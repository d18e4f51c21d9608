// numpy's legacy np.random.RandomState(seed).permutation(n), bit for bit,
// drawn without the Python interpreter (bound with ctypes, which releases
// the GIL for the call).
//
// The generator is MT19937 seeded by init_genrand (numpy's mt19937_seed);
// the shuffle is numpy's legacy Fisher-Yates over arange(n): i from n - 1
// down to 1, j = random_interval(i), then x[i] and x[j] swapped.
// random_interval masks 32-bit draws to the bit length of i and rejects
// those above i; numpy takes 64-bit draws past 2^32 - 1, which the entry
// refuses (a return of -1).

#include <cstdint>

namespace {

constexpr int kN = 624;
constexpr int kM = 397;
constexpr uint32_t kMatrixA = 0x9908b0dfu;
constexpr uint32_t kUpper = 0x80000000u;
constexpr uint32_t kLower = 0x7fffffffu;

struct Mt19937 {
  uint32_t key[kN];
  int pos;

  explicit Mt19937(uint32_t seed) {
    for (int i = 0; i < kN; ++i) {
      key[i] = seed;
      seed = 1812433253u * (seed ^ (seed >> 30)) + static_cast<uint32_t>(i) + 1u;
    }
    pos = kN;
  }

  static uint32_t twist(uint32_t a, uint32_t b, uint32_t m) {
    uint32_t y = (a & kUpper) | (b & kLower);
    return m ^ (y >> 1) ^ (-(y & 1u) & kMatrixA);
  }

  void generate() {
    int i = 0;
    for (; i < kN - kM; ++i) key[i] = twist(key[i], key[i + 1], key[i + kM]);
    for (; i < kN - 1; ++i) key[i] = twist(key[i], key[i + 1], key[i + kM - kN]);
    key[kN - 1] = twist(key[kN - 1], key[0], key[kM - 1]);
    pos = 0;
  }

  uint32_t next() {
    if (pos == kN) generate();
    uint32_t y = key[pos++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }
};

// numpy's random_interval for max <= 2^32 - 1
uint32_t random_interval(Mt19937& mt, uint32_t max) {
  if (max == 0) return 0;
  uint32_t mask = max;
  mask |= mask >> 1;
  mask |= mask >> 2;
  mask |= mask >> 4;
  mask |= mask >> 8;
  mask |= mask >> 16;
  uint32_t value;
  while ((value = mt.next() & mask) > max) {
  }
  return value;
}

}  // namespace

// out[0..n) = RandomState(seed).permutation(n); 0, or -1 where n is
// negative or past 2^32.
extern "C" int64_t legacy_permutation(uint32_t seed, int64_t n, int64_t* out) {
  if (n < 0 || n > (int64_t{1} << 32)) return -1;
  for (int64_t i = 0; i < n; ++i) out[i] = i;
  Mt19937 mt(seed);
  for (int64_t i = n - 1; i >= 1; --i) {
    int64_t j = random_interval(mt, static_cast<uint32_t>(i));
    int64_t t = out[i];
    out[i] = out[j];
    out[j] = t;
  }
  return 0;
}
