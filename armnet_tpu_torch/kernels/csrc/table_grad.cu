// Embedding-table gradient for Hopper (sm_90a): the dense [nrows, E] f32
// gradient of a row gather, a duplicate-safe scatter-add of g [N, E] at
// ids [N], written as a segmented sum over the ids sorted by a stable radix
// sort of its own.
//
// Replaces the Pallas TPU kernel armnet_tpu/kernels/scatter_pallas.py
// `_kernel_v4` (entered through `_table_grad_tpu_v4`, K7), with its prep
// (`_wrap_negative_ids`, `_sorted_prep`). What it keeps: the updates are
// grouped by row with a sort before any row is written (the JAX package
// co-sorts (ids, iota) with lax.sort), and each row is written once with no
// scatter-add. What it does not keep: the TPU kernel's bucket grid with a
// searched `starts` array and its one-hot MXU densify over a bf16 hi/lo
// split of g, workarounds for the TPU's matrix unit; here each output
// element is an exact f32 sum.
//
// Ids: an id in [-nrows, 0) wraps to id + nrows, any other id outside
// [0, nrows) is keyed nrows, which sorts after every real row and is
// dropped (as JAX's .at[].add drops it). int32 and int64 ids are read as
// they are; the key is formed inside the sort's first pass.
//
// What bounds it on an H100: the dense output. At the cr_armnet1h step
// (nrows 2.1M, E 10, N = 4096 x 39 = 159,744) it must write 84 MB and read
// g (6.4 MB) and the ids (0.6 MB): ~91 MB at 3.35 TB/s is about 27 us.
// The adds are far below that. The design, one stream of launches:
//   1. A stable LSD radix sort of the keys over ceil(log2(nrows + 1)) bits
//      only (22 at Criteo: two passes of 11 bits), with an int32
//      permutation: one kernel counts the first pass's digits per tile of
//      1024 keys (forming the keys from the ids as it goes); then each
//      pass is two kernels: a scan down each digit's per-tile counts (a
//      block per 32 digits, its 16 warps splitting the tiles), and the
//      placement, whose blocks place their tile's keys warp by warp in
//      order (__match_any_sync ranks the lanes of one digit, so equal keys
//      keep their order) and count the next pass's digits per output tile.
//      Small tiles give the 160K keys of a Criteo step 156 blocks, more
//      than one per SM, each placing 8 keys a lane: the placement is a
//      chain of dependent steps, and the shorter chains are what the sort's
//      time is made of.
//   2. The zero fill of the output, one 16-byte streaming store a thread
//      (which a persistent grid and cudaMemsetAsync do not beat), with the
//      long-row flags of step 4 cleared in the same launch.
//   3. The segmented sums, one thread per (sorted position, column): the
//      head of each row's segment (key[i] != key[i-1]) sums its column of
//      that row's updates in the stable order (the order of the updates in
//      g, the order index_add_ adds in on the CPU) and writes it once. The
//      E threads of a head are neighbouring lanes, so a row is read and
//      written as one contiguous run. A thread reads the keys around its
//      position and its index in one trip, so a row of one update takes
//      two trips to memory; a longer row's head loads kGroup updates'
//      keys, indices and values at a time, so a row of 40 updates costs a
//      few trips, not 40. The result is the same bits every run. kGroup
//      and kChunk were chosen on synthetic batches (ids uniform within
//      each Criteo field, all ids equal) and then timed on Zipf-skewed
//      ones (PERF.md); no real Criteo ids were measured.
//   4. Skew: a segment longer than kChunk updates is cut at the multiples of
//      kChunk in sorted position; each piece sums its part in order into a
//      partial row, and a second small pass adds each long segment's
//      partials in position order. Still deterministic; all ids equal
//      becomes N / kChunk pieces summed in parallel instead of N serial
//      adds. A segment of up to kChunk updates is never cut.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadixBits = 11;                  // at most 2048 bins a pass
constexpr int kBins = 1 << kRadixBits;
constexpr int kMaxPasses = 3;                   // keys < 2^31
constexpr int kSortThreads = 128;               // 4 warps
constexpr int kWarps = kSortThreads / 32;
constexpr int kItems = 8;                       // keys a lane places
constexpr int kWarpTile = 32 * kItems;          // keys a warp places
constexpr int kTile = kWarps * kWarpTile;       // keys a sort block takes
constexpr int kDigitsPerThread = kBins / kSortThreads;
constexpr int kScanWarps = 16;                  // warps a scan block takes
constexpr int kScanUnroll = 16;                 // tiles' counts read at once
constexpr int kChunk = 256;                     // longest uncut segment
constexpr int kSegThreads = 256;
constexpr int kGroup = 8;                       // updates loaded at once
constexpr int kFillThreads = 128;

template <typename Id>
__device__ __forceinline__ int key_of(const Id* ids, int i, int nrows) {
  int64_t id = ids[i];
  if (id < 0) id += nrows;
  return (id >= 0 && id < nrows) ? (int)id : nrows;
}

// the key of position i in a pass: from the raw ids in the first pass
template <typename Id>
__device__ __forceinline__ int pass_key(const Id* ids, const int* keys,
                                        int i, int nrows) {
  return keys ? keys[i] : key_of(ids, i, nrows);
}

// counts[b * bins + d] = the keys of block b's tile with digit d, for the
// first pass; the later passes' counts, which the pass before each adds up,
// are set to 0 (`later` ints after the first pass's)
template <typename Id>
__global__ void __launch_bounds__(kSortThreads)
radix_count_kernel(const Id* __restrict__ ids, int n, int nrows, int bins,
                   int* __restrict__ counts, int64_t later) {
  __shared__ int hist[kBins];
  const int64_t first = (int64_t)gridDim.x * bins;
  for (int64_t q = (int64_t)blockIdx.x * kSortThreads + threadIdx.x;
       q < later; q += (int64_t)gridDim.x * kSortThreads)
    counts[first + q] = 0;
  for (int d = threadIdx.x; d < bins; d += kSortThreads) hist[d] = 0;
  __syncthreads();
  const int end = (int)min((int64_t)n, ((int64_t)blockIdx.x + 1) * kTile);
  for (int i = blockIdx.x * kTile + threadIdx.x; i < end; i += kSortThreads)
    atomicAdd(&hist[key_of(ids, i, nrows) & (bins - 1)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < bins; d += kSortThreads)
    counts[(int64_t)blockIdx.x * bins + d] = hist[d];
}

// offs[b * bins + d] = the keys of digit d in the tiles before tile b (an
// exclusive scan down each digit's column of the per-tile counts), and
// totals[d] = the keys of digit d in all tiles. A block takes 32 digits,
// one a lane, and its kScanWarps warps split the tiles: each warp sums its
// share of the column (up to kScanUnroll counts in flight a thread), the
// warps' sums are scanned in shared memory, then each warp writes its
// share's running offsets.
__global__ void __launch_bounds__(32 * kScanWarps)
radix_scan_kernel(const int* __restrict__ counts, int nblocks, int bins,
                  int* __restrict__ offs, int* __restrict__ totals) {
  __shared__ int part[kScanWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int share = (nblocks + kScanWarps - 1) / kScanWarps;
  const int lo = min(nblocks, w * share), hi = min(nblocks, lo + share);
  int sum = 0;
  for (int b0 = lo; d < bins && b0 < hi; b0 += kScanUnroll) {
    int c[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      c[u] = b0 + u < hi ? counts[(int64_t)(b0 + u) * bins + d] : 0;
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) sum += c[u];
  }
  part[w][lane] = sum;
  __syncthreads();
  if (d >= bins) return;
  int run = 0;
  for (int v = 0; v < w; ++v) run += part[v][lane];
  if (w == kScanWarps - 1) totals[d] = run + sum;
  for (int b0 = lo; b0 < hi; b0 += kScanUnroll) {
    int c[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      c[u] = b0 + u < hi ? counts[(int64_t)(b0 + u) * bins + d] : 0;
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u)
      if (b0 + u < hi) {
        offs[(int64_t)(b0 + u) * bins + d] = run;
        run += c[u];
      }
  }
}

// One stable pass of the LSD radix sort. Block b takes tile b; its warp w
// places the keys [w * kWarpTile, (w + 1) * kWarpTile) of the tile, 32 at a
// time, in order. A key of digit d goes after every key of a lower digit
// (an exclusive scan of totals), after the keys of digit d in earlier tiles
// (offs, from radix_scan_kernel) and in the block's earlier warps. So equal
// digits keep their order and the pass is stable. vals == nullptr in the
// first pass (the value is the position). With next_counts, the pass also
// counts the next pass's digits per tile of its output (integer atomics:
// the counts, not their order, are what is kept).
template <typename Id>
__global__ void __launch_bounds__(kSortThreads)
radix_scatter_kernel(const Id* __restrict__ ids, const int* __restrict__ keys,
                     const int* __restrict__ vals, int n, int nrows,
                     int shift, int bins, const int* __restrict__ offs,
                     const int* __restrict__ totals, int next_shift,
                     int* __restrict__ next_counts,
                     int* __restrict__ keys_out, int* __restrict__ vals_out) {
  __shared__ int cursor[kWarps][kBins];
  __shared__ int start[kBins];
  __shared__ int warp_sum[kWarps];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int wbase = blockIdx.x * kTile + w * kWarpTile;

  // this lane's keys and values, all loads in flight at once
  int key[kItems], val[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int i = wbase + u * 32 + lane;
    key[u] = i < n ? pass_key(ids, keys, i, nrows) : -1;
    val[u] = vals ? (i < n ? vals[i] : 0) : i;
  }

  for (int i = t; i < kWarps * kBins; i += kSortThreads)
    (&cursor[0][0])[i] = 0;
  int before[kDigitsPerThread];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = t + j * kSortThreads;
    if (d < bins) start[d] = totals[d];
    before[j] = d < bins ? offs[(int64_t)blockIdx.x * bins + d] : 0;
  }
  __syncthreads();
  // per warp digit counts: one add per digit a step, by its lowest lane
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const bool live = key[u] >= 0;
    // a lane past the end gets a digit of its own, outside [0, bins)
    const int digit = live ? (key[u] >> shift) & (bins - 1) : bins + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    if (live && (peers & below) == 0) cursor[w][digit] += __popc(peers);
    __syncwarp();
  }

  // start[d] = the keys of all digits below d: an exclusive block scan,
  // thread t over the kDigitsPerThread digits from t * kDigitsPerThread
  int mine[kDigitsPerThread], sum = 0;
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = t * kDigitsPerThread + j;
    mine[j] = d < bins ? start[d] : 0;
    sum += mine[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[w] = incl;
  __syncthreads();
  int run = incl - sum;
  for (int v = 0; v < w; ++v) run += warp_sum[v];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = t * kDigitsPerThread + j;
    if (d < bins) start[d] = run;
    run += mine[j];
  }
  __syncthreads();
  // cursor[v][d] = where warp v's first key of digit d goes
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = t + j * kSortThreads;
    if (d < bins) {
      int at = start[d] + before[j];
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int c = cursor[v][d];
        cursor[v][d] = at;
        at += c;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const bool live = key[u] >= 0;
    const int digit = live ? (key[u] >> shift) & (bins - 1) : bins + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    int pos = 0;
    if (live) pos = cursor[w][digit] + __popc(peers & below);
    __syncwarp();
    if (live && (peers & below) == 0) cursor[w][digit] += __popc(peers);
    __syncwarp();
    if (live) {
      keys_out[pos] = key[u];
      vals_out[pos] = val[u];
    }
    if (next_counts) {
      // one add per (output tile, next digit) a step
      const int64_t slot = live ? (int64_t)(pos / kTile) * bins +
                                      ((key[u] >> next_shift) & (bins - 1))
                                : -1 - lane;
      const unsigned same = __match_any_sync(0xffffffffu, slot);
      if (live && (same & below) == 0)
        atomicAdd(&next_counts[slot], __popc(same));
    }
  }
}

// first index in [lo, hi) with a[i] >= key (hi if none)
__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int lo,
                                           int hi, int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (a[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The sum of g[perm[j], c] over the run of sorted positions j from a while
// j < lim and sk[j] == key, added in position order from 0.0f. kGroup
// positions' keys and indices, then their values, are loaded at once.
__device__ __forceinline__ float sum_run(const float* __restrict__ g,
                                         const int* __restrict__ sk,
                                         const int* __restrict__ perm, int a,
                                         int lim, int key, int e, int c) {
  float acc = 0.0f;
  for (int j0 = a;; j0 += kGroup) {
    bool live[kGroup];
    float v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      live[u] = j0 + u < lim && sk[j0 + u] == key;
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      v[u] = live[u] ? g[(int64_t)perm[j0 + u] * e + c] : 0.0f;
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (live[u]) acc += v[u];
    if (!live[kGroup - 1]) return acc;
  }
}

// whether the segment of key that holds position i (> 0, sk[i - 1] == key)
// is longer than kChunk
__device__ __forceinline__ bool in_long_segment(const int* __restrict__ sk,
                                                int n, int i, int key) {
  if (i >= kChunk && sk[i - kChunk] == key) return true;
  const int s = lower_bound(sk, i > kChunk ? i - kChunk + 1 : 0, i, key);
  return s + kChunk < n && sk[s + kChunk] == key;
}

// One thread per (sorted position, column). A segment of up to kChunk
// updates is summed by its head's threads and written to its row. A longer
// one is cut at the multiples of kChunk: its head sums up to the next
// multiple into slot 1 of its chunk and flags the chunk (long_key = key +
// 1); the position at each later multiple inside it sums the next piece
// into slot 0 of its chunk. The keys around i and perm[i] are read in one
// trip to memory, so the most common head, a row of one update, takes two
// trips: that and its value.
__global__ void __launch_bounds__(kSegThreads)
segment_kernel(const float* __restrict__ g, const int* __restrict__ sk,
               const int* __restrict__ perm, int n, int nrows, int e,
               float* __restrict__ out, float* __restrict__ partial,
               int* __restrict__ long_key) {
  const int64_t t = (int64_t)blockIdx.x * kSegThreads + threadIdx.x;
  if (t >= (int64_t)n * e) return;
  int i, c;
  if (t <= 0x7fffffff) {                // a 32-bit divide where it will do
    i = (int)t / e;
    c = (int)t - i * e;
  } else {
    i = (int)(t / e);
    c = (int)(t - (int64_t)i * e);
  }
  const int key = sk[i];
  const int prev = i > 0 ? sk[i - 1] : -1;
  const int next = i + 1 < n ? sk[i + 1] : -1;
  const int p = perm[i];
  if (key >= nrows) return;                           // dropped ids
  const bool head = prev != key;
  if (head && next != key) {                          // one update: 0 + g
    out[(int64_t)key * e + c] = __fadd_rn(0.0f, g[(int64_t)p * e + c]);
    return;
  }
  const int chunk = i / kChunk;
  if (head) {
    if (i + kChunk < n && sk[i + kChunk] == key) {    // longer than kChunk
      partial[(int64_t)(2 * chunk + 1) * e + c] =
          sum_run(g, sk, perm, i, (chunk + 1) * kChunk, key, e, c);
      if (c == 0) long_key[chunk] = key + 1;
    } else
      out[(int64_t)key * e + c] = sum_run(g, sk, perm, i, n, key, e, c);
  } else if (i == chunk * kChunk && in_long_segment(sk, n, i, key)) {
    partial[(int64_t)(2 * chunk) * e + c] =
        sum_run(g, sk, perm, i, min(n, i + kChunk), key, e, c);
  }
}

// out[row] of each long segment, one thread per (flagged chunk, column):
// the pieces' partials added in position order
__global__ void __launch_bounds__(kSegThreads)
long_segment_kernel(const int* __restrict__ sk, int n, int e,
                    const float* __restrict__ partial,
                    const int* __restrict__ long_key,
                    float* __restrict__ out) {
  const int nchunks = (n + kChunk - 1) / kChunk;
  const int t = blockIdx.x * kSegThreads + threadIdx.x;
  if (t >= nchunks * e) return;
  const int chunk = t / e, c = t - chunk * e;
  const int key = long_key[chunk] - 1;
  if (key < 0) return;
  float s = partial[(int64_t)(2 * chunk + 1) * e + c];
  for (int k = chunk + 1; k < nchunks && sk[k * kChunk] == key; ++k)
    s += partial[(int64_t)(2 * k) * e + c];
  out[(int64_t)key * e + c] = s;
}

// out[0, nout) = 0, one 16-byte streaming store a thread (out 16-byte
// aligned), and flags[0, nflags) = 0
__global__ void __launch_bounds__(kFillThreads)
zero_kernel(float* __restrict__ out, int64_t nout, int* __restrict__ flags,
            int nflags) {
  const int64_t q = (int64_t)blockIdx.x * kFillThreads + threadIdx.x;
  if (q < nout / 4)
    __stcs(reinterpret_cast<float4*>(out) + q,
           make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  if (q < nout % 4) out[nout / 4 * 4 + q] = 0.0f;
  if (q < nflags) flags[q] = 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

size_t align256(size_t b) { return (b + 255) & ~(size_t)255; }

// the parts of the scratch buffer (armnet_table_grad_scratch bytes)
struct Scratch {
  int *keys, *vals, *sid, *perm, *counts, *offs, *totals, *long_key;
  float* partial;
};

// the parts' places from `base` (from 0, the bytes they take in all)
Scratch carve(void* base, int n, int e, size_t* bytes = nullptr) {
  size_t at = 0;
  Scratch s;
  auto take = [&](size_t part) {
    char* q = reinterpret_cast<char*>(reinterpret_cast<uintptr_t>(base) + at);
    at += align256(part);
    return q;
  };
  const size_t per_pass = (size_t)kBins * ceil_div(n, kTile);
  const int nchunks = ceil_div(n, kChunk);
  s.keys = reinterpret_cast<int*>(take(sizeof(int) * (size_t)n));
  s.vals = reinterpret_cast<int*>(take(sizeof(int) * (size_t)n));
  s.sid = reinterpret_cast<int*>(take(sizeof(int) * (size_t)n));
  s.perm = reinterpret_cast<int*>(take(sizeof(int) * (size_t)n));
  s.counts = reinterpret_cast<int*>(take(sizeof(int) * kMaxPasses * per_pass));
  s.offs = reinterpret_cast<int*>(take(sizeof(int) * per_pass));
  s.totals = reinterpret_cast<int*>(take(sizeof(int) * kBins));
  s.long_key = reinterpret_cast<int*>(take(sizeof(int) * (size_t)nchunks));
  s.partial = reinterpret_cast<float*>(
      take(sizeof(float) * (size_t)2 * nchunks * e));
  if (bytes) *bytes = at;
  return s;
}

size_t scratch_bytes(int n, int e) {
  size_t bytes = 0;
  carve(nullptr, n, e, &bytes);
  return bytes;
}

// the stable radix sort of the keys of ids [n] (n >= 1) into sid/perm
template <typename Id>
cudaError_t sort_keys(const Id* ids, int n, int nrows, int* sid, int* perm,
                      const Scratch& s, cudaStream_t stream) {
  const int nbits = 32 - __builtin_clz((unsigned)nrows);   // keys <= nrows
  const int npass = ceil_div(nbits, kRadixBits);
  const int bits = ceil_div(nbits, npass);
  const int bins = 1 << bits;
  const int nblocks = ceil_div(n, kTile);
  const int64_t per_pass = (int64_t)bins * nblocks;
  radix_count_kernel<Id><<<nblocks, kSortThreads, 0, stream>>>(
      ids, n, nrows, bins, s.counts, per_pass * (npass - 1));
  const int* keys_in = nullptr;
  const int* vals_in = nullptr;
  for (int p = 0; p < npass; ++p) {
    radix_scan_kernel<<<ceil_div(bins, 32), 32 * kScanWarps, 0, stream>>>(
        s.counts + p * per_pass, nblocks, bins, s.offs, s.totals);
    // the passes alternate between sid/perm and the scratch pair so that
    // the last one writes sid/perm
    const bool to_out = (npass - 1 - p) % 2 == 0;
    int* keys_out = to_out ? sid : s.keys;
    int* vals_out = to_out ? perm : s.vals;
    radix_scatter_kernel<Id><<<nblocks, kSortThreads, 0, stream>>>(
        ids, keys_in, vals_in, n, nrows, p * bits, bins, s.offs, s.totals,
        (p + 1) * bits,
        p + 1 < npass ? s.counts + (p + 1) * per_pass : nullptr, keys_out,
        vals_out);
    keys_in = keys_out;
    vals_in = vals_out;
  }
  return cudaGetLastError();
}

// out [nrows, e] = the segmented sums of g over the sorted keys: the zero
// fill with the long-row flags, then (n >= 1) the segmented sums and the
// long rows' pieces added
cudaError_t fill_and_sum(const float* g, const int* sid, const int* perm,
                         int n, int nrows, int e, float* out,
                         const Scratch& s, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16) return cudaErrorInvalidValue;
  const int64_t nout = (int64_t)nrows * e;
  const int nchunks = ceil_div(n, kChunk);
  const int64_t fill_threads = nout / 4 > nchunks ? nout / 4 : nchunks;
  zero_kernel<<<(unsigned)((fill_threads + kFillThreads) / kFillThreads),
                kFillThreads, 0, stream>>>(out, nout, s.long_key, nchunks);
  if (n == 0) return cudaGetLastError();
  segment_kernel<<<(unsigned)(((int64_t)n * e + kSegThreads - 1) /
                              kSegThreads),
                   kSegThreads, 0, stream>>>(g, sid, perm, n, nrows, e, out,
                                             s.partial, s.long_key);
  long_segment_kernel<<<ceil_div(nchunks * e, kSegThreads), kSegThreads, 0,
                        stream>>>(sid, n, e, s.partial, s.long_key, out);
  return cudaGetLastError();
}

bool bad_shape(int n, int nrows, int e) {
  return nrows < 1 || nrows == 0x7fffffff || e < 1 || n < 0;
}

}  // namespace

// Bytes of scratch that the entry points below take for n updates of width
// e (allocated by the caller; nothing is allocated here).
extern "C" long long armnet_table_grad_scratch(int n, int e) {
  return (long long)scratch_bytes(n, e);
}

// sid [n], perm [n] (int32) = the stable sort of the keys of ids [n]
// (int64 if ids_are_64, else int32): an id in [-nrows, 0) wraps, any other
// outside [0, nrows) is keyed nrows. The sort of armnet_table_grad alone,
// the hook its tests hold against a stable sort. Returns the cudaError_t (0
// on success).
extern "C" int armnet_table_sort(const void* ids, int ids_are_64, int n,
                                 int nrows, int* sid, int* perm,
                                 void* scratch, void* stream) {
  if (bad_shape(n, nrows, 1)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Scratch s = carve(scratch, n, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(ids_are_64
                   ? sort_keys(static_cast<const long long*>(ids), n, nrows,
                               sid, perm, s, st)
                   : sort_keys(static_cast<const int*>(ids), n, nrows, sid,
                               perm, s, st));
}

// out [nrows, e] = the table gradient of g [n, e] at ids [n] (int64 if
// ids_are_64, else int32): the sort, the zero fill, the segmented sums.
// Returns the cudaError_t (0 on success).
extern "C" int armnet_table_grad(const float* g, const void* ids,
                                 int ids_are_64, int n, int nrows, int e,
                                 float* out, void* scratch, void* stream) {
  if (bad_shape(n, nrows, e)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Scratch s = carve(scratch, n, e);
  if (n > 0) {
    const cudaError_t err =
        ids_are_64 ? sort_keys(static_cast<const long long*>(ids), n, nrows,
                               s.sid, s.perm, s, st)
                   : sort_keys(static_cast<const int*>(ids), n, nrows, s.sid,
                               s.perm, s, st);
    if (err) return (int)err;
  }
  return (int)fill_and_sum(g, s.sid, s.perm, n, nrows, e, out, s, st);
}
