// Fast libsvm parser for the armnet_tpu data pipeline.
//
// The reference parses "label id:val id:val ..." line-by-line in Python
// (data_loader.py:16-46) — minutes of startup for Criteo-scale files. This
// parser mmaps the file and decodes it in one pass with hand-rolled integer
// scanning and std::from_chars floats; malformed lines are skipped and
// counted (the Python layer warns, preserving the reference's tolerance).
//
// Exposed C ABI (ctypes):
//   int64 libsvm_count_rows(path)                     -> #lines (upper bound)
//   int64 libsvm_parse(path, nfield, ids, vals, labels, max_rows, skipped*)
//       fills caller-allocated int32[max_rows*nfield], float[max_rows*nfield],
//       float[max_rows]; returns rows parsed or -1 on IO error.
//
// Build: make -C csrc   (g++ -O3 -shared -fPIC)

#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr || size == 0; }
};

Mapped map_file(const char* path) {
  Mapped m;
  m.fd = ::open(path, O_RDONLY);
  if (m.fd < 0) return m;
  struct stat st;
  if (::fstat(m.fd, &st) != 0) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  m.size = static_cast<size_t>(st.st_size);
  if (m.size == 0) {
    m.data = reinterpret_cast<const char*>(1);  // non-null marker, unused
    return m;
  }
  void* p = ::mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) {
    ::close(m.fd);
    m.fd = -1;
    return m;
  }
  ::madvise(p, m.size, MADV_SEQUENTIAL);
  m.data = static_cast<const char*>(p);
  return m;
}

void unmap(Mapped& m) {
  if (m.data && m.size) ::munmap(const_cast<char*>(m.data), m.size);
  if (m.fd >= 0) ::close(m.fd);
}

inline const char* skip_spaces(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Parse one line into row buffers. Returns true iff the line is well-formed
// with exactly nfield id:value pairs.
bool parse_line(const char* p, const char* end, int64_t nfield, int32_t* ids,
                float* vals, float* label) {
  p = skip_spaces(p, end);
  if (p >= end) return false;

  // label (float: "1", "0", possibly "1.0" or scientific)
  float lab;
  auto r = std::from_chars(p, end, lab);
  if (r.ec != std::errc()) return false;
  p = r.ptr;

  for (int64_t f = 0; f < nfield; ++f) {
    p = skip_spaces(p, end);
    if (p >= end) return false;
    // feature id: unsigned decimal
    int64_t id = 0;
    const char* q = p;
    while (q < end && *q >= '0' && *q <= '9') {
      id = id * 10 + (*q - '0');
      ++q;
    }
    if (q == p || q >= end || *q != ':') return false;
    p = q + 1;
    float v;
    auto rv = std::from_chars(p, end, v);
    if (rv.ec != std::errc()) return false;
    p = rv.ptr;
    ids[f] = static_cast<int32_t>(id);
    vals[f] = v;
  }
  p = skip_spaces(p, end);
  if (p < end) return false;  // trailing junk => field-count mismatch
  *label = lab;
  return true;
}

}  // namespace

namespace {

// Byte-range shard ownership: a line belongs to the shard whose [lo, hi)
// contains the line's FIRST byte. Shard 0 starts at 0; any other shard
// scans forward from `lo` to the first newline and owns what follows.
// Splitting [0, filesize) into disjoint ranges therefore partitions the
// rows exactly (each host parses ~1/P of the bytes; SURVEY.md §3.5).
struct Range {
  const char* begin;
  const char* end;    // parse lines starting before this point
  const char* hard;   // absolute end of mapping (a line may run past `end`)
};

Range shard_range(const Mapped& m, int64_t lo, int64_t hi) {
  Range r;
  const char* base = m.data;
  const char* file_end = m.data + m.size;
  if (lo < 0) lo = 0;
  // clamp lo too: lo past EOF would hand memchr an underflowed
  // (negative-cast-to-size_t) length — an out-of-bounds read (SIGSEGV,
  // reproduced). The numpy fallback returns b"" for the same inputs.
  if (lo > static_cast<int64_t>(m.size)) lo = static_cast<int64_t>(m.size);
  if (hi > static_cast<int64_t>(m.size)) hi = static_cast<int64_t>(m.size);
  const char* p = base + lo;
  if (lo > 0) {
    const char* nl = static_cast<const char*>(
        memchr(p - 1, '\n', static_cast<size_t>(file_end - (p - 1))));
    // p-1: if the byte before lo is '\n', the line starting AT lo is ours
    p = nl ? nl + 1 : file_end;
  }
  r.begin = p;
  r.end = base + (hi < lo ? lo : hi);
  r.hard = file_end;
  return r;
}

}  // namespace

extern "C" {

// Rows whose first byte lies in [lo, hi) — see shard_range above.
int64_t libsvm_count_rows_range(const char* path, int64_t lo, int64_t hi) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Range r = shard_range(m, lo, hi);
  int64_t lines = 0;
  const char* p = r.begin;
  while (p < r.end) {
    ++lines;
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(r.hard - p)));
    if (!nl) break;
    p = nl + 1;
  }
  unmap(m);
  return lines;
}

int64_t libsvm_parse_range(const char* path, int64_t nfield, int64_t lo,
                           int64_t hi, int32_t* ids, float* vals,
                           float* labels, int64_t max_rows, int64_t* skipped) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  Range r = shard_range(m, lo, hi);
  const char* p = r.begin;
  int64_t rows = 0;
  int64_t bad = 0;
  while (p < r.end && rows < max_rows) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(r.hard - p)));
    const char* line_end = nl ? nl : r.hard;
    if (line_end > p) {
      if (parse_line(p, line_end, nfield, ids + rows * nfield,
                     vals + rows * nfield, labels + rows)) {
        ++rows;
      } else {
        ++bad;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  if (skipped) *skipped = bad;
  unmap(m);
  return rows;
}

int64_t libsvm_count_rows(const char* path) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  int64_t lines = 0;
  const char* p = m.data;
  const char* end = m.data + m.size;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    ++lines;
    if (!nl) break;
    p = nl + 1;
  }
  if (m.size && m.data[m.size - 1] == '\n') {
    // final newline does not start a new row
  }
  unmap(m);
  return lines;
}

int64_t libsvm_parse(const char* path, int64_t nfield, int32_t* ids,
                     float* vals, float* labels, int64_t max_rows,
                     int64_t* skipped) {
  Mapped m = map_file(path);
  if (!m.ok()) return -1;
  const char* p = m.data;
  const char* end = m.data + m.size;
  int64_t rows = 0;
  int64_t bad = 0;
  while (p < end && rows < max_rows) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    if (line_end > p) {  // skip empty lines silently
      if (parse_line(p, line_end, nfield, ids + rows * nfield,
                     vals + rows * nfield, labels + rows)) {
        ++rows;
      } else {
        ++bad;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  if (skipped) *skipped = bad;
  unmap(m);
  return rows;
}

}  // extern "C"
