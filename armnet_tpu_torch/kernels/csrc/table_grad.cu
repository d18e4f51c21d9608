// Embedding-table gradient for Hopper (sm_90a): the dense [nrows, E] f32
// gradient of a row gather, a duplicate-safe scatter-add of g [N, E] at
// ids [N], written as a segmented sum over ids sorted outside the kernel.
//
// Replaces the Pallas TPU kernel armnet_tpu/kernels/scatter_pallas.py
// `_kernel_v4` (entered through `_table_grad_tpu_v4`, K7). What it keeps:
// the ids are sorted outside the kernel (the JAX package sorts with
// lax.sort before its pallas_call; the wrapper here with a stable
// torch.sort), the table is cut into contiguous row blocks, and every
// block writes its rows once, contiguously, with no scatter. What it does
// not keep: the TPU kernel densifies each window of updates with a one-hot
// MXU matmul over a bf16 hi/lo split of g, a workaround for the TPU's
// matrix unit; here each output element is an exact f32 sum.
//
// Layout: block b owns rows [b*kRows, (b+1)*kRows). Two threads find the
// block's range of the sorted ids by binary search, every thread then finds
// the start of one row's segment inside that (short) range, and the block's
// threads walk the kRows*E output elements of the block in order, so
// neighbouring threads write neighbouring floats (coalesced). Element
// (r, c) is sum_i g[order[i], c] over the segment of row r, added in the
// order of the stable sort, which is the order of the updates in g: the
// result is deterministic (the same bits every run) and, on the CPU, the
// order index_add_ adds in. Rows with no update are written as 0.
//
// What bounds it on an H100: the dense output. At the cr_armnet1h step
// (nrows 2.1M, E 10, N = 4096 x 39 = 159,744) it must write 84 MB and read
// g (6.4 MB) and the ids (0.6 MB): ~91 MB at 3.35 TB/s is about 27 us.
// The operations (one add per update element) are far below that. The
// binary searches read the sorted ids, which stay in L2. Skew (all ids
// equal) puts one row's whole segment on E threads of one block; that case
// is correct and its time is recorded, not tuned.
//
// Ids: the wrapper maps ids in [-nrows, 0) to id + nrows and every id
// outside [-nrows, nrows) to nrows, which sorts after every real row and
// lies in no block's range, so it is dropped (as JAX's .at[].add drops it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;       // table rows per block
constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads)
table_grad_kernel(const float* __restrict__ g, const int* __restrict__ sid,
                  const int64_t* __restrict__ order, int n, int nrows, int e,
                  float* __restrict__ out) {
  __shared__ int seg[kRows + 1];     // seg[r]: first sorted index of row r
  __shared__ int range[2];
  const int base = blockIdx.x * kRows;
  const int rows = min(kRows, nrows - base);
  if (threadIdx.x < 2)
    range[threadIdx.x] = lower_bound(sid, 0, n, base + (int)threadIdx.x * rows);
  __syncthreads();
  const int lo = range[0], hi = range[1];
  for (int r = threadIdx.x; r <= rows; r += kThreads)
    seg[r] = r == rows ? hi : lower_bound(sid, lo, hi, base + r);
  __syncthreads();

  float* outp = out + (int64_t)base * e;
  for (int t = threadIdx.x; t < rows * e; t += kThreads) {
    const int r = t / e;
    const int c = t - r * e;
    float s = 0.0f;
    for (int i = seg[r]; i < seg[r + 1]; ++i) s += g[order[i] * e + c];
    outp[t] = s;
  }
}

}  // namespace

// out [nrows, e] = the segmented sums of g [n, e] (f32, row-major) over the
// sorted int32 keys sid [n] with their stable-sort permutation order [n]
// (int64). Keys >= nrows are dropped. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int armnet_table_grad(const float* g, const int* sid,
                                 const long long* order, int n, int nrows,
                                 int e, float* out, void* stream) {
  if (nrows < 1 || e < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nrows + kRows - 1) / kRows));
  table_grad_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      g, sid, reinterpret_cast<const int64_t*>(order), n, nrows, e, out);
  return (int)cudaGetLastError();
}
