// Weighted histogram of an inverse index for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_distinct_counts_kernel` of the JAX package
// (src/repro/kernels/scan.py, `distinct_counts`). For rows i < n:
//
//   out[b] = sum of w[i] over the rows with inv[i] == b,   0 <= b < n_bins
//
// in 32-bit wraparound arithmetic. Rows whose inv lies outside
// [0, n_bins), the -1 pad among them, add nothing. The sums are taken in
// uint32, since signed overflow is undefined in C++; the bits are those
// of the int32 sum. Integer atomics commute, so the result is exact and
// the same on every run, whatever order the rows land in.
//
// Bound on the H100: 8 bytes a row in (inv and w) and 4 bytes a bin out,
// against one add a row. Both are microseconds at the million rows of a
// whole-archive aggregation and far less at the 8,192 rows of a stream
// chunk, so launch latency and atomic throughput bound it in practice.
// The TPU kernel compared each row with every bin (a one-hot tile of
// RN x n_bins); here a row costs one atomic. A grid-stride loop over rows
// feeds a per-block histogram in shared memory when its 4 * n_bins bytes
// fit there (opting in above 48 KB), so most atomics stay on the SM; the
// block then adds each non-zero bin to the output with one global atomic.
// Wider histograms take atomics straight into global memory (L2). The
// output must be zeroed by the caller.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void distinct_counts_shared_kernel(const int32_t* __restrict__ inv,
                                              const int32_t* __restrict__ w,
                                              uint32_t* __restrict__ out, long long n,
                                              int n_bins) {
  extern __shared__ uint32_t hist[];
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) hist[b] = 0u;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t b = __ldg(inv + i);
    if ((uint32_t)b < (uint32_t)n_bins) atomicAdd(hist + b, (uint32_t)__ldg(w + i));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += blockDim.x) {
    const uint32_t v = hist[b];
    if (v) atomicAdd(out + b, v);
  }
}

__global__ void distinct_counts_global_kernel(const int32_t* __restrict__ inv,
                                              const int32_t* __restrict__ w,
                                              uint32_t* __restrict__ out, long long n,
                                              int n_bins) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t b = __ldg(inv + i);
    if ((uint32_t)b < (uint32_t)n_bins) atomicAdd(out + b, (uint32_t)__ldg(w + i));
  }
}

}  // namespace

// `out` holds n_bins zeroed int32 on entry.
extern "C" int distinct_counts_launch(const int32_t* inv, const int32_t* w, int32_t* out,
                                      long long n, int n_bins, void* stream) {
  if (n <= 0 || n_bins <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  long long blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)n_bins * sizeof(uint32_t);
  if (smem <= (size_t)optin) {
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(distinct_counts_shared_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, distinct_counts_shared_kernel,
                                                      kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    // at least n_bins rows a block, so that zeroing and flushing the
    // block's histogram cost no more than its rows
    const long long by_rows = (n + n_bins - 1) / n_bins;
    if (blocks > resident) blocks = resident;
    if (blocks > by_rows) blocks = by_rows;
    distinct_counts_shared_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
        inv, w, o, n, n_bins);
  } else {
    const long long resident = (long long)sms * (2048 / kThreads);
    if (blocks > resident) blocks = resident;
    distinct_counts_global_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        inv, w, o, n, n_bins);
  }
  return (int)cudaGetLastError();
}
