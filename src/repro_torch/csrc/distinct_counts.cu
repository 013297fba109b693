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
// of the int32 sum. Integer adds commute, so the result is exact and the
// same on every run, whatever order the rows land in.
//
// Bound on the H100: 8 bytes a row in (inv and w) and 4 bytes a bin out,
// against one add a row. Both are microseconds at the million rows of a
// whole-archive aggregation and far less at the 8,192 rows of a stream
// chunk, so launch latency and same-address atomics bound it in practice.
// The TPU kernel compared each row with every bin (a one-hot tile of
// RN x n_bins); here a row costs at most one shared-memory atomic.
//
// Each call is one device operation, which writes all of `out`, zeros
// included: the caller fills nothing.
// - Up to kSmallRows rows (an LZJS chunk is 8,192): one cluster of
//   kClusterBlocks blocks on as many SMs. Each block takes its share of
//   the rows (16-byte loads) into its own histogram in shared memory;
//   after a cluster barrier each block sums one slice of the bins over
//   every block's histogram (distributed shared memory) and writes it.
// - Above it: one cooperative grid, sized from the rows. Block 0 zeroes
//   `out` while every block takes its rows into its own histogram; after
//   one grid barrier each block adds its non-zero bins to `out` with one
//   global atomic each. When an SM takes many rows, the lanes of a warp
//   that hold the lowest lane's bin (a header field with one common
//   value, a time column in order) first add their weights together (one
//   __reduce_add_sync) and one atomic takes the sum: kPeels such groups of
//   kMinGroup lanes or more at most, the lanes left an atomic each.
// - A histogram wider than the opt-in shared memory: the same cooperative
//   grid with its atomics straight into `out` (L2), after the barrier.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterBlocks = 8;
constexpr int kThreads = 256;
constexpr int kDepth = 2;                 // 16-byte loads of each array in flight a thread
constexpr long long kSmallRows = 16384;
constexpr long long kRowsPerThread = 4;   // the grid's least
constexpr int kGridBlocksPerSm = 4;
constexpr long long kPeelRows = 4096;     // rows an SM from which the grid's warps peel
constexpr int kPeels = 2;
constexpr int kMinGroup = 8;

// Adds row (b, w) of each lane to hist. Every lane of the warp calls it;
// a lane whose b lies outside [0, n_bins) adds nothing.
template <bool kPeel>
__device__ __forceinline__ void warp_add(uint32_t* hist, int32_t b, int32_t w,
                                         uint32_t n_bins, int lane) {
  bool left = (uint32_t)b < n_bins;
  if (kPeel) {
    uint32_t todo = __ballot_sync(0xFFFFFFFFu, left);
#pragma unroll
    for (int p = 0; p < kPeels && todo; ++p) {
      const int lead = __ffs(todo) - 1;  // the lanes holding the lowest lane's bin
      const int32_t bin = __shfl_sync(0xFFFFFFFFu, b, lead);
      const bool mine = left && b == bin;
      const uint32_t group = __ballot_sync(0xFFFFFFFFu, mine);
      if (__popc(group) < kMinGroup) break;  // the bins are spread
      const uint32_t sum = __reduce_add_sync(0xFFFFFFFFu, mine ? (uint32_t)w : 0u);
      if (lane == lead) atomicAdd(hist + bin, sum);
      left = left && !mine;
      todo &= ~group;
    }
  }
  if (left) atomicAdd(hist + b, (uint32_t)w);
}

// Adds rows [0, n) to hist, dealt over `threads` threads of which this
// is `tid`: with kVec, four rows a 16-byte load of each array. Every
// loop test is the same across a warp (tid - lane is the warp's first
// thread), so each warp_add has the whole warp.
template <bool kVec, bool kPeel>
__device__ __forceinline__ void add_rows(uint32_t* hist, const int32_t* __restrict__ inv,
                                         const int32_t* __restrict__ w, long long n,
                                         uint32_t n_bins, long long tid, long long threads) {
  const int lane = threadIdx.x & 31;
  const long long units = kVec ? n >> 2 : n;
  for (long long i = tid; i - lane < units; i += kDepth * threads) {
    int4 b[kDepth], x[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const long long j = i + d * threads;
      b[d] = make_int4(-1, -1, -1, -1);
      x[d] = make_int4(0, 0, 0, 0);
      if (j < units) {
        if (kVec) {
          b[d] = __ldg(reinterpret_cast<const int4*>(inv) + j);
          x[d] = __ldg(reinterpret_cast<const int4*>(w) + j);
        } else {
          b[d].x = __ldg(inv + j);
          x[d].x = __ldg(w + j);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (i + d * threads - lane >= units) break;
      warp_add<kPeel>(hist, b[d].x, x[d].x, n_bins, lane);
      if (kVec) {
        warp_add<kPeel>(hist, b[d].y, x[d].y, n_bins, lane);
        warp_add<kPeel>(hist, b[d].z, x[d].z, n_bins, lane);
        warp_add<kPeel>(hist, b[d].w, x[d].w, n_bins, lane);
      }
    }
  }
  if (kVec && tid - lane == 0) {  // the last n % 4 rows: the first warp
    const long long r = 4 * units + lane;
    warp_add<kPeel>(hist, r < n ? __ldg(inv + r) : -1, r < n ? __ldg(w + r) : 0, n_bins, lane);
  }
}

// One cluster takes every row and writes every bin.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    distinct_counts_cluster_kernel(const int32_t* __restrict__ inv, const int32_t* __restrict__ w,
                                   uint32_t* __restrict__ out, long long n, int n_bins) {
  extern __shared__ uint32_t hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  for (int b = threadIdx.x; b < n_bins; b += kThreads) hist[b] = 0u;
  __syncthreads();
  add_rows<kVec, false>(hist, inv, w, n, (uint32_t)n_bins,
                        (long long)rank * kThreads + threadIdx.x,
                        (long long)kClusterBlocks * kThreads);
  cluster.sync();  // every block's histogram is complete
  for (int b = rank * kThreads + threadIdx.x; b < n_bins; b += kClusterBlocks * kThreads) {
    uint32_t sum = 0u;
#pragma unroll
    for (int r = 0; r < kClusterBlocks; ++r) sum += cluster.map_shared_rank(hist, r)[b];
    out[b] = sum;
  }
  cluster.sync();  // no block leaves while another reads its histogram
}

// A cooperative grid; kShared: a histogram a block, else atomics into
// `out` itself.
template <bool kVec, bool kPeel, bool kShared>
__global__ void __launch_bounds__(kThreads)
    distinct_counts_grid_kernel(const int32_t* __restrict__ inv, const int32_t* __restrict__ w,
                                uint32_t* __restrict__ out, long long n, int n_bins) {
  extern __shared__ uint32_t hist[];
  if (blockIdx.x == 0)
    for (int b = threadIdx.x; b < n_bins; b += kThreads) out[b] = 0u;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kThreads;
  if (!kShared) {
    cg::this_grid().sync();  // `out` is zero
    add_rows<kVec, kPeel>(out, inv, w, n, (uint32_t)n_bins, tid, threads);
    return;
  }
  for (int b = threadIdx.x; b < n_bins; b += kThreads) hist[b] = 0u;
  __syncthreads();
  add_rows<kVec, kPeel>(hist, inv, w, n, (uint32_t)n_bins, tid, threads);
  __syncthreads();
  cg::this_grid().sync();  // `out` is zero
  for (int b = threadIdx.x; b < n_bins; b += kThreads) {
    const uint32_t v = hist[b];
    if (v) atomicAdd(out + b, v);
  }
}

using Kernel = void (*)(const int32_t*, const int32_t*, uint32_t*, long long, int);

cudaError_t launch_ex(Kernel kernel, long long blocks, size_t smem, cudaLaunchAttribute attr,
                      const int32_t* inv, const int32_t* w, uint32_t* o, long long n, int n_bins,
                      cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, inv, w, o, n, n_bins);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool kVec>
cudaError_t launch(const int32_t* inv, const int32_t* w, uint32_t* o, long long n, int n_bins,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t bins_bytes = (size_t)n_bins * sizeof(uint32_t);
  const bool shared = bins_bytes <= (size_t)optin;
  const size_t smem = shared ? bins_bytes : 0;
  // the grid: at least kRowsPerThread rows a thread, and (with a shared
  // histogram) n_bins rows a block, so that zeroing and flushing a
  // block's histogram cost no more than its rows
  long long blocks = (n + kThreads * kRowsPerThread - 1) / (kThreads * kRowsPerThread);
  if (shared && blocks > (n + n_bins - 1) / n_bins) blocks = (n + n_bins - 1) / n_bins;
  if (blocks < 1) blocks = 1;
  const bool peel = n >= kPeelRows * sms;
  const bool cluster = shared && n <= kSmallRows;
  Kernel kernel = cluster ? distinct_counts_cluster_kernel<kVec>
                  : shared ? (peel ? distinct_counts_grid_kernel<kVec, true, true>
                                   : distinct_counts_grid_kernel<kVec, false, true>)
                           : (peel ? distinct_counts_grid_kernel<kVec, true, false>
                                   : distinct_counts_grid_kernel<kVec, false, false>);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr;
  if (cluster) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kClusterBlocks;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    return launch_ex(kernel, kClusterBlocks, smem, attr, inv, w, o, n, n_bins, stream);
  }
  // a cooperative grid has every block resident at once
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm > kGridBlocksPerSm) per_sm = kGridBlocksPerSm;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  return launch_ex(kernel, blocks, smem, attr, inv, w, o, n, n_bins, stream);
}

}  // namespace

// Rows up to which one cluster takes the whole input.
extern "C" long long distinct_counts_small_rows() { return kSmallRows; }

// Writes all n_bins int32 of `out` (zeros where no row lands), in one
// device operation.
extern "C" int distinct_counts_launch(const int32_t* inv, const int32_t* w, int32_t* out,
                                      long long n, int n_bins, void* stream) {
  if (n_bins <= 0) return (int)cudaSuccess;
  if (n < 0) n = 0;
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  const bool vec = ((reinterpret_cast<uintptr_t>(inv) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(vec ? launch<true>(inv, w, o, n, n_bins, s) : launch<false>(inv, w, o, n, n_bins, s));
}
