// Common-token counts (the clustering surrogate phi) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_simcount_kernel` of the JAX package
// (src/repro/kernels/simcount.py, `simcount`). For line n (tokens
// logs[n, :T]) and template k (tokens templates[k, :Tt]) it writes
//
//   out[n, k] = #{ i < T : logs[n, i] is not PAD (0) or STAR (1),
//                          and logs[n, i] == templates[k, j] for some j }
//
// A duplicate log token counts once per occurrence. PAD and STAR in a
// template never equal a valid log token, so they match nothing without
// a mask.
//
// Bound on the H100: integer operations. Each (line, template) pair
// compares every valid log token with every template slot, T * Tt
// compares in the worst case, against 4 bytes read per token. A block
// is a tile of 32 templates x 8 lines, threadIdx.x the template and
// threadIdx.y the line, so the 32 lanes of a warp share one line: its
// tokens are read once per warp through the read-only cache (one address
// per load, a broadcast) and the test for a valid token is uniform
// across the warp. The tile's 32 template rows are staged in shared
// memory with an odd row stride, so the 32 lanes reading slot j of their
// own rows hit 32 different banks. The inner loop over the template's
// slots has no branch: a hit is OR-ed in and the count adds it once per
// log position. Output stores of a warp are 32 consecutive int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileK = 32;
constexpr int kTileN = 8;

__global__ void simcount_kernel(const int32_t* __restrict__ logs,
                                const int32_t* __restrict__ tmpl, int32_t* __restrict__ out,
                                long long n_lines, int t, int k, int tt, int stride) {
  extern __shared__ int32_t stile[];  // kTileK rows of `stride` >= tt slots
  const int k0 = blockIdx.y * kTileK;
  for (int e = threadIdx.y * kTileK + threadIdx.x; e < kTileK * tt; e += kTileK * kTileN) {
    const int r = e / tt, j = e - r * tt;
    stile[r * stride + j] = k0 + r < k ? __ldg(tmpl + (long long)(k0 + r) * tt + j) : 0;
  }
  __syncthreads();

  const long long n = (long long)blockIdx.x * kTileN + threadIdx.y;
  const int kk = k0 + threadIdx.x;
  if (n >= n_lines || kk >= k) return;
  const int32_t* line = logs + n * (long long)t;
  const int32_t* row = stile + threadIdx.x * stride;
  int count = 0;
  for (int i = 0; i < t; ++i) {
    const int32_t tok = __ldg(line + i);
    if (tok == 0 || tok == 1) continue;  // PAD and STAR never count
    bool hit = false;
    for (int j = 0; j < tt; ++j) hit |= row[j] == tok;
    count += hit;
  }
  out[n * k + kk] = count;
}

}  // namespace

// Templates of more than SIMCOUNT_MAX_TT slots are refused (the caller
// checks): the tile of 32 rows must fit in a block's shared memory.
extern "C" int simcount_launch(const int32_t* logs, const int32_t* tmpl, int32_t* out,
                               long long n, int t, int k, int tt, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  const int stride = tt | 1;  // odd: slot j of the 32 rows lies in 32 banks
  const size_t smem = (size_t)kTileK * stride * sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        simcount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 threads(kTileK, kTileN);
  const dim3 grid((unsigned)((n + kTileN - 1) / kTileN), (unsigned)((k + kTileK - 1) / kTileK));
  simcount_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(logs, tmpl, out, n, t, k, tt,
                                                                 stride);
  return (int)cudaGetLastError();
}
