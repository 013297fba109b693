// Typed-column integer transform for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_colcodec_kernel` of the JAX package
// (src/repro/kernels/colcodec.py, `colcodec_transform`). Per row r of a
// (R, C) int32 grid with per-row length, mode and reference value:
//
//   mode 3 (frame of reference):  out[i] = v[i] - ref
//   mode 1 (delta):               out[0] = 0, out[i] = v[i] - v[i-1]
//   otherwise (mode 2, delta of delta):
//       d[0] = 0, d[i] = v[i] - v[i-1]
//       out[i] = zigzag(d[i] - d[i-1])        (d[-1] taken as 0)
//
// and out[i] = 0 at i >= len. All arithmetic is uint32, so it wraps as the
// int32 lanes of the reference do (signed overflow is undefined in C++);
// zigzag shifts the *signed* second difference arithmetically.
//
// Bound on the H100: memory. Each element reads 4 bytes and writes 4, and
// does a handful of integer operations. The design: one thread per
// element, over a grid-stride loop on the flattened grid, so neighbouring
// threads read and write neighbouring words. The neighbours v[i-1] and
// v[i-2] are re-read from global memory; they were just read by the
// neighbouring threads of the same warp and come from L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void colcodec_kernel(const int32_t* __restrict__ vals,
                                const int32_t* __restrict__ lens,
                                const int32_t* __restrict__ mode,
                                const int32_t* __restrict__ refv,
                                uint32_t* __restrict__ out,
                                long long rows, long long cols) {
  const long long total = rows * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const long long r = e / cols;
    const long long i = e - r * cols;
    uint32_t res = 0;
    if (i < (long long)lens[r]) {
      const int32_t* v = vals + r * cols;
      const int m = mode[r];
      const uint32_t x0 = (uint32_t)v[i];
      if (m == 3) {
        res = x0 - (uint32_t)refv[r];
      } else {
        const uint32_t x1 = i >= 1 ? (uint32_t)v[i - 1] : 0u;
        const uint32_t d = i >= 1 ? x0 - x1 : 0u;
        if (m == 1) {
          res = d;
        } else {
          const uint32_t dprev = i >= 2 ? x1 - (uint32_t)v[i - 2] : 0u;
          const uint32_t dd = d - dprev;
          res = (dd << 1) ^ (uint32_t)((int32_t)dd >> 31);
        }
      }
    }
    out[e] = res;
  }
}

}  // namespace

extern "C" int colcodec_transform_launch(const int32_t* vals, const int32_t* lens,
                                         const int32_t* mode, const int32_t* refv,
                                         uint32_t* out, long long rows, long long cols,
                                         void* stream) {
  const long long total = rows * cols;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks per SM
  colcodec_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      vals, lens, mode, refv, out, rows, cols);
  return (int)cudaGetLastError();
}
