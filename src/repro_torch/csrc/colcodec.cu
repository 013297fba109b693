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
// Bound on the H100: bytes. Each element reads 4 bytes and writes 4 and
// does a handful of integer operations, so the kernel can only be as fast
// as its loads and stores. The design spends nothing else per element:
//
// - A row-tiled grid: blockIdx.y walks the rows, blockIdx.x the tiles of a
//   row. A row's len, mode and ref are read once per block (by thread 0,
//   into shared memory) and the mode branch is uniform over the block, so
//   there is no 64-bit divide and no per-element read of them.
// - Each thread takes a group of 4 consecutive elements that lies on a
//   16-byte boundary of memory, read with one 16-byte load and written
//   with one 16-byte store. A row that does not start on a 16-byte
//   boundary (r * C % 4 != 0) begins with a partial group, and one that
//   does not end on one ends with a partial group; those two are read and
//   written element by element (the scalar head and tail).
// - v[i-1] and v[i-2] are the thread's own registers, or the previous
//   lane's last two values through __shfl_up_sync; a warp's lane 0 takes
//   them from a two-element halo in shared memory that the previous warp's
//   lane 31 wrote, and the block's first thread from the two elements
//   before its tile, read once by thread 0. Nothing is re-read from
//   device memory.
// - The launcher picks the tiling from the row's width: blocks of two
//   warps (one on a row of at most 32 groups), a group a thread, two on a
//   row of about a million elements. Blocks that small had the shortest
//   times at every width timed; a short row of an LZJS chunk launches no
//   idle warps.
//
// Where the input and output rows are not on the same 16-byte phase (an
// input view at an odd offset), every group takes the element-wise path.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // a block's threads, at most
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroups = 2;  // groups a thread takes, at most
constexpr unsigned kFull = 0xffffffffu;

// The group of 4 elements at i0 (some of them may lie outside [0, cols)).
template <bool kVec>
__device__ __forceinline__ bool load_group(const int32_t* __restrict__ v, int i0, int cols,
                                           uint32_t (&x)[4]) {
  const bool full = kVec && i0 >= 0 && i0 + 3 < cols;
  if (full) {
    const int4 q = *reinterpret_cast<const int4*>(v + i0);
    x[0] = (uint32_t)q.x;
    x[1] = (uint32_t)q.y;
    x[2] = (uint32_t)q.z;
    x[3] = (uint32_t)q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      x[j] = (i >= 0 && i < cols) ? (uint32_t)v[i] : 0u;
    }
  }
  return full;
}

// out[i0 .. i0+3] from the group's values x and the two before it (m2, m1).
__device__ __forceinline__ void transform_group(const uint32_t (&x)[4], uint32_t m2, uint32_t m1,
                                                int i0, int len, int m, uint32_t ref,
                                                uint32_t (&res)[4]) {
  if (m == 3) {
#pragma unroll
    for (int j = 0; j < 4; ++j) res[j] = x[j] - ref;
  } else if (m == 1) {
    uint32_t prev = m1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      res[j] = i0 + j >= 1 ? x[j] - prev : 0u;
      prev = x[j];
    }
  } else {
    uint32_t p1 = m1, p2 = m2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      const uint32_t d = i >= 1 ? x[j] - p1 : 0u;
      const uint32_t dprev = i >= 2 ? p1 - p2 : 0u;
      const uint32_t dd = d - dprev;
      res[j] = (dd << 1) ^ (uint32_t)((int32_t)dd >> 31);
      p2 = p1;
      p1 = x[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (i0 + j >= len) res[j] = 0u;
  }
}

// A block takes a tile of kG * blockDim.x groups of a row: group g of
// sub-tile k is blockIdx.x * tile + k * blockDim.x + threadIdx.x, so each
// sub-tile's loads and stores are one coalesced run.
template <bool kVec, int kG>
__global__ void __launch_bounds__(kThreads)
colcodec_kernel(const int32_t* __restrict__ vals, const int32_t* __restrict__ lens,
                const int32_t* __restrict__ mode, const int32_t* __restrict__ refv,
                uint32_t* __restrict__ out, int rows, int cols, int lead) {
  __shared__ int32_t s_par[3];  // the row's len, mode, ref
  // v[i-2], v[i-1] before warp w of sub-tile k; [k][nwarps] ends sub-tile
  // k, [0][0] is the two elements before the block's tile
  __shared__ uint32_t s_halo[kG][kWarps + 1][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile0 = (int)(blockIdx.x * blockDim.x) * kG;  // the tile's first group
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long base = (long long)r * cols;
    // elements of the row that precede its first 16-byte boundary's group
    const int skew = (lead + (int)(base & 3)) & 3;
    const int32_t* v = vals + base;
    uint32_t* o = out + base;
    if (threadIdx.x == 0) {
      const int first = 4 * tile0 - skew;
      s_par[0] = lens[r];
      s_par[1] = mode[r];
      s_par[2] = refv[r];
      s_halo[0][0][0] = (first >= 2 && first - 2 < cols) ? (uint32_t)v[first - 2] : 0u;
      s_halo[0][0][1] = (first >= 1 && first - 1 < cols) ? (uint32_t)v[first - 1] : 0u;
    }
    uint32_t x[kG][4], m2[kG], m1[kG];
    bool full[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int i0 = 4 * (tile0 + k * (int)blockDim.x + (int)threadIdx.x) - skew;
      full[k] = load_group<kVec>(v, i0, cols, x[k]);
    }
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      m2[k] = __shfl_up_sync(kFull, x[k][2], 1);
      m1[k] = __shfl_up_sync(kFull, x[k][3], 1);
      if (lane == 31) {
        s_halo[k][warp + 1][0] = x[k][2];
        s_halo[k][warp + 1][1] = x[k][3];
      }
    }
    __syncthreads();
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        const uint32_t* h = warp > 0 ? s_halo[k][warp] : k > 0 ? s_halo[k - 1][nwarps]
                                                               : s_halo[0][0];
        m2[k] = h[0];
        m1[k] = h[1];
      }
    }
    const int len = s_par[0];
    const int m = s_par[1];
    const uint32_t ref = (uint32_t)s_par[2];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      const int i0 = 4 * (tile0 + k * (int)blockDim.x + (int)threadIdx.x) - skew;
      uint32_t res[4];
      transform_group(x[k], m2[k], m1[k], i0, len, m, ref, res);
      if (full[k]) {
        *reinterpret_cast<uint4*>(o + i0) = make_uint4(res[0], res[1], res[2], res[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j;
          if (i >= 0 && i < cols) o[i] = res[j];
        }
      }
    }
    __syncthreads();  // s_par and s_halo are rewritten for the next row
  }
}

template <bool kVec>
void launch(int per_thread, dim3 grid, int threads, cudaStream_t stream, const int32_t* vals,
            const int32_t* lens, const int32_t* mode, const int32_t* refv, uint32_t* out,
            int rows, int cols, int lead) {
  if (per_thread == 1) {
    colcodec_kernel<kVec, 1><<<grid, threads, 0, stream>>>(vals, lens, mode, refv, out, rows,
                                                           cols, lead);
  } else {
    colcodec_kernel<kVec, kMaxGroups><<<grid, threads, 0, stream>>>(vals, lens, mode, refv, out,
                                                                    rows, cols, lead);
  }
}

}  // namespace

extern "C" int colcodec_transform_launch(const int32_t* vals, const int32_t* lens,
                                         const int32_t* mode, const int32_t* refv,
                                         uint32_t* out, long long rows, long long cols,
                                         void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaSuccess;
  // in-row indices are int: 4 * group, up to a whole tile past the row's
  // end, must not overflow
  if (cols > (long long)INT_MAX - 4 * kThreads * kMaxGroups - 8 ||
      rows > (long long)INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  // Groups a row spans, at the worst skew (3 elements before its first
  // boundary). Two warps a block (fewer on a narrower row), a group a
  // thread; two groups a thread on a row long enough that the blocks
  // still number at least 4 an SM (an H100 has 132). Timed in turns
  // against 32, 128 and 256 threads and 1, 2 and 4 groups a thread, this
  // was the fastest or within the noise of it at every width.
  const long long groups = (cols + 3 + 3) / 4;
  const int threads = groups >= kThreads ? kThreads : (int)((groups + 31) / 32 * 32);
  const int per_thread = groups >= 4LL * 132 * kMaxGroups * kThreads ? kMaxGroups : 1;
  const long long tile = (long long)threads * per_thread;
  const dim3 grid((unsigned)((groups + tile - 1) / tile), (unsigned)(rows < 65535 ? rows : 65535));
  const uintptr_t in_addr = (uintptr_t)vals, out_addr = (uintptr_t)out;
  const int lead = (int)((in_addr >> 2) & 3);
  if ((in_addr & 15) == (out_addr & 15)) {
    launch<true>(per_thread, grid, threads, (cudaStream_t)stream, vals, lens, mode, refv, out,
                 (int)rows, (int)cols, lead);
  } else {
    launch<false>(per_thread, grid, threads, (cudaStream_t)stream, vals, lens, mode, refv, out,
                  (int)rows, (int)cols, lead);
  }
  return (int)cudaGetLastError();
}
