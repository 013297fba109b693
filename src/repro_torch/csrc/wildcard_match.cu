// Wildcard-template matching for Hopper (sm_90a): two kernels over one DP.
//
// Replaces the Pallas kernel `_match_kernel` of the JAX package
// (src/repro/kernels/wildcard_match.py, `wildcard_match`) and the host
// composition around it (src/repro/kernels/ops.py, `match_first_bucketed`:
// one (N, K) launch per first-token bucket, the matrix copied back, then
// any / argmax / min on the host). For line n (tokens logs[n, :T], length
// lens[n]) and template k (tokens templates[k, :Tt], length t_lens[k]) the
// reachability DP is
//
//   col[i] = (i == 0)                          before the first step
//   literal t_j:  col[i] = col[i-1] & (log[i-1] == t_j)
//   star (id 1):  col[i] = OR_{i' < i} col[i']  (absorbs >= 1 token)
//
// for steps j < min(t_len, Tt), and the pair matches iff col[len] is set.
// t_len < 0 (padding, and the over-length sentinel of pack_templates)
// and len > T match nothing; len < 0 reads col[0] as the reference does.
//
// `wildcard_dp` runs the DP for one pair in one thread, the column held as
// a bit mask of W 32-bit words (W*32 > T, so bit len is always present):
//
//   literal: the set bits of col are walked (ffs), and bit i+1 of the new
//            column is set where log[i] == t_j. Only positions i < len
//            are looked at: bits never move down, so a bit above len can
//            never reach the bit that is read.
//   star:    every bit strictly above the lowest set bit is set (bit 0
//            stays clear), then the column is cut to bits <= len.
//
// A column that becomes empty stays empty, so the pair stops there: most
// pairs fail at their first literal and cost one compare. The line's
// tokens are read from shared memory, where the block staged them once
// with coalesced loads, in place of a global load at every set bit.
//
// wildcard_first_kernel (the main path, `match_first`): the lowest-id
// template that matches each line, -1 for none. On the H100 the work the
// function needs is the (line, candidate) pairs up to each line's first
// hit (31x fewer than all pairs of the first-token buckets on 1M HDFS
// lines), and what it must move is N int32 results: the (N, K) byte matrix
// of the bucketed design was 93% of that design's bytes and its copy to
// the host took 16x the kernel's time. So one warp takes one line:
//   - its candidates are the line's first-token bucket (bucket_tpl over
//     bucket_ptr[line_bucket[n]], ascending) merged with the star-first
//     templates (star_tpl, ascending); lane l takes merged position
//     32g + l, found by a merge-path binary search over the two lists
//     (no per-line list is built anywhere);
//   - each lane runs the DP on its candidate; __ballot_sync marks the
//     lanes that matched and, since lane order is id order, the lowest
//     set lane holds the lowest id. The warp stops at the first group of
//     32 that holds a hit; a line that matches nothing runs every
//     candidate. The lanes of a group run their DPs side by side, so the
//     groups past a line's hit cost nothing, and a group costs its
//     longest DP;
//   - the line's tokens (T <= 255, at most 1 KB) go to the warp's slice of
//     shared memory once; all indices are 32-bit, and no division is left
//     on the device.
//
// wildcard_match_kernel (the function-level counterpart of the Pallas
// kernel): the full (N, K) byte matrix. A 2-D grid, lines x template
// tiles: a block of kTileN lines x kTileK templates stages its lines in
// shared memory; thread (x, y) takes template tile*kTileK + x against
// line y, so neighbouring threads write neighbouring bytes of a row.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kStar = 1;
constexpr int kWarps = 8;    // lines (one a warp) per block of the first-hit kernel
constexpr int kTileK = 32;   // templates per block of the (N, K) kernel
constexpr int kTileN = 8;    // lines per block of the (N, K) kernel
constexpr unsigned kFull = 0xFFFFFFFFu;

// The DP of one (line, template) pair: line[0:at] in shared memory, `steps`
// template tokens at tp; -> col[at].
template <int W>
__device__ __forceinline__ bool wildcard_dp(const int32_t* line, int at,
                                            const int32_t* __restrict__ tp, int steps) {
  // bits 0..at kept after a star step
  uint32_t keep[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int lo = w * 32;
    keep[w] = at >= lo + 31 ? kFull : (at < lo ? 0u : (kFull >> (31 - (at - lo))));
  }
  uint32_t col[W];
#pragma unroll
  for (int w = 0; w < W; ++w) col[w] = w == 0 ? 1u : 0u;

  for (int j = 0; j < steps; ++j) {
    const int32_t tj = __ldg(tp + j);
    uint32_t any = 0;
    if (tj == kStar) {
      bool below = true;  // still at or below the word of the lowest set bit
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t m = col[w];
        uint32_t nw;
        if (!below) {
          nw = kFull;
        } else if (m) {
          nw = ~(m ^ (m - 1u));  // bits strictly above the lowest set bit
          below = false;
        } else {
          nw = 0u;
        }
        col[w] = nw & keep[w];
        any |= col[w];
      }
    } else {
      uint32_t nxt[W];
#pragma unroll
      for (int w = 0; w < W; ++w) nxt[w] = 0u;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        uint32_t m = col[w];
        while (m) {
          const int b = __ffs(m) - 1;
          m &= m - 1u;
          const int i = w * 32 + b;
          if (i < at && line[i] == tj) {
            // set bit i+1 (<= at < W*32); indices stay static so the
            // column lives in registers
            if (b < 31) {
              nxt[w] |= 2u << b;
            } else if (w + 1 < W) {
              nxt[w + 1] |= 1u;
            }
          }
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        col[w] = nxt[w];
        any |= nxt[w];
      }
    }
    if (!any) return false;
  }
  uint32_t word = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == (at >> 5)) word = col[w];
  return (word >> (at & 31)) & 1u;
}

template <int W>
__global__ void wildcard_match_kernel(const int32_t* __restrict__ logs,
                                      const int32_t* __restrict__ lens,
                                      const int32_t* __restrict__ tmpl,
                                      const int32_t* __restrict__ tlens,
                                      uint8_t* __restrict__ out, int n, int t, int k, int tt) {
  extern __shared__ int32_t s_lines[];  // kTileN rows of t tokens
  const int n0 = blockIdx.x * kTileN;
  const int rows = min(kTileN, n - n0);
  const int32_t* src = logs + (size_t)n0 * t;
  for (int i = threadIdx.y * kTileK + threadIdx.x; i < rows * t; i += kTileK * kTileN)
    s_lines[i] = __ldg(src + i);
  __syncthreads();
  const int r = threadIdx.y;
  const int kk = blockIdx.y * kTileK + threadIdx.x;
  if (r >= rows || kk >= k) return;
  const int len = __ldg(lens + n0 + r);
  const int tl = __ldg(tlens + kk);
  bool hit = false;
  if (tl >= 0 && len <= t) {
    const int at = len < 0 ? 0 : len;  // the bit that is read, at <= t < W*32
    hit = wildcard_dp<W>(s_lines + r * t, at, tmpl + (size_t)kk * tt, min(tl, tt));
  }
  out[(size_t)(n0 + r) * k + kk] = hit;
}

template <int W>
__global__ void wildcard_first_kernel(const int32_t* __restrict__ logs,
                                      const int32_t* __restrict__ lens,
                                      const int32_t* __restrict__ tmpl,
                                      const int32_t* __restrict__ tlens,
                                      const int32_t* __restrict__ line_bucket,
                                      const int32_t* __restrict__ bucket_ptr,
                                      const int32_t* __restrict__ bucket_tpl,
                                      const int32_t* __restrict__ star_tpl, int n_buckets,
                                      int n_star, int32_t* __restrict__ out, int n, int t, int k,
                                      int tt) {
  extern __shared__ int32_t s_lines[];  // kWarps rows of t tokens
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nn = blockIdx.x * kWarps + warp;
  if (nn >= n) return;  // the whole warp: nothing below synchronises the block
  const int len = __ldg(lens + nn);
  int found = -1;
  if (len <= t) {
    const int at = len < 0 ? 0 : len;
    int32_t* line = s_lines + warp * t;
    const int32_t* src = logs + (size_t)nn * t;
    for (int i = lane; i < at; i += 32) line[i] = __ldg(src + i);
    __syncwarp();
    const int b = __ldg(line_bucket + nn);
    const int32_t* lit = bucket_tpl;
    int n_lit = 0;
    if (b >= 0 && b < n_buckets) {
      const int p0 = __ldg(bucket_ptr + b);
      lit += p0;
      n_lit = __ldg(bucket_ptr + b + 1) - p0;
    }
    const int total = n_lit + n_star;
    for (int base = 0; base < total; base += 32) {  // warp-uniform
      const int d = base + lane;
      int cand = -1;
      bool hit = false;
      if (d < total) {
        // merge path: the first d merged ids are lit[0:lo] and star[0:d-lo]
        int lo = max(0, d - n_star), hi = min(d, n_lit);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(lit + mid) < __ldg(star_tpl + d - 1 - mid)) lo = mid + 1;
          else hi = mid;
        }
        const int s = d - lo;
        cand = (lo < n_lit && (s >= n_star || __ldg(lit + lo) < __ldg(star_tpl + s)))
                   ? __ldg(lit + lo) : __ldg(star_tpl + s);
        if (cand >= 0 && cand < k) {
          const int tl = __ldg(tlens + cand);
          hit = tl >= 0 && wildcard_dp<W>(line, at, tmpl + (size_t)cand * tt, min(tl, tt));
        }
      }
      const unsigned hits = __ballot_sync(kFull, hit);
      if (hits) {  // lanes hold ascending ids: the lowest set lane wins
        found = __shfl_sync(kFull, cand, __ffs(hits) - 1);
        break;
      }
    }
  }
  if (lane == 0) out[nn] = found;
}

template <int W>
cudaError_t launch_match(const int32_t* logs, const int32_t* lens, const int32_t* tmpl,
                         const int32_t* tlens, uint8_t* out, int n, int t, int k, int tt,
                         cudaStream_t stream) {
  const dim3 grid((n + kTileN - 1) / kTileN, (k + kTileK - 1) / kTileK);
  const dim3 block(kTileK, kTileN);
  const size_t smem = sizeof(int32_t) * kTileN * t;
  wildcard_match_kernel<W><<<grid, block, smem, stream>>>(logs, lens, tmpl, tlens, out, n, t,
                                                          k, tt);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_first(const int32_t* logs, const int32_t* lens, const int32_t* tmpl,
                         const int32_t* tlens, const int32_t* line_bucket,
                         const int32_t* bucket_ptr, const int32_t* bucket_tpl,
                         const int32_t* star_tpl, int n_buckets, int n_star, int32_t* out,
                         int n, int t, int k, int tt, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  const size_t smem = sizeof(int32_t) * kWarps * t;
  wildcard_first_kernel<W><<<blocks, kWarps * 32, smem, stream>>>(
      logs, lens, tmpl, tlens, line_bucket, bucket_ptr, bucket_tpl, star_tpl, n_buckets, n_star,
      out, n, t, k, tt);
  return cudaGetLastError();
}

// Column words for a line width t: W*32 >= t+1. Widths above 255 are
// refused (the caller checks; LogzipConfig.max_tokens is 128).
#define WILDCARD_DISPATCH(t, CALL)                \
  switch (((t) + 1 + 31) / 32) {                  \
    case 1: return (int)CALL(1);                  \
    case 2: return (int)CALL(2);                  \
    case 3: return (int)CALL(3);                  \
    case 4: return (int)CALL(4);                  \
    case 5: return (int)CALL(5);                  \
    case 6: return (int)CALL(6);                  \
    case 7: return (int)CALL(7);                  \
    case 8: return (int)CALL(8);                  \
    default: return (int)cudaErrorInvalidValue;   \
  }

}  // namespace

// (N, T), (N,) x (K, Tt), (K,) int32 -> out (N, K) uint8 match matrix.
extern "C" int wildcard_match_launch(const int32_t* logs, const int32_t* lens,
                                     const int32_t* tmpl, const int32_t* tlens, uint8_t* out,
                                     long long n, int t, int k, int tt, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(W) launch_match<W>(logs, lens, tmpl, tlens, out, (int)n, t, k, tt, s)
  WILDCARD_DISPATCH(t, CALL)
#undef CALL
}

// -> out (N,) int32: the lowest template id of the line's bucket and the
// star-first list that matches each line, or -1. Bucket indexes outside
// [0, n_buckets) and template ids outside [0, K) are no candidates.
extern "C" int wildcard_first_launch(const int32_t* logs, const int32_t* lens,
                                     const int32_t* tmpl, const int32_t* tlens,
                                     const int32_t* line_bucket, const int32_t* bucket_ptr,
                                     const int32_t* bucket_tpl, const int32_t* star_tpl,
                                     int n_buckets, int n_star, int32_t* out, long long n, int t,
                                     int k, int tt, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CALL(W)                                                                          \
  launch_first<W>(logs, lens, tmpl, tlens, line_bucket, bucket_ptr, bucket_tpl, star_tpl, \
                  n_buckets, n_star, out, (int)n, t, k, tt, s)
  WILDCARD_DISPATCH(t, CALL)
#undef CALL
}
