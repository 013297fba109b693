// Batched wildcard-template matching for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_match_kernel` of the JAX package
// (src/repro/kernels/wildcard_match.py, `wildcard_match`). For line n
// (tokens logs[n, :T], length lens[n]) and template k (tokens
// templates[k, :Tt], length t_lens[k]) it runs the reachability DP
//
//   col[i] = (i == 0)                          before the first step
//   literal t_j:  col[i] = col[i-1] & (log[i-1] == t_j)
//   star (id 1):  col[i] = OR_{i' < i} col[i']  (absorbs >= 1 token)
//
// for steps j < min(t_len, Tt), and writes col[len] to out[n, k].
// t_len < 0 (padding, and the over-length sentinel of pack_templates)
// and len > T match nothing; len < 0 reads col[0] as the reference does.
//
// Bound on the H100: integer operations, N*K pairs times the template's
// steps. The TPU kernel carried each (BN, BK, T+1) column tile as int32
// words and compared every position on every step. Here one thread owns
// one (line, template) pair and holds its column as a bit mask of
// W 32-bit words (W*32 > T, so bit len is always present):
//
//   literal: the set bits of col are walked (ffs), and bit i+1 of the new
//            column is set where log[i] == t_j. Only positions i < len
//            are looked at: bits never move down, so a bit above len can
//            never reach the bit that is read.
//   star:    every bit strictly above the lowest set bit is set (bit 0
//            stays clear), then the column is cut to bits <= len.
//
// A column that becomes empty stays empty, so the pair stops there: most
// pairs fail at their first literal and cost one compare. Pairs are
// flattened as p = n*K + k, so out[p] is written coalesced and the lines
// of a block are contiguous rows; a thread reads only the line positions
// its column holds bits at, through the read-only cache, and the block's
// lines are not staged in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kStar = 1;

template <int W>
__global__ void wildcard_match_kernel(const int32_t* __restrict__ logs,
                                      const int32_t* __restrict__ lens,
                                      const int32_t* __restrict__ tmpl,
                                      const int32_t* __restrict__ tlens,
                                      uint8_t* __restrict__ out, long long n_lines,
                                      int t, int k, int tt) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_lines * (long long)k) return;
  const long long n = p / k;
  const int kk = (int)(p - n * k);
  const int len = __ldg(lens + n);
  const int tl = __ldg(tlens + kk);
  if (tl < 0 || len > t) {
    out[p] = 0;
    return;
  }
  const int at = len < 0 ? 0 : len;  // the bit that is read, at <= t < W*32
  const int32_t* line = logs + n * (long long)t;
  const int32_t* tp = tmpl + (long long)kk * tt;

  // bits 0..at kept after a star step
  uint32_t keep[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int lo = w * 32;
    keep[w] = at >= lo + 31 ? 0xFFFFFFFFu : (at < lo ? 0u : (0xFFFFFFFFu >> (31 - (at - lo))));
  }
  uint32_t col[W];
#pragma unroll
  for (int w = 0; w < W; ++w) col[w] = w == 0 ? 1u : 0u;

  const int steps = tl < tt ? tl : tt;
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
          nw = 0xFFFFFFFFu;
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
          if (i < at && __ldg(line + i) == tj) {
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
    if (!any) break;
  }
  uint32_t word = 0;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w == (at >> 5)) word = col[w];
  out[p] = (uint8_t)((word >> (at & 31)) & 1u);
}

template <int W>
cudaError_t launch(const int32_t* logs, const int32_t* lens, const int32_t* tmpl,
                   const int32_t* tlens, uint8_t* out, long long n, int t, int k, int tt,
                   cudaStream_t stream) {
  const int threads = 256;
  const long long pairs = n * (long long)k;
  const long long blocks = (pairs + threads - 1) / threads;
  wildcard_match_kernel<W><<<(unsigned)blocks, threads, 0, stream>>>(logs, lens, tmpl, tlens,
                                                                       out, n, t, k, tt);
  return cudaGetLastError();
}

}  // namespace

// Column words needed for a line width t: W*32 >= t+1. Widths above 255
// are refused (the caller checks; LogzipConfig.max_tokens is 128).
extern "C" int wildcard_match_launch(const int32_t* logs, const int32_t* lens,
                                     const int32_t* tmpl, const int32_t* tlens, uint8_t* out,
                                     long long n, int t, int k, int tt, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((t + 1 + 31) / 32) {
    case 1: return (int)launch<1>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 2: return (int)launch<2>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 3: return (int)launch<3>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 4: return (int)launch<4>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 5: return (int)launch<5>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 6: return (int)launch<6>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 7: return (int)launch<7>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    case 8: return (int)launch<8>(logs, lens, tmpl, tlens, out, n, t, k, tt, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
