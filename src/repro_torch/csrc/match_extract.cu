// Fused wildcard match + parameter-span extraction for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_me_kernel` of the JAX package
// (src/repro/kernels/match_extract.py, `match_extract`). For line n
// (tokens logs[n, :T], length lens[n], read at lc = min(len, T)) it
// finds the lowest template id k whose reachability DP
//
//   col[i] = (i == 0)                          before the first step
//   literal t_j:  col[i] = col[i-1] & (log[i-1] == t_j)
//   star (id 1):  col[i] = OR_{i' < i} col[i']  (absorbs >= 1 token)
//
// run for steps j < min(t_len, Tt) holds col[lc], and writes assign[n] =
// k (-1 if none; t_len < 0 matches nothing; lc < 0 matches nothing). For
// that template it walks back from i = lc: a literal moves i to i-1, a
// star takes the span [i', i) with i' the largest position <= i-1 set in
// the column before the star (later stars take the shortest span), and
// writes it into slot s of spans[n, s, :] for the template's s-th star
// (s < n_slots). Every other slot of the row, and the whole row of a line
// that matches nothing, is 0.
//
// Bound on the H100: integer operations (the DP steps), against a few
// bytes a line. The TPU kernel ran all K templates for a tile of 64
// lines and kept every DP column of a template in a (BN, Tt+1, T+1)
// scratch. Here one thread owns one line and runs the templates in
// ascending id, stopping at its first hit: no later template can change
// the result. Its column is a bit mask of W 32-bit words (W*32 > T) in
// registers, cut to bits <= lc, so an empty column ends a template at
// once (most end at their first literal). Only the columns met just
// before a star are kept: the walk back reads no other. A column is
// empty once its steps outrun lc (each step lifts the lowest set bit),
// so at most T+1 <= 32*W are kept. They live in local memory, 32*W*W
// words a thread, indexed by the star; the largest position <= i-1 is a
// highest-set-bit query, `__clz` on the masked word. All threads of a
// warp read the same template token at the same time (one address, a
// broadcast) until they diverge at their hits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kStar = 1;
constexpr int kThreads = 128;

template <int W>
__global__ void match_extract_kernel(const int32_t* __restrict__ logs,
                                     const int32_t* __restrict__ lens,
                                     const int32_t* __restrict__ tmpl,
                                     const int32_t* __restrict__ tlens,
                                     int32_t* __restrict__ assign, int32_t* __restrict__ spans,
                                     long long n_lines, int t, int k, int tt, int n_slots) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_lines) return;
  int32_t* sp = spans + n * (long long)(2 * n_slots);
  for (int s = 0; s < 2 * n_slots; ++s) sp[s] = 0;
  const int len = __ldg(lens + n);
  const int lc = len < t ? len : t;
  int best = -1;
  if (lc >= 0) {
    const int32_t* line = logs + n * (long long)t;
    uint32_t keep[W];  // bits 0..lc
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int lo = w * 32;
      keep[w] = lc >= lo + 31 ? 0xFFFFFFFFu : (lc < lo ? 0u : (0xFFFFFFFFu >> (31 - (lc - lo))));
    }
    uint32_t saved[32 * W * W];  // the column before each star, by star index
    for (int kk = 0; kk < k && best < 0; ++kk) {
      const int tl = __ldg(tlens + kk);
      if (tl < 0) continue;
      const int steps = tl < tt ? tl : tt;
      const int32_t* tp = tmpl + (long long)kk * tt;
      uint32_t col[W];
#pragma unroll
      for (int w = 0; w < W; ++w) col[w] = w == 0 ? 1u : 0u;
      int stars = 0;
      bool alive = true;
      for (int j = 0; j < steps && alive; ++j) {
        const int32_t tj = __ldg(tp + j);
        uint32_t any = 0;
        if (tj == kStar) {
#pragma unroll
          for (int w = 0; w < W; ++w) saved[stars * W + w] = col[w];
          ++stars;
          bool below = true;  // at or below the word of the lowest set bit
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
              if (i < lc && __ldg(line + i) == tj) {
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
        alive = any != 0u;
      }
      if (!alive) continue;
      uint32_t word = 0;
#pragma unroll
      for (int w = 0; w < W; ++w)
        if (w == (lc >> 5)) word = col[w];
      if (!((word >> (lc & 31)) & 1u)) continue;

      best = kk;
      int i = lc;
      for (int j = steps; j >= 1; --j) {
        if (__ldg(tp + j - 1) != kStar) {
          --i;
          continue;
        }
        --stars;
        // largest i' <= i - 1 set in the column before this star (0 if none)
        int ip = 0;
        const int top = i - 1;
        for (int w = top >> 5; top >= 0 && w >= 0; --w) {
          uint32_t m = saved[stars * W + w];
          if (w == (top >> 5)) m &= 0xFFFFFFFFu >> (31 - (top & 31));
          if (m) {
            ip = w * 32 + 31 - __clz(m);
            break;
          }
        }
        if (stars < n_slots) {
          sp[2 * stars] = ip;
          sp[2 * stars + 1] = i;
        }
        i = ip;
      }
    }
  }
  assign[n] = best;
}

}  // namespace

// Line widths above 255 are refused (the caller checks).
extern "C" int match_extract_launch(const int32_t* logs, const int32_t* lens,
                                    const int32_t* tmpl, const int32_t* tlens, int32_t* assign,
                                    int32_t* spans, long long n, int t, int k, int tt,
                                    int n_slots, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
#define ME_LAUNCH(W)                                                                      \
  match_extract_kernel<W><<<blocks, kThreads, 0, s>>>(logs, lens, tmpl, tlens, assign, \
                                                      spans, n, t, k, tt, n_slots);      \
  return (int)cudaGetLastError()
  switch ((t + 1 + 31) / 32) {
    case 1: ME_LAUNCH(1);
    case 2: ME_LAUNCH(2);
    case 3: ME_LAUNCH(3);
    case 4: ME_LAUNCH(4);
    case 5: ME_LAUNCH(5);
    case 6: ME_LAUNCH(6);
    case 7: ME_LAUNCH(7);
    case 8: ME_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ME_LAUNCH
}
