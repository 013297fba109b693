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
// Bound on the H100: bytes. The function reads each line's tokens up to
// its length once and writes 4 * (1 + 2 * n_slots) bytes a line; its DP
// is a few integer operations a step, and most templates end at their
// first literal. The TPU kernel ran all K templates for a tile of 64
// lines and kept every DP column in a (BN, Tt+1, T+1) scratch. Here a
// block takes a tile of L consecutive lines, one thread a line, and:
//
// - stages the tile's rows of `logs`, one contiguous run of L*T int32, in
//   shared memory with 16-byte loads (scalar at the unaligned edges), at
//   an odd row stride so that threads reading the same position of their
//   own lines hit distinct banks;
// - for lines of at most 31 tokens (W = 1), holds the line's tokens in
//   16 or 32 registers, so a literal step is that many compares and a
//   shift, col = ((col & E(t_j)) << 1) & keep, with no memory access and
//   whatever the column's density; wider lines walk the column's set bits
//   and read the tokens from shared memory;
// - stages the templates (their first min(Tt, T) tokens) in shared
//   memory, up to 32 at a time in ascending id; a line keeps its first
//   hit, and the block leaves the stages once every line has one. Per
//   stage a thread first marks, in one 32-bit mask, the templates that can
//   match its line: at most lc steps (every step lifts the column's lowest
//   bit) and a first token that is a star or the line's first token;
// - runs the marked templates in ascending id as one flat loop, a step per
//   iteration, moving to the next template when the column empties, so a
//   warp runs as many iterations as its longest line needs, not the sum
//   over templates of each template's longest run. The column is a bit
//   mask of W 32-bit words (W*32 > T) in registers, cut to bits <= lc;
// - keeps only the columns met just before each star, in shared memory
//   laid out [star][word][thread] (no local memory). The walk back reads
//   them, finds the largest position <= i-1 with `__clz`, and packs each
//   span (start | end << 16, both <= 255) in place of its column;
// - writes assign from registers (one int a thread, coalesced) and the
//   tile's spans, L*2*n_slots consecutive int32, as one coalesced run from
//   shared memory, zeros included, so no separate zeroing pass is needed.
//
// The launcher sizes the tiling from the shapes: every template in one
// stage up to 32, and L = 128 lines a block, halved until the block's
// shared memory (`smem_words`) fits a 96 KB budget.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kStar = 1;
constexpr int kMaxLines = 128;              // threads (lines) of a block
constexpr int kSmemBudget = 96 * 1024;      // bytes of shared memory a block is sized to
constexpr int kMaxStage = 32;               // templates a stage (one bit each in a mask)

// int32 words of dynamic shared memory for one block
long long smem_words(int lines, int w, int t, int kt, int ttc) {
  const int cap = ttc > 0 ? ttc : 1;
  return (long long)lines * (t | 1) + (long long)kt * ttc + kt
         + (long long)cap * (w * lines + 1) + 2LL * lines;
}

// word w of the mask of bits 0..lc (recomputed where needed: W fewer live registers)
__device__ __forceinline__ uint32_t keep_word(int lc, int w) {
  const int lo = w * 32;
  return lc >= lo + 31 ? 0xFFFFFFFFu : (lc < lo ? 0u : (0xFFFFFFFFu >> (31 - (lc - lo))));
}

// token e of the tile's flat run into row e / t of the staged lines
// (magic = ceil(2^32 / t): exact for e < 2^24)
__device__ __forceinline__ void stage_token(int32_t* sline, int e, int32_t v, int t, int ts,
                                            unsigned magic) {
  const int row = t == 1 ? e : (int)__umulhi((unsigned)e, magic);
  sline[row * ts + (e - row * t)] = v;
}

// A literal step over a column wider than the registered tokens: word w
// (and, by recursion, the words above it) from the column's set bits, the
// tokens read from shared memory. Recursion keeps every index of col a
// constant, so the column stays in registers.
template <int W, int w = 0>
__device__ __forceinline__ void literal_words(uint32_t (&col)[W], const int32_t* line, int lc,
                                              int32_t tj, uint32_t carry, uint32_t& any) {
  if constexpr (w < W) {
    uint32_t m = col[w], hit = 0;
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1u;
      const int i = w * 32 + b;
      if (i < lc && line[i] == tj) hit |= 1u << b;
    }
    col[w] = ((hit << 1) | carry) & keep_word(lc, w);
    any |= col[w];
    literal_words<W, w + 1>(col, line, lc, tj, hit >> 31, any);
  }
}

// P: the line's tokens held in P registers (16 or 32, W = 1 only); 0:
// read from shared memory at each set bit of the column. The bound of one
// resident block lets ptxas give every instantiation the registers it
// needs: without it, five of nine spilled to a stack frame.
template <int W, int P>
__global__ void __launch_bounds__(kMaxLines, 1)
match_extract_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ lens,
                     const int32_t* __restrict__ tmpl, const int32_t* __restrict__ tlens,
                     int32_t* __restrict__ assign, int32_t* __restrict__ spans,
                     long long n_lines, int t, int k, int tt, int n_slots, int kt,
                     unsigned magic_t) {
  extern __shared__ __align__(16) int32_t smem[];
  const int nl = blockDim.x;  // L
  const int tid = threadIdx.x;
  const int ts = t | 1;                 // odd row stride
  const int ttc = tt < t ? tt : t;      // template tokens kept
  const int ss = W * nl + 1;            // stride of one star's saved column
  int32_t* sline = smem;
  int32_t* stmpl = sline + nl * ts;
  int32_t* ssteps = stmpl + kt * ttc;
  uint32_t* ssaved = reinterpret_cast<uint32_t*>(ssteps + kt);
  int32_t* sassign = reinterpret_cast<int32_t*>(ssaved + (ttc > 0 ? ttc : 1) * ss);
  int32_t* snst = sassign + nl;

  const long long line0 = (long long)blockIdx.x * nl;
  const int lv = (int)(n_lines - line0 < nl ? n_lines - line0 : nl);

  // -- the tile's lines: flat int32 [line0*T, (line0+lv)*T) -> sline[row*ts + col]
  {
    const int cnt = lv * t;
    const int32_t* g = logs + line0 * t;
    int head = cnt, nvec = 0;
    if ((reinterpret_cast<uintptr_t>(logs) & 15) == 0) {
      head = (int)((4 - ((line0 * t) & 3)) & 3);
      head = head < cnt ? head : cnt;
      nvec = (cnt - head) >> 2;
    }
    for (int e = tid; e < head; e += nl) stage_token(sline, e, __ldg(g + e), t, ts, magic_t);
    const int4* gv = reinterpret_cast<const int4*>(g + head);
    for (int u = tid; u < nvec; u += nl) {
      const int4 v = __ldg(gv + u);
      const int e = head + 4 * u;
      stage_token(sline, e, v.x, t, ts, magic_t);
      stage_token(sline, e + 1, v.y, t, ts, magic_t);
      stage_token(sline, e + 2, v.z, t, ts, magic_t);
      stage_token(sline, e + 3, v.w, t, ts, magic_t);
    }
    for (int e = head + 4 * nvec + tid; e < cnt; e += nl)
      stage_token(sline, e, __ldg(g + e), t, ts, magic_t);
  }
  __syncthreads();

  const int len = tid < lv ? __ldg(lens + line0 + tid) : -1;
  const int lc = len < t ? len : t;
  const int32_t* line = sline + tid * ts;
  int32_t tok[P > 0 ? P : 1];  // the line's tokens, 0 past lc
#pragma unroll
  for (int i = 0; i < (P > 0 ? P : 1); ++i) tok[i] = (P > 0 && i < lc) ? line[i] : 0;
  const int32_t tok0 = lc > 0 ? line[0] : 0;
  int best = -1, nst = 0;

  for (int k0 = 0; k0 < k; k0 += kt) {
    const int kn = k - k0 < kt ? k - k0 : kt;
    __syncthreads();  // the last stage's readers are done
    for (int e = tid; e < kn * ttc; e += nl) {
      const int r = e / ttc;
      stmpl[e] = __ldg(tmpl + (long long)(k0 + r) * tt + (e - r * ttc));
    }
    for (int r = tid; r < kn; r += nl) {
      const int tl = __ldg(tlens + k0 + r);
      const int steps = tl < tt ? tl : tt;
      ssteps[r] = (tl < 0 || steps > t) ? -1 : steps;
    }
    __syncthreads();

    if (best < 0 && lc >= 0) {
      // the templates of this stage that can match: at most lc steps, and
      // a first token that is a star or the line's first token
      uint32_t todo = 0;
      for (int r = 0; r < kn; ++r) {
        const int st = ssteps[r];
        const int32_t first = stmpl[r * ttc];  // read only where st >= 1
        if (st >= 0 && st <= lc && (st == 0 || first == kStar || first == tok0)) todo |= 1u << r;
      }
      // one flat loop over them, a step an iteration
      int r = 0, j = 0, steps = 0, stars = 0;
      const int32_t* tp = stmpl;
      uint32_t col[W];
      bool next = true;
      while (true) {
        if (next) {
          if (!todo) break;
          r = __ffs(todo) - 1;
          todo &= todo - 1u;
          steps = ssteps[r];
          tp = stmpl + r * ttc;
          j = stars = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) col[w] = w == 0 ? 1u : 0u;
          next = false;
        }
        if (j < steps) {
          const int32_t tj = tp[j++];
          uint32_t any = 0;
          if (tj == kStar) {
            uint32_t* sv = ssaved + stars * ss + tid;
#pragma unroll
            for (int w = 0; w < W; ++w) sv[w * nl] = col[w];
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
              col[w] = nw & keep_word(lc, w);
              any |= col[w];
            }
          } else {
            if constexpr (P > 0) {  // W == 1: E(t_j) from the registers
              uint32_t eq = 0;
#pragma unroll
              for (int i = 0; i < P; ++i) eq |= (uint32_t)(tok[i] == tj) << i;
              const uint32_t x = col[0] & eq & ((1u << lc) - 1u);  // lc <= 31
              col[0] = (x << 1) & keep_word(lc, 0);
              any = col[0];
            } else {  // the column's set bits, read from shared memory
              literal_words<W>(col, line, lc, tj, 0u, any);
            }
          }
          if (!any) {
            next = true;
            continue;
          }
        }
        if (j == steps) {
          // bit lc: the column lies within bits 0..lc, so it is what keep(lc - 1) drops
          uint32_t top = 0;
#pragma unroll
          for (int w = 0; w < W; ++w) top |= col[w] & ~keep_word(lc - 1, w);
          if (top) {
            best = k0 + r;
            break;
          }
          next = true;
        }
      }
      if (best >= 0) {  // the walk back over the winning template
        nst = stars;
        int i = lc;
        for (int jj = steps; jj >= 1; --jj) {
          if (tp[jj - 1] != kStar) {
            --i;
            continue;
          }
          --stars;
          uint32_t* sv = ssaved + stars * ss + tid;
          // largest i' <= i - 1 set in the column before this star (0 if none)
          int ip = 0;
          const int top = i - 1;
          for (int w = top >> 5; top >= 0 && w >= 0; --w) {
            uint32_t m = sv[w * nl];
            if (w == (top >> 5)) m &= 0xFFFFFFFFu >> (31 - (top & 31));
            if (m) {
              ip = w * 32 + 31 - __clz(m);
              break;
            }
          }
          sv[0] = (uint32_t)ip | ((uint32_t)i << 16);  // the span, where its column was
          i = ip;
        }
      }
    }
    if (!__syncthreads_or(best < 0 && lc >= 0)) break;  // every line has its hit
  }

  // -- outputs: assign from registers, the tile's spans as one coalesced run
  if (tid < lv) assign[line0 + tid] = best;
  sassign[tid] = best;
  snst[tid] = nst;
  __syncthreads();
  const int d = 2 * n_slots;
  int32_t* gsp = spans + line0 * d;
  const long long total = (long long)lv * d;
  const int dl = nl / d, dx = nl - dl * d;  // (line, slot) step for e += L
  int l = tid / d, x = tid - (tid / d) * d;
  for (long long e = tid; e < total; e += nl) {
    int32_t v = 0;
    if (sassign[l] >= 0 && (x >> 1) < snst[l]) {
      const uint32_t p = ssaved[(x >> 1) * ss + l];
      v = (int32_t)((x & 1) ? (p >> 16) : (p & 0xFFFFu));
    }
    gsp[e] = v;
    l += dl;
    x += dx;
    if (x >= d) {
      x -= d;
      ++l;
    }
  }
}

}  // namespace

// One launch: blocks of up to 128 threads (one line each), up to 32
// templates staged at a time. Line widths above 255 are refused (the
// caller checks).
extern "C" int match_extract_launch(const int32_t* logs, const int32_t* lens,
                                    const int32_t* tmpl, const int32_t* tlens, int32_t* assign,
                                    int32_t* spans, long long n, int t, int k, int tt,
                                    int n_slots, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n_slots < 1 || t < 0 || tt < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const int w = (t + 1 + 31) / 32;
  const int ttc = tt < t ? tt : t;
  const int kt = k < 1 ? 1 : (k < kMaxStage ? k : kMaxStage);
  int lines = kMaxLines;
  while (lines > 1 && 4 * smem_words(lines, w, t, kt, ttc) > kSmemBudget) lines /= 2;
  // at most 43 KB with one line (T = Tt = 255, 32 templates), so this always fits
  const long long bytes = 4 * smem_words(lines, w, t, kt, ttc);
  const unsigned magic = t >= 2 ? (unsigned)(((1ull << 32) + t - 1) / t) : 0u;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((n + lines - 1) / lines);
#define ME_LAUNCH(W, P)                                                                        \
  {                                                                                            \
    if (bytes > 48 * 1024) {                                                                   \
      const cudaError_t e = cudaFuncSetAttribute(                                              \
          match_extract_kernel<W, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes); \
      if (e != cudaSuccess) return (int)e;                                                     \
    }                                                                                          \
    match_extract_kernel<W, P><<<blocks, lines, (size_t)bytes, s>>>(                           \
        logs, lens, tmpl, tlens, assign, spans, n, t, k, tt, n_slots, kt, magic);              \
    return (int)cudaGetLastError();                                                            \
  }
  // Lines of at most 16 tokens take 16 token registers: at T = 16 (1M
  // Spark lines, 18 templates, an H100 80GB HBM3) 32 registers took
  // 0.180-0.182 ms a launch against 0.133-0.134 ms, a literal step being
  // that many compares.
  switch (w) {
    case 1:
      if (t <= 16) ME_LAUNCH(1, 16) else ME_LAUNCH(1, 32)
    case 2: ME_LAUNCH(2, 0)
    case 3: ME_LAUNCH(3, 0)
    case 4: ME_LAUNCH(4, 0)
    case 5: ME_LAUNCH(5, 0)
    case 6: ME_LAUNCH(6, 0)
    case 7: ME_LAUNCH(7, 0)
    case 8: ME_LAUNCH(8, 0)
    default: return (int)cudaErrorInvalidValue;
  }
#undef ME_LAUNCH
}
