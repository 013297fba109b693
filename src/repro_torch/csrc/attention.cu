// Fused attention over a sequence for Hopper (sm_90a): the forward, and
// the backward in three kernels (FlashAttention-2).
//
// Replaces no TPU kernel: the JAX package leaves its sequence attention
// (src/repro/models/layers.py, `attention`, a lax.scan over KV chunks) to
// XLA. The port's plain version of it, models/layers.py `_attention`, is
// a Python loop over 1,024-key chunks with fp32 (B, H, Sq, 1024) score
// tiles in device memory; models/layers.py `attention` launches these
// kernels for CUDA tensors instead (kernels/attention.py, the wrapper).
//
// Bound on the H100: at the models' shapes (sequences of 2,048, head dims
// 64 and 128) the work is the causal FLOPs of the two products,
// 4 B H hd S (S + 1) / 2 in the forward, against 989 TFLOP/s in bf16;
// the bytes (q, k, v read once, o written once) at 3.35 TB/s take about
// half that time, and less as sequences grow. So the products stay on the
// tensor cores and no score ever reaches device memory:
//
// - a block of 4 warps owns 64 query rows of one (batch, head), 16 rows a
//   warp, and walks the KV blocks with an online softmax. The score tile
//   lives in registers, in the mma's accumulator layout, and P goes from
//   there straight into the A operand of P.V (mma.sync m16n8k16, bf16
//   operands, fp32 accumulation; ldmatrix feeds the B operands from
//   shared memory, .trans where the tile is stored k-major);
// - the next KV block is copied in (cp.async, two buffers) while the
//   current one is used;
// - under `causal` the walk stops at the diagonal, so the blocks above it
//   (half the work at S = 2,048) are never computed, and only the blocks
//   on the diagonal or at an edge (`kv_len`, a ragged Sk) pay for masks;
// - GQA is native: query head h reads KV head h / (H / KV) through the
//   strides, with no copy of K or V;
// - the backward recomputes P from the forward's row statistics: one pass
//   for D = rowsum(dO * O), one over KV blocks that writes dK and dV (each
//   block sums over its KV head's whole group of query heads), one over
//   query blocks that writes dQ. No atomics, so the gradients are the same
//   bits on every run.
//
// Arithmetic: QK^T on operands in the inputs' dtype with fp32
// accumulation; the scale (times log2 e) applied to the fp32 scores; the
// running max and sum in fp32 (base 2); P rounded to the inputs' dtype
// before P.V, which accumulates in fp32; o normalised in fp32 and rounded
// once. The backward rounds P and dS to the inputs' dtype for their
// products, which accumulate in fp32. fp32 inputs take the same kernels
// with true fp32 products (fmaf on the CUDA cores, no TF32): a warp's
// product reads both operands from shared memory, P and dS going there
// first. Causal masking is aligned top-left (query i sees keys 0..i, also
// where Sq != Sk); masked scores are -1e30 (layers.NEG_INF) and keys past
// Sk -inf, so a row whose keys are all masked (kv_len 0) averages v over
// all Sk keys, as the plain version does. The row statistics are kept as
// the max and the log2 of the sum apart, so that such a row's
// probabilities stay 1 / Sk in the backward.
//
// Head dims 32, 64 and 128; the wrapper refuses others, and hands q, k,
// v, o and dO with unit stride along the head dim and 16-byte-aligned
// rows. Block sizes are fixed per head dim and dtype (Blocks below).

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows (forward, dQ) or keys (dK/dV) a block
constexpr float kMasked = -1e30f;   // layers.NEG_INF

struct Params {
  const void *q, *k, *v, *o, *dout;
  void *out, *dq, *dk, *dv;
  const int* len;  // (B,) valid keys a batch row, or null
  float *m, *lg, *dd;  // (B, H, Sq): row max, log2 of the row sum, rowsum(dO * O)
  // element strides over (batch, position, head); the head dim's is 1
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h, g_b, g_s, g_h, dq_b,
      dq_s, dq_h, dk_b, dk_s, dk_h;
  int B, H, KV, group, Sq, Sk;
  float qk_scale;  // hd^-0.5 * log2(e)
  float sm_scale;  // hd^-0.5
  int causal, stats;
};

// Block sizes: KV block of the forward, query block of dK/dV, KV block
// of dQ (the other side of each is kRows).
template <typename T, int HD>
struct Blocks {
  static constexpr bool kWide = sizeof(T) == 4 || HD == 128;
  static constexpr int kFwdN = sizeof(T) == 4 ? 32 : 64;
  static constexpr int kDkdvM = kWide ? 32 : 64;
  static constexpr int kDqN = kWide ? 32 : 64;
};

// shared-memory row of a head-dim tile: 16 bytes of padding, so that the
// eight rows an ldmatrix (or eight lanes of a warp) reads fall in
// different banks
template <typename T, int HD>
__host__ __device__ constexpr int row_ld() { return HD + 16 / (int)sizeof(T); }

// ------------------------------------------------------------ copies

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ROWS rows of HD elements from g (row stride `stride`) into s; rows at or
// past `valid` are zero-filled (their source is `base`, read for 0 bytes)
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long stride, int valid,
                                          const void* base) {
  constexpr int kChunks = HD * (int)sizeof(T) / 16;
  constexpr int kLd = row_ld<T, HD>();
  constexpr int kPer = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, j = c % kChunks;
    const bool ok = r < valid;
    cp_async16(s + r * kLd + j * kPer, ok ? (const void*)(g + r * stride + j * kPer) : base, ok);
  }
}

// ROWS fp32 statistics of consecutive rows, zero past `valid`
template <int ROWS>
__device__ __forceinline__ void load_stats(float* s, const float* g, int valid) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads)
    cp_async4(s + r, r < valid ? (const void*)(g + r) : (const void*)g, r < valid);
}

// ------------------------------------------------------------ products
//
// A warp's product acc (16 x 8 NT, fp32, the mma's accumulator layout:
// lane l holds rows l/4 and l/4 + 8, columns 8 j + 2 (l % 4) + {0, 1} of
// each 8-column tile j) += A (16 x K) * B. B lies in shared memory, as N
// rows of K (kNK, e.g. K for Q K^T) or as K rows of N (e.g. V for P V).

// A: 16 rows x K, as bf16 mma fragments in registers, or, for fp32, where
// the rows lie in shared memory
template <typename T, int K>
struct FragA;
template <int K>
struct FragA<bf16, K> {
  uint32_t r[K / 16][4];
};
template <int K>
struct FragA<float, K> {
  const float* s;
  int ld;
};

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// A from 16 rows of shared memory (row-major, ld elements a row)
template <int K>
__device__ __forceinline__ void load_a(FragA<bf16, K>& a, const bf16* s, int ld) {
  const int lane = threadIdx.x & 31;
  const bf16* p = s + (lane & 15) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) ldsm4(a.r[kk], p + kk * 16);
}

template <int K>
__device__ __forceinline__ void load_a(FragA<float, K>& a, const float* s, int ld) {
  a.s = s;
  a.ld = ld;
}

// A from an accumulator (16 x K), rounded to the operand type: the bf16
// fragments are the accumulator's registers repacked; fp32 goes through
// the warp's scratch rows (16 x (K + 4))
template <int K>
__device__ __forceinline__ void acc_to_a(FragA<bf16, K>& a, const float (&p)[K / 8][4], float*) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    a.r[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a.r[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a.r[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a.r[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

template <int K>
__device__ __forceinline__ void acc_to_a(FragA<float, K>& a, const float (&p)[K / 8][4],
                                         float* scratch) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  constexpr int kLd = K + 4;
  __syncwarp();  // the last product that read the scratch is done
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {
    scratch[g * kLd + 8 * j + c] = p[j][0];
    scratch[g * kLd + 8 * j + c + 1] = p[j][1];
    scratch[(g + 8) * kLd + 8 * j + c] = p[j][2];
    scratch[(g + 8) * kLd + 8 * j + c + 1] = p[j][3];
  }
  __syncwarp();
  a.s = scratch;
  a.ld = kLd;
}

template <bool kNK, int NT, int K>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const FragA<bf16, K>& a, const bf16* b,
                                     int ld) {
  static_assert(NT % 2 == 0, "B is read 16 columns at a time");
  const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < NT / 2; ++nn) {
      uint32_t f[4];
      if constexpr (kNK)  // matrices (n, k): (0-7, 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
        ldsm4(f, b + (nn * 16 + (mi >> 1) * 8 + r8) * ld + kk * 16 + (mi & 1) * 8);
      else  // matrices (k, n), transposed: (0-7, 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        ldsm4_t(f, b + (kk * 16 + (mi & 1) * 8 + r8) * ld + nn * 16 + (mi >> 1) * 8);
      mma_bf16(acc[2 * nn], a.r[kk], f[0], f[1]);
      mma_bf16(acc[2 * nn + 1], a.r[kk], f[2], f[3]);
    }
  }
}

template <bool kNK, int NT, int K>
__device__ __forceinline__ void gemm(float (&acc)[NT][4], const FragA<float, K>& a,
                                     const float* b, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
  const float* a0 = a.s + g * a.ld;
  const float* a1 = a0 + 8 * a.ld;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + c;
      const float y0 = kNK ? b[n * ld + k] : b[k * ld + n];
      const float y1 = kNK ? b[(n + 1) * ld + k] : b[k * ld + n + 1];
      acc[j][0] = fmaf(x0, y0, acc[j][0]);
      acc[j][1] = fmaf(x0, y1, acc[j][1]);
      acc[j][2] = fmaf(x1, y0, acc[j][2]);
      acc[j][3] = fmaf(x1, y1, acc[j][3]);
    }
  }
}

// a pair of neighbouring elements of a row, from fp32
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ the walks
//
// A query block [m0, m0 + kRows) walks the keys [0, hi): [0, mid) need no
// mask, [mid, hi) are masked (the diagonal under causal, the kv_len and Sk
// edges). A row whose keys are all masked (kv_len <= 0) walks every key
// in the forward and none in dQ (it has no gradient).
struct Walk {
  int L, mid, hi;
};

__device__ __forceinline__ Walk query_walk(const Params& p, int b, int m0, int bn, bool grad) {
  int L = p.Sk, hi = p.Sk, limit = p.Sk;
  if (p.causal) {
    hi = min(hi, m0 + kRows);
    limit = min(limit, m0 + 1);
  }
  if (p.len) {
    L = p.len[b];
    limit = min(limit, L);
    hi = L > 0 ? min(hi, L) : (grad ? 0 : p.Sk);
  }
  return {L, (max(limit, 0) / bn) * bn, hi};
}

// the score of (query qpos, key kpos) in a masked block: kept, -1e30 where
// causal or kv_len masks it, -inf past Sk (forward only: the backward's
// masked entries are zeroed)
__device__ __forceinline__ bool keep(const Params& p, int L, int qpos, int kpos) {
  return kpos < L && (!p.causal || qpos >= kpos);
}

// ------------------------------------------------------------ forward

template <typename T, int HD>
constexpr size_t fwd_smem() {
  constexpr int BN = Blocks<T, HD>::kFwdN;
  return (size_t)(kRows + 4 * BN) * row_ld<T, HD>() * sizeof(T) +
         (sizeof(T) == 4 ? (size_t)kWarps * 16 * (BN + 4) * sizeof(float) : 0);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_fwd(const Params p) {
  constexpr int BN = Blocks<T, HD>::kFwdN;
  constexpr int LD = row_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kRows * LD;  // two buffers each
  T* sV = sK + 2 * BN * LD;
  float* scratch = reinterpret_cast<float*>(sV + 2 * BN * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // the longest rows of a head first
  const T* Q = static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* K = static_cast<const T*>(p.k) + b * p.k_b + kvh * p.k_h;
  const T* V = static_cast<const T*>(p.v) + b * p.v_b + kvh * p.v_h;
  const Walk w = query_walk(p, b, m0, BN, false);
  const int n_blocks = (w.hi + BN - 1) / BN;

  load_tile<T, HD, kRows>(sQ, Q + m0 * p.q_s, p.q_s, p.Sq - m0, p.q);
  load_tile<T, HD, BN>(sK, K, p.k_s, p.Sk, p.k);
  load_tile<T, HD, BN>(sV, V, p.v_s, p.Sk, p.v);
  cp_commit();

  float acc[HD / 8][4] = {};
  float m_i[2] = {kMasked, kMasked}, l_i[2] = {0.f, 0.f};
  const int row = m0 + warp * 16 + g;  // and row + 8
  FragA<T, HD> qa;
  for (int j = 0; j < n_blocks; ++j) {
    const int buf = j & 1, n0 = j * BN;
    if (j + 1 < n_blocks) {
      const int n1 = n0 + BN;
      load_tile<T, HD, BN>(sK + (buf ^ 1) * BN * LD, K + n1 * p.k_s, p.k_s, p.Sk - n1, p.k);
      load_tile<T, HD, BN>(sV + (buf ^ 1) * BN * LD, V + n1 * p.v_s, p.v_s, p.Sk - n1, p.v);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    if (j == 0) load_a(qa, sQ + warp * 16 * LD, LD);

    float s[BN / 8][4] = {};
    gemm<true>(s, qa, sK + buf * BN * LD, LD);
    const bool masked = n0 >= w.mid;
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * p.qk_scale;
        if (masked) {
          const int kpos = n0 + 8 * t + c + (e & 1), qpos = row + (e >> 1) * 8;
          x = keep(p, w.L, qpos, kpos) ? x : kMasked;
          x = kpos < p.Sk ? x : __int_as_float(0xff800000);  // -inf
        }
        s[t][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_i[r];
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
      mx = quad_max(mx);
      const float alpha = exp2f(m_i[r] - mx);
      m_i[r] = mx;
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) {
        s[t][2 * r] = exp2f(s[t][2 * r] - mx);
        s[t][2 * r + 1] = exp2f(s[t][2 * r + 1] - mx);
        sum += s[t][2 * r] + s[t][2 * r + 1];
      }
      l_i[r] = l_i[r] * alpha + sum;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t) {
        acc[t][2 * r] *= alpha;
        acc[t][2 * r + 1] *= alpha;
      }
    }
    FragA<T, BN> pa;
    acc_to_a(pa, s, scratch + warp * 16 * (BN + 4));
    gemm<false>(acc, pa, sV + buf * BN * LD, LD);
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  T* O = static_cast<T*>(p.out) + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row + 8 * r;
    const float l = quad_sum(l_i[r]);
    if (qpos >= p.Sq) continue;
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
      store_pair(O + qpos * p.o_s + 8 * t + c, acc[t][2 * r] / l, acc[t][2 * r + 1] / l);
    if (p.stats && c == 0) {
      const long long at = (long long)bh * p.Sq + qpos;
      p.m[at] = m_i[r];
      p.lg[at] = log2f(l);
    }
  }
}

// ------------------------------------------------------------ backward

// D = rowsum(dO * O) in fp32, a warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) attn_bwd_pre(const Params p, int hd) {
  const long long rowid = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (rowid >= (long long)p.B * p.H * p.Sq) return;
  const long long bh = rowid / p.Sq;
  const int s = (int)(rowid % p.Sq), b = (int)(bh / p.H), h = (int)(bh % p.H);
  const T* o = static_cast<const T*>(p.o) + b * p.o_b + s * p.o_s + h * p.o_h;
  const T* d = static_cast<const T*>(p.dout) + b * p.g_b + s * p.g_s + h * p.g_h;
  float sum = 0.f;
  for (int i = lane; i < hd; i += 32) sum += to_float(o[i]) * to_float(d[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.dd[rowid] = sum;
}

template <typename T, int HD>
constexpr size_t dkdv_smem() {
  constexpr int BM = Blocks<T, HD>::kDkdvM;
  return (size_t)(2 * kRows + 4 * BM) * row_ld<T, HD>() * sizeof(T) + 2 * 3 * BM * sizeof(float) +
         (sizeof(T) == 4 ? (size_t)kWarps * 16 * (BM + 4) * sizeof(float) : 0);
}

// dK and dV of kRows keys of one (batch, KV head): the walk over the query
// blocks of every query head of the group. Query rows [lo, mid) are
// masked, [mid, Sq) are not; under causal the rows before the block's
// first key see none of it and are skipped.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(const Params p) {
  constexpr int BM = Blocks<T, HD>::kDkdvM;
  constexpr int LD = row_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kRows * LD;
  T* sQ = sV + kRows * LD;  // two buffers each
  T* sG = sQ + 2 * BM * LD;
  float* sStat = reinterpret_cast<float*>(sG + 2 * BM * LD);  // [buf][m, lg, dd][BM]
  float* scratch = sStat + 2 * 3 * BM;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int n0 = blockIdx.y * kRows;  // the keys with the most rows first
  const T* K = static_cast<const T*>(p.k) + b * p.k_b + kvh * p.k_h;
  const T* V = static_cast<const T*>(p.v) + b * p.v_b + kvh * p.v_h;

  int L = p.Sk, lo = 0, mid = 0;
  if (p.causal) {
    lo = (n0 / BM) * BM;
    mid = min((n0 + kRows + BM - 1) / BM * BM, p.Sq);
  }
  if (p.len) {
    // a block across kv_len is masked for every row; one past it has no
    // gradient, unless every key is masked (kv_len <= 0): then every row
    // sees every key, masked
    L = p.len[b];
    if (L <= 0) {
      lo = 0;
      mid = p.Sq;
    } else if (n0 >= L) {
      lo = mid = p.Sq;
    } else if (n0 + kRows > L) {
      mid = p.Sq;
    }
  }
  const int nb = lo < p.Sq ? (p.Sq - lo + BM - 1) / BM : 0;
  const int tasks = p.group * nb;  // (query head of the group, query block)

  auto prefetch = [&](int t, int buf) {
    const int h = kvh * p.group + t / nb, m0 = lo + (t % nb) * BM;
    const long long st = ((long long)b * p.H + h) * p.Sq + m0;
    load_tile<T, HD, BM>(sQ + buf * BM * LD,
                         static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h + m0 * p.q_s, p.q_s,
                         p.Sq - m0, p.q);
    load_tile<T, HD, BM>(sG + buf * BM * LD,
                         static_cast<const T*>(p.dout) + b * p.g_b + h * p.g_h + m0 * p.g_s,
                         p.g_s, p.Sq - m0, p.dout);
    load_stats<BM>(sStat + (buf * 3 + 0) * BM, p.m + st, p.Sq - m0);
    load_stats<BM>(sStat + (buf * 3 + 1) * BM, p.lg + st, p.Sq - m0);
    load_stats<BM>(sStat + (buf * 3 + 2) * BM, p.dd + st, p.Sq - m0);
  };

  load_tile<T, HD, kRows>(sK, K + n0 * p.k_s, p.k_s, p.Sk - n0, p.k);
  load_tile<T, HD, kRows>(sV, V + n0 * p.v_s, p.v_s, p.Sk - n0, p.v);
  if (tasks > 0) prefetch(0, 0);
  cp_commit();

  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  const int key = n0 + warp * 16 + g;  // and key + 8
  float* wscratch = scratch + warp * 16 * (BM + 4);
  for (int t = 0; t < tasks; ++t) {
    const int buf = t & 1, m0 = lo + (t % nb) * BM;
    if (t + 1 < tasks) prefetch(t + 1, buf ^ 1);
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    const T* q = sQ + buf * BM * LD;
    const T* dout = sG + buf * BM * LD;
    const float* sm = sStat + buf * 3 * BM;
    const bool masked = m0 < mid;

    // P^T (keys x queries) = exp2(K Q^T * scale - m - lg)
    FragA<T, HD> ka;
    load_a(ka, sK + warp * 16 * LD, LD);
    float pt[BM / 8][4] = {};
    gemm<true>(pt, ka, q, LD);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        float x = pt[j][e] * p.qk_scale;
        if (masked && !keep(p, L, m0 + col, key + (e >> 1) * 8)) x = kMasked;
        pt[j][e] = exp2f(x - sm[col] - sm[BM + col]);
      }
    FragA<T, BM> pa;
    acc_to_a(pa, pt, wscratch);
    gemm<false>(dv, pa, dout, LD);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - D)
    FragA<T, HD> va;
    load_a(va, sV + warp * 16 * LD, LD);
    float ds[BM / 8][4] = {};
    gemm<true>(ds, va, dout, LD);
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        ds[j][e] = pt[j][e] * (ds[j][e] - sm[2 * BM + col]);
        if (masked && !keep(p, L, m0 + col, key + (e >> 1) * 8)) ds[j][e] = 0.f;
      }
    acc_to_a(pa, ds, wscratch);
    gemm<false>(dk, pa, q, LD);  // dK += dS^T Q
    __syncthreads();
  }

  // dK and dV share one layout
  T* DK = static_cast<T*>(p.dk) + b * p.dk_b + kvh * p.dk_h;
  T* DV = static_cast<T*>(p.dv) + b * p.dk_b + kvh * p.dk_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = key + 8 * r;
    if (kpos >= p.Sk) continue;
#pragma unroll
    for (int t = 0; t < HD / 8; ++t) {
      store_pair(DK + kpos * p.dk_s + 8 * t + c, dk[t][2 * r] * p.sm_scale,
                 dk[t][2 * r + 1] * p.sm_scale);
      store_pair(DV + kpos * p.dk_s + 8 * t + c, dv[t][2 * r], dv[t][2 * r + 1]);
    }
  }
}

template <typename T, int HD>
constexpr size_t dq_smem() {
  constexpr int BN = Blocks<T, HD>::kDqN;
  return (size_t)(2 * kRows + 4 * BN) * row_ld<T, HD>() * sizeof(T) +
         (sizeof(T) == 4 ? (size_t)kWarps * 16 * (BN + 4) * sizeof(float) : 0);
}

// dQ of kRows query rows of one (batch, head): the forward's walk
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(const Params p) {
  constexpr int BN = Blocks<T, HD>::kDqN;
  constexpr int LD = row_ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sG = sQ + kRows * LD;
  T* sK = sG + kRows * LD;  // two buffers each
  T* sV = sK + 2 * BN * LD;
  float* scratch = reinterpret_cast<float*>(sV + 2 * BN * LD);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = (lane & 3) * 2;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H, kvh = h / p.group;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const T* K = static_cast<const T*>(p.k) + b * p.k_b + kvh * p.k_h;
  const T* V = static_cast<const T*>(p.v) + b * p.v_b + kvh * p.v_h;
  const Walk w = query_walk(p, b, m0, BN, true);
  const int n_blocks = (w.hi + BN - 1) / BN;

  load_tile<T, HD, kRows>(sQ, static_cast<const T*>(p.q) + b * p.q_b + h * p.q_h + m0 * p.q_s,
                          p.q_s, p.Sq - m0, p.q);
  load_tile<T, HD, kRows>(sG, static_cast<const T*>(p.dout) + b * p.g_b + h * p.g_h + m0 * p.g_s,
                          p.g_s, p.Sq - m0, p.dout);
  load_tile<T, HD, BN>(sK, K, p.k_s, p.Sk, p.k);
  load_tile<T, HD, BN>(sV, V, p.v_s, p.Sk, p.v);
  cp_commit();

  const int row = m0 + warp * 16 + g;  // and row + 8
  float m[2], lg[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = (long long)bh * p.Sq + row + 8 * r;
    const bool ok = row + 8 * r < p.Sq;
    m[r] = ok ? p.m[at] : 0.f;
    lg[r] = ok ? p.lg[at] : 0.f;
    dd[r] = ok ? p.dd[at] : 0.f;
  }
  float dq[HD / 8][4] = {};
  FragA<T, HD> qa, ga;
  float* wscratch = scratch + warp * 16 * (BN + 4);
  for (int j = 0; j < n_blocks; ++j) {
    const int buf = j & 1, n0 = j * BN;
    if (j + 1 < n_blocks) {
      const int n1 = n0 + BN;
      load_tile<T, HD, BN>(sK + (buf ^ 1) * BN * LD, K + n1 * p.k_s, p.k_s, p.Sk - n1, p.k);
      load_tile<T, HD, BN>(sV + (buf ^ 1) * BN * LD, V + n1 * p.v_s, p.v_s, p.Sk - n1, p.v);
    }
    cp_commit();
    cp_wait_all_but_one();
    __syncthreads();
    if (j == 0) {
      load_a(qa, sQ + warp * 16 * LD, LD);
      load_a(ga, sG + warp * 16 * LD, LD);
    }
    const T* k = sK + buf * BN * LD;
    const bool masked = n0 >= w.mid;

    float s[BN / 8][4] = {};
    gemm<true>(s, qa, k, LD);  // Q K^T
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[t][e] * p.qk_scale;
        if (masked && !keep(p, w.L, row + (e >> 1) * 8, n0 + 8 * t + c + (e & 1))) x = kMasked;
        s[t][e] = exp2f(x - m[e >> 1] - lg[e >> 1]);
      }
    float ds[BN / 8][4] = {};
    gemm<true>(ds, ga, sV + buf * BN * LD, LD);  // dO V^T
#pragma unroll
    for (int t = 0; t < BN / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = n0 + 8 * t + c + (e & 1);
        ds[t][e] = s[t][e] * (ds[t][e] - dd[e >> 1]);
        if (masked && !(kpos < p.Sk && keep(p, w.L, row + (e >> 1) * 8, kpos))) ds[t][e] = 0.f;
      }
    FragA<T, BN> da;
    acc_to_a(da, ds, wscratch);
    gemm<false>(dq, da, k, LD);  // dQ += dS K
    __syncthreads();
  }

  T* DQ = static_cast<T*>(p.dq) + b * p.dq_b + h * p.dq_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row + 8 * r;
    if (qpos >= p.Sq) continue;
#pragma unroll
    for (int t = 0; t < HD / 8; ++t)
      store_pair(DQ + qpos * p.dq_s + 8 * t + c, dq[t][2 * r] * p.sm_scale,
                 dq[t][2 * r + 1] * p.sm_scale);
  }
}

// ------------------------------------------------------------ launches

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream, const Params& p) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t forward(const Params& p, cudaStream_t s) {
  return launch(attn_fwd<T, HD>, dim3(p.B * p.H, (p.Sq + kRows - 1) / kRows), fwd_smem<T, HD>(),
                s, p);
}

template <typename T, int HD>
cudaError_t backward(const Params& p, cudaStream_t s) {
  const long long rows = (long long)p.B * p.H * p.Sq;
  attn_bwd_pre<T><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0, s>>>(p, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch(attn_bwd_dkdv<T, HD>, dim3(p.B * p.KV, (p.Sk + kRows - 1) / kRows),
             dkdv_smem<T, HD>(), s, p);
  if (e != cudaSuccess) return e;
  return launch(attn_bwd_dq<T, HD>, dim3(p.B * p.H, (p.Sq + kRows - 1) / kRows), dq_smem<T, HD>(),
                s, p);
}

using Entry = cudaError_t (*)(const Params&, cudaStream_t);

template <bool kBackward>
Entry pick(int f32, int hd) {
  if (f32) {
    if (hd == 32) return kBackward ? backward<float, 32> : forward<float, 32>;
    if (hd == 64) return kBackward ? backward<float, 64> : forward<float, 64>;
    if (hd == 128) return kBackward ? backward<float, 128> : forward<float, 128>;
  } else {
    if (hd == 32) return kBackward ? backward<bf16, 32> : forward<bf16, 32>;
    if (hd == 64) return kBackward ? backward<bf16, 64> : forward<bf16, 64>;
    if (hd == 128) return kBackward ? backward<bf16, 128> : forward<bf16, 128>;
  }
  return nullptr;
}

// strides: 21 element strides, (batch, position, head) of q, k, v, o, dO,
// dQ and dK (= dV)
Params make_params(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* out, void* dq, void* dk, void* dv, const int* len, float* m, float* lg,
                   float* dd, const long long* st, int B, int H, int KV, int Sq, int Sk, int hd,
                   int causal, int stats) {
  Params p;
  p.q = q, p.k = k, p.v = v, p.o = o, p.dout = dout;
  p.out = out, p.dq = dq, p.dk = dk, p.dv = dv;
  p.len = len, p.m = m, p.lg = lg, p.dd = dd;
  p.q_b = st[0], p.q_s = st[1], p.q_h = st[2], p.k_b = st[3], p.k_s = st[4], p.k_h = st[5];
  p.v_b = st[6], p.v_s = st[7], p.v_h = st[8], p.o_b = st[9], p.o_s = st[10], p.o_h = st[11];
  p.g_b = st[12], p.g_s = st[13], p.g_h = st[14], p.dq_b = st[15], p.dq_s = st[16];
  p.dq_h = st[17], p.dk_b = st[18], p.dk_s = st[19], p.dk_h = st[20];
  p.B = B, p.H = H, p.KV = KV, p.group = H / KV, p.Sq = Sq, p.Sk = Sk;
  p.sm_scale = 1.0f / sqrtf((float)hd);
  p.qk_scale = p.sm_scale * 1.4426950408889634f;
  p.causal = causal, p.stats = stats;
  return p;
}

}  // namespace

// o (B, Sq, H, hd) = attention of q over k, v; with stats != 0 also the
// row statistics m and lg (B, H, Sq). `strides` as make_params, o's in
// place of dO, dQ and dK (12 read). Refuses (cudaErrorInvalidValue) a head
// dim other than 32, 64 or 128 and shapes the grid cannot hold.
extern "C" int attention_forward(int f32, int hd, const void* q, const void* k, const void* v,
                                 void* o, const int* len, float* m, float* lg,
                                 const long long* strides, int B, int H, int KV, int Sq, int Sk,
                                 int causal, int stats, void* stream) {
  const Entry fn = pick<false>(f32, hd);
  if (!fn || B <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 ||
      (Sq + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  long long st[21] = {};
  for (int i = 0; i < 12; ++i) st[i] = strides[i];
  const Params p = make_params(q, k, v, o, nullptr, o, nullptr, nullptr, nullptr, len, m, lg,
                               nullptr, st, B, H, KV, Sq, Sk, hd, causal, stats);
  return (int)fn(p, (cudaStream_t)stream);
}

// dq, dk, dv of the forward's o and statistics m, lg, given dO; dd is
// (B, H, Sq) fp32 scratch. Three launches: D, dK/dV, dQ.
extern "C" int attention_backward(int f32, int hd, const void* q, const void* k, const void* v,
                                  const void* o, const void* dout, void* dq, void* dk, void* dv,
                                  const int* len, float* m, float* lg, float* dd,
                                  const long long* strides, int B, int H, int KV, int Sq, int Sk,
                                  int causal, void* stream) {
  const Entry fn = pick<true>(f32, hd);
  if (!fn || B <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 ||
      (Sq + kRows - 1) / kRows > 65535 || (Sk + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, o, dout, nullptr, dq, dk, dv, len, m, lg, dd, strides, B,
                               H, KV, Sq, Sk, hd, causal, 1);
  return (int)fn(p, (cudaStream_t)stream);
}
