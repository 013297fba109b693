// Common-token counts (the clustering surrogate phi) for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_simcount_kernel` of the JAX package
// (src/repro/kernels/simcount.py, `simcount`). For line n (tokens
// logs[n, :T]) and template k (tokens templates[k, :Tt]) it writes
//
//   out[n, k] = #{ i < T : logs[n, i] is not PAD (0) or STAR (1),
//                          and logs[n, i] == templates[k, j] for some j }
//
// A duplicate log token counts once per occurrence.
//
// Bound on the H100: bytes. The function needs one set lookup a valid
// log token and one count an output, against 4 bytes read a token and
// 4 written an output. The TPU kernel compared every log token with
// every template slot; here a block builds, for a
// tile of up to 32 templates, a table in shared memory from each literal
// template token to the 32-bit mask of the tile's templates that hold it
// (open addressing, the key stored, so a lookup is exact for any int32;
// PAD and STAR are never inserted, so key 0 marks an empty slot, and a
// token repeated in a template sets its bit once). A warp then takes
// lines with a lane a log position (32 / S lines a step for T <= S <=
// 32, S a power of two; T > 32 in pieces of 32), each lane loading its
// token (the warp reads one run of 128 bytes) and looking it up once.
// For each template bit set in any lane, one __ballot_sync gathers the
// positions that hold it; lane k keeps template k's ballot, and the
// popcount of its S-bit segment is line g's count. Lanes k < K then
// store each line's counts as one run. Blocks stay resident and walk
// many lines, so each builds its table once a tile, not once a few
// lines. The tile holds fewer than 32 templates when Tt is wide, so that
// the table (2 slots a template slot, a power of two) fits kTableBytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;                 // steps a warp loads ahead of its lookups
constexpr int kTableBytes = 64 * 1024;
constexpr int kMinTableBits = 6;

__device__ __forceinline__ uint32_t slot(uint32_t key, int bits) {
  return (key * 0x9E3779B1u) >> (32 - bits);
}

// table[h] = (key, mask of the tile's templates that hold key); key 0 is empty.
__device__ void build_table(uint2* table, int bits, const int32_t* __restrict__ tmpl, int kn,
                            int tt) {
  const uint32_t cap = 1u << bits;
  for (uint32_t e = threadIdx.x; e < cap; e += kThreads) table[e] = make_uint2(0u, 0u);
  __syncthreads();
  for (int r = threadIdx.x >> 5; r < kn; r += kWarps) {
    for (int j = threadIdx.x & 31; j < tt; j += 32) {
      const int32_t tok = __ldg(tmpl + (long long)r * tt + j);
      if (tok == 0 || tok == 1) continue;  // PAD and STAR match nothing
      const uint32_t key = (uint32_t)tok;
      for (uint32_t h = slot(key, bits);; h = (h + 1) & (cap - 1)) {
        const uint32_t old = atomicCAS(&table[h].x, 0u, key);
        if (old == 0u || old == key) {
          atomicOr(&table[h].y, 1u << r);
          break;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t find(const uint2* table, int bits, int32_t tok) {
  if (tok == 0 || tok == 1) return 0u;  // PAD and STAR never count
  const uint32_t key = (uint32_t)tok, mask = (1u << bits) - 1u;
  for (uint32_t h = slot(key, bits);; h = (h + 1) & mask) {
    const uint2 e = table[h];
    if (e.x == key) return e.y;
    if (e.x == 0u) return 0u;
  }
}

// Lane j gets the warp's ballot of bit j of each lane's mask m (0 where
// no lane has it). One ballot per bit set in any lane.
__device__ __forceinline__ uint32_t template_ballots(uint32_t m, int lane) {
  uint32_t any = __reduce_or_sync(0xFFFFFFFFu, m), mine = 0u;
  while (any) {
    const int j = __ffs(any) - 1;
    any &= any - 1;
    const uint32_t b = __ballot_sync(0xFFFFFFFFu, (m >> j) & 1u);
    if (lane == j) mine = b;
  }
  return mine;
}

// This lane's token of each step of the chunk at line n0 (0 past the
// grid).
__device__ __forceinline__ void load_chunk(int32_t (&tok)[kUnroll],
                                           const int32_t* __restrict__ logs, long long n, int t,
                                           long long n0, int per, int g, int p) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long line = n0 + u * per + g;
    tok[u] = p < t && line < n ? __ldg(logs + line * t + p) : 0;
  }
}

// T <= 32: a step is 32 >> seg_bits lines, lane = (line g, position p).
// A chunk is kUnroll steps; a warp loads its first chunk's tokens before
// the table is built and each next chunk's before the current lookups.
__device__ __forceinline__ void narrow_lines(uint2* table, int bits,
                                             const int32_t* __restrict__ tmpl, int kn, int tt,
                                             const int32_t* __restrict__ logs,
                                             int32_t* __restrict__ out, long long n, int t,
                                             int k, int k0, int seg_bits, long long warp0,
                                             long long warps, int lane) {
  const int per = 32 >> seg_bits;
  const int g = lane >> seg_bits, p = lane & ((1 << seg_bits) - 1);
  const uint32_t seg = seg_bits == 5 ? 0xFFFFFFFFu : (1u << (1 << seg_bits)) - 1u;
  const long long chunk = (long long)kUnroll * per;
  int32_t next[kUnroll];
  long long n0 = warp0 * chunk;
  load_chunk(next, logs, n, t, n0, per, g, p);
  build_table(table, bits, tmpl, kn, tt);
  for (; n0 < n; n0 += warps * chunk) {
    int32_t tok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) tok[u] = next[u];
    load_chunk(next, logs, n, t, n0 + warps * chunk, per, g, p);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t mine = template_ballots(find(table, bits, tok[u]), lane);
      for (int h = 0; h < per; ++h) {
        const long long line = n0 + u * per + h;
        if (lane < kn && line < n)
          out[line * k + k0 + lane] = __popc((mine >> (h << seg_bits)) & seg);
      }
    }
  }
}

// T > 32: a warp a line, its positions 32 at a time.
__device__ __forceinline__ void wide_lines(const uint2* table, int bits,
                                           const int32_t* __restrict__ logs,
                                           int32_t* __restrict__ out, long long n, int t, int k,
                                           int k0, int kn, long long warp0, long long warps,
                                           int lane) {
  for (long long line = warp0; line < n; line += warps) {
    const int32_t* row = logs + line * t;
    int count = 0;
    for (int q = 0; q < t; q += 32 * kUnroll) {
      int32_t tok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int pos = q + 32 * u + lane;
        tok[u] = pos < t ? __ldg(row + pos) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        count += __popc(template_ballots(find(table, bits, tok[u]), lane));
    }
    if (lane < kn) out[line * k + k0 + lane] = count;
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    simcount_kernel(const int32_t* __restrict__ logs, const int32_t* __restrict__ tmpl,
                    int32_t* __restrict__ out, long long n, int t, int k, int tt, int kt,
                    int bits, int seg_bits) {
  extern __shared__ uint2 table[];
  const int lane = threadIdx.x & 31;
  const long long warp0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long warps = (long long)gridDim.x * kWarps;
  const int n_tiles = (k + kt - 1) / kt;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int k0 = tile * kt, kn = min(kt, k - k0);
    const int32_t* rows = tmpl + (long long)k0 * tt;
    if (kWide) {
      build_table(table, bits, rows, kn, tt);
      wide_lines(table, bits, logs, out, n, t, k, k0, kn, warp0, warps, lane);
    } else {
      narrow_lines(table, bits, rows, kn, tt, logs, out, n, t, k, k0, seg_bits, warp0, warps,
                   lane);
    }
    __syncthreads();  // every warp is done with the table before the next tile's
  }
}

// log2 of the table's slots for kt templates of tt slots: at least two a slot.
int table_bits(int kt, int tt) {
  int bits = kMinTableBits;
  while ((1LL << bits) < 2LL * kt * tt) ++bits;
  return bits;
}

template <bool kWide>
cudaError_t launch(const int32_t* logs, const int32_t* tmpl, int32_t* out, long long n, int t,
                   int k, int tt, int kt, int bits, int seg_bits, cudaStream_t stream) {
  const size_t smem = sizeof(uint2) << bits;
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(simcount_kernel<kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, simcount_kernel<kWide>, kThreads,
                                                      smem);
  if (e != cudaSuccess) return e;
  const long long tiles = (k + kt - 1) / kt;
  const long long grid_y = tiles < 65535 ? tiles : 65535;
  // a warp's unit: kUnroll steps of lines (T <= 32) or one line
  const long long units = kWide ? n : (n + kUnroll * (32 >> seg_bits) - 1) /
                                          (kUnroll * (32 >> seg_bits));
  long long grid_x = (units + kWarps - 1) / kWarps;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1) / grid_y;
  if (grid_x > resident) grid_x = resident > 0 ? resident : 1;
  simcount_kernel<kWide><<<dim3((unsigned)grid_x, (unsigned)grid_y), kThreads, smem, stream>>>(
      logs, tmpl, out, n, t, k, tt, kt, bits, seg_bits);
  return cudaGetLastError();
}

}  // namespace

// Refuses (cudaErrorInvalidValue) templates too wide for one template's
// table in kTableBytes; the wrapper checks MAX_TT before.
extern "C" int simcount_launch(const int32_t* logs, const int32_t* tmpl, int32_t* out,
                               long long n, int t, int k, int tt, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  if (t < 0 || tt < 0) return (int)cudaErrorInvalidValue;
  int kt = k < 32 ? k : 32;
  while (kt > 1 && (sizeof(uint2) << table_bits(kt, tt)) > (size_t)kTableBytes) --kt;
  const int bits = table_bits(kt, tt);
  if ((sizeof(uint2) << bits) > (size_t)kTableBytes) return (int)cudaErrorInvalidValue;
  int seg_bits = 0;
  while ((1 << seg_bits) < t && seg_bits < 5) ++seg_bits;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(t > 32 ? launch<true>(logs, tmpl, out, n, t, k, tt, kt, bits, seg_bits, s)
                      : launch<false>(logs, tmpl, out, n, t, k, tt, kt, bits, seg_bits, s));
}
