// Byte tokenizer and rolling-hash prefix scan for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_tokenize_kernel` of the JAX package
// (src/repro/kernels/tokenize.py, `tokenize_hash`). For row n of an
// (N, B) uint8 byte grid with length lens[n] it writes, at every byte
// position p < B:
//
//   mask[n, p]   = 1 if p < len and byte p is not a delimiter (a token byte)
//   starts[n, p] = mask[n, p] and not mask[n, p-1] (the first byte of a token)
//   prefL[n, p]  = sum_{q <= p} (byte_q + 1) * pwL[q] * mask[n, q]  mod 2^32
//
// for the two hash lanes L = 1, 2. The delimiter set is a 256-bit table
// passed by value (the TPU kernel baked it in as a chain of compares).
//
// Bound on the H100: bytes. Each input byte becomes 10 output bytes (two
// int8 masks, two uint32 prefix sums), so the kernel must stream 11 bytes
// per grid cell through device memory; its arithmetic is a few integer
// operations a byte. The design keeps every device-memory access a
// 16-byte vector over a contiguous run and the scan off the critical path:
//
// - Each block takes one tile of R whole rows, one contiguous run of R*B bytes
//   in `blocks` (R*B int8 in each mask, R*B uint32 in each sum). The
//   launcher picks R (`tile_rows`) so that the run with its alignment lead
//   fits in one chunk of 2,048 bytes, and R*B is a multiple of 16 where
//   that keeps most of the chunk. Rows wider than that are one tile each,
//   walked in chunks with the carry. At 48 registers a thread, 5 blocks
//   are resident an SM.
// - A chunk is 2,048 positions starting at a 16-byte boundary of the
//   flat grid. Its input is loaded into shared memory with 16-byte loads
//   (bytes at the ragged edges, or all bytes when `blocks` is not 16-byte
//   aligned), and its four outputs leave through shared memory with
//   16-byte stores over the same flat run (scalar at the edges).
// - Each thread takes 8 consecutive bytes and scans them serially in
//   registers (resetting at a row start), so one segmented warp-shuffle
//   scan over the threads' totals covers 256 bytes and one pass over the
//   8 warps' totals covers the chunk: at B = 125 a row takes part in one
//   scan, where a warp a row took four 32-byte scans. The token bit of the
//   byte before a thread's first byte crosses by one shuffle.
// - The power tables live in shared memory, loaded once a block when a
//   row fits in a chunk and a chunk's slice at a time otherwise, padded
//   one word in 32 so that threads 8 columns apart hit distinct banks.
//
// uint32 wraparound addition is associative, so the segmented scan is
// exact in any order. Every width B >= 1 is taken.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBytes = 8;                    // bytes a thread
constexpr int kChunk = kThreads * kBytes;    // positions a chunk
constexpr int kPadded = kChunk + kChunk / 32;
constexpr int kMinBlocks = 5;                // resident blocks an SM (48 registers a thread)
constexpr unsigned kFull = 0xFFFFFFFFu;

struct DelimSet {
  uint32_t w[8];  // bit b of word w: byte 32*w + b is a delimiter
};

__device__ __forceinline__ int pad(int c) { return c + (c >> 5); }

// 4 bits -> 4 bytes of 0/1 (bit j to byte j)
__device__ __forceinline__ uint32_t spread4(uint32_t m) {
  return ((m & 0xFu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
tokenize_hash_kernel(const uint8_t* __restrict__ blocks, const int32_t* __restrict__ lens,
                     const uint32_t* __restrict__ pw1, const uint32_t* __restrict__ pw2,
                     int8_t* __restrict__ mask, int8_t* __restrict__ starts,
                     uint32_t* __restrict__ pref1, uint32_t* __restrict__ pref2,
                     long long n_rows, int width, int rows, unsigned magic_b,
                     DelimSet delims) {
  __shared__ uint32_t sdelim[8];
  __shared__ __align__(16) uint8_t sin[kChunk];
  __shared__ __align__(16) uint8_t smask[kChunk];
  __shared__ __align__(16) uint8_t sstart[kChunk];
  __shared__ __align__(16) uint32_t sp1[kChunk];
  __shared__ __align__(16) uint32_t sp2[kChunk];
  __shared__ uint32_t spw1[kPadded];
  __shared__ uint32_t spw2[kPadded];
  __shared__ uint32_t swf[kWarps], swa1[kWarps], swa2[kWarps], swtok[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool whole_rows = width <= kChunk - 15;  // a tile is one chunk
  const bool vec_in = (reinterpret_cast<uintptr_t>(blocks) & 15) == 0;
  if (tid < 8) sdelim[tid] = delims.w[tid];
  if (whole_rows) {
    for (int c = tid; c < width; c += kThreads) {
      spw1[pad(c)] = __ldg(pw1 + c);
      spw2[pad(c)] = __ldg(pw2 + c);
    }
  }

  const long long row0 = (long long)blockIdx.x * rows;
  const int rt = (int)(n_rows - row0 < rows ? n_rows - row0 : rows);
  const long long s = row0 * width;                    // the tile's flat run [s, end)
  const long long end = s + (long long)rt * width;
  uint32_t carry1 = 0, carry2 = 0, carry_tok = 0;      // from the chunk before
  for (long long w0 = s & ~15LL; w0 < end; w0 += kChunk) {
    const long long lo = w0 > s ? w0 : s;
    const long long hi = w0 + kChunk < end ? w0 + kChunk : end;
    const int c_lo = whole_rows ? 0 : (int)(lo - s);  // first column of the table slice
    if (!whole_rows) {
      for (int c = tid; c < (int)(hi - lo); c += kThreads) {
        spw1[pad(c)] = __ldg(pw1 + c_lo + c);
        spw2[pad(c)] = __ldg(pw2 + c_lo + c);
      }
    }
    for (int u = tid; u < kChunk / 16; u += kThreads) {
      const long long q = w0 + 16 * u;
      if (q >= hi) break;
      if (vec_in && q >= lo && q + 16 <= hi) {
        *reinterpret_cast<uint4*>(sin + 16 * u) =
            __ldg(reinterpret_cast<const uint4*>(blocks + q));
      } else {
        for (int b = 0; b < 16; ++b)
          sin[16 * u + b] = (q + b >= lo && q + b < hi) ? __ldg(blocks + q + b) : 0;
      }
    }
    __syncthreads();

    // -- this thread's 8 bytes: positions w0 + l0 .. w0 + l0 + 7
    const int l0 = kBytes * tid;
    const long long rel = w0 + l0 - s;  // position in the tile's run
    int row, col;
    if (rel < 0) {
      row = 0;
      col = (int)rel;  // before the tile: the first byte of row 0 comes at col 0
    } else if (whole_rows) {
      row = width == 1 ? (int)rel : (int)__umulhi((unsigned)rel, magic_b);
      col = (int)rel - row * width;
    } else {
      row = rel >= width ? 1 : 0;
      col = (int)(rel - (long long)row * width);
    }
    int len_row = (col >= 0 && row < rt) ? __ldg(lens + row0 + row) : 0;
    const uint2 raw = *reinterpret_cast<const uint2*>(sin + l0);
    uint32_t v1[kBytes], v2[kBytes];
    uint32_t run1 = 0, run2 = 0;
    unsigned tb = 0, rsb = 0;  // token bits, row-start bits
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      const uint32_t byte = ((j < 4 ? raw.x : raw.y) >> (8 * (j & 3))) & 0xFFu;
      const bool in = col >= 0 && row < rt;
      if (in && col == 0) {
        rsb |= 1u << j;
        run1 = run2 = 0;
        len_row = __ldg(lens + row0 + row);
      }
      if (in && col < len_row && !((sdelim[byte >> 5] >> (byte & 31)) & 1u)) {
        tb |= 1u << j;
        const int c = pad(col - c_lo);
        run1 += (byte + 1u) * spw1[c];
        run2 += (byte + 1u) * spw2[c];
      }
      v1[j] = run1;
      v2[j] = run2;
      if (++col == width) {
        col = 0;
        ++row;
      }
    }

    // -- segmented scan of (a row start in these bytes, sum since the last)
    unsigned f = rsb != 0;
    uint32_t a1 = run1, a2 = run2;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned fu = __shfl_up_sync(kFull, f, off);
      const uint32_t b1 = __shfl_up_sync(kFull, a1, off);
      const uint32_t b2 = __shfl_up_sync(kFull, a2, off);
      if (lane >= off) {
        if (!f) {
          a1 += b1;
          a2 += b2;
        }
        f |= fu;
      }
    }
    const unsigned last_tok = (tb >> (kBytes - 1)) & 1u;
    unsigned ef = __shfl_up_sync(kFull, f, 1);
    uint32_t e1 = __shfl_up_sync(kFull, a1, 1);
    uint32_t e2 = __shfl_up_sync(kFull, a2, 1);
    unsigned prev_in = __shfl_up_sync(kFull, last_tok, 1);
    if (lane == 31) {
      swf[warp] = f;
      swa1[warp] = a1;
      swa2[warp] = a2;
      swtok[warp] = last_tok;
    }
    __syncthreads();
    // the warps before this one, from the chunk before; and the chunk's total
    uint32_t x1 = 0, x2 = 0, p1 = carry1, p2 = carry2;
    unsigned xtok = 0, ptok = carry_tok;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) {
      if (wi == warp) {
        x1 = p1;
        x2 = p2;
        xtok = ptok;
      }
      if (swf[wi]) {
        p1 = swa1[wi];
        p2 = swa2[wi];
      } else {
        p1 += swa1[wi];
        p2 += swa2[wi];
      }
      ptok = swtok[wi];
    }
    carry1 = p1;
    carry2 = p2;
    carry_tok = ptok;
    if (lane == 0) {
      ef = 0;
      e1 = e2 = 0;
      prev_in = xtok;
    }
    const uint32_t c1 = ef ? e1 : x1 + e1;  // sum since the row start before these bytes
    const uint32_t c2 = ef ? e2 : x2 + e2;
    const unsigned first = rsb ? __ffs(rsb) - 1 : kBytes;  // bytes that take the carry

    const unsigned prev = ((tb << 1) | prev_in) & ~rsb;
    const unsigned st = tb & ~prev;
    *reinterpret_cast<uint2*>(smask + l0) = make_uint2(spread4(tb), spread4(tb >> 4));
    *reinterpret_cast<uint2*>(sstart + l0) = make_uint2(spread4(st), spread4(st >> 4));
#pragma unroll
    for (int j = 0; j < kBytes; ++j) {
      if ((unsigned)j < first) {
        v1[j] += c1;
        v2[j] += c2;
      }
    }
    *reinterpret_cast<uint4*>(sp1 + l0) = make_uint4(v1[0], v1[1], v1[2], v1[3]);
    *reinterpret_cast<uint4*>(sp1 + l0 + 4) = make_uint4(v1[4], v1[5], v1[6], v1[7]);
    *reinterpret_cast<uint4*>(sp2 + l0) = make_uint4(v2[0], v2[1], v2[2], v2[3]);
    *reinterpret_cast<uint4*>(sp2 + l0 + 4) = make_uint4(v2[4], v2[5], v2[6], v2[7]);
    __syncthreads();

    // -- the chunk's outputs over [lo, hi): 16-byte stores, scalar at the edges
    {
      const int u = tid & (kChunk / 16 - 1);
      const long long q = w0 + 16 * u;
      const uint8_t* src = tid < kChunk / 16 ? smask : sstart;
      int8_t* dst = tid < kChunk / 16 ? mask : starts;
      if (q >= lo && q + 16 <= hi) {
        *reinterpret_cast<uint4*>(dst + q) = *reinterpret_cast<const uint4*>(src + 16 * u);
      } else if (q < hi) {
        for (int b = 0; b < 16; ++b)
          if (q + b >= lo && q + b < hi) dst[q + b] = (int8_t)src[16 * u + b];
      }
    }
    for (int v = tid; v < kChunk / 2; v += kThreads) {
      const int u = v & (kChunk / 4 - 1);
      const long long q = w0 + 4 * u;
      const uint32_t* src = v < kChunk / 4 ? sp1 : sp2;
      uint32_t* dst = v < kChunk / 4 ? pref1 : pref2;
      if (q >= lo && q + 4 <= hi) {
        *reinterpret_cast<uint4*>(dst + q) = *reinterpret_cast<const uint4*>(src + 4 * u);
      } else if (q < hi) {
        for (int b = 0; b < 4; ++b)
          if (q + b >= lo && q + b < hi) dst[q + b] = src[4 * u + b];
      }
    }
  }
}

// Rows of width `width` a block takes as one tile: as many as fit with
// their lead before a 16-byte boundary (at most 15) in one chunk, 1 for
// wider rows; among those counts, the largest whose bytes are a multiple
// of 16 where it keeps three quarters of the rows, so every tile starts
// on a 16-byte boundary. On 1M Spark lines cut to B = 70 and B = 61 (an
// H100 80GB HBM3) the aligned 24 and 32 rows took 0.394-0.396 and 0.320
// ms a launch, the largest counts (29, 33) 0.409-0.410 and 0.359-0.360.
int tile_rows(int width) {
  const int most = (kChunk - 15) / width;
  if (most <= 1) return 1;
  const int step = 16 >> __builtin_ctz(width | 16);  // 16 / gcd(width, 16)
  const int aligned = most - most % step;
  return 4 * aligned >= 3 * most ? aligned : most;
}

}  // namespace

// d0..d3: the delimiter table as four 64-bit words (bit b of d_i: byte
// 64*i + b is a delimiter). The four outputs must be 16-byte aligned
// (the wrapper allocates them).
extern "C" int tokenize_hash_launch(const uint8_t* blocks, const int32_t* lens,
                                    const uint32_t* pw1, const uint32_t* pw2, int8_t* mask,
                                    int8_t* starts, uint32_t* pref1, uint32_t* pref2,
                                    long long n_rows, int width, unsigned long long d0,
                                    unsigned long long d1, unsigned long long d2,
                                    unsigned long long d3, void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaSuccess;
  const int rows = tile_rows(width);
  if ((reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(starts) |
       reinterpret_cast<uintptr_t>(pref1) | reinterpret_cast<uintptr_t>(pref2)) & 15)
    return (int)cudaErrorMisalignedAddress;
  DelimSet ds;
  const unsigned long long d[4] = {d0, d1, d2, d3};
  for (int i = 0; i < 4; ++i) {
    ds.w[2 * i] = (uint32_t)(d[i] & 0xFFFFFFFFull);
    ds.w[2 * i + 1] = (uint32_t)(d[i] >> 32);
  }
  const unsigned magic = width >= 2 ? (unsigned)(((1ull << 32) + width - 1) / width) : 0u;
  const unsigned grid = (unsigned)((n_rows + rows - 1) / rows);
  tokenize_hash_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, lens, pw1, pw2, mask, starts, pref1, pref2, n_rows, width, rows, magic, ds);
  return (int)cudaGetLastError();
}
