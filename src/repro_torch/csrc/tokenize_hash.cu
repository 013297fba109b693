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
// Bound on the H100: bytes. Each input byte becomes 10 output bytes
// (two int8 masks, two uint32 prefix sums), so the kernel must stream
// 11 bytes per grid cell through device memory; its arithmetic is a few
// integer operations a byte. One warp owns one row and walks it in
// chunks of 32 bytes, a byte per lane: loads and stores of a chunk are
// contiguous across the warp. The inclusive prefix sum of a chunk is a
// warp scan with shuffles (uint32 wraparound addition is associative, so
// the scan is exact in any order), and the running total of earlier
// chunks is carried from lane 31. The token bit of the byte before the
// chunk is carried the same way for `starts`. Rows of any width B are
// taken: the loop runs ceil(B / 32) chunks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct DelimSet {
  uint32_t w[8];  // bit b of word w: byte 32*w + b is a delimiter
};

__global__ void tokenize_hash_kernel(const uint8_t* __restrict__ blocks,
                                     const int32_t* __restrict__ lens,
                                     const uint32_t* __restrict__ pw1,
                                     const uint32_t* __restrict__ pw2, int8_t* __restrict__ mask,
                                     int8_t* __restrict__ starts, uint32_t* __restrict__ pref1,
                                     uint32_t* __restrict__ pref2, long long n_rows, int width,
                                     DelimSet delims) {
  __shared__ uint32_t sdelim[8];
  if (threadIdx.x < 8) sdelim[threadIdx.x] = delims.w[threadIdx.x];
  __syncthreads();

  const long long row = (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int len = __ldg(lens + row);
  const long long base = row * (long long)width;

  uint32_t carry1 = 0, carry2 = 0;
  uint32_t prev_tok = 0;  // token bit of the byte before the chunk
  for (int c = 0; c < width; c += 32) {
    const int p = c + lane;
    const bool in_row = p < width;
    const uint32_t byte = in_row ? (uint32_t)__ldg(blocks + base + p) : 0u;
    const bool is_delim = (sdelim[byte >> 5] >> (byte & 31)) & 1u;
    const bool tok = in_row && p < len && !is_delim;
    const uint32_t bits = __ballot_sync(kFull, tok);
    const uint32_t prev = lane == 0 ? prev_tok : (bits >> (lane - 1)) & 1u;
    uint32_t w1 = 0, w2 = 0;
    if (tok) {
      w1 = (byte + 1u) * __ldg(pw1 + p);
      w2 = (byte + 1u) * __ldg(pw2 + p);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y1 = __shfl_up_sync(kFull, w1, off);
      const uint32_t y2 = __shfl_up_sync(kFull, w2, off);
      if (lane >= off) {
        w1 += y1;
        w2 += y2;
      }
    }
    w1 += carry1;
    w2 += carry2;
    if (in_row) {
      mask[base + p] = (int8_t)tok;
      starts[base + p] = (int8_t)(tok && !prev);
      pref1[base + p] = w1;
      pref2[base + p] = w2;
    }
    carry1 = __shfl_sync(kFull, w1, 31);
    carry2 = __shfl_sync(kFull, w2, 31);
    prev_tok = bits >> 31;
  }
}

}  // namespace

// d0..d3: the delimiter table as four 64-bit words (bit b of d_i: byte
// 64*i + b is a delimiter).
extern "C" int tokenize_hash_launch(const uint8_t* blocks, const int32_t* lens,
                                    const uint32_t* pw1, const uint32_t* pw2, int8_t* mask,
                                    int8_t* starts, uint32_t* pref1, uint32_t* pref2,
                                    long long n_rows, int width, unsigned long long d0,
                                    unsigned long long d1, unsigned long long d2,
                                    unsigned long long d3, void* stream) {
  if (n_rows <= 0 || width <= 0) return (int)cudaSuccess;
  DelimSet ds;
  const unsigned long long d[4] = {d0, d1, d2, d3};
  for (int i = 0; i < 4; ++i) {
    ds.w[2 * i] = (uint32_t)(d[i] & 0xFFFFFFFFull);
    ds.w[2 * i + 1] = (uint32_t)(d[i] >> 32);
  }
  const long long blocks_n = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  tokenize_hash_kernel<<<(unsigned)blocks_n, kThreads, 0, (cudaStream_t)stream>>>(
      blocks, lens, pw1, pw2, mask, starts, pref1, pref2, n_rows, width, ds);
  return (int)cudaGetLastError();
}
