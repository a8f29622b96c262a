// Variable-rate BDI decode for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel decompress_packed_pallas (_packed_kernel) of
// src/repro/kernels/bdi/bdi.py: every block's record [enc | base | mask |
// deltas] sits at offsets[i] in one byte stream, and its encoding id
// selects zeros, rep8, base+delta over 8/4/2-byte words, or raw.  Unlike
// the TPU kernel, which maps the 8-byte-word ids 2-4 to raw because its
// callers never emit them, this one decodes all nine ids: the cold tier
// packs with the full table, and 64-bit integer arithmetic is native here.
//
// What bounds it: bytes.  Per output byte it reads at most ~1 compressed
// byte and does a handful of integer operations, far below the card's
// ~295 operations per byte, so the least time is (compressed bytes read
// + raw bytes written) / 3.35 TB/s.  The design reads each record once:
// the block stages only its own record (enc_size bytes, not the 1+B
// over-fetch window) in shared memory with consecutive threads on
// consecutive bytes, then every thread builds whole 4-byte output words
// from shared memory and stores them with neighbouring threads on
// neighbouring addresses.
//
// Layout: one block of 128 threads per 512 B block ("cache line").  The
// branch on the encoding id is uniform across the block.  A simple first
// form: no vector loads, no multi-block-per-CTA batching.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int enc_word_bytes(int e) {
  switch (e) {
    case 2: case 3: case 4: return 8;
    case 5: case 6: return 4;
    case 7: return 2;
    default: return 0;
  }
}

__device__ __forceinline__ int enc_delta_bytes(int e) {
  switch (e) {
    case 2: case 5: case 7: return 1;
    case 3: case 6: return 2;
    case 4: return 4;
    default: return 0;
  }
}

// Bytes of one record (id byte included), as the host encoder writes it.
__device__ __forceinline__ int record_bytes(int e, int B) {
  if (e == 0) return 1;
  if (e == 1) return 9;
  if (e == 8) return 1 + B;
  const int wb = enc_word_bytes(e);
  if (wb == 0) return 1;          // unknown id: decodes to zeros
  const int W = B / wb;
  return 1 + wb + (W + 7) / 8 + W * enc_delta_bytes(e);
}

// n little-endian bytes at p (n <= 4), zero-extended.
__device__ __forceinline__ uint32_t le(const uint8_t* p, int n) {
  uint32_t v = 0;
  for (int k = 0; k < n; ++k) v |= static_cast<uint32_t>(p[k]) << (8 * k);
  return v;
}

// The low n bytes of v sign-extended to 64 bits.
__device__ __forceinline__ int64_t sext(uint32_t v, int n) {
  const int shift = 64 - 8 * n;
  return static_cast<int64_t>(static_cast<uint64_t>(v) << shift) >> shift;
}

__device__ __forceinline__ int mask_bit(const uint8_t* mask, int w) {
  return (mask[w >> 3] >> (w & 7)) & 1;
}

__global__ void __launch_bounds__(kThreads)
bdi_packed_decode_kernel(const uint8_t* __restrict__ stream,
                         const int32_t* __restrict__ offsets,
                         const uint8_t* __restrict__ enc,
                         uint8_t* __restrict__ out, int B) {
  extern __shared__ uint8_t rec[];
  const int blk = blockIdx.x;
  const int e = enc[blk];
  const int64_t off = offsets[blk];
  const int len = record_bytes(e, B);
  for (int i = threadIdx.x; i < len; i += blockDim.x) rec[i] = stream[off + i];
  __syncthreads();

  uint32_t* o = reinterpret_cast<uint32_t*>(out + static_cast<size_t>(blk) * B);
  const int wb = enc_word_bytes(e);
  const int db = enc_delta_bytes(e);
  const int W = wb ? B / wb : 0;
  const uint8_t* mask = rec + 1 + wb;
  const uint8_t* deltas = mask + (W + 7) / 8;
  for (int t = threadIdx.x; t < B / 4; t += blockDim.x) {
    uint32_t word = 0;
    if (e == 1) {                                   // rep8
      word = le(rec + 1 + 4 * (t & 1), 4);
    } else if (e == 8) {                            // raw
      word = le(rec + 1 + 4 * t, 4);
    } else if (wb == 8) {                           // b8d1 / b8d2 / b8d4
      const int w = t >> 1;
      const uint64_t base = static_cast<uint64_t>(le(rec + 1, 4)) |
                            (static_cast<uint64_t>(le(rec + 5, 4)) << 32);
      const uint64_t d = static_cast<uint64_t>(sext(le(deltas + w * db, db), db));
      const uint64_t v = mask_bit(mask, w) ? base + d : d;
      word = static_cast<uint32_t>((t & 1) ? v >> 32 : v);
    } else if (wb == 4) {                           // b4d1 / b4d2
      const uint32_t base = le(rec + 1, 4);
      const uint32_t d = static_cast<uint32_t>(sext(le(deltas + t * db, db), db));
      word = mask_bit(mask, t) ? base + d : d;
    } else if (wb == 2) {                           // b2d1
      const uint32_t base = le(rec + 1, 2);
      for (int j = 0; j < 2; ++j) {
        const int w = 2 * t + j;
        const uint32_t d = static_cast<uint32_t>(sext(deltas[w], 1));
        const uint32_t v = (mask_bit(mask, w) ? base + d : d) & 0xFFFFu;
        word |= v << (16 * j);
      }
    }                                               // zeros (and unknown ids)
    o[t] = word;
  }
}

}  // namespace

extern "C" {

// stream uint8[S]; offsets int32[nb]; enc uint8[nb]; out uint8[nb, B]
// (4-byte aligned).  B must be a multiple of 8.
int bdi_packed_decode(const void* stream, const void* offsets,
                      const void* enc, void* out, int nb, int block_bytes,
                      void* cuda_stream) {
  if (nb <= 0 || block_bytes <= 0 || block_bytes % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  bdi_packed_decode_kernel<<<nb, kThreads, 1 + block_bytes, st>>>(
      static_cast<const uint8_t*>(stream),
      static_cast<const int32_t*>(offsets), static_cast<const uint8_t*>(enc),
      static_cast<uint8_t*>(out), block_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
