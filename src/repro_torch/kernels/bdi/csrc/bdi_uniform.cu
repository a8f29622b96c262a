// Fixed-encoding BDI decode and encode for Hopper (sm_90a), plain C
// interface.
//
// Replaces two Pallas kernels of src/repro/kernels/bdi/bdi.py:
// * decompress_pallas (_decompress_kernel), paper Alg. 1: every word is its
//   sign-extended delta (1 byte, or 2 as a little-endian pair) plus the
//   block's base where its mask bit is set, truncated to the word width;
// * compress_pallas (_compress_kernel), paper Alg. 2: the base is the
//   block's first word; a word takes the base where its delta fits the
//   delta width as a signed number, else the zero base; the block is ok
//   when every word fits one of the two.  The fit tests wrap at 32 bits
//   ((u + half) < 2^bits on uint32), as the reference's.
// Encodings b2d1 (uint16 words), b4d1 and b4d2 (uint32 words); a block of
// B bytes holds W = B / word_bytes words.  Layout per block: base
// uint32[1], mask uint8[W/8] (little-bit-endian), deltas uint8[W * d].
//
// What bounds them: bytes.  A handful of integer operations per word,
// far below the card's ~295 operations per byte: the least time is
// (bytes read + bytes written) / 3.35 TB/s.  The design keeps every
// access coalesced and reads each byte once:
// * decode: one thread per output word, a grid-stride loop, consecutive
//   threads on consecutive words, deltas and outputs;
// * encode: one CTA per block row, one thread per word (W = 128 or 256
//   threads).  The block's ok is one __syncthreads_and, and each warp's 32
//   mask bits come from one __ballot_sync, stored as one 4-byte word by
//   lane 0 (lane i is bit i: little-bit-endian).
// Unlike the TPU kernels, which assert nb % bn == 0, any block count is
// taken.  A simple first form: no vector loads.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDecodeThreads = 256;

template <int WB, int DB>
__global__ void __launch_bounds__(kDecodeThreads)
bdi_uniform_decode_kernel(const uint32_t* __restrict__ base,
                          const uint8_t* __restrict__ mask,
                          const uint8_t* __restrict__ deltas,
                          void* __restrict__ out, int64_t n_words, int W) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_words; i += stride) {
    const int64_t b = i / W;
    const int w = static_cast<int>(i - b * W);
    uint32_t d;
    if (DB == 1) {
      d = static_cast<uint32_t>(static_cast<int32_t>(
          static_cast<int8_t>(deltas[i])));
    } else {
      const uint8_t* p = deltas + 2 * i;
      d = static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(
          static_cast<uint16_t>(p[0] | (p[1] << 8)))));
    }
    const int bit = (mask[b * (W / 8) + (w >> 3)] >> (w & 7)) & 1;
    const uint32_t v = bit ? base[b] + d : d;
    if (WB == 2)
      static_cast<uint16_t*>(out)[i] = static_cast<uint16_t>(v);
    else
      static_cast<uint32_t*>(out)[i] = v;
  }
}

// blockDim.x == W (a multiple of 32, at most 1024).
template <int WB, int DB>
__global__ void bdi_uniform_encode_kernel(const void* __restrict__ words,
                                          uint32_t* __restrict__ base,
                                          uint8_t* __restrict__ mask,
                                          uint8_t* __restrict__ deltas,
                                          uint8_t* __restrict__ ok, int W) {
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  uint32_t w, w0;
  if (WB == 2) {
    const uint16_t* row = static_cast<const uint16_t*>(words) + b * W;
    w = row[t];
    w0 = row[0];
  } else {
    const uint32_t* row = static_cast<const uint32_t*>(words) + b * W;
    w = row[t];
    w0 = row[0];
  }
  constexpr uint32_t kHalf = 1u << (8 * DB - 1);
  constexpr uint32_t kFull = 1u << (8 * DB);
  const uint32_t delta = w - w0;                 // wraps at 32 bits
  const bool from_base = (delta + kHalf) < kFull;
  const bool from_zero = (w + kHalf) < kFull;
  const int all_fit = __syncthreads_and(from_base || from_zero);
  const unsigned bits = __ballot_sync(0xffffffffu, from_base);
  if ((t & 31) == 0)
    reinterpret_cast<uint32_t*>(mask + b * (W / 8))[t >> 5] = bits;
  const uint32_t sel = from_base ? delta : w;
  if (DB == 1)
    deltas[b * W + t] = static_cast<uint8_t>(sel);
  else
    reinterpret_cast<uint16_t*>(deltas)[b * W + t] =
        static_cast<uint16_t>(sel);
  if (t == 0) {
    base[b] = w0;
    ok[b] = all_fit ? 1 : 0;
  }
}

template <int WB, int DB>
void launch_decode(const void* base, const void* mask, const void* deltas,
                   void* out, int nb, int W, cudaStream_t st) {
  const int64_t n = static_cast<int64_t>(nb) * W;
  const int64_t want = (n + kDecodeThreads - 1) / kDecodeThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  bdi_uniform_decode_kernel<WB, DB><<<blocks, kDecodeThreads, 0, st>>>(
      static_cast<const uint32_t*>(base), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(deltas), out, n, W);
}

template <int WB, int DB>
void launch_encode(const void* words, void* base, void* mask, void* deltas,
                   void* ok, int nb, int W, cudaStream_t st) {
  bdi_uniform_encode_kernel<WB, DB><<<nb, W, 0, st>>>(
      words, static_cast<uint32_t*>(base), static_cast<uint8_t*>(mask),
      static_cast<uint8_t*>(deltas), static_cast<uint8_t*>(ok), W);
}

bool valid(int nb, int W, int wb, int db) {
  const bool enc = (wb == 2 && db == 1) || (wb == 4 && (db == 1 || db == 2));
  return enc && nb > 0 && W > 0 && W % 32 == 0 && W <= 1024;
}

}  // namespace

extern "C" {

// base uint32[nb]; mask uint8[nb, W/8]; deltas uint8[nb, W*db] ->
// out uint16[nb, W] (wb 2) or uint32[nb, W] (wb 4).
int bdi_uniform_decode(const void* base, const void* mask, const void* deltas,
                       void* out, int nb, int W, int wb, int db,
                       void* cuda_stream) {
  if (!valid(nb, W, wb, db)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (wb == 2)
    launch_decode<2, 1>(base, mask, deltas, out, nb, W, st);
  else if (db == 1)
    launch_decode<4, 1>(base, mask, deltas, out, nb, W, st);
  else
    launch_decode<4, 2>(base, mask, deltas, out, nb, W, st);
  return static_cast<int>(cudaGetLastError());
}

// words uint16[nb, W] (wb 2) or uint32[nb, W] (wb 4) -> base uint32[nb],
// mask uint8[nb, W/8] (4-byte aligned), deltas uint8[nb, W*db] (2-byte
// aligned), ok uint8[nb].
int bdi_uniform_encode(const void* words, void* base, void* mask,
                       void* deltas, void* ok, int nb, int W, int wb, int db,
                       void* cuda_stream) {
  if (!valid(nb, W, wb, db)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  if (wb == 2)
    launch_encode<2, 1>(words, base, mask, deltas, ok, nb, W, st);
  else if (db == 1)
    launch_encode<4, 1>(words, base, mask, deltas, ok, nb, W, st);
  else
    launch_encode<4, 2>(words, base, mask, deltas, ok, nb, W, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
