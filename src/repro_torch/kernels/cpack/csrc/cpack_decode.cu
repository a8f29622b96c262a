// C-Pack decode for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel decompress_pallas (_decompress_kernel) of
// src/repro/kernels/cpack/cpack.py, paper Alg. 5.  A block of B bytes is
// W = B / 4 four-byte words.  A compressible block (ok set) holds a
// 4-entry dictionary, a 4-bit code per word (nibble-packed, the low nibble
// the even word) and a 1-byte payload per word; code 1+k is dictionary
// entry k, 5+k is entry k with its low byte replaced by the payload, 9 is
// the payload zero-extended, anything else is zero.  A block whose ok is
// clear copies its raw bytes.
//
// What bounds it: bytes.  A few integer operations per word, far below
// the card's ~295 operations per byte.  The bound counts the layout as the
// TPU kernel reads it -- ok, dictionary, codes, payload and the full raw
// array in, the words out: 721 B in and 512 B out per 512 B block -- over
// 3.35 TB/s.  This kernel reads less: the codes and payload of ok blocks
// only and the raw bytes of the others, each once.  The fixed word size
// (the paper's point) makes every word independent: one thread per output
// word, a grid-stride loop, consecutive threads on consecutive words, so
// loads and stores coalesce; the 4-way select is a register index.
// Unlike the TPU kernel, which asserts nb % bn == 0, any block count is
// taken.  A simple first form: no vector loads.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFull0 = 1, kPart0 = 5, kZext = 9, kNdict = 4;

__global__ void __launch_bounds__(kThreads)
cpack_decode_kernel(const uint8_t* __restrict__ ok,
                    const uint32_t* __restrict__ dict,
                    const uint8_t* __restrict__ codes,
                    const uint8_t* __restrict__ payload,
                    const uint32_t* __restrict__ raw,
                    uint32_t* __restrict__ out, int64_t n_words, int W) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n_words; i += stride) {
    const int64_t b = i / W;
    uint32_t v = 0;
    if (!ok[b]) {
      v = raw[i];
    } else {
      const int code = (codes[i >> 1] >> (4 * (i & 1))) & 0xF;
      const uint32_t pay = payload[i];
      const uint32_t* d = dict + kNdict * b;
      if (code >= kFull0 && code < kFull0 + kNdict)
        v = d[code - kFull0];
      else if (code >= kPart0 && code < kPart0 + kNdict)
        v = (d[code - kPart0] & 0xFFFFFF00u) | pay;
      else if (code == kZext)
        v = pay;
    }
    out[i] = v;
  }
}

}  // namespace

extern "C" {

// ok uint8[nb] (0/1); dict uint32[nb, 4]; codes uint8[nb, W/2]; payload
// uint8[nb, W]; raw uint8[nb, 4W] (4-byte aligned) -> out uint8[nb, 4W]
// (4-byte aligned).  W must be even.
int cpack_decode(const void* ok, const void* dict, const void* codes,
                 const void* payload, const void* raw, void* out, int nb,
                 int W, void* cuda_stream) {
  if (nb <= 0 || W <= 0 || W % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  const int64_t n = static_cast<int64_t>(nb) * W;
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  cpack_decode_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(ok), static_cast<const uint32_t*>(dict),
      static_cast<const uint8_t*>(codes), static_cast<const uint8_t*>(payload),
      static_cast<const uint32_t*>(raw), static_cast<uint32_t*>(out), n, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
