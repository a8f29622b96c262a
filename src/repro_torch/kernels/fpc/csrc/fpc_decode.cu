// FPC decode for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel decompress_pallas (_fpc_kernel, _decode_seg)
// of src/repro/kernels/fpc/fpc.py: a block of 512 B is 16 segments of 8
// four-byte words; each segment has one of 8 patterns (zero, 4/8/16-bit
// sign-extended, upper halfword, two sign-extended bytes, repeated byte,
// raw) and its payload follows the previous segment's in the stream, from
// the block's offset.  Segment offsets are the exclusive scan of the
// pattern sizes.
//
// What bounds it: bytes.  A few integer operations per output word and at
// most one compressed byte read per output byte, far below the card's
// ~295 operations per byte: the least time is (compressed bytes read + raw
// bytes written) / 3.35 TB/s.  The design reads each payload byte once:
// one thread scans the 16 pattern sizes, the block stages exactly its
// payload (not the B + 32 over-fetch window) in shared memory with
// consecutive threads on consecutive bytes, then thread t expands word t
// of the block (segment t / 8, word t % 8) and stores it with neighbouring
// threads on neighbouring addresses.
//
// Layout: one block of 128 threads per 512 B block; the pattern branch is
// uniform across each group of 8 threads.  A simple first form.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSegWords = 8;
constexpr int kSegBytes = 32;
constexpr int kMaxSegs = 256;    // block_bytes <= 8192

__device__ __forceinline__ int seg_bytes(int pat) {
  switch (pat) {
    case 1: return 4;
    case 2: case 6: return 8;
    case 3: case 4: case 5: return 16;
    case 7: return 32;
    default: return 0;
  }
}

__device__ __forceinline__ uint32_t sext(uint32_t v, int bits) {
  const int shift = 32 - bits;
  return static_cast<uint32_t>(static_cast<int32_t>(v << shift) >> shift);
}

// Word j of a segment of pattern pat whose payload starts at q.
__device__ __forceinline__ uint32_t decode_word(const uint8_t* q, int pat,
                                                int j) {
  switch (pat) {
    case 1: {
      const uint32_t b = q[j >> 1];
      return sext((j & 1) ? b >> 4 : b & 0xFu, 4);
    }
    case 2: return sext(q[j], 8);
    case 3: return sext(q[2 * j] | (q[2 * j + 1] << 8), 16);
    case 4: return static_cast<uint32_t>(q[2 * j] | (q[2 * j + 1] << 8)) << 16;
    case 5:
      return (sext(q[2 * j], 8) & 0xFFFFu) | (sext(q[2 * j + 1], 8) << 16);
    case 6: return static_cast<uint32_t>(q[j]) * 0x01010101u;
    case 7:
      return static_cast<uint32_t>(q[4 * j]) | (q[4 * j + 1] << 8) |
             (q[4 * j + 2] << 16) | (static_cast<uint32_t>(q[4 * j + 3]) << 24);
    default: return 0u;          // zero (and unknown patterns)
  }
}

__global__ void __launch_bounds__(kThreads)
fpc_decode_kernel(const uint8_t* __restrict__ stream,
                  const int32_t* __restrict__ offsets,
                  const uint8_t* __restrict__ seg_enc,
                  uint8_t* __restrict__ out, int nseg) {
  extern __shared__ uint8_t payload[];
  __shared__ int seg_off[kMaxSegs + 1];
  __shared__ uint8_t seg_pat[kMaxSegs];
  const int blk = blockIdx.x;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < nseg; ++s) {
      const int p = seg_enc[static_cast<size_t>(blk) * nseg + s];
      seg_pat[s] = static_cast<uint8_t>(p);
      seg_off[s] = acc;
      acc += seg_bytes(p);
    }
    seg_off[nseg] = acc;
  }
  __syncthreads();
  const int64_t off = offsets[blk];
  const int len = seg_off[nseg];
  for (int i = threadIdx.x; i < len; i += blockDim.x) payload[i] = stream[off + i];
  __syncthreads();

  uint32_t* o = reinterpret_cast<uint32_t*>(
      out + static_cast<size_t>(blk) * nseg * kSegBytes);
  for (int t = threadIdx.x; t < nseg * kSegWords; t += blockDim.x) {
    const int s = t / kSegWords;
    o[t] = decode_word(payload + seg_off[s], seg_pat[s], t % kSegWords);
  }
}

}  // namespace

extern "C" {

// stream uint8[S]; offsets int32[nb]; seg_enc uint8[nb, nseg]; out
// uint8[nb, nseg * 32] (4-byte aligned); nseg <= 256.
int fpc_decode(const void* stream, const void* offsets, const void* seg_enc,
               void* out, int nb, int nseg, void* cuda_stream) {
  if (nb <= 0 || nseg <= 0 || nseg > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(cuda_stream);
  fpc_decode_kernel<<<nb, kThreads, nseg * kSegBytes, st>>>(
      static_cast<const uint8_t*>(stream),
      static_cast<const int32_t*>(offsets),
      static_cast<const uint8_t*>(seg_enc), static_cast<uint8_t*>(out), nseg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
