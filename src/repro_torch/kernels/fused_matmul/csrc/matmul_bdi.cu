// Fused lossless-BDI-weight matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/fused_matmul/fused_matmul.py
// (matmul_bdi / _matmul_bdi_kernel): y = x @ W, x bf16 [M, K], W bf16
// [K, N] rebuilt from its b2d1 layout (ref.make_bdi_b2d1_layout): per row
// and 256-column block a base (a 16-bit pattern in an int32), a mask of
// 32 bytes (bit j of byte i: value 8 i + j is stored from the base) and
// one delta byte per value.  A value is sext(delta), plus the base where
// its mask bit is set, keeping the low 16 bits; f32 accumulation, bf16 y
// [M, N].  It is the paper's lossless compressed-weight site: device
// memory streams 1.14 bytes per weight (delta, mask bit, base share) in
// place of 2, and the decompression runs on the way to the tensor cores.
//
// What bounds it: at decode (M = the batch slots, 4) bytes -- the layout
// is read once for 2 M operations per weight; at prefill M it nears the
// bf16 tensor-core rate.  The design is kernel 6's (matmul_q8.cu): the
// delta, mask and base tiles land in shared memory by cp.async kStages - 1
// tiles ahead of the math, and K is split across blocks when the output
// has too few tiles to fill the card; each split writes its f32 partial
// to a workspace and the last block of the tile to arrive (an arrival
// counter per tile, set back to 0 by that block) sums the partials in
// split order, so the result does not depend on the block order.
//
// Block: 4 warps over a (16 * MT) x 128 tile of y, K in steps of 32.  A
// 128-column tile lies inside one 256-column b2d1 block, so each of its
// rows has one base and 16 mask bytes.  Each warp rebuilds the bf16 bit
// patterns of its B fragments in registers from the staged bytes (the
// column of fragment element gid is bit gid of mask byte wn / 8 + j) and
// runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) on 32 columns; the sum
// is rounded to bf16 once.  Rows beyond M are zero-filled and never
// stored (the TPU kernel asserts M % bm == 0); N is a multiple of 256.
// wgmma and TMA are later work.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int BN = 128;        // columns per block, 32 per warp
constexpr int BK = 32;         // K per pipeline stage: two k16 steps
constexpr int kStages = 4;
constexpr int XP = BK + 8;     // x tile row pitch (bf16): conflict-free A loads
constexpr int DP = BN + 16;    // delta tile row pitch (bytes)
constexpr int MB = BN / 8;     // mask bytes per tile row

template <int MT>
struct Tiles {
  __nv_bfloat16 x[kStages][16 * MT][XP];
  uint8_t d[kStages][BK][DP];
  uint8_t m[kStages][BK][MB];
  int base[kStages][BK];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the bf16 bit pattern of one b2d1 value
__device__ __forceinline__ uint32_t rebuild(uint8_t delta, uint8_t mask,
                                            int bit, int base) {
  const int d = static_cast<int8_t>(delta);
  const int v = ((mask >> bit) & 1) ? base + d : d;
  return static_cast<uint32_t>(v) & 0xFFFFu;
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid (N / BN, ceil(M / (16 MT)), splits); split z covers K tiles
// [z * kt_per, min(z * kt_per + kt_per, K / BK)).
template <int MT>
__global__ void __launch_bounds__(kThreads)
matmul_bdi_kernel(const __nv_bfloat16* __restrict__ x,
                  const int* __restrict__ base,
                  const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ deltas,
                  __nv_bfloat16* __restrict__ y, float* __restrict__ work,
                  int* __restrict__ counters, int M, int N, int K,
                  int kt_per) {
  constexpr int BM = 16 * MT;
  __shared__ __align__(16) Tiles<MT> t;
  __shared__ int s_last;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4;   // fragment row / column group
  const int tig = lane % 4;   // thread in group
  const int n_base = blockIdx.x * BN;
  const int m_base = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int kt_all = K / BK;
  const int kt0 = split * kt_per;
  const int nk = min(kt_per, kt_all - kt0);
  const int nb = N / 256;     // b2d1 blocks (bases) per row

  // one stage: x tile BM x 32 bf16 (4 chunks of 16 B a row); 32 rows of
  // 128 delta bytes (8 chunks), 16 mask bytes (1 chunk) and one base
  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    for (int c = threadIdx.x; c < BM * 4; c += kThreads) {
      const int r = c / 4;
      const int m = m_base + r;
      const bool ok = m < M;
      const __nv_bfloat16* src =
          x + static_cast<int64_t>(ok ? m : 0) * K + k0 + (c % 4) * 8;
      cp_async16(&t.x[stage][r][(c % 4) * 8], src, ok);
    }
    for (int c = threadIdx.x; c < BK * 8; c += kThreads) {
      const int r = c / 8;
      const uint8_t* src =
          deltas + static_cast<int64_t>(k0 + r) * N + n_base + (c % 8) * 16;
      cp_async16(&t.d[stage][r][(c % 8) * 16], src, true);
    }
    if (threadIdx.x < BK) {
      const int r = threadIdx.x;
      cp_async16(&t.m[stage][r][0],
                 mask + static_cast<int64_t>(k0 + r) * (N / 8) + n_base / 8,
                 true);
    } else if (threadIdx.x < 2 * BK) {
      const int r = threadIdx.x - BK;
      cp_async4(&t.base[stage][r],
                base + static_cast<int64_t>(k0 + r) * nb + n_base / 256);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  const int wn = warp * 32;  // this warp's first column in the tile
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed (own copies)
    __syncthreads();               // all copies landed; stage it-1 free
    const int nxt = it + kStages - 1;
    if (nxt < nk) load(nxt % kStages, kt0 + nxt);
    cp_async_commit();

    const int st = it % kStages;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t bfr[4][2];
      const int r = kk + 2 * tig;
      const int b0 = t.base[st][r], b1 = t.base[st][r + 1];
      const int b8 = t.base[st][r + 8], b9 = t.base[st][r + 9];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + gid;
        const int mb = wn / 8 + j;   // mask byte of column c; bit gid
        bfr[j][0] = rebuild(t.d[st][r][c], t.m[st][r][mb], gid, b0) |
                    rebuild(t.d[st][r + 1][c], t.m[st][r + 1][mb], gid, b1)
                        << 16;
        bfr[j][1] = rebuild(t.d[st][r + 8][c], t.m[st][r + 8][mb], gid, b8) |
                    rebuild(t.d[st][r + 9][c], t.m[st][r + 9][mb], gid, b9)
                        << 16;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t afr[4];
        const int ra = i * 16 + gid;
        const int ca = kk + 2 * tig;
        afr[0] = *reinterpret_cast<const uint32_t*>(&t.x[st][ra][ca]);
        afr[1] = *reinterpret_cast<const uint32_t*>(&t.x[st][ra + 8][ca]);
        afr[2] = *reinterpret_cast<const uint32_t*>(&t.x[st][ra][ca + 8]);
        afr[3] = *reinterpret_cast<const uint32_t*>(&t.x[st][ra + 8][ca + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], afr, bfr[j]);
      }
    }
  }
  cp_async_wait<0>();

  // fragment element e of (i, j): row i*16 + gid (+8 for e >= 2), column
  // wn + j*8 + 2*tig (+1 for odd e)
  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_base + wn + j * 8 + 2 * tig;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = m_base + i * 16 + gid + 8 * hf;
          if (m < M) {
            *reinterpret_cast<__nv_bfloat162*>(
                &y[static_cast<int64_t>(m) * N + n]) =
                __floats2bfloat162_rn(acc[i][j][2 * hf],
                                      acc[i][j][2 * hf + 1]);
          }
        }
      }
    }
    return;
  }

  // split K: write this split's partial, then the last block sums them
  float* mine = work + static_cast<int64_t>(split) * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n_base + wn + j * 8 + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m_base + i * 16 + gid + 8 * hf;
        if (m < M) {
          *reinterpret_cast<float2*>(&mine[static_cast<int64_t>(m) * N + n]) =
              make_float2(acc[i][j][2 * hf], acc[i][j][2 * hf + 1]);
        }
      }
    }
  }
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&counters[tile], 1) == n_split - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n_base + wn + j * 8 + 2 * tig;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m_base + i * 16 + gid + 8 * hf;
        if (m < M) {
          const int64_t off = static_cast<int64_t>(m) * N + n;
          float s0 = 0.0f, s1 = 0.0f;
          for (int s = 0; s < n_split; ++s) {
            const float2 p = __ldcg(
                reinterpret_cast<const float2*>(&work[s * int64_t(M) * N + off]));
            s0 += p.x;
            s1 += p.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(&y[off]) =
              __floats2bfloat162_rn(s0, s1);
        }
      }
    }
  }
  if (threadIdx.x == 0) counters[tile] = 0;
}

template <int MT>
int launch(const void* x, const void* base, const void* mask,
           const void* deltas, void* y, void* work, void* counters, int M,
           int N, int K, int kt_per, cudaStream_t stream) {
  const int kt_all = K / BK;
  const int splits = (kt_all + kt_per - 1) / kt_per;
  const dim3 grid(N / BN, (M + 16 * MT - 1) / (16 * MT), splits);
  matmul_bdi_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int*>(base),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(deltas),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(work),
      static_cast<int*>(counters), M, N, K, kt_per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x bf16 [M, K]; base int32 [K, N / 256]; mask uint8 [K, N / 8]; deltas
// uint8 [K, N]; y bf16 [M, N]; work f32 [splits, M, N] (read only when
// splits > 1); counters int32 [ceil(M / (16 m_tiles)) * N / 128], zero on
// entry and on exit.  N a multiple of 256, K of 32; m_tiles 1 or 4,
// kt_per >= 1 K tiles of 32 per split.
int matmul_bdi(const void* x, const void* base, const void* mask,
               const void* deltas, void* y, void* work, void* counters, int M,
               int N, int K, int m_tiles, int kt_per, void* stream) {
  if (M <= 0 || N <= 0 || N % 256 != 0 || K <= 0 || K % BK != 0 ||
      kt_per <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m_tiles == 1) {
    return launch<1>(x, base, mask, deltas, y, work, counters, M, N, K,
                     kt_per, st);
  }
  if (m_tiles == 4) {
    return launch<4>(x, base, mask, deltas, y, work, counters, M, N, K,
                     kt_per, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
