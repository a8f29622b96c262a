// Fused int8-weight matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/fused_matmul/fused_matmul.py
// (matmul_q8 / _matmul_q8_kernel): y = x @ (w8 * scale), x bf16 [M, K],
// w8 int8 [K, N], scale f32 [K / gk, N] (one scale per K-group of gk rows
// and column), f32 accumulation, bf16 y [M, N].  It is the paper's
// compressed-weight site: device memory streams int8 weight bytes and the
// decompression runs in registers on the way to the tensor cores.
//
// What bounds it: at decode (M = the batch slots, 4) bytes -- the weight
// is read once for 2 M operations per byte; at prefill (M = a prompt
// bucket, up to a few hundred rows) it nears the bf16 tensor-core rate.
// The design answers the byte bound by reading each weight byte once, as
// int8, with 16-byte cp.async copies kept kStages - 1 tiles ahead of the
// math, and by splitting K across blocks when the output has too few
// tiles to fill the card (at M = 4 an N = 512 projection has 4 tiles):
// each split writes its f32 partial to a workspace and the last block of
// the tile to arrive (an arrival counter per tile, set back to 0 by that
// block) sums the partials in split order, so the result does not depend
// on the block order.
//
// Block: 4 warps over a (16 * MT) x 128 tile of y, K in steps of 32.  The
// int8 tile lands in shared memory as it is stored; each warp converts the
// bytes of its B fragments to bf16 in registers (exact for |q| <= 127) and
// runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) on 32 columns.  The
// scale is applied once per (K-group, column) to that group's partial sum,
// at the group's last K step, as in the TPU kernel (acc += dot(x, w8) * s).
// With bf16_scale set the scale is first rounded to bf16, as the reference
// model's consumer of a q8 leaf (getw: bf16(q8) * bf16(s8)) rounds it.
// Rows beyond M are zero-filled and never stored (the TPU kernel asserts
// M % bm == 0).  wgmma and TMA are later work.
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
constexpr int WP = BN + 16;    // w tile row pitch (bytes): conflict-free B loads

template <int MT>
struct Tiles {
  __nv_bfloat16 x[kStages][16 * MT][XP];
  int8_t w[kStages][BK][WP];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t bf16x2_of(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));
  return *reinterpret_cast<uint32_t*>(&v);
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

// grid (ceil(N / BN), ceil(M / (16 MT)), splits); split z covers K tiles
// [z * kt_per, min(z * kt_per + kt_per, K / BK)).
template <int MT>
__global__ void __launch_bounds__(kThreads)
matmul_q8_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w8,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ y, float* __restrict__ work,
                 int* __restrict__ counters, int M, int N, int K, int gk,
                 int kt_per, int bf16_scale) {
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

  // one stage: x tile BM x 32 bf16 (4 chunks of 16 B a row), w tile
  // 32 x 128 int8 (8 chunks a row)
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
      const int n = n_base + (c % 8) * 16;
      const bool ok = n < N;
      const int8_t* src =
          w8 + static_cast<int64_t>(k0 + r) * N + (ok ? n : 0);
      cp_async16(&t.w[stage][r][(c % 8) * 16], src, ok);
    }
  };

  float acc[MT][4][4];  // this K-group's partial sums
  float tot[MT][4][4];  // scaled sums over the split's groups
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.0f;
        tot[i][j][e] = 0.0f;
      }
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + gid;
        const int r = kk + 2 * tig;
        bfr[j][0] = bf16x2_of(t.w[st][r][c], t.w[st][r + 1][c]);
        bfr[j][1] = bf16x2_of(t.w[st][r + 8][c], t.w[st][r + 9][c]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t afr[4];
        const int r = i * 16 + gid;
        const int c = kk + 2 * tig;
        afr[0] = *reinterpret_cast<const uint32_t*>(&t.x[st][r][c]);
        afr[1] = *reinterpret_cast<const uint32_t*>(&t.x[st][r + 8][c]);
        afr[2] = *reinterpret_cast<const uint32_t*>(&t.x[st][r][c + 8]);
        afr[3] = *reinterpret_cast<const uint32_t*>(&t.x[st][r + 8][c + 8]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], afr, bfr[j]);
      }
    }

    // end of a K-group (or of the split): scale its partial sum once
    const int kt = kt0 + it;
    if (it == nk - 1 || ((kt + 1) * BK) % gk == 0) {
      const float* srow = scale + static_cast<int64_t>(kt * BK / gk) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n_base + wn + j * 8 + 2 * tig;
        float s0 = n < N ? __ldg(&srow[n]) : 0.0f;
        float s1 = n < N ? __ldg(&srow[n + 1]) : 0.0f;
        if (bf16_scale) {
          s0 = __bfloat162float(__float2bfloat16_rn(s0));
          s1 = __bfloat162float(__float2bfloat16_rn(s1));
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tot[i][j][0] += acc[i][j][0] * s0;
          tot[i][j][1] += acc[i][j][1] * s1;
          tot[i][j][2] += acc[i][j][2] * s0;
          tot[i][j][3] += acc[i][j][3] * s1;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        }
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
          if (m < M && n < N) {
            *reinterpret_cast<__nv_bfloat162*>(
                &y[static_cast<int64_t>(m) * N + n]) =
                __floats2bfloat162_rn(tot[i][j][2 * hf],
                                      tot[i][j][2 * hf + 1]);
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
        if (m < M && n < N) {
          *reinterpret_cast<float2*>(&mine[static_cast<int64_t>(m) * N + n]) =
              make_float2(tot[i][j][2 * hf], tot[i][j][2 * hf + 1]);
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
        if (m < M && n < N) {
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
int launch(const void* x, const void* w8, const void* scale, void* y,
           void* work, void* counters, int M, int N, int K, int gk,
           int kt_per, int bf16_scale, cudaStream_t stream) {
  const int kt_all = K / BK;
  const int splits = (kt_all + kt_per - 1) / kt_per;
  const dim3 grid((N + BN - 1) / BN, (M + 16 * MT - 1) / (16 * MT), splits);
  matmul_q8_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(work), static_cast<int*>(counters), M, N, K, gk,
      kt_per, bf16_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x bf16 [M, K]; w8 int8 [K, N]; scale f32 [K / gk, N]; y bf16 [M, N];
// work f32 [splits, M, N] (read only when splits > 1); counters int32
// [ceil(M / (16 m_tiles)) * ceil(N / 128)], zero on entry and on exit.
// K and gk multiples of 32 with K % gk == 0, N a multiple of 16, m_tiles
// 1 or 4, kt_per >= 1 K tiles of 32 per split; bf16_scale 1 rounds each
// scale to bf16 before it is applied.
int matmul_q8(const void* x, const void* w8, const void* scale, void* y,
              void* work, void* counters, int M, int N, int K, int gk,
              int m_tiles, int kt_per, int bf16_scale, void* stream) {
  if (M <= 0 || N <= 0 || N % 16 != 0 || K <= 0 || K % BK != 0 ||
      gk <= 0 || gk % BK != 0 || K % gk != 0 || kt_per <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m_tiles == 1) {
    return launch<1>(x, w8, scale, y, work, counters, M, N, K, gk, kt_per,
                     bf16_scale, st);
  }
  if (m_tiles == 4) {
    return launch<4>(x, w8, scale, y, work, counters, M, N, K, gk, kt_per,
                     bf16_scale, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
