// Dense flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attn/decode_attn.py
// (decode_attn / _decode_kernel): one decode query per (sequence, head)
// attends over a dense [B, G, S, D] KV cache, int8 with f32 per-token
// scales (the CABA compressed-KV site) or bf16, under a length mask.
//
// What bounds it: bytes.  A query does two multiply-adds per KV element
// it reads, far below the card's ~295 operations per byte, so the kernel
// can only move fewer bytes and keep enough of them in flight.  It reads
// only the positions below the length (the rest are never loaded), reads
// int8 KV as int8 and dequantizes in registers, and splits each (b, g)
// row of S positions over ceil(S / chunk) blocks (flash-decoding): the TPU
// kernel's sequential grid axis over S becomes blocks that run at once,
// so B*G rows fill more of the 132 SMs.  Each block stages its chunk's K
// and V rows in shared memory with 16-byte loads that are all issued
// before any is used (one memory round trip per block), then each of its
// 4 warps runs an online softmax over every 4th position, the query group
// (H / G heads) sharing every loaded row.  The warps' states merge in
// shared memory; with more than one split, each block writes its partial
// (acc, m, l) to a workspace and the last block of the row to arrive (an
// arrival counter per row, set back to 0 by that block) merges the splits
// in split order, so the result does not depend on the block order.
//
// Numerics follow the reference step: f32 accumulation, logits scaled by
// D^-0.5 after the dot (int8 K times its scale), positions >= len masked
// by never being read (rows beyond the length may hold NaN), denominator
// max(l, 1e-30) so a len == 0 row gives 0, bf16 output.  A length beyond S
// counts as S.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// One block per (split, g, b); DPL = D / 32 elements of a row per lane
// (lane + 32 j), so a warp reads a row with consecutive addresses.
template <typename KV, bool kScaled, int DPL>
__global__ void __launch_bounds__(kThreads)
dense_decode(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
             const float* __restrict__ ks, const KV* __restrict__ v,
             const float* __restrict__ vs, const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out, float* __restrict__ work,
             int* __restrict__ counters, int H, int G, int S, int chunk,
             float scale) {
  constexpr int D = 32 * DPL;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int split = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_split = gridDim.x;
  const int group = H / G;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  int len = lengths[b];
  len = len < 0 ? 0 : (len > S ? S : len);
  const int s0 = split * chunk;
  const int n = max(0, min(chunk, len - s0));  // valid positions here

  // stage the chunk's valid K/V rows (and scales) in shared memory
  KV* sk = reinterpret_cast<KV*>(smem);
  KV* sv = sk + chunk * D;
  float* sks = reinterpret_cast<float*>(sv + chunk * D);
  float* svs = sks + chunk;
  const int64_t row0 = (static_cast<int64_t>(b) * G + g) * S + s0;
  const int vecs = n * D * static_cast<int>(sizeof(KV)) / 16;
  const uint4* gk4 = reinterpret_cast<const uint4*>(k + row0 * D);
  const uint4* gv4 = reinterpret_cast<const uint4*>(v + row0 * D);
  uint4* sk4 = reinterpret_cast<uint4*>(sk);
  uint4* sv4 = reinterpret_cast<uint4*>(sv);
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
    sk4[i] = gk4[i];
    sv4[i] = gv4[i];
  }
  if (kScaled) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      sks[i] = ks[row0 + i];
      svs[i] = vs[row0 + i];
    }
  }
  // the group's query rows, in registers
  float qr[kMaxGroup][DPL];
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * H + g * group) * D;
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      qr[h][j] = h < group ? to_f32(qb[h * D + lane + 32 * j]) : 0.0f;
    }
  }
  __syncthreads();

  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][DPL];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    m[h] = kNegInf;
    l[h] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[h][j] = 0.0f;
  }
  for (int t = warp; t < n; t += kWarps) {
    float kx[DPL], vx[DPL];
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      kx[j] = to_f32(sk[t * D + lane + 32 * j]);
      vx[j] = to_f32(sv[t * D + lane + 32 * j]);
    }
    const float kscale = kScaled ? sks[t] * scale : scale;
    if (kScaled) {
      const float vscale = svs[t];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vx[j] *= vscale;
    }
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h >= group) break;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) dot += qr[h][j] * kx[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      const float logit = dot * kscale;
      const float m_new = fmaxf(m[h], logit);
      const float alpha = expf(m[h] - m_new);
      const float p = expf(logit - m_new);
      l[h] = l[h] * alpha + p;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[h][j] = acc[h][j] * alpha + p * vx[j];
      m[h] = m_new;
    }
  }
  __syncthreads();  // the staged rows are consumed: reuse them for the merge

  // merge the warps' states: wm/wl [kWarps][kMaxGroup], wacc [..][D]
  float* wm = reinterpret_cast<float*>(smem);
  float* wl = wm + kWarps * kMaxGroup;
  float* wacc = wl + kWarps * kMaxGroup;
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
    if (h >= group) break;
    if (lane == 0) {
      wm[warp * kMaxGroup + h] = m[h];
      wl[warp * kMaxGroup + h] = l[h];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      wacc[(warp * kMaxGroup + h) * D + lane + 32 * j] = acc[h][j];
    }
  }
  __syncthreads();

  const int64_t row = static_cast<int64_t>(b) * G + g;
  __nv_bfloat16* ob = out + (static_cast<int64_t>(b) * H + g * group) * D;
  const int rec = group * (D + 2);  // one split's record: acc, m, l
  float* mine = work + (row * n_split + split) * rec;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int h = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kMaxGroup + h]);
    float sum = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(wm[w * kMaxGroup + h] - mx);
      sum += wl[w * kMaxGroup + h] * e;
      a += wacc[(w * kMaxGroup + h) * D + d] * e;
    }
    if (n_split == 1) {
      ob[h * D + d] = __float2bfloat16_rn(a / fmaxf(sum, 1e-30f));
    } else {
      mine[h * D + d] = a;
      if (d == 0) {
        mine[group * D + h] = mx;
        mine[group * D + group + h] = sum;
      }
    }
  }
  if (n_split == 1) return;

  // the last block of this row to arrive merges the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(&counters[row], 1) == n_split - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* recs = work + row * n_split * rec;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int h = i / D;
    const int d = i % D;
    float mx = kNegInf;
    for (int s = 0; s < n_split; ++s) {
      mx = fmaxf(mx, __ldcg(&recs[s * rec + group * D + h]));
    }
    float sum = 0.0f, a = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const float* r = recs + s * rec;
      const float e = expf(__ldcg(&r[group * D + h]) - mx);
      sum += __ldcg(&r[group * D + group + h]) * e;
      a += __ldcg(&r[h * D + d]) * e;
    }
    ob[h * D + d] = __float2bfloat16_rn(a / fmaxf(sum, 1e-30f));
  }
  if (threadIdx.x == 0) counters[row] = 0;
}

template <typename KV, bool kScaled, int DPL>
int launch(const void* q, const void* k, const void* ks, const void* v,
           const void* vs, const void* lengths, void* out, void* work,
           void* counters, int B, int H, int G, int S, int chunk,
           float scale, cudaStream_t stream) {
  constexpr int D = 32 * DPL;
  const size_t stage = 2 * static_cast<size_t>(chunk) * D * sizeof(KV) +
                       (kScaled ? 2 * static_cast<size_t>(chunk) * 4 : 0);
  const size_t merge =
      sizeof(float) * (2 * kWarps * kMaxGroup + kWarps * kMaxGroup * D);
  const size_t smem = stage > merge ? stage : merge;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + chunk - 1) / chunk, G, B);
  dense_decode<KV, kScaled, DPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const float*>(ks), static_cast<const KV*>(v),
      static_cast<const float*>(vs), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(work),
      static_cast<int*>(counters), H, G, S, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, bool kScaled>
int launch_d(int D, const void* q, const void* k, const void* ks,
             const void* v, const void* vs, const void* lengths, void* out,
             void* work, void* counters, int B, int H, int G, int S,
             int chunk, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<KV, kScaled, 1>(q, k, ks, v, vs, lengths, out, work,
                                    counters, B, H, G, S, chunk, scale,
                                    stream);
    case 64:
      return launch<KV, kScaled, 2>(q, k, ks, v, vs, lengths, out, work,
                                    counters, B, H, G, S, chunk, scale,
                                    stream);
    case 96:
      return launch<KV, kScaled, 3>(q, k, ks, v, vs, lengths, out, work,
                                    counters, B, H, G, S, chunk, scale,
                                    stream);
    case 128:
      return launch<KV, kScaled, 4>(q, k, ks, v, vs, lengths, out, work,
                                    counters, B, H, G, S, chunk, scale,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q bf16 [B, H, D]; k/v [B, G, S, D] int8 (quantized != 0, with ks/vs f32
// [B, G, S]) or bf16; lengths int32 [B]; out bf16 [B, H, D]; work f32
// [B * G * ceil(S / chunk) * (H / G) * (D + 2)]; counters int32 [B * G],
// zero on entry and on exit.  k and v 16-byte aligned.
int decode_attn(const void* q, const void* k, const void* ks, const void* v,
                const void* vs, const void* lengths, void* out, void* work,
                void* counters, int quantized, int B, int H, int G, int S,
                int D, int chunk, float scale, void* stream) {
  if (G <= 0 || H % G != 0 || H / G > kMaxGroup || chunk <= 0 || S <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return launch_d<int8_t, true>(D, q, k, ks, v, vs, lengths, out, work,
                                  counters, B, H, G, S, chunk, scale, st);
  }
  return launch_d<__nv_bfloat16, false>(D, q, k, ks, v, vs, lengths, out,
                                        work, counters, B, H, G, S, chunk,
                                        scale, st);
}

}  // extern "C"
