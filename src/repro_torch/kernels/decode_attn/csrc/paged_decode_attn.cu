// Paged flash-decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas kernels of src/repro/kernels/decode_attn/paged.py:
//   paged_decode_attn         (_paged_kernel + _flash_step): GQA decode that
//                             walks a block table of bf16, f32 or int8 pages
//   paged_decode_attn_tiered  (_tiered_kernel): the same step over an
//                             ENCODED table (>0 hot bf16 slot, <0 warm int8
//                             slot -e dequantized right after the load,
//                             0 the trash slot)
//
// What bounds it: bytes.  One decode query per (lane, head) does two
// multiply-adds per KV element it reads, far below the card's ~295
// operations per byte, so the kernel is memory-bound.  The design answers
// that only by reading each needed byte once: the block table is walked
// from the first to the last page that the length (and window) leaves
// valid, every other page is skipped instead of loaded and masked, and a
// warm page is read as int8 plus scales and dequantized in shared memory,
// never materialized as bf16 in device memory.  The tiered kernel branches
// on the sign of the entry and loads only the tile it needs (the TPU kernel
// copies both candidate tiles and selects).
//
// Layout: one block per (KV head g, lane b), 128 threads, looping over the
// lane's pages; the query group (H / G heads) shares every loaded tile.  A
// simple, correct first form: at B*G blocks it fills few of the 132 SMs.
// Splitting the page axis across blocks (flash-decoding), cp.async/TMA
// pipelining and tensor cores are later work.
//
// Numerics follow the reference step exactly: f32 accumulation, logits
// scaled by D^-0.5 AFTER the dot, positions >= len (and < len - window)
// masked to -1e30, invalid V rows SELECTED to 0 (trash pages may hold NaN),
// denominator max(l, 1e-30), output in q's dtype.  Table entries outside
// the pool are clamped into it, as a JAX gather clamps.
//
// Each entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;
constexpr int kMaxDPerThread = 2;  // head dim <= kThreads * kMaxDPerThread

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ int clamp_slot(int slot, int n) {
  return slot < 0 ? 0 : (slot >= n ? n - 1 : slot);
}

// Tile loaders: fill sk/sv[ps, D] (f32) with page s of lane b, head g.
// Rows at invalid positions are selected to 0 in V (K needs no select:
// its logits are replaced by -1e30).

// A pool of T (bf16 / f32), or int8 with per-token f32 scales.
template <typename T, bool kScaled>
struct PoolLoader {
  const T* k;
  const T* v;
  const float* ks;
  const float* vs;
  int n_slots;

  __device__ void load(int entry, int g, int G, int ps, int D, int pos0,
                       int lo, int hi, float* sk, float* sv) const {
    const int slot = clamp_slot(entry, n_slots);
    const int64_t row0 = (static_cast<int64_t>(slot) * G + g) * ps;
    for (int i = threadIdx.x; i < ps * D; i += kThreads) {
      const int t = i / D;
      const int64_t off = row0 * D + i;
      float kx = to_f32(k[off]);
      float vx = to_f32(v[off]);
      if (kScaled) {
        kx *= ks[row0 + t];
        vx *= vs[row0 + t];
      }
      const int pos = pos0 + t;
      sk[i] = kx;
      sv[i] = (pos >= lo && pos < hi) ? vx : 0.0f;
    }
  }
};

// The encoded hot/warm table: branch on the sign, load only that tile.
struct TieredLoader {
  PoolLoader<__nv_bfloat16, false> hot;
  PoolLoader<int8_t, true> warm;

  __device__ void load(int entry, int g, int G, int ps, int D, int pos0,
                       int lo, int hi, float* sk, float* sv) const {
    if (entry < 0) {
      warm.load(-entry, g, G, ps, D, pos0, lo, hi, sk, sv);
    } else {
      hot.load(entry, g, G, ps, D, pos0, lo, hi, sk, sv);
    }
  }
};

// One block per (g, b).  Shared memory (f32): q[group, D], k[ps, D],
// v[ps, D], p[group, ps], m/l/alpha[group].
template <typename QT, typename Loader>
__global__ void __launch_bounds__(kThreads)
paged_flash_decode(const QT* __restrict__ q, Loader loader,
                   const int* __restrict__ bt, const int* __restrict__ lengths,
                   QT* __restrict__ out, int H, int G, int ps, int D, int np,
                   int window, float scale) {
  extern __shared__ float smem[];
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int group = H / G;
  float* sq = smem;
  float* sk = sq + group * D;
  float* sv = sk + ps * D;
  float* sp = sv + ps * D;
  float* sm = sp + group * ps;
  float* sl = sm + group;
  float* salpha = sl + group;

  const int len = lengths[b];
  const int lo = window > 0 ? len - window : 0;  // first valid position
  const int hi = len;                            // one past the last
  const QT* qb = q + (static_cast<int64_t>(b) * H + g * group) * D;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    sq[i] = to_f32(qb[i]);
  }
  if (threadIdx.x < group) {
    sm[threadIdx.x] = kNegInf;
    sl[threadIdx.x] = 0.0f;
  }
  float acc[kMaxGroup][kMaxDPerThread];
#pragma unroll
  for (int h = 0; h < kMaxGroup; ++h) {
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) acc[h][j] = 0.0f;
  }

  // pages holding at least one valid position; the rest would be masked
  // out entirely (a fully masked page leaves m, l and acc unchanged)
  const int s_begin = lo > 0 ? lo / ps : 0;
  const int s_end = min(np, (hi + ps - 1) / ps);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int s = s_begin; s < s_end; ++s) {
    const int pos0 = s * ps;
    __syncthreads();  // previous page's tiles fully consumed; q/m/l ready
    loader.load(bt[static_cast<int64_t>(b) * np + s], g, G, ps, D, pos0, lo,
                hi, sk, sv);
    __syncthreads();

    // logits[h, t] = (q_h . k_t) * scale, one warp per (h, t) pair
    for (int j = warp; j < group * ps; j += kWarps) {
      const int h = j / ps;
      const int t = j % ps;
      float dot = 0.0f;
      for (int d = lane; d < D; d += 32) dot += sq[h * D + d] * sk[t * D + d];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      }
      if (lane == 0) {
        const int pos = pos0 + t;
        sp[j] = (pos >= lo && pos < hi) ? dot * scale : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax bookkeeping, one thread per query head
    if (threadIdx.x < group) {
      const int h = threadIdx.x;
      const float m_prev = sm[h];
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sp[h * ps + t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int t = 0; t < ps; ++t) {
        const int pos = pos0 + t;
        const float p =
            (pos >= lo && pos < hi) ? expf(sp[h * ps + t] - m_new) : 0.0f;
        sp[h * ps + t] = p;
        sum += p;
      }
      const float alpha = expf(m_prev - m_new);
      salpha[h] = alpha;
      sl[h] = sl[h] * alpha + sum;
      sm[h] = m_new;
    }
    __syncthreads();

    // acc[h, d] = acc * alpha_h + sum_t p[h, t] * v[t, d]
#pragma unroll
    for (int j = 0; j < kMaxDPerThread; ++j) {
      const int d = threadIdx.x + j * kThreads;
      if (d >= D) break;
#pragma unroll
      for (int h = 0; h < kMaxGroup; ++h) {
        if (h >= group) break;
        float a = acc[h][j] * salpha[h];
        for (int t = 0; t < ps; ++t) a += sp[h * ps + t] * sv[t * D + d];
        acc[h][j] = a;
      }
    }
  }
  __syncthreads();

  QT* ob = out + (static_cast<int64_t>(b) * H + g * group) * D;
#pragma unroll
  for (int j = 0; j < kMaxDPerThread; ++j) {
    const int d = threadIdx.x + j * kThreads;
    if (d >= D) break;
#pragma unroll
    for (int h = 0; h < kMaxGroup; ++h) {
      if (h >= group) break;
      store_out(&ob[h * D + d], acc[h][j] / fmaxf(sl[h], 1e-30f));
    }
  }
}

size_t smem_bytes(int group, int ps, int D) {
  return sizeof(float) *
         (static_cast<size_t>(group) * D + 2 * static_cast<size_t>(ps) * D +
          static_cast<size_t>(group) * ps + 3 * group);
}

template <typename QT, typename Loader>
void launch(const void* q, const Loader& loader, const void* bt,
            const void* lengths, void* out, int B, int H, int G, int ps,
            int D, int np, int window, float scale, cudaStream_t stream) {
  const dim3 grid(G, B);
  paged_flash_decode<QT, Loader>
      <<<grid, kThreads, smem_bytes(H / G, ps, D), stream>>>(
          static_cast<const QT*>(q), loader, static_cast<const int*>(bt),
          static_cast<const int*>(lengths), static_cast<QT*>(out), H, G, ps,
          D, np, window, scale);
}

template <typename Loader>
void launch_q(int q_dtype, const void* q, const Loader& loader,
              const void* bt, const void* lengths, void* out, int B, int H,
              int G, int ps, int D, int np, int window, float scale,
              cudaStream_t stream) {
  if (q_dtype == kBF16) {
    launch<__nv_bfloat16>(q, loader, bt, lengths, out, B, H, G, ps, D, np,
                          window, scale, stream);
  } else {
    launch<float>(q, loader, bt, lengths, out, B, H, G, ps, D, np, window,
                  scale, stream);
  }
}

// the kernel's limits: static shared memory budget and register tiles
bool shape_ok(int H, int G, int ps, int D) {
  return G > 0 && H % G == 0 && H / G <= kMaxGroup && ps > 0 && D > 0 &&
         D <= kThreads * kMaxDPerThread &&
         smem_bytes(H / G, ps, D) <= 48 * 1024;
}

}  // namespace

extern "C" {

// q [B, H, D] (q_dtype f32|bf16); k/v pools [P, G, ps, D] (kv_dtype
// f32|bf16|int8; ks/vs f32 [P, G, ps] read only for int8); bt int32
// [B, np] pool slots; lengths int32 [B]; out [B, H, D] in q's dtype.
int paged_decode_attn(const void* q, const void* k, const void* ks,
                      const void* v, const void* vs, const void* bt,
                      const void* lengths, void* out, int q_dtype,
                      int kv_dtype, int B, int H, int G, int P, int ps, int D,
                      int np, int window, float scale, void* stream) {
  if (!shape_ok(H, G, ps, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv_dtype == kBF16) {
    PoolLoader<__nv_bfloat16, false> ld{
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), nullptr, nullptr, P};
    launch_q(q_dtype, q, ld, bt, lengths, out, B, H, G, ps, D, np, window,
             scale, st);
  } else if (kv_dtype == kF32) {
    PoolLoader<float, false> ld{static_cast<const float*>(k),
                                static_cast<const float*>(v), nullptr,
                                nullptr, P};
    launch_q(q_dtype, q, ld, bt, lengths, out, B, H, G, ps, D, np, window,
             scale, st);
  } else {
    PoolLoader<int8_t, true> ld{
        static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs), P};
    launch_q(q_dtype, q, ld, bt, lengths, out, B, H, G, ps, D, np, window,
             scale, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// q [B, H, D]; hot kh/vh bf16 [Ph, G, ps, D]; warm k8/v8 int8 [Pw, G, ps, D]
// with ks/vs f32 [Pw, G, ps]; bt int32 [B, np] ENCODED (>0 hot, <0 warm,
// 0 trash); lengths int32 [B]; out [B, H, D] in q's dtype.
int paged_decode_attn_tiered(const void* q, const void* kh, const void* vh,
                             const void* k8, const void* ks, const void* v8,
                             const void* vs, const void* bt,
                             const void* lengths, void* out, int q_dtype,
                             int B, int H, int G, int Ph, int Pw, int ps,
                             int D, int np, int window, float scale,
                             void* stream) {
  if (!shape_ok(H, G, ps, D)) return static_cast<int>(cudaErrorInvalidValue);
  TieredLoader ld{
      {static_cast<const __nv_bfloat16*>(kh),
       static_cast<const __nv_bfloat16*>(vh), nullptr, nullptr, Ph},
      {static_cast<const int8_t*>(k8), static_cast<const int8_t*>(v8),
       static_cast<const float*>(ks), static_cast<const float*>(vs), Pw}};
  launch_q(q_dtype, q, ld, bt, lengths, out, B, H, G, ps, D, np, window,
           scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
