// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` in
// src/repro/kernels/paged_attention.py (entry `_paged_decode_pallas`): one
// query per slot, grouped-query heads (head = kv·G + g), KV read through a
// per-slot page table from one pool of fixed-size pages, online softmax with
// m, l and acc in float32, positions kpos <= cur_pos only.
//
// What bounds it on the H100: bytes. Each slot reads its live K and V rows
// once (2 · (cur_pos+1) · KV · D elements) and does 4 · G · D operations per
// row read, about 3 per byte in bf16, two orders of magnitude below the
// tensor cores' balance point. At decode the slots are few, so the latency
// of the page loop dominates in practice.
//
// What the design does about it:
// * One block per (slot, kv head); the G query heads of the group share
//   every K/V row the block loads, so each live row is read from device
//   memory once.
// * The block reads its own page-table row and cur_pos (the TPU kernel got
//   them through scalar prefetch) and loops over pages 0 .. cur_pos / ps
//   only: pages wholly past cur_pos are never loaded, so NaN or stale data
//   there cannot reach the softmax. Inside the last page only rows
//   kpos <= cur_pos are loaded and scored.
// * Physical page 0 (the trash page) is read only where the caller's page
//   table maps a live position to it, which the pool never does for an
//   active slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kMaxG = 16;
constexpr int kMaxPage = 64;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ cur_pos, T* __restrict__ out, int KV, int G,
    int D, int ps, int P, float scale) {
  // shared: q (G*D) | k page (ps*D) | v page (ps*D) | acc (G*D)
  extern __shared__ float sm[];
  float* sq = sm;
  float* sk = sq + G * D;
  float* sv = sk + ps * D;
  float* acc = sv + ps * D;
  __shared__ float sp[kMaxG * kMaxPage];  // scores, then probabilities
  __shared__ float m_run[kMaxG], l_run[kMaxG], corr[kMaxG];

  const int b = blockIdx.x / KV;
  const int kv = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int cur = cur_pos[b];
  int last_page = cur / ps;
  if (last_page > P - 1) last_page = P - 1;

  const T* qb = q + ((size_t)b * KV + kv) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    sq[i] = to_f32<T>(qb[i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  for (int p = 0; p <= last_page; ++p) {
    const int page = page_table[(size_t)b * P + p];
    int n_valid = cur - p * ps + 1;
    if (n_valid > ps) n_valid = ps;
    // live rows of this page for kv head `kv`
    for (int i = tid; i < n_valid * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const size_t off = (((size_t)page * ps + t) * KV + kv) * D + d;
      sk[i] = to_f32<T>(k_pool[off]);
      sv[i] = to_f32<T>(v_pool[off]);
    }
    __syncthreads();
    for (int i = tid; i < G * n_valid; i += kThreads) {
      const int g = i / n_valid, t = i % n_valid;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += sq[g * D + d] * sk[t * D + d];
      sp[g * ps + t] = s * scale;
    }
    __syncthreads();
    if (tid < G) {
      const int g = tid;
      float mx = m_run[g];
      for (int t = 0; t < n_valid; ++t) mx = fmaxf(mx, sp[g * ps + t]);
      float sum = 0.f;
      for (int t = 0; t < n_valid; ++t) {
        const float e = expf(sp[g * ps + t] - mx);
        sp[g * ps + t] = e;
        sum += e;
      }
      const float c = expf(m_run[g] - mx);
      corr[g] = c;
      l_run[g] = l_run[g] * c + sum;
      m_run[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float a = acc[i] * corr[g];
      for (int t = 0; t < n_valid; ++t) a += sp[g * ps + t] * sv[t * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * KV + kv) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = fmaxf(l_run[i / D], 1e-30f);
    ob[i] = from_f32<T>(acc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* cur_pos, void* out,
                   int B, int KV, int G, int D, int ps, int P, float scale,
                   cudaStream_t stream) {
  if (B < 1 || KV < 1 || G < 1 || G > kMaxG || D < 1 || ps < 1 ||
      ps > kMaxPage || P < 1)
    return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)(2 * G * D + 2 * ps * D);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  paged_decode_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), page_table, cur_pos,
      static_cast<T*>(out), KV, G, D, ps, P, scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, KV, G, D); pools (N, ps, KV, D); page_table (B, P) int32;
// cur_pos (B,) int32; out (B, KV, G, D). dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const int* page_table,
                            const int* cur_pos, void* out, int B, int KV,
                            int G, int D, int ps, int P, float scale,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, cur_pos, out, B, KV,
                         G, D, ps, P, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, cur_pos, out,
                                 B, KV, G, D, ps, P, scale, s);
  return cudaErrorInvalidValue;
}
