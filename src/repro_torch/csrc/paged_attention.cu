// Paged single-query decode attention for Hopper (sm_90a), split over pages.
//
// Replaces the TPU kernel `_decode_kernel` in
// src/repro/kernels/paged_attention.py (entry `_paged_decode_pallas`): one
// query per slot, grouped-query heads (head = kv·G + g), KV read through a
// per-slot page table from one pool of fixed-size pages, online softmax with
// m, l and acc in float32, positions kpos <= cur_pos only.
// kernels/paged_attention.py:paged_decode_split_plain is the plain twin of
// the split and its combine; paged_attend_ref is the oracle.
//
// What bounds it on the H100: bytes. Each slot reads its live K and V rows
// once (2 · (cur_pos+1) · KV · D elements) and does 4 · G · D operations per
// row read, about 3 per byte in bf16, two orders of magnitude below the
// tensor cores' balance point. A decode step has few slots, so what keeps
// the bytes from streaming is latency: one block walking a slot's pages in
// turn waits on each page's loads.
//
// What the design does about it (flash-decoding), two launches:
// * paged_split_kernel: one block per (slot, kv head, run of pages): runs of
//   `rows_per_split` positions (4 pages of 16), so a slot at position 511
//   spreads over 8 blocks per kv head. Blocks whose run starts past cur_pos
//   exit at once. A row of K or V is read by a group of lanes as 16-byte
//   vectors; each group loads four rows before it scores them, so many
//   loads are in flight. The G query heads sit in registers; a score is a
//   shuffle sum over the group's lanes. Each group keeps its own online
//   softmax (m, l, acc) over its rows, with no barrier per page; the groups
//   of a warp merge by shuffles, the four warps through shared memory in
//   warp order (one barrier), and the block writes its partial state.
// * paged_combine_kernel: one block per (slot, kv head) merges the live
//   runs' partial states in run order and rounds the output once.
// Every sum runs in a fixed order: repeats are bit-identical.
//
// Invariants: the block reads its own page-table row and cur_pos (the TPU
// kernel got them through scalar prefetch); pages wholly past cur_pos are
// never loaded, and inside the last page only rows kpos <= cur_pos are
// loaded and scored, so NaN or stale data there cannot reach the softmax.
// Physical page 0 (the trash page) is read only where the caller's page
// table maps a live position to it, which the pool never does for an
// active slot. A slot with cur_pos < 0 gets zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sandwich_common.cuh"  // to_f32 / from_f32

namespace {

using sandwich::from_f32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kAhead = 4;  // rows a lane group loads before scoring them
constexpr float kNegInf = -1e30f;

// the 16 bytes of one vector as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// Partial state of run `split` of (slot, kv head) bkv: m and l (G each),
// then acc (G, D), unnormalised, in one float32 workspace of nsplit runs.
__device__ __forceinline__ size_t part_off(int bkv, int split, int nsplit,
                                           int G, int D) {
  return ((size_t)bkv * nsplit + split) * G * (D + 2);
}

// A lane group of 2^lpr_log2 lanes holds a row: vector i (< NV) of 16 bytes
// at columns (i · lanes + lane) · E. GMAX bounds G.
template <typename T, int NV, int GMAX>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ page_table,
    const int* __restrict__ cur_pos, float* __restrict__ part, int KV, int G,
    int D, int ps, int P, int rows_per_split, int lpr_log2, float scale) {
  constexpr int E = 16 / sizeof(T);
  constexpr int W = NV * E;  // elements of a row a lane holds
  const int bkv = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = bkv / KV, kv = bkv - b * KV;
  const int cur = min(cur_pos[b], P * ps - 1);
  const int r0 = split * rows_per_split;
  if (cur < 0 || r0 > cur) return;  // the whole block: a run past cur_pos
  const int r1 = min(r0 + rows_per_split, cur + 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lanes = 1 << lpr_log2, gpw = 32 >> lpr_log2;
  const int grp = lane >> lpr_log2, lig = lane & (lanes - 1);

  float qr[GMAX][W], m[GMAX], l[GMAX], acc[GMAX][W];
  const T* qb = q + (size_t)bkv * G * D;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * lanes + lig) * E;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (g < G && c < D) u = *reinterpret_cast<const uint4*>(qb + g * D + c);
      unpack(u, &qr[g][i * E], T());
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][i * E + e] = 0.f;
    }
  }

  // the warp's chunks of gpw · kAhead rows: group grp takes rows
  // cs + grp + gpw · u, neighbouring groups neighbouring rows
  for (int cs = r0 + warp * gpw * kAhead; cs < r1;
       cs += kWarps * gpw * kAhead) {
    uint4 kr[kAhead][NV], vr[kAhead][NV];
    bool ok[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int r = cs + grp + gpw * u;
      ok[u] = r < r1;
      size_t off = 0;
      if (ok[u]) {
        const int page = page_table[(size_t)b * P + r / ps];
        off = (((size_t)page * ps + r % ps) * KV + kv) * D;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * lanes + lig) * E;
        kr[u][i] = vr[u][i] = make_uint4(0, 0, 0, 0);
        if (ok[u] && c < D) {
          kr[u][i] = *reinterpret_cast<const uint4*>(k_pool + off + c);
          vr[u][i] = *reinterpret_cast<const uint4*>(v_pool + off + c);
        }
      }
    }
    float sc[kAhead][GMAX];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      float kf[W];
#pragma unroll
      for (int i = 0; i < NV; ++i) unpack(kr[u][i], &kf[i * E], T());
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        sc[u][g] = kNegInf;
        if (g >= G) continue;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) s = fmaf(qr[g][e], kf[e], s);
        for (int o = lanes >> 1; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if (ok[u]) sc[u][g] = s * scale;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) mx = fmaxf(mx, sc[u][g]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < W; ++e) acc[g][e] *= corr;
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const float p = ok[u] ? expf(sc[u][g] - mx) : 0.f;
        l[g] += p;
        float vf[W];
#pragma unroll
        for (int i = 0; i < NV; ++i) unpack(vr[u][i], &vf[i * E], T());
#pragma unroll
        for (int e = 0; e < W; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // merge the warp's groups: a butterfly of shuffles over the group bits
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < W; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mn;
    }
  }

  // the warps' states through shared memory, merged in warp order
  extern __shared__ float sm[];  // m, l (kWarps · G each), acc (kWarps, G, D)
  float* sm_m = sm;
  float* sm_l = sm_m + kWarps * G;
  float* sm_acc = sm_l + kWarps * G;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      if (lig == 0) {
        sm_m[warp * G + g] = m[g];
        sm_l[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = (i * lanes + lig) * E;
        if (c < D)
#pragma unroll
          for (int e = 0; e < E; ++e)
            sm_acc[(warp * G + g) * D + c + e] = acc[g][i * E + e];
      }
    }
  }
  __syncthreads();
  float* out = part + part_off(bkv, split, nsplit, G, D);
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float mn = kNegInf;
    for (int w = 0; w < kWarps; ++w) mn = fmaxf(mn, sm_m[w * G + g]);
    float ls = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * G + g] - mn);
      ls += sm_l[w * G + g] * c;
      a += sm_acc[w * G * D + idx] * c;
    }
    out[2 * G + idx] = a;
    if (idx % D == 0) {
      out[g] = mn;
      out[G + g] = ls;
    }
  }
}

// One block per (slot, kv head): the live runs' partial states merged in
// run order, the output rounded once. The runs' m and l go through shared
// memory first, all loaded at once, and become weights exp(m_r − max m);
// then each thread sums its elements' acc over the runs, loads batched.
template <typename T>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ cur_pos,
    T* __restrict__ out, int KV, int G, int D, int ps, int P,
    int rows_per_split, int nsplit) {
  extern __shared__ float sw[];  // weights (live, G), l (live, G), sums (G)
  const int bkv = blockIdx.x;
  const int cur = min(cur_pos[bkv / KV], P * ps - 1);
  const int live = cur < 0 ? 0 : cur / rows_per_split + 1;
  float* sl = sw + live * G;
  float* sum = sl + live * G;
  for (int i = threadIdx.x; i < live * G; i += kThreads) {
    const float* p = part + part_off(bkv, i / G, nsplit, G, D);
    sw[i] = p[i % G];
    sl[i] = p[G + i % G];
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float mn = kNegInf;
    for (int r = 0; r < live; ++r) mn = fmaxf(mn, sw[r * G + g]);
    float ls = 0.f;
    for (int r = 0; r < live; ++r) {
      const float c = expf(sw[r * G + g] - mn);
      sw[r * G + g] = c;
      ls += sl[r * G + g] * c;
    }
    sum[g] = fmaxf(ls, 1e-30f);
  }
  __syncthreads();
  const float* acc = part + part_off(bkv, 0, nsplit, G, D) + 2 * G;
  const size_t run = (size_t)G * (D + 2);  // one run's partial state
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float a = 0.f;
#pragma unroll 8
    for (int r = 0; r < live; ++r) a += acc[r * run + idx] * sw[r * G + g];
    out[(size_t)bkv * G * D + idx] = from_f32<T>(a / sum[g]);
  }
}

template <typename T, int NV, int GMAX>
cudaError_t launch_split(const void* q, const void* k_pool,
                         const void* v_pool, const int* page_table,
                         const int* cur_pos, float* part, int BKV, int nsplit,
                         int KV, int G, int D, int ps, int P,
                         int rows_per_split, int lpr_log2, float scale,
                         cudaStream_t stream) {
  auto kernel = paged_split_kernel<T, NV, GMAX>;
  const size_t smem = sizeof(float) * (size_t)kWarps * G * (D + 2);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BKV, nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), page_table, cur_pos, part, KV, G, D, ps,
      P, rows_per_split, lpr_log2, scale);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t split_g(const void* q, const void* k_pool, const void* v_pool,
                    const int* page_table, const int* cur_pos, float* part,
                    int BKV, int nsplit, int KV, int G, int D, int ps, int P,
                    int rows_per_split, int lpr_log2, float scale,
                    cudaStream_t s) {
  if (G <= 4)
    return launch_split<T, NV, 4>(q, k_pool, v_pool, page_table, cur_pos,
                                  part, BKV, nsplit, KV, G, D, ps, P,
                                  rows_per_split, lpr_log2, scale, s);
  if (G <= 8)
    return launch_split<T, NV, 8>(q, k_pool, v_pool, page_table, cur_pos,
                                  part, BKV, nsplit, KV, G, D, ps, P,
                                  rows_per_split, lpr_log2, scale, s);
  return launch_split<T, NV, 16>(q, k_pool, v_pool, page_table, cur_pos,
                                 part, BKV, nsplit, KV, G, D, ps, P,
                                 rows_per_split, lpr_log2, scale, s);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* page_table, const int* cur_pos, void* out,
                   float* part, int B, int KV, int G, int D, int ps, int P,
                   int pages_per_split, float scale, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  if (B < 1 || KV < 1 || G < 1 || G > 16 || D < 8 || D > 256 || D % 8 ||
      ps < 1 || P < 1 || pages_per_split < 1)
    return cudaErrorInvalidValue;
  const int nvec = D / E;  // 16-byte vectors a row
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < nvec && lpr_log2 < 5) ++lpr_log2;
  const int nv = (nvec + (1 << lpr_log2) - 1) >> lpr_log2;
  const int nsplit = (P + pages_per_split - 1) / pages_per_split;
  const int rows = pages_per_split * ps, BKV = B * KV;
  cudaError_t err;
  if constexpr (E == 4) {  // float32 rows past 128 take two vectors a lane
    err = nv == 1 ? split_g<T, 1>(q, k_pool, v_pool, page_table, cur_pos,
                                  part, BKV, nsplit, KV, G, D, ps, P, rows,
                                  lpr_log2, scale, stream)
                  : split_g<T, 2>(q, k_pool, v_pool, page_table, cur_pos,
                                  part, BKV, nsplit, KV, G, D, ps, P, rows,
                                  lpr_log2, scale, stream);
  } else {  // bfloat16: one vector a lane up to D = 256
    err = split_g<T, 1>(q, k_pool, v_pool, page_table, cur_pos, part, BKV,
                        nsplit, KV, G, D, ps, P, rows, lpr_log2, scale,
                        stream);
  }
  if (err != cudaSuccess) return err;
  auto combine = paged_combine_kernel<T>;
  const size_t smem = sizeof(float) * (size_t)G * (2 * nsplit + 1);
  err = cudaFuncSetAttribute(
      combine, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  combine<<<BKV, kThreads, smem, stream>>>(
      part, cur_pos, static_cast<T*>(out), KV, G, D, ps, P, rows, nsplit);
  return cudaGetLastError();
}

}  // namespace

// q (B, KV, G, D); pools (N, ps, KV, D); page_table (B, P) int32;
// cur_pos (B,) int32; out (B, KV, G, D); all contiguous, q and the pools
// 16-byte aligned. part: float32 workspace of B · KV · nsplit · G · (D + 2)
// elements, nsplit = ceil(P / pages_per_split). dtype: 0 = float32, 1 =
// bfloat16. D: 8..256, a multiple of 8; G <= 16. Returns the cudaError_t
// of the two launches (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const int* page_table,
                            const int* cur_pos, void* out, float* part, int B,
                            int KV, int G, int D, int ps, int P,
                            int pages_per_split, float scale, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, page_table, cur_pos, out, part,
                         B, KV, G, D, ps, P, pages_per_split, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, page_table, cur_pos, out,
                                 part, B, KV, G, D, ps, P, pages_per_split,
                                 scale, s);
  return cudaErrorInvalidValue;
}
