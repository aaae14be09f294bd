// Device code shared by the sandwich kernels (sandwich.cu, sandwich_bwd.cu)
// and the butterfly kernels (butterfly.cu, butterfly_bwd.cu): dtype
// conversions, the reference's rounding points, 16-byte asynchronous copies,
// the butterfly stage and its VJP in both directions, and the
// segmented-checkpoint VJP of a stage chain.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sandwich {

constexpr int kThreads = 256;
constexpr int kTile = 4096;    // output-butterfly elements per block
constexpr int kMaxN1 = 32768;  // input butterfly width (mistral-large's down)
constexpr int kMaxK = 64;      // core dims k1, k2
constexpr int kMaxTiles = 64;  // n2 <= kTile * kMaxTiles

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

// round a float32 value to T and back: the reference's cast points
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; an invalid source zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) · b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Pair q of a stage with stride 2^s: elements (i, i | 2^s).
__device__ __forceinline__ int pair_lo(int q, int s) {
  return ((q >> s) << (s + 1)) | (q & ((1 << s) - 1));
}

// One stage over n elements, src -> dst (may alias), weights a/b already
// offset to the first element, rounded to T:
//   forward    y[i] = a[i] x[i] + b[i] x[i^st]
//   transposed y[i] = a[i] x[i] + b[i^st] x[i^st]
// Ends with a barrier.
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      const float* a, const float* b, int n,
                                      int s) {
  const int st = 1 << s;
  for (int q = threadIdx.x; q < n / 2; q += kThreads) {
    const int i = pair_lo(q, s);
    const int j = i | st;
    const float xi = src[i], xj = src[j];
    if (kTransposed) {
      dst[i] = rnd<T>(a[i]) * xi + rnd<T>(b[j]) * xj;
      dst[j] = rnd<T>(a[j]) * xj + rnd<T>(b[i]) * xi;
    } else {
      dst[i] = rnd<T>(a[i]) * xi + rnd<T>(b[i]) * xj;
      dst[j] = rnd<T>(a[j]) * xj + rnd<T>(b[j]) * xi;
    }
  }
  __syncthreads();
}

// VJP of one stage: t the stage input, g the cotangent of its output,
// replaced by the cotangent of its input. pda/pdb: the stage's partial
// da/db rows, indexed like t. Each element of pda/pdb is only ever touched
// by the same thread (the pair -> thread map depends on s alone), so the
// partials need no barrier across rows. Ends with a barrier.
template <typename T, bool kTransposed>
__device__ __forceinline__ void stage_vjp(float* g, const float* t,
                                          const float* a, const float* b,
                                          float* pda, float* pdb, int n,
                                          int s) {
  const int st = 1 << s;
  for (int q = threadIdx.x; q < n / 2; q += kThreads) {
    const int i = pair_lo(q, s);
    const int j = i | st;
    const float gi = g[i], gj = g[j], xi = t[i], xj = t[j];
    pda[i] += gi * xi;
    pda[j] += gj * xj;
    if (kTransposed) {
      pdb[i] += gj * xi;
      pdb[j] += gi * xj;
      g[i] = rnd<T>(a[i]) * gi + rnd<T>(b[i]) * gj;
      g[j] = rnd<T>(a[j]) * gj + rnd<T>(b[j]) * gi;
    } else {
      pdb[i] += gi * xj;
      pdb[j] += gj * xi;
      g[i] = rnd<T>(a[i]) * gi + rnd<T>(b[j]) * gj;
      g[j] = rnd<T>(a[j]) * gj + rnd<T>(b[i]) * gi;
    }
  }
  __syncthreads();
}

// Segmented VJP of a chain of p stages over n elements
// (`_butterfly_bwd_block`'s schedule). Chain position j applies stage
// s(j) = kTransposed ? p-1-j : j, whose weights start at w + 2·s·ldw (a) and
// w + (2·s+1)·ldw (b); its partial rows at part + 2·s·n (da) and
// part + (2·s+1)·n (db).
// On entry `work` holds the chain input and g the cotangent of the chain
// output; on exit g holds the cotangent of the chain input. The forward
// sweep checkpoints the input of every segment; with `to_end` it runs the
// last segment too and hands the chain output to `on_out` (which may fill
// in g) before the reverse sweep, else it stops at the last checkpoint and
// `on_out` is not called. ck: ceil(p/seg) buffers of n; acts:
// max(seg-1, 1) buffers of n, the first of which is `work`. Any buffer may
// lie in shared or device memory. Returns the number of stage applications
// (forward, recomputed and dual) it performed.
template <typename T, bool kTransposed, typename OnOut>
__device__ int chain_vjp(float* work, float* g, float* ck, int n, int p,
                         int seg, const float* w, size_t ldw, float* part,
                         bool to_end, OnOut on_out) {
  auto s_of = [&](int j) { return kTransposed ? p - 1 - j : j; };
  const int nck = (p + seg - 1) / seg;
  int applied = 0;
  // forward sweep: checkpoint the input of every segment
  for (int ci = 0; ci < nck; ++ci) {
    float* c = ck + (size_t)ci * n;
    for (int i = threadIdx.x; i < n; i += kThreads) c[i] = work[i];
    __syncthreads();
    if (ci == nck - 1 && !to_end) break;
    const int j1 = min((ci + 1) * seg, p);
    for (int j = ci * seg; j < j1; ++j, ++applied) {
      const float* a = w + (size_t)(2 * s_of(j)) * ldw;
      stage<T, kTransposed>(work, work, a, a + ldw, n, s_of(j));
    }
  }
  if (to_end) on_out(work);
  // reverse sweep: recompute each segment's stage inputs once
  for (int ci = nck - 1; ci >= 0; --ci) {
    const int j0 = ci * seg, j1 = min(j0 + seg, p);
    // act(j) = input of chain position j: ck[ci] for j0, work + (j-j0-1)·n
    // after it
    auto act = [&](int j) -> float* {
      return j == j0 ? ck + (size_t)ci * n : work + (size_t)(j - j0 - 1) * n;
    };
    for (int j = j0; j < j1 - 1; ++j, ++applied) {
      const float* a = w + (size_t)(2 * s_of(j)) * ldw;
      stage<T, kTransposed>(act(j + 1), act(j), a, a + ldw, n, s_of(j));
    }
    for (int j = j1 - 1; j >= j0; --j, ++applied) {
      const int s = s_of(j);
      const float* a = w + (size_t)(2 * s) * ldw;
      float* pda = part + (size_t)(2 * s) * n;
      stage_vjp<T, kTransposed>(g, act(j), a, a + ldw, pda, pda + n, n, s);
    }
  }
  return applied;
}

inline int log2_exact(int n) {
  int p = 0;
  while ((1 << p) < n) ++p;
  return (1 << p) == n ? p : -1;
}

}  // namespace sandwich
