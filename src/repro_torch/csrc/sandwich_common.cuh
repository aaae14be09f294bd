// Device code shared by the sandwich forward (sandwich.cu) and backward
// (sandwich_bwd.cu) kernels: dtype conversions, the reference's rounding
// points, the butterfly stage in both directions, and the cross-tile part of
// the output butterfly for rows wider than one tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sandwich {

constexpr int kThreads = 256;
constexpr int kTile = 4096;    // output-butterfly elements per block
constexpr int kMaxN1 = 8192;   // input butterfly held whole in shared memory
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

// Cross-tile stages of the transposed output butterfly (strides >= tile),
// highest first, for the row whose k2 nonzeros are (zidx[m], zval[m]): for
// every offset l of the tile the stages act on the short vector
// v[j] = z[l + j*tile]; row[l] receives the entry of tile t. Offsets that
// hold none of the nonzeros give 0. No barrier at the end.
template <typename T, int NT>
__device__ __forceinline__ void cross_tile_row(float* row, const float* zval,
                                               const int* zidx, int k2,
                                               const float* b_out, int n2,
                                               int tile, int log_tile,
                                               int t) {
  for (int l = threadIdx.x; l < tile; l += kThreads) {
    float v[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) v[j] = 0.f;
    bool any = false;
    for (int m = 0; m < k2; ++m) {
      const int g = zidx[m];
      if ((g & (tile - 1)) == l) {
        const int jj = g >> log_tile;
        any = true;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j == jj) v[j] = zval[m];
      }
    }
    if (!any) {
      row[l] = 0.f;
      continue;
    }
#pragma unroll
    for (int c = NT / 2; c >= 1; c >>= 1) {
      const int s = log_tile + (31 - __clz(c));
      const float* a = b_out + (size_t)(2 * s) * n2;
      const float* b = a + n2;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j & c) continue;
        const int gi = (j << log_tile) | l;
        const int gj = ((j | c) << log_tile) | l;
        const float vi = v[j], vj = v[j | c];
        v[j] = rnd<T>(a[gi]) * vi + rnd<T>(b[gj]) * vj;
        v[j | c] = rnd<T>(a[gj]) * vj + rnd<T>(b[gi]) * vi;
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j == t) mine = v[j];
    row[l] = mine;
  }
}

inline int log2_exact(int n) {
  int p = 0;
  while ((1 << p) < n) ++p;
  return (1 << p) == n ? p : -1;
}

}  // namespace sandwich
