// Fused butterfly-sandwich forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sandwich_kernel` in src/repro/kernels/sandwich.py
// (entry `_sandwich_fwd_call`). Per row it computes the paper's dense-layer
// replacement
//
//     out = Bᵀ_out · scatter(scale_out · core · (scale_in · select(B_in x)))
//
// with the reference's precision points: the input butterfly in x's dtype
// (kept here as one float32 chain over T-rounded weights, rounded to T once
// at the end, which the port allows), then select, core and scatter in
// float32, the scattered values rounded to T, and the output butterfly in T
// (again one float32 chain, rounded once when stored).
//
// What bounds it on the H100: bytes. Per row it does ~3·(n1·log n1 +
// n2·log n2) float operations on n_in + n_out activations and a few MB of
// stage weights that every row shares, far below the ~20 operations per
// byte at which the card's float32 rate would be the limit. At decode the
// rows are few, so in practice the latency of the stage chain (one barrier
// per stage) dominates.
//
// What the design does about it:
// * Selection and scatter are index gathers (`idx_in`, `idx_out` as int32),
//   not the TPU's one-hot matmuls, and the (k2 x k1) core, at most a few
//   hundred FMAs, stays in the kernel.
// * Padding n_in -> n1 and slicing n2 -> n_out happen on load and store, so
//   the caller launches nothing else around the kernel.
// * The head's output row (n2 = 65536: 256 KB in float32) does not fit in
//   one block's shared memory. The row is split into tiles of kTile
//   elements, one block per (row, tile). Stages whose stride is below the
//   tile run in shared memory. The log2(n2 / kTile) stages whose stride
//   reaches across tiles act, for each offset l inside a tile, only on the
//   n2 / kTile elements {l + j·kTile}; each block computes those short
//   vectors in registers, straight from the k2 scattered values, and keeps
//   the entry of its own tile. This was chosen over staging the row in
//   global memory because it needs no pass over device memory and no
//   synchronisation between blocks. An offset that holds none of the k2
//   nonzeros yields a zero vector and is skipped; the in-tile stages still
//   run densely on the k2-sparse row, which is a speed lever left for later.
// * The input row (n1 <= kMaxN1) is held whole in shared memory; every
//   block of a row recomputes the cheap input side.
// * A ragged last block needs no care: one block owns one row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) sandwich_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ b_in,
    const float* __restrict__ core, const float* __restrict__ b_out,
    const int* __restrict__ idx_in, const int* __restrict__ idx_out,
    T* __restrict__ out, int n_in, int n1, int p1, int k1, int k2, int n2,
    int n_out, int tile, int log_tile, float scale_in, float scale_out) {
  extern __shared__ float row[];  // max(n1, tile) floats
  __shared__ float h1[kMaxK];
  __shared__ float zval[kMaxK];
  __shared__ int zidx[kMaxK];

  const int r = blockIdx.x / NT;  // row
  const int t = blockIdx.x % NT;  // output tile of that row
  const int tid = threadIdx.x;

  // 1. input row -> shared memory (float32), zero-padded to n1
  const T* xr = x + (size_t)r * n_in;
  for (int i = tid; i < n1; i += kThreads)
    row[i] = i < n_in ? to_f32<T>(xr[i]) : 0.f;
  __syncthreads();

  // 2. input butterfly B x, stage 0 first: pairs (i, i|st) update in place
  for (int s = 0; s < p1; ++s) {
    const int st = 1 << s;
    const float* a = b_in + (size_t)(2 * s) * n1;
    const float* b = a + n1;
    for (int q = tid; q < n1 / 2; q += kThreads) {
      const int i = ((q >> s) << (s + 1)) | (q & (st - 1));
      const int j = i | st;
      const float xi = row[i], xj = row[j];
      row[i] = rnd<T>(a[i]) * xi + rnd<T>(b[i]) * xj;
      row[j] = rnd<T>(a[j]) * xj + rnd<T>(b[j]) * xi;
    }
    __syncthreads();
  }

  // 3. select: exact gather of the T-rounded butterfly output, JL scale
  if (tid < k1) h1[tid] = rnd<T>(row[idx_in[tid]]) * scale_in;
  __syncthreads();

  // 4. core (k2 x k1) in float32; the scattered value is rounded to T
  if (tid < k2) {
    float acc = 0.f;
    for (int i = 0; i < k1; ++i) acc += core[tid * k1 + i] * h1[i];
    zval[tid] = rnd<T>(acc * scale_out);
    zidx[tid] = idx_out[tid];
  }
  __syncthreads();  // the input row is dead from here on

  // 5. cross-tile stages (stride >= tile), highest first, on the short
  //    vectors v[j] = z[l + j*tile]; keep the entry of tile t
  for (int l = tid; l < tile; l += kThreads) {
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
        // transposed stage: y[i] = a[i] x[i] + b[i^st] x[i^st]
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
  __syncthreads();

  // 6. in-tile stages, highest stride first (Bᵀ applies stages reversed)
  const int base = t << log_tile;
  for (int s = log_tile - 1; s >= 0; --s) {
    const int st = 1 << s;
    const float* a = b_out + (size_t)(2 * s) * n2 + base;
    const float* b = a + n2;
    for (int q = tid; q < tile / 2; q += kThreads) {
      const int i = ((q >> s) << (s + 1)) | (q & (st - 1));
      const int j = i | st;
      const float xi = row[i], xj = row[j];
      row[i] = rnd<T>(a[i]) * xi + rnd<T>(b[j]) * xj;
      row[j] = rnd<T>(a[j]) * xj + rnd<T>(b[i]) * xi;
    }
    __syncthreads();
  }

  // 7. store the tile's columns below n_out
  T* orow = out + (size_t)r * n_out;
  for (int i = tid; i < tile; i += kThreads) {
    const int g = base + i;
    if (g < n_out) orow[g] = from_f32<T>(row[i]);
  }
}

int log2_exact(int n) {
  int p = 0;
  while ((1 << p) < n) ++p;
  return (1 << p) == n ? p : -1;
}

template <typename T, int NT>
cudaError_t launch_nt(const void* x, const float* b_in, const float* core,
                      const float* b_out, const int* idx_in,
                      const int* idx_out, void* out, int rows, int n_in,
                      int n1, int p1, int k1, int k2, int n2, int n_out,
                      int tile, int log_tile, float scale_in, float scale_out,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(n1 > tile ? n1 : tile);
  sandwich_fwd_kernel<T, NT><<<rows * NT, kThreads, smem, stream>>>(
      static_cast<const T*>(x), b_in, core, b_out, idx_in, idx_out,
      static_cast<T*>(out), n_in, n1, p1, k1, k2, n2, n_out, tile, log_tile,
      scale_in, scale_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* b_in, const float* core,
                   const float* b_out, const int* idx_in, const int* idx_out,
                   void* out, int rows, int n_in, int n1, int k1, int k2,
                   int n2, int n_out, float scale_in, float scale_out,
                   cudaStream_t stream) {
  const int p1 = log2_exact(n1), p2 = log2_exact(n2);
  if (p1 < 1 || p2 < 1 || n1 > kMaxN1 || n2 > kTile * kMaxTiles ||
      k1 < 1 || k1 > kMaxK || k2 < 1 || k2 > kMaxK || n_in > n1 ||
      n_out > n2 || rows < 1)
    return cudaErrorInvalidValue;
  const int tile = n2 < kTile ? n2 : kTile;
  const int log_tile = log2_exact(tile);
#define SANDWICH_NT(NT)                                                      \
  case NT:                                                                   \
    return launch_nt<T, NT>(x, b_in, core, b_out, idx_in, idx_out, out, rows, \
                            n_in, n1, p1, k1, k2, n2, n_out, tile, log_tile,  \
                            scale_in, scale_out, stream);
  switch (n2 / tile) {
    SANDWICH_NT(1)
    SANDWICH_NT(2)
    SANDWICH_NT(4)
    SANDWICH_NT(8)
    SANDWICH_NT(16)
    SANDWICH_NT(32)
    SANDWICH_NT(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef SANDWICH_NT
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out); weights are float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sandwich_fwd(const void* x, const float* b_in,
                            const float* core, const float* b_out,
                            const int* idx_in, const int* idx_out, void* out,
                            int rows, int n_in, int n1, int k1, int k2,
                            int n2, int n_out, float scale_in,
                            float scale_out, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, b_in, core, b_out, idx_in, idx_out, out, rows,
                         n_in, n1, k1, k2, n2, n_out, scale_in, scale_out, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, b_in, core, b_out, idx_in, idx_out, out,
                                 rows, n_in, n1, k1, k2, n2, n_out, scale_in,
                                 scale_out, s);
  return cudaErrorInvalidValue;
}
