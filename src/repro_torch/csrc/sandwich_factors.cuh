// The truncated butterfly factors of the sandwich, shared by its forward
// (sandwich.cu) and backward (sandwich_bwd.cu): F_in = B_in[idx_in, :n_in]
// (k1 x n_in) and F_out = B_out[idx_out, :n_out] (k2 x n_out), rows of the
// butterflies (the transposed butterfly on one-hot rows) over the weights
// rounded to T, float32, zero-padded to (kp, ld): rows to a multiple of
// kFacPadK, columns to a multiple of kFacPadN. See sandwich.cu for the
// design.
#pragma once

#include "sandwich_common.cuh"

namespace sandwich {

constexpr int kFacTile = 2048;     // factor columns per block
constexpr int kFacThreads = 256;
constexpr int kMaxCross = 7;       // log2(kMaxTiles * kTile / kFacTile)
constexpr int kFacPadK = 16;       // factor rows padded to a multiple
constexpr int kFacPadN = 128;      // factor columns padded to a multiple

// Block b builds columns [t·tile, (t+1)·tile) ∩ [0, ld) of row m of F_in
// (b < kp1·tiles1) or of F_out. Rows m >= k and columns >= n_valid are
// stored as zeros. Where hl_in / hl_out is not null, the factor's bfloat16
// hi/lo pair (2, kp, ld) goes there too: hi = bf16(F), lo = bf16(F - hi).
template <typename T>
__global__ void __launch_bounds__(kFacThreads) sandwich_factors_kernel(
    const float* __restrict__ b_in, const float* __restrict__ b_out,
    const int* __restrict__ idx_in, const int* __restrict__ idx_out,
    float* __restrict__ f_in, float* __restrict__ f_out,
    __nv_bfloat16* __restrict__ hl_in, __nv_bfloat16* __restrict__ hl_out,
    int n1, int k1, int n_in, int kp1,
    int ld1, int tiles1, int n2, int k2, int n_out, int kp2, int ld2,
    int tiles2) {
  __shared__ float row[kFacTile];
  __shared__ float4 w4[kFacTile - 1];           // in-tile pair weights
  __shared__ float sv[2][kMaxTiles * kTile / kFacTile];

  // the row kernel may start now: it waits for this grid before it reads
  // the factors (programmatic dependent launch)
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int tid = threadIdx.x;
  int b = blockIdx.x;
  const bool is_in = b < kp1 * tiles1;
  if (!is_in) b -= kp1 * tiles1;
  const float* w = is_in ? b_in : b_out;
  const int* idx = is_in ? idx_in : idx_out;
  const int n = is_in ? n1 : n2, k = is_in ? k1 : k2;
  const int nv = is_in ? n_in : n_out, kp = is_in ? kp1 : kp2;
  const int ld = is_in ? ld1 : ld2, tiles = is_in ? tiles1 : tiles2;
  float* f = is_in ? f_in : f_out;
  __nv_bfloat16* hl = is_in ? hl_in : hl_out;
  const int m = b / tiles, t = b % tiles;

  const int tile = n < kFacTile ? n : kFacTile;
  const int log_tile = 31 - __clz(tile);
  const int nt = n / tile;                      // tiles of the butterfly
  const int col0 = t * tile;
  const bool active = m < k && col0 < n && col0 < nv;  // block-uniform

  if (active) {
    const int g = idx[m];
    const int l = g & (tile - 1);
    // weights of the in-tile pairs on the support, heap order: stage
    // s = log_tile-1-lg holds 2^lg pairs at e = 2^lg - 1 + q
    for (int e = tid; e < tile - 1; e += kFacThreads) {
      const int lg = 31 - __clz(e + 1);
      const int s = log_tile - 1 - lg;
      const int q = e + 1 - (1 << lg);
      const int i = (q << (s + 1)) | (l & ((1 << s) - 1));
      const int j = i | (1 << s);
      const float* a = w + (size_t)(2 * s) * n + col0;
      const float* bw = a + n;
      w4[e] = make_float4(rnd<T>(a[i]), rnd<T>(bw[j]), rnd<T>(a[j]),
                          rnd<T>(bw[i]));
    }
    for (int i = tid; i < tile; i += kFacThreads) row[i] = 0.f;
    // cross-tile stages, highest stride first, on v[j] = F[l + j·tile]
    int cur = 0;
    if (tid < nt) sv[0][tid] = tid == (g >> log_tile) ? 1.f : 0.f;
    float wa[kMaxCross], wb[kMaxCross];
    int ns = 0;
    if (tid < nt) {
#pragma unroll
      for (int c = 0; c < kMaxCross; ++c) {
        const int stride = (nt >> 1) >> c;     // nt/2, nt/4, ..., 1
        if (stride < 1) break;
        const int s = log_tile + (31 - __clz(stride));
        const float* a = w + (size_t)(2 * s) * n;
        wa[c] = rnd<T>(a[(tid << log_tile) | l]);
        wb[c] = rnd<T>(a[n + (((tid ^ stride) << log_tile) | l)]);
        ns = c + 1;
      }
    }
    __syncthreads();
    for (int c = 0; (nt >> 1) >> c >= 1; ++c) {
      const int stride = (nt >> 1) >> c;
      if (tid < nt) {
        float y = 0.f;
#pragma unroll
        for (int cc = 0; cc < kMaxCross; ++cc)
          if (cc == c && cc < ns)
            y = wa[cc] * sv[cur][tid] + wb[cc] * sv[cur][tid ^ stride];
        sv[cur ^ 1][tid] = y;
      }
      cur ^= 1;
      __syncthreads();
    }
    if (tid == 0) row[l] = sv[cur][t];
    __syncthreads();
    // in-tile stages, highest stride first, only the pairs on the support
    for (int lg = 0; lg < log_tile; ++lg) {
      const int s = log_tile - 1 - lg;
      for (int q = tid; q < (1 << lg); q += kFacThreads) {
        const int i = (q << (s + 1)) | (l & ((1 << s) - 1));
        const int j = i | (1 << s);
        const float4 c4 = w4[(1 << lg) - 1 + q];
        const float xi = row[i], xj = row[j];
        row[i] = c4.x * xi + c4.y * xj;
        row[j] = c4.z * xj + c4.w * xi;
      }
      __syncthreads();
    }
  }
  // store the block's columns below ld (zeros outside the factor)
  float* frow = f + (size_t)m * ld;
  for (int i = tid; i < tile; i += kFacThreads) {
    const int c = col0 + i;
    if (c >= ld) break;
    const float v = active && c < nv ? row[i] : 0.f;
    frow[c] = v;
    if (hl != nullptr) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      hl[(size_t)m * ld + c] = hi;
      hl[(size_t)(kp + m) * ld + c] =
          __float2bfloat16_rn(v - __bfloat162float(hi));
    }
  }
}

template <typename T>
cudaError_t launch_factors(const float* b_in, const float* b_out,
                           const int* idx_in, const int* idx_out,
                           float* f_in, float* f_out, void* hl_in,
                           void* hl_out,
                           int n1, int k1, int n_in, int kp1,
                           int ld1, int n2, int k2, int n_out, int kp2,
                           int ld2, cudaStream_t stream) {
  const int t1 = n1 < kFacTile ? n1 : kFacTile;
  const int t2 = n2 < kFacTile ? n2 : kFacTile;
  const int tiles1 = (ld1 + t1 - 1) / t1, tiles2 = (ld2 + t2 - 1) / t2;
  sandwich_factors_kernel<T><<<kp1 * tiles1 + kp2 * tiles2, kFacThreads, 0,
                               stream>>>(
      b_in, b_out, idx_in, idx_out, f_in, f_out,
      static_cast<__nv_bfloat16*>(hl_in), static_cast<__nv_bfloat16*>(hl_out),
      n1, k1, n_in, kp1, ld1, tiles1,
      n2, k2, n_out, kp2, ld2, tiles2);
  return cudaGetLastError();
}

inline bool valid_factors(int n1, int k1, int n_in, int kp1, int ld1,
                          int n2, int k2, int n_out, int kp2, int ld2) {
  const int p1 = log2_exact(n1), p2 = log2_exact(n2);
  return p1 >= 1 && p2 >= 1 && n1 <= kMaxN1 && n2 <= kTile * kMaxTiles &&
         k1 >= 1 && k1 <= kMaxK && k2 >= 1 && k2 <= kMaxK && n_in >= 1 &&
         n_in <= n1 && n_out >= 1 && n_out <= n2 && kp1 >= k1 &&
         kp2 >= k2 && kp1 <= kMaxK && kp2 <= kMaxK &&
         kp1 % kFacPadK == 0 && kp2 % kFacPadK == 0 && ld1 >= n_in &&
         ld2 >= n_out && ld1 % kFacPadN == 0 && ld2 % kFacPadN == 0;
}

}  // namespace sandwich
