// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(mask(q kᵀ/√D)) v from q, k, v, dO, the forward's lse and
// Δ = rowsum(dO ⊙ o), recomputing each score tile instead of storing the
// (S, S) probabilities. Two kernels, the reference's split:
//
// * flash_bwd_dq replaces `_flash_bwd_dq_kernel` in
//   src/repro/kernels/flash.py: one block per (b·h, tile of query rows)
//   sweeps the key tiles the mask can reach, p = exp(s − lse) on visible
//   entries, ds = p ⊙ (dO·vᵀ − Δ), dq += ds·k; dq·D^-0.5 stored.
// * flash_bwd_dkv replaces `_flash_bwd_dkv_kernel`: one block per (b·h,
//   tile of key rows) sweeps the query tiles that can see it,
//   dv += pᵀ·dO, dk += dsᵀ·(q·D^-0.5).
//
// Each block owns its output tile, so there are no atomics and dq, dk, dv
// are bit-identical from run to run. Precision points are the reference
// kernels': inputs read as float32, q scaled by D^-0.5, every product and
// sum in float32, the outputs rounded to the input dtype once when stored;
// masked entries get p = 0 explicitly, as the reference does
// (kernels/flash.py:121, :160). Δ is computed outside the kernels in
// float32, as the reference computes it outside its pallas_calls.
// kernels/flash.py:flash_dq_plain / flash_dkv_plain are the plain twins.
//
// What bounds them on the H100: operations, 6·D (dq: q·k, dO·v, ds·k) and
// 8·D (dkv: q·k, dO·v, pᵀ·dO, dsᵀ·q) float operations per visible (q, k)
// pair against a few (S, D) arrays moved. Like the forward these first
// kernels run on CUDA cores in float32 and are bound by shared-memory
// loads. A fused backward would need 10·D per pair; the split recomputes
// q·k and dO·v in both kernels, as the reference does.
//
// What the design does about it: the forward's tiles and register
// blocking (flash_common.cuh). The dq block keeps its q and dO tiles, and
// the dkv block its k and v tiles, in shared memory for the whole sweep;
// the swept side's tiles are staged per step with two barriers, the score
// tiles pass through shared memory to the second products, and the
// accumulators stay in registers. Any S >= 1 (zeros and the mask at the
// ragged edge); head dims 8..256 in steps of 8.

#include "flash_common.cuh"

namespace {

using namespace flash;

// s[i][j] = Σ_d A[ty·R+i][d] · B[tx+16j][d] and t[i][j] likewise over
// (A2, B2): the two score-shaped products of a tile, in one pass over d.
template <int R>
__device__ __forceinline__ void two_products(float (&s)[R][R],
                                             float (&t)[R][R], const float* A,
                                             const float* B, const float* A2,
                                             const float* B2, int D, int tx,
                                             int ty) {
  const int LD = D + 1;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = t[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float a[R], b[R], a2[R], b2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = A[(ty * R + i) * LD + d];
      a2[i] = A2[(ty * R + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      b[j] = B[(tx + 16 * j) * LD + d];
      b2[j] = B2[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        t[i][j] = fmaf(a2[i], b2[j], t[i][j]);
      }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int D,
    int causal, int window, float scale) {
  using Tl = Tile<DMAX>;
  constexpr int N = Tl::N, R = Tl::R, DJ = Tl::DJ, PLD = Tl::PLD;
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* qs = smem;           // (N, LD) scaled q tile
  float* dos = qs + N * LD;   // (N, LD) dO tile
  float* ks = dos + N * LD;   // (N, LD) key tile
  float* vs = ks + N * LD;    // (N, LD) value tile
  float* dss = vs + N * LD;   // (N, PLD) ds
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t lbase = (size_t)blockIdx.x * S;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * N;

  load_rows<T, N>(qs, q + base, q0, S, D, scale);
  load_rows<T, N>(dos, dout + base, q0, S, D, 1.f);
  float row_lse[R], row_delta[R], acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    row_lse[i] = row < S ? lse[lbase + row] : 0.f;
    row_delta[i] = row < S ? delta[lbase + row] : 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  key_tiles(q0, N, S, causal, window, &lo, &hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * N;
    __syncthreads();  // the last tile's ks/vs/dss are consumed
    load_rows<T, N>(ks, k + base, k0, S, D, 1.f);
    load_rows<T, N>(vs, v + base, k0, S, D, 1.f);
    __syncthreads();
    float s[R][R], dp[R][R];
    two_products<R>(s, dp, qs, ks, dos, vs, D, tx, ty);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = visible(row, col, S, causal, window)
                            ? expf(s[i][j] - row_lse[i])
                            : 0.f;
        dss[(ty * R + i) * PLD + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();  // dss complete
#pragma unroll 4
    for (int c = 0; c < N; ++c) {
      float g[R];
#pragma unroll
      for (int i = 0; i < R; ++i) g[i] = dss[(ty * R + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float kk = d < D ? ks[c * LD + d] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(g[i], kk, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dq[base + (size_t)row * D + d] = from_f32<T>(acc[i][j] * scale);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int D, int causal, int window, float scale) {
  using Tl = Tile<DMAX>;
  constexpr int N = Tl::N, R = Tl::R, DJ = Tl::DJ, PLD = Tl::PLD;
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* ks = smem;            // (N, LD) key tile, owned
  float* vs = ks + N * LD;     // (N, LD) value tile, owned
  float* qs = vs + N * LD;     // (N, LD) scaled q tile, swept
  float* dos = qs + N * LD;    // (N, LD) dO tile, swept
  float* pt = dos + N * LD;    // (N, PLD) pᵀ: key row x query row
  float* dst = pt + N * PLD;   // (N, PLD) dsᵀ
  float* lse_s = dst + N * PLD;  // (N,)
  float* delta_s = lse_s + N;    // (N,)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t lbase = (size_t)blockIdx.x * S;
  const int k0 = (int)blockIdx.y * N;

  load_rows<T, N>(ks, k + base, k0, S, D, 1.f);
  load_rows<T, N>(vs, v + base, k0, S, D, 1.f);
  float acc_k[R][DJ], acc_v[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  int lo, hi;
  query_tiles(k0, N, S, causal, window, &lo, &hi);
  for (int t = lo; t < hi; ++t) {
    const int q0 = t * N;
    __syncthreads();  // the last tile's qs/dos/pt/dst are consumed
    load_rows<T, N>(qs, q + base, q0, S, D, scale);
    load_rows<T, N>(dos, dout + base, q0, S, D, 1.f);
    for (int c = threadIdx.x; c < N; c += kThreads) {
      const int row = q0 + c;
      lse_s[c] = row < S ? lse[lbase + row] : 0.f;
      delta_s[c] = row < S ? delta[lbase + row] : 0.f;
    }
    __syncthreads();
    float s[R][R], dp[R][R];  // transposed: [key row i][query row j]
    two_products<R>(s, dp, ks, qs, vs, dos, D, tx, ty);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int col = k0 + ty * R + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + c, col, S, causal, window)
                            ? expf(s[i][j] - lse_s[c])
                            : 0.f;
        pt[(ty * R + i) * PLD + c] = p;
        dst[(ty * R + i) * PLD + c] = p * (dp[i][j] - delta_s[c]);
      }
    }
    __syncthreads();  // pt, dst complete
#pragma unroll 2
    for (int c = 0; c < N; ++c) {
      float pp[R], gg[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pp[i] = pt[(ty * R + i) * PLD + c];
        gg[i] = dst[(ty * R + i) * PLD + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float dov = d < D ? dos[c * LD + d] : 0.f;
        const float qv = d < D ? qs[c * LD + d] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc_v[i][j] = fmaf(pp[i], dov, acc_v[i][j]);
          acc_k[i][j] = fmaf(gg[i], qv, acc_k[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = k0 + ty * R + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        dk[base + (size_t)row * D + d] = from_f32<T>(acc_k[i][j]);
        dv[base + (size_t)row * D + d] = from_f32<T>(acc_v[i][j]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, S, D, causal, window;
  float scale;
};

template <typename T, int DMAX>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  using Tl = Tile<DMAX>;
  auto kernel = flash_dq_kernel<T, DMAX>;
  const size_t smem =
      sizeof(float) * ((size_t)4 * Tl::N * (a.D + 1) + Tl::N * Tl::PLD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.S + Tl::N - 1) / Tl::N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.S, a.D, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  using Tl = Tile<DMAX>;
  auto kernel = flash_dkv_kernel<T, DMAX>;
  const size_t smem =
      sizeof(float) * ((size_t)4 * Tl::N * (a.D + 1) + 2 * Tl::N * Tl::PLD +
                       2 * Tl::N);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.S + Tl::N - 1) / Tl::N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.S, a.D,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  switch (dmax_of(a.D)) {
    case 64: return kDq ? launch_dq<T, 64>(a, s) : launch_dkv<T, 64>(a, s);
    case 128: return kDq ? launch_dq<T, 128>(a, s) : launch_dkv<T, 128>(a, s);
    case 256: return kDq ? launch_dq<T, 256>(a, s) : launch_dkv<T, 256>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kDq>
int run(const Args& a, int dtype, void* stream) {
  if (a.bh < 1 || a.S < 1 || dmax_of(a.D) == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, kDq>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, kDq>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq (and dk, dv) (bh, S, D) contiguous in one dtype
// (0 = float32, 1 = bfloat16); lse, delta (bh, S) float32; scale D^-0.5 as
// float32; causal 0 or 1; window > 0 keeps keys k > q - window. Each
// returns the cudaError_t of its one launch (0 on success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int S,
                            int D, int causal, int window, float scale,
                            int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               bh, S, D, causal, window, scale};
  return run<true>(a, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int S, int D, int causal, int window,
                             float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               bh, S, D, causal, window, scale};
  return run<false>(a, dtype, stream);
}
