// Flash-attention forward for Hopper (sm_90a): o = softmax(mask(q kᵀ/√D)) v
// and the row logsumexp, for q/k/v (B·H, S, D), heads already expanded.
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash.py
// (entry `_flash_fwd_call`, reached from `flash_attention`). Precision
// points are the reference kernel's: q/k/v read as float32, q pre-scaled by
// D^-0.5, every product and the online-softmax state (m, l, the
// accumulator) in float32, o rounded to the input dtype once when stored;
// lse = m + log(max(l, 1e-30)) in float32. kernels/flash.py:flash_fwd_plain
// is the plain twin.
//
// Masked entries: the reference writes -1e30 into masked scores and lets
// exp(m_old - m_new) = 0 wipe what a row summed before its first visible
// key. Here a masked entry's probability is 0 outright and -1e30 enters
// only the running max; every row sees at least its own key (k = q passes
// every mask), so both give the softmax over the visible keys.
//
// What bounds it on the H100: operations. Per visible (q, k) pair it does
// 4·D float operations (q·k and p·v) against 4·S·D elements moved in all;
// at the training shape (B·H = 36, S = 2048, D = 64, causal) that is
// 19.3 GFLOP against 19 MB. This first kernel runs the products on CUDA
// cores in float32 (67 TFLOP/s), not on the tensor cores that the bf16
// peak of 989 TFLOP/s assumes, and is bound by its shared-memory loads: a
// thread's 4 x 4 score block takes 8 loads per 16 multiply-adds.
//
// What the design does about it (a first, simple kernel):
// * One block per (b·h, tile of N query rows), heaviest causal tiles first.
//   The q tile (scaled) stays in shared memory; the block sweeps the key
//   tiles the mask can reach, staging K and V tiles in shared memory with
//   two barriers a tile, and never writes a score to device memory.
// * The score tile is split into 4 x 4 (2 x 2 at D > 128) blocks of
//   registers; row max and row sum are half-warp shuffles, so m and l of a
//   row live in the 16 threads that own it. The probabilities go through
//   shared memory to the p·v product, whose accumulator stays in registers.
// * Any S >= 1: the ragged last tiles load zeros and the mask hides them.
//   Head dims 8..256 in steps of 8, compiled for 64, 128 and 256.

#include "flash_common.cuh"

namespace {

using namespace flash;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int D, int causal,
    int window, float scale) {
  using Tl = Tile<DMAX>;
  constexpr int N = Tl::N, R = Tl::R, DJ = Tl::DJ, PLD = Tl::PLD;
  extern __shared__ float smem[];
  const int LD = D + 1;
  float* qs = smem;           // (N, LD) scaled q tile
  float* ks = qs + N * LD;    // (N, LD) key tile
  float* vs = ks + N * LD;    // (N, LD) value tile
  float* ps = vs + N * LD;    // (N, PLD) probabilities
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t base = (size_t)blockIdx.x * S * D;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * N;

  load_rows<T, N>(qs, q + base, q0, S, D, scale);
  float m[R], l[R], acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  int lo, hi;
  key_tiles(q0, N, S, causal, window, &lo, &hi);
  for (int t = lo; t < hi; ++t) {
    const int k0 = t * N;
    __syncthreads();  // the last tile's ks/vs/ps are consumed
    load_rows<T, N>(ks, k + base, k0, S, D, 1.f);
    load_rows<T, N>(vs, v + base, k0, S, D, 1.f);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[R], b[R];
#pragma unroll
      for (int i = 0; i < R; ++i) a[i] = qs[(ty * R + i) * LD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty * R + i;
      bool ok[R];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        ok[j] = visible(row, k0 + tx + 16 * j, S, causal, window);
        mx = fmaxf(mx, ok[j] ? s[i][j] : kNegInf);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * R + i) * PLD + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // ps complete
#pragma unroll 4
    for (int c = 0; c < N; ++c) {
      float p[R];
#pragma unroll
      for (int i = 0; i < R; ++i) p[i] = ps[(ty * R + i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? vs[c * LD + d] : 0.f;
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }
  const size_t lbase = (size_t)blockIdx.x * S;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty * R + i;
    if (row >= S) continue;
    const float lm = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) o[base + (size_t)row * D + d] = from_f32<T>(acc[i][j] / lm);
    }
    if (tx == 0) lse[lbase + row] = m[i] + logf(lm);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int S, int D, int causal, int window,
                   float scale, cudaStream_t stream) {
  using Tl = Tile<DMAX>;
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const size_t smem =
      sizeof(float) * ((size_t)3 * Tl::N * (D + 1) + Tl::N * Tl::PLD);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + Tl::N - 1) / Tl::N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, D, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int S, int D, int causal, int window,
                     float scale, cudaStream_t s) {
  switch (dmax_of(D)) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, S, D, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, S, D, causal, window, scale,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, bh, S, D, causal, window, scale,
                            s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// o and lse for q, k, v, o (bh, S, D) contiguous and lse (bh, S) float32.
// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o). causal: 0 or 1; window:
// keys k > q - window only, when > 0. Returns the cudaError_t of the launch
// (0 on success). scale: D^-0.5 as float32, passed in so that the plain twin
// and the kernel scale by the same number.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int S, int D, int causal,
                         int window, float scale, int dtype, void* stream) {
  if (bh < 1 || S < 1 || dmax_of(D) == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, bh, S, D, causal, window, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, S, D, causal, window,
                                   scale, s);
  return cudaErrorInvalidValue;
}

// Rows of the kernels' query and key tiles at head dim D, forward and
// backward (0: D not taken); the bench rows report them.
extern "C" int flash_tile_rows(int D) { return tile_rows(D); }
