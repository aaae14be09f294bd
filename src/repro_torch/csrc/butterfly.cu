// Fused multi-stage butterfly product for Hopper (sm_90a): y = B x or Bᵀ x
// over the last axis of x (rows, n).
//
// Replaces the TPU kernel `_butterfly_kernel` in
// src/repro/kernels/butterfly.py (entry `_butterfly_fwd_call`, reached from
// `butterfly_matmul`). Stage s is y = a_s ⊙ x + b_s ⊙ swap_s(x) with
// swap_s(x)[i] = x[i ^ 2^s], stages 0..p-1 in order; the transpose applies
// them in reverse order as a_s ⊙ x + swap_s(b_s ⊙ x). Precision points: the
// reference runs each stage in x's dtype; here the chain runs in float32
// over weights rounded to x's dtype and is rounded once when stored, as the
// sandwich kernels do (kernels/butterfly.py:butterfly_plain is the plain
// twin with the same points).
//
// What bounds it on the H100: bytes. Each row reads n values and writes n,
// and does 3·n·p float operations (a multiply, a multiply-add per element
// and stage): at the encoder's 70,000 x 1024 float32 product, 573 MB moved
// (0.17 ms at 3.35 TB/s) against 2.2 GFLOP (0.03 ms at 67 TFLOP/s). The
// float32 stage weights (p·2·n, 80 KB at n = 1024) are shared by every row
// and stay in L1/L2.
//
// What the design does about it (a first, simple kernel):
// * One pass over device memory: a block loads a row into shared memory as
//   float32 (coalesced), runs all p stages there with one barrier per stage,
//   and writes the row once. No stage touches device memory.
// * Each block loops over a chunk of rows; the grid is as many blocks as fit
//   on the SMs at once (occupancy query), so the row loop, not the launch,
//   covers the rows. A ragged last chunk needs no care: a block owns whole
//   rows.
// * n <= 32768 (128 KB of float32 per row in shared memory, opted into with
//   cudaFuncAttributeMaxDynamicSharedMemorySize); the wrapper raises above
//   it.

#include "sandwich_common.cuh"

namespace {

using namespace sandwich;

constexpr int kMaxN = 32768;

template <typename T, bool kTransposed>
__global__ void __launch_bounds__(kThreads) butterfly_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
    int rows, int n, int p) {
  extern __shared__ float row[];  // n floats
  const int r0 = (int)((long long)blockIdx.x * rows / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * n;
    for (int i = threadIdx.x; i < n; i += kThreads) row[i] = to_f32<T>(xr[i]);
    __syncthreads();
    for (int j = 0; j < p; ++j) {
      const int s = kTransposed ? p - 1 - j : j;
      const float* a = w + (size_t)(2 * s) * n;
      stage<T, kTransposed>(row, row, a, a + n, n, s);
    }
    T* orow = out + (size_t)r * n;
    for (int i = threadIdx.x; i < n; i += kThreads)
      orow[i] = from_f32<T>(row[i]);
    __syncthreads();
  }
}

template <typename T, bool kTransposed>
cudaError_t launch(const void* x, const float* w, void* out, int rows, int n,
                   int p, cudaStream_t stream) {
  auto kernel = butterfly_fwd_kernel<T, kTransposed>;
  const size_t smem = sizeof(float) * (size_t)n;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const int blocks = (int)(rows < fit ? rows : fit);
  kernel<<<blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), w,
                                             static_cast<T*>(out), rows, n, p);
  return cudaGetLastError();
}

}  // namespace

// y = B x (transposed = 0) or Bᵀ x (transposed = 1) for x, out (rows, n)
// contiguous, w (p, 2, n) float32. dtype: 0 = float32, 1 = bfloat16 (x and
// out). Returns the cudaError_t of the launch (0 on success).
extern "C" int butterfly_fwd(const void* x, const float* w, void* out,
                             int rows, int n, int transposed, int dtype,
                             void* stream) {
  const int p = log2_exact(n);
  if (p < 1 || n > kMaxN || rows < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return transposed ? launch<float, true>(x, w, out, rows, n, p, s)
                      : launch<float, false>(x, w, out, rows, n, p, s);
  if (dtype == 1)
    return transposed
               ? launch<__nv_bfloat16, true>(x, w, out, rows, n, p, s)
               : launch<__nv_bfloat16, false>(x, w, out, rows, n, p, s);
  return cudaErrorInvalidValue;
}
