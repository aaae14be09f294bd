// Device code shared by the butterfly kernels (butterfly.cu, butterfly_bwd.cu):
// the stage arithmetic with the plain twins' rounding points, compile-time
// loops, and the per-device launch settings each kernel instance computes
// once.
//
// A stage with stride 2^s is y[i] = a[i] x[i] + b[i] x[i ^ 2^s] (forward) or
// y[i] = a[i] x[i] + b[i ^ 2^s] x[i ^ 2^s] (transposed, the stages applied in
// reverse order). Every value is a float32 product of two float32 values
// followed by their float32 sum, as the plain twins compute it (`a * x` and
// `b * swap(x)` are separate tensors, then added), so the kernels give the
// same bits as the twins: products and sums use the _rn intrinsics, which
// nvcc never contracts into fused multiply-adds.
#pragma once

#include <type_traits>

#include "sandwich_common.cuh"

namespace butterfly {

using sandwich::from_f32;
using sandwich::log2_exact;
using sandwich::rnd;
using sandwich::to_f32;

constexpr int kMaxN = 32768;
constexpr int kMaxDevices = 64;

// ⌈√p⌉, the reference's default checkpoint interval
__host__ __device__ constexpr int seg_of(int p) {
  int s = 1;
  while (s * s < p) ++s;
  return s;
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// a·x + b·xp, two rounded products and their rounded sum
__device__ __forceinline__ float mix(float a, float x, float b, float xp) {
  return add(mul(a, x), mul(b, xp));
}

__device__ __forceinline__ float shfl(float v, int mask) {
  return __shfl_xor_sync(0xffffffffu, v, mask);
}

// f(integral_constant<I>) for I in [I0, I1): indices the compiler sees as
// constants, so register arrays indexed by them stay in registers
template <int I0, int I1, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I0 < I1) {
    f(std::integral_constant<int, I0>{});
    static_for<I0 + 1, I1>(f);
  }
}

// One stage on the register pair (xi, xj) = (x[i], x[i ^ st]) of each of U
// rows, weights (ai, bi) at i and (aj, bj) at j.
template <bool kTr, int U>
__device__ __forceinline__ void pair_stage(float (&xi)[U], float (&xj)[U],
                                           float ai, float bi, float aj,
                                           float bj) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float vi = xi[u], vj = xj[u];
    xi[u] = mix(ai, vi, kTr ? bj : bi, vj);
    xj[u] = mix(aj, vj, kTr ? bi : bj, vi);
  }
}

// One stage whose partner lies in lane ^ mask: v is this lane's x[i], a and
// b its weights at i. The transposed stage swaps the product b·x.
template <bool kTr>
__device__ __forceinline__ float lane_stage(float v, float a, float b,
                                            int mask) {
  if (kTr) return add(mul(a, v), shfl(mul(b, v), mask));
  return mix(a, v, b, shfl(v, mask));
}

// The current device and its SM count, asked once per device.
inline cudaError_t device_sms(int* dev, int* sms) {
  static int cached[kMaxDevices] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[*dev] == 0 &&
      (err = cudaDeviceGetAttribute(&cached[*dev],
                                    cudaDevAttrMultiProcessorCount, *dev)) !=
          cudaSuccess)
    return err;
  *sms = cached[*dev];
  return cudaSuccess;
}

// The blocks of `threads` an SM holds at `smem` bytes, asked once per kernel
// instance and device (`cache`, zero until then) with the opt-in to that
// much dynamic shared memory.
template <typename Kernel>
cudaError_t blocks_per_sm(int (&cache)[kMaxDevices], Kernel kernel, int dev,
                          int threads, int smem, int* per_sm) {
  if (cache[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int fit = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &fit, kernel, threads, smem)) != cudaSuccess)
      return err;
    cache[dev] = fit > 0 ? fit : 1;
  }
  *per_sm = cache[dev];
  return cudaSuccess;
}

}  // namespace butterfly
