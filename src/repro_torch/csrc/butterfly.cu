// Fused multi-stage butterfly product for Hopper (sm_90a): y = B x or Bᵀ x
// over the last axis of x (rows, n), n = 2^p.
//
// Replaces the TPU kernel `_butterfly_kernel` in
// src/repro/kernels/butterfly.py (entry `_butterfly_fwd_call`, reached from
// `butterfly_matmul`). Stage s is y = a_s ⊙ x + b_s ⊙ swap_s(x) with
// swap_s(x)[i] = x[i ^ 2^s], stages 0..p-1 in order; the transpose applies
// them in reverse order as a_s ⊙ x + swap_s(b_s ⊙ x). Precision points: the
// reference runs each stage in x's dtype; here the chain runs in float32
// over weights rounded to x's dtype and is rounded once when stored
// (kernels/butterfly.py:butterfly_plain is the plain twin with the same
// points). Each value is two rounded products and their rounded sum, the
// twin's own operations, so the kernel gives the twin's bits.
//
// What bounds it on the H100: bytes. Each row reads n values and writes n,
// and does 3·n·p float operations: at the encoder's 70,000 x 1024 float32
// product, 573 MB moved (0.17 ms at 3.35 TB/s) against 2.2 GFLOP (0.03 ms at
// 67 TFLOP/s). So the rows must stream through at the memory's rate, with
// nothing in between that waits: no barrier, no shared-memory round trip of
// the data, and enough loads in flight.
//
// What the design does about it:
// * n <= 1024 (`butterfly_fwd_kernel`): a warp holds whole rows in its
//   registers, element i = 32·r + lane in register r (n/32 a lane; below
//   n = 32 a warp holds 32/n rows side by side). A stage with stride < 32
//   swaps across lanes by __shfl_xor_sync, one with stride >= 32 between a
//   lane's own registers; all p stages run without a barrier. Loads and
//   stores are coalesced, 32 consecutive elements a register.
// * Each warp keeps two rows in flight (64 values a lane at n = 1024), so
//   each weight read serves both and the loads of one warp's rows overlap
//   the others' stages; more would leave SMs idle at the benches' 64 and
//   128 rows.
// * The block stages the weights once, rounded to x's dtype, as (a, b)
//   pairs in shared memory (8·p·n bytes, 80 KB at n = 1024; two blocks of 8
//   warps an SM), loading them 16 bytes at a time, all before the first
//   store, then its warps walk the rows. A weight read is one 8-byte shared
//   load for every row in flight.
// * n > 1024 (`butterfly_fwd_wide_kernel`, up to 32,768): a block of 8
//   warps takes two rows at a time (one at 32,768) through two register
//   phases: stages 0..9 on chunks of 1024 elements, one warp a chunk as
//   above, and stages 10..p-1 on columns, one lane holding the 2^(p-10)
//   elements that differ in those bits; one shared-memory exchange of the
//   rows (128 KB at the widest) and one barrier between the phases.
//   Weights come from device memory through L1 (p·2·n floats are too many
//   to stage), each load serving both rows.
// * Launch settings (the shared-memory opt-in, the blocks an SM holds) are
//   set up once per kernel instance and device, not per call.

#include "butterfly_common.cuh"

namespace {

using namespace butterfly;

constexpr int kWarps = 8;                 // n <= 1024: warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kWideThreads = 256;         // n > 1024: threads a block
constexpr int kWideWarps = kWideThreads / 32;

template <int P>
struct Narrow {
  static constexpr int N = 1 << P;
  static constexpr int LOGE = P > 5 ? P - 5 : 0;
  static constexpr int E = 1 << LOGE;               // registers a row
  static constexpr int R = 2;                        // row slots a warp
  static constexpr int SUB = P < 5 ? 32 >> P : 1;    // rows a row slot
  static constexpr int ROWS = R * SUB;               // rows a warp takes
  static constexpr int SMEM = 8 * P * N;             // (a, b) pairs
};

// Stages S0..S1-1 of the chain (descending when transposed) on a lane's
// registers v[r][u] = x_u[e0 + r·2^RS] of U rows: a stage with stride below
// 32 pairs lanes (only where RS = 5, the registers holding bits 5 and up),
// any other pairs registers. wab(s, i) gives the rounded (a, b) of stage s
// at element i.
template <bool kTr, int S0, int S1, int RLOG, int RS, int U, typename WAB>
__device__ __forceinline__ void chain(float (&v)[1 << RLOG][U], WAB&& wab,
                                      int e0) {
  static_for<0, S1 - S0>([&](auto J) {
    constexpr int j = decltype(J)::value;
    constexpr int s = kTr ? S1 - 1 - j : S0 + j;
    if constexpr (s < 5) {
#pragma unroll
      for (int r = 0; r < (1 << RLOG); ++r) {
        const float2 ab = wab(s, e0 + (r << RS));
#pragma unroll
        for (int u = 0; u < U; ++u)
          v[r][u] = lane_stage<kTr>(v[r][u], ab.x, ab.y, 1 << s);
      }
    } else {
      constexpr int k = 1 << (s - RS);
#pragma unroll
      for (int r = 0; r < (1 << RLOG); ++r) {
        if (r & k) continue;
        const float2 wi = wab(s, e0 + (r << RS));
        const float2 wj = wab(s, e0 + ((r | k) << RS));
        pair_stage<kTr, U>(v[r], v[r | k], wi.x, wi.y, wj.x, wj.y);
      }
    }
  });
}

template <typename T, bool kTr, int P>
__global__ void __launch_bounds__(kThreads) butterfly_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
    int rows) {
  using C = Narrow<P>;
  constexpr int N = C::N, E = C::E, R = C::R;
  extern __shared__ float2 wt[];  // [p][n] (rnd a, rnd b)
  auto stage_scalar = [&] {
    for (int e = threadIdx.x; e < P * N; e += kThreads) {
      const int s = e / N, i = e % N;
      wt[e] = make_float2(rnd<T>(w[(size_t)(2 * s) * N + i]),
                          rnd<T>(w[(size_t)(2 * s + 1) * N + i]));
    }
  };
  if constexpr (N >= 4) {
    // all of a thread's 16-byte loads first, then the stores: one round
    // trip to L2 rather than one per element pair
    constexpr int Q = P * N / 4, ITERS = (Q + kThreads - 1) / kThreads;
    if ((reinterpret_cast<uintptr_t>(w) & 15) == 0) {
      float4 a4[ITERS], b4[ITERS];
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int e = threadIdx.x + it * kThreads;
        if (e >= Q) break;
        const float* a =
            w + (size_t)(2 * (e / (N / 4))) * N + 4 * (e % (N / 4));
        a4[it] = *reinterpret_cast<const float4*>(a);
        b4[it] = *reinterpret_cast<const float4*>(a + N);
      }
#pragma unroll
      for (int it = 0; it < ITERS; ++it) {
        const int e = threadIdx.x + it * kThreads;
        if (e >= Q) break;
        float2* d = wt + 4 * e;  // [s][4·(e % (n/4))], e = s·n/4 + ...
        d[0] = make_float2(rnd<T>(a4[it].x), rnd<T>(b4[it].x));
        d[1] = make_float2(rnd<T>(a4[it].y), rnd<T>(b4[it].y));
        d[2] = make_float2(rnd<T>(a4[it].z), rnd<T>(b4[it].z));
        d[3] = make_float2(rnd<T>(a4[it].w), rnd<T>(b4[it].w));
      }
    } else {
      stage_scalar();
    }
  } else {
    stage_scalar();
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int e0 = lane & ((N < 32 ? N : 32) - 1);  // element of register 0
  const int sub = P < 5 ? lane >> P : 0;
  const int groups = (rows + C::ROWS - 1) / C::ROWS;
  auto wab = [&](int s, int i) { return wt[s * N + i]; };
  for (int gi = blockIdx.x * kWarps + (threadIdx.x >> 5); gi < groups;
       gi += gridDim.x * kWarps) {
    const int row0 = gi * C::ROWS + sub;  // slot u holds row row0 + u·SUB
    float v[E][R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = row0 + u * C::SUB;
      const T* xr = x + (size_t)row * N + e0;
#pragma unroll
      for (int r = 0; r < E; ++r)
        v[r][u] = row < rows ? to_f32<T>(xr[32 * r]) : 0.f;
    }
    chain<kTr, 0, P, C::LOGE, 5, R>(v, wab, e0);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int row = row0 + u * C::SUB;
      if (row >= rows) continue;
      T* orow = out + (size_t)row * N + e0;
#pragma unroll
      for (int r = 0; r < E; ++r) orow[32 * r] = from_f32<T>(v[r][u]);
    }
  }
}

template <int P>
struct Wide {
  static constexpr int N = 1 << P, H = P - 10;
  static constexpr int R = P <= 14 ? 2 : 1;  // rows a block at once
  static constexpr int SMEM = 4 * R * N;
};

// Stages S0..S1-1 of the wide kernel's chain on its R rows from row0:
// register r of row u holds element e0 + r·2^RS. The first phase (kFirst)
// reads x and writes the block's buffer, the second reads the buffer and
// writes out; rows past the end read 0 and are not stored.
template <typename T, bool kTr, int P, int S0, int S1, int RLOG, int RS,
          bool kFirst>
__device__ __forceinline__ void wide_phase(const T* __restrict__ x,
                                           const float* __restrict__ w,
                                           T* __restrict__ out, float* buf,
                                           int rows, int row0, int e0) {
  constexpr int N = 1 << P, R = Wide<P>::R, NR = 1 << RLOG;
  float v[NR][R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool real = row0 + u < rows;
    const T* xr = x + (size_t)(row0 + u) * N + e0;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      v[r][u] = kFirst ? (real ? to_f32<T>(xr[r << RS]) : 0.f)
                       : buf[u * N + e0 + (r << RS)];
  }
  chain<kTr, S0, S1, RLOG, RS, R>(
      v,
      [&](int s, int i) {
        return make_float2(rnd<T>(__ldg(w + (size_t)(2 * s) * N + i)),
                           rnd<T>(__ldg(w + (size_t)(2 * s + 1) * N + i)));
      },
      e0);
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const bool real = row0 + u < rows;
    T* orow = out + (size_t)(row0 + u) * N + e0;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      if (kFirst) buf[u * N + e0 + (r << RS)] = v[r][u];
      else if (real) orow[r << RS] = from_f32<T>(v[r][u]);
    }
  }
}

template <typename T, bool kTr, int P>
__global__ void __launch_bounds__(kWideThreads) butterfly_fwd_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
    int rows) {
  constexpr int N = 1 << P, H = P - 10, R = Wide<P>::R;
  extern __shared__ float row_buf[];  // R rows of n floats
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row0 = blockIdx.x * R; row0 < rows; row0 += gridDim.x * R) {
    // stages 0..9 on chunk h, element h·1024 + 32·r + lane; stages
    // 10..p-1 on column q, element 1024·r + 32·q + lane
    if constexpr (kTr) {
      for (int q = warp; q < 32; q += kWideWarps)
        wide_phase<T, kTr, P, 10, P, H, 10, true>(x, w, out, row_buf, rows,
                                                  row0, 32 * q + lane);
      __syncthreads();
      for (int h = warp; h < N / 1024; h += kWideWarps)
        wide_phase<T, kTr, P, 0, 10, 5, 5, false>(x, w, out, row_buf, rows,
                                                  row0, 1024 * h + lane);
    } else {
      for (int h = warp; h < N / 1024; h += kWideWarps)
        wide_phase<T, kTr, P, 0, 10, 5, 5, true>(x, w, out, row_buf, rows,
                                                 row0, 1024 * h + lane);
      __syncthreads();
      for (int q = warp; q < 32; q += kWideWarps)
        wide_phase<T, kTr, P, 10, P, H, 10, false>(x, w, out, row_buf, rows,
                                                   row0, 32 * q + lane);
    }
    __syncthreads();  // the buffer is free for the next rows
  }
}

template <typename T, bool kTr, int P>
cudaError_t launch_p(const void* x, const float* w, void* out, int rows,
                     cudaStream_t stream) {
  static int cache[kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = device_sms(&dev, &sms);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if constexpr (P <= 10) {
    auto kernel = butterfly_fwd_kernel<T, kTr, P>;
    constexpr int rows_a_block = Narrow<P>::ROWS * kWarps;
    if ((err = blocks_per_sm(cache, kernel, dev, kThreads, Narrow<P>::SMEM,
                             &per_sm)) != cudaSuccess)
      return err;
    const long long need = ((long long)rows + rows_a_block - 1) / rows_a_block;
    const long long fit = (long long)sms * per_sm;
    kernel<<<(int)(need < fit ? need : fit), kThreads, Narrow<P>::SMEM,
             stream>>>(xt, w, ot, rows);
  } else {
    auto kernel = butterfly_fwd_wide_kernel<T, kTr, P>;
    constexpr int smem = Wide<P>::SMEM, R = Wide<P>::R;
    if ((err = blocks_per_sm(cache, kernel, dev, kWideThreads, smem,
                             &per_sm)) != cudaSuccess)
      return err;
    const long long need = ((long long)rows + R - 1) / R;
    const long long fit = (long long)sms * per_sm;
    kernel<<<(int)(need < fit ? need : fit), kWideThreads, smem, stream>>>(
        xt, w, ot, rows);
  }
  return cudaGetLastError();
}

template <typename T, bool kTr>
cudaError_t launch(const void* x, const float* w, void* out, int rows, int p,
                   cudaStream_t stream) {
  switch (p) {
#define BUTTERFLY_FWD_P(P) \
  case P:                  \
    return launch_p<T, kTr, P>(x, w, out, rows, stream);
    BUTTERFLY_FWD_P(1) BUTTERFLY_FWD_P(2) BUTTERFLY_FWD_P(3)
    BUTTERFLY_FWD_P(4) BUTTERFLY_FWD_P(5) BUTTERFLY_FWD_P(6)
    BUTTERFLY_FWD_P(7) BUTTERFLY_FWD_P(8) BUTTERFLY_FWD_P(9)
    BUTTERFLY_FWD_P(10) BUTTERFLY_FWD_P(11) BUTTERFLY_FWD_P(12)
    BUTTERFLY_FWD_P(13) BUTTERFLY_FWD_P(14) BUTTERFLY_FWD_P(15)
#undef BUTTERFLY_FWD_P
  }
  return cudaErrorInvalidValue;
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
    return transposed ? launch<float, true>(x, w, out, rows, p, s)
                      : launch<float, false>(x, w, out, rows, p, s);
  if (dtype == 1)
    return transposed ? launch<__nv_bfloat16, true>(x, w, out, rows, p, s)
                      : launch<__nv_bfloat16, false>(x, w, out, rows, p, s);
  return cudaErrorInvalidValue;
}
