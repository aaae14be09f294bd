// Butterfly VJP for Hopper (sm_90a): dx and dw of y = B x (or Bᵀ x) over
// the last axis of x (rows, n), for the cotangent g of y.
//
// Replaces the TPU kernel `_butterfly_bwd_kernel` / `_butterfly_bwd_block`
// in src/repro/kernels/butterfly.py (entry `_butterfly_bwd_call`, reached
// from the custom VJP `_butterfly_diff_bwd`). Per row, with segment
// seg = ceil(sqrt(p)) as the reference's default:
//   1. a forward sweep from x that checkpoints the stage input at every
//      seg-th chain position, stopping at the last checkpoint;
//   2. a reverse sweep that recomputes each segment's stage inputs x_s once
//      and takes the dual stage on g: for a forward stage
//      g ← a ⊙ g + swap(b ⊙ g), da_s += g ⊙ x_s, db_s += g ⊙ swap(x_s);
//      for a transposed stage g ← a ⊙ g + b ⊙ swap(g), da_s += g ⊙ x_s,
//      db_s += swap(g) ⊙ x_s (g the cotangent of the stage's output).
// That is at most 3p stage applications a row; the first row's count is
// written to `applied` so a caller can hold it to the reference's schedule.
// Chains run in float32 over weights rounded to x's dtype (the forward
// kernel's precision points); dx is rounded to x's dtype once, when stored;
// dw (p, 2, n) is float32, taken w.r.t. the rounded weights.
//
// What bounds it on the H100: bytes. Per row it reads x and g and writes dx
// (3·n values); the weights are read and dw written once per call. At the
// encoder's 70,000 x 1024 float32 shape that is 860 MB (0.26 ms at
// 3.35 TB/s; 573 MB and 0.17 ms without dx). Its float32 operations, 3n
// for each of the 25 stage applications at p = 10 and 4n for each stage's
// two weight products, 115·n a row, come to 8.2 GFLOP (0.12 ms at
// 67 TFLOP/s).
//
// What the design does about it (a first, simple kernel: one row at a time
// per block, one barrier per stage):
// * The TPU grid is sequential and sums dw in one output block revisited by
//   every grid step. GPU blocks run in parallel, so each block sums the dw
//   of its chunk of rows into its own float32 partial, and a second launch
//   sums the partials over blocks in block order. No atomics: two launches
//   give bit-identical dw. Each partial element is only ever updated by one
//   thread, so no barrier guards it.
// * Where the checkpoints, the recomputed activations, g and the partial
//   fit in 227 KB of shared memory (n <= 1024: 108 KB at n = 1024), all of
//   them live there and the partial is copied out once per block. Above
//   that (n = 2048 .. 8192) the checkpoints and the partial live in device
//   memory, one slice per block; the activations and g stay in shared
//   memory (at n = 8192, p = 13, seg = 4: 4 x 32 KB = 128 KB). Where those
//   pass the 227 KB too (n = 16384 and 32768), they move to device memory
//   as well, beside the block's checkpoints, and the grid is one block an
//   SM. The checkpoints of a row are written and read back by the same
//   block, which mostly hits L2.
// * The grid is as many blocks as fit on the SMs at once; each loops over a
//   chunk of rows, so the partials number a few hundred, not one per row.
// * The input x is data in the encoder and needs no gradient there: with
//   dx = nullptr the kernel skips the store (the dual sweep still runs, dw
//   needs it).

#include "sandwich_common.cuh"

namespace {

using namespace sandwich;

constexpr int kMaxN = 32768;
constexpr size_t kSmemLimit = 227 * 1024;

struct Plan {
  int nck, nact;
  bool in_smem;      // everything in shared memory
  bool work_global;  // the activations and g in device memory too
  size_t smem;
  size_t ck_floats;  // device floats a block keeps beside its partial
};

Plan make_plan(int n, int p, int seg) {
  Plan pl;
  pl.nck = (p + seg - 1) / seg;
  pl.nact = seg > 1 ? seg - 1 : 1;
  const size_t work = sizeof(float) * (size_t)(pl.nact + 1) * n;
  const size_t all =
      work + sizeof(float) * ((size_t)pl.nck * n + (size_t)2 * p * n);
  pl.in_smem = all <= kSmemLimit;
  pl.work_global = work > kSmemLimit;
  pl.smem = pl.in_smem ? all : pl.work_global ? 0 : work;
  pl.ck_floats = pl.in_smem ? 0
                 : (size_t)pl.nck * n +
                       (pl.work_global ? (size_t)(pl.nact + 1) * n : 0);
  return pl;
}

template <typename T, bool kTransposed>
__global__ void __launch_bounds__(kThreads) butterfly_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ gout, T* __restrict__ dx,
    float* __restrict__ partial, float* __restrict__ ckpt,
    int* __restrict__ applied, int rows, int n, int p, int seg, int nck,
    int nact, int in_smem, int work_global, size_t ck_floats) {
  extern __shared__ float smem[];
  float* dev = ckpt + (size_t)blockIdx.x * ck_floats;  // this block's slice
  float* work = work_global ? dev + (size_t)nck * n : smem;  // nact rows
  float* g = work + (size_t)nact * n;          // one row
  const size_t pn2 = (size_t)2 * p * n;
  float* slot = partial + (size_t)blockIdx.x * pn2;
  float* ck = in_smem ? g + n : dev;
  float* part = in_smem ? ck + (size_t)nck * n : slot;
  // zeroed before the first row's barrier, updated only after it
  for (size_t i = threadIdx.x; i < pn2; i += kThreads) part[i] = 0.f;
  const int r0 = (int)((long long)blockIdx.x * rows / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x);
  for (int r = r0; r < r1; ++r) {
    const T* xr = x + (size_t)r * n;
    const T* gr = gout + (size_t)r * n;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      work[i] = to_f32<T>(xr[i]);
      g[i] = to_f32<T>(gr[i]);
    }
    __syncthreads();
    const int count = chain_vjp<T, kTransposed>(
        work, g, ck, n, p, seg, w, (size_t)n, part, false, [](float*) {});
    if (dx != nullptr) {
      T* dr = dx + (size_t)r * n;
      for (int i = threadIdx.x; i < n; i += kThreads)
        dr[i] = from_f32<T>(g[i]);
    }
    if (r == 0 && applied != nullptr && threadIdx.x == 0) *applied = count;
    __syncthreads();
  }
  if (in_smem)  // after the row loop's last barrier
    for (size_t i = threadIdx.x; i < pn2; i += kThreads) slot[i] = part[i];
}

// dw[e] = sum of the partials over blocks, in block order.
__global__ void __launch_bounds__(kThreads) butterfly_bwd_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int chunks,
    size_t total) {
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + e];
    dw[e] = acc;
  }
}

template <typename T, bool kTransposed>
cudaError_t blocks_that_fit(const Plan& pl, int* blocks) {
  auto kernel = butterfly_bwd_kernel<T, kTransposed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, pl.smem)) != cudaSuccess)
    return err;
  // with everything in device memory, one block an SM: each keeps 2pn + (nck
  // + nact + 1)·n floats there
  *blocks = sms * (per_sm > 0 && !pl.work_global ? per_sm : 1);
  return cudaSuccess;
}

template <typename T, bool kTransposed>
cudaError_t launch(const void* x, const float* w, const void* g, void* dx,
                   float* dw, float* partial, float* ckpt, int* applied,
                   int rows, int n, int p, int seg, int chunks,
                   cudaStream_t stream) {
  const Plan pl = make_plan(n, p, seg);
  auto kernel = butterfly_bwd_kernel<T, kTransposed>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return err;
  kernel<<<chunks, kThreads, pl.smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(g),
      static_cast<T*>(dx), partial, ckpt, applied, rows, n, p, seg, pl.nck,
      pl.nact, pl.in_smem ? 1 : 0, pl.work_global ? 1 : 0, pl.ck_floats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)2 * p * n;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  butterfly_bwd_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      partial, dw, chunks, total);
  return cudaGetLastError();
}

bool bad_shape(int n, int p, int seg) {
  return p < 1 || n > kMaxN || seg < 1 || seg > p;
}

}  // namespace

// The launch plan for rows x n at segment seg: sizes[0] the number of
// blocks (row chunks) to pass to butterfly_bwd, sizes[1] the floats of the
// partial workspace (chunks · 2pn), sizes[2] the floats of the checkpoint
// workspace in device memory (0 where the checkpoints fit in shared
// memory; with the activations and g where those do not fit either).
// Returns 0, or cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int butterfly_bwd_plan(int rows, int n, int seg, int transposed,
                                  int dtype, long long* sizes) {
  const int p = log2_exact(n);
  if (bad_shape(n, p, seg) || rows < 1) return cudaErrorInvalidValue;
  const Plan pl = make_plan(n, p, seg);
  int fit = 0;
  cudaError_t err;
  if (dtype == 0)
    err = transposed ? blocks_that_fit<float, true>(pl, &fit)
                     : blocks_that_fit<float, false>(pl, &fit);
  else if (dtype == 1)
    err = transposed ? blocks_that_fit<__nv_bfloat16, true>(pl, &fit)
                     : blocks_that_fit<__nv_bfloat16, false>(pl, &fit);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const int chunks = rows < fit ? rows : fit;
  sizes[0] = chunks;
  sizes[1] = (long long)chunks * 2 * p * n;
  sizes[2] = (long long)chunks * pl.ck_floats;
  return 0;
}

// x, g (rows, n) contiguous in the dtype (0 = float32, 1 = bfloat16); w
// (p, 2, n) float32. Writes dx (rows, n) in the dtype unless dx is null,
// dw (p, 2, n) float32, and, unless `applied` is null, the first row's
// number of stage applications. partial, ckpt: workspaces of the sizes
// butterfly_bwd_plan gives for the same rows, n, seg and chunks. Returns
// the cudaError_t of the two launches (0 on success).
extern "C" int butterfly_bwd(const void* x, const float* w, const void* g,
                             void* dx, float* dw, float* partial,
                             float* ckpt, int* applied, int rows, int n,
                             int seg, int chunks, int transposed, int dtype,
                             void* stream) {
  const int p = log2_exact(n);
  if (bad_shape(n, p, seg) || rows < 1 || chunks < 1 || chunks > rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BUTTERFLY_BWD(T, TR)                                                \
  launch<T, TR>(x, w, g, dx, dw, partial, ckpt, applied, rows, n, p, seg, \
                chunks, s)
  if (dtype == 0)
    return transposed ? BUTTERFLY_BWD(float, true)
                      : BUTTERFLY_BWD(float, false);
  if (dtype == 1)
    return transposed ? BUTTERFLY_BWD(__nv_bfloat16, true)
                      : BUTTERFLY_BWD(__nv_bfloat16, false);
#undef BUTTERFLY_BWD
  return cudaErrorInvalidValue;
}
