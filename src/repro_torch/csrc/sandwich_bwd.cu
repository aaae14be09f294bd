// Fused butterfly-sandwich backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_sandwich_bwd_kernel` in
// src/repro/kernels/sandwich.py (entry `_sandwich_bwd_call`, reached from
// the custom VJP `_sandwich_diff_bwd`). Given the forward's input x, its
// weights and the cotangent g of its output, per row it
//
//   1. recomputes h1 = scale_in · select(B_in x) and z = scatter(scale_out ·
//      core · h1), rounded to T as the forward rounds them;
//   2. takes the VJP through the transposed output butterfly: gz and d b_out;
//   3. forms dh2 = scale_out · gz[idx_out] (gz rounded to T), d core +=
//      dh2ᵀ h1, dh1 = dh2 · core and du = scatter_idx_in(scale_in · dh1),
//      rounded to T;
//   4. takes the VJP through the input butterfly: dx (rounded to T when
//      stored, padding columns dropped) and d b_in.
//
// The stage rule (butterfly.py:103-165): for a forward stage the cotangent
// goes through the transposed stage, da[i] += g[i] x[i], db[i] += g[i]
// x[i^st]; for a transposed stage through the forward stage, db[i] +=
// g[i^st] x[i]. Chains run in float32 over weights rounded to T, like the
// forward kernel and the plain twin (kernels/sandwich.py:sandwich_bwd_plain).
// Weight gradients are float32 and are taken w.r.t. the T-rounded weights.
//
// What bounds it on the H100: bytes. Per row it must move 2·n_in + n_out
// activations (x, g, dx), and per call the float32 weights and their
// gradients: at 8192 rows ~45-60 MB at an MLP site, ~0.84 GB at the head.
// Its float32 operations, counted on the support the VJP needs (the output
// chain starts from k2 nonzeros, the input chain's cotangent from k1), are
// 19-24% of a dense count: ~0.6 G at an MLP site and ~17 G at the head,
// under the ~20 operations per byte where the CUDA cores' float32 rate
// (67 TFLOP/s) would bind instead. The weight gradients are summed over
// all rows, which on a GPU needs a reduction across blocks.
//
// What the design does about it (a first, simple kernel: its sweeps run
// densely, one row at a time, far from the bound):
// * Three launches, no float atomics, a fixed summation order, so the
//   weight gradients are bit-identical from run to run:
//   A) one block per (row chunk, output tile) runs the output side: it
//      recomputes the row's z, the tile's row after the cross-tile stages,
//      and takes the VJP through the tile's in-tile stages. It adds the
//      in-tile d b_out of its rows into its own float32 partial in device
//      memory and writes G, the cotangent at the in-tile boundary, at the
//      k2 offsets idx_out mod tile (k2 · tiles floats per row);
//   B) one block per row chunk recomputes the input side, finishes the
//      cross-tile VJP (only the <= k2 offsets that hold a nonzero of z have
//      nonzero stage inputs there, and gz is needed only at idx_out, so this
//      part is k2 short vectors of tiles entries), then dh2, d core, dh1, du
//      and the input-butterfly VJP; it stores dx and adds d b_in, d core and
//      the cross-tile d b_out into its own partial;
//   C) sums the partials over chunks, in chunk order, into the outputs.
//   Each partial element is read and written by one thread only, so no
//   barrier guards it.
// * The head's output row (n2 = 65536) is split into tiles of kTile as in
//   the forward kernel; its in-tile d b_out (12 stages x 2 x 4096 float32,
//   384 KB) does not fit shared memory, hence the partials in device memory.
// * Stage inputs for the reverse sweeps come from segmented checkpointing
//   in shared memory, as `_butterfly_bwd_block` does: a forward sweep keeps
//   the activation at every seg-th stage (seg = ceil(sqrt(p))), the reverse
//   sweep recomputes each segment once. Stage applications per row: p for
//   the sweep, <= p for the recompute, p for the dual stages, on each side
//   (A also recomputes the input side, p1 more). Shared memory per block:
//   A (ceil(p/seg) + max(seg - 1, 1) + 1) tiles, at most n1 for the
//   recomputed input; B the same count of n1 rows, plus k2·(cross stages +
//   2)·tiles floats. At the head: A 7 x 16 KB = 112 KB, B 7 x 4 KB + 6 KB.
//   Where B's rows would pass the 227 KB a block may use (n1 = 8192: 8 rows
//   of 32 KB), its ceil(p/seg) checkpoints move to device memory, a slice
//   of the block's own partial, as the butterfly backward's do.
// * Selection and scatter are index gathers (int32 idx_in/idx_out), not
//   the TPU's one-hot matmuls.

#include "sandwich_common.cuh"

namespace {

using namespace sandwich;

// Partial of one block: nothing else writes it. Zeroed by the block.
__device__ __forceinline__ void zero_partial(float* p, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
  __syncthreads();
}

struct Dims {
  int rows, n_in, n1, p1, k1, k2, n2, n_out, tile, log_tile, nt, ncross;
  int seg1, seg2, chunks_a, chunks_b;
  int ck_global;  // B keeps its checkpoints in device memory
  float scale_in, scale_out;
};

constexpr size_t kSmemLimit = 227 * 1024;

__host__ __device__ inline int nbuf(int p, int seg) {
  return (p + seg - 1) / seg + (seg > 1 ? seg - 1 : 1) + 1;
}
__host__ __device__ inline size_t part_a(const Dims& d) {
  return (size_t)2 * d.log_tile * d.tile;
}
// B's partial sums (d b_in, d core, cross-tile d b_out), then, with
// ck_global, its checkpoint rows
__host__ __device__ inline size_t part_b_sums(const Dims& d) {
  return (size_t)2 * d.p1 * d.n1 + (size_t)d.k1 * d.k2 +
         (size_t)2 * d.ncross * d.k2 * d.nt;
}
__host__ __device__ inline size_t part_b(const Dims& d) {
  const int nck = (d.p1 + d.seg1 - 1) / d.seg1;
  return part_b_sums(d) + (d.ck_global ? (size_t)nck * d.n1 : 0);
}

// Input butterfly of row r, then h1 and the rounded scattered values zval.
// work holds n1 floats. Ends with a barrier.
template <typename T>
__device__ void input_side(const T* x, const float* b_in, const float* core,
                           const int* idx_in, const int* idx_out,
                           const Dims& d, int r, float* work, float* h1,
                           float* zval, int* zidx) {
  const T* xr = x + (size_t)r * d.n_in;
  for (int i = threadIdx.x; i < d.n1; i += kThreads)
    work[i] = i < d.n_in ? to_f32<T>(xr[i]) : 0.f;
  __syncthreads();
  for (int s = 0; s < d.p1; ++s) {
    const float* a = b_in + (size_t)(2 * s) * d.n1;
    stage<T, false>(work, work, a, a + d.n1, d.n1, s);
  }
  if (threadIdx.x < d.k1)
    h1[threadIdx.x] = rnd<T>(work[idx_in[threadIdx.x]]) * d.scale_in;
  __syncthreads();
  if (threadIdx.x < d.k2) {
    float acc = 0.f;
    for (int i = 0; i < d.k1; ++i) acc += core[threadIdx.x * d.k1 + i] * h1[i];
    zval[threadIdx.x] = rnd<T>(acc * d.scale_out);
    zidx[threadIdx.x] = idx_out[threadIdx.x];
  }
  __syncthreads();
}

// A: output side, one block per (row chunk, tile).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads) sandwich_bwd_out_kernel(
    const T* __restrict__ x, const T* __restrict__ gout,
    const float* __restrict__ b_in, const float* __restrict__ core,
    const float* __restrict__ b_out, const int* __restrict__ idx_in,
    const int* __restrict__ idx_out, float* __restrict__ gsel,
    float* __restrict__ partial, Dims d) {
  extern __shared__ float smem[];
  __shared__ float h1[kMaxK];
  __shared__ float zval[kMaxK];
  __shared__ int zidx[kMaxK];
  const int c = blockIdx.x / NT, t = blockIdx.x % NT;
  const int tile = d.tile, p = d.log_tile;
  const int nck = (p + d.seg2 - 1) / d.seg2;
  float* ck = smem;                                  // nck tiles
  float* work = ck + (size_t)nck * tile;             // >= max(seg-1,1) tiles
  float* g = work + (size_t)max(d.n1, max(d.seg2 - 1, 1) * tile);
  float* part = partial + (size_t)blockIdx.x * part_a(d);
  zero_partial(part, part_a(d));
  const int base = t << d.log_tile;
  const int r0 = (int)((long long)c * d.rows / d.chunks_a);
  const int r1 = (int)((long long)(c + 1) * d.rows / d.chunks_a);
  for (int r = r0; r < r1; ++r) {
    input_side<T>(x, b_in, core, idx_in, idx_out, d, r, work, h1, zval,
                  zidx);
    cross_tile_row<T, NT>(work, zval, zidx, d.k2, b_out, d.n2, tile,
                          d.log_tile, t);
    const T* gr = gout + (size_t)r * d.n_out;
    for (int i = threadIdx.x; i < tile; i += kThreads)
      g[i] = base + i < d.n_out ? to_f32<T>(gr[base + i]) : 0.f;
    __syncthreads();
    chain_vjp<T, true>(work, g, ck, tile, p, d.seg2, b_out + base,
                       (size_t)d.n2, part, true, [](float*) {});
    // G at the k2 offsets, for the cross-tile part and gz in kernel B
    if (threadIdx.x < d.k2)
      gsel[((size_t)r * d.k2 + threadIdx.x) * NT + t] =
          g[zidx[threadIdx.x] & (tile - 1)];
    __syncthreads();
  }
}

// B: cross-tile VJP, core, input side; one block per row chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) sandwich_bwd_in_kernel(
    const T* __restrict__ x, const float* __restrict__ b_in,
    const float* __restrict__ core, const float* __restrict__ b_out,
    const int* __restrict__ idx_in, const int* __restrict__ idx_out,
    const float* __restrict__ gsel, T* __restrict__ dx,
    float* __restrict__ partial, Dims d) {
  extern __shared__ float smem[];
  __shared__ float h1[kMaxK];
  __shared__ float zval[kMaxK];
  __shared__ int zidx[kMaxK];
  __shared__ float dh2[kMaxK];
  const int n1 = d.n1, p = d.p1, nt = d.nt, nc = d.ncross;
  const int nck = (p + d.seg1 - 1) / d.seg1;
  float* part = partial + (size_t)blockIdx.x * part_b(d);
  float* ck = d.ck_global ? part + part_b_sums(d) : smem;  // nck rows
  float* work = d.ck_global ? smem : ck + (size_t)nck * n1;  // max(seg-1,1)
  float* g = work + (size_t)max(d.seg1 - 1, 1) * n1;      // one row
  float* xc = g + n1;  // per m: (nc + 1) stage inputs and G, nt floats each
  float* part_core = part + (size_t)2 * p * n1;
  float* part_cross = part_core + (size_t)d.k1 * d.k2;
  zero_partial(part, part_b(d));
  const int r0 = (int)((long long)blockIdx.x * d.rows / d.chunks_b);
  const int r1 = (int)((long long)(blockIdx.x + 1) * d.rows / d.chunks_b);
  const int tid = threadIdx.x;
  for (int r = r0; r < r1; ++r) {
    // input forward sweep with checkpoints; h1 and zval from its output
    const T* xr = x + (size_t)r * d.n_in;
    for (int i = tid; i < n1; i += kThreads)
      work[i] = i < d.n_in ? to_f32<T>(xr[i]) : 0.f;
    for (int i = tid; i < n1; i += kThreads) g[i] = 0.f;
    __syncthreads();
    // the chain's forward sweep runs first and calls back with its output;
    // the cotangent g is filled in there before the reverse sweep starts
    chain_vjp<T, false>(work, g, ck, n1, p, d.seg1, b_in, (size_t)n1, part,
                        true, [&](float* h) {
      if (tid < d.k1) h1[tid] = rnd<T>(h[idx_in[tid]]) * d.scale_in;
      __syncthreads();
      if (tid < d.k2) {
        float acc = 0.f;
        for (int i = 0; i < d.k1; ++i) acc += core[tid * d.k1 + i] * h1[i];
        zval[tid] = rnd<T>(acc * d.scale_out);
        zidx[tid] = idx_out[tid];
      }
      __syncthreads();
      // cross-tile VJP for the offset of idx_out[m], one thread per m; the
      // lowest m of an offset owns its partial entries
      if (tid < d.k2) {
        const int m = tid, lt = d.log_tile, l = zidx[m] & (d.tile - 1);
        float* v = xc + (size_t)m * (nc + 2) * nt;     // nc + 1 inputs
        float* gv = v + (size_t)(nc + 1) * nt;         // cotangent
        bool owner = true;
        for (int mm = 0; mm < m; ++mm)
          if ((zidx[mm] & (d.tile - 1)) == l) owner = false;
        for (int j = 0; j < nt; ++j) v[j] = 0.f;
        for (int mm = 0; mm < d.k2; ++mm)
          if ((zidx[mm] & (d.tile - 1)) == l) v[zidx[mm] >> lt] = zval[mm];
        // forward, highest cross stage first; input of step k at v + k·nt
        for (int k = 0; k < nc; ++k) {
          const int cb = nt >> (k + 1), s = lt + nc - 1 - k;
          const float* a = b_out + (size_t)(2 * s) * d.n2;
          const float* b = a + d.n2;
          const float* vi = v + (size_t)k * nt;
          float* vo = v + (size_t)(k + 1) * nt;
          for (int j = 0; j < nt; ++j) {
            if (j & cb) continue;
            const int gi = (j << lt) | l, gj = ((j | cb) << lt) | l;
            vo[j] = rnd<T>(a[gi]) * vi[j] + rnd<T>(b[gj]) * vi[j | cb];
            vo[j | cb] = rnd<T>(a[gj]) * vi[j | cb] + rnd<T>(b[gi]) * vi[j];
          }
        }
        for (int j = 0; j < nt; ++j)
          gv[j] = gsel[((size_t)r * d.k2 + m) * nt + j];
        // reverse: lowest cross stage first
        for (int k = nc - 1; k >= 0; --k) {
          const int cb = nt >> (k + 1), s = lt + nc - 1 - k;
          const float* a = b_out + (size_t)(2 * s) * d.n2;
          const float* b = a + d.n2;
          const float* t = v + (size_t)k * nt;
          float* pda = part_cross + ((size_t)(2 * k) * d.k2 + m) * nt;
          float* pdb = pda + (size_t)d.k2 * nt;
          for (int j = 0; j < nt; ++j) {
            if (j & cb) continue;
            const int jc = j | cb;
            const int gi = (j << lt) | l, gj = (jc << lt) | l;
            const float g0 = gv[j], g1 = gv[jc];
            if (owner) {
              pda[j] += g0 * t[j];
              pda[jc] += g1 * t[jc];
              pdb[j] += g1 * t[j];
              pdb[jc] += g0 * t[jc];
            }
            gv[j] = rnd<T>(a[gi]) * g0 + rnd<T>(b[gi]) * g1;
            gv[jc] = rnd<T>(a[gj]) * g1 + rnd<T>(b[gj]) * g0;
          }
        }
        dh2[m] = rnd<T>(gv[zidx[m] >> lt]) * d.scale_out;
      }
      __syncthreads();
      // d core += dh2ᵀ h1; dh1 = dh2 · core; du = scatter(scale_in · dh1)
      for (int e = tid; e < d.k1 * d.k2; e += kThreads)
        part_core[e] += dh2[e / d.k1] * h1[e % d.k1];
      if (tid < d.k1) {
        float acc = 0.f;
        for (int m = 0; m < d.k2; ++m) acc += dh2[m] * core[m * d.k1 + tid];
        g[idx_in[tid]] = rnd<T>(acc * d.scale_in);
      }
      __syncthreads();
    });
    T* dr = dx + (size_t)r * d.n_in;
    for (int i = tid; i < d.n_in; i += kThreads) dr[i] = from_f32<T>(g[i]);
    __syncthreads();
  }
}

// C: sum the partials over chunks, in chunk order.
__global__ void __launch_bounds__(kThreads) sandwich_bwd_reduce_kernel(
    const float* __restrict__ pa, const float* __restrict__ pb,
    const int* __restrict__ idx_out, float* __restrict__ db_in,
    float* __restrict__ dcore, float* __restrict__ db_out, Dims d) {
  const size_t n_in_w = (size_t)2 * d.p1 * d.n1;
  const size_t n_core = (size_t)d.k1 * d.k2;
  const int p2 = d.log_tile + d.ncross;
  const size_t n_out_w = (size_t)2 * p2 * d.n2;
  const size_t total = n_in_w + n_core + n_out_w;
  const size_t sa = part_a(d), sb = part_b(d);
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    float acc = 0.f;
    if (e < n_in_w + n_core) {
      for (int c = 0; c < d.chunks_b; ++c) acc += pb[c * sb + e];
      if (e < n_in_w) db_in[e] = acc;
      else dcore[e - n_in_w] = acc;
      continue;
    }
    const size_t o = e - n_in_w - n_core;
    const int sab = (int)(o / d.n2), i = (int)(o % d.n2);
    const int s = sab / 2, ab = sab % 2;
    if (s < d.log_tile) {
      const int t = i >> d.log_tile, il = i & (d.tile - 1);
      const size_t off = (size_t)(2 * s + ab) * d.tile + il;
      for (int c = 0; c < d.chunks_a; ++c)
        acc += pa[((size_t)c * d.nt + t) * sa + off];
    } else {
      const int k = d.log_tile + d.ncross - 1 - s;   // cross step of stage s
      const int l = i & (d.tile - 1), j = i >> d.log_tile;
      int m = -1;
      for (int mm = 0; mm < d.k2 && m < 0; ++mm)
        if ((idx_out[mm] & (d.tile - 1)) == l) m = mm;
      if (m >= 0) {
        const size_t off = n_in_w + n_core +
                           (((size_t)(2 * k + ab) * d.k2 + m) * d.nt + j);
        for (int c = 0; c < d.chunks_b; ++c) acc += pb[c * sb + off];
      }
    }
    db_out[o] = acc;
  }
}

int default_seg(int p) {
  int s = 1;
  while (s * s < p) ++s;
  return s;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t smem_a(const Dims& d) {
  const size_t work = d.n1 > (d.seg2 > 1 ? d.seg2 - 1 : 1) * d.tile
                          ? (size_t)d.n1
                          : (size_t)(d.seg2 > 1 ? d.seg2 - 1 : 1) * d.tile;
  return sizeof(float) *
         ((size_t)((d.log_tile + d.seg2 - 1) / d.seg2) * d.tile + work +
          d.tile);
}
size_t smem_b(const Dims& d) {
  const int rows = nbuf(d.p1, d.seg1) -
                   (d.ck_global ? (d.p1 + d.seg1 - 1) / d.seg1 : 0);
  return sizeof(float) *
         ((size_t)rows * d.n1 + (size_t)d.k2 * (d.ncross + 2) * d.nt);
}

// B's checkpoints go to device memory where its shared memory would not fit.
void place_checkpoints(Dims& d) {
  d.ck_global = 0;
  if (smem_b(d) > kSmemLimit) d.ck_global = 1;
}

template <typename T, int NT>
cudaError_t launch_out(const void* x, const void* g, const float* b_in,
                       const float* core, const float* b_out,
                       const int* idx_in, const int* idx_out, float* gsel,
                       float* pa, const Dims& d, cudaStream_t stream) {
  const size_t smem = smem_a(d);
  auto kernel = sandwich_bwd_out_kernel<T, NT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<d.chunks_a * NT, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), b_in, core, b_out,
      idx_in, idx_out, gsel, pa, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* g, const float* b_in,
                   const float* core, const float* b_out, const int* idx_in,
                   const int* idx_out, void* dx, float* db_in, float* dcore,
                   float* db_out, float* gsel, float* pa, float* pb, Dims d,
                   cudaStream_t stream) {
  if (smem_a(d) > kSmemLimit || smem_b(d) > kSmemLimit)
    return cudaErrorInvalidValue;
#define SANDWICH_BWD_NT(NT)                                                \
  case NT:                                                                 \
    err = launch_out<T, NT>(x, g, b_in, core, b_out, idx_in, idx_out, gsel, \
                            pa, d, stream);                                \
    break;
  cudaError_t err;
  switch (d.nt) {
    SANDWICH_BWD_NT(1)
    SANDWICH_BWD_NT(2)
    SANDWICH_BWD_NT(4)
    SANDWICH_BWD_NT(8)
    SANDWICH_BWD_NT(16)
    SANDWICH_BWD_NT(32)
    SANDWICH_BWD_NT(64)
    default:
      return cudaErrorInvalidValue;
  }
#undef SANDWICH_BWD_NT
  if (err != cudaSuccess) return err;
  const size_t smem = smem_b(d);
  err = set_smem(sandwich_bwd_in_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  sandwich_bwd_in_kernel<T><<<d.chunks_b, kThreads, smem, stream>>>(
      static_cast<const T*>(x), b_in, core, b_out, idx_in, idx_out, gsel,
      static_cast<T*>(dx), pb, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)2 * d.p1 * d.n1 + (size_t)d.k1 * d.k2 +
                       (size_t)2 * (d.log_tile + d.ncross) * d.n2;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  sandwich_bwd_reduce_kernel<<<blocks < 4096 ? blocks : 4096, kThreads, 0,
                               stream>>>(pa, pb, idx_out, db_in, dcore,
                                         db_out, d);
  return cudaGetLastError();
}

}  // namespace

// Workspace sizes in floats for the given shape and chunk counts: gsel
// (rows·k2·tiles), the output-side partials (chunks_a·tiles blocks) and the
// input-side partials (chunks_b blocks). Returns 0, or cudaErrorInvalidValue
// for a shape the kernel does not take.
extern "C" int sandwich_bwd_workspace(int rows, int n1, int k1, int k2,
                                      int n2, int chunks_a, int chunks_b,
                                      long long* sizes) {
  const int p1 = log2_exact(n1), p2 = log2_exact(n2);
  if (p1 < 1 || p2 < 1 || n1 > kMaxN1 || n2 > kTile * kMaxTiles || k1 < 1 ||
      k1 > kMaxK || k2 < 1 || k2 > kMaxK)
    return cudaErrorInvalidValue;
  Dims d{};
  d.n1 = n1, d.p1 = p1, d.k1 = k1, d.k2 = k2, d.n2 = n2;
  d.tile = n2 < kTile ? n2 : kTile;
  d.log_tile = log2_exact(d.tile);
  d.nt = n2 / d.tile;
  d.ncross = p2 - d.log_tile;
  d.seg1 = default_seg(p1);
  place_checkpoints(d);
  sizes[0] = (long long)rows * k2 * d.nt;
  sizes[1] = (long long)chunks_a * d.nt * part_a(d);
  sizes[2] = (long long)chunks_b * part_b(d);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, g, dx); weights and their gradients
// are float32. gsel, pa, pb: workspaces of the sizes above. Returns the
// cudaError_t of the launches (0 on success).
extern "C" int sandwich_bwd(const void* x, const float* b_in,
                            const float* core, const float* b_out,
                            const int* idx_in, const int* idx_out,
                            const void* g, void* dx, float* db_in,
                            float* dcore, float* db_out, float* gsel,
                            float* pa, float* pb, int rows, int n_in, int n1,
                            int k1, int k2, int n2, int n_out, int chunks_a,
                            int chunks_b, float scale_in, float scale_out,
                            int dtype, void* stream) {
  const int p1 = log2_exact(n1), p2 = log2_exact(n2);
  if (p1 < 1 || p2 < 1 || n1 > kMaxN1 || n2 > kTile * kMaxTiles || k1 < 1 ||
      k1 > kMaxK || k2 < 1 || k2 > kMaxK || n_in > n1 || n_out > n2 ||
      rows < 1 || chunks_a < 1 || chunks_a > rows || chunks_b < 1 ||
      chunks_b > rows)
    return cudaErrorInvalidValue;
  Dims d{};
  d.rows = rows, d.n_in = n_in, d.n1 = n1, d.p1 = p1, d.k1 = k1, d.k2 = k2;
  d.n2 = n2, d.n_out = n_out;
  d.tile = n2 < kTile ? n2 : kTile;
  d.log_tile = log2_exact(d.tile);
  d.nt = n2 / d.tile;
  d.ncross = p2 - d.log_tile;
  d.seg1 = default_seg(p1);
  d.seg2 = default_seg(d.log_tile);
  place_checkpoints(d);
  d.chunks_a = chunks_a, d.chunks_b = chunks_b;
  d.scale_in = scale_in, d.scale_out = scale_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g, b_in, core, b_out, idx_in, idx_out, dx, db_in,
                         dcore, db_out, gsel, pa, pb, d, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, b_in, core, b_out, idx_in, idx_out,
                                 dx, db_in, dcore, db_out, gsel, pa, pb, d,
                                 s);
  return cudaErrorInvalidValue;
}
