// Butterfly-sandwich backward for Hopper (sm_90a), as products with the
// truncated factors.
//
// Replaces the TPU kernel `_sandwich_bwd_kernel` in
// src/repro/kernels/sandwich.py (entry `_sandwich_bwd_call`, reached from
// the custom VJP `_sandwich_diff_bwd`). The forward is
//
//     out = F_outᵀ · rnd_T((core · h1) · scale_out),
//     h1 = rnd_T(F_in · x) · scale_in,
//
// with F_in = B_in[idx_in, :n_in] (k1 x n_in) and F_out = B_out[idx_out,
// :n_out] (k2 x n_out), rows of the butterflies built from the weights
// rounded to T. Given x, the cotangent g of the output and the weights, the
// VJP at the reference's rounding points is
//
//     gz = rnd_T(g · F_outᵀ)            ((B_out g)[idx_out], k2 a row)
//     dh2 = gz · scale_out,   d core = Σ_rows dh2ᵀ h1,   dh1 = dh2 · core
//     du = rnd_T(dh1 · scale_in),   dx = rnd_T(du · F_in)
//     dF_out = Σ_rows zᵀ g,   dF_in = Σ_rows duᵀ x
//
// and d b_in, d b_out are the VJPs of the factor construction, the
// transposed butterfly on k one-hot rows, with the cotangents dF_in, dF_out
// (zero past n_in and n_out). By linearity that is the weight gradient of
// the stage chains over all rows, in another summation order; as in the
// reference it is float32 and taken w.r.t. the weights rounded to T.
//
// Six kernels, on the current stream, no atomics, fixed summation orders
// (two launches give the same bits):
// 0. `sandwich_factors_kernel` (sandwich_factors.cuh, the forward's) builds
//    F_in and F_out again from the saved weights into the workspace: one
//    ~6 µs launch, simpler than keeping the forward's alive across remat.
// 1. `sandwich_bwd_rows_kernel`, one block per tile of kBM rows: h1 and z
//    recomputed by products with the factors, gz, dh2, du, dx (stored), the
//    tile's partial of d core, and per row z and du (in T) for kernel 2.
//    The three products stream row and factor chunks through a cp.async
//    ring. In bfloat16 they run on tensor cores (`mma.sync.m16n8k16`): x, g
//    and du are bfloat16 exactly and the factors enter as their bfloat16
//    hi/lo pair, which the factor kernel writes too, so each product is
//    exact in float32 and only the order of the float32 sums differs. In
//    float32 they run on CUDA cores in 4 x 4 register blocks, each thread's
//    share a super-chunk at a time (a blocked sum: the head's gz sums
//    49,152 terms a row).
// 2. `sandwich_bwd_cols_kernel` (float32) or `sandwich_bwd_cols_mma_kernel`
//    (bfloat16, tensor cores, exact products as above), one block per
//    (column tile, row split) of each factor: dF[m][c] = Σ_r V[r][m]
//    A[r][c] over the split's rows, rows streamed through a cp.async ring,
//    written as the split's partial.
// 3. `sandwich_bwd_sum_kernel` adds the splits' partials in split order,
//    over the whole card.
// 4. `sandwich_bwd_vjp_kernel`, one block per factor row: the transposed
//    butterfly's VJP on its one-hot row. Its stage inputs are one path wide
//    until they fan out (stage s's input is nonzero only where the low s+1
//    bits are those of idx), so the forward sweep stores them in n - 1
//    floats and each dual stage touches only that support: per stage s the
//    row's da and db are nonzero on 2^(p-1-s) positions, written compactly.
//    The cotangent and the stage inputs sit in shared memory up to n =
//    kVjpSmemN, in the workspace above it.
// 5. `sandwich_bwd_reduce_kernel`: each weight-gradient element sums, over
//    the factor rows in order, the compact entries of the rows whose
//    support holds it; d core sums the row tiles' partials, a warp an
//    element, in a fixed order.
//
// What bounds it on the H100: bytes. k <= 64, so every output element
// takes at most 64 multiply-adds: at the head (8192 x 49,152, k2 = 16) the
// two long products are 2 x 6.4 G FMA (~0.4 ms on CUDA cores, a few µs on
// tensor cores) against 0.8 GB of activations (0.24 ms at 3.35 TB/s); x
// and g are read twice (kernels 1 and 2). On the card a row block is bound
// by what one SM takes in (~16 KB a 0.6 µs chunk), half of which are
// factor chunks every row tile reads again. The factor VJP is O(k · n) and
// kernel 5 O(k · p · n) comparisons.

#include <cstdint>
#include <type_traits>

#include "sandwich_common.cuh"
#include "sandwich_factors.cuh"

namespace {

using namespace sandwich;

constexpr int kBM = 32;            // rows per row tile
constexpr int kMT = kBM / 16;      // its tensor-core row tiles
constexpr int kKC = 128;           // K chunk of the row products (elements)
constexpr int kDeepRing = 4;       // the row kernel's cp.async ring depth
constexpr int kShallowRing = 2;    // ... where the deep ring does not fit
constexpr int kSuper = 8;          // chunks summed apart, then added
constexpr int kBN = 128;           // dx columns per chunk
constexpr int kPadK = 16;          // factor rows padded to a multiple
constexpr int kColRows = 16;       // rows per column-kernel ring chunk
constexpr int kMmaColRows = 32;    // ... on tensor cores (two k-steps)
constexpr int kColRing = 3;        // its cp.async ring depth
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kVjpSmemN = 16384;   // widest factor row whose VJP runs in
                                   // shared memory (2 x 64 KB)
constexpr int kMaxN2 = kTile * kMaxTiles;

struct Dims {
  int rows, n_in, n1, p1, k1, kp1, ld1;
  int n_out, n2, p2, k2, kp2, ld2;
  int bf16;             // x's dtype: the tensor-core routes
  int tiles;            // row tiles of kernel 1
  int ct1, ct2;         // column tiles of kernel 2, in and out
  int nsplit;           // row splits of kernel 2
  float scale_in, scale_out;
};

// Threads of one factor-row group of the column kernel (kp / 16 groups,
// whole warps) and the block's columns, 4 a thread.
__host__ __device__ inline int col_threads(int kp) {
  return (kThreads / (kp / 16)) & ~31;
}
__host__ __device__ inline int col_width(int kp) { return 4 * col_threads(kp); }
// bytes of one column-kernel ring chunk: kColRows rows of A and of V
__host__ __device__ inline int col_stage(int kp) {
  return kColRows * col_width(kp) * 4 + kColRows * kp * 4;
}
// The bfloat16 column kernel: warp w takes factor rows 16(w % (kp/16)) ..
// +15 and 32 columns, so a block's tile is 32 · (8 / (kp/16)) columns. A
// ring chunk holds kMmaColRows rows of A and of V, rows padded by 8
// elements (ldmatrix rows on distinct banks).
__host__ __device__ inline int mma_col_width(int kp) {
  return 32 * (8 / (kp / 16));
}
__host__ __device__ inline int mma_col_stage(int kp) {
  return kMmaColRows * (mma_col_width(kp) + 8) * 2 + kMmaColRows * (kp + 8) * 2;
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Floats of one split's column partials: (kp1, ld1) then (kp2, ld2).
__host__ __device__ inline size_t split_floats(const Dims& d) {
  return (size_t)d.kp1 * d.ld1 + (size_t)d.kp2 * d.ld2;
}

// Shared-memory plan of the row kernel (bytes), host and device alike.
// float32: A chunks in float, factor chunks float (CUDA cores); bfloat16: A
// chunks in bfloat16 and the factors' hi/lo pairs (tensor cores), rows
// padded by 8 elements so that ldmatrix's rows fall on distinct banks.
struct RowPlan {
  int a_ld;      // row stride of the ring's A chunk (elements of T)
  int f_ld;      // row stride of the ring's factor chunk (elements)
  int fa_off;    // bytes from a ring slot to its factor chunk
  int slot;      // bytes of one product ring slot
  int fo_ld;     // row stride of the dx ring's F_in chunk (elements)
  int dslot;     // bytes of one dx ring slot
  int h1_ld, z_ld;  // strides of the per-row k vectors (floats)
  int duh_ld;    // stride of du in bfloat16, the dx product's A operand
  int core_off, h1_off, z_off, dh2_off, du_off, duh_off, pipe_off, total;
};

// K groups of the bfloat16 products: 8 warps over kMT row tiles x kp/16
// factor-row pairs
__host__ __device__ inline int mma_ksplit(int kp) {
  const int units = kMT * (kp / 16);
  return units >= 8 ? 1 : 8 / units;
}

template <typename T, int R>
__host__ __device__ inline RowPlan row_plan(int k1, int k2, int kp1, int kp2) {
  constexpr bool f32 = std::is_same<T, float>::value;
  RowPlan p;
  const int kp = kp1 > kp2 ? kp1 : kp2;
  p.a_ld = kKC + (f32 ? 4 : 8);
  // float32: a warp's factor rows on distinct banks; bfloat16: ldmatrix rows
  p.f_ld = kKC + (f32 ? 4 : 8);
  p.fa_off = round16(kBM * p.a_ld * (int)sizeof(T));
  p.slot = p.fa_off + (f32 ? round16(kp * p.f_ld * 4)
                           : 2 * round16(kp * p.f_ld * 2));
  p.fo_ld = kBN + (f32 ? 4 : 8);
  p.dslot = f32 ? round16(kp1 * p.fo_ld * 4) : 2 * round16(kp1 * p.fo_ld * 2);
  p.h1_ld = kp1 + 1;
  p.z_ld = kp2 + 1;
  p.duh_ld = kp1 + 8;
  p.core_off = 0;
  p.h1_off = round16(k1 * k2 * 4);
  p.z_off = p.h1_off + round16(kBM * p.h1_ld * 4);
  p.dh2_off = p.z_off + round16(kBM * p.z_ld * 4);
  p.du_off = p.dh2_off + round16(kBM * p.z_ld * 4);
  p.duh_off = p.du_off + round16(kBM * p.h1_ld * 4);
  p.pipe_off = p.duh_off + (f32 ? 0 : round16(kBM * p.duh_ld * 2));
  const int red = f32 ? kBM * kp * 4 * (kThreads / (2 * kp))  // K groups
                      : kBM * kp * 4 * mma_ksplit(kp);
  int pipe = R * p.slot;
  if (R * p.dslot > pipe) pipe = R * p.dslot;
  if (red > pipe) pipe = red;
  p.total = p.pipe_off + pipe;
  return p;
}

// out[r][m] = Σ_{c<n} A[row0 + r][c] · F[m][c] for the block's kBM rows
// (rows past `rows` give 0) and m < kp; A (rows, n) and F (kp, ldf)
// float32, F zero past n (the float32 route, on CUDA cores). A and F
// stream in chunks of kKC columns through a ring of R; thread (kg, rq, mq)
// sums rows rq + 8u and factor rows mq + (kp/4)v (a warp's factor rows on
// distinct banks) over every groups-th 4-column step of a chunk, each
// super-chunk of kSuper chunks apart and then into its running sum, and
// the K groups' sums are added in group order. Ends with a barrier.
template <int R>
__device__ void dot_rows(const float* __restrict__ A, int rows, int n,
                         int row0, const float* __restrict__ F, int ldf,
                         int kp, char* pipe, const RowPlan& P, float* out,
                         int out_ld, bool vec) {
  using T = float;
  constexpr int vw = 4;
  const int tid = threadIdx.x;
  const int nk = (n + kKC - 1) / kKC;
  auto slot_a = [&](int s) {
    return reinterpret_cast<T*>(pipe + (size_t)s * P.slot);
  };
  auto slot_f = [&](int s) {
    return reinterpret_cast<float*>(pipe + (size_t)s * P.slot + P.fa_off);
  };
  auto load = [&](int s, int c) {
    T* as = slot_a(s);
    float* fs = slot_f(s);
    const int c0 = c * kKC;
    if (vec) {
      constexpr int segs = kKC / vw;
      for (int e = tid; e < kBM * segs; e += kThreads) {
        const int r = e / segs, col = c0 + (e % segs) * vw;
        const bool ok = row0 + r < rows && col < n;
        cp_async16(as + r * P.a_ld + (e % segs) * vw,
                   ok ? A + (size_t)(row0 + r) * n + col : A, ok);
      }
    } else {
      for (int e = tid; e < kBM * kKC; e += kThreads) {
        const int r = e / kKC, col = c0 + e % kKC;
        as[r * P.a_ld + e % kKC] = row0 + r < rows && col < n
            ? A[(size_t)(row0 + r) * n + col] : from_f32<T>(0.f);
      }
    }
    constexpr int fsegs = kKC / 4;
    for (int e = tid; e < kp * fsegs; e += kThreads) {
      const int r = e / fsegs, sg = e % fsegs;
      cp_async16(fs + r * P.f_ld + sg * 4, F + (size_t)r * ldf + c0 + sg * 4,
                 true);
    }
  };
  for (int s = 0; s < R - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int quads = kp / 4, per = 8 * quads, groups = kThreads / per;
  const int kg = tid / per, rq = tid % 8, mq = (tid / 8) % quads;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = part[u][v] = 0.f;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<R - 2>();
    __syncthreads();
    if (c + R - 1 < nk) load((c + R - 1) % R, c + R - 1);
    cp_async_commit();
    const T* as = slot_a(c % R);
    const float* fs = slot_f(c % R);
    for (int q = 4 * kg; kg < groups && q < kKC; q += 4 * groups) {
      float4 xv[4], fv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xv[u] = *reinterpret_cast<const float4*>(as + (rq + 8 * u) * P.a_ld +
                                                 q);
        fv[u] = *reinterpret_cast<const float4*>(fs + (mq + quads * u) * P.f_ld
                                                 + q);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          part[u][v] += xv[u].x * fv[v].x;
          part[u][v] += xv[u].y * fv[v].y;
          part[u][v] += xv[u].z * fv[v].z;
          part[u][v] += xv[u].w * fv[v].w;
        }
    }
    if ((c + 1) % kSuper == 0 || c + 1 == nk) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] += part[u][v];
          part[u][v] = 0.f;
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(pipe);  // [groups][kBM][kp]
  if (kg < groups) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[(kg * kBM + rq + 8 * u) * kp + mq + quads * v] = acc[u][v];
  }
  __syncthreads();
  for (int e = tid; e < kBM * kp; e += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += red[g * kBM * kp + e];
    out[(e / kp) * out_ld + e % kp] = sum;
  }
  __syncthreads();
}

// dot_rows for bfloat16 A on tensor cores: F enters as its hi/lo pair
// (Fhl: hi rows 0..kp-1, lo rows kp..2kp-1, row stride ldf), both products
// exact in float32, so the result differs from float32 FMAs only in the
// order of the sums. The work is items (unit, K group) of a unit (row tile
// mt, factor-row pair np) and a K group kg, which takes the k-steps kg, kg +
// ksplit, ...; warp w takes items w and w + 8, and the K groups' sums are
// added in group order. Ends with a barrier.
template <int R>
__device__ void dot_rows_mma(const __nv_bfloat16* __restrict__ A, int rows,
                             int n, int row0,
                             const __nv_bfloat16* __restrict__ Fhl, int ldf,
                             int kp, char* pipe, const RowPlan& P, float* out,
                             int out_ld, bool vec) {
  using T = __nv_bfloat16;
  constexpr int vw = 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = (n + kKC - 1) / kKC;
  auto slot_a = [&](int s) {
    return reinterpret_cast<T*>(pipe + (size_t)s * P.slot);
  };
  auto slot_f = [&](int s) {
    return reinterpret_cast<T*>(pipe + (size_t)s * P.slot + P.fa_off);
  };
  auto load = [&](int s, int c) {
    T* as = slot_a(s);
    T* fs = slot_f(s);
    const int c0 = c * kKC;
    constexpr int segs = kKC / vw;
    if (vec) {
      for (int e = tid; e < kBM * segs; e += kThreads) {
        const int r = e / segs, col = c0 + (e % segs) * vw;
        const bool ok = row0 + r < rows && col < n;
        cp_async16(as + r * P.a_ld + (e % segs) * vw,
                   ok ? A + (size_t)(row0 + r) * n + col : A, ok);
      }
    } else {
      for (int e = tid; e < kBM * kKC; e += kThreads) {
        const int r = e / kKC, col = c0 + e % kKC;
        as[r * P.a_ld + e % kKC] = row0 + r < rows && col < n
            ? A[(size_t)(row0 + r) * n + col] : from_f32<T>(0.f);
      }
    }
    for (int e = tid; e < 2 * kp * segs; e += kThreads) {   // hi, then lo
      const int r = e / segs, sg = e % segs;
      cp_async16(fs + r * P.f_ld + sg * vw,
                 Fhl + (size_t)r * ldf + c0 + sg * vw, true);
    }
  };
  for (int s = 0; s < R - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // items (unit, K group): unit = (row tile mt, factor-row pair np); warp
  // w takes items w and w + 8
  const int units = kMT * (kp / 16), ksplit = mma_ksplit(kp);
  const int items = units * ksplit;
  const int mat = lane >> 3, i8 = lane & 7;
  float acc[2][2][4];
#pragma unroll
  for (int it = 0; it < 2; ++it)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[it][j][v] = 0.f;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<R - 2>();
    __syncthreads();
    if (c + R - 1 < nk) load((c + R - 1) % R, c + R - 1);
    cp_async_commit();
    const T* as = slot_a(c % R);
    const T* fh = slot_f(c % R);
    const T* fl = fh + kp * P.f_ld;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int item = warp + 8 * it;
      if (item >= items) break;
      const int unit = item % units, kg = item / units;
      const int mt = unit % kMT, np = unit / kMT;
      for (int ks = kg; ks < kKC / 16; ks += ksplit) {
        uint32_t a[4], bh[4], bl[4];
        ldmatrix_x4(a, as + (16 * mt + (mat & 1) * 8 + i8) * P.a_ld +
                           16 * ks + (mat >> 1) * 8);
        const int off = (16 * np + (mat >> 1) * 8 + i8) * P.f_ld + 16 * ks +
                        (mat & 1) * 8;
        ldmatrix_x4(bh, fh + off);
        ldmatrix_x4(bl, fl + off);
        mma_bf16(acc[it][0], a, bh[0], bh[1]);
        mma_bf16(acc[it][1], a, bh[2], bh[3]);
        mma_bf16(acc[it][0], a, bl[0], bl[1]);
        mma_bf16(acc[it][1], a, bl[2], bl[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(pipe);  // [ksplit][kBM][kp]
  const int g = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int item = warp + 8 * it;
    if (item >= items) break;
    const int unit = item % units, kg = item / units;
    const int mt = unit % kMT, np = unit / kMT;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 16 * mt + g, m = 16 * np + 8 * j + 2 * tg;
      float* o = red + (kg * kBM + r) * kp + m;
      o[0] = acc[it][j][0];
      o[1] = acc[it][j][1];
      o[8 * kp] = acc[it][j][2];
      o[8 * kp + 1] = acc[it][j][3];
    }
  }
  __syncthreads();
  for (int e = tid; e < kBM * kp; e += kThreads) {
    float sum = 0.f;
    for (int g = 0; g < ksplit; ++g) sum += red[g * kBM * kp + e];
    out[(e / kp) * out_ld + e % kp] = sum;
  }
  __syncthreads();
}

// -- kernel 1: per row tile -------------------------------------------------

template <typename T, int R>
__global__ void __launch_bounds__(kThreads) sandwich_bwd_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ g,
    const float* __restrict__ core, const float* __restrict__ f_in,
    const float* __restrict__ f_out, const __nv_bfloat16* __restrict__ hl_in,
    const __nv_bfloat16* __restrict__ hl_out, T* __restrict__ dx,
    T* __restrict__ rowbuf, float* __restrict__ pcore, Dims d, int vec_x,
    int vec_g, int vec_dx) {
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) char smem[];
  const RowPlan P = row_plan<T, R>(d.k1, d.k2, d.kp1, d.kp2);
  float* core_s = reinterpret_cast<float*>(smem + P.core_off);
  float* h1 = reinterpret_cast<float*>(smem + P.h1_off);
  float* z = reinterpret_cast<float*>(smem + P.z_off);
  float* dh2 = reinterpret_cast<float*>(smem + P.dh2_off);
  float* du = reinterpret_cast<float*>(smem + P.du_off);
  __nv_bfloat16* duh = reinterpret_cast<__nv_bfloat16*>(smem + P.duh_off);
  char* pipe = smem + P.pipe_off;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kBM;
  const int k1 = d.k1, k2 = d.k2;
  for (int i = tid; i < k1 * k2; i += kThreads) core_s[i] = core[i];

  // h1 = rnd_T(x · F_inᵀ) · scale_in (the barrier at its end publishes
  // core_s too)
  if constexpr (f32)
    dot_rows<R>(x, d.rows, d.n_in, row0, f_in, d.ld1, d.kp1, pipe, P, h1,
                P.h1_ld, vec_x);
  else
    dot_rows_mma<R>(x, d.rows, d.n_in, row0, hl_in, d.ld1, d.kp1, pipe, P,
                    h1, P.h1_ld, vec_x);
  for (int e = tid; e < kBM * d.kp1; e += kThreads) {
    float* v = h1 + (e / d.kp1) * P.h1_ld + e % d.kp1;
    *v = e % d.kp1 < k1 ? rnd<T>(*v) * d.scale_in : 0.f;
  }
  __syncthreads();
  // z = rnd_T((h1 · coreᵀ) · scale_out), as the forward rounds it
  for (int e = tid; e < kBM * d.kp2; e += kThreads) {
    const int r = e / d.kp2, m = e % d.kp2;
    float v = 0.f;
    if (m < k2) {
      float acc = 0.f;
      for (int i = 0; i < k1; ++i)
        acc += core_s[m * k1 + i] * h1[r * P.h1_ld + i];
      v = rnd<T>(acc * d.scale_out);
    }
    z[r * P.z_ld + m] = v;
  }
  // gz = rnd_T(g · F_outᵀ); dh2 = gz · scale_out
  if constexpr (f32)
    dot_rows<R>(g, d.rows, d.n_out, row0, f_out, d.ld2, d.kp2, pipe, P, dh2,
                P.z_ld, vec_g);
  else
    dot_rows_mma<R>(g, d.rows, d.n_out, row0, hl_out, d.ld2, d.kp2, pipe, P,
                    dh2, P.z_ld, vec_g);
  for (int e = tid; e < kBM * d.kp2; e += kThreads) {
    float* v = dh2 + (e / d.kp2) * P.z_ld + e % d.kp2;
    *v = e % d.kp2 < k2 ? rnd<T>(*v) * d.scale_out : 0.f;
  }
  __syncthreads();
  // du = rnd_T((dh2 · core) · scale_in); the tile's d core = Σ_r dh2ᵀ h1;
  // z and du of each row for the column kernel
  for (int e = tid; e < kBM * d.kp1; e += kThreads) {
    const int r = e / d.kp1, i = e % d.kp1;
    float v = 0.f;
    if (i < k1) {
      float acc = 0.f;
      for (int m = 0; m < k2; ++m)
        acc += dh2[r * P.z_ld + m] * core_s[m * k1 + i];
      v = rnd<T>(acc * d.scale_in);
    }
    du[r * P.h1_ld + i] = v;
    if constexpr (!f32) duh[r * P.duh_ld + i] = __float2bfloat16_rn(v);
  }
  float* pc = pcore + (size_t)blockIdx.x * k1 * k2;
  for (int e = tid; e < k1 * k2; e += kThreads) {
    const int m = e / k1, i = e % k1;
    float acc = 0.f;
    for (int r = 0; r < kBM; ++r)
      acc += dh2[r * P.z_ld + m] * h1[r * P.h1_ld + i];
    pc[e] = acc;
  }
  __syncthreads();
  const int vld = d.kp1 + d.kp2;
  for (int e = tid; e < kBM * vld; e += kThreads) {
    const int r = e / vld, m = e % vld;
    if (row0 + r >= d.rows) break;
    rowbuf[(size_t)(row0 + r) * vld + m] = from_f32<T>(
        m < d.kp1 ? du[r * P.h1_ld + m] : z[r * P.z_ld + m - d.kp1]);
  }

  // dx = rnd_T(du · F_in) over chunks of kBN columns
  const int warp = tid >> 5, lane = tid & 31;
  const int chunks = (d.n_in + kBN - 1) / kBN;
  auto slot = [&](int s) { return pipe + (size_t)s * P.dslot; };
  auto load = [&](int s, int c) {
    if constexpr (f32) {
      float* fs = reinterpret_cast<float*>(slot(s));
      constexpr int segs = kBN / 4;
      for (int e = tid; e < d.kp1 * segs; e += kThreads) {
        const int r = e / segs, sg = e % segs;
        cp_async16(fs + r * P.fo_ld + sg * 4,
                   f_in + (size_t)r * d.ld1 + c * kBN + sg * 4, true);
      }
    } else {
      __nv_bfloat16* fs = reinterpret_cast<__nv_bfloat16*>(slot(s));
      constexpr int segs = kBN / 8;
      for (int e = tid; e < 2 * d.kp1 * segs; e += kThreads) {  // hi, lo
        const int r = e / segs, sg = e % segs;
        cp_async16(fs + r * P.fo_ld + sg * 8,
                   hl_in + (size_t)r * d.ld1 + c * kBN + sg * 8, true);
      }
    }
  };
  __syncthreads();                              // the ring is free again
  for (int s = 0; s < R - 1; ++s) {
    if (s < chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<R - 2>();
    __syncthreads();
    if (c + R - 1 < chunks) load((c + R - 1) % R, c + R - 1);
    cp_async_commit();
    if constexpr (f32) {
      // thread: rows 4·warp .. +3, columns 4·lane .. +3 of the chunk
      const float* fs = reinterpret_cast<const float*>(slot(c % R));
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[a][v] = 0.f;
      for (int m = 0; m < k1; ++m) {
        const float4 fv =
            *reinterpret_cast<const float4*>(fs + m * P.fo_ld + 4 * lane);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float u = du[(4 * warp + a) * P.h1_ld + m];
          acc[a][0] += u * fv.x;
          acc[a][1] += u * fv.y;
          acc[a][2] += u * fv.z;
          acc[a][3] += u * fv.w;
        }
      }
      const int gc = c * kBN + 4 * lane;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int gr = row0 + 4 * warp + a;
        if (gr >= d.rows || gc >= d.n_in) break;
        float* o = reinterpret_cast<float*>(dx) + (size_t)gr * d.n_in + gc;
        if (vec_dx) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (gc + v < d.n_in) o[v] = acc[a][v];
        }
      }
    } else {
      // tensor cores, as the forward's product 3: unit u = (rows 16·(u %
      // kMT) .. +15, columns 32·(u / kMT) .. +31 of the chunk), warp w
      // takes units w and w + 8; du (exact in bfloat16) by F_in's hi and lo
      const __nv_bfloat16* fh =
          reinterpret_cast<const __nv_bfloat16*>(slot(c % R));
      const __nv_bfloat16* fl = fh + d.kp1 * P.fo_ld;
      const int mat = lane >> 3, i8 = lane & 7, gq = lane >> 2, tg = lane & 3;
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int u = warp + 8 * it;
        if (u >= kMT * (kBN / 32)) break;
        const int mt = u % kMT, q = u / kMT;
        float acc[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
        for (int ks = 0; ks < d.kp1 / 16; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, duh + (16 * mt + (mat & 1) * 8 + i8) * P.duh_ld +
                             16 * ks + (mat >> 1) * 8);
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const int off = (16 * ks + (mat & 1) * 8 + i8) * P.fo_ld +
                            32 * q + 16 * pp + (mat >> 1) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, fh + off);
            ldmatrix_x4_trans(bl, fl + off);
            mma_bf16(acc[2 * pp], a, bh[0], bh[1]);
            mma_bf16(acc[2 * pp + 1], a, bh[2], bh[3]);
            mma_bf16(acc[2 * pp], a, bl[0], bl[1]);
            mma_bf16(acc[2 * pp + 1], a, bl[2], bl[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gc = c * kBN + 32 * q + 8 * j + 2 * tg;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = row0 + 16 * mt + gq + 8 * h;
            if (gr >= d.rows || gc >= d.n_in) continue;
            T* o = dx + (size_t)gr * d.n_in + gc;
            if (vec_dx) {
              *reinterpret_cast<uint32_t*>(o) =
                  pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
            } else {
              o[0] = from_f32<T>(acc[j][2 * h]);
              if (gc + 1 < d.n_in) o[1] = from_f32<T>(acc[j][2 * h + 1]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
}

// -- kernel 2: the factors' cotangents, per column tile and row split ------

// Block b: split b / (ct1 + ct2), then column tile t of dF_in (t < ct1) or
// of dF_out. dF[m][c] = Σ_r V[r][m] A[r][c] over the split's rows, with
// (A, V) = (x, du) or (g, z); thread (mg, cq) holds factor rows 16mg .. +15
// and columns 4cq .. +3 of the tile. Chunks of kColRows rows of A (the
// tile's columns) and V stream through a cp.async ring; rows past the split
// and columns past n arrive as zeros. The partial goes to dfp[split] laid
// out as (kp1, ld1) then (kp2, ld2), columns below n only (kernel 3 reads
// no others).
__global__ void __launch_bounds__(kThreads) sandwich_bwd_cols_kernel(
    const float* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ rowbuf, float* __restrict__ dfp, Dims d,
    int vec_x, int vec_g) {
  using T = float;
  extern __shared__ __align__(16) char csm[];
  constexpr int vw = 4;
  const int tid = threadIdx.x;
  const int tiles = d.ct1 + d.ct2;
  const int sp = blockIdx.x / tiles;
  int t = blockIdx.x % tiles;
  const bool is_in = t < d.ct1;
  if (!is_in) t -= d.ct1;
  const T* A = is_in ? x : g;
  const int n = is_in ? d.n_in : d.n_out;
  const int kp = is_in ? d.kp1 : d.kp2, ld = is_in ? d.ld1 : d.ld2;
  const int voff = is_in ? 0 : d.kp1, vld = d.kp1 + d.kp2;
  const bool vec = is_in ? vec_x : vec_g;
  const int per = col_threads(kp), cw = col_width(kp);
  const int c0 = t * cw, c = c0 + 4 * (tid % per);
  // threads past the factor rows or the columns only load and meet the
  // barriers (their partial columns stay 0: the sum reads c < n only)
  const bool active = tid / per < kp / 16 && c < n;
  const int mg = active ? tid / per : 0, cq = tid % per;
  const int r0 = (int)((long long)sp * d.rows / d.nsplit);
  const int r1 = (int)((long long)(sp + 1) * d.rows / d.nsplit);
  const int nk = (r1 - r0 + kColRows - 1) / kColRows;
  const int abytes = kColRows * cw * (int)sizeof(T);
  auto slot_a = [&](int s) {
    return reinterpret_cast<T*>(csm + (size_t)s * col_stage(kp));
  };
  auto slot_v = [&](int s) {
    return reinterpret_cast<float*>(csm + (size_t)s * col_stage(kp) +
                                    abytes);
  };
  auto load = [&](int s, int k) {
    T* as = slot_a(s);
    float* vs = slot_v(s);
    const int rb = r0 + k * kColRows;
    if (vec) {
      const int segs = cw / vw;
      for (int e = tid; e < kColRows * segs; e += kThreads) {
        const int r = e / segs, col = c0 + (e % segs) * vw;
        const bool ok = rb + r < r1 && col < n;
        cp_async16(as + r * cw + (e % segs) * vw,
                   ok ? A + (size_t)(rb + r) * n + col : A, ok);
      }
    } else {
      for (int e = tid; e < kColRows * cw; e += kThreads) {
        const int r = e / cw, col = c0 + e % cw;
        as[e] = rb + r < r1 && col < n ? A[(size_t)(rb + r) * n + col]
                                       : from_f32<T>(0.f);
      }
    }
    const int vsegs = kp / 4;
    for (int e = tid; e < kColRows * vsegs; e += kThreads) {
      const int r = e / vsegs, sg = e % vsegs;
      const bool ok = rb + r < r1;
      cp_async16(vs + r * kp + sg * 4,
                 ok ? rowbuf + (size_t)(rb + r) * vld + voff + sg * 4
                    : rowbuf, ok);
    }
  };
  for (int s = 0; s < kColRing - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  float acc[16][4];
#pragma unroll
  for (int m = 0; m < 16; ++m)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[m][v] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kColRing - 2>();
    __syncthreads();
    if (k + kColRing - 1 < nk) load((k + kColRing - 1) % kColRing,
                                    k + kColRing - 1);
    cp_async_commit();
    const T* as = slot_a(k % kColRing);
    const float* vs = slot_v(k % kColRing);
    if (active) {
#pragma unroll 4
      for (int r = 0; r < kColRows; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(as + r * cw + 4 * cq);
        const float* vr = vs + r * kp + 16 * mg;
#pragma unroll
        for (int m4 = 0; m4 < 4; ++m4) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 4 * m4);
          const float wm[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[4 * m4 + j][0] += wm[j] * a.x;
            acc[4 * m4 + j][1] += wm[j] * a.y;
            acc[4 * m4 + j][2] += wm[j] * a.z;
            acc[4 * m4 + j][3] += wm[j] * a.w;
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = dfp + (size_t)sp * split_floats(d) +
               (is_in ? 0 : (size_t)d.kp1 * d.ld1);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    float* o = out + (size_t)(16 * mg + m) * ld + c;
    if (c + 3 < ld) {
      *reinterpret_cast<float4*>(o) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (c + v < ld) o[v] = acc[m][v];
    }
  }
}

// The column kernel for bfloat16 on tensor cores: dF (m x c) += Vᵀ (m x r) ·
// A (r x c) a k-step of 16 rows at a time, Vᵀ by ldmatrix.trans of V's
// rows, A by ldmatrix.trans of its rows; V (du or z) and A (x or g) are
// bfloat16 exactly, so every product is exact and only the float32 sums'
// order differs. Block b as in the float32 kernel, with mma_col_width
// columns; warp w: factor rows 16(w % (kp/16)) .. +15, columns 32(w /
// (kp/16)) .. +31 of the tile (warps past 8 / (kp/16) groups idle).
__global__ void __launch_bounds__(kThreads) sandwich_bwd_cols_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
    const __nv_bfloat16* __restrict__ rowbuf, float* __restrict__ dfp,
    Dims d, int vec_x, int vec_g) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) char csm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = d.ct1 + d.ct2;
  const int sp = blockIdx.x / tiles;
  int t = blockIdx.x % tiles;
  const bool is_in = t < d.ct1;
  if (!is_in) t -= d.ct1;
  const T* A = is_in ? x : g;
  const int n = is_in ? d.n_in : d.n_out;
  const int kp = is_in ? d.kp1 : d.kp2, ld = is_in ? d.ld1 : d.ld2;
  const int voff = is_in ? 0 : d.kp1, vld = d.kp1 + d.kp2;
  const bool vec = is_in ? vec_x : vec_g;
  const int cw = mma_col_width(kp), a_ld = cw + 8, v_ld = kp + 8;
  const int mtiles = kp / 16;
  const int mt = warp % mtiles, ch = warp / mtiles;
  const bool active = ch < 8 / mtiles;
  const int c0 = t * cw, wc = 32 * ch;
  const int r0 = (int)((long long)sp * d.rows / d.nsplit);
  const int r1 = (int)((long long)(sp + 1) * d.rows / d.nsplit);
  const int nk = (r1 - r0 + kMmaColRows - 1) / kMmaColRows;
  const int stage = mma_col_stage(kp);
  auto slot_a = [&](int s) {
    return reinterpret_cast<T*>(csm + (size_t)s * stage);
  };
  auto slot_v = [&](int s) { return slot_a(s) + kMmaColRows * a_ld; };
  auto load = [&](int s, int k) {
    T* as = slot_a(s);
    T* vs = slot_v(s);
    const int rb = r0 + k * kMmaColRows;
    if (vec) {
      const int segs = cw / 8;
      for (int e = tid; e < kMmaColRows * segs; e += kThreads) {
        const int r = e / segs, col = c0 + (e % segs) * 8;
        const bool ok = rb + r < r1 && col < n;
        cp_async16(as + r * a_ld + (e % segs) * 8,
                   ok ? A + (size_t)(rb + r) * n + col : A, ok);
      }
    } else {
      for (int e = tid; e < kMmaColRows * cw; e += kThreads) {
        const int r = e / cw, col = c0 + e % cw;
        as[r * a_ld + e % cw] = rb + r < r1 && col < n
            ? A[(size_t)(rb + r) * n + col] : from_f32<T>(0.f);
      }
    }
    const int vsegs = kp / 8;
    for (int e = tid; e < kMmaColRows * vsegs; e += kThreads) {
      const int r = e / vsegs, sg = e % vsegs;
      const bool ok = rb + r < r1;
      cp_async16(vs + r * v_ld + sg * 8,
                 ok ? rowbuf + (size_t)(rb + r) * vld + voff + sg * 8
                    : rowbuf, ok);
    }
  };
  for (int s = 0; s < kColRing - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  const int mat = lane >> 3, i8 = lane & 7;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  for (int k = 0; k < nk; ++k) {
    cp_async_wait<kColRing - 2>();
    __syncthreads();
    if (k + kColRing - 1 < nk) load((k + kColRing - 1) % kColRing,
                                    k + kColRing - 1);
    cp_async_commit();
    const T* as = slot_a(k % kColRing);
    const T* vs = slot_v(k % kColRing);
    if (active) {
#pragma unroll
      for (int ks = 0; ks < kMmaColRows / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, vs + (16 * ks + (mat >> 1) * 8 + i8) * v_ld +
                                 16 * mt + (mat & 1) * 8);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, as + (16 * ks + (mat & 1) * 8 + i8) * a_ld +
                                   wc + 16 * pp + (mat >> 1) * 8);
          mma_bf16(acc[2 * pp], a, b[0], b[1]);
          mma_bf16(acc[2 * pp + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (!active) return;
  float* out = dfp + (size_t)sp * split_floats(d) +
               (is_in ? 0 : (size_t)d.kp1 * d.ld1);
  const int gq = lane >> 2, tg = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + wc + 8 * j + 2 * tg;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = out + (size_t)(16 * mt + gq + 8 * h) * ld + c;
      if (c < n) o[0] = acc[j][2 * h];
      if (c + 1 < n) o[1] = acc[j][2 * h + 1];
    }
  }
}

// -- kernel 3: the column partials' sum -------------------------------------

// df[m][c] = Σ_split dfp[split][m][c] in split order, for m < k and c < n
// of each factor (the same (kp, ld) layout, one split).
__global__ void __launch_bounds__(kThreads) sandwich_bwd_sum_kernel(
    const float* __restrict__ dfp, float* __restrict__ df, Dims d) {
  const size_t stride = split_floats(d);
  const size_t n_in_el = (size_t)d.k1 * d.n_in;
  const size_t total = n_in_el + (size_t)d.k2 * d.n_out;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const bool is_in = e < n_in_el;
    const size_t o = is_in ? e : e - n_in_el;
    const int n = is_in ? d.n_in : d.n_out;
    const size_t off = (is_in ? 0 : (size_t)d.kp1 * d.ld1) +
                       (o / n) * (is_in ? d.ld1 : d.ld2) + o % n;
    float v = 0.f;
    // eight partials' loads in flight, added in split order
    for (int sp = 0; sp < d.nsplit; sp += 8) {
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        t[u] = sp + u < d.nsplit ? dfp[(sp + u) * stride + off] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp + u < d.nsplit) v += t[u];
    }
    df[off] = v;
  }
}

// -- kernel 4: the factor rows' VJP -----------------------------------------

// Stage s of a one-hot row's transposed chain (stages p-1 .. 0 in order)
// takes an input that is nonzero only on the 2^(p-1-s) positions whose low
// s+1 bits are idx's; its compact entry q is position (q << (s+1)) | low.
// The row's da_s and db_s are nonzero only there too: they are stored at
// part + off(s) + q and part + off(s) + 2^(p-1-s) + q, off(s) = 2(n - n/2^s)
// (2(n - 1) floats a row).
__host__ __device__ inline size_t vjp_off(int n, int s) {
  return (size_t)2 * (n - (n >> s));
}

// Block b: factor row b of F_in (b < k1) or b - k1 of F_out. Its cotangent
// is df_in + m·ld_in (or df_out + m·ld_out), zero past nv. The stage inputs
// go to `act` (stage s at 2^(p-1-s) - 1, n - 1 floats) and the cotangent to
// `gv` (n floats), both in shared memory where n <= kVjpSmemN, else in the
// row's slice of `scratch` (2n floats).
template <typename T>
__global__ void __launch_bounds__(kThreads) sandwich_bwd_vjp_kernel(
    const float* __restrict__ b_in, const float* __restrict__ b_out,
    const int* __restrict__ idx_in, const int* __restrict__ idx_out,
    const float* __restrict__ df_in, const float* __restrict__ df_out,
    int ld_in, int ld_out, float* __restrict__ part,
    float* __restrict__ scratch, Dims d) {
  extern __shared__ __align__(16) float vsm[];
  const int tid = threadIdx.x;
  const bool is_in = (int)blockIdx.x < d.k1;
  const int m = is_in ? blockIdx.x : blockIdx.x - d.k1;
  const float* w = is_in ? b_in : b_out;
  const int n = is_in ? d.n1 : d.n2, p = is_in ? d.p1 : d.p2;
  const int nv = is_in ? d.n_in : d.n_out;
  const int idx = is_in ? idx_in[m] : idx_out[m];
  const float* df =
      (is_in ? df_in : df_out) + (size_t)m * (is_in ? ld_in : ld_out);
  float* prow = part + (is_in ? (size_t)m * 2 * (d.n1 - 1)
                              : (size_t)d.k1 * 2 * (d.n1 - 1) +
                                    (size_t)m * 2 * (d.n2 - 1));
  float* act = vsm;
  if (n > kVjpSmemN) {
    size_t off = 0;                      // rows before this one that spill
    if (d.n1 > kVjpSmemN) off += (size_t)(is_in ? m : d.k1) * 2 * d.n1;
    if (!is_in) off += (size_t)m * 2 * d.n2;
    act = scratch + off;
  }
  float* gv = act + n;
  // forward sweep: the input of stage s-1 from that of stage s
  if (tid == 0) act[0] = 1.f;
  __syncthreads();
  for (int s = p - 1; s >= 1; --s) {
    const int cnt = 1 << (p - 1 - s);
    const float* src = act + cnt - 1;
    float* dst = act + 2 * cnt - 1;
    const int low = idx & ((2 << s) - 1), st = 1 << s;
    const float* a = w + (size_t)(2 * s) * n;
    for (int q = tid; q < cnt; q += kThreads) {
      const int u = (q << (s + 1)) | low;
      const float xv = src[q];
      dst[u >> s] = rnd<T>(a[u]) * xv;
      dst[(u ^ st) >> s] = rnd<T>(a[n + u]) * xv;
    }
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads) gv[i] = i < nv ? df[i] : 0.f;
  __syncthreads();
  // reverse sweep: the dual stages on the support, stage 0 first
  for (int s = 0; s < p; ++s) {
    const int cnt = 1 << (p - 1 - s);
    const float* xs = act + cnt - 1;
    const int low = idx & ((2 << s) - 1), st = 1 << s;
    const float* a = w + (size_t)(2 * s) * n;
    float* pa = prow + vjp_off(n, s);
    for (int q = tid; q < cnt; q += kThreads) {
      const int u = (q << (s + 1)) | low;
      const float xv = xs[q], gu = gv[u], gw = gv[u ^ st];
      pa[q] = gu * xv;
      pa[cnt + q] = gw * xv;
      gv[u] = rnd<T>(a[u]) * gu + rnd<T>(a[n + u]) * gw;
    }
    __syncthreads();
  }
}

// -- kernel 5: the weight gradients -----------------------------------------

// The first `core_blocks` blocks: d core = Σ of the row tiles' partials, a
// warp per element, lane l adding tiles l, l + 32, ... in order and the
// lanes' sums added by a fixed shuffle tree (none where dcore is null). The
// rest: db[s][ab][i] = Σ_m (over the factor rows in order, those whose
// stage-s support holds i) of the row's compact entry.
__global__ void __launch_bounds__(kThreads) sandwich_bwd_reduce_kernel(
    const float* __restrict__ part, const float* __restrict__ pcore,
    const int* __restrict__ idx_in, const int* __restrict__ idx_out,
    float* __restrict__ db_in, float* __restrict__ dcore,
    float* __restrict__ db_out, Dims d, int core_blocks) {
  if ((int)blockIdx.x < core_blocks) {
    const int kk = d.k1 * d.k2, lane = threadIdx.x & 31;
    const int j = (blockIdx.x * kThreads + threadIdx.x) >> 5;
    if (j >= kk) return;
    float acc = 0.f;
    for (int t = lane; t < d.tiles; t += 32) acc += pcore[(size_t)t * kk + j];
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) dcore[j] = acc;
    return;
  }
  __shared__ int ids[2 * kMaxK];
  for (int i = threadIdx.x; i < d.k1 + d.k2; i += kThreads)
    ids[i] = i < d.k1 ? idx_in[i] : idx_out[i - d.k1];
  __syncthreads();
  const size_t n_win = (size_t)2 * d.p1 * d.n1;
  const size_t total = n_win + (size_t)2 * d.p2 * d.n2;
  const int blocks = gridDim.x - core_blocks;
  for (size_t e = (size_t)(blockIdx.x - core_blocks) * kThreads +
                  threadIdx.x;
       e < total; e += (size_t)blocks * kThreads) {
    const bool is_in = e < n_win;
    const size_t o = is_in ? e : e - n_win;
    const int n = is_in ? d.n1 : d.n2, k = is_in ? d.k1 : d.k2;
    const int sab = (int)(o / n), i = (int)(o % n);
    const int s = sab >> 1, ab = sab & 1;
    const int mask = (2 << s) - 1, cnt = n >> (s + 1);
    const int* id = ids + (is_in ? 0 : d.k1);
    const float* pr = part + (is_in ? 0 : (size_t)d.k1 * 2 * (d.n1 - 1)) +
                      vjp_off(n, s) + (size_t)ab * cnt + (i >> (s + 1));
    const size_t rs = (size_t)2 * (n - 1);
    float acc = 0.f;
    for (int m0 = 0; m0 < k; m0 += 8) {          // eight loads in flight
      float t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int m = m0 + u;
        t[u] = m < k && ((i ^ id[m]) & mask) == 0 ? pr[m * rs] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (m0 + u < k && ((i ^ id[m0 + u]) & mask) == 0) acc += t[u];
    }
    (is_in ? db_in : db_out)[o] = acc;
  }
}

// -- host -------------------------------------------------------------------

bool set_dims(Dims& d, int rows, int n_in, int n1, int k1, int kp1, int ld1,
              int n_out, int n2, int k2, int kp2, int ld2) {
  d.rows = rows, d.n_in = n_in, d.n1 = n1, d.k1 = k1, d.kp1 = kp1;
  d.ld1 = ld1, d.n_out = n_out, d.n2 = n2, d.k2 = k2, d.kp2 = kp2;
  d.ld2 = ld2;
  d.p1 = log2_exact(n1), d.p2 = log2_exact(n2);
  return d.p1 >= 1 && d.p2 >= 1 && n1 <= kMaxN1 && n2 <= kMaxN2 &&
         k1 >= 1 && k1 <= kMaxK && k2 >= 1 && k2 <= kMaxK && n_in >= 1 &&
         n_in <= n1 && n_out >= 1 && n_out <= n2 && k1 <= kp1 &&
         k2 <= kp2 && kp1 <= kMaxK && kp2 <= kMaxK && kp1 % kPadK == 0 &&
         kp2 % kPadK == 0 && ld1 >= n_in && ld2 >= n_out && ld1 % kBN == 0 &&
         ld2 % kBN == 0 && rows >= 0;
}

// Lets `Kernel` take all the dynamic shared memory a block may use, once
// per kernel and process.
template <auto Kernel>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

// Floats of the row tiles' d core partials, rounded up to 16 bytes.
size_t pcore_floats(const Dims& d) {
  return ((size_t)d.tiles * d.k1 * d.k2 + 3) & ~(size_t)3;
}

// Floats of the factor VJP's workspace: the compact partials, then the
// stage inputs and cotangents of rows wider than kVjpSmemN.
size_t vjp_floats(const Dims& d) {
  size_t f = (size_t)d.k1 * 2 * (d.n1 - 1) + (size_t)d.k2 * 2 * (d.n2 - 1);
  if (d.n1 > kVjpSmemN) f += (size_t)d.k1 * 2 * d.n1;
  if (d.n2 > kVjpSmemN) f += (size_t)d.k2 * 2 * d.n2;
  return f;
}

size_t vjp_smem(const Dims& d) {
  int n = 0;
  if (d.n1 <= kVjpSmemN) n = d.n1;
  if (d.n2 <= kVjpSmemN && d.n2 > n) n = d.n2;
  return sizeof(float) * 2 * (size_t)n;
}

template <typename T>
cudaError_t launch_vjp(const float* b_in, const float* b_out,
                       const int* idx_in, const int* idx_out,
                       const float* df_in, const float* df_out, int ld_in,
                       int ld_out, float* part,
                       float* scratch, const float* pcore, float* db_in,
                       float* dcore, float* db_out, const Dims& d,
                       cudaStream_t stream) {
  const size_t smem = vjp_smem(d);
  auto kernel = sandwich_bwd_vjp_kernel<T>;
  cudaError_t err = allow_smem<sandwich_bwd_vjp_kernel<T>>();
  if (err != cudaSuccess) return err;
  kernel<<<d.k1 + d.k2, kThreads, smem, stream>>>(
      b_in, b_out, idx_in, idx_out, df_in, df_out, ld_in, ld_out, part,
      scratch, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t total = (size_t)2 * d.p1 * d.n1 + (size_t)2 * d.p2 * d.n2;
  const size_t want = (total + kThreads - 1) / kThreads;
  const int core_blocks =
      dcore != nullptr ? (d.k1 * d.k2 * 32 + kThreads - 1) / kThreads : 0;
  sandwich_bwd_reduce_kernel<<<core_blocks + (int)(want < 4096 ? want : 4096),
                               kThreads, 0, stream>>>(
      part, pcore, idx_in, idx_out, db_in, dcore, db_out, d, core_blocks);
  return cudaGetLastError();
}

// The factors' padded shape: rows to kPadK, columns to kBN (the forward's
// workspace layout, `valid_factors`).
void pad_factors(Dims& d) {
  d.kp1 = kPadK * ((d.k1 + kPadK - 1) / kPadK);
  d.kp2 = kPadK * ((d.k2 + kPadK - 1) / kPadK);
  d.ld1 = kBN * ((d.n_in + kBN - 1) / kBN);
  d.ld2 = kBN * ((d.n_out + kBN - 1) / kBN);
}

void plan_split(Dims& d, int sms) {
  d.tiles = (d.rows + kBM - 1) / kBM;
  const int w1 = d.bf16 ? mma_col_width(d.kp1) : col_width(d.kp1);
  const int w2 = d.bf16 ? mma_col_width(d.kp2) : col_width(d.kp2);
  d.ct1 = (d.n_in + w1 - 1) / w1;
  d.ct2 = (d.n_out + w2 - 1) / w2;
  // about four blocks an SM, at most 512 rows summed in one run, at least
  // 64 rows a split
  const int cols = d.ct1 + d.ct2;
  int s = (4 * sms + cols - 1) / cols;
  if (s > 128) s = 128;
  const int most = (d.rows + 63) / 64;
  if (s > most) s = most;
  const int least = (d.rows + 511) / 512;
  if (s < least) s = least;
  d.nsplit = s < 1 ? 1 : s;
}

// The workspace, in floats, each part 16-byte aligned: the factors F_in
// (kp1, ld1) and F_out (kp2, ld2) and for bfloat16 their hi/lo pairs,
// kernel 1's per-row du and z (in x's dtype) and its d core partials,
// kernel 2's partials, their sum, kernel 4's compact entries and its device
// rows.
struct Workspace {
  size_t f_in, f_out, hl_in, hl_out, rowbuf, pcore, dfp, df, part, scratch,
      total;
};

Workspace workspace(const Dims& d) {
  Workspace w;
  const size_t stride = split_floats(d);
  w.f_in = 0;
  w.f_out = (size_t)d.kp1 * d.ld1;
  w.hl_in = stride;                     // (2, kp, ld) bfloat16 = kp·ld floats
  w.hl_out = w.hl_in + (d.bf16 ? (size_t)d.kp1 * d.ld1 : 0);
  w.rowbuf = w.hl_out + (d.bf16 ? (size_t)d.kp2 * d.ld2 : 0);
  w.pcore = w.rowbuf +
            (size_t)d.rows * (d.kp1 + d.kp2) / (d.bf16 ? 2 : 1);
  w.dfp = w.pcore + pcore_floats(d);
  w.df = w.dfp + (size_t)d.nsplit * stride;
  w.part = w.df + stride;
  w.scratch = w.part + (size_t)d.k1 * 2 * (d.n1 - 1) +
              (size_t)d.k2 * 2 * (d.n2 - 1);
  w.total = w.part + vjp_floats(d);
  return w;
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, const float* core,
                       const float* b_in, const float* b_out,
                       const int* idx_in, const int* idx_out, void* dx,
                       float* db_in, float* dcore, float* db_out, float* ws,
                       const Dims& d, cudaStream_t stream) {
  constexpr int vw = 16 / sizeof(T);
  constexpr bool f32 = std::is_same<T, float>::value;
  const Workspace w = workspace(d);
  float* f_in = ws + w.f_in;
  float* f_out = ws + w.f_out;
  __nv_bfloat16* hl_in =
      f32 ? nullptr : reinterpret_cast<__nv_bfloat16*>(ws + w.hl_in);
  __nv_bfloat16* hl_out =
      f32 ? nullptr : reinterpret_cast<__nv_bfloat16*>(ws + w.hl_out);
  cudaError_t err = launch_factors<T>(b_in, b_out, idx_in, idx_out, f_in,
                                      f_out, hl_in, hl_out, d.n1, d.k1,
                                      d.n_in, d.kp1, d.ld1, d.n2, d.k2,
                                      d.n_out, d.kp2, d.ld2, stream);
  if (err != cudaSuccess) return err;
  // the deep ring where it fits beside the rest (all but the widest cores)
  const bool deep =
      row_plan<T, kDeepRing>(d.k1, d.k2, d.kp1, d.kp2).total <= kMaxSmem;
  const RowPlan P = deep ? row_plan<T, kDeepRing>(d.k1, d.k2, d.kp1, d.kp2)
                         : row_plan<T, kShallowRing>(d.k1, d.k2, d.kp1,
                                                     d.kp2);
  auto rows_k = deep ? sandwich_bwd_rows_kernel<T, kDeepRing>
                     : sandwich_bwd_rows_kernel<T, kShallowRing>;
  if ((err = deep ? allow_smem<sandwich_bwd_rows_kernel<T, kDeepRing>>()
                  : allow_smem<sandwich_bwd_rows_kernel<T, kShallowRing>>())
      != cudaSuccess)
    return err;
  auto aligned = [](const void* p, int a) {
    return reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  // 16-byte row loads into shared memory; 4-element stores of dx (2 on
  // tensor cores)
  const int vec_x = d.n_in % vw == 0 && aligned(x, 16);
  const int vec_g = d.n_out % vw == 0 && aligned(g, 16);
  const int v4_dx = d.n_in % 4 == 0 && aligned(dx, 4 * sizeof(T));
  T* rowbuf = reinterpret_cast<T*>(ws + w.rowbuf);
  float* pcore = ws + w.pcore;
  float* dfp = ws + w.dfp;
  float* df = ws + w.df;
  rows_k<<<d.tiles, kThreads, P.total, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), core, f_in, f_out,
      hl_in, hl_out, static_cast<T*>(dx), rowbuf, pcore, d, vec_x, vec_g,
      v4_dx);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int col_blocks = (d.ct1 + d.ct2) * d.nsplit;
  if constexpr (f32) {
    int cs = col_stage(d.kp1);
    if (col_stage(d.kp2) > cs) cs = col_stage(d.kp2);
    if ((err = allow_smem<sandwich_bwd_cols_kernel>()) != cudaSuccess)
      return err;
    sandwich_bwd_cols_kernel<<<col_blocks, kThreads, kColRing * cs,
                               stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), rowbuf, dfp, d,
        vec_x, vec_g);
  } else {
    int cs = mma_col_stage(d.kp1);
    if (mma_col_stage(d.kp2) > cs) cs = mma_col_stage(d.kp2);
    if ((err = allow_smem<sandwich_bwd_cols_mma_kernel>()) != cudaSuccess)
      return err;
    sandwich_bwd_cols_mma_kernel<<<col_blocks, kThreads, kColRing * cs,
                                   stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), rowbuf, dfp, d,
        vec_x, vec_g);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t elems = (size_t)d.k1 * d.n_in + (size_t)d.k2 * d.n_out;
  const size_t want = (elems + kThreads - 1) / kThreads;
  sandwich_bwd_sum_kernel<<<(int)(want < 2048 ? want : 2048), kThreads, 0,
                            stream>>>(dfp, df, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_vjp<T>(b_in, b_out, idx_in, idx_out, df,
                       df + (size_t)d.kp1 * d.ld1, d.ld1, d.ld2, ws + w.part,
                       ws + w.scratch, pcore, db_in, dcore, db_out, d,
                       stream);
}

bool plan(Dims& d, int rows, int n_in, int n1, int k1, int n_out, int n2,
          int k2, int sms, int dtype) {
  d.k1 = k1, d.k2 = k2, d.n_in = n_in, d.n_out = n_out;
  d.bf16 = dtype == 1;
  if (dtype != 0 && dtype != 1) return false;
  pad_factors(d);
  if (!set_dims(d, rows, n_in, n1, k1, d.kp1, d.ld1, n_out, n2, k2, d.kp2,
                d.ld2) ||
      rows < 1 || sms < 1)
    return false;
  plan_split(d, sms);
  return true;
}

}  // namespace

// The floats of the backward's workspace for rows x (n_in -> n_out) in
// dtype (0 = float32, 1 = bfloat16) on a card of `sms` SMs, or 0 for a
// shape the kernels do not take.
extern "C" long long sandwich_bwd_floats(int rows, int n_in, int n1, int k1,
                                         int n_out, int n2, int k2, int sms,
                                         int dtype) {
  Dims d{};
  if (!plan(d, rows, n_in, n1, k1, n_out, n2, k2, sms, dtype)) return 0;
  return (long long)workspace(d).total;
}

// x (rows, n_in), g (rows, n_out) and dx (rows, n_in) in dtype (0 = float32,
// 1 = bfloat16); core (k2, k1), b_in (p1, 2, n1), b_out (p2, 2, n2) float32.
// Builds the factors from the weights rounded to dtype (sandwich_factors.cuh)
// and writes dx, db_in, dcore and db_out (float32, shaped as the weights);
// ws holds sandwich_bwd_floats floats. Six launches on `stream`; returns the
// first cudaError_t (0 on success).
extern "C" int sandwich_bwd(const void* x, const void* g, const float* core,
                            const float* b_in, const float* b_out,
                            const int* idx_in, const int* idx_out, void* dx,
                            float* db_in, float* dcore, float* db_out,
                            float* ws, int rows, int n_in, int n1, int k1,
                            int n_out, int n2, int k2, int sms,
                            float scale_in, float scale_out, int dtype,
                            void* stream) {
  Dims d{};
  if (!plan(d, rows, n_in, n1, k1, n_out, n2, k2, sms, dtype))
    return cudaErrorInvalidValue;
  d.scale_in = scale_in, d.scale_out = scale_out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, g, core, b_in, b_out, idx_in, idx_out, dx,
                             db_in, dcore, db_out, ws, d, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g, core, b_in, b_out, idx_in,
                                     idx_out, dx, db_in, dcore, db_out, ws,
                                     d, s);
  return cudaErrorInvalidValue;
}

// Floats of the workspace `sandwich_factors_vjp` takes for these widths
// (0 for a shape it does not take).
extern "C" long long sandwich_factors_vjp_floats(int n1, int k1, int n2,
                                                 int k2) {
  Dims d{};
  d.k1 = k1, d.k2 = k2, d.n_in = 1, d.n_out = 1;
  pad_factors(d);
  if (!set_dims(d, 1, 1, n1, k1, d.kp1, d.ld1, 1, n2, k2, d.kp2, d.ld2))
    return 0;
  return (long long)vjp_floats(d);
}

// The factor VJP alone (kernels 4 and 5): d b_in and d b_out (float32,
// shaped as the weights) for the cotangents d_f_in (k1, n_in) and d_f_out
// (k2, n_out) of F_in = B_in[idx_in, :n_in] and F_out = B_out[idx_out,
// :n_out] built from the weights rounded to dtype (0 = float32, 1 =
// bfloat16). ws: sandwich_factors_vjp_floats floats. Returns the first
// cudaError_t of the two launches.
extern "C" int sandwich_factors_vjp(const float* b_in, const float* b_out,
                                    const int* idx_in, const int* idx_out,
                                    const float* d_f_in,
                                    const float* d_f_out, float* db_in,
                                    float* db_out, float* ws, int n_in,
                                    int n1, int k1, int n_out, int n2,
                                    int k2, int dtype, void* stream) {
  Dims d{};
  d.k1 = k1, d.k2 = k2, d.n_in = n_in, d.n_out = n_out;
  pad_factors(d);
  if (!set_dims(d, 1, n_in, n1, k1, d.kp1, d.ld1, n_out, n2, k2, d.kp2,
                d.ld2))
    return cudaErrorInvalidValue;
  d.tiles = 0;
  float* part = ws;
  float* scratch = part + (size_t)d.k1 * 2 * (d.n1 - 1) +
                   (size_t)d.k2 * 2 * (d.n2 - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_vjp<float>(b_in, b_out, idx_in, idx_out, d_f_in, d_f_out,
                             n_in, n_out, part, scratch, nullptr, db_in,
                             nullptr, db_out, d, s);
  if (dtype == 1)
    return launch_vjp<__nv_bfloat16>(b_in, b_out, idx_in, idx_out, d_f_in,
                                     d_f_out, n_in, n_out, part, scratch,
                                     nullptr, db_in, nullptr, db_out, d, s);
  return cudaErrorInvalidValue;
}
