// Butterfly-sandwich forward for Hopper (sm_90a), as truncated factors and
// row-tile products.
//
// Replaces the TPU kernel `_sandwich_kernel` in src/repro/kernels/sandwich.py
// (entry `_sandwich_fwd_call`). Per row it computes the paper's dense-layer
// replacement
//
//     out = Bᵀ_out · scatter(scale_out · core · (scale_in · select(B_in x)))
//
// A truncated butterfly that keeps k outputs is, as a matrix, a k x n
// factor: row m of B_in restricted to the k1 selected outputs is
// F_in[m] = B_inᵀ e_idx_in[m], and the scatter followed by Bᵀ_out is
// F_outᵀ with F_out[m] = B_outᵀ e_idx_out[m] (the reference's
// `materialize_truncated`). So
//
//     out = F_outᵀ · core · F_in · x,   F_in (k1, n_in), F_out (k2, n_out),
//
// with the reference's precision points: h1 = rnd_T(select(B_in x)) ·
// scale_in, z = rnd_T((h1 · coreᵀ) · scale_out), out = rnd_T(z · F_out), the
// factors float32 products of the stage weights rounded to T.
//
// Two kernels per call, on the current stream:
//
// 1. `sandwich_factors_kernel` (sandwich_factors.cuh, which the backward
//    launches too) builds F_in and F_out from this call's weights, one
//    block per (factor row, column tile of kFacTile). A one-hot
//    row stays one path wide: the stages whose stride reaches across tiles
//    act on the short vector {l + j·tile} at the single offset
//    l = idx & (tile - 1) (one thread per tile), and each in-tile stage
//    doubles the support, so a stage touches only the pairs on it. Every
//    entry is a product of path weights, one rounding per stage, as the
//    plain twin's chain gives. Stores are zero-padded to (kp, ld): rows to a
//    multiple of 16, columns to a multiple of kBN, so the row kernel loads
//    whole chunks with no bounds. For bfloat16 it also writes F_out's hi/lo
//    pair (hi = bf16(F), lo = bf16(F - hi)), which keeps the tensor-core
//    product at ~2^-17 of F, far inside bfloat16's rounding.
// 2. `sandwich_rows_kernel` runs a tile of kBM rows over a group of output
//    column chunks. Product 1 gives h1: in float32 as x · F_inᵀ, x and F_in
//    streamed in K chunks through a cp.async ring; in bfloat16 by the input
//    butterfly itself on its support, operation for operation as the plain
//    twin (h1 is rounded right after it, and a sum in another order falls on
//    the other side of a tie for a few values in ten thousand, each moving a
//    whole output row past the tolerance). Product 2, the core (k <= 64), is
//    float32 on CUDA cores. Product 3 streams F_out in column chunks through
//    a cp.async ring and writes each output tile once, through a staging
//    buffer with 16-byte streaming stores (scalar where the row width is
//    ragged). The grid is row tiles x column groups (the wrapper picks the
//    groups). It is launched as a programmatic dependent of the factor
//    kernel: its blocks start while the factors are built and wait for them
//    only where they read them. No atomics, fixed summation orders: two
//    launches give the same bits.
//
// What bounds it on the H100: bytes. Per row the factored products do n_in·k1
// + k1·k2 + k2·n_out multiply-adds (22,179 at the MLP's up/gate, 791,760 at
// the head), a few per byte of activations; the weights are read once per
// block, not once per row. The head's output (805 MB in bfloat16 at 8192
// rows) dominates. The bfloat16 route runs product 3 on tensor cores with
// `mma.sync.m16n8k16` (bf16 in, float32 accumulate, k2 padded to 16 by
// zeros; z is bf16 exactly, F_out enters as its hi/lo pair). `wgmma` is not
// needed: K = k2 <= 64 is too small to feed it, and the kernel is bound by
// its stores. The input chain runs on CUDA cores in float32, about n1·log n1
// operations per row on its support; at the MLP's widths it, not the bytes,
// takes most of a block's time. The float32 route uses float32 FMAs on CUDA
// cores, no TF32.

#include <cstdint>
#include <type_traits>

#include "sandwich_common.cuh"
#include "sandwich_factors.cuh"

namespace {

using namespace sandwich;

constexpr int kBM = 64;            // rows per row tile
constexpr int kBN = 128;           // output columns per chunk
constexpr int kRowThreads = 256;   // 8 warps
constexpr int kStages = 4;         // cp.async ring depth
constexpr int kSuper = 16;         // K chunks summed apart, then added
constexpr int kPadK = 16;          // factor rows padded to a multiple
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kChainFloats = 16384;  // input-butterfly batch, bfloat16 route
constexpr int kMaxP = 15;          // log2(kMaxN1)
constexpr int kTabPairs = 4096;    // stage-weight table of the input chain's
                                   // pair stages, at most n1 pairs
constexpr int kWarpTabN1 = 2048;   // widest n1 whose warp stages' weights
                                   // are tabled

// -- device helpers ---------------------------------------------------------

// -- kernel 2: the row-tile products -----------------------------------------

// Shared-memory plan of the row kernel (bytes), on host and device alike.
struct RowPlan {
  int kc;        // K chunk of product 1, float32 route (elements)
  int xs_ld;     // x chunk row stride (elements)
  int a_stage;   // bytes of one product-1 ring slot
  int chain_rb;  // rows of one input-butterfly batch, bfloat16 route
  int chain_ld;  // their row stride (floats): n1 + 4, rows 16-byte aligned
                 // and eight of them on distinct banks
  int tab_pairs; // pairs the stage-weight table holds
  int wtab;      // whether stages 0..4's weights are tabled
  int fo_ld;     // F_out chunk row stride (elements)
  int c_stage;   // bytes of one product-3 ring slot
  int h1_ld;     // h1 row stride (floats)
  int z_ld;      // z row stride (elements of T)
  int core_off, h1_off, z_off, pat_off, tab_off, wtab_off, pipe_off, stg_off,
      total;
};

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

template <typename T>
__host__ __device__ inline RowPlan row_plan(int k1, int k2, int kp1, int kp2,
                                            int n1) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int es = sizeof(T);
  RowPlan p;
  p.kc = 64;                                    // 256 bytes of a row
  p.xs_ld = p.kc + 4;
  p.a_stage = f32 ? round16((kBM + kp1) * p.xs_ld * 4) : 0;
  // at least one row a batch: from n1 = 32768 a row takes 128 KB
  p.chain_rb = kChainFloats / n1 < 1 ? 1
               : kChainFloats / n1 < kBM ? kChainFloats / n1 : kBM;
  p.chain_ld = n1 + 4;
  p.tab_pairs = n1 < kTabPairs ? n1 : kTabPairs;
  p.wtab = !f32 && n1 >= 32 && n1 <= kWarpTabN1;
  p.fo_ld = kBN + (f32 ? 4 : 8);
  p.c_stage = round16((f32 ? 1 : 2) * kp2 * p.fo_ld * es);
  p.h1_ld = kp1 + 1;
  p.z_ld = f32 ? kp2 : kp2 + 8;
  const int stg = f32 ? 0 : round16(kBM * p.fo_ld * es);
  p.core_off = 0;
  p.h1_off = round16(k1 * k2 * 4);
  p.z_off = p.h1_off + round16(kBM * p.h1_ld * 4);
  p.pat_off = p.z_off + round16(kBM * p.z_ld * es);
  p.tab_off = p.pat_off +
              (f32 ? 0 : round16(4 * (kMaxK + kMaxP * (2 * kMaxK + 3))));
  p.wtab_off = p.tab_off + (f32 ? 0 : round16(10 * p.tab_pairs));
  p.pipe_off = p.wtab_off + (p.wtab ? 5 * n1 * 4 : 0);
  const int a = f32 ? kStages * p.a_stage
                    : round16(p.chain_rb * p.chain_ld * 4);
  const int c = kStages * p.c_stage + stg;
  p.total = p.pipe_off + (a > c ? a : c);
  if (p.total > kMaxSmem && !f32) {
    // the widest rows with the largest cores: table fewer pair stages (the
    // rest read their weights from device memory)
    const int cut = (p.total - kMaxSmem + 15) / 10;
    p.tab_pairs = p.tab_pairs > cut ? (p.tab_pairs - cut) & ~7 : 0;
    const int shift = p.wtab_off - (p.tab_off + round16(10 * p.tab_pairs));
    p.wtab_off -= shift;
    p.pipe_off -= shift;
    p.total -= shift;
  }
  p.stg_off = p.pipe_off + kStages * p.c_stage;
  return p;
}

// Product 1, float32 route: h1s[r][m] = (Σ_c x[r][c] F_in[m][c]) · scale_in
// over the block's rows, x and F_in (kp1, ld1) streamed in K chunks through
// a cp.async ring. No rounding point follows, so the sum's order is free;
// it is blocked (each thread's share of kSuper chunks apart, then into its
// running sum): at n_in = 28,672 a straight sum of a thread's 7,168 terms
// strays past SANDWICH_TOL from the stage chain on near-zero outputs.
__device__ __forceinline__ void product_in_dot(
    const float* __restrict__ x, const float* __restrict__ fin, char* smem,
    const RowPlan& P, float* h1s, int row0, int rows, int n_in, int kp1,
    int ld1, float scale_in, bool vec_in) {
  const int tid = threadIdx.x;
  const int kc = P.kc, nk = (n_in + kc - 1) / kc;
  char* pipe = smem + P.pipe_off;
  auto slot_x = [&](int s) {
    return reinterpret_cast<float*>(pipe + (size_t)s * P.a_stage);
  };
  auto slot_f = [&](int s) { return slot_x(s) + kBM * P.xs_ld; };
  auto load = [&](int s, int c) {
    float* xs = slot_x(s);
    float* fs = slot_f(s);
    const int c0 = c * kc, segs = kc / 4;
    if (vec_in) {
      for (int e = tid; e < kBM * segs; e += kRowThreads) {
        const int r = e / segs, col = c0 + (e % segs) * 4;
        const bool ok = row0 + r < rows && col < n_in;
        cp_async16(xs + r * P.xs_ld + (e % segs) * 4,
                   ok ? x + (size_t)(row0 + r) * n_in + col : x, ok);
      }
    } else {
      for (int e = tid; e < kBM * kc; e += kRowThreads) {
        const int r = e / kc, col = c0 + e % kc;
        xs[r * P.xs_ld + e % kc] = row0 + r < rows && col < n_in
            ? x[(size_t)(row0 + r) * n_in + col] : 0.f;
      }
    }
    for (int e = tid; e < kp1 * segs; e += kRowThreads) {
      const int r = e / segs, sg = e % segs;
      cp_async16(fs + r * P.xs_ld + sg * 4,
                 fin + (size_t)r * ld1 + c0 + sg * 4, true);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  // thread: rows rq + 16u and factor rows 4·mq + v (u, v < 4) over every
  // kg-th float4 of a chunk; the K groups' sums are added in a fixed order
  const int quads = kp1 / 4, per = 16 * quads, groups = kRowThreads / per;
  const int kg = tid / per, rq = tid % 16, mq = (tid / 16) % quads;
  float acc[4][4], part[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = part[u][v] = 0.f;
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < nk) load((c + kStages - 1) % kStages,
                                   c + kStages - 1);
    cp_async_commit();
    const float* xs = slot_x(c % kStages);
    const float* fs = slot_f(c % kStages);
    if (kg < groups) {
      for (int q = 4 * kg; q < kc; q += 4 * groups) {
        float4 xv[4], fv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xv[u] = *reinterpret_cast<const float4*>(
              xs + (rq + 16 * u) * P.xs_ld + q);
          fv[u] = *reinterpret_cast<const float4*>(
              fs + (4 * mq + u) * P.xs_ld + q);
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
  float* red = reinterpret_cast<float*>(pipe);  // [groups][kBM][kp1]
  if (kg < groups) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        red[(kg * kBM + rq + 16 * u) * kp1 + 4 * mq + v] = acc[u][v];
  }
  __syncthreads();
  for (int e = tid; e < kBM * kp1; e += kRowThreads) {
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += red[g * kBM * kp1 + e];
    h1s[(e / kp1) * P.h1_ld + e % kp1] = sum * scale_in;
  }
  __syncthreads();
}

// Product 1, bfloat16 route: h1s[r][m] = rnd_T((B_in x_r)[idx_in[m]]) ·
// scale_in by the input butterfly itself, in batches of chain_rb rows held
// in shared memory. h1 is a rounding point: a sum in another order than the
// twin's stage chain lands on the other side of a bfloat16 tie for a few
// values in ten thousand, and each such step moves a whole output row by
// scale_in · core · scale_out of it. So the chain is the twin's, operation
// for operation (products and sums rounded apart, never fused), and h1 is
// its bits. Stages 0..4 (stride below 32) run within a warp by shuffles, on
// every aligned group of 32 elements holding nonzeros. Each later stage runs
// only the pairs that lead to a selected output (low bits those of an index
// in idx_in) and hold a nonzero (x is zero from n_in on, and the nonzeros
// after stage s are [0, n_in) rounded up to 2^(s+1)); elsewhere the twin
// computes zeros, which the buffer holds. The weights, exact in bfloat16,
// are gathered once per block into shared tables: stages 0..4's per element
// (n1 <= kWarpTabN1), the later stages' per pair (stages in order while
// they fit); the rest read device memory.
__device__ __forceinline__ void product_in_chain(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ b_in,
    const int* __restrict__ idx_in, char* smem, const RowPlan& P,
    float* h1s, int row0, int rows, int n_in, int n1, int k1, int kp1,
    float scale_in, bool vec_in) {
  using T = __nv_bfloat16;
  const int tid = threadIdx.x;
  const int p1 = 31 - __clz(n1);
  const int rb = P.chain_rb, ld = P.chain_ld;
  const int live = rows - row0 < kBM ? rows - row0 : kBM;
  float* buf = reinterpret_cast<float*>(smem + P.pipe_off);
  int* idx = reinterpret_cast<int*>(smem + P.pat_off);   // [kMaxK]
  int* pat = idx + kMaxK;                  // [p1][kMaxK] low bits, ascending
  int* cnt = pat + kMaxP * kMaxK;          // patterns of stage s
  int* nblk = cnt + kMaxP;                 // blocks of 2^(s+1) with nonzeros
  int* toff = nblk + kMaxP;                // first table entry, or -1
  int* flag = toff + kMaxP;                // [p1 * k1] scratch
  uint2* tw = reinterpret_cast<uint2*>(smem + P.tab_off);  // weights
  unsigned short* ti = reinterpret_cast<unsigned short*>(tw + P.tab_pairs);
  if (tid < k1) idx[tid] = idx_in[tid];
  __syncthreads();
  // the distinct low s bits of the selected indices, ascending, so a dense
  // stage's pairs run in order: (s, m) is first if no m' < m has its low
  // bits, and a first one's place is the number of firsts below it
  const int sk = p1 * k1;
  for (int e = tid; e < sk; e += kRowThreads) {
    const int st = e / k1, m = e % k1, mask = (1 << st) - 1;
    const int v = idx[m] & mask;
    bool first = true;
    for (int mm = 0; mm < m; ++mm) first &= (idx[mm] & mask) != v;
    flag[e] = first;
  }
  __syncthreads();
  for (int e = tid; e < sk; e += kRowThreads) {
    const int st = e / k1, m = e % k1, mask = (1 << st) - 1;
    const int v = idx[m] & mask;
    int below = 0, firsts = 0;
    for (int mm = 0; mm < k1; ++mm) {
      firsts += flag[st * k1 + mm];
      below += flag[st * k1 + mm] && (idx[mm] & mask) < v;
    }
    if (flag[e]) pat[st * kMaxK + below] = v;
    if (m == 0) cnt[st] = firsts;
  }
  __syncthreads();
  // the stages of stride below 32 (s < s0) run within a warp, the rest
  // pair by pair
  const int s0 = n1 >= 32 ? 5 : 0;
  if (tid == 0) {
    int end = n_in, off = 0;
    for (int s = 0; s < p1; ++s) {
      nblk[s] = (end + (2 << s) - 1) >> (s + 1);
      end = nblk[s] << (s + 1);
      const int np = cnt[s] * nblk[s];
      toff[s] = s >= s0 && off + np <= P.tab_pairs ? off : -1;
      if (toff[s] >= 0) off += np;
    }
  }
  __syncthreads();
  // pair q of stage s: i = (block << (s+1)) | pattern, j = i | 2^s
  auto pair_i = [&](int s, int q) {
    return ((q / cnt[s]) << (s + 1)) | pat[s * kMaxK + q % cnt[s]];
  };
  // the pair table: each pair's i and its weights (a_i, b_i, a_j, b_j),
  // exact in bfloat16; the entries of all stages at once, eight loads of four
  // weights in flight per thread. tend[s]: the table's end after stage s
  int tend[kMaxP];
  int tab_n = 0;
#pragma unroll
  for (int s = 0; s < kMaxP; ++s) {
    if (s < p1 && toff[s] >= 0) tab_n = toff[s] + cnt[s] * nblk[s];
    tend[s] = tab_n;
  }
  for (int e0 = tid; e0 < tab_n; e0 += 8 * kRowThreads) {
    float w[8][4];
    int iq[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kRowThreads;
      if (e >= tab_n) continue;
      int s = 0;
#pragma unroll
      for (int k = 0; k < kMaxP; ++k) s += tend[k] <= e;
      iq[u] = pair_i(s, e - toff[s]);
      const int j = iq[u] | (1 << s);
      const float* a = b_in + (size_t)(2 * s) * n1;
      w[u][0] = a[iq[u]];
      w[u][1] = a[n1 + iq[u]];
      w[u][2] = a[j];
      w[u][3] = a[n1 + j];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kRowThreads;
      if (e >= tab_n) break;
      const __nv_bfloat162 wi = __floats2bfloat162_rn(w[u][0], w[u][1]);
      const __nv_bfloat162 wj = __floats2bfloat162_rn(w[u][2], w[u][3]);
      tw[e] = make_uint2(*reinterpret_cast<const uint32_t*>(&wi),
                         *reinterpret_cast<const uint32_t*>(&wj));
      ti[e] = static_cast<unsigned short>(iq[u]);
    }
  }
  // stages 0..4's weights (a_i, b_i) of the elements holding nonzeros, as a
  // bfloat16 pair each, eight loads in flight per thread
  uint32_t* wt = reinterpret_cast<uint32_t*>(smem + P.wtab_off);  // [5][n1]
  const int wn = ((n_in + 31) >> 5) << 5;
  if (P.wtab) {
    for (int e0 = tid; e0 < 5 * wn; e0 += 8 * kRowThreads) {
      float w[8][2];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kRowThreads, st = e / wn, i = e % wn;
        if (e < 5 * wn) {
          w[u][0] = b_in[(size_t)(2 * st) * n1 + i];
          w[u][1] = b_in[(size_t)(2 * st + 1) * n1 + i];
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * kRowThreads;
        if (e >= 5 * wn) break;
        const __nv_bfloat162 v = __floats2bfloat162_rn(w[u][0], w[u][1]);
        wt[(e / wn) * n1 + e % wn] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  }
  for (int e = tid; e < (kBM - live) * kp1; e += kRowThreads)
    h1s[(live + e / kp1) * P.h1_ld + e % kp1] = 0.f;
  // x in 16-byte loads, a batch's eight per thread in flight at once; the
  // next batch's are issued before the current one's stages run
  constexpr int vw = 16 / sizeof(T);
  const int segs = n1 / vw;
  uint4 v[8];
  auto load_x = [&](int r0) {
    const int items = (live - r0 < rb ? live - r0 : rb) * segs;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = tid + u * kRowThreads, c = (e % segs) * vw;
      v[u] = make_uint4(0, 0, 0, 0);
      if (e < items && c < n_in)
        v[u] = *reinterpret_cast<const uint4*>(
            x + (size_t)(row0 + r0 + e / segs) * n_in + c);
    }
  };
  if (vec_in) load_x(0);
  for (int r0 = 0; r0 < live; r0 += rb) {
    const int nr = live - r0 < rb ? live - r0 : rb;
    if (vec_in) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = tid + u * kRowThreads;
        if (e >= nr * segs) break;
        const T* t = reinterpret_cast<const T*>(&v[u]);
        float4* dst = reinterpret_cast<float4*>(buf + (e / segs) * ld +
                                                (e % segs) * vw);
        dst[0] = make_float4(to_f32<T>(t[0]), to_f32<T>(t[1]),
                             to_f32<T>(t[2]), to_f32<T>(t[3]));
        dst[1] = make_float4(to_f32<T>(t[4]), to_f32<T>(t[5]),
                             to_f32<T>(t[6]), to_f32<T>(t[7]));
      }
      if (r0 + rb < live) load_x(r0 + rb);
    } else {
      for (int e = tid; e < nr * n1; e += kRowThreads) {
        const int r = e / n1, c = e % n1;
        buf[r * ld + c] = c < n_in
            ? to_f32<T>(x[(size_t)(row0 + r0 + r) * n_in + c]) : 0.f;
      }
    }
    __syncthreads();
    if (s0 > 0) {
      // stages 0..4 on each aligned group of 32 elements that holds
      // nonzeros: a lane per element, its partner by shuffle, eight rows in
      // flight, the group's weights in registers over the batch's rows,
      // y[i] = a[i] x[i] + b[i] x[i ^ 2^s] as the twin rounds it
      const int warp = tid >> 5, lane = tid & 31;
      const int ng = (n_in + 31) >> 5;
      // the weights of stage s at element i, from the table or device memory
      auto weight = [&](int st, int i, float& a, float& b) {
        if (P.wtab) {
          const uint32_t t = wt[st * n1 + i];
          const __nv_bfloat162 ab = *reinterpret_cast<const __nv_bfloat162*>(
              &t);
          a = __low2float(ab);
          b = __high2float(ab);
        } else {
          a = rnd<T>(b_in[(size_t)(2 * st) * n1 + i]);
          b = rnd<T>(b_in[(size_t)(2 * st + 1) * n1 + i]);
        }
      };
      for (int gr = warp; gr < ng; gr += kRowThreads / 32) {
        const int i = (gr << 5) | lane;
        float wa[5], wb[5];
#pragma unroll
        for (int s = 0; s < 5; ++s) weight(s, i, wa[s], wb[s]);
        for (int r = 0; r < nr; r += 8) {
          float y[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            y[u] = r + u < nr ? buf[(r + u) * ld + i] : 0.f;
#pragma unroll
          for (int s = 0; s < 5; ++s)
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const float p = __shfl_xor_sync(0xffffffffu, y[u], 1 << s);
              y[u] = __fadd_rn(__fmul_rn(wa[s], y[u]), __fmul_rn(wb[s], p));
            }
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (r + u < nr) buf[(r + u) * ld + i] = y[u];
        }
      }
      __syncthreads();
    }
    for (int s = s0; s < p1; ++s) {
      const int pairs = cnt[s] * nblk[s];
      // g row groups per pair so that every thread has work; thread t takes
      // pair t / g and the rows t % g, t % g + g, ..., eight in flight
      int g = kRowThreads / pairs;
      g = g < 1 ? 1 : (g > nr ? nr : g);
      const float* a = b_in + (size_t)(2 * s) * n1;
      const float* b = a + n1;
      for (int t = tid; t < pairs * g; t += kRowThreads) {
        const int q = t / g;
        const int i = toff[s] >= 0 ? ti[toff[s] + q] : pair_i(s, q);
        const int j = i | (1 << s);
        float4 w;
        if (toff[s] >= 0) {
          const uint2 tv = tw[toff[s] + q];
          const __nv_bfloat162 wi = *reinterpret_cast<const __nv_bfloat162*>(
              &tv.x);
          const __nv_bfloat162 wj = *reinterpret_cast<const __nv_bfloat162*>(
              &tv.y);
          w = make_float4(__low2float(wi), __high2float(wi), __low2float(wj),
                          __high2float(wj));
        } else {
          w = make_float4(rnd<T>(a[i]), rnd<T>(b[i]), rnd<T>(a[j]),
                          rnd<T>(b[j]));
        }
        for (int r = t % g; r < nr; r += 8 * g) {
          float xi[8], xj[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (r + u * g < nr) {
              xi[u] = buf[(r + u * g) * ld + i];
              xj[u] = buf[(r + u * g) * ld + j];
            }
          }
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (r + u * g < nr) {
              buf[(r + u * g) * ld + i] =
                  __fadd_rn(__fmul_rn(w.x, xi[u]), __fmul_rn(w.y, xj[u]));
              buf[(r + u * g) * ld + j] =
                  __fadd_rn(__fmul_rn(w.z, xj[u]), __fmul_rn(w.w, xi[u]));
            }
          }
        }
      }
      __syncthreads();
    }
    for (int e = tid; e < nr * kp1; e += kRowThreads) {
      const int r = e / kp1, m = e % kp1;
      h1s[(r0 + r) * P.h1_ld + m] =
          m < k1 ? rnd<T>(buf[r * ld + idx[m]]) * scale_in : 0.f;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads) sandwich_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ b_in,
    const int* __restrict__ idx_in, const float* __restrict__ fin,
    const float* __restrict__ core, const void* __restrict__ fout,
    T* __restrict__ out, int rows, int n_in, int n1, int k1, int kp1,
    int ld1, int k2, int kp2, int ld2, int n_out, int groups,
    float scale_in, float scale_out, int vec_in, int vec_out) {
  constexpr bool f32 = std::is_same<T, float>::value;
  constexpr int vw = 16 / sizeof(T);
  extern __shared__ __align__(16) char smem[];
  const RowPlan P = row_plan<T>(k1, k2, kp1, kp2, n1);
  float* core_s = reinterpret_cast<float*>(smem + P.core_off);
  float* h1s = reinterpret_cast<float*>(smem + P.h1_off);
  T* zs = reinterpret_cast<T*>(smem + P.z_off);
  char* pipe = smem + P.pipe_off;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (blockIdx.x / groups) * kBM;
  const int grp = blockIdx.x % groups;
  const int chunks = ld2 / kBN;
  const int cbeg = (int)((long long)grp * chunks / groups);
  const int cend = (int)((long long)(grp + 1) * chunks / groups);

  for (int i = tid; i < k1 * k2; i += kRowThreads) core_s[i] = core[i];

  // 1. h1 = rnd_T(select(B_in x)) · scale_in (ends in a barrier, which
  //    also publishes core_s)
  // the factors come from the kernel launched just before this one, which
  // may still run (programmatic dependent launch): wait before reading them
  if constexpr (f32) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    product_in_dot(x, fin, smem, P, h1s, row0, rows, n_in, kp1, ld1,
                   scale_in, vec_in);
  }
  else
    product_in_chain(x, b_in, idx_in, smem, P, h1s, row0, rows, n_in, n1, k1,
                     kp1, scale_in, vec_in);

  // 2. z = rnd_T((h1 · coreᵀ) · scale_out), zeros in the padded columns
  for (int e = tid; e < kBM * kp2; e += kRowThreads) {
    const int r = e / kp2, m = e % kp2;
    float v = 0.f;
    if (m < k2) {
      float acc = 0.f;
      for (int i = 0; i < k1; ++i)
        acc += core_s[m * k1 + i] * h1s[r * P.h1_ld + i];
      v = rnd<T>(acc * scale_out);
    }
    zs[r * P.z_ld + m] = from_f32<T>(v);
  }

  // 3. out = rnd_T(z · F_out) over the group's column chunks
  if constexpr (!f32) asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const T* fo_base = static_cast<const T*>(fout);  // hi (bf16) or F
  auto slot = [&](int s) {
    return reinterpret_cast<T*>(pipe + (size_t)s * P.c_stage);
  };
  auto load = [&](int s, int c) {
    T* fs = slot(s);
    const int segs = kBN / vw;
    const int frows = (f32 ? 1 : 2) * kp2;
    for (int e = tid; e < frows * segs; e += kRowThreads) {
      const int r = e / segs, sg = e % segs;
      cp_async16(fs + r * P.fo_ld + sg * vw,
                 fo_base + (size_t)r * ld2 + c * kBN + sg * vw, true);
    }
  };
  for (int s = 0; s < kStages - 1; ++s) {
    if (cbeg + s < cend) load(s, cbeg + s);
    cp_async_commit();
  }
  __syncthreads();                              // zs complete

  if constexpr (f32) {
    // thread: rows 8·rq .. +7, columns 4·cq .. +3 of the chunk
    const int rq = tid >> 5, cq = lane;
    for (int c = cbeg; c < cend; ++c) {
      const int i = c - cbeg;
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (c + kStages - 1 < cend) load((i + kStages - 1) % kStages,
                                       c + kStages - 1);
      cp_async_commit();
      const float* fs = slot(i % kStages);
      float acc[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[a][v] = 0.f;
      for (int m = 0; m < k2; ++m) {
        const float4 fv =
            *reinterpret_cast<const float4*>(fs + m * P.fo_ld + 4 * cq);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float zr = zs[(8 * rq + a) * P.z_ld + m];
          acc[a][0] += zr * fv.x;
          acc[a][1] += zr * fv.y;
          acc[a][2] += zr * fv.z;
          acc[a][3] += zr * fv.w;
        }
      }
      const int gc = c * kBN + 4 * cq;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int gr = row0 + 8 * rq + a;
        if (gr >= rows) break;
        float* o = reinterpret_cast<float*>(out) + (size_t)gr * n_out + gc;
        if (vec_out && gc < n_out) {
          __stcs(reinterpret_cast<float4*>(o),
                 make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
        } else {
#pragma unroll
          for (int v = 0; v < 4; ++v)
            if (gc + v < n_out) o[v] = acc[a][v];
        }
      }
    }
  } else {
    // warp: rows 16·mt .. +15, columns 64·nh .. +63 of the chunk
    const int mt = warp & 3, nh = warp >> 2, g = lane >> 2, tg = lane & 3;
    const int ksteps = kp2 / 16;
    uint32_t a[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks < ksteps) {
        const int r = 16 * mt + g, kk = 16 * ks + 2 * tg;
        a[ks][0] = lds32(zs + r * P.z_ld + kk);
        a[ks][1] = lds32(zs + (r + 8) * P.z_ld + kk);
        a[ks][2] = lds32(zs + r * P.z_ld + kk + 8);
        a[ks][3] = lds32(zs + (r + 8) * P.z_ld + kk + 8);
      }
    }
    T* stg = reinterpret_cast<T*>(smem + P.stg_off);
    const int mi = lane >> 3, mr = lane & 7;
    for (int c = cbeg; c < cend; ++c) {
      const int i = c - cbeg;
      cp_async_wait<kStages - 2>();
      __syncthreads();
      if (c + kStages - 1 < cend) load((i + kStages - 1) % kStages,
                                       c + kStages - 1);
      cp_async_commit();
      const T* fh = slot(i % kStages);
      const T* fl = fh + kp2 * P.fo_ld;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks < ksteps) {
#pragma unroll
          for (int pp = 0; pp < 4; ++pp) {
            const int off = (16 * ks + (mi & 1) * 8 + mr) * P.fo_ld + 64 * nh
                            + 16 * pp + (mi >> 1) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, fh + off);
            ldmatrix_x4_trans(bl, fl + off);
            mma_bf16(acc[2 * pp], a[ks], bh[0], bh[1]);
            mma_bf16(acc[2 * pp + 1], a[ks], bh[2], bh[3]);
            mma_bf16(acc[2 * pp], a[ks], bl[0], bl[1]);
            mma_bf16(acc[2 * pp + 1], a[ks], bl[2], bl[3]);
          }
        }
      }
      const int r = 16 * mt + g;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nh + 8 * j + 2 * tg;
        *reinterpret_cast<uint32_t*>(stg + r * P.fo_ld + col) =
            pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(stg + (r + 8) * P.fo_ld + col) =
            pack_bf16(acc[j][2], acc[j][3]);
      }
      __syncthreads();
      const int segs = kBN / vw;
      for (int e = tid; e < kBM * segs; e += kRowThreads) {
        const int rr = e / segs, sg = e % segs;
        const int gr = row0 + rr, gc = c * kBN + sg * vw;
        if (gr >= rows || gc >= n_out) continue;
        T* o = out + (size_t)gr * n_out + gc;
        const T* s = stg + rr * P.fo_ld + sg * vw;
        if (vec_out) {
          __stcs(reinterpret_cast<float4*>(o),
                 *reinterpret_cast<const float4*>(s));
        } else {
          for (int v = 0; v < vw && gc + v < n_out; ++v) o[v] = s[v];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <typename T>
cudaError_t launch_rows(const void* x, const float* b_in, const int* idx_in,
                        const float* fin, const float* core, const void* fout,
                        void* out, int rows, int n_in, int n1, int k1,
                        int kp1, int ld1, int k2, int kp2, int ld2,
                        int n_out, int groups, float scale_in,
                        float scale_out, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    // all the shared memory a block may take, and the SM's carveout at its
    // largest, so that two blocks of a large plan share an SM
    cudaError_t err = cudaFuncSetAttribute(
        sandwich_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          sandwich_rows_kernel<T>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const RowPlan P = row_plan<T>(k1, k2, kp1, kp2, n1);
  constexpr int vw = 16 / sizeof(T);
  // the bfloat16 chain loads a batch's x as eight 16-byte loads a thread
  // at most: wider batches (one row of n1 > 16384) load element by element
  const int vec_in = n_in % vw == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     (std::is_same<T, float>::value ||
                      P.chain_rb * (n1 / vw) <= 8 * kRowThreads);
  const int vec_out = n_out % vw == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int tiles = (rows + kBM - 1) / kBM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * groups);
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = P.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, sandwich_rows_kernel<T>, static_cast<const T*>(x), b_in, idx_in,
      fin, core, fout, static_cast<T*>(out), rows, n_in, n1, k1, kp1, ld1,
      k2, kp2, ld2, n_out, groups, scale_in, scale_out, vec_in, vec_out);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the type the weights are rounded to).
// f_in (kp1, ld1) and f_out (kp2, ld2) float32; hl_out (2, kp2, ld2), where
// not null, receives F_out's hi then lo (bfloat16 only: the forward's
// tensor-core operand; the backward passes null). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int sandwich_factors(const float* b_in, const float* b_out,
                                const int* idx_in, const int* idx_out,
                                float* f_in, float* f_out, void* hl_out,
                                int n1, int k1, int n_in, int kp1, int ld1,
                                int n2, int k2, int n_out, int kp2, int ld2,
                                int dtype, void* stream) {
  if (!valid_factors(n1, k1, n_in, kp1, ld1, n2, k2, n_out, kp2, ld2))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_factors<float>(b_in, b_out, idx_in, idx_out, f_in, f_out,
                                 nullptr, nullptr, n1, k1, n_in, kp1, ld1,
                                 n2, k2, n_out, kp2, ld2, s);
  if (dtype == 1)
    return launch_factors<__nv_bfloat16>(b_in, b_out, idx_in, idx_out, f_in,
                                         f_out, nullptr, hl_out, n1, k1,
                                         n_in, kp1, ld1, n2, k2, n_out, kp2,
                                         ld2, s);
  return cudaErrorInvalidValue;
}

// x (rows, n_in) and out (rows, n_out) in dtype (0 = float32, 1 =
// bfloat16); b_in (p1, 2, n1) and idx_in (k1,) the input butterfly (its
// stage chain is the bfloat16 route's product 1), f_in and fout the factors
// as `sandwich_factors` wrote them: f_in float32 (the float32 route's
// product 1), fout F_out float32 for float32 and its hi/lo pair for
// bfloat16. Returns the cudaError_t of the launch.
static int sandwich_rows(const void* x, const float* b_in, const int* idx_in,
                         const float* f_in, const float* core,
                         const void* fout, void* out, int rows, int n_in,
                         int n1, int k1, int kp1, int ld1, int k2, int kp2,
                         int ld2, int n_out, int groups, float scale_in,
                         float scale_out, int dtype, void* stream) {
  const int p1 = log2_exact(n1);
  if (rows < 1 || groups < 1 || groups > ld2 / kBN || p1 < 1 ||
      n1 > kMaxN1 || n_in > n1 || k1 < 1 || k2 < 1 || k1 > kp1 ||
      k2 > kp2 || kp1 > kMaxK || kp2 > kMaxK || kp1 % kPadK != 0 ||
      kp2 % kPadK != 0 || n_in > ld1 || n_out > ld2 || ld1 % kBN != 0 ||
      ld2 % kBN != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_rows<float>(x, b_in, idx_in, f_in, core, fout, out, rows,
                              n_in, n1, k1, kp1, ld1, k2, kp2, ld2, n_out,
                              groups, scale_in, scale_out, s);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(x, b_in, idx_in, f_in, core, fout,
                                      out, rows, n_in, n1, k1, kp1, ld1, k2,
                                      kp2, ld2, n_out, groups, scale_in,
                                      scale_out, s);
  return cudaErrorInvalidValue;
}

// The forward of one call: the factor kernel into `ws`, laid out as F_in
// (kp1, ld1) and F_out (kp2, ld2) float32 and for bfloat16 F_out's hi/lo
// pair (2, kp2, ld2), then the row kernel over `groups` column groups, both
// on `stream`. Returns the first cudaError_t (0 on success).
extern "C" int sandwich_fwd(const void* x, const float* b_in,
                            const float* core, const float* b_out,
                            const int* idx_in, const int* idx_out, void* out,
                            void* ws, int rows, int n_in, int n1, int k1,
                            int n2, int k2, int n_out, int kp1, int ld1,
                            int kp2, int ld2, int groups, float scale_in,
                            float scale_out, int dtype, void* stream) {
  float* f_in = static_cast<float*>(ws);
  float* f_out = f_in + (size_t)kp1 * ld1;
  void* hl_out = dtype == 1 ? f_out + (size_t)kp2 * ld2 : nullptr;
  int err = sandwich_factors(b_in, b_out, idx_in, idx_out, f_in, f_out,
                             hl_out, n1, k1, n_in, kp1, ld1, n2, k2, n_out,
                             kp2, ld2, dtype, stream);
  if (err != 0) return err;
  return sandwich_rows(x, b_in, idx_in, f_in, core,
                       dtype == 1 ? hl_out : static_cast<void*>(f_out), out,
                       rows, n_in, n1, k1, kp1, ld1, k2, kp2, ld2, n_out,
                       groups, scale_in, scale_out, dtype, stream);
}
