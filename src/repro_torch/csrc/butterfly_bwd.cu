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
// That is stage_applies(p) <= 3p stage applications a row; the first row's
// count is written to `applied` so a caller can hold it to the reference's
// schedule. Chains run in float32 over weights rounded to x's dtype (the
// forward kernel's precision points, two rounded products and their rounded
// sum, so dx has the plain twin's bits); dx is rounded to x's dtype once,
// when stored; dw (p, 2, n) is float32, taken w.r.t. the rounded weights.
//
// What bounds it on the H100: bytes, then the float work. Per row it reads
// x and g and writes dx (3·n values); the weights are read and dw written
// once per call. At the encoder's 70,000 x 1024 float32 shape that is 860
// MB (0.26 ms at 3.35 TB/s; 573 MB and 0.17 ms without dx). Its float32
// operations, 3n for each of the 25 stage applications at p = 10 and 4n for
// each stage's two weight products, come to 8.2 GFLOP (0.12 ms at 67
// TFLOP/s).
//
// What the design does about it:
// * A segment's stages act on seg consecutive bits of the element index.
//   So each pass of the schedule (a segment of the forward sweep, or the
//   recompute and duals of one segment in the reverse sweep) runs in
//   registers on groups: the 2^len elements that differ only in the
//   segment's bits. A thread holds two elements of a group (the lowest
//   group bit in its registers), the group's other bits are lane bits
//   (shuffles). All of a pass's stages run without a barrier; between
//   passes the tile's rows go through shared memory, one barrier a pass
//   (2·ceil(p/seg) - 1 a tile), not one a stage.
// * A block of 512 threads takes a tile of rows: x, the checkpoints and g
//   of every row of the tile live in shared memory (rows padded by 4
//   floats every 32, which spreads most passes' lanes over the banks),
//   loaded and stored with coalesced row-major copies. Each thread works
//   2 rows at once. For float32 up to n = 4096 the block keeps a second x
//   and g buffer and copies the next tile in by cp.async while this one's
//   passes run.
// * For n <= 1024 each thread owns the same elements of every row of the
//   tile in a given pass: n/2 threads cover a row, 1024/n rows side by
//   side. So the rounded weights of its elements for every stage (4p
//   values) and its da/db sums (4p values) stay in its registers for the
//   whole launch: no weight is read twice, no partial is read and written
//   per row. At the end the block's sums over the rows side by side are
//   added in their order into the block's float32 partial.
// * For n > 1024 a thread owns n/1024 groups' elements; weights come from
//   device memory through L1 and its da/db sums go to the block's partial
//   in device memory, each entry owned by one thread (no atomics). Where
//   one row's buffers do not fit in shared memory (n = 16384 and 32768)
//   the tile is one row in device memory.
// * dw: the block's partials are summed over blocks, in block order, by a
//   second launch. No atomics; a thread adds its rows in row order, a block
//   its row slots in slot order: two launches give the same bits, with or
//   without dx. kernels/butterfly.py:butterfly_bwd_tiled_plain is the plain
//   twin of that order.
// * The launch plan (tile rows, blocks) is computed once per shape by the
//   wrapper, the shared-memory opt-in once per kernel instance and device.

#include <cuda_pipeline.h>

#include "butterfly_common.cuh"

namespace {

using namespace butterfly;

constexpr int kThreads = 512;
constexpr int kSmemMax = 227 * 1024;
constexpr int kReduceThreads = 256;

template <int P>
struct Bwd {
  static constexpr int N = 1 << P;
  static constexpr int SEG = seg_of(P);
  static constexpr int NCK = (P + SEG - 1) / SEG;      // checkpoints (x first)
  static constexpr int TPR = N / 2;                    // threads a row
  static constexpr bool kReg = TPR <= kThreads;        // weights, dw in regs
  static constexpr int RS = kReg ? kThreads / TPR : 1;  // rows side by side
  static constexpr int K = kReg ? 1 : TPR / kThreads;  // groups parts a thread
  static constexpr int RF = kReg ? 2 : 1;              // rows a thread at once
  static constexpr int UNIT = RS * RF;                 // tiles are multiples
  static constexpr int LD = N >= 32 ? N + N / 8 : N;   // padded row
  static constexpr int STASH = kReg && RS > 1 ? 4 * RS * 2 * P * N : 0;
};

// Segment C of the chain: positions [J0, J1), stages on element bits
// [LO, LO + LEN), of which LO is a register bit and the LL others lane bits.
template <int P, bool kTr, int C>
struct Seg {
  static constexpr int J0 = C * seg_of(P);
  static constexpr int J1 = J0 + seg_of(P) < P ? J0 + seg_of(P) : P;
  static constexpr int LEN = J1 - J0;
  static constexpr int LO = kTr ? P - J1 : J0;
  static constexpr int LL = LEN - 1;
  // element k (0 or 1) of group part pt: group bit 0 is k, group bits
  // 1..LEN-1 the low LL bits of pt, the other bits of pt the column
  __device__ __forceinline__ static int elem(int pt, int k) {
    const int gl = pt & ((1 << LL) - 1), col = pt >> LL;
    return ((col >> LO) << (LO + LEN)) | (((gl << 1) | k) << LO) |
           (col & ((1 << LO) - 1));
  }
};

__device__ __forceinline__ int pad(int i) { return i + ((i >> 5) << 2); }

// Whether float32 tiles in shared memory take a second x and g buffer, so
// that the next tile's rows are copied in while this one's passes run (n
// from 4, whole 16-byte copies, up to 4096; at 8192 one tile row of seven
// buffers passes 227 KB).
template <typename T, int P>
constexpr bool kDouble =
    std::is_same<T, float>::value && P >= 2 &&
    4LL * (Bwd<P>::NCK + 3) * Bwd<P>::LD * Bwd<P>::UNIT <= kSmemMax;

// Row buffers of a tile: the checkpoints (x first), g, and for kDouble in
// shared memory the next tile's x and g.
template <typename T, int P>
__host__ __device__ constexpr int bufs(bool in_global) {
  return Bwd<P>::NCK + 1 + (kDouble<T, P> && !in_global ? 2 : 0);
}

// The tile's rows [t0, t0 + nt) of x and g into xb and gb (padded rows of
// LD floats), as float32.
template <typename T, int P>
__device__ __forceinline__ void copy_tile(const T* __restrict__ x,
                                          const T* __restrict__ g, int t0,
                                          int nt, float* xb, float* gb) {
  constexpr int N = 1 << P, LD = Bwd<P>::LD;
  for (int e = threadIdx.x; e < nt * N; e += kThreads) {
    const int r = e / N, i = e % N;
    const size_t at = (size_t)(t0 + r) * N + i;
    xb[r * LD + pad(i)] = to_f32<T>(x[at]);
    gb[r * LD + pad(i)] = to_f32<T>(g[at]);
  }
}

// The same for float32 rows, as 16-byte asynchronous copies (cp.async),
// committed as one group.
template <int P>
__device__ __forceinline__ void copy_tile_async(const float* __restrict__ x,
                                                const float* __restrict__ g,
                                                int t0, int nt, float* xb,
                                                float* gb) {
  constexpr int N = 1 << P, LD = Bwd<P>::LD;
  for (int e = 4 * threadIdx.x; e < nt * N; e += 4 * kThreads) {
    const int r = e / N, i = e % N;
    const size_t at = (size_t)(t0 + r) * N + i;
    __pipeline_memcpy_async(xb + r * LD + pad(i), x + at, 16);
    __pipeline_memcpy_async(gb + r * LD + pad(i), g + at, 16);
  }
  __pipeline_commit();
}

// A thread's state for n <= 1024: the rounded weights of its elements for
// every stage and its da/db sums (one element row for n > 1024, unused).
template <int P>
struct Regs {
  static constexpr int W = Bwd<P>::kReg ? P : 1;
  float wa[W][2], wb[W][2], da[W][2], db[W][2];
};

// One work item of a pass: the thread's group part and RF rows of the tile,
// with which rows are real (the last tile may be short).
template <int P>
struct Item {
  int pt;
  int ri[Bwd<P>::RF];
  bool ok[Bwd<P>::RF];
};

// (a, b) of stage S at the group part's elements k = 0, 1 (segment C)
template <typename T, bool kTr, int P, int C, int S>
__device__ __forceinline__ void stage_weights(const Regs<P>& st,
                                              const float* __restrict__ w,
                                              int pt, float (&a)[2],
                                              float (&b)[2]) {
  constexpr int N = 1 << P;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if constexpr (Bwd<P>::kReg) {
      a[k] = st.wa[S][k];
      b[k] = st.wb[S][k];
    } else {
      const int i = Seg<P, kTr, C>::elem(pt, k);
      a[k] = rnd<T>(__ldg(w + (size_t)(2 * S) * N + i));
      b[k] = rnd<T>(__ldg(w + (size_t)(2 * S + 1) * N + i));
    }
  }
}

template <bool kTr, int P, int J>
__host__ __device__ constexpr int stage_of() {
  return kTr ? P - 1 - J : J;
}

// The stage at chain position J (in segment C) on v[k][f], the group
// part's two elements of RF rows.
template <typename T, bool kTr, int P, int C, int J>
__device__ __forceinline__ void stage_at(const Regs<P>& st,
                                         const float* __restrict__ w, int pt,
                                         float (&v)[2][Bwd<P>::RF]) {
  constexpr int RF = Bwd<P>::RF, S = stage_of<kTr, P, J>();
  constexpr int gb = S - Seg<P, kTr, C>::LO;
  float a[2], b[2];
  stage_weights<T, kTr, P, C, S>(st, w, pt, a, b);
  if constexpr (gb == 0) {
    pair_stage<kTr, RF>(v[0], v[1], a[0], b[0], a[1], b[1]);
  } else {
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int f = 0; f < RF; ++f)
        v[k][f] = lane_stage<kTr>(v[k][f], a[k], b[k], 1 << (gb - 1));
  }
}

// The dual of the stage at chain position J: g (its output's cotangent) and
// its input act. Adds g ⊙ act and the swapped product to da, db of the rows
// that are real, then g ← the cotangent of the stage's input.
template <typename T, bool kTr, int P, int C, int J>
__device__ __forceinline__ void dual_at(Regs<P>& st,
                                        const float* __restrict__ w,
                                        float* __restrict__ part,
                                        const Item<P>& it,
                                        float (&g)[2][Bwd<P>::RF],
                                        const float (&act)[2][Bwd<P>::RF]) {
  constexpr int N = 1 << P, RF = Bwd<P>::RF, S = stage_of<kTr, P, J>();
  constexpr int gb = S - Seg<P, kTr, C>::LO;
  float a[2], b[2];
  stage_weights<T, kTr, P, C, S>(st, w, it.pt, a, b);
  float pa[2][RF], pb[2][RF];  // this item's da, db terms
  if constexpr (gb == 0) {
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      pa[0][f] = mul(g[0][f], act[0][f]);
      pa[1][f] = mul(g[1][f], act[1][f]);
      pb[0][f] = kTr ? mul(g[1][f], act[0][f]) : mul(g[0][f], act[1][f]);
      pb[1][f] = kTr ? mul(g[0][f], act[1][f]) : mul(g[1][f], act[0][f]);
    }
    // the dual of a forward stage is a transposed stage and back
    pair_stage<!kTr, RF>(g[0], g[1], a[0], b[0], a[1], b[1]);
  } else {
    constexpr int mask = 1 << (gb - 1);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int f = 0; f < RF; ++f) {
        const float gv = g[k][f], tv = act[k][f];
        pa[k][f] = mul(gv, tv);
        if (kTr) {
          const float gp = shfl(gv, mask);
          pb[k][f] = mul(gp, tv);
          g[k][f] = mix(a[k], gv, b[k], gp);
        } else {
          pb[k][f] = mul(gv, shfl(tv, mask));
          g[k][f] = add(mul(a[k], gv), shfl(mul(b[k], gv), mask));
        }
      }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      if (!it.ok[f]) continue;
      if constexpr (Bwd<P>::kReg) {
        st.da[S][k] = add(st.da[S][k], pa[k][f]);
        st.db[S][k] = add(st.db[S][k], pb[k][f]);
      } else {
        float* pe = part + (size_t)(2 * S) * N + Seg<P, kTr, C>::elem(it.pt, k);
        pe[0] = add(pe[0], pa[k][f]);
        pe[N] = add(pe[N], pb[k][f]);
      }
    }
}

// The work item number `m` of a pass: n <= 1024 walks the tile's rows of
// its slot RF at a time (every slot walks the whole tile, so the lanes of a
// warp stay together; rows past nt are computed, not used); n > 1024 walks
// its K group parts, each over the tile's rows.
template <int P>
__device__ __forceinline__ int items(int tile, int nt) {
  using B = Bwd<P>;
  return B::kReg ? tile / B::RS / B::RF : B::K * nt;
}

template <int P>
__device__ __forceinline__ Item<P> item(int m, int u, int pt0, int nt) {
  using B = Bwd<P>;
  Item<P> it;
  if constexpr (B::kReg) {
    it.pt = pt0;
#pragma unroll
    for (int f = 0; f < B::RF; ++f) {
      it.ri[f] = u + B::RS * (m * B::RF + f);
      it.ok[f] = it.ri[f] < nt;
    }
  } else {
    it.pt = pt0 + kThreads * (m / nt);
    it.ri[0] = m % nt;
    it.ok[0] = true;
  }
  return it;
}

// Forward sweep, segment C: checkpoint C + 1 from checkpoint C.
template <typename T, bool kTr, int P, int C>
__device__ __forceinline__ void forward_pass(const Regs<P>& st,
                                             const float* __restrict__ w,
                                             const float* src, float* dst,
                                             int tile, int nt, int u, int pt0,
                                             int& count, bool counting) {
  using B = Bwd<P>;
  using S = Seg<P, kTr, C>;
  constexpr int RF = B::RF, LD = B::LD;
  const int nm = items<P>(tile, nt);
  for (int m = 0; m < nm; ++m) {
    const Item<P> it = item<P>(m, u, pt0, nt);
    const int o0 = pad(S::elem(it.pt, 0)), o1 = pad(S::elem(it.pt, 1));
    float v[2][RF];
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      v[0][f] = src[it.ri[f] * LD + o0];
      v[1][f] = src[it.ri[f] * LD + o1];
    }
    static_for<S::J0, S::J1>([&](auto J) {
      stage_at<T, kTr, P, C, decltype(J)::value>(st, w, it.pt, v);
    });
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      dst[it.ri[f] * LD + o0] = v[0][f];
      dst[it.ri[f] * LD + o1] = v[1][f];
    }
    if (counting && m == 0) count += S::LEN;
  }
}

// Reverse sweep, segment C: recompute its stage inputs from its
// checkpoint, then its dual stages in reverse, g in gbuf.
template <typename T, bool kTr, int P, int C>
__device__ __forceinline__ void reverse_pass(Regs<P>& st,
                                             const float* __restrict__ w,
                                             float* part, const float* src,
                                             float* gbuf, bool store,
                                             int tile, int nt, int u, int pt0,
                                             int& count, bool counting) {
  using B = Bwd<P>;
  using S = Seg<P, kTr, C>;
  constexpr int RF = B::RF, LD = B::LD;
  const int nm = items<P>(tile, nt);
  for (int m = 0; m < nm; ++m) {
    const Item<P> it = item<P>(m, u, pt0, nt);
    const int o0 = pad(S::elem(it.pt, 0)), o1 = pad(S::elem(it.pt, 1));
    float act[S::LEN][2][RF], g[2][RF];
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      act[0][0][f] = src[it.ri[f] * LD + o0];
      act[0][1][f] = src[it.ri[f] * LD + o1];
    }
    static_for<0, S::LEN - 1>([&](auto Q) {
      constexpr int q = decltype(Q)::value;
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int f = 0; f < RF; ++f) act[q + 1][k][f] = act[q][k][f];
      stage_at<T, kTr, P, C, S::J0 + q>(st, w, it.pt, act[q + 1]);
    });
#pragma unroll
    for (int f = 0; f < RF; ++f) {
      g[0][f] = gbuf[it.ri[f] * LD + o0];
      g[1][f] = gbuf[it.ri[f] * LD + o1];
    }
    static_for<0, S::LEN>([&](auto Q) {
      constexpr int q = S::LEN - 1 - decltype(Q)::value;
      dual_at<T, kTr, P, C, S::J0 + q>(st, w, part, it, g, act[q]);
    });
    if (store) {
#pragma unroll
      for (int f = 0; f < RF; ++f) {
        gbuf[it.ri[f] * LD + o0] = g[0][f];
        gbuf[it.ri[f] * LD + o1] = g[1][f];
      }
    }
    if (counting && m == 0) count += 2 * S::LEN - 1;
  }
}

// The rounded weights of the thread's elements in segment C, and zero sums.
template <typename T, bool kTr, int P, int C>
__device__ __forceinline__ void load_weights(Regs<P>& st,
                                             const float* __restrict__ w,
                                             int pt0) {
  using S = Seg<P, kTr, C>;
  constexpr int N = 1 << P;
  static_for<S::J0, S::J1>([&](auto J) {
    constexpr int s = stage_of<kTr, P, decltype(J)::value>();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = S::elem(pt0, k);
      st.wa[s][k] = rnd<T>(w[(size_t)(2 * s) * N + i]);
      st.wb[s][k] = rnd<T>(w[(size_t)(2 * s + 1) * N + i]);
      st.da[s][k] = st.db[s][k] = 0.f;
    }
  });
}

// The thread's sums of segment C into dst (2·p·n floats, indexed as dw).
template <bool kTr, int P, int C>
__device__ __forceinline__ void store_sums(const Regs<P>& st, float* dst,
                                           int pt0) {
  using S = Seg<P, kTr, C>;
  constexpr int N = 1 << P;
  static_for<S::J0, S::J1>([&](auto J) {
    constexpr int s = stage_of<kTr, P, decltype(J)::value>();
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = S::elem(pt0, k);
      dst[(size_t)(2 * s) * N + i] = st.da[s][k];
      dst[(size_t)(2 * s + 1) * N + i] = st.db[s][k];
    }
  });
}

template <typename T, bool kTr, int P>
__global__ void __launch_bounds__(kThreads, 1) butterfly_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const T* __restrict__ gout, T* __restrict__ dx,
    float* __restrict__ partial, float* __restrict__ scratch,
    int* __restrict__ applied, int rows, int tile) {
  using B = Bwd<P>;
  constexpr int N = B::N, LD = B::LD;
  extern __shared__ float4 smem4[];
  float* const sm = reinterpret_cast<float*>(smem4);
  const bool in_global = scratch != nullptr;
  const size_t bstride = (size_t)tile * LD;
  float* const tb =
      in_global ? scratch + blockIdx.x * bufs<T, P>(true) * bstride : sm;
  // x and g of set 0, and of set 1 where the next tile is copied in during
  // this one: [x, ck1 .. ck(nck-1), g, x', g']
  auto xset = [&](int k) { return tb + (k ? B::NCK + 1 : 0) * bstride; };
  auto gset = [&](int k) { return tb + (B::NCK + 2 * k) * bstride; };
  bool async = false;
  if constexpr (kDouble<T, P>)
    async = !in_global && ((reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(gout)) & 15) == 0;
  float* const part = partial + (size_t)blockIdx.x * 2 * P * N;
  const int t = threadIdx.x;
  const int u = B::kReg ? t / B::TPR : 0;    // row slot
  const int pt0 = B::kReg ? t % B::TPR : t;  // first group part
  const int r0 = (int)((long long)blockIdx.x * rows / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * rows / gridDim.x);

  Regs<P> st;
  if constexpr (B::kReg) {
    static_for<0, B::NCK>([&](auto C) {
      load_weights<T, kTr, P, decltype(C)::value>(st, w, pt0);
    });
  } else {
    // the block's partial lives in device memory; zeroed before the first
    // tile's barrier, each entry then owned by one thread
    for (int e = t; e < 2 * P * N; e += kThreads) part[e] = 0.f;
  }

  int count = 0;  // stage applications for the first row
  auto copy_async = [&](int t0, float* xb, float* gb) {
    if constexpr (kDouble<T, P>)
      copy_tile_async<P>(reinterpret_cast<const float*>(x),
                         reinterpret_cast<const float*>(gout), t0,
                         min(tile, r1 - t0), xb, gb);
  };
  if (async) copy_async(r0, xset(0), gset(0));
  int set = 0;
  for (int t0 = r0; t0 < r1; t0 += tile, set ^= async) {
    const int nt = min(tile, r1 - t0);
    const bool counting = blockIdx.x == 0 && t0 == r0 && t == 0;
    float* const xb = xset(set);
    float* const gbuf = gset(set);
    if (async)
      __pipeline_wait_prior(0);
    else
      copy_tile<T, P>(x, gout, t0, nt, xb, gbuf);
    __syncthreads();
    if (async && t0 + tile < r1) copy_async(t0 + tile, xset(!set), gset(!set));
    static_for<0, B::NCK - 1>([&](auto C) {
      constexpr int c = decltype(C)::value;
      forward_pass<T, kTr, P, c>(st, w, c ? tb + c * bstride : xb,
                                 tb + (c + 1) * bstride, tile, nt, u, pt0,
                                 count, counting);
      __syncthreads();
    });
    static_for<0, B::NCK>([&](auto C) {
      constexpr int c = B::NCK - 1 - decltype(C)::value;
      reverse_pass<T, kTr, P, c>(st, w, part, c ? tb + c * bstride : xb,
                                 gbuf, c > 0 || dx != nullptr, tile, nt, u,
                                 pt0, count, counting);
      __syncthreads();
    });
    if (counting && applied != nullptr) *applied = count;
    if (dx != nullptr) {
      for (int e = t; e < nt * N; e += kThreads) {
        const int r = e / N, i = e % N;
        dx[(size_t)(t0 + r) * N + i] = from_f32<T>(gbuf[r * LD + pad(i)]);
      }
      // the next tile copies into these buffers only with a single set
      if (!async) __syncthreads();
    }
  }

  if constexpr (B::kReg) {
    // this thread's sums into the block's partial; rows side by side are
    // added in slot order through shared memory (after a barrier: the tile
    // buffers are free then)
    float* const dst = B::RS > 1 ? sm + (size_t)u * 2 * P * N : part;
    if constexpr (B::RS > 1) __syncthreads();
    static_for<0, B::NCK>([&](auto C) {
      store_sums<kTr, P, decltype(C)::value>(st, dst, pt0);
    });
    if constexpr (B::RS > 1) {
      __syncthreads();
      for (int e = t; e < 2 * P * N; e += kThreads) {
        float v = sm[e];
        for (int s = 1; s < B::RS; ++s)
          v = add(v, sm[(size_t)s * 2 * P * N + e]);
        part[e] = v;
      }
    }
  }
}

// dw[e] = the sum of the blocks' partials, in block order.
__global__ void __launch_bounds__(kReduceThreads) butterfly_bwd_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int blocks,
    int total) {
  for (int e = blockIdx.x * kReduceThreads + threadIdx.x; e < total;
       e += gridDim.x * kReduceThreads) {
    float acc = 0.f;
    for (int c = 0; c < blocks; ++c)
      acc = add(acc, partial[(size_t)c * total + e]);
    dw[e] = acc;
  }
}

// Shared bytes of a launch at `tile` rows: the tile's buffers (none where
// they live in device memory), at least the stash of the row slots' sums.
template <typename T, int P>
int smem_bytes(int tile, bool in_global) {
  using B = Bwd<P>;
  const long long b = in_global ? 0 : 4LL * bufs<T, P>(false) * B::LD * tile;
  return (int)(b > B::STASH ? b : B::STASH);
}

// The kernel instance for (T, kTr, P), opted in to the largest shared
// memory once per device.
template <typename T, bool kTr, int P>
cudaError_t instance(int* dev, int* sms) {
  static bool opted[kMaxDevices] = {};
  cudaError_t err = device_sms(dev, sms);
  if (err != cudaSuccess || opted[*dev]) return err;
  err = cudaFuncSetAttribute(butterfly_bwd_kernel<T, kTr, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) opted[*dev] = true;
  return err;
}

// sizes: blocks, partial floats, tile-workspace floats, tile rows
template <typename T, bool kTr, int P>
cudaError_t plan_p(int rows, long long* sizes) {
  using B = Bwd<P>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = instance<T, kTr, P>(&dev, &sms);
  if (err != cudaSuccess) return err;
  const long long row_bytes = 4LL * bufs<T, P>(false) * B::LD;
  long long max_tile = kSmemMax / (row_bytes * B::UNIT) * B::UNIT;
  const bool in_global = max_tile < B::UNIT;
  if (in_global) max_tile = B::UNIT;
  if (in_global) {
    per_sm = 1;  // each block keeps its tile in device memory
  } else if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &per_sm, butterfly_bwd_kernel<T, kTr, P>, kThreads,
                  smem_bytes<T, P>((int)max_tile, false))) != cudaSuccess) {
    return err;
  }
  const long long fit = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long tile = (rows + fit - 1) / fit;
  tile = (tile + B::UNIT - 1) / B::UNIT * B::UNIT;
  if (tile > max_tile) tile = max_tile;
  long long blocks = (rows + tile - 1) / tile;
  if (blocks > fit) blocks = fit;
  sizes[0] = blocks;
  sizes[1] = blocks * 2 * P * B::N;
  sizes[2] = in_global ? blocks * bufs<T, P>(true) * tile * B::LD : 0;
  sizes[3] = tile;
  return cudaSuccess;
}

template <typename T, bool kTr, int P>
cudaError_t launch_p(const void* x, const float* w, const void* g, void* dx,
                     float* dw, float* partial, float* scratch, int* applied,
                     int rows, int blocks, int tile, cudaStream_t stream) {
  using B = Bwd<P>;
  if (tile < 1 || (B::kReg && tile % B::UNIT != 0) ||
      (scratch == nullptr &&
       4LL * bufs<T, P>(false) * B::LD * tile > kSmemMax))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = instance<T, kTr, P>(&dev, &sms);
  if (err != cudaSuccess) return err;
  butterfly_bwd_kernel<T, kTr, P>
      <<<blocks, kThreads, smem_bytes<T, P>(tile, scratch != nullptr),
         stream>>>(static_cast<const T*>(x), w, static_cast<const T*>(g),
                   static_cast<T*>(dx), partial, scratch, applied, rows,
                   tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int total = 2 * P * B::N;
  const int want = (total + kReduceThreads - 1) / kReduceThreads;
  butterfly_bwd_reduce_kernel<<<want < 4096 ? want : 4096, kReduceThreads, 0,
                                stream>>>(partial, dw, blocks, total);
  return cudaGetLastError();
}

#define BUTTERFLY_BWD_CASES(F, ...)                                      \
  switch (p) {                                                           \
    case 1: return F<T, kTr, 1>(__VA_ARGS__);                            \
    case 2: return F<T, kTr, 2>(__VA_ARGS__);                            \
    case 3: return F<T, kTr, 3>(__VA_ARGS__);                            \
    case 4: return F<T, kTr, 4>(__VA_ARGS__);                            \
    case 5: return F<T, kTr, 5>(__VA_ARGS__);                            \
    case 6: return F<T, kTr, 6>(__VA_ARGS__);                            \
    case 7: return F<T, kTr, 7>(__VA_ARGS__);                            \
    case 8: return F<T, kTr, 8>(__VA_ARGS__);                            \
    case 9: return F<T, kTr, 9>(__VA_ARGS__);                            \
    case 10: return F<T, kTr, 10>(__VA_ARGS__);                          \
    case 11: return F<T, kTr, 11>(__VA_ARGS__);                          \
    case 12: return F<T, kTr, 12>(__VA_ARGS__);                          \
    case 13: return F<T, kTr, 13>(__VA_ARGS__);                          \
    case 14: return F<T, kTr, 14>(__VA_ARGS__);                          \
    case 15: return F<T, kTr, 15>(__VA_ARGS__);                          \
  }                                                                      \
  return cudaErrorInvalidValue

template <typename T, bool kTr>
cudaError_t plan(int p, int rows, long long* sizes) {
  BUTTERFLY_BWD_CASES(plan_p, rows, sizes);
}

template <typename T, bool kTr>
cudaError_t launch(int p, const void* x, const float* w, const void* g,
                   void* dx, float* dw, float* partial, float* scratch,
                   int* applied, int rows, int blocks, int tile,
                   cudaStream_t stream) {
  BUTTERFLY_BWD_CASES(launch_p, x, w, g, dx, dw, partial, scratch, applied,
                      rows, blocks, tile, stream);
}

#undef BUTTERFLY_BWD_CASES

bool bad_shape(int n, int p, int seg) {
  return p < 1 || n > kMaxN || seg != seg_of(p);
}

}  // namespace

// The launch plan for rows x n at segment seg (only ⌈√p⌉ is taken):
// sizes[0] the number of blocks, sizes[1] the floats of the partial
// workspace (blocks · 2pn), sizes[2] the floats of the tile workspace in
// device memory (0 where the tiles fit in shared memory), sizes[3] the rows
// of a tile. Returns 0, or cudaErrorInvalidValue for a shape the kernel does
// not take.
extern "C" int butterfly_bwd_plan(int rows, int n, int seg, int transposed,
                                  int dtype, long long* sizes) {
  const int p = log2_exact(n);
  if (bad_shape(n, p, seg) || rows < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return transposed ? plan<float, true>(p, rows, sizes)
                      : plan<float, false>(p, rows, sizes);
  if (dtype == 1)
    return transposed ? plan<__nv_bfloat16, true>(p, rows, sizes)
                      : plan<__nv_bfloat16, false>(p, rows, sizes);
  return cudaErrorInvalidValue;
}

// x, g (rows, n) contiguous in the dtype (0 = float32, 1 = bfloat16); w
// (p, 2, n) float32. Writes dx (rows, n) in the dtype unless dx is null,
// dw (p, 2, n) float32, and, unless `applied` is null, the first row's
// number of stage applications. partial, scratch: workspaces of the sizes
// butterfly_bwd_plan gives for the same rows, n, seg, with its blocks and
// tile rows. Returns the cudaError_t of the two launches (0 on success).
extern "C" int butterfly_bwd(const void* x, const float* w, const void* g,
                             void* dx, float* dw, float* partial,
                             float* scratch, int* applied, int rows, int n,
                             int seg, int blocks, int tile, int transposed,
                             int dtype, void* stream) {
  const int p = log2_exact(n);
  if (bad_shape(n, p, seg) || rows < 1 || blocks < 1 || blocks > rows)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BUTTERFLY_BWD(T, TR)                                                 \
  launch<T, TR>(p, x, w, g, dx, dw, partial, scratch, applied, rows, blocks, \
                tile, s)
  if (dtype == 0)
    return transposed ? BUTTERFLY_BWD(float, true)
                      : BUTTERFLY_BWD(float, false);
  if (dtype == 1)
    return transposed ? BUTTERFLY_BWD(__nv_bfloat16, true)
                      : BUTTERFLY_BWD(__nv_bfloat16, false);
#undef BUTTERFLY_BWD
  return cudaErrorInvalidValue;
}
