// Device code shared by the flash-attention kernels (flash.cu: the
// forward; flash_bwd.cu: dq and dkv): the mask and the sweep ranges, the
// tile shapes, 64-row tile loads by cp.async, the tensor-core pieces
// (mma.sync in bfloat16 and TF32, the 3xTF32 split, base-2 exp, the hi/lo
// bfloat16 pair, quad reductions), and the warp's tile products built on
// them, so that one precision rule holds in all three kernels.
//
// Layout: q/k/v/o (and dO, dq, dk, dv) are (B·H, S, D) contiguous, lse and
// Δ (B·H, S) float32. Every kernel runs blocks of four warps. A warp owns
// 16 rows of the block's tile (query rows in the forward and dq, key rows
// in dkv) and sweeps tiles of 64 rows of the other side; a score tile of a
// warp is 16 x 64, eight m16n8 accumulator fragments.
//
// Fragments of mma.sync.m16n8k{16,8} for a warp: lane = 4·g + t. The
// float32 accumulator C of a 16 x 8 tile holds (g, 2t), (g, 2t+1) in c0, c1
// and (g+8, 2t), (g+8, 2t+1) in c2, c3, for both shapes below.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sandwich_common.cuh"  // cp.async, ldmatrix, pack_bf16

namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Four warps a block, 16 rows a warp: 64 rows of a tile, forward and
// backward, swept and owned (the backward's blocks own 32 rows where two
// warps share 16, see BwdSplit).
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileRows = 16 * kWarps;

// The reference's mask (ref.flash_attention_ref, kernels/flash.py
// _tile_mask), plus the ragged edge: key `col` is visible from query `row`.
__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Key tiles [lo, hi) of `tile` rows that can hold a visible key for query
// rows [q0, q0 + rows) ∩ [0, S): from the first key inside the window of
// the first row to the diagonal of the last row (kernels/flash.py
// _kv_bounds, here exact for these tile sizes and a ragged last tile).
__device__ __forceinline__ void key_tiles(int q0, int rows, int tile, int S,
                                          int causal, int window, int* lo,
                                          int* hi) {
  const int q_last = min(q0 + rows, S) - 1;
  *hi = causal ? q_last / tile + 1 : (S + tile - 1) / tile;
  *lo = window > 0 ? max(0, q0 - window + 1) / tile : 0;
}

// Query tiles [lo, hi) of `tile` rows that can see a key of rows
// [k0, k0 + rows) ∩ [0, S): from the diagonal of the first key (causal) to
// the last query whose window still reaches the last key
// (kernels/flash.py:141-147).
__device__ __forceinline__ void query_tiles(int k0, int rows, int tile,
                                            int S, int causal, int window,
                                            int* lo, int* hi) {
  const int k_last = min(k0 + rows, S) - 1;
  *lo = causal ? k0 / tile : 0;
  *hi = window > 0 ? min(S - 1, k_last + window - 1) / tile + 1
                   : (S + tile - 1) / tile;
}

// Columns of a tile row in shared memory: bfloat16 rows zero-padded to a
// multiple of 16 (the k of m16n8k16), float32 rows D wide.
template <typename T>
__host__ __device__ inline int padded(int D) {
  return sizeof(T) == 2 ? (D + 15) / 16 * 16 : D;
}

// Row stride of a tile in shared memory, in elements. bfloat16: padded +
// 8, so the 8 rows one ldmatrix reads sit 16 bytes apart modulo 128 (no
// bank conflict). float32: D + 4, so the 8 rows of a fragment read sit 4
// banks apart and the 4 lanes of a quad fill the gaps (and 16-byte rows of
// an ldmatrix of float32 pairs likewise).
template <typename T>
__host__ __device__ inline int row_stride(int D) {
  return sizeof(T) == 2 ? padded<T>(D) + 8 : D + 4;
}

// A thread's walk over the 16-byte chunks of a tile, cpr chunks a row:
// chunks threadIdx.x, + kThreads, ... in row order, kept as (row, chunk)
// and stepped by (dr, dc) without a division per chunk.
struct ChunkWalk {
  int cpr, r, c, dr, dc;
  __device__ explicit ChunkWalk(int cpr_) : cpr(cpr_) {
    r = threadIdx.x / cpr;
    c = threadIdx.x - r * cpr;
    dr = kThreads / cpr;
    dc = kThreads - dr * cpr;
  }
};

// Rows [r0, r0 + rows) of a (S, D) matrix into dst at stride LD by 16-byte
// cp.async, columns [0, padded(D)); rows past S and columns past D zero.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int r0,
                                          int rows, int S, int D, int LD,
                                          const ChunkWalk& w) {
  constexpr int E = 16 / sizeof(T);
  int r = w.r, c = w.c;
  while (r < rows) {
    const int row = r0 + r, col = c * E;
    const bool ok = row < S && col < D;
    sandwich::cp_async16(dst + r * LD + col,
                         ok ? src + (size_t)row * D + col : src, ok);
    r += w.dr;
    c += w.dc;
    if (c >= w.cpr) {
      c -= w.cpr;
      ++r;
    }
  }
}

// 2^x by the SFU, subnormal results flushed to zero (they are below any
// probability that can move a float32 row sum of at least 1)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// hi = bf16(x), bf16(y) and lo = the rounding residuals, packed as the
// pairs an A fragment holds (x at the lower column)
__device__ __forceinline__ void hi_lo(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = sandwich::pack_bf16(x - hf.x, y - hf.y);
}

// The products below are plain (not volatile) asm: they read and write
// registers only, so the compiler may interleave independent tiles.

// c += a (16x16 bf16, row) · b (16x8 bf16, col), float32 accumulate. A:
// a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..); B:
// b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16x8 tf32, row) · b (8x8 tf32, col), float32 accumulate. A:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); B: b0 (k t, n g),
// b1 (k t+4, n g).
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// tf32(x): x rounded to 10 mantissa bits, to nearest with ties away from
// zero, by two integer ops (half the last kept bit added to the
// magnitude, the 13 dropped bits cleared): the bits of cvt.rna.tf32.f32
// for finite x, at a fraction of its cost in the 3xTF32 loops (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small with big = tf32(x) and small = x − big truncated to 10
// mantissa bits (CUTLASS's fast 3xTF32 split: round half up, then toward
// zero): the 3xTF32 split. big·big' + big·small' + small·big' keeps ~21
// bits of each product; the dropped small·small' is below 2^-21 of it.
// A NaN stays in small: x − big is then the canonical NaN 0x7fffffff,
// which truncation keeps a NaN (big may lose it: tf32_rna's add carries
// some NaNs into the sign bit), and every product takes small once.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// An A fragment of float32 values split once for every B it meets.
__device__ __forceinline__ void split_a(const float a[4], uint32_t ab[4],
                                        uint32_t as[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ab[i], as[i]);
}

// c[j] += a · b[j] over N n-tiles in 3xTF32, a split by split_a and b by
// split_tf32 (bb big, bs small): the small products first, then big · big,
// each pass over all N tiles, so that no product waits on the one before.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t ab[4],
                                           const uint32_t as[4],
                                           const uint32_t (*bb)[2],
                                           const uint32_t (*bs)[2]) {
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], as, bb[j][0], bb[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j][0], bb[j][1]);
}

// Max and sum over the 4 lanes of a quad (the lanes holding one row of a
// C fragment).
__device__ __forceinline__ float max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- tile products of a warp, the same in every kernel ----------------------
//
// A warp's 16 own rows against a swept tile of kTileRows rows: a score
// tile c (16 x 64, NT n-tiles) = A·Bᵀ over the head dim, and an
// accumulator acc (16 x DW) += P·B with P a 16 x 64 score tile. One
// precision rule for all: the tensor cores' float32 sums truncate, so
// each 64 dims of a score and each swept tile of an accumulator sum in
// fresh registers, added into the running sum by IEEE float32 adds.

constexpr int NT = kTileRows / 8;  // n-tiles of a warp's score tile

// The A fragments of a warp's 16 rows of a bfloat16 tile: ldmatrix'd once
// into registers (kRegs), or at every use.
template <int DMAX, bool kRegs>
struct RowsBf16 {
  uint32_t f[kRegs ? DMAX / 16 : 1][4];
  const __nv_bfloat16* p;  // the lane's ldmatrix row
  __device__ __forceinline__ void init(const __nv_bfloat16* tile, int row0,
                                       int LD, int DP, int lane) {
    p = tile + (row0 + (lane & 15)) * LD + 8 * (lane >> 4);
    if constexpr (kRegs) {
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk)
        if (kk * 16 < DP) sandwich::ldmatrix_x4(f[kk], p + kk * 16);
    }
  }
  __device__ __forceinline__ void get(int kk, uint32_t a[4]) const {
    if constexpr (kRegs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = f[kk][i];
    } else {
      sandwich::ldmatrix_x4(a, p + kk * 16);
    }
  }
};

// c[j] = Σ_d A[r][d]·B[8j + n][d] for the warp's 16 rows r of A and the 64
// rows of a swept bfloat16 tile b_s. The first 64 dims go straight into c,
// n-tiles inner (independent products back to back); each later 64 dims
// into fresh pair accumulators, added into c by float32 adds.
template <int DMAX, bool kRegs>
__device__ __forceinline__ void score_bf16(float (&c)[NT][4],
                                           const RowsBf16<DMAX, kRegs>& A,
                                           const __nv_bfloat16* b_s, int LD, int DP,
                                           int lane) {
  const __nv_bfloat16* bp =
      b_s + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4 && kk < DMAX / 16; ++kk) {
    if (kk * 16 >= DP) continue;
    uint32_t a[4];
    A.get(kk, a);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      sandwich::ldmatrix_x4(b, bp + 16 * jp * LD + kk * 16);
      mma_bf16(c[2 * jp], a, b[0], b[1]);
      mma_bf16(c[2 * jp + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int k0 = 4; k0 < DMAX / 16; k0 += 4) {
    if (k0 * 16 >= DP) continue;
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float f[2][4] = {};
#pragma unroll
      for (int kk = k0; kk < k0 + 4; ++kk) {
        if (kk * 16 >= DP) continue;
        uint32_t a[4], b[4];
        A.get(kk, a);
        sandwich::ldmatrix_x4(b, bp + 16 * jp * LD + kk * 16);
        mma_bf16(f[0], a, b[0], b[1]);
        mma_bf16(f[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[2 * jp][e] += f[0][e];
        c[2 * jp + 1][e] += f[1][e];
      }
    }
  }
}

// The same product for float32 tiles in 3xTF32: a_s at the warp's first
// row, both operands by ldmatrix (a row of 8 b16 elements is 4 floats: an
// m8n8 b16 matrix is 8 rows x 4 floats, lane (g, t) gets float t of row
// g). A fresh accumulator per 64 dims (the first is c itself), n-tiles in
// groups of NG (even: one ldmatrix holds two n-tiles).
template <int DMAX, int NG>
__device__ __forceinline__ void score_f32(float (&c)[NT][4], const float* a_s,
                                          const float* b_s, int LD, int D,
                                          int lane) {
  // A: matrices (rows 0-7 | 8-15) x (floats 0-3 | 4-7) give a0..a3
  const float* ap =
      a_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4);
  // B: (n-tile j: floats 0-3, 4-7), (n-tile j + 1: the same) give b0, b1
  // of two n-tiles
  const float* bp =
      b_s + ((lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1);
  static_assert(NG % 2 == 0 && NT % NG == 0, "pairs of n-tiles");
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += NG) {
#pragma unroll
    for (int kc0 = 0; kc0 < DMAX / 8; kc0 += 8) {
      if (kc0 * 8 >= D) continue;
      float f[NG][4] = {};
#pragma unroll
      for (int kc = kc0; kc < kc0 + 8; ++kc) {
        if (kc * 8 >= D) continue;
        uint32_t ar[4], ab[4], as[4], bb[NG][2], bs[NG][2];
        sandwich::ldmatrix_x4(ar, ap + kc * 8);
        const float a[4] = {__uint_as_float(ar[0]), __uint_as_float(ar[1]),
                            __uint_as_float(ar[2]), __uint_as_float(ar[3])};
        split_a(a, ab, as);
#pragma unroll
        for (int jp = 0; jp < NG / 2; ++jp) {
          uint32_t b[4];
          sandwich::ldmatrix_x4(b, bp + 8 * (j0 + 2 * jp) * LD + kc * 8);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(b[i]), bb[2 * jp + i / 2][i % 2],
                       bs[2 * jp + i / 2][i % 2]);
        }
        mma_3xtf32<NG>(f, ab, as, bb, bs);
      }
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          c[j0 + j][e] = kc0 == 0 ? f[j][e] : c[j0 + j][e] + f[j][e];
    }
  }
}

// hi/lo A fragments of a 16 x 64 C tile (k of the product = the tile's 64
// columns, 16 a step)
__device__ __forceinline__ void pack_hi_lo(const float (&c)[NT][4],
                                           uint32_t (&ah)[NT / 2][4],
                                           uint32_t (&al)[NT / 2][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    hi_lo(c[2 * kk][0], c[2 * kk][1], ah[kk][0], al[kk][0]);
    hi_lo(c[2 * kk][2], c[2 * kk][3], ah[kk][1], al[kk][1]);
    hi_lo(c[2 * kk + 1][0], c[2 * kk + 1][1], ah[kk][2], al[kk][2]);
    hi_lo(c[2 * kk + 1][2], c[2 * kk + 1][3], ah[kk][3], al[kk][3]);
  }
}

// acc[n] += P · B[:, d0 + 8n ..] for P (16 x 64) given as hi/lo fragments
// and B a swept bfloat16 tile (64 rows) read transposed; per pair of
// n-tiles a fresh accumulator over the tile, added by float32 adds.
template <int DW>
__device__ __forceinline__ void accum_bf16(float (&acc)[DW / 8][4],
                                           const uint32_t (&ah)[NT / 2][4],
                                           const uint32_t (&al)[NT / 2][4],
                                           const __nv_bfloat16* b_s, int LD,
                                           int d0, int DP, int lane) {
  const __nv_bfloat16* bp = b_s + (lane & 15) * LD + d0 + 8 * (lane >> 4);
#pragma unroll
  for (int dp = 0; dp < DW / 16; ++dp) {
    if (d0 + dp * 16 >= DP) continue;
    float f[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      uint32_t b[4];
      sandwich::ldmatrix_x4_trans(b, bp + 16 * kk * LD + 16 * dp);
      mma_bf16(f[0], al[kk], b[0], b[1]);
      mma_bf16(f[1], al[kk], b[2], b[3]);
      mma_bf16(f[0], ah[kk], b[0], b[1]);
      mma_bf16(f[1], ah[kk], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * dp][e] += f[0][e];
      acc[2 * dp + 1][e] += f[1][e];
    }
  }
}

// The same for float32 in 3xTF32: k of the product in the order column 2t
// (A column t), 2t + 1 (column t + 4), as a C fragment holds them; B's
// rows follow it. d n-tiles in groups of NG, each a fresh accumulator over
// the tile.
template <int DW, int NG>
__device__ __forceinline__ void accum_f32(float (&acc)[DW / 8][4],
                                          const float (&p)[NT][4],
                                          const float* b_s, int LD, int d0,
                                          int D, int g, int t) {
#pragma unroll
  for (int dn0 = 0; dn0 < DW / 8; dn0 += NG) {
    if (d0 + dn0 * 8 >= D) continue;
    float f[NG][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
      uint32_t ab[4], as[4], bb[NG][2], bs[NG][2];
      split_a(a, ab, as);
      const float* br = b_s + (8 * j + 2 * t) * LD + d0 + 8 * dn0 + g;
#pragma unroll
      for (int dn = 0; dn < NG; ++dn) {
        const bool in = d0 + (dn0 + dn) * 8 < D;
        split_tf32(in ? br[8 * dn] : 0.f, bb[dn][0], bs[dn][0]);
        split_tf32(in ? br[LD + 8 * dn] : 0.f, bb[dn][1], bs[dn][1]);
      }
      mma_3xtf32<NG>(f, ab, as, bb, bs);
    }
#pragma unroll
    for (int dn = 0; dn < NG; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn0 + dn][e] += f[dn][e];
  }
}

// The head-dim bucket a kernel is compiled for: 64, 128 or 256 (0: none).
inline int dmax_of(int D) {
  if (D < 8 || D > 256 || D % 8 != 0) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// Warps sharing 16 rows of a backward block (kDq: the dq kernel's, else
// dkv's) at head dims up to DMAX, each holding 1/kSplit of the
// accumulators' columns: 2 above 128, and for dkv's float32 above 64,
// where one warp's accumulators (dk and dv, or dq) and its operands'
// 3xTF32 splits would not fit in registers.
template <bool kBf16, int DMAX, bool kDq>
struct BwdSplit {
  static constexpr int kSplit =
      (DMAX > 128 || (!kBf16 && !kDq && DMAX > 64)) ? 2 : 1;
  static constexpr int kOwn = kTileRows / kSplit;  // rows a block owns
};

template <bool kBf16, bool kDq>
inline int own_rows(int D) {
  switch (dmax_of(D)) {
    case 64: return BwdSplit<kBf16, 64, kDq>::kOwn;
    case 128: return BwdSplit<kBf16, 128, kDq>::kOwn;
    case 256: return BwdSplit<kBf16, 256, kDq>::kOwn;
  }
  return 0;
}

// Rows a block of the dq kernel (dkv = 0: query rows) or of the dkv
// kernel (dkv = 1: key rows) owns at head dim D in dtype (0 = float32, 1 =
// bfloat16), 0 for what the kernels do not take; the tiles they sweep,
// and the forward's, are kTileRows (64) at every head dim.
inline int tile_rows(int D, int dtype, int dkv) {
  if (dtype == 0)
    return dkv ? own_rows<false, false>(D) : own_rows<false, true>(D);
  if (dtype == 1)
    return dkv ? own_rows<true, false>(D) : own_rows<true, true>(D);
  return 0;
}

}  // namespace flash
