// Device code shared by the flash-attention kernels (flash.cu,
// flash_bwd.cu): the tile shape for a head dim, the mask, the sweep ranges,
// tile loads into shared memory and the 16-lane reductions.
//
// Layout: q/k/v/o (and dO, dq, dk, dv) are (B·H, S, D) contiguous, lse and
// Δ (B·H, S) float32. A block has 256 threads seen as a 16 x 16 grid,
// tx = threadIdx.x % 16 (the "column" lanes of one half-warp) and
// ty = threadIdx.x / 16. A block owns one tile of N rows (query rows in the
// forward and dq kernels, key rows in the dkv kernel) and sweeps tiles of
// N rows of the other side. Thread (ty, tx) holds rows ty·R .. ty·R+R-1 of
// its own tile and, of the swept tile, rows tx + 16·j (j < R): a score tile
// is N x N, R x R entries a thread. Of the D columns of an accumulator it
// holds d = tx + 16·j (j < DMAX/16).
//
// Shared memory keeps each row of a (rows, D) tile at a stride of D + 1
// floats: D is even, so D + 1 is odd and the 16 rows tx + 16·j that a
// half-warp reads at one column fall in 16 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sandwich_common.cuh"  // to_f32 / from_f32

namespace flash {

using sandwich::from_f32;
using sandwich::to_f32;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's mask value

// Rows of a tile for head dims up to DMAX: 64 up to 128, 32 above (the
// dq and dkv kernels hold four (N, D) float32 tiles; at D = 256 and N = 64
// they would not fit in the 227 KB a block may use).
template <int DMAX>
struct Tile {
  static constexpr int N = DMAX <= 128 ? 64 : 32;
  static constexpr int R = N / 16;     // own rows (and swept rows) a thread
  static constexpr int DJ = DMAX / 16; // accumulator columns a thread
  static constexpr int PLD = N + 1;    // stride of an (N, N) score tile
};

// The reference's mask (ref.flash_attention_ref, kernels/flash.py
// _tile_mask), plus the ragged edge: key `col` is visible from query `row`.
__device__ __forceinline__ bool visible(int row, int col, int S, int causal,
                                        int window) {
  return row < S && col < S && (!causal || col <= row) &&
         (window <= 0 || col > row - window);
}

// Key tiles [lo, hi) that can hold a visible key for query rows
// [q0, q0 + N) ∩ [0, S): from the first key inside the window of the first
// row to the diagonal of the last row (kernels/flash.py _kv_bounds, here
// exact for this tile size and a ragged last tile).
__device__ __forceinline__ void key_tiles(int q0, int N, int S, int causal,
                                          int window, int* lo, int* hi) {
  const int q_last = min(q0 + N, S) - 1;
  *hi = causal ? q_last / N + 1 : (S + N - 1) / N;
  *lo = window > 0 ? max(0, q0 - window + 1) / N : 0;
}

// Query tiles [lo, hi) that can see a key of rows [k0, k0 + N) ∩ [0, S):
// from the diagonal of the first key (causal) to the last query whose
// window still reaches the last key (kernels/flash.py:141-147).
__device__ __forceinline__ void query_tiles(int k0, int N, int S, int causal,
                                            int window, int* lo, int* hi) {
  const int k_last = min(k0 + N, S) - 1;
  *lo = causal ? k0 / N : 0;
  *hi = window > 0 ? min(S - 1, k_last + window - 1) / N + 1
                   : (S + N - 1) / N;
}

// Rows [r0, r0 + N) of a (S, D) matrix into dst (N rows at stride D + 1),
// float32, times mul; rows past S are zero.
template <typename T, int N>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int S, int D, float mul) {
  const int LD = D + 1;
  for (int idx = threadIdx.x; idx < N * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    const int row = r0 + r;
    dst[r * LD + d] =
        row < S ? to_f32<T>(src[(size_t)row * D + d]) * mul : 0.f;
  }
}

// Max and sum over the 16 lanes of a half-warp (one tx row of the grid).
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The head-dim bucket a kernel is compiled for: 64, 128 or 256 (0: none).
inline int dmax_of(int D) {
  if (D < 8 || D > 256 || D % 8 != 0) return 0;
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// Rows of the query and key tiles, forward and backward, at head dim D (0:
// a head dim the kernels do not take).
inline int tile_rows(int D) {
  switch (dmax_of(D)) {
    case 64: return Tile<64>::N;
    case 128: return Tile<128>::N;
    case 256: return Tile<256>::N;
  }
  return 0;
}

}  // namespace flash
