// Flash-attention forward for Hopper (sm_90a): o = softmax(mask(q kᵀ/√D)) v
// and the row logsumexp, for q/k/v (B·H, S, D), heads already expanded.
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash.py
// (entry `_flash_fwd_call`, reached from `flash_attention`).
// kernels/flash.py:flash_fwd_plain is the plain twin.
//
// What bounds it on the H100: operations. Per visible (q, k) pair it does
// 4·D operations (q·k and p·v) against 4·S·D elements moved in all; at the
// training attention (B·H = 36, S = 2048, D = 64, causal) that is
// 19.3 GFLOP against 19 MB, ~1000 operations a byte. So the products run
// on the tensor cores, in FlashAttention-2's layout:
// * A block of four warps owns 64 query rows, 16 a warp, and sweeps the
//   key tiles of 64 rows that the mask can reach (`key_tiles`), heaviest
//   causal query tiles first. K and V tiles stream through shared memory
//   by cp.async, double-buffered: the next tile loads while this one is
//   used, one barrier a tile.
// * s = q·kᵀ and o += p·v are mma.sync tiles, the warp's tile products of
//   flash_common.cuh (score_bf16 / score_f32, pack_hi_lo with accum_bf16,
//   accum_f32), shared with the backward kernels. The score fragments of s
//   become the A operand of p·v in registers, so the probabilities never
//   pass through shared memory; row max and row sum are quad shuffles, and
//   each lane keeps its part of the row sum until the end.
// * Any S >= 1: ragged tiles load zeros and the mask hides them. Head dims
//   8..256 in steps of 8, compiled for 64, 128 and 256; bfloat16 rows
//   are zero-padded to a multiple of 16 in shared memory (the k of
//   m16n8k16).
//
// Precision points (the twin's, except where stated):
// * bfloat16: q, k, v are exact in bfloat16, so q·kᵀ by m16n8k16 with a
//   float32 sum differs from the twin only in summation order. The scores
//   are scaled after the product by D^-0.5·log2(e) and the softmax runs in
//   base 2 (ex2.approx, subnormal results flushed to zero), where the twin
//   pre-scales q by D^-0.5 and uses exp: a float32 reordering. p enters
//   p·v as a hi/lo bfloat16 pair, hi = bf16(p) and lo = bf16(p − hi), two
//   products, so p keeps ~16 bits; v is exact; the sum is float32.
// * float32: 3xTF32 on m16n8k8. Every operand x is split into big =
//   tf32(x) and small = x − big truncated to TF32, and a·b is big·big +
//   big·small + small·big with a float32 sum (~21 bits a product); q·kᵀ
//   and p·v both.
// * Both: the tensor cores' float32 accumulation truncates, so q·kᵀ takes
//   a fresh accumulator per 64 dims and p·v one per key tile, each added
//   into the running sum by IEEE float32 adds (p·v's after the rescale by
//   exp2(m_old − m_new)), as in the backward kernels.
// * The online softmax (m, l, the accumulator) is float32; lse = (m +
//   log2(max(l, 1e-30)))·ln 2 in float32; o is rounded to the input dtype
//   once, when stored.
//
// Masked entries: the reference writes -1e30 into masked scores and lets
// exp(m_old − m_new) = 0 wipe what a row summed before its first visible
// key. Here a masked entry's probability is 0 outright and -1e30 enters
// only the running max; every row sees at least its own key (k = q passes
// every mask), so both give the softmax over the visible keys.

#include "flash_common.cuh"

namespace {

using namespace flash;
using sandwich::cp_async_commit;
using sandwich::cp_async_wait;
using bf16 = __nv_bfloat16;

constexpr int BQ = kTileRows, BK = kTileRows;

template <typename T, int DMAX>
struct Fwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  // K/V tile buffers: two, the next tile loading while this one is used
  // (a ring of three read slower: it leaves three blocks an SM, not four);
  // float32 at D > 128 has one (two would pass the 227 KB a block may
  // use) and two barriers a tile
  static constexpr int kStages = (kBf16 || DMAX <= 128) ? 2 : 1;
  // the q tile's A fragments stay in registers up to D = 128
  static constexpr bool kQRegs = kBf16 && DMAX <= 128;
  // float32: n-tiles a 3xTF32 pass covers at once (score_f32, accum_f32)
  static constexpr int NG = 8;
  static size_t smem_bytes(int D) {
    return sizeof(T) * (size_t)(BQ + kStages * 2 * BK) * row_stride<T>(D);
  }
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int D, int causal,
    int window, float scale) {
  using F = Fwd<T, DMAX>;
  constexpr int DT = DMAX / 8;  // d n-tiles of the accumulator, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const qs = reinterpret_cast<T*>(smem_raw);
  const int LD = row_stride<T>(D), DP = padded<T>(D);
  // buffer b: K tile at kv(b), V tile at kv(b) + BK·LD
  auto kv = [&](int b) { return qs + (BQ + 2 * b * BK) * LD; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t base = (size_t)blockIdx.x * S * D;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * BQ;
  const int wq = 16 * warp;  // the warp's first row in the tile
  const float sl2 = scale * kLog2e;

  int lo, hi;
  key_tiles(q0, BQ, BK, S, causal, window, &lo, &hi);
  const int q_last = min(q0 + BQ, S) - 1;

  const ChunkWalk walk(DP * (int)sizeof(T) / 16);
  // key tile t into buffer (t − lo) mod kStages, one commit group a tile
  auto load_kv = [&](int tile) {
    T* dst = kv((tile - lo) % F::kStages);
    load_tile<T>(dst, k + base, tile * BK, BK, S, D, LD, walk);
    load_tile<T>(dst + BK * LD, v + base, tile * BK, BK, S, D, LD,
                walk);
    cp_async_commit();
  };
  load_tile<T>(qs, q + base, q0, BQ, S, D, LD, walk);
  load_kv(lo);

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  RowsBf16<DMAX, F::kQRegs> qa;  // the warp's q rows (bfloat16)

  for (int tile = lo; tile < hi; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; the last one is consumed
    const int buf = (tile - lo) % F::kStages;
    if constexpr (F::kBf16) {
      if (tile == lo)
        qa.init(reinterpret_cast<const bf16*>(qs), wq, LD, DP, lane);
    }
    if (F::kStages == 2 && tile + 1 < hi) load_kv(tile + 1);
    const T* ks = kv(buf);
    const T* vs = ks + BK * LD;
    const int k0 = tile * BK;

    // s = q·kᵀ for the warp's 16 rows x 64 keys
    float s[NT][4];
    if constexpr (F::kBf16) {
      score_bf16<DMAX>(s, qa, reinterpret_cast<const bf16*>(ks), LD, DP,
                       lane);
    } else {
      score_f32<DMAX, F::NG>(s, reinterpret_cast<const float*>(qs) + wq * LD,
                             reinterpret_cast<const float*>(ks), LD, D, lane);
    }

    // scale to base 2, mask, online softmax (rows g and g + 8)
    const bool full = k0 + BK <= S && (!causal || k0 + BK - 1 <= q0) &&
                      (window <= 0 || k0 > q_last - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (!full && !visible(q0 + wq + g + 8 * (e >> 1),
                              k0 + 8 * j + 2 * t + (e & 1), S, causal,
                              window))
          x = kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], max4(mx[h]));
      corr[h] = exp2_ftz(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x == kNegInf ? 0.f : exp2_ftz(x - m[e >> 1]);
        s[j][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + rs[h];
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= corr[e >> 1];

    // acc += p·v
    if constexpr (F::kBf16) {
      uint32_t ah[NT / 2][4], al[NT / 2][4];
      pack_hi_lo(s, ah, al);
      accum_bf16<DMAX>(acc, ah, al, reinterpret_cast<const bf16*>(vs), LD, 0,
                       DP, lane);
    } else {
      accum_f32<DMAX, F::NG>(acc, s, reinterpret_cast<const float*>(vs), LD,
                             0, D, g, t);
    }

    if (F::kStages == 1 && tile + 1 < hi) {
      __syncthreads();  // every warp is done with the one buffer
      load_kv(tile + 1);
    }
  }

  const size_t lbase = (size_t)blockIdx.x * S;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wq + g + 8 * h;
    // at least 1e-30, as the twin's clamp; a NaN stays (fmaxf would drop it)
    const float ls = sum4(l[h]);
    const float lm = ls < 1e-30f ? 1e-30f : ls;
    if (row >= S) continue;
    T* orow = o + base + (size_t)row * D;
#pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      const int col = 8 * dn + 2 * t;
      if (col >= D) continue;
      const float x = acc[dn][2 * h] / lm, y = acc[dn][2 * h + 1] / lm;
      if constexpr (F::kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x, y);
      } else {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
      }
    }
    if (t == 0) lse[lbase + row] = (m[h] + log2f(lm)) * kLn2;
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int S, int D, int causal, int window,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const size_t smem = Fwd<T, DMAX>::smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + BQ - 1) / BQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, D, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int bh, int S, int D, int causal, int window,
                     float scale, cudaStream_t s) {
  switch (dmax_of(D)) {
    case 64:
      return launch<T, 64>(q, k, v, o, lse, bh, S, D, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, bh, S, D, causal, window, scale,
                            s);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, bh, S, D, causal, window, scale,
                            s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// o and lse for q, k, v, o (bh, S, D) contiguous, 16-byte aligned, and lse
// (bh, S) float32. dtype: 0 = float32, 1 = bfloat16 (q, k, v, o). causal:
// 0 or 1; window: keys k > q - window only, when > 0. Returns the
// cudaError_t of the launch (0 on success). scale: D^-0.5 as float32,
// passed in so that the plain twin and the kernel scale by the same number.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int bh, int S, int D, int causal,
                         int window, float scale, int dtype, void* stream) {
  if (bh < 1 || S < 1 || dmax_of(D) == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, bh, S, D, causal, window, scale,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, bh, S, D, causal, window,
                                   scale, s);
  return cudaErrorInvalidValue;
}

// Rows a block of the backward kernels (flash_bwd.cu) owns at head dim D
// in dtype (0 = float32, 1 = bfloat16): the dq kernel's query rows (dkv =
// 0) or the dkv kernel's key rows (dkv = 1); 0 for what they do not take.
// The bench rows report them. The tiles they sweep, and the forward's, are
// kTileRows (64) at every head dim.
extern "C" int flash_tile_rows(int D, int dtype, int dkv) {
  return tile_rows(D, dtype, dkv);
}
