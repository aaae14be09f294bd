// Flash-attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(mask(q kᵀ/√D)) v from q, k, v, dO, the forward's lse and
// Δ = rowsum(dO ⊙ o), recomputing each score tile instead of storing the
// (S, S) probabilities. Two kernels, the reference's split:
//
// * flash_bwd_dq replaces `_flash_bwd_dq_kernel` in
//   src/repro/kernels/flash.py: one block per (b·h, tile of query rows)
//   sweeps the key tiles the mask can reach, p = exp(s − lse) on visible
//   entries, ds = p ⊙ (dO·vᵀ − Δ), dq += ds·k; dq·D^-0.5 stored.
// * flash_bwd_dkv replaces `_flash_bwd_dkv_kernel`: one block per (b·h,
//   tile of key rows) sweeps the query tiles that can see it, dv += pᵀ·dO,
//   dk += dsᵀ·q; dk·D^-0.5 stored.
//
// Δ is computed outside the kernels in float32, as the reference computes
// it outside its pallas_calls. kernels/flash.py:flash_dq_plain /
// flash_dkv_plain are the plain twins.
//
// What bounds them on the H100: operations, 6·D (dq: q·k, dO·v, ds·k) and
// 8·D (dkv: q·k, dO·v, pᵀ·dO, dsᵀ·q) per visible (q, k) pair against a
// few (S, D) arrays moved; at the training attention (B·H = 36, S = 2048,
// D = 64, causal, bfloat16) 29 and 39 GFLOP against 48 and 57 MB. So
// every product runs on the tensor cores, in the forward's layout
// (flash.cu):
// * A block of four warps owns 64 rows, 16 a warp (query rows in dq, key
//   rows in dkv), and sweeps the 64-row tiles of the other side that the
//   mask can reach, heaviest causal tiles first. The swept tiles (K and V
//   in dq; q, dO, lse and Δ in dkv) stream through shared memory by
//   cp.async, double-buffered, one barrier a tile.
// * The two score-shaped products (s = q·kᵀ and dp = dO·vᵀ in dq, sᵀ =
//   k·qᵀ and dpᵀ = v·dOᵀ in dkv) are mma.sync tiles whose A operand is the
//   warp's own rows (in bfloat16 held in registers for the whole sweep up
//   to D = 64, and q in dq up to 128), B the swept rows by ldmatrix.
// * p and ds stay in registers in the C-fragment layout and become the A
//   operand of ds·k (dq), pᵀ·dO and dsᵀ·q (dkv); the swept rows are the B
//   operand, read transposed (ldmatrix .trans). Nothing passes through
//   shared memory but the swept tiles.
// * Each block owns its output tile: no atomics, a fixed summation order,
//   bit-identical repeats. Above D = 128 (in float32's dkv above 64) two
//   warps share 16 rows, each accumulating half the columns (both compute
//   the rows' scores): a block owns 32 rows there, so that the
//   accumulators fit in registers (flash_common.cuh BwdSplit).
// * Any S >= 1: ragged tiles load zeros and the mask hides them. Head dims
//   8..256 in steps of 8, compiled for 64, 128 and 256; bfloat16 rows are
//   zero-padded to a multiple of 16 in shared memory.
//
// Precision points (the twins', except where stated):
// * bfloat16: q, k, v and dO are exact in bfloat16, so s and dp by
//   m16n8k16 with a float32 sum differ from the twins only in summation
//   order. p and ds are float32; each enters its product as a hi/lo
//   bfloat16 pair, hi = bf16(x) and lo = bf16(x − hi), two products (~16
//   bits kept).
// * float32: 3xTF32 on m16n8k8 for all the products: every operand x is
//   split into big = tf32(x) and small = x − big truncated to TF32, and
//   a·b is big·big + big·small + small·big with a float32 sum.
// * Both: p = 2^(s·D^-0.5·log2(e) − lse·log2(e)) (ex2.approx, subnormal
//   results flushed to zero), where the twins pre-scale q by D^-0.5 and
//   use exp: a float32 reordering. The tensor cores' float32 accumulation
//   truncates, so s and dp take a fresh accumulator per 64 dims, and dq,
//   dk, dv one per swept tile, each added into the running sum by IEEE
//   float32 adds. dq and dk are scaled by D^-0.5 once, when stored (in
//   bfloat16, q·D^-0.5 is not exact unless D is a power of 4; q is), and
//   every output is rounded to the input dtype once, when stored.
// * Masked entries get p = 0 outright, as the reference does
//   (kernels/flash.py:121, :160).

#include "flash_common.cuh"

namespace {

using namespace flash;
using sandwich::cp_async_commit;
using sandwich::cp_async_wait;
using sandwich::smem_addr;
using bf16 = __nv_bfloat16;

constexpr int BS = kTileRows;  // rows of a swept tile

// 4-byte async copy (lse and Δ rows need not be 16-byte aligned); an
// invalid source zero-fills the destination
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

template <typename T, int DMAX, bool kDq>
struct Bwd {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kSplit = BwdSplit<kBf16, DMAX, kDq>::kSplit;
  static constexpr int kOwn = BwdSplit<kBf16, DMAX, kDq>::kOwn;
  static constexpr int DW = DMAX / kSplit;  // accumulator columns a warp
  // swept tiles double-buffered; float32 at D > 128 single (two would pass
  // the 227 KB a block may use), with two barriers a tile
  static constexpr int kStages = (kBf16 || DMAX <= 128) ? 2 : 1;
  // the own rows' bfloat16 A fragments kept in registers for the sweep
  // (the rest read by ldmatrix at every use): both up to D = 64; in dq the
  // first (q) up to 128 too, as the forward keeps q (dkv's dk and dv take
  // twice the registers of dq)
  static constexpr bool kRegs = kBf16 && DMAX <= 64;
  static constexpr bool kRegsFirst = kBf16 && DMAX <= (kDq ? 128 : 64);
  // float32: n-tiles a 3xTF32 pass covers at once (score_f32,
  // accum_f32: its operands' splits take registers); fewer where the
  // accumulators are wide
  static constexpr int NG = DW <= 64 ? 8 : kDq ? 4 : 2;
  // swept stage: two (64, LD) tiles, and in dkv the tile's lse and Δ
  __host__ __device__ static size_t stage_bytes(int D) {
    return sizeof(T) * (size_t)2 * BS * row_stride<T>(D) +
           (kDq ? 0 : 2 * BS * sizeof(float));
  }
  __host__ __device__ static size_t smem_bytes(int D) {
    return sizeof(T) * (size_t)2 * kOwn * row_stride<T>(D) +
           kStages * stage_bytes(D);
  }
};

// Rows r0 + g and r0 + g + 8 of the warp's accumulator columns [d0, d0 +
// DW) ∩ [0, D), times mul, into out (S, D) rounded to T.
template <typename T, int DW>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[DW / 8][4],
                                           int r0, int d0, int S, int D,
                                           float mul, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row >= S) continue;
    T* orow = out + (size_t)row * D;
#pragma unroll
    for (int dn = 0; dn < DW / 8; ++dn) {
      const int col = d0 + 8 * dn + 2 * t;
      if (col >= D) continue;
      const float x = acc[dn][2 * h] * mul, y = acc[dn][2 * h + 1] * mul;
      if constexpr (sizeof(T) == 2) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x, y);
      } else {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x, y);
      }
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int D,
    int causal, int window, float scale) {
  using P = Bwd<T, DMAX, true>;
  constexpr int DW = P::DW, OWN = P::kOwn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const qs = reinterpret_cast<T*>(smem_raw);  // (OWN, LD) q tile
  const int LD = row_stride<T>(D), DP = padded<T>(D);
  T* const dos = qs + OWN * LD;                  // (OWN, LD) dO tile
  // buffer b: K tile at kv(b), V tile at kv(b) + BS·LD
  auto kv = [&](int b) { return dos + (OWN + 2 * b * BS) * LD; };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq = 16 * (warp / P::kSplit);  // the warp's first row
  const int d0 = DW * (warp % P::kSplit);  // its first accumulator column
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t lbase = (size_t)blockIdx.x * S;
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * OWN;
  const float sl2 = scale * kLog2e;

  int lo, hi;
  key_tiles(q0, OWN, BS, S, causal, window, &lo, &hi);
  const int q_last = min(q0 + OWN, S) - 1;

  const ChunkWalk walk(DP * (int)sizeof(T) / 16);
  // key tile `tile` into buffer (tile − lo) mod kStages, one commit group
  auto load_kv = [&](int tile) {
    T* dst = kv((tile - lo) % P::kStages);
    load_tile<T>(dst, k + base, tile * BS, BS, S, D, LD, walk);
    load_tile<T>(dst + BS * LD, v + base, tile * BS, BS, S, D, LD, walk);
    cp_async_commit();
  };
  load_tile<T>(qs, q + base, q0, OWN, S, D, LD, walk);
  load_tile<T>(dos, dout + base, q0, OWN, S, D, LD, walk);
  load_kv(lo);

  // rows g and g + 8 of the warp: lse·log2(e) and Δ
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wq + g + 8 * h;
    lse2[h] = row < S ? lse[lbase + row] * kLog2e : 0.f;
    dlt[h] = row < S ? delta[lbase + row] : 0.f;
  }
  float acc[DW / 8][4];
#pragma unroll
  for (int d = 0; d < DW / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  RowsBf16<DMAX, P::kRegsFirst> qa;
  RowsBf16<DMAX, P::kRegs> da;

  for (int tile = lo; tile < hi; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; the last one is consumed
    const int buf = (tile - lo) % P::kStages;
    if constexpr (P::kBf16) {
      if (tile == lo) {
        qa.init(reinterpret_cast<const bf16*>(qs), wq, LD, DP, lane);
        da.init(reinterpret_cast<const bf16*>(dos), wq, LD, DP, lane);
      }
    }
    if (P::kStages == 2 && tile + 1 < hi) load_kv(tile + 1);
    const T* ks = kv(buf);
    const T* vs = ks + BS * LD;
    const int k0 = tile * BS;

    // s = q·kᵀ, dp = dO·vᵀ for the warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
    if constexpr (P::kBf16) {
      score_bf16<DMAX>(s, qa, reinterpret_cast<const bf16*>(ks), LD, DP,
                       lane);
      score_bf16<DMAX>(dp, da, reinterpret_cast<const bf16*>(vs), LD, DP,
                       lane);
    } else {
      score_f32<DMAX, P::NG>(s, reinterpret_cast<const float*>(qs) + wq * LD,
                             reinterpret_cast<const float*>(ks), LD, D, lane);
      score_f32<DMAX, P::NG>(dp,
                             reinterpret_cast<const float*>(dos) + wq * LD,
                             reinterpret_cast<const float*>(vs), LD, D, lane);
    }

    // p = 2^(s·sl2 − lse2) on visible entries, ds = p ⊙ (dp − Δ), into s
    const bool full = k0 + BS <= S && (!causal || k0 + BS - 1 <= q0) &&
                      (window <= 0 || k0 > q_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float x = exp2_ftz(fmaf(s[j][e], sl2, -lse2[h]));
        const bool vis =
            full || visible(q0 + wq + g + 8 * h, k0 + 8 * j + 2 * t + (e & 1),
                            S, causal, window);
        const float p = vis ? x : 0.f;
        s[j][e] = p * (dp[j][e] - dlt[h]);
      }

    // dq += ds·k
    if constexpr (P::kBf16) {
      uint32_t ah[NT / 2][4], al[NT / 2][4];
      pack_hi_lo(s, ah, al);
      accum_bf16<DW>(acc, ah, al, reinterpret_cast<const bf16*>(ks), LD, d0,
                     DP, lane);
    } else {
      accum_f32<DW, P::NG>(acc, s, reinterpret_cast<const float*>(ks), LD,
                           d0, D, g, t);
    }

    if (P::kStages == 1 && tile + 1 < hi) {
      __syncthreads();  // every warp is done with the one buffer
      load_kv(tile + 1);
    }
  }
  store_rows<T, DW>(dq + base, acc, q0 + wq, d0, S, D, scale, g, t);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int D, int causal, int window, float scale) {
  using P = Bwd<T, DMAX, false>;
  constexpr int DW = P::DW, OWN = P::kOwn;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ks = reinterpret_cast<T*>(smem_raw);  // (OWN, LD) key tile
  const int LD = row_stride<T>(D), DP = padded<T>(D);
  T* const vs = ks + OWN * LD;                   // (OWN, LD) value tile
  // stage b: q tile, dO tile (BS, LD) each, then lse and Δ (BS floats each)
  unsigned char* const stages =
      smem_raw + sizeof(T) * (size_t)2 * OWN * LD;
  const size_t stage_bytes = P::stage_bytes(D);
  auto stage = [&](int b) {
    return reinterpret_cast<T*>(stages + b * stage_bytes);
  };
  auto rows_of = [&](T* st) {
    return reinterpret_cast<float*>(st + 2 * BS * LD);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wk = 16 * (warp / P::kSplit);  // the warp's first key row
  const int d0 = DW * (warp % P::kSplit);  // its first accumulator column
  const size_t base = (size_t)blockIdx.x * S * D;
  const size_t lbase = (size_t)blockIdx.x * S;
  const int k0 = (int)blockIdx.y * OWN;    // the lowest (heaviest) first
  const float sl2 = scale * kLog2e;

  int lo, hi;
  query_tiles(k0, OWN, BS, S, causal, window, &lo, &hi);

  const ChunkWalk walk(DP * (int)sizeof(T) / 16);
  // query tile `tile` (q, dO, lse, Δ) into stage (tile − lo) mod kStages
  auto load_q = [&](int tile) {
    T* st = stage((tile - lo) % P::kStages);
    const int q0 = tile * BS;
    load_tile<T>(st, q + base, q0, BS, S, D, LD, walk);
    load_tile<T>(st + BS * LD, dout + base, q0, BS, S, D, LD, walk);
    const int i = threadIdx.x & (BS - 1), row = q0 + i;
    const float* src = threadIdx.x < BS ? lse : delta;
    cp_async4(rows_of(st) + threadIdx.x, src + (row < S ? lbase + row : 0),
              row < S);
    cp_async_commit();
  };
  static_assert(kThreads == 2 * BS, "one thread per lse and Δ entry");
  load_tile<T>(ks, k + base, k0, OWN, S, D, LD, walk);
  load_tile<T>(vs, v + base, k0, OWN, S, D, LD, walk);
  load_q(lo);

  float acc_k[DW / 8][4], acc_v[DW / 8][4];
#pragma unroll
  for (int d = 0; d < DW / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[d][e] = acc_v[d][e] = 0.f;
  RowsBf16<DMAX, P::kRegsFirst> ka;
  RowsBf16<DMAX, P::kRegs> va;

  for (int tile = lo; tile < hi; ++tile) {
    cp_async_wait<0>();
    __syncthreads();  // this tile landed; the last one is consumed
    T* const st = stage((tile - lo) % P::kStages);
    if constexpr (P::kBf16) {
      if (tile == lo) {
        ka.init(reinterpret_cast<const bf16*>(ks), wk, LD, DP, lane);
        va.init(reinterpret_cast<const bf16*>(vs), wk, LD, DP, lane);
      }
    }
    if (P::kStages == 2 && tile + 1 < hi) load_q(tile + 1);
    const T* qt = st;
    const T* dot = st + BS * LD;
    const float* ls = rows_of(st);
    const float* dl = ls + BS;
    const int q0 = tile * BS;

    // sᵀ = k·qᵀ, dpᵀ = v·dOᵀ for the warp's 16 keys x 64 queries
    float s[NT][4], dp[NT][4];
    if constexpr (P::kBf16) {
      score_bf16<DMAX>(s, ka, reinterpret_cast<const bf16*>(qt), LD, DP,
                       lane);
      score_bf16<DMAX>(dp, va, reinterpret_cast<const bf16*>(dot), LD, DP,
                       lane);
    } else {
      score_f32<DMAX, P::NG>(s, reinterpret_cast<const float*>(ks) + wk * LD,
                             reinterpret_cast<const float*>(qt), LD, D, lane);
      score_f32<DMAX, P::NG>(dp, reinterpret_cast<const float*>(vs) + wk * LD,
                             reinterpret_cast<const float*>(dot), LD, D,
                             lane);
    }

    // pᵀ into s, dsᵀ = pᵀ ⊙ (dpᵀ − Δ) into dp; query columns 8j + 2t, +1
    const bool full = q0 + BS <= S && k0 + OWN <= S &&
                      (!causal || k0 + OWN - 1 <= q0) &&
                      (window <= 0 || k0 > q0 + BS - 1 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        const float dq_ = (e & 1) ? d2.y : d2.x;
        const float x = exp2_ftz(fmaf(s[j][e], sl2, -lq * kLog2e));
        const bool vis = full || visible(q0 + c + (e & 1),
                                         k0 + wk + g + 8 * (e >> 1), S,
                                         causal, window);
        const float p = vis ? x : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dq_);
      }
    }

    // dv += pᵀ·dO, dk += dsᵀ·q
    if constexpr (P::kBf16) {
      uint32_t ph[NT / 2][4], pl[NT / 2][4], dh[NT / 2][4], dlo[NT / 2][4];
      pack_hi_lo(s, ph, pl);
      pack_hi_lo(dp, dh, dlo);
      accum_bf16<DW>(acc_v, ph, pl, reinterpret_cast<const bf16*>(dot), LD,
                     d0, DP, lane);
      accum_bf16<DW>(acc_k, dh, dlo, reinterpret_cast<const bf16*>(qt), LD,
                     d0, DP, lane);
    } else {
      accum_f32<DW, P::NG>(acc_v, s, reinterpret_cast<const float*>(dot), LD,
                           d0, D, g, t);
      accum_f32<DW, P::NG>(acc_k, dp, reinterpret_cast<const float*>(qt), LD,
                           d0, D, g, t);
    }

    if (P::kStages == 1 && tile + 1 < hi) {
      __syncthreads();  // every warp is done with the one stage
      load_q(tile + 1);
    }
  }
  store_rows<T, DW>(dk + base, acc_k, k0 + wk, d0, S, D, scale, g, t);
  store_rows<T, DW>(dv + base, acc_v, k0 + wk, d0, S, D, 1.f, g, t);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int bh, S, D, causal, window;
  float scale;
};

template <typename T, int DMAX, bool kDq>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using P = Bwd<T, DMAX, kDq>;
  const size_t smem = P::smem_bytes(a.D);
  const dim3 grid(a.bh, (a.S + P::kOwn - 1) / P::kOwn);
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v),
          *dout = static_cast<const T*>(a.dout);
  if constexpr (kDq) {
    auto kernel = flash_dq_kernel<T, DMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dq), a.S, a.D,
        a.causal, a.window, a.scale);
  } else {
    auto kernel = flash_dkv_kernel<T, DMAX>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        q, k, v, dout, a.lse, a.delta, static_cast<T*>(a.dk),
        static_cast<T*>(a.dv), a.S, a.D, a.causal, a.window, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, bool kDq>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  switch (dmax_of(a.D)) {
    case 64: return launch<T, 64, kDq>(a, s);
    case 128: return launch<T, 128, kDq>(a, s);
    case 256: return launch<T, 256, kDq>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kDq>
int run(const Args& a, int dtype, void* stream) {
  if (a.bh < 1 || a.S < 1 || dmax_of(a.D) == 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float, kDq>(a, s);
  if (dtype == 1) return dispatch<__nv_bfloat16, kDq>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, dout, dq (and dk, dv) (bh, S, D) contiguous in one dtype
// (0 = float32, 1 = bfloat16), 16-byte aligned; lse, delta (bh, S)
// float32; scale D^-0.5 as float32; causal 0 or 1; window > 0 keeps keys
// k > q - window. Each returns the cudaError_t of its one launch (0 on
// success).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int bh, int S,
                            int D, int causal, int window, float scale,
                            int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr,
               bh, S, D, causal, window, scale};
  return run<true>(a, dtype, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int bh,
                             int S, int D, int causal, int window,
                             float scale, int dtype, void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv,
               bh, S, D, causal, window, scale};
  return run<false>(a, dtype, stream);
}
