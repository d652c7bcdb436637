// Causal (or full) flash attention, forward only, for the prefill: bf16 q/k/v,
// f32 scores, online softmax and accumulation, P rounded to bf16 before PV;
// returns bf16 out and f32 lse.  Query head h reads KV head h / (Hq / Hkv).
// S queries attend T keys: causal takes T == S; full attention takes any T
// (an encoder-decoder's cross attention, S decoder tokens over T frames).
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py `flash_prefill_pallas`
//           (`_kernel`: the causal block skip, the `s_valid` column mask with
//           -1e37, `l` clamped at 1e-30, P cast to bf16 before PV).
// Bound on the H100: operations at prefill lengths.  Causal attention does
// about 2 * S^2 * d multiply-adds per head and reads q/k/v once, so at
// S = 2048, d = 128 it needs ~1,000 operations per byte, far above the
// card's ~295 bf16 operations per byte of device memory: the tensor cores
// have to be kept busy, which on Hopper means wgmma fed by TMA.
// Design (FlashAttention-3's shape, bf16 only): persistent CTAs, one per
// SM, of three warpgroups, each CTA walking work tiles of (128 query rows,
// q-head, batch row), heaviest causal tiles first.
//  - Warpgroup 0 is the producer: it gives its registers away (setmaxnreg)
//    and one thread issues TMA loads: a work tile's Q (two buffers where
//    they fit, d <= 128), then its K and V tiles into a ring of two stages
//    that runs on across work tiles.  Each of Q, K and V has a full barrier
//    (bytes arrived) and an empty one (both consumers done with it), so the
//    next work tile's Q, K and V load while this one's last products and
//    epilogue run.
//  - Warpgroups 1 and 2 are consumers of 64 query rows each, with 240
//    registers a thread.  Per KV tile: S = Q K^T as wgmma m64nBNk16 with both
//    operands read from shared memory through descriptors; the online softmax
//    in registers, in base 2 with the scale folded into one multiply-add and
//    ex2.approx; P rounded to bf16 and repacked in registers as the A operand
//    of O += P V, a wgmma m64n{d}k16 that reads V transposed from shared
//    memory (no transpose pass).  Tile t's QK^T is issued with tile t - 1's
//    PV, so the softmax runs under a product.  KV tiles wholly above a
//    consumer's rows are skipped; the mask is applied only on tiles that
//    cross the diagonal or the end of S (TMA zero-fills rows past S, which
//    would score 0).
//  - Tensor maps are 4-D, (d, S, H, B) with the caller's strides, so
//    [B, S, H, d], [B, H, S, d] and head slices of a fused buffer are read as
//    they are; tiles are boxes of 64 channels (128 bytes, 128-byte swizzle)
//    by rows: d = 128 takes two per tile, d = 256 four, and d = 32 one box
//    whose channels past d TMA fills with zeros.  Q's map has extent S, K's
//    and V's extent T: rows past either arrive as zeros, and the masks and
//    the epilogue test against T and S.
// KV tiles are 128 rows for d <= 128 (2 x Q 32 KB + 2 stages x 64 KB at
// d = 128) and 64 at d = 256 (Q 64 KB + 2 x 64 KB), within the 227 KB of a
// CTA.
// The caller chooses the number of CTAs (kernels/flash_prefill/ops.py,
// `launch_ctas`): one per SM at d <= 128; one per work tile at d = 256,
// where the hardware's dispatch balanced gemma-7b's few, uneven waves
// better than a static walk.
#include <cstdio>

#include "hopper.cuh"

#define FP_BM 128       // query rows of a CTA: 64 per consumer warpgroup
#define FP_THREADS 384  // a producer and two consumer warpgroups
#define FP_STAGES 2  // of the K/V ring (three measured slower)
#define FP_MASK (-1e37f)
#define FP_PRODUCER_REGS 24
#define FP_CONSUMER_REGS 240

template <int D>
struct FpTile {
  static constexpr int DP = D < 64 ? 64 : D;     // channels held in shared memory
  static constexpr int NCH = DP / 64;            // 128-byte chunks of a row
  static constexpr int BN = D > 128 ? 64 : 128;  // keys per KV tile
  // output channels of one PV product: at d = 256 two m64n128k16 products,
  // as one m64n256k16 made ptxas serialize the products
  static constexpr int PV_N = DP > 128 ? 128 : DP;
  static constexpr int NPV = DP / PV_N;
  static constexpr uint32_t Q_BYTES = FP_BM * DP * 2;
  static constexpr uint32_t KV_BYTES = BN * DP * 2;  // K or V of one tile
  // 1,024 bytes to align the swizzled tiles, then Q, the stages (K, V each)
  // and the barriers
  // Q buffers: two where they fit (d <= 128), so the next work tile's Q
  // loads while this one's still feeds QK^T
  static constexpr int QS =
      1024 + 2 * Q_BYTES + 2 * FP_STAGES * KV_BYTES + 8 * (4 + 4 * FP_STAGES) <= 232448 ? 2 : 1;
  static constexpr size_t SMEM =
      1024 + QS * Q_BYTES + 2 * FP_STAGES * KV_BYTES + 8 * (2 * QS + 4 * FP_STAGES);
};

__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the lower half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T of one KV tile for this warpgroup's 64 rows (issued, not waited).
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[FpTile<D>::BN / 2], uint32_t qd,
                                         uint32_t kd) {
  using T = FpTile<D>;
#pragma unroll
  for (int c = 0; c < T::NCH; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 channels (32 bytes) a step
      wgmma_ss<T::BN>(sc, qd + (c * FP_BM * 128 + kk * 32) / 16,
                      kd + (c * T::BN * 128 + kk * 32) / 16, c | kk);
  wgmma_commit();
}

// O += P V of one KV tile (issued, not waited).  V is read MN-major: 8-key
// atoms 1 KB apart, 64-channel chunks BN * 128 bytes apart.
template <int D>
__device__ __forceinline__ void pv_issue(float (&acc)[FpTile<D>::NPV][FpTile<D>::PV_N / 2],
                                         const uint32_t (&p)[FpTile<D>::BN / 16][4],
                                         uint32_t vd) {
  using T = FpTile<D>;
#pragma unroll
  for (int k = 0; k < T::BN / 16; ++k)
#pragma unroll
    for (int n = 0; n < T::NPV; ++n)
      wgmma_rs<T::PV_N>(acc[n], p[k],
                        vd + (n * T::PV_N / 64 * T::BN * 128 + k * 16 * 128) / 16, 1);
  wgmma_commit();
}

// This thread's two rows (a: row_a, b: row_a + 8) of the online softmax.
struct Rows {
  float m_a, m_b;  // running max of the raw scores
  float l_a, l_b;  // running sum over this thread's columns
};

// One tile's scores -> unnormalised probabilities, in place; updates the
// running max and sum and returns O's rescale factors.  Element 4j + e of
// the accumulator is row (e < 2 ? row_a : row_a + 8), column
// k0 + 8j + cq + e % 2.  `edge`: the tile crosses the diagonal or the end of
// the keys, so columns past T or above a row are masked (TMA's zero fill
// would score 0 there, not a masked value).
template <int BN>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], Rows& r, float& alpha_a,
                                             float& alpha_b, bool edge, int k0, int T,
                                             int causal, int row_a, int cq, float scale_log2) {
  if (edge) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + cq + (e & 1);
        if (col >= T || (causal && col > row_a + (e < 2 ? 0 : 8))) sc[4 * j + e] = FP_MASK;
      }
  }
  float mx_a = r.m_a, mx_b = r.m_b;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  alpha_a = exp2_approx((r.m_a - mx_a) * scale_log2);
  alpha_b = exp2_approx((r.m_b - mx_b) * scale_log2);
  r.m_a = mx_a;
  r.m_b = mx_b;
  const float off_a = mx_a * scale_log2, off_b = mx_b * scale_log2;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    sc[4 * j] = exp2_approx(fmaf(sc[4 * j], scale_log2, -off_a));
    sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], scale_log2, -off_a));
    sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], scale_log2, -off_b));
    sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], scale_log2, -off_b));
    sum_a += sc[4 * j] + sc[4 * j + 1];
    sum_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.l_a = r.l_a * alpha_a + sum_a;
  r.l_b = r.l_b * alpha_b + sum_b;
}

template <int NPV, int N>
__device__ __forceinline__ void rescale(float (&acc)[NPV][N], float alpha_a, float alpha_b) {
#pragma unroll
  for (int n = 0; n < NPV; ++n)
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      acc[n][4 * j] *= alpha_a;
      acc[n][4 * j + 1] *= alpha_a;
      acc[n][4 * j + 2] *= alpha_b;
      acc[n][4 * j + 3] *= alpha_b;
    }
}

// P in bf16: the S accumulator's columns 16k..16k+15 are the m64k16 A
// fragment of keys 16k..16k+15.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int k = 0; k < BN / 16; ++k) {
    p[k][0] = round_pair(sc[8 * k], sc[8 * k + 1]);
    p[k][1] = round_pair(sc[8 * k + 2], sc[8 * k + 3]);
    p[k][2] = round_pair(sc[8 * k + 4], sc[8 * k + 5]);
    p[k][3] = round_pair(sc[8 * k + 6], sc[8 * k + 7]);
  }
}

// Work tile w of n_work (heaviest causal q-tiles first): its first query row,
// q-head and batch row.  Neighbouring tiles share a KV head (L2 reuse).
struct Work {
  int q0, h, b;
  __device__ Work(int w, int nq, int Hq, int B)
      : q0((nq - 1 - w / (Hq * B)) * FP_BM), h(w % Hq), b(w / Hq % B) {}
};

template <int D>
__global__ void __launch_bounds__(FP_THREADS, 1) flash_prefill_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, float* __restrict__ lse,
    int B, int Hq, int Hkv, int S, int Tk, long long osb, long long oss, long long osh,
    int causal, float sm_scale) {
  using T = FpTile<D>;
  constexpr int BN = T::BN, NCH = T::NCH, ST = FP_STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023) & ~1023u;  // Q [QS][NCH][FP_BM][64]
  const uint32_t skv = sq + T::QS * T::Q_BYTES;  // stage s: K [NCH][BN][64], then V
  const uint32_t bars = skv + 2 * ST * T::KV_BYTES;
  // Q arrived (TMA bytes) and released (one arrival per consumer warp), then
  // per stage the same for K and for V.  KV tiles are numbered across the
  // CTA's work tiles: the ring runs on from one work tile into the next.
  constexpr int QS = T::QS;
  auto q_full = [&](int i) { return bars + 8 * (i % QS); };  // of the CTA's i-th work tile
  auto q_empty = [&](int i) { return bars + 8 * (QS + i % QS); };
  auto q_tile = [&](int i) { return sq + i % QS * T::Q_BYTES; };
  const uint32_t ring = bars + 8 * 2 * QS;
  auto full_k = [&](int kt) { return ring + 8 * (kt % ST); };
  auto full_v = [&](int kt) { return ring + 8 * (ST + kt % ST); };
  auto empty_k = [&](int kt) { return ring + 8 * (2 * ST + kt % ST); };
  auto empty_v = [&](int kt) { return ring + 8 * (3 * ST + kt % ST); };
  auto parity = [](int kt) { return (uint32_t)(kt / ST) & 1; };  // of tile kt's fill
  auto k_tile = [&](int kt) { return skv + kt % ST * 2 * T::KV_BYTES; };
  auto v_tile = [&](int kt) { return k_tile(kt) + T::KV_BYTES; };

  const int nq = (S + FP_BM - 1) / FP_BM, n_work = nq * Hq * B;
  const int g = Hq / Hkv;
  // The CTA's i-th work tile: round i of the heaviest-first list, walked
  // forwards in even rounds and backwards in odd ones, so that the CTAs
  // that took the heaviest tiles of a round take the lightest of the next.
  auto work_of = [&](int i) {
    return i * (int)gridDim.x + (i & 1 ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x);
  };
  auto n_tiles_of = [&](const Work& wk) {  // KV tiles of a work tile (Tk == S if causal)
    return ((causal ? min(Tk, wk.q0 + FP_BM) : Tk) + BN - 1) / BN;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(q_full(i), 1);
      mbar_init(q_empty(i), 8);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);
      mbar_init(empty_v(s), 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---------------------------------- producer
    regs_dec<FP_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int kt = 0;  // KV tiles loaded so far
      for (int i = 0, w = work_of(0); w < n_work; w = work_of(++i)) {
        const Work wk(w, nq, Hq, B);
        const int hk = wk.h / g, n_tiles = n_tiles_of(wk);
        if (i >= QS) mbar_wait(q_empty(i), (i / QS - 1) & 1);
        mbar_expect_tx(q_full(i), T::Q_BYTES);
        for (int c = 0; c < NCH; ++c)
          tma_load_4d(q_tile(i) + c * FP_BM * 128, &tq, q_full(i), c * 64, wk.q0, wk.h, wk.b);
        for (int t = 0; t < n_tiles; ++t, ++kt) {  // a stage is refilled once released
          if (kt >= ST) mbar_wait(empty_k(kt), parity(kt) ^ 1);
          mbar_expect_tx(full_k(kt), T::KV_BYTES);
          for (int c = 0; c < NCH; ++c)
            tma_load_4d(k_tile(kt) + c * BN * 128, &tk, full_k(kt), c * 64, t * BN, hk, wk.b);
          if (kt >= ST) mbar_wait(empty_v(kt), parity(kt) ^ 1);
          mbar_expect_tx(full_v(kt), T::KV_BYTES);
          for (int c = 0; c < NCH; ++c)
            tma_load_4d(v_tile(kt) + c * BN * 128, &tv, full_v(kt), c * 64, t * BN, hk, wk.b);
        }
      }
    }
  } else {  // ------------------------------------------------- consumers
    regs_inc<FP_CONSUMER_REGS>();
    const int wg = threadIdx.x / 128 - 1;  // 0 or 1: query rows q0 + 64 wg ...
    const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
    const int cq = 2 * (lane % 4);  // this thread's first column of each 8
    const float scale_log2 = sm_scale * 1.4426950408889634f;
    auto k_desc = [&](int kt) { return sw128_lo(k_tile(kt), 16); };
    auto v_desc = [&](int kt) { return sw128_lo(v_tile(kt), BN * 128); };
    auto release = [&](uint32_t bar) {
      if (lane == 0) mbar_arrive(bar);
    };
    int kt0 = 0;  // KV tiles consumed before this work tile
    for (int i = 0, w = work_of(0); w < n_work; w = work_of(++i)) {
      const Work wk(w, nq, Hq, B);
      const int n_tiles = n_tiles_of(wk);
      const int r0 = wk.q0 + 64 * wg;
      const int row_a = r0 + 16 * warp + lane / 4, row_b = row_a + 8;  // this thread's rows
      // tiles this warpgroup computes; the rest it only releases
      const int n_mine = r0 >= S ? 0 : causal ? (min(S, r0 + 64) + BN - 1) / BN : n_tiles;
      auto edge = [&](int t) {
        return (t + 1) * BN > Tk || (causal && (t + 1) * BN - 1 > r0);
      };

      float acc[T::NPV][T::PV_N / 2];  // O: NPV wgmma m64n{PV_N} accumulators
#pragma unroll
      for (int n = 0; n < T::NPV; ++n)
#pragma unroll
        for (int j = 0; j < T::PV_N / 2; ++j) acc[n][j] = 0.f;
      Rows r{FP_MASK, FP_MASK, 0.f, 0.f};
      float sc[BN / 2];        // S: the wgmma m64n{BN} accumulator
      uint32_t p[BN / 16][4];  // P in bf16, the A operand of PV
      float alpha_a, alpha_b;
      mbar_wait(q_full(i), (i / QS) & 1);
      if (n_mine == 0) release(q_empty(i));
      const uint32_t qd = sw128_lo(q_tile(i) + wg * 64 * 128, 16);  // this warpgroup's rows
      int t = 0;
      // Tile t's QK^T and tile t - 1's PV are issued together; the softmax of
      // tile t then runs while PV t - 1 is still on the tensor cores.  The
      // loop body stays free of branches around the products: ptxas waits
      // for every product in flight where control flow joins.  The register
      // fences keep the compiler from sinking the rescale and the packing of
      // P past wgmma_fence, into the window of the products in flight.
      if (n_mine > 0) {
        mbar_wait(full_k(kt0), parity(kt0));
        wgmma_fence();
        qk_issue<D>(sc, qd, k_desc(kt0));
        wgmma_wait<0>();
        fence_regs(sc);
        release(empty_k(kt0));
        if (n_mine == 1) release(q_empty(i));
        softmax_tile<BN>(sc, r, alpha_a, alpha_b, edge(0), 0, Tk, causal, row_a, cq,
                         scale_log2);
        pack_p<BN>(p, sc);
        for (t = 1; t < n_mine; ++t) {
          const int kt = kt0 + t;
          fence_regs(p);
          fence_regs(sc);
          fence_regs(acc);
          mbar_wait(full_k(kt), parity(kt));
          mbar_wait(full_v(kt - 1), parity(kt - 1));
          wgmma_fence();
          qk_issue<D>(sc, qd, k_desc(kt));
          wgmma_fence();  // else ptxas fences before PV itself, and waits
          pv_issue<D>(acc, p, v_desc(kt - 1));
          wgmma_wait<1>();
          fence_regs(sc);
          release(empty_k(kt));
          if (lane == 0 && t == n_mine - 1) mbar_arrive(q_empty(i));
          softmax_tile<BN>(sc, r, alpha_a, alpha_b, edge(t), t * BN, Tk, causal, row_a, cq,
                           scale_log2);
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(p);
          release(empty_v(kt - 1));
          rescale(acc, alpha_a, alpha_b);
          pack_p<BN>(p, sc);
        }
        fence_regs(p);
        fence_regs(acc);
        mbar_wait(full_v(kt0 + t - 1), parity(kt0 + t - 1));
        wgmma_fence();
        pv_issue<D>(acc, p, v_desc(kt0 + t - 1));
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_v(kt0 + t - 1));
      }
      // Tiles above this warpgroup's rows: released once filled, so that a
      // release never counts towards the stage's previous fill.
      for (; t < n_tiles; ++t) {
        mbar_wait(full_k(kt0 + t), parity(kt0 + t));
        release(empty_k(kt0 + t));
        mbar_wait(full_v(kt0 + t), parity(kt0 + t));
        release(empty_v(kt0 + t));
      }
      kt0 += n_tiles;

      if (n_mine > 0) {  // epilogue: O / l in bf16 and lse for rows < S
        const float l_a = fmaxf(quad_sum(r.l_a), 1e-30f);
        const float l_b = fmaxf(quad_sum(r.l_b), 1e-30f);
        const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
        bf16* ob = o + wk.b * osb + wk.h * osh;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {  // d = 32: the padded channels are not stored
          const int c = 8 * j + cq, n = j / (T::PV_N / 8), e = 4 * (j % (T::PV_N / 8));
          if (row_a < S)
            *reinterpret_cast<__nv_bfloat162*>(ob + row_a * oss + c) =
                __floats2bfloat162_rn(acc[n][e] * inv_a, acc[n][e + 1] * inv_a);
          if (row_b < S)
            *reinterpret_cast<__nv_bfloat162*>(ob + row_b * oss + c) =
                __floats2bfloat162_rn(acc[n][e + 2] * inv_b, acc[n][e + 3] * inv_b);
        }
        if (lane % 4 == 0) {
          float* lb = lse + ((long long)wk.b * Hq + wk.h) * S;
          if (row_a < S) lb[row_a] = r.m_a * sm_scale + logf(l_a);
          if (row_b < S) lb[row_b] = r.m_b * sm_scale + logf(l_b);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (cudaGetDriverEntryPoint*), so the library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The 4-D map (d, S, H, B) of one operand, strides in elements, boxes of 64
// channels by `rows` rows.  A dimension of extent 1 gets a nominal stride:
// TMA never steps along it.
static cudaError_t make_map(CUtensorMap* map, const void* ptr, int d, int S, int H, int B,
                            long long ss, long long sh, long long sb, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  auto bytes = [](long long st, int n) { return (cuuint64_t)(n > 1 ? st : 8) * 2; };
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(ss, S), bytes(sh, H), bytes(sb, B)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_prefill: cuTensorMapEncodeTiled failed (CUresult %d)\n", (int)r);
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <int D>
static cudaError_t launch_fp(const void* q, const void* k, const void* v, void* o, void* lse,
                             int B, int Hq, int Hkv, int S, int Tk, const long long* st,
                             int causal, float sm_scale, int ctas, void* stream) {
  using T = FpTile<D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
    if (err != cudaSuccess) return err;
    // setmaxnreg moves registers between the warpgroups of a CTA: the
    // consumers' raise waits forever unless the launch holds them all
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_prefill_kernel<D>);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * FP_THREADS < 128 * FP_PRODUCER_REGS + 256 * FP_CONSUMER_REGS) {
      fprintf(stderr, "flash_prefill: built with %d registers a thread, too few for setmaxnreg\n",
              attr.numRegs);
      return cudaErrorInvalidConfiguration;
    }
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, D, S, Hq, B, st[1], st[2], st[0], FP_BM);
  if (err == cudaSuccess) err = make_map(&tk, k, D, Tk, Hkv, B, st[4], st[5], st[3], T::BN);
  if (err == cudaSuccess) err = make_map(&tv, v, D, Tk, Hkv, B, st[7], st[8], st[6], T::BN);
  if (err != cudaSuccess) return err;
  flash_prefill_kernel<D><<<ctas, FP_THREADS, T::SMEM, (cudaStream_t)stream>>>(
      tq, tk, tv, (bf16*)o, (float*)lse, B, Hq, Hkv, S, Tk, st[9], st[10], st[11], causal,
      sm_scale);
  return cudaGetLastError();
}

// Strides are in elements, (batch, sequence, head) for each of q, k, v, out;
// channels are contiguous, every row and stride 16-byte aligned (the
// wrapper checks: TMA's rule).  S queries over T keys and values: causal
// needs T == S (refused otherwise), full attention takes any T >= 1.
// `ctas`: CTAs to launch, 1 to the number of work tiles
// (ceil(S / 128) * Hq * B); each walks its share of them.
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hkv, int S, int T, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    float sm_scale, int ctas, void* stream) {
  if (B * Hq * S == 0) return 0;
  if (T < 1 || (causal && T != S)) return (int)cudaErrorInvalidValue;
  if (ctas < 1 || (long long)ctas > (long long)((S + FP_BM - 1) / FP_BM) * Hq * B)
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {
    case 32:
      err = launch_fp<32>(q, k, v, o, lse, B, Hq, Hkv, S, T, st, causal, sm_scale,
                          ctas, stream);
      break;
    case 64:
      err = launch_fp<64>(q, k, v, o, lse, B, Hq, Hkv, S, T, st, causal, sm_scale,
                          ctas, stream);
      break;
    case 128:
      err = launch_fp<128>(q, k, v, o, lse, B, Hq, Hkv, S, T, st, causal, sm_scale,
                           ctas, stream);
      break;
    case 256:
      err = launch_fp<256>(q, k, v, o, lse, B, Hq, Hkv, S, T, st, causal, sm_scale,
                           ctas, stream);
      break;
  }
  return (int)err;
}

// Dynamic shared memory of the head-dim-d instance (0 for an unsupported d).
extern "C" int flash_prefill_smem_bytes(int d) {
  switch (d) {
    case 32: return (int)FpTile<32>::SMEM;
    case 64: return (int)FpTile<64>::SMEM;
    case 128: return (int)FpTile<128>::SMEM;
    case 256: return (int)FpTile<256>::SMEM;
  }
  return 0;
}
