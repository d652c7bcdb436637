// The body of the fused low-bit flash-decode attention with split-KV, shared
// by the dense kernel (bitdecode.cu) and the paged one (paged_bitdecode.cu),
// as the TPU kernels share `make_flash_update`, `dequant_tile` and `finalize`
// (src/repro/kernels/paged_bitdecode/kernel.py imports them from
// bitdecode/kernel.py).  The two kernels differ only in where packed block j
// of row b, head h lives: `cell_of(j)` returns its index in the [.., npr, d]
// word arrays (and [.., kp] param arrays).  Everything else, the arithmetic
// and its order included, is this one function, so the two kernels agree bit
// for bit on the same blocks.
//
// Work is cut into units a warp takes whole: a packed unit is W = 4 word
// rows of one block (2 when a block has fewer: W * 32 / bits tokens, since
// row i of word (i, c) holds tokens i + k * npr), a residual unit 8 bf16
// tokens.  Row (b, h) has pack_blocks[b] * npr / W packed units and
// ceil(res_len[b] / 8) residual ones, read on the device; CTA `split` of
// the row's num_splits has BD_WARPS warps, and warp w of the row's
// num_splits * BD_WARPS takes a contiguous, balanced range of them.  A CTA
// whose range is empty writes the empty partial at once.  Each warp runs its
// own ring of BD_STAGES shared-memory stages filled by cp.async (the next
// unit's words, scale and zero land while the current one computes) and
// its own online softmax; the CTA then combines its warps by logsumexp and
// writes one normalised partial (o, lse), or the result when
// num_splits == 1.
//
// Products run on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulation) with tokens and channels on the M side and the g query rows
// padded to N = 8 (16 for g > 8):
//   S^T = K Q^T:  A = dequantized K [16 tokens x 16 channels], B = Q^T;
//   O^T = V^T P^T: A = dequantized V^T [16 channels x 16 tokens], B = P^T,
// P^T from S^T's accumulators through movmatrix.trans.  The words are
// dequantized on the CUDA cores straight into A fragments, in the order
// that suits the strided layout: in a unit, 16-token tile j, fragment row
// gamma + 8h (gamma = lane / 4) is word row (gamma % W), code
// (j * 8 / W + gamma / W) * 2 + h.  Both products use that one token
// permutation.  QK^T reads channels 4 t .. 4 t + 3 of each 16 (t = lane % 4)
// as k columns 2t, 2t + 1, 2t + 8, 2t + 9, and Q^T in the same order; PV puts
// channel 32 m + 4 gamma + 2 x + y on row gamma + 8 y of tile 2 m + x.
// Dequantization is bf16(fmaf(code, scale, zero)) in f32, as the plain
// version; P is rounded to bf16 before PV while l sums the f32 p.  The
// instances are templates over bits, W, the head dims, the padded g and
// K's param granularity, so the hot loops carry no runtime branch.  The
// speculative draft read (the JAX package's XLA-only `draft_bits`) is a
// runtime argument of the same instances: every packed word is ANDed with
// a mask that keeps each code's top bits (draft_keep), residual tokens are
// read as they are.
//
// The grid's third axis cuts a row's query rows into tiles of G = 8 * NT
// (g > 16: the MLA decode's g = n_heads = 128) and, in the shared_kv mode,
// its V channels into chunks of DV.  shared_kv (the MLA latent cache, the
// JAX kernels' `shared_kv`) has no V words: V is the first d_v channels of
// K, so a chunk's V^T fragments are dequantized from the staged K words'
// channels vb .. vb + DV - 1 with K's per-channel scale and zero, the same
// bf16(fmaf(code, scale, zero)) QK^T takes (and the same draft mask), and
// the residual's V from the staged K residual.  Each chunk's CTA recomputes
// the QK^T and the softmax over all DK channels (its K words come from L2
// after the first chunk's read): f32 accumulators for all 512 channels of
// 16 rows would not fit a warp's registers.
#pragma once

#include <type_traits>

#include "common.cuh"

#define BD_WARPS 4
#define BD_THREADS (32 * BD_WARPS)
#define BD_STAGES 2
#define BD_RES_TOKENS 8
#define BD_LATENT_DV 128  // V channels a CTA of the shared_kv mode takes
#define MASK_VALUE (-1e37f)

// ------------------------------------------------------------ PTX

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The transpose of the warp's 8 x 8 b16 matrix fragment.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf_lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float bf_hi(uint32_t x) { return __uint_as_float(x & 0xFFFF0000u); }
__device__ __forceinline__ float bf_at(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
}

// fmaf(code, scale, zero) with the code taken from bit `shift` of `w`; the
// code becomes a float exactly as (2^23 + code) - 2^23.
template <int BITS>
__device__ __forceinline__ float deq(uint32_t w, int shift, float s, float z) {
  constexpr uint32_t M = (1u << BITS) - 1u;
  const float code = __uint_as_float(((w >> shift) & M) | 0x4B000000u) - 8388608.f;
  return fmaf(code, s, z);
}

// ------------------------------------------------------------ shapes

// Word rows of a packed unit: 4, or all of a block's when it has fewer.
__host__ __device__ inline int bd_unit_rows(int block_n, int bits) {
  const int npr = block_n * bits / 32;
  return npr < 4 ? npr : 4;
}

struct BdArgs {
  const bf16* q;          // [B, H, g, DK]
  const int32_t* kw;      // dense [B, H, nb, npr, DK], paged [P, H, npr, DK]
  const bf16* ks;         // [.., kp]
  const bf16* kz;
  const int32_t* vw;      // [.., npr, dv]; null when shared_kv
  const bf16* vs;         // [.., block_n]
  const bf16* vz;
  const bf16* k_res;      // [B, H, res_n, DK]
  const bf16* v_res;      // [B, H, res_n, dv]; null when shared_kv
  const int32_t* pack_blocks;  // [B]
  const int32_t* res_len;      // [B]
  float* out;             // [S, B, H, g, dv] (S = num_splits; the result when S == 1)
  float* lse;             // [S, B, H, g]
  int B, H, g, nb, block_n, res_n, num_splits;
  float sm_scale;
  // the speculative draft read: each code read as its top BITS - draft_shift
  // bits (0: the normal read; see draft_keep)
  int draft_shift;
  int dv;    // the output's channels: DV, or a multiple of it when shared_kv
  int n_vc;  // V chunks of DV a row (dv / DV): the grid's third axis is tile * n_vc + chunk
  // the block window (one rank's share of a split-KV walk across devices):
  // blocks [block_lo, block_lo + nb_win) of the nb-wide axis, a row's
  // pack_blocks clipped to it; read_res 0 leaves the residual to another
  // rank.  The whole call: block_lo 0, nb_win nb, read_res 1.
  int block_lo, nb_win, read_res;
};

// The mask a packed word is ANDed with before its codes are taken: every
// BITS-bit code keeps its top BITS - draft_shift bits (all ones for
// draft_shift 0, the normal read).  The plain version's draft read
// (ref.py `_dequant_blocks(draft_bits=)`) takes code >> draft_shift against
// the scale times 2^draft_shift; the masked code is (code >> draft_shift) *
// 2^draft_shift, an exact small integer, so fmaf(masked, s, z) rounds the
// same real number once as fmaf(code >> draft_shift, s * 2^draft_shift, z)
// would, with no branch, template instance or scale change in the loops.
template <int BITS>
__device__ __forceinline__ uint32_t draft_keep(int draft_shift) {
  const uint32_t code = ((1u << BITS) - 1u) >> draft_shift << draft_shift;
  uint32_t keep = 0u;
#pragma unroll
  for (int i = 0; i < 32 / BITS; ++i) keep |= code << (BITS * i);
  return keep;
}

template <int BITS, int W, int DK, int DV, int NT, bool SH = false>
struct BdShape {
  static constexpr int R = 32 / BITS;     // codes a word
  static constexpr int SUB = 8 / W;       // fragment rows sharing a word row
  static constexpr int MT = W * R / 16;   // 16-token tiles of a packed unit
  static constexpr int KC = DK / 16;      // k steps of QK^T
  // PV takes V's channels 32 at a time, as two 16-channel tiles: a head dim
  // that is not a multiple of 32 (zamba2's 112) ends in a half-full group
  // whose upper lanes' channels do not exist (their A fragments are zero,
  // their outputs never written)
  static constexpr int MP = (DV + 31) / 32;  // 32-channel groups of PV
  static constexpr int OT = 2 * MP;          // channel tiles of PV
  static constexpr int G = 8 * NT;        // query rows, padded
  // shared-memory row strides (elements), chosen so a warp's fragment loads
  // hit distinct banks: K words at 16 mod 32 words, bf16 rows at 16 mod 64
  // elements (DK 112 is already 16 mod 32)
  static constexpr int KLD = DK % 32 ? DK : DK + 16;      // K words, int32
  static constexpr int VLD = DV + 4;                      // V words, int32
  static constexpr int KRLD = DK % 32 ? DK + 32 : DK + 16;  // residual K, bf16
  static constexpr int VRLD = DV + 8;                     // residual V, bf16
  static constexpr int QLD = KRLD;                        // Q, bf16
  static constexpr int KP = DK > 128 ? DK : 128;  // K params a block (per channel or token)
  // one stage (bytes): a packed unit or a residual unit (no V words, V
  // params or V residual when shared_kv)
  static constexpr int OFF_VW = 4 * W * KLD;
  static constexpr int OFF_KS = OFF_VW + (SH ? 0 : 4 * W * VLD);
  static constexpr int OFF_KZ = OFF_KS + 2 * KP;
  static constexpr int OFF_VS = OFF_KZ + 2 * KP;
  static constexpr int OFF_VZ = OFF_VS + (SH ? 0 : 2 * 128);
  static constexpr int PACKED = OFF_VZ + (SH ? 0 : 2 * 128);
  static constexpr int OFF_VR = 2 * BD_RES_TOKENS * KRLD;
  static constexpr int RESID = OFF_VR + (SH ? 0 : 2 * BD_RES_TOKENS * VRLD);
  static constexpr int STAGE = ((PACKED > RESID ? PACKED : RESID) + 127) / 128 * 128;
  static constexpr int RING = BD_WARPS * BD_STAGES * STAGE;
  // a warp's P^T fragments between the softmax and PV, [tile][nt][2][lane]
  static constexpr int PBUF = MT * NT * 2 * 32 * 4;
  // the warps' combine: acc [warps][G][DV], m, l, weights [warps][G], L [G]
  static constexpr int COMBINE = 4 * (BD_WARPS * G * (DV + 3) + G);
  static constexpr int Q_BYTES = 2 * G * QLD;
  static constexpr int SMEM = Q_BYTES + BD_WARPS * PBUF + (RING > COMBINE ? RING : COMBINE);
};

// ------------------------------------------------------------ the warp's work

// One online-softmax step over the warp's scores s (S^T accumulators,
// already scaled and masked): updates m (the warp's) and l (this lane's
// share of the warp's), rescales o, leaves p in s.
template <int M, int NT, int OT>
__device__ __forceinline__ void online_softmax(float (&s)[M][NT][4], float (&m_run)[NT][2],
                                               float (&l_run)[NT][2], float (&o)[OT][NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = s[0][nt][e];
#pragma unroll
      for (int j = 0; j < M; ++j) mx = fmaxf(mx, fmaxf(s[j][nt][e], s[j][nt][2 + e]));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m_run[nt][e], mx);
      const float alpha = expf(m_run[nt][e] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < M; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p = expf(s[j][nt][2 * h + e] - m_next);
          s[j][nt][2 * h + e] = p;
          sum += p;
        }
      }
      l_run[nt][e] = l_run[nt][e] * alpha + sum;  // this lane's share; summed at the end
      m_run[nt][e] = m_next;
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        o[t][nt][e] *= alpha;
        o[t][nt][2 + e] *= alpha;
      }
    }
  }
}

// B fragments of P^T for PV from tile j of S^T's accumulators (p).
template <int NT>
__device__ __forceinline__ void p_fragments(const float (&p)[NT][4], uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    b[nt][0] = movmatrix_trans(pack_bf16(p[nt][0], p[nt][1]));
    b[nt][1] = movmatrix_trans(pack_bf16(p[nt][2], p[nt][3]));
  }
}

// The Q^T B fragments of k step kc (channels 16 kc + 4 t .. + 3).
template <int NT, int QLD>
__device__ __forceinline__ void q_fragments(const bf16* q_s, int kc, int gam, int tig,
                                            uint32_t (&qb)[NT][2]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint2 v = *reinterpret_cast<const uint2*>(q_s + (gam + 8 * nt) * QLD + 16 * kc + 4 * tig);
    qb[nt][0] = v.x;
    qb[nt][1] = v.y;
  }
}

// A packed unit: W word rows (unit `qg` of its block) staged at `st`; K's
// params per channel (KCH) or per token; every word read through `keep`
// (draft_keep).  SH: V is K's channels vb .. vb + DV - 1.
template <int BITS, int W, int DK, int DV, int NT, bool KCH, bool SH>
__device__ __forceinline__ void packed_unit(const unsigned char* st, const bf16* q_s,
                                            uint32_t* pbuf, int qg, int npr, uint32_t keep,
                                            float sm_scale, int vb,
                                            float (&m_run)[NT][2], float (&l_run)[NT][2],
                                            float (&o)[BdShape<BITS, W, DK, DV, NT,
                                                               SH>::OT][NT][4]) {
  using S = BdShape<BITS, W, DK, DV, NT, SH>;
  const int lane = threadIdx.x & 31, gam = lane >> 2, tig = lane & 3;
  const int32_t* kw_s = reinterpret_cast<const int32_t*>(st);
  const int32_t* vw_s = reinterpret_cast<const int32_t*>(st + S::OFF_VW);
  const bf16* ks_s = reinterpret_cast<const bf16*>(st + S::OFF_KS);
  const bf16* kz_s = reinterpret_cast<const bf16*>(st + S::OFF_KZ);
  const bf16* vs_s = reinterpret_cast<const bf16*>(st + S::OFF_VS);
  const bf16* vz_s = reinterpret_cast<const bf16*>(st + S::OFF_VZ);

  // S^T = K Q^T: this thread's K words are row gam % W, codes
  // (j * SUB + gam / W) * 2 + h of tile j, row gam + 8 h
  float s[S::MT][NT][4];
#pragma unroll
  for (int j = 0; j < S::MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][nt][c] = 0.f;
  const int rk = gam % W, subk = gam / W;
  const int tok_k = qg * W + rk + npr * 2 * subk;  // token of code (j * SUB) * 2 + h, less npr * that
  const int32_t* krow = kw_s + rk * S::KLD + 4 * tig;
  float kst[S::MT][2], kzt[S::MT][2];  // per-token K params of the thread's tokens
  if (!KCH) {
#pragma unroll
    for (int j = 0; j < S::MT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tau = tok_k + npr * (2 * S::SUB * j + h);
        kst[j][h] = bf_at(ks_s + tau), kzt[j][h] = bf_at(kz_s + tau);
      }
  }
#pragma unroll 2  // a short body keeps the unit's code in the instruction cache
  for (int kc = 0; kc < S::KC; ++kc) {
    const uint4 w4 = *reinterpret_cast<const uint4*>(krow + 16 * kc);
    const int pre = 2 * BITS * subk;
    const uint32_t w[4] = {(static_cast<uint32_t>(w4.x) & keep) >> pre,
                           (static_cast<uint32_t>(w4.y) & keep) >> pre,
                           (static_cast<uint32_t>(w4.z) & keep) >> pre,
                           (static_cast<uint32_t>(w4.w) & keep) >> pre};
    uint32_t qb[NT][2];
    q_fragments<NT, S::QLD>(q_s, kc, gam, tig, qb);
    float sc[4], zc[4];
    if (KCH) {
      const uint2 s2 = *reinterpret_cast<const uint2*>(ks_s + 16 * kc + 4 * tig);
      const uint2 z2 = *reinterpret_cast<const uint2*>(kz_s + 16 * kc + 4 * tig);
      sc[0] = bf_lo(s2.x), sc[1] = bf_hi(s2.x), sc[2] = bf_lo(s2.y), sc[3] = bf_hi(s2.y);
      zc[0] = bf_lo(z2.x), zc[1] = bf_hi(z2.x), zc[2] = bf_lo(z2.y), zc[3] = bf_hi(z2.y);
    }
#pragma unroll
    for (int j = 0; j < S::MT; ++j) {
      float v[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int shift = BITS * (2 * S::SUB * j + h);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[h][e] = deq<BITS>(w[e], shift, KCH ? sc[e] : kst[j][h], KCH ? zc[e] : kzt[j][h]);
      }
      const uint32_t a[4] = {pack_bf16(v[0][0], v[0][1]), pack_bf16(v[1][0], v[1][1]),
                             pack_bf16(v[0][2], v[0][3]), pack_bf16(v[1][2], v[1][3])};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(s[j][nt], a, qb[nt][0], qb[nt][1]);
    }
  }
#pragma unroll
  for (int j = 0; j < S::MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][nt][c] *= sm_scale;
  online_softmax(s, m_run, l_run, o);

  // O^T += V^T P^T: k position 2t + e + 8h of tile j is word row
  // (2t + e) % W, code (j * SUB + 2t / W) * 2 + h; the thread's channels are
  // 32 m + 4 gam .. + 3.  P^T goes through shared memory so that the loop
  // over tiles need not be unrolled.
#pragma unroll
  for (int j = 0; j < S::MT; ++j) {
    uint32_t pb[NT][2];
    p_fragments<NT>(s[j], pb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) pbuf[((j * NT + nt) * 2 + r) * 32 + lane] = pb[nt][r];
  }
  __syncwarp();
  const int subv = (2 * tig) / W;
  const int r0 = (2 * tig) % W, r1 = (2 * tig + 1) % W;
  const int tok_v0 = qg * W + r0 + npr * 2 * subv, tok_v1 = qg * W + r1 + npr * 2 * subv;
  constexpr int VLD = SH ? S::KLD : S::VLD;
  const int32_t* vsrc = SH ? kw_s + vb : vw_s;
  const int32_t* v0 = vsrc + r0 * VLD + 4 * gam;
  const int32_t* v1 = vsrc + r1 * VLD + 4 * gam;
  const int pre = 2 * BITS * subv;
#pragma unroll 1
  for (int j = 0; j < S::MT; ++j) {
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) pb[nt][r] = pbuf[((j * NT + nt) * 2 + r) * 32 + lane];
    float vsc[2][2], vzc[2][2];  // [e][h]: V's per-token params (not SH)
    if constexpr (!SH) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = npr * (2 * S::SUB * j + h);
        vsc[0][h] = bf_at(vs_s + tok_v0 + kk), vzc[0][h] = bf_at(vz_s + tok_v0 + kk);
        vsc[1][h] = bf_at(vs_s + tok_v1 + kk), vzc[1][h] = bf_at(vz_s + tok_v1 + kk);
      }
    }
    const int sh0 = pre + BITS * (2 * S::SUB * j), sh1 = sh0 + BITS;
#pragma unroll
    for (int mp = 0; mp < S::MP; ++mp) {
      // the thread's channels 32 mp + 4 gam .. + 3 exist (always, but in
      // the half-full last group of a head dim 16 mod 32)
      const bool live = 32 * mp + 4 * gam < DV;
      uint4 a4 = make_uint4(0u, 0u, 0u, 0u), b4 = a4;
      if (live) {
        a4 = *reinterpret_cast<const uint4*>(v0 + 32 * mp);
        b4 = *reinterpret_cast<const uint4*>(v1 + 32 * mp);
      }
      const uint32_t w0[4] = {static_cast<uint32_t>(a4.x) & keep, static_cast<uint32_t>(a4.y) & keep,
                              static_cast<uint32_t>(a4.z) & keep, static_cast<uint32_t>(a4.w) & keep};
      const uint32_t w1[4] = {static_cast<uint32_t>(b4.x) & keep, static_cast<uint32_t>(b4.y) & keep,
                              static_cast<uint32_t>(b4.z) & keep, static_cast<uint32_t>(b4.w) & keep};
      float csc[4], czc[4];  // SH: K's params of channels vb + 32 mp + 4 gam .. + 3
      if constexpr (SH) {
        const uint2 s2 = *reinterpret_cast<const uint2*>(ks_s + vb + 32 * mp + 4 * gam);
        const uint2 z2 = *reinterpret_cast<const uint2*>(kz_s + vb + 32 * mp + 4 * gam);
        csc[0] = bf_lo(s2.x), csc[1] = bf_hi(s2.x), csc[2] = bf_lo(s2.y), csc[3] = bf_hi(s2.y);
        czc[0] = bf_lo(z2.x), czc[1] = bf_hi(z2.x), czc[2] = bf_lo(z2.y), czc[3] = bf_hi(z2.y);
      }
      // the code of word `w` at `shift`, dequantized: token side e, code h,
      // channel c of the thread's four
      auto dv_at = [&](uint32_t w, int shift, int e, int h, int c) {
        if constexpr (SH) return deq<BITS>(w, shift, csc[c], czc[c]);
        else return deq<BITS>(w, shift, vsc[e][h], vzc[e][h]);
      };
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int cl = 2 * x, ch = 2 * x + 1;
        // a missing channel's A rows are zero: its zero words would
        // dequantize to the zero point
        const uint32_t mask = live ? 0xffffffffu : 0u;
        const uint32_t a[4] = {
            mask & pack_bf16(dv_at(w0[cl], sh0, 0, 0, cl), dv_at(w1[cl], sh0, 1, 0, cl)),
            mask & pack_bf16(dv_at(w0[ch], sh0, 0, 0, ch), dv_at(w1[ch], sh0, 1, 0, ch)),
            mask & pack_bf16(dv_at(w0[cl], sh1, 0, 1, cl), dv_at(w1[cl], sh1, 1, 1, cl)),
            mask & pack_bf16(dv_at(w0[ch], sh1, 0, 1, ch), dv_at(w1[ch], sh1, 1, 1, ch))};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(o[2 * mp + x][nt], a, pb[nt][0], pb[nt][1]);
      }
    }
  }
  __syncwarp();  // pbuf is rewritten by the next unit
}

// A residual unit: bf16 tokens t0 .. t0 + 7 staged at `st`, of which the
// first `valid` are unmasked.  The tile's rows gamma + 8 repeat rows gamma
// with their scores masked, so their p is 0 against finite values.  SH: V
// is the K residual's channels vb .. vb + DV - 1.
template <int BITS, int W, int DK, int DV, int NT, bool SH>
__device__ __forceinline__ void residual_unit(const unsigned char* st, const bf16* q_s,
                                              int valid, float sm_scale, int vb,
                                              float (&m_run)[NT][2], float (&l_run)[NT][2],
                                              float (&o)[BdShape<BITS, W, DK, DV, NT,
                                                               SH>::OT][NT][4]) {
  using S = BdShape<BITS, W, DK, DV, NT, SH>;
  const int lane = threadIdx.x & 31, gam = lane >> 2, tig = lane & 3;
  const bf16* kr_s = reinterpret_cast<const bf16*>(st);
  const bf16* vr_s = reinterpret_cast<const bf16*>(st + S::OFF_VR);
  float s[1][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[0][nt][c] = 0.f;
#pragma unroll 2
  for (int kc = 0; kc < S::KC; ++kc) {
    const uint2 k0 = *reinterpret_cast<const uint2*>(kr_s + gam * S::KRLD + 16 * kc + 4 * tig);
    const uint32_t a[4] = {k0.x, k0.x, k0.y, k0.y};
    uint32_t qb[NT][2];
    q_fragments<NT, S::QLD>(q_s, kc, gam, tig, qb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) mma_bf16(s[0][nt], a, qb[nt][0], qb[nt][1]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[0][nt][c] = (c < 2 && gam < valid) ? s[0][nt][c] * sm_scale : MASK_VALUE;
  online_softmax(s, m_run, l_run, o);

  uint32_t pb[NT][2];
  p_fragments<NT>(s[0], pb);
  constexpr int VRLD = SH ? S::KRLD : S::VRLD;
  const bf16* vt = (SH ? kr_s + vb : vr_s) + 4 * gam;
#pragma unroll
  for (int mp = 0; mp < S::MP; ++mp) {
    uint2 u0 = make_uint2(0u, 0u), u1 = u0;  // a missing channel: bf16 zeros
    if (32 * mp + 4 * gam < DV) {
      u0 = *reinterpret_cast<const uint2*>(vt + (2 * tig) * VRLD + 32 * mp);
      u1 = *reinterpret_cast<const uint2*>(vt + (2 * tig + 1) * VRLD + 32 * mp);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const uint32_t w0 = x ? u0.y : u0.x, w1 = x ? u1.y : u1.x;
      const uint32_t lo = __byte_perm(w0, w1, 0x5410), hi = __byte_perm(w0, w1, 0x7632);
      const uint32_t a[4] = {lo, hi, lo, hi};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(o[2 * mp + x][nt], a, pb[nt][0], pb[nt][1]);
    }
  }
}

// ------------------------------------------------------------ the CTA

// blockIdx.x = b * H + h, blockIdx.y = split, blockIdx.z = query-row tile
// * n_vc + V chunk.  `a.nb` is the width of the block axis (the dense
// cache's blocks, or the page table's columns); the CTA walks the window
// [a.block_lo, a.block_lo + a.nb_win) of it.
template <int BITS, int W, int DK, int DV, int NT, bool KCH, bool SH, class CellOf>
__device__ __forceinline__ void bitdecode_body(const BdArgs& a, CellOf cell_of) {
  using S = BdShape<BITS, W, DK, DV, NT, SH>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gam = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.x, split = blockIdx.y, b = bh / a.H;
  // this CTA's query rows [row0, row0 + gl) and V channels [vb, vb + DV)
  const int vc = blockIdx.z % a.n_vc, row0 = (blockIdx.z / a.n_vc) * S::G;
  const int gl = min(S::G, a.g - row0), vb = vc * DV;
  const int npr = a.block_n * BITS / 32, upb = npr / W;
  const int kp = KCH ? DK : a.block_n;
  const uint32_t keep = draft_keep<BITS>(a.draft_shift);
  // the merge (launched as a programmatic dependent) may start its CTAs
  // now; it waits in griddepcontrol.wait until this grid has finished
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  bf16* q_s = reinterpret_cast<bf16*>(smem);
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(smem + S::Q_BYTES + warp * S::PBUF);
  unsigned char* ring = smem + S::Q_BYTES + BD_WARPS * S::PBUF;
  unsigned char* mine = ring + warp * BD_STAGES * S::STAGE;
  const size_t base = ((size_t)split * a.B * a.H + bh) * a.g + row0;  // the tile's first row

  // Q's rows (>= g zero) in registers while the lengths load
  constexpr int QCH = (S::G * DK / 8 + BD_THREADS - 1) / BD_THREADS;
  uint4 qv[QCH];
#pragma unroll
  for (int k = 0; k < QCH; ++k) {
    const int i = tid + k * BD_THREADS, r = i / (DK / 8), c = i % (DK / 8);
    qv[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i < S::G * DK / 8 && r < gl)
      qv[k] = *reinterpret_cast<const uint4*>(a.q + ((size_t)bh * a.g + row0 + r) * DK + 8 * c);
  }

  // this warp's units, from the row's own lengths; a CTA with none writes
  // the empty partial (o = 0, lse ~ -1e37) and leaves
  const int pb = min(max(a.pack_blocks[b] - a.block_lo, 0), a.nb_win);
  const int rl = a.read_res ? min(max(a.res_len[b], 0), a.res_n) : 0;
  const int n_pk = pb * upb;
  const int n_u = n_pk + (rl + BD_RES_TOKENS - 1) / BD_RES_TOKENS;
  const int n_w = a.num_splits * BD_WARPS, wg = split * BD_WARPS + warp;
  const int lo = wg * n_u / n_w, hi = (wg + 1) * n_u / n_w;
  if (split * BD_WARPS * n_u / n_w == (split + 1) * BD_WARPS * n_u / n_w) {
    for (int i = tid; i < gl * DV; i += BD_THREADS)
      a.out[(base + i / DV) * a.dv + vb + i % DV] = 0.f;
    if (vc == 0 && tid < gl) a.lse[base + tid] = MASK_VALUE + logf(1e-30f);
    return;
  }

  // queue unit u's copies into this warp's stage (one cp.async of 16 bytes
  // a lane and step; every bound is a constant or at most 32 chunks)
  auto issue = [&](int u, int stage) {
    unsigned char* st = mine + stage * S::STAGE;
    if (u < n_pk) {
      const int blk = u / upb, qg = u - blk * upb;
      const long long cell = cell_of(a.block_lo + blk);
      const int32_t* kw = a.kw + (cell * npr + qg * W) * DK;
#pragma unroll
      for (int k = 0; k < (W * DK / 4 + 31) / 32; ++k) {
        const int c = lane + 32 * k, r = c / (DK / 4), cc = c % (DK / 4);
        if (c < W * DK / 4) cp_async16(st + 4 * (r * S::KLD + 4 * cc), kw + r * DK + 4 * cc);
      }
      for (int c = lane; c < kp / 8; c += 32) {
        cp_async16(st + S::OFF_KS + 16 * c, a.ks + cell * kp + 8 * c);
        cp_async16(st + S::OFF_KZ + 16 * c, a.kz + cell * kp + 8 * c);
      }
      if constexpr (!SH) {
        const int32_t* vw = a.vw + (cell * npr + qg * W) * DV;
#pragma unroll
        for (int k = 0; k < (W * DV / 4 + 31) / 32; ++k) {
          const int c = lane + 32 * k, r = c / (DV / 4), cc = c % (DV / 4);
          if (c < W * DV / 4)
            cp_async16(st + S::OFF_VW + 4 * (r * S::VLD + 4 * cc), vw + r * DV + 4 * cc);
        }
        if (lane < a.block_n / 8) {
          cp_async16(st + S::OFF_VS + 16 * lane, a.vs + cell * a.block_n + 8 * lane);
          cp_async16(st + S::OFF_VZ + 16 * lane, a.vz + cell * a.block_n + 8 * lane);
        }
      }
    } else {
      const size_t t0 = (size_t)bh * a.res_n + (size_t)(u - n_pk) * BD_RES_TOKENS;
#pragma unroll
      for (int k = 0; k < (BD_RES_TOKENS * DK / 8 + 31) / 32; ++k) {
        const int c = lane + 32 * k, r = c / (DK / 8), cc = c % (DK / 8);
        if (c < BD_RES_TOKENS * DK / 8)
          cp_async16(st + 2 * (r * S::KRLD + 8 * cc), a.k_res + (t0 + r) * DK + 8 * cc);
      }
      if constexpr (!SH) {
#pragma unroll
        for (int k = 0; k < (BD_RES_TOKENS * DV / 8 + 31) / 32; ++k) {
          const int c = lane + 32 * k, r = c / (DV / 8), cc = c % (DV / 8);
          if (c < BD_RES_TOKENS * DV / 8)
            cp_async16(st + S::OFF_VR + 2 * (r * S::VRLD + 8 * cc),
                       a.v_res + (t0 + r) * DV + 8 * cc);
        }
      }
    }
  };

  float m_run[NT][2], l_run[NT][2], o[S::OT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) m_run[nt][e] = MASK_VALUE, l_run[nt][e] = 0.f;
#pragma unroll
    for (int t = 0; t < S::OT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[t][nt][c] = 0.f;
  }

#pragma unroll
  for (int k = 0; k < QCH; ++k) {
    const int i = tid + k * BD_THREADS;
    if (i < S::G * DK / 8)
      *reinterpret_cast<uint4*>(q_s + (i / (DK / 8)) * S::QLD + 8 * (i % (DK / 8))) = qv[k];
  }
  __syncthreads();  // Q staged
  // unit u computes from stage (u - lo) % BD_STAGES while unit u + 1 loads
  // into the next; the first pass only queues unit lo (one copy of the issue
  // code)
#pragma unroll 1
  for (int u = lo - 1; u < hi; ++u) {
    if (u + 1 < hi) issue(u + 1, (u + 1 - lo) % BD_STAGES);
    cp_async_commit();
    if (u < lo) continue;
    cp_async_wait<1>();
    __syncwarp();
    const unsigned char* st = mine + ((u - lo) % BD_STAGES) * S::STAGE;
    if (u < n_pk) {
      packed_unit<BITS, W, DK, DV, NT, KCH, SH>(st, q_s, pbuf, u % upb, npr, keep, a.sm_scale,
                                                vb, m_run, l_run, o);
    } else {
      const int t0 = (u - n_pk) * BD_RES_TOKENS;
      residual_unit<BITS, W, DK, DV, NT, SH>(st, q_s, rl - t0, a.sm_scale, vb, m_run, l_run,
                                             o);
    }
    __syncwarp();  // the stage is free for unit u + BD_STAGES
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring

  // combine the warps by logsumexp; an empty CTA (l = 0) gives o = 0 and
  // lse ~ -1e37, which the merge weights out exactly
  float* acc_s = reinterpret_cast<float*>(ring);
  float* m_s = acc_s + BD_WARPS * S::G * DV;
  float* l_s = m_s + BD_WARPS * S::G;
  float* w_s = l_s + BD_WARPS * S::G;
  float* lt_s = w_s + BD_WARPS * S::G;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gi = 8 * nt + 2 * tig + e;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l_run[nt][e] += __shfl_xor_sync(0xffffffffu, l_run[nt][e], off);
      if (gam == 0) m_s[warp * S::G + gi] = m_run[nt][e], l_s[warp * S::G + gi] = l_run[nt][e];
#pragma unroll
      for (int t = 0; t < S::OT; ++t) {
        const int c = 32 * (t >> 1) + 4 * gam + 2 * (t & 1);
        if (c < DV) {  // c even, DV a multiple of 16: c + 1 < DV too
          acc_s[(warp * S::G + gi) * DV + c] = o[t][nt][e];
          acc_s[(warp * S::G + gi) * DV + c + 1] = o[t][nt][2 + e];
        }
      }
    }
  }
  __syncthreads();
  if (tid < gl) {
    float mx = m_s[tid];
    for (int w = 1; w < BD_WARPS; ++w) mx = fmaxf(mx, m_s[w * S::G + tid]);
    float l = 0.f;
    for (int w = 0; w < BD_WARPS; ++w) {
      const float wt = expf(m_s[w * S::G + tid] - mx);
      w_s[w * S::G + tid] = wt;
      l += l_s[w * S::G + tid] * wt;
    }
    lt_s[tid] = fmaxf(l, 1e-30f);
    if (vc == 0) a.lse[base + tid] = mx + logf(fmaxf(l, 1e-30f));  // the same in every chunk
  }
  __syncthreads();
  for (int i = tid; i < gl * DV; i += BD_THREADS) {
    const int gi = i / DV, c = i - gi * DV;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < BD_WARPS; ++w) acc += acc_s[(w * S::G + gi) * DV + c] * w_s[w * S::G + gi];
    a.out[(base + gi) * a.dv + vb + c] = acc / lt_s[gi];
  }
}

// ------------------------------------------------------------ host side

// Calls f(bits, W, DK, NT) as integral constants for every (bits, W, d,
// NT) the kernels have: bits 2, 4, 8 with block_n 32, 64, 128; d 32, 64,
// 128, 256; NT 1 (g <= 8) or 2 (g > 8, in tiles of 16 rows); W as
// bd_unit_rows picks it; and d 112 (zamba2-7b, g = 1) at NT 1.
template <class F>
static cudaError_t bd_dispatch_shape(int bits, int w, int d, int nt, F&& f) {
#define BD_CASE(BI, WW, DD, NN)                                                              \
  if (bits == BI && w == WW && d == DD && nt == NN)                                          \
    return f(std::integral_constant<int, BI>{}, std::integral_constant<int, WW>{},          \
             std::integral_constant<int, DD>{}, std::integral_constant<int, NN>{});
#define BD_CASES_D(DD, NN) \
  BD_CASE(2, 4, DD, NN) BD_CASE(2, 2, DD, NN) BD_CASE(4, 4, DD, NN) BD_CASE(8, 4, DD, NN)
#define BD_CASES_N(NN) \
  BD_CASES_D(32, NN) BD_CASES_D(64, NN) BD_CASES_D(128, NN) BD_CASES_D(256, NN)
  BD_CASES_N(1)
  BD_CASES_N(2)
  BD_CASES_D(112, 1)
#undef BD_CASES_N
#undef BD_CASES_D
#undef BD_CASE
  return cudaErrorInvalidValue;
}

// The shared_kv instances, what the MLA configs use: the latent widths DK
// 160 (the smoke config) and 576, bits 2, 4, 8 at W 4 (block_n 64 and 128),
// NT 1 and 2; K's params per channel.
template <class F>
static cudaError_t bd_dispatch_latent(int bits, int w, int d, int nt, F&& f) {
#define BD_CASE(BI, DD, NN)                                                                \
  if (bits == BI && w == 4 && d == DD && nt == NN)                                         \
    return f(std::integral_constant<int, BI>{}, std::integral_constant<int, 4>{},         \
             std::integral_constant<int, DD>{}, std::integral_constant<int, NN>{});
#define BD_CASES_D(DD, NN) BD_CASE(2, DD, NN) BD_CASE(4, DD, NN) BD_CASE(8, DD, NN)
  BD_CASES_D(160, 1) BD_CASES_D(160, 2) BD_CASES_D(576, 1) BD_CASES_D(576, 2)
#undef BD_CASES_D
#undef BD_CASE
  return cudaErrorInvalidValue;
}

// Calls f(bits, W, DK, DV, NT, KCH, SH) as constants: the split K/V
// instances (DV = DK, K's params per channel or per token, KCH) or, with
// `shared`, the shared_kv ones (DV = BD_LATENT_DV, KCH).
template <class F>
static cudaError_t bd_dispatch(int bits, int w, int d, int nt, int k_channel, int shared, F&& f) {
  using DVL = std::integral_constant<int, BD_LATENT_DV>;
  if (shared) {
    if (!k_channel) return cudaErrorInvalidValue;
    return bd_dispatch_latent(bits, w, d, nt, [&](auto bi, auto ww, auto dd, auto nn) {
      return f(bi, ww, dd, DVL{}, nn, std::true_type{}, std::true_type{});
    });
  }
  if (k_channel)
    return bd_dispatch_shape(bits, w, d, nt, [&](auto bi, auto ww, auto dd, auto nn) {
      return f(bi, ww, dd, dd, nn, std::true_type{}, std::false_type{});
    });
  return bd_dispatch_shape(bits, w, d, nt, [&](auto bi, auto ww, auto dd, auto nn) {
    return f(bi, ww, dd, dd, nn, std::false_type{}, std::false_type{});
  });
}

// The constants of the instance in a bd_dispatch callback whose parameters
// are (bi, w, dk, dv, nt, kch, sh), and its shared memory.
#define BD_INSTANCE_CONSTANTS                                                              \
  constexpr int BI = decltype(bi)::value, WW = decltype(w)::value;                         \
  constexpr int DK = decltype(dk)::value, DV = decltype(dv)::value;                        \
  constexpr int NT = decltype(nt)::value;                                                  \
  constexpr bool KCH = decltype(kch)::value, SH = decltype(sh)::value;                     \
  constexpr int SMEM = BdShape<BI, WW, DK, DV, NT, SH>::SMEM;

// The launch shape's checks and its grid's third axis: query-row tiles of
// 8 * NT times V chunks of DV (shared_kv: d_v / BD_LATENT_DV, d_v <= d_k).
// Returns 0 for shapes the kernels do not take.
static int bd_grid_z(int g, int dk, int dv, int shared, int* n_vc) {
  if (shared ? (dv % BD_LATENT_DV != 0 || dv > dk) : dv != dk) return 0;
  *n_vc = shared ? dv / BD_LATENT_DV : 1;
  const int rows = g > 8 ? 16 : 8;
  return (g + rows - 1) / rows * *n_vc;
}

// Raise the instance's dynamic shared memory limit once; `done` is the
// instance's own flag.
template <class Kernel>
static cudaError_t bd_allow_smem(Kernel kernel, int smem, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) *done = true;
  return err;
}
