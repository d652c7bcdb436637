// Causal (or full) flash attention, forward only, for the prefill: bf16 q/k/v,
// f32 scores, online softmax and accumulation, P rounded to bf16 before PV;
// returns bf16 out and f32 lse.  Query head h reads KV head h / (Hq / Hkv).
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py `flash_prefill_pallas`
//           (`_kernel`: the causal block skip, the `s_valid` column mask with
//           -1e37, `l` clamped at 1e-30, P cast to bf16 before PV).
// Bound on the H100: operations at prefill lengths.  Causal attention does
// about 2 * S^2 * d multiply-adds per head and reads q/k/v once, so at
// S = 2048, d = 128 it needs ~1,000 operations per byte, far above the
// card's ~295 bf16 operations per byte of device memory.
// Design: one CTA of 4 warps per (tile of 64 query rows, q-head, batch row),
// heaviest causal tiles launched first.  Each warp owns 16 query rows.  The
// CTA copies the Q tile and then each KV tile (64 rows; 32 at d = 256 to
// bound registers) into shared memory with cp.async, two stages deep, so the
// next tile's copy runs under this tile's products; rows are padded by 8
// elements so the ldmatrix fragment loads are free of bank conflicts.  QK^T
// and PV run on the tensor cores as mma.sync m16n8k16 (bf16 operands, f32
// accumulators; V's fragments through ldmatrix.trans); the score fragment is
// rescaled, masked and exponentiated in registers and becomes the A operand
// of PV directly.  The running max is kept per row, the running sum per
// thread (its quad's columns) and reduced once at the end.  KV tiles wholly
// above a warp's rows are skipped; masking is applied only on tiles that
// cross the diagonal or the end of S.  Reads go through strides, so
// [B, S, H, d] and [B, H, S, d] are both taken as they are.  Not yet: wgmma,
// TMA, warp specialisation.
#include "common.cuh"

#define FP_WARPS 4
#define FP_THREADS (FP_WARPS * 32)
#define FP_BQ (FP_WARPS * 16)  // query rows of a CTA: 16 per warp
#define FP_MASK (-1e37f)

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments of four 8x8 bf16 matrices from shared memory: lanes 8m..8m+7
// give the row addresses of matrix m, register m receives its fragment
// (`_t`: transposed, for an operand stored with its k axis along rows).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

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

// 16 bytes from device to shared memory without passing through registers;
// zero-filled when `valid` is false (nothing is read then).
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying ROWS rows of D bf16 (row stride `ld_g` elements in device
// memory) into shared memory rows of stride LD; rows at or past `valid`
// (>= 1) are zero-filled.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ld_g, int valid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CH % FP_THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int j = 0; j < ROWS * CH / FP_THREADS; ++j) {
    const int i = threadIdx.x + j * FP_THREADS;
    const int r = i / CH, c = (i % CH) * 8;
    cp_async16(dst + r * LD + c, src + (r < valid ? r * ld_g + c : 0), r < valid);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(FP_THREADS) flash_prefill_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int Hq, int Hkv, int S, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    float sm_scale) {
  constexpr int LD = D + 8;  // shared row stride (elements): 16-byte rows
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [FP_BQ][LD]
  bf16* KV = Qs + FP_BQ * LD;  // two stages of K [BK][LD] then V [BK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FP_BQ;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row group, column pair
  const int lm = lane >> 3, lr = lane & 7;  // ldmatrix: matrix, row of it
  const int w0 = q0 + warp * 16;            // this warp's first query row
  const int row0 = w0 + gr, row1 = row0 + 8;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  const int n_kv = causal ? min(S, q0 + FP_BQ) : S;
  const int n_tiles = (n_kv + BK - 1) / BK;
  stage_rows<D, LD, FP_BQ>(Qs, q + b * qsb + h * qsh + q0 * qss, qss, S - q0);
  stage_rows<D, LD, BK>(KV, kb, kss, S);
  stage_rows<D, LD, BK>(KV + BK * LD, vb, vss, S);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m0 = FP_MASK, m1 = FP_MASK;  // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;          // running sum over this thread's columns
  // this lane's ldmatrix row of the warp's Q tile: matrices (rows 0-7 | 8-15)
  // x (columns 0-7 | 8-15) of each 16-channel chunk, in a0..a3 order
  const bf16* qa = Qs + (warp * 16 + (lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const bf16* Ks = KV + (t & 1) * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;
    if (t + 1 < n_tiles) {  // start the next tile into the other stage
      bf16* Kn = KV + ((t + 1) & 1) * 2 * BK * LD;
      stage_rows<D, LD, BK>(Kn, kb + (k0 + BK) * kss, kss, S - k0 - BK);
      stage_rows<D, LD, BK>(Kn + BK * LD, vb + (k0 + BK) * vss, vss, S - k0 - BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) visible to every warp

    if (!causal || k0 <= w0 + 15) {  // else: above all of this warp's rows
      float s[BK / 8][4];
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // B operand rows: keys (2 n-tiles per ldmatrix) x channel halves
      const bf16* kr = Ks + ((lm >> 1) * 8 + lr) * LD + (lm & 1) * 8;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {  // S = Q K^T, 16 channels at a time
        uint32_t a[4];
        ldsm_x4(a, qa + kc * 16);
#pragma unroll
        for (int np = 0; np < BK / 16; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, kr + np * 16 * LD + kc * 16);
          mma_16816(s[2 * np], a, bk[0], bk[1]);
          mma_16816(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }

      // scale, mask (only where a column can be past S or above a row), max
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > w0);
      float mx0 = FP_MASK, mx1 = FP_MASK;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sm_scale;
          if (edge) {
            const int col = k0 + nt * 8 + 2 * tg + (e & 1);
            const int row = e < 2 ? row0 : row1;
            if (col >= S || (causal && col > row)) x = FP_MASK;
          }
          s[nt][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        s[nt][0] = expf(s[nt][0] - mn0);
        s[nt][1] = expf(s[nt][1] - mn0);
        s[nt][2] = expf(s[nt][2] - mn1);
        s[nt][3] = expf(s[nt][3] - mn1);
        sum0 += s[nt][0] + s[nt][1];
        sum1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][0] *= alpha0;
        acc[dt][1] *= alpha0;
        acc[dt][2] *= alpha1;
        acc[dt][3] *= alpha1;
      }

      // B operand rows: keys (halves of 16) x channels (2 n-tiles per ldmatrix)
      const bf16* vr = Vs + ((lm & 1) * 8 + lr) * LD + (lm >> 1) * 8;
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {  // O += P V, 16 keys at a time
        const uint32_t a[4] = {round_pair(s[2 * kc][0], s[2 * kc][1]),
                               round_pair(s[2 * kc][2], s[2 * kc][3]),
                               round_pair(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                               round_pair(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vr + kc * 16 * LD + dp * 16);
          mma_16816(acc[2 * dp], a, bv[0], bv[1]);
          mma_16816(acc[2 * dp + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + 2 * tg;
    if (row0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * oss + c) =
          __floats2bfloat162_rn(acc[dt][0] / l0, acc[dt][1] / l0);
    if (row1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + row1 * oss + c) =
          __floats2bfloat162_rn(acc[dt][2] / l1, acc[dt][3] / l1);
  }
  if (tg == 0) {
    float* lb = lse + ((long long)b * Hq + h) * S;
    if (row0 < S) lb[row0] = m0 + logf(l0);
    if (row1 < S) lb[row1] = m1 + logf(l1);
  }
}

template <int D, int BK>
static cudaError_t launch_fp(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Hq, int Hkv, int S,
                             const long long* st, int causal, float sm_scale,
                             void* stream) {
  const size_t smem = (size_t)(FP_BQ + 4 * BK) * (D + 8) * sizeof(bf16);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<D, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((S + FP_BQ - 1) / FP_BQ, Hq, B);
  flash_prefill_kernel<D, BK><<<grid, FP_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, Hq,
      Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, sm_scale);
  return cudaGetLastError();
}

// Strides are in elements, (batch, sequence, head) for each of q, k, v, out;
// channels are contiguous and every row 16-byte aligned (the wrapper checks).
extern "C" int flash_prefill_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Hq, int Hkv, int S, int d, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long oss, long long osh, int causal,
    float sm_scale, void* stream) {
  if (B * Hq * S == 0) return 0;
  const long long st[12] = {qsb, qss, qsh, ksb, kss, ksh,
                            vsb, vss, vsh, osb, oss, osh};
  cudaError_t err = cudaErrorInvalidValue;
  switch (d) {  // KV tiles of 32 rows at d = 256 keep the registers under 255
    case 32:
      err = launch_fp<32, 64>(q, k, v, o, lse, B, Hq, Hkv, S, st, causal, sm_scale, stream);
      break;
    case 64:
      err = launch_fp<64, 64>(q, k, v, o, lse, B, Hq, Hkv, S, st, causal, sm_scale, stream);
      break;
    case 128:
      err = launch_fp<128, 64>(q, k, v, o, lse, B, Hq, Hkv, S, st, causal, sm_scale, stream);
      break;
    case 256:
      err = launch_fp<256, 32>(q, k, v, o, lse, B, Hq, Hkv, S, st, causal, sm_scale, stream);
      break;
  }
  return (int)err;
}
