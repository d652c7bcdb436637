// Fused low-bit flash-decode attention with split-KV over the dense cache
// (the paper's Packing Kernel), and the logsumexp merge of its splits.
//
// Replaces: src/repro/kernels/bitdecode/kernel.py `bitdecode_attention_pallas`
//           (`_body`, `make_flash_update`, `dequant_tile`, `finalize`) and its
//           XLA epilogue `merge_partials`.
// Bound on the H100: bytes.  A decode step reads every valid packed word
// once; at g <= 16 query rows per KV head the work is at most 2 * g
// multiply-adds per dequantized element, far below the card's
// operations-per-byte balance.  What stands between the kernel and that
// bound is latency (dependent loads, few warps) and the dequantization's
// instructions, not the products.  The MLA decode (shared_kv, g = 128 on a
// 576-wide latent, 4 bits) does ~970 operations a byte it reads: there the
// products bound it.
// Design (bitdecode_body.cuh): the row's packed blocks and residual are cut
// into units of a few KB and spread over num_splits CTAs of 4 warps; each
// warp keeps its next unit's words, scales and zeros in flight with cp.async
// into a two-stage ring while it dequantizes the current one on the CUDA
// cores straight into mma.sync fragments (QK^T and PV on the tensor cores,
// one token permutation shared by both).  The split count is a function of
// the shapes alone, so a launch can be captured in a CUDA graph; which units
// a warp takes is read from the row's own pack_blocks and res_len on the
// device.  The warps of a CTA merge in shared memory; the splits merge in
// bitdecode_merge_kernel, the call's only other launch.  The shared_kv mode
// (the MLA latent cache: V the first d_v channels of K, d_k 160 / 576, g up
// to 128) puts query-row tiles and V chunks on the grid's third axis
// (bitdecode_body.cuh).
//
// Replaces also: the `shared_kv` branches of `_body` (kernel.py:191-192,
// 203-204).
#include "bitdecode_body.cuh"

template <int BITS, int W, int DK, int DV, int NT, bool KCH, bool SH>
__global__ void __launch_bounds__(BD_THREADS) bitdecode_kernel(const BdArgs a) {
  // block j of row (b, h) is cell (b * H + h) * nb + j of [B, H, nb, ...]
  const long long row = (long long)blockIdx.x * a.nb;
  bitdecode_body<BITS, W, DK, DV, NT, KCH, SH>(a, [row](int j) { return row + j; });
}

// Merge of the splits' partials o [S, rows, dv], lse [S, rows] (rows =
// B * H * g) into out [rows, dv], lse [rows], as ref.merge_partials: splits
// with lse ~ -1e37 (no valid token) get weight 0.  Split s's partials start
// at o_part + s * o_ld and lse_part + s * lse_ld (rows * dv and rows for the
// kernel's own splits; the stride of a rank's chunk for the partials the
// ranks of a split-KV walk gathered).  A CTA per row; the S weights go
// through shared memory once.
__global__ void __launch_bounds__(128) bitdecode_merge_kernel(
    const float* __restrict__ o_part, const float* __restrict__ lse_part,
    float* __restrict__ out, float* __restrict__ lse, int S, int dv, long long o_ld,
    long long lse_ld) {
  extern __shared__ float w_s[];  // [S]
  const int row = blockIdx.x, tid = threadIdx.x;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials are written
  for (int s = tid; s < S; s += blockDim.x) w_s[s] = lse_part[s * lse_ld + row];
  __syncthreads();
  float m = w_s[0];
  for (int s = 1; s < S; ++s) m = fmaxf(m, w_s[s]);
  __syncthreads();
  for (int s = tid; s < S; s += blockDim.x) w_s[s] = expf(w_s[s] - m);
  __syncthreads();
  float den = 0.f;
  for (int s = 0; s < S; ++s) den += w_s[s];
  den = fmaxf(den, 1e-30f);
  for (int c = tid; c < dv; c += blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) acc += w_s[s] * o_part[s * o_ld + (size_t)row * dv + c];
    out[(size_t)row * dv + c] = acc / den;
  }
  if (tid == 0) lse[row] = m + logf(den);
}

extern "C" int bitdecode_launch(
    const void* q, const void* kw, const void* ks, const void* kz, const void* vw,
    const void* vs, const void* vz, const void* k_res, const void* v_res,
    const void* pack_blocks, const void* res_len, void* out, void* lse, int B, int H, int g,
    int dk, int dv, int nb, int block_n, int res_n, int bits, int k_channel, int shared,
    int num_splits, int draft_shift, int block_lo, int nb_win, int read_res, float sm_scale,
    void* stream) {
  if (B * H == 0) return 0;
  int n_vc = 1;
  const int gz = bd_grid_z(g, dk, dv, shared, &n_vc);
  if (gz == 0 || draft_shift < 0 || draft_shift >= bits || block_lo < 0 || nb_win < 0 ||
      block_lo + nb_win > nb)
    return (int)cudaErrorInvalidValue;
  const BdArgs a{(const bf16*)q, (const int32_t*)kw, (const bf16*)ks, (const bf16*)kz,
                 (const int32_t*)vw, (const bf16*)vs, (const bf16*)vz, (const bf16*)k_res,
                 (const bf16*)v_res, (const int32_t*)pack_blocks, (const int32_t*)res_len,
                 (float*)out, (float*)lse, B, H, g, nb, block_n, res_n, num_splits, sm_scale,
                 draft_shift, dv, n_vc, block_lo, nb_win, read_res};
  const dim3 grid(B * H, num_splits, gz);
  return (int)bd_dispatch(
      bits, bd_unit_rows(block_n, bits), dk, g > 8 ? 2 : 1, k_channel, shared,
      [&](auto bi, auto w, auto dk, auto dv, auto nt, auto kch, auto sh) {
        BD_INSTANCE_CONSTANTS
        static bool done = false;
        cudaError_t err =
            bd_allow_smem(bitdecode_kernel<BI, WW, DK, DV, NT, KCH, SH>, SMEM, &done);
        if (err != cudaSuccess) return err;
        bitdecode_kernel<BI, WW, DK, DV, NT, KCH, SH>
            <<<grid, BD_THREADS, SMEM, (cudaStream_t)stream>>>(a);
        return cudaGetLastError();
      });
}

// CTAs of the instance for (g, d, block_n, bits, k_channel, shared) resident on one SM
// (what the wrapper's "auto" split count fills), or minus a CUDA error.
extern "C" int bitdecode_ctas_per_sm(int g, int d, int block_n, int bits, int k_channel,
                                     int shared) {
  int n = 0;
  const cudaError_t err = bd_dispatch(
      bits, bd_unit_rows(block_n, bits), d, g > 8 ? 2 : 1, k_channel, shared,
      [&](auto bi, auto w, auto dk, auto dv, auto nt, auto kch, auto sh) {
        BD_INSTANCE_CONSTANTS
        static bool done = false;
        cudaError_t e = bd_allow_smem(bitdecode_kernel<BI, WW, DK, DV, NT, KCH, SH>, SMEM, &done);
        if (e != cudaSuccess) return e;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, bitdecode_kernel<BI, WW, DK, DV, NT, KCH, SH>, BD_THREADS, SMEM);
      });
  return err == cudaSuccess ? n : -(int)err;
}

extern "C" int bitdecode_merge_launch(const void* o_part, const void* lse_part, void* out,
                                      void* lse, int S, int rows, int dv, long long o_ld,
                                      long long lse_ld, void* stream) {
  if (rows == 0) return 0;
  // a programmatic dependent launch: its CTAs start as the decode kernel's
  // last ones do and wait on the device, not behind a launch on the host
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows);
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = S * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, bitdecode_merge_kernel, (const float*)o_part,
                                             (const float*)lse_part, (float*)out, (float*)lse, S,
                                             dv, o_ld, lse_ld);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
