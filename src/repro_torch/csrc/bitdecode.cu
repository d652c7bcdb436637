// Fused low-bit flash-decode attention with split-KV over the dense cache
// (the paper's Packing Kernel): unpack + dequantize the packed K/V blocks,
// QK^T and PV with bf16 operands and f32 accumulation, online softmax; the
// last split also takes the bf16 residual masked by res_len[b].  Each split
// writes its normalised partial (o, lse); the wrapper merges splits by
// logsumexp.  The body is bitdecode_body.cuh, shared with the paged kernel.
//
// Replaces: src/repro/kernels/bitdecode/kernel.py `bitdecode_attention_pallas`
//           (`_body`, `make_flash_update`, `dequant_tile`, `finalize`).
// Bound on the H100: bytes.  A decode step reads every valid packed word
// once; at g = 4 query rows per KV head the work is about 4 multiply-adds per
// dequantized element, far below the card's operations-per-byte balance.
// Design: one CTA of 128 threads per (b, h_kv, split), looping over the
// split's blocks (the TPU grid's sequential axis becomes this loop).  Words
// are read coalesced along channels, unpacked (shift, mask), dequantized with
// an f32 FMA rounded to bf16 exactly as `dequant_tile` does, and stored in
// shared memory: K row-major with a 2-element row pad (conflict-free
// per-token dot products), V row-major (one thread per value channel).
// Scores and PV run on the CUDA cores; P is rounded to bf16 before PV as on
// the MXU.  The split axis supplies parallelism when B * H_kv underfills the
// 132 SMs.  No cp.async / TMA pipelining and no tensor cores yet.
#include "bitdecode_body.cuh"

__global__ void __launch_bounds__(BD_THREADS) bitdecode_kernel(
    const bf16* __restrict__ q, const int32_t* __restrict__ kw,
    const bf16* __restrict__ ks, const bf16* __restrict__ kz,
    const int32_t* __restrict__ vw, const bf16* __restrict__ vs,
    const bf16* __restrict__ vz, const bf16* __restrict__ k_res,
    const bf16* __restrict__ v_res, const int32_t* __restrict__ pack_blocks,
    const int32_t* __restrict__ res_len, float* __restrict__ o_part,
    float* __restrict__ lse_part, int B, int H, int g, int dk, int dv, int nb,
    int block_n, int res_n, int bits, int k_channel, int num_splits, int bps,
    float sm_scale) {
  // block j of row (b, h) is cell (b * H + h) * nb + j of [B, H, nb, ...]
  const long long row = (long long)blockIdx.x * nb;
  bitdecode_body(q, kw, ks, kz, vw, vs, vz, k_res, v_res, pack_blocks, res_len,
                 o_part, lse_part, B, H, g, dk, dv, nb, block_n, res_n, bits,
                 k_channel, num_splits, bps, sm_scale,
                 [row](int j) { return row + j; });
}

extern "C" int bitdecode_launch(
    const void* q, const void* kw, const void* ks, const void* kz,
    const void* vw, const void* vs, const void* vz, const void* k_res,
    const void* v_res, const void* pack_blocks, const void* res_len,
    void* o_part, void* lse_part, int B, int H, int g, int dk, int dv, int nb,
    int block_n, int res_n, int bits, int k_channel, int num_splits, int bps,
    float sm_scale, void* stream) {
  if (B * H == 0) return 0;
  const size_t smem = bitdecode_smem_bytes(g, dk, dv, block_n, res_n);
  static size_t configured = 48 * 1024;
  cudaError_t err = allow_smem(bitdecode_kernel, smem, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, num_splits);
  bitdecode_kernel<<<grid, BD_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const int32_t*)kw, (const bf16*)ks, (const bf16*)kz,
      (const int32_t*)vw, (const bf16*)vs, (const bf16*)vz, (const bf16*)k_res,
      (const bf16*)v_res, (const int32_t*)pack_blocks, (const int32_t*)res_len,
      (float*)o_part, (float*)lse_part, B, H, g, dk, dv, nb, block_n, res_n,
      bits, k_channel, num_splits, bps, sm_scale);
  return (int)cudaGetLastError();
}
