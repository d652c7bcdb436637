// Fused low-bit flash-decode attention with split-KV over the paged cache
// (the paper's Page setting): the dense kernel's body (bitdecode_body.cuh)
// walking each sequence's blocks through its page-table row.  Packed block j
// of row b, head h lives in pool page page_table[b, j], head h: cell
// page * H + h of the [P, H, npr, d] word pools and [P, H, kp] param pools.
//
// Replaces: src/repro/kernels/paged_bitdecode/kernel.py
//           `paged_bitdecode_attention_pallas` (`_paged_body`).
// Bound on the H100: bytes, as the dense kernel: every valid packed word of
// every sequence is read once, plus one int32 table entry per block.
// Design: one CTA of 128 threads per (b, h_kv, split); split s owns table
// columns [s * bps, (s + 1) * bps) cut to pack_blocks[b], the residual rides
// with the last split.  The TPU kernel fetches pages through a scalar-
// prefetch index map; here the CTA reads table entry (b, j) once per block,
// a broadcast load, and computes the page's offset itself.  A page id
// outside [0, P) is clamped to P - 1, so a corrupt table entry reads a wrong
// page rather than out of bounds.  With an identity table over a pool laid
// out as the dense cache the arithmetic is the dense kernel's, in the same
// order: the two agree bit for bit.
#include "bitdecode_body.cuh"

__global__ void __launch_bounds__(BD_THREADS) paged_bitdecode_kernel(
    const bf16* __restrict__ q, const int32_t* __restrict__ kw,
    const bf16* __restrict__ ks, const bf16* __restrict__ kz,
    const int32_t* __restrict__ vw, const bf16* __restrict__ vs,
    const bf16* __restrict__ vz, const bf16* __restrict__ k_res,
    const bf16* __restrict__ v_res, const int32_t* __restrict__ page_table,
    const int32_t* __restrict__ pack_blocks,
    const int32_t* __restrict__ res_len, float* __restrict__ o_part,
    float* __restrict__ lse_part, int B, int H, int g, int dk, int dv,
    int nb_max, int n_pages, int block_n, int res_n, int bits, int k_channel,
    int num_splits, int bps, float sm_scale) {
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int32_t* row = page_table + (long long)b * nb_max;
  bitdecode_body(q, kw, ks, kz, vw, vs, vz, k_res, v_res, pack_blocks, res_len,
                 o_part, lse_part, B, H, g, dk, dv, nb_max, block_n, res_n,
                 bits, k_channel, num_splits, bps, sm_scale,
                 [row, h, H, n_pages](int j) {
                   const int page = min(max(row[j], 0), n_pages - 1);
                   return (long long)page * H + h;
                 });
}

extern "C" int paged_bitdecode_launch(
    const void* q, const void* kw, const void* ks, const void* kz,
    const void* vw, const void* vs, const void* vz, const void* k_res,
    const void* v_res, const void* page_table, const void* pack_blocks,
    const void* res_len, void* o_part, void* lse_part, int B, int H, int g,
    int dk, int dv, int nb_max, int n_pages, int block_n, int res_n, int bits,
    int k_channel, int num_splits, int bps, float sm_scale, void* stream) {
  if (B * H == 0) return 0;
  const size_t smem = bitdecode_smem_bytes(g, dk, dv, block_n, res_n);
  static size_t configured = 48 * 1024;
  cudaError_t err = allow_smem(paged_bitdecode_kernel, smem, &configured);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, num_splits);
  paged_bitdecode_kernel<<<grid, BD_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const int32_t*)kw, (const bf16*)ks, (const bf16*)kz,
      (const int32_t*)vw, (const bf16*)vs, (const bf16*)vz, (const bf16*)k_res,
      (const bf16*)v_res, (const int32_t*)page_table,
      (const int32_t*)pack_blocks, (const int32_t*)res_len, (float*)o_part,
      (float*)lse_part, B, H, g, dk, dv, nb_max, n_pages, block_n, res_n, bits,
      k_channel, num_splits, bps, sm_scale);
  return (int)cudaGetLastError();
}
