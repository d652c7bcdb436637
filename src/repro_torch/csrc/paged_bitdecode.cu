// Fused low-bit flash-decode attention with split-KV over the paged cache
// (the paper's Page setting): the dense kernel's body (bitdecode_body.cuh)
// walking each sequence's blocks through its page-table row.  Packed block j
// of row b, head h lives in pool page page_table[b, j], head h: cell
// page * H + h of the [P, H, npr, d] word pools and [P, H, kp] param pools.
// Its splits merge in the dense file's bitdecode_merge_kernel.
//
// Replaces: src/repro/kernels/paged_bitdecode/kernel.py
//           `paged_bitdecode_attention_pallas` (`_paged_body`).
// Bound on the H100: bytes, as the dense kernel: every valid packed word of
// every sequence is read once, plus one int32 table entry per block.
// Design: the dense kernel's (bitdecode.cu).  The work of a row is cut by
// its own pack_blocks and res_len, not by the table's width, so a row with
// few blocks in a wide table spreads over all of its warps.  The TPU kernel
// fetches pages through a scalar-prefetch index map; here the warp reads
// table entry (b, j) when it queues block j's copies, a unit ahead of its
// compute.  A page id outside [0, P) is clamped to P - 1, so a corrupt table
// entry reads a wrong page rather than out of bounds.  With an identity
// table over a pool laid out as the dense cache the arithmetic is the dense
// kernel's, in the same order: the two agree bit for bit.  The shared_kv
// mode (the MLA latent pools) is the dense kernel's.
//
// Replaces also: the `shared_kv` branches of `_paged_body` (kernel.py:60,
// 70).
#include "bitdecode_body.cuh"

template <int BITS, int W, int DK, int DV, int NT, bool KCH, bool SH>
__global__ void __launch_bounds__(BD_THREADS) paged_bitdecode_kernel(
    const BdArgs a, const int32_t* __restrict__ page_table, int n_pages, int page_lo) {
  const int h = blockIdx.x % a.H;
  const int32_t* row = page_table + (long long)(blockIdx.x / a.H) * a.nb;
  const int H = a.H;
  bitdecode_body<BITS, W, DK, DV, NT, KCH, SH>(a, [row, h, H, n_pages, page_lo](int j) {
    const int page = min(max(row[j] - page_lo, 0), n_pages - 1);
    return (long long)page * H + h;
  });
}

extern "C" int paged_bitdecode_launch(
    const void* q, const void* kw, const void* ks, const void* kz, const void* vw,
    const void* vs, const void* vz, const void* k_res, const void* v_res,
    const void* page_table, const void* pack_blocks, const void* res_len, void* out,
    void* lse, int B, int H, int g, int dk, int dv, int nb_max, int n_pages, int block_n,
    int res_n, int bits, int k_channel, int shared, int num_splits, int draft_shift,
    int block_lo, int nb_win, int read_res, int page_lo, float sm_scale, void* stream) {
  if (B * H == 0) return 0;
  int n_vc = 1;
  const int gz = bd_grid_z(g, dk, dv, shared, &n_vc);
  if (gz == 0 || draft_shift < 0 || draft_shift >= bits || block_lo < 0 || nb_win < 0 ||
      block_lo + nb_win > nb_max)
    return (int)cudaErrorInvalidValue;
  const BdArgs a{(const bf16*)q, (const int32_t*)kw, (const bf16*)ks, (const bf16*)kz,
                 (const int32_t*)vw, (const bf16*)vs, (const bf16*)vz, (const bf16*)k_res,
                 (const bf16*)v_res, (const int32_t*)pack_blocks, (const int32_t*)res_len,
                 (float*)out, (float*)lse, B, H, g, nb_max, block_n, res_n, num_splits,
                 sm_scale, draft_shift, dv, n_vc, block_lo, nb_win, read_res};
  const dim3 grid(B * H, num_splits, gz);
  return (int)bd_dispatch(
      bits, bd_unit_rows(block_n, bits), dk, g > 8 ? 2 : 1, k_channel, shared,
      [&](auto bi, auto w, auto dk, auto dv, auto nt, auto kch, auto sh) {
        BD_INSTANCE_CONSTANTS
        static bool done = false;
        cudaError_t err =
            bd_allow_smem(paged_bitdecode_kernel<BI, WW, DK, DV, NT, KCH, SH>, SMEM, &done);
        if (err != cudaSuccess) return err;
        paged_bitdecode_kernel<BI, WW, DK, DV, NT, KCH, SH>
            <<<grid, BD_THREADS, SMEM, (cudaStream_t)stream>>>(a, (const int32_t*)page_table,
                                                                n_pages, page_lo);
        return cudaGetLastError();
      });
}
