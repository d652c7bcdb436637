// Fused residual flush: quantize + pack the full bf16 residual block of every
// sequence with full[b] != 0 and write it, in place, into packed block
// min(dest_block[b], nb - 1) of the dense low-bit cache, or into pool page
// min(dest_page[b], P - 1) of the paged cache (the paper's Residual Kernel,
// decode face, dense and paged).
//
// Replaces: src/repro/kernels/residual_flush/kernel.py `residual_flush_pallas`
//           (dense) and `paged_residual_flush_pallas` (paged).
// Bound on the H100: launch latency on most steps (a flush happens once in
// block_n tokens), bytes when it flushes (two bf16 tiles in, packed words and
// params out).
// Design: one block per (b, h).  It reads full[b] and returns at once when it
// is 0, so the caller launches it every step without a host-side check of
// `full` (which would synchronise every token).  Rows that do not flush are
// not written at all: the TPU kernel's copy-back of the untouched block is not
// needed.  K and V go through the same tile math as the prefill kernel
// (quant_tile.cuh), so a flushed block equals a prefilled one bit for bit.
// The paged kernel differs only in where the block lands: cell page * H + h
// of the [P, H, ...] pools.  Its callers keep the destinations of one launch
// pairwise distinct (rows that do not flush point at their own scratch page,
// and return before writing anyway), so no two programs write one page.
#include "quant_tile.cuh"

__global__ void __launch_bounds__(256) residual_flush_kernel(
    int32_t* __restrict__ kw, bf16* __restrict__ ks, bf16* __restrict__ kz,
    int32_t* __restrict__ vw, bf16* __restrict__ vs, bf16* __restrict__ vz,
    const bf16* __restrict__ k_res, const bf16* __restrict__ v_res,
    const int32_t* __restrict__ full, const int32_t* __restrict__ dest,
    int H, int nb, int block_n, int dk, int dv, int bits, int k_channel) {
  extern __shared__ float sm[];
  const int bh = blockIdx.x, b = bh / H;
  if (full[b] == 0) return;
  const int blk = min(max(dest[b], 0), nb - 1);
  const int npr = block_n * bits / 32;
  const int kp = k_channel ? dk : block_n;
  const long long cell = (long long)bh * nb + blk;
  quant_block_tile(k_res + (long long)bh * block_n * dk, dk, block_n, dk, bits,
                   k_channel != 0, kw + cell * npr * dk, ks + cell * kp,
                   kz + cell * kp, sm);
  quant_block_tile(v_res + (long long)bh * block_n * dv, dv, block_n, dv, bits,
                   false, vw + cell * npr * dv, vs + cell * block_n,
                   vz + cell * block_n, sm);
}

__global__ void __launch_bounds__(256) paged_residual_flush_kernel(
    int32_t* __restrict__ kw, bf16* __restrict__ ks, bf16* __restrict__ kz,
    int32_t* __restrict__ vw, bf16* __restrict__ vs, bf16* __restrict__ vz,
    const bf16* __restrict__ k_res, const bf16* __restrict__ v_res,
    const int32_t* __restrict__ full, const int32_t* __restrict__ dest,
    int H, int n_pages, int block_n, int dk, int dv, int bits, int k_channel) {
  extern __shared__ float sm[];
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  if (full[b] == 0) return;
  const int page = min(max(dest[b], 0), n_pages - 1);
  const int npr = block_n * bits / 32;
  const int kp = k_channel ? dk : block_n;
  const long long cell = (long long)page * H + h;
  quant_block_tile(k_res + (long long)bh * block_n * dk, dk, block_n, dk, bits,
                   k_channel != 0, kw + cell * npr * dk, ks + cell * kp,
                   kz + cell * kp, sm);
  quant_block_tile(v_res + (long long)bh * block_n * dv, dv, block_n, dv, bits,
                   false, vw + cell * npr * dv, vs + cell * block_n,
                   vz + cell * block_n, sm);
}

static size_t flush_smem_bytes(int dk, int dv, int block_n) {
  int widest = dk > dv ? dk : dv;
  widest = widest > block_n ? widest : block_n;
  return 2 * sizeof(float) * (size_t)widest;
}

extern "C" int residual_flush_launch(void* kw, void* ks, void* kz, void* vw,
                                     void* vs, void* vz, const void* k_res,
                                     const void* v_res, const void* full,
                                     const void* dest, int B, int H, int nb,
                                     int block_n, int dk, int dv, int bits,
                                     int k_channel, void* stream) {
  if (B * H == 0) return 0;
  const size_t smem = flush_smem_bytes(dk, dv, block_n);
  residual_flush_kernel<<<B * H, 256, smem, (cudaStream_t)stream>>>(
      (int32_t*)kw, (bf16*)ks, (bf16*)kz, (int32_t*)vw, (bf16*)vs, (bf16*)vz,
      (const bf16*)k_res, (const bf16*)v_res, (const int32_t*)full,
      (const int32_t*)dest, H, nb, block_n, dk, dv, bits, k_channel);
  return (int)cudaGetLastError();
}

extern "C" int paged_residual_flush_launch(void* kw, void* ks, void* kz,
                                           void* vw, void* vs, void* vz,
                                           const void* k_res, const void* v_res,
                                           const void* full, const void* dest,
                                           int B, int H, int n_pages,
                                           int block_n, int dk, int dv,
                                           int bits, int k_channel,
                                           void* stream) {
  if (B * H == 0) return 0;
  const size_t smem = flush_smem_bytes(dk, dv, block_n);
  paged_residual_flush_kernel<<<B * H, 256, smem, (cudaStream_t)stream>>>(
      (int32_t*)kw, (bf16*)ks, (bf16*)kz, (int32_t*)vw, (bf16*)vs, (bf16*)vz,
      (const bf16*)k_res, (const bf16*)v_res, (const int32_t*)full,
      (const int32_t*)dest, H, n_pages, block_n, dk, dv, bits, k_channel);
  return (int)cudaGetLastError();
}
