// Fused quantize + strided pack of a prefill's K or V (the paper's Residual
// Kernel, prefill face).
//
// Replaces: src/repro/kernels/kv_quant/kernel.py `quantize_kv_pallas`
//           (tile math `quant_block_tile`).
// Bound on the H100: bytes.  It reads the bf16 tensor once and writes a
// quarter of it (4-bit words) plus the params; a few float ops per element.
// Design: one block per (b, h, packed block).  The tile is read from global
// memory twice (statistics, then pack); the second read hits L1/L2, so device
// memory sees it about once.  Reads are coalesced along the channel axis.
// Strides are taken in elements, so the transposed [B, H, S, d] view of a
// model's [B, S, H, d] keys is read without a copy.
#include "quant_tile.cuh"

__global__ void __launch_bounds__(256) kv_quant_kernel(
    const bf16* __restrict__ x, long long sb, long long sh, long long st,
    int32_t* __restrict__ words, bf16* __restrict__ scale,
    bf16* __restrict__ zero, int H, int nb, int block_n, int d, int bits,
    int channel) {
  extern __shared__ float sm[];
  const int blk = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int npr = block_n * bits / 32;
  const int np = channel ? d : block_n;
  const long long cell = (long long)bh * nb + blk;
  const bf16* src = x + b * sb + h * sh + (long long)blk * block_n * st;
  quant_block_tile(src, st, block_n, d, bits, channel != 0,
                   words + cell * npr * d, scale + cell * np, zero + cell * np,
                   sm);
}

extern "C" int kv_quant_launch(const void* x, long long sb, long long sh,
                               long long st, void* words, void* scale,
                               void* zero, int B, int H, int nb, int block_n,
                               int d, int bits, int channel, void* stream) {
  if (nb == 0 || B * H == 0) return 0;
  const int np = channel ? d : block_n;
  const size_t smem = 2 * sizeof(float) * (size_t)(np > block_n ? np : block_n);
  dim3 grid(nb, B * H);
  kv_quant_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, sb, sh, st, (int32_t*)words, (bf16*)scale, (bf16*)zero,
      H, nb, block_n, d, bits, channel);
  return (int)cudaGetLastError();
}
