// Quantize + strided-pack one (block_n, d) bf16 tile: the tile math of the
// prefill kernel (kv_quant.cu), the CUDA counterpart of the JAX package's
// kv_quant/kernel.py `quant_block_tile`.  The decode-time flush
// (residual_flush.cu) keeps the same contract in its own body, so both
// commit bitwise-identical packed blocks.
//
// Bitwise contract with the plain PyTorch version (core/quantizer.py):
//   scale = bf16_rn(max((max - min) / qmax, 1e-6)), zero = bf16_rn(min);
//   q = clip(rint((x - zero_f32) / scale_f32), 0, qmax)   -- IEEE division,
//   round half to even; params are rounded to bf16 *before* quantizing.
// Words are assembled as uint32 (plane R-1 may set bit 31) and stored as int32.
#pragma once

#include "common.cuh"

// Runs on the whole thread block (blockDim.x a multiple of 32).  `src` row t
// starts at src + t * ld.  `sm` is shared scratch of 2 * max(d, block_n)
// floats.  Ends with __syncthreads(), so a second call may reuse `sm`.
// Static: it is defined in each source that includes it.
static __device__ void quant_block_tile(const bf16* __restrict__ src, long long ld,
                                 int block_n, int d, int bits, bool channel,
                                 int32_t* __restrict__ words,
                                 bf16* __restrict__ scale,
                                 bf16* __restrict__ zero, float* sm) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int qmax = (1 << bits) - 1;
  const int np = channel ? d : block_n;
  float* s_sm = sm;
  float* z_sm = sm + np;

  auto commit = [&](int i, float mn, float mx) {
    float s = fmaxf(__fdiv_rn(__fsub_rn(mx, mn), (float)qmax), 1e-6f);
    bf16 sb = __float2bfloat16_rn(s), zb = __float2bfloat16_rn(mn);
    scale[i] = sb;
    zero[i] = zb;
    s_sm[i] = bf2f(sb);
    z_sm[i] = bf2f(zb);
  };

  if (channel) {  // statistics along tokens: one thread per channel
    for (int c = tid; c < d; c += nt) {
      float mn = bf2f(src[c]), mx = mn;
      for (int t = 1; t < block_n; ++t) {
        float v = bf2f(src[t * ld + c]);
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
      commit(c, mn, mx);
    }
  } else {  // statistics along channels: one warp per token
    for (int t = warp; t < block_n; t += nwarps) {
      float mn = INFINITY, mx = -INFINITY;
      for (int c = lane; c < d; c += 32) {
        float v = bf2f(src[t * ld + c]);
        mn = fminf(mn, v);
        mx = fmaxf(mx, v);
      }
      mn = warp_min(mn);
      mx = warp_max(mx);
      if (lane == 0) commit(t, mn, mx);
    }
  }
  __syncthreads();

  // strided pack: word (i, c) collects plane k from token k * npr + i
  const int r = 32 / bits, npr = block_n / r;
  for (int idx = tid; idx < npr * d; idx += nt) {
    const int i = idx / d, c = idx - i * d;
    uint32_t w = 0u;
    for (int k = 0; k < r; ++k) {
      const int t = k * npr + i;
      const int p = channel ? c : t;
      float q = rintf(__fdiv_rn(__fsub_rn(bf2f(src[t * ld + c]), z_sm[p]), s_sm[p]));
      q = fminf(fmaxf(q, 0.0f), (float)qmax);
      w |= static_cast<uint32_t>(q) << (bits * k);
    }
    words[idx] = static_cast<int32_t>(w);
  }
  __syncthreads();
}
