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
// Per CTA (b, h_kv, split): unpack + dequantize the split's packed blocks
// into shared memory, QK^T and PV with bf16 operands and f32 accumulation,
// online softmax; the last split also takes the bf16 residual masked by
// res_len[b].  Each split writes its normalised partial (o, lse); the wrapper
// merges splits by logsumexp.
#pragma once

#include "common.cuh"

#define BD_THREADS 128
#define ROWS 4  // query rows held in registers at a time
#define MASK_VALUE (-1e37f)

struct Tiles {
  bf16* K;     // [tile_n][ldk]
  bf16* V;     // [tile_n][dv]
  float* q;    // [g][dk]
  float* P;    // [g][tile_n]  scores, then bf16-rounded probabilities
  float* acc;  // [g][dv]
  float* m;    // [g]
  float* l;    // [g]
  float* alpha;  // [g]
};

__host__ __device__ inline size_t tile_offset(int tile_n, int ldk, int dv) {
  return ((size_t)tile_n * (ldk + dv) * sizeof(bf16) + 15) & ~(size_t)15;
}

// Dynamic shared memory of one CTA.
inline size_t bitdecode_smem_bytes(int g, int dk, int dv, int block_n, int res_n) {
  const int tile_n = block_n > res_n ? block_n : res_n;
  return tile_offset(tile_n, dk + 2, dv) +
         sizeof(float) * ((size_t)g * (dk + tile_n + dv) + 3 * (size_t)g);
}

// One online-softmax step over n staged tokens, of which the first `valid`
// are unmasked (make_flash_update in the TPU kernel).
static __device__ void flash_update(const Tiles& s, int n, int valid, int g,
                                    int dk, int dv, int tile_n, int ldk,
                                    float sm_scale) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int t = tid; t < n; t += BD_THREADS) {  // scores: a thread per token
    const __nv_bfloat162* krow =
        reinterpret_cast<const __nv_bfloat162*>(s.K + (size_t)t * ldk);
    for (int r0 = 0; r0 < g; r0 += ROWS) {
      float a[ROWS] = {0.f, 0.f, 0.f, 0.f};
      for (int c2 = 0; c2 < dk / 2; ++c2) {
        const float2 kv = __bfloat1622float2(krow[c2]);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          if (r0 + j < g) {
            const float* qr = s.q + (r0 + j) * dk + 2 * c2;
            a[j] = fmaf(qr[0], kv.x, a[j]);
            a[j] = fmaf(qr[1], kv.y, a[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (r0 + j < g)
          s.P[(r0 + j) * tile_n + t] = t < valid ? a[j] * sm_scale : MASK_VALUE;
    }
  }
  __syncthreads();
  for (int r = warp; r < g; r += BD_THREADS / 32) {  // softmax: a warp per row
    float* pr = s.P + r * tile_n;
    float mx = -INFINITY;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    const float m_prev = s.m[r];
    const float m_next = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(pr[t] - m_next);
      sum += p;
      pr[t] = bf2f(__float2bfloat16_rn(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_next);
      s.l[r] = s.l[r] * alpha + sum;
      s.m[r] = m_next;
      s.alpha[r] = alpha;
    }
  }
  __syncthreads();
  for (int c = tid; c < dv; c += BD_THREADS) {  // PV: a thread per channel
    for (int r0 = 0; r0 < g; r0 += ROWS) {
      float a[ROWS] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < n; ++t) {
        const float v = bf2f(s.V[(size_t)t * dv + c]);
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
          if (r0 + j < g) a[j] = fmaf(s.P[(r0 + j) * tile_n + t], v, a[j]);
      }
#pragma unroll
      for (int j = 0; j < ROWS; ++j)
        if (r0 + j < g) {
          float* o = s.acc + (r0 + j) * dv + c;
          *o = *o * s.alpha[r0 + j] + a[j];
        }
    }
  }
  __syncthreads();
}

// Unpack + dequantize one packed (npr, d) word tile into row-major bf16
// rows of stride `ld`; params per channel (`per_channel`) or per token.
static __device__ void dequant_tile(const int32_t* __restrict__ w,
                                    const bf16* __restrict__ scale,
                                    const bf16* __restrict__ zero,
                                    bool per_channel, int npr, int d, int bits,
                                    bf16* out, int ld) {
  const int r = 32 / bits;
  const uint32_t mask = (1u << bits) - 1u;
  for (int idx = threadIdx.x; idx < npr * d; idx += BD_THREADS) {
    const int i = idx / d, c = idx - i * d;
    const uint32_t word = static_cast<uint32_t>(w[idx]);
    for (int k = 0; k < r; ++k) {
      const int t = k * npr + i;
      const int p = per_channel ? c : t;
      const float code = static_cast<float>((word >> (bits * k)) & mask);
      out[(size_t)t * ld + c] =
          __float2bfloat16_rn(fmaf(code, bf2f(scale[p]), bf2f(zero[p])));
    }
  }
}

// The whole CTA: blockIdx.x = b * H + h, blockIdx.y = split.  `nb` is the
// width of the block axis the splits cut (the dense cache's blocks, or the
// page table's columns).
template <class CellOf>
static __device__ void bitdecode_body(
    const bf16* __restrict__ q, const int32_t* __restrict__ kw,
    const bf16* __restrict__ ks, const bf16* __restrict__ kz,
    const int32_t* __restrict__ vw, const bf16* __restrict__ vs,
    const bf16* __restrict__ vz, const bf16* __restrict__ k_res,
    const bf16* __restrict__ v_res, const int32_t* __restrict__ pack_blocks,
    const int32_t* __restrict__ res_len, float* __restrict__ o_part,
    float* __restrict__ lse_part, int B, int H, int g, int dk, int dv, int nb,
    int block_n, int res_n, int bits, int k_channel, int num_splits, int bps,
    float sm_scale, CellOf cell_of) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_n = max(block_n, res_n), ldk = dk + 2;
  Tiles s;
  s.K = reinterpret_cast<bf16*>(smem);
  s.V = s.K + (size_t)tile_n * ldk;
  s.q = reinterpret_cast<float*>(smem + tile_offset(tile_n, ldk, dv));
  s.P = s.q + g * dk;
  s.acc = s.P + g * tile_n;
  s.m = s.acc + g * dv;
  s.l = s.m + g;
  s.alpha = s.l + g;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, split = blockIdx.y, b = bh / H;
  for (int i = tid; i < g * dk; i += BD_THREADS) s.q[i] = bf2f(q[(size_t)bh * g * dk + i]);
  for (int i = tid; i < g * dv; i += BD_THREADS) s.acc[i] = 0.f;
  for (int r = tid; r < g; r += BD_THREADS) {
    s.m[r] = MASK_VALUE;
    s.l[r] = 0.f;
  }
  __syncthreads();

  const int npr = block_n * bits / 32;
  const int kp = k_channel ? dk : block_n;
  const int lo = split * bps;
  const int hi = min(min(lo + bps, nb), pack_blocks[b]);
  for (int blk = lo; blk < hi; ++blk) {
    const long long cell = cell_of(blk);
    dequant_tile(kw + cell * npr * dk, ks + cell * kp, kz + cell * kp,
                 k_channel != 0, npr, dk, bits, s.K, ldk);
    dequant_tile(vw + cell * npr * dv, vs + cell * block_n, vz + cell * block_n,
                 false, npr, dv, bits, s.V, dv);
    __syncthreads();
    flash_update(s, block_n, block_n, g, dk, dv, tile_n, ldk, sm_scale);
  }

  if (split == num_splits - 1) {  // the residual tail rides with the last split
    const bf16* kr = k_res + (size_t)bh * res_n * dk;
    const bf16* vr = v_res + (size_t)bh * res_n * dv;
    for (int idx = tid; idx < res_n * dk; idx += BD_THREADS) {
      const int t = idx / dk;
      s.K[(size_t)t * ldk + (idx - t * dk)] = kr[idx];
    }
    for (int idx = tid; idx < res_n * dv; idx += BD_THREADS) s.V[idx] = vr[idx];
    __syncthreads();
    flash_update(s, res_n, res_len[b], g, dk, dv, tile_n, ldk, sm_scale);
  }

  // finalize: an empty split (l = 0) gives o = 0 and lse ~ -1e37, which the
  // logsumexp merge weights out exactly
  const size_t out = (size_t)split * B * H + bh;
  for (int i = tid; i < g * dv; i += BD_THREADS)
    o_part[out * g * dv + i] = s.acc[i] / fmaxf(s.l[i / dv], 1e-30f);
  for (int r = tid; r < g; r += BD_THREADS)
    lse_part[out * g + r] = s.m[r] + logf(fmaxf(s.l[r], 1e-30f));
}

// Raise the kernel's dynamic shared memory limit when a launch needs more
// than the default 48 KB; `configured` is the kernel's own high-water mark.
template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* configured) {
  if (smem <= *configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = smem;
  return err;
}
