// Shared helpers of the port's CUDA kernels: bf16 conversions, warp
// reductions, and the quantization params of the K1 / K2 / K5 contract.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// eight bf16 (one 16-byte load) to floats, exactly
__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float* f) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = __uint_as_float(v[e] << 16);
    f[2 * e + 1] = __uint_as_float(v[e] & 0xffff0000u);
  }
}

// The params of one channel or token from its min / max, kept in shared
// memory as the floats the quantize divides by (bf16 values: stored later
// from there, exactly).  The bitwise contract with the plain version
// (core/quantizer.py): scale = bf16(max(__fdiv_rn(max - min, qmax), 1e-6)),
// zero = bf16(min); no reciprocal, no fast math.
__device__ __forceinline__ void commit_params(float mn, float mx, int qmax, float* s_sm,
                                              float* z_sm) {
  const float s = fmaxf(__fdiv_rn(__fsub_rn(mx, mn), (float)qmax), 1e-6f);
  *s_sm = bf2f(__float2bfloat16_rn(s));
  *z_sm = bf2f(__float2bfloat16_rn(mn));
}
