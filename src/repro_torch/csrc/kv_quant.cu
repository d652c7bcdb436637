// Fused quantize + strided pack of a prefill's K and V, straight into the
// cache (the paper's Residual Kernel, prefill face).
//
// Replaces: src/repro/kernels/kv_quant/kernel.py `quantize_kv_pallas` (:105,
//           tile math `quant_block_tile`), which a layer's prefill calls once
//           for K and once for V.
// Bound on the H100: bytes.  Each bf16 element is read once and bits / 16 of
// it written back as packed words, plus the params; ~20 instructions an
// element (one IEEE division among them) have to hide under that stream.
// Design:
//  * One launch takes K and V (or one tensor).  Its work is cut into units:
//    (tensor, b, h, packed block, part).  A part is a slice of the block's
//    channels for channel-wise K (a channel's params depend on that channel
//    alone, so a wide head is cut into slices of at most 16 chunks of 8
//    channels and a [128, 576] tile is never staged whole), or a group of a
//    power of two of word rows (the tokens those words hold) for token-wise
//    V.  A unit is at most 32 KB of bf16.
//  * One CTA a unit, the grid every unit: with 3 CTAs an SM resident (the
//    registers are sized for it), the hardware hands each SM its next unit
//    as one finishes, K's and V's alike.  (A resident wave of CTAs walking
//    fixed runs of units measured slower: scripts/kv_quant_variants.py.)
//  * A thread copies its slots of the tile into shared memory with cp.async,
//    up to 8 of 16 bytes in flight and no staging registers, reading the
//    strided [B, H, S, d] view as it is (row stride st, unit channel
//    stride).  Once its own copies land it takes the statistics of its
//    slots: per channel, each thread keeps the min / max of its 8 channels,
//    combined by shuffles over the lanes of one chunk and one shared-memory
//    pass over the warps; per token, by shuffles within the lanes of that
//    token, every row at once.
//  * Words are packed from shared memory, four channels a thread, and stored
//    16 bytes at a time into strided destinations (the cache's first blocks),
//    so the cache is written in place with no copy.  A zero numerator (the
//    min of its channel or token) takes no division: its range check would
//    send the whole warp down the division's slow path (the div_zero
//    ablation of scripts/kv_quant_variants.py).  rint is the float add of
//    1.5 * 2^23 after the clip.
//  * BITS and the granularity are template parameters: the plane loop
//    unrolls and each unit runs code for its own granularity.
//  * Bitwise contract with the plain version (core/quantizer.py), its params
//    from common.cuh's commit_params as the flush's: scale =
//    bf16(max(__fdiv_rn(max - min, qmax), 1e-6)), zero = bf16(min), q =
//    clip(rintf(__fdiv_rn(x - zero, scale)), 0, qmax) with the params rounded
//    to bf16 first; no reciprocal, no fast math.  A block packed here equals
//    the block the flush packs from the same tokens.
#include "common.cuh"

namespace {

constexpr int KQ_THREADS = 256;
constexpr int KQ_WARPS = KQ_THREADS / 32;
constexpr int KQ_BATCH = 8;                         // 16-byte loads a thread a unit, at most
constexpr int KQ_TILE = KQ_THREADS * KQ_BATCH * 8;  // bf16 elements a unit, at most
constexpr int KQ_SLICE = 16;                        // chunks of 8 channels a channel slice
constexpr int KQ_MAX_BLOCK = 256;                   // block_n, at most
constexpr int KQ_MAX_D = 576;
constexpr int KQ_MIN_CTAS = 3;  // CTAs an SM the registers are sized for

struct KqTensor {
  const bf16* x;  // [B, H, S, d], unit channel stride
  long long x_sb, x_sh, x_st;
  int32_t* w;     // [B, H, nb, npr, d], unit channel stride
  long long w_sb, w_sh, w_sn, w_si;
  bf16* s;        // [B, H, nb, d or block_n], unit last stride
  long long s_sb, s_sh, s_sn;
  bf16* z;
  long long z_sb, z_sh, z_sn;
  int chunks;    // d / 8
  int channel;   // params per channel (else per token)
  int parts;     // parts a block
  int width;     // chunks a part (channel) or word rows a part (token: a power of two)
  int lg_width;  // token: log2(width)
  int lg_lanes;  // lanes that load one row: 1 << lg_lanes, at most 32
  int reps;      // token: 16-byte chunks a lane loads of one row (1 to 3)
  int units;     // B * H * nb * parts
};

struct KqArgs {
  KqTensor t[2];
  int H, nb, block_n, units;
};

struct Unit {
  int t, b, h, blk;
  int c0, cw;  // chunks [c0, c0 + cw) of the tile (channel: the slice; token: all)
  int i0, nr;  // word rows [i0, i0 + nr) (channel: all)
  int rows;    // tile rows: block_n (channel), or CPW * width (token: row (k, ii) at
               // k * width + ii holds token k * npr + i0 + ii; rows with ii >= nr unused)
};

__device__ __forceinline__ Unit unit_of(const KqArgs& a, int u, int npr, int cpw) {
  Unit n;
  n.t = u >= a.t[0].units;
  const KqTensor& T = a.t[n.t];
  if (n.t) u -= a.t[0].units;
  const int p = u % T.parts;
  u /= T.parts;
  n.blk = u % a.nb;
  u /= a.nb;
  n.h = u % a.H;
  n.b = u / a.H;
  if (T.channel) {
    n.c0 = p * T.width;
    n.cw = min(T.width, T.chunks - n.c0);
    n.i0 = 0;
    n.nr = npr;
    n.rows = a.block_n;
  } else {
    n.c0 = 0;
    n.cw = T.chunks;
    n.i0 = p * T.width;
    n.nr = min(T.width, npr - n.i0);
    n.rows = cpw * T.width;
  }
  return n;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool CH>
__device__ __forceinline__ bool row_ok(const KqTensor& T, const Unit& n, int j) {
  return j < n.rows && (CH || (j & (T.width - 1)) < n.nr);
}

// the token (in the block) of tile row j
template <bool CH>
__device__ __forceinline__ int token_of(const KqTensor& T, const Unit& n, int j, int npr) {
  return CH ? j : (j >> T.lg_width) * npr + n.i0 + (j & (T.width - 1));
}

// Load slot s of a thread: tile row rs + (s / REPS) * (threads / lanes), chunk
// lc + (s % REPS) * lanes of the part, copied into the tile ([rows, cw * 8]
// bf16) by cp.async.  The same slots in every lane.
template <bool CH, int REPS>
__device__ __forceinline__ void load_unit(const KqArgs& a, const Unit& n, int npr, bf16* tile) {
  const KqTensor& T = a.t[n.t];
  const int L = 1 << T.lg_lanes, P = KQ_THREADS >> T.lg_lanes;
  const int lc = threadIdx.x & (L - 1), rs = threadIdx.x >> T.lg_lanes;
  const bf16* x = T.x + n.b * T.x_sb + n.h * T.x_sh + (long long)n.blk * a.block_n * T.x_st;
  const int W = n.cw * 8;
#pragma unroll
  for (int s = 0; s < KQ_BATCH; ++s) {
    const int j = rs + (s / REPS) * P, c = lc + (s % REPS) * L;
    if (row_ok<CH>(T, n, j) && c < n.cw) {
      cp_async16(tile + j * W + c * 8, x + token_of<CH>(T, n, j, npr) * T.x_st + (n.c0 + c) * 8);
    }
  }
}

// The statistics of the arrived tile, each thread over the slots it copied
// (complete once it has waited for its own copies), the params committed to
// shared memory and stored.  Ends with __syncthreads(), after which the
// whole tile is visible to every thread.
template <bool CH, int REPS>
__device__ __forceinline__ void stage_unit(const KqArgs& a, const Unit& n, int npr, int qmax,
                                           const bf16* tile, float* part, float* s_sm,
                                           float* z_sm) {
  constexpr int PASSES = (KQ_BATCH + REPS - 1) / REPS;  // tile rows a thread
  const KqTensor& T = a.t[n.t];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = 1 << T.lg_lanes, P = KQ_THREADS >> T.lg_lanes;
  const int lc = tid & (L - 1), rs = tid >> T.lg_lanes, W = n.cw * 8;
  bf16* scale = T.s + n.b * T.s_sb + n.h * T.s_sh + n.blk * T.s_sn;
  bf16* zero = T.z + n.b * T.z_sb + n.h * T.z_sh + n.blk * T.z_sn;
  float mn[8], mx[8], tmn[PASSES], tmx[PASSES];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mn[e] = INFINITY;
    mx[e] = -INFINITY;
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    tmn[p] = INFINITY;
    tmx[p] = -INFINITY;
  }
#pragma unroll
  for (int s = 0; s < KQ_BATCH; ++s) {
    const int pass = s / REPS, j = rs + pass * P, c = lc + (s % REPS) * L;
    if (row_ok<CH>(T, n, j) && c < n.cw) {
      float f[8];
      bf16x8_to_float(*reinterpret_cast<const uint4*>(tile + j * W + c * 8), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (CH) {
          mn[e] = fminf(mn[e], f[e]);
          mx[e] = fmaxf(mx[e], f[e]);
        } else {
          tmn[pass] = fminf(tmn[pass], f[e]);
          tmx[pass] = fmaxf(tmx[pass], f[e]);
        }
      }
    }
  }
  if (!CH) {  // a token's L lanes are neighbours in one warp: every row at once
    for (int o = 1; o < L; o <<= 1) {
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        tmn[p] = fminf(tmn[p], __shfl_xor_sync(0xffffffffu, tmn[p], o));
        tmx[p] = fmaxf(tmx[p], __shfl_xor_sync(0xffffffffu, tmx[p], o));
      }
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {  // the rows' lanes commit them side by side
      const int j = rs + p * P;
      if ((p & (L - 1)) == lc && row_ok<CH>(T, n, j)) {
        commit_params(tmn[p], tmx[p], qmax, s_sm + j, z_sm + j);
        const int tok = token_of<CH>(T, n, j, npr);
        scale[tok] = __float2bfloat16_rn(s_sm[j]);
        zero[tok] = __float2bfloat16_rn(z_sm[j]);
      }
    }
  } else {  // the lanes of one chunk within the warp, then across the warps
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      for (int o = L; o < 32; o <<= 1) {
        mn[e] = fminf(mn[e], __shfl_xor_sync(0xffffffffu, mn[e], o));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], o));
      }
    }
    if (lane < L) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        part[warp * KQ_SLICE * 8 + lane * 8 + e] = mn[e];
        part[(KQ_WARPS + warp) * KQ_SLICE * 8 + lane * 8 + e] = mx[e];
      }
    }
    __syncthreads();
    for (int c = tid; c < W; c += KQ_THREADS) {
      float cmn = part[c], cmx = part[KQ_WARPS * KQ_SLICE * 8 + c];
#pragma unroll
      for (int w = 1; w < KQ_WARPS; ++w) {
        cmn = fminf(cmn, part[w * KQ_SLICE * 8 + c]);
        cmx = fmaxf(cmx, part[(KQ_WARPS + w) * KQ_SLICE * 8 + c]);
      }
      commit_params(cmn, cmx, qmax, s_sm + c, z_sm + c);
      scale[n.c0 * 8 + c] = __float2bfloat16_rn(s_sm[c]);
      zero[n.c0 * 8 + c] = __float2bfloat16_rn(z_sm[c]);
    }
  }
  __syncthreads();
}

// A unit's copies or its statistics, at its granularity and its lanes' reps.
template <bool STAGE>
__device__ __forceinline__ void load_or_stage(bool ch, const KqArgs& a, const Unit& n, int npr,
                                              int qmax, bf16* tile, float* part, float* s_sm,
                                              float* z_sm) {
  if (ch) {
    if (STAGE) stage_unit<true, 1>(a, n, npr, qmax, tile, part, s_sm, z_sm);
    else load_unit<true, 1>(a, n, npr, tile);
    return;
  }
  switch (a.t[n.t].reps) {
    case 1:
      if (STAGE) stage_unit<false, 1>(a, n, npr, qmax, tile, part, s_sm, z_sm);
      else load_unit<false, 1>(a, n, npr, tile);
      break;
    case 2:
      if (STAGE) stage_unit<false, 2>(a, n, npr, qmax, tile, part, s_sm, z_sm);
      else load_unit<false, 2>(a, n, npr, tile);
      break;
    default:
      if (STAGE) stage_unit<false, 3>(a, n, npr, qmax, tile, part, s_sm, z_sm);
      else load_unit<false, 3>(a, n, npr, tile);
  }
}

// Strided pack from shared memory: word (i, c) collects plane k from token
// k * npr + i; a thread takes four channels of one word row.  The code is
// clip(rint(q)) with q the IEEE quotient: a zero numerator gives 0 without
// a division (its range check would send the warp down the slow path), the
// clip comes first (it commutes with rint at the integer bounds) and rint
// is the float add of 1.5 * 2^23, whose low bits the word takes.
template <int BITS, bool CH>
__device__ __forceinline__ void pack_unit(const KqArgs& a, const Unit& n, int npr,
                                          const bf16* tile, const float* s_sm,
                                          const float* z_sm) {
  constexpr int CPW = 32 / BITS;
  constexpr float QMAX = (float)((1 << BITS) - 1);
  constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23: its float bits + an integer <= 2^22
  constexpr uint32_t MAGIC_BITS = 0x4B400000u;
  uint32_t planes = 0u;  // sum over k of 2^(BITS k)
#pragma unroll
  for (int k = 0; k < CPW; ++k) planes += 1u << (BITS * k);
  const uint32_t bias = MAGIC_BITS * planes;
  const KqTensor& T = a.t[n.t];
  const int W = n.cw * 8, G = W / 4;
  int32_t* words = T.w + n.b * T.w_sb + n.h * T.w_sh + n.blk * T.w_sn + n.c0 * 8;
  for (int it = threadIdx.x; it < n.nr * G; it += KQ_THREADS) {
    const int ii = it / G, c = (it - ii * G) * 4;
    float cs[4], cz[4];
    if (CH) {
      *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(s_sm + c);
      *reinterpret_cast<float4*>(cz) = *reinterpret_cast<const float4*>(z_sm + c);
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int j = CH ? k * npr + ii : (k << T.lg_width) + ii;
      const uint2 v = *reinterpret_cast<const uint2*>(tile + j * W + c);
      const float f[4] = {__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                          __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sc = CH ? cs[e] : s_sm[j], zc = CH ? cz[e] : z_sm[j];
        const float num = __fsub_rn(f[e], zc);
        const bool nil = num == 0.0f;
        float q = __fdiv_rn(nil ? sc : num, sc);
        q = fminf(fmaxf(nil ? 0.0f : q, 0.0f), QMAX);
        w[e] += __float_as_uint(__fadd_rn(q, MAGIC)) << (BITS * k);
      }
    }
    *reinterpret_cast<int4*>(words + (long long)(n.i0 + ii) * T.w_si + c) =
        make_int4((int)(w[0] - bias), (int)(w[1] - bias), (int)(w[2] - bias),
                  (int)(w[3] - bias));
  }
}

// One CTA a unit: its copies, their statistics, its pack.
template <int BITS, bool KCH>
__global__ void __launch_bounds__(KQ_THREADS, KQ_MIN_CTAS)
    kv_quant_kernel(const __grid_constant__ KqArgs a) {
  __shared__ __align__(16) bf16 tile[KQ_TILE];
  __shared__ float part[2 * KQ_WARPS * KQ_SLICE * 8];
  __shared__ __align__(16) float s_sm[KQ_MAX_BLOCK];
  __shared__ __align__(16) float z_sm[KQ_MAX_BLOCK];
  constexpr int CPW = 32 / BITS, QMAX = (1 << BITS) - 1;
  const int npr = a.block_n / CPW;
  const Unit n = unit_of(a, blockIdx.x, npr, CPW);
  const bool ch = KCH && a.t[n.t].channel;
  load_or_stage<false>(ch, a, n, npr, QMAX, tile, part, s_sm, z_sm);
  cp_async_commit();
  cp_async_wait<0>();
  load_or_stage<true>(ch, a, n, npr, QMAX, tile, part, s_sm, z_sm);
  if (ch) {
    pack_unit<BITS, true>(a, n, npr, tile, s_sm, z_sm);
  } else {
    pack_unit<BITS, false>(a, n, npr, tile, s_sm, z_sm);
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

int log2_of(int p) {  // p a power of two
  int l = 0;
  while ((1 << l) < p) ++l;
  return l;
}

// A tensor's parts: channel slices of at most KQ_SLICE chunks whose
// [block_n, slice] tile fits KQ_TILE, or groups of a power of two of word
// rows whose tokens fit it at every lane's KQ_BATCH loads.  False for a
// shape the kernel refuses.
bool setup_tensor(KqTensor& T, int d, int channel, int B, int H, int nb, int block_n,
                  int npr, int cpw) {
  if (d < 8 || d > KQ_MAX_D || d % 8) return false;
  T.chunks = d / 8;
  T.channel = channel;
  if (channel) {
    int cap = KQ_THREADS * KQ_BATCH / block_n;  // lanes a row, at most
    cap = cap < KQ_SLICE ? cap : KQ_SLICE;
    int lanes = 1;
    while (lanes * 2 <= cap) lanes <<= 1;
    T.parts = (T.chunks + lanes - 1) / lanes;
    T.width = (T.chunks + T.parts - 1) / T.parts;
    T.lg_lanes = log2_of(pow2_at_least(T.width));
    T.reps = 1;
    T.lg_width = 0;
  } else {
    const int lanes = pow2_at_least(T.chunks < 32 ? T.chunks : 32);
    T.lg_lanes = log2_of(lanes);
    T.reps = (T.chunks + lanes - 1) / lanes;
    const int rows = KQ_THREADS / lanes * (KQ_BATCH / T.reps);
    int width = 1;
    while (width * 2 * cpw <= rows && width * 2 <= npr) width <<= 1;
    if (width * cpw > rows) return false;
    T.width = width;
    T.lg_width = log2_of(width);
    T.parts = (npr + width - 1) / width;
  }
  T.units = B * H * nb * T.parts;
  return true;
}

template <int BITS, bool KCH>
cudaError_t kv_quant_run(const KqArgs& a, cudaStream_t stream) {
  kv_quant_kernel<BITS, KCH><<<a.units, KQ_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool KCH>
cudaError_t kv_quant_dispatch(int bits, const KqArgs& a, cudaStream_t stream) {
  switch (bits) {
    case 2: return kv_quant_run<2, KCH>(a, stream);
    case 4: return kv_quant_run<4, KCH>(a, stream);
    case 8: return kv_quant_run<8, KCH>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch quantizes and packs K (tensor 0, params per channel when
// k_channel) and, with n_t == 2, V (tensor 1, params per token), both
// [B, H, nb * block_n, d_t] views, into the word / scale / zero views of
// each.  `strides` holds 13 element strides a tensor: the input's batch, head
// and token strides, the words' batch, head, block and word-row strides, and
// the batch, head and block strides of the scales and of the zeros; every
// last axis has unit stride.
extern "C" int kv_quant_launch(const void* xk, const void* xv, void* kw, void* ks, void* kz,
                               void* vw, void* vs, void* vz, const long long* strides,
                               int B, int H, int nb, int block_n, int dk, int dv, int bits,
                               int k_channel, int n_t, void* stream) {
  if (bits != 2 && bits != 4 && bits != 8) return (int)cudaErrorInvalidValue;
  const int cpw = 32 / bits;
  if (block_n < cpw || block_n > KQ_MAX_BLOCK || block_n % cpw || n_t < 1 || n_t > 2)
    return (int)cudaErrorInvalidValue;
  if (nb == 0 || B * H == 0) return 0;
  const int npr = block_n / cpw;
  KqArgs a = {};
  const void* xs[2] = {xk, xv};
  void* ws[2] = {kw, vw};
  void* ss[2] = {ks, vs};
  void* zs[2] = {kz, vz};
  const int ds[2] = {dk, dv};
  for (int t = 0; t < n_t; ++t) {
    KqTensor& T = a.t[t];
    const long long* st = strides + 13 * t;
    T.x = (const bf16*)xs[t];
    T.x_sb = st[0];
    T.x_sh = st[1];
    T.x_st = st[2];
    T.w = (int32_t*)ws[t];
    T.w_sb = st[3];
    T.w_sh = st[4];
    T.w_sn = st[5];
    T.w_si = st[6];
    T.s = (bf16*)ss[t];
    T.s_sb = st[7];
    T.s_sh = st[8];
    T.s_sn = st[9];
    T.z = (bf16*)zs[t];
    T.z_sb = st[10];
    T.z_sh = st[11];
    T.z_sn = st[12];
    if (!setup_tensor(T, ds[t], t == 0 && k_channel, B, H, nb, block_n, npr, cpw))
      return (int)cudaErrorInvalidValue;
  }
  a.H = H;
  a.nb = nb;
  a.block_n = block_n;
  a.units = a.t[0].units + (n_t == 2 ? a.t[1].units : 0);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(k_channel ? kv_quant_dispatch<true>(bits, a, st)
                         : kv_quant_dispatch<false>(bits, a, st));
}
