// Residual flush and the fused decode append, dense and paged (the paper's
// Residual Kernel, decode face): one body with two modes.
//
//   flush   quantize + pack the full bf16 residual of every row with
//           full[b] != 0 into packed block min(dest[b], nb - 1) of the dense
//           cache, or pool page min(dest[b], P - 1) of the paged one.
//   append  a layer's whole cache update in a decode step: write the new
//           token into residual row min(res_len[b], block_n - 1) (rows with
//           mask true), flush the rows it fills (full = res_len + step ==
//           block_n) into block min(pack_blocks[b], nb - 1) or page
//           page_table[b, clamp(pack_blocks[b], 0, nb_max - 1)], and update
//           pack_blocks += full, res_len = full ? 0 : res_len + step.
//           A paged pool may hold one page range of a larger pool (a rank's
//           share of page-affine pools): a flush into a page outside it
//           writes no page, the residual and the lengths being written all
//           the same.
//
// Replaces: src/repro/kernels/residual_flush/kernel.py `residual_flush_pallas`
//           (dense) and `paged_residual_flush_pallas` (paged), and the torch
//           ops around them in the decode append (JAX's jitted
//           `append_decode` / `paged_append_decode`).
// Bound on the H100: bytes when a row flushes (two bf16 tiles in, packed words
// and params out), launch latency on the other block_n - 1 steps.
// Design:
//  * One CTA per (b, h, tensor K or V, group of word rows), the groups as
//    many as keep the whole grid resident (flush_launch): at llama3-8b's
//    shape (B 4, H 8, 4-bit, block_n 128, 16 word rows) 4 groups give 256
//    CTAs, at gemma-7b's (H 16, d 256) 2 give 256.  A CTA stages the tokens
//    its words need in shared memory with 16-byte loads, eight in flight a
//    thread: the whole tile for channel-wise K (its statistics run along
//    the tokens), only its own tokens per token.  The statistics come out
//    of the staging: each thread keeps the min / max of its 8 channels,
//    combined by shuffles and one shared-memory pass (per channel), or by
//    shuffles within the lanes of one token (per token: a power of two of
//    lanes a token, those past its d / 8 chunks idle and holding the
//    min / max identities, so zamba2's d 112 takes 16 lanes for its 14
//    chunks).  Then every thread packs words from shared memory.
//  * Bitwise contract with the plain version (core/quantizer.py), as K1's
//    (kv_quant.cu; the params from common.cuh's commit_params): scale =
//    bf16(max(__fdiv_rn(max - min, qmax), 1e-6)), zero = bf16(min), q =
//    clip(rintf(__fdiv_rn(x - zero, scale)), 0, qmax) with the params rounded
//    to bf16 first; no reciprocal, no fast math.  A flushed block equals the
//    block K1 packs from the same tokens.
//  * Append, the new token: every CTA loads its chunk of it before the
//    lengths are known; the CTA of group 0 writes it into the residual, and
//    every CTA that flushes stages it from that chunk, never from the residual
//    row being written.
//  * Append, the lengths: thread 0 of every CTA reads res_len / pack_blocks
//    and arrives on the row's counter (arrive[b], zero between launches)
//    with a release-ordered atomic whose result it waits for only at its
//    end; the last of the row's H * 2 * groups CTAs to arrive writes the new
//    lengths and resets the counter.  So no CTA reads a length another has
//    written, the update is one launch, and nothing is read on the host.
//  * A row that does not flush does no more than its token write; a frozen
//    row (mask false) writes nothing, its lengths are rewritten unchanged.
//  * The paged destinations of one launch are pairwise distinct (callers
//    point rows that do not flush at their own scratch page), so no two CTAs
//    write one page; the page is read while the tile comes in.
//  * shared_kv (the MLA latent cache, the JAX kernels' `shared_kv`): the
//    grid's tensor axis holds K alone, and a row's counter counts
//    H * groups arrivals.  Per-channel K takes any head dim that is a
//    multiple of 8 up to 576 (the latents 160 and 576): the channel
//    statistics reduce one shared-memory slot a chunk row of the staging
//    pass, whatever the lanes of a chunk; the 128 x 576 bf16 tile (147 KB)
//    fits the opt-in shared memory.  Per-token statistics take any multiple
//    of 8 up to 256 (d / 8 chunks on at most 32 lanes of one warp).
#include "common.cuh"

namespace {

constexpr int FL_THREADS = 256;
constexpr int FL_GROUPS = 4;  // word-row groups a (b, h, tensor), at most (flush_launch)
constexpr int FL_BATCH = 8;   // 16-byte loads a thread has in flight

struct FlushArgs {
  int32_t* w[2];      // packed words, K and V
  bf16* s[2];         // scales
  bf16* z[2];         // zeros
  bf16* res[2];       // residual [B, H, block_n, d]
  const bf16* nw[2];  // append: the new tokens [B, H, 1, d], strides below
  long long n_sb[2], n_sh[2];
  const uint8_t* mask;  // append: [B] bool, null = every row
  const int32_t* full;  // flush: [B]
  const int32_t* dest;  // flush: [B]
  const int32_t* table; // paged append: [B, nb_max], row stride table_ld
  int32_t* pack_blocks; // append
  int32_t* res_len;     // append
  int32_t* arrive;      // append: [B] counter, zero between launches
  int H, n_cells, block_n, d[2], k_channel, groups, nb_max, table_ld, paged;
  int tensors;  // 2: K and V; 1: K alone (shared_kv)
  // paged append: the page range this pool holds, pages [page_lo, page_lo +
  // n_cells) of a pool of pages_total (one rank's share of page-affine
  // pools); a flush whose page lies outside it writes no page.  The whole
  // pool: page_lo 0, pages_total n_cells.
  int page_lo, pages_total;
};

// Chunk rows whose channel partials the statistics combine in shared memory
// (the `part` slots): one a chunk row of the staging pass.
__host__ __device__ inline int part_slots(int d) { return FL_THREADS / (d >> 3); }

// arrive on a row's counter: release-ordered after this thread's reads of
// the lengths; the count before it is only waited for where it is used
__device__ __forceinline__ int arrive_release(int32_t* counter) {
  int old;
  asm volatile("atom.release.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

template <int BITS, bool APPEND>
__global__ void __launch_bounds__(FL_THREADS) residual_flush_kernel(const FlushArgs a) {
  extern __shared__ __align__(16) unsigned char fl_smem[];
  __shared__ int s_full, s_cell, s_at, s_step;
  constexpr int CPW = 32 / BITS;  // codes a word
  constexpr int QMAX = (1 << BITS) - 1;
  const int tid = threadIdx.x;
  int idx = blockIdx.x;
  const int grp = idx % a.groups;
  idx /= a.groups;
  const int t = idx % a.tensors;  // 0: K, 1: V
  const int bh = idx / a.tensors, b = bh / a.H, h = bh - b * a.H;
  const int block_n = a.block_n, d = t ? a.d[1] : a.d[0];
  const int npr = block_n / CPW;
  const bool channel = t == 0 && a.k_channel;
  // a thread's 8-channel chunk of a token row (the same in every pass): a
  // row takes L lanes, its C chunks' and, per token, up to the next power of
  // two, so that shuffles reduce within a row's lanes; the threads past the
  // last whole chunk row, and a row's lanes past C, stage nothing
  const int C = d >> 3;
  int L = C;
  if (!channel)
    while (L & (L - 1)) L += L & -L;  // C rounded up to a power of two
  const int ch = tid % L, per_pass = FL_THREADS / L;
  const bool stager = ch < C && tid < per_pass * L;

  // append: the new token's chunk, loaded before the lengths are known
  uint4 nv = make_uint4(0u, 0u, 0u, 0u);
  if (APPEND && ch < C) {
    const bf16* nw = (t ? a.nw[1] + b * a.n_sb[1] + h * a.n_sh[1]
                        : a.nw[0] + b * a.n_sb[0] + h * a.n_sh[0]) + ch * 8;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = (uint32_t)__bfloat16_as_ushort(nw[2 * e]) |
             ((uint32_t)__bfloat16_as_ushort(nw[2 * e + 1]) << 16);
    }
    nv = make_uint4(v[0], v[1], v[2], v[3]);
  }

  // thread 0 reads the lengths (append) or full / dest (flush); in append
  // mode it arrives on the row's counter at once, and the last of the row's
  // H * tensors * groups CTAs to arrive writes the new lengths when it is done
  int old = 0, pb0 = 0, rl1 = 0;
  if (tid == 0) {
    int full, cell = 0, at = 0, step = 0;
    if (APPEND) {
      const int rl0 = a.res_len[b];
      pb0 = a.pack_blocks[b];
      step = a.mask ? (a.mask[b] != 0) : 1;
      rl1 = rl0 + step;
      full = rl1 == block_n;
      at = min(rl0, block_n - 1);
      old = arrive_release(a.arrive + b);
      if (!a.paged) cell = bh * a.n_cells + min(max(pb0, 0), a.n_cells - 1);
    } else {
      full = a.full[b] != 0;
      const int dst = min(max(a.dest[b], 0), a.n_cells - 1);
      cell = a.paged ? dst * a.H + h : bh * a.n_cells + dst;
    }
    s_full = full;
    s_cell = cell;
    s_at = at;
    s_step = step;
  }
  __syncthreads();
  const bool full = s_full != 0;
  const int at = s_at, step = s_step;
  auto finish = [&]() {
    if (APPEND && tid == 0 && old == a.H * a.tensors * a.groups - 1) {
      __threadfence();  // the other CTAs' reads of the lengths came first
      a.pack_blocks[b] = pb0 + full;
      a.res_len[b] = full ? 0 : rl1;
      a.arrive[b] = 0;
    }
  };
  bf16* res = (t ? a.res[1] : a.res[0]) + (long long)bh * block_n * d;
  if (APPEND && step && grp == 0 && tid < C) {  // the new token into its residual row
    *reinterpret_cast<uint4*>(res + (long long)at * d + tid * 8) = nv;
  }
  // this CTA's word rows [i0, i1), and the tokens their words hold
  const int per = (npr + a.groups - 1) / a.groups;
  const int i0 = grp * per, i1 = min(npr, i0 + per), nr = i1 - i0;
  if (!full || nr <= 0) {
    finish();
    return;
  }
  // paged append: the destination page, read while the tile comes in
  int page = 0;
  if (APPEND && a.paged && tid == 0) {
    page = a.table[(long long)b * a.table_ld + min(max(pb0, 0), a.nb_max - 1)];
  }
  const int rows = channel ? block_n : CPW * nr;

  const int slots = part_slots(d);
  bf16* tile = reinterpret_cast<bf16*>(fl_smem);  // [rows, d]
  float* part = reinterpret_cast<float*>(tile + (size_t)block_n * d);  // [2, slots, d]
  float* s_sm = part + 2 * slots * d;  // [d] or [rows]
  float* z_sm = s_sm + max(d, block_n);

  // staging: chunk `ch` of local rows j, j + per_pass, ...; a thread issues
  // up to FL_BATCH 16-byte loads before it uses one
  auto token_of = [&](int j) { return channel ? j : (j / nr) * npr + i0 + j % nr; };
  float mn[8], mx[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mn[e] = INFINITY;
    mx[e] = -INFINITY;
  }
  for (int j0 = 0; j0 < rows; j0 += FL_BATCH * per_pass) {  // the same trips in every lane
    uint4 u[FL_BATCH];
#pragma unroll
    for (int p = 0; p < FL_BATCH; ++p) {
      const int j = j0 + p * per_pass + tid / L, tok = token_of(j);
      if (j >= rows || !stager) continue;
      u[p] = APPEND && step && tok == at  // the new token, not its residual row
                 ? nv
                 : *reinterpret_cast<const uint4*>(res + (long long)tok * d + ch * 8);
    }
#pragma unroll
    for (int p = 0; p < FL_BATCH; ++p) {
      const int j = j0 + p * per_pass + tid / L;
      float tmn = INFINITY, tmx = -INFINITY;
      if (j < rows && stager) {
        float f[8];
        *reinterpret_cast<uint4*>(tile + (size_t)j * d + ch * 8) = u[p];
        bf16x8_to_float(u[p], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          mn[e] = fminf(mn[e], f[e]);
          mx[e] = fmaxf(mx[e], f[e]);
          tmn = fminf(tmn, f[e]);
          tmx = fmaxf(tmx, f[e]);
        }
      }
      if (!channel) {  // one token's L lanes are neighbours in one warp
        for (int o = 1; o < L; o <<= 1) {
          tmn = fminf(tmn, __shfl_xor_sync(0xffffffffu, tmn, o));
          tmx = fmaxf(tmx, __shfl_xor_sync(0xffffffffu, tmx, o));
        }
        if (ch == 0 && j < rows) commit_params(tmn, tmx, QMAX, s_sm + j, z_sm + j);
      }
    }
  }
  if (APPEND && a.paged && tid == 0) {  // rebased into the range, -1 outside it
    const int local = min(max(page, 0), a.pages_total - 1) - a.page_lo;
    s_cell = local >= 0 && local < a.n_cells ? local * a.H + h : -1;
  }
  if (channel) {  // each chunk row's partials into its slot, then across the slots
    const int slot = tid / L;
    if (stager) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        part[slot * d + ch * 8 + e] = mn[e];
        part[(slots + slot) * d + ch * 8 + e] = mx[e];
      }
    }
    __syncthreads();
    for (int c = tid; c < d; c += FL_THREADS) {
      float cmn = part[c], cmx = part[slots * d + c];
      for (int w = 1; w < slots; ++w) {
        cmn = fminf(cmn, part[w * d + c]);
        cmx = fmaxf(cmx, part[(slots + w) * d + c]);
      }
      commit_params(cmn, cmx, QMAX, s_sm + c, z_sm + c);
    }
  }
  __syncthreads();

  // the params (every group has the channel ones; group 0 stores them)
  const long long cell = s_cell;
  if (cell < 0) {  // paged append: the page is another rank's
    finish();
    return;
  }
  const int kp = channel ? d : block_n;  // params a block
  bf16* scale = (t ? a.s[1] : a.s[0]) + cell * kp;
  bf16* zero = (t ? a.z[1] : a.z[0]) + cell * kp;
  for (int i = tid; i < (channel ? (grp == 0 ? d : 0) : rows); i += FL_THREADS) {
    const int at_ = channel ? i : token_of(i);
    scale[at_] = __float2bfloat16_rn(s_sm[i]);
    zero[at_] = __float2bfloat16_rn(z_sm[i]);
  }
  // strided pack: word (i, c) collects plane k from token k * npr + i
  int32_t* words = (t ? a.w[1] : a.w[0]) + cell * npr * d;
  for (int wi = tid; wi < nr * d; wi += FL_THREADS) {
    const int ii = wi / d, c = wi - ii * d, i = i0 + ii;
    uint32_t w = 0u;
#pragma unroll
    for (int k = 0; k < CPW; ++k) {
      const int j = channel ? k * npr + i : k * nr + ii;
      const int p = channel ? c : j;
      const float x = bf2f(tile[(size_t)j * d + c]);
      float q = rintf(__fdiv_rn(__fsub_rn(x, z_sm[p]), s_sm[p]));
      q = fminf(fmaxf(q, 0.0f), (float)QMAX);
      w |= static_cast<uint32_t>(q) << (BITS * k);
    }
    words[(long long)i * d + c] = static_cast<int32_t>(w);
  }
  finish();
}

size_t flush_smem_bytes(int block_n, int dmax) {
  return (size_t)block_n * dmax * sizeof(bf16) +
         2 * (size_t)part_slots(dmax) * dmax * sizeof(float) +
         2 * (size_t)(dmax > block_n ? dmax : block_n) * sizeof(float);
}

// Groups a (b, h, tensor): as many as keep every CTA of the launch resident
// at once (the occupancy at this shared memory, times the SMs), at most
// FL_GROUPS and the block's word rows.  Fixed for a cache's shape, so the
// launch shape is too.
template <int BITS, bool APPEND>
cudaError_t flush_launch(FlushArgs a, int units, int npr, size_t smem, cudaStream_t stream) {
  static size_t allowed = 48 * 1024, occ_smem = 0;
  static int occ = 0, sms = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        residual_flush_kernel<BITS, APPEND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (smem != occ_smem) {
    int dev = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, residual_flush_kernel<BITS, APPEND>, FL_THREADS, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    occ_smem = smem;
  }
  const int cap = npr < FL_GROUPS ? npr : FL_GROUPS, fit = occ * sms / units;
  a.groups = fit < 1 ? 1 : fit < cap ? fit : cap;
  residual_flush_kernel<BITS, APPEND><<<units * a.groups, FL_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool APPEND>
cudaError_t flush_dispatch(int bits, const FlushArgs& a, int units, int npr, size_t smem,
                           cudaStream_t stream) {
  switch (bits) {
    case 2: return flush_launch<2, APPEND>(a, units, npr, smem, stream);
    case 4: return flush_launch<4, APPEND>(a, units, npr, smem, stream);
    case 8: return flush_launch<8, APPEND>(a, units, npr, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// 8-channel chunks: up to a warp of them per token, per-channel K any
// multiple of 8 up to 576
bool flush_head_dim_ok(int d, bool channel) {
  return d >= 8 && d % 8 == 0 && d <= (channel ? 576 : 256);
}

}  // namespace

// One entry point for both caches and both modes.  Dense: the packed arrays
// are [B, H, n_cells = nb, ...]; paged: [n_cells = P, H, ...].  Append mode
// reads k_new / v_new (last dim contiguous), mask (may be null), the table
// (paged), and updates pack_blocks / res_len through the arrival counter;
// flush mode reads full / dest.
extern "C" int residual_flush_launch(
    void* kw, void* ks, void* kz, void* vw, void* vs, void* vz, void* k_res, void* v_res,
    const void* k_new, const void* v_new, const void* mask, const void* full,
    const void* dest, const void* table, void* pack_blocks, void* res_len, void* arrive,
    long long k_sb, long long k_sh, long long v_sb, long long v_sh, int B, int H, int n_cells,
    int block_n, int dk, int dv, int bits, int k_channel, int nb_max, int table_ld, int append,
    int paged, int shared_kv, int page_lo, int pages_total, void* stream) {
  if (B * H == 0) return 0;
  if (page_lo < 0 || page_lo + n_cells > pages_total) return (int)cudaErrorInvalidValue;
  if (!flush_head_dim_ok(dk, k_channel) || (!shared_kv && !flush_head_dim_ok(dv, false)) ||
      (block_n * bits) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  FlushArgs a = {};
  a.w[0] = (int32_t*)kw;
  a.w[1] = (int32_t*)vw;
  a.s[0] = (bf16*)ks;
  a.s[1] = (bf16*)vs;
  a.z[0] = (bf16*)kz;
  a.z[1] = (bf16*)vz;
  a.res[0] = (bf16*)k_res;
  a.res[1] = (bf16*)v_res;
  a.nw[0] = (const bf16*)k_new;
  a.nw[1] = (const bf16*)v_new;
  a.n_sb[0] = k_sb;
  a.n_sh[0] = k_sh;
  a.n_sb[1] = v_sb;
  a.n_sh[1] = v_sh;
  a.mask = (const uint8_t*)mask;
  a.full = (const int32_t*)full;
  a.dest = (const int32_t*)dest;
  a.table = (const int32_t*)table;
  a.pack_blocks = (int32_t*)pack_blocks;
  a.res_len = (int32_t*)res_len;
  a.arrive = (int32_t*)arrive;
  a.H = H;
  a.n_cells = n_cells;
  a.block_n = block_n;
  a.d[0] = dk;
  a.d[1] = dv;
  a.k_channel = k_channel;
  a.nb_max = nb_max;
  a.table_ld = table_ld;
  a.paged = paged;
  a.tensors = shared_kv ? 1 : 2;
  a.page_lo = page_lo;
  a.pages_total = pages_total;
  const int units = B * H * a.tensors, npr = block_n * bits / 32;
  const int dmax = shared_kv || dk > dv ? dk : dv;
  const size_t smem = flush_smem_bytes(block_n, dmax);
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(append ? flush_dispatch<true>(bits, a, units, npr, smem, st)
                      : flush_dispatch<false>(bits, a, units, npr, smem, st));
}
