"""Entry point of the fused low-bit decode attention: the split-KV CUDA kernel
(``csrc/bitdecode.cu``) and, with more than one split, its merge kernel, or
the plain PyTorch version (``ref.py``).

A call on the card is at most two launches: the kernel writes the result
when it runs as one split, else per-split partials that
``bitdecode_merge`` combines by logsumexp.  The kernel cuts each row's
packed blocks and residual into units (:func:`work_units`) and spreads them
over ``num_splits`` CTAs of :data:`WARPS` warps; ``num_splits="auto"``
sizes the splits from the cache's capacity and the CTAs the card holds at
once (:func:`auto_num_splits`).
The split count depends on the shapes alone, never on the lengths, so a
row's result depends only on its own data and the launch shape.

The grid's third axis holds a row's query-row tiles (16 rows where g > 8)
and, in the ``shared_kv`` mode (the MLA latent cache: V is the first
``d_v`` channels of K), its V chunks of :data:`LATENT_DV` channels
(:func:`grid_tiles`).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ref as _ref

_MAX_SPLITS = 64
WARPS = 4              # warps a CTA (BD_WARPS in csrc/bitdecode_body.cuh)
RES_TOKENS = 8         # bf16 tokens a residual unit (BD_RES_TOKENS)
UNITS_PER_WARP = 2     # "auto": the units a warp takes from a full row
WAVES = 2              # "auto": at most this many waves of resident CTAs
HEAD_DIMS = (32, 64, 112, 128, 256)
BLOCK_NS = (32, 64, 128)
MAX_G = 16
# head dims whose instances take one 8-row query tile only (g <= 8): zamba2's
# 112 (g = 1), the half-full last 32-channel group of PV
ONE_TILE_DIMS = (112,)
# shared_kv instances: the MLA latent widths (smoke config, full width), V
# chunks of LATENT_DV channels a CTA, K's params per channel, W = 4, g up to
# LATENT_MAX_G (deepseek-v3's 128 query heads on one latent head)
LATENT_DIMS = (160, 576)
LATENT_DV = 128
LATENT_MAX_G = 128


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (1 on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def unit_rows(block_n: int, bits: int) -> int:
    """Word rows of a packed unit (bd_unit_rows in the kernel)."""
    return min(block_n * bits // 32, 4)


def work_units(nb: int, block_n: int, bits: int, res_n: int) -> int:
    """The most units a row can hold: every packed block's and a full
    residual's."""
    return nb * (block_n * bits // 32 // unit_rows(block_n, bits)) + -(-res_n // RES_TOKENS)


def grid_tiles(g: int, d_v: int, shared_kv: bool) -> int:
    """CTAs a (row, split) takes: query-row tiles (8 rows for g <= 8, else
    16) times V chunks (``d_v / LATENT_DV`` when shared_kv)."""
    rows = 16 if g > 8 else 8
    return -(-g // rows) * (d_v // LATENT_DV if shared_kv else 1)


def auto_num_splits(b: int, h_kv: int, units: int, *, ctas: int, tiles: int = 1) -> int:
    """Splits that give each warp of a full row about UNITS_PER_WARP of its
    ``units``, within WAVES waves of the card's ``ctas`` resident CTAs, a
    (row, split) taking ``tiles`` CTAs (:func:`grid_tiles`).  A CTA whose
    share of a shorter row is empty writes its empty partial and leaves at
    once, so rows of unequal length balance over the card."""
    want = -(-units // (WARPS * UNITS_PER_WARP))
    return max(1, min(want, WAVES * ctas // (b * h_kv * tiles), _MAX_SPLITS))


def check_kernel_shapes(*, g: int, d_k: int, d_v: int, block_n: int, bits: int, npr: int,
                        res_n: int, shared_kv: bool = False, k_gran: str = "channel") -> None:
    """Raise ValueError for what the kernel has no instance for."""
    if npr * 32 != block_n * bits:
        raise ValueError(f"{npr} packed word rows do not match bits={bits}, block_n={block_n}")
    if bits not in (2, 4, 8) or block_n not in BLOCK_NS:
        raise ValueError(f"the CUDA decode kernel takes bits 2, 4 or 8 and block_n in "
                         f"{BLOCK_NS}, got bits={bits}, block_n={block_n}")
    if shared_kv:
        if (d_k not in LATENT_DIMS or d_v % LATENT_DV or not 0 < d_v <= d_k
                or k_gran != "channel" or unit_rows(block_n, bits) != 4):
            raise ValueError(f"the CUDA decode kernel's shared_kv mode takes per-channel K "
                             f"of width {LATENT_DIMS}, d_v a multiple of {LATENT_DV} up to "
                             f"d_k and 4-row units, got d_k={d_k}, d_v={d_v}, {k_gran}, "
                             f"bits={bits}, block_n={block_n}")
    elif d_k not in HEAD_DIMS or d_v != d_k:
        raise ValueError(f"the CUDA decode kernel takes d_k = d_v in {HEAD_DIMS}, got "
                         f"d_k={d_k}, d_v={d_v}")
    max_g = LATENT_MAX_G if shared_kv else 8 if d_k in ONE_TILE_DIMS else MAX_G
    if not 1 <= g <= max_g:
        raise ValueError(f"the CUDA decode kernel takes 1 to {max_g} query rows per KV head"
                         f"{' (shared_kv)' if shared_kv else ''}, got g={g}")
    if res_n % RES_TOKENS:
        raise ValueError(f"the residual's length {res_n} is not a multiple of {RES_TOKENS}")


@functools.lru_cache(maxsize=None)
def ctas_per_sm(g: int, d: int, block_n: int, bits: int, k_channel: bool,
                shared_kv: bool = False) -> int:
    """CTAs of the kernel's instance that one SM holds at once."""
    n = _build.build().bitdecode_ctas_per_sm(g, d, block_n, bits, int(k_channel),
                                             int(shared_kv))
    if n <= 0:
        raise RuntimeError(f"bitdecode occupancy query failed (cudaError {-n})")
    return n


def resolve_num_splits(num_splits, b: int, h_kv: int, units: int, device, *, g: int = 1,
                       d: int = 128, block_n: int = 128, bits: int = 4,
                       k_channel: bool = True, shared_kv: bool = False,
                       d_v: int | None = None) -> int:
    """The kernel's split count: an explicit integer as given, ``"auto"``
    from the card's SMs, the instance's occupancy and the CTAs a (row,
    split) takes (1 off the card)."""
    if num_splits in (None, "auto"):
        if torch.device(device).type != "cuda":
            return 1
        ctas = sm_count(device) * ctas_per_sm(g, d, block_n, bits, k_channel, shared_kv)
        tiles = grid_tiles(g, d if d_v is None else d_v, shared_kv)
        return auto_num_splits(b, h_kv, units, ctas=ctas, tiles=tiles)
    s = int(num_splits)
    if s < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")
    return s


def kernel_operand(t, what: str):
    """``t`` as the kernel reads it: contiguous and 16-byte aligned."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"the CUDA decode kernel takes contiguous, 16-byte aligned {what}")
    return t


def draft_shift(bits: int, draft_bits: int | None) -> int:
    """The kernel's ``draft_shift``: the low bits of each code a draft read
    drops (0 for the normal read, ``draft_bits`` None or >= ``bits``)."""
    if draft_bits is None or draft_bits >= bits:
        return 0
    if draft_bits < 1:
        raise ValueError(f"draft_bits={draft_bits} outside [1, bits={bits}]")
    return bits - draft_bits


def launch_decode(name: str, q, arrays, ints, *, d_v: int, num_splits: int, sm_scale: float,
                  shift: int = 0, window=()):
    """Launch kernel ``name`` (its C entry point takes q, ``arrays`` (None a
    null pointer), out, lse, B, H, g, ``ints``, num_splits, the draft
    shift, the ``window`` ints, sm_scale, stream) and, with more than one
    split, the merge.  Returns (out [B, H, g, d_v] f32, lse [B, H, g] f32)."""
    b, h, g, _ = q.shape
    dev = q.device
    out = torch.empty((b, h, g, d_v), dtype=torch.float32, device=dev)
    lse = torch.empty((b, h, g), dtype=torch.float32, device=dev)
    if num_splits == 1:
        o_part, l_part = out, lse
    else:
        o_part = torch.empty((num_splits, b, h, g, d_v), dtype=torch.float32, device=dev)
        l_part = torch.empty((num_splits, b, h, g), dtype=torch.float32, device=dev)
    stream = _build.stream_of(q)
    _build.launch(name, q.data_ptr(), *(t if t is None else t.data_ptr() for t in arrays),
                  o_part.data_ptr(),
                  l_part.data_ptr(), b, h, g, *ints, num_splits, shift, *window, float(sm_scale),
                  stream)
    if num_splits > 1:
        merge_cuda(o_part, l_part, out, lse)
    return out, lse


def merge_cuda(o_parts, lse_parts, out=None, lse=None):
    """The merge kernel on CUDA partials o [S, ..., d_v], lse [S, ...] (f32):
    what ``ref.merge_partials`` computes, in one launch.  Each split's
    partials are contiguous; the splits may lie at any stride of the first
    axis (the ranks' chunks of one gathered buffer, ``dist.splitkv``)."""
    if not (o_parts[0].is_contiguous() and lse_parts[0].is_contiguous()):
        raise ValueError("the merge kernel takes each split's partials contiguous")
    if out is None:
        out = torch.empty(o_parts.shape[1:], dtype=torch.float32, device=o_parts.device)
        lse = torch.empty(lse_parts.shape[1:], dtype=torch.float32, device=o_parts.device)
    _build.launch("bitdecode_merge", o_parts.data_ptr(), lse_parts.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), o_parts.shape[0], lse_parts[0].numel(), o_parts.shape[-1],
                  o_parts.stride(0), lse_parts.stride(0), _build.stream_of(o_parts))
    return out, lse


def query_operand(q):
    """q as bf16, contiguous and 16-byte aligned (copied only if it is not)."""
    q = q.to(torch.bfloat16).contiguous()
    return q if q.data_ptr() % 16 == 0 else q.clone()


def cache_operands(tensors, what: str, shared_kv: bool):
    """The packed arrays and residuals (K's words, scale, zero, V's, K's
    residual, V's) as the kernel reads them; the V side None when
    ``shared_kv``."""
    kw, ks, kz, vw, vs, vz, k_res, v_res = tensors
    if shared_kv:
        vw = vs = vz = v_res = None
    if any(t is not None and t.dtype != torch.bfloat16 for t in (ks, vs, k_res, v_res)):
        raise ValueError("the CUDA decode kernel takes bf16 params and residuals")
    return [None if t is None else kernel_operand(t, what)
            for t in (kw, ks, kz, vw, vs, vz, k_res, v_res)]


def block_window(nb: int, block_lo: int, n_blocks: int | None, read_res: bool) -> tuple:
    """The kernel's window ints (block_lo, nb_win, read_res) over a block axis
    of ``nb``: blocks ``[block_lo, block_lo + n_blocks)`` cut at ``nb`` (the
    last rank's window of a split-KV walk may be short or empty)."""
    if block_lo < 0 or (n_blocks is not None and n_blocks < 0):
        raise ValueError(f"block window [{block_lo}, +{n_blocks}) is negative")
    lo = min(block_lo, nb)
    width = nb - lo if n_blocks is None else min(n_blocks, nb - lo)
    return lo, width, int(bool(read_res))


def bitdecode_cuda(q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, pack_blocks,
                   res_len, *, bits: int, block_n: int, sm_scale: float, k_gran: str,
                   num_splits, draft_bits: int | None = None, shared_kv: bool = False,
                   d_v: int | None = None, block_lo: int = 0, n_blocks: int | None = None,
                   read_res: bool = True):
    """The kernel (and merge) on CUDA tensors: (out, lse).  ``draft_bits``
    below ``bits`` reads every packed code at that width (the runtime
    shift of ``csrc/bitdecode_body.cuh``).  ``shared_kv`` reads V as the
    first ``d_v`` channels of K (the V-side arguments are ignored).  The
    window (``block_lo``, ``n_blocks``, ``read_res``) walks blocks
    ``[block_lo, block_lo + n_blocks)`` of the whole cache in place, each
    row's ``pack_blocks`` clipped to them, the residual read only with
    ``read_res``; "auto" splits by the window's width."""
    b, h, g, d_k = q.shape
    nb, npr = kw.shape[2], kw.shape[3]
    window = block_window(nb, block_lo, n_blocks, read_res)
    d_v = d_v if shared_kv else vw.shape[-1]
    res_n = k_res.shape[2]
    check_kernel_shapes(g=g, d_k=d_k, d_v=d_v, block_n=block_n, bits=bits, npr=npr,
                        res_n=res_n, shared_kv=shared_kv, k_gran=k_gran)
    arrays = cache_operands((kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res),
                            "cache arrays", shared_kv)
    arrays += [pack_blocks.to(torch.int32).contiguous(), res_len.to(torch.int32).contiguous()]
    k_channel = k_gran == "channel"
    width = nb if n_blocks is None else n_blocks
    splits = resolve_num_splits(num_splits, b, h, work_units(width, block_n, bits, res_n),
                                q.device, g=g, d=d_k, block_n=block_n, bits=bits,
                                k_channel=k_channel, shared_kv=shared_kv, d_v=d_v)
    return launch_decode("bitdecode", query_operand(q), arrays,
                         (d_k, d_v, nb, block_n, res_n, bits, int(k_channel), int(shared_kv)),
                         d_v=d_v, num_splits=splits, sm_scale=sm_scale,
                         shift=draft_shift(bits, draft_bits), window=window)


def bitdecode_attention(q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res,
                        v_res, pack_blocks, res_len, *, bits: int,
                        block_n: int = 128, sm_scale: float | None = None,
                        k_gran: str = "channel", shared_kv: bool = False,
                        d_v: int | None = None, impl: str = "auto",
                        num_splits: int | str | None = "auto",
                        return_lse: bool = False, draft_bits: int | None = None,
                        block_lo: int = 0, n_blocks: int | None = None,
                        read_res: bool = True):
    """Fused low-bit decode attention over (packed cache + bf16 residual).

    q: [B, H_kv, g, d_k] (query-transformed); see ref.py for the shapes.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors).
    ``draft_bits`` (the speculative draft read: each packed code read at
    its top ``draft_bits`` bits, against the scale times 2^(bits -
    draft_bits)) runs in the kernel too; ``draft_bits >= bits`` is the
    normal read.  ``shared_kv`` (MLA latent cache): V is the first ``d_v``
    channels of dequantized K (and of the K residual); the V-side
    arguments are ignored.  The plain version resolves ``num_splits="auto"``
    to 1 (splitting multiplies its work); explicit integers are honoured.
    The block window (``block_lo``, ``n_blocks``, ``read_res``: one rank's
    share of a split-KV walk across devices, ``dist/splitkv.py``) attends
    blocks ``[block_lo, block_lo + n_blocks)`` of the cache, and the
    residual only with ``read_res``; the defaults are the whole call.
    """
    d_k = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if draft_bits is not None and draft_bits >= bits:
        draft_bits = None  # a full-fidelity read is the normal path
    impl = _build.resolve_impl(impl, q, kw, k_scale, k_zero, vw, v_scale, v_zero,
                               k_res, v_res, pack_blocks, res_len)
    if shared_kv and d_v is None:
        raise ValueError("shared_kv requires d_v")
    if impl == "torch":
        out, lse = _ref.bitdecode_attention_ref(
            q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
            pack_blocks, res_len, bits=bits, block_n=block_n, sm_scale=sm_scale,
            k_gran=k_gran, shared_kv=shared_kv, d_v=d_v,
            num_splits=resolve_num_splits(num_splits, 1, 1, 1, "cpu"),  # "auto": 1
            draft_bits=draft_bits, block_lo=block_lo, n_blocks=n_blocks, read_res=read_res,
        )
    else:
        out, lse = bitdecode_cuda(
            q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
            pack_blocks, res_len, bits=bits, block_n=block_n, sm_scale=sm_scale,
            k_gran=k_gran, num_splits=num_splits, draft_bits=draft_bits,
            shared_kv=shared_kv, d_v=d_v, block_lo=block_lo, n_blocks=n_blocks,
            read_res=read_res,
        )
    return (out, lse) if return_lse else out
