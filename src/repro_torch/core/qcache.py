"""Quantized KV cache with a bf16 residual buffer (paper §IV-A(2), §V-B),
dense layout.

The sequence is split into packed low-bit blocks of ``block_n`` tokens plus
a bf16 residual tail of capacity ``block_n``.  Decoded tokens append to the
residual; when it fills, the fused flush (kernels/residual_flush) quantizes,
packs and commits the block and the residual restarts.

Unlike the JAX reference, whose arrays are immutable, :func:`prefill` and
:func:`append_decode` update the cache's tensors **in place** and return the
same object.  The flush is launched on every decode step: the JAX reference
skips it with ``lax.cond(any(full))``, but on the card a host-side check of
``full`` would synchronise every token, so instead each flush program returns
at once for a row that is not full.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import layout
from repro_torch.core.device import resolve_device
from repro_torch.kernels.kv_quant import ops as kvq_ops
from repro_torch.kernels.residual_flush import ops as rf_ops

_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero",
           "k_res", "v_res", "pack_blocks", "res_len")


@dataclasses.dataclass
class QuantKVCache:
    kw: torch.Tensor        # int32 [B, H, nb, npr, d_k]
    k_scale: torch.Tensor   # [B, H, nb, d_k] (channel) or [B, H, nb, block_n]
    k_zero: torch.Tensor
    vw: torch.Tensor        # int32 [B, H, nb, npr, d_v]
    v_scale: torch.Tensor   # [B, H, nb, block_n]
    v_zero: torch.Tensor
    k_res: torch.Tensor     # bf16 [B, H, block_n, d_k]
    v_res: torch.Tensor     # bf16 [B, H, block_n, d_v]
    pack_blocks: torch.Tensor  # int32 [B]
    res_len: torch.Tensor      # int32 [B]
    bits: int
    block_n: int
    k_gran: str

    @property
    def length(self) -> torch.Tensor:
        return self.pack_blocks * self.block_n + self.res_len

    def layer(self, i: int) -> "QuantKVCache":
        """Layer ``i`` of a cache stacked over layers, as views: in-place
        updates of the returned cache land in the stacked tensors."""
        return dataclasses.replace(self, **{f: getattr(self, f)[i] for f in _FIELDS})


def stack_caches(caches: list[QuantKVCache]) -> QuantKVCache:
    """Stack per-layer caches along a new leading layer axis."""
    return dataclasses.replace(
        caches[0], **{f: torch.stack([getattr(c, f) for c in caches]) for f in _FIELDS}
    )


def init_cache(batch: int, h_kv: int, d: int, max_seq: int, *, bits: int = 4,
               block_n: int = 128, k_gran: str = "channel",
               device=None) -> QuantKVCache:
    """Allocate an empty cache with capacity >= max_seq tokens: bf16 params
    and a bf16 residual, K and V of head width ``d``, on ``device`` (the card
    unless given)."""
    device = resolve_device(device)
    nb = max(1, -(-max_seq // block_n))
    npr = layout.words_per_block(block_n, bits)
    kp = d if k_gran == "channel" else block_n
    bf16 = torch.bfloat16

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return QuantKVCache(
        kw=z((batch, h_kv, nb, npr, d), torch.int32),
        k_scale=z((batch, h_kv, nb, kp), bf16),
        k_zero=z((batch, h_kv, nb, kp), bf16),
        vw=z((batch, h_kv, nb, npr, d), torch.int32),
        v_scale=z((batch, h_kv, nb, block_n), bf16),
        v_zero=z((batch, h_kv, nb, block_n), bf16),
        k_res=z((batch, h_kv, block_n, d), bf16),
        v_res=z((batch, h_kv, block_n, d), bf16),
        pack_blocks=z((batch,), torch.int32),
        res_len=z((batch,), torch.int32),
        bits=bits, block_n=block_n, k_gran=k_gran,
    )


def _append_residual(cache: QuantKVCache, k_new, v_new, mask=None):
    """Write one new token per sequence into the residual rows ``res_len[b]``
    (in place).  Returns ``(res_len_after, full)``.

    ``mask`` ([B] bool, optional) freezes sequences: a ``False`` row keeps
    its residual and ``res_len`` unchanged."""
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    at = torch.clamp(cache.res_len.long(), max=cache.block_n - 1)
    for res, new in ((cache.k_res, k_new), (cache.v_res, v_new)):
        new = new[:, :, 0].to(res.dtype)  # [B, H, d]
        if mask is not None:
            new = torch.where(mask[:, None, None], new, res[rows, :, at])
        res[rows, :, at] = new
    step = 1 if mask is None else mask.to(torch.int32)
    rl = cache.res_len + step
    return rl, rl == cache.block_n


def append_decode(cache: QuantKVCache, k_new, v_new, *, quant_impl: str = "auto",
                  mask=None) -> QuantKVCache:
    """Append one decoded token per sequence (k_new/v_new: [B, H, 1, d]) and
    commit the residual block of every row it fills, in place.

    quant_impl: 'auto' | 'cuda' | 'torch', forwarded to the flush.
    ``mask`` ([B] bool, optional): rows with ``False`` keep the cache
    unchanged."""
    rl, full = _append_residual(cache, k_new, v_new, mask)
    rf_ops.residual_flush(
        cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale,
        cache.v_zero, cache.k_res, cache.v_res, full.to(torch.int32),
        cache.pack_blocks, bits=cache.bits, block_n=cache.block_n,
        k_gran=cache.k_gran, impl=quant_impl,
    )
    cache.pack_blocks.copy_(torch.where(full, cache.pack_blocks + 1, cache.pack_blocks))
    cache.res_len.copy_(torch.where(full, torch.zeros_like(rl), rl))
    return cache


def _quantize_full_region(cache: QuantKVCache, k, v, n_full: int, quant_impl: str):
    """Quantize + pack the first ``n_full`` blocks of a prefill into the
    packed fields (in place)."""
    if not n_full:
        return
    n = n_full * cache.block_n
    for (w_dst, s_dst, z_dst), x, gran in (
        ((cache.kw, cache.k_scale, cache.k_zero), k, cache.k_gran),
        ((cache.vw, cache.v_scale, cache.v_zero), v, "tensor"),
    ):
        w, s, z = kvq_ops.quantize_kv(
            x[:, :, :n], cache.bits, gran, block_n=cache.block_n,
            param_dtype=s_dst.dtype, impl=quant_impl,
        )
        w_dst[:, :, :n_full] = w
        s_dst[:, :, :n_full] = s
        z_dst[:, :, :n_full] = z


def prefill(cache: QuantKVCache, k, v, *, lengths=None,
            quant_impl: str = "auto") -> QuantKVCache:
    """Fill the cache (in place) from a prefill's k/v [B, H, L, d]: the
    first ``L - L % block_n`` tokens are quantized into packed blocks, the
    tail goes to the residual.

    ``lengths`` ([B] int32, optional) marks a ragged batch right-padded to
    L: sequence b keeps ``lengths[b] // block_n`` packed blocks and its
    residual holds tokens ``[lengths[b] - lengths[b] % block_n, lengths[b])``.
    Blocks past ``pack_blocks[b]`` hold pad-polluted params but are never
    read, and the next flush overwrites them.
    """
    b, h, L, _ = k.shape
    block_n = cache.block_n
    n_full = L // block_n
    res = L - n_full * block_n
    _quantize_full_region(cache, k, v, n_full, quant_impl)
    if lengths is not None:
        lengths = lengths.to(device=k.device, dtype=torch.int32)
        lo = (lengths // block_n) * block_n
        idx = torch.clamp(lo[:, None].long() + torch.arange(block_n, device=k.device),
                          max=L - 1)  # [B, block_n]; rows >= res_len are unread
        for res_buf, x in ((cache.k_res, k), (cache.v_res, v)):
            gather = idx[:, None, :, None].expand(b, h, block_n, x.shape[-1])
            res_buf.copy_(torch.gather(x, 2, gather))
        cache.pack_blocks.copy_(lengths // block_n)
        cache.res_len.copy_(lengths % block_n)
        return cache
    for res_buf, x in ((cache.k_res, k), (cache.v_res, v)):
        res_buf.zero_()
        res_buf[:, :, :res] = x[:, :, n_full * block_n:]
    cache.pack_blocks.fill_(n_full)
    cache.res_len.fill_(res)
    return cache
