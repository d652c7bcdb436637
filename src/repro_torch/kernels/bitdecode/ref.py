"""Plain PyTorch version of the fused low-bit decode attention (Packing
kernel), and the logsumexp merge of split-KV partials.

It does the kernel's work in whole tensors: dequantize every packed block,
append the bf16 residual, QK^T with bf16 operands and f32 accumulation,
masked softmax, PV.  ``num_splits > 1`` computes one masked-softmax partial
per contiguous range of packed blocks (the residual rides with the last) and
merges them with :func:`merge_partials`.

bf16 operands with f32 accumulation are written as float32 matmuls of
bf16-rounded values: every product of two bf16 numbers is exact in float32,
and on the card a float32 matmul runs in full float32 unless TF32 is enabled.
"""
from __future__ import annotations

import torch

from repro_torch.core import layout, quantizer

MASK_VALUE = -1e37


def _bf16_f32(x):
    return x.to(torch.bfloat16).float()


def _dequant_blocks(words, scale, zero, bits, granularity, draft_bits=None):
    """words [B, H, nb, npr, d] -> bf16 [B, H, nb * block_n, d].

    ``draft_bits`` (speculative draft read) dequantizes as if only the top
    ``draft_bits`` of each code had been stored, against a scale widened by
    ``2 ** (bits - draft_bits)``."""
    if draft_bits is not None and draft_bits < bits:
        shift = bits - draft_bits
        q = layout.unpack_strided(words, bits) >> shift
        x = quantizer.dequantize_block(q, scale.float() * (1 << shift), zero, granularity)
    else:
        x = quantizer.unpack_and_dequantize(words, scale, zero, bits, granularity)
    b, h, nb, n, d = x.shape
    return x.reshape(b, h, nb * n, d)


def _softmax_partial(scores, v_all):
    """Masked-softmax partial over the token axis: (o, lse).  Fully masked
    rows give lse ~ -1e37, which the merge weights out."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    out = torch.matmul(_bf16_f32(p), v_all.float()) / l
    lse = (m + torch.log(l))[..., 0]
    return out, lse


def merge_partials(o_parts, lse_parts):
    """Combine per-split partials o [S, ..., g, d_v], lse [S, ..., g] into
    (o, lse).  Splits with lse ~ -1e37 (no valid token) get weight 0."""
    m = lse_parts.amax(dim=0)
    w = torch.exp(lse_parts - m[None])
    den = torch.clamp_min(w.sum(dim=0), 1e-30)
    out = (w[..., None] * o_parts).sum(dim=0) / den[..., None]
    return out, m + torch.log(den)


def bitdecode_attention_ref(q, kw, k_scale, k_zero, vw, v_scale, v_zero,
                            k_res, v_res, pack_blocks, res_len, *, bits: int,
                            block_n: int = 128, sm_scale: float | None = None,
                            k_gran: str = "channel", shared_kv: bool = False,
                            d_v: int | None = None, num_splits: int = 1,
                            draft_bits: int | None = None, block_lo: int = 0,
                            n_blocks: int | None = None, read_res: bool = True):
    """q: [B, H_kv, g, d_k] (query-transformed); kw: int32 [B, H_kv, nb, npr, d_k];
    vw: int32 [B, H_kv, nb, npr, d_v] with per-token params (ignored when
    ``shared_kv``: V is then the first ``d_v`` channels of dequantized K);
    k_res/v_res: bf16 [B, H_kv, N_r, d]; pack_blocks/res_len: int32 [B].
    The block window attends blocks ``[block_lo, block_lo + n_blocks)`` (cut
    at nb), each row's pack_blocks clipped to them, and the residual only
    with ``read_res``: the call over that slice of the cache.

    Returns (out [B, H, g, d_v] f32, lse [B, H, g] f32).
    """
    if block_lo or n_blocks is not None or not read_res:
        nb = kw.shape[2]
        lo = min(block_lo, nb)
        hi = nb if n_blocks is None else min(nb, lo + n_blocks)
        kw, k_scale, k_zero, vw, v_scale, v_zero = (
            None if x is None else x[:, :, lo:hi]
            for x in (kw, k_scale, k_zero, vw, v_scale, v_zero))
        pack_blocks = torch.clamp(pack_blocks - block_lo, 0, hi - lo)
        if not read_res:
            res_len = torch.zeros_like(res_len)
    b, h, g, d_k = q.shape
    nb = kw.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if shared_kv:
        if d_v is None:
            raise ValueError("shared_kv requires d_v")
    if draft_bits is not None and not 1 <= draft_bits <= bits:
        raise ValueError(f"draft_bits={draft_bits} outside [1, bits={bits}]")

    k_hat = _dequant_blocks(kw, k_scale, k_zero, bits, k_gran, draft_bits)
    if shared_kv:
        v_hat = k_hat[..., :d_v]
        if v_res is None:
            v_res = k_res[..., :d_v]
    else:
        v_hat = _dequant_blocks(vw, v_scale, v_zero, bits, "tensor", draft_bits)
    k_all = torch.cat([k_hat, k_res.to(torch.bfloat16)], dim=2)
    v_all = torch.cat([v_hat, v_res.to(torch.bfloat16)], dim=2)

    s_pack = nb * block_n
    t = torch.arange(s_pack + k_res.shape[2], device=q.device)
    valid_pack = t[None, :] < (pack_blocks.long()[:, None] * block_n)
    in_res = t[None, :] >= s_pack
    valid_res = in_res & (t[None, :] - s_pack < res_len.long()[:, None])
    valid = torch.where(in_res, valid_res, valid_pack)  # [B, S_tot]

    scores = torch.matmul(_bf16_f32(q), k_all.float().transpose(-1, -2)) * sm_scale

    num_splits = max(1, min(num_splits, nb))
    if num_splits == 1:
        scores = torch.where(valid[:, None, None, :], scores, MASK_VALUE)
        return _softmax_partial(scores, v_all)

    bps = -(-nb // num_splits)
    parts_o, parts_lse = [], []
    for i in range(num_splits):
        lo, hi = i * bps * block_n, min((i + 1) * bps, nb) * block_n
        own = (t[None, :] >= lo) & (t[None, :] < hi)
        if i == num_splits - 1:
            own = own | in_res
        s_i = torch.where((valid & own)[:, None, None, :], scores, MASK_VALUE)
        o_i, lse_i = _softmax_partial(s_i, v_all)
        parts_o.append(o_i)
        parts_lse.append(lse_i)
    return merge_partials(torch.stack(parts_o), torch.stack(parts_lse))
