"""Attention entry points: query transformation, decode dispatch (dense and
paged caches), blockwise prefill attention (the flash-prefill kernel on the
card), and the suffix-over-prefix attention of a shared-prefix prefill.

Query transformation (paper §V-A): the decode query ``[B, 1, h_q, d]`` is
reshaped to ``[B, h_kv, g_q, d]`` (``g_q = h_q / h_kv``) so the query heads
that share a KV head become the rows of one product; MHA (g_q = 1) and GQA
(g_q > 1) run through the same kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import qcache
from repro_torch.core.qcache import PagedQuantKVCache, QuantKVCache
from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.paged_bitdecode import ops as pg_ops

MASK_VALUE = -1e37  # finite: with -inf an empty split or block turns into NaN


def query_transform(q: torch.Tensor, h_kv: int) -> torch.Tensor:
    """[B, 1, h_q, d] -> [B, h_kv, g_q, d].  Head h shares KV head h // g_q."""
    b, s1, h_q, d = q.shape
    if s1 != 1:
        raise ValueError(f"decode expects q_len=1, got {s1}")
    if h_q % h_kv:
        raise ValueError(f"h_q={h_q} not divisible by h_kv={h_kv}")
    return q.reshape(b, h_kv, h_q // h_kv, d)


def inverse_query_transform(o: torch.Tensor) -> torch.Tensor:
    """[B, h_kv, g_q, d_v] -> [B, 1, h_q, d_v]."""
    b, h_kv, g_q, d_v = o.shape
    return o.reshape(b, 1, h_kv * g_q, d_v)


# Split-KV (sequence-parallel) decode context: when a mesh is set,
# decode_attention walks this rank's window of the cache and merges the
# ranks' partials across the mesh axis (dist/splitkv.py).  page_affine
# declares the pools' pages split along the same axis (the page-affine
# allocator, serve/pages.py): each rank reads only the pages it holds.
_SPLITKV: dict = {"mesh": None, "axis": "data", "page_affine": False}


class use_splitkv:
    """Context manager enabling cross-device split-KV decode (long-context,
    small-batch shapes) over ``mesh`` (a ``DeviceMesh``) axis ``axis``: the
    serving engine enters it around its split-KV decode step."""

    def __init__(self, mesh, axis: str = "data", *, page_affine: bool = False):
        self.mesh, self.axis = mesh, axis
        self.page_affine = page_affine

    def __enter__(self):
        self._prev = dict(_SPLITKV)
        _SPLITKV["mesh"], _SPLITKV["axis"] = self.mesh, self.axis
        _SPLITKV["page_affine"] = self.page_affine
        return self

    def __exit__(self, *exc):
        _SPLITKV.update(self._prev)
        return False


def decode_attention(q, cache: QuantKVCache | PagedQuantKVCache, *,
                     sm_scale: float | None = None, impl: str = "auto",
                     num_splits="auto", draft_bits: int | None = None,
                     d_v: int | None = None):
    """Low-bit fused decode attention of q [B, 1, h_q, d_k] against the cache;
    returns f32 [B, 1, h_q, d_v].  ``num_splits`` is the in-kernel split-KV
    count ('auto' or an integer).  ``draft_bits`` reads the packed blocks at
    that truncated width (the speculative draft read; None or >= the
    cache's bits is the normal read).  A shared_kv cache (the MLA latent)
    reads V as the first ``d_v`` channels of K.  A paged cache goes through
    the page table (:func:`_paged_decode_attention`).

    Under :class:`use_splitkv` the read walks this rank's window and merges
    across the mesh axis (``dist.splitkv``); a draft read stays unsplit, as
    in the JAX package, except over page-affine pools, which no rank holds
    whole."""
    mesh = _SPLITKV["mesh"]
    paged = isinstance(cache, PagedQuantKVCache)
    affine = paged and _SPLITKV["page_affine"]
    if mesh is not None and (draft_bits is None or affine):
        from repro_torch.dist import splitkv as sk

        kw = dict(axis=_SPLITKV["axis"], sm_scale=sm_scale, d_v=d_v, impl=impl,
                  num_splits=num_splits, draft_bits=draft_bits)
        if paged:
            return sk.splitkv_paged_decode_attention(q, cache, mesh, page_affine=affine, **kw)
        return sk.splitkv_decode_attention(q, cache, mesh, **kw)
    if paged:
        return _paged_decode_attention(q, cache, sm_scale=sm_scale, impl=impl,
                                       num_splits=num_splits, draft_bits=draft_bits,
                                       d_v=d_v)
    qt = query_transform(q, cache.kw.shape[1])
    out = bd_ops.bitdecode_attention(
        qt, cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale,
        cache.v_zero, cache.k_res, cache.v_res, cache.pack_blocks, cache.res_len,
        bits=cache.bits, block_n=cache.block_n, sm_scale=sm_scale,
        k_gran=cache.k_gran, shared_kv=cache.shared_kv, d_v=d_v, impl=impl,
        num_splits=num_splits, draft_bits=draft_bits,
    )
    return inverse_query_transform(out)


def _paged_decode_attention(q, cache: PagedQuantKVCache, *, sm_scale, impl,
                            num_splits, draft_bits=None, d_v=None):
    """Paged decode: the page-table walk of kernels/paged_bitdecode."""
    qt = query_transform(q, cache.kw.shape[1])
    out = pg_ops.paged_bitdecode_attention(
        qt, cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale,
        cache.v_zero, cache.k_res, cache.v_res, cache.page_table,
        cache.pack_blocks, cache.res_len, bits=cache.bits, block_n=cache.block_n,
        sm_scale=sm_scale, k_gran=cache.k_gran, shared_kv=cache.shared_kv, d_v=d_v,
        impl=impl, num_splits=num_splits, draft_bits=draft_bits,
    )
    return inverse_query_transform(out)


def decode_append_attention(q, cache: QuantKVCache | PagedQuantKVCache, k_new,
                            v_new, *, quant_impl: str = "auto", mask=None,
                            draft_bits: int | None = None, **attn_kwargs):
    """The per-token hot path: append the new KV token (residual write +
    flush, in place; ``qcache.append_decode`` or ``qcache.paged_append_decode``
    by the cache's type; ``v_new`` None for a shared_kv cache) and run fused
    low-bit decode attention over the updated cache.  Returns ``(out,
    cache)``.  ``attn_kwargs`` go to :func:`decode_attention`.  The serving
    engine swaps in a paged state and the model code stays the same.

    The two modes of self-speculative decoding are explicit arguments here
    (the JAX package sets them as trace-time contexts, ``use_draft`` and
    ``masked_append`` in its ``core/attention.py``):

    * ``mask`` ([B] bool, the verify pass): rows with ``False`` keep their
      cache unchanged bit for bit, live rows append exactly as unmasked;
    * ``draft_bits`` (the draft pass): the append is residual-only
      (``qcache.draft_append``: no flush, the pools untouched) and the read
      dequantizes the packed blocks at ``draft_bits``.
    """
    if draft_bits is not None:
        cache = qcache.draft_append(cache, k_new, v_new)
        return decode_attention(q, cache, draft_bits=draft_bits, **attn_kwargs), cache
    append = (qcache.paged_append_decode if isinstance(cache, PagedQuantKVCache)
              else qcache.append_decode)
    cache = append(cache, k_new, v_new, quant_impl=quant_impl, mask=mask)
    return decode_attention(q, cache, **attn_kwargs), cache


def prefix_suffix_attention(q, k, v, k_prior, v_prior, prior_len, *,
                            sm_scale: float | None = None,
                            q_chunk: int | None = None):
    """Causal attention of a prompt *suffix* against a materialized prefix,
    in plain PyTorch.

    q [B, S, h_q, d_k], k/v [B, S, h_kv, d] (the suffix); k_prior/v_prior
    [B, T, h_kv, d] (dequantized shared pages, right-padded) of which the
    first ``prior_len[b]`` are valid.  Suffix row ``j`` attends prior columns
    ``< prior_len[b]`` and suffix columns ``<= j``: rows
    ``[prior_len, prior_len + S)`` of causal attention over the concatenated
    sequence.  Returns f32 [B, S, h_q, d_v].

    The score tile ``[B, h_kv, rows * g, T + S]`` is f32; at full width it
    would run to gigabytes per layer, so the query rows go in chunks of
    ``q_chunk`` (default: as many as keep the tile near 256 MiB).  Each chunk
    keeps the whole key axis, so every row's softmax is the same function as
    unchunked.  Products take bf16 operands with f32 accumulation.  There is
    no kernel for it, in the JAX package either: the flash-prefill kernel
    takes S == T only.
    """
    b, s, h_q, d_k = q.shape
    t = k_prior.shape[1]
    h_kv, d_v = k.shape[2], v.shape[-1]
    g = h_q // h_kv
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if q_chunk is None:
        q_chunk = max(1, (256 << 20) // (4 * b * h_kv * g * (t + s)))
    qg = q.to(torch.bfloat16).float().reshape(b, s, h_kv, g, d_k).permute(0, 2, 1, 3, 4)
    kcat = torch.cat([k_prior, k], dim=1).to(torch.bfloat16).float().permute(0, 2, 3, 1)
    vcat = torch.cat([v_prior, v], dim=1).to(torch.bfloat16).float().permute(0, 2, 1, 3)
    cols = torch.arange(t + s, device=q.device)
    in_prior = (cols[None, :] < prior_len.to(q.device).long()[:, None]) & (cols[None, :] < t)
    out = torch.empty((b, h_kv, s, g, d_v), dtype=torch.float32, device=q.device)
    for lo in range(0, s, q_chunk):
        hi = min(s, lo + q_chunk)
        rows = torch.arange(lo, hi, device=q.device)
        in_suffix = (cols[None, :] >= t) & (cols[None, :] - t <= rows[:, None])
        valid = in_prior[:, None, :] | in_suffix[None]  # [B, rows, T + S]
        scores = torch.matmul(qg[:, :, lo:hi].reshape(b, h_kv, (hi - lo) * g, d_k), kcat)
        scores = scores.reshape(b, h_kv, hi - lo, g, t + s) * sm_scale
        scores = torch.where(valid[:, None, :, None, :], scores, MASK_VALUE)
        p = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
        out[:, :, lo:hi] = torch.matmul(p.reshape(b, h_kv, (hi - lo) * g, t + s),
                                        vcat).reshape(b, h_kv, hi - lo, g, d_v)
    return out.permute(0, 2, 1, 3, 4).reshape(b, s, h_q, d_v)


def padded_head_dim(d_k: int, d_v: int) -> int:
    """The flash-prefill kernel's head dim for (d_k, d_v): d_k itself when it
    has an instance and d_v == d_k, else the smallest instance >= both."""
    if d_k == d_v and d_k in fp_ops.HEAD_DIMS:
        return d_k
    fits = [d for d in fp_ops.HEAD_DIMS if d >= max(d_k, d_v)]
    if not fits:
        raise ValueError(f"head dims d_k={d_k}, d_v={d_v} exceed the flash-prefill kernel's "
                         f"{fp_ops.HEAD_DIMS}; use impl='torch'")
    return fits[0]


def blockwise_attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                        block_k: int = 512, impl: str = "auto"):
    """Flash-style attention, causal or full: q [B, S, h_q, d_k], k/v
    [B, T, h_kv, d].  Causal attention needs S == T on the card; full
    attention (an encoder's self attention, a decoder's cross attention over
    T encoder frames) takes any S and T.

    ``impl="cuda"`` runs the flash-prefill kernel (``kernels/flash_prefill``)
    on the model's [B, S, H, d] layout and returns bf16.
    Head dims the kernel has an instance for, with d_k == d_v, go as they
    are; others (MLA's d_k 192, d_v 128) take the padded route: Q, K and V
    zero-padded to the smallest instance >= max(d_k, d_v), the caller's
    ``sm_scale`` (default 1/sqrt(d_k), the unpadded width), the output
    sliced back to d_v.  Zero channels add exact zeros to every score and
    to every output channel, so the first d_v channels are the attention
    of the unpadded inputs.
    The kernel has no backward, so under autograd (grad enabled and any
    input requiring grad) the kernel route raises a ``RuntimeError``.
    ``impl="torch"`` is the plain loop (:func:`blockwise_attention_plain`),
    returning f32, which autograd differentiates.  ``"auto"`` takes the
    kernel for CUDA tensors and the plain loop for CPU tensors.
    """
    s, d_k, t, d_v = q.shape[1], q.shape[-1], v.shape[1], v.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if _build.resolve_impl(impl, q, k, v) == "cuda":
        if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
            raise RuntimeError("the flash-prefill kernel has no backward: its output would "
                               "carry no autograd graph; train with impl='torch' (the plain "
                               "loop, models.attention.TRAIN_IMPL)")
        if causal and s != t:
            raise ValueError(f"the flash-prefill kernel's causal mode needs S == T, got {s} "
                             f"queries over {t} keys")
        width = padded_head_dim(d_k, d_v)
        if width != d_k or width != d_v:
            q, k, v = (torch.nn.functional.pad(x, (0, width - x.shape[-1])) for x in (q, k, v))
        out = fp_ops.flash_prefill_attention(q, k, v, sm_scale=sm_scale, causal=causal,
                                             layout="bshd", impl="cuda")
        return out[..., :d_v]
    return blockwise_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale,
                                     block_k=block_k)


def blockwise_attention_plain(q, k, v, *, causal: bool = True, sm_scale: float,
                              block_k: int = 512):
    """The plain version of :func:`blockwise_attention`, returning f32: it
    walks KV blocks of ``block_k`` with online-softmax carries and never
    builds the [S, T] score matrix; products take bf16 operands with f32
    accumulation (float32 matmuls of bf16-rounded values).  Causal: query
    row i attends keys <= i; full: every row attends all T keys (the last
    block is sliced at T, so no key past T enters)."""
    b, s, h_q, d_k = q.shape
    _, t, h_kv, d_v = v.shape
    g = h_q // h_kv
    # [B, h_kv, S*g, d]: rows ordered (s, g) so a row's position is row // g
    qg = (q.to(torch.bfloat16).float().reshape(b, s, h_kv, g, d_k)
          .permute(0, 2, 1, 3, 4).reshape(b, h_kv, s * g, d_k))
    kf = k.to(torch.bfloat16).float().permute(0, 2, 1, 3)  # [B, h_kv, T, d_k]
    vf = v.to(torch.bfloat16).float().permute(0, 2, 1, 3)
    rows = (torch.arange(s * g, device=q.device) // g)[:, None]

    m = torch.full((b, h_kv, s * g, 1), MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h_kv, s * g, d_v), dtype=torch.float32, device=q.device)
    for lo in range(0, t, block_k):
        kj, vj = kf[:, :, lo:lo + block_k], vf[:, :, lo:lo + block_k]
        sblk = torch.matmul(qg, kj.transpose(-1, -2)) * sm_scale
        if causal:
            cols = torch.arange(lo, lo + kj.shape[2], device=q.device)[None, :]
            sblk = torch.where(cols <= rows, sblk, MASK_VALUE)
        m_new = torch.maximum(m, sblk.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sblk - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(), vj)
        m = m_new
    out = acc / l
    return out.reshape(b, h_kv, s, g, d_v).permute(0, 2, 1, 3, 4).reshape(b, s, h_q, d_v)
