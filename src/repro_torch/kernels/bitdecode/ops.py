"""Entry point of the fused low-bit decode attention: the split-KV CUDA kernel
(``csrc/bitdecode.cu``) followed by the logsumexp merge, or the plain PyTorch
version (``ref.py``).

``num_splits="auto"`` splits the packed-block axis only when ``B x H_kv``
underfills the card's streaming multiprocessors and every split still owns at
least 2 packed blocks: the long-context, small-batch regime of the paper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ref as _ref

_MAX_SPLITS = 16


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (1 on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def auto_num_splits(b: int, h_kv: int, nb: int, *, cores: int) -> int:
    """1 unless B * H_kv underfills ``cores`` and the packed sequence is long
    enough for every split to own >= 2 blocks."""
    if b * h_kv >= cores or nb < 4:
        return 1
    want = -(-cores // (b * h_kv))
    return max(1, min(want, nb // 2, _MAX_SPLITS))


def resolve_num_splits(num_splits, b: int, h_kv: int, nb: int, device) -> int:
    if num_splits in (None, "auto"):
        return auto_num_splits(b, h_kv, nb, cores=sm_count(device))
    s = int(num_splits)
    if s < 1:
        raise ValueError(f"num_splits must be >= 1, got {num_splits}")
    return max(1, min(s, nb)) if nb else 1


def bitdecode_partials_cuda(q, kw, k_scale, k_zero, vw, v_scale, v_zero,
                            k_res, v_res, pack_blocks, res_len, *, bits: int,
                            block_n: int, sm_scale: float, k_gran: str,
                            num_splits: int):
    """Launch the kernel: per-split partials (o [S, B, H, g, d_v] f32,
    lse [S, B, H, g] f32)."""
    b, h, g, d_k = q.shape
    nb, npr = kw.shape[2], kw.shape[3]
    d_v = vw.shape[-1]
    res_n = k_res.shape[2]
    if npr * 32 != block_n * bits:
        raise ValueError(f"packed words {kw.shape} do not match bits={bits}, block_n={block_n}")
    if d_k % 2:
        raise ValueError(f"d_k={d_k} must be even")
    arrays = [q.to(torch.bfloat16).contiguous(), kw, k_scale, k_zero, vw,
              v_scale, v_zero, k_res, v_res]
    if any(not t.is_contiguous() for t in arrays):
        raise ValueError("the CUDA decode kernel takes contiguous cache arrays")
    if any(t.dtype != torch.bfloat16 for t in (k_scale, v_scale, k_res, v_res)):
        raise ValueError("the CUDA decode kernel takes bf16 params and residuals")
    pb = pack_blocks.to(torch.int32).contiguous()
    rl = res_len.to(torch.int32).contiguous()
    num_splits = max(1, min(num_splits, nb))
    bps = -(-nb // num_splits)
    o = torch.empty((num_splits, b, h, g, d_v), dtype=torch.float32, device=q.device)
    lse = torch.empty((num_splits, b, h, g), dtype=torch.float32, device=q.device)
    _build.launch(
        "bitdecode", *(t.data_ptr() for t in arrays), pb.data_ptr(), rl.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, g, d_k, d_v, nb, block_n, res_n,
        bits, int(k_gran == "channel"), num_splits, bps, float(sm_scale),
        _build.stream_of(q),
    )
    return o, lse


def bitdecode_attention(q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res,
                        v_res, pack_blocks, res_len, *, bits: int,
                        block_n: int = 128, sm_scale: float | None = None,
                        k_gran: str = "channel", shared_kv: bool = False,
                        d_v: int | None = None, impl: str = "auto",
                        num_splits: int | str | None = "auto",
                        return_lse: bool = False, draft_bits: int | None = None):
    """Fused low-bit decode attention over (packed cache + bf16 residual).

    q: [B, H_kv, g, d_k] (query-transformed); see ref.py for the shapes.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors).
    ``shared_kv`` (MLA latent cache) and ``draft_bits`` (truncated draft
    read) exist in the plain version only: on CUDA tensors they raise
    unless the caller asks for ``impl='torch'``.  The plain version resolves
    ``num_splits="auto"`` to 1 (splitting multiplies its work); explicit
    integers are honoured.
    """
    b, h, g, d_k = q.shape
    nb = kw.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if draft_bits is not None and draft_bits >= bits:
        draft_bits = None  # a full-fidelity read is the normal path
    impl = _build.resolve_impl(impl, q, kw, k_scale, k_zero, vw, v_scale, v_zero,
                               k_res, v_res, pack_blocks, res_len)
    if impl == "cuda" and (shared_kv or draft_bits is not None):
        raise ValueError("shared_kv and draft_bits have no CUDA kernel; pass impl='torch' "
                         "for the plain version")
    if num_splits in (None, "auto") and impl == "torch":
        num_splits = 1
    else:
        num_splits = resolve_num_splits(num_splits, b, h, nb, q.device)

    if impl == "torch":
        out, lse = _ref.bitdecode_attention_ref(
            q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
            pack_blocks, res_len, bits=bits, block_n=block_n, sm_scale=sm_scale,
            k_gran=k_gran, shared_kv=shared_kv, d_v=d_v, num_splits=num_splits,
            draft_bits=draft_bits,
        )
    else:
        o_parts, lse_parts = bitdecode_partials_cuda(
            q, kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
            pack_blocks, res_len, bits=bits, block_n=block_n, sm_scale=sm_scale,
            k_gran=k_gran, num_splits=num_splits,
        )
        if o_parts.shape[0] == 1:
            out, lse = o_parts[0], lse_parts[0]
        else:
            out, lse = _ref.merge_partials(o_parts, lse_parts)
    return (out, lse) if return_lse else out
