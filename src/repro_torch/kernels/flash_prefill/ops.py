"""Entry point of the flash-prefill attention: the CUDA kernel
(``csrc/flash_prefill.cu``) or its plain PyTorch version (``ref.py``).

Two layouts are taken: ``"bhsd"`` ([B, H, S, d], the TPU kernel's and the
plain version's shapes) and ``"bshd"`` ([B, S, H, d], the layout the model
holds its projections in).  The kernel reads either through strides, so the
model path makes no transposed copy; the output comes back in the layout of
the input.  Unlike the TPU entry point, nothing is padded: the kernel masks
the ragged end of S itself and takes d in {32, 64, 128, 256} as it is.
The kernel loads its operands by TMA through one 4-D tensor map each, built
from these strides, so a head slice of a fused QKV buffer is read as it is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill import ref as _ref

HEAD_DIMS = (32, 64, 128, 256)
BLOCK_Q = 128  # query rows of one work tile (two consumer warpgroups of 64)
_LAYOUTS = ("bhsd", "bshd")


def work_tiles(b: int, hq: int, s: int) -> int:
    """The kernel's work tiles: (128 query rows, q-head, batch row)."""
    return -(-s // BLOCK_Q) * hq * b


def launch_ctas(b: int, hq: int, s: int, d: int, sm_count: int) -> int:
    """CTAs to launch: persistent, one per SM, at d <= 128 (a work tile's
    loads then run under the last one's products and epilogue); one per work
    tile at d = 256, where the hardware's dispatch balanced gemma-7b's few,
    uneven waves better than the kernel's static walk (PERF.md)."""
    n = work_tiles(b, hq, s)
    return n if d > 128 else max(1, min(n, sm_count))


def _as_bshd(x, layout: str):
    return x.transpose(1, 2) if layout == "bhsd" else x


def _kernel_operand(x):
    """bf16 with unit channel stride, a 16-byte aligned start and strides
    that are nonzero multiples of 16 bytes wherever the extent is above 1
    (TMA's rules for a tensor map), copied only when ``x`` is not already
    so."""
    x = x.to(torch.bfloat16)
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(st % 8 or (st == 0 and n > 1) for st, n in zip(x.stride()[:-1], x.shape))):
        x = x.clone(memory_format=torch.contiguous_format)  # a fresh, aligned allocation
    return x


def flash_prefill_cuda(q, k, v, *, sm_scale: float, causal: bool, layout: str):
    """Launch the kernel; returns (out bf16 in ``layout``, lse f32 [B, Hq, S])."""
    q, k, v = (_kernel_operand(_as_bshd(x, layout)) for x in (q, k, v))
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or t == 0:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}: the kernel needs d_k == d_v and T >= 1")
    if causal and t != s:
        raise ValueError(f"causal attention needs S == T, got {s} queries over {t} keys; "
                         "only full attention (causal=False) takes S != T")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instance; built for {HEAD_DIMS}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"h_q={hq} is not a multiple of h_kv={hkv}")
    shape = (b, hq, s, d) if layout == "bhsd" else (b, s, hq, d)
    out = torch.empty(shape, dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    o = _as_bshd(out, layout)
    strides = [st for x in (q, k, v, o) for st in x.stride()[:3]]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _build.launch(
        "flash_prefill", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, s, t, d, *strides, int(causal), float(sm_scale),
        launch_ctas(b, hq, s, d, sms), _build.stream_of(q),
    )
    return out, lse


def flash_prefill_attention(q, k, v, *, sm_scale: float | None = None,
                            causal: bool = True, layout: str = "bhsd",
                            impl: str = "auto", return_lse: bool = False):
    """Causal (or full) attention, forward only.

    q [B, Hq, S, d] and k, v [B, Hkv, T, d] (``layout="bhsd"``), or the
    same as [B, S, H, d] (``layout="bshd"``); query head h reads KV head
    h // (Hq / Hkv).  Causal attention needs T == S; full attention
    (``causal=False``: an encoder's self attention, a decoder's cross
    attention over T encoder frames) takes any T.  Returns out (bf16, in ``layout``) and, with
    ``return_lse``, lse (f32 [B, Hq, S]).  ``sm_scale`` defaults to
    1/sqrt(d).  impl: 'cuda' (the kernel), 'torch' (the plain version) or
    'auto' (the kernel for CUDA tensors, the plain version for CPU tensors).
    """
    if layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {_LAYOUTS}")
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    if _build.resolve_impl(impl, q, k, v) == "cuda":
        out, lse = flash_prefill_cuda(q, k, v, sm_scale=sm_scale, causal=causal,
                                      layout=layout)
    else:
        bhsd = (lambda x: x) if layout == "bhsd" else (lambda x: x.transpose(1, 2))
        out, lse = _ref.flash_prefill_ref(bhsd(q), bhsd(k), bhsd(v), sm_scale=sm_scale,
                                          causal=causal)
        out = bhsd(out)
    return (out, lse) if return_lse else out
