"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  This file
imports only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

kv_quant and residual_flush must match bit for bit; bitdecode within the
reference's tolerances (out 2e-2, lse 1e-3).  The plain versions are held
against the JAX package in test_torch_kernels.py.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.kv_quant import ops as kq_ops
from repro_torch.kernels.residual_flush import ops as rf_ops
from repro_torch.models.zoo import build_model

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits_of(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def randn(gen, shape, device, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gran", ["channel", "tensor"])
@pytest.mark.parametrize("shape", [(2, 2, 3 * 64, 32, 64), (2, 8, 4 * 128, 128, 128)])
def test_kv_quant_kernel_matches_plain_bitwise(cuda, bits, gran, shape):
    b, h, s, d, block_n = shape
    gen = torch.Generator(device=cuda).manual_seed(bits)
    x = randn(gen, (b, s, h, d), cuda).transpose(1, 2)  # the strided view a model passes
    out = kq_ops.quantize_kv(x, bits, gran, block_n=block_n, impl="cuda")
    ref = kq_ops.quantize_kv(x, bits, gran, block_n=block_n, impl="torch")
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(bits_of(o), bits_of(r))


def _packed(gen, device, *, b, h, nb, block_n, d, bits, k_gran, v_off=0.0):
    k = randn(gen, (b, h, nb * block_n, d), device)
    v = (randn(gen, (b, h, nb * block_n, d), device) + v_off).to(torch.bfloat16)
    return [*kq_ops.quantize_kv(k, bits, k_gran, block_n=block_n, impl="torch"),
            *kq_ops.quantize_kv(v, bits, "tensor", block_n=block_n, impl="torch")]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("shape", [(64, 32), (128, 128)])
def test_residual_flush_kernel_matches_plain_bitwise(cuda, bits, k_gran, shape):
    block_n, d = shape
    gen = torch.Generator(device=cuda).manual_seed(bits)
    args = _packed(gen, cuda, b=4, h=2, nb=3, block_n=block_n, d=d, bits=bits, k_gran=k_gran)
    args += [randn(gen, (4, 2, block_n, d), cuda) for _ in range(2)]
    args += [torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=cuda),
             torch.tensor([0, 1, 6, 2], dtype=torch.int32, device=cuda)]  # 6 > nb - 1
    kw = dict(bits=bits, block_n=block_n, k_gran=k_gran)
    clone = [a.clone() for a in args]
    out = rf_ops.residual_flush(*args, impl="cuda", **kw)
    ref = rf_ops.residual_flush(*clone, impl="torch", **kw)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(bits_of(o), bits_of(r))


DECODE_CASES = [  # (g, d, block_n, bits, k_gran, pack_blocks, res_len, q_scale)
    (1, 32, 64, 4, "channel", [4, 1], [37, 0], 1.0),
    (2, 32, 64, 2, "tensor", [0, 4], [5, 64], 1.0),
    (4, 128, 128, 4, "channel", [4, 3], [0, 100], 1.0),
    (4, 128, 128, 8, "tensor", [2, 4], [1, 127], 1.0),
    (4, 128, 128, 4, "channel", [4, 3], [9, 100], 256.0),  # scores in the hundreds
]


def _decode_args(gen, device, g, d, block_n, bits, k_gran, pb, rl, q_scale):
    """Per-channel V offsets keep the output O(1), so the 2e-2 tolerance is
    small beside it and a fault on the PV side (a missed rescale, a wrong
    dequant) shows."""
    v_off = 2.0 * torch.randn(d, generator=gen, device=device)
    packed = _packed(gen, device, b=2, h=2, nb=4, block_n=block_n, d=d, bits=bits,
                     k_gran=k_gran, v_off=v_off)
    q = (randn(gen, (2, 2, g, d), device) * q_scale).to(torch.bfloat16)
    k_res = randn(gen, (2, 2, block_n, d), device)
    v_res = (randn(gen, (2, 2, block_n, d), device) + v_off).to(torch.bfloat16)
    ints = functools.partial(torch.tensor, dtype=torch.int32, device=device)
    return [q, *packed, k_res, v_res, ints(pb), ints(rl)]


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("num_splits", [1, 3, "auto"])
def test_bitdecode_kernel_matches_plain(cuda, case, num_splits):
    g, d, block_n, bits, k_gran = case[:5]
    gen = torch.Generator(device=cuda).manual_seed(g * d)
    fn = functools.partial(
        bd_ops.bitdecode_attention, *_decode_args(gen, cuda, *case),
        bits=bits, block_n=block_n, k_gran=k_gran, return_lse=True,
    )
    out_k, lse_k = fn(impl="cuda", num_splits=num_splits)
    out_r, lse_r = fn(impl="torch", num_splits=1)
    assert out_r.abs().amax() > 0.5  # the tolerance is small beside the output
    torch.testing.assert_close(out_k, out_r, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse_k, lse_r, rtol=1e-3, atol=1e-3)


def test_plain_only_options_raise_on_the_card(cuda):
    """shared_kv and draft_bits have no kernel: on the card they need
    impl='torch', and 'auto' raises instead of falling back."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _decode_args(gen, cuda, *DECODE_CASES[2])
    shared = args[:8] + [None] + args[9:]  # V is read from K: no V residual
    for call_args, extra in ((shared, dict(shared_kv=True, d_v=64)), (args, dict(draft_bits=2))):
        call = functools.partial(bd_ops.bitdecode_attention, *call_args, bits=4,
                                 block_n=128, k_gran="channel", **extra)
        for impl in ("auto", "cuda"):
            with pytest.raises(ValueError, match="no CUDA kernel"):
                call(impl=impl)
        assert torch.isfinite(call(impl="torch")).all()


def test_entry_points_default_to_the_card(cuda):
    m = build_model(smoke_config("llama3-8b"))
    assert m.init_decode_state(1, 64)["caches"][0].kw.is_cuda
    assert m.init(torch.Generator().manual_seed(0))["embed"]["table"].is_cuda


def test_smoke_model_kernels_match_plain(cuda):
    """Ragged prefill (one full block in row 0) + 30 decode steps (each row
    flushes once) of the smoke model: kernels vs plain versions, same token
    stream; layer 0's packed cache equal bit for bit."""
    cfg = smoke_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    lengths = torch.tensor([100, 60], dtype=torch.int32, device=cuda)

    def run(impl, feed=None):
        logits, state = model.prefill(params, {"tokens": tokens}, 256,
                                      lengths=lengths, quant_impl=impl)
        out = [logits]
        for i in range(30):
            tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
            logits, state = model.decode_step(params, state, tok, impl=impl,
                                              quant_impl=impl)
            out.append(logits)
        return out, state

    with torch.no_grad():
        out_t, s_t = run("torch")
        _build.launches.clear()
        out_k, s_k = run("auto", [o[:, -1].argmax(-1)[:, None] for o in out_t])
    assert min(_build.launches[k] for k in ("kv_quant", "residual_flush", "bitdecode")) > 0
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=3e-1)
    ct, ck = s_t["caches"][0], s_k["caches"][0]
    assert torch.equal(ct.pack_blocks, ck.pack_blocks) and torch.equal(ct.res_len, ck.res_len)
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
        np.testing.assert_array_equal(bits_of(getattr(ck, f)[0]), bits_of(getattr(ct, f)[0]))
