"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card.  This file
imports only torch and the port, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

kv_quant and residual_flush (dense and paged, both modes: "flush" and the
decode step's "append") must match bit for bit;
bitdecode and paged_bitdecode within the reference's tolerances (out 2e-2,
lse 1e-3), and paged_bitdecode over an identity page table bit for bit
equal to bitdecode; flash_prefill within its kernel's tolerance (out 3e-2,
lse 1e-3); the draft read (``draft_bits``) of both decode kernels within
the same tolerances, and the speculative passes' graphs bit for bit equal
to their eager bodies; the MoE smoke model's kernels against its plain
versions, its captured step bit for bit equal to the eager one, and its
routing, dispatch and combine free of host syncs; the MLA latent cache's
shared_kv modes of K2-K5 (bit for bit / within the decode tolerances), K6's
padded route, the deepseek-v3 smoke model's kernels against its plain
versions, its captured step and its freedom from host syncs; K2-K5 at
zamba2-7b's head dim 112 and the zamba2 smoke model (the Mamba2 hybrid) on
the kernels against its plain versions, its captured step bit for bit equal
to the eager one (Mamba2 states included) and its engines (async, spec)
against the sequential one; K6's full mode at S != T (cross attention) and
the seamless (encoder-decoder) and qwen2-vl (VLM stub, M-RoPE) smoke models
on the kernels against their plain versions, the engine refusing both
(``-k "encdec or vlm or cross"``); the xLSTM smoke model's captured step bit
for bit equal to the eager one, its chunkwise prefill against the
sequential one, and the exact-length shim's engines (llama3-8b forced to
it, and xLSTM) on the async runtime and by self-speculation against the
sync one, no plain version called (``-k "xlstm or shim"``).  The plain
versions are
held against the JAX package in test_torch_kernels.py, test_torch_paged.py
and test_torch_flash_prefill.py.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.core import attention as catt
from repro_torch.core import qcache
from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.kv_quant import ops as kq_ops
from repro_torch.kernels.paged_bitdecode import ops as pg_ops
from repro_torch.kernels.residual_flush import ops as rf_ops
from repro_torch.models.zoo import build_model
from repro_torch.data.pipeline import make_batch
from repro_torch.optim import get_optimizer
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import tree as tr
from repro_torch.train.step import TrainState, make_train_step, value_and_grad

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


# (B, H, S, d, block_n): every cache width of the configs (zamba2-7b's 112,
# the MLA latents 160 and 576) and block sizes 32-128
KV_QUANT_SHAPES = [(2, 2, 3 * 64, 32, 64), (2, 3, 4 * 32, 64, 32), (2, 3, 2 * 128, 112, 128),
                   (2, 8, 4 * 128, 128, 128), (2, 2, 3 * 64, 160, 64), (2, 4, 2 * 128, 256, 128),
                   (1, 2, 2 * 128, 576, 128)]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("gran", ["channel", "tensor"])
@pytest.mark.parametrize("shape", KV_QUANT_SHAPES)
def test_kv_quant_kernel_matches_plain_bitwise(cuda, bits, gran, shape):
    b, h, s, d, block_n = shape
    gen = torch.Generator(device=cuda).manual_seed(bits)
    x = randn(gen, (b, s, h, d), cuda).transpose(1, 2)  # the strided view a model passes
    out = kq_ops.quantize_kv(x, bits, gran, block_n=block_n, impl="cuda")
    ref = kq_ops.quantize_kv(x, bits, gran, block_n=block_n, impl="torch")
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(bits_of(o), bits_of(r))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("d", [64, 128, 256, 576])
def test_kv_quant_pair_kernel_writes_the_cache_like_the_plain_pair(cuda, d, bits, k_gran):
    """One launch of the pair into the first n_full blocks of an init_cache
    cache equals the plain pair bit for bit; the guard blocks past n_full
    keep what they held."""
    b, h, block_n, n_full = 2, 3, 128, 3
    gen = torch.Generator(device=cuda).manual_seed(bits + d)
    k = randn(gen, (b, n_full * block_n, h, d), cuda).transpose(1, 2)
    v = randn(gen, (b, n_full * block_n, 2 * h, d), cuda)[:, :, h:].transpose(1, 2)
    cache = qcache.init_cache(b, h, d, (n_full + 2) * block_n, bits=bits, block_n=block_n,
                              k_gran=k_gran, device=cuda)
    fields = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")
    for f in fields:  # guard contents: anything but zeros
        x = getattr(cache, f)
        x.copy_(torch.randint(-2**30, 2**30, x.shape, generator=gen, device=cuda)
                if x.dtype == torch.int32 else randn(gen, x.shape, cuda))
    twin = [getattr(cache, f).clone() for f in fields]
    before = [x.clone() for x in twin]
    heads = [getattr(cache, f)[:, :, :n_full] for f in fields]
    _build.launches.clear()
    kq_ops.quantize_kv_pair(k, v, bits, k_gran, block_n=block_n, out_k=heads[:3],
                            out_v=heads[3:], impl="cuda")
    assert dict(_build.launches) == {"kv_quant": 1}
    heads = [x[:, :, :n_full] for x in twin]
    kq_ops.quantize_kv_pair(k, v, bits, k_gran, block_n=block_n, out_k=heads[:3],
                            out_v=heads[3:], impl="torch")
    for f, want, b0 in zip(fields, twin, before):
        got = getattr(cache, f)
        np.testing.assert_array_equal(bits_of(got), bits_of(want))
        np.testing.assert_array_equal(bits_of(got[:, :, n_full:]), bits_of(b0[:, :, n_full:]))


def test_quant_params_at_an_exact_bf16_tie_on_the_card(cuda):
    """A channel whose (max - min) / 15 is 0.19580078125, halfway between
    two bf16 values (a seamless cross cache's block): the plain version on
    the card rounds the IEEE quotient to even, 0.1953125, as JAX and the
    CPU do, and K1 equals it bit for bit.  Divided by the Python number 15,
    the quotient would round to 0.1962890625: PyTorch's CUDA kernel turns
    that division into a multiply by the reciprocal (ROADMAP C)."""
    x = torch.rand((1, 1, 128, 8), generator=torch.Generator().manual_seed(7)) * 4.0 - 2.0
    x[..., 0] = torch.linspace(-3.046875, -0.10986328125, 128)
    x = x.to(torch.bfloat16).to(cuda)
    assert float(x[..., 0].min()) == -3.046875 and float(x[..., 0].max()) == -0.10986328125
    ref = kq_ops.quantize_kv(x, 4, "channel", block_n=128, impl="torch")
    out = kq_ops.quantize_kv(x, 4, "channel", block_n=128, impl="cuda")
    assert float(ref[1][0, 0, 0, 0]) == 0.1953125
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(bits_of(o), bits_of(r))


def test_kv_quant_kernel_refuses_what_it_cannot_take_on_the_card(cuda):
    """A head dim it has no instance for, a non-bf16 input, out views with a
    channel stride other than 1 and out views off the card raise before a
    launch; a CPU tensor under impl='cuda' raises: no fallback."""
    x = torch.zeros((1, 2, 128, 128), dtype=torch.bfloat16, device=cuda)
    out = kq_ops.quantize_kv(x, 4, "channel", block_n=64, impl="cuda")
    _build.launches.clear()
    for bad in (torch.zeros((1, 2, 128, 100), dtype=torch.bfloat16, device=cuda),
                torch.zeros((1, 2, 128, 584), dtype=torch.bfloat16, device=cuda), x.float()):
        with pytest.raises(ValueError):
            kq_ops.quantize_kv(bad, 4, "channel", block_n=64)
    wide = kq_ops.quantize_kv(torch.zeros((1, 2, 128, 256), dtype=torch.bfloat16, device=cuda),
                              4, "channel", block_n=64)
    _build.launches.clear()
    with pytest.raises(ValueError, match="unit channel stride"):
        kq_ops.quantize_kv(x, 4, "channel", block_n=64, out=tuple(t[..., ::2] for t in wide))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kq_ops.quantize_kv(x, 4, "channel", block_n=64, out=tuple(t.cpu() for t in out))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kq_ops.quantize_kv_pair(x, x.cpu(), 4, "channel", block_n=64, out_k=out, out_v=out)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kq_ops.quantize_kv(x.cpu(), 4, "channel", block_n=64, impl="cuda")
    assert not _build.launches


def _packed(gen, device, *, b, h, nb, block_n, d, bits, k_gran, v_off=0.0):
    k = randn(gen, (b, h, nb * block_n, d), device)
    v = (randn(gen, (b, h, nb * block_n, d), device) + v_off).to(torch.bfloat16)
    return [*kq_ops.quantize_kv(k, bits, k_gran, block_n=block_n, impl="torch"),
            *kq_ops.quantize_kv(v, bits, "tensor", block_n=block_n, impl="torch")]


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("shape", [(64, 32), (128, 112), (128, 128), (128, 256)])
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
    (8, 128, 128, 4, "channel", [3, 4], [60, 16], 1.0),  # command-r-35b's g
    (12, 128, 128, 4, "tensor", [4, 2], [127, 33], 1.0),  # starcoder2-3b's g
    (1, 256, 128, 4, "channel", [4, 3], [100, 7], 1.0),  # gemma-7b's head
    (2, 64, 64, 2, "channel", [4, 2], [20, 64], 1.0),  # 4 word rows a block
    (4, 64, 64, 8, "tensor", [3, 4], [64, 1], 1.0),
    (4, 128, 128, 4, "channel", [1, 4], [0, 50], 1.0),  # a row with fewer blocks than splits
    (4, 128, 128, 4, "tensor", [0, 3], [0, 40], 1.0),  # pack_blocks 0 with res_len 0
    (2, 128, 128, 2, "channel", [2, 4], [128, 128], 1.0),  # full residuals
]


def _live(pb, rl):
    """Rows with at least one valid token.  A row with none has no defined
    attention: the kernel gives it o = 0 and lse ~ -1e37, as it gives an
    empty split; the plain version a uniform softmax over masked slots."""
    return torch.tensor([p > 0 or r > 0 for p, r in zip(pb, rl)])


def _assert_decode_close(out_k, lse_k, out_r, lse_r, pb, rl):
    live = _live(pb, rl)
    assert out_r[live].abs().amax() > 0.5  # the tolerance is small beside the output
    torch.testing.assert_close(out_k[live], out_r[live], rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(lse_k[live], lse_r[live], rtol=1e-3, atol=1e-3)
    assert not out_k[~live].any() and (lse_k[~live] < -1e36).all()


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
    _assert_decode_close(out_k, lse_k, out_r, lse_r, case[5], case[6])


def test_plain_only_options_raise_on_the_card(cuda):
    """shared_kv at a width with no kernel instance (d_k 128): on the card it
    needs impl='torch', and 'auto' raises instead of falling back.  The MLA
    widths and draft_bits have kernels: they launch."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    args = _decode_args(gen, cuda, *DECODE_CASES[2])
    shared = args[:8] + [None] + args[9:]  # V is read from K: no V residual
    call = functools.partial(bd_ops.bitdecode_attention, *shared, bits=4, block_n=128,
                             k_gran="channel", shared_kv=True, d_v=64)
    for impl in ("auto", "cuda"):
        with pytest.raises(ValueError, match="shared_kv mode takes"):
            call(impl=impl)
    assert torch.isfinite(call(impl="torch")).all()
    _build.launches.clear()
    q, kq, k_res, pb, rl = _latent_args(gen, cuda, 4, 160, 64, 4, [2, 1], [3, 4])
    bd_ops.bitdecode_attention(q, *kq, None, None, None, k_res, None, pb, rl, bits=4,
                               block_n=64, shared_kv=True, d_v=128, num_splits=1)
    assert dict(_build.launches) == {"bitdecode": 1}
    _build.launches.clear()
    bd_ops.bitdecode_attention(*args, bits=4, block_n=128, k_gran="channel", draft_bits=2,
                               num_splits=1)
    assert dict(_build.launches) == {"bitdecode": 1}


# ------------------------------------------ the shared_kv (MLA latent) mode

# (B, g, d_k, d_v, block_n, bits, pack_blocks, res_len): the smoke config's
# latent (160 / 128, g 4, block_n 64) and deepseek-v3's (576 / 512, g 128)
LATENT_CASES = [
    (2, 4, 160, 128, 64, 4, [4, 1], [37, 0]),
    (2, 4, 160, 128, 64, 2, [0, 4], [5, 64]),
    (2, 12, 160, 128, 64, 8, [3, 4], [64, 1]),
    (4, 128, 576, 512, 128, 4, [4, 3, 1, 0], [0, 100, 127, 9]),
    (2, 128, 576, 512, 128, 2, [2, 4], [128, 33]),
    (2, 16, 576, 512, 128, 8, [4, 2], [16, 1]),
]
LATENT_SCALE = 1.0 / 192**0.5  # MLA's 1 / sqrt(qk_nope + qk_rope) at full width


def _latent_args(gen, device, g, d, block_n, bits, pb, rl, b=2, nb=4, res_n=None):
    """q [B, 1, g, d], the packed latent (words, scale, zero; per channel),
    its residual [B, 1, res_n, d] and the lengths.  Per-channel offsets keep
    the output (V = K's first channels) O(1)."""
    off = 2.0 * torch.randn(d, generator=gen, device=device)
    lat = (randn(gen, (b, 1, nb * block_n, d), device) + off).to(torch.bfloat16)
    kq = kq_ops.quantize_kv(lat, bits, "channel", block_n=block_n, impl="torch")
    q = randn(gen, (b, 1, g, d), device)
    k_res = (randn(gen, (b, 1, res_n or block_n, d), device) + off).to(torch.bfloat16)
    ints = functools.partial(torch.tensor, dtype=torch.int32, device=device)
    return q, list(kq), k_res, ints(pb), ints(rl)


@pytest.mark.parametrize("case", LATENT_CASES)
def test_shared_kv_decode_kernels_match_plain(cuda, case):
    """K3 and K4 (a scrambled table) in the shared_kv mode against their
    plain versions (out 2e-2, lse 1e-3) at split counts 1, 3 and auto; K4 on
    an identity table equals K3 bit for bit; the draft read 4 -> 2 bits
    against its plain version."""
    b, g, dk, dv, block_n, bits, pb, rl = case
    gen = torch.Generator(device=cuda).manual_seed(g + dk + bits)
    q, kq, k_res, pbt, rlt = _latent_args(gen, cuda, g, dk, block_n, bits, pb, rl, b=b)
    order = torch.randperm(b * 4, generator=gen, device=cuda)
    pools = [torch.empty_like(p).index_copy_(0, order, p) for p in _pools(kq)]
    tables = {"scrambled": order.reshape(b, 4).to(torch.int32),
              "identity": torch.arange(b * 4, dtype=torch.int32, device=cuda).reshape(b, 4)}
    kw = dict(bits=bits, block_n=block_n, shared_kv=True, d_v=dv, sm_scale=LATENT_SCALE,
              return_lse=True)

    def dense(**x):
        return bd_ops.bitdecode_attention(q, *kq, None, None, None, k_res, None, pbt, rlt,
                                          **kw, **x)

    def paged(table, pool=pools, **x):
        return pg_ops.paged_bitdecode_attention(q, *pool, None, None, None, k_res, None,
                                                table, pbt, rlt, **kw, **x)

    draft = [2] if bits == 4 else []
    for db in [None] + draft:
        out_r, lse_r = dense(impl="torch", num_splits=1, draft_bits=db)
        for ns in (1, 3, "auto"):
            for name, call in (("dense", dense), ("paged", functools.partial(
                    paged, tables["scrambled"]))):
                out_k, lse_k = call(impl="cuda", num_splits=ns, draft_bits=db)
                _assert_decode_close(out_k, lse_k, out_r, lse_r, pb, rl)
        for ns in (1, 3):
            d_out = dense(impl="cuda", num_splits=ns, draft_bits=db)
            p_out = paged(tables["identity"], _pools(kq), impl="cuda", num_splits=ns,
                          draft_bits=db)
            assert torch.equal(d_out[0], p_out[0]) and torch.equal(d_out[1], p_out[1])


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("d", [160, 576])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_shared_kv_flush_kernels_match_plain_bitwise(cuda, paged, d, bits):
    """K2 / K5 in the shared_kv mode (K alone, per channel, at the MLA
    latent widths), mode "flush" once with mixed ``full`` and then mode
    "append" over 2 * block_n + 5 steps (row 1 masked every third step),
    every array and length equal to the plain version's after each call."""
    b, block_n = 3, 128
    gen = torch.Generator(device=cuda).manual_seed(d + bits)
    lat = randn(gen, (b, 1, 6 * block_n, d), cuda)
    kq = list(kq_ops.quantize_kv(lat, bits, "channel", block_n=block_n, impl="torch"))
    arrays = (_pools(kq) if paged else kq)
    k_res = randn(gen, (b, 1, block_n, d), cuda)
    kw = dict(bits=bits, block_n=block_n, k_gran="channel", shared_kv=True)
    flush = rf_ops.paged_residual_flush if paged else rf_ops.residual_flush
    full = torch.tensor([1, 0, 1], dtype=torch.int32, device=cuda)
    dest = torch.tensor([7, 1, 40] if paged else [0, 1, 9], dtype=torch.int32, device=cuda)
    twin = [x.clone() for x in arrays]
    flush(*arrays, None, None, None, k_res, None, full, dest, impl="cuda", **kw)
    flush(*twin, None, None, None, k_res, None, full, dest, impl="torch", **kw)
    for x, y in zip(arrays, twin):
        assert torch.equal(x, y)

    ints = functools.partial(torch.tensor, dtype=torch.int32, device=cuda)
    lens = [ints([0, 1, 0]), ints([5, 100, 127]), ints([0, 0, 0])]
    if paged:
        lens = [(b + torch.randperm(3 * b * 2 - b, generator=gen, device=cuda)[:b * 4]
                 ).reshape(b, 4).to(torch.int32)] + lens
    twin_a, twin_l = [x.clone() for x in arrays + [k_res]], [x.clone() for x in lens]
    state_a = arrays + [k_res]
    append = rf_ops.paged_append_flush if paged else rf_ops.append_flush
    for step in range(2 * block_n + 5):
        k_new = randn(gen, (b, 1, 1, d), cuda)
        mask = torch.tensor([True, step % 3 != 1, True], device=cuda)
        for arr, ln, impl in ((state_a, lens, "cuda"), (twin_a, twin_l, "torch")):
            append(*arr[:3], None, None, None, arr[3], None, k_new, None, *ln, mask=mask,
                   impl=impl, **kw)
        for i, (x, y) in enumerate(zip(state_a + lens, twin_a + twin_l)):
            assert torch.equal(x, y), f"field {i} differs after step {step}"
    assert (lens[-3] >= 2).all() and not lens[-1].any()


# ---------------------------------------------- the speculative draft read


DRAFT_PAIRS = [(4, 1), (4, 2), (4, 3), (8, 2), (8, 4), (2, 1)]


@pytest.mark.parametrize("bits, draft_bits", DRAFT_PAIRS)
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("res_n", [128, 136], ids=["res128", "res136"])
def test_draft_read_kernel_matches_plain(cuda, bits, draft_bits, k_gran, d, res_n):
    """K3 and K4 (a scrambled table) with ``draft_bits`` against their plain
    versions, out 2e-2 / lse 1e-3, with a residual of ``block_n`` tokens or
    widened by the draft pass's 8 (a row with ``res_len > block_n``); the
    rows past ``res_len`` are never read (zeroing them changes nothing, bit
    for bit); ``draft_bits = bits`` is the normal read bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(bits * 100 + draft_bits * 10 + d)
    g = 4 if d == 128 else 1
    v_off = 2.0 * torch.randn(d, generator=gen, device=cuda)
    packed = _packed(gen, cuda, b=2, h=2, nb=4, block_n=128, d=d, bits=bits, k_gran=k_gran,
                     v_off=v_off)
    q = randn(gen, (2, 2, g, d), cuda)
    k_res = randn(gen, (2, 2, res_n, d), cuda)
    v_res = (randn(gen, (2, 2, res_n, d), cuda) + v_off).to(torch.bfloat16)
    pb, rl = [4, 3], [res_n - 1, 100]
    ints = functools.partial(torch.tensor, dtype=torch.int32, device=cuda)
    kw = dict(bits=bits, block_n=128, k_gran=k_gran, return_lse=True)
    order = torch.randperm(8, generator=gen, device=cuda)
    pools = [torch.empty_like(p).index_copy_(0, order, p) for p in _pools(packed)]
    table = order.reshape(2, 4).to(torch.int32)
    calls = {
        "dense": lambda kr, vr, **x: bd_ops.bitdecode_attention(
            q, *packed, kr, vr, ints(pb), ints(rl), **kw, **x),
        "paged": lambda kr, vr, **x: pg_ops.paged_bitdecode_attention(
            q, *pools, kr, vr, table, ints(pb), ints(rl), **kw, **x),
    }
    k_zero, v_zero = k_res.clone(), v_res.clone()
    for t in (k_zero, v_zero):
        t[0, :, rl[0]:] = 0
        t[1, :, rl[1]:] = 0
    for name, call in calls.items():
        for ns in (1, 3, "auto"):
            out_k, lse_k = call(k_res, v_res, impl="cuda", num_splits=ns, draft_bits=draft_bits)
            out_r, lse_r = call(k_res, v_res, impl="torch", num_splits=1, draft_bits=draft_bits)
            _assert_decode_close(out_k, lse_k, out_r, lse_r, pb, rl)
            zeroed = call(k_zero, v_zero, impl="cuda", num_splits=ns, draft_bits=draft_bits)
            assert torch.equal(zeroed[0], out_k) and torch.equal(zeroed[1], lse_k), (name, ns)
        full = call(k_res, v_res, impl="cuda", num_splits=3)
        same = call(k_res, v_res, impl="cuda", num_splits=3, draft_bits=bits)
        assert torch.equal(full[0], same[0]) and torch.equal(full[1], same[1]), name
        assert not torch.equal(full[0], call(k_res, v_res, impl="cuda", num_splits=3,
                                             draft_bits=draft_bits)[0])


def test_entry_points_default_to_the_card(cuda):
    m = build_model(smoke_config("llama3-8b"))
    assert m.init_decode_state(1, 64)["caches"][0].kw.is_cuda
    assert m.init(torch.Generator().manual_seed(0))["embed"]["table"].is_cuda


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-7b", "starcoder2-3b", "command-r-35b",
                                  "qwen3-moe-235b-a22b"])
def test_smoke_model_kernels_match_plain(cuda, arch):
    """Ragged prefill (one full block in row 0) + 30 decode steps (each row
    flushes once) of the smoke model: kernels vs plain versions, same token
    stream; layer 0's packed cache equal bit for bit."""
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    lengths = torch.tensor([100, 60], dtype=torch.int32, device=cuda)

    def run(impl, feed=None):
        logits, state = model.prefill(params, {"tokens": tokens}, 256,
                                      lengths=lengths, impl=impl, quant_impl=impl)
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
    assert min(_build.launches[k] for k in ("kv_quant", "residual_flush", "bitdecode",
                                            "flash_prefill")) > 0
    assert _build.launches["kv_quant"] == cfg.n_layers  # K and V: one launch a layer
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=3e-1)
    ct, ck = s_t["caches"][0], s_k["caches"][0]
    assert torch.equal(ct.pack_blocks, ck.pack_blocks) and torch.equal(ct.res_len, ck.res_len)
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
        np.testing.assert_array_equal(bits_of(getattr(ck, f)[0]), bits_of(getattr(ct, f)[0]))


@pytest.mark.parametrize("moe_layer", [True, False], ids=["smoke", "mla_only"])
def test_mla_smoke_model_kernels_match_plain(cuda, moe_layer):
    """The deepseek-v3 smoke model (MLA: the latent through K1-K3 in the
    shared_kv mode, the prefill through K6's padded route; a dense layer,
    then an MoE layer) as the test above: kernels vs plain versions over a
    ragged prefill and 30 decode steps fed the plain run's tokens, the
    logits within rtol 2e-2 / atol 3e-1, layer 0's latent cache bit for
    bit.  Its one MoE layer is the last, so a step's logits depend on that
    step's routing alone: a row whose top-k set there differs between the
    runs (a near tie of the router flipped by rounding-level differences,
    as a plain run split three ways flips them; ROADMAP C) is not held to
    the logits tolerance at that step, and such rows must be few.
    ``mla_only`` (no experts: two dense layers) holds every row at every
    step."""
    from repro_torch.models import moe

    change = {} if moe_layer else dict(n_experts=0)
    cfg = smoke_config("deepseek-v3-671b").with_(**change)
    model = build_model(cfg)
    assert model.stacks == ([("mlp", 1), ("moe", 1)] if moe_layer else [("mlp", 2)])
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    lengths = torch.tensor([100, 60], dtype=torch.int32, device=cuda)
    route = moe.route

    def run(impl, feed=None):
        sets = []  # per MoE call, the sorted top-k experts

        def recorded(p, c, x):
            out = route(p, c, x)
            sets.append(out[2].sort(-1).values)
            return out

        moe.route = recorded
        try:
            logits, state = model.prefill(params, {"tokens": tokens}, 256, lengths=lengths,
                                          impl=impl, quant_impl=impl)
            out = [logits]
            for i in range(30):
                tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
                logits, state = model.decode_step(params, state, tok, impl=impl,
                                                  quant_impl=impl)
                out.append(logits)
        finally:
            moe.route = route
        return out, state, sets

    with torch.no_grad():
        out_t, s_t, sets_t = run("torch")
        _build.launches.clear()
        out_k, s_k, sets_k = run("auto", [o[:, -1].argmax(-1)[:, None] for o in out_t])
    assert min(_build.launches[k] for k in ("kv_quant", "residual_flush", "bitdecode",
                                            "flash_prefill")) > 0
    assert _build.launches["kv_quant"] == cfg.n_layers  # the latent: one launch a layer
    assert len(sets_k) == len(sets_t) == (31 if moe_layer else 0)
    compared = 0
    for i, (a, b) in enumerate(zip(out_k, out_t)):
        rows = torch.ones(2, dtype=torch.bool, device=cuda)
        if moe_layer:  # the set of the token whose logits these are
            at = lengths.long() - 1 if i == 0 else torch.zeros(2, dtype=torch.long, device=cuda)
            pick = torch.arange(2, device=cuda)
            rows = (sets_k[i][pick, at] == sets_t[i][pick, at]).all(-1)
        torch.testing.assert_close(a[rows], b[rows], rtol=2e-2, atol=3e-1, msg=f"step {i}")
        compared += int(rows.sum())
    assert compared >= 0.9 * 2 * len(out_k), compared
    ct, ck = s_t["caches"][0], s_k["caches"][0]
    assert torch.equal(ct.pack_blocks, ck.pack_blocks) and torch.equal(ct.res_len, ck.res_len)
    assert ck.vw is None and ck.shared_kv
    for f in ("kw", "k_scale", "k_zero", "k_res"):
        np.testing.assert_array_equal(bits_of(getattr(ck, f)[0]), bits_of(getattr(ct, f)[0]))


def test_padded_prefill_route_on_the_card(cuda):
    """``blockwise_attention`` on the card at MLA's head dims (d_k 192, d_v
    128: padded to the d = 256 instance): one flash_prefill launch, within
    the kernel's tolerance (out 3e-2) of the plain loop on the unpadded
    inputs; an instance's own dims take no padding."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, s, h = 2, 300, 8
    q, k = randn(gen, (b, s, h, 192), cuda), randn(gen, (b, s, h, 192), cuda)
    v = (randn(gen, (b, s, h, 128), cuda) + 2.0 * torch.randn(128, generator=gen, device=cuda)
         ).to(torch.bfloat16)
    scale = 1.0 / 192**0.5
    _build.launches.clear()
    got = catt.blockwise_attention(q, k, v, sm_scale=scale, impl="cuda")
    assert dict(_build.launches) == {"flash_prefill": 1} and tuple(got.shape) == (b, s, h, 128)
    want = catt.blockwise_attention(q, k, v, sm_scale=scale, impl="torch")
    torch.testing.assert_close(got.float(), want, rtol=3e-2, atol=3e-2)
    assert catt.padded_head_dim(128, 128) == 128 and catt.padded_head_dim(64, 32) == 64


# ------------------------------------------------------------ flash prefill

FLASH_CASES = [  # (B, Hq, Hkv, S, d, causal)
    (2, 4, 4, 48, 32, True),      # shorter than one tile, MHA
    (2, 8, 2, 500, 64, True),     # ragged S, g = 4
    (1, 24, 2, 300, 128, True),   # g = 12
    (2, 4, 4, 200, 256, True),    # d = 256, g = 1
    (1, 8, 2, 1900, 128, False),  # full attention
    (1, 4, 1, 130, 256, False),
    # S around the 64-row warpgroup and the 128-row KV tile edges
    (1, 12, 1, 1, 64, True),      # one row, g = 12
    (2, 24, 2, 63, 32, True),     # d = 32 (one zero-filled 64-channel box), g = 12
    (1, 4, 2, 64, 128, True),
    (2, 4, 4, 65, 256, True),     # d = 256: 64-row KV tiles
    (1, 24, 2, 127, 64, False),   # d = 64, g = 12
    (1, 8, 8, 128, 128, True),
    (2, 24, 2, 129, 32, True),
    (1, 2, 1, 2100, 256, True),   # many KV tiles, ragged, the wide head
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_prefill_kernel_matches_plain(cuda, case, layout):
    """Per-channel V offsets keep the output O(1) beside the tolerance."""
    b, hq, hkv, s, d, causal = case
    gen = torch.Generator(device=cuda).manual_seed(hq * s + d)
    shape = (lambda h: (b, h, s, d)) if layout == "bhsd" else (lambda h: (b, s, h, d))
    q, k = randn(gen, shape(hq), cuda), randn(gen, shape(hkv), cuda)
    v = (randn(gen, shape(hkv), cuda) + 2.0 * torch.randn(d, generator=gen, device=cuda)
         ).to(torch.bfloat16)
    fn = functools.partial(fp_ops.flash_prefill_attention, q, k, v, causal=causal,
                           layout=layout, return_lse=True)
    out_k, lse_k = fn(impl="cuda")
    out_r, lse_r = fn(impl="torch")
    assert out_k.shape == out_r.shape and out_r.float().abs().amax() > 0.5
    torch.testing.assert_close(out_k.float(), out_r.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(lse_k, lse_r, rtol=1e-3, atol=1e-3)


def test_flash_prefill_reads_head_slices_of_a_fused_buffer(cuda):
    """q, k and v as strided head slices of one [B, S, Hq + 2 Hkv, d]
    projection: read through their strides (no copy: one launch, nothing
    else), the same as on contiguous copies."""
    b, s, hq, hkv, d = 2, 300, 8, 2, 128
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = randn(gen, (b, s, hq + 2 * hkv, d), cuda)
    q, k, v = qkv[:, :, :hq], qkv[:, :, hq:hq + hkv], qkv[:, :, hq + hkv:]
    assert not q.is_contiguous() and fp_ops._kernel_operand(k).data_ptr() == k.data_ptr()
    _build.launches.clear()
    out, lse = fp_ops.flash_prefill_attention(q, k, v, layout="bshd", impl="cuda",
                                              return_lse=True)
    assert dict(_build.launches) == {"flash_prefill": 1}
    out_c, lse_c = fp_ops.flash_prefill_attention(
        *(x.contiguous() for x in (q, k, v)), layout="bshd", impl="cuda", return_lse=True)
    np.testing.assert_array_equal(bits_of(out), bits_of(out_c))
    torch.testing.assert_close(lse, lse_c, rtol=0, atol=0)


@pytest.mark.parametrize("d", [64, 256])
def test_flash_prefill_launches_once_per_call_whatever_the_ctas(cuda, monkeypatch, d):
    """One launch per call; the result is the same bit for bit with one CTA
    walking every work tile, one per SM and one per work tile (the KV ring
    runs on across work tiles, heaviest first)."""
    b, hq, hkv, s = 2, 4, 2, 700
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, k, v = (randn(gen, (b, s, h, d), cuda) for h in (hq, hkv, hkv))
    outs = []
    n = fp_ops.work_tiles(b, hq, s)
    for ctas in (1, 5, n):
        monkeypatch.setattr(fp_ops, "launch_ctas", lambda *a, c=ctas: c)
        _build.launches.clear()
        outs.append(fp_ops.flash_prefill_attention(q, k, v, layout="bshd", impl="cuda",
                                                   return_lse=True))
        assert _build.launches["flash_prefill"] == 1
    for out, lse in outs[1:]:
        np.testing.assert_array_equal(bits_of(out), bits_of(outs[0][0]))
        torch.testing.assert_close(lse, outs[0][1], rtol=0, atol=0)


def test_blockwise_attention_takes_the_kernel_on_the_card(cuda):
    """'auto' on CUDA tensors launches the kernel on the model's layout;
    'torch' is the plain loop; S != T raises rather than fall back."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (randn(gen, (2, 100, h, 64), cuda) for h in (8, 2, 2))
    _build.launches.clear()
    out_k = catt.blockwise_attention(q, k, v)
    assert _build.launches["flash_prefill"] == 1 and out_k.dtype == torch.bfloat16
    out_r = catt.blockwise_attention(q, k, v, impl="torch", block_k=64)
    torch.testing.assert_close(out_k.float(), out_r, rtol=3e-2, atol=3e-2)
    with pytest.raises(ValueError, match="S == T"):
        catt.blockwise_attention(q[:, :50], k, v)


def test_flash_prefill_refuses_autograd(cuda):
    """K6 has no backward: under autograd its route raises, naming the
    plain one, and launches nothing; the plain loop gives every input a
    gradient; without grad (or with no input requiring it) the kernel runs.
    A training step on the card therefore never reaches K6."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (randn(gen, (1, 64, h, 64), cuda) for h in (4, 2, 2))
    wq = q.clone().requires_grad_()
    _build.launches.clear()
    for impl in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="impl='torch'"):
            catt.blockwise_attention(wq, k, v, impl=impl)
    assert _build.launches.get("flash_prefill", 0) == 0
    out = catt.blockwise_attention(wq, k, v, impl="torch", block_k=32)
    out.sum().backward()
    assert wq.grad is not None and torch.isfinite(wq.grad).all() and wq.grad.abs().sum() > 0
    with torch.no_grad():
        catt.blockwise_attention(wq, k, v)
    catt.blockwise_attention(q, k, v)
    assert _build.launches["flash_prefill"] == 2


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v3-671b", "zamba2-7b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model's loss and gradients on the card within the CPU
    tests' bounds against JAX (2e-3 relative, 3e-2 relative L2 a leaf) of
    the same code on the CPU, the parameters drawn once on the CPU.  One
    leaf alone may pass 3e-2: zamba2's tail dt_bias, whose 64 terms nearly
    cancel, held to its largest rounding witness (how far it moves, on the
    card and on the CPU, with one bf16 ulp added to every 101st or every
    13th parameter; ROADMAP C, scripts/train_grad_spread.py).  Then one
    train step with the config's optimizer and microbatches; no kernel of
    K1-K6 launched."""
    def rel(a, b):
        return ((a.float().cpu() - b.float().cpu()).norm()
                / b.float().cpu().norm().clamp_min(1e-30)).item()

    def nudged(t, every):
        if t.dtype != torch.bfloat16:
            return t.clone()
        words = t.clone().view(torch.int16).reshape(-1)
        words[::every] += 1
        return words.view(torch.bfloat16).reshape(t.shape)

    cfg = smoke_config(arch)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, ShapeSpec("t", 32, 2, "train"), step=3, device="cpu")
    loss_c, g_c = value_and_grad(model.loss, cpu, batch)
    params = tr.map_leaves(lambda t: t.to(cuda), cpu)
    _build.launches.clear()
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    loss_g, g_g = value_and_grad(model.loss, params, on_card)
    assert abs(loss_g.item() - loss_c.item()) <= 2e-3 * abs(loss_c.item())
    names = [".".join(map(str, path)) for path, _ in tr.leaves_with_paths(cpu)]
    named = "tail.mixer.dt_bias" if arch == "zamba2-7b" else None
    for name, a, b in zip(names, g_g, g_c):
        assert a.is_cuda
        gap = rel(a, b)
        if name != named:
            assert gap <= 3e-2, (name, gap)
            continue
        i = names.index(named)
        witness = max(rel(value_and_grad(model.loss, tr.map_leaves(
            lambda t: nudged(t, every), ps), bt)[1][i], ref)
            for every in (101, 13)
            for ps, bt, ref in ((params, on_card, a), (cpu, batch, b)))
        assert gap <= 3e-2 or gap <= witness, (name, gap, witness)
    opt = get_optimizer(cfg.optimizer)
    state, m = make_train_step(model, opt, microbatches=cfg.microbatches)(
        TrainState(params, opt.init(params), 0),
        make_batch(cfg, ShapeSpec("t", 32, 8, "train"), device=cuda))
    assert state.step == 1 and torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert not any(_build.launches.values()), dict(_build.launches)


# (B, Hq, Hkv, S, T, d): full attention with a key length of its own
CROSS_CASES = [
    (4, 16, 16, 100, 4096, 64),  # seamless-m4t-medium's cross prefill: S < one q-tile
    (2, 8, 2, 300, 1000, 128),   # a ragged T (not a multiple of the 128-key tile), g 4
    (2, 8, 8, 2048, 512, 128),   # S > T
    (2, 12, 1, 7, 300, 32),      # S < 16, d 32, g 12
    (2, 8, 2, 200, 50, 128),     # T < one KV tile
    (1, 4, 4, 130, 70, 256),     # d 256: 64-key tiles, T ragged over two
    (1, 4, 2, 1, 1, 64),         # one query over one key
]


@pytest.mark.parametrize("case", CROSS_CASES)
@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
def test_flash_prefill_cross_mode_matches_plain(cuda, case, layout):
    """K6's full mode at S != T (an encoder-decoder's cross attention)
    against its plain version, out 3e-2 / lse 1e-3; one launch a call."""
    b, hq, hkv, s, t, d = case
    gen = torch.Generator(device=cuda).manual_seed(hq * s + t + d)
    shape = (lambda h, n: (b, h, n, d)) if layout == "bhsd" else (lambda h, n: (b, n, h, d))
    q, k = randn(gen, shape(hq, s), cuda), randn(gen, shape(hkv, t), cuda)
    v = (randn(gen, shape(hkv, t), cuda) + 2.0 * torch.randn(d, generator=gen, device=cuda)
         ).to(torch.bfloat16)
    fn = functools.partial(fp_ops.flash_prefill_attention, q, k, v, causal=False,
                           layout=layout, return_lse=True)
    _build.launches.clear()
    out_k, lse_k = fn(impl="cuda")
    assert dict(_build.launches) == {"flash_prefill": 1}
    out_r, lse_r = fn(impl="torch")
    assert out_k.shape == out_r.shape == q.shape and lse_k.shape == (b, hq, s)
    assert out_r.float().abs().amax() > 0.5
    torch.testing.assert_close(out_k.float(), out_r.float(), rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(lse_k, lse_r, rtol=1e-3, atol=1e-3)


def test_flash_prefill_cross_mode_through_blockwise_attention(cuda):
    """``blockwise_attention(causal=False)`` at S != T takes the kernel
    (one launch, bf16) on the model's layout and matches the plain loop."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = randn(gen, (2, 100, 16, 64), cuda), *(randn(gen, (2, 700, 16, 64), cuda)
                                                     for _ in range(2))
    _build.launches.clear()
    out_k = catt.blockwise_attention(q, k, v, causal=False)
    assert dict(_build.launches) == {"flash_prefill": 1} and out_k.dtype == torch.bfloat16
    out_r = catt.blockwise_attention(q, k, v, causal=False, impl="torch", block_k=128)
    torch.testing.assert_close(out_k.float(), out_r, rtol=3e-2, atol=3e-2)


def test_flash_prefill_cross_refuses_causal_at_s_ne_t(cuda):
    """Causal attention with S != T is refused by the wrapper and by the
    launcher itself (no launch counted)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k = randn(gen, (1, 50, 4, 64), cuda), randn(gen, (1, 80, 4, 64), cuda)
    _build.launches.clear()
    with pytest.raises(ValueError, match="S == T"):
        fp_ops.flash_prefill_attention(q, k, k, causal=True, layout="bshd", impl="cuda")
    with pytest.raises(ValueError, match="S == T"):
        catt.blockwise_attention(q, k, k, causal=True)
    out = torch.empty_like(q)
    lse = torch.empty((1, 4, 50), dtype=torch.float32, device=cuda)
    strides = [st for x in (q, k, k, out) for st in x.stride()[:3]]
    with pytest.raises(RuntimeError, match="flash_prefill kernel launch failed"):
        _build.launch("flash_prefill", q.data_ptr(), k.data_ptr(), k.data_ptr(), out.data_ptr(),
                      lse.data_ptr(), 1, 4, 4, 50, 80, 64, *strides, 1, 0.125, 1,
                      _build.stream_of(q))
    assert not _build.launches


def model_cross(params, cfg, mem, impl):
    """Every decoder layer's static cross cache of ``mem`` (``quant_impl``
    ``impl``)."""
    from repro_torch.models import attention as mattn

    dec = params["decoder"]["xattn"]
    return [mattn.build_cross_cache({k: w[i] for k, w in dec.items()}, cfg, mem,
                                    quant_impl=impl) for i in range(cfg.dec_layers)]


@pytest.mark.parametrize("frames", [64, 24])
def test_encdec_smoke_model_kernels_match_plain(cuda, frames):
    """The seamless smoke model (2 + 2 layers, block_n 64) over ``frames``
    stub frames (64: one packed cross block; 24: the cross cache all in its
    residual): prefill of two 100-token prompts and 30 decode steps (each
    row's self cache flushes once), kernels against the plain versions fed
    the same tokens, logits within rtol 2e-2 / atol 3e-1; the cross caches
    of one memory built by K1 and by its plain version bit for bit, and
    untouched by the decode steps; K6 once an encoder layer and twice a
    decoder layer (self, cross), K1 twice a decoder layer."""
    cfg = smoke_config("seamless-m4t-medium")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=cuda, generator=gen)
    batch = {"tokens": tokens, "frames": randn(gen, (2, frames, cfg.d_model), cuda)}

    def run(impl, feed=None):
        logits, state = model.prefill(params, batch, 160, impl=impl, quant_impl=impl)
        cross = [t.clone() for t in (state["cross"].kw, state["cross"].v_res)]
        out = [logits]
        for i in range(30):
            tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
            logits, state = model.decode_step(params, state, tok, impl=impl, quant_impl=impl)
            out.append(logits)
        assert torch.equal(cross[0], state["cross"].kw) and torch.equal(cross[1],
                                                                        state["cross"].v_res)
        return out, state

    with torch.no_grad():
        out_t, s_t = run("torch")
        _build.launches.clear()
        out_k, s_k = run("auto", [o[:, -1].argmax(-1)[:, None] for o in out_t])
        launches = dict(_build.launches)
        mem = model.encode(params, batch["frames"])
        caches = [model_cross(params, cfg, mem, impl) for impl in ("cuda", "torch")]
    assert min(launches.get(k, 0) for k in ("kv_quant", "residual_flush", "bitdecode",
                                            "flash_prefill")) > 0
    assert launches["flash_prefill"] == cfg.enc_layers + 2 * cfg.dec_layers
    assert launches["kv_quant"] == (2 if frames >= cfg.kv_block else 1) * cfg.dec_layers
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=3e-1)
    ct, ck = s_t["self"], s_k["self"]
    assert torch.equal(ct.pack_blocks, ck.pack_blocks) and ck.pack_blocks[0].tolist() == [2, 2]
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
        np.testing.assert_array_equal(bits_of(getattr(ck, f)[0]), bits_of(getattr(ct, f)[0]))
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
              "pack_blocks", "res_len"):
        for a, b in zip(*caches):
            np.testing.assert_array_equal(bits_of(getattr(a, f)), bits_of(getattr(b, f)))


def test_vlm_smoke_model_kernels_match_plain(cuda):
    """The qwen2-vl smoke model (16 patches on a 4 x 4 grid, M-RoPE,
    block_n 64) with ragged text of 100 and 90 tokens: prefill and 30
    decode steps (each row's cache flushes once), kernels against the plain
    versions fed the same tokens; pos and the cache lengths count the
    patches; layer 0's packed cache bit for bit."""
    cfg = smoke_config("qwen2-vl-7b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 100), device=cuda, generator=gen),
             "patches": randn(gen, (2, cfg.n_patches, cfg.d_model), cuda)}
    lengths = torch.tensor([100, 90], dtype=torch.int32, device=cuda)

    def run(impl, feed=None):
        logits, state = model.prefill(params, batch, 256, lengths=lengths, impl=impl,
                                      quant_impl=impl)
        assert state["pos"].tolist() == [116, 106]
        out = [logits]
        for i in range(30):
            tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
            logits, state = model.decode_step(params, state, tok, impl=impl, quant_impl=impl)
            out.append(logits)
        return out, state

    with torch.no_grad():
        out_t, s_t = run("torch")
        _build.launches.clear()
        out_k, s_k = run("auto", [o[:, -1].argmax(-1)[:, None] for o in out_t])
    assert min(_build.launches[k] for k in ("kv_quant", "residual_flush", "bitdecode",
                                            "flash_prefill")) > 0
    assert _build.launches["kv_quant"] == _build.launches["flash_prefill"] == cfg.n_layers
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=3e-1)
    ct, ck = s_t["caches"][0], s_k["caches"][0]
    assert ck.pack_blocks[0].tolist() == [2, 2] and torch.equal(ct.res_len, ck.res_len)
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
        np.testing.assert_array_equal(bits_of(getattr(ck, f)[0]), bits_of(getattr(ct, f)[0]))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "qwen2-vl-7b"])
@pytest.mark.parametrize("paged", [None, False])
def test_encdec_and_vlm_engine_refuses_on_the_card(cuda, arch, paged):
    """The engine refuses both families with the JAX engine's ValueError."""
    model = build_model(smoke_config(arch))
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    with pytest.raises(ValueError, match="serveable cache family"):
        ServeEngine(model, params, slots=2, max_seq=128, paged=paged, device=cuda)


# ------------------------------------------------------------ paged kernels


def _pools(packed):
    """Dense [B, H, nb, ...] fields -> pools [B * nb, H, ...] in which row b's
    block j is page b * nb + j."""
    return [x.movedim(2, 1).reshape(-1, *x.shape[1:2], *x.shape[3:]).contiguous()
            for x in packed]


PAGED_CASES = [  # (g, d, block_n, bits, k_gran, pack_blocks, res_len)
    (4, 128, 128, 4, "channel", [5, 3], [17, 0]),
    (4, 128, 128, 2, "tensor", [0, 6], [128, 1]),  # a row with no packed block
    (4, 128, 128, 8, "channel", [6, 6], [0, 127]),
    (2, 32, 64, 4, "tensor", [2, 6], [5, 64]),
    (8, 128, 128, 4, "channel", [6, 1], [0, 128]),  # fewer blocks than splits, full residual
    (12, 128, 128, 8, "tensor", [3, 5], [90, 16]),
    (1, 256, 128, 4, "channel", [2, 6], [128, 33]),
    (2, 64, 64, 2, "channel", [6, 2], [33, 0]),
    (4, 32, 64, 8, "tensor", [5, 0], [64, 0]),  # pack_blocks 0 with res_len 0
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("num_splits", [1, 3, "auto"])
def test_paged_bitdecode_kernel_matches_plain(cuda, case, num_splits):
    """Scrambled table over a pool of 16 pages, O(1) outputs."""
    g, d, block_n, bits, k_gran, pb, rl = case
    gen = torch.Generator(device=cuda).manual_seed(g * d + bits)
    args = _decode_args(gen, cuda, g, d, block_n, bits, k_gran, pb, rl, 1.0)
    q, packed, res, lens = args[0], args[1:7], args[7:9], args[9:]
    v_off = 2.0 * torch.randn(d, generator=gen, device=cuda)
    pool = _pools(_packed(gen, cuda, b=4, h=2, nb=4, block_n=block_n, d=d, bits=bits,
                          k_gran=k_gran, v_off=v_off))
    res[1] = (res[1] + v_off).to(torch.bfloat16)
    table = torch.randperm(16, generator=gen, device=cuda)[:12].reshape(2, 6).to(torch.int32)
    fn = functools.partial(pg_ops.paged_bitdecode_attention, q, *pool, *res, table, *lens,
                           bits=bits, block_n=block_n, k_gran=k_gran, return_lse=True)
    out_k, lse_k = fn(impl="cuda", num_splits=num_splits)
    out_r, lse_r = fn(impl="torch", num_splits=1)
    _assert_decode_close(out_k, lse_k, out_r, lse_r, pb, rl)


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("num_splits", [1, 3])
def test_paged_bitdecode_equals_bitdecode_on_identity_table(cuda, case, num_splits):
    """The pool laid out as the dense cache, the identity table: the two
    kernels share one body and agree bit for bit."""
    g, d, block_n, bits, k_gran = case[:5]
    gen = torch.Generator(device=cuda).manual_seed(g * d)
    q, *packed, k_res, v_res, pb, rl = _decode_args(gen, cuda, *case)
    b, nb = q.shape[0], packed[0].shape[2]
    table = torch.arange(b * nb, dtype=torch.int32, device=cuda).reshape(b, nb)
    kw = dict(bits=bits, block_n=block_n, k_gran=k_gran, return_lse=True,
              num_splits=num_splits, impl="cuda")
    out_d, lse_d = bd_ops.bitdecode_attention(q, *packed, k_res, v_res, pb, rl, **kw)
    out_p, lse_p = pg_ops.paged_bitdecode_attention(q, *_pools(packed), k_res, v_res,
                                                    table, pb, rl, **kw)
    assert torch.equal(out_p, out_d) and torch.equal(lse_p, lse_d)


@pytest.mark.parametrize("num_splits", [1, 3, "auto"])
def test_decode_call_is_at_most_two_launches(cuda, num_splits):
    """One kernel launch, and the merge's when there is more than one
    split: nothing else on the card (pack_blocks and res_len already int32)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, *packed, k_res, v_res, pb, rl = _decode_args(gen, cuda, *DECODE_CASES[2])
    b, nb = q.shape[0], packed[0].shape[2]
    table = torch.arange(b * nb, dtype=torch.int32, device=cuda).reshape(b, nb)
    kw = dict(bits=4, block_n=128, k_gran="channel", num_splits=num_splits)
    for name, call in (("bitdecode", lambda: bd_ops.bitdecode_attention(
            q, *packed, k_res, v_res, pb, rl, **kw)),
                       ("paged_bitdecode", lambda: pg_ops.paged_bitdecode_attention(
            q, *_pools(packed), k_res, v_res, table, pb, rl, **kw))):
        call()  # the occupancy query and the build happen once, before
        torch.cuda.synchronize()
        _build.launches.clear()
        call()
        launched = dict(_build.launches)
        assert launched.get(name) == 1 and sum(launched.values()) <= 2, launched
        if num_splits == 1:
            assert launched == {name: 1}
        if num_splits == 3:
            assert launched == {name: 1, "bitdecode_merge": 1}


@pytest.mark.parametrize("change", [dict(g=17), dict(d=48), dict(d=96)])
def test_decode_kernel_refuses_shapes_it_has_no_instance_for(cuda, change):
    """g above one tile's 16 rows (split K/V), or a head dim outside 32, 64,
    128, 256: ValueError from the wrapper, before any launch."""
    g, d = change.get("g", 4), change.get("d", 128)
    gen = torch.Generator(device=cuda).manual_seed(6)
    args = _decode_args(gen, cuda, g, d, 64, 4, "channel", [2, 1], [3, 4], 1.0)
    q, packed, res, lens = args[0], args[1:7], args[7:9], args[9:]
    table = torch.arange(8, dtype=torch.int32, device=cuda).reshape(2, 4)
    _build.launches.clear()
    with pytest.raises(ValueError, match="the CUDA decode kernel takes"):
        bd_ops.bitdecode_attention(*args, bits=4, block_n=64, impl="cuda")
    with pytest.raises(ValueError, match="the CUDA decode kernel takes"):
        pg_ops.paged_bitdecode_attention(q, *_pools(packed), *res, table, *lens, bits=4,
                                         block_n=64, impl="cuda")
    assert not _build.launches


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
def test_paged_residual_flush_kernel_matches_plain_bitwise(cuda, bits, k_gran):
    """Mixed ``full``, one destination past the pool (clamped); every page
    that is not a full row's destination comes back unchanged."""
    gen = torch.Generator(device=cuda).manual_seed(bits)
    pool = _pools(_packed(gen, cuda, b=2, h=2, nb=6, block_n=128, d=128, bits=bits,
                          k_gran=k_gran))
    res = [randn(gen, (4, 2, 128, 128), cuda) for _ in range(2)]
    full = torch.tensor([1, 0, 1, 1], dtype=torch.int32, device=cuda)
    dest = torch.tensor([7, 1, 4, 40], dtype=torch.int32, device=cuda)  # 40 -> page 11
    kw = dict(bits=bits, block_n=128, k_gran=k_gran)
    before = [p.clone() for p in pool]
    twin = [p.clone() for p in pool]
    out = rf_ops.paged_residual_flush(*pool, *res, full, dest, impl="cuda", **kw)
    ref = rf_ops.paged_residual_flush(*twin, *res, full, dest, impl="torch", **kw)
    written = torch.tensor([7, 4, 11], device=cuda)
    kept = torch.tensor([p for p in range(12) if p not in (7, 4, 11)], device=cuda)
    for o, r, b0 in zip(out, ref, before):
        np.testing.assert_array_equal(bits_of(o), bits_of(r))
        assert torch.equal(o[kept], b0[kept])
        assert not torch.equal(o[written], b0[written])


def test_small_engine_kernels_match_plain(cuda):
    """The serving engine on the card, the smoke model: kernels against
    ``impl="torch"``, fed the plain run's tokens; the same schedule, pool and
    page-table bookkeeping, logits within the decode tolerance, and both
    paged kernels launched."""
    cfg = smoke_config("llama3-8b").with_(kv_block=32)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = np.random.default_rng(0)
    base = rng.integers(0, cfg.vocab, 70).astype(np.int32)
    prompts = [base, np.concatenate([base[:64], rng.integers(0, cfg.vocab, 30)]),
               base[:10].copy(), rng.integers(0, cfg.vocab, 45).astype(np.int32)]
    rec = []

    def run(impl, feed=None):
        eng = ServeEngine(model, params, slots=3, max_seq=192, impl=impl, quant_impl=impl,
                          audit_every=1)
        step = eng._step

        def wrapped(p, s, t):
            if feed is not None:
                t = feed[len(rec)]
            logits, s = step(p, s, t)
            rec.append((t.clone(), logits.clone()))
            return logits, s
        eng._step = wrapped
        reqs = [Request(uid=i, prompt=p, max_new_tokens=40) for i, p in enumerate(prompts)]
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run()
        return eng, reqs

    with torch.no_grad():
        plain, _ = run("torch")
        plain_rec, rec[:] = list(rec), []
        _build.launches.clear()
        kern, reqs = run("auto", [t for t, _ in plain_rec])
    assert min(_build.launches[k] for k in ("paged_bitdecode", "paged_residual_flush",
                                            "flash_prefill")) > 0
    assert all(r.done for r in reqs)
    assert np.array_equal(kern._table, plain._table)
    assert kern.pool.free_pages() == plain.pool.free_pages()
    assert kern.stats == plain.stats and kern.sched.stats == plain.sched.stats
    assert kern.sched.stats["prefix_hit_blocks"] > 0 and kern.stats["cow_copies"] > 0
    for (_, lk), (_, lp) in zip(rec, plain_rec):
        torch.testing.assert_close(lk, lp, rtol=2e-2, atol=3e-1)


# ------------------------------------------- residual_flush, mode "append"


def _append_state(gen, device, *, paged, b, h, d, block_n, bits, k_gran):
    """A cache mid-run: random packed blocks (or pools behind a scrambled
    table of 4 columns), random residuals, res_len in [0, block_n),
    pack_blocks in {0, 1}.  Returns (arrays, lengths) in the order the
    append entry points take them around k_new / v_new."""
    nb = 6
    packed = _packed(gen, device, b=b, h=h, nb=nb, block_n=block_n, d=d, bits=bits,
                     k_gran=k_gran)
    res = [randn(gen, (b, h, block_n, d), device) for _ in range(2)]
    ints = functools.partial(torch.randint, generator=gen, device=device, dtype=torch.int32)
    lens = [ints(0, 2, (b,)), ints(0, block_n, (b,)), torch.zeros(b, dtype=torch.int32,
                                                                  device=device)]
    if not paged:
        return packed + res, lens
    n_pages = b * nb
    table = (b + torch.randperm(n_pages - b, generator=gen, device=device)[: b * 4]
             ).reshape(b, 4).to(torch.int32)
    return _pools(packed) + res, [table, *lens]


def _new_tokens(gen, device, b, h, d):
    """k_new / v_new [B, H, 1, d] as the model passes them: strided views
    (a transposed [B, 1, H, d], the second half of a wider buffer)."""
    k = randn(gen, (b, 1, h, d), device).transpose(1, 2)
    v = randn(gen, (b, 1, 2 * h, d), device)[:, :, h:].transpose(1, 2)
    return k, v


@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("block_n", [64, 128])
@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_append_kernel_matches_plain_bitwise(cuda, paged, d, block_n, bits, k_gran):
    """Mode "append" against its plain version over 3 * block_n - 10
    consecutive steps, every array and length compared after every step:
    row 0 appends every step (2-3 flushes, so the counter works again and
    again), row 1 is masked every third step, row 2 is frozen throughout;
    B * H = 9 rows is not a multiple of the group count."""
    b, h = 3, 3
    gen = torch.Generator(device=cuda).manual_seed(d + block_n + bits)
    arrays, lens = _append_state(gen, cuda, paged=paged, b=b, h=h, d=d, block_n=block_n,
                                 bits=bits, k_gran=k_gran)
    twin_a, twin_l = [x.clone() for x in arrays], [x.clone() for x in lens]
    start_a, start_l = [x.clone() for x in arrays], [x.clone() for x in lens]
    fn = rf_ops.paged_append_flush if paged else rf_ops.append_flush
    kw = dict(bits=bits, block_n=block_n, k_gran=k_gran)
    for step in range(3 * block_n - 10):
        k_new, v_new = _new_tokens(gen, cuda, b, h, d)
        mask = torch.tensor([True, step % 3 != 1, False], device=cuda)
        fn(*arrays, k_new, v_new, *lens, mask=mask, impl="cuda", **kw)
        fn(*twin_a, k_new, v_new, *twin_l, mask=mask, impl="torch", **kw)
        for i, (x, y) in enumerate(zip(arrays + lens, twin_a + twin_l)):
            assert torch.equal(x, y), f"field {i} differs after step {step}"
    flushes = (lens[-3] - start_l[-3]).tolist()
    assert flushes[0] >= 2 and flushes[1] >= 1 and flushes[2] == 0, flushes
    assert not lens[-1].any()  # the counter is back at zero
    for x, x0 in zip(arrays[-2:] + lens[-3:-1], start_a[-2:] + start_l[-3:-1]):
        assert torch.equal(x[2], x0[2])  # the frozen row's residual and lengths
    if not paged:  # and its packed blocks
        assert all(torch.equal(x[2], x0[2]) for x, x0 in zip(arrays[:6], start_a[:6]))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_append_decode_is_one_launch(cuda, paged, with_mask):
    """A layer's cache update in a decode step is one kernel on the card
    (the profiler's count of device kernels), counted under the flush's
    name, with no host read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, h, d = 4, 8, 128
    if paged:
        cache = qcache.init_paged_cache(40, b, h, d, 8, device=cuda)
        append, name = qcache.paged_append_decode, "paged_residual_flush"
    else:
        cache = qcache.init_cache(b, h, d, 512, device=cuda)
        append, name = qcache.append_decode, "residual_flush"
    gen = torch.Generator(device=cuda).manual_seed(1)
    mask = torch.tensor([True, False, True, True], device=cuda) if with_mask else None
    append(cache, *_new_tokens(gen, cuda, b, h, d), mask=mask)  # warm-up
    k_new, v_new = _new_tokens(gen, cuda, b, h, d)
    torch.cuda.synchronize()
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        append(cache, k_new, v_new, mask=mask)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    assert dict(_build.launches) == {name: 1}
    assert sum(kernels.values()) == 1 and "residual_flush" in next(iter(kernels)), kernels
    assert cache.res_len.tolist() == ([2, 0, 2, 2] if with_mask else [2] * b)


def test_prefill_layer_quantizes_k_and_v_in_one_launch(cuda):
    """A layer's prefill fills the packed cache with one device kernel: the
    pair's launch, no copy around it.  (Profiled with CPU and CUDA
    activities, after the append tests' CUDA-only profiles: with torch 2.11,
    a CUDA-only profile followed by much other work leaves the later
    CUDA-only profiles of the process without device events.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b, h, d, block_n, n_full = 4, 8, 128, 128, 3
    gen = torch.Generator(device=cuda).manual_seed(3)
    k = randn(gen, (b, n_full * block_n + 5, h, d), cuda).transpose(1, 2)
    v = randn(gen, (b, n_full * block_n + 5, h, d), cuda).transpose(1, 2)
    cache = qcache.init_cache(b, h, d, 4 * block_n, device=cuda)
    qcache._quantize_full_region(cache, k, v, n_full, "auto")  # warm-up: the build
    torch.cuda.synchronize()
    _build.launches.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        qcache._quantize_full_region(cache, k, v, n_full, "auto")
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    assert dict(_build.launches) == {"kv_quant": 1}
    assert sum(kernels.values()) == 1 and "kv_quant" in next(iter(kernels)), kernels
    _build.launches.clear()
    qcache.prefill(cache, k, v)
    assert _build.launches["kv_quant"] == 1


@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("d", [128, 256])
def test_appended_block_equals_kv_quant_block(cuda, d, bits, k_gran):
    """Two blocks appended token by token through the kernel's append mode
    are bitwise the blocks K1 packs from the same tokens."""
    b, h, block_n = 2, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(bits)
    k, v = (randn(gen, (b, h, 2 * block_n, d), cuda) for _ in range(2))
    cache = qcache.init_cache(b, h, d, 3 * block_n, bits=bits, block_n=block_n, k_gran=k_gran,
                              device=cuda)
    for t in range(2 * block_n):
        qcache.append_decode(cache, k[:, :, t:t + 1], v[:, :, t:t + 1], quant_impl="cuda")
    assert cache.pack_blocks.tolist() == [2] * b and cache.res_len.tolist() == [0] * b
    kq = kq_ops.quantize_kv(k, bits, k_gran, block_n=block_n, impl="cuda")
    vq = kq_ops.quantize_kv(v, bits, "tensor", block_n=block_n, impl="cuda")
    for got, want in zip((cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale,
                          cache.v_zero), (*kq, *vq)):
        np.testing.assert_array_equal(bits_of(got[:, :, :2]), bits_of(want))


def test_append_kernel_refuses_what_it_cannot_take(cuda):
    """A head dim outside its 8-channel chunks, and CPU lengths beside CUDA
    arrays, raise: no fallback to the plain version."""
    cache = qcache.init_cache(2, 2, 48, 256, device=cuda)
    k_new = torch.zeros((2, 2, 1, 48), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        qcache.append_decode(cache, k_new, k_new)
    qcache.append_decode(cache, k_new, k_new, quant_impl="torch")
    cache = qcache.init_cache(2, 2, 64, 256, device=cuda)
    cache.res_len = cache.res_len.cpu()
    k_new = torch.zeros((2, 2, 1, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        qcache.append_decode(cache, k_new, k_new)


# ------------------------------------- the async runtime's captured decode step


def _state_fields(state) -> list:
    """Every tensor of a decode state (a shared_kv cache has no V side)."""
    return [*(getattr(c, f) for c in state["caches"] for f in qcache._PAGED_FIELDS
              if getattr(c, f, None) is not None), state["pos"]]


def _decode_state(model, params, cuda, *, paged):
    """A decode state mid-run of the smoke model (block_n 32): rows of 50
    and 60 prompt tokens (18 and 28 into their residuals, so both flush
    within the steps below) and an idle row 2 (no token, no page)."""
    from repro_torch.serve import pages as pg

    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (3, 60), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(4))
    lengths = torch.tensor([50, 60, 1], dtype=torch.int32, device=cuda)
    _, dense = model.prefill(params, {"tokens": tokens}, 160, lengths=lengths)
    if not paged:
        for c in dense["caches"]:
            c.pack_blocks[:, 2] = 0
            c.res_len[:, 2] = 0
        dense["pos"][2] = 0
        return dense
    bn, nb_max = cfg.kv_block, 5
    state = model.init_paged_decode_state(3, n_pages=3 + 8, nb_max=nb_max, device=cuda)
    pg.adopt_prefill(state["caches"], dense["caches"], slot_ids=[0, 1], lengths=[50, 60],
                     pages_per_req=[[7], [4]], block_n=bn)
    table = np.arange(3, dtype=np.int32)[:, None].repeat(nb_max, 1)
    table[0, :3], table[1, :3] = [7, 9, 3], [4, 10, 8]  # flush destinations allocated
    pg.set_page_tables(state["caches"], table)
    state["pos"][:2] = torch.tensor([50, 60], dtype=torch.int32, device=cuda)
    return state


@pytest.fixture(scope="module")
def graph_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = smoke_config("llama3-8b").with_(kv_block=32)
    model = build_model(cfg)
    return model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


def _moe_smoke(**change):
    """The qwen3-moe smoke model (MoE FFNs, q/k norm), block_n 32, and its
    parameters on the card."""
    cfg = smoke_config("qwen3-moe-235b-a22b").with_(kv_block=32, **change)
    model = build_model(cfg)
    return model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


@pytest.fixture(scope="module")
def moe_graph_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _moe_smoke()


@pytest.fixture(scope="module")
def mla_graph_model():
    """The deepseek-v3 smoke model (MLA: one shared_kv latent head of 160
    channels, g 4; a dense then an MoE stack), block_n 32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = build_model(smoke_config("deepseek-v3-671b").with_(kv_block=32))
    return model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_captured_step_equals_eager_bitwise(cuda, graph_model, paged):
    """40 replays of the captured step against 40 eager steps fed the same
    tokens, from the same state: every state tensor, the argmax and the
    finite flags bit for bit after every step, over a flush on both live
    rows and an idle row.  Capture leaves the state as it found it, and
    records one launch of each of the step's kernels a layer."""
    _captured_vs_eager(cuda, *graph_model, paged)


@pytest.mark.parametrize("dense_first", [False, True], ids=["moe", "dense_first"])
def test_captured_moe_step_equals_eager_bitwise(cuda, moe_graph_model, dense_first):
    """The same over a paged state of the MoE smoke model: routing,
    dispatch and combine replay bit for bit (no host sync, no atomics);
    and of its dense-then-MoE variant, two stacks with their own pools."""
    model, params = (_moe_smoke(first_dense_layers=1, d_ff=256) if dense_first
                     else moe_graph_model)
    assert len(model.stacks) == 1 + dense_first
    _captured_vs_eager(cuda, model, params, True)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_captured_mla_step_equals_eager_bitwise(cuda, mla_graph_model, paged):
    """The same over the MLA smoke model's latent caches (dense and paged):
    the absorbed decode, K2 / K3 (K4 / K5) in their shared_kv mode."""
    _captured_vs_eager(cuda, *mla_graph_model, paged)


def _captured_vs_eager(cuda, model, params, paged):
    from repro_torch.serve.async_runtime import CapturedDecodeStep

    with torch.no_grad():
        eager, graphed = (_decode_state(model, params, cuda, paged=paged) for _ in range(2))
        for a, b in zip(_state_fields(eager), _state_fields(graphed)):
            assert torch.equal(a, b)
        before = [t.clone() for t in _state_fields(graphed)]
        step = CapturedDecodeStep(model, params, graphed)
        for a, b in zip(_state_fields(graphed), before):
            assert torch.equal(a, b)
        n = model.cfg.n_layers
        kinds = ("paged_bitdecode", "paged_residual_flush") if paged else (
            "bitdecode", "residual_flush")
        assert all(step.capture_launches[k] == n for k in kinds), step.capture_launches
        pack0 = eager["caches"][0].pack_blocks[0].clone()
        feed = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
        step.tokens.copy_(feed)
        for i in range(40):
            logits, eager = model.decode_step(params, eager, feed)
            step.replay()
            want = logits[:, 0].argmax(-1).to(torch.int32)
            assert torch.equal(step.nxt, want) and torch.equal(step.tokens[:, 0], want), i
            assert torch.equal(step.finite, torch.isfinite(logits[:, 0]).all(-1))
            for a, b in zip(_state_fields(eager), _state_fields(graphed)):
                assert torch.equal(a, b), f"step {i}"
            feed = want[:, None]
    # 18 + 40, 28 + 40 and 0 + 40 tokens in 32-token blocks
    assert (eager["caches"][0].pack_blocks[0] - pack0).tolist() == [1, 2, 1]
    assert step.replays == 40 and step.launches[kinds[0]] == 40 * n


def _gpu_workload(cfg, n=5):
    rng = np.random.default_rng(42)
    base = rng.integers(0, cfg.vocab, 70).astype(np.int32)
    prompts = [base, np.concatenate([base[:64], rng.integers(0, cfg.vocab, 30)])]
    prompts += [rng.integers(0, cfg.vocab, int(rng.integers(34, 48))).astype(np.int32)
                for _ in range(n - 2)]
    return [Request(uid=i, prompt=p, max_new_tokens=int(rng.integers(24, 40)))
            for i, p in enumerate(prompts)]


def _drive(eng, reqs):
    eng.submit(reqs[0])
    eng.step()
    for r in reqs[1:]:
        eng.submit(r)
    eng.run()
    eng.close()
    return {r.uid: list(r.out_tokens) for r in reqs}, {r.uid: r.phase for r in reqs}


@pytest.mark.parametrize("pressure", [False, True])
def test_async_engine_equals_sync_on_the_card(cuda, graph_model, pressure):
    """The smoke engine on the card (prefix sharing, flushes, and with
    ``pressure`` preemption): the async runtime's streams and phases equal
    the sync cycle's bit for bit; one replay a dispatch; the fresh async
    engine's state equals a fresh sync engine's."""
    model, params = graph_model
    kw = dict(slots=3, max_seq=192, audit_every=1)
    if pressure:
        kw.update(n_pages=3 + 5, reserve_policy="expected", expected_quantile=0.0)
    with torch.no_grad():
        sync_eng = ServeEngine(model, params, **kw)
        async_eng = ServeEngine(model, params, async_runtime=True, **kw)
        for a, b in zip(_state_fields(sync_eng.state), _state_fields(async_eng.state)):
            assert torch.equal(a, b)
        want = _drive(sync_eng, _gpu_workload(model.cfg))
        got = _drive(async_eng, _gpu_workload(model.cfg))
    assert got == want
    runner = async_eng._runner
    assert runner.step_fn.graph is not None and runner.step_fn.replays == runner.dispatched
    assert async_eng.stats["preempted"] == sync_eng.stats["preempted"]
    assert (async_eng.stats["preempted"] > 0) == pressure
    assert async_eng.sched.stats["prefix_hit_blocks"] > 0
    assert async_eng.pool.n_free == async_eng.pool.capacity


def test_async_dispatch_side_makes_no_host_sync(cuda, graph_model):
    """Everything the async step does outside consumption (admission and
    its prefills, a shared-prefix suffix prefill, flush-page allocation,
    the page-table push, the feed overrides, the replay and the read-back)
    runs under ``torch.cuda.set_sync_debug_mode("error")``: only the event
    wait in ``_consume_one`` blocks."""
    model, params = graph_model
    eng = ServeEngine(model, params, slots=3, max_seq=192, async_runtime=True)
    runner = eng._runner
    consume = runner._consume_one

    def consume_unchecked():
        torch.cuda.set_sync_debug_mode(0)
        try:
            consume()
        finally:
            torch.cuda.set_sync_debug_mode("error")

    runner._consume_one = consume_unchecked
    reqs = _gpu_workload(model.cfg)
    try:
        with torch.no_grad():
            eng.submit(reqs[0])
            torch.cuda.set_sync_debug_mode("error")
            eng.step()
            for r in reqs[1:]:
                eng.submit(r)
            while eng._has_work():
                eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        eng.close()
    assert all(r.done for r in reqs) and eng.sched.stats["prefix_hit_blocks"] > 0
    assert eng.stats["cow_copies"] + eng.stats["decoded_tokens"] > 0


def test_moe_dispatch_makes_no_host_sync(cuda, moe_graph_model):
    """``moe_ffn`` at a prefill's and a decode step's shapes (drops
    included), and the MoE model's prefill and decode step, run under
    ``torch.cuda.set_sync_debug_mode("error")``: routing, dispatch and
    combine read no device value on the host."""
    from repro_torch.models import moe

    model, params = moe_graph_model
    cfg = model.cfg
    gen = torch.Generator(device=cuda).manual_seed(5)
    p = {k: v[0] for k, v in params["stack_0"]["moe"].items()}
    xs = [randn(gen, (3, 37, cfg.d_model), cuda), randn(gen, (4, 1, cfg.d_model), cuda)]
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=cuda, generator=gen)
    lengths = torch.tensor([40, 23], dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.no_grad():
            outs = [moe.moe_ffn(p, c, x)[0] for x in xs
                    for c in (cfg, cfg.with_(capacity_factor=0.5))]
            logits, state = model.prefill(params, {"tokens": tokens}, 96, lengths=lengths)
            for _ in range(3):
                logits, state = model.decode_step(params, state,
                                                  logits[:, -1].argmax(-1)[:, None])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(o.float()).all()) for o in outs)
    assert bool(torch.isfinite(logits).all())


def test_mla_step_makes_no_host_sync(cuda, mla_graph_model):
    """The MLA smoke model's prefill (K6's padded route, K1 on the latent),
    decode steps on a dense and on a paged latent cache (the absorbed
    products, K2-K5 in the shared_kv mode, the MoE layer) run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    model, params = mla_graph_model
    cfg = model.cfg
    gen = torch.Generator(device=cuda).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (2, 40), device=cuda, generator=gen)
    lengths = torch.tensor([40, 23], dtype=torch.int32, device=cuda)
    with torch.no_grad():
        paged = _decode_state(model, params, cuda, paged=True)
    feed = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        with torch.no_grad():
            logits, state = model.prefill(params, {"tokens": tokens}, 96, lengths=lengths)
            for _ in range(3):
                logits, state = model.decode_step(params, state,
                                                  logits[:, -1].argmax(-1)[:, None])
                paged_logits, paged = model.decode_step(params, paged, feed)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(paged_logits).all())


def test_capture_failure_raises_and_does_not_fall_back(cuda, graph_model):
    """A decode step that syncs the host cannot be captured: the engine's
    construction raises instead of running the step eagerly."""
    model, params = graph_model

    class Syncing:
        cfg = model.cfg

        def __getattr__(self, name):
            return getattr(model, name)

        def decode_step(self, *args, **kw):
            torch.cuda.synchronize()  # not allowed while a stream is capturing
            return model.decode_step(*args, **kw)

    with pytest.raises(RuntimeError, match="capturing the decode step"):
        ServeEngine(Syncing(), params, slots=2, max_seq=128, async_runtime=True)
    eng = ServeEngine(model, params, slots=2, max_seq=128, async_runtime=True)
    assert eng._runner.step_fn.graph is not None
    eng.close()


# ------------------------------------------ self-speculative decoding's passes


def test_spec_passes_replay_equal_eager_bitwise(cuda, graph_model):
    """The draft and verify passes captured as CUDA graphs against the same
    bodies run eagerly, from the same paged state, over six cycles that
    flush on both live rows (an idle row 2): the drafts, ``v``,
    ``applied``, ``finite`` and every state tensor bit for bit after every
    pass.  Capture leaves the state as it found it; the draft graph reads
    the pools (one K4 launch a layer and step, no flush), the verify graph
    appends through K5 and reads through K4 once a layer and feed."""
    from repro_torch.serve.speculative import DraftPass, VerifyPass

    model, params = graph_model
    k, n = 4, model.cfg.n_layers
    spec = model.paged_spec()
    with torch.no_grad():
        states = [_decode_state(model, params, cuda, paged=True) for _ in range(2)]
        before = [t.clone() for t in _state_fields(states[1])]
        passes = [(DraftPass(model, params, st, spec, spec_k=k, spec_bits=2),
                   VerifyPass(model, params, st, spec, spec_k=k)) for st in states]
        for a, b in zip(_state_fields(states[1]), before):
            assert torch.equal(a, b)
        (d_e, v_e), (d_g, v_g) = passes
        assert d_g.graph is not None and v_g.graph is not None
        assert d_g.capture_launches["paged_bitdecode"] == n * (k - 1)
        assert d_g.capture_launches["paged_residual_flush"] == 0
        assert v_g.capture_launches["paged_residual_flush"] == n * k
        assert v_g.capture_launches["paged_bitdecode"] == n * k
        gen = torch.Generator(device=cuda).manual_seed(3)
        tok0 = torch.zeros(3, dtype=torch.int32, device=cuda)
        for cycle in range(6):
            for d_pass in (d_e, d_g):
                d_pass.tok0.copy_(tok0)
            d_e._body()
            d_g.replay()
            assert torch.equal(d_e.drafts, d_g.drafts), cycle
            feeds = torch.cat([tok0[:, None], d_e.drafts], 1)
            feeds[1, 2:] = torch.randint(0, model.cfg.vocab, (k - 2,), generator=gen,
                                         device=cuda, dtype=torch.int32)
            for v_pass in (v_e, v_g):
                v_pass.feeds.copy_(feeds)
                v_pass.limit.copy_(torch.tensor([k, k - 1, 0], dtype=torch.int32, device=cuda))
                v_pass.forced.copy_(torch.tensor([cycle % 2 == 0, False, False], device=cuda))
            v_e._body()
            v_g.replay()
            for name in ("v", "applied", "finite"):
                assert torch.equal(getattr(v_e, name), getattr(v_g, name)), (cycle, name)
            for a, b in zip(_state_fields(states[0]), _state_fields(states[1])):
                assert torch.equal(a, b), cycle
            last = v_e.applied.sum(1) - 1
            tok0 = v_e.v[torch.arange(3, device=cuda), last.clamp(min=0)].to(torch.int32)
    assert d_g.replays == v_g.replays == 6


@pytest.mark.parametrize("async_runtime", [False, True])
@pytest.mark.parametrize("pressure", [False, True])
def test_spec_engine_equals_sequential_on_the_card(cuda, graph_model, pressure, async_runtime):
    """The smoke engine at ``spec_k = 4``, ``spec_bits = 2`` on the card
    (prefix sharing, flushes inside verify scans, with ``pressure``
    preemption and replay; with ``async_runtime`` completions on the
    background thread): streams and phases bit for bit the ``spec_k = 1``
    engine's; every draft and verify pass one graph replay."""
    model, params = graph_model
    kw = dict(slots=3, max_seq=192, audit_every=1)
    if pressure:
        kw.update(n_pages=3 + 5, reserve_policy="expected", expected_quantile=0.0)
    with torch.no_grad():
        want = _drive(ServeEngine(model, params, **kw), _gpu_workload(model.cfg))
        eng = ServeEngine(model, params, spec_k=4, spec_bits=2, async_runtime=async_runtime,
                          **kw)
        got = _drive(eng, _gpu_workload(model.cfg))
    assert got == want
    s = eng.stats
    assert eng._draft.graph is not None and eng._verify.graph is not None
    assert eng._verify.replays == s["spec_cycles"] == s["steps"] > 0
    assert 0 < eng._draft.replays <= eng._verify.replays
    assert s["spec_draft_tokens"] == s["spec_accepted_tokens"] + s["spec_rejected_tokens"] > 0
    assert (s["preempted"] > 0) == pressure
    assert eng.pool.n_free == eng.pool.capacity


# --------------------------------------------------------------------------
# the Mamba2 hybrid (zamba2-7b): K2-K5 at head dim 112, the smoke model
# --------------------------------------------------------------------------

D112_CASES = [  # (g, block_n, bits, k_gran, pack_blocks, res_len)
    (1, 128, 4, "channel", [4, 3], [100, 7]),  # zamba2-7b's decode: g 1
    (1, 128, 2, "tensor", [0, 4], [5, 128]),  # no packed block; a full residual
    (1, 64, 8, "channel", [4, 2], [64, 1]),
    (4, 32, 2, "tensor", [3, 4], [31, 0]),  # 2 word rows a block
    (8, 128, 4, "tensor", [1, 4], [0, 50]),  # one full tile of query rows
]


@pytest.mark.parametrize("case", D112_CASES)
@pytest.mark.parametrize("num_splits", [1, 3, "auto"])
def test_decode_kernels_at_head_dim_112_match_plain(cuda, case, num_splits):
    """K3 and K4 (a scrambled table) at d 112 (PV's last 32-channel group
    half full) within out 2e-2 / lse 1e-3 of the plain version; K4 on the
    identity table bit for bit K3; at 4 bits the draft read at 2 bits
    too."""
    g, block_n, bits, k_gran, pb, rl = case
    gen = torch.Generator(device=cuda).manual_seed(112 + g + bits)
    q, *packed, k_res, v_res, pbt, rlt = _decode_args(gen, cuda, g, 112, block_n, bits,
                                                      k_gran, pb, rl, 1.0)
    b, nb = q.shape[0], packed[0].shape[2]
    pools = _pools(packed)
    order = torch.randperm(b * nb, generator=gen, device=cuda)
    scrambled = [torch.empty_like(p).index_copy_(0, order, p) for p in pools]
    tables = {"scrambled": order.reshape(b, nb).to(torch.int32),
              "identity": torch.arange(b * nb, dtype=torch.int32, device=cuda).reshape(b, nb)}
    kw = dict(bits=bits, block_n=block_n, k_gran=k_gran, return_lse=True)
    for draft_bits in (None, 2) if bits == 4 else (None,):
        dense = functools.partial(bd_ops.bitdecode_attention, q, *packed, k_res, v_res, pbt,
                                  rlt, draft_bits=draft_bits, **kw)
        out_r, lse_r = dense(impl="torch", num_splits=1)
        out_k, lse_k = dense(impl="cuda", num_splits=num_splits)
        _assert_decode_close(out_k, lse_k, out_r, lse_r, pb, rl)
        for kind, arrays in (("scrambled", scrambled), ("identity", pools)):
            out_p, lse_p = pg_ops.paged_bitdecode_attention(
                q, *arrays, k_res, v_res, tables[kind], pbt, rlt, impl="cuda",
                num_splits=num_splits, draft_bits=draft_bits, **kw)
            _assert_decode_close(out_p, lse_p, out_r, lse_r, pb, rl)
            if kind == "identity":
                assert torch.equal(out_p, out_k) and torch.equal(lse_p, lse_k)


def test_decode_kernel_at_head_dim_112_refuses_two_query_tiles(cuda):
    """d 112 has instances for one tile of 8 query rows: g 9 raises before
    any launch."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    args = _decode_args(gen, cuda, 9, 112, 64, 4, "channel", [2, 1], [3, 4], 1.0)
    _build.launches.clear()
    with pytest.raises(ValueError, match="the CUDA decode kernel takes"):
        bd_ops.bitdecode_attention(*args, bits=4, block_n=64, impl="cuda")
    assert not _build.launches


def _hybrid_smoke(**change):
    """The zamba2 smoke model (2 super-blocks of 2 Mamba2 layers and the
    shared block, a tail of 1), block_n 32, and its parameters on the
    card."""
    model = build_model(smoke_config("zamba2-7b").with_(**{"kv_block": 32, **change}))
    return model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


@pytest.mark.parametrize("head_dim", [32, 112])
def test_hybrid_smoke_model_kernels_match_plain(cuda, head_dim):
    """The zamba2 smoke model (and a variant at zamba2-7b's head dim 112),
    block_n 64: an exact-length prefill of two 100-token prompts and 30
    decode steps (each row flushes once), kernels against the plain
    versions fed the same tokens: logits within rtol 2e-2 / atol 3e-1, the
    SSM states within 2e-2 in relative norm, invocation 0's packed cache
    bit for bit; one kv_quant and one flash_prefill launch an invocation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model, params = _hybrid_smoke(kv_block=64, head_dim=head_dim)
    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (2, 100), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))

    def run(impl, feed=None):
        logits, state = model.prefill(params, {"tokens": tokens}, 256, impl=impl,
                                      quant_impl=impl)
        out = [logits]
        for i in range(30):
            tok = logits[:, -1].argmax(-1)[:, None] if feed is None else feed[i]
            logits, state = model.decode_step(params, state, tok, impl=impl, quant_impl=impl)
            out.append(logits)
        return out, state

    with torch.no_grad():
        out_t, s_t = run("torch")
        _build.launches.clear()
        out_k, s_k = run("auto", [o[:, -1].argmax(-1)[:, None] for o in out_t])
    assert min(_build.launches[k] for k in ("kv_quant", "residual_flush", "bitdecode",
                                            "flash_prefill")) > 0
    assert _build.launches["kv_quant"] == _build.launches["flash_prefill"] == model.n_super
    for a, b in zip(out_k, out_t):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=3e-1)
    for path in ("ssm_main", "ssm_tail"):
        k, t = s_k[path]["ssm"], s_t[path]["ssm"]
        assert float((k - t).norm() / t.norm()) < 2e-2, path
    ct, ck = s_t["caches"][0], s_k["caches"][0]
    assert torch.equal(ct.pack_blocks, ck.pack_blocks) and ck.pack_blocks[0].tolist() == [2, 2]
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):
        np.testing.assert_array_equal(bits_of(getattr(ck, f)[0]), bits_of(getattr(ct, f)[0]))


def _hybrid_fields(state) -> list:
    """Every tensor of a hybrid decode state: the caches', pos, and the
    Mamba2 states."""
    return _state_fields(state) + [t for path in ("ssm_main", "ssm_tail")
                                   for t in state[path].values()]


def _hybrid_state(model, params, cuda, *, paged):
    """A decode state mid-run of the hybrid smoke model (block_n 32): two
    rows of 50 prompt tokens (18 into their residuals), an idle row 2; the
    paged one through the engine's adoption and side-state splice."""
    from repro_torch.serve import pages as pg

    cfg = model.cfg
    tokens = torch.randint(0, cfg.vocab, (3, 50), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(4))
    _, dense = model.prefill(params, {"tokens": tokens}, 160)
    if not paged:
        for c in dense["caches"]:
            c.pack_blocks[:, 2] = 0
            c.res_len[:, 2] = 0
        dense["pos"][2] = 0
        return dense
    nb_max = 5
    state = model.init_paged_decode_state(3, n_pages=3 + 8, nb_max=nb_max, device=cuda)
    pg.adopt_prefill(state["caches"], dense["caches"], slot_ids=[0, 1], lengths=[50, 50],
                     pages_per_req=[[7], [4]], block_n=cfg.kv_block)
    for path, bdim in model.paged_spec().side_state:
        for k, t in state[path].items():
            t.narrow(bdim, 0, 2).copy_(dense[path][k].narrow(bdim, 0, 2))
    table = np.arange(3, dtype=np.int32)[:, None].repeat(nb_max, 1)
    table[0, :3], table[1, :3] = [7, 9, 3], [4, 10, 8]
    pg.set_page_tables(state["caches"], table)
    state["pos"][:2] = 50
    return state


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_captured_hybrid_step_equals_eager_bitwise(cuda, paged):
    """40 replays of the hybrid's captured step against 40 eager steps fed
    the same tokens: every state tensor, the Mamba2 states included, bit
    for bit after every step (the step updates them in place, so the graph
    advances them); capture leaves the state as it found it and records one
    launch of the decode kernels an invocation."""
    from repro_torch.serve.async_runtime import CapturedDecodeStep

    model, params = _hybrid_smoke()
    n = model.n_super
    with torch.no_grad():
        eager, graphed = (_hybrid_state(model, params, cuda, paged=paged) for _ in range(2))
        before = [t.clone() for t in _hybrid_fields(graphed)]
        step = CapturedDecodeStep(model, params, graphed)
        for a, b in zip(_hybrid_fields(graphed), before):
            assert torch.equal(a, b)
        kinds = ("paged_bitdecode", "paged_residual_flush") if paged else (
            "bitdecode", "residual_flush")
        assert all(step.capture_launches[k] == n for k in kinds), step.capture_launches
        feed = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
        step.tokens.copy_(feed)
        for i in range(40):
            logits, eager = model.decode_step(params, eager, feed)
            step.replay()
            want = logits[:, 0].argmax(-1).to(torch.int32)
            assert torch.equal(step.nxt, want), i
            for a, b in zip(_hybrid_fields(eager), _hybrid_fields(graphed)):
                assert torch.equal(a, b), f"step {i}"
            feed = want[:, None]
    assert not torch.equal(graphed["ssm_main"]["ssm"], before[-4])  # the states advanced


@pytest.mark.parametrize("mode", ["async", "spec", "spec_async"])
def test_hybrid_engines_equal_sequential_on_the_card(cuda, mode):
    """The hybrid smoke engine (exact-length prefill groups, the Mamba2
    states spliced in place) on the async runtime, by self-speculation
    (``spec_k = 4``, drafts at 2 bits: the draft pass advances its own copy
    of the states) and both: streams and phases bit for bit the sync
    ``spec_k = 1`` engine's, each decode step or pass one graph replay."""
    model, params = _hybrid_smoke()
    kw = dict(slots=3, max_seq=192, audit_every=1)
    spec = dict(spec_k=4, spec_bits=2) if mode.startswith("spec") else {}
    with torch.no_grad():
        want = _drive(ServeEngine(model, params, **kw), _gpu_workload(model.cfg))
        eng = ServeEngine(model, params, async_runtime=mode.endswith("async"), **spec, **kw)
        got = _drive(eng, _gpu_workload(model.cfg))
    assert got == want
    if spec:
        assert eng._draft.graph is not None and eng._verify.graph is not None
        assert eng._verify.replays == eng.stats["spec_cycles"] > 0
    else:
        assert eng._runner.step_fn.replays == eng._runner.dispatched > 0
    assert eng.pool.n_free == eng.pool.capacity


# --------------------------------------------------------------------------
# the recurrent xLSTM family and the engine's exact-length shim
# (``-k "xlstm or shim"``)
# --------------------------------------------------------------------------

# the plain versions of the kernels: none may run on the shim's kernel path
_PLAIN_VERSIONS = (
    ("repro_torch.kernels.kv_quant.ref", ("quantize_kv_ref", "quantize_kv_pair_ref")),
    ("repro_torch.kernels.residual_flush.ref", ("residual_flush_ref", "append_flush_ref")),
    ("repro_torch.kernels.bitdecode.ref", ("bitdecode_attention_ref", "merge_partials")),
    ("repro_torch.kernels.flash_prefill.ref", ("flash_prefill_ref",)),
    ("repro_torch.core.attention", ("blockwise_attention_plain",)),
)


def _count_plain(monkeypatch) -> dict:
    """Count every call of a kernel's plain version from now on."""
    import importlib

    seen: dict = {}
    for mod_name, names in _PLAIN_VERSIONS:
        mod = importlib.import_module(mod_name)
        for n in names:
            fn = getattr(mod, n)

            def counted(*a, _n=n, _fn=fn, **kw):
                seen[_n] = seen.get(_n, 0) + 1
                return _fn(*a, **kw)

            monkeypatch.setattr(mod, n, counted)
    return seen


def _xlstm_smoke(**change):
    """The xlstm smoke model (2 super-blocks of 1 mLSTM + 1 sLSTM, d 64)
    and its parameters on the card."""
    model = build_model(smoke_config("xlstm-1.3b").with_(**change))
    return model, model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")


def _xlstm_fields(state) -> list:
    """Every tensor of an xLSTM decode state."""
    return [t for kind in ("mlstm", "slstm") for t in state["blocks"][kind].values()] + [
        state["pos"]]


def test_captured_xlstm_step_equals_eager_bitwise(cuda):
    """40 replays of the xLSTM smoke model's captured step against 40
    eager steps fed the same tokens, from a 40-token prefill of 3 rows:
    every recurrent state bit for bit after every step (the step updates
    them in place, so the graph advances them); capture leaves the state as
    it found it and records no kernel launch (no KV cache)."""
    from repro_torch.serve.async_runtime import CapturedDecodeStep

    model, params = _xlstm_smoke()
    tokens = torch.randint(0, model.cfg.vocab, (3, 40), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(4))
    with torch.no_grad():
        eager, graphed = (model.prefill(params, {"tokens": tokens})[1] for _ in range(2))
        before = [t.clone() for t in _xlstm_fields(graphed)]
        step = CapturedDecodeStep(model, params, graphed)
        for a, b in zip(_xlstm_fields(graphed), before):
            assert torch.equal(a, b)
        assert step.graph is not None and not step.capture_launches
        feed = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
        step.tokens.copy_(feed)
        for i in range(40):
            logits, eager = model.decode_step(params, eager, feed)
            step.replay()
            want = logits[:, 0].argmax(-1).to(torch.int32)
            assert torch.equal(step.nxt, want), i
            for a, b in zip(_xlstm_fields(eager), _xlstm_fields(graphed)):
                assert torch.equal(a, b), f"step {i}"
            feed = want[:, None]
    assert not torch.equal(graphed["blocks"]["mlstm"]["C"], before[0])  # the states advanced


def test_xlstm_chunkwise_prefill_on_the_card(cuda):
    """The chunkwise mLSTM prefill (``xlstm_chunkwise``, chunk 64) against
    the sequential one on the card, two 128-token prompts: the last logits
    within rtol 2e-2 / atol 3e-1, the states within 2e-2 in relative
    norm."""
    model, params = _xlstm_smoke()
    chunked = build_model(model.cfg.with_(xlstm_chunkwise=True))
    tokens = torch.randint(0, model.cfg.vocab, (2, 128), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(5))
    with torch.no_grad():
        (ls, ss), (lc, sc) = (m.prefill(params, {"tokens": tokens}) for m in (model, chunked))
    torch.testing.assert_close(lc, ls, rtol=2e-2, atol=3e-1)
    for a, b in zip(_xlstm_fields(sc)[:-1], _xlstm_fields(ss)[:-1]):
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) < 2e-2


@pytest.mark.parametrize("mode", ["async", "spec", "spec_async"])
@pytest.mark.parametrize("family", ["attn", "xlstm"])
def test_shim_engines_equal_sequential_on_the_card(cuda, monkeypatch, family, mode):
    """The exact-length shim on the card: the llama3-8b smoke model forced
    to it (``paged=False``: one B 1 prefill a request through flash_prefill
    and kv_quant, the dense caches appended by residual_flush and read by
    bitdecode) and the xLSTM smoke model, on the async runtime, by
    self-speculation (``spec_k = 4``, drafts at 2 bits: the draft reads the
    dense cache at 2 bits, the verify pass appends with the row mask) and
    both: streams and phases bit for bit the sync engine's, each decode
    step or pass one graph replay, and no plain version of a kernel
    called."""
    if family == "attn":
        model = build_model(smoke_config("llama3-8b").with_(kv_block=32))
        params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    else:
        model, params = _xlstm_smoke()
    kw = dict(slots=3, max_seq=192, audit_every=1, paged=False)
    spec = dict(spec_k=4, spec_bits=2) if mode.startswith("spec") else {}
    plain = _count_plain(monkeypatch)
    with torch.no_grad():
        _build.launches.clear()
        want = _drive(ServeEngine(model, params, **kw), _gpu_workload(model.cfg))
        sync_launches = dict(_build.launches)
        eng = ServeEngine(model, params, async_runtime=mode.endswith("async"), **spec, **kw)
        got = _drive(eng, _gpu_workload(model.cfg))
    assert got == want and not plain, plain
    assert not eng.paged and eng.pool is None
    if family == "attn":
        assert min(sync_launches.get(k, 0) for k in ("kv_quant", "flash_prefill",
                                                     "residual_flush", "bitdecode")) > 0
        assert not any(k.startswith("paged_") for k in sync_launches), sync_launches
    else:
        assert not sync_launches
    if spec:
        assert eng._draft.graph is not None and eng._verify.graph is not None
        assert eng._verify.replays == eng.stats["spec_cycles"] > 0
        if family == "xlstm":
            assert eng.stats["spec_rejected_tokens"] == 0
    else:
        assert eng._runner.step_fn.replays == eng._runner.dispatched > 0


# --------------------------------------------------------------------------
# cross-device split-KV: K3/K4's window, K5's page range, the one-rank mesh
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [(0, 4, True), (1, 2, False), (2, 2, True), (3, 2, True),
                                    (4, 1, True), (0, 2, False)])
@pytest.mark.parametrize("num_splits", [1, 3, "auto"])
def test_bitdecode_window_equals_the_call_over_a_copy(cuda, window, num_splits):
    """K3 over blocks [lo, lo + n) of the whole cache, in place, equals K3
    over a contiguous copy of those blocks, pack_blocks clipped and the
    residual dropped where ``read_res`` is off: bit for bit, out and lse
    (an empty window and one past nb included)."""
    lo, n, res = window
    gen = torch.Generator(device=cuda).manual_seed(lo * 7 + n)
    q, *packed, k_res, v_res, pb, rl = _decode_args(gen, cuda, *DECODE_CASES[2])
    kw = dict(bits=4, block_n=128, k_gran="channel", return_lse=True, num_splits=num_splits,
              impl="cuda")
    got = bd_ops.bitdecode_attention(q, *packed, k_res, v_res, pb, rl, block_lo=lo, n_blocks=n,
                                     read_res=res, **kw)
    hi = min(4, lo + n)
    copy = [x[:, :, lo:hi].contiguous() for x in packed]
    pad = [torch.zeros_like(x[:, :, :lo + n - hi]) for x in packed]  # the window's full width
    copy = [torch.cat([c, p], dim=2) for c, p in zip(copy, pad)]
    want = bd_ops.bitdecode_attention(q, *copy, k_res, v_res, torch.clamp(pb - lo, 0, hi - lo),
                                      rl if res else torch.zeros_like(rl), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("window", [(0, 6, True, 0), (2, 2, False, 0), (4, 2, True, 8),
                                    (3, 3, True, 4)])
def test_paged_bitdecode_window_and_page_lo_equal_the_call_over_a_copy(cuda, window):
    """K4 over table columns [lo, lo + n) with its page ids rebased by
    ``page_lo`` into pools holding pages [page_lo, page_lo + 8) equals K4
    over a copy of the sliced, rebased table: bit for bit."""
    lo, n, res, page_lo = window
    g, d, block_n, bits, k_gran, pb, rl = PAGED_CASES[0]
    gen = torch.Generator(device=cuda).manual_seed(lo + n + page_lo)
    args = _decode_args(gen, cuda, g, d, block_n, bits, k_gran, pb, rl, 1.0)
    q, res_t, lens = args[0], args[7:9], args[9:]
    pool = _pools(_packed(gen, cuda, b=4, h=2, nb=4, block_n=block_n, d=d, bits=bits,
                          k_gran=k_gran))
    local = [p[page_lo:page_lo + 8].contiguous() for p in pool]
    table = torch.randperm(16, generator=gen, device=cuda)[:12].reshape(2, 6).to(torch.int32)
    kw = dict(bits=bits, block_n=block_n, k_gran=k_gran, return_lse=True, impl="cuda",
              num_splits=3)
    got = pg_ops.paged_bitdecode_attention(q, *local, *res_t, table, *lens, block_lo=lo,
                                           n_blocks=n, read_res=res, page_lo=page_lo, **kw)
    sub = torch.clamp(table[:, lo:lo + n] - page_lo, 0, 7).to(torch.int32).contiguous()
    want = pg_ops.paged_bitdecode_attention(
        q, *local, *res_t, sub, torch.clamp(lens[0] - lo, 0, n),
        lens[1] if res else torch.zeros_like(lens[1]), **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("page_lo", [0, 8, 16])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
def test_paged_append_page_range_bitwise(cuda, page_lo, k_gran):
    """K5's append over pools that hold pages [page_lo, page_lo + 8) of 24:
    the pages in the range bit for bit the whole pool's after every step,
    pages outside never written, residuals and lengths equal, and the
    kernel bit for bit its plain version on the range."""
    b, h, d, block_n = 4, 2, 128, 64
    gen = torch.Generator(device=cuda).manual_seed(page_lo)
    arrays, lens = _append_state(gen, cuda, paged=True, b=b, h=h, d=d, block_n=block_n,
                                 bits=4, k_gran=k_gran)
    whole_a, whole_l = arrays, lens
    part_a = [x[page_lo:page_lo + 8].clone() for x in arrays[:6]] + [x.clone() for x in arrays[6:]]
    part_l = [x.clone() for x in lens]
    plain_a, plain_l = [x.clone() for x in part_a], [x.clone() for x in part_l]
    kw = dict(bits=4, block_n=block_n, k_gran=k_gran)
    rng = dict(page_lo=page_lo, pages_total=24)
    for step in range(2 * block_n + 5):
        k_new, v_new = _new_tokens(gen, cuda, b, h, d)
        mask = torch.tensor([True, step % 3 != 1, True, True], device=cuda)
        rf_ops.paged_append_flush(*whole_a, k_new, v_new, *whole_l, mask=mask, impl="cuda", **kw)
        rf_ops.paged_append_flush(*part_a, k_new, v_new, *part_l, mask=mask, impl="cuda", **kw,
                                  **rng)
        rf_ops.paged_append_flush(*plain_a, k_new, v_new, *plain_l, mask=mask, impl="torch",
                                  **kw, **rng)
        for x, y in zip(part_a[:6], whole_a[:6]):
            assert torch.equal(x, y[page_lo:page_lo + 8]), step
        for x, y, z in zip(part_a[6:] + part_l, whole_a[6:] + whole_l, plain_a[6:] + plain_l):
            assert torch.equal(x, y) and torch.equal(x, z), step
        assert all(torch.equal(x, y) for x, y in zip(part_a[:6], plain_a[:6])), step
    assert (whole_l[1] > 0).all()  # every row flushed, into pages of every range


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL process group and a 1-D mesh over axis "data"."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    yield init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    dist.destroy_process_group()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_one_rank_split_step_captured_equals_eager_and_unsplit(cuda, graph_model, nccl_mesh,
                                                               paged):
    """The split-KV decode step on a one-rank NCCL mesh: the captured step
    (its all-gather in the graph) equals the eager split step and the
    unsplit step bit for bit, 40 steps over flushes; the capture records the
    cross-rank merge once a layer."""
    from repro_torch.serve.async_runtime import CapturedDecodeStep

    model, params = graph_model
    ctx = catt.use_splitkv(nccl_mesh, "data")
    with torch.no_grad():
        eager, graphed, plain = (_decode_state(model, params, cuda, paged=paged)
                                 for _ in range(3))
        step = CapturedDecodeStep(model, params, graphed, splitkv=ctx)
        n = model.cfg.n_layers
        assert step.capture_launches["bitdecode_merge"] >= n, step.capture_launches
        feed = torch.zeros((3, 1), dtype=torch.int32, device=cuda)
        step.tokens.copy_(feed)
        for i in range(40):
            with ctx:
                logits, eager = model.decode_step(params, eager, feed)
            lp, plain = model.decode_step(params, plain, feed)
            step.replay()
            want = logits[:, 0].argmax(-1).to(torch.int32)
            assert torch.equal(logits, lp), i
            assert torch.equal(step.nxt, want), i
            for a, b, c in zip(_state_fields(eager), _state_fields(graphed), _state_fields(plain)):
                assert torch.equal(a, b) and torch.equal(a, c), f"step {i}"
            feed = want[:, None]


@pytest.mark.parametrize("affine", [False, True], ids=["replicated", "page_affine"])
def test_one_rank_split_async_engine_equals_unsplit(cuda, graph_model, nccl_mesh, affine):
    """The async engine with a one-rank mesh and ``splitkv="always"`` (and
    page-affine pools): streams and phases bit for bit the unsplit sync
    engine's, every decode step split, one replay a dispatch."""
    model, params = graph_model
    kw = dict(slots=3, max_seq=192, audit_every=1)
    with torch.no_grad():
        want = _drive(ServeEngine(model, params, **kw), _gpu_workload(model.cfg))
        eng = ServeEngine(model, params, async_runtime=True, mesh=nccl_mesh, splitkv="always",
                          page_affine=affine, **kw)
        got = _drive(eng, _gpu_workload(model.cfg))
    assert got == want
    runner = eng._runner
    assert runner.step_fn.graph is not None and runner.step_fn.replays == runner.dispatched
    assert eng.stats["splitkv_steps"] == runner.dispatched > 0
    assert eng.summary()["pool_shards"] == 1


def test_async_dispatch_side_makes_no_host_sync_with_a_mesh(cuda, graph_model, nccl_mesh):
    """``test_async_dispatch_side_makes_no_host_sync`` with a one-rank mesh,
    page-affine pools and every step split: the collective and the page
    range add no host sync."""
    model, params = graph_model
    eng = ServeEngine(model, params, slots=3, max_seq=192, async_runtime=True, mesh=nccl_mesh,
                      splitkv="always", page_affine=True)
    runner = eng._runner
    consume = runner._consume_one

    def consume_unchecked():
        torch.cuda.set_sync_debug_mode(0)
        try:
            consume()
        finally:
            torch.cuda.set_sync_debug_mode("error")

    runner._consume_one = consume_unchecked
    reqs = _gpu_workload(model.cfg)
    try:
        with torch.no_grad():
            eng.submit(reqs[0])
            torch.cuda.set_sync_debug_mode("error")
            eng.step()
            for r in reqs[1:]:
                eng.submit(r)
            while eng._has_work():
                eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        eng.close()
    assert all(r.done for r in reqs) and eng.sched.stats["prefix_hit_blocks"] > 0
    assert eng.stats["splitkv_steps"] > 0
