"""The port's flash-prefill attention against the JAX package's, on the CPU.

The plain version (``repro_torch.kernels.flash_prefill.ref``) against JAX's
``flash_prefill_ref`` and against the Pallas kernel in interpret mode
(small shapes, as tests/test_kernels_flash_prefill.py runs it), MHA, GQA
and MQA, causal and full, within the kernel's tolerance (out 3e-2, lse
1e-3); ``blockwise_attention``'s ``impl`` routing; and that ``impl="cuda"``
on CPU tensors raises.  The CUDA kernel is held against the plain version
on the card in tests/test_torch_gpu.py.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as jatt
from repro.kernels.flash_prefill import ops as jfp_ops
from repro.kernels.flash_prefill import ref as jfp_ref
from repro_torch.core import attention as tatt
from repro_torch.kernels.flash_prefill import ops as fp_ops

OUT_TOL = dict(rtol=3e-2, atol=3e-2)
LSE_TOL = dict(rtol=1e-3, atol=1e-3)


def _case(seed, b, hq, hkv, s, d, layout="bhsd"):
    """q, k, v as bf16 pairs (JAX, torch), drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)]
    if layout == "bshd":
        shapes = [(b, s, h, d) for b, h, s, d in shapes]
    arrs = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    return ([jnp.asarray(a, jnp.bfloat16) for a in arrs],
            [torch.from_numpy(a).to(torch.bfloat16) for a in arrs])


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (4, 1), (12, 1)])  # MHA/GQA/MQA
@pytest.mark.parametrize("s,d", [(48, 32), (200, 64), (130, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_ref(hq, hkv, s, d, causal):
    (qj, kj, vj), (qt, kt, vt) = _case(hq * s + d, 2, hq, hkv, s, d)
    out_j, lse_j = jfp_ref.flash_prefill_ref(qj, kj, vj, causal=causal)
    out_t, lse_t = fp_ops.flash_prefill_attention(qt, kt, vt, causal=causal, return_lse=True)
    assert out_t.dtype == torch.bfloat16 and lse_t.dtype == torch.float32
    assert out_t.shape == (2, hq, s, d) and lse_t.shape == (2, hq, s)
    _close(out_t, out_j, OUT_TOL)
    _close(lse_t, lse_j, LSE_TOL)


@pytest.mark.parametrize("hq,hkv,s,causal", [(4, 4, 256, True), (8, 2, 200, True),
                                             (4, 1, 256, False)])
def test_plain_matches_pallas_interpret(hq, hkv, s, causal):
    """The Pallas kernel in interpret mode (S padded to 128, d = 128)."""
    (qj, kj, vj), (qt, kt, vt) = _case(7 * hq + s, 1, hq, hkv, s, 128)
    out_p, lse_p = jfp_ops.flash_prefill_attention(qj, kj, vj, causal=causal, bq=128, bk=128,
                                                   impl="pallas", return_lse=True)
    out_t, lse_t = fp_ops.flash_prefill_attention(qt, kt, vt, causal=causal, return_lse=True)
    _close(out_t, out_p, OUT_TOL)
    _close(lse_t, lse_p, LSE_TOL)


def test_layouts_agree_and_sm_scale_is_honoured():
    """``layout="bshd"`` is the same function on the transposed operands;
    an explicit ``sm_scale`` reaches the scores."""
    _, (q, k, v) = _case(3, 2, 4, 2, 70, 32)
    out, lse = fp_ops.flash_prefill_attention(q, k, v, return_lse=True)
    out_s, lse_s = fp_ops.flash_prefill_attention(
        *(x.transpose(1, 2) for x in (q, k, v)), layout="bshd", return_lse=True)
    assert torch.equal(out_s.transpose(1, 2), out) and torch.equal(lse_s, lse)
    half = fp_ops.flash_prefill_attention(q, k, v, sm_scale=0.5 / 32**0.5, return_lse=True)[1]
    assert not torch.allclose(half, lse)
    with pytest.raises(ValueError, match="layout"):
        fp_ops.flash_prefill_attention(q, k, v, layout="sbhd")


@pytest.mark.parametrize("hq,hkv,s", [(8, 2, 150), (12, 1, 64)])
def test_blockwise_plain_matches_jax(hq, hkv, s):
    """The plain blockwise loop (``impl="auto"`` on CPU tensors) against the
    JAX package's XLA route, ragged against ``block_k`` and one block."""
    (qj, kj, vj), (qt, kt, vt) = _case(11, 2, hq, hkv, s, 32, layout="bshd")
    out_j = jatt.blockwise_attention(qj, kj, vj, block_k=64, impl="xla")
    out_t = tatt.blockwise_attention(qt, kt, vt, block_k=64)
    assert out_t.dtype == torch.float32
    _close(out_t, out_j, OUT_TOL)
    assert torch.equal(out_t, tatt.blockwise_attention(qt, kt, vt, block_k=64, impl="torch"))


def test_blockwise_matches_jax_pallas_route():
    """The port's ``blockwise_attention`` against the JAX package's
    ``impl="pallas"`` route (the flash-prefill kernel in interpret mode)."""
    (qj, kj, vj), (qt, kt, vt) = _case(12, 1, 4, 2, 256, 128, layout="bshd")
    out_p = jatt.blockwise_attention(qj, kj, vj, impl="pallas")
    _close(tatt.blockwise_attention(qt, kt, vt, block_k=128), out_p, OUT_TOL)


def test_cuda_impl_on_cpu_tensors_raises():
    _, (q, k, v) = _case(5, 1, 4, 2, 32, 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fp_ops.flash_prefill_attention(q, k, v, impl="cuda")
    bshd = [x.transpose(1, 2) for x in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        tatt.blockwise_attention(*bshd, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tatt.blockwise_attention(*bshd, impl="pallas")


def test_model_prefill_routes_impl():
    """``DecoderLM.prefill(impl=...)`` reaches ``blockwise_attention``: on
    the CPU 'auto' and 'torch' give the same logits and 'cuda' raises."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.zoo import build_model

    cfg = smoke_config("llama3-8b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = {"tokens": torch.randint(0, cfg.vocab, (2, 40),
                                      generator=torch.Generator().manual_seed(1))}
    run = functools.partial(model.prefill, params, tokens, 128)
    with torch.no_grad():
        assert torch.equal(run()[0], run(impl="torch")[0])
        with pytest.raises(ValueError, match="CUDA tensors"):
            run(impl="cuda")

