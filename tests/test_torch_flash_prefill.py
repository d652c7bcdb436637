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



@pytest.mark.parametrize("b,hq,s,d,sms,expect", [
    (4, 32, 2048, 128, 132, 132),   # llama3-8b's prefill: one CTA per SM
    (1, 2, 100, 64, 132, 2),        # fewer work tiles than SMs
    (4, 16, 1200, 256, 132, 640),   # gemma-7b's: one CTA per work tile
    (1, 1, 1, 32, 132, 1),
])
def test_launch_ctas(b, hq, s, d, sms, expect):
    """The kernel's CTA count: persistent (at most one per SM) at d <= 128,
    one per work tile of 128 query rows at d = 256; always 1 to the number
    of work tiles, the range the C entry point accepts."""
    n = fp_ops.work_tiles(b, hq, s)
    assert n == -(-s // 128) * hq * b
    assert fp_ops.launch_ctas(b, hq, s, d, sms) == expect and 1 <= expect <= n


def test_kernel_operand_copies_only_what_tma_cannot_read():
    """Head slices of a fused QKV buffer and [B, H, S, d] transposes are
    taken as they are; a broadcast (stride 0) axis, a channel stride or a
    start off 16 bytes is copied, as TMA requires."""
    qkv = torch.zeros((2, 40, 12, 64), dtype=torch.bfloat16)
    for view in (qkv[:, :, 8:10], qkv[:, :, :8].transpose(1, 2)):
        assert fp_ops._kernel_operand(view).data_ptr() == view.data_ptr()
    one = torch.zeros((2, 40, 1, 64), dtype=torch.bfloat16)
    n = 2 * 40 * 12 * 64
    off16 = torch.zeros(n + 8, dtype=torch.bfloat16)[4:4 + n].view(2, 40, 12, 64)
    for view in (one.expand(2, 40, 4, 64), qkv[..., ::2], off16):
        kept = fp_ops._kernel_operand(view)
        assert kept.data_ptr() != view.data_ptr() and torch.equal(kept, view)
    assert fp_ops._kernel_operand(one).data_ptr() == one.data_ptr()  # extent-1 axes are free


def test_count_sass_counts_opcodes_per_kernel():
    """``_build.count_sass`` (behind chip_smoke.py's HGMMA / UTMALDG check)
    on ``cuobjdump -sass`` text: per matching function, predicated
    instructions included, encoding lines and other functions ignored."""
    from repro_torch.kernels import _build

    sass = "\n".join([
        "\tFunction : _Z20flash_prefill_kernelILi128EEv14CUtensorMap_st",
        "        /*0ce0*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR16], RZ, !UPT, gsb0 ;  /* 0x0 */",
        "                                                                              /* 0x1 */",
        "        /*0cf0*/   @P0 UTMALDG.4D [UR8], [UR4] ;  /* 0x2 */",
        "        /*0d00*/   HGMMA.64x128x16.F32.BF16 R24, R164, gdesc[UR4].tnspB, R24 ;",
        "\tFunction : _Z17bitdecode_kernelILi128EEvv",
        "        /*0ce0*/   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR16], RZ, !UPT, gsb0 ;",
    ])
    counts = _build.count_sass(sass, ("HGMMA", "UTMALDG"), "flash_prefill")
    assert counts == {"_Z20flash_prefill_kernelILi128EEv14CUtensorMap_st":
                      {"HGMMA": 2, "UTMALDG": 1}}
