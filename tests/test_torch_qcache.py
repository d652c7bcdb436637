"""The port's dense quantized cache against ``repro.core.qcache``, bit for
bit: a ragged prefill, then masked decode appends across two flushes per
row, every field compared after the prefill and along the way."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qcache as jq
from repro_torch.convert import to_torch
from repro_torch.core import qcache as tq

B, H, D, BLOCK, MAX_SEQ, L = 3, 2, 32, 32, 160, 70
FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
          "pack_blocks", "res_len")


def bits_of(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def assert_same_cache(tc, jc, where):
    for f in FIELDS:
        np.testing.assert_array_equal(
            bits_of(getattr(tc, f)), bits_of(to_torch(np.asarray(getattr(jc, f)))),
            err_msg=f"{f} differs {where}",
        )


@jax.jit
def _jax_append(cache, k, v, mask):
    return jq.append_decode(cache, k, v, quant_impl="xla", mask=mask)


@pytest.mark.parametrize("bits,k_gran", [(4, "channel"), (2, "tensor"), (8, "channel")])
def test_prefill_and_masked_appends_match_jax_bitwise(bits, k_gran):
    rng = np.random.default_rng(bits)
    k = rng.standard_normal((B, H, L, D)).astype(np.float32)
    v = rng.standard_normal((B, H, L, D)).astype(np.float32)
    lengths = np.array([70, 45, 64], np.int32)
    kw = dict(bits=bits, block_n=BLOCK, k_gran=k_gran)

    jc = jq.prefill(jq.init_cache(B, H, D, MAX_SEQ, **kw), jnp.asarray(k, jnp.bfloat16),
                    jnp.asarray(v, jnp.bfloat16), lengths=jnp.asarray(lengths),
                    quant_impl="xla")
    tc = tq.init_cache(B, H, D, MAX_SEQ, device="cpu", **kw)
    assert tq.prefill(tc, torch.from_numpy(k).to(torch.bfloat16),
                      torch.from_numpy(v).to(torch.bfloat16),
                      lengths=torch.from_numpy(lengths), quant_impl="torch") is tc
    assert_same_cache(tc, jc, "after prefill")

    flushes = np.zeros(B, int)
    for step in range(90):
        kn = rng.standard_normal((B, H, 1, D)).astype(np.float32)
        vn = rng.standard_normal((B, H, 1, D)).astype(np.float32)
        mask = np.array([True, step % 3 != 1, step % 5 != 0])
        before = np.asarray(jc.pack_blocks)
        jc = _jax_append(jc, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
                         jnp.asarray(mask))
        tq.append_decode(tc, torch.from_numpy(kn).to(torch.bfloat16),
                         torch.from_numpy(vn).to(torch.bfloat16),
                         mask=torch.from_numpy(mask), quant_impl="auto")
        flushes += np.asarray(jc.pack_blocks) - before
        if step in (20, 50):
            assert_same_cache(tc, jc, f"after step {step}")
    assert (flushes >= 2).all(), flushes
    assert_same_cache(tc, jc, "at the end")
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_flushed_block_equals_prefilled_block():
    """A block committed by the decode-time flush is bitwise the block an
    exact-length prefill of the same tokens packs."""
    rng = np.random.default_rng(3)
    n = 2 * BLOCK
    k = torch.from_numpy(rng.standard_normal((B, H, n, D)).astype(np.float32)).to(torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((B, H, n, D)).astype(np.float32)).to(torch.bfloat16)
    empty = lambda: tq.init_cache(B, H, D, MAX_SEQ, block_n=BLOCK, device="cpu")  # noqa: E731
    pre = tq.prefill(empty(), k, v)
    inc = tq.prefill(empty(), k[:, :, :3], v[:, :, :3])
    for t in range(3, n):
        tq.append_decode(inc, k[:, :, t:t + 1], v[:, :, t:t + 1])
    for f in FIELDS[:6]:
        np.testing.assert_array_equal(bits_of(getattr(inc, f)), bits_of(getattr(pre, f)))
    assert inc.pack_blocks.tolist() == [2] * B and inc.res_len.tolist() == [0] * B
