"""The residual-flush kernel's append mode (a decode step's whole cache
update: token write, flush of the rows it fills, lengths), plain version,
against the JAX package's ``append_decode`` / ``paged_append_decode``
(``quant_impl="xla"``), bit for bit on the CPU.

Each case starts from a cache mid-run (random packed blocks or pool pages,
random residuals, rows at different ``res_len``), then appends over
``STEPS`` consecutive steps with a masked row or two, through a scrambled
page table when paged, and compares every field after every step; every row
flushes at least twice.  The CUDA kernel is held against this plain version
on the card in tests/test_torch_gpu.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qcache as jq
from repro.kernels.kv_quant import ref as jkq_ref
from repro_torch.convert import to_torch
from repro_torch.kernels.residual_flush import ops as rf_ops

B, H, D, BLOCK, NB, N_PAGES = 3, 2, 32, 16, 6, 24
STEPS = 3 * BLOCK + 4
PACKED = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")


def bits_of(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def from_jax(x) -> torch.Tensor:
    return to_torch(np.asarray(x))


def _mid_run_cache(rng, paged, bits, k_gran):
    """A JAX cache with random contents: packed blocks (dense [B, H, NB,
    ...]) or pool pages ([N_PAGES, H, ...]) quantized from random K/V, random
    residuals, pack_blocks [0, 1, 0], res_len [3, 10, 15], and when paged a
    scrambled table over the pages past the scratch pages [0, B)."""
    kw = dict(bits=bits, block_n=BLOCK, k_gran=k_gran)
    rows, n = (1, N_PAGES * BLOCK) if paged else (B, NB * BLOCK)
    x = [jnp.asarray(rng.standard_normal((rows, H, n, D)), jnp.bfloat16) for _ in range(2)]
    packed = [*jkq_ref.quantize_kv_ref(x[0], bits, k_gran, block_n=BLOCK),
              *jkq_ref.quantize_kv_ref(x[1], bits, "tensor", block_n=BLOCK)]
    res = [jnp.asarray(rng.standard_normal((B, H, BLOCK, D)), jnp.bfloat16) for _ in range(2)]
    lens = dict(pack_blocks=jnp.asarray([0, 1, 0], jnp.int32),
                res_len=jnp.asarray([3, 10, 15], jnp.int32))
    if paged:
        cache = jq.init_paged_cache(N_PAGES, B, H, D, NB, **kw)
        packed = [jnp.moveaxis(p[0], 1, 0) for p in packed]
        table = B + rng.permutation(N_PAGES - B)[:B * NB].reshape(B, NB)
        lens["page_table"] = jnp.asarray(table, jnp.int32)
    else:
        cache = jq.init_cache(B, H, D, NB * BLOCK, **kw)
    return dataclasses.replace(cache, **dict(zip(PACKED, packed)), k_res=res[0], v_res=res[1],
                               **lens)


@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_append_mode_plain_matches_jax_bitwise(paged, bits, k_gran):
    rng = np.random.default_rng(10 * bits + paged)
    jc = _mid_run_cache(rng, paged, bits, k_gran)
    fields = [*PACKED, "k_res", "v_res", *(("page_table",) if paged else ()), "pack_blocks",
              "res_len"]
    t = {f: from_jax(getattr(jc, f)) for f in fields}
    arrive = torch.zeros(B, dtype=torch.int32)
    jax_append = jax.jit(functools.partial(
        jq.paged_append_decode if paged else jq.append_decode, quant_impl="xla"))
    append = rf_ops.paged_append_flush if paged else rf_ops.append_flush
    start = t["pack_blocks"].clone()
    for step in range(STEPS):
        kn, vn = (rng.standard_normal((B, H, 1, D)).astype(np.float32) for _ in range(2))
        mask = np.array([True, step % 3 != 1, step % 4 != 0])
        jc = jax_append(jc, jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16),
                        mask=jnp.asarray(mask))
        out = append(*(t[f] for f in fields[:8]), torch.from_numpy(kn).to(torch.bfloat16),
                     torch.from_numpy(vn).to(torch.bfloat16), *(t[f] for f in fields[8:]),
                     arrive, mask=torch.from_numpy(mask), bits=bits, block_n=BLOCK,
                     k_gran=k_gran)
        assert all(o is t[f] for o, f in zip(out, PACKED))  # in place
        for f in fields:
            np.testing.assert_array_equal(bits_of(t[f]), bits_of(from_jax(getattr(jc, f))),
                                          err_msg=f"{f} differs after step {step}")
    assert (t["pack_blocks"] - start).min() >= 2
    assert not arrive.any()
