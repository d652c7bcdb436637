"""The port's paged decode path against the JAX package, on the CPU.

Plain versions of the two paged kernels (``paged_bitdecode`` within the
reference's tolerances, out 2e-2 / lse 1e-3; ``paged_residual_flush`` bit for
bit), the paged cache (``init_paged_cache``, ``paged_append_decode`` through a
scrambled page table across flushes, ``copy_pages``, ``dequant_prior``: bit
for bit), ``prefix_suffix_attention`` (2e-2, and chunked against unchunked)
and ``DecoderLM.prefill(prior=...)`` (the prefill/decode tolerance, rtol 2e-2
/ atol 3e-1).  Inputs are made with numpy from a seed and handed to both.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_gpu.py.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.core import attention as jatt
from repro.core import qcache as jq
from repro.kernels.kv_quant import ref as jkq_ref
from repro.kernels.paged_bitdecode import ops as jpg_ops
from repro.kernels.residual_flush import ops as jrf_ops
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import attention as tatt
from repro_torch.core import qcache as tq
from repro_torch.kernels.paged_bitdecode import ops as pg_ops
from repro_torch.kernels.residual_flush import ops as rf_ops
from repro_torch.models.zoo import build_model

PAGED_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
                "page_table", "pack_blocks", "res_len")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; several test workers
    on a shared machine would oversubscribe it.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_of(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def from_jax(x) -> torch.Tensor:
    return to_torch(np.asarray(x))


def bf16(a: np.ndarray):
    return jnp.asarray(a, jnp.bfloat16)


def assert_same(t: torch.Tensor, j, what: str) -> None:
    np.testing.assert_array_equal(bits_of(t), bits_of(from_jax(j)), err_msg=what)


# ---------------------------------------------------------- paged_bitdecode


def _pools(rng, *, h, n_pages, block_n, d, bits, k_gran, v_off):
    """Pools [P, H, ...] quantized from random K/V (V with per-channel
    offsets, so the output is O(1) beside the 2e-2 tolerance)."""
    k = rng.standard_normal((1, h, n_pages * block_n, d)).astype(np.float32)
    v = rng.standard_normal((1, h, n_pages * block_n, d)).astype(np.float32) + v_off
    kq = jkq_ref.quantize_kv_ref(bf16(k), bits, k_gran, block_n=block_n)
    vq = jkq_ref.quantize_kv_ref(bf16(v), bits, "tensor", block_n=block_n)
    return [jnp.moveaxis(x[0], 1, 0) for x in (*kq, *vq)]


def _paged_case(seed, *, b=2, h=2, g=4, d=32, block_n=64, nb=3, n_pages=8, bits=4,
                k_gran="channel", res_len=17):
    rng = np.random.default_rng(seed)
    v_off = 2.0 * rng.standard_normal(d).astype(np.float32)
    pools = _pools(rng, h=h, n_pages=n_pages, block_n=block_n, d=d, bits=bits,
                   k_gran=k_gran, v_off=v_off)
    q = rng.standard_normal((b, h, g, d)).astype(np.float32)
    k_res = rng.standard_normal((b, h, block_n, d)).astype(np.float32)
    v_res = rng.standard_normal((b, h, block_n, d)).astype(np.float32) + v_off
    table = rng.permutation(n_pages)[: b * nb].reshape(b, nb).astype(np.int32)
    pb = np.array([nb, nb - 1], np.int32)
    rl = np.array([res_len, 5], np.int32)
    jargs = [bf16(q), *pools, bf16(k_res), bf16(v_res), jnp.asarray(table),
             jnp.asarray(pb), jnp.asarray(rl)]
    return jargs, [from_jax(a) for a in jargs]


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
@pytest.mark.parametrize("num_splits", [1, 2])
@pytest.mark.parametrize("res_len", [0, 17])
def test_paged_bitdecode_plain_matches_jax(bits, k_gran, num_splits, res_len):
    jargs, targs = _paged_case(bits * 10 + num_splits, bits=bits, k_gran=k_gran,
                               res_len=res_len)
    kw = dict(bits=bits, block_n=64, k_gran=k_gran, return_lse=True, num_splits=num_splits)
    out_j, lse_j = jpg_ops.paged_bitdecode_attention(*jargs, impl="xla", **kw)
    out_t, lse_t = pg_ops.paged_bitdecode_attention(*targs, impl="auto", **kw)
    assert float(out_t.abs().max()) > 0.5  # the tolerance is small beside the output
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-3, atol=1e-3)


def test_paged_bitdecode_plain_matches_jax_pallas_interpret():
    """The TPU kernel itself, in interpret mode (nb <= 8, as its own tests)."""
    jargs, targs = _paged_case(7, d=128, block_n=128, nb=3, n_pages=6)
    kw = dict(bits=4, block_n=128, k_gran="channel", return_lse=True, num_splits=2)
    out_j, lse_j = jpg_ops.paged_bitdecode_attention(*jargs, impl="pallas", **kw)
    out_t, lse_t = pg_ops.paged_bitdecode_attention(*targs, impl="torch", **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-3, atol=1e-3)


# ----------------------------------------------------- paged_residual_flush


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("k_gran", ["channel", "tensor"])
def test_paged_residual_flush_plain_matches_jax_bitwise(bits, k_gran):
    rng = np.random.default_rng(200 + bits)
    pools = _pools(rng, h=2, n_pages=9, block_n=64, d=32, bits=bits, k_gran=k_gran,
                   v_off=0.0)
    res = [bf16(rng.standard_normal((4, 2, 64, 32)).astype(np.float32)) for _ in range(2)]
    full = jnp.asarray([1, 0, 1, 1], jnp.int32)
    dest = jnp.asarray([6, 1, 4, 20], jnp.int32)  # row 1 at its scratch page; 20 clamps
    kw = dict(bits=bits, block_n=64, k_gran=k_gran)
    ref = jrf_ops.paged_residual_flush(*pools, *res, full, dest, impl="xla", **kw)
    tpools = [from_jax(p) for p in pools]
    out = rf_ops.paged_residual_flush(*tpools, *(from_jax(r) for r in res), from_jax(full),
                                      from_jax(dest), impl="auto", **kw)
    for o, t, r in zip(out, tpools, ref):
        assert o is t  # in place
        np.testing.assert_array_equal(bits_of(o), bits_of(from_jax(r)))


# ------------------------------------------------------------- paged qcache

B, H, D, BLOCK, N_PAGES, NB_MAX = 3, 2, 32, 16, 16, 4


def test_init_paged_cache_matches_jax():
    kw = dict(bits=4, block_n=BLOCK, k_gran="channel")
    jc = jq.init_paged_cache(N_PAGES, B, H, D, NB_MAX, **kw)
    tc = tq.init_paged_cache(N_PAGES, B, H, D, NB_MAX, device="cpu", **kw)
    for f in PAGED_FIELDS:
        assert_same(getattr(tc, f), getattr(jc, f), f)
    with pytest.raises(ValueError, match="scratch"):
        tq.init_paged_cache(B, B, H, D, NB_MAX, device="cpu")


@pytest.mark.parametrize("bits,k_gran", [(4, "channel"), (2, "tensor")])
def test_paged_append_decode_through_scrambled_table_matches_jax(bits, k_gran):
    """Masked appends through a scrambled table, every row flushing at least
    twice: all fields bit for bit along the way."""
    rng = np.random.default_rng(bits)
    kw = dict(bits=bits, block_n=BLOCK, k_gran=k_gran)
    table = (B + rng.permutation(N_PAGES - B)[: B * NB_MAX]).reshape(B, NB_MAX)
    jc = dataclasses.replace(jq.init_paged_cache(N_PAGES, B, H, D, NB_MAX, **kw),
                             page_table=jnp.asarray(table, jnp.int32))
    tc = tq.init_paged_cache(N_PAGES, B, H, D, NB_MAX, device="cpu", **kw)
    tc.page_table.copy_(torch.from_numpy(table))
    append = jax.jit(functools.partial(jq.paged_append_decode, quant_impl="xla"))
    for step in range(44):
        kn = rng.standard_normal((B, H, 1, D)).astype(np.float32)
        vn = rng.standard_normal((B, H, 1, D)).astype(np.float32)
        mask = np.array([True, step % 5 != 0, True])
        jc = append(jc, bf16(kn), bf16(vn), mask=jnp.asarray(mask))
        out = tq.paged_append_decode(tc, torch.from_numpy(kn).to(torch.bfloat16),
                                     torch.from_numpy(vn).to(torch.bfloat16),
                                     mask=torch.from_numpy(mask))
        assert out is tc
        if step in (15, 31, 43):
            for f in PAGED_FIELDS:
                assert_same(getattr(tc, f), getattr(jc, f), f"{f} after step {step}")
    assert (tc.pack_blocks >= 2).all()


def _random_stacked(seed, layers=2):
    """A layer-stacked paged cache with random pool contents, both sides."""
    rng = np.random.default_rng(seed)
    one = jq.init_paged_cache(N_PAGES, B, H, D, NB_MAX, bits=4, block_n=BLOCK)
    upd = {}
    for f in jq._PAGED_POOL_FIELDS:
        shape = (layers, *getattr(one, f).shape)
        if f in ("kw", "vw"):
            upd[f] = jnp.asarray(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                                 .astype(np.int32))
        else:
            upd[f] = bf16(0.1 + rng.random(shape).astype(np.float32))
    jc = dataclasses.replace(one, **upd)
    tc = tq.init_paged_cache(N_PAGES, B, H, D, NB_MAX, bits=4, block_n=BLOCK,
                             layers=layers, device="cpu")
    for f in jq._PAGED_POOL_FIELDS:
        getattr(tc, f).copy_(from_jax(upd[f]))
    return jc, tc


def test_copy_pages_and_dequant_prior_match_jax_bitwise():
    jc, tc = _random_stacked(5)
    src, dst = [4, 7], [9, 3]
    jc = jq.copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    assert tq.copy_pages(tc, src, dst) is tc
    for f in jq._PAGED_POOL_FIELDS:
        assert_same(getattr(tc, f), getattr(jc, f), f)
    pages = np.array([[3, 9, 0], [5, 6, 8], [15, 11, 4]], np.int32)
    for t, j in zip(tq.dequant_prior(tc, torch.from_numpy(pages)),
                    jq.dequant_prior(jc, jnp.asarray(pages))):
        assert t.shape == (2, B, 3 * BLOCK, H, D)
        assert_same(t, j, "dequant_prior")


# ------------------------------------------------- prefix_suffix_attention


def test_prefix_suffix_attention_matches_jax_and_is_chunk_invariant():
    rng = np.random.default_rng(11)
    b, s, t, h_q, h_kv, d = 2, 24, 32, 4, 2, 32
    q, k, v = (rng.standard_normal(sh).astype(np.float32) for sh in
               ((b, s, h_q, d), (b, s, h_kv, d), (b, s, h_kv, d)))
    kp, vp = (rng.standard_normal((b, t, h_kv, d)).astype(np.float32) for _ in range(2))
    plen = np.array([t, 9], np.int32)
    ref = jatt.prefix_suffix_attention(*(bf16(x) for x in (q, k, v, kp, vp)),
                                       jnp.asarray(plen))
    targs = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, kp, vp)]
    whole = tatt.prefix_suffix_attention(*targs, torch.from_numpy(plen))
    chunked = tatt.prefix_suffix_attention(*targs, torch.from_numpy(plen), q_chunk=5)
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=2e-2, atol=2e-2)


# ------------------------------------------------------ suffix prefill


def test_suffix_prefill_matches_jax():
    """``DecoderLM.prefill(prior=, prior_len=)``: a ragged suffix batch over a
    prior of dequantized pages; last-token logits and cache occupancy."""
    jcfg, tcfg = jax_smoke("llama3-8b"), smoke_config("llama3-8b")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(12)
    b, s, t = 2, 40, 2 * tcfg.kv_block
    shape = (tcfg.n_layers, b, t, tcfg.n_kv_heads, tcfg.head_dim)
    kp, vp = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    tokens = rng.integers(0, tcfg.vocab, (b, s)).astype(np.int32)
    lengths = np.array([s, 23], np.int32)
    plen = np.array([t, tcfg.kv_block], np.int32)
    jl, jstate = jm.prefill(jparams, {"tokens": jnp.asarray(tokens)}, s,
                            lengths=jnp.asarray(lengths), prior=[(bf16(kp), bf16(vp))],
                            prior_len=jnp.asarray(plen))
    with torch.no_grad():
        tl, tstate = tm.prefill(
            tparams, {"tokens": torch.from_numpy(tokens).long()}, s,
            lengths=torch.from_numpy(lengths),
            prior=[tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (kp, vp))],
            prior_len=torch.from_numpy(plen))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-2, atol=3e-1)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    for f in ("pack_blocks", "res_len"):
        np.testing.assert_array_equal(getattr(tstate["caches"][0], f).numpy(),
                                      np.asarray(getattr(jstate["caches"][0], f)))
