"""MLA (DeepSeek-V3's latent attention) in the port against the JAX package,
on the CPU, at the smoke size, on the plain versions of the kernels.

* **The shared_kv latent cache** against ``repro.core.qcache`` bit for bit:
  a ragged prefill and masked appends across flushes (dense), appends
  through a scrambled page table, ``copy_pages`` and ``dequant_prior``
  (paged); the port of ``tests/test_qcache.py``'s latent round trip (0.08,
  its tolerance).
* **The plain kernel modes**: K2 / K5's ``shared_kv`` flush bit for bit
  against JAX's ``residual_flush/ref.py``; K3 / K4's ``shared_kv`` read
  against JAX's Pallas kernels in interpret mode (out 2e-2, lse 1e-3); the
  flash-prefill kernel's padded route (zero channels up to an instance)
  on the plain loop against the unpadded loop (1e-6: the same sums in
  another order).
* **models/mla.py**: ``mla_prefill_cache`` with and without a latent prior
  and ``mla_decode`` against JAX's on the same layer parameters (out rtol
  / atol 1e-2, the caches bit for bit).
* **The model**: the deepseek-v3 parameter trees (SMOKE and CONFIG, the
  ``mtp`` head included) leaf for leaf and ``params_from_jax``;
  ``DecoderLM`` through a ragged prefill and 20 decode steps against JAX
  within the family tests' tolerance (rtol 2e-2 / atol 3e-1): JAX's init up
  to the flush with layer 0's latent cache bit for bit, the port's init
  carried to JAX at every step (ROADMAP C).
* **The engine**: the port's versions of the JAX package's five MLA engine
  tests (the paged engine against greedy decoding, prefix sharing with a
  suffix prefill over a latent prior, the donor and a copy-on-write sharer
  bit for bit, self-speculation against sequential decoding, paged by
  default with no V pools), the async runtime against the sync cycle, and
  the launcher's ``--family mla``.

The JAX model is compiled as written (``jit_as_written``, ROADMAP C): the
smoke config routes its MoE layer through a top-k.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_config as jax_smoke
from repro.core import qcache as jq
from repro.kernels.bitdecode import ops as jbd_ops
from repro.kernels.kv_quant import ref as jkq_ref
from repro.kernels.paged_bitdecode import ops as jpg_ops
from repro.kernels.residual_flush import ref as jrf_ref
from repro.models import mla as jmla
from repro.models.params import init_tree as jax_init_tree
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import attention as tcatt
from repro_torch.core import qcache as tq
from repro_torch.kernels.bitdecode import ops as tbd_ops
from repro_torch.kernels.paged_bitdecode import ops as tpg_ops
from repro_torch.kernels.residual_flush import ref as trf_ref
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mla as tmla
from repro_torch.models.params import init_tree, leaves
from repro_torch.models.zoo import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.audit import audit_engine
from repro_torch.serve.scheduler import bucket_for

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=2e-2, atol=3e-1)  # the family tests' logits tolerance
OUT_TOL = dict(rtol=1e-2, atol=1e-2)
BLOCK = 32
LAT_FIELDS = ("kw", "k_scale", "k_zero", "k_res", "pack_blocks", "res_len")
jit_as_written = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; several test workers
    on a shared machine would oversubscribe it.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bits_of(x) -> np.ndarray:
    t = x if isinstance(x, torch.Tensor) else to_torch(np.asarray(x))
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _to_jax(t: torch.Tensor):
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _bf16(x: np.ndarray):
    """One numpy array as (bf16 JAX array, bf16 CPU tensor)."""
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def assert_same_latent(tc, jc, where, fields=LAT_FIELDS):
    for f in fields:
        np.testing.assert_array_equal(bits_of(getattr(tc, f)), bits_of(getattr(jc, f)),
                                      err_msg=f"{f} differs {where}")
    assert jc.vw is None and tc.vw is None and tc.v_res is None and tc.shared_kv


# --------------------------------------------------------------------------
# the shared_kv latent cache against JAX's qcache
# --------------------------------------------------------------------------

B, D_LAT, MAX_SEQ = 3, 160, 160


@jax.jit
def _jax_append(cache, k, mask):
    return jq.append_decode(cache, k, None, quant_impl="xla", mask=mask)


@jax.jit
def _jax_paged_append(cache, k, mask):
    return jq.paged_append_decode(cache, k, None, quant_impl="xla", mask=mask)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_shared_cache_prefill_and_appends_match_jax_bitwise(bits):
    """A ragged prefill (one K1 launch on the card), then 80 masked appends
    across flushes; every field after the prefill and at the end."""
    rng = np.random.default_rng(bits)
    lat = rng.standard_normal((B, 1, 70, D_LAT)).astype(np.float32)
    lengths = np.array([70, 45, 64], np.int32)
    kw = dict(bits=bits, block_n=BLOCK, k_gran="channel", shared_kv=True)
    jl, tl = _bf16(lat)
    jc = jq.prefill(jq.init_cache(B, 1, D_LAT, MAX_SEQ, **kw), jl, None,
                    lengths=jnp.asarray(lengths), quant_impl="xla")
    tc = tq.init_cache(B, 1, D_LAT, MAX_SEQ, device="cpu", **kw)
    tq.prefill(tc, tl, None, lengths=torch.from_numpy(lengths))
    assert_same_latent(tc, jc, "after prefill")
    for step in range(80):
        jk, tk = _bf16(rng.standard_normal((B, 1, 1, D_LAT)).astype(np.float32))
        mask = np.array([True, step % 3 != 1, step % 5 != 0])
        jc = _jax_append(jc, jk, jnp.asarray(mask))
        tq.append_decode(tc, tk, None, mask=torch.from_numpy(mask))
    assert (np.asarray(jc.pack_blocks) >= 3).all()
    assert_same_latent(tc, jc, "at the end")


def test_paged_shared_cache_matches_jax_bitwise():
    """The latent pools behind a scrambled table: 70 masked appends (flushes
    into pages), then ``copy_pages`` and ``dequant_prior`` (``(latent,
    None)``) bit for bit."""
    rng = np.random.default_rng(11)
    n_pages, nb_max = 16, 4
    kw = dict(bits=4, block_n=BLOCK, k_gran="channel", shared_kv=True)
    jc = jq.init_paged_cache(n_pages, B, 1, D_LAT, nb_max, **kw)
    tc = tq.init_paged_cache(n_pages, B, 1, D_LAT, nb_max, device="cpu", **kw)
    table = (B + rng.permutation(n_pages - B)[: B * nb_max]).reshape(B, nb_max).astype(np.int32)
    jc = dataclasses.replace(jc, page_table=jnp.asarray(table))
    tc.page_table.copy_(torch.from_numpy(table))
    for step in range(70):
        jk, tk = _bf16(rng.standard_normal((B, 1, 1, D_LAT)).astype(np.float32))
        mask = np.array([True, step % 4 != 2, True])
        jc = _jax_paged_append(jc, jk, jnp.asarray(mask))
        tq.paged_append_decode(tc, tk, None, mask=torch.from_numpy(mask))
    assert_same_latent(tc, jc, "after the appends")
    assert (np.asarray(jc.pack_blocks) == 2).sum() >= 2
    src, dst = [int(table[0, 0]), int(table[2, 1])], [0, 1]  # onto scratch pages
    jc = jq.copy_pages(jc, jnp.asarray(src), jnp.asarray(dst))
    tq.copy_pages(tc, src, dst)
    assert_same_latent(tc, jc, "after copy_pages")
    pages = table[:, :2]
    jk, jv = jq.dequant_prior(jc, jnp.asarray(pages))
    tk, tv = tq.dequant_prior(tc, torch.from_numpy(pages))
    assert jv is None and tv is None and tuple(tk.shape) == (B, 2 * BLOCK, 1, D_LAT)
    np.testing.assert_array_equal(bits_of(tk), bits_of(jk))


def test_mla_shared_cache_roundtrip():
    """The port of ``tests/test_qcache.py::test_mla_shared_cache_roundtrip``:
    200 latents appended one by one (8 bits), the shared_kv decode against
    softmax attention over the raw latents with V = the first d_v channels,
    within that test's 0.08."""
    b, h, g, d_lat, d_v, n = 2, 2, 4, 128, 128, 200
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.standard_normal((b, h, n, d_lat)).astype(np.float32)).to(
        torch.bfloat16)
    cache = tq.init_cache(b, h, d_lat, 256, bits=8, block_n=BLOCK, shared_kv=True,
                          device="cpu")
    for t in range(n):
        tq.append_decode(cache, k[:, :, t:t + 1], None)
    q = torch.from_numpy(rng.standard_normal((b, 1, h * g, d_lat)).astype(np.float32)).to(
        torch.bfloat16)
    out = tcatt.decode_attention(q, cache, d_v=d_v, impl="torch")
    qt = q.reshape(b, h, g, d_lat).float()
    p = torch.softmax(qt @ k.float().transpose(-1, -2) / d_lat**0.5, dim=-1)
    ref = p @ k[..., :d_v].float()
    np.testing.assert_allclose(out.reshape(b, h, g, d_v).numpy(), ref.numpy(), rtol=0.08,
                               atol=0.08)


# --------------------------------------------------------------------------
# the plain kernel modes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plain_shared_flush_matches_jax_ref_bitwise(paged, bits):
    """K2 / K5's plain ``shared_kv`` flush (K alone) against JAX's
    ``residual_flush/ref.py``, mixed ``full``, a destination past the end."""
    rng = np.random.default_rng(bits + 10 * paged)
    lat = rng.standard_normal((4, 1, 6 * BLOCK, D_LAT)).astype(np.float32)
    kw_, ks_, kz_ = jkq_ref.quantize_kv_ref(jnp.asarray(lat, jnp.bfloat16), bits, "channel",
                                            block_n=BLOCK)
    jres, tres = _bf16(rng.standard_normal((4, 1, BLOCK, D_LAT)).astype(np.float32))
    full = np.array([1, 0, 1, 1], np.int32)
    jpk = [kw_, ks_, kz_]
    if paged:  # [B, H, nb, ...] -> pools [B * nb, H, ...]
        jpk = [jnp.moveaxis(x, 2, 1).reshape(-1, *x.shape[1:2], *x.shape[3:]) for x in jpk]
        dest, fn_j, fn_t = np.array([7, 1, 4, 40], np.int32), \
            jrf_ref.paged_residual_flush_ref, trf_ref.paged_residual_flush_ref
    else:
        dest, fn_j, fn_t = np.array([0, 1, 9, 3], np.int32), \
            jrf_ref.residual_flush_ref, trf_ref.residual_flush_ref
    tpk = [to_torch(np.asarray(x)) for x in jpk]
    kw = dict(bits=bits, block_n=BLOCK, k_gran="channel", shared_kv=True)
    jout = fn_j(*jpk, None, None, None, jres, None, jnp.asarray(full), jnp.asarray(dest), **kw)
    tout = fn_t(*tpk, None, None, None, tres, None, torch.from_numpy(full),
                torch.from_numpy(dest), **kw)
    assert jout[3:] == (None, None, None) and tout[3] is None
    for t, j in zip(tout[:3], jout[:3]):
        np.testing.assert_array_equal(bits_of(t), bits_of(j))


# (g, d_k, d_v, block_n, bits, pack_blocks, res_len): the smoke latent, a
# wider one with g 16
SHARED_DECODE = [(4, 160, 128, 64, 4, [2, 1], [37, 0]),
                 (16, 256, 128, 128, 4, [2, 2], [17, 100])]


@pytest.mark.parametrize("case", SHARED_DECODE)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_plain_shared_decode_matches_jax_pallas(case, paged):
    """K3 / K4's plain ``shared_kv`` read against JAX's Pallas kernels in
    interpret mode (V the first d_v channels of dequantized K and of the K
    residual), out 2e-2, lse 1e-3."""
    g, d_k, d_v, block_n, bits, pb, rl = case
    rng = np.random.default_rng(g + d_k)
    b, nb = 2, 2
    k_full = rng.standard_normal((b, 1, nb * block_n, d_k)) + 3 * rng.standard_normal(d_k)
    packed = jkq_ref.quantize_kv_ref(jnp.asarray(k_full, jnp.bfloat16), bits, "channel",
                                     block_n=block_n)
    jq_, tq_ = _bf16((rng.standard_normal((b, 1, g, d_k)) / d_k**0.25).astype(np.float32))
    jres, tres = _bf16(rng.standard_normal((b, 1, block_n, d_k)).astype(np.float32))
    lens = [np.asarray(x, np.int32) for x in (pb, rl)]
    kw = dict(bits=bits, block_n=block_n, k_gran="channel", shared_kv=True, d_v=d_v,
              return_lse=True)
    if paged:
        jpk = [jnp.moveaxis(x, 2, 1).reshape(-1, *x.shape[1:2], *x.shape[3:]) for x in packed]
        order = rng.permutation(b * nb)
        jpk = [x[np.argsort(order)] for x in jpk]  # page order[i] holds block i
        table = order.reshape(b, nb).astype(np.int32)
        out_j, lse_j = jpg_ops.paged_bitdecode_attention(
            jq_, *jpk, None, None, None, jres, None, jnp.asarray(table),
            *map(jnp.asarray, lens), impl="pallas", num_splits=1, **kw)
        out_t, lse_t = tpg_ops.paged_bitdecode_attention(
            tq_, *[to_torch(np.asarray(x)) for x in jpk], None, None, None, tres, None,
            torch.from_numpy(table), *map(torch.from_numpy, lens), impl="torch", **kw)
    else:
        out_j, lse_j = jbd_ops.bitdecode_attention(
            jq_, *packed, None, None, None, jres, None, *map(jnp.asarray, lens),
            impl="pallas", num_splits=1, **kw)
        out_t, lse_t = tbd_ops.bitdecode_attention(
            tq_, *[to_torch(np.asarray(x)) for x in packed], None, None, None, tres, None,
            *map(torch.from_numpy, lens), impl="torch", **kw)
    assert tuple(out_t.shape) == (b, 1, g, d_v)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dims", [(48, 32), (192, 128), (160, 160)])
def test_padded_prefill_route_equals_unpadded(dims):
    """The flash-prefill kernel's padded route: Q, K, V zero-padded to the
    smallest instance, the caller's ``sm_scale``, the output sliced back.
    Run on the plain loop, it gives the unpadded attention (1e-6: zero
    channels add exact zeros, the sums run in another order)."""
    d_k, d_v = dims
    width = tcatt.padded_head_dim(d_k, d_v)
    assert width == {48: 64, 192: 256, 160: 256}[d_k]
    assert tcatt.padded_head_dim(128, 128) == 128
    rng = np.random.default_rng(d_k)
    b, s, hq, hkv = 2, 70, 4, 2
    q, k = (torch.from_numpy(rng.standard_normal((b, s, h, d_k)).astype(np.float32)).to(
        torch.bfloat16) for h in (hq, hkv))
    v = torch.from_numpy(rng.standard_normal((b, s, hkv, d_v)).astype(np.float32)).to(
        torch.bfloat16)
    scale = 1.0 / 192**0.5
    want = tcatt.blockwise_attention(q, k, v, sm_scale=scale, block_k=32, impl="torch")
    pad = [torch.nn.functional.pad(x, (0, width - x.shape[-1])) for x in (q, k, v)]
    got = tcatt.blockwise_attention(*pad, sm_scale=scale, block_k=32, impl="torch")[..., :d_v]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="exceed"):
        tcatt.padded_head_dim(320, 128)


# --------------------------------------------------------------------------
# models/mla.py against JAX's
# --------------------------------------------------------------------------


def _assert_close_latent(tc, jc, where):
    assert_same_latent(tc, jc, where, fields=("pack_blocks", "res_len"))
    for f in ("k_scale", "k_zero", "k_res"):
        np.testing.assert_allclose(getattr(tc, f).float().numpy(),
                                   np.asarray(getattr(jc, f), np.float32), rtol=1e-2,
                                   atol=1e-2, err_msg=f"{f} {where}")
    assert np.mean(tc.kw.numpy() == np.asarray(jc.kw)) > 0.99, where


def _layer_pair(seed=0):
    """One MLA layer's parameters from the port's init, carried to JAX."""
    tcfg, jcfg = smoke_config(ARCH).with_(kv_block=BLOCK), jax_smoke(ARCH).with_(kv_block=BLOCK)
    tp = init_tree(tmla.mla_def(tcfg), torch.Generator().manual_seed(seed), "cpu")
    return tcfg, jcfg, tp, jax.tree.map(_to_jax, tp)


@pytest.mark.parametrize("with_prior", [False, True], ids=["prefill", "suffix"])
def test_mla_prefill_and_decode_match_jax(with_prior):
    """``mla_prefill_cache`` (ragged; with a latent prior: the suffix attends
    the expanded prior through ``prefix_suffix_attention``), then five
    ``mla_decode`` steps across a flush; the outputs within rtol / atol
    1e-2.  The latents pass through the RMSNorm, whose f32 mean XLA sums in
    another order (a bf16 ulp in a few of 10,240 elements at these N(0, 1)
    inputs), so the caches are held to that: the lengths equal, the
    residual and params within 1e-2, 99% of the packed words equal (bit for
    bit on equal latents: the cache tests above)."""
    tcfg, jcfg, tp, jp = _layer_pair()
    rng = np.random.default_rng(3 + with_prior)
    b, s, d = 2, 29, tcfg.d_model
    jx, tx = _bf16(rng.standard_normal((b, s, d)).astype(np.float32))
    lengths = np.array([29, 20], np.int32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jkw = dict(lengths=jnp.asarray(lengths))
    tkw = dict(lengths=torch.from_numpy(lengths))
    plen = np.zeros(b, np.int32)
    if with_prior:
        t = 2 * BLOCK
        prior = rng.standard_normal((b, t, 1, tcfg.kv_lora + tcfg.qk_rope)).astype(np.float32)
        plen = np.array([64, 32], np.int32)
        pos = pos + plen[:, None]
        jpr, tpr = _bf16(prior)
        jkw |= dict(prior=(jpr, None), prior_len=jnp.asarray(plen))
        tkw |= dict(prior=(tpr, None), prior_len=torch.from_numpy(plen))
    jout, jc = jit_as_written(lambda p, x, ps: jmla.mla_prefill_cache(p, jcfg, x, ps, 96,
                                                                      **jkw))(
        jp, jx, jnp.asarray(pos))
    with torch.no_grad():
        tout, tc = tmla.mla_prefill_cache(tp, tcfg, tx, torch.from_numpy(pos.copy()), 96,
                                          **tkw)
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32), **OUT_TOL)
    _assert_close_latent(tc, jc, "after prefill")
    step = jit_as_written(lambda p, x, ps, c: jmla.mla_decode(p, jcfg, x, ps, c, impl="xla",
                                                              quant_impl="xla"))
    at = (lengths + plen)[:, None]  # each row's next position
    for i in range(5):
        jx1, tx1 = _bf16(rng.standard_normal((b, 1, d)).astype(np.float32))
        jo, jc = step(jp, jx1, jnp.asarray(at + i), jc)
        with torch.no_grad():
            to, tc = tmla.mla_decode(tp, tcfg, tx1, torch.from_numpy(at + i), tc)
        np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                                   err_msg=f"step {i}", **OUT_TOL)
    assert int(tc.pack_blocks[0]) == 1  # row 0 (29 tokens) flushed at step 2
    _assert_close_latent(tc, jc, "after the decode steps")


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _jax_leaves(tree):
    return {tuple(getattr(k, "key", k) for k in kp): (tuple(v.shape), str(v.dtype))
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_param_defs_match_jax(which):
    """Leaf for leaf, shape and dtype, the ``mtp`` head included, without
    drawing the full config; the paged spec is JAX's."""
    tcfg, jcfg = (get_config(ARCH), jax_config(ARCH)) if which == "config" else (
        smoke_config(ARCH), jax_smoke(ARCH))
    tm, jm = build_model(tcfg), jax_build(jcfg)
    assert tm.stacks == jm.stacks
    ours = {path: (p.shape, str(p.dtype).replace("torch.", "")) for path, p in
            leaves(tm.param_defs())}
    assert ours == _jax_leaves(jm.param_shapes())
    assert ("mtp", "proj") in ours and ("stack_0", "attn", "kv_down") in ours
    assert dataclasses.asdict(tm.paged_spec()) == dataclasses.asdict(jm.paged_spec())


def test_params_from_jax_takes_the_mla_leaves():
    """``params_from_jax`` walks ``param_defs()``: every MLA and ``mtp`` leaf
    of a JAX init arrives bit for bit."""
    jcfg, tcfg = jax_smoke(ARCH), smoke_config(ARCH)
    jparams = jax_init_tree(jax_build(jcfg).param_defs(), jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    n = 0
    for path, _ in leaves(build_model(tcfg).param_defs()):
        t, j = tparams, jparams
        for key in path:
            t, j = t[key], j[key]
        np.testing.assert_array_equal(bits_of(t), bits_of(j), err_msg="/".join(path))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jparams))


PROMPT, STEPS = 48, 20
FLUSH = 64 - PROMPT - 1  # kv_block 64: the decode step (from 0) that flushes every row


@pytest.mark.parametrize("init", ["jax", "port"])
def test_decoder_matches_jax(init):
    """A ragged prefill ([48, 37] tokens) and 20 decode steps fed the JAX
    tokens, step FLUSH flushing row 0's latent.  ``init="jax"``: JAX's init
    through ``params_from_jax``, compared at prefill and before the flush,
    and layer 0's latent cache bit for bit after the prefill.
    ``init="port"``: the port's init carried to JAX, compared at every
    step."""
    jm, tm = jax_build(jax_smoke(ARCH)), build_model(smoke_config(ARCH))
    assert tm.stacks == [("mlp", 1), ("moe", 1)]
    if init == "jax":
        jparams = jm.init(jax.random.PRNGKey(0))
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tm.cfg)
        compared = range(FLUSH)
    else:
        tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
        jparams = jax.tree.map(_to_jax, tparams)
        compared = range(STEPS)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tm.cfg.vocab, size=(2, PROMPT), dtype=np.int32)
    lengths = np.array([PROMPT, 37], np.int32)
    jl, jstate = jit_as_written(lambda p, t: jm.prefill(
        p, {"tokens": t}, 256, lengths=jnp.asarray(lengths)))(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 256,
                                lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    if init == "jax":  # layer 0's latents come from the embeddings alone
        assert_same_latent(tstate["caches"][0].layer(0),
                           jax.tree.map(lambda a: a[0], jstate["caches"][0]), "after prefill")
    step = jit_as_written(jm.decode_step)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        if i in compared:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for tc, jc in zip(tstate["caches"], jstate["caches"]):
        np.testing.assert_array_equal(tc.pack_blocks.numpy(), np.asarray(jc.pack_blocks))
        np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    assert tstate["caches"][0].pack_blocks[0].tolist() == [1, 0]  # the 48-token row flushed


# --------------------------------------------------------------------------
# the engine: the port's versions of the JAX package's MLA engine tests
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mla_model():
    cfg = smoke_config(ARCH).with_(kv_bits=4, kv_block=BLOCK)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _greedy(model, params, prompt, max_new, max_seq=128):
    """``DecoderLM``'s greedy decoding of one prompt, prefilled right-padded
    to the engine's bucket (the MoE layer's capacity follows the padded
    length, as in JAX)."""
    n = len(prompt)
    toks = np.zeros((1, bucket_for(n)), np.int64)
    toks[0, :n] = prompt
    with torch.no_grad():
        logits, st = model.prefill(params, {"tokens": torch.from_numpy(toks)}, max_seq,
                                   lengths=torch.tensor([n], dtype=torch.int32))
        tok, out = int(logits[0, -1].argmax()), []
        for _ in range(max_new):
            out.append(tok)
            logits, st = model.decode_step(params, st, torch.tensor([[tok]]))
            tok = int(logits[0, 0].argmax())
    return out


def test_mla_paged_engine_matches_dense_oracle(mla_model):
    """Short and block-crossing prompts, staggered, through the latent page
    pools (prefix sharing and copy on write on, the defaults): each stream
    equals greedy decoding on the dense latent cache."""
    cfg, model, params = mla_model
    rng = np.random.default_rng(3)
    specs = [(30, 6), (7, 5), (44, 4)]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in specs]
    want = [_greedy(model, params, p, mn) for p, (_, mn) in zip(prompts, specs)]
    engine = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=mn)
            for i, (p, (_, mn)) in enumerate(zip(prompts, specs))]
    for r in reqs:
        engine.submit(r)
        engine.step()
    engine.run()
    for r, w in zip(reqs, want):
        assert r.done and r.out_tokens == w, r.uid
    assert engine.pool.n_free == engine.pool.capacity and engine.pool.reserved == 0


def test_mla_prefix_sharing_suffix_prefill(mla_model):
    """A sharer of a resident prefix holds the donor's pages (refcounted)
    and prefills only its divergent suffix, over the dequantized latent
    prior expanded by each layer's up-projections."""
    cfg, model, params = mla_model
    engine = ServeEngine(model, params, slots=2, max_seq=256, device="cpu")
    rng = np.random.default_rng(5)
    pa = rng.integers(0, cfg.vocab, 3 * BLOCK).astype(np.int32)
    pb = np.concatenate([pa[: 2 * BLOCK], rng.integers(0, cfg.vocab, 16).astype(np.int32)])
    a = Request(uid=0, prompt=pa, max_new_tokens=4)
    b = Request(uid=1, prompt=pb, max_new_tokens=4)
    engine.submit(a)
    engine.step()
    tokens_after_a = engine.stats["prefill_tokens"]
    engine.submit(b)
    engine.step()
    assert b.shared_pages == a.pages[:2]
    assert all(engine.pool.refcount(p) == 2 for p in b.shared_pages)
    assert engine.stats["prefill_tokens"] - tokens_after_a == 16
    assert engine.stats["prefill_tokens_saved"] == 2 * BLOCK
    engine.run()
    assert a.done and b.done
    assert engine.pool.n_free == engine.pool.capacity
    assert engine.summary()["prefix_hit_rate"] > 0


def test_mla_sharing_donor_bitwise_and_cow(mla_model):
    """Sharing never perturbs the donor (bit for bit against a solo run),
    and a spec-tail sharer copies on write its first divergent flush on the
    latent pools: nothing shared is read, so the sharer is bit for bit
    too."""
    cfg, model, params = mla_model

    def solo(prompt, max_new):
        eng = ServeEngine(model, params, slots=2, max_seq=256, share_prefix=False,
                          device="cpu")
        r = Request(uid=0, prompt=prompt, max_new_tokens=max_new)
        eng.submit(r)
        eng.run()
        return r.out_tokens

    rng = np.random.default_rng(7)
    pa = rng.integers(0, cfg.vocab, BLOCK + 8).astype(np.int32)
    pb = pa[:8].copy()  # a strict mid-block prefix: the speculative tail
    engine = ServeEngine(model, params, slots=2, max_seq=256, device="cpu")
    a = Request(uid=0, prompt=pa, max_new_tokens=2 * BLOCK)
    b = Request(uid=1, prompt=pb, max_new_tokens=BLOCK)
    engine.submit(a)
    engine.step()
    page_a = a.pages[0]
    engine.submit(b)
    engine.step()
    assert b.spec_page == page_a and engine.pool.refcount(page_a) == 2
    engine.run()
    assert engine.stats["cow_copies"] == 1
    assert b.out_tokens == solo(pb, BLOCK)
    assert a.out_tokens == solo(pa, 2 * BLOCK)
    assert engine.pool.n_free == engine.pool.capacity


def _spec_workload(cfg, n=3):
    rng = np.random.default_rng(42)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(34, 48)))
                    .astype(np.int32), max_new_tokens=int(rng.integers(12, 20)))
            for i in range(n)]


def _run(model, params, reqs, **kw):
    engine = ServeEngine(model, params, slots=2, max_seq=128, device="cpu", **kw)
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    engine.close()
    return engine


def test_spec_matches_sequential_mla(mla_model):
    """Self-speculation (spec_k 2: the draft reads the latent pools at 2
    bits, the verify pass appends masked) emits the sequential streams bit
    for bit; the auditor passes every cycle."""
    cfg, model, params = mla_model
    base = _spec_workload(cfg)
    _run(model, params, base)
    reqs = _spec_workload(cfg)
    engine = _run(model, params, reqs, spec_k=2, audit_every=1)
    for r, w in zip(reqs, base):
        assert r.done and list(r.out_tokens) == list(w.out_tokens), r.uid
    assert engine.stats["spec_cycles"] > 0 and audit_engine(engine).ok


def test_async_runtime_equals_sync_mla(mla_model):
    cfg, model, params = mla_model
    base = _spec_workload(cfg)
    _run(model, params, base)
    reqs = _spec_workload(cfg)
    engine = _run(model, params, reqs, async_runtime=True)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in base]
    assert engine.stats["completions_enqueued"] == len(reqs)


def test_mla_serves_paged_by_default():
    """The latent cache pages through shared_kv pools: no V-side pools."""
    cfg = smoke_config(ARCH).with_(kv_bits=4)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    engine = ServeEngine(model, params, slots=2, max_seq=64, device="cpu")
    assert engine.paged and engine.spec.shared_kv
    assert engine.state["caches"][0].vw is None and engine.state["caches"][0].v_res is None
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 6).astype(np.int32),
                    max_new_tokens=3) for i in range(3)]
    for r in reqs:
        engine.submit(r)
    stats = engine.run()
    assert all(r.done for r in reqs)
    assert stats["decoded_tokens"] == 9


def test_serve_cli_serves_the_mla_family(capsys):
    launch_serve.main(["--family", "mla", "--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--prompt-len", "40", "--max-new", "6",
                       "--max-seq", "128", "--audit-every", "1"])
    out = capsys.readouterr().out
    assert "[serve] engine mode: paged, pool=" in out
    stats = next(line for line in out.splitlines() if line.startswith("[serve] {"))
    assert "'decoded_tokens': 18" in stats
