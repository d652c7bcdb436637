"""The encoder-decoder (seamless-m4t-medium: ``models/encdec.py``,
``EncDecLM``) in the port against the JAX package, on the CPU, at the smoke
size, on the plain versions of the kernels.

* **Full attention at S != T**: ``blockwise_attention_plain(causal=False)``
  against JAX's ``blockwise_attention`` (out within 2e-2), and the
  flash-prefill kernel's plain version against JAX's ``flash_prefill_ref``
  (out 3e-2, lse 1e-3).
* **The cross attention**: ``build_cross_cache`` bit for bit (packed words,
  scales, zeros, residual, lengths) given the same memory, at T a multiple
  of ``kv_block`` and at T = 24 (all in the residual); at T = 100 (a block
  and a residual) the projections within one bf16 ulp and the cache of
  JAX's K/V bit for bit; ``cross_attn_train`` and ``cross_attn_decode``
  within 2e-2, ``encode`` within the logits tolerance.
* **The model**: the parameter trees leaf for leaf, ``EncDecLM.prefill``
  and 20 decode steps against JAX's within the family tests' tolerance
  (rtol 2e-2 / atol 3e-1): the port's init carried to JAX at every step,
  the flush (step 15) and the steps after it included; JAX's init at
  prefill (ROADMAP C: at its scales a decode step's near-tied attention
  weight can move a row past the tolerance).
* **The engine and the launcher** refuse the family with the JAX engine's
  ``ValueError`` (``paged=None`` and ``paged=False``).

The JAX model is compiled as written (``jit_as_written``, ROADMAP C), once
for the module.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_config as jax_smoke
from repro.core import attention as jcatt
from repro.kernels.flash_prefill import ref as jfp_ref
from repro.models import attention as jattn
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.core import attention as tcatt
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention as tattn
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.params import leaves
from repro_torch.models.zoo import build_model
from repro_torch.serve import ServeEngine

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=2e-2, atol=3e-1)  # the family tests' logits tolerance
ATTN_TOL = dict(rtol=2e-2, atol=2e-2)  # attention outputs (the decode tolerance)
MAX_SEQ, PROMPT, STEPS, FRAMES = 128, 48, 20, 24
FLUSH = 64 - PROMPT - 1  # kv_block 64: the decode step (from 0) that flushes every row
# at JAX's init, the steps whose logits are compared: step 9 meets a near tie
JAX_INIT_STEPS = 9
CACHE_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res",
                "pack_blocks", "res_len")
jit_as_written = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
JCFG = jax_smoke(ARCH)
jax_cross_cache = jax.jit(lambda p, m: jattn.build_cross_cache(p, JCFG, m))


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


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _bf16_pair(x: np.ndarray):
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.fixture(scope="module")
def models():
    """JAX's smoke model with its prefill and decode step compiled once,
    its init, that init carried to the port, and the port's model."""
    jm = jax_build(jax_smoke(ARCH))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    prefill = jit_as_written(lambda p, f, t: jm.prefill(p, {"frames": f, "tokens": t}, MAX_SEQ))
    step = jit_as_written(jm.decode_step)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), smoke_config(ARCH))
    return jm, jparams, prefill, step, build_model(smoke_config(ARCH)), tparams


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# --------------------------------------------------------------------------
# the parameter trees
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_param_defs_match_jax(which):
    """Leaf for leaf, shape and dtype (the ``encoder`` / ``decoder`` stacks,
    ``enc_norm``, the cross block's unread biases), without drawing the
    full config; neither model declares a cache family."""
    tcfg, jcfg = (get_config(ARCH), jax_config(ARCH)) if which == "config" else (
        smoke_config(ARCH), jax_smoke(ARCH))
    tm, jm = build_model(tcfg), jax_build(jcfg)
    assert isinstance(tm, EncDecLM)
    ours = {path: (p.shape, str(p.dtype).replace("torch.", "")) for path, p in
            leaves(tm.param_defs())}
    theirs = {tuple(getattr(k, "key", k) for k in kp): (tuple(v.shape), str(v.dtype))
              for kp, v in jax.tree_util.tree_leaves_with_path(jm.param_shapes())}
    assert ours == theirs
    assert ("decoder", "xattn", "bk") in ours and ("enc_norm", "b") in ours
    assert tm.paged_spec() is None and jm.paged_spec() is None
    if which == "config":  # 12 + 12 layers at d 1,024, the vocab padded to 256,256
        assert ours[("embed", "table")][0] == (256256, 1024)
        assert 0.85e9 < sum(np.prod(p.shape) for _, p in leaves(tm.param_defs())) < 0.9e9


def test_params_from_jax_takes_the_encdec_leaves(models):
    """Every leaf of a JAX init arrives bit for bit."""
    _, jparams, _, _, tm, tparams = models
    for path, _ in leaves(tm.param_defs()):
        t, j = tparams, jparams
        for key in path:
            t, j = t[key], j[key]
        np.testing.assert_array_equal(bits_of(t), bits_of(j), err_msg="/".join(path))


# --------------------------------------------------------------------------
# full attention at S != T
# --------------------------------------------------------------------------


@pytest.mark.parametrize("s,t,hq,hkv", [(10, 24, 4, 4), (70, 37, 8, 2)])
def test_blockwise_plain_full_at_s_ne_t_matches_jax(s, t, hq, hkv):
    """``blockwise_attention_plain(causal=False)``, S queries over T keys in
    blocks of 32 (a ragged last block), against JAX's XLA loop."""
    rng = np.random.default_rng(s * t)
    q = rng.standard_normal((2, s, hq, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, t, hkv, 32)).astype(np.float32) for _ in range(2))
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    out_j = jax.jit(functools.partial(jcatt.blockwise_attention, causal=False, block_k=32,
                                      impl="xla"))(qj, kj, vj)
    out_t = tcatt.blockwise_attention_plain(qt, kt, vt, causal=False, sm_scale=32**-0.5,
                                            block_k=32)
    assert out_t.shape == (2, s, hq, 32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j, np.float32), **ATTN_TOL)
    assert torch.equal(out_t, tcatt.blockwise_attention(qt, kt, vt, causal=False, block_k=32))


@pytest.mark.parametrize("s,t,d", [(100, 400, 64), (7, 130, 32)])
def test_flash_prefill_plain_at_s_ne_t_matches_jax_ref(s, t, d):
    """The kernel's plain version in its full mode at S != T against JAX's
    ``flash_prefill_ref(causal=False)``: out 3e-2, lse 1e-3."""
    rng = np.random.default_rng(s + t + d)
    q = rng.standard_normal((2, 8, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, t, d)).astype(np.float32) for _ in range(2))
    (qj, qt), (kj, kt), (vj, vt) = _bf16_pair(q), _bf16_pair(k), _bf16_pair(v)
    out_j, lse_j = jax.jit(functools.partial(jfp_ref.flash_prefill_ref, causal=False))(
        qj, kj, vj)
    out_t, lse_t = fp_ops.flash_prefill_attention(qt, kt, vt, causal=False, return_lse=True)
    assert out_t.shape == (2, 8, s, d) and lse_t.shape == (2, 8, s)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                               rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="S == T"):
        fp_ops.flash_prefill_attention(qt, kt, vt, causal=True)


# --------------------------------------------------------------------------
# the cross attention
# --------------------------------------------------------------------------


def _mem(t, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, t, 128)).astype(np.float32)
    return _bf16_pair(x)


@pytest.mark.parametrize("t", [64, 24])
def test_build_cross_cache_matches_jax_bitwise(models, t):
    """Layer 1's static cross cache of one memory: every field bit for bit
    (T = 64: one packed block; 24: all in the residual)."""
    _, jparams, _, _, _, tparams = models
    cfg, jcfg = smoke_config(ARCH), jax_smoke(ARCH)
    mem_j, mem_t = _mem(t)
    jc = jax_cross_cache(_layer(jparams["decoder"], 1)["xattn"], mem_j)
    tc = tattn.build_cross_cache(_layer(tparams["decoder"], 1)["xattn"], cfg, mem_t)
    assert int(tc.pack_blocks[0]) == t // 64 and int(tc.res_len[0]) == t % 64
    for f in CACHE_FIELDS:
        np.testing.assert_array_equal(bits_of(getattr(tc, f)), bits_of(getattr(jc, f)),
                                      err_msg=f)


def test_cross_cache_of_a_block_and_a_residual_matches_jax(models):
    """T = 100 (a packed block and 36 residual tokens): the K/V projections
    agree with JAX's within one bf16 ulp (the two libraries sum the
    products in another order: at this memory 1 of the 16,384 residual K
    elements rounds a last bit apart), and the cache built from JAX's own
    K/V is JAX's bit for bit."""
    from repro_torch.core import qcache as tq

    _, jparams, _, _, _, tparams = models
    cfg, jcfg = smoke_config(ARCH), jax_smoke(ARCH)
    mem_j, mem_t = _mem(100)
    pj, pt = _layer(jparams["decoder"], 1)["xattn"], _layer(tparams["decoder"], 1)["xattn"]
    jc = jax_cross_cache(pj, mem_j)
    kj, vj = (jnp.einsum("btd,dhk->bthk", mem_j, pj[w]) for w in ("wk", "wv"))
    for ours, theirs in zip(tattn.mem_kv(pt, mem_t), (kj, vj)):
        ulps = np.abs(bits_of(ours).astype(np.int32) - bits_of(theirs).astype(np.int32))
        assert ulps.max() <= 1
    tc = tq.init_cache(2, cfg.n_kv_heads, cfg.head_dim, 100, bits=cfg.kv_bits,
                       block_n=cfg.kv_block, k_gran=cfg.kv_gran, device="cpu")
    tc = tq.prefill(tc, *(to_torch(np.asarray(x)).transpose(1, 2) for x in (kj, vj)))
    assert tc.pack_blocks.tolist() == [1, 1] and tc.res_len.tolist() == [36, 36]
    for f in CACHE_FIELDS:
        np.testing.assert_array_equal(bits_of(getattr(tc, f)), bits_of(getattr(jc, f)),
                                      err_msg=f)


@pytest.mark.parametrize("t", [64, 100])
def test_cross_attention_matches_jax(models, t):
    """``cross_attn_train`` (no mask, S != T) and ``cross_attn_decode`` (the
    static cache's read, no append) of layer 0 against JAX's, within 2e-2;
    neither reads the cross block's biases, so nonzero ones change
    nothing."""
    _, jparams, _, _, _, tparams = models
    cfg, jcfg = smoke_config(ARCH), jax_smoke(ARCH)
    mem_j, mem_t = _mem(t, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 5, 128)).astype(np.float32)
    xj, xt = _bf16_pair(x)
    pj, pt = _layer(jparams["decoder"], 0)["xattn"], _layer(tparams["decoder"], 0)["xattn"]
    out_j = jax.jit(lambda p, x, m: jattn.cross_attn_train(p, jcfg, x, m))(pj, xj, mem_j)
    biased = dict(pt, **{b: torch.ones_like(pt[b]) for b in ("bq", "bk", "bv")})
    out_t = tattn.cross_attn_train(biased, cfg, xt, mem_t)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32), **ATTN_TOL)

    jc = jax_cross_cache(pj, mem_j)
    tc = tattn.build_cross_cache(pt, cfg, mem_t)
    dec_j = jax.jit(lambda p, x, c: jattn.cross_attn_decode(p, jcfg, x, c))(pj, xj[:, :1], jc)
    dec_t = tattn.cross_attn_decode(biased, cfg, xt[:, :1], tc)
    assert dec_t.shape == (2, 1, 128)
    np.testing.assert_allclose(dec_t.float().numpy(), np.asarray(dec_j, np.float32), **ATTN_TOL)
    assert torch.equal(tc.res_len, torch.full((2,), t % 64, dtype=torch.int32))


def _tie_block() -> np.ndarray:
    """A [128, 8] K block whose channel 0 spans [-3.046875, -0.10986328125]
    (a seamless cross cache's, from the card): (max - min) / 15 is
    0.19580078125 exactly, halfway between two bf16 values."""
    rng = np.random.default_rng(7)
    x = rng.uniform(-2.0, 2.0, (128, 8)).astype(np.float32)
    x[:, 0] = np.linspace(-3.046875, -0.10986328125, 128, dtype=np.float32)
    return x


def test_quant_params_at_an_exact_bf16_tie_match_jax():
    """The scale of a channel whose quotient is an exact bf16 tie rounds to
    even, as JAX's IEEE division does (0.1953125, not 0.1962890625): the
    plain version divides by qmax as a tensor, so PyTorch's CUDA kernel does
    not multiply by its reciprocal on the card (ROADMAP C)."""
    from repro.core import quantizer as jquant
    from repro_torch.core import quantizer as tquant

    x = _tie_block()
    xj, xt = _bf16_pair(x)
    assert np.float32(np.float32(-0.10986328125) - np.float32(-3.046875)) / np.float32(15) == \
        np.float32(0.19580078125)
    sj, zj = jquant.quant_params(xj, 4, "channel", param_dtype=jnp.bfloat16)
    st, zt = tquant.quant_params(xt, 4, "channel")
    assert float(st[0]) == 0.1953125
    np.testing.assert_array_equal(bits_of(st), bits_of(sj))
    np.testing.assert_array_equal(bits_of(zt), bits_of(zj))


def test_encode_matches_jax(models):
    """The encoder (full self attention with RoPE and biases, LayerNorm,
    GELU MLP, ``enc_norm``) over 24 frames."""
    jm, jparams, _, _, tm, tparams = models
    mem_j, mem_t = _mem(FRAMES, seed=3)
    out_j = jit_as_written(jm.encode)(jparams, mem_j)
    out_t = tm.encode(tparams, mem_t)
    assert out_t.dtype == torch.bfloat16 and out_t.shape == (2, FRAMES, 128)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32), **TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("init", ["jax", "port"])
def test_prefill_and_decode_match_jax(models, init):
    """Prefill logits over 24 stub frames, then 20 decode steps fed the JAX
    tokens; step FLUSH (15) flushes every row's self cache and the steps
    from there on read the packed block.

    ``init="port"``: the port's init carried to JAX leaf for leaf, logits
    compared at prefill and at every step.  ``init="jax"``: JAX's init
    through ``params_from_jax``, logits compared at prefill and at the
    steps before step JAX_INIT_STEPS (9); the later steps run and their
    caches are compared, not their logits.  At JAX's init scales the scores
    have a standard deviation near 32, and a last-bit difference of the
    products moves a near-tied attention weight: here row 1 of step 9 lands
    1.06 from JAX's logits, and the next step 0.03 (with JAX's own encoder
    memory fed to the port too), while at the port's init no step departs
    by more than 0.05 (ROADMAP C).  At both, the self caches' and the cross
    caches' lengths are JAX's and the cross caches never change."""
    jm, jparams, prefill, step, tm, tparams = models
    if init == "port":
        tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
        jparams = _tmap(_to_jax, tparams)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, FRAMES, 128)).astype(np.float32)
    tokens = rng.integers(0, tm.cfg.vocab, size=(2, PROMPT), dtype=np.int32)
    fj, ft = _bf16_pair(frames)
    jl, jstate = prefill(jparams, fj, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"frames": ft, "tokens": torch.from_numpy(tokens)},
                                MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    cross = tstate["cross"].kw.clone()
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        if init == "port" or i < JAX_INIT_STEPS:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for which in ("self", "cross"):
        for f in ("pack_blocks", "res_len"):
            np.testing.assert_array_equal(getattr(tstate[which], f).numpy(),
                                          np.asarray(getattr(jstate[which], f)))
    assert tstate["self"].pack_blocks[0].tolist() == [1, 1]
    assert tstate["cross"].res_len[0].tolist() == [FRAMES, FRAMES]
    assert torch.equal(cross, tstate["cross"].kw)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


def test_init_decode_state_shapes():
    """Self caches of max_seq, cross caches of ``enc_len`` (64: one block),
    stacked over the decoder layers, allocated where asked."""
    tm = build_model(smoke_config(ARCH))
    st = tm.init_decode_state(3, 200, device="cpu")
    assert tuple(st["self"].kw.shape[:4]) == (2, 3, 4, 4)  # 200 tokens: 4 blocks of 64
    assert tuple(st["cross"].kw.shape[:4]) == (2, 3, 4, 1)
    assert st["pos"].tolist() == [0, 0, 0]


# --------------------------------------------------------------------------
# the engine and the launcher
# --------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [None, False])
def test_unserveable_family_refused_at_construction(models, paged):
    """``paged_spec()`` is None (the prefill needs frame embeddings that a
    request does not carry): the engine refuses at construction with the
    JAX engine's ValueError, before its ``paged=False`` refusal."""
    _, _, _, _, tm, tparams = models
    with pytest.raises(ValueError, match="serveable cache family"):
        ServeEngine(tm, tparams, slots=2, max_seq=64, paged=paged, device="cpu")


def test_launcher_refuses_the_encdec_arch():
    with pytest.raises(ValueError, match="serveable cache family"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
