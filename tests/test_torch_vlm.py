"""The VLM stub with M-RoPE (qwen2-vl-7b: ``DecoderLM`` with
``vision_stub`` and ``mrope_sections``) in the port against the JAX package,
on the CPU, at the smoke size, on the plain versions of the kernels.

* **M-RoPE**: ``apply_rope`` with ``sections`` is, bit for bit, the
  unsectioned RoPE (unchanged) of each band group's own position stream;
  with and without sections it is within one bf16 ulp of JAX's (PyTorch
  and XLA round f32 ``pow``, ``cos`` and ``sin`` apart in the last bit);
  the prefill's and the decode's position ids equal JAX's.
* **The model**: the parameter trees leaf for leaf; a ragged prefill (16
  patches ahead of text of 40 and 33 tokens, ``lengths``) and 20 decode
  steps against JAX's within the family tests' tolerance (rtol 2e-2 / atol
  3e-1): JAX's init up to the first flush, the port's init carried to JAX
  at every step (ROADMAP C); ``pos`` and the caches' lengths count the
  patches (``n_lead``), and the logits are those of each row's last text
  token.
* **Refusals**: a suffix prefill (``prior=``) raises as JAX's does, and the
  engine and the launcher refuse the family with the JAX engine's
  ``ValueError`` (``paged=None`` and ``paged=False``).
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
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttr
from repro_torch.models.params import leaves
from repro_torch.models.zoo import build_model
from repro_torch.serve import ServeEngine

ARCH = "qwen2-vl-7b"
TOL = dict(rtol=2e-2, atol=3e-1)  # the family tests' logits tolerance
MAX_SEQ, PROMPT, STEPS = 128, 40, 20
LENGTHS = (PROMPT, 33)
# kv_block 64 and 16 patches ahead: the first decode step (from 0) to flush a row
FLUSH = 64 - (16 + PROMPT) - 1
jit_as_written = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
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


@pytest.fixture(scope="module")
def models():
    """JAX's smoke model with its ragged prefill and decode step compiled
    once, its init, that init carried to the port, and the port's model."""
    jm = jax_build(jax_smoke(ARCH))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    prefill = jit_as_written(lambda p, x, t, n: jm.prefill(p, {"patches": x, "tokens": t},
                                                           MAX_SEQ, lengths=n))
    step = jit_as_written(jm.decode_step)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), smoke_config(ARCH))
    return jm, jparams, prefill, step, build_model(smoke_config(ARCH)), tparams


# --------------------------------------------------------------------------
# M-RoPE
# --------------------------------------------------------------------------


def _rope_case(sections, hi=5000):
    d = 2 * sum(sections) if sections else 64
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 37, 3, d)).astype(np.float32) * 2.0
    pos = rng.integers(0, hi, size=(3, 2, 37) if sections else (2, 37)).astype(np.int32)
    return x, pos


@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_mrope_is_rope_of_each_band_groups_stream_bitwise(sections):
    """With sections, band group i (channels [off, off + sec) of each half)
    is, bit for bit, the port's unsectioned RoPE at stream ``positions[i]``;
    three equal streams (text tokens) give the unsectioned RoPE itself."""
    x, pos = _rope_case(sections)
    xt, pt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos)
    out = tlayers.apply_rope(xt, pt, theta=1.0e6, sections=sections)
    half, off = sum(sections), 0
    for i, sec in enumerate(sections):
        ref = tlayers.apply_rope(xt, pt[i], theta=1.0e6)
        for lo in (off, half + off):
            np.testing.assert_array_equal(bits_of(out[..., lo:lo + sec]),
                                          bits_of(ref[..., lo:lo + sec]))
        off += sec
    same = pt[:1].expand(3, -1, -1)
    np.testing.assert_array_equal(
        bits_of(tlayers.apply_rope(xt, same, theta=1.0e6, sections=sections)),
        bits_of(tlayers.apply_rope(xt, pt[0], theta=1.0e6)))


@pytest.mark.parametrize("sections", [None, (4, 6, 6), (16, 24, 24)])
def test_apply_rope_matches_jax(sections):
    """[B, S, H, d] bf16 at theta 1e6 (qwen2-vl's), positions below 5,000
    ([B, S], or with sections [3, B, S] of three distinct streams), against
    JAX's within one bf16 ulp of the inputs' magnitude.  Not bit for bit:
    PyTorch and XLA compute the f32 ``theta ** x``, ``cos`` and ``sin`` with
    other approximations (they differ in the last bit in about 5% of
    elements), so an output rounds a bf16 ulp apart now and then, with or
    without sections."""
    x, pos = _rope_case(sections)
    out_j = jax.jit(lambda x, p: jlayers.apply_rope(x, p, theta=1.0e6, sections=sections))(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos))
    out_t = tlayers.apply_rope(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(pos),
                               theta=1.0e6, sections=sections)
    assert out_t.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)
    np.testing.assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32), rtol=0,
                               atol=ulp)


def test_mrope_needs_three_position_streams():
    x = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[3, B, S\]"):
        tlayers.apply_rope(x, torch.zeros((1, 4), dtype=torch.int32), theta=1e4,
                           sections=(4, 6, 6))


def test_mrope_positions_match_jax():
    """The prefill's (patches on a (0, h, w) grid, text at max(grid) on all
    three streams) and the decode's ids, at the smoke and the full grid."""
    for cfg, jcfg in ((smoke_config(ARCH), jax_smoke(ARCH)), (get_config(ARCH),
                                                              jax_config(ARCH))):
        s = cfg.n_patches + 21
        want = np.asarray(jtr._mrope_positions(jcfg, 2, s))
        got = ttr._mrope_positions(cfg, 2, s, "cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        pos = np.array([cfg.n_patches + 5, cfg.n_patches + 40], np.int32)
        want = np.asarray(jtr._mrope_decode_positions(jcfg, jnp.asarray(pos)))
        got = ttr._mrope_decode_positions(cfg, torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_param_defs_match_jax(which):
    """Leaf for leaf, shape and dtype (QKV biases, no vision tower: the
    patches come precomputed), without drawing the full config; neither
    model declares a cache family."""
    tcfg, jcfg = (get_config(ARCH), jax_config(ARCH)) if which == "config" else (
        smoke_config(ARCH), jax_smoke(ARCH))
    tm, jm = build_model(tcfg), jax_build(jcfg)
    ours = {path: (p.shape, str(p.dtype).replace("torch.", "")) for path, p in
            leaves(tm.param_defs())}
    theirs = {tuple(getattr(k, "key", k) for k in kp): (tuple(v.shape), str(v.dtype))
              for kp, v in jax.tree_util.tree_leaves_with_path(jm.param_shapes())}
    assert ours == theirs and ("stack_0", "attn", "bq") in ours
    assert tm.paged_spec() is None and jm.paged_spec() is None


@pytest.mark.parametrize("init", ["jax", "port"])
def test_ragged_prefill_and_decode_match_jax(models, init):
    """16 patches ahead of text of 40 and 33 tokens (``lengths``): the
    prefill's logits (each row's last text token), ``pos`` (lengths + 16)
    and the caches' lengths, then 20 decode steps fed the JAX tokens on
    M-RoPE decode positions.  Row 0's cache flushes at step FLUSH (7), row
    1's at step 14.  ``init="jax"``: compared before the first flush;
    ``init="port"``: at every step (ROADMAP C)."""
    jm, jparams, prefill, step, tm, tparams = models
    if init == "port":
        tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
        jparams = _tmap(_to_jax, tparams)
    compared = range(FLUSH) if init == "jax" else range(STEPS)
    rng = np.random.default_rng(5)
    patches = rng.standard_normal((2, 16, 128)).astype(np.float32)
    tokens = rng.integers(0, tm.cfg.vocab, size=(2, PROMPT), dtype=np.int32)
    lengths = np.array(LENGTHS, np.int32)
    jl, jstate = prefill(jparams, jnp.asarray(patches, jnp.bfloat16), jnp.asarray(tokens),
                         jnp.asarray(lengths))
    batch = {"patches": torch.from_numpy(patches).to(torch.bfloat16),
             "tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, batch, MAX_SEQ, lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    assert tstate["pos"].tolist() == [16 + n for n in LENGTHS]
    tc, jc = tstate["caches"][0], jstate["caches"][0]
    assert tc.res_len[0].tolist() == [16 + n for n in LENGTHS]
    np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        if i in compared:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tc, jc = tstate["caches"][0], jstate["caches"][0]
    for f in ("pack_blocks", "res_len"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    assert tc.pack_blocks[0].tolist() == [1, 1]
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))


def test_unragged_prefill_counts_the_patches(models):
    """Without ``lengths`` the last position is the last text token and
    ``pos`` is patches + tokens, as in JAX."""
    _, _, _, _, tm, tparams = models
    batch = {"patches": torch.zeros((1, 16, 128), dtype=torch.bfloat16),
             "tokens": torch.arange(10)[None]}
    with torch.no_grad():
        lg, st = tm.prefill(tparams, batch, 64)
        lg_r, _ = tm.prefill(tparams, batch, 64, lengths=torch.tensor([10]))
    assert st["pos"].tolist() == [26] and torch.equal(lg, lg_r)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def test_suffix_prefill_with_a_vision_front_raises(models):
    _, _, _, _, tm, tparams = models
    batch = {"patches": torch.zeros((1, 16, 128), dtype=torch.bfloat16),
             "tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="token-only front"):
        tm.prefill(tparams, batch, 64, prior=[(None, None)], lengths=torch.tensor([4]),
                   prior_len=torch.tensor([0]))


@pytest.mark.parametrize("paged", [None, False])
def test_unserveable_family_refused_at_construction(models, paged):
    """The port's version of JAX's test for the VLM stub: ``paged_spec()``
    is None (the prefill needs patch embeddings that a request does not
    carry), so the engine refuses at construction with JAX's ValueError."""
    _, _, _, _, tm, tparams = models
    with pytest.raises(ValueError, match="serveable cache family"):
        ServeEngine(tm, tparams, slots=2, max_seq=64, paged=paged, device="cpu")


def test_launcher_refuses_the_vlm_arch():
    with pytest.raises(ValueError, match="serveable cache family"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
