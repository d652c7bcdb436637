"""The port's DecoderLM against the JAX one on the quickstart path: smoke
configs, the same weights (converted with ``params_from_jax``), a 48-token
prompt, prefill logits and 20 greedy decode steps (one residual flush at
step 16), within the repo's prefill/decode tolerance (rtol 2e-2, atol 3e-1;
tests/test_models_smoke.py).  Both sides are fed the JAX token stream."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import qcache as tq
from repro_torch.models.params import leaves
from repro_torch.models.transformer import XLSTMLM
from repro_torch.models.zoo import build_model

MAX_SEQ, PROMPT, STEPS = 256, 48, 20
TOL = dict(rtol=2e-2, atol=3e-1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; several test workers
    on a shared machine would oversubscribe it.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,ragged", [("llama3-8b", False), ("llama3-8b", True),
                                         ("llama2-7b", False)])
def test_prefill_and_decode_match_jax(arch, ragged):
    jcfg, tcfg = jax_smoke(arch), smoke_config(arch)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)

    rng = np.random.default_rng(1)
    b = 2 if ragged else 1
    tokens = rng.integers(0, tcfg.vocab, size=(b, PROMPT), dtype=np.int32)
    lengths = np.array([PROMPT, 37], np.int32) if ragged else None
    jkw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
    tkw = {} if lengths is None else {"lengths": torch.from_numpy(lengths)}

    jl, jstate = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, MAX_SEQ, **jkw))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, MAX_SEQ, **tkw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))

    step = jax.jit(jm.decode_step)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    jc, tc = jstate["caches"][0], tstate["caches"][0]
    np.testing.assert_array_equal(tc.pack_blocks.numpy(), np.asarray(jc.pack_blocks))
    np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    assert int(tc.pack_blocks[0, 0]) == 1  # the row of PROMPT tokens flushed once
    # layer 0's K/V depend only on the tokens: its packed block matches JAX's
    # code for code up to rare rounding ties in the projections
    agree = np.mean(tc.kw[0].numpy() == np.asarray(jc.kw[0]))
    assert agree > 0.95, agree


def test_decode_from_empty_state_matches_jax():
    """``init_decode_state`` + decode with no prefill: every token goes
    through the residual until the first flush at step ``kv_block``.

    Logits are compared up to the flush.  From the flush on, layer 1 and up
    quantize K/V that differ from JAX's in the last bf16 bit (matmul order),
    some codes differ, and the smoke model's peaked softmax can push single
    logits past the tolerance; layer 0's K/V depend on the tokens alone, so
    its flushed block is compared instead."""
    jcfg, tcfg = jax_smoke("llama3-8b"), smoke_config("llama3-8b")
    jm, tm = jax_build(jcfg), build_model(tcfg)
    jparams = jm.init(jax.random.PRNGKey(3))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    jstate = jm.init_decode_state(2, 128)
    tstate = tm.init_decode_state(2, 128, device="cpu")
    step = jax.jit(jm.decode_step)
    toks = np.random.default_rng(4).integers(0, tcfg.vocab, size=(tcfg.kv_block + 2, 2, 1))
    for i, tok in enumerate(toks.astype(np.int32)):
        jl, jstate = step(jparams, jstate, jnp.asarray(tok))
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(tok))
        if i < tcfg.kv_block - 1:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
    jc, tc = jstate["caches"][0], tstate["caches"][0]
    assert tc.pack_blocks.tolist() == [[1, 1]] * tcfg.n_layers
    np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    np.testing.assert_array_equal(tstate["pos"].numpy(), np.asarray(jstate["pos"]))
    agree = np.mean(tc.kw[0, :, :, 0].numpy() == np.asarray(jc.kw[0, :, :, 0]))
    assert agree > 0.99, agree


def test_random_init_matches_jax_shapes_and_scales():
    """Same leaves and shapes as JAX; every leaf drawn at its definition's
    scale, which is JAX's except for the attention projections (true
    fan-in here, the heads axis in JAX)."""
    tcfg = smoke_config("llama3-8b")
    jparams = jax_build(jax_smoke("llama3-8b")).init(jax.random.PRNGKey(0))
    tparams = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    for path, p in leaves(build_model(tcfg).param_defs()):
        t, j = tparams, jparams
        for key in path:
            t, j = t[key], j[key]
        assert tuple(t.shape) == j.shape and t.dtype == p.dtype, path
        tstd = float(t.float().std()) if p.init != "ones" else 1.0
        jstd = float(jnp.std(j.astype(jnp.float32))) if p.init != "ones" else 1.0
        want = p.std if p.init != "ones" else 1.0
        assert abs(tstd - want) <= 0.1 * want, (path, tstd, want)
        if p.fan_in is None:
            assert abs(jstd - want) <= 0.1 * want, (path, jstd, want)
        else:  # JAX scales by the heads axis: a larger std
            assert path[-2:-1] == ("attn",) and jstd > want, (path, jstd, want)


@pytest.mark.parametrize("arch, change", [("zamba2-7b", dict(rope=False)),
                                          ("zamba2-7b", dict(vision_stub=True)),
                                          ("zamba2-7b", dict(mrope_sections=(8, 4, 4))),
                                          ("llama3-8b", dict(mixer="xlstm")),
                                          ("llama3-8b", dict(rope=False))])
def test_unported_families_raise(arch, change):
    """What the port does not carry yet raises, the hybrid's shared block
    included (``HybridLM`` runs the same refusals).  ``mixer="xlstm"`` is
    ported: it builds ``XLSTMLM`` (here with no mLSTM block a super-block),
    which prefills and decodes."""
    cfg = smoke_config(arch).with_(**change)
    if cfg.mixer == "xlstm":
        m = build_model(cfg)
        assert isinstance(m, XLSTMLM) and m.n_super == cfg.n_layers
        params = m.init(torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            logits, st = m.prefill(params, {"tokens": torch.arange(5)[None]})
            logits, st = m.decode_step(params, st, logits[:, -1].argmax(-1)[:, None])
        assert logits.shape == (1, 1, cfg.padded_vocab) and st["pos"].tolist() == [6]
        assert bool(torch.isfinite(logits[..., :cfg.vocab]).all())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)


def test_suffix_prefill_raises():
    """A suffix prefill (``prior=``) needs the suffix lengths and the prior
    lengths, and one prior per stack; without them it raises.  Its numbers
    are held against JAX in tests/test_torch_paged.py."""
    cfg = smoke_config("llama3-8b")
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    tokens = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="prior"):
        m.prefill(params, tokens, 64, prior=[(None, None)])
    with pytest.raises(ValueError, match="prior"):
        m.prefill(params, tokens, 64, prior=[], lengths=torch.tensor([4]),
                  prior_len=torch.tensor([0]))


def test_entry_points_default_to_the_card():
    """Without a device, the cache, the decode state and the parameters are
    allocated on the card; where there is none they raise rather than fall
    back to the CPU."""
    cfg = smoke_config("llama3-8b")
    m = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    calls = [lambda: tq.init_cache(1, 2, 32, 64).kw,
             lambda: m.init_decode_state(1, 64)["pos"],
             lambda: m.init(gen)["embed"]["table"]]
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
