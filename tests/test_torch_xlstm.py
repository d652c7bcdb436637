"""The recurrent xLSTM family (xlstm-1.3b: ``models/xlstm.py``, ``XLSTMLM``)
and the serving engine's exact-length shim (``paged=False``) in the port
against the JAX package, on the CPU, at the smoke size (d 64, 2 heads, 4
layers in 2 super-blocks of 1 mLSTM + 1 sLSTM).

* **The model's pieces**: the parameter trees (SMOKE and CONFIG) leaf for
  leaf and the paged spec; ``params_from_jax`` carrying the f32 gate leaves
  and the bf16 recurrence unchanged; ``_mlstm_cell`` and ``_slstm_cell``
  over 40 steps within 1e-5; ``mlstm_chunkwise`` against JAX's at S 32 /
  64 / 96, chunk 16 / 32, gate scales 1 / 5 / 20 within the JAX test's
  2e-4; ``mlstm_block`` and ``slstm_block`` over a prompt and on from its
  state.
* **The model**: ``XLSTMLM``'s prefill (the sequential and the chunkwise
  form) and 20 decode steps against JAX compiled as written (ROADMAP C):
  logits within rtol 2e-2 / atol 3e-1, the recurrent states within 2e-2 in
  relative norm; JAX's init at prefill, the port's init carried to JAX at
  every step (JAX's init saturates the gates: ROADMAP C).
* **The shim**: the port's versions of the JAX package's shim tests (the
  xLSTM engine's accounting, the forced shim against the paged engine bit
  for bit, xLSTM's speculative decoding accepting every draft, the async
  runtime against the sync cycle), the forced shim of the hybrid against
  its paged engine, and the port's xLSTM streams against JAX's engine.

Fixed numpy seeds throughout.
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
from repro.models import xlstm as jx
from repro.models.zoo import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.models import xlstm as tx
from repro_torch.models.params import leaves
from repro_torch.models.transformer import XLSTMLM
from repro_torch.models.zoo import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.audit import audit_engine

ARCH = "xlstm-1.3b"
TOL = dict(rtol=2e-2, atol=3e-1)  # the family tests' logits tolerance
CELL_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 in, f32 out
CHUNK_TOL = dict(rtol=2e-4, atol=2e-4)  # the JAX package's chunkwise test
OUT_TOL = dict(rtol=1e-2, atol=1e-2)  # one block's bf16 output
STATE_TOL = dict(rtol=1e-2, atol=1e-3)  # f32 states of bf16 products
BLOCK = 32
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


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_model():
    """JAX's smoke model, its init, and that init carried to the port."""
    jm = jax_build(jax_smoke(ARCH))
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jparams, params_from_jax(jax.tree.map(np.asarray, jparams), smoke_config(ARCH))


# --------------------------------------------------------------------------
# the parameter trees
# --------------------------------------------------------------------------


def _jax_leaves(tree):
    return {tuple(getattr(k, "key", k) for k in kp): (tuple(v.shape), str(v.dtype))
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("which", ["smoke", "config"])
def test_param_defs_match_jax(which):
    """Leaf for leaf, shape and dtype (``blocks/mlstm`` stacked [n_super,
    mlstm_per_slstm, ...], ``blocks/slstm`` [n_super, ...]), without
    drawing the full config; the paged spec is JAX's, and the zoo builds
    ``XLSTMLM``."""
    tcfg, jcfg = (get_config(ARCH), jax_config(ARCH)) if which == "config" else (
        smoke_config(ARCH), jax_smoke(ARCH))
    tm, jm = build_model(tcfg), jax_build(jcfg)
    assert isinstance(tm, XLSTMLM) and tm.n_super == jm.n_super
    ours = {path: (p.shape, str(p.dtype).replace("torch.", "")) for path, p in
            leaves(tm.param_defs())}
    assert ours == _jax_leaves(jm.param_shapes())
    assert dataclasses.asdict(tm.paged_spec()) == dataclasses.asdict(jm.paged_spec())
    if which == "config":  # xlstm-1.3b: 6 super-blocks of 7 + 1, ~1.24 B parameters
        assert tm.n_super == 6
        assert 1.2e9 < sum(np.prod(p.shape) for _, p in leaves(tm.param_defs())) < 1.3e9


def test_params_from_jax_takes_the_xlstm_leaves(jax_model):
    """Every leaf of a JAX init arrives bit for bit, the f32 gate leaves
    (``wif``, ``bif``, ``b``) and the bf16 recurrence ``r`` in their own
    dtypes; the port's own init draws ``wqkv``, ``wif`` and ``wx`` at their
    true fan-in and ``r`` at JAX's 0.02."""
    _, jparams, tparams = jax_model
    tcfg = smoke_config(ARCH)
    n = 0
    for path, _ in leaves(build_model(tcfg).param_defs()):
        t, j = tparams, jparams
        for key in path:
            t, j = t[key], j[key]
        np.testing.assert_array_equal(bits_of(t), bits_of(j), err_msg="/".join(path))
        n += 1
    assert n == len(jax.tree_util.tree_leaves(jparams))
    blocks = tparams["blocks"]
    for leaf, dtype in ((blocks["mlstm"]["mixer"]["wif"], torch.float32),
                        (blocks["mlstm"]["mixer"]["bif"], torch.float32),
                        (blocks["slstm"]["mixer"]["b"], torch.float32),
                        (blocks["slstm"]["mixer"]["r"], torch.bfloat16)):
        assert leaf.dtype == dtype
    own = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")["blocks"]
    for leaf in (own["mlstm"]["mixer"]["wqkv"], own["mlstm"]["mixer"]["wif"],
                 own["slstm"]["mixer"]["wx"]):
        assert abs(float(leaf.float().std()) * tcfg.d_model**0.5 - 1.0) < 0.1
    assert abs(float(own["slstm"]["mixer"]["r"].float().std()) - 0.02) < 0.002


# --------------------------------------------------------------------------
# models/xlstm.py
# --------------------------------------------------------------------------

B, H, DH = 2, 3, 16
CFG = type("cfg", (), {"n_heads": H, "d_model": H * DH})()


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_cells_match_jax(cell):
    """40 steps of the recurrence from a fresh state (m at -1e30) on
    gates of standard deviation 3, each step's output and the state after
    the last within 1e-5."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    if cell == "mlstm":
        jstate, tstate = jx.mlstm_init_state(CFG, B), tx.mlstm_init_state(CFG, B, "cpu")
        jstep = jax.jit(jx._mlstm_cell)
    else:
        r = (0.3 * rng.standard_normal((4, H, DH, DH))).astype(ml_dtypes.bfloat16)
        b = rng.standard_normal((4, H, DH)).astype(f32)
        jp, tp = {"r": jnp.asarray(r), "b": jnp.asarray(b)}, {"r": to_torch(r),
                                                              "b": torch.from_numpy(b)}
        jstate, tstate = jx.slstm_init_state(CFG, B), tx.slstm_init_state(CFG, B, "cpu")
        jstep = jax.jit(functools.partial(jx._slstm_cell, jp))
    for t in range(40):
        if cell == "mlstm":
            q, k, v = (rng.standard_normal((B, H, DH)).astype(f32) for _ in range(3))
            i_pre, f_pre = (3 * rng.standard_normal((B, H)).astype(f32) for _ in range(2))
            xs = (q, k / DH**0.5, v, i_pre, f_pre)
            jstate, jh = jstep(jstate, tuple(map(jnp.asarray, xs)))
            tstate, th = tx._mlstm_cell(tstate, tuple(map(torch.from_numpy, xs)))
        else:
            wx = (3 * rng.standard_normal((B, 4, H, DH))).astype(f32)
            jstate, jh = jstep(jstate, jnp.asarray(wx))
            tstate, th = tx._slstm_cell(tp, tstate, torch.from_numpy(wx))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), err_msg=f"step {t}", **CELL_TOL)
    for key, val in tstate.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(jstate[key]), err_msg=key, **CELL_TOL)


@functools.lru_cache(maxsize=None)
def _jax_chunkwise(chunk):
    return jax.jit(functools.partial(jx.mlstm_chunkwise, chunk=chunk))


@pytest.mark.parametrize("gate_scale", [1.0, 5.0, 20.0])
@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("s", [32, 64, 96])
def test_mlstm_chunkwise_matches_jax(s, chunk, gate_scale):
    """The chunkwise form against JAX's on the JAX test's inputs (k scaled
    by 1 / sqrt(dh), gates scaled by up to 20: an unstabilised form would
    overflow), from a fresh state: h and the final state within 2e-4, m
    within 1e-5."""
    rng = np.random.default_rng(s * 100 + chunk + int(gate_scale))
    f32 = np.float32
    q, k, v = (rng.standard_normal((B, s, H, DH)).astype(f32) for _ in range(3))
    k = k / f32(DH**0.5)
    i_pre, f_pre = (gate_scale * rng.standard_normal((B, s, H))).astype(f32), (
        gate_scale * rng.standard_normal((B, s, H))).astype(f32)
    xs = (q, k, v, i_pre, f_pre)
    jh, jst = _jax_chunkwise(chunk)(*map(jnp.asarray, xs), jx.mlstm_init_state(CFG, B))
    th, tst = tx.mlstm_chunkwise(*map(torch.from_numpy, xs), tx.mlstm_init_state(CFG, B, "cpu"),
                                 chunk=chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **CHUNK_TOL)
    np.testing.assert_allclose(tst["m"].numpy(), np.asarray(jst["m"]), **CELL_TOL)
    for key in ("C", "n"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), err_msg=key,
                                   **CHUNK_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_jax(jax_model, kind):
    """One block of JAX's init (super-block 0): a 24-token prompt from a
    fresh state, then 3 tokens from its state: the outputs within 1e-2
    (bf16), the states within rtol 1e-2 / atol 1e-3."""
    _, jparams, tparams = jax_model
    jcfg, tcfg = jax_smoke(ARCH), smoke_config(ARCH)
    jp = jax.tree.map(lambda a: a[0, 0] if kind == "mlstm" else a[0],
                      jparams["blocks"][kind]["mixer"])
    tp = _tmap(lambda a: a[0, 0] if kind == "mlstm" else a[0], tparams["blocks"][kind]["mixer"])
    jblock = jit_as_written(functools.partial(getattr(jx, f"{kind}_block"), cfg=jcfg))
    tblock = getattr(tx, f"{kind}_block")
    rng = np.random.default_rng(3)
    jst = tst = None
    for s in (24, 3):
        x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
        jo, jst = jblock(jp, x=jnp.asarray(x, jnp.bfloat16), state=jst)
        to, tst = tblock(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16), tst)
        np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32),
                                   err_msg=f"out at S {s}", **OUT_TOL)
        for key, val in tst.items():
            np.testing.assert_allclose(val.numpy(), np.asarray(jst[key]),
                                       err_msg=f"{key} at S {s}", **STATE_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

STEPS = 20


def _rel(ours, theirs) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


@pytest.mark.parametrize("chunkwise", [False, True])
@pytest.mark.parametrize("init", ["jax", "port"])
def test_xlstm_matches_jax(jax_model, init, chunkwise):
    """A prefill of two 64-token prompts (with ``chunkwise`` through the
    chunkwise mLSTM, the config's ``xlstm_chunkwise``, chunk 64) and 20
    decode steps fed JAX's tokens.  ``init="jax"``: JAX's init (its gates
    saturate), compared at prefill; ``init="port"``: the port's init carried
    to JAX, the logits at every step, every recurrent state after the
    prefill and after every step within 2e-2 in relative norm."""
    jm, jparams, tparams = jax_model
    tcfg = smoke_config(ARCH).with_(xlstm_chunkwise=chunkwise)
    jm = jax_build(jax_smoke(ARCH).with_(xlstm_chunkwise=chunkwise))
    tm = build_model(tcfg)
    compared = range(STEPS)
    if init == "jax":
        compared = ()
    else:
        tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
        jparams = jax.tree.map(_to_jax, tparams)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tcfg.vocab, size=(2, 64), dtype=np.int32)
    jl, jstate = jit_as_written(lambda p, t: jm.prefill(p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    assert tstate["pos"].tolist() == [64, 64]

    def same_states(what):
        ours, theirs = _np(tstate["blocks"]), _np(jstate["blocks"])
        for kind in ("mlstm", "slstm"):
            for key, val in ours[kind].items():
                rel = _rel(val, theirs[kind][key])
                assert rel < 2e-2, (kind, key, what, rel)

    if init == "port":
        same_states("after the prefill")
    step = jit_as_written(jm.decode_step)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        if i in compared:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
            same_states(f"step {i}")
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    assert tstate["pos"].tolist() == [64 + STEPS] * 2


def test_xlstm_refuses_lengths_prior_and_training():
    """The prefill takes no ``lengths``, ``prior`` or ``prior_len`` (the
    states would absorb right-padding); ``loss``, ported with training
    (ROADMAP A12.1; against JAX's in test_torch_train_grads.py), no longer
    raises: it trains on the batch's labels; a depth the super-block does
    not divide raises."""
    tm = build_model(smoke_config(ARCH))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for kw in (dict(lengths=torch.tensor([4])), dict(prior=[(None, None)]),
               dict(prior_len=torch.tensor([0]))):
        with pytest.raises(ValueError, match="exact length"):
            tm.prefill(params, batch, 64, **kw)
    loss = tm.loss(params, {**batch, "labels": torch.ones((1, 4), dtype=torch.long),
                            "loss_mask": torch.ones((1, 4))})
    assert loss.dim() == 0 and torch.isfinite(loss)
    with pytest.raises(ValueError, match="super-block"):
        build_model(smoke_config(ARCH).with_(n_layers=5))


# --------------------------------------------------------------------------
# the exact-length shim: the port's versions of the JAX package's tests
# --------------------------------------------------------------------------


def _model(arch, **cfg_kw):
    cfg = smoke_config(arch).with_(kv_bits=4, kv_block=BLOCK, **cfg_kw)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(0), "cpu")


@pytest.fixture(scope="module")
def xlstm_model():
    return _model(ARCH)


@pytest.fixture(scope="module")
def attn_model():
    return _model("llama3-8b")


def _workload(cfg, n=3, seed=42, max_new=(12, 20), make=Request):
    rng = np.random.default_rng(seed)
    return [make(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(34, 48)))
                 .astype(np.int32), max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _run(model, params, reqs, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 128)
    engine = ServeEngine(model, params, device="cpu", **kw)
    for r in reqs:
        assert engine.submit(r)
    summary = engine.run()
    engine.close()
    return engine, summary


def test_nokv_shim_engine_serves_and_accounts(xlstm_model):
    """xLSTM (no KV anywhere) serves through the exact-length shim: the same
    scheduler without a pool, the same decode cycle, per-token accounting
    intact (``pos`` advances with every decoded token, budget retirement
    counted once each), one B 1 prefill a request spliced into the slots
    in place."""
    cfg, model, params = xlstm_model
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, 7).astype(np.int32),
                    max_new_tokens=3) for i in range(3)]
    engine, stats = _run(model, params, reqs, max_seq=64)
    assert not engine.paged and engine.pool is None and engine.sched.exact_buckets
    assert all(r.done for r in reqs)
    assert all(r.pos == 7 + 3 for r in reqs)
    assert stats["decoded_tokens"] == 9 and stats["budget_retired"] == 3
    assert stats["prefill_calls"] == 3 and stats["prefill_tokens"] == 21
    assert "kv_page_bytes" not in stats and audit_engine(engine).ok


def test_paged_true_refused_for_a_family_that_does_not_page(xlstm_model):
    """``paged=True`` on a model whose spec does not page raises JAX's
    ``ValueError``; ``splitkv="always"`` without a mesh is accepted, as in
    JAX (no split step exists), and ``page_affine`` raises JAX's errors."""
    _, model, params = xlstm_model
    with pytest.raises(ValueError, match="no paged decode capability"):
        ServeEngine(model, params, slots=2, max_seq=64, paged=True, device="cpu")
    engine = ServeEngine(model, params, slots=2, max_seq=64, splitkv="always", device="cpu")
    assert not engine.paged and engine._step_splitkv is None
    assert not engine._use_splitkv_now()
    with pytest.raises(ValueError, match="requires a mesh"):
        ServeEngine(model, params, slots=2, max_seq=64, page_affine=True, device="cpu")


def _oracle(model, params, prompt, max_new, max_seq=128):
    """The dense oracle: an exact-length B 1 prefill and the decode loop."""
    with torch.no_grad():
        logits, st = model.prefill(params, {"tokens": torch.from_numpy(prompt[None]).long()},
                                   max_seq)
        tok, out = int(logits[0, -1].argmax()), []
        for _ in range(max_new):
            out.append(tok)
            logits, st = model.decode_step(params, st, torch.tensor([[tok]]))
            tok = int(logits[0, 0].argmax())
    return out


@pytest.mark.parametrize("arch", ["llama3-8b", "zamba2-7b"])
def test_forced_shim_matches_paged_outputs(arch):
    """``paged=False`` forces the exact-length shim for a paged-capable
    model (attention: the dense quantized caches; the hybrid: its dense
    caches and Mamba2 states): the streams equal the paged engine's bit for
    bit, and each the dense oracle's."""
    cfg, model, params = _model(arch)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in (9, 40)]

    def run(paged):
        reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        engine, _ = _run(model, params, reqs, paged=paged)
        return [r.out_tokens for r in reqs], engine

    want, shim = run(False)
    assert not shim.paged and shim.pool is None
    got, paged = run(None)
    assert paged.paged
    assert got == want
    assert want == [_oracle(model, params, p, 5) for p in prompts]


def test_spec_xlstm_full_acceptance(xlstm_model):
    """The recurrent shim has no quantized cache: draft and verify run the
    same full-precision math, so every draft is accepted; the streams equal
    the sequential cycle's and the auditor passes every cycle."""
    cfg, model, params = xlstm_model
    base = _workload(cfg)
    _run(model, params, base)
    reqs = _workload(cfg)
    engine, summary = _run(model, params, reqs, spec_k=2, audit_every=1)
    assert all(r.done for r in reqs)
    assert [list(r.out_tokens) for r in reqs] == [list(r.out_tokens) for r in base]
    assert summary["spec_cycles"] > 0 and summary["spec_draft_tokens"] > 0
    assert summary["spec_rejected_tokens"] == 0 and summary["spec_accept_rate"] == 1.0
    assert audit_engine(engine).ok


def test_spec_forced_shim_matches_sequential(attn_model):
    """Self-speculation over the shim's dense caches (spec_k 3, drafts read
    at 2 bits through the dense decode read, the verify pass's masked
    dense append): the streams equal the sequential shim's bit for bit."""
    cfg, model, params = attn_model
    base = _workload(cfg)
    _run(model, params, base, paged=False)
    reqs = _workload(cfg)
    engine, summary = _run(model, params, reqs, paged=False, spec_k=3, audit_every=1)
    assert [list(r.out_tokens) for r in reqs] == [list(r.out_tokens) for r in base]
    assert summary["spec_rejected_tokens"] > 0  # the 2-bit draft is not the 4-bit read
    assert engine.spec_bits == 2 and audit_engine(engine).ok


@pytest.mark.parametrize("family", ["attn", "xlstm"])
def test_async_matches_sync_bitwise_per_family(family, request):
    """The async runtime over the shim (attention forced to it, xLSTM by
    its spec): identical token streams and terminal phases, every request
    DONE, the completion ledger holding each uid once."""
    cfg, model, params = request.getfixturevalue(f"{family}_model")
    kw = dict(paged=False) if family == "attn" else {}
    rs, ra = _workload(cfg, n=4, max_new=(20, 28)), _workload(cfg, n=4, max_new=(20, 28))
    _run(model, params, rs, **kw)
    eng, summary = _run(model, params, ra, async_runtime=True, **kw)
    assert [list(r.out_tokens) for r in ra] == [list(r.out_tokens) for r in rs]
    assert [r.phase for r in ra] == [r.phase for r in rs] and all(r.done for r in ra)
    ledger = eng._completions.records
    assert sorted(ledger) == [r.uid for r in ra] and eng._completions.duplicates == 0
    assert summary["completions_enqueued"] == len(ra)
    for r in ra:
        assert ledger[r.uid].tokens == tuple(r.out_tokens)


def _rows(model, params, prompt, fed):
    """The port's logits rows of a B 1 run fed ``fed`` (the prefill's row
    first): what request ``prompt`` saw at each token."""
    with torch.no_grad():
        logits, st = model.prefill(params, {"tokens": torch.from_numpy(prompt[None]).long()})
        rows = [logits[0, -1]]
        for tok in fed[:-1]:
            logits, st = model.decode_step(params, st, torch.tensor([[tok]]))
            rows.append(logits[0, 0])
    return rows


def test_xlstm_shim_streams_match_jax_engine(xlstm_model):
    """The same workload through the port's shim and JAX's (the port's init
    carried to JAX): the same decoded counts, and the same tokens, the
    streams parting only at a near tie: JAX's token scoring within the
    logits tolerance of the port's best there."""
    cfg, model, params = xlstm_model
    jm = jax_build(jax_smoke(ARCH).with_(kv_bits=4, kv_block=BLOCK))
    jparams = jax.tree.map(_to_jax, params)
    t_reqs = _workload(cfg, n=3, seed=5, max_new=(8, 12))
    _, t_sum = _run(model, params, t_reqs)
    j_reqs = _workload(cfg, n=3, seed=5, max_new=(8, 12), make=JRequest)
    jeng = JServeEngine(jm, jparams, slots=2, max_seq=128)
    assert not jeng.paged
    for r in j_reqs:
        jeng.submit(r)
    j_sum = jeng.run()
    for key in ("decoded_tokens", "prefill_calls", "budget_retired", "steps"):
        assert t_sum[key] == j_sum[key], key
    for tr, jr in zip(t_reqs, j_reqs):
        mine, theirs = tr.out_tokens, [int(t) for t in jr.out_tokens]
        d = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b), None)
        if d is not None:
            row = _rows(model, params, tr.prompt, mine)[d]
            top = row.max().item()
            assert top - row[theirs[d]].item() <= TOL["atol"] + TOL["rtol"] * abs(top), (
                tr.uid, d, mine[d], theirs[d])
