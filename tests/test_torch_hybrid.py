"""The Mamba2 hybrid (zamba2-7b: ``models/mamba2.py``, ``HybridLM``) in the
port against the JAX package, on the CPU, at the smoke size, on the plain
versions of the kernels.

* **The model's pieces**: the parameter trees (SMOKE and CONFIG) leaf for
  leaf, the paged spec, ``params_from_jax``; ``ssd_chunked`` against JAX's
  (rtol / atol 1e-5: f32 products in another order); one Mamba2 layer's
  ``mamba2_prefill`` (a prompt shorter than the conv window, one that pads
  the tail chunk, one of whole chunks) and three ``mamba2_decode`` steps
  against JAX's on the same parameters: out and the conv tail within rtol /
  atol 1e-2 (bf16 values; the in-projection's products may round a last bit
  apart in a few elements), the SSM state within rtol 1e-2 / atol 1e-3.
* **The model**: ``HybridLM`` through an exact-length prefill and 20 decode
  steps against JAX within the family tests' tolerance (rtol 2e-2 / atol
  3e-1): JAX's init up to the first flush, with invocation 0's cache after
  the prefill bit for bit and its codes after the flush within one step of
  JAX's; the port's init carried to JAX at every step (ROADMAP C).
* **The engine**: the port's versions of the JAX package's hybrid engine
  tests (the paged engine against the dense oracle bit for bit, exact-length
  prefill groups, self-speculation against sequential decoding, and in
  place of the jaxpr taint proof: a decode step under two page tables that
  map the same content leaves the SSM states bit for bit equal), preemption
  against the unpressured run, the async runtime against the sync cycle,
  and the launcher's ``--family hybrid``.

The JAX model is compiled as written (``jit_as_written``, ROADMAP C): XLA
otherwise skips the bf16 round trips of the conv and the gated norm.
"""
import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_config
from repro.configs.base import smoke_config as jax_smoke
from repro.models import mamba2 as jm2
from repro.models.zoo import build_model as jax_build
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_torch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import mamba2 as tm2
from repro_torch.models.params import leaves
from repro_torch.models.zoo import build_model
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.audit import audit_engine

ARCH = "zamba2-7b"
TOL = dict(rtol=2e-2, atol=3e-1)  # the family tests' logits tolerance
OUT_TOL = dict(rtol=1e-2, atol=1e-2)  # one layer's bf16 output
SSD_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 in, f32 out: products in another order
# f32 SSM states of bf16 inputs (the in-projection's), which may round a last
# bit apart: one bf16 ulp is 2^-8 relative
STATE_TOL = dict(rtol=1e-2, atol=1e-3)
BLOCK = 32
CACHE_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero", "k_res", "v_res")
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
    """Leaf for leaf, shape and dtype (``main`` stacked [n_super,
    attn_every, ...], ``tail``, ``shared_attn``), without drawing the full
    config; the paged spec is JAX's."""
    tcfg, jcfg = (get_config(ARCH), jax_config(ARCH)) if which == "config" else (
        smoke_config(ARCH), jax_smoke(ARCH))
    tm, jm = build_model(tcfg), jax_build(jcfg)
    assert (tm.n_super, tm.tail) == (jm.n_super, jm.tail)
    ours = {path: (p.shape, str(p.dtype).replace("torch.", "")) for path, p in
            leaves(tm.param_defs())}
    assert ours == _jax_leaves(jm.param_shapes())
    assert ("main", "mixer", "conv_w") in ours and ("shared_attn", "mlp", "wo") in ours
    assert dataclasses.asdict(tm.paged_spec()) == dataclasses.asdict(jm.paged_spec())
    if which == "config":  # zamba2-7b: 13 super-blocks of 6 and a tail of 3, 6.79 B
        assert (tm.n_super, tm.tail) == (13, 3)
        assert 6.78e9 < sum(np.prod(p.shape) for _, p in leaves(tm.param_defs())) < 6.8e9


def test_params_from_jax_takes_the_hybrid_leaves(jax_model):
    """Every leaf of a JAX init arrives bit for bit; the port's own init
    draws ``conv_w`` at JAX's explicit scale (0.2) and the stacked in/out
    projections at their true fan-in."""
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
    own = build_model(tcfg).init(torch.Generator().manual_seed(0), "cpu")["main"]["mixer"]
    assert abs(float(own["conv_w"].std()) - 0.2) < 0.02
    for name, fan_in in (("in_proj", tcfg.d_model), ("out_proj", tcfg.mamba_d_inner)):
        assert abs(float(own[name].float().std()) * fan_in**0.5 - 1.0) < 0.05, name


# --------------------------------------------------------------------------
# models/mamba2.py
# --------------------------------------------------------------------------


def test_ssd_chunked_matches_jax():
    """Four chunks of 16, 8 heads over 2 groups: y and the final state."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n = 2, 64, 8, 16, 2, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (0.5 * rng.standard_normal(h)).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, n)).astype(np.float32) for _ in range(2))
    yj, fj = jax.jit(functools.partial(jm2.ssd_chunked, chunk=16))(x, dt, a_log, bb, cc)
    yt, ft = tm2.ssd_chunked(*map(torch.from_numpy, (x, dt, a_log, bb, cc)), chunk=16)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **SSD_TOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **SSD_TOL)


@pytest.mark.parametrize("s", [2, 45, 64])
def test_mamba2_layer_matches_jax(jax_model, s):
    """One Mamba2 layer (super-block 0, layer 0 of JAX's init): a prefill of
    ``s`` tokens (2: shorter than the conv window, its tail left-padded; 45:
    the tail chunk padded with zero-dt steps; 64: two whole chunks), then
    three decode steps from the prefill's state."""
    _, jparams, tparams = jax_model
    jcfg, tcfg = jax_smoke(ARCH), smoke_config(ARCH)
    jp = jax.tree.map(lambda a: a[0, 0], jparams["main"]["mixer"])
    tp = _tmap(lambda a: a[0, 0], tparams["main"]["mixer"])
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    oj, sj = jit_as_written(lambda p, x: jm2.mamba2_prefill(p, jcfg, x))(
        jp, jnp.asarray(x, jnp.bfloat16))
    ot, st = tm2.mamba2_prefill(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16))

    def same(oj, sj, ot, st, what):
        np.testing.assert_allclose(ot.float().numpy(), np.asarray(oj, np.float32),
                                   err_msg=f"out {what}", **OUT_TOL)
        np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(sj["ssm"]),
                                   err_msg=f"ssm {what}", **STATE_TOL)
        np.testing.assert_allclose(st["conv"].float().numpy(), np.asarray(sj["conv"], np.float32),
                                   err_msg=f"conv {what}", **OUT_TOL)

    assert st["conv"].shape == (2, tm2.CONV_K - 1, sj["conv"].shape[-1])
    same(oj, sj, ot, st, "after the prefill")
    step = jit_as_written(lambda p, x, st: jm2.mamba2_decode(p, jcfg, x, st))
    for i in range(3):
        y = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        oj, sj = step(jp, jnp.asarray(y, jnp.bfloat16), sj)
        ot, st = tm2.mamba2_decode(tp, tcfg, torch.from_numpy(y).to(torch.bfloat16), st)
        same(oj, sj, ot, st, f"after decode step {i}")


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

PROMPT, STEPS = 48, 20
FLUSH = 64 - PROMPT - 1  # kv_block 64: the decode step (from 0) that flushes every row


@pytest.mark.parametrize("init", ["jax", "port"])
def test_hybrid_matches_jax(jax_model, init):
    """An exact-length prefill of two 48-token prompts and 20 decode steps
    fed the JAX tokens, step FLUSH flushing every row.  ``init="jax"``:
    JAX's init, compared at prefill and before the flush; invocation 0's
    cache bit for bit after the prefill, and after the flush its codes
    within one step of JAX's (its input passed two Mamba2 layers whose
    products round in another order).  ``init="port"``: the port's init
    carried to JAX, compared at every step, and the SSM states after every
    step within 2e-2 of JAX's in relative norm (a state's inputs passed
    every layer before it, as the logits' did; at JAX's init scales the
    tail's states depart as far as its logits do after the flush)."""
    jm, jparams, tparams = jax_model
    tm = build_model(smoke_config(ARCH))
    if init == "jax":
        compared = range(FLUSH)
    else:
        tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
        jparams = jax.tree.map(_to_jax, tparams)
        compared = range(STEPS)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, tm.cfg.vocab, size=(2, PROMPT), dtype=np.int32)
    jl, jstate = jit_as_written(lambda p, t: jm.prefill(p, {"tokens": t}, 128))(
        jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens)}, 128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg="prefill", **TOL)
    if init == "jax":
        tc, jc = tstate["caches"][0].layer(0), jax.tree.map(lambda a: a[0], jstate["caches"][0])
        for f in CACHE_FIELDS[:6]:
            np.testing.assert_array_equal(bits_of(getattr(tc, f)), bits_of(getattr(jc, f)),
                                          err_msg=f"{f} after the prefill")
    step = jit_as_written(jm.decode_step)
    tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        jl, jstate = step(jparams, jstate, tok)
        with torch.no_grad():
            tl, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(np.array(tok)))
        if i in compared:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), err_msg=f"step {i}", **TOL)
            for path in ("ssm_main", "ssm_tail") if init == "port" else ():
                ours, theirs = tstate[path]["ssm"].numpy(), np.asarray(jstate[path]["ssm"])
                rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
                assert rel < 2e-2, (path, i, rel)
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None].astype(jnp.int32)
    tc, jc = tstate["caches"][0], jstate["caches"][0]
    np.testing.assert_array_equal(tc.pack_blocks.numpy(), np.asarray(jc.pack_blocks))
    np.testing.assert_array_equal(tc.res_len.numpy(), np.asarray(jc.res_len))
    assert tc.pack_blocks[0].tolist() == [1, 1]  # both rows flushed
    if init == "jax":  # invocation 0's packed codes after the flush
        bits = tm.cfg.kv_bits
        for f in ("kw", "vw"):
            ours, theirs = (np.asarray(getattr(c, f))[0].astype(np.int64) for c in (tc, jc))
            codes = [((w >> (bits * k)) & ((1 << bits) - 1)) for w in (ours, theirs)
                     for k in range(32 // bits)]
            half = len(codes) // 2
            diff = np.abs(np.stack(codes[:half]) - np.stack(codes[half:]))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.95, (f, (diff == 0).mean())


def test_hybrid_prefill_refuses_lengths_and_prior():
    """The hybrid prefills at the exact length: ``lengths``, ``prior`` and
    ``prior_len`` raise rather than being ignored."""
    tm = build_model(smoke_config(ARCH))
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    for kw in (dict(lengths=torch.tensor([4])), dict(prior=[(None, None)]),
               dict(prior_len=torch.tensor([0]))):
        with pytest.raises(ValueError, match="exact length"):
            tm.prefill(params, batch, 64, **kw)


# --------------------------------------------------------------------------
# the engine: the port's versions of the JAX package's hybrid engine tests
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hybrid_model():
    cfg = smoke_config(ARCH).with_(kv_bits=4, kv_block=BLOCK)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _oracle(model, params, prompt, max_new, max_seq=128):
    """The dense oracle: an exact-length prefill and the decode loop."""
    with torch.no_grad():
        logits, st = model.prefill(params, {"tokens": torch.from_numpy(prompt[None]).long()},
                                   max_seq)
        tok, out = int(logits[0, -1].argmax()), []
        for _ in range(max_new):
            out.append(tok)
            logits, st = model.decode_step(params, st, torch.tensor([[tok]]))
            tok = int(logits[0, 0].argmax())
    return out


def test_hybrid_paged_engine_matches_dense_oracle(hybrid_model):
    """Short and block-crossing prompts, staggered: the shared block's
    caches page, the SSM states splice per slot, and every stream equals
    the dense oracle bit for bit."""
    cfg, model, params = hybrid_model
    rng = np.random.default_rng(3)
    specs = [(30, 6), (7, 5), (44, 4)]  # 30 + 6 and 44 cross block boundaries
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in specs]
    want = [_oracle(model, params, p, mn) for p, (_, mn) in zip(prompts, specs)]
    engine = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    assert engine.paged and engine.sched.index is None  # no prefix sharing
    reqs = [Request(uid=i, prompt=p, max_new_tokens=mn)
            for i, (p, (_, mn)) in enumerate(zip(prompts, specs))]
    for r in reqs:
        engine.submit(r)
        engine.step()
    engine.run()
    for r, w in zip(reqs, want):
        assert r.done and r.out_tokens == w, r.uid
    assert engine.pool.n_free == engine.pool.capacity and engine.pool.reserved == 0


def test_hybrid_exact_prefill_grouping(hybrid_model):
    """Admission groups are exact suffix lengths, and same-length prompts
    still batch into one prefill call."""
    cfg, model, params = hybrid_model
    engine = ServeEngine(model, params, slots=4, max_seq=128, device="cpu")
    assert engine.spec.exact_prefill and engine.sched.exact_buckets
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=2) for i, n in enumerate([9, 9, 20])]
    for r in reqs:
        engine.submit(r)
    engine.step()
    assert engine.stats["prefill_calls"] == 2  # the two 9-token prompts batch
    engine.run()
    assert all(r.done for r in reqs)


def _workload(cfg, n=3, max_new=(12, 20)):
    rng = np.random.default_rng(42)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(34, 48)))
                    .astype(np.int32), max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _run(model, params, reqs, **kw):
    engine = ServeEngine(model, params, slots=2, max_seq=128, device="cpu", **kw)
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    engine.close()
    return engine


@pytest.fixture(scope="module")
def baseline(hybrid_model):
    cfg, model, params = hybrid_model
    reqs = _workload(cfg)
    _run(model, params, reqs)
    assert all(r.done for r in reqs)
    return [list(r.out_tokens) for r in reqs]


def test_spec_matches_sequential_hybrid(hybrid_model, baseline):
    """Self-speculation (spec_k 2, drafts at 2 bits): the draft pass
    advances its own copy of the SSM states, the verify pass freezes dead
    lanes' states; the streams equal the sequential ones bit for bit and
    the auditor passes every cycle."""
    cfg, model, params = hybrid_model
    reqs = _workload(cfg)
    engine = _run(model, params, reqs, spec_k=2, audit_every=1)
    assert [list(r.out_tokens) for r in reqs] == baseline
    assert engine.stats["spec_cycles"] > 0 and engine.stats["spec_draft_tokens"] > 0
    assert audit_engine(engine).ok


def test_async_runtime_equals_sync_hybrid(hybrid_model, baseline):
    cfg, model, params = hybrid_model
    reqs = _workload(cfg)
    engine = _run(model, params, reqs, async_runtime=True)
    assert [list(r.out_tokens) for r in reqs] == baseline
    assert engine.stats["completions_enqueued"] == len(reqs)


def test_hybrid_preemption_replays_bit_for_bit(hybrid_model):
    """Half the worst-case pages with expected-case reservations preempts;
    a victim re-prefills at its exact length and replays its tokens through
    the decode path, so its SSM states and every later token equal the
    unpressured run's."""
    cfg, model, params = hybrid_model
    base = _workload(cfg, n=4, max_new=(24, 32))
    _run(model, params, base)
    reqs = _workload(cfg, n=4, max_new=(24, 32))
    engine = _run(model, params, reqs, n_pages=2 + 3, reserve_policy="expected",
                  expected_quantile=0.0, audit_every=1)
    assert engine.stats["preempted"] > 0
    assert [list(r.out_tokens) for r in reqs] == [list(r.out_tokens) for r in base]
    assert engine.pool.n_free == engine.pool.capacity


def test_hybrid_ssm_layers_carry_no_page_table_work(hybrid_model):
    """In place of JAX's jaxpr taint proof: one decode step over the same
    cache content behind two page tables (the identity, and a permutation
    with the pools permuted to match) gives bit for bit the same logits and
    SSM states; only the shared block's attention reads the table, and
    ``mamba2_decode`` takes no cache."""
    cfg, model, params = hybrid_model
    assert model.tail
    assert list(inspect.signature(tm2.mamba2_decode).parameters) == ["p", "cfg", "x", "state"]
    gen = torch.Generator().manual_seed(5)
    b, nb = 2, 3
    states = []
    for perm in (torch.arange(b + b * nb), torch.cat([torch.arange(b),
                                                      b + torch.randperm(b * nb, generator=gen)])):
        st = model.init_paged_decode_state(b, n_pages=b + b * nb, nb_max=nb, device="cpu")
        states.append((st, perm))
    base = states[0][0]
    for path in ("ssm_main", "ssm_tail"):
        for t in base[path].values():
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    c0 = base["caches"][0]
    for f in CACHE_FIELDS:
        t = getattr(c0, f)
        if t is not None:
            t.copy_(torch.randint(-2**30, 2**30, t.shape, generator=gen, dtype=torch.int32)
                    if t.dtype == torch.int32 else 0.1 * torch.randn(t.shape, generator=gen))
    c0.pack_blocks.fill_(2)
    c0.res_len.copy_(torch.tensor([5, 17], dtype=torch.int32))
    c0.page_table[0].copy_(b + torch.arange(b * nb, dtype=torch.int32).reshape(b, nb))
    st1, perm = states[1]
    for path in ("ssm_main", "ssm_tail"):
        for k, t in st1[path].items():
            t.copy_(base[path][k])
    c1 = st1["caches"][0]
    inv = torch.argsort(perm)
    for f in ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero"):  # page p moves to inv[p]
        getattr(c1, f).copy_(torch.empty_like(getattr(c0, f)).index_copy_(1, inv,
                                                                          getattr(c0, f)))
    for f in ("k_res", "v_res", "pack_blocks", "res_len"):
        getattr(c1, f).copy_(getattr(c0, f))
    c1.page_table[0].copy_(inv[c0.page_table[0].long()].to(torch.int32))
    assert not torch.equal(c1.page_table, c0.page_table)
    tokens = torch.tensor([[3], [7]])
    with torch.no_grad():
        out = [model.decode_step(params, st, tokens) for st, _ in states]
    assert torch.equal(out[0][0], out[1][0])
    for path in ("ssm_main", "ssm_tail"):
        for k in ("ssm", "conv"):
            assert torch.equal(bits_t(out[0][1][path][k]), bits_t(out[1][1][path][k])), (path, k)


def bits_t(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def test_serve_cli_serves_the_hybrid_family(capsys):
    launch_serve.main(["--family", "hybrid", "--smoke", "--device", "cpu", "--requests", "3",
                       "--slots", "2", "--prompt-len", "40", "--max-new", "6",
                       "--max-seq", "128", "--audit-every", "1"])
    out = capsys.readouterr().out
    assert "[serve] engine mode: paged, pool=" in out
    stats = next(line for line in out.splitlines() if line.startswith("[serve] {"))
    assert "'decoded_tokens': 18" in stats and "'prefill_calls': 2" in stats
