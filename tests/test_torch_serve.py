"""The port's serving engine (synchronous cycle) on the CPU, at the smoke
size, on the plain versions of the kernels.

* The host-side pieces (``PagePool``, ``Scheduler`` / ``PrefixIndex``,
  ``FaultPlan``) driven by one scripted sequence through both packages make
  identical decisions: free lists, refcounts, holders, admission groups,
  chain digests and fire sequences.
* The port's engine equals the port's dense decode path token for token; an
  oversubscribed pool (preemption, audited every cycle) equals the
  unpressured run bit for bit; a copy-on-write pair equals its solo runs.
* Against the JAX engine on the same workload and the same parameters, the
  per-step logits of every active slot lie within rtol 2e-2 / atol 3e-1.
  Both engines are fed the JAX engine's token stream (the step function is
  wrapped in the test), so a last-bit difference cannot make the streams
  diverge, and every step is compared.  The parameters are the port's init
  carried to JAX: at the JAX init's scales the smoke model's softmax is
  peaked enough that the codes of layer 1, which differ from JAX's in a few
  percent of places (K/V one bf16 ulp apart, ROADMAP §C), move logits past
  the tolerance from the first step that reads a packed block.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from repro.configs.base import smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro.serve import engine as jeng
from repro.serve import faults as jfaults
from repro.serve import pages as jpages
from repro.serve import scheduler as jsched
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models.zoo import build_model
from repro_torch.serve import (
    FaultPlan,
    Phase,
    Request,
    ServeEngine,
    audit_engine,
    validate_events,
)
from repro_torch.serve import engine as teng
from repro_torch.serve import faults as tfaults
from repro_torch.serve import pages as tpages
from repro_torch.serve import scheduler as tsched

BLOCK = 32
TOL = dict(rtol=2e-2, atol=3e-1)


# --------------------------------------------------------------------------
# host-side decisions: one scripted sequence through both packages
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; several test workers
    on a shared machine would oversubscribe it.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_state(pool) -> tuple:
    return (pool.free_pages(), [pool.refcount(p) for p in range(pool.n_pages)],
            [pool.holders(p) for p in range(pool.n_pages)], pool.reserved,
            pool.retained_pages(), pool.n_used, pool.committed)


def _script_pool(mod) -> list:
    """Reservations, owned allocs, sharing, frees, the retained tier and its
    reclaim; the state after every call."""
    pool = mod.PagePool(12, n_scratch=2)
    keep = {5, 7}
    pool.retainable = keep.__contains__
    released = []
    pool.on_release = released.append
    trace = []
    step = lambda: trace.append(_pool_state(pool))  # noqa: E731
    assert pool.reserve(4, owner="a") and pool.reserve(3, owner="b")
    step()
    pages_a = [pool.alloc(owner="a") for _ in range(3)]
    pages_b = [pool.alloc(owner="b") for _ in range(2)]
    step()
    pool.retain(pages_a[0], owner="b")
    pool.retain(pages_a[1], owner="b")
    step()
    for p in pages_a:
        pool.free(p, owner="a")
    pool.release(1, owner="a")
    step()
    for p in pages_b + pages_a[:2]:
        pool.free(p, owner="b")
    step()
    assert not pool.reserve(12)  # reclaims the retained tier, still refused
    step()
    pool.release(1, owner="b")
    pool.alloc(covered=False, owner="c")
    step()
    trace.append(("released", released, pool.reclaim_count))
    return trace


def test_pagepool_decisions_match_jax():
    assert _script_pool(tpages) == _script_pool(jpages)


def _script_scheduler(sched_mod, pages_mod) -> list:
    """Admissions with shared prefixes, a speculative tail, buckets and
    backpressure; groups, shared pages and chain digests per cycle."""
    rng = np.random.default_rng(3)
    base = rng.integers(0, 500, 3 * BLOCK).astype(np.int32)
    prompts = [base, np.concatenate([base[:2 * BLOCK], rng.integers(0, 500, 9)]),
               base[:10].copy(), rng.integers(0, 500, 70).astype(np.int32),
               base.copy(), rng.integers(0, 500, 5).astype(np.int32)]
    pool = pages_mod.PagePool(20, n_scratch=3)
    sched = sched_mod.Scheduler(slots=3, pool=pool, block_n=BLOCK, max_seq=256,
                                reserve_policy="expected", expected_quantile=0.5,
                                namespace="llama3-8b/b4/n32/channel")
    reqs = [sched_mod.Request(uid=i, prompt=p, max_new_tokens=40)
            for i, p in enumerate(prompts)]
    trace = []
    for r in reqs[:2]:
        sched.submit(r)
    for cycle in range(4):
        if cycle == 1:
            for r in reqs[2:]:
                sched.submit(r)
        groups = sched.admit()
        trace.append({b: [r.uid for r in g] for b, g in groups.items()})
        for g in groups.values():
            for r in g:
                fresh = [pool.alloc(owner=r.uid)
                         for _ in range(r.suffix_len(BLOCK) // BLOCK)]
                r.pages += fresh
                r.reserved_pages -= len(fresh)
                sched.register_prefix(r, r.shared_pages + fresh)
                trace.append((r.uid, r.shared_pages, r.spec_page, r.reserved_pages,
                              [d.hex() for d in r.chain]))
        if cycle == 2:
            sched.retire(reqs[0])
            sched.preempt(reqs[1], pending_token=7)
        trace.append((_pool_state(pool), sched.stats, [r.phase.value for r in reqs]))
    return trace


def test_scheduler_and_prefix_index_decisions_match_jax():
    assert _script_scheduler(tsched, tpages) == _script_scheduler(jsched, jpages)


def _script_faults(mod) -> list:
    plan = mod.FaultPlan(seed=11, alloc_fail=0.3, forced_preempt=0.2,
                         poison_logits=0.1, evict_storm=0.25,
                         fire_at={"delayed_release": (1, 4)},
                         max_fires={"poison_logits": 3},
                         fire_at_token={"poison_logits": {(2, 5)}})
    for cycle in range(40):
        for site in mod.SITES:
            plan.fires(site, cycle=cycle, uid=cycle % 3, progress=cycle // 2)
    return plan.log


def test_faultplan_fire_sequence_matches_jax():
    log = _script_faults(tfaults)
    assert log == _script_faults(jfaults)
    assert {e["site"] for e in log} == set(tfaults.SITES)


# --------------------------------------------------------------------------
# the port's engine against itself
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    cfg = smoke_config("llama3-8b").with_(kv_bits=4, kv_block=BLOCK)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _engine(model, params, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 128)
    return ServeEngine(model, params, device="cpu", **kw)


def test_engine_matches_dense_oracle(small_model):
    """Staggered arrivals, short and multi-block prompts, one crossing a
    block boundary while decoding: token for token the dense decode path."""
    cfg, model, params = small_model
    rng = np.random.default_rng(3)
    specs = [(30, 6), (7, 5), (44, 4)]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n, _ in specs]

    def oracle(prompt, max_new):
        with torch.no_grad():
            logits, st = model.prefill(params, {"tokens": torch.from_numpy(prompt[None]).long()},
                                       128)
            tok, out = int(logits[0, -1].argmax()), []
            for _ in range(max_new):
                out.append(tok)
                logits, st = model.decode_step(params, st, torch.tensor([[tok]]))
                tok = int(logits[0, 0].argmax())
        return out

    engine = _engine(model, params)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, (_, n)) in enumerate(zip(prompts, specs))]
    engine.submit(reqs[0])
    engine.step()
    engine.submit(reqs[1])
    engine.step()
    engine.submit(reqs[2])
    engine.run()
    for r, p, (_, n) in zip(reqs, prompts, specs):
        assert r.done and r.out_tokens == oracle(p, n), r.uid
    assert engine.pool.n_free == engine.pool.capacity


def _workload(cfg, n=5):
    rng = np.random.default_rng(42)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(34, 48)))
                    .astype(np.int32), max_new_tokens=int(rng.integers(24, 32)))
            for i in range(n)]


@pytest.fixture(scope="module")
def baseline(small_model):
    """The unpressured run of ``_workload``: ample pages, worst-case
    reservations."""
    cfg, model, params = small_model
    engine = _engine(model, params)
    reqs = _workload(cfg)
    for r in reqs:
        engine.submit(r)
    engine.run()
    assert all(r.done for r in reqs)
    return {r.uid: list(r.out_tokens) for r in reqs}


@pytest.mark.parametrize("policy", ["youngest", "fewest_pages"])
def test_oversubscribed_pool_preempts_and_matches_unpressured(small_model, baseline, policy):
    """Half the worst-case pages, expected-case reservations, audited every
    cycle: preemption fires and every token stream equals the unpressured
    run's bit for bit; the pool drains clean and the trace is well formed."""
    cfg, model, params = small_model
    engine = _engine(model, params, n_pages=2 + 3, reserve_policy="expected",
                     expected_quantile=0.0, preempt_policy=policy, audit_every=1,
                     trace=True)
    reqs = _workload(cfg)
    for r in reqs:
        assert engine.submit(r)
    stats = engine.run()
    assert stats["preempted"] > 0 and stats["preempt_remat_tokens"] > 0
    for r in reqs:
        assert r.done and r.out_tokens == baseline[r.uid], r.uid
    assert engine.pool.n_free == engine.pool.capacity and engine.pool.reserved == 0
    assert audit_engine(engine).ok
    assert validate_events(engine.tracer.events) == []
    names = {e["name"] for e in engine.tracer.chrome_trace()["traceEvents"]}
    assert {"decode_dispatch", "device_wait"} <= names
    assert any(n.startswith("preempt (req") for n in names)
    assert "repro_serve_preempted" in engine.metrics.to_prometheus()


def test_poison_cancel_and_deadline_retire_one_request_each(small_model, baseline):
    """A poisoned logits row retires its request ERRORED, ``cancel`` one
    CANCELLED, a passed deadline one EXPIRED; the others finish with their
    unpressured streams and the pool drains."""
    cfg, model, params = small_model
    now = [0.0]
    engine = _engine(model, params, audit_every=1, clock=lambda: now[0],
                     faults=FaultPlan(fire_at_token={"poison_logits": {(1, 3)}}))
    reqs = _workload(cfg)
    reqs[3].deadline_s = 5.0
    for r in reqs:
        engine.submit(r)
    for _ in range(4):
        engine.step()
    assert engine.cancel(reqs[2].uid) is reqs[2] and engine.cancel(99) is None
    now[0] = 10.0
    engine.run()
    phases = [r.phase for r in reqs]
    assert phases == [Phase.DONE, Phase.ERRORED, Phase.CANCELLED, Phase.EXPIRED, Phase.DONE]
    assert len(reqs[1].out_tokens) == 4 and "non-finite" in reqs[1].error
    for r in (reqs[0], reqs[4]):
        assert r.out_tokens == baseline[r.uid]
    assert {k: engine.stats[k] for k in ("errored", "cancelled", "expired")} == dict.fromkeys(
        ("errored", "cancelled", "expired"), 1)
    assert engine.pool.n_free == engine.pool.capacity and engine.pool.reserved == 0


def test_cow_pair_equals_solo_runs(small_model):
    """Two requests whose identical prompt ends mid-block inside a resident
    block adopt that page as their speculative flush destination; each one's
    first flush copies it on write.  All three streams equal their solo,
    unshared runs bit for bit, and the donor's page is never written."""
    cfg, model, params = small_model
    rng = np.random.default_rng(7)
    pa = rng.integers(0, cfg.vocab, BLOCK + 8).astype(np.int32)
    pb = pa[:8].copy()

    def solo(prompt, max_new):
        eng = _engine(model, params, slots=3, max_seq=256, share_prefix=False)
        r = Request(uid=0, prompt=prompt, max_new_tokens=max_new)
        eng.submit(r)
        eng.run()
        return r.out_tokens

    engine = _engine(model, params, slots=3, max_seq=256, audit_every=1)
    a = Request(uid=0, prompt=pa, max_new_tokens=2 * BLOCK)
    pair = [Request(uid=i, prompt=pb.copy(), max_new_tokens=BLOCK) for i in (1, 2)]
    engine.submit(a)
    engine.step()
    page_a = a.pages[0]
    before = engine.state["caches"][0].kw[:, page_a].clone()
    for r in pair:
        engine.submit(r)
    engine.step()
    assert [r.spec_page for r in pair] == [page_a, page_a]
    assert engine.pool.refcount(page_a) == 3
    engine.run()
    assert engine.stats["cow_copies"] == 2
    assert torch.equal(engine.state["caches"][0].kw[:, page_a], before)
    assert a.out_tokens == solo(pa, 2 * BLOCK)
    want = solo(pb, BLOCK)
    assert [r.out_tokens for r in pair] == [want, want]
    assert engine.pool.n_free == engine.pool.capacity


@pytest.mark.parametrize("kw", [dict(splitkv="never"),
                                dict(mesh=object()), dict(splitkv="always"),
                                dict(page_affine=True), dict(paged=False)])
def test_unported_options_raise(small_model, kw):
    """Every option is ported.  As in the JAX engine: an object with no
    ``data`` axis as the mesh raises "mesh has no axis", ``page_affine``
    without a mesh raises "requires a mesh", and ``splitkv`` without a mesh
    serves unsplit (the split walk across ranks: tests/test_torch_dist_serve.py).
    ``paged=False``, the exact-length shim, serves (its streams against the
    paged engine's: tests/test_torch_xlstm.py)."""
    cfg, model, params = small_model
    if "mesh" in kw:
        with pytest.raises(ValueError, match="mesh has no axis 'data'"):
            _engine(model, params, **kw)
        return
    if "page_affine" in kw:
        with pytest.raises(ValueError, match="page_affine=True requires a mesh"):
            _engine(model, params, **kw)
        return
    if "splitkv" in kw:
        engine = _engine(model, params, **kw)
        req = Request(uid=0, prompt=np.arange(20, dtype=np.int32) % cfg.vocab,
                      max_new_tokens=3)
        engine.submit(req)
        summary = engine.run()
        assert req.done and summary["splitkv_steps"] == 0 and summary["pool_shards"] == 1
        return
    if kw == dict(paged=False):
        engine = _engine(model, params, **kw)
        assert not engine.paged and engine.pool is None
        req = Request(uid=0, prompt=np.arange(20, dtype=np.int32) % cfg.vocab,
                      max_new_tokens=3)
        engine.submit(req)
        summary = engine.run()
        assert req.done and req.pos == 23 and summary["prefill_calls"] == 1
        assert "kv_page_bytes" not in summary


# --------------------------------------------------------------------------
# the port's engine against the JAX engine
# --------------------------------------------------------------------------


def _to_jax(t: torch.Tensor):
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def test_engine_logits_match_jax_engine():
    """Prefix sharing, a flush on every request, staggered arrivals: the
    JAX engine and the port's, same parameters, same schedule, fed the JAX
    token stream; each active slot's logits at every decode step."""
    jcfg = jax_smoke("llama3-8b").with_(kv_bits=4, kv_block=BLOCK)
    tcfg = smoke_config("llama3-8b").with_(kv_bits=4, kv_block=BLOCK)
    jm, tm = jax_build(jcfg), build_model(tcfg)
    tparams = tm.init(torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(_to_jax, tparams)
    # the round trip is exact: the JAX tree is the port's, leaf for leaf
    back = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(back),
                                                 jax.tree.leaves(tparams)))
    rng = np.random.default_rng(9)
    base = rng.integers(0, tcfg.vocab, 2 * BLOCK + 5).astype(np.int32)
    prompts = [base, np.concatenate([base[:2 * BLOCK], rng.integers(0, tcfg.vocab, 20)]),
               rng.integers(0, tcfg.vocab, 50).astype(np.int32)]
    max_new = [40, 30, 36]

    def drive(engine_mod, model, params, wrap):
        eng = engine_mod.ServeEngine(model, params, slots=2, max_seq=128,
                                     **({} if engine_mod is jeng else {"device": "cpu"}))
        eng._step = wrap(eng, eng._step)
        reqs = [engine_mod.Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, max_new))]
        eng.submit(reqs[0])
        eng.step()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run()
        assert all(r.done for r in reqs)
        return eng

    jrec = []  # per decode step: (active slots, tokens fed, logits)

    def jwrap(eng, step):
        def run(p, s, t):
            logits, s = step(p, s, t)
            # a copy: on the CPU the token array may share the engine's buffer
            jrec.append((sorted(eng.sched.active), np.array(t), np.array(logits)))
            return logits, s
        return run

    trec = []

    def twrap(eng, step):
        def run(p, s, t):
            active, feed, _ = jrec[len(trec)]
            assert sorted(eng.sched.active) == active  # the same schedule
            logits, s = step(p, s, torch.from_numpy(feed))
            trec.append(logits.numpy())
            return logits, s
        return run

    jeng_ = drive(jeng, jm, jparams, jwrap)
    teng_ = drive(teng, tm, tparams, twrap)
    assert len(trec) == len(jrec)
    assert teng_.stats["cow_copies"] == jeng_.stats["cow_copies"]
    assert teng_.sched.stats == jeng_.sched.stats
    assert teng_.sched.stats["prefix_hit_blocks"] > 0
    for i, ((active, _, jl), tl) in enumerate(zip(jrec, trec)):
        np.testing.assert_allclose(tl[active], jl[active], err_msg=f"step {i}", **TOL)
