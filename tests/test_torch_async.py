"""The port's async overlapped serving runtime on the CPU, at the smoke size,
on the plain versions of the kernels: the counterpart of
``tests/test_serve_async.py``.

* **Bit for bit against the sync oracle.**  The same workload through
  ``ServeEngine(async_runtime=True)`` and ``async_runtime=False`` gives the
  same token streams and terminal phases: at windows 1, 2 and 4, under pool
  pressure (preemption; lagging steps discarded), under seeded faults with a
  ``fire_at_token`` poison, with prefix sharing and copy on write, and with
  a preemption before the first consumption.
* **Liveness and exactly-once completion.**  The completion worker's ledger,
  callback errors and full-queue watchdog; ``close()``; an
  admit/cancel/expire/preempt storm; the runner's watchdog.
* **Against the JAX runner.**  Same workload, ``eos_id=None`` (so the
  schedule does not depend on token values) and the port's init carried to
  JAX: the same dispatch snapshots of (slot, admit_seq), the same
  ``dispatched``/``discarded_steps``/``preempted`` and the same completion
  order; token values compared up to each request's first flush (ROADMAP C,
  the init-scale property), where the streams may part only at a near tie:
  JAX's token within the logits tolerance of the port's best.
* **The CLI.**  ``repro_torch.launch.serve.main`` with ``--async-runtime``.

On the CPU the captured decode step runs eagerly (its plain counterpart);
the CUDA graph itself is held to the eager step in ``test_torch_gpu.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes
from repro.configs.base import smoke_config as jax_smoke
from repro.models.zoo import build_model as jax_build
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import smoke_config
from repro_torch.core.device import upload
from repro_torch.launch import serve as launch_serve
from repro_torch.models.zoo import build_model
from repro_torch.serve import (
    CompletionWorker,
    DeadlockError,
    FaultPlan,
    Phase,
    Request,
    ServeEngine,
    audit_engine,
)
from repro_torch.serve.async_runtime import CapturedDecodeStep

BLOCK = 32
TOL = dict(rtol=2e-2, atol=3e-1)  # the port's logits against JAX's (test_torch_serve.py)


@pytest.fixture(scope="module")
def attn_model():
    cfg = smoke_config("llama3-8b").with_(kv_bits=4, kv_block=BLOCK)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    return cfg, model, params


def _workload(cfg, n=5, seed=42, lo=34, hi=48, new_lo=24, new_hi=32, make=Request):
    """Block-crossing prompts and decodes: flush-time allocation (the
    preemption site) and residual flushes actually fire."""
    rng = np.random.default_rng(seed)
    return [make(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(lo, hi)))
                 .astype(np.int32), max_new_tokens=int(rng.integers(new_lo, new_hi)))
            for i in range(n)]


def _run(model, params, reqs, *, async_runtime, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_seq", 128)
    engine = ServeEngine(model, params, async_runtime=async_runtime, device="cpu", **kw)
    for r in reqs:
        assert engine.submit(r)
    summary = engine.run()
    engine.close()
    return engine, summary


def _outputs(reqs):
    return {r.uid: list(r.out_tokens) for r in reqs}


def _phases(reqs):
    return {r.uid: r.phase.value for r in reqs}


def _differential(cfg, model, params, **engine_kw):
    """The same workload through both runtimes; returns (sync reqs, async
    reqs, sync summary, async summary, async engine)."""
    rs, ra = _workload(cfg), _workload(cfg)
    _, ss = _run(model, params, rs, async_runtime=False, **engine_kw)
    eng, sa = _run(model, params, ra, async_runtime=True, **engine_kw)
    assert _outputs(ra) == _outputs(rs), "async token streams diverged"
    assert _phases(ra) == _phases(rs), "terminal phases diverged"
    return rs, ra, ss, sa, eng


@pytest.fixture(scope="module")
def sync_plain(attn_model):
    cfg, model, params = attn_model
    reqs = _workload(cfg)
    _, summary = _run(model, params, reqs, async_runtime=False)
    return _outputs(reqs), _phases(reqs), summary


# --------------------------------------------------------------------------
# bit for bit against the sync oracle
# --------------------------------------------------------------------------


def test_async_matches_sync_and_records_each_completion_once(attn_model, sync_plain):
    cfg, model, params = attn_model
    ra = _workload(cfg)
    eng, sa = _run(model, params, ra, async_runtime=True)
    assert (_outputs(ra), _phases(ra)) == sync_plain[:2]
    assert all(r.done for r in ra), _phases(ra)
    ledger = eng._completions.records
    assert sorted(ledger) == sorted(r.uid for r in ra)
    assert eng._completions.duplicates == 0
    assert sa["completions_enqueued"] == len(ra)
    for r in ra:
        assert ledger[r.uid].tokens == tuple(r.out_tokens)
    # one replay a dispatch, and no kernel on the CPU
    assert eng._runner.step_fn.replays == eng._runner.dispatched > 0
    assert eng._runner.step_fn.launches == {}
    assert sa["decoded_tokens"] == sync_plain[2]["decoded_tokens"]
    assert 0.0 <= sa["host_stall_fraction"] <= 1.0


@pytest.mark.parametrize("window", [1, 2, 4])
def test_async_parity_any_window_depth(attn_model, sync_plain, window):
    """The window changes only *when* results are consumed, never what they
    are: window 1 (dispatch/consume lockstep) and windows deeper than the
    retirement lag."""
    cfg, model, params = attn_model
    ra = _workload(cfg)
    eng, _ = _run(model, params, ra, async_runtime=True, async_window=window)
    assert _outputs(ra) == sync_plain[0]
    assert not eng._runner.inflight and eng._runner.dispatched > 0


def test_async_parity_under_pool_pressure(attn_model):
    """The scratch pages plus three under expected-case reservations at
    quantile 0, audited every cycle: preemption fires in both runtimes, the
    lagging steps of retired and preempted slots are discarded, the streams
    stay equal and the pool drains."""
    cfg, model, params = attn_model
    kw = dict(n_pages=2 + 3, reserve_policy="expected", expected_quantile=0.0,
              audit_every=1)
    _rs, ra, _ss, sa, eng = _differential(cfg, model, params, **kw)
    assert all(r.done for r in ra), _phases(ra)
    assert sa["preempted"] > 0, "no pressure exercised"
    assert sa["discarded_steps"] > 0
    assert eng.pool.n_free == eng.pool.capacity
    assert audit_engine(eng).ok


def test_async_parity_under_seeded_faults(attn_model):
    """Rate-based alloc-fail / forced-preempt / delayed-release faults plus a
    schedule-invariant ``fire_at_token`` poison: the poisoned request
    retires ERRORED at the same token in both runtimes, everyone else
    completes identically."""
    cfg, model, params = attn_model

    def plan():
        return FaultPlan(seed=3, alloc_fail=0.05, forced_preempt=0.05, delayed_release=0.3,
                         fire_at_token={"poison_logits": {(2, 5)}})

    kw = dict(n_pages=2 + 3, reserve_policy="expected", expected_quantile=0.0, audit_every=1)
    rs, ra = _workload(cfg), _workload(cfg)
    _run(model, params, rs, async_runtime=False, faults=plan(), **kw)
    eng, _ = _run(model, params, ra, async_runtime=True, faults=plan(), **kw)
    assert _outputs(ra) == _outputs(rs)
    assert _phases(ra) == _phases(rs)
    assert _phases(ra)[2] == "errored"
    assert "non-finite logits row" in ra[2].error
    assert len(ra[2].out_tokens) == 6  # poisoned at progress 5, the 6th emitted
    assert audit_engine(eng).ok


def test_async_parity_with_prefix_sharing(attn_model):
    """B shares A's committed prefix blocks (admitted one step later so the
    index hit is real) and decodes across a block boundary: both runtimes
    emit the same streams and save the same prefill tokens."""
    cfg, model, params = attn_model
    rng = np.random.default_rng(6)
    pa = rng.integers(0, cfg.vocab, 2 * BLOCK).astype(np.int32)
    pb = np.concatenate([pa, rng.integers(0, cfg.vocab, 8).astype(np.int32)])

    def staged(async_runtime):
        eng = ServeEngine(model, params, slots=2, max_seq=256, async_runtime=async_runtime,
                          device="cpu")
        a = Request(uid=0, prompt=pa.copy(), max_new_tokens=BLOCK + 4)
        b = Request(uid=1, prompt=pb.copy(), max_new_tokens=BLOCK + 4)
        eng.submit(a)
        eng.step()  # A adopted, its prefix registered
        eng.submit(b)
        eng.step()  # B admitted: sharing visible before retirement
        assert len(b.shared_pages) == 2
        s = eng.run()
        eng.close()
        assert a.done and b.done
        return _outputs([a, b]), s

    out_async, sa = staged(True)
    out_sync, ss = staged(False)
    assert out_async == out_sync
    assert sa["prefill_tokens_saved"] == ss["prefill_tokens_saved"] > 0


def test_async_parity_with_copy_on_write(attn_model):
    """Two requests whose identical prompt ends inside a resident block take
    it as their speculative flush destination and copy it on write at their
    first flush (decided at the dispatch frontier): the streams equal the
    sync engine's, and the donor's page is never written."""
    cfg, model, params = attn_model
    rng = np.random.default_rng(7)
    pa = rng.integers(0, cfg.vocab, BLOCK + 8).astype(np.int32)

    def staged(async_runtime):
        eng = ServeEngine(model, params, slots=3, max_seq=256, audit_every=1,
                          async_runtime=async_runtime, device="cpu")
        a = Request(uid=0, prompt=pa.copy(), max_new_tokens=2 * BLOCK)
        pair = [Request(uid=i, prompt=pa[:8].copy(), max_new_tokens=BLOCK) for i in (1, 2)]
        eng.submit(a)
        eng.step()
        page_a = a.pages[0]
        before = eng.state["caches"][0].kw[:, page_a].clone()
        for r in pair:
            eng.submit(r)
        eng.step()
        assert [r.spec_page for r in pair] == [page_a, page_a]
        eng.run()
        eng.close()
        assert torch.equal(eng.state["caches"][0].kw[:, page_a], before)
        assert eng.stats["cow_copies"] == 2
        return _outputs([a, *pair])

    assert staged(True) == staged(False)


def test_async_preempt_before_first_consumption(attn_model):
    """A request whose admission first token is still on the device (no
    consumption reached it) is preempted: the runtime resolves it into the
    parked feed, so rematerialisation replays the right stream."""
    cfg, model, params = attn_model

    def plan():
        return FaultPlan(fire_at={"forced_preempt": (0, 1, 2)})

    rs, ra = _workload(cfg, n=3), _workload(cfg, n=3)
    _run(model, params, rs, async_runtime=False, faults=plan(), n_pages=2 + 6, audit_every=1)
    eng, sa = _run(model, params, ra, async_runtime=True, faults=plan(), n_pages=2 + 6,
                   audit_every=1, async_window=4)
    assert _outputs(ra) == _outputs(rs)
    assert sa["preempted"] > 0
    assert audit_engine(eng).ok


# --------------------------------------------------------------------------
# the captured step's plain counterpart and the dispatch-side uploads
# --------------------------------------------------------------------------


def test_captured_step_on_the_cpu_is_the_eager_step(attn_model):
    """On the CPU the captured step is the model's decode step plus the
    argmax feed: the same logits' argmax, ``pos`` advanced in place (the
    state dict keeps its tensors), the finite flags, no kernel counted."""
    cfg, model, params = attn_model
    prompt = torch.from_numpy(np.arange(40, dtype=np.int64) % cfg.vocab)[None].repeat(2, 1)
    with torch.no_grad():
        _, ref = model.prefill(params, {"tokens": prompt}, 128)
        _, st = model.prefill(params, {"tokens": prompt}, 128)
        fresh = {k: v.clone() for k, v in ((f, getattr(st["caches"][0], f))
                                           for f in ("k_res", "res_len", "pack_blocks"))}
        step = CapturedDecodeStep(model, params, st)
        for name, t in fresh.items():  # construction ran nothing on the CPU
            assert torch.equal(getattr(st["caches"][0], name), t)
        pos = st["pos"]
        feed = torch.zeros((2, 1), dtype=torch.int32)
        for _ in range(3):
            logits, ref = model.decode_step(params, ref, feed)
            step.replay()
            assert st["pos"] is pos and torch.equal(pos, ref["pos"])
            assert torch.equal(step.nxt, logits[:, 0].argmax(-1).int())
            assert torch.equal(step.tokens[:, 0], step.nxt) and bool(step.finite.all())
            feed = step.tokens.clone()
    assert step.replays == 3 and step.launches == {}


def test_upload_copies_host_values():
    """``upload`` on the CPU returns a tensor that does not alias the
    caller's array (the engine rewrites its host buffers after a push)."""
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = upload(a, "cpu")
    a[0, 0] = 99
    assert t.dtype == torch.int32 and t.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert upload([1, 2], "cpu", torch.long).dtype == torch.long


# --------------------------------------------------------------------------
# completion worker: ledger, callbacks, watchdogs
# --------------------------------------------------------------------------


class _Req:
    """A retired-request stand-in for the worker's unit tests."""

    def __init__(self, uid, tokens=(1, 2, 3), phase=Phase.DONE, error=None):
        self.uid = uid
        self.out_tokens = list(tokens)
        self.phase = phase
        self.error = error


def test_completion_worker_detokenizes_and_records_once():
    seen = []
    w = CompletionWorker(queue_size=4, watchdog_s=5.0,
                         detokenizer=lambda toks: "|".join(map(str, toks)),
                         on_complete=lambda rec: seen.append(rec.uid))
    try:
        w.put(_Req(7, (4, 5)))
        w.put(_Req(8, (6,), phase=Phase.ERRORED, error="boom"))
        w.drain()
        assert sorted(w.records) == [7, 8]
        assert w.records[7].text == "4|5" and w.records[7].phase == "done"
        assert w.records[8].error == "boom"
        assert sorted(seen) == [7, 8]
        w.put(_Req(7, (9, 9)))  # a duplicate retirement is counted, never overwrites
        w.drain()
        assert w.duplicates == 1 and w.records[7].tokens == (4, 5)
    finally:
        w.close()


def test_completion_callback_error_surfaces_at_drain():
    w = CompletionWorker(queue_size=4, watchdog_s=5.0,
                         on_complete=lambda rec: (_ for _ in ()).throw(ValueError("cb")))
    try:
        w.put(_Req(1))
        with pytest.raises(ValueError, match="cb"):
            w.drain()
        assert 1 in w.records  # the record landed before the callback raised
    finally:
        w.close()


def test_completion_queue_full_raises_deadlock_not_hang():
    """A wedged consumer turns a full bounded queue into a DeadlockError
    within about watchdog_s, not a hang."""
    release = threading.Event()
    w = CompletionWorker(queue_size=1, watchdog_s=0.2,
                         detokenizer=lambda toks: (release.wait(10), "")[1])
    try:
        w.put(_Req(0))        # the worker takes this one and blocks
        time.sleep(0.05)
        w.put(_Req(1))        # fills the queue
        t0 = time.perf_counter()
        with pytest.raises(DeadlockError, match="completion queue full"):
            w.put(_Req(2))
        assert time.perf_counter() - t0 < 5.0
        with pytest.raises(DeadlockError, match="failed to drain"):
            w.drain()
    finally:
        release.set()
        w.close()


def test_engine_close_is_idempotent_and_sync_noop(attn_model):
    cfg, model, params = attn_model
    eng = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    eng.close()
    eng.close()
    eng2, _ = _run(model, params, _workload(cfg, n=1), async_runtime=True)
    eng2.close()  # a second close after _run's
    assert not eng2._completions._thread.is_alive()


# --------------------------------------------------------------------------
# concurrency stress and liveness
# --------------------------------------------------------------------------


def test_storm_admit_cancel_expire_preempt_no_loss_no_double(attn_model):
    """Staggered submissions, random cancels (waiting and active), short
    deadlines on an injectable clock, forced preemption and delayed page
    release over an oversubscribed pool, driven step by step with the
    watchdog armed: every submitted uid completes exactly once, the auditor
    is clean at drain, and two DONE streams equal their solo runs."""
    cfg, model, params = attn_model
    rng = np.random.default_rng(11)
    now = [0.0]
    plan = FaultPlan(seed=5, forced_preempt=0.08, delayed_release=0.4, delay_cycles=3)
    eng = ServeEngine(model, params, slots=2, max_seq=128, n_pages=2 + 3,
                      reserve_policy="expected", expected_quantile=0.0, faults=plan,
                      audit_every=1, clock=lambda: now[0], async_runtime=True,
                      async_window=3, watchdog_s=20.0, device="cpu")
    pending = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(rng.integers(34, 48)))
                       .astype(np.int32), max_new_tokens=int(rng.integers(10, 24)),
                       deadline_s=(float(rng.integers(3, 9)) if rng.random() < 0.35 else None))
               for i in range(14)]
    deadline = time.perf_counter() + 120.0
    all_reqs, cancelled, submitted = [], set(), set()
    while eng._has_work() or pending:
        assert time.perf_counter() < deadline, "storm exceeded wall clock"
        if pending and rng.random() < 0.4:
            req = pending.pop()
            assert eng.submit(req)
            submitted.add(req.uid)
            all_reqs.append(req)
        if submitted and rng.random() < 0.08:
            uid = int(rng.choice(sorted(submitted)))
            if eng.cancel(uid) is not None:
                cancelled.add(uid)
        now[0] += 1.0
        if eng._has_work():
            eng.step()
            eng._runner.check_liveness()
    summary = eng.run()
    eng.close()
    terminal = {Phase.DONE, Phase.CANCELLED, Phase.EXPIRED, Phase.ERRORED}
    assert all(r.phase in terminal for r in all_reqs), _phases(all_reqs)
    ledger = eng._completions.records
    assert sorted(ledger) == sorted(submitted) and eng._completions.duplicates == 0
    assert summary["completions_enqueued"] == len(submitted)
    phases = {r.phase for r in all_reqs}
    assert Phase.DONE in phases and (cancelled or Phase.EXPIRED in phases)
    for r in [r for r in all_reqs if r.phase is Phase.DONE][:2]:
        solo_eng = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
        solo = Request(uid=0, prompt=np.asarray(r.prompt).copy(),
                       max_new_tokens=r.max_new_tokens)
        solo_eng.submit(solo)
        solo_eng.run()
        assert list(r.out_tokens) == list(solo.out_tokens), r.uid
    assert eng.pool.n_free == eng.pool.capacity and eng.pool.reserved == 0
    assert audit_engine(eng).ok


def test_runner_watchdog_raises_on_stall(attn_model):
    """A runner whose clock says nothing progressed for longer than
    watchdog_s raises DeadlockError, and the workload still finishes."""
    cfg, model, params = attn_model
    eng = ServeEngine(model, params, slots=2, max_seq=128, async_runtime=True,
                      watchdog_s=0.05, device="cpu")
    try:
        reqs = _workload(cfg, n=1)
        for r in reqs:
            eng.submit(r)
        eng.step()
        eng._runner.last_progress -= 10.0
        with pytest.raises(DeadlockError, match="no progress"):
            eng._runner.check_liveness()
        eng._runner.last_progress = time.perf_counter()
        eng.run()
        assert all(r.done for r in reqs)
    finally:
        eng.close()


# --------------------------------------------------------------------------
# against the JAX runner
# --------------------------------------------------------------------------


def _to_jax(t: torch.Tensor):
    a = t.numpy() if t.dtype != torch.bfloat16 else (
        t.view(torch.int16).numpy().view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


class _RecordingDeque(list):
    """Stands in for the runner's in-flight deque and keeps, per dispatch,
    the snapshot of (slot, admit_seq)."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def append(self, rec):
        self.log.append([(slot, seq) for slot, _req, seq in rec.snap])
        super().append(rec)

    def popleft(self):
        return self.pop(0)


def _solo_rows(model, params, req):
    """The port's logits row behind each of ``req``'s tokens, from a solo
    run of its prompt through the sync engine (a row's result does not
    depend on the other slots): the prefill's, then each decode step's."""
    eng = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    rows, prefill, step = [], eng._prefill, eng._step

    def on_prefill(toks, lens):
        logits, dstate = prefill(toks, lens)
        rows.append(logits[0, 0].float())
        return logits, dstate

    def on_step(p, s, t):
        logits, s = step(p, s, t)
        rows.append(logits[0, 0].float())
        return logits, s

    eng._prefill, eng._step = on_prefill, on_step
    solo = Request(uid=0, prompt=np.asarray(req.prompt).copy(), max_new_tokens=req.max_new_tokens)
    eng.submit(solo)
    eng.run()
    assert solo.out_tokens == req.out_tokens
    return rows


@pytest.fixture(scope="module")
def jax_twin(attn_model):
    """The port's init carried to the JAX smoke model."""
    _, _, tparams = attn_model
    jcfg = jax_smoke("llama3-8b").with_(kv_bits=4, kv_block=BLOCK)
    return jcfg, jax_build(jcfg), jax.tree.map(_to_jax, tparams)


@pytest.mark.parametrize("pressure", [False, True])
def test_runner_trace_matches_jax_runner(attn_model, jax_twin, pressure):
    """Same workload, ``eos_id=None``: the port's runner and JAX's
    ``AsyncRunner`` dispatch the same active sets step by step, count the
    same dispatches, discards and preemptions, and complete the requests in
    the same order.  Tokens agree up to each request's first decode step
    that reads a block packed by a flush."""
    cfg, model, params = attn_model
    jcfg, jmodel, jparams = jax_twin
    kw = dict(slots=2, max_seq=128, async_runtime=True, async_window=2)
    if pressure:
        kw.update(n_pages=2 + 3, reserve_policy="expected", expected_quantile=0.0,
                  audit_every=1)

    def drive(engine_cls, model_, params_, make, extra):
        order, snaps = [], []
        eng = engine_cls(model_, params_, on_complete=lambda rec: order.append(rec.uid),
                         **kw, **extra)
        eng._runner.inflight = _RecordingDeque(snaps)
        reqs = _workload(cfg, make=make)
        for r in reqs:
            assert eng.submit(r)
        summary = eng.run()
        eng.close()
        return reqs, summary, order, snaps, eng._runner.dispatched

    t_reqs, t_sum, t_order, t_snaps, t_disp = drive(ServeEngine, model, params, Request,
                                                    {"device": "cpu"})
    j_reqs, j_sum, j_order, j_snaps, j_disp = drive(JServeEngine, jmodel, jparams, JRequest, {})
    assert t_snaps == j_snaps
    assert t_disp == j_disp == len(t_snaps)
    for key in ("discarded_steps", "preempted", "decoded_tokens", "completions_enqueued"):
        assert t_sum[key] == j_sum[key], key
    assert t_order == j_order and sorted(t_order) == [r.uid for r in t_reqs]
    assert (t_sum["preempted"] > 0) == pressure and t_sum["discarded_steps"] > 0
    for tr, jr in zip(t_reqs, j_reqs):
        assert len(tr.out_tokens) == len(jr.out_tokens) == tr.max_new_tokens
        # token j > 0 comes from decode step j - 1; step BLOCK - 1 - prompt_len % BLOCK
        # fills the residual and reads the block its flush packed
        first_read = BLOCK - tr.prompt_len % BLOCK
        mine, theirs = tr.out_tokens[:first_read], [int(t) for t in jr.out_tokens[:first_read]]
        d = next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b), None)
        if d is not None:
            # the streams part at a near tie: JAX's token scores within the
            # cross-framework logits tolerance of the port's best there
            row = _solo_rows(model, params, tr)[d]
            top = row.max().item()
            assert top - row[theirs[d]].item() <= TOL["atol"] + TOL["rtol"] * abs(top), (
                tr.uid, d, mine[d], theirs[d])


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_serve_cli_async_runtime_on_the_cpu(capsys):
    launch_serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--async-runtime",
                       "--requests", "4", "--slots", "2", "--prompt-len", "40",
                       "--max-new", "6", "--max-seq", "128", "--audit-every", "1"])
    out = capsys.readouterr().out
    assert "[serve] engine mode: paged, pool=" in out
    assert "[serve] async runtime: window=2" in out and "discarded_steps=" in out
    stats = next(line for line in out.splitlines() if line.startswith("[serve] {"))
    assert "'decoded_tokens': 24" in stats and "'completions_enqueued': 4" in stats
    assert "[serve] latency: ttft_p50=" in out and "host_stall=" in out


@pytest.mark.parametrize("argv, item", [
    (["--dense"], "10"), (["--splitkv", "always"], "11"),
    (["--family", "hybrid", "--dense"], "10"), (["--family", "xlstm"], "10"),
    (["--splitkv", "never"], "11"), (["--dense", "--spec-k", "2"], "10"),
])
def test_serve_cli_refuses_what_is_not_ported(argv, item, capsys):
    """What queue A items 10 and 11 named is ported: ``--dense`` (the
    exact-length shim, for any family, with ``--spec-k`` too) and ``--family
    xlstm`` serve the smoke configs on the CPU, and ``--splitkv`` goes to the
    engine as in the JAX launcher, which builds no mesh: the paged engine
    serves with every step unsplit."""
    argv = ["--smoke", "--device", "cpu", *argv] + (
        [] if "--family" in argv else ["--arch", "llama3-8b"])
    if item == "11":
        stats = launch_serve.main(argv + ["--requests", "3", "--slots", "2", "--prompt-len",
                                          "20", "--max-new", "4", "--max-seq", "128"])
        assert "[serve] engine mode: paged, pool=" in capsys.readouterr().out
        assert stats["decoded_tokens"] == 12 and stats["budget_retired"] == 3
        assert stats["splitkv_steps"] == 0 and stats["pool_shards"] == 1
        return
    stats = launch_serve.main(argv + ["--requests", "3", "--slots", "2", "--prompt-len", "20",
                                      "--max-new", "4", "--max-seq", "128"])
    assert "[serve] engine mode: exact-length shim" in capsys.readouterr().out
    assert stats["decoded_tokens"] == 12 and stats["budget_retired"] == 3
    assert stats["prefill_calls"] == 3
