"""The port's async overlapped serving runtime on the CPU, at the smoke size,
on the plain versions of the kernels: the counterpart of
``tests/test_serve_async.py`` (first of three files: one file would take
one worker for ~1,000 s under ``--dist loadfile``).

* **Bit for bit against the sync oracle** under pool pressure (preemption;
  lagging steps discarded), with copy on write, and with a preemption
  before the first consumption.
* **The captured step's plain counterpart** and the dispatch-side uploads.
* **The completion worker**: its ledger, callback errors and full-queue
  watchdog.

On the CPU the captured decode step runs eagerly (its plain counterpart);
the CUDA graph itself is held to the eager step in ``test_torch_gpu.py``.
This file also holds the model, the workload and the runs of both runtimes
that the other two import.  ``test_torch_async_windows.py`` holds the window depths, prefix sharing and
the engine's liveness; ``test_torch_async_jax.py`` the JAX runner, seeded
faults, the storm and the CLI.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.core.device import upload
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Smoke-size products run as fast on one thread; several test workers
    on a shared machine would oversubscribe it.  Restored after the
    module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# --------------------------------------------------------------------------
# bit for bit against the sync oracle
# --------------------------------------------------------------------------


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
