"""The port's async runtime on the CPU (third of three files; the shared
pieces are ``test_torch_async.py``'s).

* **Against the sync oracle under seeded faults** with a ``fire_at_token``
  poison.
* **Liveness and exactly-once completion**: an admit/cancel/expire/preempt
  storm.
* **Against the JAX runner.**  Same workload, ``eos_id=None`` (so the
  schedule does not depend on token values) and the port's init carried to
  JAX: the same dispatch snapshots of (slot, admit_seq), the same
  ``dispatched``/``discarded_steps``/``preempted`` and the same completion
  order; token values compared up to each request's first flush (ROADMAP C,
  the init-scale property), where the streams may part only at a near tie:
  JAX's token within the logits tolerance of the port's best.
* **The CLI.**  ``repro_torch.launch.serve.main`` with ``--async-runtime``.
"""
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
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import FaultPlan, Phase, Request, ServeEngine, audit_engine
from test_torch_async import (  # noqa: F401 (attn_model, one_thread: fixtures)
    BLOCK,
    TOL,
    _outputs,
    _phases,
    _run,
    _workload,
    attn_model,
    one_thread,
)


# --------------------------------------------------------------------------
# bit for bit against the sync oracle
# --------------------------------------------------------------------------


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
