"""The port's serving engine under a seeded fault plan, on the CPU, at the
smoke size: failed allocations, forced preemptions and delayed releases
leave every stream equal to the unpressured run, and the same plan replays
the same firings.  It is ``tests/test_torch_serve.py``'s longest test, in
a file of its own so that ``--dist loadfile`` runs it beside the others;
the model, the engine and the unpressured baseline are that file's.
"""
from repro_torch.serve import FaultPlan
from test_torch_serve import (  # noqa: F401 (small_model, baseline, one_thread: fixtures)
    _engine,
    _workload,
    baseline,
    one_thread,
    small_model,
)


def test_seeded_faults_recover_with_parity(small_model, baseline):
    """Failed allocations, forced preemptions and delayed releases from a
    seeded plan, audited every cycle: every stream equals the unpressured
    run, and the same plan replays the same firings."""
    cfg, model, params = small_model

    def run():
        plan = FaultPlan(seed=5, alloc_fail=0.3, forced_preempt=0.1, delayed_release=0.5)
        engine = _engine(model, params, n_pages=2 + 4, reserve_policy="expected",
                         expected_quantile=0.0, audit_every=1, faults=plan)
        reqs = _workload(cfg)
        for r in reqs:
            engine.submit(r)
        stats = engine.run()
        assert {r.uid: r.out_tokens for r in reqs} == baseline
        assert engine.pool.n_free == engine.pool.capacity
        return plan.log, stats

    log, stats = run()
    assert {e["site"] for e in log} == {"alloc_fail", "forced_preempt", "delayed_release"}
    assert stats["faults_injected"] == len(log) and stats["preempted"] > 0
    assert run()[0] == log
