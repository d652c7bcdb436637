"""The port's async runtime on the CPU (second of three files; the shared
pieces are ``test_torch_async.py``'s): the same workload through
``ServeEngine(async_runtime=True)`` and ``async_runtime=False`` gives the
same token streams and terminal phases with exactly-once completion, at
windows 1, 2 and 4, and with prefix sharing; ``close()`` and the runner's
watchdog.
"""
import time

import numpy as np
import pytest

from repro_torch.serve import DeadlockError, Request, ServeEngine
from test_torch_async import (  # noqa: F401 (attn_model, one_thread: fixtures)
    BLOCK,
    _outputs,
    _phases,
    _run,
    _workload,
    attn_model,
    one_thread,
)


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


# --------------------------------------------------------------------------
# liveness
# --------------------------------------------------------------------------


def test_engine_close_is_idempotent_and_sync_noop(attn_model):
    cfg, model, params = attn_model
    eng = ServeEngine(model, params, slots=2, max_seq=128, device="cpu")
    eng.close()
    eng.close()
    eng2, _ = _run(model, params, _workload(cfg, n=1), async_runtime=True)
    eng2.close()  # a second close after _run's
    assert not eng2._completions._thread.is_alive()


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
