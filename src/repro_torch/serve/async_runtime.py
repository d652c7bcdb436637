"""Async overlapped serving runtime: the port of the JAX package's
``serve/async_runtime.py``.

The synchronous :class:`~repro_torch.serve.engine.ServeEngine` cycle stops
the world once per decoded token: enqueue the decode step layer by layer,
read the logits back, argmax on the host, do the scheduling bookkeeping,
then enqueue the next step.  On the card the host's enqueueing of some
2,400 kernels a step takes longer than the kernels themselves, and the
card idles through every host phase.  This module restructures the loop:

* **One captured decode step.**  :class:`CapturedDecodeStep` records the
  model's ``decode_step`` over the engine's own state tensors, followed by
  the next-token argmax and a per-row finite flag on the device and a copy
  of the argmax into its token buffer, as one CUDA graph
  (``torch.cuda.graph``).  A decode step is then one ``replay()``: one
  launch from the host.  The graph reads and writes the state in place, so
  the engine keeps the very tensors it captured: admission, the page-table
  push and copy on write all write into them.  On the CPU the same call
  runs the step eagerly.

* **Device-resident token feed, bounded in-flight window.**  The argmax of
  one step feeds the next through the graph's token buffer, with no host
  round trip.  Each dispatch queues copies of its argmax and finite flag
  into fresh pinned host buffers and records a CUDA event after them; at
  most ``window`` such records are in flight.  The host consumes the
  *oldest* (waiting on its event: the runtime's one host sync) while the
  younger steps run.  All per-token bookkeeping (EOS and budget retirement,
  replay accounting, poisoned-step isolation) runs at this consumption
  boundary, through the same ``ServeEngine._advance_one`` body the sync
  cycle uses, so the token streams equal the sync oracle's bit for bit.

* **Dispatch-frontier control state.**  Host decisions that must precede a
  dispatch (flush-destination allocation, copy on write, page-table pushes,
  admission) run against a dispatch-side position mirror that leads
  ``req.pos`` (consumption truth) by the in-flight depth.  Retirement is
  discovered late, by up to ``window`` steps: the lagging steps decode
  garbage into the request's still-private pages, their results are
  recognised at consumption by an ``admit_seq`` mismatch and discarded
  (``discarded_steps``), and stream order guarantees that a freed page is
  written by its next owner *after* any lagging garbage flush.  Preemption
  parks the consumption-frontier feed token (``engine.tokens``), so
  rematerialisation replays exactly the sync stream.

* **Background completion thread.**  Terminal requests go to a
  :class:`CompletionWorker` through a bounded queue; it detokenizes and runs
  the completion callback off the dispatch thread and records every
  completion exactly once.  Every blocking queue operation carries a
  ``watchdog_s`` timeout that raises :class:`DeadlockError`.

Admission does not sync either: the prefill's first-token argmax stays on
the device (:class:`DeviceTokens`) and is copied into the token buffer by an
index copy queued before the slot's first dispatch; its host value is read
at the slot's first consumption boundary, or at once if the request is
preempted before that.  Every host-to-device upload on the dispatch side
goes through pinned memory (``core.device.upload``).

Kernel launches are counted by the Python wrappers (``kernels._build``), so
a capture counts each kernel of the step once and a replay counts nothing:
:attr:`CapturedDecodeStep.launches` gives the capture's count times the
replays.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.device import upload
from repro_torch.kernels import _build


class DeadlockError(RuntimeError):
    """A bounded queue operation or the liveness watchdog timed out: the
    overlapped runtime would otherwise deadlock or livelock silently."""


#: feed-plan marker: this dispatch's feed is a not-yet-resolved device-side
#: prefill first token (see ``AsyncRunner._lazy_first``)
_LAZY = object()

#: completion-queue shutdown sentinel
_SENTINEL = object()


@dataclasses.dataclass(frozen=True)
class CompletionRecord:
    """What the background thread produces per finished request."""

    uid: int
    phase: str          # terminal Phase value ("done", "errored", ...)
    tokens: tuple       # the request's final output token ids
    text: str           # detokenizer output
    error: str | None   # req.error at retirement


class CompletionWorker:
    """Bounded-queue background detokenize/completion thread.

    The engine's single retirement path enqueues every terminal request
    (``ServeEngine._retire``); this thread detokenizes, fires the
    ``on_complete`` callback, and records the completion in a thread-safe
    ledger (``records``: uid -> :class:`CompletionRecord`).  A uid enqueued
    twice increments ``duplicates`` instead of overwriting.  Callback and
    detokenizer exceptions are captured in ``errors`` and re-raised at
    :meth:`drain` (the worker itself never dies).  ``put`` blocks at most
    ``watchdog_s`` on a full queue and ``drain`` waits at most
    ``watchdog_s`` for the queue to empty; both raise
    :class:`DeadlockError` on timeout."""

    def __init__(self, *, queue_size: int = 64, watchdog_s: float = 30.0,
                 detokenizer=None, on_complete=None):
        self.watchdog_s = float(watchdog_s)
        self.detokenizer = (detokenizer if detokenizer is not None
                            else (lambda toks: " ".join(str(t) for t in toks)))
        self.on_complete = on_complete
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(queue_size)))
        self._lock = threading.Lock()
        self.records: dict[int, CompletionRecord] = {}
        self.duplicates = 0
        self.errors: list[Exception] = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop, name="serve-completions",
                                        daemon=True)
        self._thread.start()

    @property
    def processed(self) -> int:
        """Completions recorded so far (thread-safe)."""
        with self._lock:
            return len(self.records)

    def put(self, req) -> None:
        """Enqueue a just-retired request (main thread).  The payload is
        snapshotted here: the worker never touches live Request state."""
        item = (req.uid, req.phase.value, tuple(req.out_tokens), req.error)
        try:
            self._q.put(item, timeout=self.watchdog_s)
        except queue.Full:
            raise DeadlockError(
                f"completion queue full for {self.watchdog_s:.1f}s "
                f"(maxsize {self._q.maxsize}): detokenize thread wedged") from None

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _SENTINEL:
                self._q.task_done()
                return
            uid, phase, tokens, error = item
            try:
                rec = CompletionRecord(uid=uid, phase=phase, tokens=tokens,
                                       text=self.detokenizer(tokens), error=error)
                with self._lock:
                    if uid in self.records:
                        self.duplicates += 1
                    else:
                        self.records[uid] = rec
                if self.on_complete is not None:
                    self.on_complete(rec)
            except Exception as exc:  # surfaced at drain, the thread survives
                with self._lock:
                    self.errors.append(exc)
            finally:
                self._q.task_done()

    def drain(self) -> None:
        """Block until every enqueued completion was processed; re-raise the
        first captured worker exception; DeadlockError past watchdog_s."""
        deadline = time.perf_counter() + self.watchdog_s
        while self._q.unfinished_tasks:
            if time.perf_counter() > deadline:
                raise DeadlockError(
                    f"completion queue failed to drain within {self.watchdog_s:.1f}s "
                    f"({self._q.unfinished_tasks} item(s) outstanding)")
            time.sleep(0.001)
        with self._lock:
            if self.errors:
                raise self.errors[0]

    def close(self, timeout: float | None = None) -> None:
        """Stop the worker thread (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._thread.join(self.watchdog_s if timeout is None else timeout)


# --------------------------------------------------------------------------
# the decode step as one CUDA graph
# --------------------------------------------------------------------------

#: eager steps before the capture: the first builds the kernels and fills
#: the occupancy cache, the second runs with everything settled
_WARMUP_STEPS = 2


def _state_tensors(state) -> list[torch.Tensor]:
    """Every tensor of a decode state (each cache field, ``pos``, each
    tensor of a side state such as the hybrid's Mamba2 states or xLSTM's
    nested recurrent states), a tensor expanded over a leading axis (the
    shared page table) as its one underlying slice: what a step may write in
    place."""
    out = []
    for key, node in state.items():
        if key == "caches":
            for cache in node:
                for f in dataclasses.fields(cache):
                    t = getattr(cache, f.name)
                    if isinstance(t, torch.Tensor):
                        while t.dim() and t.stride(0) == 0:
                            t = t[0]
                        out.append(t)
        elif isinstance(node, dict):
            out += _state_tensors(node)
        else:
            out.append(node)
    return out


class DeviceTokens:
    """Token ids on the device (a prefill's first-token argmax, ``[R]``)
    with a copy to a pinned host buffer queued at once: :meth:`value` waits
    for that copy alone, and returns at once after any later event of the
    stream has completed."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        self._ready = None
        if dev.is_cuda:
            self._host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            self._host.copy_(dev, non_blocking=True)
            self._ready = torch.cuda.Event()
            self._ready.record()
        else:
            self._host = dev

    def value(self, row: int) -> int:
        if self._ready is not None:
            self._ready.synchronize()
        return int(self._host[row])


class CapturedPass:
    """A body over a decode ``state`` that runs as one CUDA graph on the card:
    the machinery :class:`CapturedDecodeStep` and the speculative passes
    (``serve/speculative.py``) share.

    On the card :meth:`capture` runs the body ``_WARMUP_STEPS`` times
    eagerly on a side stream (the kernel library's build, the occupancy
    queries, cuBLAS's handles and the allocator settle), captures one run
    as a CUDA graph, and restores every state tensor and every buffer of
    :meth:`_buffers` to what it held before: the warm-up wrote them.
    :meth:`replay` then launches the graph on the current stream.  A failed
    capture raises; there is no eager fallback on the card.  On the CPU
    :meth:`replay` runs the same body eagerly.

    The body must read and write only tensors that live as long as the pass
    (the state's, written in place, and the pass's own buffers), and must
    neither copy from the host nor synchronise.  ``capture_launches``
    counts the kernels the capture recorded (the wrappers count at capture,
    not at replay); ``replays`` the runs."""

    what = "the pass"

    def __init__(self, state, splitkv=None):
        self.state = state
        # a ``core.attention.use_splitkv`` the body runs under (None: unsplit)
        self.splitkv = splitkv
        self.replays = 0
        self.capture_launches: collections.Counter = collections.Counter()
        self.graph = None

    def _body(self) -> None:
        raise NotImplementedError

    def _buffers(self) -> list[torch.Tensor]:
        """The pass's own tensors the warm-up may write."""
        return []

    def _run(self) -> None:
        """The body, under the pass's split-KV context if it has one."""
        with self.splitkv if self.splitkv is not None else contextlib.nullcontext():
            self._body()

    def capture(self) -> None:
        """Capture the body as a graph (on the card; a no-op on the CPU)."""
        if self.state["pos"].device.type != "cuda":
            return
        keep = _state_tensors(self.state) + self._buffers()
        saved = [t.clone() for t in keep]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.no_grad():
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):  # a split step's collective starts here
                    self._run()
            torch.cuda.current_stream().wait_stream(side)
            before = collections.Counter(_build.launches)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    self._run()
            except Exception as err:
                raise RuntimeError(f"capturing {self.what} as a CUDA graph failed: "
                                   f"{err}") from err
            self.capture_launches = collections.Counter(_build.launches) - before
            for t, s in zip(keep, saved):
                t.copy_(s)
        self.graph = graph

    def replay(self) -> None:
        """Run the body once: the graph on the card, eagerly on the CPU."""
        if self.graph is not None:
            self.graph.replay()
        else:
            with torch.no_grad():
                self._run()
        self.replays += 1

    @property
    def launches(self) -> dict:
        """Kernel launches of the replays so far: the capture's count of
        each kernel times the replays (the eager runs on the CPU launch no
        kernel)."""
        return {k: v * self.replays for k, v in self.capture_launches.items()}


class CapturedDecodeStep(CapturedPass):
    """One decode step of ``model`` over ``state``, with the next-token
    argmax (``nxt``, int32 ``[B]``) and the rows' finiteness (``finite``,
    bool ``[B]``) computed on the device and the argmax copied into the
    step's token buffer (``tokens``, int32 ``[B, 1]``): the feed of the next
    step.  The step writes ``state`` in place, ``state["pos"]`` included:
    the model's ``decode_step`` updates the caches and any side state (the
    hybrid's Mamba2 states) in place, and the body copies ``pos`` back.
    Captured on construction (:class:`CapturedPass`).

    ``splitkv`` (a ``core.attention.use_splitkv``): the split-KV decode step,
    whose merge's all-gather is captured in the graph; its warm-up runs the
    collective first, outside the capture (NCCL's first collective sets up
    its communicator).  ``share`` (another captured step): take its token,
    argmax and finite buffers, so the two steps feed one token stream."""

    what = "the decode step"

    def __init__(self, model, params, state, *, impl: str = "auto",
                 quant_impl: str = "auto", splitkv=None, share=None):
        super().__init__(state, splitkv)
        self.model, self.params = model, params
        self.impl, self.quant_impl = impl, quant_impl
        pos = state["pos"]
        dev = pos.device
        b = pos.shape[0]
        if share is not None:
            self.tokens, self.nxt, self.finite = share.tokens, share.nxt, share.finite
        else:
            self.tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
            self.nxt = torch.zeros((b,), dtype=torch.int32, device=dev)
            self.finite = torch.ones((b,), dtype=torch.bool, device=dev)
        self.capture()

    def _buffers(self) -> list[torch.Tensor]:
        return [self.tokens, self.nxt, self.finite]

    def _body(self) -> None:
        logits, st = self.model.decode_step(self.params, self.state, self.tokens,
                                            impl=self.impl, quant_impl=self.quant_impl)
        self.state["pos"].copy_(st["pos"])
        row = logits[:, 0]
        nxt = row.argmax(-1)
        self.nxt.copy_(nxt)
        self.finite.copy_(torch.isfinite(row).all(-1))
        self.tokens.copy_(nxt[:, None])

    def read_back(self):
        """Queue copies of the last step's ``nxt`` and ``finite`` into fresh
        host buffers (pinned on the card) and an event after them.  Returns
        (nxt, finite, event); the event is None on the CPU, where the copies
        are done on return."""
        if self.graph is None:
            return self.nxt.clone(), self.finite.clone(), None
        nxt = torch.empty(self.nxt.shape, dtype=self.nxt.dtype, pin_memory=True)
        finite = torch.empty(self.finite.shape, dtype=self.finite.dtype, pin_memory=True)
        nxt.copy_(self.nxt, non_blocking=True)
        finite.copy_(self.finite, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return nxt, finite, done


# --------------------------------------------------------------------------
# the overlapped decode loop
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unconsumed decode step."""

    cycle: int      # engine cycle that dispatched it (error attribution)
    nxt: object     # host [slots] int32: per-slot next-token argmax, once `done`
    finite: object  # host [slots] bool: per-slot logits-row finiteness
    done: object    # CUDA event after the copies (None on the CPU)
    snap: list      # [(slot, req, admit_seq)] active set at dispatch
    lazy: dict      # slot -> (DeviceTokens, row, admit_seq): firsts to resolve here
    t0: float       # dispatch wall time (pipeline token latency)


class AsyncRunner:
    """The overlapped decode loop behind ``ServeEngine(async_runtime=True)``.

    One :meth:`step` = consume the oldest in-flight record if the window is
    full, run the scheduling skeleton (deferred releases, expiry, faults,
    admission: prefill dispatches queue behind the in-flight decode),
    pre-allocate dispatch-frontier flush destinations, then dispatch one
    more decode step (one graph replay) without waiting for any of it.  See
    the module docstring for the parity argument."""

    def __init__(self, engine, *, window: int = 2, watchdog_s: float = 30.0):
        if window < 1:
            raise ValueError(f"async window {window} must be >= 1")
        self.eng = engine
        self.window = int(window)
        self.watchdog_s = float(watchdog_s)
        self.inflight: deque[_InFlight] = deque()
        self.dispatched = 0
        self.last_progress = time.perf_counter()
        # dispatch-frontier mirrors (consumption truth lives on the Request)
        self._dispatch_pos: dict[int, int] = {}
        self._feed_plan: dict[int, deque] = {}
        # slot -> (DeviceTokens, row, admit_seq): unresolved admission first
        # tokens, resolved at first consumption or at preemption
        self._lazy_first: dict[int, tuple] = {}
        # entries not yet attached to a dispatch record (exactly one each)
        self._pending_lazy: dict[int, tuple] = {}
        # set when a consumption empties the pipeline, cleared (and observed
        # as device_starved_s) at the next dispatch; None before the first
        # dispatch: filling the pipeline at startup is prefill-bound, not
        # starvation, in both runtimes
        self._idle_since: float | None = None
        # the decode step to replay: the split-KV one alone when the engine
        # always splits, else the unsplit one, with the split one captured
        # at its first use (sharing the token buffers)
        always = engine._splitkv_ctx is not None and engine._splits_always()
        self.step_fn = CapturedDecodeStep(
            engine.model, engine.params, engine.state, impl=engine._impl,
            quant_impl=engine._quant_impl, splitkv=engine._splitkv_ctx if always else None)
        self._split_fn = self.step_fn if always else None

    # ----------------------------------------------------------- liveness

    @property
    def pending(self) -> bool:
        """True while dispatched steps await consumption (drain gate)."""
        return bool(self.inflight)

    def check_liveness(self) -> None:
        """Raise :class:`DeadlockError` when the runtime has work but made
        no progress (dispatch, consumption, retirement) for watchdog_s."""
        if not self.eng._has_work():
            return
        stalled = time.perf_counter() - self.last_progress
        if stalled > self.watchdog_s:
            raise DeadlockError(
                f"async runtime made no progress for {stalled:.1f}s "
                f"(> watchdog_s={self.watchdog_s}): {len(self.inflight)} in flight, "
                f"{len(self.eng.sched.active)} active, {len(self.eng.sched.waiting)} waiting")

    # ----------------------------------------------------- engine hooks

    def on_slot_cleared(self, slot: int) -> None:
        """Retirement hook: drop the slot's dispatch-frontier mirrors; its
        lagging in-flight steps are discarded at consumption."""
        self._dispatch_pos.pop(slot, None)
        self._feed_plan.pop(slot, None)
        self._lazy_first.pop(slot, None)
        self._pending_lazy.pop(slot, None)
        self.last_progress = time.perf_counter()

    def on_preempt(self, req) -> None:
        """Preemption hook, called before the engine reads the parked token
        from ``engine.tokens``: if the slot's admission first token is still
        on the device (no consumption reached it yet), resolve it into the
        host mirror now (the one host wait outside consumption)."""
        slot = req.slot
        lazy = self._lazy_first.pop(slot, None)
        if lazy is not None and req.replay_left == 0:
            first, row, seq = lazy
            if seq == req.admit_seq:
                self.eng.tokens[slot, 0] = first.value(row)
        self._dispatch_pos.pop(slot, None)
        self._feed_plan.pop(slot, None)
        self._pending_lazy.pop(slot, None)

    # ------------------------------------------------------- the cycle

    def step(self) -> bool:
        eng = self.eng
        t0 = time.perf_counter()
        eng._cycle += 1
        eng._cycle_worked = False
        try:
            with torch.no_grad():
                return self._step_once(t0)
        finally:
            eng._finish_cycle(t0)

    def _step_once(self, t0: float) -> bool:
        eng = self.eng
        if len(self.inflight) >= self.window:
            self._consume_one()
        eng._lifecycle()
        # prefill admission queues behind the in-flight decode steps; its
        # first tokens stay on the device (defer_first); the shim prefills
        # each request alone at its exact length
        admit = eng._admit_and_prefill if eng.paged else eng._admit_exact
        self._register_admissions(admit(defer_first=True))
        if not eng.sched.active:
            return self._drain_progress()
        if eng.paged:
            with eng._phase("schedule"):
                eng._ensure_flush_pages(pos_of=self._frontier_pos)
                eng._push_table()
            if not eng.sched.active:  # everyone self-preempted under faults
                return self._drain_progress()

        eng._cycle_worked = True
        eng._note_occupancy()
        with eng._phase("decode_dispatch"):
            self._apply_overrides()
            step = self.step_fn
            if eng._use_splitkv_now():
                step = self._split_step()
                eng.metrics.inc("splitkv_steps")
            step.replay()
            nxt, finite, done = step.read_back()
        now = time.perf_counter()
        if self._idle_since is not None:
            # the dispatch pipeline was empty until now: starved time is the
            # overlap-aware host-stall numerator
            eng.metrics.observe("device_starved_s", max(0.0, now - self._idle_since))
            self._idle_since = None
        snap = [(slot, req, req.admit_seq) for slot, req in sorted(eng.sched.active.items())]
        taken, self._pending_lazy = self._pending_lazy, {}
        self.inflight.append(_InFlight(cycle=eng._cycle, nxt=nxt, finite=finite, done=done,
                                       snap=snap, lazy=taken, t0=t0))
        for slot, req, _seq in snap:
            self._dispatch_pos[slot] = self._dispatch_pos.get(slot, req.pos) + 1
        self.dispatched += 1
        self.last_progress = now
        return True

    def _split_step(self) -> CapturedDecodeStep:
        """The split-KV decode step (JAX's ``_splitkv_step``), captured at its
        first use over the same state and token buffers."""
        if self._split_fn is None:
            eng = self.eng
            self._split_fn = CapturedDecodeStep(
                eng.model, eng.params, eng.state, impl=eng._impl, quant_impl=eng._quant_impl,
                splitkv=eng._splitkv_ctx, share=self.step_fn)
        return self._split_fn

    def _drain_progress(self) -> bool:
        """Nothing to dispatch: consume one in-flight record if any."""
        if self.inflight:
            self._consume_one()
            return True
        return False

    def _frontier_pos(self, req) -> int:
        return self._dispatch_pos.get(req.slot, req.pos)

    def _register_admissions(self, lazy: dict) -> None:
        """Set up dispatch-frontier mirrors for slots admitted this cycle:
        the dispatch position starts at the prompt length and the feed plan
        holds every host-known feed the slot consumes before switching to
        the device next-token chain: the whole teacher-forced replay stream
        plus the parked token for a rematerialising victim, the parked token
        alone for a pre-decode preemptee, the lazy device first otherwise."""
        eng = self.eng
        for slot, req in eng.sched.active.items():
            if slot in self._dispatch_pos:
                continue
            self._dispatch_pos[slot] = req.pos
            plan: deque = deque()
            if req.replay_left > 0:
                plan.extend(req.out_tokens)
                plan.append(req.pending_token)
            elif slot in lazy:
                first, row = lazy[slot]
                entry = (first, row, req.admit_seq)
                self._lazy_first[slot] = entry
                self._pending_lazy[slot] = entry
                plan.append(_LAZY)
            else:
                plan.append(int(eng.tokens[slot, 0]))
            self._feed_plan[slot] = plan

    def _apply_overrides(self) -> None:
        """Fold this dispatch's feed overrides into the step's token buffer,
        queued on the stream before the replay: one entry pops off each
        planned slot's feed queue.  Host-known values merge in one masked
        select (-1: keep the device feed); unresolved admission firsts are
        index-copied device to device from their prefill's argmax."""
        eng = self.eng
        toks = self.step_fn.tokens
        host_vals = np.full((eng.slots,), -1, np.int32)
        groups: dict[int, tuple] = {}  # id(first) -> (first, [(slot, row)])
        for slot in list(self._feed_plan):
            if eng.sched.active.get(slot) is None:
                continue
            plan = self._feed_plan[slot]
            if not plan:
                self._feed_plan.pop(slot, None)
                continue
            val = plan.popleft()
            if not plan:
                self._feed_plan.pop(slot, None)
            if val is _LAZY:
                entry = self._lazy_first.get(slot)
                if entry is None:
                    continue
                first, row, _seq = entry
                groups.setdefault(id(first), (first, []))[1].append((slot, row))
            else:
                host_vals[slot] = int(val)
        if (host_vals >= 0).any():
            vals = upload(host_vals, toks.device)[:, None]
            toks.copy_(torch.where(vals >= 0, vals, toks))
        for first, pairs in groups.values():
            idx = upload(np.asarray(pairs, np.int64).T, toks.device)  # [2, n]: slots, rows
            toks.index_copy_(0, idx[0], first.dev.index_select(0, idx[1]).to(toks.dtype)[:, None])

    # -------------------------------------------------- consumption side

    def _consume_one(self) -> None:
        """Consume the oldest in-flight step: wait on its event (the async
        runtime's only sync, attributed to ``device_wait``), then the sync
        engine's own per-slot advance body against the dispatch-time
        snapshot.  Snapshot entries whose slot was retired or preempted
        since dispatch are discarded: their results belong to a request that
        already left."""
        eng = self.eng
        rec = self.inflight.popleft()
        with eng._phase("device_wait"):
            if rec.done is not None:
                rec.done.synchronize()
            nxt = rec.nxt.numpy()
            finite = rec.finite.numpy()
            for slot, (first, row, seq) in rec.lazy.items():
                req = eng.sched.active.get(slot)
                if req is not None and req.admit_seq == seq:
                    eng.tokens[slot, 0] = first.value(row)
                cur = self._lazy_first.get(slot)
                if cur is not None and cur[2] == seq:
                    self._lazy_first.pop(slot, None)
        if not self.inflight:
            self._idle_since = time.perf_counter()
        now = time.perf_counter()
        dt = now - rec.t0  # pipeline latency of this token
        with eng._phase("advance"):
            for slot, req, seq in rec.snap:
                cur = eng.sched.active.get(slot)
                if cur is not req or req.admit_seq != seq:
                    eng.metrics.inc("discarded_steps")
                    continue
                poisoned = eng.faults is not None and eng.faults.fires(
                    "poison_logits", cycle=rec.cycle, uid=req.uid,
                    progress=len(req.out_tokens))
                bad = ("non-finite logits row"
                       if eng.guard_logits and (poisoned or not bool(finite[slot])) else None)
                eng._advance_one(slot, req, int(nxt[slot]), bad, dt, now, cycle=rec.cycle)
            eng.metrics.inc("steps")
        self.last_progress = now
        if eng.audit_every and rec.cycle % eng.audit_every == 0:
            eng.audit().raise_if_violations()
