"""Paged continuous-batching serving engine, synchronous cycle: the port of
the JAX package's ``serve/engine.py``.

The engine composes the serving pieces into one cycle (:meth:`ServeEngine.step`):

1. admit waiting requests into free slots (:class:`~.scheduler.Scheduler`:
   strict FIFO, gated on a free slot and on the page pool's commitment
   budget); prefill them in suffix-length buckets, each right-padded to its
   bucket, the shared leading blocks of a prompt (prefix index) read from
   the pools as a dequantized prior (``model.prefill(prior=...)``); a
   prefill with no prior runs the flash-prefill kernel on the card; adopt
   the prefilled blocks into freshly allocated pages behind the shared ones
   (``pages.adopt_prefill``);
2. allocate the destination page of every row whose residual fills on this
   step; a destination that holds a page with refcount > 1 (a speculative
   shared tail) is copied on write first (``qcache.copy_pages``);
3. push the page table if it changed, then run one batched decode step over
   all slots: ``self._step(params, state, tokens)``, the model's
   ``decode_step`` with the engine's ``impl``/``quant_impl``, through the
   page table on the paged kernels (``kernels/paged_bitdecode`` and the
   paged residual flush);
4. read the logits once (the cycle's one device sync), advance per-token
   accounting, retire finished requests.

``spec_k > 1`` replaces steps 3 and 4 with a self-speculative cycle
(:meth:`ServeEngine._step_spec_once`, :mod:`repro_torch.serve.speculative`): a
draft pass proposes ``spec_k - 1`` tokens a row against the ``spec_bits``
read of the same pools, one verify pass runs all ``spec_k`` feeds at full
fidelity, and the host keeps the longest prefix the verify argmax agrees
with.  On the card each pass is one replay of a captured CUDA graph; the
cycle's two host syncs are the two read-backs.  The streams equal
``spec_k = 1`` bit for bit.

``async_runtime=True`` replaces this stop-the-world cycle with the
overlapped runtime (:mod:`repro_torch.serve.async_runtime`): each decode
step is one replay of a captured CUDA graph, the next token is taken on the
card and fed back there, the host consumes a step's results up to
``async_window`` steps behind its dispatch, and finished requests go to a
background completion thread.  Its token streams equal this cycle's bit for
bit; the sync cycle stays eager and is the oracle.

Idle slots decode garbage into their own scratch pages (their table rows
point there): wasted lanes, never corruption.

Pressure: under ``reserve_policy="expected"`` a request that outlives its
reservation extends it one page at a time and, when the pool is full,
**preempts** a victim, which re-prefills its prompt on re-admission and
replays its decoded tokens teacher-forced through the decode path, so its
cache, and every later token, is rebuilt bit for bit.  Lifecycle guards
(deadlines, :meth:`ServeEngine.cancel`, a poisoned logits row retiring only
its request), the invariant auditor (``audit_every``), seeded faults
(``faults``) and telemetry (metrics registry, per-phase timers,
``trace=True`` for the Chrome-trace event log) work as in the JAX engine.

What the port adds: one prefill call per (suffix bucket, prior width)
instead of per suffix bucket, so that a request's prefill has the same
shapes whichever requests it is admitted with.  On the card cuBLAS picks a
matrix product's kernel by shape, and a row's result is then a function of
that row alone: a preempted request rebuilds its prefill bit for bit.

Families (``model.paged_spec()``, ``models/family.py``): split K/V
attention, the MLA latent (``shared_kv``) pools, and the Mamba2 hybrid,
whose Mamba2 states are per-slot ``side_state`` spliced in place at
admission (:meth:`ServeEngine._splice_side_state`) and whose prompts
prefill in groups of one exact length (``exact_prefill``: no lengths, no
right-padding, no prefix sharing).

**The exact-length shim** (``paged=False``, and every family whose spec is
not paged: the recurrent xLSTM family): no pool, no page table, the model's
dense decode state (``model.init_decode_state``), and the same scheduler
without a pool, grouping by exact length.  Each admitted request prefills
alone at B 1 and its exact length (:meth:`ServeEngine._fill_slot`), and its
state is spliced into its slot in place: the declared side state on its
batch axis, every other tensor (the dense quantized caches stacked
``(L, B, ...)``, ``pos``) on its own.  The decode cycles, the speculative
passes and the async runtime run over that state as over the paged one; for
the attention family they read and append the dense cache through the dense
decode and flush kernels.

A model that declares no cache family (``paged_spec()`` is None: the
encoder-decoder and the VLM stub, whose prefill needs frame or patch
embeddings that a request does not carry) is refused with the JAX engine's
``ValueError``, ``paged=False`` or not; so is ``paged=True`` for a family
that does not page.

**Split-KV across devices** (``mesh``, ``splitkv``, ``page_affine``): the
engine runs SPMD, one copy a rank of the mesh axis ``splitkv_axis``, each on
the same replicated host state (scheduler, page accounting, residuals,
``pack_blocks``); a split-KV decode step (:meth:`ServeEngine._use_splitkv_now`
picks it, ``splitkv_steps`` counts it) walks this rank's window of the
blocks under ``core.attention.use_splitkv`` and merges the ranks' partials
(``dist.splitkv``).  ``page_affine=True`` also splits the pools' pages: the
allocator pins the page of table column ``j`` to shard ``j // nb_local``
(``pages.PagePool(shards=)``), each rank allocates its ``n_pages / n`` pages
alone, and every write into the pools (prefill adoption, copy on write, the
decode step's flush) lands on the rank that holds the page; a suffix
prefill gathers its shared pages from their ranks (``dist.splitkv.
gather_prior_pages``).  The JAX engine keeps its state replicated as well
and ``shard_map``s the walk; it places only the page-affine pools along the
axis, as here.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import qcache
from repro_torch.core.device import resolve_device, upload
from repro_torch.models.family import tensors_at
from repro_torch.serve import pages as pg
from repro_torch.serve.async_runtime import (
    AsyncRunner,
    CompletionWorker,
    DeviceTokens,
    _state_tensors,
)
from repro_torch.serve.audit import audit_engine
from repro_torch.serve.speculative import DraftPass, VerifyPass
from repro_torch.serve.scheduler import (  # noqa: F401 (Phase/Request re-exported)
    Phase,
    Request,
    Scheduler,
    bucket_for,
)
from repro_torch.serve.telemetry import MetricsRegistry, Tracer

#: cycle phases in execution order -> the registry histogram each feeds
PHASE_METRICS = {
    "schedule": "phase_schedule_s",
    "prefill": "phase_prefill_s",
    "decode_dispatch": "phase_decode_dispatch_s",
    "device_wait": "phase_device_wait_s",
    "advance": "phase_advance_s",
}

#: timing-derived ``summary()`` keys: what a determinism comparison strips
TIMING_SUMMARY_KEYS = frozenset({
    "wall_s", "tokens_per_s", "latency_p50_ms", "latency_p99_ms",
    "ttft_p50_ms", "ttft_p99_ms", "tpot_p50_ms", "tpot_p99_ms",
    "queue_wait_p50_ms", "queue_wait_p99_ms", "e2e_p50_ms", "e2e_p99_ms",
    "host_stall_fraction", "phase_s",
})

#: the engine's lifecycle counters (``stats`` and ``summary()`` show them)
STAT_COUNTERS = (
    "decoded_tokens", "steps", "prefill_calls", "splitkv_steps", "prefill_tokens",
    "prefill_tokens_saved", "cow_copies",
    # retirement breakdown (each request counts in at most one):
    # budget_retired = hit max_new_tokens without EOS
    "budget_retired", "preempted", "preempt_remat_tokens",
    "expired", "cancelled", "errored", "audits", "faults_injected",
    # retained pages evicted back to the free list
    "retained_reclaims",
    # async runtime: terminal retirements handed to the completion thread;
    # in-flight decode results consumed after their request left the slot
    "completions_enqueued", "discarded_steps",
    # self-speculative decoding: cycles, and draft tokens proposed,
    # accepted and rejected (drafted = accepted + rejected)
    "spec_cycles", "spec_draft_tokens", "spec_accepted_tokens", "spec_rejected_tokens",
)


def _percentile(xs: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


class _PhaseTimer:
    """Accumulating timer for one named cycle phase; with tracing on, each
    block also emits one complete event on the engine track."""

    __slots__ = ("engine", "name", "t0")

    def __init__(self, engine, name: str):
        self.engine = engine
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        acc = self.engine._phase_acc
        acc[self.name] = acc.get(self.name, 0.0) + dt
        if self.engine.tracer is not None:
            self.engine.tracer.complete(self.name, t0=self.t0, dur_s=dt, cat="engine")
        return False


def splitkv_cores(device) -> int:
    """The parallel-slot target of the split-KV rule: ``REPRO_SPLITKV_CORES``
    if set, else the card's SM count (1 on the CPU).  The JAX package counts
    four cores a device."""
    import os

    from repro_torch.kernels.bitdecode import ops as bd_ops

    env = os.environ.get("REPRO_SPLITKV_CORES")
    return int(env) if env else bd_ops.sm_count(device)


def use_splitkv_rule(splitkv: str, *, page_affine: bool, axis_size: int, active: int,
                     h_kv: int, max_blocks: int, cores: int) -> bool:
    """Whether a decode step with a mesh splits the walk (JAX's
    ``_use_splitkv_now``): always under ``"always"`` or page-affine pools
    (no rank holds every page), never under ``"never"``, and under ``"auto"``
    when the ``active`` rows' KV heads leave ``cores`` unfilled and the
    longest row holds at least two blocks a rank."""
    if splitkv == "never":
        return False
    if splitkv == "always" or page_affine:
        return True
    if axis_size <= 1:
        return False
    return active * h_kv < cores and max_blocks >= 2 * axis_size


class ServeEngine:
    def __init__(self, model, params, *, slots: int = 8, max_seq: int = 2048,
                 eos_id: int | None = None, impl: str = "auto",
                 quant_impl: str = "auto", paged: bool | None = None,
                 n_pages: int | None = None, min_bucket: int = 16,
                 mesh=None, splitkv_axis: str = "data", splitkv: str = "auto",
                 share_prefix: bool = True,
                 spec_tail: bool = True, retain_prefix: bool = False,
                 page_affine: bool = False, reserve_policy: str = "worst_case",
                 expected_quantile: float = 0.5, preempt_policy: str = "youngest",
                 audit_every: int = 0, faults=None, strict: bool = False,
                 guard_logits: bool = True, clock=None, spec_k: int = 1,
                 spec_bits: int | None = None, trace: bool | Tracer = False,
                 metrics: MetricsRegistry | None = None, metrics_every: int = 0,
                 metrics_sink=None, async_runtime: bool = False, async_window: int = 2,
                 completion_queue: int = 64, watchdog_s: float = 30.0,
                 detokenizer=None, on_complete=None, device=None):
        """The options are the JAX engine's (see its docstring): ``n_pages``
        bounds the pool (default: full provisioning, ``slots * nb_max`` plus
        the scratch pages), ``share_prefix``/``spec_tail``/``retain_prefix``
        drive prefix sharing, ``reserve_policy``/``expected_quantile``/
        ``preempt_policy`` the pressure handling, ``audit_every``/``faults``/
        ``clock`` the self-checks and guards (``strict=True``: a submission
        that can never be admitted raises instead of retiring REJECTED;
        ``guard_logits=False``: no per-row poisoned-step isolation),
        ``trace``/``metrics`` telemetry (``metrics_every=N``: a registry
        snapshot every N cycles to ``metrics_sink``, a callable, or printed
        as the Prometheus text exposition when it is None).
        ``spec_k > 1`` decodes up to ``spec_k`` tokens a cycle by
        self-speculation (module docstring), drafting against the
        ``spec_bits`` read (default ``min(2, kv_bits)``, within
        ``[1, kv_bits]``).
        ``async_runtime`` runs the overlapped runtime (module docstring) with
        at most ``async_window`` decode steps in flight; ``completion_queue``
        bounds the completion thread's queue, ``watchdog_s`` every blocking
        wait of the runtime (``async_runtime.DeadlockError``), and
        ``detokenizer`` (tokens -> text) and ``on_complete`` (called with
        each ``CompletionRecord``) run on that thread.  With ``spec_k > 1``
        the speculative cycle runs unoverlapped (it syncs twice for up to
        ``spec_k`` tokens) and completions still go to the thread.
        ``impl`` picks the prefill and decode attention kernels (a suffix
        prefill over a shared prefix stays plain PyTorch), ``quant_impl`` the
        quantize and flush kernels ('auto' | 'cuda' | 'torch').  ``device``:
        where the state lives (the card unless given).  ``paged=None``
        follows the model's spec, ``paged=False`` forces the exact-length
        shim (module docstring), ``paged=True`` raises for a family that
        does not page.  ``mesh`` (a ``DeviceMesh``) and ``splitkv_axis``
        attach the split-KV decode step across the ranks of that axis,
        ``splitkv`` ('auto' | 'always' | 'never') picks when it runs, and
        ``page_affine`` splits the pools' pages along the axis (module
        docstring); every rank runs the same engine on the same requests."""
        spec = model.paged_spec() if hasattr(model, "paged_spec") else None
        if spec is None:  # the JAX engine's refusal, before any other
            raise ValueError("model declares no serveable cache family (paged_spec() is "
                             "None): its prefill needs inputs beyond tokens")
        if paged and not spec.paged:
            raise ValueError("model declares no paged decode capability "
                             "(see repro_torch.models.family.PagedSpec)")
        if preempt_policy not in ("youngest", "fewest_pages"):
            raise ValueError(f"unknown preempt_policy {preempt_policy!r}")
        self.model = model
        self.params = params
        self.spec = spec
        self.paged = spec.paged if paged is None else bool(paged)
        self.slots = slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.preempt_policy = preempt_policy
        self.audit_every = audit_every
        self.faults = faults
        self.guard_logits = guard_logits
        self.clock = clock if clock is not None else time.monotonic
        self.device = resolve_device(device)
        self._cycle = 0
        cfg = model.cfg

        # --- telemetry ---------------------------------------------------
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = trace if isinstance(trace, Tracer) else (Tracer() if trace else None)
        self.metrics_every = int(metrics_every)
        self.metrics_sink = metrics_sink
        for name in STAT_COUNTERS:
            self.metrics.counter(name)
        # device_starved_s: async runtime, wall time the dispatch pipeline sat
        # empty while work remained (the overlap-aware host-stall numerator)
        for hist in (*PHASE_METRICS.values(), "cycle_s", "device_idle_gap_s", "ttft_s",
                     "tpot_s", "queue_wait_s", "e2e_latency_s", "device_starved_s"):
            self.metrics.histogram(hist)
        self._phase_acc: dict[str, float] = {}
        self._cycle_worked = False
        self._work_t0: float | None = None
        self._work_t1: float | None = None
        self._ttft_s: list[float] = []
        self._tpot_s: list[float] = []
        self._queue_wait_s: list[float] = []
        self._e2e_s: list[float] = []
        if faults is not None and getattr(faults, "on_fire", None) is None:
            faults.on_fire = self._on_fault
        # delayed-release fault parking lot: (ready_cycle, uid, pages)
        self._deferred: list[tuple[int, int, list[int]]] = []

        self.block_n = spec.block_n
        # self-speculative decoding: the passes are built over the state below
        self.spec_k = int(spec_k)
        if self.spec_k < 1:
            raise ValueError(f"spec_k={spec_k} must be >= 1")
        self.spec_bits = int(spec_bits) if spec_bits is not None else min(2, cfg.kv_bits)
        if not 1 <= self.spec_bits <= cfg.kv_bits:
            raise ValueError(f"spec_bits={self.spec_bits} outside [1, kv_bits={cfg.kv_bits}]")
        self._impl, self._quant_impl = impl, quant_impl
        # the decode step: a plain callable over (params, state, tokens), the
        # counterpart of the JAX engine's jitted lambda; it updates the
        # state's caches in place
        self._step = lambda p, s, t: model.decode_step(p, s, t, impl=impl,
                                                       quant_impl=quant_impl)
        # the split-KV decode step: the same step under use_splitkv
        self.mesh, self.splitkv_axis, self.splitkv = mesh, splitkv_axis, splitkv
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if mesh is not None and splitkv_axis not in names:
            raise ValueError(f"mesh has no axis {splitkv_axis!r}; available: {names}")
        self.page_affine = bool(page_affine)
        if self.page_affine and mesh is None:
            raise ValueError("page_affine=True requires a mesh")
        if self.page_affine and not self.paged:
            raise ValueError("page_affine=True requires a paged family")
        if self.page_affine and splitkv == "never":
            raise ValueError("page_affine=True needs the sharded split-KV walk "
                             "(splitkv='auto' or 'always')")
        self._axis_size = self._axis_rank = 1
        if mesh is not None:
            self._axis_size = mesh.size(names.index(splitkv_axis))
            self._axis_rank = mesh.get_local_rank(splitkv_axis)
        self._splitkv_ctx = self._step_splitkv = None
        if mesh is not None and splitkv != "never":
            from repro_torch.core.attention import use_splitkv

            self._splitkv_ctx = use_splitkv(mesh, splitkv_axis, page_affine=self.page_affine)
            self._splitkv_cores = splitkv_cores(self.device)

            def split_step(p, s, t):
                with self._splitkv_ctx:
                    return model.decode_step(p, s, t, impl=impl, quant_impl=quant_impl)

            self._step_splitkv = split_step
        self._pool_shards = self._axis_size if self.page_affine else 1
        self.tokens = np.zeros((slots, 1), np.int32)
        self._occupancy: list[float] = []

        if self.paged:
            self._init_paged(n_pages, share_prefix, spec_tail, retain_prefix, min_bucket,
                             reserve_policy, expected_quantile, strict)
        else:  # the exact-length shim: the dense state, no pool
            self.pool = None
            self.retain_prefix = False
            self.sched = Scheduler(slots=slots, pool=None, block_n=self.block_n,
                                   max_seq=max_seq, share_prefix=False, spec_tail=False,
                                   exact_buckets=True, strict=strict, clock=self.clock,
                                   metrics=self.metrics)
            self.state = model.init_decode_state(slots, max_seq, device=self.device)

        # --- the speculative passes and the async runtime capture their
        # graphs over the state above, so they come last
        self._draft = self._verify = None
        if self.spec_k > 1:
            # the passes read the pools unsplit, as in the JAX engine, except
            # page-affine ones, which no rank holds whole: they walk split
            ctx = self._splitkv_ctx if self.page_affine else None
            self._draft = DraftPass(model, params, self.state, spec, spec_k=self.spec_k,
                                    spec_bits=self.spec_bits, impl=impl, quant_impl=quant_impl,
                                    splitkv=ctx)
            self._verify = VerifyPass(model, params, self.state, spec, spec_k=self.spec_k,
                                      impl=impl, quant_impl=quant_impl, splitkv=ctx)
        self.async_runtime = bool(async_runtime)
        self._runner = None
        self._completions = None
        if self.async_runtime:
            self._completions = CompletionWorker(queue_size=completion_queue,
                                                 watchdog_s=watchdog_s, detokenizer=detokenizer,
                                                 on_complete=on_complete)
            if self.spec_k == 1:
                self._runner = AsyncRunner(self, window=async_window, watchdog_s=watchdog_s)

    def _init_paged(self, n_pages, share_prefix, spec_tail, retain_prefix, min_bucket,
                    reserve_policy, expected_quantile, strict) -> None:
        """The paged engine's state, page pool, scheduler and host page
        table."""
        spec, slots, max_seq, cfg = self.spec, self.slots, self.max_seq, self.model.cfg
        nb_max = -(-max_seq // self.block_n)
        n = self._axis_size
        self.nb_max = -(-nb_max // n) * n  # every rank's window of the table equally wide
        shards = self._pool_shards
        self._nb_local = self.nb_max // shards
        # full provisioning; page-affine adds one slot-page a shard so shard
        # 0's scratch range does not eat into its allocatable share
        self.n_pages = (n_pages if n_pages is not None
                        else slots * self.nb_max + slots * shards)
        if self.n_pages % shards:
            raise ValueError(f"page_affine needs n_pages ({self.n_pages}) divisible by the "
                             f"{self.splitkv_axis!r} axis size ({shards})")
        # page-affine: this rank allocates its page range alone
        self.state = self.model.init_paged_decode_state(
            slots, n_pages=self.n_pages // shards, nb_max=self.nb_max, device=self.device)
        if self.page_affine:
            lo = self._axis_rank * (self.n_pages // shards)
            self.state["caches"] = [dataclasses.replace(c, page_lo=lo, pages_total=self.n_pages)
                                    for c in self.state["caches"]]
        first = self.state["caches"][0]
        # a shared_kv (latent) pool has no V side: its V width is the declared one
        d_v = spec.d_v if first.vw is None else first.vw.shape[-1]
        if (first.kw.shape[-1] != spec.d_k or d_v != spec.d_v
                or bool(first.shared_kv) != bool(spec.shared_kv)):
            raise ValueError(
                "paged_spec() disagrees with init_paged_decode_state: declared "
                f"(d_k={spec.d_k}, d_v={spec.d_v}, shared_kv={spec.shared_kv}) vs allocated "
                f"(d_k={first.kw.shape[-1]}, d_v={d_v}, shared_kv={first.shared_kv})")
        # one page across every paged layer, measured from the pools
        self.kv_page_bytes = sum(
            getattr(pc, f).numel() * getattr(pc, f).element_size()
            for pc in self.state["caches"] for f in qcache._PAGED_POOL_FIELDS
            if getattr(pc, f) is not None
        ) // first.n_pages
        self.pool = pg.PagePool(self.n_pages, n_scratch=slots, page_bytes=self.kv_page_bytes,
                                metrics=self.metrics, shards=shards)
        share = share_prefix and spec.supports_prior
        self.retain_prefix = retain_prefix and share
        self.sched = Scheduler(
            slots=slots, pool=self.pool, block_n=self.block_n, max_seq=max_seq,
            min_bucket=min_bucket, share_prefix=share, spec_tail=spec_tail and share,
            retain_prefix=self.retain_prefix, exact_buckets=spec.exact_prefill,
            reserve_policy=reserve_policy,
            expected_quantile=expected_quantile, strict=strict, clock=self.clock,
            metrics=self.metrics,
            namespace=f"{cfg.name}/b{cfg.kv_bits}/n{self.block_n}/{cfg.kv_gran}",
        )
        # host mirror of the device page table; unassigned entries point at
        # the slot's scratch page (flush-destination injectivity)
        self._table = np.broadcast_to(
            np.arange(slots, dtype=np.int32)[:, None], (slots, self.nb_max)).copy()
        self._table_dirty = False

    # ------------------------------------------------------------ public

    @property
    def stats(self) -> dict:
        """Lifecycle counters as a plain dict (a view of the registry)."""
        return {k: int(self.metrics.value(k)) for k in STAT_COUNTERS}

    def _phase(self, name: str) -> _PhaseTimer:
        return _PhaseTimer(self, name)

    def _on_fault(self, site: str, cycle: int, uid) -> None:
        """``FaultPlan.on_fire`` hook: count and trace every injected fault."""
        self.metrics.inc("faults_injected")
        if self.tracer is not None:
            self.tracer.instant("fault", args={"site": site, "cycle": cycle, "uid": uid})

    def submit(self, req: Request) -> bool:
        """Queue ``req``; False when it was retired REJECTED at submission
        (``req.error`` names the reason)."""
        ok = self.sched.submit(req)
        if self.tracer is not None:
            if ok:
                self.tracer.begin("queue", uid=req.uid, cat="request")
            else:
                self.tracer.instant("rejected", uid=req.uid, cat="request")
        return ok

    def cancel(self, uid: int) -> Request | None:
        """Cancel a waiting or active request by uid; returns the retired
        request (CANCELLED, resources released, table row reset) or None."""
        for req in list(self.sched.waiting):
            if req.uid == uid:
                self.sched.waiting.remove(req)
                self._retire(req, Phase.CANCELLED, reason="cancelled")
                return req
        for req in list(self.sched.active.values()):
            if req.uid == uid:
                self._retire(req, Phase.CANCELLED, reason="cancelled")
                return req
        return None

    def audit(self):
        """Run the invariant auditor now."""
        self.metrics.inc("audits")
        report = audit_engine(self)
        if self.tracer is not None:
            self.tracer.instant("audit", args={"violations": len(report.violations)})
        return report

    def run(self, max_cycles: int = 10_000):
        t0 = time.perf_counter()
        cycles = 0
        while self._has_work() and cycles < max_cycles:
            self.step()
            cycles += 1
            if self._runner is not None:
                self._runner.check_liveness()
        if self._completions is not None:
            # every enqueued completion processed before the drain audit
            self._completions.drain()
        if self.audit_every:
            self.audit().raise_if_violations()  # clean at drain
        return self.summary(wall_s=time.perf_counter() - t0)

    def close(self) -> None:
        """Stop the background completion thread (async runtime); idempotent
        and a no-op for the synchronous engine."""
        if self._completions is not None:
            self._completions.close()

    def summary(self, *, wall_s: float | None = None) -> dict:
        """Engine statistics.  ``wall_s`` defaults to the first-work to
        last-work window of the cycles run so far."""
        if wall_s is None:
            if self._work_t0 is not None and self._work_t1 is not None:
                wall_s = self._work_t1 - self._work_t0
            else:
                wall_s = 0.0
        stats = self.stats
        cycle_total = self.metrics.histogram("cycle_s").total
        wait_total = self.metrics.histogram("phase_device_wait_s").total
        lat = self._tpot_s if self._tpot_s else self._ttft_s
        sched = self.sched.stats
        out = {
            **stats,
            "wall_s": wall_s,
            "tokens_per_s": stats["decoded_tokens"] / wall_s if wall_s > 0 else 0.0,
            **{f"sched_{k}": v for k, v in sched.items()},
            "latency_p50_ms": 1e3 * _percentile(lat, 50),
            "latency_p99_ms": 1e3 * _percentile(lat, 99),
            "ttft_p50_ms": 1e3 * _percentile(self._ttft_s, 50),
            "ttft_p99_ms": 1e3 * _percentile(self._ttft_s, 99),
            "tpot_p50_ms": 1e3 * _percentile(self._tpot_s, 50),
            "tpot_p99_ms": 1e3 * _percentile(self._tpot_s, 99),
            "queue_wait_p50_ms": 1e3 * _percentile(self._queue_wait_s, 50),
            "queue_wait_p99_ms": 1e3 * _percentile(self._queue_wait_s, 99),
            "e2e_p50_ms": 1e3 * _percentile(self._e2e_s, 50),
            "e2e_p99_ms": 1e3 * _percentile(self._e2e_s, 99),
            # share of cycle time the host was not waiting on the device
            "host_stall_fraction": (1.0 - min(1.0, wait_total / cycle_total)
                                    if cycle_total > 0 else 0.0),
            "phase_s": {**{name: self.metrics.histogram(h).total
                           for name, h in PHASE_METRICS.items()},
                        "cycle": cycle_total},
        }
        if self.paged:  # the pool's accounting (the shim has no pool)
            out.update({
                "occupancy_mean": float(np.mean(self._occupancy)) if self._occupancy else 0.0,
                "occupancy_max": float(np.max(self._occupancy)) if self._occupancy else 0.0,
                "kv_page_bytes": self.kv_page_bytes,
                "kv_bytes_in_use": self.pool.bytes_in_use,
                "kv_page_layers": self.spec.page_layers,
                "pages_per_token": self.spec.pages_per_token,
                "prefix_hit_rate": (sched["prefix_hit_blocks"]
                                    / max(1, sched["prefix_lookup_blocks"])),
                "pool_pages_retained": self.pool.n_retained,
                "pool_shards": self._pool_shards,
            })
        if self.spec_k > 1:
            out["spec_accept_rate"] = (stats["spec_accepted_tokens"]
                                       / max(1, stats["spec_draft_tokens"]))
        if self._runner is not None and self._runner.dispatched > 0:
            # overlap-aware: the share of cycle time the dispatch pipeline sat
            # empty; under overlap, host work no longer means an idle device
            starved = self.metrics.histogram("device_starved_s").total
            out["host_stall_fraction"] = (min(1.0, starved / cycle_total)
                                          if cycle_total > 0 else 0.0)
        return out

    def _has_work(self) -> bool:
        return (self.sched.has_work or bool(self._deferred)
                or (self._runner is not None and self._runner.pending))

    # ------------------------------------------------ the one decode cycle

    def step(self) -> bool:
        if self._runner is not None:
            return self._runner.step()
        t0 = time.perf_counter()
        self._cycle += 1
        self._cycle_worked = False
        try:
            with torch.no_grad():
                if self.spec_k > 1:
                    return self._step_spec_once(t0)
                return self._step_once(t0)
        finally:
            self._finish_cycle(t0)

    def _schedule_and_admit(self) -> bool:
        """The cycle's skeleton before its decode: deferred releases,
        expiry, the forced-preempt and evict-storm faults (paged only),
        admission and prefill.  Returns whether any request is active."""
        self._lifecycle()
        if self.paged:
            self._admit_and_prefill()
        else:
            self._admit_exact()
        return bool(self.sched.active)

    def _lifecycle(self) -> None:
        """Deferred releases, expiry and the pool's faults (forced preempt,
        evict storm: paged only), the sync and async cycles' common start."""
        with self._phase("schedule"):
            self._service_deferred()
            self._expire()
            if not self.paged or self.faults is None:
                return
            if self.faults.fires("forced_preempt", cycle=self._cycle):
                victim = self._pick_victim()
                if victim is not None:
                    self._preempt(victim)
            if self.faults.fires("evict_storm", cycle=self._cycle):
                self.pool.reclaim_retained(self.faults.storm_pages)

    def _step_once(self, t0: float) -> bool:
        if not self._schedule_and_admit():
            return False
        if self.paged:
            with self._phase("schedule"):
                self._ensure_flush_pages()
                self._push_table()
            if not self.sched.active:  # everyone self-preempted under faults
                return False

        step = self._step
        if self._use_splitkv_now():
            step = self._step_splitkv
            self.metrics.inc("splitkv_steps")
        self._cycle_worked = True
        with self._phase("decode_dispatch"):
            tokens = torch.from_numpy(self.tokens).to(self.device)
            logits, self.state = step(self.params, self.state, tokens)
        # the cycle's one device sync: reading the logits separates waiting
        # on the device from the host work around it
        with self._phase("device_wait"):
            rows = logits[:, 0].float().cpu().numpy()
        with self._phase("advance"):
            if self.faults is not None:
                for slot, req in list(self.sched.active.items()):
                    if self.faults.fires("poison_logits", cycle=self._cycle, uid=req.uid,
                                         progress=len(req.out_tokens)):
                        rows[slot] = np.nan
            nxt = np.argmax(rows, axis=-1)
            # a poisoned row retires its request alone
            bad: dict[int, str] = {}
            if self.guard_logits:
                finite = np.isfinite(rows).all(axis=-1)
                for slot in self.sched.active:
                    if not finite[slot]:
                        bad[slot] = "non-finite logits row"
                    elif not 0 <= int(nxt[slot]) < rows.shape[-1]:
                        bad[slot] = f"invalid next token id {int(nxt[slot])}"
            self.metrics.inc("steps")
            self._note_occupancy()
            self._advance(nxt, time.perf_counter() - t0, bad=bad)
        if self.audit_every and self._cycle % self.audit_every == 0:
            self.audit().raise_if_violations()
        return True

    def _push_table(self) -> None:
        """Push the host page table to the device if it changed."""
        if self.sched.active and self._table_dirty:
            pg.set_page_tables(self.state["caches"], self._table)
            self._table_dirty = False

    def _note_occupancy(self) -> None:
        """The pool's occupancy at the cycle peak (after admission, before
        release); the shim has no pool."""
        if self.paged:
            self._occupancy.append(self.pool.occupancy)

    def _finish_cycle(self, t0: float) -> None:
        """Cycle-boundary bookkeeping: fold the phase timers into the
        registry, derive the device-idle gap, advance the work window, and
        serve the periodic metrics sink."""
        now = time.perf_counter()
        cycle_s = now - t0
        acc, self._phase_acc = self._phase_acc, {}
        m = self.metrics
        m.observe("cycle_s", cycle_s)
        for name, hist in PHASE_METRICS.items():
            if name in acc:
                m.observe(hist, acc[name])
        busy = acc.get("device_wait", 0.0) + acc.get("prefill", 0.0)
        m.observe("device_idle_gap_s", max(0.0, cycle_s - busy))
        if self._cycle_worked:
            if self._work_t0 is None:
                self._work_t0 = t0
            self._work_t1 = now
        if self.tracer is not None:
            self.tracer.complete("cycle", t0=t0, dur_s=cycle_s, cat="engine",
                                 args={"cycle": self._cycle})
        if self.metrics_every and self._cycle % self.metrics_every == 0:
            if self.metrics_sink is not None:
                self.metrics_sink(m.snapshot())
            else:
                print(m.to_prometheus(), end="")

    # ------------------------------------------- the speculative decode cycle

    def _step_spec_once(self, t0: float) -> bool:
        """One self-speculative cycle (``spec_k > 1``): the skeleton of the
        sync cycle, then

        1. the ``[slots, spec_k]`` feed matrix: column 0 is each row's
           committed token; a replay row takes its recorded stream (teacher
           forcing, accepted whatever the verify argmax), a decoding row
           leaves room for its drafts;
        2. every flush destination the cycle can reach
           (``_ensure_flush_pages`` with each row's feed count as its
           lookahead; copy on write and preemption as in the sync cycle);
        3. the draft pass (one graph replay on the card), its tokens read
           back: the cycle's first host sync;
        4. the verify pass (one graph replay) over every feed, written into
           the engine's state, its results read back: the second sync;
        5. :meth:`_advance_spec`: the longest accepted prefix, token by token
           with the sequential EOS, budget and poisoned-row semantics."""
        if not self._schedule_and_admit():
            return False
        k = self.spec_k
        feeds = np.zeros((self.slots, k), np.int32)
        limit = np.zeros((self.slots,), np.int32)
        forced = np.zeros((self.slots,), bool)
        with self._phase("schedule"):
            lookahead: dict[int, int] = {}
            for slot, req in self.sched.active.items():
                feeds[slot, 0] = self.tokens[slot, 0]
                if req.replay_left > 0:
                    n = min(k, req.replay_left)
                    start = len(req.out_tokens) - req.replay_left
                    feeds[slot, 1:n] = req.out_tokens[start + 1:start + n]
                    limit[slot] = n
                    forced[slot] = True
                else:
                    limit[slot] = min(k, req.max_new_tokens - len(req.out_tokens))
                lookahead[slot] = int(limit[slot])
            if self.paged:
                self._ensure_flush_pages(lookahead=lookahead)
                for slot in range(self.slots):
                    if self.sched.active.get(slot) is None:
                        limit[slot] = 0  # preempted while allocating: feeds nothing
                self._push_table()
        if not self.sched.active:  # everyone self-preempted under faults
            return False

        self._cycle_worked = True
        dev = self.device
        if any(limit[s] > 1 and not forced[s] for s in self.sched.active):
            with self._phase("decode_dispatch"):
                self._draft.tok0.copy_(upload(feeds[:, 0], dev))
                self._draft.replay()
            with self._phase("device_wait"):
                drafts = self._draft.drafts.cpu().numpy()
            if self.tracer is not None:
                self.tracer.instant("spec_draft", args={"cycle": self._cycle})
            for slot in self.sched.active:
                n = int(limit[slot])
                if not forced[slot] and n > 1:
                    feeds[slot, 1:n] = drafts[slot, :n - 1]
        ver = self._verify
        with self._phase("decode_dispatch"):
            ver.feeds.copy_(upload(feeds, dev))
            ver.limit.copy_(upload(limit, dev))
            ver.forced.copy_(upload(forced, dev))
            ver.replay()
        with self._phase("device_wait"):
            v, applied, finite = torch.stack(
                (ver.v, ver.applied.to(torch.int32), ver.finite.to(torch.int32))).cpu().numpy()
        with self._phase("advance"):
            poison: set[int] = set()
            if self.faults is not None:
                for slot, req in list(self.sched.active.items()):
                    if self.faults.fires("poison_logits", cycle=self._cycle, uid=req.uid,
                                         progress=len(req.out_tokens)):
                        poison.add(slot)
            self.metrics.inc("steps")
            self.metrics.inc("spec_cycles")
            self._note_occupancy()
            self._advance_spec(v, applied.astype(bool), finite.astype(bool), limit,
                               time.perf_counter() - t0, poison)
        if self.audit_every and self._cycle % self.audit_every == 0:
            self.audit().raise_if_violations()
        return True

    def _advance_spec(self, v, applied, finite, limit, dt: float, poison: set[int]) -> None:
        """Per-row accounting of a speculative cycle.  A row with ``n``
        applied feeds ran feed 0 (its committed token) and ``n - 1``
        accepted drafts, each equal to the verify argmax before it; they are
        recorded by ``n`` calls of the sequential cycle's
        :meth:`_advance_one`, the next committed token of each being the
        verify argmax after it, so EOS, the token budget and replay advance
        token by token as ``n`` sequential cycles would.  Emission stops at
        the first non-finite verify row (or an injected poison), which
        retires the request ERRORED after recording the token that produced
        it, as the sequential poisoned step does.  Replay rows ignore the
        logits and count no draft."""
        now = time.perf_counter()
        cyc_drafted = cyc_accepted = 0
        for slot, req in list(self.sched.active.items()):
            n_ap = int(applied[slot].sum())
            if n_ap == 0:
                continue
            n_emit, err = n_ap, None
            if req.replay_left == 0:
                drafted, accepted = max(0, int(limit[slot]) - 1), n_ap - 1
                cyc_drafted += drafted
                cyc_accepted += accepted
                self.metrics.inc("spec_draft_tokens", drafted)
                self.metrics.inc("spec_accepted_tokens", accepted)
                self.metrics.inc("spec_rejected_tokens", drafted - accepted)
                req.spec_accepted += accepted
                req.spec_rejected += drafted - accepted
                if slot in poison:
                    n_emit, err = 1, "non-finite logits row"
                elif self.guard_logits:
                    bad_idx = np.flatnonzero(~finite[slot, :n_ap])
                    if bad_idx.size:
                        n_emit, err = int(bad_idx[0]) + 1, "non-finite logits row"
            for j in range(n_emit):
                self._advance_one(slot, req, int(v[slot, j]),
                                  err if j == n_emit - 1 else None, dt / n_emit, now)
                if self.sched.active.get(slot) is not req:
                    break  # retired
        if self.tracer is not None:
            self.tracer.instant("spec_verify",
                                args={"drafted": cyc_drafted, "accepted": cyc_accepted})

    def _advance(self, nxt: np.ndarray, dt: float, bad: dict[int, str] | None = None) -> None:
        """Per-token accounting: record the decoded token, advance
        ``req.pos``, retire on EOS or the token budget; slots in ``bad``
        retire ERRORED and every other slot advances normally.  A
        rematerializing request (``replay_left > 0``) is teacher-forced: its
        next token is taken from its recorded stream, nothing is re-counted."""
        now = time.perf_counter()
        for slot, req in list(self.sched.active.items()):
            self._advance_one(slot, req, int(nxt[slot]), (bad or {}).get(slot), dt, now)

    def _advance_one(self, slot: int, req: Request, nxt_tok: int, bad: str | None,
                     dt: float, now: float, *, cycle: int | None = None) -> None:
        """One slot's share of :meth:`_advance`, the one per-token body every
        cycle shares: the sync cycle calls it right after its host sync, the
        speculative cycle once a verified feed (:meth:`_advance_spec`), the
        async runtime at the consumption boundary with the step's dispatch
        ``cycle`` (for error attribution)."""
        if req.replay_left > 0:
            req.pos += 1
            req.replay_left -= 1
            if req.replay_left > 0:
                self.tokens[slot, 0] = req.out_tokens[len(req.out_tokens) - req.replay_left]
            else:  # replay complete: resume the parked stream
                self.tokens[slot, 0] = req.pending_token
                req.pending_token = None
                if self.tracer is not None:
                    self.tracer.instant("replay_done", uid=req.uid, cat="request")
            return
        tok = int(self.tokens[slot, 0])
        req.out_tokens.append(tok)
        req.pos += 1
        req.token_latencies_s.append(dt)
        self._observe_token(req, dt, now)
        self.metrics.inc("decoded_tokens")
        if bad is not None:
            step_no = self._cycle if cycle is None else cycle
            self._retire(req, Phase.ERRORED, reason=f"request {req.uid} step {step_no}: {bad}")
            return
        hit_eos = self.eos_id is not None and tok == self.eos_id
        if hit_eos or len(req.out_tokens) >= req.max_new_tokens:
            if not hit_eos:
                self.metrics.inc("budget_retired")
            self._retire(req, Phase.DONE)
        else:
            self.tokens[slot, 0] = int(nxt_tok)

    def _observe_token(self, req: Request, per_tok_s: float, now: float) -> None:
        """TTFT (submission to first token, queue wait included) for a
        request's first token, TPOT (the cycle's time) for every later one."""
        if req.t_first_token_s is None:
            req.t_first_token_s = now
            ttft = (now - req.t_submit_s) if req.t_submit_s is not None else per_tok_s
            self._ttft_s.append(ttft)
            self.metrics.observe("ttft_s", ttft)
        else:
            self._tpot_s.append(per_tok_s)
            self.metrics.observe("tpot_s", per_tok_s)

    # ---------------------------------------- retirement, expiry, preemption

    def _retire(self, req: Request, phase: Phase, reason: str | None = None) -> None:
        """The one retirement path: reset the table row to scratch, honour a
        delayed-release fault, release through the scheduler, count, and
        (async runtime) hand the request to the completion thread."""
        if self._runner is not None and req.slot is not None:
            # lagging in-flight steps of this slot are discarded at consumption
            self._runner.on_slot_cleared(req.slot)
        if self.paged and req.slot is not None:
            self._table[req.slot, :] = req.slot
            self._table_dirty = True
        if (self.faults is not None and req.pages
                and self.faults.fires("delayed_release", cycle=self._cycle, uid=req.uid)):
            self._deferred.append((self._cycle + self.faults.delay_cycles, req.uid,
                                   list(req.pages)))
            req.pages = []  # the scheduler releases reservation + slot only
        self.sched.retire(req, phase, reason=reason)
        stat = {Phase.EXPIRED: "expired", Phase.CANCELLED: "cancelled",
                Phase.ERRORED: "errored"}.get(phase)
        if stat is not None:
            self.metrics.inc(stat)
        if phase is Phase.DONE and req.t_submit_s is not None:
            e2e = time.perf_counter() - req.t_submit_s
            self._e2e_s.append(e2e)
            self.metrics.observe("e2e_latency_s", e2e)
        if self.tracer is not None:
            self.tracer.end_open(uid=req.uid, cat="request")
            self.tracer.instant(phase.value, uid=req.uid, cat="request",
                                args={"reason": reason} if reason is not None else None)
        if self._completions is not None:
            self.metrics.inc("completions_enqueued")
            self._completions.put(req)

    def _service_deferred(self) -> None:
        """Free pages whose injected release delay has elapsed."""
        if not self._deferred:
            return
        due = [d for d in self._deferred if d[0] <= self._cycle]
        self._deferred = [d for d in self._deferred if d[0] > self._cycle]
        for _ready, uid, pages in due:
            for page in pages:
                self.pool.free(page, owner=uid)

    def _expire(self) -> None:
        """Retire every live request whose ``deadline_s`` has passed."""
        for req in self.sched.expired(self.clock()):
            if req.phase == Phase.WAITING:
                self.sched.waiting.remove(req)
            self._retire(req, Phase.EXPIRED, reason=(
                f"request {req.uid}: deadline_s={req.deadline_s} exceeded before completion"))

    def _pick_victim(self, exclude: Request | None = None) -> Request | None:
        """An active DECODE request admitted in an earlier cycle: the latest
        admission (``youngest``) or the fewest pages, ties to the youngest."""
        cands = [r for r in self.sched.active.values()
                 if r is not exclude and r.phase == Phase.DECODE
                 and r.admit_cycle < self._cycle]
        if not cands:
            return None
        if self.preempt_policy == "fewest_pages":
            return min(cands, key=lambda r: (len(r.pages), -r.admit_seq))
        return max(cands, key=lambda r: r.admit_seq)

    def _preempt(self, req: Request) -> None:
        """Preempt by rematerialization: park the decoded-but-unfed token
        (a victim caught mid-replay keeps its parked one), reset the table
        row and requeue at the FIFO head for re-prefill and replay."""
        slot = req.slot
        if self._runner is not None:
            # a still-lazy admission feed becomes a host value first
            self._runner.on_preempt(req)
        pending = req.pending_token if req.replay_left > 0 else int(self.tokens[slot, 0])
        if self.paged:
            self._table[slot, :] = slot
            self._table_dirty = True
        self.metrics.inc("preempted")
        self.metrics.inc("preempt_remat_tokens", len(req.out_tokens))
        if self.tracer is not None:
            self.tracer.end_open(uid=req.uid, cat="request")
            self.tracer.instant("preempt", uid=req.uid, cat="request",
                                args={"tokens_to_replay": len(req.out_tokens)})
            self.tracer.begin("queue", uid=req.uid, cat="request")
        self.sched.preempt(req, pending_token=pending)

    # ----------------------------------------------------- paged admission

    def _splits_always(self) -> bool:
        """Whether every decode step splits (no unsplit step is needed)."""
        return self.splitkv == "always" or self.page_affine

    def _use_splitkv_now(self) -> bool:
        """Whether this decode step walks split (:func:`use_splitkv_rule` on
        the replicated scheduler state, so every rank decides alike)."""
        if self._step_splitkv is None:
            return False
        active = self.sched.active.values()
        return use_splitkv_rule(
            self.splitkv, page_affine=self.page_affine, axis_size=self._axis_size,
            active=len(self.sched.active), h_kv=self.spec.n_kv_heads,
            max_blocks=max((r.pos // self.block_n for r in active), default=0),
            cores=self._splitkv_cores)

    def _alloc_page(self, req: Request, *, admission: bool = False,
                    block: int | None = None) -> int | None:
        """Pool alloc charged to ``req``.  A request without reservation
        left extends it by one unit, preempting victims while the pool is
        full; with no victim it preempts itself (returns None).  An injected
        ``alloc_fail`` takes the same victim path.  ``block`` (page-affine)
        pins the page to the shard that walks that table column; while the
        shard is dry, victims are preempted until one frees a page there."""
        if self.faults is not None and self.faults.fires("alloc_fail", cycle=self._cycle,
                                                         uid=req.uid):
            victim = self._pick_victim(exclude=req)
            if victim is not None:
                self._preempt(victim)
            elif not admission and req.reserved_pages <= 0:
                self._preempt(req)
                return None
        if req.reserved_pages <= 0:
            while not self.pool.reserve(1, owner=req.uid):
                victim = self._pick_victim(exclude=req)
                if victim is None:
                    self._preempt(req)
                    return None
                self._preempt(victim)
            req.reserved_pages += 1
        shard = None
        if self.page_affine and block is not None:
            shard = block // self._nb_local
            while not self.pool.shard_available(shard):
                victim = self._pick_victim(exclude=req)
                if victim is None:
                    if admission:  # full per-shard provisioning makes this unreachable
                        raise RuntimeError(f"page-affine shard {shard} exhausted at admission "
                                           f"of request {req.uid} with no preemptible victim")
                    self._preempt(req)
                    return None
                self._preempt(victim)
        page = self.pool.alloc(owner=req.uid, shard=shard)
        req.reserved_pages -= 1
        req.pages.append(page)
        return page

    def _admit_and_prefill(self, *, defer_first: bool = False) -> dict:
        """Admit and prefill.  ``defer_first`` (async runtime): the first
        tokens stay on the device; returns slot -> (DeviceTokens, row)."""
        with self._phase("schedule"):
            groups = self.sched.admit()
            if groups:
                self._note_admissions(groups)
        lazy: dict[int, tuple] = {}
        for bucket_len, reqs in groups.items():
            # one call per prior width as well (see the module docstring)
            by_prior: dict[int, list[Request]] = {}
            for req in reqs:
                s = len(req.shared_pages)
                by_prior.setdefault(bucket_for(s, min_bucket=1) if s else 0, []).append(req)
            for part in by_prior.values():
                with self._phase("prefill"):
                    lazy.update(self._prefill_bucket(bucket_len, part, defer_first=defer_first))
        return lazy

    def _note_admissions(self, groups: dict[int, list[Request]]) -> None:
        """Close the queue span, open the prefill span, observe queue wait
        (first admission only)."""
        now = time.perf_counter()
        for reqs in groups.values():
            for req in reqs:
                first_admit = req.t_admit_s is None
                req.t_admit_s = now
                if first_admit and req.t_submit_s is not None:
                    qw = now - req.t_submit_s
                    self._queue_wait_s.append(qw)
                    self.metrics.observe("queue_wait_s", qw)
                if self.tracer is not None:
                    self.tracer.end_open(uid=req.uid, cat="request")
                    self.tracer.begin("prefill", uid=req.uid, cat="request")

    def _prefill(self, toks, lens):
        """A bucket's prefill; an ``exact_prefill`` family's rows all hold
        the bucket's length, and its prefill takes no lengths."""
        lengths = None if self.spec.exact_prefill else lens
        return self.model.prefill(self.params, {"tokens": toks}, toks.shape[1],
                                  lengths=lengths, impl=self._impl,
                                  quant_impl=self._quant_impl)

    def _prefill_shared(self, toks, lens, pages, prior_len):
        """Suffix prefill over the shared prefix, dequantized from the pools
        (page-affine: gathered from the ranks that hold its pages)."""
        fetch = [None] * len(self.state["caches"])
        if self.page_affine:
            from repro_torch.dist.splitkv import gather_prior_pages

            fetch = [gather_prior_pages(c, pages, self.mesh, self.splitkv_axis)
                     for c in self.state["caches"]]
        prior = [qcache.dequant_prior(c, pages, fetch=f)
                 for c, f in zip(self.state["caches"], fetch)]
        return self.model.prefill(self.params, {"tokens": toks}, toks.shape[1],
                                  lengths=lens, quant_impl=self._quant_impl,
                                  prior=prior, prior_len=prior_len)

    def _prefill_bucket(self, bucket_len: int, reqs: list[Request], *,
                        defer_first: bool = False) -> dict:
        # divergent-suffix prefill: row r holds request r's unshared tail
        toks = np.zeros((self.slots, bucket_len), np.int64)
        lens = np.ones((self.slots,), np.int32)  # pad rows: length 1
        shared_blocks = [len(r.shared_pages) for r in reqs]
        p_max = max(shared_blocks)
        for r, req in enumerate(reqs):
            sl = req.suffix_len(self.block_n)
            toks[r, :sl] = req.prompt[len(req.shared_pages) * self.block_n:]
            lens[r] = sl
            self.metrics.inc("prefill_tokens", sl)
            self.metrics.inc("prefill_tokens_saved", req.prompt_len - sl)
        dev = self.device
        t_toks, t_lens = upload(toks, dev), upload(lens, dev)
        if p_max == 0:
            logits, dstate = self._prefill(t_toks, t_lens)
        else:
            # the prior walk padded to a power-of-two block count
            p_pad = bucket_for(p_max, min_bucket=1)
            pages = np.zeros((self.slots, p_pad), np.int64)
            plens = np.zeros((self.slots,), np.int32)
            for r, req in enumerate(reqs):
                s = len(req.shared_pages)
                pages[r, :s] = req.shared_pages
                plens[r] = s * self.block_n
            logits, dstate = self._prefill_shared(t_toks, t_lens, upload(pages, dev),
                                                  upload(plens, dev))
        self.metrics.inc("prefill_calls")
        lazy: dict[int, tuple] = {}
        if defer_first:
            # async runtime: no host sync at admission; the token is read at
            # the slot's first consumption boundary (or at preemption)
            first = DeviceTokens(logits[:, 0].argmax(-1))
        else:
            first = logits[:, 0].argmax(-1).cpu().numpy()

        slot_ids, lengths, pages_per_req = [], [], []
        for r, req in enumerate(reqs):
            s = len(req.shared_pages)
            sl = req.suffix_len(self.block_n)
            n_blocks = sl // self.block_n
            # covered by the reservation floor: never preempts here
            # page-affine: fresh block j lands at table column s + j
            pgs = [self._alloc_page(req, admission=True, block=s + j) for j in range(n_blocks)]
            self._table[req.slot, :] = req.slot  # fresh scratch row
            self._table[req.slot, :s] = req.shared_pages
            if req.spec_page is not None:  # speculative flush destination
                self._table[req.slot, s] = req.spec_page
            self._table[req.slot, s:s + n_blocks] = pgs
            slot_ids.append(req.slot)
            lengths.append(sl)
            pages_per_req.append(pgs)
            req.phase = Phase.DECODE
            req.pos = req.prompt_len
            req.admit_cycle = self._cycle
            if self.tracer is not None:
                self.tracer.end("prefill", uid=req.uid, cat="request")
                self.tracer.begin("decode", uid=req.uid, cat="request")
            if req.replay_left > 0:
                # rematerializing victim: teacher-force its recorded stream
                self.tokens[req.slot, 0] = req.out_tokens[0]
            elif req.pending_token is not None:
                # preempted before any decode: resume from the parked token
                self.tokens[req.slot, 0] = req.pending_token
                req.pending_token = None
            elif defer_first:
                lazy[req.slot] = (first, r)
            else:
                self.tokens[req.slot, 0] = int(first[r])
        self._table_dirty = True
        pg.adopt_prefill(self.state["caches"], dstate["caches"], slot_ids=slot_ids,
                         lengths=lengths, pages_per_req=pages_per_req,
                         block_n=self.block_n, base_blocks=shared_blocks)
        self._splice_side_state(dstate, slot_ids)
        # in place: the async runtime's captured step reads this tensor
        self.state["pos"][upload(np.asarray(slot_ids, np.int64), dev)] = upload(
            np.asarray([r.prompt_len for r in reqs], np.int32), dev)
        # full prompt blocks (shared + fresh) become discoverable
        for r, req in enumerate(reqs):
            self.sched.register_prefix(req, req.shared_pages + pages_per_req[r])
        return lazy

    def _splice_side_state(self, dstate, slot_ids: list[int]) -> set[str]:
        """Copy the declared side state (``PagedSpec.side_state``: the
        hybrid's Mamba2 states, xLSTM's recurrent states) of the
        just-prefilled rows into their decode slots, in place (prefill row
        ``r`` -> slot ``slot_ids[r]``), so the captured graphs read it; the
        page table never sees it.  Returns the top-level state keys it
        covered (the shim splices the others itself)."""
        if not self.spec.side_state:
            return set()
        dev = self.device
        sidx = upload(np.asarray(slot_ids, np.int64), dev)
        rows = torch.arange(len(slot_ids), device=dev)
        for path, bdim in self.spec.side_state:
            for dst, src in zip(tensors_at(self.state, path), tensors_at(dstate, path)):
                dst.index_copy_(bdim, sidx, src.index_select(bdim, rows).to(dst.dtype))
        return {path.split("/")[0] for path, _ in self.spec.side_state}

    # ------------------------------------------------- exact-length shim

    def _admit_exact(self, *, defer_first: bool = False) -> dict:
        """The shim's admission: the pool-less scheduler's exact-length
        groups, each request prefilled alone (:meth:`_fill_slot`).
        ``defer_first`` as in :meth:`_admit_and_prefill`."""
        with self._phase("schedule"):
            groups = self.sched.admit()
            if groups:
                self._note_admissions(groups)
        lazy: dict[int, tuple] = {}
        for reqs in groups.values():
            for req in reqs:
                with self._phase("prefill"):
                    lazy.update(self._fill_slot(req, defer_first=defer_first))
        return lazy

    def _fill_slot(self, req: Request, *, defer_first: bool = False) -> dict:
        """One exact-length prefill at B 1, spliced into ``req``'s slot in
        place: the declared side state on its batch axis, every other
        tensor of the state on its own (axis 1 of the caches stacked ``(L,
        B, ...)``, axis 0 of ``pos``)."""
        i = req.slot
        toks = upload(np.asarray(req.prompt, np.int64)[None], self.device)
        logits, st = self.model.prefill(self.params, {"tokens": toks}, self.max_seq,
                                        impl=self._impl, quant_impl=self._quant_impl)
        handled = self._splice_side_state(st, [i])
        rest = [k for k in self.state if k not in handled]
        for dst, src in zip(_state_tensors({k: self.state[k] for k in rest}),
                            _state_tensors({k: st[k] for k in rest})):
            bdim = 0 if dst.dim() == 1 else 1
            dst.select(bdim, i).copy_(src.select(bdim, 0))
        lazy: dict[int, tuple] = {}
        if defer_first:
            # async runtime: read at the slot's first consumption boundary
            lazy[i] = (DeviceTokens(logits[:, -1].argmax(-1)), 0)
        else:
            self.tokens[i, 0] = int(logits[0, -1].argmax())
        self.metrics.inc("prefill_calls")
        self.metrics.inc("prefill_tokens", req.prompt_len)
        req.phase = Phase.DECODE
        req.pos = req.prompt_len
        req.admit_cycle = self._cycle
        if self.tracer is not None:
            self.tracer.end("prefill", uid=req.uid, cat="request")
            self.tracer.begin("decode", uid=req.uid, cat="request")
        return lazy

    def _ensure_flush_pages(self, pos_of=None, lookahead: dict[int, int] | None = None) -> None:
        """Allocate the destination page of every row whose residual fills on
        the coming step (``pos % block_n == block_n - 1``); ``lookahead``
        (slot -> feed count, the speculative cycle) widens the check to
        every position the cycle's verify pass can reach, which may cross
        more than one block boundary.  A destination
        column that holds a page with refcount > 1 (a speculative shared
        tail) is copied on write: the request gets a private page, the block
        is replicated on the device, and only its own column is repointed.
        A privately held page is overwritten in place, so its stale index
        node is dropped.  Preemption can fire here, so the loop re-checks
        each request is still active.  ``pos_of`` (request -> position)
        overrides the position checked: the async runtime passes its
        dispatch-frontier position, which leads ``req.pos`` by the steps in
        flight (a destination must exist before its step is dispatched)."""
        cow_src, cow_dst = [], []
        for req in list(self.sched.active.values()):
            pos = req.pos if pos_of is None else pos_of(req)
            window = 1 if lookahead is None else lookahead.get(req.slot, 1)
            for j in range(max(1, window)):
                if self.sched.active.get(req.slot) is not req:
                    break  # preempted by an earlier alloc this cycle
                if (pos + j) % self.block_n != self.block_n - 1:
                    continue
                blk = (pos + j) // self.block_n
                entry = int(self._table[req.slot, blk])
                if entry < self.slots:  # still scratch -> fresh private page
                    page = self._alloc_page(req, block=blk)
                    if page is None:
                        continue  # self-preempted: requeued, row reset
                    self._table[req.slot, blk] = page
                    self._table_dirty = True
                elif self.pool.refcount(entry) > 1:  # shared -> copy on write
                    # page-affine: source and copy back column blk, one shard
                    page = self._alloc_page(req, block=blk)
                    if page is None:
                        continue
                    cow_src.append(entry)
                    cow_dst.append(page)
                    req.pages.remove(entry)
                    if req.spec_page == entry:
                        req.spec_page = None
                    self.pool.free(entry, owner=req.uid)
                    self._table[req.slot, blk] = page
                    self._table_dirty = True
                    self.metrics.inc("cow_copies")
                    if self.tracer is not None:
                        self.tracer.instant("cow", uid=req.uid, cat="request",
                                            args={"src": entry, "dst": page})
                else:
                    self.sched.forget_page(entry)
        if cow_src:
            pg.cow_pages(self.state["caches"], cow_src, cow_dst)
