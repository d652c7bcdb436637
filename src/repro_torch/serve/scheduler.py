"""Continuous-batching scheduler: lifecycle, bucketed admission, prefix index.

The port's copy of the JAX package's ``serve/scheduler.py``, host-side and
framework-free: the same admission order, reservations, buckets and chunk
hashes, so a prefix chain digests to the same bytes in both packages.

Request lifecycle (the serving subsystem's state machine):

```
 submit()            admit()               prefill adopted        retire
WAITING ──────────► PREFILL ─────────────► DECODE ──────────────► DONE
   ▲  (slot free AND pages reservable)        │       │
   │ └───────────── backpressure ◄────────────┼───────┘
   └─────────────── preempt() ◄───────────────┘  (pool alloc would fail
   │                                              mid-decode: pages freed,
   │                                              decoded tokens queued
   │                                              for replay, FIFO head
   │                                              requeue)
   └──► REJECTED (submit: never admittable)     terminal phases:
        CANCELLED (cancel(uid))                 DONE / REJECTED / CANCELLED
        EXPIRED   (deadline_s passed)           / EXPIRED / ERRORED
        ERRORED   (poisoned step, isolated)
```

Admission is strict FIFO: the head of the waiting queue is admitted when a
decode slot is free *and* the page pool can reserve its page count under the
configured ``reserve_policy``; if the head cannot be admitted nothing behind
it is (no starvation, deterministic order).

* ``reserve_policy="worst_case"`` (default) reserves the request's full
  lifetime page count — decode-time allocation is infallible and steady
  state never preempts;
* ``reserve_policy="expected"`` reserves for an *expected* decode length
  (``ceil(expected_quantile * max_new_tokens)`` generated tokens, never less
  than the prompt itself needs) — the pool admits more concurrent requests
  than it could at worst case, and a request that outlives its expectation
  extends its reservation one page at a time, **preempting** a victim when
  the commitment budget is full (engine's ``_alloc_page``).  Preemption is
  recoverable by construction: the victim's pages are freed (shared pages
  survive through their other holders), re-admission re-prefills its prompt
  through the ordinary (prefix-sharing) suffix path, and its already-decoded
  tokens are **replayed teacher-forced through the decode path** — the same
  computation that built them, so the quantized cache state (and therefore
  every future token) is reconstructed *bitwise*; a prefill recompute of
  decode-built blocks would quantize differently and break greedy parity.
  See docs/SERVING.md §10 for the bounded-preemption invariant that
  replaces preempt-free.

**Prefix sharing** (:class:`PrefixIndex`): prompts are hashed as a chain of
``block_n``-sized chunks under a per-model-config namespace; at admission
the longest leading run of chunks already resident in the pool maps straight
onto the donor's pages (``PagePool.retain`` — no prefill compute, no second
copy, reservation discounted by the shared read blocks).  The last shareable
index is capped at ``(prompt_len - 1) // block_n`` so at least one suffix
token is always prefilled (the engine needs its logits).  When the prompt
ends mid-block and the donor has the covering block committed with a
matching token prefix, that page is additionally adopted as a *speculative
tail* — a flush-destination placeholder that the engine copy-on-writes at
the first divergent flush (its reservation unit is kept, so COW stays inside
the preempt-free budget).  Pages register after their prefill is adopted, so
sharing takes effect from the next scheduling cycle on.

Prompts admitted in the same cycle are grouped into *length buckets*
(powers of two ≥ ``min_bucket``) over their **divergent suffix** length and
right-padded to the bucket, so each bucket is one prefill call of one
shape, and a fully-shared prompt
costs a minimal bucket instead of its full length.
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import math
import time
from collections import deque

import numpy as np

from repro_torch.serve.pages import PagePool
from repro_torch.serve.telemetry import MetricsRegistry


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    REJECTED = "rejected"    # never admittable (submit-time guard)
    CANCELLED = "cancelled"  # cancel(uid)
    EXPIRED = "expired"      # deadline_s passed before completion
    ERRORED = "errored"      # isolated step-level failure (poisoned row)


#: phases a request never leaves (DONE plus the failure retirements)
TERMINAL_PHASES = frozenset(
    {Phase.DONE, Phase.REJECTED, Phase.CANCELLED, Phase.EXPIRED,
     Phase.ERRORED}
)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int = 32
    out_tokens: list = dataclasses.field(default_factory=list)
    deadline_s: float | None = None  # TTL from submit() (engine clock)
    # ---- lifecycle, managed by the scheduler/engine ----
    phase: Phase = Phase.WAITING
    slot: int | None = None
    pages: list = dataclasses.field(default_factory=list)
    pos: int = 0                 # cached tokens so far (host mirror)
    reserved_pages: int = 0      # remaining un-allocated reservation units
    arrival_s: float = 0.0       # virtual arrival time (bench offered-load)
    submitted_s: float = 0.0     # scheduler clock at submit (deadline base)
    token_latencies_s: list = dataclasses.field(default_factory=list)
    error: str | None = None     # reason for REJECTED/EXPIRED/ERRORED/...
    # ---- prefix sharing (set at admission) ----
    shared_pages: list = dataclasses.field(default_factory=list)
    spec_page: int | None = None  # speculative tail page (COW candidate)
    chain: list = dataclasses.field(default_factory=list)  # chunk digests
    # ---- preemption-by-rematerialization ----
    remat_tokens: int = 0          # cumulative tokens replayed after preempts
    replay_left: int = 0           # decoded tokens still to teacher-force
    pending_token: int | None = None  # decoded-but-unfed token at preemption
    preemptions: int = 0
    # shared-block count of the FIRST admission, frozen so rematerializing
    # re-admissions reproduce the original prefill computation exactly: a
    # victim whose prompt entered cold must re-prefill cold even if its own
    # pages now sit in the RETAINED tier (suffix-over-dequantized-prior is
    # not bitwise vs. a raw full prefill, SERVING.md §9/§14)
    orig_shared_blocks: int | None = None
    admit_seq: int = -1            # global admission order (victim policy)
    admit_cycle: int = -1          # engine cycle of the last admission
    # ---- self-speculative decoding (kept for parity; ROADMAP A9) ----
    spec_accepted: int = 0         # draft tokens accepted by verify
    spec_rejected: int = 0         # draft tokens discarded at divergence
    # ---- telemetry timestamps (real perf_counter clock, never the
    # injectable TTL clock; docs/OBSERVABILITY.md) ----
    t_submit_s: float | None = None       # submit() wall time
    t_admit_s: float | None = None        # first admission wall time
    t_first_token_s: float | None = None  # first emitted token (TTFT base)

    @property
    def done(self) -> bool:
        """Derived from the lifecycle phase (single source of truth)."""
        return self.phase == Phase.DONE

    @property
    def finished(self) -> bool:
        """True in any terminal phase (DONE or a failure retirement)."""
        return self.phase in TERMINAL_PHASES

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    def pages_needed(self, block_n: int) -> int:
        """Worst-case committed blocks over the request's lifetime: the cache
        holds ``prompt + max_new_tokens`` tokens when it retires (preemption
        does not change the total — the prompt and budget are invariant)."""
        return (self.prompt_len + self.max_new_tokens) // block_n

    def suffix_len(self, block_n: int) -> int:
        """Divergent-suffix tokens this request must still prefill."""
        return self.prompt_len - len(self.shared_pages) * block_n


def bucket_for(n: int, *, min_bucket: int = 16) -> int:
    """Smallest power-of-two bucket >= max(n, min_bucket)."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


class PrefixIndex:
    """Block-granular prompt-prefix index: chunk-hash chains → resident pages.

    One chain node per full ``block_n``-sized prompt chunk:
    ``digest_j = H(digest_{j-1} || tokens[j*block_n:(j+1)*block_n])`` with
    ``digest_{-1} = H(namespace)`` — the namespace folds the model-config
    fields that determine cache content (arch, kv bits/block/granularity), so
    pools of incompatible layouts never cross-match.  A node maps to the pool
    page holding that chunk's committed block; pages register once (first
    writer wins) and are forgotten when their last pool reference drops
    (``PagePool.on_release``) or when the engine is about to overwrite a
    privately-held page in place.

    Per page the index also records the chunk's token ids — the speculative
    tail lookup (:meth:`spec_tail`) needs to check that a donor block's first
    ``r`` tokens equal a new prompt's mid-block tail.
    """

    def __init__(self, namespace: str, block_n: int):
        self.block_n = block_n
        self.root = hashlib.sha1(namespace.encode()).digest()
        self._page_of: dict[bytes, int] = {}
        # page -> (digest, parent digest, chunk token ids)
        self._meta: dict[int, tuple[bytes, bytes, np.ndarray]] = {}
        self._children: dict[bytes, list[int]] = {}

    def __len__(self) -> int:
        return len(self._page_of)

    def chain(self, prompt: np.ndarray) -> list[bytes]:
        """Digest after each *full* ``block_n`` chunk of ``prompt``."""
        h = self.root
        out = []
        p = np.ascontiguousarray(prompt, dtype=np.int32)
        for j in range(len(p) // self.block_n):
            chunk = p[j * self.block_n : (j + 1) * self.block_n]
            h = hashlib.sha1(h + chunk.tobytes()).digest()
            out.append(h)
        return out

    def lookup(self, chain: list[bytes]) -> list[int]:
        """Pages for the longest leading run of resident chain nodes."""
        pages = []
        for h in chain:
            page = self._page_of.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def spec_tail(self, parent: bytes, tail: np.ndarray) -> int | None:
        """A resident page one chain step below ``parent`` whose block starts
        with ``tail`` (the new prompt's mid-block remainder) — the engine
        adopts it as the speculative flush destination (COW candidate)."""
        if not len(tail):
            return None
        tail = np.ascontiguousarray(tail, dtype=np.int32)
        for page in self._children.get(parent, ()):
            _, _, toks = self._meta[page]
            if len(toks) >= len(tail) and np.array_equal(toks[: len(tail)], tail):
                return page
        return None

    def register(self, chain: list[bytes], pages: list[int],
                 prompt: np.ndarray) -> None:
        """Make ``pages[j]`` (holding ``prompt``'s chunk ``j``) discoverable.
        Nodes already resident and pages already registered are skipped, so
        re-registering a shared prefix is a no-op."""
        p = np.ascontiguousarray(prompt, dtype=np.int32)
        parent = self.root
        for j, (h, page) in enumerate(zip(chain, pages)):
            if h not in self._page_of and page not in self._meta:
                toks = p[j * self.block_n : (j + 1) * self.block_n].copy()
                self._page_of[h] = page
                self._meta[page] = (h, parent, toks)
                self._children.setdefault(parent, []).append(page)
            parent = h

    def is_registered(self, page: int) -> bool:
        """Whether ``page`` holds a live chain node — the pool's
        ``retainable`` predicate: only pages the index can re-discover are
        worth keeping in the RETAINED tier."""
        return page in self._meta

    def forget_page(self, page: int) -> None:
        """Drop a page's node (page died, or its content is about to be
        overwritten in place)."""
        meta = self._meta.pop(page, None)
        if meta is None:
            return
        digest, parent, _ = meta
        self._page_of.pop(digest, None)
        kids = self._children.get(parent)
        if kids is not None:
            kids.remove(page)
            if not kids:
                self._children.pop(parent, None)


class Scheduler:
    """Continuous-batching admission over a fixed slot set and a PagePool."""

    def __init__(self, *, slots: int, pool: PagePool | None, block_n: int,
                 max_seq: int, min_bucket: int = 16,
                 share_prefix: bool = True, spec_tail: bool = True,
                 retain_prefix: bool = False,
                 exact_buckets: bool = False, namespace: str = "default",
                 reserve_policy: str = "worst_case",
                 expected_quantile: float = 0.5, strict: bool = False,
                 clock=None, metrics: MetricsRegistry | None = None):
        """``exact_buckets`` groups admissions by *exact* suffix length
        instead of power-of-two buckets — required by cache families whose
        prefill cannot be right-padded (recurrent side-state absorbs pad
        tokens: HybridLM's SSM states, xLSTM; ``PagedSpec.exact_prefill``).
        Costs one prefill compile per distinct prompt length instead of per
        bucket — the documented trade-off of those families.

        ``reserve_policy`` selects the admission reservation: ``"worst_case"``
        reserves the full lifetime page count (preempt-free steady state),
        ``"expected"`` reserves for ``expected_quantile`` of the decode
        budget and relies on the engine's preemption-by-rematerialization
        when a request outlives it.  ``strict=True`` restores the historical
        behavior of raising ``ValueError`` from :meth:`submit` for
        never-admittable requests instead of retiring them ``REJECTED``.
        ``clock`` (default ``time.monotonic``) timestamps submissions for
        per-request ``deadline_s`` enforcement.  ``metrics`` shares the
        engine's `repro_torch.serve.telemetry.MetricsRegistry` (counters register
        under the ``sched_`` prefix; default: a private registry) — the
        ``stats`` property keeps the historical unprefixed dict view.

        ``retain_prefix`` (needs ``share_prefix``) turns on the pool's
        RETAINED tier: prefix-registered pages survive their last holder's
        departure as evictable LRU entries, and admission promotes them
        back at zero cost (counted as ``prefix_retained_hits``).  Off by
        default — with retention on, a drained engine intentionally keeps
        registered pages out of the free list."""
        if reserve_policy not in ("worst_case", "expected"):
            raise ValueError(f"unknown reserve_policy {reserve_policy!r}")
        if not 0.0 <= expected_quantile <= 1.0:
            raise ValueError(
                f"expected_quantile must be in [0, 1], got {expected_quantile}"
            )
        self.slots = slots
        self.pool = pool
        self.block_n = block_n
        self.max_seq = max_seq
        self.min_bucket = min_bucket
        self.spec_tail = spec_tail
        self.exact_buckets = exact_buckets
        self.reserve_policy = reserve_policy
        self.expected_quantile = expected_quantile
        self.strict = strict
        self.clock = clock if clock is not None else time.monotonic
        self.index: PrefixIndex | None = None
        self.retain_prefix = retain_prefix and share_prefix and pool is not None
        if share_prefix and pool is not None:
            self.index = PrefixIndex(namespace, block_n)
            pool.on_release = self.index.forget_page
            if self.retain_prefix:
                pool.retainable = self.index.is_registered
        self.waiting: deque[Request] = deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self._admit_seq = 0
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        for key in self._STAT_KEYS:
            self.metrics.counter("sched_" + key)

    #: lifecycle counters (registry names carry the ``sched_`` prefix the
    #: engine historically added when folding them into ``summary()``)
    _STAT_KEYS = (
        "submitted", "admitted", "completed", "rejected",
        "backpressure_events", "prefix_hit_requests", "prefix_hit_blocks",
        "prefix_lookup_blocks", "prefix_retained_hits",
        "spec_tail_adoptions",
    )

    @property
    def stats(self) -> dict:
        """Scheduler counters as a plain unprefixed dict (the pre-telemetry
        ``stats`` interface, now a read-only registry view)."""
        return {
            k: int(self.metrics.value("sched_" + k)) for k in self._STAT_KEYS
        }

    # ------------------------------------------------------------ queue

    def reject(self, req: Request, reason: str) -> None:
        """Retire ``req`` as REJECTED with ``reason`` (or raise it under
        ``strict=True``) — the graceful path for never-admittable requests,
        so one bad submission cannot crash a serving loop."""
        if self.strict:
            raise ValueError(reason)
        req.phase = Phase.REJECTED
        req.error = reason
        self.metrics.inc("sched_rejected")

    def submit(self, req: Request) -> bool:
        """Queue ``req``; returns False (phase REJECTED, ``req.error`` set)
        when it could never be admitted: over the sequence budget, or needing
        more pages than the pool holds."""
        if req.prompt_len + req.max_new_tokens > self.max_seq:
            self.reject(
                req,
                f"request {req.uid}: prompt_len={req.prompt_len} + "
                f"max_new_tokens={req.max_new_tokens} exceeds max_seq="
                f"{self.max_seq}",
            )
            return False
        need = req.pages_needed(self.block_n)
        if self.pool is not None and need > self.pool.capacity:
            self.reject(
                req,
                f"request {req.uid} needs {need} pages but the pool holds "
                f"{self.pool.capacity} — it could never be admitted",
            )
            return False
        req.phase = Phase.WAITING
        req.submitted_s = self.clock()
        if req.t_submit_s is None:  # real clock for TTFT/queue-wait series
            req.t_submit_s = time.perf_counter()
        self.waiting.append(req)
        self.metrics.inc("sched_submitted")
        return True

    def free_slots(self) -> list[int]:
        return [i for i in range(self.slots) if i not in self.active]

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    # --------------------------------------------------------- admission

    def _match_prefix(self, req: Request):
        """Resolve the head request's shareable pages (no state change)."""
        if self.index is None:
            return [], None, []
        if not req.chain and req.prompt_len >= self.block_n:
            # memoized: a backpressured head is re-probed every cycle, but
            # the prompt (hence its digest chain) is immutable
            req.chain = self.index.chain(req.prompt)
        chain = req.chain
        cap = (req.prompt_len - 1) // self.block_n  # keep >= 1 suffix token
        if req.preemptions and req.orig_shared_blocks is not None:
            # rematerialization must replay the original admission's exact
            # prefill: never share MORE blocks than the first admission did
            # (the wider hit would swap a raw-bf16 prefill for a suffix
            # prefill over a dequantized prior — not bitwise, §9)
            cap = min(cap, req.orig_shared_blocks)
        shared = self.index.lookup(chain[:cap])
        spec = None
        s = len(shared)
        if (
            self.spec_tail
            and req.prompt_len % self.block_n
            and s == req.prompt_len // self.block_n
        ):
            parent = chain[s - 1] if s else self.index.root
            spec = self.index.spec_tail(
                parent, req.prompt[s * self.block_n :]
            )
        return shared, spec, chain

    def reserve_need(self, req: Request, n_shared: int) -> int:
        """Reservation units to admit ``req`` with ``n_shared`` shared read
        blocks already resident.  ``worst_case`` covers the full lifetime;
        ``expected`` covers ``ceil(expected_quantile * remaining_budget)``
        generated tokens — never less than the prompt itself commits at
        admission (suffix blocks must be allocatable immediately), never
        more than the worst case."""
        worst = req.pages_needed(self.block_n)
        if self.reserve_policy == "expected":
            # already-decoded tokens are certain (a preempted request will
            # replay them); only the remaining budget is discounted
            certain = len(req.out_tokens)
            remaining = req.max_new_tokens - certain
            exp_new = certain + math.ceil(self.expected_quantile * remaining)
            expected = (req.prompt_len + exp_new) // self.block_n
            # the admission itself allocates every full prompt block not
            # already shared, so the reservation can never dip below that
            worst = min(worst, max(expected, req.prompt_len // self.block_n))
        return max(worst - n_shared, 0)

    def admit(self) -> dict[int, list[Request]]:
        """Admit waiting requests (strict FIFO) into free slots while the
        pool can reserve their policy-determined *private* pages (shared
        read blocks are counted once pool-wide, never re-reserved); returns
        the admitted requests grouped by divergent-suffix prefill bucket
        length, in admission order."""
        free = self.free_slots()
        groups: dict[int, list[Request]] = {}
        while self.waiting and free:
            req = self.waiting[0]
            shared, spec, chain = self._match_prefix(req)
            need = self.reserve_need(req, len(shared))
            promoted = 0
            if self.pool is not None:
                # retain BEFORE reserving: reserve() reclaims retained
                # pages under budget pressure, and the LRU tail it would
                # evict can be exactly the chain _match_prefix resolved.
                # Promotion is budget-neutral (a retained page already
                # counts in n_used), so retain-first never turns a
                # would-have-succeeded reserve into backpressure.
                for page in shared:
                    promoted += bool(self.pool.retain(page, owner=req.uid))
                if spec is not None:
                    promoted += bool(self.pool.retain(spec, owner=req.uid))
                if not self.pool.reserve(need, owner=req.uid):
                    # retract: promoted pages fall back to RETAINED (at
                    # the MRU end — they were just touched), plain shared
                    # refs simply drop
                    for page in shared:
                        self.pool.free(page, owner=req.uid)
                    if spec is not None:
                        self.pool.free(spec, owner=req.uid)
                    self.metrics.inc("sched_backpressure_events")
                    break  # strict FIFO: nothing overtakes the head
            self.waiting.popleft()
            req.shared_pages = list(shared)
            if req.orig_shared_blocks is None:
                req.orig_shared_blocks = len(shared)
            req.spec_page = spec
            req.chain = chain
            req.pages = list(shared) + ([spec] if spec is not None else [])
            req.reserved_pages = need
            req.slot = free.pop(0)
            req.phase = Phase.PREFILL
            req.pos = 0
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            self.active[req.slot] = req
            self.metrics.inc("sched_admitted")
            if shared:
                self.metrics.inc("sched_prefix_hit_requests")
                self.metrics.inc("sched_prefix_hit_blocks", len(shared))
            if promoted:
                self.metrics.inc("sched_prefix_retained_hits", promoted)
            if self.index is not None:
                self.metrics.inc("sched_prefix_lookup_blocks", len(chain))
            if spec is not None:
                self.metrics.inc("sched_spec_tail_adoptions")
            if self.exact_buckets:
                bucket = req.suffix_len(self.block_n)
            else:
                bucket = bucket_for(
                    req.suffix_len(self.block_n), min_bucket=self.min_bucket
                )
            groups.setdefault(bucket, []).append(req)
        return groups

    def register_prefix(self, req: Request, pages: list[int]) -> None:
        """Register a just-adopted prompt's full-block pages (shared + fresh)
        in the index — the engine calls this after adoption, so same-cycle
        admissions never observe half-written pages."""
        if self.index is not None and req.chain:
            self.index.register(req.chain, pages, req.prompt)

    def forget_page(self, page: int) -> None:
        """Engine hook: a privately-held page is about to be overwritten in
        place (its indexed content would go stale)."""
        if self.index is not None:
            self.index.forget_page(page)

    # ------------------------------------------- retirement & preemption

    def _release_resources(self, req: Request) -> None:
        """Free pages (refcounted — shared pages survive until their last
        holder), return the remaining reservation, release the slot."""
        if self.pool is not None:
            for page in req.pages:
                self.pool.free(page, owner=req.uid)
            self.pool.release(req.reserved_pages, owner=req.uid)
        req.pages = []
        req.shared_pages = []
        req.spec_page = None
        req.reserved_pages = 0
        if req.slot is not None and self.active.get(req.slot) is req:
            self.active.pop(req.slot)
        req.slot = None

    def retire(self, req: Request, phase: Phase = Phase.DONE,
               reason: str | None = None) -> None:
        """Move ``req`` to a terminal phase, releasing everything it holds."""
        if phase not in TERMINAL_PHASES:
            raise ValueError(f"retire to non-terminal phase {phase}")
        self._release_resources(req)
        req.phase = phase
        if reason is not None:
            req.error = reason
        if phase == Phase.DONE:
            self.metrics.inc("sched_completed")

    def complete(self, req: Request) -> None:
        """Retire a request as DONE (historical alias of :meth:`retire`)."""
        self.retire(req, Phase.DONE)

    def preempt(self, req: Request, pending_token: int | None = None) -> None:
        """Preempt an active request so its pages can serve someone else,
        keeping it *recoverable by rematerialization*: re-admission
        re-prefills its (unchanged) prompt through the ordinary — prefix-
        sharing — suffix path, then replays its already-decoded tokens
        teacher-forced through the decode path (``replay_left``), which
        rebuilds the quantized cache bit-for-bit; the decoded-but-not-yet-fed
        token is parked in ``pending_token`` and restored after the replay,
        so the continuation is exactly the unpreempted token stream.  The
        request requeues at the FIFO *head* — it is older than anything
        waiting behind it."""
        self._release_resources(req)
        req.replay_left = len(req.out_tokens)
        req.remat_tokens += req.replay_left
        req.pending_token = pending_token
        req.preemptions += 1
        req.phase = Phase.WAITING
        self.waiting.appendleft(req)

    def cancel(self, uid: int) -> Request | None:
        """Cancel a waiting or active request by uid; returns the retired
        request (phase CANCELLED) or None if no live request has that uid.
        The engine wraps this to also reset the victim's page-table row."""
        for req in self.waiting:
            if req.uid == uid:
                self.waiting.remove(req)
                self.retire(req, Phase.CANCELLED, reason="cancelled")
                return req
        for req in list(self.active.values()):
            if req.uid == uid:
                self.retire(req, Phase.CANCELLED, reason="cancelled")
                return req
        return None

    def expired(self, now: float) -> list[Request]:
        """Live requests whose ``deadline_s`` (TTL from submission) has
        passed at clock reading ``now`` — the engine retires them EXPIRED."""
        live = list(self.waiting) + list(self.active.values())
        return [
            r for r in live
            if r.deadline_s is not None
            and now - r.submitted_s > r.deadline_s
        ]
