"""Invariant auditor for the paged serving engine (the port's copy of the
JAX package's ``serve/audit.py``: the pool, speculative-state and telemetry
audits).

Four views of page ownership must agree at every cycle boundary, and each
is maintained by different code:

1. the **pool** (`repro_torch.serve.pages.PagePool`) — refcounts, holder tags,
   the free list, the RETAINED tier (refcount-0 pages kept for prefix
   re-admission), and the commitment budget (``n_used + reserved``);
2. the **page tables** (the engine's host mirror ``_table``) — which pool
   page each slot's block column resolves to on device;
3. the **prefix index** (`repro_torch.serve.scheduler.PrefixIndex`) — which
   resident pages are discoverable as shared prompt prefixes;
4. the **per-request page lists** (``Request.pages``) — what each live
   request believes it holds.

:func:`audit_engine` cross-checks all four and returns an
:class:`AuditReport` naming every violation (leaked pages, dangling index
nodes, table columns aimed at freed pages, refcount/holder drift,
reservation-ledger desync).  The engine runs it every ``audit_every``
cycles and at drain.

The audit reads only host-side state — no device sync — so it is cheap
enough for continuous background use.
"""
from __future__ import annotations

import dataclasses

from repro_torch.serve.scheduler import Phase


class AuditError(RuntimeError):
    """An invariant audit found violations (the report text is the message)."""


@dataclasses.dataclass
class AuditReport:
    """Outcome of one :func:`audit_engine` pass."""

    violations: list
    pages_checked: int = 0
    table_entries_checked: int = 0
    index_nodes_checked: int = 0
    requests_checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def raise_if_violations(self) -> None:
        if self.violations:
            raise AuditError(
                f"{len(self.violations)} invariant violation(s):\n  "
                + "\n  ".join(self.violations)
            )

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        if self.ok:
            return (
                f"audit ok ({self.pages_checked} pages, "
                f"{self.table_entries_checked} table entries, "
                f"{self.index_nodes_checked} index nodes)"
            )
        return "audit FAILED:\n  " + "\n  ".join(self.violations)


def _audit_pool(pool, out: list) -> int:
    """Pool-internal accounting: free list vs refcounts vs holders vs the
    retained tier vs the commitment budget."""
    free = pool.free_pages()
    if len(set(free)) != len(free):
        dups = sorted({p for p in free if free.count(p) > 1})
        out.append(f"free list holds duplicate page(s) {dups}")
    free_set = set(free)
    retained_set = set(pool.retained_pages())
    for page in free_set:
        if page < pool.n_scratch:
            out.append(f"scratch page {page} on the free list")
        if pool.refcount(page) != 0:
            out.append(
                f"page {page} is on the free list with refcount "
                f"{pool.refcount(page)}"
            )
        if page in retained_set:
            out.append(f"page {page} is both free and retained")
    for page in retained_set:
        if page < pool.n_scratch:
            out.append(f"scratch page {page} in the retained tier")
        if pool.refcount(page) != 0:
            out.append(
                f"retained page {page} has refcount {pool.refcount(page)} "
                "(the tier holds only refcount-0 pages)"
            )
        if pool.holders(page):
            out.append(
                f"retained page {page} still lists holders "
                f"{pool.holders(page)}"
            )
    for page in range(pool.n_scratch, pool.n_pages):
        rc = pool.refcount(page)
        if rc < 0:
            out.append(f"page {page} has negative refcount {rc}")
        if rc > 0 and (page in free_set or page in retained_set):
            continue  # already reported above
        if rc == 0 and page not in free_set and page not in retained_set:
            out.append(
                f"leaked page {page}: refcount 0 but on neither the free "
                "list nor the retained tier"
            )
        holders = pool.holders(page)
        if rc > 0 and len(holders) != rc:
            out.append(
                f"page {page}: refcount {rc} but {len(holders)} holder "
                f"tag(s) {holders}"
            )
        if rc == 0 and holders:
            out.append(f"freed page {page} still lists holders {holders}")
    if pool.n_used != pool.capacity - pool.n_free:
        out.append(
            f"n_used={pool.n_used} disagrees with capacity-n_free="
            f"{pool.capacity - pool.n_free}"
        )
    if pool.reserved < 0:
        out.append(f"negative reservation count {pool.reserved}")
    tracked = sum(pool._owner_reserved.values())
    if tracked > pool.reserved:
        out.append(
            f"owner reservation ledger sums to {tracked} > pool.reserved="
            f"{pool.reserved}"
        )
    if pool.committed > pool.capacity:
        out.append(
            f"over-committed pool: committed={pool.committed} > capacity="
            f"{pool.capacity}"
        )
    return pool.n_pages - pool.n_scratch


def audit_engine(engine) -> AuditReport:
    """Cross-check the four ownership views of a (paged) ServeEngine.

    Non-paged engines (the exact-length shim has no pool) audit trivially
    clean — there is no page state to drift.
    """
    out: list = []
    report = AuditReport(out)
    pool = getattr(engine, "pool", None)
    if pool is None:
        return report
    sched = engine.sched
    report.pages_checked = _audit_pool(pool, out)

    # pages parked by a delayed-release fault are legitimately held by their
    # (already retired) owner until the engine services the deferral
    deferred_pages: dict[int, object] = {}
    for _ready, uid, pages in getattr(engine, "_deferred", ()):
        for page in pages:
            deferred_pages[page] = uid

    # --- per-request page lists vs pool holders -------------------------
    live_uids = set()
    for req in sched.active.values():
        live_uids.add(req.uid)
        report.requests_checked += 1
        for page in req.pages:
            if page < pool.n_scratch:
                out.append(
                    f"request {req.uid} lists scratch page {page} as held"
                )
            elif pool.refcount(page) <= 0:
                out.append(
                    f"request {req.uid} lists freed page {page} as held"
                )
            elif req.uid not in pool.holders(page):
                out.append(
                    f"request {req.uid} lists page {page} but is not among "
                    f"its holders {pool.holders(page)}"
                )
        if pool.owner_reserved(req.uid) != req.reserved_pages:
            out.append(
                f"request {req.uid}: reserved_pages={req.reserved_pages} "
                f"but the pool ledger holds "
                f"{pool.owner_reserved(req.uid)} unit(s)"
            )
    for req in sched.waiting:
        live_uids.add(req.uid)
        if req.pages:
            out.append(
                f"waiting request {req.uid} still lists pages {req.pages}"
            )

    # --- allocated pages must be held by someone accounted for ----------
    for page in range(pool.n_scratch, pool.n_pages):
        if pool.refcount(page) <= 0:
            continue
        holders = pool.holders(page)
        accounted = (
            any(h in live_uids or h is None for h in holders)
            or page in deferred_pages
        )
        if not accounted:
            out.append(
                f"leaked page {page}: refcount {pool.refcount(page)} held "
                f"by retired owner(s) {holders}"
            )

    # --- page-table columns ---------------------------------------------
    table = getattr(engine, "_table", None)
    if table is not None:
        n_slots, nb_max = table.shape
        report.table_entries_checked = n_slots * nb_max
        for slot in range(n_slots):
            req = sched.active.get(slot)
            held = set(req.pages) if req is not None else set()
            for blk in range(nb_max):
                entry = int(table[slot, blk])
                if entry < pool.n_scratch:
                    if entry != slot:
                        out.append(
                            f"table[{slot},{blk}] points at scratch page "
                            f"{entry} of another slot (injectivity breach)"
                        )
                    continue
                if pool.refcount(entry) <= 0:
                    out.append(
                        f"table[{slot},{blk}] points at freed page {entry}"
                    )
                elif req is None:
                    out.append(
                        f"table[{slot},{blk}] of idle slot still points at "
                        f"pool page {entry}"
                    )
                elif entry not in held:
                    out.append(
                        f"table[{slot},{blk}] points at page {entry} not in "
                        f"request {req.uid}'s page list"
                    )

    # --- prefix-index registrations --------------------------------------
    index = sched.index
    if index is not None:
        report.index_nodes_checked = len(index._meta)
        for page, (digest, parent, _toks) in index._meta.items():
            if pool.refcount(page) <= 0 and not pool.is_retained(page):
                out.append(
                    f"dangling prefix-index node: page {page} is registered "
                    "but free"
                )
            if index._page_of.get(digest) != page:
                out.append(
                    f"prefix-index node for page {page}: digest does not map "
                    "back to it"
                )
            if page not in index._children.get(parent, ()):
                out.append(
                    f"prefix-index node for page {page}: missing from its "
                    "parent's child list"
                )
        for digest, page in index._page_of.items():
            if page not in index._meta:
                out.append(
                    f"prefix-index digest entry maps to unregistered page "
                    f"{page}"
                )
        # retained pages exist only to be re-discovered: one with no index
        # node is dead weight the reclaim path can never justify keeping
        for page in pool.retained_pages():
            if page not in index._meta:
                out.append(
                    f"retained page {page} is not registered in the prefix "
                    "index"
                )

    _audit_spec(engine, out)
    _audit_telemetry(engine, out)
    return report


def _audit_spec(engine, out: list) -> None:
    """Self-speculative decoding state.

    * the configuration: ``spec_k >= 1``; with speculation on, ``spec_bits``
      in ``[1, kv_bits]`` and both passes built;
    * token conservation: every drafted token was accepted or rejected,
      ``spec_draft_tokens == spec_accepted + spec_rejected``, and no
      counter, the per-request ones included, is negative;
    * position bookkeeping: an active DECODE request's ``pos`` equals
      ``prompt_len + len(out_tokens) - replay_left``: the multi-token verify
      and the one-token cycle keep the same ledger, so drift here is a lost
      or double-counted append.
    """
    spec_k = getattr(engine, "spec_k", 1)
    stats = getattr(engine, "stats", {})
    if spec_k < 1:
        out.append(f"spec_k={spec_k} out of range (must be >= 1)")
    if spec_k > 1:
        bits = getattr(getattr(getattr(engine, "model", None), "cfg", None), "kv_bits", None)
        sb = getattr(engine, "spec_bits", None)
        if sb is not None and bits is not None and not 1 <= sb <= bits:
            out.append(f"spec_bits={sb} outside [1, kv_bits={bits}]")
        if getattr(engine, "_draft", None) is None:
            out.append("spec_k > 1 but no draft pass was built")
        if getattr(engine, "_verify", None) is None:
            out.append("spec_k > 1 but no verify pass was built")
    drafted = stats.get("spec_draft_tokens", 0)
    accepted = stats.get("spec_accepted_tokens", 0)
    rejected = stats.get("spec_rejected_tokens", 0)
    if min(drafted, accepted, rejected) < 0:
        out.append(f"negative speculative counter(s): drafted={drafted} "
                   f"accepted={accepted} rejected={rejected}")
    if drafted != accepted + rejected:
        out.append(f"speculative token conservation breach: drafted={drafted} != "
                   f"accepted={accepted} + rejected={rejected}")
    sched = getattr(engine, "sched", None)
    if sched is None:
        return
    for req in sched.active.values():
        if req.spec_accepted < 0 or req.spec_rejected < 0:
            out.append(f"request {req.uid}: negative per-request speculative counter(s) "
                       f"({req.spec_accepted}/{req.spec_rejected})")
        if req.phase is Phase.DECODE:
            want = req.prompt_len + len(req.out_tokens) - req.replay_left
            if req.pos != want:
                out.append(f"request {req.uid}: pos={req.pos} but prompt_len + out_tokens - "
                           f"replay_left = {want} (append ledger drift)")


def _audit_telemetry(engine, out: list) -> None:
    """Telemetry consistency (docs/OBSERVABILITY.md).

    * lifecycle counters are non-negative (the registry enforces monotone
      counters, so a negative here means the view layer drifted);
    * with a tracer attached, span discipline holds: every live request has
      exactly one open lifecycle span (``queue`` while waiting, ``prefill``
      or ``decode`` while active) and no span stays open for a uid that has
      already retired.
    """
    stats = getattr(engine, "stats", {})
    for name, value in stats.items():
        if isinstance(value, (int, float)) and value < 0:
            out.append(f"negative lifecycle counter {name}={value}")
    tracer = getattr(engine, "tracer", None)
    sched = getattr(engine, "sched", None)
    if tracer is None or sched is None:
        return
    live = {r.uid for r in sched.active.values()}
    live |= {r.uid for r in sched.waiting}
    open_by_uid: dict = {}
    for cat, name, uid in tracer.open_spans():
        if cat == "request" and uid is not None:
            open_by_uid.setdefault(uid, []).append(name)
    for uid, names in open_by_uid.items():
        if uid not in live:
            out.append(
                f"tracer span(s) {names} still open for retired request {uid}"
            )
        elif len(names) > 1:
            out.append(
                f"request {uid} holds {len(names)} lifecycle spans open "
                f"simultaneously: {names}"
            )
    for uid in sorted(live - set(open_by_uid)):
        out.append(f"live request {uid} has no open lifecycle span")
