"""Deterministic fault injection for the serving engine (the port's copy of
the JAX package's ``serve/faults.py``: same seeding, so the same plan fires
at the same consultations in both engines).

Chaos testing is only useful when a failure found once can be found again:
a :class:`FaultPlan` is a *seeded* schedule of failures that the engine
consults at named sites, so every injected fault — and therefore every
recovery path it exercises — replays bit-for-bit from ``(seed, workload)``.

Sites (``FaultPlan.SITES``), each consulted by `repro_torch.serve.engine.ServeEngine`
at exactly one place in the cycle:

* ``alloc_fail`` — consulted in ``_alloc_page`` before every pool
  allocation; a firing simulates a failed allocation, which the engine
  recovers from by preempting a victim (the same path real commitment-budget
  exhaustion takes under ``reserve_policy="expected"``);
* ``forced_preempt`` — consulted once per cycle; a firing preempts the
  victim the engine's ``preempt_policy`` would choose, unprovoked;
* ``delayed_release`` — consulted at retirement; a firing holds the
  retiring request's pages out of the free list for ``delay_cycles`` engine
  cycles (modelling asynchronous device-side release) before freeing them;
* ``poison_logits`` — consulted per active request per cycle; a firing
  overwrites that request's logits row with NaN *after* the decode step,
  exercising the engine's step-level error isolation (the request retires
  ``ERRORED``; the engine loop and every other request are unaffected);
* ``evict_storm`` — consulted once per cycle (schedule phase); a firing
  force-reclaims up to ``storm_pages`` pages from the pool's RETAINED tier
  (LRU order, prefix index invalidated atomically —
  ``PagePool.reclaim_retained``), exercising retention-tier invalidation:
  a post-storm admission must fall back to a cold prefill with outputs
  bitwise unchanged.

Determinism: each site draws from its own ``numpy`` Generator seeded from
``(seed, site)``, and decisions depend only on the site's consultation
count — never on wall clock, interleaving with other sites, or dict order.
Two runs of the same workload with equal-seed plans take identical
decisions; ``FaultPlan.log`` records every firing (site, cycle, uid,
consultation index) so tests can assert the replay.

Targeted (non-random) injection: ``fire_at={"alloc_fail": (3,)}`` fires a
site at exact consultation indices, composable with rates.  ``max_fires``
caps firings per site (e.g. poison exactly one row over a whole run).

Schedule-invariant targeting: ``fire_at_token={"poison_logits":
{(uid, k)}}`` fires when the site is consulted for request ``uid`` at
decode progress ``k`` (the engine passes ``progress=len(req.out_tokens)``).
Unlike consultation indices — which depend on how many cycles ran and how
many requests were active in each — a ``(uid, progress)`` key names a point
on the *request's own* token stream, so the firing replays identically
under any scheduling: preempted vs unpressured, different admission
interleavings.
"""
from __future__ import annotations

import numpy as np

#: the named engine sites, in consultation-stream order
SITES = ("alloc_fail", "forced_preempt", "delayed_release", "poison_logits",
         "evict_storm")


class FaultPlan:
    """A seeded, replayable schedule of injected serving faults."""

    def __init__(self, seed: int = 0, *, alloc_fail: float = 0.0,
                 forced_preempt: float = 0.0, delayed_release: float = 0.0,
                 poison_logits: float = 0.0, evict_storm: float = 0.0,
                 delay_cycles: int = 2, storm_pages: int = 4,
                 max_fires: dict | None = None, fire_at: dict | None = None,
                 fire_at_token: dict | None = None):
        """``alloc_fail``/``forced_preempt``/``delayed_release``/
        ``poison_logits``/``evict_storm`` are per-consultation firing
        probabilities in ``[0, 1]``.  ``delay_cycles`` is how long a delayed
        release parks pages; ``storm_pages`` is how many retained pages one
        ``evict_storm`` firing reclaims (LRU-first; fewer when the tier is
        shallower).  ``max_fires`` maps site → max total firings; ``fire_at``
        maps site → iterable of 0-based consultation indices that fire
        unconditionally (deterministic targeting); ``fire_at_token`` maps
        site → iterable of ``(uid, progress)`` pairs that fire when the
        site is consulted for that request at that decode progress
        (schedule-invariant targeting — see module docstring)."""
        rates = {
            "alloc_fail": alloc_fail,
            "forced_preempt": forced_preempt,
            "delayed_release": delayed_release,
            "poison_logits": poison_logits,
            "evict_storm": evict_storm,
        }
        for site, rate in rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{site} rate {rate} outside [0, 1]")
        for site in (dict(max_fires or {}) | dict(fire_at or {})
                     | dict(fire_at_token or {})):
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r}")
        self.seed = seed
        self.rates = rates
        self.delay_cycles = delay_cycles
        self.storm_pages = storm_pages
        self.max_fires = dict(max_fires or {})
        self.fire_at = {
            site: frozenset(idx) for site, idx in (fire_at or {}).items()
        }
        self.fire_at_token = {
            site: frozenset((uid, int(k)) for uid, k in pairs)
            for site, pairs in (fire_at_token or {}).items()
        }
        # one independent stream per site: the decision sequence of a site
        # depends only on how many times IT was consulted
        self._rng = {
            site: np.random.default_rng(
                np.random.SeedSequence(entropy=seed, spawn_key=(i,))
            )
            for i, site in enumerate(SITES)
        }
        self._consults = {site: 0 for site in SITES}
        self._fired = {site: 0 for site in SITES}
        #: every firing, in order: {"site", "cycle", "uid", "consult"}
        self.log: list[dict] = []
        #: optional observer called as ``on_fire(site, cycle, uid)`` at each
        #: firing — the engine attaches its telemetry hook here (counting
        #: and tracing injected faults never influences the decisions)
        self.on_fire = None

    def fires(self, site: str, *, cycle: int, uid=None,
              progress: int | None = None) -> bool:
        """Consult ``site``; True when the plan injects a fault here.
        ``cycle``/``uid`` only annotate the log — they never influence a
        rate or ``fire_at`` decision (determinism by consultation count).
        ``progress`` (with ``uid``) additionally keys the schedule-invariant
        ``fire_at_token`` targets."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        n = self._consults[site]
        self._consults[site] += 1
        rate = self.rates[site]
        hit = n in self.fire_at.get(site, ())
        if (not hit and progress is not None
                and (uid, progress) in self.fire_at_token.get(site, ())):
            hit = True
        if not hit and rate > 0.0:
            hit = bool(self._rng[site].random() < rate)
        if hit and self._fired[site] >= self.max_fires.get(site, np.inf):
            hit = False
        if hit:
            self._fired[site] += 1
            self.log.append(
                {"site": site, "cycle": cycle, "uid": uid, "consult": n}
            )
            if self.on_fire is not None:
                self.on_fire(site, cycle, uid)
        return hit

    def fired(self, site: str) -> int:
        """Total firings of ``site`` so far."""
        return self._fired[site]

    def consulted(self, site: str) -> int:
        """Total consultations of ``site`` so far."""
        return self._consults[site]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        active = {s: r for s, r in self.rates.items() if r} or dict(self.fire_at)
        return (f"FaultPlan(seed={self.seed}, sites={active}, "
                f"fired={sum(self._fired.values())})")
