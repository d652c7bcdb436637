"""Serving telemetry: metrics registry + structured per-request event tracer
(the port's copy of the JAX package's ``serve/telemetry.py``; host-side,
framework-free).

Two cooperating pieces, both pure host-side (no device work, no effect on
any computed value — the bitwise-parity suites run with telemetry enabled):

**MetricsRegistry** — named :class:`Counter` / :class:`Gauge` /
:class:`Histogram` instruments replacing the engine's ad-hoc ``stats``
dict.  Histograms are *log-bucketed*: bucket ``i`` covers
``(lo * growth**(i-1), lo * growth**i]`` so a fixed relative error
(``growth - 1``, ~9% at the default ``growth = 2**0.125``) holds across
nine decades of latency without preallocating buckets — sub-microsecond
host hops and minute-long request lifetimes share one instrument.
Percentiles interpolate inside the resolved bucket and clamp to the
observed min/max (exact at the extremes).  The registry exports a plain
``snapshot()`` dict and a Prometheus text exposition
(:meth:`MetricsRegistry.to_prometheus`).

**Tracer** — an append-only structured event log of the serving engine's
execution:

* *request lifecycle spans*: ``queue`` (submit -> admit), ``prefill``
  (admit -> adoption), ``decode`` (adoption -> retirement), re-opened
  ``queue`` after a preemption requeue — every span carries the request
  uid;
* *engine phase spans*: one complete event per cycle phase (``schedule``,
  ``prefill``, ``decode_dispatch``, ``device_wait``, ``advance`` —
  serve/engine.py's phase-timing breakdown);
* *point events*: ``submit``, ``cow``, ``preempt``, ``replay_done``,
  ``spec_verify``, ``audit``, ``fault``, ``rejected`` and the terminal
  phase markers (``done`` / ``preempted`` / ``expired`` / ``cancelled`` /
  ``errored``).

Events export as JSONL (one event dict per line, schema documented in
docs/OBSERVABILITY.md) and as Chrome ``trace_event`` JSON
(:meth:`Tracer.chrome_trace`) that opens directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``: pid 0 is the engine
(phase track), pid 1 holds one track per request uid.

:func:`validate_events` is the schema checker the tests (and the invariant
auditor, when a tracer is attached) run over a finished trace: every span
closed, per-request span sequences alternating and time-ordered, and every
referenced request uid resolving to a submitted request.

The tracer costs one dict append per event when enabled and **nothing when
disabled**: the engine holds ``tracer = None`` and every call site is
guarded, so a production run pays only the perf_counter reads of the
always-on phase-timing breakdown.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

#: terminal request events a trace may contain without a preceding span
#: (a REJECTED submission never opens a lifecycle span)
_UNSPANNED_EVENTS = frozenset({"rejected"})


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------


class Counter:
    """Monotonically increasing named value (float so second-sums fit)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        self.value += n


class Gauge:
    """Last-set value plus the high/low water marks since creation."""

    __slots__ = ("name", "help", "value", "hi", "lo", "_seen")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0
        self.hi = 0.0
        self.lo = 0.0
        self._seen = False

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        if not self._seen:
            self.hi = self.lo = v
            self._seen = True
        else:
            self.hi = max(self.hi, v)
            self.lo = min(self.lo, v)


class Histogram:
    """Log-bucketed histogram with bounded relative error.

    Bucket 0 covers ``[0, lo]`` (and any non-positive sample); bucket
    ``i >= 1`` covers ``(lo * growth**(i-1), lo * growth**i]``.  Buckets are
    a sparse dict, so the instrument is O(observed decades), not O(range).
    :meth:`percentile` resolves the bucket holding the requested rank
    (numpy's ``linear`` rank convention), interpolates linearly inside it,
    and clamps to the exact observed min/max — the estimate is within one
    bucket width (relative error ``growth - 1``) of the numpy oracle,
    the same estimator as the JAX package's.
    """

    __slots__ = ("name", "help", "lo", "growth", "_log_g", "counts", "n",
                 "total", "vmin", "vmax")

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-7,
                 growth: float = 2 ** 0.125):
        if lo <= 0 or growth <= 1.0:
            raise ValueError(f"histogram {name}: need lo > 0, growth > 1")
        self.name = name
        self.help = help
        self.lo = lo
        self.growth = growth
        self._log_g = math.log(growth)
        self.counts: dict[int, int] = {}
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def bucket_edge(self, i: int) -> float:
        """Upper (inclusive) edge of bucket ``i``."""
        return self.lo * self.growth ** i

    def _bucket(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = max(1, math.ceil(math.log(v / self.lo) / self._log_g))
        if self.bucket_edge(i) < v:  # float fuzz at an exact edge
            i += 1
        return i

    def record(self, v: float) -> None:
        v = float(v)
        i = self._bucket(v)
        self.counts[i] = self.counts.get(i, 0) + 1
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def percentile(self, q: float) -> float:
        """Estimate of the ``q``-th percentile (``q`` in [0, 100])."""
        if self.n == 0:
            return 0.0
        rank = (q / 100.0) * (self.n - 1)
        if rank <= 0:
            return self.vmin
        if rank >= self.n - 1:
            return self.vmax
        cum = 0
        for i in sorted(self.counts):
            c = self.counts[i]
            if cum + c > rank:
                low = 0.0 if i == 0 else self.bucket_edge(i - 1)
                high = self.bucket_edge(i)
                frac = min(max((rank - cum + 0.5) / c, 0.0), 1.0)
                val = low + frac * (high - low)
                return min(max(val, self.vmin), self.vmax)
            cum += c
        return self.vmax

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def summary(self) -> dict:
        return {
            "count": self.n,
            "sum": self.total,
            "min": self.vmin if self.n else 0.0,
            "max": self.vmax if self.n else 0.0,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Named instrument store with get-or-create semantics.

    One registry serves the whole engine stack (engine + scheduler + pool);
    names are flat strings (the scheduler prefixes its own with ``sched_``).
    A name registered as one instrument kind cannot be re-registered as
    another — the drift that silently zeroes a dashboard.
    """

    def __init__(self, namespace: str = "repro_serve"):
        self.namespace = namespace
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    # -- get-or-create ----------------------------------------------------

    def _claim(self, name: str, kind: str) -> None:
        others = {
            "counter": (self._gauges, self._hists),
            "gauge": (self._counters, self._hists),
            "histogram": (self._counters, self._gauges),
        }[kind]
        if any(name in d for d in others):
            raise ValueError(
                f"metric {name!r} already registered as a different kind"
            )

    def counter(self, name: str, help: str = "") -> Counter:
        c = self._counters.get(name)
        if c is None:
            self._claim(name, "counter")
            c = self._counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            self._claim(name, "gauge")
            g = self._gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            self._claim(name, "histogram")
            h = self._hists[name] = Histogram(name, help, **kw)
        return h

    # -- convenience write paths ------------------------------------------

    def inc(self, name: str, n: float = 1.0) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).record(v)

    def value(self, name: str, default: float = 0.0) -> float:
        """Current value of a counter or gauge (0/default when absent)."""
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            return self._gauges[name].value
        return default

    def hist(self, name: str) -> Histogram | None:
        return self._hists.get(name)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict view: counters, gauges (value/hi/lo), histogram
        summaries (count/sum/min/max/mean/p50/p90/p99)."""
        return {
            "counters": {n: c.value for n, c in self._counters.items()},
            "gauges": {
                n: {"value": g.value, "hi": g.hi, "lo": g.lo}
                for n, g in self._gauges.items()
            },
            "histograms": {n: h.summary() for n, h in self._hists.items()},
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (one fully-qualified family per
        instrument; histograms expose cumulative ``_bucket`` series plus
        ``_sum`` / ``_count``)."""
        ns = self.namespace
        lines: list[str] = []
        for n, c in sorted(self._counters.items()):
            lines.append(f"# TYPE {ns}_{n} counter")
            lines.append(f"{ns}_{n} {_fmt(c.value)}")
        for n, g in sorted(self._gauges.items()):
            lines.append(f"# TYPE {ns}_{n} gauge")
            lines.append(f"{ns}_{n} {_fmt(g.value)}")
        for n, h in sorted(self._hists.items()):
            lines.append(f"# TYPE {ns}_{n} histogram")
            cum = 0
            for i in sorted(h.counts):
                cum += h.counts[i]
                lines.append(
                    f'{ns}_{n}_bucket{{le="{h.bucket_edge(i):.6g}"}} {cum}'
                )
            lines.append(f'{ns}_{n}_bucket{{le="+Inf"}} {h.n}')
            lines.append(f"{ns}_{n}_sum {_fmt(h.total)}")
            lines.append(f"{ns}_{n}_count {h.n}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class Tracer:
    """Append-only structured event log with span tracking.

    Event record (the JSONL schema — see docs/OBSERVABILITY.md):

    ``{"ph": "B"|"E"|"i"|"X", "name": str, "cat": str, "ts_us": int,
    "dur_us": int (X only), "uid": int|None, "args": dict|None}``

    ``ph`` follows the Chrome trace_event phase letters: span begin/end,
    instant, and complete (begin + duration in one record).  ``ts_us`` is
    microseconds since tracer construction on ``clock`` (default
    ``time.perf_counter`` — always the real wall clock, independent of any
    fake engine clock injected for TTL tests).
    """

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else time.perf_counter
        self._t0 = self.clock()
        self.events: list[dict] = []
        self._open: dict[tuple, int] = {}  # (cat, name, uid) -> event index

    # -- time --------------------------------------------------------------

    def now_us(self, ts: float | None = None) -> int:
        """Microseconds since tracer start (``ts``: a raw clock reading)."""
        t = self.clock() if ts is None else ts
        return max(0, int(round((t - self._t0) * 1e6)))

    # -- spans -------------------------------------------------------------

    def begin(self, name: str, *, uid=None, cat: str = "request",
              args: dict | None = None, ts: float | None = None) -> None:
        key = (cat, name, uid)
        if key in self._open:
            raise ValueError(f"span {key} begun twice without an end")
        ev = {"ph": "B", "name": name, "cat": cat,
              "ts_us": self.now_us(ts), "uid": uid, "args": args}
        self._open[key] = len(self.events)
        self.events.append(ev)

    def end(self, name: str, *, uid=None, cat: str = "request",
            args: dict | None = None, ts: float | None = None) -> None:
        key = (cat, name, uid)
        if key not in self._open:
            raise ValueError(f"end of span {key} that was never begun")
        del self._open[key]
        self.events.append(
            {"ph": "E", "name": name, "cat": cat, "ts_us": self.now_us(ts),
             "uid": uid, "args": args}
        )

    def end_open(self, *, uid, cat: str = "request",
                 args: dict | None = None) -> list[str]:
        """End every open span of ``uid`` under ``cat`` (a retirement does
        not need to know which lifecycle span is current).  Returns the
        names ended."""
        names = [k[1] for k in self._open if k[0] == cat and k[2] == uid]
        for name in names:
            self.end(name, uid=uid, cat=cat, args=args)
        return names

    def open_spans(self) -> list[tuple]:
        """Currently open ``(cat, name, uid)`` keys (audit hook)."""
        return list(self._open)

    # -- points ------------------------------------------------------------

    def instant(self, name: str, *, uid=None, cat: str = "event",
                args: dict | None = None, ts: float | None = None) -> None:
        self.events.append(
            {"ph": "i", "name": name, "cat": cat, "ts_us": self.now_us(ts),
             "uid": uid, "args": args}
        )

    def complete(self, name: str, *, t0: float, dur_s: float,
                 cat: str = "engine", uid=None,
                 args: dict | None = None) -> None:
        """One finished span with explicit start (raw clock reading ``t0``)
        and duration — the engine's per-cycle phase records."""
        self.events.append(
            {"ph": "X", "name": name, "cat": cat, "ts_us": self.now_us(t0),
             "dur_us": max(0, int(round(dur_s * 1e6))), "uid": uid,
             "args": args}
        )

    # -- export ------------------------------------------------------------

    def write_jsonl(self, path) -> Path:
        path = Path(path)
        with path.open("w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (dict form): pid 0 = the engine
        (phase spans + engine instants), pid 1 = requests, one tid per
        request uid.  Opens directly in Perfetto / chrome://tracing."""
        out = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]
        for ev in self.events:
            uid = ev.get("uid")
            rec = {
                "ph": ev["ph"],
                "name": (ev["name"] if uid is None
                         else f"{ev['name']} (req {uid})"),
                "cat": ev["cat"],
                "ts": ev["ts_us"],
                "pid": 0 if uid is None else 1,
                "tid": 0 if uid is None else uid,
            }
            if ev["ph"] == "X":
                rec["dur"] = ev.get("dur_us", 0)
            if ev["ph"] == "i":
                rec["s"] = "t"  # thread-scoped instant
            if ev.get("args"):
                rec["args"] = ev["args"]
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome(self, path) -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.chrome_trace()) + "\n")
        return path


def validate_events(events: list[dict]) -> list[str]:
    """Schema check over a finished trace; returns human-readable
    violations (empty == valid).

    * every ``B`` has a matching ``E`` (same cat/name/uid), none dangling,
      no double-begin, no end-without-begin;
    * per request uid, lifecycle span events alternate B/E with
      non-decreasing timestamps (a request is in at most one phase at a
      time, and its phases are time-ordered);
    * ``X`` events carry a non-negative ``dur_us``;
    * every uid referenced anywhere resolves to a request the trace saw
      submitted (a ``queue`` span begin) — except the explicitly unspanned
      terminal events (``rejected``).
    """
    out: list[str] = []
    open_spans: dict[tuple, dict] = {}
    per_uid: dict[object, list[dict]] = {}
    submitted: set = set()
    for ev in events:
        for field in ("ph", "name", "cat", "ts_us"):
            if field not in ev:
                out.append(f"event missing field {field!r}: {ev}")
                break
        else:
            ph, uid = ev["ph"], ev.get("uid")
            key = (ev["cat"], ev["name"], uid)
            if ph == "B":
                if key in open_spans:
                    out.append(f"double begin of span {key}")
                open_spans[key] = ev
                if ev["name"] == "queue" and uid is not None:
                    submitted.add(uid)
            elif ph == "E":
                start = open_spans.pop(key, None)
                if start is None:
                    out.append(f"end of never-begun span {key}")
                elif ev["ts_us"] < start["ts_us"]:
                    out.append(
                        f"span {key} ends at {ev['ts_us']}us before its "
                        f"begin at {start['ts_us']}us"
                    )
            elif ph == "X":
                if ev.get("dur_us", 0) < 0:
                    out.append(f"negative duration on {ev['name']}")
            elif ph != "i":
                out.append(f"unknown phase {ph!r} on {ev['name']}")
            if uid is not None and ph in ("B", "E"):
                per_uid.setdefault(uid, []).append(ev)
    for key in open_spans:
        out.append(f"span {key} never ended")
    for uid, evs in per_uid.items():
        last_ts = -1
        expect_begin = True
        for ev in evs:
            if (ev["ph"] == "B") != expect_begin:
                out.append(
                    f"request {uid}: lifecycle events do not alternate "
                    f"(saw {ev['ph']} {ev['name']} at {ev['ts_us']}us)"
                )
                break
            if ev["ts_us"] < last_ts:
                out.append(
                    f"request {uid}: timestamps regress at {ev['name']} "
                    f"({ev['ts_us']}us after {last_ts}us)"
                )
                break
            last_ts = ev["ts_us"]
            expect_begin = not expect_begin
    for ev in events:
        uid = ev.get("uid")
        if (uid is not None and uid not in submitted
                and ev["name"] not in _UNSPANNED_EVENTS):
            out.append(
                f"event {ev['name']} references unknown request uid {uid}"
            )
            break
    return out
