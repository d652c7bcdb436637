"""Serving subsystem of the port: the continuous-batching scheduler, the
page-pool allocator, the paged ``ServeEngine`` (the synchronous cycle and
the async overlapped runtime, whose decode step is one CUDA graph replay),
its invariant auditor and seeded fault injection, and the telemetry layer
(metrics registry, event tracer)."""
from repro_torch.serve.async_runtime import CompletionWorker, DeadlockError  # noqa: F401
from repro_torch.serve.audit import AuditError, AuditReport, audit_engine  # noqa: F401
from repro_torch.serve.engine import TIMING_SUMMARY_KEYS, ServeEngine  # noqa: F401
from repro_torch.serve.faults import FaultPlan  # noqa: F401
from repro_torch.serve.pages import PagePool  # noqa: F401
from repro_torch.serve.scheduler import Phase, Request, Scheduler  # noqa: F401
from repro_torch.serve.telemetry import (  # noqa: F401
    MetricsRegistry,
    Tracer,
    validate_events,
)
