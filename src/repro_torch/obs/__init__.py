"""repro_torch.obs — unified tracing, metrics, and load-imbalance telemetry.

The one instrument layer for the whole query path.  Three pieces:

* :mod:`.trace`      — thread-safe span tracer (plan / pack / compile /
                       dispatch / device-wait / unpack), ring-buffered,
                       exported as Chrome trace-event JSON
                       (``obs.export_trace(path)``);
* :mod:`.metrics`    — named counters / gauges / histograms with label
                       sets, JSON snapshot (``obs.metrics_snapshot()``)
                       and Prometheus text exposition
                       (``obs.prometheus_text()``);
* :mod:`.peel_stats` — the paper's load-imbalance statistic observed at
                       runtime: per-slot iteration / level / alive-edge
                       histograms per ``(bucket, backend)``, feeding the
                       planner's future cost-model calibration.

Plus :mod:`.clock`, the single time source (fake-able in tests) behind
every duration, deadline, and trace timestamp.

Turn tracing on per session (``Session(trace="trace.json")``), per call
(``solve(qs, trace="trace.json")``), or process-wide via the
``REPRO_TRACE=path`` environment variable.  Disabled, the tracer is a
shared no-op singleton — no clock reads, no allocation.

An :class:`Observability` bundle (tracer + metrics + export path) is what
a :class:`repro_torch.api.Session` owns; ``activate()`` installs it as the
context-current sink so instrumented library code (planner, exec,
stream) records into the owning session without explicit threading.
"""

from __future__ import annotations

import contextlib
import os

from .clock import (
    Clock,
    FakeClock,
    MonotonicClock,
    get_clock,
    now,
    remaining,
    set_clock,
    use_clock,
)
from .metrics import (
    DEFAULT_BUCKETS,
    HistogramData,
    MetricsRegistry,
    current_registry,
    get_registry,
    metrics_snapshot,
    prometheus_text,
    use_registry,
)
from .peel_stats import (
    EDGE_BUCKETS,
    IMBALANCE_BUCKETS,
    ITER_BUCKETS,
    PeelBatchTelemetry,
    imbalance_summary,
    record_peel_batch,
)
from .trace import (
    NULL_TRACER,
    NullTracer,
    Span,
    Tracer,
    current_tracer,
    export_trace,
    use_tracer,
)

__all__ = [
    # clock
    "Clock",
    "MonotonicClock",
    "FakeClock",
    "get_clock",
    "set_clock",
    "use_clock",
    "now",
    "remaining",
    # metrics
    "MetricsRegistry",
    "HistogramData",
    "DEFAULT_BUCKETS",
    "get_registry",
    "current_registry",
    "use_registry",
    "metrics_snapshot",
    "prometheus_text",
    # tracing
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "Span",
    "current_tracer",
    "use_tracer",
    "export_trace",
    # peel telemetry
    "record_peel_batch",
    "PeelBatchTelemetry",
    "imbalance_summary",
    "ITER_BUCKETS",
    "EDGE_BUCKETS",
    "IMBALANCE_BUCKETS",
    # the session-owned bundle
    "Observability",
    "TRACE_ENV_VAR",
]

TRACE_ENV_VAR = "REPRO_TRACE"


class Observability:
    """One session's instrument bundle: tracer + metrics + export path.

    ``trace`` selects the tracing mode:
      * ``None``  — consult the ``REPRO_TRACE`` env var: unset/empty means
        disabled; a path means trace and export there;
      * ``False`` — disabled (the shared no-op tracer);
      * ``True``  — trace in memory (export via :meth:`export_trace`);
      * a path    — trace and export there (the session auto-exports
        after ``solve()``/``flush()``).

    The metrics registry is private to the bundle and chains to the
    process-global default, so per-session metrics stay isolated while
    the global view aggregates (``repro_torch.obs.metrics_snapshot()``).
    """

    def __init__(
        self,
        *,
        trace: bool | str | None = None,
        metrics: MetricsRegistry | None = None,
        capacity: int = 65536,
    ):
        if trace is None:
            trace = os.environ.get(TRACE_ENV_VAR) or False
        self.trace_path: str | None = trace if isinstance(trace, str) else None
        enabled = bool(trace)
        self.tracer: Tracer = Tracer(capacity=capacity) if enabled else NULL_TRACER
        self.metrics = (
            metrics
            if metrics is not None
            else MetricsRegistry(parent=get_registry())
        )

    @property
    def tracing(self) -> bool:
        return self.tracer.enabled

    @contextlib.contextmanager
    def activate(self):
        """Make this bundle the context-current metrics/tracer sink."""
        with use_registry(self.metrics), use_tracer(self.tracer):
            yield self

    def export_trace(self, path: str | None = None) -> str | None:
        """Write the Chrome trace JSON (to ``path`` or the configured one).

        Returns the written path, or ``None`` when tracing is disabled or
        no path is known.
        """
        path = path or self.trace_path
        if path is None or not self.tracer.enabled:
            return None
        return self.tracer.export(path)

    def metrics_snapshot(self) -> dict:
        """JSON snapshot of this bundle's (session-scoped) metrics."""
        return self.metrics.snapshot()

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()
