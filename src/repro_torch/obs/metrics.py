"""Metrics registry: named counters / gauges / histograms with label sets.

One thread-safe registry replaces the ad-hoc counter dicts that grew all
over the serving stack (``CacheStats`` ints, ``ENUM_COUNTS``, per-object
``stats()`` tallies).  Instruments are identified by ``(name, labels)``
where labels are keyword pairs (``inc("dispatches", bucket=..., backend=...)``),
so per-(bucket, backend) breakdowns — the data the planner's cost-model
calibration needs — fall out of the key structure instead of bespoke
dicts.

Registries **chain to a parent**: a :class:`repro_torch.api.Session` owns a
private registry parented to the process-global default, so per-session
metrics stay isolated (concurrent sessions / test runs don't pollute
each other) while the global view still aggregates everything.  Library
code that has no session handle records into :func:`current_registry`
— the session installs its registry for the duration of its work via
``use_registry`` (see ``Observability.activate``), and standalone calls
fall through to the global default.

Exports: :meth:`MetricsRegistry.snapshot` (JSON-able dict) and
:meth:`MetricsRegistry.prometheus_text` (Prometheus text exposition,
ready for a scrape endpoint or a textfile collector).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
import re
import threading
from typing import Iterable, Mapping

__all__ = [
    "DEFAULT_BUCKETS",
    "HistogramData",
    "MetricsRegistry",
    "get_registry",
    "current_registry",
    "use_registry",
    "metrics_snapshot",
    "prometheus_text",
]

# Seconds-flavored default: spans 10 µs .. 100 s, the range of everything
# we time (plan µs through cold-compile seconds).  Call sites with
# different units (iterations, ratios, fractions) pass buckets=.
DEFAULT_BUCKETS = (
    1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0,
)

_LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: Mapping[str, object]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape_label(value: str) -> str:
    """Backslash-escape the characters ``_fmt_key`` uses structurally."""
    return (
        value.replace("\\", "\\\\").replace(",", "\\,").replace("=", "\\=")
    )


def _split_unescaped(text: str, sep: str) -> list[str]:
    """Split on ``sep`` occurrences not preceded by a backslash escape."""
    parts: list[str] = []
    buf: list[str] = []
    i = 0
    while i < len(text):
        c = text[i]
        if c == "\\" and i + 1 < len(text):
            buf.append(c)
            buf.append(text[i + 1])
            i += 2
            continue
        if c == sep:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(c)
        i += 1
    parts.append("".join(buf))
    return parts


def _unescape_label(value: str) -> str:
    out: list[str] = []
    i = 0
    while i < len(value):
        if value[i] == "\\" and i + 1 < len(value):
            out.append(value[i + 1])
            i += 2
        else:
            out.append(value[i])
            i += 1
    return "".join(out)


def _fmt_key(name: str, labels: _LabelKey) -> str:
    if not labels:
        return name
    # Label values are escaped so a value containing "," or "=" (graph
    # names, backend strings) still round-trips through _parse_key.
    inner = ",".join(f"{k}={_escape_label(v)}" for k, v in labels)
    return f"{name}{{{inner}}}"


def _parse_key(key: str) -> tuple[str, dict[str, str]]:
    """Invert :func:`_fmt_key`: ``"name{a=b,c=d}"`` -> (name, labels)."""
    if "{" not in key or not key.endswith("}"):
        return key, {}
    name, inner = key.split("{", 1)
    labels: dict[str, str] = {}
    for pair in _split_unescaped(inner[:-1], ","):
        if pair:
            # Split on the first unescaped "=": the key never contains
            # one, and "="s inside the value arrive escaped.
            head, *rest = _split_unescaped(pair, "=")
            labels[_unescape_label(head)] = _unescape_label("=".join(rest))
    return name, labels


class HistogramData:
    """One histogram series: cumulative-bucket counts + sum/min/max.

    Bucket bounds are fixed at first observation (later ``buckets=``
    arguments for the same series are ignored) with an implicit +inf
    overflow bucket, Prometheus-style.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max")

    def __init__(self, bounds: Iterable[float]):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError(f"histogram bounds must be sorted: {self.bounds}")
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        i = 0
        for b in self.bounds:
            if value <= b:
                break
            i += 1
        self.counts[i] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def row(self) -> dict:
        buckets = {}
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            buckets[f"{b:g}"] = cum
        buckets["+Inf"] = self.count
        return {
            "count": self.count,
            "sum": round(self.sum, 9),
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": round(self.mean, 9),
            "buckets": buckets,
        }


class MetricsRegistry:
    """Thread-safe counters / gauges / histograms with label sets."""

    def __init__(self, *, parent: "MetricsRegistry | None" = None):
        self.parent = parent
        self._lock = threading.Lock()
        self._counters: dict[tuple[str, _LabelKey], float] = {}
        self._gauges: dict[tuple[str, _LabelKey], float] = {}
        self._histograms: dict[tuple[str, _LabelKey], HistogramData] = {}

    # -- write side ---------------------------------------------------- #
    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add ``value`` to counter ``name{labels}`` (and the parent's)."""
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value
        if self.parent is not None:
            self.parent.inc(name, value, **labels)

    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Set gauge ``name{labels}`` to ``value`` (last write wins)."""
        key = (name, _label_key(labels))
        with self._lock:
            self._gauges[key] = float(value)
        if self.parent is not None:
            self.parent.set_gauge(name, value, **labels)

    def observe(
        self,
        name: str,
        value: float,
        *,
        buckets: Iterable[float] | None = None,
        **labels,
    ) -> None:
        """Record ``value`` into histogram ``name{labels}``."""
        key = (name, _label_key(labels))
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = HistogramData(
                    buckets if buckets is not None else DEFAULT_BUCKETS
                )
            h.observe(float(value))
        if self.parent is not None:
            self.parent.observe(name, value, buckets=buckets, **labels)

    def ingest(self, counters: Mapping[str, float], **labels) -> None:
        """Mirror another process's cumulative counters into this registry.

        ``counters`` maps snapshot keys — plain names or the
        ``name{k=v,...}`` strings :meth:`snapshot` emits — to cumulative
        values read from a remote source (e.g. a replica's
        ``HealthReport``).  Each series is recorded as a **gauge** (last
        write wins): the remote values are already totals, so replaying
        them through :meth:`inc` on every poll would double-count.
        ``labels`` are merged into every series (``replica=...``), which
        keeps a fleet roll-up per-source while the parent chain still
        aggregates the whole fleet in one snapshot."""
        for key, value in counters.items():
            name, parsed = _parse_key(str(key))
            self.set_gauge(name, float(value), **{**parsed, **labels})

    # -- read side ----------------------------------------------------- #
    def value(self, name: str, **labels) -> float:
        """Current counter value (0.0 if never incremented)."""
        with self._lock:
            return self._counters.get((name, _label_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> float:
        with self._lock:
            return self._gauges.get((name, _label_key(labels)), 0.0)

    def histogram(self, name: str, **labels) -> HistogramData | None:
        with self._lock:
            return self._histograms.get((name, _label_key(labels)))

    def histograms_named(self, name: str) -> dict[str, HistogramData]:
        """Every label-series of histogram ``name`` (formatted-key map)."""
        with self._lock:
            return {
                _fmt_key(n, lk): h
                for (n, lk), h in self._histograms.items()
                if n == name
            }

    def snapshot(self) -> dict:
        """JSON-able view: ``{"counters": .., "gauges": .., "histograms": ..}``.

        Keys are ``name{label=value,...}`` strings (labels sorted), so the
        snapshot round-trips through ``json.dumps`` unchanged.
        """
        with self._lock:
            return {
                "counters": {
                    _fmt_key(n, lk): v for (n, lk), v in sorted(self._counters.items())
                },
                "gauges": {
                    _fmt_key(n, lk): v for (n, lk), v in sorted(self._gauges.items())
                },
                "histograms": {
                    _fmt_key(n, lk): h.row()
                    for (n, lk), h in sorted(self._histograms.items())
                },
            }

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        out: list[str] = []
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
        seen: set[str] = set()
        for (name, lk), v in counters:
            pname = _prom_name(name)
            if pname not in seen:
                seen.add(pname)
                out.append(f"# TYPE {pname} counter")
            out.append(f"{pname}{_prom_labels(lk)} {v:g}")
        for (name, lk), v in gauges:
            pname = _prom_name(name)
            if pname not in seen:
                seen.add(pname)
                out.append(f"# TYPE {pname} gauge")
            out.append(f"{pname}{_prom_labels(lk)} {v:g}")
        for (name, lk), h in hists:
            pname = _prom_name(name)
            if pname not in seen:
                seen.add(pname)
                out.append(f"# TYPE {pname} histogram")
            cum = 0
            for b, c in zip(h.bounds, h.counts):
                cum += c
                out.append(
                    f"{pname}_bucket{_prom_labels(lk, le=f'{b:g}')} {cum}"
                )
            out.append(f"{pname}_bucket{_prom_labels(lk, le='+Inf')} {h.count}")
            out.append(f"{pname}_sum{_prom_labels(lk)} {h.sum:g}")
            out.append(f"{pname}_count{_prom_labels(lk)} {h.count}")
        return "\n".join(out) + ("\n" if out else "")

    def reset(self) -> None:
        """Drop every recorded series (test/bench isolation helper)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return name if not name[:1].isdigit() else "_" + name


def _prom_labels(lk: _LabelKey, **extra: str) -> str:
    pairs = [*lk, *extra.items()]
    if not pairs:
        return ""
    inner = ",".join(f'{_NAME_RE.sub("_", k)}="{v}"' for k, v in pairs)
    return "{" + inner + "}"


# ---------------------------------------------------------------------- #
# The default (process-global) registry + the context-scoped current one
# ---------------------------------------------------------------------- #
_default_registry = MetricsRegistry()
_current: contextvars.ContextVar[MetricsRegistry | None] = contextvars.ContextVar(
    "repro_obs_metrics", default=None
)


def get_registry() -> MetricsRegistry:
    """The process-global default registry (every session's parent)."""
    return _default_registry


def current_registry() -> MetricsRegistry:
    """The context-installed registry, else the global default.

    Library code without a session handle (``repro.stream.frontier``,
    ``repro_torch.exec.peel``) records here; a session's ``activate()`` scope
    redirects it to the session's own registry.
    """
    return _current.get() or _default_registry


@contextlib.contextmanager
def use_registry(registry: MetricsRegistry):
    """Scoped install: record this context's metrics into ``registry``."""
    token = _current.set(registry)
    try:
        yield registry
    finally:
        _current.reset(token)


def metrics_snapshot(registry: MetricsRegistry | None = None) -> dict:
    """JSON snapshot of ``registry`` (default: the global registry)."""
    return (registry or _default_registry).snapshot()


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    """Prometheus exposition of ``registry`` (default: the global registry)."""
    return (registry or _default_registry).prometheus_text()
