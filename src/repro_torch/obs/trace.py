"""Span tracer: where does a query's time actually go?

A :class:`Tracer` records nested spans — plan / pack / compile / dispatch /
device-wait / unpack — into a bounded ring buffer and exports them as
Chrome trace-event JSON (``chrome://tracing`` / Perfetto's legacy format:
``"ph": "X"`` complete events with microsecond ``ts``/``dur``).  Spans
carry attributes (bucket, backend, batch size, ...) in the event ``args``.

Design points:

* **near-zero overhead when disabled** — the module-default tracer is the
  :data:`NULL_TRACER` singleton whose ``span()`` returns one shared no-op
  context manager: no clock read, no allocation, no lock;
* **thread-safe** — spans from concurrent callers interleave safely
  (the ring is lock-guarded; ``tid`` is the recording thread, so the
  Chrome viewer lays concurrent work out on separate tracks);
* **bounded** — the ring keeps the most recent ``capacity`` events, so a
  long-lived serving session can leave tracing on without growing
  memory.

Timestamps come from the observability clock (:mod:`repro_torch.obs.clock`),
so traces, metrics, and deadline accounting share one timeline.  While a
``torch.profiler`` records, a span also opens a
``torch.profiler.record_function`` range of its name, so the spans sit on
the device trace's own timeline too.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import os
import threading
from typing import Any

import torch

from .clock import now as _now

__all__ = [
    "Span",
    "Tracer",
    "NullTracer",
    "NULL_TRACER",
    "current_tracer",
    "use_tracer",
    "export_trace",
]


class Span:
    """One in-flight span; records a complete ("X") event on exit.

    ``attrs`` may be extended while the span is open
    (``sp.attrs["batch"] = 4``); the dict is written into the event's
    ``args`` at close.  Opened while a ``torch.profiler`` records, the span
    also holds a ``record_function`` range of its name.
    """

    __slots__ = ("_tracer", "name", "attrs", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._range = None

    def __enter__(self) -> "Span":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = _now()
        return self

    def __exit__(self, *exc) -> None:
        t1 = _now()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._tracer._record(self.name, self._t0, t1 - self._t0, self.attrs)


class _NullSpan:
    """Shared no-op span: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass

    @property
    def attrs(self) -> dict:
        return {}  # mutations are discarded — tracing is off

    name = ""


_NULL_SPAN = _NullSpan()


class Tracer:
    """Ring-buffered span recorder with Chrome trace-event export."""

    def __init__(self, *, capacity: int = 65536, enabled: bool = True):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._events: collections.deque[dict] = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0  # events evicted by the ring

    # -- recording ----------------------------------------------------- #
    def span(self, name: str, **attrs):
        """Context manager timing one named span (nesting by call stack)."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        """A zero-duration marker ("i" event) — e.g. deadline-miss."""
        if not self.enabled:
            return
        ev = {
            "name": name,
            "ph": "i",
            "ts": _now() * 1e6,
            "s": "t",
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if attrs:
            ev["args"] = attrs
        self._push(ev)

    def _record(self, name: str, t0: float, dur: float, attrs: dict) -> None:
        ev = {
            "name": name,
            "ph": "X",
            "ts": t0 * 1e6,
            "dur": dur * 1e6,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFFFFFF,
        }
        if attrs:
            ev["args"] = {k: _jsonable(v) for k, v in attrs.items()}
        self._push(ev)

    def _push(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    # -- reading / export ---------------------------------------------- #
    def events(self) -> list[dict]:
        """The buffered events, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self, path: str) -> str:
        """Write Chrome trace-event JSON; returns ``path``.

        Load via ``chrome://tracing``, Perfetto ("legacy JSON"), or
        ``json.load`` (``{"traceEvents": [...]}``).
        """
        doc = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }
        with open(path, "w") as f:
            json.dump(doc, f)
        return str(path)


class NullTracer(Tracer):
    """Permanently disabled tracer (the module default)."""

    def __init__(self):
        super().__init__(capacity=1, enabled=False)

    def span(self, name: str, **attrs):
        return _NULL_SPAN

    def instant(self, name: str, **attrs) -> None:
        pass


NULL_TRACER = NullTracer()


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# ---------------------------------------------------------------------- #
# Context plumbing: whose trace are we recording into?
# ---------------------------------------------------------------------- #
_current: contextvars.ContextVar[Tracer | None] = contextvars.ContextVar(
    "repro_obs_tracer", default=None
)


def current_tracer() -> Tracer:
    """The context-installed tracer, else the no-op :data:`NULL_TRACER`.

    Instrumented library code (planner, exec, stream) records here; a
    traced session installs its tracer for the duration of its work
    (``Observability.activate``), and untraced paths cost one contextvar
    read per span site.
    """
    return _current.get() or NULL_TRACER


@contextlib.contextmanager
def use_tracer(tracer: Tracer):
    """Scoped install: record this context's spans into ``tracer``."""
    token = _current.set(tracer)
    try:
        yield tracer
    finally:
        _current.reset(token)


def export_trace(path: str, tracer: Tracer | None = None) -> str:
    """Export ``tracer`` (default: the context-current one) to ``path``."""
    return (tracer or current_tracer()).export(path)
