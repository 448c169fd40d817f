"""The observability clock: one time source for every instrument.

Every duration, deadline, and trace timestamp in the query path reads
this clock instead of calling ``time.perf_counter`` directly.  That buys
two things:

* **one timeline** — span timestamps, queue/deadline accounting, and
  metrics all agree, so a trace's ``dur`` fields and ``RequestStats``
  are the same numbers;
* **fake time in tests** — installing a :class:`FakeClock`
  (``with use_clock(FakeClock()): ...``) lets deadline/timeout tests
  advance time explicitly instead of sleeping.

The deadline helper :func:`remaining` is the single place "how much of
this query's budget is left" is computed; ``TrussFuture.result()`` and
the batch former both use it, so a fake clock moves every deadline
consistently.
"""

from __future__ import annotations

import contextlib
import contextvars
import time

__all__ = [
    "Clock",
    "MonotonicClock",
    "FakeClock",
    "get_clock",
    "set_clock",
    "use_clock",
    "now",
    "sleep",
    "remaining",
]


class Clock:
    """Monotonic seconds source (the perf_counter contract)."""

    def now(self) -> float:  # pragma: no cover - interface
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        """Block for ``dt`` seconds of this clock's time.

        The resilience layer's retry backoff waits through here, so a
        fake clock makes backoff tests instantaneous (time advances,
        nothing actually sleeps).
        """
        time.sleep(max(0.0, float(dt)))


class MonotonicClock(Clock):
    """The real clock: ``time.perf_counter``."""

    def now(self) -> float:
        return time.perf_counter()


class FakeClock(Clock):
    """Manually advanced clock for tests — no sleeping.

    ``advance(dt)`` moves time forward; ``now()`` never moves on its own,
    so a timeout loop under a fake clock either expires immediately (the
    budget is already spent) or never (nothing advances it).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards (dt={dt})")
        self._t += float(dt)

    def sleep(self, dt: float) -> None:
        self.advance(max(0.0, float(dt)))


_default_clock = MonotonicClock()
_current: contextvars.ContextVar[Clock | None] = contextvars.ContextVar(
    "repro_obs_clock", default=None
)


def get_clock() -> Clock:
    """The active clock: the context-installed one, else the real clock."""
    return _current.get() or _default_clock


def set_clock(clock: Clock | None) -> None:
    """Install ``clock`` for the current context (``None`` restores real time)."""
    _current.set(clock)


@contextlib.contextmanager
def use_clock(clock: Clock):
    """Scoped clock install: ``with use_clock(FakeClock()) as clk: ...``"""
    token = _current.set(clock)
    try:
        yield clock
    finally:
        _current.reset(token)


def now() -> float:
    """Current time on the active clock (monotonic seconds)."""
    return get_clock().now()


def sleep(dt: float) -> None:
    """Sleep ``dt`` seconds on the active clock (fake clocks just advance)."""
    get_clock().sleep(dt)


def remaining(submitted_at: float, deadline_s: float | None) -> float | None:
    """Seconds left of a query's deadline budget (the ONE deadline rule).

    ``None`` deadline means no budget (returns ``None``); otherwise the
    remainder is clamped at 0 — an expired deadline is "no time left",
    never negative.
    """
    if deadline_s is None:
        return None
    return max(0.0, submitted_at + deadline_s - now())
