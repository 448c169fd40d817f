"""Runtime recompile sentinel — the dynamic half of the R2 rule.

The static rule proves the variant key *covers* what the builder reads;
this sentinel proves the warm path actually *hits* the caches.  What
compiles in the port is an ``nvcc`` build of a kernel library, an
executor-cache miss and the capture of the unfused peel's trip graph (on
the card); all three are events of :mod:`repro_torch.obs.events`
(the port's stand-in for the reference's ``jax.monitoring`` listener),
so a test or ``chip_smoke.py`` can run the same query mix twice and
assert that the second pass built nothing.  It mints no metric name.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

from ..obs.events import (
    EXECUTOR_BUILD,
    KERNEL_BUILD,
    PEEL_CAPTURE,
    register_event_listener,
    unregister_event_listener,
)

__all__ = ["COMPILE_EVENTS", "CompileLog", "count_compiles", "assert_no_compiles"]

# An nvcc build of a kernel library; an executor built on a cache miss; a
# trip graph captured on an executor's first dispatch of a shape.
COMPILE_EVENTS = (KERNEL_BUILD, EXECUTOR_BUILD, PEEL_CAPTURE)


class CompileLog:
    """Callable event listener accumulating compile events."""

    def __init__(self) -> None:
        self.events: list[str] = []

    @property
    def compiles(self) -> int:
        return len(self.events)

    @property
    def kernel_builds(self) -> int:
        return self.events.count(KERNEL_BUILD)

    @property
    def executor_builds(self) -> int:
        return self.events.count(EXECUTOR_BUILD)

    @property
    def captures(self) -> int:
        return self.events.count(PEEL_CAPTURE)

    def __call__(self, event: str, **info) -> None:
        if event in COMPILE_EVENTS:
            self.events.append(event)


@contextlib.contextmanager
def count_compiles() -> Iterator[CompileLog]:
    """Context manager yielding a :class:`CompileLog` counting the kernel
    builds, executor builds and trip-graph captures that happen inside the
    block (in any thread of the process)."""
    log = CompileLog()
    register_event_listener(log)
    try:
        yield log
    finally:
        unregister_event_listener(log)


@contextlib.contextmanager
def assert_no_compiles(what: str = "warm path") -> Iterator[CompileLog]:
    """Assert that the block builds no kernel and no executor, and
    captures no trip graph.

    Usage::

        with assert_no_compiles("second solve of identical mix"):
            session.solve(query)
    """
    with count_compiles() as log:
        yield log
    if log.compiles:
        raise AssertionError(
            f"{what}: {log.kernel_builds} kernel build(s) and "
            f"{log.executor_builds} executor build(s); {log.captures} "
            "trip-graph capture(s) — an executor-cache "
            "variant-key dimension is leaking (see R2 in repro_torch.analysis)"
        )
