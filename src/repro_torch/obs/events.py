"""Process-wide build events: the port's counterpart of the compile events
``jax.monitoring`` emits in the reference.

Three things count as a compile in the port: an ``nvcc`` build of a
kernel library (``repro_torch.kernels.build``), an executor-cache miss
(``repro_torch.api.cache.CompileCache`` building a peel executor) and the
capture of the unfused peel's trip graph on an executor's first dispatch
of a shape (``repro_torch.exec.peel._TripGraph``, CUDA only).  Each
calls :func:`record_event` with its event name; listeners registered with
:func:`register_event_listener` (the recompile sentinel,
``repro_torch.analysis.sentinel``) see every event in the process, on the
thread that caused it.  No listener, no cost but a tuple copy.
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = [
    "KERNEL_BUILD",
    "EXECUTOR_BUILD",
    "PEEL_CAPTURE",
    "record_event",
    "register_event_listener",
    "unregister_event_listener",
]

KERNEL_BUILD = "/repro_torch/kernels/nvcc_build"
EXECUTOR_BUILD = "/repro_torch/api/executor_build"
PEEL_CAPTURE = "/repro_torch/exec/peel_capture"

_lock = threading.Lock()
# Replaced whole under _lock, never mutated: record_event reads it unlocked.
_listeners: tuple[Callable[..., None], ...] = ()


def register_event_listener(fn: Callable[..., None]) -> None:
    """Call ``fn(event, **info)`` on every event from now on."""
    global _listeners
    with _lock:
        _listeners = (*_listeners, fn)


def unregister_event_listener(fn: Callable[..., None]) -> None:
    """Stop calling ``fn`` (a no-op when it is not registered)."""
    global _listeners
    with _lock:
        _listeners = tuple(f for f in _listeners if f is not fn)


def record_event(event: str, **info) -> None:
    """Hand ``event`` to every registered listener."""
    for fn in _listeners:
        fn(event, **info)
