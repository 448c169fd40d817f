"""Device time of the peel's launches, from CUDA events.

The peel brackets each launch that does a dispatch's work on the card —
each fused level launch, each replay of the unfused peel's trip graph —
with a pair of timing events on the launch's stream (:class:`EventPair`).
Recording an event waits for nothing.  The pair's interval is read
(:meth:`EventPair.seconds`) only after a readback that the peel makes
anyway has waited for that stream: the fused loop's at the top of the next
level, the trip loop's at its exit.  So the timing adds no synchronization
and costs two event records a launch.  A pair is made once per fused
dispatch, or per trip graph, and reused for each launch after its last
interval was read.

:func:`dispatch_device_time` gathers one dispatch's intervals: the planner
opens it around ``PeelExecutor.peel``, and the peel adds each interval it
reads (:func:`add_device_seconds`).  On CUDA their sum is the dispatch's
device time.  Off CUDA the peel runs on the host and records no events.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

__all__ = ["EventPair", "DeviceTime", "dispatch_device_time", "add_device_seconds"]


class EventPair:
    """Two timing events around one launch on ``device``'s current stream.

    :meth:`start` just before the launch and :meth:`stop` just after it, or
    a kernel library records the two :meth:`handles` itself around its
    launch call; :meth:`seconds` once a readback has waited for the
    stream.  The pair may then time the next launch."""

    __slots__ = ("index", "begin", "end")

    def __init__(self, device: torch.device):
        self.index = device.index if device.index is not None else torch.cuda.current_device()
        stream = torch.cuda.current_stream(self.index)
        self.begin = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        for event in (self.begin, self.end):
            event.record(stream)  # creates it on the device, so it has a handle

    def start(self) -> None:
        self.begin.record(torch.cuda.current_stream(self.index))

    def stop(self) -> None:
        self.end.record(torch.cuda.current_stream(self.index))

    def handles(self) -> tuple[int, int]:
        """The two events' ``cudaEvent_t`` handles (begin, end)."""
        return self.begin.cuda_event, self.end.cuda_event

    def seconds(self) -> float:
        """The seconds between the two records.  The stream must have
        passed the second (no wait here)."""
        return self.begin.elapsed_time(self.end) * 1e-3


class DeviceTime:
    """One dispatch's device seconds: the sum of its launches' intervals."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


_current: contextvars.ContextVar[DeviceTime | None] = contextvars.ContextVar(
    "repro_obs_device_time", default=None
)


@contextlib.contextmanager
def dispatch_device_time():
    """Scoped: gather the device seconds of the launches made inside."""
    acc = DeviceTime()
    token = _current.set(acc)
    try:
        yield acc
    finally:
        _current.reset(token)


def add_device_seconds(seconds: float) -> None:
    """Add one launch's interval to the open :func:`dispatch_device_time`."""
    acc = _current.get()
    if acc is not None:
        acc.seconds += seconds
