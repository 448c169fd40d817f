"""The traced run's instruments: the program's spans summed by name, and
one profiled stretch of whole requests reduced to the device's busy
time, its longest operations and its idle gaps.

``SpanSums`` takes the place of a traced session's tracer: the program
opens its spans on it as on its own, and it adds each span's seconds to
its name's sum, so a long window needs no ring.  Inside the stretch it
also opens a ``torch.profiler.record_function`` range per span, which
puts the spans on the profiler's timeline to name the idle gaps.

The profiler does not see inside a captured CUDA graph's WHILE node (the
unfused peel's trip loop): a cell whose path replays one needs each
replay bracketed by CUDA events before its idle share can be read.  The
cells here run the fused peel, which launches every kernel itself.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import threading
import time
from dataclasses import dataclass, field

from repro_torch.obs.trace import Tracer

__all__ = ["SpanSums", "Stretch", "profiled", "reduce_trace"]

PREFIX = "ktb:"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class _Span:
    __slots__ = ("sums", "name", "attrs", "t0", "rf")

    def __init__(self, sums, name, attrs):
        self.sums, self.name, self.attrs, self.rf = sums, name, attrs, None

    def __enter__(self):
        if self.sums.mirror:
            import torch

            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.sums.add(self.name, dt)


class SpanSums(Tracer):
    """A tracer for a session's ``obs.tracer`` that sums span seconds by
    name (``snapshot()``: name -> [seconds, count])."""

    def __init__(self):
        super().__init__(capacity=1, enabled=True)
        self.mirror = False  # also open a profiler range per span
        self._totals: dict[str, list] = {}
        self._sum_lock = threading.Lock()

    def span(self, name: str, **attrs):
        return _Span(self, name, attrs)

    def instant(self, name: str, **attrs) -> None:
        pass

    def add(self, name: str, seconds: float) -> None:
        with self._sum_lock:
            tot = self._totals.setdefault(name, [0.0, 0])
            tot[0] += seconds
            tot[1] += 1

    def snapshot(self) -> dict[str, list]:
        with self._sum_lock:
            return {k: list(v) for k, v in self._totals.items()}


@dataclass
class Stretch:
    """One profiled stretch, reduced."""

    window_s: float  # the stretch's length on the profiler's timeline
    busy_s: float  # union of the device operations' intervals
    op_seconds: dict[str, float]  # device time by operation name
    gaps: dict[str, float]  # idle seconds by the innermost port span open then
    requests: list = field(default_factory=list)  # the answers of the stretch's requests

    def device_seconds(self, needle: str) -> float:
        return sum(s for name, s in self.op_seconds.items() if needle in name)

    def breakdown(self) -> dict:
        ops = sorted(self.op_seconds.items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in ops[:10]],
                "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    argument list."""
    name = re.sub(r"\(anonymous namespace\)::", "", name).removeprefix("void ")
    return name.split("(", 1)[0][:96] if not name.startswith("Memcpy") else name


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def reduce_trace(events: list[dict]) -> Stretch:
    """Reduce a Chrome trace's events (kineto's export) to a :class:`Stretch`.
    The stretch is the ``ktb:stretch`` range."""
    stretch = next(e for e in events if e.get("name") == PREFIX + "stretch")
    lo, hi = float(stretch["ts"]), float(stretch["ts"]) + float(stretch["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    ops: dict[str, float] = {}
    intervals = []
    for e in dev:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        intervals.append((a, b))
        name = _short(e["name"])
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    busy_us, merged = _union(intervals)
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):])
        for e in events
        if e.get("name", "").startswith(PREFIX) and e["name"] != PREFIX + "stretch" and "dur" in e
    )
    edges = sorted({p for s in spans for p in s[:2]})
    gaps: dict[str, float] = {}
    cursor = lo
    for a, b in merged + [[hi, hi]]:
        if a > cursor:  # an idle gap, split where a span opens or closes
            cuts = [cursor, *(p for p in edges if cursor < p < a), a]
            for x, y in zip(cuts, cuts[1:]):
                mid = 0.5 * (x + y)
                inner = [s for s in spans if s[0] <= mid <= s[1]]
                name = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "outside the port's spans"
                gaps[name] = gaps.get(name, 0.0) + (y - x) * 1e-6
        cursor = max(cursor, b)
    return Stretch((hi - lo) * 1e-6, busy_us * 1e-6, ops, gaps)


def profiled(run, sums) -> Stretch:
    """Run ``run()`` (whole requests) under ``torch.profiler`` on the card
    and reduce its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(PREFIX + "stretch"):
                sums.mirror = True
                try:
                    run()
                finally:
                    sums.mirror = False
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_trace(events)
