"""The port's user-facing examples: one module per ``examples/<name>.py``.

Each module runs as ``python -m repro_torch.examples.<name> [--device cpu]``
and has ``main(device=None, ...)``: with no device it runs on the CUDA card
and raises without one (the port never drops to the CPU on its own).  It
prints the reference example's lines in the reference's order and returns
what it printed, times left out, as a dict.

* :mod:`.declarative_queries` — ``TrussQuery`` through ``solve()`` and a
  mixed ``Session``, with the planner's backend per bucket;
* :mod:`.quickstart` — the paper's Table I in miniature: ``KTrussEngine``
  over a grid of (granularity, mode, backend), exposed as :func:`.quickstart.grid`;
* :mod:`.ktruss_scaling` — the Fig. 2 analog, fine-over-coarse speedup
  beside ``max_degree / avg_degree``, exposed as :func:`.ktruss_scaling.sweep`;
* :mod:`.tracing` — a traced ``Session`` read back from its Chrome trace,
  exposed as :func:`.tracing.traced_solve` (milliseconds per span);
* :mod:`.streaming_updates` — a stream of edge updates, each held to a
  from-scratch decompose.

Imports ``torch``, ``numpy`` and ``repro_torch`` only.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Callable

import torch

__all__ = ["median_ms", "device_arg"]


def median_ms(fn: Callable[[], object], device: torch.device, reps: int = 3) -> float:
    """Median time of one ``fn()`` over ``reps`` calls, in ms.

    On a CUDA device each call sits between two CUDA events; on the CPU
    between two reads of the host clock.  The caller warms ``fn`` first.
    """
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_arg(doc: str) -> argparse.ArgumentParser:
    """The examples' command line: ``--device`` (default: the CUDA card)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument(
        "--device", default=None, help="torch device to run on (default: cuda; 'cpu' for the CPU)"
    )
    return ap
