"""Peel telemetry: the paper's load-imbalance statistic, observed at runtime.

``repro_torch.graphs.stats.imbalance_stats`` *predicts* imbalance from the
degree structure (max/mean task work — the quantity the fine-grained
formulation fixes); this module *measures* it on real dispatches.  The
device peel already carries per-slot state in its while-loop —
``levels`` (fixed points peeled), ``iters`` (prune trips while the slot
was live) and ``edges_alive`` (the final level's alive-edge count) — so
every batch yields a free imbalance sample: the slowest slot holds the
whole dispatch, exactly like the paper's slowest SIMD lane holds its
warp, and ``max(iters) / mean(iters)`` is the batch-level analog of the
paper's max/mean work ratio.

Samples are recorded per ``(bucket, backend)`` label set so the
planner's auto rule can later be calibrated from observed device time
instead of the static two-threshold heuristic (see ROADMAP's cost-model
item): the registry accumulates, per backend per shape class,

* ``peel_device_time_s``   — dispatch device time histogram (on CUDA
  the launches' time between CUDA events, ``repro_torch.obs.device_time``;
  on the CPU, where the peel runs on the host, its wall time), with
  ``peel_device_seconds_total`` its sum,
* ``peel_slot_iters``      — per-slot iteration histogram (the
  imbalance's raw material),
* ``peel_batch_imbalance`` — per-batch max/mean slot-iteration ratio
  (1.0 == perfectly balanced, the paper's statistic),
* ``peel_level_edges``     — per-slot final-level alive-edge counts,
* ``peel_batches`` / ``peel_slots`` counters.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .metrics import MetricsRegistry, current_registry

__all__ = [
    "ITER_BUCKETS",
    "IMBALANCE_BUCKETS",
    "EDGE_BUCKETS",
    "PeelBatchTelemetry",
    "record_peel_batch",
    "imbalance_summary",
]

# Powers of two: iteration counts and edge counts are size-like.
ITER_BUCKETS = tuple(float(1 << i) for i in range(0, 12))
EDGE_BUCKETS = tuple(float(1 << i) for i in range(0, 24, 2))
# Ratio-like: 1.0 is perfect balance, heavy tails run past 8x.
IMBALANCE_BUCKETS = (1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 6.0, 8.0, 16.0, 32.0)


@dataclasses.dataclass(frozen=True)
class PeelBatchTelemetry:
    """One dispatch's imbalance sample (also recorded into the registry)."""

    batch_size: int  # real members (pad slots excluded)
    max_iters: int
    mean_iters: float
    imbalance: float  # max/mean slot iterations; 1.0 == balanced
    max_levels: int
    device_time_s: float


def record_peel_batch(
    *,
    bucket,
    backend,
    levels: Sequence[int] | np.ndarray,
    iters: Sequence[int] | np.ndarray,
    edges_alive: Sequence[int] | np.ndarray | None = None,
    batch_size: int | None = None,
    device_time_s: float = 0.0,
    metrics: MetricsRegistry | None = None,
) -> PeelBatchTelemetry:
    """Record one dispatch's per-slot peel state into the metrics registry.

    ``levels`` / ``iters`` / ``edges_alive`` are the executor's per-slot
    arrays (``PeelState``); only the first ``batch_size`` slots are real
    members — pad slots are excluded from the statistics (they retire on
    the first trip and would dilute the imbalance toward 1/B).
    ``device_time_s`` is the dispatch's ``RequestStats.device_time_s``:
    device time on CUDA, host wall on the CPU.
    """
    m = metrics if metrics is not None else current_registry()
    labels = {"bucket": _bucket_label(bucket), "backend": str(backend)}
    iters = np.asarray(iters, np.int64)
    levels = np.asarray(levels, np.int64)
    b = int(batch_size) if batch_size is not None else int(iters.shape[0])
    live_iters = iters[:b]
    live_levels = levels[:b]
    mean_it = float(live_iters.mean()) if b else 0.0
    max_it = int(live_iters.max(initial=0))
    imb = float(max_it / mean_it) if mean_it > 0 else 1.0

    m.inc("peel_batches", **labels)
    m.inc("peel_slots", b, **labels)
    m.inc("peel_device_seconds_total", device_time_s, **labels)
    m.observe("peel_device_time_s", device_time_s, **labels)
    m.observe("peel_batch_imbalance", imb, buckets=IMBALANCE_BUCKETS, **labels)
    for it in live_iters.tolist():
        m.observe("peel_slot_iters", it, buckets=ITER_BUCKETS, **labels)
    for lv in live_levels.tolist():
        m.observe("peel_slot_levels", lv, buckets=ITER_BUCKETS, **labels)
    if edges_alive is not None:
        ea = np.asarray(edges_alive, np.int64)[:b]
        for e in ea.tolist():
            m.observe("peel_level_edges", e, buckets=EDGE_BUCKETS, **labels)
    return PeelBatchTelemetry(
        batch_size=b,
        max_iters=max_it,
        mean_iters=mean_it,
        imbalance=imb,
        max_levels=int(live_levels.max(initial=0)),
        device_time_s=device_time_s,
    )


def _bucket_label(bucket) -> str:
    try:
        return f"n{bucket.n_pad}-nnz{bucket.nnz_pad}-w{bucket.window}"
    except AttributeError:
        return str(bucket)


def imbalance_summary(metrics: MetricsRegistry | None = None) -> list[dict]:
    """Per-(bucket, backend) roll-up of the recorded peel telemetry.

    One row per label series with the observed device time, slot
    iteration spread, and mean batch imbalance — the table the cost-model
    calibration (and ``BENCH_obs.json``) reads.
    """
    m = metrics if metrics is not None else current_registry()
    rows: list[dict] = []
    for key, h in sorted(m.histograms_named("peel_batch_imbalance").items()):
        labels = key[key.index("{") + 1 : -1] if "{" in key else ""
        it = m.histograms_named("peel_slot_iters").get(
            "peel_slot_iters" + (("{" + labels + "}") if labels else "")
        )
        dt = m.histograms_named("peel_device_time_s").get(
            "peel_device_time_s" + (("{" + labels + "}") if labels else "")
        )
        parsed = dict(
            part.split("=", 1) for part in labels.split(",") if "=" in part
        )
        rows.append(
            {
                "labels": labels,
                "bucket": parsed.get("bucket", ""),
                "backend": parsed.get("backend", ""),
                "batches": h.count,
                "mean_imbalance": round(h.mean, 4),
                "max_imbalance": round(h.max if h.count else 0.0, 4),
                "slot_iters_mean": round(it.mean, 4) if it else 0.0,
                "slot_iters_max": int(it.max) if it and it.count else 0,
                "device_time_s_total": round(dt.sum, 6) if dt else 0.0,
                "device_time_s_mean": round(dt.mean, 6) if dt else 0.0,
            }
        )
    return rows
