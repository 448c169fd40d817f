"""Observability in one screen: trace a mixed batch, read the telemetry.

Runs a mixed-workload solve with span tracing on, exports the Chrome
trace-event JSON (open it in Perfetto or ``chrome://tracing``), and
prints the metrics the same run recorded — including the paper's
load-imbalance statistic observed per (bucket, backend) on the real
dispatches.  Beside the reference example's span lines it prints the
part of ``solve`` that no child span covers.

    PYTHONPATH=src python -m repro_torch.examples.tracing [--device cpu] [--trace trace.json]

Tracing can also be forced process-wide without touching code:

    REPRO_TRACE=trace.json PYTHONPATH=src python your_script.py
"""

from __future__ import annotations

import torch

from repro_torch.api import Session, TrussQuery
from repro_torch.device import resolve_device
from repro_torch.examples import device_arg
from repro_torch.graphs import barabasi, rmat, road
from repro_torch.obs import imbalance_summary

# The spans a solve records: "solve" holds the others; "peel-level" (one
# per fused level launch) nests in "dispatch".
SPANS = ("solve", "plan", "pack", "compile", "dispatch", "peel-level", "device-wait", "unpack")
SOLVE_CHILDREN = ("plan", "pack", "compile", "dispatch", "device-wait", "unpack")


def example_queries() -> list[TrussQuery]:
    return [
        TrussQuery.decompose(rmat(6, 6, seed=0)),  # heavy tail -> fine
        TrussQuery.decompose(barabasi(120, 4, seed=1)),
        TrussQuery.decompose(road(8, 0.1, seed=2)),  # balanced -> coarse
        TrussQuery.kmax(rmat(6, 6, seed=3)),
    ]


def traced_solve(session: Session, queries) -> tuple[list, list[dict], dict[str, float]]:
    """Solve ``queries`` on ``session``, which traces (``Session(trace=...)``),
    and read that solve back from its tracer.

    Returns the results, the solve's trace events, and the milliseconds of
    each name in :data:`SPANS` summed over its spans, plus ``"outside"``:
    ``solve`` less its child spans (work no span covers, such as the fused
    path's tiling check before ``dispatch`` opens).
    """
    if not session.obs.tracing:
        raise ValueError("traced_solve needs a tracing session: Session(trace=True or a path)")
    session.obs.tracer.clear()  # the events then hold this solve alone
    results = session.solve(queries)
    events = session.obs.tracer.events()
    ms = dict.fromkeys(SPANS, 0.0)
    for ev in events:
        if ev["ph"] == "X" and ev["name"] in ms:
            ms[ev["name"]] += ev["dur"] / 1e3
    ms["outside"] = ms["solve"] - sum(ms[name] for name in SOLVE_CHILDREN)
    return results, events, ms


def main(device: str | torch.device | None = None, trace: str = "trace.json") -> dict:
    """Run the example on ``device`` (default: the CUDA card), tracing to
    ``trace``; returns the run's counters, batch occupancy and observed
    imbalance rows."""
    dev = resolve_device(device)
    # trace="path" records spans AND auto-exports after solve()/flush().
    s = Session(kernel="xla", max_batch=4, chunk=64, trace=trace, device=dev)
    results, events, ms = traced_solve(s, example_queries())

    # The exported trace: plan -> pack -> compile -> dispatch ->
    # device-wait -> unpack spans, nested under one "solve".
    print(f"wrote {trace} ({len(events)} events)")
    for name in ("solve", "plan", "pack", "compile", "dispatch", "device-wait"):
        ev = next(e for e in events if e["name"] == name)
        print(f"  {name:<12} {ev['dur'] / 1e3:8.2f} ms  args={ev.get('args', {})}")
    print(f"  {'outside':<12} {ms['outside']:8.2f} ms  (solve less its child spans)")

    # Counters/gauges/histograms for the same run (also available as
    # s.prometheus_text() for scraping).
    snap = s.metrics_snapshot()
    print("\ncounters:")
    counters = {}
    for key in ("requests_served", "batches_run", "dispatches", "cache_compiles"):
        counters[key] = snap["counters"].get(key, 0)
        print(f"  {key} = {counters[key]}")
    occ = snap["histograms"]["batch_occupancy"]
    print(f"  batch_occupancy mean = {occ['mean']:.2f} over {occ['count']} batches")

    # The paper's max/mean work statistic, measured per (bucket, backend):
    # heavy-tail buckets show spread, balanced ones sit near 1.0.
    print("\nobserved peel imbalance (max/mean slot iterations):")
    rows = imbalance_summary(s.obs.metrics)
    for row in rows:
        print(
            f"  {row['bucket']:<20} {row['backend']:<20} "
            f"mean={row['mean_imbalance']:<7} slot_iters_max={row['slot_iters_max']}"
        )
    return {
        "results": results,
        "events": len(events),
        "span_names": sorted({e["name"] for e in events}),
        "counters": counters,
        "batch_occupancy": {"mean": occ["mean"], "count": occ["count"]},
        "imbalance": rows,
    }


if __name__ == "__main__":
    ap = device_arg(__doc__)
    ap.add_argument("--trace", default="trace.json", help="Chrome trace JSON to write")
    args = ap.parse_args()
    main(args.device, args.trace)
