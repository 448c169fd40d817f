"""The declarative front door in one screen: TrussQuery -> solve/Session.

Mixed workloads over mixed graph families, lowered through the planner's
backend registry (formulation x kernel x layout, auto-chosen per shape
bucket from the paper's imbalance statistics) onto one device dispatch
per batch.  On the CUDA card the one-shot ``solve()`` is planned with the
hand kernels (``fine/fused/aligned`` on a heavily imbalanced bucket, else
``fine/pallas/aligned``); the serving session asks for ``kernel="xla"``,
the torch-ops twins, as the reference example does.

    PYTHONPATH=src python -m repro_torch.examples.declarative_queries [--device cpu]
"""

from __future__ import annotations

import torch

from repro_torch.api import Session, TrussQuery, solve
from repro_torch.device import resolve_device
from repro_torch.examples import device_arg
from repro_torch.graphs import CSRGraph, erdos, rmat, road


def one_shot_graph() -> CSRGraph:
    return rmat(8, 5, seed=7)


def mixed_queries() -> list[TrussQuery]:
    return [
        TrussQuery.ktruss(erdos(100, 6.0, seed=0), k=4),
        TrussQuery.kmax(erdos(100, 6.0, seed=1)),
        TrussQuery.decompose(road(8, 0.1, seed=0)),  # balanced -> coarse rows
        TrussQuery.kmax(rmat(6, 4, seed=2)),  # heavy tail -> fine nonzeros
    ]


def main(device: str | torch.device | None = None) -> dict:
    """Run the example on ``device`` (default: the CUDA card); returns the
    one-shot decomposition, the mixed session's answers (in
    :func:`mixed_queries` order), its dispatch count and its backend per
    bucket."""
    dev = resolve_device(device)

    # One-shot: a single declarative query, auto-planned.
    g = one_shot_graph()
    dec = solve(TrussQuery.decompose(g), chunk=64, max_batch=1, device=dev)
    print(f"{g.name}: kmax={dec.kmax} levels={dec.levels}")

    # Serving: one session, mixed workloads, per-bucket backend choice.
    s = Session(kernel="xla", max_batch=4, chunk=64, device=dev)
    results = s.solve(mixed_queries())
    print("ktruss(4) edges:", results[0].edges_remaining)
    print("kmax:", results[1], "| road kmax:", results[2].kmax, "| rmat kmax:", results[3])

    st = s.stats()
    print(
        f"dispatches={st['device_dispatches']} "
        f"plan_overhead={st['planner_plan_us_per_query']:.0f}us/query"
    )
    for choice in st["planner_backends"]:
        print(
            f"  bucket {choice['bucket']} -> {choice['backend']} "
            f"({choice['queries']} queries)"
        )
    return {
        "one_shot": dec,
        "results": results,
        "dispatches": st["device_dispatches"],
        "planner_backends": st["planner_backends"],
    }


if __name__ == "__main__":
    main(device_arg(__doc__).parse_args().device)
