"""Fig. 2 analog: fine-over-coarse speedup tracks the imbalance statistic.

Sweeps graph families (uniform grid → heavy-tail) and prints measured
speedup next to the W/avg-degree prediction — the mechanism behind the
paper's graph-dependent speedups (roadNet ≈ 1×, soc-* ≫ 1×).  Support
times are CUDA events on the card, the host clock on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.ktruss_scaling [--device cpu]
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import KTrussResult
from repro_torch.device import resolve_device
from repro_torch.examples import device_arg
from repro_torch.examples.quickstart import grid
from repro_torch.graphs import CSRGraph, barabasi, erdos, imbalance_stats, rmat, road

# (granularity, mode, backend): the reference example's two engines.
SETTINGS = (("coarse", "eager", "xla"), ("fine", "eager", "xla"))


@dataclasses.dataclass(frozen=True)
class SweepRow:
    graph: str
    n: int
    nnz: int
    max_degree: int
    pred: float  # max_degree / avg_degree, the W/avg prediction
    coarse_imbalance: float  # imbalance_stats(g).coarse_imbalance
    ms: dict[str, float]  # "granularity/mode/backend" -> median support() ms
    ktruss: dict[str, KTrussResult]  # "granularity/mode/backend" -> ktruss(4)


def example_graphs() -> list[CSRGraph]:
    return [
        road(48, 0.08, seed=1),  # uniform degree (roadNet regime)
        erdos(3_000, 8.0, seed=2),  # near-uniform (p2p regime)
        barabasi(3_000, 4, seed=3),  # heavy tail (oregon regime)
        rmat(11, 6, seed=4),  # heavier tail (soc-* regime)
    ]


def sweep(
    graphs,
    settings=SETTINGS,
    *,
    device: str | torch.device | None = None,
    reps: int = 3,
) -> list[SweepRow]:
    """:func:`repro_torch.examples.quickstart.grid` over each graph with
    the (granularity, mode, backend) settings, beside the graph's
    imbalance statistics."""
    dev = resolve_device(device)
    rows = []
    for g in graphs:
        grid_rows = grid(g, [(*s, False) for s in settings], device=dev, reps=reps)
        rows.append(
            SweepRow(
                graph=g.name,
                n=g.n,
                nnz=g.nnz,
                max_degree=g.max_degree(),
                pred=g.max_degree() / max(g.nnz / g.n, 1e-9),
                coarse_imbalance=imbalance_stats(g).coarse_imbalance,
                ms={r.tag: r.ms for r in grid_rows},
                ktruss={r.tag: r.result for r in grid_rows},
            )
        )
    return rows


def main(device: str | torch.device | None = None) -> dict:
    """Run the example on ``device`` (default: the CUDA card); returns each
    graph's statistics and the 4-truss of each engine."""
    dev = resolve_device(device)
    print(f"{'graph':>14} {'maxdeg':>7} {'pred W/avg':>10} {'coarse ms':>10} "
          f"{'fine ms':>8} {'speedup':>8}")
    # One timed warm call per pass, as the reference times.
    rows = sweep(example_graphs(), SETTINGS, device=dev, reps=1)
    coarse, fine = ("/".join(s) for s in SETTINGS)
    for r in rows:
        c, f = r.ms[coarse], r.ms[fine]
        print(
            f"{r.graph:>14} {r.max_degree:>7} {r.pred:>10.1f} {c:>10.1f} "
            f"{f:>8.1f} {c/f:>7.1f}x"
        )
    print("\nspeedup grows with the imbalance statistic — the paper's Fig. 2/3.")
    return {
        r.graph: {
            "max_degree": r.max_degree,
            "pred": r.pred,
            "coarse_imbalance": r.coarse_imbalance,
            "ktruss4": r.ktruss,
        }
        for r in rows
    }


if __name__ == "__main__":
    main(device_arg(__doc__).parse_args().device)
