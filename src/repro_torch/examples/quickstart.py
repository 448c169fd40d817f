"""Quickstart: the paper's algorithm in five minutes.

Builds a power-law graph, runs Eager K-truss with the coarse (Alg. 2) and
fine-grained (Alg. 3, the paper's contribution) decompositions plus the
hand-written kernel backend (``fine/owner/pallas``: ``support_fine_cuda``
on the CUDA card, its plain version on the CPU), checks they agree, and
prints the ME/s comparison — the paper's Table I in miniature.  Support
times are CUDA events on the card, the host clock on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import KTrussEngine, KTrussResult
from repro_torch.device import resolve_device
from repro_torch.examples import device_arg, median_ms
from repro_torch.graphs import CSRGraph, imbalance_stats, rmat

# (granularity, mode, backend, bucketed): the reference example's grid.
COMBOS = (
    ("coarse", "eager", "xla", False),
    ("fine", "eager", "xla", False),
    ("fine", "owner", "xla", False),
    ("fine", "owner", "pallas", False),
)


@dataclasses.dataclass(frozen=True)
class GridRow:
    tag: str  # "granularity/mode/backend", "/bucketed" appended when set
    ms: float  # median support() time over the timed calls
    result: KTrussResult  # ktruss(4) of the combination's engine


def grid(
    g: CSRGraph,
    combos=COMBOS,
    *,
    device: str | torch.device | None = None,
    reps: int = 3,
) -> list[GridRow]:
    """One ``KTrussEngine`` per combination on ``g``: its ``ktruss(4)``
    (which also warms the support closure) and the median time of ``reps``
    warm ``support()`` calls on the full alive mask."""
    dev = resolve_device(device)
    rows = []
    for gran, mode, backend, bucketed in combos:
        eng = KTrussEngine(
            g, granularity=gran, mode=mode, backend=backend, bucketed=bucketed, device=dev
        )
        res = eng.ktruss(4)
        alive = eng.initial_alive()
        ms = median_ms(lambda: eng.support(alive), dev, reps)
        tag = f"{gran}/{mode}/{backend}" + ("/bucketed" if bucketed else "")
        rows.append(GridRow(tag, ms, res))
    return rows


def main(device: str | torch.device | None = None) -> dict:
    """Run the example on ``device`` (default: the CUDA card); returns the
    graph's statistics and each combination's 4-truss."""
    dev = resolve_device(device)
    g = rmat(10, 6, seed=7)
    st = imbalance_stats(g, device=dev)
    print(f"graph: {g.name}  |V|={g.n} |E|={g.nnz} max_deg={g.max_degree()}")
    print(
        f"coarse-task imbalance {st.coarse_imbalance:.0f}x vs fine "
        f"{st.fine_imbalance:.1f}x  (the paper's §III-A premise)\n"
    )

    # One timed warm call per combination, as the reference times.
    rows = grid(g, COMBOS, device=dev, reps=1)
    for row in rows:
        print(
            f"{row.tag:24s} support: {row.ms:8.1f} ms  "
            f"({g.nnz / row.ms / 1e3:6.2f} ME/s)   4-truss edges: {row.result.edges_remaining}"
        )

    base = rows[1].result.alive  # fine/eager/xla
    if not all(np.array_equal(base, row.result.alive) for row in rows):
        raise AssertionError("the decompositions disagree on the 4-truss")
    print("\nall decompositions agree ✓  (the paper's Table I, in miniature)")
    return {
        "graph": g.name,
        "n": g.n,
        "nnz": g.nnz,
        "max_degree": g.max_degree(),
        "coarse_imbalance": st.coarse_imbalance,
        "fine_imbalance": st.fine_imbalance,
        "ktruss4": {row.tag: row.result for row in rows},
    }


if __name__ == "__main__":
    main(device_arg(__doc__).parse_args().device)
