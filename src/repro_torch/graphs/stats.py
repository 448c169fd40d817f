"""Load-imbalance statistics — the quantity the paper's technique fixes.

The paper's coarse-grained decomposition assigns one task per row; the work
of row ``i`` is (to first order) ``Σ_{j ∈ N⁺(i)} min window work``, i.e. it
scales with both the row length and the neighbor row lengths.  On a SIMD/MXU
machine the imbalance manifests as *padding waste*: every row is padded to
the longest row.  These statistics quantify exactly that, and the benchmark
tables report them next to the measured speedups so the mechanism — not just
the number — is visible (cf. paper §III-A).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .csr import CSRGraph

__all__ = ["ImbalanceStats", "imbalance_stats", "coarse_task_work", "fine_task_work"]


def coarse_task_work(g: CSRGraph) -> np.ndarray:
    """Per-row work estimate for the coarse decomposition (Alg. 2).

    Row i's task intersects, for each j-th neighbor κ of i, the suffix
    a_i12[j+1:] with row κ.  Work(i) = Σ_{κ ∈ N⁺(i)} (deg(i) + deg(κ)),
    the standard merge-cost model for sorted intersections.
    """
    deg = g.degrees()
    rows = g.row_of_edge()
    per_edge = deg[rows] + deg[g.colidx]
    work = np.zeros(g.n + 1, dtype=np.int64)
    np.add.at(work, rows, per_edge)
    return work[1:]


def fine_task_work(g: CSRGraph) -> np.ndarray:
    """Per-edge work estimate for the fine decomposition (Alg. 3)."""
    deg = g.degrees()
    return (deg[g.row_of_edge()] + deg[g.colidx]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ImbalanceStats:
    name: str
    n: int
    nnz: int
    max_degree: int
    mean_degree: float
    # max/mean work ratio per decomposition: 1.0 == perfectly balanced.
    coarse_imbalance: float
    fine_imbalance: float
    # Fraction of SIMD lanes doing useful work when every task is padded to
    # the max task size (the TPU-native cost of imbalance).
    coarse_lane_efficiency: float
    fine_lane_efficiency: float
    # Parallelism available to fill a machine (task count).
    coarse_tasks: int
    fine_tasks: int

    def row(self) -> dict:
        return dataclasses.asdict(self)


def imbalance_stats(g: CSRGraph) -> ImbalanceStats:
    cw = coarse_task_work(g)
    fw = fine_task_work(g)
    cw_pos = cw[cw > 0]
    fw_pos = fw[fw > 0]

    def _imb(w: np.ndarray) -> float:
        return float(w.max() / max(w.mean(), 1e-9)) if w.size else 1.0

    def _lane_eff(w: np.ndarray) -> float:
        return float(w.mean() / max(w.max(), 1)) if w.size else 1.0

    deg = g.degrees()[1:]
    return ImbalanceStats(
        name=g.name,
        n=g.n,
        nnz=g.nnz,
        max_degree=g.max_degree(),
        mean_degree=float(deg.mean()) if g.n else 0.0,
        coarse_imbalance=_imb(cw_pos),
        fine_imbalance=_imb(fw_pos),
        coarse_lane_efficiency=_lane_eff(cw_pos),
        fine_lane_efficiency=_lane_eff(fw_pos),
        coarse_tasks=int((cw > 0).sum()),
        fine_tasks=int(fw_pos.size),
    )
