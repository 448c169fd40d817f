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
import torch

from ..device import resolve_device
from .csr import CSRGraph, csr_degrees, edge_rows, lift_csr

__all__ = [
    "ImbalanceStats",
    "coarse_task_work",
    "fine_task_work",
    "imbalance_parts",
    "imbalance_stats",
    "stats_from_parts",
]


def _fine(
    rowptr: torch.Tensor, colidx: torch.Tensor, nnz: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(fine, rows, deg)`` of a lifted CSR, int64 on its device: the
    per-edge work, each edge's row and the degrees."""
    deg = csr_degrees(rowptr)
    rows = edge_rows(rowptr, nnz)
    return deg[rows] + deg[colidx], rows, deg


def _coarse(fine: torch.Tensor, rows: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Per-row sums of the per-edge work (``np.add.at``'s, by ``index_add_``)."""
    return torch.zeros_like(deg).index_add_(0, rows, fine)[1:]


def coarse_task_work(g: CSRGraph, *, device: str | torch.device | None = None) -> np.ndarray:
    """Per-row work estimate for the coarse decomposition (Alg. 2), built
    on ``device`` (``None`` = CUDA) and returned as the host's int64 array.

    Row i's task intersects, for each j-th neighbor κ of i, the suffix
    a_i12[j+1:] with row κ.  Work(i) = Σ_{κ ∈ N⁺(i)} (deg(i) + deg(κ)),
    the standard merge-cost model for sorted intersections.
    """
    return _coarse(*_fine(*lift_csr(g, resolve_device(device)), g.nnz)).cpu().numpy()


def fine_task_work(g: CSRGraph, *, device: str | torch.device | None = None) -> np.ndarray:
    """Per-edge work estimate for the fine decomposition (Alg. 3), built on
    ``device`` (``None`` = CUDA) and returned as the host's int64 array."""
    return _fine(*lift_csr(g, resolve_device(device)), g.nnz)[0].cpu().numpy()


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


def imbalance_parts(rowptr: torch.Tensor, colidx: torch.Tensor, nnz: int) -> list[torch.Tensor]:
    """The integer sums, maxima and counts :func:`imbalance_stats` reads
    back, as eight () int64 tensors on the arrays' device (``nnz`` is the
    host's count: sizing reads nothing back)."""
    fine, rows, deg = _fine(rowptr, colidx, nnz)
    coarse = _coarse(fine, rows, deg)
    parts = [deg.sum(), deg.max()]  # deg[0] == 0: never empty, never raises the max
    # Work is never negative, so the positive entries' sum and maximum are
    # the whole vector's (a zero appended keeps the maximum of an empty one).
    for w in (coarse, fine):
        parts += [w.sum(), torch.cat([w, w.new_zeros(1)]).max(), (w > 0).sum()]
    return parts


def stats_from_parts(g: CSRGraph, values) -> ImbalanceStats:
    """``g``'s :class:`ImbalanceStats` from the eight integers of
    :func:`imbalance_parts`, read back.  The ratios are taken here in
    float64.  Every sum is an exact integer below 2^53, so ``float(sum) /
    count`` is numpy's ``mean`` bit for bit and the result equals the
    reference's."""
    d_sum, d_max, c_sum, c_max, c_cnt, f_sum, f_max, f_cnt = values

    def _imb(total: int, top: int, count: int) -> float:
        return float(top) / max(float(total) / count, 1e-9) if count else 1.0

    def _lane_eff(total: int, top: int, count: int) -> float:
        return float(total) / count / max(top, 1) if count else 1.0

    return ImbalanceStats(
        name=g.name,
        n=g.n,
        nnz=g.nnz,
        max_degree=d_max,
        mean_degree=float(d_sum) / g.n if g.n else 0.0,
        coarse_imbalance=_imb(c_sum, c_max, c_cnt),
        fine_imbalance=_imb(f_sum, f_max, f_cnt),
        coarse_lane_efficiency=_lane_eff(c_sum, c_max, c_cnt),
        fine_lane_efficiency=_lane_eff(f_sum, f_max, f_cnt),
        coarse_tasks=c_cnt,
        fine_tasks=f_cnt,
    )


def imbalance_stats(g: CSRGraph, *, device: str | torch.device | None = None) -> ImbalanceStats:
    """The paper's imbalance statistics of ``g``, its work vectors built on
    ``device`` (``None`` = CUDA) and reduced there to integer sums, maxima
    and counts (:func:`imbalance_parts`), read back once."""
    rowptr, colidx = lift_csr(g, resolve_device(device))
    return stats_from_parts(g, torch.stack(imbalance_parts(rowptr, colidx, g.nnz)).tolist())
