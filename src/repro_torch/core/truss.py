"""K-truss result types returned by the planner."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["KTrussResult", "TrussDecomposition"]


@dataclasses.dataclass(frozen=True)
class KTrussResult:
    k: int
    alive: np.ndarray  # (nnz,) bool over the graph's real edges
    support: np.ndarray  # (nnz,) int32 (post-prune supports)
    iterations: int
    edges_remaining: int


@dataclasses.dataclass(frozen=True)
class TrussDecomposition:
    """Full truss decomposition: the trussness of every edge.

    ``trussness[e]`` is the largest k such that edge e belongs to the
    k-truss; every edge is trivially in the 2-truss, so values are >= 2.
    """

    trussness: np.ndarray  # (nnz,) int32, >= 2
    kmax: int  # max(trussness) (0 on edgeless graphs)
    levels: int  # number of fixed-point levels peeled
