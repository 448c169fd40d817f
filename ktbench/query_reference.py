"""The plain reference for the ``kmax`` and ``ktruss(k)`` answers.

Plain PyTorch on whatever device it is given, independent of the program:
both answers follow from a graph's trussness (``ktbench.reference``).  The
k-truss is the edges of trussness k or more, and an edge's support in it is
the number of the graph's triangles (``ktbench.reference.triangles``) whose
three edges all lie in it.  The largest k whose k-truss is non-empty is the
largest trussness, counted from the query's starting k: a graph none of
whose edges reaches it has a kmax of 0.
"""

from __future__ import annotations

import torch

__all__ = ["kmax", "ktruss"]


def kmax(trussness: torch.Tensor, k_start: int = 3) -> int:
    """The largest k >= ``k_start`` whose k-truss holds an edge, else 0."""
    top = int(trussness.max()) if trussness.numel() else 0
    return top if top >= k_start else 0


def ktruss(trussness: torch.Tensor, tri: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alive, support)`` of the k-truss: the ``(m,)`` bool mask
    ``trussness >= k``, and the ``(m,)`` int64 count of each edge's
    triangles whose three edges are on the mask (0 off it)."""
    alive = trussness >= k
    inside = tri[alive[tri].all(1)]
    support = torch.bincount(inside.reshape(-1), minlength=trussness.shape[0])
    return alive, support
