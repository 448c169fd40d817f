"""The 10th DIMACS Implementation Challenge's Delaunay graph
(``delaunay_n<log2_n>``), drawn from the run's seed: a frozen copy of the
published rule, with the vertex ids in ascending degree.

``n = 2**log2_n`` points uniform in the unit square, drawn as the random
geometric graph's are (``rgg.points``: float64, one ``torch.Generator`` on
``device``), and an edge for each side of each triangle of their Delaunay
triangulation, which Qhull computes on the host
(``scipy.spatial.Delaunay``).  Vertex ids are then renumbered by
ascending degree, ties by point index (a stable sort): the orientation
that triangle-counting and truss codes give a graph before they count.
"""

from __future__ import annotations

import numpy as np
import torch

from ktbench import by_file
from ktbench.generators import canonical, derived_seed

NUMBERINGS = ("degree_ascending",)


def triangulation_edges(pts: torch.Tensor) -> torch.Tensor:
    """``(m, 2)`` int64 pairs ``(i, j)``, ``i < j``, each once: the sides of
    every triangle of the points' Delaunay triangulation, in point ids, on
    the points' device."""
    from scipy.spatial import Delaunay

    tri = torch.from_numpy(Delaunay(pts.cpu().numpy()).simplices.astype(np.int64))
    tri = tri.to(pts.device)
    sides = torch.cat([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [0, 2]]])
    n = pts.shape[0]
    u = torch.minimum(sides[:, 0], sides[:, 1])
    v = torch.maximum(sides[:, 0], sides[:, 1])
    key = torch.unique(u * n + v)
    return torch.stack([key // n, key % n], 1)


def by_ascending_degree(n: int, edges: torch.Tensor) -> torch.Tensor:
    """``edges`` renumbered so that id ``r`` is the vertex of rank ``r`` by
    (undirected degree, point index)."""
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    order = torch.argsort(deg, stable=True)
    new_id = torch.empty_like(order)
    new_id[order] = torch.arange(n, device=order.device)
    return new_id[edges]


def graph(config: dict, seed: int, index: int, device) -> tuple[int, np.ndarray]:
    numbering = config["numbering"]
    if numbering not in NUMBERINGS:
        raise ValueError(f"unknown numbering {numbering!r} (have {NUMBERINGS})")
    rgg = by_file.load("graph_generators", "rgg", "generator")
    n = 1 << int(config["log2_n"])
    pts = rgg.points(n, derived_seed(seed, index), device)
    return n, canonical(n, by_ascending_degree(n, triangulation_edges(pts)))
