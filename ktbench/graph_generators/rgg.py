"""The 10th DIMACS Implementation Challenge's random geometric graph
(``rgg_n_2_<log2_n>_s0``), drawn from the run's seed: a frozen copy of the
published rule.

``n = 2**log2_n`` points uniform in the unit square, and an edge wherever
two points lie closer than ``r = radius_factor * sqrt(ln n / n)``.  Pairs
are found through a grid of square cells of side ``1 / floor(1 / r)``, at
least ``r``: a point is compared with the later points of its own cell and
with every point of the four cells after it (right, and the three below),
its distances in float64, so that each pair is looked at once.  Vertex ids
follow the points' row-major cell order, and within a cell their order by
``x``: a spatial numbering, like the published files'.  The points are
drawn on ``device`` by one ``torch.Generator``; the pairs are found in
blocks of points, so that the memory stays within a few hundred MB at
2**20 points.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ktbench.generators import canonical, derived_seed

BLOCK = 1 << 17  # points whose candidate pairs are held at once


def radius(n: int, factor: float) -> float:
    return factor * math.sqrt(math.log(n) / n)


def points(n: int, seed: int, device) -> torch.Tensor:
    """``(n, 2)`` float64 points uniform in ``[0, 1)**2``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)


def spatial_order(pts: torch.Tensor, side: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The points renumbered by cell (row-major: row by ``y``, column by
    ``x``), then by ``x`` within a cell; and each renumbered point's cell."""
    cx = (pts[:, 0] * side).long().clamp_(max=side - 1)
    cy = (pts[:, 1] * side).long().clamp_(max=side - 1)
    by_x = torch.argsort(pts[:, 0], stable=True)
    cell = cy * side + cx
    order = by_x[torch.argsort(cell[by_x], stable=True)]
    return pts[order], cell[order]


def rgg_edges(pts: torch.Tensor, r: float, *, block: int = BLOCK) -> torch.Tensor:
    """``(m, 2)`` int64 pairs ``(i, j)``, ``i < j``, of the points (in the
    spatial order of :func:`spatial_order`) closer than ``r``."""
    dev, n = pts.device, pts.shape[0]
    side = max(1, math.floor(1.0 / r))
    pts, cell = spatial_order(pts, side)
    count = torch.bincount(cell, minlength=side * side)
    start = torch.cumsum(count, 0) - count
    r2 = r * r
    out = []
    for lo in range(0, n, block):
        i = torch.arange(lo, min(lo + block, n), device=dev)
        c = cell[i]
        cx, cy = c % side, c // side
        # Candidate ranges [first, first + size): the rest of the own cell,
        # then the cells right, below-left, below and below-right.
        firsts, sizes = [i + 1], [start[c] + count[c] - i - 1]
        for dy, dx in ((0, 1), (1, -1), (1, 0), (1, 1)):
            ok = (cx + dx >= 0) & (cx + dx < side) & (cy + dy < side)
            nc = torch.where(ok, c + dy * side + dx, 0)
            firsts.append(start[nc])
            sizes.append(torch.where(ok, count[nc], 0))
        first, size = torch.cat(firsts), torch.cat(sizes)
        src = i.repeat(len(firsts))
        total = int(size.sum())
        a = torch.repeat_interleave(src, size, output_size=total)
        b = torch.repeat_interleave(first - (torch.cumsum(size, 0) - size), size,
                                    output_size=total) + torch.arange(total, device=dev)
        d = pts[a] - pts[b]
        near = (d * d).sum(1) < r2
        out.append(torch.stack([a[near], b[near]], 1))
    return torch.cat(out) if out else torch.zeros((0, 2), dtype=torch.int64, device=dev)


def graph(config: dict, seed: int, index: int, device) -> tuple[int, np.ndarray]:
    n = 1 << int(config["log2_n"])
    pts = points(n, derived_seed(seed, index), device)
    return n, canonical(n, rgg_edges(pts, radius(n, float(config["radius_factor"]))))
