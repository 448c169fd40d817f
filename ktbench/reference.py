"""The plain truss reference: every edge's trussness by peeling triangles.

Plain PyTorch on whatever device it is given, and independent of the
program: it takes the benchmark's own canonical edges (``(m, 2)``, ``u <
v``, sorted) and lists the graph's triangles itself, by the degree-ordered
wedge check, then peels levels to their fixed points on the triangle
list.  The trussness of an edge is the largest k whose k-truss (every edge
in at least k - 2 triangles of it) holds the edge; every edge is in the
2-truss.  ``trip_cap`` limits the peel's trips per level: the control
(``ktbench.control``) sets it to 1, which breaks the exactness the
configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["triangles", "trussness", "peel"]

WEDGE_BLOCK = 1 << 25  # wedges checked per block: bounds the reference's memory


def triangles(n: int, edges: torch.Tensor, *, block: int = WEDGE_BLOCK) -> torch.Tensor:
    """``(t, 3)`` int64 edge ids of every triangle, each once.

    Each edge is pointed from the endpoint of lower ``(degree, id)`` rank
    to the higher; a triangle is a wedge ``b <- a -> c`` (``b`` before
    ``c`` in rank) closed by the edge ``b -> c``."""
    dev = edges.device
    m = edges.shape[0]
    if m == 0:
        return torch.zeros((0, 3), dtype=torch.int64, device=dev)
    u, v = edges[:, 0], edges[:, 1]
    deg = torch.bincount(u, minlength=n) + torch.bincount(v, minlength=n)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[torch.argsort(deg * n + torch.arange(n, device=dev))] = torch.arange(n, device=dev)
    forward = rank[u] < rank[v]
    a = torch.where(forward, u, v)
    b = torch.where(forward, v, u)
    # Out-edges grouped by tail, heads in rank order.
    order = torch.argsort(rank[a] * n + rank[b])
    a, b, eid = a[order], b[order], order
    okey = rank[a] * n + rank[b]  # sorted: the lookup table for closing edges
    end = torch.searchsorted(rank[a], rank[a], side="right")
    later = end - torch.arange(m, device=dev) - 1  # wedges opened by each out-edge
    csum = torch.cumsum(later, 0)
    out = []
    lo = 0
    while lo < m:
        base = int(csum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(csum, base + block, side="right"))
        hi = max(hi, lo + 1)
        cnt = later[lo:hi]
        first = torch.repeat_interleave(torch.arange(lo, hi, device=dev), cnt)
        if first.numel():
            offs = torch.arange(first.numel(), device=dev) - torch.repeat_interleave(
                torch.cumsum(cnt, 0) - cnt, cnt
            )
            second = first + 1 + offs
            want = rank[b[first]] * n + rank[b[second]]
            pos = torch.searchsorted(okey, want).clamp(max=m - 1)
            hit = okey[pos] == want
            out.append(torch.stack([eid[first[hit]], eid[second[hit]], eid[pos[hit]]], 1))
        lo = hi
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=torch.int64, device=dev)


def peel(m: int, tri: torch.Tensor, *, trip_cap: int | None = None) -> torch.Tensor:
    """``(m,)`` int32 trussness from the triangle list.

    Level k removes every alive edge in fewer than k - 2 alive triangles,
    again and again until none is left (at most ``trip_cap`` times when it
    is given), and gives the removed edges trussness k - 1.  A removed
    edge's triangles die and take one from each of their edges' counts."""
    dev = tri.device
    t = torch.full((m,), 2, dtype=torch.int32, device=dev)
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    flat = tri.reshape(-1)
    count = torch.bincount(flat, minlength=m)  # triangles of each edge
    sup = count.clone()  # alive triangles of each edge
    # Each edge's triangles, grouped by edge from `first`.
    by_edge = torch.argsort(flat) // 3
    first = torch.cumsum(count, 0) - count
    tri_alive = torch.ones(tri.shape[0], dtype=torch.bool, device=dev)
    k = 3
    while bool(alive.any()):
        trips = 0
        while trip_cap is None or trips < trip_cap:
            gone = torch.nonzero(alive & (sup < k - 2)).squeeze(1)
            if not gone.numel():
                break
            trips += 1
            t[gone] = k - 1
            alive[gone] = False
            cnt = count[gone]
            ends = torch.cumsum(cnt, 0)
            slots = torch.repeat_interleave(first[gone] - ends + cnt, cnt)
            slots += torch.arange(slots.numel(), device=dev)
            dead = by_edge[slots]
            dead = torch.unique(dead[tri_alive[dead]])
            tri_alive[dead] = False
            sup -= torch.bincount(tri[dead].reshape(-1), minlength=m)
        k += 1
    return t


def trussness(n: int, edges: np.ndarray, device, *, trip_cap: int | None = None) -> np.ndarray:
    """``(m,)`` int32 trussness of the canonical ``edges`` on ``device``."""
    e = torch.as_tensor(np.ascontiguousarray(edges), dtype=torch.int64, device=device)
    tri = triangles(n, e)
    out = peel(e.shape[0], tri, trip_cap=trip_cap)
    return out.cpu().numpy()
