"""The kernels' yardstick: bytes counted from the graph and the
reference's trussness, never from the program's arrays.

A graph's CSR is read as int32: ``n + 1`` row offsets and one column per
undirected edge (the upper triangle).  A pass over a set of alive edges
reads their CSR once and writes one int32 per alive edge.  A decompose
runs one level per k from 2 to kmax: the level that gives trussness k to
the edges it removes starts from the edges of trussness k or more.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "PEAK_BYTES_PER_S", "pass_bytes", "level_bytes", "roofline_pct",
]

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet (700 W)


def pass_bytes(n: int, alive_edges: int) -> int:
    """One pass over ``alive_edges`` of an ``n``-vertex graph: the CSR read
    once, one int32 written per edge."""
    return 4 * (n + 1) + 4 * alive_edges + 4 * alive_edges


def level_bytes(n: int, trussness: np.ndarray) -> int:
    """Every level of one decompose, each a pass over its starting edges."""
    t = np.asarray(trussness)
    if not t.size:
        return 0
    at_least = np.cumsum(np.bincount(t)[::-1])[::-1]  # at_least[k] = #{t >= k}
    return sum(pass_bytes(n, int(at_least[k])) for k in range(2, int(t.max()) + 1))


def roofline_pct(nbytes: float, seconds: float) -> float:
    """The bytes bound's time over the measured time, in percent."""
    return 100.0 * nbytes / PEAK_BYTES_PER_S / seconds
