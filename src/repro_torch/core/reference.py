"""Numpy K-truss oracles (independent of every implementation under test).

Pure-numpy set-intersection triangle counting on the upper-triangular CSR,
structurally independent of the eager and owner formulations and of the
CUDA kernel.  Copied from ``repro.core.reference`` so the port can check
itself where JAX is absent.
"""

from __future__ import annotations

import numpy as np

from ..graphs.csr import CSRGraph

__all__ = ["support_numpy", "ktruss_numpy", "trussness_numpy"]


def support_numpy(g: CSRGraph, alive: np.ndarray | None = None) -> np.ndarray:
    """Per-(upper-)edge triangle counts via sorted set intersection.

    Args:
      g: upper-triangular CSR graph.
      alive: optional (nnz,) bool mask of surviving edges.

    Returns:
      (nnz,) int64 support per nonzero (0 for dead edges).
    """
    alive = np.ones(g.nnz, bool) if alive is None else alive.astype(bool)
    # Undirected alive neighbor sets.
    rows = g.row_of_edge()
    src = np.concatenate([rows[alive], g.colidx[alive]])
    dst = np.concatenate([g.colidx[alive], rows[alive]])
    nbrs: list[np.ndarray] = [np.empty(0, np.int64)] * (g.n + 1)
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    bounds = np.searchsorted(src_s, np.arange(g.n + 2))
    for v in range(1, g.n + 1):
        nbrs[v] = np.sort(dst_s[bounds[v] : bounds[v + 1]])
    out = np.zeros(g.nnz, np.int64)
    for t in range(g.nnz):
        if not alive[t]:
            continue
        a, b = rows[t], g.colidx[t]
        out[t] = np.intersect1d(nbrs[a], nbrs[b], assume_unique=True).size
    return out


def ktruss_numpy(g: CSRGraph, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-point K-truss on the numpy oracle: returns (alive, support)."""
    alive = np.ones(g.nnz, bool)
    while True:
        s = support_numpy(g, alive)
        new_alive = alive & (s >= k - 2)
        if np.array_equal(new_alive, alive):
            return alive, s * alive
        alive = new_alive


def trussness_numpy(g: CSRGraph, k_start: int = 3) -> np.ndarray:
    """(nnz,) trussness per edge via level-by-level numpy peeling.

    Independent oracle for ``KTrussEngine.decompose()`` and the streaming
    maintenance invariant: an edge's trussness is the last k whose truss
    still contains it; edges never reaching the ``k_start``-truss keep the
    vacuous floor ``k_start - 1``.
    """
    trussness = np.full(g.nnz, max(2, k_start - 1), np.int64)
    alive = np.ones(g.nnz, bool)
    k = k_start
    while alive.any():
        while True:
            s = support_numpy(g, alive)
            new_alive = alive & (s >= k - 2)
            if np.array_equal(new_alive, alive):
                break
            alive = new_alive
        trussness[alive] = k
        k += 1
    return trussness
