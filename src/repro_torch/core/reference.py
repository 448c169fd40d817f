"""Reference K-truss implementations (oracles for tests and kernels).

Two independent oracles, as in ``repro.core.reference``:

* :func:`support_dense` / :func:`ktruss_dense` — Algorithm 1 of the paper,
  the linear-algebraic form ``S = (A·A) ∘ A`` over the *symmetric* dense
  adjacency, pruned to a fixed point.  Plain torch, O(n³): small graphs.
  Neither calls the dense kernel (``repro_torch.kernels.ops.support_dense``).
* :func:`support_numpy` — pure-numpy set-intersection triangle counting on
  the upper-triangular CSR; structurally independent of both the dense
  form and the eager, owner and CUDA implementations.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graphs.csr import CSRGraph

__all__ = [
    "support_dense",
    "ktruss_dense",
    "support_numpy",
    "ktruss_numpy",
    "trussness_numpy",
    "kmax_numpy",
]


# ---------------------------------------------------------------------- #
# Dense linear-algebraic oracle (Algorithm 1)
# ---------------------------------------------------------------------- #
def support_dense(adj_sym: torch.Tensor) -> torch.Tensor:
    """S = (A @ A) ∘ A on a dense symmetric 0/1 adjacency."""
    return (adj_sym @ adj_sym) * adj_sym


def ktruss_dense(
    adj_sym: torch.Tensor, k: int, max_iters: int = 10_000
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-point prune loop of Algorithm 1 on the dense symmetric form.

    The reference's ``(adj, support, changed)`` loop in float32, one
    readback of ``changed`` per trip, at most ``max_iters`` trips (the
    fixed point comes after at most one trip per edge).

    Returns (adj_final, support_final); ``adj_final`` is the K-truss.
    """
    adj = adj_sym.to(torch.float32)
    for _ in range(max(1, max_iters)):
        s = support_dense(adj)
        mask = (s >= (k - 2)).to(adj.dtype) * adj
        changed = bool((mask != adj).any())
        adj, s = mask, s * mask
        if not changed:
            break
    return adj, s


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


def kmax_numpy(g: CSRGraph, k_start: int = 3) -> int:
    """Largest k with a non-empty k-truss (0 if even the ``k_start``-truss
    is empty): the top of :func:`trussness_numpy`'s peel."""
    trussness = trussness_numpy(g, k_start)
    top = int(trussness.max()) if trussness.size else 0
    return top if top >= k_start else 0
