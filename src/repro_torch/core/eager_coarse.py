"""Coarse-grained parallel Eager K-truss support computation (Algorithm 2).

One task per **row** (vertex) of the upper-triangular adjacency — the
baseline decomposition of Low et al. that the paper's contribution
replaces.  Every row task is padded to the maximum degree in *both* the
neighbour dimension and the per-neighbour window, so the work per block
of C rows is ``C × W × W`` regardless of how sparse the rows are: the
padding waste the paper's fine-grained formulation removes.
"""

from __future__ import annotations

import torch

from .eager_fine import _WINDOW_ELEMS, FineProblem, _row_start
from .taskmap import sorted_window_member

__all__ = ["support_coarse_eager"]


def support_coarse_eager(
    p: FineProblem, alive: torch.Tensor, *, window: int
) -> torch.Tensor:
    """Support per directed edge via row-parallel eager updates (Alg. 2).

    Args:
      p: problem tensors (``prepare_fine`` — shared with the fine algorithm).
      alive: (nnzp,) bool mask over directed edges.
      window: width ≥ max out-degree.

    Rows run in blocks sized so each ``(rows, W, W)`` intermediate stays
    near ``_WINDOW_ELEMS`` elements (the reference scans fixed blocks of
    ``row_chunk`` rows; the sums are integers, so the block size does not
    change the result).

    Returns:
      (nnzp,) int32 support (0 on dead/pad lanes).
    """
    n, nnzp = p.n, p.nnz_pad
    w = int(window)
    c = max(1, _WINDOW_ELEMS // (w * w))
    dev = p.device
    large = n + 2
    offs = torch.arange(w, dtype=torch.int32, device=dev)
    s_acc = torch.zeros(nnzp + 1, dtype=torch.int32, device=dev)
    suffix = offs[None, None, :] > offs[None, :, None]  # w > j

    for first in range(1, n + 1, c):
        v = torch.arange(first, min(first + c, n + 1), dtype=torch.int32, device=dev)
        rows = v.shape[0]

        start = _row_start(p.rowptr, v)  # (C,)
        a_idx = start[:, None] + offs[None, :]  # (C, W) global slots
        a_in = offs[None, :] < p.deg[v][:, None]
        a_idx_c = a_idx.clamp(0, nnzp - 1)
        a_vals = torch.where(a_in, p.colidx[a_idx_c], 0)  # κ per (c, j)
        a_alive = a_in & alive[a_idx_c]

        # Row-κ windows for every j: (C, W, W).
        kappa = a_vals
        b_start = _row_start(p.rowptr, kappa)  # (C, W)
        b_idx = b_start[:, :, None] + offs[None, None, :]
        b_in = offs[None, None, :] < p.deg[kappa][:, :, None]
        b_idx_c = b_idx.clamp(0, nnzp - 1)
        b_nav = torch.where(b_in, p.colidx[b_idx_c], large)
        b_alive = b_in & alive[b_idx_c]

        # Suffix queries: task (c, j) intersects a_vals[c, j+1:] with row κ.
        task_ok = a_alive  # edge (v_c, κ_j) itself must be alive
        q = torch.where(
            suffix & a_alive[:, None, :] & task_ok[:, :, None],
            a_vals[:, None, :],
            0,
        )  # (C, W, W): queries for task (c, j)

        member, pos = sorted_window_member(
            q.reshape(rows * w, w), b_nav.reshape(rows * w, w)
        )
        member = member.reshape(rows, w, w)
        pos_c = pos.reshape(rows, w, w).clamp(max=w - 1)
        member &= torch.gather(b_alive, 2, pos_c.long())
        ones = member.to(torch.int32)

        # u1: edge (v, κ_j) gains the intersection count.
        u1_tgt = torch.where(task_ok, a_idx_c, nnzp)
        s_acc.index_add_(0, u1_tgt.reshape(-1), ones.sum(dim=2, dtype=torch.int32).reshape(-1))
        # u2: matched suffix entries (edges (v, m)).
        u2_tgt = torch.where(member.any(dim=1), a_idx_c, nnzp)
        s_acc.index_add_(0, u2_tgt.reshape(-1), ones.sum(dim=1, dtype=torch.int32).reshape(-1))
        # u3: matched row-κ entries (edges (κ, m)).
        u3_tgt = torch.where(member, b_start[:, :, None] + pos_c, nnzp)
        s_acc.index_add_(0, u3_tgt.reshape(-1), ones.reshape(-1))
    return s_acc[:nnzp]
