"""Flat-task index mathematics: row recovery and sorted-window search.

The fine-grained Eager K-truss iterates a *flat* range of nonzero tasks,
recovers each task's row from the CSR row pointers (the paper's flat-range
to row mapping) and intersects fixed-width sorted neighbour windows per
task.  These helpers are the torch counterparts of ``repro.core.taskmap``.
"""

from __future__ import annotations

import torch

__all__ = [
    "row_of_task",
    "window_gather",
    "batched_searchsorted",
    "sorted_window_member",
    "segment_offsets",
]


def row_of_task(rowptr: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Recover the 1-based row id of flat task(s) ``t``.

    ``rowptr`` is the (n+1,) CSR row-pointer array over 1-based rows: row v
    spans ``[rowptr[v-1], rowptr[v])``.  One binary search per task.
    """
    t = torch.as_tensor(t, dtype=rowptr.dtype, device=rowptr.device)
    return torch.searchsorted(rowptr, t, right=True, out_int32=True)


def window_gather(
    flat: torch.Tensor, starts: torch.Tensor, width: int, fill
) -> torch.Tensor:
    """Gather fixed-width windows ``flat[starts[e] : starts[e]+width]``.

    Out-of-range lanes read ``fill``.  Shapes: starts (E,) -> out (E, width).
    """
    offs = torch.arange(width, dtype=torch.int32, device=flat.device)[None, :]
    idx = starts[:, None].to(torch.int32) + offs
    valid = (idx >= 0) & (idx < flat.shape[0])
    vals = flat[idx.clamp(0, max(flat.shape[0] - 1, 0))]
    return torch.where(valid, vals, torch.as_tensor(fill, dtype=flat.dtype, device=flat.device))


def batched_searchsorted(b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row-wise ``searchsorted(b[e], q[e], side='left')``.

    Args:
      b: (E, Wb) ascending per row.
      q: (E, Wq) query values, same dtype as ``b``.

    Returns:
      (E, Wq) int32 insertion positions in ``[0, Wb]``.
    """
    return torch.searchsorted(b.contiguous(), q.contiguous(), out_int32=True)


def sorted_window_member(
    a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Membership of each a-lane in the sorted window b (per row).

    Args:
      a: (E, Wa) query values (invalid lanes must be < 1, e.g. the 0
         sentinel — vertex ids are 1-based).
      b: (E, Wb) ascending windows (invalid lanes must be a +inf-like
         sentinel strictly greater than any valid id).

    Returns:
      member: (E, Wa) bool — a[e,w] appears in b[e,:].
      pos:    (E, Wa) int32 — position of the match in b (undefined where
              ``member`` is False; callers must mask).
    """
    wb = b.shape[1]
    pos = batched_searchsorted(b, a)
    # Clamp explicitly: an out-of-range gather index raises on the CPU and
    # trips a device assert on CUDA.
    safe = pos.clamp(max=wb - 1).long()
    hit = torch.gather(b, 1, safe) == a
    member = hit & (a >= 1) & (pos < wb)
    return member, pos


def segment_offsets(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Boundaries of equal-id runs in a sorted id array.

    Returns (num_segments + 1,) int32 offsets such that segment s spans
    ``[off[s], off[s+1])`` — the inverse of :func:`row_of_task`.
    """
    ids = torch.arange(num_segments + 1, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids.contiguous(), ids, out_int32=True)
