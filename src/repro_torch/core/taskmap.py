"""Flat-task index mathematics: sorted-window membership on tensors.

The fine-grained Eager K-truss iterates a *flat* range of nonzero tasks and
intersects fixed-width sorted neighbour windows per task.  These helpers
are the torch counterparts of ``repro.core.taskmap``'s window search.
"""

from __future__ import annotations

import torch

__all__ = ["batched_searchsorted", "sorted_window_member"]


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
