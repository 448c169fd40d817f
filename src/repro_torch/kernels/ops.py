"""``support_fine``: the kernel-backed ``(problem, alive) -> support`` entry.

The port's counterpart of ``repro.kernels.ops.support_fine``, and what the
registry's ``pallas`` kernel axis runs.  The tensor's device decides:

* on a CUDA tensor it launches the hand-written Hopper kernel
  (:func:`repro_torch.kernels.support_fine.support_fine_cuda`) or raises;
* on a CPU tensor it runs the kernel's plain version,
  :func:`repro_torch.core.eager_fine.support_fine_owner`.

Both compute the same function bit for bit; there is no fallback from one
to the other.
"""

from __future__ import annotations

import torch

from ..core.eager_fine import FineProblem, support_fine_owner
from .support_fine import support_fine_cuda

__all__ = ["support_fine"]


def support_fine(
    p: FineProblem, alive: torch.Tensor, *, window: int, chunk: int = 1024
) -> torch.Tensor:
    """Owner-mode fine-grained support (``window`` ≥ max undirected degree;
    ``chunk`` must divide ``nnz_pad``).

    Semantically identical to :func:`support_fine_owner`, which is also
    what it runs for a CPU tensor.
    """
    if p.nnz_pad % chunk:
        raise ValueError(f"need chunk | nnz_pad, got {chunk}/{p.nnz_pad}")
    if alive.device.type == "cuda":
        return support_fine_cuda(p, alive)
    if alive.device.type != "cpu":
        raise ValueError(f"support_fine runs on CUDA or the CPU, got {alive.device}")
    return support_fine_owner(p, alive, window=window, chunk=chunk)
