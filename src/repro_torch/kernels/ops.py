"""The kernel-backed entry points (``repro.kernels.ops``'s counterparts).

* ``support_fine`` — the ``(problem, alive) -> support`` entry that the
  registry's ``pallas`` kernel axis runs; ``support_fine_stacked`` is its
  batched form.
* ``support_dense`` — Algorithm 1, ``S = (U @ U) ∘ U``, padded to the
  kernel's tile.

The tensor's device decides: on a CUDA tensor each launches its
hand-written Hopper kernel
(:func:`repro_torch.kernels.support_fine.support_fine_cuda`,
:func:`repro_torch.kernels.support_dense.support_dense_cuda`) or raises;
on a CPU tensor it runs the kernel's plain version
(:func:`repro_torch.core.eager_fine.support_fine_owner`,
:func:`repro_torch.kernels.support_dense.support_dense_torch`).  Each pair
computes the same function bit for bit; there is no fallback from one to
the other.
"""

from __future__ import annotations

import math

import torch

from ..core.eager_fine import FineProblem, _unstack, support_fine_owner
from .support_dense import TILE, support_dense_cuda, support_dense_torch
from .support_fine import support_fine_cuda

__all__ = ["support_fine", "support_fine_stacked", "support_dense"]


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


def support_fine_stacked(
    p: FineProblem, alive: torch.Tensor, *, window: int, chunk: int = 1024
) -> torch.Tensor:
    """Batched :func:`support_fine` over a leading batch axis.

    ``p``'s fields carry a leading ``(B, ...)`` dimension (one shape
    bucket, ``repro_torch.graphs.pack.stack_problems``) and ``alive`` is
    ``(B, nnzp)``; each member runs through :func:`support_fine` in turn.
    Returns (B, nnzp) int32 supports.
    """
    return torch.stack(
        [support_fine(m, alive[i], window=window, chunk=chunk) for i, m in enumerate(_unstack(p))]
    )


def support_dense(u_sym: torch.Tensor, *, block: int = 128) -> torch.Tensor:
    """S = (U @ U) ∘ U (float32) of a square 0/1 matrix of any real or bool
    dtype, padded with zeros to a multiple of ``lcm(block, 128)`` and sliced
    back, so the result never depends on ``block``.

    Raises ``ValueError`` on entries outside {0, 1} (one readback), the
    reference's domain.  U need not be symmetric.
    """
    if u_sym.dim() != 2 or u_sym.shape[0] != u_sym.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(u_sym.shape)}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if u_sym.is_complex():
        raise TypeError(f"support_dense needs a real or bool matrix, got {u_sym.dtype}")
    if u_sym.dtype != torch.bool and bool(((u_sym != 0) & (u_sym != 1)).any()):
        raise ValueError("support_dense needs a 0/1 matrix (an adjacency)")
    v = int(u_sym.shape[0])
    step = math.lcm(block, TILE)
    vp = -(-v // step) * step
    dev = u_sym.device
    if dev.type == "cuda":
        u = torch.zeros((vp, vp), dtype=torch.int8, device=dev)
        u[:v, :v] = u_sym
        return support_dense_cuda(u)[:v, :v]
    if dev.type != "cpu":
        raise ValueError(f"support_dense runs on CUDA or the CPU, got {dev}")
    u = torch.zeros((vp, vp), dtype=torch.float32)
    u[:v, :v] = u_sym
    return support_dense_torch(u)[:v, :v]
