"""Plain torch oracle of the TPU support kernel's window contract.

A literal copy of ``repro.kernels.ref.support_tiles_ref``: the function
``repro.kernels.support_fine.support_fine_pallas`` computes from
pre-gathered ``(E, W)`` windows.  The port's CUDA kernel reads the CSR
itself and has no window arrays; this oracle pins the window semantics in
the parity tests.
"""

from __future__ import annotations

import torch

__all__ = ["support_tiles_ref"]


def support_tiles_ref(
    a_nav: torch.Tensor,
    a_ok: torch.Tensor,
    b_nav: torch.Tensor,
    b_ok: torch.Tensor,
) -> torch.Tensor:
    """Per-edge sorted-window intersection counts (owner-mode support).

    Args:
      a_nav: (E, W) int32 — query window per edge (invalid lanes hold a
        sentinel ≥ LARGE; they are excluded via ``a_ok``).
      a_ok:  (E, W) bool — query lane validity (structural ∧ alive).
      b_nav: (E, W) int32 — ascending navigation window (invalid = LARGE).
      b_ok:  (E, W) bool — membership lane validity of ``b_nav``.

    Returns:
      (E,) int32 — |{w : a_ok[e,w] ∧ ∃w': b_nav[e,w'] == a_nav[e,w] ∧ b_ok[e,w']}|
    """
    # O(W²) dense equality — deliberately the most literal semantics.
    eq = a_nav[:, :, None] == b_nav[:, None, :]
    eq &= a_ok[:, :, None] & b_ok[:, None, :]
    return eq.any(dim=2).sum(dim=1).to(torch.int32)
