"""Plain torch oracles of the TPU kernels' contracts (``repro.kernels.ref``).

``support_tiles_ref`` is the function
``repro.kernels.support_fine.support_fine_pallas`` computes from
pre-gathered ``(E, W)`` windows.  The port's CUDA kernel reads the CSR
itself and has no window arrays; this oracle pins the window semantics in
the parity tests.  ``support_dense_ref`` is Algorithm 1, the function of
``repro.kernels.support_dense.support_dense_pallas``.
"""

from __future__ import annotations

import torch

__all__ = ["support_tiles_ref", "support_dense_ref"]


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


def support_dense_ref(u_sym: torch.Tensor) -> torch.Tensor:
    """Dense linear-algebraic support: S = (U @ U) ∘ U (Algorithm 1)."""
    return (u_sym @ u_sym) * u_sym
