"""repro_torch — the K-truss system in PyTorch, with hand-written CUDA kernels.

A port of the JAX package ``repro`` (which stays the reference) to PyTorch
on an NVIDIA H100.  Module names mirror ``repro``'s, so each counterpart
sits at the same relative path.  The front door is :mod:`repro_torch.api`
(``TrussQuery``, ``solve()``, ``Session``); its entry points run on the
CUDA device unless the caller passes ``device="cpu"``.

This package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``repro``.
"""
