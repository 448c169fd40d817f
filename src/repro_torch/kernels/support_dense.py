"""Dense linear-algebraic support (Algorithm 1): ``S = (U @ U) ∘ U``.

``support_dense_cuda(u)`` launches the hand-written Hopper kernel
``csrc/support_dense.cu``: int8 operands on the tensor cores
(``mma.sync`` m16n8k32, s32 accumulators), one CTA per 128 × 128 output
tile.  It replaces the TPU kernel
``repro.kernels.support_dense.support_dense_pallas``.  See the source for
the design and what bounds it.  :func:`support_dense_torch` is its plain
version.  Both return float32 and agree bit for bit on 0/1 inputs: the
kernel sums exactly in int32, and every count is at most V < 2²⁴, so
float32 holds it exactly.

The library is built from the checkout on the first launch
(:mod:`repro_torch.kernels.build`); a build or launch failure raises.
``support_dense_cuda.launches`` counts launches of the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..errors import DeviceError
from .build import BuiltLibrary, load_library

__all__ = ["support_dense_cuda", "support_dense_torch", "load_support_dense", "TILE"]

TILE = 128  # the kernel's output tile: V must be a multiple of it


def load_support_dense() -> BuiltLibrary:
    """Build (on first use) and load the kernel library; ctypes signatures set."""
    built = load_library("support_dense")
    fn = built.lib.support_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = built.lib.support_dense_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def support_dense_torch(u: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(u @ u) * u`` in float32.

    A float32 matrix product on CUDA runs without TF32 by default
    (``torch.backends.cuda.matmul.allow_tf32`` is False); with 0/1
    operands and float32 accumulation the result would be exact either
    way, since TF32 holds 0 and 1 exactly.
    """
    u32 = u.to(torch.float32)
    return (u32 @ u32) * u32


def _check(u: torch.Tensor) -> None:
    if u.device.type != "cuda":
        raise ValueError(f"support_dense_cuda needs a CUDA tensor, got {u.device}")
    if u.dtype != torch.int8:
        raise ValueError(f"support_dense_cuda needs int8, got {u.dtype}")
    if u.dim() != 2 or u.shape[0] != u.shape[1] or u.shape[0] % TILE:
        raise ValueError(
            f"support_dense_cuda needs a square (V, V) matrix with V % {TILE} == 0, "
            f"got {tuple(u.shape)}"
        )
    if not u.is_contiguous() or u.data_ptr() % 16:
        raise ValueError("support_dense_cuda needs a contiguous, 16-byte aligned tensor")


def support_dense_cuda(u: torch.Tensor) -> torch.Tensor:
    """``S = (U @ U) ∘ U`` of a (V, V) 0/1 int8 CUDA matrix, V % 128 == 0,
    by the CUDA kernel; returns (V, V) float32.  U need not be symmetric."""
    _check(u)
    built = load_support_dense()
    v = int(u.shape[0])
    ut = u.t().contiguous()  # the B operand, k-contiguous: V² bytes
    out = torch.empty((v, v), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = built.lib.support_dense_launch(u.data_ptr(), ut.data_ptr(), out.data_ptr(), v, stream)
    if rc:
        msg = built.lib.support_dense_error_string(rc).decode()
        raise DeviceError(
            f"support_dense kernel launch failed: {msg} (cudaError {rc})", site="support_dense"
        )
    support_dense_cuda.launches += 1
    return out


support_dense_cuda.launches = 0
