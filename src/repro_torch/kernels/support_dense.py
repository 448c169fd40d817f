"""Dense linear-algebraic support (Algorithm 1): ``S = (U @ U) ∘ U``.

``support_dense_cuda(u)`` launches the hand-written Hopper kernels of
``csrc/support_dense.cu``: a transpose that writes Uᵀ (``wgmma`` takes
8-bit operands K-major only, so the second operand must be Uᵀ), then the
product, int8 operands on the tensor cores (``wgmma`` m64n256k32 fed by
TMA loads, s32 accumulators) in one persistent CTA per SM walking
128 × 256 output tiles.  It replaces the TPU kernel
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

__all__ = [
    "support_dense_cuda",
    "support_dense_torch",
    "transpose_cuda",
    "load_support_dense",
    "TILE",
]

TILE = 128  # the kernel's output tile: V must be a multiple of it


def load_support_dense() -> BuiltLibrary:
    """Build (on first use) and load the kernel library; ctypes signatures set."""
    built = load_library("support_dense")
    fn = built.lib.support_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    tr = built.lib.support_dense_transpose
    tr.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
    tr.restype = ctypes.c_int
    built.lib.support_dense_smem_bytes.argtypes = []
    built.lib.support_dense_smem_bytes.restype = ctypes.c_int
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


def _raise_on(rc: int, built: BuiltLibrary) -> None:
    if rc:
        msg = built.lib.support_dense_error_string(rc).decode()
        raise DeviceError(
            f"support_dense kernel launch failed: {msg} (cudaError {rc})", site="support_dense"
        )


def transpose_cuda(u: torch.Tensor) -> torch.Tensor:
    """Uᵀ, contiguous, by the library's own transpose kernel: the first
    half of :func:`support_dense_cuda`, on its own so that its share of
    the call can be timed.  Same input contract as the product."""
    _check(u)
    built = load_support_dense()
    v = int(u.shape[0])
    ut = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = built.lib.support_dense_transpose(u.data_ptr(), ut.data_ptr(), v, stream)
    _raise_on(rc, built)
    return ut


def support_dense_cuda(u: torch.Tensor) -> torch.Tensor:
    """``S = (U @ U) ∘ U`` of a (V, V) 0/1 int8 CUDA matrix, V % 128 == 0,
    by the CUDA kernels; returns (V, V) float32.  U need not be symmetric."""
    _check(u)
    built = load_support_dense()
    v = int(u.shape[0])
    ut = torch.empty_like(u)  # scratch: the kernel writes Uᵀ here first (V² bytes)
    out = torch.empty((v, v), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = built.lib.support_dense_launch(u.data_ptr(), ut.data_ptr(), out.data_ptr(), v, stream)
    _raise_on(rc, built)
    support_dense_cuda.launches += 1
    return out


support_dense_cuda.launches = 0
