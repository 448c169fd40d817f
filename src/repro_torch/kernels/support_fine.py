"""Hand-written Hopper kernel for owner-mode fine-grained support.

``support_fine_cuda(p, alive)`` launches ``csrc/support_fine.cu`` and
returns the ``(nnz_pad,)`` int32 support that
:func:`repro_torch.core.eager_fine.support_fine_owner` (its plain version)
computes, bit for bit.  It replaces the TPU kernel
``repro.kernels.support_fine.support_fine_pallas`` *and* the window gather
that feeds it there (``repro.kernels.ops.support_fine``): a warp reads its
own CSR rows, so the ``(E, W)`` window arrays — about 16 GiB per support
pass at ``W = 4096`` over 262,144 lanes — never exist.  See the source for
the design and what bounds it.

The library is built from the checkout on the first launch
(:mod:`repro_torch.kernels.build`); a build or launch failure raises.
``support_fine_cuda.launches`` counts launches of the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.eager_fine import FineProblem, undirected_alive
from .build import BuiltLibrary, load_library

__all__ = ["support_fine_cuda", "load_support_fine"]

_FIELDS = ("edge_row", "colidx", "urowptr", "udeg", "ucolidx", "u2d")


def load_support_fine() -> BuiltLibrary:
    """Build (on first use) and load the kernel library; ctypes signatures set."""
    built = load_library("support_fine")
    fn = built.lib.support_fine_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = built.lib.support_fine_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(p: FineProblem, alive: torch.Tensor) -> None:
    dev = alive.device
    if dev.type != "cuda":
        raise ValueError(f"support_fine_cuda needs CUDA tensors, got {dev}")
    if alive.dtype != torch.bool or alive.shape != (p.nnz_pad,):
        raise ValueError(
            f"alive must be bool of shape ({p.nnz_pad},), got {alive.dtype} {tuple(alive.shape)}"
        )
    for name in _FIELDS:
        x = getattr(p, name)
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(
                f"problem field {name!r} must be a contiguous int32 tensor on {dev}, "
                f"got {x.dtype} on {x.device}"
            )


def support_fine_cuda(p: FineProblem, alive: torch.Tensor) -> torch.Tensor:
    """Owner-mode support of every directed lane, by the CUDA kernel."""
    _check(p, alive)
    built = load_support_fine()
    dev = alive.device
    alive = alive.contiguous()
    ualive = undirected_alive(p, alive).contiguous()
    out = torch.empty(p.nnz_pad, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.support_fine_launch(
            p.edge_row.data_ptr(),
            p.colidx.data_ptr(),
            alive.data_ptr(),
            p.urowptr.data_ptr(),
            p.udeg.data_ptr(),
            p.ucolidx.data_ptr(),
            ualive.data_ptr(),
            out.data_ptr(),
            p.nnz_pad,
            stream,
        )
    if rc:
        msg = built.lib.support_fine_error_string(rc).decode()
        raise RuntimeError(f"support_fine kernel launch failed: {msg} (cudaError {rc})")
    support_fine_cuda.launches += 1
    return out


support_fine_cuda.launches = 0
