"""A WHILE conditional node in a captured CUDA graph (``csrc/graph_while.cu``).

:func:`while_loop` is used while a ``torch.cuda.CUDAGraph`` is being
captured on the current stream: it adds a WHILE node whose condition is a
device bool that ``cond()`` computes, and captures ``body()`` into the
node's body followed by ``cond()`` again, so on every replay the device
runs the body for as long as it finds the condition true, with no host
work per iteration.  It is the graph form of
``while cond(): body()`` (the reference's ``lax.while_loop``), for PyTorch
releases that cannot capture a conditional node (2.11 cannot).

The body is captured on its own stream ``body``, and its allocations come
from ``pool`` (a ``torch.cuda.MemPool`` kept alive with the graph): the
caching allocator routes a capture's allocations to the graph's pool only
for the capturing stream itself.  A body's temporaries are static in the
graph, so every iteration reuses the same memory.

The library is built from the checkout on first use, like the kernels
(:mod:`repro_torch.kernels.build`).  Errors raise
:class:`~repro_torch.errors.DeviceError` with ``site="peel_graph"``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from ..errors import DeviceError
from .build import BuiltLibrary, load_library

__all__ = ["GRAPH_SITE", "MIN_CUDA", "cuda_versions", "load_graph_while", "while_loop"]

GRAPH_SITE = "peel_graph"  # the DeviceError site of a capture or replay failure
MIN_CUDA = 12040  # conditional WHILE nodes: CUDA 12.4 runtime and driver
# torch's capture_error_mode names as cudaStreamCaptureMode values.
_MODES = {"global": 0, "thread_local": 1, "relaxed": 2}

_checked: set[str] = set()  # library paths whose runtime and driver passed the check


def load_graph_while() -> BuiltLibrary:
    """Build (on first use) and load the library; ctypes signatures set.
    Raises when the CUDA runtime or driver is older than 12.4."""
    built = load_library("graph_while")
    lib = built.lib
    key = str(built.path)
    if key in _checked:
        return built
    lib.graph_while_versions.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.graph_while_begin.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
    ]
    lib.graph_while_end.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p]
    lib.graph_while_error_string.argtypes = [ctypes.c_int]
    lib.graph_while_error_string.restype = ctypes.c_char_p
    for fn in (lib.graph_while_versions, lib.graph_while_begin, lib.graph_while_end):
        fn.restype = ctypes.c_int
    runtime, driver = cuda_versions(built)
    if min(runtime, driver) < MIN_CUDA:
        raise DeviceError(
            f"CUDA graph conditional nodes need a CUDA {MIN_CUDA // 1000}.{MIN_CUDA % 1000 // 10} "
            f"runtime and driver; found runtime {runtime}, driver {driver}",
            site=GRAPH_SITE,
        )
    _checked.add(key)
    return built


def cuda_versions(built: BuiltLibrary) -> tuple[int, int]:
    """The library's CUDA runtime version and the driver's (``12040`` is 12.4)."""
    runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
    rc = built.lib.graph_while_versions(ctypes.byref(runtime), ctypes.byref(driver))
    _raise_on(built.lib, rc, "version query")
    return runtime.value, driver.value


def _raise_on(lib, rc: int, what: str) -> None:
    if rc:
        msg = lib.graph_while_error_string(rc).decode()
        raise DeviceError(f"CUDA graph {what} failed: {msg} (cudaError {rc})", site=GRAPH_SITE)


def _device_bool(pred: torch.Tensor) -> torch.Tensor:
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(
            f"cond() must give one CUDA bool, got {pred.dtype} {tuple(pred.shape)} on {pred.device}"
        )
    return pred


def while_loop(
    cond: Callable[[], torch.Tensor],
    body_fn: Callable[[], None],
    body: torch.cuda.Stream,
    pool,
    mode: str = "thread_local",
) -> None:
    """Capture ``while cond(): body_fn()`` as one WHILE node.  ``cond`` gives
    a one-element CUDA bool tensor; ``body_fn`` must leave its results where
    the next ``cond()`` reads them.  Must run inside a capture on the
    current stream; ``mode`` is that capture's ``capture_error_mode``, which
    the body's capture takes too."""
    lib = load_graph_while().lib
    first = _device_bool(cond())
    capture = torch.cuda.current_stream(first.device)
    handle = ctypes.c_ulonglong(0)
    rc = lib.graph_while_begin(
        capture.cuda_stream, first.data_ptr(), body.cuda_stream, _MODES[mode],
        ctypes.byref(handle),
    )
    _raise_on(lib, rc, "WHILE node capture")
    try:
        with torch.cuda.stream(body), torch.cuda.use_mem_pool(pool, first.device):
            body_fn()
            again = _device_bool(cond())
    except BaseException:
        lib.graph_while_end(body.cuda_stream, handle, None)  # the block's own error is the one to report
        raise
    _raise_on(lib, lib.graph_while_end(body.cuda_stream, handle, again.data_ptr()),
              "WHILE body capture")
