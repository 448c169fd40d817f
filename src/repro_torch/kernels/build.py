"""Build the port's CUDA sources into shared libraries loaded with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) on first use, into ``_build/`` beside this
file (listed in ``.gitignore``).  The library's file name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header is rebuilt and an unchanged one is reused.  A failed build
raises :class:`~repro_torch.errors.CompileError` (``site="kernel_build"``);
nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ..errors import CompileError

__all__ = ["BuiltLibrary", "NVCC_FLAGS", "load_library"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A loaded kernel library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_s: float  # nvcc wall time in this process (0.0 when reused)
    log: str  # nvcc's output when the library was built (ptxas' register/spill report)


_lock = threading.Lock()  # guards _locks
_locks: dict[str, threading.Lock] = {}  # one per library: builds run in parallel
_loaded: dict[str, BuiltLibrary] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # lazy: CUDA-only path

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = cand if os.path.exists(cand) else None
    if found is None:
        raise CompileError(
            "nvcc not found (on PATH or under CUDA_HOME/bin)",
            site="kernel_build",
            cause=FileNotFoundError("nvcc"),
        )
    return found


def load_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.

    Different libraries build concurrently when called from several
    threads; one library builds once."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        src = CSRC / f"{name}.cu"
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + "\0".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        BUILD_DIR.mkdir(exist_ok=True)
        out = BUILD_DIR / f"{name}-{digest}.so"
        log_path = out.with_suffix(".log")
        build_s = 0.0
        if not out.exists():
            # Build under a private name, then rename: concurrent builders
            # (test workers) never load a half-written library.
            tmp = BUILD_DIR / f"{name}-{digest}.{os.getpid()}.tmp.so"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True,
                text=True,
            )
            build_s = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                raise CompileError(
                    f"nvcc failed building {src.name} (exit {proc.returncode}):\n{log}",
                    site="kernel_build",
                    cause=subprocess.CalledProcessError(proc.returncode, proc.args, log),
                )
            log_path.write_text(log)
            os.replace(tmp, out)
        log = log_path.read_text() if log_path.exists() else ""
        built = BuiltLibrary(lib=ctypes.CDLL(str(out)), path=out, build_s=build_s, log=log)
        _loaded[name] = built
        return built
