"""Hand-written Hopper kernels, their wrappers and their plain oracles.

``support_fine`` — per-edge support (Alg. 3), one launch per peel trip.
``peel_fused``   — one whole truss level (support + prune + bookkeeping)
                   per launch.
``autotune``     — per-bucket config sweep/store for the fused kernel.

Kernels are built from ``csrc/`` by ``nvcc`` on first launch (never at
import), so every module here imports on a machine without CUDA.
"""

from . import autotune
from .autotune import FusedConfig
from .ops import support_fine
from .peel_fused import make_fused_level
from .ref import support_tiles_ref
from .support_fine import support_fine_cuda

__all__ = [
    "autotune",
    "FusedConfig",
    "make_fused_level",
    "support_fine",
    "support_fine_cuda",
    "support_tiles_ref",
]
