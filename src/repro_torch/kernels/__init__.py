"""Hand-written Hopper kernels, their wrappers and their plain oracles.

``support_fine`` — per-edge support (Alg. 3), one launch per peel trip.
``support_dense`` — dense support ``(U@U)∘U`` (Alg. 1) on the tensor cores;
                   its entry point is ``ops.support_dense``.
``peel_fused``   — one whole truss level (support + prune + bookkeeping)
                   per launch.
``autotune``     — per-bucket config sweep/store for the fused kernel.

Kernels are built from ``csrc/`` by ``nvcc`` on first launch (never at
import), so every module here imports on a machine without CUDA.
"""

from . import autotune, ops, ref
from .autotune import FusedConfig
from .ops import support_fine, support_fine_stacked
from .peel_fused import make_fused_level
from .ref import support_dense_ref, support_tiles_ref
from .support_dense import support_dense_cuda, support_dense_torch
from .support_fine import support_fine_cuda

__all__ = [
    "autotune",
    "ops",
    "ref",
    "FusedConfig",
    "make_fused_level",
    "support_dense_cuda",
    "support_dense_torch",
    "support_dense_ref",
    "support_fine",
    "support_fine_cuda",
    "support_fine_stacked",
    "support_tiles_ref",
]
