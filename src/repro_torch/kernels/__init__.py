"""Hand-written Hopper kernels, their wrappers and their plain oracles.

Kernels are built from ``csrc/`` by ``nvcc`` on first launch (never at
import), so every module here imports on a machine without CUDA.
"""

from .ops import support_fine
from .ref import support_tiles_ref
from .support_fine import support_fine_cuda

__all__ = ["support_fine", "support_fine_cuda", "support_tiles_ref"]
