"""Named input-shape registry (generic shape-struct builders).

The counterpart of ``repro.configs.shapes``: :class:`ShapeSpec` names a
(sequence, batch, kind) cell and :func:`materialize` turns shape structs
into concrete smoke tensors.  Torch's shape struct is a tensor on the
``meta`` device (``torch.empty(shape, dtype=..., device="meta")``), which
carries a shape and a dtype and no data.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ShapeSpec", "SHAPES", "materialize"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def _tree_map(fn, tree):
    """``fn`` over every tensor leaf, in ``jax.tree.map``'s order: dict
    keys sorted, sequences in order; ``None`` is an empty subtree."""
    if torch.is_tensor(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    raise TypeError(f"materialize: unsupported node {type(tree).__name__}")


def materialize(specs, seed: int = 0, *, device=None):
    """Concrete tensors on ``device`` (``None`` = CUDA) for smoke tests:
    int32 specs of rank <= 2 uniform in [0, 97) (a scalar is 0), the rest
    gaussian (sd 0.5) in the spec's dtype.  The same seed gives the
    reference's values."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def mk(s):
        if s.dtype == torch.int32 and s.dim() <= 2:
            if s.dim() == 0:
                return torch.zeros((), dtype=torch.int32, device=dev)
            return torch.from_numpy(rng.integers(0, 97, size=tuple(s.shape))).to(dev, torch.int32)
        return torch.from_numpy(rng.normal(0, 0.5, size=tuple(s.shape))).to(dev, s.dtype)

    return _tree_map(mk, specs)
