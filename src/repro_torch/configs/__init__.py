"""Workload configs: the paper's K-truss problem instances + shape specs."""

from __future__ import annotations

from .ktruss import BENCH_GRAPHS, K_SETTINGS, LARGE_GRAPHS, KTrussBench
from .shapes import SHAPES, ShapeSpec

__all__ = [
    "BENCH_GRAPHS",
    "K_SETTINGS",
    "LARGE_GRAPHS",
    "KTrussBench",
    "SHAPES",
    "ShapeSpec",
]
