"""Workload configs: the paper's K-truss problem instances."""

from __future__ import annotations

from .ktruss import BENCH_GRAPHS, K_SETTINGS, LARGE_GRAPHS, KTrussBench

__all__ = ["BENCH_GRAPHS", "K_SETTINGS", "LARGE_GRAPHS", "KTrussBench"]
