"""Execution layer: the device-resident peel behind every multi-level workload."""

from .peel import PeelExecutor, PeelState, build_peel, make_problem_support

__all__ = ["PeelExecutor", "PeelState", "build_peel", "make_problem_support"]
