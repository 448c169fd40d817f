"""Graph substrate: CSR containers, generators, packing, imbalance statistics."""

from .csr import CSRGraph, DeviceCSR, build_upper_csr, from_edges, validate_csr
from .generators import barabasi, clustered, erdos, rmat, road, suite, SUITE_SPECS
from .pack import PackedGraph, PackedProblem, pack_graphs, pack_problems
from .stats import ImbalanceStats, coarse_task_work, fine_task_work, imbalance_stats

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "build_upper_csr",
    "from_edges",
    "validate_csr",
    "PackedGraph",
    "PackedProblem",
    "pack_graphs",
    "pack_problems",
    "barabasi",
    "clustered",
    "erdos",
    "rmat",
    "road",
    "suite",
    "SUITE_SPECS",
    "ImbalanceStats",
    "coarse_task_work",
    "fine_task_work",
    "imbalance_stats",
]
