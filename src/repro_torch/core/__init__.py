"""Core: the paper's contribution — Eager K-truss, coarse & fine grained."""

from .eager_coarse import support_coarse_eager
from .eager_fine import (
    FineProblem,
    bucket_tasks,
    prepare_fine,
    problem_from_arrays,
    support_fine_bucketed,
    support_fine_eager,
    support_fine_owner,
    support_fine_stacked,
    undirected_alive,
)
from .reference import (
    kmax_numpy,
    ktruss_dense,
    ktruss_numpy,
    support_dense,
    support_numpy,
    trussness_numpy,
)
from .taskmap import (
    batched_searchsorted,
    row_of_task,
    segment_offsets,
    sorted_window_member,
    window_gather,
)
from .truss import KTrussEngine, KTrussResult, TrussDecomposition, make_support_fn

__all__ = [
    "support_coarse_eager",
    "FineProblem",
    "bucket_tasks",
    "prepare_fine",
    "problem_from_arrays",
    "support_fine_bucketed",
    "support_fine_eager",
    "support_fine_owner",
    "support_fine_stacked",
    "undirected_alive",
    "kmax_numpy",
    "ktruss_dense",
    "ktruss_numpy",
    "support_dense",
    "support_numpy",
    "trussness_numpy",
    "batched_searchsorted",
    "row_of_task",
    "segment_offsets",
    "sorted_window_member",
    "window_gather",
    "KTrussEngine",
    "KTrussResult",
    "TrussDecomposition",
    "make_support_fn",
]
