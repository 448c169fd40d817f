"""The paper's algorithms on tensors: support formulations and oracles."""

from .eager_coarse import support_coarse_eager
from .eager_fine import (
    FineProblem,
    prepare_fine,
    prepare_fine_arrays,
    problem_from_arrays,
    support_fine_eager,
    support_fine_owner,
    undirected_alive,
)
from .reference import ktruss_numpy, support_numpy, trussness_numpy
from .taskmap import batched_searchsorted, sorted_window_member
from .truss import KTrussResult, TrussDecomposition

__all__ = [
    "FineProblem",
    "prepare_fine",
    "prepare_fine_arrays",
    "problem_from_arrays",
    "support_fine_eager",
    "support_fine_owner",
    "undirected_alive",
    "support_coarse_eager",
    "support_numpy",
    "ktruss_numpy",
    "trussness_numpy",
    "batched_searchsorted",
    "sorted_window_member",
    "KTrussResult",
    "TrussDecomposition",
]
