"""repro_torch.api — the one front door to every K-truss workload.

Declare *what* you want as :class:`TrussQuery` values; ``solve()`` (one
shot) or :class:`Session` (long-lived serving, micro-batching, futures)
lowers them through the :class:`Planner` onto interchangeable backends —
``formulation={coarse,fine} × kernel={xla,pallas,fused} × layout={contig,
aligned}`` — chosen per shape bucket by an auto rule keyed on the paper's
load-imbalance statistics.  On a CUDA device the ``pallas`` kernel axis
runs the hand-written Hopper support kernel, ``fused`` the hand-written
one-launch-per-level kernel; ``xla`` runs torch ops::

    from repro_torch.api import TrussQuery, solve

    dec = solve(TrussQuery.decompose(g))             # on CUDA by default
    results = solve([TrussQuery.ktruss(g1, k=4),      # one dispatch
                     TrussQuery.kmax(g2)], device="cpu")   # per bucket
"""

from ..core.truss import KTrussResult, TrussDecomposition
from .cache import (
    Bucket,
    CompileCache,
    bucket_for,
    bucket_str,
    build_peel,
    enable_persistent_cache,
)
from .errors import (
    CheckpointError,
    CompileError,
    DeviceError,
    InvalidGraphError,
    QueryFailedError,
    TrussError,
    TrussTimeoutError,
)
from .planner import Plan, PlannedBatch, Planner, QueryState, RequestStats
from .query import PLACEMENTS, WORKLOADS, TrussQuery
from .registry import (
    FORMULATIONS,
    KERNELS,
    LAYOUTS,
    BackendKey,
    BackendSpec,
    available_backends,
    choose_backend,
    default_kernel,
    fallback_backends,
    get_backend,
    register_backend,
)
from .session import QueryQueue, Session, TrussFuture, solve

__all__ = [
    # query surface
    "TrussQuery",
    "WORKLOADS",
    "PLACEMENTS",
    "solve",
    "Session",
    "TrussFuture",
    # failure taxonomy (repro_torch.errors re-export)
    "TrussError",
    "InvalidGraphError",
    "CompileError",
    "DeviceError",
    "QueryFailedError",
    "TrussTimeoutError",
    "CheckpointError",
    # planner / lowering
    "Planner",
    "Plan",
    "PlannedBatch",
    "QueryState",
    "QueryQueue",
    "RequestStats",
    # backend registry
    "BackendKey",
    "BackendSpec",
    "FORMULATIONS",
    "KERNELS",
    "LAYOUTS",
    "register_backend",
    "get_backend",
    "available_backends",
    "choose_backend",
    "default_kernel",
    "fallback_backends",
    # shape buckets + executor cache
    "Bucket",
    "bucket_for",
    "bucket_str",
    "build_peel",
    "CompileCache",
    "enable_persistent_cache",
    # result types
    "KTrussResult",
    "TrussDecomposition",
]
