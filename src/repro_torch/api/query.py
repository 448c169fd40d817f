"""`TrussQuery`: the one declarative description of any K-truss workload.

A query names *what* to compute — ``ktruss(k)`` membership, ``kmax``, a
full ``decompose``, or a frontier-bounded ``stream_update`` — plus
optional placement, deadline, backend, and stats knobs.  It never says
*how*: lowering onto a formulation/kernel/layout backend is the
:class:`repro_torch.api.Planner`'s job, so every entry point (``solve()``,
``Session``) shares one execution path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..graphs.csr import CSRGraph
from .registry import BackendKey

__all__ = ["WORKLOADS", "PLACEMENTS", "TrussQuery"]

WORKLOADS = ("ktruss", "kmax", "decompose", "stream_update")

# auto: let the session place (sharded iff it has a mesh); replicated /
# sharded force the choice and fail loudly when the session cannot honor it.
PLACEMENTS = ("auto", "replicated", "sharded")


def _lanes(a, dtype):
    """A per-edge array as ``dtype``: a tensor stays one (on its device),
    anything else becomes numpy."""
    if torch.is_tensor(a):
        return a.to(torch.bool if dtype is bool else torch.int32)
    return np.asarray(a, dtype)


@dataclasses.dataclass(frozen=True)
class TrussQuery:
    """One declarative K-truss request over one graph.

    Fields:
      graph: the upper-triangular CSR instance to query.
      workload: one of :data:`WORKLOADS`.
      k: target k for ``ktruss``; starting k for every other workload.
      frontier / frozen_truss: ``stream_update`` only — which edges are
        free to re-peel and the known trussness the complement is frozen
        at (see ``repro_torch.exec.build_peel``'s frozen lanes): numpy
        arrays, or tensors on the planner's device (a stream session's,
        which builds them there); kept as bool / int32.
      backend: force a registry backend (``BackendKey`` or
        ``"formulation/kernel/layout"`` string); ``None`` defers to the
        planner's auto rule (imbalance-statistic keyed).
      placement: one of :data:`PLACEMENTS`.
      deadline_s: soft scheduling deadline (seconds from submit).  The
        session's batch former serves the earliest-deadline group first,
        and ``TrussFuture.result()`` uses it as its default timeout.
      collect_stats: populate per-request :class:`repro_torch.api.RequestStats`.
    """

    graph: CSRGraph
    workload: str = "ktruss"
    k: int = 3
    frontier: Union[np.ndarray, torch.Tensor, None] = None
    frozen_truss: Union[np.ndarray, torch.Tensor, None] = None
    backend: Union[BackendKey, str, None] = None
    placement: str = "auto"
    deadline_s: Optional[float] = None
    collect_stats: bool = True

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"unknown workload {self.workload!r}; expected one of {WORKLOADS}"
            )
        if self.placement not in PLACEMENTS:
            raise ValueError(
                f"unknown placement {self.placement!r}; expected one of {PLACEMENTS}"
            )
        if self.k < 3:
            raise ValueError(f"k must be >= 3, got {self.k}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got {self.deadline_s}")
        if self.workload == "stream_update":
            if self.frontier is None or self.frozen_truss is None:
                raise ValueError("stream_update requires frontier= and frozen_truss=")
            frontier = _lanes(self.frontier, bool)
            frozen = _lanes(self.frozen_truss, np.int32)
            nnz = self.graph.nnz
            if tuple(frontier.shape) != (nnz,) or tuple(frozen.shape) != (nnz,):
                raise ValueError(
                    f"frontier/frozen_truss must cover all {nnz} edges, got "
                    f"{tuple(frontier.shape)} / {tuple(frozen.shape)}"
                )
            object.__setattr__(self, "frontier", frontier)
            object.__setattr__(self, "frozen_truss", frozen)
        elif self.frontier is not None or self.frozen_truss is not None:
            raise ValueError(
                f"frontier/frozen_truss are stream_update-only fields "
                f"(workload is {self.workload!r})"
            )

    # ------------------------------------------------------------------ #
    # Constructors — one per workload, so call sites read declaratively.
    # ------------------------------------------------------------------ #
    @classmethod
    def ktruss(cls, graph: CSRGraph, k: int, **opts) -> "TrussQuery":
        """Membership mask + supports of the k-truss."""
        return cls(graph=graph, workload="ktruss", k=int(k), **opts)

    @classmethod
    def kmax(cls, graph: CSRGraph, k_start: int = 3, **opts) -> "TrussQuery":
        """Largest k with a non-empty truss (0 if even k_start's is empty)."""
        return cls(graph=graph, workload="kmax", k=int(k_start), **opts)

    @classmethod
    def decompose(cls, graph: CSRGraph, k_start: int = 3, **opts) -> "TrussQuery":
        """Full truss decomposition: trussness of every edge."""
        return cls(graph=graph, workload="decompose", k=int(k_start), **opts)

    @classmethod
    def stream_update(
        cls,
        graph: CSRGraph,
        *,
        frontier: np.ndarray | torch.Tensor,
        frozen_truss: np.ndarray | torch.Tensor,
        **opts,
    ) -> "TrussQuery":
        """Frontier-bounded re-peel: the streaming maintenance kernel."""
        return cls(
            graph=graph,
            workload="stream_update",
            frontier=frontier,
            frozen_truss=frozen_truss,
            **opts,
        )
