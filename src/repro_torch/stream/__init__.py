"""Streaming K-truss: incremental truss maintenance under live edge updates.

Layers (bottom-up):

* :mod:`.delta`    — CSR delta application: an :class:`EdgeBatch` of
                     inserts/deletes becomes the mutated graph plus edge-id
                     correspondences (torch ops on the session's device,
                     on sorted edge keys).
* :mod:`.frontier` — the affected-edge closure: the classic trussness
                     drift bounds (±1 per unit update) plus per-triangle
                     level tests bound exactly which edges an update can
                     re-rank; everything else provably keeps its trussness.
                     The union graph, triangle enumeration and the
                     closure are torch ops on the session's device.
* :mod:`.tricache` — incremental triangle state: the union graph's
                     triangle list cached as edge-key triples on the
                     device, maintained per update by enumerating only the
                     wedges through inserted edges (one full enumeration
                     per session).
* :mod:`.session`  — :class:`StreamingTrussSession`: maintains the graph +
                     decomposition, freezes non-frontier edges at their
                     known trussness, and lowers each update onto ONE
                     :class:`repro_torch.exec.PeelExecutor` dispatch as a
                     ``stream_update`` query on the owning
                     :class:`repro_torch.api.Session` (so many sessions'
                     updates coalesce like ordinary queries).

Incremental results are bit-identical to from-scratch ``decompose()`` on
the mutated graph, and to the JAX package's stream on the same updates
(``tests/test_torch_stream.py``).
"""

from .delta import EdgeBatch, GraphDelta, apply_batch, edge_keys
from .frontier import ENUM_COUNTS, FrontierResult, compute_frontier, edge_triangles
from .session import PendingUpdate, StreamingTrussSession, StreamUpdateResult
from .tricache import TriangleCache, triangles_incident

__all__ = [
    "EdgeBatch",
    "GraphDelta",
    "apply_batch",
    "edge_keys",
    "ENUM_COUNTS",
    "FrontierResult",
    "compute_frontier",
    "edge_triangles",
    "PendingUpdate",
    "StreamingTrussSession",
    "StreamUpdateResult",
    "TriangleCache",
    "triangles_incident",
]
