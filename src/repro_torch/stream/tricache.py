"""Incremental triangle cache: stop re-enumerating the graph per update.

``compute_frontier`` needs the *union* graph's (old ∪ inserts) triangle
list; without this cache every update would pay a full
O(nnz · max_degree) enumeration of a graph that barely changed.  The
union's triangles partition exactly:

* triangles whose three edges all exist in the old graph — the cached
  list, maintained across commits;
* triangles containing at least one **inserted** edge — enumerable from
  the inserts alone: triangle {u, v, w} through inserted edge (u, v)
  means w is a common neighbor of u and v, so probing one endpoint's
  neighbors against the other's (the wedge idiom of the fine-grained
  support task) finds them all in O(Σ min(deg(u), deg(v)) log nnz).

On commit the deleted edges' triangles are dropped (a triangle survives
iff none of its edges was deleted), leaving exactly the new graph's
triangle list for the next update.  Triangles are stored as a (T, 3)
int64 tensor of composite *edge-key* triples on the cache's device —
positional edge ids shift on every CSR rebuild, keys don't; a checkpoint
takes them to the host with ``.cpu()``.  The inserted and deleted keys
come from the delta's tensors, and the wedges are probed in the union's
symmetrized CSR built on the device (``graphs.csr.symmetrize_csr``), so
an update copies nothing of the graph to the device.

The ``stream_enumerations{kind=full|incident}`` metric (recorded into the
active session's :mod:`repro_torch.obs` registry; ``ENUM_COUNTS`` reads
the process-global aggregate) tracks full vs. incident enumerations; a
cached session does exactly one full enumeration however many updates it
applies.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..graphs.csr import CSRGraph, LiftedCSR, check_upper, edge_rows, lift_csr, symmetrize_csr
from ..obs import current_registry
from .delta import GraphDelta, device_edge_keys, isin_sorted
from .frontier import _ragged, edge_triangles, union_graph

__all__ = ["TriangleCache", "triangles_incident"]


def _triple_keys(n: int, tri_verts: torch.Tensor) -> torch.Tensor:
    """(T, 3) sorted 1-based vertex triples -> (T, 3) edge-key triples."""
    stride = n + 1
    a, b, c = tri_verts[:, 0], tri_verts[:, 1], tri_verts[:, 2]
    return torch.stack([a * stride + b, a * stride + c, b * stride + c], dim=1)


def triangles_incident(
    g: CSRGraph | LiftedCSR, keys, *, device: str | torch.device | None = None
) -> torch.Tensor:
    """Triangles of ``g`` containing >= 1 edge of ``keys``, as key triples.

    ``keys`` are 1-based upper-triangular composite keys (``edge_keys``
    convention), numpy or tensor.  Each key's triangles are the common
    neighbors of its endpoints in the symmetrized adjacency, built on
    ``device`` by :func:`~repro_torch.graphs.csr.symmetrize_csr` (the
    order of the reference's ``undirected_csr``): the shorter endpoint's
    neighbors are probed against the other's by a searchsorted over the
    symmetrized keys.  A triangle touched by several listed edges is
    deduplicated; rows come out sorted (``torch.unique(dim=0)``), as the
    reference's ``np.unique(axis=0)`` gives them.  A host ``CSRGraph`` is
    held to the upper-triangular contract first (``check_upper``).
    """
    current_registry().inc("stream_enumerations", kind="incident")
    dev = resolve_device(device)
    empty = torch.zeros((0, 3), dtype=torch.int64, device=dev)
    keys = torch.as_tensor(keys).to(dev, torch.int64).reshape(-1)
    if keys.numel() == 0 or g.nnz == 0:
        return empty
    rowptr, colidx = lift_csr(g, dev)
    if isinstance(g, CSRGraph):
        check_upper(g, rowptr, colidx)
    # From here on the symmetrized CSR: both directions of every edge.
    rowptr, col, urows = symmetrize_csr(rowptr, colidx, edge_rows(rowptr, g.nnz))
    stride = g.n + 1
    ukeys = urows * stride + col  # sorted: the symmetrization's (row, column) order
    u, v = keys // stride, keys % stride
    deg = rowptr[1:] - rowptr[:-1]  # deg[x - 1] for 1-based vertex x
    a = torch.where(deg[u - 1] <= deg[v - 1], u, v)  # walk the shorter row
    b = u + v - a
    owner, off = _ragged(deg[a - 1])
    w = col[rowptr[a - 1][owner] + off]
    probe = b[owner] * stride + w
    pos = torch.searchsorted(ukeys, probe).clamp_(max=ukeys.shape[0] - 1)
    hit = ukeys[pos] == probe  # w neighbors both endpoints (w = b never: no self loops)
    if not bool(hit.any()):
        return empty
    verts = torch.stack([u[owner][hit], v[owner][hit], w[hit]], dim=1).sort(dim=1).values
    return torch.unique(_triple_keys(g.n, verts), dim=0)


class TriangleCache:
    """The current graph's triangle list, maintained across updates, on
    ``device`` (``None`` = CUDA)."""

    def __init__(
        self,
        g: CSRGraph,
        *,
        tri_keys=None,
        device: str | torch.device | None = None,
    ):
        self.graph = g
        self.device = resolve_device(device)
        if tri_keys is not None:
            # Checkpoint restore (repro_torch.resilience.checkpoint): adopt
            # the serialized triangle list instead of re-enumerating — the
            # restored session keeps the "one full enumeration" contract.
            self.tri_keys = torch.as_tensor(tri_keys).to(self.device, torch.int64).reshape(-1, 3)
            return
        # The one full enumeration this cache ever does.
        tri = edge_triangles(g, device=self.device)
        self.tri_keys = device_edge_keys(g, self.device)[tri]

    @property
    def num_triangles(self) -> int:
        return int(self.tri_keys.shape[0])

    def union_triangles(self, delta: GraphDelta, union=None) -> torch.Tensor:
        """(T, 3) key triples of the union graph (old ∪ inserts).

        Cached old-graph triangles plus the wedge-enumerated triangles
        through the batch's inserted edges — the exact set
        ``edge_triangles(union)`` would produce, without touching the
        rest of the graph.  ``union`` is an optional prebuilt
        ``frontier.union_graph(delta)`` pair (the session builds it once
        and shares it with ``compute_frontier``).
        """
        if delta.old_graph is not self.graph:
            raise RuntimeError(
                "triangle cache is out of sync: delta.old_graph is not the "
                "cached graph (commit() every update in order)"
            )
        if not delta.num_inserts:
            return self.tri_keys
        g_union, _ukeys = union if union is not None else union_graph(delta)
        gained = triangles_incident(g_union, delta.tensors.inserts, device=self.device)
        if not gained.numel():
            return self.tri_keys
        return torch.cat([self.tri_keys, gained])

    def commit(self, delta: GraphDelta, union_tri_keys: torch.Tensor) -> None:
        """Advance to ``delta.new_graph``: drop deleted edges' triangles."""
        kept = union_tri_keys
        if union_tri_keys.numel() and delta.num_deletes:
            dele = delta.tensors.deletes.to(self.device)
            kept = union_tri_keys[~isin_sorted(union_tri_keys, dele).any(dim=1)]
        self.tri_keys = kept
        self.graph = delta.new_graph
