"""Affected-edge frontier: which trussness values can an update change?

The fine-grained formulation makes each support contribution a per-triangle
quantity, and trussness has a per-triangle fixed-point characterization:

    t(f) = max k such that #{triangles {f,e,g} : min(t(e), t(g)) >= k} >= k-2

so ``t(f)`` depends only on the multiset of ``min(t(e), t(g))`` over f's
triangles.  An update can change ``t(f)`` only by changing that multiset
*at a level that matters for f* — which yields the classic conservative
propagation bound used by incremental truss maintenance (Huang et al.,
"Querying k-truss communities in large and dynamic graphs"):

* drift bounds: one edge insertion raises any trussness by at most 1 and
  one deletion lowers it by at most 1, so after a batch with ``nI``
  inserts / ``nD`` deletes every surviving edge satisfies
  ``lo(e) = max(2, t_old(e) - nD) <= t_new(e) <= t_old(e) + nI = hi(e)``
  (inserted edges: ``lo = 2``, ``hi = 2 + #triangles``);
* seed rule: f is affected directly if it gains or loses a triangle whose
  other two edges satisfy ``min(hi(e), hi(g)) >= lo(f)`` — a triangle
  whose min-trussness ceiling is below f's trussness floor cannot move
  f's count at any level f could occupy;
* propagation rule: an affected edge e spreads to a triangle partner f
  (through any surviving triangle {f, e, g}) under the same
  ``min(hi(e), hi(g)) >= lo(f)`` level test, iterated to closure.

Every edge outside the closure provably keeps its trussness, so the
streaming session may freeze it (the peel's frozen lanes) and re-peel only
the frontier.

Triangle enumeration, the union graph and the closure are array work over
every edge and every triangle of the graph, so they run as torch ops on
an explicit ``device`` (the owning session's; ``None`` means CUDA and
raises without it).  :func:`union_graph` builds the union's CSR there and
never reads it back (a ``graphs.csr.LiftedCSR``), and the
:class:`FrontierResult` holds its arrays there, giving the reference's
numpy fields on first use.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.csr import CSRGraph, LiftedCSR, edge_rows, lift_csr
from ..obs import current_registry, get_registry
from .delta import GraphDelta, keys_csr, merge_keys

__all__ = [
    "ENUM_COUNTS",
    "FrontierResult",
    "FrontierTensors",
    "edge_triangles",
    "compute_frontier",
    "union_graph",
]


class _EnumCounts(Mapping):
    """Process-global view of triangle enumerations, by kind.

    The store is the ``stream_enumerations{kind=full|incident}`` counter
    of the owning session's :class:`repro_torch.obs.MetricsRegistry`;
    this mapping reads the process-global registry, which aggregates
    every session.  "full" counts whole-graph enumerations
    (:func:`edge_triangles`), "incident" the insert-wedge enumerations of
    the triangle cache (:mod:`repro_torch.stream.tricache`); a cached
    session does one "full".
    """

    _KINDS = ("full", "incident")

    def __getitem__(self, kind: str) -> int:
        if kind not in self._KINDS:
            raise KeyError(kind)
        return int(get_registry().value("stream_enumerations", kind=kind))

    def __setitem__(self, kind: str, value: int) -> None:
        # Read-modify-write (`ENUM_COUNTS["full"] += 1`): adjust the
        # global counter by the implied delta.
        get_registry().inc(
            "stream_enumerations", float(value) - self[kind], kind=kind
        )

    def __iter__(self):
        return iter(self._KINDS)

    def __len__(self) -> int:
        return len(self._KINDS)

    def __repr__(self) -> str:
        return repr(dict(self))


ENUM_COUNTS = _EnumCounts()


class FrontierTensors(NamedTuple):
    """A frontier's per-new-edge arrays on its device."""

    frontier: torch.Tensor  # (new_nnz,) bool
    lo: torch.Tensor  # (new_nnz,) int32
    hi: torch.Tensor  # (new_nnz,) int32


@dataclasses.dataclass(frozen=True, eq=False)
class FrontierResult:
    """The affected-edge closure of one update batch.

    ``frontier`` is a mask over the **new** graph's edge ids; everything
    outside it keeps its old trussness.  ``lo``/``hi`` are the per-new-edge
    trussness drift bounds the closure used; ``rounds`` is how many
    propagation sweeps reached the fixed point; ``num_triangles`` counts
    the union graph's triangles (the closure's work set); ``size`` is the
    frontier's edge count.  The three arrays live in ``tensors`` on the
    closure's device; ``frontier``, ``lo`` and ``hi`` are their numpy
    copies, each read back once when first asked for.
    """

    rounds: int
    num_triangles: int
    size: int
    tensors: FrontierTensors

    @functools.cached_property
    def frontier(self) -> np.ndarray:  # (new_nnz,) bool
        return self.tensors.frontier.cpu().numpy()

    @functools.cached_property
    def lo(self) -> np.ndarray:  # (new_nnz,) int32
        return self.tensors.lo.cpu().numpy()

    @functools.cached_property
    def hi(self) -> np.ndarray:  # (new_nnz,) int32
        return self.tensors.hi.cpu().numpy()

    @property
    def frac(self) -> float:
        n = int(self.tensors.frontier.shape[0])
        return self.size / n if n else 0.0


def _ragged(counts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(owner, offset)`` for runs of ``counts`` laid end to end: entry j of
    run i is ``(i, j)``, runs in order (one host sync for the total)."""
    owner = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts
    )
    starts = torch.cumsum(counts, 0) - counts
    offset = torch.arange(owner.shape[0], device=counts.device) - starts[owner]
    return owner, offset


def edge_triangles(
    g: CSRGraph | LiftedCSR, *, chunk: int = 8192, device: str | torch.device | None = None
) -> torch.Tensor:
    """All triangles of an upper-triangular CSR (on the host or, as a
    ``LiftedCSR``, on the device) as a (T, 3) int64 tensor of edge ids on
    ``device``.

    Triangle (i < j < k) is reported as the edge ids of
    ``[(i,j), (i,k), (j,k)]``.  Same dataflow as the fine-grained support
    task: edge (i,j)'s row-i suffix supplies the k candidates, and a
    searchsorted over the global sorted edge keys resolves (j,k).

    Only in-row candidates are generated (each edge's row suffix, laid out
    ragged), ``chunk`` edges at a time.  The triangles come out ordered by
    (edge, offset in the row suffix), lexicographically: the order of the
    reference's ``np.nonzero`` over its padded ``(chunk, max_degree - 1)``
    windows, whose hits are exactly these in-row candidates, whatever the
    chunking.
    """
    current_registry().inc("stream_enumerations", kind="full")
    dev = resolve_device(device)
    empty = torch.zeros((0, 3), dtype=torch.int64, device=dev)
    nnz = g.nnz
    if nnz == 0:
        return empty
    rowptr, cols = lift_csr(g, dev)
    rows = edge_rows(rowptr, nnz)
    keys = rows * (g.n + 1) + cols
    row_end = rowptr[rows]
    # Row-i suffix after the position of (i, j): candidate edges (i, k).
    # Row v (1-based) spans [rowptr[v-1], rowptr[v]), so rowptr[i] is
    # exactly row i's end.
    after = row_end - torch.arange(nnz, device=dev) - 1
    stride = g.n + 1
    out: list[torch.Tensor] = []
    for start in range(0, nnz, chunk):
        owner, off = _ragged(after[start : start + chunk])
        if owner.numel() == 0:
            continue
        t = owner + start
        q = t + off + 1
        # Does (j, k) exist?  One searchsorted on the sorted keys.
        jk = cols[t] * stride + cols[q]
        pos = torch.searchsorted(keys, jk).clamp_(max=nnz - 1)
        hit = keys[pos] == jk
        out.append(torch.stack([t[hit], q[hit], pos[hit]], dim=1))
    return torch.cat(out) if out else empty


def union_graph(delta: GraphDelta) -> tuple[LiftedCSR, torch.Tensor]:
    """G_old ∪ inserts on the delta's device: its CSR (never read back) and
    its sorted edge keys.

    The union holds every triangle of either snapshot: gained triangles
    (contain an insert, no delete), lost triangles (a delete, no insert)
    and persistent ones are all subsets of it.  Its keys are the old keys
    merged with the inserts (``delta.merge_keys``, nothing deleted).
    """
    t = delta.tensors
    n = delta.old_graph.n
    size = t.old_keys.shape[0] + t.inserts.shape[0]
    ukeys, _, _ = merge_keys(t.old_keys, torch.zeros_like(t.deleted_old), t.inserts, size)
    rowptr, colidx = keys_csr(ukeys, n)
    name = delta.old_graph.name + "+union"
    return LiftedCSR(n, rowptr, colidx.to(torch.int32), name=name), ukeys


def _per_member(x: torch.Tensor, op) -> torch.Tensor:
    """``op`` over the OTHER two members of each (T, 3) row, per member."""
    return torch.stack(
        [op(x[:, 1], x[:, 2]), op(x[:, 0], x[:, 2]), op(x[:, 0], x[:, 1])], dim=1
    )


def _marked(tri: torch.Tensor, hit: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) bool: the edges of ``tri`` (T, 3) at the ``hit`` members (a
    scatter of ``True`` into a spare last lane for the misses, no
    readback)."""
    out = torch.zeros(size + 1, dtype=torch.bool, device=tri.device)
    out[torch.where(hit, tri, size).reshape(-1)] = True
    return out[:size]


def compute_frontier(
    trussness_old,
    delta: GraphDelta,
    *,
    chunk: int = 8192,
    tri_keys=None,
    union: tuple[CSRGraph | LiftedCSR, torch.Tensor] | None = None,
    device: str | torch.device | None = None,
) -> FrontierResult:
    """Conservative affected-edge closure of ``delta`` (see module doc).

    Args:
      trussness_old: (old_nnz,) trussness of every old edge (>= 2), e.g.
        from ``KTrussEngine.decompose()`` or the previous session state
        (numpy or tensor).
      delta: the applied batch (:func:`repro_torch.stream.delta.apply_batch`).
      tri_keys: optional precomputed union-graph triangle list as (T, 3)
        edge-key triples (numpy or tensor;
        ``repro_torch.stream.tricache.TriangleCache``); when given, the
        per-update full triangle enumeration is skipped.
      union: optional prebuilt ``union_graph(delta)`` result, so callers
        that already needed it (the triangle cache) don't rebuild it.
      device: where the classification, bounds and closure run.

    Returns a :class:`FrontierResult` over the **new** graph's edges.
    Inserted edges are always in the frontier; an empty batch (or one
    touching no triangles at a relevant level) yields an empty frontier.
    The closure reads one flag back per propagation round (its exit), and
    the frontier's size once.
    """
    dev = resolve_device(device)
    t = delta.tensors
    t_old = torch.as_tensor(trussness_old).to(dev, torch.int64)
    if t_old.shape[0] != delta.old_graph.nnz:
        raise ValueError(
            f"trussness has {t_old.shape[0]} entries, graph has {delta.old_graph.nnz}"
        )
    union, ukeys = union if union is not None else union_graph(delta)
    ukeys = torch.as_tensor(ukeys).to(dev, torch.int64)
    nu = ukeys.shape[0]
    nI, nD = delta.num_inserts, delta.num_deletes

    # Union-edge classification + old-trussness lift: the union is the old
    # edges and the inserts, so each old edge's lane is a searchsorted.
    old_u = torch.searchsorted(ukeys, t.old_keys.to(dev))
    is_ins = torch.zeros(nu, dtype=torch.bool, device=dev)
    is_ins[torch.searchsorted(ukeys, t.inserts.to(dev))] = True
    is_del = torch.zeros(nu, dtype=torch.bool, device=dev)
    is_del[old_u] = t.deleted_old.to(dev)
    t_old_u = torch.zeros(nu, dtype=torch.int64, device=dev)
    t_old_u[old_u] = t_old

    if tri_keys is None:
        tri = edge_triangles(union, chunk=chunk, device=dev)
    else:
        # Union triangles by construction, so every key resolves exactly.
        tk = torch.as_tensor(tri_keys).to(dev, torch.int64).reshape(-1, 3)
        tri = torch.searchsorted(ukeys, tk)
    num_tri = int(tri.shape[0])

    # Per-union-edge drift bounds (valid for BOTH snapshots' trussness).
    lo = torch.where(is_ins, 2, (t_old_u - nD).clamp_(min=2))
    hi = t_old_u + nI
    frontier_u = is_ins.clone()
    rounds = 0
    if num_tri:
        tri_has_del = is_del[tri].any(dim=1)
        tri_has_ins = is_ins[tri].any(dim=1)
        surv = ~tri_has_del
        # Inserted edges: trussness <= 2 + (# surviving triangles through them).
        surv_cnt = torch.zeros(nu, dtype=torch.int64, device=dev).index_add_(
            0, tri.reshape(-1), surv[:, None].expand(-1, 3).reshape(-1).long()
        )
        hi = torch.where(is_ins, 2 + surv_cnt, hi)

        # min over the OTHER two edges' ceilings, per triangle member.
        relevant = _per_member(hi[tri], torch.minimum) >= lo[tri]

        # Seeds: members of gained/lost triangles that pass the level test.
        changed_tri = tri_has_ins ^ tri_has_del  # in exactly one snapshot
        frontier_u |= _marked(tri, relevant & changed_tri[:, None] & ~is_del[tri], nu)

        # Propagation closure over the NEW graph's triangles only (lost
        # triangles were fully accounted as seeds; deleted edges never
        # appear in a surviving triangle, so they cannot spread).
        rel_s = relevant & surv[:, None]
        while True:
            rounds += 1
            in_f = frontier_u[tri]  # (T, 3)
            add = _per_member(in_f, torch.logical_or) & rel_s & ~in_f
            if not bool(add.any()):
                break
            frontier_u |= _marked(tri, add, nu)
    else:
        hi = torch.where(is_ins, 2, hi)

    # Project union-edge quantities onto the new graph's edge ids.
    new_u = torch.searchsorted(ukeys, t.new_keys.to(dev))
    frontier = frontier_u[new_u]
    return FrontierResult(
        rounds=rounds,
        num_triangles=num_tri,
        size=int(frontier.sum()),
        tensors=FrontierTensors(
            frontier=frontier,
            lo=lo[new_u].to(torch.int32),
            hi=hi[new_u].to(torch.int32),
        ),
    )
