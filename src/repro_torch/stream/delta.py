"""CSR delta application: mutate an upper-triangular CSR graph in place(-ish).

The streaming subsystem treats a graph update as an :class:`EdgeBatch` —
a set of edge insertions plus a set of deletions over a fixed vertex set —
and :func:`apply_batch` produces the mutated :class:`~repro_torch.graphs.csr.CSRGraph`
together with the edge-id correspondences the incremental machinery needs:

* ``old2new`` / ``new2old`` — where each surviving edge moved (CSR edge ids
  are positional, so inserting an edge shifts every id after it);
* ``inserted_new`` / ``deleted_old`` — which lanes are structurally new or
  gone, the seeds of the affected-edge frontier (``repro_torch.stream.frontier``).

Everything is host-side numpy on sorted edge keys (``u * (n + 1) + v``, the
same composite key ``prepare_fine`` uses for its u2d searchsorted), so a
delta costs O((nnz + batch) log) — no device work until the frontier peel.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..graphs.csr import CSRGraph

__all__ = ["EdgeBatch", "GraphDelta", "edge_keys", "apply_batch"]


class EdgeBatch(NamedTuple):
    """One batched graph update: edges to insert and edges to delete.

    Endpoints are **0-based** vertex ids in ``[0, n)`` (the same convention
    as :func:`repro_torch.graphs.csr.from_edges`); orientation and duplicates are
    canonicalized by :func:`apply_batch`.  Empty arrays mean "no-op side".
    """

    inserts: np.ndarray  # (mi, 2) int
    deletes: np.ndarray  # (md, 2) int

    @staticmethod
    def of(inserts=(), deletes=()) -> "EdgeBatch":
        def arr(x):
            a = np.asarray(list(x) if not isinstance(x, np.ndarray) else x, np.int64)
            return a.reshape(-1, 2) if a.size else np.zeros((0, 2), np.int64)

        return EdgeBatch(arr(inserts), arr(deletes))


@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """The applied batch: mutated graph + edge-id correspondences.

    ``num_inserts``/``num_deletes`` are the *effective* counts after
    canonicalization (dedup, self-loop drop) — the counts the frontier's
    trussness drift bounds use.
    """

    old_graph: CSRGraph
    new_graph: CSRGraph
    old2new: np.ndarray  # (old_nnz,) int64 — new edge id, -1 if deleted
    new2old: np.ndarray  # (new_nnz,) int64 — old edge id, -1 if inserted
    inserted_new: np.ndarray  # (new_nnz,) bool
    deleted_old: np.ndarray  # (old_nnz,) bool
    num_inserts: int
    num_deletes: int


def edge_keys(g: CSRGraph) -> np.ndarray:
    """(nnz,) strictly-increasing composite keys ``u * (n + 1) + v`` (1-based).

    CSR stores rows ascending and columns ascending within a row, so the
    key sequence is already sorted — every correspondence below is one
    ``searchsorted``.
    """
    return g.row_of_edge().astype(np.int64) * (g.n + 1) + g.colidx


def _canonical_keys(n: int, pairs: np.ndarray, what: str) -> np.ndarray:
    """0-based endpoint pairs -> unique sorted 1-based upper-tri keys."""
    if pairs.size == 0:
        return np.zeros(0, np.int64)
    pairs = np.asarray(pairs, np.int64)
    if pairs.min() < 0 or pairs.max() >= n:
        raise ValueError(f"{what} endpoints must lie in [0, {n})")
    u = np.minimum(pairs[:, 0], pairs[:, 1])
    v = np.maximum(pairs[:, 0], pairs[:, 1])
    keep = u != v  # self loops are never edges; drop silently like from_edges
    u, v = u[keep] + 1, v[keep] + 1
    return np.unique(u * (n + 1) + v)


def apply_batch(g: CSRGraph, batch: EdgeBatch, *, strict: bool = True) -> GraphDelta:
    """Apply ``batch`` to ``g`` and return the mutated graph + id maps.

    With ``strict=True`` (default) inserting an existing edge, deleting a
    missing edge, or inserting and deleting the same edge in one batch
    raises ``ValueError`` — a streaming session's source of truth should
    never disagree with its updates.  ``strict=False`` drops the
    conflicting entries instead (at-least-once delivery feeds).
    """
    n = g.n
    old_keys = edge_keys(g)
    ins = _canonical_keys(n, batch.inserts, "insert")
    dele = _canonical_keys(n, batch.deletes, "delete")

    both = np.intersect1d(ins, dele, assume_unique=True)
    if both.size:
        if strict:
            raise ValueError(
                f"{both.size} edge(s) appear in both inserts and deletes"
            )
        ins = np.setdiff1d(ins, both, assume_unique=True)
        dele = np.setdiff1d(dele, both, assume_unique=True)

    ins_exists = np.isin(ins, old_keys, assume_unique=True)
    if ins_exists.any():
        if strict:
            raise ValueError(f"{int(ins_exists.sum())} inserted edge(s) already exist")
        ins = ins[~ins_exists]
    del_exists = np.isin(dele, old_keys, assume_unique=True)
    if not del_exists.all():
        if strict:
            raise ValueError(
                f"{int((~del_exists).sum())} deleted edge(s) do not exist"
            )
        dele = dele[del_exists]

    deleted_old = np.isin(old_keys, dele, assume_unique=True)
    new_keys = np.union1d(old_keys[~deleted_old], ins)

    # Rebuild the CSR from the merged key set.
    u = (new_keys // (n + 1)).astype(np.int64)
    v = (new_keys % (n + 1)).astype(np.int32)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    rowptr[1:] = np.cumsum(np.bincount(u, minlength=n + 1)[1:])
    new_graph = CSRGraph(n, rowptr, v, name=g.name)

    old2new = np.searchsorted(new_keys, old_keys)
    old2new[deleted_old] = -1
    new2old = np.searchsorted(old_keys, new_keys)
    inserted_new = np.isin(new_keys, ins, assume_unique=True)
    # Guard the searchsorted clip (an inserted key past every old key).
    new2old = np.minimum(new2old, g.nnz - 1) if g.nnz else np.zeros_like(new2old)
    new2old[inserted_new] = -1
    return GraphDelta(
        old_graph=g,
        new_graph=new_graph,
        old2new=old2new,
        new2old=new2old,
        inserted_new=inserted_new,
        deleted_old=deleted_old,
        num_inserts=int(ins.size),
        num_deletes=int(dele.size),
    )
