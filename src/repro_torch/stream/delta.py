"""CSR delta application: mutate an upper-triangular CSR graph in place(-ish).

The streaming subsystem treats a graph update as an :class:`EdgeBatch` —
a set of edge insertions plus a set of deletions over a fixed vertex set —
and :func:`apply_batch` produces the mutated :class:`~repro_torch.graphs.csr.CSRGraph`
together with the edge-id correspondences the incremental machinery needs:

* ``old2new`` / ``new2old`` — where each surviving edge moved (CSR edge ids
  are positional, so inserting an edge shifts every id after it);
* ``inserted_new`` / ``deleted_old`` — which lanes are structurally new or
  gone, the seeds of the affected-edge frontier (``repro_torch.stream.frontier``).

Canonicalizing the batch is host numpy over its O(batch) pairs; everything
over the graph's edges is torch ops on the session's device, on sorted edge
keys (``u * (n + 1) + v``, the same composite key ``prepare_fine`` uses for
its u2d searchsorted): existence checks, the merge into the new key set,
the new CSR and the id maps cost O((nnz + batch) log) there.  The
:class:`GraphDelta` holds those tensors (:class:`DeltaTensors`) and gives
the reference's numpy fields, each read back once on first use; the new
graph's host arrays are read back once, and it carries its device arrays
(``graphs.csr.hold_lifted``) so that no later stage copies it again.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.csr import CSRGraph, edge_rows, hold_lifted, lift_csr

__all__ = ["EdgeBatch", "DeltaTensors", "GraphDelta", "edge_keys", "apply_batch"]


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


class DeltaTensors(NamedTuple):
    """A delta's arrays on its device (sorted keys are 1-based composite
    ``edge_keys``)."""

    old_keys: torch.Tensor  # (old_nnz,) int64, sorted
    new_keys: torch.Tensor  # (new_nnz,) int64, sorted
    inserts: torch.Tensor  # (num_inserts,) int64 — the effective inserted keys, sorted
    deletes: torch.Tensor  # (num_deletes,) int64 — the effective deleted keys, sorted
    old2new: torch.Tensor  # (old_nnz,) int64
    new2old: torch.Tensor  # (new_nnz,) int64
    inserted_new: torch.Tensor  # (new_nnz,) bool
    deleted_old: torch.Tensor  # (old_nnz,) bool


@dataclasses.dataclass(frozen=True, eq=False)
class GraphDelta:
    """The applied batch: mutated graph + edge-id correspondences.

    ``num_inserts``/``num_deletes`` are the *effective* counts after
    canonicalization (dedup, self-loop drop) — the counts the frontier's
    trussness drift bounds use.  ``tensors`` holds every array on the
    delta's device; ``old2new``, ``new2old``, ``inserted_new`` and
    ``deleted_old`` are the reference's numpy fields, each read back once
    when first asked for.
    """

    old_graph: CSRGraph
    new_graph: CSRGraph
    num_inserts: int
    num_deletes: int
    tensors: DeltaTensors

    @property
    def device(self) -> torch.device:
        return self.tensors.old_keys.device

    @functools.cached_property
    def old2new(self) -> np.ndarray:  # (old_nnz,) int64 — new edge id, -1 if deleted
        return self.tensors.old2new.cpu().numpy()

    @functools.cached_property
    def new2old(self) -> np.ndarray:  # (new_nnz,) int64 — old edge id, -1 if inserted
        return self.tensors.new2old.cpu().numpy()

    @functools.cached_property
    def inserted_new(self) -> np.ndarray:  # (new_nnz,) bool
        return self.tensors.inserted_new.cpu().numpy()

    @functools.cached_property
    def deleted_old(self) -> np.ndarray:  # (old_nnz,) bool
        return self.tensors.deleted_old.cpu().numpy()


def edge_keys(g: CSRGraph) -> np.ndarray:
    """(nnz,) strictly-increasing composite keys ``u * (n + 1) + v`` (1-based).

    CSR stores rows ascending and columns ascending within a row, so the
    key sequence is already sorted — every correspondence below is one
    ``searchsorted``.
    """
    return g.row_of_edge().astype(np.int64) * (g.n + 1) + g.colidx


def device_edge_keys(g, device: torch.device) -> torch.Tensor:
    """:func:`edge_keys` of ``g`` (a ``CSRGraph`` or ``LiftedCSR``) built on
    ``device`` from its lifted arrays (no copy when ``g`` carries them)."""
    rowptr, colidx = lift_csr(g, device)
    return edge_rows(rowptr, g.nnz) * (g.n + 1) + colidx


def keys_csr(keys: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The upper-triangular CSR ``(rowptr, colidx)``, both int64, of sorted
    unique keys: ``rowptr[v]`` counts the keys of rows at most ``v`` (a
    searchsorted: ``torch.bincount`` on CUDA reads its input's maximum
    back)."""
    stride = n + 1
    rows = keys // stride
    vertices = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    return torch.searchsorted(rows, vertices, right=True), keys - rows * stride


def merge_keys(
    old_keys: torch.Tensor, deleted_old: torch.Tensor, ins: torch.Tensor, size: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sorted merge of ``old_keys`` without its ``deleted_old`` lanes
    and ``ins`` (sorted, disjoint from ``old_keys``), ``size`` keys long:
    ``(keys, old_pos, ins_pos)``, where ``old_pos`` is each old key's place
    in ``keys`` (``size`` for a deleted one) and ``ins_pos`` each insert's.

    A kept old key moves down by the deletions before it and up by the
    inserts below it; an insert lands after the kept old keys below it and
    the inserts before it.  Two searchsorteds and a scatter, no readback.
    """
    dev = old_keys.device
    gone = torch.cat([deleted_old.new_zeros(1, dtype=torch.int64), deleted_old.long().cumsum(0)])
    old_pos = torch.arange(old_keys.shape[0], device=dev) - gone[:-1]
    old_pos += torch.searchsorted(ins, old_keys)
    old_pos = torch.where(deleted_old, size, old_pos)
    at = torch.searchsorted(old_keys, ins)
    ins_pos = torch.arange(ins.shape[0], device=dev) + at - gone[at]
    keys = old_keys.new_empty(size + 1)  # the last lane takes the deleted keys
    keys[old_pos] = old_keys
    keys[ins_pos] = ins
    return keys[:size], old_pos, ins_pos


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


def isin_sorted(x: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Which of ``x`` (any shape) lie in the sorted ``keys``: one
    searchsorted, no readback."""
    if keys.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    return keys[torch.searchsorted(keys, x).clamp_(max=keys.shape[0] - 1)] == x


def apply_batch(
    g: CSRGraph,
    batch: EdgeBatch,
    *,
    strict: bool = True,
    device: str | torch.device | None = None,
) -> GraphDelta:
    """Apply ``batch`` to ``g`` on ``device`` (``None`` = CUDA) and return
    the mutated graph + id maps.

    With ``strict=True`` (default) inserting an existing edge, deleting a
    missing edge, or inserting and deleting the same edge in one batch
    raises ``ValueError`` — a streaming session's source of truth should
    never disagree with its updates.  ``strict=False`` drops the
    conflicting entries instead (at-least-once delivery feeds).

    The existence checks read one flag per batch key back; the new graph's
    ``rowptr`` and ``colidx`` are read back once, as one tensor, and built
    correct, so they are not validated again on the host.
    """
    dev = resolve_device(device)
    n = g.n
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

    old_keys = device_edge_keys(g, dev)
    ins_t, del_t = torch.from_numpy(ins).to(dev), torch.from_numpy(dele).to(dev)
    if ins.size or dele.size:
        flags = torch.cat([isin_sorted(ins_t, old_keys), isin_sorted(del_t, old_keys)]).cpu().numpy()
        ins_exists, del_exists = flags[: ins.size], flags[ins.size :]
        if ins_exists.any():
            if strict:
                raise ValueError(f"{int(ins_exists.sum())} inserted edge(s) already exist")
            ins = ins[~ins_exists]
            ins_t = torch.from_numpy(ins).to(dev)
        if not del_exists.all():
            if strict:
                raise ValueError(
                    f"{int((~del_exists).sum())} deleted edge(s) do not exist"
                )
            dele = dele[del_exists]
            del_t = torch.from_numpy(dele).to(dev)

    old_nnz = g.nnz
    new_nnz = old_nnz - dele.size + ins.size
    deleted_old = torch.zeros(old_nnz, dtype=torch.bool, device=dev)
    deleted_old[torch.searchsorted(old_keys, del_t)] = True
    new_keys, old_pos, ins_pos = merge_keys(old_keys, deleted_old, ins_t, new_nnz)
    new2old = torch.empty(new_nnz + 1, dtype=torch.int64, device=dev)
    new2old[old_pos] = torch.arange(old_nnz, device=dev)
    new2old[ins_pos] = -1
    inserted_new = torch.zeros(new_nnz, dtype=torch.bool, device=dev)
    inserted_new[ins_pos] = True

    # The new CSR from the merged key set: one readback for the host graph.
    rowptr, colidx = keys_csr(new_keys, n)
    host = torch.cat([rowptr, colidx]).cpu().numpy()
    new_graph = CSRGraph(
        n, host[: n + 1].copy(), host[n + 1 :].astype(np.int32), name=g.name, validate=False
    )
    hold_lifted(new_graph, rowptr, colidx)
    return GraphDelta(
        old_graph=g,
        new_graph=new_graph,
        num_inserts=int(ins.size),
        num_deletes=int(dele.size),
        tensors=DeltaTensors(
            old_keys=old_keys,
            new_keys=new_keys,
            inserts=ins_t,
            deletes=del_t,
            old2new=torch.where(deleted_old, -1, old_pos),
            new2old=new2old[:new_nnz],
            inserted_new=inserted_new,
            deleted_old=deleted_old,
        ),
    )
