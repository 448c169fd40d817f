"""CSR graph containers for the Eager K-truss framework.

Host-side construction is numpy; device-side views are JAX pytrees with
fully static shapes.

Conventions (paper-faithful, see DESIGN.md §2/§4):

* Vertices are stored **1-based** inside the CSR: vertex id ``0`` is the
  universal sentinel used for padded lanes *and* pruned edges.  This is the
  zero-terminated-CSR trick of Blanco et al. adapted to static shapes: the
  paper appends a literal ``0`` after every row so pruned/terminated entries
  need no extra bookkeeping; on TPU the same sentinel doubles as the padding
  value, so padded lanes and pruned edges are one code path.
* ``colidx`` is sorted ascending within each row (required by the sorted
  intersection in the fine-grained algorithm).
* The canonical adjacency is **upper-triangular** (``src < dst`` after the
  1-based shift), exactly as Algorithm 2/3 of the paper require.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..errors import InvalidGraphError

__all__ = [
    "CSRGraph",
    "DeviceCSR",
    "build_upper_csr",
    "from_edges",
    "validate_csr",
]


def validate_csr(
    n: int, rowptr: np.ndarray, colidx: np.ndarray, *, name: str = "graph"
) -> None:
    """Check the CSR invariants every algorithm downstream assumes.

    Raises :class:`repro_torch.errors.InvalidGraphError` naming the *first*
    violating 1-based row (and the broken invariant's ``kind``) — today a
    malformed input would otherwise fail deep inside packing or the
    device peel with an opaque shape/index error that implicates the
    wrong layer.  Checked invariants:

    * ``rowptr`` has ``n + 1`` entries, starts at 0, is nondecreasing,
      and ends at ``nnz``;
    * every column id lies in ``[1, n]`` (1-based; 0 is the pad/prune
      sentinel and must never appear host-side);
    * no self-loops (``colidx[e] == row(e)``);
    * columns strictly ascend within each row (sorted, no duplicates —
      required by the sorted intersections of the fine-grained kernels).

    Symmetrized CSRs (``undirected_csr``) satisfy all of these too, so
    the check runs at every construction; upper-triangularity itself is
    a builder contract (``from_edges``), not re-checked here.
    """

    def bad(message, *, row=None, kind=None):
        raise InvalidGraphError(
            f"graph {name!r}: {message}", row=row, kind=kind, graph=name
        )

    rowptr = np.asarray(rowptr)
    colidx = np.asarray(colidx)
    nnz = int(colidx.shape[0])
    if rowptr.ndim != 1 or rowptr.shape[0] != n + 1:
        bad(
            f"rowptr must have n+1={n + 1} entries, got shape {rowptr.shape}",
            kind="rowptr_len",
        )
    if n >= 0 and rowptr.shape[0] and int(rowptr[0]) != 0:
        bad(f"rowptr[0] must be 0, got {int(rowptr[0])}", row=1, kind="rowptr_start")
    diffs = np.diff(rowptr)
    dec = np.nonzero(diffs < 0)[0]
    if dec.size:
        row = int(dec[0]) + 1
        bad(f"rowptr decreases at row {row}", row=row, kind="rowptr_unsorted")
    if int(rowptr[-1]) != nnz:
        bad(
            f"rowptr[-1]={int(rowptr[-1])} does not match nnz={nnz}",
            row=n,
            kind="rowptr_mismatch",
        )
    if not nnz:
        return

    def row_of(e: int) -> int:  # smallest v with rowptr[v] > e is e's 1-based row
        return int(np.searchsorted(rowptr, e, side="right"))

    out_of_range = np.nonzero((colidx < 1) | (colidx > n))[0]
    if out_of_range.size:
        e = int(out_of_range[0])
        bad(
            f"colidx[{e}]={int(colidx[e])} outside [1, {n}] at row {row_of(e)}",
            row=row_of(e),
            kind="col_range",
        )
    rows = np.searchsorted(rowptr, np.arange(nnz), side="right").astype(np.int64)
    loops = np.nonzero(colidx == rows)[0]
    if loops.size:
        e = int(loops[0])
        bad(
            f"self-loop ({row_of(e)}, {int(colidx[e])}) at row {row_of(e)}",
            row=row_of(e),
            kind="self_loop",
        )
    if nnz > 1:
        d = np.diff(colidx.astype(np.int64))
        same_row = rows[1:] == rows[:-1]
        unsorted = np.nonzero(same_row & (d < 0))[0]
        if unsorted.size:
            e = int(unsorted[0]) + 1
            bad(
                f"columns not ascending within row {row_of(e)} "
                f"(colidx[{e - 1}]={int(colidx[e - 1])} > colidx[{e}]={int(colidx[e])})",
                row=row_of(e),
                kind="unsorted_row",
            )
        dupes = np.nonzero(same_row & (d == 0))[0]
        if dupes.size:
            e = int(dupes[0]) + 1
            bad(
                f"duplicate column {int(colidx[e])} within row {row_of(e)}",
                row=row_of(e),
                kind="duplicate",
            )


class DeviceCSR(NamedTuple):
    """Static-shape device view of an upper-triangular CSR graph.

    All arrays are jnp/np int32.  Shapes are static so the same jitted
    K-truss executable is reused across graphs padded to the same budget.

    Attributes:
      rowptr:   (n + 1,) exclusive prefix sum of row lengths.
      colidx:   (nnz_pad,) 1-based neighbor ids, ascending per row; 0 = pad.
      edge_row: (nnz_pad,) 1-based row (source) id per nonzero; 0 = pad.
      edge_pos: (nnz_pad,) position of the nonzero within its row.
      deg:      (n + 1,) out-degree per 1-based vertex (deg[0] == 0).
    """

    rowptr: np.ndarray
    colidx: np.ndarray
    edge_row: np.ndarray
    edge_pos: np.ndarray
    deg: np.ndarray

    @property
    def n(self) -> int:
        return int(self.rowptr.shape[0] - 1)

    @property
    def nnz_pad(self) -> int:
        return int(self.colidx.shape[0])


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Host-side upper-triangular CSR graph (numpy, exact nnz).

    ``rowptr`` has length ``n + 1`` and is indexed by 1-based vertex id with
    ``rowptr[0] == rowptr[1] == 0`` only when vertex 1 has no out-neighbors;
    i.e. row ``v`` (1-based) spans ``colidx[rowptr[v - 1]:rowptr[v]]``.

    Note: to keep indexing uniform we store rowptr for the *1-based* id
    space: entry ``v`` of ``deg`` is the out-degree of vertex ``v`` and
    ``deg[0] == 0`` for the sentinel.
    """

    n: int
    rowptr: np.ndarray  # (n + 1,) int64 -> cast to int32 on device
    colidx: np.ndarray  # (nnz,) int32, 1-based, ascending per row
    name: str = "graph"
    # Construction-time invariant check (validate_csr): malformed input
    # fails HERE with a typed InvalidGraphError naming the violating row,
    # not deep inside packing with an opaque shape error.  ``False`` is
    # for tests/tools that need to materialize a known-bad graph.
    validate: dataclasses.InitVar[bool] = True

    def __post_init__(self, validate: bool):
        if validate:
            validate_csr(self.n, self.rowptr, self.colidx, name=self.name)

    # ------------------------------------------------------------------ #
    # Basic properties
    # ------------------------------------------------------------------ #
    @property
    def nnz(self) -> int:
        return int(self.colidx.shape[0])

    @property
    def num_edges(self) -> int:
        return self.nnz

    def degrees(self) -> np.ndarray:
        """Out-degree per 1-based vertex id; index 0 is the sentinel (=0)."""
        deg = np.zeros(self.n + 1, dtype=np.int64)
        deg[1:] = np.diff(self.rowptr)
        return deg

    def max_degree(self) -> int:
        return int(self.degrees().max(initial=0))

    # ------------------------------------------------------------------ #
    # Derived structures
    # ------------------------------------------------------------------ #
    def row_of_edge(self) -> np.ndarray:
        """(nnz,) 1-based source vertex of each nonzero.

        rowptr is over 1-based rows: row v spans [rowptr[v-1], rowptr[v]).
        Vectorized as: mark every row start, then a cumulative count gives
        the (1-based) row id at each nonzero.
        """
        marks = np.zeros(self.nnz + 1, dtype=np.int32)
        np.add.at(marks, self.rowptr[:-1], 1)
        return np.cumsum(marks[:-1]).astype(np.int32)  # vertex ids 1..n

    def pos_in_row(self) -> np.ndarray:
        """(nnz,) position of each nonzero within its row (0-based)."""
        rows = self.row_of_edge()
        return (np.arange(self.nnz, dtype=np.int64) - self.rowptr[rows - 1]).astype(
            np.int32
        )

    def undirected_csr(self) -> "CSRGraph":
        """Symmetrized (full) adjacency as CSR, same 1-based id space."""
        rows = self.row_of_edge()
        src = np.concatenate([rows, self.colidx])
        dst = np.concatenate([self.colidx, rows])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        rowptr = np.zeros(self.n + 1, dtype=np.int64)
        counts = np.bincount(src, minlength=self.n + 1)[1:]
        rowptr[1:] = np.cumsum(counts)
        return CSRGraph(self.n, rowptr, dst.astype(np.int32), name=self.name + "+sym")

    def padded_rows(self, width: int | None = None) -> np.ndarray:
        """(n + 1, W) matrix of neighbor ids per 1-based vertex, 0-padded.

        Row 0 (sentinel vertex) is all zeros so that gathers indexed by the
        sentinel are harmless — the paper's zero-termination generalized.
        """
        w = int(width if width is not None else self.max_degree())
        out = np.zeros((self.n + 1, w), dtype=np.int32)
        deg = self.degrees()
        for v in range(1, self.n + 1):
            d = int(deg[v])
            if d:
                out[v, :d] = self.colidx[self.rowptr[v - 1] : self.rowptr[v - 1] + d]
        return out

    # ------------------------------------------------------------------ #
    # Device view
    # ------------------------------------------------------------------ #
    def device_csr(self, nnz_pad: int | None = None) -> DeviceCSR:
        """Static-shape arrays for the JAX algorithms (0-sentinel padded)."""
        nnz_pad = int(nnz_pad if nnz_pad is not None else self.nnz)
        if nnz_pad < self.nnz:
            raise ValueError(f"nnz_pad={nnz_pad} < nnz={self.nnz}")
        pad = nnz_pad - self.nnz

        def _pad(a: np.ndarray) -> np.ndarray:
            return np.pad(a.astype(np.int32), (0, pad))

        return DeviceCSR(
            rowptr=self.rowptr.astype(np.int32),
            colidx=_pad(self.colidx),
            edge_row=_pad(self.row_of_edge()),
            edge_pos=_pad(self.pos_in_row()),
            deg=self.degrees().astype(np.int32),
        )

    def dense_upper(self) -> np.ndarray:
        """(n + 1, n + 1) dense 0/1 upper-triangular adjacency (row/col 0 empty)."""
        a = np.zeros((self.n + 1, self.n + 1), dtype=np.float32)
        a[self.row_of_edge(), self.colidx] = 1.0
        return a

    def edge_list(self) -> np.ndarray:
        """(nnz, 2) array of 1-based (src, dst) pairs, src < dst."""
        return np.stack([self.row_of_edge(), self.colidx], axis=1)


# ---------------------------------------------------------------------- #
# Builders
# ---------------------------------------------------------------------- #
def from_edges(n: int, edges: np.ndarray, name: str = "graph") -> CSRGraph:
    """Build an upper-triangular, deduplicated, sorted CSR from raw edges.

    Args:
      n: number of vertices (0-based input ids in ``[0, n)``).
      edges: (m, 2) array of undirected edges, any order/duplication; self
        loops are dropped.  Ids are shifted to 1-based internally.
    """
    edges = np.asarray(edges, dtype=np.int64)
    if edges.size == 0:
        return CSRGraph(n, np.zeros(n + 1, dtype=np.int64), np.zeros(0, np.int32), name)
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep] + 1, v[keep] + 1  # 1-based, u < v (upper triangular)
    key = u * (n + 1) + v
    key = np.unique(key)
    u = (key // (n + 1)).astype(np.int64)
    v = (key % (n + 1)).astype(np.int32)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    counts = np.bincount(u, minlength=n + 1)[1:]
    rowptr[1:] = np.cumsum(counts)
    return CSRGraph(n, rowptr, v, name=name)


def build_upper_csr(adj_dense: np.ndarray, name: str = "graph") -> CSRGraph:
    """Build from a dense 0/1 adjacency (0-based, symmetric or triangular)."""
    adj = np.asarray(adj_dense)
    n = adj.shape[0]
    iu, ju = np.nonzero(np.triu(adj + adj.T, k=1))
    return from_edges(n, np.stack([iu, ju], axis=1), name=name)
