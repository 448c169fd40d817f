"""Block-diagonal packing of many graphs into one static-shape problem.

The serving layer batches same-bucket requests by placing each member graph
on its own vertex *slot* of width ``slot_n``: member ``i``'s 1-based vertex
``v`` becomes ``i * slot_n + v`` in the packed id space.  The packed
adjacency is the disjoint union, so every K-truss quantity (support,
fixed-point alive mask, trussness) of the union restricted to a member's
edge range equals the quantity computed on that member alone — components
never interact.  One device dispatch therefore serves B requests.

Shapes are fully determined by ``(slots, slot_n, slot_nnz)``: rowptr is
``(slots * slot_n + 1,)`` and colidx ``(slots * slot_nnz,)`` regardless of
which graphs occupy the slots, which is exactly what the compile cache
needs to reuse one executor across batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..errors import InvalidGraphError
from .csr import CSRGraph

__all__ = [
    "PackedGraph",
    "PackedProblem",
    "pack_graphs",
    "pack_problems",
]


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """Disjoint union of member graphs on a fixed vertex grid."""

    graph: CSRGraph
    slot_n: int
    slots: int
    # Member i's real (unpadded) edges occupy colidx[edge_ranges[i][0]:edge_ranges[i][1]].
    edge_ranges: tuple[tuple[int, int], ...]

    @property
    def num_members(self) -> int:
        return len(self.edge_ranges)


@dataclasses.dataclass(frozen=True)
class PackedProblem:
    """Member graphs lowered to device-ready block-diagonal ``FineProblem`` arrays.

    Two layouts:

    * ``"contig"``  — member edges are concatenated from lane 0 with one
      pad tail (the classic CSR prefix-sum layout).
    * ``"aligned"`` — member i's edges occupy lane block
      ``[i * slot_nnz, (i+1) * slot_nnz)`` with per-slot interior padding,
      so slot boundaries are also lane-block boundaries — what the sharded
      executor needs to place whole slots per device
      (``repro.distributed.ktruss`` in the reference).
    """

    problem: "FineProblem"  # noqa: F821 - repro_torch.core.eager_fine.FineProblem
    slot_nnz: int
    # Member i's real (unpadded) edges occupy colidx[edge_ranges[i][0]:edge_ranges[i][1]].
    edge_ranges: tuple[tuple[int, int], ...]
    slot_n: int
    slots: int
    layout: str = "contig"
    packed: PackedGraph | None = None  # union CSRGraph; contig layout only


def pack_graphs(
    graphs: list[CSRGraph] | tuple[CSRGraph, ...],
    *,
    slot_n: int | None = None,
    slots: int | None = None,
    name: str = "packed",
) -> PackedGraph:
    """Block-diagonal union of ``graphs`` on a ``slots × slot_n`` vertex grid.

    Unused slots (when ``len(graphs) < slots``) and the tail vertices of
    each slot are isolated, so padding batches to a fixed slot count keeps
    shapes — and hence compiled executables — stable.
    """
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    b = int(slots if slots is not None else len(graphs))
    sn = int(slot_n if slot_n is not None else max(g.n for g in graphs))
    if len(graphs) > b:
        raise ValueError(f"{len(graphs)} graphs > {b} slots")
    if any(g.n > sn for g in graphs):
        raise ValueError(f"member graph exceeds slot_n={sn}")
    if b * sn + 1 >= np.iinfo(np.int32).max:
        raise ValueError("packed vertex space overflows int32")

    counts = np.zeros(b * sn + 1, dtype=np.int64)
    col_parts: list[np.ndarray] = []
    edge_ranges: list[tuple[int, int]] = []
    at = 0
    for i, g in enumerate(graphs):
        counts[i * sn + 1 : i * sn + g.n + 1] = np.diff(g.rowptr)
        col_parts.append(g.colidx.astype(np.int64) + i * sn)
        edge_ranges.append((at, at + g.nnz))
        at += g.nnz
    colidx = (
        np.concatenate(col_parts) if col_parts else np.zeros(0, np.int64)
    ).astype(np.int32)
    union = CSRGraph(b * sn, np.cumsum(counts), colidx, name=name)
    return PackedGraph(
        graph=union, slot_n=sn, slots=b, edge_ranges=tuple(edge_ranges)
    )


def _check_member_capacity(graphs, *, slot_n: int, slot_nnz: int) -> None:
    """Per-member slot-capacity guard, shared by both layouts.

    Names the overflowing member and both capacities: a member larger than
    its aligned slot would otherwise pad into the next slot's lane region
    (corrupting slot-id thresholds and shard boundaries) — and in the
    contiguous layout a single oversized member can hide inside an
    under-full batch total.  Fail loudly instead.
    """
    for i, g in enumerate(graphs):
        if g.n > slot_n:
            raise InvalidGraphError(
                f"member {i} ({g.name!r}) has n={g.n} vertices, exceeding "
                f"its slot's capacity slot_n={slot_n}; use a bucket with "
                f"n_pad >= {g.n}",
                slot=i,
                graph=g.name,
                kind="slot_overflow",
            )
        if g.nnz > slot_nnz:
            raise InvalidGraphError(
                f"member {i} ({g.name!r}) has nnz={g.nnz} edges, exceeding "
                f"its slot's capacity slot_nnz={slot_nnz}; use a bucket "
                f"with nnz_pad >= {g.nnz}",
                slot=i,
                graph=g.name,
                kind="slot_overflow",
            )


def pack_problems(
    graphs: list[CSRGraph] | tuple[CSRGraph, ...],
    *,
    slot_n: int,
    slot_nnz: int,
    slots: int | None = None,
    chunk: int = 256,
    layout: str = "contig",
    device: str | torch.device | None = None,
) -> PackedProblem:
    """Pack ``graphs`` into one block-diagonal ``FineProblem`` on ``device``
    (``None`` = CUDA).

    The packed arrays are padded to ``slots * slot_nnz`` directed nonzeros
    (and twice that undirected), so every batch drawn from the same
    ``(slot_n, slot_nnz, slots)`` bucket shares one executable.
    ``layout="aligned"`` additionally aligns each member's edge lanes to
    its own slot block (see :class:`PackedProblem`).
    """
    b = int(slots if slots is not None else len(graphs))
    if (b * slot_nnz) % chunk:
        raise ValueError(f"slots*slot_nnz={b * slot_nnz} not a multiple of chunk={chunk}")
    if layout == "aligned":
        return _pack_problems_aligned(
            graphs, slot_n=slot_n, slot_nnz=slot_nnz, slots=b, chunk=chunk,
            device=device,
        )
    if layout != "contig":
        raise ValueError(f"unknown layout {layout!r}")
    from ..core.eager_fine import prepare_fine  # lazy: graphs stays core-free

    _check_member_capacity(graphs, slot_n=slot_n, slot_nnz=slot_nnz)
    total = sum(g.nnz for g in graphs)
    if total > b * slot_nnz:
        raise ValueError(
            f"batch nnz={total} exceeds the packed capacity "
            f"{b} slots x slot_nnz={slot_nnz} = {b * slot_nnz}"
        )
    pg = pack_graphs(graphs, slot_n=slot_n, slots=b)
    problem = prepare_fine(
        pg.graph,
        chunk=chunk,
        nnz_pad=b * slot_nnz,
        unnz_pad=2 * b * slot_nnz,
        device=device,
    )
    return PackedProblem(
        problem=problem,
        slot_nnz=int(slot_nnz),
        edge_ranges=pg.edge_ranges,
        slot_n=int(slot_n),
        slots=b,
        layout="contig",
        packed=pg,
    )


def _pack_problems_aligned(
    graphs, *, slot_n: int, slot_nnz: int, slots: int, chunk: int, device
) -> PackedProblem:
    """Slot-aligned block-diagonal packing.

    Each member is prepared on its own ``(slot_n, slot_nnz)`` grid and the
    per-member arrays are concatenated with slot offsets, so member i's
    directed lanes are exactly ``[i * slot_nnz, (i+1) * slot_nnz)`` (and
    undirected lanes twice that).  Pad lanes sit *inside* each slot block;
    ``rowptr``/``urowptr`` store row starts (the only way the kernels read
    them — see ``FineProblem``), with row extents carried by the degree
    arrays.
    """
    from ..core.eager_fine import prepare_fine_arrays, problem_from_arrays

    if not graphs:
        raise ValueError("pack_problems needs at least one graph")
    if len(graphs) > slots:
        raise ValueError(f"{len(graphs)} graphs > {slots} slots")
    _check_member_capacity(graphs, slot_n=slot_n, slot_nnz=slot_nnz)
    if slot_nnz % chunk:
        raise ValueError(f"slot_nnz={slot_nnz} not a multiple of chunk={chunk}")
    if slots * slot_n + 1 >= np.iinfo(np.int32).max:
        raise ValueError("packed vertex space overflows int32")

    n_tot, nnzp, unnzp = slots * slot_n, slots * slot_nnz, 2 * slots * slot_nnz
    rowptr = np.zeros(n_tot + 1, np.int32)
    urowptr = np.zeros(n_tot + 1, np.int32)
    deg = np.zeros(n_tot + 1, np.int32)
    udeg = np.zeros(n_tot + 1, np.int32)
    colidx = np.zeros(nnzp, np.int32)
    edge_row = np.zeros(nnzp, np.int32)
    ucolidx = np.zeros(unnzp, np.int32)
    uedge_row = np.zeros(unnzp, np.int32)
    u2d = np.full(unnzp, nnzp, np.int32)
    rowptr[-1], urowptr[-1] = nnzp, unnzp
    edge_ranges: list[tuple[int, int]] = []

    for i in range(slots):
        vo, eo, uo = i * slot_n, i * slot_nnz, 2 * i * slot_nnz
        if i >= len(graphs):
            rowptr[vo : vo + slot_n] = eo
            urowptr[vo : vo + slot_n] = uo
            edge_ranges.append((eo, eo))
            continue
        g = graphs[i]
        p = prepare_fine_arrays(
            g, chunk=chunk, nnz_pad=slot_nnz, unnz_pad=2 * slot_nnz
        )
        lrp = p["rowptr"]  # (g.n + 1,) local row starts
        lurp = p["urowptr"]
        # rowptr[j] is the start of row j+1: rows 1..g.n take the member's
        # prefix sums; the slot's tail rows are empty at the member's end.
        rowptr[vo : vo + slot_n] = eo + lrp[np.minimum(np.arange(slot_n), g.n)]
        urowptr[vo : vo + slot_n] = uo + lurp[np.minimum(np.arange(slot_n), g.n)]
        deg[vo + 1 : vo + g.n + 1] = p["deg"][1:]
        udeg[vo + 1 : vo + g.n + 1] = p["udeg"][1:]
        lcol = p["colidx"]
        colidx[eo : eo + slot_nnz] = np.where(lcol != 0, lcol + vo, 0)
        lrow = p["edge_row"]
        edge_row[eo : eo + slot_nnz] = np.where(lrow != 0, lrow + vo, 0)
        lucol = p["ucolidx"]
        ucolidx[uo : uo + 2 * slot_nnz] = np.where(lucol != 0, lucol + vo, 0)
        lurow = p["uedge_row"]
        uedge_row[uo : uo + 2 * slot_nnz] = np.where(lurow != 0, lurow + vo, 0)
        lu2d = p["u2d"]
        u2d[uo : uo + 2 * slot_nnz] = np.where(lu2d < slot_nnz, lu2d + eo, nnzp)
        edge_ranges.append((eo, eo + g.nnz))

    problem = problem_from_arrays(
        {
            "rowptr": rowptr,
            "colidx": colidx,
            "edge_row": edge_row,
            "deg": deg,
            "urowptr": urowptr,
            "ucolidx": ucolidx,
            "u2d": u2d,
            "uedge_row": uedge_row,
            "udeg": udeg,
        },
        device,
    )
    return PackedProblem(
        problem=problem,
        slot_nnz=int(slot_nnz),
        edge_ranges=tuple(edge_ranges),
        slot_n=int(slot_n),
        slots=int(slots),
        layout="aligned",
    )
