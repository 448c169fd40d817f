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

from ..device import resolve_device
from ..errors import InvalidGraphError
from .csr import CSRGraph, LiftedCSR, check_upper, lift_csr

__all__ = [
    "PackedGraph",
    "PackedProblem",
    "pack_graphs",
    "pack_problems",
    "stack_problems",
    "validate_fused_tiling",
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
    # The reference's host union (contig layout); the port builds the union
    # on the device (``LiftedCSR``) and keeps no host copy of it.
    packed: PackedGraph | None = None


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
    _check_grid(graphs, slot_n=sn, slots=b)

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


def _check_grid(graphs, *, slot_n: int, slots: int) -> None:
    """The members fit a ``slots × slot_n`` vertex grid that int32 can number."""
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    if len(graphs) > slots:
        raise ValueError(f"{len(graphs)} graphs > {slots} slots")
    if any(g.n > slot_n for g in graphs):
        raise ValueError(f"member graph exceeds slot_n={slot_n}")
    if slots * slot_n + 1 >= np.iinfo(np.int32).max:
        raise ValueError("packed vertex space overflows int32")


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
    union, edge_ranges = _lifted_union(graphs, slot_n=slot_n, slots=b, device=device)
    problem = prepare_fine(
        union,
        chunk=chunk,
        nnz_pad=b * slot_nnz,
        unnz_pad=2 * b * slot_nnz,
        device=device,
    )
    return PackedProblem(
        problem=problem,
        slot_nnz=int(slot_nnz),
        edge_ranges=edge_ranges,
        slot_n=int(slot_n),
        slots=b,
        layout="contig",
    )


def _lifted_union(graphs, *, slot_n: int, slots: int, device):
    """:func:`pack_graphs`'s disjoint union, built on ``device`` from each
    member's lift (:func:`~repro_torch.graphs.csr.lift_csr`: a member
    already there is not copied), as a :class:`LiftedCSR` with the
    members' edge ranges.  A union with a host member is held to the
    upper-triangular contract here (one readback); members that are
    ``LiftedCSR`` were held to it when they were lifted."""
    _check_grid(graphs, slot_n=slot_n, slots=slots)
    dev = resolve_device(device)
    counts = torch.zeros(slots * slot_n + 1, dtype=torch.int64, device=dev)
    cols, edge_ranges, at = [], [], 0
    for i, g in enumerate(graphs):
        rowptr, colidx = lift_csr(g, dev)
        counts[i * slot_n + 1 : i * slot_n + g.n + 1] = torch.diff(rowptr)
        cols.append(colidx.long() + i * slot_n)
        edge_ranges.append((at, at + g.nnz))
        at += g.nnz
    union = LiftedCSR(slots * slot_n, torch.cumsum(counts, 0), torch.cat(cols), "packed")
    if not all(isinstance(g, LiftedCSR) for g in graphs):
        check_upper(union, union.rowptr, union.colidx)
    return union, tuple(edge_ranges)


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
    arrays.  Every field is allocated and written on ``device``; each
    member is prepared there (:func:`~repro_torch.core.eager_fine.prepare_fine`),
    so its ``rowptr`` and ``colidx`` are the only host-to-device copies.
    """
    from ..core.eager_fine import FineProblem, prepare_fine

    if not graphs:
        raise ValueError("pack_problems needs at least one graph")
    if len(graphs) > slots:
        raise ValueError(f"{len(graphs)} graphs > {slots} slots")
    _check_member_capacity(graphs, slot_n=slot_n, slot_nnz=slot_nnz)
    if slot_nnz % chunk:
        raise ValueError(f"slot_nnz={slot_nnz} not a multiple of chunk={chunk}")
    if slots * slot_n + 1 >= np.iinfo(np.int32).max:
        raise ValueError("packed vertex space overflows int32")

    dev = resolve_device(device)
    n_tot, nnzp, unnzp = slots * slot_n, slots * slot_nnz, 2 * slots * slot_nnz

    def zeros(size: int) -> torch.Tensor:
        return torch.zeros(size, dtype=torch.int32, device=dev)

    rowptr, urowptr, deg, udeg = (zeros(n_tot + 1) for _ in range(4))
    colidx, edge_row = zeros(nnzp), zeros(nnzp)
    ucolidx, uedge_row = zeros(unnzp), zeros(unnzp)
    u2d = torch.full((unnzp,), nnzp, dtype=torch.int32, device=dev)
    rowptr[-1], urowptr[-1] = nnzp, unnzp
    slot_rows = torch.arange(slot_n, device=dev)
    edge_ranges: list[tuple[int, int]] = []

    for i in range(slots):
        vo, eo, uo = i * slot_n, i * slot_nnz, 2 * i * slot_nnz
        if i >= len(graphs):
            rowptr[vo : vo + slot_n] = eo
            urowptr[vo : vo + slot_n] = uo
            edge_ranges.append((eo, eo))
            continue
        g = graphs[i]
        p = prepare_fine(g, chunk=chunk, nnz_pad=slot_nnz, unnz_pad=2 * slot_nnz, device=dev)
        # rowptr[j] is the start of row j+1: rows 1..g.n take the member's
        # prefix sums; the slot's tail rows are empty at the member's end.
        local = slot_rows.clamp(max=g.n)
        rowptr[vo : vo + slot_n] = eo + p.rowptr[local]
        urowptr[vo : vo + slot_n] = uo + p.urowptr[local]
        deg[vo + 1 : vo + g.n + 1] = p.deg[1:]
        udeg[vo + 1 : vo + g.n + 1] = p.udeg[1:]
        colidx[eo : eo + slot_nnz] = torch.where(p.colidx != 0, p.colidx + vo, 0)
        edge_row[eo : eo + slot_nnz] = torch.where(p.edge_row != 0, p.edge_row + vo, 0)
        ucolidx[uo : uo + 2 * slot_nnz] = torch.where(p.ucolidx != 0, p.ucolidx + vo, 0)
        uedge_row[uo : uo + 2 * slot_nnz] = torch.where(p.uedge_row != 0, p.uedge_row + vo, 0)
        u2d[uo : uo + 2 * slot_nnz] = torch.where(p.u2d < slot_nnz, p.u2d + eo, nnzp)
        edge_ranges.append((eo, eo + g.nnz))

    problem = FineProblem(
        rowptr=rowptr,
        colidx=colidx,
        edge_row=edge_row,
        deg=deg,
        urowptr=urowptr,
        ucolidx=ucolidx,
        u2d=u2d,
        uedge_row=uedge_row,
        udeg=udeg,
    )
    return PackedProblem(
        problem=problem,
        slot_nnz=int(slot_nnz),
        edge_ranges=tuple(edge_ranges),
        slot_n=int(slot_n),
        slots=int(slots),
        layout="aligned",
    )


def stack_problems(problems):
    """Stack same-shape ``FineProblem``s along a new leading batch axis.

    Input to the ``support_fine_stacked`` batched entry points; all members
    must come from one shape bucket (identical field shapes).
    """
    if not problems:
        raise ValueError("stack_problems needs at least one problem")
    first = problems[0]
    for i, q in enumerate(problems[1:], start=1):
        for name, a, b in zip(first._fields, first, q):
            if a.shape != b.shape:
                raise ValueError(
                    f"problem {i} field {name!r} has shape {tuple(b.shape)}, "
                    f"problem 0 has {tuple(a.shape)}: stack one shape bucket"
                )
    return type(first)(*(torch.stack(xs) for xs in zip(*problems)))


def validate_fused_tiling(problem, *, slots: int, block: int) -> None:
    """Validate an aligned pack against the fused kernel's tiling.

    The fused level kernel (``repro_torch.kernels.peel_fused``) walks edge
    lanes in ``block``-sized tiles it can skip when dead, and reduces
    per-slot convergence over each slot's band of ``slot_nnz`` lanes.
    Both are only sound for the aligned layout's geometry: ``block`` must
    divide each slot's lane band, and every row's lanes must sit inside
    its slot's band ``[i * slot_nnz, (i+1) * slot_nnz)``.  A violation —
    a mis-sized block, or a pack whose row starts spill across a slot
    boundary — would silently mix members' edges into one tile/slot
    reduction; instead it raises the typed :class:`InvalidGraphError`
    naming the offending slot.  The band test runs on the pack's device,
    which reads back one int32: the first offending row, or -1.
    """
    nnzp = int(problem.colidx.shape[0])
    if slots < 1 or nnzp % slots:
        raise InvalidGraphError(
            f"packed nnz={nnzp} does not divide into {slots} aligned slots",
            kind="fused_tiling",
        )
    slot_nnz = nnzp // slots
    if block < 1 or slot_nnz % block:
        raise InvalidGraphError(
            f"fused kernel block={block} does not divide slot_nnz="
            f"{slot_nnz}: a {block}-lane tile would straddle slot 1's "
            f"band boundary at lane {slot_nnz}; repack or clamp the "
            "config (FusedConfig.clamp)",
            slot=1 if slots > 1 else 0,
            kind="fused_tiling",
        )
    n_tot = problem.rowptr.shape[0] - 1
    if n_tot % slots:
        raise InvalidGraphError(
            f"packed vertex count {n_tot} does not divide into {slots} slots",
            kind="fused_tiling",
        )
    slot_n = n_tot // slots
    # The band test on the device: row v (1-based) starts at rowptr[v-1]
    # and holds deg[v] lanes, inside [slot * slot_nnz, (slot+1) * slot_nnz).
    start = problem.rowptr[:-1].long()
    extent = problem.deg[1:].long()
    slot_of = torch.arange(n_tot, device=start.device) // max(slot_n, 1)
    lo = slot_of * slot_nnz
    bad = (extent > 0) & ((start < lo) | (start + extent > lo + slot_nnz))
    # The first bad row (argmax names the first maximum, as numpy's does),
    # or -1: the one readback.
    at = torch.cat([bad, bad.new_ones(1)]).to(torch.int32).argmax()
    i = int(torch.where(at < n_tot, at, -1).to(torch.int32))
    if i >= 0:
        raise InvalidGraphError(
            f"slot {i // slot_n}: row {i + 1} spans lanes "
            f"[{int(start[i])}, {int(start[i] + extent[i])}) outside its "
            f"aligned band [{i // slot_n * slot_nnz}, {(i // slot_n + 1) * slot_nnz}); the "
            "fused kernel's per-slot tiles would mix members",
            slot=i // slot_n,
            kind="fused_tiling",
        )
