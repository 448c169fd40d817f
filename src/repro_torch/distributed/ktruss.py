"""K-truss sharding: packed slot blocks across a set of devices.

The serving layer packs B same-bucket graphs block-diagonally, and in the
slot-aligned layout (``repro_torch.graphs.pack``, ``layout="aligned"``)
edge lanes ``[i * slot_nnz, (i+1) * slot_nnz)`` and vertices
``[i * slot_n + 1, (i+1) * slot_n]`` belong to slot i.  Slots never
interact, so slot boundaries are natural shard boundaries: each device
gets a block of whole slots, with no cross-device triangle closing.

The reference leaves the split to GSPMD, which keeps global indices.
Torch has no single-controller partitioner, so here the split is
explicit: :func:`shard_peel_args` cuts the packed problem into one
problem per device and rebases it to that device's own numbering.  A
shard's vertex ids (1-based; 0 stays the pad sentinel) drop by the
block's first vertex, its lane indices (``rowptr``, ``urowptr``, ``u2d``)
by the block's first lane, and its slot ids by the block's first slot.
The result is exactly the ``slots / d``-slot aligned pack of the block's
members, so every backend peels it unchanged, and the executor
(``repro_torch.exec.PeelExecutor(mesh=)``) runs the shards in lock step
and concatenates their states in slot order.  All peel state is
integer/bool, so the sharded result equals the unsharded one bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.eager_fine import FineProblem
from ..device import canonical_device
from ..errors import InvalidGraphError

__all__ = ["SLOT_AXIS", "SlotMesh", "slot_mesh", "peel_problem_specs", "shard_peel_args"]

SLOT_AXIS = "slots"


@dataclasses.dataclass(frozen=True)
class SlotMesh:
    """A 1-D mesh over the ``"slots"`` axis: the devices the slot blocks go
    to, in slot order.  ``shape`` and ``axis_names`` read as the
    reference's ``jax.sharding.Mesh`` does."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = (SLOT_AXIS,)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a slot mesh needs at least one device")
        # One device type, so that the planner's device (the first) says
        # whether the shards run the hand kernels on a card.
        types = sorted({torch.device(d).type for d in self.devices})
        if len(types) > 1:
            raise ValueError(f"a slot mesh's devices must be of one type, got {types}")
        object.__setattr__(self, "devices", tuple(canonical_device(d) for d in self.devices))

    @property
    def shape(self) -> dict[str, int]:
        return {SLOT_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def slot_mesh(num_devices: int | None = None, *, devices=None) -> SlotMesh:
    """1-D mesh over the ``"slots"`` axis.

    By default it spans every visible CUDA device, or the first
    ``num_devices`` of them.  ``devices`` names the devices instead (the
    first ``num_devices`` of them when both are given), and only this form
    may repeat a device: ``("cpu",) * 8`` runs eight shards on the CPU,
    ``("cuda:0", "cuda:0")`` two shards on one card.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=(...) for a mesh on the CPU"
            )
        devs = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        devs = tuple(devices)
    d = int(num_devices) if num_devices is not None else len(devs)
    if d > len(devs):
        raise ValueError(f"requested {d} devices, have {len(devs)}")
    if d < 1:
        raise ValueError(f"a slot mesh needs at least one device, got num_devices={d}")
    return SlotMesh(devs[:d])


def peel_problem_specs() -> list[tuple[str, ...]]:
    """Per :class:`FineProblem` field (field order), the mesh axes its
    leading dimension is split over, in the reference's ``PartitionSpec``
    form: ``("slots",)`` for edge-dim fields, ``()`` for vertex-dim ones.

    Edge-dim fields are cut into lane blocks, one per device.  Vertex-dim
    fields (``rowptr``, ``deg``, ``urowptr``, ``udeg``: O(n) index
    metadata) are not cut by lanes; each device holds the rows its slots'
    lanes index, in its own numbering (see :func:`shard_peel_args`).
    """
    edge = (SLOT_AXIS,)
    rep = ()
    return [
        rep,  # rowptr   (n+1,)
        edge,  # colidx   (nnzp,)
        edge,  # edge_row (nnzp,)
        rep,  # deg      (n+1,)
        rep,  # urowptr  (n+1,)
        edge,  # ucolidx  (unnzp,)
        edge,  # u2d      (unnzp,)
        edge,  # uedge_row(unnzp,)
        rep,  # udeg     (n+1,)
    ]


def _ids(x: torch.Tensor, base: int) -> torch.Tensor:
    """Vertex ids less ``base``; 0, the pad sentinel, stays 0."""
    return torch.where(x != 0, x - base, 0)


def _shard_problem(p: FineProblem, j: int, d: int) -> FineProblem:
    """Shard ``j`` of ``d``: the lane and vertex block of its slots, rebased."""
    nv, ne = p.n // d, p.nnz_pad // d
    nu = int(p.ucolidx.shape[0]) // d
    vo, eo, uo = j * nv, j * ne, j * nu
    zero = p.deg[:1]  # deg[0] / udeg[0]: the sentinel vertex has no row
    return FineProblem(
        rowptr=p.rowptr[vo : vo + nv + 1] - eo,
        colidx=_ids(p.colidx[eo : eo + ne], vo),
        edge_row=_ids(p.edge_row[eo : eo + ne], vo),
        deg=torch.cat([zero, p.deg[vo + 1 : vo + nv + 1]]),
        urowptr=p.urowptr[vo : vo + nv + 1] - uo,
        ucolidx=_ids(p.ucolidx[uo : uo + nu], vo),
        u2d=torch.where(p.u2d[uo : uo + nu] < p.nnz_pad, p.u2d[uo : uo + nu] - eo, ne),
        uedge_row=_ids(p.uedge_row[uo : uo + nu], vo),
        udeg=torch.cat([zero, p.udeg[vo + 1 : vo + nv + 1]]),
    )


def _escapes(q: FineProblem, slot_ids: torch.Tensor, slots: int) -> torch.Tensor:
    """Does shard problem ``q`` reach outside its own block?  (0-dim bool.)

    True when a lane names a vertex, a directed lane or a slot of another
    shard, or a row spans lanes outside the shard: the pack was not slot
    aligned, and rebasing it would mix members."""
    nv, ne, nu = q.n, q.nnz_pad, int(q.ucolidx.shape[0])

    def outside(x, hi):
        return ((x < 0) | (x > hi)).any()

    rows = (q.deg[1:] > 0) & (
        (q.rowptr[:-1] < 0) | (q.rowptr[:-1] + q.deg[1:] > ne)
    )
    urows = (q.udeg[1:] > 0) & (
        (q.urowptr[:-1] < 0) | (q.urowptr[:-1] + q.udeg[1:] > nu)
    )
    return torch.stack(
        [
            outside(q.colidx, nv),
            outside(q.edge_row, nv),
            outside(q.ucolidx, nv),
            outside(q.uedge_row, nv),
            outside(q.u2d, ne),
            outside(slot_ids, slots - 1),
            rows.any(),
            urows.any(),
        ]
    ).any()


def shard_peel_args(
    mesh: SlotMesh,
    p: FineProblem,
    slot_ids: torch.Tensor,
    k0: torch.Tensor,
    single_level: torch.Tensor,
    alive0: torch.Tensor,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
):
    """Split peel inputs over ``mesh``: one set of peel inputs per device.

    Device ``j`` gets slots ``[j * S/d, (j+1) * S/d)``: their lane block of
    every edge-dim input (``alive0``, ``frozen``, ``frozen_truss`` too),
    their per-slot entries, and their rows of the vertex-dim fields, all
    rebased to the device's own numbering (see the module docstring), so
    each set is the aligned pack of that block's members.  Requires the
    mesh size to divide the slot count (and hence ``nnz_pad``), so each
    device owns whole slots, and raises :class:`InvalidGraphError` when
    the pack is not slot aligned (one readback per shard).
    """
    d = mesh.size
    num_slots = int(k0.shape[0])
    nnzp = p.nnz_pad
    if num_slots % d or nnzp % d:
        raise ValueError(
            f"mesh size {d} must evenly divide slots={num_slots} "
            f"(and nnz_pad={nnzp}) so each device owns whole slots"
        )
    spd, ne = num_slots // d, nnzp // d
    shards = []
    for j, dev in enumerate(mesh.devices):
        q = _shard_problem(p, j, d)
        ids = slot_ids[j * ne : (j + 1) * ne] - j * spd
        # One readback per shard and dispatch: refuse a pack that is not
        # slot aligned before any trip runs.
        if bool(_escapes(q, ids, spd)):  # trusslint: disable=R1
            raise InvalidGraphError(
                f"shard {j} of {d}: the pack is not slot aligned (a lane of slots "
                f"[{j * spd}, {(j + 1) * spd}) reaches outside their block); a mesh "
                "needs layout='aligned'",
                slot=j * spd,
                kind="shard_tiling",
            )
        lanes = slice(j * ne, (j + 1) * ne)
        slots = slice(j * spd, (j + 1) * spd)
        shards.append(
            (
                FineProblem(*(x.to(dev) for x in q)),
                ids.to(dev),
                k0[slots].to(dev),
                single_level[slots].to(dev),
                alive0[lanes].to(dev),
                frozen[lanes].to(dev),
                frozen_truss[lanes].to(dev),
            )
        )
    return shards
