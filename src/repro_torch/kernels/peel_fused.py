"""The fused level peel: one kernel launch per truss level.

The port's counterpart of ``repro.kernels.peel_fused``.  One call of the
``level_step`` that :func:`make_fused_level` returns advances every live
slot of a packed batch by exactly one truss level:

- support → prune (``alive & s >= cur_k - 2``) to the level's fixed
  point, without leaving the launch;
- frozen lanes count as alive while ``frozen_truss >= cur_k`` (computed
  once per launch: the threshold is fixed for the level);
- a tile of ``block`` lanes with no free alive lane is skipped (its
  supports are written as 0 — they are masked out of every output);
- a per-slot convergence latch counts ``iters`` exactly as the unfused
  peel (``repro_torch.exec.peel.build_peel``) does: a live slot counts
  one iteration per trip until the trip on which none of its lanes
  changed, then waits uncounted;
- level bookkeeping (trussness, ``cur_k`` advance, ``kmax``, ``levels``,
  retirement) and prune-ahead, as in ``build_peel``'s converged branch.

``total_iters`` grows by the launch's inner trips, so it legitimately
differs from the unfused peel's; every other state field is identical.

The kernel computes only what can change the state: the alive lanes of
slots that are neither done nor latched, from a worklist it compacts in
scratch; a done slot's ``alive``, ``support`` and ``trussness`` are copied
from the state in (its fixed point; see the source for why the copy is
exact), unless the state out already holds them: a launch walks only the
slots that can change (see :func:`fused_level_cuda`'s ``state_out``).
After a launch's first trip, a trip whose last prune killed at most as
many lanes as it kept takes its supports from those deaths (each lost
triangle taken off its surviving edges) instead of counting every alive
lane again; the supports are the count's either way.

The first trip of a launch updates the same way when the launch before,
in the same level loop, handed it a :class:`LevelCarry`: the lanes that
left the effective set (alive or frozen-live) between the two launches.
Every live slot of a launch converges, so its supports out are exact on
that set; the prune-ahead then kills some lanes, and in a slot that
advanced the frozen lanes of trussness ``cur_k`` stop counting as alive.
Those are the carried deaths.  A frozen leaver is exact like a pruned
lane: it was in the set the supports count over, is not in the next one,
and is never an alive lane itself, so its triangles come off their alive
survivors as any death's do.  The rule is the trips': update when the
carried deaths are at most the lanes alive at launch, count otherwise.  A
launch with no carry (a loop's first, or a state handed in from anywhere
else) counts, and :func:`fused_level_torch` ignores the carry.  Lanes whose
shorter (compacted) row exceeds :data:`SPLIT_ROW` entries are split into
:data:`SPLIT_WAYS` work items.  ``block`` is the most worklist items a warp
claims at a time.

The tensors' device picks the implementation, with no fallback between
them: :func:`fused_level_cuda` launches the hand-written Hopper kernel
``csrc/peel_fused.cu`` on CUDA tensors (or raises);
:func:`fused_level_torch` is its plain version, torch ops over
:func:`repro_torch.core.eager_fine.support_fine_owner`, and runs on CPU
tensors.  ``fused_level_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.eager_fine import FineProblem, support_fine_owner, undirected_alive
from ..errors import DeviceError
from ..exec.peel import PeelState
from .build import BuiltLibrary, load_library

__all__ = [
    "LevelCarry",
    "LevelCounts",
    "make_fused_level",
    "fused_level_torch",
    "fused_level_cuda",
    "load_peel_fused",
    "scratch_elements",
    "split_items",
    "split_lanes",
    "SPLIT_ROW",
    "SPLIT_WAYS",
    "NUM_STAMPS",
]

SCHEDULES = ("compare", "bsearch")
_PROBLEM_FIELDS = ("colidx", "edge_row", "urowptr", "udeg", "ucolidx", "u2d")

# A lane whose shorter undirected row has more than SPLIT_ROW entries is
# split into SPLIT_WAYS work items, chunks of that row that several warps
# take (rmat-15's hub row has 4,011 entries).  Fixed here, not a knob.
SPLIT_ROW = 256
SPLIT_WAYS = 8
# The kernel's clock readings when ``stamps`` is given (see fused_level_cuda).
NUM_STAMPS = 6
# `counts` holds, besides the per-slot counters (changed x 2, left), the
# item cursor per trip parity (64-bit: four int32 words) and the lengths
# of the two worklists and of the two death lists (unsplit, split) per
# parity (eight words).
_COUNTER_WORDS = 12


class LevelCounts(NamedTuple):
    """The slots, in order, of the int64 level-counts vector that every
    launch adds its counts to in place (``csrc/peel_fused.cu`` declares
    them as ``kUpdateTrips`` and on): its inner trips that took their
    supports from the last trip's deaths; the lanes its trips counted in
    full (a split lane once, a latched slot's not at all; the plain version
    counts every alive lane of every trip); 1 when its first trip updated
    from the carry; the alive lanes of the slots not done at launch; and
    the lanes its per-lane passes visited, ``slot_nnz`` times the slots it
    walked (the plain version visits all ``nnz_pad``).  The vector read
    back makes one of these."""

    update_trips: int
    counted_lanes: int
    carried: int
    alive_lanes: int
    walked_lanes: int

    @classmethod
    def zeros(cls, device) -> torch.Tensor:
        """A zeroed level-counts vector on ``device``."""
        return torch.zeros(len(cls._fields), dtype=torch.int64, device=device)


class LevelCarry(NamedTuple):
    """The carried deaths one :func:`fused_level_cuda` launch hands the
    next launch of the same level loop, on the state it returned: ``lanes``
    ((nnzp,) int32) lists ``length[0]`` lanes ((1,) int32); ``flags``
    ((nnzp,) uint8) holds each lane's flag in the next launch's compacted
    rows on the slots that advanced: 1 alive or frozen-live, 2 carried
    (dying), 0 neither (elsewhere unset: the next launch reads it only on
    rows of slots not done, which are those)."""

    lanes: torch.Tensor
    flags: torch.Tensor
    length: torch.Tensor

    @classmethod
    def empty(cls, nnzp: int, device) -> "LevelCarry":
        """Buffers for a launch to record its carry into (it sets ``length``)."""
        return cls(
            lanes=torch.empty(nnzp, dtype=torch.int32, device=device),
            flags=torch.empty(nnzp, dtype=torch.uint8, device=device),
            length=torch.empty(1, dtype=torch.int32, device=device),
        )


def scratch_elements(nnzp: int, unnzp: int, nrows: int, num_slots: int) -> dict[str, int]:
    """Elements of each scratch buffer of one :func:`fused_level_cuda`
    launch: the undirected rows compacted at launch (``ccol`` int32,
    ``calive`` uint8, ``clane`` int32: the lane of each entry, ``cdeg``
    int32 per row), ``lists`` and ``deaths`` (two worklists of lanes and
    two lists of the lanes a trip killed, int32), ``acc`` (split lanes'
    sums, int32) and ``counts`` (int32, zeroed)."""
    return {
        "ccol": unnzp,
        "calive": unnzp,
        "clane": unnzp,
        "cdeg": nrows,
        "lists": 2 * nnzp,
        "deaths": 2 * nnzp,
        "acc": nnzp,
        "counts": 3 * num_slots + _COUNTER_WORDS,
    }


def split_items(
    p: FineProblem, alive: torch.Tensor, frozen_live: torch.Tensor | None = None
) -> tuple[int, int]:
    """``(unsplit lanes, split lanes)`` of the kernel's first worklist when
    ``alive`` holds the alive lanes of the live slots and ``frozen_live``
    the frozen lanes that count as alive.  The launch compacts each
    undirected row to its entries in ``alive | frozen_live``; a lane is
    split when it is real and the shorter of its two compacted rows has
    more than :data:`SPLIT_ROW` entries.  A split lane is
    :data:`SPLIT_WAYS` work items."""
    eff = alive if frozen_live is None else alive | frozen_live
    ualive = undirected_alive(p, eff)
    cdeg = torch.zeros_like(p.udeg).index_add_(0, p.uedge_row.long(), ualive.to(torch.int32))
    n_split = int(split_lanes(p, alive, cdeg).sum())
    return int(alive.sum()) - n_split, n_split


def split_lanes(p: FineProblem, alive: torch.Tensor, row_len: torch.Tensor) -> torch.Tensor:
    """The lanes of ``alive`` that become :data:`SPLIT_WAYS` work items: the
    real lanes whose shorter row has more than :data:`SPLIT_ROW` entries,
    with ``row_len`` the length per vertex of the rows the kernel walks (the
    rows compacted at launch here; the whole rows in
    ``repro_torch.kernels.support_fine``).  The one split rule of both
    kernels."""
    short = torch.minimum(row_len[p.edge_row.long()], row_len[p.colidx.long()])
    return alive & (p.colidx != 0) & (short > SPLIT_ROW)


def _geometry(p: FineProblem, state: PeelState, block: int) -> tuple[int, int]:
    """``(num_slots, slot_nnz)`` of a packed batch, checked against ``block``."""
    nnzp = p.nnz_pad
    num_slots = int(state.cur_k.shape[0])
    if num_slots < 1 or nnzp % num_slots:
        raise ValueError(f"nnz_pad={nnzp} does not split into {num_slots} slots")
    slot_nnz = nnzp // num_slots
    if slot_nnz % block:
        raise ValueError(f"fused block={block} does not divide slot_nnz={slot_nnz}")
    return num_slots, slot_nnz


def fused_level_torch(
    p: FineProblem,
    state: PeelState,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
    single_level: torch.Tensor,
    *,
    window: int,
    block: int,
    level_counts: torch.Tensor | None = None,
    carry: LevelCarry | None = None,
) -> PeelState:
    """One truss level of every live slot, in torch ops (the plain version).

    Replays ``repro.kernels.peel_fused._level_kernel`` step by step.  Both
    of the kernel's intersection schedules count exactly, so the plain
    version has one: :func:`support_fine_owner` over the effective alive
    set.  Reads the loop condition back to the host once per inner trip.
    Every trip counts every lane, and ``carry`` is not read: of
    ``level_counts`` (see :class:`LevelCounts`; None for a vector of its
    own) it adds to ``counted_lanes``, ``alive_lanes`` and ``walked_lanes``
    (every lane) alone.
    """
    del carry  # every trip counts
    num_slots, slot_nnz = _geometry(p, state, block)
    cur_k, done = state.cur_k, state.done
    if level_counts is None:
        level_counts = LevelCounts.zeros(done.device)
    slot = LevelCounts._fields.index
    level_counts[slot("alive_lanes")] += (state.alive & ~done.repeat_interleave(slot_nnz)).sum()
    level_counts[slot("walked_lanes")] += p.nnz_pad
    cur_k_lane = cur_k.repeat_interleave(slot_nnz)
    frozen_live = frozen & (frozen_truss >= cur_k_lane)
    # Per level a live slot prunes >= 1 of its <= slot_nnz free lanes per
    # trip until its convergence trip: a provable cap.
    inner_limit = slot_nnz + 2

    alive = state.alive
    s = torch.zeros_like(alive, dtype=torch.int32)
    latch = torch.zeros_like(done)
    iters = state.iters
    trips = 0
    while trips < inner_limit and bool((~latch & ~done).any()):
        s = support_fine_owner(p, alive | frozen_live, window=window, chunk=block)
        level_counts[slot("counted_lanes")] += alive.sum()
        tile_live = alive.view(-1, block).any(dim=1).repeat_interleave(block)
        s = s * tile_live
        new_alive = alive & (s >= cur_k_lane - 2)
        changed = (new_alive ^ alive).view(num_slots, slot_nnz).sum(dim=1)
        live = ~latch & ~done
        iters = iters + live.to(torch.int32)
        latch = latch | (live & (changed == 0))
        alive = new_alive
        trips += 1

    converged = latch & ~done
    conv_lane = converged.repeat_interleave(slot_nnz)
    trussness = torch.where(conv_lane & alive, cur_k_lane, state.trussness)
    left = alive.view(num_slots, slot_nnz).sum(dim=1, dtype=torch.int32)
    nonempty = left > 0
    retired = converged & (~nonempty | single_level)
    cur_k_new = torch.where(converged & ~retired, cur_k + 1, cur_k)
    # Prune-ahead against the advanced threshold with the support in hand.
    alive_next = alive & (s >= cur_k_new.repeat_interleave(slot_nnz) - 2)
    return PeelState(
        alive=alive_next,
        support=s * alive_next.to(torch.int32),
        trussness=trussness,
        cur_k=cur_k_new,
        kmax=torch.where(converged & nonempty, cur_k, state.kmax),
        levels=state.levels + converged.to(torch.int32),
        iters=iters,
        done=done | retired,
        total_iters=state.total_iters + trips,
        edges_alive=torch.where(done, state.edges_alive, left),
    )


def load_peel_fused() -> BuiltLibrary:
    """Build (on first use) and load the kernel library; ctypes signatures set."""
    built = load_library("peel_fused")
    fn = built.lib.peel_fused_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 46
        + [ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int] * 11
        + [ctypes.c_void_p] * 3  # the stream, the timing events (or null)
    )
    fn.restype = ctypes.c_int
    occ = built.lib.peel_fused_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int]
    occ.restype = ctypes.c_int
    err = built.lib.peel_fused_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check_cuda_inputs(p, state, frozen, frozen_truss, single_level) -> torch.device:
    dev = state.alive.device
    if dev.type != "cuda":
        raise ValueError(f"fused_level_cuda needs CUDA tensors, got {dev}")
    nnzp, num_slots = p.nnz_pad, int(state.cur_k.shape[0])
    want = {
        "alive": (state.alive, torch.bool, (nnzp,)),
        "support": (state.support, torch.int32, (nnzp,)),
        "trussness": (state.trussness, torch.int32, (nnzp,)),
        "cur_k": (state.cur_k, torch.int32, (num_slots,)),
        "kmax": (state.kmax, torch.int32, (num_slots,)),
        "levels": (state.levels, torch.int32, (num_slots,)),
        "iters": (state.iters, torch.int32, (num_slots,)),
        "done": (state.done, torch.bool, (num_slots,)),
        "edges_alive": (state.edges_alive, torch.int32, (num_slots,)),
        "total_iters": (state.total_iters, torch.int32, ()),
        "frozen": (frozen, torch.bool, (nnzp,)),
        "frozen_truss": (frozen_truss, torch.int32, (nnzp,)),
        "single_level": (single_level, torch.bool, (num_slots,)),
    }
    want.update({f: (getattr(p, f), torch.int32, None) for f in _PROBLEM_FIELDS})
    for name, (x, dtype, shape) in want.items():
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(
                f"{name!r} must be a contiguous {dtype} tensor on {dev}, "
                f"got {x.dtype} on {x.device}"
            )
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name!r} must have shape {shape}, got {tuple(x.shape)}")
    return dev


def fused_level_cuda(
    p: FineProblem,
    state: PeelState,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
    single_level: torch.Tensor,
    *,
    block: int,
    schedule: str,
    trip_log: torch.Tensor | None = None,
    stamps: torch.Tensor | None = None,
    level_counts: torch.Tensor | None = None,
    carry: LevelCarry | None = None,
    carry_out: LevelCarry | None = None,
    state_out: PeelState | None = None,
    events=None,
) -> PeelState:
    """One truss level of every live slot, by the CUDA kernel (one
    cooperative launch).  A refused or failed launch raises
    :class:`repro_torch.errors.DeviceError`.

    Optional diagnostics, CUDA tensors the kernel writes into:
    ``trip_log`` ((2 * T,) int32) receives for each of the first T inner
    trips the worklist's unsplit and split lanes; ``stamps`` ((6,) int64)
    CTA 0's clock (``%globaltimer``, ns) at entry, rows compacted, first
    worklist built, inner loop done, bookkeeping done and exit.

    ``level_counts``: the level-counts vector the launch adds its counts
    to (see :class:`LevelCounts`); None for a vector of its own.

    ``carry``: the :class:`LevelCarry` that the launch which returned
    ``state`` recorded (and only that one): the first trip may then update
    from it.  ``carry_out``: buffers the launch records its own carry into
    for the next launch; they may be ``carry``'s (the launch reads a carry
    before it writes one).

    ``state_out``: the state the launch before last of the same level loop
    returned (and only that one; never ``state`` itself), which the launch
    writes into and returns.  The done slots it already holds final are
    neither read nor written: a launch walks the slots not done and copies
    the newly done ones.  None allocates a fresh state, into which every
    done slot is copied.

    ``events`` (a ``repro_torch.obs.device_time.EventPair`` on the state's
    device): the library records its two events on the launch's stream
    just before and just after the launch call, so their interval holds
    the launch alone, not the scratch set-up or the library's queries."""
    num_slots, slot_nnz = _geometry(p, state, block)
    dev = _check_cuda_inputs(p, state, frozen, frozen_truss, single_level)
    if trip_log is not None and (
        trip_log.device != dev or trip_log.dtype != torch.int32 or trip_log.dim() != 1
        or not trip_log.is_contiguous() or trip_log.numel() % 2
    ):
        raise ValueError("trip_log must be a contiguous (2 * T,) int32 tensor on the state's "
                         "device")
    if stamps is not None and (
        stamps.device != dev or stamps.dtype != torch.int64 or stamps.shape != (NUM_STAMPS,)
        or not stamps.is_contiguous()
    ):
        raise ValueError(f"stamps must be a contiguous ({NUM_STAMPS},) int64 tensor on the "
                         "state's device")
    if level_counts is None:
        level_counts = LevelCounts.zeros(dev)
    if level_counts.device != dev or not level_counts.is_contiguous() or (
        level_counts.dtype, level_counts.shape) != (torch.int64, (len(LevelCounts._fields),)):
        raise ValueError("level_counts must be a contiguous LevelCounts.zeros vector on the "
                         "state's device")
    nnzp, unnzp = p.nnz_pad, int(p.ucolidx.shape[0])
    for name, c in (("carry", carry), ("carry_out", carry_out)):
        if c is not None and any(
            x.device != dev or x.dtype != dtype or x.shape != shape or not x.is_contiguous()
            for x, dtype, shape in (
                (c.lanes, torch.int32, (nnzp,)), (c.flags, torch.uint8, (nnzp,)),
                (c.length, torch.int32, (1,)),
            )
        ):
            raise ValueError(f"{name} must be a LevelCarry of ({nnzp},) int32 lanes, ({nnzp},) "
                             "uint8 flags and (1,) int32 length on the state's device")
    if state_out is not None:
        ins = {x.data_ptr() for x in state}
        for f in PeelState._fields:
            x, like = getattr(state_out, f), getattr(state, f)
            if (x.device, x.dtype, x.shape) != (like.device, like.dtype, like.shape) or (
                not x.is_contiguous() or x.data_ptr() in ins
            ):
                raise ValueError(f"state_out.{f} must be a contiguous {like.dtype} tensor of "
                                 f"shape {tuple(like.shape)} on {dev}, apart from the state in")
    built = load_peel_fused()

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    out = state_out if state_out is not None else PeelState(
        alive=torch.empty(nnzp, dtype=torch.bool, device=dev),
        support=i32(nnzp),
        trussness=i32(nnzp),
        cur_k=i32(num_slots),
        kmax=i32(num_slots),
        levels=i32(num_slots),
        iters=i32(num_slots),
        done=torch.empty(num_slots, dtype=torch.bool, device=dev),
        total_iters=i32(()),
        edges_alive=i32(num_slots),
    )
    nrows = int(p.udeg.shape[0])
    n = scratch_elements(nnzp, unnzp, nrows, num_slots)
    ccol, clane, cdeg = i32(n["ccol"]), i32(n["clane"]), i32(n["cdeg"])
    calive = torch.empty(n["calive"], dtype=torch.uint8, device=dev)
    lists, deaths, acc = i32(n["lists"]), i32(n["deaths"]), i32(n["acc"])
    counts = torch.zeros(n["counts"], dtype=torch.int32, device=dev)
    ptrs = [
        x.data_ptr()
        for x in (
            p.colidx, p.edge_row, p.urowptr, p.udeg, p.ucolidx, p.u2d,
            state.alive, state.support, state.trussness, state.cur_k, state.kmax,
            state.levels, state.iters, state.done, state.edges_alive, state.total_iters,
            frozen, frozen_truss, single_level,
            out.alive, out.support, out.trussness, out.cur_k, out.kmax, out.levels,
            out.iters, out.done, out.total_iters, out.edges_alive,
            ccol, calive, clane, cdeg, lists, deaths, acc, counts,
        )
    ]
    ptrs += [x.data_ptr() if x is not None else None for x in (trip_log, stamps, level_counts)]
    for c in (carry, carry_out):
        ptrs += [x.data_ptr() for x in c] if c is not None else [None] * 3
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.peel_fused_launch(
            *ptrs,
            nnzp,
            unnzp,
            nrows,
            slot_nnz,
            num_slots,
            block,
            slot_nnz + 2,  # inner_limit, as in fused_level_torch
            SPLIT_ROW,
            SPLIT_WAYS,
            trip_log.numel() // 2 if trip_log is not None else 0,
            int(state_out is not None),  # held: the state out holds its done slots' lanes
            int(schedule == "bsearch"),
            dev.index if dev.index is not None else torch.cuda.current_device(),
            stream,
            *(events.handles() if events is not None else (None, None)),
        )
    if rc:
        msg = built.lib.peel_fused_error_string(rc).decode()
        raise DeviceError(
            f"peel_fused kernel launch failed: {msg} (cudaError {rc})", site="fused_level"
        )
    fused_level_cuda.launches += 1
    return out


fused_level_cuda.launches = 0


def make_fused_level(*, window: int, block: int = 128, schedule: str = "bsearch"):
    """Build the one-launch-per-level step for one configuration.

    Returns ``level_step(p, state, frozen, frozen_truss, single_level, *,
    carry=None, state_out=None, events=None, level_counts=None) ->
    (PeelState, LevelCarry | None)`` advancing every live slot by exactly
    one truss level and adding its counts to ``level_counts`` (see
    :class:`LevelCounts`).  CUDA tensors go to :func:`fused_level_cuda`
    (with ``carry``, the one the last step of the same level loop returned,
    or None; ``state_out``, the state the step before last of that loop
    returned, or None; ``events``, the launch's timing pair), which returns
    the launch's own carry, recorded into ``carry``'s buffers when given;
    CPU tensors to :func:`fused_level_torch`, which counts every lane on
    every trip, allocates its state and returns no carry.
    ``window`` must cover the bucket's max
    undirected degree; ``block`` must divide the packed ``slot_nnz``
    (checked here and, with slot attribution, by
    ``repro_torch.graphs.pack.validate_fused_tiling``).
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown fused schedule {schedule!r}")
    if block < 1 or (block & (block - 1)) != 0:
        raise ValueError(f"fused block must be a power of two, got {block}")

    def level_step(p, state, frozen, frozen_truss, single_level, *, carry=None, state_out=None,
                   events=None, level_counts=None):
        dev = state.alive.device
        if dev.type == "cuda":
            out = carry if carry is not None else LevelCarry.empty(p.nnz_pad, dev)
            st = fused_level_cuda(
                p, state, frozen, frozen_truss, single_level, block=block, schedule=schedule,
                level_counts=level_counts, carry=carry, carry_out=out, state_out=state_out,
                events=events,
            )
            return st, out
        if dev.type != "cpu":
            raise ValueError(f"the fused level runs on CUDA or the CPU, got {dev}")
        st = fused_level_torch(
            p, state, frozen, frozen_truss, single_level, window=window, block=block,
            level_counts=level_counts, carry=carry,
        )
        return st, None

    return level_step
