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

The tensors' device picks the implementation, with no fallback between
them: :func:`fused_level_cuda` launches the hand-written Hopper kernel
``csrc/peel_fused.cu`` on CUDA tensors (or raises);
:func:`fused_level_torch` is its plain version, torch ops over
:func:`repro_torch.core.eager_fine.support_fine_owner`, and runs on CPU
tensors.  ``fused_level_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.eager_fine import FineProblem, support_fine_owner
from ..errors import DeviceError
from ..exec.peel import PeelState
from .build import BuiltLibrary, load_library

__all__ = [
    "make_fused_level",
    "fused_level_torch",
    "fused_level_cuda",
    "load_peel_fused",
]

SCHEDULES = ("compare", "bsearch")
_PROBLEM_FIELDS = ("colidx", "edge_row", "urowptr", "udeg", "ucolidx", "u2d")


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
) -> PeelState:
    """One truss level of every live slot, in torch ops (the plain version).

    Replays ``repro.kernels.peel_fused._level_kernel`` step by step.  Both
    of the kernel's intersection schedules count exactly, so the plain
    version has one: :func:`support_fine_owner` over the effective alive
    set.  Reads the loop condition back to the host once per inner trip.
    """
    num_slots, slot_nnz = _geometry(p, state, block)
    cur_k, done = state.cur_k, state.done
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
        [ctypes.c_void_p] * 31
        + [ctypes.c_longlong, ctypes.c_longlong]
        + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
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
) -> PeelState:
    """One truss level of every live slot, by the CUDA kernel (one
    cooperative launch).  A refused or failed launch raises
    :class:`repro_torch.errors.DeviceError`."""
    num_slots, slot_nnz = _geometry(p, state, block)
    dev = _check_cuda_inputs(p, state, frozen, frozen_truss, single_level)
    built = load_peel_fused()
    nnzp, unnzp = p.nnz_pad, int(p.ucolidx.shape[0])

    def i32(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    out = PeelState(
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
    # Scratch: frozen-live flags, the undirected alive flags, and per-slot
    # counters (two parities of `changed`, then `left`).
    flive = torch.empty(nnzp, dtype=torch.uint8, device=dev)
    ualive = torch.empty(unnzp, dtype=torch.uint8, device=dev)
    counts = i32(3 * num_slots)
    ptrs = [
        x.data_ptr()
        for x in (
            p.colidx, p.edge_row, p.urowptr, p.udeg, p.ucolidx, p.u2d,
            state.alive, state.trussness, state.cur_k, state.kmax, state.levels,
            state.iters, state.done, state.edges_alive, state.total_iters,
            frozen, frozen_truss, single_level,
            out.alive, out.support, out.trussness, out.cur_k, out.kmax, out.levels,
            out.iters, out.done, out.total_iters, out.edges_alive,
            flive, ualive, counts,
        )
    ]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.peel_fused_launch(
            *ptrs,
            nnzp,
            unnzp,
            slot_nnz,
            num_slots,
            block,
            slot_nnz + 2,  # inner_limit, as in fused_level_torch
            int(schedule == "bsearch"),
            dev.index if dev.index is not None else torch.cuda.current_device(),
            stream,
        )
    if rc:
        msg = built.lib.peel_fused_error_string(rc).decode()
        raise DeviceError(
            f"peel_fused kernel launch failed: {msg} (cudaError {rc})", site="fused_level"
        )
    fused_level_cuda.launches += 1
    return out


fused_level_cuda.launches = 0


def make_fused_level(*, window: int, block: int = 32, schedule: str = "compare"):
    """Build the one-launch-per-level step for one configuration.

    Returns ``level_step(p, state, frozen, frozen_truss, single_level) ->
    PeelState`` advancing every live slot by exactly one truss level.
    CUDA tensors go to :func:`fused_level_cuda`, CPU tensors to
    :func:`fused_level_torch`.  ``window`` must cover the bucket's max
    undirected degree; ``block`` must divide the packed ``slot_nnz``
    (checked here and, with slot attribution, by
    ``repro_torch.graphs.pack.validate_fused_tiling``).
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown fused schedule {schedule!r}")
    if block < 1 or (block & (block - 1)) != 0:
        raise ValueError(f"fused block must be a power of two, got {block}")

    def level_step(p, state, frozen, frozen_truss, single_level):
        dev = state.alive.device
        if dev.type == "cuda":
            return fused_level_cuda(
                p, state, frozen, frozen_truss, single_level, block=block, schedule=schedule
            )
        if dev.type != "cpu":
            raise ValueError(f"the fused level runs on CUDA or the CPU, got {dev}")
        return fused_level_torch(
            p, state, frozen, frozen_truss, single_level, window=window, block=block
        )

    return level_step
