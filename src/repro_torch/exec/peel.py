"""Device-resident level peeling: a whole truss decomposition per dispatch.

The torch counterpart of ``repro.exec.peel``.  :func:`build_peel` returns a
peel whose every trip runs a support computation, prunes each lane
against its packed slot's current threshold, and — for every slot whose
alive mask just reached a fixed point — records the surviving edges'
trussness at ``cur_k``, bumps the slot's kmax/level counters, and advances
its threshold to ``cur_k + 1`` (or retires the slot when its level
emptied, or at once for single-level ``ktruss(k)`` members).

The reference runs the trips inside one ``lax.while_loop`` whose
condition, ``any(~done) & (total_iters < limit)``, the device evaluates,
compiled on the executor's first call.  So does the port on CUDA: a
shard's trip loop is one captured CUDA graph (:class:`_TripGraph`), one
trip the body of a WHILE conditional node whose condition
(:func:`_trip_pred`) the device computes before the first trip and after
each; it is captured on the first dispatch of each shard's shapes and
device (a ``PEEL_CAPTURE`` event, the counterpart of the reference's
compile) and replayed, its inputs copied into its static buffers, on
every later one.  There is no eager path on CUDA.  On the CPU the same
loop reads its condition as a host bool each trip, which is free there.
Both devices read back alike: once per shard before its first trip (is
any lane alive, are the slot ids the aligned layout, and which is the
last slot with an alive lane), then once per live shard after its loop
(the exit condition, with the support passes and the lanes they were
given, which the device counted, and on CUDA the support kernel's global
claims), two a live shard whatever its trips;
the executor counts every readback in ``host_syncs``.  An aligned shard's
trips walk only its leading slots up to the last live one, rounded up to
a power of two (:func:`_slot_prefix`): the slots past them are done
before the first trip and keep their starting state, so a one-query
dispatch on eight slots peels one slot's lanes.  On CUDA each replay is
bracketed by a pair of timing events (``repro_torch.obs.device_time``),
read once the loop's exit has been read back.  A **dispatch** is one
:meth:`PeelExecutor.peel` call: one packed batch peeled to completion,
however many trips it takes.  ``total_iters`` counts trips exactly as the
reference's loop counter does.

Slots are the block-diagonal members of ``repro_torch.graphs.pack``;
because the packing is a disjoint union, each slot's fixed point is
independent and a per-slot convergence test (a sum of changed lanes per
slot, :class:`_SlotSums`) is exact.

:func:`build_fused_peel` is the fused form: each level's support→prune
fixed point runs inside one launch of the fused level kernel
(``repro_torch.kernels.peel_fused``), and the host loop steps levels with
one readback per level; each launch's inner trips, and on CUDA its device
time between two events, are recorded once the next readback returns.

With a mesh (``repro_torch.distributed``), :class:`PeelExecutor` splits a
packed batch into per-device blocks of whole slots and runs the blocks in
lock step (:meth:`_Peel.lock_step`); the concatenated state equals the
unsharded peel's, field for field.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import threading
import time
import weakref
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..core.eager_coarse import support_coarse_eager
from ..core.eager_fine import FineProblem, support_fine_eager, support_fine_owner
from ..errors import DeviceError, TrussError
from ..obs import current_registry, current_tracer
from ..obs.device_time import EventPair, add_device_seconds
from ..obs.events import PEEL_CAPTURE, record_event
from ..obs.names import (
    PEEL_LEVEL_DEVICE_SECONDS,
    PEEL_LEVEL_LANES_COUNTED,
    PEEL_LEVEL_LANES_WALKED,
    PEEL_LEVEL_TRIPS,
    PEEL_LEVEL_TRIPS_CARRIED,
    PEEL_LEVEL_TRIPS_INCREMENTAL,
    PEEL_SUPPORT_CLAIMS,
    PEEL_SUPPORT_LANES,
    PEEL_SUPPORT_PASSES,
    PEEL_TRIP_LANES_WALKED,
    PEEL_TRIPS,
)

__all__ = [
    "PeelState",
    "make_problem_support",
    "init_peel_state",
    "build_peel",
    "build_fused_peel",
    "PeelExecutor",
]

SupportFn = Callable[[FineProblem, torch.Tensor], torch.Tensor]

_CAPTURE_LOCK = threading.Lock()  # held by every trip-graph capture in the process
# The CUDA graphs and memory pools of dropped trip graphs.  A memory pool
# must not be destroyed while any capture is underway (the caching
# allocator asserts it), and the garbage collector may drop a trip graph
# during another's capture, so they wait here and are destroyed under
# _CAPTURE_LOCK by _release_retired.
_RETIRED: list[tuple] = []


def _release_retired() -> None:  # requires-lock: _CAPTURE_LOCK
    while _RETIRED:
        graph, pool = _RETIRED.pop()
        del graph  # before the pool its bodies allocated from
        del pool


class PeelState(NamedTuple):
    """Carry/result of the device peel.

    Per-edge tensors span the packed problem's ``nnz_pad`` lanes; per-slot
    tensors have one entry per packed slot.
    """

    alive: torch.Tensor  # (nnzp,) bool — final alive mask (fixed point of cur_k)
    support: torch.Tensor  # (nnzp,) int32 — post-prune supports of that mask
    trussness: torch.Tensor  # (nnzp,) int32 — last k whose truss held the edge
    cur_k: torch.Tensor  # (S,) int32 — threshold each slot ended on
    kmax: torch.Tensor  # (S,) int32 — largest k with non-empty truss (0 if none)
    levels: torch.Tensor  # (S,) int32 — fixed-point levels peeled
    iters: torch.Tensor  # (S,) int32 — prune iterations while the slot was live
    done: torch.Tensor  # (S,) bool
    total_iters: torch.Tensor  # () int32 — loop trips (the cap's subject)
    edges_alive: torch.Tensor  # (S,) int32 — alive edges at the last converged level


def make_problem_support(
    *,
    granularity: str = "fine",
    mode: str = "eager",
    backend: str = "xla",
    window: int,
    chunk: int = 256,
    row_chunk: int = 32,
) -> SupportFn:
    """Problem-polymorphic ``(problem, alive) -> support`` for one config.

    ``backend="pallas"`` is the kernel axis: it runs
    :func:`repro_torch.kernels.ops.support_fine`, which launches the
    hand-written CUDA kernel on CUDA tensors.  ``"xla"`` is the torch-ops
    twin axis (the name keeps the reference's spelling).
    """
    if backend == "fused":
        raise ValueError(
            "the fused backend is not a support fn; it is built whole via "
            "build_fused_peel (one kernel launch per level)"
        )
    if backend == "pallas":
        from ..kernels import ops as kernel_ops  # lazy: keeps exec dep-light

        if granularity != "fine":
            raise ValueError("pallas backend implements the fine granularity")
        return functools.partial(kernel_ops.support_fine, window=window, chunk=chunk)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    if granularity == "coarse":
        if mode != "eager":
            raise ValueError("coarse granularity implements the eager mode")
        return functools.partial(support_coarse_eager, window=window, row_chunk=row_chunk)
    if granularity != "fine":
        raise ValueError(f"unknown granularity {granularity!r}")
    if mode == "eager":
        return functools.partial(support_fine_eager, window=window, chunk=chunk)
    if mode == "owner":
        return functools.partial(support_fine_owner, window=window, chunk=chunk)
    raise ValueError(f"unknown mode {mode!r}")


class _SlotSums:
    """Exact per-slot int32 sums of a lane mask, with no atomics.

    Built once per peel from the slot ids, on their device.  In the
    aligned layout (lane block ``s`` of ``nnz_pad / slots`` lanes is slot
    ``s``: ``arange(slots).repeat_interleave(...)``, the planner's aligned
    pack and every mesh shard) a sum is a reshape to ``(slots, -1)`` and a
    row sum.  Any other ids (the contig layout, whose pad tail is parked
    on slot 0 after the last member) are stably sorted once; a sum is then
    the lanes' cumulative sum in that order, differenced at each slot's
    end.  Both are exact for every input.
    """

    def __init__(self, slot_ids: torch.Tensor, num_slots: int, *, aligned: bool):
        self.num_slots = num_slots
        self.order = None
        if aligned:
            return
        ids = slot_ids.to(torch.int32)
        self.order = torch.argsort(ids, stable=True)
        slots = torch.arange(num_slots, dtype=torch.int32, device=ids.device)
        ends = torch.searchsorted(ids[self.order], slots, right=True)
        self.last = (ends - 1).clamp(min=0)  # each slot's last lane in sorted order
        self.nonempty = ends > 0

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """The index tensors a sum reads (none in the aligned layout)."""
        return () if self.order is None else (self.order, self.last, self.nonempty)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.order is None:
            return x.reshape(self.num_slots, -1).sum(1, dtype=torch.int32)
        csum = x[self.order].cumsum(0, dtype=torch.int32)
        upto = torch.where(self.nonempty, csum[self.last], 0)  # lanes of slots <= s
        return torch.diff(upto, prepend=upto.new_zeros(1))


def _is_aligned(slot_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """() bool on the ids' device: are the ids the aligned layout?"""
    if num_slots == 0 or slot_ids.numel() % num_slots:
        return torch.zeros((), dtype=torch.bool, device=slot_ids.device)
    slots = torch.arange(num_slots, dtype=slot_ids.dtype, device=slot_ids.device)
    return (slot_ids.reshape(num_slots, -1) == slots[:, None]).all()


def _live_slots(alive0: torch.Tensor, num_slots: int) -> torch.Tensor:
    """() int64 on the mask's device: one more than the last of the
    aligned layout's lane blocks that holds an alive lane (0 when none
    does; ``num_slots`` when the lanes do not split into the slots)."""
    dev = alive0.device
    if num_slots == 0 or alive0.numel() % num_slots:
        return torch.full((), num_slots, dtype=torch.int64, device=dev)
    rank = torch.arange(1, num_slots + 1, device=dev)
    return (alive0.reshape(num_slots, -1).any(1) * rank).max()


def _walked_slots(live: int, num_slots: int, p: FineProblem) -> int:
    """The slots an aligned shard's trips walk: its ``live`` leading slots
    rounded up to a power of two (so a bucket captures at most
    ``log2(slots) + 1`` trip graphs), or all of them when the vertex rows
    or the undirected lanes do not split into the slots."""
    if not live or p.n % num_slots or int(p.ucolidx.shape[0]) % num_slots:
        return num_slots
    return min(num_slots, 1 << (live - 1).bit_length())


# The FineProblem fields indexed by vertex row and by undirected lane; the
# others by directed lane.  And the PeelState fields indexed by lane; the
# others by slot, but for the scalar total_iters.
_ROW_FIELDS = frozenset({"rowptr", "deg", "urowptr", "udeg"})
_ULANE_FIELDS = frozenset({"ucolidx", "u2d", "uedge_row"})
_LANE_FIELDS = frozenset({"alive", "support", "trussness"})


def _slot_prefix(args: tuple, st: PeelState, width: int) -> tuple[tuple, PeelState]:
    """A shard's peel inputs and starting state cut to their first
    ``width`` slots of the aligned layout, which are the aligned pack of
    those slots: slot ``s`` owns the directed lanes ``[s, s+1) * slot_nnz``,
    the undirected lanes ``[2s, 2s+2) * slot_nnz`` and the vertex rows
    ``[s * slot_n, (s+1) * slot_n]``, so every field is a leading slice
    and nothing is renumbered (the undirected pad's ``u2d``, the whole
    pack's ``nnz_pad``, stays past the cut one)."""
    p, slot_ids, k0, single_level, alive0, frozen, frozen_truss = args
    num_slots = int(k0.shape[0])
    lanes = p.nnz_pad // num_slots * width
    ulanes = int(p.ucolidx.shape[0]) // num_slots * width
    rows = p.n // num_slots * width + 1
    cut = FineProblem(*(
        t[:rows if f in _ROW_FIELDS else ulanes if f in _ULANE_FIELDS else lanes]
        for f, t in zip(FineProblem._fields, p)
    ))
    args = (cut, slot_ids[:lanes], k0[:width], single_level[:width], alive0[:lanes],
            frozen[:lanes], frozen_truss[:lanes])
    st = PeelState(*(
        t if f == "total_iters" else t[:lanes if f in _LANE_FIELDS else width]
        for f, t in zip(PeelState._fields, st)
    ))
    return args, st


def _widened(start: PeelState, part: PeelState) -> PeelState:
    """A new state: ``part``'s fields over the leading lanes and slots of
    ``start``'s, whose rest they keep (a done slot is a fixed point)."""
    return PeelState(*(
        b.clone() if f == "total_iters" else torch.cat([b, a[b.shape[0]:]])
        for f, a, b in zip(PeelState._fields, start, part)
    ))


def init_peel_state(
    p: FineProblem,
    slot_ids: torch.Tensor,
    k0: torch.Tensor,
    single_level: torch.Tensor,
    alive0: torch.Tensor,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
    *,
    sums: _SlotSums | None = None,
) -> PeelState:
    """The peel's starting carry.  Frozen lanes carry their known
    trussness straight through to the output; free lanes start at the
    vacuous floor.  ``p`` and ``single_level`` are taken in the
    reference's positions and not used.  ``sums`` is the peel's per-slot
    summer; by default one for any slot ids (sorted) is built."""
    num_slots = int(k0.shape[0])
    lanes = slot_ids.long()
    if sums is None:
        sums = _SlotSums(slot_ids, num_slots, aligned=False)
    edges0 = sums(alive0)
    return PeelState(
        alive=alive0,
        support=torch.zeros_like(alive0, dtype=torch.int32),
        trussness=torch.where(
            frozen,
            frozen_truss,
            (k0 - 1).clamp(min=2)[lanes] * alive0.to(torch.int32),
        ),
        cur_k=k0,
        kmax=torch.zeros_like(k0),
        levels=torch.zeros_like(k0),
        iters=torch.zeros_like(k0),
        done=edges0 == 0,
        total_iters=torch.zeros((), dtype=torch.int32, device=k0.device),
        edges_alive=edges0,
    )


def _peel_step(
    support: SupportFn,
    p: FineProblem,
    lanes: torch.Tensor,
    sums: _SlotSums,
    single_level: torch.Tensor,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
    st: PeelState,
) -> PeelState:
    """One trip: support, prune, per-slot convergence and level bookkeeping."""
    lane_k = st.cur_k[lanes]
    lane_done = st.done[lanes]
    # Frozen lanes participate in supports exactly while the slot's
    # threshold is inside their truss: at level k the from-scratch k-truss
    # contains a frozen edge iff its trussness >= k.
    eff_alive = st.alive | (frozen & (frozen_truss >= lane_k))
    # A done slot is a fixed point: its last trip computed s on exactly its
    # final effective alive set, retiring did not advance cur_k (so its
    # frozen-live set is unchanged), and st.support holds that s on its
    # alive lanes (0 elsewhere, where every output masks s out).  So the
    # support function gets only the live slots' lanes, and a done slot's s
    # is its st.support: every field stays what recomputing it would give.
    s = torch.where(lane_done, st.support, support(p, eff_alive & ~lane_done))
    new_alive = st.alive & (s >= lane_k - 2)
    changed = sums(new_alive ^ st.alive)
    converged = (changed == 0) & ~st.done
    trussness = torch.where(converged[lanes] & new_alive, lane_k, st.trussness)
    left = sums(new_alive)
    nonempty = left > 0
    retired = converged & (~nonempty | single_level)
    cur_k = torch.where(converged & ~retired, st.cur_k + 1, st.cur_k)
    # Prune-ahead: slots that just advanced re-prune against their new
    # threshold using the support already in hand (the free mask is
    # unchanged, so s IS the next level's first support; with frozen lanes
    # s only over-counts, so every ahead-pruned edge would be pruned by the
    # next level's first true support anyway).  Retired/done slots see
    # their old threshold: idempotent.
    new_alive = new_alive & (s >= (cur_k - 2)[lanes])
    return PeelState(
        alive=new_alive,
        support=s * new_alive.to(s.dtype),
        trussness=trussness,
        cur_k=cur_k,
        kmax=torch.where(converged & nonempty, st.cur_k, st.kmax),
        levels=st.levels + converged.to(torch.int32),
        iters=st.iters + (~st.done).to(torch.int32),
        done=st.done | retired,
        total_iters=st.total_iters + 1,
        # Live slots track their current level's alive-edge count; a
        # retired slot freezes at its final level (peel telemetry).
        edges_alive=torch.where(st.done, st.edges_alive, left),
    )


def trip_cap(max_iters: int | None, p: FineProblem, alive0: torch.Tensor) -> int:
    """The peel's trip cap: ``max_iters``, or the provable bound
    ``nnz_pad + n + 4`` of the whole (unsharded) problem (see
    :func:`build_peel`)."""
    return int(alive0.shape[0]) + p.n + 4 if max_iters is None else int(max_iters)


def _trip_pred(st: PeelState, limit: int) -> torch.Tensor:
    """() bool on the state's device: the reference's loop condition."""
    return (~st.done).any() & (st.total_iters < limit)


class _EagerTrips:
    """A shard's trip loop off CUDA, its condition read on the host each
    trip (free on the CPU).  Each trip adds the lanes of the mask its
    support is given to the int64 ``support_lanes``."""

    def __init__(self, support: SupportFn, step: tuple, st: PeelState, limit: int):
        self.support, self.step, self.st, self.limit = support, step, st, limit
        dev = st.alive.device
        # Support passes counted on the device: none here, where every
        # launch counts itself.
        self.passes = torch.zeros((), dtype=torch.int32, device=dev)
        self.support_lanes = torch.zeros((), dtype=torch.int64, device=dev)
        self.support_claims = None  # the kernel's claims are counted on the card only

    def run(self) -> None:
        while bool(_trip_pred(self.st, self.limit)):
            self.st = _peel_step(self._counted_support, *self.step, self.st)

    def _counted_support(self, p: FineProblem, alive: torch.Tensor) -> torch.Tensor:
        self.support_lanes.add_(alive.sum())
        return self.support(p, alive)

    def ran(self, passes: int) -> None:
        """Every launch of an eager trip counted itself."""


class _TripGraph:
    """A shard's trip loop captured as one CUDA graph, for one shape,
    layout, cap and device.

    The graph reads static buffers: the problem's fields, the lanes' slot
    ids, ``single_level``, ``frozen``, ``frozen_truss``, the per-slot
    summer's index tensors (contig layout) and the carried
    :class:`PeelState`; :meth:`load` copies a dispatch's inputs and
    starting state into them.  One trip is the body of a WHILE node
    (``repro_torch.kernels.graph_while``) whose condition, :func:`_trip_pred`
    of the static state, the device computes; the body writes its new
    state back into the static state, which the next condition reads.  The
    body's temporaries are static in the graph and reused every trip.

    Before the capture, the loop is captured into a graph that is thrown
    away (relaxed mode, nothing runs): the warm-up that loads every kernel
    the trip launches outside the real capture without changing any
    buffer.  The support function runs only at capture, so it must be
    pure tensor ops on its inputs.  A ``support_fine_cuda`` pass in the
    body adds one to the graph's device counter ``passes`` each time it
    runs, the lanes its worklist listed to the int64 ``support_lanes``
    (a count the kernel has already made: a reduction of the pass's mask
    would cost a tenth of a trip) and the global claims and reservations
    its launches made to the int64 ``support_claims``; :meth:`ran` adds
    what a replay counted to its ``launches``, and :meth:`load` zeroes the
    counters.
    """

    def __init__(self, support: SupportFn, step: tuple, st: PeelState, limit: int):
        p, lanes, sums, single_level, frozen, frozen_truss = step
        self.support, self.limit = support, limit
        self.p = FineProblem(*(torch.empty_like(t) for t in p))
        self.lanes = torch.empty_like(lanes)
        self.sums = copy.copy(sums)
        if sums.order is not None:
            self.sums.order, self.sums.last, self.sums.nonempty = (
                torch.empty_like(t) for t in sums.tensors()
            )
        self.single_level = torch.empty_like(single_level)
        self.frozen = torch.empty_like(frozen)
        self.frozen_truss = torch.empty_like(frozen_truss)
        self.st = PeelState(*(torch.empty_like(t) for t in st))
        dev = st.alive.device
        self.passes = torch.zeros((), dtype=torch.int32, device=dev)
        self.support_lanes = torch.zeros((), dtype=torch.int64, device=dev)
        self.support_claims = torch.zeros((), dtype=torch.int64, device=dev)
        self.events = EventPair(dev)  # each replay's timing pair
        self.load(step, st)
        self.graph = torch.cuda.CUDAGraph()
        self.side = torch.cuda.Stream(dev)  # the capture's stream
        self.body = torch.cuda.Stream(dev)  # the WHILE body's
        self.pool = torch.cuda.MemPool()  # the WHILE body's allocations
        weakref.finalize(self, _RETIRED.append, (self.graph, self.pool))
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            self._record(torch.cuda.CUDAGraph(), "relaxed")  # the warm-up, thrown away
            self._record(self.graph, "thread_local")
        record_event(PEEL_CAPTURE, device=str(dev), seconds=time.perf_counter() - t0)

    def _record(self, graph, mode: str) -> None:
        from ..kernels.graph_while import while_loop  # lazy: CUDA only
        from ..kernels.support_fine import count_launches_on_device

        self.side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.side):
            graph.capture_begin(capture_error_mode=mode)
            try:
                with count_launches_on_device(
                    self.passes, lanes=self.support_lanes, claims=self.support_claims
                ):
                    while_loop(
                        lambda: _trip_pred(self.st, self.limit), self._trip, self.body,
                        self.pool, mode,
                    )
            except BaseException:
                with contextlib.suppress(Exception):  # the trip's own error is the one to report
                    graph.capture_end()
                raise
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(self.side)

    def _trip(self) -> None:
        new = _peel_step(
            self.support, self.p, self.lanes, self.sums,
            self.single_level, self.frozen, self.frozen_truss, self.st,
        )
        for dst, src in zip(self.st, new):
            dst.copy_(src)

    def load(self, step: tuple, st: PeelState) -> None:
        """Copy one dispatch's inputs and starting state into the buffers
        (the ``trip-load`` span)."""
        p, lanes, sums, single_level, frozen, frozen_truss = step
        pairs = [
            *zip(self.p, p), *zip(self.sums.tensors(), sums.tensors()), *zip(self.st, st),
            (self.lanes, lanes), (self.single_level, single_level),
            (self.frozen, frozen), (self.frozen_truss, frozen_truss),
        ]
        with current_tracer().span("trip-load"):
            for dst, src in pairs:
                dst.copy_(src)
            self.passes.zero_()
            self.support_lanes.zero_()
            self.support_claims.zero_()

    def run(self) -> None:
        from ..kernels.graph_while import GRAPH_SITE  # lazy: CUDA only

        try:
            with torch.cuda.device(self.st.alive.device):
                self.events.start()
                self.graph.replay()
                self.events.stop()
        except RuntimeError as e:
            raise DeviceError(
                f"replaying the peel's trip graph failed: {e}", site=GRAPH_SITE, cause=e
            ) from e

    def ran(self, passes: int) -> None:
        """Add the support passes the replay counted on the device, and the
        replay's device seconds (the loop's exit has been read back)."""
        from ..kernels.support_fine import support_fine_cuda  # lazy: CUDA only

        support_fine_cuda.launches += passes
        add_device_seconds(self.events.seconds())


class _Peel:
    """The peel callable :func:`build_peel` returns (see there)."""

    def __init__(self, support: SupportFn, max_iters: int | None):
        self.support = support
        self.max_iters = max_iters
        self.host_syncs = 0  # device->host readbacks of the loop condition and layout
        # One dispatch at a time: a CUDA shard replays a graph whose static
        # buffers hold that dispatch's inputs and state.
        self._lock = threading.Lock()
        self._graphs: dict[tuple, _TripGraph] = {}  # guarded-by: _lock

    def __call__(
        self,
        p: FineProblem,
        slot_ids: torch.Tensor,
        k0: torch.Tensor,
        single_level: torch.Tensor,
        alive0: torch.Tensor,
        frozen: torch.Tensor,
        frozen_truss: torch.Tensor,
        *,
        span_attrs: dict | None = None,
    ) -> PeelState:
        # The unsharded peel is the lock step of one shard.
        args = (p, slot_ids, k0, single_level, alive0, frozen, frozen_truss)
        return self.lock_step(
            [args], trip_cap(self.max_iters, p, alive0), span_attrs=span_attrs
        )[0]

    def lock_step(self, shards, limit: int, *, span_attrs: dict | None = None) -> list[PeelState]:
        """Peel every shard's inputs (``shard_peel_args``' sets) in lock step.

        Each shard first reads back whether any of its lanes is alive,
        whether its slot ids are the aligned layout (its :class:`_SlotSums`)
        and how many leading slots hold its alive lanes.  An aligned shard
        then peels only those slots, rounded up to a power of two
        (:func:`_walked_slots`, :func:`_slot_prefix`), and the rest keep
        their starting state: no lane of theirs is alive, so they are done
        before the first trip, and a done slot is a fixed point.  Then
        every live shard runs its trip loop (a replay of its graph on
        CUDA), and after all are started each one's exit condition is read
        back: every slot done, or ``limit`` trips (the unsharded peel's
        cap).  A shard stops at its own last trip: a done slot is a fixed
        point of the step (see :func:`_peel_step`), so leaving a finished
        shard alone gives every per-slot field the value the unsharded
        loop would, and each shard's ``total_iters`` is its own trip
        count.  Launches go to each shard's device on its current stream:
        shards on different devices overlap, shards on one device run one
        after another.  The exit's readback also brings each loop's support
        passes and support lanes: ``peel_trips``, ``peel_support_passes``
        and ``peel_support_lanes`` add them, ``peel_trip_lanes_walked`` the
        trips times the lanes of the slots they walked,
        ``peel_support_claims`` (a trip graph's alone) the support kernel's
        global claims and reservations, and ``span_attrs``
        (the ``dispatch`` span's, while tracing) gets the live shards'
        ``trips`` and ``support_lanes``, their live slots (``members``: an
        aligned shard's live prefix, every slot of another) and the slots
        they walked (``walked_slots``), each summed over the shards."""
        if _CAPTURE_LOCK.acquire(blocking=False):  # no capture is underway
            try:
                _release_retired()
            finally:
                _CAPTURE_LOCK.release()
        with self._lock:
            runs, starts, live = [], [], []
            members = walked = 0  # the live shards' live and walked slots
            for j, args in enumerate(shards):
                p, slot_ids, k0, single_level, alive0, frozen, frozen_truss = args
                num_slots = int(k0.shape[0])
                self.host_syncs += 1
                # The first loop condition, the layout and the live slots:
                # one readback a shard.
                any_alive, aligned, live_slots = torch.stack(  # trusslint: disable=R1
                    [alive0.any().long(), _is_aligned(slot_ids, num_slots).long(),
                     _live_slots(alive0, num_slots)]
                ).tolist()
                aligned = bool(aligned)
                sums = _SlotSums(slot_ids, num_slots, aligned=aligned)
                start = init_peel_state(
                    p, slot_ids, k0, single_level, alive0, frozen, frozen_truss, sums=sums
                )
                starts.append(start)
                width = _walked_slots(live_slots, num_slots, p) if aligned else num_slots
                st = start
                if width < num_slots:
                    # Every slot past the live ones is done at the start and
                    # keeps its starting state: peel the leading ones alone.
                    args, st = _slot_prefix(args, start, width)
                    p, slot_ids, k0, single_level, alive0, frozen, frozen_truss = args
                    sums = _SlotSums(slot_ids, width, aligned=True)
                step = (p, slot_ids.long(), sums, single_level, frozen, frozen_truss)
                if any_alive and limit > 0 and alive0.is_cuda:
                    runs.append(self._graph(j, args, aligned, limit, step, st))
                else:
                    runs.append(_EagerTrips(self.support, step, st, limit))
                if any_alive and limit > 0:
                    live.append(j)
                    members += live_slots if aligned else num_slots
                    walked += width
            for j in live:
                runs[j].run()
            registry = current_registry()
            total_trips = total_lanes = 0
            for j in live:
                run = runs[j]
                self.host_syncs += 1
                # The loop's exit, with the support passes, lanes and claims
                # the device counted: one readback per live shard.
                counted = [run.st.done.all().to(torch.int64), run.st.total_iters.to(torch.int64),
                           run.passes.to(torch.int64), run.support_lanes]
                if run.support_claims is not None:
                    counted.append(run.support_claims)
                all_done, trips, passes, lanes, *claims = torch.stack(  # trusslint: disable=R1
                    counted
                ).tolist()
                if not all_done and trips < limit:
                    from ..kernels.graph_while import GRAPH_SITE

                    raise DeviceError(
                        f"the peel's trip loop stopped after {trips} of {limit} trips with "
                        "slots unfinished", site=GRAPH_SITE,
                    )
                run.ran(passes)
                registry.inc(PEEL_TRIPS, trips)
                registry.inc(PEEL_SUPPORT_PASSES, passes)
                registry.inc(PEEL_SUPPORT_LANES, lanes)
                if claims:
                    registry.inc(PEEL_SUPPORT_CLAIMS, claims[0])
                registry.inc(PEEL_TRIP_LANES_WALKED, trips * int(run.st.alive.shape[0]))
                total_trips += trips
                total_lanes += lanes
            if span_attrs is not None and live:
                span_attrs.update(trips=total_trips, support_lanes=total_lanes,
                                  members=members, walked_slots=walked)
            # New tensors: a later dispatch overwrites a trip graph's state.
            return [_widened(start, run.st) for start, run in zip(starts, runs)]

    def _graph(self, j, args, aligned, limit, step, st) -> _TripGraph:  # requires-lock: _lock
        """Shard ``j``'s trip graph for these inputs' shapes, captured on
        first use, loaded with ``step`` and ``st``."""
        key = (j, aligned, limit, str(st.alive.device)) + tuple(
            (tuple(t.shape), t.dtype) for t in (*args[0], *args[1:])
        )
        graph = self._graphs.get(key)
        if graph is not None:
            graph.load(step, st)
            return graph
        from ..kernels.graph_while import GRAPH_SITE  # lazy: CUDA only

        try:
            with _CAPTURE_LOCK:
                _release_retired()
                graph = _TripGraph(self.support, step, st, limit)
        except TrussError:
            raise  # a kernel's own typed failure at capture
        except Exception as e:
            raise DeviceError(
                f"capturing the peel's trips as a CUDA graph failed: {e}",
                site=GRAPH_SITE,
                oom=isinstance(e, torch.OutOfMemoryError),
                cause=e,
            ) from e
        self._graphs[key] = graph
        return graph


def build_peel(support: SupportFn, *, max_iters: int | None = None) -> _Peel:
    """Build the full level peel for one support function.

    The returned callable has signature

        peel(p, slot_ids, k0, single_level, alive0, frozen, frozen_truss) -> PeelState

    where ``slot_ids`` maps every edge lane to its packed slot, ``k0`` is
    each slot's starting k, and ``single_level`` marks slots that stop at
    their first fixed point (the ``ktruss(k)`` workload) instead of
    peeling on.  ``frozen`` marks lanes whose trussness is already known
    (``frozen_truss``): they are never pruned or re-ranked, but count as
    alive for support exactly while the slot's threshold is within their
    truss (``frozen_truss >= cur_k``).  ``alive0`` and ``frozen`` must be
    disjoint.  ``max_iters`` caps total trips across all levels; ``None``
    uses ``nnz_pad + n + 4``, a provable upper bound (every trip each
    active slot either prunes ≥ 1 edge or converges a level), so an
    uncapped peel is never truncated.  An explicit cap that fires raises
    in :meth:`PeelExecutor.peel` rather than returning a truncated state.

    On CUDA the trips run as a captured graph (see the module docstring):
    ``support`` is called only while the graph is captured, so it must be
    pure tensor ops on its arguments, with no readback and no host state
    that changes between calls; the graph replays what it launched then.
    """
    return _Peel(support, max_iters)


# The slots of the level-counts vector (``kernels.peel_fused.LevelCounts``)
# a dispatch files, with their counters; ``alive_lanes`` goes to the trace
# alone.
_FILED_LEVEL_COUNTS = (
    ("update_trips", PEEL_LEVEL_TRIPS_INCREMENTAL),
    ("counted_lanes", PEEL_LEVEL_LANES_COUNTED),
    ("carried", PEEL_LEVEL_TRIPS_CARRIED),
    ("walked_lanes", PEEL_LEVEL_LANES_WALKED),
)


class _FusedPeel:
    """The peel callable :func:`build_fused_peel` returns (see there)."""

    def __init__(self, level_step, max_iters: int | None):
        self.level_step = level_step
        self.max_iters = max_iters
        self.host_syncs = 0  # device->host readbacks, one per level

    def __call__(
        self,
        p: FineProblem,
        slot_ids: torch.Tensor,
        k0: torch.Tensor,
        single_level: torch.Tensor,
        alive0: torch.Tensor,
        frozen: torch.Tensor,
        frozen_truss: torch.Tensor,
    ) -> PeelState:
        from ..kernels.peel_fused import LevelCounts  # lazy: exec stays dep-light

        num_slots = int(k0.shape[0])
        limit = trip_cap(self.max_iters, p, alive0)
        st = init_peel_state(p, slot_ids, k0, single_level, alive0, frozen, frozen_truss)
        tracer = current_tracer()
        registry = current_registry()
        events = EventPair(alive0.device) if alive0.is_cuda else None  # reused each level
        counts = LevelCounts.zeros(alive0.device)  # every launch adds its counts here
        # What the last launch of this call hands the next: none to the first.
        carry = None
        # The state the launch before last returned, which the next launch
        # writes into: none to the first two (the first state's alive is the
        # caller's alive0), then the call's two states in turns.
        spare = None
        level, device_s = 0, 0.0
        before = None  # total_iters and the counts before the last launch
        while True:
            self.host_syncs += 1
            # One readback per level (as int64): the loop condition, the cap
            # check and the level counts so far.
            all_done, *now = torch.cat(  # trusslint: disable=R1
                [st.done.all().reshape(1), st.total_iters.reshape(1), counts]
            ).tolist()
            trips = now[0]
            if level:  # the last launch has ended: read its events
                seconds = None
                if events is not None:
                    seconds = events.seconds()
                    device_s += seconds
                if tracer.enabled:
                    step_trips, *step = (a - b for a, b in zip(now, before))
                    attrs = {"level": level - 1, "trips": step_trips}
                    attrs.update(LevelCounts(*step)._asdict())
                    if seconds is not None:
                        attrs["device_ms"] = 1e3 * seconds
                    tracer.instant("peel-level.done", **attrs)
            if all_done or trips >= limit:
                break  # a fired cap: the executor's all-done belt raises
            with tracer.span("peel-level", level=level, slots=num_slots):
                nxt, carry = self.level_step(
                    p, st, frozen, frozen_truss, single_level, carry=carry, state_out=spare,
                    events=events, level_counts=counts,
                )
            spare, st = (st if level else None), nxt
            registry.inc("peel_fused_levels")
            before = now
            level += 1
        if level:  # once a dispatch: trips (total_iters starts at 0), counts, device time
            registry.inc(PEEL_LEVEL_TRIPS, trips)
            totals = LevelCounts(*now[1:])
            for slot, name in _FILED_LEVEL_COUNTS:
                registry.inc(name, getattr(totals, slot))
            if events is not None:
                registry.inc(PEEL_LEVEL_DEVICE_SECONDS, device_s)
                add_device_seconds(device_s)
        return st


def build_fused_peel(
    *,
    window: int,
    block: int = 128,
    schedule: str = "bsearch",
    max_iters: int | None = None,
) -> _FusedPeel:
    """Host-driven fused peel: one fused-kernel launch per level.

    Same signature and bit-identical results as :func:`build_peel`'s
    callable (except ``total_iters``, which counts the kernel's inner
    trips), but the support→prune fixed point of each level runs inside
    one launch (``repro_torch.kernels.peel_fused.make_fused_level``), and
    the host loop steps levels — one ``"peel-level"`` span and one
    ``peel_fused_levels`` tick per launch, and one readback per level
    (``host_syncs``).  After that readback the last launch's two timing
    events are read on CUDA.  Every level step is handed the call's one
    level-counts vector (``repro_torch.kernels.peel_fused.LevelCounts``),
    adds its counts to it, and the same readback brings it back.  While
    tracing, a ``"peel-level.done"`` instant event carries the level, its
    inner trips (the step in ``total_iters``), the step in each of the
    vector's counts under the count's name (``update_trips``,
    ``counted_lanes``, ``carried``, ``alive_lanes``, ``walked_lanes``) and,
    on CUDA, its device ms.  Each level step is handed the carry the last
    step of the same call returned (none to the call's first), and returns
    its own; and, as ``state_out``, the state the step before last returned
    (none to the call's first two), so the call's launches write into two
    states in turns and never into the first, whose ``alive`` is
    ``alive0``.  Once a dispatch, ``peel_level_trips`` adds the loop's
    trips, the counters of ``_FILED_LEVEL_COUNTS`` the counts' totals
    (``peel_level_trips_incremental``, ``peel_level_lanes_counted``,
    ``peel_level_trips_carried``, ``peel_level_lanes_walked``) and, on CUDA,
    ``peel_level_device_seconds`` its launches' event time, which is also
    the dispatch's device time.  A fired iteration cap returns the un-done
    state;
    :meth:`PeelExecutor.peel`'s all-done belt raises the typed
    ``DeviceError`` exactly as on the unfused path.
    """
    from ..kernels.peel_fused import make_fused_level  # lazy: exec stays dep-light

    return _FusedPeel(
        make_fused_level(window=window, block=block, schedule=schedule), max_iters
    )


class PeelExecutor:
    """Unified executor for every multi-level K-truss workload.

    One instance owns one peel (one support configuration) and serves
    ``ktruss`` / ``kmax`` / ``decompose`` for any problem matching its
    shapes — a single graph (one slot) or a packed batch.

    ``backend="fused"`` runs the fused level kernel through
    :func:`build_fused_peel`, tuned by ``fused_config``
    (``repro_torch.kernels.autotune.FusedConfig``; default the stock
    config), and validates each pack's tiling before dispatch.

    With ``mesh=`` (``repro_torch.distributed.slot_mesh``) the packed slot
    blocks are split across the mesh's devices before dispatch
    (``shard_peel_args``), peeled in lock step, and their states
    concatenated in slot order on the problem's device.  The fused backend
    keeps its state kernel-resident and refuses a mesh, as the reference's
    does.

    ``dispatches`` counts :meth:`peel` calls (one per packed batch,
    however many shards); ``host_syncs`` counts the device→host readbacks
    they made, every shard's.
    """

    def __init__(
        self,
        *,
        granularity: str = "fine",
        mode: str = "eager",
        backend: str = "xla",
        window: int | None = None,
        chunk: int = 256,
        row_chunk: int = 32,
        max_iters: int | None = None,
        mesh=None,
        support: SupportFn | None = None,
        fused_config=None,
    ):
        self.backend = backend
        self.fused_config = None
        self.dispatches = 0
        self._belt_syncs = 0
        if backend == "fused":
            if mesh is not None:
                raise ValueError(
                    "the fused backend keeps peel state kernel-resident and "
                    "does not shard; use fine/pallas/aligned under a mesh"
                )
            if granularity != "fine":
                raise ValueError("fused backend implements the fine granularity")
            if window is None:
                raise ValueError("window is required for the fused backend")
            from ..kernels.autotune import FusedConfig  # lazy: exec stays dep-light

            cfg = fused_config if fused_config is not None else FusedConfig()
            self.fused_config = cfg
            self.support = None
            self.mesh = None
            self._peel = build_fused_peel(
                window=window, block=cfg.block, schedule=cfg.schedule, max_iters=max_iters
            )
            return
        if support is None:
            if window is None:
                raise ValueError("window is required unless support= is given")
            support = make_problem_support(
                granularity=granularity,
                mode=mode,
                backend=backend,
                window=window,
                chunk=chunk,
                row_chunk=row_chunk,
            )
        self.support = support
        self.mesh = mesh
        self._peel = build_peel(support, max_iters=max_iters)

    @property
    def host_syncs(self) -> int:
        return self._peel.host_syncs + self._belt_syncs

    def peel(
        self,
        p: FineProblem,
        *,
        slot_ids,
        k0: Sequence[int] | np.ndarray,
        single_level: Sequence[bool] | np.ndarray | None = None,
        alive0: torch.Tensor | None = None,
        frozen: torch.Tensor | None = None,
        frozen_truss: torch.Tensor | None = None,
    ) -> PeelState:
        """Run the whole peel for one packed problem in one dispatch.

        ``frozen``/``frozen_truss`` mark lanes whose trussness is already
        known (see :func:`build_peel`); callers must keep ``alive0`` and
        ``frozen`` disjoint.  Defaults (all-free) reproduce the plain
        from-scratch peel bit-for-bit.  Host inputs (numpy or sequences)
        are moved to the problem's device.
        """
        dev = p.device
        k0 = torch.as_tensor(np.asarray(k0, dtype=np.int32), device=dev)
        num_slots = int(k0.shape[0])
        if single_level is None:
            single_level = np.zeros(num_slots, dtype=bool)
        single_level = torch.as_tensor(np.asarray(single_level, dtype=bool), device=dev)
        if not torch.is_tensor(slot_ids):
            slot_ids = torch.as_tensor(np.asarray(slot_ids, dtype=np.int32))
        slot_ids = slot_ids.to(device=dev, dtype=torch.int32)
        if alive0 is None:
            alive0 = p.colidx != 0
        if frozen is None:
            frozen = torch.zeros(alive0.shape, dtype=torch.bool, device=dev)
        if frozen_truss is None:
            frozen_truss = torch.zeros(alive0.shape, dtype=torch.int32, device=dev)
        if self.backend == "fused":
            # The kernel tiles lanes by `block` and reduces per slot over
            # slot bands: refuse mis-tiled packs loudly (typed,
            # slot-attributed) instead of mixing members.  Reads the pack's
            # row arrays back once.
            from ..graphs.pack import validate_fused_tiling

            self._belt_syncs += 1
            validate_fused_tiling(p, slots=num_slots, block=self.fused_config.block)
        self.dispatches += 1
        current_registry().inc("peel_dispatches")
        tracer = current_tracer()
        # "dispatch" covers every trip: the loop reads the done flags back
        # when it has ended (the fused loop after every level), so the
        # span ends when the device has finished.  The unfused loop puts
        # its trips, support lanes, live slots and walked slots on it.
        with tracer.span("dispatch", slots=num_slots) as span:
            if self.mesh is None:
                kw = {} if self.backend == "fused" else {"span_attrs": span.attrs}
                st = self._peel(p, slot_ids, k0, single_level, alive0, frozen, frozen_truss, **kw)
            else:
                st = self._peel_sharded(
                    p, slot_ids, k0, single_level, alive0, frozen, frozen_truss,
                    span_attrs=span.attrs,
                )
        # Belt: the iteration cap is provably unreachable (see build_peel),
        # so an un-done slot means a peel bug — fail loudly rather than
        # letting callers read back a truncated state as final.
        with tracer.span("device-wait"):
            self._belt_syncs += 1
            # The belt: one readback per dispatch, after the loop's own.
            all_done = bool(st.done.all())  # trusslint: disable=R1
        if not all_done:
            raise DeviceError(
                f"peel hit the iteration cap after {int(st.total_iters)} "
                f"trips with slots unfinished: done={st.done.cpu().numpy()}",
                site="peel",
            )
        return st

    def _peel_sharded(
        self, p, slot_ids, k0, single_level, alive0, frozen, frozen_truss, *, span_attrs=None
    ) -> PeelState:
        """The mesh path of :meth:`peel`: split, lock step, concatenate."""
        from ..distributed.ktruss import shard_peel_args  # lazy: exec stays dep-light

        shards = shard_peel_args(
            self.mesh, p, slot_ids, k0, single_level, alive0, frozen, frozen_truss
        )
        self._belt_syncs += len(shards)  # shard_peel_args' alignment check
        states = self._peel.lock_step(
            shards, trip_cap(self._peel.max_iters, p, alive0), span_attrs=span_attrs
        )
        dev = p.device

        def joined(field):
            return [getattr(s, field).to(dev) for s in states]

        return PeelState(
            **{f: torch.cat(joined(f)) for f in PeelState._fields if f != "total_iters"},
            total_iters=torch.stack(joined("total_iters")).max(),
        )

