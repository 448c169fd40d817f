"""Device-resident level peeling: a whole truss decomposition per dispatch.

The torch counterpart of ``repro.exec.peel``.  :func:`build_peel` returns a
peel whose every trip runs a support computation, prunes each lane
against its packed slot's current threshold, and — for every slot whose
alive mask just reached a fixed point — records the surviving edges'
trussness at ``cur_k``, bumps the slot's kmax/level counters, and advances
its threshold to ``cur_k + 1`` (or retires the slot when its level
emptied, or at once for single-level ``ktruss(k)`` members).

The reference runs the trips inside one ``lax.while_loop``; here they are
a Python loop of device operations.  Its one device→host readback per
trip is the ``done.all()`` test of the loop condition; the executor counts
every readback in ``host_syncs``.  A **dispatch** is one
:meth:`PeelExecutor.peel` call: one packed batch peeled to completion,
however many trips and readbacks it takes.  ``total_iters`` counts trips
exactly as the reference's loop counter does.

Slots are the block-diagonal members of ``repro_torch.graphs.pack``;
because the packing is a disjoint union, each slot's fixed point is
independent and a per-slot convergence test (a segment sum of changed
lanes) is exact.  Mesh placement and the fused level kernel are not
ported yet.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..core.eager_coarse import support_coarse_eager
from ..core.eager_fine import FineProblem, support_fine_eager, support_fine_owner
from ..errors import DeviceError
from ..obs import current_registry, current_tracer

__all__ = [
    "PeelState",
    "make_problem_support",
    "init_peel_state",
    "build_peel",
    "PeelExecutor",
]

SupportFn = Callable[[FineProblem, torch.Tensor], torch.Tensor]


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
) -> SupportFn:
    """Problem-polymorphic ``(problem, alive) -> support`` for one config.

    ``backend="pallas"`` is the kernel axis: it runs
    :func:`repro_torch.kernels.ops.support_fine`, which launches the
    hand-written CUDA kernel on CUDA tensors.  ``"xla"`` is the torch-ops
    twin axis (the name keeps the reference's spelling).
    """
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
        return functools.partial(support_coarse_eager, window=window)
    if granularity != "fine":
        raise ValueError(f"unknown granularity {granularity!r}")
    if mode == "eager":
        return functools.partial(support_fine_eager, window=window, chunk=chunk)
    if mode == "owner":
        return functools.partial(support_fine_owner, window=window, chunk=chunk)
    raise ValueError(f"unknown mode {mode!r}")


def _segment_sum(x: torch.Tensor, slot_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """Per-slot int32 sums of ``x`` (``slot_ids`` int64; exact on any device)."""
    out = torch.zeros(num_slots, dtype=torch.int32, device=x.device)
    return out.index_add_(0, slot_ids, x.to(torch.int32))


def init_peel_state(
    slot_ids: torch.Tensor,
    k0: torch.Tensor,
    alive0: torch.Tensor,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
) -> PeelState:
    """The peel's starting carry.  Frozen lanes carry their known
    trussness straight through to the output; free lanes start at the
    vacuous floor."""
    num_slots = int(k0.shape[0])
    lanes = slot_ids.long()
    edges0 = _segment_sum(alive0, lanes, num_slots)
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
    single_level: torch.Tensor,
    frozen: torch.Tensor,
    frozen_truss: torch.Tensor,
    st: PeelState,
) -> PeelState:
    """One trip: support, prune, per-slot convergence and level bookkeeping."""
    num_slots = int(st.cur_k.shape[0])
    lane_k = st.cur_k[lanes]
    # Frozen lanes participate in supports exactly while the slot's
    # threshold is inside their truss: at level k the from-scratch k-truss
    # contains a frozen edge iff its trussness >= k.
    eff_alive = st.alive | (frozen & (frozen_truss >= lane_k))
    s = support(p, eff_alive)
    new_alive = st.alive & (s >= lane_k - 2)
    changed = _segment_sum(new_alive ^ st.alive, lanes, num_slots)
    converged = (changed == 0) & ~st.done
    trussness = torch.where(converged[lanes] & new_alive, lane_k, st.trussness)
    left = _segment_sum(new_alive, lanes, num_slots)
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


class _Peel:
    """The peel callable :func:`build_peel` returns (see there)."""

    def __init__(self, support: SupportFn, max_iters: int | None):
        self.support = support
        self.max_iters = max_iters
        self.host_syncs = 0  # device->host readbacks of the loop condition

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
        limit = (
            int(alive0.shape[0]) + p.n + 4 if self.max_iters is None else int(self.max_iters)
        )
        lanes = slot_ids.long()
        st = init_peel_state(slot_ids, k0, alive0, frozen, frozen_truss)
        trips = 0
        while trips < limit:
            self.host_syncs += 1
            if bool(st.done.all()):
                break
            st = _peel_step(self.support, p, lanes, single_level, frozen, frozen_truss, st)
            trips += 1
        return st


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
    """
    return _Peel(support, max_iters)


class PeelExecutor:
    """Unified executor for every multi-level K-truss workload.

    One instance owns one peel (one support configuration) and serves
    ``ktruss`` / ``kmax`` / ``decompose`` for any problem matching its
    shapes — a single graph (one slot) or a packed batch.

    ``dispatches`` counts :meth:`peel` calls (one per packed batch);
    ``host_syncs`` counts the device→host readbacks they made.
    """

    def __init__(
        self,
        *,
        granularity: str = "fine",
        mode: str = "eager",
        backend: str = "xla",
        window: int | None = None,
        chunk: int = 256,
        max_iters: int | None = None,
        support: SupportFn | None = None,
    ):
        if support is None:
            if window is None:
                raise ValueError("window is required unless support= is given")
            support = make_problem_support(
                granularity=granularity,
                mode=mode,
                backend=backend,
                window=window,
                chunk=chunk,
            )
        self.support = support
        self._peel = build_peel(support, max_iters=max_iters)
        self.dispatches = 0
        self._belt_syncs = 0

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
        self.dispatches += 1
        current_registry().inc("peel_dispatches")
        tracer = current_tracer()
        # "dispatch" covers every trip: the loop reads the done flags back
        # each trip, so the span ends when the device has finished.
        with tracer.span("dispatch", slots=num_slots):
            st = self._peel(p, slot_ids, k0, single_level, alive0, frozen, frozen_truss)
        # Belt: the iteration cap is provably unreachable (see build_peel),
        # so an un-done slot means a peel bug — fail loudly rather than
        # letting callers read back a truncated state as final.
        with tracer.span("device-wait"):
            self._belt_syncs += 1
            all_done = bool(st.done.all())
        if not all_done:
            raise DeviceError(
                f"peel hit the iteration cap after {int(st.total_iters)} "
                f"trips with slots unfinished: done={st.done.cpu().numpy()}",
                site="peel",
            )
        return st
