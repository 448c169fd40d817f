"""Planner: lower declarative ``TrussQuery`` sets onto the device peel.

The ONE pack/cache/dispatch path every entry point shares.  Lowering one
batch:

1. **assign** — each query is canonicalized to a shape :class:`Bucket`
   and a registry :class:`BackendKey` (forced per query or per planner,
   else the imbalance-statistic auto rule of ``repro_torch.api.registry``);
2. **pack**  — same-``(bucket, backend)`` queries are packed
   block-diagonally (``repro_torch.graphs.pack``) in the backend's layout,
   straight onto the planner's device;
3. **dispatch** — the bucket's cached :class:`repro_torch.exec.PeelExecutor`
   peels every member to completion in ONE dispatch (per-slot thresholds
   advance inside the peel loop; ktruss members retire at their first
   fixed point, kmax/decompose peel to exhaustion, stream members re-peel
   only their frontier against frozen lanes);
4. **unpack** — what each member returns (its range of the arrays its
   workload reads, or a scalar) is read back, in one copy with the
   per-slot counters, into its workload's result type.

The planner is stateless about queues and futures — that is
:class:`repro_torch.api.Session`'s job.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import weakref
from typing import Any, Optional

import numpy as np
import torch

from ..core.truss import KTrussResult, TrussDecomposition
from ..device import canonical_device, resolve_device
from ..errors import DeviceError, InvalidGraphError, TrussError
from ..graphs.csr import CSRGraph, LiftedCSR, lift_csr, not_upper, upper_violation
from ..graphs.pack import pack_problems
from ..graphs.stats import ImbalanceStats, imbalance_parts, stats_from_parts
from ..obs import clock as obs_clock
from ..obs import current_registry, current_tracer, record_peel_batch
from ..obs.device_time import dispatch_device_time
from ..obs.names import PEEL_SLOTS_SHARED
from ..resilience.faults import inject
from .cache import Bucket, CompileCache, bucket_from_degree, undirected_max_degree
from .query import TrussQuery
from .registry import (
    BackendKey,
    choose_backend,
    default_kernel,
    get_backend,
    runs_hand_kernel,
)

__all__ = ["RequestStats", "GraphLift", "QueryState", "PlannedBatch", "Plan", "Planner"]

_ids = itertools.count()


@dataclasses.dataclass
class RequestStats:
    """Per-query observability (exposed on the future)."""

    queue_time_s: float = 0.0  # submit -> batch formation
    pack_time_s: float = 0.0  # host-side block-diagonal packing (shared)
    # The batch's single peel dispatch (shared): on CUDA its launches'
    # device time between CUDA events (fused levels, trip-graph replays),
    # on the CPU, where the peel runs on the host, its host wall.
    device_time_s: float = 0.0
    plan_time_s: float = 0.0  # bucket + backend assignment for THIS query
    compile_hit: bool = False  # did the batch reuse a cached executor
    bucket: Optional[Bucket] = None
    backend: Optional[BackendKey] = None
    batch_size: int = 0  # real members in the packed batch
    rounds: int = 0  # fixed-point levels THIS member peeled
    iterations: int = 0  # prune iterations while THIS member was live
    dispatch_trips: int = 0  # peel loop trips of the batch's dispatch (shared)


@dataclasses.dataclass(eq=False)
class GraphLift:
    """A query graph's CSR on the planner's device, and what ``plan`` read
    back of it: the bucket, the first row that is not strictly upper
    triangular (``low``: the row and its first column, ``(0, 0)`` when
    none) and, for the auto rule, the imbalance statistics.

    Queries on one ``CSRGraph`` object share one lift while any of them
    holds it (:class:`QueryState`'s ``lift``, dropped when its dispatch's
    unpack ends): the graph goes to the device once, ``plan`` reads back
    once, and ``pack`` copies and reads back nothing.  The caller's graph
    is not touched."""

    graph: CSRGraph
    csr: Optional[LiftedCSR] = None
    bucket: Optional[Bucket] = None
    low: tuple[int, int] = (0, 0)
    stats: Optional[ImbalanceStats] = None
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


@dataclasses.dataclass
class QueryState:
    """A submitted query with its planner assignment (queue entry)."""

    query: TrussQuery
    bucket: Bucket
    backend: BackendKey
    submitted_at: float = dataclasses.field(default_factory=obs_clock.now)
    id: int = dataclasses.field(default_factory=lambda: next(_ids))
    stats: RequestStats = dataclasses.field(default_factory=RequestStats)
    # stream_update: the member's trussness left on the planner's device by
    # the unpack, beside the host result (a stream session keeps it as
    # its committed state, so nothing is copied back to the device).
    device_result: Optional[torch.Tensor] = None
    # The query's graph on the planner's device (``Planner.assign``),
    # shared with the other pending queries on the same graph object;
    # ``None`` once the dispatch's unpack has ended.
    lift: Optional[GraphLift] = None

    @property
    def group(self) -> tuple[Bucket, BackendKey]:
        """Batchable-together key: same bucket AND same backend."""
        return (self.bucket, self.backend)

    def time_remaining(self) -> float | None:
        """Seconds left of this query's deadline budget (``None`` = no
        deadline), on the observability clock."""
        return obs_clock.remaining(self.submitted_at, self.query.deadline_s)

    # Legacy aliases (the old service Request shape) ------------------- #
    @property
    def graph(self):
        return self.query.graph

    @property
    def workload(self) -> str:
        return self.query.workload

    @property
    def k(self) -> int:
        return self.query.k


@dataclasses.dataclass
class PlannedBatch:
    """One packed dispatch: same-(bucket, backend) queries on ``slots`` slots."""

    bucket: Bucket
    backend: BackendKey
    queries: list[QueryState]
    slots: int


@dataclasses.dataclass
class Plan:
    """A lowered query set (``Planner.plan``): batches in dispatch order."""

    batches: list[PlannedBatch]
    plan_time_s: float = 0.0

    @property
    def num_queries(self) -> int:
        return sum(len(b.queries) for b in self.batches)

    @property
    def num_dispatches(self) -> int:
        return len(self.batches)


class Planner:
    """Lowers queries onto ``(bucket, backend)`` batches and executes them
    on ``device`` (``None`` = CUDA; raises when CUDA is absent).

    With ``mesh=`` (``repro_torch.distributed.slot_mesh``) each batch's
    slot blocks are split across the mesh's devices at dispatch.  The mesh
    forces the aligned layout and refuses the fused backend, as the
    reference's does.  The pack and the unpack live on the mesh's first
    device, which is the planner's ``device``: ``device=None`` takes it,
    and any other ``device=`` raises.
    """

    def __init__(
        self,
        *,
        max_batch: int = 8,
        chunk: int = 256,
        kernel: str | None = None,
        layout: str | None = None,
        backend: BackendKey | str | None = None,
        mode: str | None = None,
        max_iters: int | None = None,
        mesh=None,
        device: str | torch.device | None = None,
    ):
        if chunk & (chunk - 1):
            raise ValueError(f"chunk={chunk} must be a power of two")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.mesh = mesh
        if mesh is not None:
            if layout is not None and layout != "aligned":
                raise ValueError(
                    "mesh sharding needs layout='aligned' (slot blocks are "
                    "the shard boundaries)"
                )
            layout = "aligned"
            first = mesh.devices[0]
            # The type is compared first: making "cuda" canonical needs a card.
            if device is not None and (
                torch.device(device).type != first.type or canonical_device(device) != first
            ):
                raise ValueError(
                    f"device={device!r} is not the mesh's first device {first}: "
                    "the pack and the unpack live there"
                )
            device = first
            # The hashable fold of the mesh for the cache key: the devices
            # decide where an executor's shards run.
            self._mesh_key = (
                tuple(mesh.axis_names),
                mesh.size,
                tuple(str(d) for d in mesh.devices),
            )
        else:
            self._mesh_key = None
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.chunk = int(chunk)
        self.kernel = kernel or default_kernel(self.device)
        self.mode = mode
        # None = the peel's provable iteration bound; an explicit cap that
        # fires raises instead of returning truncated results.
        self.max_iters = None if max_iters is None else int(max_iters)
        self.layout = layout or "aligned"
        # Forced backend for every query (None = per-query auto rule).
        self.backend = get_backend(backend).key if backend is not None else None
        if mesh is not None and self.backend is not None and self.backend.layout != "aligned":
            raise ValueError(
                f"backend {self.backend} has layout={self.backend.layout!r}, "
                "but mesh sharding needs layout='aligned'"
            )
        if mesh is not None and self.backend is not None and self.backend.kernel == "fused":
            raise ValueError(
                f"backend {self.backend} keeps peel state kernel-resident "
                "and cannot shard across a mesh; use fine/pallas/aligned"
            )
        # Concurrent submitters all assign through one planner, so
        # everything mutable below is lock-guarded.
        self._stats_lock = threading.Lock()
        self._slot_ids: dict[tuple[int, int], Any] = {}  # guarded-by: _stats_lock
        self.queries_planned = 0  # guarded-by: _stats_lock
        self.plan_time_s = 0.0  # guarded-by: _stats_lock
        self.backend_choices: dict[tuple[Bucket, BackendKey], int] = {}  # guarded-by: _stats_lock
        # The live lifts, by the id of their graph (which each holds, so the
        # id is not reused while it lives); an entry goes when the last
        # query holding it lets it go.
        self._lifts: weakref.WeakValueDictionary = weakref.WeakValueDictionary()  # guarded-by: _stats_lock

    # ------------------------------------------------------------------ #
    # Assignment: query -> (bucket, backend)
    # ------------------------------------------------------------------ #
    def assign(self, query: TrussQuery) -> QueryState:
        """Canonicalize one query: shape bucket + registry backend."""
        t0 = obs_clock.now()
        with current_tracer().span("plan", workload=query.workload) as span:
            key = query.backend if query.backend is not None else self.backend
            lift = self._lift(query.graph, stats=key is None)
            bucket = lift.bucket
            if query.placement == "sharded" and self.mesh is None:
                raise ValueError("placement='sharded' needs a session mesh")
            if query.placement == "replicated" and self.mesh is not None:
                raise ValueError(
                    "placement='replicated' conflicts with the session mesh "
                    "(placement is per-session; open a mesh-less session)"
                )
            if key is None:
                key = choose_backend(
                    lift.stats,
                    kernel=self.kernel,
                    layout=self.layout,
                )
                if self.mesh is not None and key.kernel == "fused":
                    # The auto rule upgraded to the kernel-resident fused
                    # kernel, but a mesh session must shard: step down to
                    # the unfused support kernel (bit-identical).
                    key = BackendKey(key.formulation, "pallas", key.layout)
            else:
                key = get_backend(key).key
            if self.mesh is not None and key.layout != "aligned":
                # The aligned layout is what makes slot boundaries shard
                # boundaries; a contig backend on a mesh would split member
                # graphs across devices.
                raise ValueError(
                    f"backend {key} has layout={key.layout!r}, but mesh "
                    "sharding needs layout='aligned'"
                )
            if self.mesh is not None and key.kernel == "fused":
                raise ValueError(
                    f"backend {key} keeps peel state kernel-resident and "
                    "cannot shard across a mesh; use fine/pallas/aligned"
                )
            span.attrs["backend"] = str(key)
        dt = obs_clock.now() - t0
        with self._stats_lock:
            self.queries_planned += 1
            self.plan_time_s += dt
            self.backend_choices[(bucket, key)] = (
                self.backend_choices.get((bucket, key), 0) + 1
            )
        state = QueryState(query=query, bucket=bucket, backend=key, lift=lift)
        state.stats.plan_time_s = dt
        state.stats.bucket = bucket
        state.stats.backend = key
        return state

    def _lift(self, graph: CSRGraph, *, stats: bool) -> GraphLift:
        """``graph``'s live lift on the planner's device, made on first use,
        with its bucket, its upper-triangular test and (``stats``) its
        imbalance statistics read back in one readback for what it lacks."""
        with self._stats_lock:
            lift = self._lifts.get(id(graph))
            if lift is None:
                lift = self._lifts[id(graph)] = GraphLift(graph)
        with lift.lock:
            if lift.csr is None:
                lift.csr = LiftedCSR(graph.n, *lift_csr(graph, self.device), graph.name)
            rowptr, colidx = lift.csr.rowptr, lift.csr.colidx
            parts = []
            if lift.bucket is None:
                parts += [undirected_max_degree(rowptr, colidx), *upper_violation(rowptr, colidx)]
            if stats and lift.stats is None:
                parts += imbalance_parts(rowptr, colidx, graph.nnz)
            if parts:
                values = torch.stack(parts).tolist()  # plan's one readback
                if lift.bucket is None:
                    und_max, row, col = values[:3]
                    values = values[3:]
                    lift.bucket = bucket_from_degree(graph, und_max, chunk=self.chunk)
                    lift.low = (row, col)
                if values:
                    lift.stats = stats_from_parts(graph, values)
        return lift

    def plan(self, states: list[QueryState]) -> Plan:
        """Group assigned queries into dispatchable batches (FIFO within a
        ``(bucket, backend)`` group, at most ``max_batch`` members each)."""
        t0 = obs_clock.now()
        batches: list[PlannedBatch] = []
        by_group: dict[tuple, list[QueryState]] = {}
        for st in states:
            by_group.setdefault(st.group, []).append(st)
        for group, members in by_group.items():
            for at in range(0, len(members), self.max_batch):
                batches.append(
                    PlannedBatch(
                        bucket=group[0],
                        backend=group[1],
                        queries=members[at : at + self.max_batch],
                        slots=self.max_batch,
                    )
                )
        dt = obs_clock.now() - t0
        with self._stats_lock:
            self.plan_time_s += dt  # batching is planning work too
        return Plan(batches=batches, plan_time_s=dt)

    # ------------------------------------------------------------------ #
    # Lowering: batch -> one dispatch -> per-query results
    # ------------------------------------------------------------------ #
    def cache_variant(
        self,
        backend: BackendKey,
        bucket: Bucket | None = None,
        slots: int | None = None,
    ):
        """What beyond (bucket, slots) specializes the executor.

        Every planner attribute ``build_executor`` reads MUST be folded in
        here (``mesh`` rides as its hashable ``_mesh_key``: axis names,
        shape and devices) — an attribute missing from this tuple would
        let two configs share one cache row; the R2 rule
        (``repro_torch.analysis.rules_recompile``) checks it.  The device
        needs no fold: an executor holds no tensor, and the problem it is
        handed decides where it runs.  Fused backends also fold in the bucket's
        autotuned kernel config (``repro_torch.kernels.autotune.lookup``),
        so a newly tuned block/schedule builds its own executor instead of
        reusing a stale one."""
        fused_sig = None
        if backend.kernel == "fused" and bucket is not None:
            fused_sig = self.fused_config_for(bucket, slots or self.max_batch).signature()
        return (backend, self.mode, self._mesh_key, self.chunk, self.max_iters, fused_sig)

    def fused_config_for(self, bucket: Bucket, slots: int):
        """The fused tuning point for one (bucket, slots): the persisted
        autotune winner when one exists, the stock default otherwise —
        always clamped so the block divides the bucket's slot width."""
        from ..kernels import autotune

        return autotune.lookup(bucket, slots).clamp(bucket.nnz_pad)

    def build_executor(self, key: tuple[Bucket, int, Any]):
        """Cache builder: one peel executor per cache key.  Everything it
        depends on arrives through the key but ``self.mesh``, the one
        object it reads (unhashable), keyed by its ``_mesh_key`` fold."""
        bucket, _slots, (backend, mode, _mesh_key, chunk, max_iters, fused_sig) = key
        fused_config = None
        if fused_sig is not None:
            from ..kernels.autotune import FusedConfig

            fused_config = FusedConfig.from_signature(fused_sig)
        return get_backend(backend).make_executor(
            window=bucket.window,
            chunk=chunk,
            max_iters=max_iters,
            mesh=self.mesh,
            mode=mode,
            fused_config=fused_config,
        )

    def _slot_ids_for(self, batch: PlannedBatch, edge_ranges) -> torch.Tensor:
        if batch.backend.layout == "aligned":
            # Lane blocks are slot blocks: one cached id vector per shape.
            cache_key = (batch.slots, batch.bucket.nnz_pad)
            with self._stats_lock:
                ids = self._slot_ids.get(cache_key)
            if ids is None:
                ids = torch.arange(
                    batch.slots, dtype=torch.int32, device=self.device
                ).repeat_interleave(batch.bucket.nnz_pad)
                with self._stats_lock:
                    # First writer wins so every batch shares one tensor.
                    ids = self._slot_ids.setdefault(cache_key, ids)
            return ids
        # Contig layout: members are prefix-packed, so slot ownership
        # depends on this batch's member sizes.  Pad-tail lanes are dead
        # (never alive, never frozen) — parking them on slot 0 is inert.
        lengths = [b - a for a, b in edge_ranges]
        ids = torch.repeat_interleave(
            torch.arange(len(lengths), dtype=torch.int32, device=self.device),
            torch.tensor(lengths, device=self.device),
            output_size=sum(lengths),
        )
        return torch.cat([ids, ids.new_zeros(batch.slots * batch.bucket.nnz_pad - ids.shape[0])])

    def _typed_fault(self, err: Exception, bucket: Bucket, backend: BackendKey) -> TrussError:
        """``err`` as the resilience runner receives it: typed, and marked
        ``kernel_fault`` under the port's kernel-fault rule.

        The rule is decided here and nowhere else.  A failure raised while
        a hand-written CUDA kernel's backend runs on the card
        (:func:`~repro_torch.api.registry.runs_hand_kernel`) is a kernel
        fault unless it was injected, is bad input, or is the peel's
        iteration cap (``site="peel"``): a wrapper's typed launch error,
        ``nvcc`` missing or failing, and anything raw on the way (an OOM
        allocating a kernel's scratch, a wrapper's argument check).  The
        runner fails the batch at once on it, with no retry and no
        fallback (``repro_torch.resilience.runner``).  Raw failures of any
        backend become typed device faults.
        """
        if not isinstance(err, TrussError):
            err = DeviceError(
                f"peel dispatch failed on backend {backend}: {err}",
                bucket=bucket,
                backend=backend,
                oom=isinstance(err, torch.OutOfMemoryError),
                cause=err,
            )
        if (
            runs_hand_kernel(backend, self.device)
            and not err.injected
            and not isinstance(err, InvalidGraphError)
            and not (isinstance(err, DeviceError) and err.site == "peel")
        ):
            err.kernel_fault = True
        return err

    def execute(self, batch: PlannedBatch, cache: CompileCache) -> list[Any]:
        """Run one planned batch — ONE dispatch — and unpack results.

        Returns one result per query, in batch order: ``KTrussResult``
        (ktruss), ``int`` (kmax), ``TrussDecomposition`` (decompose), or
        the member's full ``(nnz,)`` trussness (stream_update).
        """
        bucket, backend, queries = batch.bucket, batch.backend, batch.queries
        tracer = current_tracer()
        qids = tuple(st.id for st in queries)
        # Fault sites (repro_torch.resilience.faults), the reference's:
        # no-ops without an active FaultPlan; under one, these are where the
        # chaos suite makes the dispatch fail in every taxonomy-distinct way.
        for i, st in enumerate(queries):
            inject(
                "poison",
                slot=i,
                query=st.id,
                queries=qids,
                bucket=bucket,
                backend=str(backend),
            )
        t0 = obs_clock.now()
        with tracer.span(
            "pack", members=len(queries), slots=batch.slots, layout=backend.layout
        ):
            members = []
            for st in queries:
                if st.lift is None:  # not assigned here: the pack lifts and checks it
                    members.append(st.query.graph)
                    continue
                if st.lift.low[0]:
                    raise not_upper(st.lift.graph.name, *st.lift.low)
                members.append(st.lift.csr)
            # Members whose graph object an earlier member already holds:
            # each is packed into a slot of its own all the same.
            shared = len(queries) - len({id(st.query.graph) for st in queries})
            current_registry().inc(PEEL_SLOTS_SHARED, shared)
            packed = pack_problems(
                members,
                slot_n=bucket.n_pad,
                slot_nnz=bucket.nnz_pad,
                slots=batch.slots,
                chunk=self.chunk,
                layout=backend.layout,
                device=self.device,
            )
        pack_dt = obs_clock.now() - t0
        with tracer.span("compile", backend=str(backend)) as span:
            inject("compile", bucket=bucket, backend=str(backend), queries=qids)
            try:
                exe, hit = cache.get(
                    bucket, batch.slots, self.cache_variant(backend, bucket, batch.slots)
                )
            except TrussError as e:
                raise self._typed_fault(e, bucket, backend)
            span.attrs["hit"] = hit
        for st in queries:
            st.stats.pack_time_s = pack_dt
            st.stats.compile_hit = hit

        slot_ids = self._slot_ids_for(batch, packed.edge_ranges)
        k0 = np.full(batch.slots, 3, np.int32)
        single_level = np.zeros(batch.slots, bool)
        for i, st in enumerate(queries):
            k0[i] = st.query.k
            single_level[i] = st.query.workload == "ktruss"

        # Streaming members peel only their affected frontier; the rest of
        # their lanes are frozen at the caller's maintained trussness.
        # Ordinary members stay on the executor's defaults (fully alive,
        # nothing frozen) — zeros here reproduce those defaults exactly.
        alive0 = frozen = frozen_truss = None
        streams = [
            (st, rng)
            for st, rng in zip(queries, packed.edge_ranges)
            if st.query.workload == "stream_update"
        ]
        if streams:
            # Every real lane starts alive: the lanes of the pack's edge
            # ranges are exactly those holding a column (pad lanes hold 0),
            # the executor's own default.  A member's frontier and frozen
            # trussness (numpy, or tensors already on this device) are
            # written into its range on the device.
            alive0 = packed.problem.colidx != 0
            frozen = torch.zeros_like(alive0)
            frozen_truss = torch.zeros(alive0.shape, dtype=torch.int32, device=self.device)
            for st, (a, b) in streams:
                lanes = torch.as_tensor(st.query.frontier, device=self.device)
                alive0[a:b] = lanes
                frozen[a:b] = ~lanes
                frozen_truss[a:b] = torch.as_tensor(st.query.frozen_truss, device=self.device)

        # peel() synchronizes (it reads the done flags back when its trip
        # loop has ended; the fused loop after every level), so dt covers
        # the whole dispatch.  On CUDA the device time is its launches'
        # event intervals, which the peel reads after those readbacks.
        inject("clock_skew", bucket=bucket, backend=str(backend), queries=qids)
        inject("device_oom", bucket=bucket, backend=str(backend), queries=qids)
        inject("dispatch", bucket=bucket, backend=str(backend), queries=qids)
        t0 = obs_clock.now()
        try:
            with dispatch_device_time() as launches:
                st_dev = exe.peel(
                    packed.problem,
                    slot_ids=slot_ids,
                    k0=k0,
                    single_level=single_level,
                    alive0=alive0,
                    frozen=frozen,
                    frozen_truss=frozen_truss,
                )
        except Exception as e:
            fault = self._typed_fault(e, bucket, backend)
            if fault is e:
                raise
            raise fault from e
        dt = obs_clock.now() - t0
        if packed.problem.device.type == "cuda":
            dt = launches.seconds

        with tracer.span("unpack", members=len(queries)):
            # One batched copy of what the members return: the per-slot
            # counters (every member's stats and record_peel_batch read
            # them), then each member's range of the arrays its workload
            # returns — alive and support for ktruss, trussness for
            # decompose and stream_update, nothing more for kmax.
            parts = [st_dev.kmax, st_dev.levels, st_dev.iters, st_dev.edges_alive,
                     st_dev.total_iters.reshape(1)]
            for st, (a, b) in zip(queries, packed.edge_ranges):
                if st.query.workload == "ktruss":
                    parts += [st_dev.alive[a:b], st_dev.support[a:b]]
                elif st.query.workload != "kmax":
                    parts.append(st_dev.trussness[a:b])
            host = torch.cat([x.to(torch.int32) for x in parts]).cpu().numpy()
            kmax, levels, iters, edges_alive = host[: 4 * batch.slots].reshape(4, -1)
            trips = int(host[4 * batch.slots])
            at = 4 * batch.slots + 1

            # Members' arrays are views of this readback, a fresh buffer
            # that nothing else writes: a copy of each into numpy's own
            # allocation took longer than the readback itself, and varied
            # from process to process (a 27 MB answer: 5-7 ms on an H100's
            # host, the readback 2.3 ms).
            def take(m: int) -> np.ndarray:
                nonlocal at
                at += m
                return host[at - m : at]

            results: list[Any] = []
            for i, (st, (a, b)) in enumerate(zip(queries, packed.edge_ranges)):
                st.stats.device_time_s = dt  # the batch's single dispatch
                st.stats.rounds = int(levels[i])
                st.stats.iterations = int(iters[i])
                st.stats.dispatch_trips = trips
                workload = st.query.workload
                if workload == "ktruss":
                    member_alive = take(b - a).astype(bool)
                    results.append(
                        KTrussResult(
                            k=st.query.k,
                            alive=member_alive,
                            support=take(b - a),
                            iterations=int(iters[i]),
                            edges_remaining=int(member_alive.sum()),
                        )
                    )
                elif workload == "kmax":
                    results.append(int(kmax[i]))
                elif workload == "stream_update":
                    # Full member trussness: frontier lanes re-peeled, frozen
                    # lanes passed through by the peel.  The device copy is
                    # the executor's buffer's, which its next peel reuses.
                    results.append(take(b - a))
                    st.device_result = st_dev.trussness[a:b].clone()
                else:
                    t = take(b - a)
                    results.append(
                        TrussDecomposition(
                            trussness=t,
                            kmax=int(t.max(initial=0)) if t.size else 0,
                            levels=int(levels[i]),
                        )
                    )

        for st in queries:
            st.lift = None  # the dispatch is done with the graph's lift
        # The paper's load-imbalance statistic, observed at runtime: the
        # per-slot iteration spread of THIS dispatch, per (bucket, backend).
        record_peel_batch(
            bucket=bucket,
            backend=backend,
            levels=levels,
            iters=iters,
            edges_alive=edges_alive,
            batch_size=len(queries),
            device_time_s=dt,
        )
        return results

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Planning observability: overhead per query + chosen backends."""
        from .cache import bucket_str

        with self._stats_lock:
            queries_planned = self.queries_planned
            plan_time_s = self.plan_time_s
            choices = dict(self.backend_choices)
        per_query_us = (
            1e6 * plan_time_s / queries_planned if queries_planned else 0.0
        )
        return {
            "queries_planned": queries_planned,
            "plan_time_s": round(plan_time_s, 6),
            "plan_us_per_query": round(per_query_us, 2),
            # One row per (bucket, backend) choice.
            "backends": [
                {
                    "bucket": bucket_str(b),
                    "backend": str(k),
                    "queries": n,
                }
                for (b, k), n in sorted(choices.items(), key=lambda kv: -kv[1])
            ],
        }
