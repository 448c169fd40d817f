"""StreamingTrussSession: truss maintenance for one mutating graph.

A session owns one evolving graph and its current truss decomposition.
Each :meth:`update` applies an :class:`~repro_torch.stream.delta.EdgeBatch`,
computes the affected-edge frontier (``repro_torch.stream.frontier``), and
— only if the frontier is non-empty — submits ONE
frontier-bounded ``stream_update`` :class:`repro_torch.api.TrussQuery`
through the owning :class:`repro_torch.api.Session`: the frontier lanes
start alive, every other edge is frozen at its maintained trussness (the
exec layer's frozen lanes), so the update costs one device dispatch over
the sub-problem instead of a full decompose.  Updates whose frontier is
empty (e.g. deleting an edge in no triangle) cost zero dispatches.

The maintained state is exact, not approximate: the frontier closure is a
proven superset of every edge whose trussness can change, and the frozen
re-peel restricted to it reproduces from-scratch ``decompose()``
bit-for-bit (held to the JAX package in ``tests/test_torch_stream.py``).

Two maintained-state optimizations keep an update below a full
recompute:

* the union-graph **triangle list is cached** across updates
  (:class:`repro_torch.stream.tricache.TriangleCache`, on the device):
  only wedges through the batch's inserted edges are enumerated, instead
  of re-enumerating every triangle per update (``cache_triangles=False``
  restores the old path);
* deltas themselves are sorted-key merges (``repro_torch.stream.delta``).

Every stage over the graph's edges (the delta, the union graph, the
incident triangles, the frontier, the carried trussness and the frozen
lanes) is torch ops on the owning api session's device.  The session
keeps its state there between updates: the committed graph carries its
device CSR (``graphs.csr.hold_lifted``) and the trussness its device
twin, the peel's own output, so an update copies only the batch's keys
to the device.  ``graph`` and ``trussness`` stay the host values, each
read back once a commit (the new CSR by the delta, the trussness by the
dispatch's unpack).

Sessions ride the api session's queue, micro-batcher and compile cache,
so updates from many concurrent sessions — and ordinary declarative
queries — coalesce into shared dispatches.  Use the two-phase form for
that::

    pend_a = session_a.submit_update(batch_a)   # enqueue only
    pend_b = session_b.submit_update(batch_b)
    s.flush()                                   # one packed dispatch
    res_a, res_b = pend_a.result(), pend_b.result()

``update()`` is submit + result in one call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..errors import InvalidGraphError
from ..graphs.csr import CSRGraph, hold_lifted, lift_csr
from ..obs import MetricsRegistry, use_registry, use_tracer
from .delta import EdgeBatch, GraphDelta, apply_batch
from .frontier import FrontierResult, compute_frontier, union_graph
from .tricache import TriangleCache

if TYPE_CHECKING:  # pragma: no cover
    from ..api.session import Session, TrussFuture

__all__ = ["StreamUpdateResult", "PendingUpdate", "StreamingTrussSession"]


@dataclasses.dataclass(frozen=True)
class StreamUpdateResult:
    """One committed update: the new decomposition + what it cost."""

    trussness: np.ndarray  # (new_nnz,) int32 — full, exact decomposition
    kmax: int
    frontier_size: int  # edges re-peeled
    frontier_frac: float  # frontier_size / new_nnz
    num_inserts: int
    num_deletes: int
    dispatches: int  # 0 (frontier empty) or 1
    num_edges: int  # new graph's edge count


class PendingUpdate:
    """Deferred half of :meth:`StreamingTrussSession.submit_update`.

    ``result()`` resolves the underlying api future (running the
    session's batch group if needed), takes the re-peeled trussness (the
    carried trussness, on the device, when nothing was dispatched),
    commits the session state, and returns the :class:`StreamUpdateResult`.
    """

    def __init__(
        self,
        session: "StreamingTrussSession",
        delta: GraphDelta,
        frontier: FrontierResult,
        carry: torch.Tensor,
        future: "TrussFuture | None",
        union_tri_keys: torch.Tensor | None = None,
    ):
        self._session = session
        self._delta = delta
        self._frontier = frontier
        self._carry = carry
        self._future = future
        self._union_tri_keys = union_tri_keys
        self._result: StreamUpdateResult | None = None

    def done(self) -> bool:
        return self._result is not None or (
            self._future is not None and self._future.done()
        )

    def result(self) -> StreamUpdateResult:
        if self._result is None:
            if self._future is None:
                t_dev = self._carry
                t_new = t_dev.cpu().numpy()
            else:
                t_new = np.asarray(self._future.result(), np.int32)
                # The planner keeps the member's trussness on the device too.
                t_dev = self._future.request.device_result
            self._result = self._session._commit(
                self._delta, self._frontier, t_new, t_dev, self._union_tri_keys
            )
        return self._result


class StreamingTrussSession:
    """Incremental truss maintenance for one graph on a ``repro_torch.api.Session``.

    Construct via :meth:`repro_torch.api.Session.open_stream` (shared session —
    concurrent streams coalesce), the legacy ``TrussService.open_stream``
    adapter, or :meth:`for_graph` (private single-slot session).
    ``trussness`` seeds the state; omitted, the initial full decompose
    runs through the session's batched path.  Triangle state and the
    frontier live on the api session's device.
    """

    def __init__(
        self,
        session,
        graph: CSRGraph,
        *,
        trussness: np.ndarray | None = None,
        cache_triangles: bool = True,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
    ):
        # Accept a repro_torch.api.Session or anything wrapping one under
        # ``.session`` (the legacy TrussService adapter).
        self.api: "Session" = getattr(session, "session", session)
        self.service = session  # legacy spelling; .stats() works on both
        self.device = self.api.planner.device
        # Per-stream metrics, chained to the owning api session's registry
        # (which chains to the process-global one): counts stay isolated
        # per stream while every aggregate view still sees them.
        self.metrics = MetricsRegistry(parent=self.api.obs.metrics)
        # The stream's own handle on the caller's arrays (not copied): it
        # carries their device copy once the first update lifts them, and
        # the caller's graph object stays as it was.
        self.graph = CSRGraph(graph.n, graph.rowptr, graph.colidx, name=graph.name, validate=False)
        if trussness is None:
            from ..api.query import TrussQuery  # lazy: no import cycle

            trussness = self.api.submit(TrussQuery.decompose(graph)).result().trussness
        trussness = np.asarray(trussness, np.int32)
        if trussness.shape[0] != graph.nnz:
            raise InvalidGraphError(
                f"trussness has {trussness.shape[0]} entries, graph has "
                f"{graph.nnz}",
                kind="trussness_len",
                graph=graph.name,
            )
        self.trussness = trussness
        self._trussness_dev: torch.Tensor | None = None  # made on first use
        self.cache_triangles = bool(cache_triangles)
        self._tri_cache: TriangleCache | None = None
        self._pending: PendingUpdate | None = None
        # Crash durability (repro_torch.resilience.checkpoint): with a
        # checkpoint_dir, every `checkpoint_every`-th commit serializes
        # graph + trussness + triangle cache at the update boundary.
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self._ckpt_seq = 0  # monotone auto-checkpoint sequence number
        self._updates_total = 0  # lifetime commits, surviving restore

    # Maintenance counters — views over this stream's metrics registry -- #
    @property
    def updates_applied(self) -> int:
        return int(self.metrics.value("stream_updates"))

    @property
    def updates_total(self) -> int:
        """Lifetime committed updates **across restores**.

        Unlike :attr:`updates_applied` (a per-instance metric that resets
        to 0 in a restored session), this is the durable sequence number a
        checkpoint's ``updates_applied`` meta records — the serving tier's
        exactly-once replay anchor."""
        return self._updates_total

    @property
    def update_dispatches(self) -> int:
        return int(self.metrics.value("stream_update_dispatches"))

    @property
    def edges_repeeled(self) -> int:
        return int(self.metrics.value("stream_edges_repeeled"))

    def _instrumented(self):
        """Scope where this stream's metrics + the api session's tracer
        are the context-current sinks (frontier/tricache record here)."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(use_registry(self.metrics))
        ctx.enter_context(use_tracer(self.api.obs.tracer))
        return ctx

    # ------------------------------------------------------------------ #
    @classmethod
    def for_graph(cls, graph: CSRGraph, **session_kwargs) -> "StreamingTrussSession":
        """Standalone session over a private one-slot ``repro_torch.api.Session``.

        Stream-level knobs (``trussness``, ``cache_triangles``,
        ``checkpoint_dir``, ``checkpoint_every``) are split off; the rest
        (``device=`` among them: CUDA unless ``"cpu"`` is passed)
        configures the private api session.
        """
        from ..api.session import Session

        stream_kwargs = {
            k: session_kwargs.pop(k)
            for k in (
                "trussness",
                "cache_triangles",
                "checkpoint_dir",
                "checkpoint_every",
            )
            if k in session_kwargs
        }
        session_kwargs.setdefault("max_batch", 1)
        return cls(Session(**session_kwargs), graph, **stream_kwargs)

    @property
    def kmax(self) -> int:
        return int(self.trussness.max(initial=0)) if self.graph.nnz else 0

    def _device_trussness(self) -> torch.Tensor:
        """The committed trussness on the device: the previous dispatch's
        output, or one copy of the host array (a new or restored session)."""
        if self._trussness_dev is None:
            self._trussness_dev = torch.from_numpy(np.ascontiguousarray(self.trussness)).to(
                self.device
            )
        return self._trussness_dev

    # ------------------------------------------------------------------ #
    def submit_update(self, batch: EdgeBatch, *, strict: bool = True) -> PendingUpdate:
        """Apply ``batch``, enqueue the frontier re-peel, return a handle.

        The graph/trussness state commits when the handle resolves; one
        update may be in flight per session (deltas are relative to the
        committed graph), so concurrency comes from many sessions sharing
        one api session, not from pipelining a single session.
        """
        if self._pending is not None and self._pending._result is None:
            raise RuntimeError(
                "session already has an in-flight update; resolve it first"
            )
        tracer = self.api.obs.tracer
        dev = self.device
        with self._instrumented():
            with tracer.span(
                "stream.delta", inserts=len(batch.inserts), deletes=len(batch.deletes)
            ):
                # A new or restored session's graph goes to the device once
                # and stays there; every later graph is built there.
                hold_lifted(self.graph, *lift_csr(self.graph, dev))
                delta = apply_batch(self.graph, batch, strict=strict, device=dev)

            # Incremental triangle state: reuse the cached list, enumerating
            # only the wedges the batch's inserts touch.  The union graph is
            # built once and shared between the cache and the frontier.
            union_tri_keys = union_pair = None
            if self.cache_triangles:
                with tracer.span("stream.triangles") as span:
                    if self._tri_cache is None:
                        self._tri_cache = TriangleCache(self.graph, device=dev)
                    union_pair = union_graph(delta)
                    union_tri_keys = self._tri_cache.union_triangles(
                        delta, union=union_pair
                    )
                    span.attrs["triangles"] = int(union_tri_keys.shape[0])
            with tracer.span("stream.frontier") as span:
                fr = compute_frontier(
                    self._device_trussness(),
                    delta,
                    tri_keys=union_tri_keys,
                    union=union_pair,
                    device=dev,
                )
                span.attrs["frontier"] = fr.size
            self.metrics.observe(
                "stream_frontier_frac",
                fr.frac,
                buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0),
            )
        g_new = delta.new_graph

        # Trussness carried over from the committed state (inserted edges
        # start at the vacuous floor 2 and are always in the frontier): an
        # inserted edge's new2old is -1, which picks the appended 2.
        t_old = self._device_trussness()
        carry = torch.cat([t_old, t_old.new_full((1,), 2)])[delta.tensors.new2old]
        frontier = fr.tensors.frontier

        future = None
        if fr.size:
            from ..api.query import TrussQuery  # lazy: no import cycle

            future = self.api.submit(
                TrussQuery.stream_update(
                    g_new,
                    frontier=frontier,
                    frozen_truss=torch.where(frontier, 0, carry).to(torch.int32),
                )
            )
        self._pending = PendingUpdate(self, delta, fr, carry, future, union_tri_keys)
        return self._pending

    def update(self, batch: EdgeBatch, *, strict: bool = True) -> StreamUpdateResult:
        """Submit + resolve in one call (single-session convenience)."""
        return self.submit_update(batch, strict=strict).result()

    # ------------------------------------------------------------------ #
    def _commit(
        self,
        delta: GraphDelta,
        fr: FrontierResult,
        t_new: np.ndarray,
        t_dev: torch.Tensor,
        union_tri_keys: torch.Tensor | None,
    ) -> StreamUpdateResult:
        self.graph = delta.new_graph
        self.trussness = t_new
        self._trussness_dev = t_dev
        if self._tri_cache is not None and union_tri_keys is not None:
            self._tri_cache.commit(delta, union_tri_keys)
        self._pending = None
        dispatches = 1 if fr.size else 0
        self._updates_total += 1
        self.metrics.inc("stream_updates")
        self.metrics.inc("stream_update_dispatches", dispatches)
        self.metrics.inc("stream_edges_repeeled", fr.size)
        if (
            self.checkpoint_dir is not None
            and self._updates_total % self.checkpoint_every == 0
        ):
            self._auto_checkpoint()
        return StreamUpdateResult(
            trussness=t_new,
            kmax=self.kmax,
            frontier_size=fr.size,
            frontier_frac=fr.frac,
            num_inserts=delta.num_inserts,
            num_deletes=delta.num_deletes,
            dispatches=dispatches,
            num_edges=delta.new_graph.nnz,
        )

    # ------------------------------------------------------------------ #
    # Crash durability (repro_torch.resilience.checkpoint)
    # ------------------------------------------------------------------ #
    @property
    def checkpoints_written(self) -> int:
        return int(self.metrics.value("stream_checkpoints"))

    def checkpoint(self, path: str) -> str:
        """Serialize the committed state (CSR + trussness + triangle cache)
        to ``path`` atomically; returns ``path``.  Restoring it
        (:meth:`restore`) continues bit-identically to this session."""
        from ..resilience.checkpoint import save_checkpoint  # lazy: no cycle

        if self._pending is not None and self._pending._result is None:
            raise RuntimeError(
                "cannot checkpoint with an in-flight update; resolve it first"
            )
        out = save_checkpoint(
            path,
            graph=self.graph,
            trussness=self.trussness,
            tri_keys=self._tri_cache.tri_keys.cpu().numpy() if self._tri_cache else None,
            updates_applied=self.updates_total,
        )
        self.metrics.inc("stream_checkpoints")
        return out

    def _auto_checkpoint(self) -> None:
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self._ckpt_seq += 1
        path = os.path.join(self.checkpoint_dir, f"ckpt-{self._ckpt_seq:08d}.npz")
        self.checkpoint(path)
        # Keep the newest two: a crash mid-write of checkpoint N still
        # leaves N-1 intact (the write itself is atomic, this is belt
        # and suspenders for partial-directory states).
        kept = sorted(
            f
            for f in os.listdir(self.checkpoint_dir)
            if f.startswith("ckpt-") and f.endswith(".npz")
        )
        for stale in kept[:-2]:
            with contextlib.suppress(OSError):
                os.unlink(os.path.join(self.checkpoint_dir, stale))

    @classmethod
    def restore(cls, path: str, session=None, **session_kwargs):
        """Rebuild a session from a :meth:`checkpoint` file — no decompose
        dispatch, no triangle re-enumeration (``resilience.restore_session``)."""
        from ..resilience.checkpoint import restore_session  # lazy: no cycle

        return restore_session(path, session=session, **session_kwargs)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        return {
            "updates_applied": self.updates_applied,
            "update_dispatches": self.update_dispatches,
            "edges_repeeled": self.edges_repeeled,
            "edges": self.graph.nnz,
            "kmax": self.kmax,
            "cached_triangles": (
                self._tri_cache.num_triangles if self._tri_cache else 0
            ),
            "checkpoints_written": self.checkpoints_written,
        }
