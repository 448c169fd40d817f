"""Session + solve(): the one front door over the planner/backend registry.

``solve(queries)`` is the one-shot form: assign, batch, dispatch, return
results in submission order.  :class:`Session` is the serving form: a
long-lived queue + executor cache where queries from many callers coalesce
into shared dispatches (micro-batching), and futures resolve on
``flush()`` or transparently on ``result()`` (which drives only the owning
query's ``(bucket, backend)`` group).

Both run on the CUDA device unless ``device="cpu"`` is passed, and raise
``RuntimeError`` when CUDA is asked for and absent.  The lowering itself
lives in :class:`repro_torch.api.Planner`.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque
from typing import Any

import numpy as np
import torch

from ..obs import MetricsRegistry, Observability
from ..obs import clock as obs_clock
from ..resilience.faults import FaultPlan, use_plan
from ..resilience.retry import RetryPolicy
from ..resilience.runner import ResilientRunner
from .cache import CompileCache, bucket_for, enable_persistent_cache
from .errors import TrussTimeoutError
from .planner import PlannedBatch, Planner, QueryState
from .query import TrussQuery
from .registry import BackendKey

__all__ = ["QueryQueue", "TrussFuture", "Session", "solve"]

_UNSET = object()  # result(): "no timeout given" vs. explicit None


class QueryQueue:
    """Arrival-ordered queue with same-group, deadline-aware batch formation.

    A batch is formed by taking one pending query's ``(bucket, backend)``
    group and draining up to ``max_batch`` same-group queries (FIFO within
    the group).  With no explicit group the *most urgent* pending query
    picks it: earliest absolute deadline first, arrival order among
    undeadlined queries.
    """

    def __init__(self, *, max_batch: int = 8):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self._pending: deque[QueryState] = deque()

    def __len__(self) -> int:
        return len(self._pending)

    def enqueue(self, state: QueryState) -> None:
        self._pending.append(state)

    def drain(self) -> list[QueryState]:
        """Remove and return every pending query (arrival order)."""
        states = list(self._pending)
        self._pending.clear()
        return states

    @staticmethod
    def _urgency(state: QueryState) -> tuple[float, int]:
        d = state.query.deadline_s
        absolute = state.submitted_at + d if d is not None else float("inf")
        return (absolute, state.id)

    def discard(self, state: QueryState) -> bool:
        """Remove one specific pending query (shed-on-timeout's reclaim),
        matched by identity.  Returns whether it was still pending."""
        n = len(self._pending)
        self._pending = deque(st for st in self._pending if st is not state)
        return len(self._pending) != n

    def next_batch(self, group=None) -> list[QueryState]:
        """Drain up to ``max_batch`` queries sharing one group."""
        if not self._pending:
            return []
        if group is None:
            group = min(self._pending, key=self._urgency).group
        batch: list[QueryState] = []
        keep: deque[QueryState] = deque()
        while self._pending:
            st = self._pending.popleft()
            if st.group == group and len(batch) < self.max_batch:
                batch.append(st)
            else:
                keep.append(st)
        self._pending = keep
        now = obs_clock.now()
        for st in batch:
            st.stats.queue_time_s = now - st.submitted_at
            st.stats.batch_size = len(batch)
        return batch


class TrussFuture:
    """Handle to a submitted query; resolves when its batch runs."""

    def __init__(self, session: "Session", state: QueryState):
        self._session = session
        self._state = state
        self._result: Any = None
        self._error: BaseException | None = None
        self._done = False

    @property
    def request(self) -> QueryState:
        return self._state

    @property
    def query(self) -> TrussQuery:
        return self._state.query

    @property
    def stats(self):
        return self._state.stats

    def done(self) -> bool:
        return self._done

    def result(self, timeout: float | None = _UNSET) -> Any:
        """Resolve this query, driving only its own ``(bucket, backend)``
        group.

        ``timeout`` bounds the time spent driving the queue (checked
        between batch dispatches); left unset it defaults to the query's
        remaining ``deadline_s`` budget, and ``timeout=None`` waits until
        resolved.  On expiry raises :class:`TrussTimeoutError`; under the
        session's default ``shed_on_timeout=True`` the query is also
        marked dead and its queue slot reclaimed.
        """
        if timeout is _UNSET:
            timeout = self._state.time_remaining()
        t0 = obs_clock.now()
        session = self._session
        while not self._done:
            waited = obs_clock.now() - t0
            if timeout is not None and waited >= timeout:
                session._record_deadline_miss(self._state, waited)
                shed = session.shed_on_timeout
                depth = session.queue_depth()
                err = TrussTimeoutError(
                    f"query {self._state.id} ({self._state.query.workload}) "
                    f"unresolved after {waited:.3f}s (timeout={timeout}s); "
                    f"bucket={self._state.bucket}, "
                    f"queue_depth={depth}"
                    + ("; query shed" if shed else ""),
                    bucket=self._state.bucket,
                    queue_depth=depth,
                    request_id=self._state.id,
                    waited_s=waited,
                    shed=shed,
                )
                if shed:
                    session._shed(self._state, err)
                raise err
            batch = session._form_batch(group=self._state.group)
            if batch:
                session._run_batch(session._planned(batch))
                continue
            with session._cv:
                if self._done:
                    break
                if self._state.id in session._inflight:
                    # Another thread's dispatch owns this query's batch;
                    # wait for its resolution (bounded, so the deadline
                    # check above still runs).
                    session._cv.wait(timeout=0.05)
                    continue
                raise RuntimeError(
                    f"query {self._state.id} is unresolved but not queued"
                )
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result: Any) -> None:
        self._result = result
        self._done = True

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done = True


class Session:
    """Long-lived query session: one queue, one planner, one executor cache.

    Config (all optional):
      device: where packed problems and the peel live; ``None`` = CUDA
        (``RuntimeError`` when absent — pass ``"cpu"`` for the CPU).
      backend: force one registry backend for every query
        (``BackendKey`` / ``"fine/pallas/aligned"``); ``None`` = per-query
        auto rule on the paper's imbalance statistics.
      kernel / layout: defaults for the auto rule (kernel ``None`` =
        ``pallas``, the CUDA kernel, on CUDA; ``xla`` on the CPU).
      mode: override the backend's update dataflow (``eager``/``owner``).
      max_batch: packed slots per dispatch (batches pad to this).
      chunk: task-chunk width (power of two).
      max_iters: explicit peel iteration cap (None = provable bound).
      cache_dir: keep the fused kernel's autotune store at
        ``<cache_dir>/autotune.json``, so tuned configs outlive the
        process (:func:`repro_torch.api.cache.enable_persistent_cache`).
      trace: span tracing — ``True`` records in memory, a path string
        records AND exports Chrome trace JSON there after
        ``solve()``/``flush()``; ``None`` consults ``REPRO_TRACE``.
      metrics: route this session's metrics into an existing
        :class:`repro_torch.obs.MetricsRegistry`.
      faults: a :class:`repro_torch.resilience.FaultPlan` injected at the
        planner's fault sites for this session's dispatches (``None``
        consults the ``REPRO_FAULTS`` env var; production leaves both
        unset — the hooks are no-ops).
      retry: the :class:`repro_torch.resilience.RetryPolicy` governing
        retry/backoff, registry fallback, and batch bisection (default
        policy: 3 attempts, exponential backoff, fallback + bisect on).
      shed_on_timeout: when a ``result(timeout=...)`` expires, mark the
        query dead and reclaim its queue slot (default).

    Dispatches run through a :class:`repro_torch.resilience.ResilientRunner`:
    typed faults become per-query outcomes (quarantine, retry, fallback,
    bisect), except that a real launch or build failure of a hand-written
    CUDA kernel fails its batch's queries at once, with no retry and no
    fallback; any non-taxonomy exception fails the batch and propagates.
    """

    def __init__(
        self,
        *,
        device: str | torch.device | None = None,
        backend: BackendKey | str | None = None,
        kernel: str | None = None,
        layout: str | None = None,
        mode: str | None = None,
        max_batch: int = 8,
        chunk: int = 256,
        max_iters: int | None = None,
        cache_dir: str | None = None,
        trace: bool | str | None = None,
        metrics: MetricsRegistry | None = None,
        faults: FaultPlan | None = None,
        retry: RetryPolicy | None = None,
        shed_on_timeout: bool = True,
    ):
        if cache_dir is not None:
            enable_persistent_cache(cache_dir)
        self.obs = Observability(trace=trace, metrics=metrics)
        self.planner = Planner(
            max_batch=max_batch,
            chunk=chunk,
            kernel=kernel,
            layout=layout,
            backend=backend,
            mode=mode,
            max_iters=max_iters,
            device=device,
        )
        self.cache = CompileCache(
            self.planner.build_executor, metrics=self.obs.metrics
        )
        # Thread safety: the batch former, the futures map and the
        # in-flight set share one condition variable; dispatches run
        # outside the lock.
        self._cv = threading.Condition()
        self.queue = QueryQueue(max_batch=max_batch)  # guarded-by: _cv
        self._futures: dict[int, TrussFuture] = {}  # guarded-by: _cv
        self._inflight: set[int] = set()  # guarded-by: _cv
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self.retry = retry or RetryPolicy()
        self.shed_on_timeout = bool(shed_on_timeout)
        self.runner = ResilientRunner(
            self._dispatch_once,
            policy=self.retry,
            metrics=self.obs.metrics,
            device=self.planner.device,
        )

    # Convenience mirrors of the planner's config ----------------------- #
    @property
    def max_batch(self) -> int:
        return self.planner.max_batch

    @property
    def chunk(self) -> int:
        return self.planner.chunk

    # Serving counters — views over the session's metrics registry ------ #
    @property
    def requests_served(self) -> int:
        return int(self.obs.metrics.value("requests_served"))

    @property
    def batches_run(self) -> int:
        return int(self.obs.metrics.value("batches_run"))

    @property
    def device_dispatches(self) -> int:
        return int(self.obs.metrics.value("dispatches"))

    @property
    def device_time_s(self) -> float:
        return self.obs.metrics.value("device_seconds_total")

    @property
    def deadline_misses(self) -> int:
        return int(self.obs.metrics.value("deadline_misses"))

    @property
    def queries_failed(self) -> int:
        return int(self.obs.metrics.value("queries_failed"))

    @property
    def queries_shed(self) -> int:
        return int(self.obs.metrics.value("queries_shed"))

    def _counter_total(self, name: str) -> int:
        """Sum a counter across every label series (e.g. retries{backend=})."""
        prefix = name + "{"
        return int(
            sum(
                v
                for k, v in self.obs.metrics.snapshot()["counters"].items()
                if k == name or k.startswith(prefix)
            )
        )

    # Resilience counters (repro_torch.resilience.runner / faults) ------ #
    @property
    def retries(self) -> int:
        return self._counter_total("retries")

    @property
    def backend_fallbacks(self) -> int:
        return self._counter_total("backend_fallbacks")

    @property
    def queries_quarantined(self) -> int:
        return int(self.obs.metrics.value("queries_quarantined"))

    @property
    def batch_bisects(self) -> int:
        return int(self.obs.metrics.value("batch_bisects"))

    @property
    def faults_injected(self) -> int:
        return self._counter_total("faults_injected")

    # ------------------------------------------------------------------ #
    # Submission
    # ------------------------------------------------------------------ #
    def submit(self, query: TrussQuery) -> TrussFuture:
        """Assign (bucket + backend) and enqueue one declarative query."""
        with self.obs.activate():
            state = self.planner.assign(query)
        fut = TrussFuture(self, state)
        with self._cv:
            self._futures[state.id] = fut
            self.queue.enqueue(state)
            depth = len(self.queue)
        self.obs.metrics.set_gauge("queue_depth", depth)
        return fut

    def solve(self, queries) -> list[Any]:
        """Submit ``queries``, lower everything queued through one
        :meth:`Planner.plan`, dispatch batch by batch, and return results
        in submission order."""
        queries = list(queries)
        with self.obs.activate(), self.obs.tracer.span("solve", queries=len(queries)):
            futs = [self.submit(q) for q in queries]
            with self._cv:
                states = self.queue.drain()
                self._inflight.update(st.id for st in states)
            now = obs_clock.now()
            plan = self.planner.plan(states)
            for batch in plan.batches:
                for st in batch.queries:
                    st.stats.queue_time_s = now - st.submitted_at
                    st.stats.batch_size = len(batch.queries)
                self._run_batch(batch)
            results = [f.result() for f in futs]
        self.obs.export_trace()  # no-op unless a trace path is configured
        return results

    def open_stream(
        self,
        g,
        trussness: np.ndarray | None = None,
        *,
        cache_triangles: bool = True,
    ):
        """Open a :class:`repro_torch.stream.StreamingTrussSession` on this
        session (its triangle state and frontier on this session's device).

        Runs the initial full decompose through the ordinary batched path
        unless ``trussness`` is supplied; subsequent ``update()`` batches
        are frontier-bounded ``stream_update`` queries on this queue.
        """
        from ..stream.session import StreamingTrussSession  # lazy: no cycle

        return StreamingTrussSession(
            self, g, trussness=trussness, cache_triangles=cache_triangles
        )

    def executor_for(self, g):
        """The peel executor a query on ``g`` lowers onto, built on first
        use.  Needs a session-pinned backend (auto-rule sessions choose per
        query); exposes the executor's ``dispatches``/``host_syncs``."""
        if self.planner.backend is None:
            raise ValueError(
                "executor_for needs a session-pinned backend= (the auto "
                "rule chooses per query)"
            )
        bucket = bucket_for(g, chunk=self.planner.chunk)
        exe, _ = self.cache.get(
            bucket,
            self.planner.max_batch,
            self.planner.cache_variant(
                self.planner.backend, bucket, self.planner.max_batch
            ),
        )
        return exe

    # ------------------------------------------------------------------ #
    # Execution
    # ------------------------------------------------------------------ #
    def poll(self) -> int:
        """Run at most one micro-batch; returns how many queries resolved."""
        batch = self._form_batch()
        if not batch:
            return 0
        return self._run_batch(self._planned(batch))

    def queue_depth(self) -> int:
        """Pending-query count, read under the session lock."""
        with self._cv:
            return len(self.queue)

    def flush(self) -> int:
        """Drain the queue; returns how many queries resolved."""
        n = 0
        while self.queue_depth():
            n += self.poll()
        self.obs.export_trace()  # no-op unless a trace path is configured
        return n

    def drain(self, timeout_s: float | None = None) -> int:
        """Serve everything pending to completion — the serving tier's
        pre-shutdown hook.  Flushes the queue, then waits out batches in
        flight on other threads (up to ``timeout_s``; ``None`` = until
        they resolve).  Returns how many queries this call resolved."""
        n = self.flush()
        deadline = (
            obs_clock.now() + timeout_s if timeout_s is not None else None
        )
        with self._cv:
            while self._inflight:
                if deadline is not None and obs_clock.now() >= deadline:
                    break
                self._cv.wait(timeout=0.05)
        return n

    def _form_batch(self, group=None) -> list[QueryState]:
        """Atomically dequeue one micro-batch and mark it in flight."""
        with self._cv:
            batch = self.queue.next_batch(group=group)
            self._inflight.update(st.id for st in batch)
        return batch

    def _planned(self, batch: list[QueryState]) -> PlannedBatch:
        """Wrap a queue-formed (single-group) batch for the planner."""
        return PlannedBatch(
            bucket=batch[0].bucket,
            backend=batch[0].backend,
            queries=batch,
            slots=self.planner.max_batch,
        )

    def _dispatch_once(self, planned: PlannedBatch) -> list[Any]:
        """One attempt at one packed dispatch (the runner's retry unit).

        Activates the session's obs sinks and fault plan around the
        planner, and counts the per-dispatch serving metrics only on
        success — a retried dispatch is one dispatch, not two.
        """
        ctx = contextlib.ExitStack()
        ctx.enter_context(self.obs.activate())
        if self.faults is not None:
            ctx.enter_context(use_plan(self.faults))
        with ctx:
            results = self.planner.execute(planned, self.cache)
        batch = planned.queries
        m = self.obs.metrics
        m.inc("device_seconds_total", batch[0].stats.device_time_s)
        m.inc("dispatches")
        m.inc("batches_run")
        m.inc("requests_served", len(batch))
        m.observe(
            "batch_occupancy",
            len(batch) / planned.slots,
            buckets=(0.125, 0.25, 0.5, 0.75, 1.0),
        )
        return results

    def _shed(self, state: QueryState, err: BaseException) -> None:
        """Mark a timed-out query dead: reclaim its queue slot, fail its
        future, count the shed."""
        with self._cv:
            self.queue.discard(state)
            fut = self._futures.pop(state.id, None)
            self._inflight.discard(state.id)
            if fut is not None:
                fut._fail(err)
            depth = len(self.queue)
            self._cv.notify_all()
        self.obs.metrics.inc("queries_shed")
        self.obs.metrics.set_gauge("queue_depth", depth)

    def _run_batch(self, planned: PlannedBatch) -> int:
        batch = planned.queries
        # The batch was already dequeued, so its futures must always end
        # up resolved or failed.  The runner turns member/device/compile
        # faults into per-query outcomes (quarantine, retry, fallback,
        # bisect; a hand kernel's own fault fails the batch at once);
        # anything non-taxonomy still fails everyone and propagates.
        try:
            outcomes = self.runner.run(planned)
        except Exception as e:
            with self._cv:
                for st in batch:
                    fut = self._futures.pop(st.id, None)
                    self._inflight.discard(st.id)
                    if fut is not None:
                        fut._fail(e)
                self._cv.notify_all()
            raise
        m = self.obs.metrics
        with self._cv:
            for out in outcomes:
                fut = self._futures.pop(out.state.id, None)
                self._inflight.discard(out.state.id)
                if fut is None:
                    continue  # shed mid-flight: its future already failed
                if out.ok:
                    fut._resolve(out.result)
                else:
                    m.inc("queries_failed")
                    fut._fail(out.error)
            depth = len(self.queue)
            self._cv.notify_all()
        m.set_gauge("queue_depth", depth)
        return len(batch)

    def _record_deadline_miss(self, state: QueryState, waited_s: float) -> None:
        self.obs.metrics.inc("deadline_misses")
        self.obs.tracer.instant(
            "deadline-miss",
            query=state.id,
            workload=state.query.workload,
            waited_s=round(waited_s, 6),
        )

    # ------------------------------------------------------------------ #
    # Observability
    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Serving counters — a view over ``self.obs.metrics``."""
        return {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "device_dispatches": self.device_dispatches,
            "deadline_misses": self.deadline_misses,
            "pending": self.queue_depth(),
            "device_time_s": round(self.device_time_s, 6),
            "retries": self.retries,
            "backend_fallbacks": self.backend_fallbacks,
            "queries_quarantined": self.queries_quarantined,
            "batch_bisects": self.batch_bisects,
            "queries_failed": self.queries_failed,
            "queries_shed": self.queries_shed,
            "faults_injected": self.faults_injected,
            **{f"cache_{k}": v for k, v in self.cache.stats.row().items()},
            **{f"planner_{k}": v for k, v in self.planner.stats().items()},
        }

    def metrics_snapshot(self) -> dict:
        """JSON snapshot of this session's metrics registry."""
        return self.obs.metrics_snapshot()

    def prometheus_text(self) -> str:
        """Prometheus text exposition of this session's metrics."""
        return self.obs.prometheus_text()

    def export_trace(self, path: str | None = None) -> str | None:
        """Write the session's Chrome trace JSON (see ``Session(trace=)``)."""
        return self.obs.export_trace(path)


def solve(queries, **session_kwargs) -> Any:
    """One-shot front door: lower and run a set of declarative queries.

    ``queries`` is a :class:`TrussQuery` or an iterable of them; results
    come back in submission order (a lone query returns its lone result).
    Session knobs (``device=``, ``backend=``, ``max_batch=``, ``trace=``,
    ...) pass through — see :class:`Session`.  ``device`` defaults to CUDA.
    """
    single = isinstance(queries, TrussQuery)
    qs = [queries] if single else list(queries)
    results = Session(**session_kwargs).solve(qs)
    return results[0] if single else results
