"""Bucket-affinity router: the fleet's load balancer.

The paper's problem — one slow lane starves the warp — reappears across
replicas: naive round-robin sends a bucket's traffic to replicas that
never built it (a cold executor build on the request path) and keeps
feeding a replica already pinned on a slow bucket.  The router fixes both
the way the planner fixes slot imbalance, with observed stats instead of
static structure:

* **bucket affinity** — each shape bucket has a *home* replica (the one
  that already compiled it, learned from health reports or first
  assignment); same-bucket traffic goes home, so executables compile once
  per bucket per fleet instead of once per replica.
* **EDF spillover** — when the home replica's in-flight depth crosses
  ``spill_depth``, traffic spills to the least-loaded healthy replica.
  :meth:`route_many` routes earliest-deadline-first, so when capacity is
  scarce the urgent queries grab the spare replicas (the batch former's
  EDF rule, one level up).
* **load shedding** — when *every* healthy replica is at ``shed_depth``
  the router sheds at the door through the existing typed path: a
  :class:`~repro_torch.errors.TrussTimeoutError` with ``shed=True``, counted as
  ``router_queries_shed``.
* **quarantine** — a replica that fails a health poll (or errors on RPC)
  is quarantined: removed from routing, its bucket homes redistributed to
  survivors that have the bucket warm, its streams reported to the
  :class:`~repro_torch.serve.fleet.Fleet` for warm handoff.

Metrics: the router owns a registry; each replica gets a child registry
chained to it, so per-replica series stay isolated while the router's
aggregate sees everything (the same parent-chaining ``repro_torch.obs`` uses
for sessions).  Remote counters from health reports are mirrored in via
:meth:`~repro_torch.obs.MetricsRegistry.ingest`.
"""

from __future__ import annotations

import socket
import threading

from ..api.cache import bucket_for, bucket_str
from ..errors import DeviceError, QueryFailedError, TrussTimeoutError
from ..obs import MetricsRegistry, get_registry
from ..obs import clock as obs_clock
from ..resilience.faults import inject
from .replica import HealthReport
from .wire import raise_remote_error, recv_msg, send_msg

__all__ = ["ReplicaHandle", "RoutedQuery", "Router"]


class ReplicaHandle:
    """Client side of one replica's RPC socket (thread-safe, one frame in
    flight per connection; concurrent callers serialize on the lock)."""

    def __init__(self, name: str, host: str, port: int, *, timeout_s: float = 60.0):
        self.name = name
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        # io-lock: held regions deliberately do socket IO — one frame in
        # flight per connection is the serialization this lock provides.
        self._lock = threading.Lock()  # trusslint: io-lock
        self._sock: socket.socket | None = None  # guarded-by: _lock

    def connect(self) -> None:
        with self._lock:
            self._connect_locked()

    def _connect_locked(self) -> None:  # requires-lock: _lock
        if self._sock is not None:
            return
        s = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                finally:
                    self._sock = None

    def rpc(self, msg: dict, *, timeout_s: float | None = None) -> dict:
        """One request/response frame; remote errors re-raise typed.

        Connection-level failures surface as ``ConnectionError`` (the
        router's quarantine signal); the ``network`` fault site lets the
        chaos storm fire them deterministically.
        """
        inject("network", replica=self.name, op=msg.get("op"))
        with self._lock:
            try:
                self._connect_locked()
                assert self._sock is not None
                self._sock.settimeout(
                    timeout_s if timeout_s is not None else self.timeout_s
                )
                send_msg(self._sock, msg)
                reply = recv_msg(self._sock)
            except (ConnectionError, socket.timeout, OSError) as e:
                # A dead connection is not retryable on this socket; drop
                # it so a later attempt reconnects (post-restart).
                if self._sock is not None:
                    try:
                        self._sock.close()
                    finally:
                        self._sock = None
                raise ConnectionError(
                    f"replica {self.name} rpc {msg.get('op')!r} failed: {e}"
                ) from e
        if reply is None:
            self.close()
            raise ConnectionError(
                f"replica {self.name} closed during {msg.get('op')!r}"
            )
        if "error" in reply:
            raise_remote_error(reply)
        return reply

    # Typed convenience wrappers ---------------------------------------- #
    def ping(self) -> bool:
        return bool(self.rpc({"op": "ping"}).get("ok"))

    def submit(self, qmsg: dict) -> int:
        return int(self.rpc({"op": "submit", "query": qmsg})["qid"])

    def result(self, qid: int, *, timeout_s: float | None = None) -> dict:
        # The socket wait must outlive the query's own budget, so the
        # replica's typed TrussTimeoutError wins over a raw socket timeout.
        sock_timeout = None if timeout_s is None else timeout_s + self.timeout_s
        return self.rpc(
            {"op": "result", "qid": qid, "timeout": timeout_s},
            timeout_s=sock_timeout,
        )["result"]

    def health(self) -> HealthReport:
        return HealthReport.from_dict(self.rpc({"op": "health"})["health"])

    def drain(self) -> int:
        return int(self.rpc({"op": "drain"}, timeout_s=None)["drained"])

    def shutdown(self) -> None:
        self.rpc({"op": "shutdown"})


class RoutedQuery:
    """One routed submission: which replica, which bucket, which qid."""

    __slots__ = ("replica", "qid", "bucket", "affine")

    def __init__(self, replica: ReplicaHandle, qid: int, bucket: str, affine: bool):
        self.replica = replica
        self.qid = qid
        self.bucket = bucket
        self.affine = affine  # did it land on the bucket's home replica


class Router:
    """N-replica front door: affinity routing + spillover + shed + quarantine."""

    def __init__(
        self,
        replicas: list[ReplicaHandle],
        *,
        chunk: int = 256,
        spill_depth: int = 4,
        shed_depth: int = 32,
        max_health_fails: int = 1,
        metrics: MetricsRegistry | None = None,
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.chunk = int(chunk)
        self.spill_depth = int(spill_depth)
        self.shed_depth = int(shed_depth)
        self.max_health_fails = int(max_health_fails)
        self.metrics = MetricsRegistry(
            parent=metrics if metrics is not None else get_registry()
        )
        self._lock = threading.RLock()
        self._replicas: dict[str, ReplicaHandle] = {}  # guarded-by: _lock
        self._replica_metrics: dict[str, MetricsRegistry] = {}  # guarded-by: _lock
        self._affinity: dict[str, str] = {}  # bucket label -> replica name; guarded-by: _lock
        self._quarantined: set[str] = set()  # guarded-by: _lock
        self._inflight: dict[str, int] = {}  # guarded-by: _lock
        self._health_fails: dict[str, int] = {}  # guarded-by: _lock
        self._last_health: dict[str, HealthReport] = {}  # guarded-by: _lock
        with self._lock:
            for r in replicas:
                self._register(r)

    def _register(self, handle: ReplicaHandle) -> None:  # requires-lock: _lock
        self._replicas[handle.name] = handle
        # Chained per-replica registry: replica-scoped series roll up into
        # the router's aggregate exactly like session registries roll up
        # into the process-global one.
        self._replica_metrics[handle.name] = MetricsRegistry(parent=self.metrics)
        self._inflight.setdefault(handle.name, 0)
        self._health_fails[handle.name] = 0

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #
    @property
    def replica_names(self) -> tuple[str, ...]:
        with self._lock:
            return tuple(self._replicas)

    def healthy(self) -> list[ReplicaHandle]:
        with self._lock:
            return [
                h for n, h in self._replicas.items() if n not in self._quarantined
            ]

    def is_quarantined(self, name: str) -> bool:
        with self._lock:
            return name in self._quarantined

    def last_health(self, name: str) -> HealthReport | None:
        with self._lock:
            return self._last_health.get(name)

    def depth(self, name: str) -> int:
        with self._lock:
            return self._inflight.get(name, 0)

    def stats(self) -> dict:
        m = self.metrics
        hits = int(m.value("router_affinity_hits"))
        spills = int(m.value("router_spillovers"))
        cold = int(m.value("router_affinity_cold"))
        routed = hits + spills + cold
        with self._lock:
            quarantined = sorted(self._quarantined)
            affinity = dict(sorted(self._affinity.items()))
        return {
            "routed": routed,
            "affinity_hits": hits,
            "spillovers": spills,
            "cold_assignments": cold,
            "affinity_hit_rate": round(hits / routed, 4) if routed else 0.0,
            "queries_shed": int(m.value("router_queries_shed")),
            "replicas_quarantined": int(m.value("router_replicas_quarantined")),
            "quarantined": quarantined,
            "affinity": affinity,
        }

    # ------------------------------------------------------------------ #
    # Routing
    # ------------------------------------------------------------------ #
    def bucket_of(self, query) -> str:
        return bucket_str(bucket_for(query.graph, chunk=self.chunk))

    def _least_loaded(self, exclude: set[str] = frozenset()) -> str | None:  # requires-lock: _lock
        candidates = [
            (self._inflight.get(n, 0), i, n)
            for i, n in enumerate(self._replicas)
            if n not in self._quarantined and n not in exclude
        ]
        return min(candidates)[2] if candidates else None

    def _warm_owner(self, bucket: str) -> str | None:  # requires-lock: _lock
        """A healthy replica whose last health report shows ``bucket``
        already compiled (affinity learned from observed state)."""
        for name, report in self._last_health.items():
            if name in self._quarantined:
                continue
            if bucket in report.compiled_buckets:
                return name
        return None

    def pick(self, bucket: str) -> tuple[ReplicaHandle, bool]:
        """Choose a replica for one ``bucket``-keyed query.

        Returns ``(handle, affine)`` where ``affine`` says the query
        landed on the bucket's home replica.  Raises
        :class:`TrussTimeoutError` (``shed=True``) when every healthy
        replica is at ``shed_depth``, and :class:`QueryFailedError` when
        none is healthy at all.
        """
        with self._lock:
            if len(self._quarantined) >= len(self._replicas):
                raise QueryFailedError("no healthy replicas in the fleet")
            floor = min(
                self._inflight.get(n, 0)
                for n in self._replicas
                if n not in self._quarantined
            )
            if floor >= self.shed_depth:
                self.metrics.inc("router_queries_shed")
                raise TrussTimeoutError(
                    f"fleet saturated (every healthy replica at depth >= "
                    f"{self.shed_depth}); query shed",
                    queue_depth=floor,
                    shed=True,
                )
            home = self._affinity.get(bucket)
            if home is not None and home in self._quarantined:
                home = None
            if home is None:
                # Cold bucket: adopt a replica that already compiled it
                # (post-restart / learned from health), else least-loaded.
                home = self._warm_owner(bucket) or self._least_loaded()
                self._affinity[bucket] = home
                self.metrics.inc("router_affinity_cold")
                self._inflight[home] += 1
                return self._replicas[home], False
            if self._inflight.get(home, 0) >= self.spill_depth:
                spill = self._least_loaded(exclude={home})
                if spill is not None and self._inflight[spill] < self._inflight[home]:
                    self.metrics.inc("router_spillovers")
                    self._replica_metrics[spill].inc(
                        "router_replica_spill_in", replica=spill
                    )
                    self._inflight[spill] += 1
                    return self._replicas[spill], False
            self.metrics.inc("router_affinity_hits")
            self._inflight[home] += 1
            return self._replicas[home], True

    def release(self, name: str) -> None:
        """One routed query resolved (or failed): free its depth slot."""
        with self._lock:
            self._inflight[name] = max(0, self._inflight.get(name, 0) - 1)

    def submit(self, query, qmsg: dict) -> RoutedQuery:
        """Route and submit one encoded query; replica failures quarantine
        and re-route until a healthy replica accepts (or none is left)."""
        bucket = self.bucket_of(query)
        while True:
            handle, affine = self.pick(bucket)
            try:
                qid = handle.submit(qmsg)
            except (ConnectionError, DeviceError) as e:
                self.release(handle.name)
                self.mark_failed(handle.name, reason=str(e))
                continue
            except TrussTimeoutError:
                # The replica shed at its own door (admission control) —
                # its health poll will rebalance; propagate the shed.
                self.release(handle.name)
                raise
            return RoutedQuery(handle, qid, bucket, affine)

    def route_many(self, queries: list) -> list[int]:
        """EDF routing order for a batch: earliest absolute deadline
        first, submission order among undeadlined queries.  Returns the
        order's indices — the caller submits in that order so urgent
        queries grab spare capacity first."""
        now = obs_clock.now()

        def urgency(iq):
            i, q = iq
            d = q.deadline_s
            return (now + d if d is not None else float("inf"), i)

        return [i for i, _ in sorted(enumerate(queries), key=urgency)]

    # ------------------------------------------------------------------ #
    # Health and quarantine
    # ------------------------------------------------------------------ #
    def poll_health(self) -> dict[str, HealthReport]:
        """Poll every non-quarantined replica; failures count toward
        quarantine.  Returns the reports that succeeded."""
        reports: dict[str, HealthReport] = {}
        with self._lock:
            targets = [
                (n, h)
                for n, h in self._replicas.items()
                if n not in self._quarantined
            ]
        # The RPCs themselves run unlocked — a slow replica's health poll
        # must not stall routing decisions on the lock.
        for name, handle in targets:
            try:
                report = handle.health()
            except (ConnectionError, DeviceError) as e:
                self.mark_failed(name, reason=str(e))
                continue
            reports[name] = report
            with self._lock:
                self._health_fails[name] = 0
                self._last_health[name] = report
                rm = self._replica_metrics[name]
            rm.set_gauge("replica_queue_depth", report.queue_depth, replica=name)
            rm.set_gauge("replica_live_queries", report.live_queries, replica=name)
            rm.set_gauge(
                "replica_compiled_buckets",
                len(report.compiled_buckets),
                replica=name,
            )
            # Mirror the replica's own counters (shed/failed/retries, ...)
            # into its chained registry so the router-level aggregate has
            # the whole fleet's accounting in one snapshot.
            rm.ingest(
                {
                    "replica_requests_served": report.requests_served,
                    "replica_queries_shed": report.queries_shed,
                    "replica_queries_failed": report.queries_failed,
                    "replica_queries_quarantined": report.queries_quarantined,
                    "replica_retries": report.retries,
                },
                replica=name,
            )
        return reports

    def mark_failed(self, name: str, *, reason: str = "") -> bool:
        """Record one health/RPC failure; quarantine past the threshold.
        Returns whether the replica is now quarantined."""
        with self._lock:
            if name in self._quarantined:
                return True
            self._health_fails[name] = self._health_fails.get(name, 0) + 1
            if self._health_fails[name] < self.max_health_fails:
                return False
        self.quarantine(name, reason=reason)
        return True

    def quarantine(self, name: str, *, reason: str = "") -> tuple[str, ...]:
        """Remove ``name`` from routing and redistribute its bucket homes.

        Returns the stream ids the replica owned per its last health
        report — the fleet restores those on survivors (warm handoff).
        """
        with self._lock:
            if name in self._quarantined:
                return ()
            self._quarantined.add(name)
            self.metrics.inc("router_replicas_quarantined")
            self._replica_metrics[name].inc(
                "router_quarantines", replica=name, reason=reason[:80] or "health"
            )
            self._inflight[name] = 0
            orphaned = [b for b, owner in self._affinity.items() if owner == name]
            for bucket in orphaned:
                heir = self._warm_owner(bucket) or self._least_loaded()
                if heir is None:
                    del self._affinity[bucket]
                else:
                    self._affinity[bucket] = heir
                    self.metrics.inc("router_affinity_redistributed")
            report = self._last_health.get(name)
            handle = self._replicas[name]
        # Socket teardown outside the routing lock: close() can block on
        # a dying peer, and pick()/poll_health() must not wait behind it.
        handle.close()
        return tuple(report.streams) if report is not None else ()

    def reinstate(self, name: str, handle: ReplicaHandle | None = None) -> None:
        """Bring a (restarted) replica back into routing."""
        with self._lock:
            if handle is not None:
                handle.name = name
                self._replicas[name] = handle
                self._replica_metrics.setdefault(
                    name, MetricsRegistry(parent=self.metrics)
                )
            self._quarantined.discard(name)
            self._health_fails[name] = 0
            self._inflight[name] = 0
            self._last_health.pop(name, None)

    def close(self) -> None:
        with self._lock:
            handles = list(self._replicas.values())
        for handle in handles:
            handle.close()
