"""Replica worker: one process, one thread-safe ``Session``, one socket.

A replica is the fleet's unit of capacity and of failure.  It wraps one
:class:`repro_torch.api.Session` — on CUDA unless its config names another
device — behind the length-prefixed JSON RPC of
:mod:`repro_torch.serve.wire` (submit / result / health / drain / stream
ops), one handler thread per connection — which is exactly why ``Session``
is thread-safe: many router connections drive one batch former.  Each
replica process holds its own CUDA context; with one card, every replica
shares ``cuda:0``.

Design notes carried over from saxml-style model servers:

* **dummy-compute warmup on load** — the replica runs one throwaway
  ``decompose`` per configured warm graph spec *before* opening its
  port, so the first real request in those shape buckets hits a warm
  executor cache, with the kernel libraries already loaded (built once
  per checkout into ``kernels/_build/``), and the CUDA context up;
* **admission by queue depth** — ``max_live`` bounds unresolved queries;
  past it, submits are refused with a typed ``TrussTimeoutError``
  (``shed=True``) and counted in ``queries_shed``, giving the router a
  backpressure signal instead of an unbounded queue;
* **drain before death** — ``drain`` stops admission, finishes queued
  work, and checkpoints every streaming session, so planned restarts
  hand off warm.

Each :class:`HealthReport` carries the routing signals:
per-bucket compile-cache hits (bucket affinity's raw material), the
shed/failed/retry counters from the resilience layer, queue depth, and
the observed ``peel_batch_imbalance`` roll-up from ``repro_torch.obs``.

Run standalone with ``python -m repro_torch.serve.replica --config
cfg.json`` (the :class:`repro_torch.serve.fleet.Fleet` does this for you);
the chosen port is written atomically to ``config.port_file``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import threading
from typing import Any

import numpy as np

from ..errors import TrussError, TrussTimeoutError
from ..obs.peel_stats import imbalance_summary
from .wire import (
    WireError,
    decode_graph,
    decode_query,
    encode_error,
    encode_result,
    recv_msg,
    send_msg,
)

__all__ = ["ReplicaConfig", "HealthReport", "health_report", "Replica", "main"]

# Warm graph specs resolve against these generators only (the config file
# crosses a process boundary — never eval arbitrary callables from it).
_WARMUP_KINDS = ("erdos", "rmat", "barabasi", "road", "clustered")


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Everything a replica process needs, JSON-serializable.

    ``warmup`` is a list of ``{"kind": <generator>, ...kwargs}`` specs —
    one throwaway decompose per spec runs before the port opens.
    ``max_live`` is the admission bound (unresolved queries) past which
    submits shed.  ``checkpoint_root`` holds one subdirectory per
    streaming session (``<root>/<stream_id>/``) — on shared storage it is
    what makes warm handoff to a survivor possible.  ``device`` is where
    the replica's ``Session`` runs (``None`` = CUDA).
    """

    name: str = "replica"
    host: str = "127.0.0.1"
    port: int = 0  # 0 = OS-assigned; written to port_file
    port_file: str | None = None
    max_batch: int = 4
    chunk: int = 256
    backend: str | None = None
    cache_dir: str | None = None
    checkpoint_root: str | None = None
    checkpoint_every: int = 1
    max_live: int = 64
    warmup: tuple = ()
    device: str | None = None

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["warmup"] = list(self.warmup)
        return json.dumps(d)

    @classmethod
    def from_json(cls, text: str) -> "ReplicaConfig":
        d = json.loads(text)
        d["warmup"] = tuple(d.get("warmup", ()))
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """One replica's health/load snapshot (the router's routing signal)."""

    name: str
    queue_depth: int
    live_queries: int  # unresolved (queued or in flight)
    requests_served: int
    queries_shed: int
    queries_failed: int
    queries_quarantined: int
    retries: int
    warmup_queries: int
    draining: bool
    streams: tuple[str, ...]  # stream ids this replica owns
    compiled_buckets: tuple[str, ...]  # bucket labels with a warm executable
    cache_bucket_hits: dict  # bucket label -> compile-cache hits
    imbalance: tuple  # repro_torch.obs.imbalance_summary rows (dicts)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["streams"] = list(self.streams)
        d["compiled_buckets"] = list(self.compiled_buckets)
        d["imbalance"] = [dict(r) for r in self.imbalance]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HealthReport":
        d = dict(d)
        d["streams"] = tuple(d.get("streams", ()))
        d["compiled_buckets"] = tuple(d.get("compiled_buckets", ()))
        d["imbalance"] = tuple(d.get("imbalance", ()))
        return cls(**d)


def health_report(
    session,
    *,
    name: str = "replica",
    live_queries: int = 0,
    warmup_queries: int = 0,
    draining: bool = False,
    streams: tuple[str, ...] = (),
) -> HealthReport:
    """Build a :class:`HealthReport` from one ``Session``'s counters.

    Pure read of the session's metrics registry — the shed/quarantine
    accounting a report carries is exactly ``session.stats()``'s, so the
    roundtrip test can assert them equal.
    """
    snap = session.obs.metrics.snapshot()["counters"]
    prefix = "cache_bucket_hits{bucket="
    bucket_hits = {
        k[len(prefix):-1]: int(v)
        for k, v in snap.items()
        if k.startswith(prefix)
    }
    return HealthReport(
        name=name,
        queue_depth=session.queue_depth(),
        live_queries=int(live_queries),
        requests_served=session.requests_served,
        queries_shed=session.queries_shed,
        queries_failed=session.queries_failed,
        queries_quarantined=session.queries_quarantined,
        retries=session.retries,
        warmup_queries=int(warmup_queries),
        draining=bool(draining),
        streams=tuple(streams),
        compiled_buckets=tuple(session.cache.buckets()),
        cache_bucket_hits=bucket_hits,
        imbalance=tuple(imbalance_summary(session.obs.metrics)),
    )


def _warm_graph(spec: dict):
    from .. import graphs

    spec = dict(spec)
    kind = spec.pop("kind", None)
    if kind not in _WARMUP_KINDS:
        raise ValueError(
            f"unknown warmup generator {kind!r}; expected one of {_WARMUP_KINDS}"
        )
    return getattr(graphs, kind)(**spec)


class Replica:
    """The serving loop: accept connections, drive one shared Session."""

    def __init__(self, config: ReplicaConfig, *, session=None):
        from ..api.session import Session  # lazy: torch import is heavy

        self.config = config
        self.session = session or Session(
            device=config.device,
            max_batch=config.max_batch,
            chunk=config.chunk,
            backend=config.backend,
            cache_dir=config.cache_dir,
        )
        self.warmup_queries = 0
        self._live_lock = threading.Lock()
        self._live = 0  # unresolved queries (admission control); guarded-by: _live_lock
        self._futures_lock = threading.Lock()
        self._futures: dict[int, Any] = {}  # guarded-by: _futures_lock
        # _stream_lock guards map membership AND the per-stream sequence
        # numbers; the per-stream locks in _stream_locks serialize the
        # device work of one stream's updates without blocking the rest.
        self._stream_lock = threading.Lock()
        self._streams: dict[str, Any] = {}  # guarded-by: _stream_lock
        self._stream_seq: dict[str, int] = {}  # guarded-by: _stream_lock
        self._stream_locks: dict[str, threading.Lock] = {}  # guarded-by: _stream_lock
        self._draining = False  # monotonic latch; racy reads only delay the cutover
        self._stop = threading.Event()
        self._sock: socket.socket | None = None

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def warm(self) -> int:
        """Dummy-compute warmup: one throwaway decompose per warm spec, so
        the matching buckets' executables are compiled before traffic."""
        from ..api.query import TrussQuery

        for spec in self.config.warmup:
            g = _warm_graph(dict(spec))
            self.session.submit(TrussQuery.decompose(g)).result(timeout=None)
            self.warmup_queries += 1
        return self.warmup_queries

    def bind(self) -> int:
        """Open the listening socket (after warmup) and publish the port."""
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.config.host, self.config.port))
        self._sock.listen(64)
        port = self._sock.getsockname()[1]
        if self.config.port_file:
            tmp = self.config.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, self.config.port_file)
        return port

    def serve_forever(self) -> None:
        assert self._sock is not None, "bind() first"
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            t.start()
        with contextlib.suppress(OSError):
            self._sock.close()

    def stop(self) -> None:
        self._stop.set()

    # ------------------------------------------------------------------ #
    # Per-connection handler
    # ------------------------------------------------------------------ #
    def _serve_conn(self, conn: socket.socket) -> None:
        with contextlib.suppress(WireError, OSError), conn:
            while not self._stop.is_set():
                msg = recv_msg(conn)
                if msg is None:
                    return
                try:
                    reply = self._handle(msg)
                except TrussError as e:
                    reply = encode_error(e)
                except Exception as e:  # a handler bug must not kill the loop
                    reply = encode_error(e)
                send_msg(conn, reply)

    def _handle(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "submit":
            return self._op_submit(msg)
        if op == "result":
            return self._op_result(msg)
        if op == "health":
            return {"health": self.health().to_dict()}
        if op == "drain":
            return {"drained": self.drain()}
        if op == "open_stream":
            return self._op_open_stream(msg)
        if op == "restore_stream":
            return self._op_restore_stream(msg)
        if op == "stream_update":
            return self._op_stream_update(msg)
        if op == "shutdown":
            self.stop()
            return {"ok": True}
        raise ValueError(f"unknown op {op!r}")

    # -- queries -------------------------------------------------------- #
    def _op_submit(self, msg: dict) -> dict:
        if self._draining:
            raise TrussTimeoutError(
                f"replica {self.config.name} is draining", shed=True
            )
        with self._live_lock:
            if self._live >= self.config.max_live:
                # Admission control: past max_live the replica sheds at
                # the door — the router reads queries_shed and backs off.
                self.session.obs.metrics.inc("queries_shed")
                raise TrussTimeoutError(
                    f"replica {self.config.name} at max_live="
                    f"{self.config.max_live}; query shed",
                    queue_depth=self.session.queue_depth(),
                    shed=True,
                )
            self._live += 1
        try:
            fut = self.session.submit(decode_query(msg["query"]))
        except BaseException:
            with self._live_lock:
                self._live -= 1
            raise
        with self._futures_lock:
            self._futures[fut.request.id] = fut
        return {"qid": fut.request.id}

    def _op_result(self, msg: dict) -> dict:
        qid = int(msg["qid"])
        with self._futures_lock:
            fut = self._futures.pop(qid, None)
        if fut is None:
            raise KeyError(f"unknown or already-collected qid {qid}")
        try:
            result = fut.result(timeout=msg.get("timeout"))
        except BaseException:
            with self._live_lock:
                self._live -= 1
            raise
        with self._live_lock:
            self._live -= 1
        return {"result": encode_result(result)}

    # -- streams -------------------------------------------------------- #
    def _stream_dir(self, stream_id: str) -> str:
        root = self.config.checkpoint_root
        if root is None:
            raise ValueError(
                "streaming needs a checkpoint_root (warm handoff has "
                "nowhere to write)"
            )
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in stream_id)
        return os.path.join(root, safe)

    def _stream_state(self, stream) -> dict:
        t = np.asarray(stream.trussness, np.int32)
        return {
            "trussness": encode_result(t)["trussness"],
            "kmax": int(stream.kmax),
        }

    def _op_open_stream(self, msg: dict) -> dict:
        sid = str(msg["stream_id"])
        g = decode_graph(msg["graph"])
        d = self._stream_dir(sid)
        os.makedirs(d, exist_ok=True)
        stream = self.session.open_stream(g)
        stream.checkpoint_dir = d
        stream.checkpoint_every = int(
            msg.get("checkpoint_every", self.config.checkpoint_every)
        )
        # Checkpoint the initial state so a crash before the first update
        # still hands off warm.
        stream._auto_checkpoint()
        with self._stream_lock:
            self._streams[sid] = stream
            self._stream_seq[sid] = 0
            self._stream_locks[sid] = threading.Lock()
        return {"stream_id": sid, "seq": 0, **self._stream_state(stream)}

    def _op_restore_stream(self, msg: dict) -> dict:
        from ..resilience.checkpoint import latest_checkpoint
        from ..stream.session import StreamingTrussSession

        sid = str(msg["stream_id"])
        d = self._stream_dir(sid)
        path = latest_checkpoint(d)
        if path is None:
            raise FileNotFoundError(f"no checkpoint for stream {sid!r} in {d}")
        stream = StreamingTrussSession.restore(
            path,
            session=self.session,
            checkpoint_dir=d,
            checkpoint_every=int(
                msg.get("checkpoint_every", self.config.checkpoint_every)
            ),
        )
        with self._stream_lock:
            self._streams[sid] = stream
            seq = self._stream_seq[sid] = stream.updates_total
            self._stream_locks[sid] = threading.Lock()
        return {
            "stream_id": sid,
            "seq": seq,
            **self._stream_state(stream),
        }

    def _op_stream_update(self, msg: dict) -> dict:
        from .wire import decode_array
        from ..stream.delta import EdgeBatch

        sid = str(msg["stream_id"])
        seq = int(msg["seq"])
        with self._stream_lock:
            stream = self._streams.get(sid)
            lock = self._stream_locks.get(sid)
        if stream is None:
            raise KeyError(f"replica does not own stream {sid!r}")
        # Per-stream lock: updates on one stream serialize (deltas are
        # relative to the committed graph) without blocking health polls
        # or other streams behind a device dispatch.  The sequence map
        # itself stays under _stream_lock — one guard per attribute, not
        # one per path (the R3 lint checks exactly this).
        with lock:
            with self._stream_lock:
                applied = self._stream_seq[sid]
            if seq <= applied:
                # Idempotent replay: the update committed (and was
                # checkpointed) but the ack was lost — re-acking the
                # committed state keeps retries exactly-once.
                return {
                    "stream_id": sid,
                    "seq": applied,
                    "replayed": True,
                    **self._stream_state(stream),
                }
            if seq != applied + 1:
                raise ValueError(
                    f"stream {sid!r} expects seq {applied + 1}, got {seq}"
                )
            batch = EdgeBatch(
                decode_array(msg["inserts"]).reshape(-1, 2),
                decode_array(msg["deletes"]).reshape(-1, 2),
            )
            res = stream.update(batch)
            with self._stream_lock:
                self._stream_seq[sid] = seq
            return {
                "stream_id": sid,
                "seq": seq,
                "frontier_size": res.frontier_size,
                "dispatches": res.dispatches,
                **self._stream_state(stream),
            }

    # -- health / drain -------------------------------------------------- #
    def health(self) -> HealthReport:
        with self._stream_lock:
            streams = tuple(sorted(self._streams))
        with self._live_lock:
            live = self._live
        return health_report(
            self.session,
            name=self.config.name,
            live_queries=live,
            warmup_queries=self.warmup_queries,
            draining=self._draining,
            streams=streams,
        )

    def drain(self) -> int:
        """Stop admission, run everything queued, checkpoint every stream."""
        self._draining = True
        n = self.session.drain()
        with self._stream_lock:
            streams = list(self._streams.values())
        for stream in streams:
            if stream.checkpoint_dir is not None:
                stream._auto_checkpoint()
        return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="repro_torch.serve replica worker")
    parser.add_argument("--config", required=True, help="ReplicaConfig JSON file")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = ReplicaConfig.from_json(f.read())
    replica = Replica(config)
    replica.warm()
    replica.bind()
    replica.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
