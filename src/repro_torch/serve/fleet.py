"""Fleet: replica process lifecycle + warm handoff of streaming sessions.

The :class:`Fleet` owns N replica worker processes (each running
``python -m repro_torch.serve.replica``, started by ``subprocess.Popen`` —
a fresh interpreter, never a fork, so a parent that already holds a CUDA
context is safe) and the :class:`~repro_torch.serve.router.Router` in
front of them.  Its jobs:

* **spawn** — write each replica's :class:`ReplicaConfig` JSON, launch
  the process, and wait for the atomic ``port_file`` handshake (the
  replica publishes its port only *after* dummy-compute warmup, so a
  replica is routable exactly when its executor cache is warm);
* **monitor** — :meth:`monitor_once` reaps dead processes, polls health
  through the router (which quarantines unresponsive replicas), and
  services the ``replica_kill`` fault site so the chaos storm can kill
  replicas deterministically (``REPRO_FAULTS="replica_kill:times=1"``);
* **warm handoff** — every replica shares one ``checkpoint_root``, and
  streaming sessions auto-checkpoint at update boundaries.  When
  a stream's owner dies, :meth:`recover_stream` restores it on a
  survivor from the newest checkpoint — the restored stream continues
  bit-identically, and the replica's idempotent seq replay keeps a
  retried update exactly-once across the handoff;
* **restart** — a killed/crashed replica is respawned (bounded by
  ``max_restarts``) and reinstated into routing; the kernel libraries
  built once per checkout make the comeback skip ``nvcc``.

Everything is local-process by design (the wire protocol is the only
coupling), so the integration tests exercise real process death, not a
simulation of it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import threading
import time

from ..errors import DeviceError, QueryFailedError
from ..resilience.faults import FaultPlan, inject, use_plan
from .replica import ReplicaConfig
from .router import ReplicaHandle, Router
from .wire import encode_graph

__all__ = ["ManagedReplica", "Fleet"]

_SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class ManagedReplica:
    """One replica process under fleet management."""

    def __init__(self, config: ReplicaConfig, workdir: str):
        self.config = config
        self.workdir = workdir
        self.process: subprocess.Popen | None = None
        self.handle: ReplicaHandle | None = None
        self.restarts = 0
        self.stopped = False  # deliberately shut down (don't restart)

    @property
    def name(self) -> str:
        return self.config.name

    def alive(self) -> bool:
        return self.process is not None and self.process.poll() is None

    def log_tail(self, lines: int = 20) -> str:
        path = os.path.join(self.workdir, "log.txt")
        try:
            with open(path, errors="replace") as f:
                return "".join(f.readlines()[-lines:])
        except OSError:
            return "<no log>"


class Fleet:
    """Spawn, monitor, and restart a fleet of replica workers.

    ``size`` replicas share one ``checkpoint_root`` (warm handoff needs a
    common view of the checkpoints) and, when ``cache_dir`` is set, one
    autotune store.  ``device`` is handed to every replica's config
    (``None`` = CUDA; ``"cpu"`` for the CPU).  ``warmup`` specs are
    distributed round-robin so the fleet collectively pre-builds every
    expected bucket without every replica paying every build; pass
    ``warmup_all=True`` to give every replica the full list instead.

    Use as a context manager, or call :meth:`start` / :meth:`shutdown`.
    """

    def __init__(
        self,
        size: int = 3,
        *,
        workdir: str,
        max_batch: int = 4,
        chunk: int = 256,
        backend: str | None = None,
        cache_dir: str | None = None,
        checkpoint_every: int = 1,
        max_live: int = 64,
        warmup: tuple = (),
        warmup_all: bool = False,
        spill_depth: int = 4,
        shed_depth: int = 32,
        max_restarts: int = 2,
        auto_restart: bool = True,
        faults: FaultPlan | None = None,
        python: str | None = None,
        device: str | None = None,
    ):
        if size < 1:
            raise ValueError("a fleet needs at least one replica")
        self.workdir = os.path.abspath(workdir)
        self.checkpoint_root = os.path.join(self.workdir, "checkpoints")
        self.max_restarts = int(max_restarts)
        self.auto_restart = bool(auto_restart)
        self.faults = faults if faults is not None else FaultPlan.from_env()
        self.python = python or sys.executable
        self.router: Router | None = None
        self._spill_depth = int(spill_depth)
        self._shed_depth = int(shed_depth)
        self._lock = threading.RLock()
        self._stream_owner: dict[str, str] = {}
        self._replicas: dict[str, ManagedReplica] = {}
        warmup = tuple(warmup)
        for i in range(size):
            name = f"replica-{i}"
            rdir = os.path.join(self.workdir, name)
            per_warm = (
                warmup if warmup_all else tuple(warmup[i::size])
            )
            cfg = ReplicaConfig(
                name=name,
                port_file=os.path.join(rdir, "port"),
                max_batch=max_batch,
                chunk=chunk,
                backend=backend,
                cache_dir=cache_dir,
                checkpoint_root=self.checkpoint_root,
                checkpoint_every=checkpoint_every,
                max_live=max_live,
                warmup=per_warm,
                device=device,
            )
            self._replicas[name] = ManagedReplica(cfg, rdir)

    # ------------------------------------------------------------------ #
    # Lifecycle
    # ------------------------------------------------------------------ #
    def __enter__(self) -> "Fleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def start(self, timeout_s: float = 120.0) -> "Fleet":
        """Spawn every replica, wait for all port handshakes, build the
        router.  Replicas warm up in parallel (separate processes)."""
        os.makedirs(self.checkpoint_root, exist_ok=True)
        deadline = time.monotonic() + timeout_s
        for mr in self._replicas.values():
            self._spawn(mr)
        handles = []
        for mr in self._replicas.values():
            port = self._await_port(mr, deadline)
            mr.handle = ReplicaHandle(mr.name, mr.config.host, port)
            handles.append(mr.handle)
        self.router = Router(
            handles,
            chunk=next(iter(self._replicas.values())).config.chunk,
            spill_depth=self._spill_depth,
            shed_depth=self._shed_depth,
        )
        # Seed bucket affinity from what each replica actually warmed.
        self.router.poll_health()
        return self

    def _spawn(self, mr: ManagedReplica) -> None:
        os.makedirs(mr.workdir, exist_ok=True)
        with contextlib.suppress(OSError):
            os.unlink(mr.config.port_file)
        cfg_path = os.path.join(mr.workdir, "config.json")
        with open(cfg_path, "w") as f:
            f.write(mr.config.to_json())
        env = dict(os.environ)
        env["PYTHONPATH"] = _SRC_DIR + os.pathsep + env.get("PYTHONPATH", "")
        # A replica must never inherit the fleet's chaos plan — faults
        # against replicas are the *fleet's* to inject, not theirs.
        env.pop("REPRO_FAULTS", None)
        log = open(os.path.join(mr.workdir, "log.txt"), "ab")
        try:
            mr.process = subprocess.Popen(
                [self.python, "-m", "repro_torch.serve.replica", "--config", cfg_path],
                stdout=log,
                stderr=subprocess.STDOUT,
                env=env,
                cwd=mr.workdir,
            )
        finally:
            log.close()
        mr.stopped = False

    def _await_port(self, mr: ManagedReplica, deadline: float) -> int:
        while time.monotonic() < deadline:
            if mr.process is not None and mr.process.poll() is not None:
                raise QueryFailedError(
                    f"replica {mr.name} exited with code "
                    f"{mr.process.returncode} during startup:\n{mr.log_tail()}"
                )
            try:
                with open(mr.config.port_file) as f:
                    return int(f.read().strip())
            except (OSError, ValueError):
                time.sleep(0.05)
        raise QueryFailedError(
            f"replica {mr.name} did not publish a port in time:\n{mr.log_tail()}"
        )

    def kill(self, name: str) -> None:
        """Hard-kill one replica process (the chaos storm's hammer)."""
        mr = self._replicas[name]
        if mr.process is not None and mr.process.poll() is None:
            mr.process.kill()
            mr.process.wait(timeout=10)
        if self.router is not None:
            self._orphans_of(name, self.router.quarantine(name, reason="killed"))

    def restart(self, name: str) -> None:
        """Respawn one replica and reinstate it into routing."""
        mr = self._replicas[name]
        if mr.process is not None and mr.process.poll() is None:
            mr.process.kill()
            mr.process.wait(timeout=10)
        mr.restarts += 1
        self._spawn(mr)
        port = self._await_port(mr, time.monotonic() + 120.0)
        mr.handle = ReplicaHandle(name, mr.config.host, port)
        if self.router is not None:
            self.router.reinstate(name, mr.handle)
            self.router.metrics.inc("fleet_replica_restarts", replica=name)

    def drain(self) -> int:
        """Drain every healthy replica (finish queued work, checkpoint
        streams); returns the total resolved across the fleet."""
        assert self.router is not None, "start() first"
        total = 0
        for handle in self.router.healthy():
            with contextlib.suppress(ConnectionError, DeviceError):
                total += handle.drain()
        return total

    def shutdown(self) -> None:
        """Stop every replica (best-effort polite, then force)."""
        for mr in self._replicas.values():
            mr.stopped = True
            if mr.handle is not None:
                with contextlib.suppress(Exception):
                    mr.handle.shutdown()
                mr.handle.close()
        for mr in self._replicas.values():
            if mr.process is None:
                continue
            try:
                mr.process.wait(timeout=3)
            except subprocess.TimeoutExpired:
                mr.process.kill()
                with contextlib.suppress(subprocess.TimeoutExpired):
                    mr.process.wait(timeout=10)
        if self.router is not None:
            self.router.close()

    # ------------------------------------------------------------------ #
    # Monitoring
    # ------------------------------------------------------------------ #
    def monitor_once(self) -> dict:
        """One monitor tick: fire chaos kills, reap dead processes
        (quarantine + warm handoff + restart), poll health.  Returns the
        health reports that succeeded."""
        assert self.router is not None, "start() first"
        ctx = use_plan(self.faults) if self.faults is not None else contextlib.nullcontext()
        with ctx:
            for name, mr in self._replicas.items():
                if mr.alive() and inject("replica_kill", replica=name):
                    self.kill(name)
        for name, mr in list(self._replicas.items()):
            if mr.process is not None and mr.process.poll() is not None and not mr.stopped:
                orphans = self.router.quarantine(name, reason="process exited")
                self._orphans_of(name, orphans)
                if self.auto_restart and mr.restarts < self.max_restarts:
                    self.restart(name)
                else:
                    mr.stopped = True
        reports = self.router.poll_health()
        # Health-poll quarantines may have orphaned streams too.
        for name in self.router.replica_names:
            if self.router.is_quarantined(name):
                self._orphans_of(name, ())
        return reports

    def _orphans_of(self, name: str, reported: tuple[str, ...]) -> None:
        """Re-home every stream owned by a now-quarantined replica."""
        with self._lock:
            owned = [
                sid for sid, owner in self._stream_owner.items() if owner == name
            ]
        for sid in dict.fromkeys((*owned, *reported)):
            with contextlib.suppress(Exception):
                self.recover_stream(sid)

    # ------------------------------------------------------------------ #
    # Streams: placement, RPC with failover, warm handoff
    # ------------------------------------------------------------------ #
    def open_stream(self, graph, stream_id: str, **opts) -> dict:
        """Open a streaming session on a bucket-affine replica."""
        assert self.router is not None, "start() first"
        handle, _ = self.router.pick(self.router.bucket_of(_GraphQuery(graph)))
        try:
            reply = handle.rpc(
                {
                    "op": "open_stream",
                    "stream_id": stream_id,
                    "graph": encode_graph(graph),
                    **opts,
                }
            )
        finally:
            self.router.release(handle.name)
        with self._lock:
            self._stream_owner[stream_id] = handle.name
        return reply

    def stream_owner(self, stream_id: str) -> str | None:
        with self._lock:
            return self._stream_owner.get(stream_id)

    def recover_stream(self, stream_id: str) -> dict:
        """Warm handoff: restore ``stream_id`` from its newest checkpoint
        on the least-loaded healthy replica; returns the replica's
        committed state (seq, trussness, kmax)."""
        assert self.router is not None, "start() first"
        survivors = self.router.healthy()
        if not survivors:
            raise QueryFailedError(
                f"no healthy replica can adopt stream {stream_id!r}"
            )
        survivor = min(survivors, key=lambda h: self.router.depth(h.name))
        reply = survivor.rpc({"op": "restore_stream", "stream_id": stream_id})
        with self._lock:
            self._stream_owner[stream_id] = survivor.name
        self.router.metrics.inc("fleet_stream_handoffs", stream=stream_id)
        return reply

    def stream_rpc(self, stream_id: str, msg: dict) -> dict:
        """One stream op with failover: on a dead owner, quarantine it,
        hand the stream off warm, and retry on the new owner.  The
        replica's idempotent seq replay makes the retry exactly-once."""
        assert self.router is not None, "start() first"
        for _ in range(len(self._replicas) + 1):
            owner = self.stream_owner(stream_id)
            if owner is None or self.router.is_quarantined(owner):
                self.recover_stream(stream_id)
                owner = self.stream_owner(stream_id)
            handle = self._replicas[owner].handle
            try:
                return handle.rpc(msg)
            except (ConnectionError, DeviceError) as e:
                self.router.mark_failed(owner, reason=str(e))
                continue
        raise QueryFailedError(
            f"stream {stream_id!r} rpc failed on every replica"
        )

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        assert self.router is not None, "start() first"
        with self._lock:
            owners = dict(sorted(self._stream_owner.items()))
        return {
            **self.router.stats(),
            "replicas": {
                name: {
                    "alive": mr.alive(),
                    "restarts": mr.restarts,
                    "quarantined": self.router.is_quarantined(name),
                }
                for name, mr in self._replicas.items()
            },
            "streams": owners,
        }


class _GraphQuery:
    """Minimal duck-typed query for :meth:`Router.bucket_of` (streams
    route by graph bucket but are not TrussQueries)."""

    __slots__ = ("graph",)

    def __init__(self, graph):
        self.graph = graph
