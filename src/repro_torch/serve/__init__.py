"""repro_torch.serve — the multi-replica serving tier over :mod:`repro_torch.api`.

The port of ``repro.serve``.  Across *replicas*, one process pinned on a
slow bucket starves the fleet unless work is routed by observed state.
Four pieces:

* :mod:`.wire`    — length-prefixed JSON-over-socket protocol (queries,
                    results, and typed errors cross processes bit-exactly;
                    the frames are the reference's, byte for byte);
* :mod:`.replica` — worker process wrapping one thread-safe ``Session``
                    (on CUDA unless configured otherwise): dummy-compute
                    warmup before the port opens, ``max_live`` admission
                    (shed at the door), periodic :class:`HealthReport`\\ s,
                    drain-before-death;
* :mod:`.router`  — bucket-affinity routing (same-bucket traffic goes to
                    the replica that already built it), EDF spillover
                    past a depth threshold, load shedding through the
                    typed :class:`~repro_torch.errors.TrussTimeoutError`
                    path, quarantine + redistribution on health failure;
* :mod:`.fleet` / :mod:`.client` — process lifecycle (spawn / monitor /
                    chaos-kill / restart) and the ``solve()``-shaped
                    :class:`FleetClient`, with warm handoff of streaming
                    sessions via checkpoint/restore.

Quickstart::

    from repro_torch.serve import Fleet, FleetClient

    with Fleet(3, workdir=".fleet") as fleet:      # device="cpu" for the CPU
        client = FleetClient(fleet)
        results = client.solve(queries)   # bit-identical to solve(queries)
"""

from .client import FleetClient, FleetFuture, FleetStream
from .fleet import Fleet, ManagedReplica
from .replica import HealthReport, Replica, ReplicaConfig, health_report
from .router import ReplicaHandle, Router
from .wire import (
    MAX_FRAME_BYTES,
    WireError,
    decode_query,
    decode_result,
    encode_query,
    encode_result,
    raise_remote_error,
    recv_msg,
    send_msg,
)

__all__ = [
    # client
    "FleetClient",
    "FleetFuture",
    "FleetStream",
    # fleet
    "Fleet",
    "ManagedReplica",
    # replica
    "Replica",
    "ReplicaConfig",
    "HealthReport",
    "health_report",
    # router
    "Router",
    "ReplicaHandle",
    # wire
    "MAX_FRAME_BYTES",
    "WireError",
    "send_msg",
    "recv_msg",
    "encode_query",
    "decode_query",
    "encode_result",
    "decode_result",
    "raise_remote_error",
]
