"""FleetClient: the ``solve()``/``Session`` API over a replica fleet.

Existing entry points migrate by swapping the constructor — everything
else reads the same::

    from repro_torch.api import TrussQuery, solve    # single process
    results = solve(queries)

    from repro_torch.serve import Fleet, FleetClient # fleet
    with Fleet(3, workdir=".fleet") as fleet:        # replicas on CUDA
        client = FleetClient(fleet)
        results = client.solve(queries)              # same results,
                                                     # bit for bit

``submit`` returns a :class:`FleetFuture` (mirror of
:class:`repro_torch.api.TrussFuture`: ``result(timeout=...)`` raising the same
typed errors — a replica's shed crosses the wire as the same
:class:`~repro_torch.errors.TrussTimeoutError` with ``shed=True``).
``open_stream`` returns a :class:`FleetStream` whose ``update`` survives
replica death: the fleet hands the stream off warm and the client's
sequence numbers make the retried update exactly-once.

The bit-identical contract holds because every replica runs the same
deterministic planner/peel as a local ``Session`` — routing changes
*where* a query runs, never *what* it computes.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any

import numpy as np

from ..errors import DeviceError, QueryFailedError
from .fleet import Fleet
from .wire import decode_array, decode_result, encode_array, encode_query

__all__ = ["FleetFuture", "FleetStream", "FleetClient"]

_stream_ids = itertools.count()


class FleetFuture:
    """Handle to one query submitted through the fleet (mirror of
    :class:`repro_torch.api.TrussFuture`)."""

    def __init__(self, client: "FleetClient", query, qmsg: dict, routed):
        self._client = client
        self.query = query
        self._qmsg = qmsg
        self._routed = routed
        self._result: Any = None
        self._error: BaseException | None = None
        self._done = False

    @property
    def replica(self) -> str:
        """Name of the replica currently holding this query."""
        return self._routed.replica.name

    @property
    def affine(self) -> bool:
        """Did routing land on the query's bucket-home replica."""
        return self._routed.affine

    def done(self) -> bool:
        return self._done

    def result(self, timeout: float | None = None) -> Any:
        """Block on the remote result; typed errors re-raise locally.

        A replica that dies mid-query gets quarantined and the query is
        transparently resubmitted to a survivor (queries are pure — a
        re-run is bit-identical, not at-most-once)."""
        if self._done:
            if self._error is not None:
                raise self._error
            return self._result
        router = self._client.router
        while True:
            routed = self._routed
            try:
                encoded = routed.replica.result(routed.qid, timeout_s=timeout)
            except (ConnectionError, DeviceError) as e:
                router.release(routed.replica.name)
                router.mark_failed(routed.replica.name, reason=str(e))
                router.metrics.inc("router_query_retries")
                # Resubmit elsewhere; pick/submit handle quarantine/shed.
                self._routed = router.submit(self.query, self._qmsg)
                continue
            except BaseException as e:
                router.release(routed.replica.name)
                self._error = e
                self._done = True
                raise
            router.release(routed.replica.name)
            self._result = decode_result(encoded)
            self._done = True
            return self._result


class FleetStream:
    """Client half of a replica-hosted streaming truss session.

    Mirrors :class:`repro_torch.stream.StreamingTrussSession`'s read surface
    (``trussness``, ``kmax``, ``update``) while the maintained state
    lives on a replica.  ``update`` carries a client-side sequence
    number; after a crash + warm handoff, a retried update is recognized
    (``seq <= committed``) and re-acked instead of re-applied."""

    def __init__(self, client: "FleetClient", stream_id: str, state: dict):
        self._client = client
        self.stream_id = stream_id
        self._apply_state(state)

    def _apply_state(self, state: dict) -> None:
        self.seq = int(state["seq"])
        self.trussness = decode_array(state["trussness"])
        self.kmax = int(state["kmax"])

    @property
    def owner(self) -> str | None:
        """Name of the replica currently hosting this stream."""
        return self._client.fleet.stream_owner(self.stream_id)

    def update(self, batch) -> dict:
        """Apply one :class:`~repro_torch.stream.delta.EdgeBatch` exactly once
        (survives replica death mid-update); returns the replica's commit
        record and refreshes ``trussness``/``kmax``/``seq``."""
        msg = {
            "op": "stream_update",
            "stream_id": self.stream_id,
            "seq": self.seq + 1,
            "inserts": encode_array(np.asarray(batch.inserts, np.int64)),
            "deletes": encode_array(np.asarray(batch.deletes, np.int64)),
        }
        reply = self._client.fleet.stream_rpc(self.stream_id, msg)
        self._apply_state(reply)
        return reply


class FleetClient:
    """``solve()``/``Session``-shaped front door over a :class:`Fleet`."""

    def __init__(self, fleet: Fleet):
        if fleet.router is None:
            raise QueryFailedError("fleet is not started (call start())")
        self.fleet = fleet
        self.router = fleet.router
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    def submit(self, query) -> FleetFuture:
        """Route one declarative query to a replica; returns a future."""
        qmsg = encode_query(query)
        routed = self.router.submit(query, qmsg)
        return FleetFuture(self, query, qmsg, routed)

    def solve(self, queries) -> Any:
        """Route and resolve a query set; results in submission order.

        Submission happens in EDF order (urgent queries claim spare
        capacity first — the router's spillover rule), results come back
        in the caller's order, exactly like :func:`repro_torch.api.solve`."""
        from ..api.query import TrussQuery  # lazy: torch-heavy import chain

        single = isinstance(queries, TrussQuery)
        qs = [queries] if single else list(queries)
        futs: list[FleetFuture | None] = [None] * len(qs)
        for i in self.router.route_many(qs):
            futs[i] = self.submit(qs[i])
        results = [f.result() for f in futs]
        return results[0] if single else results

    def open_stream(self, graph, *, stream_id: str | None = None, **opts) -> FleetStream:
        """Open a streaming truss session hosted on the fleet."""
        if stream_id is None:
            with self._lock:
                stream_id = f"stream-{next(_stream_ids)}"
        state = self.fleet.open_stream(graph, stream_id, **opts)
        return FleetStream(self, stream_id, state)

    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        """Fleet-level serving stats (router + replicas + streams)."""
        return self.fleet.stats()

    def drain(self) -> int:
        return self.fleet.drain()
