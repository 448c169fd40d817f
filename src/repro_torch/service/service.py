"""TrussService: the legacy batched serving front end (adapter).

.. deprecated::
    ``TrussService`` is a thin adapter over :class:`repro_torch.api.Session`
    — the declarative query API is the one front door now::

        from repro_torch.api import Session, TrussQuery

        s = Session(max_batch=8)
        fut = s.submit(TrussQuery.ktruss(g, k=4))

    Every ``submit_*`` method builds the equivalent
    :class:`repro_torch.api.TrussQuery` and hands it to the session, so
    queueing, bucketing, packing, executor caching, and dispatch all run
    through the single ``repro_torch.api`` lowering path.  ``TrussFuture``
    *is* :class:`repro_torch.api.TrussFuture` (re-exported).  The
    arguments are the JAX package's adapter's, with ``device=`` (CUDA
    unless ``"cpu"`` is passed).
"""

from __future__ import annotations

import numpy as np
import torch

from ..api.registry import BackendKey
from ..api.session import Session, TrussFuture
from ..api.query import TrussQuery
from ..graphs.csr import CSRGraph

__all__ = ["TrussFuture", "TrussService"]


class TrussService:
    """Batched multi-graph K-truss serving over one executor cache.

    Adapter over :class:`repro_torch.api.Session`: ``mode``/``backend`` pin
    the session to one registry backend (``fine`` formulation, the given
    kernel, slot-aligned layout) so legacy behavior — one executor per
    shape bucket — is preserved exactly.  Use ``repro_torch.api`` directly for
    the declarative surface (per-query backends, deadlines, the
    imbalance-keyed auto rule).
    """

    def __init__(
        self,
        *,
        mode: str = "eager",
        backend: str = "xla",
        max_batch: int = 8,
        chunk: int = 256,
        max_iters: int | None = None,
        mesh=None,
        cache_dir: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.mode = mode
        self.backend = backend
        self._session = Session(
            backend=BackendKey("fine", backend, "aligned"),
            mode=mode,
            max_batch=max_batch,
            chunk=chunk,
            max_iters=max_iters,
            mesh=mesh,
            cache_dir=cache_dir,
            device=device,
        )

    # The api session's state, exposed under the legacy names ---------- #
    @property
    def session(self) -> Session:
        """The underlying :class:`repro_torch.api.Session`."""
        return self._session

    @property
    def cache(self):
        return self._session.cache

    @property
    def batcher(self):
        return self._session.queue

    @property
    def chunk(self) -> int:
        return self._session.chunk

    @property
    def mesh(self):
        return self._session.mesh

    @property
    def requests_served(self) -> int:
        return self._session.requests_served

    @property
    def batches_run(self) -> int:
        return self._session.batches_run

    @property
    def device_dispatches(self) -> int:
        return self._session.device_dispatches

    @property
    def device_time_s(self) -> float:
        return self._session.device_time_s

    # ------------------------------------------------------------------ #
    # Submission
    # ------------------------------------------------------------------ #
    def submit(self, g: CSRGraph, workload: str = "ktruss", *, k: int = 3) -> TrussFuture:
        if workload not in ("ktruss", "kmax", "decompose"):
            raise ValueError(f"unknown workload {workload!r}")
        return self._session.submit(TrussQuery(graph=g, workload=workload, k=int(k)))

    def submit_ktruss(self, g: CSRGraph, k: int) -> TrussFuture:
        return self.submit(g, "ktruss", k=k)

    def submit_kmax(self, g: CSRGraph, k_start: int = 3) -> TrussFuture:
        return self.submit(g, "kmax", k=k_start)

    def submit_decompose(self, g: CSRGraph, k_start: int = 3) -> TrussFuture:
        return self.submit(g, "decompose", k=k_start)

    def submit_stream(
        self,
        g: CSRGraph,
        *,
        frontier: np.ndarray,
        frozen_truss: np.ndarray,
    ) -> TrussFuture:
        """Submit a frontier-bounded re-peel (the streaming update kernel).

        Adapter for :meth:`repro_torch.api.TrussQuery.stream_update` — see there
        for semantics.  The future resolves to the member's full (nnz,)
        trussness: frontier lanes re-peeled, frozen lanes passed through.
        """
        return self._session.submit(
            TrussQuery.stream_update(
                g,
                frontier=np.asarray(frontier, bool),
                frozen_truss=np.asarray(frozen_truss, np.int32),
            )
        )

    def open_stream(self, g: CSRGraph, trussness: np.ndarray | None = None):
        """Open a :class:`repro_torch.stream.StreamingTrussSession` on this service."""
        return self._session.open_stream(g, trussness=trussness)

    # ------------------------------------------------------------------ #
    # Batch execution
    # ------------------------------------------------------------------ #
    def poll(self) -> int:
        """Run at most one micro-batch; returns how many requests resolved."""
        return self._session.poll()

    def flush(self) -> int:
        """Drain the queue; returns how many requests resolved."""
        return self._session.flush()

    def resolve(self, request) -> None:
        """Run batches from ``request``'s group until it resolves (legacy
        spelling of ``future.result()`` — which is the API to use)."""
        fut = self._session._futures.get(request.id)
        if fut is not None:
            fut.result()

    # ------------------------------------------------------------------ #
    # Observability
    # ------------------------------------------------------------------ #
    def stats(self) -> dict:
        return self._session.stats()
