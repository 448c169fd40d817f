"""Several closed-loop clients over one session: the driver of the
``decompose_clients`` kind.

The mix's ``clients`` threads each submit one ``TrussQuery.decompose``
and wait for its result, then submit the next, with no think time.
Request j, numbered in the order sent across the threads, is on pool graph
``j % pool``.  Their queries meet in the session's one queue, and a
client that drives the queue dispatches every query of its group that is
pending then, up to the session's ``max_batch``.

The window's rule is the one-client driver's: no client starts a request
once ``seconds`` have passed, a request already started is finished, and
the window runs from the first submit to the last result; with
``requests=N`` the clients together send N.  Each latency runs from its
own client's submit to its own result.  A failed request counts as
attempted and failed.  One lock guards the request counter and every
update of the records.  Before the window the pool's graphs are warmed
one at a time, then in one round of every client at once, all submitted
before any waits, so that a dispatch of that many live slots is built.
"""

from __future__ import annotations

import threading
import time
from collections import Counter

import numpy as np

from ktbench import clients

__all__ = ["DecomposeClientsDriver", "make_driver"]


class DecomposeClientsDriver(clients.DecomposeDriver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.clients = int(traffic["clients"])
        self._lock = threading.Lock()
        self.batch_sizes: list[int] = []  # the last run's: the batch each request was served in
        # The session's requests_served and batches_run over every run (window and stretch).
        self.served = self.batches = 0

    def _clients(self, work) -> None:
        """Run ``work(i)`` on one thread per client; re-raise the first
        error any of them raised once all have ended."""
        errors: list[BaseException] = []

        def client(i: int) -> None:
            try:
                work(i)
            except BaseException as e:  # carried to the caller's thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,), name=f"ktb-client-{i}")
                   for i in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def warm(self) -> None:
        from repro_torch.api import TrussQuery

        super().warm()
        submitted = threading.Barrier(self.clients)

        def one(i: int) -> None:
            try:
                fut = self.session.submit(TrussQuery.decompose(self.graphs[self.graph_of(i)]))
            except BaseException:
                submitted.abort()  # the others stop waiting for this client
                raise
            submitted.wait()
            fut.result(timeout=None)

        self._clients(one)

    def _request(self, j: int, rec: clients.Records | None) -> None:
        from repro_torch.api import TrussQuery

        gi = self.graph_of(j)
        t0 = time.perf_counter()
        fut = res = err = None
        try:
            fut = self.session.submit(TrussQuery.decompose(self.graphs[gi]))
            res = fut.result(timeout=None)
        except Exception as e:  # a refused or failed request: counted, not raised
            err = e
        t1 = time.perf_counter()
        if rec is None:
            if err is not None:
                raise err
            return
        with self._lock:
            index = rec.attempted
            rec.attempted += 1
            if err is not None:
                rec.failed += 1
                rec.errors.append(f"request {index}: {type(err).__name__}: {err}")
                return
            rec.latencies.append(t1 - t0)
            rec.work += self.pool[gi][1].shape[0]
            rec.keep(clients.Answer(index, gi, int(res.kmax), np.asarray(res.trussness)))
            self.batch_sizes.append(int(fut.stats.batch_size))

    def run(self, rec: clients.Records, *, seconds: float | None = None,
            requests: int | None = None) -> float:
        """The clients until ``seconds`` have passed (a request started
        before then is finished) or they have sent ``requests`` in all;
        returns the wall seconds from the first submit to the last
        result."""
        served, batches = self.session.requests_served, self.session.batches_run
        self.batch_sizes = []
        sent = 0
        t0 = time.perf_counter()

        def loop(i: int) -> None:
            nonlocal sent
            while True:
                with self._lock:
                    if (seconds is not None and time.perf_counter() - t0 >= seconds
                            or requests is not None and sent >= requests):
                        return
                    j = self.requests
                    self.requests += 1
                    sent += 1
                self._request(j, rec)

        self._clients(loop)
        wall = time.perf_counter() - t0
        self.served += self.session.requests_served - served
        self.batches += self.session.batches_run - batches
        return wall

    def summary(self) -> list[str]:
        """The batches the last run's requests were served in, by size:
        a batch of k queries holds k of the requests."""
        sizes = Counter(self.batch_sizes)
        if not sizes:
            return []
        return [f"batches by size (from {len(self.batch_sizes)} requests): "
                + ", ".join(f"{k}: {sizes[k] / k:g}" for k in sorted(sizes))]


def make_driver(config: dict, traffic: dict, seed: int, device) -> DecomposeClientsDriver:
    return DecomposeClientsDriver(config, traffic, seed, device)
