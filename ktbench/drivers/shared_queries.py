"""Several queries on one graph at once: the driver of the
``shared_queries`` kind.

One closed-loop client.  Request j takes pool graph ``j % pool`` and
submits one query for each entry of the mix's ``queries``, in that order,
on the same ``CSRGraph`` object: ``"decompose"`` and ``"kmax"`` from k = 3,
``"ktruss:<k>"`` the k-truss.  It waits for a result only once all are
submitted, so the session's queue holds them together and one dispatch
serves them.  Its latency runs from the first submit to the last result;
its work is the graph's undirected edges, once.  The mix must hold exactly
one ``decompose``.

The check (``ktbench.check``) compares one trussness and one kmax a
request, so each request is folded into one answer against the plain
reference (``ktbench.query_reference``) of the decompose's trussness:

- the trussness is the decompose's, with -1 on every edge where a
  ``ktruss`` member's mask or support differs from the reference's k-truss
  of that trussness (the pool graph's triangles are listed once, at
  set-up, on the run's device);
- the kmax is the ``kmax`` member's, or -1 where it differs from the
  reference's kmax of that trussness.

A wrong member then shows as mismatched edges or a kmax mismatch.  The
fold runs after the request's result, outside its latency and inside the
window; its time is logged for the run's summary.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from ktbench import clients, query_reference, reference

__all__ = ["SharedQueriesDriver", "make_driver"]


def parse_queries(names: list[str]) -> list[tuple[str, int]]:
    """``(workload, k)`` of each entry: ``decompose``, ``kmax`` (k = 3) or
    ``ktruss:<k>``."""
    out = []
    for name in names:
        workload, _, k = name.partition(":")
        if workload not in ("decompose", "kmax", "ktruss") or bool(k) != (workload == "ktruss"):
            raise ValueError(f"unknown query {name!r}: decompose, kmax or ktruss:<k>")
        out.append((workload, int(k) if k else 3))
    if [w for w, _ in out].count("decompose") != 1:
        raise ValueError(f"the queries {names} must hold exactly one decompose")
    return out


class SharedQueriesDriver(clients.DecomposeDriver):
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.device = device
        self.queries = parse_queries(traffic["queries"])
        t0 = time.perf_counter()
        self.triangles = [
            reference.triangles(n, torch.as_tensor(edges, dtype=torch.int64, device=device))
            for n, edges in self.pool
        ]
        self.setup_split["triangles"] = time.perf_counter() - t0
        self.batch_sizes: Counter = Counter()  # dispatch size -> requests, over every run
        self.fold_s: list[float] = []  # each recorded request's fold

    def _submit(self, g) -> list:
        from repro_torch.api import TrussQuery

        # Each constructor takes (graph, k): k_start, or the truss's k.
        return [self.session.submit(getattr(TrussQuery, w)(g, k)) for w, k in self.queries]

    def fold(self, gi: int, results: list) -> tuple[int, np.ndarray]:
        """One request's ``(kmax, trussness)`` for the check (module docstring)."""
        dec = results[[w for w, _ in self.queries].index("decompose")]
        truss = np.asarray(dec.trussness)
        t = torch.as_tensor(truss, device=self.device)
        bad = torch.zeros(t.shape, dtype=torch.bool, device=self.device)
        want_kmax = query_reference.kmax(t)
        kmax = want_kmax
        for (workload, k), res in zip(self.queries, results):
            if workload == "kmax":
                kmax = int(res) if kmax >= 0 and int(res) == want_kmax else -1
            elif workload == "ktruss":
                alive, support = query_reference.ktruss(t, self.triangles[gi], k)
                got_alive, got_support = np.asarray(res.alive), np.asarray(res.support)
                if got_alive.shape != truss.shape or got_support.shape != truss.shape:
                    bad[:] = True
                    continue
                bad |= alive != torch.as_tensor(got_alive, device=self.device)
                bad |= support != torch.as_tensor(got_support, device=self.device)
        wrong = torch.nonzero(bad).squeeze(1).cpu().numpy()
        if wrong.size:
            truss = truss.copy()
            truss[wrong] = -1
        return kmax, truss

    def _request(self, j: int, rec: clients.Records | None) -> None:
        gi = self.graph_of(j)
        t0 = time.perf_counter()
        futs, results, err = [], None, None
        try:
            futs = self._submit(self.graphs[gi])
            results = [f.result(timeout=None) for f in futs]
        except Exception as e:  # a refused or failed request: counted, not raised
            err = e
        t1 = time.perf_counter()
        if err is None:
            self.batch_sizes[max(f.stats.batch_size for f in futs)] += 1
            kmax, truss = self.fold(gi, results)
        t2 = time.perf_counter()
        if rec is None:
            if err is not None:
                raise err
            return
        index = rec.attempted
        rec.attempted += 1
        if err is not None:
            rec.failed += 1
            rec.errors.append(f"request {index}: {type(err).__name__}: {err}")
            return
        rec.latencies.append(t1 - t0)
        rec.work += self.pool[gi][1].shape[0]
        self.fold_s.append(t2 - t1)
        rec.keep(clients.Answer(index, gi, kmax, truss))

    def summary(self) -> list[str]:
        """The dispatches' sizes, and the fold's time a request."""
        out = []
        if self.batch_sizes:
            out.append("requests by the largest dispatch serving their queries: "
                       + ", ".join(f"{k}: {v}" for k, v in sorted(self.batch_sizes.items())))
        if self.fold_s:
            out.append(f"fold: mean {1e3 * float(np.mean(self.fold_s)):.3f} ms, max "
                       f"{1e3 * max(self.fold_s):.3f} ms over {len(self.fold_s)} requests")
        return out


def make_driver(config: dict, traffic: dict, seed: int, device) -> SharedQueriesDriver:
    return SharedQueriesDriver(config, traffic, seed, device)
