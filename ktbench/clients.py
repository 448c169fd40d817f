"""The one traffic generator: drives the program with the mix a traffic
file describes, and records what came back.

A mix (``ktbench/traffic/<name>.json``) is one of two kinds here, or a
kind whose driver is the file ``ktbench/drivers/<kind>.py``:

- ``"decompose"``: one closed-loop client.  Request j submits one
  ``TrussQuery.decompose`` through one ``repro_torch.api.Session`` on
  graph ``j % pool`` of a pool made at set-up, and waits for its result.
- ``"stream"``: one ``Session.open_stream`` over the pool's graph, and a
  closed loop of balanced updates of ``width`` edges
  (:mod:`ktbench.updates`), drawn from the seed at set-up.

Every pool graph is warmed once before the window (the stream by
``warm_updates`` updates), so every shape the window uses is built.  A
request that raises counts as attempted and failed and adds no work.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import numpy as np

from . import by_file, generators, reference, updates

__all__ = ["Answer", "Records", "Driver", "MixExhausted", "make_driver"]


class MixExhausted(RuntimeError):
    """The mix's pre-drawn updates ran out before the window closed."""


@dataclass
class Answer:
    index: int  # request number, in issue order
    graph: int  # pool index (decompose) or update number (stream)
    kmax: int
    trussness: np.ndarray | None  # kept for the check, or None


@dataclass
class Records:
    """What the window (and, traced, the profiled stretch) returned."""

    sample: int  # answers kept whole for the check, drawn from the seed
    rng: random.Random
    attempted: int = 0
    failed: int = 0
    errors: list[str] = field(default_factory=list)
    latencies: list[float] = field(default_factory=list)
    work: int = 0  # undirected edges decomposed, or updates committed
    answers: list[Answer] = field(default_factory=list)  # every answer; kmax alone past the sample
    kept: list[Answer] = field(default_factory=list)  # the sample, kept whole
    last: Answer | None = None  # the newest answer, always checked whole

    def keep(self, ans: Answer) -> None:
        """Reservoir sampling: every answer has the same chance to be kept
        whole; the others keep their kmax, and the newest is kept too."""
        self.answers.append(ans)
        whole = ans.trussness
        if len(self.kept) < self.sample:
            self.kept.append(Answer(ans.index, ans.graph, ans.kmax, whole))
        else:
            j = self.rng.randrange(len(self.answers))
            if j < self.sample:
                self.kept[j] = Answer(ans.index, ans.graph, ans.kmax, whole)
        self.last = Answer(ans.index, ans.graph, ans.kmax, whole)
        ans.trussness = None

    def checked(self) -> list[Answer]:
        """The answers compared whole: the sample and the newest."""
        out = {a.index: a for a in self.kept}
        if self.last is not None:
            out[self.last.index] = self.last
        return [out[i] for i in sorted(out)]


def _graph(n: int, edges: np.ndarray, name: str):
    from repro_torch.graphs.csr import from_edges

    return from_edges(n, edges, name=name)


class Driver:
    """Builds a cell's inputs from the seed and runs its requests."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        t0 = time.perf_counter()
        self.pool = [generators.config_graph(config, seed, i, device) for i in range(traffic["pool"])]
        t1 = time.perf_counter()
        self.graphs = [_graph(n, e, f"{config['name']}-{i}") for i, (n, e) in enumerate(self.pool)]
        self.setup_split = {"generator": t1 - t0, "from_edges": time.perf_counter() - t1}
        self.session = None
        self.requests = 0  # requests issued so far (a stream's warm updates included)

    def open(self, session) -> None:
        self.session = session

    def close(self) -> None:
        self.session = None

    def summary(self) -> list[str]:
        """Lines for the run's standard error about the window's requests."""
        return []


class DecomposeDriver(Driver):
    def graph_of(self, j: int) -> int:
        """The pool graph of request ``j``."""
        return j % len(self.pool)

    def warm(self) -> None:
        for j in range(len(self.pool)):
            self._request(j, None)

    def _request(self, j: int, rec: Records | None) -> None:
        from repro_torch.api import TrussQuery

        gi = self.graph_of(j)
        t0 = time.perf_counter()
        res, err = None, None
        try:
            res = self.session.submit(TrussQuery.decompose(self.graphs[gi])).result(timeout=None)
        except Exception as e:  # a refused or failed request: counted, not raised
            err = e
        t1 = time.perf_counter()
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
        rec.keep(Answer(index, gi, int(res.kmax), np.asarray(res.trussness)))

    def run(self, rec: Records, *, seconds: float | None = None,
            requests: int | None = None) -> float:
        """One closed-loop client until ``seconds`` have passed (a request
        started before then is finished) or it has made ``requests``
        requests; returns the wall seconds from the first submit to the
        last result."""
        t0 = time.perf_counter()
        done = 0
        while not (seconds is not None and time.perf_counter() - t0 >= seconds
                   or requests is not None and done >= requests):
            self._request(self.requests, rec)
            self.requests += 1
            done += 1
        return time.perf_counter() - t0

    def answer_graph(self, ans: Answer) -> tuple[int, np.ndarray]:
        return self.pool[ans.graph]


class UpdateFailed(RuntimeError):
    """An update of the window failed; the stream cannot go on."""


class StreamDriver(Driver):
    """One stream over the pool's one graph, with updates drawn from the
    seed.  The deletes are drawn by the mix's ``delete_strata`` strata of
    the starting graph's trussness, which the plain reference works out at
    set-up (:func:`ktbench.updates.stratified_picks`).  Each
    update's kind, deleted edge's trussness, frontier (the edges it
    re-peels, as the program reports them) and latency are logged for the
    run's summary."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        n, base = self.pool[0]
        rng = np.random.default_rng(generators.derived_seed(seed, 0, 1))
        t0 = time.perf_counter()
        truss = reference.trussness(n, base, device)
        count = min(traffic["updates"], base.shape[0])  # a tiny graph has fewer edges to delete
        self.batches = updates.balanced_updates(rng, n, base, traffic["width"], count,
                                                delete_key=truss, strata=traffic["delete_strata"])
        self.setup_split["updates"] = time.perf_counter() - t0
        keys = base[:, 0] * n + base[:, 1]  # each batch's deleted edges' starting trussness, for the log
        self.deleted_truss = [truss[np.searchsorted(keys, d[:, 0] * n + d[:, 1])]
                              for _, d in self.batches]
        self.stream = None
        self.log: list[tuple[int, int, float]] = []  # (deleted truss or -1, frontier, seconds)

    def open(self, session) -> None:
        super().open(session)
        self.stream = session.open_stream(self.graphs[0])

    def close(self) -> None:
        self.stream = None
        super().close()

    def warm(self) -> None:
        for _ in range(self.traffic["warm_updates"]):
            self._update(None)

    def _update(self, rec: Records | None) -> None:
        from repro_torch.stream import EdgeBatch

        i = self.requests
        if i >= len(self.batches):
            raise MixExhausted(f"the mix's {len(self.batches)} updates ran out")
        self.requests += 1
        ins, dels = self.batches[i]
        t0 = time.perf_counter()
        res, err = None, None
        try:
            res = self.stream.submit_update(EdgeBatch(ins, dels)).result()
        except Exception as e:  # the update failed: counted, not raised
            err = e
        t1 = time.perf_counter()
        if rec is None:
            if err is not None:
                raise err
            return
        index = rec.attempted
        rec.attempted += 1
        if err is not None:
            rec.failed += 1
            rec.errors.append(f"update {i}: {type(err).__name__}: {err}")
            # Deltas are relative to the committed graph: nothing after a
            # failed update can be checked, so the run stops here.
            raise UpdateFailed(f"update {i} failed") from err
        rec.latencies.append(t1 - t0)
        rec.work += 1
        dt = self.deleted_truss[i]
        self.log.append((int(dt.max()) if dt.size else -1, int(res.frontier_size), t1 - t0))
        rec.keep(Answer(index, i, int(res.kmax), np.asarray(res.trussness)))

    def run(self, rec: Records, *, seconds: float | None = None,
            requests: int | None = None) -> float:
        t0 = time.perf_counter()
        done = 0
        while True:
            if seconds is not None and time.perf_counter() - t0 >= seconds:
                break
            if requests is not None and done >= requests:
                break
            try:
                self._update(rec)
            except UpdateFailed:
                break
            done += 1
        return time.perf_counter() - t0

    def answer_graph(self, ans: Answer) -> tuple[int, np.ndarray]:
        n, edges = self.pool[0]
        return n, updates.state_after(n, edges, self.batches[: ans.graph + 1])

    def summary(self) -> list[str]:
        """Each kind's latency and frontier, the updates whose frontier holds
        1% of the edges or more ("wide") and the rest, and the deletes in
        four groups by the starting trussness of the edge they delete."""
        if not self.log:
            return []
        truss, front, secs = (np.asarray(c) for c in zip(*self.log))
        wide = front >= 0.01 * self.pool[0][1].shape[0]
        groups = [("inserts", truss < 0), ("deletes", truss >= 0), ("wide", wide), ("narrow", ~wide)]
        dels = np.sort(truss[truss >= 0])
        if dels.size >= 4:
            cuts = np.unique(dels[[dels.size * q // 4 for q in range(1, 4)]])
            edges = [dels[0], *cuts, dels[-1] + 1]
            groups += [(f"deletes of trussness {lo}-{hi - 1}", (truss >= lo) & (truss < hi))
                       for lo, hi in zip(edges, edges[1:])]
        out = []
        for name, sel in groups:
            if sel.any():
                ms = np.percentile(secs[sel] * 1e3, [50, 95, 100])
                fr = np.percentile(front[sel], [50, 95, 100])
                out.append(f"{name}: {int(sel.sum())} of {sel.size}, latency ms p50 {ms[0]:.3f} "
                           f"p95 {ms[1]:.3f} max {ms[2]:.3f}, frontier p50 {fr[0]:.0f} "
                           f"p95 {fr[1]:.0f} max {fr[2]:.0f}, {secs[sel].sum():.3f} s in all")
        return out


def make_driver(config: dict, traffic: dict, seed: int, device) -> Driver:
    """The cell's driver, its inputs made from ``seed`` on ``device``.  A
    kind other than ``decompose`` and ``stream`` is the file
    ``drivers/<kind>.py``, whose ``make_driver(config, traffic, seed,
    device)`` returns a :class:`Driver`."""
    if traffic["kind"] == "decompose":
        return DecomposeDriver(config, traffic, seed, device)
    if traffic["kind"] == "stream":
        return StreamDriver(config, traffic, seed, device)
    return by_file.load("drivers", traffic["kind"], "traffic kind").make_driver(config, traffic, seed, device)
