"""Several queries on one graph in one dispatch, on the CPU: the
``delaunay20_shared_q3`` cell's request (``decompose``, ``kmax`` and
``ktruss(4)`` of one Delaunay graph, submitted before any result is
awaited) at 2**12 points, through ``Session`` on the auto rule's hand-kernel
path (``fine/pallas/aligned``, as on the card).  The request is one
dispatch whose members share the graph (``peel_slots_shared``), and each
answer equals the benchmark's plain reference (``ktbench.query_reference``)
and the JAX package's, edge for edge.  Then the benchmark driver's fold of
a request into the one answer ``ktbench.check`` compares: a corrupted
``ktruss`` lane, ``ktruss`` support or ``kmax`` member is caught.  On a
card, the same request runs in the trip graph (``-m gpu``)."""

import dataclasses
import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the benchmark's package, ktbench

import repro_torch.api as ta  # noqa: E402
from ktbench import check, clients, generators, query_reference, reference  # noqa: E402
from repro_torch.api.planner import Planner  # noqa: E402
from repro_torch.graphs.csr import from_edges  # noqa: E402
from repro_torch.obs.names import PEEL_SLOTS_SHARED  # noqa: E402

CONFIG = json.loads((ROOT / "ktbench" / "configs" / "delaunay_n20_q3.json").read_text())
MESH = json.loads((ROOT / "ktbench" / "configs" / "delaunay_n20.json").read_text())
MIX = json.loads((ROOT / "ktbench" / "traffic" / "shared_q3.json").read_text())
SEED = 2_147_483_659  # beyond 32 bits, as the benchmark's seeds are
PLANNED = "fine/pallas/aligned"
QUERIES = {  # request -> (workload, k) of each query, in submit order
    "q3": [("decompose", 3), ("kmax", 3), ("ktruss", 4)],
    "q4": [("decompose", 3), ("kmax", 3), ("ktruss", 4), ("ktruss", 3)],
}


def _graph(log2_n: int, index: int = 0):
    return generators.config_graph(dict(CONFIG, log2_n=log2_n), SEED, index)


def _query(tq, g, workload, k):
    return getattr(tq.TrussQuery, workload)(g, k)


@pytest.fixture(scope="module")
def small():
    """A 2**12-point graph, its triangles, the plain reference's trussness
    and the JAX package's answers to the four-query request."""
    pytest.importorskip("scipy.spatial")
    import repro.api as ra
    import repro.graphs as rg

    n, edges = _graph(12)
    tri = reference.triangles(n, torch.as_tensor(edges))
    want = reference.trussness(n, edges, "cpu")
    g = rg.from_edges(n, edges, name="delaunay12")
    jax_res = ra.solve([_query(ra, g, w, k) for w, k in QUERIES["q4"]])
    return n, edges, tri, want, jax_res


def _served(device, n, edges, tri, want, queries):
    """Serve one request of ``queries`` on one graph through ``Session`` on
    ``device``: one dispatch whose members share the graph, each answer
    equal to the plain reference.  Returns the answers."""
    g = from_edges(n, edges, name="delaunay12")
    s = ta.Session(device=device, max_batch=8, kernel="pallas", trace=True)
    futs = [s.submit(_query(ta, g, w, k)) for w, k in queries]
    got = [f.result() for f in futs]

    assert [f.stats.batch_size for f in futs] == [len(queries)] * len(queries)
    assert s.stats()["batches_run"] == 1
    (planned,) = s.stats()["planner_backends"]
    assert planned["backend"] == PLANNED
    assert s.metrics_snapshot()["counters"][PEEL_SLOTS_SHARED] == len(queries) - 1
    (dispatch,) = [e["args"] for e in s.obs.tracer.events() if e["name"] == "dispatch"]
    assert (dispatch["members"], dispatch["walked_slots"]) == (len(queries), 4)

    t = torch.as_tensor(want)
    for (workload, k), res in zip(queries, got):
        if workload == "decompose":
            assert np.array_equal(res.trussness, want)
        elif workload == "kmax":
            assert res == query_reference.kmax(t) == int(want.max()) == 4
        else:
            alive, support = (x.numpy() for x in query_reference.ktruss(t, tri, k))
            assert np.array_equal(res.alive, alive) and np.array_equal(res.support, support)
            assert res.edges_remaining == int(alive.sum()) > 0
    return got


@pytest.mark.parametrize("request_", sorted(QUERIES))
def test_a_request_on_one_graph_is_one_dispatch_equal_to_the_references(small, request_):
    n, edges, tri, want, jax_res = small
    queries = QUERIES[request_]
    got = _served("cpu", n, edges, tri, want, queries)
    for (workload, _), res, ref in zip(queries, got, jax_res):
        if workload == "decompose":
            assert np.array_equal(np.asarray(ref.trussness), want)
        elif workload == "kmax":
            assert res == int(ref)
        else:
            assert np.array_equal(np.asarray(ref.alive), res.alive)
            assert np.array_equal(np.asarray(ref.support), res.support)


@pytest.mark.gpu
def test_a_request_on_one_graph_on_the_card_is_one_trip_graph_equal_to_the_reference():
    """The same four-query request on the card, where the dispatch's three
    or four live slots run in the trip graph captured at width 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the trip graph has no CPU mode)")
    pytest.importorskip("scipy.spatial")
    n, edges = _graph(12)
    tri = reference.triangles(n, torch.as_tensor(edges))
    want = reference.trussness(n, edges, "cpu")
    _served("cuda", n, edges, tri, want, QUERIES["q4"])


def test_the_plain_reference_of_a_truss_is_closed():
    """The k-truss the reference gives holds every edge in at least k - 2
    of its own triangles, and ``kmax`` counts from the starting k."""
    pytest.importorskip("scipy.spatial")
    n, edges = _graph(9)
    truss = torch.as_tensor(reference.trussness(n, edges, "cpu"))
    tri = reference.triangles(n, torch.as_tensor(edges))
    for k in (3, 4, 5):
        alive, support = query_reference.ktruss(truss, tri, k)
        assert bool((support[alive] >= k - 2).all())
        assert not bool(support[~alive].any())
    top = int(truss.max())
    assert query_reference.kmax(truss) == top
    assert query_reference.kmax(truss, top + 1) == 0


def _corrupt(which):
    """A ``Planner.execute`` that corrupts one member's answer: one lane of
    the ``ktruss`` mask, one ``ktruss`` support, or the ``kmax``."""
    execute = Planner.execute

    def corrupted(self, batch, cache):
        out = execute(self, batch, cache)
        for i, st in enumerate(batch.queries):
            if which == "kmax" and st.query.workload == "kmax":
                out[i] += 1
            elif which != "kmax" and st.query.workload == "ktruss":
                field = getattr(out[i], which).copy()
                field[0] = not field[0] if which == "alive" else field[0] + 1
                out[i] = dataclasses.replace(out[i], **{which: field})
        return out

    return corrupted


@pytest.mark.parametrize("which", [None, "alive", "support", "kmax"])
def test_the_fold_is_caught_by_the_check_when_a_member_is_wrong(which, monkeypatch):
    pytest.importorskip("scipy.spatial")
    config = dict(CONFIG, name="tiny-delaunay", log2_n=9)
    driver = clients.make_driver(config, MIX, SEED, "cpu")
    if which is not None:
        monkeypatch.setattr(Planner, "execute", _corrupt(which))
    driver.open(ta.Session(device="cpu", max_batch=MIX["max_batch"], kernel="pallas"))
    rec = clients.Records(sample=MIX["check_sample"], rng=random.Random(0))
    driver.run(rec, requests=2)
    driver.close()
    assert rec.attempted == 2 and rec.failed == 0
    assert dict(driver.batch_sizes) == {3: 2}  # each request one dispatch of its three queries
    readings, _ = check.compare(driver, rec, "cpu")
    if which is None:
        assert readings == {"mismatched_edges": 0, "kmax_mismatches": 0, "failed_requests": 0}
    elif which == "kmax":
        assert readings["kmax_mismatches"] == 2 and readings["mismatched_edges"] == 0
    else:
        assert readings["mismatched_edges"] == 2 and readings["kmax_mismatches"] == 0
    assert check.verdict(readings) is (which is None)


@pytest.mark.parametrize("key", ["generator", "log2_n", "numbering", "dedup", "reduced"])
def test_the_shared_queries_configuration_draws_delaunay_n20s_graph(key):
    """``delaunay_n20_q3`` is ``delaunay_n20``'s mesh, uncut, asked other
    questions: every key that makes the graph is the same."""
    assert CONFIG[key] == MESH[key]


def test_the_shared_queries_configuration_asks_what_its_cell_runs():
    """The configuration's questions are its mix's, and its cell runs it
    under its own source."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert CONFIG["queries"] == MIX["queries"]
    cell = {w["name"]: w for w in bench["workloads"]}["delaunay20_shared_q3"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG["name"], "shared_q3", 1)
    entries = {c["name"]: c for c in bench["configs"]}
    assert entries[CONFIG["name"]]["file"] == "ktbench/configs/delaunay_n20_q3.json"
    assert entries[CONFIG["name"]]["reduced"] == []
    assert entries[CONFIG["name"]]["source"] != entries[MESH["name"]]["source"]
