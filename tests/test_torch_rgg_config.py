"""The benchmark's random geometric graph (``rgg_n_2_20_s0``, the 10th DIMACS
Challenge's rule) on the CPU: the generator against an all-pairs check of
its own points; at full size, the published edge count and the auto rule's
plan (``fine/fused/aligned``: the graph is not balanced enough for the
support kernel); at 2**12 points, the port's ``Session`` decompose against
the benchmark's plain reference and the JAX package, edge for edge; and the
plain fused level's count of the lanes its trips counted
(``peel_level_lanes_counted``)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the benchmark's package, ktbench

import repro.api as ra  # noqa: E402
import repro.graphs as rg  # noqa: E402
import repro_torch.api as ta  # noqa: E402
import repro_torch.kernels.peel_fused as kpf  # noqa: E402
from ktbench import generators, reference  # noqa: E402
from repro_torch.api.registry import choose_backend  # noqa: E402
from repro_torch.graphs.csr import from_edges  # noqa: E402
from repro_torch.graphs.stats import imbalance_stats  # noqa: E402
from repro_torch.obs.names import PEEL_LEVEL_LANES_COUNTED, PEEL_LEVEL_TRIPS  # noqa: E402

CONFIG = json.loads((ROOT / "ktbench" / "configs" / "rgg_n_2_20_s0.json").read_text())
PUBLISHED_EDGES = 6_891_620  # SuiteSparse DIMACS10/rgg_n_2_20_s0
SEED = 2_147_483_659  # beyond 32 bits, as the benchmark's seeds are


def _graph(log2_n: int, seed: int = SEED, index: int = 0):
    return generators.config_graph(dict(CONFIG, log2_n=log2_n), seed, index)


@pytest.mark.parametrize("seed", [5, SEED])
def test_generator_equals_all_pairs_at_2_10(seed):
    """Every pair of the generator's own points (in its spatial numbering)
    closer than the radius, found by comparing all pairs, in canonical
    order; ids follow the points' row-major cells, then x."""
    rgg = generators.by_file.load("graph_generators", "rgg", "generator")
    n, edges = _graph(10, seed)
    pts = rgg.points(n, generators.derived_seed(seed, 0), "cpu")
    r = rgg.radius(n, CONFIG["radius_factor"])
    side = int(1 / r)
    ordered, cell = rgg.spatial_order(pts, side)
    assert torch.all(cell[1:] >= cell[:-1])
    same = cell[1:] == cell[:-1]
    assert torch.all(ordered[1:, 0][same] > ordered[:-1, 0][same])
    i, j = torch.triu_indices(n, n, 1)
    d = ordered[i] - ordered[j]
    near = (d * d).sum(1) < r * r
    want = torch.stack([i[near], j[near]], 1).numpy()
    assert edges.dtype == np.int64 and edges.shape == want.shape and len(want) > 2 * n
    assert set(map(tuple, edges.tolist())) == set(map(tuple, want.tolist()))
    assert np.array_equal(edges, want)


def test_full_size_graph_has_the_published_size_and_plans_the_fused_kernel():
    n, edges = _graph(CONFIG["log2_n"])
    assert n == 1_048_576
    assert abs(edges.shape[0] - PUBLISHED_EDGES) <= 0.005 * PUBLISHED_EDGES
    stats = imbalance_stats(from_edges(n, edges, name="rgg20"), device="cpu")
    assert stats.max_degree <= 40  # short rows: no row near the split threshold
    assert str(choose_backend(stats, kernel="pallas")) == "fine/fused/aligned"


@pytest.fixture(scope="module")
def small():
    """A 2**12-point graph, the plain reference's trussness and the JAX
    package's decompose of it."""
    n, edges = _graph(12)
    want = reference.trussness(n, edges, "cpu")
    jax_res = ra.solve([ra.TrussQuery.decompose(rg.from_edges(n, edges, name="rgg12"))])[0]
    return n, edges, want, jax_res


@pytest.mark.parametrize("how", ["auto", "auto_pallas", "fused"])
def test_session_decompose_equals_the_references_at_2_12(small, how):
    """The auto rule on the CPU's default kernel, the auto rule asked for
    the hand-kernel path (it plans the fused kernel, as on the card), and
    the fused backend pinned."""
    n, edges, want, jax_res = small
    kw = {"auto": {}, "auto_pallas": {"kernel": "pallas"},
          "fused": {"backend": "fine/fused/aligned"}}[how]
    s = ta.Session(device="cpu", max_batch=2, **kw)
    got = s.solve([ta.TrussQuery.decompose(from_edges(n, edges, name="rgg12"))])[0]
    assert np.array_equal(np.asarray(jax_res.trussness), want)
    assert int(jax_res.kmax) == int(want.max()) >= 5
    assert np.array_equal(got.trussness, want)
    assert got.kmax == int(want.max())
    (planned,) = s.stats()["planner_backends"]
    if how != "auto":
        assert planned["backend"] == "fine/fused/aligned"


def test_plain_fused_level_counts_every_alive_lane_of_every_trip(monkeypatch):
    """``peel_level_lanes_counted`` of the plain version is the sum, over
    its trips, of the alive lanes each trip counted: a decompose beside a
    ``ktruss(3)`` member whose slot retires with its lanes alive (they are
    counted too, as the plain version counts them).  Each level's record
    carries its share."""
    n, edges = _graph(9)
    g = from_edges(n, edges, name="rgg9")
    counted_by_trip = []
    inner = kpf.support_fine_owner

    def spy(p, alive, **kw):
        counted_by_trip.append(int(alive.sum()))  # no frozen lane: alive | frozen_live = alive
        return inner(p, alive, **kw)

    monkeypatch.setattr(kpf, "support_fine_owner", spy)
    s = ta.Session(device="cpu", backend="fine/fused/aligned", max_batch=2, trace=True)
    fut = s.submit(ta.TrussQuery.decompose(g))
    s.submit(ta.TrussQuery.ktruss(g, k=3))
    s.flush()
    assert np.array_equal(fut.result().trussness, reference.trussness(n, edges, "cpu"))
    counters = s.metrics_snapshot()["counters"]
    total, trips = counters[PEEL_LEVEL_LANES_COUNTED], counters[PEEL_LEVEL_TRIPS]
    assert len(counted_by_trip) == trips
    assert total == sum(counted_by_trip) > 0
    done = [e["args"] for e in s.obs.tracer.events() if e["name"] == "peel-level.done"]
    assert sum(a["counted_lanes"] for a in done) == total
    # The live slot's alive lanes are among those the first trip counts.
    assert all(a["counted_lanes"] >= a["alive_lanes"] for a in done)
