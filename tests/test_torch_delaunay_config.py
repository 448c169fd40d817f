"""The benchmark's Delaunay graph (``delaunay_n20``, the 10th DIMACS
Challenge's rule, vertex ids in ascending degree) on the CPU: the
generator against Qhull's triangulation of its own points, read another
way and renumbered by a numpy sort; at full size, the published edge count
and the auto rule's plan (``fine/pallas/aligned``: the unfused path of the
support kernel); at 2**12 points, the port's ``Session`` decompose on that
path against the benchmark's plain reference and the JAX package, edge for
edge; and the unfused trip loop's counters (``peel_trips``,
``peel_support_passes``, ``peel_support_lanes``) against what its support
function was given (``peel_support_claims``, the support kernel's own
count, absent off the card).  On a card, the trip graph's counters and
state against the same trips driven one at a time."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the benchmark's package, ktbench

import repro_torch.api as ta  # noqa: E402
import repro_torch.kernels.ops as kernel_ops  # noqa: E402
from ktbench import generators, reference  # noqa: E402
from repro_torch.api.registry import choose_backend  # noqa: E402
from repro_torch.exec import peel as pm  # noqa: E402
from repro_torch.graphs.csr import from_edges  # noqa: E402
from repro_torch.graphs.stats import imbalance_stats  # noqa: E402
from repro_torch.obs import names  # noqa: E402
from repro_torch.obs.names import (  # noqa: E402
    PEEL_SUPPORT_CLAIMS,
    PEEL_SUPPORT_LANES,
    PEEL_SUPPORT_PASSES,
    PEEL_TRIPS,
)
from ktbench.spec import load_reader  # noqa: E402

CONFIG = json.loads((ROOT / "ktbench" / "configs" / "delaunay_n20.json").read_text())
PUBLISHED_EDGES = 3_145_686  # SuiteSparse DIMACS10/delaunay_n20
SEED = 2_147_483_659  # beyond 32 bits, as the benchmark's seeds are
PINNED = "fine/pallas/aligned"


def _graph(log2_n: int, seed: int = SEED, index: int = 0):
    return generators.config_graph(dict(CONFIG, log2_n=log2_n), seed, index)


@pytest.mark.parametrize("seed", [5, SEED])
@pytest.mark.parametrize("log2_n", [12, 14])
def test_generator_equals_qhull_renumbered_by_degree(log2_n, seed):
    """The edges are Qhull's Delaunay neighbours of the generator's own
    points (read from ``vertex_neighbor_vertices``, not the triangles), ids
    renumbered by a stable numpy sort of the degrees, in canonical order;
    a planar triangulation of ``n`` points with ``h`` on the hull has ``3n
    - 3 - h`` edges, and no point lies inside a triangle's circumcircle."""
    spatial = pytest.importorskip("scipy.spatial")
    rgg = generators.by_file.load("graph_generators", "rgg", "generator")
    n, edges = _graph(log2_n, seed)
    pts = rgg.points(n, generators.derived_seed(seed, 0), "cpu").numpy()
    tri = spatial.Delaunay(pts)
    indptr, nbrs = tri.vertex_neighbor_vertices
    deg = np.diff(indptr)
    new_id = np.empty(n, np.int64)
    new_id[np.argsort(deg, kind="stable")] = np.arange(n)
    a = new_id[np.repeat(np.arange(n), deg)]
    b = new_id[nbrs]
    keys = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    want = np.stack([keys // n, keys % n], 1)
    assert edges.dtype == np.int64 and np.array_equal(edges, want)
    hull = spatial.ConvexHull(pts).vertices.size
    assert edges.shape[0] == 3 * n - 3 - hull
    # Degrees ascend with the ids.
    got_deg = np.bincount(edges.reshape(-1), minlength=n)
    assert np.all(np.diff(got_deg) >= 0)
    # The empty-circle rule: each triangle's circumcircle holds no other point.
    p = pts[tri.simplices]
    ax, ay, bx, by, cx, cy = (p[:, i, j] for i in range(3) for j in range(2))
    d = 2 * (ax * (by - cy) + bx * (cy - ay) + cx * (ay - by))
    sa, sb, sc = ax**2 + ay**2, bx**2 + by**2, cx**2 + cy**2
    ux = (sa * (by - cy) + sb * (cy - ay) + sc * (ay - by)) / d
    uy = (sa * (cx - bx) + sb * (ax - cx) + sc * (bx - ax)) / d
    r = np.hypot(ax - ux, ay - uy)
    dist, idx = spatial.cKDTree(pts).query(np.stack([ux, uy], 1), k=4)
    other = (idx[:, :, None] != tri.simplices[:, None, :]).all(2)  # not the triangle's own
    nearest_other = np.where(other, dist, np.inf).min(1)
    assert np.all(nearest_other >= r * (1 - 1e-9))


def test_full_size_graph_has_the_published_size_and_plans_the_support_kernel():
    pytest.importorskip("scipy.spatial")
    n, edges = _graph(CONFIG["log2_n"])
    assert n == 1_048_576
    assert abs(edges.shape[0] - PUBLISHED_EDGES) <= 1e-4 * PUBLISHED_EDGES
    stats = imbalance_stats(from_edges(n, edges, name="delaunay20"), device="cpu")
    assert stats.coarse_imbalance < 8.0  # below the auto rule's fused threshold
    assert stats.max_degree <= 32
    assert str(choose_backend(stats, kernel="pallas")) == PINNED


@pytest.fixture(scope="module")
def small():
    """A 2**12-point graph, the plain reference's trussness and the JAX
    package's decompose of it (imported here: the card has no JAX)."""
    pytest.importorskip("scipy.spatial")
    import repro.api as ra
    import repro.graphs as rg

    n, edges = _graph(12)
    want = reference.trussness(n, edges, "cpu")
    jax_res = ra.solve([ra.TrussQuery.decompose(rg.from_edges(n, edges, name="delaunay12"))])[0]
    return n, edges, want, jax_res


@pytest.mark.parametrize("how", ["pinned", "auto_pallas"])
def test_session_decompose_equals_the_references_at_2_12(small, how):
    """The unfused support-kernel backend pinned, and the auto rule asked
    for the hand-kernel path (it plans the same backend, as on the card)."""
    n, edges, want, jax_res = small
    kw = {"pinned": {"backend": PINNED}, "auto_pallas": {"kernel": "pallas"}}[how]
    s = ta.Session(device="cpu", max_batch=8, **kw)
    got = s.solve([ta.TrussQuery.decompose(from_edges(n, edges, name="delaunay12"))])[0]
    assert np.array_equal(np.asarray(jax_res.trussness), want)
    assert int(jax_res.kmax) == int(want.max()) >= 4
    assert np.array_equal(got.trussness, want)
    assert got.kmax == int(want.max())
    (planned,) = s.stats()["planner_backends"]
    assert planned["backend"] == PINNED


def test_trip_loop_counts_its_trips_and_support_lanes(small, monkeypatch):
    """``peel_trips`` is the dispatch's trips (``total_iters``) and
    ``peel_support_lanes`` the sum, over its trips, of the lanes the support
    function was given; the ``dispatch`` span carries both.  A decompose
    beside a ``ktruss(3)`` member, whose slot retires first: its lanes leave
    the later trips' masks."""
    n, edges, want, _ = small
    given = []
    inner = kernel_ops.support_fine

    def spy(p, alive, **kw):
        given.append(int(alive.sum()))
        return inner(p, alive, **kw)

    monkeypatch.setattr(kernel_ops, "support_fine", spy)
    g = from_edges(n, edges, name="delaunay12")
    s = ta.Session(device="cpu", backend=PINNED, max_batch=8, trace=True)
    fut = s.submit(ta.TrussQuery.decompose(g))
    s.submit(ta.TrussQuery.ktruss(g, k=3))
    s.flush()
    assert np.array_equal(fut.result().trussness, want)
    counters = s.metrics_snapshot()["counters"]
    trips = fut.stats.dispatch_trips
    assert counters[PEEL_TRIPS] == trips == len(given) > 1
    assert counters[PEEL_SUPPORT_LANES] == sum(given) > 0
    assert counters[PEEL_SUPPORT_PASSES] == 0  # off the card every launch counts itself
    assert PEEL_SUPPORT_CLAIMS not in counters  # the kernel's claims: a card count
    assert given[-1] < given[0]  # the retired ktruss slot's lanes left the masks
    (dispatch,) = [e["args"] for e in s.obs.tracer.events() if e["name"] == "dispatch"]
    assert (dispatch["trips"], dispatch["support_lanes"]) == (trips, sum(given))


def test_lock_step_sums_the_counts_of_its_shards():
    """Two shards of unequal trips in one lock step: each counter adds both
    shards' counts, and the span attributes hold their sums (the live and
    walked slots too)."""
    from repro_torch.api import bucket_for
    from repro_torch.core import prepare_fine
    from repro_torch.obs import MetricsRegistry, use_registry

    gs = [from_edges(*_graph(9, seed=seed), name=f"d9-{seed}") for seed in (1, 2)]
    shards = []
    for g in gs:
        p = prepare_fine(g, chunk=64, device="cpu")
        nnzp = p.nnz_pad
        shards.append((p, torch.zeros(nnzp, dtype=torch.int32),
                       torch.tensor([3], dtype=torch.int32), torch.zeros(1, dtype=torch.bool),
                       p.colidx != 0, torch.zeros(nnzp, dtype=torch.bool),
                       torch.zeros(nnzp, dtype=torch.int32)))
    window = max(bucket_for(g, chunk=64).window for g in gs)
    plain = pm.make_problem_support(mode="owner", window=window, chunk=64)
    given = []

    def spy(p, alive):
        given.append(int(alive.sum()))
        return plain(p, alive)

    attrs, reg = {}, MetricsRegistry()
    with use_registry(reg):
        states = pm.build_peel(spy).lock_step(shards, limit=10_000, span_attrs=attrs)
    trips = [int(st.total_iters) for st in states]
    assert trips[0] != trips[1]
    counters = reg.snapshot()["counters"]
    assert counters[PEEL_TRIPS] == sum(trips) == len(given) == attrs["trips"]
    assert counters[PEEL_SUPPORT_LANES] == sum(given) == attrs["support_lanes"] > 0
    assert (attrs["members"], attrs["walked_slots"]) == (2, 2)  # one live slot a shard


@pytest.mark.parametrize(
    "const",
    ["PEEL_TRIPS", "PEEL_SUPPORT_PASSES", "PEEL_SUPPORT_LANES", "PEEL_TRIP_LANES_WALKED",
     "PEEL_SUPPORT_CLAIMS"],
)
def test_trip_loop_counters_are_declared_constants(const):
    """Each counter of the unfused trip loop is an exported constant of
    ``repro_torch.obs.names`` whose value is a declared counter, and the
    peel files it by that constant."""
    assert const in names.__all__
    assert getattr(names, const) in names.COUNTERS
    peel = (ROOT / "src" / "repro_torch" / "exec" / "peel.py").read_text()
    assert f"registry.inc({const}," in peel


@pytest.mark.parametrize("metric", ["support_claims_per_trip.delaunay",
                                    "support_claims_per_trip.q3"])
@pytest.mark.parametrize("counts, want", [
    ({PEEL_TRIPS: 860, PEEL_SUPPORT_CLAIMS: 860 * 4_000}, 4_000.0),
    ({PEEL_TRIPS: 860}, None),  # off the card, or a program that does not count its claims
    ({PEEL_SUPPORT_CLAIMS: 5}, None),
])
def test_support_claims_reader_is_the_ratio_of_two_counters(monkeypatch, metric, counts, want):
    """The benchmark's reader of the support kernel's claims a trip: the
    program's claims over its trips, nothing where either is absent; the
    shared-queries cell's reader forwards to the Delaunay cell's."""
    import repro_torch.obs as program_obs
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    for name, value in counts.items():
        reg.inc(name, value)
    monkeypatch.setattr(program_obs, "get_registry", lambda: reg)
    ctx = type("Ctx", (), {"device": "cuda"})()
    assert load_reader("layer_metrics", metric).read(ctx) == want


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
def _card_case(cuda, which: str, monkeypatch):
    """One decompose through a session pinned to the unfused path, its
    lock step's inputs and states recorded, with its registry's counters."""
    from repro_torch.configs import LARGE_GRAPHS

    if which == "delaunay14":
        pytest.importorskip("scipy.spatial")
        g = from_edges(*_graph(14), name="delaunay14")
    else:
        g = LARGE_GRAPHS[0].factory()  # rmat-15
    seen = {}
    lock_step = pm._Peel.lock_step

    def spy(self, shards, limit, **kw):
        seen["shards"], seen["limit"] = shards, limit
        seen["states"] = lock_step(self, shards, limit, **kw)
        return seen["states"]

    monkeypatch.setattr(pm._Peel, "lock_step", spy)
    s = ta.Session(device=cuda, backend=PINNED, max_batch=8)
    s.solve([ta.TrussQuery.decompose(g)])
    return s, s.executor_for(g), seen


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["delaunay14", "rmat15"])
def test_trip_graph_counts_equal_the_eager_loop(which, monkeypatch):
    """The trip graph's ``peel_trips``, ``peel_support_passes`` and
    ``peel_support_lanes`` equal the same trips driven one at a time on the
    card (``_EagerTrips``, each support pass launched and counted by the
    host), and its state equals theirs field for field."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the trip graph has no CPU mode)")
    from repro_torch.kernels import support_fine_cuda

    cuda = torch.device("cuda")
    s, exe, seen = _card_case(cuda, which, monkeypatch)
    (shard,), limit = seen["shards"], seen["limit"]
    p, slot_ids, k0, single, alive0, frozen, ftruss = shard
    sums = pm._SlotSums(slot_ids, int(k0.shape[0]), aligned=True)
    st = pm.init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss, sums=sums)
    step = (p, slot_ids.long(), sums, single, frozen, ftruss)
    eager = pm._EagerTrips(exe.support, step, st, limit)
    before = support_fine_cuda.launches
    eager.run()
    passes = support_fine_cuda.launches - before
    counters = s.metrics_snapshot()["counters"]
    trips = int(eager.st.total_iters)
    assert counters[PEEL_TRIPS] == trips > 1
    assert counters[PEEL_SUPPORT_PASSES] == passes == trips
    assert counters[PEEL_SUPPORT_LANES] == int(eager.support_lanes) > 0
    # Each pass over a nonempty list claims; an eager pass's claims are not filed.
    assert passes <= counters[PEEL_SUPPORT_CLAIMS] < 8_000 * passes
    (graph_state,) = seen["states"]
    for name, a, b in zip(pm.PeelState._fields, graph_state, eager.st):
        assert torch.equal(a, b), name
