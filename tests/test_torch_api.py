"""Port parity, front door: ``solve()``/``Session`` on a mixed query set give
the JAX package's results and the same dispatches per bucket; the registry,
auto rule and device defaults behave as the port promises."""

import numpy as np
import pytest
import torch

import repro.api as ra
import repro_torch.api as ta
from _torch_parity import small_pairs, torch_graph
from repro.graphs import road

KW = dict(chunk=64, max_batch=4)


def _queries(api, graphs):
    """A mixed set: decompose/kmax/ktruss over several graphs (and buckets)."""
    g0, g1, g2 = graphs
    return [
        api.TrussQuery.decompose(g0),
        api.TrussQuery.kmax(g1),
        api.TrussQuery.ktruss(g2, k=4),
        api.TrussQuery.ktruss(g0, k=5),
        api.TrussQuery.decompose(g2, k_start=4),
        api.TrussQuery.kmax(g0),
    ]


def _same_result(r, t):
    if isinstance(r, int):
        assert t == r
    elif isinstance(r, ra.KTrussResult):
        assert (t.k, t.iterations, t.edges_remaining) == (r.k, r.iterations, r.edges_remaining)
        assert np.array_equal(t.alive, r.alive) and np.array_equal(t.support, r.support)
        assert t.support.dtype == r.support.dtype
    else:
        assert (t.kmax, t.levels) == (r.kmax, r.levels)
        assert np.array_equal(t.trussness, r.trussness)
        assert t.trussness.dtype == r.trussness.dtype


@pytest.mark.parametrize("backend", [None, "fine/pallas/aligned", "fine/xla/contig"])
def test_mixed_solve_matches_reference_results_and_dispatches(backend):
    pairs = small_pairs()
    rs = ra.Session(backend=backend, **KW)
    ts = ta.Session(backend=backend, device="cpu", **KW)
    want = rs.solve(_queries(ra, [g for g, _ in pairs]))
    got = ts.solve(_queries(ta, [g for _, g in pairs]))
    for r, t in zip(want, got):
        _same_result(r, t)
    rst, tst = rs.stats(), ts.stats()
    for key in ("device_dispatches", "batches_run", "requests_served"):
        assert tst[key] == rst[key], key
    assert tst["planner_backends"] == rst["planner_backends"]


def test_one_dispatch_per_bucket_and_auto_rule_on_cpu():
    """On the CPU the auto rule uses kernel ``xla`` like the reference:
    coarse for a balanced road grid, fine for skewed graphs."""
    gr = [g for g, _ in small_pairs()] + [road(8, 0.1, seed=3)]
    s = ta.Session(device="cpu", **KW)
    s.solve([ta.TrussQuery.decompose(torch_graph(g)) for g in gr])
    rows = {r["backend"] for r in s.stats()["planner_backends"]}
    ref = ra.Session(**KW)
    ref.solve([ra.TrussQuery.decompose(g) for g in gr])
    assert rows == {r["backend"] for r in ref.stats()["planner_backends"]}
    assert "coarse/xla/aligned" in rows and "fine/xla/aligned" in rows
    buckets = {r["bucket"] for r in s.stats()["planner_backends"]}
    assert s.stats()["device_dispatches"] == len(buckets)


def test_stream_update_matches_reference():
    """Frozen lanes through the front door: re-peel a frontier."""
    gr, gt = small_pairs()[1]
    truss = ra.solve(ra.TrussQuery.decompose(gr), **KW).trussness
    frontier = np.random.default_rng(4).random(gr.nnz) < 0.25
    want = ra.solve(ra.TrussQuery.stream_update(gr, frontier=frontier, frozen_truss=truss), **KW)
    got = ta.solve(
        ta.TrussQuery.stream_update(gt, frontier=frontier, frozen_truss=truss), device="cpu", **KW
    )
    assert np.array_equal(got, want) and np.array_equal(got, truss)


def test_backend_grid_spellings_and_default_kernel():
    port = {str(k) for k in ta.available_backends()}
    assert port == {str(k) for k in ra.available_backends()}
    assert ta.get_backend("fine/pallas/aligned").mode == "owner"
    assert ta.get_backend("fine/fused/aligned").mode == "owner"
    assert ta.default_kernel("cpu") == "xla" and ta.default_kernel("cuda") == "pallas"
    with pytest.raises(KeyError):
        ta.get_backend("fine/fused/contig")


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = small_pairs()[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.solve(ta.TrussQuery.kmax(gt))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.Session()


def test_typed_dispatch_failure_fails_the_batch_futures():
    _, gt = small_pairs()[0]
    s = ta.Session(device="cpu", max_iters=1, **KW)
    futs = [s.submit(ta.TrussQuery.decompose(gt)), s.submit(ta.TrussQuery.kmax(gt))]
    s.flush()
    for f in futs:
        with pytest.raises(ta.DeviceError, match="iteration cap"):
            f.result()
    assert s.stats()["queries_failed"] == 2


def test_session_metrics_views():
    _, gt = small_pairs()[2]
    s = ta.Session(device="cpu", backend="fine/pallas/aligned", **KW)
    s.solve([ta.TrussQuery.decompose(gt), ta.TrussQuery.kmax(gt)])
    snap = s.metrics_snapshot()
    assert snap["counters"]["dispatches"] == 1
    assert snap["counters"]["peel_dispatches"] == 1
    exe = s.executor_for(gt)
    assert exe.dispatches == 1 and exe.host_syncs >= 2
    assert "peel_slot_iters" in s.prometheus_text()
