"""Port parity, front door: ``solve()``/``Session`` on a mixed query set give
the JAX package's results and the same dispatches per bucket; the registry,
auto rule and device defaults behave as the port promises; a batch that
mixes stream updates with ordinary queries gets its frozen lanes built on
the device and reads back only what its members return."""

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


@pytest.mark.parametrize("row_chunk", [8, 32])
def test_registry_executor_takes_row_chunk_like_reference(row_chunk):
    """``BackendSpec.make_executor(row_chunk=...)`` builds a coarse executor
    whose peel equals the reference's on the same pack."""
    from repro.graphs import pack_problems
    from _torch_parity import torch_problem

    graphs = [g for g, _ in small_pairs()][:2]
    buckets = [ra.bucket_for(g, chunk=64) for g in graphs]
    window = max(b.window for b in buckets)
    slots, slot_nnz = 2, max(b.nnz_pad for b in buckets)
    pp = pack_problems(graphs, slot_n=max(b.n_pad for b in buckets), slot_nnz=slot_nnz,
                       slots=slots, chunk=64, layout="aligned")
    slot_ids = np.repeat(np.arange(slots, dtype=np.int32), slot_nnz)
    kw = dict(window=window, chunk=64, row_chunk=row_chunk)
    ref = ra.get_backend("coarse/xla/aligned").make_executor(**kw).peel(
        pp.problem, slot_ids=slot_ids, k0=[3, 4]
    )
    tex = ta.get_backend("coarse/xla/aligned").make_executor(**kw)
    got = tex.peel(torch_problem(pp.problem), slot_ids=slot_ids, k0=[3, 4])
    assert tex.support.keywords["row_chunk"] == row_chunk
    for f in ref._fields:
        assert np.array_equal(np.asarray(getattr(ref, f)), getattr(got, f).numpy()), f


def _three(api, g):
    return [api.TrussQuery.decompose(g), api.TrussQuery.kmax(g), api.TrussQuery.ktruss(g, k=4)]


@pytest.mark.parametrize("backend", [None, "fine/xla/contig"])
def test_a_batch_on_one_graph_lifts_it_once_and_reads_back_once_in_plan(monkeypatch, backend):
    """Three queries on one graph object: its arrays go to the device once,
    in ``plan``, which reads back once for the batch; ``pack`` copies and
    reads back nothing.  The answers are the reference's, the caller's
    graph is left alone, and no lift outlives the dispatch."""
    from _torch_traffic import plan_pack_traffic

    gr, gt = small_pairs()[0]
    kw = dict(backend=backend, chunk=64, max_batch=8)
    want = ra.Session(**kw).solve(_three(ra, gr))
    session = ta.Session(device="cpu", **kw)
    got, lifts, reads = plan_pack_traffic(monkeypatch, session, _three(ta, gt), gt)
    assert lifts == ["plan", "plan"]  # rowptr and colidx, once
    assert reads == {"plan": 1, "pack": 0}
    for r, t in zip(want, got):
        _same_result(r, t)
    assert "_lifted" not in gt.__dict__ and len(session.planner._lifts) == 0
    assert session.stats()["device_dispatches"] == 1


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = small_pairs()[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.solve(ta.TrussQuery.kmax(gt))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.Session()


def test_typed_dispatch_failure_fails_the_batch_futures():
    """Under the resilience runner (the reference's semantics, reference
    ``tests/test_resilience.py::test_peel_iteration_cap_is_a_typed_device_error``)
    each future fails with a terminal ``QueryFailedError`` whose cause is the
    peel's iteration-cap ``DeviceError``."""
    from repro_torch.resilience import RetryPolicy

    _, gt = small_pairs()[0]
    s = ta.Session(
        device="cpu",
        max_iters=1,
        retry=RetryPolicy(max_attempts=1, backoff_base_s=0.0, fallback=False),
        **KW,
    )
    futs = [s.submit(ta.TrussQuery.decompose(gt)), s.submit(ta.TrussQuery.kmax(gt))]
    s.flush()
    for f in futs:
        with pytest.raises(ta.QueryFailedError) as ei:
            f.result()
        assert ei.value.query_id == f.request.id
        assert isinstance(ei.value.cause, ta.DeviceError)
        assert ei.value.cause.site == "peel" and not ei.value.cause.injected
        assert "iteration cap" in str(ei.value.cause)
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


def _mixed_stream_batch(api, g, truss, frontier, as_tensor):
    """Every workload in one bucket: two stream updates (the port's given
    as tensors when ``as_tensor``) between ordinary members."""
    frozen = np.where(frontier, 0, truss).astype(np.int32)
    other = ~frontier
    lanes = [(frontier, frozen), (other, np.where(other, 0, truss).astype(np.int32))]
    if as_tensor:
        lanes[0] = tuple(torch.from_numpy(x) for x in lanes[0])
    return [
        api.TrussQuery.decompose(g),
        api.TrussQuery.stream_update(g, frontier=lanes[0][0], frozen_truss=lanes[0][1]),
        api.TrussQuery.kmax(g),
        api.TrussQuery.ktruss(g, k=4),
        api.TrussQuery.stream_update(g, frontier=lanes[1][0], frozen_truss=lanes[1][1]),
        api.TrussQuery.decompose(g, k_start=4),
    ]


def _stream_inputs():
    gr, gt = small_pairs()[1]
    truss = ra.solve(ra.TrussQuery.decompose(gr), **KW).trussness
    frontier = np.random.default_rng(6).random(gr.nnz) < 0.3
    return gr, gt, truss, frontier


def test_stream_lanes_are_built_on_the_device_as_the_reference_builds_them(monkeypatch):
    """The planner's ``alive0``/``frozen``/``frozen_truss`` for a batch that
    mixes stream updates (tensor and numpy inputs) with ordinary members
    equal the reference's numpy build over the pack's edge ranges."""
    import repro_torch.api.planner as tp
    from repro_torch.exec import PeelExecutor

    _, gt, truss, frontier = _stream_inputs()
    seen = {}
    real_pack, real_peel = tp.pack_problems, PeelExecutor.peel

    def pack(*a, **k):
        seen["packed"] = real_pack(*a, **k)
        return seen["packed"]

    def peel(self, p, **kw):
        seen.update(kw)
        return real_peel(self, p, **kw)

    monkeypatch.setattr(tp, "pack_problems", pack)
    monkeypatch.setattr(PeelExecutor, "peel", peel)
    queries = _mixed_stream_batch(ta, gt, truss, frontier, as_tensor=True)
    ta.Session(device="cpu", backend="fine/xla/aligned", chunk=64, max_batch=8).solve(queries)
    packed = seen["packed"]
    nnzp = packed.problem.nnz_pad
    alive_np = np.zeros(nnzp, bool)
    for a, b in packed.edge_ranges:
        alive_np[a:b] = True
    frozen_np = np.zeros(nnzp, bool)
    ft_np = np.zeros(nnzp, np.int32)
    for q, (a, b) in zip(queries, packed.edge_ranges):
        if q.workload == "stream_update":
            f = np.asarray(q.frontier)
            alive_np[a:b] = f
            frozen_np[a:b] = ~f
            ft_np[a:b] = np.asarray(q.frozen_truss)
    for name, want in (("alive0", alive_np), ("frozen", frozen_np), ("frozen_truss", ft_np)):
        got = seen[name]
        assert got.device.type == "cpu" and got.dtype == torch.from_numpy(want).dtype, name
        assert np.array_equal(got.numpy(), want), name


def test_mixed_batch_unpacks_each_result_as_the_reference_and_reads_back_only_those(monkeypatch):
    """Every workload's result (type name, dtype, values) equals the
    reference's in one mixed batch, and the dispatch reads back one tensor:
    the per-slot counters plus each member's returned ranges."""
    gr, gt, truss, frontier = _stream_inputs()
    kw = dict(chunk=64, max_batch=8)
    want = ra.Session(backend="fine/xla/aligned", **kw).solve(
        _mixed_stream_batch(ra, gr, truss, frontier, as_tensor=False)
    )
    session = ta.Session(device="cpu", backend="fine/xla/aligned", **kw)
    session.solve([ta.TrussQuery.kmax(gt)])  # built and warm
    queries = _mixed_stream_batch(ta, gt, truss, frontier, as_tensor=True)
    sizes = []
    real_cpu = torch.Tensor.cpu

    def cpu(t, *a, **k):
        sizes.append(t.numel())
        return real_cpu(t, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    futs = [session.submit(q) for q in queries]
    session.flush()
    got = [f.result() for f in futs]
    monkeypatch.undo()
    per_member = {"decompose": 1, "stream_update": 1, "kmax": 0, "ktruss": 2}
    assert sizes == [4 * 8 + 1 + gt.nnz * sum(per_member[q.workload] for q in queries)]
    for q, r, t, f in zip(queries, want, got, futs):
        assert type(t).__name__ == type(r).__name__, q.workload
        if q.workload == "stream_update":
            assert t.dtype == r.dtype and np.array_equal(t, r)
            dev = f.request.device_result
            assert dev.dtype == torch.int32 and np.array_equal(dev.numpy(), t)
        else:
            _same_result(r, t)
        if q.workload == "ktruss":
            assert t.alive.dtype == r.alive.dtype and type(t.edges_remaining) is int
        elif q.workload == "decompose":
            assert type(t.kmax) is int and type(t.levels) is int


def test_stream_update_lanes_as_tensors_keep_the_shape_checks():
    _, gt, truss, frontier = _stream_inputs()
    q = ta.TrussQuery.stream_update(
        gt, frontier=torch.from_numpy(frontier).int(), frozen_truss=torch.from_numpy(truss).long()
    )
    assert q.frontier.dtype == torch.bool and q.frozen_truss.dtype == torch.int32
    with pytest.raises(ValueError, match="must cover all"):
        ta.TrussQuery.stream_update(
            gt, frontier=torch.from_numpy(frontier[:-1]), frozen_truss=torch.from_numpy(truss)
        )
    with pytest.raises(ValueError, match="requires frontier"):
        ta.TrussQuery.stream_update(gt, frontier=None, frozen_truss=torch.from_numpy(truss))
