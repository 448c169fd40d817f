"""Port parity, legacy adapter: ``repro_torch.service.TrussService`` (and the
``Session.open_stream`` / ``QueryState`` surface it rides on) against the
JAX package's adapter on the CPU; the coalescing and overlap rules of a
stream; and the import boundary of the packages added beside the port's
front door."""

import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.api as ra
import repro.service as rsv
import repro.stream as rs
import repro_torch.api as ta
import repro_torch.service as tsv
import repro_torch.stream as ts
from _torch_parity import assert_same, small_pairs, torch_graph
from repro.core import trussness_numpy
from repro.graphs import CSRGraph, erdos

KW = dict(max_batch=4, chunk=64)


def _same(r, t):
    if isinstance(r, int):
        assert t == r
    elif isinstance(r, np.ndarray):
        assert_same(r, t)
    elif isinstance(r, ra.KTrussResult):
        assert (t.k, t.iterations, t.edges_remaining) == (r.k, r.iterations, r.edges_remaining)
        assert_same(r.alive, t.alive)
        assert_same(r.support, t.support)
    else:
        assert (t.kmax, t.levels) == (r.kmax, r.levels)
        assert_same(r.trussness, t.trussness)


def _submit_all(svc, graphs):
    g0, g1, g2 = graphs
    return [
        svc.submit_decompose(g0),
        svc.submit_kmax(g1),
        svc.submit_ktruss(g2, 4),
        svc.submit(g0, "ktruss", k=5),
        svc.submit_decompose(g2, k_start=4),
        svc.submit_kmax(g0, k_start=4),
    ]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_submit_results_and_dispatches_match_reference(backend):
    pairs = small_pairs()
    rsvc = rsv.TrussService(backend=backend, **KW)
    tsvc = tsv.TrussService(backend=backend, device="cpu", **KW)
    want = _submit_all(rsvc, [g for g, _ in pairs])
    got = _submit_all(tsvc, [g for _, g in pairs])
    assert tsvc.stats()["pending"] == rsvc.stats()["pending"] == len(want)
    assert tsvc.flush() == rsvc.flush() == len(want)
    for r, t in zip(want, got):
        _same(r.result(), t.result())
    for name in ("device_dispatches", "batches_run", "requests_served"):
        assert tsvc.stats()[name] == rsvc.stats()[name], name
    assert (tsvc.requests_served, tsvc.batches_run, tsvc.device_dispatches) == (
        rsvc.requests_served, rsvc.batches_run, rsvc.device_dispatches)
    assert tsvc.stats()["planner_backends"] == rsvc.stats()["planner_backends"]
    assert tsvc.chunk == rsvc.chunk == 64 and tsvc.batcher is tsvc.session.queue
    with pytest.raises(ValueError, match="unknown workload"):
        tsvc.submit(pairs[0][1], "triangles")


def test_submit_stream_and_open_stream_match_reference():
    g, gt = small_pairs()[1]
    rsvc, tsvc = rsv.TrussService(**KW), tsv.TrussService(device="cpu", **KW)
    truss = rsvc.submit_decompose(g).result().trussness
    frontier = np.random.default_rng(4).random(g.nnz) < 0.25
    frozen_truss = np.where(frontier, 0, truss).astype(np.int32)
    want = rsvc.submit_stream(g, frontier=frontier, frozen_truss=frozen_truss).result()
    got = tsvc.submit_stream(gt, frontier=frontier, frozen_truss=frozen_truss).result()
    assert_same(want, got)
    assert_same(truss, got)
    # A stream opened on each adapter, two updates, the same answers.
    sr, st_ = rsvc.open_stream(g, trussness=truss), tsvc.open_stream(gt)
    assert st_.api is tsvc.session  # as the reference: the stream rides the session
    rng = np.random.default_rng(8)
    for _ in range(2):
        el = sr.graph.edge_list() - 1
        dels = [tuple(e) for e in el[rng.permutation(len(el))[:2]]]
        ins = [(0, 33), (5, 40)]
        a = sr.update(rs.EdgeBatch.of(ins, dels), strict=False)
        b = st_.update(ts.EdgeBatch.of(ins, dels), strict=False)
        assert_same(a.trussness, b.trussness)
        assert (a.frontier_size, a.dispatches) == (b.frontier_size, b.dispatches)
    assert st_.stats() == sr.stats()


def test_signature_is_the_reference_minus_mesh_plus_device():
    # The name is kept from before the port had a mesh: the adapter is now
    # the reference's plus ``device=``, ``mesh=`` and the ``mesh`` property
    # included.
    ref = inspect.signature(rsv.TrussService.__init__).parameters
    port = inspect.signature(tsv.TrussService.__init__).parameters
    assert set(port) == set(ref) | {"device"}
    for name in ref:
        assert port[name].default == ref[name].default, name
        assert port[name].kind == ref[name].kind, name
    assert port["device"].default is None
    public = {n for n in dir(rsv.TrussService) if not n.startswith("_")}
    assert "mesh" in public
    assert {n for n in dir(tsv.TrussService) if not n.startswith("_")} == public
    assert set(tsv.__all__) == set(rsv.__all__)
    assert tsv.TrussFuture is ta.TrussFuture and tsv.bucket_for is ta.bucket_for


def test_adapter_defaults_to_cuda_and_never_falls_back(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = small_pairs()[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsv.TrussService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.StreamingTrussSession.for_graph(gt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.edge_triangles(gt)


# --------------------------------------------------------------------- #
# Streams on one shared session: coalescing, overlap
# --------------------------------------------------------------------- #
def _oracle(gt):
    return trussness_numpy(CSRGraph(gt.n, gt.rowptr, gt.colidx)).astype(np.int32)


def test_concurrent_stream_updates_coalesce_into_one_dispatch():
    rng = np.random.default_rng(17)
    svc = tsv.TrussService(device="cpu", **KW)
    # 4 same-bucket graphs: 3 streams + 1 plain member.
    groups: dict = {}
    for s in range(64):
        g = torch_graph(erdos(60, 6.0, seed=s))
        bucket = ta.bucket_for(g, chunk=64)
        groups.setdefault(bucket, []).append(g)
        if len(groups[bucket]) == 4:
            graphs = groups[bucket]
            break
    sessions = [svc.open_stream(g) for g in graphs[:3]]
    before = svc.stats()["device_dispatches"]
    pend = []
    for sess in sessions:
        el = sess.graph.edge_list() - 1
        # Deletes only: the mutated graphs stay inside the shared bucket.
        dels = [tuple(e) for e in el[rng.permutation(len(el))[:2]]]
        pend.append(sess.submit_update(ts.EdgeBatch.of([], dels)))
    extra = svc.submit_decompose(graphs[3])
    assert svc.stats()["pending"] == 4
    svc.flush()
    assert svc.stats()["device_dispatches"] == before + 1
    for sess, p in zip(sessions, pend):
        res = p.result()
        assert res.dispatches == 1 and p.done()
        assert_same(_oracle(sess.graph), res.trussness)
    assert_same(_oracle(graphs[3]), extra.result().trussness)


def test_session_rejects_overlapping_updates_and_checkpoints():
    gt = torch_graph(erdos(40, 5.0, seed=0))
    s = ta.Session(device="cpu", max_batch=2, chunk=64)
    sess = s.open_stream(gt)
    sess.submit_update(ts.EdgeBatch.of([(0, 39)], []))
    with pytest.raises(RuntimeError, match="in-flight"):
        sess.submit_update(ts.EdgeBatch.of([(1, 38)], []))
    with pytest.raises(RuntimeError, match="in-flight"):
        sess.checkpoint("unused.npz")
    with pytest.raises(ValueError, match="checkpoint_every"):
        ts.StreamingTrussSession(s, gt, trussness=_oracle(gt), checkpoint_every=0)


# --------------------------------------------------------------------- #
# QueryState's legacy aliases
# --------------------------------------------------------------------- #
def test_query_state_aliases_match_reference():
    g, gt = small_pairs()[2]
    rq = ra.Session(**KW).submit(ra.TrussQuery.ktruss(g, k=4)).request
    tq = ta.Session(device="cpu", **KW).submit(ta.TrussQuery.ktruss(gt, k=4)).request
    assert tq.graph is gt and rq.graph is g
    assert (tq.workload, tq.k) == (rq.workload, rq.k) == ("ktruss", 4)


# --------------------------------------------------------------------- #
# Import boundary
# --------------------------------------------------------------------- #
def test_new_packages_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.stream, repro_torch.service, repro_torch.resilience\n"
        "from repro_torch.stream import StreamingTrussSession\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0 and "CLEAN" in proc.stdout, proc.stdout + proc.stderr
