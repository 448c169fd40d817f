"""Port parity, serving tier: ``repro_torch.serve`` (wire, replica, router,
fleet, client) against the JAX package's ``repro.serve``, on the CPU.

Frames are byte-compatible across the two packages (each decodes what the
other encodes); the router's policy runs over stub handles as in the
reference's tests; replica ops run in process; one fleet of three real
replica processes on ``device="cpu"`` answers like the reference's local
``solve()`` and hands a stream off warm after a kill; and a port replica
loads neither ``jax`` nor the reference package.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.errors as rerr
import repro.serve.wire as rw
import repro.stream as rstream
import repro_torch.api as ta
import repro_torch.serve as tserve
import repro_torch.serve.wire as tw
from _torch_parity import torch_graph
from repro.graphs import erdos, rmat
from repro_torch.api.cache import bucket_for, bucket_str
from repro_torch.errors import (
    DeviceError,
    InvalidGraphError,
    QueryFailedError,
    TrussTimeoutError,
)
from repro_torch.resilience import FaultPlan, FaultSpec, inject, use_plan
from repro_torch.serve import (
    Fleet,
    FleetClient,
    HealthReport,
    Replica,
    ReplicaConfig,
    ReplicaHandle,
    Router,
    health_report,
)
from repro_torch.serve.replica import _WARMUP_KINDS, _warm_graph
from repro_torch.stream import EdgeBatch

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))


def _fresh_edge(g):
    """One (u, v) not in ``g`` (0-based), deterministic."""
    existing = set(map(tuple, (g.edge_list() - 1)))
    for u in range(g.n):
        for v in range(u + 1, g.n):
            if (u, v) not in existing:
                return (u, v)
    raise AssertionError("graph is complete")


def _rt(obj):
    """Through JSON text, as a frame carries it."""
    return json.loads(json.dumps(obj))


# ------------------------------------------------------------------ #
# Wire protocol
# ------------------------------------------------------------------ #
def test_surface_and_constants_match_the_reference():
    import repro.serve as rs

    assert tserve.__all__ == rs.__all__
    assert tw.MAX_FRAME_BYTES == rw.MAX_FRAME_BYTES
    assert tw._ERROR_CONTEXT == rw._ERROR_CONTEXT
    assert tw._ERROR_CONTEXT_EXCLUDED == rw._ERROR_CONTEXT_EXCLUDED


def test_wire_framing_roundtrip_and_oversized_frames():
    a, b = socket.socketpair()
    try:
        tw.send_msg(a, {"op": "ping", "payload": [1, 2, 3]})
        tw.send_msg(a, {"op": "second"})
        assert tw.recv_msg(b) == {"op": "ping", "payload": [1, 2, 3]}
        assert tw.recv_msg(b) == {"op": "second"}
        a.close()
        assert tw.recv_msg(b) is None  # clean EOF at a frame boundary
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall((tw.MAX_FRAME_BYTES + 1).to_bytes(4, "big"))
        with pytest.raises(tw.WireError):
            tw.recv_msg(b)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("send, recv", [(rw, tw), (tw, rw)], ids=["ref-to-port", "port-to-ref"])
def test_frames_cross_the_packages_byte_for_byte(send, recv):
    """One package's frame on a socket is the other's, and decodes equal."""
    a, b = socket.socketpair()
    try:
        msg = {"op": "submit", "query": {"k": 3}, "x": [1.5, None, "s"]}
        send.send_msg(a, msg)
        assert recv.recv_msg(b) == msg
    finally:
        a.close()
        b.close()


def test_arrays_and_graphs_roundtrip_across_packages():
    rng = np.random.default_rng(3)
    for arr in (
        rng.integers(-(2**31), 2**31, size=(17,), dtype=np.int32),
        rng.integers(0, 2, size=(4, 9)).astype(bool),
        np.zeros((0, 2), np.int64),
    ):
        assert tw.encode_array(arr) == rw.encode_array(arr)
        out = tw.decode_array(_rt(rw.encode_array(arr)))
        assert out.dtype == arr.dtype and np.array_equal(out, arr)
    g = rmat(6, 5, seed=1)
    gt = torch_graph(g)
    assert json.dumps(tw.encode_graph(gt)) == json.dumps(rw.encode_graph(g))
    for enc, dec in ((rw.encode_graph, tw.decode_graph), (tw.encode_graph, rw.decode_graph)):
        src = g if enc is rw.encode_graph else gt
        g2 = dec(_rt(enc(src)))
        assert g2.n == g.n and g2.name == g.name
        assert np.array_equal(g2.rowptr, g.rowptr) and np.array_equal(g2.colidx, g.colidx)


def test_queries_encode_identically_and_decode_across_packages():
    g = erdos(40, 5.0, seed=0)
    gt = torch_graph(g)
    frontier = np.zeros(g.nnz, bool)
    frontier[:3] = True
    frozen = np.arange(g.nnz, dtype=np.int32)
    pairs = [
        (ra.TrussQuery.ktruss(g, k=4, deadline_s=2.5), ta.TrussQuery.ktruss(gt, k=4, deadline_s=2.5)),
        (ra.TrussQuery.kmax(g, backend="fine/pallas/aligned"),
         ta.TrussQuery.kmax(gt, backend="fine/pallas/aligned")),
        (ra.TrussQuery.stream_update(g, frontier=frontier, frozen_truss=frozen),
         ta.TrussQuery.stream_update(gt, frontier=frontier, frozen_truss=frozen)),
        # A stream session's query holds its lanes as tensors on its device.
        (ra.TrussQuery.stream_update(g, frontier=frontier, frozen_truss=frozen),
         ta.TrussQuery.stream_update(gt, frontier=torch.from_numpy(frontier),
                                     frozen_truss=torch.from_numpy(frozen))),
    ]
    for rq, tq in pairs:
        assert json.dumps(tw.encode_query(tq)) == json.dumps(rw.encode_query(rq))
        back = tw.decode_query(_rt(rw.encode_query(rq)))
        assert isinstance(back, ta.TrussQuery)
        assert (back.workload, back.k, back.deadline_s) == (rq.workload, rq.k, rq.deadline_s)
        assert str(back.backend) == str(rq.backend)
        assert np.array_equal(back.graph.colidx, g.colidx)
        fwd = rw.decode_query(_rt(tw.encode_query(tq)))
        assert isinstance(fwd, ra.TrussQuery) and fwd.workload == tq.workload
        if rq.frontier is not None:
            assert np.array_equal(back.frontier, frontier)
            assert np.array_equal(back.frozen_truss, frozen)


def test_results_encode_identically_and_decode_across_packages():
    g = erdos(48, 6.0, seed=0)
    qs = lambda api, gg: [api.TrussQuery.decompose(gg), api.TrussQuery.kmax(gg),  # noqa: E731
                          api.TrussQuery.ktruss(gg, k=3)]
    want = ra.solve(qs(ra, g))
    got = ta.solve(qs(ta, torch_graph(g)), device="cpu")
    for r, t in zip(want + [want[0].trussness], got + [got[0].trussness]):
        assert json.dumps(tw.encode_result(t)) == json.dumps(rw.encode_result(r))
        back = tw.decode_result(_rt(rw.encode_result(r)))
        fwd = rw.decode_result(_rt(tw.encode_result(t)))
        for x in (back, fwd):
            if isinstance(r, int):
                assert x == r
            elif isinstance(r, np.ndarray):
                assert np.array_equal(x, r) and x.dtype == r.dtype
            elif hasattr(r, "trussness"):
                assert np.array_equal(x.trussness, r.trussness)
                assert (x.kmax, x.levels) == (r.kmax, r.levels)
            else:
                assert np.array_equal(x.alive, r.alive) and np.array_equal(x.support, r.support)
                assert (x.k, x.iterations, x.edges_remaining) == (
                    r.k, r.iterations, r.edges_remaining)
        if not isinstance(r, (int, np.ndarray)):
            assert type(back).__module__ == "repro_torch.core.truss"
            assert type(fwd).__module__ == "repro.core.truss"


def test_typed_errors_cross_the_packages_with_context():
    cases = [
        (rerr.TrussTimeoutError("full", shed=True, queue_depth=7), TrussTimeoutError),
        (rerr.InvalidGraphError("bad", kind="self_loop", row=3), InvalidGraphError),
        (rerr.DeviceError("boom", oom=True, site="dispatch", injected=True), DeviceError),
        (rerr.QueryFailedError("gone", attempts=4), QueryFailedError),
    ]
    for ref_err, port_cls in cases:
        frame = _rt(rw.encode_error(ref_err))
        assert json.dumps(frame) == json.dumps(tw.encode_error(port_cls(
            str(ref_err), **{k: getattr(ref_err, k) for k in frame["error"].get("context", {})})))
        with pytest.raises(port_cls) as ei:
            tw.raise_remote_error(frame)
        for key, val in frame["error"].get("context", {}).items():
            assert getattr(ei.value, key) == val
        assert "[remote]" in str(ei.value)
        # and the other way round, into the reference's classes
        with pytest.raises(type(ref_err)):
            rw.raise_remote_error(_rt(tw.encode_error(ei.value)))
    with pytest.raises(RuntimeError, match="NoSuchError"):
        tw.raise_remote_error({"error": {"type": "NoSuchError", "message": "x"}})
    with pytest.raises(RuntimeError):
        tw.raise_remote_error({"error": {"type": "os.system", "message": "x"}})


# ------------------------------------------------------------------ #
# HealthReport and warmup
# ------------------------------------------------------------------ #
def test_health_report_reads_session_counters():
    s = ta.Session(max_batch=2, device="cpu")
    g = torch_graph(erdos(48, 6.0, seed=0))
    s.submit(ta.TrussQuery.decompose(g)).result(timeout=None)
    s.submit(ta.TrussQuery.kmax(g)).result(timeout=None)
    rep = health_report(s, name="r0", streams=("s1",))
    assert rep.requests_served == s.requests_served == 2
    assert rep.queries_shed == s.queries_shed
    assert rep.queries_quarantined == s.queries_quarantined == 0
    assert rep.retries == s.retries == 0
    label = bucket_str(bucket_for(g, chunk=s.chunk))
    assert label in rep.compiled_buckets
    assert rep.cache_bucket_hits.get(label, 0) >= 1
    back = HealthReport.from_dict(_rt(rep.to_dict()))
    assert back == rep
    # the reference decodes the port's report
    import repro.serve as rs

    assert rs.HealthReport.from_dict(_rt(rep.to_dict())).to_dict() == rep.to_dict()


def test_warmup_specs_are_allowlisted():
    g = _warm_graph({"kind": "erdos", "n": 32, "avg_degree": 4.0, "seed": 1})
    assert g.n == 32 and type(g).__module__.startswith("repro_torch")
    with pytest.raises(ValueError, match="unknown warmup generator"):
        _warm_graph({"kind": "os.system"})
    with pytest.raises(ValueError):
        _warm_graph({})
    assert "erdos" in _WARMUP_KINDS


def test_replica_config_carries_the_device():
    cfg = ReplicaConfig(name="r", device="cpu", warmup=({"kind": "erdos", "n": 8},))
    back = ReplicaConfig.from_json(cfg.to_json())
    assert back == cfg and back.device == "cpu"
    assert ReplicaConfig().device is None  # None = CUDA


# ------------------------------------------------------------------ #
# Router policy (stub handles — no sockets)
# ------------------------------------------------------------------ #
class _StubHandle(ReplicaHandle):
    """Handle whose RPCs are canned: submit counts, health is scripted."""

    def __init__(self, name, report=None):
        super().__init__(name, "127.0.0.1", 0)
        self.report = report
        self.submitted = 0

    def submit(self, qmsg):
        self.submitted += 1
        return self.submitted

    def health(self):
        if self.report is None:
            raise ConnectionError(f"{self.name} is down")
        return self.report

    def close(self):
        pass


def _report(name, **over):
    base = dict(
        name=name, queue_depth=0, live_queries=0, requests_served=0, queries_shed=0,
        queries_failed=0, queries_quarantined=0, retries=0, warmup_queries=0,
        draining=False, streams=(), compiled_buckets=(), cache_bucket_hits={}, imbalance=(),
    )
    base.update(over)
    return HealthReport(**base)


def test_router_affinity_sticks_and_counts():
    r = Router([_StubHandle("r0"), _StubHandle("r1")], spill_depth=100)
    h, affine = r.pick("bucketA")
    assert affine is False  # cold assignment
    home = h.name
    for _ in range(5):
        h2, affine = r.pick("bucketA")
        assert h2.name == home and affine is True
    st = r.stats()
    assert st["cold_assignments"] == 1 and st["affinity_hits"] == 5
    assert st["routed"] == 6 and st["affinity"]["bucketA"] == home
    assert st["affinity_hit_rate"] == round(5 / 6, 4)


def test_router_spills_past_depth_and_sheds_at_saturation():
    r = Router([_StubHandle("r0"), _StubHandle("r1")], spill_depth=2, shed_depth=2)
    home = r.pick("b")[0].name
    r.pick("b")
    spill, affine = r.pick("b")
    assert spill.name != home and affine is False
    r.pick("b")
    assert r.stats()["spillovers"] == 2
    with pytest.raises(TrussTimeoutError) as ei:
        r.pick("b")
    assert ei.value.shed is True and r.stats()["queries_shed"] == 1
    r.release(home)
    assert r.pick("b")[0] is not None


def test_router_learns_warm_home_from_health():
    warm = _report("r1", compiled_buckets=("bucketX",))
    r = Router([_StubHandle("r0"), _StubHandle("r1", report=warm)])
    r._replicas["r0"].report = _report("r0")
    r.poll_health()
    assert r.pick("bucketX")[0].name == "r1"


def test_router_quarantine_redistributes_and_recovers():
    h0 = _StubHandle("r0", report=_report("r0"))
    h1 = _StubHandle("r1", report=_report("r1", streams=("s7",)))
    r = Router([h0, h1], max_health_fails=1)
    assert r.pick("b")[0].name == "r0"
    r.release("r0")
    h1.report = None
    r.poll_health()
    assert r.is_quarantined("r1") and not r.is_quarantined("r0")
    assert r.quarantine("r0") == ()
    with pytest.raises(QueryFailedError):
        r.pick("b")
    r.reinstate("r1", _StubHandle("r1", report=_report("r1")))
    assert r.pick("b")[0].name == "r1"
    assert r.stats()["replicas_quarantined"] == 2


def test_router_quarantine_reports_orphaned_streams():
    h0 = _StubHandle("r0", report=_report("r0", streams=("sA", "sB")))
    r = Router([h0, _StubHandle("r1", report=_report("r1"))])
    r.poll_health()
    assert r.quarantine("r0") == ("sA", "sB")
    assert r.quarantine("r0") == ()


def test_network_fault_site_raises_typed_device_error():
    handle = ReplicaHandle("r0", "127.0.0.1", 1)  # never actually connects
    with use_plan(FaultPlan([FaultSpec("network", times=1)])):
        with pytest.raises(DeviceError) as ei:
            handle.ping()
        assert ei.value.site == "network" and ei.value.injected
        assert handle._sock is None


class _NetFlakyHandle(_StubHandle):
    def submit(self, qmsg):
        inject("network", replica=self.name, op="submit")
        return super().submit(qmsg)


def test_router_reroutes_around_injected_network_fault():
    q = ta.TrussQuery.decompose(torch_graph(erdos(30, 3.0, seed=5)))
    r = Router([_NetFlakyHandle("r0"), _NetFlakyHandle("r1")], max_health_fails=1)
    plan = FaultPlan([FaultSpec("network", times=1, where=(("replica", "r0"),))])
    with use_plan(plan):
        routed = r.submit(q, {"op": "submit"})
    assert routed.replica.name == "r1" and r.is_quarantined("r0")
    assert plan.fired("network") == 1


def test_replica_kill_is_a_pure_action_site():
    plan = FaultPlan([FaultSpec("replica_kill", times=1, where=(("replica", "r1"),))])
    with use_plan(plan):
        assert inject("replica_kill", replica="r0") is None
        spec = inject("replica_kill", replica="r1")
        assert spec is not None and spec.site == "replica_kill"
        assert inject("replica_kill", replica="r1") is None
    assert plan.fired("replica_kill") == 1


def test_router_ingests_replica_counters():
    r = Router([_StubHandle("r0", report=_report("r0", queries_shed=4, requests_served=11))])
    r.poll_health()
    snap = r.metrics.snapshot()["gauges"]
    assert snap["replica_queries_shed{replica=r0}"] == 4
    assert snap["replica_requests_served{replica=r0}"] == 11


def test_route_many_is_edf_ordered():
    g = torch_graph(erdos(24, 4.0, seed=0))
    qs = [ta.TrussQuery.kmax(g), ta.TrussQuery.kmax(g, deadline_s=5.0),
          ta.TrussQuery.kmax(g, deadline_s=1.0), ta.TrussQuery.kmax(g)]
    assert Router([_StubHandle("r0")]).route_many(qs) == [2, 1, 0, 3]


# ------------------------------------------------------------------ #
# Thread-safe Session, drain
# ------------------------------------------------------------------ #
def test_session_threaded_hammer_matches_serial_reference():
    gs = [erdos(48, 6.0, seed=0), erdos(150, 5.0, seed=1)]

    def qs(api, g_small, g_big):
        return [api.TrussQuery.decompose(g_small if i % 2 else g_big) for i in range(8)] + [
            api.TrussQuery.kmax(g_small), api.TrussQuery.ktruss(g_big, k=3)]

    expect = ra.solve(qs(ra, *gs), max_batch=4)
    queries = qs(ta, *map(torch_graph, gs))
    s = ta.Session(max_batch=4, device="cpu")
    results, errors = {}, []

    def worker(idxs):
        try:
            futs = [(i, s.submit(queries[i])) for i in idxs]
            for i, f in futs:
                results[i] = f.result(timeout=None)
        except BaseException as e:  # pragma: no cover - failure detail
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(range(t, len(queries), 4),))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    for i, exp in enumerate(expect):
        got = results[i]
        if isinstance(exp, int):
            assert got == exp
        elif hasattr(exp, "trussness"):
            assert np.array_equal(got.trussness, exp.trussness)
        else:
            assert np.array_equal(got.alive, exp.alive)
    assert s.requests_served == len(queries)
    assert s.drain() == 0


def test_session_drain_flushes_queued_work():
    s = ta.Session(max_batch=4, device="cpu")
    g = torch_graph(erdos(48, 6.0, seed=0))
    futs = [s.submit(ta.TrussQuery.kmax(g)) for _ in range(3)]
    assert s.drain() >= 1
    assert all(f.done() for f in futs) and len(s.queue) == 0


# ------------------------------------------------------------------ #
# Replica ops in process
# ------------------------------------------------------------------ #
@pytest.fixture()
def replica(tmp_path):
    cfg = ReplicaConfig(
        name="r-test", port_file=str(tmp_path / "port"), max_batch=2, max_live=2,
        checkpoint_root=str(tmp_path / "ckpt"), checkpoint_every=1, device="cpu",
    )
    return Replica(cfg)


def test_replica_session_is_on_the_configured_device(replica):
    assert replica.session.planner.device.type == "cpu"


def test_replica_admission_sheds_past_max_live(replica):
    q = tw.encode_query(ta.TrussQuery.kmax(torch_graph(erdos(48, 6.0, seed=0))))
    qid1 = replica._handle({"op": "submit", "query": q})["qid"]
    replica._handle({"op": "submit", "query": q})
    with pytest.raises(TrussTimeoutError) as ei:
        replica._handle({"op": "submit", "query": q})
    assert ei.value.shed is True
    out = replica._handle({"op": "result", "qid": qid1, "timeout": None})
    assert tw.decode_result(out["result"]) == ra.solve(
        ra.TrussQuery.kmax(erdos(48, 6.0, seed=0)))
    rep = replica.health()
    assert rep.queries_shed >= 1 and rep.live_queries == 1
    with pytest.raises(KeyError):
        replica._handle({"op": "result", "qid": qid1})


def test_replica_drain_refuses_new_work(replica):
    q = tw.encode_query(ta.TrussQuery.kmax(torch_graph(erdos(48, 6.0, seed=0))))
    replica._handle({"op": "submit", "query": q})
    replica._handle({"op": "drain"})
    assert replica.health().draining is True
    with pytest.raises(TrussTimeoutError):
        replica._handle({"op": "submit", "query": q})


def test_replica_stream_seq_is_exactly_once(replica):
    g = erdos(48, 6.0, seed=0)
    opened = replica._handle({"op": "open_stream", "stream_id": "s0", "graph": rw.encode_graph(g)})
    assert opened["seq"] == 0
    ins, dele = _fresh_edge(g), tuple(g.edge_list()[0] - 1)
    msg = {
        "op": "stream_update", "stream_id": "s0", "seq": 1,
        "inserts": tw.encode_array(np.asarray([ins], np.int64)),
        "deletes": tw.encode_array(np.asarray([dele], np.int64)),
    }
    first = replica._handle(msg)
    assert first["seq"] == 1 and "replayed" not in first
    again = replica._handle(msg)
    assert again["replayed"] is True and again["seq"] == 1
    assert again["trussness"] == first["trussness"]
    with pytest.raises(ValueError, match="expects seq 2"):
        replica._handle({**msg, "seq": 5})
    with pytest.raises(KeyError):
        replica._handle({**msg, "stream_id": "nope"})
    # the committed state equals the reference's stream fed the same batch
    ref = rstream.StreamingTrussSession.for_graph(g, backend="fine/xla/aligned", chunk=64)
    ref.update(rstream.EdgeBatch.of([ins], [dele]))
    assert np.array_equal(tw.decode_array(first["trussness"]), ref.trussness)
    assert first["kmax"] == ref.kmax


def test_replica_restore_stream_resumes_from_checkpoint(replica):
    g = erdos(48, 6.0, seed=0)
    replica._handle({"op": "open_stream", "stream_id": "s1", "graph": tw.encode_graph(g)})
    msg = {
        "op": "stream_update", "stream_id": "s1", "seq": 1,
        "inserts": tw.encode_array(np.asarray([_fresh_edge(g)], np.int64)),
        "deletes": tw.encode_array(np.zeros((0, 2), np.int64)),
    }
    committed = replica._handle(msg)
    twin = Replica(replica.config)  # a "new" replica process over the same root
    restored = twin._handle({"op": "restore_stream", "stream_id": "s1"})
    assert restored["seq"] == 1 and restored["trussness"] == committed["trussness"]
    assert twin._handle(msg)["replayed"] is True


# ------------------------------------------------------------------ #
# The multi-process fleet, on the CPU
# ------------------------------------------------------------------ #
def test_fleet_integration_matches_reference_solve(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # three replica processes beside the workers
    g1, g2, g3 = erdos(48, 6.0, seed=0), erdos(150, 5.0, seed=1), rmat(7, 5, seed=2)
    buckets = {bucket_str(bucket_for(g, chunk=256)) for g in (g1, g2, g3)}
    assert len(buckets) == 3
    warm = [
        {"kind": "erdos", "n": 48, "avg_degree": 6.0, "seed": 0},
        {"kind": "erdos", "n": 150, "avg_degree": 5.0, "seed": 1},
        {"kind": "rmat", "scale": 7, "edge_factor": 5, "seed": 2},
    ]

    def mix(api, a, b, c):
        return [api.TrussQuery.decompose(a), api.TrussQuery.kmax(b), api.TrussQuery.ktruss(c, k=3),
                api.TrussQuery.decompose(b), api.TrussQuery.kmax(a), api.TrussQuery.decompose(c)]

    expect = ra.solve(mix(ra, g1, g2, g3), max_batch=2)
    ins, dele = _fresh_edge(g1), tuple(g1.edge_list()[0] - 1)
    lstream = ra.Session(max_batch=2).open_stream(g1)
    lstream.update(rstream.EdgeBatch.of([ins]))
    lstream.update(rstream.EdgeBatch.of([], [dele]))

    with Fleet(3, workdir=str(tmp_path / "fleet"), max_batch=2, warmup=warm,
               device="cpu") as fleet:
        client = FleetClient(fleet)
        got = client.solve(mix(ta, *map(torch_graph, (g1, g2, g3))))
        for exp, res in zip(expect, got):
            if isinstance(exp, int):
                assert res == exp
            elif hasattr(exp, "trussness"):
                assert np.array_equal(res.trussness, exp.trussness) and res.kmax == exp.kmax
            else:
                assert np.array_equal(res.alive, exp.alive)
                assert np.array_equal(res.support, exp.support)
        st = client.stats()
        assert st["routed"] >= 6
        assert st["routed"] == st["affinity_hits"] + st["spillovers"] + st["cold_assignments"]
        assert st["affinity_hits"] > 0
        for name in fleet.router.replica_names:
            rep = fleet.router.last_health(name)
            assert rep is not None and rep.warmup_queries == 1

        stream = client.open_stream(torch_graph(g1))
        owner = stream.owner
        assert owner is not None
        stream.update(EdgeBatch.of([ins]))
        fleet.kill(owner)
        reply = stream.update(EdgeBatch.of([], [dele]))
        assert stream.owner != owner
        assert stream.seq == 2 and reply["seq"] == 2
        assert np.array_equal(stream.trussness, lstream.trussness)
        assert stream.kmax == lstream.kmax
        assert fleet.stats()["replicas"][owner]["quarantined"] is True
        assert fleet.router.metrics.value("fleet_stream_handoffs", stream=stream.stream_id) >= 1


# ------------------------------------------------------------------ #
# Import boundary
# ------------------------------------------------------------------ #
def test_a_port_replica_loads_neither_jax_nor_the_reference(tmp_path):
    code = (
        "import sys\n"
        "import repro_torch.serve, repro_torch.resilience\n"
        "from repro_torch.serve import Replica, ReplicaConfig\n"
        f"cfg = ReplicaConfig(name='r', port_file={str(tmp_path / 'port')!r}, device='cpu',\n"
        "                    max_batch=1, warmup=({'kind': 'erdos', 'n': 24, 'avg_degree': 3.0},))\n"
        "r = Replica(cfg)\n"
        "assert r.warm() == 1\n"
        "port = r.bind()\n"
        "r.stop()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('CLEAN', port > 0)\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "CLEAN True" in proc.stdout, proc.stdout + proc.stderr
