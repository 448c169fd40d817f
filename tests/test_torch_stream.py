"""Port parity, streaming: ``repro_torch.stream`` and
``repro_torch.resilience.checkpoint`` against the JAX package on the same
graphs and batches, on the CPU.  Every comparison is exact, dtype included:
delta maps, triangle lists in order, frontier/``lo``/``hi``/``rounds``,
triangle-cache keys, multi-step session state and counters, and
checkpoints moved between the two packages; then the device stages
themselves (the delta's tensors, the union graph, the symmetrized CSR,
the session's device state), which no update may copy or validate on the
host."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import repro.resilience as rr
import repro.stream as rs
import repro_torch.resilience as tr
import repro_torch.stream as ts
from _hypothesis_compat import given, settings, st
from _torch_parity import assert_same, small_pairs, torch_graph
from repro.core import trussness_numpy
from repro.errors import CheckpointError as RefCheckpointError
from repro.graphs import CSRGraph, clustered, erdos, from_edges, road
from repro.stream.frontier import union_graph as ref_union_graph
from repro_torch.errors import CheckpointError
from repro_torch.graphs import csr as tcsr
from repro_torch.stream.frontier import union_graph

CPU = dict(device="cpu")


def _ref_graph(gt):
    """The reference's CSRGraph over a port graph's arrays (for its oracle)."""
    return CSRGraph(gt.n, gt.rowptr, gt.colidx, name=gt.name)


def _random_batch(rng, g, n_ins, n_del):
    """Up to ``n_ins`` fresh inserts + ``n_del`` existing deletes (0-based)."""
    existing = set(map(tuple, (g.edge_list() - 1)))
    ins = []
    for _ in range(8 * n_ins):
        if len(ins) == n_ins:
            break
        a, b = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
        if a != b and (min(a, b), max(a, b)) not in existing:
            ins.append((a, b))
            existing.add((min(a, b), max(a, b)))
    dels = [tuple(e - 1) for e in g.edge_list()[rng.permutation(g.nnz)[: min(n_del, g.nnz)]]]
    return ins, dels


def _batches(ins, dels):
    """The same update as the reference's and the port's ``EdgeBatch``."""
    return rs.EdgeBatch.of(ins, dels), ts.EdgeBatch.of(ins, dels)


def _same_graph(r, t):
    assert (r.n, r.name) == (t.n, t.name)
    assert_same(r.rowptr, t.rowptr, "rowptr")
    assert_same(r.colidx, t.colidx, "colidx")


def _same_delta(dr, dt):
    _same_graph(dr.new_graph, dt.new_graph)
    for f in ("old2new", "new2old", "inserted_new", "deleted_old"):
        assert_same(getattr(dr, f), getattr(dt, f), f)
    assert (dr.num_inserts, dr.num_deletes) == (dt.num_inserts, dt.num_deletes)


def _same_frontier(fr, ft):
    for f in ("frontier", "lo", "hi"):
        assert_same(getattr(fr, f), getattr(ft, f), f)
    assert (fr.rounds, fr.num_triangles, fr.size) == (ft.rounds, ft.num_triangles, ft.size)


# --------------------------------------------------------------------- #
# (a) delta application
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_ins,n_del", [(3, 2), (0, 4), (5, 0), (0, 0)])
def test_apply_batch_maps_match_reference(n_ins, n_del):
    g = erdos(40, 5.0, seed=0)
    ins, dels = _random_batch(np.random.default_rng(n_ins * 10 + n_del), g, n_ins, n_del)
    br, bt = _batches(ins, dels)
    assert_same(br.inserts, bt.inserts)
    assert_same(br.deletes, bt.deletes)
    gt = torch_graph(g)
    _same_delta(rs.apply_batch(g, br), ts.apply_batch(gt, bt, **CPU))
    assert gt.nnz == g.nnz  # the old graph is not mutated


def test_apply_batch_conflicts_match_reference():
    g = erdos(40, 5.0, seed=0)
    gt = torch_graph(g)
    el = g.edge_list() - 1
    dup = tuple(el[0])
    existing = set(map(tuple, el))
    missing = next((a, b) for a in range(g.n) for b in range(a + 1, g.n) if (a, b) not in existing)
    for ins, dels in ([[dup], []], [[], [missing]], [[missing], [missing]], [[(3, 3)], [(g.n, 0)]]):
        br, bt = _batches(ins, dels)
        with pytest.raises(ValueError) as er:
            rs.apply_batch(g, br)
        with pytest.raises(ValueError) as et:
            ts.apply_batch(gt, bt, **CPU)
        assert str(et.value) == str(er.value)
    # Lenient mode drops the conflicts exactly as the reference does.
    br, bt = _batches([dup, missing, (5, 7)], [missing, tuple(el[3])])
    _same_delta(rs.apply_batch(g, br, strict=False), ts.apply_batch(gt, bt, strict=False, **CPU))


# --------------------------------------------------------------------- #
# (b) triangle enumeration: same triples, same order
# --------------------------------------------------------------------- #
def _enum_graphs():
    pairs = small_pairs()
    return [
        *((g, gt, 8192) for g, gt in pairs),
        (pairs[2][0], pairs[2][1], 7),  # many chunks
        (clustered(3, 12, 0.7, seed=1), None, 5),
        (road(6, 0.2, seed=2), None, 16),  # few triangles
        (road(3, 0.0, seed=0), None, 4),  # none
    ]


@pytest.mark.parametrize("case", range(7))
def test_edge_triangles_match_reference_in_order(case):
    g, gt, chunk = _enum_graphs()[case]
    gt = gt if gt is not None else torch_graph(g)
    want = rs.edge_triangles(g, chunk=chunk)
    before = ts.ENUM_COUNTS["full"]
    got = ts.edge_triangles(gt, chunk=chunk, **CPU)
    assert ts.ENUM_COUNTS["full"] == before + 1
    assert_same(want, got, g.name)
    if case == 3:
        assert g.nnz > 50 * chunk and want.shape[0] > 0


# --------------------------------------------------------------------- #
# (c) the frontier closure
# --------------------------------------------------------------------- #
FRONTIER_CASES = [(2, 2), (0, 5), (6, 0), (1, 0), (0, 1), (0, 0), (4, 3)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_frontier_matches_reference(seed):
    make = [lambda: erdos(40, 6.0, seed=0), lambda: clustered(3, 12, 0.7, seed=1),
            lambda: erdos(60, 8.0, seed=2)]
    g = make[seed]()
    gt = torch_graph(g)
    t_old = trussness_numpy(g)
    rng = np.random.default_rng(100 + seed)
    for n_ins, n_del in FRONTIER_CASES:
        br, bt = _batches(*_random_batch(rng, g, n_ins, n_del))
        dr, dt = rs.apply_batch(g, br), ts.apply_batch(gt, bt, **CPU)
        fr = rs.compute_frontier(t_old, dr)
        _same_frontier(fr, ts.compute_frontier(t_old, dt, **CPU))
        _same_frontier(fr, ts.compute_frontier(t_old, dt, chunk=8, **CPU))
        # With the triangle list given (the cache's path), as numpy keys.
        ur = ref_union_graph(dr)
        ut = union_graph(dt)
        _same_graph(ur[0], ut[0])
        assert_same(ur[1], ut[1], "union keys")
        tri_keys = rs.TriangleCache(g).union_triangles(dr, union=ur)
        _same_frontier(
            rs.compute_frontier(t_old, dr, tri_keys=tri_keys, union=ur),
            ts.compute_frontier(t_old, dt, tri_keys=tri_keys, union=ut, **CPU),
        )
        if n_ins or n_del:
            assert fr.rounds >= 1 or fr.num_triangles == 0


def test_compute_frontier_rejects_wrong_trussness_length():
    g = erdos(30, 5.0, seed=0)
    gt = torch_graph(g)
    d = ts.apply_batch(gt, ts.EdgeBatch.of(), **CPU)
    with pytest.raises(ValueError, match="entries"):
        ts.compute_frontier(np.zeros(g.nnz + 1, np.int32), d, **CPU)


# --------------------------------------------------------------------- #
# (d) the triangle cache: same keys, element for element
# --------------------------------------------------------------------- #
def test_triangle_cache_matches_reference_over_updates():
    g = erdos(40, 5.0, seed=2)
    rng = np.random.default_rng(3)
    gr, gt = g, torch_graph(g)
    cr, ct = rs.TriangleCache(gr), ts.TriangleCache(gt, **CPU)
    assert_same(cr.tri_keys, ct.tri_keys, "seed list")
    for n_ins, n_del in [(3, 2), (4, 0), (0, 3), (2, 2)]:
        br, bt = _batches(*_random_batch(rng, gr, n_ins, n_del))
        dr, dt = rs.apply_batch(gr, br), ts.apply_batch(gt, bt, **CPU)
        ur, ut = ref_union_graph(dr), union_graph(dt)
        ins_keys = rs.edge_keys(dr.new_graph)[dr.inserted_new]
        assert_same(
            rs.triangles_incident(ur[0], ins_keys),
            ts.triangles_incident(ut[0], ins_keys, **CPU),
            "incident",
        )
        kr, kt = cr.union_triangles(dr, union=ur), ct.union_triangles(dt, union=ut)
        assert_same(kr, kt, "union triangles")
        cr.commit(dr, kr)
        ct.commit(dt, kt)
        assert_same(cr.tri_keys, ct.tri_keys, "committed")
        assert cr.num_triangles == ct.num_triangles
        gr, gt = dr.new_graph, dt.new_graph
    with pytest.raises(RuntimeError, match="out of sync"):
        ct.union_triangles(ts.apply_batch(torch_graph(g), ts.EdgeBatch.of(), **CPU))


# --------------------------------------------------------------------- #
# (e) multi-step sessions
# --------------------------------------------------------------------- #
def _same_update(ra, rb):
    assert_same(ra.trussness, rb.trussness, "trussness")
    for f in ("kmax", "frontier_size", "frontier_frac", "num_inserts", "num_deletes",
              "dispatches", "num_edges"):
        assert getattr(ra, f) == getattr(rb, f), f


@pytest.mark.parametrize("which", ["erdos", "clustered"])
def test_session_multi_step_matches_reference(which):
    g = erdos(50, 6.0, seed=0) if which == "erdos" else clustered(3, 12, 0.7, seed=1)
    sr = rs.StreamingTrussSession.for_graph(g, chunk=64)
    full0 = ts.ENUM_COUNTS["full"]
    st_ = ts.StreamingTrussSession.for_graph(torch_graph(g), chunk=64, **CPU)
    assert st_.device.type == "cpu"
    rng = np.random.default_rng(11)
    for n_ins, n_del in [(2, 1), (0, 3), (3, 0), (0, 0)]:
        br, bt = _batches(*_random_batch(rng, sr.graph, n_ins, n_del))
        _same_update(sr.update(br), st_.update(bt))
        _same_graph(sr.graph, st_.graph)
        assert_same(sr._tri_cache.tri_keys, st_._tri_cache.tri_keys, "tri_keys")
    assert st_.stats() == sr.stats()
    # One full enumeration for the whole session (the cache seed).
    assert ts.ENUM_COUNTS["full"] == full0 + 1
    assert st_.metrics.value("stream_enumerations", kind="full") == 1
    assert st_.metrics.value("stream_enumerations", kind="incident") >= 1


def test_empty_frontier_update_costs_zero_dispatches():
    # A 2x2 grid has no triangles: deleting an edge can change nothing.
    g = road(3, 0.0, seed=0)
    sess = ts.StreamingTrussSession.for_graph(torch_graph(g), chunk=64, **CPU)
    base = sess.service.stats()["device_dispatches"]
    e0 = tuple(sess.graph.edge_list()[0] - 1)
    res = sess.update(ts.EdgeBatch.of([], [e0]))
    assert res.dispatches == 0 and res.frontier_size == 0
    assert sess.service.stats()["device_dispatches"] == base
    assert_same(trussness_numpy(_ref_graph(sess.graph)).astype(np.int32), res.trussness)


def test_triangle_cache_off_still_exact():
    from repro_torch.api import Session

    g = clustered(3, 12, 0.7, seed=1)
    sess = ts.StreamingTrussSession(
        Session(max_batch=1, chunk=64, **CPU), torch_graph(g), cache_triangles=False
    )
    _, bt = _batches(*_random_batch(np.random.default_rng(5), g, 2, 2))
    full0 = ts.ENUM_COUNTS["full"]
    res = sess.update(bt)
    assert sess._tri_cache is None and ts.ENUM_COUNTS["full"] == full0 + 1
    assert_same(trussness_numpy(_ref_graph(sess.graph)).astype(np.int32), res.trussness)


@settings(max_examples=6, deadline=None)
@given(
    n=st.integers(min_value=8, max_value=28),
    m=st.integers(min_value=6, max_value=70),
    seed=st.integers(min_value=0, max_value=2**31 - 1),
    n_ins=st.integers(min_value=0, max_value=4),
    n_del=st.integers(min_value=0, max_value=3),
)
def test_incremental_equals_scratch_property(n, m, seed, n_ins, n_del):
    rng = np.random.default_rng(seed)
    g = from_edges(n, rng.integers(0, n, size=(m, 2)))
    if g.nnz == 0:
        return
    sess = ts.StreamingTrussSession.for_graph(torch_graph(g), chunk=64, **CPU)
    res = sess.update(ts.EdgeBatch.of(*_random_batch(rng, g, n_ins, n_del)))
    want = trussness_numpy(_ref_graph(sess.graph))
    assert np.array_equal(res.trussness, want), (n, m, seed, n_ins, n_del)


# --------------------------------------------------------------------- #
# (f) checkpoints across packages
# --------------------------------------------------------------------- #
def _ckpt_batches(rng, g, count):
    """Insert-only batches, applied leniently (as tests/test_resilience.py)."""
    out = []
    for _ in range(count):
        ins = [(int(rng.integers(g.n)), int(rng.integers(g.n))) for _ in range(3)]
        out.append([(u, v) for u, v in ins if u != v])
    return out


def test_port_checkpoint_loads_in_reference(tmp_path):
    g = erdos(40, 5.0, seed=0)
    live = ts.StreamingTrussSession.for_graph(torch_graph(g), chunk=64, **CPU)
    for ins in _ckpt_batches(np.random.default_rng(7), g, 2):
        live.update(ts.EdgeBatch.of(ins), strict=False)
    path = live.checkpoint(str(tmp_path / "port.npz"))
    assert live.checkpoints_written == 1
    cr, ct = rr.load_checkpoint(path), tr.load_checkpoint(path)
    assert cr.meta == ct.meta and ct.meta["updates_applied"] == 2
    assert ct.meta["version"] == tr.CHECKPOINT_VERSION == rr.CHECKPOINT_VERSION
    _same_graph(cr.graph, ct.graph)
    assert_same(cr.trussness, ct.trussness)
    assert_same(cr.tri_keys, ct.tri_keys)
    assert_same(cr.tri_keys, live._tri_cache.tri_keys, "tri_keys on disk")
    assert_same(cr.trussness, live.trussness)


def test_reference_checkpoint_restores_into_port_bit_identically(tmp_path):
    rng = np.random.default_rng(9)
    g = erdos(40, 5.0, seed=1)
    batches = _ckpt_batches(rng, g, 4)
    live = rs.StreamingTrussSession.for_graph(g, backend="fine/xla/aligned", chunk=64)
    for ins in batches[:2]:
        live.update(rs.EdgeBatch.of(ins), strict=False)
    path = live.checkpoint(str(tmp_path / "ref.npz"))
    full0 = ts.ENUM_COUNTS["full"]
    restored = tr.restore_session(path, backend="fine/xla/aligned", chunk=64, **CPU)
    assert restored.device.type == "cpu" and restored.updates_total == 2
    assert_same(live._tri_cache.tri_keys, restored._tri_cache.tri_keys)
    for ins in batches[2:]:
        _same_update(
            live.update(rs.EdgeBatch.of(ins), strict=False),
            restored.update(ts.EdgeBatch.of(ins), strict=False),
        )
        assert_same(live._tri_cache.tri_keys, restored._tri_cache.tri_keys)
    assert ts.ENUM_COUNTS["full"] == full0  # no re-enumeration
    assert restored.updates_total == live.updates_total == 4


def test_auto_checkpoint_retention_and_restore(tmp_path):
    g = erdos(40, 5.0, seed=1)
    ckdir = str(tmp_path / "ck")
    st_ = ts.StreamingTrussSession.for_graph(
        torch_graph(g), chunk=64, checkpoint_dir=ckdir, checkpoint_every=1, **CPU
    )
    for ins in _ckpt_batches(np.random.default_rng(3), g, 3):
        st_.update(ts.EdgeBatch.of(ins), strict=False)
    assert sorted(os.listdir(ckdir)) == ["ckpt-00000002.npz", "ckpt-00000003.npz"]
    assert st_.stats()["checkpoints_written"] == 3
    latest = tr.latest_checkpoint(ckdir)
    assert latest == rr.latest_checkpoint(ckdir)
    restored = ts.StreamingTrussSession.restore(latest, chunk=64, **CPU)
    assert_same(st_.trussness, restored.trussness)
    assert tr.latest_checkpoint(str(tmp_path / "none")) is None


def test_checkpoint_errors_are_typed(tmp_path):
    g = erdos(40, 5.0, seed=0)
    gt = torch_graph(g)
    t = trussness_numpy(g).astype(np.int32)
    with pytest.raises(CheckpointError):
        tr.save_checkpoint(str(tmp_path / "bad.npz"), graph=gt, trussness=t[:-1])
    with pytest.raises(CheckpointError):
        tr.load_checkpoint(str(tmp_path / "nope.npz"))
    # A flipped byte mid-file.
    path = tr.save_checkpoint(str(tmp_path / "state.npz"), graph=gt, trussness=t)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CheckpointError) as ei:
        tr.load_checkpoint(path)
    assert ei.value.path == path
    # Another version of the format.
    path = tr.save_checkpoint(str(tmp_path / "v.npz"), graph=gt, trussness=t)
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    meta = dict(tr.load_checkpoint(path).meta, version=tr.CHECKPOINT_VERSION + 1)
    data["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)
    with pytest.raises(CheckpointError, match="version"):
        tr.load_checkpoint(path)
    with pytest.raises(RefCheckpointError, match="version"):
        rr.load_checkpoint(path)


# --------------------------------------------------------------------- #
# (g) the device stages, field by field
# --------------------------------------------------------------------- #
DELTA_CASES = {"inserts": (4, 0), "deletes": (0, 4), "both": (3, 3), "empty": (0, 0)}


def _conflicting_batch(rng, g):
    """A lenient feed's batch: fresh inserts and real deletes, plus an
    existing insert, a missing delete and a pair on both sides."""
    ins, dels = _random_batch(rng, g, 3, 2)
    el = g.edge_list() - 1
    existing = set(map(tuple, el))
    missing = [
        (a, b) for a in range(g.n) for b in range(a + 1, g.n)
        if (a, b) not in existing and (a, b) not in ins
    ]
    return ins + [tuple(el[0]), missing[0]], dels + [missing[1], missing[0]]


@pytest.mark.parametrize("case", [*DELTA_CASES, "lenient"])
def test_device_delta_tensors_match_reference(case):
    g = erdos(50, 6.0, seed=4)
    gt = torch_graph(g)
    rng = np.random.default_rng(21)
    if case == "lenient":
        ins, dels = _conflicting_batch(rng, g)
    else:
        ins, dels = _random_batch(rng, g, *DELTA_CASES[case])
    strict = case != "lenient"
    br, bt = _batches(ins, dels)
    dr = rs.apply_batch(g, br, strict=strict)
    dt = ts.apply_batch(gt, bt, strict=strict, **CPU)
    t = dt.tensors
    assert dt.device.type == "cpu"
    for f in ("old2new", "new2old", "inserted_new", "deleted_old"):
        assert_same(getattr(dr, f), getattr(t, f), f)
    assert_same(rs.edge_keys(g), t.old_keys, "old keys")
    assert_same(rs.edge_keys(dr.new_graph), t.new_keys, "new keys")
    assert_same(rs.edge_keys(dr.new_graph)[dr.inserted_new], t.inserts, "inserted keys")
    assert_same(rs.edge_keys(g)[dr.deleted_old], t.deletes, "deleted keys")
    assert (dt.num_inserts, dt.num_deletes) == (dr.num_inserts, dr.num_deletes)
    _same_graph(dr.new_graph, dt.new_graph)
    # The new graph carries its CSR on the device: lifting it copies nothing.
    rowptr, colidx = tcsr.lift_csr(dt.new_graph, torch.device("cpu"))
    assert rowptr is tcsr.lift_csr(dt.new_graph, torch.device("cpu"))[0]
    assert_same(dr.new_graph.rowptr, rowptr, "held rowptr")
    assert_same(dr.new_graph.colidx.astype(np.int64), colidx, "held colidx")


def test_strict_errors_keep_the_reference_order():
    """Several conflicts in one batch: both sides first, then an existing
    insert, then a missing delete, with the reference's counts."""
    g = erdos(40, 5.0, seed=0)
    gt = torch_graph(g)
    el = g.edge_list() - 1
    existing = set(map(tuple, el))
    missing = [(a, b) for a in range(g.n) for b in range(a + 1, g.n) if (a, b) not in existing]
    cases = [
        ([tuple(el[0]), tuple(el[1])], [missing[0], missing[1], missing[2]]),
        ([tuple(el[0]), missing[0]], [missing[0], missing[1]]),
        ([missing[3]], [missing[4], tuple(el[2])]),
    ]
    for ins, dels in cases:
        br, bt = _batches(ins, dels)
        with pytest.raises(ValueError) as er:
            rs.apply_batch(g, br)
        with pytest.raises(ValueError) as et:
            ts.apply_batch(gt, bt, **CPU)
        assert type(et.value) is type(er.value) and str(et.value) == str(er.value)


@pytest.mark.parametrize("seed", [0, 1])
def test_union_graph_and_incident_triangles_follow_the_reference_path(seed, monkeypatch):
    """The union's keys and CSR built on the device, its symmetrization
    against the reference's ``undirected_csr``, and the incident triangles
    (rows in order) from the device union and from a host graph, neither
    calling ``undirected_csr``."""
    g = clustered(3, 12, 0.7, seed=seed)
    gt = torch_graph(g)
    br, bt = _batches(*_random_batch(np.random.default_rng(30 + seed), g, 5, 2))
    dr, dt = rs.apply_batch(g, br), ts.apply_batch(gt, bt, **CPU)
    ur, ut = ref_union_graph(dr), union_graph(dt)
    assert isinstance(ut[0], tcsr.LiftedCSR)
    _same_graph(ur[0], ut[0])
    assert_same(ur[1], ut[1], "union keys")
    und = ur[0].undirected_csr()
    rowptr, colidx = tcsr.lift_csr(ut[0], torch.device("cpu"))
    urowptr, ucol, _ = tcsr.symmetrize_csr(rowptr, colidx, tcsr.edge_rows(rowptr, ut[0].nnz))
    assert_same(und.rowptr, urowptr, "symmetrized rowptr")
    assert_same(und.colidx.astype(np.int64), ucol, "symmetrized colidx")
    want = rs.triangles_incident(ur[0], rs.edge_keys(dr.new_graph)[dr.inserted_new])
    assert want.shape[0] > 0

    def refused(self):
        raise AssertionError("the stream path called undirected_csr")

    monkeypatch.setattr(tcsr.CSRGraph, "undirected_csr", refused)
    assert_same(want, ts.triangles_incident(ut[0], dt.tensors.inserts, **CPU), "device union")
    host_union = tcsr.CSRGraph(ur[0].n, ur[0].rowptr, ur[0].colidx, name=ur[0].name)
    assert_same(want, ts.triangles_incident(host_union, dt.tensors.inserts, **CPU), "host union")


def test_session_state_stays_on_the_device_between_updates(monkeypatch):
    """After the first update the session's graph carries its device CSR
    and its trussness is the peel's output on the device; later updates
    build nothing on the host (no ``row_of_edge``, ``undirected_csr`` or
    CSR validation) and stay equal to the reference's stream."""
    g = erdos(50, 6.0, seed=5)
    sr = rs.StreamingTrussSession.for_graph(g, chunk=64)
    st_ = ts.StreamingTrussSession.for_graph(torch_graph(g), chunk=64, **CPU)
    rng = np.random.default_rng(8)
    br, bt = _batches(*_random_batch(rng, g, 2, 2))
    _same_update(sr.update(br), st_.update(bt))

    def refused(*_a, **_k):
        raise AssertionError("a host stage ran on the stream path")

    monkeypatch.setattr(tcsr.CSRGraph, "undirected_csr", refused)
    monkeypatch.setattr(tcsr.CSRGraph, "row_of_edge", refused)
    monkeypatch.setattr(tcsr, "validate_csr", refused)
    for n_ins, n_del in [(3, 1), (0, 2), (2, 0)]:
        br, bt = _batches(*_random_batch(rng, sr.graph, n_ins, n_del))
        held = st_._trussness_dev
        _same_update(sr.update(br), st_.update(bt))
        assert "_lifted" in st_.graph.__dict__
        assert st_._trussness_dev is not held or sr.update_dispatches == 0
        assert_same(sr.trussness, st_._trussness_dev, "device trussness")
        assert_same(sr._tri_cache.tri_keys, st_._tri_cache.tri_keys, "tri_keys")
    assert st_.stats() == sr.stats()
    # A pickled graph leaves its device copy behind.
    back = pickle.loads(pickle.dumps(st_.graph))
    assert "_lifted" not in back.__dict__
    _same_graph(sr.graph, back)


def test_failed_strict_update_leaves_the_session_untouched():
    g = erdos(40, 5.0, seed=3)
    st_ = ts.StreamingTrussSession.for_graph(torch_graph(g), chunk=64, **CPU)
    rng = np.random.default_rng(2)
    st_.update(ts.EdgeBatch.of(*_random_batch(rng, g, 2, 1)))
    graph, truss = st_.graph, st_.trussness.copy()
    tri, t_dev = st_._tri_cache.tri_keys.clone(), st_._trussness_dev.clone()
    dup = tuple(st_.graph.edge_list()[0] - 1)
    with pytest.raises(ValueError, match="already exist"):
        st_.update(ts.EdgeBatch.of([dup], []))
    assert st_.graph is graph and st_.updates_applied == 1
    assert_same(truss, st_.trussness)
    assert torch.equal(tri, st_._tri_cache.tri_keys) and torch.equal(t_dev, st_._trussness_dev)
    res = st_.update(ts.EdgeBatch.of(*_random_batch(rng, _ref_graph(graph), 2, 2)))
    assert_same(trussness_numpy(_ref_graph(st_.graph)).astype(np.int32), res.trussness)
