"""Port parity, multi-device placement: ``repro_torch.distributed`` and the
``mesh=`` argument of ``PeelExecutor``, ``Planner``, ``Session``,
``TrussService`` and ``api.build_peel``, on meshes of CPU shards.

The reference's own sharded path is not the oracle (under jax 0.9.0 its
sharded service fails every query: the "slots" axis is not found in the
mesh); every mesh result is held to the reference's *unsharded*
answers, bit for bit, and to the port's unsharded peel field for field.
The refusals are held to the reference's messages."""

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.distributed as rd
import repro.service as rsv
import repro_torch.api as ta
import repro_torch.distributed as td
import repro_torch.service as tsv
import repro_torch.stream as ts
from _torch_parity import assert_same, torch_graph
from repro.core import trussness_numpy
from repro.graphs import CSRGraph, erdos
from repro.graphs import pack_problems as ref_pack_problems
from repro_torch.errors import InvalidGraphError
from repro_torch.exec import PeelExecutor
from repro_torch.graphs import pack_problems

CHUNK = 64


def _bucket_graphs():
    """The reference's sharded workload: the first 8 ``erdos(40, 5.0)``
    graphs (seeds 0..63) that land in one bucket."""
    groups = {}
    for s in range(64):
        g = erdos(40, 5.0, seed=s)
        b = ra.bucket_for(g, chunk=CHUNK)
        groups.setdefault(b, []).append(g)
        if len(groups[b]) == 8:
            return b, groups[b]
    raise AssertionError("no bucket of 8")


BUCKET, GRAPHS = _bucket_graphs()
TGRAPHS = [torch_graph(g) for g in GRAPHS]


def cpu_mesh(d):
    return td.slot_mesh(devices=("cpu",) * d)


def _same_decomposition(r, t):
    assert (t.kmax, t.levels) == (r.kmax, r.levels)
    assert_same(r.trussness, t.trussness)


# --------------------------------------------------------------------- #
# The reference's sharded workload, against its unsharded service
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ref_decompositions():
    svc = rsv.TrussService(max_batch=8, chunk=CHUNK)
    futs = [svc.submit_decompose(g) for g in GRAPHS]
    svc.flush()
    return [f.result() for f in futs]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_service_matches_unsharded_reference(backend, ref_decompositions):
    svc = tsv.TrussService(max_batch=8, chunk=CHUNK, backend=backend, mesh=cpu_mesh(8))
    assert svc.mesh is svc.session.mesh and svc.mesh.shape == {"slots": 8}
    futs = [svc.submit_decompose(g) for g in TGRAPHS]
    svc.flush()
    assert svc.stats()["device_dispatches"] == 1
    for r, f in zip(ref_decompositions, futs):
        _same_decomposition(r, f.result())


def _mixed_queries(api, graphs):
    g = graphs
    return [
        *(api.TrussQuery.decompose(x) for x in g[:4]),
        api.TrussQuery.kmax(g[4]),
        api.TrussQuery.kmax(g[5], k_start=4),
        api.TrussQuery.ktruss(g[6], k=4),
        api.TrussQuery.ktruss(g[7], k=3),
    ]


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_mesh_session_matches_unsharded_reference(shards):
    want = ra.solve(_mixed_queries(ra, GRAPHS), max_batch=8, chunk=CHUNK)
    s = ta.Session(max_batch=8, chunk=CHUNK, mesh=cpu_mesh(shards))
    assert s.planner.device == torch.device("cpu") and s.mesh.size == shards
    got = s.solve(_mixed_queries(ta, TGRAPHS))
    assert s.stats()["device_dispatches"] == 1
    for r, t in zip(want, got):
        if isinstance(r, int):
            assert t == r
        elif isinstance(r, ra.KTrussResult):
            assert (t.k, t.iterations, t.edges_remaining) == (r.k, r.iterations, r.edges_remaining)
            assert_same(r.alive, t.alive)
            assert_same(r.support, t.support)
        else:
            _same_decomposition(r, t)


# --------------------------------------------------------------------- #
# The executor: every PeelState field equals the unsharded peel's
# --------------------------------------------------------------------- #
def _peel_inputs(graphs, slots=8):
    pk = pack_problems(
        graphs, slot_n=BUCKET.n_pad, slot_nnz=BUCKET.nnz_pad, slots=slots, chunk=CHUNK,
        layout="aligned", device="cpu",
    )
    slot_ids = torch.arange(slots, dtype=torch.int32).repeat_interleave(BUCKET.nnz_pad)
    k0 = np.array([3, 3, 4, 3, 5, 3, 4, 3][:slots], np.int32)
    single = np.array([False, True, False, False, True, False, False, True][:slots])
    return pk, slot_ids, k0, single


def _frozen_inputs(pk, graphs):
    """A seeded frontier per member: the rest frozen at its true trussness."""
    nnzp = pk.problem.nnz_pad
    alive0, frozen = np.zeros(nnzp, bool), np.zeros(nnzp, bool)
    ft = np.zeros(nnzp, np.int32)
    rng = np.random.default_rng(3)
    for g, (a, b) in zip(graphs, pk.edge_ranges):
        front = rng.random(b - a) < 0.3
        alive0[a:b], frozen[a:b] = front, ~front
        ft[a:b] = np.where(front, 0, trussness_numpy(g))
    return torch.from_numpy(alive0), torch.from_numpy(frozen), torch.from_numpy(ft)


@pytest.mark.parametrize("frozen", [False, True], ids=["plain", "frozen"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sharded_peel_state_equals_unsharded(backend, frozen):
    # 6 members in 8 slots: the last shard of 4 holds only empty slots.
    pk, slot_ids, k0, single = _peel_inputs(TGRAPHS[:6])
    kw = dict(slot_ids=slot_ids, k0=k0, single_level=single)
    if frozen:
        kw.update(zip(("alive0", "frozen", "frozen_truss"), _frozen_inputs(pk, GRAPHS[:6])))
    mk = dict(granularity="fine", mode="owner", backend=backend, window=BUCKET.window, chunk=CHUNK)
    want = PeelExecutor(**mk).peel(pk.problem, **kw)
    for shards in (2, 4, 8):
        exe = PeelExecutor(mesh=cpu_mesh(shards), **mk)
        got = exe.peel(pk.problem, **kw)
        assert exe.dispatches == 1
        for name, a, b in zip(want._fields, want, got):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), (shards, name)
    assert int(want.total_iters) > 0


def test_lock_step_runs_each_shard_its_own_trips():
    pk, slot_ids, k0, single = _peel_inputs(TGRAPHS)
    mk = dict(granularity="fine", mode="owner", backend="xla", window=BUCKET.window, chunk=CHUNK)
    exe = PeelExecutor(mesh=cpu_mesh(4), **mk)
    shards = td.shard_peel_args(
        exe.mesh, pk.problem, slot_ids, torch.from_numpy(k0), torch.from_numpy(single),
        pk.problem.colidx != 0, torch.zeros(pk.problem.nnz_pad, dtype=torch.bool),
        torch.zeros(pk.problem.nnz_pad, dtype=torch.int32),
    )
    states = exe._peel.lock_step(shards, limit=10_000)
    trips = [int(s.total_iters) for s in states]
    # A shard's trips are its slots' longest run, and it stops there.
    assert trips == [int(s.iters.max()) for s in states]
    # One readback per shard before its first trip, then one per live
    # shard when its loop has ended.
    assert exe.host_syncs == sum(1 + (t > 0) for t in trips)
    whole = PeelExecutor(**mk).peel(pk.problem, slot_ids=slot_ids, k0=k0, single_level=single)
    assert int(whole.total_iters) == max(trips)


# --------------------------------------------------------------------- #
# The shard's problem: a rebased slice of the pack, and the pack of its block
# --------------------------------------------------------------------- #
def _rebased_slice(p, j, d):
    """Shard j of d computed independently, in numpy, from the whole pack."""
    f = {name: getattr(p, name).numpy() for name in p._fields}
    nv, ne, nu = p.n // d, p.nnz_pad // d, f["ucolidx"].shape[0] // d
    vo, eo, uo = j * nv, j * ne, j * nu

    def ids(x):
        return np.where(x != 0, x - vo, 0).astype(np.int32)

    return {
        "rowptr": f["rowptr"][vo : vo + nv + 1] - eo,
        "colidx": ids(f["colidx"][eo : eo + ne]),
        "edge_row": ids(f["edge_row"][eo : eo + ne]),
        "deg": np.concatenate([[0], f["deg"][vo + 1 : vo + nv + 1]]).astype(np.int32),
        "urowptr": f["urowptr"][vo : vo + nv + 1] - uo,
        "ucolidx": ids(f["ucolidx"][uo : uo + nu]),
        "u2d": np.where(f["u2d"][uo : uo + nu] < p.nnz_pad, f["u2d"][uo : uo + nu] - eo, ne),
        "uedge_row": ids(f["uedge_row"][uo : uo + nu]),
        "udeg": np.concatenate([[0], f["udeg"][vo + 1 : vo + nv + 1]]).astype(np.int32),
    }


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_problem_is_rebased_slice_and_pack_of_its_block(shards):
    pk, slot_ids, k0, single = _peel_inputs(TGRAPHS)
    nnzp = pk.problem.nnz_pad
    sets = td.shard_peel_args(
        cpu_mesh(shards), pk.problem, slot_ids, torch.from_numpy(k0), torch.from_numpy(single),
        pk.problem.colidx != 0, torch.zeros(nnzp, dtype=torch.bool),
        torch.zeros(nnzp, dtype=torch.int32),
    )
    spd = 8 // shards
    for j, (q, ids, k0_j, single_j, alive_j, _, _) in enumerate(sets):
        own = pack_problems(
            TGRAPHS[j * spd : (j + 1) * spd], slot_n=BUCKET.n_pad, slot_nnz=BUCKET.nnz_pad,
            slots=spd, chunk=CHUNK, layout="aligned", device="cpu",
        ).problem
        want = _rebased_slice(pk.problem, j, shards)
        for name in q._fields:
            got = getattr(q, name)
            assert got.dtype == torch.int32, name
            assert np.array_equal(got.numpy(), want[name]), (j, name)
            assert torch.equal(got, getattr(own, name)), (j, name)
        # The pad sentinel stays 0 exactly where the whole pack has it.
        lanes = slice(j * q.nnz_pad, (j + 1) * q.nnz_pad)
        assert torch.equal(q.colidx == 0, pk.problem.colidx[lanes] == 0)
        assert torch.equal(ids, torch.arange(spd, dtype=torch.int32).repeat_interleave(BUCKET.nnz_pad))
        assert k0_j.tolist() == k0[j * spd : (j + 1) * spd].tolist()
        assert single_j.tolist() == single[j * spd : (j + 1) * spd].tolist()
        assert torch.equal(alive_j, q.colidx != 0)


def test_peel_problem_specs_match_reference():
    ref = [tuple(s) for s in rd.peel_problem_specs()]
    assert td.peel_problem_specs() == ref
    assert td.SLOT_AXIS == rd.SLOT_AXIS == "slots"


# --------------------------------------------------------------------- #
# Streams on a mesh session
# --------------------------------------------------------------------- #
def test_streams_on_mesh_session_equal_from_scratch():
    s = ta.Session(max_batch=2, chunk=CHUNK, mesh=cpu_mesh(2))
    streams = [s.open_stream(g) for g in TGRAPHS[:2]]
    rng = np.random.default_rng(17)
    for _ in range(2):  # two balanced updates, both shards live in one dispatch
        pend = []
        for st in streams:
            existing = set(map(tuple, (st.graph.edge_list() - 1).tolist()))
            ins = []
            while len(ins) < 2:
                a, b = sorted(int(x) for x in rng.choice(st.graph.n, 2, replace=False))
                if (a, b) not in existing:
                    ins.append((a, b))
                    existing.add((a, b))
            el = st.graph.edge_list() - 1
            dels = [tuple(e) for e in el[rng.permutation(len(el))[:2]].tolist()]
            pend.append(st.submit_update(ts.EdgeBatch.of(ins, dels)))
        before = s.device_dispatches
        s.flush()
        assert s.device_dispatches == before + 1
        for st, pu in zip(streams, pend):
            got = pu.result().trussness
            g = st.graph  # the update's graph, committed by result()
            want = trussness_numpy(CSRGraph(g.n, g.rowptr, g.colidx)).astype(np.int32)
            assert_same(want, got)


# --------------------------------------------------------------------- #
# Refusals, with the reference's messages
# --------------------------------------------------------------------- #
def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize(
    "kw",
    [
        dict(backend="fine/fused/aligned"),
        dict(layout="contig"),
        dict(backend="fine/xla/contig"),
    ],
    ids=["fused", "contig-layout", "contig-backend"],
)
def test_session_refusals_match_reference(kw):
    want = _message(lambda: ra.Session(max_batch=8, mesh=rd.slot_mesh(1), **kw))
    got = _message(lambda: ta.Session(max_batch=8, mesh=cpu_mesh(2), **kw))
    assert got == want


@pytest.mark.parametrize(
    "query",
    [
        dict(backend="fine/fused/aligned"),
        dict(backend="coarse/xla/contig"),
        dict(placement="replicated"),
    ],
    ids=["fused", "contig", "replicated"],
)
def test_query_refusals_on_a_mesh_match_reference(query):
    g = GRAPHS[0]
    want = _message(
        lambda: ra.Session(max_batch=8, mesh=rd.slot_mesh(1)).submit(ra.TrussQuery.kmax(g, **query))
    )
    got = _message(
        lambda: ta.Session(max_batch=8, mesh=cpu_mesh(2)).submit(
            ta.TrussQuery.kmax(TGRAPHS[0], **query)
        )
    )
    assert got == want


def test_sharded_placement_needs_a_mesh_as_reference():
    want = _message(lambda: ra.Session().submit(ra.TrussQuery.kmax(GRAPHS[0], placement="sharded")))
    got = _message(
        lambda: ta.Session(device="cpu").submit(ta.TrussQuery.kmax(TGRAPHS[0], placement="sharded"))
    )
    assert got == want == "placement='sharded' needs a session mesh"
    # With a mesh, "sharded" and "auto" both place on it.
    s = ta.Session(max_batch=2, chunk=CHUNK, mesh=cpu_mesh(2))
    assert s.solve([ta.TrussQuery.kmax(TGRAPHS[0], placement="sharded")]) == [
        ra.solve([ra.TrussQuery.kmax(GRAPHS[0])], chunk=CHUNK)[0]
    ]


def test_size_refusals_match_reference():
    with pytest.raises(ValueError, match=r"^max_batch=6 must divide evenly over the mesh's 4 "
                                         r"devices \(slots shard whole\)$"):
        ta.Session(max_batch=6, mesh=cpu_mesh(4))
    with pytest.raises(ValueError, match=r"^requested 2 devices, have 1$"):
        rd.slot_mesh(2)
    with pytest.raises(ValueError, match=r"^requested 9 devices, have 8$"):
        td.slot_mesh(9, devices=("cpu",) * 8)
    pk, slot_ids, k0, single = _peel_inputs(TGRAPHS)
    z = torch.zeros(pk.problem.nnz_pad, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"^mesh size 3 must evenly divide slots=8 \(and "
                                         r"nnz_pad=1024\) so each device owns whole slots$"):
        td.shard_peel_args(cpu_mesh(3), pk.problem, slot_ids, torch.from_numpy(k0),
                           torch.from_numpy(single), z, z, z.int())


def test_mesh_of_mixed_device_types_is_refused():
    """The planner's device (the mesh's first) decides the kernel-fault rule
    and the fallback chain for every shard, so a mesh has one device type."""
    for devices in [("cpu", "cuda:0"), ("cuda:0", "cpu", "cpu")]:
        with pytest.raises(ValueError, match=r"^a slot mesh's devices must be of one type, "
                                             r"got \['cpu', 'cuda'\]$"):
            td.slot_mesh(devices=devices)
        with pytest.raises(ValueError, match="must be of one type"):
            td.SlotMesh(tuple(torch.device(d) for d in devices))


def test_executor_refuses_fused_as_reference():
    from repro.exec import PeelExecutor as RefPeelExecutor

    want = _message(lambda: RefPeelExecutor(backend="fused", window=32, mesh=rd.slot_mesh(1)))
    got = _message(lambda: PeelExecutor(backend="fused", window=32, mesh=cpu_mesh(2)))
    assert got == want


def test_contig_pack_on_a_mesh_is_refused():
    pk = pack_problems(TGRAPHS, slot_n=BUCKET.n_pad, slot_nnz=BUCKET.nnz_pad, slots=8,
                       chunk=CHUNK, layout="contig", device="cpu")
    ids = np.zeros(pk.problem.nnz_pad, np.int32)
    for i, (a, b) in enumerate(pk.edge_ranges):
        ids[a:b] = i
    exe = PeelExecutor(backend="xla", window=BUCKET.window, chunk=CHUNK, mesh=cpu_mesh(2))
    with pytest.raises(InvalidGraphError, match="not slot aligned") as e:
        exe.peel(pk.problem, slot_ids=ids, k0=np.full(8, 3, np.int32))
    assert e.value.kind == "shard_tiling"


def test_planner_device_is_the_mesh_first_device():
    m = cpu_mesh(2)
    assert ta.Planner(mesh=m).device == torch.device("cpu")
    assert ta.Planner(mesh=m, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="mesh's first device"):
        ta.Planner(mesh=m, device="meta")
    variant = ta.Planner(mesh=m).cache_variant(ta.get_backend("fine/xla/aligned").key)
    assert ("slots",) in variant[2] and ("cpu", "cpu") in variant[2]
    assert ta.Planner(device="cpu").cache_variant(ta.get_backend("fine/xla/aligned").key)[2] is None


# --------------------------------------------------------------------- #
# The legacy adapter
# --------------------------------------------------------------------- #
def test_build_peel_mesh_matches_reference_build_peel():
    rpk = ref_pack_problems(GRAPHS, slot_n=BUCKET.n_pad, slot_nnz=BUCKET.nnz_pad, slots=8,
                            chunk=CHUNK, layout="aligned")
    pk, slot_ids, k0, single = _peel_inputs(TGRAPHS)
    kw = dict(mode="owner", backend="xla", window=BUCKET.window, chunk=CHUNK)
    want = ra.build_peel(**kw).peel(rpk.problem, slot_ids=slot_ids.numpy(), k0=k0,
                                    single_level=single)
    exe = ta.build_peel(mesh=cpu_mesh(4), device="cpu", **kw)
    assert exe.mesh.size == 4
    got = exe.peel(pk.problem, slot_ids=slot_ids, k0=k0, single_level=single)
    for name, a, b in zip(want._fields, want, got):
        assert_same(a, b, name)
    with pytest.raises(ValueError, match="mesh's first device"):
        ta.build_peel(mesh=cpu_mesh(2), device="meta", **kw)


def test_mesh_surface_is_the_reference_plus_device():
    import inspect

    def params(fn):
        return inspect.signature(fn).parameters

    for ref, port in [(ra.Session, ta.Session), (ra.Planner, ta.Planner),
                      (ra.build_peel, ta.build_peel)]:
        assert set(params(port)) == set(params(ref)) | {"device"}, port
        assert params(port)["mesh"].default is None
    assert params(PeelExecutor)["mesh"].default is None
    assert params(ta.BackendSpec.make_executor)["mesh"].default is None
    assert set(td.__all__) == set(rd.__all__) | {"SlotMesh"}
    assert isinstance(ta.Session.mesh, property) and "build_peel" in ta.__all__
