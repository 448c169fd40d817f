"""Port parity, graph substrate: CSR generation, FineProblem arrays, the
block-diagonal packer and the imbalance statistics equal the JAX package's,
field by field and dtype included (exact equality: every output is an
integer, and every float of the statistics is taken from exact integers)."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.configs as rc
import repro.core as rcore
import repro.errors as rerr
import repro.graphs as rg
import repro_torch.api as ta
import repro_torch.configs as tc
import repro_torch.core as tcore
import repro_torch.errors as terr
import repro_torch.graphs as tg
from _torch_parity import assert_same, small_pairs, torch_graph, torch_problem

GENERATORS = [
    ("erdos", dict(n=150, avg_degree=6.0, seed=3)),
    ("barabasi", dict(n=140, m_attach=3, seed=4)),
    ("clustered", dict(n_communities=3, community_size=16, p_in=0.6, seed=5)),
    ("road", dict(side=10, shortcut_frac=0.1, seed=6)),
    ("rmat", dict(scale=7, edge_factor=5, seed=7)),
]


@pytest.mark.parametrize("family,kwargs", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_same_csr_from_same_seed(family, kwargs):
    ref = getattr(rg, family)(**kwargs)
    got = getattr(tg, family)(**kwargs)
    assert got.n == ref.n
    assert np.array_equal(got.rowptr, ref.rowptr)
    assert np.array_equal(got.colidx, ref.colidx)
    assert got.colidx.dtype == ref.colidx.dtype


def test_bench_configs_build_identical_graphs():
    assert [b.name for b in tc.BENCH_GRAPHS] == [b.name for b in rc.BENCH_GRAPHS]
    assert [b.name for b in tc.LARGE_GRAPHS] == [b.name for b in rc.LARGE_GRAPHS]
    for bt, br in zip(tc.BENCH_GRAPHS, rc.BENCH_GRAPHS):
        gt, gr = bt.build(), br.build()
        assert gt.name == gr.name and gt.n == gr.n, bt.name
        assert np.array_equal(gt.rowptr, gr.rowptr), bt.name
        assert np.array_equal(gt.colidx, gr.colidx), bt.name


def test_buckets_and_imbalance_stats_agree():
    for gr, gt in small_pairs():
        for chunk in (64, 256):
            assert tuple(ta.bucket_for(gt, chunk=chunk)) == tuple(ra.bucket_for(gr, chunk=chunk))
        assert ta.bucket_str(ta.bucket_for(gt)) == ra.cache.bucket_str(ra.bucket_for(gr))
        assert dataclasses.asdict(tg.imbalance_stats(gt, device="cpu")) == dataclasses.asdict(
            rg.imbalance_stats(gr)
        )


@pytest.mark.parametrize("chunk", [64, 256])
def test_prepare_fine_matches_field_by_field(chunk):
    for gr, gt in small_pairs():
        pr = rcore.prepare_fine(gr, chunk=chunk)
        pt = tcore.prepare_fine(gt, chunk=chunk, device="cpu")
        for f in pr._fields:
            assert_same(getattr(pr, f), getattr(pt, f), f"{gr.name}.{f}")
            assert getattr(pt, f).dtype == torch.int32


@pytest.mark.parametrize("layout", ["aligned", "contig"])
def test_pack_problems_matches_field_by_field(layout):
    pairs = small_pairs()
    kw = dict(slot_n=128, slot_nnz=1024, slots=4, chunk=64, layout=layout)
    pr = rg.pack_problems([g for g, _ in pairs], **kw)
    pt = tg.pack_problems([g for _, g in pairs], device="cpu", **kw)
    assert pt.edge_ranges == pr.edge_ranges
    assert (pt.slot_n, pt.slot_nnz, pt.slots, pt.layout) == (
        pr.slot_n, pr.slot_nnz, pr.slots, pr.layout,
    )
    for f in pr.problem._fields:
        assert_same(getattr(pr.problem, f), getattr(pt.problem, f), f"{layout}.{f}")


def _edge_case_graphs():
    """name -> (member graphs, pack keywords): the shapes a pack meets at its
    edges (0-based edges in; ``from_edges`` makes them 1-based)."""
    # Vertex 3 isolated, vertices 7 and 8 with no out-neighbours (the last
    # rows empty), vertex 8 isolated altogether.
    isolated = rg.from_edges(8, np.array([[0, 1], [0, 4], [1, 4], [4, 5], [1, 6]]), "isolated")
    one_edge = rg.from_edges(2, np.array([[0, 1]]), "one-edge")
    # 64 edges on 12 vertices: fills a (slot_n=12, slot_nnz=64) slot exactly.
    full = rg.from_edges(12, np.array([(a, b) for a in range(12) for b in range(a + 1, 12)])[:64], "full")
    empty = rg.from_edges(6, np.zeros((0, 2), np.int64), "empty")
    kw = dict(slot_n=12, slot_nnz=64, chunk=64)
    return {
        "isolated-vertices-trailing-empty-row": ([isolated, one_edge], dict(kw, slots=2)),
        "one-edge": ([one_edge], dict(kw, slots=1)),
        "members-fill-slot": ([full, full], dict(kw, slots=2)),
        "empty-slot-between-members": ([isolated, empty, full], dict(kw, slots=4)),
        "empty-member": ([empty, one_edge, isolated], dict(kw, slots=3)),
    }


@pytest.mark.parametrize("case", list(_edge_case_graphs()))
def test_prepare_and_pack_edge_cases_match_reference(case):
    graphs, kw = _edge_case_graphs()[case]
    for g in graphs:
        pr = rcore.prepare_fine(g, chunk=kw["chunk"])
        pt = tcore.prepare_fine(torch_graph(g), chunk=kw["chunk"], device="cpu")
        for f in pr._fields:
            assert_same(getattr(pr, f), getattr(pt, f), f"{g.name}.{f}")
    for layout in ("aligned", "contig"):
        pr = rg.pack_problems(graphs, layout=layout, **kw)
        pt = tg.pack_problems([torch_graph(g) for g in graphs], layout=layout, device="cpu", **kw)
        assert pt.edge_ranges == pr.edge_ranges, layout
        for f in pr.problem._fields:
            assert_same(getattr(pr.problem, f), getattr(pt.problem, f), f"{layout}.{f}")


def _symmetric(csr_graph, g):
    """``g``'s edges in both directions as one valid CSR (rows ascend, no
    self-loop, no duplicate within a row): the misuse of handing a
    symmetric CSR where an upper-triangular one is due."""
    pairs = np.concatenate([g.edge_list(), g.edge_list()[:, ::-1]]).astype(np.int64)
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    rowptr = np.zeros(g.n + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(pairs[:, 0], minlength=g.n + 1)[1:])
    return csr_graph(g.n, rowptr, pairs[:, 1].astype(np.int32), name=g.name + "-sym")


@pytest.mark.parametrize("entry", ["prepare_fine", "aligned", "contig", "session"])
def test_symmetric_csr_is_refused_like_reference(entry):
    gr, _ = small_pairs()[0]
    kw = dict(slot_n=128, slot_nnz=2048, slots=2, chunk=64)
    ref, port = _symmetric(rg.CSRGraph, gr), _symmetric(tg.CSRGraph, gr)

    def run(core, graphs, api, g, **dev):
        if entry == "prepare_fine":
            return core.prepare_fine(g, chunk=64, **dev)
        if entry == "session":
            return api.Session(**dev).solve([api.TrussQuery.decompose(g)])
        return graphs.pack_problems([g], layout=entry, **kw, **dev)

    if entry == "session":  # the resilience runner quarantines the query
        with pytest.raises(rerr.QueryFailedError) as want:
            run(rcore, rg, ra, ref)
        with pytest.raises(terr.QueryFailedError) as got:
            run(tcore, tg, ta, port, device="cpu")
        assert isinstance(want.value.cause, rerr.InvalidGraphError)
        assert isinstance(got.value.cause, terr.InvalidGraphError)
        assert got.value.cause.kind == "not_upper"
        assert got.value.attempts == want.value.attempts
    else:
        with pytest.raises(rerr.InvalidGraphError):
            run(rcore, rg, ra, ref)
        with pytest.raises(terr.InvalidGraphError, match="upper triangular") as got:
            run(tcore, tg, ta, port, device="cpu")
        rows = port.row_of_edge()
        first_low = int(rows[port.colidx <= rows][0])  # rows ascend in edge order
        assert (got.value.kind, got.value.row) == ("not_upper", first_low)


_KTRUSS = {b.name: b for b in rc.BENCH_GRAPHS + rc.LARGE_GRAPHS}


@pytest.mark.parametrize("name", list(_KTRUSS) + ["empty", "no-vertices"])
def test_bucket_from_the_device_equals_reference(name):
    """``bucket_for`` on the host and the planner's bucket, its undirected
    maximum degree an ``index_add_`` on the lift, are the reference's on
    every ``configs.ktruss`` graph and on empty ones."""
    from repro_torch.api.cache import bucket_from_degree, undirected_max_degree
    from repro_torch.graphs.csr import lift_csr

    if name in _KTRUSS:
        gr = _KTRUSS[name].build()
    else:
        gr = rg.from_edges(6 if name == "empty" else 0, np.zeros((0, 2), np.int64), name)
    gt = torch_graph(gr)
    for chunk in (64, 256):
        want = tuple(ra.bucket_for(gr, chunk=chunk))
        assert tuple(ta.bucket_for(gt, chunk=chunk)) == want
        und_max = int(undirected_max_degree(*lift_csr(gt, torch.device("cpu"))))
        assert tuple(bucket_from_degree(gt, und_max, chunk=chunk)) == want
    if gr.n:
        planner = ta.Planner(device="cpu", chunk=256)
        assert tuple(planner.assign(ta.TrussQuery.kmax(gt)).bucket) == tuple(ra.bucket_for(gr))


def _not_upper(g, case):
    """``g`` made not strictly upper triangular: both directions of every
    edge (``symmetric``), or one row given a column below it (``lower``)."""
    if case == "symmetric":
        return _symmetric(tg.CSRGraph, g)
    pairs = g.edge_list().astype(np.int64)
    row = int(pairs[len(pairs) // 2, 0])
    low = next(c for c in range(1, row) if c not in set(pairs[pairs[:, 0] == row, 1]))
    pairs = np.concatenate([pairs, [[row, low]]])
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    rowptr = np.zeros(g.n + 1, np.int64)
    rowptr[1:] = np.cumsum(np.bincount(pairs[:, 0], minlength=g.n + 1)[1:])
    return tg.CSRGraph(g.n, rowptr, pairs[:, 1].astype(np.int32), name=g.name + "-low")


@pytest.mark.parametrize("case", ["symmetric", "lower"])
def test_device_check_upper_names_the_first_low_row(case):
    """The test on the lift names the first nonempty row whose first column
    lies at or below it, with the host check's text, row, kind and graph,
    through ``check_upper``, ``prepare_fine`` and a ``Session``; an upper
    graph passes."""
    from repro_torch.graphs.csr import check_upper, lift_csr

    _, gt = small_pairs()[2]
    bad = _not_upper(gt, case)
    starts, ends = bad.rowptr[:-1], bad.rowptr[1:]
    rows = np.nonzero(starts < ends)[0]
    low = rows[bad.colidx[starts[rows]] <= rows + 1]
    row = int(low[0]) + 1
    col = int(bad.colidx[starts[row - 1]])
    text = (f"graph {bad.name!r}: column {col} at or below row {row}: the CSR must be "
            "strictly upper triangular (each edge once, as (min, max))")
    cpu = torch.device("cpu")
    check_upper(gt, *lift_csr(gt, cpu))
    for entry in (lambda: check_upper(bad, *lift_csr(bad, cpu)),
                  lambda: tcore.prepare_fine(bad, chunk=64, device="cpu")):
        with pytest.raises(terr.InvalidGraphError) as got:
            entry()
        assert (str(got.value), got.value.row, got.value.kind, got.value.graph) == (
            text, row, "not_upper", bad.name)
    with pytest.raises(terr.QueryFailedError) as failed:
        ta.Session(device="cpu").solve([ta.TrussQuery.decompose(bad)])
    assert str(failed.value.cause) == text and failed.value.cause.row == row


def _tiling_case(case):
    """A two-member aligned pack, reference and port, broken as ``case``
    says: a row spilling out of slot 0 or slot 1, a block that does not
    divide the slot, or a vertex count that does not divide the slots."""
    graphs = [rg.rmat(5, 6, seed=1), rg.erdos(25, 4.0, seed=0)]
    pr = rg.pack_problems(graphs, slot_n=64, slot_nnz=256, slots=2, chunk=64, layout="aligned")
    ref = pr.problem._replace(**{f: np.asarray(getattr(pr.problem, f)) for f in pr.problem._fields})
    slots, block = 2, 32
    if case.startswith("spill"):
        slot = int(case[-1])
        rowptr, deg = ref.rowptr.copy(), ref.deg
        v = slot * 64 + int(np.argmax(deg[slot * 64 + 1 : (slot + 1) * 64 + 1] > 0)) + 1
        rowptr[v - 1] = (slot + 1) * 256 - 1
        ref = ref._replace(rowptr=rowptr)
    elif case == "block":
        block = 512
    else:
        ref = ref._replace(rowptr=ref.rowptr[:-1], deg=ref.deg[:-1])
    return ref, torch_problem(ref), slots, block


@pytest.mark.parametrize("case", ["spill-0", "spill-1", "block", "vertices"])
def test_device_tiling_check_raises_the_reference_error(case):
    """The band test on the device (one int32 read back) names the same
    slot and row with the same text and kind as the reference's numpy
    check."""
    from repro.graphs.pack import validate_fused_tiling as ref_check
    from repro_torch.graphs.pack import validate_fused_tiling

    ref, port, slots, block = _tiling_case(case)
    with pytest.raises(rerr.InvalidGraphError) as want:
        ref_check(ref, slots=slots, block=block)
    with pytest.raises(terr.InvalidGraphError) as got:
        validate_fused_tiling(port, slots=slots, block=block)
    assert (str(got.value), got.value.slot, got.value.kind) == (
        str(want.value), want.value.slot, want.value.kind)


@pytest.mark.parametrize("name", ["rmat-12", "ba-6k", "edge-cases"])
def test_imbalance_stats_and_work_equal_reference(name):
    if name == "edge-cases":
        graphs = [g for gs, _ in _edge_case_graphs().values() for g in gs]
    else:
        graphs = [next(b for b in rc.BENCH_GRAPHS if b.name == name).build()]
    for gr in graphs:
        gt = torch_graph(gr)
        got = dataclasses.asdict(tg.imbalance_stats(gt, device="cpu"))
        assert got == dataclasses.asdict(rg.imbalance_stats(gr)), gr.name
        assert_same(rg.coarse_task_work(gr), tg.coarse_task_work(gt, device="cpu"), gr.name)
        assert_same(rg.fine_task_work(gr), tg.fine_task_work(gt, device="cpu"), gr.name)


def test_pack_rejects_oversized_member_like_reference():
    g = rg.erdos(100, 6.0, seed=1)
    for pack, graph in ((rg.pack_problems, g), (tg.pack_problems, torch_graph(g))):
        with pytest.raises(ValueError, match="slot_overflow|exceeding"):
            pack([graph], slot_n=64, slot_nnz=1024, slots=2, chunk=64, layout="aligned")


def test_problem_from_arrays_keeps_int32_and_refuses_overflow():
    gr, _ = small_pairs()[0]
    fields = {f: np.asarray(getattr(rcore.prepare_fine(gr, chunk=64), f)) for f in tcore.FineProblem._fields}
    p = tcore.problem_from_arrays({k: v.astype(np.int64) for k, v in fields.items()}, "cpu")
    assert all(getattr(p, f).dtype == torch.int32 for f in p._fields)
    fields["colidx"] = fields["colidx"].astype(np.int64) + (1 << 40)
    with pytest.raises(ValueError, match="int32"):
        tcore.problem_from_arrays(fields, "cpu")


def test_default_device_is_cuda_and_refuses_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, gt = small_pairs()[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.prepare_fine(gt, chunk=64)
