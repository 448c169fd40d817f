"""Port parity, host substrate: CSR generation, FineProblem arrays and the
block-diagonal packer equal the JAX package's, field by field and dtype
included (exact equality: every output is an integer)."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.configs as rc
import repro.core as rcore
import repro.graphs as rg
import repro_torch.api as ta
import repro_torch.configs as tc
import repro_torch.core as tcore
import repro_torch.graphs as tg
from _torch_parity import assert_same, small_pairs, torch_graph

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
        assert dataclasses.asdict(tg.imbalance_stats(gt)) == dataclasses.asdict(
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
