"""Port parity, the paper's single-graph layer: ``KTrussEngine`` for each of
the quickstart's (granularity, mode, backend) combinations and for
``bucketed=True``, the degree-bucketed and batched support entry points,
``stack_problems``, the flat-task index helpers and the coarse support's
``row_chunk`` keyword, each against the JAX package on the same inputs,
with exact equality (every output is an integer or a mask).

The JAX package's engine combinations agree with one another (its own
tests hold every combination to the numpy oracle), so one reference
engine per graph, ``fine/eager/xla``, is the oracle for every port
combination; it runs on XLA's CPU backend."""

import functools
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as rcore
import repro.graphs as rg
import repro.kernels.ops as rops
import repro_torch.core as tcore
import repro_torch.graphs as tg
import repro_torch.kernels.ops as tops
from _torch_parity import alive_masks, assert_same, small_pairs, torch_graph, torch_problem
from repro_torch.exec.peel import make_problem_support

COMBOS = [
    ("coarse", "eager", "xla", False),
    ("fine", "eager", "xla", False),
    ("fine", "owner", "xla", False),
    ("fine", "owner", "pallas", False),
    ("fine", "eager", "xla", True),
]
COMBO_IDS = ["coarse-eager-xla", "fine-eager-xla", "fine-owner-xla", "fine-owner-pallas", "bucketed"]


@functools.lru_cache(maxsize=None)
def _reference(i):
    """The JAX engine's answers on ``small_pairs()[i]``: ktruss(3),
    ktruss(4), peel_levels(), kmax(), decompose()."""
    gr, _ = small_pairs()[i]
    eng = rcore.KTrussEngine(gr, granularity="fine", mode="eager", backend="xla")
    return eng.ktruss(3), eng.ktruss(4), eng.peel_levels(), eng.kmax(), eng.decompose()


def _same_result(a, b, what):
    assert a.k == b.k, what
    assert_same(a.alive, b.alive, (what, "alive"))
    assert_same(a.support, b.support, (what, "support"))
    assert (a.iterations, a.edges_remaining) == (b.iterations, b.edges_remaining), what


@pytest.mark.parametrize("combo", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("i", [0, 1, 2])
def test_engine_matches_reference_engine(i, combo):
    gran, mode, backend, bucketed = combo
    gt = small_pairs()[i][1]
    k3, k4, (kmax_l, levels), kmax, dec = _reference(i)
    eng = tcore.KTrussEngine(
        gt, granularity=gran, mode=mode, backend=backend, bucketed=bucketed, device="cpu"
    )
    _same_result(k3, eng.ktruss(3), "ktruss(3)")
    _same_result(k4, eng.ktruss(4), "ktruss(4)")
    got_kmax, got_levels = eng.peel_levels()
    assert got_kmax == kmax_l and len(got_levels) == len(levels)
    for a, b in zip(levels, got_levels):
        _same_result(a, b, f"level {a.k}")
    assert eng.kmax() == kmax
    got = eng.decompose()
    assert_same(dec.trussness, got.trussness, "trussness")
    assert (got.kmax, got.levels) == (dec.kmax, dec.levels)
    assert eng.peel_executor.dispatches == 2  # kmax() and decompose(), one each


def test_engine_window_and_row_chunk_rules_match_reference():
    gr, gt = small_pairs()[2]
    for gran, mode, backend, _ in COMBOS[:4]:
        r = rcore.KTrussEngine(gr, granularity=gran, mode=mode, backend=backend)
        t = tcore.KTrussEngine(gt, granularity=gran, mode=mode, backend=backend, device="cpu")
        assert (t.window, t.row_chunk, t.chunk) == (r.window, r.row_chunk, r.chunk)
        assert_same(r.problem.colidx, t.problem.colidx)
    with pytest.raises(ValueError, match="bucketed"):
        tcore.KTrussEngine(gt, mode="owner", bucketed=True, device="cpu")


def test_engine_default_device_is_cuda(monkeypatch):
    assert inspect.signature(tcore.KTrussEngine).parameters["device"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt = small_pairs()[0][1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.KTrussEngine(gt)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.KTrussEngine(gt, device="cuda")


def test_engine_max_iters_caps_trips():
    gt = small_pairs()[2][1]
    full = tcore.KTrussEngine(gt, device="cpu").ktruss(5)
    assert full.iterations > 1
    capped = tcore.KTrussEngine(gt, max_iters=1, device="cpu").ktruss(5)
    assert capped.iterations == 1


# --------------------------------------------------------------------- #
# Degree bucketing, the eager hooks, batched entry points
# --------------------------------------------------------------------- #
BUCKET_GRAPHS = [
    lambda: rg.barabasi(150, 4, seed=7),
    lambda: rg.rmat(7, 4, seed=3),
    lambda: rg.clustered(3, 18, 0.7, seed=1),
]


@pytest.mark.parametrize("make", BUCKET_GRAPHS, ids=["barabasi", "rmat", "clustered"])
@pytest.mark.parametrize("chunk", [64, 256])
def test_bucket_tasks_identical(make, chunk):
    gr = make()
    want = rcore.bucket_tasks(gr, chunk=chunk)
    got = tcore.bucket_tasks(torch_graph(gr), chunk=chunk)
    assert [wb for wb, _ in got] == [wb for wb, _ in want]
    for (_, a), (_, b) in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("make", BUCKET_GRAPHS[:2], ids=["barabasi", "rmat"])
def test_support_fine_bucketed_matches_reference(make):
    gr = make()
    pr = rcore.prepare_fine(gr, chunk=64)
    pt = torch_problem(pr)
    rb = [(wb, jnp.asarray(ids)) for wb, ids in rcore.bucket_tasks(gr, chunk=64)]
    tb = [(wb, torch.from_numpy(ids)) for wb, ids in tcore.bucket_tasks(torch_graph(gr), chunk=64)]
    for alive in alive_masks(pr, seed=11, count=1):
        want = rcore.support_fine_bucketed(pr, jnp.asarray(alive), rb, chunk=64)
        got = tcore.support_fine_bucketed(pt, torch.from_numpy(alive), tb, chunk=64)
        assert_same(want, got)


def test_support_fine_eager_tasks_and_s_init_hooks():
    gr = rg.rmat(7, 4, seed=3)
    pr = rcore.prepare_fine(gr, chunk=64)
    pt = torch_problem(pr)
    rng = np.random.default_rng(5)
    w = max(8, -(-gr.max_degree() // 8) * 8)
    for alive in alive_masks(pr, seed=12):
        ids = rng.permutation(gr.nnz)[: gr.nnz // 2].astype(np.int32)
        ids = np.pad(ids, (0, -len(ids) % 64), constant_values=np.iinfo(np.int32).max)
        s0 = rng.integers(0, 50, pr.nnz_pad).astype(np.int32)
        want = rcore.support_fine_eager(
            pr, jnp.asarray(alive), window=w, chunk=64, tasks=jnp.asarray(ids), s_init=jnp.asarray(s0)
        )
        s0_t = torch.from_numpy(s0.copy())
        got = tcore.support_fine_eager(
            pt, torch.from_numpy(alive), window=w, chunk=64, tasks=torch.from_numpy(ids), s_init=s0_t
        )
        assert_same(want, got)
        assert np.array_equal(s0_t.numpy(), s0)  # s_init is not modified
    with pytest.raises(ValueError, match="chunk"):
        tcore.support_fine_eager(pt, pt.colidx != 0, window=w, chunk=64, tasks=torch.zeros(65, dtype=torch.int32))


def _stacked_inputs():
    gs = [rg.erdos(60, 6.0, seed=0), rg.erdos(60, 7.0, seed=5)]
    w = max(8, -(-max(int(g.undirected_csr().max_degree()) for g in gs) // 8) * 8)
    prs = [rcore.prepare_fine(g, chunk=64, nnz_pad=256, unnz_pad=512) for g in gs]
    rng = np.random.default_rng(9)
    alive = np.stack([(np.asarray(p.colidx) != 0) & (rng.random(256) < 0.8) for p in prs])
    return prs, [torch_problem(p) for p in prs], alive, w


def test_stack_problems_matches_reference():
    prs, pts, _, _ = _stacked_inputs()
    want, got = rg.stack_problems(prs), tg.stack_problems(pts)
    assert type(got) is tcore.FineProblem
    for name in want._fields:
        assert_same(getattr(want, name), getattr(got, name), name)
    with pytest.raises(ValueError, match="at least one"):
        tg.stack_problems([])
    other = torch_problem(rcore.prepare_fine(rg.erdos(60, 6.0, seed=0), chunk=64))
    with pytest.raises(ValueError, match="shape"):
        tg.stack_problems([pts[0], other])


@pytest.mark.parametrize("mode", ["eager", "owner"])
def test_support_fine_stacked_core_matches_reference(mode):
    prs, pts, alive, w = _stacked_inputs()
    want = rcore.support_fine_stacked(
        rg.stack_problems(prs), jnp.asarray(alive), window=w, chunk=64, mode=mode
    )
    got = tcore.support_fine_stacked(
        tg.stack_problems(pts), torch.from_numpy(alive), window=w, chunk=64, mode=mode
    )
    assert_same(want, got, mode)
    with pytest.raises(ValueError, match="mode"):
        tcore.support_fine_stacked(tg.stack_problems(pts), torch.from_numpy(alive), window=w, mode="x")


def test_support_fine_stacked_kernel_entry_matches_reference():
    prs, pts, alive, w = _stacked_inputs()
    want = rops.support_fine_stacked(
        rg.stack_problems(prs), jnp.asarray(alive), window=w, chunk=64, tile=64
    )
    got = tops.support_fine_stacked(tg.stack_problems(pts), torch.from_numpy(alive), window=w, chunk=64)
    assert_same(want, got)


# --------------------------------------------------------------------- #
# Flat-task index helpers and the coarse row_chunk keyword
# --------------------------------------------------------------------- #
def test_taskmap_helpers_match_reference():
    rng = np.random.default_rng(21)
    deg = rng.integers(0, 6, 40)
    rowptr = np.cumsum(deg).astype(np.int32)
    t = np.arange(int(rowptr[-1]) + 3, dtype=np.int32)
    assert_same(rcore.row_of_task(jnp.asarray(rowptr), jnp.asarray(t)),
                tcore.row_of_task(torch.from_numpy(rowptr), torch.from_numpy(t)), "row_of_task")

    flat = rng.integers(1, 100, 50).astype(np.int32)
    starts = rng.integers(-5, 55, 17).astype(np.int32)
    for width, fill in [(4, 0), (9, -1)]:
        assert_same(rcore.window_gather(jnp.asarray(flat), jnp.asarray(starts), width, fill),
                    tcore.window_gather(torch.from_numpy(flat), torch.from_numpy(starts), width, fill),
                    ("window_gather", width))

    ids = np.sort(rng.integers(0, 12, 60)).astype(np.int32)
    for segs in (12, 15):
        assert_same(rcore.segment_offsets(jnp.asarray(ids), segs),
                    tcore.segment_offsets(torch.from_numpy(ids), segs), ("segment_offsets", segs))


def test_row_chunk_does_not_change_coarse_support():
    gr, _ = small_pairs()[2]
    pr = rcore.prepare_fine(gr, chunk=64)
    pt = torch_problem(pr)
    w = max(8, -(-gr.max_degree() // 8) * 8)
    for alive in alive_masks(pr, seed=4):
        want = rcore.support_coarse_eager(pr, jnp.asarray(alive), window=w, row_chunk=8)
        a = torch.from_numpy(alive)
        for rc in (1, 7, 32):
            assert_same(want, tcore.support_coarse_eager(pt, a, window=w, row_chunk=rc), rc)
        fn = make_problem_support(granularity="coarse", window=w, row_chunk=3)
        assert_same(want, fn(pt, a), "make_problem_support")
    with pytest.raises(ValueError, match="row_chunk"):
        tcore.support_coarse_eager(pt, pt.colidx != 0, window=w, row_chunk=0)
