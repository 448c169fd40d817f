"""The hand-written CUDA kernels against their plain versions, on the
card.  Marked ``gpu``: each test decides inside itself whether a CUDA device
is present and skips otherwise (run them on a machine with an H100:
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py``)."""

import numpy as np
import pytest
import torch

import repro_torch.graphs as tg
from repro_torch.api import bucket_for
from repro_torch.core import prepare_fine, support_fine_owner, support_numpy
from repro_torch.kernels import support_fine, support_fine_cuda

pytestmark = pytest.mark.gpu

GRAPHS = [
    lambda: tg.erdos(120, 8.0, seed=0),
    lambda: tg.clustered(3, 18, 0.7, seed=1),
    lambda: tg.rmat(7, 5, seed=2),
    lambda: tg.barabasi(400, 4, seed=3),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("make", GRAPHS, ids=["erdos", "clustered", "rmat", "barabasi"])
def test_kernel_matches_plain_version_on_random_masks(cuda, make):
    g = make()
    w = bucket_for(g, chunk=64).window
    p = prepare_fine(g, chunk=64, device=cuda)
    real = (p.colidx != 0).cpu().numpy()
    rng = np.random.default_rng(5)
    for keep in (1.0, 0.8, 0.5, 0.1):
        alive = torch.from_numpy(real & (rng.random(real.shape[0]) < keep)).to(cuda)
        before = support_fine_cuda.launches
        got = support_fine_cuda(p, alive)
        torch.cuda.synchronize()
        assert support_fine_cuda.launches == before + 1
        want = support_fine_owner(p, alive, window=w, chunk=64)
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (g.name, keep)
    full = support_fine_cuda(p, torch.from_numpy(real).to(cuda))
    assert np.array_equal(full.cpu().numpy()[: g.nnz], support_numpy(g))


def test_kernel_on_aligned_pack_with_pad_lanes_between_rows(cuda):
    gs = [f() for f in GRAPHS[:3]]
    pp = tg.pack_problems(
        gs, slot_n=128, slot_nnz=1024, slots=4, chunk=64, layout="aligned", device=cuda
    )
    alive = pp.problem.colidx != 0
    w = max(bucket_for(g, chunk=64).window for g in gs)
    got = support_fine(pp.problem, alive, window=w, chunk=64)  # the CUDA branch
    want = support_fine_owner(pp.problem, alive, window=w, chunk=64)
    assert torch.equal(got, want)
    for g, (a, b) in zip(gs, pp.edge_ranges):
        assert np.array_equal(got[a:b].cpu().numpy(), support_numpy(g)), g.name


def _support_case(name, cuda):
    """(problem, window, alive) of one edge case of the support kernel."""
    if name == "split_hub":  # every clique lane's shorter row exceeds SPLIT_ROW
        g = _star_clique()
        p = prepare_fine(g, chunk=64, device=cuda)
        return p, bucket_for(g, chunk=64).window, p.colidx != 0
    gs = [f() for f in GRAPHS]
    b = [bucket_for(g, chunk=64) for g in gs]
    pp = tg.pack_problems(
        gs, slot_n=max(x.n_pad for x in b), slot_nnz=max(x.nnz_pad for x in b), slots=8,
        chunk=64, layout="aligned", device=cuda,
    )
    p, w = pp.problem, max(x.window for x in b)
    if name == "all_dead":  # an empty worklist
        return p, w, torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
    # one_live_slot: only the barabasi slot (the fourth of eight) is alive
    a, e = pp.edge_ranges[3]
    alive = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
    alive[a:e] = True
    return p, w, alive & (p.colidx != 0)


@pytest.mark.parametrize("name", ["split_hub", "all_dead", "one_live_slot"])
def test_kernel_matches_plain_version_on_edge_cases(cuda, name):
    from repro_torch.kernels.support_fine import worklist

    p, w, alive = _support_case(name, cuda)
    before = support_fine_cuda.launches
    got = support_fine_cuda(p, alive)
    torch.cuda.synchronize()
    assert support_fine_cuda.launches == before + 1
    want = support_fine_owner(p, alive, window=w, chunk=64)
    assert got.dtype == torch.int32 and torch.equal(got, want), name
    wl = worklist(p, alive)
    assert (wl.split.numel() > 0) == (name == "split_hub")
    assert (wl.items == 0) == (name == "all_dead")
    if name == "all_dead":
        assert not bool(got.any())
    if name == "one_live_slot":
        assert bool(got.any()) and not bool(got[~alive].any())


@pytest.mark.parametrize("stage", [0, 1], ids=["worklist", "items"])
def test_support_launch_error_raises(cuda, monkeypatch, stage):
    """2,048 threads a block is more than a CTA can have: the runtime refuses
    that launch, and the wrapper raises instead of returning a support
    (there is no fallback to the plain version).  Either of the kernel's two
    launches is checked; a later good call is not charged with the error."""
    import importlib

    # The module (the package's `support_fine` attribute is the function).
    sf = importlib.import_module("repro_torch.kernels.support_fine")

    p, w, alive = _support_case("split_hub", cuda)
    threads = [256, 256]
    threads[stage] = 2048
    monkeypatch.setattr(sf, "_LAUNCH_THREADS", tuple(threads))
    before = support_fine_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        support_fine_cuda(p, alive)
    assert support_fine_cuda.launches == before
    monkeypatch.undo()
    got = support_fine_cuda(p, alive)
    assert torch.equal(got, support_fine_owner(p, alive, window=w, chunk=64))


def test_kernel_refuses_wrong_inputs(cuda):
    g = GRAPHS[0]()
    p = prepare_fine(g, chunk=64, device=cuda)
    with pytest.raises(ValueError, match="bool"):
        support_fine_cuda(p, (p.colidx != 0).to(torch.int32))


# --------------------------------------------------------------------- #
# The fused level kernel (csrc/peel_fused.cu) against fused_level_torch
# --------------------------------------------------------------------- #
def _bench_pack(cuda):
    """er-4k, clustered-32x40 and rmat-12 (configs.BENCH_GRAPHS) packed
    aligned into one 4-slot batch of their largest bucket."""
    from repro_torch.configs import BENCH_GRAPHS

    gs = [b.build() for b in BENCH_GRAPHS if b.name in ("er-4k", "clustered-32x40", "rmat-12")]
    buckets = [bucket_for(g, chunk=256) for g in gs]
    nnz_pad = max(b.nnz_pad for b in buckets)
    pp = tg.pack_problems(
        gs, slot_n=max(b.n_pad for b in buckets), slot_nnz=nnz_pad, slots=4,
        chunk=256, layout="aligned", device=cuda,
    )
    return pp, max(b.window for b in buckets)


def test_fused_level_kernel_matches_plain_version_for_every_candidate(cuda):
    from repro_torch.exec.peel import PeelExecutor, init_peel_state
    from repro_torch.kernels.autotune import FusedConfig, candidate_configs
    from repro_torch.kernels.peel_fused import fused_level_cuda, fused_level_torch

    pp, window = _bench_pack(cuda)
    p = pp.problem
    slot_ids = torch.arange(4, dtype=torch.int32, device=cuda).repeat_interleave(pp.slot_nnz)
    k0 = torch.tensor([3, 3, 4, 3], dtype=torch.int32, device=cuda)
    single = torch.tensor([False, False, True, False], device=cuda)
    # Any frozen lanes and truss values are valid inputs: kernel and plain
    # version must agree on all of them.
    rng = np.random.default_rng(7)
    real = (p.colidx != 0).cpu().numpy()
    frozen_np = real & (rng.random(real.shape[0]) < 0.2)
    frozen_np[pp.slot_nnz :] = False  # slot 0 only
    frozen = torch.from_numpy(frozen_np).to(cuda)
    ftruss = torch.from_numpy(rng.integers(2, 9, real.shape[0]).astype(np.int32)).to(cuda)
    ftruss = ftruss * frozen
    alive0 = (p.colidx != 0) & ~frozen
    for cfg in candidate_configs(pp.slot_nnz):
        st = init_peel_state(slot_ids, k0, alive0, frozen, ftruss)
        levels = 0
        while not bool(st.done.all()):
            before = fused_level_cuda.launches
            got = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule)
            torch.cuda.synchronize()
            assert fused_level_cuda.launches == before + 1
            want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
            for f in got._fields:
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype and torch.equal(a, b), (cfg, levels, f)
            st, levels = got, levels + 1
        assert levels >= 3, cfg
    # The whole fused peel equals the unfused kernel path on every field but
    # total_iters, and launches once per level step.
    kw = dict(slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())
    before = fused_level_cuda.launches
    fused = PeelExecutor(backend="fused", window=window, chunk=256, fused_config=FusedConfig())
    st_f = fused.peel(p, **kw)
    st_p = PeelExecutor(mode="owner", backend="pallas", window=window, chunk=256).peel(p, **kw)
    assert fused_level_cuda.launches - before == int(st_f.levels.max())
    for f in st_f._fields:
        if f != "total_iters":
            assert torch.equal(getattr(st_f, f), getattr(st_p, f)), f
    assert fused.host_syncs == int(st_f.levels.max()) + 3


def test_fused_level_kernel_refuses_mis_tiled_block(cuda):
    from repro_torch.errors import InvalidGraphError
    from repro_torch.exec.peel import PeelExecutor, init_peel_state
    from repro_torch.kernels.autotune import FusedConfig
    from repro_torch.kernels.peel_fused import fused_level_cuda

    pp, window = _bench_pack(cuda)
    p = pp.problem
    slot_ids = torch.arange(4, dtype=torch.int32, device=cuda).repeat_interleave(pp.slot_nnz)
    k0 = torch.full((4,), 3, dtype=torch.int32, device=cuda)
    frozen = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
    ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32, device=cuda)
    st = init_peel_state(slot_ids, k0, p.colidx != 0, frozen, ftruss)
    single = torch.zeros(4, dtype=torch.bool, device=cuda)
    before = fused_level_cuda.launches
    with pytest.raises(ValueError, match="does not divide"):
        fused_level_cuda(p, st, frozen, ftruss, single, block=2 * pp.slot_nnz, schedule="compare")
    exe = PeelExecutor(
        backend="fused", window=window, chunk=256, fused_config=FusedConfig(block=2 * pp.slot_nnz)
    )
    with pytest.raises(InvalidGraphError, match="does not divide"):
        exe.peel(p, slot_ids=slot_ids, k0=k0.cpu().numpy())
    assert fused_level_cuda.launches == before


def test_fused_level_launch_error_raises(cuda):
    """65,536 one-lane slots need 768 KiB of shared memory per CTA for the
    per-slot latch, more than a CTA can have: the launch is refused, and
    the wrapper raises the typed error instead of returning a state."""
    from repro_torch.core import problem_from_arrays
    from repro_torch.errors import DeviceError
    from repro_torch.exec.peel import init_peel_state
    from repro_torch.kernels.peel_fused import fused_level_cuda

    slots = 1 << 16

    def z(n):
        return np.zeros(n, np.int32)

    p = problem_from_arrays(
        dict(rowptr=z(2), colidx=z(slots), edge_row=z(slots), deg=z(2), urowptr=z(2),
             ucolidx=z(2 * slots), u2d=np.full(2 * slots, slots), uedge_row=z(2 * slots),
             udeg=z(2)),
        cuda,
    )
    lanes = torch.arange(slots, dtype=torch.int32, device=cuda)
    frozen = torch.zeros(slots, dtype=torch.bool, device=cuda)
    st = init_peel_state(
        lanes, torch.full((slots,), 3, dtype=torch.int32, device=cuda),
        frozen, frozen, torch.zeros(slots, dtype=torch.int32, device=cuda),
    )
    before = fused_level_cuda.launches
    with pytest.raises(DeviceError, match="launch failed"):
        fused_level_cuda(p, st, frozen, st.trussness, frozen, block=1, schedule="bsearch")
    assert fused_level_cuda.launches == before


def _star_clique():
    """A hub joined to 1,499 other vertices, 270 of which also form a
    clique: every clique lane's shorter row has at least 270 entries, more
    than SPLIT_ROW, so the kernel splits it across warps."""
    n, clique = 1500, 270
    star = [(0, v) for v in range(1, n)]
    kk = [(i, j) for i in range(1, clique + 1) for j in range(i + 1, clique + 1)]
    return tg.from_edges(n, np.array(star + kk, dtype=np.int64), name="star-clique")


def _case(name, cuda):
    """(problem, window, k0, single, alive0, frozen, frozen_truss) of one
    whole-peel case of the fused kernel."""
    from repro_torch.core import trussness_numpy

    if name == "single_beside_decompose":
        pp, window = _bench_pack(cuda)
        k0, single = [3, 3, 4, 3], [False, False, True, False]
        p = pp.problem
        frozen = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
        ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32, device=cuda)
    else:
        g = tg.rmat(5, 6, seed=3) if name == "frozen" else _star_clique()
        b = bucket_for(g, chunk=64)
        pp = tg.pack_problems(
            [g, g], slot_n=b.n_pad, slot_nnz=b.nnz_pad, slots=2, chunk=64,
            layout="aligned", device=cuda,
        )
        p, window = pp.problem, b.window
        if name == "frozen":  # slot 0's even lanes frozen at the oracle's trussness
            k0, single = [3, 3], [False, False]
            oracle = trussness_numpy(g)
            ft = np.zeros(p.nnz_pad, np.int32)
            ft[: g.nnz] = oracle
            fz = np.zeros(p.nnz_pad, bool)
            fz[: g.nnz] = np.arange(g.nnz) % 2 == 0
            frozen = torch.from_numpy(fz).to(cuda)
            ftruss = torch.from_numpy(ft * fz).to(cuda)
        else:  # start the decompose slot near the clique's top level
            k0, single = [265, 3], [False, True]
            frozen = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
            ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32, device=cuda)
    slots = len(k0)
    lanes = torch.arange(slots, dtype=torch.int32, device=cuda)
    slot_ids = lanes.repeat_interleave(p.nnz_pad // slots)
    alive0 = (p.colidx != 0) & ~frozen
    k0 = torch.tensor(k0, dtype=torch.int32, device=cuda)
    single = torch.tensor(single, device=cuda)
    return p, window, slot_ids, k0, single, alive0, frozen, ftruss


@pytest.mark.parametrize("name", ["single_beside_decompose", "frozen", "split_hub"])
def test_fused_level_kernel_whole_peel_cases(cuda, name):
    """Every autotune candidate, level by level over the whole peel: all ten
    fields equal fused_level_torch's.  A slot done on entry comes out with
    the state in's alive, support and trussness (the kernel copies them;
    the plain version recomputes them)."""
    from repro_torch.exec.peel import init_peel_state
    from repro_torch.kernels.autotune import candidate_configs
    from repro_torch.kernels.peel_fused import (
        SPLIT_WAYS,
        fused_level_cuda,
        fused_level_torch,
        split_items,
    )

    p, window, slot_ids, k0, single, alive0, frozen, ftruss = _case(name, cuda)
    slot_nnz = p.nnz_pad // k0.numel()
    lanes_done = lambda st: st.done.repeat_interleave(slot_nnz)  # noqa: E731
    for cfg in candidate_configs(slot_nnz):
        st = init_peel_state(slot_ids, k0, alive0, frozen, ftruss)
        levels, copied = 0, 0
        while not bool(st.done.all()):
            log = torch.full((64,), -1, dtype=torch.int32, device=cuda)
            got = fused_level_cuda(
                p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule, trip_log=log
            )
            want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
            for f in got._fields:
                a, b = getattr(got, f), getattr(want, f)
                assert a.dtype == b.dtype and torch.equal(a, b), (name, cfg, levels, f)
            done = lanes_done(st)
            for f in ("alive", "support", "trussness"):
                assert torch.equal(getattr(got, f)[done], getattr(st, f)[done]), (name, f)
            copied += int(done.sum())
            # The worklist of the first trip: the alive lanes of live slots.
            live = st.alive & ~done
            flive = frozen & (ftruss >= st.cur_k.repeat_interleave(slot_nnz))
            unsplit, split = split_items(p, live, flive)
            assert log[:2].tolist() == [unsplit, split], (name, cfg, levels)
            if name == "split_hub" and levels == 0:
                assert split * SPLIT_WAYS > 0
            st, levels = got, levels + 1
        assert levels >= 2, (name, cfg)
        # On the all-done state no trip runs: the kernel prunes ahead with
        # s = 0 as the plain version does, instead of copying.
        got = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule)
        want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
        assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields), (name, cfg)
    assert copied > 0 or name == "frozen"


# --------------------------------------------------------------------- #
# The dense kernel (csrc/support_dense.cu) against support_dense_torch,
# and KTrussEngine through the support kernel
# --------------------------------------------------------------------- #
def _zero_one(v, seed, symmetric):
    rng = np.random.default_rng(seed)
    u = (rng.random((v, v)) < 0.15).astype(np.int8)
    if symmetric:
        u = np.triu(u, 1)
        u = u + u.T
    return u


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "asymmetric"])
def test_dense_kernel_matches_plain_version(cuda, symmetric):
    """V = 128 and 256 give fewer 128 x 256 tiles than SMs, 384 an odd count
    of 128-tiles (a ragged 256-wide column tile), 4,096 more tiles than
    SMs (the persistent grid walks several each)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.support_dense import (
        support_dense_cuda,
        support_dense_torch,
        transpose_cuda,
    )

    for v in (128, 256, 384, 4096):
        u = torch.from_numpy(_zero_one(v, v, symmetric)).to(cuda)
        assert symmetric == torch.equal(u, u.t())
        before = support_dense_cuda.launches
        got = support_dense_cuda(u)
        torch.cuda.synchronize()
        assert support_dense_cuda.launches == before + 1
        want = support_dense_torch(u)
        assert got.dtype == torch.float32 and torch.equal(got, want), v
        assert torch.equal(transpose_cuda(u), u.t().contiguous()), v
    u = _zero_one(1000, 1000, symmetric)  # padded to 1024 by ops.support_dense
    got = ops.support_dense(torch.from_numpy(u).to(cuda))
    want = support_dense_torch(torch.from_numpy(u))
    assert got.shape == (1000, 1000) and torch.equal(got.cpu(), want)


def test_dense_kernel_refuses_wrong_inputs(cuda):
    from repro_torch.kernels.support_dense import support_dense_cuda

    u = torch.from_numpy(_zero_one(256, 1, True)).to(cuda)
    before = support_dense_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        support_dense_cuda(u.cpu())
    with pytest.raises(ValueError, match="int8"):
        support_dense_cuda(u.to(torch.float32))
    with pytest.raises(ValueError, match="square"):
        support_dense_cuda(u[:128])
    with pytest.raises(ValueError, match="square"):
        support_dense_cuda(u[:200, :200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        support_dense_cuda(u.t())
    assert support_dense_cuda.launches == before


def test_engine_pallas_goes_through_the_kernel(cuda):
    from repro_torch.core import KTrussEngine

    g = GRAPHS[2]()
    eng = KTrussEngine(g, granularity="fine", mode="owner", backend="pallas", device=cuda)
    ref = KTrussEngine(g, granularity="fine", mode="owner", backend="pallas", device="cpu")
    before = support_fine_cuda.launches
    got, want = eng.ktruss(4), ref.ktruss(4)
    assert support_fine_cuda.launches - before == got.iterations > 0
    assert np.array_equal(got.alive, want.alive) and np.array_equal(got.support, want.support)
    assert got.iterations == want.iterations
    assert eng.kmax() == ref.kmax()
    assert np.array_equal(eng.decompose().trussness, ref.decompose().trussness)


def test_stream_update_on_the_card_matches_scratch_decompose(cuda):
    """A real ``StreamingTrussSession`` on a skewed graph (planned on
    ``fine/fused/aligned``, frozen lanes through ``fused_level_cuda``):
    every update equals a from-scratch decompose on ``fine/pallas/aligned``,
    and the card's triangle enumeration equals the CPU's, in order."""
    from repro_torch.api import Session, TrussQuery
    from repro_torch.kernels.peel_fused import fused_level_cuda
    from repro_torch.stream import EdgeBatch, StreamingTrussSession, edge_triangles

    g = tg.rmat(10, seed=0)
    got = edge_triangles(g, chunk=512, device=cuda)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), edge_triangles(g, chunk=512, device="cpu"))
    sess = StreamingTrussSession.for_graph(g, device=cuda, chunk=256)
    scratch = Session(device=cuda, backend="fine/pallas/aligned", max_batch=1, chunk=256)
    rng = np.random.default_rng(3)
    for width in (1, 1, 16, 64):
        existing = set(map(tuple, (sess.graph.edge_list() - 1).tolist()))
        ins = set()
        while len(ins) < max(width // 2, 1):
            a, b = sorted(int(x) for x in rng.integers(0, g.n, 2))
            if a != b and (a, b) not in existing:
                ins.add((a, b))
        el = sess.graph.edge_list() - 1
        dels = [tuple(e) for e in el[rng.permutation(len(el))[: width // 2]]]
        before = fused_level_cuda.launches
        res = sess.update(EdgeBatch.of(sorted(ins), dels))
        assert res.dispatches == 1 and fused_level_cuda.launches > before
        want = scratch.submit(TrussQuery.decompose(sess.graph)).result().trussness
        assert np.array_equal(res.trussness, want), width
    backends = {row["backend"] for row in sess.api.stats()["planner_backends"]}
    assert backends == {"fine/fused/aligned"}
    assert sess.metrics.value("stream_enumerations", kind="full") == 1
    assert sess._tri_cache.tri_keys.device.type == "cuda"
