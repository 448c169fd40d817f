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


@pytest.mark.parametrize("which", ["small", "rmat-12"])
def test_graph_preparation_on_the_card_equals_the_cpu(cuda, which):
    """prepare_fine, both packs and the imbalance statistics, built on the
    card, equal the CPU's field by field (the CPU's are held to the
    reference by tests/test_torch_graphs.py)."""
    from repro_torch.configs import BENCH_GRAPHS

    if which == "small":
        gs = [f() for f in GRAPHS[:3]]
    else:
        gs = [next(b for b in BENCH_GRAPHS if b.name == which).build()]
    for g in gs:
        on_card, on_cpu = prepare_fine(g, chunk=64, device=cuda), prepare_fine(g, chunk=64, device="cpu")
        for f, a, c in zip(on_card._fields, on_card, on_cpu):
            assert a.is_cuda and a.dtype == torch.int32 and torch.equal(a.cpu(), c), (g.name, f)
        assert tg.imbalance_stats(g, device=cuda) == tg.imbalance_stats(g, device="cpu"), g.name
    b = [bucket_for(g, chunk=64) for g in gs]
    kw = dict(slot_n=max(x.n_pad for x in b), slot_nnz=max(x.nnz_pad for x in b),
              slots=len(gs) + 1, chunk=64)
    for layout in ("aligned", "contig"):
        on_card = tg.pack_problems(gs, layout=layout, device=cuda, **kw)
        on_cpu = tg.pack_problems(gs, layout=layout, device="cpu", **kw)
        assert on_card.edge_ranges == on_cpu.edge_ranges
        for f, a, c in zip(on_card.problem._fields, on_card.problem, on_cpu.problem):
            assert a.is_cuda and torch.equal(a.cpu(), c), (layout, f)


@pytest.mark.parametrize("backend", [None, "fine/pallas/contig"])
def test_a_batch_on_one_graph_lifts_it_once_on_the_card(cuda, monkeypatch, backend):
    """A three-query batch on one graph copies it to the card once, in
    ``plan``, which reads back once; ``pack`` copies and reads back
    nothing; the fused tiling check (the auto rule's pick on rmat-9) and
    the answers are the CPU's."""
    from _torch_traffic import plan_pack_traffic
    from repro_torch.api import Session, TrussQuery

    g = tg.rmat(9, 8, seed=5)

    def three():
        return [TrussQuery.decompose(g), TrussQuery.kmax(g), TrussQuery.ktruss(g, k=4)]

    kw = dict(backend=backend, max_batch=8, kernel="pallas")
    want = Session(device="cpu", **kw).solve(three())
    session = Session(device=cuda, **kw)
    got, lifts, reads = plan_pack_traffic(monkeypatch, session, three(), g)
    assert lifts == ["plan", "plan"] and reads == {"plan": 1, "pack": 0}
    assert np.array_equal(got[0].trussness, want[0].trussness) and got[1] == want[1]
    assert np.array_equal(got[2].alive, want[2].alive)
    assert len(session.planner._lifts) == 0


def _support_case(name, cuda):
    """(problem, window, alive) of one case of the support kernel."""
    if name in ("split_hub", "delaunay18", "rmat15"):
        # split_hub: every clique lane's shorter row exceeds SPLIT_ROW;
        # delaunay18: a planar mesh whose 786 K short items span several
        # batches a block; rmat15: hub rows, split items.
        if name == "split_hub":
            g = _star_clique()
        elif name == "delaunay18":
            g = _delaunay(18)
        else:
            from repro_torch.configs import LARGE_GRAPHS

            g = next(b for b in LARGE_GRAPHS if b.name == "rmat-15").build()
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
    if name == "short_list":  # fewer items than one batch a block
        alive = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
        alive[torch.nonzero(p.colidx != 0).flatten()[::97]] = True
        return p, w, alive
    # one_live_slot: only the barabasi slot (the fourth of eight) is alive
    a, e = pp.edge_ranges[3]
    alive = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
    alive[a:e] = True
    return p, w, alive & (p.colidx != 0)


def _captured_claims(p, alive):
    """The global claims and reservations of one ``support_fine_cuda``
    pass, counted by its kernels in a captured graph's replay, and the
    pass's support."""
    from repro_torch.kernels.support_fine import count_launches_on_device

    counter = torch.zeros((), dtype=torch.int32, device=alive.device)
    claims = torch.zeros((), dtype=torch.int64, device=alive.device)
    side = torch.cuda.Stream(alive.device)
    side.wait_stream(torch.cuda.current_stream(alive.device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            with count_launches_on_device(counter, claims=claims):
                got = support_fine_cuda(p, alive)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(alive.device).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    assert int(counter) == 1
    return int(claims), got


@pytest.mark.parametrize(
    "name", ["split_hub", "all_dead", "one_live_slot", "delaunay18", "rmat15", "short_list"]
)
def test_kernel_matches_plain_version_on_edge_cases(cuda, name):
    """Bit for bit the plain version, eagerly and in a captured pass, whose
    global claims and reservations lie within what the batch rule allows
    (``claim_bounds``): far fewer than one claim a warp's draw."""
    from repro_torch.kernels.support_fine import claim_bounds, worklist

    p, w, alive = _support_case(name, cuda)
    before = support_fine_cuda.launches
    got = support_fine_cuda(p, alive)
    torch.cuda.synchronize()
    assert support_fine_cuda.launches == before + 1
    want = support_fine_owner(p, alive, window=w, chunk=64)
    assert got.dtype == torch.int32 and torch.equal(got, want), name
    wl = worklist(p, alive)
    assert (wl.split.numel() > 0) == (name in ("split_hub", "rmat15"))
    assert (wl.items == 0) == (name == "all_dead")
    if name == "all_dead":
        assert not bool(got.any())
    if name == "one_live_slot":
        assert bool(got.any()) and not bool(got[~alive].any())
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    claims, captured = _captured_claims(p, alive)
    assert torch.equal(captured, want), name
    lo, hi = claim_bounds(p, alive, sms)
    assert lo <= claims <= hi, (name, lo, claims, hi)
    if name == "all_dead":
        assert claims == 0
    if name in ("delaunay18", "rmat15"):  # batches of many draws, not a claim a draw
        assert 10 * claims < wl.items / 4, (name, claims, wl.items)


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
        st = init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss)
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
    single = torch.zeros(4, dtype=torch.bool, device=cuda)
    st = init_peel_state(p, slot_ids, k0, single, p.colidx != 0, frozen, ftruss)
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
    """65,536 one-lane slots need 1 MiB of shared memory per CTA for the
    per-slot latch and the slots to walk, more than a CTA can have: the launch is refused, and
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
        p, lanes, torch.full((slots,), 3, dtype=torch.int32, device=cuda), frozen,
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


def _hub_with_ears():
    """A clique on 300 vertices, a hub joined to 258 of them, and an ear on
    each hub edge (a vertex joined to the hub and to that clique vertex).
    At k = 260 the ears' edges (support 1) die on the first trip, both of an
    ear's in one trip; then each hub edge (support 257 + its ear's 1; its
    shorter row over SPLIT_ROW, so a split lane) loses its ear's triangle on
    the update and dies mid-level, two hub edges in each of the hub's
    triangles with the clique; the next update takes those off the clique's
    edges."""
    n, hub_deg = 300, 258
    clique = [(i, j) for i in range(1, n + 1) for j in range(i + 1, n + 1)]
    hub = [(0, v) for v in range(1, hub_deg + 1)]
    ears = [(x, n + v) for v in range(1, hub_deg + 1) for x in (0, v)]
    return tg.from_edges(n + hub_deg + 1, np.array(clique + hub + ears, dtype=np.int64),
                         name="hub-ears")


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
        g = {
            "frozen": lambda: tg.rmat(5, 6, seed=3),
            "split_hub": _star_clique,
            "hub_dies_mid_level": _hub_with_ears,
            # Level 9 of its decompose: a count, an update, then a trip that
            # kills more lanes than it keeps, so the next trip counts.
            "recount_after_update": lambda: tg.clustered(3, 18, 0.7, seed=1),
        }[name]()
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
        else:
            k0, single = {
                # the decompose slot near the clique's top level
                "split_hub": ([265, 3], [False, True]),
                # one level at k = 260, retired beside a decompose from the
                # clique's top levels (its hub edges die on the first trip)
                "hub_dies_mid_level": ([260, 299], [True, False]),
                "recount_after_update": ([3, 3], [False, True]),
            }[name]
            frozen = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
            ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32, device=cuda)
    slots = len(k0)
    lanes = torch.arange(slots, dtype=torch.int32, device=cuda)
    slot_ids = lanes.repeat_interleave(p.nnz_pad // slots)
    alive0 = (p.colidx != 0) & ~frozen
    k0 = torch.tensor(k0, dtype=torch.int32, device=cuda)
    single = torch.tensor(single, device=cuda)
    return p, window, slot_ids, k0, single, alive0, frozen, ftruss


CASES = ["single_beside_decompose", "frozen", "split_hub", "hub_dies_mid_level",
         "recount_after_update"]


@pytest.mark.parametrize("name", CASES)
def test_fused_level_kernel_whole_peel_cases(cuda, name):
    """Every autotune candidate (both schedules), level by level over the
    whole peel, each launch after the first handed the carry of the launch
    before: all ten fields equal fused_level_torch's and those of the same
    launch without a carry.  A slot done on entry comes out with the state
    in's alive, support and trussness (the kernel copies them; the plain
    version recomputes them).  A launch's first trip updates exactly when
    it has a carry of at most the lanes of its first worklist (``frozen``:
    frozen leavers among the carried deaths); its update trips are at most
    its trips, and its later trips' updates at most its trips but the
    first; ``hub_dies_mid_level`` updates over split lanes that died
    mid-level (triangles with two dying edges among them), and
    ``recount_after_update`` has a launch that updates and later counts
    again."""
    from repro_torch.exec.peel import init_peel_state
    from repro_torch.kernels.autotune import candidate_configs
    from repro_torch.kernels.peel_fused import (
        SPLIT_WAYS,
        LevelCarry,
        LevelCounts,
        fused_level_cuda,
        fused_level_torch,
        split_items,
    )

    p, window, slot_ids, k0, single, alive0, frozen, ftruss = _case(name, cuda)
    slot_nnz = p.nnz_pad // k0.numel()
    lanes_done = lambda st: st.done.repeat_interleave(slot_nnz)  # noqa: E731
    leavers = 0
    for cfg in candidate_configs(slot_nnz):
        st = init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss)
        levels, copied, mixed, carry = 0, 0, False, None
        while not bool(st.done.all()):
            log = torch.full((64,), -1, dtype=torch.int32, device=cuda)
            counts = LevelCounts.zeros(cuda)
            n_carry = int(carry.length) if carry is not None else None
            bare = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block,
                                    schedule=cfg.schedule)
            out = LevelCarry.empty(p.nnz_pad, cuda)
            got = fused_level_cuda(
                p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule, trip_log=log,
                level_counts=counts, carry=carry, carry_out=out,
            )
            want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
            for f in got._fields:
                a, b, c = getattr(got, f), getattr(want, f), getattr(bare, f)
                assert a.dtype == b.dtype and torch.equal(a, b), (name, cfg, levels, f)
                assert torch.equal(a, c), (name, cfg, levels, f)
            # The carry it recorded: in each slot that advanced, the lanes
            # alive at the level's fixed point (trussness set to cur_k) or
            # frozen-live at cur_k, and neither after the prune-ahead at the
            # next threshold.
            k_in = st.cur_k.repeat_interleave(slot_nnz)
            k_out = got.cur_k.repeat_interleave(slot_nnz)
            fixed = st.alive & (got.trussness == k_in)
            adv = k_out > k_in
            dying = adv & (fixed | (frozen & (ftruss >= k_in))) & ~(got.alive | (frozen & (ftruss >= k_out)))
            listed = out.lanes[: int(out.length)].sort().values
            assert torch.equal(listed, torch.nonzero(dying).flatten().to(torch.int32)), (name, levels)
            present = got.alive | (frozen & (ftruss >= k_out))
            flags = present.to(torch.uint8) + 2 * dying.to(torch.uint8)
            assert torch.equal(out.flags[adv], flags[adv]), (name, levels)
            leavers += int((dying & frozen).sum())
            done = lanes_done(st)
            for f in ("alive", "support", "trussness"):
                assert torch.equal(getattr(got, f)[done], getattr(st, f)[done]), (name, f)
            copied += int(done.sum())
            # The worklist of the first trip: the alive lanes of live slots,
            # a split lane once; their count is the level's alive lanes.
            live = st.alive & ~done
            flive = frozen & (ftruss >= st.cur_k.repeat_interleave(slot_nnz))
            unsplit, split = split_items(p, live, flive)
            assert log[:2].tolist() == [unsplit, split], (name, cfg, levels)
            if name == "split_hub" and levels == 0:
                assert split * SPLIT_WAYS > 0
            n = LevelCounts(*counts.tolist())
            assert n.alive_lanes == unsplit + split == int(live.sum()), (name, cfg, levels)
            trips = int(got.total_iters - st.total_iters)
            n_upd, counted = n.update_trips, n.counted_lanes
            first = n.carried
            assert first == int(n_carry is not None and n_carry <= unsplit + split), (
                name, cfg, levels, n_carry, unsplit + split)
            assert first <= n_upd <= max(trips - 1, 0) + first, (name, cfg, levels)
            # The lanes counted: the first trip's worklist when it counted,
            # and at most every trip's (a latched slot's lanes and the
            # update trips' excluded).
            worklists = (log[0: 2 * trips: 2] + log[1: 2 * trips: 2]).tolist()
            if 0 < trips <= log.numel() // 2:
                least = 0 if first else worklists[0]
                assert least <= counted <= sum(worklists[first:]), (name, cfg, levels)
            assert trips > 0 or counted == 0
            mixed |= 0 < n_upd < trips - 1
            if name == "hub_dies_mid_level" and levels == 0:
                # Trips 0-2: a count, then updates; the split lanes that
                # died on trip 1 (the hub's) leave trip 2's worklist.
                assert trips == 3 and n_upd == 2, (cfg, trips, n_upd)
                assert log[3] > log[5] > 0, log[:6].tolist()
            st, levels, carry = got, levels + 1, out
        assert levels >= 2, (name, cfg)
        # On the all-done state no trip runs: the kernel prunes ahead with
        # s = 0 as the plain version does, instead of copying.
        got = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule)
        want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
        assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields), (name, cfg)
        assert mixed or name != "recount_after_update", cfg
    assert copied > 0 or name == "frozen"
    assert (leavers > 0) is (name == "frozen")


def test_update_trips_on_rmat15(cuda):
    """A decompose of rmat-15 on the fused backend: some inner trips take
    their supports from the last trip's deaths.  The first launch's first
    trip counts; a later launch's first trip updates from the deaths the
    launch before carried over exactly when they are at most the lanes of
    its first worklist (the alive lanes at launch), and
    ``peel_level_trips_carried`` counts those launches: above 0, at most
    the launches less one."""
    from repro_torch.api import Session, TrussQuery
    from repro_torch.configs import LARGE_GRAPHS
    from repro_torch.kernels.peel_fused import LevelCarry, LevelCounts, fused_level_cuda
    from repro_torch.obs.names import (
        PEEL_LEVEL_TRIPS,
        PEEL_LEVEL_TRIPS_CARRIED,
        PEEL_LEVEL_TRIPS_INCREMENTAL,
    )

    g = LARGE_GRAPHS[0].factory()  # rmat-15
    s = Session(device=cuda, backend="fine/fused/aligned", max_batch=1)
    exe = s.executor_for(g)
    cfg, firsts = exe.fused_config, []
    carried = LevelCounts._fields.index("carried")

    def step(p, st, frozen, ftruss, single, *, carry=None, level_counts=None, **kw):
        log = torch.full((2,), -1, dtype=torch.int32, device=cuda)  # the first trip's worklist
        n_carry = int(carry.length) if carry is not None else None
        before = int(level_counts[carried])
        out = carry if carry is not None else LevelCarry.empty(p.nnz_pad, cuda)
        got = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule,
                               trip_log=log, level_counts=level_counts, carry=carry, carry_out=out,
                               **kw)
        firsts.append((n_carry, int(log.sum()), int(level_counts[carried]) - before))
        return got, out

    exe._peel.level_step = step
    s.solve([TrussQuery.decompose(g)])
    counters = s.metrics_snapshot()["counters"]
    levels = counters["peel_fused_levels"]
    trips, updates = counters[PEEL_LEVEL_TRIPS], counters[PEEL_LEVEL_TRIPS_INCREMENTAL]
    assert len(firsts) == levels and firsts[0][0] is None
    for i, (n_carry, lanes, first) in enumerate(firsts):
        assert first == int(n_carry is not None and n_carry <= lanes), (i, n_carry, lanes, first)
    n_carried = counters[PEEL_LEVEL_TRIPS_CARRIED]
    assert n_carried == sum(f for *_, f in firsts)
    assert 0 < n_carried <= levels - 1, (n_carried, levels)
    assert n_carried < updates <= trips - levels + n_carried, (updates, trips, levels, n_carried)


def _eight_slots(cuda):
    """(problem, window, slot_ids, k0, single) of an 8-slot aligned batch:
    three decompose members of kmax 3, 6 and 11 (one retires early, one
    late), a ``ktruss(4)`` member (one level), and four padded slots."""
    gs = [tg.erdos(200, 6.0, seed=1), tg.rmat(7, 5, seed=4), tg.clustered(3, 20, 0.8, seed=3),
          tg.rmat(8, 6, seed=2)]
    buckets = [bucket_for(g, chunk=64) for g in gs]
    pp = tg.pack_problems(gs, slot_n=max(b.n_pad for b in buckets),
                          slot_nnz=max(b.nnz_pad for b in buckets), slots=8, chunk=64,
                          layout="aligned", device=cuda)
    slot_ids = torch.arange(8, dtype=torch.int32, device=cuda).repeat_interleave(pp.slot_nnz)
    k0 = torch.tensor([3, 3, 3, 4, 3, 3, 3, 3], dtype=torch.int32, device=cuda)
    single = torch.tensor([False, False, False, True] + [False] * 4, device=cuda)
    return pp.problem, max(b.window for b in buckets), slot_ids, k0, single


def test_fused_level_loop_walks_only_the_slots_that_can_change(cuda):
    """Through the fused level loop of an 8-slot batch whose slots retire at
    different levels: each launch, handed the state of the launch before
    last (none to the first two) and writing into it, returns every field of
    ``fused_level_torch``'s level and of today's launch (the same carry, no
    state out); its counts are today's launch's but for ``walked_lanes``,
    which steps by ``slot_nnz`` times the slots walked (those not done at
    launch and the done ones the state out does not hold; every slot with no
    state out, whose launch walks all ``nnz_pad``).  The loop ends on the
    plain whole peel, files the walked lanes as ``peel_level_lanes_walked``
    and never writes the caller's ``alive0``.  The all-done launch into a
    state walks every slot and prunes with s = 0, as the plain version does;
    a state out that is the state in is refused."""
    from repro_torch.exec.peel import PeelExecutor, init_peel_state
    from repro_torch.kernels.peel_fused import (
        LevelCarry,
        LevelCounts,
        fused_level_cuda,
        fused_level_torch,
    )
    from repro_torch.obs import get_registry
    from repro_torch.obs.names import PEEL_LEVEL_LANES_WALKED

    p, window, slot_ids, k0, single = _eight_slots(cuda)
    slot_nnz = p.nnz_pad // 8
    alive0 = p.colidx != 0
    kept = alive0.clone()
    frozen = torch.zeros(p.nnz_pad, dtype=torch.bool, device=cuda)
    ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32, device=cuda)
    exe = PeelExecutor(backend="fused", window=window, chunk=64)
    cfg, inner = exe.fused_config, exe._peel.level_step
    walked_at = LevelCounts._fields.index("walked_lanes")
    walked, states = [], []

    def step(p, st, frozen, ftruss, single, *, carry=None, state_out=None, events=None,
             level_counts=None):
        level = len(walked)
        assert (state_out is None) is (level < 2) and state_out is not st
        today = LevelCounts.zeros(cuda)
        bare = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule,
                                level_counts=today, carry=carry,
                                carry_out=LevelCarry.empty(p.nnz_pad, cuda))
        want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
        done = st.done.clone()
        held = state_out.done.clone() if state_out is not None else torch.zeros_like(done)
        before = level_counts.clone()
        got, out = inner(p, st, frozen, ftruss, single, carry=carry, state_out=state_out,
                         events=events, level_counts=level_counts)
        assert state_out is None or all(x is y for x, y in zip(got, state_out))
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (level, f)
            assert torch.equal(getattr(got, f), getattr(bare, f)), (level, f)
        step_counts, today = (level_counts - before).tolist(), today.tolist()
        assert today[walked_at] == p.nnz_pad
        del step_counts[walked_at], today[walked_at]
        assert step_counts == today, level
        n = int((~done | ~held).sum()) if not bool(done.all()) else 8
        assert int(level_counts[walked_at] - before[walked_at]) == n * slot_nnz, (level, n)
        walked.append(n)
        states.append(got)
        return got, out

    exe._peel.level_step = step
    counters = get_registry().snapshot()["counters"]
    walked0 = counters.get(PEEL_LEVEL_LANES_WALKED, 0)
    st = exe.peel(p, slot_ids=slot_ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy(),
                  alive0=alive0)
    assert get_registry().snapshot()["counters"][PEEL_LEVEL_LANES_WALKED] - walked0 == (
        slot_nnz * sum(walked))
    assert torch.equal(alive0, kept)
    assert walked[:2] == [8, 8] and min(walked) == 1, walked
    assert len(set(st.levels[:3].tolist())) == 3, st.levels
    ref = init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss)
    while not bool(ref.done.all()):
        ref = fused_level_torch(p, ref, frozen, ftruss, single, window=window, block=cfg.block)
    for f in st._fields:
        assert torch.equal(getattr(st, f), getattr(ref, f)), f
    # The all-done launch, into the state the loop's last launch did not
    # return, and with no state out.
    want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=cfg.block)
    bare = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule)
    counts = LevelCounts.zeros(cuda)
    got = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule,
                           level_counts=counts, state_out=states[-2])
    assert all(torch.equal(getattr(got, f), getattr(want, f)) for f in got._fields)
    assert all(torch.equal(getattr(bare, f), getattr(want, f)) for f in got._fields)
    assert int(counts[walked_at]) == p.nnz_pad
    with pytest.raises(ValueError, match="apart from the state in"):
        fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule,
                         state_out=st)


def _ktbench_root():
    """The repository's root, put on the path for the benchmark's package
    (``ktbench``, beside ``tests``)."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    return root


def _rgg(log2_n: int):
    """The benchmark's random geometric graph at ``2**log2_n`` points."""
    import json

    root = _ktbench_root()
    from ktbench import generators

    config = json.loads((root / "ktbench" / "configs" / "rgg_n_2_20_s0.json").read_text())
    n, edges = generators.config_graph(dict(config, log2_n=log2_n), 2_147_483_659, 0)
    return tg.from_edges(n, edges, name=f"rgg{log2_n}")


def _reference_trussness(g, device):
    """The benchmark's plain reference on ``g``'s edges, in lane order."""
    _ktbench_root()
    from ktbench import reference

    rows = np.repeat(np.arange(g.n), np.diff(g.rowptr))  # row v + 1 (1-based)
    edges = np.stack([rows, g.colidx.astype(np.int64) - 1], 1)
    return reference.trussness(g.n, edges, device)


@pytest.mark.parametrize("which", ["rgg12", "rmat15"])
def test_counted_lanes_of_the_fused_kernel(cuda, which):
    """A traced one-slot decompose on the fused backend, through the carry,
    each launch also writing its trip log: the kernel's ``counted`` grows,
    each level, by the worklists of the trips that counted (the first when
    the launch had no carry or one of more lanes than the worklist, and
    every later trip whose last prune killed more lanes than it kept), and
    its ``alive_lanes`` by the alive lanes of the live slots at launch; the
    dispatch's ``peel_level_lanes_counted`` and the levels'
    ``counted_lanes`` hold the same; a level whose first trip counted and
    whose later trips all updated counted exactly the alive lanes it
    started on (``peel-level.done``'s ``alive_lanes``), and one whose trips
    all updated counted none.  The state of every launch equals the same
    launch without the counts and the carry (and, on the small graph, the
    plain version's)."""
    from repro_torch.api import Session, TrussQuery
    from repro_torch.configs import LARGE_GRAPHS
    from repro_torch.kernels.peel_fused import (
        LevelCarry,
        LevelCounts,
        fused_level_cuda,
        fused_level_torch,
    )
    from repro_torch.obs.names import PEEL_LEVEL_LANES_COUNTED

    g = _rgg(12) if which == "rgg12" else LARGE_GRAPHS[0].factory()  # rmat-15
    s = Session(device=cuda, backend="fine/fused/aligned", max_batch=1, trace=True)
    exe = s.executor_for(g)
    cfg, window = exe.fused_config, bucket_for(g, chunk=s.planner.chunk).window
    levels = []

    def step(p, st, frozen, ftruss, single, *, carry=None, state_out=None, events=None,
             level_counts=None):
        log = torch.full((4096,), -1, dtype=torch.int32, device=cuda)
        before = LevelCounts(*level_counts.tolist())
        n_carry = int(carry.length) if carry is not None else None
        bare = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule)
        kept = carry if carry is not None else LevelCarry.empty(p.nnz_pad, cuda)
        out = fused_level_cuda(p, st, frozen, ftruss, single, block=cfg.block, schedule=cfg.schedule,
                               trip_log=log, level_counts=level_counts, carry=carry, carry_out=kept,
                               state_out=state_out, events=events)
        wants = [bare]
        if which == "rgg12":
            wants.append(fused_level_torch(p, st, frozen, ftruss, single, window=window,
                                           block=cfg.block))
        for want in wants:
            assert all(torch.equal(getattr(out, f), getattr(want, f)) for f in out._fields)
        trips = int(out.total_iters - st.total_iters)
        assert trips <= log.numel() // 2
        lanes = (log[0: 2 * trips: 2] + log[1: 2 * trips: 2]).tolist()
        first_counts = n_carry is None or n_carry > lanes[0]
        counts = [first_counts if i == 0 else lanes[i - 1] - lanes[i] > lanes[i]
                  for i in range(trips)]
        levels.append(sum(n for n, c in zip(lanes, counts) if c))
        after = LevelCounts(*level_counts.tolist())
        assert after.counted_lanes - before.counted_lanes == levels[-1], (n_carry, lanes)
        live = st.alive & ~st.done.repeat_interleave(p.nnz_pad // st.done.numel())
        assert after.alive_lanes - before.alive_lanes == int(live.sum()) == lanes[0]
        return out, kept

    exe._peel.level_step = step
    res = s.solve([TrussQuery.decompose(g)])[0]
    want = _reference_trussness(g, cuda)
    assert np.array_equal(res.trussness, want)
    assert s.metrics_snapshot()["counters"][PEEL_LEVEL_LANES_COUNTED] == sum(levels) > 0
    done = [e["args"] for e in s.obs.tracer.events() if e["name"] == "peel-level.done"]
    assert [a["counted_lanes"] for a in done] == levels
    whole = [a for a in done if not a["carried"] and a["update_trips"] == a["trips"] - 1]
    assert whole and all(a["counted_lanes"] == a["alive_lanes"] for a in whole)
    none = [a for a in done if a["carried"] and a["update_trips"] == a["trips"]]
    assert none and all(a["counted_lanes"] == 0 for a in none)
    assert sum(a["counted_lanes"] for a in done) < sum(a["alive_lanes"] for a in done)


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


def test_stream_on_the_card_equals_the_cpu_after_every_commit(cuda):
    """rmat-12 (``BENCH_GRAPHS``) updates through a stream on the card,
    with every stage replayed on ``device="cpu"`` from the same committed
    state (the CPU's own peel of rmat-12 takes most of a minute an
    update): each update's delta and frontier equal field by field, and
    after every commit the graph, the triangle cache and the trussness
    (host and device) equal the CPU's, the trussness a from-scratch
    decompose."""
    from repro_torch.api import Session, TrussQuery
    from repro_torch.configs import BENCH_GRAPHS
    from repro_torch.stream import (
        EdgeBatch, StreamingTrussSession, TriangleCache, apply_batch, compute_frontier,
    )
    from repro_torch.stream.frontier import union_graph

    g = next(b for b in BENCH_GRAPHS if b.name == "rmat-12").build()
    card = StreamingTrussSession.for_graph(g, device=cuda, chunk=256)
    scratch = Session(device=cuda, backend="fine/pallas/aligned", max_batch=1, chunk=256)
    g_cpu, t_cpu, cache = g, card.trussness, TriangleCache(g, device="cpu")
    rng = np.random.default_rng(12)
    for width in (1, 2, 8, 16, 64):
        existing = set(map(tuple, (g_cpu.edge_list() - 1).tolist()))
        ins = set()
        while len(ins) < max(width // 2, 1):
            a, b = sorted(int(x) for x in rng.integers(0, g.n, 2))
            if a != b and (a, b) not in existing:
                ins.add((a, b))
        el = g_cpu.edge_list() - 1
        batch = EdgeBatch.of(sorted(ins), [tuple(e) for e in el[rng.permutation(len(el))[: width // 2]]])
        dc = apply_batch(card.graph, batch, device=cuda)
        dh = apply_batch(g_cpu, batch, device="cpu")
        for f, a, b in zip(dc.tensors._fields, dc.tensors, dh.tensors):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b), (width, f)
        union = union_graph(dh)
        tri_keys = cache.union_triangles(dh, union=union)
        fc = compute_frontier(card.trussness, dc, device=cuda)
        fh = compute_frontier(t_cpu, dh, tri_keys=tri_keys, union=union, device="cpu")
        assert (fc.rounds, fc.num_triangles, fc.size) == (fh.rounds, fh.num_triangles, fh.size)
        for f, a, b in zip(fc.tensors._fields, fc.tensors, fh.tensors):
            assert a.is_cuda and a.dtype == b.dtype and torch.equal(a.cpu(), b), (width, f)
        res = card.update(batch)
        cache.commit(dh, tri_keys)
        g_cpu = dh.new_graph
        want = scratch.submit(TrussQuery.decompose(g_cpu)).result().trussness
        carry = np.where(dh.new2old >= 0, t_cpu[np.maximum(dh.new2old, 0)], 2)
        assert np.array_equal(want[~fh.frontier], carry[~fh.frontier]), width
        t_cpu = want
        assert res.frontier_size == fh.size and res.num_edges == g_cpu.nnz
        assert res.trussness.dtype == np.int32 and np.array_equal(res.trussness, want), width
        assert np.array_equal(card.trussness, want)
        assert card._trussness_dev.is_cuda and np.array_equal(card._trussness_dev.cpu().numpy(), want)
        assert np.array_equal(card.graph.rowptr, g_cpu.rowptr)
        assert card.graph.colidx.dtype == np.int32 and np.array_equal(card.graph.colidx, g_cpu.colidx)
        assert card.graph.__dict__["_lifted"][0].is_cuda
        assert torch.equal(card._tri_cache.tri_keys.cpu(), cache.tri_keys)


def test_session_fused_launch_failure_is_terminal_and_loud(cuda, monkeypatch):
    """A nonzero code from the fused library's launch (here the runtime's
    ``cudaErrorCooperativeLaunchTooLarge``, returned by a wrapper around the
    loaded symbol, so the wrapper's real ``if rc:`` path raises) fails every
    query of the batch with ``QueryFailedError``: no retry, no step down the
    fallback chain, and neither the support kernel nor the level's plain
    version runs.  The same session serves once the launch works again."""
    import repro_torch.kernels.peel_fused as kpf
    from repro_torch.api import QueryFailedError, Session, TrussQuery

    built = kpf.load_peel_fused()
    plain_calls = []
    monkeypatch.setattr(kpf, "fused_level_torch", lambda *a, **k: plain_calls.append(1))
    monkeypatch.setattr(built.lib, "peel_fused_launch", lambda *a: 720)
    g = GRAPHS[2]()
    s = Session(device=cuda, backend="fine/fused/aligned", max_batch=4, chunk=64)
    before = (kpf.fused_level_cuda.launches, support_fine_cuda.launches)
    futs = [s.submit(TrussQuery.decompose(g)), s.submit(TrussQuery.kmax(g))]
    s.flush()
    for f in futs:
        with pytest.raises(QueryFailedError) as ei:
            f.result()
        e = ei.value
        assert type(e.cause).__name__ == "DeviceError" and e.cause.site == "fused_level"
        assert not e.cause.injected and "cudaError 720" in str(e.cause)
        assert [str(b) for b in e.backends_tried] == ["fine/fused/aligned"]
    assert (s.retries, s.backend_fallbacks, s.batch_bisects, s.queries_failed) == (0, 0, 0, 2)
    assert (kpf.fused_level_cuda.launches, support_fine_cuda.launches) == before
    assert not plain_calls
    monkeypatch.undo()
    dec = s.solve([TrussQuery.decompose(g)])[0]
    want = Session(device="cpu", backend="fine/fused/aligned", max_batch=4, chunk=64).solve(
        [TrussQuery.decompose(g)])[0]
    assert np.array_equal(dec.trussness, want.trussness)
    assert kpf.fused_level_cuda.launches > before[0]


def test_session_support_launch_failure_is_terminal_and_loud(cuda, monkeypatch):
    """A refused launch of ``support_fine_cuda`` (2,048 threads a block) on
    ``fine/pallas/aligned`` fails the batch typed, with no fallback to the
    torch-ops twin; the session serves again afterwards."""
    import importlib

    from repro_torch.api import QueryFailedError, Session, TrussQuery

    sf = importlib.import_module("repro_torch.kernels.support_fine")
    monkeypatch.setattr(sf, "_LAUNCH_THREADS", (2048, 256))
    g = GRAPHS[0]()
    s = Session(device=cuda, backend="fine/pallas/aligned", max_batch=2, chunk=64)
    fut = s.submit(TrussQuery.decompose(g))
    s.flush()
    with pytest.raises(QueryFailedError) as ei:
        fut.result()
    assert ei.value.cause.site == "support_fine" and not ei.value.cause.injected
    assert [str(b) for b in ei.value.backends_tried] == ["fine/pallas/aligned"]
    assert (s.retries, s.backend_fallbacks) == (0, 0)
    assert s.cache.stats.compiles == 1  # no other backend's executor was built
    monkeypatch.undo()
    got = s.solve([TrussQuery.decompose(g)])[0]
    assert np.array_equal(got.trussness, _numpy_trussness(g))


@pytest.mark.parametrize("backend", ["fine/fused/aligned", "fine/pallas/aligned"])
def test_session_kernel_scratch_oom_is_terminal_and_loud(cuda, monkeypatch, backend):
    """A real ``torch.OutOfMemoryError`` from a hand kernel's scratch
    allocation (its sizing asks for 4 TiB) is a kernel fault on the card:
    every query fails typed, with no retry, no step down the chain and no
    plain version run.  The session serves again afterwards."""
    import importlib

    import repro_torch.kernels.ops as kops
    import repro_torch.kernels.peel_fused as kpf
    from repro_torch.api import QueryFailedError, Session, TrussQuery

    sf = importlib.import_module("repro_torch.kernels.support_fine")  # not the function
    g = GRAPHS[2]()
    want = _numpy_trussness(g)
    # Warm the kernel libraries on another session: on fine/pallas/aligned
    # the scratch is allocated when the trip graph is captured, on this
    # session's first dispatch of the shape (a replay allocates nothing).
    warm = Session(device=cuda, backend=backend, max_batch=4, chunk=64)
    assert np.array_equal(warm.solve([TrussQuery.decompose(g)])[0].trussness, want)
    s = Session(device=cuda, backend=backend, max_batch=4, chunk=64)
    plain_calls = []
    monkeypatch.setattr(kpf, "fused_level_torch", lambda *a, **k: plain_calls.append(1))
    monkeypatch.setattr(kops, "support_fine_owner", lambda *a, **k: plain_calls.append(1))
    if backend == "fine/fused/aligned":
        real, key = kpf.scratch_elements, "acc"
        monkeypatch.setattr(kpf, "scratch_elements", lambda *a: {**real(*a), key: 1 << 40})
    else:
        real, key = sf.worklist_elements, "list"
        monkeypatch.setattr(sf, "worklist_elements", lambda *a: {**real(*a), key: 1 << 40})
    before = (kpf.fused_level_cuda.launches, support_fine_cuda.launches)
    futs = [s.submit(TrussQuery.decompose(g)), s.submit(TrussQuery.kmax(g))]
    s.flush()
    for f in futs:
        with pytest.raises(QueryFailedError) as ei:
            f.result()
        e = ei.value
        assert type(e.cause).__name__ == "DeviceError" and e.cause.oom and e.cause.kernel_fault
        assert isinstance(e.cause.cause, torch.OutOfMemoryError)
        assert [str(b) for b in e.backends_tried] == [backend]
    assert (s.retries, s.backend_fallbacks, s.batch_bisects) == (0, 0, 0)
    assert s.obs.metrics.value("dispatch_failures", site="oom") == 1
    assert (kpf.fused_level_cuda.launches, support_fine_cuda.launches) == before
    assert not plain_calls and s.cache.stats.compiles == 1
    monkeypatch.undo()
    assert np.array_equal(s.solve([TrussQuery.decompose(g)])[0].trussness, want)


# --------------------------------------------------------------------- #
# The unfused peel as a captured CUDA graph
# --------------------------------------------------------------------- #
def _graph_peel_inputs(cuda, layout, frozen):
    """Three small graphs in 4 slots of one pack (decompose, ktruss(4) and
    kmax members and an empty slot) in ``layout``, and the peel's inputs
    on the card; with ``frozen``, a seeded frontier of each member is free
    and its other real lanes frozen at their trussness (every k0 3)."""
    from repro_torch.core import trussness_numpy

    gs = [make() for make in GRAPHS[:3]]
    buckets = [bucket_for(g, chunk=64) for g in gs]
    slot_nnz = max(b.nnz_pad for b in buckets)
    pp = tg.pack_problems(
        gs, slot_n=max(b.n_pad for b in buckets), slot_nnz=slot_nnz, slots=4,
        chunk=64, layout=layout, device=cuda,
    )
    nnzp = pp.problem.nnz_pad
    ids = np.repeat(np.arange(4, dtype=np.int32), slot_nnz)
    if layout == "contig":  # members prefix-packed, the pad tail parked on slot 0
        ids = np.zeros(nnzp, np.int32)
        for i, (a, b) in enumerate(pp.edge_ranges):
            ids[a:b] = i
    alive0 = np.zeros(nnzp, bool)
    fz = np.zeros(nnzp, bool)
    ft = np.zeros(nnzp, np.int32)
    rng = np.random.default_rng(5)
    for g, (a, b) in zip(gs, pp.edge_ranges):
        alive0[a:b] = True
        if frozen:
            free = rng.random(b - a) < 0.3
            alive0[a:b], fz[a:b] = free, ~free
            ft[a:b] = np.where(free, 0, trussness_numpy(g))
    k0 = [3, 3, 3, 3] if frozen else [3, 4, 3, 3]

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=cuda)

    args = (dev(ids), dev(k0, torch.int32), dev([False, True, False, False]), dev(alive0),
            dev(fz), dev(ft))
    return pp.problem, args, max(b.window for b in buckets)


def _eager_trip_loop(support, p, slot_ids, k0, single, alive0, frozen, ftruss):
    """The peel's trips driven by hand, one ``_peel_step`` at a time with
    ``done`` read back after each: the eager loop the graph replaces."""
    from repro_torch.exec import peel as pm

    aligned = bool(pm._is_aligned(slot_ids, int(k0.shape[0])))
    sums = pm._SlotSums(slot_ids, int(k0.shape[0]), aligned=aligned)
    st = pm.init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss, sums=sums)
    lanes = slot_ids.long()
    while not bool(st.done.all()):
        st = pm._peel_step(support, p, lanes, sums, single, frozen, ftruss, st)
    return st


@pytest.mark.parametrize("frozen", [False, True], ids=["free", "frozen"])
@pytest.mark.parametrize("layout", ["aligned", "contig"])
def test_graph_peel_equals_eager_trip_loop(cuda, layout, frozen):
    """The unfused peel on the card (one captured graph, its trip loop a
    WHILE node) equals the hand-driven eager loop and the CPU's peel field
    for field; the support kernel counts one launch a trip on the device;
    readbacks are one before the first trip and one at the loop's exit."""
    from repro_torch.exec import build_peel, make_problem_support
    from repro_torch.exec import peel as pm

    p, args, window = _graph_peel_inputs(cuda, layout, frozen)
    cfg = dict(granularity="fine", mode="owner", window=window, chunk=64)
    support = make_problem_support(backend="pallas", **cfg)
    peel = build_peel(support)
    before = support_fine_cuda.launches
    got = peel(p, *args)
    trips = int(got.total_iters)
    assert support_fine_cuda.launches - before == trips > 0
    assert peel.host_syncs == 2
    want = _eager_trip_loop(support, p, *args)
    cpu = build_peel(make_problem_support(backend="xla", **cfg))(
        type(p)(*(t.cpu() for t in p)), *(a.cpu() for a in args)
    )
    for name, a, b, c in zip(pm.PeelState._fields, got, want, cpu):
        assert a.device.type == "cuda" and torch.equal(a, b), name
        assert torch.equal(a.cpu(), c), name


def test_graph_peel_captures_once_and_keeps_each_result(cuda):
    """Two dispatches with different inputs through one executor: one
    capture (the first dispatch's), and the second replay does not
    overwrite the first result."""
    from repro_torch.analysis.sentinel import count_compiles
    from repro_torch.exec import PeelExecutor

    p, (ids, k0, single, alive0, _, _), window = _graph_peel_inputs(cuda, "aligned", False)
    _, (_, k0f, _, alive0f, fz, ft), _ = _graph_peel_inputs(cuda, "aligned", True)
    exe = PeelExecutor(mode="owner", backend="pallas", window=window, chunk=64)
    with count_compiles() as log:
        first = exe.peel(p, slot_ids=ids, k0=k0.cpu().numpy(), single_level=single.cpu().numpy())
        kept = [t.clone() for t in first]
        second = exe.peel(p, slot_ids=ids, k0=k0f.cpu().numpy(), single_level=single.cpu().numpy(),
                          alive0=alive0f, frozen=fz, frozen_truss=ft)
    assert (log.captures, log.kernel_builds) == (1, 0)
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    want = _eager_trip_loop(exe.support, p, ids, k0f, single, alive0f, fz, ft)
    assert all(torch.equal(a, b) for a, b in zip(second, want))
    assert not torch.equal(first.trussness, second.trussness) or not torch.equal(
        first.iters, second.iters)


def test_captured_support_pass_needs_a_device_launch_counter(cuda):
    """A support pass captured into a CUDA graph is counted by its kernel
    on the device, once each time the graph runs it: without a counter the
    capture is refused, with one the count follows the replays."""
    from repro_torch.kernels.support_fine import count_launches_on_device

    g = GRAPHS[0]()
    p = prepare_fine(g, chunk=64, device=cuda)
    alive = p.colidx != 0
    want = support_fine_cuda(p, alive)
    counter = torch.zeros((), dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            with pytest.raises(ValueError, match="launch counter"):
                support_fine_cuda(p, alive)
            with count_launches_on_device(counter):
                got = support_fine_cuda(p, alive)
        finally:
            graph.capture_end()
    torch.cuda.current_stream(cuda).wait_stream(side)
    before = support_fine_cuda.launches
    for _ in range(3):
        graph.replay()
    assert int(counter) == 3 and support_fine_cuda.launches == before
    assert torch.equal(got, want)


def _delaunay(log2_n: int):
    """The benchmark's Delaunay graph at ``2**log2_n`` points (Qhull on the
    host)."""
    import json

    pytest.importorskip("scipy.spatial")
    root = _ktbench_root()
    from ktbench import generators

    config = json.loads((root / "ktbench" / "configs" / "delaunay_n20.json").read_text())
    n, edges = generators.config_graph(dict(config, log2_n=log2_n), 2_147_483_659, 0)
    return tg.from_edges(n, edges, name=f"delaunay{log2_n}")


def _wide_inputs(cuda, gs, bucket, slots=8):
    """``gs`` packed from slot 0 on ``slots`` aligned slots of ``bucket``,
    every member a decompose, and the peel's inputs on the card."""
    pp = tg.pack_problems(gs, slot_n=bucket.n_pad, slot_nnz=bucket.nnz_pad, slots=slots,
                          chunk=64, layout="aligned", device=cuda)
    p = pp.problem
    ids = torch.arange(slots, dtype=torch.int32, device=cuda).repeat_interleave(bucket.nnz_pad)
    k0 = torch.full((slots,), 3, dtype=torch.int32, device=cuda)
    single = torch.zeros(slots, dtype=torch.bool, device=cuda)
    alive0 = p.colidx != 0
    return p, (ids, k0, single, alive0, torch.zeros_like(alive0),
               torch.zeros(alive0.shape, dtype=torch.int32, device=cuda))


def test_walked_prefix_trip_graph_equals_the_eager_loop_on_delaunay14(cuda):
    """One Delaunay member on 8 slots: the trip graph walks the first slot's
    lanes alone, and its state and counters equal the eager loop's over all
    8 slots, each support pass launched and counted by the host; its
    support claims lie within the bounds of the masks the loop handed over."""
    from repro_torch.exec import build_peel, make_problem_support
    from repro_torch.exec import peel as pm
    from repro_torch.obs import MetricsRegistry, use_registry
    from repro_torch.obs import names

    g = _delaunay(14)
    bucket = bucket_for(g, chunk=64)
    p, args = _wide_inputs(cuda, [g], bucket)
    support = make_problem_support(backend="pallas", mode="owner", window=bucket.window, chunk=64)
    peel, reg = build_peel(support), MetricsRegistry()
    with use_registry(reg):
        got = peel(p, *args)
    from repro_torch.kernels.support_fine import claim_bounds

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    given, bounds = [], []

    def counted(prob, alive):
        given.append(int(alive.sum()))
        bounds.append(claim_bounds(prob, alive, sms))
        return support(prob, alive)

    before = support_fine_cuda.launches
    want = _eager_trip_loop(counted, p, *args)
    trips = int(want.total_iters)
    assert support_fine_cuda.launches - before == trips == len(given) > 1
    for name, a, b in zip(pm.PeelState._fields, got, want):
        assert torch.equal(a, b), name
    counters = reg.snapshot()["counters"]
    assert counters[names.PEEL_TRIPS] == counters[names.PEEL_SUPPORT_PASSES] == trips
    assert counters[names.PEEL_SUPPORT_LANES] == sum(given) > 0
    assert counters[names.PEEL_TRIP_LANES_WALKED] == trips * bucket.nnz_pad
    # The eager loop walks all 8 slots, the graph the first: the same lists.
    lo, hi = (sum(b) for b in zip(*bounds))
    assert 0 < lo <= counters[names.PEEL_SUPPORT_CLAIMS] <= hi
    assert peel.host_syncs == 2


def test_walked_prefix_captures_at_most_four_trip_graphs(cuda):
    """Dispatches of 1, 2, 3 and 8 members on 8 slots walk 1, 2, 4 and 8
    slots: four trip graphs, none more on a second pass, each answer the
    eager loop's."""
    from repro_torch.analysis.sentinel import count_compiles
    from repro_torch.exec import PeelExecutor

    from repro_torch.api.cache import Bucket

    gs = [make() for make in GRAPHS]
    bucket = Bucket(*(max(col) for col in zip(*(bucket_for(g, chunk=64) for g in gs))))
    exe = PeelExecutor(mode="owner", backend="pallas", window=bucket.window, chunk=64)
    for rep in range(2):
        with count_compiles() as log:
            for members in (1, 2, 3, 8):
                p, args = _wide_inputs(cuda, [gs[i % len(gs)] for i in range(members)], bucket)
                ids, k0, single = args[:3]
                got = exe.peel(p, slot_ids=ids, k0=k0.cpu().numpy(),
                               single_level=single.cpu().numpy())
                want = _eager_trip_loop(exe.support, p, *args)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), members
        assert log.captures == (4 if rep == 0 else 0)


def _numpy_trussness(g):
    from repro_torch.core import trussness_numpy

    return trussness_numpy(g).astype(np.int32)


def test_two_replica_fleet_on_the_card(cuda, tmp_path):
    """Two replica processes, each with its own CUDA context on the one
    card, answer like an in-process session on the CPU."""
    from repro_torch.api import TrussQuery, solve
    from repro_torch.serve import Fleet, FleetClient

    g = tg.rmat(9, 8, seed=4)
    qs = [TrussQuery.decompose(g), TrussQuery.kmax(g), TrussQuery.ktruss(g, k=4)]
    want = solve(list(qs), device="cpu", max_batch=4)
    warm = [{"kind": "rmat", "scale": 9, "edge_factor": 8, "seed": 4}]
    with Fleet(2, workdir=str(tmp_path / "fleet"), device="cuda", max_batch=4,
               warmup=warm, warmup_all=True) as fleet:
        got = FleetClient(fleet).solve(list(qs))
        for name in fleet.router.replica_names:
            rep = fleet.router.last_health(name)
            assert rep.warmup_queries == 1 and rep.retries == 0
    assert np.array_equal(got[0].trussness, want[0].trussness)
    assert got[1] == want[1]
    assert np.array_equal(got[2].alive, want[2].alive)
