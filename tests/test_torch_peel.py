"""Port parity, executor layer: ``PeelExecutor`` on a packed batch gives the
JAX package's per-slot state — trussness, kmax, levels, iters, total_iters,
edges_alive and the rest — bit for bit, for every support configuration,
with single-level slots and frozen lanes.  The unfused peel's per-slot sums
are held to ``index_add_``, and its trip loop to the reference's
``build_peel`` in both layouts, under caps and in lock step."""

import functools

import numpy as np
import pytest
import torch

import repro.exec as rexec
import repro.graphs as rg
import repro_torch.exec as texec
import repro_torch.exec.peel as tpeel
from _torch_parity import assert_same, small_pairs, torch_problem
from repro.api import bucket_for
from repro.errors import DeviceError as RefDeviceError
from repro_torch.errors import DeviceError

SLOTS, SLOT_N, SLOT_NNZ, CHUNK = 4, 128, 1024, 64
CONFIGS = [
    dict(granularity="fine", mode="eager", backend="xla"),
    dict(granularity="fine", mode="owner", backend="xla"),
    dict(granularity="fine", mode="owner", backend="pallas"),
    dict(granularity="coarse", mode="eager", backend="xla"),
]


def _batch(coarse=False):
    # The coarse formulation pads every row to W x W; rmat7's W = 128 would
    # make it the slowest test here, so its batch leaves rmat7 out.
    graphs = [g for g, _ in small_pairs()][: 2 if coarse else 3]
    pp = rg.pack_problems(
        graphs, slot_n=SLOT_N, slot_nnz=SLOT_NNZ, slots=SLOTS, chunk=CHUNK, layout="aligned"
    )
    window = max(bucket_for(g, chunk=CHUNK).window for g in graphs)
    slot_ids = np.repeat(np.arange(SLOTS, dtype=np.int32), SLOT_NNZ)
    return graphs, pp, window, slot_ids


def _peel_both(cfg, args, *, max_iters=None, **inputs):
    """Run both executors on the same arrays; inputs are numpy."""
    import jax.numpy as jnp

    _, pp, window, slot_ids = _batch(cfg["granularity"] == "coarse")
    # The reference's pallas backend runs its kernel in interpret mode here.
    rex = rexec.PeelExecutor(window=window, chunk=CHUNK, max_iters=max_iters, **cfg)
    tex = texec.PeelExecutor(window=window, chunk=CHUNK, max_iters=max_iters, **cfg)
    ref = rex.peel(
        pp.problem, slot_ids=slot_ids, **args,
        **{k: jnp.asarray(v) for k, v in inputs.items()},
    )
    got = tex.peel(
        torch_problem(pp.problem), slot_ids=slot_ids, **args,
        **{k: torch.from_numpy(v) for k, v in inputs.items()},
    )
    return ref, got, tex


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: "/".join(c.values()))
def test_peel_state_matches_reference_per_slot(cfg):
    args = dict(k0=[3, 4, 3, 3], single_level=[False, True, False, False])
    ref, got, tex = _peel_both(cfg, args)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    # One dispatch; the first condition, the loop's exit and the
    # executor's belt, however many trips.
    assert tex.dispatches == 1 and int(got.total_iters) > 1
    assert tex.host_syncs == LIVE_SHARD_SYNCS + 1


@pytest.mark.parametrize("row_chunk", [8, 32])
def test_coarse_executor_takes_row_chunk_like_reference(row_chunk):
    """``row_chunk`` goes through ``PeelExecutor`` to the coarse support in
    the reference's position, and the peel answers as the reference's."""
    cfg = dict(CONFIGS[3], row_chunk=row_chunk)
    args = dict(k0=[3, 4, 3, 3], single_level=[False, True, False, False])
    ref, got, tex = _peel_both(cfg, args)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    assert tex.support.keywords["row_chunk"] == row_chunk
    assert texec.PeelExecutor(granularity="coarse", window=8, row_chunk=row_chunk).support


def test_init_peel_state_takes_the_reference_positional_order():
    """``(p, slot_ids, k0, single_level, alive0, frozen, frozen_truss)``,
    the same arguments in the same places, give the reference's state."""
    import jax.numpy as jnp
    import repro.exec.peel as rpeel

    _, pp, _, slot_ids = _batch()
    real = np.asarray(pp.problem.colidx) != 0
    rng = np.random.default_rng(5)
    frozen = real & (rng.random(real.shape[0]) < 0.2)
    ftruss = np.where(frozen, rng.integers(2, 6, real.shape[0]), 0).astype(np.int32)
    args = (slot_ids, np.array([3, 4, 3, 3], np.int32), np.array([False, True, False, False]),
            real & ~frozen, frozen, ftruss)
    ref = rpeel.init_peel_state(pp.problem, *(jnp.asarray(a) for a in args))
    got = tpeel.init_peel_state(torch_problem(pp.problem), *(torch.from_numpy(a) for a in args))
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)


def test_frozen_lanes_match_reference():
    """The masked sub-problem the streaming layer peels: a random frontier
    is free, everything else frozen at its known trussness."""
    _, pp, _, _ = _batch()
    full, _, _ = _peel_both(CONFIGS[0], dict(k0=[3] * SLOTS))
    truss = np.asarray(full.trussness)
    real = np.asarray(pp.problem.colidx) != 0
    rng = np.random.default_rng(21)
    frontier = real & (rng.random(real.shape[0]) < 0.3)
    frozen = real & ~frontier
    for c in (CONFIGS[0], CONFIGS[2]):
        ref, got, _ = _peel_both(
            c, dict(k0=[3] * SLOTS),
            alive0=frontier, frozen=frozen, frozen_truss=np.where(frozen, truss, 0).astype(np.int32),
        )
        for f in ref._fields:
            assert_same(getattr(ref, f), getattr(got, f), f)
        # Re-peeling a frontier against the exact frozen rest is a no-op.
        assert np.array_equal(got.trussness.numpy()[real], truss[real])


def test_iteration_cap_raises_device_error_like_reference():
    _, pp, window, slot_ids = _batch()
    kw = dict(window=window, chunk=CHUNK, max_iters=2)
    with pytest.raises(RefDeviceError, match="iteration cap"):
        rexec.PeelExecutor(**kw).peel(pp.problem, slot_ids=slot_ids, k0=[3] * SLOTS)
    with pytest.raises(DeviceError, match="iteration cap"):
        texec.PeelExecutor(**kw).peel(
            torch_problem(pp.problem), slot_ids=slot_ids, k0=[3] * SLOTS
        )


def test_empty_batch_is_done_without_trips():
    cfg = CONFIGS[2]
    _, pp, window, slot_ids = _batch()
    tex = texec.PeelExecutor(window=window, chunk=CHUNK, **cfg)
    p = torch_problem(pp.problem)
    st = tex.peel(p, slot_ids=slot_ids, k0=[3] * SLOTS, alive0=torch.zeros(p.nnz_pad, dtype=torch.bool))
    assert int(st.total_iters) == 0 and bool(st.done.all())


# --------------------------------------------------------------------- #
# The unfused peel's per-slot sums and trip loop
# --------------------------------------------------------------------- #
# A live shard's readbacks: the first condition (with the layout), then
# the loop's exit, whatever its trips; the card's graph reads back alike.
LIVE_SHARD_SYNCS = 2


def _contig_ids(edge_ranges, nnzp):
    """The planner's contig slot ids: members prefix-packed, the pad tail
    parked on slot 0."""
    ids = np.zeros(nnzp, np.int32)
    for i, (a, b) in enumerate(edge_ranges):
        ids[a:b] = i
    return ids


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("layout", ["aligned", "contig", "shuffled"])
def test_slot_sums_match_index_add(layout, seed):
    rng = np.random.default_rng(seed)
    slots, per = 6, 64
    if layout == "aligned":
        ids = np.repeat(np.arange(slots, dtype=np.int32), per)
    elif layout == "contig":
        # Members of random sizes (one empty) from the front, then the tail.
        sizes = rng.integers(1, per, slots)
        sizes[seed % slots] = 0
        ends = np.cumsum(sizes)
        ids = _contig_ids(list(zip(ends - sizes, ends)), slots * per)
    else:
        ids = rng.integers(0, slots, slots * per).astype(np.int32)
    t_ids = torch.from_numpy(ids)
    assert bool(tpeel._is_aligned(t_ids, slots)) == (layout == "aligned")
    for keep in (0.0, 0.5, 1.0):
        # Random over every lane, the contig tail included.
        x = torch.from_numpy(rng.random(ids.shape[0]) < keep)
        want = torch.zeros(slots, dtype=torch.int32).index_add_(0, t_ids.long(), x.int())
        # The sorted path serves any ids, the aligned ones included.
        for aligned in {layout == "aligned", False}:
            got = tpeel._SlotSums(t_ids, slots, aligned=aligned)(x)
            assert got.dtype == torch.int32 and torch.equal(got, want), (aligned, keep)


def _layout_batch(layout):
    """Three small graphs packed into SLOTS slots in ``layout``, the slot ids
    the planner gives that layout, and the bucket's window."""
    graphs = [g for g, _ in small_pairs()]
    pp = rg.pack_problems(
        graphs, slot_n=SLOT_N, slot_nnz=SLOT_NNZ, slots=SLOTS, chunk=CHUNK, layout=layout
    )
    nnzp = int(pp.problem.nnz_pad)
    if layout == "aligned":
        slot_ids = np.repeat(np.arange(SLOTS, dtype=np.int32), SLOT_NNZ)
    else:
        slot_ids = _contig_ids(pp.edge_ranges, nnzp)
    window = max(bucket_for(g, chunk=CHUNK).window for g in graphs)
    return pp, slot_ids, window


def _layout_args(layout, frozen):
    """Numpy peel arguments on ``_layout_batch``: decompose, ktruss(4) and
    kmax slots and an empty one; with ``frozen``, a seeded frontier is free
    and every other real lane frozen at its trussness."""
    pp, slot_ids, window = _layout_batch(layout)
    real = np.asarray(pp.problem.colidx) != 0
    k0 = np.array([3, 4, 3, 3], np.int32)
    single = np.array([False, True, False, False])
    nnzp = real.shape[0]
    if not frozen:
        return slot_ids, k0, single, real, np.zeros(nnzp, bool), np.zeros(nnzp, np.int32)
    truss = np.asarray(_ref_peel(layout, False).trussness)
    frontier = real & (np.random.default_rng(5).random(nnzp) < 0.3)
    fr = real & ~frontier
    return slot_ids, np.full(SLOTS, 3, np.int32), single, frontier, fr, np.where(fr, truss, 0).astype(np.int32)


def _support_cfg(window):
    return dict(granularity="fine", mode="owner", backend="xla", window=window, chunk=CHUNK)


@functools.lru_cache(maxsize=None)
def _ref_peel(layout, frozen, max_iters=None):
    """The reference's ``build_peel`` state on ``_layout_args`` (cached:
    several tests hold the port to it)."""
    import jax.numpy as jnp

    pp, _, window = _layout_batch(layout)
    args = _layout_args(layout, frozen)
    peel = rexec.build_peel(rexec.make_problem_support(**_support_cfg(window)), max_iters=max_iters)
    return peel(pp.problem, *(jnp.asarray(a) for a in args))


def _port_peel(layout, frozen, max_iters=None):
    pp, _, window = _layout_batch(layout)
    args = [torch.from_numpy(a) for a in _layout_args(layout, frozen)]
    peel = texec.build_peel(texec.make_problem_support(**_support_cfg(window)), max_iters=max_iters)
    return peel(torch_problem(pp.problem), *args), peel


@pytest.mark.parametrize("frozen", [False, True], ids=["free", "frozen"])
@pytest.mark.parametrize("layout", ["aligned", "contig"])
def test_build_peel_matches_reference_per_field(layout, frozen):
    ref = _ref_peel(layout, frozen)
    got, peel = _port_peel(layout, frozen)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    trips = int(got.total_iters)
    assert bool(got.done.all()) and trips > 0
    # The first condition (with the layout), then the loop's exit.
    assert peel.host_syncs == LIVE_SHARD_SYNCS
    # Not vacuous: the ktruss(4) slot retired early, the empty one at once.
    iters = got.iters.tolist()
    assert iters[3] == 0 < iters[1] < max(iters)


@pytest.mark.parametrize("layout", ["aligned", "contig"])
@pytest.mark.parametrize("cap", [1, 5, 6])
def test_capped_peel_matches_reference(layout, cap):
    """A cap that fires in the first level or mid-peel stops at exactly
    the reference's truncated state: the loop's condition holds the cap."""
    ref = _ref_peel(layout, False, cap)
    got, peel = _port_peel(layout, False, cap)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    assert int(got.total_iters) == cap and not bool(got.done.all())
    assert peel.host_syncs == LIVE_SHARD_SYNCS
    pp, slot_ids, window = _layout_batch(layout)
    with pytest.raises(DeviceError, match="iteration cap"):
        texec.PeelExecutor(max_iters=cap, **_support_cfg(window)).peel(
            torch_problem(pp.problem), slot_ids=slot_ids, k0=[3] * SLOTS
        )


def test_lock_step_shards_of_unequal_trips():
    """Two shards (aligned and contig packs of different batches) in lock
    step: each equals the reference's peel of its own inputs, takes trips
    only while unfinished, and reads back twice whatever its trips."""
    layouts = ("aligned", "contig")
    frozen = (False, True)
    calls = {}
    shards = []
    for layout, fz in zip(layouts, frozen):
        pp, _, window = _layout_batch(layout)
        p = torch_problem(pp.problem)
        shards.append((p, *(torch.from_numpy(a) for a in _layout_args(layout, fz))))
    plain = texec.make_problem_support(**_support_cfg(window))

    def spy(prob, alive):
        calls[id(prob)] = calls.get(id(prob), 0) + 1
        return plain(prob, alive)

    peel = texec.build_peel(spy)
    states = peel.lock_step(shards, limit=10_000)
    trips = [int(s.total_iters) for s in states]
    assert trips[0] != trips[1], trips
    for layout, fz, st in zip(layouts, frozen, states):
        ref = _ref_peel(layout, fz)
        for f in ref._fields:
            assert_same(getattr(ref, f), getattr(st, f), (layout, f))
    assert [calls[id(sh[0])] for sh in shards] == trips
    assert peel.host_syncs == LIVE_SHARD_SYNCS * len(shards)


def test_lock_step_reads_an_empty_shard_once():
    """A shard with no alive lane takes no trip and one readback (its
    first condition) beside a live one, whose state is the reference's."""
    pp, _, window = _layout_batch("aligned")
    live = (torch_problem(pp.problem), *(torch.from_numpy(a) for a in _layout_args("aligned", False)))
    empty = list(live)
    empty[4] = torch.zeros_like(live[4])  # alive0
    peel = texec.build_peel(texec.make_problem_support(**_support_cfg(window)))
    got, idle = peel.lock_step([live, tuple(empty)], limit=10_000)
    ref = _ref_peel("aligned", False)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    assert int(idle.total_iters) == 0 and bool(idle.done.all())
    assert peel.host_syncs == LIVE_SHARD_SYNCS + 1


def test_trip_loop_that_stops_early_is_a_typed_device_fault(monkeypatch):
    """The loop's exit is checked where it is read back: a loop that ends
    with a slot unfinished below the cap (a graph that did not run its
    trips) raises the graph's typed fault, never the iteration cap's."""
    monkeypatch.setattr(tpeel._EagerTrips, "run", lambda self: None)
    with pytest.raises(DeviceError, match="stopped after 0 of") as e:
        _port_peel("aligned", False)
    assert e.value.site == "peel_graph"


# --------------------------------------------------------------------- #
# An aligned shard's trips walk only its live slot prefix
# --------------------------------------------------------------------- #
WIDE = 8  # the planner's max_batch: a one-query dispatch has seven empty slots


def _wide_pack(members: int, layout: str = "aligned"):
    """``members`` of the small graphs, in turn, packed on WIDE slots."""
    graphs = [g for g, _ in small_pairs()]
    graphs = [graphs[i % len(graphs)] for i in range(members)]
    pp = rg.pack_problems(
        graphs, slot_n=SLOT_N, slot_nnz=SLOT_NNZ, slots=WIDE, chunk=CHUNK, layout=layout
    )
    window = max(bucket_for(g, chunk=CHUNK).window for g in graphs)
    return pp, window


@functools.lru_cache(maxsize=None)
def _wide_ref_peel(window, max_iters=None):
    """One reference peel a window and cap: every case shares its shapes."""
    return rexec.build_peel(rexec.make_problem_support(**_support_cfg(window)), max_iters=max_iters)


@functools.lru_cache(maxsize=None)
def _wide_truss(members):
    """Each lane's trussness in a decompose of ``members`` (the reference's)."""
    import jax.numpy as jnp

    pp, window = _wide_pack(members)
    real = np.asarray(pp.problem.colidx) != 0
    none = np.zeros(real.shape[0], bool)
    args = (np.repeat(np.arange(WIDE, dtype=np.int32), SLOT_NNZ), np.full(WIDE, 3, np.int32),
            np.zeros(WIDE, bool), real, none, np.zeros(real.shape[0], np.int32))
    return np.asarray(_wide_ref_peel(window)(pp.problem, *(jnp.asarray(a) for a in args)).trussness)


# name: (members, k0 of the members, single_level of the members, lanes of
# these slots not alive, lanes of these slots frozen only, walked slots)
WIDE_CASES = {
    "one_member": (1, [3], [False], (), (), 1),
    "three_members": (3, [3, 4, 3], [False, False, False], (), (), 4),
    "eight_members": (8, [3] * 8, [False] * 8, (), (), 8),
    "slot_1_empty": (3, [3, 3, 3], [False] * 3, (1,), (), 4),
    # A frontier free in slots 0 and 2, the rest frozen; slots 1, 3 (inside
    # the walked prefix) and 4 (past it) frozen only.
    "frozen": (5, [3] * 5, [False] * 5, (), (1, 3, 4), 4),
    "single_level": (2, [3, 4], [False, True], (), (), 2),
}


def _wide_args(name):
    """Numpy peel arguments of a WIDE_CASES case, with its pack and window."""
    members, k0, single, dead, frozen_only, _ = WIDE_CASES[name]
    pp, window = _wide_pack(members)
    real = np.asarray(pp.problem.colidx) != 0
    slot = np.repeat(np.arange(WIDE, dtype=np.int32), SLOT_NNZ)
    alive0 = real & ~np.isin(slot, dead)
    frozen = np.zeros(real.shape[0], bool)
    truss = np.zeros(real.shape[0], np.int32)
    if frozen_only:
        frontier = real & (np.random.default_rng(7).random(real.shape[0]) < 0.3)
        frozen = real & (~frontier | np.isin(slot, frozen_only))
        alive0 = real & ~frozen
        truss = np.where(frozen, _wide_truss(members), 0).astype(np.int32)
    pad = WIDE - members
    k0 = np.array(k0 + [3] * pad, np.int32)
    single = np.array(single + [False] * pad)
    return pp, window, (slot, k0, single, alive0, frozen, truss)


def _port_wide(pp, window, args, *, max_iters=None, walk_all=False):
    """The port's ``build_peel`` state, the peel, and what it filed; with
    ``walk_all`` the trips walk every slot (the untrimmed loop)."""
    from repro_torch.obs import MetricsRegistry, use_registry

    peel = texec.build_peel(texec.make_problem_support(**_support_cfg(window)), max_iters=max_iters)
    reg = MetricsRegistry()
    with pytest.MonkeyPatch.context() as m, use_registry(reg):
        if walk_all:
            m.setattr(tpeel, "_walked_slots", lambda live, num_slots, p: num_slots)
        st = peel(torch_problem(pp.problem), *(torch.from_numpy(a) for a in args))
    return st, peel, reg.snapshot()["counters"]


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_walked_prefix_peel_equals_the_reference_and_the_whole_loop(name):
    """The trips walk the live slots rounded up to a power of two, and
    every ``PeelState`` field equals the reference's ``build_peel`` and the
    same loop over all WIDE slots; two readbacks, as before."""
    import jax.numpy as jnp

    pp, window, args = _wide_args(name)
    walked = WIDE_CASES[name][-1]
    ref = _wide_ref_peel(window)(pp.problem, *(jnp.asarray(a) for a in args))
    got, peel, counters = _port_wide(pp, window, args)
    whole, _, whole_counters = _port_wide(pp, window, args, walk_all=True)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
        assert torch.equal(getattr(whole, f), getattr(got, f)), f
    trips = int(got.total_iters)
    assert bool(got.done.all()) and trips > 1
    assert peel.host_syncs == LIVE_SHARD_SYNCS
    assert counters[tpeel.PEEL_TRIPS] == trips
    assert counters[tpeel.PEEL_TRIP_LANES_WALKED] == trips * walked * SLOT_NNZ
    assert whole_counters[tpeel.PEEL_TRIP_LANES_WALKED] == trips * WIDE * SLOT_NNZ
    # The same work: the support passes were given the same lanes.
    assert counters[tpeel.PEEL_SUPPORT_LANES] == whole_counters[tpeel.PEEL_SUPPORT_LANES] > 0
    assert got.alive.shape == (WIDE * SLOT_NNZ,) and got.done.shape == (WIDE,)


@pytest.mark.parametrize("cap", [1, 2])
def test_walked_prefix_capped_peel_stops_like_the_reference_and_raises(cap):
    """A cap that fires mid-peel on the one-member prefix stops at the
    reference's truncated state, and the executor still raises."""
    import jax.numpy as jnp

    pp, window, args = _wide_args("one_member")
    ref = _wide_ref_peel(window, cap)(pp.problem, *(jnp.asarray(a) for a in args))
    got, _, counters = _port_wide(pp, window, args, max_iters=cap)
    whole, _, _ = _port_wide(pp, window, args, max_iters=cap, walk_all=True)
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
        assert torch.equal(getattr(whole, f), getattr(got, f)), f
    assert int(got.total_iters) == cap and not bool(got.done.all())
    assert counters[tpeel.PEEL_TRIP_LANES_WALKED] == cap * SLOT_NNZ
    slot_ids, k0 = args[0], args[1]
    with pytest.raises(DeviceError, match="iteration cap"):
        texec.PeelExecutor(max_iters=cap, **_support_cfg(window)).peel(
            torch_problem(pp.problem), slot_ids=slot_ids, k0=k0
        )


def test_contig_layout_walks_every_lane():
    """The contig layout parks its pad tail on slot 0: not the aligned
    layout, so its trips walk the whole pack, one member or eight."""
    pp, window = _wide_pack(1, layout="contig")
    nnzp = int(pp.problem.nnz_pad)
    real = np.asarray(pp.problem.colidx) != 0
    args = (_contig_ids(pp.edge_ranges, nnzp), np.full(WIDE, 3, np.int32), np.zeros(WIDE, bool),
            real, np.zeros(nnzp, bool), np.zeros(nnzp, np.int32))
    assert not bool(tpeel._is_aligned(torch.from_numpy(args[0]), WIDE))
    got, peel, counters = _port_wide(pp, window, args)
    trips = int(got.total_iters)
    assert trips > 1 and bool(got.done.all())
    assert counters[tpeel.PEEL_TRIP_LANES_WALKED] == trips * nnzp
    assert peel.host_syncs == LIVE_SHARD_SYNCS


@pytest.mark.parametrize(
    "live, walked", [(0, 8), (1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (7, 8), (8, 8)]
)
def test_walked_slots_round_the_live_prefix_up_to_a_power_of_two(live, walked):
    pp, _ = _wide_pack(1)
    p = torch_problem(pp.problem)
    assert tpeel._walked_slots(live, WIDE, p) == walked
    alive = torch.zeros(p.nnz_pad, dtype=torch.bool)
    if live:
        alive[(live - 1) * SLOT_NNZ + 3] = True
    assert int(tpeel._live_slots(alive, WIDE)) == live


def test_lock_step_walks_each_shards_own_prefix(monkeypatch):
    """Two aligned shards in lock step, one member and three: each walks its
    own live prefix (1 and 4 slots), equals the loop over all its slots
    field for field, and reads back twice."""
    from repro_torch.obs import MetricsRegistry, use_registry

    shards = []
    for name in ("one_member", "three_members"):
        pp, window, args = _wide_args(name)
        shards.append((torch_problem(pp.problem), *(torch.from_numpy(a) for a in args)))
    support = texec.make_problem_support(**_support_cfg(window))
    peel, reg = texec.build_peel(support), MetricsRegistry()
    with use_registry(reg):
        states = peel.lock_step(shards, limit=10_000)
    monkeypatch.setattr(tpeel, "_walked_slots", lambda live, num_slots, p: num_slots)
    wholes = texec.build_peel(support).lock_step(shards, limit=10_000)
    trips = [int(st.total_iters) for st in states]
    assert trips[0] != trips[1]
    for st, whole in zip(states, wholes):
        for f, a, b in zip(tpeel.PeelState._fields, st, whole):
            assert torch.equal(a, b), f
    counters = reg.snapshot()["counters"]
    assert counters[tpeel.PEEL_TRIP_LANES_WALKED] == (trips[0] * 1 + trips[1] * 4) * SLOT_NNZ
    assert peel.host_syncs == LIVE_SHARD_SYNCS * len(shards)
