"""The fused level kernel's host-side plan, on the CPU.

``fused_level_cuda`` computes only the alive lanes of live slots from a
worklist, splits lanes with long rows into several work items, copies
a done slot's ``alive``, ``support`` and ``trussness`` from the state in
instead of recomputing them, and after a launch's first trip may take a
trip's supports from the last trip's deaths instead of counting again.
The kernel itself runs only on the card (``tests/test_torch_kernels_gpu.py``);
here: its scratch sizes, its split rule, the premise of the copy, checked
on the plain version (``fused_level_torch``, the reference's
``_level_kernel`` replayed) that the kernel is held to bit for bit, and the
update rule, as a plain model of the kernel's walk (``_update_model``) held
to a recount, also across launches (the carried deaths, frozen leavers
included); the plain version ignores a carry.  And the level-counts
vector: the kernel's slots in the Python table's order, and the plain
version's adds to each against the slot's definition.  And the level
loop's two states: each launch from the third writes into the state the
launch before last returned.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ra
import repro.exec.peel as rpeel
import repro.graphs as rg
import repro_torch.exec.peel as tpeel
import repro_torch.graphs as tg
import repro_torch.kernels.peel_fused as kpf
from _torch_parity import assert_same, torch_problem
from repro.core import trussness_numpy
from repro.kernels.peel_fused import make_fused_level as ref_make_fused_level
from repro_torch.api import bucket_for
from repro_torch.core import prepare_fine, support_fine_owner
from repro_torch.kernels.peel_fused import (
    SPLIT_ROW,
    SPLIT_WAYS,
    LevelCarry,
    LevelCounts,
    fused_level_cuda,
    fused_level_torch,
    scratch_elements,
    split_items,
)

CHUNK = 64


def _star_clique(n=400, clique=SPLIT_ROW + 4):
    """A hub joined to every other vertex; the first ``clique`` of those also
    form a clique, so every clique lane's shorter row exceeds SPLIT_ROW."""
    star = [(0, v) for v in range(1, n)]
    kk = [(i, j) for i in range(1, clique + 1) for j in range(i + 1, clique + 1)]
    return tg.from_edges(n, np.array(star + kk, dtype=np.int64), name="star-clique")


def test_scratch_elements_cover_the_worklists():
    n = scratch_elements(nnzp=4096, unnzp=8192, nrows=513, num_slots=4)
    # The undirected rows compacted at launch (an entry, a flag and a lane
    # per undirected lane, a length per row), two worklists and two death
    # lists (one each per trip parity) of up to every lane each, a sum per
    # lane for split lanes, and the per-slot counters (changed x 2, left)
    # plus a 64-bit item cursor and four list lengths per parity.
    assert n == {"ccol": 8192, "calive": 8192, "clane": 8192, "cdeg": 513, "lists": 8192,
                 "deaths": 8192, "acc": 4096, "counts": 24}


def test_split_constants_leave_no_empty_chunk():
    """A split lane's shorter row has more than SPLIT_ROW entries; cut into
    SPLIT_WAYS chunks of ceil(ds / SPLIT_WAYS), every chunk holds an entry."""
    assert 1 < SPLIT_WAYS <= 32 and SPLIT_ROW >= SPLIT_WAYS
    for ds in range(SPLIT_ROW + 1, SPLIT_ROW + 200):
        size = -(-ds // SPLIT_WAYS)
        assert (SPLIT_WAYS - 1) * size < ds


@pytest.mark.parametrize("hub", [False, True], ids=["rmat", "star_clique"])
def test_split_items_counts_long_row_pairs(hub):
    g = _star_clique() if hub else tg.rmat(7, 5, seed=2)
    p = prepare_fine(g, chunk=CHUNK, device="cpu")
    alive = p.colidx != 0
    unsplit, split = split_items(p, alive)
    # The same rule from the graph's own degrees (1-based in the problem).
    deg = np.bincount(np.concatenate([g.row_of_edge(), g.colidx]), minlength=g.n)
    short = np.minimum(deg[g.row_of_edge()], deg[g.colidx])
    assert split == int((short > SPLIT_ROW).sum())
    assert unsplit + split == g.nnz
    if hub:
        clique = SPLIT_ROW + 4
        assert split == clique * (clique - 1) // 2 + clique  # clique lanes and hub-clique lanes
    else:
        assert split == 0
    half = alive & (torch.arange(p.nnz_pad) % 2 == 0)
    assert sum(split_items(p, half)) == int(half.sum())
    if hub:
        # Rows are compacted to the alive set at launch: with the hub's own
        # lanes dead and half the clique's, no shorter row exceeds SPLIT_ROW,
        # unless the other half counts as frozen-live.
        rest = half & (p.edge_row != 1)
        assert split_items(p, rest)[1] == 0
        assert split_items(p, rest, alive & ~half)[1] > 0


def test_fused_level_cuda_refuses_cpu_tensors():
    p = prepare_fine(tg.rmat(5, 6, seed=1), chunk=CHUNK, device="cpu")
    slot_ids = torch.zeros(p.nnz_pad, dtype=torch.int32)
    frozen = torch.zeros(p.nnz_pad, dtype=torch.bool)
    st = tpeel.init_peel_state(
        p, slot_ids, torch.tensor([3], dtype=torch.int32), torch.zeros(1, dtype=torch.bool),
        p.colidx != 0, frozen, torch.zeros(p.nnz_pad, dtype=torch.int32),
    )
    before = fused_level_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused_level_cuda(p, st, frozen, st.trussness, torch.zeros(1, dtype=torch.bool),
                         block=32, schedule="bsearch")
    assert fused_level_cuda.launches == before


def _case(name):
    """(problem, slot_nnz, window, k0, single, alive0, frozen, frozen_truss)
    of a batch with a single-level slot that retires while others peel on."""
    if name == "single_beside_decompose":
        gs = [rg.rmat(5, 6, seed=1), rg.barabasi(30, 3, seed=0), rg.rmat(5, 6, seed=3)]
        k0, single = [3, 4, 3], [False, True, False]
    else:  # the same graph twice: frozen lanes in the decompose slot
        gs = [rg.rmat(5, 6, seed=3)] * 2
        k0, single = [3, 4], [False, True]
    buckets = [ra.bucket_for(g, chunk=CHUNK) for g in gs]
    nnz_pad = max(b.nnz_pad for b in buckets)
    pp = rg.pack_problems(gs, slot_n=max(b.n_pad for b in buckets), slot_nnz=nnz_pad,
                          slots=len(gs), chunk=CHUNK, layout="aligned")
    p = torch_problem(pp.problem)
    real = p.colidx != 0
    lane = torch.arange(p.nnz_pad)
    ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32)
    if name == "single_beside_decompose":  # arbitrary frozen lanes in slot 0
        frozen = real & (lane % 3 == 0) & (lane < nnz_pad)
        ftruss[frozen] = 4
    else:  # slot 0's even lanes frozen at the oracle's trussness
        oracle = torch.from_numpy(trussness_numpy(gs[0]).astype(np.int32))
        frozen = real & (lane % 2 == 0) & (lane < oracle.numel())
        ftruss[: oracle.numel()] = oracle
        ftruss = ftruss * frozen
    window = max(b.window for b in buckets)
    return p, nnz_pad, window, k0, single, real & ~frozen, frozen, ftruss


@pytest.mark.parametrize("name", ["single_beside_decompose", "frozen"])
def test_done_slot_state_is_a_fixed_point_of_the_level(name):
    """What makes the kernel's copy exact: while some slot is live, a level
    leaves every slot that is done on entry exactly as it found it (alive,
    support, trussness), though the plain version recomputes its supports."""
    p, slot_nnz, window, k0, single, alive0, frozen, ftruss = _case(name)
    slots = len(k0)
    slot_ids = torch.arange(slots, dtype=torch.int32).repeat_interleave(slot_nnz)
    single = torch.tensor(single)
    k0 = torch.tensor(k0, dtype=torch.int32)
    st = tpeel.init_peel_state(p, slot_ids, k0, single, alive0, frozen, ftruss)
    checked = 0
    while not bool(st.done.all()):
        out = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=32)
        done = st.done.repeat_interleave(slot_nnz)
        for f in ("alive", "support", "trussness"):
            assert torch.equal(getattr(out, f)[done], getattr(st, f)[done]), f
        # The support of a done slot is its alive set's own support, masked.
        if bool(done.any()):
            k_lane = st.cur_k.repeat_interleave(slot_nnz)
            s = support_fine_owner(p, st.alive | (frozen & (ftruss >= k_lane)), window=window,
                                   chunk=32)
            assert torch.equal((s * st.alive)[done], st.support[done])
            checked += 1
        st = out
    assert checked > 0


def test_all_done_level_prunes_with_zero_support_like_reference():
    """The one state the copy does not cover: with every slot done no inner
    trip runs, and the level prunes ahead with s = 0, in the reference's
    _level_kernel as in fused_level_torch (the kernel does the same)."""
    g = rg.rmat(5, 6, seed=1)
    b = ra.bucket_for(g, chunk=CHUNK)
    pp = rg.pack_problems([g], slot_n=b.n_pad, slot_nnz=b.nnz_pad, slots=1, chunk=CHUNK,
                          layout="aligned")
    p = torch_problem(pp.problem)
    n = p.nnz_pad
    slot_ids = np.zeros(n, np.int32)
    k0, single = np.array([3], np.int32), np.array([True])
    alive0 = np.asarray(pp.problem.colidx) != 0
    frozen, ftruss = np.zeros(n, bool), np.zeros(n, np.int32)
    ref_step = ref_make_fused_level(window=b.window, block=32, schedule="bsearch", interpret=True)
    args = [jnp.asarray(x) for x in (slot_ids, k0, single, alive0, frozen, ftruss)]
    rst = ref_step(pp.problem, rpeel.init_peel_state(pp.problem, *args), args[4], args[5], args[2])
    t_args = [torch.from_numpy(x) for x in (slot_ids, k0, single, alive0, frozen, ftruss)]
    tst = fused_level_torch(
        p, tpeel.init_peel_state(p, *t_args), t_args[4], t_args[5], t_args[2],
        window=b.window, block=32,
    )
    assert bool(tst.done.all()) and int(tst.support.sum()) > 0
    # A second level on the all-done state: no trip, support 0 everywhere.
    rst2 = ref_step(pp.problem, rst, args[4], args[5], args[2])
    tst2 = fused_level_torch(p, tst, torch.from_numpy(frozen), torch.from_numpy(ftruss),
                             torch.from_numpy(single), window=b.window, block=32)
    for f in rpeel.PeelState._fields:
        assert_same(getattr(rst2, f), getattr(tst2, f), f)
    assert int(tst2.support.abs().sum()) == 0 and int(tst2.total_iters) == int(tst.total_iters)


# --------------------------------------------------------------------- #
# The update from a trip's deaths (csrc/peel_fused.cu, phase (a))
# --------------------------------------------------------------------- #
def _update_model(p, s, alive, frozen_live, dying):
    """The kernel's update, entry by entry: ``s`` is a trip's support over
    ``alive | frozen_live``, ``dying`` the alive lanes its prune killed.
    Each undirected entry is absent (0), present (1: alive or frozen-live)
    or dying (2).  For each dying lane d = (x, y) and each c in both rows,
    f = (x, c) and g = (y, c) both not absent: the triangle is skipped when
    f or g is dying with a smaller lane than d (that lane owns it), and
    otherwise each of f and g that is an alive survivor loses 1.  Returns
    the supports and how many triangles held two or three dying edges."""
    nnzp = p.nnz_pad
    lane = p.u2d.long()
    real = lane < nnzp
    at = lane.clamp(max=nnzp - 1)
    flag = torch.where((alive | frozen_live)[at] & real, 1 + dying[at].long(), 0).tolist()
    lane, col = lane.tolist(), p.ucolidx.tolist()
    start = [0] + p.urowptr[:-1].tolist()  # row v starts at urowptr[v - 1]
    udeg = p.udeg.tolist()
    out, shared = s.clone(), 0
    for d in torch.nonzero(dying).flatten().tolist():
        x, y = int(p.edge_row[d]), int(p.colidx[d])
        if y == 0:
            continue
        in_y = {col[w]: w for w in range(start[y], start[y] + udeg[y])}
        for u in range(start[x], start[x] + udeg[x]):
            w = in_y.get(col[u])
            if w is None or flag[u] == 0 or flag[w] == 0:
                continue
            f, g = lane[u], lane[w]
            if (flag[u] == 2 and f < d) or (flag[w] == 2 and g < d):
                continue
            shared += flag[u] == 2 or flag[w] == 2
            for fl, e in ((flag[u], f), (flag[w], g)):
                if fl == 1 and alive[e]:
                    out[e] -= 1
    return out, shared


def _rule_graph(seed):
    return [tg.erdos(60, 12.0, seed=seed), tg.rmat(6, 8, seed=seed),
            tg.clustered(3, 16, 0.8, seed=seed)][seed % 3]


@pytest.mark.parametrize("seed", range(6))
def test_update_from_deaths_equals_a_recount(seed):
    """On random small graphs, alive sets, frozen-live lanes and death
    sets: the model's supports equal a recount over the survivors (alive
    minus dying) and the frozen-live lanes, on every survivor; frozen-live,
    dying and dead lanes keep the support they had."""
    g = _rule_graph(seed)
    p = prepare_fine(g, chunk=CHUNK, device="cpu")
    window = bucket_for(g, chunk=CHUNK).window
    gen = torch.Generator().manual_seed(seed)
    real = p.colidx != 0
    r = torch.rand(p.nnz_pad, generator=gen)
    frozen_live = real & (r < 0.15)
    alive = real & ~frozen_live & (r < 0.9)
    dying = alive & (torch.rand(p.nnz_pad, generator=gen) < 0.3)
    s = support_fine_owner(p, alive | frozen_live, window=window, chunk=CHUNK)
    got, shared = _update_model(p, s, alive, frozen_live, dying)
    survivors = alive & ~dying
    want = support_fine_owner(p, survivors | frozen_live, window=window, chunk=CHUNK)
    assert torch.equal(got[survivors], want[survivors])
    assert torch.equal(got[~survivors], s[~survivors])
    assert shared > 0 and int((got != s).sum()) > 0  # an owner was needed; supports moved


@pytest.mark.parametrize("seed", range(3))
def test_update_rule_over_a_level(seed):
    """A level's trips as the kernel chooses them: after the first, a trip
    updates from the last prune's deaths when they are at most the lanes it
    kept, and counts otherwise.  Every trip's supports equal a count, and
    some trips update."""
    g = _rule_graph(seed)
    p = prepare_fine(g, chunk=CHUNK, device="cpu")
    window = bucket_for(g, chunk=CHUNK).window
    real = p.colidx != 0
    frozen_live = real & (torch.arange(p.nnz_pad) % 7 == 0)
    alive = real & ~frozen_live
    kinds = []
    for k in (4, 6, 8):
        a = alive.clone()
        s = support_fine_owner(p, a | frozen_live, window=window, chunk=CHUNK)
        while True:
            dying = a & (s < k - 2)
            if not bool(dying.any()):
                break
            kept = a & ~dying
            want = support_fine_owner(p, kept | frozen_live, window=window, chunk=CHUNK)
            if int(dying.sum()) <= int(kept.sum()):
                s = _update_model(p, s, a, frozen_live, dying)[0]
                kinds.append("update")
            else:
                s = want
                kinds.append("count")
            assert torch.equal(s[kept], want[kept]), (k, len(kinds))
            a = kept
    assert "update" in kinds


# --------------------------------------------------------------------- #
# The carry from one launch to the next (csrc/peel_fused.cu, prune-ahead)
# --------------------------------------------------------------------- #
def _one_slot(frozen_case):
    """rmat(5, 6, seed=3) in one slot: (problem, window, state, frozen,
    frozen_truss, single), its even lanes frozen at the oracle's trussness
    when ``frozen_case``."""
    g = rg.rmat(5, 6, seed=3)
    b = ra.bucket_for(g, chunk=CHUNK)
    pp = rg.pack_problems([g], slot_n=b.n_pad, slot_nnz=b.nnz_pad, slots=1, chunk=CHUNK,
                          layout="aligned")
    p = torch_problem(pp.problem)
    real = p.colidx != 0
    ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32)
    frozen = torch.zeros(p.nnz_pad, dtype=torch.bool)
    if frozen_case:
        oracle = torch.from_numpy(trussness_numpy(g).astype(np.int32))
        frozen = real & (torch.arange(p.nnz_pad) % 2 == 0) & (torch.arange(p.nnz_pad) < oracle.numel())
        ftruss[: oracle.numel()] = oracle
        ftruss = ftruss * frozen
    single = torch.zeros(1, dtype=torch.bool)
    st = tpeel.init_peel_state(p, torch.zeros(p.nnz_pad, dtype=torch.int32),
                               torch.tensor([3], dtype=torch.int32), single, real & ~frozen,
                               frozen, ftruss)
    return p, b.window, st, frozen, ftruss, single


@pytest.mark.parametrize("frozen_case", [False, True], ids=["free", "frozen"])
def test_carried_deaths_update_to_the_next_levels_count(frozen_case):
    """Level by level on one slot: the supports a level converges on, less
    the carried deaths' triangles (the plain model of the update), equal
    the next level's first count on every lane alive at its launch.  The
    carried deaths are the lanes alive or frozen-live at the level and
    neither after its prune-ahead at the next: the pruned lanes and, with
    frozen lanes, those whose trussness is the level (frozen leavers, of
    which some level has a few).  The supports the state hands over are the
    converged ones on the lanes it keeps alive."""
    p, window, st, frozen, ftruss, single = _one_slot(frozen_case)
    leavers = carried = 0
    while not bool(st.done.all()):
        k = int(st.cur_k)
        out = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=32)
        fl_old, fl_new = frozen & (ftruss >= k), frozen & (ftruss >= int(out.cur_k))
        a = st.alive  # the level's fixed point
        while True:
            s = support_fine_owner(p, a | fl_old, window=window, chunk=32)
            if bool(((a & (s < k - 2))).sum() == 0):
                break
            a = a & (s >= k - 2)
        assert torch.equal(s[out.alive], out.support[out.alive])
        if bool(out.done.all()):
            break
        dying = (a | fl_old) & ~(out.alive | fl_new)
        carried += int(dying.sum())
        leavers += int((dying & frozen).sum())
        got = _update_model(p, s, a, fl_old, dying)[0]
        want = support_fine_owner(p, out.alive | fl_new, window=window, chunk=32)
        assert torch.equal(got[out.alive], want[out.alive]), k
        st = out
    assert carried > 0 and (leavers > 0) is frozen_case


@pytest.mark.parametrize("frozen_case", [False, True], ids=["free", "frozen"])
def test_the_plain_level_ignores_a_carry(frozen_case):
    """``fused_level_torch`` handed any carry (here every lane flagged dying)
    returns the state it returns without one, level by level; and a fused
    peel whose level steps hand such a carry on ends on the plain peel's
    state."""
    p, window, st0, frozen, ftruss, single = _one_slot(frozen_case)
    n = p.nnz_pad
    junk = LevelCarry(lanes=torch.arange(n, dtype=torch.int32),
                      flags=torch.full((n,), 2, dtype=torch.uint8),
                      length=torch.tensor([n], dtype=torch.int32))
    st, levels = st0, 0
    while not bool(st.done.all()):
        want = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=32)
        got = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=32, carry=junk)
        for f in tpeel.PeelState._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (levels, f)
        st, levels = want, levels + 1
    assert levels >= 2
    kw = dict(slot_ids=torch.zeros(n, dtype=torch.int32), k0=np.array([3], np.int32),
              single_level=np.array([False]), alive0=st0.alive, frozen=frozen,
              frozen_truss=ftruss)
    exe = tpeel.PeelExecutor(backend="fused", window=window, chunk=CHUNK)
    plain = exe.peel(p, **kw)
    inner = exe._peel.level_step

    def step(*args, carry=None, **kw):
        return inner(*args, carry=carry, **kw)[0], junk

    exe._peel.level_step = step
    handed = exe.peel(p, **kw)
    for f in tpeel.PeelState._fields:
        assert torch.equal(getattr(handed, f), getattr(plain, f)), f
    assert torch.equal(handed.trussness, st.trussness)


# --------------------------------------------------------------------- #
# The level-counts vector
# --------------------------------------------------------------------- #
def test_level_counts_slots_match_the_kernel_and_their_definitions(monkeypatch):
    """``csrc/peel_fused.cu`` declares the slots of the level-counts vector
    (``kUpdateTrips`` and on) in the order of ``LevelCounts``.  Level by
    level over a batch whose single-level slot retires with its lanes
    alive, the plain version adds to the vector it is handed: the alive
    lanes of the slots not done at entry (``alive_lanes``), each trip's
    alive lanes (``counted_lanes``), every lane (``walked_lanes``: it walks
    every slot), and 0 and 0."""
    src = Path(__file__).resolve().parents[1] / "src/repro_torch/kernels/csrc/peel_fused.cu"
    enum = re.search(r"enum\s*:\s*int\s*\{([^}]*kUpdateTrips[^}]*)\}", src.read_text())
    declared = {k: int(v) for k, v in re.findall(r"(k\w+)\s*=\s*(\d+)", enum.group(1))}
    want = ["k" + "".join(w.title() for w in f.split("_")) for f in LevelCounts._fields]
    assert sorted(declared, key=declared.get) == want
    assert sorted(declared.values()) == list(range(len(want)))

    p, slot_nnz, window, k0, single, alive0, frozen, ftruss = _case("single_beside_decompose")
    slot_ids = torch.arange(len(k0), dtype=torch.int32).repeat_interleave(slot_nnz)
    single = torch.tensor(single)
    st = tpeel.init_peel_state(p, slot_ids, torch.tensor(k0, dtype=torch.int32), single, alive0,
                               frozen, ftruss)
    trips_alive = []
    inner = kpf.support_fine_owner

    def spy(p, eff, **kw):
        trips_alive.append(int((eff & ~frozen).sum()))  # alive and frozen are disjoint
        return inner(p, eff, **kw)

    monkeypatch.setattr(kpf, "support_fine_owner", spy)
    counts = LevelCounts.zeros("cpu")
    assert counts.dtype == torch.int64
    retired_alive = False
    while not bool(st.done.all()):
        before, trips_alive[:] = counts.clone(), []
        out = fused_level_torch(p, st, frozen, ftruss, single, window=window, block=32,
                                level_counts=counts)
        done = st.done.repeat_interleave(slot_nnz)
        assert len(trips_alive) == int(out.total_iters - st.total_iters) >= 1
        assert LevelCounts(*(counts - before).tolist()) == LevelCounts(
            update_trips=0, counted_lanes=sum(trips_alive), carried=0,
            alive_lanes=int((st.alive & ~done).sum()), walked_lanes=p.nnz_pad,
        )
        retired_alive |= bool((st.alive & done).any())
        st = out
    assert retired_alive


# --------------------------------------------------------------------- #
# The level loop's two states (exec/peel.py::_FusedPeel)
# --------------------------------------------------------------------- #
def test_each_launch_writes_into_the_state_of_the_launch_before_last():
    """A level step that, as the kernel does, writes its state into the
    ``state_out`` it is handed: the first two launches of a dispatch are
    handed none, every later one the state the launch before last
    returned (never the state it peels), so a dispatch's launches write
    into two states in turns; the caller's ``alive0`` is never handed over
    nor written, and the peel ends on the plain peel's state."""
    p, slot_nnz, window, k0, single, alive0, frozen, ftruss = _case("single_beside_decompose")
    kw = dict(slot_ids=torch.arange(len(k0), dtype=torch.int32).repeat_interleave(slot_nnz),
              k0=np.array(k0, np.int32), single_level=np.array(single), alive0=alive0,
              frozen=frozen, frozen_truss=ftruss)
    kept = alive0.clone()
    exe = tpeel.PeelExecutor(backend="fused", window=window, chunk=CHUNK)
    plain = exe.peel(p, **kw)
    inner = exe._peel.level_step
    given, ins, returned = [], [], []

    def step(p, st, *args, state_out=None, **kw):
        got, carry = inner(p, st, *args, state_out=state_out, **kw)
        given.append(state_out)
        ins.append(st)
        if state_out is not None:
            for x, y in zip(state_out, got):
                x.copy_(y)
            got = state_out
        returned.append(got)
        return got, carry

    exe._peel.level_step = step
    for _ in range(2):  # a second dispatch starts afresh
        start = len(given)
        out = exe.peel(p, **kw)
        levels = len(given) - start
        assert levels >= 3 and out is returned[-1]
        assert given[start] is None and given[start + 1] is None
        for i in range(start + 2, start + levels):
            assert given[i] is returned[i - 2] and given[i] is not ins[i]
        assert not any(g is not None and g.alive is alive0 for g in given)
        for f in tpeel.PeelState._fields:
            assert torch.equal(getattr(out, f), getattr(plain, f)), f
    assert torch.equal(alive0, kept)


def test_the_plain_level_walks_every_lane_and_the_dispatch_files_it():
    """The plain version adds ``nnz_pad`` to ``walked_lanes`` a launch (it
    walks every slot); a dispatch files the total as
    ``peel_level_lanes_walked``, one ``nnz_pad`` a level."""
    from repro_torch.api import Session, TrussQuery
    from repro_torch.obs.names import PEEL_LEVEL_LANES_WALKED

    g = tg.rmat(6, 4, seed=2)
    s = Session(device="cpu", backend="fine/fused/aligned", chunk=64, max_batch=2)
    s.solve([TrussQuery.decompose(g)])
    counters = s.metrics_snapshot()["counters"]
    nnz_pad = 2 * bucket_for(g, chunk=64).nnz_pad
    levels = counters["peel_fused_levels"]
    assert levels >= 2 and counters[PEEL_LEVEL_LANES_WALKED] == levels * nnz_pad
