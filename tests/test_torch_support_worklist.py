"""The support kernel's work decomposition and the unfused peel's done-slot
skip, on the CPU.

``support_fine_cuda`` lists the alive real lanes, walks the shorter of
each lane's two rows, and splits a lane whose shorter row exceeds
``SPLIT_ROW`` into ``SPLIT_WAYS`` chunks.  The kernel runs only on the card
(``tests/test_torch_kernels_gpu.py``); here its plain twin
``support_fine_items``, which computes the support by the same items, is
held to ``support_fine_owner`` and to the JAX package (its Pallas kernel
in interpret mode), exactly.  ``build_peel`` hands the support function
only the lanes of slots that are not done; every ``PeelState`` field stays
the reference's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rcore
import repro.exec as rexec
import repro.graphs as rg
import repro.kernels.ops as rops
import repro_torch.exec as texec
from _torch_parity import alive_masks, assert_same, small_pairs, torch_problem
from repro.api import bucket_for
from repro_torch.core import support_fine_owner
from repro_torch.kernels.peel_fused import SPLIT_ROW, SPLIT_WAYS
from repro_torch.kernels.support_fine import (
    _batch_chunks,
    _batch_claim_bounds,
    _item_chunks,
    claim_bounds,
    support_fine_items,
    worklist,
    worklist_elements,
)

CHUNK = 64


def _star_clique(n=300, clique=SPLIT_ROW + 4):
    """A hub joined to every other vertex; the first ``clique`` of those also
    form a clique, so every clique lane's shorter row exceeds SPLIT_ROW."""
    star = [(0, v) for v in range(1, n)]
    kk = [(i, j) for i in range(1, clique + 1) for j in range(i + 1, clique + 1)]
    return rg.from_edges(n, np.array(star + kk, dtype=np.int64), name="star-clique")


@functools.lru_cache(maxsize=None)
def _case(name):
    """(reference problem, port problem, window, masks) of one graph."""
    if name == "star_clique":
        g = _star_clique()
        pr = rcore.prepare_fine(g, chunk=CHUNK)
        real = np.asarray(pr.colidx) != 0
        rng = np.random.default_rng(31)
        # Sparse masks keep the probes few; rows stay whole, so lanes split.
        masks = [real & (rng.random(real.shape[0]) < keep) for keep in (0.05, 0.2)]
    else:
        g = dict(zip(("erdos", "clustered", "rmat"), (r for r, _ in small_pairs())))[name]
        pr = rcore.prepare_fine(g, chunk=CHUNK)
        masks = alive_masks(pr, seed=41)
        masks.append(np.zeros_like(masks[0]))
    return pr, torch_problem(pr), bucket_for(g, chunk=CHUNK).window, masks


@pytest.mark.parametrize("name", ["erdos", "clustered", "rmat", "star_clique"])
def test_items_twin_matches_owner_and_reference(name):
    pr, pt, w, masks = _case(name)
    pallas = jax.jit(
        functools.partial(rops.support_fine, window=w, chunk=CHUNK, tile=CHUNK, interpret=True)
    )
    split_seen = 0
    for i, alive in enumerate(masks):
        ta = torch.from_numpy(alive)
        got = support_fine_items(pt, ta)
        assert torch.equal(got, support_fine_owner(pt, ta, window=w, chunk=CHUNK)), (name, i)
        assert_same(pallas(pr, jnp.asarray(alive)), got, f"{name} mask {i} vs pallas")
        split_seen += int(worklist(pt, ta).split.numel())
    assert (split_seen > 0) == (name == "star_clique")


@pytest.mark.parametrize("name", ["rmat", "star_clique"])
def test_worklist_scratch_covers_every_mask(name):
    _, pt, _, masks = _case(name)
    nnzp, unnzp = pt.nnz_pad, int(pt.ucolidx.shape[0])
    n = worklist_elements(nnzp, unnzp)
    # The chunk cursor (two words), the two list lengths and the claims.
    assert n == {"ualive": unnzp, "list": nnzp, "counts": 5}
    real = pt.colidx != 0
    deg = pt.udeg.long()
    for ta in [torch.from_numpy(m) for m in masks] + [real, torch.ones(nnzp, dtype=torch.bool)]:
        wl = worklist(pt, ta)
        listed = torch.cat([wl.unsplit, wl.split])
        # Each alive real lane once: the list (unsplit from the front, split
        # from the back) never outgrows its nnz_pad slots.
        assert torch.equal(listed.sort().values, torch.nonzero(ta & real).flatten())
        assert listed.numel() <= n["list"]
        assert wl.items == wl.unsplit.numel() + SPLIT_WAYS * wl.split.numel() < 2**31
        short = torch.minimum(deg[pt.edge_row.long()], deg[pt.colidx.long()])
        assert bool((short[wl.split] > SPLIT_ROW).all())
        assert not bool((short[wl.unsplit] > SPLIT_ROW).any())


def _lagging_claims(n_items: int, sms: int, lag: int, seed: int) -> int:
    """The items launch's global claims in a model of its blocks: the block
    whose batch runs out next is drawn at random, reads the cursor as it
    stood up to ``lag`` claims earlier, claims ``_batch_chunks`` of what it
    read as unclaimed, and stops once it reads the list claimed or its
    claim starts past the end."""
    blocks, n_chunks = _item_chunks(n_items, sms)
    rng = np.random.default_rng(seed)
    history, live, claims = [0], list(range(blocks)), 0
    while live:
        b = live[int(rng.integers(len(live)))]
        done = history[max(0, len(history) - 1 - int(rng.integers(lag + 1)))]
        first = history[-1]
        if done < n_chunks:
            history.append(first + _batch_chunks(n_chunks - done, blocks))
            claims += 1
        if done >= n_chunks or first >= n_chunks:
            live.remove(b)
    return claims


@pytest.mark.parametrize("n_items, sms", [
    (0, 132), (1, 132), (100, 1), (5_000, 132), (1_121_068, 132), (3_363_204, 132),
    (910_269, 132), (40_000_000, 132),
])
@pytest.mark.parametrize("lag", [0, 1, 64, 2_000])
def test_claims_of_the_batch_rule_lie_within_its_bounds(n_items, sms, lag):
    """Whatever the order of the blocks' claims and however far their reads
    of the cursor lag, the claims lie within ``claim_bounds``' range of the
    items launch; with exact reads, the least terminal claims."""
    least, most = _batch_claim_bounds(n_items, sms)
    got = _lagging_claims(n_items, sms, lag, seed=n_items + lag)
    assert least <= got <= most, (least, got, most)
    if n_items == 0:
        assert (least, most) == (0, 0)
    if lag == 0:  # exact reads: no block claims past the end
        blocks, _ = _item_chunks(n_items, sms)
        assert got == most - (blocks if n_items else 0)


def test_batches_cut_a_planar_meshs_claims_by_fifty_times():
    """On the mean Delaunay trip's list (1.12 M items, 132 SMs) the items
    launch claims 3,756 times on exact reads (and at least 1,460), against
    280,267 claims of four items a warp: 528 blocks of 16 warps claim
    batches of whole 128-item chunks (a draw of eight items a warp), a
    third of the unclaimed chunks' even share at a time, shrinking as the
    list drains."""
    least, most = _batch_claim_bounds(1_121_068, 132)
    blocks, n_chunks = _item_chunks(1_121_068, 132)
    assert (blocks, n_chunks) == (528, 8_759)
    assert (least, most - blocks) == (1_460, 3_756)
    assert most - blocks < 1_121_068 / 4 / 50
    assert [_batch_chunks(left, blocks) for left in (n_chunks, 1_584, 1_585, 10**9)] == [
        6, 1, 2, 255]
    # A list too short to give each of the 8,448 warps twelve draws of eight
    # draws fewer items: 1,920 items, one a draw.
    assert _item_chunks(1_920, 132) == (528, 120)


@pytest.mark.parametrize("name", ["erdos", "star_clique"])
def test_claim_bounds_count_one_reservation_a_tile_and_half(name):
    """The worklist launch reserves once for each half of the list that
    lists a lane of an 8,192-lane tile (512 threads, 16 lanes each), and
    not at all for a tile that lists no lane of that half."""
    _, pt, _, masks = _case(name)
    tiles = -(-pt.nnz_pad // 8_192)
    assert (tiles == 1) == (name == "erdos")
    for i, m in enumerate(masks):
        ta = torch.from_numpy(m)
        wl = worklist(pt, ta)
        listed = [torch.zeros(pt.nnz_pad, dtype=torch.bool) for _ in wl]
        for flags, lanes in zip(listed, wl):
            flags[lanes] = True
        halves = sum(int(f[t * 8_192:(t + 1) * 8_192].any()) for f in listed for t in range(tiles))
        want = tuple(halves + x for x in _batch_claim_bounds(wl.items, 132))
        assert claim_bounds(pt, ta, sms=132) == want, i
    assert claim_bounds(pt, torch.zeros(pt.nnz_pad, dtype=torch.bool), sms=132) == (0, 0)


def _batch():
    """Three queries on one graph (decompose, kmax, ktruss(4)) and an empty
    fourth slot, packed aligned as the planner packs a batch."""
    g = rg.rmat(7, 5, seed=2)
    b = bucket_for(g, chunk=CHUNK)
    pp = rg.pack_problems(
        [g, g, g], slot_n=b.n_pad, slot_nnz=b.nnz_pad, slots=4, chunk=CHUNK, layout="aligned"
    )
    slot_ids = np.repeat(np.arange(4, dtype=np.int32), b.nnz_pad)
    args = dict(k0=[3, 3, 4, 3], single_level=[False, False, True, False])
    return pp.problem, b.window, slot_ids, args


def test_build_peel_never_hands_support_a_done_slots_lane():
    pr, w, slot_ids, args = _batch()
    p = torch_problem(pr)
    handed = []

    def spy(prob, alive):
        handed.append(alive.clone())
        return support_fine_owner(prob, alive, window=w, chunk=CHUNK)

    peel = texec.build_peel(spy)
    st = peel(
        p, torch.from_numpy(slot_ids), torch.tensor(args["k0"], dtype=torch.int32),
        torch.tensor(args["single_level"]), p.colidx != 0,
        torch.zeros(p.nnz_pad, dtype=torch.bool), torch.zeros(p.nnz_pad, dtype=torch.int32),
    )
    assert bool(st.done.all()) and len(handed) == int(st.total_iters)
    # A slot is live for exactly its first `iters` trips, then done for good.
    iters = st.iters.tolist()
    lanes = torch.from_numpy(slot_ids).long()
    for trip, alive in enumerate(handed):
        for s, n in enumerate(iters):
            if trip >= n:
                assert not bool(alive[lanes == s].any()), (trip, s)
    # Not vacuous: the ktruss(4) slot retired while the others peeled on,
    # and the empty slot was done from the start.
    assert iters[3] == 0 < iters[2] < min(iters[0], iters[1])


@pytest.mark.parametrize(
    "cfg",
    [
        dict(granularity="fine", mode="owner", backend="pallas"),
        dict(granularity="fine", mode="eager", backend="xla"),
    ],
    ids=lambda c: "/".join(c.values()),
)
def test_three_query_batch_matches_reference(cfg):
    pr, w, slot_ids, args = _batch()
    ref = rexec.PeelExecutor(window=w, chunk=CHUNK, **cfg).peel(pr, slot_ids=slot_ids, **args)
    got = texec.PeelExecutor(window=w, chunk=CHUNK, **cfg).peel(
        torch_problem(pr), slot_ids=slot_ids, **args
    )
    for f in ref._fields:
        assert_same(getattr(ref, f), getattr(got, f), f)
    assert int(got.total_iters) > int(got.iters[2]) > 0
