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
    assert n == {"ualive": unnzp, "list": nnzp, "counts": 4}
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
