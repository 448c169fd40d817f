"""Port parity, support layer: every support formulation of the port, the
kernel wrapper's plain path and the window-contract oracle equal the JAX
package's on the same arrays, with exact equality (integer outputs).

The JAX side runs as its own CPU tests run it: Pallas kernels in interpret
mode, everything else on XLA's CPU backend."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as rcore
import repro.kernels.ops as rops
import repro_torch.core as tcore
import repro_torch.kernels as tk
from _torch_parity import alive_masks, assert_same, small_pairs, torch_problem
from repro.api import bucket_for
from repro.kernels.support_fine import support_fine_pallas

LARGE = 1 << 20


def _windows(rng, e, w, universe=4096, fill_frac=0.8):
    """CSR-realistic windows: strictly ascending unique valid prefix."""
    vals = np.full((e, w), LARGE, np.int32)
    ok = np.zeros((e, w), bool)
    for i in range(e):
        d = rng.integers(0, w + 1)
        vals[i, :d] = np.sort(rng.choice(np.arange(1, universe), size=d, replace=False))
        ok[i, :d] = rng.random(d) < fill_frac
    return vals, ok


@functools.lru_cache(maxsize=None)
def _problems(chunk=64):
    """(reference problem, port problem on the same arrays, window) per graph."""
    out = []
    for gr, _ in small_pairs():
        pr = rcore.prepare_fine(gr, chunk=chunk)
        out.append((gr.name, pr, torch_problem(pr), bucket_for(gr, chunk=chunk).window))
    return tuple(out)


def _jit(fn, **static):
    """The reference function compiled once for all masks of one graph."""
    return jax.jit(functools.partial(fn, **static))


@pytest.mark.parametrize("schedule", ["compare", "bsearch"])
@pytest.mark.parametrize("e,w", [(128, 128), (256, 256)])
def test_support_tiles_ref_matches_pallas_kernel(schedule, e, w):
    rng = np.random.default_rng(e * w)
    a, a_ok = _windows(rng, e, w, universe=3 * w)
    b, b_ok = _windows(rng, e, w, universe=3 * w)
    want = support_fine_pallas(
        *(jnp.asarray(x) for x in (a, a_ok, b, b_ok)),
        tile=128, schedule=schedule, interpret=True,
    )
    got = tk.support_tiles_ref(*(torch.from_numpy(x) for x in (a, a_ok, b, b_ok)))
    assert_same(want, got, schedule)


def test_sorted_window_member_matches_reference():
    rng = np.random.default_rng(3)
    b, _ = _windows(rng, 64, 32, universe=80)
    q = rng.integers(0, 90, size=(64, 40)).astype(np.int32)
    rm, rp = rcore.sorted_window_member(jnp.asarray(q), jnp.asarray(b))
    tm, tp = tcore.sorted_window_member(torch.from_numpy(q), torch.from_numpy(b))
    assert_same(rm, tm, "member")
    m = np.asarray(rm)
    assert np.array_equal(np.asarray(rp)[m], tp.numpy()[m])  # pos is defined where member


def test_ops_support_fine_plain_path_matches_pallas_and_owner():
    for name, pr, pt, w in _problems():
        pallas = _jit(rops.support_fine, window=w, chunk=64, tile=64, interpret=True)
        owner_fn = _jit(rcore.support_fine_owner, window=w, chunk=64)
        for i, alive in enumerate(alive_masks(pr, seed=11)):
            ja, ta = jnp.asarray(alive), torch.from_numpy(alive)
            want = pallas(pr, ja)
            owner = owner_fn(pr, ja)
            got = tk.support_fine(pt, ta, window=w, chunk=64)
            assert_same(want, got, f"{name} mask {i} vs pallas")
            assert_same(owner, got, f"{name} mask {i} vs owner")


@pytest.mark.parametrize("fn", ["support_fine_eager", "support_fine_owner"])
def test_fine_formulations_match_reference(fn):
    for name, pr, pt, w in _problems():
        ref = _jit(getattr(rcore, fn), window=w, chunk=64)
        for i, alive in enumerate(alive_masks(pr, seed=12, count=3)):
            want = ref(pr, jnp.asarray(alive))
            got = getattr(tcore, fn)(pt, torch.from_numpy(alive), window=w, chunk=64)
            assert_same(want, got, f"{fn} {name} mask {i}")


def test_coarse_formulation_matches_reference():
    for name, pr, pt, w in _problems():
        ref = _jit(rcore.support_coarse_eager, window=w)
        for i, alive in enumerate(alive_masks(pr, seed=13)):
            want = ref(pr, jnp.asarray(alive))
            got = tcore.support_coarse_eager(pt, torch.from_numpy(alive), window=w)
            assert_same(want, got, f"coarse {name} mask {i}")


def test_supports_match_numpy_oracle_on_aligned_pack():
    """The port's formulations on a slot-aligned pack (pad lanes between
    rows) equal the numpy oracle per member."""
    import repro_torch.graphs as tg

    pairs = small_pairs()
    pp = tg.pack_problems(
        [g for _, g in pairs], slot_n=128, slot_nnz=1024, slots=4, chunk=64,
        layout="aligned", device="cpu",
    )
    w = max(bucket_for(g, chunk=64).window for g, _ in pairs)
    alive = pp.problem.colidx != 0
    for s in (
        tk.support_fine(pp.problem, alive, window=w, chunk=64),
        tcore.support_fine_eager(pp.problem, alive, window=w, chunk=64),
        tcore.support_coarse_eager(pp.problem, alive, window=w),
    ):
        for (_, gt), (a, b) in zip(pairs, pp.edge_ranges):
            assert np.array_equal(s[a:b].numpy(), tcore.support_numpy(gt)), gt.name
        assert not s[3 * 1024 :].any()


def test_wrapper_refuses_what_the_kernel_cannot_take():
    _, _, pt, w = _problems()[0]
    alive = pt.colidx != 0
    with pytest.raises(ValueError, match="chunk"):
        tk.support_fine(pt, alive, window=w, chunk=48)
    with pytest.raises(ValueError, match="CUDA"):
        tk.support_fine_cuda(pt, alive)
