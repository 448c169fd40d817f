"""Port parity, executor layer: ``PeelExecutor`` on a packed batch gives the
JAX package's per-slot state — trussness, kmax, levels, iters, total_iters,
edges_alive and the rest — bit for bit, for every support configuration,
with single-level slots and frozen lanes."""

import numpy as np
import pytest
import torch

import repro.exec as rexec
import repro.graphs as rg
import repro_torch.exec as texec
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
    # One dispatch; one readback per trip condition plus the executor's belt.
    assert tex.dispatches == 1
    assert tex.host_syncs == int(got.total_iters) + 2


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
