"""Port parity, fused peel: the one-launch-per-level path against the JAX
package's fused path.

The plain fused level (``fused_level_torch``, what CPU tensors run), the
fused executor and ``solve(backend="fine/fused/aligned")`` must give the
reference's state on every field, ``total_iters`` included (exact: integer
state, tolerance 0).  Against the port's unfused executor every field but
``total_iters`` agrees.  The JAX side runs ``make_fused_level`` in interpret
mode, as ``tests/test_fused.py`` does.  Also: tiling validation, the
autotune store and its cross-process replay, and the auto rule that picks
the fused backend.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as ra
import repro.exec.peel as rpeel
import repro.graphs as rg
import repro_torch.api as ta
import repro_torch.exec.peel as tpeel
from _torch_parity import assert_same, torch_graph, torch_problem
from repro.configs.ktruss import BENCH_GRAPHS, LARGE_GRAPHS
from repro.core import trussness_numpy
from repro.graphs.stats import imbalance_stats as ref_imbalance_stats
from repro.kernels import autotune as rtune
from repro.kernels.peel_fused import make_fused_level as ref_make_fused_level
from repro_torch.errors import InvalidGraphError
from repro_torch.graphs.pack import validate_fused_tiling
from repro_torch.graphs.stats import imbalance_stats
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import AutotuneStore, FusedConfig, candidate_configs
from repro_torch.kernels.peel_fused import fused_level_torch, make_fused_level
from repro_torch.obs import Observability

CHUNK = 64


def _pack(graphs):
    """The reference's aligned pack of ``graphs`` (one slot each) and the
    port's copy of it."""
    buckets = [ra.bucket_for(g, chunk=CHUNK) for g in graphs]
    nnz_pad = max(b.nnz_pad for b in buckets)
    pp = rg.pack_problems(
        graphs,
        slot_n=max(b.n_pad for b in buckets),
        slot_nnz=nnz_pad,
        slots=len(graphs),
        chunk=CHUNK,
        layout="aligned",
    )
    slot_ids = np.repeat(np.arange(len(graphs), dtype=np.int32), nnz_pad)
    return pp, torch_problem(pp.problem), slot_ids, max(b.window for b in buckets)


def _mixed():
    return _pack([rg.rmat(5, 6, seed=1), rg.barabasi(30, 3, seed=0)])


def _frozen_inputs():
    """rmat(5, 6, seed=3) with its even lanes frozen at the oracle's trussness."""
    g = rg.rmat(5, 6, seed=3)
    oracle = trussness_numpy(g)
    pp, p, slot_ids, window = _pack([g])
    real = np.asarray(pp.problem.colidx) != 0
    frozen = real & (np.arange(real.shape[0]) % 2 == 0)
    frozen_truss = np.zeros(real.shape[0], np.int32)
    frozen_truss[: oracle.shape[0]] = np.where(frozen[: oracle.shape[0]], oracle, 0)
    return pp, p, slot_ids, window, real & ~frozen, frozen, frozen_truss, oracle


def _assert_states(ref, got, fields=rpeel.PeelState._fields):
    for f in fields:
        assert_same(getattr(ref, f), getattr(got, f), f)


def _levels_both(pp, p, slot_ids, window, block, schedule, k0, single, alive0, frozen, ftruss):
    """Step both level functions side by side from the same initial state,
    comparing every field after every level; returns the levels stepped."""
    ref_step = ref_make_fused_level(window=window, block=block, schedule=schedule, interpret=True)
    args = [jnp.asarray(x) for x in (slot_ids, k0, single, alive0, frozen, ftruss)]
    rst = rpeel.init_peel_state(pp.problem, *args)
    tk0, tsingle, talive0, tfrozen, tftruss = (torch.from_numpy(x) for x in (k0, single, alive0, frozen, ftruss))
    tst = tpeel.init_peel_state(p, torch.from_numpy(slot_ids), tk0, tsingle, talive0, tfrozen, tftruss)
    _assert_states(rst, tst)
    levels = 0
    while not bool(np.asarray(rst.done).all()):
        rst = ref_step(pp.problem, rst, args[4], args[5], args[2])
        tst = fused_level_torch(p, tst, tfrozen, tftruss, tsingle, window=window, block=block)
        _assert_states(rst, tst)
        levels += 1
    assert bool(tst.done.all())
    return levels


# --------------------------------------------------------------------- #
# (a), (b) the plain fused level against the reference's, level by level
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("schedule", ["compare", "bsearch"])
@pytest.mark.parametrize("single", [False, True], ids=["peel", "single_level"])
def test_fused_level_torch_matches_reference_level_by_level(schedule, single):
    pp, p, slot_ids, window = _mixed()
    n = p.nnz_pad
    levels = _levels_both(
        pp, p, slot_ids, window, 32, schedule,
        k0=np.array([3, 4] if single else [3, 3], np.int32),
        single=np.array([False, single]),
        alive0=np.asarray(pp.problem.colidx) != 0,
        frozen=np.zeros(n, bool),
        ftruss=np.zeros(n, np.int32),
    )
    assert levels >= 2


def test_fused_level_torch_frozen_lanes_match_reference():
    pp, p, slot_ids, window, alive0, frozen, ftruss, _ = _frozen_inputs()
    _levels_both(
        pp, p, slot_ids, window, 32, "compare",
        k0=np.array([3], np.int32), single=np.array([False]),
        alive0=alive0, frozen=frozen, ftruss=ftruss,
    )


def test_make_fused_level_refuses_bad_configs():
    with pytest.raises(ValueError, match="schedule"):
        make_fused_level(window=32, schedule="magic")
    with pytest.raises(ValueError, match="power of two"):
        make_fused_level(window=32, block=48)
    pp, p, slot_ids, window = _mixed()
    step = make_fused_level(window=window, block=2 * p.nnz_pad)
    frozen = torch.zeros(p.nnz_pad, dtype=torch.bool)
    ftruss = torch.zeros(p.nnz_pad, dtype=torch.int32)
    st = tpeel.init_peel_state(
        p, torch.from_numpy(slot_ids), torch.tensor([3, 3], dtype=torch.int32),
        torch.zeros(2, dtype=torch.bool), p.colidx != 0, frozen, ftruss,
    )
    with pytest.raises(ValueError, match="does not divide"):
        step(p, st, frozen, ftruss, torch.zeros(2, dtype=torch.bool))


# --------------------------------------------------------------------- #
# (c) executors
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("frozen_case", [False, True], ids=["plain", "frozen"])
def test_fused_executor_matches_reference_and_unfused(frozen_case):
    if frozen_case:
        pp, p, slot_ids, window, alive0, frozen, ftruss, oracle = _frozen_inputs()
        k0 = np.array([3], np.int32)
        inputs = dict(alive0=alive0, frozen=frozen, frozen_truss=ftruss)
    else:
        pp, p, slot_ids, window = _mixed()
        k0 = np.array([3, 4], np.int32)
        inputs = dict(single_level=np.array([False, True]))
    cfg = dict(block=32, schedule="bsearch")
    ref = rpeel.PeelExecutor(
        backend="fused", window=window, chunk=CHUNK, fused_config=rtune.FusedConfig(**cfg)
    ).peel(pp.problem, slot_ids=slot_ids, k0=k0, **{k: jnp.asarray(v) for k, v in inputs.items()})
    tinputs = {k: torch.from_numpy(v) for k, v in inputs.items()}
    fused = tpeel.PeelExecutor(
        backend="fused", window=window, chunk=CHUNK, fused_config=FusedConfig(**cfg)
    )
    got = fused.peel(p, slot_ids=slot_ids, k0=k0, **tinputs)
    _assert_states(ref, got)
    unfused = tpeel.PeelExecutor(mode="owner", backend="xla", window=window, chunk=CHUNK).peel(
        p, slot_ids=slot_ids, k0=k0, **tinputs
    )
    _assert_states(unfused, got, [f for f in got._fields if f != "total_iters"])
    # One dispatch; one readback per level step plus the final check, the
    # tiling validation and the executor's belt.
    assert fused.dispatches == 1
    assert fused.host_syncs == int(got.levels.max()) + 3
    if frozen_case:
        assert np.array_equal(got.trussness.numpy()[: oracle.shape[0]], oracle)


def test_fused_executor_counts_levels_and_caps_like_reference():
    pp, p, slot_ids, window = _mixed()
    k0 = np.array([3, 3], np.int32)
    obs = Observability(trace=True)
    exe = tpeel.PeelExecutor(backend="fused", window=window, chunk=CHUNK)
    with obs.activate():
        st = exe.peel(p, slot_ids=slot_ids, k0=k0)
    steps = int(obs.metrics.value("peel_fused_levels"))
    spans = [e for e in obs.tracer.events() if e["name"] == "peel-level"]
    assert steps == len(spans) == int(st.levels.max()) >= 2
    assert exe.host_syncs == steps + 3
    kw = dict(window=window, chunk=CHUNK, max_iters=2)
    with pytest.raises(rpeel.DeviceError, match="iteration cap"):
        rpeel.PeelExecutor(backend="fused", **kw).peel(pp.problem, slot_ids=slot_ids, k0=k0)
    with pytest.raises(ta.DeviceError, match="iteration cap"):
        tpeel.PeelExecutor(backend="fused", **kw).peel(p, slot_ids=slot_ids, k0=k0)


# --------------------------------------------------------------------- #
# (d) the front door
# --------------------------------------------------------------------- #
def test_fused_solve_matches_reference_across_workloads():
    g = rg.barabasi(60, 4, seed=1)
    kw = dict(backend="fine/fused/aligned", chunk=CHUNK, max_batch=4)

    def queries(api, graph):
        return [api.TrussQuery.ktruss(graph, k=3), api.TrussQuery.kmax(graph),
                api.TrussQuery.decompose(graph), api.TrussQuery.ktruss(graph, k=5)]

    rs, ts = ra.Session(**kw), ta.Session(device="cpu", **kw)
    want = rs.solve(queries(ra, g))
    got = ts.solve(queries(ta, torch_graph(g)))
    for r, t in ((want[0], got[0]), (want[3], got[3])):
        assert (t.k, t.iterations, t.edges_remaining) == (r.k, r.iterations, r.edges_remaining)
        assert np.array_equal(t.alive, r.alive) and np.array_equal(t.support, r.support)
    assert got[1] == want[1]
    assert (got[2].kmax, got[2].levels) == (want[2].kmax, want[2].levels)
    assert np.array_equal(got[2].trussness, want[2].trussness)
    assert ts.stats()["planner_backends"] == rs.stats()["planner_backends"]
    assert ts.stats()["device_dispatches"] == 1
    with pytest.raises(KeyError):
        ta.Session(device="cpu", backend="fine/fused/contig")


# --------------------------------------------------------------------- #
# (e) tiling validation
# --------------------------------------------------------------------- #
def _two_member_pack():
    return _pack([rg.rmat(5, 6, seed=1), rg.erdos(25, 4.0, seed=0)])


def test_validate_fused_tiling_accepts_aligned_pack():
    pp, p, _, _ = _two_member_pack()
    validate_fused_tiling(p, slots=pp.slots, block=FusedConfig().clamp(pp.slot_nnz).block)


def test_validate_fused_tiling_rejects_straddling_block():
    pp, p, _, _ = _two_member_pack()
    with pytest.raises(InvalidGraphError) as ei:
        validate_fused_tiling(p, slots=pp.slots, block=2 * pp.slot_nnz)
    assert ei.value.kind == "fused_tiling" and ei.value.slot == 1


def test_validate_fused_tiling_names_spilling_slot_and_executor_refuses():
    pp, p, slot_ids, window = _two_member_pack()
    rowptr = p.rowptr.clone()
    v = int(torch.argmax((p.deg[1:] > 0).to(torch.int32))) + 1
    rowptr[v - 1] = pp.slot_nnz - 1
    bad = p._replace(rowptr=rowptr)
    with pytest.raises(InvalidGraphError) as ei:
        validate_fused_tiling(bad, slots=pp.slots, block=32)
    assert ei.value.kind == "fused_tiling" and ei.value.slot == 0
    assert f"row {v}" in str(ei.value)
    exe = tpeel.PeelExecutor(
        backend="fused", window=window, chunk=CHUNK, fused_config=FusedConfig(block=32)
    )
    with pytest.raises(InvalidGraphError):
        exe.peel(bad, slot_ids=slot_ids, k0=np.full(pp.slots, 3, np.int32))
    assert exe.dispatches == 0


# --------------------------------------------------------------------- #
# (f) autotune: configs, store, sweep, cross-process replay
# --------------------------------------------------------------------- #
def test_fused_config_validation_clamp_and_candidates():
    with pytest.raises(ValueError):
        FusedConfig(block=100)
    with pytest.raises(ValueError):
        FusedConfig(schedule="magic")
    cfg = FusedConfig(block=256, schedule="bsearch")
    assert cfg.clamp(64) == FusedConfig(block=64, schedule="bsearch")
    assert cfg.clamp(512) is cfg
    assert FusedConfig.from_signature(cfg.signature()) == cfg
    cands = candidate_configs(64)
    assert all(c.block <= 64 for c in cands)
    assert len({c.signature() for c in cands}) == len(cands) == 4
    assert {c.signature() for c in candidate_configs(1 << 20)} == {
        (b, s) for b in (32, 64, 128, 256) for s in ("compare", "bsearch")
    }


def test_autotune_store_roundtrip_and_reads_reference_store(tmp_path):
    bucket, slots = (32, 128, 32), 2
    store = AutotuneStore(tmp_path / "autotune.json")
    assert store.get(bucket, slots) is None
    winner = FusedConfig(block=32, schedule="bsearch")
    store.put(bucket, slots, winner, stats={"best_s": 0.01})
    assert AutotuneStore(store.path).get(bucket, slots) == winner
    assert AutotuneStore(store.path).get(bucket, 4) is None
    assert autotune.lookup(bucket, slots, default=FusedConfig()) == FusedConfig()
    # A store the reference wrote (with its xla_flags) loads in the port.
    ref_path = tmp_path / "ref.json"
    rtune.AutotuneStore(ref_path).put(
        bucket, slots, rtune.FusedConfig(block=64, schedule="compare", xla_flags=("--x",))
    )
    assert "xla_flags" in json.loads(ref_path.read_text())["configs"]["n32-nnz128-w32/s2"]
    assert AutotuneStore(ref_path).get(bucket, slots) == FusedConfig(block=64, schedule="compare")


def test_autotune_fused_sweeps_and_persists(tmp_path):
    g = torch_graph(rg.erdos(40, 4.0, seed=0))
    bucket = ta.bucket_for(g, chunk=CHUNK)
    store = AutotuneStore(tmp_path / "autotune.json")
    candidates = (FusedConfig(block=32, schedule="compare"), FusedConfig(block=32, schedule="bsearch"))
    winner, rows = autotune.autotune_fused(
        bucket, 1, graphs=[g], chunk=CHUNK, candidates=candidates, repeats=1,
        store=store, device="cpu",
    )
    assert winner in candidates
    assert len(rows) == 2 and all(r["best_s"] > 0 for r in rows)
    assert AutotuneStore(store.path).get(bucket, 1) == winner


_PERSIST_SCRIPT = """
import sys

import numpy as np

from repro_torch.api import Session, TrussQuery, bucket_for, enable_persistent_cache
from repro_torch.core import trussness_numpy
from repro_torch.graphs import erdos
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import FusedConfig

assert "jax" not in sys.modules and "repro" not in sys.modules
cache_dir, phase = sys.argv[1], sys.argv[2]
g = erdos(40, 4.0, seed=0)
bucket = bucket_for(g, chunk=64)
if phase == "tune":
    enable_persistent_cache(cache_dir)
    # Candidates exclude the stock default, so a replay is distinguishable
    # from a store miss.
    winner, _ = autotune.autotune_fused(
        bucket, 1, graphs=[g], chunk=64, repeats=1, device="cpu",
        candidates=(FusedConfig(block=16, schedule="compare"),
                    FusedConfig(block=16, schedule="bsearch")),
    )
    print(f"PERSIST_WINNER={winner.signature()}")
else:
    s = Session(device="cpu", backend="fine/fused/aligned", chunk=64, max_batch=1,
                cache_dir=cache_dir)
    print(f"PERSIST_WINNER={autotune.lookup(bucket, 1).signature()}")
    variant = s.planner.cache_variant(s.planner.backend, bucket, 1)
    print(f"PERSIST_VARIANT_SIG={variant[-1]}")
    dec = s.solve([TrussQuery.decompose(g)])[0]
    assert np.array_equal(dec.trussness, trussness_numpy(g))
    assert s.executor_for(g).fused_config.signature() == variant[-1]
    print("PERSIST_PARITY=ok")
"""


def _run_persist(cache_dir: str, phase: str) -> dict:
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir, "src"))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _PERSIST_SCRIPT, cache_dir, phase],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return dict(line.split("=", 1) for line in proc.stdout.splitlines() if line.startswith("PERSIST_"))


def test_autotuned_config_replays_across_processes_through_session(tmp_path):
    cache_dir = str(tmp_path / "cache")
    tuned = _run_persist(cache_dir, "tune")
    assert os.path.exists(os.path.join(cache_dir, "autotune.json"))
    replay = _run_persist(cache_dir, "replay")
    assert replay["PERSIST_WINNER"] == tuned["PERSIST_WINNER"]
    assert replay["PERSIST_WINNER"] != str(FusedConfig().signature())
    assert replay["PERSIST_VARIANT_SIG"] == tuned["PERSIST_WINNER"]
    assert replay["PERSIST_PARITY"] == "ok"


# --------------------------------------------------------------------- #
# (g) the auto rule picks the reference's backend
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("bench", LARGE_GRAPHS + BENCH_GRAPHS, ids=lambda b: b.name)
def test_auto_rule_matches_reference_on_configured_graphs(bench):
    g = bench.build()
    want = ra.choose_backend(ref_imbalance_stats(g), kernel="pallas", layout="aligned")
    got = ta.choose_backend(imbalance_stats(torch_graph(g), device="cpu"), kernel="pallas",
                            layout="aligned")
    assert str(got) == str(want)
    skewed = {"rmat-15", "ba-50k", "rmat-12", "ba-6k", "ba-12k", "er-4k", "er-12k"}
    assert (str(got) == "fine/fused/aligned") == (bench.name in skewed)


def test_session_kernel_pallas_plans_like_reference():
    skewed, mild = rg.barabasi(120, 3, seed=5), rg.erdos(120, 8.0, seed=0)
    assert ref_imbalance_stats(skewed).coarse_imbalance > 8 > ref_imbalance_stats(mild).coarse_imbalance
    kw = dict(kernel="pallas", chunk=CHUNK, max_batch=2)
    rs, ts = ra.Session(**kw), ta.Session(device="cpu", **kw)
    want = rs.solve([ra.TrussQuery.decompose(skewed), ra.TrussQuery.kmax(mild)])
    got = ts.solve([ta.TrussQuery.decompose(torch_graph(skewed)), ta.TrussQuery.kmax(torch_graph(mild))])
    assert ts.stats()["planner_backends"] == rs.stats()["planner_backends"]
    assert {r["backend"] for r in ts.stats()["planner_backends"]} == {
        "fine/fused/aligned", "fine/pallas/aligned"
    }
    assert np.array_equal(got[0].trussness, want[0].trussness) and got[1] == want[1]
