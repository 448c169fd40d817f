"""Port parity, the examples: each twin in ``repro_torch.examples`` against
the JAX package on the CPU, on the same seeds, exactly (every compared
value is an integer, a mask, a name or a count).

* ``declarative_queries``, ``quickstart``, ``tracing`` and
  ``streaming_updates`` run their ``main(device="cpu")`` at the example's
  own arguments (the quickstart's coarse passes are most of this file's
  run time); the JAX package's engine combinations agree with one another
  (its own tests hold each to the numpy oracle), so one reference engine,
  ``fine/eager/xla``, is the oracle for every combination;
* ``ktruss_scaling`` runs its ``sweep`` on smaller graphs of the example's
  four families: at the example's size the reference's coarse passes take
  about ten seconds each here.  The sizing is for run time only.

Also: ``main()`` with no device raises the no-CUDA error, the command
line says so too, and the package imports neither ``jax`` nor ``repro``.
"""

import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.core as rcore
import repro.graphs as rg
import repro.obs as robs
import repro.service as rsv
import repro.stream as rs
from _torch_parity import assert_same
from repro_torch.api import Session
from repro_torch.examples import (
    declarative_queries,
    ktruss_scaling,
    quickstart,
    streaming_updates,
    tracing,
)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("declarative_queries", "quickstart", "ktruss_scaling", "tracing", "streaming_updates")


def _same_answer(r, t):
    """One reference answer against the port's, exactly."""
    if isinstance(r, int):
        assert t == r
    elif isinstance(r, ra.KTrussResult):
        assert (t.k, t.iterations, t.edges_remaining) == (r.k, r.iterations, r.edges_remaining)
        assert np.array_equal(r.alive, t.alive) and np.array_equal(r.support, t.support)
    else:
        assert (t.kmax, t.levels) == (r.kmax, r.levels)
        assert np.array_equal(r.trussness, t.trussness)


def _reference_example(name):
    """The reference example's module, loaded from ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- #
# declarative_queries
# --------------------------------------------------------------------- #
def test_declarative_queries_matches_reference(capsys):
    got = declarative_queries.main(device="cpu")
    out = capsys.readouterr().out.splitlines()

    g = rg.rmat(8, 5, seed=7)
    dec = ra.solve(ra.TrussQuery.decompose(g), chunk=64, max_batch=1)
    s = ra.Session(kernel="xla", max_batch=4, chunk=64)
    results = s.solve(
        [
            ra.TrussQuery.ktruss(rg.erdos(100, 6.0, seed=0), k=4),
            ra.TrussQuery.kmax(rg.erdos(100, 6.0, seed=1)),
            ra.TrussQuery.decompose(rg.road(8, 0.1, seed=0)),
            ra.TrussQuery.kmax(rg.rmat(6, 4, seed=2)),
        ]
    )
    st = s.stats()
    _same_answer(dec, got["one_shot"])
    assert len(got["results"]) == len(results)
    for r, t in zip(results, got["results"]):
        _same_answer(r, t)
    assert got["dispatches"] == st["device_dispatches"]
    assert got["planner_backends"] == st["planner_backends"]
    assert out[0] == f"{g.name}: kmax={dec.kmax} levels={dec.levels}"
    assert out[1] == f"ktruss(4) edges: {results[0].edges_remaining}"


# --------------------------------------------------------------------- #
# quickstart
# --------------------------------------------------------------------- #
def test_quickstart_matches_reference(capsys):
    got = quickstart.main(device="cpu")
    out = capsys.readouterr().out.splitlines()

    g = rg.rmat(10, 6, seed=7)
    st = rg.imbalance_stats(g)
    ref = rcore.KTrussEngine(g, granularity="fine", mode="eager", backend="xla").ktruss(4)
    assert list(got["ktruss4"]) == [
        "coarse/eager/xla", "fine/eager/xla", "fine/owner/xla", "fine/owner/pallas"
    ]
    for res in got["ktruss4"].values():
        _same_answer(ref, res)
    assert (got["n"], got["nnz"], got["max_degree"]) == (g.n, g.nnz, g.max_degree())
    assert (got["coarse_imbalance"], got["fine_imbalance"]) == (
        st.coarse_imbalance, st.fine_imbalance
    )
    assert out[0] == f"graph: {g.name}  |V|={g.n} |E|={g.nnz} max_deg={g.max_degree()}"
    assert out[1].startswith(f"coarse-task imbalance {st.coarse_imbalance:.0f}x vs fine ")
    assert out[-1].startswith("all decompositions agree")


# --------------------------------------------------------------------- #
# ktruss_scaling (smaller graphs of the example's four families)
# --------------------------------------------------------------------- #
def test_ktruss_scaling_sweep_matches_reference():
    def families(gen):
        return [
            gen.road(12, 0.08, seed=1),
            gen.erdos(300, 8.0, seed=2),
            gen.barabasi(300, 4, seed=3),
            gen.rmat(7, 6, seed=4),
        ]

    settings = ktruss_scaling.SETTINGS + (("fine", "owner", "pallas"),)
    rows = ktruss_scaling.sweep(
        families(ktruss_scaling), settings, device="cpu", reps=1
    )
    for g, row in zip(families(rg), rows):
        st = rg.imbalance_stats(g)
        assert (row.graph, row.n, row.nnz, row.max_degree) == (g.name, g.n, g.nnz, g.max_degree())
        assert row.pred == g.max_degree() / max(g.nnz / g.n, 1e-9)
        assert row.coarse_imbalance == st.coarse_imbalance
        ref = rcore.KTrussEngine(g, granularity="fine", mode="eager", backend="xla").ktruss(4)
        assert sorted(row.ktruss) == sorted("/".join(s) for s in settings)
        for tag, res in row.ktruss.items():
            _same_answer(ref, res)
            assert row.ms[tag] > 0


# --------------------------------------------------------------------- #
# tracing
# --------------------------------------------------------------------- #
def test_tracing_matches_reference(tmp_path, capsys):
    got = tracing.main(device="cpu", trace=str(tmp_path / "port.json"))
    out = capsys.readouterr().out.splitlines()

    s = ra.Session(kernel="xla", max_batch=4, chunk=64, trace=str(tmp_path / "ref.json"))
    results = s.solve(
        [
            ra.TrussQuery.decompose(rg.rmat(6, 6, seed=0)),
            ra.TrussQuery.decompose(rg.barabasi(120, 4, seed=1)),
            ra.TrussQuery.decompose(rg.road(8, 0.1, seed=2)),
            ra.TrussQuery.kmax(rg.rmat(6, 6, seed=3)),
        ]
    )
    for r, t in zip(results, got["results"]):
        _same_answer(r, t)
    snap = s.metrics_snapshot()
    for key in ("requests_served", "batches_run", "dispatches", "cache_compiles"):
        assert got["counters"][key] == snap["counters"].get(key, 0)
    occ = snap["histograms"]["batch_occupancy"]
    assert got["batch_occupancy"] == {"mean": occ["mean"], "count": occ["count"]}

    def untimed(rows):
        return [{k: v for k, v in r.items() if not k.startswith("device_time_s")} for r in rows]

    assert untimed(got["imbalance"]) == untimed(robs.imbalance_summary(s.obs.metrics))
    events = s.obs.tracer.events()
    assert got["events"] == len(events)
    assert got["span_names"] == sorted({e["name"] for e in events})
    assert out[0] == f"wrote {tmp_path / 'port.json'} ({len(events)} events)"


def test_traced_solve_splits_solve_into_its_spans():
    s = Session(kernel="xla", max_batch=4, chunk=64, trace=True, device="cpu")
    first = tracing.traced_solve(s, tracing.example_queries())
    _, events, ms = tracing.traced_solve(s, tracing.example_queries())
    assert len(events) == len(first[1])  # the second read holds the second solve alone
    assert set(ms) == set(tracing.SPANS) | {"outside"}
    assert ms["outside"] == pytest.approx(
        ms["solve"] - sum(ms[n] for n in tracing.SOLVE_CHILDREN)
    )
    assert 0 <= ms["outside"] <= ms["solve"]
    assert ms["peel-level"] == 0.0  # no fused backend in this session
    with pytest.raises(ValueError, match="needs a tracing session"):
        tracing.traced_solve(Session(max_batch=2, device="cpu"), tracing.example_queries())


# --------------------------------------------------------------------- #
# streaming_updates
# --------------------------------------------------------------------- #
def test_streaming_updates_matches_reference(capsys):
    got = streaming_updates.main(device="cpu")
    capsys.readouterr()

    ref = _reference_example("streaming_updates")
    rng = np.random.default_rng(0)
    g = rg.clustered(4, 16, 0.6, seed=3)
    svc = rsv.TrussService(max_batch=2, chunk=64)
    sess = svc.open_stream(g)
    assert got["opened"] == {"edges": g.nnz, "kmax": sess.kmax}
    assert len(got["steps"]) == 8
    for step in got["steps"]:
        want = sess.update(ref.random_batch(rng, sess.graph, n_ins=2, n_del=1))
        assert isinstance(want, rs.StreamUpdateResult)
        for field in ("kmax", "frontier_size", "frontier_frac", "num_inserts", "num_deletes",
                      "dispatches", "num_edges"):
            assert getattr(step, field) == getattr(want, field), field
        assert_same(want.trussness, torch.from_numpy(step.trussness))
    assert got["session"] == sess.stats()
    want_svc = {k: v for k, v in svc.stats().items() if k not in streaming_updates.TIMED_STATS}
    assert got["service"] == want_svc


# --------------------------------------------------------------------- #
# The card by default, and the import boundary
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_a_device_needs_cuda(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        mod.main()


def test_command_line_needs_cuda_and_imports_neither_jax_nor_the_reference():
    """In a fresh interpreter with no card: importing every twin loads no
    ``jax`` and no ``repro``, and the command line exits with the no-CUDA
    error."""
    code = (
        "import runpy, sys\n"
        + "".join(f"import repro_torch.examples.{name}\n" for name in EXAMPLES)
        + "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('CLEAN', flush=True)\n"
        "sys.argv = ['declarative_queries']\n"
        "runpy.run_module('repro_torch.examples.declarative_queries', run_name='__main__')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, wherever the tests run
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert "CLEAN" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
