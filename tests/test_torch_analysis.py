"""The port's analysis suite (``repro_torch.analysis``): each rule fires on
a known-bad file and stays silent on its fixed twin, fingerprints do not
depend on line numbers, the port's tree is clean against its own
baseline, the CLI exits 0, and the recompile sentinel counts what
compiles in the port.

The rule fixtures are written into ``tmp_path`` (never checked in), so no
file of the repository breaks a rule on purpose."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import AnalysisConfig, Finding, apply_baseline, load_baseline, run
from repro_torch.analysis import (
    rules_faults,
    rules_locks,
    rules_metrics,
    rules_recompile,
    rules_trace,
    rules_wire,
)

REPO_ROOT = Path(__file__).resolve().parents[1]
BASELINE = REPO_ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"

R1_HOT = {
    "bad": '''
        import numpy as np
        import torch

        def peel_loop(st: torch.Tensor, limit: int):
            trips = 0
            while trips < limit:
                if bool(st.any()):
                    break
                x = st.sum().item()
                trips += int(limit)
            host = np.asarray(st)
            torch.cuda.synchronize()
            n = int(st.shape[0])
            if st.max() > 3:
                n += 1
            return host, n, x

        def plain_loop(lo: torch.Tensor):
            while bool(lo.any()):
                lo = lo - 1
            return lo

        def check(p: torch.Tensor):
            if p.dim() != 1:
                raise ValueError(f"bad {p.cpu().numpy()}")
            return p
    ''',
    "fixed": '''
        import torch

        def peel_loop(st: torch.Tensor, limit: int):
            trips = 0
            while trips < limit:
                # The loop's one counted readback a trip.
                if bool(st.any()):  # trusslint: disable=R1
                    break
                trips += int(limit)
            n = int(st.shape[0])
            return torch.where(st > 3, st, 0), n

        def plain_loop(lo: torch.Tensor):
            while bool(lo.any()):
                lo = lo - 1
            return lo

        def check(p: torch.Tensor):
            if p.dim() != 1:
                raise ValueError(f"bad {p.cpu().numpy()}")
            return p
    ''',
}
R1_DISPATCH = {
    "bad": '''
        import numpy as np

        def execute(packed, exe):
            rows = np.asarray(packed.problem.rowptr)
            n = int(packed.problem.colidx.shape[0])
            st = exe.peel(packed.problem)
            return np.asarray(st.alive), rows, n
    ''',
    "fixed": '''
        import numpy as np

        def execute(packed, exe, rows):
            n = int(packed.problem.colidx.shape[0])
            st = exe.peel(packed.problem)
            return np.asarray(st.alive), rows, n
    ''',
}
R2 = {
    "bad": '''
        class LeakyPlanner:
            def __init__(self, mesh, chunk, mode):
                self.mesh, self.chunk, self.mode = mesh, chunk, mode
                self._mesh_key = None if mesh is None else tuple(mesh.devices)

            def cache_variant(self, backend):
                return (backend, self.mode)

            def build_executor(self, key):
                return make(key, chunk=self.chunk, mesh=self.mesh, mode=self.mode)
    ''',
    "fixed": '''
        class LeakyPlanner:
            def __init__(self, mesh, chunk, mode):
                self.mesh, self.chunk, self.mode = mesh, chunk, mode
                self._mesh_key = None if mesh is None else tuple(mesh.devices)

            def cache_variant(self, backend):
                return (backend, self.mode, self._mesh_key, self.chunk)

            def build_executor(self, key):
                return make(key, chunk=self.chunk, mesh=self.mesh, mode=self.mode)
    ''',
}
R3 = {
    "bad": '''
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []  # guarded-by: _lock

            def bad_unlocked(self):
                return len(self._items)

            def bad_sync_under_lock(self, torch):
                with self._lock:
                    torch.cuda.synchronize()
                    self._items.append(1)
    ''',
    "fixed": '''
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []  # guarded-by: _lock

            def bad_unlocked(self):
                with self._lock:
                    return len(self._items)

            def bad_sync_under_lock(self, torch):
                torch.cuda.synchronize()
                with self._lock:
                    self._items.append(1)
    ''',
}
R4 = {
    "bad": '''
        FAULT_SITES = ("compile", "dispatch", "ghost_town")

        def drive(inject):
            inject("compile")
            inject("dispatchh")
    ''',
    "fixed": '''
        FAULT_SITES = ("compile", "dispatch")

        def drive(inject):
            inject("compile")
            inject(site="dispatch")
    ''',
}
R5_NAMES = '''
    COUNTERS = {"requests_served": "queries answered"}
    GAUGES = {"queue_depth": "pending"}
'''
R5 = {
    "bad": '''
        def work(m):
            m.inc("requests_servd")
            m.set_gauge("queue_depht", 3)
            m.inc("requests_served")
    ''',
    "fixed": '''
        def work(m):
            m.inc("requests_served")
            m.set_gauge("queue_depth", 3)
    ''',
}
R6 = {
    "bad": '''
        __all__ = ["AlphaError", "BetaError"]
        _ERROR_CONTEXT = ("slot", "phantom")
        _ERROR_CONTEXT_EXCLUDED = ()

        class AlphaError(Exception):
            def __init__(self, message: str, *, slot: int | None = None, depth: int = 0):
                super().__init__(message)
                self.slot, self.depth = slot, depth

        class BetaError(Exception):
            def __init__(self, message: str, code):
                super().__init__(message)
                self.code = code
    ''',
    "fixed": '''
        __all__ = ["AlphaError", "BetaError"]
        _ERROR_CONTEXT = ("slot", "depth")
        _ERROR_CONTEXT_EXCLUDED = ("code",)

        class AlphaError(Exception):
            def __init__(self, message: str, *, slot: int | None = None, depth: int = 0):
                super().__init__(message)
                self.slot, self.depth = slot, depth

        class BetaError(Exception):
            def __init__(self, message: str, code: int = 0):
                super().__init__(message)
                self.code = code
    ''',
}


def _write(tmp_path, name, source):
    path = tmp_path / name
    path.write_text(textwrap.dedent(source))
    return path


def _config(tmp_path, files, **over):
    base = dict(
        root=tmp_path,
        files=files,
        trace_files=[],
        dispatch_files=[],
        recompile_files=[],
        lock_files=[],
        faults_file="",
        test_files=[],
        names_file="",
        metric_ref_files=[],
        wire_file="",
        errors_file="",
    )
    base.update(over)
    return AnalysisConfig(**base)


def _summaries(found):
    return sorted((f.rule, f.scope, f.message.split(" (")[0]) for f in found)


@pytest.mark.parametrize("variant", ["bad", "fixed"])
def test_r1_host_syncs(tmp_path, variant):
    hot = _write(tmp_path, "hot.py", R1_HOT[variant])
    disp = _write(tmp_path, "disp.py", R1_DISPATCH[variant])
    cfg = _config(
        tmp_path, [hot, disp], trace_files=["hot.py"], dispatch_files=["disp.py"],
        off_path_scopes={"hot.py::plain_loop": "a plain version's loop"},
    )
    found = run(cfg, rules=[rules_trace])
    want = [
        ("R1", "execute", "np.asarray() reads a packed tensor back to the host before dispatch"),
        ("R1", "peel_loop", ".item() reads a tensor back to the host"),
        ("R1", "peel_loop", "Python `if` on a tensor"),
        ("R1", "peel_loop", "bool() of a tensor reads it back to the host"),
        ("R1", "peel_loop", "np.asarray() of a tensor reads it back to the host"),
        ("R1", "peel_loop", "torch.cuda.synchronize() blocks the host on the device"),
    ]
    assert _summaries(found) == (sorted(want) if variant == "bad" else [])


@pytest.mark.parametrize("variant", ["bad", "fixed"])
def test_r2_recompile_hazard(tmp_path, variant):
    path = _write(tmp_path, "planner.py", R2[variant])
    found = run(_config(tmp_path, [path], recompile_files=["planner.py"]), rules=[rules_recompile])
    leaked = sorted(f.message.split("self.")[1].split(" ")[0] for f in found)
    assert leaked == (["chunk", "mesh"] if variant == "bad" else [])
    assert all(f.scope == "LeakyPlanner.build_executor" for f in found)


@pytest.mark.parametrize("variant", ["bad", "fixed"])
def test_r3_lock_discipline(tmp_path, variant):
    path = _write(tmp_path, "box.py", R3[variant])
    found = run(_config(tmp_path, [path], lock_files=["box.py"]), rules=[rules_locks])
    want = [
        ("R3", "Box.bad_sync_under_lock", "blocking call synchronize() while holding _lock"),
        ("R3", "Box.bad_unlocked", "self._items is guarded-by _lock but accessed without it"),
    ]
    assert _summaries(found) == (want if variant == "bad" else [])


@pytest.mark.parametrize("variant", ["bad", "fixed"])
def test_r4_fault_sites(tmp_path, variant):
    path = _write(tmp_path, "faults.py", R4[variant])
    cfg = _config(tmp_path, [path], faults_file="faults.py", test_files=["faults.py"])
    messages = sorted(f.message for f in run(cfg, rules=[rules_faults]))
    if variant == "fixed":
        assert messages == []
        return
    assert len(messages) == 3, messages
    assert sum("'dispatchh' is not declared" in m for m in messages) == 1
    assert sum("'dispatch' is declared but no test" in m for m in messages) == 1
    assert sum("'ghost_town' is declared but no test" in m for m in messages) == 1


@pytest.mark.parametrize("variant", ["bad", "fixed"])
def test_r5_metric_names(tmp_path, variant):
    names = _write(tmp_path, "names.py", R5_NAMES)
    path = _write(tmp_path, "work.py", R5[variant])
    cfg = _config(tmp_path, [names, path], names_file="names.py", metric_ref_files=["work.py"])
    found = run(cfg, rules=[rules_metrics])
    assert sorted(f.message.split("'")[1] for f in found) == (
        ["queue_depht", "requests_servd"] if variant == "bad" else []
    )
    assert all("repro_torch.obs.names" in f.message for f in found)


@pytest.mark.parametrize("variant", ["bad", "fixed"])
def test_r6_wire_schema(tmp_path, variant):
    path = _write(tmp_path, "wire.py", R6[variant])
    cfg = _config(tmp_path, [path], wire_file="wire.py", errors_file="wire.py")
    messages = sorted(f.message for f in run(cfg, rules=[rules_wire]))
    if variant == "fixed":
        assert messages == []
        return
    assert len(messages) == 3, messages
    assert sum("'phantom' matches no parameter" in m for m in messages) == 1
    assert sum("'depth' is neither" in m for m in messages) == 1
    assert sum("BetaError is not constructible" in m for m in messages) == 1


def test_fingerprints_do_not_depend_on_line_numbers(tmp_path):
    def findings(source):
        hot = _write(tmp_path, "hot.py", source)
        return run(_config(tmp_path, [hot], trace_files=["hot.py"]), rules=[rules_trace])

    before = findings(R1_HOT["bad"])
    after = findings('"""A docstring that moves every line."""\n\n\n' + textwrap.dedent(R1_HOT["bad"]))
    assert [f.line + 3 for f in before] == [f.line for f in after]
    assert [f.fingerprint for f in before] == [f.fingerprint for f in after]
    a = Finding("R1", "p.py", 10, "f", "msg", "snippet x")
    assert a.fingerprint == Finding("R1", "p.py", 99, "f", "msg", "snippet x").fingerprint
    assert a.fingerprint != Finding("R1", "p.py", 10, "f", "msg", "snippet x", occurrence=1).fingerprint


# --------------------------------------------------------------------- #
# The port's tree
# --------------------------------------------------------------------- #
def test_port_tree_is_clean_against_its_baseline():
    cfg = AnalysisConfig.default(REPO_ROOT)
    rels = {p.relative_to(REPO_ROOT).as_posix() for p in cfg.files}
    assert "chip_smoke.py" in rels and "tests/test_torch_analysis.py" in rels
    assert not any(r.startswith("src/repro/") for r in rels)
    new, _old, stale = apply_baseline(run(cfg), load_baseline(BASELINE))
    assert not new, [f.to_dict() for f in new]
    assert not stale, sorted(stale)


@pytest.mark.parametrize(
    "const",
    ["PEEL_LEVEL_DEVICE_SECONDS", "PEEL_LEVEL_LANES_COUNTED", "PEEL_LEVEL_LANES_WALKED",
     "PEEL_LEVEL_TRIPS", "PEEL_LEVEL_TRIPS_CARRIED", "PEEL_LEVEL_TRIPS_INCREMENTAL"],
)
def test_fused_level_counters_are_declared_and_r5_finds_no_drift(const):
    """Each counter of the fused level loop is a constant of
    ``repro_torch.obs.names`` (exported, its value a declared counter); the
    peel files it by that constant, either in the loop's table of level
    counts (beside a slot of ``LevelCounts``) or by a ``registry.inc`` of
    its own; and R5 over the port's files finds nothing."""
    from repro_torch.exec.peel import _FILED_LEVEL_COUNTS
    from repro_torch.kernels.peel_fused import LevelCounts
    from repro_torch.obs import names

    assert const in names.__all__
    assert getattr(names, const) in names.COUNTERS
    peel = (REPO_ROOT / "src" / "repro_torch" / "exec" / "peel.py").read_text()
    tabled = {name: slot for slot, name in _FILED_LEVEL_COUNTS}
    slot = tabled.get(getattr(names, const))
    if slot is not None:
        assert slot in LevelCounts._fields
        assert f'("{slot}", {const})' in peel
    else:
        assert f"registry.inc({const}," in peel
    assert run(AnalysisConfig.default(REPO_ROOT), rules=[rules_metrics]) == []


def test_counted_readbacks_are_the_only_suppressed_syncs():
    """R1 sees every readback of the hot path; the suppressed ones are the
    counted readbacks of the peel loops, the belt, the shard check."""
    from repro_torch.analysis.engine import AnalysisContext

    cfg = AnalysisConfig.default(REPO_ROOT)
    ctx = AnalysisContext(cfg)
    suppressed = [
        f for f in rules_trace.check(ctx) if ctx.files[f.path].is_suppressed("R1", f.line)
    ]
    assert sorted((f.path.split("/")[-1], f.scope) for f in suppressed) == [
        ("ktruss.py", "shard_peel_args"),
        ("peel.py", "PeelExecutor.peel"),
        ("peel.py", "_FusedPeel.__call__"),
        ("peel.py", "_Peel.lock_step"),
        ("peel.py", "_Peel.lock_step"),
    ]


def test_cli_reports_and_exits_zero(tmp_path):
    report = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--report", str(report)],
        cwd=REPO_ROOT,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["tool"] == "repro_torch.analysis"
    assert data["counts"] == {"new": 0, "baselined": 1, "stale_baseline": 0}
    assert data["files_scanned"] > 60


def test_engine_imports_only_the_standard_library():
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, repro_torch.analysis, repro_torch.analysis.engine as e\n"
         "from repro_torch.analysis import rules_trace, rules_recompile, rules_locks, "
         "rules_faults, rules_metrics, rules_wire\n"
         "e.run(e.AnalysisConfig.default('.'))\n"
         "assert not {'torch', 'numpy', 'jax'} & set(sys.modules), sorted(sys.modules)"],
        cwd=REPO_ROOT,
        env={"PYTHONPATH": str(REPO_ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


# --------------------------------------------------------------------- #
# The recompile sentinel (the runtime half of R2)
# --------------------------------------------------------------------- #
def test_sentinel_counts_cold_executor_build_and_warm_silence():
    import repro_torch.api as ta
    from repro_torch.analysis.sentinel import assert_no_compiles, count_compiles
    from repro_torch.graphs import erdos

    s = ta.Session(device="cpu", max_batch=2, chunk=64)
    qs = [ta.TrussQuery.decompose(erdos(40, 5.0, seed=0)), ta.TrussQuery.kmax(erdos(40, 5.0, seed=0))]
    with count_compiles() as log:
        want = s.solve(qs)
    # No nvcc on the CPU, and no trip graph: the CPU runs its trips eagerly.
    assert (log.executor_builds, log.kernel_builds, log.captures) == (1, 0, 0)
    with assert_no_compiles("warm solve") as warm:
        got = s.solve(qs)
    assert warm.compiles == 0 and warm.captures == 0 and got[1] == want[1]
    with pytest.raises(AssertionError, match="warm .sic.: 0 kernel build.s. and 1 executor"):
        with assert_no_compiles("warm (sic)"):
            s.solve([ta.TrussQuery.kmax(erdos(200, 5.0, seed=1))])  # a new bucket


def test_sentinel_counts_trip_graph_captures():
    """A capture of the unfused peel's trip graph (an event only the card
    raises) counts as a compile: a warm path that captures fails."""
    from repro_torch.analysis.sentinel import assert_no_compiles, count_compiles
    from repro_torch.obs.events import PEEL_CAPTURE, record_event

    with count_compiles() as log:
        record_event(PEEL_CAPTURE, device="cuda:0", seconds=0.005)
    assert (log.captures, log.executor_builds, log.kernel_builds) == (1, 0, 0)
    with pytest.raises(AssertionError, match="1 trip-graph capture"):
        with assert_no_compiles("warm"):
            record_event(PEEL_CAPTURE, device="cuda:0", seconds=0.005)
