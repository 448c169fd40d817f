"""The harness as a whole, on the CPU at tiny sizes: what it imports, how
it finds cells, configurations, mixes and metrics by name, how it refuses
to run without a card, and that a run whose timed path is broken comes out
not correct."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from tiny import ROOT, run_cell, tiny_copy

KTBENCH = ROOT / "ktbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(KTBENCH.rglob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".")[0] for name in _imports(f)}
        assert not tops & FORBIDDEN, f"{f} imports {tops & FORBIDDEN}"


def test_reference_imports_nothing_of_the_program():
    yardstick = [KTBENCH / name for name in ("reference.py", "roofline.py", "generators.py",
                                             "updates.py", "by_file.py")]
    for path in yardstick + sorted((KTBENCH / "graph_generators").glob("*.py")):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & {"repro_torch", "repro", "jax"}, path
    code = ("import sys; sys.path.insert(0, %r); import ktbench.reference, ktbench.roofline; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro', 'jax'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_every_cell_and_metric_has_its_files():
    from ktbench.spec import load_cell, load_reader

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        moved = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in moved for m in cell.per_layer)
    for m in bench["end_to_end"]:
        assert callable(load_reader("end_to_end", m["name"]).read)
    for m in bench["per_layer"]:
        assert callable(load_reader("layer_metrics", m["name"]).read)


def test_refuses_to_run_without_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, str(KTBENCH / "run.py"), "--workload", "g500_decompose", "--seed",
         "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_refuses_when_the_jax_package_is_loaded(tmp_path):
    root = tiny_copy(tmp_path)
    rc, result, err = run_cell(root, "t_dec", prelude="import types; sys.modules['repro'] = types.ModuleType('repro')")
    assert rc != 0 and result is None
    assert "repro" in err


def test_discovers_a_new_config_cell_and_metric_added_as_files(tmp_path):
    """A config, a mix, a cell and a per-layer metric added as new files
    and entries, with no existing file of the harness edited."""
    root = tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "ktbench").rglob("*") if p.is_file()}
    kt = root / "ktbench"
    (kt / "configs" / "tiny-flat.json").write_text(json.dumps(
        {"name": "tiny-flat", "generator": "rmat", "scale": 7, "edge_factor": 6, "a": 0.25,
         "b": 0.25, "c": 0.25}))
    (kt / "traffic" / "decompose_pair.json").write_text(json.dumps(
        {"kind": "decompose", "max_batch": 2, "pool": 3, "check_sample": 4,
         "profile_requests": 1}))
    (kt / "layer_metrics" / "spans_seen.py").write_text(
        "def read(ctx):\n    return float(sum(c for _, c in ctx.spans.values())) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-flat", "source": "test", "file": "ktbench/configs/tiny-flat.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "grid_pair", "config": "tiny-flat", "traffic": "decompose_pair",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "edges_per_s":
            m["workloads"].append("grid_pair")
    bench["per_layer"].append({"name": "spans_seen", "unit": "spans", "better": "higher",
                               "source": "program_span", "layer": "api", "moves": "edges_per_s",
                               "workloads": ["grid_pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())

    rc, result, err = run_cell(root, "grid_pair", trace=0)
    assert rc == 0, err
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"edges_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    rc, result, err = run_cell(root, "grid_pair", trace=1)
    assert rc == 0, err
    assert result["correct"]
    assert set(result["metrics"]) == {"spans_seen"}
    assert result["metrics"]["spans_seen"]["value"] > 0


@pytest.mark.parametrize("cell", ["t_dec", "t_st"])
def test_tiny_cells_run_correct(tmp_path, cell):
    root = tiny_copy(tmp_path)
    for trace in (0, 1):
        rc, result, err = run_cell(root, cell, trace=trace)
        assert rc == 0, err
        assert result["correct"], err
        assert result["attempted"] > 0 and result["failed"] == 0
        assert all(v["limit"] == 0 and v["value"] == 0 for v in result["checks"].values())
        assert "check mismatched_edges 0 limit 0" in err


# Faults planted under the timed path: each run must come out not correct.
ALTERED = """
import dataclasses
import numpy as np
from repro_torch.api.planner import Planner
_execute = Planner.execute
def execute(self, batch, cache):
    out = _execute(self, batch, cache)
    whole = isinstance(out[0], np.ndarray)  # a stream member returns its trussness alone
    t = (out[0] if whole else out[0].trussness).copy()
    t[len(t) // 2] += 1
    out[0] = t if whole else dataclasses.replace(out[0], trussness=t)
    return out
Planner.execute = execute
"""

UNCHANGED = """
from repro_torch.stream.session import StreamingTrussSession
_submit = StreamingTrussSession.submit_update
def submit_update(self, batch, **kw):
    pending = _submit(self, batch, **kw)
    pending._future = None  # the re-peel's answer dropped: the carried state stands
    return pending
StreamingTrussSession.submit_update = submit_update
"""


@pytest.mark.parametrize("cell, fault", [
    ("t_dec", ALTERED),
    ("t_st", ALTERED),
    ("t_st", UNCHANGED),
])
def test_a_broken_timed_path_is_not_correct(tmp_path, cell, fault):
    root = tiny_copy(tmp_path)
    rc, result, err = run_cell(root, cell, prelude=fault, seconds=1.5)
    assert rc == 0, err
    assert result["correct"] is False, err
    assert result["checks"]["mismatched_edges"]["value"] > 0
