"""The random geometric graph's configuration (``rgg_n_2_20_s0``) on the CPU
at tiny sizes: a copy cut to 2**9 points is found by file and runs the
decompose mix correct, with the cell's own per-layer metrics; an altered
answer under its timed path comes out not correct; and the readers of the
counted lanes per fused level."""

import json
from types import SimpleNamespace

import pytest
from test_ktb_harness import ALTERED
from tiny import run_cell, tiny_copy

import repro_torch.obs as program_obs
from ktbench.spec import load_reader
from repro_torch.obs import MetricsRegistry


def _tiny_rgg_cell(root):
    """The configuration cut to 2**9 points and a cell ``t_rgg`` on the
    decompose mix, reporting what ``rgg20_decompose`` reports."""
    configs = root / "ktbench" / "configs"
    rgg = json.loads((configs / "rgg_n_2_20_s0.json").read_text())
    rgg.update(name="tiny-rgg", log2_n=9)
    (configs / "tiny-rgg.json").write_text(json.dumps(rgg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-rgg", "source": "tiny", "why": "CPU test",
                             "file": "ktbench/configs/tiny-rgg.json", "reduced": ["log2_n"]})
    bench["workloads"].append({"name": "t_rgg", "config": "tiny-rgg", "traffic": "decompose_alt2",
                               "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "rgg20_decompose" in m.get("workloads", ()):
            m["workloads"].append("t_rgg")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_rgg_cell_runs_correct(tmp_path, trace):
    root = _tiny_rgg_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_rgg", trace=trace)
    assert rc == 0, err
    assert result["correct"], err
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["limit"] == 0 and v["value"] == 0 for v in result["checks"].values())
    if trace:
        # Off the card the device readers find nothing to read, and the
        # auto rule on the CPU's default kernel plans no fused level.
        got = result["metrics"]
        assert got["unpack_ms.rgg"]["value"] > 0
        assert "fused_counted_lanes_per_level.rgg" not in got
        assert "dispatch_device_ms.rgg" not in got and "device_idle_pct.rgg" not in got
    else:
        assert set(result["metrics"]) == {"edges_per_s", "setup_s"}


def test_the_tiny_rgg_cell_with_an_altered_answer_is_not_correct(tmp_path):
    root = _tiny_rgg_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_rgg", prelude=ALTERED, seconds=1.5)
    assert rc == 0, err
    assert result["correct"] is False, err
    assert result["checks"]["mismatched_edges"]["value"] > 0


READERS = ("fused_counted_lanes_per_level", "fused_counted_lanes_per_level.rgg")
COUNTS = {"peel_level_lanes_counted": 6_000_000, "peel_fused_levels": 40}


def _registry(monkeypatch, counts: dict) -> None:
    reg = MetricsRegistry()
    for name, value in counts.items():
        reg.inc(name, value)
    monkeypatch.setattr(program_obs, "get_registry", lambda: reg)


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_the_counted_lanes_per_level(monkeypatch, metric):
    _registry(monkeypatch, COUNTS)
    assert load_reader("layer_metrics", metric).read(SimpleNamespace(device="cuda")) == 150_000.0


@pytest.mark.parametrize("metric", READERS)
def test_reader_is_none_without_the_count(monkeypatch, metric):
    """A program whose kernel does not count its lanes reports nothing."""
    _registry(monkeypatch, {"peel_fused_levels": 40})
    assert load_reader("layer_metrics", metric).read(SimpleNamespace(device="cuda")) is None
