"""The Delaunay graph's configuration (``delaunay_n20``) and the width-16
stream mix on the CPU at tiny sizes: a copy of the configuration cut to
2**9 points is found by file and runs the decompose mix correct, with the
cell's own per-layer metrics; an altered answer under its timed path comes
out not correct; the width-16 mix's batches hold 8 deletes and 8 inserts;
and the readers of the unfused trip loop's counters."""

import json
from types import SimpleNamespace

import numpy as np
import pytest
from test_ktb_harness import ALTERED
from tiny import ROOT, run_cell, tiny_copy

import repro_torch.obs as program_obs
from ktbench import generators, updates
from ktbench.devtrace import Stretch
from ktbench.spec import load_cell, load_reader
from repro_torch.obs import MetricsRegistry

CELL = "delaunay20_decompose"


def _tiny_delaunay_cell(root):
    """The configuration cut to 2**9 points and a cell ``t_del`` on the
    decompose mix, reporting what ``delaunay20_decompose`` reports."""
    pytest.importorskip("scipy.spatial")
    configs = root / "ktbench" / "configs"
    cfg = json.loads((configs / "delaunay_n20.json").read_text())
    cfg.update(name="tiny-delaunay", log2_n=9)
    (configs / "tiny-delaunay.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-delaunay", "source": "tiny", "why": "CPU test",
                             "file": "ktbench/configs/tiny-delaunay.json", "reduced": ["log2_n"]})
    bench["workloads"].append({"name": "t_del", "config": "tiny-delaunay",
                               "traffic": "decompose_alt2", "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("t_del")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_delaunay_cell_runs_correct(tmp_path, trace):
    root = _tiny_delaunay_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_del", trace=trace)
    assert rc == 0, err
    assert result["correct"], err
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["limit"] == 0 and v["value"] == 0 for v in result["checks"].values())
    if trace:
        # Off the card the trip loop counts its trips and lanes, and the
        # device readers and the trip graph's span find nothing to read.
        got = result["metrics"]
        assert got["support_lanes_per_trip.delaunay"]["value"] > 0
        assert not {"trip_us.delaunay", "trip_load_ms.delaunay", "dispatch_device_ms.delaunay",
                    "device_idle_pct.delaunay", "support_fine_roofline_pct.delaunay"} & set(got)
    else:
        assert set(result["metrics"]) == {"edges_per_s", "setup_s"}


def test_the_tiny_delaunay_cell_with_an_altered_answer_is_not_correct(tmp_path):
    root = _tiny_delaunay_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_del", prelude=ALTERED, seconds=1.5)
    assert rc == 0, err
    assert result["correct"] is False, err
    assert result["checks"]["mismatched_edges"]["value"] > 0


def test_the_width_16_mix_holds_8_deletes_and_8_inserts():
    cell = load_cell("g500_stream_w16", ROOT)
    w1 = json.loads((ROOT / "ktbench" / "traffic" / "stream_w1.json").read_text())
    assert cell.traffic["width"] == 16
    assert {k: v for k, v in cell.traffic.items() if k not in ("width", "why")} == {
        k: v for k, v in w1.items() if k not in ("width", "why")}
    assert {m["name"] for m in cell.end_to_end} == {"updates_per_s", "update_p95_ms", "setup_s"}
    n, edges = generators.config_graph(dict(cell.config, scale=8, edge_factor=4), 11, 0)
    truss = np.arange(edges.shape[0]) % 7  # any key: the strata only order the deletes
    batches = updates.balanced_updates(np.random.default_rng(3), n, edges, cell.traffic["width"],
                                       20, delete_key=truss, strata=4)
    assert len(batches) == 20
    assert all(ins.shape == (8, 2) and dels.shape == (8, 2) for ins, dels in batches)
    keys = edges[:, 0] * n + edges[:, 1]
    for ins, dels in batches:
        assert np.isin(dels[:, 0] * n + dels[:, 1], keys).all()
        assert not np.isin(ins[:, 0] * n + ins[:, 1], keys).any()


def _registry(monkeypatch, counts: dict) -> None:
    reg = MetricsRegistry()
    for name, value in counts.items():
        reg.inc(name, value)
    monkeypatch.setattr(program_obs, "get_registry", lambda: reg)


COUNTS = {"peel_trips": 1700, "peel_support_lanes": 1_912_000_000, "device_seconds_total": 4.25,
          "dispatches": 2}


def test_trip_readers_read_the_trip_loop_counters(monkeypatch):
    _registry(monkeypatch, COUNTS)
    card = SimpleNamespace(device="cuda")
    assert load_reader("layer_metrics", "trip_us.delaunay").read(card) == pytest.approx(2500.0)
    assert load_reader("layer_metrics", "support_lanes_per_trip.delaunay").read(card) == (
        pytest.approx(1_124_705.882, rel=1e-9))
    assert load_reader("layer_metrics", "dispatch_device_ms.delaunay").read(card) == (
        pytest.approx(2125.0))
    # Off the card the counter holds the host wall: no device time per trip.
    off_card = SimpleNamespace(device="cpu")
    assert load_reader("layer_metrics", "trip_us.delaunay").read(off_card) is None


@pytest.mark.parametrize("metric", ["trip_us.delaunay", "support_lanes_per_trip.delaunay"])
def test_trip_readers_are_none_without_the_trip_count(monkeypatch, metric):
    """A program whose trip loop does not count its trips reports nothing."""
    _registry(monkeypatch, {k: v for k, v in COUNTS.items() if k != "peel_trips"})
    assert load_reader("layer_metrics", metric).read(SimpleNamespace(device="cuda")) is None


def _ctx(stretch=None, requests=0):
    driver = SimpleNamespace(pool=[(100, None), (100, None)], requests=requests,
                             graph_of=lambda j: j % 2)
    truths = {0: np.array([2, 3, 3, 4], np.int32), 1: np.array([2, 2, 3], np.int32)}
    return SimpleNamespace(device="cuda", stretch=stretch, driver=driver, truths=truths,
                           spans={"trip-load": [0.006, 3], "dispatch": [4.0, 3]})


def test_the_roofline_counts_every_dispatched_decompose_over_the_trip_graph_time(monkeypatch):
    from ktbench import roofline

    _registry(monkeypatch, COUNTS)
    ctx = _ctx(requests=3)  # warm 0, 1; then 0, 1, 0
    want_bytes = 3 * roofline.level_bytes(100, ctx.truths[0]) + 2 * roofline.level_bytes(
        100, ctx.truths[1])
    got = load_reader("layer_metrics", "support_fine_roofline_pct.delaunay").read(ctx)
    assert got == pytest.approx(roofline.roofline_pct(want_bytes, 4.25))
    _registry(monkeypatch, {})
    assert load_reader("layer_metrics", "support_fine_roofline_pct.delaunay").read(ctx) is None


def test_the_idle_share_counts_the_trip_graph_replays_as_busy(monkeypatch):
    _registry(monkeypatch, COUNTS)
    st = Stretch(window_s=5.0, busy_s=0.5, op_seconds={}, gaps={}, requests=[None, None])
    got = load_reader("layer_metrics", "device_idle_pct.delaunay").read(_ctx(st))
    assert got == pytest.approx(100.0 * (1 - (0.5 + 2 * 2.125) / 5.0))
    assert load_reader("layer_metrics", "device_idle_pct").read(_ctx(st)) == pytest.approx(90.0)
    _registry(monkeypatch, {"dispatches": 2})  # a program that does not time its replays
    assert load_reader("layer_metrics", "device_idle_pct.delaunay").read(_ctx(st)) is None


def test_the_trip_load_span_per_dispatch():
    got = load_reader("layer_metrics", "trip_load_ms.delaunay").read(_ctx())
    assert got == pytest.approx(2.0)
    ctx = _ctx()
    del ctx.spans["trip-load"]
    assert load_reader("layer_metrics", "trip_load_ms.delaunay").read(ctx) is None
