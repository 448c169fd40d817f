"""The shared-queries mix (``shared_q3``) on the CPU at a tiny size: a cell
of the shared-queries Delaunay configuration (``delaunay_n20_q3``) cut to
2**9 points on that mix runs correct, with ``delaunay20_shared_q3``'s
per-layer metrics (each request one dispatch of three members, two of them
on a graph an earlier one holds); a wrong ``ktruss`` member under the timed
path comes out not correct; and the mix's queries are parsed as the driver
reads them."""

import json

import pytest
from tiny import run_cell, tiny_copy

from ktbench.drivers.shared_queries import parse_queries

CELL = "delaunay20_shared_q3"

KTRUSS_ALTERED = """
import dataclasses
from repro_torch.api.planner import Planner
_execute = Planner.execute
def execute(self, batch, cache):
    out = _execute(self, batch, cache)
    for i, st in enumerate(batch.queries):
        if st.query.workload == "ktruss":
            support = out[i].support.copy()
            support[len(support) // 2] += 1
            out[i] = dataclasses.replace(out[i], support=support)
    return out
Planner.execute = execute
"""


def _tiny_shared_cell(root):
    """The configuration cut to 2**9 points and a cell ``t_q3`` on the
    shared-queries mix, reporting what ``delaunay20_shared_q3`` reports."""
    pytest.importorskip("scipy.spatial")
    configs = root / "ktbench" / "configs"
    cfg = json.loads((configs / "delaunay_n20_q3.json").read_text())
    cfg.update(name="tiny-delaunay", log2_n=9)
    (configs / "tiny-delaunay.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-delaunay", "source": "tiny", "why": "CPU test",
                             "file": "ktbench/configs/tiny-delaunay.json", "reduced": ["log2_n"]})
    bench["workloads"].append({"name": "t_q3", "config": "tiny-delaunay", "traffic": "shared_q3",
                               "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("t_q3")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_the_tiny_shared_cell_runs_correct(tmp_path, trace):
    root = _tiny_shared_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_q3", trace=trace)
    assert rc == 0, err
    assert result["correct"], err
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["limit"] == 0 and v["value"] == 0 for v in result["checks"].values())
    assert "fold: mean" in err and "dispatch serving their queries: 3:" in err
    if trace:
        got = {k: v["value"] for k, v in result["metrics"].items()}
        assert got["queries_per_dispatch.q3"] == 3.0
        assert got["shared_slots_per_dispatch.q3"] == 2.0
        assert got["support_lanes_per_trip.q3"] > 0
        assert got["trip_walked_lanes_per_trip.q3"] > 0
        # Off the card the device readers find nothing to read.
        assert not {"trip_us.q3", "device_idle_pct.q3", "support_fine_roofline_pct.q3"} & set(got)
    else:
        assert set(result["metrics"]) == {"edges_per_s", "setup_s"}


def test_the_tiny_shared_cell_with_a_wrong_ktruss_member_is_not_correct(tmp_path):
    root = _tiny_shared_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_q3", prelude=KTRUSS_ALTERED, seconds=1.5)
    assert rc == 0, err
    assert result["correct"] is False, err
    assert result["checks"]["mismatched_edges"]["value"] > 0


def test_the_mix_queries_parse():
    assert parse_queries(["decompose", "kmax", "ktruss:4"]) == [
        ("decompose", 3), ("kmax", 3), ("ktruss", 4)]
    for bad in (["kmax"], ["decompose", "decompose"], ["decompose", "ktruss"],
                ["decompose", "kmax:5"], ["decompose", "count"]):
        with pytest.raises(ValueError):
            parse_queries(bad)
