"""The reader of the lanes the unfused trip loop walks a trip
(``trip_walked_lanes_per_trip.delaunay``): the ratio of the program's two
counters, nothing for a program that does not count them, and on the tiny
Delaunay cell (one decompose a dispatch on eight slots) one slot's lanes."""

from types import SimpleNamespace

import pytest
from test_ktb_delaunay import _tiny_delaunay_cell
from tiny import run_cell, tiny_copy

import repro_torch.obs as program_obs
from ktbench.spec import load_reader
from repro_torch.obs import MetricsRegistry

METRIC = "trip_walked_lanes_per_trip.delaunay"


@pytest.mark.parametrize("counts, want", [
    ({"peel_trips": 1700, "peel_trip_lanes_walked": 1700 * 4_194_304}, 4_194_304.0),
    ({"peel_trips": 1700}, None),  # a program that does not count the lanes it walks
    ({"peel_trip_lanes_walked": 5}, None),
])
def test_the_reader_is_the_ratio_of_the_two_counters(monkeypatch, counts, want):
    reg = MetricsRegistry()
    for name, value in counts.items():
        reg.inc(name, value)
    monkeypatch.setattr(program_obs, "get_registry", lambda: reg)
    assert load_reader("layer_metrics", METRIC).read(SimpleNamespace(device="cuda")) == want


def test_the_tiny_delaunay_cell_walks_one_slot_a_trip(tmp_path):
    """2**9 points, about 1,530 edges: one slot of 2,048 lanes of the 8."""
    root = _tiny_delaunay_cell(tiny_copy(tmp_path))
    rc, result, err = run_cell(root, "t_del", trace=1)
    assert rc == 0, err
    assert result["correct"], err
    assert result["metrics"][METRIC]["value"] == 2048
