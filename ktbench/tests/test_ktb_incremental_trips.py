"""The readers of the fused kernel's update-trip share, on a registry with
known counts put in the process-global registry's place."""

from types import SimpleNamespace

import pytest

import repro_torch.obs as program_obs
from ktbench.spec import load_reader
from repro_torch.obs import MetricsRegistry

COUNTS = {"peel_level_trips_incremental": 34_000, "peel_level_trips": 40_000}
READERS = ("fused_incremental_trip_pct", "fused_incremental_trip_pct.stream")
ON_CARD = SimpleNamespace(device="cuda")


def _registry(monkeypatch, counts: dict) -> None:
    reg = MetricsRegistry()
    for name, value in counts.items():
        reg.inc(name, value)
    monkeypatch.setattr(program_obs, "get_registry", lambda: reg)


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_the_update_share(monkeypatch, metric):
    _registry(monkeypatch, COUNTS)
    assert load_reader("layer_metrics", metric).read(ON_CARD) == pytest.approx(85.0)


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_zero_when_every_trip_counts(monkeypatch, metric):
    _registry(monkeypatch, {**COUNTS, "peel_level_trips_incremental": 0})
    assert load_reader("layer_metrics", metric).read(ON_CARD) == 0.0


@pytest.mark.parametrize("metric", READERS)
def test_reader_is_none_without_its_counters(monkeypatch, metric):
    """A program that does not count update trips (one without them) reports
    nothing; neither does one with no trips."""
    reader = load_reader("layer_metrics", metric)
    for name in COUNTS:
        _registry(monkeypatch, {k: v for k, v in COUNTS.items() if k != name})
        assert reader.read(ON_CARD) is None
    _registry(monkeypatch, {**COUNTS, "peel_level_trips": 0})
    assert reader.read(ON_CARD) is None
