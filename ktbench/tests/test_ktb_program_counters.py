"""The per-layer readers of the program's counters, on a registry with
known counts put in the process-global registry's place."""

from types import SimpleNamespace

import pytest

import repro_torch.obs as program_obs
from ktbench.spec import load_reader
from repro_torch.obs import MetricsRegistry

COUNTS = {
    "peel_level_device_seconds": 6.0,
    "peel_level_trips": 40_000,
    "peel_fused_levels": 500,
    "device_seconds_total": 12.5,
    "dispatches": 4,
    "stream_edges_repeeled": 3_000_000,
    "stream_updates": 20,
}

EXPECTED = {  # reader -> (its value from COUNTS, the counters it reads)
    "fused_trip_us": (150.0, ("peel_level_device_seconds", "peel_level_trips")),
    "fused_trip_us.stream": (150.0, ("peel_level_device_seconds", "peel_level_trips")),
    "fused_trips_per_level": (80.0, ("peel_level_trips", "peel_fused_levels")),
    "dispatch_device_ms": (3125.0, ("device_seconds_total", "dispatches")),
    "repeeled_edges_per_update.stream": (150_000.0, ("stream_edges_repeeled", "stream_updates")),
}

ON_CARD = SimpleNamespace(device="cuda")


def _registry(monkeypatch, counts: dict) -> None:
    reg = MetricsRegistry()
    for name, value in counts.items():
        reg.inc(name, value)
    monkeypatch.setattr(program_obs, "get_registry", lambda: reg)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_its_ratio(monkeypatch, metric):
    _registry(monkeypatch, COUNTS)
    assert load_reader("layer_metrics", metric).read(ON_CARD) == pytest.approx(EXPECTED[metric][0])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_is_none_without_its_counters(monkeypatch, metric):
    reader = load_reader("layer_metrics", metric)
    for name in EXPECTED[metric][1]:
        _registry(monkeypatch, {k: v for k, v in COUNTS.items() if k != name})
        assert reader.read(ON_CARD) is None
    _registry(monkeypatch, {**COUNTS, EXPECTED[metric][1][1]: 0})  # a zero denominator
    assert reader.read(ON_CARD) is None


def test_dispatch_device_ms_reads_nothing_off_the_card(monkeypatch):
    """Off the card the program's ``device_seconds_total`` holds the host
    wall: no number under a device name."""
    _registry(monkeypatch, COUNTS)
    assert load_reader("layer_metrics", "dispatch_device_ms").read(SimpleNamespace(device="cpu")) is None
