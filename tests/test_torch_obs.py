"""Port parity, observability: the contracts of the JAX package's
``tests/test_obs.py`` held on ``repro_torch`` on the CPU.

* the key sets of ``Session.stats()``, ``CacheStats.snapshot()`` and a
  stream's ``stats()`` equal the reference's, read from ``repro`` itself;
* a traced ``solve()`` writes Chrome trace-event JSON with well-formed
  ``ph``/``ts``/``dur`` fields and every stage's span, the same span names
  and the same counters as the reference's traced solve of the same batch;
* ``REPRO_TRACE``, ``trace=False`` as a no-op, the Prometheus text format,
  deadlines on the fake clock, escaped metric labels, registry chaining;
* the fused peel's one ``peel-level`` span per level launch.

Left out: the reference's check of JAX's persistent compile cache
(``tests/test_cache_persist.py``), which has no counterpart in the port.
"""

import importlib
import json
import sys
import warnings

import pytest

import repro.api as ra
import repro.graphs as rg
import repro_torch.api as ta
from _torch_parity import torch_graph
from repro.api.cache import CacheStats as RefCacheStats
from repro_torch import obs
from repro_torch.api import Session, TrussQuery, solve
from repro_torch.api.cache import CacheStats
from repro_torch.api.errors import TrussTimeoutError

SPAN_NAMES = {"solve", "plan", "pack", "compile", "dispatch", "device-wait", "unpack"}
# Counters that hold seconds: equal in name only between the two packages.
TIMED_COUNTERS = ("device_seconds_total", "peel_device_seconds_total")


def _ref_graphs():
    return [rg.erdos(60, 6.0, seed=3), rg.rmat(6, 6, seed=4)]


@pytest.fixture(scope="module")
def graphs():
    return [torch_graph(g) for g in _ref_graphs()]


def _batch(tq, gs):
    return [
        tq.TrussQuery.decompose(gs[0]),
        tq.TrussQuery.decompose(gs[1]),
        tq.TrussQuery.kmax(gs[0]),
        tq.TrussQuery.ktruss(gs[1], k=3),
    ]


@pytest.fixture(scope="module")
def traced(tmp_path_factory, graphs):
    """One traced mixed-workload solve on the port, shared across assertions."""
    path = tmp_path_factory.mktemp("obs") / "trace.json"
    s = Session(trace=str(path), max_batch=4, device="cpu")
    res = s.solve(_batch(ta, graphs))
    return s, res, path


@pytest.fixture(scope="module")
def ref_traced(tmp_path_factory):
    """The same traced solve on the JAX package."""
    path = tmp_path_factory.mktemp("obs_ref") / "trace.json"
    s = ra.Session(trace=str(path), max_batch=4)
    res = s.solve(_batch(ra, _ref_graphs()))
    return s, res, path


# --------------------------------------------------------------------- #
# stats() key sets, read from the reference
# --------------------------------------------------------------------- #
def test_session_stats_keys_match_reference(traced):
    s, res, _ = traced
    assert len(res) == 4
    want = set(ra.Session(max_batch=4).stats().keys())
    assert set(s.stats().keys()) == want


def test_session_stats_values_are_metric_views(traced):
    s, _, _ = traced
    st = s.stats()
    assert st["requests_served"] == 4
    assert st["device_dispatches"] == st["batches_run"] >= 1
    assert st["deadline_misses"] == 0
    assert st["device_time_s"] > 0
    assert s.obs.metrics.value("requests_served") == 4
    assert s.obs.metrics.value("dispatches") == st["device_dispatches"]


def test_cache_stats_snapshot_keys_match_reference():
    cs = CacheStats()
    assert set(cs.snapshot().keys()) == set(RefCacheStats().snapshot().keys())
    cs.record_compile()
    cs.record_hit()
    assert cs.compiles == 1 and cs.hits == 1
    assert cs.snapshot()["hit_rate"] == 0.5


def test_stream_stats_keys_match_reference(graphs):
    want = set(ra.Session(max_batch=2).open_stream(_ref_graphs()[0]).stats().keys())
    stream = Session(max_batch=2, device="cpu").open_stream(graphs[0])
    assert set(stream.stats().keys()) == want


def test_metrics_snapshot_structure(traced):
    s, _, _ = traced
    snap = s.metrics_snapshot()
    assert set(snap.keys()) == {"counters", "gauges", "histograms"}
    assert snap["counters"]["requests_served"] == 4
    assert "queue_depth" in snap["gauges"]
    occ = snap["histograms"]["batch_occupancy"]
    for field in ("count", "sum", "min", "max", "mean", "buckets"):
        assert field in occ
    assert occ["count"] >= 1


def test_metrics_snapshot_matches_reference(traced, ref_traced):
    """The same batch records the same counters (seconds by name only),
    gauges and histogram series in both packages."""
    got, want = traced[0].metrics_snapshot(), ref_traced[0].metrics_snapshot()
    assert set(got["counters"]) == set(want["counters"])
    for key, value in want["counters"].items():
        if not key.startswith(TIMED_COUNTERS):
            assert got["counters"][key] == value, key
    assert set(got["gauges"]) == set(want["gauges"])
    assert set(got["histograms"]) == set(want["histograms"])
    occ, ref_occ = got["histograms"]["batch_occupancy"], want["histograms"]["batch_occupancy"]
    assert (occ["count"], occ["mean"]) == (ref_occ["count"], ref_occ["mean"])


# --------------------------------------------------------------------- #
# Chrome trace JSON
# --------------------------------------------------------------------- #
def test_traced_solve_exports_chrome_trace(traced):
    _, _, path = traced
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    assert events, "traced solve produced no events"
    names = set()
    for ev in events:
        assert ev["ph"] in {"X", "i"}
        assert isinstance(ev["ts"], (int, float)) and ev["ts"] >= 0
        if ev["ph"] == "X":
            assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0
        assert "pid" in ev and "tid" in ev
        names.add(ev["name"])
    assert SPAN_NAMES <= names
    plan = next(e for e in events if e["name"] == "plan")
    assert "workload" in plan["args"] and "backend" in plan["args"]
    compile_ev = next(e for e in events if e["name"] == "compile")
    assert "hit" in compile_ev["args"]


def test_trace_matches_reference(traced, ref_traced):
    """Same span names, same count of each, same span attributes' keys."""
    got = json.loads(traced[2].read_text())["traceEvents"]
    want = json.loads(ref_traced[2].read_text())["traceEvents"]

    def shape(events):
        return sorted((e["name"], e["ph"], tuple(sorted(e.get("args", {})))) for e in events)

    assert shape(got) == shape(want)


def test_trace_env_var(tmp_path, graphs, monkeypatch):
    path = tmp_path / "env_trace.json"
    monkeypatch.setenv(obs.TRACE_ENV_VAR, str(path))
    assert obs.TRACE_ENV_VAR == "REPRO_TRACE"
    solve(TrussQuery.decompose(graphs[0]), device="cpu")
    data = json.loads(path.read_text())
    assert any(e["name"] == "solve" for e in data["traceEvents"])


def test_trace_disabled_is_noop(graphs):
    s = Session(trace=False, max_batch=2, device="cpu")
    s.solve([TrussQuery.decompose(graphs[0])])
    assert s.obs.tracer is obs.NULL_TRACER
    assert not s.obs.tracing
    assert s.export_trace() is None


# --------------------------------------------------------------------- #
# Peel telemetry: the paper's imbalance statistic, observed at runtime
# --------------------------------------------------------------------- #
def test_peel_telemetry_recorded_per_bucket_backend(traced, ref_traced):
    s, _, _ = traced
    hists = s.metrics_snapshot()["histograms"]
    imb = {k: v for k, v in hists.items() if k.startswith("peel_batch_imbalance")}
    assert imb, "no peel_batch_imbalance histograms recorded"
    for key, row in imb.items():
        assert "bucket=" in key and "backend=" in key
        assert row["min"] >= 1.0
    rows = obs.imbalance_summary(s.obs.metrics)
    assert rows and all("bucket" in r and "backend" in r for r in rows)
    assert any(k.startswith("peel_slot_iters") for k in hists)
    assert any(k.startswith("peel_level_edges") for k in hists)
    from repro.obs import imbalance_summary as ref_summary

    def untimed(rs):
        return [{k: v for k, v in r.items() if not k.startswith("device_time_s")} for r in rs]

    assert untimed(rows) == untimed(ref_summary(ref_traced[0].obs.metrics))


# --------------------------------------------------------------------- #
# Prometheus text exposition
# --------------------------------------------------------------------- #
def test_prometheus_text_format(traced):
    s, _, _ = traced
    lines = s.prometheus_text().splitlines()
    assert "# TYPE requests_served counter" in lines
    assert "requests_served 4" in lines
    assert "# TYPE queue_depth gauge" in lines
    assert "# TYPE batch_occupancy histogram" in lines
    assert any(
        line.startswith("batch_occupancy_bucket{") and 'le="+Inf"' in line for line in lines
    )
    assert any(line.startswith("batch_occupancy_sum ") for line in lines)
    assert any(line.startswith("batch_occupancy_count ") for line in lines)


# --------------------------------------------------------------------- #
# Deadlines run on the obs clock (fake-able: no sleeping in this test)
# --------------------------------------------------------------------- #
def test_deadline_miss_on_fake_clock(graphs):
    clock = obs.FakeClock()
    with obs.use_clock(clock):
        s = Session(max_batch=2, device="cpu")
        fut = s.submit(TrussQuery.decompose(graphs[0], deadline_s=5.0))
        assert fut.request.time_remaining() == pytest.approx(5.0)
        clock.advance(10.0)
        assert fut.request.time_remaining() == 0.0
        with pytest.raises(TrussTimeoutError) as ei:
            fut.result()
        assert s.deadline_misses == 1
        assert s.stats()["deadline_misses"] == 1
        assert ei.value.shed is True
        assert len(s.queue) == 0
        assert s.stats()["queries_shed"] == 1
        with pytest.raises(TrussTimeoutError):
            fut.result(timeout=None)


def test_remaining_is_the_one_deadline_rule():
    clock = obs.FakeClock()
    with obs.use_clock(clock):
        t0 = obs.now()
        assert obs.remaining(t0, None) is None
        assert obs.remaining(t0, 2.0) == pytest.approx(2.0)
        clock.advance(1.5)
        assert obs.remaining(t0, 2.0) == pytest.approx(0.5)
        clock.advance(1.0)
        assert obs.remaining(t0, 2.0) == 0.0


def test_fake_clock_drives_trace_timestamps():
    clock = obs.FakeClock()
    with obs.use_clock(clock):
        tr = obs.Tracer()
        with obs.use_tracer(tr):
            with obs.current_tracer().span("work"):
                clock.advance(0.25)
        (ev,) = tr.events()
        assert ev["dur"] == pytest.approx(0.25e6)


# --------------------------------------------------------------------- #
# Per-session stream metrics
# --------------------------------------------------------------------- #
def test_stream_enumerations_per_session(graphs):
    from repro_torch.stream.delta import EdgeBatch
    from repro_torch.stream.frontier import ENUM_COUNTS

    base_full = ENUM_COUNTS["full"]
    s = Session(max_batch=2, device="cpu")
    st_a = s.open_stream(graphs[0])
    st_b = s.open_stream(graphs[1])
    st_a.update(EdgeBatch.of(inserts=[(1, 2)]), strict=False)
    assert st_a.metrics.value("stream_enumerations", kind="full") == 1
    assert st_b.metrics.value("stream_enumerations", kind="full") == 0
    assert ENUM_COUNTS["full"] >= base_full + 1
    assert set(iter(ENUM_COUNTS)) == {"full", "incident"}
    assert len(ENUM_COUNTS) == 2


def test_stream_counters_are_metric_views(graphs):
    from repro_torch.stream.delta import EdgeBatch

    stream = Session(max_batch=2, device="cpu").open_stream(graphs[0])
    stream.update(EdgeBatch.of(inserts=[(2, 3)]), strict=False)
    assert stream.updates_applied == 1
    assert stream.metrics.value("stream_updates") == 1
    assert stream.update_dispatches == stream.metrics.value("stream_update_dispatches")
    hists = stream.metrics.snapshot()["histograms"]
    assert any(k.startswith("stream_frontier_frac") for k in hists)


# --------------------------------------------------------------------- #
# The legacy service package: no shim modules, a warning-free import
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mod", ["repro_torch.service.cache", "repro_torch.service.batcher"])
def test_service_shims_are_absent(mod):
    sys.modules.pop(mod, None)
    with pytest.raises(ImportError):
        importlib.import_module(mod)


def test_service_package_import_is_warning_free():
    sys.modules.pop("repro_torch.service", None)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        import repro_torch.service

        assert callable(repro_torch.service.bucket_for)
        assert repro_torch.service.TrussService is not None
    assert "MicroBatcher" not in repro_torch.service.__all__
    from repro_torch.api import QueryQueue

    assert QueryQueue is not None


# --------------------------------------------------------------------- #
# Registry mechanics the wiring relies on
# --------------------------------------------------------------------- #
def test_metric_key_escaping_roundtrips_hostile_labels():
    from repro.obs.metrics import _fmt_key as ref_fmt_key
    from repro_torch.obs.metrics import _fmt_key, _label_key, _parse_key

    hostile = {
        "graph": "road,usa=west\\v2",
        "note": "a=b,c=d",
        "plain": "fine",
        "trail": "ends with backslash\\",
    }
    key = _fmt_key("requests_served", _label_key(hostile))
    assert key == ref_fmt_key("requests_served", _label_key(hostile))
    name, labels = _parse_key(key)
    assert name == "requests_served"
    assert labels == hostile
    name, labels = _parse_key("cache_bucket_hits{bucket=b64x2}")
    assert name == "cache_bucket_hits" and labels == {"bucket": "b64x2"}


def test_registry_escaped_labels_are_distinct_series():
    r = obs.MetricsRegistry()
    r.inc("requests_served", 1, graph="a,b", note="c")
    r.inc("requests_served", 5, graph="a", note="b,c")
    assert r.value("requests_served", graph="a,b", note="c") == 1
    assert r.value("requests_served", graph="a", note="b,c") == 5
    counters = r.snapshot()["counters"]
    assert sum(v for k, v in counters.items() if k.startswith("requests_served{")) == 6


def test_registry_parent_chaining():
    parent = obs.MetricsRegistry()
    child = obs.MetricsRegistry(parent=parent)
    child.inc("x", 2, where="here")  # trusslint: disable=R5
    assert child.value("x", where="here") == 2  # trusslint: disable=R5
    assert parent.value("x", where="here") == 2  # propagated up; trusslint: disable=R5
    parent.inc("x", 1, where="here")  # trusslint: disable=R5
    assert child.value("x", where="here") == 2  # isolation downward; trusslint: disable=R5


def test_session_metrics_chain_to_global(graphs):
    before = obs.get_registry().value("requests_served")
    solve(TrussQuery.decompose(graphs[0]), device="cpu")
    assert obs.get_registry().value("requests_served") == before + 1


# ------------------------------------------------------------------ #
# Fused level peel: one level per launch, one span per launch
# ------------------------------------------------------------------ #
def test_fused_peel_one_span_per_level(tmp_path):
    path = tmp_path / "fused_trace.json"
    s = Session(trace=str(path), backend="fine/fused/aligned", chunk=64, max_batch=2, device="cpu")
    g = torch_graph(rg.rmat(6, 4, seed=2))
    s.submit(TrussQuery.decompose(g))
    s.flush()
    assert s.stats()["device_dispatches"] == 1
    levels = int(s.obs.metrics.value("peel_fused_levels"))
    assert levels >= 1
    events = json.loads(path.read_text())["traceEvents"]
    level_spans = [e for e in events if e["name"] == "peel-level"]
    assert len(level_spans) == levels
    assert [e["args"]["level"] for e in level_spans] == list(range(levels))
    assert sum(1 for e in events if e["name"] == "dispatch") == 1
