"""The peel's device time and work per fused level.

On the CPU: a traced ``fine/fused/aligned`` decompose counts every inner
trip in ``peel_level_trips`` and writes one ``peel-level.done`` record per
level, whose alive lanes are recounted here from the states the level step
was given; an untraced session records no level events and makes the same
readbacks; the update trips the level steps add on the device ride in the
same readbacks into ``peel_level_trips_incremental`` and the records (0 on
the plain version); each level step is handed the carry of the step before
in its dispatch, and the carried first trips ride into
``peel_level_trips_carried`` and the records; off CUDA no device counter is recorded and
``device_time_s`` is the dispatch's host wall; a traced session's spans
open profiler ranges while a ``torch.profiler`` records.  On the card (``-m gpu``): the level
launches' event seconds against the profiler's kernel time on rmat-15, and
``device_time_s`` against the dispatch's wall on the fused and trip-graph
paths.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.api import Session, TrussQuery
from repro_torch.graphs import rmat
from repro_torch.kernels.peel_fused import LevelCounts
from repro_torch.obs.names import (
    PEEL_LEVEL_DEVICE_SECONDS,
    PEEL_LEVEL_TRIPS,
    PEEL_LEVEL_TRIPS_CARRIED,
    PEEL_LEVEL_TRIPS_INCREMENTAL,
)

FUSED = dict(backend="fine/fused/aligned", chunk=64, max_batch=2)


def _spied(s: Session, g) -> list:
    """Wrap the session's fused level step for ``g``; returns the list that
    receives each launch's (state in, state out)."""
    peel = s.executor_for(g)._peel
    inner, seen = peel.level_step, []

    def step(p, st, *args, **kw):
        out = inner(p, st, *args, **kw)
        seen.append((st, out[0]))
        return out

    peel.level_step = step
    return seen


def _decompose(s: Session, g):
    fut = s.submit(TrussQuery.decompose(g))
    s.flush()
    fut.result()
    return fut


def test_traced_fused_decompose_records_each_level(tmp_path):
    """A decompose beside a ``ktruss(3)`` member, whose slot retires after
    its first level with its alive lanes kept: they are not live lanes."""
    path = tmp_path / "levels.json"
    s = Session(trace=str(path), device="cpu", **FUSED)
    g = rmat(6, 4, seed=2)
    seen = _spied(s, g)
    fut = s.submit(TrussQuery.decompose(g))
    s.submit(TrussQuery.ktruss(g, k=3))
    s.flush()
    fut.result()
    assert s.stats()["device_dispatches"] == 1
    assert any(st.done[1] and st.alive.reshape(2, -1)[1].any() for st, _ in seen)
    levels = int(s.obs.metrics.value("peel_fused_levels"))
    assert levels == len(seen) >= 2
    trips = s.metrics_snapshot()["counters"][PEEL_LEVEL_TRIPS]
    assert trips == fut.stats.dispatch_trips == int(seen[-1][1].total_iters) > levels
    events = json.loads(path.read_text())["traceEvents"]
    done = [e for e in events if e["name"] == "peel-level.done"]
    assert [e["args"]["level"] for e in done] == list(range(levels))
    slots = FUSED["max_batch"]
    for ev, (before, after) in zip(done, seen):
        assert ev["ph"] == "i" and "device_ms" not in ev["args"]
        assert ev["args"]["trips"] == int(after.total_iters) - int(before.total_iters) >= 1
        alive = before.alive.numpy().reshape(slots, -1)
        assert ev["args"]["alive_lanes"] == int(alive[~before.done.numpy()].sum())
    assert sum(ev["args"]["trips"] for ev in done) == trips
    # Each record follows its level's span, inside the one dispatch.
    spans = [e for e in events if e["name"] == "peel-level"]
    assert all(ev["ts"] >= sp["ts"] + sp["dur"] for ev, sp in zip(done, spans))


def test_untraced_fused_decompose_records_no_level_event_and_same_readbacks():
    g = rmat(6, 4, seed=2)
    syncs = {}
    for trace in (False, True):
        s = Session(trace=trace, device="cpu", **FUSED)
        _decompose(s, g)
        levels = int(s.obs.metrics.value("peel_fused_levels"))
        syncs[trace] = s.executor_for(g).host_syncs
        assert syncs[trace] == levels + 3  # a readback a level, the last test, tiling, belt
        assert s.obs.metrics.value(PEEL_LEVEL_TRIPS) > levels
        assert s.metrics_snapshot()["counters"][PEEL_LEVEL_TRIPS_INCREMENTAL] == 0  # plain version
        assert s.metrics_snapshot()["counters"][PEEL_LEVEL_TRIPS_CARRIED] == 0
        names = {e["name"] for e in s.obs.tracer.events()}
        assert ("peel-level.done" in names) is trace
    assert syncs[False] == syncs[True]


def test_update_trips_ride_in_the_level_readbacks():
    """Level steps that add update trips to the level counts they are
    handed (as the kernel does on the card; here all but each launch's
    first trip):
    the dispatch's ``peel_level_trips_incremental`` and each level's record
    hold them, with no readback more than an untraced plain session's."""
    g = rmat(6, 4, seed=2)
    s = Session(trace=True, device="cpu", **FUSED)
    seen = _spied(s, g)
    peel = s.executor_for(g)._peel
    inner = peel.level_step

    def step(p, st, *args, level_counts=None, **kw):
        out = inner(p, st, *args, level_counts=level_counts, **kw)
        added = int(out[0].total_iters - st.total_iters) - 1
        level_counts[LevelCounts._fields.index("update_trips")] += added  # in place, as on the card
        return out

    peel.level_step = step
    _decompose(s, g)
    levels = int(s.obs.metrics.value("peel_fused_levels"))
    added = [int(after.total_iters - before.total_iters) - 1 for before, after in seen]
    assert len(added) == levels and sum(added) > 0
    assert s.metrics_snapshot()["counters"][PEEL_LEVEL_TRIPS_INCREMENTAL] == sum(added)
    done = [e for e in s.obs.tracer.events() if e["name"] == "peel-level.done"]
    assert [e["args"]["update_trips"] for e in done] == added
    assert s.executor_for(g).host_syncs == levels + 3


def test_each_launch_gets_the_carry_of_the_launch_before_in_its_dispatch():
    """A level step that returns a fresh carry each launch and, as the
    kernel does when its first trip updates from a carry, adds 1 to the
    level counts' ``carried`` when it was handed one: the first launch of each dispatch
    is handed none, every later one the carry its predecessor returned;
    ``peel_level_trips_carried`` and the records' ``carried`` hold the
    count, with no readback more."""
    g = rmat(6, 4, seed=2)
    s = Session(trace=True, device="cpu", **FUSED)
    peel = s.executor_for(g)._peel
    inner, given, returned = peel.level_step, [], []

    def step(p, st, *args, carry=None, level_counts=None, **kw):
        out, none = inner(p, st, *args, carry=carry, level_counts=level_counts, **kw)
        assert none is None  # the plain version hands nothing over
        given.append(carry)
        returned.append(object())
        if carry is not None:
            level_counts[LevelCounts._fields.index("carried")] += 1  # in place, as on the card
        return out, returned[-1]

    peel.level_step = step
    _decompose(s, g)
    levels = len(given)
    _decompose(s, g)  # a second dispatch starts without a carry
    assert int(s.obs.metrics.value("peel_fused_levels")) == len(given) == 2 * levels >= 4
    for first in (0, levels):
        assert given[first] is None
        assert all(given[i] is returned[i - 1] for i in range(first + 1, first + levels))
    counters = s.metrics_snapshot()["counters"]
    assert counters[PEEL_LEVEL_TRIPS_CARRIED] == 2 * (levels - 1)
    done = [e["args"]["carried"] for e in s.obs.tracer.events() if e["name"] == "peel-level.done"]
    assert done == 2 * ([0] + [1] * (levels - 1))
    assert s.executor_for(g).host_syncs == 2 * (levels + 3)


def test_device_time_off_cuda_is_the_dispatch_host_wall():
    """A fake clock that only the level steps advance: the dispatch's
    ``device_time_s`` is exactly their host time, and no device counter
    is recorded."""
    clock = obs.FakeClock()
    g = rmat(6, 4, seed=2)
    with obs.use_clock(clock):
        s = Session(device="cpu", **FUSED)
        seen = _spied(s, g)
        inner = s.executor_for(g)._peel.level_step

        def step(*args, **kw):
            clock.advance(0.125)
            return inner(*args, **kw)

        s.executor_for(g)._peel.level_step = step
        fut = _decompose(s, g)
    wall = 0.125 * len(seen)
    assert fut.stats.device_time_s == s.device_time_s == wall > 0
    counters = s.metrics_snapshot()["counters"]
    assert PEEL_LEVEL_DEVICE_SECONDS not in counters
    assert sum(v for k, v in counters.items() if k.startswith("peel_device_seconds_total")) == wall


def test_spans_open_profiler_ranges_while_a_profiler_records():
    from torch.profiler import ProfilerActivity, profile

    g = rmat(6, 4, seed=2)
    s = Session(trace=True, device="cpu", **FUSED)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decompose(s, g)
    ranges = {e.name for e in prof.events()}
    spans = {e["name"] for e in s.obs.tracer.events() if e["ph"] == "X"}
    assert {"plan", "pack", "dispatch", "peel-level", "unpack"} <= spans <= ranges
    # Without a profiler a span opens no range; the disabled tracer stays
    # one shared no-op.
    tracer = obs.Tracer()
    with tracer.span("quiet") as sp:
        assert sp._range is None
    assert obs.NULL_TRACER.span("a") is obs.NULL_TRACER.span("b")


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _kernel_seconds(prof, needle: str) -> float:
    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    return 1e-6 * sum(device_us(e) for e in prof.key_averages() if needle in e.key)


@pytest.mark.gpu
def test_level_device_seconds_match_the_profiled_kernel_time(cuda):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import LARGE_GRAPHS

    g = LARGE_GRAPHS[0].factory()  # rmat-15
    s = Session(device=cuda, backend="fine/fused/aligned", max_batch=1)
    _decompose(s, g)  # builds the kernel, outside the profile
    before = s.obs.metrics.value(PEEL_LEVEL_DEVICE_SECONDS)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _decompose(s, g)
        torch.cuda.synchronize()
    got = s.obs.metrics.value(PEEL_LEVEL_DEVICE_SECONDS) - before
    want = _kernel_seconds(prof, "peel_fused_kernel")
    assert want > 0
    assert abs(got - want) <= 0.02 * want, (got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fine/fused/aligned", "fine/pallas/aligned"])
def test_device_time_is_at_most_the_dispatch_wall(cuda, backend):
    """Every dispatch (the trip graph's first captures it, the second
    replays it): 0 < device_time_s <= the ``dispatch`` span."""
    g = rmat(10, 8, seed=5)
    s = Session(device=cuda, backend=backend, max_batch=2, trace=True)
    for _ in range(2):
        s.obs.tracer.clear()
        fut = _decompose(s, g)
        (dispatch,) = [e for e in s.obs.tracer.events() if e["name"] == "dispatch"]
        assert 0 < fut.stats.device_time_s <= dispatch["dur"] * 1e-6
    assert (PEEL_LEVEL_DEVICE_SECONDS in s.metrics_snapshot()["counters"]) is (
        backend == "fine/fused/aligned"
    )
    assert np.isclose(s.device_time_s, sum(
        v for k, v in s.metrics_snapshot()["counters"].items()
        if k.startswith("peel_device_seconds_total")
    ))
