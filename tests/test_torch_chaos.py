"""Port parity, chaos: the reference's fault storms (``tests/test_chaos.py``)
run on both packages with the same graphs, fault text and seeds, on the CPU.

Under every storm the two packages must give the same outcomes: queries the
faults do not touch resolve bit-identically (to each other and to the numpy
oracle), queries a fault hits raise the same typed error with the same
``query_id``/cause, and the resilience counters move alike.  The property
test holds the port alone to the numpy oracle.
"""

import numpy as np
import pytest

import repro.api as ra
import repro.resilience as rr
import repro_torch.api as ta
import repro_torch.resilience as tr
from _hypothesis_compat import given, settings, st
from _torch_parity import torch_graph
from repro.core import trussness_numpy
from repro.graphs import erdos, rmat

SEEDS = (101, 202, 303)

# The reference's storms: site -> REPRO_FAULTS clause (seed appended).
STORMS = {
    "none": None,
    "dispatch": "dispatch:times=1",
    "device_oom": "device_oom:times=1",
    "compile": "compile:times=1",
    "clock_skew": "clock_skew:times=1:skew=5.0",
}

COUNTERS = ("retries", "backend_fallbacks", "queries_quarantined", "batch_bisects",
            "faults_injected", "queries_failed")


class Side:
    """One package's chaos session and the matching graph/parse helpers."""

    def __init__(self, port: bool):
        self.api = ta if port else ra
        self.parse = tr.parse_faults if port else rr.parse_faults
        self.graph = torch_graph if port else (lambda g: g)
        self.session = self.api.Session(
            backend="fine/xla/aligned",
            max_batch=4,
            chunk=64,
            retry=(tr if port else rr).RetryPolicy(backoff_base_s=0.0),
            **({"device": "cpu"} if port else {}),
        )

    def counters(self):
        stats = self.session.stats()
        return {k: stats[k] for k in COUNTERS}


@pytest.fixture(scope="module")
def sides():
    return Side(port=False), Side(port=True)


def _graphs(seed, count=3):
    return [erdos(50, 4.0, seed=seed + i) for i in range(count)]


def _verdict(fut):
    try:
        r = fut.result()
    except ra.QueryFailedError as e:  # the reference's
        return _err(e, fut)
    except ta.QueryFailedError as e:  # the port's
        return _err(e, fut)
    return ("ok", np.asarray(r.trussness).dtype.str, np.asarray(r.trussness).tobytes(),
            r.kmax, r.levels)


def _err(e, fut):
    return ("QueryFailedError", e.query_id == fut.request.id, e.attempts,
            tuple(str(b) for b in e.backends_tried), type(e.cause).__name__,
            e.cause.injected, e.cause.site)


def _storm(side, gs, clause, seed, *, target=None):
    """Submit ``gs``, arm the storm, flush; verdicts and counter deltas."""
    s = side.session
    before = side.counters()
    futs = [s.submit(side.api.TrussQuery.decompose(side.graph(g))) for g in gs]
    if target is not None:
        clause = f"poison:times=*:where.query={futs[target].request.id}"
    s.faults = side.parse(f"{clause};seed={seed}") if clause else None
    try:
        s.flush()
        verdicts = [_verdict(f) for f in futs]
    finally:
        s.faults = None
    after = side.counters()
    return verdicts, {k: after[k] - before[k] for k in COUNTERS}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("storm", sorted(STORMS))
def test_transient_storms_resolve_bit_identical(sides, storm, seed):
    gs = _graphs(seed)
    want = _storm(sides[0], gs, STORMS[storm], seed)
    got = _storm(sides[1], gs, STORMS[storm], seed)
    assert got == want, (storm, seed)
    for g, v in zip(gs, got[0]):
        assert v[0] == "ok", (storm, seed, g.name)
        assert v[2] == trussness_numpy(g).astype(np.int32).tobytes(), (storm, seed, g.name)


@pytest.mark.parametrize("seed", SEEDS)
def test_poison_storm_isolates_exactly_the_target(sides, seed):
    gs = _graphs(seed)
    want = _storm(sides[0], gs, None, seed, target=1)
    got = _storm(sides[1], gs, None, seed, target=1)
    assert got == want, seed
    verdicts, delta = got
    assert verdicts[1][:2] == ("QueryFailedError", True) and verdicts[1][5] is True
    for i in (0, 2):
        assert verdicts[i][2] == trussness_numpy(gs[i]).astype(np.int32).tobytes()
    assert delta["queries_quarantined"] == 1 and delta["queries_failed"] == 1


@pytest.mark.parametrize("seed", SEEDS)
def test_unlimited_oom_storm_fails_typed_then_session_recovers(sides, seed):
    g = erdos(50, 4.0, seed=seed)
    want = _storm(sides[0], [g], "device_oom:times=*", seed)
    got = _storm(sides[1], [g], "device_oom:times=*", seed)
    assert got == want, seed
    (verdict,), _ = got
    assert verdict[0] == "QueryFailedError" and len(verdict[3]) >= 2  # the chain was walked
    s = sides[1].session
    dec = s.solve([ta.TrussQuery.decompose(torch_graph(g))])[0]
    assert np.array_equal(dec.trussness, trussness_numpy(g))


@settings(max_examples=6, deadline=None)
@given(
    seed=st.integers(min_value=0, max_value=10**6),
    site=st.sampled_from(["dispatch", "device_oom", "compile", "clock_skew"]),
    times=st.integers(min_value=1, max_value=2),
)
def test_random_storm_property(seed, site, times):
    """Random (site, intensity, seed) storms on a fresh port session give
    results bit-identical to the numpy oracle or a typed QueryFailedError —
    never silent corruption."""
    skew = ":skew=2.5" if site == "clock_skew" else ""
    s = ta.Session(
        device="cpu",
        backend="fine/xla/aligned",
        max_batch=2,
        chunk=64,
        retry=tr.RetryPolicy(max_attempts=2, backoff_base_s=0.0),
        faults=tr.parse_faults(f"{site}:times={times}{skew};seed={seed}"),
    )
    g = rmat(5, 4, seed=seed % 7)
    fut = s.submit(ta.TrussQuery.decompose(torch_graph(g)))
    s.flush()
    try:
        dec = fut.result()
    except ta.QueryFailedError as e:
        assert e.query_id == fut.request.id
        assert e.cause is not None
    else:
        assert np.array_equal(dec.trussness, trussness_numpy(g))
