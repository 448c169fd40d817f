"""Port parity, resilience: ``repro_torch.resilience`` (fault injection, retry
policy, the resilient runner), the registry's fallback chain and
``Session(faults=, retry=)`` against the JAX package's, on the CPU.

Both packages get the same numpy graphs, the same ``FaultPlan`` text and the
same ``RetryPolicy``; results must be bit-identical, and the error types,
``query_id``, ``backends_tried`` and the resilience counters equal.  Last,
the port's one deviation: a real launch or build failure of a hand kernel
fails its batch at once, with no retry, fallback or bisection.
"""

import numpy as np
import pytest
import torch

import repro.api as ra
import repro.obs.clock as rclock
import repro.resilience as rr
import repro_torch.api as ta
import repro_torch.obs.clock as tclock
import repro_torch.resilience as tr
from _torch_parity import torch_graph
from repro.core import trussness_numpy
from repro.graphs import erdos
from repro.resilience.faults import poison_csr_arrays as ref_poison
from repro_torch.errors import CompileError, DeviceError
from repro_torch.resilience.faults import poison_csr_arrays as port_poison

COUNTERS = (
    "retries",
    "backend_fallbacks",
    "queries_quarantined",
    "batch_bisects",
    "faults_injected",
    "queries_failed",
)


class Pkg:
    """One package's surface, so a case runs the same code on both."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.api = ta if port else ra
        self.res = tr if port else rr
        self.clock = tclock if port else rclock
        self.device_kw = {"device": "cpu"} if port else {}
        self.graph = torch_graph if port else (lambda g: g)

    def session(self, **kw):
        return self.api.Session(**self.device_kw, **kw)


REF, PORT = Pkg("ref"), Pkg("port")


def tiny(seed=0):
    return erdos(50, 4.0, seed=seed)


def _arr(a):
    a = np.asarray(a)
    return (a.dtype.str, a.shape, a.tobytes())


def _oracle(g):
    """The numpy oracle's trussness, as an int32 record like the results'."""
    return _arr(trussness_numpy(g).astype(np.int32))


def outcome(fut):
    """A package-neutral record of one future's verdict."""
    try:
        r = fut.result()
    except Exception as e:
        cause = getattr(e, "cause", None)
        return (
            "err",
            type(e).__name__,
            getattr(e, "query_id", None) == fut.request.id,
            getattr(e, "attempts", None),
            tuple(str(b) for b in getattr(e, "backends_tried", ())),
            type(cause).__name__ if cause is not None else None,
            getattr(cause, "injected", None),
            getattr(cause, "site", None),
            getattr(cause, "oom", None),
        )
    if isinstance(r, int):
        return ("ok", r)
    if hasattr(r, "trussness"):
        return ("ok", _arr(r.trussness), r.kmax, r.levels)
    return ("ok", _arr(r.alive), _arr(r.support), r.iterations, r.edges_remaining)


def counters(s):
    st = s.stats()
    return {k: st[k] for k in COUNTERS}


def both(case):
    """Run ``case(pkg)`` on both packages; their records must be equal."""
    want, got = case(REF), case(PORT)
    assert got == want
    return got


# --------------------------------------------------------------------- #
# Fault plan mechanics, retry policy, fallback chain
# --------------------------------------------------------------------- #
def test_module_surfaces_match_the_reference():
    assert tr.__all__ == rr.__all__
    assert tr.FAULT_SITES == rr.FAULT_SITES
    assert tr.FAULTS_ENV_VAR == rr.FAULTS_ENV_VAR
    s_ref = ra.Session(backend="fine/xla/aligned", max_batch=1, chunk=64)
    s_port = ta.Session(backend="fine/xla/aligned", max_batch=1, chunk=64, device="cpu")
    assert set(s_port.stats()) == set(s_ref.stats())
    assert list(s_port.stats()) == list(s_ref.stats())


@pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
def test_fault_spec_gating_times_skip_where(pkg):
    def gates(p):
        plan = p.res.FaultPlan(
            [
                p.res.FaultSpec("dispatch", times=2, skip=1),
                p.res.FaultSpec("poison", times=None, where=(("query", 7),)),
            ]
        )
        seq = [plan.should_fire("dispatch", {}) is not None for _ in range(4)]
        seq += [
            plan.should_fire("poison", {"query": 3}) is not None,
            plan.should_fire("poison", {"query": 7}) is not None,
            plan.should_fire("poison", {"queries": (1, 7, 9), "query": 7}) is not None,
        ]
        fired = plan.fired()
        plan.reset()
        return seq, fired, plan.fired(), plan.should_fire("dispatch", {}) is None

    seq, fired, after, skipped = gates(pkg)
    assert (seq, fired, after, skipped) == gates(REF)
    assert seq == [False, True, True, False, False, True, True] and skipped


def test_fault_probability_fires_the_same_hits_in_both_packages():
    def draw(p, seed):
        plan = p.res.FaultPlan([p.res.FaultSpec("dispatch", times=None, p=0.5)], seed=seed)
        return [plan.should_fire("dispatch", {}) is not None for _ in range(48)]

    for seed in (0, 1, 2, 7, 11, 303):
        a = draw(PORT, seed)
        assert a == draw(REF, seed), seed
        assert any(a) and not all(a)
    assert draw(PORT, 1) != draw(PORT, 2)


@pytest.mark.parametrize(
    "text",
    [
        "dispatch:times=1;device_oom:skip=2:times=*:p=0.25;"
        "poison:where.query=7:msg=bad member;clock_skew:skew=9.5;seed=11",
        "compile:times=1:where.backend=fine/fused/aligned",
        "replica_kill:times=inf:where.replica=replica-1;network:p=0.5;seed=3",
        "",
    ],
)
def test_parse_faults_gives_equal_specs_and_seed(text):
    want, got = rr.parse_faults(text), tr.parse_faults(text)
    assert got.seed == want.seed
    assert [vars_of(s) for s in got.specs] == [vars_of(s) for s in want.specs]
    for bad in ("warp_core_breach", "dispatch:frequency=11", "dispatch:times"):
        with pytest.raises(ValueError):
            tr.parse_faults(bad)


def vars_of(spec):
    return (spec.site, spec.times, spec.skip, spec.p, spec.where, spec.skew_s, spec.message)


def test_faults_env_var(monkeypatch):
    monkeypatch.delenv("REPRO_FAULTS", raising=False)
    assert tr.FaultPlan.from_env() is None
    monkeypatch.setenv("REPRO_FAULTS", "dispatch:times=1;seed=5")
    plan = tr.FaultPlan.from_env()
    assert plan.seed == 5 and plan.specs[0].site == "dispatch"
    s = PORT.session(backend="fine/xla/aligned", max_batch=2, chunk=64)
    assert s.faults is not None and s.faults.specs[0].site == "dispatch"


def test_poison_corpus_matches_the_reference():
    g = erdos(40, 5.0, seed=1)
    kinds = set()
    for seed in range(32):
        want = ref_poison(g.n, g.rowptr, g.colidx, seed=seed)
        got = port_poison(g.n, g.rowptr, g.colidx, seed=seed)
        assert got[0] == want[0] and got[3] == want[3], seed
        assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
        assert np.array_equal(got[2], want[2]) and got[2].dtype == want[2].dtype
        kinds.add(got[3])
        # the port's validator reports the kind the corruptor promised
        with pytest.raises(ta.InvalidGraphError) as ei:
            from repro_torch.graphs import validate_csr

            validate_csr(got[0], got[1], got[2])
        assert ei.value.kind == got[3]
    assert len(kinds) >= 4


def test_retry_policy_delay_matches_the_reference():
    for kw in ({}, {"backoff_base_s": 0.01, "backoff_mult": 2.0, "backoff_max_s": 0.05},
               {"backoff_base_s": 0.5, "backoff_mult": 1.0}):
        want, got = rr.RetryPolicy(**kw), tr.RetryPolicy(**kw)
        assert [got.delay(i) for i in range(7)] == [want.delay(i) for i in range(7)]
    with pytest.raises(ValueError):
        tr.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        tr.RetryPolicy(backoff_mult=0.5)


def test_fallback_chain_equals_the_reference_for_every_key():
    keys = [str(k) for k in ra.available_backends()]
    assert keys == [str(k) for k in ta.available_backends()]
    for key in keys:
        assert [str(k) for k in ta.fallback_backends(key)] == [
            str(k) for k in ra.fallback_backends(key)
        ], key
    assert ta.fallback_backends("fine/fused/aligned") == (
        ta.BackendKey("fine", "pallas", "aligned"),
        ta.BackendKey("fine", "xla", "aligned"),
        ta.BackendKey("coarse", "xla", "aligned"),
    )
    assert ta.fallback_backends("coarse/xla/contig") == ()


def test_compile_cache_wraps_failed_executor_builds():
    cache = ta.CompileCache(lambda key: (_ for _ in ()).throw(RuntimeError("no exe")))
    with pytest.raises(ta.CompileError) as ei:
        cache.get(("bucket",), 1, "variant")
    assert "no exe" in str(ei.value)
    assert cache.stats.compiles == 0  # failed builds are not compiles


def test_use_plan_scoping():
    plan = tr.FaultPlan([tr.FaultSpec("dispatch", times=None)])
    with tr.use_plan(plan):
        with tr.use_plan(None):
            assert tr.current_plan() is None
        assert tr.current_plan() is plan
        # the two packages' plans are separate context variables
        assert rr.current_plan() is None


# --------------------------------------------------------------------- #
# Batch fault isolation end to end (tests/test_resilience.py, section e)
# --------------------------------------------------------------------- #
def test_transient_dispatch_fault_is_retried_under_fake_time():
    def case(p):
        g = p.graph(tiny())
        clk = p.clock.FakeClock()
        with p.clock.use_clock(clk):
            s = p.session(
                backend="fine/xla/aligned",
                max_batch=2,
                chunk=64,
                faults=p.res.FaultPlan([p.res.FaultSpec("dispatch", times=1)]),
                retry=p.res.RetryPolicy(backoff_base_s=0.5),
            )
            fut = s.submit(p.api.TrussQuery.decompose(g))
            s.flush()
        return outcome(fut), counters(s), clk.now() >= 0.5

    rec = both(case)
    assert rec[0][0] == "ok" and rec[0][1] == _oracle(tiny())
    assert rec[1]["retries"] == 1 and rec[1]["faults_injected"] == 1 and rec[2]


def test_oom_fault_exhausts_retries_then_falls_back():
    def case(p):
        s = p.session(
            backend="fine/xla/aligned",
            max_batch=2,
            chunk=64,
            faults=p.res.FaultPlan([p.res.FaultSpec("device_oom", times=None)]),
            retry=p.res.RetryPolicy(max_attempts=2, backoff_base_s=0.0),
        )
        fut = s.submit(p.api.TrussQuery.decompose(p.graph(tiny())))
        s.flush()
        return outcome(fut), counters(s)

    (rec, cnt) = both(case)
    assert rec[:3] == ("err", "QueryFailedError", True)
    assert rec[4] == ("fine/xla/aligned", "coarse/xla/aligned")
    assert rec[5] == "DeviceError" and rec[8] is True
    assert cnt["backend_fallbacks"] == 1 and cnt["queries_failed"] == 1


def test_compile_fault_falls_back_bit_identically():
    def case(p):
        s = p.session(
            backend="fine/xla/aligned",
            max_batch=2,
            chunk=64,
            faults=p.res.FaultPlan([p.res.FaultSpec("compile", times=1)]),
            retry=p.res.RetryPolicy(backoff_base_s=0.0),
        )
        fut = s.submit(p.api.TrussQuery.decompose(p.graph(tiny())))
        s.flush()
        return outcome(fut), counters(s), [r["backend"] for r in s.stats()["planner_backends"]]

    rec, cnt, _ = both(case)
    assert rec[1] == _oracle(tiny())
    assert cnt["backend_fallbacks"] == 1 and cnt["retries"] == 0


def test_poisoned_fused_compile_lands_on_xla_bit_identically():
    def case(p):
        s = p.session(
            backend="fine/fused/aligned",
            max_batch=2,
            chunk=64,
            faults=p.res.parse_faults(
                "compile:times=1:where.backend=fine/fused/aligned;"
                "compile:times=1:where.backend=fine/pallas/aligned"
            ),
            retry=p.res.RetryPolicy(backoff_base_s=0.0),
        )
        fut = s.submit(p.api.TrussQuery.decompose(p.graph(tiny())))
        s.flush()
        return outcome(fut), counters(s), str(fut.stats.backend)

    rec, cnt, ran = both(case)
    assert rec[1] == _oracle(tiny())
    assert cnt["backend_fallbacks"] == 2 and cnt["retries"] == 0
    assert ran == "fine/xla/aligned"


def test_poison_member_quarantined_survivors_bit_identical():
    def case(p):
        gs = [p.graph(tiny(seed=i)) for i in range(3)]
        s = p.session(
            backend="fine/xla/aligned", max_batch=4, chunk=64,
            retry=p.res.RetryPolicy(backoff_base_s=0.0),
        )
        futs = [s.submit(p.api.TrussQuery.decompose(g)) for g in gs]
        target = futs[1].request.id
        s.faults = p.res.parse_faults(f"poison:times=*:where.query={target}")
        s.flush()
        return [outcome(f) for f in futs], counters(s)

    recs, cnt = both(case)
    assert recs[1][:3] == ("err", "QueryFailedError", True)
    assert recs[1][5:7] == ("InvalidGraphError", True)
    for i in (0, 2):
        assert recs[i][1] == _oracle(tiny(seed=i))
    assert cnt["queries_quarantined"] == 1 and cnt["queries_failed"] == 1


def test_unattributed_fault_bisects_to_isolate():
    def case(p):
        s = p.session(
            backend="fine/xla/aligned",
            max_batch=4,
            chunk=64,
            faults=p.res.FaultPlan([p.res.FaultSpec("dispatch", times=None)]),
            retry=p.res.RetryPolicy(max_attempts=1, backoff_base_s=0.0),
        )
        futs = [s.submit(p.api.TrussQuery.decompose(p.graph(tiny(seed=i)))) for i in range(4)]
        s.flush()
        return [outcome(f) for f in futs], counters(s)

    recs, cnt = both(case)
    assert all(r[1] == "QueryFailedError" for r in recs)
    assert cnt["batch_bisects"] >= 1 and cnt["queries_failed"] == 4


def test_clock_skew_fault_advances_fake_clock_only():
    def case(p):
        clk = p.clock.FakeClock()
        with p.clock.use_clock(clk):
            s = p.session(
                backend="fine/xla/aligned",
                max_batch=2,
                chunk=64,
                faults=p.res.FaultPlan([p.res.FaultSpec("clock_skew", times=1, skew_s=123.0)]),
                retry=p.res.RetryPolicy(backoff_base_s=0.0),
            )
            fut = s.submit(p.api.TrussQuery.decompose(p.graph(tiny())))
            s.flush()
            skewed = clk.now() >= 123.0
        return outcome(fut), counters(s), skewed

    rec, cnt, skewed = both(case)
    assert skewed and cnt["faults_injected"] == 1
    assert rec[1] == _oracle(tiny())


def test_peel_iteration_cap_is_a_typed_device_error():
    def case(p):
        s = p.session(
            backend="fine/xla/aligned",
            max_batch=1,
            chunk=64,
            max_iters=1,
            retry=p.res.RetryPolicy(max_attempts=1, backoff_base_s=0.0, fallback=False),
        )
        fut = s.submit(p.api.TrussQuery.decompose(p.graph(erdos(60, 6.0, seed=2))))
        s.flush()
        return outcome(fut), counters(s)

    rec, _ = both(case)
    assert rec[1] == "QueryFailedError" and rec[5] == "DeviceError" and rec[7] == "peel"


def test_stream_update_failure_surfaces_as_query_failed():
    """A stream update whose re-peel fails resolves to the reference's
    ``QueryFailedError`` and leaves the committed state alone."""

    def case(p):
        g = p.graph(erdos(40, 5.0, seed=0))
        policy = p.res.RetryPolicy(max_attempts=1, backoff_base_s=0.0, fallback=False)
        stream_mod = __import__(p.api.__name__.replace(".api", ".stream"), fromlist=["x"])
        st = stream_mod.StreamingTrussSession.for_graph(
            g, **p.device_kw, backend="fine/xla/aligned", chunk=64, retry=policy
        )
        assert st.api.retry is policy  # the session knobs pass through
        before = np.asarray(st.trussness).copy()
        st.api.faults = p.res.parse_faults("dispatch:times=*")
        pend = st.submit_update(st_batch(p, g))
        with pytest.raises(Exception) as ei:
            pend.result()
        return type(ei.value).__name__, type(ei.value.cause).__name__, bool(
            np.array_equal(np.asarray(st.trussness), before)
        )

    assert both(case) == ("QueryFailedError", "DeviceError", True)


def st_batch(p, g):
    mod = __import__(p.api.__name__.replace(".api", ".stream"), fromlist=["EdgeBatch"])
    u, v = (g.edge_list()[0] - 1).tolist()
    return mod.EdgeBatch.of([], [(u, v)])


# --------------------------------------------------------------------- #
# The port's deviation: a hand kernel's own fault is terminal at once
# --------------------------------------------------------------------- #
def _as_if_on_the_card(monkeypatch):
    """Let a CPU session take its hand-kernel backends for the card's.

    The kernel-fault rule and the fallback chain read one predicate,
    ``registry.runs_hand_kernel``; patched to answer for CUDA, it makes the
    CPU session, whose wrappers' places are held by their plain versions,
    drive the rule as a session on the card does."""
    import repro_torch.api.planner as tplanner
    import repro_torch.api.registry as treg

    real = treg.runs_hand_kernel

    def on_card(key, device):
        return real(key, "cuda")

    monkeypatch.setattr(treg, "runs_hand_kernel", on_card)
    monkeypatch.setattr(tplanner, "runs_hand_kernel", on_card)


def _kernel_fault_session(monkeypatch, backend, err, *, on_card=True):
    """A CPU session on ``backend`` whose hand-kernel step raises ``err``
    (the fused level's plain version for ``fused``, the support kernel's
    for ``pallas``: the functions the CUDA wrappers' places hold on CPU)."""
    import repro_torch.kernels.ops as kops
    import repro_torch.kernels.peel_fused as kpf

    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise err

    if on_card:
        _as_if_on_the_card(monkeypatch)
    if backend == "fine/fused/aligned":
        monkeypatch.setattr(kpf, "fused_level_torch", boom)
    else:
        monkeypatch.setattr(kops, "support_fine_owner", boom)
    s = PORT.session(backend=backend, max_batch=4, chunk=64, retry=tr.RetryPolicy(backoff_base_s=0.0))
    return s, calls


@pytest.mark.parametrize(
    "backend, err",
    [
        ("fine/fused/aligned", DeviceError("launch failed (cudaError 720)", site="fused_level")),
        ("fine/pallas/aligned", DeviceError("launch failed (cudaError 9)", site="support_fine")),
        ("fine/fused/aligned", CompileError("nvcc failed", site="kernel_build")),
        ("fine/pallas/aligned", CompileError("nvcc not found", site="kernel_build")),
    ],
    ids=["fused_level", "support_fine", "build-fused", "build-pallas"],
)
def test_kernel_fault_fails_the_batch_with_no_retry_or_fallback(monkeypatch, backend, err):
    assert not err.injected and not err.kernel_fault
    s, calls = _kernel_fault_session(monkeypatch, backend, err)
    gs = [torch_graph(tiny(seed=i)) for i in (0, 1, 3)]  # one bucket: one batch
    futs = [s.submit(ta.TrussQuery.decompose(g)) for g in gs]
    s.flush()
    for f in futs:
        with pytest.raises(ta.QueryFailedError) as ei:
            f.result()
        e = ei.value
        assert e.cause is err and e.cause.kernel_fault and e.query_id == f.request.id
        assert tuple(str(b) for b in e.backends_tried) == (backend,)
        assert e.attempts == 1
    assert calls["n"] == 1  # one attempt, no retry
    cnt = counters(s)
    assert cnt == {
        "retries": 0, "backend_fallbacks": 0, "queries_quarantined": 0,
        "batch_bisects": 0, "faults_injected": 0, "queries_failed": 3,
    }
    site = "compile" if isinstance(err, CompileError) else "device"
    assert s.obs.metrics.value("dispatch_failures", site=site) == 1
    # no other backend's executor was built: the torch-ops twin never ran
    assert s.cache.stats.compiles == 1
    assert s.device_dispatches == 0
    # the same session serves again once the kernel works
    monkeypatch.undo()
    g = gs[0]
    dec = s.solve([ta.TrussQuery.decompose(g)])[0]
    assert np.array_equal(dec.trussness, trussness_numpy(tiny(seed=0)))


@pytest.mark.parametrize(
    "err, site, oom",
    [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 4.00 TiB"), "oom", True),
        (ValueError("stamps must be a contiguous (8,) int64 tensor"), "device", False),
        (DeviceError("no kernel site"), "device", False),
    ],
    ids=["scratch-oom", "wrapper-check", "siteless-device"],
)
def test_any_real_fault_under_a_hand_kernel_on_the_card_is_terminal(monkeypatch, err, site, oom):
    """Not only the wrappers' typed launch errors: anything real raised
    while a hand kernel's backend runs on the card (an OOM allocating its
    scratch, a wrapper's argument check, a device error with no site)
    fails the batch at once, and no plain version answers."""
    s, calls = _kernel_fault_session(monkeypatch, "fine/fused/aligned", err)
    g = tiny(seed=4)
    fut = s.submit(ta.TrussQuery.decompose(torch_graph(g)))
    s.flush()
    with pytest.raises(ta.QueryFailedError) as ei:
        fut.result()
    cause = ei.value.cause
    assert isinstance(cause, DeviceError) and cause.kernel_fault and not cause.injected
    assert cause.oom == oom and (cause is err or cause.cause is err)
    assert tuple(str(b) for b in ei.value.backends_tried) == ("fine/fused/aligned",)
    assert calls["n"] == 1
    assert (s.retries, s.backend_fallbacks, s.batch_bisects) == (0, 0, 0)
    assert s.obs.metrics.value("dispatch_failures", site=site) == 1
    assert s.cache.stats.compiles == 1


@pytest.mark.parametrize(
    "err, fallbacks, retries",
    [
        (DeviceError("injected", site="fused_level", injected=True), 1, 2),
        (CompileError("injected", site="kernel_build", injected=True), 1, 0),
        (DeviceError("no kernel site"), 1, 2),
    ],
    ids=["injected-device", "injected-build", "siteless-device"],
)
def test_injected_or_siteless_faults_walk_the_chain(monkeypatch, err, fallbacks, retries):
    """Off the card no hand kernel runs, so the reference's policy holds
    for every fault; an injected one walks the chain on the card too."""
    s, calls = _kernel_fault_session(monkeypatch, "fine/fused/aligned", err, on_card=err.injected)
    g = tiny(seed=4)
    fut = s.submit(ta.TrussQuery.decompose(torch_graph(g)))
    s.flush()
    assert np.array_equal(fut.result().trussness, trussness_numpy(g))
    assert s.backend_fallbacks == fallbacks and s.retries == retries
    assert calls["n"] == 1 + retries
    assert str(fut.stats.backend) == "fine/pallas/aligned"


def test_iteration_cap_on_the_card_is_not_a_kernel_fault(monkeypatch):
    """The peel's iteration cap is the reference's retried, stepped-down
    fault on the card too; the step lands on the other hand kernel."""
    err = DeviceError("peel hit the iteration cap", site="peel")
    s, calls = _kernel_fault_session(monkeypatch, "fine/fused/aligned", err)
    g = tiny(seed=4)
    fut = s.submit(ta.TrussQuery.decompose(torch_graph(g)))
    s.flush()
    assert np.array_equal(fut.result().trussness, trussness_numpy(g))
    assert not err.kernel_fault
    assert (s.retries, s.backend_fallbacks, calls["n"]) == (2, 1, 3)
    assert str(fut.stats.backend) == "fine/pallas/aligned"


def test_fallback_chain_on_the_card_never_reaches_torch_ops():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for key in ta.available_backends():
        assert ta.fallback_backends(key, device=cpu) == ta.fallback_backends(key), key
        on_card = ta.fallback_backends(key, device=cuda)
        if key.kernel == "xla":
            assert on_card == ta.fallback_backends(key), key
        else:
            assert all(k.kernel != "xla" for k in on_card), key
    assert ta.fallback_backends("fine/fused/aligned", device=cuda) == (
        ta.BackendKey("fine", "pallas", "aligned"),
    )
    assert ta.fallback_backends("fine/pallas/contig", device=cuda) == ()


def test_a_lasting_injected_fault_on_the_card_ends_on_hand_kernels(monkeypatch):
    """``compile:times=*`` walks fused -> pallas on the card and fails
    there; off the card it walks the reference's whole chain."""

    def tried(on_card):
        if on_card:
            _as_if_on_the_card(monkeypatch)
        s = PORT.session(
            backend="fine/fused/aligned", max_batch=4, chunk=64,
            retry=tr.RetryPolicy(backoff_base_s=0.0),
            faults=tr.parse_faults("compile:times=*"),
        )
        fut = s.submit(ta.TrussQuery.decompose(torch_graph(tiny(seed=2))))
        s.flush()
        with pytest.raises(ta.QueryFailedError) as ei:
            fut.result()
        assert ei.value.cause.injected and not ei.value.cause.kernel_fault
        monkeypatch.undo()
        return [str(b) for b in ei.value.backends_tried]

    assert tried(True) == ["fine/fused/aligned", "fine/pallas/aligned"]
    assert tried(False) == [
        "fine/fused/aligned", "fine/pallas/aligned", "fine/xla/aligned", "coarse/xla/aligned",
    ]
