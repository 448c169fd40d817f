"""The traced run's reductions: span sums and a profiler trace reduced to
busy time, device operations and named idle gaps."""

import pytest
import torch

from ktbench.devtrace import SpanSums, reduce_trace


def test_span_sums_add_by_name():
    sums = SpanSums()
    for _ in range(3):
        with sums.span("plan", workload="decompose") as sp:
            sp.attrs["bucket"] = 1
    with sums.span("dispatch"):
        pass
    snap = sums.snapshot()
    assert snap["plan"][1] == 3 and snap["dispatch"][1] == 1
    assert snap["plan"][0] >= 0.0


def _ev(name, ts, dur, cat):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat, "ph": "X"}


def test_reduce_trace_by_hand():
    events = [
        _ev("ktb:stretch", 0.0, 1000.0, "user_annotation"),
        _ev("ktb:plan", 0.0, 100.0, "user_annotation"),
        _ev("ktb:dispatch", 100.0, 800.0, "user_annotation"),
        _ev("aten::empty", 5.0, 5.0, "cpu_op"),  # host side: not device time
        _ev("peel_fused_kernel<1>", 200.0, 300.0, "kernel"),
        _ev("Memcpy DtoH", 600.0, 50.0, "gpu_memcpy"),
        _ev("peel_fused_kernel<1>", 640.0, 60.0, "kernel"),  # overlaps the copy by 10
        _ev("Memset", 950.0, 100.0, "gpu_memset"),  # runs past the stretch's end
    ]
    st = reduce_trace(events)
    assert st.window_s == pytest.approx(1e-3)
    # Busy: 300 + (600..700) 100 + (950..1000) 50 = 450 us.
    assert st.busy_s == pytest.approx(450e-6)
    assert st.device_seconds("peel_fused_kernel") == pytest.approx(360e-6)
    # Gaps: 0-100 in plan (100); 100-200, 500-600 and 700-900 in dispatch (400);
    # 900-950 outside the spans (50).
    assert st.gaps["plan"] == pytest.approx(100e-6)
    assert st.gaps["dispatch"] == pytest.approx(400e-6)
    assert st.gaps["outside the port's spans"] == pytest.approx(50e-6)
    bd = st.breakdown()
    assert bd["device_ops"][0] == ["peel_fused_kernel<1>", pytest.approx(360e-6)]
    assert bd["idle_gaps"][0][0] == "dispatch"


@pytest.mark.gpu
def test_reference_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ktbench import generators, reference

    n, raw = generators.rmat(12, 8, seed=3)
    e = generators.canonical(n, raw)
    assert (reference.trussness(n, e, "cuda") == reference.trussness(n, e, "cpu")).all()
