"""repro_torch.analysis — the port's static-analysis suite.

The reference's six rules (``repro.analysis``), pointed at
``src/repro_torch``, its tests (``tests/test_torch_*.py``) and
``chip_smoke.py``, with R1 restated for torch:

========  ==============================================================
R1        host syncs: no ``.item()``/``.cpu()``/``.numpy()``/``.tolist()``,
          ``bool()``/``int()``/``float()`` of a tensor, ``np.asarray`` of
          a tensor or ``synchronize()`` in the peel's hot path but the
          counted readbacks, and no readback of a packed tensor on the
          dispatch path before ``.peel``.
R2        recompile-hazard: every attribute the executor builder reads
          must be folded into the executor-cache variant key.
R3        lock-discipline: ``# guarded-by:`` annotated attributes only
          touched under their lock; no blocking call while holding a
          non-``io-lock`` lock.
R4        fault-site coverage: ``inject(site)`` literals exist in the
          port's ``FAULT_SITES`` and every site appears in a port test.
R5        metric-name drift: every metric name at every call site is
          declared in ``repro_torch.obs.names``.
R6        wire-schema safety: the error-context whitelist of
          ``repro_torch.serve.wire`` stays in sync with
          ``repro_torch.errors`` and every error class is re-raisable by
          name from a bare message.
========  ==============================================================

Findings carry stable fingerprints (line-number independent), so the
baseline (``src/repro_torch/analysis/baseline.json``) survives unrelated
drift.  A finding is silenced either by the baseline or by a trailing
``# trusslint: disable=R<n>`` comment on the flagged line.  The runtime
half of R2 is :mod:`repro_torch.analysis.sentinel`.

Run it from the repository's root: ``python -m repro_torch.analysis``
(with ``src`` on ``PYTHONPATH``).  The engine and the rules import only
the standard library.
"""

from .engine import (
    AnalysisConfig,
    AnalysisContext,
    Finding,
    apply_baseline,
    load_baseline,
    render_text,
    report_dict,
    run,
    write_baseline,
)

__all__ = [
    "AnalysisConfig",
    "AnalysisContext",
    "Finding",
    "apply_baseline",
    "load_baseline",
    "render_text",
    "report_dict",
    "run",
    "write_baseline",
]
