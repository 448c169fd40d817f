"""The program's own counters, for the per-layer readers that read them.

A traced run closes its session before the readers run, and every
session's registry chains to the process-global one
(``repro_torch.obs.get_registry()``), so the global counters hold the
whole traced process: the warm requests, the window and the profiled
stretch alike.  A ratio of two of them is ``None`` when either is absent
or the denominator is 0: a program that does not count a quantity reports
nothing under its name.
"""

from __future__ import annotations

__all__ = ["counters", "ratio", "times_launches_on_device"]


def counters() -> dict[str, float]:
    """The process-global counters, by name (labelled series under
    ``name{labels}``, as the registry's snapshot gives them)."""
    import repro_torch.obs as program_obs

    return program_obs.get_registry().snapshot()["counters"]


def ratio(numerator: str, denominator: str, *, scale: float = 1.0) -> float | None:
    found = counters()
    if numerator not in found or not found.get(denominator):
        return None
    return scale * found[numerator] / found[denominator]


def times_launches_on_device(ctx) -> bool:
    """Does the program's ``device_seconds_total`` hold device time?  On
    the card, where the program brackets its launches by CUDA events
    (``repro_torch.obs.device_time``); a program without that module
    counts the host wall under the name."""
    import importlib.util

    return ctx.device == "cuda" and importlib.util.find_spec("repro_torch.obs.device_time") is not None
