"""Retry/backoff policy for transient device faults.

One frozen dataclass holds every knob the :class:`~.runner.ResilientRunner`
consults, so a session's whole failure-handling posture is a single
``Session(retry=RetryPolicy(...))`` argument — and a test can turn the
policy into "no waiting, no fallback" in one place.

Backoff waits go through :func:`repro_torch.obs.clock.sleep`, i.e. the active
observability clock: under a :class:`~repro_torch.obs.clock.FakeClock` the wait
advances fake time and returns immediately, so retry tests never sleep.
"""

from __future__ import annotations

import dataclasses

__all__ = ["RetryPolicy"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard the runner fights before declaring a query failed.

    ``max_attempts``   — dispatch attempts per backend for transient
                         (:class:`~repro_torch.errors.DeviceError`) faults;
                         the first try counts, so 3 = 1 try + 2 retries.
    ``backoff_base_s`` — wait before the first retry; doubles (or
                         ``backoff_mult``-s) per retry, capped at
                         ``backoff_max_s``.
    ``fallback``       — walk the registry fallback chain
                         (pallas→xla, fine→coarse) on compile faults or
                         exhausted retries.  Safe because every
                         registered backend is parity-tested
                         bit-identical.
    ``bisect``         — on an unattributed batch fault, split the batch
                         and recurse to isolate the poisoned member
                         instead of failing everyone.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.01
    backoff_mult: float = 2.0
    backoff_max_s: float = 1.0
    fallback: bool = True
    bisect: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if self.backoff_mult < 1.0:
            raise ValueError(f"backoff_mult must be >= 1, got {self.backoff_mult}")

    def delay(self, attempt: int) -> float:
        """Seconds to wait before retry number ``attempt`` (1-based)."""
        if attempt < 1:
            return 0.0
        return min(
            self.backoff_max_s,
            self.backoff_base_s * self.backoff_mult ** (attempt - 1),
        )
