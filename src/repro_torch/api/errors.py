"""Typed errors of the declarative query API.

The taxonomy itself lives in :mod:`repro_torch.errors` (a dependency-free
module so low layers — ``graphs.csr`` validation, ``exec.peel`` — can
raise typed errors without import cycles); this module is its public
face on ``repro_torch.api``.  See :class:`repro_torch.errors.TrussError` for the
context contract every subclass carries (bucket / backend / slot /
query_id / injected) and :mod:`repro.resilience` for the policy layer
keyed on it.
"""

from __future__ import annotations

from ..errors import (
    CheckpointError,
    CompileError,
    DeviceError,
    InvalidGraphError,
    QueryFailedError,
    TrussError,
    TrussTimeoutError,
)

__all__ = [
    "TrussError",
    "InvalidGraphError",
    "CompileError",
    "DeviceError",
    "QueryFailedError",
    "TrussTimeoutError",
    "CheckpointError",
]
