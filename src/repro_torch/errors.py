"""Typed failure taxonomy for the whole serving stack.

Every failure the query path can surface is a :class:`TrussError` subclass
carrying enough context to *act* on — which shape bucket, which registry
backend, which packed slot / query — instead of a bare ``ValueError`` or
``RuntimeError`` that forces callers to parse messages.  The taxonomy is
what the resilience layer (``repro.resilience``) keys its policy on:

* :class:`InvalidGraphError` — the input itself is bad (malformed CSR,
  slot-capacity overflow, poisoned batch member).  Deterministic: never
  retried; the offending query is quarantined so its batch-mates survive.
* :class:`CompileError` — building/compiling a bucket's executable
  failed.  Deterministic for a given backend: not retried on the same
  backend, but the planner falls down the registry fallback chain
  (pallas→xla, fine→coarse) because every backend is bit-identical.
* :class:`DeviceError` — the dispatch itself failed (kernel fault,
  ``oom=True`` for resource exhaustion).  Potentially transient: retried
  with exponential backoff, then falls back.
* :class:`QueryFailedError` — the terminal per-query verdict after
  retries/fallbacks/bisection are exhausted; ``cause`` keeps the last
  underlying typed error.
* :class:`TrussTimeoutError` — a future's wait budget expired; with
  ``shed=True`` the query was marked dead and its slot reclaimed.
* :class:`CheckpointError` — a streaming checkpoint failed to write,
  parse, or verify (``repro.resilience.checkpoint``).

This module lives at the repo root of the ``repro_torch`` namespace (no
intra-repo imports) so low-level layers — ``graphs.csr`` validation,
``exec.peel`` — can raise typed errors without import cycles;
``repro_torch.api.errors`` re-exports the taxonomy as the public surface.
"""

from __future__ import annotations

__all__ = [
    "TrussError",
    "InvalidGraphError",
    "CompileError",
    "DeviceError",
    "QueryFailedError",
    "TrussTimeoutError",
    "CheckpointError",
]


class TrussError(Exception):
    """Base of the typed taxonomy; carries serving context as attributes.

    ``bucket`` / ``backend`` are the shape bucket and registry backend the
    failing work was assigned to (kept as their original objects, not
    stringified, so callers can compare against ``bucket_for`` /
    ``BackendKey`` values).  ``slot`` / ``query_id`` attribute a failure
    to one member of a packed batch — the hook batch fault isolation
    quarantines on.  ``injected=True`` marks faults raised by the
    fault-injection harness (``repro.resilience.faults``), which the
    chaos suite uses to tell injected failures from organic ones.

    ``kernel_fault=True`` is the port's own marker: the planner sets it on
    a real failure raised while a hand-written CUDA kernel's backend ran on
    the card, and the resilience runner fails the batch at once on it
    (``repro_torch.api.planner.Planner.execute``).  It is not part of the
    wire format.
    """

    kernel_fault = False

    def __init__(
        self,
        message: str,
        *,
        bucket=None,
        backend=None,
        slot: int | None = None,
        query_id: int | None = None,
        site: str | None = None,
        injected: bool = False,
        cause: BaseException | None = None,
    ):
        super().__init__(message)
        self.bucket = bucket
        self.backend = backend
        self.slot = slot
        self.query_id = query_id
        self.site = site
        self.injected = bool(injected)
        self.cause = cause

    def context(self) -> dict:
        """The non-empty context fields, JSON-friendly (for logs/metrics)."""
        out = {}
        for k in ("bucket", "backend", "slot", "query_id", "site"):
            v = getattr(self, k)
            if v is not None:
                out[k] = str(v) if k in ("bucket", "backend") else v
        if self.injected:
            out["injected"] = True
        return out


class InvalidGraphError(TrussError, ValueError):
    """The input graph (or one packed member) violates a CSR invariant.

    ``row`` is the first violating 1-based row and ``kind`` names the
    broken invariant (``rowptr_unsorted`` / ``rowptr_mismatch`` /
    ``col_range`` / ``self_loop`` / ``unsorted_row`` / ``duplicate`` /
    ...), so callers and tests can assert on *which* invariant failed.
    Subclasses ``ValueError`` so pre-taxonomy ``except ValueError``
    callers keep working.
    """

    def __init__(
        self,
        message: str,
        *,
        row: int | None = None,
        kind: str | None = None,
        graph: str | None = None,
        **ctx,
    ):
        super().__init__(message, **ctx)
        self.row = row
        self.kind = kind
        self.graph = graph


class CompileError(TrussError, RuntimeError):
    """Building or compiling a bucket's executable failed (deterministic
    per backend — the resilience layer falls back instead of retrying)."""


class DeviceError(TrussError, RuntimeError):
    """A device dispatch failed; ``oom=True`` flags resource exhaustion."""

    def __init__(self, message: str, *, oom: bool = False, **ctx):
        super().__init__(message, **ctx)
        self.oom = bool(oom)


class QueryFailedError(TrussError, RuntimeError):
    """Terminal per-query failure after the resilience policy is exhausted.

    ``attempts`` counts dispatch attempts made on this query's behalf and
    ``backends_tried`` the registry keys walked; ``cause`` is the last
    underlying typed error (``CompileError`` / ``DeviceError`` / ...).
    """

    def __init__(
        self,
        message: str,
        *,
        attempts: int = 0,
        backends_tried: tuple = (),
        **ctx,
    ):
        super().__init__(message, **ctx)
        self.attempts = int(attempts)
        self.backends_tried = tuple(backends_tried)


class TrussTimeoutError(TrussError, TimeoutError):
    """``TrussFuture.result(timeout=...)`` expired before the query resolved.

    Carries enough context to act on — which shape bucket the request was
    waiting in and how deep the session's queue was at expiry — instead of
    a bare ``TimeoutError`` that forces callers to re-derive both.
    ``shed=True`` means the session marked the query dead on expiry (the
    default): its queue slot was reclaimed and later ``result()`` calls
    re-raise this error instead of re-dispatching abandoned work.
    """

    def __init__(
        self,
        message: str,
        *,
        bucket=None,
        queue_depth: int = 0,
        request_id: int | None = None,
        waited_s: float = 0.0,
        shed: bool = False,
        **ctx,
    ):
        super().__init__(message, bucket=bucket, query_id=request_id, **ctx)
        self.queue_depth = int(queue_depth)
        self.request_id = request_id
        self.waited_s = float(waited_s)
        self.shed = bool(shed)


class CheckpointError(TrussError, RuntimeError):
    """A streaming checkpoint failed to write, parse, or verify."""

    def __init__(self, message: str, *, path: str | None = None, **ctx):
        super().__init__(message, **ctx)
        self.path = path
