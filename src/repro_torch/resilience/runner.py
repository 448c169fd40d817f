"""ResilientRunner: per-query fault domains around one packed dispatch.

A packed batch is ONE device call over many users' graphs, so a naive
session turns any member's fault into everyone's failure.  The runner
wraps the dispatch with the taxonomy-keyed policy:

* :class:`~repro_torch.errors.InvalidGraphError` attributed to a member (by
  ``query_id`` or packed ``slot``) → **quarantine** that member with a
  terminal :class:`~repro_torch.errors.QueryFailedError` and re-dispatch the
  survivors — bit-identical by construction, because packed members are
  independent blocks of a disjoint union;
* :class:`~repro_torch.errors.DeviceError` (kernel fault / OOM) → **retry**
  with exponential backoff on the observability clock, up to
  ``policy.max_attempts`` per backend;
* :class:`~repro_torch.errors.CompileError` (or exhausted retries) → **fall
  back** down :func:`~repro_torch.api.registry.fallback_backends`
  (pallas→xla, fine→coarse) — safe because every registered backend is
  parity-tested bit-identical;
* unattributed fault with the whole chain exhausted → **bisect** the
  batch and recurse, so one poison member is isolated in O(log batch)
  dispatches instead of failing its batch-mates.

Every decision is counted in the session's metrics registry:
``retries``, ``backend_fallbacks{from,to}``, ``queries_quarantined``,
``batch_bisects``, ``dispatch_failures{site}``.

**The port's one deviation from** ``src/repro/resilience/runner.py``:
a *kernel fault* is terminal at once.  The planner decides what one is
and marks it ``kernel_fault`` (``repro_torch.api.planner.Planner.execute``):
a real failure — not injected, not bad input, not the peel's iteration
cap — raised while a hand-written CUDA kernel's backend runs on the card,
whether a kernel's launch returned an error, ``nvcc`` is missing or
failed, or its wrapper could not allocate its scratch.  The runner does
not retry it, step down the fallback chain or bisect: every query of the
batch gets a :class:`QueryFailedError` whose ``cause`` is the kernel fault
and whose ``backends_tried`` ends with the backend that ran;
``dispatch_failures{site=device|oom|compile}`` counts it, ``retries`` and
``backend_fallbacks`` do not move.  A failed CUDA launch is deterministic
(a refused cooperative grid) or sticky (an illegal address kills the
context), so a retry in the same process cannot help, and a fallback
would answer with the torch-ops twin — a hidden fallback the port does
not allow.  For the same reason the runner walks
``fallback_backends(key, device=...)``, which on the card never steps from
a hand-kernel backend to a torch-ops one.  Every other fault follows the
reference's policy exactly, so an injected ``compile`` fault on
``fine/fused/aligned`` still lands on ``fine/pallas/aligned``, which runs
a hand kernel too.

The runner is deliberately ignorant of queues, futures, and compile
caches — it drives a session-provided ``dispatch(PlannedBatch) ->
results`` callable and returns per-query outcomes;
:class:`repro_torch.api.Session` resolves futures from them.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Callable

from ..errors import (
    CompileError,
    DeviceError,
    InvalidGraphError,
    QueryFailedError,
    TrussError,
)
from ..obs import clock as obs_clock
from ..obs.metrics import MetricsRegistry, current_registry
from .retry import RetryPolicy

if TYPE_CHECKING:  # pragma: no cover — avoids a cycle: planner imports faults
    from ..api.planner import PlannedBatch, QueryState
    from ..api.registry import BackendKey

__all__ = ["Outcome", "ResilientRunner"]


class Outcome:
    """One query's verdict: ``result`` on success, typed ``error`` if not."""

    __slots__ = ("state", "result", "error")

    def __init__(self, state: QueryState, result: Any = None, error=None):
        self.state = state
        self.result = result
        self.error = error

    @property
    def ok(self) -> bool:
        return self.error is None

    def __repr__(self):
        verdict = "ok" if self.ok else f"error={type(self.error).__name__}"
        return f"Outcome(query={self.state.id}, {verdict})"


class ResilientRunner:
    """Runs planned batches through ``dispatch`` under a :class:`RetryPolicy`."""

    def __init__(
        self,
        dispatch: Callable[[PlannedBatch], list[Any]],
        *,
        policy: RetryPolicy | None = None,
        metrics: MetricsRegistry | None = None,
        device=None,
    ):
        self.dispatch = dispatch
        self.policy = policy or RetryPolicy()
        self._metrics = metrics
        self.device = device  # the session's: picks the fallback chain

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics or current_registry()

    # ------------------------------------------------------------------ #
    def run(self, planned: PlannedBatch) -> list[Outcome]:
        """Dispatch ``planned`` with isolation; one outcome per query,
        in the batch's order.  Only :class:`TrussError` faults are
        policy-handled — anything else propagates to the caller."""
        # Lazy: the registry lives in repro_torch.api, which imports this
        # module — a top-level import would make `import
        # repro_torch.resilience` depend on import order (repro_torch.serve
        # imports resilience before api).
        from ..api.registry import fallback_backends

        chain = [planned.backend]
        if self.policy.fallback:
            chain.extend(fallback_backends(planned.backend, device=self.device))
        outcomes: dict[int, Outcome] = {}
        self._run(planned, list(planned.queries), chain, outcomes)
        return [outcomes[st.id] for st in planned.queries]

    # ------------------------------------------------------------------ #
    def _rebatch(
        self, template: PlannedBatch, states: list[QueryState], backend: BackendKey
    ) -> PlannedBatch:
        for st in states:
            st.stats.backend = backend  # observability: the backend that ran
        return dataclasses.replace(template, backend=backend, queries=states)

    @staticmethod
    def _attribute(states: list[QueryState], err: TrussError) -> QueryState | None:
        """The member a fault names, by query id first, packed slot second."""
        if err.query_id is not None:
            for st in states:
                if st.id == err.query_id:
                    return st
        if err.slot is not None and 0 <= err.slot < len(states):
            return states[err.slot]
        return None

    def _terminal(
        self,
        st: QueryState,
        err: TrussError,
        *,
        attempts: int,
        backends_tried: list[BackendKey],
    ) -> QueryFailedError:
        return QueryFailedError(
            f"query {st.id} ({st.query.workload}) failed after {attempts} "
            f"attempt(s) over backends "
            f"{[str(b) for b in backends_tried]}: {err}",
            bucket=st.bucket,
            backend=backends_tried[-1] if backends_tried else st.backend,
            query_id=st.id,
            attempts=attempts,
            backends_tried=tuple(backends_tried),
            cause=err,
        )

    def _run(
        self,
        template: PlannedBatch,
        states: list[QueryState],
        chain: list[BackendKey],
        outcomes: dict[int, Outcome],
    ) -> None:
        if not states:
            return
        backends_tried: list[BackendKey] = []
        attempts = 0
        last_err: TrussError | None = None
        for ci, backend in enumerate(chain):
            if backends_tried:
                self.metrics.inc(
                    "backend_fallbacks",
                    **{"from": str(backends_tried[-1]), "to": str(backend)},
                )
            backends_tried.append(backend)
            attempt = 0
            while attempt < self.policy.max_attempts:
                attempt += 1
                attempts += 1
                try:
                    results = self.dispatch(self._rebatch(template, states, backend))
                    for st, res in zip(states, results):
                        outcomes[st.id] = Outcome(st, result=res)
                    return
                except InvalidGraphError as e:
                    last_err = e
                    self.metrics.inc("dispatch_failures", site="invalid")
                    culprit = self._attribute(states, e)
                    if culprit is not None:
                        # Deterministic, member-attributed: quarantine and
                        # re-dispatch the survivors (still on this chain
                        # position — the backend itself is not at fault).
                        self.metrics.inc("queries_quarantined")
                        outcomes[culprit.id] = Outcome(
                            culprit,
                            error=self._terminal(
                                culprit,
                                e,
                                attempts=attempts,
                                backends_tried=backends_tried,
                            ),
                        )
                        survivors = [s for s in states if s is not culprit]
                        self._run(template, survivors, chain[ci:], outcomes)
                        return
                    # Unattributed bad input: no backend will fix it — skip
                    # the rest of the chain and let bisection isolate it.
                    break
                except CompileError as e:
                    last_err = e
                    self.metrics.inc("dispatch_failures", site="compile")
                    if e.kernel_fault:
                        self._fail_all(states, e, attempts, backends_tried, outcomes)
                        return
                    break  # deterministic per backend: next chain entry
                except DeviceError as e:
                    last_err = e
                    self.metrics.inc(
                        "dispatch_failures", site="oom" if e.oom else "device"
                    )
                    if e.kernel_fault:
                        self._fail_all(states, e, attempts, backends_tried, outcomes)
                        return
                    if attempt >= self.policy.max_attempts:
                        break  # retries exhausted: next chain entry
                    self.metrics.inc("retries", backend=str(backend))
                    obs_clock.sleep(self.policy.delay(attempt))
            if isinstance(last_err, InvalidGraphError):
                break  # input-determined: don't walk more backends
        # Chain exhausted.  With several members and an unattributed fault,
        # split to isolate the poison member in O(log n) dispatches.
        if len(states) > 1 and self.policy.bisect:
            self.metrics.inc("batch_bisects")
            mid = len(states) // 2
            self._run(template, states[:mid], chain, outcomes)
            self._run(template, states[mid:], chain, outcomes)
            return
        self._fail_all(states, last_err, attempts, backends_tried, outcomes)

    def _fail_all(
        self,
        states: list[QueryState],
        err: TrussError,
        attempts: int,
        backends_tried: list[BackendKey],
        outcomes: dict[int, Outcome],
    ) -> None:
        for st in states:
            outcomes[st.id] = Outcome(
                st,
                error=self._terminal(
                    st,
                    err,
                    attempts=attempts,
                    backends_tried=backends_tried,
                ),
            )
