"""Deterministic fault injection for the batched peel path.

The chaos suite needs to drive every failure path — compile error,
device OOM, dispatch exception, poisoned batch member, clock skew — on
demand and *reproducibly*, so a failing chaos seed can be replayed
byte-for-byte.  This module is the harness:

* a :class:`FaultSpec` names one **site** plus firing rules (fire the
  first N times, skip the first M hits, fire with probability p under a
  seeded RNG, fire only when context fields match ``where``);
* a :class:`FaultPlan` bundles specs with a seed and is threaded through
  ``Session(faults=...)`` — or picked up process-wide from the
  ``REPRO_FAULTS`` env var (:func:`FaultPlan.from_env`);
* production code calls :func:`inject` at its fault sites with whatever
  context it has (bucket, backend, slot, query id).  With no active plan
  the call is a cheap no-op; with one, matching specs raise the mapped
  typed error (marked ``injected=True``) or perform their action
  (clock skew advances the active :class:`~repro_torch.obs.clock.FakeClock`).

Sites and their mapped failures:

========== ==============================================================
site        effect
========== ==============================================================
compile     :class:`~repro_torch.errors.CompileError` before the bucket's
            executable is built — exercises registry fallback.
device_oom  :class:`~repro_torch.errors.DeviceError` with ``oom=True`` before
            dispatch — exercises retry/backoff then fallback.
dispatch    :class:`~repro_torch.errors.DeviceError` before dispatch —
            generic kernel fault, same retry path.
poison      :class:`~repro_torch.errors.InvalidGraphError` attributed to one
            packed member — exercises quarantine + survivor re-dispatch.
clock_skew  no exception: advances the active FakeClock by ``skew_s``
            (real clocks are left alone) — exercises deadline/timeout
            handling under time jumps.
network     :class:`~repro_torch.errors.DeviceError` at a serving-tier RPC
            boundary (``repro_torch.serve``) — exercises router re-route and
            replica quarantine.
replica_kill no exception: an *action* site — the fleet chaos storm
            polls it (``if inject("replica_kill", replica=...)``) and
            kills the named replica process when it fires, exercising
            warm stream handoff to a survivor.
========== ==============================================================

Every fired fault is counted in the current metrics registry as
``faults_injected{site=...}``; :func:`inject` returns the fired
:class:`FaultSpec` (``None`` when nothing fired) so action sites can
react without a raise.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
import threading
import zlib

import numpy as np

from ..errors import CompileError, DeviceError, InvalidGraphError
from ..obs import clock as obs_clock
from ..obs.clock import FakeClock
from ..obs.metrics import current_registry

__all__ = [
    "FAULT_SITES",
    "FAULTS_ENV_VAR",
    "FaultSpec",
    "FaultPlan",
    "parse_faults",
    "current_plan",
    "use_plan",
    "inject",
    "poison_csr_arrays",
]

FAULT_SITES = (
    "compile",
    "dispatch",
    "device_oom",
    "poison",
    "clock_skew",
    "network",
    "replica_kill",
)
FAULTS_ENV_VAR = "REPRO_FAULTS"


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: fire at ``site`` when the gates all pass.

    ``times``     — fire at most this many times (``None`` = unlimited).
    ``skip``      — let the first ``skip`` matching hits through unharmed
                    (e.g. ``skip=1`` faults the *second* dispatch only).
    ``p``         — fire probability per hit, decided by a seeded RNG so
                    the same plan replays identically.
    ``where``     — ``((key, value), ...)`` context gates; a hit only
                    counts when every key is present in the injection
                    context and matches (equality, or membership when the
                    context value is a tuple/list — e.g. ``("query", 7)``
                    matches a batch whose ``queries`` tuple contains 7).
    ``skew_s``    — clock_skew only: seconds to advance the fake clock.
    ``message``   — override the raised error's message.
    """

    site: str
    times: int | None = 1
    skip: int = 0
    p: float = 1.0
    where: tuple[tuple[str, object], ...] = ()
    skew_s: float = 0.0
    message: str | None = None

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; expected one of {FAULT_SITES}"
            )
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault probability must be in [0, 1], got {self.p}")

    def matches(self, ctx: dict) -> bool:
        for key, want in self.where:
            if key not in ctx:
                return False
            have = ctx[key]
            if isinstance(have, (tuple, list, set, frozenset)):
                if want not in have:
                    return False
            elif have != want:
                return False
        return True


class FaultPlan:
    """A seeded set of :class:`FaultSpec`\\ s with per-spec firing state.

    The plan is mutable state (hit/fire counters advance as sites are
    visited) guarded by a lock, so one plan can be shared by a session's
    worker threads.  ``reset()`` rewinds the counters for replay.
    """

    def __init__(self, specs: tuple[FaultSpec, ...] | list[FaultSpec] = (), seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._hits = [0] * len(self.specs)
        self._fired = [0] * len(self.specs)

    @classmethod
    def from_env(cls, env: str | None = None) -> "FaultPlan | None":
        """Build a plan from ``REPRO_FAULTS`` (or ``env``); None if unset."""
        text = os.environ.get(FAULTS_ENV_VAR) if env is None else env
        if not text or not text.strip():
            return None
        return parse_faults(text)

    def reset(self) -> None:
        with self._lock:
            self._hits = [0] * len(self.specs)
            self._fired = [0] * len(self.specs)

    def fired(self, site: str | None = None) -> int:
        """How many faults have fired (optionally for one site)."""
        with self._lock:
            return sum(
                f
                for s, f in zip(self.specs, self._fired)
                if site is None or s.site == site
            )

    def should_fire(self, site: str, ctx: dict) -> FaultSpec | None:
        """Advance firing state for ``site``; the spec to fire, or None."""
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site or not spec.matches(ctx):
                    continue
                hit = self._hits[i]
                self._hits[i] += 1
                if hit < spec.skip:
                    continue
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if spec.p < 1.0:
                    # Seeded per (plan seed, spec index, hit ordinal, site):
                    # the same plan replayed fires at the same hits.
                    rng = np.random.default_rng(
                        (self.seed, i, hit, zlib.crc32(site.encode()))
                    )
                    if rng.random() >= spec.p:
                        continue
                self._fired[i] += 1
                return spec
        return None

    def __repr__(self):
        return f"FaultPlan(specs={self.specs!r}, seed={self.seed})"


_current_plan: contextvars.ContextVar[FaultPlan | None] = contextvars.ContextVar(
    "repro_fault_plan", default=None
)


def current_plan() -> FaultPlan | None:
    """The context-active fault plan (None in production)."""
    return _current_plan.get()


@contextlib.contextmanager
def use_plan(plan: FaultPlan | None):
    """Scoped plan install: ``with use_plan(plan): session work``.

    Installing ``None`` explicitly masks any outer plan, so nested
    fault-free scopes (e.g. an oracle run inside a chaos test) work.
    """
    token = _current_plan.set(plan)
    try:
        yield plan
    finally:
        _current_plan.reset(token)


def inject(site: str, **ctx) -> FaultSpec | None:
    """Fault site hook: raise/act if the active plan says so, else no-op.

    Call this from production code at each site with whatever context is
    known (``bucket=``, ``backend=``, ``slot=``, ``query=``,
    ``queries=``, ``replica=``).  Exception sites raise typed errors
    with ``injected=True``; action sites (``clock_skew`` performs the
    skew, ``replica_kill`` leaves the action to the caller) return the
    fired spec so call sites can react — ``None`` means nothing fired.
    """
    plan = _current_plan.get()
    if plan is None:
        return None
    spec = plan.should_fire(site, ctx)
    if spec is None:
        return None
    current_registry().inc("faults_injected", site=site)
    bucket = ctx.get("bucket")
    backend = ctx.get("backend")
    msg = spec.message or f"injected fault at site {site!r}"
    if site == "clock_skew":
        clk = obs_clock.get_clock()
        if isinstance(clk, FakeClock):
            clk.advance(max(0.0, float(spec.skew_s)))
        return spec
    if site == "replica_kill":
        # Pure action site: the fleet's monitor polls it and does the
        # killing itself — there is no in-process exception to raise.
        return spec
    if site == "network":
        raise DeviceError(
            msg, backend=backend, site=site, injected=True
        )
    if site == "compile":
        raise CompileError(
            msg, bucket=bucket, backend=backend, site=site, injected=True
        )
    if site == "device_oom":
        raise DeviceError(
            msg, oom=True, bucket=bucket, backend=backend, site=site, injected=True
        )
    if site == "dispatch":
        raise DeviceError(
            msg, bucket=bucket, backend=backend, site=site, injected=True
        )
    if site == "poison":
        raise InvalidGraphError(
            msg,
            kind="poisoned",
            bucket=bucket,
            backend=backend,
            slot=ctx.get("slot"),
            query_id=ctx.get("query"),
            site=site,
            injected=True,
        )
    raise AssertionError(f"unhandled fault site {site!r}")  # pragma: no cover


# ---------------------------------------------------------------------- #
# REPRO_FAULTS parsing
# ---------------------------------------------------------------------- #
# Grammar (semicolon-separated clauses):
#   REPRO_FAULTS="dispatch:times=1;device_oom:skip=2:times=1;seed=7"
#   clause  := site (":" option)*   |   "seed=" int
#   option  := "times=" (int|"inf"|"*") | "skip=" int | "p=" float
#            | "skew=" float | "where.<key>=" value | "msg=" text
# Values for where.<key> are parsed as int when possible, else kept as
# strings (backend/bucket gates compare against str(ctx value)).


def parse_faults(text: str) -> FaultPlan:
    """Parse the ``REPRO_FAULTS`` mini-language into a :class:`FaultPlan`."""
    specs: list[FaultSpec] = []
    seed = 0
    for clause in text.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        if clause.startswith("seed="):
            seed = int(clause[len("seed="):])
            continue
        parts = clause.split(":")
        site = parts[0].strip()
        kw: dict = {"site": site}
        where: list[tuple[str, object]] = []
        for opt in parts[1:]:
            opt = opt.strip()
            if not opt:
                continue
            if "=" not in opt:
                raise ValueError(f"bad fault option {opt!r} in clause {clause!r}")
            key, val = opt.split("=", 1)
            key = key.strip()
            val = val.strip()
            if key == "times":
                kw["times"] = None if val in ("inf", "*") else int(val)
            elif key == "skip":
                kw["skip"] = int(val)
            elif key == "p":
                kw["p"] = float(val)
            elif key == "skew":
                kw["skew_s"] = float(val)
            elif key == "msg":
                kw["message"] = val
            elif key.startswith("where."):
                field = key[len("where."):]
                try:
                    parsed: object = int(val)
                except ValueError:
                    parsed = val
                where.append((field, parsed))
            else:
                raise ValueError(f"unknown fault option {key!r} in clause {clause!r}")
        kw["where"] = tuple(where)
        specs.append(FaultSpec(**kw))
    return FaultPlan(tuple(specs), seed=seed)


# ---------------------------------------------------------------------- #
# Malformed-graph corpus for validation tests
# ---------------------------------------------------------------------- #
POISON_KINDS = ("col_range", "self_loop", "duplicate", "unsorted_row", "rowptr_unsorted")


def poison_csr_arrays(
    n: int, rowptr: np.ndarray, colidx: np.ndarray, *, seed: int = 0
) -> tuple[int, np.ndarray, np.ndarray, str]:
    """Deterministically corrupt a valid CSR into ``(n, rowptr, colidx, kind)``.

    Picks one invariant violation by seed and applies it to copies of the
    inputs, returning the :class:`~repro_torch.errors.InvalidGraphError` kind
    the validator must report.  Used by the chaos/validation tests to
    cover every branch of ``validate_csr`` from real graph shapes.
    """
    rowptr = np.array(rowptr, copy=True)
    colidx = np.array(colidx, copy=True)
    nnz = int(colidx.shape[0])
    if nnz == 0:
        raise ValueError("cannot poison an empty graph")
    rng = np.random.default_rng(seed)
    # Only pick kinds that are expressible on this shape.
    kinds = [k for k in POISON_KINDS if k != "rowptr_unsorted" or n >= 2]
    kind = kinds[int(rng.integers(len(kinds)))]
    e = int(rng.integers(nnz))
    if kind == "col_range":
        colidx[e] = n + 1 + int(rng.integers(3))
    elif kind == "self_loop":
        row = int(np.searchsorted(rowptr, e, side="right"))  # 1-based row of e
        colidx[e] = row
    elif kind == "duplicate":
        counts = np.diff(rowptr)
        wide = np.flatnonzero(counts >= 2)
        if wide.size == 0:
            colidx[e] = n + 1  # no row can hold a duplicate; degrade
            kind = "col_range"
        else:
            r = int(wide[int(rng.integers(wide.size))])
            colidx[rowptr[r] + 1] = colidx[rowptr[r]]
    elif kind == "unsorted_row":
        counts = np.diff(rowptr)
        wide = np.flatnonzero(counts >= 2)
        if wide.size == 0:
            colidx[e] = n + 1
            kind = "col_range"
        else:
            r = int(wide[int(rng.integers(wide.size))])
            a, b = int(rowptr[r]), int(rowptr[r]) + 1
            if colidx[a] == colidx[b]:
                kind = "duplicate"  # already equal: swap is a no-op
            colidx[a], colidx[b] = colidx[b], colidx[a]
    elif kind == "rowptr_unsorted":
        # Either dent rowptr[r] below its predecessor, or (when the
        # predecessor is 0) bump it past nnz so the next diff goes
        # negative — both trip the monotonicity check first.
        r = 1 + int(rng.integers(max(1, n - 1)))
        rowptr[r] = rowptr[r - 1] - 1 if rowptr[r - 1] > 0 else rowptr[r] + nnz + 1
    return n, rowptr, colidx, kind
