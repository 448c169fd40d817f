"""repro_torch.resilience — fault domains for the batched peel path.

The port of ``repro.resilience``: the same policy layer, so a packed
dispatch's faults stay per-query on the card too.

* :mod:`.faults`     — deterministic fault-injection harness: a
  :class:`FaultPlan` (``Session(faults=...)`` or the ``REPRO_FAULTS``
  env var) fires typed failures by site + seed — compile error, device
  OOM, dispatch exception, poisoned batch member, clock skew — with the
  reference's sites, grammar and seeded firing rule, so a chaos seed
  replays identically in both packages;
* :mod:`.retry`      — :class:`RetryPolicy`: bounded attempts with
  exponential backoff (on the fake-able obs clock) and the registry
  fallback switch;
* :mod:`.runner`     — :class:`ResilientRunner`: quarantines
  member-attributed failures, retries transient device faults, falls
  down the backend registry (fused→pallas→xla, fine→coarse) on compile
  faults, and bisects batches to isolate unattributed poison members.
  One deviation from the reference: a real launch or build failure of a
  hand-written CUDA kernel fails the batch's queries at once, typed, with
  no retry and no fallback (see the module);
* :mod:`.checkpoint` — a ``StreamingTrussSession``'s CSR + trussness +
  triangle cache serialized at update boundaries and restored after a
  crash, equal to an uninterrupted session.  The file format is the JAX
  package's, so checkpoints move between the two packages.

Every retry, fallback, quarantine, bisect, and shed is counted in the
session's :mod:`repro_torch.obs` metrics registry.
"""

from .checkpoint import (
    CHECKPOINT_VERSION,
    Checkpoint,
    latest_checkpoint,
    load_checkpoint,
    restore_session,
    save_checkpoint,
)
from .faults import (
    FAULT_SITES,
    FAULTS_ENV_VAR,
    FaultPlan,
    FaultSpec,
    current_plan,
    inject,
    parse_faults,
    poison_csr_arrays,
    use_plan,
)
from .retry import RetryPolicy
from .runner import ResilientRunner

__all__ = [
    # fault injection
    "FAULT_SITES",
    "FAULTS_ENV_VAR",
    "FaultSpec",
    "FaultPlan",
    "parse_faults",
    "current_plan",
    "use_plan",
    "inject",
    "poison_csr_arrays",
    # retry/fallback policy + runner
    "RetryPolicy",
    "ResilientRunner",
    # streaming checkpoint/restore
    "CHECKPOINT_VERSION",
    "Checkpoint",
    "save_checkpoint",
    "load_checkpoint",
    "restore_session",
    "latest_checkpoint",
]
