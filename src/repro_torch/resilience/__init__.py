"""repro_torch.resilience — crash durability for streaming sessions.

* :mod:`.checkpoint` — a ``StreamingTrussSession``'s CSR + trussness +
  triangle cache serialized at update boundaries and restored after a
  crash, equal to an uninterrupted session.  The file format is the JAX
  package's, so checkpoints move between the two packages.

The rest of the reference's resilience layer (fault injection, retry
policy, the resilient runner) is not ported yet.
"""

from .checkpoint import (
    CHECKPOINT_VERSION,
    Checkpoint,
    latest_checkpoint,
    load_checkpoint,
    restore_session,
    save_checkpoint,
)

__all__ = [
    "CHECKPOINT_VERSION",
    "Checkpoint",
    "save_checkpoint",
    "load_checkpoint",
    "restore_session",
    "latest_checkpoint",
]
