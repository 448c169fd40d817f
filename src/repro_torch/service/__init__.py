"""Legacy serving subsystem — adapters over :mod:`repro_torch.api`.

.. deprecated::
    ``repro_torch.api`` is the one front door: declare work as
    :class:`repro_torch.api.TrussQuery` values and run them through
    ``repro_torch.api.solve()`` or a :class:`repro_torch.api.Session`.
    This package keeps the JAX package's previous surface:

    * :class:`TrussService` — thin adapter over ``repro_torch.api.Session``
      (pinned to one registry backend);
    * ``TrussFuture`` — re-export of :class:`repro_torch.api.TrussFuture`.

    The cache spellings (``Bucket``, ``bucket_for``, ``CompileCache``,
    ``enable_persistent_cache``) still resolve but are not part of the
    documented surface.
"""

# Cache names resolve straight from repro_torch.api.
from ..api.cache import (  # noqa: F401 — legacy re-exports
    Bucket,
    CompileCache,
    bucket_for,
    enable_persistent_cache,
)
from .service import TrussFuture, TrussService

__all__ = [
    "TrussFuture",
    "TrussService",
]
