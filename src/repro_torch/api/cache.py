"""Shape-bucket canonicalization + executor cache for the query API.

Canonicalizing every incoming graph to power-of-two ``(n_pad, nnz_pad,
window)`` buckets collapses the shape space: one executor per bucket
serves every request (and every micro-batch) that lands in it, and the
port's buckets are the reference's (``Bucket``/``bucket_for``/
``bucket_str`` are identical), so the two packages agree on which
requests batch together.

The cached artifact is a *problem-polymorphic* device peel: the executor
takes the ``FineProblem`` as an argument, so any same-bucket problem —
including a block-diagonal batch of them — reuses it.  Cache keys are
``(bucket, slots, variant)``: the slot count scales the packed shapes and
the variant captures everything else that specializes the executor — the
registry backend key and dataflow mode.
"""

from __future__ import annotations

import threading
from typing import Callable, Hashable, NamedTuple

import numpy as np

from ..errors import CompileError, TrussError
from ..graphs.csr import CSRGraph
from ..obs import MetricsRegistry

__all__ = [
    "Bucket",
    "bucket_for",
    "bucket_str",
    "CacheStats",
    "CompileCache",
]


class Bucket(NamedTuple):
    """Canonical power-of-two shape class of one graph slot.

    A graph in this bucket is packed to ``n_pad`` vertices, ``nnz_pad``
    directed nonzeros (twice that undirected) and intersected with windows
    of width ``window``.  Batches of B same-bucket graphs use the scaled
    shapes ``(B * n_pad, B * nnz_pad)``; the executor cache key is
    ``(bucket, slots, variant)``.
    """

    n_pad: int
    nnz_pad: int
    window: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def bucket_for(g: CSRGraph, *, chunk: int = 256, min_window: int = 8) -> Bucket:
    """Canonical shape bucket of one graph.

    The window is sized to the max *undirected* degree so one bucket is
    valid for every backend (eager needs out-degree, owner/pallas need
    the symmetric degree).
    """
    deg = g.degrees()
    indeg = np.bincount(g.colidx, minlength=g.n + 1)
    und_max = int((deg + indeg).max(initial=0))
    return Bucket(
        n_pad=_next_pow2(max(g.n, 1)),
        nnz_pad=_next_pow2(max(g.nnz, chunk)),
        window=_next_pow2(max(min_window, und_max)),
    )


def bucket_str(bucket: Bucket) -> str:
    """Canonical string label of one bucket (``n{..}-nnz{..}-w{..}``).

    The one spelling shared by metrics labels, planner stats rows, and the
    serving tier's affinity keys — the router matches these against a
    replica's ``compiled_buckets``, so every producer must agree."""
    return f"n{bucket.n_pad}-nnz{bucket.nnz_pad}-w{bucket.window}"


class CacheStats:
    """Compile-cache hit/miss counters — a view over the metrics registry.

    The counters live in a :class:`repro_torch.obs.MetricsRegistry`
    (``cache_compiles`` / ``cache_hits``), so they show up in
    ``obs.metrics_snapshot()`` and the Prometheus exposition alongside
    every other instrument; ``compiles`` / ``hits`` / ``hit_rate`` keep
    their historical read surface, and :meth:`snapshot` (alias
    :meth:`row`) keeps the historical key set.
    """

    def __init__(self, metrics: "MetricsRegistry | None" = None):
        if metrics is None:
            metrics = MetricsRegistry()  # standalone cache: private series
        self.metrics = metrics

    def record_compile(self, bucket: "Bucket | None" = None) -> None:
        self.metrics.inc("cache_compiles")
        if bucket is not None:
            self.metrics.inc("cache_bucket_compiles", bucket=bucket_str(bucket))

    def record_hit(self, bucket: "Bucket | None" = None) -> None:
        self.metrics.inc("cache_hits")
        if bucket is not None:
            self.metrics.inc("cache_bucket_hits", bucket=bucket_str(bucket))

    @property
    def compiles(self) -> int:
        return int(self.metrics.value("cache_compiles"))

    @property
    def hits(self) -> int:
        return int(self.metrics.value("cache_hits"))

    @property
    def requests(self) -> int:
        return self.compiles + self.hits

    @property
    def hit_rate(self) -> float:
        return self.hits / self.requests if self.requests else 0.0

    def row(self) -> dict:
        return {
            "compiles": self.compiles,
            "hits": self.hits,
            "hit_rate": round(self.hit_rate, 4),
        }

    # The key-locked export name (tests/test_obs.py snapshots this).
    snapshot = row


class CompileCache:
    """Executor store keyed by ``(bucket, slots, variant)`` with hit/miss
    counters.

    Each key maps to one peel executor built by ``builder(key)``;
    ``compiles`` counts builder calls (executor builds; a CUDA kernel
    library is built once per process on its first launch).  ``variant``
    folds in whatever else specializes the executor — the backend key and
    dataflow mode.  ``metrics`` routes the hit/miss counters into the owning
    session's registry (default: a private one).
    """

    def __init__(
        self,
        builder: Callable[[tuple[Bucket, int, Hashable]], Callable],
        *,
        metrics: "MetricsRegistry | None" = None,
    ):
        self._builder = builder
        self._exes: dict[tuple[Bucket, int, Hashable], Callable] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats(metrics)

    def get(
        self, bucket: Bucket, slots: int, variant: Hashable = "contig"
    ) -> tuple[Callable, bool]:
        """Return (executor, was_hit) for one bucket/slots/variant key."""
        key = (bucket, int(slots), variant)
        with self._lock:
            exe = self._exes.get(key)
            if exe is not None:
                self.stats.record_hit(bucket)
                return exe, True
            try:
                exe = self._exes[key] = self._builder(key)
            except TrussError:
                raise  # already typed
            except Exception as e:
                # A failed build is a CompileError no matter which layer
                # threw — the resilience runner keys its fallback on it.
                raise CompileError(
                    f"building executor for bucket={bucket} slots={slots} "
                    f"variant={variant} failed: {e}",
                    bucket=bucket,
                    cause=e,
                ) from e
            self.stats.record_compile(bucket)
            return exe, False

    def buckets(self) -> tuple[str, ...]:
        """Labels of every bucket holding at least one compiled executable
        (sorted) — a replica's ``compiled_buckets`` health field, and the
        raw material of the router's bucket affinity."""
        with self._lock:
            seen = {bucket_str(b) for (b, _slots, _variant) in self._exes}
        return tuple(sorted(seen))

    def __len__(self) -> int:
        return len(self._exes)
