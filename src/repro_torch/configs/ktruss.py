"""The paper's own workload configs: K-truss problem instances.

Mirrors the experimental grid of the paper (50 SNAP graphs × {coarse,fine}
× K ∈ {3, K_max}) at laptop scale with calibrated synthetic families
(DESIGN.md §3).  ``BENCH_GRAPHS`` is sized so that the coarse-grained
baseline — whose padded cost is O(n·W²) — still completes on one CPU core;
``LARGE_GRAPHS`` extends the fine-only scaling study.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from ..graphs import CSRGraph, barabasi, clustered, erdos, rmat, road

__all__ = ["KTrussBench", "BENCH_GRAPHS", "LARGE_GRAPHS", "K_SETTINGS"]


@dataclasses.dataclass(frozen=True)
class KTrussBench:
    name: str
    factory: Callable[[], CSRGraph]
    regime: str  # which paper-graph family this calibrates to

    def build(self) -> CSRGraph:
        g = self.factory()
        return CSRGraph(g.n, g.rowptr, g.colidx, name=self.name)


# Ordered by edge count, like the paper's plots.
BENCH_GRAPHS: tuple[KTrussBench, ...] = (
    KTrussBench("er-4k", lambda: erdos(4_000, 8.0, seed=11), "p2p-Gnutella"),
    KTrussBench("road-64", lambda: road(64, 0.08, seed=12), "roadNet"),
    KTrussBench("clustered-32x40", lambda: clustered(32, 40, 0.5, seed=13), "ca-/email-"),
    KTrussBench("ba-6k", lambda: barabasi(6_000, 4, seed=14), "oregon/as"),
    KTrussBench("rmat-12", lambda: rmat(12, 6, seed=15), "soc-/cit-"),
    KTrussBench("road-128", lambda: road(128, 0.06, seed=16), "roadNet"),
    KTrussBench("er-12k", lambda: erdos(12_000, 8.0, seed=17), "p2p-Gnutella"),
    KTrussBench("ba-12k", lambda: barabasi(12_000, 5, seed=18), "oregon/as"),
)

# Fine-grained-only scaling set (coarse padded cost would be prohibitive —
# which is itself the paper's point; reported as such).
LARGE_GRAPHS: tuple[KTrussBench, ...] = (
    KTrussBench("rmat-15", lambda: rmat(15, 8, seed=21), "soc-Slashdot"),
    KTrussBench("ba-50k", lambda: barabasi(50_000, 6, seed=22), "loc-brightkite"),
    KTrussBench("road-512", lambda: road(512, 0.05, seed=23), "roadNet"),
)

K_SETTINGS = ("k3", "kmax")
