"""Synthetic graph generators calibrated to the paper's input families.

The paper benchmarks 50 SNAP graphs (GraphChallenge collection).  This
container is offline, so we generate synthetic graphs from the same degree
regimes the paper's inputs span:

* ``rmat``       — Kronecker/R-MAT power-law graphs: the soc-*/cit-*/oregon
                   regime (heavy-tailed degrees, dense triangle cores) where
                   the paper's fine-grained win is largest.
* ``barabasi``   — preferential attachment, a second heavy-tail family.
* ``erdos``      — Erdős–Rényi: near-uniform degrees (p2p-Gnutella regime,
                   modest wins in the paper).
* ``road``       — 2D lattice + shortcut diagonals: uniform tiny degrees
                   (roadNet-* regime, where the paper observes parity).
* ``clustered``  — planted-community graph with dense triangle-rich blocks
                   (email-Enron/ca-* regime; high K_max).

All return upper-triangular 1-based :class:`~repro_torch.graphs.csr.CSRGraph`.
"""

from __future__ import annotations

import numpy as np

from .csr import CSRGraph, from_edges

__all__ = [
    "rmat",
    "barabasi",
    "erdos",
    "road",
    "clustered",
    "suite",
    "SUITE_SPECS",
]


def rmat(
    scale: int,
    edge_factor: int = 8,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> CSRGraph:
    """R-MAT graph with 2**scale vertices (Graph500 defaults)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r >= ab  # bottom half for source
        r2 = rng.random(m)
        # Within chosen half, pick the column quadrant.
        col_right = np.where(
            right,
            r2 >= (c / (1.0 - ab)) if ab < 1.0 else False,
            r2 >= (a / ab),
        )
        src |= right.astype(np.int64) << bit
        dst |= col_right.astype(np.int64) << bit
    # Random vertex relabeling removes the Kronecker ordering artifact.
    perm = rng.permutation(n)
    return from_edges(n, np.stack([perm[src], perm[dst]], 1), name=f"rmat{scale}")


def barabasi(n: int, m_attach: int = 4, seed: int = 0) -> CSRGraph:
    """Barabási–Albert preferential attachment (vectorized approximation).

    Classic BA grows one vertex at a time; we use the standard repeated-node
    trick: targets are sampled from the edge-endpoint multiset so far, which
    reproduces the power-law tail without the O(n·m) python loop.
    """
    rng = np.random.default_rng(seed)
    src_list = []
    dst_list = []
    # Seed clique among the first m_attach + 1 vertices.
    seed_nodes = np.arange(m_attach + 1)
    iu, ju = np.triu_indices(m_attach + 1, k=1)
    src_list.append(seed_nodes[iu])
    dst_list.append(seed_nodes[ju])
    endpoint_pool = np.concatenate([seed_nodes[iu], seed_nodes[ju]])
    for v in range(m_attach + 1, n):
        targets = endpoint_pool[rng.integers(0, endpoint_pool.size, m_attach)]
        targets = np.unique(targets)
        src = np.full(targets.size, v, dtype=np.int64)
        src_list.append(src)
        dst_list.append(targets)
        endpoint_pool = np.concatenate([endpoint_pool, src, targets])
    edges = np.stack([np.concatenate(src_list), np.concatenate(dst_list)], 1)
    return from_edges(n, edges, name=f"ba{n}")


def erdos(n: int, avg_degree: float = 8.0, seed: int = 0) -> CSRGraph:
    """Erdős–Rényi G(n, m) with m = n * avg_degree / 2 undirected edges."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree / 2)
    edges = rng.integers(0, n, size=(int(m * 1.15) + 8, 2))
    return from_edges(n, edges[:m], name=f"er{n}")


def road(side: int, shortcut_frac: float = 0.05, seed: int = 0) -> CSRGraph:
    """2D grid with a few diagonal shortcuts: uniform degree ~4, few triangles.

    Mirrors the roadNet-* regime where the paper's coarse and fine versions
    tie (there is no imbalance to fix).
    """
    rng = np.random.default_rng(seed)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1)
    diag = np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)
    keep = rng.random(diag.shape[0]) < shortcut_frac
    edges = np.concatenate([right, down, diag[keep]], 0)
    return from_edges(n, edges, name=f"road{side}x{side}")


def clustered(
    n_communities: int,
    community_size: int,
    p_in: float = 0.5,
    p_out_edges: int = 2,
    seed: int = 0,
) -> CSRGraph:
    """Planted partition: dense communities (many triangles) + sparse bridges."""
    rng = np.random.default_rng(seed)
    n = n_communities * community_size
    src_list, dst_list = [], []
    iu, ju = np.triu_indices(community_size, k=1)
    for cidx in range(n_communities):
        base = cidx * community_size
        keep = rng.random(iu.size) < p_in
        src_list.append(base + iu[keep])
        dst_list.append(base + ju[keep])
    bridges = rng.integers(0, n, size=(n_communities * p_out_edges * 8, 2))
    src_list.append(bridges[:, 0])
    dst_list.append(bridges[:, 1])
    edges = np.stack([np.concatenate(src_list), np.concatenate(dst_list)], 1)
    return from_edges(n, edges, name=f"clustered{n_communities}x{community_size}")


# ---------------------------------------------------------------------- #
# Benchmark suite — spans the paper's Table I regimes at laptop scale.
# ---------------------------------------------------------------------- #
SUITE_SPECS = (
    # (name, factory)  — ordered by edge count like the paper's plots.
    ("er-small", lambda: erdos(2_000, 6.0, seed=1)),
    ("ba-small", lambda: barabasi(3_000, 4, seed=2)),
    ("clustered-small", lambda: clustered(24, 48, 0.45, seed=3)),
    ("rmat-14", lambda: rmat(14, 4, seed=4)),
    ("road-128", lambda: road(128, 0.06, seed=5)),
    ("ba-mid", lambda: barabasi(20_000, 6, seed=6)),
    ("er-mid", lambda: erdos(30_000, 8.0, seed=7)),
    ("rmat-16", lambda: rmat(16, 8, seed=8)),
    ("clustered-mid", lambda: clustered(80, 64, 0.4, seed=9)),
    ("road-512", lambda: road(512, 0.05, seed=10)),
)


def suite(names: tuple[str, ...] | None = None) -> list[CSRGraph]:
    """Materialize the benchmark suite (optionally a named subset)."""
    out = []
    for name, factory in SUITE_SPECS:
        if names is None or name in names:
            g = factory()
            out.append(CSRGraph(g.n, g.rowptr, g.colidx, name=name))
    return out
