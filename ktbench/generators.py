"""The benchmark's graph generator: a frozen copy of the published rule.

``rmat`` is the Graph500 Kronecker (R-MAT) edge generator.  Its rule
(:func:`rmat_edges`) is the one the program's generator
(``repro_torch.graphs.generators.rmat``) follows, copied so that a later
change to the program cannot move the graphs the benchmark runs; its
uniform draws come from a ``torch.Generator`` on the run's device in one
call, so that a scale-18 graph is made in a fraction of a second.
:func:`canonical` deduplicates the raw edges into the upper-triangular
key order the program's CSR stores (sorted by ``(u, v)`` with ``u < v``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import by_file

__all__ = ["rmat_edges", "rmat", "canonical", "config_graph", "derived_seed"]


def rmat_edges(scale: int, a: float, b: float, c: float, draws: torch.Tensor,
               perm: torch.Tensor) -> torch.Tensor:
    """Raw 0-based ``(m, 2)`` int64 R-MAT edges from ``draws``, uniform
    numbers of shape ``(scale, 2, m)`` (per bit: the row's draw, then the
    column's), and the vertex relabeling ``perm``."""
    ab = a + b
    m = draws.shape[2]
    src = torch.zeros(m, dtype=torch.int64, device=draws.device)
    dst = torch.zeros_like(src)
    for bit in range(scale):
        r, r2 = draws[bit, 0], draws[bit, 1]
        right = r >= ab
        col_right = torch.where(right, r2 >= (c / (1.0 - ab)) if ab < 1.0 else False, r2 >= (a / ab))
        src |= right.to(torch.int64) << bit
        dst |= col_right.to(torch.int64) << bit
    return torch.stack([perm[src], perm[dst]], 1)


def rmat(scale: int, edge_factor: int = 8, a: float = 0.57, b: float = 0.19, c: float = 0.19,
         seed: int = 0, device="cpu") -> tuple[int, torch.Tensor]:
    """R-MAT edges on ``2**scale`` vertices, ``edge_factor`` per vertex,
    with the vertex ids randomly relabeled (Graph500's generator), drawn
    on ``device`` from ``seed``."""
    n = 1 << scale
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draws = torch.rand((scale, 2, n * edge_factor), generator=gen, device=device)
    perm = torch.randperm(n, generator=gen, device=device)
    return n, rmat_edges(scale, a, b, c, draws, perm)


def canonical(n: int, edges) -> np.ndarray:
    """``(m, 2)`` int64 ``(u, v)`` with ``u < v``, self-loops and duplicates
    dropped, sorted by ``(u, v)``: the order of the program's CSR lanes.
    ``edges`` is an array or a tensor on any device; the result is on the
    host."""
    e = torch.as_tensor(edges)
    u = torch.minimum(e[:, 0], e[:, 1])
    v = torch.maximum(e[:, 0], e[:, 1])
    keep = u != v
    key = torch.unique(u[keep] * n + v[keep])
    return torch.stack([key // n, key % n], 1).cpu().numpy()


def derived_seed(seed: int, *path: int) -> int:
    """A 32-bit seed drawn from the run's ``seed`` and a path of indices."""
    entropy = [int(x) % (1 << 64) for x in (seed, *path)]  # SeedSequence takes no negatives
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def config_graph(config: dict, seed: int, index: int, device="cpu") -> tuple[int, np.ndarray]:
    """Graph ``index`` of a pool for the run's ``seed``, as canonical edges:
    the configuration's generator at a seed drawn from the run's ``seed``
    and the index, so that every run decomposes graphs of its own.  A
    generator other than ``rmat`` is the file
    ``graph_generators/<generator>.py``, whose ``graph(config, seed,
    index, device) -> (n, canonical edges)`` draws from
    ``derived_seed(seed, index)`` and, like this module, imports nothing
    of the program."""
    c = config
    if c["generator"] != "rmat":
        return by_file.load("graph_generators", c["generator"], "generator").graph(c, seed, index, device)
    n, raw = rmat(c["scale"], c["edge_factor"], c["a"], c["b"], c["c"],
                  seed=derived_seed(seed, index), device=device)
    return n, canonical(n, raw)
