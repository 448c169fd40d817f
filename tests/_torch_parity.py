"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Inputs are made once, with numpy from fixed seeds, by the JAX package's own
generators; the port receives the same arrays (``torch_graph``,
``torch_problem``), so every comparison is of like with like.
"""

import numpy as np
import torch

import repro.graphs as rg
import repro_torch.graphs as tg
from repro_torch.core import problem_from_arrays

# The suite runs in several worker processes beside JAX's own thread pool;
# one intra-op thread per worker keeps them from oversubscribing the cores
# (the parity inputs are small).
torch.set_num_threads(1)


def small_pairs():
    """(reference graph, port graph) for the conftest ``small_graphs`` set."""
    refs = [rg.erdos(120, 8.0, seed=0), rg.clustered(3, 18, 0.7, seed=1), rg.rmat(7, 5, seed=2)]
    return [(g, torch_graph(g)) for g in refs]


def torch_graph(g):
    """The port's CSRGraph over a reference graph's arrays."""
    return tg.CSRGraph(g.n, g.rowptr, g.colidx, name=g.name)


def torch_problem(p):
    """The port's FineProblem (CPU) over a reference FineProblem's arrays."""
    return problem_from_arrays({f: np.asarray(getattr(p, f)) for f in p._fields}, "cpu")


def alive_masks(p, seed, count=2, keep=0.7):
    """The full alive mask plus ``count`` random ones (numpy, seeded); pad
    lanes are never alive."""
    real = np.asarray(p.colidx) != 0
    rng = np.random.default_rng(seed)
    return [real] + [real & (rng.random(real.shape[0]) < keep) for _ in range(count)]


def assert_same(ref, got, what=""):
    """Exact equality of a JAX/numpy array and a torch tensor, dtype too."""
    r = np.asarray(ref)
    g = got.cpu().numpy() if hasattr(got, "cpu") else np.asarray(got)
    assert r.dtype == g.dtype, (what, r.dtype, g.dtype)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    assert np.array_equal(r, g), what
