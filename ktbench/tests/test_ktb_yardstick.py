"""The frozen yardstick: generators, updates, the reference and the
roofline counts."""

import numpy as np
import pytest
import torch

from ktbench import control, generators, reference, roofline, updates


@pytest.mark.parametrize("seed", [0, 1, 21])
def test_rmat_rule_matches_the_programs_generator(seed):
    """Given the program's own draws, in the order it takes them, the
    frozen rule makes the program's graph."""
    from repro_torch.graphs.generators import rmat

    scale, m = 10, (1 << 10) * 8
    rng = np.random.default_rng(seed)
    draws = np.stack([np.stack([rng.random(m), rng.random(m)]) for _ in range(scale)])
    perm = rng.permutation(1 << scale)
    raw = generators.rmat_edges(scale, 0.57, 0.19, 0.19, torch.as_tensor(draws), torch.as_tensor(perm))
    g = rmat(scale, 8, seed=seed)
    np.testing.assert_array_equal(generators.canonical(g.n, raw), g.edge_list() - 1)


@pytest.mark.parametrize("seed", [0, 2_147_483_659, 4_000_000_007])
def test_pool_graphs_are_drawn_from_the_seed(seed):
    config = {"generator": "rmat", "scale": 8, "edge_factor": 8, "a": 0.57, "b": 0.19, "c": 0.19}
    first, again = generators.config_graph(config, seed, 0), generators.config_graph(config, seed, 0)
    np.testing.assert_array_equal(first[1], again[1])
    for other in (generators.config_graph(config, seed, 1), generators.config_graph(config, seed + 1, 0)):
        assert first[0] == other[0]
        assert not np.array_equal(first[1], other[1])


def _brute(n, edges):
    """Trussness by the definition, on Python sets."""
    adj = [set() for _ in range(n)]
    for u, v in edges.tolist():
        adj[u].add(v)
        adj[v].add(u)
    alive, t, k = {tuple(e) for e in edges.tolist()}, {}, 3
    key = lambda a, b: (min(a, b), max(a, b))  # noqa: E731
    while alive:
        while True:
            gone = [e for e in alive if sum(
                1 for w in adj[e[0]] & adj[e[1]]
                if key(e[0], w) in alive and key(e[1], w) in alive) < k - 2]
            if not gone:
                break
            for e in gone:
                t[e] = k - 1
                alive.discard(e)
        k += 1
    return np.array([t[tuple(e)] for e in edges.tolist()], np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_reference_matches_the_definition(seed):
    n, raw = generators.rmat(7, 6, seed=seed)
    e = generators.canonical(n, raw)
    np.testing.assert_array_equal(reference.trussness(n, e, "cpu"), _brute(n, e))


def test_reference_triangle_blocks_agree():
    n, raw = generators.rmat(9, 8, seed=4)
    e = torch.as_tensor(generators.canonical(n, raw))
    whole = reference.triangles(n, e)
    blocked = reference.triangles(n, e, block=97)
    key = lambda t: torch.sort(t, 1).values.tolist()  # noqa: E731
    assert sorted(key(whole)) == sorted(key(blocked))


@pytest.mark.parametrize("make", [
    lambda: generators.rmat(8, 6, seed=2),
    lambda: generators.rmat(9, 4, 0.25, 0.25, 0.25, seed=1),
])
def test_reference_matches_the_port_on_the_cpu(make):
    from repro_torch.api import Session, TrussQuery
    from repro_torch.graphs.csr import from_edges

    n, raw = make()
    e = generators.canonical(n, raw)
    got = Session(device="cpu").submit(TrussQuery.decompose(from_edges(n, e))).result()
    want = reference.trussness(n, e, "cpu")
    np.testing.assert_array_equal(got.trussness, want)
    assert got.kmax == want.max()


def test_control_peel_is_not_exact():
    n, raw = generators.rmat(8, 8, seed=5)
    e = generators.canonical(n, raw)
    assert (control.capped_peel(n, e, "cpu") != reference.trussness(n, e, "cpu")).any()


def test_balanced_updates_rule():
    n, raw = generators.rmat(8, 8, seed=6)
    e = generators.canonical(n, raw)
    batches = updates.balanced_updates(np.random.default_rng(1), n, e, 1, 40)
    assert [(len(i), len(d)) for i, d in batches] == [(1, 0), (0, 1)] * 20
    ins = np.concatenate([i for i, _ in batches])
    dels = np.concatenate([d for _, d in batches])
    keys = set((e[:, 0] * n + e[:, 1]).tolist())
    assert all(u < v for u, v in ins.tolist()) and not {u * n + v for u, v in ins.tolist()} & keys
    assert len({u * n + v for u, v in dels.tolist()}) == 20
    assert {u * n + v for u, v in dels.tolist()} <= keys
    after = updates.state_after(n, e, batches)
    assert after.shape[0] == e.shape[0]
    wide = updates.balanced_updates(np.random.default_rng(1), n, e, 16, 3)
    assert [(len(i), len(d)) for i, d in wide] == [(8, 8)] * 3


def test_carried_control_keeps_the_old_values():
    n = 5
    e = np.array([[0, 1], [0, 2], [1, 2], [3, 4]])
    t = np.array([3, 3, 3, 2], np.int32)
    batches = [(np.array([[2, 3]]), np.zeros((0, 2), np.int64)),
               (np.zeros((0, 2), np.int64), np.array([[0, 1]]))]
    np.testing.assert_array_equal(control.carried(n, e, t, batches), [3, 3, 2, 2])


def test_byte_counts_by_hand():
    # A triangle (0, 1, 2) with a pendant edge (2, 3): 4 vertices, 4 edges.
    # Trussness 3, 3, 3, 2: level 2 starts from all 4 edges, level 3 from 3.
    n, t = 4, np.array([3, 3, 3, 2])
    assert roofline.pass_bytes(n, 4) == 4 * 5 + 4 * 4 + 4 * 4
    assert roofline.level_bytes(n, t) == (20 + 32) + (20 + 24)
    assert roofline.roofline_pct(3.35e12, 2.0) == pytest.approx(50.0)
