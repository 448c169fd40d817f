"""Balanced edge updates for a stream, made from arrays.

The rule of the reference ``stream_bench``: a batch of width w holds
w // 2 deletes and the rest inserts, and a batch of width 1 is an insert
and a delete in turns, the insert first.  Deletes are edges of the
starting graph, each deleted once; inserts are fresh uniform vertex pairs
that are in neither the starting graph nor an earlier insert.  Applied in
order the batches never conflict.

Deletes may be drawn by strata (:func:`stratified_picks`): every edge is
as likely to be deleted as with a plain uniform draw, but each block of
``strata`` deletes holds one edge of each stratum of the edges ranked by
a key, in the same order of strata for every seed.  A delete's cost
follows the edge's trussness (a delete in the dense core re-peels most of
the graph), so with the trussness as the key every seed's sequence does
the same amount of work, on different edges.
"""

from __future__ import annotations

import numpy as np

__all__ = ["balanced_updates", "stratified_picks", "state_after"]


def _fresh_pairs(rng, n: int, taken: np.ndarray, count: int) -> np.ndarray:
    """``count`` distinct canonical pairs, in draw order, none in the
    sorted key array ``taken`` (keys ``u * n + v``)."""
    if count > n * (n - 1) // 2 - taken.size:
        raise ValueError(f"{count} fresh pairs asked of a {n}-vertex graph with {taken.size} edges")
    out = np.zeros(0, np.int64)
    while out.size < count:
        draw = rng.integers(0, n, size=(2 * (count - out.size) + 64, 2))
        u, v = draw.min(1), draw.max(1)
        key = (u * n + v)[u != v]
        pos = np.searchsorted(taken, key)
        known = (pos < taken.size) & (taken[np.minimum(pos, taken.size - 1)] == key)
        key = np.concatenate([out, key[~known]])
        _, first = np.unique(key, return_index=True)
        out = key[np.sort(first)]
    out = out[:count]
    return np.stack([out // n, out % n], 1)


def stratified_picks(rng, key: np.ndarray, count: int, strata: int) -> np.ndarray:
    """``count`` distinct indices into ``key``.  The indices, ranked by
    ``key`` with ties broken at random, are cut into ``strata`` runs of
    equal size; pick j is drawn uniformly, without repetition, from run
    ``(j * step) % strata``, where ``step`` is the odd number nearest the
    golden section of ``strata``, so that a block's runs come far apart and
    each block of ``strata`` picks visits every run once."""
    m = key.shape[0]
    per = -(-count // strata)
    if per > m // strata:
        raise ValueError(f"{count} picks in {strata} strata of {m} items")
    ranked = np.lexsort((rng.random(m), key))
    bounds = np.arange(strata + 1) * m // strata
    step = int(round(0.6180339887 * strata)) | 1
    while np.gcd(step, strata) != 1:
        step += 2
    runs = np.stack([ranked[bounds[r] + rng.choice(bounds[r + 1] - bounds[r], per, replace=False)]
                     for r in range(strata)])
    j = np.arange(count)
    return runs[(j * step) % strata, j // strata]


def balanced_updates(rng, n: int, edges: np.ndarray, width: int, count: int, *,
                     delete_key: np.ndarray | None = None, strata: int = 1):
    """``count`` batches ``(inserts, deletes)`` of 0-based ``(k, 2)`` pairs
    against the canonical ``edges``; with ``delete_key`` (one number per
    edge) the deletes are drawn by :func:`stratified_picks`."""
    dels_per = [width // 2 if width > 1 else i % 2 for i in range(count)]
    ins_per = [width - d for d in dels_per]
    keys = edges[:, 0] * n + edges[:, 1]
    if delete_key is None:
        deletes = edges[rng.permutation(edges.shape[0])[: sum(dels_per)]]
    else:
        deletes = edges[stratified_picks(rng, delete_key, sum(dels_per), strata)]
    inserts = _fresh_pairs(rng, n, keys, sum(ins_per))
    out, a, b = [], 0, 0
    for ni, nd in zip(ins_per, dels_per):
        out.append((inserts[a : a + ni], deletes[b : b + nd]))
        a, b = a + ni, b + nd
    return out


def state_after(n: int, edges: np.ndarray, batches) -> np.ndarray:
    """The canonical edges of the starting ``edges`` with ``batches``
    applied in order."""
    keys = edges[:, 0] * n + edges[:, 1]
    ins = [i[:, 0] * n + i[:, 1] for i, _ in batches]
    dels = [d[:, 0] * n + d[:, 1] for _, d in batches]
    keys = np.concatenate([keys, *ins]) if ins else keys
    if dels:
        keys = keys[~np.isin(keys, np.concatenate(dels))]
    keys = np.sort(keys)
    return np.stack([keys // n, keys % n], 1)
