"""What decides ``correct``: the program's answers against the plain
reference, edge by edge.

Every answer's kmax is compared, and a sample of answers drawn from the
seed (with the newest) is compared whole.  The reference recomputes each
checked graph from the benchmark's own edges.  Answers are integers and
the configurations state exactness, so every limit is 0.
"""

from __future__ import annotations

import numpy as np

from . import reference

__all__ = ["LIMITS", "compare", "verdict"]

LIMITS = {"mismatched_edges": 0, "kmax_mismatches": 0, "failed_requests": 0}


def compare(driver, rec, device, *, solve=reference.trussness) -> tuple[dict, dict]:
    """``(readings, truths)``: the compared numbers, and the reference's
    trussness of each pool graph it computed (pool index -> array)."""
    truths: dict = {}

    def truth(key, ans):
        if key not in truths:
            n, edges = driver.answer_graph(ans)
            truths[key] = solve(n, edges, device)
        return truths[key]

    stream = driver.traffic["kind"] == "stream"
    mismatched = kmax_bad = 0
    for ans in rec.checked():
        want = truth(ans.graph, ans)
        got = ans.trussness
        if got.shape != want.shape:
            mismatched += max(got.shape[0], want.shape[0])
        else:
            mismatched += int(np.count_nonzero(got != want))
        if stream:
            kmax_bad += int(ans.kmax != int(want.max(initial=0)))
    if not stream:  # every answer's kmax: one reference per pool graph
        for ans in rec.answers:
            kmax_bad += int(ans.kmax != int(truth(ans.graph, ans).max(initial=0)))
    readings = {"mismatched_edges": mismatched, "kmax_mismatches": kmax_bad,
                "failed_requests": rec.failed}
    pool_truths = {} if stream else truths
    return readings, pool_truths


def verdict(readings: dict) -> bool:
    return all(readings[k] <= LIMITS[k] for k in LIMITS)
