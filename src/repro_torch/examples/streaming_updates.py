"""Streaming K-truss demo: maintain a decomposition under live edge updates.

Opens a :class:`repro_torch.stream.StreamingTrussSession` on a
planted-community graph, then feeds it insert/delete batches.  Each update
re-peels only the affected-edge frontier (one device dispatch — or zero
when the update touches no triangles at a relevant level), and the
maintained trussness is bit-identical to a from-scratch ``decompose()`` of
the mutated graph, which the demo verifies at every step.

    PYTHONPATH=src python -m repro_torch.examples.streaming_updates [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import KTrussEngine
from repro_torch.device import resolve_device
from repro_torch.examples import device_arg
from repro_torch.graphs import clustered
from repro_torch.service import TrussService
from repro_torch.stream import EdgeBatch

# Session.stats() fields that are times, left out of main()'s result.
TIMED_STATS = ("device_time_s", "planner_plan_time_s", "planner_plan_us_per_query")


def random_batch(rng, g, n_ins, n_del):
    existing = set(map(tuple, (g.edge_list() - 1)))
    ins = []
    while len(ins) < n_ins:
        a, b = int(rng.integers(0, g.n)), int(rng.integers(0, g.n))
        if a != b and (min(a, b), max(a, b)) not in existing:
            ins.append((a, b))
            existing.add((min(a, b), max(a, b)))
    eids = rng.permutation(g.nnz)[:n_del]
    return EdgeBatch.of(ins, [tuple(e - 1) for e in g.edge_list()[eids]])


def main(device: str | torch.device | None = None) -> dict:
    """Run the example on ``device`` (default: the CUDA card); returns each
    step's update and the session's and service's counters."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    g = clustered(4, 16, 0.6, seed=3)
    svc = TrussService(max_batch=2, chunk=64, device=dev)
    sess = svc.open_stream(g)  # initial full decompose via the batched path
    print(f"opened stream: {g.nnz} edges, kmax={sess.kmax}")
    opened = {"edges": g.nnz, "kmax": sess.kmax}

    steps = []
    for step in range(8):
        res = sess.update(random_batch(rng, sess.graph, n_ins=2, n_del=1))
        ref = KTrussEngine(sess.graph, chunk=64, device=dev).decompose().trussness
        if not np.array_equal(res.trussness, ref):
            raise AssertionError("incremental != from-scratch")
        print(
            f"step {step}: +{res.num_inserts}/-{res.num_deletes} edges -> "
            f"frontier {res.frontier_size}/{res.num_edges} "
            f"({100 * res.frontier_frac:.1f}%), {res.dispatches} dispatch(es), "
            f"kmax={res.kmax}  [exact ✓]"
        )
        steps.append(res)

    session_stats, service_stats = sess.stats(), svc.stats()
    print("session:", session_stats)
    print("service:", service_stats)
    return {
        "opened": opened,
        "steps": steps,
        "session": session_stats,
        "service": {k: v for k, v in service_stats.items() if k not in TIMED_STATS},
    }


if __name__ == "__main__":
    main(device_arg(__doc__).parse_args().device)
