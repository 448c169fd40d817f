"""The control: the reference put in the program's place with the
configurations' stated guarantee (exact trussness) broken, judged by the
same comparison that decides ``correct``.  The benchmark's own runs never
run it.

    python3 ktbench/control.py --workload <cell> --seeds 11 12 13 [--device cuda]

- A decompose cell's control is the plain peel with one trip per level
  (``reference.peel(..., trip_cap=1)``): the early exit that would tempt
  a faster peel.
- A stream cell's control skips the re-peel: each update carries the
  committed trussness over to the new edges (an inserted edge at 2),
  which is a step that returns its state unchanged.

For each seed it builds the cell's inputs as a run does, answers the
same requests a run of ``--requests`` requests would, and prints the
compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import random
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "ktbench":
    sys.path.pop(0)  # run as a script: its folder's modules must not shadow others
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from ktbench import check, generators, reference  # noqa: E402
from ktbench.spec import load_cell  # noqa: E402
from ktbench.clients import Answer, Records, make_driver  # noqa: E402

__all__ = ["capped_peel", "carried", "control_records", "main"]


def capped_peel(n: int, edges: np.ndarray, device) -> np.ndarray:
    return reference.trussness(n, edges, device, trip_cap=1)


def carried(n: int, edges: np.ndarray, truss: np.ndarray, batches) -> np.ndarray:
    """The starting trussness carried through ``batches`` with no re-peel:
    kept edges keep their value, inserted edges start at 2."""
    ins = [i[:, 0] * n + i[:, 1] for i, _ in batches]
    dels = [d[:, 0] * n + d[:, 1] for _, d in batches]
    keys = np.concatenate([edges[:, 0] * n + edges[:, 1], *ins])
    vals = np.concatenate([truss, np.full(sum(k.size for k in ins), 2, np.int32)])
    keep = ~np.isin(keys, np.concatenate(dels)) if dels else np.ones(keys.size, bool)
    keys, vals = keys[keep], vals[keep]
    return vals[np.argsort(keys, kind="stable")].astype(np.int32)


def control_records(driver, requests: int, seed: int, device) -> Records:
    """The answers a run of ``requests`` requests would check, made by the
    control instead of the program."""
    tr = driver.traffic
    rec = Records(sample=tr["check_sample"], rng=random.Random(generators.derived_seed(seed, 7)))
    if tr["kind"] == "stream":
        n, edges = driver.pool[0]
        start = reference.trussness(n, edges, device)
        first = tr["warm_updates"]
        for i in range(first, first + requests):
            rec.attempted += 1
            rec.keep(Answer(rec.attempted - 1, i, 0, None))
        # Only the sampled updates and the newest are checked: carry those alone.
        for ans in rec.checked():
            ans.trussness = carried(n, edges, start, driver.batches[: ans.graph + 1])
            ans.kmax = int(ans.trussness.max(initial=0))
        return rec
    cache: dict[int, np.ndarray] = {}
    for j in range(requests):
        gi = driver.graph_of(j)
        if gi not in cache:
            cache[gi] = capped_peel(*driver.pool[gi], device)
        t = cache[gi]
        rec.attempted += 1
        rec.keep(Answer(rec.attempted - 1, gi, int(t.max(initial=0)), t))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, required=True,
                    help="requests (decompose cells) or updates (stream cells) a run completes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    worst = None
    for seed in args.seeds:
        driver = make_driver(cell.config, cell.traffic, seed, args.device)
        rec = control_records(driver, args.requests, seed, args.device)
        readings, _ = check.compare(driver, rec, args.device)
        verdict = check.verdict(readings)
        print(f"control {cell.name} seed {seed}: correct={verdict} "
              + ", ".join(f"{k}={v} (limit {check.LIMITS[k]})" for k, v in readings.items()),
              flush=True)
        worst = readings["mismatched_edges"] if worst is None else min(worst, readings["mismatched_edges"])
    print(f"control {cell.name}: smallest mismatched_edges over {len(args.seeds)} seeds: {worst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
