"""Run one cell several times, one process a run, and summarize the spread.

    python3 ktbench/series.py --workload <cell> --seeds 11 12 13 --seconds 10 \
        [--trace 1] --out runs.jsonl

Each run is ``ktbench/run.py`` as the benchmark's command runs it; its
result line (or its failure) is appended to ``--out`` with its seed, exit
code and the end of its standard error.  The summary gives each metric's
median and its spread: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    ap.add_argument("--out", required=True, help="JSON lines file the runs are appended to")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values: dict[str, list[float]] = {}
    bad = 0
    for seed in args.seeds:
        t0 = time.perf_counter()
        cmd = [sys.executable, str(ROOT / "ktbench" / "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                                  timeout=args.timeout)
        except subprocess.TimeoutExpired as e:
            proc = subprocess.CompletedProcess(cmd, 124, e.stdout or "", str(e.stderr or ""))
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
        except json.JSONDecodeError:
            result = None
        row = {"workload": args.workload, "seed": seed, "trace": args.trace, "rc": proc.returncode,
               "wall_s": wall, "result": result, "stderr": proc.stderr[-4000:]}
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        if result is None or not result["correct"]:
            bad += 1
            print(f"seed {seed}: rc {proc.returncode}, not correct\n{proc.stderr[-2000:]}", flush=True)
            continue
        for name, m in result["metrics"].items():
            values.setdefault(name, []).append(m["value"])
        dev = result["device"]
        print(f"seed {seed}: {wall:.1f} s wall, "
              + ", ".join(f"{k}={m['value']:.6g}" for k, m in result["metrics"].items())
              + f"; peak {dev['memory_peak_bytes']}"
              + (f", busy {dev['busy_s']:.4f} of {dev['window_s']:.4f} s" if "busy_s" in dev else ""),
              flush=True)
    for name, vals in values.items():
        print(f"{args.workload} {name}: median {statistics.median(vals):.6g}, "
              f"spread {spread(vals):.4f} over {len(vals)} runs", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
