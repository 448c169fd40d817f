"""Run one cell of the port's benchmark once, and print its result line.

    python3 ktbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name (``ktbench.spec``).  The run makes its graphs and updates from
``--seed``, opens one ``repro_torch.api.Session`` on the card, warms every
pool graph (set-up ends at the first timed request), drives the mix for
``--seconds`` (a request started before the close is finished), and
then checks a sample of what came back against the plain reference
(``ktbench.check``).  With ``--trace 1`` the session's spans are summed
over the window, a stretch of whole requests after it is profiled, and
the per-layer metrics are read; without, the end-to-end metrics are.

The last line of standard output is one JSON object; the compared
numbers and their limits close standard error and the line.  Without a
card, or with JAX or the JAX package loaded once the window has closed,
the run exits with a code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_ENTRY = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "ktbench":
    sys.path.pop(0)  # run as a script: its folder's modules must not shadow others
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole
NO_CARD, JAX_LOADED = 2, 3


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module ran."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_ENTRY


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Window:
    """The measured window, for the end-to-end readers."""

    seconds: float
    setup_s: float
    latencies: list  # seconds, one per completed request
    work: int  # undirected edges decomposed, or updates committed


@dataclass
class Context:
    """What a per-layer reader may read."""

    cell: object  # ktbench.spec.Cell
    driver: object  # ktbench.clients.Driver
    spans: dict  # span name -> [seconds, count] over the window
    requests: int  # requests completed in the window
    stretch: object  # ktbench.devtrace.Stretch, or None without a card
    truths: dict  # pool index -> the reference's trussness
    device: str


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, device: str | None = None) -> int:
    """Run one cell.  ``device`` is for the CPU tests: given, the run skips
    its look for a card and runs there, with no profiled stretch."""
    args = parse(argv)
    t_start = time.perf_counter() - process_age()
    for var in ("REPRO_TRACE", "REPRO_FAULTS"):  # the program consults both when unset
        os.environ.pop(var, None)
    import numpy as np
    import torch

    from ktbench import check, generators
    from ktbench.spec import load_cell, load_reader

    cell = load_cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"ktbench: the cell needs {cell.chips} CUDA device(s); "
                  f"cuda available={torch.cuda.is_available()}", file=sys.stderr)
            return NO_CARD
        device = "cuda"
    on_card = device == "cuda"

    from repro_torch.api import Session

    from ktbench.devtrace import SpanSums, profiled
    from ktbench.clients import Records, make_driver

    traffic = cell.traffic
    t_inputs = time.perf_counter()
    driver = make_driver(cell.config, traffic, args.seed, device)
    if on_card:  # the peak is the program's: the stream's strata ran the reference
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    session = Session(device=device, max_batch=traffic["max_batch"], trace=bool(args.trace),
                      faults=None)
    driver.open(session)
    driver.warm()
    sums = None
    if args.trace:
        sums = session.obs.tracer = SpanSums()  # the window's spans, summed by name
    if on_card:
        torch.cuda.synchronize()
    rec = Records(sample=traffic["check_sample"],
                  rng=random.Random(generators.derived_seed(args.seed, 7)))
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    window_s = driver.run(rec, seconds=args.seconds)
    window = Window(window_s, setup_s, list(rec.latencies), rec.work)
    summary = driver.summary()
    spans = sums.snapshot() if sums is not None else {}
    stretch = None
    if args.trace and on_card:
        first = len(rec.answers)
        stretch = profiled(lambda: driver.run(rec, requests=traffic["profile_requests"]), sums)
        stretch.requests = rec.answers[first:]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.close()
    del session
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    readings, truths = check.compare(driver, rec, device)
    t_check = time.perf_counter() - t_check
    correct = check.verdict(readings)
    if args.trace:
        ctx = Context(cell, driver, spans, len(window.latencies), stretch, truths, device)
        wanted = cell.per_layer
    else:
        ctx = window
        wanted = cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader("layer_metrics" if args.trace else "end_to_end", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    loaded = forbidden_modules()
    if loaded:
        print(f"ktbench: forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return JAX_LOADED

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if stretch is not None:
        dev["busy_s"] = stretch.busy_s
        dev["window_s"] = stretch.window_s
    if window.latencies:
        q = np.percentile(np.asarray(window.latencies) * 1e3, [50, 90, 95, 99, 100])
        print("ktbench: window latency ms p50 %.3f p90 %.3f p95 %.3f p99 %.3f max %.3f over %d"
              % (*q, len(window.latencies)), file=sys.stderr)
    for text in summary:
        print(f"ktbench: window {text}", file=sys.stderr)
    for err in rec.errors[:20]:
        print(f"ktbench: {err}", file=sys.stderr)
    print(f"ktbench: {cell.name} seed {args.seed}: window {window_s:.3f} s, "
          f"{rec.attempted} attempted, {rec.failed} failed, set-up {setup_s:.3f} s (start and "
          f"imports {t_inputs - t_start:.3f}, inputs {t_warm - t_inputs:.3f} ("
          + ", ".join(f"{k} {v:.3f}" for k, v in driver.setup_split.items())
          + f"), session and warm "
          f"requests {t_window - t_warm:.3f}); "
          f"the check {t_check:.3f} s; card {card_line() if on_card else 'none'}", file=sys.stderr)
    checks = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in readings.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    line = {"correct": correct, "attempted": rec.attempted, "failed": rec.failed,
            "metrics": metrics, "device": dev}
    if stretch is not None:
        line["breakdown"] = stretch.breakdown()
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
