"""CLI: ``python -m repro_torch.analysis``.

Exit codes: 0 clean (or everything baselined), 2 new findings, 3 stale
baseline entries (a baselined finding was fixed — regenerate with
``--write-baseline`` to shrink the baseline).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import (
    AnalysisConfig,
    apply_baseline,
    load_baseline,
    render_text,
    report_dict,
    run,
    write_baseline,
)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static analysis of the PyTorch port (rules R1-R6)",
    )
    parser.add_argument(
        "--root", default=".", help="repository root (default: cwd)"
    )
    parser.add_argument(
        "--baseline",
        default="src/repro_torch/analysis/baseline.json",
        help="baseline file, relative to --root",
    )
    parser.add_argument(
        "--report", default=None, help="write a JSON report to this path"
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="accept all current findings into the baseline and exit 0",
    )
    parser.add_argument("--quiet", action="store_true")
    args = parser.parse_args(argv)

    root = Path(args.root).resolve()
    config = AnalysisConfig.default(root)
    findings = run(config)

    baseline_path = root / args.baseline
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        if not args.quiet:
            print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    new, baselined, stale = apply_baseline(findings, baseline)

    if args.report:
        Path(args.report).write_text(
            json.dumps(report_dict(new, baselined, stale, config), indent=2)
            + "\n"
        )
    if not args.quiet:
        print(render_text(new, baselined, stale))
    if new:
        return 2
    if stale:
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
