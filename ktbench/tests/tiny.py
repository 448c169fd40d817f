"""A copy of the benchmark with tiny cells added as files, for the CPU
tests: ``tiny_copy`` copies ``BENCHMARK.json`` and ``ktbench/`` into a
folder and adds a tiny configuration and three cells that reuse the real
mixes; ``run_cell`` runs one cell there on the CPU in a new process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

CELLS = {  # tiny cell -> (configuration, mix, the real cell whose metrics it reports)
    "t_dec": ("tiny-rmat", "decompose_alt2", "g500_decompose"),
    "t_st": ("tiny-rmat", "stream_w1", "g500_stream_w1"),
    "t_c8": ("tiny-rmat", "decompose_alt2_c8", "g500_decompose"),
}


def tiny_copy(dest: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "ktbench", dest / "ktbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    configs = dest / "ktbench" / "configs"
    rmat = json.loads((configs / "graph500-s18.json").read_text())
    rmat.update(name="tiny-rmat", scale=8, edge_factor=4)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    (configs / "tiny-rmat.json").write_text(json.dumps(rmat))
    bench["configs"].append({"name": "tiny-rmat", "source": "tiny", "why": "CPU test",
                             "file": "ktbench/configs/tiny-rmat.json", "reduced": ["scale"]})
    for cell, (config, mix, like) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                                   "why": "CPU test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def run_cell(root: Path, cell: str, *, seed: int = 2_147_483_659, seconds: float = 1.0,
             trace: int = 0, prelude: str = "", timeout: float = 240.0):
    """Run ``cell`` in the copy at ``root`` on the CPU; ``prelude`` is
    Python run first (a fault planted in the program).  Returns
    ``(returncode, result line or None, stderr)``."""
    code = (
        f"import sys; sys.path.insert(0, {str(root)!r})\n{prelude}\n"
        "from ktbench.run import main\n"
        f"sys.exit(main(['--workload', {cell!r}, '--seed', '{seed}', '--seconds', '{seconds}', "
        f"'--trace', '{trace}'], device='cpu'))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr
