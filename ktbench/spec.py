"""What one cell is: found by name from ``BENCHMARK.json`` and the files
beside the harness.

A cell (an entry of ``workloads``) names a configuration, found at the
``file`` its ``configs`` entry gives, and a traffic mix, found at
``ktbench/traffic/<traffic>.json``.  An end-to-end metric is read by
``ktbench/end_to_end/<name>.py``, a per-layer one by
``ktbench/layer_metrics/<name>.py``.  A configuration's ``generator``
other than ``rmat`` is found at ``ktbench/graph_generators/<generator>.py``
(:func:`ktbench.generators.config_graph`), and a mix's ``kind`` other than
``decompose`` and ``stream`` at ``ktbench/drivers/<kind>.py``
(:func:`ktbench.clients.make_driver`).  Adding a configuration, a mix, a
cell or a metric is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

__all__ = ["Cell", "load_cell", "load_reader", "HERE"]

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    root: Path  # the checkout: BENCHMARK.json's folder
    config: dict  # the configuration's file
    traffic: dict  # the mix's file
    end_to_end: list[dict]  # this cell's end-to-end metrics, as BENCHMARK.json lists them
    per_layer: list[dict]  # this cell's per-layer metrics
    chips: int


def _reports(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    """A per-layer metric is read in the cells it lists, or else in every
    cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in e2e_names


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of the ``BENCHMARK.json`` at ``root`` (default:
    the folder above this package)."""
    root = Path(root) if root is not None else HERE.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / config_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, root, config, traffic, e2e, per_layer, int(w["chips"]))


def load_reader(kind: str, metric: str):
    """The reader module of a metric: ``end_to_end/<metric>.py`` or
    ``layer_metrics/<metric>.py`` (names may hold dots).  Its ``read(ctx)``
    returns the metric's value, or ``None`` when it finds nothing to read."""
    path = HERE / kind / f"{metric}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"ktbench_{kind}_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
