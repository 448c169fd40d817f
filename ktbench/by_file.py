"""Parts of a cell that are found by file: a configuration's graph
generator (``graph_generators/<generator>.py``) and a traffic mix's
driver (``drivers/<kind>.py``), each loaded by path the way
:func:`ktbench.spec.load_reader` loads a metric's reader."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

__all__ = ["load"]

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def load(folder: str, name: str, what: str):
    """The module ``<folder>/<name>.py`` beside this file.  A name that is
    no file there raises ``ValueError`` naming the path looked at."""
    path = HERE / folder / f"{name}.py"
    if not NAME.fullmatch(name) or not path.is_file():
        raise ValueError(f"unknown {what} {name!r}: no file {path}")
    spec = importlib.util.spec_from_file_location(f"ktbench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
