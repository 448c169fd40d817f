"""A program counter summed over its label sets, for the per-layer readers
that read labelled counters (``ktbench.program_counters`` reads each
series by its full key)."""

from __future__ import annotations

from ktbench.program_counters import counters

__all__ = ["summed"]


def summed(name: str) -> float | None:
    """The sum of every series of counter ``name`` (``name`` and each
    ``name{labels}``), or ``None`` where the program files none."""
    found = [v for k, v in counters().items() if k == name or k.startswith(name + "{")]
    return sum(found) if found else None
