"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["canonical_device", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no CUDA device is present: the port never drops to the
    CPU on its own; a caller that wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def canonical_device(device) -> torch.device:
    """``device`` with its CUDA index made explicit (``"cuda"`` names the
    current CUDA device), so that two spellings of one card compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
