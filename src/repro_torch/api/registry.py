"""Backend registry: formulation × kernel × layout, chosen per shape bucket.

The paper's subject is a *formulation* choice — coarse row tasks
(Algorithm 2) vs. fine nonzero tasks (Algorithm 3) of Eager K-truss — and
its result is that the right choice is input-dependent: fine wins under
load imbalance, while the row formulation is competitive on balanced
graphs.  The grid keeps the reference's spellings, so a ``backend=``
string names the same point in both packages:

* ``formulation`` — ``coarse`` (row tasks) | ``fine`` (nonzero tasks);
* ``kernel``      — ``xla``: the torch-ops twins (the name is the
                    reference's) | ``pallas``: in the port, the
                    hand-written CUDA kernel
                    (``repro_torch.kernels.support_fine``) on CUDA
                    tensors, its plain version on CPU tensors.  The
                    reference's third kernel, ``fused``, is not ported
                    yet;
* ``layout``      — ``contig`` (prefix-sum packed lanes) | ``aligned``
                    (slot-aligned lanes).

Every registered backend is *semantically identical* — bit-identical
``trussness`` on any graph — so :func:`choose_backend` is purely a
performance policy keyed on the paper's imbalance statistics.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import torch

from ..graphs.stats import ImbalanceStats

__all__ = [
    "FORMULATIONS",
    "KERNELS",
    "LAYOUTS",
    "BackendKey",
    "BackendSpec",
    "register_backend",
    "get_backend",
    "available_backends",
    "choose_backend",
    "default_kernel",
]

FORMULATIONS = ("coarse", "fine")
KERNELS = ("xla", "pallas")
LAYOUTS = ("contig", "aligned")


class BackendKey(NamedTuple):
    """One point of the backend grid; the registry and compile-cache key."""

    formulation: str  # coarse | fine
    kernel: str  # xla | pallas
    layout: str  # contig | aligned

    def __str__(self) -> str:  # "fine/xla/aligned" — the CLI/bench spelling
        return "/".join(self)


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """A registered backend: its key plus how to build its executor.

    ``mode`` is the update dataflow the support uses (``eager`` scatter vs
    ``owner`` collision-free); the CUDA kernel is owner-form by
    construction.
    """

    key: BackendKey
    mode: str = "eager"
    description: str = ""

    def make_executor(
        self,
        *,
        window: int,
        chunk: int = 256,
        max_iters: int | None = None,
        mode: str | None = None,
    ):
        """Build this backend's :class:`repro_torch.exec.PeelExecutor` for
        one shape bucket.  ``mode`` overrides the spec's dataflow."""
        from ..exec.peel import PeelExecutor  # lazy: registry stays import-light

        return PeelExecutor(
            granularity=self.key.formulation,
            mode=mode or self.mode,
            backend=self.key.kernel,
            window=window,
            chunk=chunk,
            max_iters=max_iters,
        )


_REGISTRY: dict[BackendKey, BackendSpec] = {}


def register_backend(spec: BackendSpec, *, overwrite: bool = False) -> BackendSpec:
    """Add ``spec`` to the registry (axes validated; duplicates rejected)."""
    key = spec.key
    if key.formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation {key.formulation!r} ({FORMULATIONS})")
    if key.kernel not in KERNELS:
        raise ValueError(f"unknown kernel {key.kernel!r} ({KERNELS})")
    if key.layout not in LAYOUTS:
        raise ValueError(f"unknown layout {key.layout!r} ({LAYOUTS})")
    if key in _REGISTRY and not overwrite:
        raise ValueError(f"backend {key} already registered")
    _REGISTRY[key] = spec
    return spec


def get_backend(key: Union[BackendKey, str, tuple]) -> BackendSpec:
    """Resolve a key, 3-tuple, or ``"formulation/kernel/layout"`` string."""
    if isinstance(key, str):
        parts = tuple(key.split("/"))
        if len(parts) != 3:
            raise ValueError(
                f"backend string must be 'formulation/kernel/layout', got {key!r}"
            )
        key = BackendKey(*parts)
    elif not isinstance(key, BackendKey):
        key = BackendKey(*key)
    spec = _REGISTRY.get(key)
    if spec is None:
        raise KeyError(
            f"no backend registered for {key}; available: "
            f"{[str(k) for k in available_backends()]}"
        )
    return spec


def available_backends() -> tuple[BackendKey, ...]:
    """Every registered key, in a stable order (the parity-test axis)."""
    return tuple(sorted(_REGISTRY))


def default_kernel(device: str | torch.device | None = None) -> str:
    """``pallas`` (the CUDA kernel) for a CUDA device, ``xla`` (the
    torch-ops twins) for the CPU.  ``None`` asks whether CUDA is present."""
    if device is None:
        return "pallas" if torch.cuda.is_available() else "xla"
    return "pallas" if torch.device(device).type == "cuda" else "xla"


def choose_backend(
    stats: ImbalanceStats,
    *,
    kernel: str | None = None,
    layout: str = "aligned",
) -> BackendKey:
    """The auto rule: pick a formulation from the paper's imbalance stats.

    The coarse (row-task) formulation pads every row task to the longest
    one, so its cost inflates by ``1 / coarse_lane_efficiency``; the fine
    (nonzero-task) formulation is insensitive to the degree tail (paper
    §III-A).  Coarse therefore only wins on near-balanced graphs:

      coarse  iff  coarse_lane_efficiency >= 0.4 and coarse_imbalance <= 2.5

    otherwise fine.  The kernel axis implements the fine formulation only,
    so ``kernel="pallas"`` forces ``fine``.  (The reference also upgrades
    a heavily imbalanced ``pallas`` pick to its fused megakernel; the port
    has no fused backend yet, so it keeps ``fine/pallas`` there — with
    identical results.)
    """
    kernel = kernel or default_kernel()
    balanced = stats.coarse_lane_efficiency >= 0.4 and stats.coarse_imbalance <= 2.5
    formulation = "coarse" if (balanced and kernel != "pallas") else "fine"
    key = BackendKey(formulation, kernel, layout)
    if key not in _REGISTRY:
        raise KeyError(f"auto-chosen backend {key} is not registered")
    return key


def _register_defaults() -> None:
    for layout in LAYOUTS:
        register_backend(
            BackendSpec(
                key=BackendKey("coarse", "xla", layout),
                mode="eager",
                description="row tasks (Alg. 2) on torch ops",
            )
        )
        register_backend(
            BackendSpec(
                key=BackendKey("fine", "xla", layout),
                mode="eager",
                description="nonzero tasks (Alg. 3) on torch index_add_",
            )
        )
        register_backend(
            BackendSpec(
                key=BackendKey("fine", "pallas", layout),
                mode="owner",
                description="nonzero tasks, collision-free hand-written CUDA kernel",
            )
        )


_register_defaults()
