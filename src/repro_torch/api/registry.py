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
                    hand-written CUDA support kernel
                    (``repro_torch.kernels.support_fine``) on CUDA
                    tensors, its plain version on CPU tensors |
                    ``fused``: the hand-written fused level kernel
                    (``repro_torch.kernels.peel_fused``), one launch per
                    truss level, autotuned per bucket;
* ``layout``      — ``contig`` (prefix-sum packed lanes) | ``aligned``
                    (slot-aligned lanes; the only layout whose slot-banded
                    lane geometry the fused kernel can tile).

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
    "fallback_backends",
    "runs_hand_kernel",
]

FORMULATIONS = ("coarse", "fine")
KERNELS = ("xla", "pallas", "fused")
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
        fused_config=None,
    ):
        """Build this backend's :class:`repro_torch.exec.PeelExecutor` for
        one shape bucket.  ``mode`` overrides the spec's dataflow;
        ``fused_config`` is the ``kernel="fused"`` tuning point
        (``repro_torch.kernels.autotune``), ignored by the other kernels."""
        from ..exec.peel import PeelExecutor  # lazy: registry stays import-light

        return PeelExecutor(
            granularity=self.key.formulation,
            mode=mode or self.mode,
            backend=self.key.kernel,
            window=window,
            chunk=chunk,
            max_iters=max_iters,
            fused_config=fused_config,
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

    otherwise fine.  The hand kernels implement the fine formulation only,
    so ``kernel="pallas"`` or ``"fused"`` forces ``fine``.  On the
    hand-kernel path (``kernel="pallas"``, the CUDA default) a *heavily*
    imbalanced bucket (``coarse_imbalance > 8``) is upgraded to the fused
    level kernel when its aligned variant is registered: a heavy degree
    tail means long peel tails with mostly-dead lanes, where the fused
    kernel's dead-tile skipping and one-readback-per-level pay.  Every
    backend returns identical results, so a wrong guess costs time, never
    correctness.  The rule is the reference's, verbatim.
    """
    kernel = kernel or default_kernel()
    balanced = stats.coarse_lane_efficiency >= 0.4 and stats.coarse_imbalance <= 2.5
    formulation = "coarse" if (balanced and kernel not in ("pallas", "fused")) else "fine"
    if (
        kernel == "pallas"
        and layout == "aligned"
        and stats.coarse_imbalance > 8.0
        and BackendKey("fine", "fused", layout) in _REGISTRY
    ):
        kernel = "fused"
    key = BackendKey(formulation, kernel, layout)
    if key not in _REGISTRY:
        raise KeyError(f"auto-chosen backend {key} is not registered")
    return key


# The kernels whose backends run one of the port's hand-written CUDA
# kernels: ``pallas`` the support kernel, ``fused`` the fused level kernel.
HAND_KERNELS = ("pallas", "fused")


def runs_hand_kernel(key: Union[BackendKey, str, tuple], device) -> bool:
    """Does ``key`` launch a hand-written CUDA kernel on ``device``?

    On the CPU every backend runs its plain torch version, so only a CUDA
    device counts.  The port's kernel-fault rule and its fallback chain
    both read this one predicate (``Planner.execute``, :func:`fallback_backends`).
    """
    return get_backend(key).key.kernel in HAND_KERNELS and torch.device(device).type == "cuda"


def fallback_backends(
    key: Union[BackendKey, str, tuple], *, device=None
) -> tuple[BackendKey, ...]:
    """The degradation chain below ``key``, most-capable first.

    The reference's chain, step for step: every registered backend is
    bit-identical, so falling down it on a compile/kernel fault trades
    performance for availability, never correctness.  The chain steps down
    one axis at a time and **preserves the layout**:

    1. ``fused -> pallas`` — same formulation, same layout: the fused
       level kernel's unfused twin, the hand-written support kernel;
    2. ``pallas -> xla`` — same formulation, same layout: the torch-ops
       twin;
    3. ``fine -> coarse`` on ``xla`` — the row-task formulation as the
       last resort.

    Only registered keys are returned, and never ``key`` itself.  On a
    CUDA ``device`` a hand-kernel backend never steps down to a torch-ops
    one: its chain keeps only hand-kernel backends (``fused -> pallas``),
    so no fault, injected or not, is answered by a plain version on the
    card.  ``device=None`` gives the reference's chain.
    """
    key = get_backend(key).key
    chain: list[BackendKey] = []
    if key.kernel == "fused":
        chain.append(BackendKey(key.formulation, "pallas", key.layout))
    if key.kernel in ("pallas", "fused"):
        chain.append(BackendKey(key.formulation, "xla", key.layout))
    if key.formulation == "fine":
        chain.append(BackendKey("coarse", "xla", key.layout))
    if device is not None and runs_hand_kernel(key, device):
        chain = [k for k in chain if k.kernel in HAND_KERNELS]
    return tuple(k for k in chain if k != key and k in _REGISTRY)


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
    # The fused kernel tiles the aligned layout's slot-banded lane
    # geometry; there is no contig variant (a contig pack interleaves
    # members' lanes, which its per-slot reductions cannot band).
    register_backend(
        BackendSpec(
            key=BackendKey("fine", "fused", "aligned"),
            mode="owner",
            description=(
                "hand-written fused CUDA level kernel: support + prune + level "
                "bookkeeping in one launch per level, autotuned per bucket "
                "(repro_torch.kernels.autotune)"
            ),
        )
    )


_register_defaults()
