"""Hand-written Hopper kernel for owner-mode fine-grained support.

``support_fine_cuda(p, alive)`` launches ``csrc/support_fine.cu`` and
returns the ``(nnz_pad,)`` int32 support that
:func:`repro_torch.core.eager_fine.support_fine_owner` (its plain version)
computes, bit for bit.  It replaces the TPU kernel
``repro.kernels.support_fine.support_fine_pallas`` *and* the window gather
that feeds it there (``repro.kernels.ops.support_fine``): a warp reads its
own CSR rows, so the ``(E, W)`` window arrays — about 16 GiB per support
pass at ``W = 4096`` over 262,144 lanes — never exist.

The kernel works from a worklist (:func:`worklist`): the alive real lanes,
each one work item, except that a lane whose shorter row has more than
:data:`~repro_torch.kernels.peel_fused.SPLIT_ROW` entries is
:data:`~repro_torch.kernels.peel_fused.SPLIT_WAYS` items, chunks of that
row (the fused kernel's rule, :func:`~repro_torch.kernels.peel_fused.split_lanes`).
Each entry of an item's chunk is binary-searched in the longer row.
:func:`support_fine_items` computes the support by that same
decomposition in torch ops, on the CPU, so that the CPU tests check the
split arithmetic.  See the source for the design and what bounds it.

The library is built from the checkout on the first launch
(:mod:`repro_torch.kernels.build`); a build or launch failure raises.
``support_fine_cuda.launches`` counts calls that launched the kernel (one
per support pass; each call is two launches on the stream: the worklist,
then the items).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core.eager_fine import FineProblem, undirected_alive
from ..errors import DeviceError
from .build import BuiltLibrary, load_library
from .peel_fused import SPLIT_ROW, SPLIT_WAYS, split_lanes

__all__ = [
    "support_fine_cuda",
    "support_fine_items",
    "load_support_fine",
    "worklist",
    "worklist_elements",
    "Worklist",
]

_FIELDS = ("edge_row", "colidx", "urowptr", "udeg", "ucolidx", "u2d")
# Threads per block of the two launches (worklist, items).
_LAUNCH_THREADS = (256, 256)
# `counts`: a 64-bit item cursor (two words) and the two list lengths.
_COUNTER_WORDS = 4


class Worklist(NamedTuple):
    """The kernel's worklist for one alive mask (int64 lane ids, ascending)."""

    unsplit: torch.Tensor  # lanes that are one work item each
    split: torch.Tensor  # lanes that are SPLIT_WAYS work items each

    @property
    def items(self) -> int:
        return int(self.unsplit.numel()) + SPLIT_WAYS * int(self.split.numel())


def worklist(p: FineProblem, alive: torch.Tensor) -> Worklist:
    """The lanes the kernel lists for ``alive``: the alive real lanes,
    split by :func:`~repro_torch.kernels.peel_fused.split_lanes` over the
    whole rows (``udeg``), which the kernel walks uncompacted."""
    listed = alive & (p.colidx != 0)
    split = split_lanes(p, listed, p.udeg)
    return Worklist(
        unsplit=torch.nonzero(listed & ~split).flatten(),
        split=torch.nonzero(split).flatten(),
    )


def worklist_elements(nnzp: int, unnzp: int) -> dict[str, int]:
    """Elements of each scratch buffer of one :func:`support_fine_cuda`
    call: the undirected alive flags (``ualive``, uint8), the worklist
    (``list``, int32: unsplit lanes from the front, split lanes from the
    back, each listed lane once) and ``counts`` (int32, zeroed)."""
    return {"ualive": unnzp, "list": nnzp, "counts": _COUNTER_WORDS}


def _row_start(urowptr: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, urowptr[(v - 1).clamp(min=0)].long(), 0)


def _lower_bound(col: torch.Tensor, base: torch.Tensor, hi: torch.Tensor, v: torch.Tensor):
    """Per probe, the first index in [0, hi) of the ascending run of ``col``
    at ``base`` that is >= v (hi when none is): the kernel's search."""
    lo = torch.zeros_like(hi)
    hi = hi.clone()
    last = col.numel() - 1
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) // 2
        right = active & (col[(base + mid).clamp(0, max(last, 0))].long() < v)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def support_fine_items(p: FineProblem, alive: torch.Tensor) -> torch.Tensor:
    """The support by the kernel's own decomposition, in torch ops (CPU).

    Every item of :func:`worklist` (split lanes' chunks first, as the
    kernel orders them) is flattened into probes: each entry of the item's
    chunk of the shorter row is binary-searched in the longer row, and a
    probe counts where both entries are alive.  Items' counts are summed
    into their lanes with ``index_add_``.  Equals
    :func:`~repro_torch.core.eager_fine.support_fine_owner` bit for bit.
    """
    if alive.device.type != "cpu":
        raise ValueError(f"support_fine_items runs on the CPU only, got {alive.device}")
    nnzp = p.nnz_pad
    wl = worklist(p, alive)
    ualive = undirected_alive(p, alive)
    n_split, n_unsplit = int(wl.split.numel()), int(wl.unsplit.numel())
    lanes = torch.cat([wl.split.repeat_interleave(SPLIT_WAYS), wl.unsplit])
    chunk = torch.cat([torch.arange(SPLIT_WAYS).repeat(n_split), torch.zeros(n_unsplit).long()])
    ways = torch.cat([torch.full((n_split * SPLIT_WAYS,), SPLIT_WAYS), torch.ones(n_unsplit).long()])
    a, b = p.edge_row[lanes].long(), p.colidx[lanes].long()
    da, db = p.udeg[a].long(), p.udeg[b].long()
    a_short = da <= db
    ds, dl = torch.where(a_short, da, db), torch.where(a_short, db, da)
    length = (ds + ways - 1) // ways
    lo = chunk * length
    n = (torch.minimum(lo + length, ds) - lo).clamp(min=0)
    s0 = _row_start(p.urowptr, torch.where(a_short, a, b)) + lo
    l0 = _row_start(p.urowptr, torch.where(a_short, b, a))

    # The probes of all items end to end, as a warp flattens its items.
    item = torch.repeat_interleave(torch.arange(lanes.numel()), n)
    first = torch.cumsum(n, 0) - n
    u = s0[item] + (torch.arange(item.numel()) - first[item])
    v = p.ucolidx[u].long()
    pos = _lower_bound(p.ucolidx, l0[item], dl[item], v)
    at = (l0[item] + pos).clamp(max=max(p.ucolidx.numel() - 1, 0))
    hit = ualive[u] & (pos < dl[item]) & (p.ucolidx[at].long() == v) & ualive[at]
    per_item = torch.zeros(lanes.numel(), dtype=torch.int32).index_add_(
        0, item, hit.to(torch.int32)
    )
    return torch.zeros(nnzp, dtype=torch.int32).index_add_(0, lanes, per_item)


def load_support_fine() -> BuiltLibrary:
    """Build (on first use) and load the kernel library; ctypes signatures set."""
    built = load_library("support_fine")
    fn = built.lib.support_fine_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    err = built.lib.support_fine_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return built


def _check(p: FineProblem, alive: torch.Tensor) -> None:
    dev = alive.device
    if dev.type != "cuda":
        raise ValueError(f"support_fine_cuda needs CUDA tensors, got {dev}")
    if alive.dtype != torch.bool or alive.shape != (p.nnz_pad,):
        raise ValueError(
            f"alive must be bool of shape ({p.nnz_pad},), got {alive.dtype} {tuple(alive.shape)}"
        )
    for name in _FIELDS:
        x = getattr(p, name)
        if x.device != dev or x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(
                f"problem field {name!r} must be a contiguous int32 tensor on {dev}, "
                f"got {x.dtype} on {x.device}"
            )


def support_fine_cuda(p: FineProblem, alive: torch.Tensor) -> torch.Tensor:
    """Owner-mode support of every directed lane, by the CUDA kernel."""
    _check(p, alive)
    built = load_support_fine()
    dev = alive.device
    alive = alive.contiguous()
    nnzp, unnzp = p.nnz_pad, int(p.ucolidx.shape[0])
    n = worklist_elements(nnzp, unnzp)
    out = torch.zeros(nnzp, dtype=torch.int32, device=dev)
    counts = torch.zeros(n["counts"], dtype=torch.int32, device=dev)
    ualive = torch.empty(n["ualive"], dtype=torch.uint8, device=dev)
    lst = torch.empty(n["list"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = built.lib.support_fine_launch(
            p.edge_row.data_ptr(),
            p.colidx.data_ptr(),
            alive.data_ptr(),
            p.urowptr.data_ptr(),
            p.udeg.data_ptr(),
            p.ucolidx.data_ptr(),
            p.u2d.data_ptr(),
            ualive.data_ptr(),
            lst.data_ptr(),
            counts.data_ptr(),
            out.data_ptr(),
            nnzp,
            unnzp,
            SPLIT_ROW,
            SPLIT_WAYS,
            *_LAUNCH_THREADS,
            stream,
        )
    if rc:
        msg = built.lib.support_fine_error_string(rc).decode()
        raise DeviceError(
            f"support_fine kernel launch failed: {msg} (cudaError {rc})", site="support_fine"
        )
    support_fine_cuda.launches += 1
    return out


support_fine_cuda.launches = 0
