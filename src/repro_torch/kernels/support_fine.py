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
then the items).  A call made while its stream is being captured into a
CUDA graph launches nothing then, and the graph may run it many times or
none: such a call must be made inside :func:`count_launches_on_device`,
and its worklist kernel then adds one to that device counter each time it
runs (and, when a lane counter is given, each run adds the lanes its
worklist listed to that counter too; when a claim counter is given, the
global claims and reservations the two launches made).  The graph's owner
reads the counter back and adds it to ``launches``
(``repro_torch.exec.peel._TripGraph``), so every launch is counted by the
kernel that ran.

The items launch claims work per block, not per warp: a block claims a
batch of items from the global cursor with one atomic, and its warps draw
from the batch in shared memory; the worklist launch reserves a tile's
listed lanes with one atomic per half of the list.  :func:`claim_bounds`
gives the least and the most such claims a pass can make.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Iterator, NamedTuple

import torch

from ..core.eager_fine import FineProblem, undirected_alive
from ..errors import DeviceError
from .build import BuiltLibrary, load_library
from .peel_fused import SPLIT_ROW, SPLIT_WAYS, split_lanes

__all__ = [
    "support_fine_cuda",
    "count_launches_on_device",
    "support_fine_items",
    "claim_bounds",
    "load_support_fine",
    "worklist",
    "worklist_elements",
    "Worklist",
]

_FIELDS = ("edge_row", "colidx", "urowptr", "udeg", "ucolidx", "u2d")
# Threads per block of the two launches (worklist, items).
_LAUNCH_THREADS = (512, 512)
# `counts`: a 64-bit chunk cursor (two words), the two list lengths and the
# launches' global claims and reservations.
_COUNTER_WORDS = 5
_LIST_LENGTHS = slice(2, 4)  # the unsplit and split lanes the worklist kernel listed
_CLAIMS = 4
# What the kernels fix at compile time (csrc/support_fine.cu): the items
# launch's blocks per SM, the lanes a worklist thread classifies a tile, the
# most items a warp draws, the fewest draws a warp should get, the most
# chunks a block claims at once, and the blocks over which a claim spreads
# what is unclaimed (times the grid).
_BLOCKS_PER_SM, _TILE_STEPS, _MAX_CLAIM, _MIN_DRAWS = 4, 16, 8, 12
_MAX_BATCH_CHUNKS, _GUIDE = 255, 3
# .counter, .lanes, .claims: this thread's device counters, if any
_capture = threading.local()


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
    back, each listed lane once) and ``counts`` (int32, zeroed: the chunk
    cursor, the two list lengths, the claims)."""
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


def _item_chunks(n_items: int, sms: int) -> tuple[int, int]:
    """The items launch's blocks on a card of ``sms`` SMs, and the chunks of
    a list of ``n_items`` items: a chunk is one draw of ``share`` items
    (``_MAX_CLAIM``, fewer when the list cannot give every warp of the grid
    ``_MIN_DRAWS`` draws) for each warp of a block."""
    blocks = _BLOCKS_PER_SM * sms
    warps = _LAUNCH_THREADS[1] // 32
    share = min(_MAX_CLAIM, max(1, -(-n_items // (blocks * warps * _MIN_DRAWS))))
    return blocks, -(-n_items // (share * warps))


def _batch_chunks(left: int, blocks: int) -> int:
    """The chunks a block claims when it reads ``left`` chunks unclaimed."""
    return min(_MAX_BATCH_CHUNKS, -(-left // (_GUIDE * blocks)))


def _batch_claim_bounds(n_items: int, sms: int) -> tuple[int, int]:
    """The least and the most global claims of the items launch on a list of
    ``n_items`` items (see :func:`claim_bounds`)."""
    blocks, n_chunks = _item_chunks(n_items, sms)
    if n_chunks == 0:
        return 0, 0
    claimed = exact = 0
    while claimed < n_chunks:
        claimed += _batch_chunks(n_chunks - claimed, blocks)
        exact += 1
    return -(-n_chunks // _batch_chunks(n_chunks, blocks)), exact + blocks


def claim_bounds(p: FineProblem, alive: torch.Tensor, sms: int) -> tuple[int, int]:
    """The least and the most global claims and reservations one
    :func:`support_fine_cuda` pass on ``alive`` makes on a card of ``sms``
    SMs: what the kernels add to ``counts`` (and a captured pass to its
    claim counter).

    The worklist launch reserves once for each half of the list (unsplit,
    split) that lists a lane of a tile (``_TILE_STEPS`` lanes a thread):
    exactly that many.  The items launch's blocks claim batches of whole
    chunks (:func:`_item_chunks`); a claim takes the unclaimed chunks over
    ``_GUIDE`` times the blocks, at least one and at most
    ``_MAX_BATCH_CHUNKS``, by a read of
    the cursor that may lag the claims of other blocks.  A lagging read
    only makes a batch larger, so the claims are at most those of the same
    rule on exact reads, and at least the chunks over the first batch's
    size; each block may make one more claim that finds the list used up."""
    wl = worklist(p, alive)
    tile = _LAUNCH_THREADS[0] * _TILE_STEPS
    reservations = sum(int(torch.unique(lanes // tile).numel()) for lanes in wl)
    least, most = _batch_claim_bounds(wl.items, sms)
    return reservations + least, reservations + most


def load_support_fine() -> BuiltLibrary:
    """Build (on first use) and load the kernel library; ctypes signatures set."""
    built = load_library("support_fine")
    fn = built.lib.support_fine_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 2
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


@contextlib.contextmanager
def count_launches_on_device(
    counter: torch.Tensor, lanes: torch.Tensor | None = None, claims: torch.Tensor | None = None
) -> Iterator[None]:
    """Inside the block, in this thread, a :func:`support_fine_cuda` call
    captured into a CUDA graph passes ``counter`` (one int32 on the card)
    to its kernel, which adds one to it every time the graph launches it.
    With ``lanes`` (one int64 on the card), each run of the call also adds
    to it the lanes its worklist listed: the alive real lanes of its mask,
    whose supports it counts.  With ``claims`` (one int64 on the card),
    each run adds the global claims and reservations its two launches made
    (:func:`claim_bounds`)."""
    given = (("counter", counter, torch.int32), ("lanes", lanes, torch.int64),
             ("claims", claims, torch.int64))
    for name, t, dtype in given:
        if t is not None and (t.dtype != dtype or t.numel() != 1 or not t.is_cuda):
            raise ValueError(
                f"{name} must be one CUDA {dtype}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    outer = tuple(getattr(_capture, name, None) for name, _, _ in given)
    _capture.counter, _capture.lanes, _capture.claims = counter, lanes, claims
    try:
        yield
    finally:
        _capture.counter, _capture.lanes, _capture.claims = outer


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
        captured = torch.cuda.is_current_stream_capturing()
        counter = getattr(_capture, "counter", None) if captured else None
        lanes = getattr(_capture, "lanes", None) if captured else None
        claims = getattr(_capture, "claims", None) if captured else None
        if captured and (counter is None or counter.device != dev):
            raise ValueError(
                "support_fine_cuda captured into a CUDA graph needs a launch counter on "
                f"{dev} (count_launches_on_device)"
            )
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
            None if counter is None else counter.data_ptr(),
        )
    if rc:
        msg = built.lib.support_fine_error_string(rc).decode()
        raise DeviceError(
            f"support_fine kernel launch failed: {msg} (cudaError {rc})", site="support_fine"
        )
    if not captured:  # a captured launch counts on the device, each time it runs
        support_fine_cuda.launches += 1
    if lanes is not None:
        lanes.add_(counts[_LIST_LENGTHS].sum())
    if claims is not None:
        claims.add_(counts[_CLAIMS])
    return out


support_fine_cuda.launches = 0
