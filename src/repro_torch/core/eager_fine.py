"""Fine-grained parallel Eager K-truss support computation (Algorithm 3).

One task per **nonzero** (edge) of the upper-triangular adjacency.  Task
``t`` — the j-th nonzero of row ``i`` with column ``κ = colidx[t]`` —
intersects the row-``i`` suffix ``a_i12[j+1:]`` with row ``A(κ,:)`` and
performs the paper's three eager updates:

  u1:  S[t]            += |suffix ∩ N⁺(κ)|      (edge (i,κ) itself)
  u2:  S[pos of m in i] += 1  per match m        (edges (i,m))
  u3:  S[pos of m in κ] += 1  per match m        (edges (κ,m))

Two execution modes, as in ``repro.core.eager_fine``:

* ``eager`` — the faithful dataflow: ``index_add_`` replaces GPU atomics
  (integer sums, so the result is exact in any order).
* ``owner`` — collision-free reformulation: each edge's support is
  computed wholly by its own task as |N(a) ∩ N(b)| over the *undirected*
  alive neighbourhoods.  This is the function the CUDA kernel
  (``repro_torch.kernels.support_fine``) computes.

Tasks run in blocks of a multiple of ``chunk`` lanes: a Python loop takes
the place of the reference's ``lax.scan``, and the block grows with the
window so each ``(block, window)`` intermediate stays near
``_WINDOW_ELEMS`` elements (a few hundred MiB of intermediates at most).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.csr import CSRGraph
from .taskmap import sorted_window_member

__all__ = [
    "FineProblem",
    "prepare_fine",
    "prepare_fine_arrays",
    "problem_from_arrays",
    "support_fine_eager",
    "support_fine_owner",
    "undirected_alive",
]

# Elements per (block, window) intermediate of the torch-ops twins.
_WINDOW_ELEMS = 1 << 22


class FineProblem(NamedTuple):
    """Static-shape int32 tensors for the fine-grained algorithm.

    Directed (upper-triangular) arrays drive the eager mode; the undirected
    mirror (u*) drives the owner mode.  ``u2d`` maps each undirected nonzero
    to its directed edge id so a single ``alive`` vector (over directed
    edges) masks both views.

    Contract: ``rowptr``/``urowptr`` are read only as row *starts*
    (``rowptr[v-1]`` begins row v; extents come from ``deg``/``udeg``), so
    layouts may leave unowned pad lanes between rows — the slot-aligned
    packing (``repro_torch.graphs.pack``, ``layout="aligned"``) relies on
    this.
    """

    rowptr: torch.Tensor  # (n+1,) int32
    colidx: torch.Tensor  # (nnzp,) int32, 0 = pad
    edge_row: torch.Tensor  # (nnzp,) int32
    deg: torch.Tensor  # (n+1,) int32
    urowptr: torch.Tensor  # (n+1,) int32
    ucolidx: torch.Tensor  # (unnzp,) int32
    u2d: torch.Tensor  # (unnzp,) int32 -> directed edge id (nnzp for pad)
    uedge_row: torch.Tensor  # (unnzp,) int32  (row id of undirected entry)
    udeg: torch.Tensor  # (n+1,) int32

    @property
    def n(self) -> int:
        return int(self.rowptr.shape[0] - 1)

    @property
    def nnz_pad(self) -> int:
        return int(self.colidx.shape[0])

    @property
    def device(self) -> torch.device:
        return self.colidx.device


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def problem_from_arrays(
    fields: dict[str, np.ndarray], device: str | torch.device | None = None
) -> FineProblem:
    """Lift host arrays (one per :class:`FineProblem` field) onto ``device``.

    The hand-over point between the host-side packers and the device: the
    tests feed the JAX package's own ``FineProblem`` arrays through here.
    Every field must hold integers that fit int32; they are stored as int32.
    """
    dev = resolve_device(device)
    out = {}
    for name in FineProblem._fields:
        a = np.asarray(fields[name])
        if a.dtype.kind not in "iu":
            raise TypeError(f"field {name!r} has dtype {a.dtype}, expected integers")
        if a.size and (a.min() < np.iinfo(np.int32).min or a.max() > np.iinfo(np.int32).max):
            raise ValueError(f"field {name!r} does not fit int32")
        out[name] = torch.from_numpy(a.astype(np.int32)).to(dev)  # a fresh, writable copy
    return FineProblem(**out)


def prepare_fine_arrays(
    g: CSRGraph,
    chunk: int = 1024,
    *,
    nnz_pad: int | None = None,
    unnz_pad: int | None = None,
) -> dict[str, np.ndarray]:
    """Host-side packing of a CSR graph into int32 :class:`FineProblem` arrays.

    ``nnz_pad``/``unnz_pad`` override the default round-up-to-chunk padding
    with explicit targets so callers (the serving compile cache) can
    canonicalize many graphs onto one static shape.
    """
    nnzp = max(_round_up(g.nnz, chunk), chunk) if nnz_pad is None else int(nnz_pad)
    if nnzp < g.nnz or nnzp % chunk:
        raise ValueError(f"nnz_pad={nnzp} must be a chunk multiple >= nnz={g.nnz}")
    d = g.device_csr(nnzp)
    u = g.undirected_csr()
    unnzp = max(_round_up(u.nnz, chunk), chunk) if unnz_pad is None else int(unnz_pad)
    if unnzp < u.nnz:
        raise ValueError(f"unnz_pad={unnzp} < undirected nnz={u.nnz}")

    # Map undirected nonzeros to directed edge ids: entry (a,b) of the
    # symmetric CSR corresponds to directed edge (min(a,b), max(a,b)).  The
    # directed nonzeros are globally sorted under the composite key
    # row * (n + 2) + col, so one vectorized searchsorted over those keys
    # resolves every undirected entry at once.
    urows = u.row_of_edge()
    lo = np.minimum(urows, u.colidx).astype(np.int64)
    hi = np.maximum(urows, u.colidx).astype(np.int64)
    stride = np.int64(g.n + 2)
    dkeys = g.row_of_edge().astype(np.int64) * stride + g.colidx
    u2d = np.searchsorted(dkeys, lo * stride + hi)
    pad_u = unnzp - u.nnz
    i32 = np.int32
    return {
        "rowptr": d.rowptr.astype(i32),
        "colidx": d.colidx.astype(i32),
        "edge_row": d.edge_row.astype(i32),
        "deg": d.deg.astype(i32),
        "urowptr": u.rowptr.astype(i32),
        "ucolidx": np.pad(u.colidx.astype(i32), (0, pad_u)),
        "u2d": np.pad(u2d.astype(i32), (0, pad_u), constant_values=nnzp),
        "uedge_row": np.pad(u.row_of_edge().astype(i32), (0, pad_u)),
        "udeg": u.degrees().astype(i32),
    }


def prepare_fine(
    g: CSRGraph,
    chunk: int = 1024,
    *,
    nnz_pad: int | None = None,
    unnz_pad: int | None = None,
    device: str | torch.device | None = None,
) -> FineProblem:
    """:func:`prepare_fine_arrays` lifted onto ``device`` (``None`` = CUDA)."""
    return problem_from_arrays(
        prepare_fine_arrays(g, chunk, nnz_pad=nnz_pad, unnz_pad=unnz_pad), device
    )


def _block(chunk: int, width: int) -> int:
    """Tasks per loop step: a multiple of ``chunk`` near the element budget."""
    return max(chunk, (_WINDOW_ELEMS // width) // chunk * chunk)


def _row_start(rowptr: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rowptr[v-1]`` for v > 0, 0 for the sentinel row 0."""
    return rowptr[(v - 1).clamp(min=0)] * (v > 0)


# ---------------------------------------------------------------------- #
# Mode "eager": faithful Algorithm 3 dataflow (index_add_ for atomics)
# ---------------------------------------------------------------------- #
def support_fine_eager(
    p: FineProblem, alive: torch.Tensor, *, window: int, chunk: int = 1024
) -> torch.Tensor:
    """Support per directed edge via the eager triple-update (Alg. 3).

    Args:
      p: problem tensors (``prepare_fine``).
      alive: (nnzp,) bool — surviving edges (pad lanes False).
      window: width ≥ max degree of the graph.
      chunk: the task granularity; must divide ``nnz_pad``.

    Returns:
      (nnzp,) int32 support (0 on dead/pad lanes).
    """
    nnzp = p.nnz_pad
    if nnzp % chunk:
        raise ValueError(f"tasks={nnzp} not a multiple of chunk={chunk}")
    w = int(window)
    dev = p.device
    large = p.n + 2
    offs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    # One extra lane absorbs the masked-off scatters (JAX's mode="drop").
    s_acc = torch.zeros(nnzp + 1, dtype=torch.int32, device=dev)
    step = _block(chunk, w)

    for start in range(0, nnzp, step):
        t = torch.arange(start, min(start + step, nnzp), dtype=torch.int32, device=dev)
        kappa = p.colidx[t]
        i = p.edge_row[t]
        valid_t = (kappa != 0) & alive[t]

        # --- row-i suffix window (queries) -------------------------------
        a_idx = t[:, None] + 1 + offs  # global colidx positions
        # Row end as start + degree (not rowptr[i]): rowptr is read only as
        # row *starts* (FineProblem contract).
        row_end = (_row_start(p.rowptr, i) + p.deg[i])[:, None]
        a_in = a_idx < row_end
        a_idx_c = a_idx.clamp(0, nnzp - 1)
        a_vals = torch.where(a_in, p.colidx[a_idx_c], 0)
        a_alive = a_in & alive[a_idx_c]
        q = torch.where(a_alive & valid_t[:, None], a_vals, 0)

        # --- row-κ window (sorted navigation values) ---------------------
        b_start = _row_start(p.rowptr, kappa)
        b_idx = b_start[:, None] + offs
        b_in = offs < p.deg[kappa][:, None]
        b_idx_c = b_idx.clamp(0, nnzp - 1)
        b_nav = torch.where(b_in, p.colidx[b_idx_c], large)
        b_alive = b_in & alive[b_idx_c]

        member, pos = sorted_window_member(q, b_nav)
        pos_c = pos.clamp(max=w - 1)
        member &= torch.gather(b_alive, 1, pos_c.long())
        ones = member.to(torch.int32)

        # u1: the task's own edge accumulates the intersection size.
        s_acc.index_add_(0, t, ones.sum(dim=1, dtype=torch.int32) * valid_t)
        # u2: matched suffix entries (edges (i, m)) — scatter to row i slots.
        u2_tgt = torch.where(member, a_idx_c, nnzp)
        s_acc.index_add_(0, u2_tgt.reshape(-1), ones.reshape(-1))
        # u3: matched row-κ entries (edges (κ, m)) — scatter to row κ slots.
        u3_tgt = torch.where(member, b_start[:, None] + pos_c, nnzp)
        s_acc.index_add_(0, u3_tgt.reshape(-1), ones.reshape(-1))
    return s_acc[:nnzp]


# ---------------------------------------------------------------------- #
# Mode "owner": collision-free symmetric reformulation (the kernel's form)
# ---------------------------------------------------------------------- #
def undirected_alive(p: FineProblem, alive: torch.Tensor) -> torch.Tensor:
    """The directed ``alive`` mask lifted to the undirected lanes (pad False)."""
    nnzp = p.nnz_pad
    alive_pad = torch.cat([alive, alive.new_zeros(1)])
    return alive_pad[p.u2d.clamp(max=nnzp)] & (p.ucolidx != 0)


def support_fine_owner(
    p: FineProblem, alive: torch.Tensor, *, window: int, chunk: int = 1024
) -> torch.Tensor:
    """Support per directed edge as |N(a) ∩ N(b)| over undirected alive rows.

    ``window`` must be ≥ max *undirected* degree.  No scatters: each output
    lane is written by exactly one task (ownership partitioning).
    """
    nnzp = p.nnz_pad
    if nnzp % chunk:
        raise ValueError(f"nnz_pad={nnzp} not a multiple of chunk={chunk}")
    w = int(window)
    dev = p.device
    unnzp = int(p.ucolidx.shape[0])
    large = p.n + 2
    offs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    ualive = undirected_alive(p, alive)

    def row_window(v: torch.Tensor):
        """(C, w) undirected window of vertex v: (nav values, alive mask)."""
        idx = _row_start(p.urowptr, v)[:, None] + offs
        n_in = offs < p.udeg[v][:, None]
        idx_c = idx.clamp(0, unnzp - 1)
        nav = torch.where(n_in, p.ucolidx[idx_c], large)
        return nav, n_in & ualive[idx_c]

    out = torch.empty(nnzp, dtype=torch.int32, device=dev)
    step = _block(chunk, w)
    for start in range(0, nnzp, step):
        t = torch.arange(start, min(start + step, nnzp), dtype=torch.int32, device=dev)
        a = p.edge_row[t]
        b = p.colidx[t]
        valid_t = (b != 0) & alive[t]

        a_nav, a_alive = row_window(a)
        b_nav, b_alive = row_window(b)
        q = torch.where(a_alive & valid_t[:, None], a_nav, 0)
        # a_nav uses `large` for invalid lanes; queries must be 0 there.
        q = torch.where(q >= large, 0, q)
        member, pos = sorted_window_member(q, b_nav)
        member &= torch.gather(b_alive, 1, pos.clamp(max=w - 1).long())
        out[start : start + t.shape[0]] = member.sum(dim=1, dtype=torch.int32) * valid_t
    return out
