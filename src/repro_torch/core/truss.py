"""K-truss driver: support → prune fixed-point loop, K_max search.

The paper-faithful single-graph object, the port's counterpart of
``repro.core.truss`` (``repro_torch.api`` is the system's front door;
``kmax``/``decompose`` here are adapters over it):

    engine = KTrussEngine(graph, granularity="fine", mode="eager", device="cpu")
    res = engine.ktruss(k=3)           # alive mask + supports + iterations
    kmax = engine.kmax()               # largest non-empty truss (via repro_torch.api)

``granularity`` selects the paper's axis of study:
  * ``"coarse"`` — Algorithm 2 (row tasks; the baseline).
  * ``"fine"``   — Algorithm 3 (nonzero tasks; the contribution).
``mode`` selects the update dataflow (``"eager"`` scatter vs ``"owner"``
collision-free), and ``backend`` selects the torch-ops twins (``"xla"``,
the reference's spelling) or the hand-written kernel (``"pallas"``: the
CUDA kernel on the card, its plain version on the CPU).  Together they
map onto a ``repro_torch.api`` registry backend for ``kmax``/``decompose``.
The engine runs on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..graphs.csr import CSRGraph
from .eager_fine import FineProblem, bucket_tasks, prepare_fine, support_fine_bucketed

__all__ = ["KTrussResult", "TrussDecomposition", "KTrussEngine", "make_support_fn"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class KTrussResult:
    k: int
    alive: np.ndarray  # (nnz,) bool over the graph's real edges
    support: np.ndarray  # (nnz,) int32 (post-prune supports)
    iterations: int
    edges_remaining: int


@dataclasses.dataclass(frozen=True)
class TrussDecomposition:
    """Full truss decomposition: the trussness of every edge.

    ``trussness[e]`` is the largest k such that edge e belongs to the
    k-truss; every edge is trivially in the 2-truss, so values are >= 2.
    """

    trussness: np.ndarray  # (nnz,) int32, >= 2
    kmax: int  # max(trussness) (0 on edgeless graphs)
    levels: int  # number of fixed-point levels peeled


def make_support_fn(
    p: FineProblem,
    *,
    granularity: str = "fine",
    mode: str = "eager",
    backend: str = "xla",
    window: int,
    chunk: int = 1024,
    row_chunk: int = 32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``alive -> support`` for one decomposition/dataflow/backend.

    The problem-bound view of ``repro_torch.exec.peel.make_problem_support``:
    one copy of the granularity/mode/backend dispatch serves both the
    engine and the exec/serving layers.
    """
    from ..exec.peel import make_problem_support  # lazy: avoids an import cycle

    fn = make_problem_support(
        granularity=granularity,
        mode=mode,
        backend=backend,
        window=window,
        chunk=chunk,
        row_chunk=row_chunk,
    )
    return functools.partial(fn, p)


class KTrussEngine:
    """K-truss solver for one graph (one packed problem reused per k)."""

    def __init__(
        self,
        g: CSRGraph,
        *,
        granularity: str = "fine",
        mode: str = "eager",
        backend: str = "xla",
        window: int | None = None,
        chunk: int = 1024,
        row_chunk: int | None = None,
        max_iters: int = 1_000,
        bucketed: bool = False,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.g = g
        self.granularity = granularity
        self.mode = mode
        self.backend = backend
        self.bucketed = bucketed
        self.problem = prepare_fine(g, chunk=chunk, device=self.device)
        max_out = g.max_degree()
        max_und = int(g.undirected_csr().max_degree())
        need = max_und if (mode == "owner" or backend == "pallas") else max_out
        self.window = int(window) if window is not None else max(8, _round_up(need, 8))
        self.chunk = chunk
        # Keep the coarse chunk's (C, W, W) working set near ~2^24 lanes.
        self.row_chunk = (
            int(row_chunk)
            if row_chunk is not None
            else max(1, min(64, (1 << 24) // max(1, self.window**2)))
        )
        self.max_iters = max_iters
        if bucketed:
            if granularity != "fine" or mode != "eager" or backend != "xla":
                raise ValueError("bucketed requires fine/eager/xla")
            buckets = [
                (wb, torch.from_numpy(ids).to(self.device))
                for wb, ids in bucket_tasks(g, chunk=min(chunk, 256))
            ]
            self._support = functools.partial(
                support_fine_bucketed, self.problem, buckets=buckets, chunk=min(chunk, 256)
            )
        else:
            self._support = make_support_fn(
                self.problem,
                granularity=granularity,
                mode=mode,
                backend=backend,
                window=self.window,
                chunk=chunk,
                row_chunk=self.row_chunk,
            )
        self._api = None

    # ------------------------------------------------------------------ #
    def support(self, alive: torch.Tensor) -> torch.Tensor:
        """One support computation (no pruning) — benchmark entry point."""
        return self._support(alive)

    def initial_alive(self) -> torch.Tensor:
        return self.problem.colidx != 0

    def _fixed_point(self, alive: torch.Tensor, k: int):
        """The reference's ``lax.while_loop`` as a Python loop: a trip runs
        while the last one changed the mask and fewer than ``max_iters``
        trips ran; one readback of ``changed`` per trip."""
        s = torch.zeros(alive.shape, dtype=torch.int32, device=alive.device)
        it, changed = 0, True
        while changed and it < self.max_iters:
            sup = self._support(alive)
            new_alive = alive & (sup >= k - 2)
            changed = bool((new_alive != alive).any())
            alive, s, it = new_alive, sup * new_alive, it + 1
        return alive, s, it

    # ------------------------------------------------------------------ #
    def _result(self, k: int, alive: torch.Tensor, s: torch.Tensor, it: int) -> KTrussResult:
        alive_np = alive.cpu().numpy()[: self.g.nnz]
        return KTrussResult(
            k=int(k),
            alive=alive_np,
            support=s.cpu().numpy()[: self.g.nnz],
            iterations=int(it),
            edges_remaining=int(alive_np.sum()),
        )

    def ktruss(self, k: int, alive0: torch.Tensor | None = None) -> KTrussResult:
        alive0 = self.initial_alive() if alive0 is None else alive0.to(self.device)
        return self._result(k, *self._fixed_point(alive0, int(k)))

    # ------------------------------------------------------------------ #
    # Device peel: kmax / decompose in ONE dispatch, lowered through
    # repro_torch.api (the one pack/cache/dispatch path)
    # ------------------------------------------------------------------ #
    def _api_session(self):
        """Lazily built 1-slot :class:`repro_torch.api.Session` on the
        engine's device, pinned to its (granularity, kernel, mode) as a
        registry backend.

        ``kmax``/``decompose`` are adapters over it.  The api path buckets
        the graph itself (power-of-two window from the undirected degree),
        so the engine's own ``window``/``bucketed`` knobs only shape its
        ``ktruss``/``support`` closures.
        """
        if self._api is None:
            from ..api import BackendKey, Session  # lazy: core stays api-free

            chunk = self.chunk
            if chunk & (chunk - 1):  # api packing wants a power of two
                chunk = 1 << (chunk.bit_length() - 1)
            self._api = Session(
                device=self.device,
                backend=BackendKey(
                    "coarse" if self.granularity == "coarse" else "fine",
                    self.backend,
                    "aligned",
                ),
                mode=self.mode,
                max_batch=1,
                chunk=max(8, chunk),
            )
        return self._api

    @property
    def peel_executor(self):
        """The peel executor behind :meth:`kmax`/:meth:`decompose`.  Its
        ``dispatches`` counter is the test hook for the one-dispatch
        contract."""
        return self._api_session().executor_for(self.g)

    def kmax(self, k_start: int = 3) -> int:
        """Largest k with a non-empty truss (0 if even the ``k_start``-truss
        is empty) — the whole peel in one dispatch.

        Per-level masks/supports live on :meth:`peel_levels`.
        """
        from ..api import TrussQuery  # lazy: core stays api-free

        return int(self._api_session().solve([TrussQuery.kmax(self.g, k_start)])[0])

    def decompose(self, k_start: int = 3) -> TrussDecomposition:
        """Full truss decomposition in one dispatch.

        An edge's trussness is the last k whose truss still contains it;
        edges never reaching the ``k_start``-truss keep trussness
        ``k_start - 1`` (= 2 by default).
        """
        from ..api import TrussQuery  # lazy: core stays api-free

        return self._api_session().solve([TrussQuery.decompose(self.g, k_start)])[0]

    # ------------------------------------------------------------------ #
    # Host-driven level peel: per-level results (one fixed point per level)
    # ------------------------------------------------------------------ #
    def _peel(self, k_start: int = 3):
        """Yield (k, result) per level, warm-starting each k from the
        (k-1)-truss; ends after the first level whose truss is empty."""
        alive = self.initial_alive()
        k = k_start
        while bool(alive.any()):
            alive, s, it = self._fixed_point(alive, k)
            yield k, self._result(k, alive, s, it)
            k += 1

    def peel_levels(self, k_start: int = 3) -> tuple[int, list[KTrussResult]]:
        """(kmax, per-level results) for callers that need every level's
        alive mask/supports; costs one fixed point per level."""
        results: list[KTrussResult] = []
        kmax = 0
        for k, res in self._peel(k_start):
            if res.edges_remaining:
                kmax = k
                results.append(res)
        return kmax, results
