"""Per-bucket autotuning for the fused level kernel.

The fused backend (``repro_torch.kernels.peel_fused``) has two tuning
knobs — the edge-block tile it skips dead work at, and the intersection
schedule — and the best point can differ per shape bucket.  This module
is the tuned-config store for those knobs, the counterpart of
``repro.kernels.autotune``:

- :class:`FusedConfig` — one immutable candidate point.
- :func:`autotune_fused` — sweep candidates on a representative packed
  batch for one ``(bucket, slots)`` and persist the winner.
- :class:`AutotuneStore` — JSON store at ``<cache_dir>/autotune.json``
  (installed by ``repro_torch.api.cache.enable_persistent_cache``), so a
  warm process replays tuned configs instead of re-sweeping.  Its file
  format and keys are the reference's, so either package reads a store
  the other wrote.
- :func:`lookup` — what the planner calls per ``(bucket, slots)`` when it
  builds a fused executor / cache key.

The reference also records an ``xla_flags`` set per point.  Flags for
XLA mean nothing to a kernel built by ``nvcc``, so the port has no such
field; :meth:`FusedConfig.from_json` ignores the key, and a store the
reference wrote still loads.

The stock point and the sweep grid are the port's own, measured on an
H100 (``chip_smoke.py`` phases 4 and 6, recorded in ``PERF.md``): the
point with the least mean slowdown against each bucket's best point over
the ``BENCH_GRAPHS`` buckets and rmat-15 is the stock one: block 128 with
``"bsearch"`` (the reference's stock point is 128 with ``"compare"``).
The grid starts at 32.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
from typing import Iterable, Sequence

__all__ = [
    "FusedConfig",
    "AutotuneStore",
    "set_store",
    "get_store",
    "lookup",
    "candidate_configs",
    "autotune_fused",
    "DEFAULT_BLOCKS",
    "DEFAULT_SCHEDULES",
]

DEFAULT_BLOCKS = (32, 64, 128, 256)
DEFAULT_SCHEDULES = ("compare", "bsearch")


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """One fused-kernel tuning point.

    ``block`` is the most worklist items (alive lanes, or chunks of a split
    lane) a warp of the kernel claims at a time — a power of two that must
    divide the packed ``slot_nnz``; ``schedule`` picks the in-kernel
    intersection: ``"compare"`` (a warp-wide merge of the shorter row with
    the longer, 32 by 32 entries) or ``"bsearch"`` (each entry of the
    shorter row binary-searched in the longer, the probes of a warp's items
    flattened).  Both count exactly, so every point gives the same state.
    """

    block: int = 128
    schedule: str = "bsearch"

    def __post_init__(self):
        if self.block < 1 or (self.block & (self.block - 1)) != 0:
            raise ValueError(f"block must be a power of two, got {self.block}")
        if self.schedule not in DEFAULT_SCHEDULES:
            raise ValueError(
                f"schedule must be one of {DEFAULT_SCHEDULES}, got "
                f"{self.schedule!r}"
            )

    def signature(self) -> tuple:
        """Hashable identity — folded into the executor-cache variant key."""
        return (self.block, self.schedule)

    @classmethod
    def from_signature(cls, sig: Sequence) -> "FusedConfig":
        block, schedule = sig
        return cls(block=int(block), schedule=str(schedule))

    def clamp(self, slot_nnz: int) -> "FusedConfig":
        """Shrink ``block`` to divide ``slot_nnz`` (both powers of two)."""
        block = min(self.block, int(slot_nnz)) or 1
        if block == self.block:
            return self
        return dataclasses.replace(self, block=block)

    def to_json(self) -> dict:
        return {"block": self.block, "schedule": self.schedule}

    @classmethod
    def from_json(cls, d: dict) -> "FusedConfig":
        return cls(block=int(d["block"]), schedule=str(d["schedule"]))


def _key(bucket, slots: int) -> str:
    n_pad, nnz_pad, window = bucket[0], bucket[1], bucket[2]
    return f"n{int(n_pad)}-nnz{int(nnz_pad)}-w{int(window)}/s{int(slots)}"


class AutotuneStore:
    """JSON-backed winning-config store, one entry per ``(bucket, slots)``.

    Saves are atomic (tmp file + rename) so concurrent processes sharing
    a cache dir never observe a torn file; a corrupt or missing file
    degrades to an empty store rather than failing warm start.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = str(path)
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return
        configs = data.get("configs", {}) if isinstance(data, dict) else {}
        for k, v in configs.items():
            try:
                FusedConfig.from_json(v)
            except (KeyError, TypeError, ValueError):
                continue
            self._entries[k] = v

    def get(self, bucket, slots: int) -> FusedConfig | None:
        entry = self._entries.get(_key(bucket, slots))
        return FusedConfig.from_json(entry) if entry is not None else None

    def put(self, bucket, slots: int, config: FusedConfig,
            *, stats: dict | None = None) -> None:
        entry = config.to_json()
        if stats:
            entry["stats"] = dict(stats)
        with self._lock:
            self._entries[_key(bucket, slots)] = entry
            self._save()

    def _save(self) -> None:
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        payload = {"version": 1, "configs": self._entries}
        fd, tmp = tempfile.mkstemp(dir=parent, prefix=".autotune-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def __len__(self) -> int:
        return len(self._entries)


_STORE: AutotuneStore | None = None


def set_store(path_or_store: str | os.PathLike | AutotuneStore | None):
    """Install the process-wide store (path or instance; None disables)."""
    global _STORE
    if path_or_store is None or isinstance(path_or_store, AutotuneStore):
        _STORE = path_or_store
    else:
        _STORE = AutotuneStore(path_or_store)
    return _STORE


def get_store() -> AutotuneStore | None:
    return _STORE


def lookup(bucket, slots: int, default: FusedConfig | None = None) -> FusedConfig:
    """Tuned config for ``(bucket, slots)``; stock default on a miss."""
    if _STORE is not None:
        cfg = _STORE.get(bucket, slots)
        if cfg is not None:
            return cfg
    return default if default is not None else FusedConfig()


def candidate_configs(
    slot_nnz: int,
    *,
    blocks: Iterable[int] = DEFAULT_BLOCKS,
    schedules: Iterable[str] = DEFAULT_SCHEDULES,
) -> tuple[FusedConfig, ...]:
    """The default sweep grid, clamped to ``slot_nnz`` and deduplicated."""
    out: list[FusedConfig] = []
    seen: set[tuple] = set()
    for block in blocks:
        for schedule in schedules:
            cfg = FusedConfig(block=int(block), schedule=schedule).clamp(slot_nnz)
            if cfg.signature() not in seen:
                seen.add(cfg.signature())
                out.append(cfg)
    return tuple(out)


def autotune_fused(
    bucket,
    slots: int,
    *,
    graphs: Sequence | None = None,
    chunk: int = 64,
    candidates: Sequence[FusedConfig] | None = None,
    repeats: int = 2,
    store: AutotuneStore | None = None,
    seed: int = 0,
    device=None,
) -> tuple[FusedConfig, list[dict]]:
    """Sweep fused configs on one ``(bucket, slots)`` and persist the winner.

    Times a *warm* full decompose per candidate on a representative
    aligned-packed batch (``graphs``, or synthesized R-MAT members landing
    in ``bucket``) on ``device`` (``None`` = CUDA), writes the fastest
    config to ``store`` (defaulting to the process store installed by
    ``enable_persistent_cache``), and returns ``(winner, sweep_rows)``.
    Each timing ends with a device synchronise.
    """
    import time

    import numpy as np
    import torch

    from ..exec.peel import PeelExecutor
    from ..graphs.pack import pack_problems

    n_pad, nnz_pad, window = int(bucket[0]), int(bucket[1]), int(bucket[2])
    chunk = min(int(chunk), nnz_pad)
    if graphs is None:
        graphs = _synthesize(bucket, slots, chunk=chunk, seed=seed)
    packed = pack_problems(
        list(graphs),
        slot_n=n_pad,
        slot_nnz=nnz_pad,
        slots=slots,
        chunk=chunk,
        layout="aligned",
        device=device,
    )
    dev = packed.problem.device
    slot_ids = np.repeat(np.arange(slots, dtype=np.int32), nnz_pad)
    k0 = np.full(slots, 3, dtype=np.int32)
    if candidates is None:
        candidates = candidate_configs(nnz_pad)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows: list[dict] = []
    best: tuple[FusedConfig, float] | None = None
    for cfg in candidates:
        cfg = cfg.clamp(nnz_pad)
        exe = PeelExecutor(
            granularity="fine",
            mode="owner",
            backend="fused",
            window=window,
            chunk=chunk,
            fused_config=cfg,
        )
        exe.peel(packed.problem, slot_ids=slot_ids, k0=k0)  # warm: kernel build
        times = []
        for _ in range(max(1, int(repeats))):
            sync()
            t0 = time.perf_counter()
            exe.peel(packed.problem, slot_ids=slot_ids, k0=k0)
            sync()
            times.append(time.perf_counter() - t0)
        dt = min(times)
        rows.append({"config": cfg.to_json(), "best_s": dt})
        if best is None or dt < best[1]:
            best = (cfg, dt)
    if best is None:
        raise ValueError("autotune_fused needs at least one candidate")
    winner, dt = best
    target = store if store is not None else _STORE
    if target is not None:
        target.put(
            bucket, slots, winner,
            stats={"best_s": round(dt, 6), "candidates": len(rows)},
        )
    return winner, rows


def _synthesize(bucket, slots: int, *, chunk: int, seed: int = 0) -> list:
    """Best-effort representative members for ``bucket`` (R-MAT sweep)."""
    import numpy as np

    from ..api.cache import bucket_for
    from ..graphs import rmat

    n_pad = int(bucket[0])
    scale = max(2, int(np.log2(max(n_pad, 4))))
    graphs = []
    for s in range(seed, seed + 64):
        for edge_factor in (8, 6, 4, 3, 2):
            g = rmat(scale, edge_factor, seed=s)
            if tuple(bucket_for(g, chunk=chunk)) == tuple(bucket):
                graphs.append(g)
                break
        if len(graphs) >= min(int(slots), 2):
            return graphs
    if graphs:
        return graphs
    raise ValueError(f"could not synthesize members for bucket {tuple(bucket)}")
