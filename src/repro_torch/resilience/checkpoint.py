"""Streaming checkpoint/restore: crash-durable truss maintenance.

A :class:`~repro_torch.stream.session.StreamingTrussSession` carries state
that is expensive to rebuild — the maintained CSR, the exact trussness,
and the :class:`~repro_torch.stream.tricache.TriangleCache`'s triangle
list (the one full enumeration the cache ever does).  A crash between updates
loses all of it; this module makes the session durable:

* :func:`save_checkpoint` serializes ``(graph, trussness, tri_keys)`` to
  a single compressed ``.npz`` written **atomically** (tmp file +
  ``os.replace``), with a JSON meta record carrying a format version and
  a CRC over every array so torn/corrupt files are detected at load,
  not silently decoded;
* :func:`load_checkpoint` verifies version, checksum, CSR invariants
  (through ordinary :class:`~repro_torch.graphs.csr.CSRGraph` construction)
  and trussness length, raising :class:`~repro_torch.errors.CheckpointError`
  with the offending path on any mismatch;
* :func:`restore_session` rebuilds a ``StreamingTrussSession`` from a
  checkpoint **without re-running the initial decompose or the full
  triangle enumeration**; it continues bit-identically to one that never
  crashed.

The file format is the JAX package's (``repro.resilience.checkpoint``,
same version, arrays, meta and CRC), so a checkpoint written by either
package loads in the other (``tests/test_torch_stream.py``).

Sessions auto-checkpoint at update boundaries when constructed with
``checkpoint_dir=`` (every ``checkpoint_every`` commits, keeping the
last two files so a crash mid-write still leaves a good predecessor);
:func:`latest_checkpoint` finds the newest one after a crash.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zlib

import numpy as np

from ..errors import CheckpointError
from ..graphs.csr import CSRGraph

__all__ = [
    "CHECKPOINT_VERSION",
    "Checkpoint",
    "save_checkpoint",
    "load_checkpoint",
    "restore_session",
    "latest_checkpoint",
]

CHECKPOINT_VERSION = 1
_CKPT_PREFIX = "ckpt-"
_CKPT_SUFFIX = ".npz"


@dataclasses.dataclass(frozen=True)
class Checkpoint:
    """One verified on-disk session state (the load side's return type)."""

    graph: CSRGraph
    trussness: np.ndarray
    tri_keys: np.ndarray | None  # None = session ran cache_triangles=False
    meta: dict

    @property
    def kmax(self) -> int:
        return int(self.trussness.max(initial=0)) if self.trussness.size else 0


def _checksum(arrays: dict[str, np.ndarray]) -> int:
    """Order-stable CRC32 over every array's dtype/shape/bytes."""
    crc = 0
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        crc = zlib.crc32(f"{name}:{a.dtype.str}:{a.shape}".encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return crc


def save_checkpoint(
    path: str,
    *,
    graph: CSRGraph,
    trussness: np.ndarray,
    tri_keys: np.ndarray | None = None,
    updates_applied: int = 0,
) -> str:
    """Atomically write a session checkpoint to ``path``; returns ``path``.

    The write goes to ``path + ".tmp"`` first and is renamed into place,
    so readers (and :func:`latest_checkpoint`) never observe a torn file.
    """
    trussness = np.asarray(trussness, np.int32)
    if trussness.shape[0] != graph.nnz:
        raise CheckpointError(
            f"trussness has {trussness.shape[0]} entries, graph has "
            f"{graph.nnz} — refusing to write an inconsistent checkpoint",
            path=path,
        )
    arrays = {
        "rowptr": np.asarray(graph.rowptr, np.int64),
        "colidx": np.asarray(graph.colidx, np.int32),
        "trussness": trussness,
    }
    if tri_keys is not None:
        arrays["tri_keys"] = np.asarray(tri_keys, np.int64)
    meta = {
        "version": CHECKPOINT_VERSION,
        "n": graph.n,
        "nnz": graph.nnz,
        "name": graph.name,
        "kmax": int(trussness.max(initial=0)) if trussness.size else 0,
        "cache_triangles": tri_keys is not None,
        "updates_applied": int(updates_applied),
        "checksum": _checksum(arrays),
    }
    tmp = path + ".tmp"
    try:
        buf = io.BytesIO()
        np.savez_compressed(buf, meta=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        ), **arrays)
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise CheckpointError(f"checkpoint write failed: {e}", path=path, cause=e) from e
    return path


def load_checkpoint(path: str) -> Checkpoint:
    """Read and fully verify a checkpoint (version, CRC, CSR invariants)."""
    try:
        with np.load(path) as z:
            data = {k: z[k] for k in z.files}
    except (OSError, ValueError, zlib.error) as e:
        raise CheckpointError(f"checkpoint unreadable: {e}", path=path, cause=e) from e
    if "meta" not in data:
        raise CheckpointError("checkpoint has no meta record", path=path)
    try:
        meta = json.loads(bytes(data.pop("meta")).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CheckpointError(f"checkpoint meta is corrupt: {e}", path=path, cause=e) from e
    version = meta.get("version")
    if version != CHECKPOINT_VERSION:
        raise CheckpointError(
            f"checkpoint version {version!r} != supported {CHECKPOINT_VERSION}",
            path=path,
        )
    for key in ("rowptr", "colidx", "trussness"):
        if key not in data:
            raise CheckpointError(f"checkpoint missing array {key!r}", path=path)
    crc = _checksum(data)
    if crc != meta.get("checksum"):
        raise CheckpointError(
            f"checkpoint checksum mismatch (stored {meta.get('checksum')}, "
            f"computed {crc}) — file is corrupt or torn",
            path=path,
        )
    try:
        # Ordinary construction re-validates every CSR invariant, so a
        # checkpoint that passes CRC but carries bad data still fails
        # loudly (typed) instead of poisoning the restored session.
        graph = CSRGraph(
            int(meta["n"]),
            data["rowptr"],
            data["colidx"],
            name=str(meta.get("name", "graph")),
        )
    except ValueError as e:
        raise CheckpointError(
            f"checkpoint graph fails CSR validation: {e}", path=path, cause=e
        ) from e
    trussness = np.asarray(data["trussness"], np.int32)
    if trussness.shape[0] != graph.nnz:
        raise CheckpointError(
            f"checkpoint trussness has {trussness.shape[0]} entries, graph "
            f"has {graph.nnz}",
            path=path,
        )
    tri_keys = data.get("tri_keys")
    if tri_keys is None and meta.get("cache_triangles"):
        raise CheckpointError(
            "checkpoint meta promises a triangle cache but tri_keys is missing",
            path=path,
        )
    return Checkpoint(graph=graph, trussness=trussness, tri_keys=tri_keys, meta=meta)


def restore_session(path: str, session=None, **session_kwargs):
    """Rebuild a :class:`~repro_torch.stream.session.StreamingTrussSession`
    from ``path`` — no decompose dispatch, no full triangle re-enumeration.

    ``session`` is the owning :class:`repro_torch.api.Session` (a private
    one is created from ``session_kwargs`` if omitted, matching
    ``StreamingTrussSession.for_graph``: on CUDA unless ``device="cpu"``
    is passed).  The triangle list goes to that session's device.  The restored session resumes
    auto-checkpointing if ``checkpoint_dir=`` is passed through.
    """
    from ..api.session import Session
    from ..stream.session import StreamingTrussSession
    from ..stream.tricache import TriangleCache

    ckpt = load_checkpoint(path)
    checkpoint_kwargs = {
        k: session_kwargs.pop(k)
        for k in ("checkpoint_dir", "checkpoint_every")
        if k in session_kwargs
    }
    if session is None:
        session_kwargs.setdefault("max_batch", 1)
        session = Session(**session_kwargs)
    stream = StreamingTrussSession(
        session,
        ckpt.graph,
        trussness=ckpt.trussness,
        cache_triangles=ckpt.tri_keys is not None,
        **checkpoint_kwargs,
    )
    if ckpt.tri_keys is not None:
        stream._tri_cache = TriangleCache(
            stream.graph, tri_keys=ckpt.tri_keys, device=stream.device
        )
    # The checkpoint's updates_applied meta is the durable lifetime count:
    # it seeds both the auto-checkpoint filename sequence and the restored
    # session's updates_total, so a restore + re-checkpoint keeps strictly
    # increasing sequence numbers (latest_checkpoint stays a name sort)
    # and stream replay offsets survive the handoff.
    stream._ckpt_seq = int(ckpt.meta.get("updates_applied", 0))
    stream._updates_total = int(ckpt.meta.get("updates_applied", 0))
    return stream


def latest_checkpoint(directory: str) -> str | None:
    """Newest auto-checkpoint file in ``directory`` (None if there are none).

    Auto-checkpoints are named ``ckpt-<seq>.npz`` with a monotonically
    increasing sequence number, so "latest" is a filename sort, not an
    mtime race.
    """
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return None
    ckpts = sorted(
        n
        for n in names
        if n.startswith(_CKPT_PREFIX) and n.endswith(_CKPT_SUFFIX)
    )
    return os.path.join(directory, ckpts[-1]) if ckpts else None
