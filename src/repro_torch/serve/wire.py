"""Length-prefixed JSON-over-socket wire format for the serving tier.

One frame = a 4-byte big-endian payload length followed by a UTF-8 JSON
object.  JSON keeps the protocol inspectable (``tcpdump``/test fixtures
read it directly) and dependency-free; numpy arrays ride inside it as
``{"__nd__": dtype, "shape": [...], "data": <base64>}`` envelopes, so a
query's CSR arrays round-trip bit-exactly — the fleet's bit-identical
contract starts at the wire.

The envelope layer is deliberately dumb: :func:`send_msg` /
:func:`recv_msg` move dicts, and the codec pairs (``encode_query`` /
``decode_query``, ``encode_result`` / ``decode_result``, ...) map the
``repro_torch.api`` value types onto them.  The frames are the
reference's byte for byte (``repro.serve.wire``): the same envelopes,
the same error context, the same frame bound, so either package decodes
the other's.  Errors cross the wire as
``{"error": {"type": ..., "message": ...}}`` and are re-raised typed on
the client side (:func:`raise_remote_error`) so ``except
TrussTimeoutError`` works identically against a fleet and a local
session.
"""

from __future__ import annotations

import base64
import json
import socket
import struct

import numpy as np

from .. import errors as repro_errors
from ..core.truss import KTrussResult, TrussDecomposition
from ..graphs.csr import CSRGraph

__all__ = [
    "MAX_FRAME_BYTES",
    "WireError",
    "send_msg",
    "recv_msg",
    "encode_array",
    "decode_array",
    "encode_graph",
    "decode_graph",
    "encode_query",
    "decode_query",
    "encode_result",
    "decode_result",
    "encode_error",
    "raise_remote_error",
]

# One frame must hold a packed query's CSR arrays; 256 MiB bounds a
# malicious/corrupt length prefix without constraining real graphs.
MAX_FRAME_BYTES = 256 * 1024 * 1024
_LEN = struct.Struct(">I")


class WireError(ConnectionError):
    """Framing/decoding failure on one connection (connection is dead)."""


# ---------------------------------------------------------------------- #
# Framing
# ---------------------------------------------------------------------- #
def send_msg(sock: socket.socket, obj: dict) -> None:
    """Write one frame: 4-byte big-endian length + JSON payload."""
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > MAX_FRAME_BYTES:
        raise WireError(f"frame of {len(payload)} bytes exceeds {MAX_FRAME_BYTES}")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise WireError(f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> dict | None:
    """Read one frame; ``None`` on clean EOF at a frame boundary."""
    try:
        head = sock.recv(_LEN.size)
    except (ConnectionResetError, BrokenPipeError) as e:
        raise WireError(f"connection lost: {e}") from e
    if not head:
        return None  # peer closed between frames
    if len(head) < _LEN.size:
        head += _recv_exact(sock, _LEN.size - len(head))
    (length,) = _LEN.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise WireError(f"frame length {length} exceeds {MAX_FRAME_BYTES}")
    try:
        return json.loads(_recv_exact(sock, length).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireError(f"frame is not valid JSON: {e}") from e


# ---------------------------------------------------------------------- #
# Arrays and graphs
# ---------------------------------------------------------------------- #
def encode_array(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {
        "__nd__": a.dtype.str,
        "shape": list(a.shape),
        "data": base64.b64encode(a.tobytes()).decode(),
    }


def decode_array(d: dict) -> np.ndarray:
    raw = base64.b64decode(d["data"])
    return np.frombuffer(raw, dtype=np.dtype(d["__nd__"])).reshape(d["shape"]).copy()


def encode_graph(g: CSRGraph) -> dict:
    return {
        "n": g.n,
        "rowptr": encode_array(np.asarray(g.rowptr, np.int64)),
        "colidx": encode_array(np.asarray(g.colidx, np.int32)),
        "name": g.name,
    }


def decode_graph(d: dict) -> CSRGraph:
    # Ordinary construction re-validates every CSR invariant, so a peer
    # sending a malformed graph gets a typed InvalidGraphError back
    # instead of poisoning the replica's batch.
    return CSRGraph(
        int(d["n"]),
        decode_array(d["rowptr"]),
        decode_array(d["colidx"]),
        name=str(d.get("name", "graph")),
    )


# ---------------------------------------------------------------------- #
# Queries and results
# ---------------------------------------------------------------------- #
def encode_query(query) -> dict:
    d = {
        "graph": encode_graph(query.graph),
        "workload": query.workload,
        "k": query.k,
        "deadline_s": query.deadline_s,
        "backend": str(query.backend) if query.backend is not None else None,
    }
    if query.frontier is not None:
        d["frontier"] = encode_array(_host(query.frontier, bool))
        d["frozen_truss"] = encode_array(_host(query.frozen_truss, np.int32))
    return d


def _host(a, dtype) -> np.ndarray:
    """A query's per-edge array (numpy, or a tensor on any device) as numpy."""
    return np.asarray(a.cpu() if hasattr(a, "cpu") else a, dtype)


def decode_query(d: dict):
    from ..api.query import TrussQuery  # lazy: serve must import without api

    kwargs = {}
    if "frontier" in d:
        kwargs["frontier"] = decode_array(d["frontier"])
        kwargs["frozen_truss"] = decode_array(d["frozen_truss"])
    return TrussQuery(
        graph=decode_graph(d["graph"]),
        workload=str(d["workload"]),
        k=int(d["k"]),
        deadline_s=d.get("deadline_s"),
        backend=d.get("backend"),
        **kwargs,
    )


def encode_result(result) -> dict:
    """Map a planner result onto its wire shape (tagged by ``kind``)."""
    if isinstance(result, KTrussResult):
        return {
            "kind": "ktruss",
            "k": result.k,
            "alive": encode_array(result.alive),
            "support": encode_array(result.support),
            "iterations": result.iterations,
            "edges_remaining": result.edges_remaining,
        }
    if isinstance(result, TrussDecomposition):
        return {
            "kind": "decompose",
            "trussness": encode_array(result.trussness),
            "kmax": result.kmax,
            "levels": result.levels,
        }
    if isinstance(result, (int, np.integer)):
        return {"kind": "kmax", "value": int(result)}
    if isinstance(result, np.ndarray):  # stream_update: full trussness
        return {"kind": "trussness", "trussness": encode_array(result)}
    raise TypeError(f"cannot encode result of type {type(result).__name__}")


def decode_result(d: dict):
    kind = d["kind"]
    if kind == "ktruss":
        return KTrussResult(
            k=int(d["k"]),
            alive=decode_array(d["alive"]),
            support=decode_array(d["support"]),
            iterations=int(d["iterations"]),
            edges_remaining=int(d["edges_remaining"]),
        )
    if kind == "decompose":
        return TrussDecomposition(
            trussness=decode_array(d["trussness"]),
            kmax=int(d["kmax"]),
            levels=int(d["levels"]),
        )
    if kind == "kmax":
        return int(d["value"])
    if kind == "trussness":
        return decode_array(d["trussness"])
    raise WireError(f"unknown result kind {kind!r}")


# ---------------------------------------------------------------------- #
# Errors
# ---------------------------------------------------------------------- #
# Context attributes that ride along with an error frame.  JSON scalars
# only, and every name is a keyword its owning class accepts — so e.g. a
# replica's shed crosses the wire as TrussTimeoutError(shed=True), not
# just a message that *says* shed.
_ERROR_CONTEXT = (
    "site",
    "injected",
    "slot",
    "shed",
    "queue_depth",
    "waited_s",
    "request_id",
    "oom",
    "path",
    "row",
    "kind",
    "attempts",
)

# Scalar constructor params deliberately NOT carried across the wire.
# The R6 lint (repro.analysis.rules_wire, on the reference's copy) requires every scalar-annotated
# error-class param to be whitelisted above or excluded here, with a
# reason:
#   query_id — TrussTimeoutError forwards request_id as query_id to its
#     base; carrying both would pass query_id twice (a ctor TypeError
#     that degrades the whole context to a bare message).
#   graph — a member graph's *name*; the row/kind fields already
#     attribute the failure, and names can be arbitrarily large.
_ERROR_CONTEXT_EXCLUDED = (
    "query_id",
    "graph",
)


def encode_error(e: BaseException) -> dict:
    rec: dict = {"type": type(e).__name__, "message": str(e)}
    ctx = {
        key: v
        for key in _ERROR_CONTEXT
        if isinstance(v := getattr(e, key, None), (bool, int, float, str))
    }
    if ctx:
        rec["context"] = ctx
    return {"error": rec}


def raise_remote_error(d: dict) -> None:
    """Re-raise a remote ``{"error": ...}`` record as its typed class.

    Error classes are resolved by name against :mod:`repro_torch.errors` only
    (never arbitrary import), so a hostile peer can at worst pick which
    *truss* error to raise.  Unknown names degrade to ``RuntimeError``.
    """
    rec = d["error"]
    cls = getattr(repro_errors, rec.get("type", ""), None)
    msg = f"[remote] {rec.get('message', '')}"
    if isinstance(cls, type) and issubclass(cls, BaseException):
        ctx = rec.get("context", {})
        try:
            raise cls(msg, **ctx)
        except TypeError:  # typed ctor rejects the carried kwargs
            pass
        try:
            raise cls(msg)
        except TypeError:  # typed ctor needs kwargs we don't carry
            raise RuntimeError(f"{rec.get('type')}: {msg}") from None
    raise RuntimeError(f"{rec.get('type', 'RemoteError')}: {msg}")
