"""Length-prefixed binary wire protocol for the peer-fetch data plane.

Every message on a SOLAR runtime socket — peer fetches on the data plane,
registration/barrier traffic on the launcher's control plane — rides in one
self-verifying frame (DESIGN.md §8):

    MAGIC(4) | VERSION(1) | TYPE(1) | LEN(8, big-endian) | PAYLOAD | SHA256(32)

The trailing SHA-256 covers header *and* payload, so a flipped bit anywhere
in the frame is detected before any byte reaches a buffer mirror or a batch.
Failure taxonomy:

  * :class:`TruncatedFrame` — the connection died mid-frame (or delivered
    fewer payload bytes than the header promised).
  * :class:`ChecksumMismatch` — the frame arrived whole but its digest does
    not match: corruption on the wire or a buggy peer.
  * :class:`ProtocolError` — structurally wrong bytes: bad magic, an
    unknown protocol version, or an implausible length.

All three derive from :class:`WireError` (a ``ConnectionError``): transports
treat any ``WireError`` as "this peer cannot serve right now" and fall back
to the PFS — corrupt frames are *never* repaired into batch bytes.  A
:class:`HandshakeError` is deliberately **not** a ``WireError``: two ends
disagreeing about sample geometry is a deployment misconfiguration that
must fail loudly, not degrade quietly into permanent PFS fallback.

Fetch/row payloads are fixed little-endian numpy encodings
(:func:`pack_fetch` / :func:`pack_rows` and their unpackers); control and
handshake payloads are JSON (:func:`pack_json` / :func:`unpack_json`) — the
volume there is a handful of frames per run, so self-describing beats
compact.

Own copy of the JAX package's ``runtime/wire.py``: every frame is byte for
byte the one the JAX package writes, so a client of either package talks
to a server of the other.
"""
from __future__ import annotations

import hashlib
import json
import socket
import struct

import numpy as np

__all__ = [
    "WIRE_VERSION",
    "MSG_HELLO",
    "MSG_HELLO_OK",
    "MSG_FETCH",
    "MSG_ROWS",
    "MSG_ERROR",
    "MSG_CTRL",
    "MSG_FETCHW",
    "MSG_ATTACH",
    "MSG_ATTACH_OK",
    "MSG_READ",
    "MSG_SHED",
    "WireError",
    "TruncatedFrame",
    "ChecksumMismatch",
    "ProtocolError",
    "StaleRefusal",
    "HandshakeError",
    "send_frame",
    "recv_frame",
    "pack_json",
    "unpack_json",
    "pack_fetch",
    "unpack_fetch",
    "pack_fetchw",
    "unpack_fetchw",
    "pack_rows",
    "unpack_rows",
    "pack_read",
    "unpack_read",
    "pack_shed",
    "unpack_shed",
]

MAGIC = b"SOLw"
#: bump on any change to the frame layout or payload encodings.
WIRE_VERSION = 1

#: client -> server: geometry negotiation ``{"node", "shape", "dtype"}``.
MSG_HELLO = 1
#: server -> client: negotiation accepted (echoes the server's geometry).
MSG_HELLO_OK = 2
#: client -> server: one peer-fetch request (step guard + sample ids).
MSG_FETCH = 3
#: server -> client: ok mask + the rows it could serve.
MSG_ROWS = 4
#: server -> client: named refusal (payload = utf-8 reason); the connection
#: is closed after sending.
MSG_ERROR = 5
#: launcher control plane (register / addrbook / barrier / release / report).
MSG_CTRL = 6
#: client -> server: a *windowed* peer-fetch request carrying the epoch
#: window tag alongside the step (the window-skew guard, DESIGN.md §11).
#: A separate message type, not a payload extension of :data:`MSG_FETCH`:
#: the legacy payload is ``(step, n) + n ids`` and the windowed one is
#: ``(window, step, n) + n ids`` — length arithmetic alone cannot tell a
#: windowed fetch of ``n`` ids from a legacy fetch of ``n + 1`` ids, so the
#: type byte disambiguates and old frames keep decoding unchanged.
MSG_FETCHW = 7
#: tenant -> server: attach a data-tier tenant to this buffer server
#: (JSON ``{"tenant", "token", "shape"?, "dtype"?}``).  Unlike ``MSG_HELLO``
#: — which binds a connection to a *node* for planned trainer fetches — an
#: ATTACH binds it to a *tenant*: an unplanned consumer reading samples by
#: id, admitted per-tenant and shed under load (DESIGN.md §12).  Geometry is
#: negotiable: a client that omits shape/dtype adopts the server's from the
#: ATTACH_OK echo; one that sends them must match exactly.
MSG_ATTACH = 8
#: server -> tenant: attach accepted (echoes tenant id + server geometry).
MSG_ATTACH_OK = 9
#: tenant -> server: one by-id read (tenant tag + forward flag + sample
#: ids).  Answered with :data:`MSG_ROWS` (possibly partial), or
#: :data:`MSG_SHED` when admission refuses.  The forward flag says whether
#: the server may route misses onward (peer proxy / PFS); proxy-to-proxy
#: hops always clear it so routing can never loop.
MSG_READ = 10
#: server -> tenant: load shed (JSON ``{"retry_after_s", "reason"}``).  The
#: connection stays open — a shed is admission control doing its job, not a
#: failure: clients honor the hint and retry, and must *not* charge their
#: circuit-breaker ladder.
MSG_SHED = 11

_KNOWN_TYPES = frozenset(
    (MSG_HELLO, MSG_HELLO_OK, MSG_FETCH, MSG_ROWS, MSG_ERROR, MSG_CTRL,
     MSG_FETCHW, MSG_ATTACH, MSG_ATTACH_OK, MSG_READ, MSG_SHED)
)

_HEADER = struct.Struct("!4sBBQ")
_DIGEST_BYTES = 32
#: hard per-frame cap: a header asking for more than this is garbage, not a
#: giant fetch (2 GiB >> any buffer's worth of samples in one step).
MAX_FRAME_PAYLOAD = 1 << 31


class WireError(ConnectionError):
    """Any frame-level failure; transports fall back to the PFS on it."""


class TruncatedFrame(WireError):
    """The connection closed (or stalled out) mid-frame."""


class ChecksumMismatch(WireError):
    """A whole frame arrived but its SHA-256 does not match its bytes."""


class ProtocolError(WireError):
    """Structurally invalid bytes: bad magic, version, type, or length."""


class StaleRefusal(WireError):
    """The server refused because the fetch fell outside its live skew
    window (or it no longer speaks for the node) — *expected* under the
    epoch-window protocol, e.g. mid ownership transition.  Transports fall
    back to the PFS but must not charge the failure ladder: a stale refusal
    is a healthy guard firing, not a peer fault.
    """


class HandshakeError(RuntimeError):
    """The two ends disagree about sample geometry or node identity.

    Not a :class:`WireError` on purpose: silently falling back to the PFS
    would mask a misconfigured address book or a mixed-version deployment.
    """


def _frame_digest(header: bytes, payload: bytes) -> bytes:
    h = hashlib.sha256()
    h.update(header)
    h.update(payload)
    return h.digest()


def send_frame(
    sock: socket.socket, msg_type: int, payload: bytes, *, site: str | None = None
) -> None:
    """Write one framed message (header + payload + checksum) to ``sock``.

    ``site`` names this send for the fault-injection harness
    (:mod:`repro_torch.runtime.faults`); when a fault is armed there the frame is
    deliberately damaged — a bit flip in the payload (caught downstream as
    :class:`ChecksumMismatch`) or a partial write followed by an injected
    close (caught as :class:`TruncatedFrame`).  Unnamed sends are never
    faulted.
    """
    if len(payload) > MAX_FRAME_PAYLOAD:
        raise ProtocolError(f"frame payload too large: {len(payload)} bytes")
    header = _HEADER.pack(MAGIC, WIRE_VERSION, int(msg_type), len(payload))
    digest = _frame_digest(header, payload)
    if site is not None:
        from . import faults

        action = faults.on_send(site)
        if action == "corrupt":
            frame = bytearray(header + payload + digest)
            frame[len(frame) // 2] ^= 0x40
            sock.sendall(bytes(frame))
            return
        if action == "truncate":
            frame = header + payload + digest
            sock.sendall(frame[: max(1, len(frame) // 2)])
            raise faults.InjectedTruncation(
                f"injected truncation at site {site!r}"
            )
    sock.sendall(header + payload + digest)


def _recv_exact(sock: socket.socket, n: int, *, eof_ok: bool = False) -> bytes | None:
    """Read exactly ``n`` bytes; ``None`` on a clean EOF at a frame boundary
    (only when ``eof_ok``), :class:`TruncatedFrame` on EOF anywhere else."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        try:
            part = sock.recv(n - got)
        except socket.timeout as e:
            raise TruncatedFrame(f"timed out after {got}/{n} bytes") from e
        if not part:
            if eof_ok and got == 0:
                return None
            raise TruncatedFrame(f"connection closed after {got}/{n} bytes")
        chunks.append(part)
        got += len(part)
    return b"".join(chunks)


def recv_frame(
    sock: socket.socket, *, eof_ok: bool = False
) -> tuple[int, bytes] | None:
    """Read one frame; returns ``(msg_type, payload)``.

    With ``eof_ok`` a clean close *between* frames returns ``None`` (how a
    server loop distinguishes "client hung up" from a truncated frame).
    Verifies magic, version, length sanity, and the trailing checksum before
    returning any payload byte to the caller.
    """
    header = _recv_exact(sock, _HEADER.size, eof_ok=eof_ok)
    if header is None:
        return None
    magic, version, msg_type, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise ProtocolError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise ProtocolError(
            f"peer speaks wire version {version}, this build speaks "
            f"{WIRE_VERSION}"
        )
    if msg_type not in _KNOWN_TYPES:
        raise ProtocolError(f"unknown message type {msg_type}")
    if length > MAX_FRAME_PAYLOAD:
        raise ProtocolError(f"implausible frame length {length}")
    payload = _recv_exact(sock, length)
    digest = _recv_exact(sock, _DIGEST_BYTES)
    if digest != _frame_digest(header, payload):
        raise ChecksumMismatch("frame checksum mismatch")
    return msg_type, payload


# ---------------------------------------------------------------------------
# Payload encodings
# ---------------------------------------------------------------------------


def pack_json(obj: dict) -> bytes:
    return json.dumps(obj, sort_keys=True).encode()


def unpack_json(payload: bytes) -> dict:
    try:
        out = json.loads(payload.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed JSON payload: {e}") from e
    if not isinstance(out, dict):
        raise ProtocolError("JSON payload must be an object")
    return out


_FETCH = struct.Struct("!qq")


def pack_fetch(step: int, ids: np.ndarray) -> bytes:
    """FETCH payload: the requester's global step index + wanted sample ids.

    ``step`` is the guard: the server refuses to serve unless its own buffer
    mirror currently reflects the *start-of-step* state for exactly this
    step (DESIGN.md §8) — the multi-process form of the ordering contract in
    :mod:`repro_torch.data.peer`.
    """
    ids = np.ascontiguousarray(np.asarray(ids, dtype="<i8"))
    return _FETCH.pack(int(step), ids.size) + ids.tobytes()


def unpack_fetch(payload: bytes) -> tuple[int, np.ndarray]:
    if len(payload) < _FETCH.size:
        raise ProtocolError("short FETCH payload")
    step, n = _FETCH.unpack_from(payload)
    body = payload[_FETCH.size:]
    if n < 0 or len(body) != n * 8:
        raise ProtocolError(
            f"FETCH declares {n} ids but carries {len(body)} payload bytes"
        )
    return step, np.frombuffer(body, dtype="<i8").astype(np.int64)


_FETCHW = struct.Struct("!qqq")


def pack_fetchw(window: int, step: int, ids: np.ndarray) -> bytes:
    """FETCHW payload: epoch window tag + global step index + wanted ids.

    The windowed form of :func:`pack_fetch` (DESIGN.md §11): the server's
    window-skew guard serves any step inside its live window from the
    matching snapshot (bounded eviction history) and refuses anything
    beyond it as stale.  Rides its own message type (:data:`MSG_FETCHW`) so
    legacy ``MSG_FETCH`` frames stay unambiguous and fully supported.
    """
    ids = np.ascontiguousarray(np.asarray(ids, dtype="<i8"))
    return _FETCHW.pack(int(window), int(step), ids.size) + ids.tobytes()


def unpack_fetchw(payload: bytes) -> tuple[int, int, np.ndarray]:
    if len(payload) < _FETCHW.size:
        raise ProtocolError("short FETCHW payload")
    window, step, n = _FETCHW.unpack_from(payload)
    body = payload[_FETCHW.size:]
    if n < 0 or len(body) != n * 8:
        raise ProtocolError(
            f"FETCHW declares {n} ids but carries {len(body)} payload bytes"
        )
    return window, step, np.frombuffer(body, dtype="<i8").astype(np.int64)


_READ = struct.Struct("!qBq")
#: retry-after ceiling carried in a SHED frame: JSON cannot carry infinity
#: and no client should ever sleep longer than this on one hint anyway.
MAX_RETRY_AFTER_S = 3600.0


def pack_read(tenant: int, ids: np.ndarray, *, forward: bool = True) -> bytes:
    """READ payload: tenant tag + forward flag + wanted sample ids.

    Carries no step or window: tenant reads are unplanned, and sample rows
    are immutable by id, so *any* currently-resident copy is the correct
    bytes — the guards that protect trainer snapshot reproducibility do not
    apply (DESIGN.md §12).  ``forward=False`` marks a proxy hop: the serving
    side answers from its local mirrors only, so misses can never bounce
    between servers.
    """
    ids = np.ascontiguousarray(np.asarray(ids, dtype="<i8"))
    return _READ.pack(int(tenant), 1 if forward else 0, ids.size) + ids.tobytes()


def unpack_read(payload: bytes) -> tuple[int, bool, np.ndarray]:
    if len(payload) < _READ.size:
        raise ProtocolError("short READ payload")
    tenant, forward, n = _READ.unpack_from(payload)
    if forward not in (0, 1):
        raise ProtocolError(f"READ forward flag must be 0/1, got {forward}")
    body = payload[_READ.size:]
    if n < 0 or len(body) != n * 8:
        raise ProtocolError(
            f"READ declares {n} ids but carries {len(body)} payload bytes"
        )
    return tenant, bool(forward), np.frombuffer(body, dtype="<i8").astype(np.int64)


def pack_shed(retry_after_s: float, reason: str) -> bytes:
    """SHED payload: how long the tenant should back off, and why."""
    retry = float(retry_after_s)
    if not retry >= 0.0:  # also rejects NaN
        raise ValueError(f"retry_after_s must be >= 0, got {retry_after_s!r}")
    return pack_json({
        "retry_after_s": min(retry, MAX_RETRY_AFTER_S),
        "reason": str(reason),
    })


def unpack_shed(payload: bytes) -> tuple[float, str]:
    msg = unpack_json(payload)
    try:
        retry = float(msg["retry_after_s"])
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed SHED payload: {e}") from e
    if not 0.0 <= retry <= MAX_RETRY_AFTER_S:
        raise ProtocolError(f"SHED retry_after_s {retry!r} out of range")
    return retry, str(msg.get("reason", ""))


def pack_rows(ok: np.ndarray, rows: np.ndarray) -> bytes:
    """ROWS payload: bool mask over the requested ids + served row bytes.

    ``rows`` holds one row per True mask entry, in request order — exactly
    the :class:`~repro_torch.data.peer.PeerTransport` return contract.
    """
    ok = np.ascontiguousarray(np.asarray(ok, bool))
    rows = np.ascontiguousarray(rows)
    assert rows.shape[0] == int(ok.sum()), (rows.shape, int(ok.sum()))
    return ok.tobytes() + rows.tobytes()


def unpack_rows(
    payload: bytes, num_ids: int, sample_shape: tuple[int, ...], dtype
) -> tuple[np.ndarray, np.ndarray]:
    """Decode a ROWS payload against the *negotiated* geometry.

    The expected byte count is fully determined by ``num_ids`` and the
    handshake geometry; any disagreement is a :class:`ProtocolError`, never
    a partially-decoded batch.
    """
    dtype = np.dtype(dtype)
    if len(payload) < num_ids:
        raise ProtocolError("short ROWS payload: mask missing")
    ok = np.frombuffer(payload[:num_ids], dtype=bool)
    row_bytes = int(
        dtype.itemsize * int(np.prod(sample_shape, dtype=np.int64))
    )
    body = payload[num_ids:]
    n_ok = int(ok.sum())
    if len(body) != n_ok * row_bytes:
        raise ProtocolError(
            f"ROWS declares {n_ok} rows but carries {len(body)} bytes"
        )
    rows = np.frombuffer(body, dtype=dtype).reshape(
        (n_ok,) + tuple(sample_shape)
    )
    return ok.copy(), rows.copy()
