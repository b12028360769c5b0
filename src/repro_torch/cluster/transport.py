"""Wire protocol for the cross-host cluster tier.

The cluster tier (PR 3) is wire-READY — ``ClusterFrontend.submit`` already
speaks request/response with explicit backpressure and deadline errors —
but until now every caller lived in the frontend's process. This module is
the actual wire: a deliberately small, dependency-free, length-prefixed
protocol that ``remote.PredictionServer`` serves and ``remote.RemoteReplica``
consumes — JSON frames (v2) for control traffic and legacy peers, binary
frames (v3, negotiated per connection) for the feature/prediction hot path.

v2 JSON frame format (both directions)::

    4-byte big-endian unsigned length  ||  4-byte big-endian CRC32 of the
    body  ||  UTF-8 JSON object of ``length`` bytes

v3 binary frame format (both directions, after a ``hello`` negotiated
``accept_v >= 3`` — see ``remote.py`` and docs/transport.md)::

    b"RPB3"  ||  4-byte BE meta length  ||  4-byte BE payload length
             ||  4-byte BE CRC32 of (meta || payload)
             ||  UTF-8 JSON meta object  ||  raw payload bytes

The meta object carries the same fields a v2 frame would (``v``/``id``/
``op``/``deadline_ms``/``priority``/``error``...) EXCEPT the float batch:
features travel in the payload as raw little-endian float32 (C order) and
predictions as raw little-endian float64, described by an ``"array"``
meta field ``{"shape": [...], "dtype": "<f4"|"<f8"}``. ``unpack_array``
decodes the payload with ``np.frombuffer`` — zero per-element Python work,
which is the whole point: the v2 codec spends ~150 us/row JSON-encoding
floats that the engine predicts in ~1-14 us (BENCH ``latency.remote.*``).
float64 for predictions is deliberate: float32 quantization (~1.9e-6
relative) would break the <=1e-6 remote==in-process acceptance bar.

Framing negotiation happens IN BAND over v2 JSON (the ``hello`` op), so a
v3 client against a v2-only server falls back to JSON on the same
connection and mixed fleets roll forward one host at a time — this retires
the v1/v2 "no mixed-framing rolling upgrade" limitation documented below.

The CRC makes corruption DETECTABLE: a bit flipped anywhere in the header
or body (a failing NIC, a proxy truncating mid-stream) surfaces as a
retryable ``TransportError`` instead of silently decoding to a different —
but still valid — JSON payload. The property tests
(``tests/test_transport.py``) drive arbitrary truncations and bit flips
through the codec and assert it always raises the documented taxonomy,
never crashes, never hangs.

Every frame carries ``"v"`` (protocol version) and ``"id"`` (request id,
echoed verbatim in the response so a client can detect stale replies after
a timeout). Requests add ``"op"`` plus op-specific fields; responses are
either ``{"ok": true, ...}`` or an ERROR frame::

    {"v": 1, "id": "...", "ok": false,
     "error": {"type": "FrontendRejected", "message": "...",
               "retry_after_s": 0.05}}

``error.type`` is a STABLE string (see ``encode_error``/``decode_error``):
the frontend's admission semantics — ``FrontendRejected(retry_after_s)``
backpressure and ``DeadlineExceeded`` fail-fast — cross the host boundary
as first-class errors, not as opaque 500s, so a remote scheduler's retry
loop behaves exactly like a local caller's.

Deadlines travel as ``deadline_ms``: the REMAINING budget in milliseconds,
relative, never absolute — the two hosts' clocks are unrelated. The server
re-anchors the budget against its own monotonic clock on arrival, and a
budget that is already spent fails fast with ``DeadlineExceeded`` before
touching the admission queue.

Failure taxonomy (what the client raises):

  * ``TransportError``  — retryable=True. Connection refused/reset, torn or
    truncated frame, timeout, server draining. The caller may retry — on
    this connection after a reconnect, or on another replica; a
    ``ReplicaPool`` treats it like any dispatch failure (drain + failover).
  * ``ProtocolError``   — retryable=False. Version mismatch, malformed or
    oversized frame, bad request. Retrying cannot help; fix the peer.
  * ``RemoteError``     — retryable=False. The server executed the request
    and raised something not in the mapping table; message preserved.
  * ``AuthError``       — a ``ProtocolError`` subclass (retryable=False):
    the server requires per-tenant tokens and the hello carried a missing
    or wrong one (wire type ``Unauthorized``). CRC32 detects corruption,
    not tampering — tokens are the admission-control counterpart.

A copy of ``repro.cluster.transport``: frames, protocol versions and auth
are the reference's byte for byte, so a peer of either package talks to a
server of the other.
"""
from __future__ import annotations

import itertools
import json
import socket
import struct
import uuid
import zlib

__all__ = ["MAX_FRAME_BYTES", "PROTOCOL_V3", "PROTOCOL_VERSION",
           "AuthError", "ProtocolError", "RemoteError", "TransportError",
           "decode_error", "encode_error", "pack_array", "recv_frame",
           "recv_frame_v3", "request_id", "send_frame", "send_frame_v3",
           "unpack_array"]

# v2: CRC32 added to the frame header (corruption detection) and the
# ``schedule`` op (per-kernel DVFS operating-point selection over the wire).
# NOTE the in-band "v" check only diagnoses version skew between peers that
# share this FRAME layout; a peer speaking the v1 framing (no CRC word)
# desynchronizes at the byte level and surfaces as a retryable
# TransportError (checksum mismatch / torn read), not as ProtocolMismatch.
# v3 (the binary framing) does NOT repeat that mistake: it is negotiated in
# band over v2 JSON (``hello``), so mixed fleets interoperate per
# connection and rolling upgrades work in both directions.
PROTOCOL_VERSION = 2

# v3: binary zero-copy framing, negotiated per connection at the hello.
# JSON frames keep ``"v": 2`` (same JSON layout); a meta object inside a
# binary frame carries ``"v": 3``.
PROTOCOL_V3 = 3

# A (B, F) float batch at our feature widths is a few KiB of JSON; 16 MiB is
# orders of magnitude of headroom while still rejecting a garbage length
# prefix (e.g. a peer speaking TLS or HTTP at us) before allocating.
MAX_FRAME_BYTES = 16 << 20

_LEN = struct.Struct(">I")
_CRC = struct.Struct(">I")
_SEQ = itertools.count()
_CLIENT = uuid.uuid4().hex[:8]

# v3 binary frame header: magic || meta_len || payload_len || crc32.
# The magic makes a framing desync DIAGNOSABLE: a v3 frame read by a JSON
# peer parses as an absurd length prefix (ProtocolError, no hang), and a
# JSON frame read by a v3 peer fails the magic check by the fourth byte.
V3_MAGIC = b"RPB3"
_V3_HEADER = struct.Struct(">4sIII")

#: payload dtypes the v3 codec will construct arrays from — a peer cannot
#: name an arbitrary (e.g. object) dtype into ``np.frombuffer``
_V3_DTYPES = ("<f4", "<f8")


class TransportError(ConnectionError):
    """Retryable transport failure: the request MAY not have executed.

    Raised for torn/truncated frames, resets, timeouts, and a draining
    server. ``retryable`` is True: retry on a fresh connection or route to
    another replica.
    """

    retryable = True


class ProtocolError(RuntimeError):
    """Non-retryable protocol violation (version mismatch, malformed or
    oversized frame, bad request). Retrying the same bytes cannot help."""

    retryable = False


class RemoteError(RuntimeError):
    """The server executed the request and failed with an unmapped error."""

    retryable = False


class AuthError(ProtocolError):
    """Missing/unknown tenant or wrong token at the hello (wire type
    ``Unauthorized``). Non-retryable: resending the same credentials
    cannot help; fix the client's token."""


def request_id() -> str:
    """Process-unique, monotonic request id (client tag + sequence)."""
    return f"{_CLIENT}-{next(_SEQ)}"


# ------------------------------------------------------------------- framing

def send_frame(sock: socket.socket, obj: dict) -> None:
    """Serialize ``obj`` and write one length-prefixed, CRC-tagged frame."""
    body = json.dumps(obj, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    header = _LEN.pack(len(body)) + _CRC.pack(zlib.crc32(body))
    try:
        sock.sendall(header + body)
    except (OSError, ValueError) as exc:        # ValueError: closed socket
        raise TransportError(f"send failed: {exc}") from exc


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or raise ``TransportError`` naming how far
    the torn read got — the 'server died mid-frame' diagnostic."""
    chunks, got = [], 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except (OSError, ValueError) as exc:
            raise TransportError(f"recv failed after {got}/{n} bytes "
                                 f"of {what}: {exc}") from exc
        if not chunk:
            raise TransportError(f"connection closed after {got}/{n} bytes "
                                 f"of {what}")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> dict | None:
    """Read one frame; ``None`` on clean EOF at a frame boundary.

    Torn reads (EOF or reset mid-header / mid-body) raise ``TransportError``
    — the peer died mid-frame and the stream is unrecoverable — and so does
    a CRC mismatch (the bytes were corrupted in transit; retry on a fresh
    connection). A length prefix beyond ``MAX_FRAME_BYTES`` or a body that
    is not a JSON object raises ``ProtocolError`` — the peer is not
    speaking this protocol. The length is validated BEFORE anything else is
    read, so a garbage prefix is rejected without waiting on bytes that
    will never arrive.
    """
    try:
        first = sock.recv(1)
    except (OSError, ValueError) as exc:
        raise TransportError(f"recv failed: {exc}") from exc
    if not first:
        return None                              # clean EOF between frames
    raw = first + _recv_exact(sock, _LEN.size - 1, "length prefix")
    (length,) = _LEN.unpack(raw)
    if length > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {length} exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    (crc,) = _CRC.unpack(_recv_exact(sock, _CRC.size, "frame checksum"))
    body = _recv_exact(sock, length, "frame body")
    actual = zlib.crc32(body)
    if actual != crc:
        raise TransportError(f"frame checksum mismatch: header says "
                             f"{crc:#010x}, body is {actual:#010x} — "
                             f"corrupted in transit")
    try:
        obj = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ProtocolError(f"frame body is not JSON: {exc}") from exc
    if not isinstance(obj, dict):
        raise ProtocolError(f"frame is {type(obj).__name__}, expected object")
    return obj


# ------------------------------------------------------------- v3 framing

def send_frame_v3(sock: socket.socket, meta: dict,
                  payload: bytes = b"") -> None:
    """Write one binary frame: JSON ``meta`` + raw ``payload`` bytes,
    CRC-tagged together. ``payload`` is typically ``pack_array`` output;
    control frames (ping/info/errors) ship an empty payload."""
    body = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    if len(body) + len(payload) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(body) + len(payload)} bytes "
                            f"exceeds MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    crc = zlib.crc32(payload, zlib.crc32(body))
    header = _V3_HEADER.pack(V3_MAGIC, len(body), len(payload), crc)
    try:
        # one sendall: header+meta are small, and the payload bytes object
        # is handed to the kernel without an extra copy through join()
        sock.sendall(header + body + payload)
    except (OSError, ValueError) as exc:        # ValueError: closed socket
        raise TransportError(f"send failed: {exc}") from exc


def recv_frame_v3(sock: socket.socket) -> tuple[dict, bytes] | None:
    """Read one binary frame -> ``(meta, payload)``; ``None`` on clean EOF.

    Same taxonomy as ``recv_frame``: torn reads and CRC mismatches raise
    retryable ``TransportError``; a wrong magic, oversized lengths, or a
    non-JSON-object meta raise ``ProtocolError``. Lengths are validated
    BEFORE the body is awaited, so garbage headers fail without blocking
    on bytes that will never arrive.
    """
    try:
        first = sock.recv(1)
    except (OSError, ValueError) as exc:
        raise TransportError(f"recv failed: {exc}") from exc
    if not first:
        return None                              # clean EOF between frames
    raw = first + _recv_exact(sock, _V3_HEADER.size - 1, "v3 header")
    magic, meta_len, payload_len, crc = _V3_HEADER.unpack(raw)
    if magic != V3_MAGIC:
        raise ProtocolError(f"bad v3 magic {magic!r}: peer is not speaking "
                            f"the v3 binary framing")
    if meta_len + payload_len > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame length {meta_len + payload_len} exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    body = _recv_exact(sock, meta_len, "v3 meta")
    payload = _recv_exact(sock, payload_len, "v3 payload")
    actual = zlib.crc32(payload, zlib.crc32(body))
    if actual != crc:
        raise TransportError(f"frame checksum mismatch: header says "
                             f"{crc:#010x}, body is {actual:#010x} — "
                             f"corrupted in transit")
    try:
        meta = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ProtocolError(f"frame meta is not JSON: {exc}") from exc
    if not isinstance(meta, dict):
        raise ProtocolError(f"frame meta is {type(meta).__name__}, "
                            f"expected object")
    return meta, payload


def pack_array(arr) -> tuple[dict, bytes]:
    """ndarray -> (``"array"`` meta descriptor, raw payload bytes).

    Features ship as ``<f4`` and predictions as ``<f8`` — both native
    little-endian layouts, so on the overwhelmingly common LE hosts this
    is a straight memory copy out of the array. Bit patterns (NaN, ±inf,
    subnormals) survive exactly: no decimal round-trip.
    """
    import numpy as np

    arr = np.asarray(arr)
    dtype = "<f8" if arr.dtype == np.float64 else "<f4"
    arr = np.ascontiguousarray(arr, dtype=np.dtype(dtype))
    return ({"shape": [int(s) for s in arr.shape], "dtype": dtype},
            arr.tobytes())


def unpack_array(desc, payload: bytes):
    """(descriptor, payload) -> ndarray, zero per-element work.

    Peer-controlled, so everything is validated before ``np.frombuffer``:
    dtype must be one of ``_V3_DTYPES``, the shape must be a short list of
    non-negative ints, and ``prod(shape) * itemsize`` must equal the
    payload length exactly — a descriptor/payload mismatch is a
    ``ProtocolError``, never a mis-shaped buffer view. The returned array
    is a read-only view over the received bytes (zero-copy).
    """
    import numpy as np

    if not isinstance(desc, dict):
        raise ProtocolError(f"bad array descriptor: {desc!r}")
    dtype, shape = desc.get("dtype"), desc.get("shape")
    if dtype not in _V3_DTYPES:
        raise ProtocolError(f"bad array dtype {dtype!r} "
                            f"(one of {_V3_DTYPES})")
    if (not isinstance(shape, list) or len(shape) > 4
            or not all(isinstance(s, int) and 0 <= s <= MAX_FRAME_BYTES
                       for s in shape)):
        raise ProtocolError(f"bad array shape {shape!r}")
    n = 1
    for s in shape:
        n *= s
    itemsize = np.dtype(dtype).itemsize
    if n * itemsize != len(payload):
        raise ProtocolError(f"array payload is {len(payload)} bytes, "
                            f"descriptor {shape}x{dtype} needs "
                            f"{n * itemsize}")
    return np.frombuffer(payload, dtype=np.dtype(dtype)).reshape(shape)


# ------------------------------------------------------------ error mapping

def encode_error(exc: Exception) -> dict:
    """Exception -> stable wire representation (the ``error`` field)."""
    # local imports: frontend imports nothing from here, but keeping this
    # lazy means the bare framing layer stays importable without numpy
    from .frontend import DeadlineExceeded, FrontendRejected

    if isinstance(exc, FrontendRejected):
        return {"type": "FrontendRejected", "message": str(exc),
                "retry_after_s": exc.retry_after_s}
    if isinstance(exc, DeadlineExceeded):
        return {"type": "DeadlineExceeded", "message": str(exc)}
    if isinstance(exc, AuthError):               # before its ProtocolError base
        return {"type": "Unauthorized", "message": str(exc)}
    if isinstance(exc, ProtocolError):
        return {"type": "BadRequest", "message": str(exc)}
    if isinstance(exc, TransportError):
        return {"type": "Unavailable", "message": str(exc)}
    return {"type": "Internal",
            "message": f"{type(exc).__name__}: {exc}"}


def decode_error(error: dict) -> Exception:
    """Wire representation -> the exception a LOCAL caller would have seen.

    ==================  =============================================
    wire ``type``       raised client-side
    ==================  =============================================
    FrontendRejected    ``frontend.FrontendRejected(retry_after_s)``
    DeadlineExceeded    ``frontend.DeadlineExceeded``
    ProtocolMismatch    ``ProtocolError`` (non-retryable)
    BadRequest          ``ProtocolError`` (non-retryable)
    Unauthorized        ``AuthError`` (non-retryable: fix the token)
    Unavailable         ``TransportError`` (retryable: server draining)
    Internal / other    ``RemoteError`` (message preserved)
    ==================  =============================================
    """
    from .frontend import DeadlineExceeded, FrontendRejected

    kind = error.get("type", "Internal")
    message = error.get("message", "")
    if kind == "FrontendRejected":
        exc = FrontendRejected(float(error.get("retry_after_s", 0.05)))
        if message:
            exc.args = (message,)
        return exc
    if kind == "DeadlineExceeded":
        return DeadlineExceeded(message)
    if kind == "Unauthorized":
        return AuthError(message)
    if kind in ("ProtocolMismatch", "BadRequest"):
        return ProtocolError(message)
    if kind == "Unavailable":
        return TransportError(message)
    return RemoteError(message or kind)
