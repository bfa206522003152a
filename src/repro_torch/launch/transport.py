"""Length-prefixed frame codec for the gateway's socket transport.

The serving stack's asyncio edge (``launch/gateway.py``) multiplexes
thousands of in-process connections; ``launch/socket_gateway.py`` puts a
real wire under them.  This module is the wire's *message fabric*: every
message travels as one self-describing FRAME —

    +-------+---------+-------+-----------------+----------------+
    | magic | version | codec | payload length  | payload bytes  |
    | 2 B   | 1 B     | 1 B   | 4 B big-endian  | <= size cap    |
    +-------+---------+-------+-----------------+----------------+

— the same length-prefixed point-to-point discipline a NoC-style overlay
interconnect uses to move packets between functional units: a fixed
header any endpoint can parse without trusting the peer, then an opaque
payload.  Design rules, each enforced here rather than by convention:

* VERSIONED — the header carries ``PROTOCOL_VERSION``; a frame from a
  different protocol generation raises :class:`ProtocolVersionError`
  instead of being misparsed (the socket layer turns that into an
  explicit handshake refusal).
* SIZE-CAPPED — ``max_bytes`` bounds the payload both ways: a declared
  length past the cap raises :class:`FrameTooLargeError` *before* any
  payload is read, so a hostile or buggy peer cannot make the server
  allocate unbounded memory from four header bytes.
* REJECT, don't guess — bad magic, garbage payloads, and truncated
  streams raise typed errors (:class:`MalformedFrameError`,
  :class:`TruncatedFrameError`); the socket layer counts them as
  ``wire.rejects`` and drops the connection.
* CODEC-TAGGED — each frame names its payload codec (msgpack when the
  optional dependency is present, JSON always).  ``numpy`` arrays ride
  as raw little-endian bytes (base64 under JSON), so a float32 tensor
  round-trips BIT-EXACTLY through either codec — the loopback soak's
  oracle parity check depends on that.  (numpy has no bfloat16: this
  port delivers a bfloat16 overlay's results widened to float32, so its
  frames name ``float32`` where a peer with ``ml_dtypes`` may send
  ``bfloat16``.)

The codec is transport-agnostic: ``encode_frame``/``decode_frame`` work
on ``bytes`` (the frame bytes are the JAX package's, byte for byte), and
``read_frame``/``write_frame`` adapt them to asyncio streams.
"""

from __future__ import annotations

import asyncio
import base64
import json
import struct

import numpy as np

try:  # optional, like hypothesis: the wire falls back to JSON without it
    import msgpack
    HAVE_MSGPACK = True
except ModuleNotFoundError:  # pragma: no cover - exercised in msgpack-less CI
    msgpack = None
    HAVE_MSGPACK = False

__all__ = [
    "CODECS", "DEFAULT_MAX_FRAME_BYTES", "FrameTooLargeError",
    "HAVE_MSGPACK", "HEADER_BYTES", "MalformedFrameError",
    "PROTOCOL_VERSION", "ProtocolVersionError", "TransportError",
    "TruncatedFrameError", "decode_frame", "default_codec", "encode_frame",
    "read_frame", "write_frame",
]

#: protocol generation; bumped on any incompatible frame/message change
PROTOCOL_VERSION = 1

#: two magic bytes open every frame: cheap resync/garbage detection
MAGIC = b"\xf5\x9e"

_HEADER = struct.Struct(">2sBBI")       # magic, version, codec id, length
HEADER_BYTES = _HEADER.size

#: payload size cap (bytes) applied on both encode and decode
DEFAULT_MAX_FRAME_BYTES = 32 << 20

_CODEC_IDS = {"json": 0, "msgpack": 1}
_CODEC_NAMES = {v: k for k, v in _CODEC_IDS.items()}

#: codecs THIS endpoint can encode/decode, preference order
CODECS = ("msgpack", "json") if HAVE_MSGPACK else ("json",)


class TransportError(RuntimeError):
    """Base class for frame-codec and wire failures."""


class MalformedFrameError(TransportError):
    """Bad magic, unknown codec, or an undecodable payload."""


class TruncatedFrameError(MalformedFrameError):
    """The stream/buffer ended mid-frame."""


class FrameTooLargeError(TransportError):
    """Declared payload length exceeds the size cap (either direction)."""


class ProtocolVersionError(TransportError):
    """The peer speaks a different protocol generation."""


def default_codec() -> str:
    """The preferred codec this endpoint supports (msgpack when present)."""
    return CODECS[0]


# --------------------------------------------------------------- payload
# ndarrays are tagged and carried as raw bytes so both codecs round-trip
# them bit-exactly; everything else must be JSON-able (dict/list/str/num).
_ND_TAG = "__nd__"


def _pack(obj, binary: bool):
    if isinstance(obj, np.ndarray):
        raw = np.ascontiguousarray(obj).tobytes()
        return {_ND_TAG: [str(obj.dtype), list(obj.shape)],
                "b": raw if binary else
                base64.b64encode(raw).decode("ascii")}
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, dict):
        return {k: _pack(v, binary) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack(v, binary) for v in obj]
    return obj


def _restore(obj):
    if isinstance(obj, dict):
        tag = obj.get(_ND_TAG)
        if tag is not None:
            dtype, shape = tag
            raw = obj["b"]
            if isinstance(raw, str):
                raw = base64.b64decode(raw)
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return {k: _restore(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore(v) for v in obj]
    return obj


def _encode_payload(obj, codec: str) -> bytes:
    if codec == "json":
        return json.dumps(_pack(obj, binary=False),
                          separators=(",", ":")).encode("utf-8")
    if codec == "msgpack":
        if not HAVE_MSGPACK:
            raise MalformedFrameError(
                "msgpack codec requested but msgpack is not installed")
        return msgpack.packb(_pack(obj, binary=True), use_bin_type=True)
    raise MalformedFrameError(f"unknown codec {codec!r}")


def _decode_payload(payload: bytes, codec_id: int):
    name = _CODEC_NAMES.get(codec_id)
    if name is None:
        raise MalformedFrameError(f"unknown codec id {codec_id}")
    try:
        if name == "json":
            obj = json.loads(payload.decode("utf-8"))
        else:
            if not HAVE_MSGPACK:
                raise MalformedFrameError(
                    "peer sent a msgpack frame but msgpack is not "
                    "installed here")
            obj = msgpack.unpackb(payload, raw=False)
    except MalformedFrameError:
        raise
    except Exception as e:
        raise MalformedFrameError(f"undecodable {name} payload: {e}") from e
    return _restore(obj)


# ---------------------------------------------------------------- frames
def encode_frame(obj, codec: str | None = None,
                 max_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> bytes:
    """Serialize one message into a framed byte string."""
    codec = codec or default_codec()
    payload = _encode_payload(obj, codec)
    if len(payload) > max_bytes:
        raise FrameTooLargeError(
            f"payload is {len(payload)} bytes, cap is {max_bytes}")
    return _HEADER.pack(MAGIC, PROTOCOL_VERSION, _CODEC_IDS[codec],
                        len(payload)) + payload


def decode_frame(buf: bytes, max_bytes: int = DEFAULT_MAX_FRAME_BYTES):
    """Parse one frame from ``buf``; returns ``(message, bytes_consumed)``.

    Raises :class:`TruncatedFrameError` when ``buf`` holds less than one
    complete frame — a stream consumer should read more and retry.
    """
    if len(buf) < HEADER_BYTES:
        raise TruncatedFrameError(
            f"need {HEADER_BYTES} header bytes, have {len(buf)}")
    magic, version, codec_id, length = _HEADER.unpack_from(buf)
    if magic != MAGIC:
        raise MalformedFrameError(f"bad frame magic {magic!r}")
    if version != PROTOCOL_VERSION:
        raise ProtocolVersionError(
            f"peer frame is protocol v{version}, this end speaks "
            f"v{PROTOCOL_VERSION}")
    if length > max_bytes:
        raise FrameTooLargeError(
            f"declared payload of {length} bytes exceeds cap {max_bytes}")
    end = HEADER_BYTES + length
    if len(buf) < end:
        raise TruncatedFrameError(
            f"need {end} bytes for the declared payload, have {len(buf)}")
    return _decode_payload(bytes(buf[HEADER_BYTES:end]), codec_id), end


# --------------------------------------------------------------- streams
async def read_frame(reader: asyncio.StreamReader,
                     max_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                     on_bytes=None):
    """Read one frame from an asyncio stream.

    Returns the decoded message, or ``None`` on clean EOF (the peer
    closed between frames).  EOF *inside* a frame raises
    :class:`TruncatedFrameError`; an over-cap declared length raises
    :class:`FrameTooLargeError` before any payload byte is read.
    ``on_bytes``, when given, is called with the complete frame's size
    (header + payload) after a successful read — the socket layer's
    ``wire.bytes_in`` accounting hook.
    """
    try:
        hdr = await reader.readexactly(HEADER_BYTES)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise TruncatedFrameError(
            f"stream ended {len(e.partial)} bytes into a frame "
            f"header") from e
    magic, version, codec_id, length = _HEADER.unpack(hdr)
    if magic != MAGIC:
        raise MalformedFrameError(f"bad frame magic {magic!r}")
    if version != PROTOCOL_VERSION:
        raise ProtocolVersionError(
            f"peer frame is protocol v{version}, this end speaks "
            f"v{PROTOCOL_VERSION}")
    if length > max_bytes:
        raise FrameTooLargeError(
            f"declared payload of {length} bytes exceeds cap {max_bytes}")
    try:
        payload = await reader.readexactly(length)
    except asyncio.IncompleteReadError as e:
        raise TruncatedFrameError(
            f"stream ended {len(e.partial)}/{length} bytes into a "
            f"frame payload") from e
    if on_bytes is not None:
        on_bytes(HEADER_BYTES + length)
    return _decode_payload(payload, codec_id)


async def write_frame(writer: asyncio.StreamWriter, obj,
                      codec: str | None = None,
                      max_bytes: int = DEFAULT_MAX_FRAME_BYTES) -> int:
    """Encode + write one frame and drain; returns bytes written."""
    frame = encode_frame(obj, codec, max_bytes)
    writer.write(frame)
    await writer.drain()
    return len(frame)
