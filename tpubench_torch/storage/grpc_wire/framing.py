"""gRPC message framing and status mapping (no grpcio) — a copy of
``tpubench/storage/grpc_wire/framing.py``.

Every gRPC message rides HTTP/2 DATA as a 5-byte-prefixed frame:
1 byte compressed-flag (tpubench never compresses) + 4-byte big-endian
message length + the protobuf payload. The RPC outcome travels in
HTTP/2 trailers as ``grpc-status`` / ``grpc-message``.

:class:`FrameDecoder` is an incremental parser shared by the wire
client and the fake wire server: feed it DATA payloads as they arrive,
pull complete messages out. Malformed input — a set compressed flag,
an oversized length, bytes left dangling at stream end — is always a
classified :class:`WireCodecError`, never a hang or a silent short
read.

Status mapping mirrors ``tpubench``'s gRPC library-mode tables:
transient codes retry under ``RetryingBackend``; the
HTTP-ish codes keep fault-plan assertions (404/412/416/503) uniform
across h1, h2 and gRPC transports.
"""

from __future__ import annotations

import struct
from typing import Optional, Union

from tpubench_torch.storage.base import StorageError

# gRPC status codes (the subset tpubench maps; numbering is canonical).
OK = 0
UNKNOWN = 2
INVALID_ARGUMENT = 3
DEADLINE_EXCEEDED = 4
NOT_FOUND = 5
FAILED_PRECONDITION = 9
ABORTED = 10
OUT_OF_RANGE = 11
INTERNAL = 13
UNAVAILABLE = 14

_STATUS_NAMES = {
    OK: "OK",
    UNKNOWN: "UNKNOWN",
    INVALID_ARGUMENT: "INVALID_ARGUMENT",
    DEADLINE_EXCEEDED: "DEADLINE_EXCEEDED",
    NOT_FOUND: "NOT_FOUND",
    FAILED_PRECONDITION: "FAILED_PRECONDITION",
    ABORTED: "ABORTED",
    OUT_OF_RANGE: "OUT_OF_RANGE",
    INTERNAL: "INTERNAL",
    UNAVAILABLE: "UNAVAILABLE",
}

# Same transient set as gcs_grpc._TRANSIENT_STATUS_INTS (native receive):
# the retry planes must classify identically whichever stack decoded
# the status.
TRANSIENT_STATUS = frozenset(
    {DEADLINE_EXCEEDED, ABORTED, INTERNAL, UNAVAILABLE, 8}  # 8 = RESOURCE_EXHAUSTED
)

# gRPC status → the HTTP-ish StorageError.code the rest of tpubench
# asserts on (fault plans, lifecycle preconditions, range sentinels).
STATUS_TO_HTTPISH = {
    INVALID_ARGUMENT: 400,
    NOT_FOUND: 404,
    FAILED_PRECONDITION: 412,
    OUT_OF_RANGE: 416,
    UNAVAILABLE: 503,
}
HTTPISH_TO_STATUS = {v: k for k, v in STATUS_TO_HTTPISH.items()}

# Ceiling on a single decoded message. Server chunks reads at 2 MiB
# (MAX_READ_CHUNK); metadata responses are tiny. 4x headroom guards
# against a corrupt length prefix allocating gigabytes.
MAX_MESSAGE_BYTES = 8 * 1024 * 1024


class WireCodecError(StorageError):
    """Malformed wire bytes (framing or protobuf). Never transient:
    retrying a corrupt stream replays the corruption."""

    def __init__(self, msg: str):
        super().__init__(f"grpc wire: {msg}", transient=False, code=400)


def encode_frame(msg: Union[bytes, bytearray, memoryview]) -> bytes:
    """5-byte-prefix a serialized protobuf message (uncompressed)."""
    return b"\x00" + struct.pack("!I", len(msg)) + bytes(msg)


class FrameDecoder:
    """Incremental gRPC frame parser.

    ``feed()`` DATA-frame payloads as they arrive; ``next()`` returns
    one complete message (``bytes``) or ``None`` when more input is
    needed; ``finish()`` asserts no partial frame is left dangling at
    end-of-stream.
    """

    def __init__(self, max_message: int = MAX_MESSAGE_BYTES):
        self._buf = bytearray()
        self._max = max_message

    def feed(self, data: Union[bytes, bytearray, memoryview]) -> None:
        self._buf += data

    def next(self) -> Optional[bytes]:
        buf = self._buf
        if len(buf) < 5:
            return None
        if buf[0] != 0:
            raise WireCodecError(
                f"compressed flag {buf[0]:#x} (compression unsupported)"
            )
        (ln,) = struct.unpack_from("!I", buf, 1)
        if ln > self._max:
            raise WireCodecError(
                f"message length {ln} exceeds cap {self._max}"
            )
        if len(buf) < 5 + ln:
            return None
        msg = bytes(buf[5 : 5 + ln])
        del buf[: 5 + ln]
        return msg

    def finish(self) -> None:
        if self._buf:
            raise WireCodecError(
                f"stream ended mid-frame ({len(self._buf)} bytes of "
                "partial gRPC frame)"
            )


def status_to_storage_error(
    status: int, message: str, what: str
) -> StorageError:
    """Map a non-OK grpc-status trailer to a classified StorageError."""
    name = _STATUS_NAMES.get(status, str(status))
    return StorageError(
        f"{what}: grpc status {name}: {message or '(no message)'}",
        transient=status in TRANSIENT_STATUS,
        code=STATUS_TO_HTTPISH.get(status),
    )


def storage_error_to_status(e: StorageError) -> tuple[int, str]:
    """Reverse map for the fake wire server's trailers.

    Injected connection resets (code 104) never reach here — the
    server kills the socket abruptly instead, so the client exercises
    its EOF/RST path exactly as against a real mid-stream drop.
    """
    code = getattr(e, "code", None)
    if code in HTTPISH_TO_STATUS:
        return HTTPISH_TO_STATUS[code], str(e)
    if getattr(e, "transient", False):
        return UNAVAILABLE, str(e)
    return UNKNOWN, str(e)
