"""Hand-rolled protobuf wire codec for the storage-v2 messages — a copy of
``tpubench/storage/grpc_wire/proto.py``: the read and the write
messages.

Proto3 wire format, the slice tpubench needs (no dependency on
``protobuf``): varints, length-delimited fields, fixed32 — declared per
message as ``FIELDS = {number: (attr, kind)}`` and driven by one
generic encoder/decoder. Field numbers are pinned to
``google/storage/v2/storage.proto`` (the same constants the native
engine's hand-rolled client uses, engine.cc — the in-repo interop
anchor), so wire-mode Python, the C++ engine and the real service all
speak one schema.

Decoding skips unknown fields by wire type (a real server may send
fields this codec doesn't model); every truncation is a classified
:class:`WireCodecError`, never a silent short read. A decode copies the
bytes of a ``bytes`` field once and nothing else: sub-messages are
decoded from views of the message.

gRPC library mode carries these messages too, as grpcio's serializer
(``Msg.encode``) and deserializers (``decode``): for the fields
declared here they are byte for byte what the generated
``google.cloud._storage_v2`` types give (``tests/test_torch_grpc_codec.py``).
Field names follow the proto (``object``, where proto-plus says
``object_``), and an absent sub-message decodes to ``None``, where
proto-plus gives an empty one.

Kinds: ``str`` / ``bytes`` / ``varint`` (proto3 implicit presence:
zero/empty values are not encoded) / ``bool`` / ``ovarint`` (explicit
presence — ``None`` = absent, 0 is encoded: ``if_generation_match=0``
means "object must not exist"; also a member of a oneof, as
``persisted_size`` in the ``write_status`` oneof) / ``fixed32``
(``None`` = absent, for crc32c) / ``("msg", cls)`` / ``("rep", cls)``.
"""

from __future__ import annotations

from typing import Optional, Union

from tpubench_torch.storage.grpc_wire.framing import WireCodecError

# Varints are unbounded on the wire; 64 bits is the proto ceiling and
# anything longer is a malformed (or hostile) stream.
_MAX_VARINT_BYTES = 10


def encode_varint(v: int) -> bytes:
    if v < 0:
        raise WireCodecError(f"varint must be non-negative, got {v}")
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data, i: int) -> tuple[int, int]:
    """(value, next_index); raises on truncation or overlong varints."""
    v = 0
    shift = 0
    n = len(data)
    for _ in range(_MAX_VARINT_BYTES):
        if i >= n:
            raise WireCodecError("truncated varint")
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7
    raise WireCodecError("varint longer than 10 bytes")


def _tag(field: int, wtype: int) -> bytes:
    return encode_varint((field << 3) | wtype)


def _enc_len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + encode_varint(len(payload)) + payload


def _skip_field(data, i: int, wtype: int) -> int:
    if wtype == 0:
        _, i = decode_varint(data, i)
        return i
    if wtype == 1:
        i += 8
    elif wtype == 2:
        ln, i = decode_varint(data, i)
        i += ln
    elif wtype == 5:
        i += 4
    else:
        raise WireCodecError(f"unsupported wire type {wtype}")
    if i > len(data):
        raise WireCodecError("field payload past end of message")
    return i


def _default(kind) -> object:
    if isinstance(kind, tuple):
        return [] if kind[0] == "rep" else None
    return {
        "str": "", "bytes": b"", "varint": 0, "bool": False,
        "ovarint": None, "fixed32": None,
    }[kind]


class Msg:
    """Base for declarative messages: ``FIELDS = {num: (attr, kind)}``."""

    FIELDS: dict[int, tuple[str, Union[str, tuple]]] = {}

    def __init__(self, **kw):
        for _num, (attr, kind) in self.FIELDS.items():
            setattr(self, attr, kw.pop(attr, _default(kind)))
        if kw:
            raise TypeError(
                f"{type(self).__name__}: unknown fields {sorted(kw)}"
            )

    def __repr__(self) -> str:  # debugging/test failure readability
        pairs = ", ".join(
            f"{attr}={getattr(self, attr)!r}"
            for _n, (attr, _k) in sorted(self.FIELDS.items())
            if getattr(self, attr) not in (None, "", b"", 0, False, [])
        )
        return f"{type(self).__name__}({pairs})"

    # ------------------------------------------------------------ encode --
    def encode(self) -> bytes:
        out = bytearray()
        for num, (attr, kind) in sorted(self.FIELDS.items()):
            v = getattr(self, attr)
            if isinstance(kind, tuple):
                tag, cls = kind
                if tag == "msg":
                    if v is not None:
                        out += _enc_len_delim(num, v.encode())
                else:  # rep
                    for item in v:
                        out += _enc_len_delim(num, item.encode())
            elif kind == "str":
                if v:
                    out += _enc_len_delim(num, v.encode("utf-8"))
            elif kind == "bytes":
                if v:
                    out += _enc_len_delim(num, bytes(v))
            elif kind == "varint":
                if v:
                    out += _tag(num, 0) + encode_varint(int(v))
            elif kind == "bool":
                if v:
                    out += _tag(num, 0) + encode_varint(1)
            elif kind == "ovarint":
                if v is not None:
                    out += _tag(num, 0) + encode_varint(int(v))
            elif kind == "fixed32":
                if v is not None:
                    out += _tag(num, 5) + int(v).to_bytes(4, "little")
            else:  # pragma: no cover - schema bug
                raise WireCodecError(f"unknown field kind {kind!r}")
        return bytes(out)

    # ------------------------------------------------------------ decode --
    @classmethod
    def decode(cls, data) -> "Msg":
        """Decode ``data`` (bytes-like). Sub-messages are decoded from
        views of it, so a ``bytes`` field is the only copy made."""
        data = memoryview(data)
        self = cls()
        i, n = 0, len(data)
        while i < n:
            key, i = decode_varint(data, i)
            num, wtype = key >> 3, key & 0x7
            spec = cls.FIELDS.get(num)
            if spec is None:
                i = _skip_field(data, i, wtype)
                continue
            attr, kind = spec
            if isinstance(kind, tuple) or kind in ("str", "bytes"):
                if wtype != 2:
                    raise WireCodecError(
                        f"{cls.__name__}.{attr}: wire type {wtype}, "
                        "expected length-delimited"
                    )
                ln, i = decode_varint(data, i)
                if i + ln > n:
                    raise WireCodecError(
                        f"{cls.__name__}.{attr}: length {ln} past end"
                    )
                payload = data[i : i + ln]
                i += ln
                if isinstance(kind, tuple):
                    tag, sub = kind
                    if tag == "msg":
                        setattr(self, attr, sub.decode(payload))
                    else:
                        getattr(self, attr).append(sub.decode(payload))
                elif kind == "str":
                    setattr(self, attr, str(payload, "utf-8"))
                else:
                    setattr(self, attr, payload.tobytes())
            elif kind in ("varint", "ovarint", "bool"):
                if wtype != 0:
                    raise WireCodecError(
                        f"{cls.__name__}.{attr}: wire type {wtype}, "
                        "expected varint"
                    )
                v, i = decode_varint(data, i)
                setattr(self, attr, bool(v) if kind == "bool" else v)
            elif kind == "fixed32":
                if wtype != 5:
                    raise WireCodecError(
                        f"{cls.__name__}.{attr}: wire type {wtype}, "
                        "expected fixed32"
                    )
                if i + 4 > n:
                    raise WireCodecError(f"{cls.__name__}.{attr}: truncated fixed32")
                setattr(self, attr, int.from_bytes(data[i : i + 4], "little"))
                i += 4
        return self


# ------------------------------------------------- storage-v2 messages ----
# Field numbers from google/storage/v2/storage.proto (subset).


class Object(Msg):
    FIELDS = {
        1: ("name", "str"),
        2: ("bucket", "str"),
        3: ("generation", "varint"),
        6: ("size", "varint"),
    }


class ChecksummedData(Msg):
    FIELDS = {
        1: ("content", "bytes"),
        2: ("crc32c", "fixed32"),
    }


class ObjectChecksums(Msg):
    FIELDS = {
        1: ("crc32c", "fixed32"),
    }


class ReadObjectRequest(Msg):
    FIELDS = {
        1: ("bucket", "str"),
        2: ("object", "str"),
        3: ("generation", "varint"),
        4: ("read_offset", "varint"),
        5: ("read_limit", "varint"),
    }


class ReadObjectResponse(Msg):
    FIELDS = {
        1: ("checksummed_data", ("msg", ChecksummedData)),
        4: ("metadata", ("msg", Object)),
    }


class GetObjectRequest(Msg):
    FIELDS = {
        1: ("bucket", "str"),
        2: ("object", "str"),
        3: ("generation", "varint"),
    }


class ListObjectsRequest(Msg):
    FIELDS = {
        1: ("parent", "str"),
        2: ("page_size", "varint"),
        3: ("page_token", "str"),
        6: ("prefix", "str"),
    }


class ListObjectsResponse(Msg):
    FIELDS = {
        1: ("objects", ("rep", Object)),
        3: ("next_page_token", "str"),
    }


class DeleteObjectRequest(Msg):
    FIELDS = {
        1: ("bucket", "str"),
        2: ("object", "str"),
    }


class WriteObjectSpec(Msg):
    # if_generation_match has EXPLICIT presence in the real proto
    # (optional int64): 0 means "must not exist" and must hit the wire.
    FIELDS = {
        1: ("resource", ("msg", Object)),
        3: ("if_generation_match", "ovarint"),
    }


class WriteObjectRequest(Msg):
    FIELDS = {
        1: ("upload_id", "str"),
        2: ("write_object_spec", ("msg", WriteObjectSpec)),
        3: ("write_offset", "varint"),
        4: ("checksummed_data", ("msg", ChecksummedData)),
        6: ("object_checksums", ("msg", ObjectChecksums)),
        7: ("finish_write", "bool"),
    }


# The write-status responses hold ``persisted_size`` and ``resource`` in
# the ``write_status`` oneof, where a member has explicit presence: a
# persisted size of 0 is encoded, and one absent decodes to ``None``.
class WriteObjectResponse(Msg):
    FIELDS = {
        1: ("persisted_size", "ovarint"),
        2: ("resource", ("msg", Object)),
    }


class StartResumableWriteRequest(Msg):
    FIELDS = {
        1: ("write_object_spec", ("msg", WriteObjectSpec)),
    }


class StartResumableWriteResponse(Msg):
    FIELDS = {
        1: ("upload_id", "str"),
    }


class QueryWriteStatusRequest(Msg):
    FIELDS = {
        1: ("upload_id", "str"),
    }


class QueryWriteStatusResponse(Msg):
    FIELDS = {
        1: ("persisted_size", "ovarint"),
        2: ("resource", ("msg", Object)),
    }


class BidiWriteObjectRequest(Msg):
    FIELDS = {
        1: ("upload_id", "str"),
        2: ("write_object_spec", ("msg", WriteObjectSpec)),
        3: ("write_offset", "varint"),
        4: ("checksummed_data", ("msg", ChecksummedData)),
        6: ("object_checksums", ("msg", ObjectChecksums)),
        7: ("state_lookup", "bool"),
        8: ("flush", "bool"),
        9: ("finish_write", "bool"),
    }


class BidiWriteObjectResponse(Msg):
    FIELDS = {
        1: ("persisted_size", "ovarint"),
        2: ("resource", ("msg", Object)),
    }


def crc32c_of(data) -> Optional[int]:
    """CRC32C when the accelerated ``google_crc32c`` library is installed,
    else ``None`` (the checksummed field stays absent — a pure-Python CRC
    in the hot loop would turn a transport benchmark into a checksum
    benchmark)."""
    try:
        import google_crc32c
    except ImportError:
        return None
    return int(google_crc32c.value(bytes(data)))
