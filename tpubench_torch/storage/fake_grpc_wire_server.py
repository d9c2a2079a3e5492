"""Hermetic storage-v2 gRPC server speaking raw HTTP/2 frames — no grpcio.
A copy of ``tpubench/storage/fake_grpc_wire_server.py``.

``endpoint`` is ``insecure://host:port`` (h2c) by default; ``tls=True``
serves TLS with ALPN h2 and an ephemeral self-signed certificate
(``host:port``, ``cafile`` the PEM to trust). It serves ReadObject
(content in messages of at most 2 MiB, as the real service chunks it),
GetObject, ListObjects, DeleteObject and the write plane
(StartResumableWrite, WriteObject, BidiWriteObject, QueryWriteStatus)
from the same :class:`FakeBackend` the HTTP fakes use, so one FaultPlan
and one upload-session store govern every transport in a run:

- open faults (latency, error_rate, 404/416) fire inside
  ``backend.open_read``/``stat`` and map to grpc-status trailers;
- mid-stream read faults from the backend reader map to trailers, except
  the injected connection reset (StorageError code 104), which kills the
  socket so the client exercises its EOF path;
- upload faults (503 rolls, the one-shot stall, commit-a-prefix-then-
  reset) fire inside ``backend.upload_append``: the stall shows as a
  delayed bidi ack, the reset as a dead socket mid-stream.

The frame loop routes DATA payloads into per-stream queues, so
client-streaming and bidi methods consume messages as they arrive.

A real gRPC client (grpcio) is served as well as the hand-rolled ones:
each connection keeps an HPACK dynamic table, the server advertises a
header table of 0 and the largest stream window, credits the
connection and stream windows back as DATA arrives, answers a header
block it cannot decode with error trailers and GOAWAY, sends DATA only
within the client's own connection and stream windows, and writes with
``TCP_NODELAY``. ``tpubench``'s copy serves a grpcio client only its
first call of each method, stalls its request bodies at 64 KiB,
overruns its windows and holds each small write for the peer's ACK.
"""

from __future__ import annotations

import queue
import socket
import ssl
import struct
import threading
from typing import Optional

from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_h2_server import (
    _PREFACE,
    _HpackError,
    _hp_literal,
    _hpd_int,
    _hpd_str,
)
from tpubench_torch.storage.fake_server import (
    inject_open_fault,
    make_self_signed_cert,
)
from tpubench_torch.storage.grpc_wire import proto
from tpubench_torch.storage.grpc_wire.framing import (
    OK,
    FrameDecoder,
    WireCodecError,
    encode_frame,
    storage_error_to_status,
)

_DATA, _HEADERS, _RST_STREAM, _SETTINGS, _PING, _GOAWAY = 0, 1, 3, 4, 6, 7
_WINDOW_UPDATE = 8
_UNIMPLEMENTED, _INTERNAL = 12, 13
_COMPRESSION_ERROR = 0x9

# Our first SETTINGS: HEADER_TABLE_SIZE 0 (a client's encoder stops
# indexing once it has read them) and the largest stream window. The
# connection window is raised to match by one WINDOW_UPDATE, and both
# are credited back as DATA arrives, so a client that keeps to flow
# control (grpcio) never stalls on a request body.
_WINDOW_MAX = 2**31 - 1
_SERVER_SETTINGS = struct.pack("!HIHI", 0x1, 0, 0x4, _WINDOW_MAX)
_WINDOW_REFILL = 2**30  # credit back once this much has been consumed

# Largest content per ReadObjectResponse (google.storage.v2 caps
# ChecksummedData at 2 MiB).
MAX_READ_CHUNK = 2 * 1024 * 1024

# RFC 7541 Appendix A: the static table, names and values.
_STATIC_TABLE = tuple(
    (n, v) for n, _, v in (
        e.partition("=") for e in (
            ":authority", ":method=GET", ":method=POST", ":path=/",
            ":path=/index.html", ":scheme=http", ":scheme=https",
            ":status=200", ":status=204", ":status=206", ":status=304",
            ":status=400", ":status=404", ":status=500", "accept-charset",
            "accept-encoding=gzip, deflate", "accept-language",
            "accept-ranges", "accept", "access-control-allow-origin", "age",
            "allow", "authorization", "cache-control", "content-disposition",
            "content-encoding", "content-language", "content-length",
            "content-location", "content-range", "content-type", "cookie",
            "date", "etag", "expect", "expires", "from", "host", "if-match",
            "if-modified-since", "if-none-match", "if-range",
            "if-unmodified-since", "last-modified", "link", "location",
            "max-forwards", "proxy-authenticate", "proxy-authorization",
            "range", "referer", "refresh", "retry-after", "server",
            "set-cookie", "strict-transport-security", "transfer-encoding",
            "user-agent", "vary", "via", "www-authenticate",
        )
    )
)


class _HpackDecoder:
    """A connection's HPACK decoder, dynamic table included (RFC 7541
    §2.3): grpc-core indexes request headers (``:path`` among them), so
    a later block names entries an earlier block inserted. The table
    starts at the protocol's 4,096 B; the client shrinks it to our
    advertised 0 with a size update once it has read our SETTINGS, and
    blocks sent before that still resolve here. Huffman-coded strings
    raise :class:`_HpackError` (no client of this server sends them in
    requests)."""

    def __init__(self):
        self._table: list[tuple[str, str]] = []  # newest first
        self._size = 0
        self._max = 4096

    def _entry(self, idx: int) -> tuple[str, str]:
        if 1 <= idx <= len(_STATIC_TABLE):
            return _STATIC_TABLE[idx - 1]
        j = idx - len(_STATIC_TABLE) - 1
        if 0 <= j < len(self._table):
            return self._table[j]
        raise _HpackError(f"header index {idx} not in the table")

    def _evict(self) -> None:
        while self._size > self._max and self._table:
            name, value = self._table.pop()
            self._size -= 32 + len(name) + len(value)

    def decode(self, block: bytes) -> dict[str, str]:
        out: dict[str, str] = {}
        i = 0
        while i < len(block):
            b = block[i]
            if b & 0x80:  # indexed field
                idx, i = _hpd_int(block, i, 7)
                name, value = self._entry(idx)
            elif (b & 0xE0) == 0x20:  # dynamic table size update
                self._max, i = _hpd_int(block, i, 5)
                self._evict()
                continue
            else:  # literal: with (0x40), without or never indexing
                indexed = b & 0x40
                idx, i = _hpd_int(block, i, 6 if indexed else 4)
                if idx:
                    name = self._entry(idx)[0]
                else:
                    name, i = _hpd_str(block, i)
                value, i = _hpd_str(block, i)
                if indexed:
                    self._table.insert(0, (name, value))
                    self._size += 32 + len(name) + len(value)
                    self._evict()
            out[name.lower()] = value
        return out


class _Kill(Exception):
    """Socket already aborted (injected reset); unwind silently."""


class _Stream:
    def __init__(self, stream_id: int, headers: dict):
        self.id = stream_id
        self.headers = headers
        self.q: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self.cancelled = threading.Event()
        self.consumed = 0  # DATA bytes not yet credited back


class _Rsp:
    """Per-stream response side: lazy initial HEADERS, framed DATA
    messages within the client's flow-control windows, trailers
    (trailers-only when nothing was sent yet)."""

    def __init__(self, conn: "_GrpcConn", stream_id: int):
        self._conn = conn
        self._sid = stream_id
        self._opened = False
        self.done = False

    def msg(self, m: "proto.Msg") -> None:
        conn = self._conn
        if not self._opened:
            self._opened = True
            conn.send_frame(
                _HEADERS, 0x4, self._sid,
                _hp_literal(":status", "200")
                + _hp_literal("content-type", "application/grpc"),
            )
        mv = memoryview(encode_frame(m.encode()))
        off = 0
        while off < len(mv):
            n = conn.reserve(self._sid, min(len(mv) - off, conn.client_max_frame))
            conn.send_frame(_DATA, 0, self._sid, bytes(mv[off : off + n]))
            off += n

    def trailers(self, status: int, message: str = "") -> None:
        if self.done:
            return
        self.done = True
        block = b""
        if not self._opened:
            # Trailers-only response (legal gRPC: one HEADERS frame).
            block += _hp_literal(":status", "200") + _hp_literal(
                "content-type", "application/grpc"
            )
        block += _hp_literal("grpc-status", str(status))
        if message:
            block += _hp_literal(
                "grpc-message", message.replace("\r", " ").replace("\n", " ")
            )
        self._conn.send_frame(_HEADERS, 0x4 | 0x1, self._sid, block)


class _GrpcConn:
    def __init__(self, sock: socket.socket, backend: FakeBackend):
        self.sock = sock
        self.backend = backend
        self.wlock = threading.Lock()
        self.client_max_frame = 16384
        self._streams: dict[int, _Stream] = {}
        # Send-side flow control (RFC 7540 §6.9): the client's windows for
        # our DATA, 65,535 B until its SETTINGS and WINDOW_UPDATEs say more.
        self._fc = threading.Condition()
        self._conn_send = 65535
        self._stream_init = 65535
        self._stream_send: dict[int, int] = {}
        self._closed = False

    # ---------------------------------------------------------- frame io --
    def _recv_all(self, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def send_frame(self, ftype: int, flags: int, stream: int, payload: bytes):
        hdr = struct.pack("!I", len(payload))[1:] + bytes(
            [ftype, flags]
        ) + struct.pack("!I", stream & 0x7FFFFFFF)
        with self.wlock:
            self.sock.sendall(hdr + payload)

    def abort(self) -> None:
        """Abrupt reset (the injected code-104 fault): ``SO_LINGER(1,0)``
        then close, after ``shutdown(SHUT_RD)`` wakes the frame loop's
        blocked ``recv`` (which would otherwise hold the socket open), so
        the peer sees a reset at once."""
        try:
            self.sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0),
            )
        except OSError:
            pass
        try:
            self.sock.shutdown(socket.SHUT_RD)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def reserve(self, stream: int, want: int) -> int:
        """Take up to ``want`` bytes of both windows for a DATA frame on
        ``stream``, waiting for the client's credit; raises ``OSError``
        once the stream is reset or the connection is gone."""
        with self._fc:
            while True:
                if self._closed or stream not in self._stream_send:
                    raise OSError(f"stream {stream} closed awaiting credit")
                n = min(want, self._conn_send, self._stream_send[stream])
                if n > 0:
                    self._conn_send -= n
                    self._stream_send[stream] -= n
                    return n
                self._fc.wait(1.0)

    def _credit(self, stream: int, inc: int) -> None:
        with self._fc:
            if stream == 0:
                self._conn_send += inc
            elif stream in self._stream_send:
                self._stream_send[stream] += inc
            self._fc.notify_all()

    def _initial_window(self, value: int) -> None:
        """SETTINGS_INITIAL_WINDOW_SIZE moves every open stream's window
        by the change (RFC 7540 §6.9.2)."""
        with self._fc:
            delta, self._stream_init = value - self._stream_init, value
            for sid in self._stream_send:
                self._stream_send[sid] += delta
            self._fc.notify_all()

    # ------------------------------------------------------------ serving --
    def serve(self) -> None:
        try:
            first = self._recv_all(len(_PREFACE))
            if first != _PREFACE:
                return
            self.send_frame(_SETTINGS, 0, 0, _SERVER_SETTINGS)
            self.send_frame(_WINDOW_UPDATE, 0, 0,
                            struct.pack("!I", _WINDOW_MAX - 65535))
            hpack = _HpackDecoder()
            consumed = 0  # connection DATA bytes not yet credited back
            while True:
                fh = self._recv_all(9)
                if fh is None:
                    return
                flen = (fh[0] << 16) | (fh[1] << 8) | fh[2]
                ftype, fflags = fh[3], fh[4]
                stream = struct.unpack("!I", fh[5:9])[0] & 0x7FFFFFFF
                payload = self._recv_all(flen) if flen else b""
                if payload is None:
                    return
                if ftype == _SETTINGS and not fflags & 0x1:
                    for off in range(0, len(payload) - 5, 6):
                        ident, value = struct.unpack_from("!HI", payload, off)
                        if ident == 0x5:  # SETTINGS_MAX_FRAME_SIZE
                            self.client_max_frame = value
                        elif ident == 0x4:  # SETTINGS_INITIAL_WINDOW_SIZE
                            self._initial_window(value)
                    self.send_frame(_SETTINGS, 0x1, 0, b"")
                elif ftype == _PING and not fflags & 0x1:
                    self.send_frame(_PING, 0x1, 0, payload)
                elif ftype == _WINDOW_UPDATE and len(payload) == 4:
                    self._credit(stream, struct.unpack("!I", payload)[0]
                                 & 0x7FFFFFFF)
                elif ftype == _HEADERS:
                    if not fflags & 0x4:
                        return  # CONTINUATION unsupported: drop conn
                    block = payload
                    if fflags & 0x8:  # PADDED
                        pad = block[0]
                        block = block[1 : len(block) - pad]
                    if fflags & 0x20:  # PRIORITY
                        block = block[5:]
                    try:
                        hdrs = hpack.decode(block)
                    except _HpackError as e:
                        # The table may now disagree with the client's:
                        # fail the stream with trailers, then the
                        # connection (COMPRESSION_ERROR), so the client
                        # hears of it instead of waiting.
                        _Rsp(self, stream).trailers(
                            _INTERNAL, f"undecodable header block: {e}")
                        self.send_frame(_GOAWAY, 0, 0, struct.pack(
                            "!II", stream, _COMPRESSION_ERROR))
                        return
                    st = _Stream(stream, hdrs)
                    self._streams[stream] = st
                    with self._fc:
                        self._stream_send[stream] = self._stream_init
                    if fflags & 0x1:
                        st.q.put(None)
                    threading.Thread(
                        target=self._dispatch, args=(st,),
                        name=f"grpc-wire-stream-{stream}", daemon=True,
                    ).start()
                elif ftype == _DATA:
                    consumed += flen
                    if consumed >= _WINDOW_REFILL:
                        self.send_frame(_WINDOW_UPDATE, 0, 0,
                                        struct.pack("!I", consumed))
                        consumed = 0
                    st = self._streams.get(stream)
                    if st is not None:
                        st.consumed += flen
                        if st.consumed >= _WINDOW_REFILL and not fflags & 0x1:
                            self.send_frame(_WINDOW_UPDATE, 0, stream,
                                            struct.pack("!I", st.consumed))
                            st.consumed = 0
                        if fflags & 0x8 and payload:  # PADDED
                            pad = payload[0]
                            payload = payload[1 : len(payload) - pad]
                        if payload:
                            st.q.put(payload)
                        if fflags & 0x1:
                            st.q.put(None)
                elif ftype == _RST_STREAM:
                    st = self._streams.pop(stream, None)
                    if st is not None:
                        st.cancelled.set()
                        st.q.put(None)
                    with self._fc:  # a sender awaiting credit gives up
                        self._stream_send.pop(stream, None)
                        self._fc.notify_all()
                elif ftype == _GOAWAY:
                    return
        except OSError:
            return
        finally:
            with self._fc:
                self._closed = True
                self._fc.notify_all()
            for st in list(self._streams.values()):
                st.q.put(None)  # unblock any handler still reading
            try:
                self.sock.close()
            except OSError:
                pass

    # --------------------------------------------------------- dispatch --
    def _dispatch(self, st: _Stream) -> None:
        try:
            self._handle(st)
        finally:
            # The call is over: drop its stream and send window, so a
            # long-lived connection keeps only the calls still open.
            self._streams.pop(st.id, None)
            with self._fc:
                self._stream_send.pop(st.id, None)

    def _handle(self, st: _Stream) -> None:
        method = st.headers.get(":path", "").rsplit("/", 1)[-1]
        handler = getattr(self, f"_rpc_{method}", None)
        rsp = _Rsp(self, st.id)
        try:
            if handler is None:
                rsp.trailers(_UNIMPLEMENTED, f"unknown method {method!r}")
                return
            handler(st, rsp)
        except _Kill:
            return
        except StorageError as e:
            if getattr(e, "code", None) == 104:
                self.abort()
                return
            status, msg = storage_error_to_status(e)
            try:
                rsp.trailers(status, msg)
            except OSError:
                pass
        except OSError:
            pass
        except Exception as e:  # handler bug: surface as UNKNOWN, not a hang
            try:
                rsp.trailers(2, f"{type(e).__name__}: {e}")
            except OSError:
                pass

    def _iter_msgs(self, st: _Stream):
        """The request messages of a call, as they arrive (raises
        WireCodecError on a partial frame at END_STREAM)."""
        dec = FrameDecoder()
        while True:
            m = dec.next()
            if m is not None:
                yield m
                continue
            item = st.q.get()
            if item is None:
                dec.finish()
                return
            dec.feed(item)

    def _one_msg(self, st: _Stream) -> bytes:
        """The single request message of a unary or server-streaming
        call (raises WireCodecError on any other count)."""
        msgs = list(self._iter_msgs(st))
        if len(msgs) != 1:
            raise WireCodecError(f"unary call carried {len(msgs)} messages")
        return msgs[0]

    def _gate(self) -> None:
        """Open-time fault gate for the metadata unaries (reads roll
        inside ``backend.open_read`` instead — one roll per op)."""
        if inject_open_fault(self.backend):
            raise StorageError("injected unavailability", transient=True, code=503)

    @staticmethod
    def _obj(meta) -> proto.Object:
        return proto.Object(
            name=meta.name, generation=meta.generation, size=meta.size
        )

    # --------------------------------------------------------- read plane --
    def _rpc_ReadObject(self, st: _Stream, rsp: _Rsp) -> None:
        req = proto.ReadObjectRequest.decode(self._one_msg(st))
        be = self.backend
        meta = be.stat(req.object)
        start = req.read_offset
        length = req.read_limit or max(meta.size - start, 0)
        reader = be.open_read(req.object, start=start, length=length)
        try:
            sent_meta = False
            mv = memoryview(bytearray(MAX_READ_CHUNK))
            while True:
                if st.cancelled.is_set():
                    return
                n = reader.readinto(mv)
                if n <= 0:
                    break
                content = bytes(mv[:n])
                rsp.msg(
                    proto.ReadObjectResponse(
                        checksummed_data=proto.ChecksummedData(
                            content=content, crc32c=proto.crc32c_of(content),
                        ),
                        metadata=None if sent_meta else self._obj(meta),
                    )
                )
                sent_meta = True
            if not sent_meta:
                # Empty body: metadata still rides the (only) response.
                rsp.msg(proto.ReadObjectResponse(metadata=self._obj(meta)))
            rsp.trailers(OK)
        finally:
            reader.close()

    def _rpc_GetObject(self, st: _Stream, rsp: _Rsp) -> None:
        req = proto.GetObjectRequest.decode(self._one_msg(st))
        self._gate()
        rsp.msg(self._obj(self.backend.stat(req.object)))
        rsp.trailers(OK)

    def _rpc_ListObjects(self, st: _Stream, rsp: _Rsp) -> None:
        req = proto.ListObjectsRequest.decode(self._one_msg(st))
        self._gate()
        metas = self.backend.list(req.prefix)
        start = int(req.page_token) if req.page_token else 0
        if req.page_size:
            page = metas[start : start + req.page_size]
        else:
            page = metas[start:]
        nxt = ""
        if req.page_size and start + len(page) < len(metas):
            nxt = str(start + len(page))
        rsp.msg(
            proto.ListObjectsResponse(
                objects=[self._obj(m) for m in page], next_page_token=nxt
            )
        )
        rsp.trailers(OK)


    def _rpc_DeleteObject(self, st: _Stream, rsp: _Rsp) -> None:
        req = proto.DeleteObjectRequest.decode(self._one_msg(st))
        self._gate()
        self.backend.delete(req.object)
        rsp.msg(proto.Msg())  # google.protobuf.Empty
        rsp.trailers(OK)

    # -------------------------------------------------------- write plane --
    def _rpc_StartResumableWrite(self, st: _Stream, rsp: _Rsp) -> None:
        req = proto.StartResumableWriteRequest.decode(self._one_msg(st))
        spec = req.write_object_spec
        if spec is None or spec.resource is None or not spec.resource.name:
            raise WireCodecError("StartResumableWrite without object name")
        uid = self.backend.begin_upload(
            spec.resource.name, if_generation_match=spec.if_generation_match
        )
        rsp.msg(proto.StartResumableWriteResponse(upload_id=uid))
        rsp.trailers(OK)

    def _rpc_QueryWriteStatus(self, st: _Stream, rsp: _Rsp) -> None:
        req = proto.QueryWriteStatusRequest.decode(self._one_msg(st))
        committed, final = self.backend.upload_status(req.upload_id)
        if final is not None:
            rsp.msg(
                proto.QueryWriteStatusResponse(
                    persisted_size=final.size, resource=self._obj(final)
                )
            )
        else:
            rsp.msg(proto.QueryWriteStatusResponse(persisted_size=committed))
        rsp.trailers(OK)

    def _bidi_begin(self, msg) -> str:
        if msg.upload_id:
            return msg.upload_id
        spec = msg.write_object_spec
        if spec is not None and spec.resource is not None and spec.resource.name:
            return self.backend.begin_upload(
                spec.resource.name,
                if_generation_match=spec.if_generation_match,
            )
        raise WireCodecError(
            "first write message needs upload_id or write_object_spec"
        )

    def _append(self, uid: str, msg) -> int:
        """One chunk through the shared fault point; code-104 resets
        kill the socket (the client sees a dead conn, not trailers)."""
        cd = msg.checksummed_data
        if cd is None or not cd.content:
            return self.backend.upload_committed(uid)
        try:
            return self.backend.upload_append(uid, msg.write_offset, cd.content)
        except StorageError as e:
            if getattr(e, "code", None) == 104:
                self.abort()
                raise _Kill() from e
            raise

    def _rpc_WriteObject(self, st: _Stream, rsp: _Rsp) -> None:
        uid: Optional[str] = None
        committed = 0
        for raw in self._iter_msgs(st):
            msg = proto.WriteObjectRequest.decode(raw)
            if uid is None:
                uid = self._bidi_begin(msg)
            committed = self._append(uid, msg)
            if msg.finish_write:
                cd = msg.checksummed_data
                total = msg.write_offset + (len(cd.content) if cd else 0)
                meta = self.backend.finalize_upload(uid, total=total)
                rsp.msg(
                    proto.WriteObjectResponse(
                        persisted_size=meta.size, resource=self._obj(meta)
                    )
                )
                rsp.trailers(OK)
                return
        if uid is None:
            raise WireCodecError("WriteObject stream carried no messages")
        # Half-close without finish_write: report progress; the session
        # stays open for QueryWriteStatus / a resumed stream.
        rsp.msg(proto.WriteObjectResponse(persisted_size=committed))
        rsp.trailers(OK)

    def _rpc_BidiWriteObject(self, st: _Stream, rsp: _Rsp) -> None:
        uid: Optional[str] = None
        for raw in self._iter_msgs(st):
            msg = proto.BidiWriteObjectRequest.decode(raw)
            if uid is None:
                uid = self._bidi_begin(msg)
            committed = self._append(uid, msg)
            if msg.finish_write:
                cd = msg.checksummed_data
                if cd is not None and cd.content:
                    total = msg.write_offset + len(cd.content)
                else:
                    total = msg.write_offset or None
                meta = self.backend.finalize_upload(uid, total=total)
                rsp.msg(
                    proto.BidiWriteObjectResponse(
                        persisted_size=meta.size, resource=self._obj(meta)
                    )
                )
                rsp.trailers(OK)
                return
            if msg.state_lookup:
                rsp.msg(proto.BidiWriteObjectResponse(persisted_size=committed))
        # Input ended without finish_write (client broke away to
        # re-probe): close our side cleanly, session stays resumable.
        rsp.trailers(OK)


class FakeGrpcWireServer:
    """Threaded hermetic storage-v2 gRPC server (raw frames, no grpcio);
    a context manager."""

    def __init__(self, backend: Optional[FakeBackend] = None, port: int = 0,
                 tls: bool = False):
        self.backend = backend or FakeBackend()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(64)
        self._port = self._sock.getsockname()[1]
        self._tls = tls
        self.cafile = ""
        self._ctx = None
        if tls:
            self.cafile, keyfile = make_self_signed_cert()
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.cafile, keyfile)
            ctx.set_alpn_protocols(["h2"])
            self._ctx = ctx
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        if self._tls:
            return f"127.0.0.1:{self._port}"  # no scheme = TLS (like real GCS)
        return f"insecure://127.0.0.1:{self._port}"

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # A response is several small writes (HEADERS, DATA, trailers):
            # under Nagle each waits out the client's delayed ACK, ~40 ms
            # a unary call on a connection kept open, as grpcio keeps it.
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._ctx is not None:
                try:
                    conn = self._ctx.wrap_socket(conn, server_side=True)
                except (ssl.SSLError, OSError):
                    continue
            threading.Thread(
                target=_GrpcConn(conn, self.backend).serve,
                name="grpc-wire-conn", daemon=True,
            ).start()

    def start(self) -> "FakeGrpcWireServer":
        self._thread = threading.Thread(
            target=self._accept_loop, name="grpc-wire-accept", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "FakeGrpcWireServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
