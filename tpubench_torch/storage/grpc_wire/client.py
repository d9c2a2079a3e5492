"""gRPC-over-HTTP/2 client connection — no grpcio, no h2 package. A copy
of ``tpubench/storage/grpc_wire/client.py`` (unary, server-streaming and
bidi calls).

Speaks exactly the frame subset the RPC shapes need: client preface +
SETTINGS, HEADERS with literal-never-indexed HPACK (the same encoding
the native engine's client emits), DATA carrying 5-byte-prefixed gRPC
messages, trailers HEADERS carrying ``grpc-status``. One RPC at a time
per connection — :class:`GrpcWireChannel` keeps a small free-list and
dials extra sockets under concurrency, which is also how the reference
Go client's ``WithGRPCConnectionPool`` behaves (N independent
subchannels, calls round-robined across them).

Failure classification matches ``tpubench``'s gRPC library-mode
tables: socket EOF / RST_STREAM / GOAWAY mid-RPC are transient
(UNAVAILABLE-shaped), a blown per-read deadline is transient
(DEADLINE_EXCEEDED-shaped), and a missing ``grpc-status`` after
END_STREAM is a transient protocol error — the retry planes above
never see a raw ``OSError``.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
import time
from typing import Optional

from tpubench_torch.obs.flight import annotate
from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake_h2_server import (
    _PREFACE,
    _HpackError,
    _hp_literal,
    decode_request_headers,
)
from tpubench_torch.storage.grpc_wire.framing import (
    OK,
    FrameDecoder,
    WireCodecError,
    encode_frame,
    status_to_storage_error,
)

# Frame types (RFC 9113 §6).
_DATA = 0x0
_HEADERS = 0x1
_RST_STREAM = 0x3
_SETTINGS = 0x4
_PING = 0x6
_GOAWAY = 0x7
_WINDOW_UPDATE = 0x8

_FLAG_END_STREAM = 0x1
_FLAG_ACK = 0x1
_FLAG_END_HEADERS = 0x4
_FLAG_PADDED = 0x8
_FLAG_PRIORITY = 0x20

# SETTINGS we advertise: effectively-unbounded stream window plus the
# legal max frame size, so servers that DO enforce flow control (a real
# grpcio server, unlike the fakes) never stall a 16 MiB payload read.
_SETTINGS_MAX_FRAME_SIZE = 0x5
_SETTINGS_INITIAL_WINDOW = 0x4
_CLIENT_SETTINGS = struct.pack(
    "!HIHI",
    _SETTINGS_INITIAL_WINDOW, 2**31 - 1,
    _SETTINGS_MAX_FRAME_SIZE, 2**24 - 1,
)
_CONN_WINDOW_TOPUP = struct.pack("!I", 2**30)

_DEFAULT_MAX_FRAME = 16384


def _transient(msg: str) -> StorageError:
    return StorageError(msg, transient=True)


class _WireConn:
    """One HTTP/2 connection carrying one RPC at a time."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        tls: bool,
        cafile: Optional[str],
        insecure_skip_verify: bool,
        authority: str,
        connect_timeout_s: float,
    ):
        self.authority = authority
        self.scheme = "https" if tls else "http"
        self.broken = False
        self._next_stream = 1
        # Max DATA payload the SERVER allows us to send (its SETTINGS).
        self._peer_max_frame = _DEFAULT_MAX_FRAME
        self._wlock = threading.Lock()
        sock = socket.create_connection((host, port), timeout=connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if tls:
            ctx = ssl.create_default_context(cafile=cafile or None)
            ctx.set_alpn_protocols(["h2"])
            if insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            sock = ctx.wrap_socket(sock, server_hostname=host)
        self.sock = sock
        with self._wlock:
            self.sock.sendall(_PREFACE)
        self.send_frame(_SETTINGS, 0, 0, _CLIENT_SETTINGS)
        self.send_frame(_WINDOW_UPDATE, 0, 0, _CONN_WINDOW_TOPUP)

    # ---------------------------------------------------------- frame io --
    def send_frame(self, ftype: int, flags: int, stream: int, payload: bytes):
        hdr = struct.pack("!I", len(payload))[1:] + bytes(
            [ftype, flags]
        ) + struct.pack("!I", stream & 0x7FFFFFFF)
        with self._wlock:
            self.sock.sendall(hdr + payload)

    def recv_frame(
        self, deadline_ns: int
    ) -> Optional[tuple[int, int, int, bytes]]:
        """(type, flags, stream, payload) or None at clean EOF."""
        hdr = self._recv_all(9, deadline_ns)
        if hdr is None:
            return None
        flen = (hdr[0] << 16) | (hdr[1] << 8) | hdr[2]
        ftype, fflags = hdr[3], hdr[4]
        stream = struct.unpack("!I", hdr[5:9])[0] & 0x7FFFFFFF
        payload = b""
        if flen:
            payload = self._recv_all(flen, deadline_ns)
            if payload is None:
                return None
        return ftype, fflags, stream, payload

    def _recv_all(self, n: int, deadline_ns: int) -> Optional[bytearray]:
        # recv_into one preallocated buffer: a 2 MiB message arrives in
        # many socket reads, and growing a bytes object per read would
        # copy it over and over.
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            remaining = (deadline_ns - time.perf_counter_ns()) / 1e9
            if remaining <= 0:
                raise socket.timeout("grpc wire deadline")
            self.sock.settimeout(min(remaining, 60.0))
            k = self.sock.recv_into(view[got:])
            if not k:
                # EOF — mid-frame or between frames, the RPC is dead
                # either way; callers classify as transient.
                return None
            got += k
        return buf

    def note_peer_settings(self, payload: bytes) -> None:
        for off in range(0, len(payload) - 5, 6):
            ident, value = struct.unpack_from("!HI", payload, off)
            if ident == _SETTINGS_MAX_FRAME_SIZE:
                self._peer_max_frame = value

    def next_stream_id(self) -> int:
        sid = self._next_stream
        self._next_stream += 2
        return sid

    def close(self) -> None:
        self.broken = True
        try:
            self.sock.close()
        except OSError:
            pass


class WireCall:
    """One in-flight RPC on a leased connection.

    Send side: :meth:`send_message` (``end=True`` half-closes). Receive
    side: :meth:`recv_message` returns the next response message, or
    ``None`` once OK trailers arrived; non-OK trailers raise the
    classified StorageError. :meth:`close` returns the connection to
    the channel (reusable only after a clean end)."""

    def __init__(self, channel: "GrpcWireChannel", conn: _WireConn, method: str):
        self._channel = channel
        self._conn = conn
        self.method = method
        self.stream_id = conn.next_stream_id()
        self._decoder = FrameDecoder()
        self._deadline_ns = time.perf_counter_ns() + int(
            channel.timeout_s * 1e9
        )
        self._trailers_status: Optional[int] = None
        self._trailers_message = ""
        self._remote_closed = False
        self._finished = False
        block = b"".join(
            _hp_literal(k, v)
            for k, v in (
                (":method", "POST"),
                (":scheme", conn.scheme),
                (":path", method),
                (":authority", conn.authority),
                ("te", "trailers"),
                ("content-type", "application/grpc"),
            )
        )
        conn.send_frame(
            _HEADERS, _FLAG_END_HEADERS, self.stream_id, block
        )
        annotate("grpc_frame", dir="open", method=method)

    # -------------------------------------------------------------- send --
    def send_message(self, msg: bytes, end: bool = False) -> None:
        """Frame + send one gRPC message, chunked to the server's
        advertised max frame size; ``end=True`` half-closes our side."""
        framed = encode_frame(msg)
        try:
            mv = memoryview(framed)
            step = self._conn._peer_max_frame
            for off in range(0, len(mv), step):
                chunk = mv[off : off + step]
                last = off + step >= len(mv)
                self._conn.send_frame(
                    _DATA,
                    _FLAG_END_STREAM if (end and last) else 0,
                    self.stream_id,
                    bytes(chunk),
                )
        except OSError as e:
            self._conn.broken = True
            raise _transient(f"{self.method}: send failed: {e}") from e
        annotate("grpc_frame", dir="send", bytes=len(msg))

    def half_close(self) -> None:
        """END_STREAM with an empty DATA frame (no trailing message)."""
        try:
            self._conn.send_frame(
                _DATA, _FLAG_END_STREAM, self.stream_id, b""
            )
        except OSError as e:
            self._conn.broken = True
            raise _transient(f"{self.method}: half-close failed: {e}") from e

    # -------------------------------------------------------------- recv --
    def recv_message(self) -> Optional[bytes]:
        while True:
            msg = self._decoder.next()
            if msg is not None:
                annotate("grpc_frame", dir="recv", bytes=len(msg))
                return msg
            if self._trailers_status is not None:
                if self._trailers_status != OK:
                    raise status_to_storage_error(
                        self._trailers_status,
                        self._trailers_message,
                        self.method,
                    )
                self._decoder.finish()
                return None
            if self._remote_closed:
                # END_STREAM without grpc-status trailers: the server
                # (or a middlebox) dropped the stream shape.
                self._conn.broken = True
                raise _transient(
                    f"{self.method}: stream ended without grpc-status"
                )
            self._pump()

    def _pump(self) -> None:
        conn = self._conn
        try:
            frame = conn.recv_frame(self._deadline_ns)
        except socket.timeout as e:
            conn.broken = True
            raise StorageError(
                f"{self.method}: grpc wire deadline exceeded "
                f"({self._channel.timeout_s}s)",
                transient=True,
            ) from e
        except OSError as e:
            conn.broken = True
            raise _transient(f"{self.method}: recv failed: {e}") from e
        if frame is None:
            conn.broken = True
            raise _transient(f"{self.method}: connection closed mid-rpc")
        ftype, flags, stream, payload = frame
        if ftype == _SETTINGS:
            if not flags & _FLAG_ACK:
                conn.note_peer_settings(payload)
                conn.send_frame(_SETTINGS, _FLAG_ACK, 0, b"")
            return
        if ftype == _PING:
            if not flags & _FLAG_ACK:
                conn.send_frame(_PING, _FLAG_ACK, 0, payload)
            return
        if ftype == _WINDOW_UPDATE:
            return
        if ftype == _GOAWAY:
            conn.broken = True
            raise _transient(f"{self.method}: server sent GOAWAY")
        if stream != self.stream_id:
            return  # stray frame for a dead stream; ignore
        if ftype == _RST_STREAM:
            conn.broken = True
            code = struct.unpack("!I", payload)[0] if len(payload) >= 4 else 0
            raise _transient(
                f"{self.method}: stream reset by server (h2 error {code})"
            )
        if ftype == _DATA:
            if flags & _FLAG_PADDED and payload:
                pad = payload[0]
                payload = payload[1 : len(payload) - pad]
            self._decoder.feed(payload)
            if flags & _FLAG_END_STREAM:
                self._remote_closed = True
            return
        if ftype == _HEADERS:
            if not flags & _FLAG_END_HEADERS:
                conn.broken = True
                raise _transient(
                    f"{self.method}: fragmented header block (CONTINUATION "
                    "unsupported)"
                )
            if flags & _FLAG_PADDED and payload:
                pad = payload[0]
                payload = payload[1 : len(payload) - pad]
            elif flags & _FLAG_PRIORITY:
                payload = payload[5:]
            try:
                hdrs = decode_request_headers(payload)
            except _HpackError as e:
                conn.broken = True
                raise _transient(f"{self.method}: bad header block: {e}") from e
            if "grpc-status" in hdrs:
                try:
                    self._trailers_status = int(hdrs["grpc-status"])
                except ValueError:
                    self._trailers_status = 2  # UNKNOWN
                self._trailers_message = hdrs.get("grpc-message", "")
                if flags & _FLAG_END_STREAM:
                    self._remote_closed = True
            # else: initial response headers (:status 200) — nothing to do.
            return
        # Unknown frame type: ignore (extension frames are legal).

    # ------------------------------------------------------------- close --
    def cancel(self) -> None:
        """RST_STREAM CANCEL; the connection is discarded (frames from
        the cancelled stream may still be in flight on it)."""
        if self._finished:
            return
        self._finished = True
        try:
            self._conn.send_frame(
                _RST_STREAM, 0, self.stream_id, struct.pack("!I", 0x8)
            )
        except OSError:
            pass
        self._conn.broken = True
        self._channel._release(self._conn)

    def close(self) -> None:
        """Return the connection: reusable iff the RPC ended cleanly."""
        if self._finished:
            return
        self._finished = True
        if not (
            self._remote_closed and self._trailers_status is not None
        ):
            self._conn.broken = True
        self._channel._release(self._conn)


class GrpcWireChannel:
    """Pool of :class:`_WireConn` serving one RPC each, round-robin by
    lease order. ``pool``-sized free-list; concurrency beyond it dials
    ephemeral sockets (dropped on release once the list is full)."""

    def __init__(
        self,
        host: str,
        port: int,
        *,
        tls: bool = False,
        cafile: Optional[str] = None,
        insecure_skip_verify: bool = False,
        authority: Optional[str] = None,
        timeout_s: float = 30.0,
        idle_cap: int = 4,
    ):
        self.host, self.port, self.tls = host, port, tls
        self.cafile = cafile
        self.insecure_skip_verify = insecure_skip_verify
        self.authority = authority or f"{host}:{port}"
        self.timeout_s = timeout_s
        self._idle_cap = idle_cap
        self._idle: list[_WireConn] = []
        self._lock = threading.Lock()
        self.stats = {"connects": 0, "reuses": 0}
        self._closed = False

    # ------------------------------------------------------------- conns --
    def _dial(self) -> _WireConn:
        with self._lock:
            self.stats["connects"] += 1
        try:
            return _WireConn(
                self.host,
                self.port,
                tls=self.tls,
                cafile=self.cafile,
                insecure_skip_verify=self.insecure_skip_verify,
                authority=self.authority,
                connect_timeout_s=min(self.timeout_s, 20.0),
            )
        except OSError as e:
            raise _transient(
                f"grpc wire: connect {self.host}:{self.port} failed: {e}"
            ) from e

    def _lease(self) -> _WireConn:
        with self._lock:
            if self._idle:
                self.stats["reuses"] += 1
                return self._idle.pop()
        return self._dial()

    def _release(self, conn: _WireConn) -> None:
        if conn.broken or self._closed:
            conn.close()
            return
        with self._lock:
            if len(self._idle) < self._idle_cap:
                self._idle.append(conn)
                return
        conn.close()

    # -------------------------------------------------------------- RPCs --
    def start_call(self, method: str) -> WireCall:
        """Open an RPC; caller drives send/recv and must close()."""
        conn = self._lease()
        try:
            return WireCall(self, conn, method)
        except OSError:
            # Stale keep-alive socket: one fresh dial, then give up to
            # the retry plane above.
            conn.close()
            conn = self._dial()
            try:
                return WireCall(self, conn, method)
            except OSError as e:
                conn.close()
                raise _transient(f"{method}: send failed: {e}") from e

    def unary(self, method: str, request: bytes) -> bytes:
        """One request in, exactly one response message out."""
        call = self.start_call(method)
        try:
            call.send_message(request, end=True)
            resp = call.recv_message()
            if resp is None:
                raise _transient(f"{method}: OK trailers with no response")
            # Drain to trailers so the conn is clean for reuse.
            while call.recv_message() is not None:
                pass
            return resp
        except BaseException:
            call.cancel()
            raise
        finally:
            call.close()

    def server_stream(self, method: str, request: bytes) -> WireCall:
        """Send the one request, return the call for streamed reads."""
        call = self.start_call(method)
        try:
            call.send_message(request, end=True)
        except BaseException:
            call.cancel()
            raise
        return call

    def bidi(self, method: str) -> WireCall:
        """Open a bidi stream; caller interleaves send/recv."""
        return self.start_call(method)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()
