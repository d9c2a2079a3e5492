"""A minimal HTTP/2 fake-GCS server (h2c prior knowledge / TLS+ALPN) — a
copy of ``tpubench/storage/fake_h2_server.py``, the hermetic target of the native HTTP/2 client (the reference's
``ForceAttemptHTTP2`` branch, ``main.go:76-80``).

Python's stdlib has no h2 server, so this implements the slice the
clients need:

* connection preface + SETTINGS exchange, PING replies;
* request HEADERS decoded by structural HPACK (indexed entries resolved
  against the static-table pseudo-headers clients commonly index; literal
  entries with plain or static-table names). Huffman-coded request
  strings are answered 400 — the engine's client never huffman-encodes;
* ``GET .../o/<object>?alt=media`` with ``Range``, served as a literal
  ``:status`` + ``content-length`` HEADERS frame and 16 KiB DATA frames
  from the backing :class:`FakeBackend` (faults included); object
  metadata and list over h2 (the whole-client h2 mode sends them too);
* concurrent streams: each request is served on its own thread as its
  END_STREAM arrives;
* an HTTP/1.1 side on the same port (metadata, media, list, and the
  media and resumable uploads), as real GCS serves both protocols on one
  port.

The frame helpers (:data:`_PREFACE`, :func:`decode_request_headers`,
:func:`_hp_literal`) are shared with the gRPC wire client and server.
"""

from __future__ import annotations

import json
import socket
import ssl
import struct
import threading
import urllib.parse
from typing import Optional

from tpubench_torch.storage.base import StorageError, object_meta_dict
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_server import (
    RESET_CONNECTION,
    handle_upload_request,
    inject_open_fault,
    make_self_signed_cert,
    paginate_listing,
)

_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# RFC 7541 Appendix A static-table entries this server resolves (the ones
# clients commonly send indexed for a GET).
_STATIC = {
    2: (":method", "GET"),
    3: (":method", "POST"),
    4: (":path", "/"),
    6: (":scheme", "http"),
    7: (":scheme", "https"),
}


class _HpackError(Exception):
    pass


def _hpd_int(data: bytes, i: int, prefix: int) -> tuple[int, int]:
    if i >= len(data):
        raise _HpackError("truncated int")
    maxp = (1 << prefix) - 1
    v = data[i] & maxp
    i += 1
    if v == maxp:
        m = 0
        while True:
            if i >= len(data) or m > 56:
                raise _HpackError("truncated varint")
            b = data[i]
            i += 1
            v += (b & 0x7F) << m
            if not b & 0x80:
                break
            m += 7
    return v, i


def _hpd_str(data: bytes, i: int) -> tuple[str, int]:
    if i >= len(data):
        raise _HpackError("truncated string")
    huff = data[i] & 0x80
    n, i = _hpd_int(data, i, 7)
    if i + n > len(data):
        raise _HpackError("string past end")
    if huff:
        raise _HpackError("huffman-coded request strings unsupported")
    return data[i : i + n].decode("latin-1"), i + n


def decode_request_headers(block: bytes) -> dict[str, str]:
    """Structural HPACK decode of a header block into a dict."""
    out: dict[str, str] = {}
    i = 0
    while i < len(block):
        b = block[i]
        if b & 0x80:  # indexed
            idx, i = _hpd_int(block, i, 7)
            if idx in _STATIC:
                k, v = _STATIC[idx]
                out[k] = v
            continue
        if (b & 0xE0) == 0x20:  # dynamic table size update
            _, i = _hpd_int(block, i, 5)
            continue
        prefix = 6 if b & 0x40 else 4
        idx, i = _hpd_int(block, i, prefix)
        if idx == 0:
            name, i = _hpd_str(block, i)
        else:
            name = _STATIC.get(idx, (f"idx{idx}", ""))[0]
        value, i = _hpd_str(block, i)
        out[name.lower()] = value
    return out


def _hp_literal(name: str, value: str) -> bytes:
    """One header as an HPACK literal never indexed, plain strings."""

    def _s(x: bytes) -> bytes:
        if len(x) < 127:
            return bytes([len(x)]) + x
        n = len(x) - 127
        out = bytearray([127])
        while n >= 128:
            out.append((n & 0x7F) | 0x80)
            n >>= 7
        out.append(n)
        return bytes(out) + x

    return b"\x10" + _s(name.encode()) + _s(value.encode())


def _byte_range(spec: str, size: int) -> tuple[int, int, int]:
    """``(start, end, status)`` of a ``Range`` header value against an
    object of ``size`` bytes (no header: the whole object, 200)."""
    if not spec.startswith("bytes="):
        return 0, size - 1, 200
    a, _, b = spec[len("bytes="):].partition("-")
    return int(a), (size - 1 if not b else min(int(b), size - 1)), 206


class _Conn:
    def __init__(self, sock: socket.socket, backend: FakeBackend):
        self.sock = sock
        self.backend = backend
        self.wlock = threading.Lock()

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

    # ------------------------------------------------------------ serving --
    def serve(self) -> None:
        try:
            first = self._recv_all(len(_PREFACE))
            if first is None:
                return
            if first != _PREFACE:
                # Not the h2 preface: an HTTP/1.1 request on the same port.
                return self._serve_h11(first)
            self.send_frame(4, 0, 0, b"")  # empty SETTINGS
            headers_by_stream: dict[int, dict] = {}
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
                if ftype == 4 and not fflags & 0x1:  # SETTINGS -> ACK
                    self.send_frame(4, 0x1, 0, b"")
                elif ftype == 6 and not fflags & 0x1:  # PING -> ACK
                    self.send_frame(6, 0x1, 0, payload)
                elif ftype == 1:  # HEADERS
                    if not fflags & 0x4:
                        return  # CONTINUATION unsupported: drop conn
                    block = payload
                    if fflags & 0x8:  # PADDED
                        pad = block[0]
                        block = block[1 : len(block) - pad]
                    if fflags & 0x20:  # PRIORITY
                        block = block[5:]
                    try:
                        headers_by_stream[stream] = decode_request_headers(block)
                    except _HpackError as e:
                        self._respond_body(stream, 400, str(e).encode())
                        continue
                    if fflags & 0x1:  # END_STREAM: a GET, serve now
                        self._spawn(stream, headers_by_stream.pop(stream))
                elif ftype == 0:  # DATA (request bodies: ignored)
                    if fflags & 0x1 and stream in headers_by_stream:
                        self._spawn(stream, headers_by_stream.pop(stream))
                elif ftype == 7:  # GOAWAY
                    return
        except OSError:
            return
        finally:
            try:
                self.sock.close()
            except OSError:
                pass

    def _spawn(self, stream: int, headers: dict) -> None:
        threading.Thread(
            target=self._handle, args=(stream, headers),
            name=f"h2-stream-{stream}", daemon=True,
        ).start()

    def _serve_h11(self, initial: bytes) -> None:
        """Keep-alive HTTP/1.1 side: object metadata, media (with Range),
        list — and the upload surface (media + resumable sessions), since
        an ``http2=True`` client's writes ride the HTTP/1.1 pool (the
        native h2 client is GET-only). Upload semantics are the h1.1
        fake's :func:`handle_upload_request`: one definition, two
        framings."""
        buf = initial
        while True:
            while b"\r\n\r\n" not in buf:
                chunk = self.sock.recv(65536)
                if not chunk:
                    return
                buf += chunk
            head, _, buf = buf.partition(b"\r\n\r\n")
            lines = head.decode("latin-1").split("\r\n")
            try:
                method, path, _ = lines[0].split(" ", 2)
            except ValueError:
                return
            hdrs = {}
            for ln in lines[1:]:
                k, _, v = ln.partition(":")
                hdrs[k.strip().lower()] = v.strip()

            def send(status: int, body: bytes, ctype: str, extra: str = ""):
                self.sock.sendall(
                    (
                        f"HTTP/1.1 {status} X\r\nContent-Type: {ctype}\r\n"
                        f"Content-Length: {len(body)}\r\n{extra}\r\n"
                    ).encode()
                    + body
                )

            def send_error(code: int) -> None:
                send(code, json.dumps({"error": {"code": code}}).encode(),
                     "application/json")

            parsed = urllib.parse.urlsplit(path)
            query = urllib.parse.parse_qs(parsed.query)
            parts = parsed.path.split("/")
            clen = int(hdrs.get("content-length", "0") or 0)
            if len(buf) < clen:
                # bytearray: a part is MiBs, and bytes += would copy the
                # whole prefix on every recv.
                buf = bytearray(buf)
                while len(buf) < clen:
                    chunk = self.sock.recv(1 << 20)
                    if not chunk:
                        return
                    buf += chunk
            req_body, buf = bytes(buf[:clen]), bytes(buf[clen:])
            if len(parts) >= 2 and parts[1] == "upload":
                resp = handle_upload_request(
                    self.backend, method, parts, query,
                    {"Content-Range": hdrs.get("content-range", "")},
                    req_body, host=hdrs.get("host", "127.0.0.1"),
                )
                if resp == RESET_CONNECTION:
                    try:
                        self.sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
                status, extra_headers, body_doc = resp
                extra = "".join(
                    f"{k}: {v}\r\n" for k, v in extra_headers.items()
                )
                send(status, json.dumps(body_doc).encode(),
                     "application/json", extra)
                continue
            if (
                method == "GET"
                and len(parts) >= 6
                and parts[1] == "storage"
                and parts[5] == "o"
                and not "/".join(parts[6:])
            ):
                prefix = query.get("prefix", [""])[0]
                send(
                    200,
                    json.dumps(
                        paginate_listing(self.backend.list(prefix), query)
                    ).encode(),
                    "application/json",
                )
                continue
            if (
                method == "DELETE"
                and len(parts) >= 7
                and parts[1] == "storage"
                and parts[5] == "o"
            ):
                # The HTTP/1.1 fake's do_DELETE (``tpubench``'s h2 fake
                # answers 404 here: ROADMAP C.7).
                try:
                    self.backend.delete(
                        urllib.parse.unquote("/".join(parts[6:]))
                    )
                except StorageError as e:
                    send_error(e.code or 500)
                    continue
                send(204, b"", "application/json")
                continue
            if (
                method != "GET"
                or len(parts) < 7
                or parts[1] != "storage"
                or parts[5] != "o"
            ):
                send_error(404)
                continue
            name = urllib.parse.unquote("/".join(parts[6:]))
            try:
                meta = self.backend.stat(name)
            except StorageError as e:
                send_error(e.code or 404)
                continue
            if query.get("alt", [""])[0] != "media":
                send(200, json.dumps(object_meta_dict(meta)).encode(),
                     "application/json")
                continue
            start, end, status = _byte_range(hdrs.get("range", ""), meta.size)
            try:
                reader = self.backend.open_read(
                    name, start=start, length=max(0, end - start + 1)
                )
            except StorageError as e:
                send_error(e.code or 500)
                continue
            data = bytearray()
            mv = memoryview(bytearray(65536))
            while True:
                n = reader.readinto(mv)
                if n <= 0:
                    break
                data += mv[:n]
            reader.close()
            extra = (
                f"Content-Range: bytes {start}-{end}/{meta.size}\r\n"
                if status == 206 else ""
            )
            extra += f"x-goog-generation: {meta.generation}\r\n"
            send(status, bytes(data), "application/octet-stream", extra)

    def _respond_body(self, stream: int, status: int, body: bytes) -> None:
        """One complete response: ``:status`` + content-length HEADERS and
        the body as one DATA frame with END_STREAM (the engine's client
        advertises a 2^24-1 max frame size)."""
        hb = _hp_literal(":status", str(status)) + _hp_literal(
            "content-length", str(len(body))
        )
        try:
            self.send_frame(1, 0x4, stream, hb)
            self.send_frame(0, 0x1, stream, body)
        except OSError:
            pass

    def _handle(self, stream: int, h: dict) -> None:
        if inject_open_fault(self.backend):
            return self._respond_body(stream, 503, b"injected unavailability")
        path = h.get(":path", "/")
        parsed = urllib.parse.urlsplit(path)
        query = urllib.parse.parse_qs(parsed.query)
        parts = parsed.path.split("/")
        if (
            len(parts) < 6
            or parts[1] != "storage"
            or parts[3] != "b"
            or parts[5] != "o"
        ):
            return self._respond_body(stream, 404, f"no route: {path}".encode())
        if len(parts) == 6 or not "/".join(parts[6:]):  # list
            prefix = query.get("prefix", [""])[0]
            body = json.dumps(
                paginate_listing(self.backend.list(prefix), query)
            ).encode()
            return self._respond_body(stream, 200, body)
        name = urllib.parse.unquote("/".join(parts[6:]))
        try:
            meta = self.backend.stat(name)
        except StorageError as e:
            return self._respond_body(stream, e.code or 404, str(e).encode())
        if query.get("alt", [""])[0] != "media":
            body = json.dumps(object_meta_dict(meta)).encode()
            return self._respond_body(stream, 200, body)
        start, end, status = _byte_range(h.get("range", ""), meta.size)
        length = max(0, end - start + 1)
        try:
            reader = self.backend.open_read(name, start=start, length=length)
        except StorageError as e:
            # The backend's own open-time fault: answer its status rather
            # than leave the stream waiting for a socket timeout.
            return self._respond_body(stream, e.code or 500, str(e).encode())
        hb = (
            _hp_literal(":status", str(status))
            + _hp_literal("content-length", str(length))
            + _hp_literal("x-goog-generation", str(meta.generation))
        )
        try:
            # A zero-length body ends the stream on the HEADERS frame.
            self.send_frame(1, 0x4 | (0x1 if length == 0 else 0), stream, hb)
            mv = memoryview(bytearray(16384))
            sent = 0
            while sent < length:
                try:
                    n = reader.readinto(mv)
                except StorageError:
                    # Mid-stream fault: RST the stream, the mid-body cut
                    # the h1.1 fake makes by closing.
                    self.send_frame(3, 0, stream, struct.pack("!I", 2))
                    return
                if n <= 0:
                    # Backend exhausted early: end the stream rather than
                    # leave it dangling short of content-length.
                    self.send_frame(0, 0x1, stream, b"")
                    break
                sent += n
                self.send_frame(
                    0, 0x1 if sent >= length else 0, stream, bytes(mv[:n])
                )
        except OSError:
            pass
        finally:
            reader.close()


class FakeH2Server:
    """Threaded fake h2 media server; a context manager. Plain mode speaks
    h2c with prior knowledge (an ``http://`` endpoint with ``http2``);
    ``tls=True`` serves TLS with ALPN ``h2`` and an ephemeral self-signed
    certificate (``cafile``)."""

    def __init__(self, backend: Optional[FakeBackend] = None, port: int = 0,
                 tls: bool = False):
        self.backend = backend or FakeBackend()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(64)
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
        host, port = self._sock.getsockname()[:2]
        return f"{'https' if self._tls else 'http'}://{host}:{port}"

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            if self._ctx is not None:
                try:
                    conn = self._ctx.wrap_socket(conn, server_side=True)
                except (ssl.SSLError, OSError):
                    continue
            threading.Thread(
                target=_Conn(conn, self.backend).serve,
                name="h2-conn", daemon=True,
            ).start()

    def start(self) -> "FakeH2Server":
        self._thread = threading.Thread(
            target=self._accept_loop, name="h2-accept", daemon=True
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

    def __enter__(self) -> "FakeH2Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
