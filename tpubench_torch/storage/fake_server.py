"""A real HTTP/1.1 server speaking the GCS JSON-API object surface — the
read surface of ``tpubench/storage/fake_server.py``, the hermetic target
of the port's http clients.

* ``GET /storage/v1/b/<bucket>/o/<object>?alt=media`` — media download,
  honoring ``Range: bytes=a-b``;
* ``GET /storage/v1/b/<bucket>/o/<object>`` — metadata;
* ``GET /storage/v1/b/<bucket>/o?prefix=`` — list (``maxResults`` /
  ``pageToken`` pages).

Fault injection (503s, latency, mid-body resets) comes from the backing
:class:`~tpubench_torch.storage.fake.FakeBackend`'s :class:`FaultPlan`.
The upload and delete routes come with the store's write side
(``ROADMAP.md`` A.6); until then the server answers them 501.

``tls=True`` serves https with an ephemeral self-signed certificate made
by the ``openssl`` command-line tool (:func:`make_self_signed_cert`).
"""

from __future__ import annotations

import json
import shutil
import socket
import subprocess
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tpubench_torch.storage.base import StorageError, object_meta_dict
from tpubench_torch.storage.fake import FakeBackend


def paginate_listing(items, query: dict) -> dict:
    """The GCS list page surface (``maxResults``/``pageToken``): one page
    of the sorted listing, with ``nextPageToken`` (a name cursor — the
    next page starts strictly after it) when more remain. Shared by the
    h1.1 and h2 fakes."""
    max_results = int(query.get("maxResults", ["0"])[0] or 0)
    token = query.get("pageToken", [""])[0]
    if token:
        items = [m for m in items if m.name > token]
    page = items if max_results <= 0 else items[:max_results]
    doc = {
        "kind": "storage#objects",
        "items": [object_meta_dict(m) for m in page],
    }
    if 0 < max_results < len(items):
        doc["nextPageToken"] = page[-1].name
    return doc


def inject_open_fault(backend: FakeBackend) -> bool:
    """The servers' open-time fault gate: the moment's latency, then one
    roll against ``error_rate``. True when the request must be answered
    with an injected 503."""
    fault = backend.fault.at()
    if fault.latency_s:
        time.sleep(fault.latency_s)
    if fault.error_rate:
        with backend._rng_lock:
            r = backend._rng.random()
        if r < fault.error_rate:
            backend.injected_errors += 1
            return True
    return False


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive (main.go:31-32)
    server_version = "fake-gcs/0.1"

    def log_message(self, fmt, *args):  # noqa: D102 — quiet
        pass

    @property
    def backend(self) -> FakeBackend:
        return self.server.backend  # type: ignore[attr-defined]

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, code: int, message: str) -> None:
        self._send_json(code, {"error": {"code": code, "message": message}})

    def _object_name(self, parts) -> Optional[str]:
        # /storage/v1/b/<bucket>/o/<object> — object may be %2F-encoded.
        if (len(parts) >= 7 and parts[1] == "storage" and parts[3] == "b"
                and parts[5] == "o"):
            return urllib.parse.unquote("/".join(parts[6:]))
        return None

    def _range(self) -> Optional[tuple[int, Optional[int]]]:
        hdr = self.headers.get("Range")
        if not hdr or not hdr.startswith("bytes="):
            return None
        start_s, _, end_s = hdr[len("bytes="):].partition("-")
        return int(start_s), (int(end_s) if end_s else None)

    def do_GET(self):  # noqa: N802
        parsed = urllib.parse.urlsplit(self.path)
        query = urllib.parse.parse_qs(parsed.query)
        parts = parsed.path.split("/")
        if inject_open_fault(self.backend):
            return self._send_error_json(503, "injected unavailability")
        try:
            name = self._object_name(parts)
            if name:  # object media or metadata
                if query.get("alt", [""])[0] == "media":
                    return self._get_media(name)
                meta = self.backend.stat(name)
                return self._send_json(200, object_meta_dict(meta))
            if len(parts) >= 6 and parts[3] == "b" and parts[5] == "o":  # list
                prefix = query.get("prefix", [""])[0]
                return self._send_json(
                    200, paginate_listing(self.backend.list(prefix), query)
                )
            self._send_error_json(404, f"no route: {parsed.path}")
        except StorageError as e:
            self._send_error_json(e.code or 500, str(e))

    def _get_media(self, name: str) -> None:
        rng = self._range()
        meta = self.backend.stat(name)
        start, end = 0, meta.size - 1
        code = 200
        if rng is not None:
            start = rng[0]
            end = meta.size - 1 if rng[1] is None else min(rng[1], meta.size - 1)
            code = 206
        length = max(0, end - start + 1)
        reader = self.backend.open_read(name, start=start, length=length)
        self.send_response(code)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(length))
        self.send_header("x-goog-generation", str(meta.generation))
        if code == 206:
            self.send_header("Content-Range", f"bytes {start}-{end}/{meta.size}")
        self.end_headers()
        mv = memoryview(bytearray(self.server.chunk_bytes))  # type: ignore[attr-defined]
        try:
            while True:
                try:
                    n = reader.readinto(mv)
                except StorageError:
                    # Mid-body fault: the headers are on the wire, so a
                    # JSON error would be read as body bytes. Kill the
                    # connection instead (the reset shape).
                    self.close_connection = True
                    try:
                        self.connection.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    return
                if n <= 0:
                    break
                self.wfile.write(mv[:n])
        finally:
            reader.close()


class _Server(ThreadingHTTPServer):
    # 48 workers connect at once: socketserver's default backlog of 5
    # drops SYNs, and each dropped one costs the client a 1 s (then 3 s)
    # retransmit before its first byte.
    request_queue_size = 64


class FakeGcsServer:
    """Threaded fake-GCS server; a context manager. ``tls=True`` wraps the
    listener in TLS with an ephemeral self-signed certificate (SAN:
    localhost + 127.0.0.1); ``cafile`` is then the PEM to trust."""

    def __init__(
        self,
        backend: Optional[FakeBackend] = None,
        port: int = 0,
        tls: bool = False,
        chunk_bytes: int = 256 * 1024,
    ):
        self.backend = backend or FakeBackend()
        self._httpd = _Server(("127.0.0.1", port), _Handler)
        self._httpd.backend = self.backend  # type: ignore[attr-defined]
        self._httpd.chunk_bytes = chunk_bytes  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._tls = tls
        self.cafile = ""
        if tls:
            import ssl

            self.cafile, keyfile = make_self_signed_cert()
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.cafile, keyfile)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True
            )

    @property
    def endpoint(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{'https' if self._tls else 'http'}://{host}:{port}"

    def start(self) -> "FakeGcsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-gcs-http",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def __enter__(self) -> "FakeGcsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def make_self_signed_cert(hostname: str = "localhost") -> tuple[str, str]:
    """Ephemeral self-signed server certificate (SAN: ``hostname`` +
    127.0.0.1) made by the ``openssl`` command-line tool in a new temp
    directory. Returns ``(certfile, keyfile)``; the certificate doubles
    as the CA bundle clients trust. Raises StorageError without
    ``openssl``."""
    exe = shutil.which("openssl")
    if exe is None:
        raise StorageError(
            "a self-signed TLS certificate needs the `openssl` binary",
            transient=False,
        )
    d = tempfile.mkdtemp(prefix="tpubench-tls-")
    certfile = f"{d}/cert.pem"
    keyfile = f"{d}/key.pem"
    proc = subprocess.run(
        [
            exe, "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", keyfile, "-out", certfile, "-days", "1",
            "-subj", f"/CN={hostname}",
            "-addext", f"subjectAltName=DNS:{hostname},IP:127.0.0.1",
        ],
        capture_output=True, text=True, timeout=30,
    )
    if proc.returncode != 0:
        raise StorageError(
            f"openssl cert generation failed: {proc.stderr.strip()}",
            transient=False,
        )
    return certfile, keyfile
