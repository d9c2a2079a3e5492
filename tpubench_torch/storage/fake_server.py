"""A real HTTP/1.1 server speaking the GCS JSON-API object surface — the
surface of ``tpubench/storage/fake_server.py``, the hermetic target of the
port's http clients.

* ``GET /storage/v1/b/<bucket>/o/<object>?alt=media`` — media download,
  honoring ``Range: bytes=a-b``;
* ``GET /storage/v1/b/<bucket>/o/<object>`` — metadata;
* ``GET /storage/v1/b/<bucket>/o?prefix=`` — list (``maxResults`` /
  ``pageToken`` pages);
* ``POST /upload/storage/v1/b/<bucket>/o?uploadType=media|resumable&name=``
  — one-shot upload or resumable session open;
* ``PUT /upload/storage/v1/b/<bucket>/o?uploadType=resumable&upload_id=``
  — a content-range part, the finalize, or the ``bytes */*`` probe;
* ``DELETE /storage/v1/b/<bucket>/o/<object>``.

Fault injection (503s, latency, mid-body resets, the upload-side faults)
comes from the backing
:class:`~tpubench_torch.storage.fake.FakeBackend`'s :class:`FaultPlan`.

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


# Sentinel returned by handle_upload_request: the injected fault killed
# the connection mid-part — the server must abort the socket, not answer.
RESET_CONNECTION = ("reset",)


def parse_content_range(hdr: str):
    """``Content-Range: bytes a-b/T`` → (start, total) with ``None`` for
    ``*`` on either side (``bytes */T`` is the resume probe / finalize
    form; ``bytes */*`` the pure probe). Malformed → ValueError."""
    spec = hdr.strip()
    if not spec.startswith("bytes "):
        raise ValueError(f"bad Content-Range: {hdr!r}")
    rng, _, total_s = spec[len("bytes "):].partition("/")
    total = None if total_s.strip() in ("", "*") else int(total_s)
    if rng.strip() == "*":
        return None, total
    start_s, _, _end_s = rng.partition("-")
    return int(start_s), total


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


def handle_upload_request(
    backend: FakeBackend, method: str, parts, query: dict,
    headers, body: bytes, host: str,
):
    """Wire-agnostic upload routing shared by the h1.1 handler and the h2
    server's HTTP/1.1 side — one resumable-upload semantics, two framings. Returns ``(status, extra_headers, body_dict)``
    or :data:`RESET_CONNECTION` when an injected mid-part fault must kill
    the socket.

    Routes (the GCS JSON upload surface):

    * ``POST …?uploadType=media&name=N[&ifGenerationMatch=G]`` — one-shot
      media upload, precondition honored (412 on mismatch);
    * ``POST …?uploadType=resumable&name=N[&ifGenerationMatch=G]`` —
      session open; the session URL rides the ``Location`` header;
    * ``PUT …?uploadType=resumable&upload_id=U`` + ``Content-Range`` —
      one part (``bytes a-b/*``), the finalize form (``bytes a-b/T`` /
      ``bytes */T``) or the resume probe (``bytes */*``): partial commits
      answer **308 with the committed ``Range``**, completion answers the
      object metadata, precondition mismatch 412.
    """
    if len(parts) < 6 or parts[1] != "upload":
        return 404, {}, {"error": {"code": 404, "message": "no route"}}
    bucket = parts[4]
    upload_type = query.get("uploadType", [""])[0]
    igm_raw = query.get("ifGenerationMatch", [""])[0]
    igm = int(igm_raw) if igm_raw else None

    def err(e: StorageError):
        return (e.code or 500), {}, {
            "error": {"code": e.code or 500, "message": str(e)}
        }

    if method == "POST" and upload_type == "media":
        name = query.get("name", [""])[0]
        if not name:
            return 400, {}, {"error": {"code": 400, "message": "missing name"}}
        try:
            meta = backend.write(name, body, if_generation_match=igm)
        except StorageError as e:
            return err(e)
        return 200, {}, object_meta_dict(meta)
    if method == "POST" and upload_type == "resumable":
        name = query.get("name", [""])[0]
        if not name:
            return 400, {}, {"error": {"code": 400, "message": "missing name"}}
        uid = backend.begin_upload(name, if_generation_match=igm)
        session = (
            f"http://{host}/upload/storage/v1/b/{bucket}/o"
            f"?uploadType=resumable&upload_id={uid}"
        )
        return 200, {
            "Location": session, "X-GUploader-UploadID": uid,
        }, {}
    if method == "PUT" and upload_type == "resumable":
        uid = query.get("upload_id", [""])[0]
        try:
            start, total = parse_content_range(
                headers.get("Content-Range", "") or
                headers.get("content-range", "")
            )
        except ValueError as e:
            return 400, {}, {"error": {"code": 400, "message": str(e)}}
        try:
            committed, final = backend.upload_status(uid)
            if final is not None:
                # Idempotent replay of a part/finalize whose response was
                # lost: the object is already committed — answer its meta.
                return 200, {}, object_meta_dict(final)
            if body:
                if start is None:
                    return 400, {}, {"error": {
                        "code": 400,
                        "message": "data part needs an explicit range",
                    }}
                if start > committed:
                    # Client ran ahead of the server's watermark: resync
                    # via 308 + Range, the resume contract.
                    return _resume_308(committed)
                committed = backend.upload_append(uid, start, body)
            if total is not None and committed == total:
                meta = backend.finalize_upload(uid, total=total)
                return 200, {}, object_meta_dict(meta)
        except StorageError as e:
            if e.code == 104:
                return RESET_CONNECTION
            return err(e)
        return _resume_308(committed)
    return 404, {}, {"error": {"code": 404, "message": "no upload route"}}


def _resume_308(committed: int):
    hdrs = {"Range": f"bytes=0-{committed - 1}"} if committed > 0 else {}
    return 308, hdrs, {}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive (main.go:31-32)
    server_version = "fake-gcs/0.1"

    def log_message(self, fmt, *args):  # noqa: D102 — quiet
        pass

    @property
    def backend(self) -> FakeBackend:
        return self.server.backend  # type: ignore[attr-defined]

    def _send_json(self, code: int, obj: dict,
                   extra_headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json; charset=UTF-8")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
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
                    return self._reset()
                if n <= 0:
                    break
                self.wfile.write(mv[:n])
        finally:
            reader.close()

    def _reset(self) -> None:
        self.close_connection = True
        try:
            self.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def _upload(self, method: str) -> None:
        """POST/PUT upload surface: media + resumable sessions, shared
        with the h2 server's HTTP/1.1 side via handle_upload_request."""
        parsed = urllib.parse.urlsplit(self.path)
        query = urllib.parse.parse_qs(parsed.query)
        if inject_open_fault(self.backend):
            return self._send_error_json(503, "injected unavailability")
        n = int(self.headers.get("Content-Length", "0"))
        data = self.rfile.read(n) if n else b""
        resp = handle_upload_request(
            self.backend, method, parsed.path.split("/"), query,
            self.headers, data, host=self.headers.get("Host", "127.0.0.1"),
        )
        if resp == RESET_CONNECTION:
            # Injected mid-part fault: kill the socket, the shape the
            # media path takes mid-body.
            return self._reset()
        status, extra_headers, body = resp
        self._send_json(status, body, extra_headers)

    def do_POST(self):  # noqa: N802
        self._upload("POST")

    def do_PUT(self):  # noqa: N802
        self._upload("PUT")

    def do_DELETE(self):  # noqa: N802
        parts = urllib.parse.urlsplit(self.path).path.split("/")
        name = self._object_name(parts)
        if not name:
            return self._send_error_json(404, "no route")
        try:
            self.backend.delete(name)
        except StorageError as e:
            return self._send_error_json(e.code or 500, str(e))
        self.send_response(204)
        self.send_header("Content-Length", "0")
        self.end_headers()


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
