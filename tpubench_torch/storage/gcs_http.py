"""GCS JSON-API backend over pooled HTTP/1.1 connections — a copy of
``tpubench/storage/gcs_http.py``.

Reference parity (``CreateHttpClient``, main.go:62-104):

* **HTTP/1.1** — the reference kills HTTP/2 (``TLSNextProto`` zeroed,
  main.go:64-72); Python's ``http.client`` is HTTP/1.1-native, so that is
  the default client here. ``transport.http2`` switches the whole client
  to the native engine's HTTP/2 (``ForceAttemptHTTP2``, main.go:76-80):
  media, ``stat`` and ``list`` GETs alike.
* **Connection pool caps** — ``MaxConnsPerHost`` bounds live connections
  (a semaphore), ``MaxIdleConnsPerHost`` the keep-alive pool
  (main.go:31-32,66-68).
* **User-Agent** on every request (``user_agent_round_tripper.go``).
* **Native receive** (``transport.native_receive``): the engine sends the
  GET and parses the headers; body bytes then stream from the socket
  straight into whatever memory ``readinto`` is handed — on the staged
  route, the free view of a page-locked slot.
* **Retry** — not here: :class:`~tpubench_torch.storage.retrying.
  RetryingBackend` wraps this backend. This module raises classified
  ``StorageError``s (transient for 408/429/5xx and socket errors).

* **Multiplexed ranges** (``read_ranges``, under ``transport.http2``):
  many ranged GETs as concurrent streams of one h2 connection, the pod
  workloads' shard fetch.

* **Auth** — a bearer token on every request from the token source
  (:mod:`tpubench_torch.storage.auth`): ADC or ``transport.key_file`` on
  Google's endpoint; an endpoint that is not Google's is anonymous, as in
  ``tpubench``.

* **Writes** — ``write`` is the one-shot media upload, ``open_write`` the
  resumable session (:class:`_ResumableHttpWriter`), ``delete`` the
  object DELETE. All three ride the HTTP/1.1 pool, under ``http2`` too
  (the native h2 client is GET-only), and drop the h2 stat cache's entry.
"""

from __future__ import annotations

import http.client
import json
import ssl
import threading
import time
import urllib.parse
from typing import Optional

from tpubench_torch.config import TransportConfig
from tpubench_torch.native.engine import (
    PERMANENT_CODES,
    TB_ETOOBIG,
    NativeError,
)
from tpubench_torch.obs.flight import note_phase as flight_note
from tpubench_torch.obs.tracing import NoopTracer, SpanCarrier
from tpubench_torch.storage.auth import TokenSource, make_token_source
from tpubench_torch.storage.base import ObjectMeta, StorageError

DEFAULT_ENDPOINT = "https://storage.googleapis.com"

# Status codes the GCS client treats as transient (storage/invoke.go upstream
# semantics: 408, 429, 5xx).
_TRANSIENT = {408, 429, 500, 502, 503, 504}

_drain_tls = threading.local()


def _drain_scratch() -> bytearray:
    """Per-thread 64 KiB drain sink, made once: closing a response with a
    small remainder drains it (to keep the connection reusable) without an
    allocation per close."""
    buf = getattr(_drain_tls, "buf", None)
    if buf is None:
        buf = _drain_tls.buf = bytearray(65536)
    return buf


class _ConnectionPool:
    """Keep-alive pool with the reference's two caps (main.go:31-32)."""

    def __init__(self, host: str, port: int, scheme: str, transport: TransportConfig):
        self._host, self._port, self._scheme = host, port, scheme
        self._max_conns = threading.Semaphore(transport.max_conns_per_host)
        self._max_idle = transport.max_idle_conns_per_host
        self._idle: list[http.client.HTTPConnection] = []
        self._lock = threading.Lock()
        # Lets tests assert which pool a request rode (http2 never opens
        # an h1.1 connection).
        self.stats = {"connects": 0}
        self._ctx = None
        if scheme == "https":
            self._ctx = ssl.create_default_context(
                cafile=transport.tls_ca_file or None
            )
            if transport.tls_insecure_skip_verify:
                self._ctx.check_hostname = False
                self._ctx.verify_mode = ssl.CERT_NONE

    def _new_conn(self) -> http.client.HTTPConnection:
        with self._lock:
            self.stats["connects"] += 1
        flight_note("connect")  # flight-recorder phase (no-op off-op)
        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._host, self._port, context=self._ctx, timeout=60
            )
        return http.client.HTTPConnection(self._host, self._port, timeout=60)

    def acquire(self) -> http.client.HTTPConnection:
        self._max_conns.acquire()
        with self._lock:
            if self._idle:
                return self._idle.pop()
        return self._new_conn()

    def release(self, conn: http.client.HTTPConnection, reusable: bool) -> None:
        put_back = False
        if reusable:
            with self._lock:
                if len(self._idle) < self._max_idle:
                    self._idle.append(conn)
                    put_back = True
        if not put_back:
            try:
                conn.close()
            except Exception:
                pass
        self._max_conns.release()

    def close(self) -> None:
        with self._lock:
            for c in self._idle:
                try:
                    c.close()
                except Exception:
                    pass
            self._idle.clear()


class _HttpReader:
    """Streams one media response into the caller's buffers and returns
    its connection to the pool on close: complete responses keep-alive,
    aborted ones closed.

    ``carrier`` (optional) is the client-internal request span: it covers
    request→body-complete, gets a ``first_byte`` event, and ends when the
    reader closes — with the error attached when the body failed."""

    def __init__(self, pool: _ConnectionPool, conn, resp, length: int,
                 carrier=None, generation: Optional[int] = None):
        self._pool = pool
        self._conn = conn
        self._resp = resp
        self._remaining = length
        self.first_byte_ns: Optional[int] = None
        # Served object's generation (x-goog-generation), None when the
        # server did not stamp one.
        self.generation = generation
        self._done = False
        self._carrier = carrier

    def readinto(self, buf: memoryview) -> int:
        if self._done or self._remaining == 0:
            return 0
        want = min(len(buf), self._remaining)
        try:
            n = self._resp.readinto(buf[:want])
        except (http.client.HTTPException, OSError) as e:
            self._done = True
            err = StorageError(f"mid-stream read failed: {e}", transient=True)
            if self._carrier is not None:
                self._carrier.close(err)
            raise err from e
        if n == 0:
            self._done = True
            if self._remaining > 0:
                err = StorageError(
                    f"short body: {self._remaining} bytes missing", transient=True
                )
                if self._carrier is not None:
                    self._carrier.close(err)
                raise err
            return 0
        if self.first_byte_ns is None:
            self.first_byte_ns = time.perf_counter_ns()
            if self._carrier is not None:
                self._carrier.event("first_byte")
        self._remaining -= n
        return n

    def close(self) -> None:
        if self._conn is None:
            return
        complete = self._remaining == 0
        if not complete and 0 < self._remaining <= 1 << 20:
            # Drain small remainders so the connection stays reusable.
            sink = memoryview(_drain_scratch())
            try:
                while self._resp.readinto(sink):
                    pass
                complete = True
            except Exception:
                complete = False
        self._pool.release(self._conn, reusable=complete)
        self._conn = None
        if self._carrier is not None:
            self._carrier.close()  # idempotent; failure paths closed it already


class _NativeStreamReader:
    """Streaming native receive: the engine parsed the response headers
    (``tb_conn_get_begin``); each ``readinto`` hands the caller's own
    memory — granule buffer or staging slot — to ``tb_conn_body_read``,
    which ``recv()``s straight into it without the GIL. No intermediate
    body buffer and no completion copy.

    Holds its pooled connection until ``close()``: complete bodies return
    it keep-alive; abandoned or failed ones discard it."""

    _DRAIN_CAP = 1 << 20  # parity with _HttpReader: drain small remainders

    def __init__(self, pool, conn: int, content_len: int, first_byte_ns: int,
                 carrier=None):
        self._pool = pool
        self._conn: Optional[int] = conn
        self._content_len = content_len  # -1 = close-delimited
        self._consumed = 0
        self.first_byte_ns: Optional[int] = first_byte_ns or None
        self._done = False
        self._failed = False
        self._carrier = carrier

    def readinto(self, buf: memoryview) -> int:
        if self._done or self._conn is None:
            return 0
        try:
            n = self._pool.engine.conn_body_read(self._conn, buf, len(buf))
        except NativeError as e:
            self._failed = True
            self._done = True
            err = StorageError(
                f"mid-stream native read failed: {e}",
                transient=e.code not in PERMANENT_CODES,
            )
            if self._carrier is not None:
                self._carrier.close(err)
            raise err from e
        if n == 0:
            self._done = True
            return 0
        if self.first_byte_ns is None:
            self.first_byte_ns = time.perf_counter_ns()
        self._consumed += n
        return n

    def close(self) -> None:
        if self._conn is None:
            return
        conn, self._conn = self._conn, None
        if self._failed:
            self._pool.discard(conn)
            return  # carrier already closed with the error
        engine = self._pool.engine
        try:
            if not self._done and self._content_len >= 0:
                left = self._content_len - self._consumed
                if 0 < left <= self._DRAIN_CAP:
                    sink = _drain_scratch()
                    while engine.conn_body_read(conn, sink, len(sink)) > 0:
                        pass
            reusable = engine.conn_get_end(conn)
        except Exception:
            self._pool.discard(conn)
        else:
            self._pool.release(conn, reusable)
        if self._carrier is not None:
            self._carrier.close()  # idempotent


class _NativeBufReader:
    """Reader over a body the engine already received into an aligned
    buffer (the h2 and gRPC native clients). ``first_byte_ns`` is the
    engine's CLOCK_MONOTONIC stamp, comparable with
    ``time.perf_counter_ns()`` on Linux; ``readinto`` serves slices."""

    def __init__(self, buf, length: int, first_byte_ns: int, release=None):
        self._buf = buf
        self._len = length
        self._pos = 0
        self.first_byte_ns: Optional[int] = first_byte_ns
        # Back to the backend's BufferPool when pooled, else freed.
        self._release = release

    def readinto(self, out: memoryview) -> int:
        n = min(len(out), self._len - self._pos)
        if n <= 0:
            return 0
        out[:n] = self._buf.view(self._len)[self._pos : self._pos + n]
        self._pos += n
        return n

    def close(self) -> None:
        if self._buf is not None:
            if self._release is not None:
                self._release(self._buf)
            else:
                self._buf.free()
            self._buf = None


def _body(data):
    """A request body without a copy: ``http.client`` sends any
    bytes-like object and sizes it by ``memoryview(body).nbytes``."""
    mv = memoryview(data)
    return mv if mv.ndim == 1 and mv.itemsize == 1 else mv.cast("B")


def _committed_from_range(range_hdr: Optional[str]) -> int:
    """``Range: bytes=0-N`` on a 308 → N+1 committed bytes; absent = 0
    (nothing persisted yet — the empty-session probe's answer)."""
    if not range_hdr or not range_hdr.startswith("bytes=0-"):
        return 0
    try:
        return int(range_hdr[len("bytes=0-"):]) + 1
    except ValueError:
        return 0


class _ResumableHttpWriter:
    """One resumable-upload session over the JSON API (``uploadType=
    resumable``): POST opens the session (the URL rides ``Location``),
    parts PUT with ``Content-Range: bytes a-b/*`` and are acknowledged
    with **308 + the committed ``Range``**, ``committed()`` is the
    ``bytes */*`` resume probe, ``finalize()`` the ``bytes */total``
    completion. Raises classified :class:`StorageError`s and nothing
    more — resume/retry composes above (RetryingBackend's writer), the
    module contract the read path already follows."""

    def __init__(self, backend: "GcsHttpBackend", name: str,
                 if_generation_match: Optional[int]):
        self._b = backend
        self.name = name
        path = (
            f"/upload/storage/v1/b/"
            f"{urllib.parse.quote(backend.bucket, safe='')}/o"
            f"?uploadType=resumable&name={urllib.parse.quote(name, safe='')}"
        )
        if if_generation_match is not None:
            path += f"&ifGenerationMatch={if_generation_match}"
        conn, resp = backend._checked(
            "POST", path,
            headers={"Content-Type": "application/octet-stream"},
            ok=(200, 201),
        )
        try:
            loc = resp.headers.get("Location", "")
            resp.read()
        finally:
            backend._pool.release(conn, reusable=True)
        if not loc:
            raise StorageError(
                f"resumable open {name}: server sent no session Location",
                transient=False,
            )
        u = urllib.parse.urlsplit(loc)
        self._session = u.path + (f"?{u.query}" if u.query else "")
        self.offset = 0
        self._final: Optional[ObjectMeta] = None

    def _put(self, content_range: str, body=b"", ok=(200, 201, 308)):
        conn, resp = self._b._request(
            "PUT", self._session,
            {"Content-Range": content_range,
             "Content-Type": "application/octet-stream"},
            body,
        )
        status = resp.status
        try:
            payload = resp.read()
        except (http.client.HTTPException, OSError) as e:
            self._b._pool.release(conn, reusable=False)
            raise StorageError(
                f"upload {self.name}: response died: {e}", transient=True
            ) from e
        self._b._pool.release(conn, reusable=True)
        if status not in ok:
            raise StorageError(
                f"upload {self.name} -> {status}: "
                f"{payload[:200].decode('utf-8', 'replace')}",
                transient=status in _TRANSIENT,
                code=status,
            )
        return status, resp.headers, payload

    def _finish(self, payload: bytes) -> ObjectMeta:
        # A finalized session changed the object's size, as a media
        # write does: drop the h2 stat cache's entry.
        with self._b._h2_pool_lock:
            self._b._h2_stat_cache.pop(self.name, None)
        meta = json.loads(payload)
        self._final = ObjectMeta(
            meta["name"], int(meta["size"]), int(meta.get("generation", 0))
        )
        self.offset = self._final.size
        return self._final

    def write(self, data) -> int:
        n = len(data)
        if n == 0:
            return self.offset
        start = self.offset
        status, headers, payload = self._put(
            f"bytes {start}-{start + n - 1}/*", _body(data)
        )
        if status != 308:
            # Server finalized (an idempotent replay against a completed
            # session answers the object meta).
            self._finish(payload)
            return self.offset
        committed = _committed_from_range(headers.get("Range"))
        self.offset = committed
        if committed < start + n:
            # The server persisted a prefix: transient — the resuming
            # layer re-probes and resends the tail.
            raise StorageError(
                f"upload {self.name}: committed {committed} < sent "
                f"{start + n}", transient=True,
            )
        return committed

    def committed(self) -> int:
        if self._final is not None:
            return self.offset
        status, headers, payload = self._put("bytes */*")
        if status != 308:
            self._finish(payload)
        else:
            self.offset = _committed_from_range(headers.get("Range"))
        return self.offset

    def finalize(self) -> ObjectMeta:
        if self._final is not None:
            return self._final
        _status, _headers, payload = self._put(
            f"bytes */{self.offset}", ok=(200, 201)
        )
        return self._finish(payload)

    def abort(self) -> None:
        try:
            conn, resp = self._b._request("DELETE", self._session)
            try:
                resp.read()
            finally:
                self._b._pool.release(conn, reusable=True)
        except Exception:  # noqa: BLE001 — best-effort by contract
            pass


class GcsHttpBackend:
    """Thread-safe JSON-API client; one instance shared by all workers
    (the reference shares one ``*storage.Client``, main.go:200-203)."""

    def __init__(self, bucket: str, transport: Optional[TransportConfig] = None,
                 token_source: Optional[TokenSource] = None, tracer=None):
        self.bucket = bucket
        self.transport = transport or TransportConfig()
        # Client-internal request spans, nested under the workload's
        # ReadObject spans (the reference's OC bridge).
        self._tracer = tracer or NoopTracer()
        t = self.transport
        endpoint = t.endpoint or DEFAULT_ENDPOINT
        self._tokens = token_source or make_token_source(t.key_file, t.endpoint)
        u = urllib.parse.urlsplit(endpoint)
        self._scheme = u.scheme
        self._host = u.hostname or "storage.googleapis.com"
        self._port = u.port or (443 if self._scheme == "https" else 80)
        self._pool = _ConnectionPool(self._host, self._port, self._scheme, t)
        # Both native pools are built on first use, under a lock (worker
        # threads hit first use together): the HTTP/1.1 receive pool and,
        # under http2, the h2 pool every GET rides.
        self._native_pool_obj = None
        self._native_pool_lock = threading.Lock()
        self._h2_pool_obj = None
        self._h2_pool_lock = threading.Lock()
        self._h2_stat_cache: dict[str, int] = {}

    @property
    def scheme(self) -> str:
        return self._scheme

    def native_request_parts(self, name: str) -> tuple:
        """(host, port, path, header-block) for a native-engine GET of
        ``name``. Called per request, as in ``tpubench``, where it keeps
        bearer tokens fresh."""
        headers = "".join(
            f"{k}: {v}\r\n"
            for k, v in self._headers().items()
            if k.lower() != "host"  # the engine sets Host itself
        )
        return self._host, self._port, self._opath(name) + "?alt=media", headers

    # ------------------------------------------------------- native pools --
    def _native_pool(self):
        with self._native_pool_lock:
            if self._native_pool_obj is None:
                from tpubench_torch.storage.native_pool import build_native_pool

                self._native_pool_obj = build_native_pool(
                    self.transport, self._host, self._port,
                    tls=self._scheme == "https",
                )
        return self._native_pool_obj

    def _h2_pool(self):
        with self._h2_pool_lock:
            if self._h2_pool_obj is None:
                from tpubench_torch.storage.native_pool import build_native_pool

                # https: TLS with ALPN h2 required; plain http: h2c with
                # prior knowledge.
                self._h2_pool_obj = build_native_pool(
                    self.transport, self._host, self._port,
                    tls=self._scheme == "https",
                    alpn_h2=self._scheme == "https",
                )
        return self._h2_pool_obj

    @property
    def native_conn_stats(self) -> dict:
        return self._native_pool().stats

    # ------------------------------------------------------------ request --
    def _headers(self) -> dict[str, str]:
        h = {
            "User-Agent": self.transport.user_agent,
            "Host": f"{self._host}:{self._port}",
        }
        tok = self._tokens.token()
        if tok:
            h["Authorization"] = f"Bearer {tok}"
        return h

    def _request(self, method: str, path: str, headers: Optional[dict] = None,
                 body=b""):
        """One attempt: acquire a connection, send, return (conn, resp).
        The caller releases the connection."""
        conn = self._pool.acquire()
        try:
            h = self._headers()
            if headers:
                h.update(headers)
            conn.request(method, path, body=body or None, headers=h)
            return conn, conn.getresponse()
        except (http.client.HTTPException, OSError) as e:
            self._pool.release(conn, reusable=False)
            raise StorageError(f"{method} {path}: {e}", transient=True) from e

    def _checked(self, method: str, path: str, headers=None, body=b"",
                 ok=(200, 206)):
        conn, resp = self._request(method, path, headers, body)
        if resp.status in ok:
            return conn, resp
        try:
            payload = resp.read()
        except Exception:
            payload = b""
        finally:
            self._pool.release(conn, reusable=True)
        raise StorageError(
            f"{method} {path} -> {resp.status}: "
            f"{payload[:200].decode('utf-8', 'replace')}",
            transient=resp.status in _TRANSIENT,
            code=resp.status,
        )

    def _get_json(self, path: str, what: str) -> dict:
        """A metadata GET (stat, list page): over h2 under ``http2``,
        else over the HTTP/1.1 pool."""
        if self.transport.http2:
            return json.loads(self._meta_get_h2(path, what))
        conn, resp = self._checked("GET", path)
        try:
            return json.loads(resp.read())
        finally:
            self._pool.release(conn, reusable=True)

    def _opath(self, name: str) -> str:
        return (
            f"/storage/v1/b/{urllib.parse.quote(self.bucket, safe='')}"
            f"/o/{urllib.parse.quote(name, safe='')}"
        )

    # ----------------------------------------------------------------- h2 --
    def _h2_headers(self) -> str:
        return "".join(
            f"{k}: {v}\r\n" for k, v in self._headers().items()
            if k.lower() != "host"
        )

    def _meta_get_h2(self, path: str, what: str) -> bytes:
        """Metadata GET over the native HTTP/2 client (under ``http2`` the
        whole read path rides h2, stat and media alike). Returns the body;
        raises classified StorageError."""
        pool = self._h2_pool()
        engine = pool.engine
        headers = self._h2_headers()
        authority = f"{self._host}:{self._port}"
        # A big bucket's list JSON can run to megabytes: grow the buffer
        # once on TB_ETOOBIG rather than fail where h1.1 would succeed.
        for cap in (256 * 1024, 16 * 1024 * 1024):
            buf = pool.buffers.acquire(cap)

            def do_request(conn: int) -> dict:
                with self._tracer.span(
                    "gcs_http.meta_h2", path=path, bucket=self.bucket
                ) as sp:
                    engine.h2_submit_get(
                        conn, authority, path, buf, headers=headers
                    )
                    c = engine.h2_poll(conn)
                    if c is None:
                        raise NativeError("h2 stream vanished", code=-1001)
                    sp.event("first_byte", native_ns=c["first_byte_ns"])
                return c

            try:
                r = pool.run(do_request)
            except NativeError as e:
                pool.buffers.release(buf)
                raise StorageError(
                    f"h2 {what}: {e}", transient=e.code not in PERMANENT_CODES
                ) from e
            except BaseException:
                pool.buffers.release(buf)
                raise
            status = r["http_status"]
            if r["result"] == TB_ETOOBIG and cap == 256 * 1024:
                pool.buffers.release(buf)
                continue  # body outgrew the small buffer: one big retry
            if r["result"] < 0:
                pool.buffers.release(buf)
                raise StorageError(
                    f"h2 {what}: stream error {r['result']} (status {status})",
                    transient=r["result"] not in PERMANENT_CODES,
                )
            body = bytes(buf.view(r["result"]))
            pool.buffers.release(buf)
            if status != 200:
                raise StorageError(
                    f"h2 {what} -> {status}: "
                    f"{body[:200].decode('utf-8', 'replace')}",
                    transient=status in _TRANSIENT,
                    code=status,
                )
            return body
        raise StorageError(  # pragma: no cover — the loop returns or raises
            f"h2 {what}: body exceeded 16 MiB metadata buffer", transient=False
        )

    def _open_read_h2(self, name: str, start: int, length: Optional[int]):
        """Media GET over the native HTTP/2 client: DATA frames land in an
        aligned buffer sized from the range (or the object's size);
        ``:status`` arrives through HPACK. One stream at a time per
        connection, as the HTTP/1.1 path does, so an h1-vs-h2 A/B isolates
        the protocol."""
        pool = self._h2_pool()
        engine = pool.engine
        if length is None:
            with self._h2_pool_lock:
                size = self._h2_stat_cache.get(name)
            if size is None:
                size = self.stat(name).size
                with self._h2_pool_lock:
                    self._h2_stat_cache[name] = size
            want = size - start
        else:
            want = length
        _, _, req_path, headers = self.native_request_parts(name)
        if start or length is not None:
            end = "" if length is None else str(start + want - 1)
            headers += f"Range: bytes={start}-{end}\r\n"
        authority = f"{self._host}:{self._port}"
        buf = pool.buffers.acquire(max(4096, want))

        def do_request(conn: int) -> dict:
            with self._tracer.span(
                "gcs_http.get_h2", object=name, bucket=self.bucket
            ) as sp:
                engine.h2_submit_get(
                    conn, authority, req_path, buf, headers=headers
                )
                flight_note("stream_open")
                c = engine.h2_poll(conn)
                if c is None:
                    raise NativeError("h2 stream vanished", code=-1001)
                sp.event("first_byte", native_ns=c["first_byte_ns"])
            return c

        try:
            r = pool.run(do_request)
        except NativeError as e:
            pool.buffers.release(buf)
            with self._h2_pool_lock:
                self._h2_stat_cache.pop(name, None)
            raise StorageError(
                f"h2 GET {name}: {e}", transient=e.code not in PERMANENT_CODES,
            ) from e
        except BaseException:
            pool.buffers.release(buf)  # includes a classified connect failure
            raise
        status = r["http_status"]
        if r["result"] < 0:
            # Per-stream failure (the connection survived). Body exceeds
            # buffer when the buffer was sized from the stat cache: the
            # object may have grown, so one retry re-stats.
            pool.buffers.release(buf)
            with self._h2_pool_lock:
                self._h2_stat_cache.pop(name, None)
            transient = r["result"] not in PERMANENT_CODES
            if r["result"] == TB_ETOOBIG and length is None:
                transient = True
            raise StorageError(
                f"h2 GET {name}: stream error {r['result']} (status {status})",
                transient=transient,
            )
        if status not in (200, 206):
            msg = bytes(buf.view(min(r["result"], 200))).decode("utf-8", "replace")
            pool.buffers.release(buf)
            raise StorageError(
                f"h2 GET {name}: HTTP {status}: {msg}",
                transient=status in _TRANSIENT,
                code=status,
            )
        if (start > 0 and status == 200) or (
            length is not None and r["result"] > want
        ):
            # The server ignored the Range: the bytes would be misaligned.
            pool.buffers.release(buf)
            raise StorageError(
                f"h2 GET {name}: server ignored Range "
                f"(status {status}, got {r['result']}, asked {want})",
                transient=False,
            )
        return _NativeBufReader(
            buf, r["result"], r["first_byte_ns"], release=pool.buffers.release
        )

    # ------------------------------------------------------------ backend --
    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        if self.transport.http2:
            return self._open_read_h2(name, start, length)
        if self.transport.native_receive:
            return self._open_read_native(name, start, length)
        headers = {}
        if start or length is not None:
            end = "" if length is None else str(start + length - 1)
            headers["Range"] = f"bytes={start}-{end}"
        # Request span over request→body-complete: the reader ends it at
        # close(). Everything up to the reader's construction stays inside
        # the guard, so a failed open never leaks an entered span.
        carrier = SpanCarrier(
            self._tracer, "gcs_http.get", object=name, bucket=self.bucket
        )
        try:
            conn, resp = self._checked(
                "GET", self._opath(name) + "?alt=media", headers=headers
            )
            flight_note("stream_open")
            carrier.event("response_headers", status=resp.status)
            clen = int(resp.headers.get("Content-Length", "0"))
            gen_hdr = resp.headers.get("x-goog-generation")
            return _HttpReader(
                self._pool, conn, resp, clen, carrier=carrier,
                generation=int(gen_hdr) if gen_hdr else None,
            )
        except BaseException as e:
            carrier.close(e)
            raise

    def _open_read_native(self, name: str, start: int, length: Optional[int]):
        """The C++ receive path (``transport.native_receive``): the engine
        sends the GET and parses the headers (``tb_conn_get_begin``); the
        body then streams from the socket directly into the memory the
        caller's ``readinto`` offers. Pooled keep-alive connections;
        https rides the engine's TLS layer."""
        pool = self._native_pool()  # raises when TLS is unavailable
        engine = pool.engine
        _, _, req_path, headers = self.native_request_parts(name)
        if length is not None:
            headers += f"Range: bytes={start}-{start + length - 1}\r\n"
        elif start:
            headers += f"Range: bytes={start}-\r\n"
        # A stale pooled socket fails at begin() on first use: retransmit
        # the idempotent GET once on a fresh socket, so pool staleness
        # never surfaces as a request failure. Permanent protocol-shape
        # codes never burn the retransmit (they reproduce).
        conn, reused = pool.acquire()
        carrier = SpanCarrier(
            self._tracer, "gcs_http.get_native", object=name, bucket=self.bucket
        )
        # stream_open BEFORE begin(): begin() reads the response headers
        # and stamps the native first byte, and phases must stay ordered.
        flight_note("stream_open")
        while True:
            try:
                r = engine.conn_get_begin(
                    conn, self._host, self._port, req_path, headers=headers
                )
                break
            except NativeError as e:
                pool.discard(conn)
                if reused and e.code not in PERMANENT_CODES:
                    reused = False
                    pool.note_stale_retry()  # also flight-annotates
                    carrier.event("stale_retry")
                    try:
                        conn = pool.fresh()
                    except BaseException as e2:
                        carrier.close(e2)
                        raise
                    continue
                err = StorageError(
                    f"native GET {name}: {e}",
                    transient=e.code not in PERMANENT_CODES,
                )
                carrier.close(err)
                raise err from e
            except BaseException as e:
                pool.discard(conn)
                carrier.close(e)
                raise
        carrier.event("response_headers", status=r["status"])
        if r["first_byte_ns"]:
            carrier.event("first_byte", native_ns=r["first_byte_ns"])
        range_ignored = r["status"] in (200, 206) and (
            # Too many bytes announced for a bounded range, or a range
            # from a nonzero start answered with 200 (the body starts at
            # offset 0: serving it would hand back the wrong bytes).
            (length is not None and r["content_len"] > length)
            or (start > 0 and r["status"] == 200)
        )
        if range_ignored:
            pool.discard(conn)
            err = StorageError(
                f"GET {name}: server ignored Range "
                f"(status {r['status']}, announced {r['content_len']}, "
                f"requested start={start} length={length})",
                transient=False,
            )
            carrier.close(err)
            raise err
        if r["status"] not in (200, 206):
            # Error payload: read its head, drain the rest only when it is
            # small and bounded; otherwise discarding the connection is
            # cheaper than stalling the worker.
            msg = bytearray(4096)
            n = 0
            try:
                n = engine.conn_body_read(conn, msg, len(msg))
                clen = r["content_len"]
                if 0 <= clen <= _NativeStreamReader._DRAIN_CAP:
                    sink = _drain_scratch()
                    while engine.conn_body_read(conn, sink, len(sink)) > 0:
                        pass
                    pool.release(conn, engine.conn_get_end(conn))
                else:
                    pool.discard(conn)
            except Exception:
                pool.discard(conn)
            err = StorageError(
                f"GET {name}: HTTP {r['status']}: "
                f"{msg[:n].decode('utf-8', 'replace')[:200]}",
                transient=r["status"] in _TRANSIENT,
                code=r["status"],
            )
            carrier.close(err)
            raise err
        return _NativeStreamReader(
            pool, conn, r["content_len"], r["first_byte_ns"], carrier=carrier
        )

    def read_ranges(self, name: str, ranges, buffers) -> list:
        """Concurrent ranged GETs multiplexed on ONE native h2 connection
        (up to 32 streams; the h2 twin of ``GcsGrpcBackend.read_ranges``):
        range *i* (``(start, length)``) lands in ``buffers[i]``; returns
        per-range ``None`` or a classified :class:`StorageError`. A stream
        failure touches only its range; a connection failure classifies
        onto every unfinished range; the batch is sent once more on a
        fresh connection when the first use of a pooled connection fails
        before any completion. Requires ``transport.http2`` (the
        reference's whole-client h2 branch, main.go:76-80)."""
        from tpubench_torch.storage.native_pool import (
            fail_unfinished,
            range_addresses,
            run_multiplexed_batch,
        )

        if not self.transport.http2:
            raise ValueError("read_ranges requires transport.http2")
        n = len(ranges)
        done: list[bool] = [False] * n
        errs: list = [None] * n
        addrs = range_addresses(ranges, buffers, done)
        if all(done):
            return errs

        def classify(i: int, c: dict):
            start, length = ranges[i]
            status = c["http_status"]
            if c["result"] < 0:
                return StorageError(
                    f"h2 GET {name} range {i}: stream error {c['result']} "
                    f"(status {status})",
                    transient=c["result"] not in PERMANENT_CODES,
                )
            if status not in (200, 206):
                return StorageError(
                    f"h2 GET {name} range {i}: HTTP {status}",
                    transient=status in _TRANSIENT,
                    code=status,
                )
            if status == 200 and start > 0:
                # Server ignored the Range: bytes would be misaligned.
                return StorageError(
                    f"h2 GET {name} range {i}: server ignored Range",
                    transient=False,
                )
            if c["result"] != length:
                # A short delivery ending at the object's size reproduces
                # on every retry: permanent. Stat on a cache miss.
                with self._h2_pool_lock:
                    size = self._h2_stat_cache.get(name)
                if size is None:
                    try:
                        size = self.stat(name).size
                        with self._h2_pool_lock:
                            self._h2_stat_cache[name] = size
                    except StorageError:
                        size = None
                at_eof = size is not None and start + c["result"] >= size
                return StorageError(
                    f"h2 GET {name} range {i}: short stream "
                    f"({c['result']} of {length} bytes)"
                    + (" at EOF" if at_eof else ""),
                    transient=not at_eof,
                )
            return None

        try:
            pool = self._h2_pool()
            engine = pool.engine
            _, _, req_path, base_headers = self.native_request_parts(name)
            authority = f"{self._host}:{self._port}"
        except StorageError as e:
            return fail_unfinished(done, errs, e)

        def submit(conn: int, i: int) -> None:
            start, length = ranges[i]
            hdrs = (base_headers
                    + f"Range: bytes={start}-{start + length - 1}\r\n")
            engine.h2_submit_get_to(
                conn, authority, req_path, addrs[i], length,
                headers=hdrs, tag=i,
            )

        with self._tracer.span(
            "gcs_http.read_ranges_h2", object=name, bucket=self.bucket,
            ranges=n,
        ):
            return run_multiplexed_batch(
                pool, n, done, errs, submit, classify, name
            )

    def write(self, name: str, data: bytes,
              if_generation_match: Optional[int] = None) -> ObjectMeta:
        with self._h2_pool_lock:
            self._h2_stat_cache.pop(name, None)  # size changes on write
        path = (
            f"/upload/storage/v1/b/{urllib.parse.quote(self.bucket, safe='')}/o"
            f"?uploadType=media&name={urllib.parse.quote(name, safe='')}"
        )
        if if_generation_match is not None:
            path += f"&ifGenerationMatch={if_generation_match}"
        conn, resp = self._checked(
            "POST",
            path,
            headers={"Content-Type": "application/octet-stream"},
            body=_body(data),
        )
        try:
            meta = json.loads(resp.read())
        finally:
            self._pool.release(conn, reusable=True)
        return ObjectMeta(
            meta["name"], int(meta["size"]), int(meta.get("generation", 0))
        )

    def open_write(self, name: str,
                   if_generation_match: Optional[int] = None):
        """Resumable multi-part upload session (the GCS
        ``uploadType=resumable`` protocol): POST opens the session, each
        part PUTs with ``Content-Range: bytes a-b/*`` and a 308-with-
        ``Range`` acknowledgement, ``finalize`` PUTs the ``bytes */total``
        completion form. Part-level retry/resume is NOT here — the
        uniform equivalent is :class:`RetryingBackend.open_write`'s
        resuming wrapper (the read path's resume discipline, mirrored)."""
        return _ResumableHttpWriter(self, name, if_generation_match)

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]:
        """Full listing under ``prefix``, following ``nextPageToken``;
        ``page_size`` > 0 rides as ``maxResults``."""
        base = (
            f"/storage/v1/b/{urllib.parse.quote(self.bucket, safe='')}/o"
            f"?prefix={urllib.parse.quote(prefix, safe='')}"
        )
        if page_size > 0:
            base += f"&maxResults={page_size}"
        out: list[ObjectMeta] = []
        token = ""
        while True:
            path = base
            if token:
                path += f"&pageToken={urllib.parse.quote(token, safe='')}"
            payload = self._get_json(path, f"LIST {prefix!r}")
            out.extend(
                ObjectMeta(it["name"], int(it["size"]), int(it.get("generation", 0)))
                for it in payload.get("items", [])
            )
            token = payload.get("nextPageToken", "")
            if not token:
                return out

    def stat(self, name: str) -> ObjectMeta:
        meta = self._get_json(self._opath(name), f"STAT {name}")
        return ObjectMeta(
            meta["name"], int(meta["size"]), int(meta.get("generation", 0))
        )

    def delete(self, name: str) -> None:
        with self._h2_pool_lock:
            self._h2_stat_cache.pop(name, None)
        conn, resp = self._checked("DELETE", self._opath(name), ok=(200, 204))
        try:
            resp.read()
        finally:
            self._pool.release(conn, reusable=True)

    def close(self) -> None:
        self._pool.close()
        if self._native_pool_obj is not None:
            self._native_pool_obj.close()  # also drains its BufferPool
        if self._h2_pool_obj is not None:
            self._h2_pool_obj.close()
