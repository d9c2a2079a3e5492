"""GCS gRPC (storage v2) backend: ``tpubench/storage/gcs_grpc.py``
(reference ``CreateGrpcClient``, main.go:106-117), in two modes behind
one surface, chosen as ``tpubench`` chooses (``_HAVE_LIB``).

* **Library mode**, whenever ``grpcio`` imports, and always for an
  explicit ``channel=``: grpcio channels over a bare stub per method (no
  GAPIC client, so the hot loop has no client-library layer in it). The
  messages are encoded and decoded by the wire stack's own storage-v2
  codec (:mod:`tpubench_torch.storage.grpc_wire.proto`), so library mode
  needs grpcio and nothing else. ``grpc`` is imported only when a backend
  is built.
* **Wire mode**, only where grpcio does not import: the dependency-free
  stack of :mod:`tpubench_torch.storage.grpc_wire` (that codec and gRPC
  framing over raw h2 frames). It serves test servers only: Google's
  endpoint without grpcio, like an explicit channel without it, raises a
  non-transient :class:`StorageError` naming grpcio before any socket
  opens, as ``tpubench``'s wire mode refuses ``googleapis.com``.

* **DirectPath** (library mode, default endpoint): the ``google-c2p``
  resolver with compute-engine channel credentials, the grpcio
  equivalent of the Go client's rls/xds imports (main.go:24-26); the
  env-var gate is set only around channel creation (main.go:107-113).
  On any other endpoint the knob warns and does nothing.
* **Connection pool**: ``grpc_conn_pool_size`` channels (main.go:30,111),
  round-robin. An injected channel is the only one, and not closed here.
* **Auth**: library mode's call credentials and the native client's
  ``authorization`` metadata come from one token source
  (:mod:`tpubench_torch.storage.auth`: a key file or ADC on Google's
  endpoint, none for a test server). ``tpubench``'s library mode uses
  ADC alone and ignores ``key_file``.
* **2 MiB chunking**: the server streams ``ReadObjectResponse`` messages of
  at most 2 MiB (why the reference sized its copy buffer at 2 MB,
  main.go:123-125); both readers hand each message's bytes out through
  ``readinto`` without buffering whole objects, and stamp the first byte
  before protobuf decode.
* **Native receive** (``transport.native_receive``, either mode): the
  engine's h2 gRPC client runs ReadObject and lands the content in an
  aligned buffer, with a native first-byte stamp; pooled engine
  connections. ``read_ranges`` runs many ReadObject streams at once on
  one of them (the pod workloads' multiplexed shard fetch).

Writes: ``write`` is one client-streaming WriteObject, ``open_write`` the
resumable session (StartResumableWrite → BidiWriteObject with lockstep
persisted-size acks → QueryWriteStatus re-probe → idempotent finalize),
``delete`` the unary DeleteObject. ``list`` follows ``next_page_token``
in both modes (``tpubench`` reads one page).
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
import warnings
from typing import Optional

from tpubench_torch.config import TransportConfig
from tpubench_torch.storage.auth import make_token_source
from tpubench_torch.native.engine import (
    PERMANENT_CODES,
    TB_EGRPC,
    TB_ETOOBIG,
    NativeError,
)
from tpubench_torch.obs.flight import annotate
from tpubench_torch.obs.flight import note_phase as flight_note
from tpubench_torch.obs.tracing import NoopTracer, SpanCarrier
from tpubench_torch.storage.base import ObjectMeta, StorageError
from tpubench_torch.storage.gcs_http import _NativeBufReader
from tpubench_torch.storage.grpc_wire import proto as wp
from tpubench_torch.storage.grpc_wire.client import GrpcWireChannel

_SVC = "/google.storage.v2.Storage"
DEFAULT_ENDPOINT = "storage.googleapis.com:443"
_DIRECTPATH_ENDPOINTS = (DEFAULT_ENDPOINT, "storage.googleapis.com")

# gRPC server chunk ceiling (storage v2 MAX_READ_CHUNK_BYTES is 2 MiB).
MAX_READ_CHUNK = 2 * 1024 * 1024

# Library mode's status classification, by ``grpc.StatusCode`` name (so
# this module need not import grpc): DEADLINE_EXCEEDED,
# RESOURCE_EXHAUSTED, ABORTED, INTERNAL, UNAVAILABLE are transient
# (UNKNOWN is not). The HTTP-ish codes are the wire stack's
# (``grpc_wire.framing.STATUS_TO_HTTPISH``), so a precondition failure is
# a 412 in both modes; ``tpubench``'s library table stops at 404, 416 and
# 503. The native path reports the same codes as raw ints.
_TRANSIENT_CODES = frozenset({
    "UNAVAILABLE", "DEADLINE_EXCEEDED", "RESOURCE_EXHAUSTED", "ABORTED",
    "INTERNAL",
})
_HTTPISH_CODES = {"INVALID_ARGUMENT": 400, "NOT_FOUND": 404,
                  "FAILED_PRECONDITION": 412, "OUT_OF_RANGE": 416,
                  "UNAVAILABLE": 503}
_TRANSIENT_STATUS_INTS = {4, 8, 10, 13, 14}
_STATUS_HTTPISH = {5: 404, 11: 416, 14: 503}


# The mode switch. ``tpubench`` takes library mode whenever grpcio imports
# (its ``_HAVE_LIB``, ``tpubench/storage/gcs_grpc.py:46-54,240``), and so
# does the port. ``None``: whether ``import grpc`` succeeds, tried when a
# backend is built, so importing this module never loads grpc. ``False``
# pins wire mode, as on a machine without grpcio.
_HAVE_LIB: Optional[bool] = None

# Library mode's stubs: key -> (method, grpcio call shape, response
# message; ``None`` = the read deserializer). Requests are encoded by
# ``wp.Msg.encode``.
_METHODS = {
    "read": ("ReadObject", "unary_stream", None),
    "get": ("GetObject", "unary_unary", wp.Object),
    "list": ("ListObjects", "unary_unary", wp.ListObjectsResponse),
    "delete": ("DeleteObject", "unary_unary", wp.Msg),  # protobuf Empty
    "write": ("WriteObject", "stream_unary", wp.WriteObjectResponse),
    "start_resumable": ("StartResumableWrite", "unary_unary",
                        wp.StartResumableWriteResponse),
    "query_write": ("QueryWriteStatus", "unary_unary",
                    wp.QueryWriteStatusResponse),
    "bidi_write": ("BidiWriteObject", "stream_stream",
                   wp.BidiWriteObjectResponse),
}


def _import_grpc():
    """``(grpc, None)`` where library mode can run, else ``(None, the
    ImportError)``."""
    if _HAVE_LIB is False:
        return None, ImportError("wire mode pinned (gcs_grpc._HAVE_LIB)")
    try:
        import grpc
    except ImportError as e:
        return None, e
    return grpc, None


def _write_status(resp) -> int:
    """The size a write-status response reports: ``persisted_size`` and
    ``resource`` are a oneof, and a finalized session answers with the
    object, whose size is then the committed size (``tpubench``'s
    library writer reads 0 there: ROADMAP C.12)."""
    if resp.resource is not None:
        return resp.resource.size
    return resp.persisted_size or 0


def _wrap_rpc_error(e, what: str) -> StorageError:
    """A ``grpc.RpcError`` as a classified :class:`StorageError`."""
    code = e.code() if hasattr(e, "code") else None
    name = getattr(code, "name", "")
    return StorageError(
        f"{what}: {code} {e.details() if hasattr(e, 'details') else e}",
        transient=name in _TRANSIENT_CODES,
        code=_HTTPISH_CODES.get(name, 0),
    )


def _stamped_read_deserializer(b: bytes):
    """Arrival stamp taken on the raw message bytes before protobuf
    decode: the first-byte time must not include decoding 2 MiB."""
    arrival_ns = time.perf_counter_ns()
    return arrival_ns, wp.ReadObjectResponse.decode(b)


class _MessageReader:
    """Streams ReadObjectResponse messages, carrying a message's leftover
    bytes between ``readinto`` calls; ``_next`` gives (arrival stamp,
    message) or ``None`` at the end, the stamp taken on the raw bytes
    before protobuf decode. ``carrier`` (optional) is the request span:
    ``first_byte`` on the first message, ended at close, with the error
    when the stream failed."""

    def __init__(self, carrier=None):
        self._pending = memoryview(b"")
        self.first_byte_ns: Optional[int] = None
        self._done = False
        self._carrier = carrier

    def _next(self):
        raise NotImplementedError

    def readinto(self, buf: memoryview) -> int:
        if self._done and not self._pending:
            return 0
        while not self._pending:
            try:
                item = self._next()
            except StorageError as e:
                self._done = True
                if self._carrier is not None:
                    self._carrier.close(e)
                raise
            if item is None:
                self._done = True
                return 0
            arrival_ns, msg = item
            if self.first_byte_ns is None:
                self.first_byte_ns = arrival_ns
                if self._carrier is not None:
                    self._carrier.event("first_byte")
            cd = msg.checksummed_data  # None when the message has none
            if cd is not None and cd.content:
                self._pending = memoryview(cd.content)
        n = min(len(buf), len(self._pending))
        buf[:n] = self._pending[:n]
        self._pending = self._pending[n:]
        return n

    def close(self) -> None:
        self._done = True
        if self._carrier is not None:
            self._carrier.close()  # idempotent: a failure closed it already


class _GrpcReader(_MessageReader):
    """Library mode: the messages of a grpcio response iterator, decoded
    (and stamped) by ``_stamped_read_deserializer``."""

    def __init__(self, stream, rpc_error, carrier=None):
        super().__init__(carrier)
        self._stream = stream
        self._rpc_error = rpc_error

    def _next(self):
        try:
            return next(self._stream, None)
        except self._rpc_error as e:
            raise _wrap_rpc_error(e, "ReadObject stream") from e

    def close(self) -> None:
        try:
            self._stream.cancel()
        except Exception:
            pass
        super().close()


class _WireGrpcReader(_MessageReader):
    """Wire mode: the framed messages of a
    :class:`~tpubench_torch.storage.grpc_wire.client.WireCall`."""

    def __init__(self, call, carrier=None):
        super().__init__(carrier)
        self._call = call

    def _next(self):
        try:
            raw = self._call.recv_message()
        except StorageError:
            self._call.cancel()
            raise
        if raw is None:
            return None
        return time.perf_counter_ns(), wp.ReadObjectResponse.decode(raw)

    def close(self) -> None:
        if self._done:
            self._call.close()  # clean end: the connection can be reused
        else:
            self._call.cancel()  # abandoned mid-stream: RST + discard
        super().close()


class GcsGrpcBackend:
    def __init__(
        self,
        bucket: str,
        transport: Optional[TransportConfig] = None,
        channel=None,
        tracer=None,
    ):
        self.bucket = bucket
        self.transport = transport or TransportConfig()
        self._tracer = tracer or NoopTracer()
        t = self.transport
        endpoint = t.endpoint or DEFAULT_ENDPOINT
        n = max(1, t.grpc_conn_pool_size)
        # The token source is built on first use: an injected channel
        # carries its own credentials.
        self._tokens_obj = None
        self._tokens_lock = threading.Lock()
        grpc, err = _import_grpc()
        self._lib = grpc is not None
        if not self._lib and (channel is not None
                              or "googleapis.com" in endpoint):
            what = ("explicit grpc channel" if channel is not None
                    else f"gRPC to Google's endpoint {endpoint!r}")
            raise StorageError(
                f"{what} needs library mode, and grpcio does not import "
                f"({err}); wire mode serves test servers only",
                transient=False,
            ) from err
        if self._lib:
            self._grpc = grpc
            if channel is not None:
                self._channels = [channel]
                self._owns_channels = False
            else:
                self._channels = [self._make_channel() for _ in range(n)]
                self._owns_channels = True
            self._stubs = [self._make_stubs(ch) for ch in self._channels]
        else:
            if t.directpath:
                # DirectPath serves storage.googleapis.com only: say so
                # rather than ignore the knob silently.
                warnings.warn(
                    f"transport.directpath=True ignored for custom endpoint "
                    f"{endpoint!r}: DirectPath serves storage.googleapis.com "
                    "only",
                    stacklevel=2,
                )
            host, port, tls = self._native_endpoint()
            self._channels = [
                GrpcWireChannel(
                    host, port, tls=tls, cafile=t.tls_ca_file or None,
                    insecure_skip_verify=t.tls_insecure_skip_verify,
                )
                for _ in range(n)
            ]
            self._owns_channels = True
        self._rr = itertools.cycle(range(len(self._channels)))
        self._rr_lock = threading.Lock()
        # Native-receive pool (transport.native_receive): engine handles
        # carrying h2 connections, built on first use.
        self._native_pool_obj = None
        self._native_pool_lock = threading.Lock()
        self._stat_cache: dict[str, int] = {}
        self._stat_cache_lock = threading.Lock()

    @property
    def _native_tokens(self):
        """The token source of both auth paths (none for a test
        server's endpoint), built on first use."""
        with self._tokens_lock:
            if self._tokens_obj is None:
                t = self.transport
                self._tokens_obj = make_token_source(t.key_file, t.endpoint)
            return self._tokens_obj

    def _native_auth_headers(self) -> str:
        """Authorization metadata for the native h2 client, from the same
        token sources as the HTTP client (none for a test server)."""
        tok = self._native_tokens.token()
        return f"authorization: Bearer {tok}\r\n" if tok else ""

    # ------------------------------------------------ library channels --
    def _make_channel(self):
        grpc = self._grpc
        t = self.transport
        endpoint = t.endpoint or DEFAULT_ENDPOINT
        opts = [
            ("grpc.max_receive_message_length", 16 * 1024 * 1024),
            ("grpc.keepalive_time_ms", 30000),
        ]
        if t.directpath:
            if endpoint in _DIRECTPATH_ENDPOINTS:
                return self._make_directpath_channel(opts)
            warnings.warn(
                f"transport.directpath=True ignored for custom endpoint "
                f"{endpoint!r}: DirectPath serves storage.googleapis.com only",
                stacklevel=3,
            )
        if endpoint.startswith("insecure://"):
            return grpc.insecure_channel(endpoint[len("insecure://"):], opts)
        root = None
        if t.tls_ca_file:
            # A private CA, the knob of the HTTP pool and the native client.
            with open(t.tls_ca_file, "rb") as f:
                root = f.read()
        creds = grpc.ssl_channel_credentials(root_certificates=root)
        if "googleapis.com" in endpoint:
            creds = grpc.composite_channel_credentials(
                creds, self._call_credentials()
            )
        return grpc.secure_channel(endpoint, creds, opts)

    def _auth_plugin(self):
        """A ``grpc.AuthMetadataPlugin`` that puts the token source's
        bearer token on every call (nothing when it has none)."""
        tokens = self._native_tokens

        class _BearerPlugin(self._grpc.AuthMetadataPlugin):
            def __call__(self, context, callback):
                try:
                    tok = tokens.token()
                except Exception as e:  # noqa: BLE001 — fails the call
                    callback((), e)
                    return
                callback(
                    (("authorization", f"Bearer {tok}"),) if tok else (),
                    None,
                )

        return _BearerPlugin()

    def _call_credentials(self):
        return self._grpc.metadata_call_credentials(
            self._auth_plugin(), name="tpubench_torch.auth"
        )

    def _make_directpath_channel(self, opts: list):
        """DirectPath from grpcio: the ``google-c2p`` resolver picks
        DirectPath backends over the VPC fabric when the VM is eligible and
        the public path otherwise (``main.go:24-26,107-113``). Needs
        grpc-core built with xds (the standard wheels are)."""
        grpc = self._grpc
        saved = os.environ.get("GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS")
        os.environ["GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS"] = "true"
        try:
            creds = grpc.compute_engine_channel_credentials(
                self._call_credentials()
            )
            return grpc.secure_channel(
                "google-c2p:///storage.googleapis.com", creds, opts
            )
        finally:
            if saved is None:
                os.environ.pop("GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS", None)
            else:
                os.environ["GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS"] = saved

    def _make_stubs(self, ch) -> dict:
        return {
            key: getattr(ch, shape)(
                f"{_SVC}/{method}",
                request_serializer=wp.Msg.encode,
                response_deserializer=(
                    _stamped_read_deserializer if resp is None else resp.decode
                ),
            )
            for key, (method, shape, resp) in _METHODS.items()
        }

    def _stub(self) -> dict:
        with self._rr_lock:
            return self._stubs[next(self._rr)]

    @property
    def _bucket_path(self) -> str:
        return f"projects/_/buckets/{self.bucket}"

    def _native_endpoint(self) -> tuple[str, int, bool]:
        """(host, port, tls): ``insecure://`` is plaintext h2c with prior
        knowledge; anything else handshakes TLS."""
        ep = self.transport.endpoint or DEFAULT_ENDPOINT
        tls = True
        if ep.startswith("insecure://"):
            ep = ep[len("insecure://"):]
            tls = False
        host, _, port = ep.partition(":")
        return host, int(port or 443), tls

    def _wire_chan(self) -> GrpcWireChannel:
        with self._rr_lock:
            return self._channels[next(self._rr)]

    def _unary(self, key: str, req: "wp.Msg", what: str):
        """One unary RPC in either mode, its response decoded; failures
        arrive as classified :class:`StorageError` s."""
        method, _, resp = _METHODS[key]
        if not self._lib:
            return resp.decode(
                self._wire_chan().unary(f"{_SVC}/{method}", req.encode())
            )
        try:
            return self._stub()[key](req)
        except self._grpc.RpcError as e:
            raise _wrap_rpc_error(e, what) from e

    # ------------------------------------------------------- native pool --
    def _native_pool(self):
        with self._native_pool_lock:
            if self._native_pool_obj is None:
                from tpubench_torch.storage.native_pool import build_native_pool

                t = self.transport
                if t.directpath and (
                    t.endpoint or DEFAULT_ENDPOINT
                ) in _DIRECTPATH_ENDPOINTS:
                    # The native h2 client dials the endpoint itself; the
                    # google-c2p resolver never runs.
                    warnings.warn(
                        "native_receive bypasses DirectPath: the native h2 "
                        "client connects straight to the endpoint (public "
                        "path); transport.directpath does not apply",
                        stacklevel=3,
                    )
                host, port, tls = self._native_endpoint()
                self._native_pool_obj = build_native_pool(
                    self.transport, host, port, tls=tls, alpn_h2=tls
                )
        return self._native_pool_obj

    @property
    def native_conn_stats(self) -> dict:
        return self._native_pool().stats

    def _open_read_native(self, name: str, start: int, length: Optional[int]):
        """Native gRPC receive: the engine's h2 client runs ReadObject and
        lands the content in a pooled aligned buffer with a native
        first-byte stamp (h2 streams 1, 3, 5, ... per pooled connection;
        one stale-use retry)."""
        pool = self._native_pool()
        engine = pool.engine
        host, port, _ = self._native_endpoint()
        if length is None:
            with self._stat_cache_lock:
                size = self._stat_cache.get(name)
            if size is None:
                size = self.stat(name).size
            want = size - start
        else:
            want = length
        buf = pool.buffers.acquire(max(4096, want))

        def do_request(conn: int) -> dict:
            with self._tracer.span(
                "gcs_grpc.read_native", object=name, bucket=self.bucket
            ) as sp:
                flight_note("stream_open")
                r = engine.grpc_read(
                    conn, f"{host}:{port}", self._bucket_path, name, buf,
                    headers=self._native_auth_headers(),
                    read_offset=start, read_limit=length or 0,
                )
                sp.event("first_byte", native_ns=r["first_byte_ns"])
            return r

        try:
            # An explicit grpc-status is a server answer, not pool
            # staleness: never burn the stale retry on it, nor on the
            # permanent protocol-shape codes.
            r = pool.run(
                do_request,
                retry_stale=lambda e: (
                    e.code not in PERMANENT_CODES
                    and getattr(e, "grpc_status", -1) < 0
                ),
            )
        except NativeError as e:
            pool.buffers.release(buf)
            with self._stat_cache_lock:
                self._stat_cache.pop(name, None)
            st = getattr(e, "grpc_status", -1)
            if e.code == TB_EGRPC and st >= 0:
                raise StorageError(
                    f"native ReadObject {name}: grpc-status {st}",
                    transient=st in _TRANSIENT_STATUS_INTS,
                    code=_STATUS_HTTPISH.get(st, 0),
                ) from e
            transient = e.code not in PERMANENT_CODES
            if e.code == TB_ETOOBIG and length is None:
                # The buffer was sized from the (just dropped) stat cache;
                # the object may have grown: one retry re-stats.
                transient = True
            raise StorageError(
                f"native ReadObject {name}: {e}", transient=transient
            ) from e
        except BaseException:
            pool.buffers.release(buf)  # includes a classified connect failure
            raise
        # A short stream with no contradicting grpc-status must never pass
        # as a short success. Full reads compare against the object size;
        # ranged reads only when a cached stat bounds the range.
        expected = want
        if length is not None:
            with self._stat_cache_lock:
                size = self._stat_cache.get(name)
            expected = min(want, max(0, size - start)) if size is not None else 0
        if r["grpc_status"] != 0 and r["length"] < expected:
            pool.buffers.release(buf)
            with self._stat_cache_lock:
                self._stat_cache.pop(name, None)
            raise StorageError(
                f"native ReadObject {name}: short stream "
                f"({r['length']} of {expected} bytes)", transient=True
            )
        return _NativeBufReader(
            buf, r["length"], r["first_byte_ns"], release=pool.buffers.release,
        )

    # ----------------------------------------------------------- backend --
    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        if self.transport.native_receive:
            return self._open_read_native(name, start, length)
        req = wp.ReadObjectRequest(
            bucket=self._bucket_path, object=name,
            read_offset=start, read_limit=length or 0,
        )
        carrier = SpanCarrier(
            self._tracer, "gcs_grpc.read_object",
            object=name, bucket=self.bucket,
        )
        try:
            if self._lib:
                reader = _GrpcReader(
                    self._stub()["read"](req), self._grpc.RpcError,
                    carrier=carrier,
                )
            else:
                reader = _WireGrpcReader(
                    self._wire_chan().server_stream(
                        f"{_SVC}/ReadObject", req.encode()
                    ),
                    carrier=carrier,
                )
            flight_note("stream_open")
            return reader
        except BaseException as e:
            carrier.close(e)
            if self._lib and isinstance(e, self._grpc.RpcError):
                raise _wrap_rpc_error(e, f"ReadObject {name}") from e
            raise

    def read_ranges(self, name: str, ranges, buffers) -> list:
        """Concurrent ReadObject streams on ONE native connection
        (grpc-go's default multiplexing, go.mod:20), for shard fetches:
        range *i* (``(start, length)``) lands in ``buffers[i]`` (any
        writable contiguous byte buffer). Returns per range ``None``
        (exactly ``length`` bytes landed) or a classified
        :class:`StorageError`: a stream failure (NOT_FOUND, short stream)
        touches only its range, a connection failure every unfinished
        range. The batch is sent once more on a fresh connection when the
        first use of a pooled connection fails before any completion.
        Requires ``transport.native_receive``."""
        from tpubench_torch.storage.native_pool import (
            fail_unfinished,
            range_addresses,
            run_multiplexed_batch,
        )

        n = len(ranges)
        done: list[bool] = [False] * n
        errs: list = [None] * n
        addrs = range_addresses(ranges, buffers, done)
        if all(done):
            return errs

        def classify(i: int, c: dict):
            start, length = ranges[i]
            if c["result"] < 0:
                st = c["grpc_status"]
                if st > 0:
                    return StorageError(
                        f"ReadObject {name} range {i}: grpc-status {st}",
                        transient=st in _TRANSIENT_STATUS_INTS,
                        code=_STATUS_HTTPISH.get(st, 0),
                    )
                return StorageError(
                    f"ReadObject {name} range {i}: stream error {c['result']}",
                    transient=c["result"] not in PERMANENT_CODES,
                )
            if c["result"] != length:
                # The bounded range must arrive whole. A short stream that
                # ends at the object's size (the server clamped a range
                # past EOF) reproduces on every retry: permanent, a hole
                # now. Anything else (mid-object truncation) is transient.
                # A bare caller has primed no stat: one stat decides.
                with self._stat_cache_lock:
                    size = self._stat_cache.get(name)
                if size is None:
                    try:
                        size = self.stat(name).size
                    except StorageError:
                        size = None  # can't classify: stay transient
                at_eof = size is not None and start + c["result"] >= size
                return StorageError(
                    f"ReadObject {name} range {i}: short stream "
                    f"({c['result']} of {length} bytes)"
                    + (" at EOF" if at_eof else ""),
                    transient=not at_eof,
                )
            return None

        try:
            pool = self._native_pool()
            engine = pool.engine
            host, port, _ = self._native_endpoint()
            authority = f"{host}:{port}"
        except StorageError as e:
            return fail_unfinished(done, errs, e)

        metadata = self._native_auth_headers()

        def submit(conn: int, i: int) -> None:
            start, length = ranges[i]
            engine.grpc_submit_to(
                conn, authority, self._bucket_path, name, addrs[i], length,
                headers=metadata, read_offset=start, read_limit=length, tag=i,
            )

        with self._tracer.span(
            "gcs_grpc.read_ranges", object=name, bucket=self.bucket,
            ranges=n,
        ):
            return run_multiplexed_batch(
                pool, n, done, errs, submit, classify, name,
                # An explicit grpc-status proves the server answered:
                # never retried as pool staleness.
                answered=lambda e: getattr(e, "grpc_status", -1) >= 0,
            )

    def _write_spec(self, name: str, if_generation_match) -> "wp.WriteObjectSpec":
        return wp.WriteObjectSpec(
            resource=wp.Object(name=name, bucket=self._bucket_path),
            if_generation_match=(
                int(if_generation_match)
                if if_generation_match is not None
                else None
            ),
        )

    def _write_requests(self, name: str, data, if_generation_match):
        """WriteObject's messages: the spec on the first, the content in
        chunks of at most 2 MiB with their crc32c, ``finish_write`` on
        the last."""
        spec = self._write_spec(name, if_generation_match)
        mv = memoryview(data)
        if not len(mv):
            yield wp.WriteObjectRequest(write_object_spec=spec, finish_write=True)
            return
        for off in range(0, len(mv), MAX_READ_CHUNK):
            content = bytes(mv[off : off + MAX_READ_CHUNK])
            yield wp.WriteObjectRequest(
                write_object_spec=spec if off == 0 else None,
                write_offset=off,
                checksummed_data=wp.ChecksummedData(
                    content=content, crc32c=wp.crc32c_of(content),
                ),
                finish_write=off + len(content) >= len(mv),
            )

    def _wire_write(self, name: str, requests) -> "wp.WriteObjectResponse":
        """One-shot WriteObject as a client-streaming wire call."""
        call = self._wire_chan().bidi(f"{_SVC}/WriteObject")
        try:
            for req in requests:
                call.send_message(req.encode(), end=req.finish_write)
            raw = call.recv_message()
            if raw is None:
                raise StorageError(
                    f"WriteObject {name}: no response message", transient=True
                )
            resp = wp.WriteObjectResponse.decode(raw)
            while call.recv_message() is not None:
                pass
        except BaseException:
            call.cancel()
            raise
        finally:
            call.close()
        return resp

    def write(self, name: str, data: bytes,
              if_generation_match=None) -> ObjectMeta:
        requests = self._write_requests(name, data, if_generation_match)
        if not self._lib:
            resp = self._wire_write(name, requests)
        else:
            try:
                resp = self._stub()["write"](requests)
            except self._grpc.RpcError as e:
                raise _wrap_rpc_error(e, f"WriteObject {name}") from e
        # Keep the size cache coherent: a stale (smaller) size would let
        # the short-stream classifier call a truncation "at EOF".
        size = _write_status(resp)
        with self._stat_cache_lock:
            self._stat_cache[name] = size
        res = resp.resource
        return ObjectMeta(res.name if res is not None else name, size)

    def open_write(self, name: str, if_generation_match=None):
        """Resumable session: StartResumableWrite → BidiWriteObject
        chunks with lockstep persisted-size acks → QueryWriteStatus
        re-probe on break → idempotent finalize (412 non-transient).
        The RetryingBackend wraps this in ``_ResumingWriter``, which
        drives the re-probe + tail-resend choreography."""
        if self._lib:
            return _LibBidiWriter(self, name, if_generation_match)
        return _WireBidiWriter(self, name, if_generation_match)

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]:
        """Full listing under ``prefix``, following ``next_page_token``
        as the HTTP client follows ``nextPageToken``, in both modes;
        ``page_size`` > 0 bounds each page, not the listing.
        (``tpubench``'s clients read the first page only: ROADMAP C.7.)"""
        out: list[ObjectMeta] = []
        token = ""
        while True:
            resp = self._unary("list", wp.ListObjectsRequest(
                parent=self._bucket_path, prefix=prefix,
                page_size=max(0, page_size), page_token=token,
            ), "ListObjects")
            out.extend(
                ObjectMeta(o.name, o.size, o.generation) for o in resp.objects
            )
            token = resp.next_page_token
            if not token:
                return out

    def stat(self, name: str) -> ObjectMeta:
        o = self._unary("get", wp.GetObjectRequest(
            bucket=self._bucket_path, object=name,
        ), f"GetObject {name}")
        meta = ObjectMeta(o.name, o.size, o.generation)
        # Feeds the size cache the native reader sizes its buffer from.
        with self._stat_cache_lock:
            self._stat_cache[name] = meta.size
        return meta

    def delete(self, name: str) -> None:
        self._unary("delete", wp.DeleteObjectRequest(
            bucket=self._bucket_path, object=name,
        ), f"DeleteObject {name}")
        with self._stat_cache_lock:
            self._stat_cache.pop(name, None)

    def close(self) -> None:
        if self._owns_channels:
            for ch in self._channels:
                ch.close()
        if self._native_pool_obj is not None:
            self._native_pool_obj.close()  # also drains its BufferPool


class _BidiWriter:
    """Resumable gRPC write (the ObjectWriter contract), in either mode.

    StartResumableWrite issues the session; each ``write`` chunk rides
    a BidiWriteObject message with ``flush`` + ``state_lookup`` set and
    waits for the persisted-size ack in lockstep — ``offset`` is always
    the server's committed watermark, never an optimistic local count.
    A transient break tears the stream down and re-raises; the
    ``_ResumingWriter`` above re-probes ``committed()`` (QueryWriteStatus)
    and resends the tail on a fresh stream (first message re-carries the
    upload id). ``finalize`` sends ``finish_write`` and half-closes; a
    412 precondition verdict arrives non-transient. A subclass opens the
    mode's stream (``_open_stream``)."""

    def __init__(self, backend: GcsGrpcBackend, name: str,
                 if_generation_match=None):
        self._b = backend
        self.name = name
        resp = backend._unary(
            "start_resumable",
            wp.StartResumableWriteRequest(
                write_object_spec=backend._write_spec(name, if_generation_match)
            ),
            f"StartResumableWrite {name}",
        )
        self._uid = resp.upload_id
        self.offset = 0
        self._stream = None
        self._final: Optional[ObjectMeta] = None

    def _open_stream(self):
        raise NotImplementedError

    # ----------------------------------------------------------- stream --
    def _send(self, msg: "wp.BidiWriteObjectRequest", end: bool = False):
        if self._stream is None:
            self._stream = self._open_stream()
            # The upload id rides only the FIRST message of each stream
            # (the storage-v2 first_message contract).
            msg.upload_id = self._uid
        self._stream.send(msg, end)
        return self._stream

    def _break_stream(self) -> None:
        stream, self._stream = self._stream, None
        if stream is not None:
            stream.cancel()

    # --------------------------------------------------------- contract --
    def write(self, data) -> int:
        mv = memoryview(data)
        what = f"BidiWriteObject {self.name}"
        try:
            for off in range(0, len(mv), MAX_READ_CHUNK):
                content = bytes(mv[off : off + MAX_READ_CHUNK])
                ack = self._send(
                    wp.BidiWriteObjectRequest(
                        write_offset=self.offset,
                        checksummed_data=wp.ChecksummedData(
                            content=content, crc32c=wp.crc32c_of(content)
                        ),
                        flush=True,
                        state_lookup=True,
                    )
                ).recv(what)
                if ack is None:
                    raise StorageError(
                        f"{what}: stream closed before persisted-size ack",
                        transient=True,
                    )
                self.offset = _write_status(ack)
                annotate("bidi_ack", persisted=self.offset, object=self.name)
        except StorageError:
            self._break_stream()
            raise
        return self.offset

    def committed(self) -> int:
        self.offset = _write_status(self._b._unary(
            "query_write", wp.QueryWriteStatusRequest(upload_id=self._uid),
            f"QueryWriteStatus {self.name}",
        ))
        return self.offset

    def finalize(self) -> ObjectMeta:
        if self._final is not None:
            return self._final
        what = f"BidiWriteObject {self.name} finalize"
        try:
            stream = self._send(
                wp.BidiWriteObjectRequest(
                    write_offset=self.offset, finish_write=True
                ),
                end=True,
            )
            resp = stream.recv(what)
            if resp is None:
                raise StorageError(f"{what}: no response", transient=True)
            stream.drain(what)
            self._stream = None
        except StorageError:
            self._break_stream()
            raise
        res = resp.resource
        if res is not None:
            meta = ObjectMeta(res.name or self.name, res.size, res.generation)
        else:
            meta = ObjectMeta(self.name, resp.persisted_size or 0)
        with self._b._stat_cache_lock:
            self._b._stat_cache[meta.name] = meta.size
        self._final = meta
        return meta

    def abort(self) -> None:
        try:
            self._break_stream()
        except Exception:
            pass


class _WireBidiStream:
    """A BidiWriteObject call of the wire stack; failures arrive
    classified from its frame layer."""

    def __init__(self, call):
        self._call = call

    def send(self, msg: "wp.Msg", end: bool) -> None:
        self._call.send_message(msg.encode(), end=end)

    def recv(self, what: str):
        raw = self._call.recv_message()
        return None if raw is None else wp.BidiWriteObjectResponse.decode(raw)

    def drain(self, what: str) -> None:
        while self._call.recv_message() is not None:
            pass
        self._call.close()

    def cancel(self) -> None:
        self._call.cancel()


class _LibBidiStream:
    """A grpcio ``stream_stream`` call fed by a queue-driven request
    iterator (lockstep: enqueue one request, pull one ack;
    ``state_lookup`` makes the server answer each chunk)."""

    def __init__(self, stub, rpc_error):
        self._q: "queue.Queue" = queue.Queue()
        self._rpc_error = rpc_error

        def requests(q=self._q):
            while (item := q.get()) is not None:
                yield item

        self._it = stub(requests())

    def send(self, msg: "wp.Msg", end: bool) -> None:
        self._q.put(msg)
        if end:
            self._q.put(None)

    def recv(self, what: str):
        try:
            return next(self._it)
        except StopIteration:
            return None
        except self._rpc_error as e:
            raise _wrap_rpc_error(e, what) from e

    def drain(self, what: str) -> None:
        try:
            for _ in self._it:
                pass
        except self._rpc_error as e:
            raise _wrap_rpc_error(e, what) from e

    def cancel(self) -> None:
        self._q.put(None)
        try:
            self._it.cancel()
        except Exception:
            pass


class _WireBidiWriter(_BidiWriter):
    """Wire mode's resumable writer: one wire call a stream."""

    def _open_stream(self) -> _WireBidiStream:
        return _WireBidiStream(
            self._b._wire_chan().bidi(f"{_SVC}/BidiWriteObject")
        )


class _LibBidiWriter(_BidiWriter):
    """Library mode's resumable writer: one grpcio call a stream."""

    def _open_stream(self) -> _LibBidiStream:
        return _LibBidiStream(
            self._b._stub()["bidi_write"], self._b._grpc.RpcError
        )
