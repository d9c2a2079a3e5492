"""GCS gRPC (storage v2) backend: ``tpubench/storage/gcs_grpc.py``
(reference ``CreateGrpcClient``, main.go:106-117), in two modes behind
one surface.

* **Wire mode**, for every endpoint that is not Google's: the
  dependency-free stack of :mod:`tpubench_torch.storage.grpc_wire`
  (hand-rolled protobuf and gRPC framing over raw h2 frames), whatever is
  installed, so a test server is spoken to by the same client on every
  machine.
* **Library mode**, for Google's endpoint (``googleapis.com`` in it,
  the default included) and for an explicit ``channel=``: ``grpcio``
  plus the generated storage-v2 types, over a bare channel (no GAPIC
  client, so the hot loop has no client-library layer in it). Where
  either does not import, the constructor raises a non-transient
  :class:`StorageError` naming it, before any socket opens; it never
  falls back to wire mode. ``grpc`` and the types are imported only here.

``tpubench`` instead picks library mode whenever both import; the port
chooses by endpoint.

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


def _library(what: str):
    """``(grpc, storage-v2 types)`` for library mode, or a non-transient
    :class:`StorageError` naming the package that does not import."""
    try:
        import grpc
    except ImportError as e:
        missing, err = "grpcio", e
    else:
        try:
            from google.cloud._storage_v2 import types as s2
        except ImportError as e:
            missing, err = "google.cloud._storage_v2", e
        else:
            return grpc, s2
    raise StorageError(
        f"{what} needs grpcio + google.cloud._storage_v2 installed "
        f"({missing} does not import: {err})",
        transient=False,
    ) from err


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
    from google.cloud._storage_v2 import types as s2

    return arrival_ns, s2.ReadObjectResponse.deserialize(b)


def _empty_deserializer(b: bytes):
    return b


class _GrpcReader:
    """Library mode: streams ReadObjectResponse messages (arrival stamp,
    message) off a grpcio response iterator, carrying a message's
    leftover bytes between ``readinto`` calls. ``carrier`` (optional) is
    the request span: ``first_byte`` on the first message, ended at close,
    with the error when the stream failed."""

    def __init__(self, stream, rpc_error, carrier=None):
        self._stream = stream
        self._rpc_error = rpc_error
        self._pending = memoryview(b"")
        self.first_byte_ns: Optional[int] = None
        self._done = False
        self._carrier = carrier

    def readinto(self, buf: memoryview) -> int:
        if self._done and not self._pending:
            return 0
        while not self._pending:
            try:
                item = next(self._stream, None)
            except self._rpc_error as e:
                self._done = True
                err = _wrap_rpc_error(e, "ReadObject stream")
                if self._carrier is not None:
                    self._carrier.close(err)
                raise err from e
            if item is None:
                self._done = True
                return 0
            arrival_ns, msg = item
            if self.first_byte_ns is None:
                self.first_byte_ns = arrival_ns
                if self._carrier is not None:
                    self._carrier.event("first_byte")
            content = msg.checksummed_data.content
            if content:
                self._pending = memoryview(content)
        n = min(len(buf), len(self._pending))
        buf[:n] = self._pending[:n]
        self._pending = self._pending[n:]
        return n

    def close(self) -> None:
        try:
            self._stream.cancel()
        except Exception:
            pass
        self._done = True
        if self._carrier is not None:
            self._carrier.close()  # idempotent: a failure closed it already


class _WireGrpcReader:
    """Streams framed ReadObjectResponse messages off a
    :class:`~tpubench_torch.storage.grpc_wire.client.WireCall`, carrying a
    message's leftover bytes between ``readinto`` calls. The first-byte
    stamp is taken on the raw message bytes, before protobuf decode.
    ``carrier`` (optional) is the request span, ended at close."""

    def __init__(self, call, carrier=None):
        self._call = call
        self._pending = memoryview(b"")
        self.first_byte_ns: Optional[int] = None
        self._done = False
        self._carrier = carrier

    def readinto(self, buf: memoryview) -> int:
        if self._done and not self._pending:
            return 0
        while not self._pending:
            try:
                raw = self._call.recv_message()
            except StorageError as e:
                self._done = True
                self._call.cancel()
                if self._carrier is not None:
                    self._carrier.close(e)
                raise
            if raw is None:
                self._done = True
                return 0
            arrival_ns = time.perf_counter_ns()
            msg = wp.ReadObjectResponse.decode(raw)
            if self.first_byte_ns is None:
                self.first_byte_ns = arrival_ns
                if self._carrier is not None:
                    self._carrier.event("first_byte")
            cd = msg.checksummed_data
            if cd is not None and cd.content:
                self._pending = memoryview(cd.content)
        n = min(len(buf), len(self._pending))
        buf[:n] = self._pending[:n]
        self._pending = self._pending[n:]
        return n

    def close(self) -> None:
        if self._done:
            self._call.close()  # clean end: the connection can be reused
        else:
            self._call.cancel()  # abandoned mid-stream: RST + discard
        self._done = True
        if self._carrier is not None:
            self._carrier.close()


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
        self._lib = channel is not None or "googleapis.com" in endpoint
        if self._lib:
            self._grpc, self._s2 = _library(
                "explicit grpc channel" if channel is not None
                else f"gRPC to Google's endpoint {endpoint!r}"
            )
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
        s2 = self._s2
        return {
            "read": ch.unary_stream(
                f"{_SVC}/ReadObject",
                request_serializer=s2.ReadObjectRequest.serialize,
                response_deserializer=_stamped_read_deserializer,
            ),
            "get": ch.unary_unary(
                f"{_SVC}/GetObject",
                request_serializer=s2.GetObjectRequest.serialize,
                response_deserializer=s2.Object.deserialize,
            ),
            "list": ch.unary_unary(
                f"{_SVC}/ListObjects",
                request_serializer=s2.ListObjectsRequest.serialize,
                response_deserializer=s2.ListObjectsResponse.deserialize,
            ),
            "delete": ch.unary_unary(
                f"{_SVC}/DeleteObject",
                request_serializer=s2.DeleteObjectRequest.serialize,
                response_deserializer=_empty_deserializer,
            ),
            "write": ch.stream_unary(
                f"{_SVC}/WriteObject",
                request_serializer=s2.WriteObjectRequest.serialize,
                response_deserializer=s2.WriteObjectResponse.deserialize,
            ),
            "start_resumable": ch.unary_unary(
                f"{_SVC}/StartResumableWrite",
                request_serializer=s2.StartResumableWriteRequest.serialize,
                response_deserializer=(
                    s2.StartResumableWriteResponse.deserialize
                ),
            ),
            "query_write": ch.unary_unary(
                f"{_SVC}/QueryWriteStatus",
                request_serializer=s2.QueryWriteStatusRequest.serialize,
                response_deserializer=s2.QueryWriteStatusResponse.deserialize,
            ),
            "bidi_write": ch.stream_stream(
                f"{_SVC}/BidiWriteObject",
                request_serializer=s2.BidiWriteObjectRequest.serialize,
                response_deserializer=s2.BidiWriteObjectResponse.deserialize,
            ),
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

    def _wire_unary(self, method: str, req: "wp.Msg") -> bytes:
        """One unary RPC; errors arrive classified from the frame layer."""
        return self._wire_chan().unary(method, req.encode())

    # ------------------------------------------------------- native pool --
    def _native_pool(self):
        with self._native_pool_lock:
            if self._native_pool_obj is None:
                from tpubench_torch.storage.native_pool import build_native_pool

                if self.transport.directpath and self._lib:
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
        if self._lib:
            return self._open_read_lib(name, start, length)
        wreq = wp.ReadObjectRequest(
            bucket=self._bucket_path, object=name,
            read_offset=start, read_limit=length or 0,
        )
        carrier = SpanCarrier(
            self._tracer, "gcs_grpc.read_object",
            object=name, bucket=self.bucket,
        )
        try:
            call = self._wire_chan().server_stream(
                f"{_SVC}/ReadObject", wreq.encode()
            )
            flight_note("stream_open")
            return _WireGrpcReader(call, carrier=carrier)
        except BaseException as e:
            carrier.close(e)
            raise

    def _open_read_lib(self, name: str, start: int, length: Optional[int]):
        req = self._s2.ReadObjectRequest(
            bucket=self._bucket_path, object_=name,
            read_offset=start, read_limit=length or 0,
        )
        carrier = SpanCarrier(
            self._tracer, "gcs_grpc.read_object",
            object=name, bucket=self.bucket,
        )
        try:
            stream = self._stub()["read"](req)
            flight_note("stream_open")
            return _GrpcReader(stream, self._grpc.RpcError, carrier=carrier)
        except BaseException as e:
            carrier.close(e)
            if isinstance(e, self._grpc.RpcError):
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

    def _wire_write(self, name: str, data, if_generation_match) -> ObjectMeta:
        """One-shot WriteObject as a client-streaming wire call."""
        spec = wp.WriteObjectSpec(
            resource=wp.Object(name=name, bucket=self._bucket_path),
            if_generation_match=(
                int(if_generation_match)
                if if_generation_match is not None
                else None
            ),
        )
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        call = self._wire_chan().bidi(f"{_SVC}/WriteObject")
        try:
            if not len(mv):
                call.send_message(
                    wp.WriteObjectRequest(
                        write_object_spec=spec, finish_write=True
                    ).encode(),
                    end=True,
                )
            else:
                off = 0
                first = True
                while off < len(mv):
                    chunk = mv[off : off + MAX_READ_CHUNK]
                    last = off + len(chunk) >= len(mv)
                    content = bytes(chunk)
                    call.send_message(
                        wp.WriteObjectRequest(
                            write_object_spec=spec if first else None,
                            write_offset=off,
                            checksummed_data=wp.ChecksummedData(
                                content=content,
                                crc32c=wp.crc32c_of(content),
                            ),
                            finish_write=last,
                        ).encode(),
                        end=last,
                    )
                    first = False
                    off += len(chunk)
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
        res = resp.resource
        size = res.size if res is not None else resp.persisted_size
        with self._stat_cache_lock:
            self._stat_cache[name] = size
        return ObjectMeta(res.name if res is not None else name, size)

    def _lib_write(self, name: str, data, if_generation_match) -> ObjectMeta:
        """One-shot WriteObject over a grpcio ``stream_unary`` call."""
        s2 = self._s2

        def requests():
            spec = s2.WriteObjectSpec(
                resource=s2.Object(name=name, bucket=self._bucket_path)
            )
            if if_generation_match is not None:
                spec.if_generation_match = int(if_generation_match)
            mv = memoryview(bytes(data))
            if not mv:
                yield s2.WriteObjectRequest(
                    write_object_spec=spec, write_offset=0, finish_write=True
                )
                return
            off = 0
            while off < len(mv):
                chunk = mv[off : off + MAX_READ_CHUNK]
                req = s2.WriteObjectRequest(
                    write_offset=off,
                    checksummed_data=s2.ChecksummedData(content=bytes(chunk)),
                    finish_write=off + len(chunk) >= len(mv),
                )
                if off == 0:
                    req.write_object_spec = spec
                off += len(chunk)
                yield req

        try:
            resp = self._stub()["write"](requests())
        except self._grpc.RpcError as e:
            raise _wrap_rpc_error(e, f"WriteObject {name}") from e
        # Keep the size cache coherent: a stale (smaller) size would let
        # the short-stream classifier call a truncation "at EOF".
        size = int(resp.resource.size)
        with self._stat_cache_lock:
            self._stat_cache[name] = size
        return ObjectMeta(resp.resource.name, size)

    def write(self, name: str, data: bytes,
              if_generation_match=None) -> ObjectMeta:
        if self._lib:
            return self._lib_write(name, data, if_generation_match)
        return self._wire_write(name, data, if_generation_match)

    def open_write(self, name: str, if_generation_match=None):
        """Resumable session: StartResumableWrite → BidiWriteObject
        chunks with lockstep persisted-size acks → QueryWriteStatus
        re-probe on break → idempotent finalize (412 non-transient).
        The RetryingBackend wraps this in ``_ResumingWriter``, which
        drives the re-probe + tail-resend choreography."""
        if self._lib:
            return _LibBidiWriter(self, name, if_generation_match)
        return _WireBidiWriter(self, name, if_generation_match)

    def _list_page(self, prefix: str, page_size: int, token: str):
        if not self._lib:
            return wp.ListObjectsResponse.decode(self._wire_unary(
                f"{_SVC}/ListObjects",
                wp.ListObjectsRequest(
                    parent=self._bucket_path, prefix=prefix,
                    page_size=max(0, page_size), page_token=token,
                ),
            ))
        req = self._s2.ListObjectsRequest(
            parent=self._bucket_path, prefix=prefix, page_token=token
        )
        if page_size > 0:
            req.page_size = page_size
        try:
            return self._stub()["list"](req)
        except self._grpc.RpcError as e:
            raise _wrap_rpc_error(e, "ListObjects") from e

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]:
        """Full listing under ``prefix``, following ``next_page_token``
        as the HTTP client follows ``nextPageToken``, in both modes;
        ``page_size`` > 0 bounds each page, not the listing.
        (``tpubench``'s clients read the first page only: ROADMAP C.7.)"""
        out: list[ObjectMeta] = []
        token = ""
        while True:
            resp = self._list_page(prefix, page_size, token)
            out.extend(
                ObjectMeta(o.name, int(o.size), int(o.generation))
                for o in resp.objects
            )
            token = resp.next_page_token
            if not token:
                return out

    def stat(self, name: str) -> ObjectMeta:
        if self._lib:
            try:
                o = self._stub()["get"](self._s2.GetObjectRequest(
                    bucket=self._bucket_path, object_=name
                ))
            except self._grpc.RpcError as e:
                raise _wrap_rpc_error(e, f"GetObject {name}") from e
        else:
            o = wp.Object.decode(self._wire_unary(
                f"{_SVC}/GetObject",
                wp.GetObjectRequest(bucket=self._bucket_path, object=name),
            ))
        meta = ObjectMeta(o.name, int(o.size), int(o.generation))
        # Feeds the size cache the native reader sizes its buffer from.
        with self._stat_cache_lock:
            self._stat_cache[name] = meta.size
        return meta

    def delete(self, name: str) -> None:
        if self._lib:
            try:
                self._stub()["delete"](self._s2.DeleteObjectRequest(
                    bucket=self._bucket_path, object_=name
                ))
            except self._grpc.RpcError as e:
                raise _wrap_rpc_error(e, f"DeleteObject {name}") from e
        else:
            self._wire_unary(
                f"{_SVC}/DeleteObject",
                wp.DeleteObjectRequest(bucket=self._bucket_path, object=name),
            )
        with self._stat_cache_lock:
            self._stat_cache.pop(name, None)

    def close(self) -> None:
        if self._owns_channels:
            for ch in self._channels:
                ch.close()
        if self._native_pool_obj is not None:
            self._native_pool_obj.close()  # also drains its BufferPool


class _WireBidiWriter:
    """Wire-mode resumable gRPC write (the ObjectWriter contract).

    StartResumableWrite issues the session; each ``write`` chunk rides
    a BidiWriteObject message with ``flush`` + ``state_lookup`` set and
    waits for the persisted-size ack in lockstep — ``offset`` is always
    the server's committed watermark, never an optimistic local count.
    A transient break tears the stream down and re-raises; the
    ``_ResumingWriter`` above re-probes ``committed()`` (QueryWriteStatus)
    and resends the tail on a fresh stream (first message re-carries the
    upload id). ``finalize`` sends ``finish_write`` and half-closes; a
    412 precondition verdict arrives non-transient."""

    def __init__(self, backend: GcsGrpcBackend, name: str,
                 if_generation_match=None):
        self._b = backend
        self.name = name
        spec = wp.WriteObjectSpec(
            resource=wp.Object(name=name, bucket=backend._bucket_path),
            if_generation_match=(
                int(if_generation_match)
                if if_generation_match is not None
                else None
            ),
        )
        raw = backend._wire_unary(
            f"{_SVC}/StartResumableWrite",
            wp.StartResumableWriteRequest(write_object_spec=spec),
        )
        self._uid = wp.StartResumableWriteResponse.decode(raw).upload_id
        self.offset = 0
        self._call = None
        self._fresh = True
        self._final: Optional[ObjectMeta] = None

    # ----------------------------------------------------------- stream --
    def _send(self, msg: "wp.BidiWriteObjectRequest", end: bool = False):
        if self._call is None:
            self._call = self._b._wire_chan().bidi(f"{_SVC}/BidiWriteObject")
            self._fresh = True
        if self._fresh:
            # The upload id rides only the FIRST message of each stream
            # (the storage-v2 first_message contract).
            msg.upload_id = self._uid
            self._fresh = False
        self._call.send_message(msg.encode(), end=end)
        return self._call

    def _break_stream(self) -> None:
        call, self._call = self._call, None
        if call is not None:
            call.cancel()

    # --------------------------------------------------------- contract --
    def write(self, data) -> int:
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        off = 0
        try:
            while off < len(mv):
                chunk = mv[off : off + MAX_READ_CHUNK]
                content = bytes(chunk)
                call = self._send(
                    wp.BidiWriteObjectRequest(
                        write_offset=self.offset,
                        checksummed_data=wp.ChecksummedData(
                            content=content, crc32c=wp.crc32c_of(content)
                        ),
                        flush=True,
                        state_lookup=True,
                    )
                )
                raw = call.recv_message()
                if raw is None:
                    raise StorageError(
                        f"BidiWriteObject {self.name}: stream closed "
                        "before persisted-size ack",
                        transient=True,
                    )
                ack = wp.BidiWriteObjectResponse.decode(raw)
                annotate(
                    "bidi_ack", persisted=ack.persisted_size, object=self.name
                )
                self.offset = ack.persisted_size
                off += len(chunk)
        except StorageError:
            self._break_stream()
            raise
        return self.offset

    def committed(self) -> int:
        raw = self._b._wire_unary(
            f"{_SVC}/QueryWriteStatus",
            wp.QueryWriteStatusRequest(upload_id=self._uid),
        )
        resp = wp.QueryWriteStatusResponse.decode(raw)
        self.offset = resp.persisted_size
        return self.offset

    def finalize(self) -> ObjectMeta:
        if self._final is not None:
            return self._final
        try:
            call = self._send(
                wp.BidiWriteObjectRequest(
                    write_offset=self.offset, finish_write=True
                ),
                end=True,
            )
            raw = call.recv_message()
            if raw is None:
                raise StorageError(
                    f"BidiWriteObject {self.name}: no finalize response",
                    transient=True,
                )
            resp = wp.BidiWriteObjectResponse.decode(raw)
            while call.recv_message() is not None:
                pass
            call.close()
            self._call = None
        except StorageError:
            self._break_stream()
            raise
        res = resp.resource
        if res is not None:
            meta = ObjectMeta(res.name or self.name, res.size, res.generation)
        else:
            meta = ObjectMeta(self.name, resp.persisted_size)
        with self._b._stat_cache_lock:
            self._b._stat_cache[meta.name] = meta.size
        self._final = meta
        return meta

    def abort(self) -> None:
        try:
            self._break_stream()
        except Exception:
            pass


class _LibBidiWriter:
    """Library-mode twin of :class:`_WireBidiWriter`: the same RPC
    choreography over a grpcio ``stream_stream`` call with a queue-driven
    request iterator (lockstep: enqueue one request, pull one ack;
    ``state_lookup`` makes the server answer each chunk)."""

    def __init__(self, backend: GcsGrpcBackend, name: str,
                 if_generation_match=None):
        self._b = backend
        self._s2 = s2 = backend._s2
        self._rpc_error = backend._grpc.RpcError
        self.name = name
        spec = s2.WriteObjectSpec(
            resource=s2.Object(name=name, bucket=backend._bucket_path)
        )
        if if_generation_match is not None:
            spec.if_generation_match = int(if_generation_match)
        try:
            resp = backend._stub()["start_resumable"](
                s2.StartResumableWriteRequest(write_object_spec=spec)
            )
        except self._rpc_error as e:
            raise _wrap_rpc_error(e, f"StartResumableWrite {name}") from e
        self._uid = resp.upload_id
        self.offset = 0
        self._q = None
        self._resp_iter = None
        self._fresh = True
        self._final: Optional[ObjectMeta] = None

    # ----------------------------------------------------------- stream --
    def _send(self, req, end: bool = False):
        if self._resp_iter is None:
            q: "queue.Queue" = queue.Queue()

            def requests():
                while True:
                    item = q.get()
                    if item is None:
                        return
                    yield item

            self._q = q
            self._resp_iter = self._b._stub()["bidi_write"](requests())
            self._fresh = True
        if self._fresh:
            # The upload id rides only the first message of each stream.
            req.upload_id = self._uid
            self._fresh = False
        self._q.put(req)
        if end:
            self._q.put(None)
        return self._resp_iter

    def _break_stream(self) -> None:
        it, self._resp_iter = self._resp_iter, None
        q, self._q = self._q, None
        if q is not None:
            q.put(None)
        if it is not None:
            try:
                it.cancel()
            except Exception:
                pass

    def _recv(self, it, what: str):
        try:
            return next(it)
        except StopIteration:
            raise StorageError(
                f"{what}: stream closed before ack", transient=True
            ) from None
        except self._rpc_error as e:
            raise _wrap_rpc_error(e, what) from e

    # --------------------------------------------------------- contract --
    def write(self, data) -> int:
        s2 = self._s2
        mv = memoryview(data) if not isinstance(data, memoryview) else data
        off = 0
        try:
            while off < len(mv):
                chunk = mv[off : off + MAX_READ_CHUNK]
                it = self._send(
                    s2.BidiWriteObjectRequest(
                        write_offset=self.offset,
                        checksummed_data=s2.ChecksummedData(
                            content=bytes(chunk)
                        ),
                        flush=True,
                        state_lookup=True,
                    )
                )
                ack = self._recv(it, f"BidiWriteObject {self.name}")
                annotate(
                    "bidi_ack", persisted=int(ack.persisted_size),
                    object=self.name,
                )
                self.offset = int(ack.persisted_size)
                off += len(chunk)
        except StorageError:
            self._break_stream()
            raise
        return self.offset

    def committed(self) -> int:
        try:
            resp = self._b._stub()["query_write"](
                self._s2.QueryWriteStatusRequest(upload_id=self._uid)
            )
        except self._rpc_error as e:
            raise _wrap_rpc_error(e, f"QueryWriteStatus {self.name}") from e
        # ``write_status`` is a oneof: a finalized session answers with
        # the object, whose size is then the committed size
        # (``tpubench``'s library writer reads 0 there).
        self.offset = int(
            resp.resource.size if "resource" in resp else resp.persisted_size
        )
        return self.offset

    def finalize(self) -> ObjectMeta:
        if self._final is not None:
            return self._final
        try:
            it = self._send(
                self._s2.BidiWriteObjectRequest(
                    write_offset=self.offset, finish_write=True
                ),
                end=True,
            )
            resp = self._recv(it, f"BidiWriteObject {self.name} finalize")
            for _ in it:
                pass
            self._resp_iter = None
            self._q = None
        except StorageError:
            self._break_stream()
            raise
        except self._rpc_error as e:  # raised while draining the stream
            self._break_stream()
            raise _wrap_rpc_error(
                e, f"BidiWriteObject {self.name} finalize") from e
        meta = ObjectMeta(
            resp.resource.name or self.name,
            int(resp.resource.size),
            int(resp.resource.generation),
        )
        with self._b._stat_cache_lock:
            self._b._stat_cache[meta.name] = meta.size
        self._final = meta
        return meta

    def abort(self) -> None:
        try:
            self._break_stream()
        except Exception:
            pass
