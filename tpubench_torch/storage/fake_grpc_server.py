"""In-process storage-v2 gRPC server on ``grpcio``: a copy of
``tpubench/storage/fake_grpc_server.py``, the server of library-mode
tests.

It serves ``google.storage.v2.Storage`` from a :class:`FakeBackend`, with
its fault injection: ReadObject (content in messages of at most 2 MiB,
object metadata on the first), GetObject, ListObjects, DeleteObject and
WriteObject. Handlers are registered generically, with the port's
storage-v2 codec (:mod:`.grpc_wire.proto`) as their serializers, so no
servicer code generation and no generated types are needed. It has no
resumable sessions (StartResumableWrite, BidiWriteObject,
QueryWriteStatus): library mode's resumable writer is tested against
:mod:`.fake_grpc_wire_server`, which has them.

``grpc`` is imported with this module, which needs nothing else beyond
the port. Only tests and ``chip_smoke.py`` load it: the package runs
without grpcio.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_server import make_self_signed_cert
from tpubench_torch.storage.gcs_grpc import MAX_READ_CHUNK
from tpubench_torch.storage.grpc_wire import proto as wp

_SVC = "google.storage.v2.Storage"


def _abort_storage_error(context, e: StorageError):
    code = {
        404: grpc.StatusCode.NOT_FOUND,
        416: grpc.StatusCode.OUT_OF_RANGE,
        503: grpc.StatusCode.UNAVAILABLE,
    }.get(e.code, grpc.StatusCode.UNKNOWN)
    context.abort(code, str(e))


def _obj(m) -> wp.Object:
    return wp.Object(name=m.name, size=m.size, generation=m.generation)


class _Handlers:
    def __init__(self, backend: FakeBackend):
        self.backend = backend

    # --------------------------------------------------- streaming read --
    def read_object(self, request, context):
        try:
            meta = self.backend.stat(request.object)
            reader = self.backend.open_read(
                request.object, start=request.read_offset,
                length=request.read_limit or None,
            )
        except StorageError as e:
            _abort_storage_error(context, e)
            return
        first = True
        mv = memoryview(bytearray(MAX_READ_CHUNK))
        try:
            while True:
                try:
                    n = reader.readinto(mv)
                except StorageError as e:
                    _abort_storage_error(context, e)
                    return
                if n <= 0:
                    break
                yield wp.ReadObjectResponse(
                    checksummed_data=wp.ChecksummedData(content=bytes(mv[:n])),
                    metadata=_obj(meta) if first else None,
                )
                first = False
        finally:
            reader.close()

    # ------------------------------------------------------------ unary --
    def get_object(self, request, context):
        try:
            m = self.backend.stat(request.object)
        except StorageError as e:
            _abort_storage_error(context, e)
            return
        return _obj(m)

    def list_objects(self, request, context):
        return wp.ListObjectsResponse(
            objects=[_obj(m) for m in self.backend.list(request.prefix)]
        )

    def delete_object(self, request, context):
        try:
            self.backend.delete(request.object)
        except StorageError as e:
            _abort_storage_error(context, e)
            return
        return wp.Msg()  # google.protobuf.Empty

    def write_object(self, request_iterator, context):
        name = None
        chunks = []
        for req in request_iterator:
            spec = req.write_object_spec
            if spec is not None and spec.resource is not None \
                    and spec.resource.name:
                name = spec.resource.name
            if req.checksummed_data is not None \
                    and req.checksummed_data.content:
                chunks.append(req.checksummed_data.content)
        if name is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "missing spec")
            return
        meta = self.backend.write(name, b"".join(chunks))
        return wp.WriteObjectResponse(
            resource=wp.Object(name=meta.name, size=meta.size)
        )


def _service(backend: FakeBackend) -> grpc.GenericRpcHandler:
    h = _Handlers(backend)

    def codec(req_cls) -> dict:
        return dict(request_deserializer=req_cls.decode,
                    response_serializer=wp.Msg.encode)

    return grpc.method_handlers_generic_handler(
        _SVC,
        {
            "ReadObject": grpc.unary_stream_rpc_method_handler(
                h.read_object, **codec(wp.ReadObjectRequest)),
            "GetObject": grpc.unary_unary_rpc_method_handler(
                h.get_object, **codec(wp.GetObjectRequest)),
            "ListObjects": grpc.unary_unary_rpc_method_handler(
                h.list_objects, **codec(wp.ListObjectsRequest)),
            "DeleteObject": grpc.unary_unary_rpc_method_handler(
                h.delete_object, **codec(wp.DeleteObjectRequest)),
            "WriteObject": grpc.stream_unary_rpc_method_handler(
                h.write_object, **codec(wp.WriteObjectRequest)),
        },
    )


class FakeGcsGrpcServer:
    """Threaded fake storage-v2 server; a context manager.

    ``endpoint`` is ``insecure://host:port`` (h2c) by default; ``tls=True``
    serves TLS with an ephemeral self-signed certificate (grpcio
    negotiates ALPN h2), ``cafile`` then being the PEM to trust."""

    def __init__(
        self,
        backend: Optional[FakeBackend] = None,
        port: int = 0,
        tls: bool = False,
    ):
        self.backend = backend or FakeBackend()
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=16),
            options=[("grpc.max_send_message_length", 16 * 1024 * 1024)],
        )
        self._server.add_generic_rpc_handlers((_service(self.backend),))
        self._tls = tls
        self.cafile = ""
        if tls:
            self.cafile, keyfile = make_self_signed_cert()
            with open(keyfile, "rb") as f:
                key = f.read()
            with open(self.cafile, "rb") as f:
                cert = f.read()
            creds = grpc.ssl_server_credentials([(key, cert)])
            self._port = self._server.add_secure_port(f"127.0.0.1:{port}", creds)
        else:
            self._port = self._server.add_insecure_port(f"127.0.0.1:{port}")

    @property
    def endpoint(self) -> str:
        if self._tls:
            return f"127.0.0.1:{self._port}"  # no scheme = TLS (like real GCS)
        return f"insecure://127.0.0.1:{self._port}"

    def start(self) -> "FakeGcsGrpcServer":
        self._server.start()
        return self

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace=grace).wait()

    def __enter__(self) -> "FakeGcsGrpcServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
