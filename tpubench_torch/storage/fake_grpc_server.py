"""In-process storage-v2 gRPC server on ``grpcio``: a copy of
``tpubench/storage/fake_grpc_server.py``, the server of library-mode
tests.

It serves ``google.storage.v2.Storage`` from a :class:`FakeBackend`, with
its fault injection: ReadObject (content in messages of at most 2 MiB,
object metadata on the first), GetObject, ListObjects, DeleteObject and
WriteObject. Handlers are registered generically from the generated
request and response types, so no servicer code generation is needed.
It has no resumable sessions (StartResumableWrite, BidiWriteObject,
QueryWriteStatus): library mode's resumable writer is tested against
:mod:`.fake_grpc_wire_server`, which has them.

``grpc`` is imported with this module, the storage-v2 types when a
server is built. Only tests, and ``chip_smoke.py`` where grpcio imports,
load it: the package runs without grpcio.
"""

from __future__ import annotations

from concurrent import futures
from typing import Optional

import grpc

from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_server import make_self_signed_cert
from tpubench_torch.storage.gcs_grpc import MAX_READ_CHUNK

_SVC = "google.storage.v2.Storage"


def _abort_storage_error(context, e: StorageError):
    code = {
        404: grpc.StatusCode.NOT_FOUND,
        416: grpc.StatusCode.OUT_OF_RANGE,
        503: grpc.StatusCode.UNAVAILABLE,
    }.get(e.code, grpc.StatusCode.UNKNOWN)
    context.abort(code, str(e))


class _Handlers:
    def __init__(self, backend: FakeBackend, s2):
        self.backend = backend
        self.s2 = s2

    # --------------------------------------------------- streaming read --
    def read_object(self, request, context):
        s2 = self.s2
        try:
            meta = self.backend.stat(request.object_)
            reader = self.backend.open_read(
                request.object_, start=request.read_offset,
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
                resp = s2.ReadObjectResponse(
                    checksummed_data=s2.ChecksummedData(content=bytes(mv[:n]))
                )
                if first:
                    resp.metadata = s2.Object(
                        name=meta.name, size=meta.size,
                        generation=meta.generation,
                    )
                    first = False
                yield resp
        finally:
            reader.close()

    # ------------------------------------------------------------ unary --
    def get_object(self, request, context):
        try:
            m = self.backend.stat(request.object_)
        except StorageError as e:
            _abort_storage_error(context, e)
            return
        return self.s2.Object(name=m.name, size=m.size, generation=m.generation)

    def list_objects(self, request, context):
        s2 = self.s2
        return s2.ListObjectsResponse(
            objects=[
                s2.Object(name=m.name, size=m.size, generation=m.generation)
                for m in self.backend.list(request.prefix)
            ]
        )

    def delete_object(self, request, context):
        try:
            self.backend.delete(request.object_)
        except StorageError as e:
            _abort_storage_error(context, e)
            return
        return b""

    def write_object(self, request_iterator, context):
        name = None
        chunks = []
        for req in request_iterator:
            if req.write_object_spec and req.write_object_spec.resource.name:
                name = req.write_object_spec.resource.name
            if req.checksummed_data and req.checksummed_data.content:
                chunks.append(bytes(req.checksummed_data.content))
        if name is None:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "missing spec")
            return
        meta = self.backend.write(name, b"".join(chunks))
        return self.s2.WriteObjectResponse(
            resource=self.s2.Object(name=meta.name, size=meta.size)
        )


def _service(backend: FakeBackend) -> grpc.GenericRpcHandler:
    from google.cloud._storage_v2 import types as s2

    h = _Handlers(backend, s2)
    return grpc.method_handlers_generic_handler(
        _SVC,
        {
            "ReadObject": grpc.unary_stream_rpc_method_handler(
                h.read_object,
                request_deserializer=s2.ReadObjectRequest.deserialize,
                response_serializer=s2.ReadObjectResponse.serialize,
            ),
            "GetObject": grpc.unary_unary_rpc_method_handler(
                h.get_object,
                request_deserializer=s2.GetObjectRequest.deserialize,
                response_serializer=s2.Object.serialize,
            ),
            "ListObjects": grpc.unary_unary_rpc_method_handler(
                h.list_objects,
                request_deserializer=s2.ListObjectsRequest.deserialize,
                response_serializer=s2.ListObjectsResponse.serialize,
            ),
            "DeleteObject": grpc.unary_unary_rpc_method_handler(
                h.delete_object,
                request_deserializer=s2.DeleteObjectRequest.deserialize,
                response_serializer=lambda b: b if isinstance(b, bytes) else b"",
            ),
            "WriteObject": grpc.stream_unary_rpc_method_handler(
                h.write_object,
                request_deserializer=s2.WriteObjectRequest.deserialize,
                response_serializer=s2.WriteObjectResponse.serialize,
            ),
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
