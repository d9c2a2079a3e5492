"""Dependency-free gRPC-over-HTTP/2 wire stack for storage v2 (a copy of
``tpubench/storage/grpc_wire``): a hand-rolled protobuf codec
(:mod:`.proto`), gRPC message framing and status mapping (:mod:`.framing`)
and a client connection (:mod:`.client`) running them over a plain socket
(h2c prior knowledge) or TLS+ALPN h2 — no ``grpcio``, no generated types.
:class:`~tpubench_torch.storage.gcs_grpc.GcsGrpcBackend` rides this stack
in wire mode, where grpcio does not import; in library mode grpcio
carries the same codec.
"""
