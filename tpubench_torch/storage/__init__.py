"""Storage backends of the port — ``tpubench/storage``, read and write
sides (``write``/``open_write``/``delete`` on every backend).

* :mod:`.base` — the backend protocol;
* :mod:`.fake` — the in-process fake store (deterministic bytes, faults);
* :mod:`.gcs_http` — the JSON-API client: HTTP/1.1 (the reference's
  default), native streaming receive into the caller's memory, and the
  whole-client HTTP/2 branch; also the request parts of the native fetch
  executor;
* :mod:`.gcs_grpc` — the storage-v2 gRPC client: library mode (grpcio
  carrying :mod:`.grpc_wire`'s codec) wherever grpcio imports, wire mode
  (:mod:`.grpc_wire`, test servers only) where it does not, native
  receive in both;
* :mod:`.local_fs` — files under a directory root;
* :mod:`.auth` — the token sources of the HTTP and gRPC clients;
* :mod:`.retrying` — the client-level retry decorator with mid-stream
  resume, over every backend;
* :mod:`.tail` — tail tolerance (hedged reads, stall watchdog, circuit
  breaker), inside the retry decorator;
* :mod:`.reactor_backend` — the serve plane's reads through the native
  executor's pool (``--fetch-executor native`` on ``http``);
* the hermetic servers the clients are run against: :mod:`.fake_server`
  (HTTP/1.1), :mod:`.fake_h2_server` (HTTP/2), :mod:`.fake_grpc_wire_server`
  (gRPC on raw h2 frames, write plane included; serves grpcio clients
  too) and :mod:`.fake_grpc_server` (gRPC on grpcio, imported only where
  grpcio is installed).
"""

from tpubench_torch.storage.base import (  # noqa: F401
    ObjectMeta,
    ObjectReader,
    StorageBackend,
    StorageError,
    deterministic_bytes,
)
from tpubench_torch.storage.fake import FakeBackend, FaultPlan  # noqa: F401
from tpubench_torch.storage.retrying import RetryingBackend
from tpubench_torch.storage.tail import (  # noqa: F401
    CircuitOpenError,
    StallError,
    collect_tail_stats,
    wrap_tail,
)


def fault_plan(cfg):
    """The config's fault plan, or ``None`` when no fault is switched on.
    ``FaultConfig`` and ``FaultPlan`` share fields by contract; building by
    name makes a knob added to one side fail loudly here."""
    import dataclasses

    fc = cfg.transport.fault
    return FaultPlan(**dataclasses.asdict(fc)) if fc.active else None


def open_backend(cfg, tracer=None, fault=None) -> StorageBackend:
    """Backend from a BenchConfig (reference: main.go:169-177 protocol
    switch). ``fake`` holds one object per worker, as ``tpubench``'s does,
    under ``fault`` (a :class:`FaultPlan` the caller arms, as ``chaos``
    does) or else the config's fault plan. Every backend is wrapped in the
    tail layers the config switches on and then in the client-level retry
    policy (main.go:179-184) unless ``transport.retry.policy`` is
    ``never``. ``tracer`` gives the HTTP and gRPC clients their request
    spans."""
    proto = cfg.transport.protocol
    if proto == "fake":
        inner = FakeBackend.prepopulated(
            prefix=cfg.workload.object_name_prefix,
            count=max(cfg.workload.workers, cfg.workload.threads),
            size=cfg.workload.object_size,
            fault=fault if fault is not None else fault_plan(cfg),
        )
    elif proto == "http":
        from tpubench_torch.storage.gcs_http import GcsHttpBackend
        from tpubench_torch.storage.reactor_backend import (
            maybe_wrap_reactor_fetch,
        )

        inner = GcsHttpBackend(
            cfg.workload.bucket, transport=cfg.transport, tracer=tracer
        )
        # A native fetch executor routes backend reads (the serve plane's
        # fetches) through the shared pool; the wrapper is lazy, so the
        # read runners, which drive the pool themselves, never start a
        # second one.
        inner = maybe_wrap_reactor_fetch(inner, cfg)
    elif proto == "grpc":
        from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend

        inner = GcsGrpcBackend(
            cfg.workload.bucket, transport=cfg.transport, tracer=tracer
        )
    elif proto == "local":
        from tpubench_torch.storage.local_fs import LocalFsBackend

        inner = LocalFsBackend(root=cfg.workload.dir)
    else:
        raise ValueError(f"unknown protocol {proto!r} (http|grpc|local|fake)")
    # Tail layers wrap INSIDE the retry decorator, so a StallError or
    # CircuitOpenError rides the same resume/backoff as a server 503.
    inner = wrap_tail(
        inner, cfg.transport.tail, chunk_bytes=cfg.workload.granule_bytes,
    )
    if cfg.transport.retry.policy == "never":
        return inner
    return RetryingBackend(inner, cfg.transport.retry)


def base_backend(backend):
    """The client under the decorators (retry, tail): what holds the
    connection pools and the request parts."""
    while hasattr(backend, "inner"):
        backend = backend.inner
    return backend
