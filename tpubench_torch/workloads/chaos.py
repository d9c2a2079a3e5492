"""Hermetic servers for tuning sessions (``tpubench/workloads/chaos.py``).

Only :func:`spawn_hermetic_server` is ported so far: ``tune --protocol
http`` (or ``grpc``) with no endpoint runs against it. The ``chaos``
entry point itself comes with ``ROADMAP.md`` A.6.
"""

from __future__ import annotations

from tpubench_torch.config import BenchConfig


def spawn_hermetic_server(cfg: BenchConfig, fault_plan=None, store=None):
    """In-process fake server speaking the real wire protocol (HTTP/1.1,
    the h2 server under ``transport.http2``, or the gRPC wire server under
    ``--protocol grpc``), backed by a prepopulated fake store carrying
    ``fault_plan`` — server-side injection, so stalls, resets and
    truncation happen on the wire. ``store`` overrides the default
    population. Sets ``cfg.transport.endpoint`` (the caller restores it)
    and loads the C++ engine where the client path needs it, so first-use
    costs never land inside a measured window. Returns the started server
    (the caller stops it)."""
    from tpubench_torch.storage.fake import FakeBackend

    w = cfg.workload
    if store is None:
        store = FakeBackend.prepopulated(
            prefix=w.object_name_prefix,
            count=max(w.workers, w.threads),
            size=w.object_size,
            fault=fault_plan,
        )
    if cfg.transport.protocol == "grpc":
        from tpubench_torch.storage.fake_grpc_wire_server import (
            FakeGrpcWireServer,
        )

        server = FakeGrpcWireServer(backend=store).start()
        # DirectPath cannot apply to a loopback fake (caller restores cfg).
        cfg.transport.directpath = False
    elif cfg.transport.http2:
        from tpubench_torch.storage.fake_h2_server import FakeH2Server

        server = FakeH2Server(backend=store).start()
    else:
        from tpubench_torch.storage.fake_server import FakeGcsServer

        server = FakeGcsServer(backend=store).start()
    cfg.transport.endpoint = server.endpoint
    if cfg.transport.http2 or cfg.transport.native_receive:
        from tpubench_torch.native.engine import get_engine

        get_engine()
    return server
