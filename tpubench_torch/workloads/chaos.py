"""Hermetic servers (``tpubench/workloads/chaos.py``).

Ported so far: :func:`spawn_hermetic_server` (``tune --protocol http`` or
``grpc`` with no endpoint runs against it) and :func:`hermetic_target`,
the guard ``ckpt-save``/``ckpt-restore`` run under. The ``chaos`` entry
point itself comes with ``ROADMAP.md`` A.6.
"""

from __future__ import annotations

import contextlib
import dataclasses

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


@contextlib.contextmanager
def hermetic_target(cfg: BenchConfig):
    """Hermetic-target guard for the lifecycle CLI paths: under
    ``--protocol http``/``--protocol grpc`` with no endpoint, spawn the
    matching in-process fake server (carrying ``transport.fault`` when
    active, so upload faults are injected ON THE WIRE) and restore the
    touched transport fields on exit. Yields the server, or ``None`` when
    the run already has a target (an explicit endpoint, or a protocol like
    ``fake``/``local`` that needs no server).

    The server's store starts empty: ``tpubench``'s is prepopulated with
    the read workload's objects (``workers`` × ``object_size``, 4.8 GB
    at the defaults), which no lifecycle command reads."""
    t = cfg.transport
    if t.protocol not in ("http", "grpc") or t.endpoint:
        yield None
        return
    from tpubench_torch.storage.fake import FakeBackend, FaultPlan

    plan = (
        FaultPlan(**dataclasses.asdict(t.fault)) if t.fault.active else None
    )
    restore = (t.endpoint, t.directpath)
    server = spawn_hermetic_server(cfg, store=FakeBackend(fault=plan))
    try:
        yield server
    finally:
        server.stop()
        t.endpoint, t.directpath = restore
