"""Storage backends of the port: the protocol (:mod:`.base`), the
in-process fake store (:mod:`.fake`) and the JSON-API request side the
native fetch executor drives (:mod:`.gcs_http`). The http reader of the
Python route, grpc/local clients, the retrying wrapper and tail tolerance
arrive in later slices (``ROADMAP.md`` A.2)."""

from tpubench_torch.storage.base import (  # noqa: F401
    ObjectMeta,
    ObjectReader,
    StorageBackend,
    StorageError,
    deterministic_bytes,
)
from tpubench_torch.storage.fake import FakeBackend, FaultPlan  # noqa: F401


def fault_plan(cfg):
    """The config's fault plan, or ``None`` when no fault is switched on.
    ``FaultConfig`` and ``FaultPlan`` share fields by contract; building by
    name makes a knob added to one side fail loudly here."""
    import dataclasses

    fc = cfg.transport.fault
    return FaultPlan(**dataclasses.asdict(fc)) if fc.active else None


def open_backend(cfg) -> StorageBackend:
    """Backend from a BenchConfig (reference: main.go:169-177 protocol
    switch). ``fake`` holds one object per worker, as ``tpubench``'s does;
    ``http`` is the JSON-API backend of the native fetch executor."""
    proto = cfg.transport.protocol
    if proto == "http":
        from tpubench_torch.storage.gcs_http import GcsHttpBackend

        return GcsHttpBackend(cfg.workload.bucket, transport=cfg.transport)
    if proto != "fake":
        raise NotImplementedError(
            f"protocol {proto!r} is not ported to tpubench_torch yet "
            "(ROADMAP A.2: http/grpc/local backends)"
        )
    return FakeBackend.prepopulated(
        prefix=cfg.workload.object_name_prefix,
        count=max(cfg.workload.workers, cfg.workload.threads),
        size=cfg.workload.object_size,
        fault=fault_plan(cfg),
    )
