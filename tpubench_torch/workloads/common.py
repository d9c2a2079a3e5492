"""Worker fan-out with errgroup semantics (``tpubench/workloads/common.py``).

The reference's L3 is ``golang.org/x/sync/errgroup``: N goroutines, first
error cancels the run and propagates (``main.go:59,200-212``). Python
equivalent: a thread pool whose workers poll a shared cancel event; the first
exception is re-raised after join. I/O-bound workers release the GIL inside
socket/file syscalls and native copies, so threads are the right
concurrency primitive here.

``abort_on_error=False`` is per-worker failure isolation instead of a
pod-wide abort: failed workers are recorded as holes (error count + which
workers) and the run completes. :class:`ElasticGate` parks and resumes
workers live (the tune controller's fan-out knob).

The pod workloads' shard fetch lives here too (:func:`fetch_shard`,
:func:`zero_failed_shards`, :func:`global_hole_totals`). The reference's
multiplexed shard fetch (``fetch_shards_mux``, all local shards over one
h2 connection) needs ``read_ranges``, which the port's clients do not have
yet: :func:`refuse_multiplexed_fetch` refuses the configurations on which
the reference would take it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Optional


class WorkerError(Exception):
    def __init__(self, worker_id: int, cause: BaseException):
        super().__init__(f"worker {worker_id} failed: {cause!r}")
        self.worker_id = worker_id
        self.cause = cause


@dataclass
class GroupResult:
    errors: list[WorkerError] = field(default_factory=list)

    @property
    def error_count(self) -> int:
        return len(self.errors)


class ElasticGate:
    """Live worker-fan-out gate (``tpubench/workloads/common.py:39``): the
    tune controller's ``workers`` actuator on the thread-pool route.

    All ``total`` threads are spawned up front; only the first ``active``
    are admitted through :meth:`admit` — the rest PARK on the gate's
    condvar until the controller grows the pool back or the run ends.
    Shrinks take effect at each worker's next admit (its in-flight read
    completes normally — a live resize, never a mid-read cancel)."""

    def __init__(self, active: int, total: int):
        self.total = max(1, total)
        self._active = max(1, min(active, self.total))
        self._cond = threading.Condition()

    @property
    def active(self) -> int:
        return self._active

    def set_active(self, n: int) -> None:
        with self._cond:
            self._active = max(1, min(int(n), self.total))
            self._cond.notify_all()

    def admit(self, worker_id: int, cancel: threading.Event) -> bool:
        """Block while ``worker_id`` is parked; True = proceed with the
        next unit of work, False = the run was cancelled while parked.
        The short wait timeout is only a safety net against a missed
        cancel-set (cancel has no condvar of its own)."""
        with self._cond:
            while worker_id >= self._active:
                if cancel.is_set():
                    return False
                self._cond.wait(0.05)
        return not cancel.is_set()


class WorkerGroup:
    """Run ``fn(worker_id, cancel_event)`` across N threads."""

    def __init__(self, abort_on_error: bool = True):
        self.abort_on_error = abort_on_error
        self.cancel = threading.Event()

    def run(
        self,
        n_workers: int,
        fn: Callable[[int, threading.Event], None],
        name: str = "worker",
    ) -> GroupResult:
        errors: list[Optional[WorkerError]] = [None] * n_workers

        def _wrap(i: int) -> None:
            try:
                fn(i, self.cancel)
            except BaseException as exc:  # noqa: BLE001 — recorded, maybe re-raised
                errors[i] = WorkerError(i, exc)
                if self.abort_on_error:
                    self.cancel.set()

        threads = [
            threading.Thread(target=_wrap, args=(i,), name=f"{name}-{i}", daemon=True)
            for i in range(n_workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        collected = [e for e in errors if e is not None]
        if collected and self.abort_on_error:
            # errgroup returns the *first* error (main.go:212-219).
            raise collected[0]
        return GroupResult(errors=collected)


def fetch_shard(backend, name: str, table, shard_index: int, buffer) -> None:
    """Fetch one byte-range shard of ``name`` into ``buffer`` (a host
    buffer of ``table.shard_bytes`` capacity, anything numpy and
    memoryview can write), zeroing the padding tail — explicit, so a
    buffer reused across objects of different sizes never carries bytes
    of an earlier object into the gather."""
    sh = table.shard(shard_index)
    buffer[sh.length :] = 0  # zero pad (and the whole buffer for an empty shard)
    if sh.length == 0:
        return
    mv = memoryview(buffer)
    reader = backend.open_read(name, start=sh.start, length=sh.length)
    got = 0
    try:
        while got < sh.length:
            r = reader.readinto(mv[got : sh.length])
            if r <= 0:
                break
            got += r
    finally:
        # Flight-recorder phase: the reader's own first-byte stamp lands
        # on the calling worker's current op; no-op when none is active.
        fb = getattr(reader, "first_byte_ns", None)
        if fb:
            from tpubench_torch.obs.flight import note_phase

            note_phase("first_byte", fb)
        reader.close()
    if got != sh.length:
        raise IOError(f"{name} shard {shard_index}: short fetch {got}/{sh.length}")


def zero_failed_shards(gres: GroupResult, table, buffers, local_idx) -> dict:
    """Turn fetch failures into deterministic holes: zero each failed
    worker's buffer and return ``{"shards": [global indices], "bytes":
    missing}``."""
    for e in gres.errors:
        buffers[e.worker_id][:] = 0
    shards = sorted(local_idx[e.worker_id] for e in gres.errors)
    return {
        "shards": shards,
        "bytes": sum(table.shard(i).length for i in shards),
    }


def global_hole_totals(holes: dict, pod) -> dict:
    """Pod-wide hole totals. Each rank sees only the failures of its own
    shard fetches; delivered bytes must subtract every rank's holes. One
    rank: identity. Several: an int64 all-gather of every rank's
    ``(shard count, bytes)`` over the pod's group, summed."""
    if pod.size == 1:
        return {"shards": len(holes["shards"]), "bytes": holes["bytes"]}
    import torch

    local = torch.tensor([[len(holes["shards"]), holes["bytes"]]],
                         dtype=torch.int64, device=pod.device)
    every = torch.empty((pod.size, 2), dtype=torch.int64, device=pod.device)
    from tpubench_torch.dist.reassemble import all_gather_into_tensor

    all_gather_into_tensor(every, local, group=pod.group)
    every = every.cpu()
    return {
        "shards": int(every[:, 0].sum()),
        "bytes": int(every[:, 1].sum()),
    }


def refuse_multiplexed_fetch(cfg) -> None:
    """Raise ``NotImplementedError`` where the reference would fetch the
    shards multiplexed over one connection (gRPC with native receive, or
    the whole-client HTTP/2 mode): the port has no ``read_ranges`` yet, and
    running the thread fan-out instead would measure another client."""
    t = cfg.transport
    if ((t.protocol == "grpc" and t.native_receive)
            or (t.protocol == "http" and t.http2)):
        raise NotImplementedError(
            "not ported to tpubench_torch yet: the multiplexed shard fetch "
            f"of protocol {t.protocol!r} with "
            f"{'native_receive' if t.protocol == 'grpc' else 'http2'} "
            "(ROADMAP A.2: read_ranges and run_multiplexed_batch)"
        )
