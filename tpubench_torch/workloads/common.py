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

The pod workloads' shard fetch lives here too: a thread per shard
(:func:`fetch_shard`) or every range of this rank over one h2 connection
(:func:`fetch_shards_mux`, where :func:`mux_supported` says the backend
can), then :func:`zero_failed_shards` and :func:`global_hole_totals`.
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


def mux_supported(backend) -> bool:
    """Whether ``backend`` (or the one decorator layer's ``inner``, as in
    ``tpubench``) multiplexes ranges on one connection: native-receive
    gRPC, or the whole-client HTTP/2 mode."""
    from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend
    from tpubench_torch.storage.gcs_http import GcsHttpBackend

    inner = getattr(backend, "inner", backend)
    return (
        (isinstance(inner, GcsGrpcBackend) and inner.transport.native_receive)
        or (isinstance(inner, GcsHttpBackend) and inner.transport.http2)
    )


def fetch_shards_mux(backend, cfg, name, table, local_idx, buffers):
    """Multiplexed shard fetch (``tpubench/workloads/common.py:189``):
    every range ``table.shard(i)`` for ``i`` in ``local_idx`` rides ONE
    connection as a concurrent h2 stream into ``buffers`` — no fan-out
    threads, one socket, per-stream failure isolation. Failed ranges are
    fetched again under ``transport.retry`` (the policy the threaded path
    gets from ``RetryingBackend``), each range on its own attempt chain
    and backoff, within the deadline: a round sleeps the longest pause of
    the ranges it retries, and a range whose pause would cross the
    deadline is given up, so no range is sent past it.

    Returns a :class:`GroupResult` (its first error raised under
    ``abort_on_error``), or ``None`` when the backend does not multiplex
    (:func:`mux_supported`) or there is nothing to fetch: the caller then
    fans out threads, as in ``tpubench``."""
    import time as _time

    from tpubench_torch.storage.retry import Backoff, _is_retryable

    if not (mux_supported(backend) and len(local_idx) > 0):
        return None
    inner = getattr(backend, "inner", backend)
    rngs = []
    for k, gi in enumerate(local_idx):
        sh = table.shard(gi)
        buffers[k][sh.length:] = 0  # zero pad, as fetch_shard does
        rngs.append((sh.start, sh.length))

    rcfg = cfg.transport.retry
    start_t = _time.monotonic()
    final: list = [None] * len(rngs)
    remaining = list(range(len(rngs)))
    attempts = [0] * len(rngs)
    backoffs = [Backoff(rcfg) for _ in rngs]
    while remaining:
        sub_errs = inner.read_ranges(
            name,
            [rngs[i] for i in remaining],
            [buffers[i] for i in remaining],
        )
        for j, e in enumerate(sub_errs):
            final[remaining[j]] = e
        retryable = []
        for j, e in enumerate(sub_errs):
            i = remaining[j]
            if e is None or not _is_retryable(e, rcfg.policy):
                continue
            attempts[i] += 1
            if rcfg.max_attempts and attempts[i] >= rcfg.max_attempts:
                continue
            retryable.append(i)
        if not retryable:
            break
        pauses = {i: backoffs[i].pause() for i in retryable}
        if rcfg.deadline_s:
            budget = rcfg.deadline_s - (_time.monotonic() - start_t)
            retryable = [i for i in retryable if pauses[i] <= budget]
            if not retryable:
                break
        _time.sleep(max(pauses[i] for i in retryable))
        remaining = retryable
    gres = GroupResult(
        errors=[WorkerError(k, e) for k, e in enumerate(final) if e is not None]
    )
    if gres.errors and cfg.workload.abort_on_error:
        raise gres.errors[0]  # errgroup semantics (WorkerGroup parity)
    return gres
