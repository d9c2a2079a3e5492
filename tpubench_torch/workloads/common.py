"""Worker fan-out with errgroup semantics (``tpubench/workloads/common.py``).

The reference's L3 is ``golang.org/x/sync/errgroup``: N goroutines, first
error cancels the run and propagates (``main.go:59,200-212``). Python
equivalent: a thread pool whose workers poll a shared cancel event; the first
exception is re-raised after join. I/O-bound workers release the GIL inside
socket/file syscalls and native copies, so threads are the right
concurrency primitive here.

``abort_on_error=False`` is per-worker failure isolation instead of a
pod-wide abort: failed workers are recorded as holes (error count + which
workers) and the run completes.
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
