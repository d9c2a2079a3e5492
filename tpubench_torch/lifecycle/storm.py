"""Open-loop metadata storm engine (``meta-storm``; a copy of
``tpubench/lifecycle/storm.py``).

The reference's ``benchmark-script/`` list/open binaries hammer metadata
closed-loop (a fixed thread pool as fast as it can); real dataloaders
hit the many-small-files pathology OPEN-LOOP — list/stat/open requests
arrive on their own schedule whether or not the store keeps up, which is
the only regime where a saturation knee exists to measure. This engine
drives the arrivals plane of ``workloads/arrivals.py`` (Poisson/MMPP/
diurnal, seeded and replayable) over a population of small objects with
a weighted list/stat/open mix, and reports offered vs achieved rate plus
per-kind latency — the inputs :func:`tpubench_torch.serve.qos.find_knee`
needs.

Clock/sleep are injectable (CLOCK_MODULES discipline: seeded storms must
replay deterministically in tests); the ledger's lock is a leaf —
backend calls and flight appends run OUTSIDE it (LOCK_ORDER_FILES).
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from tpubench_torch.config import parse_meta_mix, parse_sleep_scale
from tpubench_torch.metrics import LatencyRecorder, merge_recorders
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.workloads.arrivals import make_arrivals, scaled_gaps


@dataclass(frozen=True)
class MetaOp:
    """One scheduled metadata operation."""

    t: float  # virtual arrival second
    kind: str  # list | stat | open
    obj: str  # target object name (stat/open) or listing prefix (list)


def _rng(seed: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(seed))


def build_storm_schedule(
    object_names: Sequence[str],
    *,
    kind: str,
    rate_rps: float,
    duration_s: float,
    mix: str,
    prefix: str,
    seed: int = 0,
    burst_factor: float = 4.0,
    burst_fraction: float = 0.25,
    burst_cycle_s: float = 1.0,
    diurnal_period_s: float = 4.0,
) -> list[MetaOp]:
    """Seeded, replayable storm timeline: arrival instants from the
    shared arrivals plane, op kinds drawn by the normalized mix weights,
    targets drawn uniformly over the object population (metadata storms
    are breadth pathologies — every small object gets touched)."""
    arrivals = make_arrivals(
        kind, rate_rps, duration_s, seed=seed,
        burst_factor=burst_factor, burst_fraction=burst_fraction,
        burst_cycle_s=burst_cycle_s, diurnal_period_s=diurnal_period_s,
    )
    if not arrivals:
        return []
    weights = parse_meta_mix(mix)
    kinds = sorted(weights)
    p = np.array([weights[k] for k in kinds], dtype=np.float64)
    rng = _rng(seed + 0x5EED)
    kind_idx = rng.choice(len(kinds), size=len(arrivals), p=p)
    obj_idx = rng.integers(0, max(1, len(object_names)), size=len(arrivals))
    out = []
    for t, ki, oi in zip(arrivals, kind_idx, obj_idx):
        k = kinds[int(ki)]
        out.append(MetaOp(
            t=t, kind=k,
            obj=prefix if k == "list" else object_names[int(oi)],
        ))
    return out


class StormLedger:
    """Shared completion accounting. The lock is a LEAF: only counter
    arithmetic runs under it — never a backend call, a flight append or
    another lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.completed: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.bytes = 0
        self.list_items = 0
        self.first_arrival_ns: Optional[int] = None
        self.last_done_ns: Optional[int] = None

    def arrival(self, ns: int) -> None:
        with self._lock:
            if self.first_arrival_ns is None or ns < self.first_arrival_ns:
                self.first_arrival_ns = ns

    def done(self, kind: str, ns: int, *, nbytes: int = 0,
             items: int = 0, error: bool = False) -> None:
        with self._lock:
            if error:
                self.errors[kind] = self.errors.get(kind, 0) + 1
            else:
                self.completed[kind] = self.completed.get(kind, 0) + 1
                self.bytes += nbytes
                self.list_items += items
            if self.last_done_ns is None or ns > self.last_done_ns:
                self.last_done_ns = ns

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "completed": dict(self.completed),
                "errors": dict(self.errors),
                "bytes": self.bytes,
                "list_items": self.list_items,
                "first_arrival_ns": self.first_arrival_ns,
                "last_done_ns": self.last_done_ns,
            }


def _execute_op(backend, op: MetaOp, *, page_size: int, read_bytes: int,
                scratch: memoryview) -> tuple[int, int]:
    """Run one metadata op; returns (bytes_read, items_listed)."""
    if op.kind == "list":
        items = backend.list(op.obj, page_size=page_size)
        return 0, len(items)
    if op.kind == "stat":
        backend.stat(op.obj)
        return 0, 0
    # open: open_read the object head, stream it, close — the
    # open_file-binary analogue (FD churn + first-byte cost).
    reader = backend.open_read(op.obj, 0, read_bytes or None)
    got = 0
    try:
        while True:
            n = reader.readinto(scratch)
            if n <= 0:
                break
            got += n
    finally:
        reader.close()
    return got, 0


def run_storm(
    backend,
    schedule: Sequence[MetaOp],
    *,
    workers: int,
    page_size: int = 0,
    read_bytes: int = 4096,
    flight=None,
    transport_label: str = "",
    sleep: Callable[[float], None] = time.sleep,
    clock_ns: Callable[[], int] = time.perf_counter_ns,
    ledger: Optional[StormLedger] = None,
) -> dict:
    """Replay one storm schedule open-loop and measure it.

    The dispatcher walks the virtual timeline under the shared
    ``TPUBENCH_BENCH_SLEEP_SCALE`` contract (per-gap floor: a scaled-down
    run still PACES its bursts); workers drain a shared queue, so once
    service falls behind the arrival process the queue grows and
    latencies carry the backlog — exactly the open-loop saturation shape
    the knee detector looks for. Per-op latency is completion minus
    ARRIVAL (queue wait included).

    ``ledger`` injects a shared StormLedger so concurrent storm mixes
    (the drill's metadata arm and a standalone meta-storm) count
    against ONE quota ledger implementation instead of drifting
    copies; None keeps a private per-run ledger."""
    ledger = ledger if ledger is not None else StormLedger()
    recs = {
        (i, k): LatencyRecorder(f"storm{i}.{k}")
        for i in range(workers) for k in ("list", "stat", "open")
    }
    q: queue.Queue = queue.Queue()

    def worker(i: int) -> None:
        ring = flight.worker(f"storm{i}") if flight is not None else None
        scratch = memoryview(bytearray(max(4096, read_bytes or 4096)))
        while True:
            item = q.get()
            if item is None:
                return
            arrival_ns, op = item
            rec_op = (
                ring.begin(op.obj, transport_label,
                           enqueue_ns=arrival_ns, kind="meta")
                if ring is not None else None
            )
            try:
                nbytes, items = _execute_op(
                    backend, op, page_size=page_size,
                    read_bytes=read_bytes, scratch=scratch,
                )
            except Exception as e:  # noqa: BLE001 — op failure is data
                now = clock_ns()
                ledger.done(op.kind, now, error=True)
                if rec_op is not None:
                    rec_op.finish(error=e)
                continue
            now = clock_ns()
            recs[(i, op.kind)].record_ns(now - arrival_ns)
            ledger.done(op.kind, now, nbytes=nbytes, items=items)
            if rec_op is not None:
                rec_op.mark("meta_op", now)
                rec_op.finish(nbytes)

    threads = [
        threading.Thread(target=worker, args=(i,), name=f"storm-{i}",
                         daemon=True)
        for i in range(workers)
    ]
    for t in threads:
        t.start()
    scale = parse_sleep_scale("arrival gaps")
    gaps = scaled_gaps([op.t for op in schedule], scale)
    t_dispatch0 = clock_ns()
    t_dispatch1 = t_dispatch0
    due_s = 0.0
    try:
        for gap, op in zip(gaps, schedule):
            # Sleep to the arrival's due time, not the gap from the last
            # push (serve's ``_Pacer``, ROADMAP C.8): where short sleeps
            # overshoot, ``tpubench``'s overshoots add up and the storm
            # is offered less than its schedule.
            due_s += gap
            left = due_s - (clock_ns() - t_dispatch0) / 1e9
            if left > 0:
                sleep(left)
            now = clock_ns()
            ledger.arrival(now)
            q.put((now, op))
        # Dispatch ends when the LAST arrival is enqueued — stamped
        # BEFORE the worker join, or offered_rps would silently include
        # the queue-drain time and collapse to achieved_rps exactly when
        # the system falls behind (the backlog the knee detector needs).
        t_dispatch1 = clock_ns()
    finally:
        for _ in threads:
            q.put(None)
        for t in threads:
            t.join()
    snap = ledger.snapshot()
    n_ops = len(schedule)
    dispatch_wall_s = max(1e-9, (t_dispatch1 - t_dispatch0) / 1e9)
    span_s = (
        (snap["last_done_ns"] - snap["first_arrival_ns"]) / 1e9
        if snap["first_arrival_ns"] is not None
        and snap["last_done_ns"] is not None else 0.0
    )
    span_s = max(span_s, 1e-9)
    completed = sum(snap["completed"].values())
    errors = sum(snap["errors"].values())
    by_kind = {}
    for k in ("list", "stat", "open"):
        merged = merge_recorders([recs[(i, k)] for i in range(workers)])
        if merged.size:
            by_kind[k] = summarize_ns(merged).to_dict()
    all_ns = merge_recorders([r for r in recs.values()])
    overall = summarize_ns(all_ns).to_dict() if all_ns.size else None
    return {
        "ops": n_ops,
        "completed": completed,
        "errors": errors,
        "by_kind_completed": snap["completed"],
        "by_kind_errors": snap["errors"],
        "bytes": snap["bytes"],
        "list_items": snap["list_items"],
        # Wall-clock offered vs achieved: the arrival replay's own pace
        # (sleep-scaled) against the completion rate over the full
        # arrival→last-completion span — achieved < offered IS backlog.
        "offered_rps": round(n_ops / dispatch_wall_s, 3),
        "achieved_rps": round(completed / span_s, 3),
        "wall_s": round(span_s, 6),
        "p50_ms": overall["p50_ms"] if overall else None,
        "p99_ms": overall["p99_ms"] if overall else None,
        "latency": overall,
        "by_kind": by_kind,
        "sleep_scale": scale,
    }
