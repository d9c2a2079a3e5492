"""Read workload on the C++ fetch executor (``tb_pool_*``), ported from
``tpubench/workloads/fetch_executor.py``: the reference's errgroup fan-out
(``main.go:200-212``) in native code, with the client-level retry policy
(``main.go:179-184``) applied to completions and, in staged mode, the
storage→HBM pipeline fed straight from the executor.

Executor dispatch shape (``fetch_executor``): ``native`` runs the epoll
reactor (one event loop owning all connections, completions over
lock-free SPSC rings) and may fall back to the thread pool with one
warning line; ``native-reactor`` pins the reactor and raises if it cannot
engage; ``native-threads`` pins the thread-per-connection pool. Under
``transport.http2`` the reactor multiplexes the GETs as h2 streams (h2c
on plaintext, ALPN on TLS); it never falls back (the thread pool speaks
HTTP/1.1 only), and ``native-threads`` with ``http2`` is refused.

Two runners:

* :func:`run_read_native_executor` — staging "none": pure fetch fan-out,
  bodies discarded in host RAM (``io.Discard``, main.go:140). Worker *i*
  owns object ``<prefix><i>`` with one outstanding read, under a fan-out
  cap that ``tune.enabled`` makes the controller's live ``workers`` knob;
  dispatch, keep-alive, receive and timing run on native threads, Python
  only drains completions.

* :func:`run_read_native_staged` — staging "device_put": each worker's
  object is read as slot-sized byte ranges; every range is one executor
  task landing straight in a page-locked slot (socket → slot, no copy),
  and the slot goes to the GPU with one asynchronous copy on the worker's
  own CUDA stream. In validate mode the checksum kernel ``tb_checksum``
  adds the landed slot's byte sum into the worker's device accumulator.

Retry semantics (both runners): completions that classify as failures
re-enter the submit queue under the gax policy (jittered exponential
backoff, 30 s cap, x2.0; policy "always"/"idempotent"/"never"; optional
attempt cap and deadline from ``transport.retry``). Backoff pauses are
served by the completion wait's timeout, so a worker awaiting backoff
never blocks the drain loop.
"""

from __future__ import annotations

import heapq
import os
import statistics
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from tpubench_torch.config import MB, BenchConfig, RetryConfig
from tpubench_torch.device import (
    device_count,
    on_stream,
    record_event,
    resolve_device,
    worker_device,
    worker_stream,
)
from tpubench_torch.kernels import landing
from tpubench_torch.metrics import MetricSet
from tpubench_torch.metrics.recorder import LatencyRecorder
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.native.engine import PERMANENT_CODES, get_engine
from tpubench_torch.obs.exporters import metrics_session_from_config
from tpubench_torch.staging.device import new_slot
from tpubench_torch.staging.executor import copy_to_device
from tpubench_torch.storage import base_backend
from tpubench_torch.storage.gcs_http import _TRANSIENT as _TRANSIENT_HTTP
from tpubench_torch.storage.gcs_http import GcsHttpBackend
from tpubench_torch.storage.retry import Backoff


def _classify(result: int, status: int, permanent_codes) -> str:
    """'ok' | 'transient' | 'permanent' for one executor completion:
    negative engine codes split on the PERMANENT_CODES ABI (socket errnos
    and short bodies transient, protocol-shape permanent); HTTP statuses
    split on the 408/429/5xx set."""
    if result < 0:
        return "permanent" if result in permanent_codes else "transient"
    if status in (200, 206):
        return "ok"
    return "transient" if status in _TRANSIENT_HTTP else "permanent"


class RetryScheduler:
    """gax backoff over executor completions.

    Tracks per-task attempt counts and Backoff state; failed tasks are
    ``push()``ed and come back from ``pop_due()`` when their jittered pause
    elapses. ``next_due_in_ms`` feeds the completion wait's timeout so
    pauses cost no busy-waiting and never block other workers' completions.
    """

    def __init__(self, cfg: RetryConfig):
        self._cfg = cfg
        # key -> (attempts, Backoff, chain_start): deadline_s is measured
        # from each task's own first failure, not from run start.
        self._state: dict[int, tuple[int, Backoff, float]] = {}
        self._heap: list[tuple[float, int]] = []
        self.retries = 0

    def offer(self, key: int, verdict: str) -> Optional[float]:
        """The pause before task ``key`` (which failed with ``verdict``)
        retries, or None = give up (policy forbids, attempts exhausted, or
        deadline passed). Policy "always" retries any failure,
        "idempotent" only transient ones, "never" none."""
        cfg = self._cfg
        if cfg.policy == "never":
            return None
        if cfg.policy == "idempotent" and verdict != "transient":
            return None
        now = time.monotonic()
        attempts, backoff, chain_start = self._state.get(key, (0, None, now))
        if backoff is None:
            backoff = Backoff(cfg)
        attempts += 1
        if cfg.max_attempts and attempts >= cfg.max_attempts:
            return None
        pause = backoff.pause()
        if cfg.deadline_s and (now - chain_start) + pause > cfg.deadline_s:
            return None
        self._state[key] = (attempts, backoff, chain_start)
        return pause

    def push(self, key: int, pause: float) -> None:
        heapq.heappush(self._heap, (time.monotonic() + pause, key))
        self.retries += 1

    def done(self, key: int) -> None:
        self._state.pop(key, None)

    def pop_due(self) -> list[int]:
        now = time.monotonic()
        due = []
        while self._heap and self._heap[0][0] <= now:
            due.append(heapq.heappop(self._heap)[1])
        return due

    @property
    def waiting(self) -> int:
        return len(self._heap)

    def next_due_in_ms(self, cap_ms: int) -> int:
        """Completion-wait timeout: min(cap, time to the next due retry)."""
        if not self._heap:
            return cap_ms
        ms = int((self._heap[0][0] - time.monotonic()) * 1000) + 1
        return max(1, min(cap_ms, ms))


def _require_native_http(backend, fetch_executor: str):
    """Shared preconditions: the executor speaks HTTP/1.1 or, on the
    reactor, HTTP/2 over plaintext or TLS. Returns ``(engine, client)``:
    the client is the :class:`GcsHttpBackend` under the retry decorator
    (the runners need its request parts; the executor retries on its
    own). A failed engine build raises."""
    backend = base_backend(backend)
    if not isinstance(backend, GcsHttpBackend) or backend.scheme not in (
        "http", "https",
    ):
        raise ValueError(
            "fetch_executor='native' requires --protocol http (plain or "
            "https endpoint)"
        )
    engine = get_engine()
    if backend.scheme == "https" and not engine.tls_available():
        raise RuntimeError(
            "fetch_executor='native' on an https endpoint, but the engine "
            "could not load OpenSSL (libssl.so.3)"
        )
    if backend.transport.http2 and executor_mode(fetch_executor) != "reactor":
        # Only the reactor multiplexes h2 streams; the thread pool would
        # serve HTTP/1.1 under an http2 label.
        raise ValueError(
            "fetch_executor='native-threads' fetches over HTTP/1.1; "
            "http2=True needs the reactor ('native'/'native-reactor') or "
            "the Python orchestration paths"
        )
    return engine, backend


def executor_mode(fetch_executor: str) -> str:
    """Requested pool dispatch shape for a ``fetch_executor`` value:
    "native" prefers the reactor, "native-reactor"/"native-threads" pin
    it. What actually engaged is ``NativeFetchPool.mode``."""
    return "threads" if fetch_executor == "native-threads" else "reactor"


def check_executor_engaged(pool, fetch_executor: str) -> bool:
    """Fallback contract for a freshly created pool: ``native`` prefers
    the reactor but may run the thread pool (reactor creation failed),
    with one warning line; a pinned ``native-reactor`` that cannot engage
    the reactor raises. Returns whether a fallback happened."""
    requested = executor_mode(fetch_executor)
    if pool.mode == requested:
        return False
    if fetch_executor == "native-reactor":
        pool.close()
        raise RuntimeError(
            "fetch_executor='native-reactor' was pinned but the engine "
            f"engaged '{pool.mode}' (reactor creation failed) — refusing "
            "the silent downgrade"
        )
    print(
        f"tpubench_torch: warning: fetch executor fell back to "
        f"'{pool.mode}' (requested '{requested}'; "
        f"fetch_executor={fetch_executor!r})",
        file=sys.stderr,
    )
    return True


def _reactor_loops() -> int:
    """Event-loop thread count for reactor pools: one loop per ~2 usable
    cores, capped at 4."""
    cores = (
        len(os.sched_getaffinity(0))
        if hasattr(os, "sched_getaffinity")
        else os.cpu_count() or 1
    )
    return max(1, min(4, cores // 2))


def _make_pool(engine, backend: GcsHttpBackend, threads: int, cap: int,
               mode: str = "reactor"):
    """Executor pool matching the backend's endpoint: TLS from the
    endpoint scheme, verified against ``transport.tls_ca_file``; h2
    streams when the transport asks for http2 (reactor only)."""
    t = backend.transport
    return engine.pool_create(
        threads=threads,
        cap=cap,
        tls=backend.scheme == "https",
        cafile=t.tls_ca_file,
        insecure=t.tls_insecure_skip_verify,
        mode=mode,
        loops=_reactor_loops(),
        h2=bool(t.http2) and mode == "reactor",
    )


def _stamp_native_delta(res: RunResult, engine, stats0: dict) -> None:
    """Transport counter delta across the run (wire bytes, connects, and
    the completion-batching ratio pool_completions / pool_wakes)."""
    delta = {k: v - stats0.get(k, 0) for k, v in engine.stats().items()}
    if any(delta.values()):
        res.extra["native_transport"] = delta


def _wake_batch_stats(batches: list) -> Optional[dict]:
    """Per-wake completion batch sizes → their distribution."""
    if not batches:
        return None
    return {
        "wakes": len(batches),
        "p50": statistics.median(batches),
        "max": max(batches),
        "mean": round(sum(batches) / len(batches), 3),
    }


def _stamp_executor(res: RunResult, w, pool, fellback: bool,
                    wake_batches: list) -> None:
    res.extra["fetch_executor"] = w.fetch_executor
    res.extra["executor_mode"] = pool.mode
    if fellback:
        res.extra["executor_fallback"] = True
    res.extra["executor_threads"] = w.workers
    bs = _wake_batch_stats(wake_batches)
    if bs is not None:
        res.extra["completions_per_wake"] = bs


def _stamp_retries(res: RunResult, cfg: BenchConfig, retry: RetryScheduler,
                   first_error: str) -> None:
    res.extra["client_retry"] = (
        f"gax policy over completions (policy={cfg.transport.retry.policy}, "
        f"retries={retry.retries})"
    )
    res.extra["retries"] = retry.retries
    if first_error:
        res.extra["first_error"] = first_error


def run_read_native_executor(cfg: BenchConfig, backend) -> RunResult:
    """Fetch fan-out on the executor, bodies discarded in host RAM
    (``io.Discard``, main.go:140). The client retry policy applies to
    completions; the executor's one stale-connection retransmit stays
    underneath as pool hygiene."""
    engine, backend = _require_native_http(backend, cfg.workload.fetch_executor)
    w = cfg.workload
    if cfg.staging.mode != "none":
        raise ValueError(
            "run_read_native_executor is the staging='none' runner; staged "
            "ingest uses run_read_native_staged"
        )

    names = [f"{w.object_name_prefix}{i}" for i in range(w.workers)]
    # One stat per object OUTSIDE the timed window: discard mode counts
    # whatever the server streams, so without an expected size a
    # misrouted 200 would silently inflate bytes_total.
    sizes = {n: backend.stat(n).size for n in set(names)}
    metrics = MetricSet()
    recorders = [metrics.new_worker(f"w{i}") for i in range(w.workers)]
    reads_per = w.read_calls_per_worker
    total_reads = w.workers * reads_per
    if total_reads <= 0:
        res = RunResult(workload="read", config=cfg.to_dict(), summaries={})
        res.extra["fetch_executor"] = w.fetch_executor
        return res
    pool = _make_pool(engine, backend, w.workers, max(4, 2 * w.workers),
                      mode=executor_mode(w.fetch_executor))
    fellback = check_executor_engaged(pool, w.fetch_executor)
    native_stats0 = engine.stats()
    retry = RetryScheduler(cfg.transport.retry)
    bytes_total = 0
    errors = 0
    first_error = ""
    wake_batches: list = []
    # One outstanding read per logical worker, admitted through a LIVE
    # fan-out cap (the tune controller's `workers` knob): workers with
    # reads left and none in flight wait in `runnable`, and the pump
    # admits them while outstanding < active. A shrink lowers concurrency
    # and loses no read. The tag encodes the worker: wid * reads_per + seq.
    active = [w.workers]  # mutable cell: the tune workers actuator
    per_worker_next = [0] * w.workers
    runnable = deque(range(w.workers))
    outstanding = 0
    completed = 0

    def submit(tag: int) -> None:
        # NULL buffer: the pool streams the body through a per-thread
        # scratch and reports its length (discard mode).
        host, port, path, headers = backend.native_request_parts(
            names[tag // reads_per]
        )
        pool.submit_to(host, port, path, 0, 0, headers=headers, tag=tag)

    def pump() -> None:
        nonlocal outstanding
        while outstanding < active[0] and runnable:
            wid = runnable.popleft()
            submit(wid * reads_per + per_worker_next[wid])
            per_worker_next[wid] += 1
            outstanding += 1

    def handle(c: dict) -> None:
        nonlocal completed, errors, first_error, bytes_total, outstanding
        tag = c["tag"]
        wid = tag // reads_per
        read_rec, fb_rec = recorders[wid]
        verdict = _classify(c["result"], c["status"], PERMANENT_CODES)
        if verdict == "ok" and c["result"] != sizes[names[wid]]:
            # A 200 whose byte count disagrees with the object's stat size
            # is a server-side misroute or staleness, not a success.
            verdict = "transient"
        if verdict != "ok":
            pause = retry.offer(tag, verdict)
            if pause is not None:
                retry.push(tag, pause)
                return  # this read stays in flight
            retry.done(tag)
            errors += 1
            if not first_error:
                first_error = (
                    f"worker {wid}: result {c['result']} status {c['status']}"
                )
        else:
            retry.done(tag)
            read_rec.record_ns(c["total_ns"])
            if c["first_byte_ns"]:
                fb_rec.record_ns(c["first_byte_ns"] - c["start_ns"])
            bytes_total += c["result"]
        completed += 1
        outstanding -= 1
        if verdict != "ok" and w.abort_on_error:
            # errgroup semantics (main.go:200-219): the first post-retry
            # error cancels the run.
            raise RuntimeError(
                f"native fetch executor: read failed ({first_error})"
            )
        if per_worker_next[wid] < reads_per:
            runnable.append(wid)

    session = metrics_session_from_config(
        cfg, metrics, bytes_fn=lambda: bytes_total
    )
    controller = None
    tune_stats = None
    metrics.ingest.start()
    try:
        if session is not None:
            session.__enter__()
        if cfg.tune.enabled and "workers" in cfg.tune.knobs and w.workers > 1:
            from tpubench_torch.tune.controller import (
                Knob,
                RecorderSampler,
                TuneController,
            )

            controller = TuneController(
                cfg.tune,
                [Knob("workers", w.workers,
                      lambda v: active.__setitem__(0, int(v)),
                      lo=1, hi=w.workers, mode="mul")],
                RecorderSampler([r for r, _ in recorders],
                                lambda: bytes_total),
            )
            controller.start()
        pump()
        # With tuning live, the wait wakes often enough to apply a grow
        # promptly; the stall guard is wall-clock based, so shorter waits
        # do not change its meaning.
        wait_cap_ms = 100 if controller is not None else 30_000
        last_completion = time.monotonic()
        while completed < total_reads:
            for tag in retry.pop_due():
                submit(tag)
            pump()
            cs = pool.next_batch(timeout_ms=retry.next_due_in_ms(wait_cap_ms))
            if not cs:
                if retry.waiting:
                    continue  # the timeout was a backoff pause elapsing
                if time.monotonic() - last_completion > 120:
                    raise RuntimeError("native fetch executor stalled (120s)")
                continue
            last_completion = time.monotonic()
            wake_batches.append(len(cs))
            for c in cs:
                handle(c)
    finally:
        if controller is not None:
            tune_stats = controller.stop()
        # Stop the clock before teardown (thread joins must not bias the
        # measured window).
        metrics.ingest.stop()
        metrics.ingest.bytes = bytes_total
        if session is not None:
            session.__exit__(None, None, None)  # guaranteed final flush
        pool.close()

    res = RunResult(
        workload="read",
        config=cfg.to_dict(),
        bytes_total=bytes_total,
        wall_seconds=metrics.ingest.seconds,
        gbps=metrics.ingest.gbps(),
        gbps_per_chip=metrics.ingest.gbps(),
        n_chips=1,
        summaries=metrics.summaries(),
        errors=errors,
    )
    _stamp_executor(res, w, pool, fellback, wake_batches)
    _stamp_native_delta(res, engine, native_stats0)
    _stamp_retries(res, cfg, retry, first_error)
    if tune_stats is not None:
        res.extra["tune"] = tune_stats
    if session is not None:
        res.extra["metrics_export"] = session.summary()
    return res


class _SlotPipeline:
    """Per-worker staging ring fed by the executor: ``depth`` slots cycle
    FREE → FETCHING (a range GET lands in the slot) → TRANSFER (an
    asynchronous copy to the worker's device on the worker's own CUDA
    stream, and in validate mode the checksum kernel after it) → FREE.

    Slots are ``(slot_bytes // lane, lane)`` uint8 tensors, page-locked
    on CUDA (a copy from pageable memory would be synchronous); the
    executor lands bytes at ``addresses[k]``, the slot's ``data_ptr()``.
    A slot returns to ``free`` only in :meth:`complete`, which the runner
    calls once the event recorded after the slot's copy (and checksum) has
    fired — never when the copy call returns."""

    def __init__(self, worker_id: int, slot_bytes: int, depth: int,
                 lane: int, device, validate: bool, pinned: bool = True):
        self.device = worker_device(device, worker_id)
        self.stream = worker_stream(self.device, worker_id)
        self._slot_bytes = slot_bytes
        pinned = pinned and self.device.type == "cuda"
        self.slots = [
            new_slot((slot_bytes // lane, lane), pinned) for _ in range(depth)
        ]
        self._flat = [s.numpy().reshape(-1) for s in self.slots]
        self.addresses = [s.data_ptr() for s in self.slots]
        self.free = list(range(depth))
        self.stage_recorder = LatencyRecorder(f"w{worker_id}/stage")
        self.staged_bytes = 0
        self.transfers = 0
        self._validate = validate
        self._host_sum = 0
        self._dev_sum: Optional[torch.Tensor] = None
        if validate:
            with on_stream(self.stream):
                self._dev_sum = landing.new_acc(self.device)

    def launch(self, slot: int, nbytes: int):
        """Enqueue the slot's copy (and checksum); returns ``(handle,
        submit_ns, nbytes)`` where ``handle`` is ``(landed, event)``.
        A partial slot (object tail) is zeroed past ``nbytes`` and shipped
        whole, so the landed shape stays fixed and the device sum sees
        only real bytes; full slots skip the memset."""
        flat = self._flat[slot]
        if nbytes < self._slot_bytes:
            flat[nbytes:] = 0
        if self._validate:
            self._host_sum += int(flat[:nbytes].sum(dtype=np.uint64))
        submit_ns = time.perf_counter_ns()
        with on_stream(self.stream):
            landed = copy_to_device(self.slots[slot], self.device)
            if self._validate:
                landing.checksum(landed, self._dev_sum)
            done = record_event(self.stream)
        self.transfers += 1
        if self._validate:
            # Validation trades overlap for integrity, as in tpubench: the
            # slot's copy and checksum complete before the next completion
            # is handled (a wait on this event, never on the device).
            done.synchronize()
        return (landed, done), submit_ns, nbytes

    def complete(self, slot: int, submit_ns: int, nbytes: int) -> None:
        self.stage_recorder.record_ns(time.perf_counter_ns() - submit_ns)
        self.staged_bytes += nbytes
        self.free.append(slot)

    def sums(self) -> tuple[int, int]:
        """(device sum, host sum) of every byte launched, mod 2³²."""
        with on_stream(self.stream):
            dev = landing.acc_value(self._dev_sum)
        return dev, self._host_sum % (1 << 32)

    def checksum(self) -> Optional[bool]:
        if not self._validate:
            return None
        dev, host = self.sums()
        return dev == host


def run_read_native_staged(cfg: BenchConfig, backend,
                           device="cuda") -> RunResult:
    """Staged ingest with no Python in the fetch hot loop.

    Each worker's object is read as a sequence of slot-sized byte ranges
    (``Range: bytes=a-b``); every range is one executor task landing bytes
    in a staging slot. On completion Python enqueues the slot's one
    asynchronous copy and resubmits the next range into a free slot —
    fetch (native threads) and host→device copies overlap, bounded by
    ``staging.depth`` slots per worker. Reads of one worker stay
    sequential (main.go:127-153); ranges within a read fetch concurrently.
    """
    engine, backend = _require_native_http(backend, cfg.workload.fetch_executor)
    w = cfg.workload
    s = cfg.staging
    if s.mode != "device_put":
        raise ValueError(
            "fetch_executor='native' staged ingest supports staging "
            "'device_put' (pallas staging rides the Python orchestration "
            "paths)"
        )
    lane = s.lane
    # >= 2 slots per worker for fetch/transfer overlap; config depth sets
    # the ceiling.
    depth = max(2, s.depth)
    # Slot size under the host budget, with no granule floor: the slot IS
    # the fetch unit (one range GET per slot), so any lane multiple works.
    budget = max(1, s.host_budget_mb) * MB
    per_worker = budget // max(1, w.workers * depth)
    slot_bytes = max(lane, min(s.slot_bytes, per_worker))
    slot_bytes = (slot_bytes + lane - 1) // lane * lane

    names = [f"{w.object_name_prefix}{i}" for i in range(w.workers)]
    sizes = [backend.stat(n).size for n in names]
    reads_per = w.read_calls_per_worker
    total_reads = w.workers * reads_per
    metrics = MetricSet()
    recorders = [metrics.new_worker(f"w{i}") for i in range(w.workers)]
    if total_reads <= 0 or sum(sizes) == 0:
        res = RunResult(workload="read", config=cfg.to_dict(), summaries={})
        res.extra["fetch_executor"] = w.fetch_executor
        return res

    n_chips = device_count(resolve_device(device))
    pipes = [
        _SlotPipeline(i, slot_bytes, depth, lane, device,
                      s.validate_checksum, pinned=s.native_slots)
        for i in range(w.workers)
    ]

    class _W:  # per-worker read-progress state machine
        __slots__ = ("call", "next_off", "ranges_out", "t0", "first_fb", "failed")

    ws = []
    completed_upfront = 0
    for i in range(w.workers):
        st = _W()
        st.call = 0          # current read-call index
        st.next_off = 0      # next unsubmitted byte offset of this call
        st.ranges_out = 0    # in-flight (or retrying) ranges of this call
        st.t0 = 0            # perf_counter_ns at first submit of this call
        st.first_fb = False  # first byte recorded for this call
        st.failed = False    # this call had a post-retry range failure
        if sizes[i] == 0:
            # Zero-length object: every read completes trivially.
            st.call = reads_per
            completed_upfront += reads_per
        ws.append(st)

    pool = _make_pool(engine, backend, w.workers, max(8, 2 * w.workers * depth),
                      mode=executor_mode(w.fetch_executor))
    fellback = check_executor_engaged(pool, w.fetch_executor)
    native_stats0 = engine.stats()
    retry = RetryScheduler(cfg.transport.retry)
    wake_batches: list = []
    inflight: dict[int, tuple] = {}  # tag -> (wid, slot, start, length)
    # Per-worker transfer FIFOs: completion is in order on one stream,
    # not across workers — one global queue would block every worker
    # behind one slow copy.
    transfers: list[deque] = [deque() for _ in range(w.workers)]
    transfers_n = 0
    next_tag = 0
    bytes_total = 0
    errors = 0
    first_error = ""
    completed_reads = completed_upfront

    def submit(tag: int) -> None:
        wid, slot, start, length = inflight[tag]
        # Headers rebuilt per attempt (request parts are per request).
        host, port, path, headers = backend.native_request_parts(names[wid])
        headers += f"Range: bytes={start}-{start + length - 1}\r\n"
        pool.submit_to(
            host, port, path, pipes[wid].addresses[slot], length,
            headers=headers, tag=tag,
        )

    def submit_range(wid: int) -> None:
        nonlocal next_tag
        st = ws[wid]
        slot = pipes[wid].free.pop()
        start = st.next_off
        length = min(slot_bytes, sizes[wid] - start)
        if st.next_off == 0 and st.ranges_out == 0:
            st.t0 = time.perf_counter_ns()
            st.first_fb = False
        st.next_off += length
        st.ranges_out += 1
        tag = next_tag
        next_tag += 1
        inflight[tag] = (wid, slot, start, length)
        submit(tag)

    def finish_transfer(wid: int) -> None:
        nonlocal transfers_n
        slot, _, submit_ns, nbytes = transfers[wid].popleft()
        pipes[wid].complete(slot, submit_ns, nbytes)
        transfers_n -= 1

    def drain_ready_transfers() -> None:
        # event.query() is the non-blocking completion probe: a slot is
        # freed only once the event after its copy (and checksum) fired.
        for wid in range(w.workers):
            q = transfers[wid]
            while q and q[0][1][1].query():
                finish_transfer(wid)

    def drain_one_transfer_blocking() -> None:
        # Wait on the oldest in-flight transfer across workers (queue
        # heads only: within a worker completion is FIFO).
        wid = min(
            (i for i in range(w.workers) if transfers[i]),
            key=lambda i: transfers[i][0][2],
        )
        transfers[wid][0][1][1].synchronize()
        finish_transfer(wid)

    def can_submit(wid: int) -> bool:
        # A call's next range needs a free slot; the next call starts only
        # when this one's fetches all settled (serial reads per worker).
        st = ws[wid]
        return (st.call < reads_per and bool(pipes[wid].free)
                and st.next_off < sizes[wid])

    def handle(c: dict) -> None:
        nonlocal bytes_total, errors, first_error, completed_reads, transfers_n
        tag = c["tag"]
        wid, slot, start, length = inflight[tag]
        st = ws[wid]
        pipe = pipes[wid]
        verdict = _classify(c["result"], c["status"], PERMANENT_CODES)
        if verdict == "ok" and c["result"] != length:
            # A honored range is exactly `length` bytes; anything else is a
            # protocol-shape failure (the server ignored the range).
            verdict = "permanent"
        if verdict != "ok":
            pause = retry.offer(tag, verdict)
            if pause is not None:
                retry.push(tag, pause)
                return  # the slot stays owned by the retrying task
            if not st.failed:
                errors += 1  # one error per failed read, not per range
            if not first_error:
                first_error = (
                    f"worker {wid} range {start}+{length}: "
                    f"result {c['result']} status {c['status']}"
                )
            del inflight[tag]
            retry.done(tag)
            pipe.free.append(slot)
            # Abandon this call: it completes (as a failed read) when its
            # in-flight ranges settle.
            st.next_off = sizes[wid]
            st.failed = True
            st.ranges_out -= 1
            if w.abort_on_error:
                raise RuntimeError(
                    f"staged executor: read failed ({first_error})"
                )
        else:
            retry.done(tag)
            del inflight[tag]
            if not st.first_fb and c["first_byte_ns"]:
                recorders[wid][1].record_ns(c["first_byte_ns"] - c["start_ns"])
                st.first_fb = True
            bytes_total += length
            st.ranges_out -= 1
            transfers[wid].append((slot,) + pipe.launch(slot, length))
            transfers_n += 1
        if st.next_off >= sizes[wid] and st.ranges_out == 0:
            if not st.failed:
                # Failed reads count in `errors`, not in the histogram.
                recorders[wid][0].record_ns(time.perf_counter_ns() - st.t0)
            completed_reads += 1
            st.call += 1
            st.next_off = 0 if st.call < reads_per else sizes[wid]
            st.failed = False

    session = metrics_session_from_config(
        cfg, metrics, bytes_fn=lambda: bytes_total
    )
    metrics.ingest.start()
    last_progress = time.monotonic()
    try:
        if session is not None:
            session.__enter__()
        while completed_reads < total_reads:
            if inflight and time.monotonic() - last_progress > 120:
                raise RuntimeError("staged executor stalled (120s)")
            for tag in retry.pop_due():
                submit(tag)
            drain_ready_transfers()
            for wid in range(w.workers):
                while can_submit(wid):
                    submit_range(wid)
            if not inflight and not retry.waiting:
                if transfers_n:
                    drain_one_transfer_blocking()
                    continue
                if any(can_submit(i) for i in range(w.workers)):
                    continue
                raise RuntimeError("staged executor: no runnable work left")
            # Keep the wait short while copies are pending, so their slots
            # come back promptly behind a slow fetch.
            cap_ms = 5 if transfers_n else 100
            cs = pool.next_batch(timeout_ms=retry.next_due_in_ms(cap_ms))
            if not cs:
                continue
            last_progress = time.monotonic()
            wake_batches.append(len(cs))
            for c in cs:
                handle(c)
        # All fetches done; the remaining copies land inside the timed
        # window (staged bandwidth counts transfer completion).
        while transfers_n:
            drain_one_transfer_blocking()
    finally:
        metrics.ingest.stop()
        metrics.ingest.bytes = bytes_total
        for pipe in pipes:
            metrics.stage_latency.append(pipe.stage_recorder)
        if session is not None:
            session.__exit__(None, None, None)
        # Drain before free: in-flight fetches (native threads) and
        # in-flight copies may still touch the slots. close() joins the
        # executor's threads; then every pending event is waited on
        # before any slot tensor is dropped.
        pool.close()
        for q in transfers:
            for _, handle_, _, _ in q:
                try:
                    handle_[1].synchronize()
                except RuntimeError:
                    pass  # a failed copy has settled; freeing is now safe
            q.clear()

    wall = metrics.ingest.seconds
    staged = sum(p.staged_bytes for p in pipes)
    gbps = metrics.ingest.gbps()
    res = RunResult(
        workload="read",
        config=cfg.to_dict(),
        bytes_total=bytes_total,
        wall_seconds=wall,
        gbps=gbps,
        gbps_per_chip=gbps / max(1, n_chips),
        n_chips=n_chips,
        summaries=metrics.summaries(),
        errors=errors,
    )
    _stamp_executor(res, w, pool, fellback, wake_batches)
    _stamp_native_delta(res, engine, native_stats0)
    res.extra["staging_zero_copy"] = True
    res.extra["staged_bytes"] = staged
    res.extra["staged_gbps"] = (staged / 1e9) / wall if wall > 0 else 0.0
    res.extra["staged_gbps_per_chip"] = res.extra["staged_gbps"] / max(1, n_chips)
    res.extra["slot_bytes"] = slot_bytes
    res.extra["depth"] = depth
    _stamp_retries(res, cfg, retry, first_error)
    if s.validate_checksum:
        res.extra["checksum_ok"] = all(p.checksum() is True for p in pipes)
    if session is not None:
        res.extra["metrics_export"] = session.summary()
    return res
