"""Readahead prefetcher: walk the workload's future access plan and warm
the chunk cache ahead of the consumer (a copy of
``tpubench/pipeline/prefetch.py``).

The access plan is the ordered list of :class:`~tpubench_torch.pipeline.cache.
ChunkKey`\\ s the workload will consume (train-ingest knows its epoch
schedule up front — the property real input pipelines exploit). The
prefetcher keeps a bounded readahead window ``[cursor, cursor+depth)``
scheduled on a small worker pool; reads go through the ordinary
``open_backend`` stack, so hedging, the stall watchdog, the circuit
breaker and retry all compose underneath readahead exactly as they do
under demand reads.

Priority is plan order (a min-heap on plan index): the next-needed chunk
is always fetched before deeper readahead, so a slow backend degrades to
"barely ahead of the consumer", never to "busy fetching step N+8 while
step N+1 starves". Two safety valves bound memory:

* ``readahead_bytes`` — scheduled + cached-but-unconsumed prefetched
  bytes never exceed it;
* cancel-on-eviction — when the cache reports prefetched-unused bytes
  being evicted (budget thrash: readahead outran the cache), the
  effective depth halves, creeping back up one chunk per thrash-free
  advance. Queued entries behind the consumer's cursor are cancelled on
  every advance.

Demand misses are NOT queued here — the consumer fetches them on its own
thread through the cache's single-flight path, which coalesces with any
in-flight prefetch of the same chunk (so a demand read never waits behind
pool scheduling, and a half-done prefetch is joined, not duplicated).
"""

from __future__ import annotations

import heapq
import threading
from typing import Callable, Optional, Sequence

from tpubench_torch.mem.slab import CopyMeter, SlabPool, release_payload
from tpubench_torch.obs import flight as _flight
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.storage.base import StorageError


def _stream_into(backend, key: ChunkKey, mv: memoryview) -> None:
    """Stream ``key``'s exact byte range through the backend stack into
    caller memory (slab or bytearray — the ONE read shape both A/B arms
    and both the demand and prefetch paths measure).

    When the transport surfaces the served object's generation
    (``reader.generation`` — the fake backend and the h1.1 JSON-API
    HTTP client do, from ``x-goog-generation``; forwarded through every
    wrapper reader), a mismatch with the plan's keyed generation is a
    hard error: the object was overwritten after the plan was built,
    and caching these bytes under the stale key would poison the cache
    with content that doesn't match its key. The caller's remedy is to
    rebuild the plan (re-stat), not to retry. Transports that don't
    surface response headers (the native h2/receive engine paths) read
    ``generation=None`` = *unknown*: enforcement degrades to plan-build
    keying there — a documented scope line, not a silent guarantee."""
    reader = backend.open_read(key.object, start=key.start, length=key.length)
    got = 0
    try:
        while got < key.length:
            n = reader.readinto(mv[got:])
            if n <= 0:
                break
            got += n
    finally:
        fb = getattr(reader, "first_byte_ns", None)
        if fb:
            _flight.note_phase("first_byte", fb)
        reader.close()
    gen = getattr(reader, "generation", None)
    if gen and key.generation and gen != key.generation:
        raise StorageError(
            f"{key.object}: generation changed under the plan "
            f"({key.generation} -> {gen}); rebuild the access plan",
            transient=False,
        )
    if got != key.length:
        raise IOError(
            f"{key.object} [{key.start}:+{key.length}]: short chunk read "
            f"{got}/{key.length}"
        )


def read_chunk(backend, key: ChunkKey,
               meter: Optional[CopyMeter] = None) -> bytes:
    """The legacy ``bytes`` chunk read (the A/B baseline arm): wire →
    scratch bytearray (one write), then a full ``bytes`` materialization
    (a second write of every byte) — exactly the copy tax the slab path
    (:func:`fetch_chunk`) exists to delete."""
    buf = bytearray(key.length)
    _stream_into(backend, key, memoryview(buf))
    if meter is not None:
        meter.landed(key.length)
        meter.copied(key.length)  # the bytes() below re-writes every byte
    return bytes(buf)


def fetch_chunk(backend, key: ChunkKey, pool: Optional[SlabPool] = None,
                meter: Optional[CopyMeter] = None):
    """One chunk fetch, zero-copy when a slab pool is given: the backend
    stack ``readinto``\\ s the wire bytes straight into a leased slab and
    the LEASE is the payload — the cache stores it, the consumer stages
    its view in place, and nothing re-copies. Returns the caller-owned
    payload (``SlabLease`` with refcount 1, or ``bytes`` without a
    pool); any failure mid-chunk releases the lease back to the pool
    before propagating — chaos faults must never leak slabs."""
    if pool is None:
        return read_chunk(backend, key, meter=meter)
    lease = pool.lease(key.length)
    if lease.overflow:
        # Pool-pressure breadcrumb on the read's flight record: sustained
        # overflow means --pool-slabs is undersized for the working set.
        _flight.annotate("slab", event="overflow")
    try:
        _stream_into(backend, key, lease.view())
    except BaseException:
        lease.release()
        raise
    if meter is not None:
        meter.landed(key.length)  # wire → slab: the one and only write
    return lease


class Prefetcher:
    """Plan-walking readahead over a :class:`ChunkCache` (module doc)."""

    def __init__(
        self,
        backend,
        cache: ChunkCache,
        plan: Sequence[ChunkKey],
        *,
        workers: int = 2,
        depth: int = 8,
        byte_budget: int = 0,
        transport: str = "",
        pool: Optional[SlabPool] = None,
        meter: Optional[CopyMeter] = None,
        max_workers: int = 0,
        fetch_fn: Optional[Callable[[ChunkKey], object]] = None,
        owners: Optional[Sequence[Optional[str]]] = None,
        owner_budgets: Optional[dict] = None,
    ):
        self._backend = backend
        self._cache = cache
        self._pool = pool
        self._meter = meter
        # Routed miss fetch (the cooperative cache's peer-first path):
        # when given, readahead misses resolve through it instead of a
        # direct origin read — the prefetcher warms the cache through
        # the SAME owner-routing/single-flight the demand path uses.
        self._fetch_fn = fetch_fn
        self._plan = list(plan)
        # QoS (serve plane): owners[i] tags plan[i] with its tenant
        # class; owner_budgets bounds each class's scheduled+in-flight
        # prefetch bytes — one greedy class can't monopolize the
        # readahead window. Over-budget items are SKIPPED (not a window
        # barrier): other classes' items behind them still schedule.
        self._owners = list(owners) if owners is not None else None
        if self._owners is not None and len(self._owners) != len(self._plan):
            raise ValueError(
                f"prefetch owners length {len(self._owners)} != plan "
                f"length {len(self._plan)}"
            )
        self._owner_budgets = dict(owner_budgets or {})
        self._owner_out: dict[str, int] = {}
        self.owner_budget_skips = 0
        # Indices already counted as budget-skipped: _fill_locked
        # re-scans the window on every advance()/completion, so without
        # this a single persistently-over-budget item would re-count on
        # every pass (the per-tick re-count bug class).
        self._owner_skip_seen: set[int] = set()
        self._depth = max(0, depth)
        self._depth_effective = self._depth
        self._budget = max(0, byte_budget)
        self._transport = transport
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._heap: list[tuple[int, ChunkKey]] = []
        self._scheduled: set[int] = set()  # queued or fetching
        self._cursor = 0
        self._inflight_bytes = 0
        self._stop = False
        self._wasted_seen = 0
        # Counters (the extra["pipeline"]["prefetch"] stamp).
        self.issued = 0
        self.completed = 0
        self.cancelled = 0
        self.skipped = 0  # already cached/in-flight at pop time
        self.errors = 0
        self.last_error: Optional[str] = None
        self.depth_clamps = 0  # cancel-on-eviction engagements
        # Flight rings are bound HERE, on the constructing thread, while
        # the run's recorder activation is known-live — a worker thread
        # resolving the ambient recorder at its own start time could race
        # the activation scope and silently record nothing.
        # max_workers pre-spawns a larger pool with only `workers` of it
        # ACTIVE (the rest park on the condvar): the tune controller's
        # prefetch_workers knob then grows/shrinks the live set without
        # ever spawning mid-run.
        n_active = max(1, workers) if self._depth else 0
        n_threads = max(n_active, max_workers) if self._depth else 0
        self._active_workers = n_active
        self._threads = [
            threading.Thread(
                target=self._worker,
                args=(i, _flight.active_worker(f"prefetch-{i}")),
                name=f"prefetch-{i}", daemon=True,
            )
            for i in range(n_threads)
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- control --
    def advance(self, pos: int) -> None:
        """The consumer reached plan position ``pos``: drop stale queue
        entries, apply the eviction thrash-guard, and top the readahead
        window back up (within the byte budget)."""
        if not self._depth:
            return
        with self._cond:
            self._cursor = max(self._cursor, pos)
            # Cancel-on-eviction: prefetched-unused bytes being evicted
            # means readahead outran the cache budget — halve the window.
            wasted = self._cache.prefetch_wasted_bytes
            if wasted > self._wasted_seen:
                self._wasted_seen = wasted
                if self._depth_effective > 1:
                    self._depth_effective = max(1, self._depth_effective // 2)
                    self.depth_clamps += 1
            elif self._depth_effective < self._depth:
                self._depth_effective += 1
            self._fill_locked()
            self._cond.notify_all()

    def _owner_of(self, i: int) -> Optional[str]:
        return self._owners[i] if self._owners is not None else None

    def _sched_add_locked(self, i: int, key: ChunkKey) -> None:
        self._scheduled.add(i)
        o = self._owner_of(i)
        if o is not None:
            self._owner_out[o] = self._owner_out.get(o, 0) + key.length

    def _sched_drop_locked(self, i: int) -> None:
        """A scheduled item left the system (fetched, cancelled, or
        stale): release its owner's outstanding-byte charge with its
        scheduled-set slot — the two must move together or a class's
        budget slowly leaks shut."""
        if i in self._scheduled:
            self._scheduled.discard(i)
            o = self._owner_of(i)
            if o is not None:
                left = self._owner_out.get(o, 0) - self._plan[i].length
                if left > 0:
                    self._owner_out[o] = left
                else:
                    self._owner_out.pop(o, None)

    def _fill_locked(self) -> None:
        hi = min(len(self._plan), self._cursor + self._depth_effective)
        for i in range(self._cursor, hi):
            if i in self._scheduled:
                continue
            key = self._plan[i]
            if self._budget and (
                self._outstanding_locked() + key.length > self._budget
            ):
                break
            if self._cache.contains(key):
                # Residency first: an already-cached item was never a
                # budget casualty and must not count as one.
                continue
            o = self._owner_of(i)
            if o is not None:
                b = self._owner_budgets.get(o)
                if b and self._owner_out.get(o, 0) + key.length > b:
                    # Per-class budget: skip, don't break — the window
                    # keeps filling with OTHER classes' items. Each
                    # plan item counts as ONE skip no matter how many
                    # re-scans defer it.
                    if i not in self._owner_skip_seen:
                        self._owner_skip_seen.add(i)
                        self.owner_budget_skips += 1
                    continue
            self._sched_add_locked(i, key)
            heapq.heappush(self._heap, (i, key))

    def reclamp(self, depth: Optional[int] = None,
                byte_budget: Optional[int] = None) -> None:
        """Live depth/byte-budget re-clamp (the tune controller's
        readahead actuation — no restart). A shrink drops QUEUED entries
        beyond the new window (counted as cancelled; in-flight fetches
        complete and land through the normal cache-insert accounting, so
        the resident-unused counter stays exact — nothing is stranded);
        growth takes effect immediately by re-filling the window."""
        if not self._depth:
            return  # constructed cold (no worker threads): knob is inert
        with self._cond:
            if depth is not None:
                depth = max(1, int(depth))
                if depth < self._depth:
                    hi = self._cursor + depth
                    keep = [(i, k) for i, k in self._heap if i < hi]
                    for i, _ in self._heap:
                        if i >= hi:
                            self._sched_drop_locked(i)
                            self.cancelled += 1
                    self._heap = keep
                    heapq.heapify(self._heap)
                grow = depth > self._depth
                self._depth = depth
                if grow:
                    # A commanded grow resets the thrash clamp: the
                    # controller asked for the window NOW; eviction
                    # waste re-clamps it if the cache disagrees.
                    self._depth_effective = depth
                else:
                    # Shrink: the clamp (if tighter) survives.
                    self._depth_effective = max(
                        1, min(self._depth_effective, depth)
                    )
            if byte_budget is not None:
                self._budget = max(0, int(byte_budget))
            self._fill_locked()
            self._cond.notify_all()

    def set_workers(self, n: int) -> None:
        """Live worker fan-out: activate the first ``n`` of the
        pre-spawned pool (parked threads resume on the condvar; threads
        beyond the active count finish their current fetch, then park)."""
        with self._cond:
            self._active_workers = max(1, min(int(n), len(self._threads)))
            self._cond.notify_all()

    @property
    def active_workers(self) -> int:
        return self._active_workers

    def _outstanding_locked(self) -> int:
        # prefetch_resident_unused is the cache's directly-maintained
        # count (not a derived identity over insert/use/waste counters,
        # which drop paths like stale-rejects would silently skew).
        queued = sum(k.length for _, k in self._heap)
        return (
            max(0, self._cache.prefetch_resident_unused)
            + self._inflight_bytes + queued
        )

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._threads:
            t.join()

    # -------------------------------------------------------------- worker --
    def _worker(self, widx: int, wf) -> None:
        while True:
            with self._cond:
                # Parked workers (widx >= the live fan-out) wait without
                # popping; set_workers() wakes them when the controller
                # grows the pool back.
                while (not self._heap or widx >= self._active_workers) \
                        and not self._stop:
                    self._cond.wait()
                if self._stop:
                    # Shutdown cancels queued readahead — close() must
                    # not sit through deep-window fetches nobody will
                    # ever consume.
                    while self._heap:
                        i, _ = heapq.heappop(self._heap)
                        self._sched_drop_locked(i)
                        self.cancelled += 1
                    return
                idx, key = heapq.heappop(self._heap)
                if idx < self._cursor:
                    self._sched_drop_locked(idx)
                    self.cancelled += 1
                    continue
                self._inflight_bytes += key.length
                self.issued += 1
            op = None
            try:
                if self._cache.contains(key):
                    # Already cached or in flight: nothing to do, and no
                    # flight record either — a zero-byte ~0 ms "read"
                    # would dilute every percentile downstream (the
                    # chaos scorecard sums kind="read" records).
                    with self._lock:
                        self.skipped += 1
                    continue
                op = (
                    wf.begin(key.object, self._transport)
                    if wf is not None else None
                )
                if op is not None:
                    op.mark("prefetch_issue")
                data, source = self._cache.get_or_fetch_info(
                    key,
                    (lambda: self._fetch_fn(key))
                    if self._fetch_fn is not None
                    else lambda: fetch_chunk(
                        self._backend, key,
                        pool=self._pool, meter=self._meter,
                    ),
                    origin="prefetch", consumer=False,
                    owner=self._owner_of(idx),
                )
                if source == "fetched":
                    nbytes = len(data)
                    # The worker's own (leaser) reference: the cache took
                    # its reference at insert — the prefetcher does not
                    # consume, so it lets go here. A refused insert
                    # (stale generation / oversize) retires the slab
                    # right now instead of leaking it.
                    release_payload(data)
                    with self._lock:
                        self.completed += 1
                    if op is not None:
                        op.mark("body_complete")
                        op.finish(nbytes)
                else:
                    # A demand read claimed the chunk between the
                    # contains() probe and the fetch (hit or joined
                    # in-flight): that read's record carries the bytes
                    # and the wait — appending one here would both
                    # double-count and dilute percentiles. Drop the op.
                    with self._lock:
                        self.skipped += 1
                    if op is not None:
                        op.abandon()
            except Exception as exc:  # noqa: BLE001 — best-effort layer
                # Prefetch is advisory: the error is recorded, the chunk
                # stays uncached, and the demand path (with its own retry
                # stack) surfaces any real failure to the workload.
                with self._lock:
                    self.errors += 1
                    self.last_error = f"{type(exc).__name__}: {exc}"
                if op is not None:
                    op.finish(error=exc)
            finally:
                with self._cond:
                    self._inflight_bytes -= key.length
                    self._sched_drop_locked(idx)

    # --------------------------------------------------------------- stats --
    def stats(self) -> dict:
        used = self._cache.prefetch_used_bytes
        # Everything prefetched that never served a consumer is waste,
        # whatever dropped it: LRU eviction, never-cached (oversize/
        # stale-reject), generation invalidation, or still sitting
        # unused at end of run.
        wasted = (
            self._cache.prefetch_wasted_bytes
            + self._cache.prefetch_dropped_bytes
            + self._cache.prefetch_invalidated_bytes
            + self._cache.unused_prefetched_bytes()
        )
        denom = used + wasted
        return {
            "depth": self._depth,
            "depth_effective": self._depth_effective,
            "workers": self._active_workers,
            "workers_max": len(self._threads),
            "issued": self.issued,
            "completed": self.completed,
            "cancelled": self.cancelled,
            "skipped": self.skipped,
            "errors": self.errors,
            "last_error": self.last_error,
            "depth_clamps": self.depth_clamps,
            "owner_budget_skips": self.owner_budget_skips,
            "prefetched_bytes": self._cache.prefetch_inserted_bytes,
            "used_bytes": used,
            "wasted_bytes": wasted,
            "efficiency": (used / denom) if denom else None,
        }
