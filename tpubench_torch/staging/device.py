"""Host→device staging with a slot ring + granule aggregation
(``tpubench/staging/device.py``).

Pipeline shape (per worker): the fetcher fills host slot *k* while slots
*k-1, k-2, …* are in flight to the device — fetch ∥ copy overlap, bounded
by ``depth`` (backpressure blocks the fetcher when every slot is in
flight). Depth > 1 rides the overlapped executor
(:mod:`tpubench_torch.staging.executor`): a depth-K window whose reaper
thread submits and completes copies OUT OF ORDER. Depth 1 and validation
keep the serial inline ring: submit, then complete on the fetch thread at
the next acquire of the same slot.

Granule aggregation: fetch granules (2 MB, main.go:123-125) are packed
into ``slot_bytes``-sized slots and shipped with ONE copy per slot; the
fetch granule stays small (socket-sized reads, fine-grained first-byte
stamps), only the shipping unit grows. Slots are fixed-size and
lane-aligned, ``(slot_bytes // lane, lane) uint8``.

Slots are page-locked on CUDA (``pin_memory=True``): an asynchronous copy
from pageable memory is synchronous, which would silently turn the window
serial. The fetcher fills a slot through ``slot.numpy()`` → ``memoryview``.
A slot is refilled only after the event recorded after its copy has
completed — never when the copy call returns.

Each stager runs its copies and kernels on its worker's own CUDA stream
(:func:`tpubench_torch.device.worker_stream`), so ordering between a
slot's copy and its checksum is implicit, and 48 workers neither
serialize on the default stream nor share a pooled one.

Integrity (``validate_checksum``): the checksum kernel adds each landed
slot's mod-2³² byte sum into a device accumulator, compared at finish with
the host-side sum of the fetched bytes. Partial slots are zero-padded at
launch so the device sum sees only real bytes.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpubench_torch.config import BenchConfig, StagingConfig
from tpubench_torch.device import (
    device_count,
    on_stream,
    record_event,
    worker_device,
    worker_stream,
)
from tpubench_torch.kernels import landing
from tpubench_torch.mem.slab import SlabLease
from tpubench_torch.metrics.recorder import LatencyRecorder
from tpubench_torch.obs import flight as _flight
from tpubench_torch.obs.profiling import hot_region
from tpubench_torch.staging.executor import (
    InflightWindow,
    TransferEngine,
    copy_to_device,
)
from tpubench_torch.staging.stats import staging_efficiency


# The profiler region of a fetch thread blocked on the device (the
# stagers' ``transfer_wait_ns``).
TRANSFER_WAIT = "staging/transfer_wait"


def new_slot(shape: tuple, pinned: bool) -> torch.Tensor:
    """A zeroed host slot; page-locked when ``pinned``."""
    slot = torch.empty(shape, dtype=torch.uint8, pin_memory=pinned)
    slot.zero_()
    if pinned and not slot.is_pinned():
        raise RuntimeError("staging slot is not page-locked")
    return slot


class GranuleAggregator:
    """Shared zero-copy sink protocol: granules pack into ``_slot_bytes``
    slots; one ``_launch()`` per slot ships it. Concrete stagers provide
    ``_launch`` (ship the first ``_fill`` bytes of the current slot and
    reset ``_fill``), ``_free_view`` (memoryview of the current slot from
    ``_fill``), and optionally ``_precommit(n)`` (inspect the next ``n``
    committed bytes before the fill mark moves)."""

    _fill: int
    _granule: int
    _slot_bytes: int

    def _launch(self) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _free_view(self) -> memoryview:  # pragma: no cover - abstract
        raise NotImplementedError

    def _precommit(self, n: int) -> None:
        pass

    def acquire(self) -> memoryview:
        """At least one granule of free slot space; a slot whose remainder
        is smaller than a granule ships now (slightly under-full) — the
        fetcher is never asked to do sub-granule socket reads."""
        if self._slot_bytes - self._fill < self._granule and self._fill > 0:
            self._launch()
        return self._free_view()

    def commit(self, n: int) -> None:
        """Advance the fill mark over the first ``n`` bytes of the space
        handed out by :meth:`acquire` (which the fetcher filled in place);
        launches the slot when full."""
        if n > 0:
            self._precommit(n)
        self._fill += n
        if self._fill >= self._slot_bytes:
            self._launch()

    def submit(self, mv) -> None:
        """Slot-fill path (granule was filled elsewhere): copy the source
        into slot free space, launching transfers as slots fill. Takes
        any bytes-like source or a :class:`~tpubench_torch.mem.slab.
        SlabLease` (the pipeline's page-locked chunk slabs feed the ring
        with no ``bytes`` in between; the caller keeps its reference until
        submit returns, as the fill is synchronous)."""
        if isinstance(mv, SlabLease):
            mv = mv.view()
        elif not isinstance(mv, memoryview):
            mv = memoryview(mv)
        off = 0
        n = len(mv)
        while off < n:
            dst = self.acquire()
            take = min(len(dst), n - off)
            dst[:take] = mv[off : off + take]
            self.commit(take)
            off += take

    def flush(self) -> None:
        """Ship any partially-filled slot now (end of stream)."""
        if self._fill > 0:
            self._launch()


class DevicePutStager(GranuleAggregator):
    """One per worker. Two sink protocols:

    * copying — ``submit(mv)`` copies the filled granule into the current
      slot's free space (launching transfers as slots fill);
    * zero-copy — ``acquire()`` hands out the current slot's free space for
      the fetch path to fill *in place*, then ``commit(n)`` advances the
      fill mark and launches the slot's async host→device copy once full.

    ``device`` is ``"cuda"`` (worker ``i`` → ``cuda:(i % count)``), a
    specific card, or ``"cpu"``.
    """

    def __init__(
        self,
        worker_id: int,
        granule_bytes: int,
        cfg: Optional[StagingConfig] = None,
        device=None,
        depth: Optional[int] = None,
        slot_bytes: Optional[int] = None,
        transfer_engine: Optional[TransferEngine] = None,
    ):
        cfg = cfg or StagingConfig()
        self.device = worker_device(device, worker_id)
        self.n_chips = device_count(self.device)
        lane = cfg.lane
        if depth is None:
            depth = max(1, cfg.depth) if cfg.double_buffer else 1
        self._granule = granule_bytes
        # Slot capacity: the aggregation target (never smaller than one
        # granule), rounded up to a lane multiple; unfilled tails are
        # zero-padded at launch so checksums see only real bytes.
        if slot_bytes is None:
            slot_bytes = cfg.slot_bytes
        slot_bytes = max(slot_bytes, granule_bytes)
        self._slot_bytes = ((slot_bytes + lane - 1) // lane) * lane
        self._shape = (self._slot_bytes // lane, lane)
        self.native_slots = cfg.native_slots and self.device.type == "cuda"
        self.stream = worker_stream(self.device, worker_id)
        self._slots: list[torch.Tensor] = []
        self._slot_flat: list[np.ndarray] = []
        self._slot_views: list[memoryview] = []
        for _ in range(depth):
            self._alloc_slot()
        self._fill = 0  # bytes of real payload in the current slot
        self.depth = depth
        self.transfers = 0
        self.stage_recorder = LatencyRecorder(f"w{worker_id}/stage")
        # Flight recorder: one record per transfer (enqueue → stage_submit
        # → stage_complete/hbm_staged) on the run's ambient recorder —
        # appended by the fetch thread (serial ring) or the window's
        # reaper (overlap), one appender either way.
        self._flight = _flight.active_worker(f"w{worker_id}/stage")
        self._validate = cfg.validate_checksum
        self._host_sum = np.uint64(0)
        self._dev_sum: Optional[torch.Tensor] = None
        if self._validate:
            with on_stream(self.stream):
                self._dev_sum = landing.new_acc(self.device)
        # Validation keeps the serial inline ring (the checksum reads the
        # landed slot in order); depth 1 is the synchronous comparator.
        self._overlap = depth > 1 and not self._validate
        # Public: an overlapped submit returns before the bytes land.
        self.overlapped = self._overlap
        self._window: Optional[InflightWindow] = None
        # Serial-path state (depth 1 / validation): per slot, the landed
        # tensor and the event that gates the slot's reuse.
        self._futures: list[Optional[tuple]] = [None] * depth
        self._submit_ns = [0] * depth
        self._true_bytes = [0] * depth
        self._k = 0
        self.staged_bytes = 0
        # Phase accounting for the pipeline-gap breakdown: transfer_wait_ns
        # is FETCH-THREAD time blocked on transfers; put_submit_ns is
        # fetch-thread submit time (inline) or reaper submit time,
        # concurrent with fetch (overlap).
        self.transfer_wait_ns = 0
        self.put_submit_ns = 0
        self.transfer_flight_ns = 0
        self._inflight_samples: list[int] = []
        if self._overlap:
            self._window = InflightWindow(
                depth, self.device,
                engine=transfer_engine or TransferEngine(self.stream),
                stage_recorder=self.stage_recorder,
                flight_ring=self._flight,
                name=f"w{worker_id}",
            )
            # Free-slot pool (out-of-order: availability is a free list,
            # not a rotation); the window's reaper returns slots here.
            self._free_cond = threading.Condition()
            self._free: list[int] = list(range(depth))
            # Live depth (set_depth): slots beyond the target retire as
            # their copies land and stay allocated until finish.
            self._retired: list[int] = []
            self._slot_count = depth
            self._target_depth = depth
            self._cur: Optional[int] = None
            self._closed = False

    # ------------------------------------------------------------ slots ----
    def _alloc_slot(self) -> int:
        """Allocate one slot (page-locked on CUDA); returns its index. A
        host allocation only: no stream is touched, so a live grow may run
        on another thread while the ring's worker copies."""
        slot = new_slot(self._shape, self.native_slots)
        flat = slot.numpy().reshape(-1)
        self._slots.append(slot)
        self._slot_flat.append(flat)
        self._slot_views.append(memoryview(flat))
        return len(self._slots) - 1

    def _release_slot(self, k: int) -> None:
        """Reaper callback: the slot's copy has landed (out of order)."""
        with self._free_cond:
            if self._slot_count > self._target_depth:
                # A live shrink retires slots as their copies land; the
                # buffers stay allocated until finish.
                self._retired.append(k)
                self._slot_count -= 1
            else:
                self._free.append(k)
            self._free_cond.notify_all()

    def set_depth(self, depth: int) -> int:
        """Live depth actuation (the ``staging_depth`` tune knob). A grow
        adds free slots (retired ones first, then new page-locked ones); a
        shrink retires free slots now and in-flight ones only when their
        copies land, so no slot is handed back while a copy reads it. The
        serial ring (depth 1, validate) has no window: a no-op."""
        depth = max(1, int(depth))
        if not self._overlap:
            return self.depth
        with self._free_cond:
            if self._closed:
                # A grow fanned out after finish must not allocate
                # page-locked buffers nothing will free.
                return self.depth
            self._target_depth = depth
            while self._slot_count < depth:
                k = self._retired.pop() if self._retired else self._alloc_slot()
                self._slot_count += 1
                self._free.append(k)
            while self._slot_count > depth and self._free:
                self._retired.append(self._free.pop())
                self._slot_count -= 1
            self._free_cond.notify_all()
        self._window.set_depth(depth)
        self.depth = depth
        return depth

    # ------------------------------------------------------------ pipeline --
    def _drain_slot(self, k: int) -> None:
        fut = self._futures[k]
        if fut is None:
            return
        with hot_region(TRANSFER_WAIT):
            t0 = time.perf_counter_ns()
            fut[1].synchronize()  # the copy (and checksum) of slot k landed
            done_ns = time.perf_counter_ns()
        self.transfer_wait_ns += done_ns - t0
        self.transfer_flight_ns += done_ns - self._submit_ns[k]
        self.stage_recorder.record_ns(done_ns - self._submit_ns[k])
        if self._flight is not None:
            op = self._flight.begin(
                "slot", "device_put", enqueue_ns=self._submit_ns[k],
                install=False, kind="stage",
            )
            op.mark("stage_submit", self._submit_ns[k])
            op.mark("stage_complete", done_ns)
            op.mark("hbm_staged", done_ns)
            op.finish(self._true_bytes[k])
        self.staged_bytes += self._true_bytes[k]
        self._futures[k] = None

    def _launch(self) -> None:
        """Ship the current slot (``_fill`` real bytes) to the device.
        Overlap: hand the filled slot to the window (reaper submits +
        completes; the fetch thread pays neither). Serial: submit inline
        and drain lazily at the next :meth:`acquire` of the slot."""
        nbytes = self._fill
        self.transfers += 1
        if self._overlap:
            k = self._cur
            if nbytes < self._slot_bytes:
                self._slot_flat[k][nbytes:] = 0
            self._fill = 0
            self._cur = None
            self._window.enqueue(
                self._slots[k], nbytes,
                on_complete=lambda k=k: self._release_slot(k),
                label="slot",
            )
            return
        k = self._k
        if nbytes < self._slot_bytes:
            # Partial slot (end of run / oversized granule remainder): zero
            # the tail so checksum/pad semantics stay exact.
            self._slot_flat[k][nbytes:] = 0
        submit_ns = time.perf_counter_ns()
        with on_stream(self.stream):
            landed = copy_to_device(self._slots[k], self.device)
            if self._validate:
                landing.checksum(landed, self._dev_sum)
            done = record_event(self.stream)
        self.put_submit_ns += time.perf_counter_ns() - submit_ns
        self._submit_ns[k] = submit_ns
        self._futures[k] = (landed, done)
        self._true_bytes[k] = nbytes
        self._inflight_samples.append(
            sum(1 for f in self._futures if f is not None)
        )
        self._fill = 0
        self._k = (k + 1) % self.depth
        if self.depth == 1:
            # Single slot = fully synchronous staging: complete the copy
            # before the fetcher can touch the slot again.
            self._drain_slot(k)

    def _acquire_slot(self) -> int:
        """Overlap path: a free slot to fill, blocking (= backpressure)
        while every slot's copy is still pending."""
        with self._free_cond:
            if not self._free and self._window.error is None:
                with hot_region(TRANSFER_WAIT):
                    t0 = time.perf_counter_ns()
                    while not self._free and self._window.error is None:
                        # Short timeout: a transfer failure must get to
                        # the error check.
                        self._free_cond.wait(0.05)
                    self.transfer_wait_ns += time.perf_counter_ns() - t0
            self._window.raise_if_failed()
            return self._free.pop()

    def _free_view(self) -> memoryview:
        """The ring's backpressure point: a slot to fill, waiting out (or
        inline-draining) a prior copy when none is free."""
        if self._overlap:
            if self._cur is None:
                self._cur = self._acquire_slot()
            return self._slot_views[self._cur][self._fill :]
        k = self._k
        self._drain_slot(k)
        return self._slot_views[k][self._fill :]

    def submit_owned(self, lease: SlabLease, label: str = "chunk") -> None:
        """Zero-copy staging of a page-locked slab lease: the copy to the
        card reads straight out of the slab (no slot copy), and the
        lease's reference, which the caller hands over, is released by
        the window's reaper once the copy's event has completed — never
        here. Serial ring (depth 1 / validation): the copying slot path,
        releasing after the synchronous fill."""
        if not self._overlap:
            try:
                self.submit(lease)
            finally:
                lease.release()
            return
        self.transfers += 1
        self._window.enqueue(
            lease.as_tensor(), len(lease), on_complete=lease.release,
            label=label,
        )

    def _precommit(self, n: int) -> None:
        if self._validate:
            chunk = self._slot_flat[self._k][self._fill : self._fill + n]
            self._host_sum += chunk.sum(dtype=np.uint64)

    def finish(self) -> dict:
        # Slots are released even when a transfer failed — but only after
        # every in-flight copy has settled, so none reads freed memory.
        err: Optional[BaseException] = None
        try:
            self.flush()
        except BaseException as e:
            err = e
        if self._overlap:
            with self._free_cond:
                self._closed = True  # registry grows become no-ops
            # The tail of the transfer time is paid inside close()'s
            # drain and counted as transfer wait.
            self._window.close()
            if err is None:
                err = self._window.error
        else:
            for k in range(self.depth):
                try:
                    self._drain_slot(k)
                except BaseException as e:
                    if err is None:
                        err = e
        self._slot_views = []
        self._slot_flat = []
        self._slots = []
        if err is not None:
            raise err
        stats = {
            "slot_bytes": self._slot_bytes,
            "n_chips": self.n_chips,
            "native_slots": self.native_slots,
            "drain": "overlap" if self._overlap else "inline",
            "stage_recorder": self.stage_recorder,
            "device": str(self.device),
            "depth": self.depth,
            "transfers": self.transfers,
        }
        if self._overlap:
            w = self._window.stats()
            self.staged_bytes = w["staged_bytes"]
            self.transfer_wait_ns = w["transfer_wait_ns"] + self.transfer_wait_ns
            self.put_submit_ns = w["put_submit_ns"]
            self.transfer_flight_ns = w["transfer_flight_ns"]
            stats.update({
                "staged_bytes": self.staged_bytes,
                "transfer_wait_ns": self.transfer_wait_ns,
                "put_submit_ns": self.put_submit_ns,
                "transfer_flight_ns": self.transfer_flight_ns,
                "inflight_p50": w["inflight_p50"],
                "inflight_max": w["inflight_max"],
                "out_of_order_completions": w["out_of_order_completions"],
            })
        else:
            samples = np.asarray(
                self._inflight_samples or [0], dtype=np.int64
            )
            stats.update({
                "staged_bytes": self.staged_bytes,
                "transfer_wait_ns": self.transfer_wait_ns,
                "put_submit_ns": self.put_submit_ns,
                "transfer_flight_ns": self.transfer_flight_ns,
                "inflight_p50": float(np.percentile(samples, 50)),
                "inflight_max": int(samples.max()),
                "out_of_order_completions": 0,
            })
        stats["staging_efficiency"] = staging_efficiency(
            stats["transfer_wait_ns"], stats["put_submit_ns"],
            stats["transfer_flight_ns"], self._overlap,
        )
        if self._validate:
            with on_stream(self.stream):
                dev = landing.acc_value(self._dev_sum)
            host = int(self._host_sum % np.uint64(2**32))
            stats["checksum_ok"] = dev == host
            stats["checksum_device"] = dev
            stats["checksum_host"] = host
        return stats


class LockedSink:
    """Serialization wrapper for a slot ring shared by CONCURRENT
    producers: each ``submit`` — the whole acquire→fill→commit
    transaction — runs under one lock, so two producers can never be
    handed the same slot region.

    Deliberately does NOT forward the zero-copy ``acquire``/``commit``
    pair: a lock released between acquire and commit would re-open the
    double-assign window. Shared rings use the copying ``submit`` path;
    the workload's ``hasattr(sink, "acquire")`` probe then routes
    correctly on its own.
    """

    def __init__(self, inner):
        self._inner = inner
        self._lock = threading.Lock()

    def submit(self, mv: memoryview) -> None:
        with self._lock:
            self._inner.submit(mv)

    def submit_owned(self, lease, label: str = "chunk") -> None:
        """Lease staging under the same lock as slot submits: the enqueue
        moves the window's credit and the ring's transfer count."""
        with self._lock:
            self._inner.submit_owned(lease, label=label)

    def flush(self) -> None:
        with self._lock:
            self._inner.flush()

    def set_depth(self, depth: int) -> int:
        """Depth actuation forwards to the wrapped ring. Not under the
        submit lock: a shrink blocked behind a long submit would stall
        the controller thread, and the stager's own free-list lock
        already serializes it."""
        return self._inner.set_depth(depth)

    @property
    def depth(self) -> int:
        return self._inner.depth

    @property
    def overlapped(self) -> bool:
        return getattr(self._inner, "overlapped", False)

    def finish(self) -> dict:
        with self._lock:
            return self._inner.finish()


def budgeted_slot_bytes(cfg: BenchConfig) -> int:
    """slot_bytes scaled so ALL workers' slots fit the host budget (never
    below one granule): 48 workers must not pin gigabytes of host memory
    before the first byte is fetched."""
    s = cfg.staging
    depth = max(1, s.depth) if s.double_buffer else 1
    workers = max(1, cfg.workload.workers)
    budget = max(1, s.host_budget_mb) * (1 << 20)
    per_worker = budget // (workers * depth)
    return max(cfg.workload.granule_bytes, min(s.slot_bytes, per_worker))


def make_sink_factory(
    cfg: BenchConfig, device="cuda",
) -> Optional[Callable[[int], GranuleAggregator]]:
    """Staging sink factory for the read workload, from config."""
    mode = cfg.staging.mode
    if mode == "none":
        return None
    slot = budgeted_slot_bytes(cfg)
    if mode == "device_put":
        return lambda worker_id: DevicePutStager(
            worker_id,
            granule_bytes=cfg.workload.granule_bytes,
            cfg=cfg.staging,
            device=device,
            slot_bytes=slot,
        )
    if mode == "pallas":
        from tpubench_torch.staging.land_stage import LandStager

        return lambda worker_id: LandStager(
            worker_id,
            granule_bytes=cfg.workload.granule_bytes,
            cfg=cfg.staging,
            device=device,
            slot_bytes=slot,
        )
    raise ValueError(f"unknown staging mode {mode!r} (none|device_put|pallas)")
