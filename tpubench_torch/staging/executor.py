"""Overlapped staging executor: a depth-K in-flight window over host→device
copies with out-of-order completion (``tpubench/staging/executor.py``).

:class:`InflightWindow` is the core: the stager's fetch thread
``enqueue``\\ s filled slots; a single **reaper** thread submits the
copies and then *polls* the per-transfer CUDA events, finalizing whichever
transfer lands first — out-of-order completion into the slot ring.
Backpressure is the window credit: ``enqueue`` blocks only when all K
slots are pending, and that blocked time is the run's ``transfer_wait_ns``.

Each transfer is one flight record (``kind="stage"``) when the run has a
recorder: begun by the producer at enqueue, adopted by the reaper, which
stamps ``stage_submit`` and, when the event reports the copy done,
``stage_complete``/``hbm_staged`` — host times, as ``tpubench`` stamps
after ``block_until_ready``.

Each transfer's resources (the slot to free, or the page-locked slab
lease of a chunk staged in place) are dropped by the reaper at
*completion* — when the copy's event has fired — never at submit: a
pinned buffer refilled while its asynchronous copy still reads it would
ship corrupted bytes. The landed device buffer is released at completion too
(its reference is dropped, and the caching allocator reuses the memory for
later work on the same stream).

Everything is injectable for tests: :class:`TransferEngine` is the
submit/probe/wait/delete surface, and the clock is a parameter.

:class:`StagerRegistry` fans the tune controller's ``staging_depth`` knob
out to every worker's ring (:meth:`InflightWindow.set_depth` through the
stager's own ``set_depth``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from tpubench_torch.device import on_stream, record_event
from tpubench_torch.obs import flight as _flight
from tpubench_torch.staging.stats import staging_efficiency


def copy_to_device(slot: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Enqueue a copy of ``slot`` onto ``device`` on the current stream.
    From a pinned slot the copy is asynchronous (``non_blocking``); on the
    CPU it is a real copy (``clone``), so the slot may be reused at once on
    both devices after the transfer's completion gate."""
    if device.type == "cpu":
        return slot.clone()
    out = torch.empty(slot.shape, dtype=slot.dtype, device=device)
    out.copy_(slot, non_blocking=True)
    return out


class TransferEngine:
    """Host→device transfer surface the window drives.

    ``submit`` enqueues the copy on ``stream`` (the stager's own; the
    reaper thread enters it explicitly, since the current stream is per
    thread) and records an event after it; the handle is ``(landed
    tensor, event)``. ``probe`` is ``event.query()``, ``wait`` is
    ``event.synchronize()``, ``delete`` lets go of the landed tensor.
    """

    def __init__(self, stream=None):
        self._stream = stream

    def submit(self, array, device):
        with on_stream(self._stream):
            landed = copy_to_device(array, device)
            return [landed, record_event(self._stream)]

    def probe(self, handle) -> Optional[bool]:
        return bool(handle[1].query())

    def wait(self, handle) -> None:
        handle[1].synchronize()

    def delete(self, handle) -> None:
        handle[0] = None


class _Transfer:
    """One in-flight transfer: buffer, accounting stamps, and the
    resources the reaper drops at completion."""

    __slots__ = ("array", "nbytes", "on_complete", "op", "enqueue_ns",
                 "seq", "handle", "submit_ns")

    def __init__(self, array, nbytes: int, on_complete, op, enqueue_ns: int,
                 seq: int):
        self.array = array
        self.nbytes = nbytes
        self.on_complete = on_complete  # free the slot / release the lease
        self.op = op  # flight record (kind="stage"), finished by the reaper
        self.enqueue_ns = enqueue_ns
        self.seq = seq
        self.handle = None
        self.submit_ns = 0


class InflightWindow:
    """Depth-K transfer window: submit queue + reaper + OOO completion.

    One window per stager; the stager's fetch thread is the only
    producer, the reaper the only consumer — all counters the reaper
    mutates are read by the producer only under the shared lock or
    after :meth:`close` joins the thread.
    """

    def __init__(
        self,
        depth: int,
        device,
        *,
        engine: Optional[TransferEngine] = None,
        stage_recorder=None,
        flight_ring=None,
        name: str = "stage",
        poll_s: float = 0.0002,
        clock: Callable[[], int] = time.perf_counter_ns,
    ):
        self._engine = engine or TransferEngine()
        self._device = device
        self._depth = max(1, int(depth))
        self._recorder = stage_recorder
        self._ring = flight_ring
        self._poll_s = poll_s
        self._clock = clock
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: list[_Transfer] = []
        self._inflight: list[_Transfer] = []
        self._seq = 0
        self._stop = False
        self.error: Optional[BaseException] = None
        # Accounting (finalized values read after close()).
        self.transfers = 0
        self.staged_bytes = 0
        self.wait_ns = 0  # producer-thread backpressure + drain-tail time
        self.submit_ns = 0  # reaper time inside engine.submit (∥ fetch)
        self.flight_ns = 0  # Σ per-transfer (complete − submit)
        self.out_of_order = 0  # completions that overtook an older submit
        self.inflight_samples: list[int] = []  # gauge, sampled per submit
        self._reaper = threading.Thread(
            target=self._run, name=f"{name}-reaper", daemon=True
        )
        self._reaper.start()

    # ---------------------------------------------------------- producer --
    @property
    def depth(self) -> int:
        return self._depth

    def set_depth(self, depth: int) -> int:
        """Live depth change: grow widens the credit window immediately;
        shrink lets in-flight transfers drain down to the new bound."""
        with self._cond:
            self._depth = max(1, int(depth))
            self._cond.notify_all()
            return self._depth

    def raise_if_failed(self) -> None:
        """A failed transfer must abort the producer NOW: the reaper
        frees failed transfers' resources (no deadlock), so without
        this check backpressure never engages and a dead device would
        let the fetch burn the whole measurement window."""
        if self.error is not None:
            raise self.error

    def enqueue(self, array, nbytes: int, on_complete=None,
                label: str = "device_put",
                enqueue_ns: Optional[int] = None) -> None:
        """Hand a filled buffer to the window. Blocks (backpressure)
        while K transfers are already pending; the blocked time is
        ``wait_ns`` — the quantity this executor exists to shrink."""
        enq = enqueue_ns if enqueue_ns is not None else self._clock()
        op = None
        if self._ring is not None:
            op = self._ring.begin(
                label, "device_put", enqueue_ns=enq, install=False,
                kind="stage",
            )
            # The serial ring stamps stage_submit too, so window transfers
            # carry an explicit marker (timeline_summary's `overlapped`).
            op.note("stage", event="overlap")
        with self._cond:
            t0 = None
            while (len(self._queue) + len(self._inflight) >= self._depth
                   and self.error is None):
                if t0 is None:
                    t0 = self._clock()
                self._cond.wait()
            if t0 is not None:
                self.wait_ns += self._clock() - t0
            if self.error is not None:
                if op is not None:
                    # Abandon, don't finish: the reaper may be appending
                    # failed ops to the same single-appender ring now.
                    op.abandon()
                if on_complete is not None:
                    on_complete()
                raise self.error
            self._queue.append(
                _Transfer(array, int(nbytes), on_complete, op, enq, self._seq)
            )
            self._seq += 1
            self._cond.notify_all()

    def drain(self) -> None:
        """Block until every enqueued transfer has settled (landed or
        failed). The tail of the transfer time is paid here and counted
        into ``wait_ns``."""
        with self._cond:
            t0 = self._clock()
            while self._queue or self._inflight:
                self._cond.wait()
            self.wait_ns += self._clock() - t0

    def close(self) -> None:
        """Drain, stop the reaper, join. Idempotent."""
        self.drain()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._reaper.join()

    def stats(self) -> dict:
        samples = np.asarray(self.inflight_samples or [0], dtype=np.int64)
        wait, flight = self.wait_ns, self.flight_ns
        efficiency = staging_efficiency(
            wait, self.submit_ns, flight, overlapped=True
        )
        return {
            "depth": self._depth,
            "transfers": self.transfers,
            "staged_bytes": self.staged_bytes,
            "transfer_wait_ns": wait,
            "put_submit_ns": self.submit_ns,
            "transfer_flight_ns": flight,
            "out_of_order_completions": self.out_of_order,
            "inflight_p50": float(np.percentile(samples, 50)),
            "inflight_max": int(samples.max()),
            "staging_efficiency": efficiency,
        }

    # ------------------------------------------------------------ reaper --
    def _run(self) -> None:
        try:
            self._loop()
        except BaseException as e:  # last-resort guard
            # A reaper death without error-marking would deadlock the
            # producer forever (enqueue/drain wait on window credit that
            # can never free). Mark the error, fail every live transfer,
            # and drop their resources so finish() can still tear down.
            with self._cond:
                if self.error is None:
                    self.error = e
                pending = self._queue + self._inflight
                self._queue = []
                self._inflight = []
                self._cond.notify_all()
            for tr in pending:
                if tr.op is not None:
                    tr.op.finish(error=e)
                self._consume_callback(tr)

    @staticmethod
    def _consume_callback(tr: _Transfer) -> None:
        """Run a transfer's on_complete exactly once (slot frees must
        never double-fire across failure paths)."""
        cb, tr.on_complete = tr.on_complete, None
        if cb is not None:
            cb()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._inflight:
                    if self._stop:
                        return
                    self._cond.wait()
                # Snapshot WITHOUT clearing: a queued transfer keeps its
                # window credit until _submit moves it to _inflight, so
                # queued+inflight ≤ depth holds at all times.
                batch = list(self._queue)
            for tr in batch:
                self._submit(tr)
            self._complete_ready()

    def _submit(self, tr: _Transfer) -> None:
        try:
            # The reaper adopts the transfer's op (and its trace position)
            # for the submission, so submit-side annotations land on it.
            if tr.op is not None:
                _flight.adopt_op(tr.op)
            try:
                s0 = self._clock()
                tr.handle = self._engine.submit(tr.array, self._device)
                tr.submit_ns = s0
                self.submit_ns += self._clock() - s0
            finally:
                if tr.op is not None:
                    _flight.adopt_op(None)
        except BaseException as e:  # raised at the producer's next enqueue
            self._fail(tr, e)
            return
        if tr.op is not None:
            tr.op.mark("stage_submit", tr.submit_ns)
        with self._cond:
            self._queue.remove(tr)
            self._inflight.append(tr)
            self.inflight_samples.append(len(self._inflight))

    def _complete_ready(self) -> None:
        """Finalize every READY in-flight transfer, first-landed first
        (out-of-order w.r.t. submission); when nothing is ready yet,
        wait a poll tick (new enqueues interrupt the wait) or — for an
        engine without a completion probe — block on the oldest."""
        while True:
            with self._cond:
                inflight = list(self._inflight)
                queued = bool(self._queue)
            if not inflight or queued:
                return  # nothing to do, or new submissions take priority
            ready = None
            probed = False
            for tr in inflight:
                ok = self._engine.probe(tr.handle)
                if ok is None:
                    break  # no probe: in-order fallback
                probed = True
                if ok:
                    ready = tr
                    break
            if ready is None and not probed:
                # No completion probe: block on the oldest (in-order
                # degrade — never free a buffer a transfer might still
                # read). With a probe we must NOT block here: a blocking
                # wait would starve the submission of buffers the
                # producer enqueues meanwhile.
                ready = inflight[0]
            if ready is not None:
                self._finalize(ready)
                continue
            with self._cond:
                if self._queue:
                    return
                self._cond.wait(self._poll_s)

    def _finalize(self, tr: _Transfer) -> None:
        # The whole completion path is guarded, not just wait(): a
        # delete()/recorder failure that escaped would kill the reaper
        # with the transfer still holding window credit.
        try:
            self._engine.wait(tr.handle)
            done = self._clock()
            self.flight_ns += done - tr.submit_ns
            if self._recorder is not None:
                # Stage latency from ENQUEUE, not submit: with overlap
                # the queueing behind earlier transfers is part of the
                # quantity that sizes the pipeline.
                self._recorder.record_ns(done - tr.enqueue_ns)
            if tr.op is not None:
                # Completion phases stamp when the event first reports
                # the copy done, on the transfer's record, from the
                # reaper thread; the adoption is cleared before the next.
                _flight.adopt_op(tr.op)
                try:
                    _flight.note_phase("stage_complete", done)
                    _flight.note_phase("hbm_staged", done)
                    tr.op.finish(tr.nbytes)
                finally:
                    _flight.adopt_op(None)
            self._engine.delete(tr.handle)
        except BaseException as e:
            self._fail(tr, e)
            return
        with self._cond:
            self._inflight.remove(tr)
            self.transfers += 1
            self.staged_bytes += tr.nbytes
            if any(o.seq < tr.seq for o in self._inflight):
                self.out_of_order += 1
            self._cond.notify_all()
        self._consume_callback(tr)

    def _fail(self, tr: _Transfer, e: BaseException) -> None:
        if tr.op is not None:
            tr.op.finish(error=e)
        with self._cond:
            if self.error is None:
                self.error = e
            if tr in self._queue:  # failed inside submit: still queued
                self._queue.remove(tr)
            if tr in self._inflight:
                self._inflight.remove(tr)
            self._cond.notify_all()
        # Resources are freed even on failure (a dead device must not
        # leak slots); the producer aborts via raise_if_failed at its
        # next acquire/enqueue.
        self._consume_callback(tr)


class StagerRegistry:
    """Live-actuation fan-out for the ``staging_depth`` tune knob
    (``tpubench/staging/executor.py:426``; a grow fans out on one thread
    per ring here, where ``tpubench``'s goes ring by ring).

    The read workload builds one stager per worker INSIDE the worker
    threads, after the controller's knob list exists — so the knob
    actuates this registry, and stagers attach as they are created. A
    depth commanded before a stager attached is applied at attach (late
    workers join the tuned operating point, not the config's)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stagers: list = []
        self._depth: Optional[int] = None
        self._high = 0  # the deepest any attached ring has been

    def attach(self, stager):
        if hasattr(stager, "set_depth"):
            with self._lock:
                self._stagers.append(stager)
                depth = self._depth
                self._high = max(self._high, getattr(stager, "depth", 0),
                                 depth or 0)
            if depth is not None:
                stager.set_depth(depth)
        return stager

    def set_depth(self, depth: int) -> None:
        with self._lock:
            self._depth = int(depth)
            stagers = list(self._stagers)
            allocates = depth > self._high
            self._high = max(self._high, self._depth)
        if not allocates:
            # A shrink, or a grow the rings' retired slots cover: nothing
            # to allocate, and starting threads would cost more than it.
            for st in stagers:
                st.set_depth(depth)
            return
        # A grow past every ring's deepest allocates page-locked slots in
        # every ring: one thread per ring, joined before returning (the
        # slots exist when the knob's setter returns, as in tpubench), so
        # the rings' allocations overlap instead of queuing on the
        # controller's thread, which waits for the interpreter lock after
        # each one (scripts/pinned_grow.py, PERF.md).
        errors: list = []

        def grow(st) -> None:
            try:
                st.set_depth(depth)
            except BaseException as e:  # re-raised on the caller's thread
                errors.append(e)

        threads = [threading.Thread(target=grow, args=(st,),
                                    name="stager-grow", daemon=True)
                   for st in stagers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def __len__(self) -> int:
        with self._lock:
            return len(self._stagers)
