"""Tail-tolerance layer: stall watchdog, hedged reads, circuit breaker
(a copy of ``tpubench/storage/tail.py``; writes pass straight through).

The paper's north star makes the POD the unit under test, so one silently
slow stream sets the p99 for every chip. The reference can only
retry-after-FAILURE (gax, ``main.go:179-184``); this module adds the three
standard tail-tolerance mechanisms (Dean & Barroso, "The Tail at Scale")
as composable :class:`~tpubench_torch.storage.base.StorageBackend` wrappers:

* :class:`WatchdogBackend` — a **stall watchdog** per reader: a stream
  whose throughput stays below ``stall_floor_bps`` for at least
  ``stall_window_s`` is cancelled with a transient :class:`StallError`,
  which the resume path in :mod:`tpubench_torch.storage.retrying` picks up and
  reopens at offset. Clock injectable → deterministic tests.
* :class:`HedgedBackend` — **hedged reads**: if the first byte hasn't
  arrived within the hedge delay (fixed, or derived from the run's
  rolling p99 first-byte latency), a second ranged read for the same
  bytes races the first; the winner streams, the loser is cancelled and
  its bytes counted as waste. The hedged reader ALSO runs the stall
  watchdog asynchronously (queue timeouts), so it detects a blackholed
  stream even while the producer thread is blocked inside a socket read
  — the one stall shape a same-thread boundary check can never see.
* :class:`BreakerBackend` — a per-backend **circuit breaker**
  (closed → open → half-open with probes): an endpoint that keeps
  failing is shed with a transient :class:`CircuitOpenError` instead of
  being hammered; after ``breaker_reset_s`` a limited probe set decides
  whether to close again. Composes under :class:`RetryingBackend` —
  shed opens are retried under the same gax pacing.

Stack order (built by ``open_backend``):
``Retrying( Hedged( Watchdog( Breaker( inner ))))`` with each layer
optional. Every hedge/stall/breaker event is annotated onto the calling
thread's flight-recorder op, so ``tpubench report timeline`` attributes
them per read.

Known limit: hedge cancellation is COOPERATIVE (the loser closes its own
reader at the next chunk boundary — no cross-thread close races the
backend). A producer blocked inside ``readinto`` (a blackholed socket,
the fake's ``stall_s``) therefore lingers as a daemon thread, holding
one chunk buffer, until the read unblocks or the process exits. Under a
sustained blackhole fault each rescued read can strand a thread for the
fault's duration — size blackhole chaos runs accordingly (bounded read
counts, or a finite ``stall_s``).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Callable, Optional

from tpubench_torch.config import TailConfig
from tpubench_torch.obs.flight import annotate as _flight_annotate
from tpubench_torch.storage.base import StorageBackend, StorageError


class StallError(StorageError):
    """A stream cancelled by the stall watchdog. Transient by contract:
    the resume path reopens the read at the delivered offset."""

    def __init__(self, msg: str):
        super().__init__(msg, transient=True, code=598)


class CircuitOpenError(StorageError):
    """Open shed by an OPEN circuit breaker — transient (the endpoint may
    recover), so the retry policy paces re-attempts instead of the caller
    hammering a known-bad endpoint."""

    def __init__(self, msg: str):
        super().__init__(msg, transient=True, code=503)


class _WrapperBackend:
    """Delegating base for the tail wrappers: everything but open_read
    passes straight through; ``inner`` is public so stats collectors and
    diagnostics can walk the chain."""

    def __init__(self, inner: StorageBackend):
        self.inner = inner

    def write(self, name: str, data: bytes, if_generation_match=None):
        return self.inner.write(
            name, data, if_generation_match=if_generation_match
        )

    def open_write(self, name: str, if_generation_match=None):
        # The tail layers shape READS (hedge/watchdog race byte streams);
        # the write path passes through and composes with the retry
        # decorator's resuming writer above this stack.
        return self.inner.open_write(
            name, if_generation_match=if_generation_match
        )

    def list(self, prefix: str = "", page_size: int = 0):
        return self.inner.list(prefix, page_size=page_size)

    def stat(self, name: str):
        return self.inner.stat(name)

    def delete(self, name: str) -> None:
        return self.inner.delete(name)

    def close(self) -> None:
        self.inner.close()


# ------------------------------------------------------------ breaker -----


class Admission:
    """Result of :meth:`CircuitBreaker.allow`: truthiness = admitted,
    ``probe`` = this operation is a half-open probe whose outcome must be
    settled (shared immutable singletons — allocation-free hot path)."""

    __slots__ = ("allowed", "probe")

    def __init__(self, allowed: bool, probe: bool):
        self.allowed = allowed
        self.probe = probe

    def __bool__(self) -> bool:
        return self.allowed


_ADMIT = Admission(True, False)
_PROBE = Admission(True, True)
_SHED = Admission(False, False)


class CircuitBreaker:
    """Closed → open → half-open state machine over consecutive failures.

    Thread-safe; ``clock`` injectable for deterministic tests. ``open``
    time is accumulated into the stats so the resilience scorecard can
    report how long the endpoint was shed."""

    def __init__(
        self,
        failures: int = 5,
        reset_s: float = 5.0,
        probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.failures_to_open = max(1, failures)
        self.reset_s = reset_s
        self.probes_to_close = max(1, probes)
        self._clock = clock
        self._lock = threading.Lock()
        self.state = "closed"
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._probes_inflight = 0
        self._probes_ok = 0
        self._open_s_total = 0.0
        self.opens = 0
        self.shed = 0
        self.probes = 0

    def allow(self) -> "Admission":
        """May a new operation proceed right now? The admission is falsy
        when shed; ``admission.probe`` marks a half-open probe, whose
        outcome MUST be settled (``record_success``/``record_failure``
        with ``probe=True``, or :meth:`abandon_probe`) — a leaked probe
        slot would shed every subsequent open forever."""
        with self._lock:
            now = self._clock()
            if self.state == "open":
                if now - self._opened_at < self.reset_s:
                    self.shed += 1
                    return _SHED
                # Cooldown elapsed: half-open, admit a probe set.
                self._open_s_total += now - self._opened_at
                self._opened_at = None
                self.state = "half_open"
                self._probes_inflight = 0
                self._probes_ok = 0
                _flight_annotate("breaker", state="half_open")
            if self.state == "half_open":
                if self._probes_inflight >= self.probes_to_close:
                    self.shed += 1
                    return _SHED
                self._probes_inflight += 1
                self.probes += 1
                return _PROBE
            return _ADMIT

    def abandon_probe(self) -> None:
        """Release a probe slot whose stream was closed without a
        verdict (cancelled hedge loser, caller closed early): the slot
        frees for the next probe, deciding nothing."""
        with self._lock:
            if self.state == "half_open" and self._probes_inflight > 0:
                self._probes_inflight -= 1

    def record_success(self, probe: bool = False) -> None:
        with self._lock:
            if probe and self.state == "half_open":
                self._probes_inflight -= 1
                self._probes_ok += 1
                if self._probes_ok >= self.probes_to_close:
                    self.state = "closed"
                    self._consecutive = 0
                    _flight_annotate("breaker", state="closed")
            else:
                # Probe verdicts arriving after the state moved on decide
                # nothing (allow() resets the slot counters on the next
                # open -> half-open transition).
                self._consecutive = 0

    def record_failure(self, probe: bool = False) -> None:
        with self._lock:
            now = self._clock()
            if probe and self.state == "half_open":
                self._probes_inflight -= 1
                self._open(now)
                return
            self._consecutive += 1
            if self.state == "closed" and (
                self._consecutive >= self.failures_to_open
            ):
                self._open(now)

    def _open(self, now: float) -> None:
        if self.state != "open":
            self.state = "open"
            self.opens += 1
            self._opened_at = now
            _flight_annotate("breaker", state="open")

    def open_seconds(self) -> float:
        """Total time spent open, INCLUDING the current open stretch."""
        with self._lock:
            total = self._open_s_total
            if self.state == "open" and self._opened_at is not None:
                total += self._clock() - self._opened_at
            return total

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "opens": self.opens,
            "open_s": self.open_seconds(),
            "shed": self.shed,
            "probes": self.probes,
        }


class _BreakerReader:
    """Reader that reports its outcome to the breaker: clean EOF =
    success, any exception = failure (reported once). A reader closed
    WITHOUT a verdict still settles: delivered bytes count as success
    (ranged reads often close at exactly-length without a 0-byte EOF
    read), a byteless close releases any probe slot undecided — a
    half-open probe must never leak its slot, or the breaker sheds
    every subsequent open forever."""

    def __init__(self, inner, breaker: CircuitBreaker, probe: bool):
        self._inner = inner
        self._breaker = breaker
        self._probe = probe
        self._settled = False
        self._delivered = 0

    @property
    def first_byte_ns(self):
        return self._inner.first_byte_ns

    @property
    def generation(self):
        return getattr(self._inner, "generation", None)

    def readinto(self, buf: memoryview) -> int:
        try:
            n = self._inner.readinto(buf)
        except BaseException:
            if not self._settled:
                self._settled = True
                self._breaker.record_failure(probe=self._probe)
            raise
        if n > 0:
            self._delivered += n
        elif not self._settled:
            self._settled = True
            self._breaker.record_success(probe=self._probe)
        return n

    def close(self) -> None:
        if not self._settled:
            self._settled = True
            if self._delivered > 0:
                self._breaker.record_success(probe=self._probe)
            elif self._probe:
                self._breaker.abandon_probe()
        self._inner.close()


class BreakerBackend(_WrapperBackend):
    def __init__(
        self,
        inner: StorageBackend,
        tail: TailConfig,
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__(inner)
        self.breaker = CircuitBreaker(
            failures=tail.breaker_failures,
            reset_s=tail.breaker_reset_s,
            probes=tail.breaker_probes,
            clock=clock,
        )

    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        adm = self.breaker.allow()
        if not adm:
            _flight_annotate("breaker", event="shed")
            raise CircuitOpenError(
                f"circuit open: shedding read of {name!r} "
                f"(state={self.breaker.state})"
            )
        try:
            r = self.inner.open_read(name, start, length)
        except BaseException:
            self.breaker.record_failure(probe=adm.probe)
            raise
        return _BreakerReader(r, self.breaker, probe=adm.probe)


# ----------------------------------------------------------- watchdog -----


class WatchdogReader:
    """Boundary-based stall watchdog: the rolling window accumulates only
    time spent INSIDE ``readinto`` (waiting on the stream) — a consumer
    that pauses between calls (a staging sink draining a device_put) is
    never mistaken for a slow stream. A window of in-stream time whose
    throughput is below the floor cancels the stream with
    :class:`StallError`. Detects slow-drip streams; a stream that blocks
    indefinitely inside ONE readinto is invisible to a same-thread check
    — that shape is covered by the hedged reader's async watchdog."""

    def __init__(
        self,
        inner,
        window_s: float,
        floor_bps: float,
        clock: Callable[[], float] = time.monotonic,
        on_stall: Optional[Callable[[], None]] = None,
    ):
        self._inner = inner
        self._window = max(1e-9, window_s)
        self._floor = floor_bps
        self._clock = clock
        self._on_stall = on_stall
        self._win_busy = 0.0  # seconds spent inside inner.readinto
        self._win_bytes = 0

    @property
    def first_byte_ns(self):
        return self._inner.first_byte_ns

    @property
    def generation(self):
        return getattr(self._inner, "generation", None)

    def readinto(self, buf: memoryview) -> int:
        t0 = self._clock()
        n = self._inner.readinto(buf)
        if n <= 0:
            return n  # EOF is never a stall
        self._win_busy += self._clock() - t0
        self._win_bytes += n
        if self._win_busy >= self._window:
            rate = self._win_bytes / self._win_busy
            if rate < self._floor:
                if self._on_stall is not None:
                    self._on_stall()
                _flight_annotate(
                    "stall", rate_bps=int(rate), window_s=self._win_busy,
                    floor_bps=self._floor,
                )
                try:
                    self._inner.close()
                except Exception:  # noqa: BLE001 — already failing the stream
                    pass
                raise StallError(
                    f"stream stalled: {rate:.0f} B/s over "
                    f"{self._win_busy:.2f}s of stream time "
                    f"(floor {self._floor:.0f} B/s)"
                )
            self._win_busy = 0.0
            self._win_bytes = 0
        return n

    def close(self) -> None:
        self._inner.close()


class WatchdogBackend(_WrapperBackend):
    def __init__(
        self,
        inner: StorageBackend,
        tail: TailConfig,
        clock: Callable[[], float] = time.monotonic,
    ):
        super().__init__(inner)
        self.tail = tail
        self._clock = clock
        self._lock = threading.Lock()
        self.stalls = 0

    def _note_stall(self) -> None:
        with self._lock:
            self.stalls += 1

    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        return WatchdogReader(
            self.inner.open_read(name, start, length),
            window_s=self.tail.stall_window_s,
            floor_bps=self.tail.stall_floor_bps,
            clock=self._clock,
            on_stall=self._note_stall,
        )


# ------------------------------------------------------------- hedged -----

_HEDGE_CHUNK = 256 * 1024
_ATTEMPT_DEPTH = 4  # chunks a producer may buffer ahead of the consumer
_CANCEL_POLL_S = 0.05


class _Attempt:
    """One racing read: a producer thread that opens the range and pumps
    chunks into the shared queue under a credit cap. Cancellation is
    cooperative — the producer checks the flag at every boundary and
    closes its own reader, so no cross-thread close races the backend."""

    __slots__ = (
        "idx", "open_fn", "out_q", "chunk_bytes", "cancelled", "credits",
        "bytes", "first_byte_ns", "generation", "op", "ctx", "thread",
    )

    def __init__(self, idx: int, open_fn, out_q: "queue.Queue",
                 chunk_bytes: int = _HEDGE_CHUNK):
        self.idx = idx
        self.open_fn = open_fn
        self.out_q = out_q
        self.chunk_bytes = chunk_bytes
        self.cancelled = threading.Event()
        self.credits = threading.Semaphore(_ATTEMPT_DEPTH)
        self.bytes = 0
        self.first_byte_ns: Optional[int] = None
        # Producer-written once post-open, consumer-read post-race
        # (GIL-atomic attribute, same discipline as first_byte_ns).
        self.generation = None
        # The consumer thread's flight op AND trace position (captured
        # at launch): the producer adopts both, so backend-level phases/
        # annotations (connect, first_byte, breaker/retry events) still
        # attribute to the read's record, and any span the leg's backend
        # stack opens parents under the read — despite running on a
        # helper thread. The trace context is captured separately
        # because a hedge can race a read that has a tracer span but no
        # flight op (flight recorder off).
        from tpubench_torch.obs.flight import current_op
        from tpubench_torch.obs.tracing import current_trace

        self.op = current_op()
        self.ctx = current_trace()
        self.thread = threading.Thread(
            target=self._run, daemon=True, name=f"hedge-{idx}"
        )
        self.thread.start()

    def _run(self) -> None:
        from tpubench_torch.obs.flight import adopt_op
        from tpubench_torch.obs.tracing import adopt_trace

        adopt_op(self.op)
        if self.op is None:
            adopt_trace(self.ctx)
        try:
            reader = self.open_fn()
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            self.out_q.put((self.idx, "err", e))
            return
        self.generation = getattr(reader, "generation", None)
        try:
            while not self.cancelled.is_set():
                while not self.credits.acquire(timeout=_CANCEL_POLL_S):
                    if self.cancelled.is_set():
                        return
                buf = bytearray(self.chunk_bytes)
                try:
                    n = reader.readinto(memoryview(buf))
                except BaseException as e:  # noqa: BLE001
                    self.out_q.put((self.idx, "err", e))
                    return
                if self.first_byte_ns is None:
                    self.first_byte_ns = getattr(reader, "first_byte_ns", None)
                if n <= 0:
                    self.out_q.put((self.idx, "eof", None))
                    return
                self.bytes += n
                self.out_q.put((self.idx, "data", memoryview(buf)[:n]))
        finally:
            try:
                reader.close()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass

    def cancel(self) -> None:
        self.cancelled.set()


class HedgedReader:
    """Winner-take-all racing reader over the inner backend.

    The primary attempt starts immediately; if no byte has arrived by the
    hedge delay, a second attempt races it for the SAME range from
    scratch (nothing has been delivered yet, so no bytes duplicate). The
    first attempt to produce data wins and streams; the loser is
    cancelled and its bytes are waste. Because the consumer waits on a
    queue, stall detection is asynchronous: no data for a full stall
    window (throughput below the floor) raises :class:`StallError` even
    while the producers are blocked inside socket reads."""

    def __init__(self, hb: "HedgedBackend", name: str, start: int,
                 length: Optional[int]):
        self._hb = hb
        self._name = name
        self._start = start
        self._length = length
        self._q: queue.Queue = queue.Queue()
        self._attempts: list[_Attempt] = []
        self._winner: Optional[_Attempt] = None
        self._errors: dict[int, BaseException] = {}
        self._pending: deque = deque()
        self._eof = False
        self._closed = False
        self.first_byte_ns: Optional[int] = None
        t = hb.tail
        self._opened_t = hb._clock()
        self._hedge_at: Optional[float] = (
            self._opened_t + hb.hedge_delay() if t.hedge else None
        )
        self._watch = t.watchdog
        self._win_start = self._opened_t
        self._win_bytes = 0
        self._launch()

    def _launch(self) -> None:
        idx = len(self._attempts)
        self._attempts.append(_Attempt(
            idx,
            lambda: self._hb.inner.open_read(
                self._name, self._start, self._length
            ),
            self._q,
            chunk_bytes=self._hb.chunk_bytes,
        ))

    # ------------------------------------------------------- internals --
    def _deadline(self) -> Optional[float]:
        dl = None
        if self._hedge_at is not None and self._winner is None:
            dl = self._hedge_at
        if self._watch:
            stall_at = self._win_start + self._hb.tail.stall_window_s
            dl = stall_at if dl is None else min(dl, stall_at)
        return dl

    def _fail(self, exc: BaseException) -> None:
        self.close()
        raise exc

    def _check_stall(self, now: float) -> None:
        if not self._watch:
            return
        elapsed = now - self._win_start
        window = self._hb.tail.stall_window_s
        if elapsed < window:
            return
        rate = self._win_bytes / elapsed if elapsed > 0 else 0.0
        if rate < self._hb.tail.stall_floor_bps:
            self._hb.note_stall()
            _flight_annotate(
                "stall", rate_bps=int(rate), window_s=elapsed,
                floor_bps=self._hb.tail.stall_floor_bps, hedged=True,
            )
            self._fail(StallError(
                f"hedged stream stalled: {rate:.0f} B/s over "
                f"{elapsed:.2f}s window "
                f"(floor {self._hb.tail.stall_floor_bps:.0f} B/s)"
            ))
        self._win_start = now
        self._win_bytes = 0

    def _maybe_hedge(self, now: float) -> None:
        if self._hedge_at is None or self._winner is not None:
            return
        if now < self._hedge_at:
            return
        self._hedge_at = None
        delay = now - self._opened_t
        self._hb.note_hedge_launched()
        _flight_annotate("hedge", event="launch", delay_s=round(delay, 6))
        self._launch()

    def _set_winner(self, att: _Attempt) -> None:
        self._winner = att
        hedged = len(self._attempts) > 1
        if hedged:
            if att.idx > 0:
                self._hb.note_hedge_result(win=True)
                _flight_annotate("hedge", event="win")
            else:
                self._hb.note_hedge_result(win=False)
                _flight_annotate("hedge", event="lose")
        for other in self._attempts:
            if other is not att:
                other.cancel()
        self.first_byte_ns = att.first_byte_ns
        if self.first_byte_ns is None:
            self.first_byte_ns = time.perf_counter_ns()
        self._hb.note_first_byte(self._hb._clock() - self._opened_t)

    @property
    def generation(self):
        att = self._winner or (self._attempts[0] if self._attempts else None)
        return att.generation if att is not None else None

    # ------------------------------------------------------ ObjectReader --
    def readinto(self, buf: memoryview) -> int:
        if self._pending:
            return self._copy_out(buf)
        if self._eof or self._closed:
            return 0
        # Fresh stall window per call: only time spent waiting in THIS
        # call counts toward the stall verdict — a caller that paused
        # between readintos (a staging sink draining a device_put) must
        # not be mistaken for a stalled stream. A genuine stall blocks
        # right here, so the window still elapses within one call.
        self._win_start = self._hb._clock()
        self._win_bytes = 0
        while True:
            now = self._hb._clock()
            self._maybe_hedge(now)
            self._check_stall(now)
            dl = self._deadline()
            timeout = None if dl is None else max(0.001, dl - now)
            try:
                idx, kind, payload = self._q.get(timeout=timeout)
            except queue.Empty:
                continue  # re-evaluate deadlines (hedge launch / stall)
            att = self._attempts[idx]
            if self._winner is None:
                if kind == "err":
                    self._errors[idx] = payload
                    # An attempt died before any byte: if a sibling is
                    # still racing, let it run; once every launched
                    # attempt is dead, surface the error — failure
                    # recovery belongs to the retry layer above, not to
                    # a hedge against a failing endpoint.
                    live = [
                        a for a in self._attempts
                        if a.idx not in self._errors
                    ]
                    if not live:
                        self._fail(payload)
                    continue
                self._set_winner(att)
            if att is not self._winner:
                continue  # loser traffic: dropped (waste counted at close)
            if kind == "data":
                att.credits.release()
                self._win_bytes += len(payload)
                self._pending.append(payload)
                return self._copy_out(buf)
            if kind == "eof":
                self._eof = True
                return 0
            self._fail(payload)  # winner mid-stream error: propagate

    def _copy_out(self, buf: memoryview) -> int:
        chunk = self._pending[0]
        n = min(len(buf), len(chunk))
        buf[:n] = chunk[:n]
        if n == len(chunk):
            self._pending.popleft()
        else:
            self._pending[0] = chunk[n:]
        return n

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for att in self._attempts:
            att.cancel()
        wasted = sum(
            a.bytes for a in self._attempts if a is not self._winner
        )
        if wasted:
            self._hb.note_waste(wasted)


class HedgedBackend(_WrapperBackend):
    """Hedged-read wrapper; also the home of the run's rolling first-byte
    latency samples (the adaptive hedge delay) and the hedge stats."""

    def __init__(
        self,
        inner: StorageBackend,
        tail: TailConfig,
        clock: Callable[[], float] = time.monotonic,
        chunk_bytes: int = _HEDGE_CHUNK,
    ):
        super().__init__(inner)
        self.tail = tail
        self._clock = clock
        # Producer chunk size. Matches the workload's granule when built
        # via open_backend, so hedging does not change the read's
        # granule-pacing semantics (paced fakes meter per call).
        self.chunk_bytes = max(1, chunk_bytes)
        self._lock = threading.Lock()
        self._fb_samples: deque = deque(maxlen=512)
        self._fb_p99: Optional[float] = None
        self._fb_since_p99 = 0
        # Live override of the fixed delay (the tune controller's
        # hedge-delay actuation): replaces tail.hedge_delay_s inside
        # hedge_delay() without mutating shared config; the rolling-p99
        # adaptive path still floors at it, exactly as it floors at the
        # configured fixed delay.
        self._delay_override: Optional[float] = None
        self.stats = {
            "reads": 0,
            "hedges": 0,
            "hedge_wins": 0,
            "hedge_losses": 0,
            "wasted_bytes": 0,
            "stalls": 0,
        }

    # ------------------------------------------------------------ stats --
    def note_first_byte(self, seconds: float) -> None:
        with self._lock:
            self._fb_samples.append(seconds)
            self._fb_since_p99 += 1
            # Refresh the cached p99 every N samples instead of sorting
            # the whole window on every open (the hedge-delay hot path).
            if self._fb_p99 is None or self._fb_since_p99 >= 16:
                self._fb_since_p99 = 0
                if len(self._fb_samples) >= 8:
                    samples = sorted(self._fb_samples)
                    self._fb_p99 = samples[
                        min(len(samples) - 1, int(0.99 * len(samples)))
                    ]

    def note_hedge_launched(self) -> None:
        with self._lock:
            self.stats["hedges"] += 1

    def note_hedge_result(self, win: bool) -> None:
        with self._lock:
            self.stats["hedge_wins" if win else "hedge_losses"] += 1

    def note_waste(self, nbytes: int) -> None:
        with self._lock:
            self.stats["wasted_bytes"] += nbytes

    def note_stall(self) -> None:
        with self._lock:
            self.stats["stalls"] += 1

    def set_hedge_delay(self, seconds: float) -> None:
        """Live fixed-delay override (tune controller actuation)."""
        with self._lock:
            self._delay_override = max(0.0, float(seconds))

    def hedge_delay(self) -> float:
        """The delay before a hedge launches: fixed (or its live tune
        override), or the cached p99(first-byte) × scale once enough
        samples exist (floored at the fixed delay so a cold cache can't
        hedge-storm)."""
        t = self.tail
        with self._lock:
            base = (
                self._delay_override
                if self._delay_override is not None else t.hedge_delay_s
            )
            p99 = self._fb_p99
        if t.hedge_from_p99 and p99 is not None:
            return max(base, p99 * t.hedge_p99_scale)
        return base

    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        with self._lock:
            self.stats["reads"] += 1
        return HedgedReader(self, name, start, length)


# ------------------------------------------------------------ assembly ----


def wrap_tail(
    inner: StorageBackend,
    tail: Optional[TailConfig],
    clock: Callable[[], float] = time.monotonic,
    chunk_bytes: int = _HEDGE_CHUNK,
) -> StorageBackend:
    """Compose the configured tail-tolerance wrappers around ``inner``
    (innermost breaker → watchdog → hedging outermost). With hedging on,
    stall detection runs inside the hedged reader (async, catches
    blackholes); standalone, it runs at readinto boundaries."""
    if tail is None or not tail.active:
        return inner
    b = inner
    if tail.breaker:
        b = BreakerBackend(b, tail, clock=clock)
    if tail.watchdog and not tail.hedge:
        b = WatchdogBackend(b, tail, clock=clock)
    if tail.hedge:
        b = HedgedBackend(b, tail, clock=clock, chunk_bytes=chunk_bytes)
    return b


def find_tail_layer(backend, cls):
    """First wrapper of type ``cls`` in the backend's ``.inner`` chain,
    or None — how the tune controller reaches the HedgedBackend for its
    live hedge-delay actuation without the workload threading it."""
    b = backend
    seen = 0
    while b is not None and seen < 16:
        seen += 1
        if isinstance(b, cls):
            return b
        b = getattr(b, "inner", None)
    return None


def collect_tail_stats(backend) -> dict:
    """Walk the wrapper chain (``.inner`` links) and gather every tail
    layer's counters — the ``extra["tail"]`` stamp the read workload and
    the chaos scorecard consume."""
    out: dict = {}
    b = backend
    seen = 0
    while b is not None and seen < 16:
        seen += 1
        if isinstance(b, HedgedBackend):
            h = dict(b.stats)
            out["hedge"] = h
            out.setdefault("watchdog", {"stalls": 0})
            out["watchdog"]["stalls"] += h.pop("stalls", 0)
        elif isinstance(b, WatchdogBackend):
            out.setdefault("watchdog", {"stalls": 0})
            out["watchdog"]["stalls"] += b.stalls
        elif isinstance(b, BreakerBackend):
            out["breaker"] = b.breaker.snapshot()
        b = getattr(b, "inner", None)
    return out
