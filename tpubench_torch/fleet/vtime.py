"""Discrete-event virtual time: the clock/scheduler seam made load-bearing.

The determinism gate (`check`) holds every plane to injectable clocks
(``AdmissionQueue(clock_ns=...)``, ``Membership(clock=...)``, the storm
ledger, the arrival schedule). This module supplies the other half of
that contract: a single-threaded event loop whose :class:`VirtualClock`
IS those injectables — time advances only when the heap pops the next
event, so a "sleep" costs one heap operation instead of real seconds,
and a 4096-host scenario replays bit-identically for a seed because
there is no thread interleaving left to vary.

Two deliberate restrictions keep the kernel honest:

* Events at equal timestamps fire in schedule order (a monotonic
  sequence breaks ties) — FIFO at a tick, never hash order.
* The loop never runs callbacks re-entrantly: a callback that schedules
  more work enqueues it; the drain loop in :meth:`EventLoop.run` is the
  only place events fire. Exceptions propagate — a sim bug must fail
  the run, not vanish into a thread.
"""

from __future__ import annotations

import heapq
from typing import Callable, Optional


class VirtualClock:
    """The injectable-clock surface over a simulated timestamp.

    ``now()`` (seconds, the ``Membership(clock=...)`` shape) and
    ``now_ns()`` (integer nanoseconds, the ``AdmissionQueue(clock_ns=)``
    / ``Request.enqueue_ns`` shape) read the same underlying instant,
    so deadline math in the queue and window math in the membership
    plane can never skew against each other the way two real clock
    reads can."""

    __slots__ = ("_now_s",)

    def __init__(self, start_s: float = 0.0):
        self._now_s = float(start_s)

    def now(self) -> float:
        return self._now_s

    def now_ns(self) -> int:
        # Round, don't truncate: a service completion scheduled at
        # exactly its deadline must compare equal through the ns domain
        # (done_ns <= deadline_ns), not lose 1ns to float flooring.
        return round(self._now_s * 1e9)

    def _advance_to(self, t_s: float) -> None:
        # Monotonic by construction — the heap only pops forward, and a
        # stale event (scheduled in the past by float noise) clamps.
        if t_s > self._now_s:
            self._now_s = t_s


class EventLoop:
    """Event-heap scheduler: ``(t_s, seq)``-ordered callbacks over a
    :class:`VirtualClock`.

    The API is the cooperative subset a simulated worker needs —
    ``call_at`` / ``call_after`` (the virtual ``sleep``), and
    ``wait_until`` (the condition-wait: poll a predicate at a bounded
    interval until it holds or a deadline passes, the virtual analogue
    of ``threading.Condition.wait_for``). ``run()`` drains to heap
    exhaustion or an optional horizon."""

    def __init__(self, clock: Optional[VirtualClock] = None):
        self.clock = clock if clock is not None else VirtualClock()
        self._heap: list = []
        self._seq = 0
        self.events_fired = 0

    # ------------------------------------------------------ schedule --
    def call_at(self, t_s: float, fn: Callable[[], None]) -> None:
        """Run ``fn`` at virtual time ``t_s`` (clamped to now: the past
        is not schedulable, it fires at the current instant)."""
        self._seq += 1
        heapq.heappush(
            self._heap, (max(t_s, self.clock.now()), self._seq, fn)
        )

    def call_after(self, delay_s: float, fn: Callable[[], None]) -> None:
        """The virtual ``sleep(delay_s); fn()`` — negative delays clamp
        to zero (fire this tick, after already-queued work)."""
        self.call_at(self.clock.now() + max(0.0, delay_s), fn)

    def wait_until(self, predicate: Callable[[], bool],
                   fn: Callable[[], None], *, poll_s: float,
                   deadline_s: Optional[float] = None,
                   on_timeout: Optional[Callable[[], None]] = None) -> None:
        """Condition-wait: run ``fn`` as soon as ``predicate()`` holds,
        polling every ``poll_s`` virtual seconds. Past ``deadline_s``
        the wait abandons (``on_timeout`` fires if given) — an unbounded
        virtual wait on a condition nothing will satisfy would spin the
        heap forever, the sim analogue of a wedged thread."""
        if poll_s <= 0:
            raise ValueError(f"wait_until poll_s={poll_s!r}: must be > 0")

        def attempt() -> None:
            if predicate():
                fn()
                return
            if deadline_s is not None and self.clock.now() >= deadline_s:
                if on_timeout is not None:
                    on_timeout()
                return
            self.call_after(poll_s, attempt)

        self.call_at(self.clock.now(), attempt)

    # ----------------------------------------------------------- run --
    def run(self, until_s: Optional[float] = None) -> float:
        """Drain the heap in timestamp order, advancing the clock to
        each event as it fires. With ``until_s``, events strictly later
        stay queued and the clock parks at the horizon (the caller can
        ``run`` again). Returns the clock's final reading."""
        while self._heap:
            t_s, _seq, fn = self._heap[0]
            if until_s is not None and t_s > until_s:
                break
            heapq.heappop(self._heap)
            self.clock._advance_to(t_s)
            self.events_fired += 1
            fn()
        if until_s is not None:
            self.clock._advance_to(until_s)
        return self.clock.now()

    @property
    def pending(self) -> int:
        return len(self._heap)
