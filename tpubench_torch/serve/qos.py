"""QoS scheduling primitives for the open-loop serve plane (a copy of
``tpubench/serve/qos.py``).

Three ideas, each with a closed-loop ancestor in the codebase:

* :class:`AdmissionQueue` — the serve plane's runnable queue. The
  native fetch executor bounded concurrency with a LIVE admission cap
  (`active[0]`: completions stop being refilled past the cap); this
  generalizes that hook for multi-tenant traffic: requests queue in
  **priority order** (priority class first, arrival order within a
  class), at most ``cap`` requests are in service at once (``set_cap``
  is the tune controller's actuator — the same "workers" knob shape),
  and under overload the queue sheds instead of growing without bound —
  lowest-priority-first when the queue limit is hit, and
  **deadline-aware** at pop time (a request that already cannot make
  its deadline is dropped before a worker burns service time on it).
  ``qos=False`` degrades to a plain FIFO with no shedding and no
  priorities: the baseline arm of the QoS A/B.

* Per-class **weighted budgets** — enforced inside the chunk cache
  (owner-tagged entries, weighted eviction) and the prefetcher
  (per-owner byte budgets); this module only computes the budget splits
  from class weights.

* The **scorecard math** — per-class SLO attainment, the Jain fairness
  index over weight-normalized per-tenant goodput, and saturation-knee
  detection over a load sweep's (offered, goodput, p99) points.
"""

from __future__ import annotations

import hashlib
import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from tpubench_torch.pipeline.cache import ChunkKey


class ShedError(Exception):
    """A request dropped by admission control (queue overload or a
    deadline that can no longer be met). Carries where it was shed."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


@dataclass(frozen=True)
class Tenant:
    """One synthetic tenant: identity + its class's QoS contract."""

    name: str
    cls: str  # priority-class name (the budget/scorecard granularity)
    priority: int  # lower = more important (heap order)
    weight: float  # share of cache/prefetch budgets
    deadline_ms: float  # per-request SLO
    seed: int  # per-tenant popularity stream


def build_tenants(
    classes: Sequence[dict], n_tenants: int, seed: int = 0,
) -> list[Tenant]:
    """Expand the class spec list into ``n_tenants`` tenants, classes
    allotted by ``share`` (largest remainder, so small classes on small
    populations still get their tenant). Class dicts are validated by
    ``config.validate_serve_config`` before they reach here."""
    shares = [float(c["share"]) for c in classes]
    total = sum(shares)
    quotas = [s / total * n_tenants for s in shares]
    counts = [int(q) for q in quotas]
    # Largest remainder; every class with share > 0 gets at least one
    # tenant when the population allows (a class spec that exists but
    # never sends a request would poison the per-class scorecard).
    rem = sorted(
        range(len(classes)), key=lambda i: quotas[i] - counts[i], reverse=True
    )
    for i in rem:
        if sum(counts) >= n_tenants:
            break
        if counts[i] == int(quotas[i]):
            counts[i] += 1
    for i in range(len(classes)):
        if counts[i] == 0 and n_tenants >= len(classes):
            counts[i] = 1
    while sum(counts) > n_tenants:
        counts[counts.index(max(counts))] -= 1
    tenants: list[Tenant] = []
    for ci, c in enumerate(classes):
        for k in range(counts[ci]):
            tenants.append(Tenant(
                name=f"{c['name']}-{k}",
                cls=str(c["name"]),
                priority=int(c.get("priority", ci)),
                weight=float(c.get("weight", 1.0)),
                deadline_ms=float(c["deadline_ms"]),
                # Collision-free per-tenant popularity seed: an
                # arithmetic mix (seed*10k + ci*1k + k) collides once a
                # class exceeds its block and would hand distinct
                # tenants bit-identical Zipf streams — hash the triple
                # instead (blake2b: deterministic across processes,
                # unlike salted str hash()).
                seed=int.from_bytes(
                    hashlib.blake2b(
                        f"{seed}/{ci}/{k}".encode(), digest_size=8
                    ).digest(), "big",
                ),
            ))
    return tenants


def class_budget_split(classes: Sequence[dict], total_bytes: int) -> dict:
    """Weighted split of a byte budget across priority classes (the
    cache/prefetch budget maps): ``budget_i = total * w_i / Σw``."""
    if total_bytes <= 0:
        return {}
    wsum = sum(float(c.get("weight", 1.0)) for c in classes) or 1.0
    return {
        str(c["name"]): max(1, int(
            total_bytes * float(c.get("weight", 1.0)) / wsum
        ))
        for c in classes
    }


@dataclass
class Request:
    """One open-loop request: a tenant asking for one chunk."""

    tenant: Tenant
    key: ChunkKey
    arrival_s: float  # virtual schedule time (seconds from run start)
    enqueue_ns: int = 0  # real clock at push (deadline anchor)
    seq: int = 0
    index: int = 0  # position in the merged schedule (prefetch cursor)
    # Elastic pod: the front-end host this arrival was dispatched to
    # (-1 = single-host plane / no live host at dispatch time). A
    # worker that finds the host dead at pop time fails over.
    host: int = -1

    @property
    def deadline_ns(self) -> int:
        return self.enqueue_ns + int(self.tenant.deadline_ms * 1e6)


class AdmissionQueue:
    """Priority admission with a live cap and deadline-aware shedding
    (class docstring at module top).

    Workers call :meth:`pop` (blocking) and :meth:`done` when the
    request finishes; the dispatcher calls :meth:`push`. ``close()``
    wakes every waiter; remaining queued requests drain as sheds
    (``shed-drain`` — an open-loop run ends on the clock, and work
    still queued at the bell was NOT served: silently discarding it
    would inflate SLO attainment exactly under overload, where it
    matters)."""

    def __init__(self, *, cap: int, qos: bool = True,
                 queue_limit: int = 0,
                 clock_ns=time.perf_counter_ns,
                 on_shed=None):
        self._cap = max(1, int(cap))
        self.qos = qos
        self.queue_limit = max(0, int(queue_limit))
        self._clock_ns = clock_ns
        # Shed observer (flight breadcrumbs): called for EVERY shed —
        # queue overload, deadline, drain — on whichever thread shed.
        # Errors are swallowed; a breadcrumb must not shed twice.
        self._on_shed = on_shed
        self._cond = threading.Condition()
        self._heap: list[tuple[tuple, Request]] = []
        self._seq = 0
        self._in_service = 0
        self._closed = False
        # Per-class shed ledger: reason -> {cls: count}.
        self.shed: dict[str, dict[str, int]] = {
            "queue": {}, "deadline": {}, "drain": {},
        }
        self.pushed = 0
        self.popped = 0
        self.peak_queue = 0
        self.peak_in_service = 0

    # ------------------------------------------------------------- stats --
    def shed_count(self, cls: Optional[str] = None) -> int:
        n = 0
        for by_cls in self.shed.values():
            if cls is None:
                n += sum(by_cls.values())
            else:
                n += by_cls.get(cls, 0)
        return n

    def stats(self) -> dict:
        with self._cond:
            return {
                "qos": self.qos,
                "cap": self._cap,
                "queue_limit": self.queue_limit,
                "pushed": self.pushed,
                "popped": self.popped,
                "peak_queue": self.peak_queue,
                "peak_in_service": self.peak_in_service,
                "shed": {k: dict(v) for k, v in self.shed.items()},
                "shed_total": self.shed_count(),
            }

    # --------------------------------------------------------------- cap --
    @property
    def cap(self) -> int:
        return self._cap

    def set_cap(self, n: int) -> None:
        """Live admission-cap actuation (the tune controller's knob —
        the native executor's hook shape): a grow wakes parked workers
        immediately; a shrink takes effect as in-service requests
        complete (never a mid-request cancel)."""
        with self._cond:
            self._cap = max(1, int(n))
            self._cond.notify_all()

    # -------------------------------------------------------------- shed --
    def _shed_locked(self, req: Request, reason: str) -> None:
        by = self.shed[reason]
        by[req.tenant.cls] = by.get(req.tenant.cls, 0) + 1
        if self._on_shed is not None:
            try:
                self._on_shed(req, reason)
            except Exception:  # noqa: BLE001 — observer, never the valve
                pass

    # -------------------------------------------------------------- push --
    def push(self, req: Request) -> bool:
        """Enqueue an arrival. Returns False when the request was shed
        at the door (queue overload — QoS mode only: the VICTIM is the
        lowest-priority queued request, which may be an earlier arrival
        rather than this one; False then means *a* request was shed and
        this one queued in its place when it outranks the victim)."""
        with self._cond:
            if self._closed:
                self._shed_locked(req, "drain")
                return False
            req.seq = self._seq = self._seq + 1
            if not req.enqueue_ns:
                req.enqueue_ns = self._clock_ns()
            order = (
                (req.tenant.priority, req.seq) if self.qos else (0, req.seq)
            )
            heapq.heappush(self._heap, (order, req))
            self.pushed += 1
            self.peak_queue = max(self.peak_queue, len(self._heap))
            admitted = True
            if (
                self.qos and self.queue_limit
                and len(self._heap) > self.queue_limit
            ):
                # Overload valve: drop the LOWEST-priority queued entry
                # (latest arrival within the class) — the best-effort
                # tenant absorbs the shed so the high-priority queue
                # stays short. Without QoS the queue just grows: the
                # baseline arm measures what unbounded queueing does to
                # everyone's p99.
                idx = max(
                    range(len(self._heap)), key=lambda i: self._heap[i][0]
                )
                _, victim = self._heap[idx]
                self._heap[idx] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                self._shed_locked(victim, "queue")
                admitted = victim is not req
            self._cond.notify()
            return admitted

    # --------------------------------------------------------------- pop --
    def pop(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Next request for a service worker: highest priority first,
        admitted only while in-service < cap. QoS mode sheds requests
        whose deadline already passed at pop time (the work is doomed;
        serving it would only delay requests that can still make
        theirs). Returns None on close-and-empty or timeout."""
        # Injected-clock discipline (the tune-controller rule, enforced
        # by the reference's `check`): the wait budget runs on the same
        # clock_ns= the deadline decisions use, so tests/replay can
        # drive both with virtual time.
        deadline_ns = (
            None if timeout is None
            else self._clock_ns() + int(timeout * 1e9)
        )
        stalled_waits = 0
        with self._cond:
            while True:
                while self._heap and self._in_service < self._cap:
                    _, req = heapq.heappop(self._heap)
                    if self.qos and self._clock_ns() > req.deadline_ns:
                        self._shed_locked(req, "deadline")
                        continue
                    self._in_service += 1
                    self.peak_in_service = max(
                        self.peak_in_service, self._in_service
                    )
                    self.popped += 1
                    return req
                if self._closed:
                    return None
                if deadline_ns is not None:
                    remaining = (deadline_ns - self._clock_ns()) / 1e9
                    if remaining <= 0:
                        return None
                    before_ns = self._clock_ns()
                    notified = self._cond.wait(remaining)
                    if notified or self._clock_ns() > before_ns:
                        stalled_waits = 0
                        continue
                    # Condition.wait expires on REAL time; with a
                    # stalled virtual clock_ns= the remaining budget
                    # would never shrink and pop would spin forever.
                    # One zero-progress expiry loops back (a push's
                    # notify can race the expiry, and a coarse-stepped
                    # replay clock may advance just late) — the heap is
                    # re-examined at the loop top; a second consecutive
                    # one means nobody is driving the clock: honor the
                    # timeout.
                    stalled_waits += 1
                    if stalled_waits >= 2:
                        return None
                else:
                    self._cond.wait()

    def done(self) -> None:
        with self._cond:
            self._in_service = max(0, self._in_service - 1)
            self._cond.notify()

    # ------------------------------------------------------------- close --
    def close(self) -> int:
        """End of run: wake every waiter and drain still-queued requests
        as ``drain`` sheds (returned count) — see class docstring."""
        with self._cond:
            self._closed = True
            drained = 0
            while self._heap:
                _, req = heapq.heappop(self._heap)
                self._shed_locked(req, "drain")
                drained += 1
            self._cond.notify_all()
            return drained

    @property
    def queued(self) -> int:
        with self._cond:
            return len(self._heap)

    @property
    def in_service(self) -> int:
        with self._cond:
            return self._in_service


# --------------------------------------------------------------- scorecard --


def jain_index(values: Sequence[float]) -> Optional[float]:
    """Jain's fairness index ``(Σx)² / (n·Σx²)`` over per-tenant (or
    per-class) allocations: 1.0 = perfectly fair, 1/n = one tenant took
    everything. Tenants with zero allocation are legitimate samples
    (they were starved — that IS unfairness); an all-zero or empty set
    has no fairness story and returns None instead of dividing by
    zero."""
    vals = [float(v) for v in values]
    if not vals:
        return None
    sq = sum(v * v for v in vals)
    if sq <= 0:
        return None
    s = sum(vals)
    return (s * s) / (len(vals) * sq)


@dataclass
class ClassLedger:
    """Per-priority-class accounting a serve run accumulates (one
    instance per class, worker-merged under the scorecard lock)."""

    arrivals: int = 0
    completed: int = 0
    deadline_met: int = 0
    shed: int = 0
    errors: int = 0
    bytes: int = 0
    latency_ms: list = field(default_factory=list)

    def slo_attainment(self) -> Optional[float]:
        """Completed-within-deadline over ARRIVALS: a shed request is an
        SLO miss (the tenant asked; the system said no). None for a
        class that saw no traffic — zero arrivals is no evidence, and
        0/0 must not render as either 0% or 100%."""
        if self.arrivals <= 0:
            return None
        return self.deadline_met / self.arrivals


def find_knee(points: Sequence[dict], *, p99_factor: float = 2.0,
              goodput_slack: float = 0.9) -> Optional[dict]:
    """Locate the saturation knee on a load-sweep curve.

    ``points`` are per-load-step dicts carrying ``offered_rps``,
    ``achieved_rps`` and ``p99_ms`` (sorted by offered load by the
    caller). The knee is the FIRST point where the system stops keeping
    up with offered load: p99 inflates past ``p99_factor ×`` the
    lightest point's p99, or achieved throughput falls below
    ``goodput_slack ×`` offered. Returns ``{"index", "offered_rps",
    "reason"}`` or None when the sweep never saturates (the curve's
    whole range is below the knee)."""
    pts = [p for p in points if p.get("offered_rps")]
    if len(pts) < 2:
        return None
    base_p99 = None
    for p in pts:
        if p.get("p99_ms") is not None:
            base_p99 = p["p99_ms"]
            break
    for i, p in enumerate(pts):
        p99 = p.get("p99_ms")
        if (
            base_p99 and p99 is not None and i > 0
            and p99 > p99_factor * base_p99
        ):
            return {
                "index": i, "offered_rps": p["offered_rps"],
                "reason": "p99_inflection",
                "p99_ms": p99, "base_p99_ms": base_p99,
            }
        ach = p.get("achieved_rps")
        if ach is not None and ach < goodput_slack * p["offered_rps"]:
            return {
                "index": i, "offered_rps": p["offered_rps"],
                "reason": "goodput_saturation",
                "achieved_rps": ach,
            }
    return None
