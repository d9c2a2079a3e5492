"""Elastic pod membership: epoch-numbered views driving the coop ring
(a copy of ``tpubench/dist/membership.py``).

The single-host serve plane and the coop cache ring assume fixed
membership — neither can measure the production scenario
where a pod *changes shape under load*: hosts join as diurnal traffic
ramps, leave cooperatively when it ebbs, and sometimes just die. This
module makes membership a first-class, observable axis:

* :class:`Membership` — a small deterministic state machine. Every host
  is ``up``, ``paused`` or ``down``; every transition (join / leave /
  fail / pause / resume) bumps a monotonically increasing **epoch** and
  is journaled as a ``kind="member"`` flight record, so the journal can
  say exactly when the pod's shape changed (and ``report timeline`` /
  ``top`` count it). The clock is injectable (the
  determinism rule): the elastic serve harness drives it with *virtual
  schedule time*, so event stamps line up with arrival stamps and tests
  replay the same timeline bit-for-bit.
* :class:`ElasticFabric` — the membership-aware loopback fabric for
  hermetic threaded pods (the ``run_coop_sim`` broker grown up): it
  owns the shared :class:`~tpubench_torch.pipeline.coop.LoopbackBroker`, the
  shared :class:`~tpubench_torch.pipeline.coop.HashRing` and the pod's
  :class:`~tpubench_torch.pipeline.coop.CoopCache` handles, subscribes to the
  membership, and translates each transition into transport + ring
  effects:

  - **fail (kill)** — the host's serve side unregisters immediately (no
    handoff): peers asking it get a definitive ``PeerMissError`` and
    fall back to origin under the existing breaker/retry composition;
    its ring points leave, so ~1/N of chunk ownership remaps.
  - **leave (cooperative)** — the ring updates first, then the departing
    host **drains its hot set** over the ordinary peer channel to each
    chunk's NEW owner (:meth:`ElasticFabric.leave_host`), so the pod
    re-warms from host RAM instead of re-fetching from origin. Handoff
    bytes are journaled as a ``member`` note (no epoch bump — the view
    already changed).
  - **pause / resume** — the host stays on the ring but its peer serve
    raises *transient* errors: the requester's bounded peer-tier retry
    re-asks, then falls through to origin — the degradation path a
    stalled-but-not-dead host produces.
  - **join (rejoin)** — the host re-enters the ring CLEAN: its demotion
    state was purged when it left (``HashRing.remove_host`` forgets
    demotions) and :meth:`~tpubench_torch.pipeline.coop.CoopCache.reset_member_state`
    drops its stale peer-transfer samples, so a host that left demoted
    never re-enters pre-demoted and old straggler evidence cannot
    outlive the epoch bump.

Ownership remap accounting (:func:`remap_stats`) is computed over the
workload's own key universe — the "~1/N of keys move per event"
consistent-hash promise becomes a measured, per-event scorecard row
rather than a docstring claim.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

from tpubench_torch.pipeline.coop import CoopCache, HashRing, LoopbackBroker

# Membership actions that change the pod view (epoch bumps), plus the
# non-view note actions the journal also carries.
VIEW_ACTIONS = ("join", "leave", "fail", "pause", "resume")
NOTE_ACTIONS = ("handoff",)

# Host-level timeline entry keys (`[t0, t1, {action: host}]`) are
# single-sourced as config.MEMBER_TIMELINE_ACTIONS — the timeline
# validator, the chaos splitter and the serve dispatcher all read that
# tuple directly.

# Event-log bound (the EXACT_SAMPLE_CAP discipline): membership events
# are rare, but a looping chaos timeline must not grow host RSS.
EVENT_LOG_CAP = 4096


class MembershipError(ValueError):
    """An invalid transition (e.g. failing a host that is already down).
    The state machine refuses and does NOT bump the epoch — a chaos
    timeline that kills a host twice gets one kill and one error."""


@dataclass(frozen=True)
class MemberEvent:
    """One journaled membership-plane event."""

    epoch: int
    action: str  # VIEW_ACTIONS | NOTE_ACTIONS
    host: int
    t_s: float  # injected-clock stamp (virtual time under the harness)
    info: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {
            "epoch": self.epoch, "action": self.action,
            "host": self.host, "t_s": self.t_s,
        }
        if self.info:
            d.update(self.info)
        return d


class Membership:
    """Epoch-numbered pod membership state machine (module docstring).

    States: ``up`` (serving, dispatchable), ``paused`` (on the ring but
    unresponsive), ``down`` (off the ring). Transitions:

    ========  ===================  =======
    action    valid from           to
    ========  ===================  =======
    join      down / absent        up
    leave     up / paused          down
    fail      up / paused          down
    pause     up                   paused
    resume    paused               up
    ========  ===================  =======

    Every valid transition bumps :attr:`epoch` by exactly one; invalid
    transitions raise :class:`MembershipError` and change nothing.
    Listeners run OUTSIDE the membership lock (they take ring/broker
    locks of their own — lock-order discipline)."""

    def __init__(self, hosts: Iterable[int] = (), *,
                 clock: Callable[[], float] = time.monotonic,
                 flight_ring=None):
        self._clock = clock
        self._flight_ring = flight_ring
        self._lock = threading.Lock()
        self._states: dict[int, str] = {int(h): "up" for h in hosts}
        self._epoch = 0
        self._events: deque = deque(maxlen=EVENT_LOG_CAP)
        self._listeners: list[Callable[[MemberEvent], None]] = []

    # ----------------------------------------------------------- queries --
    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def state(self, host: int) -> Optional[str]:
        with self._lock:
            return self._states.get(int(host))

    def live_hosts(self) -> set[int]:
        """Hosts the front end may dispatch NEW work to (state ``up``;
        a paused host is unresponsive everywhere, not just peer-side)."""
        with self._lock:
            return {h for h, s in self._states.items() if s == "up"}

    def ring_hosts(self) -> set[int]:
        """Hosts that hold ring points (``up`` + ``paused``): a paused
        owner keeps its keys — routed misses pay the transient-retry →
        origin-fallback path, which is the point."""
        with self._lock:
            return {h for h, s in self._states.items() if s != "down"}

    def is_live(self, host: int) -> bool:
        return self.state(host) == "up"

    def view(self) -> dict:
        with self._lock:
            return {
                "epoch": self._epoch,
                "states": dict(self._states),
            }

    def events(self) -> list[MemberEvent]:
        with self._lock:
            return list(self._events)

    # ------------------------------------------------------- transitions --
    def subscribe(self, fn: Callable[[MemberEvent], None]) -> None:
        self._listeners.append(fn)

    def _transition(self, action: str, host: int, valid_from: tuple,
                    to: str, info: Optional[dict] = None) -> MemberEvent:
        host = int(host)
        with self._lock:
            cur = self._states.get(host)
            if cur not in valid_from:
                raise MembershipError(
                    f"cannot {action} host {host}: state is {cur!r} "
                    f"(valid from {'/'.join(str(v) for v in valid_from)})"
                )
            self._epoch += 1
            self._states[host] = to
            ev = MemberEvent(
                self._epoch, action, host, self._clock(), dict(info or {})
            )
            self._events.append(ev)
        self._journal(ev)
        for fn in self._listeners:
            fn(ev)
        return ev

    def join(self, host: int, info: Optional[dict] = None) -> MemberEvent:
        """A new or previously-departed host enters the pod (``up``)."""
        return self._transition("join", host, ("down", None), "up", info)

    def leave(self, host: int, info: Optional[dict] = None) -> MemberEvent:
        """Cooperative departure (the warm-handoff arm — the fabric
        drains the hot set right after the view changes)."""
        return self._transition("leave", host, ("up", "paused"), "down",
                                info)

    def fail(self, host: int, info: Optional[dict] = None) -> MemberEvent:
        """Host death: no handoff, no goodbye — the degradation arm."""
        return self._transition("fail", host, ("up", "paused"), "down",
                                info)

    def pause(self, host: int, info: Optional[dict] = None) -> MemberEvent:
        return self._transition("pause", host, ("up",), "paused", info)

    def resume(self, host: int, info: Optional[dict] = None) -> MemberEvent:
        return self._transition("resume", host, ("paused",), "up", info)

    def note_event(self, action: str, host: int,
                   info: Optional[dict] = None) -> MemberEvent:
        """Journal a membership-plane event that does NOT change the
        view (no epoch bump): the cooperative handoff's byte accounting
        rides here, stamped under the epoch the leave just created."""
        if action not in NOTE_ACTIONS:
            raise MembershipError(f"unknown note action {action!r}")
        with self._lock:
            ev = MemberEvent(
                self._epoch, action, int(host), self._clock(),
                dict(info or {}),
            )
            self._events.append(ev)
        self._journal(ev)
        return ev

    # ---------------------------------------------------------- journal --
    def _journal(self, ev: MemberEvent) -> None:
        if self._flight_ring is None:
            return
        op = self._flight_ring.begin(
            f"member/{ev.action}/host{ev.host}", "", install=False,
            kind="member",
        )
        op.note("member", action=ev.action, host=ev.host, epoch=ev.epoch,
                **ev.info)
        op.finish(0)


# ----------------------------------------------------------------- remap ----


def remap_stats(keys: Iterable, before: dict, after: dict) -> dict:
    """Ownership-remap accounting over one membership event: ``before``
    / ``after`` map each chunk key to its ring owner (None = no owner).
    Returns the moved-key count/fraction and the moved BYTES (the
    consistent-hash "~1/N per event" promise, measured)."""
    total = moved = 0
    moved_bytes = 0
    for k in keys:
        total += 1
        if before.get(k) != after.get(k):
            moved += 1
            moved_bytes += getattr(k, "length", 0)
    return {
        "keys": total,
        "remapped_keys": moved,
        "remap_fraction": (moved / total) if total else 0.0,
        "remap_bytes": moved_bytes,
    }


# ---------------------------------------------------------------- fabric ----


class ElasticFabric:
    """Membership-aware hermetic pod fabric (module docstring): the
    shared broker + shared ring + per-host CoopCache handles, with the
    per-host kill / pause / resume / leave / rejoin controls the chaos
    timeline drives. Mutating controls are called from ONE driver thread
    (the serve dispatcher / the test body); queries are thread-safe
    through the membership's and ring's own locks."""

    def __init__(self, n_hosts: int, *, vnodes: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 flight_ring=None):
        self.broker = LoopbackBroker()
        self.ring = HashRing(range(n_hosts), vnodes=vnodes)
        self.membership = Membership(
            range(n_hosts), clock=clock, flight_ring=flight_ring
        )
        self.membership.subscribe(self._apply)
        self._hosts: dict[int, CoopCache] = {}
        self._delays: dict[int, float] = {}

    # ---------------------------------------------------------- plumbing --
    def add_host(self, coop: CoopCache, *, delay_s: float = 0.0) -> None:
        """Register one host's CoopCache with the fabric: its serve side
        answers peer requests, its accept side lands warm handoffs."""
        h = int(coop.host_id)
        self._hosts[h] = coop
        self._delays[h] = delay_s
        self.broker.register(
            h, coop.serve, delay_s=delay_s, accept=coop.accept_handoff
        )

    def coop(self, host: int) -> CoopCache:
        return self._hosts[int(host)]

    def hosts(self) -> dict[int, CoopCache]:
        return dict(self._hosts)

    def live_hosts(self) -> set[int]:
        return self.membership.live_hosts()

    def is_dispatchable(self, host: int) -> bool:
        return self.membership.is_live(host)

    def owners_of(self, keys: Iterable) -> dict:
        """Current ring owner per key (the remap-accounting probe)."""
        return {k: self.ring.owner(k) for k in keys}

    # ---------------------------------------------------------- controls --
    def kill_host(self, host: int) -> bool:
        """Host death: fail the membership (no handoff). Returns False
        when the host was already down (double-kill in a timeline)."""
        try:
            self.membership.fail(host)
            return True
        except MembershipError:
            return False

    def pause_host(self, host: int) -> bool:
        try:
            self.membership.pause(host)
            return True
        except MembershipError:
            return False

    def resume_host(self, host: int) -> bool:
        try:
            self.membership.resume(host)
            return True
        except MembershipError:
            return False

    def rejoin_host(self, host: int) -> bool:
        """A departed host re-enters — CLEAN (see module docstring)."""
        try:
            self.membership.join(host)
            return True
        except MembershipError:
            return False

    def leave_host(self, host: int, *, max_bytes: int = 0) -> Optional[dict]:
        """Cooperative departure with warm handoff: the view changes
        first (ring excludes the host, its serve side unregisters), then
        the departing host drains its hot set over the peer channel to
        each chunk's NEW owner — re-warming the pod from host RAM
        instead of origin. Returns the handoff stats (None when the host
        was not up/paused)."""
        coop = self._hosts.get(int(host))
        try:
            self.membership.leave(host)
        except MembershipError:
            return None
        if coop is None:
            return {"chunks": 0, "bytes": 0, "rejected": 0, "skipped": 0}
        stats = coop.drain_hot_set(
            push=lambda owner, key, data, tag: self.broker.push(
                int(host), owner, key, data, owner=tag
            ),
            owner_for=self.ring.owner,
            max_bytes=max_bytes,
        )
        self.membership.note_event("handoff", host, {
            "handoff_chunks": stats["chunks"],
            "handoff_bytes": stats["bytes"],
            "handoff_rejected": stats["rejected"],
        })
        # The departed host's RAM is gone once the drain is done — a
        # rejoin starts cold, exactly like the killed arm.
        coop.cache.close()
        return stats

    # -------------------------------------------------------- membership --
    def _apply(self, ev: MemberEvent) -> None:
        """Translate one membership transition into transport + ring
        effects (runs on the transitioning thread, outside the
        membership lock)."""
        if ev.action in ("leave", "fail"):
            # Off the ring (demotion state purged by remove_host) and
            # off the broker: peers asking a dead/departed host get a
            # definitive PeerMissError and fall back to origin. Stale
            # straggler evidence about the host dies with the epoch.
            self.ring.remove_host(ev.host)
            self.broker.unregister(ev.host)
            self.broker.resume(ev.host)
            for c in self._hosts.values():
                c.purge_host_samples(ev.host)
            if ev.action == "fail":
                # A killed host's RAM is GONE: drop its cache now so a
                # later rejoin starts cold — otherwise the kill arm's
                # scorecard would describe a pod where a dead host's
                # cache survived death. (The cooperative leave clears
                # AFTER its hot-set drain — see leave_host.)
                c = self._hosts.get(ev.host)
                if c is not None:
                    c.cache.close()
        elif ev.action == "join":
            c = self._hosts.get(ev.host)
            if c is not None:
                # Clean rejoin: no pre-demotion, no stale samples.
                c.reset_member_state()
                self.broker.register(
                    ev.host, c.serve,
                    delay_s=self._delays.get(ev.host, 0.0),
                    accept=c.accept_handoff,
                )
            self.ring.add_host(ev.host)
        elif ev.action == "pause":
            self.broker.pause(ev.host)
        elif ev.action == "resume":
            self.broker.resume(ev.host)

    # ------------------------------------------------------------- stats --
    def aggregate(self) -> dict:
        """Pod-wide counter roll-up (the scorecard's snapshot source):
        sums across every registered host's CoopCache."""
        agg = {
            "peer_requests": 0, "peer_hits": 0, "peer_misses": 0,
            "peer_bytes": 0, "origin_fetches": 0, "origin_bytes": 0,
            "pod_coalesced": 0, "handoff_out_chunks": 0,
            "handoff_out_bytes": 0, "handoff_in_chunks": 0,
            "handoff_in_bytes": 0, "handoff_rejects": 0,
        }
        for c in self._hosts.values():
            s = c.stats()
            for k in agg:
                agg[k] += s.get(k, 0)
        agg["epoch"] = self.membership.epoch
        return agg

    def close(self) -> None:
        for c in self._hosts.values():
            c.close()
