"""``fleet`` — the elastic serve plane under virtual time.

This is the discrete-event twin of ``workloads/serve._ElasticServe``:
the same open-loop schedule (``build_schedule``), the same
:class:`~tpubench_torch.serve.qos.AdmissionQueue` (injected virtual
``clock_ns``, so priority order, queue-limit sheds and deadline sheds
are byte-identical logic), the same :class:`~tpubench_torch.dist.membership.
Membership` state machine and consistent-hash rings, and the same
``serve_scorecard`` / ``membership_scorecard`` math — but the worker
threads sleeping real seconds are replaced by one
:class:`~tpubench_torch.fleet.vtime.EventLoop`, and each request's service
time is a draw from a calibrated :class:`~tpubench_torch.fleet.calibrate.
FleetProfile` instead of a real backend fetch. That swap is what lifts
the host ceiling from ~4 (one OS thread per worker, wall-clock per
sleep) to 4096 (one heap event per state change).

What is simulated rather than executed, and the fidelity caveats that
follow, are documented in README "Fleet simulation":

* Payload bytes never materialize — caches account sizes (a real
  ``ChunkCache`` would coerce payloads to real ``bytes``, which at
  1024 hosts x 64 MB is RAM the simulation must not touch).
* The coop tier is modeled (ring owner probe -> peer RTT draw ->
  origin draw with pod-wide single-flight coalescing), not the real
  ``CoopCache``/``LoopbackBroker`` (both are thread-coupled).
* A paused owner charges a flat retry penalty
  (``fleet.pause_penalty_ms`` approximating the real
  PEER_MAX_ATTEMPTS x backoff ladder) instead of live transient
  errors.

Topology: hosts partition into contiguous pods, each pod with its own
coop ring; with >1 pod a routing ring over pod ids assigns every chunk
a HOME pod, and a pod-local miss hops cross-pod to the home owner
(``fleet.cross_pod_ms`` per hop) before paying origin — the cross-pod
routing tier above the coop ring.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional

import numpy as np

from tpubench_torch.config import (
    BenchConfig,
    parse_sleep_scale,
    validate_fleet_config,
    validate_serve_config,
)
from tpubench_torch.device import resolve_device
from tpubench_torch.dist.membership import (
    Membership,
    MembershipError,
    remap_stats,
)
from tpubench_torch.fleet.calibrate import FleetProfile
from tpubench_torch.fleet.vtime import EventLoop
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.metrics.recorder import LatencyRecorder
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs.flight import (
    flight_from_config,
    rank_journal_path,
    transport_label,
)
from tpubench_torch.pipeline.coop import HashRing
from tpubench_torch.serve.qos import (
    AdmissionQueue,
    ClassLedger,
    Request,
    find_knee,
)
from tpubench_torch.storage.base import ObjectMeta
from tpubench_torch.workloads.arrivals import scaled_gaps
from tpubench_torch.workloads.serve import (
    _merge_windows,
    build_schedule,
    membership_scorecard,
    serve_scorecard,
)

# Above this pod size the per-host stats list would dominate the result
# JSON (1024 dicts per run); the scorecard carries a roll-up instead.
PER_HOST_DETAIL_MAX = 16


class SimCache:
    """Byte-accounting LRU standing in for a host's ``ChunkCache``:
    keys map to sizes, never payloads. Hit/miss/eviction accounting
    mirrors the stats the membership scorecard's per-host block reads;
    single-flight lives in the driver's pod-wide in-flight map (where
    the real plane's per-host single-flight + coop owner routing net
    out to one origin fetch per key anyway)."""

    __slots__ = ("capacity", "bytes", "hits", "misses", "inserted_bytes",
                 "evictions", "rejects", "_lru")

    def __init__(self, capacity_bytes: int):
        self.capacity = max(0, int(capacity_bytes))
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.inserted_bytes = 0
        self.evictions = 0
        self.rejects = 0
        self._lru: OrderedDict = OrderedDict()

    def get(self, key) -> Optional[int]:
        n = self._lru.get(key)
        if n is None:
            self.misses += 1
            return None
        self._lru.move_to_end(key)
        self.hits += 1
        return n

    def contains(self, key) -> bool:
        return key in self._lru

    def insert(self, key, nbytes: int) -> bool:
        """Returns False when the chunk cannot fit even an empty cache
        (the real plane's oversize-skip / handoff-reject path)."""
        if key in self._lru:
            self._lru.move_to_end(key)
            return True
        n = int(nbytes)
        if n > self.capacity:
            self.rejects += 1
            return False
        while self.bytes + n > self.capacity and self._lru:
            _, old = self._lru.popitem(last=False)
            self.bytes -= old
            self.evictions += 1
        self._lru[key] = n
        self.bytes += n
        self.inserted_bytes += n
        return True

    def mru_items(self):
        """Hot-set drain order for the warm-handoff protocol (the real
        plane drains MRU-first so the most valuable bytes land first)."""
        return reversed(list(self._lru.items()))

    def clear(self) -> None:
        self._lru.clear()
        self.bytes = 0

    def stats(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "bytes": self.bytes, "capacity_bytes": self.capacity,
            "inserted_bytes": self.inserted_bytes,
            "evictions": self.evictions, "rejects": self.rejects,
            "entries": len(self._lru),
        }


class FleetFabric:
    """The simulated pod fabric: the REAL membership state machine over
    all hosts, per-pod consistent-hash rings, and (multi-pod) the home
    ring over pod ids — exposing the same query surface
    (``is_dispatchable`` / ``live_hosts`` / ``owners_of`` /
    ``aggregate``) the scorecards read off ``ElasticFabric``."""

    def __init__(self, n_hosts: int, n_pods: int, *, vnodes: int,
                 cache_bytes: int, clock, flight_ring=None):
        self.n_hosts = int(n_hosts)
        self.n_pods = max(1, min(int(n_pods), self.n_hosts))
        self.membership = Membership(
            range(self.n_hosts), clock=clock, flight_ring=flight_ring
        )
        self.pod_of = [
            h * self.n_pods // self.n_hosts for h in range(self.n_hosts)
        ]
        self.rings = [
            HashRing(
                (h for h in range(self.n_hosts) if self.pod_of[h] == p),
                vnodes=vnodes,
            )
            for p in range(self.n_pods)
        ]
        self.pod_ring = (
            HashRing(range(self.n_pods), vnodes=vnodes)
            if self.n_pods > 1 else None
        )
        self.caches = [SimCache(cache_bytes) for _ in range(self.n_hosts)]
        self.counters = {
            "peer_requests": 0, "peer_hits": 0, "peer_misses": 0,
            "peer_bytes": 0, "origin_fetches": 0, "origin_bytes": 0,
            "pod_coalesced": 0, "handoff_out_chunks": 0,
            "handoff_out_bytes": 0, "handoff_in_chunks": 0,
            "handoff_in_bytes": 0, "handoff_rejects": 0,
            "cross_pod_hits": 0, "cross_pod_bytes": 0,
        }

    # ------------------------------------------------------- queries --
    def is_dispatchable(self, host: int) -> bool:
        return self.membership.is_live(host)

    def live_hosts(self) -> set:
        return self.membership.live_hosts()

    def state(self, host: int) -> Optional[str]:
        return self.membership.state(host)

    def home_pod(self, key) -> int:
        if self.pod_ring is None:
            return 0
        p = self.pod_ring.owner(key)
        return 0 if p is None else p

    def owner_of(self, key) -> Optional[int]:
        """The authoritative owner: the home pod's ring owner (for one
        pod, simply the ring owner) — the remap-accounting probe."""
        return self.rings[self.home_pod(key)].owner(key)

    def owners_of(self, keys) -> dict:
        return {k: self.owner_of(k) for k in keys}

    def aggregate(self) -> dict:
        agg = dict(self.counters)
        agg["epoch"] = self.membership.epoch
        return agg

    # ------------------------------------------------------ controls --
    def _try(self, fn, host: int) -> bool:
        try:
            fn(host)
            return True
        except MembershipError:
            return False

    def kill_host(self, host: int) -> bool:
        """Host death: off the membership, off its pod ring, RAM gone
        (a rejoin starts cold — the real fabric's fail semantics)."""
        if not self._try(self.membership.fail, host):
            return False
        self.rings[self.pod_of[host]].remove_host(host)
        self.caches[host].clear()
        return True

    def leave_host(self, host: int) -> Optional[dict]:
        """Cooperative departure: view change first, then the warm
        handoff drains the hot set MRU-first to each chunk's NEW owner
        in the departing host's pod — re-warming from simulated host
        RAM instead of origin, with the same out/in/reject ledger."""
        if not self._try(self.membership.leave, host):
            return None
        ring = self.rings[self.pod_of[host]]
        ring.remove_host(host)
        c = self.counters
        stats = {"chunks": 0, "bytes": 0, "rejected": 0, "skipped": 0}
        for key, n in self.caches[host].mru_items():
            dest = ring.owner(key)
            if dest is None or not self.membership.is_live(dest):
                stats["skipped"] += 1
                continue
            stats["chunks"] += 1
            stats["bytes"] += n
            c["handoff_out_chunks"] += 1
            c["handoff_out_bytes"] += n
            if self.caches[dest].insert(key, n):
                c["handoff_in_chunks"] += 1
                c["handoff_in_bytes"] += n
            else:
                stats["rejected"] += 1
                c["handoff_rejects"] += 1
        self.membership.note_event("handoff", host, {
            "handoff_chunks": stats["chunks"],
            "handoff_bytes": stats["bytes"],
            "handoff_rejected": stats["rejected"],
        })
        self.caches[host].clear()
        return stats

    def pause_host(self, host: int) -> bool:
        # The ring keeps a paused host (the real fabric's choice):
        # requests routed to it pay the retry penalty, they don't remap.
        return self._try(self.membership.pause, host)

    def resume_host(self, host: int) -> bool:
        return self._try(self.membership.resume, host)

    def rejoin_host(self, host: int) -> bool:
        if not self._try(self.membership.join, host):
            return False
        self.rings[self.pod_of[host]].add_host(host)
        return True

    def per_host_stats(self) -> list:
        return [
            {"host": h, "cache": self.caches[h].stats(),
             "state": self.membership.state(h)}
            for h in range(self.n_hosts)
        ]


def resolve_profile(cfg: BenchConfig) -> FleetProfile:
    """The run's service-time profile: a fitted/loaded profile dict
    (``fleet.profile``, set by ``--fleet-profile`` / calibration) wins;
    otherwise the configured per-phase constants."""
    fc = cfg.fleet
    if fc.profile:
        return FleetProfile.from_dict(dict(fc.profile),
                                      where="fleet.profile")
    return FleetProfile.from_constants(
        hit_ms=fc.hit_service_ms, peer_ms=fc.peer_service_ms,
        origin_ms=fc.origin_service_ms, cross_pod_ms=fc.cross_pod_ms,
    )


def build_fleet_timeline(fc, n_hosts: int) -> list:
    """Generated membership timelines, in the serve plane's entry
    format (``[t0, t1, {action: host}]``) so windows/validation reuse
    the existing machinery.

    * ``correlated_failure``: ``fail_fraction`` of the fleet dies at
      ``fail_at_s`` (seeded draw — WHICH hosts die changes remap
      geometry, so it must replay for a seed); ``recover_s`` > 0
      rejoins every victim that much later, cold.
    * ``rolling_upgrade``: every host pauses for ``upgrade_pause_s``,
      starts staggered ``upgrade_stagger_s`` apart (0 = sequential,
      the next host starts as the previous resumes).
    """
    if fc.timeline == "none":
        return []
    if fc.timeline == "correlated_failure":
        rng = np.random.Generator(np.random.Philox(fc.seed))
        k = min(max(1, int(round(fc.fail_fraction * n_hosts))),
                n_hosts - 1)
        victims = sorted(
            int(v) for v in rng.choice(n_hosts, size=k, replace=False)
        )
        out = [[fc.fail_at_s, fc.fail_at_s, {"kill_host": v}]
               for v in victims]
        if fc.recover_s > 0:
            t = fc.fail_at_s + fc.recover_s
            out += [[t, t, {"rejoin_host": v}] for v in victims]
        return out
    if fc.timeline == "rolling_upgrade":
        stagger = fc.upgrade_stagger_s or fc.upgrade_pause_s
        return [
            [fc.fail_at_s + h * stagger,
             fc.fail_at_s + h * stagger + fc.upgrade_pause_s,
             {"pause_host": h}]
            for h in range(n_hosts)
        ]
    raise SystemExit(f"fleet.timeline={fc.timeline!r}: unknown kind")


def run_fleet(cfg: BenchConfig, rate_rps: Optional[float] = None,
              device="cuda") -> RunResult:
    """One virtual-time fleet run at the configured offered load.

    Control flow tracks ``_ElasticServe.run`` step for step (membership
    events gated on arrival time before each dispatch, round-robin
    front-end assignment over live hosts, failover at pop, the
    grace-then-drain close, shed-reasons merged into the ledgers) so
    the threaded-vs-virtual agreement gate compares like with like.
    ``device`` is resolved as every entry point resolves it (``"cpu"``
    runs without CUDA; CUDA asked for and missing raises); nothing runs
    on it."""
    resolve_device(device)
    cfg = BenchConfig.from_dict(cfg.to_dict())  # private copy: we sync knobs
    fc, sc, w = cfg.fleet, cfg.serve, cfg.workload
    if fc.hosts > 0:
        sc.hosts = fc.hosts
    sc.readahead = 0  # the sim has no prefetcher (README caveat)
    validate_serve_config(sc)
    validate_fleet_config(fc, sc)
    profile = resolve_profile(cfg)
    chunk = sc.chunk_bytes or w.granule_bytes

    # Synthetic object population: the fleet never opens a backend —
    # the schedule builder only needs names/sizes/generations.
    objects = [
        ObjectMeta(name=f"{w.object_name_prefix}fleet-{i:05d}",
                   size=w.object_size, generation=1)
        for i in range(fc.objects)
    ]
    schedule = build_schedule(cfg, None, rate_rps, objects=objects)
    scale = parse_sleep_scale("fleet arrival gaps")
    gaps = scaled_gaps([r.arrival_s for r in schedule], scale)

    n_workers = (fc.workers_per_host * sc.hosts
                 if fc.workers_per_host > 0 else sc.workers)
    qos = sc.qos
    flight = flight_from_config(cfg)
    tlabel = transport_label(cfg)

    loop = EventLoop()
    wclock = loop.clock  # simulated wall domain (service/deadline math)
    vnow = [0.0]  # arrival domain (membership/windows/snapshots)

    outcome: list = [None] * len(schedule)

    def on_shed(req: Request, reason: str) -> None:
        outcome[req.index] = False

    queue = AdmissionQueue(
        cap=sc.admission_cap or n_workers, qos=qos,
        queue_limit=(sc.queue_limit or 8 * n_workers) if qos else 0,
        clock_ns=wclock.now_ns, on_shed=on_shed,
    )

    n_pods = fc.pods or max(1, sc.hosts // 128)
    fabric = FleetFabric(
        sc.hosts, n_pods, vnodes=cfg.coop.vnodes,
        cache_bytes=cfg.pipeline.cache_bytes, clock=lambda: vnow[0],
        flight_ring=(
            flight.worker("member") if flight is not None else None
        ),
    )

    # ---- membership plan + resize windows (the threaded recipe) -----
    entries = list(sc.membership_timeline) + \
        build_fleet_timeline(fc, sc.hosts)
    member_plan: list = []
    windows: list = []
    for t0, t1, spec in entries:
        (action, host), = spec.items()
        t0, t1 = float(t0), float(t1)
        if action == "pause_host":
            member_plan.append((t0, "pause_host", int(host)))
            member_plan.append((t1, "resume_host", int(host)))
            windows.append([t0, t1 + sc.resize_window_s])
        else:
            member_plan.append((t0, action, int(host)))
            windows.append([t0, t0 + sc.resize_window_s])
    member_plan.sort(key=lambda e: e[0])
    windows = _merge_windows(windows)

    uniq_keys = list({r.key for r in schedule})
    events_out: list = []
    snapshots: list = []

    classes = sorted(sc.classes, key=lambda c: int(c.get("priority", 0)))
    ledgers = {str(c["name"]): ClassLedger() for c in classes}
    recorders = {
        str(c["name"]): LatencyRecorder(f"request_{c['name']}")
        for c in classes
    }
    agg_rec = LatencyRecorder("request")
    tenant_bytes: dict[str, int] = {}
    completed_bytes = [0]
    failovers = [0]
    no_live_host_errors = [0]
    drained = [0]

    for req in schedule:
        ledgers[req.tenant.cls].arrivals += 1

    def take_snapshot(t: float) -> None:
        agg = fabric.aggregate()
        agg["completed"] = sum(led.completed for led in ledgers.values())
        snapshots.append((t, agg))

    live_cache: list = [None]  # sorted live hosts, invalidated on events

    def live_sorted() -> list:
        if live_cache[0] is None:
            live_cache[0] = sorted(fabric.live_hosts())
        return live_cache[0]

    def apply_event(t: float, action: str, host: int) -> None:
        vnow[0] = max(vnow[0], t)
        live_cache[0] = None
        before = fabric.owners_of(uniq_keys)
        handoff = None
        if action == "kill_host":
            ok = fabric.kill_host(host)
        elif action == "leave_host":
            handoff = fabric.leave_host(host)
            ok = handoff is not None
        elif action == "pause_host":
            ok = fabric.pause_host(host)
        elif action == "resume_host":
            ok = fabric.resume_host(host)
        elif action == "rejoin_host":
            ok = fabric.rejoin_host(host)
        else:  # unreachable under validate_membership_timeline
            ok = False
        ev = {
            "t_s": t, "action": action, "host": host, "applied": ok,
            "epoch": fabric.membership.epoch,
        }
        ev.update(remap_stats(
            uniq_keys, before, fabric.owners_of(uniq_keys)
        ))
        if handoff is not None:
            ev["handoff"] = handoff
        events_out.append(ev)
        take_snapshot(t)

    # ---- service-time sampling + the modeled coop tier --------------
    srng = np.random.Generator(np.random.Philox(sc.seed + 17))
    d_hit = profile.phases["hit"]
    d_peer = profile.phases["peer"]
    d_origin = profile.phases["origin"]
    d_xpod = profile.phases["cross_pod"]
    pause_penalty_s = fc.pause_penalty_ms / 1e3
    # Pod-wide single-flight over origin fetches: key -> completion
    # time of the owning fetch; joiners coalesce at that instant.
    inflight: dict = {}
    ctr = fabric.counters

    def service_for(host: int, key, nbytes: int) -> tuple:
        """One request's resolution through the modeled tier chain:
        local hit -> pod peer -> cross-pod home owner -> origin (with
        pod-wide single-flight coalescing). Returns ``(service_s,
        paid_origin)`` — the caller registers origin-paying fetches in
        the in-flight map so later misses on the key coalesce onto
        them. Counter/cache effects apply at issue time (the payloads
        are size-only, so the completion-time distinction the real
        plane needs does not exist here — documented README caveat)."""
        cache = fabric.caches[host]
        if cache.get(key) is not None:
            return d_hit.sample_s(srng), False
        pod = fabric.pod_of[host]
        o = fabric.rings[pod].owner(key)
        svc = 0.0
        if o is not None and o != host:
            if fabric.state(o) == "paused":
                # Bounded transient retries against a stalled owner,
                # then origin — the flat-penalty approximation.
                ctr["peer_requests"] += 1
                ctr["peer_misses"] += 1
                svc += pause_penalty_s
            else:
                ctr["peer_requests"] += 1
                if fabric.caches[o].get(key) is not None:
                    ctr["peer_hits"] += 1
                    ctr["peer_bytes"] += nbytes
                    cache.insert(key, nbytes)
                    return svc + d_peer.sample_s(srng), False
                ctr["peer_misses"] += 1
                svc += d_peer.sample_s(srng)
        # Cross-pod routing tier: a pod-local miss asks the chunk's
        # HOME pod owner before paying origin.
        home = fabric.home_pod(key)
        if fabric.pod_ring is not None and home != pod:
            o2 = fabric.rings[home].owner(key)
            if o2 is not None and fabric.state(o2) == "up":
                ctr["peer_requests"] += 1
                svc += d_xpod.sample_s(srng)
                if fabric.caches[o2].get(key) is not None:
                    ctr["peer_hits"] += 1
                    ctr["peer_bytes"] += nbytes
                    ctr["cross_pod_hits"] += 1
                    ctr["cross_pod_bytes"] += nbytes
                    cache.insert(key, nbytes)
                    return svc + d_peer.sample_s(srng), False
                ctr["peer_misses"] += 1
                fl = inflight.get(key)
                if fl is not None:
                    ctr["pod_coalesced"] += 1
                    cache.insert(key, nbytes)
                    return max(svc, fl - wclock.now()), False
                # The home owner fetches origin and keeps a copy — the
                # cross-pod analogue of owner_fetch.
                svc += d_origin.sample_s(srng)
                ctr["origin_fetches"] += 1
                ctr["origin_bytes"] += nbytes
                fabric.caches[o2].insert(key, nbytes)
                cache.insert(key, nbytes)
                return svc, True
        # Origin, via the pod-local owner when one is live (the real
        # plane's owner_fetch), else direct.
        fl = inflight.get(key)
        if fl is not None:
            ctr["pod_coalesced"] += 1
            cache.insert(key, nbytes)
            return max(svc, fl - wclock.now()), False
        svc += d_origin.sample_s(srng)
        ctr["origin_fetches"] += 1
        ctr["origin_bytes"] += nbytes
        if o is not None and o != host and fabric.state(o) == "up":
            fabric.caches[o].insert(key, nbytes)
        cache.insert(key, nbytes)
        return svc, True

    # ---- the virtual worker pool ------------------------------------
    idle = [n_workers]

    def kick() -> None:
        while idle[0] > 0:
            req = queue.pop(timeout=0.0)
            if req is None:
                return
            idle[0] -= 1
            serve_one(req)

    def serve_one(req: Request) -> None:
        cls = req.tenant.cls
        host = req.host
        if not fabric.is_dispatchable(host):
            live = live_sorted()
            if not live:
                no_live_host_errors[0] += 1
                ledgers[cls].errors += 1
                outcome[req.index] = False
                queue.done()
                idle[0] += 1
                return
            host = live[req.index % len(live)]
            failovers[0] += 1
        nbytes = req.key.length
        svc, paid_origin = service_for(host, req.key, nbytes)
        if paid_origin:
            # Register the origin-owning fetch for coalescing — only
            # until it lands (later misses then hit the owner's cache).
            t_done = wclock.now() + svc
            inflight[req.key] = t_done

            def land(key=req.key, t=t_done):
                if inflight.get(key) == t:
                    del inflight[key]

            loop.call_at(t_done, land)

        def complete(req=req, cls=cls, nbytes=nbytes):
            done_ns = wclock.now_ns()
            met = done_ns <= req.deadline_ns
            led = ledgers[cls]
            led.completed += 1
            led.bytes += nbytes
            if met:
                led.deadline_met += 1
            tenant_bytes[req.tenant.name] = (
                tenant_bytes.get(req.tenant.name, 0) + nbytes
            )
            completed_bytes[0] += nbytes
            outcome[req.index] = bool(met)
            lat_ns = done_ns - req.enqueue_ns
            recorders[cls].record_ns(lat_ns)
            agg_rec.record_ns(lat_ns)
            queue.done()
            idle[0] += 1
            kick()

        loop.call_after(svc, complete)

    # ---- the open loop, one dispatch event per arrival --------------
    snap_every = max(1, len(schedule) // 64)
    cursor = [0]
    rr = [0]
    mp_i = [0]

    def close_queue() -> None:
        drained[0] = queue.close()

    def end_of_schedule() -> None:
        while mp_i[0] < len(member_plan):
            apply_event(*member_plan[mp_i[0]])
            mp_i[0] += 1
        grace_s = max(1.0, 2.0 * scale)
        loop.wait_until(
            lambda: queue.queued == 0 and queue.in_service == 0,
            close_queue, poll_s=0.005,
            deadline_s=wclock.now() + grace_s, on_timeout=close_queue,
        )

    def dispatch() -> None:
        i = cursor[0]
        cursor[0] += 1
        req = schedule[i]
        while (mp_i[0] < len(member_plan)
               and member_plan[mp_i[0]][0] <= req.arrival_s):
            apply_event(*member_plan[mp_i[0]])
            mp_i[0] += 1
        vnow[0] = max(vnow[0], req.arrival_s)
        live = live_sorted()
        req.host = live[rr[0] % len(live)] if live else -1
        rr[0] += 1
        req.enqueue_ns = wclock.now_ns()
        queue.push(req)
        if rr[0] % snap_every == 0:
            take_snapshot(req.arrival_s)
        kick()
        if cursor[0] < len(schedule):
            loop.call_after(gaps[cursor[0]], dispatch)
        else:
            end_of_schedule()

    wall_t0 = time.perf_counter_ns()
    take_snapshot(0.0)
    if schedule:
        loop.call_after(gaps[0], dispatch)
    else:
        loop.call_at(0.0, end_of_schedule)
    virtual_wall = loop.run()
    take_snapshot(max(vnow[0], sc.duration_s))
    real_wall = (time.perf_counter_ns() - wall_t0) / 1e9
    wall = max(virtual_wall, 1e-9)

    qstats = queue.stats()
    qstats["drained_at_close"] = drained[0]
    for reason, by_cls in qstats["shed"].items():
        for cls, n in by_cls.items():
            if cls in ledgers:
                ledgers[cls].shed += n

    serve_extra = serve_scorecard(
        sc, schedule, ledgers, recorders, tenant_bytes, qstats,
        wall, completed_bytes[0], classes,
    )
    per_host = (
        fabric.per_host_stats() if sc.hosts <= PER_HOST_DETAIL_MAX
        else []
    )
    membership = membership_scorecard(
        sc, schedule, outcome, events_out, windows, snapshots, per_host,
        failovers[0], no_live_host_errors[0], 0, classes, fabric,
    )

    summaries = {}
    if len(agg_rec):
        summaries["request"] = summarize_ns(agg_rec.as_ns_array())
    for cls, rec in recorders.items():
        if len(rec):
            summaries[f"request_{cls}"] = summarize_ns(rec.as_ns_array())
    gbps = (completed_bytes[0] / 1e9) / wall if wall > 0 else 0.0
    errors = sum(led.errors for led in ledgers.values())
    res = RunResult(
        workload="fleet",
        config=cfg.to_dict(),
        bytes_total=completed_bytes[0],
        wall_seconds=wall,
        gbps=gbps,
        gbps_per_chip=gbps,
        n_chips=1,
        summaries=summaries,
        errors=errors,
    )
    res.extra["serve"] = serve_extra
    res.extra["membership"] = membership
    res.extra["fleet"] = {
        "hosts": sc.hosts,
        "pods": fabric.n_pods,
        "workers": n_workers,
        "tenants": sc.tenants,
        "timeline": fc.timeline,
        "arrivals": len(schedule),
        "cross_pod": {
            "hits": ctr["cross_pod_hits"],
            "bytes": ctr["cross_pod_bytes"],
        },
        "profile": profile.summary(),
        "sim": {
            "virtual_s": round(virtual_wall, 6),
            "real_wall_s": round(real_wall, 6),
            "speedup": round(virtual_wall / real_wall, 2)
            if real_wall > 0 else None,
            "events_fired": loop.events_fired,
            "hosts_per_wall_s": round(sc.hosts / real_wall, 1)
            if real_wall > 0 else None,
        },
    }
    if flight is not None:
        ring = flight.worker("fleet")
        op = ring.begin("fleet", tlabel, kind="fleet", install=False)
        op.note(
            "fleet", hosts=sc.hosts, pods=fabric.n_pods,
            virtual_s=round(virtual_wall, 6),
            real_wall_s=round(real_wall, 6),
            events=loop.events_fired,
        )
        op.finish(0)
        res.extra["flight"] = flight.summary()
        if cfg.obs.flight_journal:
            jpath = rank_journal_path(cfg)
            res.extra["flight_journal"] = flight.write_journal(
                jpath, extra={"workload": "fleet", "n_chips": 1},
                max_bytes=cfg.obs.journal_max_bytes,
            )
    return res


def run_fleet_sweep(cfg: BenchConfig, device="cuda") -> RunResult:
    """``fleet --fleet-sweep``: the serve-plane load sweep
    under virtual time — same point schema, same knee detector, so
    converted bench cells and the agreement gate compare rung for
    rung."""
    points = []
    results = []
    for mult in cfg.serve.sweep_points:
        c = BenchConfig.from_dict(cfg.to_dict())
        if cfg.serve.sweep_duration_s > 0:
            c.serve.duration_s = cfg.serve.sweep_duration_s
        c.telemetry.port = -1
        c.telemetry.enabled = False
        c.telemetry.otlp = False
        if c.obs.flight_journal:
            c.obs.flight_journal = f"{c.obs.flight_journal}.pt{len(points)}"
        res = run_fleet(c, rate_rps=cfg.serve.rate_rps * mult,
                        device=device)
        sv = res.extra["serve"]
        gold = min(
            sv["classes"].values(), key=lambda x: x["priority"]
        ) if sv["classes"] else {}
        s = res.summaries.get("request")
        points.append({
            "multiplier": mult,
            "offered_rps": sv["offered_rps"],
            "achieved_rps": sv["achieved_rps"],
            "goodput_gbps": sv["goodput_gbps"],
            "p99_ms": s.p99_ms if s is not None else None,
            "gold_p99_ms": gold.get("p99_ms"),
            "gold_slo_attainment": gold.get("slo_attainment"),
            "shed": sv["shed"],
            "jain_fairness": sv["jain_fairness"],
        })
        results.append(res)
    knee = find_knee(points)
    last = results[-1]
    res = RunResult(
        workload="fleet",
        config=cfg.to_dict(),
        bytes_total=sum(r.bytes_total for r in results),
        wall_seconds=sum(r.wall_seconds for r in results),
        gbps=last.gbps,
        gbps_per_chip=last.gbps,
        n_chips=1,
        summaries=last.summaries,
        errors=sum(r.errors for r in results),
    )
    res.extra["serve"] = {
        "qos": cfg.serve.qos,
        "sweep": {
            "base_rate_rps": cfg.serve.rate_rps,
            "points": points,
            "knee": knee,
        },
    }
    res.extra["fleet"] = {
        "hosts": results[-1].extra["fleet"]["hosts"],
        "pods": results[-1].extra["fleet"]["pods"],
        "workers": results[-1].extra["fleet"]["workers"],
        "tenants": cfg.serve.tenants,
        "timeline": cfg.fleet.timeline,
        "arrivals": sum(r.extra["fleet"]["arrivals"] for r in results),
        "profile": results[-1].extra["fleet"]["profile"],
        "sim": {
            "virtual_s": round(sum(
                r.extra["fleet"]["sim"]["virtual_s"] for r in results
            ), 6),
            "real_wall_s": round(sum(
                r.extra["fleet"]["sim"]["real_wall_s"] for r in results
            ), 6),
            "events_fired": sum(
                r.extra["fleet"]["sim"]["events_fired"] for r in results
            ),
        },
    }
    sim = res.extra["fleet"]["sim"]
    if sim["real_wall_s"] > 0:
        sim["speedup"] = round(sim["virtual_s"] / sim["real_wall_s"], 2)
    return res


def format_fleet_block(fl: dict) -> str:
    """Human rendering of ``extra["fleet"]`` (CLI + ``report``)."""
    lines = ["== fleet simulation =="]
    sim = fl.get("sim", {})
    lines.append(
        f"  hosts={fl.get('hosts')}  pods={fl.get('pods')}  "
        f"workers={fl.get('workers')}  tenants={fl.get('tenants')}  "
        f"timeline={fl.get('timeline')}"
    )
    spd = sim.get("speedup")
    lines.append(
        f"  virtual_s={sim.get('virtual_s')}  "
        f"real_wall_s={sim.get('real_wall_s')}  "
        f"speedup={f'{spd}x' if spd is not None else 'n/a'}  "
        f"events={sim.get('events_fired')}"
    )
    if sim.get("hosts_per_wall_s") is not None:
        lines.append(
            f"  simulated hosts/wall-second: {sim['hosts_per_wall_s']}"
        )
    xp = fl.get("cross_pod")
    if xp and (xp.get("hits") or xp.get("bytes")):
        lines.append(
            f"  cross-pod: hits={xp['hits']}  bytes={xp['bytes']}"
        )
    prof = fl.get("profile")
    if prof:
        lines.append("  service profile (ms):")
        for name, d in prof.items():
            lines.append(
                f"    {name:<10} {d.get('source'):<9} "
                f"p50={d.get('p50_ms')}  p99={d.get('p99_ms')}  "
                f"n={d.get('count')}"
            )
    return "\n".join(lines)
