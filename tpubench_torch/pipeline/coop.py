"""Pod-scale cooperative chunk cache: peer sharing with pod-wide
single-flight (``tpubench/pipeline/coop.py``).

The chunk cache is strictly per-host: an N-host pod downloads every
hot object from GCS N times, paying N× egress and N× first-byte latency
for bytes a peer already holds in its slab pool. This module makes "the
pod is the unit under test" true for the cache layer:

* **Consistent-hash ownership** (:class:`HashRing`): every chunk key
  ``(bucket, object, generation, range)`` has exactly ONE owner host,
  computed from a stable hash ring (virtual nodes, so a host join/leave
  remaps only ~1/N of the keys). Ownership is a pure function of the
  membership set — every host computes the same owner without
  coordination.
* **Peer-first miss path** (:class:`CoopCache`): a local
  :class:`~tpubench_torch.pipeline.cache.ChunkCache` miss whose owner is a
  peer requests the chunk over the peer channel instead of fetching
  from origin; only a peer miss (or an unreachable/demoted owner) falls
  back to an origin fetch. Received bytes land in a leased slab — one
  host-RAM write, so the local path's ``copies_per_byte <= 1.0``
  guarantee survives.
* **Pod-wide single-flight**: the owner serves peer requests through
  its OWN cache's single-flight path, so N hosts missing the same chunk
  concurrently produce exactly one origin fetch — the followers (local
  threads and remote peers alike) register as waiters on the owner's
  in-flight fetch and share its bytes. The ``pod_coalesced`` counter
  records how many origin reads the pod-wide dedup saved.
* **Straggler demotion**: fed the flight recorder's per-host straggler
  table (:func:`tpubench_torch.obs.flight.straggler_attribution`), an owner
  in the slowest decile is demoted — its virtual nodes leave the ring
  (keys rebalance consistent-hash-minimally to the remaining hosts) and
  its serve side answers pass-through misses — so one slow host cannot
  set the pod's chunk-fetch p99. Demoted hosts are restored when a
  later table clears them.

Two interchangeable peer channels sit behind one interface:

* :class:`LoopbackChannel` over a :class:`LoopbackBroker` — in-process
  request/reply for hermetic multi-"host" tests, single-host dev, and
  the simulated pod (threaded hosts, no device, no network).
* :class:`tpubench_torch.dist.peer.IciPeerChannel` — the chunk bytes ride
  the pod's all-gather (``dist.reassemble.make_reassemble``: NCCL on
  CUDA, gloo on the CPU) for real pods (lockstep scope documented
  there); the name is the reference's.

Peer reads compose under the same machinery as any backend:
:class:`PeerBackend` is a :class:`~tpubench_torch.storage.base.StorageBackend`
whose ``open_read`` resolves the chunk's owner and streams the peer
payload through an :class:`~tpubench_torch.storage.base.ObjectReader`, so
``RetryingBackend`` (and the tail stack) wrap it exactly like the GCS
clients — a transient channel error retries, a definitive peer miss
(``PeerMissError``, non-transient) falls through to origin immediately.

Received bytes land in page-locked slabs on CUDA (the slab pool of
:mod:`tpubench_torch.mem`), so a peer-served chunk is staged to the card
from its slab in place, as an origin-fetched one is.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional, Protocol, Sequence

import numpy as np

from tpubench_torch.device import DeviceLike, resolve_device
from tpubench_torch.dist.launch import member
from tpubench_torch.mem.slab import (
    CopyMeter,
    SlabPool,
    payload_view,
    release_payload,
)
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.obs import flight as _flight
from tpubench_torch.obs.tracing import (
    TraceContext,
    adopt_trace,
    current_trace,
    derive_span_id,
    trace_scope,
)
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.storage.base import ObjectMeta, StorageError

MB = 1024 * 1024

# Peer-tier retry bound (wrap_peer_backend): re-asking an owner is only
# worth a few attempts — the origin fallback is always available.
PEER_MAX_ATTEMPTS = 3

# Peer-tier backoff ceilings (wrap_peer_backend): the origin gax
# schedule (1 s initial, ×2, 30 s cap) is sized for a cloud service's
# recovery, not a peer one collective/loopback hop away — a transient peer
# error re-asked on that schedule would stall a demand miss for seconds
# when the origin fallback is immediately available behind it.
PEER_BACKOFF_INITIAL_S = 0.05
PEER_BACKOFF_MAX_S = 0.25

# Requester-side peer transfer sample window (stats percentiles + the
# local demotion signal). Bounded: a serve-shaped run with millions of
# peer hits must not grow host RSS (the telemetry registry's
# EXACT_SAMPLE_CAP discipline); a recent window is also the honest
# signal for demotion — an owner that WAS slow an hour ago isn't.
TRANSFER_SAMPLE_CAP = 8192


# --------------------------------------------------------------- hashing ----


def _h64(s: str) -> int:
    """Stable 64-bit hash (blake2b, not ``hash()``: PYTHONHASHSEED must
    never change chunk ownership between hosts or runs)."""
    return int.from_bytes(
        hashlib.blake2b(s.encode(), digest_size=8).digest(), "big"
    )


def chunk_point(key: ChunkKey) -> int:
    """The ring position of one chunk key — the full identity hashes
    (bucket, object, generation, range), so an overwritten object's new
    generation may land on a different owner while the stale
    generation's entries age out where they were."""
    return _h64(
        f"{key.bucket}\x00{key.object}\x00{key.generation}"
        f"\x00{key.start}\x00{key.length}"
    )


class HashRing:
    """Consistent-hash ring over host ids with virtual nodes.

    Deterministic by construction: two rings built from the same
    membership (in any order) place every key identically — ownership
    needs no coordination. Adding or removing one host remaps ~1/N of
    the key space (the stability property the tests pin). Demotion
    removes a host's points from the LOOKUP without forgetting the
    host, so a restored straggler gets its exact original points back
    (rehash-minimal in both directions)."""

    def __init__(self, hosts: Iterable[int] = (), vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self._hosts: set[int] = set()
        self._demoted: set[int] = set()
        self._points: list[int] = []
        self._owners: list[int] = []
        self._lock = threading.Lock()
        for h in hosts:
            self._hosts.add(int(h))
        self._rebuild_locked()

    # ------------------------------------------------------------ internal --
    def _rebuild_locked(self) -> None:
        pts: list[tuple[int, int]] = []
        for h in sorted(self._hosts - self._demoted):
            for v in range(self.vnodes):
                pts.append((_h64(f"host:{h}\x00vnode:{v}"), h))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [o for _, o in pts]

    # ------------------------------------------------------------- surface --
    def add_host(self, host: int) -> None:
        with self._lock:
            self._hosts.add(int(host))
            self._rebuild_locked()

    def remove_host(self, host: int) -> None:
        with self._lock:
            self._hosts.discard(int(host))
            self._demoted.discard(int(host))
            self._rebuild_locked()

    def demote(self, host: int) -> bool:
        """Take ``host``'s points out of the lookup (straggler
        rebalancing). Returns True when this call changed state."""
        with self._lock:
            if host not in self._hosts or host in self._demoted:
                return False
            self._demoted.add(int(host))
            self._rebuild_locked()
            return True

    def restore(self, host: int) -> bool:
        with self._lock:
            if host not in self._demoted:
                return False
            self._demoted.discard(int(host))
            self._rebuild_locked()
            return True

    @property
    def hosts(self) -> set[int]:
        with self._lock:
            return set(self._hosts)

    @property
    def demoted(self) -> set[int]:
        with self._lock:
            return set(self._demoted)

    @property
    def active_hosts(self) -> set[int]:
        with self._lock:
            return self._hosts - self._demoted

    def owner(self, key: ChunkKey) -> Optional[int]:
        """The key's owner among the ACTIVE (non-demoted) hosts, or None
        when the ring is empty — the caller fetches origin."""
        with self._lock:
            if not self._points:
                return None
            i = bisect.bisect_right(self._points, chunk_point(key))
            return self._owners[i % len(self._owners)]


# --------------------------------------------------------------- channels ---


class PeerMissError(StorageError):
    """The owner definitively does not serve this chunk (budget shed,
    demoted, serve-side failure). Non-transient on purpose: retrying the
    peer would just re-shed — the correct recovery is the ORIGIN fetch,
    which the coop miss path falls through to immediately."""

    def __init__(self, msg: str):
        super().__init__(msg, transient=False, code=404)


class PeerChannel(Protocol):
    """One host's handle on the pod's peer transport. ``request`` routes
    to the owner and returns the chunk bytes, raising ``StorageError``
    (transient ⇒ the retry stack may re-ask; ``PeerMissError`` ⇒ fall
    back to origin now). ``lockstep`` channels (``ici``) instead require
    every host to enter ``broadcast`` together — see dist/peer.py."""

    host_id: int
    lockstep: bool

    def request(self, owner: int, key: ChunkKey) -> bytes: ...

    def close(self) -> None: ...


class LoopbackBroker:
    """In-process pod: host id → serve callable. The hermetic stand-in
    for the network — multi-"host" tests register N CoopCaches here and
    exercise the identical routing/dedup/demotion logic real pods run.
    ``delay_s`` injects per-host serve latency (straggler shaping for
    the demotion tests/bench). ``accept`` is the host's warm-handoff
    landing callable (:meth:`CoopCache.accept_handoff`) — a departing
    owner :meth:`push`\\ es its hot set there. A **paused** host (the
    elastic fabric's stalled-but-not-dead state) raises *transient*
    errors instead of serving: the requester's bounded peer-tier retry
    re-asks, then falls through to origin."""

    def __init__(self):
        self._serves: dict[int, Callable[[ChunkKey], Optional[bytes]]] = {}
        self._accepts: dict[int, Callable[[ChunkKey, bytes], bool]] = {}
        self._delay: dict[int, float] = {}
        self._paused: set[int] = set()
        self._lock = threading.Lock()

    def register(self, host_id: int,
                 serve: Callable[[ChunkKey], Optional[bytes]],
                 delay_s: float = 0.0,
                 accept: Optional[Callable[[ChunkKey, bytes], bool]] = None,
                 ) -> None:
        with self._lock:
            self._serves[int(host_id)] = serve
            if delay_s:
                self._delay[int(host_id)] = delay_s
            if accept is not None:
                self._accepts[int(host_id)] = accept

    def unregister(self, host_id: int) -> None:
        with self._lock:
            self._serves.pop(int(host_id), None)
            self._accepts.pop(int(host_id), None)
            self._delay.pop(int(host_id), None)

    def pause(self, host_id: int) -> None:
        """Make ``host_id`` unresponsive without removing it: requests
        raise transient 503s (the retry stack's domain), pushes bounce."""
        with self._lock:
            self._paused.add(int(host_id))

    def resume(self, host_id: int) -> None:
        with self._lock:
            self._paused.discard(int(host_id))

    def request(self, src: int, owner: int, key: ChunkKey) -> bytes:
        with self._lock:
            serve = self._serves.get(int(owner))
            delay = self._delay.get(int(owner), 0.0)
            paused = int(owner) in self._paused
        if serve is None:
            # Definitive, not transient: a host this broker has never
            # seen will not appear by retrying (loopback brokers span
            # one process). The follower's remedy is its origin fetch.
            raise PeerMissError(f"peer host {owner} not registered")
        if paused:
            # Transient on purpose: a paused host may come back, so the
            # peer-tier retry gets its (bounded, fast-backoff) say —
            # after which the requester falls through to origin.
            raise StorageError(
                f"peer host {owner} is paused", transient=True, code=503,
            )
        if delay:
            time.sleep(delay)
        data = serve(key)
        if data is None:
            raise PeerMissError(f"host {owner} shed {key.object} chunk")
        return data

    def push(self, src: int, dst: int, key: ChunkKey, data: bytes,
             owner: Optional[str] = None) -> bool:
        """Warm-handoff delivery: ``src``'s departing owner hands one
        hot chunk to ``dst`` (its new owner), QoS owner tag riding
        along. Returns False when the destination cannot take it
        (unregistered, paused, or its accept refused) — the pusher
        counts the reject and moves on; the pod re-fetches that chunk
        from origin like the killed-host arm."""
        with self._lock:
            accept = self._accepts.get(int(dst))
            paused = int(dst) in self._paused
        if accept is None or paused:
            return False
        return bool(accept(key, data, owner))


class LoopbackChannel:
    """The broker-backed :class:`PeerChannel` (request/reply, runs the
    owner's serve on the requester's thread)."""

    lockstep = False

    def __init__(self, broker: LoopbackBroker, host_id: int):
        self._broker = broker
        self.host_id = int(host_id)

    def request(self, owner: int, key: ChunkKey) -> bytes:
        return self._broker.request(self.host_id, owner, key)

    def close(self) -> None:
        self._broker.unregister(self.host_id)


# ---------------------------------------------------------- peer backend ----

_SEP = "\x00"


def encode_chunk_name(key: ChunkKey) -> str:
    """The chunk's peer-read object name: ``open_read(name, start,
    length)`` carries the range natively; bucket + generation ride the
    name (NUL-separated — never legal in a GCS object name)."""
    return f"{key.bucket}{_SEP}{key.object}{_SEP}{key.generation}"


def decode_chunk_name(name: str, start: int, length: int) -> ChunkKey:
    bucket, obj, gen = name.split(_SEP)
    return ChunkKey(bucket, obj, int(gen), int(start), int(length))


class PeerReader:
    """ObjectReader over a received peer payload (cursor + readinto), so
    the peer path measures on the same reader shape as every transport:
    ``first_byte_ns`` is the request round-trip, ``generation`` is the
    key's (the owner's cache is generation-keyed — a served chunk IS
    that generation's bytes)."""

    def __init__(self, data: bytes, first_byte_ns: int, generation: int):
        self._data = memoryview(data)
        self._pos = 0
        self.first_byte_ns = first_byte_ns
        self.generation = generation

    def readinto(self, buf: memoryview) -> int:
        n = min(len(buf), len(self._data) - self._pos)
        if n <= 0:
            return 0
        buf[:n] = self._data[self._pos : self._pos + n]
        self._pos += n
        return n

    def close(self) -> None:
        self._data = memoryview(b"")
        self._pos = 0


class PeerBackend:
    """StorageBackend adapter over a peer channel: peer reads ride the
    ordinary ``open_read`` protocol so ``RetryingBackend`` (and the tail
    stack) compose over them exactly as over the GCS clients. A ring
    lookup that lands on SELF or an empty ring raises ``PeerMissError``
    — this backend only ever serves *remote* chunks."""

    def __init__(self, channel, ring: HashRing):
        self._channel = channel
        self._ring = ring
        self._tls = threading.local()

    def last_serving_owner(self) -> Optional[int]:
        """The owner that served THIS thread's most recent successful
        ``open_read``. The ring is re-resolved per attempt (a demotion
        between retries must redirect the re-ask), so the host a
        transfer sample should be attributed to is the one the LAST
        attempt landed on, not the one the caller resolved up front."""
        return getattr(self._tls, "owner", None)

    def open_read(self, name: str, start: int = 0,
                  length: Optional[int] = None):
        if length is None:
            raise ValueError("peer reads are ranged: length is required")
        key = decode_chunk_name(name, start, length)
        owner = self._ring.owner(key)
        if owner is None or owner == self._channel.host_id:
            raise PeerMissError(f"no remote owner for {key.object} chunk")
        data = self._channel.request(owner, key)
        if len(data) != key.length:
            raise StorageError(
                f"peer {owner} served {len(data)}/{key.length} B for "
                f"{key.object}", transient=True, code=502,
            )
        self._tls.owner = owner
        return PeerReader(data, time.perf_counter_ns(), key.generation)

    # StorageBackend protocol completeness (the peer tier is read-only).
    def write(self, name: str, data: bytes,
              if_generation_match=None) -> ObjectMeta:
        raise StorageError("peer backend is read-only", transient=False)

    def open_write(self, name: str, if_generation_match=None):
        raise StorageError("peer backend is read-only", transient=False)

    def list(self, prefix: str = "", page_size: int = 0) -> list:
        return []

    def stat(self, name: str) -> ObjectMeta:
        raise StorageError("peer backend has no metadata surface",
                           transient=False, code=404)

    def delete(self, name: str) -> None:
        raise StorageError("peer backend is read-only", transient=False)

    def close(self) -> None:
        pass


def wrap_peer_backend(channel, ring: HashRing, retry_cfg=None, *, inner=None):
    """The composition ``open_backend`` applies to every transport,
    applied to the peer tier: ``Retrying(PeerBackend)`` when a retry
    policy is given (transient channel errors re-ask the owner;
    ``PeerMissError`` is non-transient and surfaces immediately).

    The peer tier always retries under "idempotent" semantics, whatever
    the origin policy: "always" (the gax default) retries ANY
    StorageError, which would re-ask a shedding owner ``max_attempts``
    times for a definitive miss whose correct remedy — the origin
    fetch — is sitting right behind the fallback path. Attempts are
    also BOUNDED (the origin policy's 0 = retry-forever would park a
    read behind an unreachable peer when the same bytes are one origin
    fetch away), and the backoff schedule is SHRUNK to peer scale
    (``PEER_BACKOFF_*`` — the gax 1 s-initial origin schedule would add
    seconds of sleep before a fallback that is one step away)."""
    if inner is None:
        inner = PeerBackend(channel, ring)
    if retry_cfg is None or retry_cfg.policy == "never":
        return inner
    import dataclasses

    from tpubench_torch.storage.retrying import RetryingBackend

    attempts = retry_cfg.max_attempts
    if attempts <= 0 or attempts > PEER_MAX_ATTEMPTS:
        attempts = PEER_MAX_ATTEMPTS
    initial = min(retry_cfg.initial_backoff_s, PEER_BACKOFF_INITIAL_S)
    cap = min(retry_cfg.max_backoff_s, PEER_BACKOFF_MAX_S)
    if (retry_cfg.policy != "idempotent"
            or attempts != retry_cfg.max_attempts
            or initial != retry_cfg.initial_backoff_s
            or cap != retry_cfg.max_backoff_s):
        retry_cfg = dataclasses.replace(
            retry_cfg, policy="idempotent", max_attempts=attempts,
            initial_backoff_s=initial, max_backoff_s=cap,
        )
    return RetryingBackend(inner, retry_cfg)


# -------------------------------------------------------------- CoopCache ---


class CoopCache:
    """The pod-coherent tier over one host's :class:`ChunkCache` (module
    docstring). Construct one per host; register :meth:`serve` with the
    pod's peer transport; hand :meth:`fetch` to the cache's miss path
    (demand reads and the prefetcher alike) as the routed fetch.

    ``peer_budget_bytes`` bounds the bytes this host is concurrently
    serving to peers: past it, serve sheds with a miss (the follower
    falls back to origin) instead of queueing unboundedly behind a hot
    owner — the valve the ``peer_budget_bytes`` tune knob actuates
    live. ``set_enabled(False)`` (the ``coop`` knob) short-circuits
    routing to plain origin fetches without restarting anything."""

    def __init__(
        self,
        cache: ChunkCache,
        *,
        host_id: int,
        ring: HashRing,
        channel=None,
        origin_fetch: Callable[[ChunkKey], object],
        pool: Optional[SlabPool] = None,
        meter: Optional[CopyMeter] = None,
        enabled: bool = True,
        peer_budget_bytes: int = 0,
        demote_share: float = 0.5,
        demote_interval_s: float = 2.0,
        retry_cfg=None,
        flight_ring=None,
        flight_recorder=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cache = cache
        self.host_id = int(host_id)
        self.ring = ring
        self._channel = channel
        self._origin_fetch = origin_fetch
        self._pool = pool
        self._meter = meter
        self._enabled = bool(enabled)
        self._budget = max(0, int(peer_budget_bytes))
        self._demote_share = demote_share
        self._demote_interval_s = demote_interval_s
        self._clock = clock
        self._flight_ring = flight_ring
        # THIS host's recorder: serve-side origin fetches record on it
        # (kind="serve" on a pooled single-appender ring — see
        # _acquire_serve_ring), so the owner half of a cross-host hop
        # lands in the OWNER's journal carrying the REQUESTER's
        # propagated trace context.
        self._flight_recorder = flight_recorder
        self._serve_ring_free: list[str] = []
        self._serve_ring_seq = 0
        self._peer_inner = (
            PeerBackend(channel, ring)
            if channel is not None and not getattr(channel, "lockstep", False)
            else None
        )
        self._peer_backend = (
            wrap_peer_backend(channel, ring, retry_cfg, inner=self._peer_inner)
            if self._peer_inner is not None
            else None
        )
        self._lock = threading.Lock()
        self._closed = False
        self._serving_bytes = 0
        self._last_demote_check = clock()
        # Counters (the extra["pipeline"]["coop"] stamp).
        self.peer_requests = 0
        self.peer_hits = 0
        self.peer_misses = 0
        self.peer_bytes = 0
        self.peer_serves = 0
        self.peer_served_bytes = 0
        self.serve_errors = 0
        self.budget_rejects = 0
        self.pod_coalesced = 0  # peer requests that joined an in-flight fetch
        self.origin_fetches = 0
        self.origin_bytes = 0
        self.owner_fetches = 0  # origin fetches made AS the ring owner
        # Origin bytes fetched ONLY to answer a peer request (a serve
        # miss in the owner's cache). A per-host baseline would not have
        # made these fetches — the requester's own origin fetch for the
        # same bytes is already counted in its peer_bytes — so they are
        # excluded from per_host_origin_estimate_bytes.
        self.serve_origin_bytes = 0
        self.demotions = 0
        self.restores = 0
        # Warm-handoff accounting (elastic membership): chunks this host
        # DRAINED to new owners at cooperative departure (out) and
        # chunks it RECEIVED from a departing owner (in). The
        # cooperative-vs-killed resize A/B is exactly out+in vs the
        # origin re-fetch bytes the killed arm pays instead.
        self.handoff_out_chunks = 0
        self.handoff_out_bytes = 0
        self.handoff_in_chunks = 0
        self.handoff_in_bytes = 0
        self.handoff_rejects = 0  # pushes the destination refused
        # Recent (owner, round-trip ns) peer transfer samples — the
        # stats percentiles AND the local demotion signal's source.
        self._transfer_ns: deque = deque(maxlen=TRANSFER_SAMPLE_CAP)

    # ------------------------------------------------------------ routing --
    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def lockstep(self) -> bool:
        """True when the peer channel is a collective (``ici``): every host
        must enter each broadcast together, so only plan-synchronized
        consumers may route through :meth:`fetch` — the workload guards
        enforce this (asynchronous prefetch workers and desynchronized
        demand misses would hang the pod's group)."""
        return bool(getattr(self._channel, "lockstep", False))

    def set_enabled(self, on) -> None:
        """Live coop on/off (the ``coop`` tune knob): off = every miss
        is a plain origin fetch; serve sheds so peers fall back too."""
        self._enabled = bool(on)

    def set_peer_budget(self, nbytes: int) -> None:
        """Live serve-side byte budget (the ``peer_budget_bytes`` tune
        knob); 0 = unbounded."""
        self._budget = max(0, int(nbytes))

    @property
    def peer_budget_bytes(self) -> int:
        return self._budget

    def _owner(self, key: ChunkKey) -> Optional[int]:
        if not self._enabled or self._channel is None:
            return None
        if len(self.ring.active_hosts) < 2:
            return None  # a pod of one has no peers to share with
        return self.ring.owner(key)

    def _count_origin(self, payload, owner: bool, serving: bool) -> None:
        with self._lock:
            self.origin_fetches += 1
            self.origin_bytes += len(payload)
            if owner:
                self.owner_fetches += 1
            if serving:
                self.serve_origin_bytes += len(payload)

    def _origin(self, key: ChunkKey, owner: bool = False,
                serving: bool = False):
        if owner:
            _flight.note_phase("owner_fetch")
        payload = self._origin_fetch(key)
        self._count_origin(payload, owner, serving)
        return payload

    def fetch(self, key: ChunkKey):
        """The routed miss fetch — what the local cache's single-flight
        runs on a miss. Owner (or no-peer) keys fetch origin; follower
        keys ask the owner first and fall back to origin on a peer
        miss/failure. Returns a caller-owned payload (``SlabLease`` or
        ``bytes``), exactly like ``fetch_chunk``."""
        owner = self._owner(key)
        if owner is None:
            return self._origin(key)
        if getattr(self._channel, "lockstep", False):
            return self._fetch_lockstep(key, owner)
        if owner == self.host_id:
            return self._origin(key, owner=True)
        _flight.note_phase("peer_request")
        with self._lock:
            self.peer_requests += 1
        t0 = time.perf_counter_ns()
        try:
            # Trace propagation: the hop travels as a child of THIS
            # read's synthesized peer_request segment — the derived id
            # is recomputable from the requester's record at merge time,
            # so the owner host's serve span stitches under it with no
            # extra wire data (loopback/request-reply channels carry the
            # context thread-locally; a networked channel would marshal
            # the same two ids).
            with trace_scope(self._peer_hop_ctx()):
                payload = self._receive(key)
        except StorageError:
            _flight.note_phase("peer_miss")
            with self._lock:
                self.peer_misses += 1
            return self._origin(key)
        _flight.note_phase("peer_hit")
        served_by = self._peer_inner.last_serving_owner()
        with self._lock:
            self.peer_hits += 1
            self.peer_bytes += len(payload)
            self._transfer_ns.append(
                (owner if served_by is None else served_by,
                 time.perf_counter_ns() - t0)
            )
        return payload

    def _peer_hop_ctx(self) -> Optional[TraceContext]:
        """The context a peer hop travels under: the current read op's
        trace with the DERIVED peer_request segment id as parent (so the
        owner's spans nest under the hop, not the whole read), carrying
        the read's per-trace sampling decision across the hop. Falls
        back to the thread's ambient trace context; None when the read
        is untraced."""
        op = _flight.current_op()
        if op is not None:
            base = op.trace_context()
            return TraceContext(
                base.trace_id,
                derive_span_id(base.span_id, "peer_request"),
                base.sampled,
            )
        return current_trace()

    def _receive(self, key: ChunkKey):
        """Stream the peer payload through the composed peer backend
        into its landing buffer — a leased slab when the pool is on (one
        host-RAM write: the local path stays <= 1.0 copies/byte), bytes
        otherwise. Raises StorageError on miss/short reads (after the
        retry stack had its say)."""
        name = encode_chunk_name(key)
        if self._pool is not None:
            lease = self._pool.lease(key.length)
            if lease.overflow:
                _flight.annotate("slab", event="overflow")
            try:
                self._readinto(name, key, lease.view())
            except BaseException:
                lease.release()
                raise
            if self._meter is not None:
                self._meter.landed(key.length)
            return lease
        buf = bytearray(key.length)
        self._readinto(name, key, memoryview(buf))
        if self._meter is not None:
            self._meter.landed(key.length)
        return bytes(buf)

    def _readinto(self, name: str, key: ChunkKey, mv: memoryview) -> None:
        reader = self._peer_backend.open_read(
            name, start=key.start, length=key.length
        )
        got = 0
        try:
            while got < key.length:
                n = reader.readinto(mv[got:])
                if n <= 0:
                    break
                got += n
        finally:
            reader.close()
        if got != key.length:
            raise StorageError(
                f"{key.object}: short peer read {got}/{key.length}",
                transient=True, code=502,
            )

    def _fetch_lockstep(self, key: ChunkKey, owner: int):
        """Lockstep (collective) transfer: EVERY host enters the broadcast
        for this key together — the owner contributes the chunk (fetched
        from origin under its local single-flight position), followers
        contribute nothing and receive it off the pod's all-gather.
        Scope: plan-synchronized pod workloads (see dist/peer.py). The
        owner hands the channel a view of its payload, not a copy: the
        channel's host-to-device copy is complete when ``broadcast``
        returns, so the payload (a slab lease the cache holds too) is not
        read after this call."""
        if owner == self.host_id:
            payload = self._origin(key, owner=True)
            self._channel.broadcast(owner, payload_view(payload), key)
            # A collective cannot parent one remote span under another
            # (every host enters together; the owner fetched under its
            # OWN plan-walk span) — instead the followers' contexts ride
            # the gather's spare slots and land here as TRACE LINKS, the
            # OTel link shape for causal-but-not-parental edges.
            links = getattr(self._channel, "last_request_links", lambda: [])()
            if links:
                _flight.annotate(
                    "trace_link",
                    peers=[
                        {"trace_id": c.trace_id, "span_id": c.span_id}
                        for c in links
                    ],
                )
            return payload
        _flight.note_phase("peer_request")
        with self._lock:
            self.peer_requests += 1
        t0 = time.perf_counter_ns()
        data = self._channel.broadcast(
            owner, None, key, ctx=self._peer_hop_ctx()
        )
        _flight.note_phase("peer_hit")
        with self._lock:
            self.peer_hits += 1
            self.peer_bytes += len(data)
            self._transfer_ns.append((owner, time.perf_counter_ns() - t0))
        return self._land(data, key)

    def _land(self, data: bytes, key: ChunkKey):
        if self._pool is not None:
            lease = self._pool.lease(key.length)
            if lease.overflow:
                _flight.annotate("slab", event="overflow")
            lease.view()[:] = data
            if self._meter is not None:
                self._meter.landed(key.length)
            return lease
        if self._meter is not None:
            self._meter.landed(key.length)
        return data

    # -------------------------------------------------------------- serve --
    def serve(self, key: ChunkKey) -> Optional[bytes]:
        """The owner side of a peer request (invoked by the transport,
        on whatever thread it uses). Serves through this host's OWN
        cache single-flight path — which is what extends single-flight
        pod-wide: concurrent peers (and local threads) asking for one
        chunk coalesce onto one origin fetch. Returns None to shed
        (budget exceeded, demoted, disabled, or the fetch failed) — the
        follower's remedy is its own origin fetch."""
        if self._closed or not self._enabled:
            return None
        if self.host_id in self.ring.demoted:
            return None  # demoted owners pass peers through to origin
        n = key.length
        with self._lock:
            if self._budget and self._serving_bytes + n > self._budget:
                self.budget_rejects += 1
                return None
            self._serving_bytes += n
        # The serve's backend work must not stamp phases on the
        # REQUESTER's flight op (loopback runs serve on the requester's
        # thread; connect/first_byte stamps here would break the peer
        # record's phase monotonicity) — but the requester's PROPAGATED
        # trace context is kept: the serve's own record (kind="serve",
        # on THIS host's recorder) parents under the remote peer_request
        # segment, which is the cross-host stitch `report trace` merges.
        peer_ctx = current_trace()
        caller_op = _flight.current_op()
        _flight.adopt_op(None)
        adopt_trace(peer_ctx)
        sop = None
        ring_name = None
        if self._flight_recorder is not None:
            # The transport invokes serve on arbitrary threads and a
            # ring has exactly one appending owner — but keying rings
            # by thread ident would grow one 1024-slot ring per ident
            # forever on a per-connection-thread transport. A free-list
            # bounds the pool at PEAK serve concurrency: a name is held
            # exclusively for the duration of this serve (single
            # appender by construction) and recycled after.
            ring_name = self._acquire_serve_ring()
            sop = self._flight_recorder.worker(ring_name).begin(
                key.object, "peer", kind="serve"
            )
        try:
            payload, source = self.cache.get_or_fetch_info(
                key, lambda: self._origin(key, owner=True, serving=True),
            )
            try:
                data = bytes(payload_view(payload))
            finally:
                release_payload(payload)
            if sop is not None:
                if source == "hit":
                    sop.mark("cache_hit")
                # First-stamp-wins: when the origin path already stamped
                # body_complete (the composed backend stack does), this
                # is a no-op — it guarantees the serve SPAN covers the
                # fetch even over an origin_fetch that stamps nothing,
                # so the owner side of a slow hop has a duration the
                # critical-path walk can descend into.
                sop.mark("body_complete")
                sop.finish(len(data))
            with self._lock:
                self.peer_serves += 1
                self.peer_served_bytes += len(data)
                if source == "coalesced":
                    self.pod_coalesced += 1
            return data
        except Exception as e:  # noqa: BLE001 — shed, requester recovers
            # Exception, not BaseException: loopback runs serve on the
            # REQUESTER's thread — a KeyboardInterrupt here must stop
            # the run, not be counted as a shed.
            if sop is not None:
                sop.finish(error=e)
            with self._lock:
                self.serve_errors += 1
            return None
        finally:
            if sop is not None:
                sop.abandon()  # no-op when finished; never leak the op
            if ring_name is not None:
                self._release_serve_ring(ring_name)
            _flight.adopt_op(caller_op)
            # adopt_op set the trace position to the caller op's context
            # (or cleared it when there is no op) — restore the ACTUAL
            # entry state: on a loopback serve the requester thread was
            # inside its hop scope, and anything it begins after this
            # return (payload streaming in _receive) must parent under
            # the hop segment, not the whole read or a fresh root.
            adopt_trace(peer_ctx)
            with self._lock:
                self._serving_bytes -= n

    # ------------------------------------------------------ warm handoff --
    def accept_handoff(self, key: ChunkKey, data: bytes,
                       owner: Optional[str] = None) -> bool:
        """Land one hot chunk a departing owner drained to this host
        (invoked by the fabric's push, on the departing host's thread).
        The payload takes the ordinary landing path — a leased slab when
        the pool is on — and inserts as a demand entry under the SAME
        QoS owner tag it carried on the departing host (per-class cache
        budgets must survive the hop, or every cooperative departure
        would dilute the weighted-eviction guarantee with untagged
        bytes). The next miss for the key is a local hit instead of an
        origin fetch. Returns False when this host cannot take it
        (closed/disabled, or the bytes don't match the key)."""
        if self._closed or not self._enabled:
            return False
        if len(data) != key.length:
            return False
        payload = self._land(data, key)
        try:
            self.cache.insert(key, payload, owner=owner)
        finally:
            release_payload(payload)  # the cache holds its own reference
        with self._lock:
            self.handoff_in_chunks += 1
            self.handoff_in_bytes += key.length
        return True

    def drain_hot_set(self, push: Callable[..., bool],
                      owner_for: Callable[[ChunkKey], Optional[int]],
                      max_bytes: int = 0) -> dict:
        """Cooperative departure: hand this host's resident hot set to
        each chunk's NEW owner (``owner_for`` resolves against the
        post-departure ring) over ``push(owner_host, key, data,
        owner_tag)``. MRU-first, so a byte budget (``max_bytes``; 0 =
        everything) drains the hottest chunks first. Chunks whose new
        owner is this host or nobody are skipped; refused pushes are
        counted and abandoned (the pod re-fetches those from origin —
        strictly no worse than a kill)."""
        chunks = nbytes = rejected = skipped = 0
        for key, tag in self.cache.export_manifest(max_bytes=max_bytes):
            owner = owner_for(key)
            if owner is None or owner == self.host_id:
                skipped += 1
                continue
            # One entry at a time (manifest first, bytes per push): a
            # whole-cache drain must not transiently double the host's
            # cache footprint at the exact moment the pod is resizing.
            data = self.cache.peek_bytes(key)
            if data is None:
                skipped += 1  # evicted since the manifest snapshot
                continue
            if push(owner, key, data, tag):
                chunks += 1
                nbytes += len(data)
            else:
                rejected += 1
        with self._lock:
            self.handoff_out_chunks += chunks
            self.handoff_out_bytes += nbytes
            self.handoff_rejects += rejected
        return {
            "chunks": chunks, "bytes": nbytes,
            "rejected": rejected, "skipped": skipped,
        }

    def purge_host_samples(self, host: int) -> None:
        """Forget peer-transfer samples attributed to ``host`` (called
        on every membership epoch that removes it): straggler evidence
        about a departed owner must not survive the view change — a
        rejoining host starts from a clean slate, and the demotion scan
        must never act on rounds served by a host that is gone."""
        with self._lock:
            kept = [s for s in self._transfer_ns if s[0] != int(host)]
            self._transfer_ns.clear()
            self._transfer_ns.extend(kept)

    def reset_member_state(self) -> None:
        """Clean-rejoin reset for THIS host: drop every peer-transfer
        sample (they were measured under a dead epoch's view). Ring
        demotion state needs no reset here — ``HashRing.remove_host``
        already forgot it when the host left."""
        with self._lock:
            self._transfer_ns.clear()

    def _acquire_serve_ring(self) -> str:
        """Exclusive serve-ring name: pool bounded by peak concurrency,
        each name held by exactly one in-flight serve (the ring's one
        appender), recycled on release."""
        with self._lock:
            if self._serve_ring_free:
                return self._serve_ring_free.pop()
            self._serve_ring_seq += 1
            return f"serve-{self._serve_ring_seq}"

    def _release_serve_ring(self, name: str) -> None:
        with self._lock:
            self._serve_ring_free.append(name)

    # ----------------------------------------------------------- demotion --
    def _slow_hosts_from_rows(self, rows: Sequence[dict]) -> set[int]:
        """Hosts owning at least ``demote_share`` of a table's slowest
        decile. A single-row table demotes nobody: with no second host
        to compare against, 100% tail ownership is vacuous (and on a
        real pod the LOCAL recorder only ever sees its own host id)."""
        slow: set[int] = set()
        if len(rows) >= 2:
            for row in rows:
                if row.get("tail_share", 0.0) >= self._demote_share:
                    try:
                        slow.add(int(row["host"]))
                    except (KeyError, TypeError, ValueError):
                        continue
        return slow

    def _apply_slow_set(self, slow: set[int]) -> dict:
        demoted, restored = [], []
        for h in self.ring.hosts:
            if h in slow:
                if self.ring.demote(h):
                    demoted.append(h)
            elif self.ring.restore(h):
                restored.append(h)
        with self._lock:
            self.demotions += len(demoted)
            self.restores += len(restored)
            if demoted:
                # Demotion CONSUMES its transfer-sample evidence: a
                # demoted owner receives no new peer requests, so its
                # stale slow samples would otherwise keep its
                # tail_share at the cut forever (restore could only
                # happen after TRANSFER_SAMPLE_CAP newer appends).
                # Purging gives the host a clean local slate — it is
                # restored at the next refresh unless another signal
                # still flags it, and fresh round-trips re-demote it if
                # it is still slow (probation re-probe, not exile).
                gone = set(demoted)
                kept = [s for s in self._transfer_ns if s[0] not in gone]
                self._transfer_ns.clear()
                self._transfer_ns.extend(kept)
        for h in demoted:
            self._note_demotion("demote", h)
        for h in restored:
            self._note_demotion("restore", h)
        return {"demoted": demoted, "restored": restored}

    def apply_straggler_table(self, rows: Sequence[dict]) -> dict:
        """Apply one per-host straggler table (the
        ``straggler_attribution(records, by="host")`` row shape): a host
        owning at least ``demote_share`` of the slowest-decile reads is
        demoted out of the ring; every other known host is restored.
        Returns {"demoted": [...], "restored": [...]}."""
        return self._apply_slow_set(self._slow_hosts_from_rows(rows))

    def _local_transfer_rows(self) -> list[dict]:
        """Straggler rows derived from THIS host's own peer transfer
        round-trips, grouped by owner — the demotion signal that exists
        on a real pod, where the local flight recorder's records all
        carry one host id (cross-host flight tables only appear in
        post-hoc journal merges or a shared recorder). An owner whose
        serves own the slowest decile of the requester's recent
        transfers is a straggler from where this host stands."""
        with self._lock:
            samples = list(self._transfer_ns)
        if len(samples) < 16:
            return []  # too few round-trips to call anyone slow
        durs = sorted(ns for _, ns in samples)
        k = max(1, len(durs) // 10)
        cut = durs[-k]
        tail_total = sum(1 for _, ns in samples if ns >= cut)
        rows = []
        for owner in {o for o, _ in samples}:
            mine = [ns for o, ns in samples if o == owner]
            rows.append({
                "host": owner,
                "count": len(mine),
                "p99_ms": max(mine) / 1e6,
                "tail_share": (
                    sum(1 for ns in mine if ns >= cut) / tail_total
                ),
            })
        return rows

    def _note_demotion(self, event: str, host: int) -> None:
        if self._flight_ring is None:
            return
        op = self._flight_ring.begin(
            f"coop/{event}/host{host}", "", install=False, kind="coop"
        )
        op.note("coop", event=event, host=host)
        op.finish(0)

    def maybe_refresh_demotions(self, flight) -> None:
        """Rate-limited live demotion pass (the workload calls this per
        step; the scan only runs every ``demote_interval_s``). Two
        signal sources, slow sets unioned: the recorder's per-host
        straggler table (meaningful when the recorder holds multi-host
        records — the hermetic threaded pod, a shared-journal merge) and
        this host's own per-owner peer transfer round-trips
        (:meth:`_local_transfer_rows` — the signal a real pod host has
        locally). A host slow by either measure leaves the ring; hosts
        clean in both are restored."""
        now = self._clock()
        if now - self._last_demote_check < self._demote_interval_s:
            return
        self._last_demote_check = now
        from tpubench_torch.obs.flight import straggler_attribution

        slow = self._slow_hosts_from_rows(
            straggler_attribution(flight.records(), by="host")
        )
        slow |= self._slow_hosts_from_rows(self._local_transfer_rows())
        self._apply_slow_set(slow)

    # ---------------------------------------------------------- lifecycle --
    def close(self) -> None:
        self._closed = True
        if self._channel is not None:
            self._channel.close()

    def stats(self) -> dict:
        with self._lock:
            requests = self.peer_requests
            transfer = (
                summarize_ns(np.asarray(
                    [ns for _, ns in self._transfer_ns], dtype=np.int64
                ))
                if self._transfer_ns else None
            )
            return {
                "enabled": self._enabled,
                "host_id": self.host_id,
                "hosts": len(self.ring.hosts),
                "active_hosts": len(self.ring.active_hosts),
                "demoted_hosts": sorted(self.ring.demoted),
                "peer_requests": requests,
                "peer_hits": self.peer_hits,
                "peer_misses": self.peer_misses,
                "peer_hit_ratio": (
                    self.peer_hits / requests if requests else None
                ),
                "peer_bytes": self.peer_bytes,
                "peer_serves": self.peer_serves,
                "peer_served_bytes": self.peer_served_bytes,
                "serve_errors": self.serve_errors,
                "budget_rejects": self.budget_rejects,
                "peer_budget_bytes": self._budget,
                "pod_coalesced": self.pod_coalesced,
                "origin_fetches": self.origin_fetches,
                "origin_bytes": self.origin_bytes,
                "owner_fetches": self.owner_fetches,
                "serve_origin_bytes": self.serve_origin_bytes,
                # What a per-host cache would have pulled from origin:
                # every peer hit would have been this host's own origin
                # fetch, while serve-triggered owner fetches would not
                # exist at all (their bytes already appear in the
                # requester's peer_bytes — counting both would inflate
                # the saved-% headline). A serve-fetched chunk the
                # owner LATER consumes from cache makes this estimate
                # conservative: the baseline would have fetched it.
                "per_host_origin_estimate_bytes": (
                    self.origin_bytes - self.serve_origin_bytes
                    + self.peer_bytes
                ),
                "demotions": self.demotions,
                "restores": self.restores,
                "handoff_out_chunks": self.handoff_out_chunks,
                "handoff_out_bytes": self.handoff_out_bytes,
                "handoff_in_chunks": self.handoff_in_chunks,
                "handoff_in_bytes": self.handoff_in_bytes,
                "handoff_rejects": self.handoff_rejects,
                "transfer_p50_ms": transfer.p50_ms if transfer else None,
                "transfer_p99_ms": transfer.p99_ms if transfer else None,
            }


# Shared-fabric broker slot: a membership-aware fabric (the elastic
# serve harness, an embedding test pod) registers its broker here so
# coop_from_config can build a MULTI-host loopback membership whose
# peers are actually reachable. One process, one pod fabric — a module
# slot, not a registry keyed by name.
_SHARED_BROKER: list = []


def register_shared_broker(broker: Optional[LoopbackBroker]) -> None:
    """Install (or, with None, clear) the process's shared pod broker.
    While installed, loopback multi-host memberships in
    :func:`coop_from_config` attach to it instead of failing."""
    _SHARED_BROKER[:] = [] if broker is None else [broker]


def shared_broker() -> Optional[LoopbackBroker]:
    return _SHARED_BROKER[0] if _SHARED_BROKER else None


def coop_from_config(cfg, cache: ChunkCache, origin_fetch,
                     *, pool=None, meter=None, flight=None, channel=None,
                     device: DeviceLike = "cuda"):
    """Build the run's :class:`CoopCache` from ``cfg.coop`` (None when
    the plane is off). Membership defaults to the pod's ranks (the world,
    this process's global rank: ``launch.member``); the channel defaults
    to loopback (a single-process pod degenerates to owner-local fetches
    with zero routing overhead), ``coop.channel="ici"`` rides
    :class:`tpubench_torch.dist.peer.IciPeerChannel` over the joined
    process group, on ``device``."""
    cc = getattr(cfg, "coop", None)
    if cc is None or not cc.enabled:
        return None
    # Ring members are ranks: a launched host's L ranks are L members.
    m = member(cfg.dist)
    n_hosts = cc.hosts or m.world
    host_id = cc.host_id if cc.host_id >= 0 else m.rank
    if channel is None:
        if cc.channel == "ici":
            from tpubench_torch.dist.peer import IciPeerChannel

            channel = IciPeerChannel(host_id=host_id, device=device)
        else:
            # Loopback + multi-host: only legal over a SHARED broker (a
            # membership-aware fabric registered one for this process).
            # A private broker spans exactly this process, so an N-host
            # membership over it would route most misses at peers that
            # can never answer — with elastic membership in the picture
            # that silent degrade is a measurement lie (the run claims
            # an N-host pod and measures a pod of one), so it is now a
            # hard error instead of a warning-and-collapse.
            broker = shared_broker()
            if n_hosts > 1 and broker is None:
                raise SystemExit(
                    f"coop: loopback channel cannot reach the other "
                    f"{n_hosts - 1} host(s) from process {host_id} — a "
                    "multi-host loopback membership needs a shared pod "
                    "fabric (register_shared_broker / the elastic serve "
                    "harness); on a real pod use --coop-channel ici"
                )
            if broker is None:
                broker = LoopbackBroker()
            channel = LoopbackChannel(broker, host_id)
    ring = HashRing(
        range(n_hosts) if n_hosts >= 1 else [host_id], vnodes=cc.vnodes
    )
    coop = CoopCache(
        cache,
        host_id=host_id,
        ring=ring,
        channel=channel,
        origin_fetch=origin_fetch,
        pool=pool,
        meter=meter,
        enabled=True,
        peer_budget_bytes=cc.peer_budget_bytes,
        demote_share=cc.demote_share,
        demote_interval_s=cc.demote_interval_s,
        retry_cfg=cfg.transport.retry,
        flight_ring=flight.worker("coop") if flight is not None else None,
        flight_recorder=flight,
    )
    broker = getattr(channel, "_broker", None)
    if broker is not None:
        broker.register(host_id, coop.serve, accept=coop.accept_handoff)
    return coop


# ------------------------------------------------------------- simulation ---


def zipf_plan(*args, **kwargs):
    """Promoted to :func:`tpubench_torch.workloads.arrivals.zipf_plan` (the
    one popularity-law definition serve and the coop sim share); this
    re-export keeps the coop surface stable. Imported lazily so the
    pipeline package never depends on workloads at import time."""
    from tpubench_torch.workloads.arrivals import zipf_plan as _zp

    return _zp(*args, **kwargs)


def run_coop_sim(
    *,
    n_hosts: int = 2,
    n_objects: int = 4,
    object_bytes: int = 2 * MB,
    chunk_bytes: int = 256 * 1024,
    accesses_per_host: int = 64,
    cache_bytes: int = 64 * MB,
    alpha: float = 1.2,
    seed: int = 0,
    coop: bool = True,
    slab_pool: bool = False,
    peer_budget_bytes: int = 0,
    host_delay_s: Optional[dict] = None,
    plan: Optional[list] = None,
    device: DeviceLike = "cuda",
) -> dict:
    """Hermetic multi-"host" pod simulation: N threaded hosts over one
    shared fake origin and a loopback peer transport, each walking its
    own Zipf-hot access sequence drawn from the SAME hot set. This is
    the coop-vs-per-host A/B harness behind the acceptance test and the
    bench's ``coop_cache`` cell — ``coop=False`` runs the identical
    machinery with routing disabled (the per-host-cache baseline), so
    the delta is the cooperation, not incidental code differences.

    ``plan`` overrides the per-host Zipf sequences with ONE shared
    access sequence every host walks — the N-hosts-read-overlapping-
    shards shape of a replicated checkpoint restore, where cooperation
    turns N× origin traffic into ~1×.

    ``device`` is where the slab pools' bytes go: ``"cuda"`` page-locks
    every host's pool (all built before any host starts, so no host
    thread pays the pinning), ``"cpu"`` does not.

    Returns the pod scorecard: ``origin_bytes_per_pod``, per-chunk
    origin fetch counts (the pod-wide single-flight proof), pod/peer
    hit ratios, per-host stats, and ``seconds``: the wall time of the
    hosts' walk (the pools' build excluded)."""
    from tpubench_torch.pipeline.prefetch import fetch_chunk
    from tpubench_torch.storage.fake import FakeBackend

    resolve_device(device)
    prefix = "coop/file_"
    backend = FakeBackend.prepopulated(
        prefix=prefix, count=n_objects, size=object_bytes
    )
    objects = backend.list(prefix)
    # Per-chunk origin fetch ledger: the exactly-once assertion's source.
    fetch_counts: dict[ChunkKey, int] = {}
    ledger_lock = threading.Lock()
    ring = HashRing(range(n_hosts))
    broker = LoopbackBroker()
    hosts: list[dict] = []
    for h in range(n_hosts):
        pool = (
            SlabPool(chunk_bytes, 64, device=device) if slab_pool else None
        )
        meter = CopyMeter()
        cache = ChunkCache(cache_bytes)

        def origin_fetch(key: ChunkKey, _pool=pool, _meter=meter):
            with ledger_lock:
                fetch_counts[key] = fetch_counts.get(key, 0) + 1
            return fetch_chunk(backend, key, pool=_pool, meter=_meter)

        cc = CoopCache(
            cache,
            host_id=h,
            ring=ring,
            channel=LoopbackChannel(broker, h),
            origin_fetch=origin_fetch,
            pool=pool,
            meter=meter,
            enabled=coop,
            peer_budget_bytes=peer_budget_bytes,
        )
        broker.register(
            h, cc.serve,
            delay_s=(host_delay_s or {}).get(h, 0.0),
        )
        host_plan = list(plan) if plan is not None else zipf_plan(
            objects, chunk_bytes, accesses_per_host,
            alpha=alpha, seed=seed * 1000 + h,
        )
        hosts.append({
            "coop": cc, "cache": cache, "pool": pool, "meter": meter,
            "plan": host_plan, "error": None,
        })

    def run_host(entry: dict) -> None:
        cc: CoopCache = entry["coop"]
        try:
            for key in entry["plan"]:
                payload = cc.cache.get_or_fetch(
                    key, lambda k=key: cc.fetch(k)
                )
                release_payload(payload)
        except Exception as exc:  # noqa: BLE001 — surfaced below
            # Exception, not BaseException (the Ctrl-C rule): a
            # KeyboardInterrupt on a sim host thread should unwind the
            # sim, not masquerade as a per-host fetch error.
            entry["error"] = f"{type(exc).__name__}: {exc}"

    threads = [
        threading.Thread(target=run_host, args=(e,), name=f"coop-host-{i}")
        for i, e in enumerate(hosts)
    ]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    per_host = []
    agg = {
        "origin_fetches": 0, "origin_bytes": 0, "peer_requests": 0,
        "peer_hits": 0, "peer_misses": 0, "peer_bytes": 0,
        "pod_coalesced": 0, "budget_rejects": 0,
        "hits": 0, "misses": 0, "coalesced": 0,
    }
    copies_ok = True
    errors = []
    for e in hosts:
        cc, cache = e["coop"], e["cache"]
        s = cc.stats()
        cs = cache.stats()
        cp = e["meter"].stats()
        if e["pool"] is not None:
            cache.close()
            e["pool"].close()
            cpb = cp.get("copies_per_byte")
            if cpb is not None and cpb > 1.0 + 1e-9:
                copies_ok = False
        per_host.append({"coop": s, "cache": cs, "copies": cp})
        if e["error"]:
            errors.append(e["error"])
        for k in ("origin_fetches", "origin_bytes", "peer_requests",
                  "peer_hits", "peer_misses", "peer_bytes",
                  "pod_coalesced", "budget_rejects"):
            agg[k] += s[k]
        for k, ck in (("hits", "hits"), ("misses", "misses"),
                      ("coalesced", "coalesced")):
            agg[k] += cs[ck]
    lookups = agg["hits"] + agg["misses"] + agg["coalesced"]
    unique = len(fetch_counts)
    return {
        "n_hosts": n_hosts,
        "coop": coop,
        "accesses_per_host": accesses_per_host,
        "origin_bytes_per_pod": agg["origin_bytes"],
        "origin_fetches_per_pod": agg["origin_fetches"],
        "unique_chunks_fetched": unique,
        "max_origin_fetches_per_chunk": (
            max(fetch_counts.values()) if fetch_counts else 0
        ),
        "pod_hit_ratio": (agg["hits"] / lookups) if lookups else None,
        "peer_hit_ratio": (
            agg["peer_hits"] / agg["peer_requests"]
            if agg["peer_requests"] else None
        ),
        "peer_bytes": agg["peer_bytes"],
        "peer_hits": agg["peer_hits"],
        "peer_misses": agg["peer_misses"],
        "pod_coalesced": agg["pod_coalesced"],
        "budget_rejects": agg["budget_rejects"],
        "backend_opens": backend.open_count,
        "copies_per_byte_ok": copies_ok,
        "errors": errors,
        "per_host": per_host,
        "seconds": seconds,
    }
