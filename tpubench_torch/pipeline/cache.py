"""Bounded host-RAM chunk cache with single-flight miss dedup (a copy of
``tpubench/pipeline/cache.py``).

The pipeline's working set is chunks — ``(bucket, object, generation,
range)``-keyed byte slices of storage objects. The cache is byte-budgeted
(not entry-counted: a 100 MB chunk and a 256 KB chunk are not the same
cost) with LRU eviction, and **single-flight**: N concurrent misses for
one chunk issue ONE backend read, the rest wait on it (the coalesce
counter records how many reads the dedup saved — the thundering-herd
shape a prefetcher racing demand reads produces constantly).

Generation is part of the key, so an overwritten object can never serve
stale bytes; entries of superseded generations are dropped eagerly the
moment a newer generation is seen (counted, so invalidation is
observable in the ``extra["pipeline"]["cache"]`` stamp).

Prefetch-efficiency accounting lives here because only the cache sees
both sides: entries carry their origin (``prefetch`` vs ``demand``) and
a used bit; a prefetched entry's bytes count as *used* on its first hit
and as *wasted* when it is evicted — or still sitting unused at the end
of the run — without ever being consumed.

**Payloads** are either immutable ``bytes`` (the legacy / A-B baseline
arm) or refcounted :class:`~tpubench_torch.mem.slab.SlabLease`\\ s (the
zero-copy arm). The cache stores the payload object as-is — never a
copy — and manages lease references: it takes one reference when an
entry lands, drops it on eviction (retiring the slab once no consumer
still reads it), and hands every *consumer* access its OWN reference,
which the consumer releases when done. Non-consumer accesses (the
prefetcher probing its own work) get the payload without a reference
and must not release.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, NamedTuple, Optional

from tpubench_torch.mem.slab import SlabLease


def _freeze(data):
    """Storable payload: ``bytes`` and slab leases pass through untouched;
    only mutable buffers (bytearray/memoryview) are copied, and at most
    once."""
    if isinstance(data, (bytes, SlabLease)):
        return data
    return bytes(data)


class ChunkKey(NamedTuple):
    bucket: str
    object: str
    generation: int
    start: int
    length: int


class _Entry:
    __slots__ = ("data", "origin", "used", "owner", "pins")

    def __init__(self, data: bytes, origin: str, owner: Optional[str] = None):
        self.data = data
        self.origin = origin
        self.used = False
        # QoS tagging (the serve plane): which tenant class these bytes
        # belong to — the weighted-eviction victim-selection key.
        self.owner = owner
        # Single-flight waiter pins: consumers registered on the fetch
        # that produced this entry but not yet woken. A pinned entry is
        # never an eviction victim — evicting bytes a waiter is about
        # to consume would turn the single-flight save into an instant
        # re-fetch (and, on the weighted path, let one class's budget
        # pressure break another class's in-flight coalesce).
        self.pins = 0


class _Flight:
    """One in-flight fetch; losers of the single-flight race wait on it."""

    __slots__ = ("event", "data", "error", "consumer_waiters")

    def __init__(self):
        self.event = threading.Event()
        self.data = None  # bytes | SlabLease once the fetch lands
        self.error: Optional[BaseException] = None
        # Consumers blocked on this fetch (lock-guarded): the owner
        # marks the landed entry used at INSERT time when any exist, so
        # an eviction racing the waiter's wakeup can never count bytes
        # that were consumed as prefetch waste.
        self.consumer_waiters = 0


class ChunkCache:
    """Thread-safe byte-budgeted LRU chunk cache (see module docstring).

    ``capacity_bytes <= 0`` disables storage entirely — every access is a
    recorded miss that fetches through (the cold baseline arm of the
    pipeline A/B), and single-flight dedup still applies.
    """

    def __init__(self, capacity_bytes: int, debug: bool = False,
                 owner_budgets: Optional[dict] = None):
        self.capacity = max(0, int(capacity_bytes))
        # Weighted per-owner (tenant-class) byte budgets — the serve
        # plane's QoS hook. None/empty = classic single-tenant LRU.
        # With budgets set, an insert first evicts the INSERTING
        # owner's own least-recent unpinned entries while it is over
        # its budget (a class pays for its own overrun), and capacity
        # eviction prefers victims from the most-over-budget owner
        # before falling back to global LRU. Budgets are soft caps:
        # when an over-budget owner has only pinned entries the insert
        # still lands (correctness over strictness) and the overrun is
        # counted.
        self.owner_budgets = dict(owner_budgets or {})
        self.owner_bytes: dict[str, int] = {}
        # debug=True re-derives the byte-accounting invariants after
        # every mutation (O(entries) each — test harnesses only). The
        # live-reclamp path (Prefetcher.reclamp) leans on exactly these:
        # a depth/budget shrink mid-flight must never strand in-flight
        # chunk bytes in the resident-unused counter.
        self._debug = debug
        self.bytes = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[ChunkKey, _Entry]" = OrderedDict()
        self._inflight: dict[ChunkKey, _Flight] = {}
        self._obj_gen: dict[tuple[str, str], int] = {}
        # Counters (the extra["pipeline"]["cache"] stamp).
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.coalesced = 0  # misses served by an already-in-flight fetch
        self.inserted_bytes = 0
        self.evicted_bytes = 0
        self.oversize_skips = 0  # chunks larger than the whole budget
        self.generation_invalidations = 0
        self.stale_rejects = 0  # superseded-generation inserts refused
        self.prefetch_inserted_bytes = 0
        self.prefetch_used_bytes = 0
        # Two flavors of prefetch waste, kept separate on purpose: the
        # prefetcher's byte-budget estimate relies on the identity
        # resident_unused = inserted - used - wasted, so `wasted` may
        # only count bytes that WERE resident (evictions). Bytes that
        # never entered the cache (oversize skip, stale-generation
        # reject) go in `dropped` — folding them into `wasted` would
        # deflate the identity and let prefetch exceed its budget.
        self.prefetch_wasted_bytes = 0  # evicted before any use
        self.prefetch_dropped_bytes = 0  # never cached at all
        self.prefetch_invalidated_bytes = 0  # dropped by a newer generation
        self.owner_evictions = 0  # evictions charged to an owner budget
        self.owner_budget_overruns = 0  # soft-cap overruns (pins held)
        self.pinned_capacity_overruns = 0  # capacity exceeded, all pinned
        # Directly-maintained count of resident prefetched-but-unused
        # bytes: the prefetcher's byte-budget source of truth (O(1),
        # no derived identity to keep consistent across drop reasons).
        self.prefetch_resident_unused = 0

    # ------------------------------------------------------------ internal --
    def _assert_invariants_locked(self) -> None:
        """Debug-mode accounting invariants (the resize-safety guard):
        the directly-maintained resident-unused counter must equal the
        sum over resident prefetched-but-unused entries, and the byte
        total must match what is actually resident — whatever sequence
        of inserts/evictions/invalidations/live-reclamps ran."""
        resident = sum(len(e.data) for e in self._entries.values())
        assert self.bytes == resident, (
            f"cache bytes drift: counter={self.bytes} resident={resident}"
        )
        unused = sum(
            len(e.data) for e in self._entries.values()
            if e.origin == "prefetch" and not e.used
        )
        assert self.prefetch_resident_unused == unused, (
            f"prefetch_resident_unused drift: "
            f"counter={self.prefetch_resident_unused} actual={unused}"
        )
        assert 0 <= self.prefetch_resident_unused <= (
            self.prefetch_inserted_bytes
        )
        by_owner: dict = {}
        for e in self._entries.values():
            if e.owner is not None:
                by_owner[e.owner] = by_owner.get(e.owner, 0) + len(e.data)
        assert {k: v for k, v in self.owner_bytes.items() if v} == by_owner, (
            f"owner_bytes drift: counter={self.owner_bytes} actual={by_owner}"
        )

    def _note_generation_locked(self, key: ChunkKey) -> None:
        """Eager invalidation: the first sighting of a newer generation
        drops every entry of the object's older generations."""
        ok = (key.bucket, key.object)
        g = self._obj_gen.get(ok)
        if g is None or key.generation > g:
            if g is not None:
                stale = [
                    k for k in self._entries
                    if (k.bucket, k.object) == ok and k.generation < key.generation
                ]
                for k in stale:
                    self._drop_locked(k, reason="invalidate")
                    self.generation_invalidations += 1
            self._obj_gen[ok] = key.generation

    def _mark_used_locked(self, e: _Entry) -> None:
        if e.origin == "prefetch" and not e.used:
            self.prefetch_used_bytes += len(e.data)
            self.prefetch_resident_unused -= len(e.data)
        e.used = True
        if self._debug:
            self._assert_invariants_locked()

    def _drop_locked(self, key: ChunkKey, reason: str = "evict") -> None:
        e = self._entries.pop(key)
        self.bytes -= len(e.data)
        self.evicted_bytes += len(e.data)
        if e.owner is not None:
            left = self.owner_bytes.get(e.owner, 0) - len(e.data)
            if left > 0:
                self.owner_bytes[e.owner] = left
            else:
                self.owner_bytes.pop(e.owner, None)
        if e.origin == "prefetch" and not e.used:
            self.prefetch_resident_unused -= len(e.data)
            if reason == "invalidate":
                # Kept out of `wasted`: the prefetcher's cancel-on-
                # eviction thrash guard watches wasted bytes, and a
                # generation invalidation is data churn, not a sign the
                # readahead window outran the cache budget.
                self.prefetch_invalidated_bytes += len(e.data)
            else:
                self.prefetch_wasted_bytes += len(e.data)
        if isinstance(e.data, SlabLease):
            # Drop the CACHE's reference only: a consumer still reading
            # the slab holds its own, so the memory outlives the entry.
            e.data.release()
        if self._debug:
            self._assert_invariants_locked()

    def _victim_locked(self, prefer_owner: Optional[str]) -> Optional[ChunkKey]:
        """Next eviction victim: least-recent UNPINNED entry, preferring
        ``prefer_owner``'s entries when given, else (with budgets set)
        the most-over-budget owner's, else global LRU. None when every
        entry is pinned (single-flight waiters hold them all — the
        caller overruns rather than break an in-flight coalesce)."""
        if prefer_owner is None and self.owner_budgets:
            worst, worst_ratio = None, 1.0
            for owner, b in self.owner_bytes.items():
                budget = self.owner_budgets.get(owner)
                if budget and b > budget and b / budget > worst_ratio:
                    worst, worst_ratio = owner, b / budget
            prefer_owner = worst
        fallback = None
        for k, e in self._entries.items():  # OrderedDict: LRU first
            if e.pins:
                continue
            if prefer_owner is not None and e.owner == prefer_owner:
                return k
            if fallback is None:
                fallback = k
        return fallback

    def _evict_to_fit_locked(self, n: int, owner: Optional[str]) -> None:
        """Make room for an ``n``-byte insert by ``owner``: first charge
        the inserting owner's own budget (its unpinned LRU entries go
        while it is over), then global capacity with over-budget-owner
        preference. Stops (soft overrun, counted) when only pinned
        entries remain."""
        budget = self.owner_budgets.get(owner) if owner is not None else None
        while budget and self.owner_bytes.get(owner, 0) + n > budget:
            victim = None
            for k, e in self._entries.items():
                if e.owner == owner and not e.pins:
                    victim = k
                    break
            if victim is None:
                if self.owner_bytes.get(owner, 0) + n > budget:
                    self.owner_budget_overruns += 1
                break
            self._drop_locked(victim)
            self.evictions += 1
            self.owner_evictions += 1
        while self.bytes + n > self.capacity:
            victim = self._victim_locked(None)
            if victim is None:
                # Every resident entry is pinned by single-flight
                # waiters: capacity soft-overruns. Counted separately
                # from owner_budget_overruns — this fires on a classic
                # (budget-less) cache too and must not read as phantom
                # QoS budget pressure.
                self.pinned_capacity_overruns += 1
                break
            self._drop_locked(victim)
            self.evictions += 1

    def _insert_locked(self, key: ChunkKey, data, origin: str,
                       owner: Optional[str] = None, pins: int = 0) -> None:
        n = len(data)
        g = self._obj_gen.get((key.bucket, key.object))
        if g is not None and key.generation < g:
            # An in-flight fetch of a superseded generation completed
            # AFTER the invalidation pass — never resurrect stale bytes
            # (a later gen-g sighting would not drop them: invalidation
            # fires only on strictly newer generations).
            self.stale_rejects += 1
            if origin == "prefetch":
                self.prefetch_dropped_bytes += n
            return
        if n > self.capacity:
            # A chunk that cannot fit even an empty cache would evict the
            # whole working set for nothing — serve it uncached.
            self.oversize_skips += 1
            if origin == "prefetch":
                self.prefetch_dropped_bytes += n
            return
        if key in self._entries:
            return  # racer already inserted the same (immutable) bytes
        self._evict_to_fit_locked(n, owner)
        if isinstance(data, SlabLease):
            # The cache's own reference (dropped by _drop_locked). Lock
            # order is cache lock -> pool lock, everywhere.
            data.incref()
        entry = _Entry(data, origin, owner)
        entry.pins = pins
        self._entries[key] = entry
        if owner is not None:
            self.owner_bytes[owner] = self.owner_bytes.get(owner, 0) + n
        self.bytes += n
        self.inserted_bytes += n
        if origin == "prefetch":
            self.prefetch_inserted_bytes += n
            self.prefetch_resident_unused += n
        if self._debug:
            self._assert_invariants_locked()

    def _hit_locked(self, key: ChunkKey, e: _Entry):
        self._entries.move_to_end(key)
        self.hits += 1
        self._mark_used_locked(e)
        if isinstance(e.data, SlabLease):
            # Every consumer access owns a reference: an eviction between
            # this return and the consumer's read must not retire the slab.
            e.data.incref()
        return e.data

    # ------------------------------------------------------------- surface --
    def get(self, key: ChunkKey):
        """Consumer hit-or-None lookup (no fetch, no miss accounting).
        The prefetcher's membership probe is :meth:`contains` — this one
        counts a hit, marks the entry used, and (lease payloads) hands the
        caller its own reference to release."""
        with self._lock:
            e = self._entries.get(key)
            return self._hit_locked(key, e) if e is not None else None

    def contains(self, key: ChunkKey) -> bool:
        with self._lock:
            return key in self._entries or key in self._inflight

    def set_owner_budgets(self, budgets: dict) -> None:
        """Live re-split of the per-owner byte budgets (the serve
        plane's weighted-cache knob); enforcement is lazy — the next
        insert by an over-budget owner pays."""
        with self._lock:
            self.owner_budgets = dict(budgets or {})

    def get_or_fetch(
        self, key: ChunkKey, fetch: Callable[[], object],
        origin: str = "demand", consumer: bool = True,
        owner: Optional[str] = None,
    ):
        """The consumer path: hit → cached bytes; miss → ``fetch()`` once
        per key no matter how many threads ask concurrently (losers wait
        and share the winner's bytes — or its exception).

        ``consumer=False`` is the prefetcher's variant: a hit neither
        counts nor marks the entry used (the prefetcher finding its work
        already done is not a consumption), and joining an in-flight
        fetch is not a coalesce save."""
        return self.get_or_fetch_info(key, fetch, origin, consumer, owner)[0]

    def get_or_fetch_info(
        self, key: ChunkKey, fetch: Callable[[], object],
        origin: str = "demand", consumer: bool = True,
        owner: Optional[str] = None,
    ) -> tuple:
        """:meth:`get_or_fetch` plus HOW the bytes arrived — ``"hit"``
        (already cached), ``"fetched"`` (this caller issued the backend
        read) or ``"coalesced"`` (joined another caller's in-flight
        read). Callers that account delivered-from-storage bytes (the
        flight records the chaos scorecard sums) credit them only to the
        ``"fetched"`` owner, so one backend read is never counted
        twice."""
        # One consumer access contributes exactly ONE count — hit, miss
        # or coalesce — decided by its FINAL outcome: a consumer that
        # joins a failed fetch and loops back to fetch itself is one
        # miss, not a coalesce plus a miss (hit_ratio's denominator
        # would otherwise inflate precisely in fault runs).
        while True:
            with self._lock:
                self._note_generation_locked(key)
                e = self._entries.get(key)
                if e is not None:
                    if not consumer:
                        return e.data, "hit"
                    return self._hit_locked(key, e), "hit"
                fl = self._inflight.get(key)
                if fl is None:
                    fl = self._inflight[key] = _Flight()
                    if consumer:
                        self.misses += 1
                    break  # owner: fetch below
                if consumer:
                    # Register on EVERY flight joined (a consumer whose
                    # first joined fetch failed loops back and may join
                    # a re-scheduled attempt — that flight too must
                    # mark-at-insert). The coalesce COUNT, by contrast,
                    # is only taken on a successful join below.
                    fl.consumer_waiters += 1
            fl.event.wait()
            if fl.error is None:
                assert fl.data is not None
                if not consumer:
                    # A prefetch worker that raced another fetch for the
                    # same chunk: the chunk landed, its job is done. No
                    # payload reference is taken (only consumers own
                    # references), so the caller must not release.
                    return fl.data, "coalesced"
                # A demand read joining an in-flight PREFETCH consumed
                # those bytes: mark the landed entry used, or the very
                # overlap the pipeline exists to produce would be counted
                # as prefetch waste (and a readahead byte budget would
                # slowly choke on phantom outstanding bytes). The
                # consumer's payload reference was taken by the owner at
                # insert time (one per registered waiter).
                with self._lock:
                    self.coalesced += 1
                    e = self._entries.get(key)
                    if e is not None:
                        if e.origin == "prefetch" and not e.used:
                            self._mark_used_locked(e)
                        if e.pins > 0:
                            # This waiter's pin is spent: once every
                            # registered waiter has woken the entry
                            # competes for eviction like any other.
                            e.pins -= 1
                return fl.data, "coalesced"
            if not consumer:
                # A prefetch worker joining a failed fetch stays
                # advisory: surface the error, the worker records it.
                raise fl.error
            # The joined fetch failed — but prefetch (the usual owner)
            # is advisory, and its retry window may have opened long
            # before this consumer arrived. A demand read is entitled
            # to its OWN attempt with a fresh retry stack: loop back
            # and (most likely) become the owner. Readahead must never
            # make a run strictly LESS fault-tolerant than cold reads.
        try:
            # At most ONE copy, and only for mutable fetch results: bytes
            # and slab leases store as-is.
            data = _freeze(fetch())
        except BaseException as exc:
            with self._lock:
                fl.error = exc
                del self._inflight[key]
            fl.event.set()
            raise
        with self._lock:
            fl.data = data
            del self._inflight[key]
            # Registered waiters pin the entry until each wakes (the
            # weighted evictor skips pinned entries — see _Entry.pins).
            self._insert_locked(
                key, data, origin, owner=owner, pins=fl.consumer_waiters
            )
            if fl.consumer_waiters:
                # A consumer is already waiting on these bytes: they ARE
                # consumed. Mark at insert, not at the waiter's wakeup —
                # an eviction in between must not count them as waste
                # (and spuriously clamp the readahead depth).
                e = self._entries.get(key)
                if e is not None:
                    self._mark_used_locked(e)
                if isinstance(data, SlabLease):
                    # One payload reference per registered consumer waiter
                    # (they wake after the event and each release when
                    # done); taken under the cache lock, BEFORE the event,
                    # so no waiter can observe an unreferenced payload.
                    for _ in range(fl.consumer_waiters):
                        data.incref()
        fl.event.set()
        return data, "fetched"

    def insert(self, key: ChunkKey, data, origin: str = "demand",
               owner: Optional[str] = None) -> None:
        with self._lock:
            self._note_generation_locked(key)
            self._insert_locked(key, _freeze(data), origin, owner=owner)

    def close(self) -> None:
        """Run teardown: drop every resident entry, releasing the cache's
        lease references so the slab pool's leak detector sees only REAL
        leaks. Deliberately touches no counters — end-of-run stats were
        already snapshotted, and resident-but-unused prefetched bytes are
        ALREADY counted as waste by ``unused_prefetched_bytes``."""
        with self._lock:
            entries, self._entries = self._entries, OrderedDict()
            self.bytes = 0
        for e in entries.values():
            if isinstance(e.data, SlabLease):
                e.data.release()

    def export_manifest(self, max_bytes: int = 0) -> list:
        """MRU-first snapshot of resident entry identities as ``(key,
        owner)`` pairs — the cooperative-departure **hot set** a leaving
        owner drains to its chunks' new owners (the owner tag travels
        too, so QoS byte-budget accounting survives the hop). Read-only:
        no counters move, no LRU order changes, no payload bytes are
        copied here — the drain copies one entry at a time through
        :meth:`peek_bytes`, so a whole-cache drain never transiently
        doubles the host's cache footprint. A byte budget
        (``max_bytes``; 0 = everything) bounds the manifest to the
        hottest entries."""
        out: list = []
        total = 0
        with self._lock:
            for k in reversed(self._entries):  # OrderedDict: MRU first
                n = len(self._entries[k].data)
                if max_bytes and total + n > max_bytes:
                    break
                out.append((k, self._entries[k].owner))
                total += n
        return out

    def peek_bytes(self, key: ChunkKey):
        """One entry's payload as immutable bytes, or None when it is
        no longer resident. No counters move, no LRU reorder, no
        payload reference taken — the copy happens under the cache
        lock, so a concurrent eviction can never retire a slab
        mid-read."""
        from tpubench_torch.mem.slab import payload_view

        with self._lock:
            e = self._entries.get(key)
            return bytes(payload_view(e.data)) if e is not None else None

    def unused_prefetched_bytes(self) -> int:
        """Prefetched entries still waiting for their first use — at end
        of run these are waste (the prefetcher folds them in)."""
        with self._lock:
            return self.prefetch_resident_unused

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses + self.coalesced
            return {
                "capacity_bytes": self.capacity,
                "resident_bytes": self.bytes,
                "entries": len(self._entries),
                "hits": self.hits,
                "misses": self.misses,
                "coalesced": self.coalesced,
                "hit_ratio": (self.hits / lookups) if lookups else None,
                "evictions": self.evictions,
                "inserted_bytes": self.inserted_bytes,
                "evicted_bytes": self.evicted_bytes,
                "oversize_skips": self.oversize_skips,
                "generation_invalidations": self.generation_invalidations,
                "stale_rejects": self.stale_rejects,
                "prefetch_inserted_bytes": self.prefetch_inserted_bytes,
                "prefetch_used_bytes": self.prefetch_used_bytes,
                "prefetch_wasted_bytes": self.prefetch_wasted_bytes,
                "prefetch_dropped_bytes": self.prefetch_dropped_bytes,
                "prefetch_invalidated_bytes": self.prefetch_invalidated_bytes,
                "owner_evictions": self.owner_evictions,
                "owner_budget_overruns": self.owner_budget_overruns,
                "pinned_capacity_overruns": self.pinned_capacity_overruns,
                "owner_bytes": dict(self.owner_bytes),
                "owner_budgets": dict(self.owner_budgets),
            }
