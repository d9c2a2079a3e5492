"""In-process fake object store with deterministic content and fault
injection — the read half of ``tpubench/storage/fake.py``: the same
objects from the same names (``deterministic_bytes``), the same open/read
faults, and no upload sessions (those arrive with the lifecycle slice).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from tpubench_torch.storage.base import (
    ObjectMeta,
    StorageError,
    deterministic_bytes,
)


@dataclass
class FaultPlan:
    """Deterministic fault injection for tests and resilience benchmarks.

    Field-compatible with :class:`tpubench_torch.config.FaultConfig` by
    contract (``open_backend`` builds one from the other by name). Beyond the
    rate/latency knobs it carries the chaos plane: shaped faults (stall /
    slow-drip / truncation / connection reset, all triggered after a byte
    threshold) and a time-phased schedule — ``phases`` is a sequence of
    ``(t0, t1, plan)`` windows relative to :meth:`arm`'s epoch during
    which ``plan`` replaces the base fields. The fake backend resolves
    the moment's effective plan via :meth:`at` per operation, so a phase turning on mid-run hits streams
    already in flight — exactly the shape a tail-tolerance layer must
    survive."""

    error_rate: float = 0.0  # probability a read-open raises transient 503
    read_error_rate: float = 0.0  # probability a granule read raises mid-stream
    latency_s: float = 0.0  # fixed added latency per open (first byte)
    per_read_latency_s: float = 0.0  # added latency per granule read
    seed: int = 0
    # Shaped faults (see FaultConfig for semantics): stall once after N
    # delivered bytes (stall_rate = P(this reader stalls); big stall_s =
    # blackhole), cap per-reader throughput, end the body early, or kill
    # the stream after N bytes.
    stall_after_bytes: int = 0
    stall_s: float = 0.0
    stall_rate: float = 1.0
    drip_bps: float = 0.0
    truncate_after_bytes: int = 0
    reset_after_bytes: int = 0
    # Upload-side faults act on upload sessions, which this read-half
    # backend does not have; kept so FaultConfig maps on by name.
    upload_error_rate: float = 0.0
    upload_stall_s: float = 0.0
    upload_stall_rate: float = 1.0
    upload_reset_after_bytes: int = 0
    phases: tuple = ()  # ((t0, t1, FaultPlan | field-dict), ...)

    def __post_init__(self):
        self._epoch: Optional[float] = None
        self._clock = time.monotonic
        norm = []
        for t0, t1, plan in self.phases or ():
            if isinstance(plan, dict):
                # Phase dicts inherit the base seed unless they set one,
                # so a seeded timeline stays deterministic end to end.
                plan = FaultPlan(**{"seed": self.seed, **plan})
            norm.append((float(t0), float(t1), plan))
        self.phases = tuple(norm)

    def rng(self) -> random.Random:
        return random.Random(self.seed)

    def arm(self, clock=None) -> "FaultPlan":
        """Pin the schedule's epoch to *now* (chaos calls this right
        before the workload starts so phase windows line up with the
        scorecard's timeline). ``clock`` is injectable for tests."""
        if clock is not None:
            self._clock = clock
        self._epoch = self._clock()
        return self

    def at(self, now: Optional[float] = None) -> "FaultPlan":
        """The effective plan at ``now`` (default: the armed clock's
        current reading; auto-arms on first use). Plans without phases
        return themselves — the common case costs one tuple check."""
        if not self.phases:
            return self
        if self._epoch is None:
            self.arm()
        t = (self._clock() if now is None else now) - self._epoch
        for t0, t1, plan in self.phases:
            if t0 <= t < t1:
                return plan
        return self


class _FakeReader:
    """Streams a (possibly range-limited) view of an in-memory object.

    Holds the ROOT fault plan (not a phase snapshot) and resolves the
    effective plan per ``readinto``, so a scheduled fault phase switching
    on mid-stream shapes a read that is already in flight."""

    def __init__(self, data: memoryview, fault: FaultPlan, rng: random.Random,
                 generation: int = 0):
        self._data = data
        self._pos = 0
        self._fault = fault
        self._rng = rng
        self.first_byte_ns: Optional[int] = None
        # Generation of the object this stream serves (the GCS
        # `x-goog-generation` surface) — what the pipeline cache keys on,
        # so generation-change invalidation is testable hermetically.
        self.generation = generation
        self._closed = False
        self._delivered = 0
        self._stall_rolled = False

    def readinto(self, buf: memoryview) -> int:
        if self._closed:
            raise StorageError("reader closed", transient=False)
        if self._pos >= len(self._data):
            return 0
        plan = self._fault.at()
        if plan.per_read_latency_s:
            time.sleep(plan.per_read_latency_s)
        if plan.read_error_rate and self._rng.random() < plan.read_error_rate:
            raise StorageError("injected mid-stream failure", transient=True, code=503)
        if plan.reset_after_bytes and self._delivered >= plan.reset_after_bytes:
            # Abrupt stream death: the servers translate this into a
            # closed socket / RST_STREAM; direct users see the transient.
            raise StorageError(
                "injected connection reset", transient=True, code=104
            )
        if plan.truncate_after_bytes and self._delivered >= plan.truncate_after_bytes:
            return 0  # clean EOF short of the announced length
        if plan.stall_s > 0 and not self._stall_rolled and (
            self._delivered >= plan.stall_after_bytes
        ):
            # One roll per reader: either this stream is a straggler
            # (pause once for stall_s) or it never stalls — the
            # probabilistic-straggler shape hedged reads race against.
            self._stall_rolled = True
            if plan.stall_rate >= 1.0 or self._rng.random() < plan.stall_rate:
                time.sleep(plan.stall_s)
        n = min(len(buf), len(self._data) - self._pos)
        if plan.drip_bps > 0:
            # Slow-drip: cap the chunk so the pacing sleep stays fine-
            # grained (a whole-granule sleep would look like a stall).
            n = max(1, min(n, int(plan.drip_bps * 0.05)))
        buf[:n] = self._data[self._pos : self._pos + n]
        self._pos += n
        self._delivered += n
        if self.first_byte_ns is None:
            self.first_byte_ns = time.perf_counter_ns()
        if plan.drip_bps > 0:
            time.sleep(n / plan.drip_bps)
        return n

    def close(self) -> None:
        self._closed = True


class FakeBackend:
    """Thread-safe in-memory store whose objects come from
    :func:`deterministic_bytes` via ``prepopulated``/``from_population``."""

    def __init__(self, fault: Optional[FaultPlan] = None):
        self._objects: dict[str, np.ndarray] = {}
        self._generation: dict[str, int] = {}
        self._lock = threading.Lock()
        self.fault = fault or FaultPlan()
        self._rng = self.fault.rng()
        self._rng_lock = threading.Lock()
        # Observability for tests: how many opens/reads/faults happened.
        self.open_count = 0
        self.injected_errors = 0

    # ------------------------------------------------------------- setup --
    @classmethod
    def prepopulated(
        cls,
        prefix: str,
        count: int,
        size: int,
        fault: Optional[FaultPlan] = None,
    ) -> "FakeBackend":
        """Objects named ``<prefix><i>`` (reference naming: object of worker i
        is ``ObjectNamePrefix + strconv.Itoa(workerId)``, main.go:121)."""
        be = cls(fault=fault)
        for i in range(count):
            name = f"{prefix}{i}"
            be._objects[name] = deterministic_bytes(name, size)
            be._generation[name] = 1
        return be

    @classmethod
    def from_population(
        cls,
        objects: Iterable,
        fault: Optional[FaultPlan] = None,
    ) -> "FakeBackend":
        """A store rebuilt from an explicit population — ``(name, size,
        generation)`` triples or ObjectMeta: contents regenerate from
        :func:`deterministic_bytes` (name+size fully determine the bytes,
        same as ``prepopulated``), and the generations are preserved."""
        be = cls(fault=fault)
        for obj in objects:
            if isinstance(obj, ObjectMeta):
                name, size, gen = obj.name, obj.size, obj.generation
            else:
                name, size, gen = obj
            be._objects[name] = deterministic_bytes(name, int(size))
            be._generation[name] = int(gen) or 1
        return be

    # ----------------------------------------------------------- backend --
    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        with self._rng_lock:
            r = self._rng.random()
            reader_rng = random.Random(self._rng.getrandbits(64))
        plan = self.fault.at()
        if plan.latency_s:
            time.sleep(plan.latency_s)
        if plan.error_rate and r < plan.error_rate:
            self.injected_errors += 1
            raise StorageError("injected open failure", transient=True, code=503)
        with self._lock:
            obj = self._objects.get(name)
            gen = self._generation.get(name, 1)
            self.open_count += 1
        if obj is None:
            raise StorageError(f"object not found: {name}", transient=False, code=404)
        end = len(obj) if length is None else min(start + length, len(obj))
        if start > len(obj):
            raise StorageError(
                f"range start {start} > size {len(obj)}", transient=False, code=416
            )
        return _FakeReader(
            memoryview(obj.data)[start:end], self.fault, reader_rng,
            generation=gen,
        )

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]:
        # page_size is a wire concept (maxResults/pageToken): the fake
        # servers slice pages; the store serves one listing.
        with self._lock:
            return sorted(
                (
                    ObjectMeta(n, len(o), self._generation.get(n, 1))
                    for n, o in self._objects.items()
                    if n.startswith(prefix)
                ),
                key=lambda m: m.name,
            )

    def stat(self, name: str) -> ObjectMeta:
        with self._lock:
            obj = self._objects.get(name)
            if obj is None:
                raise StorageError(f"object not found: {name}", transient=False, code=404)
            return ObjectMeta(name, len(obj), self._generation.get(name, 1))

    def close(self) -> None:
        pass
