"""In-process fake object store with deterministic content and fault
injection — a copy of ``tpubench/storage/fake.py``: the same objects
from the same names (``deterministic_bytes``), the same open/read faults,
and the same resumable-upload session store with its upload-side faults.
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
    # Upload-side faults (the ckpt-save chaos surface; see FaultConfig):
    # part-append 503s, one mid-upload stall per session, and the
    # truncate-then-reset shape — a part whose bytes are partially
    # committed before the connection dies (one-shot per session so a
    # resumed upload can make progress past it).
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


class _UploadSession:
    """One resumable-upload session: an append-only buffer plus the
    committed watermark and one-shot fault state. The store's
    finalize is IDEMPOTENT (the result meta is cached on the session) so
    a finalize retried after a lost response never double-commits — the
    correctness anchor for ``ifGenerationMatch`` retries."""

    __slots__ = ("uid", "name", "if_generation_match", "buf", "final_meta",
                 "stall_rolled", "reset_done")

    def __init__(self, uid: str, name: str, if_generation_match):
        self.uid = uid
        self.name = name
        self.if_generation_match = if_generation_match
        self.buf = bytearray()
        self.final_meta: Optional[ObjectMeta] = None
        self.stall_rolled = False
        self.reset_done = False


class _FakeWriter:
    """ObjectWriter over the backend's in-process session store."""

    def __init__(self, backend: "FakeBackend", uid: str):
        self._backend = backend
        self._uid = uid
        self.offset = 0

    def write(self, data) -> int:
        self.offset = self._backend.upload_append(
            self._uid, self.offset, data
        )
        return self.offset

    def committed(self) -> int:
        self.offset = self._backend.upload_committed(self._uid)
        return self.offset

    def finalize(self) -> ObjectMeta:
        return self._backend.finalize_upload(self._uid, total=self.offset)

    def abort(self) -> None:
        self._backend.abort_upload(self._uid)


class FakeBackend:
    """Thread-safe in-memory store. Objects created explicitly via ``write``
    or lazily from :func:`deterministic_bytes` via ``prepopulated``.

    Also carries the resumable-upload SESSION STORE (begin/append/
    committed/finalize/abort) that the fake servers translate wire
    requests onto — one semantics definition (offsets, preconditions,
    idempotent finalize, upload-side faults) the h1.1, h2 and gRPC
    surfaces cannot drift apart on."""

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
        # Resumable-upload sessions (upload_id -> _UploadSession).
        self._uploads: dict[str, _UploadSession] = {}
        self._upload_seq = 0
        self.upload_parts = 0  # committed part appends (tests)

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

    def _check_generation(self, name: str, want: Optional[int]) -> None:
        """Precondition check under self._lock: ``want`` = 0 means the
        object must not exist; N means the current generation must be N.
        Mismatch is the GCS 412 — non-transient, so an idempotent retry
        layer never hammers a lost precondition."""
        if want is None:
            return
        current = self._generation.get(name, 0)
        if current != want:
            raise StorageError(
                f"ifGenerationMatch={want} does not match current "
                f"generation {current} of {name!r}",
                transient=False, code=412,
            )

    def write(self, name: str, data: bytes,
              if_generation_match: Optional[int] = None) -> ObjectMeta:
        arr = np.frombuffer(bytes(data), dtype=np.uint8).copy()
        with self._lock:
            self._check_generation(name, if_generation_match)
            self._objects[name] = arr
            self._generation[name] = self._generation.get(name, 0) + 1
            return ObjectMeta(name, len(arr), self._generation[name])

    # -------------------------------------------------- resumable uploads --
    def open_write(self, name: str,
                   if_generation_match: Optional[int] = None) -> _FakeWriter:
        return _FakeWriter(self, self.begin_upload(name, if_generation_match))

    def begin_upload(self, name: str,
                     if_generation_match: Optional[int] = None) -> str:
        with self._lock:
            self._upload_seq += 1
            uid = f"upload-{self._upload_seq}"
            self._uploads[uid] = _UploadSession(uid, name, if_generation_match)
            return uid

    def _session(self, uid: str) -> _UploadSession:
        s = self._uploads.get(uid)
        if s is None:
            raise StorageError(
                f"unknown upload session {uid!r}", transient=False, code=404
            )
        return s

    def upload_committed(self, uid: str) -> int:
        with self._lock:
            return len(self._session(uid).buf)

    def upload_append(self, uid: str, offset: int, data) -> int:
        """Append one content-range part at ``offset``; returns the new
        committed offset. Offsets BEHIND the watermark are an idempotent
        resend (the already-committed prefix is skipped); offsets ahead
        of it are a client bug (400). Upload-side faults (503s, one
        mid-upload stall, the commit-a-prefix-then-reset shape) fire
        here so the in-process backend and both wire servers share one
        fault surface."""
        mv = memoryview(data).cast("B") if not isinstance(
            data, memoryview
        ) else data.cast("B")
        plan = self.fault.at()
        with self._lock:
            s = self._session(uid)
            if s.final_meta is not None:
                raise StorageError(
                    f"upload {uid} already finalized", transient=False,
                    code=400,
                )
            committed = len(s.buf)
            stall = 0.0
            if (plan.upload_stall_s > 0 and not s.stall_rolled):
                s.stall_rolled = True
                with self._rng_lock:
                    roll = self._rng.random()
                if plan.upload_stall_rate >= 1.0 or roll < plan.upload_stall_rate:
                    stall = plan.upload_stall_s
        if stall:
            time.sleep(stall)
        if plan.upload_error_rate:
            with self._rng_lock:
                r = self._rng.random()
            if r < plan.upload_error_rate:
                self.injected_errors += 1
                raise StorageError(
                    "injected upload part failure", transient=True, code=503
                )
        with self._lock:
            s = self._session(uid)
            committed = len(s.buf)
            if offset > committed:
                raise StorageError(
                    f"upload {uid}: part offset {offset} ahead of "
                    f"committed {committed}", transient=False, code=400,
                )
            part = mv[committed - offset:] if offset < committed else mv
            if len(part) == 0:
                return committed
            if (
                plan.upload_reset_after_bytes and not s.reset_done
                and committed + len(part) > plan.upload_reset_after_bytes
            ):
                # Truncate-then-reset: commit only the prefix up to the
                # threshold, then die — the partially-committed part a
                # resume must re-probe (308 Range) and finish. One-shot
                # per session so the resumed upload makes progress.
                s.reset_done = True
                keep = max(0, plan.upload_reset_after_bytes - committed)
                s.buf += part[:keep]
                self.injected_errors += 1
                raise StorageError(
                    "injected upload reset mid-part", transient=True,
                    code=104,
                )
            s.buf += part
            self.upload_parts += 1
            return len(s.buf)

    def finalize_upload(self, uid: str,
                        total: Optional[int] = None) -> ObjectMeta:
        """Complete the session (idempotent: a finalize retried after a
        lost response returns the cached meta). The ``ifGenerationMatch``
        precondition is checked HERE — at commit time, like GCS — and a
        mismatch is the non-transient 412."""
        with self._lock:
            s = self._session(uid)
            if s.final_meta is not None:
                return s.final_meta
            if total is not None and total != len(s.buf):
                raise StorageError(
                    f"upload {uid}: declared total {total} != committed "
                    f"{len(s.buf)}", transient=False, code=400,
                )
            self._check_generation(s.name, s.if_generation_match)
            arr = np.frombuffer(bytes(s.buf), dtype=np.uint8).copy() \
                if s.buf else np.empty(0, dtype=np.uint8)
            self._objects[s.name] = arr
            self._generation[s.name] = self._generation.get(s.name, 0) + 1
            s.final_meta = ObjectMeta(
                s.name, len(arr), self._generation[s.name]
            )
            s.buf = bytearray()  # the store owns the bytes now
            return s.final_meta

    def upload_status(self, uid: str):
        """(committed_bytes, final_meta_or_None) — the resume probe's
        view, and the idempotency check the servers make before
        replaying a part against a finalized session."""
        with self._lock:
            s = self._session(uid)
            return len(s.buf), s.final_meta

    def abort_upload(self, uid: str) -> None:
        with self._lock:
            self._uploads.pop(uid, None)

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

    def delete(self, name: str) -> None:
        with self._lock:
            if name not in self._objects:
                raise StorageError(f"object not found: {name}", transient=False, code=404)
            del self._objects[name]

    def close(self) -> None:
        pass
