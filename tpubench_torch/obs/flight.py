"""Per-read flight recorder: bounded phase timelines with straggler
attribution (the always-on, zero-GCP-dependency observability layer; a
copy of ``tpubench/obs/flight.py`` — its journals are the same format,
and ``tpubench report timeline`` renders the port's).

Each read (and each staging slot / pod-ingest object) becomes one
structured record carrying nanosecond timestamps for the paper's phase
split — ``enqueue``, ``connect``, ``stream_open``, ``first_byte``,
``body_complete``, ``hbm_staged``, ``gather_complete`` — plus retry/fault
annotations. A p99 regression is then attributable: a connection stall
shows up as a fat ``connect``/``first_byte`` segment, a slow
``device_put`` as a fat ``hbm_staged`` segment, and a straggling host as
one row of the straggler table (arXiv:1804.01138 and the Pulsar latency
study both show percentile tails are only actionable decomposed per
phase and per endpoint).

Race-freedom is by the same worker-owned-array construction as
:mod:`tpubench_torch.metrics.recorder`: every worker thread owns a private
bounded ring of records (:class:`WorkerFlight`); rings are merged only
after the workers join. The ring keeps the NEWEST records when it
overflows, so a long run's journal is its recent history, not its
ancient one.

Backends emit connection-level events (connect, stream-open, stale
retries) without any signature change through a thread-local channel:
the workload opens an op (:meth:`WorkerFlight.begin`), which installs
itself as the thread's current op; :func:`note_phase` / :func:`annotate`
called anywhere down-stack (connection pools, retry wrappers) attach to
it, and are free no-ops when no op is active. One worker thread performs
one read at a time, so the channel is race-free by construction.

Journals are plain JSON docs (``format: tpubench-flight-v1``), one per
host (multi-host runs suffix ``.p<process_index>``, the same convention
as the stream snapshot files); :func:`merge_journal_docs` +
:func:`render_timeline` are the pod-level aggregation pass behind
``tpubench report timeline``.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np

from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.obs.tracing import (
    TraceContext,
    adopt_trace,
    current_trace,
    new_span_id,
    new_trace_id,
)

JOURNAL_FORMAT = "tpubench-flight-v1"

# Journal CONTENT schema, stamped into every journal doc as
# ``journal_schema`` (the format string above is the envelope and never
# changes for compatible additions). Bump when a field's meaning changes
# or a consumer-visible field is added: readers warn-once-and-continue
# on a NEWER schema (additions are forward-readable), while
# record/replay — which must rebuild a run faithfully, not just render
# it — refuse journals newer than they understand. History:
#   1 — implicit (journals predating the stamp carry no field)
#   2 — the stamp itself + the serve plane's ``replay`` scenario block
JOURNAL_SCHEMA = 2

# Canonical phase order; segment durations are computed between
# consecutive phases PRESENT in a record and attributed to the later one
# ("time spent reaching first_byte from the previous milestone").
# Pipeline phases: cache_hit/cache_miss stamp a chunk access's
# resolution, prefetch_issue marks a readahead fetch leaving the queue,
# and stall_begin/stall_end bracket a train-ingest step's data wait — so
# `report timeline` attributes stalls (the stall_end segment IS the
# stall duration) the same way it attributes connect/first_byte time.
# Staging phases: the overlapped executor splits a transfer into
# stage_submit (the device_put left the reaper) and stage_complete (the
# bytes LANDED in HBM; hbm_staged is stamped at the same instant) — the
# stage_complete segment IS the transfer's flight time, and with
# out-of-order completion it is the honest per-transfer quantity a
# submit-time stamp would have corrupted.
# Lifecycle phases: a resumable upload stamps upload_open when
# its session opens (before any connection work), part_sent at its first
# committed part (per-part detail rides "part" notes and the part
# latency recorder) and upload_complete at finalize; meta_op stamps an
# open-loop metadata operation's completion (the meta_op segment IS its
# service time, queue wait included).
# Coop phases: a miss routed to a peer owner stamps peer_request
# when the ask leaves, then peer_hit (the owner served — the peer_hit
# segment IS the peer transfer round-trip) or peer_miss (the owner shed;
# the read falls through to origin, so connect/first_byte follow on the
# SAME record). owner_fetch marks an origin read made AS the chunk's
# ring owner (the one fetch pod-wide single-flight permits).
# Drill phases: delta_commit stamps a delta save committing one
# CAS-guarded shard generation (the delta_commit segment IS that
# shard's upload+finalize time under live traffic), and shard_restored
# stamps a restoring joiner completing one shard — all its chunk reads
# landed and the crc verified against the stat-pinned generation (the
# shard_restored segment IS the shard's restore time, contention
# included).
PHASES = (
    "enqueue",
    "cache_hit",
    "cache_miss",
    "prefetch_issue",
    "peer_request",
    "peer_hit",
    "peer_miss",
    "owner_fetch",
    "upload_open",
    "connect",
    "stream_open",
    "first_byte",
    "body_complete",
    "meta_op",
    "part_sent",
    "upload_complete",
    "delta_commit",
    "shard_restored",
    "stall_begin",
    "stall_end",
    "stage_submit",
    "stage_complete",
    "hbm_staged",
    "gather_complete",
)

_tls = threading.local()


def current_op() -> Optional["FlightOp"]:
    return getattr(_tls, "op", None)


def adopt_op(op: Optional["FlightOp"]) -> None:
    """Install ``op`` as THIS thread's current op (None clears it).

    For helper threads doing work on behalf of a read that began on a
    workload thread — the hedged reader's producer threads adopt the
    consumer's op so backend-level phases/annotations (connect,
    first_byte, breaker events) still land on the read's record.
    Appends from two threads interleave but never tear (GIL-atomic
    list/dict ops; first-stamp-wins already governs phase marks).

    Adopting an op also adopts its TRACE position (and None clears
    both): any record the helper thread begins while working for the
    read — a staging-slot transfer completed by the reaper, a nested
    fetch — parents under the read's span in the trace tree."""
    _tls.op = op
    adopt_trace(op.trace_context() if op is not None else None)


def note_phase(phase: str, ns: Optional[int] = None) -> None:
    """Stamp ``phase`` on the calling thread's current op (no-op when no
    op is active — the backends call this unconditionally)."""
    op = getattr(_tls, "op", None)
    if op is not None:
        op.mark(phase, ns)


def annotate(kind: str, **info) -> None:
    """Attach a retry/fault annotation to the current op (no-op when no
    op is active)."""
    op = getattr(_tls, "op", None)
    if op is not None:
        op.note(kind, **info)


class FlightOp:
    """One in-flight read: phase stamps + annotations, appended to the
    owning ring at :meth:`finish`. Context-manager use finishes with the
    exception (if any) recorded as the op's error.

    Every op is also a SPAN in the causal trace plane: it allocates a
    ``span_id``, joins the thread's ambient :class:`TraceContext` (the
    enclosing tracer span, workload step, or in-flight read) as a child
    — or roots a fresh trace when none is active — and, when installed,
    becomes the thread's trace position so nested records parent under
    it. The ids ride the journal record (``trace_id``/``span_id``/
    ``parent_id``), which is what lets ``tpubench report trace`` stitch
    per-host journals into cross-host span trees."""

    __slots__ = ("_ring", "worker", "object", "transport", "kind",
                 "phases", "notes", "bytes", "error", "_done", "_installed",
                 "trace_id", "span_id", "parent_id", "_prev_ctx",
                 "_sampled")

    def __init__(self, ring: "WorkerFlight", object_name: str,
                 transport: str, enqueue_ns: Optional[int] = None,
                 install: bool = True, kind: str = "read"):
        self._ring = ring
        self.worker = ring.name
        self.object = object_name
        self.transport = transport
        # "read": one network read (the straggler tables compare these);
        # "object": a pod-level fetch→stage→gather span; "stage": one
        # staging-slot transfer; "serve": an origin fetch made to answer
        # a peer's request (owner side of a coop hop — excluded from
        # goodput byte credit: the requester's record carries the bytes).
        self.kind = kind
        self.phases: dict[str, int] = {
            "enqueue": enqueue_ns if enqueue_ns is not None
            else time.perf_counter_ns()
        }
        self.notes: list[dict] = []
        self.bytes = 0
        self.error: Optional[str] = None
        self._done = False
        self.span_id = new_span_id()
        ctx = current_trace()
        if ctx is not None:
            self.trace_id = ctx.trace_id
            self.parent_id = ctx.span_id
            # The per-trace sampling decision rides through the op: a
            # tracer span nested under this op (backend client spans)
            # must inherit the ROOT's draw, not re-default to sampled —
            # or an unsampled trace's descendants would record as
            # orphans of spans that were never kept.
            self._sampled = ctx.sampled
        else:
            self.trace_id = new_trace_id()
            self.parent_id = None
            self._sampled = True
        self._prev_ctx = None
        # install=False: side-channel records (e.g. staging-slot records
        # created while a read op is in flight on the same thread) must
        # not displace the thread's current op.
        self._installed = install
        if install:
            _tls.op = self
            self._prev_ctx = ctx
            adopt_trace(self.trace_context())

    def trace_context(self) -> TraceContext:
        """This op's position in the trace tree — what children (nested
        records, helper threads, remote peers) parent under. Carries
        the trace's sampling decision forward."""
        return TraceContext(self.trace_id, self.span_id, self._sampled)

    def mark(self, phase: str, ns: Optional[int] = None) -> None:
        # First stamp wins (e.g. "connect" fires once even when a stale
        # retry reconnects — the retry itself is an annotation). A
        # finished op is immutable: its record is already in the ring,
        # and a straggling helper thread (cancelled hedge loser) must
        # not add out-of-order stamps that would break the journal's
        # monotonicity invariant.
        if self._done or phase in self.phases:
            return
        self.phases[phase] = int(ns if ns else time.perf_counter_ns())

    def note(self, kind: str, **info) -> None:
        if self._done:
            return
        self.notes.append({"kind": kind, "t": time.perf_counter_ns(), **info})

    def abandon(self) -> None:
        """Discard the op WITHOUT appending a record: the work it was
        opened for turned out to be a no-op (e.g. a prefetch pop whose
        chunk a demand read claimed first). A zero-byte ~0 ms record
        would dilute every downstream percentile, so none is written;
        the thread's channel is still released."""
        if self._done:
            return
        self._done = True
        if self._installed and getattr(_tls, "op", None) is self:
            _tls.op = None
            adopt_trace(self._prev_ctx)

    def finish(self, nbytes: int = 0, error: Optional[BaseException] = None
               ) -> None:
        if self._done:
            return
        self._done = True
        if self._installed and getattr(_tls, "op", None) is self:
            _tls.op = None
            adopt_trace(self._prev_ctx)
        self.bytes = int(nbytes)
        if error is not None:
            self.error = f"{type(error).__name__}: {error}"
        rec = {
            "worker": self.worker,
            "object": self.object,
            "transport": self.transport,
            "kind": self.kind,
            "phases": self.phases,
            "bytes": self.bytes,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
        }
        if self.parent_id is not None:
            rec["parent_id"] = self.parent_id
        if self.notes:
            rec["notes"] = self.notes
        if self.error:
            rec["error"] = self.error
        self._ring.append(rec)

    def __enter__(self) -> "FlightOp":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        self.finish(self.bytes, error=exc)
        return False


class WorkerFlight:
    """One worker thread's private bounded record ring (newest kept)."""

    __slots__ = ("name", "capacity", "_buf", "_pos", "total", "tap")

    def __init__(self, name: str, capacity: int,
                 tap: Optional[Callable[[dict], None]] = None):
        self.name = name
        self.capacity = max(1, capacity)
        self._buf: list[dict] = []
        self._pos = 0
        self.total = 0  # appends ever; total - len(buf) = dropped
        # Live-telemetry tap (obs/telemetry.py): called once per appended
        # record, on the appending worker's thread, BEFORE ring overwrite
        # can drop it — so the registry sees every record even when the
        # journal keeps only the newest. Contract: the tap must not
        # raise (the telemetry feeder catches and counts its own
        # errors); None = no live consumer.
        self.tap = tap

    def begin(self, object_name: str, transport: str = "",
              enqueue_ns: Optional[int] = None,
              install: bool = True, kind: str = "read") -> FlightOp:
        return FlightOp(self, object_name, transport, enqueue_ns,
                        install=install, kind=kind)

    def append(self, rec: dict) -> None:
        self.total += 1
        tap = self.tap
        if tap is not None:
            tap(rec)
        if len(self._buf) < self.capacity:
            self._buf.append(rec)
            return
        # Overwrite the OLDEST slot (ring semantics: newest records win).
        self._buf[self._pos] = rec
        self._pos = (self._pos + 1) % self.capacity

    def records(self) -> list[dict]:
        """Oldest→newest copy (safe post-join; mid-run snapshots may miss
        or double-see the record being appended — fine for a flush)."""
        buf = list(self._buf)
        if self.total <= self.capacity:
            return buf
        pos = self._pos % len(buf) if buf else 0
        return buf[pos:] + buf[:pos]


def _is_gz_path(path: str) -> bool:
    """True when the journal path should be written gzip-compressed: a
    bare ``.gz`` suffix OR a per-host ``.gz.p<idx>`` sibling
    (:func:`host_journal_path` appends the process suffix after the
    extension, and the non-zero hosts must honor the compression the
    base path asked for)."""
    base = os.path.basename(path)
    if base.endswith(".gz"):
        return True
    stem, _, tail = base.rpartition(".")
    return tail.startswith("p") and tail[1:].isdigit() and stem.endswith(".gz")


class FlightRecorder:
    """Per-run registry of worker rings + journal/summary rendering."""

    def __init__(self, capacity_per_worker: int = 1024, host: int = 0):
        self.capacity = capacity_per_worker
        self.host = host
        self._workers: dict[str, WorkerFlight] = {}
        self._lock = threading.Lock()
        self._tap: Optional[Callable[[dict], None]] = None
        # Rotation accounting: successive flushes re-serialize the same
        # ring and re-drop the same oldest records, so the cumulative
        # counter only counts records NEWER than the last rotation
        # watermark (each record counted at most once).
        self.rotation_dropped_total = 0
        self._rotation_watermark_ns = -1

    def set_tap(self, tap: Optional[Callable[[dict], None]]) -> None:
        """Install a per-record live consumer on every ring (existing and
        future) — the telemetry registry's feed. The tap runs on the
        appending worker's thread and must not raise."""
        with self._lock:
            self._tap = tap
            for wf in self._workers.values():
                wf.tap = tap

    def activate(self) -> "_Activation":
        """Install as the run's ambient recorder for the scope: layers
        that the workload cannot hand a ring to directly (the staging
        slot pipeline) reach it via :func:`active_worker`."""
        return _Activation(self)

    def worker(self, name: str) -> WorkerFlight:
        """Get-or-create the ring for ``name`` (creation is locked so
        worker threads may call this concurrently; each ring still has
        exactly one appending owner)."""
        with self._lock:
            wf = self._workers.get(name)
            if wf is None:
                wf = self._workers[name] = WorkerFlight(
                    name, self.capacity, tap=self._tap
                )
            return wf

    def records(self) -> list[dict]:
        out: list[dict] = []
        with self._lock:
            rings = list(self._workers.values())
        for wf in rings:
            for r in wf.records():
                if "host" not in r:
                    r["host"] = self.host
                out.append(r)
        out.sort(key=lambda r: r["phases"].get("enqueue", 0))
        return out

    @property
    def dropped(self) -> int:
        with self._lock:
            rings = list(self._workers.values())
        return sum(max(0, wf.total - wf.capacity) for wf in rings)

    def journal(self, extra: Optional[dict] = None) -> dict:
        doc = {
            "format": JOURNAL_FORMAT,
            "journal_schema": JOURNAL_SCHEMA,
            "host": self.host,
            "time": time.time(),
            "dropped": self.dropped,
            "records": self.records(),
        }
        if extra:
            doc.update(extra)
        return doc

    def write_journal(self, path: str, extra: Optional[dict] = None,
                      max_bytes: int = 0) -> str:
        """Atomic per-host journal write (same torn-JSON-proof discipline
        as SnapshotWriter). A ``.gz`` path writes gzip-compressed (so do
        its ``.gz.p<idx>`` per-host siblings);
        ``max_bytes`` > 0 bounds the SERIALIZED doc size by dropping the
        oldest records (counted in the doc's ``rotation_dropped``) — the
        disk-safety valve for long runs streaming journals every tick."""
        doc = self.journal(extra)
        payload = json.dumps(doc)
        self.last_rotation_dropped = 0
        if max_bytes > 0 and len(payload) > max_bytes:
            records = doc["records"]
            # Records are sorted oldest-first; drop from the front until
            # the doc fits (per-record sizes include the separator).
            over = len(payload) - max_bytes
            dropped = 0
            fresh = 0
            while records and over > 0:
                rec = records[0]
                over -= len(json.dumps(rec)) + 2
                del records[0]
                dropped += 1
                enq = rec["phases"].get("enqueue", 0)
                if enq > self._rotation_watermark_ns:
                    fresh += 1
                    self._rotation_watermark_ns = enq
            doc["rotation_dropped"] = dropped
            self.last_rotation_dropped = dropped
            self.rotation_dropped_total += fresh
            payload = json.dumps(doc)
        tmp = f"{path}.tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if _is_gz_path(path):
            with gzip.open(tmp, "wt", encoding="utf-8") as f:
                f.write(payload)
        else:
            with open(tmp, "w") as f:
                f.write(payload)
        os.replace(tmp, path)
        return path

    def summary(self) -> dict:
        """The RunResult stamp: per-phase p50/p99 + straggler attribution
        over this host's records."""
        return timeline_summary(self.records())


_active: Optional[FlightRecorder] = None


class _Activation:
    __slots__ = ("_rec", "_prev")

    def __init__(self, rec: FlightRecorder):
        self._rec = rec
        self._prev: Optional[FlightRecorder] = None

    def __enter__(self) -> FlightRecorder:
        global _active
        self._prev = _active
        _active = self._rec
        return self._rec

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._prev


def active_worker(name: str) -> Optional[WorkerFlight]:
    """Ring on the run's ambient recorder, or None outside any
    activation — the staging pipeline's zero-config hookup."""
    rec = _active
    return rec.worker(name) if rec is not None else None


def host_journal_path(path: str, process_index: int,
                      process_count: int) -> str:
    """Per-host journal file: process 0 keeps the bare path (single-host
    unchanged), others suffix ``.p<idx>`` — the stream-snapshot
    convention, so one glob collects the pod."""
    if process_count <= 1 or process_index == 0:
        return path
    return f"{path}.p{process_index}"


def rank_journal_path(cfg) -> str:
    """This process's journal file for ``cfg.obs.flight_journal``:
    :func:`host_journal_path` by its global rank (``launch.member``), so
    the L ranks a host launches never share one file."""
    from tpubench_torch.dist.launch import member

    m = member(cfg.dist)
    return host_journal_path(cfg.obs.flight_journal, m.rank, m.world)


def flight_from_config(cfg) -> Optional[FlightRecorder]:
    """Recorder per ObservabilityConfig: ``flight_records`` is the
    per-worker ring capacity (0 disables the layer entirely); its host is
    the process's global rank."""
    from tpubench_torch.dist.launch import member

    cap = getattr(cfg.obs, "flight_records", 0)
    if cap <= 0:
        return None
    return FlightRecorder(
        capacity_per_worker=cap, host=member(cfg.dist).rank
    )


def transport_label(cfg) -> str:
    """One stable per-record transport tag (protocol + receive path)."""
    t = cfg.transport
    label = t.protocol
    if t.http2:
        label += "+h2"
    elif t.native_receive:
        label += "+native"
    return label


# ------------------------------------------------------------ analysis ----

def phase_segments(rec: dict) -> dict[str, int]:
    """Segment durations (ns) between consecutive present phases,
    attributed to the later phase, plus ``total`` (last - enqueue)."""
    ph = rec.get("phases", {})
    present = [(p, ph[p]) for p in PHASES if p in ph]
    out: dict[str, int] = {}
    for (_, t0), (p1, t1) in zip(present, present[1:]):
        out[p1] = t1 - t0
    if len(present) >= 2:
        out["total"] = present[-1][1] - present[0][1]
    return out


def monotone(rec: dict) -> bool:
    """True when the record's present phases are in non-decreasing
    timestamp order (the journal invariant the acceptance pins)."""
    ph = rec.get("phases", {})
    ts = [ph[p] for p in PHASES if p in ph]
    return all(a <= b for a, b in zip(ts, ts[1:]))


def _phase_stats(records: Iterable[dict]) -> dict[str, dict]:
    segs: dict[str, list[int]] = {}
    for rec in records:
        for name, dur in phase_segments(rec).items():
            segs.setdefault(name, []).append(dur)
    order = list(PHASES[1:]) + ["total"]
    out: dict[str, dict] = {}
    for name in order:
        vals = segs.get(name)
        if not vals:
            continue
        s = summarize_ns(np.asarray(vals, dtype=np.int64))
        out[name] = {
            "count": s.count,
            "p50_ms": s.p50_ms,
            "p99_ms": s.p99_ms,
        }
    return out


def straggler_attribution(records: list[dict], by: str = "host"
                          ) -> list[dict]:
    """Per-``by`` (host/worker/transport) tail ownership over completed
    records: who owns the slow tail of the total-read latency.

    ``tail_share`` is the fraction of the run's slowest-decile reads
    owned by the group — an injected per-host delay puts that host's
    share near 1.0. Rows sort slowest-p99 first, so row 0 IS the
    straggler. Only "read"-kind records compete (pod-level object spans
    and staging-slot records measure different quantities and would
    dominate the tail by construction); when a journal has no read
    records at all, everything competes."""
    pool = [r for r in records if r.get("kind", "read") == "read"]
    if not pool:
        pool = records
    totals: list[tuple[object, int]] = []
    for rec in pool:
        seg = phase_segments(rec)
        if "total" in seg and not rec.get("error"):
            totals.append((rec.get(by, "?"), seg["total"]))
    if not totals:
        return []
    durs = np.asarray([t for _, t in totals], dtype=np.int64)
    # Slowest decile (at least one read) defines "the tail".
    k = max(1, len(durs) // 10)
    tail_cut = np.sort(durs)[-k]
    tail_total = int((durs >= tail_cut).sum())
    rows = []
    for key in sorted({g for g, _ in totals}, key=str):
        mine = np.asarray([t for g, t in totals if g == key], dtype=np.int64)
        s = summarize_ns(mine)
        rows.append({
            by: key,
            "count": int(mine.size),
            "p50_ms": s.p50_ms,
            "p99_ms": s.p99_ms,
            "tail_share": float((mine >= tail_cut).sum() / tail_total),
        })
    rows.sort(key=lambda r: (-r["p99_ms"], str(r[by])))
    return rows


def record_span_ns(rec: dict) -> tuple[Optional[int], Optional[int]]:
    """(first, last) phase timestamps of a record, or (None, None) when
    it carries no phases."""
    ph = rec.get("phases", {})
    ts = [ph[p] for p in PHASES if p in ph]
    if not ts:
        return None, None
    return min(ts), max(ts)


def goodput_summary(records: list[dict]) -> dict:
    """Journal goodput: delivered bytes over the records' observed wall
    span, per host (perf_counter timestamps are host-relative, so spans
    never mix hosts) and summed pod-wide.

    Byte credit follows the scorecard discipline: ``step`` records carry
    a train-ingest run's consumed bytes (each chunk counted once per
    step); without steps, ``read``-kind records' owner-credited bytes
    are the goodput. THIS is the formula the live telemetry registry
    computes incrementally — ``tpubench top``, the ``/snapshot``
    endpoint and ``report timeline`` must agree because they share it.
    """
    per_host: dict = {}
    for rec in records:
        t0, t1 = record_span_ns(rec)
        if t0 is None:
            continue
        h = per_host.setdefault(rec.get("host", 0), {
            "t0": t0, "t1": t1, "read_bytes": 0, "step_bytes": 0,
            "steps": 0,
        })
        h["t0"] = min(h["t0"], t0)
        h["t1"] = max(h["t1"], t1)
        kind = rec.get("kind", "read")
        if kind == "step":
            h["steps"] += 1
            h["step_bytes"] += rec.get("bytes", 0)
        elif kind == "read" and not rec.get("error"):
            h["read_bytes"] += rec.get("bytes", 0)
    hosts = {}
    total_bytes = 0
    total_gbps = 0.0
    for host, h in sorted(per_host.items(), key=lambda kv: str(kv[0])):
        nbytes = h["step_bytes"] if h["steps"] else h["read_bytes"]
        wall_s = (h["t1"] - h["t0"]) / 1e9
        gbps = (nbytes / 1e9) / wall_s if wall_s > 0 else 0.0
        hosts[host] = {"bytes": nbytes, "wall_s": wall_s, "gbps": gbps}
        total_bytes += nbytes
        total_gbps += gbps
    return {"bytes": total_bytes, "gbps": total_gbps, "hosts": hosts}


def timeline_summary(records: list[dict]) -> dict:
    """Journal → {phases: per-segment p50/p99, stragglers, counts}."""
    errors = sum(1 for r in records if r.get("error"))
    notes = [n for r in records for n in r.get("notes", ())]
    retries = sum(1 for n in notes if n.get("kind") == "retry")
    # Tail-tolerance attribution (storage/tail.py): every hedge launch/
    # win/loss, watchdog stall and breaker transition is a note on the
    # read it happened to, so the timeline can say WHICH reads the
    # resilience machinery touched.
    tail = {
        "hedges": sum(
            1 for n in notes
            if n.get("kind") == "hedge" and n.get("event") == "launch"
        ),
        "hedge_wins": sum(
            1 for n in notes
            if n.get("kind") == "hedge" and n.get("event") == "win"
        ),
        "stalls": sum(1 for n in notes if n.get("kind") == "stall"),
        "breaker_events": sum(1 for n in notes if n.get("kind") == "breaker"),
    }
    # Autotuner attribution (tpubench/tune/): each controller decision is
    # a kind="tune" record carrying a tune note, so the timeline can say
    # when the operating point moved (and which windows accepted vs
    # reverted) next to the reads those windows measured.
    tune_notes = [n for n in notes if n.get("kind") == "tune"]
    tune = {
        "decisions": len(tune_notes),
        "accepts": sum(1 for n in tune_notes if n.get("verdict") == "accept"),
        "reverts": sum(
            1 for n in tune_notes
            if str(n.get("verdict", "")).startswith("revert")
        ),
    }
    # Ingest-pipeline attribution: step records carry
    # stall_begin/stall_end only when the step actually waited for data,
    # so the stalled-step count and the stall_end segment stats below ARE
    # the timeline's data-stall story; chunk records carry their cache
    # resolution (hit/miss/prefetch) as phases.
    steps = [r for r in records if r.get("kind") == "step"]
    pipeline = {
        "steps": len(steps),
        # Any step that waited on data at all (has the stall phases).
        # Deliberately NOT named "stalled_steps": the scorecard's
        # stalled-step count applies stall_threshold_ms, which the
        # journal doesn't carry — two different quantities must not
        # share a name.
        "steps_with_data_wait": sum(
            1 for r in steps if "stall_end" in r.get("phases", {})
        ),
        "cache_hits": sum(
            1 for r in records if "cache_hit" in r.get("phases", {})
        ),
        "cache_misses": sum(
            1 for r in records if "cache_miss" in r.get("phases", {})
        ),
        "prefetch_issues": sum(
            1 for r in records if "prefetch_issue" in r.get("phases", {})
        ),
        # Slab-pool pressure (tpubench/mem/): a read that had to lease an
        # overflow slab notes it — sustained overflow here means the pool
        # is undersized for the working set (raise --pool-slabs).
        "slab_overflows": sum(
            1 for n in notes
            if n.get("kind") == "slab" and n.get("event") == "overflow"
        ),
    }
    # Cooperative-cache attribution: a peer-routed miss carries
    # peer_request plus its resolution (peer_hit = the transfer landed;
    # peer_miss = the owner shed and origin served the same record);
    # owner_fetch marks the one origin read pod-wide single-flight
    # permits. Demotion/restore decisions are kind="coop" records with a
    # coop note, so the timeline can say when the ring rebalanced.
    peer_hit_recs = [
        r for r in records if "peer_hit" in r.get("phases", {})
    ]
    coop_notes = [n for n in notes if n.get("kind") == "coop"]
    coop = {
        "peer_requests": sum(
            1 for r in records if "peer_request" in r.get("phases", {})
        ),
        "peer_transfers": len(peer_hit_recs),
        "peer_bytes": sum(
            r.get("bytes", 0) for r in peer_hit_recs if not r.get("error")
        ),
        "peer_misses": sum(
            1 for r in records if "peer_miss" in r.get("phases", {})
        ),
        "owner_fetches": sum(
            1 for r in records if "owner_fetch" in r.get("phases", {})
        ),
        "demotions": sum(
            1 for n in coop_notes if n.get("event") == "demote"
        ),
        "restores": sum(
            1 for n in coop_notes if n.get("event") == "restore"
        ),
    }
    # Overlapped-staging attribution: every host→HBM transfer is a
    # kind="stage" record whose stage_submit→stage_complete segment is
    # its flight time, stamped at true completion by the window's reaper
    # — so the timeline can say how many transfers ran and how many
    # overlapped-submit records the journal carries.
    stage_recs = [r for r in records if r.get("kind") == "stage"]
    staging = {
        "transfers": len(stage_recs),
        "transfer_bytes": sum(r.get("bytes", 0) for r in stage_recs),
        # Window transfers carry an explicit overlap note; the serial
        # inline ring stamps stage_submit too, so phase presence alone
        # cannot discriminate overlapped from synchronous transfers.
        "overlapped": sum(
            1 for r in stage_recs
            if any(
                n.get("kind") == "stage" and n.get("event") == "overlap"
                for n in r.get("notes", ())
            )
        ),
    }
    # Serve-plane attribution (the open-loop traffic workload): every
    # resolved request notes its outcome (`serve_req`) and every
    # admission-control drop notes `shed` — the timeline can say how
    # much offered load the run absorbed vs refused, per journal.
    # Elastic-membership attribution: every pod-view transition is a
    # kind="member" record carrying a member note (epoch, action, host;
    # the cooperative handoff's byte accounting rides an action=handoff
    # note under the same kind) — the timeline can say when, and how
    # violently, the pod changed shape.
    member_notes = [n for n in notes if n.get("kind") == "member"]
    membership = {
        "events": sum(
            1 for n in member_notes if n.get("action") != "handoff"
        ),
        "by_action": {},
        "handoff_chunks": sum(
            n.get("handoff_chunks", 0) for n in member_notes
        ),
        "handoff_bytes": sum(
            n.get("handoff_bytes", 0) for n in member_notes
        ),
        "last_epoch": max(
            (n.get("epoch", 0) for n in member_notes), default=0
        ),
    }
    for n in member_notes:
        a = n.get("action")
        if a and a != "handoff":
            membership["by_action"][a] = (
                membership["by_action"].get(a, 0) + 1
            )
    serve_notes = [n for n in notes if n.get("kind") == "serve_req"]
    serve = {
        "requests": len(serve_notes),
        "shed": sum(1 for n in notes if n.get("kind") == "shed"),
        "deadline_misses": sum(
            1 for n in serve_notes
            if n.get("outcome") == "completed"
            and n.get("deadline_met") is False
        ),
    }
    return {
        "records": len(records),
        "errors": errors,
        "retries": retries,
        "tail": tail,
        "tune": tune,
        "pipeline": pipeline,
        "coop": coop,
        "membership": membership,
        "staging": staging,
        "serve": serve,
        "goodput": goodput_summary(records),
        "hosts": sorted({r.get("host", 0) for r in records}),
        "phases": _phase_stats(records),
        "stragglers": {
            "by_host": straggler_attribution(records, by="host"),
            "by_worker": straggler_attribution(records, by="worker"),
        },
    }


def merge_journal_docs(docs: Iterable[dict]) -> list[dict]:
    """Pod-level merge: per-host journal docs → one record list, each
    record carrying its host (doc-level host stamped onto records that
    predate the per-record stamp)."""
    out: list[dict] = []
    for doc in docs:
        host = doc.get("host", 0)
        for rec in doc.get("records", ()):
            if "host" not in rec:
                rec = {**rec, "host": host}
            out.append(rec)
    out.sort(key=lambda r: r["phases"].get("enqueue", 0))
    return out


def render_timeline(docs: list[dict]) -> str:
    """The ``tpubench report timeline`` body: per-phase p50/p99 block +
    straggler tables over the merged journals."""
    records = merge_journal_docs(docs)
    summ = timeline_summary(records)
    dropped = sum(int(d.get("dropped", 0)) for d in docs)
    lines = [
        f"== flight timeline: {summ['records']} records, "
        f"{len(docs)} journal(s), hosts={summ['hosts']} "
        f"errors={summ['errors']} retries={summ['retries']}"
        + (f" dropped={dropped}" if dropped else "")
        + " ==",
    ]
    if not records:
        lines.append("  (no records)")
        return "\n".join(lines)
    gp = summ.get("goodput", {})
    if gp.get("bytes"):
        lines.append(
            f"goodput: {gp['gbps']:.4f} GB/s over {gp['bytes']} bytes "
            f"({len(gp.get('hosts', {}))} host(s))"
        )
    tail = summ.get("tail", {})
    if any(tail.values()):
        lines.append(
            f"tail events: hedges={tail['hedges']} "
            f"(wins={tail['hedge_wins']}) stalls={tail['stalls']} "
            f"breaker={tail['breaker_events']}"
        )
    tn = summ.get("tune", {})
    if tn.get("decisions"):
        lines.append(
            f"tune decisions: {tn['decisions']} "
            f"(accepts={tn['accepts']} reverts={tn['reverts']})"
        )
    pipe = summ.get("pipeline", {})
    if any(pipe.values()):
        lines.append(
            f"pipeline: steps={pipe['steps']} "
            f"(with_data_wait={pipe['steps_with_data_wait']}) "
            f"cache_hits={pipe['cache_hits']} "
            f"cache_misses={pipe['cache_misses']} "
            f"prefetch_issues={pipe['prefetch_issues']}"
            + (
                f" slab_overflows={pipe['slab_overflows']}"
                if pipe.get("slab_overflows") else ""
            )
        )
    coop = summ.get("coop", {})
    if any(coop.values()):
        lines.append(
            f"coop: peer_transfers={coop['peer_transfers']} "
            f"bytes={coop['peer_bytes']} "
            f"(requests={coop['peer_requests']} "
            f"misses={coop['peer_misses']}) "
            f"owner_fetches={coop['owner_fetches']} "
            f"demotions={coop['demotions']} restores={coop['restores']}"
        )
    mem = summ.get("membership", {})
    if mem.get("events"):
        by = " ".join(
            f"{a}={n}" for a, n in sorted(mem["by_action"].items())
        )
        lines.append(
            f"membership: events={mem['events']} ({by}) "
            f"epoch={mem['last_epoch']} "
            f"handoff={mem['handoff_chunks']} chunks/"
            f"{mem['handoff_bytes']}B"
        )
    srv = summ.get("serve", {})
    if srv.get("requests") or srv.get("shed"):
        lines.append(
            f"serve: requests={srv['requests']} shed={srv['shed']} "
            f"deadline_misses={srv['deadline_misses']}"
        )
    stg = summ.get("staging", {})
    if stg.get("transfers"):
        lines.append(
            f"staging: transfers={stg['transfers']} "
            f"bytes={stg['transfer_bytes']} "
            f"overlapped={stg['overlapped']}"
        )
    lines.append("phase segments (ms):")
    for name, s in summ["phases"].items():
        lines.append(
            f"  {name:<16} n={s['count']:<6} p50={s['p50_ms']:9.3f}  "
            f"p99={s['p99_ms']:9.3f}"
        )
    for by in ("host", "worker"):
        rows = summ["stragglers"][f"by_{by}"]
        if len(rows) < 2:
            continue
        lines.append(f"stragglers by {by} (slowest p99 first):")
        for r in rows:
            lines.append(
                f"  {by}={r[by]!s:<12} n={r['count']:<6} "
                f"p50={r['p50_ms']:9.3f}  p99={r['p99_ms']:9.3f}  "
                f"tail_share={r['tail_share']:.2f}"
            )
        top = rows[0]
        lines.append(
            f"  -> straggler: {by}={top[by]} "
            f"(p99 {top['p99_ms']:.3f} ms, owns "
            f"{top['tail_share']:.0%} of the slowest decile)"
        )
    return "\n".join(lines)


def read_journal_text(path: str) -> str:
    """Raw journal text, decompressing gzip transparently (detected by
    magic bytes, not the filename — a rotated/renamed .gz still reads).
    A truncated gzip stream raises like truncated JSON parses: callers
    treat both as a partial file."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw.decode("utf-8", errors="replace")


# journal_schema values already warned about (once per process, not per
# file: a 40-host pod's journals are one upgrade notice, not 40).
_SCHEMA_WARNED: set = set()


def load_journals(paths: Iterable[str]) -> list[dict]:
    """Load journal docs, degrading gracefully on partial files: an empty
    or truncated journal (a run died mid-flush, or the stream writer was
    killed between SnapshotWriter flushes) is SKIPPED with a one-line
    warning instead of a traceback — one dead host must not make the
    pod's other journals unreadable. Gzip journals (``.gz``) decompress
    transparently. A well-formed JSON doc that is not a flight journal
    is still a hard error (wrong file, not a partial one)."""
    import sys

    docs = []
    for p in paths:
        try:
            raw = read_journal_text(p)
        except (OSError, EOFError, gzip.BadGzipFile) as e:
            print(
                f"warning: {p}: unreadable flight journal ({e}), skipped",
                file=sys.stderr,
            )
            continue
        if not raw.strip():
            print(f"warning: {p}: empty flight journal, skipped",
                  file=sys.stderr)
            continue
        try:
            doc = json.loads(raw)
        except json.JSONDecodeError as e:
            print(
                f"warning: {p}: truncated/partial flight journal "
                f"({e.msg} at char {e.pos}), skipped",
                file=sys.stderr,
            )
            continue
        if doc.get("format") != JOURNAL_FORMAT:
            raise ValueError(
                f"{p}: not a flight journal (format="
                f"{doc.get('format')!r}; expected {JOURNAL_FORMAT!r})"
            )
        schema = doc.get("journal_schema", 1)
        if isinstance(schema, int) and schema > JOURNAL_SCHEMA \
                and schema not in _SCHEMA_WARNED:
            # Warn ONCE per unknown schema, then render what we can:
            # schema bumps are additive for rendering consumers (report
            # timeline/trace, top), so continuing beats refusing — only
            # record/replay, which must rebuild a run faithfully, hard-
            # refuse newer journals (replay/bundle.py).
            _SCHEMA_WARNED.add(schema)
            print(
                f"warning: {p}: journal_schema {schema} is newer than "
                f"this build understands ({JOURNAL_SCHEMA}); rendering "
                "the fields it knows",
                file=sys.stderr,
            )
        docs.append(doc)
    return docs
