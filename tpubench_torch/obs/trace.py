"""Causal trace plane: journals → cross-host span trees, and flight
records → OTLP trace payloads (a copy of ``tpubench/obs/trace.py``; the
same journals give the same report text in both packages).

The flight recorder stamps every record with ``trace_id``/``span_id``/
``parent_id`` (:mod:`tpubench_torch.obs.flight`), and the propagation
layer (:mod:`tpubench_torch.obs.tracing`) threads one :class:`TraceContext`
through tracer spans, workload steps, the tail stack's helper threads and
the staging reaper. This module is the MERGE side:

* :func:`assemble_traces` — merged journal records → span trees. Each
  record is a span node; its phase timeline is decomposed into
  SYNTHESIZED child spans (one per phase segment, ids derived with
  :func:`~tpubench_torch.obs.tracing.derive_span_id` so both sides of a
  cross-host hop compute the same id); retry/hedge annotations become
  annotation child spans (a retry's span covers its backoff pause, a
  hedge leg runs launch→verdict).
* :func:`tail_sample` — per-TRACE tail-based sampling: keep full trees
  only for the slowest ``slow_fraction`` plus an unbiased head sample (a
  deterministic hash of the trace id — the same trace keeps or drops on
  every host and every re-run), memory-bounded by ``max_keep``.
* :func:`critical_path` / :func:`blame_table` — per-trace dominant-child
  walk and the pod-wide "p99 blame" rollup: which span owned the wall
  time of the slowest-decile reads.
* :func:`render_trace_report` — the ``report trace`` body.
* :func:`otlp_trace_payload` — OTLP/HTTP-JSON ``resourceSpans`` shape over
  the records (dry-run capture or POST via
  :class:`~tpubench_torch.obs.exporters.OTLPTraceExporter`).

Clock honesty: phase timestamps are ``perf_counter`` nanoseconds —
host-relative. Tree STRUCTURE stitches across hosts by ids; DURATIONS
are compared (both are ns), but a child's position is never placed on
the parent host's absolute timeline.
"""

from __future__ import annotations

from typing import Iterable, Optional

from tpubench_torch.obs.flight import PHASES, merge_journal_docs
from tpubench_torch.obs.tracing import derive_span_id

# ------------------------------------------------------------- catalog ------

# Every span KIND the trace plane emits (flight-record kinds) → meaning,
# the reference's catalog: journals of either package use these kinds.
# Every phase of PHASES is a synthesized child-span name and has its help
# here (span_catalog raises KeyError otherwise).
SPAN_KINDS = {
    "read": "one network read (demand or prefetch)",
    "step": "one train-ingest step (stall window bracketed)",
    "stage": "one host-to-HBM staging transfer (reaper-completed)",
    "object": "one pod-level fetch-stage-gather object span",
    "cache": "one chunk-cache access resolution (hit records)",
    "serve": "an origin fetch made to answer a peer's request "
             "(owner side of a cross-host coop hop)",
    "coop": "a cooperative-cache ring decision (demote/restore)",
    "member": "an elastic-membership transition (join/leave/fail/"
              "pause/resume — epoch-numbered pod view changes) or its "
              "warm-handoff byte accounting",
    "tune": "one autotuner decision window",
    "upload": "one resumable object upload (ckpt-save: session open "
              "to finalize; per-part detail rides its notes)",
    "meta": "one open-loop metadata operation (meta-storm "
            "list/stat/open)",
    "fleet": "one virtual-time fleet simulation (tpubench fleet: "
             "simulated topology + virtual-vs-real wall accounting "
             "rides its note)",
}

# Annotation kinds synthesized into child spans (notes with a duration
# story: a retry covers its backoff pause, a hedge leg runs from launch
# to its win/lose verdict).
NOTE_SPANS = {
    "retry": "one retry/resume attempt (span covers the backoff pause)",
    "hedge": "one hedged-read leg (launch to win/lose verdict)",
    "grpc_frame": "one gRPC wire event on a client call — stream open, "
                  "message sent, or message received (point span)",
    "bidi_ack": "one BidiWriteObject persisted-size ack — the server's "
                "committed state after a lockstep flush (point span)",
}

_PHASE_HELP = {
    "enqueue": "the read left the workload queue",
    "cache_hit": "chunk resolved from the local cache",
    "cache_miss": "chunk missed the local cache",
    "prefetch_issue": "readahead fetch left the prefetch queue",
    "peer_request": "miss routed to the chunk's peer owner",
    "peer_hit": "owner served the chunk (peer round-trip)",
    "peer_miss": "owner shed; the read fell through to origin",
    "owner_fetch": "origin read made as the chunk's ring owner",
    "upload_open": "resumable upload session opened",
    "connect": "connection establishment",
    "stream_open": "request stream opened",
    "first_byte": "time to first payload byte",
    "body_complete": "payload fully delivered",
    "meta_op": "metadata operation completed (service time incl. queue)",
    "part_sent": "first upload part committed",
    "upload_complete": "resumable upload finalized",
    "delta_commit": "delta save committed one CAS-guarded shard",
    "shard_restored": "joiner finished restoring one verified shard",
    "stall_begin": "train-ingest step began waiting for data",
    "stall_end": "train-ingest step's data wait ended",
    "stage_submit": "host-to-HBM transfer left the reaper",
    "stage_complete": "transfer bytes landed in HBM (flight time)",
    "hbm_staged": "bytes resident in HBM",
    "gather_complete": "pod gather collective finished",
}


def span_catalog() -> dict[str, str]:
    """name → help for every span the plane can emit: record kinds,
    synthesized phase-segment spans, and annotation spans. The single
    source the README section and the drift guard both walk."""
    cat = dict(SPAN_KINDS)
    for p in PHASES:
        cat[p] = _PHASE_HELP[p]
    cat.update(NOTE_SPANS)
    return cat


# ------------------------------------------------------------ assembly ------


class SpanNode:
    """One assembled span: a flight record, or a synthesized child
    (phase segment / annotation) of one."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "kind",
                 "host", "worker", "start_ns", "end_ns", "bytes", "error",
                 "synth", "children", "record")

    def __init__(self, *, span_id, trace_id, parent_id, name, kind, host,
                 worker="", start_ns=0, end_ns=0, nbytes=0, error=None,
                 synth=False, record=None):
        self.span_id = span_id
        self.trace_id = trace_id
        self.parent_id = parent_id
        self.name = name
        self.kind = kind
        self.host = host
        self.worker = worker
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.bytes = nbytes
        self.error = error
        self.synth = synth
        self.children: list[SpanNode] = []
        self.record = record

    @property
    def duration_ns(self) -> int:
        return max(0, self.end_ns - self.start_ns)

    def label(self) -> str:
        tag = self.name if self.synth else f"{self.kind} {self.name}"
        return f"{tag}"


class Trace:
    """One stitched trace: its root spans (usually one) and rollups."""

    __slots__ = ("trace_id", "roots", "orphans")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.roots: list[SpanNode] = []
        self.orphans: list[SpanNode] = []

    @property
    def duration_ns(self) -> int:
        return max((r.duration_ns for r in self.roots), default=0)

    def span_count(self) -> int:
        # orphans ⊆ roots (an orphan still tops its trace): walking
        # roots alone covers every span exactly once.
        n = 0
        stack = list(self.roots)
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children)
        return n


def _synth_children(node: SpanNode, rec: dict) -> list[SpanNode]:
    """Phase segments + annotation spans of one record, as child nodes
    with deterministic derived ids (the cross-host stitch points)."""
    out: list[SpanNode] = []
    ph = rec.get("phases", {})
    present = [(p, ph[p]) for p in PHASES if p in ph]
    for (p0, t0), (p1, t1) in zip(present, present[1:]):
        # Segment NAMED by its end phase (the "connect" segment is the
        # time it took to connect) but KEYED by its start phase: each
        # phase starts at most one segment, and the propagation side
        # only knows where a hop BEGINS — `_peer_hop_ctx` derives the
        # parent from "peer_request" without knowing whether the
        # round-trip will end at peer_hit or peer_miss, and the id
        # derived here from the same start phase is what the owner
        # host's serve span stitches under.
        out.append(SpanNode(
            span_id=derive_span_id(node.span_id, p0),
            trace_id=node.trace_id, parent_id=node.span_id,
            name=p1, kind=node.kind, host=node.host, worker=node.worker,
            start_ns=t0, end_ns=t1, synth=True,
        ))
    notes = rec.get("notes", ())
    hedge_open: Optional[SpanNode] = None
    idx = 0
    for n in notes:
        nk = n.get("kind")
        t = int(n.get("t", 0))
        if nk == "retry":
            end = t + int(float(n.get("backoff_s", 0.0)) * 1e9)
            out.append(SpanNode(
                span_id=derive_span_id(node.span_id, f"retry#{idx}"),
                trace_id=node.trace_id, parent_id=node.span_id,
                name="retry", kind=node.kind, host=node.host,
                start_ns=t, end_ns=end, synth=True,
            ))
            idx += 1
        elif nk in ("grpc_frame", "bidi_ack"):
            # Point spans: the wire event has no duration story of its
            # own — its value is WHERE it lands on the parent's timeline
            # (ack cadence exposes lockstep stalls in the trace view).
            out.append(SpanNode(
                span_id=derive_span_id(node.span_id, f"{nk}#{idx}"),
                trace_id=node.trace_id, parent_id=node.span_id,
                name=nk, kind=node.kind, host=node.host,
                start_ns=t, end_ns=t, synth=True,
            ))
            idx += 1
        elif nk == "hedge":
            ev = n.get("event")
            if ev == "launch":
                hedge_open = SpanNode(
                    span_id=derive_span_id(node.span_id, f"hedge#{idx}"),
                    trace_id=node.trace_id, parent_id=node.span_id,
                    name="hedge", kind=node.kind, host=node.host,
                    start_ns=t, end_ns=t, synth=True,
                )
                out.append(hedge_open)
                idx += 1
            elif ev in ("win", "lose") and hedge_open is not None:
                hedge_open.end_ns = t
                hedge_open = None
    return out


def _node_from_record(rec: dict, sid: str) -> SpanNode:
    """Record → SpanNode with its span window (min/max phase stamp) —
    the ONE construction both the report-trace assembly and the OTLP
    export use, so their notion of a record's span can never diverge."""
    node = SpanNode(
        span_id=sid, trace_id=rec.get("trace_id", ""),
        parent_id=rec.get("parent_id"), name=rec.get("object", "?"),
        kind=rec.get("kind", "read"), host=rec.get("host", 0),
        worker=rec.get("worker", ""), nbytes=rec.get("bytes", 0),
        error=rec.get("error"), record=rec,
    )
    ph = rec.get("phases", {})
    ts = [ph[p] for p in PHASES if p in ph]
    if ts:
        node.start_ns, node.end_ns = min(ts), max(ts)
    return node


def assemble_traces(records: Iterable[dict]) -> tuple[list[Trace], dict]:
    """Merged records → stitched traces + assembly stats
    (``cross_host_edges``: child spans attached under a parent recorded
    on a DIFFERENT host — the stitch the coop hop exists for;
    ``orphans``: spans whose parent id never appeared, kept as extra
    roots of their trace so nothing is silently dropped)."""
    nodes: list[SpanNode] = []
    index: dict[str, SpanNode] = {}
    for rec in records:
        sid = rec.get("span_id")
        if not sid:
            continue  # pre-trace-plane journal record: nothing to stitch
        node = _node_from_record(rec, sid)
        nodes.append(node)
        index[node.span_id] = node
        for child in _synth_children(node, rec):
            node.children.append(child)
            index[child.span_id] = child
    stats = {"spans": 0, "cross_host_edges": 0, "orphans": 0}
    traces: dict[str, Trace] = {}
    for node in nodes:
        tr = traces.setdefault(node.trace_id, Trace(node.trace_id))
        parent = index.get(node.parent_id) if node.parent_id else None
        if parent is not None:
            parent.children.append(node)
            if parent.host != node.host:
                stats["cross_host_edges"] += 1
        elif node.parent_id:
            # Parent outside the journal — most commonly a TRACER span
            # (read.py opens the op inside the workload span, and tracer
            # spans export through the SDK, not the journal). The record
            # is still its trace's tree top: counted as an orphan for
            # the header, but a ROOT for duration/blame rollups — or a
            # traced run's reads would vanish from the p99 story while
            # an untraced run's identical reads (parentless roots)
            # dominate it.
            stats["orphans"] += 1
            tr.orphans.append(node)
            tr.roots.append(node)
        else:
            tr.roots.append(node)
    out = sorted(traces.values(), key=lambda t: -t.duration_ns)
    stats["spans"] = sum(t.span_count() for t in out)
    stats["traces"] = len(out)
    return out, stats


# ------------------------------------------------------------- sampling -----


def head_sampled(trace_id: str, rate: float) -> bool:
    """Unbiased per-trace head-sample decision: a deterministic function
    of the trace id (no RNG — every host and every re-run agree)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0 or not trace_id:
        return False
    return (int(trace_id[:8] or "0", 16) / 0xFFFFFFFF) < rate


def tail_sample(traces: list[Trace], *, slow_fraction: float = 0.1,
                head_rate: float = 0.05, max_keep: int = 512,
                ) -> tuple[list[Trace], dict]:
    """Tail-based sampling over ASSEMBLED traces: full trees survive for
    the slowest ``slow_fraction`` (at least one) plus the unbiased head
    sample; everything is bounded by ``max_keep`` (slowest win). The
    decision is per-TRACE — a tree is kept or dropped whole, never a
    sampled child under a dropped parent."""
    if not traces:
        return [], {"kept": 0, "slow": 0, "head": 0, "total": 0}
    by_slow = sorted(traces, key=lambda t: -t.duration_ns)
    k = max(1, int(len(by_slow) * slow_fraction))
    slow = by_slow[:k]
    slow_ids = {t.trace_id for t in slow}
    head = [
        t for t in traces
        if t.trace_id not in slow_ids and head_sampled(t.trace_id, head_rate)
    ]
    kept = slow + head
    dropped = 0
    if len(kept) > max_keep:
        kept = sorted(kept, key=lambda t: -t.duration_ns)[:max_keep]
        dropped = len(slow) + len(head) - max_keep
    stats = {
        "total": len(traces), "kept": len(kept), "slow": len(slow),
        "head": len(head), "bound_dropped": dropped,
    }
    return kept, stats


# -------------------------------------------------------- critical path -----


def critical_path(root: SpanNode) -> list[SpanNode]:
    """Dominant-child walk: at every level, descend into the child span
    (synthesized segment or real child record — including one recorded
    on another host) covering the most wall time, while that child
    actually DOMINATES (covers at least half of the current span).
    Unexplained time belongs to the span itself: a 50 ms peer hop whose
    owner-side serve took 0.5 ms terminates at the hop segment, not at
    the serve — the wait was the hop, and blaming its fastest descendant
    would invert the story. The returned path (root excluded) is "what
    actually made this read slow"."""
    path: list[SpanNode] = []
    node = root
    seen = {id(root)}
    while True:
        kids = [c for c in node.children if c.duration_ns > 0
                and id(c) not in seen]
        if not kids:
            return path
        best = max(kids, key=lambda c: c.duration_ns)
        if node.duration_ns > 0 and best.duration_ns * 2 < node.duration_ns:
            return path
        path.append(best)
        seen.add(id(best))
        node = best


def blame_table(traces: list[Trace], *, slow_fraction: float = 0.1
                ) -> list[dict]:
    """The pod-wide "p99 blame" rollup: over the slowest-decile traces,
    group by the critical path's TERMINAL span (the leaf dominator) and
    report how often and how hard each one owned the tail. Rows sort by
    dominated wall time, so row 0 is the pod's p99 story."""
    pool = [t for t in traces if t.roots and t.duration_ns > 0]
    if not pool:
        return []
    pool.sort(key=lambda t: -t.duration_ns)
    k = max(1, int(len(pool) * slow_fraction))
    slow = pool[:k]
    groups: dict[str, dict] = {}
    for t in slow:
        root = max(t.roots, key=lambda r: r.duration_ns)
        path = critical_path(root)
        leaf = path[-1] if path else root
        key = leaf.name if leaf.synth else f"{leaf.kind}:{leaf.name}"
        g = groups.setdefault(key, {
            "span": key, "traces": 0, "dominated_ms": 0.0, "share_sum": 0.0,
        })
        g["traces"] += 1
        g["dominated_ms"] += leaf.duration_ns / 1e6
        g["share_sum"] += (
            leaf.duration_ns / root.duration_ns if root.duration_ns else 0.0
        )
    rows = []
    for g in groups.values():
        rows.append({
            "span": g["span"],
            "traces": g["traces"],
            "trace_share": g["traces"] / len(slow),
            "mean_ms": g["dominated_ms"] / g["traces"],
            "mean_share_of_root": g["share_sum"] / g["traces"],
        })
    rows.sort(key=lambda r: (-r["traces"] * r["mean_ms"], r["span"]))
    return rows


# ------------------------------------------------------------- rendering ----


def _render_node(node: SpanNode, lines: list[str], depth: int,
                 root_host: int) -> None:
    pad = "  " * depth
    dur = node.duration_ns / 1e6
    host = f"[host {node.host}] " if node.host != root_host else ""
    err = f"  ERROR {node.error}" if node.error else ""
    lines.append(f"{pad}{host}{node.label()}  {dur:.3f} ms{err}")
    for c in sorted(node.children, key=lambda c: c.start_ns):
        _render_node(c, lines, depth + 1, node.host)


def render_trace_report(docs: list[dict], *, slow_fraction: float = 0.1,
                        head_rate: float = 0.05, max_keep: int = 512,
                        show: int = 3) -> str:
    """The ``report trace`` body: merge per-host journals,
    assemble span trees, tail-sample, and print the p99 blame table plus
    the slowest ``show`` trees."""
    records = merge_journal_docs(docs)
    traces, astats = assemble_traces(records)
    kept, sstats = tail_sample(
        traces, slow_fraction=slow_fraction, head_rate=head_rate,
        max_keep=max_keep,
    )
    hosts = sorted({r.get("host", 0) for r in records})
    lines = [
        f"== trace report: {astats.get('traces', 0)} traces, "
        f"{astats['spans']} spans over {len(records)} records, "
        f"hosts={hosts} cross_host_edges={astats['cross_host_edges']} "
        f"orphans={astats['orphans']} ==",
    ]
    if not traces:
        lines.append("  (no traceable records — journal predates the "
                     "trace plane, or the flight recorder was off)")
        return "\n".join(lines)
    lines.append(
        f"sampling: kept {sstats['kept']}/{sstats['total']} trees "
        f"(slowest {slow_fraction:.0%} = {sstats['slow']}, head sample "
        f"@ {head_rate:.0%} = {sstats['head']}"
        + (f", bound dropped {sstats['bound_dropped']}"
           if sstats.get("bound_dropped") else "")
        + ")"
    )
    # Blame over the TRUE slowest decile of the whole run, not a decile
    # of the already tail-sampled set (slow_fraction twice over would
    # shrink the "p99 story" to ~1% of traces — or one trace on small
    # runs). tail_sample kept exactly this slow set whole, so selecting
    # it again from `traces` and pooling it all is the honest header.
    slow_k = max(1, int(len(traces) * slow_fraction))
    slow = sorted(traces, key=lambda t: -t.duration_ns)[:slow_k]
    rows = blame_table(slow, slow_fraction=1.0)
    if rows:
        lines.append("p99 blame (slowest decile, by critical-path leaf):")
        for r in rows:
            lines.append(
                f"  {r['span']:<24} traces={r['traces']:<4} "
                f"({r['trace_share']:.0%} of slow)  "
                f"mean {r['mean_ms']:9.3f} ms  "
                f"({r['mean_share_of_root']:.0%} of root)"
            )
    for t in kept[:show]:
        if not t.roots:
            continue
        lines.append(
            f"trace {t.trace_id[:16]}  total={t.duration_ns / 1e6:.3f} ms  "
            f"spans={t.span_count()}"
        )
        orphan_ids = {o.span_id for o in t.orphans}
        for root in t.roots:
            if root.span_id in orphan_ids:
                lines.append(
                    f"  (parent {root.parent_id} is outside the journal "
                    "— e.g. an exported tracer span)"
                )
            _render_node(root, lines, 1, root.host)
    return "\n".join(lines)


# ----------------------------------------------------------------- OTLP -----


def otlp_trace_payload(records: Iterable[dict],
                       resource: Optional[dict] = None) -> dict:
    """OTLP/HTTP-JSON ``ExportTraceServiceRequest`` shape over flight
    records (traceId/spanId/parentSpanId + name + start/end). The
    SYNTHESIZED segment/annotation spans ship too — a coop serve
    record's parent is a derived segment id, so without them the
    cross-host stitch would reference a span no backend ever receives.
    A record whose parent is a TRACER span resolves only when that
    tracer exports through the same backend (the OtelTracer path, which
    journals the SDK's exact ids); the in-process RecordingTracer's
    spans surface as missing-parent roots, which backends tolerate.
    Timestamps are the records' monotonic ``perf_counter`` nanoseconds,
    NOT unix epoch — honest for relative analysis, stamped as-is
    (documented; consumers aligning across hosts must use the id graph,
    not clocks)."""
    spans = []

    def emit(node: SpanNode, error=None) -> None:
        span = {
            "traceId": node.trace_id,
            "spanId": node.span_id,
            "name": node.name if node.synth
            else f"{node.kind}:{node.name}",
            "startTimeUnixNano": str(node.start_ns),
            "endTimeUnixNano": str(node.end_ns),
            "attributes": [
                {"key": "host",
                 "value": {"intValue": str(node.host)}},
                {"key": "worker",
                 "value": {"stringValue": str(node.worker)}},
            ],
        }
        if node.parent_id:
            span["parentSpanId"] = node.parent_id
        if error:
            span["status"] = {"code": 2, "message": str(error)}
        spans.append(span)

    for rec in records:
        sid = rec.get("span_id")
        if not sid:
            continue
        node = _node_from_record(rec, sid)
        emit(node, error=node.error)
        for child in _synth_children(node, rec):
            emit(child)
    return {
        "resourceSpans": [{
            "resource": {"attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in (resource or {}).items()
            ]},
            "scopeSpans": [{
                "scope": {"name": "tpubench"},
                "spans": spans,
            }],
        }],
    }
