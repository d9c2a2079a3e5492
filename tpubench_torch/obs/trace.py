"""Flight records → OTLP trace payloads (the export half of
``tpubench/obs/trace.py``).

The flight recorder stamps every record with ``trace_id``/``span_id``/
``parent_id`` (:mod:`tpubench_torch.obs.flight`), and the propagation layer
(:mod:`tpubench_torch.obs.tracing`) threads one :class:`TraceContext` through
tracer spans, the tail stack's helper threads and the staging reaper. Each
record is a span; its phase timeline is decomposed into SYNTHESIZED child
spans (one per phase segment, ids derived with
:func:`~tpubench_torch.obs.tracing.derive_span_id`), and retry/hedge/gRPC
frame annotations become annotation child spans (a retry's span covers
its backoff pause, a hedge leg runs launch→verdict).
:func:`otlp_trace_payload` ships them in the OTLP/HTTP-JSON
``resourceSpans`` shape (dry-run capture or POST via
:class:`~tpubench_torch.obs.exporters.OTLPTraceExporter`).

The merge side of the reference module (span-tree assembly, tail
sampling, critical path, the ``report trace`` body) comes with the
``report`` command (``ROADMAP.md`` A.3).

Clock honesty: phase timestamps are ``perf_counter`` nanoseconds —
host-relative.
"""

from __future__ import annotations

from typing import Iterable, Optional

from tpubench_torch.obs.flight import PHASES
from tpubench_torch.obs.tracing import derive_span_id


class SpanNode:
    """One span: a flight record, or a synthesized child (phase segment /
    annotation) of one."""

    __slots__ = ("span_id", "trace_id", "parent_id", "name", "kind",
                 "host", "worker", "start_ns", "end_ns", "bytes", "error",
                 "synth")

    def __init__(self, *, span_id, trace_id, parent_id, name, kind, host,
                 worker="", start_ns=0, end_ns=0, nbytes=0, error=None,
                 synth=False):
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
    """Record → SpanNode with its span window (min/max phase stamp)."""
    node = SpanNode(
        span_id=sid, trace_id=rec.get("trace_id", ""),
        parent_id=rec.get("parent_id"), name=rec.get("object", "?"),
        kind=rec.get("kind", "read"), host=rec.get("host", 0),
        worker=rec.get("worker", ""), nbytes=rec.get("bytes", 0),
        error=rec.get("error"),
    )
    ph = rec.get("phases", {})
    ts = [ph[p] for p in PHASES if p in ph]
    if ts:
        node.start_ns, node.end_ns = min(ts), max(ts)
    return node



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
