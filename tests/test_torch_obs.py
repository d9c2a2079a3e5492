"""The port's obs plane (``tpubench_torch/obs``) against ``tpubench/obs``:
each function runs on the same numpy-seeded inputs in both packages and
must give the same output. Counts, ids, bucket counts and rendered text are
compared exactly (tolerance 0); the summaries' percentiles come from the
same arithmetic on the same integers, so they are compared exactly too.
Only wall-clock stamps (``time``/``timeUnixNano`` fields of payloads) are
left out.

Also here: the telemetry endpoint scraped over loopback (stopped in a
``finally``; the test checks the port is closed afterwards), the stage
records the staging rings write on the CPU, and the thread-local discipline
(no op or trace context leaks from a helper thread to the next job).
"""

import gzip
import json
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import tpubench.config as jax_config
import tpubench.obs.exporters as jax_exporters
import tpubench.obs.flight as jax_flight
import tpubench.obs.telemetry as jax_telemetry
import tpubench.obs.trace as jax_trace
import tpubench.obs.tracing as jax_tracing
from tpubench.metrics import MetricSet as JaxMetricSet
from tpubench.staging import device as jax_staging

import tpubench_torch.config as t_config
import tpubench_torch.obs.exporters as t_exporters
import tpubench_torch.obs.flight as t_flight
import tpubench_torch.obs.telemetry as t_telemetry
import tpubench_torch.obs.trace as t_trace
import tpubench_torch.obs.tracing as t_tracing
from tpubench_torch.metrics import MetricSet
from tpubench_torch.staging import device as t_staging
from tpubench_torch.staging.executor import InflightWindow, TransferEngine

PAIRS = {
    "flight": (jax_flight, t_flight),
    "telemetry": (jax_telemetry, t_telemetry),
    "exporters": (jax_exporters, t_exporters),
    "tracing": (jax_tracing, t_tracing),
    "trace": (jax_trace, t_trace),
    "config": (jax_config, t_config),
}


def both(module: str):
    return PAIRS[module]


# ------------------------------------------------------------- records ----


def seeded_records(seed: int, n: int = 60) -> list[dict]:
    """Flight records as the recorder writes them, drawn from a seeded
    numpy generator: reads and stage transfers over three workers, phase
    stamps in order, retry/hedge/stall/breaker/gRPC notes, a few errors."""
    rng = np.random.default_rng(seed)
    read_phases = ("connect", "stream_open", "first_byte", "body_complete")
    stage_phases = ("stage_submit", "stage_complete", "hbm_staged")
    recs = []
    for i in range(n):
        kind = "stage" if rng.random() < 0.3 else "read"
        t = int(rng.integers(0, 10**9))
        phases = {"enqueue": t}
        for p in (stage_phases if kind == "stage" else read_phases):
            if kind == "read" and p == "connect" and rng.random() < 0.5:
                continue
            t += int(rng.integers(0, 5 * 10**7))
            phases[p] = t
        if kind == "stage":
            phases["hbm_staged"] = phases["stage_complete"]
        rec = {
            "worker": f"w{int(rng.integers(0, 3))}"
            + ("/stage" if kind == "stage" else ""),
            "object": f"tpubench/file_{i % 7}",
            "transport": "fake",
            "kind": kind,
            "phases": phases,
            "bytes": int(rng.integers(1, 1 << 24)),
            "trace_id": f"{int(rng.integers(0, 1 << 62)):032x}",
            "span_id": f"{int(rng.integers(0, 1 << 62)):016x}",
            "host": 0,
        }
        notes = []
        for kind_, extra in (
            ("retry", {"attempt": 1, "backoff_s": 0.004}),
            ("hedge", {"event": "launch"}),
            ("hedge", {"event": str(rng.choice(["win", "lose"]))}),
            ("stall", {"rate_bps": 12}),
            ("breaker", {"event": "open"}),
            ("grpc_frame", {"dir": "recv", "bytes": 9}),
            ("stage", {"event": "overlap"}),
        ):
            if rng.random() < 0.2:
                notes.append({"kind": kind_, "t": t, **extra})
        if notes:
            rec["notes"] = notes
        if rng.random() < 0.05:
            rec["error"] = "StorageError: injected"
        recs.append(rec)
    return recs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_timeline_summary_matches_reference(seed):
    recs = seeded_records(seed)
    j, t = both("flight")
    assert t.timeline_summary(recs) == j.timeline_summary(recs)
    for rec in recs:
        assert t.phase_segments(rec) == j.phase_segments(rec)
        assert t.record_span_ns(rec) == j.record_span_ns(rec)
        assert t.monotone(rec) == j.monotone(rec)
    doc = {"format": j.JOURNAL_FORMAT, "host": 0, "records": recs}
    assert t.merge_journal_docs([doc]) == j.merge_journal_docs([doc])
    assert t.render_timeline([doc]) == j.render_timeline([doc])
    assert t.PHASES == j.PHASES


def test_transport_label_and_journal_path_match_reference():
    j, t = both("flight")
    jc, tc = both("config")
    for proto, h2, native in (("fake", False, False), ("http", True, False),
                              ("grpc", False, True), ("http", False, True)):
        jcfg, tcfg = jc.BenchConfig(), tc.BenchConfig()
        for cfg in (jcfg, tcfg):
            cfg.transport.protocol = proto
            cfg.transport.http2, cfg.transport.native_receive = h2, native
        assert t.transport_label(tcfg) == j.transport_label(jcfg)
    for args in (("j.json", 0, 1), ("j.json", 3, 4), ("j.json.gz", 2, 4)):
        assert t.host_journal_path(*args) == j.host_journal_path(*args)
    cfg = tc.BenchConfig()
    assert t.flight_from_config(cfg).capacity == 1024
    cfg.obs.flight_records = 0
    assert t.flight_from_config(cfg) is None


def _journal_docs(flight_mod, recs, path, max_bytes):
    fr = flight_mod.FlightRecorder(capacity_per_worker=16)
    for rec in recs:
        fr.worker(rec["worker"]).append(dict(rec))
    fr.write_journal(str(path), extra={"workload": "read"},
                     max_bytes=max_bytes)
    doc = flight_mod.load_journals([str(path)])[0]
    doc.pop("time")
    return doc, fr.rotation_dropped_total, fr.dropped


@pytest.mark.parametrize("gz", [False, True], ids=["json", "gzip"])
def test_journal_rotation_and_gzip_match_reference(tmp_path, gz):
    """Same records into both recorders (rings of 16 overflow), written
    with a byte bound: the same records survive, the same are dropped and
    counted, and each package reads the other's journal."""
    recs = seeded_records(4)
    j, t = both("flight")
    suffix = ".json.gz" if gz else ".json"
    jd = _journal_docs(j, recs, tmp_path / f"j{suffix}", 6000)
    td = _journal_docs(t, recs, tmp_path / f"t{suffix}", 6000)
    assert td == jd
    doc, rotated, dropped = td
    assert doc["rotation_dropped"] > 0 and rotated > 0 and dropped > 0
    if gz:
        with gzip.open(tmp_path / f"t{suffix}", "rt") as f:
            assert json.load(f)["format"] == "tpubench-flight-v1"
    cross = j.load_journals([str(tmp_path / f"t{suffix}")])[0]
    cross.pop("time")
    assert cross == doc


# ------------------------------------------------------------- telemetry ---


def _fed_registry(tel_mod, recs):
    reg = tel_mod.build_registry()
    feeder = tel_mod.FlightFeeder(reg)
    for rec in recs:
        feeder(rec)
    reg.get("tpubench_native_transport_total").inc("bytes_on_wire", 4096)
    reg.get("tpubench_goodput_gbps").set(1.25)
    h = reg.get("tpubench_read_latency_ms")
    for ns in np.random.default_rng(7).integers(1, 10**11, size=50):
        h.observe_ns(int(ns))
    return reg, feeder


def _strip_times(obj):
    if isinstance(obj, dict):
        return {
            k: _strip_times(v) for k, v in obj.items()
            if k not in ("time", "timeUnixNano", "startTimeUnixNano")
        }
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


@pytest.mark.parametrize("seed", [0, 5])
def test_registry_prometheus_and_otlp_match_reference(seed):
    recs = seeded_records(seed)
    j, t = both("telemetry")
    jreg, jfeed = _fed_registry(j, recs)
    treg, tfeed = _fed_registry(t, recs)
    assert t.metric_catalog() == j.metric_catalog()
    assert treg.render_prometheus() == jreg.render_prometheus()
    assert (treg.render_prometheus(openmetrics=True)
            == jreg.render_prometheus(openmetrics=True))
    assert _strip_times(treg.snapshot()) == _strip_times(jreg.snapshot())
    assert tfeed.goodput() == jfeed.goodput()
    je, te = both("exporters")
    jp = je.OTLPMetricsExporter(jreg.snapshot, resource={"r": "1"})
    tp = te.OTLPMetricsExporter(treg.snapshot, resource={"r": "1"})
    assert _strip_times(tp.build_payload()) == _strip_times(jp.build_payload())
    assert treg.get("tpubench_reads_total").value == sum(
        1 for r in recs if r["kind"] == "read"
    )


def _scrape(port: int, path: str = "/metrics") -> str:
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=5
    ) as resp:
        return resp.read().decode("utf-8")


def test_telemetry_endpoint_serves_and_stops():
    """``/metrics`` and ``/snapshot`` on an ephemeral loopback port show
    the records fed so far; ``close()`` (in a finally) takes the server
    and the tick thread down."""
    recs = seeded_records(2, n=12)
    tc = t_config.TelemetryConfig(enabled=True, port=0, interval_s=0.05,
                                  otlp=True)
    sess = t_telemetry.TelemetrySession(tc, resource={"transport": "fake"})
    flight = t_flight.FlightRecorder(capacity_per_worker=64)
    threads0 = set(threading.enumerate())
    sess.start()
    try:
        sess.attach_flight(flight)
        for rec in recs:
            flight.worker(rec["worker"]).append(dict(rec))
        reads = sum(1 for r in recs if r["kind"] == "read")
        text = _scrape(sess.port)
        assert f"\ntpubench_reads_total {reads}\n" in text
        snap = json.loads(_scrape(sess.port, "/snapshot"))
        assert snap["counters"]["tpubench_reads_total"] == reads
        assert snap["resource"] == {"transport": "fake"}
        with pytest.raises(urllib.error.HTTPError):
            _scrape(sess.port, "/nope")
    finally:
        summary = sess.close()
    assert summary["scrapes"] >= 1 and summary["otlp"]["payloads"] >= 1
    assert summary["otlp"]["traces"]["spans"] > 0
    with pytest.raises(OSError):
        _scrape(sess.port)
    # The server's request threads are daemons that may be finishing a
    # reply as close() returns: give them a moment, then none may remain.
    deadline = time.monotonic() + 2.0
    while set(threading.enumerate()) - threads0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - threads0


def test_telemetry_config_section_matches_reference():
    jc, tc = both("config")
    assert (t_config.BenchConfig().to_dict()["telemetry"]
            == jc.BenchConfig().to_dict()["telemetry"])
    for bad in (dict(port=70000), dict(interval_s=0.0),
                dict(otlp_endpoint="ftp://x")):
        for mod in (jc, tc):
            with pytest.raises(SystemExit):
                mod.validate_telemetry_config(mod.TelemetryConfig(**bad))
    cfg = tc.BenchConfig()
    assert t_telemetry.telemetry_from_config(cfg) is None
    cfg.telemetry.otlp = True
    assert isinstance(t_telemetry.telemetry_from_config(cfg),
                      t_telemetry.TelemetrySession)


# ------------------------------------------------------------ exporters ----


def test_cloud_dry_run_and_metrics_session_match_reference():
    """The dry-run Cloud Monitoring capture after the same recorder
    samples: same series, names, labels, bucket counts and values."""
    out = []
    rng = np.random.default_rng(3)
    samples = rng.integers(10**5, 10**10, size=(2, 40))
    for exp_mod, cfg_mod, metrics in (
        (jax_exporters, jax_config, JaxMetricSet()),
        (t_exporters, t_config, MetricSet()),
    ):
        cfg = cfg_mod.BenchConfig()
        cfg.obs.export = "cloud"
        cfg.workload.project = "p"
        for i in range(2):
            r, fb = metrics.new_worker(f"w{i}")
            for ns in samples[i]:
                r.record_ns(int(ns))
                fb.record_ns(int(ns) // 3)
        metrics.ingest.bytes = 123_456_789
        sess = exp_mod.metrics_session_from_config(cfg, metrics)
        with sess:
            pass
        out.append((_strip_times(sess.exporter.exported), sess.summary()))
    assert out[1] == out[0]
    dist = t_exporters.LatencyDistribution()
    jdist = jax_exporters.LatencyDistribution()
    vals = rng.uniform(0, 2e5, size=500).tolist()
    dist.record_many_ms(vals)
    jdist.record_many_ms(vals)
    assert dist.to_dict() == jdist.to_dict()


def test_live_cloud_export_fails_loudly_without_the_package(monkeypatch):
    """``export_dry_run=False`` needs google-cloud-monitoring: without it
    both packages raise at construction, never a silent no-op."""
    monkeypatch.setitem(sys.modules, "google.cloud.monitoring_v3", None)
    for mod in (jax_exporters, t_exporters):
        with pytest.raises(ImportError):
            mod.CloudMonitoringExporter("p", "custom.googleapis.com/x/",
                                        dry_run=False)


def test_snapshot_writer_and_torn_snapshots_match_reference(tmp_path):
    p = tmp_path / "s.json"
    with t_exporters.SnapshotWriter(lambda: {"a": 1}, str(p), 60.0):
        pass  # the final flush writes on exit
    snap = t_exporters.load_snapshot(str(p))
    assert snap["a"] == 1 and snap["process_index"] == 0
    for raw in ("", "{\"a\": 1", "[1, 2]"):
        p.write_text(raw)
        assert t_exporters.load_snapshot(str(p)) is None
        assert jax_exporters.load_snapshot(str(p)) is None
    assert t_exporters.load_snapshot(str(tmp_path / "missing")) is None


def test_otlp_trace_payload_matches_reference():
    recs = seeded_records(9)
    assert (t_trace.otlp_trace_payload(recs, {"host": "0"})
            == jax_trace.otlp_trace_payload(recs, {"host": "0"}))
    spans = t_trace.otlp_trace_payload(recs)["resourceSpans"][0][
        "scopeSpans"][0]["spans"]
    assert len(spans) > len(recs)  # records plus their synthesized children


# -------------------------------------------------------------- tracing ----


@pytest.mark.parametrize("seed", [0, 11])
def test_span_ids_after_seed_match_reference(seed):
    out = []
    for mod in (jax_tracing, t_tracing):
        mod.seed_trace_ids(seed)
        ids = [mod.new_trace_id(), mod.new_span_id(), mod.new_span_id()]
        ids += [mod.derive_span_id(ids[1], p) for p in ("connect", "retry#0")]
        tracer = mod.RecordingTracer(sample_rate=0.5, seed=seed)
        for i in range(20):
            with tracer.span("ReadObject", i=i):
                with tracer.span("gcs_http.get"):
                    pass
        ids += [(s.name, s.trace_id, s.span_id, s.parent_id)
                for s in tracer.spans]
        out.append(ids)
        mod.seed_trace_ids(int.from_bytes(np.random.bytes(4), "little"))
    assert out[1] == out[0]
    names = [x[0] for x in out[1] if isinstance(x, tuple)]
    assert 0 < names.count("ReadObject") < 20  # sampled per trace
    assert names.count("gcs_http.get") == names.count("ReadObject")


def _tracer_kinds(mod, cfg_mod, monkeypatch, otel: bool, exporter: str):
    cfg = cfg_mod.BenchConfig()
    cfg.obs.enable_tracing = True
    cfg.obs.trace_exporter = exporter
    with monkeypatch.context() as m:
        if not otel:
            m.setitem(sys.modules, "opentelemetry.sdk.trace", None)
        try:
            return type(mod.make_tracer(cfg)).__name__
        except RuntimeError:
            return "RuntimeError"


def test_make_tracer_rules_match_reference(monkeypatch):
    """Tracing off → NoopTracer; no OTel SDK and no exporter →
    RecordingTracer; no SDK but an exporter asked for → an error. With
    this machine's own packages, whatever they are, both packages pick
    the same tracer."""
    got = {}
    for name, mod, cfg_mod in (("jax", jax_tracing, jax_config),
                               ("port", t_tracing, t_config)):
        on = cfg_mod.BenchConfig()
        on.obs.enable_tracing = True
        got[name] = [
            type(mod.make_tracer(cfg_mod.BenchConfig())).__name__,
            _tracer_kinds(mod, cfg_mod, monkeypatch, False, ""),
            _tracer_kinds(mod, cfg_mod, monkeypatch, False, "console"),
            type(mod.make_tracer(on)).__name__,
        ]
    assert got["port"] == got["jax"]
    assert got["port"][:3] == ["NoopTracer", "RecordingTracer", "RuntimeError"]


# -------------------------------------------------------- stage records ----


def _stage_records(stager_factory, flight_mod, nbytes: int) -> list[dict]:
    rec = flight_mod.FlightRecorder(capacity_per_worker=64)
    data = memoryview(np.arange(nbytes, dtype=np.uint64).astype(np.uint8))
    with rec.activate():
        st = stager_factory()
        for off in range(0, nbytes, 64 * 1024):
            st.submit(data[off : off + 64 * 1024])
        stats = st.finish()
    return rec.records(), stats


@pytest.mark.parametrize("mode", [
    dict(mode="device_put", validate_checksum=True),
    dict(mode="device_put", depth=3),
    dict(mode="pallas"),
], ids=["validate", "depth3", "pallas"])
def test_stage_records_match_reference(mode, jax_cpu_devices):
    """The stagers' per-transfer records on the CPU: one ``kind="stage"``
    record per transfer in the device_put rings (serial and window), none
    in the landing-kernel ring — the same records, by structure, as
    ``tpubench``'s; ``stage_submit ≤ stage_complete == hbm_staged``."""
    out = []
    for cfg_mod, staging, flight_mod, kw in (
        (jax_config, jax_staging, jax_flight, {}),
        (t_config, t_staging, t_flight, {"device": "cpu"}),
    ):
        cfg = cfg_mod.BenchConfig()
        cfg.workload.granule_bytes = 64 * 1024
        cfg.staging.slot_bytes = 256 * 1024
        for k, v in mode.items():
            setattr(cfg.staging, k, v)
        recs, stats = _stage_records(
            lambda: staging.make_sink_factory(cfg, **kw)(0), flight_mod,
            1_000_003,
        )
        out.append((
            [(r["worker"], r["kind"], r["object"], r["transport"],
              sorted(r["phases"]), r["bytes"],
              [n["kind"] for n in r.get("notes", ())]) for r in recs],
            stats["transfers"],
        ))
        for r in recs:
            ph = r["phases"]
            assert ph["enqueue"] <= ph["stage_submit"] <= ph["stage_complete"]
            assert ph["stage_complete"] == ph["hbm_staged"]
    assert out[1] == out[0]
    recs, transfers = out[1]
    assert len(recs) == (0 if mode["mode"] == "pallas" else transfers)
    if recs:
        assert sum(r[5] for r in recs) == 1_000_003


class _SlowEngine(TransferEngine):
    """CPU transfer engine whose copies report done only after a few
    polls, so the reaper's poll path runs."""

    def submit(self, array, device):
        handle = super().submit(array, device)
        return [handle[0], [3]]

    def probe(self, handle):
        handle[1][0] -= 1
        return handle[1][0] <= 0

    def wait(self, handle):
        handle[1][0] = 0


def test_window_reaper_finishes_ops_and_leaks_no_context():
    """The window's reaper adopts each transfer's op to stamp it and
    clears the adoption before the next; the producer's own op and trace
    context are untouched."""
    rec = t_flight.FlightRecorder(capacity_per_worker=64)
    ring = rec.worker("w0/stage")
    reader = rec.worker("w0").begin("obj", "fake")  # producer's read op
    seen = []
    win = InflightWindow(2, torch.device("cpu"), engine=_SlowEngine(),
                         flight_ring=ring, name="t")
    try:
        for i in range(6):
            win.enqueue(torch.zeros(4096, dtype=torch.uint8), 4096,
                        on_complete=lambda: seen.append(
                            (t_flight.current_op(), t_tracing.current_trace())
                        ))
    finally:
        win.close()
    assert t_flight.current_op() is reader
    reader.finish(1)
    stage = [r for r in rec.records() if r["kind"] == "stage"]
    assert len(stage) == win.transfers == 6
    assert all(r.get("parent_id") == reader.span_id for r in stage)
    assert all(op is None and ctx is None for op, ctx in seen)


def test_adopted_op_does_not_leak_to_a_reused_thread():
    """A helper thread that adopts an op and clears it leaves the next
    job on the same thread with no op: phases noted there land nowhere."""
    wf = t_flight.WorkerFlight("w0", 8)
    op = wf.begin("obj", "fake", install=False)
    with ThreadPoolExecutor(max_workers=1) as pool:
        def first():
            t_flight.adopt_op(op)
            try:
                t_flight.note_phase("connect")
            finally:
                t_flight.adopt_op(None)

        pool.submit(first).result()
        leaked = pool.submit(t_flight.current_op).result()
        pool.submit(t_flight.note_phase, "stream_open").result()
    op.finish(10)
    assert leaked is None
    phases = wf.records()[0]["phases"]
    assert "connect" in phases and "stream_open" not in phases
