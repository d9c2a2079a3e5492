"""The storage clients of the worker-pool route as a whole: one config
and one population through ``tpubench read`` (JAX on the CPU, served by
``tpubench``'s fake servers) and ``tpubench_torch read`` (PyTorch on the
CPU, served by the port's own fake servers).

Variants: HTTP/1.1, HTTP/1.1 with native receive, HTTP/2, gRPC (wire),
gRPC with native receive and local files, each in staging modes
device_put+validate and pallas, plus device_put depth 2 for HTTP/1.1.
Bytes, transfers, per-worker host and device checksums and the checksum
verdict must be equal, exactly (tolerance 0), and the results must have
the same keys. Not compared, as in ``test_torch_read_parity.py``: timings,
the per-chip rates and ``n_chips`` (8 simulated JAX CPU devices against
the port's one CPU). ``extra["flight"]`` is compared by structure (record
counts per kind, phase names, key sets), not by its times.

Both packages pick gRPC library mode whenever ``grpcio`` imports; the
gRPC variants hold the wire clients, so both sides are held to wire mode
here by patching each package's ``gcs_grpc._HAVE_LIB`` (nothing in
``tpubench`` is edited). Library mode is held against ``tpubench``'s in
``test_torch_grpc_lib.py``.

One case runs HTTP/1.1 with tail tolerance, tracing and telemetry on, and
compares their counters and span names. One more case runs HTTP/1.1 with
a seeded fault plan (open 503s and mid-stream failures) under retry
policy ``always``: resumes land
mid-granule (the servers send 100,000-byte chunks, the client reads
64 KiB granules), and each side must still stage exactly the
population's bytes, each once.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

import tpubench.storage.gcs_grpc as jax_gcs_grpc
from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.obs.tracing import RecordingTracer as JaxRecordingTracer
from tpubench.staging import device as jax_staging
from tpubench.storage.fake import FakeBackend as JaxFakeBackend
from tpubench.storage.fake import FaultPlan as JaxFaultPlan
from tpubench.storage.fake_grpc_wire_server import (
    FakeGrpcWireServer as JaxGrpcServer,
)
from tpubench.storage.fake_h2_server import FakeH2Server as JaxH2Server
from tpubench.storage.fake_server import FakeGcsServer as JaxGcsServer
from tpubench.workloads.read import run_read as jax_run_read

from tpubench_torch import convert
from tpubench_torch.config import BenchConfig
from tpubench_torch.obs.tracing import RecordingTracer
from tpubench_torch.staging.device import make_sink_factory
from tpubench_torch.storage import gcs_grpc
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.storage.fake_grpc_wire_server import FakeGrpcWireServer
from tpubench_torch.storage.fake_h2_server import FakeH2Server
from tpubench_torch.storage.fake_server import FakeGcsServer
from tpubench_torch.workloads.read import run_read

OBJECT_SIZE = 777_777  # not a granule multiple: the short-tail path
WORKERS = 2
READS = 2
PREFIX = "tpubench/file_"
GRANULE = 64 * 1024
EXTRA_ONLY_IN_JAX: set = set()

# variant -> (protocol, server kind, transport switches)
VARIANTS = {
    "http": ("http", "h1", {}),
    "http_native": ("http", "h1", {"native_receive": True}),
    "http2": ("http", "h2", {"http2": True}),
    "grpc": ("grpc", "grpc", {}),
    "grpc_native": ("grpc", "grpc", {"native_receive": True}),
    "local": ("local", None, {}),
}
MODES = {
    "device_put_validate": dict(mode="device_put", validate_checksum=True),
    "pallas": dict(mode="pallas"),
    "device_put_depth2": dict(mode="device_put", depth=2),
}
CASES = [(v, m) for v in VARIANTS for m in ("device_put_validate", "pallas")]
CASES.append(("http", "device_put_depth2"))

# Both packages warn that DirectPath does not apply to a test server.
pytestmark = pytest.mark.filterwarnings("ignore:.*directpath")

SERVERS = {
    "h1": (JaxGcsServer, FakeGcsServer),
    "h2": (JaxH2Server, FakeH2Server),
    "grpc": (JaxGrpcServer, FakeGrpcWireServer),
}


@pytest.fixture(autouse=True)
def _wire_mode_and_devices(monkeypatch, jax_cpu_devices):
    monkeypatch.setattr(jax_gcs_grpc, "_HAVE_LIB", False)
    monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", False)


def _stop(server) -> None:
    """Stop a fake server without waiting out its accept thread: a listening
    socket closed under a blocked ``accept`` does not wake it on Linux, so
    the socket is shut down first (``tpubench``'s h2 and gRPC fakes would
    otherwise spend their 5 s join timeout)."""
    sock = getattr(server, "_sock", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    server.stop()


@pytest.fixture(scope="module")
def servers():
    """Each kind of server, started once for the module: ``tpubench``'s
    over a JAX store and the port's over the port's store, both of the
    same population (the port's carried across by ``from_reference``)."""
    jstore = JaxFakeBackend.from_population(_population())
    _, tstore = convert.from_reference(
        _reference_config("http", "pallas", {}), _population()
    )
    started = {}
    try:
        for kind, (jcls, tcls) in SERVERS.items():
            started[kind] = (jcls(jstore).start(), tcls(tstore).start())
        yield started
    finally:
        for pair in started.values():
            for srv in pair:
                _stop(srv)


@pytest.fixture(scope="module")
def local_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("objects")
    for name, size, _ in _population():
        path = root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(deterministic_bytes(name, size).tobytes())
    return str(root)


def _population():
    return [(f"{PREFIX}{i}", OBJECT_SIZE, 1) for i in range(WORKERS)]


def _reference_config(protocol: str, mode: str, switches: dict) -> dict:
    cfg = JaxBenchConfig()
    cfg.workload.workers = WORKERS
    cfg.workload.read_calls_per_worker = READS
    cfg.workload.object_size = OBJECT_SIZE
    cfg.workload.granule_bytes = GRANULE
    cfg.workload.bucket = "testbucket"
    cfg.workload.object_name_prefix = PREFIX
    cfg.transport.protocol = protocol
    cfg.transport.retry.initial_backoff_s = 0.001
    cfg.transport.retry.max_backoff_s = 0.01
    cfg.transport.retry.jitter = False
    cfg.transport.retry.deadline_s = 20.0
    for k, v in switches.items():
        setattr(cfg.transport, k, v)
    cfg.staging.slot_bytes = 256 * 1024
    for k, v in MODES[mode].items():
        setattr(cfg.staging, k, v)
    return cfg.to_dict()


class _Recording:
    """Sink wrapper keeping each worker's stager stats (the checksums are
    compared per worker)."""

    def __init__(self, inner, stats: dict, worker_id: int):
        self._inner, self._stats, self._id = inner, stats, worker_id
        if hasattr(inner, "acquire"):
            self.acquire, self.commit = inner.acquire, inner.commit

    def submit(self, mv):
        self._inner.submit(mv)

    def finish(self):
        st = self._inner.finish()
        self._stats[self._id] = st
        return st


def _recording(factory, stats: dict):
    return lambda i: _Recording(factory(i), stats, i)


def _in_turn(factory, workers: int):
    """Sink factory that runs the read workers one after another: worker
    ``i`` makes its sink (in its own thread, before its first request)
    only once worker ``i-1``'s sink has finished. A faulted store draws
    every request's fault from one seeded RNG in arrival order, so with
    workers in turn each one meets the same faults in both packages."""
    finished = [threading.Event() for _ in range(workers)]

    def make(i):
        if i and not finished[i - 1].wait(timeout=60):
            raise TimeoutError(f"worker {i - 1} did not finish its reads")
        sink = factory(i)
        finish = sink.finish

        def done():
            try:
                return finish()
            finally:
                finished[i].set()

        sink.finish = done
        return sink

    return make


def _run_both(variant: str, mode: str, endpoints=None, local_dir: str = "",
              fault: dict = None):
    """Both packages on the same config and population; ``endpoints`` is
    the (JAX, port) server endpoint pair. Returns the two results and the
    per-worker stager stats. With a ``fault`` plan the workers run in
    turn (:func:`_in_turn`)."""
    protocol, _, switches = VARIANTS[variant]
    cfg_dict = _reference_config(protocol, mode, switches)
    if fault:
        cfg_dict["transport"]["fault"].update(fault)
    cfg_dict["workload"]["dir"] = local_dir
    jcfg = JaxBenchConfig.from_dict(cfg_dict)
    tcfg = BenchConfig.from_dict(cfg_dict)
    if endpoints is not None:
        jcfg.transport.endpoint, tcfg.transport.endpoint = endpoints
    jstats, tstats = {}, {}
    jfactory = _recording(jax_staging.make_sink_factory(jcfg), jstats)
    tfactory = _recording(make_sink_factory(tcfg, device="cpu"), tstats)
    if fault:
        jfactory, tfactory = _in_turn(jfactory, WORKERS), _in_turn(tfactory, WORKERS)
    jres = jax_run_read(jcfg, sink_factory=jfactory)
    tres = run_read(tcfg, device="cpu", sink_factory=tfactory)
    return jres.to_dict(), tres.to_dict(), jstats, tstats


def flight_structure(summary: dict) -> dict:
    """A flight summary without its times: key sets, record counts per
    kind, tail/retry counts and phase names (as in
    ``test_torch_read_parity.py``)."""
    return {
        "keys": sorted(summary),
        "records": summary["records"],
        "stage_records": summary["staging"]["transfers"],
        "stage_bytes": summary["staging"]["transfer_bytes"],
        "overlapped": summary["staging"]["overlapped"],
        "errors": summary["errors"],
        "tail": summary["tail"],
        "phases": sorted(summary["phases"]),
        "hosts": summary["hosts"],
    }


def _byte_sum(name: str) -> int:
    return int(deterministic_bytes(name, OBJECT_SIZE).sum(dtype=np.uint64))


@pytest.mark.parametrize("variant, mode", CASES, ids=[f"{v}-{m}" for v, m in CASES])
def test_protocol_parity(variant, mode, servers, local_dir):
    kind = VARIANTS[variant][1]
    endpoints = (
        None if kind is None else tuple(srv.endpoint for srv in servers[kind])
    )
    jres, tres, jstats, tstats = _run_both(variant, mode, endpoints, local_dir)
    total = WORKERS * READS * OBJECT_SIZE
    for res in (jres, tres):
        assert res["errors"] == 0
        assert res["bytes_total"] == total
        assert res["extra"]["staged_bytes"] == total
        assert res["extra"]["staging_zero_copy"] is True
    assert set(jres) == set(tres)
    assert set(jres["extra"]) - EXTRA_ONLY_IN_JAX == set(tres["extra"])
    assert set(jres["summaries"]) == set(tres["summaries"])
    je, te = jres["extra"], tres["extra"]
    assert flight_structure(je["flight"]) == flight_structure(te["flight"])
    assert je.get("checksum_ok") == te.get("checksum_ok")
    if "staging" in je:
        for key in ("transfers", "staged_bytes", "depth", "workers"):
            assert je["staging"][key] == te["staging"][key], key
    for name in jres["summaries"]:
        assert (jres["summaries"][name]["count"]
                == tres["summaries"][name]["count"]), name
    if "native_conn_stats" in je:
        assert set(je["native_conn_stats"]) == set(te["native_conn_stats"])
    assert set(jstats) == set(tstats) == set(range(WORKERS))
    for i in range(WORKERS):
        assert set(jstats[i]) == set(tstats[i])
        for key in ("staged_bytes", "transfers", "slot_bytes", "depth",
                    "checksum_ok", "checksum_host", "checksum_device"):
            assert jstats[i].get(key) == tstats[i].get(key), (i, key)
        if "checksum_host" in tstats[i]:
            want = READS * _byte_sum(f"{PREFIX}{i}") % (1 << 32)
            assert tstats[i]["checksum_host"] % (1 << 32) == want


def test_faulted_http_under_retry_resumes_mid_granule():
    """Seeded open 503s and mid-stream failures under retry policy
    ``always``: each side resumes (more opens than reads) and still stages
    every byte exactly once — equal bytes and checksums, no error. The
    workers read in turn, so each meets the same seeded faults in both
    packages and ships the same transfers."""
    fault = dict(error_rate=0.2, read_error_rate=0.25, seed=11)
    cfg_dict = _reference_config("http", "device_put_validate", {})
    cfg_dict["transport"]["fault"].update(fault)
    _, tstore = convert.from_reference(cfg_dict, _population())
    jstore = JaxFakeBackend.from_population(
        _population(), fault=JaxFaultPlan(**fault)
    )
    jsrv = JaxGcsServer(jstore, chunk_bytes=100_000).start()
    tsrv = FakeGcsServer(tstore, chunk_bytes=100_000).start()
    try:
        jres, tres, jstats, tstats = _run_both(
            "http", "device_put_validate", (jsrv.endpoint, tsrv.endpoint),
            fault=fault,
        )
    finally:
        _stop(jsrv)
        _stop(tsrv)
    total = WORKERS * READS * OBJECT_SIZE
    for res, store in ((jres, jstore), (tres, tstore)):
        assert res["errors"] == 0
        assert res["bytes_total"] == res["extra"]["staged_bytes"] == total
        assert res["extra"]["checksum_ok"] is True
        assert store.open_count > WORKERS * READS  # resumes happened
    for i in range(WORKERS):
        want = READS * _byte_sum(f"{PREFIX}{i}")
        for st in (jstats[i], tstats[i]):
            assert st["staged_bytes"] == READS * OBJECT_SIZE
            assert st["checksum_host"] == want
            assert st["checksum_device"] == want % (1 << 32)
        assert jstats[i]["transfers"] == tstats[i]["transfers"]


def test_fault_plan_is_carried_to_the_ports_store():
    cfg_dict = _reference_config("http", "device_put_validate", {})
    cfg_dict["transport"]["fault"].update(read_error_rate=0.5, seed=3)
    _, store = convert.from_reference(cfg_dict, _population())
    assert dataclasses.asdict(store.fault)["read_error_rate"] == 0.5
    assert store.fault.seed == 3


def _hedge_threads():
    return [t for t in threading.enumerate() if t.name.startswith("hedge-")]


def test_tail_tracing_and_telemetry_parity():
    """Tail layers (hedge, watchdog, breaker), tracing and telemetry on
    through both packages over HTTP/1.1. The stores add 200 ms to every
    open, far above the 2 ms hedge delay, so every read (and only a read)
    launches exactly one hedge; no fault fails a request, so the breaker
    never opens and the watchdog (2 s window) never fires. Compared
    exactly: the tail counters but the hedge-win split and the loser's
    wasted bytes (those depend on which racing open answers first), the
    flight summary's structure but its win count, the telemetry counters
    and the span names."""
    fault = dict(latency_s=0.2, seed=5)
    cfg_dict = _reference_config("http", "device_put_validate", {})
    cfg_dict["transport"]["fault"].update(fault)
    cfg_dict["transport"]["tail"].update(
        hedge=True, hedge_delay_s=0.002, watchdog=True, stall_window_s=2.0,
        breaker=True,
    )
    cfg_dict["telemetry"].update(port=0, otlp=True)
    _, tstore = convert.from_reference(cfg_dict, _population())
    jstore = JaxFakeBackend.from_population(
        _population(), fault=JaxFaultPlan(**fault)
    )
    jsrv, tsrv = JaxGcsServer(jstore).start(), FakeGcsServer(tstore).start()
    jtracer, ttracer = JaxRecordingTracer(), RecordingTracer()
    try:
        jcfg = JaxBenchConfig.from_dict(cfg_dict)
        tcfg = BenchConfig.from_dict(cfg_dict)
        jcfg.transport.endpoint, tcfg.transport.endpoint = (
            jsrv.endpoint, tsrv.endpoint
        )
        jres = jax_run_read(
            jcfg, tracer=jtracer,
            sink_factory=jax_staging.make_sink_factory(jcfg),
        ).to_dict()
        tres = run_read(
            tcfg, device="cpu", tracer=ttracer,
            sink_factory=make_sink_factory(tcfg, device="cpu"),
        ).to_dict()
    finally:
        _stop(jsrv)
        _stop(tsrv)
    reads = WORKERS * READS
    assert set(jres["extra"]) == set(tres["extra"])
    je, te = jres["extra"], tres["extra"]
    for e in (je, te):
        assert e["checksum_ok"] is True
        hedge = e["tail"]["hedge"]
        assert hedge["reads"] == hedge["hedges"] == reads
        assert hedge["hedge_wins"] + hedge["hedge_losses"] == reads
        for k in ("hedge_wins", "hedge_losses", "wasted_bytes"):
            hedge.pop(k)
        e["flight"]["tail"].pop("hedge_wins")
    assert je["tail"] == te["tail"]
    assert te["tail"]["breaker"]["opens"] == 0
    assert te["tail"]["watchdog"]["stalls"] == 0
    assert flight_structure(je["flight"]) == flight_structure(te["flight"])
    assert te["flight"]["tail"]["hedges"] == reads
    jt, tt = je["telemetry"], te["telemetry"]
    assert set(jt) == set(tt)
    for e in (jt, tt):
        # The win count rides the counters only when non-zero.
        e["counters"].pop("tpubench_hedge_wins_total", None)
    assert jt["counters"] == tt["counters"]
    assert tt["counters"]["tpubench_reads_total"] == reads
    assert tt["counters"]["tpubench_hedges_total"] == reads
    assert tt["port"] > 0 and tt["otlp"]["payloads"] >= 1
    assert set(jt["otlp"]) == set(tt["otlp"])
    jnames = sorted(s.name for s in jtracer.spans)
    tnames = sorted(s.name for s in ttracer.spans)
    assert jnames == tnames
    assert tnames.count("ReadObject") == reads
    # Every hedge producer has ended (losers stop at their next chunk).
    deadline = time.monotonic() + 2.0
    while _hedge_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _hedge_threads()
