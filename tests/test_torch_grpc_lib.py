"""gRPC library mode of the port (``grpcio`` carrying the port's own
storage-v2 codec) against ``tpubench``'s (grpcio plus the generated
storage-v2 types), on the CPU, with the same seeded inputs.

* Read parity: ``tpubench``'s library-mode client over its grpcio fake
  and the port's over its own, each given an explicit
  ``grpc.insecure_channel``; the store is carried across by
  ``convert.from_reference``. ``run_read`` (validate and pallas staging)
  must give equal bytes, per-worker checksums, staged bytes, transfer
  counts and result keys, exactly (tolerance 0).
* The reader (range read, a granule smaller than a message, the
  first-byte stamp), the object calls and UNAVAILABLE under a fault plan
  through ``RetryingBackend``: the same outcomes in both packages.
* Over the port's repaired wire fake (``fake_grpc_wire_server``, the only
  hermetic server with resumable sessions and upload faults): the stat,
  list, write, read, delete sequence of ``tests/test_gcs_grpc.py`` that
  hangs against ``tpubench``'s copy, a paged listing, and the resumable
  writer, whose outcomes must equal ``tpubench``'s wire writer against
  ``tpubench``'s wire fake; ``ckpt-save`` under upload faults.
* DirectPath's channel, the call credentials, and the mode choice
  (``tpubench``'s: library mode whenever grpcio imports).

The suite has no per-test timeout, so every client call runs under
:func:`bounded` (a deadline that fails the test instead of hanging it),
channels wait for readiness with a ``timeout=``, and every server is
stopped with a grace period.
"""

import os
import sys
import threading

import grpc
import numpy as np
import pytest

import tpubench.storage.gcs_grpc as jax_gcs_grpc
from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.config import RetryConfig as JaxRetryConfig
from tpubench.config import TransportConfig as JaxTransportConfig
from tpubench.staging import device as jax_staging
from tpubench.storage.base import StorageError as JaxStorageError
from tpubench.storage.fake import FakeBackend as JaxFakeBackend
from tpubench.storage.fake import FaultPlan as JaxFaultPlan
from tpubench.storage.fake_grpc_server import (
    FakeGcsGrpcServer as JaxGrpcServer,
)
from tpubench.storage.fake_grpc_wire_server import (
    FakeGrpcWireServer as JaxWireServer,
)
from tpubench.storage.retrying import RetryingBackend as JaxRetryingBackend
from tpubench.workloads import ckpt as jax_ckpt
from tpubench.workloads.read import run_read as jax_run_read

from tpubench_torch import convert
from tpubench_torch.config import BenchConfig, RetryConfig, TransportConfig
from tpubench_torch.staging.device import make_sink_factory
from tpubench_torch.storage import gcs_grpc
from tpubench_torch.storage.auth import StaticTokenSource
from tpubench_torch.storage.base import StorageError, deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.storage.fake_grpc_server import FakeGcsGrpcServer
from tpubench_torch.storage.fake_grpc_wire_server import FakeGrpcWireServer
from tpubench_torch.storage.retrying import RetryingBackend
from tpubench_torch.workloads import ckpt
from tpubench_torch.workloads.read import run_read

OBJECT_SIZE = 777_777  # not a granule multiple: the short-tail path
BIG = 3_000_000  # more than one 2 MiB message
WORKERS = 2
READS = 2
PREFIX = "tpubench/file_"
GRANULE = 64 * 1024
DEADLINE_S = 30.0
PART = 64 * 1024
RESET = 100_000  # mid part 2 of a 3-part upload
SEED = 11

MODES = {
    "device_put_validate": dict(mode="device_put", validate_checksum=True),
    "pallas": dict(mode="pallas"),
}

pytestmark = pytest.mark.filterwarnings("ignore:.*directpath")


def bounded(fn, timeout_s: float = DEADLINE_S):
    """``fn()`` on a daemon thread; fails the test if it has not returned
    after ``timeout_s``."""
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), f"timed out after {timeout_s} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _channel(server) -> grpc.Channel:
    ch = grpc.insecure_channel(server.endpoint.removeprefix("insecure://"))
    grpc.channel_ready_future(ch).result(timeout=10)
    return ch


def _stop(server) -> None:
    """Stop a server: grpcio fakes with a grace period, wire fakes after
    waking their blocked ``accept``."""
    import socket

    sock = getattr(server, "_sock", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    server.stop()


def _population():
    return [(f"{PREFIX}{i}", OBJECT_SIZE, 1) for i in range(WORKERS)] + [
        ("big/0", BIG, 1)
    ]


def _reference_config(mode: str) -> dict:
    cfg = JaxBenchConfig()
    cfg.workload.workers = WORKERS
    cfg.workload.read_calls_per_worker = READS
    cfg.workload.object_size = OBJECT_SIZE
    cfg.workload.granule_bytes = GRANULE
    cfg.workload.bucket = "testbucket"
    cfg.workload.object_name_prefix = PREFIX
    cfg.transport.protocol = "grpc"
    cfg.transport.directpath = False
    cfg.transport.retry.initial_backoff_s = 0.001
    cfg.transport.retry.max_backoff_s = 0.01
    cfg.transport.retry.jitter = False
    cfg.transport.retry.deadline_s = 20.0
    cfg.staging.slot_bytes = 256 * 1024
    for k, v in MODES[mode].items():
        setattr(cfg.staging, k, v)
    return cfg.to_dict()


@pytest.fixture(scope="module")
def lib_servers():
    """``tpubench``'s grpcio fake over a JAX store and the port's over the
    port's store, of one population."""
    jstore = JaxFakeBackend.from_population(_population())
    _, tstore = convert.from_reference(
        _reference_config("pallas"), _population()
    )
    pair = (JaxGrpcServer(jstore).start(), FakeGcsGrpcServer(tstore).start())
    try:
        yield pair
    finally:
        for srv in pair:
            srv.stop()


@pytest.fixture
def lib_clients(lib_servers):
    """A library-mode client of each package on an explicit channel:
    (``tpubench``'s, the port's)."""
    jsrv, tsrv = lib_servers
    jch, tch = _channel(jsrv), _channel(tsrv)
    jb = jax_gcs_grpc.GcsGrpcBackend(
        "testbucket", JaxTransportConfig(endpoint=jsrv.endpoint), channel=jch)
    tb = gcs_grpc.GcsGrpcBackend(
        "testbucket", TransportConfig(endpoint=tsrv.endpoint), channel=tch)
    assert not jb._wire and tb._lib
    try:
        yield jb, tb
    finally:
        jb.close()
        tb.close()
        jch.close()
        tch.close()


class _Recording:
    """Sink wrapper keeping each worker's stager stats."""

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


def _flight_structure(summary: dict) -> dict:
    """A flight summary without its times (as in
    ``test_torch_protocol_parity.py``)."""
    return {
        "keys": sorted(summary),
        "records": summary["records"],
        "stage_records": summary["staging"]["transfers"],
        "stage_bytes": summary["staging"]["transfer_bytes"],
        "errors": summary["errors"],
        "phases": sorted(summary["phases"]),
    }


@pytest.mark.parametrize("mode", list(MODES))
def test_library_read_parity(mode, lib_servers, jax_cpu_devices):
    cfg_dict = _reference_config(mode)
    jcfg = JaxBenchConfig.from_dict(cfg_dict)
    tcfg = BenchConfig.from_dict(cfg_dict)
    jsrv, tsrv = lib_servers
    jcfg.transport.endpoint, tcfg.transport.endpoint = (
        jsrv.endpoint, tsrv.endpoint)
    jch, tch = _channel(jsrv), _channel(tsrv)
    jb = jax_gcs_grpc.GcsGrpcBackend("testbucket", jcfg.transport, channel=jch)
    tb = gcs_grpc.GcsGrpcBackend("testbucket", tcfg.transport, channel=tch)
    jstats, tstats = {}, {}
    try:
        jres = bounded(lambda: jax_run_read(
            jcfg, backend=jb, sink_factory=_recording(
                jax_staging.make_sink_factory(jcfg), jstats))).to_dict()
        tres = bounded(lambda: run_read(
            tcfg, backend=tb, device="cpu", sink_factory=_recording(
                make_sink_factory(tcfg, device="cpu"), tstats))).to_dict()
    finally:
        for c in (jb, tb, jch, tch):
            c.close()
    total = WORKERS * READS * OBJECT_SIZE
    for res in (jres, tres):
        assert res["errors"] == 0
        assert res["bytes_total"] == total
        assert res["extra"]["staged_bytes"] == total
    assert set(jres) == set(tres)
    assert set(jres["extra"]) == set(tres["extra"])
    assert set(jres["summaries"]) == set(tres["summaries"])
    je, te = jres["extra"], tres["extra"]
    assert je.get("checksum_ok") == te.get("checksum_ok")
    assert _flight_structure(je["flight"]) == _flight_structure(te["flight"])
    for name in jres["summaries"]:
        assert (jres["summaries"][name]["count"]
                == tres["summaries"][name]["count"]), name
    assert set(jstats) == set(tstats) == set(range(WORKERS))
    for i in range(WORKERS):
        assert set(jstats[i]) == set(tstats[i])
        for key in ("staged_bytes", "transfers", "slot_bytes", "depth",
                    "checksum_ok", "checksum_host", "checksum_device"):
            assert jstats[i].get(key) == tstats[i].get(key), (i, key)
        if "checksum_host" in tstats[i]:
            byte_sum = int(deterministic_bytes(f"{PREFIX}{i}", OBJECT_SIZE)
                           .sum(dtype=np.uint64))
            assert tstats[i]["checksum_host"] % (1 << 32) == (
                READS * byte_sum % (1 << 32))


def _read(backend, name: str, start: int = 0, length=None,
          granule: int = 1 << 20):
    """(bytes, first-byte stamp) of one read through ``readinto``."""
    r = backend.open_read(name, start=start, length=length)
    out = bytearray()
    buf = memoryview(bytearray(granule))
    try:
        while True:
            n = r.readinto(buf)
            if n <= 0:
                break
            out += buf[:n]
    finally:
        r.close()
    return bytes(out), r.first_byte_ns


@pytest.mark.parametrize("case", ["range", "small_granule", "first_byte"])
def test_reader_cases(case, lib_clients):
    want = deterministic_bytes("big/0", BIG).tobytes()
    if case == "range":
        args, expect = dict(start=1_000_000, length=1_500_000), \
            want[1_000_000:2_500_000]
    elif case == "small_granule":  # leftover message bytes carry over
        args, expect = dict(granule=GRANULE), want
    else:
        args, expect = dict(granule=2 * 1024 * 1024), want
    got = [bounded(lambda b=b: _read(b, "big/0", **args)) for b in lib_clients]
    assert got[0][0] == got[1][0] == expect
    assert got[1][1] is not None and got[1][1] > 0
    assert (got[0][1] is None) == (got[1][1] is None)


def _object_calls(backend) -> list:
    """stat, list, writes of 0, 1,000 and 5,000,000 B each read back,
    delete, then stat of the deleted object."""
    out = []
    m = backend.stat(f"{PREFIX}0")
    out.append(("stat", m.name, m.size, m.generation))
    out.append(("list", [(m.name, m.size) for m in backend.list(PREFIX)]))
    for n in (0, 1000, 5_000_000):
        payload = deterministic_bytes(f"up/{n}", n).tobytes()
        m = backend.write(f"up/{n}", payload)
        got, _ = _read(backend, f"up/{n}")
        out.append(("write", m.name, m.size, got == payload))
        backend.delete(f"up/{n}")
    try:
        backend.stat("up/1000")
        out.append(("stat_deleted", "ok"))
    except (StorageError, JaxStorageError) as e:
        out.append(("stat_deleted", e.code, e.transient))
    return out


def test_object_calls_match_reference(lib_clients):
    jres, tres = (bounded(lambda b=b: _object_calls(b)) for b in lib_clients)
    assert tres == jres
    assert tres[-1] == ("stat_deleted", 404, False)
    assert [o[2:] for o in tres if o[0] == "write"] == [
        (0, True), (1000, True), (5_000_000, True)]


def test_unavailable_is_retried_to_completion():
    """UNAVAILABLE from a seeded fault plan, retried by each package's
    ``RetryingBackend`` until every read completes, with the same
    injected faults in both stores."""
    out = []
    for pkg in ("tpubench", "port"):
        if pkg == "tpubench":
            store = JaxFakeBackend.prepopulated(
                "bench/file_", count=1, size=100_000,
                fault=JaxFaultPlan(error_rate=0.5, seed=3))
            srv = JaxGrpcServer(store).start()
            mk, retrying = jax_gcs_grpc.GcsGrpcBackend, JaxRetryingBackend
            tcfg, rcfg = JaxTransportConfig, JaxRetryConfig
        else:
            store = FakeBackend.prepopulated(
                "bench/file_", count=1, size=100_000,
                fault=FaultPlan(error_rate=0.5, seed=3))
            srv = FakeGcsGrpcServer(store).start()
            mk, retrying = gcs_grpc.GcsGrpcBackend, RetryingBackend
            tcfg, rcfg = TransportConfig, RetryConfig
        ch = _channel(srv)
        raw = mk("b", tcfg(endpoint=srv.endpoint), channel=ch)
        rb = retrying(raw, rcfg(jitter=False, initial_backoff_s=0.0,
                                max_backoff_s=0.0, max_attempts=100))
        try:
            totals = bounded(lambda: [
                len(_read(rb, "bench/file_0", granule=GRANULE)[0])
                for _ in range(5)])
        finally:
            raw.close()
            ch.close()
            srv.stop()
        out.append((totals, store.injected_errors, store.open_count))
    assert out[0] == out[1]
    assert out[1][0] == [100_000] * 5 and out[1][1] > 0


# ---------------------------------------------------- the repaired wire fake --
@pytest.fixture
def wire_lib():
    """The port's library-mode client on a channel to the port's wire
    fake (3 objects of 3,000,000 B), with the store."""
    store = FakeBackend.prepopulated("bench/file_", count=3, size=BIG)
    srv = FakeGrpcWireServer(store).start()
    ch = _channel(srv)
    c = gcs_grpc.GcsGrpcBackend(
        "testbucket", TransportConfig(endpoint=srv.endpoint), channel=ch)
    try:
        yield c, store
    finally:
        c.close()
        ch.close()
        _stop(srv)


def test_stat_list_write_delete_over_wire_fake(wire_lib):
    """The sequence of ``tests/test_gcs_grpc.py::
    test_stat_list_write_delete`` (a grpcio client, the wire fake, a
    5 MB write), which stalls against ``tpubench``'s wire fake."""
    c, _ = wire_lib

    def run():
        assert c.stat("bench/file_0").size == BIG
        assert len(c.list("bench/")) == 3
        payload = deterministic_bytes("up/1", 5_000_000).tobytes()
        assert c.write("up/1", payload).size == 5_000_000
        assert _read(c, "up/1")[0] == payload
        c.delete("up/1")
        with pytest.raises(StorageError) as ei:
            c.stat("up/1")
        return ei.value

    err = bounded(run)
    assert err.code == 404 and not err.transient


def test_library_list_follows_every_page_over_wire_fake():
    store = FakeBackend.prepopulated("m/", 40, 100)
    srv = FakeGrpcWireServer(store).start()
    ch = _channel(srv)
    c = gcs_grpc.GcsGrpcBackend(
        "b", TransportConfig(endpoint=srv.endpoint), channel=ch)
    pages = []
    stub = c._stubs[0]["list"]

    def counted(req):
        pages.append(req.page_token)
        return stub(req)

    c._stubs[0]["list"] = counted
    try:
        names = bounded(lambda: [m.name for m in c.list("m/", page_size=16)])
    finally:
        c.close()
        ch.close()
        _stop(srv)
    assert names == [m.name for m in store.list("m/")] and len(names) == 40
    assert pages == ["", "16", "32"]


def _writer_sequence(be) -> list:
    """A resumable upload of 3 parts under a reset mid part 2, finalized
    twice, then the ifGenerationMatch=0 refusals, each outcome recorded."""
    out = []

    def rec(label, fn):
        try:
            r = fn()
        except (StorageError, JaxStorageError) as e:
            out.append((label, "err", e.code, e.transient))
            return None
        out.append((label, "ok", r))
        return r

    meta = lambda m: (m.name, m.size, m.generation)  # noqa: E731
    data = deterministic_bytes("w/b", 3 * PART)
    w = be.open_write("w/b", if_generation_match=0)
    for k in range(3):
        rec(f"part{k}", lambda: w.write(data[k * PART:(k + 1) * PART]))
    first = w.finalize()
    rec("finalize", lambda: meta(first))
    rec("finalize_again", lambda: w.finalize() is first)
    rec("resumed_parts", lambda: w.resumed_parts)
    rec("committed", lambda: w.committed())
    rec("media_412", lambda: be.write("w/b", b"x", if_generation_match=0))
    w2 = be.open_write("w/b", if_generation_match=0)
    rec("part_412", lambda: w2.write(b"y" * 10))
    rec("finalize_412", lambda: meta(w2.finalize()))
    rec("stored", lambda: _read(be, "w/b")[0] == data.tobytes())
    return out


def test_lib_writer_matches_reference_wire_writer(monkeypatch):
    """``_LibBidiWriter`` under ``_ResumingWriter`` against the port's
    wire fake, and ``tpubench``'s ``_WireBidiWriter`` against its own
    wire fake, under the same upload reset: the same acks, committed
    sizes, metadata and 412s."""
    monkeypatch.setattr(jax_gcs_grpc, "_HAVE_LIB", False)
    retry = dict(initial_backoff_s=0.001, max_backoff_s=0.01,
                 policy="idempotent", max_attempts=6, deadline_s=10.0)
    jstore = JaxFakeBackend(fault=JaxFaultPlan(
        upload_reset_after_bytes=RESET, seed=SEED))
    jsrv = JaxWireServer(jstore).start()
    jraw = jax_gcs_grpc.GcsGrpcBackend(
        "b", JaxTransportConfig(endpoint=jsrv.endpoint))
    assert jraw._wire
    tstore = FakeBackend(fault=FaultPlan(
        upload_reset_after_bytes=RESET, seed=SEED))
    tsrv = FakeGrpcWireServer(tstore).start()
    tch = _channel(tsrv)
    traw = gcs_grpc.GcsGrpcBackend(
        "b", TransportConfig(endpoint=tsrv.endpoint), channel=tch)
    assert traw._lib
    writers = []
    real_open = gcs_grpc.GcsGrpcBackend.open_write

    def noting(self, *a, **k):
        w = real_open(self, *a, **k)
        writers.append(w)
        return w

    monkeypatch.setattr(gcs_grpc.GcsGrpcBackend, "open_write", noting)
    try:
        ref = bounded(lambda: _writer_sequence(
            JaxRetryingBackend(jraw, JaxRetryConfig(**retry))))
        port = bounded(lambda: _writer_sequence(
            RetryingBackend(traw, RetryConfig(**retry))))
    finally:
        jraw.close()
        traw.close()
        tch.close()
        _stop(jsrv)
        _stop(tsrv)
    assert port == ref
    got = dict((o[0], o[1:]) for o in port)
    assert [got[f"part{k}"] for k in range(3)] == [
        ("ok", (k + 1) * PART) for k in range(3)]  # lockstep acks
    assert got["finalize"] == ("ok", ("w/b", 3 * PART, 1))
    assert got["finalize_again"] == ("ok", True)
    assert got["resumed_parts"] == ("ok", 1)
    assert got["committed"] == ("ok", 3 * PART)
    for label in ("media_412", "finalize_412"):
        assert got[label] == ("err", 412, False)
    assert got["stored"] == ("ok", True)
    assert writers and all(isinstance(w, gcs_grpc._LibBidiWriter)
                           for w in writers)


def test_lib_writer_committed_after_a_broken_stream(wire_lib):
    """A stream torn down mid-upload: ``committed()`` reports the server's
    watermark over QueryWriteStatus, and the upload resumes from it on a
    fresh stream."""
    c, store = wire_lib
    data = deterministic_bytes("w/c", 3 * PART).tobytes()

    def run():
        w = c.open_write("w/c")
        assert w.write(data[:PART]) == PART
        w._break_stream()
        assert w._stream is None and w.committed() == PART
        assert w.write(data[PART:]) == 3 * PART
        meta = w.finalize()
        assert w.finalize() is meta
        return meta, _read(c, "w/c")[0]

    meta, stored = bounded(run)
    assert (meta.name, meta.size) == ("w/c", 3 * PART) and stored == data


def _ckpt_cfg(p_config):
    cfg = p_config.BenchConfig()
    cfg.transport.protocol = "grpc"
    cfg.obs.flight_records = 0
    lc = cfg.lifecycle
    lc.objects, lc.object_bytes, lc.part_bytes = 2, 200_003, PART
    lc.writers = lc.readers = 2
    return cfg


def test_ckpt_save_under_upload_faults_over_lib_writer(monkeypatch):
    """``ckpt-save`` through library mode's resumable writer against the
    port's wire fake with the upload reset on the wire: every object
    verified, no corrupt finalize, the same parts as ``tpubench``'s wire
    writer against its own wire fake, and at least its resumed parts (the
    wire client holds one connection per call, grpcio one for all)."""
    monkeypatch.setattr(jax_gcs_grpc, "_HAVE_LIB", False)
    retry = dict(initial_backoff_s=0.001, max_backoff_s=0.01, max_attempts=6,
                 deadline_s=20.0)
    out = {}
    for pkg in ("tpubench", "port"):
        if pkg == "tpubench":
            from tpubench import config as pcfg

            store = JaxFakeBackend(fault=JaxFaultPlan(
                upload_reset_after_bytes=RESET, seed=SEED))
            srv, ch = JaxWireServer(store).start(), None
            raw = jax_gcs_grpc.GcsGrpcBackend(
                "b", JaxTransportConfig(endpoint=srv.endpoint))
            be, run = JaxRetryingBackend(raw, JaxRetryConfig(**retry)), \
                jax_ckpt.run_ckpt_save
        else:
            from tpubench_torch import config as pcfg

            store = FakeBackend(fault=FaultPlan(
                upload_reset_after_bytes=RESET, seed=SEED))
            srv = FakeGrpcWireServer(store).start()
            ch = _channel(srv)
            raw = gcs_grpc.GcsGrpcBackend(
                "b", TransportConfig(endpoint=srv.endpoint), channel=ch)
            be, run = RetryingBackend(raw, RetryConfig(**retry)), \
                ckpt.run_ckpt_save
        try:
            res = bounded(lambda: run(_ckpt_cfg(pcfg), backend=be), 60.0)
        finally:
            raw.close()
            if ch is not None:
                ch.close()
            _stop(srv)
        lc = res.extra["lifecycle"]
        out[pkg] = (res.errors, {k: lc[k] for k in (
            "verified", "corrupt_finalizes", "parts", "resumed_parts")})
    (jerr, jlc), (err, lc) = out["tpubench"], out["port"]
    assert err == jerr == 0
    assert lc["verified"] is jlc["verified"] is True
    assert lc["corrupt_finalizes"] == jlc["corrupt_finalizes"] == 0
    assert lc["parts"] == jlc["parts"]
    # Every session meets its reset; grpcio multiplexes both writers on
    # one connection, so a reset may also break the other writer's part.
    assert lc["resumed_parts"] >= jlc["resumed_parts"] == 2


# ------------------------------------------- channels, auth, mode choice --
def test_directpath_builds_c2p_channel(monkeypatch):
    """``transport.directpath`` on the default endpoint builds the
    ``google-c2p`` resolver channel with compute-engine credentials, the
    env var set only around its creation, as ``tpubench``'s does."""
    import google.auth

    captured = {}

    def fake_secure_channel(target, creds, opts=None):
        captured["target"] = target
        captured["env"] = os.environ.get("GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS")
        return grpc.insecure_channel("127.0.0.1:1")  # never used

    class _Creds:
        valid, token = True, "stub-token"

    monkeypatch.delenv("GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS", raising=False)
    monkeypatch.setattr(google.auth, "default", lambda **_k: (_Creds(), "p"))
    monkeypatch.setattr(grpc, "secure_channel", fake_secure_channel)
    monkeypatch.setattr(grpc, "compute_engine_channel_credentials",
                        lambda call_creds: grpc.ssl_channel_credentials())
    c = gcs_grpc.GcsGrpcBackend("b", TransportConfig(directpath=True))
    try:
        assert c._lib
        assert captured["target"] == "google-c2p:///storage.googleapis.com"
        assert captured["env"] == "true"
        assert os.environ.get("GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS") is None
    finally:
        c.close()


def test_call_credentials_carry_the_bearer_token():
    """The call credentials' plugin puts the token source's token on the
    call as ``authorization: Bearer <tok>``, and nothing without one."""
    ch = grpc.insecure_channel("127.0.0.1:1")  # never connected
    c = gcs_grpc.GcsGrpcBackend(
        "b", TransportConfig(endpoint="insecure://127.0.0.1:1"), channel=ch)
    got = []
    try:
        c._tokens_obj = StaticTokenSource("tok-123")
        assert isinstance(c._auth_plugin(), grpc.AuthMetadataPlugin)
        c._auth_plugin()(None, lambda md, err: got.append((md, err)))
        c._tokens_obj = StaticTokenSource("tok-123", ttl_s=-1.0)
        c._auth_plugin()(None, lambda md, err: got.append((md, err)))
        assert isinstance(c._call_credentials(), grpc.CallCredentials)
    finally:
        c.close()
        ch.close()
    assert got == [((("authorization", "Bearer tok-123"),), None), ((), None)]


def test_mode_choice_by_endpoint(wire_lib, monkeypatch):
    """The mode is chosen as ``tpubench`` chooses it, whatever the
    endpoint: with grpcio importable a test server's endpoint is library
    mode in both packages; with the switch pinned off (a machine without
    grpcio) it is wire mode, and reads the same object."""
    c, store = wire_lib
    ep = c.transport.endpoint
    lib = gcs_grpc.GcsGrpcBackend("testbucket", TransportConfig(endpoint=ep))
    try:
        assert lib._lib and lib._owns_channels and lib._stubs
        assert bounded(lambda: lib.stat("bench/file_0").size) == BIG
    finally:
        lib.close()
    assert c._lib and not c._owns_channels
    assert not jax_gcs_grpc.GcsGrpcBackend(
        "b", JaxTransportConfig(endpoint=ep))._wire
    monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", False)
    wire = gcs_grpc.GcsGrpcBackend("testbucket", TransportConfig(endpoint=ep))
    try:
        assert not wire._lib and not hasattr(wire, "_stubs")
        assert bounded(lambda: wire.stat("bench/file_0").size) == BIG
    finally:
        wire.close()


@pytest.mark.parametrize("blocked, named", [
    ("grpc", "grpcio"),
    # The module switch pinned to wire mode stands for the same machine.
    ("_HAVE_LIB", "grpcio"),
])
@pytest.mark.parametrize("where", ["default_endpoint", "channel"])
def test_library_mode_refused_naming_the_missing_package(
        blocked, named, where, monkeypatch):
    """Where library mode is needed (Google's endpoint, an explicit
    channel) and grpcio does not import, the constructor raises a
    non-transient ``StorageError`` naming it, before any channel or token
    source is built; it never falls back to wire mode."""
    import google.auth

    def no_adc(*_a, **_k):
        raise AssertionError("the token source was built")

    monkeypatch.setattr(google.auth, "default", no_adc)
    if blocked == "_HAVE_LIB":
        monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", False)
    else:
        monkeypatch.setitem(sys.modules, blocked, None)  # its import fails
    channel = object() if where == "channel" else None
    with pytest.raises(StorageError, match=f"{named} does not import") as ei:
        gcs_grpc.GcsGrpcBackend("b", TransportConfig(), channel=channel)
    assert not ei.value.transient


@pytest.mark.parametrize("where", ["default_endpoint", "channel"])
def test_library_mode_needs_no_storage_v2_types(where, monkeypatch):
    """The card's machine has grpcio and not ``google.cloud._storage_v2``:
    library mode is built all the same, on Google's endpoint (its
    channel made, nothing dialled) and on an explicit channel."""
    import google.auth

    class _Creds:
        valid, token = True, "stub-token"

    monkeypatch.setattr(google.auth, "default", lambda **_k: (_Creds(), "p"))
    monkeypatch.setitem(sys.modules, "google.cloud._storage_v2", None)
    ch = grpc.insecure_channel("127.0.0.1:1") if where == "channel" else None
    c = gcs_grpc.GcsGrpcBackend(
        "b", TransportConfig(directpath=False), channel=ch)
    try:
        assert c._lib and set(c._stubs[0]) == set(gcs_grpc._METHODS)
    finally:
        c.close()
        if ch is not None:
            ch.close()


def test_wire_fake_hpack_decoder_keeps_the_dynamic_table():
    """RFC 7541 Appendix C.3: three requests on one connection, the later
    ones naming entries the earlier ones inserted; then a size update to
    0 empties the table."""
    from tpubench_torch.storage.fake_grpc_wire_server import _HpackDecoder

    dec = _HpackDecoder()
    blocks = [
        "828684410f7777772e6578616d706c652e636f6d",
        "828684be58086e6f2d6361636865",
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
    ]
    got = [dec.decode(bytes.fromhex(b)) for b in blocks]
    base = {":method": "GET", ":authority": "www.example.com"}
    assert got == [
        {**base, ":scheme": "http", ":path": "/"},
        {**base, ":scheme": "http", ":path": "/", "cache-control": "no-cache"},
        {**base, ":scheme": "https", ":path": "/index.html",
         "custom-key": "custom-value"},
    ]
    assert dec._size == 164  # the RFC's table size after C.3.3
    assert dec.decode(b"\x20") == {} and dec._table == []
    with pytest.raises(Exception, match="not in the table"):
        dec.decode(b"\xbe")


def test_wire_fake_answers_an_undecodable_header_block():
    """A header block the fake cannot decode is answered with error
    trailers (grpc-status 13) and GOAWAY, never left unanswered."""
    import socket
    import struct

    from tpubench_torch.storage.fake_h2_server import (
        _PREFACE,
        decode_request_headers,
    )

    srv = FakeGrpcWireServer(FakeBackend()).start()
    host, _, port = srv.endpoint.removeprefix("insecure://").partition(":")
    frames = []
    try:
        with socket.create_connection((host, int(port)), timeout=10) as s:
            def frame(ftype, flags, sid, payload=b""):
                s.sendall(struct.pack("!I", len(payload))[1:]
                          + bytes([ftype, flags]) + struct.pack("!I", sid)
                          + payload)

            s.sendall(_PREFACE)
            frame(4, 0, 0)  # SETTINGS
            frame(1, 0x4 | 0x1, 1, b"\xff\x80\x01")  # index 1,090: none
            buf = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        while len(buf) >= 9:
            n = int.from_bytes(buf[:3], "big")
            frames.append((buf[3], int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF,
                           buf[9:9 + n]))
            buf = buf[9 + n:]
    finally:
        _stop(srv)
    trailers = [decode_request_headers(p) for t, sid, p in frames
                if t == 1 and sid == 1]
    assert trailers and trailers[0]["grpc-status"] == "13"
    goaway = [p for t, _, p in frames if t == 7]
    assert goaway and struct.unpack("!II", goaway[0][:8]) == (1, 0x9)


def test_wire_fake_keeps_to_the_clients_windows():
    """The wire fake sends DATA only within the client's windows (RFC
    7540 §6.9): a client advertising a 1,000-byte stream window gets at
    most 1,000 bytes of a 100,000-byte ReadObject until it grants more,
    then the rest, up to the trailers. A grpcio client whose window the
    fake overran reset the stream (``frame of size ... overflows local
    window``)."""
    import socket
    import struct
    import time

    from tpubench_torch.storage.fake_h2_server import (
        _PREFACE,
        _hp_literal,
        decode_request_headers,
    )
    from tpubench_torch.storage.grpc_wire import proto
    from tpubench_torch.storage.grpc_wire.framing import encode_frame

    size, window = 100_000, 1_000
    store = FakeBackend.prepopulated("f/", 1, size)
    srv = FakeGrpcWireServer(store).start()
    host, _, port = srv.endpoint.removeprefix("insecure://").partition(":")
    got = {"data": 0, "trailers": None}
    try:
        with socket.create_connection((host, int(port)), timeout=10) as s:
            def frame(ftype, flags, sid, payload=b""):
                s.sendall(struct.pack("!I", len(payload))[1:]
                          + bytes([ftype, flags]) + struct.pack("!I", sid)
                          + payload)

            def read_frames(seconds: float) -> None:
                buf, end = b"", time.monotonic() + seconds
                s.settimeout(0.1)
                while time.monotonic() < end and got["trailers"] is None:
                    try:
                        chunk = s.recv(65536)
                    except socket.timeout:
                        continue
                    if not chunk:
                        break
                    buf += chunk
                    while len(buf) >= 9 and len(buf) >= 9 + int.from_bytes(
                            buf[:3], "big"):
                        n = int.from_bytes(buf[:3], "big")
                        ftype, flags = buf[3], buf[4]
                        sid = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
                        if ftype == 0 and sid == 1:
                            got["data"] += n
                        elif ftype == 1 and sid == 1 and flags & 0x1:
                            got["trailers"] = decode_request_headers(
                                buf[9:9 + n])
                        buf = buf[9 + n:]

            s.sendall(_PREFACE)
            frame(4, 0, 0, struct.pack("!HI", 0x4, window))  # SETTINGS
            frame(1, 0x4, 1, b"".join(_hp_literal(k, v) for k, v in (
                (":method", "POST"), (":scheme", "http"),
                (":path", "/google.storage.v2.Storage/ReadObject"),
                (":authority", "fake"), ("content-type", "application/grpc"),
                ("te", "trailers"))))
            frame(0, 0x1, 1, encode_frame(proto.ReadObjectRequest(
                bucket="projects/_/buckets/b", object="f/0").encode()))
            read_frames(0.5)
            held = got["data"]
            frame(8, 0, 0, struct.pack("!I", 1 << 20))  # connection
            frame(8, 0, 1, struct.pack("!I", 1 << 20))  # stream
            read_frames(10.0)
    finally:
        _stop(srv)
    assert 0 < held <= window
    assert got["trailers"] is not None
    assert got["trailers"]["grpc-status"] == "0"
    assert got["data"] > size


def test_wire_fake_writes_without_nagle(monkeypatch):
    """Every connection the wire fake accepts has ``TCP_NODELAY`` set: a
    response is several small writes, and under Nagle each waited out
    the client's delayed ACK (about 40 ms a unary call on the one
    connection grpcio keeps open)."""
    import socket

    from tpubench_torch.storage import fake_grpc_wire_server as fw

    seen = []
    init = fw._GrpcConn.__init__

    def noting(self, sock, backend):
        seen.append(sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY))
        init(self, sock, backend)

    monkeypatch.setattr(fw._GrpcConn, "__init__", noting)
    store = FakeBackend.prepopulated("m/", 2, 4096)
    srv = FakeGrpcWireServer(store).start()
    ch = _channel(srv)
    c = gcs_grpc.GcsGrpcBackend(
        "b", TransportConfig(endpoint=srv.endpoint), channel=ch)
    try:
        assert bounded(lambda: [c.stat(f"m/{i % 2}").size
                                for i in range(4)]) == [4096] * 4
    finally:
        c.close()
        ch.close()
        _stop(srv)
    assert seen and all(seen)


def test_wire_fake_forgets_finished_calls(monkeypatch):
    """A call's stream and send window leave the wire fake's connection
    when the call ends: 40 calls on the one connection grpcio keeps open
    leave none behind (a map that only RST_STREAM emptied grew by one
    entry a call, and each SETTINGS walked all of them)."""
    import time

    from tpubench_torch.storage import fake_grpc_wire_server as fw

    conns = []
    init = fw._GrpcConn.__init__

    def noting(self, sock, backend):
        init(self, sock, backend)
        conns.append(self)

    monkeypatch.setattr(fw._GrpcConn, "__init__", noting)
    store = FakeBackend.prepopulated("m/", 2, 4096)
    srv = FakeGrpcWireServer(store).start()
    ch = _channel(srv)
    c = gcs_grpc.GcsGrpcBackend(
        "b", TransportConfig(endpoint=srv.endpoint), channel=ch)
    try:
        assert bounded(lambda: [c.stat(f"m/{i % 2}").size
                                for i in range(40)]) == [4096] * 40
        assert bounded(lambda: _read(c, "m/0"))[0] == deterministic_bytes(
            "m/0", 4096).tobytes()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and any(
                cn._streams or cn._stream_send for cn in conns):
            time.sleep(0.01)
        assert len(conns) == 1
        assert conns[0]._streams == {} and conns[0]._stream_send == {}
    finally:
        c.close()
        ch.close()
        _stop(srv)
