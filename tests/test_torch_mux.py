"""The multiplexed shard fetch of the port against ``tpubench``'s: the
counterparts of ``tests/test_h2.py``'s ``read_ranges`` and mux tests,
each running both packages' clients against the port's own fake h2c and
wire-gRPC servers and comparing what they return: the landed bytes, the
per-range verdicts (transient or not, and the message), the pool's
connection accounting. Then ``pod-ingest`` over both mux modes in both
packages (``tpubench`` on 8 simulated JAX CPU devices, 8 local shards;
the port at one rank, whose shard it fetches as the same 8 ranges):
``verified``, bytes, holes and the pod checksum of every collective call
must be equal, and the fetch must take one connection.

Both packages pick gRPC library mode whenever ``grpcio`` imports; these
tests hold the native and wire clients, so both sides are held to wire
mode here by patching each package's ``gcs_grpc._HAVE_LIB``."""

import socket
import threading
import time
import urllib.parse

import numpy as np
import pytest

import tpubench.storage.gcs_grpc as jax_gcs_grpc
import tpubench.storage.gcs_http as jax_gcs_http
from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.config import TransportConfig as JaxTransportConfig
from tpubench.dist.shard import ShardTable as JaxShardTable
from tpubench.native.engine import get_engine as jax_get_engine
from tpubench.storage.base import StorageError as JaxStorageError
from tpubench.workloads import common as jax_common
from tpubench.workloads import pod_ingest as jax_pod

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, TransportConfig
from tpubench_torch.dist import bringup
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.native.engine import get_engine
from tpubench_torch.storage import base_backend, open_backend
from tpubench_torch.storage import gcs_grpc
from tpubench_torch.storage.base import StorageError, deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.storage.fake_grpc_wire_server import FakeGrpcWireServer
from tpubench_torch.storage.fake_h2_server import FakeH2Server
from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend
from tpubench_torch.storage.gcs_http import GcsHttpBackend
from tpubench_torch.workloads import common, pod_ingest

H2_SIZE, GRPC_SIZE = 400_000, 3_000_000
PREFIX = "bench/file_"

pytestmark = pytest.mark.filterwarnings("ignore:.*directpath")


@pytest.fixture(autouse=True)
def _wire_mode(monkeypatch):
    monkeypatch.setattr(jax_gcs_grpc, "_HAVE_LIB", False)
    monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", False)


@pytest.fixture(scope="module")
def h2srv():
    with FakeH2Server(FakeBackend.prepopulated(PREFIX, 4, H2_SIZE)) as srv:
        yield srv


@pytest.fixture(scope="module")
def grpcsrv():
    with FakeGrpcWireServer(FakeBackend.prepopulated(PREFIX, 4, GRPC_SIZE)) as srv:
        yield srv


def _h2_clients(srv):
    """``(tpubench's, the port's)`` whole-client HTTP/2 backend."""
    return (
        jax_gcs_http.GcsHttpBackend(bucket="b", transport=JaxTransportConfig(
            endpoint=srv.endpoint, http2=True)),
        GcsHttpBackend("b", TransportConfig(endpoint=srv.endpoint, http2=True)),
    )


def _grpc_clients(srv):
    kw = dict(protocol="grpc", endpoint=srv.endpoint, native_receive=True,
              directpath=False)
    return (
        jax_gcs_grpc.GcsGrpcBackend(bucket="b",
                                    transport=JaxTransportConfig(**kw)),
        GcsGrpcBackend("b", TransportConfig(**kw)),
    )


def _pool(client):
    return client._h2_pool() if hasattr(client, "_h2_pool") else client._native_pool()


def _verdicts(errs):
    return [None if e is None else (e.transient, str(e)) for e in errs]


def _both_read_ranges(clients, name, ranges):
    """Each client's per-range verdicts and landed buffers."""
    out = []
    for c in clients:
        bufs = [np.zeros(ln, dtype=np.uint8) for _, ln in ranges]
        out.append((_verdicts(c.read_ranges(name, ranges, bufs)), bufs))
    return out


def _hostport(endpoint):
    u = urllib.parse.urlsplit(endpoint.replace("insecure://", "http://"))
    return u.hostname, u.port


# ------------------------------------------------------- HTTP/2 ranges --


def test_backend_http2_read_ranges_multiplexed(h2srv):
    clients = _h2_clients(h2srv)
    want = deterministic_bytes(f"{PREFIX}0", H2_SIZE)
    ranges = [(0, 1000), (100_000, 2000), (399_000, 1000)]
    (ref, ref_bufs), (got, bufs) = _both_read_ranges(clients, f"{PREFIX}0",
                                                     ranges)
    assert got == ref == [None, None, None]
    for (start, ln), b, rb in zip(ranges, bufs, ref_bufs):
        assert b.tobytes() == rb.tobytes() == want[start:start + ln].tobytes()
    assert [_pool(c).stats for c in clients] == [
        {"connects": 1, "reuses": 0, "stale_retries": 0}] * 2
    for c in clients:
        c.close()


def test_backend_http2_read_ranges_eof_clamp_permanent(h2srv):
    """A range past EOF, clamped by the server, is permanent (stat on the
    cache miss) and names EOF — the same verdict in both packages."""
    clients = _h2_clients(h2srv)
    (ref, _), (got, _) = _both_read_ranges(
        clients, f"{PREFIX}1", [(0, 1000), (H2_SIZE - 300, 1000)])
    assert got == ref
    assert got[0] is None and got[1][0] is False and "EOF" in got[1][1]
    for c in clients:
        c.close()


def _dead_fd() -> int:
    """A connected socket whose peer has closed, as a bare descriptor."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    s = socket.socket()
    s.connect(lst.getsockname())
    conn, _ = lst.accept()
    conn.close()
    lst.close()
    return s.detach()


def test_backend_http2_read_ranges_stale_batch_retransmit(h2srv):
    """A pooled h2 connection that died idle fails the batch's first use
    before any completion: the whole batch is sent once more on a fresh
    connection."""
    clients = _h2_clients(h2srv)
    pools = [_pool(c) for c in clients]
    pools[0].idle.append(jax_get_engine().conn_plain(_dead_fd()))
    pools[1].idle.append(get_engine().lib.tb_conn_plain(_dead_fd()))
    want = deterministic_bytes(f"{PREFIX}2", H2_SIZE)
    ranges = [(0, 1000), (5000, 1000)]
    (ref, ref_bufs), (got, bufs) = _both_read_ranges(clients, f"{PREFIX}2",
                                                     ranges)
    assert got == ref == [None, None]
    for (start, ln), b, rb in zip(ranges, bufs, ref_bufs):
        assert b.tobytes() == rb.tobytes() == want[start:start + ln].tobytes()
    assert [p.stats["stale_retries"] for p in pools] == [1, 1]
    for c in clients:
        c.close()


def test_backend_http2_read_ranges_concurrent_batches(h2srv):
    """Two threads, one backend, one batch each: each batch holds its own
    pooled connection and lands exactly (both packages)."""
    for c in _h2_clients(h2srv):
        results = {}

        def batch(tid, obj, c=c, results=results):
            want = deterministic_bytes(obj, H2_SIZE)
            ranges = [(i * 50_000, 50_000) for i in range(8)]
            bufs = [np.zeros(50_000, dtype=np.uint8) for _ in ranges]
            errs = c.read_ranges(obj, ranges, bufs)
            results[tid] = errs == [None] * 8 and all(
                b.tobytes() == want[s:s + 50_000].tobytes()
                for (s, _), b in zip(ranges, bufs))

        ts = [threading.Thread(target=batch, args=(k, f"{PREFIX}{k}"))
              for k in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert results == {0: True, 1: True}
        c.close()


def test_read_ranges_rejects_unusable_buffers(h2srv):
    """The engine writes through a raw pointer: a read-only or short
    buffer is refused before any request, as in ``tpubench``."""
    for c in _h2_clients(h2srv):
        with pytest.raises(ValueError, match="writable"):
            c.read_ranges(f"{PREFIX}0", [(0, 10)], [bytes(10)])
        with pytest.raises(ValueError, match="< length"):
            c.read_ranges(f"{PREFIX}0", [(0, 10)], [np.zeros(5, np.uint8)])
        c.close()


# --------------------------------------------------------- gRPC ranges --


def test_grpc_multiplexed_streams_roundtrip(grpcsrv):
    """4 ReadObject streams at once on ONE connection (bodies of several
    2 MiB messages): each lands whole — the port's engine binding and
    ``tpubench``'s, over the same engine code."""
    host, port = _hostport(grpcsrv.endpoint)
    for eng in (jax_get_engine(), get_engine()):
        h = eng.connect(host, port)
        try:
            bufs = {i: eng.alloc(3_100_000) for i in range(4)}
            for i in range(4):
                eng.grpc_submit(h, f"{host}:{port}", "projects/_/buckets/b",
                                f"{PREFIX}{i}", bufs[i], tag=i)
            tags = []
            for _ in range(4):
                c = eng.h2_poll(h)
                assert c is not None and c["result"] == GRPC_SIZE, c
                i = c["tag"]
                tags.append(i)
                want = deterministic_bytes(f"{PREFIX}{i}", GRPC_SIZE).tobytes()
                assert bytes(bufs[i].view(GRPC_SIZE)) == want
            assert sorted(tags) == [0, 1, 2, 3]
            assert eng.h2_poll(h) is None
            for b in bufs.values():
                b.free()
        finally:
            eng.conn_close(h)


def test_grpc_read_ranges_backend(grpcsrv):
    """Every range of one object on ONE connection; the connection goes
    back to the pool and the next batch reuses it."""
    clients = _grpc_clients(grpcsrv)
    n, shard = 6, GRPC_SIZE // 6
    ranges = [(i * shard, shard) for i in range(n)]
    want = deterministic_bytes(f"{PREFIX}0", GRPC_SIZE)
    (ref, ref_bufs), (got, bufs) = _both_read_ranges(clients, f"{PREFIX}0",
                                                     ranges)
    assert got == ref == [None] * n
    for i in range(n):
        assert (bufs[i].tobytes() == ref_bufs[i].tobytes()
                == want[i * shard:(i + 1) * shard].tobytes())
    (ref, _), (got, _) = _both_read_ranges(clients, f"{PREFIX}1", ranges)
    assert got == ref == [None] * n
    assert [_pool(c).stats for c in clients] == [
        {"connects": 1, "reuses": 1, "stale_retries": 0}] * 2
    for c in clients:
        c.close()


def test_grpc_read_ranges_per_range_failure_isolated(grpcsrv):
    """A range past EOF fails alone (permanent, after an inline stat);
    its neighbours land intact on the same connection."""
    clients = _grpc_clients(grpcsrv)
    ranges = [(0, 1000), (GRPC_SIZE - 500, 1000), (2000, 1000)]
    (ref, ref_bufs), (got, bufs) = _both_read_ranges(clients, f"{PREFIX}0",
                                                     ranges)
    assert got == ref
    assert got[0] is None and got[2] is None and got[1][0] is False
    want = deterministic_bytes(f"{PREFIX}0", GRPC_SIZE)
    assert bufs[0].tobytes() == ref_bufs[0].tobytes() == want[:1000].tobytes()
    assert bufs[2].tobytes() == want[2000:3000].tobytes()
    for c in clients:
        c.close()


def test_grpc_read_ranges_eof_short_is_permanent(grpcsrv):
    """A short stream ending at the known size (stat primed) is a clamp
    every retry reproduces: permanent, named EOF."""
    clients = _grpc_clients(grpcsrv)
    for c in clients:
        c.stat(f"{PREFIX}0")
    (ref, _), (got, _) = _both_read_ranges(
        clients, f"{PREFIX}0", [(0, 1000), (GRPC_SIZE - 400, 1000)])
    assert got == ref
    assert got[0] is None and got[1][0] is False and "EOF" in got[1][1]
    for c in clients:
        c.close()


def test_grpc_read_ranges_eof_clamp_classified_on_cache_miss(grpcsrv):
    """A bare caller (no stat primed): the classifier stats inline and
    still calls the clamp permanent."""
    clients = _grpc_clients(grpcsrv)
    (ref, _), (got, _) = _both_read_ranges(clients, f"{PREFIX}0",
                                           [(GRPC_SIZE - 400, 1000)])
    assert got == ref
    assert got[0][0] is False and "EOF" in got[0][1]
    for c in clients:
        c.close()


# ---------------------------------------------------- fetch_shards_mux --


def test_fetch_shards_mux_gate(h2srv):
    """The gate admits the two capable configs and answers ``None`` for
    everything else (the caller then fans out threads), as in
    ``tpubench``."""
    cfg, jcfg = BenchConfig(), JaxBenchConfig()
    table = ShardTable.build(object_size=2000, n_shards=2, align=1)
    jtable = JaxShardTable.build(object_size=2000, n_shards=2, align=1)
    plain = GcsHttpBackend("b", TransportConfig(endpoint=h2srv.endpoint))
    jplain = jax_gcs_http.GcsHttpBackend(
        bucket="b", transport=JaxTransportConfig(endpoint=h2srv.endpoint))
    bufs = [np.zeros(1000, dtype=np.uint8) for _ in range(2)]
    assert common.fetch_shards_mux(plain, cfg, f"{PREFIX}0", table, [0, 1],
                                   bufs) is None
    assert jax_common.fetch_shards_mux(jplain, jcfg, f"{PREFIX}0", jtable,
                                       [0, 1], bufs) is None
    plain.close()
    jplain.close()
    jc, c = _h2_clients(h2srv)
    jbufs = [np.zeros(1000, dtype=np.uint8) for _ in range(2)]
    res = common.fetch_shards_mux(c, cfg, f"{PREFIX}0", table, [0, 1], bufs)
    jres = jax_common.fetch_shards_mux(jc, jcfg, f"{PREFIX}0", jtable, [0, 1],
                                       jbufs)
    assert res is not None and res.error_count == jres.error_count == 0
    want = deterministic_bytes(f"{PREFIX}0", H2_SIZE)
    assert [b.tobytes() for b in bufs] == [b.tobytes() for b in jbufs] == [
        want[:1000].tobytes(), want[1000:2000].tobytes()]
    assert common.fetch_shards_mux(c, cfg, f"{PREFIX}0", table, [], []) is None
    # Behind the retry decorator (one layer, as tpubench looks).
    wcfg = BenchConfig()
    wcfg.transport = TransportConfig(endpoint=h2srv.endpoint, http2=True)
    wrapped = open_backend(wcfg)
    assert common.mux_supported(wrapped) and common.mux_supported(c)
    assert not common.mux_supported(FakeBackend())
    for b in (jc, c, wrapped):
        b.close()


def _scripted(backend, script):
    """Replace ``backend.read_ranges`` with ``script(round, ranges, real
    errors)``; returns the call counter."""
    calls = {"n": 0}
    real = backend.read_ranges

    def scripted(name, ranges, buffers):
        calls["n"] += 1
        return script(calls["n"], ranges, real(name, ranges, buffers))

    backend.read_ranges = scripted
    return calls


def _retry_pair(retry, abort=False):
    cfgs = []
    for cls in (JaxBenchConfig, BenchConfig):
        cfg = cls()
        for k, v in retry.items():
            setattr(cfg.transport.retry, k, v)
        cfg.workload.abort_on_error = abort
        cfgs.append(cfg)
    return cfgs


def test_mux_retry_chains_are_per_range():
    """Each range keeps its own attempt chain: range 0 fails rounds 1-2
    and heals on its third attempt; range 1 fails rounds 1-3 and spends
    its 3 attempts. Both packages leave the same holes."""
    store = FakeBackend.prepopulated(PREFIX, 1, 4000)
    with FakeGrpcWireServer(store) as srv:
        def script(rnd, ranges, errs, err_cls):
            out = []
            for (start, _), e in zip(ranges, errs):
                if start == 0 and rnd <= 2:
                    out.append(err_cls("flaky-a", transient=True))
                elif start == 1000 and rnd <= 3:
                    out.append(err_cls("flaky-b", transient=True))
                else:
                    out.append(e)
            return out

        retry = dict(max_attempts=3, initial_backoff_s=0.001,
                     max_backoff_s=0.002)
        jcfg, cfg = _retry_pair(retry)
        jb, b = _grpc_clients(srv)
        _scripted(jb, lambda r, rg, e: script(r, rg, e, JaxStorageError))
        _scripted(b, lambda r, rg, e: script(r, rg, e, StorageError))
        bufs = [np.zeros(1000, dtype=np.uint8) for _ in range(4)]
        jbufs = [np.zeros(1000, dtype=np.uint8) for _ in range(4)]
        res = common.fetch_shards_mux(
            b, cfg, f"{PREFIX}0", ShardTable.build(4000, 4, align=1),
            [0, 1, 2, 3], bufs)
        jres = jax_common.fetch_shards_mux(
            jb, jcfg, f"{PREFIX}0", JaxShardTable.build(4000, 4, align=1),
            [0, 1, 2, 3], jbufs)
        assert {e.worker_id for e in res.errors} == {
            e.worker_id for e in jres.errors} == {1}
        for i in (0, 2, 3):
            assert bufs[i].tobytes() == jbufs[i].tobytes()
        jb.close()
        b.close()


def test_mux_retry_deadline_never_oversleeps():
    """A deadline shorter than the first pause: the failing ranges are
    given up after one round, with no sleep past the deadline."""
    store = FakeBackend.prepopulated(PREFIX, 1, 4000)
    with FakeGrpcWireServer(store) as srv:
        retry = dict(max_attempts=5, initial_backoff_s=0.5,
                     max_backoff_s=0.5, jitter=False, deadline_s=0.2)
        for (cfg, b), mod, table, err_cls in zip(
            zip(_retry_pair(retry), _grpc_clients(srv)),
            (jax_common, common),
            (JaxShardTable.build(4000, 2, align=1),
             ShardTable.build(4000, 2, align=1)),
            (JaxStorageError, StorageError),
        ):
            calls = _scripted(b, lambda r, rg, e, err_cls=err_cls: [
                err_cls("always-flaky", transient=True) for _ in e])
            bufs = [np.zeros(2000, dtype=np.uint8) for _ in range(2)]
            t0 = time.monotonic()
            res = mod.fetch_shards_mux(b, cfg, f"{PREFIX}0", table, [0, 1],
                                       bufs)
            elapsed = time.monotonic() - t0
            assert calls["n"] == 1, "pause > budget: no retry round may run"
            assert elapsed < 0.45, elapsed
            assert len(res.errors) == 2
            b.close()


# ---------------------------------------------------------- pod-ingest --


def _checksums(mod):
    """Keep the checksum of every collective call ``mod`` makes."""
    seen, saved = [], mod.make_reassemble

    def build(*a, **k):
        fn = saved(*a, **k)

        def call(staged):
            gathered, csum = fn(staged)
            seen.append(int(csum))
            return gathered, csum

        return call

    mod.make_reassemble = build
    return seen, lambda: setattr(mod, "make_reassemble", saved)


def _pod_configs(kind, srv, size, retry=None):
    cfgs = []
    for cls in (JaxBenchConfig, BenchConfig):
        cfg = cls()
        t = cfg.transport
        t.endpoint = srv.endpoint
        if kind == "http2":
            t.protocol, t.http2 = "http", True
        else:
            t.protocol, t.native_receive, t.directpath = "grpc", True, False
        for k, v in (retry or {}).items():
            setattr(t.retry, k, v)
        cfg.workload.bucket = "b"
        cfg.workload.object_name_prefix = PREFIX
        cfg.workload.object_size = size
        cfgs.append(cfg)
    return cfgs


def _pod_both(kind, srv, size, retry=None) -> tuple[dict, dict, dict]:
    """``pod-ingest`` of ``<PREFIX>0`` in both packages, each on its own
    backend; returns both results (with the checksums) and the port's
    pool stats."""
    from tpubench.storage import open_backend as jax_open_backend

    jcfg, cfg = _pod_configs(kind, srv, size, retry)
    out = []
    for mod, c, opener, run in (
        (jax_pod, jcfg, jax_open_backend,
         lambda c, be: jax_pod.run_pod_ingest(c, backend=be)),
        (pod_ingest, cfg, open_backend,
         lambda c, be: cli.execute("pod-ingest", c, device="cpu", backend=be)),
    ):
        be = opener(c)
        seen, restore = _checksums(mod)
        try:
            res = run(c, be).to_dict()
        finally:
            restore()
        res["checksums"] = seen
        res["pool"] = dict(_pool(base_backend(be)).stats)
        be.close()
        out.append(res)
    return out[0], out[1]


@pytest.mark.parametrize("kind", ["http2", "grpc_native"])
def test_pod_ingest_multiplexed_matches_reference(kind, h2srv, grpcsrv,
                                                  jax_cpu_devices):
    """Both mux modes: the same 8 ranges on one connection in both
    packages, verified, the same bytes, holes and pod checksums. The pool
    accounting pins the route (a thread fan-out would verify too): the
    h2 client takes one connection for the stat and one batch (2
    acquires), the gRPC client stats over its wire channel, so its native
    pool sees the one batch alone."""
    srv, size = (h2srv, H2_SIZE) if kind == "http2" else (grpcsrv, GRPC_SIZE)
    ref, res = _pod_both(kind, srv, size)
    for r in (ref, res):
        assert r["errors"] == 0 and r["extra"]["verified"] is True
        assert r["bytes_total"] == size
    assert res["checksums"] == ref["checksums"]
    assert res["checksums"][0] == int(
        deterministic_bytes(f"{PREFIX}0", size).sum(dtype=np.uint64)) % (1 << 32)
    for key in ("holes", "holes_global", "object_size", "verified", "mode"):
        assert res["extra"][key] == ref["extra"][key], key
    # The rank's shard is the reference's 8 local shards end to end.
    assert res["extra"]["shard_bytes"] == 8 * ref["extra"]["shard_bytes"]
    want = 2 if kind == "http2" else 1
    for r in (ref, res):
        assert r["pool"]["connects"] + r["pool"]["reuses"] == want, r["pool"]
    assert res["pool"]["connects"] == 1


@pytest.mark.parametrize("kind", ["http2", "grpc_native"])
def test_pod_ingest_mux_retries_injected_faults(kind, jax_cpu_devices):
    """Injected open failures (a seeded 40% plan on the store behind the
    server) heal per range under the retry policy: both packages verify
    the whole object with the same pod checksum."""
    store = FakeBackend.prepopulated(PREFIX, 1, 2_000_000)
    store.fault = FaultPlan(error_rate=0.4, seed=11)
    store._rng = store.fault.rng()
    server = FakeH2Server if kind == "http2" else FakeGrpcWireServer
    with server(store) as srv:
        ref, res = _pod_both(kind, srv, 2_000_000, retry=dict(
            initial_backoff_s=0.005, max_backoff_s=0.02))
    for r in (ref, res):
        assert r["errors"] == 0 and r["extra"]["verified"] is True
        assert r["bytes_total"] == 2_000_000
    assert res["checksums"] == ref["checksums"]
    assert store.injected_errors > 0  # the plan fired


def test_pod_ingest_mux_needs_a_group(h2srv):
    """The mux route runs on the caller's group like the threaded one;
    at one rank the same 8 ranges, through ``bringup.session``."""
    _, cfg = _pod_configs("http2", h2srv, H2_SIZE)
    with bringup.session(cfg.dist, "cpu", one_rank_group=True):
        res = pod_ingest.run_pod_ingest(cfg, device="cpu")
    assert res.errors == 0 and res.extra["verified"] is True
    assert res.extra["shard_bytes"] == 8 * ShardTable.build(
        H2_SIZE, 8, align=128).shard_bytes
