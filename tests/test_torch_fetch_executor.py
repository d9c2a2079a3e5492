"""The port's native fetch-executor route on the CPU: the C++ executor
(``tpubench_torch.native``) landing slot-range GETs in the port's slots,
the staged runner (``tpubench_torch.workloads.fetch_executor``) against
``tpubench``'s on one server, and the slot ring's completion gate.

Servers: the JAX package's ``FakeGcsServer`` (a test may import it; the
port may not) and the port's own ``NativeSourceServer``. Everything runs
with ``device="cpu"``; the card's counterpart is in
``tests/test_torch_cuda.py``.
"""

import threading
import urllib.parse

import numpy as np
import pytest
import torch

from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.storage.fake import FakeBackend, FaultPlan
from tpubench.storage.fake_server import FakeGcsServer
from tpubench.workloads.read import run_read as jax_run_read

from tpubench_torch.config import BenchConfig
from tpubench_torch.kernels import landing
from tpubench_torch.native.engine import NativeSourceServer, get_engine
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.workloads import fetch_executor
from tpubench_torch.workloads.read import run_read

PREFIX = "bench/file_"
SIZE = 500_000
MOD = 1 << 32


@pytest.fixture(scope="module")
def server():
    with FakeGcsServer(FakeBackend.prepopulated(PREFIX, count=4, size=SIZE)) as srv:
        yield srv


def _cfg(endpoint: str, cls=BenchConfig, prefix: str = PREFIX, *,
         workers: int = 2, reads: int = 2, mode: str = "device_put",
         slot_bytes: int = 128 * 1024, validate: bool = True):
    cfg = cls()
    cfg.transport.protocol = "http"
    cfg.transport.endpoint = endpoint
    cfg.transport.retry.initial_backoff_s = 0.005
    cfg.transport.retry.max_backoff_s = 0.02
    cfg.workload.bucket = "testbucket"
    cfg.workload.object_name_prefix = prefix
    cfg.workload.workers = workers
    cfg.workload.read_calls_per_worker = reads
    cfg.workload.fetch_executor = "native"
    cfg.staging.mode = mode
    cfg.staging.slot_bytes = slot_bytes
    cfg.staging.depth = 3
    cfg.staging.validate_checksum = validate
    return cfg


def _byte_sum(name: str, size: int) -> int:
    return int(deterministic_bytes(name, size).sum(dtype=np.uint64))


@pytest.fixture
def recording(monkeypatch):
    """The runner's slot rings, kept by worker so a test can read their
    sums and slots after the run."""
    made = {}

    class Recording(fetch_executor._SlotPipeline):
        def __init__(self, worker_id, *args, **kwargs):
            super().__init__(worker_id, *args, **kwargs)
            made[worker_id] = self

    monkeypatch.setattr(fetch_executor, "_SlotPipeline", Recording)
    return made


# (a) -------------------------------------------------------------------
def test_pool_fanout_lands_bytes_and_stamps_in_port_tensors(server):
    eng = get_engine()
    host, port = server.endpoint.replace("http://", "").split(":")
    bufs = {}
    with eng.pool_create(4) as pool:
        for i in range(12):
            name = f"{PREFIX}{i % 4}"
            buf = torch.zeros(600_000, dtype=torch.uint8)
            bufs[i] = (buf, name)
            pool.submit_to(
                host, int(port),
                "/storage/v1/b/testbucket/o/"
                + urllib.parse.quote(name, safe="") + "?alt=media",
                buf.data_ptr(), buf.numel(), tag=i,
            )
        seen = []
        while len(seen) < 12:
            got = pool.next_batch(timeout_ms=10_000)
            assert got, "no completion within 10 s"
            seen += got
        assert pool.next_batch(timeout_ms=0) == []
    assert sorted(c["tag"] for c in seen) == list(range(12))
    for c in seen:
        assert c["result"] == SIZE and c["status"] == 200
        assert c["start_ns"] < c["first_byte_ns"]
        assert c["first_byte_ns"] - c["start_ns"] <= c["total_ns"]
        buf, name = bufs[c["tag"]]
        assert np.array_equal(buf[:SIZE].numpy(), deterministic_bytes(name, SIZE))
        assert not buf[SIZE:].any()


# (b) -------------------------------------------------------------------
def test_staged_route_parity_with_tpubench(server, jax_cpu_devices):
    """One server, one config through both packages: the same bytes,
    transfers, retries and checksum verdict, exactly, and the same result
    keys. ``n_chips`` (and the per-chip rates) differ by design: 8
    simulated JAX CPU devices against the port's one CPU."""
    jcfg = _cfg(server.endpoint, cls=JaxBenchConfig)
    jres = jax_run_read(jcfg).to_dict()
    tres = run_read(BenchConfig.from_dict(jcfg.to_dict()), device="cpu").to_dict()
    assert (jres["n_chips"], tres["n_chips"]) == (len(jax_cpu_devices), 1)
    assert set(jres) == set(tres)
    assert set(jres["extra"]) == set(tres["extra"])
    assert set(jres["summaries"]) == set(tres["summaries"])
    assert jres["bytes_total"] == tres["bytes_total"] == 2 * 2 * SIZE
    assert jres["errors"] == tres["errors"] == 0
    for key in ("staged_bytes", "checksum_ok", "slot_bytes", "depth",
                "retries", "fetch_executor", "executor_mode",
                "staging_zero_copy"):
        assert jres["extra"][key] == tres["extra"][key], key
    assert tres["extra"]["checksum_ok"] is True
    for name in ("read", "first_byte", "stage"):
        assert (jres["summaries"][name]["count"]
                == tres["summaries"][name]["count"]), name
    assert tres["summaries"]["stage"]["count"] == 2 * 2 * 4  # 4 ranges a read


# (c) -------------------------------------------------------------------
def test_each_worker_device_sum_is_its_objects_byte_sum(server, recording):
    reads = 3
    res = run_read(_cfg(server.endpoint, workers=3, reads=reads), device="cpu")
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert sorted(recording) == [0, 1, 2]
    for wid, pipe in recording.items():
        want = _byte_sum(f"{PREFIX}{wid}", SIZE) * reads % MOD
        assert pipe.sums() == (want, want), wid
        assert pipe.transfers == reads * 4
        assert pipe.staged_bytes == reads * SIZE
        assert pipe.device == torch.device("cpu") and pipe.stream is None
        assert not any(s.is_pinned() for s in pipe.slots)


# (d) -------------------------------------------------------------------
@pytest.mark.parametrize("size, slot, ranges", [
    (SIZE, 1 << 20, 1),                   # the whole object in one slot
    (2 * 128 * 1024 + 77, 128 * 1024, 3),  # tail slot shorter than a lane
], ids=["single_slot_object", "tail_under_one_lane"])
def test_partial_slots(size, slot, ranges, recording):
    name = "tpubench/file_0"
    body = deterministic_bytes(name, size)
    with NativeSourceServer(get_engine(), name, body) as srv:
        res = run_read(
            _cfg(srv.endpoint, prefix="tpubench/file_", workers=1, reads=2,
                 slot_bytes=slot),
            device="cpu",
        )
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert res.bytes_total == res.extra["staged_bytes"] == 2 * size
    assert res.extra["slot_bytes"] == slot
    assert res.summaries["stage"].count == 2 * ranges
    want = 2 * _byte_sum(name, size) % MOD
    assert recording[0].sums() == (want, want)


# (e) -------------------------------------------------------------------
@pytest.mark.parametrize("staged", [True, False], ids=["staged", "fetch_only"])
def test_injected_503s_are_retried(staged):
    be = FakeBackend.prepopulated(PREFIX, count=2, size=300_000)
    be.fault = FaultPlan(error_rate=0.3, seed=7)
    with FakeGcsServer(be) as srv:
        cfg = _cfg(srv.endpoint, reads=4, slot_bytes=100_000,
                   mode="device_put" if staged else "none", validate=staged)
        res = run_read(cfg, device="cpu")
        assert be.injected_errors > 0
    assert res.errors == 0
    assert res.bytes_total == 2 * 4 * 300_000
    assert res.extra["retries"] > 0
    if staged:
        assert res.extra["checksum_ok"] is True
        assert res.extra["staged_bytes"] == res.bytes_total


# (f) -------------------------------------------------------------------
def _switch(cfg, switch: str):
    if switch == "fake_protocol":
        cfg.transport.protocol = "fake"
        cfg.workload.object_size = 1024
        cfg.workload.workers = 1
        cfg.staging.mode = "none"
    elif switch == "pallas_staging":
        cfg.staging.mode = "pallas"
    return cfg


@pytest.mark.parametrize("switch, match", [
    ("fake_protocol", "protocol http"),
    ("pallas_staging", "device_put"),
])
def test_refusals_match_tpubench(switch, match, jax_cpu_devices):
    """Both packages refuse these before any request is sent."""
    endpoint = "http://127.0.0.1:9"
    with pytest.raises(ValueError, match=match):
        jax_run_read(_switch(_cfg(endpoint, cls=JaxBenchConfig), switch))
    with pytest.raises(ValueError, match=match):
        run_read(_switch(_cfg(endpoint), switch), device="cpu")


def _no_adc(monkeypatch):
    """Default credentials are absent, as on a machine without ADC: the
    stub raises where ``google.auth.default`` would look for them, so no
    test reaches a metadata server."""
    import google.auth
    import google.auth.exceptions

    def absent(*_a, **_k):
        raise google.auth.exceptions.DefaultCredentialsError("no ADC (stub)")

    monkeypatch.setattr(google.auth, "default", absent)


@pytest.fixture(scope="module")
def h2_server():
    from tpubench.storage.fake_h2_server import FakeH2Server

    with FakeH2Server(FakeBackend.prepopulated(PREFIX, count=4, size=SIZE)) as srv:
        yield srv


@pytest.mark.parametrize("switch", ["http2", "key_file", "google_endpoint"])
def test_lifted_http_features_run_as_in_reference(switch, server, h2_server,
                                                  jax_cpu_devices, monkeypatch):
    """The switches refused until the executor's h2 pool and the token
    sources were ported run through both packages' executors alike:
    ``http2`` over h2c (the reactor's h2 pool, every GET a stream), a key
    file against a test server (anonymous, as in ``tpubench``), and
    Google's endpoint without credentials (both raise building the
    client, before any request)."""
    jcfg = _cfg((h2_server if switch == "http2" else server).endpoint,
                cls=JaxBenchConfig)
    if switch == "http2":
        jcfg.transport.http2 = True
    elif switch == "key_file":
        jcfg.transport.key_file = "/nonexistent/key.json"
    else:
        _no_adc(monkeypatch)
        jcfg.transport.endpoint = ""  # storage.googleapis.com: credentials
        import google.auth.exceptions

        for run in (lambda: jax_run_read(jcfg),
                    lambda: run_read(BenchConfig.from_dict(jcfg.to_dict()),
                                     device="cpu")):
            with pytest.raises(google.auth.exceptions.DefaultCredentialsError):
                run()
        return
    eng = get_engine()
    stats0 = eng.stats()
    tres = run_read(BenchConfig.from_dict(jcfg.to_dict()), device="cpu").to_dict()
    delta = {k: v - stats0.get(k, 0) for k, v in eng.stats().items()}
    jres = jax_run_read(jcfg).to_dict()
    assert jres["bytes_total"] == tres["bytes_total"] == 2 * 2 * SIZE
    assert jres["errors"] == tres["errors"] == 0
    for key in ("staged_bytes", "checksum_ok", "slot_bytes", "retries",
                "executor_mode"):
        assert jres["extra"][key] == tres["extra"][key], key
    assert tres["extra"]["checksum_ok"] is True
    assert tres["extra"]["executor_mode"] == "reactor"
    transfers = tres["summaries"]["stage"]["count"]
    assert transfers == jres["summaries"]["stage"]["count"] == 2 * 2 * 4
    streams = transfers if switch == "http2" else 0
    assert delta["reactor_h2_streams"] >= streams
    assert (delta["reactor_h2_streams"] > 0) is (switch == "http2")


def test_reactor_h2_many_streams_exactly_once(h2_server):
    """h2c prior knowledge (``tests/test_reactor.py``'s case): 40 GETs
    multiplex as streams over at most 2 connections, each tag completes
    exactly once with its object's bytes, and the h2 stream counters
    attribute the multiplexing."""
    eng = get_engine()
    host, port = h2_server.endpoint.replace("http://", "").split(":")
    stats0 = eng.stats()
    n, bufs, seen = 40, {}, {}
    with eng.pool_create(2, 64, mode="reactor", h2=True) as pool:
        assert pool.mode == "reactor"
        for i in range(n):
            bufs[i] = torch.zeros(SIZE, dtype=torch.uint8)
            pool.submit_to(
                host, int(port),
                f"/storage/v1/b/testbucket/o/bench%2Ffile_{i % 4}?alt=media",
                bufs[i].data_ptr(), SIZE, tag=i,
            )
        while len(seen) < n:
            got = pool.next_batch(timeout_ms=10_000)
            assert got, "h2 drain stalled"
            for c in got:
                assert c["tag"] not in seen, "duplicate completion"
                seen[c["tag"]] = c
                assert c["result"] == SIZE and c["status"] == 200, c
    for i in seen:
        assert np.array_equal(bufs[i].numpy(),
                              deterministic_bytes(f"{PREFIX}{i % 4}", SIZE))
    delta = {k: v - stats0.get(k, 0) for k, v in eng.stats().items()}
    assert delta["reactor_h2_streams"] >= n
    assert delta["h2_streams_opened"] >= n


def test_h2_never_degrades_to_http1(server, jax_cpu_devices):
    """An h2 pool whose reactor cannot be made raises (code -22) instead
    of serving HTTP/1.1 from the thread pool, and ``native-threads`` with
    ``http2`` is refused before any request, in both packages."""
    from tpubench_torch.native.engine import NativeEngine, NativeError

    class NoReactor:
        class lib:
            tb_pool_create2 = staticmethod(lambda *a: 0)
            tb_pool_create = staticmethod(lambda *a: 1)  # would serve h1

    with pytest.raises(NativeError) as err:
        NativeEngine.pool_create(NoReactor(), 2, mode="reactor", h2=True)
    assert err.value.code == -22
    jcfg = _cfg(server.endpoint, cls=JaxBenchConfig)
    jcfg.transport.http2 = True
    jcfg.workload.fetch_executor = "native-threads"
    with pytest.raises(ValueError, match="native-threads"):
        jax_run_read(jcfg)
    with pytest.raises(ValueError, match="native-threads"):
        run_read(BenchConfig.from_dict(jcfg.to_dict()), device="cpu")


# (g) -------------------------------------------------------------------
class _PendingEvent:
    """Stand-in for the event after a slot's copy: ``query()`` answers
    False for its first ``polls`` calls (setting ``held``, if given, at the
    last of them); ``synchronize()`` completes it."""

    def __init__(self, polls: int, held: threading.Event = None):
        self.polls = polls
        self.pending_answers = 0
        self.done = False
        self.held = held

    def query(self) -> bool:
        if not self.done and self.pending_answers < self.polls:
            self.pending_answers += 1
            if self.pending_answers == self.polls and self.held is not None:
                self.held.set()
            return False
        self.done = True
        return True

    def synchronize(self) -> None:
        self.done = True


def test_slot_returns_only_after_its_event_completes(monkeypatch):
    """A slot whose copy's event still reports pending is never handed to
    a new range; once the event completes, the slot comes back.

    The store holds worker 1's first range until some event has answered
    "pending" three times. While that range is in flight the runner's
    loop keeps polling the pending events (it waits on a copy outright,
    completing it without a poll, only when no fetch is in flight), so
    the slots held back behind them come back through the poll: the last
    check no longer depends on how fast the machine is."""
    events = {}  # (worker, slot) -> the event of the slot's last launch
    reuses = []  # at each reuse of a slot: had its last event completed?
    held = threading.Event()

    class Gated(fetch_executor._SlotPipeline):
        def __init__(self, worker_id, *args, **kwargs):
            super().__init__(worker_id, *args, **kwargs)
            self.wid = worker_id

            class Free(list):
                def pop(self):
                    slot = super().pop()
                    ev = events.get((worker_id, slot))
                    if ev is not None:
                        reuses.append(ev.done)
                    return slot

            self.free = Free(self.free)

        def launch(self, slot, nbytes):
            (landed, _), submit_ns, n = super().launch(slot, nbytes)
            ev = events[(self.wid, slot)] = _PendingEvent(polls=3, held=held)
            return (landed, ev), submit_ns, n

        def complete(self, slot, submit_ns, nbytes):
            assert events[(self.wid, slot)].done, "slot freed while pending"
            super().complete(slot, submit_ns, nbytes)

    class HoldsWorker1(FakeBackend):
        def open_read(self, name, start=0, length=None):
            if name == f"{PREFIX}1" and not held.is_set():
                held.wait(timeout=30)
            return super().open_read(name, start=start, length=length)

    monkeypatch.setattr(fetch_executor, "_SlotPipeline", Gated)
    slow = HoldsWorker1.prepopulated(PREFIX, count=2, size=SIZE,
                                     fault=FaultPlan(latency_s=0.005))
    with FakeGcsServer(slow) as srv:
        res = run_read(_cfg(srv.endpoint, reads=3, validate=False),
                       device="cpu")
    assert res.errors == 0
    assert res.extra["staged_bytes"] == 2 * 3 * SIZE
    assert res.summaries["stage"].count == 2 * 3 * 4
    # 12 ranges a worker through 3 slots: every reuse came after the
    # slot's event completed, and the gate did hold slots back.
    assert len(reuses) == 2 * (12 - 3)
    assert all(reuses)
    assert any(ev.pending_answers == 3 for ev in events.values())


# (h) -------------------------------------------------------------------
def test_https_endpoint():
    if not get_engine().tls_available():
        pytest.skip("the engine could not load OpenSSL (libssl.so.3)")
    be = FakeBackend.prepopulated(PREFIX, count=2, size=300_000)
    with FakeGcsServer(be, tls=True) as srv:
        cfg = _cfg(srv.endpoint, reads=3, mode="none", validate=False)
        cfg.transport.tls_ca_file = srv.cafile
        res = run_read(cfg, device="cpu")
        assert res.errors == 0 and res.bytes_total == 2 * 3 * 300_000
        cfg.staging.mode = "device_put"
        cfg.staging.validate_checksum = True
        res = run_read(cfg, device="cpu")
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert res.extra["staged_bytes"] == 2 * 3 * 300_000


def test_cpu_route_launches_no_kernel(server):
    landing.reset_launches()
    res = run_read(_cfg(server.endpoint), device="cpu")
    assert res.extra["checksum_ok"] is True
    assert landing.checksum.launches == 0 and landing.land.launches == 0
