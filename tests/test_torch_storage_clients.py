"""The port's storage clients alone, against the port's own fake servers:
full and ranged reads across gRPC message (2 MiB) and granule boundaries,
error classification, mid-stream resume (against ``tpubench``'s
``_ResumingReader`` under the same seeded plan, clock and sleep),
connection reuse of the native pools, HTTPS with a certificate from the
``openssl`` command-line tool, the local backend's root check, gRPC
library mode's refusal where grpcio does not import, and the address the
native receive hands the engine lying inside the staging slot.
"""

import random
import socket
import sys

import numpy as np
import pytest

from tpubench_torch.config import BenchConfig, TransportConfig, refuse_unported
from tpubench_torch.native.engine import get_engine
from tpubench_torch.staging.device import make_sink_factory
from tpubench_torch.storage import base_backend, open_backend
from tpubench_torch.storage.base import StorageError, deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.storage.fake_grpc_wire_server import FakeGrpcWireServer
from tpubench_torch.storage.fake_h2_server import FakeH2Server
from tpubench_torch.storage.fake_server import FakeGcsServer
from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend
from tpubench_torch.storage.gcs_http import GcsHttpBackend
from tpubench_torch.storage.local_fs import LocalFsBackend
from tpubench_torch.storage.retrying import RetryingBackend, _ResumingReader
from tpubench_torch.workloads.read import run_read

MIB = 1 << 20
NAME = "obj/a"
SIZE = 2 * 2 * MIB + 12_345  # three gRPC messages, the last one short
CLIENTS = ("fake", "http", "http_native", "http2", "grpc", "grpc_native",
           "local")

# The gRPC client warns that DirectPath does not apply to a test server.
pytestmark = pytest.mark.filterwarnings("ignore:.*directpath")


def _transport(**kw) -> TransportConfig:
    t = TransportConfig()
    t.retry.initial_backoff_s = 0.001
    t.retry.max_backoff_s = 0.01
    t.retry.jitter = False
    t.retry.deadline_s = 10.0
    for k, v in kw.items():
        setattr(t, k, v)
    return t


class _Servers:
    """One store behind every kind of server, and a client of each kind."""

    def __init__(self, store: FakeBackend, root: str = ""):
        self.store, self.root = store, root
        self.h1 = FakeGcsServer(store).start()
        self.h2 = FakeH2Server(store).start()
        self.grpc = FakeGrpcWireServer(store).start()

    def client(self, kind: str):
        if kind == "fake":
            return self.store
        if kind == "local":
            return LocalFsBackend(self.root)
        if kind.startswith("http"):
            ep = self.h2.endpoint if kind == "http2" else self.h1.endpoint
            return GcsHttpBackend("b", _transport(
                endpoint=ep, native_receive=kind == "http_native",
                http2=kind == "http2",
            ))
        return GcsGrpcBackend("b", _transport(
            endpoint=self.grpc.endpoint,
            native_receive=kind == "grpc_native",
        ))

    def stop(self) -> None:
        for srv in (self.h1, self.h2, self.grpc):
            srv.stop()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("local")
    (root / "obj").mkdir()
    (root / "obj" / "a").write_bytes(deterministic_bytes(NAME, SIZE).tobytes())
    store = FakeBackend.from_population([(NAME, SIZE, 1)])
    srv = _Servers(store, str(root))
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def unavailable():
    """Servers whose every open answers an injected 503."""
    store = FakeBackend.from_population(
        [(NAME, SIZE, 1)], fault=FaultPlan(error_rate=1.0)
    )
    srv = _Servers(store)
    yield srv
    srv.stop()


def _read_all(reader, granule: int) -> bytes:
    out = bytearray()
    buf = memoryview(bytearray(granule))
    try:
        while True:
            n = reader.readinto(buf)
            if n <= 0:
                return bytes(out)
            out += buf[:n]
    finally:
        reader.close()


@pytest.mark.parametrize("kind", CLIENTS)
def test_full_and_ranged_reads_match_the_objects_bytes(servers, kind):
    want = deterministic_bytes(NAME, SIZE).tobytes()
    client = servers.client(kind)
    try:
        assert client.stat(NAME).size == SIZE
        assert [m.name for m in client.list("obj/")] == [NAME]
        for granule in (64 * 1024, 100_003):
            assert _read_all(client.open_read(NAME), granule) == want
        for start, length in ((1, 2 * MIB), (2 * MIB - 10, 20),
                              (4 * MIB - 7, None), (SIZE - 5, 5)):
            end = SIZE if length is None else start + length
            got = _read_all(client.open_read(NAME, start, length), 65_536)
            assert got == want[start:end], (start, length)
    finally:
        client.close()


@pytest.mark.parametrize("kind", CLIENTS)
def test_missing_object_is_a_permanent_404(servers, kind):
    client = servers.client(kind)
    try:
        with pytest.raises(StorageError) as e:
            _read_all(client.open_read("obj/missing"), 65_536)
        assert e.value.code == 404 and not e.value.transient
    finally:
        client.close()


@pytest.mark.parametrize("kind", ["http", "http_native", "http2", "grpc",
                                  "grpc_native"])
def test_injected_503_is_transient(unavailable, kind):
    client = unavailable.client(kind)
    try:
        with pytest.raises(StorageError) as e:
            _read_all(client.open_read(NAME, 0, 1000), 65_536)
        assert e.value.transient and e.value.code == 503
    finally:
        client.close()


def _resume_run(backend_cls, plan_cls, reader_cls, retry):
    """Read one object through ``reader_cls`` (a ``_ResumingReader``) over
    a store with a seeded mid-stream fault plan; returns the bytes, the
    opens ``(start, length)``, the pauses slept and the reopen count."""
    store = backend_cls.from_population(
        [(NAME, SIZE, 1)], fault=plan_cls(read_error_rate=0.3, seed=5),
    )
    opens = []
    real_open = store.open_read

    def open_read(name, start=0, length=None):
        opens.append((start, length))
        return real_open(name, start, length)

    store.open_read = open_read
    sleeps = []
    clock = iter(range(10**6))
    reader = reader_cls(
        store, NAME, 10, SIZE - 20, retry, rng=random.Random(1),
        sleep=sleeps.append, clock=lambda: float(next(clock)),
    )
    data = _read_all(reader, 100_003)
    return data, opens, sleeps, reader.reopen_count


def test_resuming_reader_matches_tpubench():
    """Same seeded plan, clock and sleep: the port's resuming reader opens
    the same ranges (each resume at start + delivered), sleeps the same
    pauses and delivers the same bytes as ``tpubench``'s."""
    from tpubench.config import RetryConfig as JaxRetryConfig
    from tpubench.storage.fake import FakeBackend as JaxFakeBackend
    from tpubench.storage.fake import FaultPlan as JaxFaultPlan
    from tpubench.storage.retrying import _ResumingReader as JaxResumingReader

    t = _transport()
    port = _resume_run(FakeBackend, FaultPlan, _ResumingReader, t.retry)
    ref = _resume_run(JaxFakeBackend, JaxFaultPlan, JaxResumingReader,
                      JaxRetryConfig(**vars(t.retry)))
    assert port == ref
    data, opens, sleeps, reopens = port
    assert data == deterministic_bytes(NAME, SIZE).tobytes()[10:SIZE - 10]
    assert reopens == len(opens) - 1 > 0 and len(sleeps) == reopens
    delivered = 0
    for (start, length), nxt in zip(opens, opens[1:] + [None]):
        assert start == 10 + delivered and length == SIZE - 20 - delivered
        if nxt is not None:
            delivered = nxt[0] - 10
    # Resumes land at 100,003-byte granule boundaries of the caller (the
    # store fails before a granule), so mid-object, never at offset 0.
    assert all((s - 10) % 100_003 == 0 for s, _ in opens)


def test_retrying_backend_retries_open_and_stat(unavailable):
    """Under retry policy ``always`` a permanently unavailable server is
    retried until the attempt cap, then the last error surfaces."""
    t = _transport(endpoint=unavailable.h1.endpoint)
    t.retry.max_attempts = 3
    slept = []
    be = RetryingBackend(GcsHttpBackend("b", t), t.retry, sleep=slept.append)
    try:
        with pytest.raises(StorageError):
            be.stat(NAME)
        assert len(slept) == 2
        with pytest.raises(StorageError):
            be.open_read(NAME)
        assert len(slept) == 4
    finally:
        be.close()


@pytest.mark.parametrize("kind", ["http_native", "grpc_native"])
def test_native_pool_reuses_connections(servers, kind):
    client = servers.client(kind)
    try:
        for _ in range(4):
            _read_all(client.open_read(NAME, 0, 300_000), 65_536)
        stats = client.native_conn_stats
        assert stats["connects"] == 1 and stats["reuses"] == 3
        assert stats["stale_retries"] == 0
    finally:
        client.close()


def test_native_pool_retries_a_stale_connection_once(servers):
    """A pooled connection that died while idle fails at its first use;
    the GET is sent once more on a fresh connection and succeeds."""
    client = servers.client("http_native")
    listener = socket.create_server(("127.0.0.1", 0))
    try:
        _read_all(client.open_read(NAME, 0, 1000), 65_536)
        pool = client._native_pool()
        pool.engine.conn_close(pool.idle.pop())
        # Stand-in for the dead socket: a peer that accepts and hangs up.
        stale = pool.engine.connect(*listener.getsockname()[:2])
        listener.accept()[0].close()
        pool.idle.append(stale)
        got = _read_all(client.open_read(NAME, 0, 1000), 65_536)
        assert got == deterministic_bytes(NAME, SIZE).tobytes()[:1000]
        assert client.native_conn_stats["stale_retries"] == 1
    finally:
        listener.close()
        client.close()


def test_https_with_an_openssl_certificate():
    store = FakeBackend.from_population([(NAME, 500_000, 1)])
    with FakeGcsServer(store, tls=True) as srv:
        assert srv.cafile.endswith("cert.pem")
        want = deterministic_bytes(NAME, 500_000).tobytes()
        kinds = [False]
        if get_engine().tls_available():
            kinds.append(True)
        for native in kinds:
            be = GcsHttpBackend("b", _transport(
                endpoint=srv.endpoint, tls_ca_file=srv.cafile,
                native_receive=native,
            ))
            try:
                assert _read_all(be.open_read(NAME), 65_536) == want
            finally:
                be.close()
        # Without the CA the certificate is refused, and not retried.
        be = GcsHttpBackend("b", _transport(endpoint=srv.endpoint))
        try:
            with pytest.raises(StorageError):
                be.stat(NAME)
        finally:
            be.close()


@pytest.mark.parametrize("name", ["../escape", "/etc/passwd", "../local2/x"])
def test_local_backend_refuses_paths_outside_its_root(tmp_path, name):
    root = tmp_path / "local"
    root.mkdir()
    be = LocalFsBackend(str(root))
    with pytest.raises(StorageError, match="escapes root"):
        be.open_read(name)
    with pytest.raises(StorageError, match="escapes root"):
        be.stat(name)


def _refusal(what: str):
    if what == "google_endpoint_grpc":
        return lambda: GcsGrpcBackend("b", _transport(protocol="grpc"))
    if what == "grpc_channel":
        return lambda: GcsGrpcBackend(
            "b", _transport(endpoint="insecure://127.0.0.1:9"), channel=object()
        )
    raise AssertionError(what)


@pytest.mark.parametrize("what, item", [
    ("google_endpoint_grpc", "A.2"), ("grpc_channel", "A.2"),
])
def test_refusals_that_stay_name_their_roadmap_item(what, item,
                                                    monkeypatch):
    """Library mode (ROADMAP ``item``, now ported) on a machine without
    grpcio: a non-transient ``StorageError`` naming it, raised before any
    connection, and no ``NotImplementedError`` naming the item."""
    monkeypatch.setitem(sys.modules, "grpc", None)  # import grpc fails
    with pytest.raises(StorageError, match="grpcio does not import") as ei:
        _refusal(what)()
    assert not ei.value.transient
    assert not isinstance(ei.value, NotImplementedError)
    assert f"ROADMAP {item}" not in str(ei.value)


class _Creds:
    """Stand-in for the credentials ``google.auth.default`` finds."""

    valid, token = True, "stub-token"


@pytest.mark.parametrize("what", [
    "google_endpoint_http", "key_file_http", "key_file_config",
])
def test_lifted_auth_switches_build_their_token_source(what, monkeypatch):
    """Refused until the token sources were ported: Google's endpoint
    gets a bearer token from default credentials (stubbed here; the
    client sends nothing until asked), a key file against a test server
    stays anonymous, and a config naming a key file passes the port's
    refusal screen."""
    import google.auth

    monkeypatch.setattr(google.auth, "default", lambda **_k: (_Creds(), "p"))
    if what == "key_file_config":
        cfg = BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.transport.key_file = "/k.json"
        refuse_unported(cfg)
        return
    if what == "google_endpoint_http":
        be = GcsHttpBackend("b", TransportConfig())
        assert be._headers()["Authorization"] == "Bearer stub-token"
        assert "Authorization: Bearer stub-token\r\n" in (
            be.native_request_parts("o")[3])
    else:
        be = GcsHttpBackend("b", _transport(
            endpoint="http://127.0.0.1:9", key_file="/k.json"))
        assert "Authorization" not in be._headers()
    be.close()


@pytest.mark.parametrize("kind", ["http2", "grpc_native"])
def test_read_ranges_lands_every_range_on_one_connection(servers, kind):
    """``read_ranges`` (refused until the multiplexed shard fetch was
    ported) on the two clients that multiplex: ranges of one object as
    concurrent streams of one connection, each landing exactly (an empty
    range lands nothing and sends nothing)."""
    be = servers.client(kind)
    want = deterministic_bytes(NAME, SIZE)
    ranges = [(0, 1), (MIB - 7, 3 * MIB // 2), (SIZE - 10, 10), (7, 0)]
    bufs = [np.zeros(max(ln, 1), dtype=np.uint8) for _, ln in ranges]
    errs = be.read_ranges(NAME, ranges, bufs)
    assert errs == [None] * 4
    assert bufs[3].tobytes() == b"\0"
    for (start, ln), b in zip(ranges[:3], bufs):
        assert b[:ln].tobytes() == want[start:start + ln].tobytes()
    pool = be._h2_pool() if kind == "http2" else be._native_pool()
    assert pool.stats["connects"] == 1
    be.close()


def test_native_receive_lands_in_the_slot_tensor(servers, monkeypatch):
    """The staged route with native receive hands the engine addresses
    inside the staging slots' own storage: no intermediate buffer."""
    engine = get_engine()
    real = engine.lib
    addresses = []

    class Recording:
        def __getattr__(self, name):
            return getattr(real, name)

        def tb_conn_body_read(self, handle, address, want):
            addresses.append((address, want))
            return real.tb_conn_body_read(handle, address, want)

    monkeypatch.setattr(engine, "lib", Recording())
    size = 777_777
    cfg = BenchConfig()
    cfg.workload.bucket = "b"
    cfg.workload.object_name_prefix = "slot/"
    cfg.workload.workers = 1
    cfg.workload.read_calls_per_worker = 1
    cfg.workload.granule_bytes = 64 * 1024
    cfg.staging.slot_bytes = 256 * 1024
    cfg.staging.validate_checksum = True
    srv = FakeGcsServer(FakeBackend.prepopulated("slot/", 1, size)).start()
    cfg.transport = _transport(endpoint=srv.endpoint, native_receive=True)
    slots = []  # (first, end) address of each slot, noted at creation
    factory = make_sink_factory(cfg, device="cpu")

    def kept(i):
        stager = factory(i)
        slots.extend((t.data_ptr(), t.data_ptr() + t.numel())
                     for t in stager._slots)
        return stager

    try:
        res = run_read(cfg, device="cpu", sink_factory=kept)
    finally:
        srv.stop()
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert res.extra["staging_zero_copy"] is True
    assert res.extra["native_conn_stats"]["connects"] == 1
    assert len(slots) == cfg.staging.depth  # the ring's slots
    assert len(addresses) >= size // (64 * 1024)
    for address, want in addresses:
        assert any(lo <= address and address + want <= hi for lo, hi in slots)


def test_open_backend_wraps_every_protocol_in_retry(servers):
    for proto, ep in (("http", servers.h1.endpoint),
                      ("grpc", servers.grpc.endpoint), ("local", "")):
        cfg = BenchConfig()
        cfg.transport = _transport(protocol=proto, endpoint=ep)
        cfg.workload.dir = servers.root
        be = open_backend(cfg)
        assert isinstance(be, RetryingBackend)
        assert type(base_backend(be)).__name__ == {
            "http": "GcsHttpBackend", "grpc": "GcsGrpcBackend",
            "local": "LocalFsBackend"}[proto]
        be.close()
        cfg.transport.retry.policy = "never"
        be = open_backend(cfg)
        assert not isinstance(be, RetryingBackend)
        be.close()
    assert np.array_equal(
        np.frombuffer(_read_all(LocalFsBackend(servers.root).open_read(NAME),
                                4096), np.uint8),
        deterministic_bytes(NAME, SIZE),
    )
