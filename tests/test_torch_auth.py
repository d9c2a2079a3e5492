"""Token sources of the port (``tpubench_torch.storage.auth``) against
``tests/test_auth.py``: key file against ADC, the anonymous source for a
test server's endpoint, the scope, and the static source; then a bearer
token from a ``StaticTokenSource`` reaching the port's fake servers on
every client route that sends one.

No test looks for real credentials: ``google.auth.default`` is replaced
by a stub, so no request leaves the machine."""

import json

import numpy as np
import pytest

from tpubench.storage import auth as ref_auth

from tpubench_torch.config import BenchConfig, TransportConfig
from tpubench_torch.storage import fake_h2_server, fake_server
from tpubench_torch.storage.auth import (
    GCS_SCOPE,
    AnonymousTokenSource,
    GoogleTokenSource,
    StaticTokenSource,
    make_token_source,
)
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_h2_server import FakeH2Server
from tpubench_torch.storage.gcs_http import GcsHttpBackend
from tpubench_torch.workloads.read import run_read


class _Creds:
    valid, token = True, "adc-token"


@pytest.fixture
def adc(monkeypatch):
    """``google.auth.default`` stubbed; ``found`` says whether it finds
    credentials."""
    import google.auth
    import google.auth.exceptions

    state = {"found": False}

    def default(*_a, **_k):
        if not state["found"]:
            raise google.auth.exceptions.DefaultCredentialsError("no ADC (stub)")
        return _Creds(), "project"

    monkeypatch.setattr(google.auth, "default", default)
    return state


def test_scope_matches_reference():
    # auth.go:60 uses gcs.Scope_FullControl.
    assert GCS_SCOPE == ref_auth.GCS_SCOPE == (
        "https://www.googleapis.com/auth/devstorage.full_control")


def test_anonymous_source_returns_none():
    assert AnonymousTokenSource().token() is None


def test_non_google_endpoint_is_anonymous():
    for key_file in ("", "/nonexistent/key.json"):
        src = make_token_source(key_file, "http://127.0.0.1:9000")
        assert isinstance(src, AnonymousTokenSource)
        assert isinstance(ref_auth.make_token_source(
            key_file, "http://127.0.0.1:9000"), ref_auth.AnonymousTokenSource)


def test_google_endpoint_uses_google_source(adc):
    import google.auth.exceptions

    for make in (make_token_source, ref_auth.make_token_source):
        with pytest.raises(google.auth.exceptions.DefaultCredentialsError):
            make("", "")
    adc["found"] = True
    src = make_token_source("", "https://storage.googleapis.com")
    assert isinstance(src, GoogleTokenSource) and src.token() == "adc-token"


def test_bad_key_file_raises(tmp_path):
    bad = tmp_path / "key.json"
    bad.write_text(json.dumps({"type": "service_account"}))  # missing fields
    for cls in (GoogleTokenSource, ref_auth.GoogleTokenSource):
        with pytest.raises(ValueError):
            cls(str(bad))


def test_static_source_expiry():
    assert StaticTokenSource("tok", ttl_s=3600).token() == "tok"
    assert StaticTokenSource("tok", ttl_s=-1).token() is None


def test_bearer_token_reaches_the_fake_servers(monkeypatch):
    """A ``StaticTokenSource`` handed to the HTTP client: every request
    carries ``Authorization: Bearer``, on the Python HTTP/1.1 route, the
    native receive and the h2 client; the executor route takes the header
    from the client's request parts."""
    seen = []
    real_get = fake_server._Handler.do_GET

    def do_get(handler):
        seen.append(("h1", handler.headers.get("Authorization")))
        return real_get(handler)

    monkeypatch.setattr(fake_server._Handler, "do_GET", do_get)
    real_h2 = fake_h2_server._Conn._handle
    monkeypatch.setattr(fake_h2_server._Conn, "_handle", lambda c, stream, h: (
        seen.append(("h2", h.get("authorization"))), real_h2(c, stream, h)))
    name, size = "tpubench/file_0", 300_001
    want = deterministic_bytes(name, size)
    tok = StaticTokenSource("s3cret")
    store = FakeBackend.prepopulated("tpubench/file_", 1, size)
    with fake_server.FakeGcsServer(store) as h1, FakeH2Server(store) as h2:
        for route, ep, kw in (("h1", h1, {}),
                              ("h1", h1, {"native_receive": True}),
                              ("h2", h2, {"http2": True})):
            be = GcsHttpBackend("b", TransportConfig(endpoint=ep.endpoint, **kw),
                                token_source=tok)
            buf = np.zeros(size, dtype=np.uint8)
            r = be.open_read(name)
            got = 0
            while got < size:
                got += r.readinto(memoryview(buf)[got:])
            r.close()
            be.close()
            assert np.array_equal(buf, want), (route, kw)
        assert seen and all(v == "Bearer s3cret" for _, v in seen), seen
        assert {r for r, _ in seen} == {"h1", "h2"}
        seen.clear()
        cfg = BenchConfig()
        cfg.transport.protocol = "http"
        cfg.transport.endpoint = h1.endpoint
        cfg.workload.bucket = "testbucket"
        cfg.workload.workers = cfg.workload.read_calls_per_worker = 1
        cfg.workload.fetch_executor = "native"
        cfg.staging.mode = "none"
        be = GcsHttpBackend("testbucket", cfg.transport, token_source=tok)
        res = run_read(cfg, backend=be, device="cpu")
        be.close()
    assert res.errors == 0 and res.bytes_total == size
    assert seen and all(v == "Bearer s3cret" for _, v in seen), seen
