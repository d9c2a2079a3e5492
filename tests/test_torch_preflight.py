"""``preflight`` of the port against ``tpubench``'s: the counterparts of
the preflight tests of ``tests/test_preflight_report.py``, each running one
config through both packages' ``run_preflight`` and comparing the checks,
plus the auth check on Google's endpoint (default credentials stubbed,
present or absent) and the check's being device-free.

No check here reaches past this machine: the GCE metadata probe is
replaced by ``False`` in both packages, ``google.auth.default`` by a stub
(no test looks for real credentials), and the bucket checks are run only
where the client fails before it connects."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.workloads import preflight as jax_pf

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_server import FakeGcsServer
from tpubench_torch.workloads import preflight

REPO = Path(__file__).resolve().parents[1]


class _Creds:
    """Stand-in for credentials ``google.auth.default`` found."""

    valid, token = True, "stub-token"


@pytest.fixture(autouse=True)
def _off_gcp(monkeypatch):
    import google.auth
    import google.auth.exceptions

    def absent(*_a, **_k):
        raise google.auth.exceptions.DefaultCredentialsError("no ADC (stub)")

    for mod in (jax_pf, preflight):
        monkeypatch.setattr(mod, "_metadata_server_reachable", lambda: False)
    monkeypatch.setattr(google.auth, "default", absent)


def _both(**transport):
    cfgs = []
    for cls in (JaxBenchConfig, BenchConfig):
        cfg = cls()
        for k, v in transport.items():
            setattr(cfg.transport, k, v)
        cfgs.append(cfg)
    return cfgs


def _checks(result):
    return {c["name"]: c for c in result["checks"]}


def test_preflight_fake_protocol_all_green():
    ref_cfg, cfg = _both(protocol="fake")
    ref, res = jax_pf.run_preflight(ref_cfg), preflight.run_preflight(cfg)
    assert res["checks"] == ref["checks"]
    assert res["ok"] is ref["ok"] is True
    assert set(res["effective"]) == set(ref["effective"])
    c = _checks(res)
    assert c["auth"]["skipped"] and c["bucket"]["skipped"]
    assert c["directpath"]["skipped"]
    assert "preflight: OK" in preflight.format_preflight(res)


def test_preflight_custom_endpoint_anonymous_auth_and_live_bucket():
    be = FakeBackend.prepopulated("bench/file_", count=3, size=1000)
    with FakeGcsServer(be) as srv:
        ref_cfg, cfg = _both(protocol="http", endpoint=srv.endpoint)
        for c in (ref_cfg, cfg):
            c.workload.bucket = "testbucket"
            c.workload.object_name_prefix = "bench/file_"
        ref, res = jax_pf.run_preflight(ref_cfg), preflight.run_preflight(cfg)
    assert res["checks"] == ref["checks"]
    assert res["effective"] == ref["effective"]
    c = _checks(res)
    assert res["ok"] is True
    assert c["auth"]["ok"] and "anonymous" in c["auth"]["detail"]
    assert c["bucket"]["ok"] and "3 object(s)" in c["bucket"]["detail"]


def test_preflight_unreachable_bucket_fails():
    ref_cfg, cfg = _both(protocol="http", endpoint="http://127.0.0.1:9")
    for c in (ref_cfg, cfg):
        c.workload.bucket = "nope"
    ref = jax_pf.run_preflight(ref_cfg, probe_timeout_s=1.0)
    res = preflight.run_preflight(cfg, probe_timeout_s=1.0)
    assert res["checks"] == ref["checks"]
    c = _checks(res)
    assert res["ok"] is False and c["bucket"]["ok"] is False
    assert "exceeded" in c["bucket"]["detail"]


def test_preflight_bad_key_file_fails_auth_naming_a2():
    """A missing key file on Google's endpoint: both packages fail
    building the token source, with the same auth check, and fail the
    run, before any request. Over HTTP the bucket checks are equal too.
    Over gRPC (library mode) the port's call credentials come from the
    key file and fail on it, where ``tpubench``'s library mode ignores
    the key file and fails on the absent default credentials: a known
    difference, never a pass."""
    for protocol in ("http", "grpc"):
        ref_cfg, cfg = _both(protocol=protocol, directpath=False,
                             key_file="/nonexistent/sa-key.json")
        ref_auth = jax_pf._auth_check(ref_cfg)  # local: reads the key file
        ref_bucket = jax_pf._bucket_check(ref_cfg)  # fails building it
        assert ref_auth["ok"] is False
        res = preflight.run_preflight(cfg, probe_timeout_s=5.0)
        c = _checks(res)
        assert c["auth"] == ref_auth
        assert c["auth"]["ok"] is False and c["auth"]["skipped"] is False
        assert "/nonexistent/sa-key.json" in c["auth"]["detail"]
        assert c["bucket"]["ok"] is ref_bucket["ok"] is False
        assert not c["bucket"]["skipped"]
        assert "backend construction" in c["bucket"]["detail"]
        assert "ROADMAP A.2" not in c["bucket"]["detail"]
        if protocol == "http":
            assert c["bucket"] == ref_bucket
        else:
            assert "/nonexistent/sa-key.json" in c["bucket"]["detail"]
            assert "no ADC (stub)" in ref_bucket["detail"]
        assert res["ok"] is False


@pytest.mark.parametrize("protocol", ["http", "grpc"])
def test_preflight_default_endpoint_credentials_fail_naming_a2(
        protocol, monkeypatch):
    """Default credentials on Google's endpoint, on a machine without
    them: the auth and bucket checks fail as ``tpubench``'s do, never
    skipped or ok, and no request leaves the machine (each client fails
    building its credentials: the gRPC one in library mode). Where grpcio
    does not import, the gRPC bucket check names it."""
    ref_cfg, cfg = _both(protocol=protocol, directpath=False)
    res = preflight.run_preflight(cfg, probe_timeout_s=5.0)
    c = _checks(res)
    assert c["auth"] == jax_pf._auth_check(ref_cfg)
    assert c["auth"]["ok"] is False and not c["auth"]["skipped"]
    assert "token source construction" in c["auth"]["detail"]
    assert c["bucket"] == jax_pf._bucket_check(ref_cfg)
    assert c["bucket"]["ok"] is False and not c["bucket"]["skipped"]
    assert "no ADC (stub)" in c["bucket"]["detail"]
    assert res["ok"] is False
    if protocol == "grpc":
        monkeypatch.setitem(sys.modules, "grpc", None)  # import grpc fails
        res = preflight.run_preflight(cfg, probe_timeout_s=5.0)
        c = _checks(res)
        assert c["bucket"]["ok"] is False and not c["bucket"]["skipped"]
        assert "grpcio does not import" in c["bucket"]["detail"]
        assert res["ok"] is False


@pytest.mark.parametrize("key_file", ["", "/k.json"], ids=["adc", "key_file"])
def test_preflight_token_source_mints_as_in_reference(key_file, monkeypatch):
    """Credentials present (stubbed): the auth check resolves the source,
    mints a token and reports which kind, as ``tpubench``'s does; a key
    file against a test server's endpoint stays anonymous."""
    import google.auth
    from google.oauth2 import service_account

    monkeypatch.setattr(google.auth, "default", lambda **_k: (_Creds(), "p"))
    monkeypatch.setattr(service_account.Credentials,
                        "from_service_account_file",
                        classmethod(lambda cls, *_a, **_k: _Creds()))
    ref_cfg, cfg = _both(protocol="http", key_file=key_file)
    c = preflight._auth_check(cfg)
    assert c == jax_pf._auth_check(ref_cfg)
    kind = "service-account key" if key_file else "ADC"
    assert c["ok"] is True and c["detail"].startswith(kind)
    assert "stub-token" not in c["detail"]
    ref_cfg, cfg = _both(protocol="http", key_file=key_file,
                         endpoint="http://127.0.0.1:9")
    c = preflight._auth_check(cfg)
    assert c == jax_pf._auth_check(ref_cfg)
    assert c["ok"] is True and "anonymous" in c["detail"]


def test_preflight_directpath_off_gcp_or_custom_endpoint():
    ref_cfg, cfg = _both(protocol="grpc", directpath=True,
                         endpoint="insecure://127.0.0.1:1")
    ref = _checks(jax_pf.run_preflight(ref_cfg, probe_timeout_s=1.0))
    c = _checks(preflight.run_preflight(cfg, probe_timeout_s=1.0))
    assert c["directpath"]["ok"] is False
    assert "custom endpoint" in c["directpath"]["detail"]
    assert c["directpath"]["ok"] == ref["directpath"]["ok"]
    # The default endpoint, off GCP: the same screen (the auth and bucket
    # checks are not run for the reference here: they would reach out).
    ref_cfg, cfg = _both(protocol="grpc", directpath=True)
    assert preflight._directpath_check(cfg) == jax_pf._directpath_check(ref_cfg)
    assert preflight._directpath_check(cfg)["skipped"] is False


@pytest.mark.parametrize("executor, detail", [
    ("native", "reactor engages (native)"),
    ("native-threads", "legacy thread pool (pinned)"),
])
def test_preflight_engine_and_executor_checks(executor, detail):
    ref_cfg, cfg = _both(protocol="http", endpoint="http://127.0.0.1:9")
    for c in (ref_cfg, cfg):
        c.workload.fetch_executor = executor
    for name in ("_engine_check", "_executor_check"):
        assert getattr(preflight, name)(cfg) == getattr(jax_pf, name)(ref_cfg)
    assert preflight._executor_check(cfg) == preflight._check(
        "fetch_executor", True, detail)


def test_preflight_cli_exit_codes(tmp_path, capsys):
    """Exit 0 and ``preflight: OK`` for the fake store, 1 against a dead
    endpoint, in both CLIs (the dead endpoint under retry policy
    ``never``, so the list fails at once rather than at the bound)."""
    from tpubench.cli import main as jax_main

    conf = tmp_path / "never.json"
    conf.write_text(json.dumps({"transport": {"retry": {"policy": "never"}}}))
    for main in (jax_main, cli.main):
        assert main(["preflight", "--protocol", "fake"]) == 0
        out = capsys.readouterr().out
        assert "preflight: OK" in out and '"ok": true' in out
        assert main(["preflight", "--protocol", "http", "--config", str(conf),
                     "--endpoint", "http://127.0.0.1:9"]) == 1
        assert "preflight: FAILED" in capsys.readouterr().out


def test_preflight_is_device_free():
    """Run with no visible GPU it still passes, and it never initialises
    CUDA (every other command refuses to run there without --device
    cpu)."""
    code = ("import sys, torch; from tpubench_torch.cli import main; "
            "rc = main(['preflight', '--protocol', 'fake']); "
            "print('cuda_initialized', torch.cuda.is_initialized()); "
            "sys.exit(rc)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr
    assert "preflight: OK" in proc.stdout
    assert "cuda_initialized False" in proc.stdout
    preflight.run_preflight(BenchConfig())
    assert not torch.cuda.is_initialized()
