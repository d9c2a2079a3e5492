"""``preflight``: check the run's environment before it spends a benchmark
window (``tpubench/workloads/preflight.py``).

The reference checks nothing and finds out by running against real
infrastructure (a GCP VM, a bucket, credentials). Each precondition is
checked apart here, and the settings the run would use are echoed, so a
misconfiguration costs seconds:

* **auth** — the token source the run would use, resolved and asked
  for a token: a key file or default credentials (ADC) on Google's
  endpoint; a custom endpoint is anonymous, whatever the key file says;
* **bucket** — open the configured backend and list it (auth, network
  and permission in one probe);
* **directpath** — the gRPC DirectPath screen of the reference: grpc
  importable, the default endpoint, and the GCE metadata server
  reachable;
* **native engine** — the C++ engine builds and loads; TLS availability;
* **fetch executor** — for a native executor, the pool shape that
  engages: the port has no fallback, so anything but the requested shape
  fails;
* **env echo** — the endpoint, protocol and credential settings the run
  would use.

Each check is ``{name, ok, skipped, detail}``; ``ok`` overall is the AND
of the checks not skipped. No device is touched (the CLI runs this
before any bring-up, and CUDA is never initialised).
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Callable

from tpubench_torch.config import BenchConfig

_ENV_KEYS = (
    "GOOGLE_APPLICATION_CREDENTIALS",
    "GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS",
    "JAX_PLATFORMS",
    "XLA_FLAGS",
    "TPUBENCH_NUM_PROCESSES",
    "TPUBENCH_PROCESS_ID",
    "TPUBENCH_COORDINATOR",
)

_METADATA_HOST = "metadata.google.internal"


def _check(name: str, ok: bool, detail: str, skipped: bool = False) -> dict:
    return {"name": name, "ok": ok, "skipped": skipped, "detail": detail}


def _bounded(name: str, fn: Callable[[], dict], timeout_s: float) -> dict:
    """Run a probe under a hard wall-clock bound: DNS lookups with no
    egress and connects to unreachable networks hang past any library
    timeout (getaddrinfo has none). A daemon thread, so a hung resolver
    cannot hold up the process's exit."""
    box: dict = {}

    def _run() -> None:
        try:
            box["result"] = fn()
        except Exception as e:  # noqa: BLE001 — reported as the check's failure
            box["error"] = str(e)

    t = threading.Thread(target=_run, daemon=True, name=f"preflight-{name}")
    t.start()
    t.join(timeout=timeout_s)
    if t.is_alive():
        return _check(
            name, False,
            f"probe exceeded {timeout_s:.0f}s (network unreachable or "
            "hanging resolver)",
        )
    if "error" in box:
        return _check(name, False, f"probe raised: {box['error']}")
    return box["result"]


def _auth_check(cfg: BenchConfig) -> dict:
    from tpubench_torch.storage.auth import (
        AnonymousTokenSource,
        make_token_source,
    )

    t = cfg.transport
    if t.protocol in ("fake", "local"):
        return _check(
            "auth", True,
            f"protocol {t.protocol!r} needs no credentials", skipped=True,
        )
    try:
        src = make_token_source(t.key_file, t.endpoint)
    except Exception as e:  # noqa: BLE001 — bad key file, no ADC
        return _check("auth", False, f"token source construction: {e}")
    if isinstance(src, AnonymousTokenSource):
        return _check(
            "auth", True,
            f"custom endpoint {t.endpoint!r}: anonymous (no Authorization "
            "header) — hermetic/fake-server mode",
        )
    try:
        tok = src.token()
    except Exception as e:  # noqa: BLE001 — refresh failure
        return _check("auth", False, f"token refresh failed: {e}")
    if not tok:
        return _check("auth", False, "token source returned no token")
    kind = "service-account key" if t.key_file else "ADC"
    return _check("auth", True, f"{kind} minted a bearer token (not shown)")


def _bucket_check(cfg: BenchConfig) -> dict:
    from tpubench_torch.storage import open_backend

    w = cfg.workload
    if cfg.transport.protocol == "fake":
        # In-process: nothing to reach (and building it would generate
        # workers x object_size bytes — gigabytes at the default config).
        return _check(
            "bucket", True, "in-process fake backend: always reachable",
            skipped=True,
        )
    try:
        backend = open_backend(cfg)
    except Exception as e:  # noqa: BLE001 — any construction failure fails the check
        return _check("bucket", False, f"backend construction: {e}")
    try:
        objs = backend.list(w.object_name_prefix)
        return _check(
            "bucket", True,
            f"list({w.object_name_prefix!r}) on {w.bucket!r}: "
            f"{len(objs)} object(s) visible",
        )
    except Exception as e:  # noqa: BLE001 — 403/404/network
        return _check("bucket", False, f"list on {w.bucket!r} failed: {e}")
    finally:
        backend.close()


def _metadata_server_reachable(timeout_s: float = 0.6) -> bool:
    try:
        with socket.create_connection((_METADATA_HOST, 80), timeout=timeout_s):
            return True
    except OSError:
        return False


def _directpath_check(cfg: BenchConfig) -> dict:
    t = cfg.transport
    if t.protocol != "grpc" or not t.directpath:
        return _check(
            "directpath", True,
            "not requested (protocol!=grpc or transport.directpath=False)",
            skipped=True,
        )
    try:
        import grpc  # noqa: F401 — DirectPath needs grpcio's resolver
    except Exception as e:  # noqa: BLE001 — any import failure means ineligible
        return _check("directpath", False, f"grpcio unavailable: {e}")
    if t.endpoint and "googleapis.com" not in t.endpoint:
        return _check(
            "directpath", False,
            f"custom endpoint {t.endpoint!r}: the google-c2p resolver "
            "only applies to the default endpoint",
        )
    if not _metadata_server_reachable():
        return _check(
            "directpath", False,
            f"GCE metadata server ({_METADATA_HOST}) unreachable: not a "
            "GCP VM, DirectPath backends cannot be selected",
        )
    xds = os.environ.get("GOOGLE_CLOUD_ENABLE_DIRECT_PATH_XDS", "")
    return _check(
        "directpath", True,
        "on-GCP (metadata server reachable); google-c2p resolver will "
        f"probe eligibility at channel build (DIRECT_PATH_XDS={xds!r})",
    )


def _engine():
    """``(engine, "")`` or ``(None, why it did not build or load)``."""
    from tpubench_torch.native.engine import get_engine

    try:
        return get_engine(), ""
    except Exception as e:  # noqa: BLE001 — reported by the checks
        return None, str(e)


def _engine_check(cfg: BenchConfig) -> dict:
    need = (
        cfg.transport.native_receive
        or cfg.transport.http2
        or cfg.workload.fetch_executor.startswith("native")
    )
    eng, err = _engine()
    if eng is None:
        return _check("native_engine", not need,
                      f"native engine unavailable: {err}", skipped=not need)
    return _check(
        "native_engine", True,
        f"engine loaded (tls={'yes' if eng.tls_available() else 'no'})",
    )


def _executor_check(cfg: BenchConfig) -> dict:
    """The pool shape a native executor engages: a one-connection pool is
    made as the run would make it and its mode read back. The port has
    no fallback, so a shape other than the requested one fails."""
    from tpubench_torch.workloads.fetch_executor import executor_mode

    fe = cfg.workload.fetch_executor
    if not fe.startswith("native"):
        return _check(
            "fetch_executor", True, f"python orchestration path ({fe})",
            skipped=True,
        )
    eng, _ = _engine()
    if eng is None:
        # The native_engine check already reports the build failure.
        return _check("fetch_executor", True, "see native_engine",
                      skipped=True)
    t = cfg.transport
    requested = executor_mode(fe)
    endpoint = t.endpoint or "https://storage.googleapis.com"
    try:
        pool = eng.pool_create(
            1, tls=endpoint.startswith("https"), cafile=t.tls_ca_file,
            insecure=t.tls_insecure_skip_verify, mode=requested,
            h2=t.http2 and requested == "reactor",
        )
    except Exception as e:  # noqa: BLE001 — reported as the check's failure
        return _check("fetch_executor", False, f"pool creation: {e}")
    engaged = pool.mode
    pool.close()
    if engaged != requested:
        return _check(
            "fetch_executor", False,
            f"requested {requested} ({fe}) but {engaged} engaged",
        )
    if engaged == "threads":
        return _check("fetch_executor", True, "legacy thread pool (pinned)")
    return _check("fetch_executor", True, f"reactor engages ({fe})")


def run_preflight(cfg: BenchConfig, probe_timeout_s: float = 15.0) -> dict:
    checks = [
        _bounded("auth", lambda: _auth_check(cfg), probe_timeout_s),
        _bounded("bucket", lambda: _bucket_check(cfg), probe_timeout_s),
        _bounded("directpath", lambda: _directpath_check(cfg), probe_timeout_s),
        _engine_check(cfg),
        _executor_check(cfg),
    ]
    t = cfg.transport
    endpoint = t.endpoint or (
        "https://storage.googleapis.com" if t.protocol == "http"
        else "storage.googleapis.com:443" if t.protocol == "grpc"
        else "(in-process)"
    )
    env = {
        "protocol": t.protocol,
        "endpoint": endpoint,
        "bucket": cfg.workload.bucket,
        "object_name_prefix": cfg.workload.object_name_prefix,
        "http2": t.http2,
        "native_receive": t.native_receive,
        "directpath": t.directpath,
        "fetch_executor": cfg.workload.fetch_executor,
        "key_file": t.key_file or "(ADC)",
        "env": {k: os.environ.get(k, "") for k in _ENV_KEYS},
    }
    ok = all(c["ok"] for c in checks if not c["skipped"])
    return {"ok": ok, "checks": checks, "effective": env}


def format_preflight(result: dict) -> str:
    lines = []
    for c in result["checks"]:
        mark = "SKIP" if c["skipped"] else ("ok " if c["ok"] else "FAIL")
        lines.append(f"[{mark}] {c['name']}: {c['detail']}")
    e = result["effective"]
    lines.append(
        f"run would use: protocol={e['protocol']} endpoint={e['endpoint']} "
        f"bucket={e['bucket']} prefix={e['object_name_prefix']} "
        f"http2={e['http2']} native_receive={e['native_receive']} "
        f"directpath={e['directpath']} executor={e['fetch_executor']} "
        f"creds={e['key_file']}"
    )
    for k, v in e["env"].items():
        if v:
            lines.append(f"  {k}={v}")
    lines.append("preflight: " + ("OK" if result["ok"] else "FAILED"))
    return "\n".join(lines)
