"""The port stands alone: no module of ``tpubench_torch`` loads ``jax`` or
any module of the JAX package ``tpubench``, and its entry points refuse to
carry on on the CPU unless asked to."""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tpubench_torch
from tpubench_torch.config import BenchConfig

REPO = Path(__file__).resolve().parents[1]


def _all_modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(
            tpubench_torch.__path__, prefix="tpubench_torch."
        )
    )


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, env={**os.environ, **env},
    )


def test_every_module_imports_without_jax_or_tpubench():
    mods = _all_modules()
    assert "tpubench_torch.kernels.landing" in mods and len(mods) >= 20
    assert {
        "tpubench_torch.native.build", "tpubench_torch.native.engine",
        "tpubench_torch.storage.gcs_http", "tpubench_torch.storage.retry",
        "tpubench_torch.workloads.fetch_executor",
        "tpubench_torch.storage.retrying", "tpubench_torch.storage.local_fs",
        "tpubench_torch.storage.native_pool",
        "tpubench_torch.storage.fake_server",
        "tpubench_torch.storage.fake_h2_server",
        "tpubench_torch.storage.fake_grpc_wire_server",
        "tpubench_torch.storage.fake_grpc_server",
        "tpubench_torch.storage.gcs_grpc",
        "tpubench_torch.storage.grpc_wire.client",
        "tpubench_torch.storage.grpc_wire.framing",
        "tpubench_torch.storage.grpc_wire.proto",
        "tpubench_torch.storage.tail", "tpubench_torch.obs.flight",
        "tpubench_torch.obs.tracing", "tpubench_torch.obs.exporters",
        "tpubench_torch.obs.trace", "tpubench_torch.obs.telemetry",
        "tpubench_torch.obs.profiling", "tpubench_torch.dist.bringup",
        "tpubench_torch.dist.reassemble", "tpubench_torch.dist.shard",
        "tpubench_torch.workloads.pod_ingest",
        "tpubench_torch.workloads.gather_bench",
        "tpubench_torch.workloads.probe",
        "tpubench_torch.tune.controller", "tpubench_torch.workloads.tune_cmd",
        "tpubench_torch.workloads.report_cmd",
        "tpubench_torch.workloads.chaos", "tpubench_torch.obs.live",
        "tpubench_torch.replay.gate", "tpubench_torch.workloads.fsbench",
        "tpubench_torch.workloads.preflight",
        "tpubench_torch.storage.auth",
        "tpubench_torch.workloads.pod_ingest_stream",
        "tpubench_torch.dist.sweep",
        "tpubench_torch.mem", "tpubench_torch.mem.slab",
        "tpubench_torch.pipeline", "tpubench_torch.pipeline.cache",
        "tpubench_torch.pipeline.prefetch",
        "tpubench_torch.workloads.train_ingest",
        "tpubench_torch.pipeline.coop", "tpubench_torch.dist.peer",
        "tpubench_torch.workloads.arrivals",
        "tpubench_torch.lifecycle", "tpubench_torch.lifecycle.manifest",
        "tpubench_torch.lifecycle.upload", "tpubench_torch.workloads.ckpt",
        "tpubench_torch.serve", "tpubench_torch.serve.qos",
        "tpubench_torch.replay.bundle", "tpubench_torch.dist.membership",
        "tpubench_torch.storage.reactor_backend",
        "tpubench_torch.workloads.serve",
        "tpubench_torch.lifecycle.storm", "tpubench_torch.lifecycle.delta",
        "tpubench_torch.workloads.meta_storm",
        "tpubench_torch.workloads.drill", "tpubench_torch.replay.driver",
        "tpubench_torch.fleet", "tpubench_torch.fleet.vtime",
        "tpubench_torch.fleet.calibrate", "tpubench_torch.fleet.driver",
        "tpubench_torch.analysis", "tpubench_torch.analysis.core",
        "tpubench_torch.analysis.threads",
        "tpubench_torch.analysis.lifecycle",
        "tpubench_torch.analysis.determinism",
        "tpubench_torch.analysis.lockorder",
        "tpubench_torch.analysis.drift", "tpubench_torch.analysis.passes",
    } <= set(mods)
    proc = _run(
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = [
        m for m in loaded
        if m in ("jax", "tpubench")
        or m.startswith(("jax.", "jaxlib", "tpubench."))
    ]
    assert banned == [], banned
    assert "torch" in loaded
    # The optional export packages load only when a run asks for them,
    # and google.auth only when a client needs Google's credentials.
    lazy = [
        m for m in loaded
        if m.startswith(("opentelemetry", "google.cloud.monitoring",
                         "google.auth"))
    ]
    assert lazy == [], lazy


def test_no_source_file_names_the_jax_package_in_an_import():
    for path in Path(tpubench_torch.__path__[0]).rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith("jax.")
                            or mod == "tpubench"
                            or mod.startswith("tpubench.")), (path, s)


def test_run_read_without_cuda_raises(monkeypatch):
    """Without a GPU and without device='cpu', the entry point raises
    instead of running on the CPU."""
    from tpubench_torch.workloads.read import run_read

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 1
    cfg.workload.object_size = 1024
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_read(cfg)


@pytest.mark.parametrize("entry", ["pod_ingest", "gather_bench", "probe",
                                   "stream"])
def test_pod_entry_points_without_cuda_raise(entry, monkeypatch):
    """``pod-ingest``, ``gather-bench``, ``probe`` and ``stream`` raise
    without a GPU unless asked for the CPU — before any process group is
    brought up."""
    import torch.distributed as dist

    from tpubench_torch.workloads.gather_bench import run_gather_bench
    from tpubench_torch.workloads.pod_ingest import run_pod_ingest
    from tpubench_torch.workloads.pod_ingest_stream import (
        run_pod_ingest_stream,
    )
    from tpubench_torch.workloads.probe import run_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 1
    cfg.workload.object_size = 1024
    run = {"pod_ingest": run_pod_ingest, "gather_bench": run_gather_bench,
           "probe": run_probe,
           "stream": lambda c: run_pod_ingest_stream(c, n_objects=2)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(cfg)
    assert not dist.is_initialized()


def test_native_route_without_cuda_raises(monkeypatch):
    """The native executor route, too, raises without a GPU unless it is
    asked for the CPU — before any engine build or request."""
    from tpubench_torch.workloads.read import run_read

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = BenchConfig()
    cfg.transport.protocol = "http"
    cfg.transport.endpoint = "http://127.0.0.1:9"
    cfg.workload.fetch_executor = "native"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_read(cfg)


def test_engine_builds_only_from_the_ports_sources():
    """``native.build`` compiles ``tpubench_torch/native/csrc`` (whose
    local includes stay in that folder) into ``build/tpubench_torch``."""
    import re

    from tpubench_torch.native import build

    csrc = REPO / "tpubench_torch" / "native" / "csrc"
    files = build.SOURCES + build.HEADERS
    assert {p.name for p in files} == {"engine.cc", "hpack_huffman.h"}
    assert all(p.parent == csrc and p.is_file() for p in files)
    for p in files:
        for inc in re.findall(r'#include\s+"([^"]+)"', p.read_text()):
            assert (csrc / inc).is_file(), (p.name, inc)
    assert build.library_path().parent == REPO / "build" / "tpubench_torch"
    assert build.library_path().name.startswith("libtb_engine-")
    # The sanitizer matrix's stress binary: the port's copy of the
    # harness, built beside the library.
    assert build.STRESS_SOURCE == csrc / "stress.cc"
    assert not re.findall(r'#include\s+"', build.STRESS_SOURCE.read_text())
    for san in build.SANITIZERS:
        path = build.stress_path(san)
        assert path.parent == REPO / "build" / "tpubench_torch"
        assert path.name.startswith(f"stress_{san}-")


def test_cli_exits_nonzero_without_cuda_and_runs_with_device_cpu(tmp_path):
    args = ("from tpubench_torch.cli import main; import sys; sys.exit(main("
            "['read', '--protocol', 'fake', '--workers', '2', "
            "'--read-call-per-worker', '1', '--object-size', '300001', "
            "'--granule-bytes', '65536', '--staging', 'pallas', "
            f"'--results-dir', {str(tmp_path)!r}")
    no_gpu = _run(args + "]))", CUDA_VISIBLE_DEVICES="")
    assert no_gpu.returncode != 0
    assert "device='cpu'" in no_gpu.stderr
    assert not list(tmp_path.iterdir())
    cpu = _run(args + ", '--device', 'cpu']))")
    assert cpu.returncode == 0, cpu.stderr
    path = cpu.stdout.strip().splitlines()[-1].removeprefix("result: ")
    res = json.loads(Path(path).read_text())
    assert res["extra"]["checksum_ok"] is True
    assert res["extra"]["staged_bytes"] == 2 * 300_001


@pytest.mark.parametrize("cmd", ["pod-ingest", "gather-bench", "probe",
                                 "sweep", "list", "stream", "train-ingest",
                                 "serve", "chaos", "fleet"])
def test_pod_commands_exit_nonzero_without_cuda(cmd, tmp_path):
    argv = [cmd, "--protocol", "fake", "--workers", "1", "--object-size",
            "70001", "--dir", str(tmp_path), "--results-dir", str(tmp_path)]
    if cmd == "sweep":
        argv += ["--sweep-protocols", "fake", "--sweep-sizes", "256kb"]
    no_gpu = _run("from tpubench_torch.cli import main; import sys; "
                  f"sys.exit(main({argv!r}))", CUDA_VISIBLE_DEVICES="")
    assert no_gpu.returncode != 0
    assert "device='cpu'" in no_gpu.stderr
    assert not list(tmp_path.iterdir())


def test_unported_protocol_raises_not_implemented(monkeypatch):
    """gRPC to Google's endpoint is library mode now: where ``grpcio``
    does not import, the run stops before the client connects (or asks
    for credentials) with a non-transient ``StorageError`` naming it,
    and never with the old ``NotImplementedError``."""
    from tpubench_torch.storage.base import StorageError
    from tpubench_torch.workloads.read import run_read

    monkeypatch.setitem(sys.modules, "grpc", None)  # import grpc fails
    cfg = BenchConfig()
    cfg.transport.protocol = "grpc"  # Google's endpoint
    with pytest.raises(StorageError, match="grpcio does not import") as ei:
        run_read(cfg, device="cpu")
    assert not ei.value.transient
    assert not isinstance(ei.value, NotImplementedError)
    assert "ROADMAP A.2" not in str(ei.value)


# An import hook that makes grpcio and the storage-v2 types unimportable,
# as on a machine that has neither.
_NO_GRPCIO = (
    "import sys, importlib.abc\n"
    "class _Block(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path, target=None):\n"
    "        if name == 'grpc' or name.startswith(('grpc.', "
    "'google.cloud._storage_v2')):\n"
    "            raise ImportError(f'{name} blocked')\n"
    "sys.meta_path.insert(0, _Block())\n"
)


def test_port_runs_without_grpcio(tmp_path):
    """Without grpcio (and the storage-v2 types): every module but the
    grpcio fake server imports, ``read --protocol grpc`` runs in wire mode,
    the only mode left, over the wire fake to completion, and the default
    endpoint raises the ``StorageError`` naming grpcio before any
    connection."""
    mods = [m for m in _all_modules()
            if m != "tpubench_torch.storage.fake_grpc_server"]
    proc = _run(
        _NO_GRPCIO
        + "import importlib, json\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "from tpubench_torch.cli import main\n"
        "from tpubench_torch.config import TransportConfig\n"
        "from tpubench_torch.storage.base import StorageError\n"
        "from tpubench_torch.storage.fake import FakeBackend\n"
        "from tpubench_torch.storage.fake_grpc_wire_server import "
        "FakeGrpcWireServer\n"
        "from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend\n"
        "store = FakeBackend.prepopulated('tpubench/file_', 2, 300001)\n"
        "srv = FakeGrpcWireServer(store).start()\n"
        "rc = main(['read', '--protocol', 'grpc', '--endpoint', "
        "srv.endpoint, '--bucket', 'testbucket', '--workers', '2', "
        "'--read-call-per-worker', '1', '--object-size', '300001', "
        "'--granule-bytes', '65536', '--validate', '--device', 'cpu', "
        f"'--results-dir', {str(tmp_path)!r}])\n"
        "srv.stop()\n"
        "try:\n"
        "    GcsGrpcBackend('b', TransportConfig())\n"
        "    refusal = None\n"
        "except StorageError as e:\n"
        "    refusal = [str(e), e.transient]\n"
        "print(json.dumps({'rc': rc, 'refusal': refusal, 'loaded': "
        "sorted(m for m in sys.modules if m == 'grpc' or "
        "m.startswith(('grpc.', 'google.cloud._storage_v2', "
        "'google.auth')))}))\n"
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["loaded"] == []
    msg, transient = out["refusal"]
    assert "grpcio does not import" in msg and transient is False
    path = proc.stdout.strip().splitlines()[-2].removeprefix("result: ")
    res = json.loads(Path(path).read_text())
    assert res["errors"] == 0 and res["extra"]["checksum_ok"] is True
    assert res["extra"]["staged_bytes"] == 2 * 300_001


def test_multichip_child_never_imports_jax(tmp_path):
    """A ``multichip-sweep`` child (one rank on the CPU, a small shard)
    runs its pod-ingest rows without loading ``jax`` or ``tpubench``."""
    proc = _run(
        "import json, sys\n"
        "from tpubench_torch.dist import sweep\n"
        "sweep.main(['--child', '1', '--rank', '0', '--port', '0', "
        "'--shard-mb', '0.0625', '--reps', '1', '--device', 'cpu'])\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    assert proc.returncode == 0, proc.stderr
    row = json.loads(proc.stdout.strip().splitlines()[-2])
    assert row["devices"] == 1 and row["backend"] == "gloo"
    assert row["pod_ingest_all_gather"]["verified"] is True
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if m in ("jax", "tpubench")
            or m.startswith(("jax.", "jaxlib", "tpubench."))] == []


def test_ckpt_commands_never_import_jax(tmp_path):
    """``ckpt-save`` then ``ckpt-restore`` through the CLI (local files,
    the CPU) run without loading ``jax`` or ``tpubench``."""
    common = ["--protocol", "local", "--dir", str(tmp_path / "store"),
              "--ckpt-objects", "2", "--ckpt-object-bytes", "70001",
              "--ckpt-part-bytes", "32768", "--device", "cpu",
              "--results-dir", str(tmp_path / "r")]
    proc = _run(
        "import json, sys\n"
        "from tpubench_torch.cli import main\n"
        f"assert main(['ckpt-save'] + {common!r}) == 0\n"
        f"assert main(['ckpt-restore'] + {common!r}) == 0\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    assert proc.returncode == 0, proc.stderr
    assert "verified=True" in proc.stdout
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if m in ("jax", "tpubench")
            or m.startswith(("jax.", "jaxlib", "tpubench."))] == []


def test_serve_and_chaos_commands_never_import_jax(tmp_path):
    """``serve`` (single host and a 4-host elastic pod with a kill) and
    ``chaos`` over read and serve through the CLI on the CPU run without
    loading ``jax`` or ``tpubench``."""
    common = ["--protocol", "fake", "--workers", "2", "--object-size",
              "262144", "--granule-bytes", "65536", "--device", "cpu",
              "--results-dir", str(tmp_path)]
    serve = ["serve", "--serve-duration", "0.3", "--serve-rate", "100"]
    proc = _run(
        "import json, sys\n"
        "from tpubench_torch.cli import main\n"
        f"assert main({serve + common!r}) == 0\n"
        f"assert main({serve + common!r} + ['--serve-hosts', '4', "
        "'--membership-timeline', '[[0.1, 0.1, {\"kill_host\": 1}]]']) == 0\n"
        f"assert main(['chaos'] + {common!r} + ['--read-call-per-worker', "
        "'8', '--chaos-start', '0.01', '--chaos-duration', '0.05']) == 0\n"
        f"assert main(['chaos', '--chaos-workload', 'serve'] + {common!r} + "
        "['--serve-duration', '0.3', '--chaos-start', '0.1', "
        "'--chaos-duration', '0.1']) == 0\n"
        "print(json.dumps(sorted(sys.modules)))\n",
        TPUBENCH_BENCH_SLEEP_SCALE="0.5",
    )
    assert proc.returncode == 0, proc.stderr
    assert "== serve scorecard ==" in proc.stdout
    assert "== membership resize scorecard ==" in proc.stdout
    assert proc.stdout.count("== resilience scorecard") == 2
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in loaded if m in ("jax", "tpubench")
            or m.startswith(("jax.", "jaxlib", "tpubench."))] == []
