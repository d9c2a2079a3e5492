"""The port's metadata storm (``tpubench_torch/lifecycle/storm.py``,
``workloads/meta_storm.py``, the ``meta-storm`` subcommand) against
``tpubench``'s, on the CPU.

* ``build_storm_schedule``: identical ops (time, kind, target) for every
  arrival kind and two mixes (tolerance 0: floats compared with ``==``).
* ``run_meta_storm`` over the in-process store, local files and the
  HTTP/1.1 fake: equal per-kind completed counts, items listed and bytes,
  zero errors, at ``TPUBENCH_BENCH_SLEEP_SCALE=0``; ``--meta-sweep`` gives
  the same points' counts and a knee entry.
* Over the gRPC wire fake with a page smaller than the population the
  port lists every object and ``tpubench`` one page (ROADMAP C.7, the
  stated difference); each run has a time limit of its own.
* The storm dispatcher sleeps to each op's due time (ROADMAP C.8): with
  every sleep 1 ms late the schedule is still offered on time.
* The CLI's lifecycle flags fold as ``tpubench``'s; ``meta-storm`` without
  CUDA and without ``--device cpu`` raises; ``report`` renders the result
  as ``tpubench``'s does.

Small shapes: 24 objects of 2 KiB, under 100 ops a run.
"""

from __future__ import annotations

import dataclasses
import json
import time

import pytest

from tpubench.config import BenchConfig as JaxConfig
from tpubench.lifecycle import storm as jax_storm
from tpubench.workloads import meta_storm as jax_meta
from tpubench.workloads import report_cmd as jax_report

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.lifecycle import storm
from tpubench_torch.metrics.report import write_result
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.workloads import meta_storm, report_cmd

from test_torch_lifecycle import bounded

NAMES = [f"q/meta/{i:05d}" for i in range(24)]


@pytest.fixture(autouse=True)
def _no_sleep(monkeypatch):
    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0")



@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
@pytest.mark.parametrize("mix", ["list:1,stat:2,open:2", "stat:3,open:1"])
def test_storm_schedule_matches_reference(kind, mix):
    kw = dict(kind=kind, rate_rps=300.0, duration_s=1.0, mix=mix,
              prefix="q/meta/", seed=9, burst_factor=4.0,
              burst_fraction=0.25, burst_cycle_s=0.5, diurnal_period_s=2.0)
    ours = storm.build_storm_schedule(NAMES, **kw)
    theirs = jax_storm.build_storm_schedule(NAMES, **kw)
    assert len(ours) > 100
    assert [(o.t, o.kind, o.obj) for o in ours] == \
        [(o.t, o.kind, o.obj) for o in theirs]
    assert {o.kind for o in ours} == {k.split(":")[0] for k in mix.split(",")}
    assert all(o.obj == "q/meta/" for o in ours if o.kind == "list")


def _cfg(cls, protocol="fake", **lc):
    cfg = cls()
    cfg.transport.protocol = protocol
    cfg.obs.export = "none"
    # The fake store is prepopulated with the read workload's objects,
    # which no storm reads: keep them tiny.
    cfg.workload.workers = 1
    cfg.workload.object_size = 4096
    life = cfg.lifecycle
    life.meta_objects = 24
    life.meta_object_bytes = 2048
    life.meta_rate_rps = 80.0
    life.meta_duration_s = 0.5
    life.meta_page_size = 5
    life.meta_read_bytes = 1024
    life.meta_workers = 3
    life.seed = 4
    for k, v in lc.items():
        setattr(life, k, v)
    return cfg


def _counts(res) -> dict:
    lc = res.extra["lifecycle"]
    return {k: lc[k] for k in ("ops", "completed", "errors",
                               "by_kind_completed", "by_kind_errors",
                               "bytes", "list_items")}


def _both(protocol, tmp_path, sweep=False, **lc):
    """One storm through each package against its own target; returns the
    two results."""
    out = []
    for name, cls, run, kw in (
        ("port", BenchConfig, meta_storm.run_meta_storm, {"device": "cpu"}),
        ("ref", JaxConfig, jax_meta.run_meta_storm, {}),
    ):
        cfg = _cfg(cls, protocol, **lc)
        server = None
        if protocol == "local":
            cfg.workload.dir = str(tmp_path / name)
        elif protocol == "http":
            if name == "port":
                from tpubench_torch.storage.fake_server import FakeGcsServer
                server = FakeGcsServer(FakeBackend()).start()
            else:
                from tpubench.storage.fake import FakeBackend as JaxFake
                from tpubench.storage.fake_server import FakeGcsServer
                server = FakeGcsServer(JaxFake()).start()
            cfg.transport.endpoint = server.endpoint
        try:
            out.append(bounded(lambda: run(cfg, sweep=sweep, **kw)))
        finally:
            if server is not None:
                server.stop()
    return out


@pytest.mark.parametrize("protocol", ["fake", "local", "http"])
def test_meta_storm_matches_reference(protocol, tmp_path):
    port, ref = _both(protocol, tmp_path)
    assert _counts(port) == _counts(ref)
    lc = port.extra["lifecycle"]
    assert lc["errors"] == 0 and lc["completed"] == lc["ops"] > 20
    lists = lc["by_kind_completed"].get("list", 0)
    assert lists > 0 and lc["list_items"] == 24 * lists
    assert set(lc) == set(ref.extra["lifecycle"])
    assert set(lc["by_kind"]) == set(ref.extra["lifecycle"]["by_kind"])
    assert port.workload == ref.workload == "meta_storm"


def test_meta_sweep_matches_reference(tmp_path):
    port, ref = _both("fake", tmp_path, sweep=True,
                      sweep_points=[0.5, 1.0, 2.0])
    ours = port.extra["lifecycle"]["sweep"]
    theirs = ref.extra["lifecycle"]["sweep"]
    keys = ("multiplier", "completed", "errors")
    assert [{k: p[k] for k in keys} for p in ours["points"]] == \
        [{k: p[k] for k in keys} for p in theirs["points"]]
    assert "knee" in ours and len(ours["points"]) == 3


def test_meta_storm_sweep_flag_runs_the_points():
    cfg = _cfg(BenchConfig, sweep_points=[1.0, 2.0])
    res = meta_storm.run_meta_storm(cfg, sweep=True, device="cpu")
    sw = res.extra["lifecycle"]["sweep"]
    assert [p["multiplier"] for p in sw["points"]] == [1.0, 2.0]
    assert sw["points"][1]["completed"] > sw["points"][0]["completed"]


def test_grpc_paged_lists_return_the_whole_population(monkeypatch):
    """ROADMAP C.7 on the storm's user: a page of 5 under 24 objects. The
    port's lists carry all 24 names, in wire mode (pinned, as where grpcio
    does not import) and in library mode (the port's own choice);
    ``tpubench``'s wire client returns the first page (5). Every other
    count is equal."""
    import tpubench.storage.gcs_grpc as jax_gcs_grpc
    from tpubench.storage.fake import FakeBackend as JaxFake
    from tpubench.storage.fake_grpc_wire_server import (
        FakeGrpcWireServer as JaxWireServer,
    )

    from tpubench_torch.storage.fake_grpc_wire_server import (
        FakeGrpcWireServer,
    )

    from tpubench_torch.storage import gcs_grpc

    # tpubench's wire fake serves grpcio only its first call of a method
    # (ROADMAP C.11): the reference is held to wire mode; the port runs
    # both modes over its repaired wire fake.
    monkeypatch.setattr(jax_gcs_grpc, "_HAVE_LIB", False)
    modes = []
    init = gcs_grpc.GcsGrpcBackend.__init__

    def noting(backend, *a, **k):
        init(backend, *a, **k)
        modes.append(backend._lib)

    monkeypatch.setattr(gcs_grpc.GcsGrpcBackend, "__init__", noting)
    for have_lib in (False, None):
        monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", have_lib)
        modes.clear()
        results = []
        for cls, run, kw, server_cls, store in (
            (BenchConfig, meta_storm.run_meta_storm, {"device": "cpu"},
             FakeGrpcWireServer, FakeBackend()),
            (JaxConfig, jax_meta.run_meta_storm, {}, JaxWireServer,
             JaxFake()),
        ):
            server = server_cls(store).start()
            cfg = _cfg(cls, "grpc", meta_mix="list:1,stat:1",
                       meta_duration_s=0.3)
            cfg.transport.endpoint = server.endpoint
            try:
                results.append(bounded(lambda: run(cfg, **kw)))
            finally:
                server.stop()
        assert modes and set(modes) == {have_lib is None}
        port, ref = (r.extra["lifecycle"] for r in results)
        lists = port["by_kind_completed"]["list"]
        assert lists == ref["by_kind_completed"]["list"] > 0
        assert port["list_items"] == 24 * lists
        assert ref["list_items"] == 5 * lists
        assert port["errors"] == ref["errors"] == 0
        assert port["by_kind_completed"] == ref["by_kind_completed"]


def test_storm_ledger_is_shared_across_runs():
    backend = FakeBackend.prepopulated(prefix="q/meta/", count=8, size=4096)
    names = [o.name for o in backend.list("q/meta/")]
    schedule = storm.build_storm_schedule(
        names, kind="poisson", rate_rps=400.0, duration_s=0.05,
        mix="list:2,stat:5,open:3", prefix="q/meta/", seed=5)
    shared = storm.StormLedger()
    a = storm.run_storm(backend, schedule, workers=2, page_size=4,
                        read_bytes=1024, ledger=shared)
    b = storm.run_storm(backend, schedule, workers=2, page_size=4,
                        read_bytes=1024, ledger=shared)
    assert a["completed"] > 0 and b["completed"] == 2 * a["completed"]
    assert sum(shared.snapshot()["completed"].values()) == b["completed"]


def test_storm_keeps_its_schedule_when_sleeps_overshoot(monkeypatch):
    """ROADMAP C.8 on the storm's dispatcher: every sleep 1 ms late, 200
    ops 0.5 ms apart (scale 1) still take ~0.1 s, where sleeping each gap
    from the last push (``tpubench``) would take over 0.3 s."""
    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "1")
    backend = FakeBackend.prepopulated(prefix="q/meta/", count=4, size=64)
    ops = [storm.MetaOp(t=0.0005 * (i + 1), kind="stat",
                        obj=f"q/meta/{i % 4}") for i in range(200)]
    real = time.sleep
    t0 = time.perf_counter()
    out = storm.run_storm(backend, ops, workers=2,
                          sleep=lambda d: real(d + 0.001))
    took = time.perf_counter() - t0
    assert out["completed"] == 200 and out["errors"] == 0
    assert took < 0.3 and out["offered_rps"] > 700


def test_cli_lifecycle_flags_fold_as_reference(tmp_path):
    import tpubench.cli as jax_cli

    argv = ["meta-storm", "--protocol", "fake", "--meta-objects", "12",
            "--meta-object-bytes", "512", "--meta-rate", "75",
            "--meta-duration", "0.5", "--meta-arrival", "bursty",
            "--meta-mix", "list:2,open:1", "--meta-page-size", "3",
            "--meta-workers", "2", "--meta-sweep-points", "0.5,2",
            "--lifecycle-seed", "8", "--ckpt-objects", "5"]
    ours = cli.build_config(cli.build_parser().parse_args(argv))
    saved = tmp_path / "cfg.json"
    assert jax_cli.main(argv + ["--save-config", str(saved)]) == 0
    assert dataclasses.asdict(ours.lifecycle) == \
        json.loads(saved.read_text())["lifecycle"]
    with pytest.raises(SystemExit, match="comma list"):
        cli.build_config(cli.build_parser().parse_args(
            ["meta-storm", "--meta-sweep-points", "a,b"]))


def test_cli_meta_storm_and_report_match_reference(tmp_path, capsys):
    argv = ["meta-storm", "--protocol", "fake", "--workers", "1",
            "--object-size", "4096", "--meta-objects", "16",
            "--meta-object-bytes", "1024", "--meta-rate", "60",
            "--meta-duration", "0.5", "--meta-workers", "2",
            "--device", "cpu", "--results-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "lifecycle [meta_storm]" in out
    (path,) = tmp_path.glob("*.json")
    doc = json.loads(path.read_text())
    assert doc["workload"] == "meta_storm"
    assert doc["extra"]["lifecycle"]["errors"] == 0
    text = report_cmd.run_report([str(path)])
    assert text == jax_report.run_report([str(path)])
    assert "lifecycle:meta_storm" in text


def test_meta_storm_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        meta_storm.run_meta_storm(_cfg(BenchConfig))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["meta-storm", "--protocol", "fake", "--meta-duration",
                  "0.1"])


def test_storm_result_writes_and_stamps_flight(tmp_path):
    cfg = _cfg(BenchConfig)
    cfg.obs.flight_journal = str(tmp_path / "storm.json")
    res = meta_storm.run_meta_storm(cfg, device="cpu")
    assert res.extra["flight"]["records"] >= res.extra["lifecycle"]["ops"]
    assert json.loads(open(write_result(res, str(tmp_path))).read())[
        "extra"]["lifecycle"]["op"] == "meta_storm"
