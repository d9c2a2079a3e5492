"""``pod-ingest`` of the port on 8 gloo ranks against ``tpubench``'s run on
8 simulated JAX CPU devices (``tests/test_dist.py``'s scenarios).

The reference's single process drives 8 devices; the port runs 8 ranks,
one shard each, and only rank 0 writes the report. Compared exactly:
the gathered bytes, the pod checksum of every collective call,
``shard_bytes``, ``ici_bytes_moved``, ``verified``,
``errors``, the holes (the union of the ranks' own against the
reference's) and ``holes_global``, and the flight records (the reference
has one record per shard plus its pod record; each rank has its shard's
and its own pod record). One 8-rank group is spawned for the module
(``test_torch_dist.run_ranks``).
"""

from __future__ import annotations

import io
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_dist import run_ranks
from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.dist.reassemble import gathered_to_bytes
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.workloads import pod_ingest

WORLD = 8
SIZE = 100_000  # uneven: padding and trim
HOLES_SIZE = 160_000
PREFIX = BenchConfig().workload.object_name_prefix
# The shard whose fetch fails in the failure-domain case, drawn from a seed.
FAILED_SHARD = int(np.random.default_rng(107).integers(1, WORLD))


class FailOneShard:
    """Backend wrapper: the shard whose range starts at ``fail_start``
    always fails to open — one deterministic failure domain."""

    def __init__(self, backend, fail_start, error):
        self._b, self._fail_start, self._error = backend, fail_start, error

    def open_read(self, name, start=0, length=None):
        if start == self._fail_start:
            raise self._error("injected host failure", transient=False)
        return self._b.open_read(name, start=start, length=length)

    def __getattr__(self, attr):
        return getattr(self._b, attr)


class AlwaysFail(FailOneShard):
    def open_read(self, name, start=0, length=None):
        raise self._error("boom", transient=False)


def _flight(summary: dict) -> dict:
    return {"records": summary["records"], "errors": summary["errors"],
            "phases": sorted(summary["phases"])}


def _checksums(mod, names=("make_reassemble", "make_ring_reassemble")):
    """Wrap ``mod``'s collective factories so every call's checksum is
    kept; returns the list they append to and a restore function."""
    seen, saved = [], {n: getattr(mod, n) for n in names}

    def watched(make):
        def build(*a, **k):
            fn = make(*a, **k)

            def call(staged):
                gathered, csum = fn(staged)
                seen.append(int(csum))
                return gathered, csum

            return call

        return build

    for n, make in saved.items():
        setattr(mod, n, watched(make))
    return seen, lambda: [setattr(mod, n, f) for n, f in saved.items()]


def _run(cfg, backend, ring=False) -> dict:
    seen, restore = _checksums(pod_ingest)
    try:
        wl = pod_ingest.PodIngestWorkload(
            cfg, backend, pod_ingest.make_mesh(device="cpu"), ring=ring)
        res = wl.run().to_dict()
    finally:
        restore()
    res["gathered"] = gathered_to_bytes(wl.gathered, res["extra"]["object_size"])
    res["checksums"] = seen
    return res


def _scenarios(rank: int, world: int, tmp: str) -> dict:
    out = {}
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    for ring in (False, True):
        store = FakeBackend.prepopulated(PREFIX, 1, SIZE)
        out["ring" if ring else "all_gather"] = _run(cfg, store, ring)
    cfg.workload.abort_on_error = False
    table = ShardTable.build(HOLES_SIZE, world, align=128)
    store = FakeBackend.prepopulated(PREFIX, 1, HOLES_SIZE)
    out["holes"] = _run(cfg, FailOneShard(
        store, table.shard(FAILED_SHARD).start, StorageError))
    cfg.workload.abort_on_error = True
    try:
        _run(cfg, AlwaysFail(store, 0, StorageError))
        out["abort"] = None
    except Exception as e:  # noqa: BLE001 — the test checks what was raised
        out["abort"] = type(e).__name__
    # ``cli.execute``: the same command on every process.
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "pod-ingest", "--protocol", "fake", "--workers", "1",
            "--object-size", str(SIZE), "--device", "cpu",
            "--results-dir", tmp, "--num-processes", str(world),
            "--process-id", str(rank), "--coordinator", "127.0.0.1:1",
        ])
    out["cli"] = (rc, buf.getvalue().strip().splitlines()[-1])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod")
    return run_ranks(_scenarios, WORLD, str(tmp)), tmp


def _reference(monkeypatch, ring=False, size=SIZE, backend_wrap=None,
               abort=True):
    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.storage import FakeBackend as JaxFakeBackend
    from tpubench.workloads import pod_ingest as jax_pod

    seen = {}

    def capture(gathered, object_size):
        seen["bytes"] = real(gathered, object_size)
        return seen["bytes"]

    real = jax_pod.gathered_to_bytes
    monkeypatch.setattr(jax_pod, "gathered_to_bytes", capture)
    cfg = JaxBenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.abort_on_error = abort
    store = JaxFakeBackend.prepopulated(cfg.workload.object_name_prefix, 1, size)
    backend = backend_wrap(store) if backend_wrap else store
    checksums, restore = _checksums(jax_pod)
    try:
        res = jax_pod.run_pod_ingest(cfg, backend=backend, ring=ring).to_dict()
    finally:
        restore()
    res["gathered"] = seen.get("bytes")
    res["checksums"] = checksums
    return res


KEYS = ("shard_bytes", "ici_bytes_moved", "verified", "object_size", "mode",
        "holes_global")


@pytest.mark.parametrize("mode", ["all_gather", "ring"])
def test_pod_ingest_matches_reference_on_8_ranks(mode, ranks, jax_cpu_devices,
                                                 monkeypatch):
    ref = _reference(monkeypatch, ring=mode == "ring")
    per_rank = [r[mode] for r in ranks[0]]
    port = per_rank[0]
    assert port["gathered"] == ref["gathered"]
    assert all(r["gathered"] == ref["gathered"] for r in per_rank)
    # Warm-up and timed call: the pod's mod-2^32 sum, on every rank.
    assert all(r["checksums"] == ref["checksums"] for r in per_rank)
    assert ref["checksums"] == [int(np.frombuffer(ref["gathered"], np.uint8)
                                    .sum(dtype=np.uint64)) % (1 << 32)] * 2
    assert ref["gathered"] == FakeBackend.prepopulated(
        PREFIX, 1, SIZE)._objects[f"{PREFIX}0"].tobytes()
    for key in KEYS:
        assert port["extra"][key] == ref["extra"][key], key
    assert port["errors"] == ref["errors"] == 0
    assert port["n_chips"] == ref["n_chips"] == WORLD
    assert port["bytes_total"] == ref["bytes_total"] == SIZE
    assert set(port) == set(ref) and set(port["extra"]) == set(ref["extra"])
    # The reference: WORLD shard records + 1 pod record; each rank 1 + 1.
    pf, rf = ([_flight(r["extra"]["flight"]) for r in per_rank],
              _flight(ref["extra"]["flight"]))
    assert sum(f["records"] - 1 for f in pf) == rf["records"] - 1 == WORLD
    assert all(f["phases"] == rf["phases"] for f in pf)
    assert sum(f["errors"] for f in pf) == rf["errors"] == 0
    assert {"hbm_staged", "gather_complete"} <= set(rf["phases"])
    for stage in ("fetch_seconds", "stage_seconds", "gather_seconds",
                  "compile_seconds"):
        assert port["extra"][stage] > 0


def test_failure_domain_holes_match_reference(ranks, jax_cpu_devices,
                                              monkeypatch):
    from tpubench.storage.base import StorageError as JaxStorageError

    table = ShardTable.build(HOLES_SIZE, WORLD, align=128)
    ref = _reference(
        monkeypatch, size=HOLES_SIZE, abort=False,
        backend_wrap=lambda s: FailOneShard(
            s, table.shard(FAILED_SHARD).start, JaxStorageError),
    )
    per_rank = [r["holes"] for r in ranks[0]]
    union = sorted(i for r in per_rank for i in r["extra"]["holes"]["shards"])
    assert union == ref["extra"]["holes"]["shards"] == [FAILED_SHARD]
    assert (sum(r["extra"]["holes"]["bytes"] for r in per_rank)
            == ref["extra"]["holes"]["bytes"] == table.shard(FAILED_SHARD).length)
    assert all(r["extra"]["holes_global"] == ref["extra"]["holes_global"]
               for r in per_rank)
    assert all(r["errors"] == ref["errors"] == 1 for r in per_rank)
    assert all(r["extra"]["verified"] is ref["extra"]["verified"] is True
               for r in per_rank)
    assert per_rank[0]["gathered"] == ref["gathered"]
    assert all(r["checksums"] == ref["checksums"] for r in per_rank)
    assert per_rank[0]["bytes_total"] == ref["bytes_total"]


def test_abort_on_error_still_aborts(ranks, jax_cpu_devices):
    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.storage import FakeBackend as JaxFakeBackend
    from tpubench.storage.base import StorageError as JaxStorageError
    from tpubench.workloads.pod_ingest import run_pod_ingest as jax_run

    assert {r["abort"] for r in ranks[0]} == {"WorkerError"}
    cfg = JaxBenchConfig()
    cfg.transport.protocol = "fake"
    store = JaxFakeBackend.prepopulated(cfg.workload.object_name_prefix, 1, SIZE)
    with pytest.raises(Exception) as err:
        jax_run(cfg, backend=AlwaysFail(store, 0, JaxStorageError), verify=False)
    assert type(err.value).__name__ == "WorkerError"


def test_only_rank_0_writes_the_report(ranks):
    results, tmp = ranks
    files = list(Path(tmp).glob("pod_ingest_*.json"))
    assert len(files) == 1 and "_p" not in files[0].name
    assert results[0]["cli"] == (0, f"result: {files[0]}")
    for rank, r in enumerate(results[1:], start=1):
        assert r["cli"] == (0, f"process {rank}/{WORLD} done (report at process 0)")


@pytest.mark.parametrize("protocol, switch", [
    ("grpc", "native_receive"), ("http", "http2"),
])
def test_multiplexed_fetch_configs_run_multiplexed(protocol, switch):
    """The configurations on which ``tpubench`` fetches the shards over one
    multiplexed connection (refused until ``read_ranges`` was ported) run
    so on the CPU: one rank through ``cli.execute``, its shard fetched as
    ``MUX_RANGES_PER_RANK`` ranges in one batch on one connection — not a
    thread per shard — verified, the group torn down after."""
    from tpubench_torch.storage import base_backend, open_backend
    from tpubench_torch.storage.fake_grpc_wire_server import (
        FakeGrpcWireServer,
    )
    from tpubench_torch.storage.fake_h2_server import FakeH2Server

    batches = []
    server = FakeGrpcWireServer if protocol == "grpc" else FakeH2Server
    with server(FakeBackend.prepopulated(PREFIX, 1, SIZE)) as srv:
        cfg = BenchConfig()
        cfg.transport.protocol = protocol
        cfg.transport.endpoint = srv.endpoint
        cfg.transport.directpath = False
        setattr(cfg.transport, switch, True)
        backend = open_backend(cfg)
        inner = base_backend(backend)
        real = inner.read_ranges
        inner.read_ranges = lambda name, r, b: batches.append(r) or real(
            name, r, b)
        res = cli.execute("pod-ingest", cfg, device="cpu", backend=backend)
        pool = inner._native_pool() if protocol == "grpc" else inner._h2_pool()
        stats = dict(pool.stats)
        backend.close()
    assert res.errors == 0 and res.extra["verified"] is True
    assert res.bytes_total == SIZE
    fine = ShardTable.build(SIZE, pod_ingest.MUX_RANGES_PER_RANK, align=128)
    assert batches == [[(sh.start, sh.length) for sh in fine.shards()]]
    assert stats["connects"] == 1
    assert not torch.distributed.is_initialized()


def test_pod_ingest_runs_on_the_callers_group():
    """The workload brings no group up (``cli.execute`` does): called
    with none joined it says so and opens no request."""
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    with pytest.raises(RuntimeError, match="no process group joined"):
        pod_ingest.run_pod_ingest(cfg, device="cpu")
    assert not torch.distributed.is_initialized()


def test_one_rank_pod_ingest_through_the_cli(tmp_path):
    """A single process: the run brings up a one-rank gloo group, gathers,
    verifies, and tears the group down; the report is written untagged."""
    rc = cli.main(["pod-ingest", "--ring", "--protocol", "fake",
                   "--workers", "1", "--object-size", str(SIZE),
                   "--device", "cpu", "--results-dir", str(tmp_path)])
    assert rc == 0 and not torch.distributed.is_initialized()
    import json

    (path,) = tmp_path.glob("pod_ingest_*.json")
    res = json.loads(path.read_text())
    assert res["errors"] == 0 and res["extra"]["verified"] is True
    assert res["extra"]["ici_bytes_moved"] == 0 and res["n_chips"] == 1
    assert "topology" not in res["extra"]


def test_obs_plane_rides_pod_ingest_as_in_reference(tmp_path, jax_cpu_devices,
                                                    monkeypatch):
    """Telemetry (OTLP dry-run), the cloud dry-run export and the flight
    journal on: the port's one-rank run leaves the blocks the reference's
    run leaves, with the same dry-run points, and a journal holding the
    shard and pod records."""
    import json

    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.storage import FakeBackend as JaxFakeBackend
    from tpubench.workloads.pod_ingest import run_pod_ingest as jax_run

    def switch(cfg, name):
        cfg.transport.protocol = "fake"
        cfg.obs.export = "cloud"
        cfg.obs.flight_journal = str(tmp_path / name)
        cfg.telemetry.otlp = True
        return cfg

    jcfg = switch(JaxBenchConfig(), "jax.json")
    ref = jax_run(jcfg, backend=JaxFakeBackend.prepopulated(
        jcfg.workload.object_name_prefix, 1, SIZE)).to_dict()
    cfg = switch(BenchConfig(), "port.json")
    port = cli.execute(
        "pod-ingest", cfg, device="cpu",
        backend=FakeBackend.prepopulated(PREFIX, 1, SIZE)).to_dict()
    assert set(port["extra"]) == set(ref["extra"])
    assert {"telemetry", "metrics_export", "flight_journal"} <= set(port["extra"])

    assert port["extra"]["metrics_export"] == ref["extra"]["metrics_export"]
    assert port["extra"]["metrics_export"]["points"] == 5
    assert port["extra"]["telemetry"].keys() == ref["extra"]["telemetry"].keys()
    journal = json.loads((tmp_path / "port.json").read_text())
    kinds = sorted(r["kind"] for r in journal["records"])
    assert kinds == ["object", "read"]
    assert journal["workload"] == "pod_ingest"
