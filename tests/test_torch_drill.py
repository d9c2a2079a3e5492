"""The port's incident drill (``tpubench_torch/workloads/drill.py``,
``lifecycle/delta.py``, the typed ``drill`` config section, the ``drill``
subcommand) against ``tpubench``'s, on the CPU.

* Exact parity (tolerance 0) on seeded inputs: ``validate_drill_config``'s
  messages, the section's defaults, its ``--save-config`` round trip and
  the config fingerprint, the CLI's drill flags; ``DeltaTracker`` and
  ``delta_save`` through one sequence (dirty sets, the crc32 map of each
  generation, every pass's dispositions, one CAS conflict that falls back
  to a full save, the manifest published last).
* One drill through both packages at ``TPUBENCH_BENCH_SLEEP_SCALE=0``
  (3 hosts, a 3 × 256 KiB checkpoint, no periodic saves: their count
  follows the host's speed): the same schedule, incident plan and
  checkpoint shape in the journal's replay stamp, the same scorecard
  keys, the restore verified in both and the stored checkpoint bytes
  equal. Wall-clock numbers (SLO, latency) are not compared: the port's
  dispatcher keeps due times (ROADMAP C.8).
* A delta save landing mid-shard under the restore is counted as a torn
  read and re-read, in both packages.
* ROADMAP C.9, the stated difference: a shard of more chunks than the
  restore window restores in the port; ``tpubench``'s driver never
  finishes it.
* The port alone: the drill over the gRPC wire fake (with a time limit),
  the direct arm, the storm mix, the sweep, ``drill`` through the CLI
  (``--protocol http`` with no endpoint starts a prepopulated fake
  server), ``report`` equal to ``tpubench``'s, and no CUDA without
  ``--device cpu`` raises.
"""

from __future__ import annotations

import dataclasses
import json
import random
import zlib

import pytest

from tpubench.config import BenchConfig as JaxConfig
from tpubench.config import validate_drill_config as jax_validate
from tpubench.lifecycle import delta as jax_delta
from tpubench.lifecycle.manifest import build_manifest as jax_build_manifest
from tpubench.replay import bundle as jax_bundle
from tpubench.storage.fake import FakeBackend as JaxFake
from tpubench.workloads import drill as jax_drill
from tpubench.workloads import report_cmd as jax_report

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, validate_drill_config
from tpubench_torch.lifecycle import delta
from tpubench_torch.lifecycle.manifest import build_manifest, manifest_name
from tpubench_torch.obs.flight import load_journals
from tpubench_torch.replay import bundle
from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.workloads import drill, report_cmd

from test_torch_lifecycle import bounded

MB = 1 << 20


@pytest.fixture(autouse=True)
def _no_sleep(monkeypatch):
    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0")



def _drill_cfg(cls=BenchConfig, journal=None, **drill_kw):
    """``tests/test_drill.py``'s shape: 3 hosts, 60/s for 3 s, a
    3 × 256 KiB checkpoint in 64 KiB parts, kill at 1.0 s, join at 1.4 s,
    saves every 0.8 s."""
    cfg = cls()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = 1 * MB
    cfg.obs.export = "none"
    if journal is not None:
        cfg.obs.flight_journal = str(journal)
    sv = cfg.serve
    sv.duration_s, sv.rate_rps, sv.tenants = 3.0, 60.0, 24
    sv.workers, sv.hosts, sv.seed = 4, 3, 7
    lc = cfg.lifecycle
    lc.objects, lc.object_bytes, lc.part_bytes, lc.seed = 3, 256 * 1024, \
        64 * 1024, 7
    dc = cfg.drill
    dc.kill_at_s, dc.join_at_s, dc.save_interval_s = 1.0, 1.4, 0.8
    for k, v in drill_kw.items():
        setattr(dc, k, v)
    return cfg


# ------------------------------------------------------------ config ----


@pytest.mark.parametrize("mutate", [
    lambda c: setattr(c.drill, "restore_class", "gold"),
    lambda c: setattr(c.drill, "restore_class", ""),
    lambda c: setattr(c.serve, "hosts", 1),
    lambda c: setattr(c.drill, "join_at_s", 0.5),
    lambda c: setattr(c.drill, "victim", 3),
    lambda c: setattr(c.drill, "dirty_fraction", 0.0),
    lambda c: setattr(c.drill, "restore_inflight", 0),
    lambda c: setattr(c.drill, "sweep_points", [1.0, -2.0]),
    lambda c: setattr(c.drill, "meta_rate_rps", -1.0),
])
def test_validate_drill_config_rejects_as_reference(mutate):
    ours, theirs = _drill_cfg(), _drill_cfg(JaxConfig)
    mutate(ours)
    mutate(theirs)
    with pytest.raises(SystemExit) as a:
        validate_drill_config(ours.drill, ours.serve)
    with pytest.raises(SystemExit) as b:
        jax_validate(theirs.drill, theirs.serve)
    assert str(a.value) == str(b.value)


def test_drill_section_roundtrips_and_fingerprints_as_reference():
    ref = JaxConfig()
    ref.drill.save_interval_s = 0.5
    ref.drill.sweep_points = [1.0, 3.0]
    ref.fleet.hosts = 9
    cfg = BenchConfig.from_json(ref.to_json())
    assert cfg.drill.save_interval_s == 0.5
    assert cfg.to_json() == ref.to_json()
    assert cfg.raw == {} and cfg.fleet.hosts == 9
    assert dataclasses.asdict(BenchConfig().drill) == \
        dataclasses.asdict(JaxConfig().drill)
    assert bundle.config_fingerprint(cfg.to_dict()) == \
        jax_bundle.config_fingerprint(ref.to_dict())


def test_cli_drill_flags_fold_as_reference(tmp_path):
    import tpubench.cli as jax_cli

    argv = ["drill", "--protocol", "fake", "--serve-hosts", "3",
            "--drill-kill-at", "0.5", "--drill-join-at", "0.9",
            "--drill-victim", "1", "--restore-class", "rst",
            "--restore-priority", "2", "--restore-weight", "3",
            "--restore-deadline", "250", "--restore-inflight", "4",
            "--restore-retries", "2", "--restore-direct",
            "--save-interval", "0.7", "--full-saves",
            "--dirty-fraction", "0.5", "--drill-meta-rate", "20",
            "--drill-sweep-points", "1,2"]
    ours = cli.build_config(cli.build_parser().parse_args(argv))
    saved = tmp_path / "cfg.json"
    assert jax_cli.main(argv + ["--save-config", str(saved)]) == 0
    assert dataclasses.asdict(ours.drill) == \
        json.loads(saved.read_text())["drill"]
    with pytest.raises(SystemExit, match="hosts >= 2"):
        cli.build_config(cli.build_parser().parse_args(["drill"]))
    # Only the drill command pays the drill's checks.
    cli.build_config(cli.build_parser().parse_args(["serve"]))


# ------------------------------------------------------------- delta ----


def _delta_sequence(mod, build, fake_cls) -> dict:
    """Baseline full save, two delta passes, a clean pass, then a foreign
    write that makes the next pass's CAS lose; every observable kept."""
    backend = fake_cls()
    tracker = mod.DeltaTracker(build("ckpt/", 6, 96 * 1024 + 5))
    out = {"passes": [], "dirty": [], "gens": []}
    rng = random.Random(3)
    out["passes"].append(mod.delta_save(backend, tracker, 32 * 1024,
                                        delta=False))
    for fraction in (0.5, 0.2):
        out["dirty"].append(tracker.mutate(rng, fraction))
        out["passes"].append(mod.delta_save(backend, tracker, 32 * 1024))
    out["passes"].append(mod.delta_save(backend, tracker, 32 * 1024))
    victim = tracker.mutate(rng, 0.1)[0]
    backend.write(victim, b"foreign")
    out["dirty"].append([victim])
    out["passes"].append(mod.delta_save(backend, tracker, 32 * 1024))
    out["gens"] = dict(tracker.generation)
    out["crc"] = sorted(tracker.published_crc.items())
    out["versions"] = dict(tracker.version)
    out["stored"] = {
        n: bytes(backend._objects[n]) for n in sorted(backend._objects)
    }
    return out


def test_delta_save_matches_reference():
    ours = _delta_sequence(delta, build_manifest, FakeBackend)
    theirs = _delta_sequence(jax_delta, jax_build_manifest, JaxFake)
    assert ours == theirs
    base, d1, d2, clean, cas = ours["passes"]
    assert base["uploaded_shards"] == 6 and base["skipped_clean"] == 0
    assert d1["uploaded_shards"] == d1["dirty_shards"] == 3
    assert d1["skipped_clean"] == 3 and d2["uploaded_shards"] == 1
    assert clean["uploaded_shards"] == 0 and clean["skipped_clean"] == 6
    assert cas["cas_conflicts"] == cas["full_fallbacks"] == 1
    assert cas["errors"] == 0 and cas["uploaded_shards"] == 1
    victim = ours["dirty"][-1][0]
    data = ours["stored"][victim]
    gen = ours["gens"][victim]
    assert dict(ours["crc"])[(victim, gen)] == zlib.crc32(data) & 0xFFFFFFFF


def test_delta_manifest_published_last_and_only_when_clean():
    backend = FakeBackend()
    tracker = delta.DeltaTracker(build_manifest("ckpt/", 4, 128 * 1024))
    delta.delta_save(backend, tracker, 32 * 1024, delta=False)
    mname = manifest_name("ckpt/")
    gen0 = backend.stat(mname).generation
    victim = tracker.mutate(random.Random(3), 0.25)[0]

    class _ShardFails:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, attr):
            return getattr(self._inner, attr)

        def open_write(self, name, **kw):
            if name == victim:
                raise StorageError("disk on fire", transient=False)
            return self._inner.open_write(name, **kw)

    stats = delta.delta_save(_ShardFails(backend), tracker, 32 * 1024)
    assert stats["errors"] == 1 and backend.stat(mname).generation == gen0
    stats = delta.delta_save(backend, tracker, 32 * 1024)
    assert stats["errors"] == 0 and backend.stat(mname).generation > gen0


# ------------------------------------------------------------- drill ----


def _keys(d):
    """The key structure of a nested dict (values dropped)."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    return None


def _ckpt_bytes(store) -> dict:
    return {n: bytes(v) for n, v in sorted(store._objects.items())
            if n.startswith("ckpt/")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One drill through each package on its own store, journals on. No
    periodic saves: how many land depends on the host's speed (the saver
    rides the wall clock), and a save under the restore is a torn read,
    held by its own test."""
    import os

    d = tmp_path_factory.mktemp("drill")
    old = os.environ.get("TPUBENCH_BENCH_SLEEP_SCALE")
    os.environ["TPUBENCH_BENCH_SLEEP_SCALE"] = "0"
    try:
        port_store = FakeBackend.prepopulated("tpubench/file_", 4, MB)
        ref_store = JaxFake.prepopulated("tpubench/file_", 4, MB)
        port = drill.run_drill(
            _drill_cfg(journal=d / "port.json", save_interval_s=0.0),
            backend=port_store, device="cpu")
        ref = jax_drill.run_drill(
            _drill_cfg(JaxConfig, d / "ref.json", save_interval_s=0.0),
            backend=ref_store)
    finally:
        if old is None:
            del os.environ["TPUBENCH_BENCH_SLEEP_SCALE"]
        else:
            os.environ["TPUBENCH_BENCH_SLEEP_SCALE"] = old
    return {"port": port, "ref": ref, "dir": d,
            "stores": (port_store, ref_store)}


def test_drill_matches_reference(runs):
    port, ref = runs["port"], runs["ref"]
    assert port.workload == ref.workload == "drill"
    assert port.errors == ref.errors == 0
    pd, rd = port.extra["drill"], ref.extra["drill"]
    assert _keys(pd) == _keys(rd)
    assert set(port.extra["serve"]) == set(ref.extra["serve"])
    assert set(port.summaries) == set(ref.summaries)
    for key in ("arm", "incident", "restore_class", "baseline_save"):
        assert pd[key] == rd[key], key
    for d in (pd, rd):
        rst = d["restore"]
        assert rst["verified"] and rst["shards_restored"] == 3
        assert rst["errors"] == 0 and rst["bytes"] == 3 * 256 * 1024
        assert d["amplification"]["checkpoint_bytes"] == 3 * 256 * 1024
        assert d["saves"]["passes"] == 0
    arrivals = {c: v["arrivals"] for c, v in
                port.extra["serve"]["classes"].items() if c != "restore"}
    assert arrivals == {c: v["arrivals"] for c, v in
                        ref.extra["serve"]["classes"].items()
                        if c != "restore"}
    assert port.extra["membership"]["pool_leaked_slabs"] == 0
    assert all(h["pool"]["native"] is False
               for h in port.extra["membership"]["per_host"])


def test_drill_stamps_the_same_scenario_and_plan(runs):
    """The journals' replay stamps: one schedule, one population, one
    incident plan and checkpoint shape (the baselines are wall-clock)."""
    (p,) = load_journals([str(runs["dir"] / "port.json")])
    (r,) = load_journals([str(runs["dir"] / "ref.json")])
    ps, rs = p["replay"], r["replay"]
    assert ps["workload"] == rs["workload"] == "drill"
    assert ps["fingerprint"] == rs["fingerprint"]
    strip = lambda s: {k: v for k, v in s["scenario"].items()  # noqa: E731
                       if k != "drill"}
    assert strip(ps) == strip(rs)
    for part in ("plan", "checkpoint"):
        assert ps["scenario"]["drill"][part] == rs["scenario"]["drill"][part]
    assert ps["scenario"]["drill"]["plan"]["victim"] == 2


def test_drill_restores_the_same_checkpoint_bytes(runs):
    port_store, ref_store = runs["stores"]
    ours, theirs = _ckpt_bytes(port_store), _ckpt_bytes(ref_store)
    assert ours == theirs and len(ours) == 4  # 3 shards + the manifest


class _TornOnce:
    """A store wrapper whose first read of a checkpoint shard past its
    first chunk lands one delta save of that shard first: the read then
    sees a new generation under its stat-pinned plan."""

    def __init__(self, inner, mod, trackers, part):
        self._inner, self._mod = inner, mod
        self._trackers, self._part = trackers, part
        self.fired = None

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def open_read(self, name, start=0, length=None):
        if (self.fired is None and name.startswith("ckpt/")
                and not name.endswith("MANIFEST.json") and start > 0):
            self.fired = name
            tracker = self._trackers[-1]
            with tracker._lock:
                tracker.version[name] += 1
                tracker.dirty.add(name)
            self._mod.delta_save(self._inner, tracker, self._part)
        return self._inner.open_read(name, start=start, length=length)


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_save_landing_mid_shard_is_a_torn_read(pkg, monkeypatch):
    mod = delta if pkg == "port" else jax_delta
    trackers = []

    class Tracker(mod.DeltaTracker):
        def __init__(self, manifest):
            super().__init__(manifest)
            trackers.append(self)

    monkeypatch.setattr(mod, "DeltaTracker", Tracker)
    cls, fake = (BenchConfig, FakeBackend) if pkg == "port" else \
        (JaxConfig, JaxFake)
    cfg = _drill_cfg(cls, save_interval_s=0.0)
    cfg.serve.chunk_bytes = 64 * 1024  # 4 chunks a shard
    store = _TornOnce(fake.prepopulated("tpubench/file_", 4, MB), mod,
                      trackers, cfg.lifecycle.part_bytes)
    if pkg == "port":
        res = drill.run_drill(cfg, backend=store, device="cpu")
    else:
        res = jax_drill.run_drill(cfg, backend=store)
    rst = res.extra["drill"]["restore"]
    assert store.fired is not None
    assert rst["torn_rereads"] == 1
    assert rst["verified"] and rst["errors"] == 0
    assert rst["shards_restored"] == 3


def test_shard_wider_than_the_restore_window_restores():
    """ROADMAP C.9: a shard of 16 chunks through a window of 2. The port
    drains the window's oldest chunk to free a slot; ``tpubench``'s
    driver waits on the window's semaphore, which only a drain releases,
    so its restore never finishes (its run ends at the grace bound)."""
    results = {}
    for pkg, cls, fake, run, kw in (
        ("port", BenchConfig, FakeBackend, drill.run_drill,
         {"device": "cpu"}),
        ("ref", JaxConfig, JaxFake, jax_drill.run_drill, {}),
    ):
        cfg = _drill_cfg(cls, restore_inflight=2, save_interval_s=0.0)
        cfg.serve.duration_s = 2.0
        cfg.serve.chunk_bytes = 16 * 1024  # 16 chunks a shard
        store = fake.prepopulated("tpubench/file_", 4, MB)
        results[pkg] = bounded(lambda: run(cfg, backend=store, **kw),
                                60.0).extra["drill"]["restore"]
    port, ref = results["port"], results["ref"]
    assert port["verified"] and port["shards_restored"] == 3
    assert port["chunks"] == 3 * 16 and port["errors"] == 0
    assert not ref["completed"] and ref["shards_restored"] == 0
    assert ref["chunks"] == 0


def test_drill_over_grpc_wire_target(tmp_path):
    from tpubench_torch.workloads.chaos import hermetic_target

    cfg = _drill_cfg(journal=tmp_path / "g.json")
    cfg.transport.protocol = "grpc"

    def run():
        with hermetic_target(cfg, populated=True):
            return drill.run_drill(cfg, device="cpu")

    res = bounded(run, 60.0)
    dr = res.extra["drill"]
    assert res.errors == 0 and dr["saves"]["errors"] == 0
    assert dr["restore"]["verified"] and dr["restore"]["errors"] == 0


def test_drill_direct_arm_and_storm_mix():
    res = drill.run_drill(_drill_cfg(restore_via_coop=False,
                                     meta_rate_rps=100.0), device="cpu")
    dr = res.extra["drill"]
    assert not dr["restore"]["via_coop"] and dr["restore"]["verified"]
    assert dr["meta"]["completed"] > 0 and dr["meta"]["errors"] == 0


def test_drill_sweep_emits_points_and_knee():
    cfg = _drill_cfg(sweep_points=[0.5, 1.0])
    cfg.serve.duration_s = 2.0
    res = drill.run_drill_sweep(cfg, device="cpu")
    ds = res.extra["drill_sweep"]
    offered = [p["offered_rps"] for p in ds["points"]]
    assert len(offered) == 2 and offered == sorted(offered)
    assert all(p["save_passes"] >= 1 for p in ds["points"])
    assert "knee" in ds
    assert drill.format_drill_sweep(ds) == jax_drill.format_drill_sweep(ds)


def test_drill_cli_over_http_and_report_match_reference(tmp_path, capsys):
    """``drill --protocol http`` with no endpoint runs against the
    prepopulated HTTP/1.1 fake; the printed scorecard and ``report`` are
    ``tpubench``'s text."""
    argv = ["drill", "--protocol", "http", "--workers", "4",
            "--object-size", str(MB), "--serve-duration", "2",
            "--serve-rate", "40", "--serve-tenants", "12",
            "--serve-workers", "3", "--serve-hosts", "3",
            "--ckpt-objects", "2", "--ckpt-object-bytes", "131072",
            "--ckpt-part-bytes", "65536", "--drill-kill-at", "0.5",
            "--drill-join-at", "0.8", "--device", "cpu",
            "--results-dir", str(tmp_path)]
    assert bounded(lambda: cli.main(argv), 60.0) == 0
    out = capsys.readouterr().out
    (path,) = tmp_path.glob("drill_*.json")
    doc = json.loads(path.read_text())
    d = doc["extra"]["drill"]
    assert d["restore"]["verified"] and doc["errors"] == 0
    assert jax_drill.format_drill_scorecard(d) in out
    text = report_cmd.run_report([str(path)])
    assert text == jax_report.run_report([str(path)])
    assert "incident drill scorecard" in text


def test_drill_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drill.run_drill(_drill_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drill.run_drill_sweep(_drill_cfg())
