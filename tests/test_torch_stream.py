"""``stream`` of the port (``tpubench_torch.workloads.pod_ingest_stream``)
against ``tpubench``'s: every case of ``tests/test_pod_ingest_stream.py``,
a parity run of one config and store through both packages, a
``tpubench`` snapshot resumed by the port (and the other way round), and
the divergent per-rank snapshots of ``tests/test_multihost.py``.

Where the shard layout matters (holes, the resume point they freeze) the
port runs on 8 gloo ranks against ``tpubench``'s 8 simulated JAX CPU
devices, in one group spawned for the module
(``test_torch_dist.run_ranks``); the other cases run one rank in this
process. Compared exactly: bytes, per-object checksums, hole lists and
byte counts, resume accounting (tolerance 0: integers).

The JAX package is imported inside the tests: the ranks import this
module, and need only torch.
"""

from __future__ import annotations

import io
import json
import os
import threading
import weakref
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from test_torch_dist import run_ranks
from tpubench_torch import cli, convert
from tpubench_torch.config import BenchConfig, DistConfig
from tpubench_torch.dist import bringup
from tpubench_torch.dist.reassemble import make_mesh
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.storage.base import StorageError, deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.workloads import pod_ingest_stream
from tpubench_torch.workloads.pod_ingest_stream import run_pod_ingest_stream

WORLD = 8
SIZE = 120_000
PREFIX = BenchConfig().workload.object_name_prefix
MOD = 1 << 32
# Objects of three sizes: the buffer sets (0, 1, 0, 1, ...) pair a small
# object with a set last used by a larger one.
SIZES = (90_000, 40_000, 17_000)
# The shards whose fetch fails once, drawn from a seed.
_rng = np.random.default_rng(109)
HOLE_SHARD, BLOCK_SHARD = (int(x) for x in _rng.integers(1, WORLD, 2))


def _cfg(size=SIZE, workers=2, cls=BenchConfig):
    cfg = cls()
    cfg.workload.object_size = size
    cfg.workload.workers = workers
    cfg.transport.protocol = "fake"
    return cfg


def _sized_store(cls):
    """Objects ``PREFIX0..2`` of ``SIZES`` in either package's store."""
    return cls.from_population(
        [(f"{PREFIX}{i}", s, 1) for i, s in enumerate(SIZES)])


class FailOnce:
    """Backend wrapper: the first open of ``name`` at ``start`` fails."""

    def __init__(self, backend, name, start, error):
        self._b, self._name, self._start, self._error = (
            backend, name, start, error)
        self.fired = False

    def open_read(self, name, start=0, length=None):
        if name == self._name and start == self._start and not self.fired:
            self.fired = True
            raise self._error("injected", transient=False)
        return self._b.open_read(name, start=start, length=length)

    def __getattr__(self, attr):
        return getattr(self._b, attr)


def _true_sum(name: str, size: int) -> int:
    return int(deterministic_bytes(name, size).sum(dtype=np.uint64)) % MOD


def _one_rank(cfg, backend, n, **kw):
    """The port's stream at one rank, in a one-rank gloo group."""
    with bringup.session(DistConfig(), "cpu", one_rank_group=True):
        return run_pod_ingest_stream(cfg, n, backend=backend, device="cpu",
                                     **kw)


# ----------------------------------------------------------- the ranks ----
def _rank_snapshot(path: str, rank: int) -> dict:
    with open(path if rank == 0 else f"{path}.p{rank}") as f:
        return json.load(f)


def _scenarios(rank: int, world: int, tmp: str) -> dict:
    out = {}
    run = run_pod_ingest_stream
    out["parity"] = run(_cfg(workers=3), 6, backend=_sized_store(FakeBackend),
                        verify=True, device="cpu").to_dict()

    cfg = _cfg()
    cfg.workload.abort_on_error = False
    store = FakeBackend.prepopulated(PREFIX, 2, SIZE)
    table = ShardTable.build(SIZE, world, align=128)
    out["holes"] = run(cfg, 4, backend=FailOnce(
        store, f"{PREFIX}0", table.shard(HOLE_SHARD).start, StorageError),
        verify=True, device="cpu").to_dict()

    snap = f"{tmp}/blocked.json"
    first = run(cfg, 3, backend=FailOnce(
        store, f"{PREFIX}1", table.shard(BLOCK_SHARD).start, StorageError),
        snapshot_path=snap, device="cpu")
    first_snap = _rank_snapshot(snap, rank)
    resumed = run(cfg, 3, backend=store, snapshot_path=snap,
                  resume_from=snap, device="cpu")
    out["blocked"] = {"first": first.to_dict(), "first_snap": first_snap,
                      "resumed": resumed.to_dict(),
                      "resumed_snap": _rank_snapshot(snap, rank)}

    # Ranks 0 and 1 as a pod of their own, each with its own snapshot.
    pod2 = make_mesh([0, 1], device="cpu")  # every rank takes part
    if pod2 is not None:
        out["divergent"] = run(
            _cfg(size=100_000, workers=3), 3,
            backend=FakeBackend.prepopulated(PREFIX, 3, 100_000),
            resume_from=f"{tmp}/div.json", device="cpu", pod=pod2,
        ).to_dict()

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "stream", "--protocol", "fake", "--workers", "1",
            "--object-size", str(SIZE), "--objects", "2", "--validate",
            "--device", "cpu", "--results-dir", tmp,
            "--num-processes", str(world), "--process-id", str(rank),
            "--coordinator", "127.0.0.1:1",
        ])
    out["cli"] = (rc, buf.getvalue().strip().splitlines()[-1])
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    # tests/test_multihost.py:169's checkpoints: rank 0 claims 2 complete
    # objects, rank 1 only 1.
    (tmp / "div.json").write_text(json.dumps(
        {"objects_done": 2, "resume_point": 2, "bytes": 200_000}))
    (tmp / "div.json.p1").write_text(json.dumps(
        {"objects_done": 1, "resume_point": 1, "bytes": 100_000}))
    return run_ranks(_scenarios, WORLD, str(tmp), timeout=120.0), tmp


def _reference(n, backend, **kw):
    from tpubench.workloads.pod_ingest_stream import run_pod_ingest_stream as ref

    return ref(kw.pop("cfg"), n_objects=n, backend=backend, **kw).to_dict()


def _jax():
    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.storage import FakeBackend as JaxFakeBackend
    from tpubench.storage.base import StorageError as JaxStorageError

    return JaxBenchConfig, JaxFakeBackend, JaxStorageError


# ----------------------------------------------------- 8 ranks vs 8 chips --
def test_stream_parity_on_8_ranks(ranks, jax_cpu_devices):
    """One config and store through both packages: the same bytes, the
    same per-object device checksums (each the true sum of the object's
    bytes, so no stale padding), the same result keys."""
    jcfg_cls, jstore_cls, _ = _jax()
    ref = _reference(6, _sized_store(jstore_cls), cfg=_cfg(workers=3, cls=jcfg_cls),
                     verify=True)
    want = [_true_sum(f"{PREFIX}{k % 3}", SIZES[k % 3]) for k in range(6)]
    assert ref["extra"]["object_checksums"] == want
    for r in (r["parity"] for r in ranks[0]):
        assert r["bytes_total"] == ref["bytes_total"] == sum(SIZES) * 2
        assert r["errors"] == ref["errors"] == 0
        assert r["n_chips"] == ref["n_chips"] == WORLD
        for key in ("object_checksums", "objects", "objects_this_run",
                    "verified", "holes_by_object"):
            assert r["extra"][key] == ref["extra"][key], key
        assert set(r["extra"]) == set(ref["extra"])


def test_stream_failure_domain_holes(ranks, jax_cpu_devices):
    """A failing shard of object 0 becomes a zeroed, reported hole; later
    objects reusing its buffer set are intact. The ranks' shard lists
    together are the reference's, each rank has the pod-wide totals, and
    the checksums and delivered bytes agree."""
    jcfg_cls, jstore_cls, jerr = _jax()
    jcfg = _cfg(cls=jcfg_cls)
    jcfg.workload.abort_on_error = False
    table = ShardTable.build(SIZE, WORLD, align=128)
    ref = _reference(4, FailOnce(jstore_cls.prepopulated(PREFIX, 2, SIZE),
                                 f"{PREFIX}0", table.shard(HOLE_SHARD).start,
                                 jerr), cfg=jcfg, verify=True)
    per_rank = [r["holes"] for r in ranks[0]]
    rh = ref["extra"]["holes_by_object"]
    assert list(rh) == ["0"] and rh["0"]["shards"] == [HOLE_SHARD]
    assert all(list(r["extra"]["holes_by_object"]) == ["0"] for r in per_rank)
    ours = [r["extra"]["holes_by_object"]["0"] for r in per_rank]
    assert sorted(i for h in ours for i in h["shards"]) == rh["0"]["shards"]
    assert sum(h["bytes"] for h in ours) == rh["0"]["bytes"]
    assert all(h["global"] == rh["0"]["global"] == {
        "shards": 1, "bytes": table.shard(HOLE_SHARD).length} for h in ours)
    for r in per_rank:
        assert r["errors"] == ref["errors"] == 1
        assert r["bytes_total"] == ref["bytes_total"] == (
            4 * SIZE - table.shard(HOLE_SHARD).length)
        assert r["extra"]["object_checksums"] == ref["extra"]["object_checksums"]
    sums = ref["extra"]["object_checksums"]
    for k in (1, 2, 3):
        assert sums[k] == _true_sum(f"{PREFIX}{k % 2}", SIZE)
    sh = table.shard(HOLE_SHARD)
    data0 = deterministic_bytes(f"{PREFIX}0", SIZE)
    assert sums[0] == (_true_sum(f"{PREFIX}0", SIZE) - int(
        data0[sh.start:sh.start + sh.length].sum(dtype=np.uint64))) % MOD


def test_stream_resume_point_blocked_by_holes(ranks, jax_cpu_devices, tmp_path):
    """An object delivered with holes stays fetchable again: every rank's
    snapshot freezes its resume point at the degraded object while
    objects_done counts on, and the resume fetches it cleanly — as in
    the reference."""
    jcfg_cls, jstore_cls, jerr = _jax()
    jcfg = _cfg(cls=jcfg_cls)
    jcfg.workload.abort_on_error = False
    table = ShardTable.build(SIZE, WORLD, align=128)
    inner = jstore_cls.prepopulated(PREFIX, 2, SIZE)
    path = str(tmp_path / "snap.json")
    first = _reference(3, FailOnce(inner, f"{PREFIX}1",
                                   table.shard(BLOCK_SHARD).start, jerr),
                       cfg=jcfg, snapshot_path=path)
    with open(path) as f:
        ref_snap = json.load(f)
    resumed = _reference(3, inner, cfg=jcfg, snapshot_path=path,
                         resume_from=path)
    with open(path) as f:
        ref_snap2 = json.load(f)
    assert (first["errors"], ref_snap["objects_done"],
            ref_snap["resume_point"]) == (1, 3, 1)
    for r in (r["blocked"] for r in ranks[0]):
        assert r["first"]["errors"] == first["errors"]
        for key in ("objects_done", "resume_point", "bytes"):
            assert r["first_snap"][key] == ref_snap[key], key
            assert r["resumed_snap"][key] == ref_snap2[key], key
        assert r["resumed"]["errors"] == resumed["errors"] == 0
        assert (r["resumed"]["extra"]["resume"]["objects_skipped"]
                == resumed["extra"]["resume"]["objects_skipped"] == 1)
        assert r["resumed"]["bytes_total"] == resumed["bytes_total"] == 2 * SIZE


def test_divergent_rank_snapshots_agree_on_the_minimum(ranks):
    """Two ranks, each resuming from its own file (rank 1's is
    ``<path>.p1``), whose checkpoints disagree: both resume at the
    smaller point, so both run the same objects and collectives."""
    div = [r["divergent"] for r in ranks[0][:2]]
    assert all("divergent" not in r for r in ranks[0][2:])
    tmp = ranks[1]
    assert [d["extra"]["resume"]["from"] for d in div] == [
        f"{tmp}/div.json", f"{tmp}/div.json.p1"]
    for d in div:
        assert d["errors"] == 0 and d["n_chips"] == 2
        assert d["extra"]["resume"]["objects_skipped"] == 1
        assert d["extra"]["objects_this_run"] == 2
        assert d["bytes_total"] == 2 * 100_000


def test_only_rank_0_writes_the_stream_report(ranks):
    results, tmp = ranks
    files = list(Path(tmp).glob("pod_ingest_stream_*.json"))
    assert len(files) == 1 and "_p" not in files[0].name
    assert results[0]["cli"] == (0, f"result: {files[0]}")
    for rank, r in enumerate(results[1:], start=1):
        assert r["cli"] == (0, f"process {rank}/{WORLD} done (report at process 0)")
    res = json.loads(files[0].read_text())
    assert res["errors"] == 0 and res["extra"]["verified"] is True


# ---------------------------------------------------------------- 1 rank --
def test_stream_ingests_all_objects(jax_cpu_devices):
    jcfg_cls, jstore_cls, _ = _jax()
    res = _one_rank(_cfg(), FakeBackend.prepopulated(PREFIX, 2, SIZE), 5,
                    verify=True)
    ref = _reference(5, jstore_cls.prepopulated(PREFIX, 2, SIZE),
                     cfg=_cfg(cls=jcfg_cls), verify=True)
    assert res.errors == 0 and res.extra["verified"] is True
    assert res.bytes_total == ref["bytes_total"] == 5 * SIZE
    assert res.extra["objects"] == 5 and res.n_chips == 1
    assert res.extra["object_checksums"] == ref["extra"]["object_checksums"]
    assert 0 < res.extra["overlap_efficiency"] <= 2.001


@pytest.mark.parametrize("route", ["threads", "mux"])
def test_stream_no_stale_bytes_across_reused_buffers(route, monkeypatch):
    """The buffer sets are reused across objects of different sizes: each
    object's gathered checksum is the true sum of its bytes, on the
    thread route and on the mux route (the rank's shard as 8 ranges of
    one h2 connection, whose pad tails ``fetch_shards_mux`` zeroes)."""
    from tpubench_torch.storage.fake_h2_server import FakeH2Server

    muxed = []
    real = pod_ingest_stream.fetch_shards_mux
    monkeypatch.setattr(pod_ingest_stream, "fetch_shards_mux",
                        lambda *a: muxed.append(len(a[4])) or real(*a))
    cfg = _cfg(workers=3)
    store = _sized_store(FakeBackend)
    if route == "threads":
        res = _one_rank(cfg, store, 6, verify=True)
    else:
        with FakeH2Server(store) as srv:
            t = cfg.transport
            t.protocol, t.http2, t.endpoint = "http", True, srv.endpoint
            cfg.workload.bucket = "testbucket"
            res = _one_rank(cfg, None, 6, verify=True)
    assert muxed == ([] if route == "threads" else [8] * 6)
    assert res.errors == 0 and res.extra["verified"] is True
    want = [_true_sum(f"{PREFIX}{k % 3}", SIZES[k % 3]) for k in range(6)]
    assert res.extra["object_checksums"] == want


class GatedFetch:
    """The read of object k + 1's shard returns only once object k's
    gather is complete (the first gather is the warm-up): the storage's
    latency then spans the device work, whatever the load on the
    machine's cores, so the ratio below measures whether the fetch
    overlaps at all. A stream that fetched after gathering would find the
    gate open and score under 1.0."""

    def __init__(self, monkeypatch):
        self._cond = threading.Condition()
        self._gathers = self._fetches = 0
        real_fetch = pod_ingest_stream.fetch_shard
        real_make = pod_ingest_stream.make_reassemble

        def fetch(*a, **kw):
            with self._cond:
                k = self._fetches
                self._fetches += 1
            real_fetch(*a, **kw)
            with self._cond:  # object k - 1's gather, after the warm-up
                self._cond.wait_for(lambda: self._gathers > k, timeout=30)

        def make(pod):
            fn = real_make(pod)

            def call(staged):
                out = fn(staged)
                with self._cond:
                    self._gathers += 1
                    self._cond.notify_all()
                return out

            return call

        monkeypatch.setattr(pod_ingest_stream, "fetch_shard", fetch)
        monkeypatch.setattr(pod_ingest_stream, "make_reassemble", make)


def test_stream_overlap_hides_device_work(monkeypatch):
    """With fetch latency injected, the fetch of object k+1 overlaps
    object k's stage and gather: (fetch + device) / wall > 1.05. The
    store is gated (``GatedFetch``): on a loaded machine the gloo
    gather's CPU time grew to 5-14x the latency-bound fetch's, which
    capped the ratio near 1.05 though the fetch still overlapped."""
    size = 32 * 1024 * 1024
    store = FakeBackend.prepopulated(
        PREFIX, 2, size, fault=FaultPlan(per_read_latency_s=0.015))
    GatedFetch(monkeypatch)
    res = _one_rank(_cfg(size=size), store, 6)
    assert res.errors == 0
    assert res.extra["overlap_efficiency"] > 1.05, res.extra


def test_stream_snapshots(tmp_path):
    store = FakeBackend.prepopulated(
        PREFIX, 2, SIZE, fault=FaultPlan(per_read_latency_s=0.001))
    path = str(tmp_path / "snap.json")
    res = _one_rank(_cfg(), store, 3, snapshot_path=path)
    assert res.errors == 0 and os.path.exists(path)
    with open(path) as f:
        snap = json.load(f)
    assert snap["objects_done"] == 3 and snap["bytes"] == 3 * SIZE


def test_stream_resume_skips_delivered_objects(tmp_path):
    store = FakeBackend.prepopulated(PREFIX, 2, SIZE)
    path = str(tmp_path / "snap.json")
    first = _one_rank(_cfg(), store, 2, snapshot_path=path)
    assert first.bytes_total == 2 * SIZE
    resumed = _one_rank(_cfg(), store, 4, snapshot_path=path, resume_from=path)
    assert resumed.errors == 0 and resumed.bytes_total == 2 * SIZE
    assert resumed.extra["resume"] == {
        "from": path, "objects_skipped": 2, "prior_bytes": 2 * SIZE,
        "prior_found": True}
    assert resumed.extra["objects_this_run"] == 2
    with open(path) as f:
        assert json.load(f)["objects_done"] == 4


def test_stream_resume_nothing_left(tmp_path):
    store = FakeBackend.prepopulated(PREFIX, 2, SIZE)
    path = str(tmp_path / "snap.json")
    _one_rank(_cfg(), store, 2, snapshot_path=path)
    res = _one_rank(_cfg(), store, 2, resume_from=path)
    assert res.bytes_total == 0
    assert res.extra["resume"]["objects_skipped"] == 2
    assert res.extra["objects_this_run"] == 0


def test_stream_resume_missing_snapshot_starts_fresh(tmp_path):
    res = _one_rank(_cfg(), FakeBackend.prepopulated(PREFIX, 2, SIZE), 2,
                    resume_from=str(tmp_path / "nope.json"))
    assert res.bytes_total == 2 * SIZE
    assert res.extra["resume"]["objects_skipped"] == 0
    assert res.extra["resume"]["prior_found"] is False


def test_stream_resume_torn_snapshot_starts_fresh(tmp_path, capsys):
    path = str(tmp_path / "snap.json")
    with open(path, "w") as f:
        f.write('{"objects_done": 2, "resume_point"')  # torn mid-key
    res = _one_rank(_cfg(), FakeBackend.prepopulated(PREFIX, 2, SIZE), 2,
                    resume_from=path)
    assert res.bytes_total == 2 * SIZE
    assert res.extra["resume"]["objects_skipped"] == 0
    assert res.extra["resume"]["prior_found"] is False
    assert "truncated/partial snapshot" in capsys.readouterr().err


def test_reference_snapshot_resumes_the_port_and_back(tmp_path, jax_cpu_devices):
    """A snapshot ``tpubench stream`` wrote resumes the port's stream, and
    the port's resumes ``tpubench``'s: one format, read by
    ``convert.stream_state``."""
    jcfg_cls, jstore_cls, _ = _jax()
    path = str(tmp_path / "snap.json")
    _reference(2, jstore_cls.prepopulated(PREFIX, 2, SIZE),
               cfg=_cfg(cls=jcfg_cls), snapshot_path=path)
    with open(path) as f:
        assert convert.stream_state(json.load(f)) == {
            "objects_done": 2, "resume_point": 2, "bytes": 2 * SIZE}
    res = _one_rank(_cfg(), FakeBackend.prepopulated(PREFIX, 2, SIZE), 4,
                    snapshot_path=path, resume_from=path, verify=True)
    assert res.extra["resume"]["objects_skipped"] == 2
    assert res.bytes_total == 2 * SIZE and res.extra["verified"] is True
    back = _reference(5, jstore_cls.prepopulated(PREFIX, 2, SIZE),
                      cfg=_cfg(cls=jcfg_cls), resume_from=path)
    assert back["extra"]["resume"]["objects_skipped"] == 4
    assert back["bytes_total"] == SIZE


def test_stream_waits_for_each_copy_and_holds_one_object(monkeypatch):
    """The fetch into a buffer set starts only after the copy staged out
    of it last has completed (its event waited on); the fetch thread is
    not the main thread; and when object k is staged, no staged shard
    or gather of an earlier object is alive. One ``reassemble`` call per
    object plus one per shard shape (the warm-up, and a new shape's
    uncounted call)."""
    events, staged_refs, calls = [], [], []
    main = threading.get_ident()
    real_stage = pod_ingest_stream.shard_to_device_array
    real_fetch = pod_ingest_stream.StreamedPodIngest._fetch_local
    real_make = pod_ingest_stream.make_reassemble

    class Event:
        def __init__(self, inner, key):
            self.inner, self.key = inner, key

        def synchronize(self):
            self.inner.synchronize()
            events.append(("synced", self.key))

    def stage(shards, pod, lane):
        assert all(ref() is None for ref in staged_refs), "an object outlived"
        key = shards[0].data_ptr()
        events.append(("staged", key))
        out = real_stage(shards, pod, lane)
        staged_refs.append(weakref.ref(out.array))
        out.event = Event(out.event, key)
        return out

    def fetch(self, plan, buffer, parent_ctx=None):
        assert threading.get_ident() != main
        events.append(("fetch", buffer.__array_interface__["data"][0]))
        return real_fetch(self, plan, buffer, parent_ctx)

    def make(pod):
        fn = real_make(pod)

        def call(staged):
            gathered, csum = fn(staged)
            calls.append(1)
            staged_refs.append(weakref.ref(gathered))
            return gathered, csum

        return call

    monkeypatch.setattr(pod_ingest_stream, "shard_to_device_array", stage)
    monkeypatch.setattr(pod_ingest_stream.StreamedPodIngest, "_fetch_local",
                        fetch)
    monkeypatch.setattr(pod_ingest_stream, "make_reassemble", make)
    res = _one_rank(_cfg(workers=3), _sized_store(FakeBackend), 6, verify=True)
    assert res.errors == 0 and res.extra["verified"] is True
    assert len(calls) == 6 + len(SIZES)
    pending = set()  # sets staged whose copy was not yet waited on
    for kind, key in events:
        if kind == "staged":
            pending.add(key)
        elif kind == "synced":
            pending.discard(key)
        else:
            assert key not in pending, f"fetch into set {key} mid-copy"
    assert sum(k == "fetch" for k, _ in events) == 6


def test_stream_obs_plane_as_in_reference(tmp_path, jax_cpu_devices):
    """Telemetry (OTLP dry-run), the cloud dry-run export and the flight
    journal on: the port's stream leaves the blocks ``tpubench``'s leaves,
    and a journal with one object record per object (staged and
    gathered) and one shard record per object and rank."""
    jcfg_cls, jstore_cls, _ = _jax()

    def switch(cfg, name):
        cfg.obs.export = "cloud"
        cfg.obs.flight_journal = str(tmp_path / name)
        cfg.telemetry.otlp = True
        return cfg

    ref = _reference(3, jstore_cls.prepopulated(PREFIX, 2, SIZE),
                     cfg=switch(_cfg(cls=jcfg_cls), "jax.json"))
    res = _one_rank(switch(_cfg(), "port.json"),
                    FakeBackend.prepopulated(PREFIX, 2, SIZE), 3).to_dict()
    assert set(res["extra"]) == set(ref["extra"])
    assert {"telemetry", "metrics_export", "flight", "flight_journal"} <= set(
        res["extra"])
    assert res["extra"]["telemetry"].keys() == ref["extra"]["telemetry"].keys()
    journal = json.loads((tmp_path / "port.json").read_text())
    assert journal["workload"] == "pod_ingest_stream"
    objs = [r for r in journal["records"] if r["kind"] == "object"]
    assert len(objs) == 3 and all(
        {"body_complete", "hbm_staged", "gather_complete"} <= set(r["phases"])
        for r in objs)
    assert sum(r["kind"] == "read" for r in journal["records"]) == 3
