"""The port's stagers on the card against the same stagers on the CPU
(the kernels themselves: ``tests/test_torch_kernels.py``), and the pod
commands on a one-rank NCCL group against a gloo one.

Every test here needs a CUDA device and skips without one (decided in a
fixture). The file imports neither jax nor the JAX package, so it runs on
a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from tpubench_torch.config import StagingConfig
from tpubench_torch.staging.device import DevicePutStager
from tpubench_torch.staging.land_stage import LandStager
from tpubench_torch.storage.base import deterministic_bytes

pytestmark = pytest.mark.cuda
GRANULE = 64 * 1024


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _feed(stager, data: np.ndarray) -> dict:
    mv = memoryview(data.tobytes())
    for off in range(0, len(mv), GRANULE):
        n = min(GRANULE, len(mv) - off)
        dst = stager.acquire()
        dst[:n] = mv[off : off + n]
        stager.commit(n)
    return stager.finish()


@pytest.mark.parametrize("kind, cfg", [
    ("copy", dict(validate_checksum=True)),
    ("copy", dict(depth=3)),
    ("land", dict(depth=3)),
    ("land", dict(double_buffer=False)),
], ids=["validate_ring", "depth3_window", "land_ring", "land_depth1"])
def test_stagers_on_cuda_match_cpu(cuda, kind, cfg):
    data = deterministic_bytes("torch/cuda", 3_000_001)
    stats = {}
    for dev in ("cpu", "cuda"):
        sc = StagingConfig()
        for k, v in cfg.items():
            setattr(sc, k, v)
        cls = DevicePutStager if kind == "copy" else LandStager
        stats[dev] = _feed(cls(0, GRANULE, cfg=sc, device=dev,
                               slot_bytes=256 * 1024), data)
    cpu, gpu = stats["cpu"], stats["cuda"]
    for key in ("staged_bytes", "transfers", "slot_bytes", "checksum_ok",
                "checksum_host", "checksum_device"):
        assert cpu.get(key) == gpu.get(key), key
    assert gpu["device"] == "cuda:0"
    assert gpu["staged_bytes"] == 3_000_001
    if kind == "copy":
        assert gpu["native_slots"] is True


def test_each_worker_has_its_own_stream(cuda):
    """More workers than PyTorch's 32 pooled streams per device: each
    worker's stager gets a stream no other worker's has, and the next
    stager of a worker takes that worker's stream again."""
    first = [DevicePutStager(i, GRANULE, device=cuda, slot_bytes=GRANULE)
             for i in range(40)]
    again = [LandStager(i, GRANULE, device=cuda, slot_bytes=GRANULE)
             for i in range(40)]
    handles = [st.stream.cuda_stream for st in first]
    assert len(set(handles)) == len(first)
    assert [st.stream.cuda_stream for st in again] == handles
    for st in first + again:
        st.finish()


def test_native_staged_validate_route_on_cuda(cuda, monkeypatch):
    """The executor route on the card: range GETs from the port's loopback
    server land in page-locked slots, one checksum kernel launch per
    transfer, each worker on its own stream, device sums exact."""
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.kernels import landing
    from tpubench_torch.native.engine import NativeSourceServer, get_engine
    from tpubench_torch.workloads import fetch_executor
    from tpubench_torch.workloads.read import run_read

    made = []

    class Kept(fetch_executor._SlotPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(fetch_executor, "_SlotPipeline", Kept)
    name, size, slot, workers, reads = "tpubench/file_0", 3_000_001, 256 * 1024, 4, 2
    body = deterministic_bytes(name, size)
    cfg = BenchConfig()
    cfg.transport.protocol = "http"
    cfg.workload.bucket = "testbucket"
    cfg.workload.object_name_prefix = "tpubench/file_"
    cfg.workload.workers = workers
    cfg.workload.read_calls_per_worker = reads
    cfg.workload.fetch_executor = "native"
    cfg.staging.slot_bytes = slot
    cfg.staging.validate_checksum = True
    with NativeSourceServer(get_engine(), name, body) as srv:
        cfg.transport.endpoint = srv.endpoint
        landing.reset_launches()
        res = run_read(cfg, device=cuda)
        launches = landing.checksum.launches
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert res.extra["executor_mode"] == "reactor"
    assert res.extra["staged_bytes"] == workers * reads * size
    transfers = sum(p.transfers for p in made)
    assert launches == transfers == workers * reads * -(-size // slot)
    assert len(made) == workers
    assert all(s.is_pinned() for p in made for s in p.slots)
    assert len({p.stream.cuda_stream for p in made}) == workers
    want = reads * int(body.sum(dtype=np.uint64)) % (1 << 32)
    assert all(p.sums() == (want, want) for p in made)


def test_native_receive_into_pinned_slots_on_cuda(cuda):
    """The worker-pool route with native receive on the card: bodies from
    the port's HTTP/1.1 fake land straight in page-locked slots (zero
    copy), one checksum kernel launch per transfer, device sums exact."""
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.storage.fake_server import FakeGcsServer
    from tpubench_torch.workloads.read import run_read

    workers, reads, size = 4, 2, 3_000_001
    cfg = BenchConfig()
    cfg.transport.protocol = "http"
    cfg.transport.native_receive = True
    cfg.workload.bucket = "testbucket"
    cfg.workload.object_name_prefix = "tpubench/file_"
    cfg.workload.workers = workers
    cfg.workload.read_calls_per_worker = reads
    cfg.workload.granule_bytes = GRANULE
    cfg.staging.slot_bytes = 256 * 1024
    cfg.staging.validate_checksum = True
    stats = []
    factory = make_sink_factory(cfg, device=cuda)

    def kept(i):
        stager = factory(i)
        assert all(s.is_pinned() for s in stager._slots)
        finish = stager.finish
        stager.finish = lambda: stats.append(finish()) or stats[-1]
        return stager

    store = FakeBackend.prepopulated("tpubench/file_", workers, size)
    with FakeGcsServer(store) as srv:
        cfg.transport.endpoint = srv.endpoint
        landing.reset_launches()
        res = run_read(cfg, device=cuda, sink_factory=kept)
        launches = landing.checksum.launches
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert res.extra["staging_zero_copy"] is True
    assert res.extra["staged_bytes"] == workers * reads * size
    assert res.extra["native_conn_stats"]["connects"] <= workers
    assert launches == sum(st["transfers"] for st in stats) > 0
    for st in stats:
        assert st["checksum_device"] == st["checksum_host"] % (1 << 32)


@pytest.mark.parametrize("kind, cfg", [
    ("copy", dict(validate_checksum=True)),
    ("copy", dict(depth=3)),
    ("land", dict(depth=3)),
], ids=["validate_ring", "depth3_window", "land_ring"])
def test_stage_records_on_cuda_match_cpu(cuda, kind, cfg):
    """The flight recorder's stage records with the card's events deciding
    completion (the window's live reaper at depth 3): one record per
    transfer from the copy rings, none from the landing-kernel ring, each
    with ``stage_submit <= stage_complete == hbm_staged`` — the same
    records, by structure, as on the CPU."""
    from tpubench_torch.obs.flight import FlightRecorder

    data = deterministic_bytes("torch/cuda/flight", 3_000_001)
    shapes = {}
    for dev in ("cpu", "cuda"):
        sc = StagingConfig()
        for k, v in cfg.items():
            setattr(sc, k, v)
        cls = DevicePutStager if kind == "copy" else LandStager
        rec = FlightRecorder(capacity_per_worker=64)
        with rec.activate():
            stats = _feed(cls(0, GRANULE, cfg=sc, device=dev,
                              slot_bytes=256 * 1024), data)
        recs = rec.records()
        for r in recs:
            ph = r["phases"]
            assert ph["enqueue"] <= ph["stage_submit"]
            assert ph["stage_submit"] <= ph["stage_complete"] == ph["hbm_staged"]
        shapes[dev] = [(r["kind"], r["object"], sorted(r["phases"]), r["bytes"])
                       for r in recs]
        want = 0 if kind == "land" else stats["transfers"]
        assert len(recs) == want
        if recs:
            assert sum(r["bytes"] for r in recs) == stats["staged_bytes"]
    assert shapes["cpu"] == shapes["cuda"]


def test_one_rank_nccl_pod_ingest_matches_cpu(cuda, tmp_path):
    """``pod-ingest`` through ``cli.execute`` on a one-rank NCCL group
    (brought up and torn down by the run), both modes, against the same
    run on a one-rank gloo group on the CPU."""
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage.fake import FakeBackend

    store = FakeBackend.prepopulated("tpubench/file_", 1, 3_000_001)
    for flags in ([], ["--ring"]):
        args = cli.build_parser().parse_args([
            "pod-ingest", "--protocol", "fake", "--workers", "1",
            "--object-size", "3000001", "--results-dir", str(tmp_path),
            *flags])
        cfg = cli.build_config(args)
        out = {}
        for dev in ("cpu", "cuda"):
            landing.reset_launches()
            out[dev] = cli.execute("pod-ingest", cfg, device=dev,
                                   backend=store, args=args)
            assert not dist.is_initialized()
            launches = landing.checksum.launches
        assert launches == 2  # one shard, warm-up + timed gather
        for res in out.values():
            assert res.errors == 0 and res.extra["verified"] is True
        for key in ("shard_bytes", "ici_bytes_moved", "holes_global", "mode"):
            assert out["cpu"].extra[key] == out["cuda"].extra[key], key


@pytest.mark.parametrize("mode", ["all_gather", "ring", "reduce_scatter", "psum"])
def test_one_rank_nccl_gather_bench(cuda, mode):
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.config import BenchConfig

    args = cli.build_parser().parse_args([
        "gather-bench", "--shard-mb", "1", "--reps", "2", "--collective", mode])
    res = cli.execute("gather-bench", BenchConfig(), device="cuda", args=args)
    assert not dist.is_initialized()
    assert res.errors == 0 and res.extra["single_device"] is True
    assert [r["devices"] for r in res.extra["scaling"]] == [1]


def test_probe_copies_from_page_locked_arrays(cuda):
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.workloads import probe

    assert probe.host_array(2 * 1024 * 1024, cuda).is_pinned()
    res = probe.run_probe(BenchConfig(), cycles=1, sleep_s=0, device="cuda")
    assert res.extra["device"].startswith("cuda:") and res.gbps > 0


@pytest.mark.parametrize("staging", [["--staging", "pallas"], ["--validate"]],
                         ids=["pallas", "validate"])
def test_sweep_cell_on_cuda_matches_cpu(cuda, tmp_path, capsys, staging):
    """One ``sweep`` cell (fake store, 1 MiB objects) on the card and on
    the CPU: the same bytes and checksum verdict, and one kernel launch
    per transfer on the card (``tb_land`` or ``tb_checksum``)."""
    import json

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    docs = {}
    for dev in ("cpu", "cuda"):
        landing.reset_launches()
        rc = cli.main(["sweep", "--protocol", "fake", "--sweep-protocols",
                       "fake", "--sweep-sizes", "1mb", "--workers", "2",
                       "--read-call-per-worker", "3", "--granule-bytes",
                       "65536", "--slot-bytes", "262144", *staging,
                       "--device", dev, "--results-dir", str(tmp_path / dev)])
        assert rc == 0
        (row,) = json.loads(capsys.readouterr().out)
        with open(row["result"]) as f:
            docs[dev] = json.load(f)
        launches = (landing.land.launches, landing.checksum.launches)
    for doc in docs.values():
        assert doc["errors"] == 0 and doc["extra"]["checksum_ok"] is True
        assert doc["extra"]["staged_bytes"] == 2 * 3 * 1024 * 1024
    assert docs["cpu"]["extra"]["sweep"] == docs["cuda"]["extra"]["sweep"]
    # 1 MiB per read in 256 KiB slots: 4 transfers a read, 6 reads.
    kernel = 0 if "pallas" in staging else 1
    assert launches[kernel] == 24 and launches[1 - kernel] == 0


@pytest.mark.parametrize("kind", ["http2", "grpc_native"])
def test_mux_pod_ingest_on_cuda_matches_cpu(cuda, kind):
    """``pod-ingest`` over one multiplexed connection on one NCCL rank and
    on one gloo rank: verified both, the same shard layout, the pod sum
    by ``tb_checksum`` on the card (warm-up + timed gather)."""
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage import base_backend, open_backend
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.storage.fake_grpc_wire_server import (
        FakeGrpcWireServer,
    )
    from tpubench_torch.storage.fake_h2_server import FakeH2Server

    store = FakeBackend.prepopulated("tpubench/file_", 1, 3_000_001)
    server = FakeH2Server if kind == "http2" else FakeGrpcWireServer
    out = {}
    with server(store) as srv:
        cfg = BenchConfig()
        t = cfg.transport
        t.endpoint, t.directpath = srv.endpoint, False
        if kind == "http2":
            t.protocol, t.http2 = "http", True
        else:
            t.protocol, t.native_receive = "grpc", True
        for dev in ("cpu", "cuda"):
            backend = open_backend(cfg)
            landing.reset_launches()
            out[dev] = cli.execute("pod-ingest", cfg, device=dev,
                                   backend=backend)
            inner = base_backend(backend)
            pool = inner._h2_pool() if kind == "http2" else inner._native_pool()
            assert pool.stats["connects"] == 1
            backend.close()
            assert not dist.is_initialized()
    assert landing.checksum.launches == 2
    for res in out.values():
        assert res.errors == 0 and res.extra["verified"] is True
        assert res.bytes_total == 3_000_001
    for key in ("shard_bytes", "holes_global", "mode"):
        assert out["cpu"].extra[key] == out["cuda"].extra[key], key


def test_one_rank_nccl_stream_matches_cpu(cuda, tmp_path):
    """``stream`` through ``cli.execute`` on a one-rank NCCL group, objects
    of three sizes (the buffer sets reused across sizes), against the same
    run on the CPU: the same per-object checksums, each the true byte sum
    of its object; one ``tb_checksum`` launch per object and one per
    shard shape on the card."""
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage.fake import FakeBackend

    sizes = (3_000_001, 1_000_003, 70_001)
    store = FakeBackend.from_population(
        [(f"tpubench/file_{i}", s, 1) for i, s in enumerate(sizes)])
    args = cli.build_parser().parse_args([
        "stream", "--protocol", "fake", "--workers", "3", "--objects", "6",
        "--validate", "--results-dir", str(tmp_path)])
    cfg = cli.build_config(args)
    out = {}
    for dev in ("cpu", "cuda"):
        landing.reset_launches()
        out[dev] = cli.execute("stream", cfg, device=dev, backend=store,
                               args=args)
        assert not dist.is_initialized()
    assert landing.checksum.launches == 6 + len(sizes)
    want = [int(deterministic_bytes(f"tpubench/file_{k % 3}", sizes[k % 3])
                .sum(dtype=np.uint64)) % (1 << 32) for k in range(6)]
    for res in out.values():
        assert res.errors == 0 and res.extra["verified"] is True
        assert res.extra["object_checksums"] == want
        assert res.bytes_total == 2 * sum(sizes)


def test_slab_leases_land_intact_through_the_window(cuda):
    """Page-locked slab leases copied in place by the overlapped window
    (``submit_owned``), reused from a two-slab pool as soon as each
    retires: every landed chunk equals its source — a slab handed back
    before its copy's event completed would land the next chunk's
    bytes."""
    import time

    from tpubench_torch.device import worker_stream
    from tpubench_torch.mem.slab import SlabPool
    from tpubench_torch.staging.executor import TransferEngine

    class Keeping(TransferEngine):
        """The stager's own engine, keeping each landed tensor."""

        def __init__(self, stream):
            super().__init__(stream)
            self.landed = []

        def submit(self, array, device):
            handle = super().submit(array, device)
            self.landed.append(handle[0])
            return handle

    pool = SlabPool(1 << 20, 2, device="cuda")
    assert pool.native and pool.pin_seconds > 0
    eng = Keeping(worker_stream(torch.device("cuda", 0), 0))
    st = DevicePutStager(0, GRANULE, cfg=StagingConfig(depth=3),
                         device="cuda", transfer_engine=eng)
    assert st.stream is eng._stream
    sources = []
    for i in range(64):
        while pool.leased >= 2:
            time.sleep(0.0001)
        lease = pool.lease((1 << 20) - 4096 * (i % 3))
        assert lease.as_tensor().is_pinned()
        src = deterministic_bytes(f"slab/{i}", len(lease))
        lease.view()[:] = src.tobytes()
        sources.append(src)
        st.submit_owned(lease)
    stats = st.finish()
    assert stats["transfers"] == 64
    assert stats["staged_bytes"] == sum(len(s) for s in sources)
    for landed, src in zip(eng.landed, sources):
        assert landed.device.type == "cuda"
        assert np.array_equal(landed.cpu().numpy(), src)
    s = pool.stats()
    assert s["overflow_leases"] == 0 and pool.close()["leaked_slabs"] == 0


@pytest.mark.parametrize("flags", [
    ["--depth", "3"], ["--validate"], ["--staging", "pallas"],
    ["--pipeline-pod"],
], ids=["depth3", "validate", "pallas", "pod"])
def test_train_ingest_on_cuda_matches_cpu(cuda, tmp_path, flags):
    """``train-ingest`` through ``cli.execute`` on the card and on the
    CPU: the same cache counters, bytes, staged bytes and checksums;
    page-locked slabs on the card; the rings' kernels launched once per
    transfer (the pod's checksum once per step and once for the
    warm-up), none by the overlapped copy window."""
    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage.fake import FakeBackend

    store = FakeBackend.prepopulated("tpubench/file_", 4, 1_000_003)
    args = cli.build_parser().parse_args([
        "train-ingest", "--protocol", "fake", "--workers", "4",
        "--granule-bytes", str(GRANULE), "--steps", "6", "--epochs", "2",
        "--batch-shards", "8", "--readahead", "0", "--slot-bytes",
        str(256 * 1024), "--results-dir", str(tmp_path), *flags])
    cfg = cli.build_config(args)
    out, launches = {}, {}
    for dev in ("cpu", "cuda"):
        landing.reset_launches()
        out[dev] = cli.execute("train-ingest", cfg, device=dev,
                               backend=store, args=args)
        launches[dev] = (landing.land.launches, landing.checksum.launches)
    cpu, gpu = out["cpu"], out["cuda"]
    pool = gpu.extra["pipeline"]["copies"]["pool"]
    assert pool["native"] is True and pool["leaked_slabs"] == 0
    for res in (cpu, gpu):
        # 48 chunks a pass: the first three objects, 16 chunks each.
        assert res.errors == 0 and res.bytes_total == 2 * 3 * 1_000_003
    assert gpu.extra["pipeline"]["cache"] == cpu.extra["pipeline"]["cache"]
    for key in ("staged_bytes", "checksum_ok", "checksum_device",
                "checksum_host"):
        assert gpu.extra.get(key) == cpu.extra.get(key), key
    stage = gpu.summaries.get("stage")
    want = {"depth3": (0, 0), "validate": (0, stage and stage.count),
            "pallas": (stage and stage.count, 0),
            "pod": (0, 12 + 1)}[
        {"--depth": "depth3", "--validate": "validate", "--staging": "pallas",
         "--pipeline-pod": "pod"}[flags[0]]]
    assert launches == {"cpu": (0, 0), "cuda": want}
    assert sum(want) > 0 or gpu.extra["staging"]["transfers"] == 96


def test_ici_peer_channel_round_trip_on_nccl(cuda):
    """``IciPeerChannel.broadcast`` on a one-rank NCCL group: every echo
    bit-exact and one ``tb_checksum`` launch per broadcast (the
    all-gather's pod checksum); a gloo group on CUDA is refused."""
    import torch.distributed as dist

    from tpubench_torch.config import DistConfig
    from tpubench_torch.dist import bringup
    from tpubench_torch.dist.peer import IciPeerChannel
    from tpubench_torch.kernels import landing
    from tpubench_torch.pipeline.cache import ChunkKey

    sizes = (128, 1000, 4096, 2 << 20)
    with bringup.session(DistConfig(), "cuda", one_rank_group=True):
        assert dist.get_backend() == "nccl"
        ch = IciPeerChannel(device="cuda")
        landing.reset_launches()
        for n in sizes:
            data = deterministic_bytes(f"coop/{n}", n).tobytes()
            assert ch.broadcast(0, data, ChunkKey("b", "o", 1, 0, n)) == data
        assert landing.checksum.launches == len(sizes)
        assert ch.stats()["broadcasts"] == len(sizes)
        ch.close()
    assert not dist.is_initialized()
    with bringup.session(DistConfig(), "cpu", one_rank_group=True):
        from tpubench_torch.dist.reassemble import make_mesh

        pod = make_mesh(device="cpu")
        cuda_pod = type(pod)(pod.group, torch.device("cuda", 0), pod.ranks)
        with pytest.raises(RuntimeError, match="NCCL"):
            IciPeerChannel(pod=cuda_pod)


@pytest.mark.parametrize("flags", [
    ["--validate"], ["--pipeline-pod", "--coop-channel", "ici"],
], ids=["validate", "pod_ici"])
def test_train_ingest_coop_on_cuda_matches_cpu(cuda, tmp_path, flags):
    """``train-ingest --coop`` on the card and on the CPU: the same coop
    stamp (a pod of one routes nothing), cache counters and bytes; the
    validating ring's ``tb_checksum`` once per transfer, the pod's once
    per step and once for the warm-up."""
    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage.fake import FakeBackend

    store = FakeBackend.prepopulated("tpubench/file_", 4, 1_000_003)
    args = cli.build_parser().parse_args([
        "train-ingest", "--protocol", "fake", "--workers", "4",
        "--granule-bytes", str(GRANULE), "--steps", "6",
        "--batch-shards", "8", "--readahead", "0", "--slot-bytes",
        str(256 * 1024), "--coop", "--results-dir", str(tmp_path), *flags])
    cfg = cli.build_config(args)
    out, launches = {}, {}
    for dev in ("cpu", "cuda"):
        landing.reset_launches()
        out[dev] = cli.execute("train-ingest", cfg, device=dev,
                               backend=store, args=args)
        launches[dev] = landing.checksum.launches
    cpu, gpu = out["cpu"], out["cuda"]
    for res in (cpu, gpu):
        co = res.extra["pipeline"]["coop"]
        assert res.errors == 0 and co["hosts"] == 1
        assert co["peer_requests"] == 0
        # readahead 0: every origin fetch is a demand miss
        assert co["origin_fetches"] == res.extra["pipeline"]["cache"]["misses"]
    assert gpu.extra["pipeline"]["coop"] == cpu.extra["pipeline"]["coop"]
    assert gpu.extra["pipeline"]["cache"] == cpu.extra["pipeline"]["cache"]
    stage = gpu.summaries.get("stage")
    want = 6 + 1 if "--pipeline-pod" in flags else stage.count
    assert launches == {"cpu": 0, "cuda": want}
    if "--validate" in flags:
        assert gpu.extra["checksum_ok"] is True


def test_ckpt_restore_onto_the_card(cuda, tmp_path, monkeypatch):
    """``ckpt-restore`` through ``cli.execute`` on a one-rank NCCL group:
    every object's shard lands on the card and equals its object's bytes
    there; the same restore on the CPU
    gives the same scorecard but for times. An injected copy failure
    raises instead of falling back to a host-RAM restore."""
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.dist import reassemble
    from tpubench_torch.storage.fake import FakeBackend

    store = FakeBackend()
    args = cli.build_parser().parse_args([
        "ckpt-save", "--protocol", "fake", "--ckpt-objects", "3",
        "--ckpt-object-bytes", "3000001", "--ckpt-part-bytes",
        str(1 << 20), "--results-dir", str(tmp_path)])
    cfg = cli.build_config(args)
    assert cli.execute("ckpt-save", cfg, device="cuda",
                       backend=store).errors == 0
    made = []
    real = reassemble.shard_to_device_array

    def kept(*a, **kw):
        st = real(*a, **kw)
        made.append(st)
        return st

    monkeypatch.setattr(reassemble, "shard_to_device_array", kept)
    out = {}
    for dev in ("cpu", "cuda"):
        made.clear()
        out[dev] = cli.execute("ckpt-restore", cfg, device=dev, backend=store)
        assert not dist.is_initialized()
    assert len(made) == 3
    for i, st in enumerate(made):  # the cuda run's, in manifest order
        name = f"ckpt/shard_{i:05d}"
        staged = st.ready()
        want = torch.from_numpy(
            deterministic_bytes(name, 3_000_001)).to(staged.device)
        assert staged.is_cuda
        assert torch.equal(staged.reshape(-1)[:3_000_001], want)
    times = {"time_to_restore_s", "fetch_seconds", "stage_seconds",
             "goodput_gbps"}
    cpu, gpu = ({k: v for k, v in out[d].extra["lifecycle"].items()
                 if k not in times} for d in ("cpu", "cuda"))
    assert gpu == cpu and gpu["verified"] is True and gpu["staged"] is True
    assert out["cuda"].errors == 0 and out["cuda"].n_chips == 1

    def broken(*a, **kw):
        raise RuntimeError("injected copy failure")

    monkeypatch.setattr(reassemble, "shard_to_device_array", broken)
    with pytest.raises(RuntimeError, match="injected copy failure"):
        cli.execute("ckpt-restore", cfg, device="cuda", backend=store)
    assert not dist.is_initialized()


def _chaos_read_cfg(mode: str):
    from tpubench_torch.config import BenchConfig

    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 2
    cfg.workload.read_calls_per_worker = 8
    cfg.workload.object_size = 3_000_001
    cfg.workload.granule_bytes = GRANULE
    cfg.transport.fault.per_read_latency_s = 0.001
    cfg.staging.mode = mode
    cfg.staging.validate_checksum = mode == "device_put"
    cfg.staging.slot_bytes = 256 * 1024
    cfg.obs.export = "none"
    return cfg


@pytest.mark.parametrize("mode", ["device_put", "pallas"])
def test_chaos_read_on_the_card_lands_every_transfer(cuda, mode):
    """``chaos`` over ``read`` stages onto the card: with ``--validate``
    one ``tb_checksum`` a transfer, with ``pallas`` one ``tb_land`` a
    transfer; the verdicts and transfers are the CPU run's."""
    from tpubench_torch.kernels import landing
    from tpubench_torch.workloads.chaos import run_chaos

    out = {}
    for dev in ("cpu", "cuda"):
        landing.reset_launches()
        out[dev] = run_chaos(
            _chaos_read_cfg(mode),
            timeline=[[0.0, 0.05, {"stall_s": 0.02, "stall_rate": 0.5}]],
            device=dev)
    gpu, cpu = out["cuda"].extra, out["cpu"].extra
    # 256 KiB slots of 64 KiB granules (a whole number of landing blocks):
    # a worker's 8 reads of 3,000,001 B ship as the aggregator packs them.
    transfers = 2 * _slots_shipped(3_000_001, GRANULE, 256 * 1024, 8)
    launched = (landing.checksum.launches if mode == "device_put"
                else landing.land.launches)
    assert launched == transfers
    assert gpu["checksum_ok"] is True
    for key in ("staged_bytes", "checksum_ok", "checksum_host",
                "checksum_device"):
        assert gpu.get(key) == cpu.get(key), key
    if mode == "device_put":
        assert gpu["staging"]["transfers"] == transfers
        assert cpu["staging"]["transfers"] == transfers
    assert out["cuda"].extra["chaos"]["scorecard"]["failed_reads"] == 0


def _slots_shipped(object_size: int, granule: int, slot: int,
                   reads: int) -> int:
    """Slots one worker ships for ``reads`` zero-copy reads: a slot ships
    when full, or when less than a granule is left at the next acquire,
    or at the final flush; the fill carries over to the next read."""
    transfers = fill = 0
    for _ in range(reads):
        remaining = object_size
        while True:
            if slot - fill < granule and fill > 0:
                transfers, fill = transfers + 1, 0
            n = min(granule, slot - fill, remaining)
            if n <= 0:
                break
            remaining -= n
            fill += n
            if fill >= slot:
                transfers, fill = transfers + 1, 0
    return transfers + (fill > 0)


def test_serve_on_the_card_launches_nothing(cuda):
    """The serve plane does no device work: a single-host run and a
    4-host elastic run on ``device="cuda"`` launch no kernel."""
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.kernels import landing
    from tpubench_torch.workloads.serve import run_serve

    for hosts in (1, 4):
        cfg = BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.workload.workers = 4
        cfg.workload.object_size = 1 << 20
        cfg.workload.granule_bytes = GRANULE
        cfg.obs.export = "none"
        cfg.serve.duration_s = 0.5
        cfg.serve.hosts = hosts
        if hosts > 1:
            cfg.serve.membership_timeline = [[0.2, 0.2, {"kill_host": 1}]]
        landing.reset_launches()
        res = run_serve(cfg, device="cuda")
        sv = res.extra["serve"]
        assert res.errors == 0 and sv["completed"] > 0
        assert landing.land.launches == landing.checksum.launches == 0


def test_fleet_on_the_card_launches_nothing(cuda):
    """``fleet`` on ``device="cuda"`` (a virtual-time run, and its sweep)
    touches no device: no kernel launched."""
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.fleet.driver import run_fleet, run_fleet_sweep
    from tpubench_torch.kernels import landing

    cfg = BenchConfig()
    cfg.workload.object_size = 1 << 20
    cfg.workload.granule_bytes = GRANULE
    cfg.obs.export = "none"
    cfg.fleet.hosts, cfg.fleet.timeline = 64, "correlated_failure"
    cfg.serve.duration_s = 0.5
    landing.reset_launches()
    res = run_fleet(cfg, device="cuda")
    assert res.errors == 0 and res.extra["serve"]["completed"] > 0
    cfg.serve.sweep_points = [0.5, 1.0]
    sweep = run_fleet_sweep(cfg, device="cuda").extra["serve"]["sweep"]
    assert len(sweep["points"]) == 2
    assert landing.land.launches == landing.checksum.launches == 0


def _lifecycle_cfg():
    from tpubench_torch.config import BenchConfig

    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = 1 << 20
    cfg.obs.export = "none"
    cfg.serve.duration_s, cfg.serve.rate_rps = 1.0, 60.0
    cfg.serve.tenants, cfg.serve.workers, cfg.serve.hosts = 24, 4, 3
    lc = cfg.lifecycle
    lc.objects, lc.object_bytes, lc.part_bytes = 3, 256 * 1024, 64 * 1024
    lc.meta_objects, lc.meta_duration_s = 16, 0.5
    cfg.drill.kill_at_s, cfg.drill.join_at_s = 0.3, 0.5
    cfg.drill.save_interval_s = 0.4
    return cfg


def test_meta_storm_on_the_card_launches_nothing(cuda, monkeypatch):
    """``meta-storm`` on ``device="cuda"`` runs and launches no kernel."""
    from tpubench_torch.kernels import landing
    from tpubench_torch.workloads.meta_storm import run_meta_storm

    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0")
    landing.reset_launches()
    res = run_meta_storm(_lifecycle_cfg(), device="cuda")
    lc = res.extra["lifecycle"]
    assert lc["errors"] == 0 and lc["completed"] == lc["ops"] > 0
    assert landing.land.launches == landing.checksum.launches == 0


def test_drill_on_the_card_launches_nothing(cuda, monkeypatch):
    """The drill on ``device="cuda"``: the restore verified through the
    pod's unpinned host pools, no slab leaked, no kernel launched."""
    from tpubench_torch.kernels import landing
    from tpubench_torch.workloads.drill import run_drill

    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0")
    landing.reset_launches()
    res = run_drill(_lifecycle_cfg(), device="cuda")
    assert res.errors == 0 and res.extra["drill"]["restore"]["verified"]
    assert res.extra["membership"]["pool_leaked_slabs"] == 0
    assert landing.land.launches == landing.checksum.launches == 0


def test_replay_on_the_card_launches_nothing(cuda, monkeypatch):
    """Both goldens replay on ``device="cuda"`` under their recording
    config with no kernel launched."""
    from pathlib import Path

    from tpubench_torch.config import BenchConfig
    from tpubench_torch.kernels import landing
    from tpubench_torch.replay.bundle import load_bundle
    from tpubench_torch.replay.driver import run_replay

    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0")
    root = Path(__file__).resolve().parents[1] / "scenarios"
    for name in ("chaos-serve-gold", "drill-restore-gold"):
        cfg = BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.workload.workers = 4
        cfg.workload.object_size = 1 << 20
        cfg.obs.export = "none"
        landing.reset_launches()
        res = run_replay(cfg, load_bundle(str(root / f"{name}.tpb.gz")),
                         device="cuda")
        rp = res.extra["replay"]
        assert rp["config_match"] and rp["arrivals_match"], rp
        assert landing.land.launches == landing.checksum.launches == 0
