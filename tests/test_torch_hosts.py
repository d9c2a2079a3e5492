"""A pod of several hosts, each running one rank a card: ``launch.launch``
with ``pod=`` and the bring-up's checks.

``tpubench`` starts one process a host (``--num-processes H --process-id
h --coordinator c``) and each meshes every local chip. The port starts L
ranks a host, rank l of host h being global rank h·L + l of H·L. Here two
"hosts" of 2 gloo ranks each (two ``launch.launch(argv, 2, pod=...)`` at
once, ``--device cpu``) play the part of two VMs of 2 chips, and global
rank 0's result is held against ``tpubench`` on a 4-device JAX CPU mesh
(``make_mesh(jax.devices()[:4])``, as ``tests/test_torch_launch.py``):

* ``pod-ingest``: ``n_chips`` 4, ``verified``, the bytes, ``shard_bytes``,
  ``ici_bytes_moved``, the holes; one flight journal a rank, named by its
  global rank;
* ``stream --validate``: ``n_chips`` 4, ``verified``, every object's
  checksum; one snapshot a rank;
* ``ckpt-restore``: ``n_chips`` 4, ``shards_per_object`` 4, ``verified``;
* the topology stamp is ``tpubench``'s for 2 hosts of 2 chips, each rank
  says which host it is on, and only global rank 0 writes a result.

The refusals come before NCCL, on every rank and fast: hosts that see
different card counts, two hosts with one ``--process-id`` (a second
host 0 cannot serve the store, a second host 1 is named by the hosts'
notes), two ranks on one card (keyed by the card, here a fake UUID in
two spawned ranks), and ``--coop-host-id`` on a command line that
launches several ranks. A launched rank takes its place from the
launcher alone, not from the host's ``--process-id`` flag (the
flags-over-environment trap), and labels its exported series with it.
"""

from __future__ import annotations

import glob
import json
import multiprocessing as mp
import os
import queue
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tpubench_torch import cli
from tpubench_torch.config import DistConfig
from tpubench_torch.dist import bringup, launch
from tpubench_torch.storage.fake import FakeBackend

HOSTS, CARDS = 2, 2
RANKS = HOSTS * CARDS
SIZE = 100_003  # uneven: padding and trim
STREAM_OBJECTS, STREAM_WORKERS = 3, 3
CKPT_OBJECTS, CKPT_BYTES, CKPT_PART = 3, 200_003, 65_536
PREFIX = "tpubench/file_"
DEADLINE_S = 120.0
REFUSAL_S = 30.0  # a refused pod ends well inside this
MOD = 1 << 32


def _host_argv(cmd: list, host: int, port: int, results: str,
               hosts: int = HOSTS) -> list:
    return [*cmd, "--num-processes", str(hosts), "--process-id", str(host),
            "--coordinator", f"127.0.0.1:{port}", "--device", "cpu",
            "--results-dir", results]


def _pod(cmd: list, results: str, cards=(CARDS, CARDS), ids=(0, 1),
         split=False):
    """Each host's launch of ``cmd`` at once, one thread a host (as many
    hosts as ``cards``): the exit codes, and the seconds until the last
    ended. ``split`` gives host h a results directory of its own,
    ``<results>/h<h>``."""
    port = bringup.free_port()

    def host(h: int) -> int:
        out = os.path.join(results, f"h{h}") if split else results
        argv = _host_argv(cmd, ids[h], port, out, hosts=len(cards))
        pod = cli.build_config(cli.build_parser().parse_args(argv)).dist
        return launch.launch(argv, cards[h], results_dir=out,
                             deadline_s=DEADLINE_S, pod=pod)

    t0 = time.monotonic()
    with ThreadPoolExecutor(len(cards)) as ex:
        rcs = list(ex.map(host, range(len(cards))))
    return rcs, time.monotonic() - t0


def _logs(results: str) -> dict:
    """Every rank's log text, by the global rank in its name."""
    out = {}
    for path in glob.glob(os.path.join(results, launch.RANK_LOG_DIR, "*",
                                       "rank*.log")):
        with open(path) as f:
            out[int(os.path.basename(path)[4:-4])] = f.read()
    return out


def _rank_lines(results: str) -> list:
    return [json.loads(ln)["local_rank"]
            for text in _logs(results).values()
            for ln in text.splitlines() if ln.startswith('{"local_rank"')]


def _result(results: str) -> dict:
    paths = glob.glob(os.path.join(results, "*.json"))
    assert len(paths) == 1, paths  # global rank 0's alone
    with open(paths[0]) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    """Every pod of this file at once: three commands on 2 hosts x 2
    ranks, and the two refused pods."""
    tmp = tmp_path_factory.mktemp("hosts")
    ckpt_dir = str(tmp / "ckpt")
    assert cli.main([
        "ckpt-save", "--protocol", "local", "--dir", ckpt_dir,
        "--ckpt-objects", str(CKPT_OBJECTS),
        "--ckpt-object-bytes", str(CKPT_BYTES),
        "--ckpt-part-bytes", str(CKPT_PART), "--device", "cpu",
        "--results-dir", str(tmp / "save"),
    ]) == 0
    runs = {
        "pod_ingest": (["pod-ingest", "--protocol", "fake", "--workers", "1",
                        "--object-size", str(SIZE), "--flight-journal",
                        str(tmp / "journal" / "j.json")], {}),
        "stream": (["stream", "--protocol", "fake", "--validate",
                    "--objects", str(STREAM_OBJECTS), "--workers",
                    str(STREAM_WORKERS), "--object-size", str(SIZE),
                    "--snapshot", str(tmp / "snap" / "s.json")], {}),
        "ckpt_restore": (["ckpt-restore", "--protocol", "local", "--dir",
                          ckpt_dir], {}),
        "cards_differ": (["pod-ingest", "--protocol", "fake",
                          "--object-size", str(SIZE)],
                         {"cards": (2, 3), "split": True}),
        "same_id": (["pod-ingest", "--protocol", "fake",
                     "--object-size", str(SIZE)],
                    {"cards": (CARDS,) * 3, "ids": (0, 1, 1),
                     "split": True}),
    }

    def one(name):
        cmd, kw = runs[name]
        results = str(tmp / name)
        return name, (*_pod(cmd, results, **kw), results)

    with ThreadPoolExecutor(len(runs)) as ex:
        return dict(ex.map(one, runs))


def _four_chips(monkeypatch, *modules):
    import jax
    from tpubench.dist import reassemble

    real = reassemble.make_mesh

    def four(devices=None, axis="pod"):
        return real(jax.devices()[:RANKS] if devices is None else devices,
                    axis)

    for mod in (reassemble, *modules):
        monkeypatch.setattr(mod, "make_mesh", four)


def _ref_cfg(**workload):
    from tpubench.config import BenchConfig

    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    for k, v in workload.items():
        setattr(cfg.workload, k, v)
    return cfg


def _check_pod(results: str) -> dict:
    """The pod's one result, and what every pod command shares: the
    stamp, the ranks' places and cards."""
    port = _result(results)
    assert port["extra"]["topology"] == {
        "process_index": 0, "process_count": HOSTS,
        "local_devices": CARDS, "global_devices": RANKS}
    lines = sorted(_rank_lines(results), key=lambda x: x["rank"])
    assert [(x["rank"], x["host"]) for x in lines] == [
        (r, r // CARDS) for r in range(RANKS)]
    assert all(x["ranks"] == RANKS and x["hosts"] == HOSTS
               and x["backend"] == "gloo" and x["n_chips"] == RANKS
               and x["errors"] == 0 for x in lines)
    return port


def test_pod_ingest_on_2_hosts_matches_4_chips(pods, jax_cpu_devices,
                                               monkeypatch, tmp_path):
    from tpubench.workloads import pod_ingest as ref_pod

    rcs, _, results = pods["pod_ingest"]
    assert rcs == [0, 0]
    port = _check_pod(results)
    _four_chips(monkeypatch, ref_pod)
    ref = ref_pod.run_pod_ingest(_ref_cfg(workers=1, object_size=SIZE))
    ref = ref.to_dict()
    assert port["n_chips"] == ref["n_chips"] == RANKS
    assert port["errors"] == ref["errors"] == 0
    assert port["bytes_total"] == ref["bytes_total"] == SIZE
    for key in ("verified", "shard_bytes", "ici_bytes_moved",
                "holes_global", "object_size"):
        assert port["extra"][key] == ref["extra"][key], key
    assert port["extra"]["verified"] is True
    # One journal a rank, named by its global rank: 4 shard records.
    journal = os.path.join(os.path.dirname(results), "journal", "j.json")
    paths = [journal] + [f"{journal}.p{r}" for r in range(1, RANKS)]
    reads = 0
    for path in paths:
        with open(path) as f:
            reads += sum(1 for x in json.load(f)["records"]
                         if x["kind"] == "read")
    assert reads == RANKS
    assert sorted(glob.glob(journal + "*")) == sorted(paths)


def test_stream_validate_on_2_hosts_matches_4_chips(pods, jax_cpu_devices,
                                                    monkeypatch):
    from tpubench.workloads import pod_ingest_stream as ref_stream

    rcs, _, results = pods["stream"]
    assert rcs == [0, 0]
    port = _check_pod(results)
    _four_chips(monkeypatch, ref_stream)
    ref = ref_stream.run_pod_ingest_stream(
        _ref_cfg(workers=STREAM_WORKERS, object_size=SIZE),
        n_objects=STREAM_OBJECTS, verify=True).to_dict()
    store = FakeBackend.prepopulated(PREFIX, STREAM_WORKERS, SIZE)
    want = [int(store._objects[f"{PREFIX}{k % STREAM_WORKERS}"].sum(
        dtype=np.uint64)) % MOD for k in range(STREAM_OBJECTS)]
    assert ref["extra"]["object_checksums"] == want
    assert port["n_chips"] == ref["n_chips"] == RANKS
    assert port["bytes_total"] == ref["bytes_total"] == STREAM_OBJECTS * SIZE
    for key in ("object_checksums", "verified", "objects",
                "objects_this_run", "holes_by_object"):
        assert port["extra"][key] == ref["extra"][key], key
    assert port["extra"]["verified"] is True
    snap = os.path.join(os.path.dirname(results), "snap", "s.json")
    assert sorted(glob.glob(snap + "*")) == sorted(
        [snap] + [f"{snap}.p{r}" for r in range(1, RANKS)])


def test_ckpt_restore_on_2_hosts_matches_4_chips(pods, jax_cpu_devices,
                                                 monkeypatch):
    from tpubench.config import BenchConfig
    from tpubench.workloads import ckpt as ref_ckpt

    rcs, _, results = pods["ckpt_restore"]
    assert rcs == [0, 0]
    port = _check_pod(results)
    _four_chips(monkeypatch)
    cfg = BenchConfig()
    cfg.transport.protocol = "local"
    cfg.workload.dir = os.path.join(os.path.dirname(results), "ckpt")
    ref = ref_ckpt.run_ckpt_restore(cfg).to_dict()
    pl, rl = port["extra"]["lifecycle"], ref["extra"]["lifecycle"]
    assert port["n_chips"] == ref["n_chips"] == RANKS
    assert pl["shards_per_object"] == rl["shards_per_object"] == RANKS
    for key in ("verified", "objects", "bytes", "staged", "op"):
        assert pl[key] == rl[key], key
    assert pl["verified"] is True and pl["bytes"] == CKPT_OBJECTS * CKPT_BYTES


# ------------------------------------------------------------ refusals --
@pytest.mark.parametrize("case,message", [
    ("cards_differ", "the hosts see different card counts"),
    ("same_id", "two hosts claim --process-id 1"),
])
def test_a_mismatched_pod_is_refused_on_every_host(pods, case, message):
    """Every host's launch fails fast, each with the refusal in a rank's
    log (the launcher ends a host's other ranks at its first failure),
    and no result is written."""
    rcs, seconds, results = pods[case]
    assert all(rc != 0 for rc in rcs)
    assert seconds < REFUSAL_S
    for h in range(len(rcs)):
        logs = _logs(os.path.join(results, f"h{h}"))
        refused = [t for t in logs.values() if message in t]
        assert refused, logs
        if case == "cards_differ":  # each host named with its count
            assert all("host 0 (" in t and "2 card(s)" in t
                       and "host 1 (" in t and "3 card(s)" in t
                       for t in refused)
    assert not glob.glob(os.path.join(results, "**", "*.json"),
                         recursive=True)


def test_a_second_host_0_cannot_serve_the_store():
    """Rank 0 never joins a store it did not start: with the port taken
    (by another host 0, another pod), it is refused at once, naming the
    address, and posts nothing there."""
    import datetime

    import torch.distributed as dist

    port = bringup.free_port()
    other = dist.TCPStore("127.0.0.1", port, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=5))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match=rf"cannot serve the rendezvous at 127\.0\.0\.1:"
                             rf"{port}.*another host also --process-id 0"):
        bringup.rendezvous(launch.Member(0, RANKS, CARDS,
                                         f"127.0.0.1:{port}"), 5.0)
    assert time.monotonic() - t0 < 5.0
    assert not other.check([bringup._HOSTS_KEY])


def _one_card(rank: int, world: int, port: int, out_q) -> None:
    """A rank whose card is the same one as every other rank's: the
    shared-card check (NCCL's, run here over a gloo group)."""
    try:
        bringup.card_key = lambda device: "NVIDIA H100 GPU-0000-test"
        bringup.initialize(
            DistConfig(num_processes=world, process_id=rank,
                       coordinator_address=f"127.0.0.1:{port}"),
            device="cpu", timeout_s=30)
        try:
            bringup.refuse_shared_cards(bringup.card_key("cuda"))
        finally:
            bringup.dist.destroy_process_group()
        out_q.put((rank, "joined"))
    except RuntimeError as e:
        out_q.put((rank, str(e)))


def test_two_ranks_on_one_card_are_refused():
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = bringup.free_port()
    procs = [ctx.Process(target=_one_card, args=(r, 2, port, out_q),
                         daemon=True) for r in range(2)]
    t0 = time.monotonic()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < 2:
            rank, msg = out_q.get(timeout=max(0.1, 60 - (time.monotonic() - t0)))
            got[rank] = msg
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert sorted(got) == [0, 1]
    for msg in got.values():
        assert "ranks [0, 1]" in msg and "GPU-0000-test" in msg, msg
        assert "one rank per GPU" in msg


@pytest.mark.parametrize("flag", [["--coop-host-id", "1"],
                                  ["--coop-hosts", "2"]])
def test_an_explicit_coop_id_is_refused_under_a_launch(flag, monkeypatch):
    def no_launch(*a, **k):
        raise AssertionError("launched")

    monkeypatch.setattr(cli, "local_ranks", lambda *a: CARDS)
    monkeypatch.setattr(launch, "launch", no_launch)
    with pytest.raises(SystemExit, match="--coop-hosts/--coop-host-id"):
        cli.main(["train-ingest", "--pipeline-pod", "--coop", *flag,
                  "--protocol", "fake"])


def test_the_default_coop_ring_is_every_rank(monkeypatch):
    """A launched rank's ring id is its global rank, its ring the world
    (host 1 of 2 hosts of 2 ranks: rank 3 of 4)."""
    from tpubench_torch.pipeline.cache import ChunkCache
    from tpubench_torch.pipeline.coop import (
        LoopbackBroker,
        LoopbackChannel,
        coop_from_config,
    )

    for k, v in launch.rank_env(launch.Member(3, 4, 2, "h:1")).items():
        monkeypatch.setenv(k, v)
    cfg = cli.build_config(cli.build_parser().parse_args(
        ["train-ingest", "--coop", "--num-processes", "2",
         "--process-id", "1", "--coordinator", "h:1"]))
    coop = coop_from_config(cfg, ChunkCache(1 << 20), lambda key: b"",
                            channel=LoopbackChannel(LoopbackBroker(), 3))
    try:
        assert coop.host_id == 3
        assert coop.ring.hosts == {0, 1, 2, 3}
    finally:
        coop.close()


def test_a_launched_rank_takes_its_place_from_the_launcher(monkeypatch):
    """The host's argv and environment say host 1 of 2; the launcher says
    global rank 3 of 4 on local rank 1: the rank is 3, not 1."""
    from tpubench_torch.dist.launch import member

    monkeypatch.setenv("TPUBENCH_PROCESS_ID", "0")
    monkeypatch.setenv("TPUBENCH_NUM_PROCESSES", "2")
    for k, v in launch.rank_env(
            launch.Member(3, 4, 2, "10.0.0.1:29500")).items():
        monkeypatch.setenv(k, v)
    cfg = cli.build_config(cli.build_parser().parse_args(
        ["pod-ingest", "--num-processes", "2", "--process-id", "1",
         "--coordinator", "10.0.0.1:29500"]))
    assert (cfg.dist.num_processes, cfg.dist.process_id) == (2, 1)
    m = member(cfg.dist)
    assert (m.rank, m.world, m.local_rank, m.host, m.hosts) == (3, 4, 1, 1, 2)
    assert m.address == "10.0.0.1:29500"
    # ... and a launched rank launches nothing of its own.
    assert cli.local_ranks("pod-ingest", cfg, None, "cuda") == 1


def test_a_host_that_never_arrives_is_named_at_the_deadline():
    """Host 0 of 2 alone at its own store: the wait ends at the deadline
    with the count of hosts that came, not in a hang."""
    m = launch.Member(0, 4, 2, f"127.0.0.1:{bringup.free_port()}")
    store = bringup.rendezvous(m, timeout_s=5.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"1 of 2 host\(s\) reached"):
        bringup.check_hosts(store, m, timeout_s=0.5)
    assert time.monotonic() - t0 < 5.0


def test_each_rank_labels_its_series_with_its_global_rank(monkeypatch):
    """The cloud exporter's and telemetry's ``process`` label is the
    global rank: the 4 ranks of 2 hosts push 4 distinct series (the
    host's ``--process-id`` alone would give 2 ranks one series)."""
    from tpubench_torch.obs.exporters import cloud_exporter_from_config
    from tpubench_torch.obs.telemetry import telemetry_from_config

    labels = []
    for h in range(HOSTS):
        argv = ["pod-ingest", "--export", "cloud", "--telemetry-otlp",
                "--num-processes", str(HOSTS), "--process-id", str(h),
                "--coordinator", "10.0.0.1:29500"]
        cfg = cli.build_config(cli.build_parser().parse_args(argv))
        for m in launch.members(CARDS, cfg.dist):
            for k, v in launch.rank_env(m).items():
                monkeypatch.setenv(k, v)
            exporter = cloud_exporter_from_config(cfg)
            telemetry = telemetry_from_config(cfg)
            labels.append((exporter.base_labels["process"],
                           telemetry.resource["process"]))
    assert labels == [(str(r), str(r)) for r in range(RANKS)]
