"""One pod command, every card of the host: ``dist/launch.py`` and the
CLI's choice to launch.

On a host of several cards ``cli.main`` runs a pod command as one rank
process a card, as ``tpubench``'s one process meshes every local chip.
Here, without a card, ``launch.launch(argv, ranks=4)`` plays the part of
``--xla_force_host_platform_device_count`` (``tests/conftest.py``): four
gloo ranks of ``python -m tpubench_torch.cli <argv> --device cpu``, whose
rank 0 result is held against ``tpubench``'s run of the same config on a
4-device JAX CPU mesh (``make_mesh(jax.devices()[:4])``):

* ``pod-ingest``: ``n_chips``, ``verified`` (at several ranks: every
  rank's shard at its offset and the pod's device checksum equal to the
  pod's host sum), the bytes, ``shard_bytes``, ``ici_bytes_moved``, the
  holes, and the flight journals' shard and pod records (the ranks'
  shard records together are the reference's; each process has one pod
  record);
* ``stream --validate``: ``n_chips``, ``verified`` and every object's
  device checksum (the mod-2³² sum of its gathered bytes), exactly;
* ``ckpt-restore`` of a checkpoint the port saved: ``n_chips``,
  ``shards_per_object`` 4, ``verified`` (the ranks' crc32s combined in
  rank order), the bytes, ``staged``;
* a ``pod-ingest`` whose rank 2 cannot fetch its shard (the server
  refuses that range): the command exits nonzero long before its
  deadline, the other ranks, waiting in the gather, are ended, and no
  process is left.

The four launches run at once (one group each, 16 processes).
``main``'s choice is tested with ``torch.cuda`` patched to 4 cards; it
spawns nothing.
"""

from __future__ import annotations

import glob
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tpubench_torch import cli
from tpubench_torch.dist import launch
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.storage.base import StorageError
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_server import FakeGcsServer

RANKS = 4
SIZE = 100_003  # uneven: padding and trim
STREAM_OBJECTS, STREAM_WORKERS = 3, 3
CKPT_OBJECTS, CKPT_BYTES, CKPT_PART = 3, 200_003, 65_536
PREFIX = "tpubench/file_"
DEADLINE_S = 120.0
FAILED_RANK = 2
MOD = 1 << 32


class RefuseRange(FakeBackend):
    """A fake store whose ranged read starting at ``fail_start`` is
    refused (403: not retried), so one rank's shard fetch fails."""

    fail_start = -1

    def open_read(self, name, start=0, length=None):
        if start == self.fail_start:
            raise StorageError("injected: shard refused", code=403)
        return super().open_read(name, start=start, length=length)


def _cpu(cmd: list, results: str) -> list:
    return [*cmd, "--device", "cpu", "--results-dir", results]


def _result(results: str) -> dict:
    """Rank 0's result: the one result file of the command."""
    paths = glob.glob(os.path.join(results, "*.json"))
    assert len(paths) == 1, paths
    with open(paths[0]) as f:
        return json.load(f)


def _rank_lines(results: str) -> list:
    """Every rank's ``local_rank`` line, from the rank logs."""
    (log_dir,) = glob.glob(os.path.join(results, launch.RANK_LOG_DIR, "*"))
    lines = []
    for r in range(RANKS):
        with open(os.path.join(log_dir, f"rank{r}.log")) as f:
            lines += [json.loads(ln)["local_rank"] for ln in f
                      if ln.startswith('{"local_rank"')]
    return lines


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The four launches, at once; each one's exit code, seconds and
    (for the failing one) what ``run_ranks`` saw."""
    tmp = tmp_path_factory.mktemp("launch")
    ckpt_dir = str(tmp / "ckpt")
    assert cli.main([
        "ckpt-save", "--protocol", "local", "--dir", ckpt_dir,
        "--ckpt-objects", str(CKPT_OBJECTS),
        "--ckpt-object-bytes", str(CKPT_BYTES),
        "--ckpt-part-bytes", str(CKPT_PART), "--device", "cpu",
        "--results-dir", str(tmp / "save"),
    ]) == 0
    store = RefuseRange.prepopulated(PREFIX, 1, SIZE)
    store.fail_start = ShardTable.build(SIZE, RANKS, align=128).shard(
        FAILED_RANK).start
    server = FakeGcsServer(backend=store).start()
    conf = tmp / "no_retry.json"  # the default policy retries a 403 forever
    conf.write_text(json.dumps({"transport": {"retry": {"policy": "never"}}}))
    runs = {
        "pod_ingest": ["pod-ingest", "--protocol", "fake", "--workers", "1",
                       "--object-size", str(SIZE), "--flight-journal",
                       str(tmp / "journal" / "j.json")],
        "stream": ["stream", "--protocol", "fake", "--validate",
                   "--objects", str(STREAM_OBJECTS), "--workers",
                   str(STREAM_WORKERS), "--object-size", str(SIZE)],
        "ckpt_restore": ["ckpt-restore", "--protocol", "local", "--dir",
                         ckpt_dir],
        "failing": ["pod-ingest", "--config", str(conf),
                    "--protocol", "http", "--endpoint",
                    server.endpoint, "--bucket", "testbucket",
                    "--object-name-prefix", PREFIX],
    }
    seen = []
    real = launch.run_ranks

    def kept(*a, **kw):
        res = real(*a, **kw)
        seen.append(res)
        return res

    def one(name):
        results = str(tmp / name)
        t0 = time.monotonic()
        rc = launch.launch(_cpu(runs[name], results), RANKS,
                           results_dir=results, deadline_s=DEADLINE_S)
        return name, (rc, time.monotonic() - t0, results)

    launch.run_ranks = kept
    try:
        with ThreadPoolExecutor(len(runs)) as ex:
            out = dict(ex.map(one, runs))
    finally:
        launch.run_ranks = real
        server.stop()
    out["failing_ranks"] = next(r for r in seen if r.rcs[FAILED_RANK] != 0)
    return out


def _four_chips(monkeypatch, *modules):
    """``make_mesh`` of ``tpubench`` over the first 4 simulated devices,
    wherever ``modules`` took it from."""
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


def _records(path: str) -> list:
    with open(path) as f:
        return json.load(f)["records"]


def test_pod_ingest_at_4_ranks_matches_4_chips(launched, jax_cpu_devices,
                                               monkeypatch, tmp_path):
    from tpubench.workloads import pod_ingest as ref_pod

    rc, _, results = launched["pod_ingest"]
    assert rc == 0
    port = _result(results)
    _four_chips(monkeypatch, ref_pod)
    cfg = _ref_cfg(workers=1, object_size=SIZE)
    cfg.obs.flight_journal = str(tmp_path / "ref.json")
    ref = ref_pod.run_pod_ingest(cfg).to_dict()
    assert port["n_chips"] == ref["n_chips"] == RANKS
    assert port["errors"] == ref["errors"] == 0
    assert port["bytes_total"] == ref["bytes_total"] == SIZE
    for key in ("verified", "shard_bytes", "ici_bytes_moved",
                "holes_global", "object_size"):
        assert port["extra"][key] == ref["extra"][key], key
    assert port["extra"]["verified"] is True
    # One host of 4 ranks is one process of 4 chips in tpubench: a single
    # host stamps no topology.
    assert "topology" not in port["extra"]
    # Flight: the reference's journal has 4 shard records and its pod
    # record; rank r's journal (j.json, j.json.p<r>) its shard's and one
    # pod record of its own.
    ref_recs = _records(cfg.obs.flight_journal)
    journal = os.path.join(os.path.dirname(results), "journal", "j.json")
    ranks = [_records(journal if r == 0 else f"{journal}.p{r}")
             for r in range(RANKS)]

    def count(recs, kind):
        return sum(1 for x in recs if x["kind"] == kind)

    assert sum(count(recs, "read") for recs in ranks) == count(
        ref_recs, "read") == RANKS
    assert [count(recs, "object") for recs in ranks] == [
        count(ref_recs, "object")] * RANKS
    lines = _rank_lines(results)
    assert sorted(x["rank"] for x in lines) == list(range(RANKS))
    assert all(x["backend"] == "gloo" and x["n_chips"] == RANKS
               and x["errors"] == 0 for x in lines)


def test_stream_validate_at_4_ranks_matches_4_chips(launched, jax_cpu_devices,
                                                    monkeypatch):
    from tpubench.workloads import pod_ingest_stream as ref_stream

    rc, _, results = launched["stream"]
    assert rc == 0
    port = _result(results)
    _four_chips(monkeypatch, ref_stream)
    ref = ref_stream.run_pod_ingest_stream(
        _ref_cfg(workers=STREAM_WORKERS, object_size=SIZE),
        n_objects=STREAM_OBJECTS, verify=True).to_dict()
    # The mod-2^32 sum of each object's gathered bytes, on the host.
    store = FakeBackend.prepopulated(PREFIX, STREAM_WORKERS, SIZE)
    want = [int(store._objects[f"{PREFIX}{k % STREAM_WORKERS}"].sum(
        dtype=np.uint64)) % MOD for k in range(STREAM_OBJECTS)]
    assert ref["extra"]["object_checksums"] == want
    assert port["n_chips"] == ref["n_chips"] == RANKS
    assert port["errors"] == ref["errors"] == 0
    assert port["bytes_total"] == ref["bytes_total"] == STREAM_OBJECTS * SIZE
    for key in ("object_checksums", "verified", "objects",
                "objects_this_run", "holes_by_object"):
        assert port["extra"][key] == ref["extra"][key], key
    assert port["extra"]["verified"] is True


def test_ckpt_restore_at_4_ranks_matches_4_chips(launched, jax_cpu_devices,
                                                 monkeypatch, tmp_path):
    from tpubench.config import BenchConfig
    from tpubench.workloads import ckpt as ref_ckpt

    rc, _, results = launched["ckpt_restore"]
    assert rc == 0
    port = _result(results)
    _four_chips(monkeypatch)
    cfg = BenchConfig()
    cfg.transport.protocol = "local"
    cfg.workload.dir = os.path.join(os.path.dirname(results), "ckpt")
    ref = ref_ckpt.run_ckpt_restore(cfg).to_dict()
    pl, rl = port["extra"]["lifecycle"], ref["extra"]["lifecycle"]
    assert port["n_chips"] == ref["n_chips"] == RANKS
    assert port["errors"] == ref["errors"] == 0
    assert pl["shards_per_object"] == rl["shards_per_object"] == RANKS
    for key in ("verified", "objects", "bytes", "staged", "op"):
        assert pl[key] == rl[key], key
    assert pl["verified"] is True and pl["bytes"] == CKPT_OBJECTS * CKPT_BYTES
    assert port["bytes_total"] == ref["bytes_total"]


def test_a_failing_rank_fails_the_command_and_ends_the_others(launched):
    rc, seconds, results = launched["failing"]
    ranks = launched["failing_ranks"]
    assert rc != 0 and ranks.first_failed == FAILED_RANK
    assert not ranks.timed_out and seconds < DEADLINE_S / 2
    # Ranks 0, 1 and 3 waited in the gather for rank 2: ended, not done.
    assert all(ranks.rcs[r] != 0 for r in range(RANKS))
    assert not _live_in_groups(ranks.pids)
    with open(ranks.logs[FAILED_RANK]) as f:
        assert "shard refused" in f.read()
    assert not glob.glob(os.path.join(results, "*.json"))


# ------------------------------------------------------- main's choice --
DECISIONS = {
    "pod_ingest": (["pod-ingest"], 4, RANKS),
    "stream": (["stream", "--validate"], 4, RANKS),
    "gather_bench": (["gather-bench"], 4, RANKS),
    "ckpt_restore": (["ckpt-restore"], 4, RANKS),
    "train_pod": (["train-ingest", "--pipeline-pod"], 4, RANKS),
    "tune_train_pod": (["tune", "--tune-workload", "train-ingest",
                        "--pipeline-pod"], 4, RANKS),
    "chaos_pod": (["chaos", "--chaos-workload", "pod-ingest"], 4, RANKS),
    "read": (["read"], 4, 1),
    "train_per_host": (["train-ingest"], 4, 1),
    "restore_to_host": (["ckpt-restore", "--no-restore-device"], 4, 1),
    "num_processes": (["pod-ingest", "--num-processes", "2",
                       "--process-id", "0", "--coordinator",
                       "127.0.0.1:1"], 4, RANKS),
    "one_card": (["pod-ingest"], 1, 1),
    "device_free": (["serve"], 4, 1),
    "cpu": (["pod-ingest", "--device", "cpu"], 4, 1),
}


def _cards(monkeypatch, n: int) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


@pytest.mark.parametrize("case", sorted(DECISIONS))
def test_local_ranks_decision(case, monkeypatch):
    argv, cards, want = DECISIONS[case]
    _cards(monkeypatch, cards)
    args = cli.build_parser().parse_args(argv)
    cfg = cli.build_config(args)
    assert cli.local_ranks(args.cmd, cfg, args, args.device) == want


@pytest.mark.parametrize("cmd,launches", [("pod-ingest", True),
                                          ("read", False)])
def test_main_launches_a_rank_a_card_or_runs_in_process(cmd, launches,
                                                        monkeypatch,
                                                        tmp_path):
    """On 4 cards ``main`` hands a pod command to the launcher with the
    user's argv and 4 ranks; ``read`` runs in this process (its workers
    spread over the cards). Neither spawns anything here."""
    _cards(monkeypatch, 4)
    called = {}

    def fake_launch(argv, ranks, results_dir="results", deadline_s=None,
                    pod=None):
        called["launch"] = (list(argv), ranks, results_dir)
        assert pod.num_processes == 1
        return 0

    def fake_execute(c, cfg, device="cuda", backend=None, args=None):
        called["execute"] = c
        return "res"

    monkeypatch.setattr(launch, "launch", fake_launch)
    monkeypatch.setattr(cli, "execute", fake_execute)
    monkeypatch.setattr(cli, "finish", lambda *a, **k: None)
    argv = [cmd, "--protocol", "fake", "--results-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    if launches:
        assert called == {"launch": (argv, RANKS, str(tmp_path))}
    else:
        assert called == {"execute": cmd}


# ------------------------------------------------------------ run_ranks --
_SLEEPER = ("import subprocess, sys, time; "
            "subprocess.Popen([sys.executable, '-c', 'import time; "
            "time.sleep(600)']); time.sleep(600)")


@pytest.mark.parametrize("case", ["one_fails", "deadline"])
def test_run_ranks_ends_every_rank_and_what_it_started(case, tmp_path):
    """Ranks that would wait for ever (each with a child of its own) are
    killed, session and all, when another rank fails or the deadline
    passes; the exit code is the failed rank's, or 124."""
    import sys

    sleep = [sys.executable, "-c", _SLEEPER]
    fail = [sys.executable, "-c", "import sys; sys.exit(3)"]
    cmds = [sleep, sleep, fail if case == "one_fails" else sleep]
    t0 = time.monotonic()
    res = launch.run_ranks(cmds, [str(tmp_path / f"r{r}.log") for r in
                                  range(3)], deadline_s=3.0)
    assert time.monotonic() - t0 < 30
    if case == "one_fails":
        assert res.first_failed == 2 and not res.timed_out
        assert res.rcs == [-9, -9, 3] and res.exit_code() == 3
    else:
        assert res.timed_out and res.first_failed is None
        assert res.rcs == [-9] * 3 and res.exit_code() == 124
    # No process of any rank's session is left running (a killed
    # grandchild may stay a zombie until init reaps it).
    assert not [p for p in _live_in_groups(res.pids)]


def _live_in_groups(pgids) -> list:
    """Pids of processes, zombies aside, in the process groups
    ``pgids``."""
    live = []
    for d in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(d) as f:
                stat = f.read()
        except OSError:
            continue
        state, _ppid, pgrp = stat.rsplit(")", 1)[1].split()[:3]
        if int(pgrp) in pgids and state != "Z":
            live.append(int(d.split("/")[2]))
    return live


# ------------------------------------------- one hermetic server a pod --
def _shared_server(rank: int, world: int) -> dict:
    """A restore's hermetic target on each rank of a pod: the servers
    started here, and the endpoint each rank was given."""
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.workloads import chaos

    started = []
    real = chaos.spawn_hermetic_server

    def counted(cfg, **kw):
        started.append(rank)
        return real(cfg, **kw)

    chaos.spawn_hermetic_server = counted
    cfg = BenchConfig()
    cfg.transport.protocol = "http"
    with chaos.hermetic_target(cfg, shared=True) as server:
        endpoint = cfg.transport.endpoint
        up = server is not None
    return {"started": started, "endpoint": endpoint, "server": up,
            "restored": cfg.transport.endpoint}


def test_a_pod_shares_one_hermetic_server():
    """``tpubench`` has one server for its chips: rank 0 starts the
    pod's, every rank reads from it, and it stops after all are done."""
    from test_torch_dist import run_ranks

    ranks = run_ranks(_shared_server, 2, timeout=60)
    assert [r["started"] for r in ranks] == [[0], []]
    assert [r["server"] for r in ranks] == [True, False]
    assert ranks[0]["endpoint"] == ranks[1]["endpoint"] != ""
    assert all(r["restored"] == "" for r in ranks)
