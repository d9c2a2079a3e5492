"""The port's dist plane against ``tpubench/dist`` on seeded inputs.

The reference runs one process over n simulated JAX CPU devices; the port
runs n ranks of a gloo group, one device (the CPU) each — the known
difference between the two. One group of ``WORLD`` ranks is spawned for
the module (:func:`run_ranks`, every process joined or killed under a
hard timeout of its own) and runs every scenario; the results come back
to the test process and are compared with the reference's, exactly
(bytes and integer sums: tolerance 0).

* ``ShardTable`` cases (``tests/test_dist.py``) on both packages;
* reassembly at n = 2 and 4: all-gather, ring, reduce-scatter and psum
  give the bytes and checksum of ``make_reassemble(make_mesh(
  jax.devices()[:n]))`` and its siblings;
* ``gather-bench`` rows at n = 2 and 4 (devices, shard bytes, bytes
  moved), and ``single_device`` at world size 1;
* ``read`` on several processes: every process writes its own result,
  tagged ``p<idx>``;
* the one-rank-per-GPU check, over gloo.

The JAX package is imported inside the tests: the ranks import this
module, and need only torch.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import queue
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, DistConfig
from tpubench_torch.dist import bringup, reassemble
from tpubench_torch.dist.shard import ShardTable, worker_object_index

WORLD = 4
LANE = 128
ROWS = 64  # divides by every swept pod size (reduce-scatter splits rows)
SEED = 7
SHARD_MB = 0.25  # 262,144 B: a multiple of LANE x 8, rounded alike at 4 and 8


# ----------------------------------------------------------- the ranks ----
def _rank_entry(target, rank, world, port, out_q, args, pg_timeout_s=None):
    result = None
    try:
        bringup.initialize(
            DistConfig(num_processes=world, process_id=rank,
                       coordinator_address=f"127.0.0.1:{port}"),
            device="cpu", timeout_s=pg_timeout_s,
        )
        result = ("ok", target(rank, world, *args))
    except BaseException:  # noqa: BLE001 — reported to the test process
        result = ("err", traceback.format_exc())
    finally:
        out_q.put((rank, result))
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_ranks(target, world: int, *args, timeout: float = 90.0,
              pg_timeout_s=None) -> list:
    """``target(rank, world, *args)`` on each rank of a fresh ``world``-rank
    gloo group on the loopback interface; the per-rank results, in rank
    order. Every process is joined, or killed, before this returns.
    ``pg_timeout_s`` bounds the group's rendezvous and collectives (a
    collective whose ranks lost step then fails in each rank)."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = bringup.free_port()
    procs = [
        ctx.Process(target=_rank_entry, daemon=True,
                    args=(target, rank, world, port, out_q, args,
                          pg_timeout_s))
        for rank in range(world)
    ]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = {}
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, res = out_q.get(timeout=left)
            except queue.Empty:
                break
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=max(0.5, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(5)
    missing = sorted(set(range(world)) - set(results))
    assert not missing, f"ranks {missing} did not report within {timeout} s"
    errors = {r: res[1] for r, res in results.items() if res[0] != "ok"}
    assert not errors, "\n".join(f"rank {r}:\n{tb}" for r, tb in errors.items())
    return [results[r][1] for r in range(world)]


def _shards(n: int) -> list:
    rng = np.random.default_rng(SEED + n)
    return [rng.integers(0, 256, ROWS * LANE, dtype=np.uint8) for _ in range(n)]


def _scenarios(rank: int, world: int, tmp: str) -> dict:
    out = {"reassembly": {}}
    for n in (2, 4):
        pod = reassemble.make_mesh(range(n), device="cpu")
        if pod is None:
            continue
        host = torch.from_numpy(_shards(n)[pod.rank])
        staged = reassemble.shard_to_device_array([host], pod, lane=LANE)
        gathered, csum = reassemble.make_reassemble(pod)(staged)
        ring, ring_csum = reassemble.make_ring_reassemble(pod)(staged)
        out["reassembly"][n] = {
            "gather": gathered.numpy(), "csum": int(csum),
            "ring": ring.numpy(), "ring_csum": int(ring_csum),
            "reduce_scatter": reassemble.make_reduce_scatter(pod)(staged).numpy(),
            "psum": reassemble.make_allreduce(pod)(staged).numpy(),
            "bytes": reassemble.gathered_to_bytes(gathered, n * ROWS * LANE - 5),
        }
    cfg = BenchConfig()
    out["gather_bench"] = {}
    from tpubench_torch.workloads.gather_bench import run_gather_bench

    for mode in ("all_gather", "ring", "reduce_scatter", "psum"):
        res = run_gather_bench(cfg, shard_mb=SHARD_MB, reps=1,
                               collective=mode, device="cpu")
        out["gather_bench"][mode] = res.to_dict()
    # `read` on every process through the CLI: one result each, tagged.
    argv = ["read", "--protocol", "fake", "--workers", "1",
            "--read-call-per-worker", "1", "--object-size", "70001",
            "--device", "cpu", "--results-dir", tmp,
            "--num-processes", str(world), "--process-id", str(rank),
            "--coordinator", "127.0.0.1:1"]
    assert cli.main(argv) == 0
    out["shared_gpus"] = bringup.shared_gpus(rank % 2)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return run_ranks(_scenarios, WORLD, str(tmp)), tmp


# ------------------------------------------------------------ shard math ----
def _packages():
    import tpubench.dist.shard as jax_shard
    import tpubench_torch.dist.shard as port_shard

    return jax_shard, port_shard


def _table_cases(mod) -> list:
    t = mod.ShardTable
    rows = []
    for size, n in ((1024, 8), (1000, 8), (100, 8), (100_000, 8), (777_777, 3)):
        tab = t.build(size, n, align=128)
        rows.append((tab.shard_bytes, tab.padded_size,
                     [(s.index, s.start, s.length, s.padded_length)
                      for s in tab.shards()]))
    rows.append([s.index for s in t.build(8 * 128, 8, align=128).chip_shards(1, 4)])
    rows.append((mod.worker_object_index(0, 3, 8), mod.worker_object_index(2, 1, 8)))
    return rows


def test_shard_tables_match_reference():
    jax_shard, port_shard = _packages()
    assert _table_cases(port_shard) == _table_cases(jax_shard)
    t = ShardTable.build(1000, 8, align=128)
    assert t.shard_bytes == 128 and t.shard(7).length == 1000 - 7 * 128
    assert worker_object_index(2, 1, 8) == 17


@pytest.mark.parametrize("size, n, exc, i", [
    (0, 8, ValueError, None), (100, 0, ValueError, None),
    (100, 2, IndexError, 5), (100, 2, IndexError, -1),
])
def test_shard_table_validation_matches_reference(size, n, exc, i):
    for mod in _packages():
        with pytest.raises(exc):
            mod.ShardTable.build(size, n).shard(0 if i is None else i)


# ----------------------------------------------------------- reassembly ----
def _reference(n: int) -> dict:
    import jax
    from tpubench.dist.reassemble import (
        gathered_to_bytes,
        make_allreduce,
        make_mesh,
        make_reassemble,
        make_reduce_scatter,
        make_ring_reassemble,
        shard_to_device_array,
    )

    mesh = make_mesh(jax.devices()[:n])
    arr = shard_to_device_array(_shards(n), mesh)
    g, c = make_reassemble(mesh)(arr)
    gr, cr = make_ring_reassemble(mesh)(arr)
    return {
        "gather": np.asarray(g), "csum": int(c),
        "ring": np.asarray(gr), "ring_csum": int(cr),
        "reduce_scatter": np.asarray(make_reduce_scatter(mesh)(arr)),
        "psum": np.asarray(make_allreduce(mesh)(arr)),
        "bytes": gathered_to_bytes(g, n * ROWS * LANE - 5),
    }


@pytest.mark.parametrize("n", [2, 4])
def test_reassembly_matches_reference(n, ranks, jax_cpu_devices):
    per_rank = [r["reassembly"][n] for r in ranks[0][:n]]
    ref = _reference(n)
    for got in per_rank:  # replicated outputs: the same on every rank
        for key in ("gather", "ring"):
            assert np.array_equal(got[key], ref[key]), key
        assert got["csum"] == got["ring_csum"] == ref["csum"] == ref["ring_csum"]
        assert got["bytes"] == ref["bytes"]
        assert np.array_equal(got["psum"][0], ref["psum"][0])
    # Row-split outputs: rank i holds the reference's i-th block.
    for key in ("reduce_scatter", "psum"):
        stacked = np.concatenate([got[key] for got in per_rank])
        assert np.array_equal(stacked, ref[key]), key
    host = sum(int(s.sum(dtype=np.uint64)) for s in _shards(n)) % (1 << 32)
    assert ref["csum"] == host


def test_ranks_outside_a_pod_get_none(ranks):
    assert [sorted(r["reassembly"]) for r in ranks[0]] == [[2, 4]] * 2 + [[4]] * 2


# --------------------------------------------------------- gather-bench ----
ROW_KEYS = ("devices", "shard_bytes", "reps", "ici_bytes_moved")


@pytest.mark.parametrize("mode", ["all_gather", "ring", "reduce_scatter", "psum"])
def test_gather_bench_rows_match_reference(mode, ranks, jax_cpu_devices):
    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.workloads.gather_bench import run_gather_bench as jax_run

    ref = jax_run(JaxBenchConfig(), shard_mb=SHARD_MB, reps=1,
                  collective=mode).to_dict()
    port = ranks[0][0]["gather_bench"][mode]
    ref_rows = [r for r in ref["extra"]["scaling"] if r["devices"] <= WORLD]
    assert [r["devices"] for r in ref_rows] == [2, 4]
    assert ([{k: r[k] for k in ROW_KEYS} for r in port["extra"]["scaling"]]
            == [{k: r[k] for k in ROW_KEYS} for r in ref_rows])
    assert set(port) == set(ref) and set(port["extra"]) == set(ref["extra"])
    assert port["extra"]["mode"] == mode and port["errors"] == 0
    assert port["extra"]["single_device"] is False
    # Ranks 2-3 sit outside the n = 2 pod: one row each.
    outside = ranks[0][3]["gather_bench"][mode]["extra"]["scaling"]
    assert [r["devices"] for r in outside] == [4]


def test_gather_bench_single_device_at_world_size_one(jax_cpu_devices,
                                                      monkeypatch):
    """One rank (a one-rank gloo group ``cli.execute`` brings up and
    tears down): the collective runs, labelled ``single_device``, as the
    reference's run on one device."""
    import jax

    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.workloads import gather_bench as jax_gb

    one = jax.devices()[:1]
    monkeypatch.setattr(jax_gb.jax, "devices", lambda: one)
    for mode in ("all_gather", "psum"):
        ref = jax_gb.run_gather_bench(JaxBenchConfig(), shard_mb=SHARD_MB,
                                      reps=1, collective=mode).to_dict()
        args = cli.build_parser().parse_args([
            "gather-bench", "--shard-mb", str(SHARD_MB), "--reps", "1",
            "--collective", mode])
        port = cli.execute("gather-bench", BenchConfig(), device="cpu",
                           args=args).to_dict()
        assert not torch.distributed.is_initialized()
        assert port["extra"]["single_device"] is ref["extra"]["single_device"] is True
        assert ([{k: r[k] for k in ROW_KEYS} for r in port["extra"]["scaling"]]
                == [{k: r[k] for k in ROW_KEYS} for r in ref["extra"]["scaling"]])
        assert port["bytes_total"] == ref["bytes_total"] == 0


# ----------------------------------------------------------- processes ----
def test_read_on_several_processes_writes_one_result_each(ranks):
    _, tmp = ranks
    files = sorted(p.name for p in Path(tmp).glob("read_*.json"))
    assert [f.split("_")[1] for f in files] == [f"p{i}" for i in range(WORLD)]
    for path in Path(tmp).glob("read_*.json"):
        res = json.loads(path.read_text())
        assert res["errors"] == 0 and res["bytes_total"] == 70_001
        assert res["extra"]["topology"]["process_count"] == WORLD


def test_shared_gpus_are_found_over_gloo(ranks):
    host = os.uname().nodename
    for r in ranks[0]:
        assert [(i, ranks_) for _, i, ranks_ in r["shared_gpus"]] == [
            (0, [0, 2]), (1, [1, 3])]
        assert all(h == host for h, _, _ in r["shared_gpus"])


def test_bringup_refuses_a_partial_pod_config():
    with pytest.raises(ValueError, match="coordinator"):
        bringup.initialize(DistConfig(num_processes=2), device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        bringup.initialize(DistConfig(num_processes=2, process_id=2,
                                      coordinator_address="127.0.0.1:1"),
                           device="cpu")
    with pytest.raises(SystemExit, match="num-processes"):
        cli.build_config(cli.build_parser().parse_args(
            ["read", "--process-id", "1"]))


def test_single_process_read_brings_nothing_up():
    assert bringup.initialize(DistConfig(), device="cpu") == {
        "process_index": 0, "process_count": 1}
    assert not torch.distributed.is_initialized()
    with bringup.session(DistConfig(), "cpu", one_rank_group=True) as topo:
        assert torch.distributed.get_backend() == "gloo"
        assert topo["process_count"] == 1
    assert not torch.distributed.is_initialized()


def test_dist_flags_and_environment(monkeypatch):
    monkeypatch.setenv("TPUBENCH_NUM_PROCESSES", "4")
    monkeypatch.setenv("TPUBENCH_COORDINATOR", "10.0.0.1:1234")
    cfg = cli.build_config(cli.build_parser().parse_args(
        ["pod-ingest", "--process-id", "3"]))
    assert (cfg.dist.num_processes, cfg.dist.process_id,
            cfg.dist.coordinator_address) == (4, 3, "10.0.0.1:1234")
    cfg = cli.build_config(cli.build_parser().parse_args(
        ["gather-bench", "--num-processes", "2", "--coordinator", "h:1"]))
    assert (cfg.dist.num_processes, cfg.dist.coordinator_address) == (2, "h:1")
