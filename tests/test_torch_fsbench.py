"""The filesystem workloads of the port (``tpubench_torch.workloads.
fsbench``, ``prepare`` and the five fs commands) against ``tpubench``'s:
the counterparts of ``tests/test_fsbench.py``, each running one seeded
config through both packages over the same files and comparing bytes,
counts, result keys and the files written, exactly. Latencies are
compared by key only: they measure the run, not its result."""

import os

import numpy as np
import pytest

from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.workloads import fsbench as jax_fs
from tpubench.workloads.common import WorkerError as JaxWorkerError

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.workloads import fsbench
from tpubench_torch.workloads.common import WorkerError

MB = 1024 * 1024


def _configs(tmp_path, threads=2, **workload):
    """The same workload section in both packages' configs."""
    cfgs = []
    for cls in (JaxBenchConfig, BenchConfig):
        cfg = cls()
        w = cfg.workload
        w.dir = str(tmp_path)
        w.threads = threads
        w.block_size_kb = 4
        w.file_size_mb = 1
        for k, v in workload.items():
            setattr(w, k, v)
        cfgs.append(cfg)
    return cfgs


def _same_result(ref, port):
    """Equal counts, bytes and keys; latency blocks by key and count."""
    assert port.workload == ref.workload
    assert port.bytes_total == ref.bytes_total
    assert port.errors == ref.errors
    assert set(port.summaries) == set(ref.summaries)
    for k, s in ref.summaries.items():
        assert port.summaries[k].count == s.count, k
        assert set(port.summaries[k].to_dict()) == set(s.to_dict())
    assert set(port.extra) == set(ref.extra)
    assert set(port.to_dict()) == set(ref.to_dict())


def _ssd_files(root, n=2, size=MB):
    for i in range(n):
        d = root / f"Workload.{i}"
        d.mkdir(exist_ok=True)
        (d / "0").write_bytes(deterministic_bytes(f"ssd/{i}", size).tobytes())


def test_read_fs(tmp_path):
    ref_cfg, cfg = _configs(tmp_path, read_count=3)
    fsbench.prepare_files(str(tmp_path), 2, MB)
    ref = jax_fs.run_read_fs(ref_cfg, direct=False)
    res = fsbench.run_read_fs(cfg, direct=False)
    _same_result(ref, res)
    assert res.bytes_total == 2 * 3 * MB  # every pass re-reads the file
    assert res.summaries["pass"].count == 6
    assert res.extra == ref.extra == {"o_direct": False}


def test_read_fs_direct_reads_a_ragged_last_block(tmp_path):
    """O_DIRECT where the filesystem takes it (buffered where it does not,
    as ``extra.o_direct`` says), over a file whose size is no multiple of
    the block: every byte of every pass is read, in both packages."""
    size = MB + 123
    ref_cfg, cfg = _configs(tmp_path, threads=1, read_count=2)
    fsbench.prepare_files(str(tmp_path), 1, size)
    ref = jax_fs.run_read_fs(ref_cfg, direct=True)
    res = fsbench.run_read_fs(cfg, direct=True)
    _same_result(ref, res)
    assert res.bytes_total == 2 * size
    assert res.extra == ref.extra


def test_write_durable(tmp_path):
    ref_cfg, cfg = _configs(tmp_path / "ref", write_count=2,
                            fsync_every_block=True)
    cfg.workload.dir = str(tmp_path / "port")
    ref = jax_fs.run_write(ref_cfg, direct=False)
    res = fsbench.run_write(cfg, direct=False)
    _same_result(ref, res)
    blocks = MB // 4096
    assert res.bytes_total == 2 * 2 * MB
    assert res.summaries["block_write"].count == 2 * 2 * blocks
    assert res.extra == ref.extra == {"fsync_every_block": True}
    for i in range(2):  # the seeded block pattern, byte for byte
        assert ((tmp_path / "port" / f"file_{i}").read_bytes()
                == (tmp_path / "ref" / f"file_{i}").read_bytes())
        assert os.path.getsize(tmp_path / "port" / f"file_{i}") == MB


def test_write_no_fsync(tmp_path):
    """The fsync switch reaches the result and the engine in both
    packages; without it a block write is no slower than with it."""
    ref_cfg, cfg = _configs(tmp_path, threads=1, write_count=1)
    p50 = {}
    for sync in (True, False):
        ref_cfg.workload.fsync_every_block = sync
        cfg.workload.fsync_every_block = sync
        ref = jax_fs.run_write(ref_cfg, direct=False)
        res = fsbench.run_write(cfg, direct=False)
        _same_result(ref, res)
        assert res.extra == ref.extra == {"fsync_every_block": sync}
        p50[sync] = res.summaries["block_write"].p50_ms
    assert p50[False] <= p50[True] * 1.5 + 0.05


def test_listing(tmp_path):
    fsbench.prepare_files(str(tmp_path), 10, 1000)
    ref_cfg, cfg = _configs(tmp_path)
    ref = jax_fs.run_listing(ref_cfg, rounds=3)
    res = fsbench.run_listing(cfg, rounds=3)
    _same_result(ref, res)
    assert res.extra == ref.extra == {
        "entries": 10, "rounds": 3, "cold_via_remount": False}
    assert res.summaries["list"].count == 3


def test_open_file_hold(tmp_path):
    fsbench.prepare_files(str(tmp_path), 5, 1000)
    ref_cfg, cfg = _configs(tmp_path, open_files=5, hold_seconds=0.05)
    ref = jax_fs.run_open_file(ref_cfg, direct=False)
    res = fsbench.run_open_file(cfg, direct=False)
    _same_result(ref, res)
    assert res.extra == ref.extra == {"open_files": 5,
                                      "cold_via_remount": False}
    assert res.summaries["open"].count == 10  # cold pass + hot pass
    assert res.wall_seconds >= 0.05


@pytest.mark.parametrize("read_type", ["seq", "random"])
def test_ssd_compare(tmp_path, read_type):
    _ssd_files(tmp_path)
    ref_cfg, cfg = _configs(tmp_path, read_type=read_type, read_count=2)
    ref = jax_fs.run_ssd_compare(ref_cfg, direct=False)
    res = fsbench.run_ssd_compare(cfg, direct=False)
    _same_result(ref, res)
    blocks = MB // 4096
    assert res.bytes_total == 2 * 2 * MB
    assert res.summaries["block_read"].count == 2 * 2 * blocks
    assert res.extra == ref.extra == {"read_type": read_type,
                                      "blocks_per_pass": blocks}
    for key in ("P20:", "P50:", "P90:", "p99:"):  # ssd_test's block shape
        assert key in res.format()


def test_ssd_compare_size_validation(tmp_path):
    d = tmp_path / "Workload.0"
    d.mkdir()
    (d / "0").write_bytes(b"short")
    ref_cfg, cfg = _configs(tmp_path, threads=1)
    with pytest.raises(JaxWorkerError) as ref_err:
        jax_fs.run_ssd_compare(ref_cfg, direct=False)
    with pytest.raises(WorkerError) as err:
        fsbench.run_ssd_compare(cfg, direct=False)
    assert str(err.value) == str(ref_err.value)


def test_ssd_random_pattern_deterministic(tmp_path, monkeypatch):
    """One seed, one shared offset pattern: the port reads the same blocks
    in the same order as ``tpubench``, run after run."""
    _ssd_files(tmp_path, n=1)
    ref_cfg, cfg = _configs(tmp_path, threads=1, read_type="random",
                            read_count=1)
    seen = {}
    for name, mod, c in (("ref", jax_fs, ref_cfg), ("port", fsbench, cfg)):
        eng = mod.get_engine() if name == "port" else mod._engine_or_raise()
        real = type(eng).pread_blocks

        def spy(self, fd, buf, block, offsets, _real=real, _name=name):
            seen.setdefault(_name, []).append(np.array(offsets))
            return _real(self, fd, buf, block, offsets)

        monkeypatch.setattr(type(eng), "pread_blocks", spy)
        r1 = mod.run_ssd_compare(c, direct=False)
        r2 = mod.run_ssd_compare(c, direct=False)
        assert r1.bytes_total == r2.bytes_total == MB
    assert len(seen["ref"]) == len(seen["port"]) == 2
    for a, b in zip(seen["ref"], seen["port"]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(seen["port"][0], np.sort(seen["port"][0]))


def _hooks(cfg, log, remount=False):
    if remount:
        cfg.workload.mount_cmd = f"echo mount >> {log}"
        cfg.workload.unmount_cmd = f"echo unmount >> {log}"
    else:
        cfg.workload.mount_cmd = f"echo mount {{dir}} >> {log}"
        cfg.workload.unmount_cmd = f"echo unmount {{dir}} >> {log}"


def test_mount_hooks_bracket_fs_run(tmp_path):
    logs = {}
    for name, mod, cls in (("ref", jax_fs, JaxBenchConfig),
                           ("port", fsbench, BenchConfig)):
        cfg = cls()
        cfg.workload.dir = str(tmp_path)
        log = tmp_path / f"{name}.log"
        _hooks(cfg, log)
        with mod.maybe_mounted(cfg):
            assert log.read_text().strip() == f"mount {tmp_path}"
        logs[name] = log.read_text().strip().splitlines()
    assert logs["port"] == logs["ref"] == [f"mount {tmp_path}",
                                           f"unmount {tmp_path}"]


def test_mount_failure_aborts(tmp_path):
    msgs = []
    for mod, cls in ((jax_fs, JaxBenchConfig), (fsbench, BenchConfig)):
        cfg = cls()
        cfg.workload.dir = str(tmp_path)
        cfg.workload.mount_cmd = "false"
        with pytest.raises(RuntimeError, match="mount hook failed") as e:
            with mod.maybe_mounted(cfg):
                pass
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_listing_hot_cold_rounds(tmp_path):
    """Round 0 is cold (after a remount when hooks are configured), the
    rest hot."""
    mnt = tmp_path / "mnt"
    fsbench.prepare_files(str(mnt), 8, 1024)
    results, logs = [], []
    for name, mod, cls in (("ref", jax_fs, JaxBenchConfig),
                           ("port", fsbench, BenchConfig)):
        cfg = cls()
        cfg.workload.dir = str(mnt)
        cfg.workload.list_rounds = 4
        log = tmp_path / f"{name}.log"
        _hooks(cfg, log, remount=True)
        results.append(mod.run_listing(cfg))
        logs.append(log.read_text().strip().splitlines())
    ref, res = results
    _same_result(ref, res)
    assert res.extra == ref.extra == {"entries": 8, "rounds": 4,
                                      "cold_via_remount": True}
    assert (res.summaries["list_cold"].count,
            res.summaries["list_hot"].count) == (1, 3)
    assert logs[0] == logs[1] == ["unmount", "mount"]


def test_open_file_hot_cold(tmp_path):
    fsbench.prepare_files(str(tmp_path), 6, 4096)
    ref_cfg, cfg = _configs(tmp_path, open_files=6)
    ref = jax_fs.run_open_file(ref_cfg, direct=False)
    res = fsbench.run_open_file(cfg, direct=False)
    _same_result(ref, res)
    assert res.summaries["open_cold"].count == res.summaries["open_hot"].count == 6
    assert res.extra["cold_via_remount"] is False


def test_cli_list_with_mount_hooks(tmp_path):
    """``list --mount-cmd/--unmount-cmd`` through both CLIs: the fresh
    mount is the cold state (no second cycle), and the results agree."""
    from tpubench.cli import main as jax_main

    import json

    d = tmp_path / "mnt"
    fsbench.prepare_files(str(d), 4, 512)
    docs, logs = [], []
    for name, main, extra in (("ref", jax_main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        log = tmp_path / f"{name}.log"
        out = tmp_path / f"res_{name}"
        rc = main([
            "list", "--dir", str(d), "--rounds", "3",
            "--mount-cmd", f"echo mount {{dir}} >> {log}",
            "--unmount-cmd", f"echo unmount {{dir}} >> {log}",
            "--results-dir", str(out), *extra,
        ])
        assert rc == 0
        logs.append(log.read_text().strip().splitlines())
        (path,) = out.glob("listing_*.json")
        docs.append(json.loads(path.read_text()))
    assert logs[0] == logs[1] == [f"mount {d}", f"unmount {d}"]
    ref, port = docs
    assert port["extra"] == ref["extra"]
    assert set(port) == set(ref) and set(port["summaries"]) == set(ref["summaries"])


@pytest.mark.parametrize("layout", ["flat", "ssd"])
def test_prepare_writes_the_references_files(tmp_path, layout):
    """``prepare`` (both layouts) through both CLIs: the same file names
    and the same bytes."""
    from tpubench.cli import main as jax_main

    trees = []
    for name, main, extra in (("ref", jax_main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        root = tmp_path / name
        rc = main(["prepare", "--layout", layout, "--dir", str(root),
                   "--threads", "2", "--open-files", "3",
                   "--file-size-mb", "1", *extra])
        assert rc == 0
        trees.append({str(p.relative_to(root)): p.read_bytes()
                      for p in sorted(root.rglob("*")) if p.is_file()})
    ref, port = trees
    assert port == ref
    want = (["file_0", "file_1", "file_2"] if layout == "flat"
            else ["Workload.0/0", "Workload.1/0"])
    assert sorted(port) == want and all(len(b) == MB for b in port.values())


def test_fs_commands_refuse_without_cuda(tmp_path, monkeypatch):
    """The fs commands bring up as every port command does: without a GPU
    and without ``--device cpu`` they raise before touching a file."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["write", "--dir", str(tmp_path / "w"), "--threads", "1",
                  "--file-size-mb", "1", "--results-dir", str(tmp_path)])
    assert not (tmp_path / "w").exists()
