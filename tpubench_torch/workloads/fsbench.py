"""Filesystem workloads (``tpubench/workloads/fsbench.py``; the reference's
``benchmark-script/``, SURVEY §2.2).

Five drivers on the reference's skeleton — flags → files indexed by
worker id → fan-out → join — over the native engine's timed block I/O
(per-thread latency arrays; every native call releases the interpreter
lock, so the threads do I/O at once). The reference's bugs are not
reproduced (SURVEY §7): the re-read at EOF, the racy shared latency
slice, the dead listing code, the unsynchronised offset shuffle.

* :func:`run_read_fs`     — #11 sequential read (read_operation/main.go)
* :func:`run_write`       — #12 durable write  (write_operations/main.go)
* :func:`run_listing`     — #13 list           (list_operation/main.go)
* :func:`run_open_file`   — #14 open/FD-hold   (open_file/main.go)
* :func:`run_ssd_compare` — #15 percentile     (ssd_test/main.go)

No device is touched: the bytes go from the disk to host memory, as in
the reference. A failed engine build raises (``get_engine``). Where the
filesystem refuses ``O_DIRECT`` (tmpfs, overlay) the engine opens the
file buffered instead, and ``extra.o_direct`` of a read says which ran.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
import warnings
from typing import Optional

import numpy as np

from tpubench_torch.config import BenchConfig
from tpubench_torch.metrics.percentiles import summarize_ns
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.native.engine import get_engine
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.workloads.common import WorkerGroup

KB = 1024


# ------------------------------------------------------- mount orchestration
def _run_hook(template: str, dirpath: str) -> None:
    cmd = template.format(dir=dirpath)
    proc = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"mount hook failed ({proc.returncode}): {cmd}\n{proc.stderr[-500:]}"
        )


# Directories the current maybe_mounted bracket mounted and no workload has
# touched yet: a fresh mount is already cold, so the cold round's _remount
# skips one unmount+mount cycle (gcsfuse mounts cost seconds each).
_fresh_mounts: set[str] = set()
_fresh_lock = threading.Lock()


@contextlib.contextmanager
def maybe_mounted(cfg: BenchConfig):
    """Bracket a run with the configured mount/unmount commands, the
    launcher convention of every benchmark script (read_operations.sh:18-21:
    mount gcsfuse with explicit cache TTLs, run, unmount). No commands: a
    directory mounted beforehand (the default). A failed mount aborts (the
    run would measure the wrong filesystem); a failed unmount warns."""
    w = cfg.workload
    if w.mount_cmd:
        _run_hook(w.mount_cmd, w.dir)
        with _fresh_lock:
            _fresh_mounts.add(w.dir)
    try:
        yield
    finally:
        with _fresh_lock:
            _fresh_mounts.discard(w.dir)
        if w.unmount_cmd:
            try:
                _run_hook(w.unmount_cmd, w.dir)
            except RuntimeError as e:
                warnings.warn(str(e), stacklevel=2)


def _remount(cfg: BenchConfig) -> bool:
    """A true cold cache: unmount + mount when both hooks are configured
    (list_operations.sh runs its cold variant on a fresh mount with zero
    cache TTLs). A mount that :func:`maybe_mounted` just made is cold
    already and is used without another cycle. Returns whether the cold
    state came from a (re)mount."""
    w = cfg.workload
    with _fresh_lock:
        if w.dir in _fresh_mounts:
            # One cold round per fresh mount, with or without an unmount
            # hook (a mount-only config: the directory was unmounted).
            _fresh_mounts.discard(w.dir)
            return True
    if not (w.mount_cmd and w.unmount_cmd):
        return False
    _run_hook(w.unmount_cmd, w.dir)
    _run_hook(w.mount_cmd, w.dir)
    return True


def prepare_files(
    dirpath: str, count: int, size: int, name_fmt: str = "file_{i}"
) -> list[str]:
    """The worker-indexed data files the reference expects on the mount
    (worker i owns file_<i>, read_operation/main.go:33); a file already
    there at the right size is kept."""
    os.makedirs(dirpath, exist_ok=True)
    paths = []
    for i in range(count):
        name = name_fmt.format(i=i)
        p = os.path.join(dirpath, name)
        if not (os.path.exists(p) and os.path.getsize(p) == size):
            with open(p, "wb") as f:
                f.write(deterministic_bytes(name, size).tobytes())
        paths.append(p)
    return paths


def prepare_ssd_files(dirpath: str, count: int, size: int) -> list[str]:
    """The ssd_test layout: ``Workload.<i>/0`` (ssd_test/main.go:41), each
    the deterministic bytes of its relative name."""
    paths = []
    for i in range(count):
        d = os.path.join(dirpath, f"Workload.{i}")
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, "0")
        if not (os.path.exists(p) and os.path.getsize(p) == size):
            with open(p, "wb") as f:
                f.write(deterministic_bytes(f"Workload.{i}/0", size).tobytes())
        paths.append(p)
    return paths


def _result(workload: str, cfg: BenchConfig, total: int, wall: float,
            summaries: dict) -> RunResult:
    return RunResult(
        workload=workload,
        config=cfg.to_dict(),
        bytes_total=total,
        wall_seconds=wall,
        gbps=(total / 1e9) / wall if wall > 0 else 0.0,
        summaries=summaries,
    )


# ------------------------------------------------------------------- #11 --
def run_read_fs(cfg: BenchConfig, direct: bool = True) -> RunResult:
    """Sequential read: each thread streams its file ``read_count`` times
    through a ``block_size`` buffer. Every pass starts at offset 0 (the
    reference read at EOF after its first pass, read_operation/main.go:46);
    a last block shorter than the buffer is read too."""
    w = cfg.workload
    eng = get_engine()
    n = w.threads
    block = w.block_size_kb * KB
    pass_lats: list[np.ndarray] = [np.empty(0)] * n
    totals = [0] * n
    directs = [False] * n

    def worker(i: int, cancel) -> None:
        path = os.path.join(w.dir, f"file_{i}")
        fd, directs[i] = eng.open(path, direct=direct)
        buf = eng.alloc(block)
        try:
            totals[i], pass_lats[i] = eng.read_file_seq(
                fd, buf, passes=w.read_count
            )
        finally:
            eng.close(fd)
            buf.free()

    t0 = time.perf_counter()
    WorkerGroup(abort_on_error=w.abort_on_error).run(n, worker, name="read_fs")
    wall = time.perf_counter() - t0

    merged = np.concatenate([a for a in pass_lats if a.size]) if n else np.empty(0)
    res = _result("read_fs", cfg, sum(totals), wall,
                  {"pass": summarize_ns(merged)} if merged.size else {})
    res.extra["o_direct"] = all(directs)
    return res


# ------------------------------------------------------------------- #12 --
def run_write(cfg: BenchConfig, direct: bool = True) -> RunResult:
    """Durable write: per block a pwrite and (by default) an fsync — the
    reference syncs EVERY block (write_operations/main.go:63-71), so this
    measures durable-write latency, not throughput. Block latencies
    include the fsync. ``write_count`` rounds overwrite the same file
    (O_TRUNC reopen each round, :36)."""
    w = cfg.workload
    eng = get_engine()
    os.makedirs(w.dir, exist_ok=True)
    n = w.threads
    block = w.block_size_kb * KB
    n_blocks = max(1, w.file_size_mb * 1024 * KB // block)
    offsets = np.arange(n_blocks, dtype=np.int64) * block
    lat_all: list[np.ndarray] = [np.empty(0)] * n
    totals = [0] * n

    def worker(i: int, cancel) -> None:
        path = os.path.join(w.dir, f"file_{i}")
        buf = eng.alloc(block)
        eng.fill_random(buf, seed=w.seed + i + 1)
        lats = []
        try:
            for _ in range(w.write_count):
                if cancel.is_set():
                    break
                fd, _ = eng.open(path, write=True, create=True, direct=direct)
                try:
                    total, lat = eng.pwrite_blocks(
                        fd, buf, block, offsets, fsync_each=w.fsync_every_block
                    )
                    totals[i] += total
                    lats.append(lat)
                finally:
                    eng.close(fd)
        finally:
            buf.free()
        if lats:
            lat_all[i] = np.concatenate(lats)

    t0 = time.perf_counter()
    WorkerGroup(abort_on_error=w.abort_on_error).run(n, worker, name="write")
    wall = time.perf_counter() - t0

    merged = np.concatenate([a for a in lat_all if a.size])
    res = _result("write", cfg, sum(totals), wall,
                  {"block_write": summarize_ns(merged)} if merged.size else {})
    res.extra["fsync_every_block"] = w.fsync_every_block
    return res


# ------------------------------------------------------------------- #13 --
def run_listing(cfg: BenchConfig, rounds: Optional[int] = None) -> RunResult:
    """List + stat of every entry: the semantics of the reference's
    in-process lister (list_operation/main.go:14-36), which it never calls
    (it times an ``ls -lah`` subprocess instead, :41-66: mostly process
    spawn, not reproduced).

    Hot and cold (list_operations.sh:11-21 runs one variant of each):
    round 0 is the COLD round — after a remount when mount hooks are
    configured, else the first touch — and the other rounds are HOT.
    Both are summarised apart, and together."""
    w = cfg.workload
    rounds = max(1, rounds if rounds is not None else w.list_rounds)
    remounted = _remount(cfg)
    lat = []
    entries = 0
    t0 = time.perf_counter()
    for _ in range(rounds):
        t = time.perf_counter_ns()
        with os.scandir(w.dir) as it:
            entries = sum(1 for e in it if e.stat() is not None)
        lat.append(time.perf_counter_ns() - t)
    wall = time.perf_counter() - t0
    summaries = {
        "list": summarize_ns(np.array(lat)),
        "list_cold": summarize_ns(np.array(lat[:1])),
    }
    if len(lat) > 1:
        summaries["list_hot"] = summarize_ns(np.array(lat[1:]))
    res = RunResult(workload="listing", config=cfg.to_dict(),
                    wall_seconds=wall, summaries=summaries)
    res.extra["entries"] = entries
    res.extra["rounds"] = rounds
    res.extra["cold_via_remount"] = remounted
    return res


# ------------------------------------------------------------------- #14 --
def run_open_file(cfg: BenchConfig, direct: bool = True) -> RunResult:
    """Open N files, hold the descriptors ``hold_seconds`` (the reference
    holds 3 min so gcsfuse's memory can be watched, open_file/main.go:52-55),
    close. The metric is per-open latency.

    Hot and cold (open_file_operation.sh:10-19): a COLD pass (after a
    remount when mount hooks are configured), then a HOT pass, whose
    descriptors are the ones held."""
    w = cfg.workload
    eng = get_engine()

    def open_pass():
        lat, fds = [], []
        try:
            for i in range(w.open_files):
                path = os.path.join(w.dir, f"file_{i}")
                t = time.perf_counter_ns()
                fd, _ = eng.open(path, direct=direct)
                lat.append(time.perf_counter_ns() - t)
                fds.append(fd)
            return lat, fds
        except BaseException:
            for fd in fds:
                eng.close(fd)
            raise

    remounted = _remount(cfg)
    t0 = time.perf_counter()
    cold_lat, fds = open_pass()
    for fd in fds:
        eng.close(fd)
    hot_lat, fds = open_pass()
    try:
        if w.hold_seconds:
            time.sleep(w.hold_seconds)
    finally:
        for fd in fds:
            eng.close(fd)
    wall = time.perf_counter() - t0
    res = RunResult(
        workload="open_file",
        config=cfg.to_dict(),
        wall_seconds=wall,
        summaries={
            "open": summarize_ns(np.array(cold_lat + hot_lat)),
            "open_cold": summarize_ns(np.array(cold_lat)),
            "open_hot": summarize_ns(np.array(hot_lat)),
        },
    )
    res.extra["open_files"] = len(fds)
    res.extra["cold_via_remount"] = remounted
    return res


# ------------------------------------------------------------------- #15 --
def run_ssd_compare(cfg: BenchConfig, direct: bool = True) -> RunResult:
    """Block-latency percentiles (the reference's most complete driver,
    ssd_test/main.go): offsets in order for ``seq``, shuffled for
    ``random`` (:118-128). All threads share ONE pattern, as there, but
    it is built once from a seeded generator before the fan-out, so no
    thread races on it. Per-thread latency arrays merge after the join
    (the reference's global append raced, :80)."""
    w = cfg.workload
    eng = get_engine()
    n = w.threads
    block = w.block_size_kb * KB
    fsize = w.file_size_mb * 1024 * KB
    n_blocks = max(1, fsize // block)
    offsets = np.arange(n_blocks, dtype=np.int64) * block
    if w.read_type == "random":
        rng = np.random.Generator(np.random.Philox(w.seed))
        rng.shuffle(offsets)
    elif w.read_type != "seq":
        raise ValueError(f"read_type must be seq|random, got {w.read_type!r}")

    lat_all: list[np.ndarray] = [np.empty(0)] * n
    totals = [0] * n

    def worker(i: int, cancel) -> None:
        path = os.path.join(w.dir, f"Workload.{i}", "0")
        size = eng.file_size(path)
        if size != fsize:
            raise ValueError(f"{path}: size {size} != configured {fsize}")
        fd, _ = eng.open(path, direct=direct)
        buf = eng.alloc(block)
        lats = []
        try:
            for _ in range(w.read_count):
                if cancel.is_set():
                    break
                total, lat = eng.pread_blocks(fd, buf, block, offsets)
                totals[i] += total
                lats.append(lat)
        finally:
            eng.close(fd)
            buf.free()
        if lats:
            lat_all[i] = np.concatenate(lats)

    t0 = time.perf_counter()
    WorkerGroup(abort_on_error=w.abort_on_error).run(n, worker, name="ssd")
    wall = time.perf_counter() - t0

    merged = np.concatenate([a for a in lat_all if a.size])
    res = _result("ssd_compare", cfg, sum(totals), wall,
                  {"block_read": summarize_ns(merged)})
    res.extra["read_type"] = w.read_type
    res.extra["blocks_per_pass"] = int(n_blocks)
    return res
