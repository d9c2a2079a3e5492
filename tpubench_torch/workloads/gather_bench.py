"""Collective micro-benchmark (``tpubench/workloads/gather_bench.py``):
bandwidth against pod size, per collective.

For every pod size n (powers of two up to the world size) the first n
ranks form a group (``new_group``), each stages one shard of random bytes
onto its device and the collective is timed after an uncounted warm-up
call. NCCL on CUDA, gloo on the CPU. Byte accounting per call, as in the
reference:

* ``all_gather`` and ``ring`` — each rank receives the other n−1 shards:
  per rank ``shard × (n−1)``, total ``shard × n × (n−1)``;
* ``reduce_scatter`` — per rank ``shard × (n−1)/n``, total
  ``shard × (n−1)``;
* ``psum`` (all-reduce) — per rank ``2 × shard × (n−1)/n``, total
  ``2 × shard × (n−1)``.

With one rank there is nothing to move: the collective runs anyway and the
result says ``single_device``. Every rank takes part; rank 0's view is the
result.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpubench_torch.config import BenchConfig
from tpubench_torch.device import resolve_device, synchronize
from tpubench_torch.dist.reassemble import (
    make_allreduce,
    make_mesh,
    make_reassemble,
    make_reduce_scatter,
    make_ring_reassemble,
    shard_to_device_array,
)
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.staging.device import new_slot

COLLECTIVES = {
    "all_gather": make_reassemble,
    "ring": make_ring_reassemble,
    "reduce_scatter": make_reduce_scatter,
    "psum": make_allreduce,
}


def run_gather_bench(
    cfg: BenchConfig,
    shard_mb: float = 4.0,
    reps: int = 5,
    ring: bool = False,
    collective: str = "",
    device="cuda",
) -> RunResult:
    """The sweep over the process group this process joined (the
    caller's: ``cli.execute`` brings it up, one rank for a single
    process)."""
    mode = collective or ("ring" if ring else "all_gather")
    if mode not in COLLECTIVES:
        raise ValueError(f"unknown collective {mode!r}")
    resolve_device(device)
    world = make_mesh(device=device).size
    lane = cfg.staging.lane
    shard_bytes = int(shard_mb * 1024 * 1024) // lane * lane
    sizes = []
    n = 2
    while n <= world:
        sizes.append(n)
        n *= 2
    single_device = not sizes
    # reduce_scatter splits rows across ranks: rows divide by the largest
    # swept size, so every size gets an equal split.
    max_n = sizes[-1] if sizes else 1
    shard_bytes = shard_bytes // (lane * max_n) * (lane * max_n) or lane * max_n
    if single_device:
        sizes = [1]

    rng = np.random.default_rng(0)
    rows = []
    for n in sizes:
        # The same draws as the reference's single process: shard i is the
        # i-th array, and rank i keeps its own.
        shards = [
            rng.integers(0, 256, (shard_bytes,), dtype=np.uint8) for _ in range(n)
        ]
        pod = make_mesh(range(n), axis=cfg.dist.mesh_axis, device=device)
        if pod is None:
            continue  # this rank is outside the first n
        host = new_slot((shard_bytes // lane, lane), pod.device.type == "cuda")
        host.view(-1).copy_(torch.from_numpy(shards[pod.rank]))
        staged = shard_to_device_array([host], pod, lane)
        fn = COLLECTIVES[mode](pod)
        fn(staged)
        synchronize(pod.device)  # warm-up, uncounted
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(staged)
        synchronize(pod.device)
        dt = (time.perf_counter() - t0) / reps  # per-collective mean
        if mode in ("all_gather", "ring"):
            per_chip_bytes = shard_bytes * (n - 1)
            total_bytes = shard_bytes * n * (n - 1)
        elif mode == "reduce_scatter":
            per_chip_bytes = shard_bytes * (n - 1) // n
            total_bytes = shard_bytes * (n - 1)
        else:  # psum
            per_chip_bytes = 2 * shard_bytes * (n - 1) // n
            total_bytes = 2 * shard_bytes * (n - 1)
        per_chip_rx = per_chip_bytes / dt / 1e9 if dt > 0 else 0.0
        rows.append(
            {
                "devices": n,
                "shard_bytes": shard_bytes,
                "seconds": dt,
                "reps": reps,
                "ici_bytes_moved": total_bytes,  # per invocation
                "per_chip_rx_gbps": per_chip_rx,
                "total_gbps": total_bytes / dt / 1e9 if dt > 0 else 0.0,
            }
        )

    # Self-consistent headline: gbps == bytes_total / wall_seconds, and
    # gbps_per_chip == gbps / n_chips; the per-size picture is in extras.
    # A rank outside every swept pod (world not a power of two) has no row.
    bytes_total = sum(r["ici_bytes_moved"] for r in rows) * reps
    wall = sum(r["seconds"] for r in rows) * reps
    n_chips = max((r["devices"] for r in rows), default=1)
    gbps = (bytes_total / 1e9) / wall if wall > 0 else 0.0
    best = max(rows, key=lambda r: r["per_chip_rx_gbps"], default=None)
    res = RunResult(
        workload="gather_bench",
        config=cfg.to_dict(),
        bytes_total=bytes_total,
        wall_seconds=wall,
        gbps=gbps,
        gbps_per_chip=gbps / n_chips,
        n_chips=n_chips,
        errors=0,
    )
    res.extra.update(
        {
            "mode": mode,
            "scaling": rows,
            "best": best,
            "single_device": single_device,
        }
    )
    return res
