#!/usr/bin/env python3
"""The cooperative cache's lockstep channel across a pod of ranks on one
host: every rank its own process and card.

    python3 scripts/coop_pod.py [--ranks 4] [--device cuda] [--steps 75]

Runs ``train-ingest --pipeline-pod --readahead 0`` over ``--ranks``
processes (rank r on ``cuda:r``, one NCCL group; gloo with ``--device
cpu``), in two arms: ``per_host`` (no cooperative cache: every rank
fetches every chunk of a step from origin) and ``coop`` (``--coop
--coop-channel ici --coop-hosts N``: a chunk comes from origin on its
ring owner only and reaches the other ranks through the pod's
all-gather, one ``IciPeerChannel.broadcast`` a chunk). Each rank holds
phase train's deployment of ``chip_smoke.py``: 48 fake objects of
100 MiB, 2 MiB chunks, 32 a step, 20 ms of step compute.

Checks, for every rank of both arms: zero errors, every step's bytes
delivered, each step's pod checksum (the gather's ``tb_checksum`` on the
card) equal to the host's sum of the step's batch taken from the store,
no slab leaked. Coop arm: the pod's origin fetches equal the plan's
unique chunks and the per-host arm's cache misses N times that; the peer
hits summed over the pod are (N - 1) times the owner fetches; no peer
miss; each rank's channel made one broadcast a unique chunk. Prints one
JSON line per rank and arm, then a summary line with both arms' GB/s per
chip and origin bytes, and the card's name and power limit; exits
nonzero on any failure. Every rank's group has a 120 s timeout and every
process a deadline, so ranks that lose step fail instead of waiting. The
ranks' own output goes to ``build/coop_pod/<arm>/rank<r>.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MIB = 1 << 20
MOD = 1 << 32
GROUP_TIMEOUT_S = 120.0
ARMS = {"per_host": [], "coop": ["--coop", "--coop-channel", "ici"]}


def _argv(a, arm: str, rank: int, port: int, out_dir: str) -> list:
    return [
        "train-ingest", "--protocol", "fake",
        "--workers", str(a.objects), "--object-size", str(a.object_size),
        "--granule-bytes", str(a.chunk), "--chunk-bytes", str(a.chunk),
        "--batch-shards", str(a.batch), "--steps", str(a.steps),
        "--step-compute-ms", str(a.compute_ms), "--readahead", "0",
        "--pipeline-pod", *ARMS[arm],
        *(["--coop-hosts", str(a.ranks)] if arm == "coop" else []),
        "--num-processes", str(a.ranks), "--process-id", str(rank),
        "--coordinator", f"127.0.0.1:{port}", "--results-dir", out_dir,
    ]


def child(a) -> None:
    """One rank: bring the group up (with its timeout), run the command
    as the CLI runs it, and write what the parent checks."""
    import numpy as np
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.dist import bringup, peer
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.workloads import train_ingest

    args = cli.build_parser().parse_args(
        _argv(a, a.arm, a.rank, a.port, a.out_dir))
    cfg = cli.build_config(args)
    store = FakeBackend.prepopulated(cfg.workload.object_name_prefix,
                                     a.objects, a.object_size)
    plan = train_ingest.build_plan(cfg, store)
    b = cfg.pipeline.batch_shards
    step_sums = [
        sum(int(store._objects[k.object][k.start:k.start + k.length]
                .sum(dtype=np.uint64)) for k in plan[i:i + b]) % MOD
        for i in range(0, len(plan), b)]

    sums, channels = [], []
    make = train_ingest.make_reassemble

    def watched(pod):
        fn = make(pod)

        def call(staged):
            gathered, csum = fn(staged)
            sums.append(int(csum))
            return gathered, csum

        return call

    class Kept(peer.IciPeerChannel):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            channels.append(self)

    train_ingest.make_reassemble = watched
    peer.IciPeerChannel = Kept
    bringup.initialize(cfg.dist, a.device, timeout_s=GROUP_TIMEOUT_S)
    backend = dist.get_backend()
    landing.reset_launches()
    t0 = time.perf_counter()
    res = cli.execute("train-ingest", cfg, device=a.device, backend=store,
                      args=args)
    seconds = time.perf_counter() - t0
    pipe = res.extra["pipeline"]
    out = {
        "rank": a.rank, "arm": a.arm, "backend": backend,
        "errors": res.errors, "bytes_total": res.bytes_total,
        "want_bytes": len(plan) * a.chunk, "n_chips": res.n_chips,
        "gbps_per_chip": res.gbps_per_chip, "wall_s": res.wall_seconds,
        "seconds": seconds, "stall_p50_ms": pipe["stall"]["p50_ms"],
        "stall_p99_ms": pipe["stall"]["p99_ms"],
        "unique_chunks": pipe["plan"]["unique_chunks"],
        "cache_misses": pipe["cache"]["misses"],
        "leaked_slabs": pipe["copies"]["pool"]["leaked_slabs"],
        "step_sums_ok": sums[0] == 0 and sums[1:] == step_sums,
        "gathers": len(sums), "checksum_launches": landing.checksum.launches,
        "coop": pipe.get("coop"),
        "broadcasts": [c.stats()["broadcasts"] for c in channels],
    }
    with open(a.out, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def run_arm(a, arm: str) -> list:
    from tpubench_torch.dist.bringup import free_port
    from tpubench_torch.dist.launch import run_ranks

    out_dir = str(ROOT / "build" / "coop_pod" / arm)
    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    outs = [os.path.join(out_dir, f"rank{rank}.json")
            for rank in range(a.ranks)]
    for out in outs:
        if os.path.exists(out):
            os.remove(out)
    res = run_ranks(
        [[sys.executable, __file__, "--child", "--arm", arm,
          "--rank", str(rank), "--port", str(port), "--out", outs[rank],
          "--out-dir", out_dir, *_shape_flags(a)]
         for rank in range(a.ranks)],
        [os.path.join(out_dir, f"rank{rank}.log") for rank in range(a.ranks)],
        deadline_s=a.deadline_s)
    if not res.ok:
        raise RuntimeError(f"coop_pod/{arm}: ranks exited {res.rcs} "
                           f"(deadline passed: {res.timed_out}; logs under "
                           f"{out_dir})")
    rows = []
    for out in outs:
        with open(out) as f:
            rows.append(json.load(f))
    return rows


def _shape_flags(a) -> list:
    return ["--ranks", str(a.ranks), "--device", a.device,
            "--steps", str(a.steps), "--objects", str(a.objects),
            "--object-size", str(a.object_size), "--chunk", str(a.chunk),
            "--batch", str(a.batch), "--compute-ms", str(a.compute_ms)]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"coop_pod: {msg}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=75)
    ap.add_argument("--objects", type=int, default=48)
    ap.add_argument("--object-size", type=int, default=100 * MIB)
    ap.add_argument("--chunk", type=int, default=2 * MIB)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--compute-ms", type=float, default=20.0)
    ap.add_argument("--deadline-s", type=float, default=600.0)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--arm", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--out-dir", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a)
        return 0
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("coop_pod: CUDA is not available", file=sys.stderr)
            return 1
        check(torch.cuda.device_count() >= a.ranks,
              f"{a.ranks} ranks need {a.ranks} cards, "
              f"torch sees {torch.cuda.device_count()}")
    n = a.ranks
    arms = {}
    for arm in ARMS:
        rows = arms[arm] = run_arm(a, arm)
        for r in rows:
            print(json.dumps(r), flush=True)
            tag = f"{arm}/rank{r['rank']}"
            check(r["errors"] == 0 and r["bytes_total"] == r["want_bytes"]
                  and r["leaked_slabs"] == 0 and r["n_chips"] == n,
                  f"{tag}: {r}")
            check(r["step_sums_ok"] and r["gathers"] == a.steps + 1,
                  f"{tag}: pod checksums differ from the host's")
            check(r["backend"] == ("nccl" if a.device == "cuda" else "gloo"),
                  f"{tag}: backend {r['backend']}")
            if a.device == "cuda":
                # The step gathers' checksums, and one a broadcast.
                want = a.steps + 1 + sum(r["broadcasts"])
                check(r["checksum_launches"] == want,
                      f"{tag}: {r['checksum_launches']} launches, "
                      f"want {want}")
    unique = arms["coop"][0]["unique_chunks"]
    coop = [r["coop"] for r in arms["coop"]]
    check(sum(r["cache_misses"] for r in arms["per_host"]) == n * unique,
          "per_host: the pod's misses are not N x the unique chunks")
    check(sum(c["origin_fetches"] for c in coop) == unique
          and sum(c["owner_fetches"] for c in coop) == unique,
          f"coop: origin fetches {[c['origin_fetches'] for c in coop]} "
          f"for {unique} unique chunks")
    check(sum(c["peer_hits"] for c in coop) == (n - 1) * unique
          and not any(c["peer_misses"] for c in coop)
          and all(c["hosts"] == n for c in coop),
          f"coop: peer hits {[c['peer_hits'] for c in coop]}")
    check(all(r["broadcasts"] == [unique] for r in arms["coop"]),
          f"coop: broadcasts {[r['broadcasts'] for r in arms['coop']]}")

    def med(arm, key):
        vals = sorted(r[key] for r in arms[arm])
        return vals[len(vals) // 2]

    from tpubench_torch.device import nvidia_smi_line

    print(json.dumps({
        "summary": "coop_pod", "ranks": n, "device": a.device,
        "steps": a.steps, "batch": a.batch, "chunk_bytes": a.chunk,
        "unique_chunks": unique,
        "origin_bytes_per_pod": {
            "per_host": sum(r["cache_misses"] for r in arms["per_host"])
            * a.chunk,
            "coop": sum(c["origin_bytes"] for c in coop)},
        "gbps_per_chip_median": {arm: med(arm, "gbps_per_chip")
                                 for arm in ARMS},
        "stall_p50_ms_median": {arm: med(arm, "stall_p50_ms")
                                for arm in ARMS},
        "transfer_p50_ms": [c["transfer_p50_ms"] for c in coop],
        "transfer_p99_ms": [c["transfer_p99_ms"] for c in coop],
        "reduced": ["one host: the ranks' cards share its CPU cores",
                    "the fake store in every rank's process"],
    }), flush=True)
    if a.device == "cuda":
        print(nvidia_smi_line() or "nvidia-smi: not available", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
