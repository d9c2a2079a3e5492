"""Multi-chip scaling sweep (``tpubench/dist/sweep.py``): pod-ingest and
collective bandwidth against pod size.

Each pod size n runs as a child of its own: n rank processes, one
process group. A child of n ≥ 2 is a gloo group on the CPU (the card's
machine has one GPU, and NCCL takes one rank per GPU); a child of size 1
runs on the card over NCCL unless ``--device cpu`` is given. Every row
says which (``backend``, ``device``), and so does the artifact's
``platform``.

A child runs pod-ingest of one object of n × ``shard_mb`` MiB with the
all-gather and with the ring (each stage timed apart, the warm-up apart,
verified), after an untimed small run that absorbs the first run's
set-up. The largest child also runs ``gather-bench``'s four collectives;
their byte accounting is checked again against the ring schedule
(:func:`check_ring_algebra`) before the artifact is written, so
``ring_algebra_ok`` is a recomputation, not an echo. A child holds only
the one object pod-ingest reads in its store (the reference's holds one
per worker, of which it reads one).

The artifact goes to ``<results-dir>/multichip_sweep_torch.json`` by
default; it never replaces the reference's committed
``MULTICHIP_SWEEP.json``. Gloo rows are CPU numbers: read them for the
scaling shape and for correctness at realistic shard sizes, not for link
bandwidth.

    python -m tpubench_torch.dist.sweep --sizes 1,2 --shard-mb 8 --reps 1
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import Optional

_COLLECTIVES = ("all_gather", "ring", "reduce_scatter", "psum")
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]
ARTIFACT = "multichip_sweep_torch.json"


def _child_device(n: int, device: str) -> str:
    """Where a child of size ``n`` runs: several ranks share the host's
    CPU (gloo); one rank runs on ``device``."""
    return device if n == 1 else "cpu"


def _run_child(n: int, shard_mb: float, reps: int, collectives: bool,
               device: str, timeout_s: float = 600.0) -> dict:
    """The n rank processes of one pod size (:func:`tpubench_torch.dist.
    launch.run_ranks`: a rank that fails ends the others, every process
    has ended when this returns); rank 0's row."""
    import tempfile

    from tpubench_torch.dist.bringup import free_port
    from tpubench_torch.dist.launch import child_env, run_ranks

    cmd = [
        sys.executable, "-m", "tpubench_torch.dist.sweep", "--child", str(n),
        "--port", str(free_port()), "--shard-mb", str(shard_mb),
        "--reps", str(reps), "--device", _child_device(n, device),
    ]
    if collectives:
        cmd.append("--collectives")
    env = child_env()  # the child joins its group from its flags
    with tempfile.TemporaryDirectory(prefix="tpubench-sweep-") as logs:
        res = run_ranks(
            [cmd + ["--rank", str(r)] for r in range(n)],
            [os.path.join(logs, f"rank{r}.log") for r in range(n)],
            envs=[env] * n, deadline_s=timeout_s,
        )
        if not res.ok:
            raise RuntimeError(
                f"sweep child n={n} failed (exit codes {res.rcs}, deadline "
                f"passed: {res.timed_out}): "
                f"{[(r, res.tail(r)) for r in res.failed]}")
        rows = [ln for ln in res.tail(0, 1 << 20).splitlines()
                if ln.startswith("{")]
    return json.loads(rows[-1])


def _pod_row(res) -> dict:
    e = res.extra
    return {
        "verified": e["verified"],
        "errors": res.errors,
        "object_size": e["object_size"],
        "shard_bytes": e["shard_bytes"],
        "fetch_seconds": round(e["fetch_seconds"], 6),
        "stage_seconds": round(e["stage_seconds"], 6),
        "gather_seconds": round(e["gather_seconds"], 6),
        "compile_seconds": round(e["compile_seconds"], 6),
        "fetch_gbps": round(e["fetch_gbps"], 4),
        "stage_gbps": round(e["stage_gbps"], 4),
        "gather_gbps": round(e["gather_gbps"], 4),
        "ingest_gbps": round(res.gbps, 4),
        "ici_bytes_moved": e["ici_bytes_moved"],
    }


def child_main(n: int, rank: int, port: int, shard_mb: float, reps: int,
               collectives: bool, device: str = "cuda") -> dict:
    """Rank ``rank`` of the size-``n`` child: joins the group (one rank:
    a group of its own on a free port), runs the pod-ingest rows and,
    when asked, the collectives; every rank returns the same row."""
    import torch.distributed as dist

    from tpubench_torch.config import MB, BenchConfig, DistConfig
    from tpubench_torch.dist import bringup
    from tpubench_torch.kernels import landing
    from tpubench_torch.workloads.pod_ingest import run_pod_ingest

    dcfg = (DistConfig() if n == 1 else DistConfig(
        num_processes=n, process_id=rank,
        coordinator_address=f"127.0.0.1:{port}"))

    def config(object_size: int) -> BenchConfig:
        cfg = BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.workload.workers = 1  # pod-ingest reads object 0 alone
        cfg.workload.object_size = object_size
        return cfg

    with bringup.session(dcfg, device, one_rank_group=True):
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"child expected {n} ranks, got {dist.get_world_size()}")
        cfg = config(int(n * shard_mb * MB))
        # The first run pays thread-pool and communicator set-up in its
        # stages: a small untimed one absorbs it.
        run_pod_ingest(config(n * 256 * 1024), verify=False, device=device)
        landing.reset_launches()
        out: dict = {"devices": n, "shard_mb": shard_mb,
                     "backend": dist.get_backend(), "device": device}
        for ring in (False, True):
            res = run_pod_ingest(cfg, ring=ring, verify=True, device=device)
            out["pod_ingest_ring" if ring else "pod_ingest_all_gather"] = (
                _pod_row(res))
        if collectives:
            from tpubench_torch.workloads.gather_bench import run_gather_bench

            coll: dict = {}
            for mode in _COLLECTIVES:
                res = run_gather_bench(cfg, shard_mb=shard_mb, reps=reps,
                                       collective=mode, device=device)
                coll[mode] = [
                    {
                        "devices": r["devices"],
                        "shard_bytes": r["shard_bytes"],
                        "seconds": round(r["seconds"], 6),
                        "ici_bytes_moved": r["ici_bytes_moved"],
                        "per_chip_rx_gbps": round(r["per_chip_rx_gbps"], 4),
                        "total_gbps": round(r["total_gbps"], 4),
                    }
                    for r in res.extra["scaling"]
                ]
            out["collectives"] = coll
        # Kernel launches on this rank's card over the timed rows (none
        # on the CPU, where the plain versions run).
        out["launches"] = {"land": landing.land.launches,
                           "checksum": landing.checksum.launches}
    return out


def check_ring_algebra(collectives: dict) -> list[str]:
    """Recompute every collective row's bytes on the wire from the ring
    schedule (``gather_bench``'s docstring); the violations."""
    bad: list[str] = []
    for mode, rows in collectives.items():
        for r in rows:
            n, s = r["devices"], r["shard_bytes"]
            if mode in ("all_gather", "ring"):
                want = s * n * (n - 1)
            elif mode == "reduce_scatter":
                want = s * (n - 1)
            elif mode == "psum":
                want = 2 * s * (n - 1)
            else:
                bad.append(f"{mode}: unknown collective")
                continue
            if r["ici_bytes_moved"] != want:
                bad.append(
                    f"{mode} n={n}: ici_bytes_moved={r['ici_bytes_moved']} "
                    f"!= ring algebra {want}"
                )
    return bad


def run_sweep(
    sizes: tuple[int, ...] = (2, 4, 8, 16),
    shard_mb: float = 8.0,
    reps: int = 3,
    out_path: Optional[str] = None,
    device: str = "cuda",
) -> dict:
    """One child per size, the collectives in the largest; the artifact
    written to ``out_path`` when given."""
    if out_path and Path(out_path).resolve() == (
            _PACKAGE_ROOT / "MULTICHIP_SWEEP.json"):
        raise ValueError(
            f"{out_path} is tpubench's committed artifact; give another --out")
    per_size = [
        _run_child(n, shard_mb, reps, collectives=(n == max(sizes)),
                   device=device)
        for n in sizes
    ]
    collectives = {}
    for c in per_size:
        if "collectives" in c:
            collectives = c.pop("collectives")  # one copy, at the top
    violations = check_ring_algebra(collectives)
    platforms = sorted({f"{c['backend']} on {c['device']}" for c in per_size})
    result = {
        "platform": ("one child per size (n ranks, one process group): "
                     + ", ".join(platforms)),
        "sizes": list(sizes),
        "shard_mb": shard_mb,
        "pod_ingest": per_size,
        "collectives": collectives,
        "ring_algebra_ok": not violations,
        "ring_algebra_violations": violations,
        "note": ("gloo rows are CPU numbers: read them for scaling shape "
                 "and correctness at realistic shard sizes, not link "
                 "bandwidth; rows with backend nccl ran on the card"),
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--collectives", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--sizes", default="2,4,8,16")
    ap.add_argument("--shard-mb", type=float, default=8.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where a child of size 1 runs (larger ones: gloo "
                         "on the CPU)")
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--out", help=f"artifact path (default "
                                  f"<results-dir>/{ARTIFACT})")
    args = ap.parse_args(argv)
    if args.child:
        row = child_main(args.child, args.rank, args.port, args.shard_mb,
                         args.reps, args.collectives, device=args.device)
        if args.rank == 0:
            print(json.dumps(row), flush=True)
        return 0
    sizes = tuple(int(x) for x in args.sizes.split(","))
    if any(n < 1 for n in sizes):
        raise SystemExit(f"--sizes {args.sizes}: every size must be >= 1")
    out = args.out or os.path.join(args.results_dir, ARTIFACT)
    result = run_sweep(sizes, args.shard_mb, args.reps, out_path=out,
                       device=args.device)
    print(json.dumps(result))
    print(f"artifact: {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
