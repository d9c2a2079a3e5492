#!/usr/bin/env python3
"""``read --staging pallas`` at ``chip_smoke.py``'s deployment (48 workers
x 100 MiB, 2 MiB granules, one read a worker) over every card of the host in one process:
worker i lands on ``cuda:(i % cards)``.

    python3 scripts/multicard_read.py          # needs several cards

Each case runs in a process of its own, after a different start: fresh;
after four rank processes that touch no card (``launch.run_ranks``);
after a pod command launched as one NCCL rank a card (``cli.main``
of a small ``stream --validate``). Each reads at ring depth 3 and 1
(``run_read`` with the CLI's sink factory), and prints one JSON line a
read: errors, ``checksum_ok``, ``tb_land`` launches, wall and staged
GB/s. A case that runs past 80 s dumps every thread's stack and fails.
The cases' logs go to ``chiprun_out/multicard_read/``; the last line is
the card's name and power limit.
"""

from __future__ import annotations

import faulthandler
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "chiprun_out", "multicard_read")
CASES = ("fresh", "after_trivial_ranks", "after_nccl_launch")


def case(name: str) -> None:
    faulthandler.dump_traceback_later(80, exit=True)
    import chip_smoke as cs
    from tpubench_torch.dist.launch import run_ranks
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    cs.phase_build()
    store = cs.populate()
    if name == "after_trivial_ranks":
        res = run_ranks([[sys.executable, "-c", "pass"]] * 4,
                        [f"{OUT}/trivial{r}.log" for r in range(4)])
        cs.check(res.ok, f"trivial ranks exited {res.rcs}")
    elif name == "after_nccl_launch":
        from tpubench_torch import cli

        rc = cli.main(["stream", "--protocol", "fake", "--validate",
                       "--objects", "2", "--workers", "2", "--object-size",
                       str(1 << 20), "--results-dir", f"{OUT}/stream"])
        cs.check(rc == 0, f"launched stream exited {rc}")
    for depth in (3, 1):
        _, cfg = cs._cli(["read", "--protocol", "fake", "--workers",
                          str(cs.WORKERS), "--object-size",
                          str(cs.OBJECT_SIZE), "--granule-bytes",
                          str(cs.GRANULE), "--read-call-per-worker", "1",
                          "--staging", "pallas",
                          "--depth", str(depth)])
        landing.reset_launches()
        t0 = time.perf_counter()
        res = run_read(cfg, backend=store, device="cuda",
                       sink_factory=make_sink_factory(cfg, device="cuda"))
        cs.emit({"case": name, "depth": depth, "errors": res.errors,
                 "checksum_ok": res.extra.get("checksum_ok"),
                 "land": landing.land.launches, "wall": res.wall_seconds,
                 "staged_gbps": res.extra.get("staged_gbps"),
                 "seconds": time.perf_counter() - t0})


def main() -> int:
    if len(sys.argv) > 1:
        case(sys.argv[1])
        return 0
    import torch

    if torch.cuda.device_count() < 2:
        print("multicard_read: needs two or more cards", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    rc = 0
    for name in CASES:
        with open(f"{OUT}/{name}.log", "w") as log:
            try:
                code = subprocess.run([sys.executable, __file__, name],
                                      timeout=110, stdout=log,
                                      stderr=subprocess.STDOUT).returncode
            except subprocess.TimeoutExpired:
                code = 124
        with open(f"{OUT}/{name}.log") as log:
            for line in log:
                if line.startswith('{"case"'):
                    print(line, end="", flush=True)
        print(json.dumps({"case": name, "rc": code}), flush=True)
        rc = rc or code
    from tpubench_torch.device import nvidia_smi_line

    print(nvidia_smi_line() or "nvidia-smi: not available", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
