#!/usr/bin/env python3
"""First byte with and without the flight recorder, in both packages.

    JAX_PLATFORMS=cpu python3 scripts/recorder_first_byte.py [--rounds 3]
    python3 scripts/recorder_first_byte.py --packages port --device cuda \
        --object-size 104857600     # the port alone, on the card

Runs ``read`` of ``tpubench`` (JAX on the CPU) and of ``tpubench_torch``
(PyTorch on the CPU) on the fake backend with 48 workers, one read each,
staging ``device_put`` at depth 3 — the mode in which the port's
first-byte p50 rose about twentyfold with the recorder on the card — with
``obs.flight_records`` at its default (recorder on) and at 0 (off), and
on with each worker thread's trace-id RNG seeded before its read starts
("primed": a thread's first flight record otherwise seeds it from
``os.urandom``, a system call that lets go of the interpreter lock
between the read's t0 and its first byte). The six configurations run in
turns, ``--rounds`` times, the order reversed every other round. Prints
one JSON line per run (first-byte p50/p99 in ms, read p50, wall) and last
the medians per configuration and their first-byte ratios to "off".

The reference begins a read's flight record between its t0 and its first
byte (``tpubench/workloads/read.py:230-237``), as the port does; if both
packages show the rise, it is the reference's property, reproduced.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

WORKERS = 48
GRANULE = 2 * 1024 * 1024
# Set by main(): the object size and the port's device.
OBJECT_SIZE = 8 * 1024 * 1024 + 123
DEVICE = "cpu"


def _config(cls, flight: bool):
    cfg = cls()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = WORKERS
    cfg.workload.read_calls_per_worker = 1
    cfg.workload.object_size = OBJECT_SIZE
    cfg.workload.granule_bytes = GRANULE
    cfg.staging.mode = "device_put"
    cfg.staging.depth = 3
    if not flight:
        cfg.obs.flight_records = 0
    return cfg


def _primed(factory, id_rng):
    """The sink factory (called in each worker's thread before its first
    read's t0), made to seed the thread's trace-id RNG first."""
    def make(i):
        id_rng()
        return factory(i)

    return make


def run_jax(flight: bool, primed: bool = False):
    from tpubench.config import BenchConfig
    from tpubench.obs.tracing import _id_rng
    from tpubench.staging.device import make_sink_factory
    from tpubench.workloads.read import run_read

    cfg = _config(BenchConfig, flight)
    factory = make_sink_factory(cfg)
    return run_read(cfg, sink_factory=_primed(factory, _id_rng) if primed
                    else factory)


def run_port(flight: bool, primed: bool = False):
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.obs.tracing import _id_rng
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    cfg = _config(BenchConfig, flight)
    factory = make_sink_factory(cfg, device=DEVICE)
    return run_read(cfg, device=DEVICE,
                    sink_factory=_primed(factory, _id_rng) if primed
                    else factory)


# (package, recorder): "on", "off", or "primed" — on, with each worker
# thread's trace-id RNG seeded before its read starts.
RUNS = {
    (pkg, mode): (lambda run=run, mode=mode: run(mode != "off", mode == "primed"))
    for pkg, run in (("jax", run_jax), ("port", run_port))
    for mode in ("on", "off", "primed")
}


def main() -> int:
    global OBJECT_SIZE, DEVICE
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--packages", default="jax,port",
                    help="comma-separated: jax (on the CPU), port")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu",
                    help="the port's device")
    ap.add_argument("--object-size", type=int, default=OBJECT_SIZE)
    args = ap.parse_args()
    OBJECT_SIZE, DEVICE = args.object_size, args.device
    packages = args.packages.split(",")
    if "jax" in packages:
        import jax

        jax.config.update("jax_platforms", "cpu")
    order = [k for k in RUNS if k[0] in packages]
    samples: dict = {k: [] for k in order}
    for r in range(args.rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            res = RUNS[key]()
            fb, rd = res.summaries["first_byte"], res.summaries["read"]
            line = {"package": key[0], "recorder": key[1], "round": r,
                    "errors": res.errors,
                    "first_byte_p50_ms": fb.p50_ms, "first_byte_p99_ms": fb.p99_ms,
                    "read_p50_ms": rd.p50_ms, "wall_s": res.wall_seconds}
            samples[key].append(line)
            print(json.dumps(line), flush=True)
    med = {
        f"{p}/{m}": {
            k: statistics.median(s[k] for s in samples[(p, m)])
            for k in ("first_byte_p50_ms", "first_byte_p99_ms", "read_p50_ms")
        }
        for p, m in order
    }
    ratio = {
        f"{p}/{m}": {k: med[f"{p}/{m}"][k] / med[f"{p}/off"][k]
                     for k in ("first_byte_p50_ms", "first_byte_p99_ms")}
        for p in packages for m in ("on", "primed")
    }
    print(json.dumps({"median": med, "over_recorder_off": ratio,
                      "workers": WORKERS, "object_size": OBJECT_SIZE,
                      "port_device": DEVICE}))
    if DEVICE == "cuda":
        from tpubench_torch.device import nvidia_smi_line

        print(nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
