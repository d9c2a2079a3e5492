#!/usr/bin/env python3
"""What a live staging-depth grow costs on the card: page-locked slot
allocation, alone and under the read path's load.

    python3 scripts/pinned_grow.py [--rings 48] [--grow 3]

A grow of the ``staging_depth`` tune knob from 3 to 6 adds 3 page-locked
slots of 7,456,640 B (the copy ring's slot at 48 workers, 2 MiB granules
and a 1024 MiB host budget) to each of 48 rings, on the controller's
thread, while the workers fetch and copy. This script allocates the same
slots with :func:`tpubench_torch.staging.device.new_slot`, one call per
slot, in two shapes — ``serial``, every slot from one thread (the
controller's fan-out), and ``parallel``, one thread per ring allocating
its own — under three loads: an idle process; 48 threads copying
host→device on their own CUDA streams and polling each copy's event from
Python every 0.2 ms (the copy ring's reapers); and the port's ``read``
itself (fake store, 48 workers × 100 MiB objects, 2 MiB granules, copy
ring at depth 3, three reads a worker), the allocation starting 1 s into
it. Each case prints one JSON line: seconds in all and milliseconds per
slot. Every allocation
stays alive to the end, so none is served from PyTorch's host cache. The
last line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SLOT_BYTES, LANE = 7_456_640, 128


def _copy(stop: threading.Event, device, i: int) -> None:
    import torch

    from tpubench_torch.device import on_stream, record_event, worker_stream
    from tpubench_torch.staging.device import new_slot

    stream = worker_stream(device, i)
    src = new_slot((SLOT_BYTES // LANE, LANE), device.type == "cuda")
    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
    while not stop.is_set():
        with on_stream(stream):
            dst.copy_(src, non_blocking=True)
            ev = record_event(stream)
        while not ev.query():
            time.sleep(0.0002)  # the reaper's poll tick


def _alloc(shape: str, rings: int, grow: int, pinned: bool) -> list:
    from tpubench_torch.staging.device import new_slot

    def ring(out: list) -> None:
        out.extend(new_slot((SLOT_BYTES // LANE, LANE), pinned)
                   for _ in range(grow))

    if shape == "serial":
        slots: list = []
        for _ in range(rings):
            ring(slots)
        return slots
    per_ring = [[] for _ in range(rings)]
    threads = [threading.Thread(target=ring, args=(out,)) for out in per_ring]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [s for out in per_ring for s in out]


def _read(store, rings: int, device) -> threading.Thread:
    """The port's read at the main path's deployment, in the background."""
    from tpubench_torch import cli
    from tpubench_torch.config import BenchConfig

    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = rings
    cfg.workload.read_calls_per_worker = 3
    cfg.workload.object_size = 100 << 20
    cfg.obs.export = "none"
    errors: list = []

    def run() -> None:
        try:
            cli.read(cfg, device=device, backend=store)
        except BaseException as e:  # raised by the caller after the join
            errors.append(e)

    t = threading.Thread(target=run)
    t.errors = errors
    t.start()
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rings", type=int, default=48)
    ap.add_argument("--grow", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu rehearses the script (slots not page-locked)")
    args = ap.parse_args()

    import torch

    from tpubench_torch.device import nvidia_smi_line, resolve_device

    device = resolve_device(args.device)
    pinned = device.type == "cuda"
    torch.zeros(1, device=device)  # context up before any timing
    from tpubench_torch.storage.fake import FakeBackend

    store = FakeBackend.prepopulated("tpubench/file_", args.rings, 100 << 20)
    keep = []
    for load in ("idle", "copy", "read"):
        for shape in ("serial", "parallel"):
            stop = threading.Event()
            if load == "copy":
                threads = [threading.Thread(target=_copy,
                                            args=(stop, device, i))
                           for i in range(args.rings)]
                for t in threads:
                    t.start()
                time.sleep(2.0)  # every thread under way
            elif load == "read":
                threads = [_read(store, args.rings, device)]
                time.sleep(1.0)  # the fetch under way
            else:
                threads = []
            t0 = time.perf_counter()
            slots = _alloc(shape, args.rings, args.grow, pinned)
            took = time.perf_counter() - t0
            read_left = threads[0].is_alive() if load == "read" else None
            stop.set()
            for t in threads:
                t.join()
                for e in getattr(t, "errors", ()):
                    raise e
            if pinned and not all(s.is_pinned() for s in slots):
                raise RuntimeError(f"{load}/{shape}: a slot is not page-locked")
            keep.append(slots)
            print(json.dumps({
                "load": load, "shape": shape, "slots": len(slots),
                "bytes": len(slots) * SLOT_BYTES, "seconds": took,
                "ms_per_slot": 1e3 * took / len(slots),
                "read_still_running": read_left,
            }), flush=True)
    print(nvidia_smi_line() or "nvidia-smi: not available", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
