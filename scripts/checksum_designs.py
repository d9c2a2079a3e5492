#!/usr/bin/env python3
"""Time the designs tried for the checksum kernel ``tb_checksum`` on one GPU.

    python3 scripts/checksum_designs.py [--seed 0] [--out designs.jsonl]

Builds ``scripts/checksum_designs.cu`` (the port's ``landing.cu`` plus the
alternatives it describes) with nvcc, checks every design bit-exact against
``checksum_reference`` from a random starting accumulator at the main-path
slot (58,255×128 B) and at the edges of the split, then times each design
at ``chip_smoke.py``'s sweep sizes exactly as ``chip_smoke.py`` times a
kernel (``_time_ms``: 200 launches queued behind a sleep, inputs rotating
beyond the L2 cache) and fits ``t(n) = t0 + n / B``. The two floors (no
reads) are timed the same way and not checked. The sizes are timed
in turn, every design at one size before the next size. Prints one JSON
line per design, then the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# (name, index in checksum_designs.cu's switch, blocks per SM). The first
# is the shipped kernel (``tb_checksum``); the plan's blocks per SM are
# ignored by the grid-stride kernel (grid_for's grid) and the empty floor.
DESIGNS = (
    ("shipped_regs_256x8_2sm_l2hint", 0, 2),
    ("grid_stride_8x256", 1, 8),
    ("bulk_16k_x4_1sm", 2, 1),
    ("bulk_16k_x4_2sm", 2, 2),
    ("bulk_8k_x8_1sm", 3, 1),
    ("bulk_32k_x2_1sm", 4, 1),
    ("bulk_16k_x8_1sm", 5, 1),
    ("regs_256x16_1sm", 6, 1),
    ("regs_512x8_1sm", 7, 1),
    ("regs_512x8_2sm", 7, 2),
    ("regs_1024x4_1sm", 8, 1),
    ("regs_512x8_1sm_l2hint", 9, 1),
    ("regs_256x4_4sm_l2hint", 10, 4),
    ("stride_512x8_1sm", 11, 1),
    ("stride_256x8_2sm", 12, 2),
    ("stride_256x4_4sm", 13, 4),
    ("stride_512x8_1sm_l2hint", 14, 1),
    ("stride_256x4_4sm_l2hint", 15, 4),
    ("stride_256x1_8sm_l2hint", 16, 8),
    ("stride_256x2_8sm_l2hint", 17, 8),
    ("stride_1024x4_1sm_l2hint", 18, 1),
    ("floor_empty_1_block", 19, 1),
    ("floor_atomics_only", 20, 2),
)
FLOORS = ("floor_empty_1_block", "floor_atomics_only")


def load_designs():
    from tpubench_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = build.BUILD_DIR / "libtb_checksum_designs.so"
    src = ROOT / "scripts" / "checksum_designs.cu"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    dll.tbx_checksum.argtypes = [i32, ptr, ptr, i64, i32, i64, ptr]
    dll.tbx_checksum.restype = ctypes.c_int
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--sizes", type=lambda v: [int(n) for n in v.split(",")],
                    default=list(chip_smoke.SWEEP), help="bytes, comma-separated")
    ap.add_argument("--designs", type=lambda v: v.split(","),
                    default=[d[0] for d in DESIGNS], help="names, comma-separated")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("checksum_designs: CUDA is not available", file=sys.stderr)
        return 1
    from tpubench_torch.device import nvidia_smi_line
    from tpubench_torch.kernels import landing

    dll = load_designs()
    sms = landing.sm_count(torch.device("cuda"))

    def launcher(design: int, per_sm: int):
        def run(x, acc):
            blocks, chunk = landing.checksum_plan(x.numel(), sms, per_sm)
            rc = dll.tbx_checksum(design, x.data_ptr(), acc.data_ptr(), x.numel(),
                                  blocks, chunk, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"design {design}: CUDA error {rc}")
        return run

    runs = {name: launcher(d, per_sm) for name, d, per_sm in DESIGNS
            if name in args.designs}
    sizes = {"main_path": chip_smoke.CHECKSUM_ROWS * 128,
             **chip_smoke.checksum_edges(landing.checksum_plan, sms)}
    res = {name: {"design": name, "max_abs_err": 0, "ms": {}, "roofline_share": {}}
           for name in runs}
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    for n in sizes.values():
        x = chip_smoke._random_bytes(torch, n, args.seed + n)
        start = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32,
                              device="cuda", generator=g)
        want = landing.acc_value(landing.checksum_reference(x, start.clone()))
        for name, run in runs.items():
            if name in FLOORS:
                continue
            acc = start.clone()
            run(x, acc)
            got = landing.acc_value(acc)
            err = min((got - want) % chip_smoke.MOD, (want - got) % chip_smoke.MOD)
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
    for n in args.sizes:
        xs = chip_smoke.timing_buffers(torch, n, args.seed)
        acc = landing.new_acc("cuda")
        for name, run in runs.items():
            ms = chip_smoke._time_ms(
                torch, lambda i, run=run: run(xs[i % len(xs)], acc), 200)
            res[name]["ms"][n] = ms
            res[name]["roofline_share"][n] = n / chip_smoke.HBM_BYTES_PER_S * 1e3 / ms
        del xs
    lines = []
    for rec in res.values():
        rec["fit"] = chip_smoke.fit_line(rec["ms"])
        lines.append(json.dumps(rec))
    lines.append(nvidia_smi_line() or "nvidia-smi: not available")
    print("\n".join(lines), flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    bad = {k: v["max_abs_err"] for k, v in res.items() if v["max_abs_err"]}
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
