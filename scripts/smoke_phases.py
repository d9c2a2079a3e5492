#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases alone: on one GPU, or for phases
pod_cards and hosts on every GPU of the host (one rank a card; hosts: two
hosts of half the cards each).

    python3 scripts/smoke_phases.py --phases serve,chaos,drill,fleet,check
    python3 scripts/smoke_phases.py --phases pod_cards   # every card
    python3 scripts/smoke_phases.py --phases hosts       # 2 hosts x n/2

Builds the kernels (phase build), makes phase read's store (48 x 100 MiB)
when serve, chaos, drill or pod_cards is asked for and phase pod's (one
1 GiB object) for chaos and pod_cards, and for hosts on several cards,
then runs the phases named, in
the order given, with every
check ``chip_smoke.py`` makes; each prints its JSON lines as there. A phase that needs another phase's state is not
offered. The last lines are the launch counts by path, the seconds taken
and the card's name and power limit. A quick way to try a phase on the
card before the whole script runs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("serve", "chaos", "drill", "fleet", "check", "pod_cards", "hosts")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {','.join(PHASES)}")
    names = ap.parse_args().phases.split(",")
    unknown = sorted(set(names) - set(PHASES))
    if unknown:
        ap.error(f"unknown phase(s) {unknown}; have {','.join(PHASES)}")

    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases: CUDA is not available", file=sys.stderr)
        return 1
    from tpubench_torch.device import nvidia_smi_line
    from tpubench_torch.storage.fake import FakeBackend

    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    cs.phase_build()
    store = (cs.populate() if {"serve", "chaos", "drill", "pod_cards"}
             & set(names) else None)
    several = torch.cuda.device_count() >= 2
    pod_store = (FakeBackend.prepopulated("tpubench/file_", 1, cs.POD_OBJECT)
                 if {"chaos", "pod_cards"} & set(names)
                 or ("hosts" in names and several) else None)
    counts = {}
    for name in names:
        if name == "serve":
            counts.update(cs.phase_serve(store, smi))
        elif name == "drill":
            counts.update(cs.phase_drill(store, smi))
        elif name == "fleet":
            counts.update(cs.phase_fleet(smi))
        elif name == "check":
            counts.update(cs.phase_check(smi))
        elif name == "pod_cards":
            counts.update(cs.phase_pod_cards(pod_store, store, smi))
        elif name == "hosts":
            counts.update(cs.phase_hosts(pod_store, smi))
        else:
            counts.update(cs.phase_chaos(store, pod_store, smi))
    cs.emit({"launches": counts, "seconds": time.perf_counter() - t0})
    print(smi or "nvidia-smi: not available", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
