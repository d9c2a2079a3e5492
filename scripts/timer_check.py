#!/usr/bin/env python3
"""How long short sleeps take on this host: what paces an open-loop
arrival schedule (the serve plane's dispatcher).

    python3 scripts/timer_check.py

For requested sleeps of 0.1, 0.3, 1 and 2 ms, 300 ``time.sleep`` calls
each, one JSON line with the mean, median and longest taken (ms); then
0.1 ms again beside 8 threads that sleep 4 ms in a loop (the serve
workers' shape). No device is used.
"""

from __future__ import annotations

import json
import statistics
import threading
import time


def _taken(seconds: float, n: int = 300) -> dict:
    xs = []
    for _ in range(n):
        t = time.perf_counter()
        time.sleep(seconds)
        xs.append(time.perf_counter() - t)
    return {"asked_ms": seconds * 1e3, "mean_ms": statistics.mean(xs) * 1e3,
            "p50_ms": statistics.median(xs) * 1e3, "max_ms": max(xs) * 1e3}


def main() -> None:
    for s in (1e-4, 3e-4, 1e-3, 2e-3):
        print(json.dumps(_taken(s)), flush=True)
    stop = threading.Event()

    def sleeper():
        while not stop.is_set():
            time.sleep(0.004)

    threads = [threading.Thread(target=sleeper) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        print(json.dumps({"beside_8_sleepers": True, **_taken(1e-4)}),
              flush=True)
    finally:
        stop.set()
        for t in threads:
            t.join()


if __name__ == "__main__":
    main()
