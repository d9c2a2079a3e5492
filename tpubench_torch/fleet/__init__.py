"""Virtual-time fleet engine (``fleet``), a copy of ``tpubench``'s.

The hermetic serve harness pays wall-clock per host thread — a 4-host
elastic pod is the practical ceiling. This package replaces the threads
with a discrete-event scheduler running on the injectable-clock seam the
serve, qos, arrivals and membership planes already expose (the
determinism pass of ``check`` holds them to it), so the SAME admission
queue, membership state machine, consistent-hash ring and scorecard math
run at 64–4096 simulated hosts in seconds of wall time. It touches no
device.

* :mod:`tpubench_torch.fleet.vtime` — the event-heap scheduler and the
  ``Clock`` surface that drop-in replaces ``time.monotonic`` /
  ``perf_counter_ns`` style injectables.
* :mod:`tpubench_torch.fleet.calibrate` — per-phase service-time
  distributions fitted from flight journals (``--calibrate-from``),
  round-tripped through ``--fleet-profile`` JSON.
* :mod:`tpubench_torch.fleet.driver` — the fleet workload: multi-pod
  topologies, correlated-failure / rolling-upgrade timelines, scored
  by the real ``serve_scorecard`` / ``membership_scorecard``.
"""

from tpubench_torch.fleet.vtime import EventLoop, VirtualClock  # noqa: F401
