"""``meta-storm`` — open-loop metadata storms over many small objects (a
copy of ``tpubench/workloads/meta_storm.py``).

The reference's ``list_operation``/``open_file`` binaries measure
metadata closed-loop; this workload drives the arrivals plane
(seeded Poisson/MMPP/diurnal) over a weighted list/stat/open mix so
metadata gets what the serve plane gave reads: offered-vs-achieved rate,
queue-inclusive latency, and — under ``--meta-sweep`` — the
latency-vs-load curve with the saturation knee identified. List ops ride
``maxResults`` pagination (multi-page listings on the wire backends;
the wire gRPC client follows every page here, ROADMAP C.7).

It touches no device, in ``tpubench`` as here; :func:`run_meta_storm`
still resolves its ``device`` as every entry point does, so CUDA asked
for and missing raises.
"""

from __future__ import annotations

import time

from tpubench_torch.config import BenchConfig
from tpubench_torch.device import resolve_device
from tpubench_torch.lifecycle.storm import build_storm_schedule, run_storm
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs.flight import (
    flight_from_config,
    rank_journal_path,
    transport_label,
)
from tpubench_torch.storage import open_backend
from tpubench_torch.storage.base import deterministic_bytes


def populate_meta_objects(backend, prefix: str, count: int,
                          size: int) -> list[str]:
    """The many-small-objects population (idempotent: re-running a storm
    against the same store just overwrites the same names)."""
    names = []
    for i in range(count):
        name = f"{prefix}meta/{i:05d}"
        backend.write(name, deterministic_bytes(name, size).tobytes())
        names.append(name)
    return names


def _storm_point(cfg: BenchConfig, backend, names: list[str],
                 rate_rps: float, flight, tlabel: str,
                 ledger=None) -> dict:
    lc = cfg.lifecycle
    schedule = build_storm_schedule(
        names,
        kind=lc.meta_arrival,
        rate_rps=rate_rps,
        duration_s=lc.meta_duration_s,
        mix=lc.meta_mix,
        prefix=f"{lc.prefix}meta/",
        seed=lc.seed,
        burst_factor=cfg.serve.burst_factor,
        burst_fraction=cfg.serve.burst_fraction,
        burst_cycle_s=cfg.serve.burst_cycle_s,
        diurnal_period_s=cfg.serve.diurnal_period_s,
    )
    return run_storm(
        backend, schedule,
        workers=lc.meta_workers,
        page_size=lc.meta_page_size,
        read_bytes=lc.meta_read_bytes,
        flight=flight,
        transport_label=tlabel,
        ledger=ledger,
    )


def run_meta_storm(cfg: BenchConfig, backend=None,
                   sweep: bool = False, device="cuda") -> RunResult:
    """One storm at ``lifecycle.meta_rate_rps`` (``sweep``: one a load
    multiplier of ``lifecycle.sweep_points``, and the knee). ``device``
    is resolved (``"cpu"`` runs without CUDA); nothing is staged on it."""
    resolve_device(device)
    lc = cfg.lifecycle
    owns = backend is None
    backend = backend or open_backend(cfg)
    flight = flight_from_config(cfg)
    tlabel = transport_label(cfg)

    # Live telemetry (short workload, same wiring as pod-ingest: the
    # registry taps every meta record; `top` can watch).
    from tpubench_torch.obs.telemetry import telemetry_from_config

    jpath = (
        rank_journal_path(cfg)
        if cfg.obs.flight_journal else None
    )
    tel = telemetry_from_config(cfg)
    if tel is not None:
        tel.resource["workload"] = "meta_storm"
        if flight is not None:
            tel.attach_flight(flight)
            if jpath:
                tel.stream_journal(
                    flight, jpath,
                    extra_fn=lambda: {"workload": "meta_storm"},
                    max_bytes=cfg.obs.journal_max_bytes,
                )
        tel.start()

    import contextlib

    try:
        t0 = time.perf_counter()
        names = populate_meta_objects(
            backend, lc.prefix, lc.meta_objects, lc.meta_object_bytes
        )
        with (flight.activate() if flight is not None
              else contextlib.nullcontext()):
            if sweep:
                points = []
                for mult in lc.sweep_points:
                    out = _storm_point(
                        cfg, backend, names, lc.meta_rate_rps * mult,
                        flight, tlabel,
                    )
                    points.append({
                        "multiplier": mult,
                        "offered_rps": out["offered_rps"],
                        "achieved_rps": out["achieved_rps"],
                        "p50_ms": out["p50_ms"],
                        "p99_ms": out["p99_ms"],
                        "errors": out["errors"],
                        "completed": out["completed"],
                    })
                from tpubench_torch.serve.qos import find_knee

                last = out
                lifecycle = {
                    "op": "meta_storm",
                    "objects": lc.meta_objects,
                    "mix": lc.meta_mix,
                    "arrival": lc.meta_arrival,
                    "page_size": lc.meta_page_size,
                    "sweep": {
                        "points": points,
                        "knee": find_knee(points),
                    },
                    **{k: last[k] for k in (
                        "ops", "completed", "errors", "bytes",
                        "list_items", "sleep_scale",
                    )},
                }
                total_bytes = last["bytes"]
                errors = sum(p["errors"] for p in points)
            else:
                out = _storm_point(
                    cfg, backend, names, lc.meta_rate_rps, flight, tlabel
                )
                lifecycle = {
                    "op": "meta_storm",
                    "objects": lc.meta_objects,
                    "mix": lc.meta_mix,
                    "arrival": lc.meta_arrival,
                    "page_size": lc.meta_page_size,
                    **out,
                }
                total_bytes = out["bytes"]
                errors = out["errors"]
        wall = time.perf_counter() - t0
    finally:
        if tel is not None:
            tel_summary = tel.close()
        if owns:
            backend.close()

    res = RunResult(
        workload="meta_storm",
        config=cfg.to_dict(),
        bytes_total=total_bytes,
        wall_seconds=wall,
        gbps=(total_bytes / 1e9) / wall if wall > 0 else 0.0,
        errors=errors,
    )
    res.extra["lifecycle"] = lifecycle
    if tel is not None and tel_summary is not None:
        res.extra["telemetry"] = tel_summary
    if flight is not None:
        res.extra["flight"] = flight.summary()
        if jpath:
            res.extra["flight_journal"] = flight.write_journal(
                jpath, extra={"workload": "meta_storm"},
                max_bytes=cfg.obs.journal_max_bytes,
            )
    return res
