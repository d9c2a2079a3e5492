"""``tune`` — offline coordinate sweeps and online-adaptive tuning
sessions over the ``read`` and ``train-ingest`` workloads
(``tpubench/workloads/tune_cmd.py``).

The reference asserts its operating point (``--worker 48``,
``main.go:36``); this workload *finds* it, two ways:

* **sweep** — a coordinate sweep: one knob axis at a time, each
  candidate a short bounded run, the best cell (by goodput, subject to
  the p99 guardrail against the baseline cell) carried into the next
  axis;
* **online** — one adaptive session: the in-run controller
  (:mod:`tpubench_torch.tune.controller`) moves the knobs live while the
  workload runs, and the convergence trace lands in ``extra["tune"]``;
* **ab** — both, plus the static-vs-adaptive comparison: adaptive
  converged goodput and p99 against the best static cell.

On the read path the knobs are worker fan-out (``workers``), the copy
ring's depth (``staging_depth``) and, with hedging, the hedge delay; on
``train-ingest`` the readahead depth, the prefetch workers, the copy
ring's depth (capped by an explicitly sized slab pool), the hedge delay
and, with the cooperative cache on a request/reply channel, its routing
switch (``coop``) and serve budget (``peer_budget_bytes``). Hermetic when
asked: with ``--protocol http`` and no endpoint,
an in-process fake server (HTTP/1.1, or the h2 server under ``--http2``)
is spawned carrying the config's fault plan. ``--protocol fake`` is
hermetic as usual.

The recommendation is reusable two ways: printed as CLI flags, and
written as a JSON profile (``--tune-profile PATH``, the same format as
``tpubench``'s, so a profile written by either package applies in the
other) that any later run applies with the same flag.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from tpubench_torch.config import BenchConfig, validate_tune_config
from tpubench_torch.device import resolve_device
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.tune.controller import ACTUATED

PROFILE_FORMAT = "tpubench-tune-profile-v1"

# Knob name -> CLI flag string (the human-pasteable recommendation).
_KNOB_FLAGS = {
    "workers": "--workers",
    "readahead": "--readahead",
    "readahead_bytes": "--readahead-bytes",
    "prefetch_workers": "--prefetch-workers",
    "hedge_delay_s": "--hedge-delay",
    "staging_depth": "--staging-depth",
}


def _set_path(cfg: BenchConfig, path: tuple, value) -> None:
    obj = cfg
    for name in path[:-1]:
        obj = getattr(obj, name)
    setattr(obj, path[-1], value)


def _get_path(cfg: BenchConfig, path: tuple):
    obj = cfg
    for name in path:
        obj = getattr(obj, name)
    return obj


def apply_knob_values(cfg: BenchConfig, values: dict) -> None:
    """Apply ``{knob name: value}`` onto a config via the ACTUATED
    registry."""
    for name, v in values.items():
        spec = ACTUATED.get(name)
        if spec is None:
            raise SystemExit(f"tune: unknown knob {name!r} in profile")
        _set_path(cfg, spec["config"], v)


def load_tune_profile(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != PROFILE_FORMAT:
        raise SystemExit(
            f"{path}: not a tune profile (format={doc.get('format')!r}; "
            f"expected {PROFILE_FORMAT!r})"
        )
    return doc


def apply_tune_profile(cfg: BenchConfig, path: str) -> dict:
    """``--tune-profile`` on a normal workload: overlay the profile's
    recommended knob values onto the config. Returns the values."""
    doc = load_tune_profile(path)
    values = doc.get("recommended") or {}
    apply_knob_values(cfg, values)
    return values


def recommended_flags(values: dict) -> str:
    parts = []
    for name, v in sorted(values.items()):
        flag = _KNOB_FLAGS.get(name)
        if flag:
            parts.append(f"{flag} {v:g}" if isinstance(v, float)
                         else f"{flag} {v}")
    return " ".join(parts)


def refuse_workload(workload: str) -> None:
    """``read`` and ``train-ingest`` are tunable; anything else is an
    error."""
    if workload not in ("read", "train-ingest"):
        raise SystemExit(f"tune: unknown workload {workload!r} "
                         "(read|train-ingest)")


# ----------------------------------------------------------- sweep axes ---


def _ladder(around: int, lo: int, hi: int) -> list[int]:
    """Doubling ladder through [lo, hi] that includes ``around``."""
    vals = {max(lo, min(hi, around))}
    v = max(lo, 1)
    while v <= hi:
        vals.add(v)
        v *= 2
    return sorted(vals)


def sweep_axes(cfg: BenchConfig, workload: str) -> dict[str, list]:
    """Candidate values per knob axis (intersected with cfg.tune.knobs),
    derived from the config's own operating point — ``tpubench``'s axes."""
    from tpubench_torch.tune.controller import (
        prefetch_workers_ceiling,
        readahead_ceiling,
        staging_depth_ceiling,
    )

    refuse_workload(workload)
    w, p, s, tail = cfg.workload, cfg.pipeline, cfg.staging, cfg.transport.tail
    axes: dict[str, list] = {}
    if workload == "read":
        if w.workers > 1:
            axes["workers"] = _ladder(w.workers, 1, w.workers)
    else:  # train-ingest
        if p.readahead > 0:
            axes["readahead"] = _ladder(
                p.readahead, 1, readahead_ceiling(p.readahead)
            )
        axes["prefetch_workers"] = _ladder(
            p.prefetch_workers, 1, prefetch_workers_ceiling(p.prefetch_workers)
        )
    if tail.hedge:
        d = tail.hedge_delay_s
        axes["hedge_delay_s"] = sorted({d / 4, d / 2, d, d * 2})
    if s.mode != "none" and s.double_buffer and not p.pod:
        # The ladder the online knob explores (ceiling single-sourced in
        # controller.py): depth 1 is the serial comparator cell, the rest
        # find the overlap knee. An explicitly sized slab pool caps it: a
        # cell past the pool budget would fail validate_pipeline_config
        # inside run_train_ingest and end the sweep.
        pool_cap = (
            p.pool_slabs
            if (workload != "read" and p.slab_pool and p.slab_bytes > 0)
            else 0
        )
        axes["staging_depth"] = _ladder(
            max(1, s.depth), 1,
            staging_depth_ceiling(max(1, s.depth), pool_cap),
        )
    if cfg.coop.enabled and workload != "read" \
            and cfg.coop.channel != "ici":
        # The routing switch is a 2-cell axis (the sweep's answer to "is
        # the peer round-trip worth it on this pod/workload"); a
        # configured serve budget sweeps the same neighborhood the
        # online knob probes (0 = unbounded has no neighborhood). Only
        # train-ingest builds a CoopCache (a read-workload coop axis
        # would sweep identical-noise cells), and lockstep routing is
        # not a knob (see _build_train_ingest_controller).
        axes["coop"] = [0, 1]
        b = cfg.coop.peer_budget_bytes
        if b > 0:
            axes["peer_budget_bytes"] = sorted({b // 2, b, b * 2, b * 4})
    wanted = set(cfg.tune.knobs)
    return {k: v for k, v in axes.items() if k in wanted}


# ------------------------------------------------------------ execution ---


def _run_target(cfg: BenchConfig, workload: str, tracer=None, backend=None,
                device="cuda") -> RunResult:
    """One run of the tuned workload, as its command runs it."""
    refuse_workload(workload)
    if workload == "train-ingest":
        from tpubench_torch.workloads.train_ingest import run_train_ingest

        return run_train_ingest(cfg, backend=backend, device=device)
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    return run_read(cfg, backend=backend, device=device, tracer=tracer,
                    sink_factory=make_sink_factory(cfg, device=device))


def _cell_stats(res: RunResult) -> dict:
    s = res.summaries.get("read")
    return {
        "goodput_bps": res.gbps * 1e9,
        "p99_ms": s.p99_ms if s is not None else None,
        "wall_s": res.wall_seconds,
        "errors": res.errors,
    }


def _clone(cfg: BenchConfig) -> BenchConfig:
    return BenchConfig.from_dict(cfg.to_dict())


def run_sweep(cfg: BenchConfig, workload: str, before_run=None,
              backend=None, device="cuda") -> dict:
    """Offline coordinate sweep: baseline cell at the config's own
    operating point, then one axis at a time, carrying the best
    admissible cell's value forward. A cell whose p99 exceeds the
    guardrail (vs the baseline cell) is recorded but never selected.
    ``before_run`` fires before every cell (the hermetic fault plan's
    per-run re-arm); ``backend`` and ``device`` go to every cell's run."""
    tc = cfg.tune
    axes = sweep_axes(cfg, workload)
    current: dict = {
        name: _get_path(cfg, ACTUATED[name]["config"]) for name in axes
    }
    cells: list[dict] = []

    def run_cell(values: dict) -> dict:
        c = _clone(cfg)
        c.tune.enabled = False
        # One short cell per knob value: a dozen bind/teardown cycles of
        # the telemetry HTTP endpoint (and OTLP flush loops) are churn,
        # not signal — the plane stays on for the ONLINE/adaptive arm,
        # which is the long-lived run `tpubench top` watches.
        c.telemetry.enabled = False
        c.telemetry.port = -1
        c.telemetry.otlp = False
        apply_knob_values(c, values)
        if before_run is not None:
            before_run()
        t0 = time.monotonic()
        res = _run_target(c, workload, backend=backend, device=device)
        cell = {
            "values": dict(values),
            **_cell_stats(res),
            "sweep_wall_s": time.monotonic() - t0,
        }
        cells.append(cell)
        return cell

    base = run_cell(dict(current))
    base_p99 = base["p99_ms"]
    best = base

    def admissible(cell: dict) -> bool:
        if cell["errors"]:
            return False
        if base_p99 and cell["p99_ms"]:
            return cell["p99_ms"] <= tc.p99_guard * base_p99
        return True

    for name, candidates in axes.items():
        axis_best = best
        for v in candidates:
            if v == current[name]:
                continue
            cell = run_cell({**current, name: v})
            if admissible(cell) and (
                cell["goodput_bps"] > axis_best["goodput_bps"]
            ):
                axis_best = cell
        best = axis_best
        current = dict(best["values"])
    return {
        "axes": {k: list(v) for k, v in axes.items()},
        "cells": cells,
        "baseline": base,
        "best": best,
        "guard": {"p99_guard": tc.p99_guard, "baseline_p99_ms": base_p99},
    }


def run_tune(
    cfg: BenchConfig,
    mode: str = "online",
    workload: str = "read",
    profile_path: str = "",
    tracer=None,
    backend=None,
    device="cuda",
) -> RunResult:
    """The ``tune`` entry point (module docstring). ``tracer`` instruments
    the online (adaptive) arm only; sweep cells stay untraced. ``backend``
    (a store the caller keeps open) serves every run instead of one
    opened per run; ``device`` is where every run stages (``"cpu"`` runs
    the plain kernels without CUDA)."""
    resolve_device(device)
    refuse_workload(workload)
    validate_tune_config(cfg.tune)
    if mode not in ("sweep", "online", "ab"):
        raise SystemExit(f"tune: unknown mode {mode!r} (sweep|online|ab)")

    # Hermetic server: --protocol http with no endpoint spawns the
    # in-process fake server carrying the config's fault plan.
    server = None
    plan = None
    endpoint_restore = cfg.transport.endpoint
    try:
        if (cfg.transport.protocol == "http" and not cfg.transport.endpoint
                and backend is None):
            from tpubench_torch.storage import fault_plan
            from tpubench_torch.workloads.chaos import spawn_hermetic_server

            plan = fault_plan(cfg)
            if plan is not None:
                plan.arm()
            server = spawn_hermetic_server(cfg, fault_plan=plan)

        def rearm() -> None:
            # Time-phased fault schedules are relative to a run's start:
            # re-arm before every target run, or only the earliest sweep
            # cells would see the fault window.
            if plan is not None:
                plan.arm()

        tune_extra: dict = {"mode": mode, "workload": workload}
        adaptive_res: Optional[RunResult] = None
        if mode in ("sweep", "ab"):
            tune_extra["sweep"] = run_sweep(
                cfg, workload, before_run=rearm, backend=backend,
                device=device,
            )
        if mode in ("online", "ab"):
            c = _clone(cfg)
            c.tune.enabled = True
            rearm()
            adaptive_res = _run_target(c, workload, tracer=tracer,
                                       backend=backend, device=device)
            tune_extra["adaptive"] = adaptive_res.extra.get("tune") or {
                "enabled": False,
                "note": "workload had no live-actuatable knobs",
            }
            tune_extra["adaptive_run"] = _cell_stats(adaptive_res)

        # The recommendation: the adaptive session's converged point
        # when one ran, else the sweep's best cell.
        if adaptive_res is not None and tune_extra["adaptive"].get("final"):
            recommended = dict(tune_extra["adaptive"]["final"])
        elif tune_extra.get("sweep"):
            recommended = dict(tune_extra["sweep"]["best"]["values"])
        else:
            recommended = {}
        tune_extra["recommended"] = recommended
        tune_extra["recommended_flags"] = recommended_flags(recommended)

        if mode == "ab" and tune_extra.get("sweep"):
            best = tune_extra["sweep"]["best"]
            ad = tune_extra["adaptive"]
            ad_good = (
                ad.get("converged_goodput_bps")
                or tune_extra["adaptive_run"]["goodput_bps"]
            )
            ab = {
                "static_best_values": best["values"],
                "static_best_goodput_bps": best["goodput_bps"],
                "static_best_p99_ms": best["p99_ms"],
                "adaptive_values": recommended,
                "adaptive_goodput_bps": ad_good,
                "adaptive_p99_ms": (
                    ad.get("converged_p99_ms")
                    or tune_extra["adaptive_run"]["p99_ms"]
                ),
            }
            if best["goodput_bps"]:
                ab["goodput_vs_static_best"] = (
                    ad_good / best["goodput_bps"] if ad_good else None
                )
            tune_extra["ab"] = ab

        if profile_path:
            doc = {
                "format": PROFILE_FORMAT,
                "workload": workload,
                "mode": mode,
                "recommended": recommended,
                "flags": tune_extra["recommended_flags"],
                "created": time.time(),
            }
            with open(profile_path, "w") as f:
                json.dump(doc, f, indent=2)
            tune_extra["profile"] = profile_path

        # The RunResult: the adaptive run's numbers when one ran (the
        # session IS a run), else a thin carrier for the sweep table.
        if adaptive_res is not None:
            res = adaptive_res
            res.workload = "tune"
        else:
            best = tune_extra["sweep"]["best"]
            res = RunResult(
                workload="tune",
                config=cfg.to_dict(),
                gbps=best["goodput_bps"] / 1e9,
                summaries={},
            )
        res.extra["tune"] = tune_extra
        return res
    finally:
        if server is not None:
            server.stop()
        cfg.transport.endpoint = endpoint_restore


# -------------------------------------------------------------- rendering --


def format_tune_block(tune: dict) -> str:
    """Human rendering of a tune result's ``extra["tune"]`` (printed by
    the CLI and by ``report``): convergence trace summary,
    sweep table, recommendation, and the static-vs-adaptive delta."""
    lines = [f"== tune ({tune.get('mode', '?')} over "
             f"{tune.get('workload', '?')}) =="]
    sweep = tune.get("sweep")
    if sweep:
        lines.append("  static sweep (goodput GB/s @ p99 ms):")
        for cell in sweep.get("cells", ()):
            vals = " ".join(
                f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in sorted(cell["values"].items())
            )
            p99 = cell.get("p99_ms")
            lines.append(
                f"    {vals:<40} {cell['goodput_bps'] / 1e9:.4f} GB/s @ "
                + (f"{p99:.2f} ms" if p99 is not None else "n/a")
            )
        best = sweep.get("best", {})
        lines.append(
            f"  best static cell: {best.get('values')} "
            f"({best.get('goodput_bps', 0) / 1e9:.4f} GB/s)"
        )
    ad = tune.get("adaptive")
    if ad and ad.get("enabled"):
        conv = ad.get("windows_to_converge")
        lines.append(
            "  adaptive: "
            + (f"converged in {conv} windows" if ad.get("converged")
               else f"NOT converged ({ad.get('n_windows', 0)} windows)")
            + f"  accepts={ad.get('accepts', 0)}"
              f" reverts={ad.get('reverts', 0)}"
              f" guard_violations={ad.get('guard_violations', 0)}"
        )
        lines.append(
            f"    operating point: {ad.get('initial')} -> {ad.get('final')}"
        )
        cg = ad.get("converged_goodput_bps")
        cp = ad.get("converged_p99_ms")
        if cg is not None:
            lines.append(
                f"    converged goodput: {cg / 1e9:.4f} GB/s"
                + (f"  p99 {cp:.2f} ms" if cp is not None else "")
            )
    ab = tune.get("ab")
    if ab:
        ratio = ab.get("goodput_vs_static_best")
        lines.append(
            "  static-vs-adaptive: adaptive "
            f"{(ab.get('adaptive_goodput_bps') or 0) / 1e9:.4f} GB/s vs "
            f"best static {(ab.get('static_best_goodput_bps') or 0) / 1e9:.4f}"
            f" GB/s"
            + (f" ({ratio:.3f}x)" if ratio is not None else "")
        )
        sp, ap = ab.get("static_best_p99_ms"), ab.get("adaptive_p99_ms")
        if sp is not None and ap is not None:
            lines.append(
                f"    p99 delta: adaptive {ap:.2f} ms vs static {sp:.2f} ms "
                f"({ap - sp:+.2f} ms)"
            )
    rec = tune.get("recommended")
    if rec:
        lines.append(f"  recommended: {rec}")
        if tune.get("recommended_flags"):
            lines.append(f"    flags: {tune['recommended_flags']}")
        if tune.get("profile"):
            lines.append(
                f"    profile: {tune['profile']} "
                "(reuse: --tune-profile <path>)"
            )
    return "\n".join(lines)
