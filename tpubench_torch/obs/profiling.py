"""Profiler capture around workload runs (``tpubench/obs/profiling.py``):
``torch.profiler`` where the reference uses ``jax.profiler``.

:func:`maybe_profile` traces the enclosed run — host ops on every thread,
and on CUDA the card's kernels and copies and the host's waits on them —
and writes a Chrome trace
(``trace_<pid>_<ms>.json``) into the directory, readable in Perfetto or
``chrome://tracing``. :func:`annotate` names a host region in the trace
(``record_function``) and, on the card, an NVTX range.
:func:`trace_summary` reads a written trace back: event counts by kind,
kernel launches by name, and the device's busy share over the traced
window.

A trace of a CUDA run with no device event in it (the profiler could not
attach to the card: CUPTI permissions) is an error, not an empty trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import torch

# Chrome-trace categories of work on the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class ProfileCapture:
    """What one :func:`maybe_profile` block wrote: the trace's path, and
    after the block, :func:`trace_summary` of it."""

    def __init__(self, profile_dir: str):
        self.dir = profile_dir
        self.path: Optional[str] = None
        self.summary: Optional[dict] = None


def _profiler(cuda: bool):
    """A ``torch.profiler.profile`` of host ops on every thread (the
    workers fetch and stage off the main thread) and, on CUDA, of the
    card's work and of host waits on it (``cuda_sync`` events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=acts,
        experimental_config=torch.profiler._ExperimentalConfig(
            profile_all_threads=True, enable_cuda_sync_events=cuda,
        ),
    )


def _trace_path(profile_dir: str) -> str:
    os.makedirs(profile_dir, exist_ok=True)
    return os.path.join(
        profile_dir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"
    )


def _export(prof, profile_dir: str, cuda: bool) -> tuple[str, dict]:
    path = _trace_path(profile_dir)
    prof.export_chrome_trace(path)
    summary = trace_summary(path)
    if cuda and not summary["device_events"]:
        raise RuntimeError(
            f"torch.profiler recorded no CUDA event in {path}: the profiler "
            "could not trace the card (CUPTI permissions?)"
        )
    return path, summary


@contextlib.contextmanager
def maybe_profile(profile_dir: str,
                  device="cuda") -> Iterator[Optional[ProfileCapture]]:
    """Trace the enclosed run into ``profile_dir`` (host activity, plus
    the card's on a ``cuda`` device); a no-op yielding ``None`` when the
    directory is empty."""
    if not profile_dir:
        yield None
        return
    cuda = torch.device(device).type == "cuda"
    cap = ProfileCapture(profile_dir)
    with _profiler(cuda) as prof:
        yield cap
    cap.path, cap.summary = _export(prof, profile_dir, cuda)


def parse_profile_steps(spec: str) -> tuple[int, int] | None:
    """``obs.profile_steps`` "N:M" → (N, M) inclusive step window, None
    when empty. Malformed specs fail at parse time with a one-line
    SystemExit."""
    if not spec:
        return None
    parts = spec.split(":")
    try:
        if len(parts) != 2:
            raise ValueError
        lo, hi = int(parts[0]), int(parts[1])
    except ValueError:
        raise SystemExit(
            f"obs.profile_steps={spec!r}: expected \"N:M\" "
            "(inclusive step window, e.g. 2:5)"
        ) from None
    if lo < 0 or hi < lo:
        raise SystemExit(
            f"obs.profile_steps={spec!r}: must satisfy 0 <= N <= M"
        )
    return lo, hi


class StepProfiler:
    """Step-windowed capture for a step loop: the trace starts when the
    step counter enters [start, stop] and stops when it leaves — a steady
    slice instead of warm-up steps.

    A profiler that cannot start or stop (a second trace already active)
    is recorded in :meth:`info`, not raised: the run must not fail because
    its observer could not attach."""

    def __init__(self, profile_dir: str, start_step: int, stop_step: int,
                 device="cuda"):
        self.dir = profile_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self.active = False
        self.captured = False
        self.error: str | None = None
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None

    def on_step_begin(self, step: int) -> None:
        if (not self.dir or self.active or self.captured
                or step != self.start_step):
            return
        try:
            self._prof = _profiler(self._cuda)
            self._prof.start()
            self.active = True
        except Exception as e:  # noqa: BLE001 — observer must not kill the run
            self.error = f"{type(e).__name__}: {e}"

    def on_step_end(self, step: int) -> None:
        if self.active and step >= self.stop_step:
            self._stop()

    def close(self) -> None:
        """Stop a still-open capture (short runs whose stop step never
        arrived) so the trace file is complete."""
        if self.active:
            self._stop()

    def _stop(self) -> None:
        try:
            self._prof.stop()
            _export(self._prof, self.dir, self._cuda)
            self.captured = True
        except Exception as e:  # noqa: BLE001
            self.error = f"{type(e).__name__}: {e}"
        self.active = False

    def info(self) -> dict | None:
        """The ``extra["profile"]`` stamp; None when profiling is off."""
        if not self.dir:
            return None
        out = {
            "dir": self.dir,
            "steps": [self.start_step, self.stop_step],
            "captured": self.captured,
        }
        if self.error:
            out["error"] = self.error
        return out


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named host region in a trace (``record_function``) and, when CUDA
    is initialised, an NVTX range; costs a few microseconds outside a
    trace."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def hot_region(name: str):
    """:func:`annotate` while a ``torch.profiler`` trace records, else
    nothing: for regions entered per transfer on every fetch thread, which
    an unprofiled run must not pay for."""
    if torch.autograd.profiler._is_profiler_enabled:
        return annotate(name)
    return contextlib.nullcontext()


def _union_us(spans: list) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace_summary(path: str) -> dict:
    """A Chrome trace written by :func:`maybe_profile`, summed: events by
    category, device events, kernel launches by name, the host regions
    :func:`annotate` named (count and total µs over every thread), the
    traced window (first to last complete event, µs) and the device's busy
    share — the union of kernel, memcpy and memset intervals over that
    window."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    by_cat: dict = {}
    kernels: dict = {}
    regions: dict = {}
    device: list = []
    lo, hi = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev.get("ts", 0)), float(ev.get("dur", 0))
        by_cat[cat] = by_cat.get(cat, 0) + 1
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur))
            if cat == "kernel":
                kernels[name] = kernels.get(name, 0) + 1
        elif cat == "user_annotation":
            r = regions.setdefault(name, {"count": 0, "total_us": 0.0})
            r["count"] += 1
            r["total_us"] += dur
    window = hi - lo if hi > lo else 0.0
    busy = _union_us(device)
    return {
        "events_by_category": by_cat,
        "device_events": len(device),
        "kernels": kernels,
        "regions": regions,
        "window_us": window,
        "device_busy_us": busy,
        "device_busy_share": busy / window if window > 0 else 0.0,
    }
