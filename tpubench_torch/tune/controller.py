"""Online AIMD/hill-climbing controller over live workload knobs — a copy
of ``tpubench/tune/controller.py`` (the same decisions on the same
samples; ``tests/test_torch_tune.py`` holds them equal).

The reference hard-codes its fan-out (``--worker 48``, ``main.go:36``),
yet the operating point depends on the host and the card. This module is
the measurement loop that *finds* the knee of the goodput/p99 curve
during the run, congestion-control style:

* the workload registers :class:`Knob` actuators — live setters for
  worker fan-out (elastic gate / executor admission cap), the staging
  window's depth (:class:`~tpubench_torch.staging.executor.StagerRegistry`)
  and the hedge delay (``HedgedBackend.set_hedge_delay``) — nothing
  restarts;
* a :class:`RecorderSampler` reads windowed goodput and p99 latency
  incrementally off the run's own per-worker
  :class:`~tpubench_torch.metrics.recorder.LatencyRecorder` arrays (the
  ``snapshot_tail_ns`` path the periodic exporter already uses) plus a
  cumulative byte counter;
* :class:`TuneController` probes ONE knob per decision window
  (multiplying knobs double/halve — the slow-start shape; additive
  knobs step by a quantum), accepts a probe only when goodput improves
  by ``epsilon`` AND p99 stays within ``p99_guard`` x the warmup
  baseline, reverts anything else, freezes a knob after
  ``freeze_after_reverts`` unproductive probes (oscillation damping),
  and declares convergence when every knob is frozen at once — after
  which it holds the operating point and stops perturbing (so the
  post-convergence tail is guardrail-clean by construction).

Every decision is appended to ``windows`` (the ``extra["tune"]`` stamp)
and, when a flight ring is supplied, journaled as a ``kind="tune"``
record carrying a ``tune`` note — ``report timeline`` counts them
alongside hedge/stall/breaker events.

Clock, sleep and rng are injectable; tests drive :meth:`step` directly
with a fake sampler and never spin a thread.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Sequence

from tpubench_torch.config import TUNE_KNOBS, TuneConfig

# Knob name -> (config field path, CLI flag dest), as in ``tpubench``:
# profiles and configs name knobs by these keys in both packages.
ACTUATED = {
    "workers": {"config": ("workload", "workers"), "cli": "workers"},
    "readahead": {"config": ("pipeline", "readahead"), "cli": "readahead"},
    "readahead_bytes": {
        "config": ("pipeline", "readahead_bytes"),
        "cli": "readahead_bytes",
    },
    "prefetch_workers": {
        "config": ("pipeline", "prefetch_workers"),
        "cli": "prefetch_workers",
    },
    "hedge_delay_s": {
        "config": ("transport", "tail", "hedge_delay_s"),
        "cli": "hedge_delay",
    },
    "staging_depth": {
        "config": ("staging", "depth"),
        "cli": "staging_depth",
    },
    "peer_budget_bytes": {
        "config": ("coop", "peer_budget_bytes"),
        "cli": "peer_budget_bytes",
    },
    "coop": {
        "config": ("coop", "enabled"),
        "cli": "coop",
    },
}
assert tuple(sorted(ACTUATED)) == tuple(sorted(TUNE_KNOBS))


# Shared knob-range formulas: the offline sweep (tune_cmd.sweep_axes)
# and the online controllers (read.py / train_ingest.py) must explore
# the SAME ranges, or the sweep recommends cells the controller can't
# reach — one definition each, next to the knob registry they belong to.
def readahead_ceiling(readahead: int) -> int:
    return min(64, max(8, 4 * readahead))


def prefetch_workers_ceiling(workers: int) -> int:
    return min(8, max(4, 2 * workers))


def staging_depth_ceiling(depth: int, pool_slabs: int = 0) -> int:
    """In-flight staging-window ceiling: past ~8 pending transfers the
    tunnel is saturated and every extra slot only pins host memory.
    ``pool_slabs`` (when the slab pool is explicitly sized) caps the
    ceiling so neither the sweep ladder nor a live grow probe can drive
    depth past the pool budget validate_pipeline_config enforces."""
    hi = min(8, max(4, 2 * depth))
    if pool_slabs > 0:
        hi = max(1, min(hi, pool_slabs))
    return hi


def hedge_delay_knob(value: float, set_fn) -> "Knob":
    """The hedge-delay knob around the configured delay (x8 both ways,
    floored so a multiplying float knob can always move)."""
    return Knob(
        "hedge_delay_s", value, set_fn,
        lo=max(0.001, value / 8), hi=max(0.002, value * 8),
        mode="mul", integer=False,
    )


class Knob:
    """One live-actuated knob: bounds, a step policy and a setter.

    ``mode="mul"`` knobs probe by doubling/halving (``factor``) — the
    slow-start shape, right for window-like quantities (fan-out,
    readahead depth, byte budgets). ``mode="add"`` knobs step by
    ``step``. Values clamp to [lo, hi]; integer knobs round."""

    __slots__ = ("name", "lo", "hi", "set_fn", "mode", "step", "factor",
                 "integer", "value", "initial")

    def __init__(self, name: str, value, set_fn: Callable, *,
                 lo, hi, mode: str = "mul", step=1, factor: float = 2.0,
                 integer: bool = True):
        if name not in ACTUATED:
            raise ValueError(f"unknown tune knob {name!r}")
        self.name = name
        # Bounds EXPAND to include the configured starting point: the
        # controller's view must match the live operating point, or the
        # first revert would "restore" a clamped value the run never had
        # (e.g. readahead=100 against a derived hi of 64).
        self.lo = min(lo, value)
        self.hi = max(hi, value)
        self.set_fn = set_fn
        self.mode = mode
        self.step = step
        self.factor = factor
        self.integer = integer
        self.value = self._clamp(value)
        self.initial = self.value

    def _clamp(self, v):
        v = min(self.hi, max(self.lo, v))
        return int(round(v)) if self.integer else float(v)

    def candidate(self, direction: int):
        """The probe value one step in ``direction`` (+1/-1), or None
        when already pinned at that bound."""
        if self.mode == "mul":
            v = self.value * self.factor if direction > 0 else (
                self.value / self.factor
            )
            if self.integer:
                # A stuck integer halving (1/2 -> 1) must still move.
                v = self.value + 1 if (direction > 0 and round(v) == self.value) \
                    else v
        else:
            v = self.value + direction * self.step
        v = self._clamp(v)
        return None if v == self.value else v

    def actuate(self, v) -> None:
        self.value = self._clamp(v)
        self.set_fn(self.value)


class RecorderSampler:
    """Windowed goodput/p99 off live recorders + a cumulative bytes fn.

    Reads only the NEW latency samples each window via
    ``snapshot_tail_ns`` (O(new) per window, safe against the owning
    worker's concurrent appends) and diffs the byte counter — the same
    mid-run-safe discipline as the periodic metrics exporter."""

    def __init__(self, recorders: Sequence, bytes_fn: Callable[[], int],
                 clock: Callable[[], float] = time.monotonic):
        self._recorders = list(recorders)
        self._offsets = [0] * len(self._recorders)
        self._bytes_fn = bytes_fn
        self._clock = clock
        self._t_last = clock()
        self._bytes_last = int(bytes_fn())

    def add_recorder(self, rec) -> None:
        self._recorders.append(rec)
        self._offsets.append(0)

    def sample(self) -> dict:
        now = self._clock()
        seconds = max(1e-9, now - self._t_last)
        self._t_last = now
        total = int(self._bytes_fn())
        delta = max(0, total - self._bytes_last)
        self._bytes_last = total
        lats = []
        for i, rec in enumerate(self._recorders):
            arr, self._offsets[i] = rec.snapshot_tail_ns(self._offsets[i])
            if arr.size:
                lats.extend(arr.tolist())
        p99_ms = None
        if lats:
            lats.sort()
            p99_ms = lats[min(len(lats) - 1, int(0.99 * len(lats)))] / 1e6
        return {
            "seconds": seconds,
            "goodput_bps": delta / seconds,
            "p99_ms": p99_ms,
            "reads": len(lats),
        }


class TuneController:
    """The per-run decision loop (module docstring). Construct with the
    workload's knobs + sampler; either call :meth:`step` once per window
    (tests) or :meth:`start`/:meth:`stop` the built-in thread."""

    def __init__(
        self,
        cfg: TuneConfig,
        knobs: Sequence[Knob],
        sampler,
        *,
        clock: Callable[[], float] = time.monotonic,
        rng: Optional[random.Random] = None,
        flight_ring=None,
    ):
        self.cfg = cfg
        self.knobs = list(knobs)
        self.sampler = sampler
        self._clock = clock
        self._rng = rng or random.Random(cfg.seed)
        self._flight = flight_ring
        self.windows: list[dict] = []
        self._baseline_p99: Optional[float] = None
        self._warmup_p99: list[float] = []
        self._stable_goodput = 0.0
        self._baseline_goodput = 0.0
        self.best_goodput = 0.0
        # Probe in flight: (knob, previous value) — judged by the NEXT
        # window, which measured the probed value.
        self._pending: Optional[tuple[Knob, object]] = None
        self._ki = 0  # round-robin cursor
        self._dir = {k.name: +1 if self._rng.random() < 0.75 else -1
                     for k in self.knobs}
        self._reverts = {k.name: 0 for k in self.knobs}
        self._frozen_until = {k.name: -1 for k in self.knobs}
        self.converged_at: Optional[int] = None
        self.accepts = 0
        self.reverts = 0
        self.guard_violations = 0
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.error: Optional[str] = None

    # ------------------------------------------------------------ policy --
    def _judge(self, s: dict) -> str:
        """Accept or revert the pending probe against its window."""
        knob, prev = self._pending
        self._pending = None
        p99 = s["p99_ms"]
        guard_ok = (
            p99 is None or self._baseline_p99 is None
            or p99 <= self.cfg.p99_guard * self._baseline_p99
        )
        if not guard_ok:
            self.guard_violations += 1
            knob.actuate(prev)
            self._after_revert(knob)
            # Flip like a plain revert: re-probing the SAME over-guard
            # value would inject a second avoidable p99 violation into
            # the live run before the knob ever tries the other side.
            self._dir[knob.name] = -self._dir[knob.name]
            return "revert_guard"
        # Accept needs a STRICTLY positive window: with a zero-goodput
        # baseline (window shorter than a step), 0 >= 0*(1+eps) would
        # accept every probe — including harmful ones — forever.
        if s["goodput_bps"] > 0 and s["goodput_bps"] >= (
            self._stable_goodput * (1.0 + self.cfg.epsilon)
        ):
            self._stable_goodput = s["goodput_bps"]
            self._reverts[knob.name] = 0
            self.accepts += 1
            return "accept"
        knob.actuate(prev)
        self._after_revert(knob)
        self._dir[knob.name] = -self._dir[knob.name]
        return "revert"

    def _after_revert(self, knob: Knob) -> None:
        self.reverts += 1
        self._reverts[knob.name] += 1
        if self._reverts[knob.name] >= self.cfg.freeze_after_reverts:
            # Freeze for cooldown_windows FUTURE windows. This runs
            # inside _judge, BEFORE the current window's record is
            # appended, while the probe/convergence checks compare
            # against the post-append length (= the upcoming window's
            # index) — hence the +1, or cooldown_windows=1 would be a
            # no-op and convergence unreachable.
            self._frozen_until[knob.name] = (
                len(self.windows) + self.cfg.cooldown_windows + 1
            )
            self._reverts[knob.name] = 0

    def _next_probe(self) -> Optional[Knob]:
        w = len(self.windows)
        for _ in range(len(self.knobs)):
            knob = self.knobs[self._ki % len(self.knobs)]
            self._ki += 1
            if self._frozen_until[knob.name] > w:
                continue
            if knob.lo == knob.hi:
                continue  # inert
            return knob
        return None

    def _launch(self, knob: Knob) -> Optional[dict]:
        cand = knob.candidate(self._dir[knob.name])
        if cand is None:  # pinned at this bound: try the other side
            self._dir[knob.name] = -self._dir[knob.name]
            cand = knob.candidate(self._dir[knob.name])
        if cand is None:
            # Immovable from here in EITHER direction (e.g. a mul knob
            # whose configured start is 0): retire it permanently, or
            # it would block convergence forever without ever probing.
            self._frozen_until[knob.name] = 1 << 62
            return None
        prev = knob.value
        knob.actuate(cand)
        self._pending = (knob, prev)
        return {"knob": knob.name, "from": prev, "to": cand}

    # -------------------------------------------------------------- step --
    def step(self) -> dict:
        """One decision window: sample it, judge the pending probe,
        launch the next one. Returns the window record."""
        s = self.sampler.sample()
        w = len(self.windows)
        rec = {
            "window": w,
            "seconds": round(s["seconds"], 6),
            "goodput_bps": round(s["goodput_bps"], 1),
            "p99_ms": round(s["p99_ms"], 4) if s["p99_ms"] is not None else None,
            "reads": s["reads"],
            "values": {k.name: k.value for k in self.knobs},
            "objective": round(s["goodput_bps"], 1),
        }
        if w < self.cfg.warmup_windows:
            rec["verdict"] = "warmup"
            if s["p99_ms"] is not None:
                self._warmup_p99.append(s["p99_ms"])
                self._baseline_p99 = max(self._warmup_p99)
            self._stable_goodput = max(self._stable_goodput, s["goodput_bps"])
            self._baseline_goodput = self._stable_goodput
        elif self._pending is not None:
            rec["knob"] = self._pending[0].name
            rec["verdict"] = self._judge(s)
        else:
            rec["verdict"] = "hold"
            # Track environment drift at the stable point so a slow
            # window can't permanently inflate the accept bar.
            if s["goodput_bps"] > 0:
                self._stable_goodput = (
                    0.5 * self._stable_goodput + 0.5 * s["goodput_bps"]
                )
        self.best_goodput = max(self.best_goodput, s["goodput_bps"])
        self.windows.append(rec)
        w = len(self.windows)
        if self.converged_at is None and w > self.cfg.warmup_windows:
            if all(self._frozen_until[k.name] > w for k in self.knobs
                   if k.lo != k.hi) and any(k.lo != k.hi for k in self.knobs):
                self.converged_at = w
                rec["converged"] = True
        # Probe only while not converged: a settled session holds its
        # operating point (the post-convergence guardrail guarantee).
        if self.converged_at is None and w >= self.cfg.warmup_windows:
            probe = self._next_probe()
            if probe is not None:
                launched = self._launch(probe)
                if launched is not None:
                    rec["probe"] = launched
        self._note(rec)
        return rec

    def _note(self, rec: dict) -> None:
        if self._flight is None:
            return
        op = self._flight.begin(
            f"tune/w{rec['window']}", "", install=False, kind="tune"
        )
        op.note(
            "tune",
            window=rec["window"],
            verdict=rec["verdict"],
            knob=rec.get("knob") or (rec.get("probe") or {}).get("knob"),
            goodput_bps=rec["goodput_bps"],
            p99_ms=rec["p99_ms"],
            values=dict(rec["values"]),
        )
        op.finish(0)

    # ------------------------------------------------------------ thread --
    def start(self) -> None:
        """Spin the decision loop on its own daemon thread, one step per
        ``window_s`` (real runs; tests call step() directly)."""

        def loop() -> None:
            while not self._stop_evt.wait(self.cfg.window_s):
                try:
                    self.step()
                except Exception as exc:  # noqa: BLE001 — advisory layer
                    # Tuning must never kill a run: record and stop.
                    self.error = f"{type(exc).__name__}: {exc}"
                    return

        self._thread = threading.Thread(
            target=loop, name="tune-controller", daemon=True
        )
        self._thread.start()

    def stop(self) -> dict:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return self.stats()

    # ------------------------------------------------------------- stats --
    def stats(self) -> dict:
        post = (
            self.windows[self.converged_at:]
            if self.converged_at is not None else []
        )
        post_good = [w["goodput_bps"] for w in post]
        post_p99 = [w["p99_ms"] for w in post if w["p99_ms"] is not None]
        return {
            "enabled": True,
            "n_windows": len(self.windows),
            "windows": self.windows,
            "converged": self.converged_at is not None,
            "windows_to_converge": self.converged_at,
            "initial": {k.name: k.initial for k in self.knobs},
            "final": {k.name: k.value for k in self.knobs},
            "baseline": {
                "goodput_bps": round(self._baseline_goodput, 1),
                "p99_ms": self._baseline_p99,
            },
            "best_goodput_bps": round(self.best_goodput, 1),
            "converged_goodput_bps": (
                round(sum(post_good) / len(post_good), 1) if post_good else None
            ),
            "converged_p99_ms": max(post_p99) if post_p99 else None,
            "accepts": self.accepts,
            "reverts": self.reverts,
            "guard_violations": self.guard_violations,
            "guard": {
                "p99_guard": self.cfg.p99_guard,
                "baseline_p99_ms": self._baseline_p99,
            },
            "error": self.error,
        }
