"""Fleet service-time calibration: flight journals → sampling profiles.

The fidelity of a virtual-time fleet run rests entirely on its service
times. This module fits per-phase empirical distributions from the same
flight journals every real run already writes (``--flight-journal``),
so a fleet simulation's origin fetch takes as long as the measured
``cache_miss → body_complete`` segment did, and a peer hop as long as
the measured ``peer_request → peer_hit`` round trip.

Representation is an inverse-CDF **quantile grid** (33 points, linear
interpolation between them): enough to carry a long tail faithfully,
small enough that a profile JSON stays human-readable, and sampling is
one uniform draw + one ``np.interp`` — no distributional family is
assumed, because measured storage latency fits none.

Discipline notes:

* Journal discovery reuses ``obs.live.discover_journal_paths`` — the
  ``.p<idx>`` per-host siblings and ``.gz`` variants come along exactly
  as they do for ``top``/``report timeline``.
* Empty/torn journals degrade with the one-line warning contract of
  ``load_journals`` (a dead host must not poison calibration).
* A phase with too few samples falls back to its configured constant
  with a one-line warning — silently fitting a distribution to three
  points would be worse than admitting the default.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

PROFILE_FORMAT = "tpubench-fleet-profile/1"

# The simulated service phases and the journal segments they fit from.
# "hit" is deliberately NOT journal-fitted: the only observable segment
# (enqueue → cache_hit) includes admission-queue wait, which the
# simulator models separately — fitting it would double-count queueing.
SERVICE_PHASES = ("hit", "peer", "origin", "cross_pod")

# Below this many samples a fitted grid is noise, not a distribution.
MIN_SAMPLES = 8

_GRID_POINTS = 33
_QGRID = np.linspace(0.0, 1.0, _GRID_POINTS)


class ServiceDist:
    """One phase's service-time distribution as an inverse-CDF grid
    (milliseconds at ``_QGRID`` quantiles). ``constant(ms)`` collapses
    the grid to a single value — the uncalibrated default."""

    __slots__ = ("grid_ms", "count", "source")

    def __init__(self, grid_ms: Sequence[float], count: int = 0,
                 source: str = "fitted"):
        self.grid_ms = [float(v) for v in grid_ms]
        if len(self.grid_ms) != _GRID_POINTS:
            raise ValueError(
                f"service grid: {len(self.grid_ms)} points "
                f"(expected {_GRID_POINTS})"
            )
        self.count = int(count)
        self.source = source

    @classmethod
    def constant(cls, ms: float) -> "ServiceDist":
        return cls([float(ms)] * _GRID_POINTS, count=0, source="constant")

    @classmethod
    def fit(cls, samples_ms: Sequence[float]) -> "ServiceDist":
        arr = np.asarray(sorted(samples_ms), dtype=np.float64)
        grid = np.quantile(arr, _QGRID)
        return cls(np.round(grid, 6), count=arr.size, source="fitted")

    def sample_s(self, rng: np.random.Generator) -> float:
        """One inverse-transform draw, in SECONDS (the sim's domain)."""
        u = rng.random()
        return float(np.interp(u, _QGRID, self.grid_ms)) / 1e3

    def mean_ms(self) -> float:
        # Trapezoid over the inverse CDF = the distribution's mean.
        return float(np.trapezoid(self.grid_ms, _QGRID)) \
            if hasattr(np, "trapezoid") else float(np.trapz(self.grid_ms, _QGRID))

    def p_ms(self, q: float) -> float:
        return float(np.interp(q, _QGRID, self.grid_ms))

    def to_dict(self) -> dict:
        return {
            "grid_ms": self.grid_ms,
            "count": self.count,
            "source": self.source,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceDist":
        return cls(d["grid_ms"], count=d.get("count", 0),
                   source=d.get("source", "fitted"))


class FleetProfile:
    """The complete service-time profile a fleet run samples from:
    one :class:`ServiceDist` per phase in :data:`SERVICE_PHASES`."""

    def __init__(self, phases: dict, source_paths: Optional[list] = None):
        missing = [p for p in SERVICE_PHASES if p not in phases]
        if missing:
            raise ValueError(f"fleet profile missing phases: {missing}")
        self.phases = {p: phases[p] for p in SERVICE_PHASES}
        self.source_paths = list(source_paths or [])

    @classmethod
    def from_constants(cls, *, hit_ms: float, peer_ms: float,
                       origin_ms: float, cross_pod_ms: float
                       ) -> "FleetProfile":
        return cls({
            "hit": ServiceDist.constant(hit_ms),
            "peer": ServiceDist.constant(peer_ms),
            "origin": ServiceDist.constant(origin_ms),
            "cross_pod": ServiceDist.constant(cross_pod_ms),
        })

    def summary(self) -> dict:
        return {
            name: {
                "source": d.source,
                "count": d.count,
                "mean_ms": round(d.mean_ms(), 4),
                "p50_ms": round(d.p_ms(0.5), 4),
                "p99_ms": round(d.p_ms(0.99), 4),
            }
            for name, d in self.phases.items()
        }

    def to_dict(self) -> dict:
        return {
            "format": PROFILE_FORMAT,
            "phases": {p: d.to_dict() for p, d in self.phases.items()},
            "source_paths": self.source_paths,
        }

    @classmethod
    def from_dict(cls, doc: dict, where: str = "fleet profile"
                  ) -> "FleetProfile":
        if doc.get("format") != PROFILE_FORMAT:
            raise SystemExit(
                f"{where}: not a fleet profile (format="
                f"{doc.get('format')!r}; expected {PROFILE_FORMAT!r})"
            )
        try:
            phases = {
                p: ServiceDist.from_dict(d)
                for p, d in doc.get("phases", {}).items()
            }
            return cls(phases, source_paths=doc.get("source_paths"))
        except (KeyError, TypeError, ValueError) as e:
            raise SystemExit(f"{where}: malformed ({e})") from e


def save_profile(profile: FleetProfile, path: str) -> str:
    """Atomic profile write (tmp + replace — the journal discipline)."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(profile.to_dict(), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_profile(path: str) -> FleetProfile:
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise SystemExit(f"fleet profile {path!r}: {e}") from e
    except json.JSONDecodeError as e:
        raise SystemExit(
            f"fleet profile {path!r}: invalid JSON ({e.msg} at char "
            f"{e.pos})"
        ) from e
    return FleetProfile.from_dict(doc, where=f"fleet profile {path!r}")


def _phase_samples_ms(records: list) -> dict:
    """Extract per-phase service samples (ms) from journal records.

    * ``origin``: ``cache_miss → body_complete`` (the full backend
      resolution of a demand miss), falling back to
      ``owner_fetch → body_complete`` for coop-owner records.
    * ``peer``: ``peer_request → peer_hit`` (the successful peer RTT).
    * ``hit`` / ``cross_pod``: never journal-fitted (see module doc /
      SERVICE_PHASES comment) — absent from the result by design.
    """
    out: dict = {"origin": [], "peer": []}
    for rec in records:
        ph = rec.get("phases") or {}
        if "body_complete" in ph:
            start = ph.get("cache_miss", ph.get("owner_fetch"))
            if start is not None and ph["body_complete"] >= start:
                out["origin"].append((ph["body_complete"] - start) / 1e6)
        if "peer_request" in ph and "peer_hit" in ph \
                and ph["peer_hit"] >= ph["peer_request"]:
            out["peer"].append((ph["peer_hit"] - ph["peer_request"]) / 1e6)
    return out


def fit_profile(bases: Sequence[str], *, defaults: dict) -> FleetProfile:
    """``--calibrate-from``: fit a :class:`FleetProfile` from journal
    base paths (``.p<idx>`` siblings and ``.gz`` discovered the same way
    ``top`` finds them). ``defaults`` maps phase → constant ms
    for phases that cannot be fitted (too few samples, or — hit /
    cross_pod — structurally unfittable from journals)."""
    from tpubench_torch.obs.flight import load_journals
    from tpubench_torch.obs.live import discover_journal_paths

    paths = discover_journal_paths(list(bases))
    docs = load_journals(paths)
    records = [r for doc in docs for r in doc.get("records", [])]
    samples = _phase_samples_ms(records)
    phases: dict = {}
    for name in SERVICE_PHASES:
        got = samples.get(name)
        if got is not None and len(got) >= MIN_SAMPLES:
            phases[name] = ServiceDist.fit(got)
            continue
        if got is not None:
            print(
                f"warning: fleet calibrate: phase {name!r}: "
                f"{len(got)} sample(s) across {len(docs)} journal(s) "
                f"(< {MIN_SAMPLES}), using the configured constant "
                f"{defaults[name]} ms",
                file=sys.stderr,
            )
        phases[name] = ServiceDist.constant(defaults[name])
    return FleetProfile(phases, source_paths=paths)
