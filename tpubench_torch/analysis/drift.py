"""Declarative drift-guard registry over this package's surfaces.

Each guard names its surfaces and returns a list of human-readable
mismatch strings (empty = no drift): metric catalog ↔ registry ↔
README; span catalog ↔ PHASES ↔ README ↔ emitted kinds; native
counters ↔ engine tb_stats ↔ README; tune knobs ↔ config fields ↔ CLI
flags; replay-bundle fields ↔ catalog ↔ README.  The analyzer
(``check``) runs every guard.  The README is the one both packages
share; every other surface is ``tpubench_torch``'s own (its telemetry,
trace, engine, tune controller, replay bundle and CLI).

Guards import live modules (registries are runtime objects), so they
run under the same constraints as ``report``: no device.
"""

from __future__ import annotations

import ast
import os
import re
import time
from typing import Callable, Sequence

from tpubench_torch.analysis.core import (
    PACKAGE,
    REPO_ROOT,
    AnalysisPass,
    Finding,
    SourceFile,
)


class DriftSkip(Exception):
    """Guard cannot run in this environment (e.g. native toolchain
    unavailable) — reported as a skip, never silently dropped."""


def _readme(repo_root: str) -> str:
    with open(os.path.join(repo_root, "README.md")) as f:
        return f.read()


# ---------------------------------------------------------------- guards --

def guard_metrics(repo_root: str = REPO_ROOT) -> list[str]:
    """registry names == metric catalog == README metric mentions;
    every catalog help non-empty; every flight phase has a histogram."""
    from tpubench_torch.obs.flight import PHASES
    from tpubench_torch.obs.telemetry import (
        Histogram,
        build_registry,
        metric_catalog,
        phase_metric_name,
    )

    problems: list[str] = []
    reg = build_registry()
    catalog = metric_catalog()
    if set(reg.names()) != set(catalog):
        problems.append(
            "registry/catalog drift: "
            f"registry-only={sorted(set(reg.names()) - set(catalog))} "
            f"catalog-only={sorted(set(catalog) - set(reg.names()))}"
        )
    empty = sorted(n for n in catalog if not catalog[n])
    if empty:
        problems.append(f"catalog entries without help text: {empty}")
    readme = _readme(repo_root)
    documented = set(re.findall(r"tpubench_[a-z0-9_]+", readme))
    missing = sorted(set(catalog) - documented)
    if missing:
        problems.append(f"metrics missing from README: {missing}")
    stale = sorted(
        {d for d in documented if d.startswith("tpubench_")} - set(catalog)
    )
    if stale:
        problems.append(f"README documents dropped metrics: {stale}")
    for p in PHASES + ("total",):
        m = reg.get(phase_metric_name(p))
        if not isinstance(m, Histogram):
            problems.append(f"phase {p!r} lacks its registry histogram")
    return problems


def guard_spans(repo_root: str = REPO_ROOT) -> list[str]:
    """span catalog covers PHASES + SPAN_KINDS + NOTE_SPANS; README span
    table == catalog; every kind= the tree emits is catalogued."""
    from tpubench_torch.obs.flight import PHASES
    from tpubench_torch.obs.trace import NOTE_SPANS, SPAN_KINDS, span_catalog

    problems: list[str] = []
    cat = span_catalog()
    for p in PHASES:
        if p not in cat or not cat[p]:
            problems.append(f"phase {p!r} missing from span catalog")
    for k in list(SPAN_KINDS) + list(NOTE_SPANS):
        if k not in cat or not cat[k]:
            problems.append(f"span kind {k!r} missing from span catalog")
    readme = _readme(repo_root)
    m = re.search(r"### Span catalog\n(.*?)\n## ", readme, re.S)
    if not m:
        problems.append("README lost its '### Span catalog' section")
    else:
        documented = set(re.findall(r"^\| `([a-z_]+)` \|", m.group(1), re.M))
        missing = sorted(set(cat) - documented)
        if missing:
            problems.append(f"spans missing from README table: {missing}")
        stale = sorted(documented - set(cat))
        if stale:
            problems.append(f"README documents dropped spans: {stale}")
    src_kinds: set[str] = set()
    pkg = os.path.join(repo_root, PACKAGE)
    for root, _dirs, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn)) as f:
                    src_kinds |= set(
                        re.findall(r"""kind=["']([a-z_]+)["']""", f.read())
                    )
    unknown = sorted(src_kinds - set(SPAN_KINDS))
    if unknown:
        problems.append(f"record kinds emitted but not catalogued: {unknown}")
    return problems


def guard_native_counters(repo_root: str = REPO_ROOT) -> list[str]:
    """engine tb_stats names == NATIVE_TRANSPORT_COUNTERS == README
    native-counter table (engine is the source of truth)."""
    from tpubench_torch.obs.telemetry import NATIVE_TRANSPORT_COUNTERS

    problems: list[str] = []
    empty = sorted(
        n for n, h in NATIVE_TRANSPORT_COUNTERS.items() if not h
    )
    if empty:
        problems.append(f"native counters without help text: {empty}")
    from tpubench_torch.native.engine import get_engine

    try:
        eng = get_engine()
    except (RuntimeError, OSError) as e:
        # The port's engine raises on a failed build or load (it never
        # answers None): that is this guard's "cannot run here".
        raise DriftSkip(
            f"native toolchain unavailable: {str(e).splitlines()[0]}"
        ) from e
    stats = eng.stats()
    if not stats:
        problems.append("tb_stats_* missing from the built engine")
    elif set(stats) != set(NATIVE_TRANSPORT_COUNTERS):
        problems.append(
            "engine/catalog drift: "
            f"engine-only={sorted(set(stats) - set(NATIVE_TRANSPORT_COUNTERS))} "
            f"catalog-only={sorted(set(NATIVE_TRANSPORT_COUNTERS) - set(stats))}"
        )
    readme = _readme(repo_root)
    m = re.search(
        r"<!-- native-counters -->(.*?)<!-- /native-counters -->",
        readme, re.S,
    )
    if not m:
        problems.append("README native-counter table markers missing")
    else:
        documented = set(re.findall(r"`([a-z0-9_]+)`", m.group(1)))
        missing = sorted(set(NATIVE_TRANSPORT_COUNTERS) - documented)
        if missing:
            problems.append(f"native counters missing from README: {missing}")
        stale = sorted(documented - set(NATIVE_TRANSPORT_COUNTERS))
        if stale:
            problems.append(
                f"README documents dropped native counters: {stale}"
            )
    return problems


def guard_tune_knobs(repo_root: str = REPO_ROOT) -> list[str]:
    """ACTUATED == TUNE_KNOBS; every knob resolves to a real config
    dataclass field AND a CLI flag dest."""
    import argparse
    import dataclasses

    from tpubench_torch import cli
    from tpubench_torch.config import BenchConfig, TUNE_KNOBS
    from tpubench_torch.tune.controller import ACTUATED

    problems: list[str] = []
    if set(ACTUATED) != set(TUNE_KNOBS):
        problems.append(
            "ACTUATED/TUNE_KNOBS drift: "
            f"actuated-only={sorted(set(ACTUATED) - set(TUNE_KNOBS))} "
            f"knobs-only={sorted(set(TUNE_KNOBS) - set(ACTUATED))}"
        )
    cfg = BenchConfig()
    parser = argparse.ArgumentParser()
    cli._add_common(parser)
    dests = {a.dest for a in parser._actions}
    for name, spec in ACTUATED.items():
        obj = cfg
        *parents, leaf = spec["config"]
        ok = True
        for part in parents:
            obj = getattr(obj, part, None)
            if obj is None:
                ok = False
                break
        if not ok or not any(
            f.name == leaf for f in dataclasses.fields(obj)
        ):
            problems.append(
                f"knob {name}: config field "
                f"{'.'.join(spec['config'])} missing"
            )
        if spec["cli"] not in dests:
            problems.append(f"knob {name}: CLI flag dest {spec['cli']!r} "
                            "missing")
    return problems


def guard_bundle_schema(repo_root: str = REPO_ROOT) -> list[str]:
    """A freshly distilled bundle == BUNDLE_FIELDS == README bundle
    table (the distiller is the source of truth: a field added to the
    stamp must land in the catalog and the docs in the same PR)."""
    from tpubench_torch.config import BenchConfig
    from tpubench_torch.replay.bundle import (
        BUNDLE_FIELDS,
        bundle_from_stamp,
        journal_replay_stamp,
    )
    from tpubench_torch.storage.base import ObjectMeta

    problems: list[str] = []
    empty = sorted(n for n, h in BUNDLE_FIELDS.items() if not h)
    if empty:
        problems.append(f"bundle fields without help text: {empty}")
    stamp = journal_replay_stamp(
        BenchConfig(), [], [ObjectMeta("o0", 8, 1)],
        {"arrivals": 0, "completed": 0, "shed": 0, "classes": {}},
        rate_rps=1.0,
    )
    produced = set(bundle_from_stamp(stamp))
    if produced != set(BUNDLE_FIELDS):
        problems.append(
            "bundle/catalog drift: "
            f"bundle-only={sorted(produced - set(BUNDLE_FIELDS))} "
            f"catalog-only={sorted(set(BUNDLE_FIELDS) - produced)}"
        )
    readme = _readme(repo_root)
    m = re.search(
        r"<!-- bundle-schema -->(.*?)<!-- /bundle-schema -->", readme, re.S
    )
    if not m:
        problems.append("README bundle-schema table markers missing")
    else:
        documented = set(
            re.findall(r"^\| `([a-z0-9_]+)` \|", m.group(1), re.M)
        )
        missing = sorted(set(BUNDLE_FIELDS) - documented)
        if missing:
            problems.append(f"bundle fields missing from README: {missing}")
        stale = sorted(documented - set(BUNDLE_FIELDS))
        if stale:
            problems.append(
                f"README documents dropped bundle fields: {stale}"
            )
    return problems


# Surface file each guard anchors to, for finding display.
DRIFT_GUARDS: dict[str, tuple[str, Callable[[str], list[str]]]] = {
    "metrics": (f"{PACKAGE}/obs/telemetry.py", guard_metrics),
    "spans": (f"{PACKAGE}/obs/trace.py", guard_spans),
    "native-counters": (f"{PACKAGE}/obs/telemetry.py",
                        guard_native_counters),
    "tune-knobs": (f"{PACKAGE}/tune/controller.py", guard_tune_knobs),
    "bundle-schema": (f"{PACKAGE}/replay/bundle.py", guard_bundle_schema),
}


def run_drift_guard(name: str, repo_root: str = REPO_ROOT) -> list[str]:
    """One guard's mismatch list (empty = clean).  Raises KeyError on an
    unknown guard and :class:`DriftSkip` when the environment cannot
    run it — callers (tests) turn that into a skip."""
    _path, fn = DRIFT_GUARDS[name]
    return fn(repo_root)


def make_drift_pass(repo_root: str = REPO_ROOT) -> AnalysisPass:
    def _run(files: Sequence[SourceFile]):
        out: list = []
        for name, (path, fn) in sorted(DRIFT_GUARDS.items()):
            t0 = time.perf_counter()
            try:
                problems = fn(repo_root)
            except DriftSkip as e:
                out.append(f"drift guard {name!r}: {e}")
                continue
            finally:
                drift_pass.part_seconds[name] = time.perf_counter() - t0
            for p in problems:
                out.append(Finding(
                    "drift", path, 0, name, f"drift:{name}", p,
                ))
        return out

    drift_pass = AnalysisPass(
        pass_id="drift",
        doc="declarative N-way catalog drift guards (metrics, spans, "
            "native counters, tune knobs, bundle schema) — one registry, "
            "not five hand-rolled tests",
        run=_run,
    )
    return drift_pass
