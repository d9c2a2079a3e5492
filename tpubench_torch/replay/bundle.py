"""Replay bundles (a copy of ``tpubench/replay/bundle.py``) — a run's
scenario as a portable, versioned artifact.

A **bundle** (schema ``tpubench-bundle/1``, gzip JSON) is the distilled
scenario of one serve-plane run: the arrival timeline (virtual seconds),
the object population with sizes and generations, the unscaled fault
timeline, the membership plan, the tenant/class map, and the system-half
config fingerprint of the run that produced it — plus the original
run's ``baseline`` scorecard so a replay can diff against it offline.

Two disciplines make bundles regression-grade:

* **determinism** — ``write_bundle`` serializes with sorted keys, no
  timestamps, and a zeroed gzip mtime, so record → replay → record is
  byte-identical (the snapshot discipline of ``stream``); the
  schedule itself replays exactly because every serve RNG stream depends
  only on seeds and counts, never on the arrival kind;
* **versioned refusal** — journals stamp ``journal_schema``, bundles
  stamp ``format`` + the source journal's schema; record/replay refuse
  anything newer than they understand instead of silently rebuilding an
  unfaithful scenario.

This module is device-free and import-light (``record`` and ``report``
run on coordinator VMs that never touch a device); the run-driving half
lives in :mod:`tpubench_torch.replay.driver`. Bundles and journals are
``tpubench``'s format: either package records and replays the other's.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from typing import Iterable, Optional, Sequence

BUNDLE_FORMAT = "tpubench-bundle/1"

# Version of the bundle CONTENT contract (what journal_replay_stamp
# promises); the format string above is the envelope. A reader refuses
# stamps/bundles newer than this rather than misparse them.
BUNDLE_SCHEMA = 1

# The bundle field catalog — the drift-guard surface (analysis/drift.py
# ``bundle-schema``): every field a bundle carries, with its meaning.
# README's "Record & replay" schema table must list exactly these.
BUNDLE_FIELDS = {
    "format": "bundle envelope version (tpubench-bundle/1)",
    "name": "scenario name (CLI --name, or derived from the output path)",
    "workload": "workload the bundle replays (serve | drill)",
    "journal_schema": "journal_schema of the source flight journal",
    "config_fingerprint": "system-half config fingerprint of the source run",
    "arrivals": "virtual arrival timestamps, seconds from run start",
    "rate_rps": "offered load the source run was driven at",
    "duration_s": "virtual schedule length in seconds",
    "seed": "serve seed (tenant map + class assignment + Zipf streams)",
    "tenants": "synthetic tenant population size",
    "alpha": "Zipf popularity exponent over the shared chunk set",
    "chunk_bytes": "resolved request chunk size (serve.chunk_bytes or granule)",
    "classes": "priority class map (share/weight/deadline_ms/priority)",
    "objects": "object population: sorted [name, size, generation] triples",
    "object_prefix": "object name prefix the population lives under",
    "bucket": "bucket the chunk keys are scoped to",
    "fault": "unscaled fault plan (FaultConfig fields incl. phases)",
    "membership": "elastic pod plan: hosts, timeline, resize_window_s",
    "drill": "incident-drill plan + checkpoint shape + drill baseline "
             "(null for serve bundles)",
    "baseline": "the source run's distilled scorecard (the diff target)",
}

_REQUIRED = tuple(BUNDLE_FIELDS)


# ---------------------------------------------------------- fingerprint --


def _system_view(cfg_dict: dict) -> dict:
    """The SYSTEM half of a config — the knobs that shape how a scenario
    is served, not what the scenario is. Endpoint and fault are excluded
    (the endpoint is per-process ephemera; the fault plan is scenario,
    carried verbatim in the bundle), and only the serve knobs that are
    not scenario-owned count."""
    transport = dict(cfg_dict.get("transport") or {})
    transport.pop("endpoint", None)
    transport.pop("fault", None)
    serve = cfg_dict.get("serve") or {}
    return {
        "transport": transport,
        "pipeline": cfg_dict.get("pipeline"),
        "staging": cfg_dict.get("staging"),
        "coop": cfg_dict.get("coop"),
        "tune": cfg_dict.get("tune"),
        "serve_system": {
            k: serve.get(k)
            for k in (
                "workers", "qos", "admission_cap", "queue_limit",
                "readahead",
            )
        },
    }


def config_fingerprint(cfg_dict: dict) -> str:
    """Short stable digest of the system half of a config. Two runs with
    the same fingerprint served their scenario through the same stack —
    the replay scorecard's "identical config" precondition, and the
    A/B marker when a bundle is replayed under a different one."""
    payload = json.dumps(
        _system_view(cfg_dict), sort_keys=True, separators=(",", ":"),
    )
    return hashlib.blake2b(payload.encode(), digest_size=12).hexdigest()


# ------------------------------------------------------------- distilling --


def distill_baseline(
    serve_extra: dict,
    *,
    errors: int = 0,
    p99_ms: Optional[float] = None,
    membership: Optional[dict] = None,
) -> dict:
    """The replay-comparable core of a serve scorecard: the numbers a
    replay is judged against (and re-measures for itself). ``gold`` is
    the highest-priority class — the one QoS exists to protect."""
    classes = serve_extra.get("classes") or {}
    gold = min(
        classes.values(), key=lambda c: c.get("priority", 0)
    ) if classes else {}
    rewarm = None
    failovers = None
    if membership:
        rewarms = [
            ev.get("time_to_rewarm_s")
            for ev in membership.get("events", ())
            if ev.get("time_to_rewarm_s") is not None
        ]
        rewarm = max(rewarms) if rewarms else None
        failovers = membership.get("failovers")
    return {
        "arrivals": serve_extra.get("arrivals"),
        "completed": serve_extra.get("completed"),
        "shed": serve_extra.get("shed"),
        "errors": errors,
        "goodput_gbps": serve_extra.get("goodput_gbps"),
        "achieved_rps": serve_extra.get("achieved_rps"),
        "jain_fairness": serve_extra.get("jain_fairness"),
        "gold_slo": gold.get("slo_attainment"),
        "gold_p99_ms": gold.get("p99_ms"),
        "p99_ms": p99_ms,
        "rewarm_s": rewarm,
        "failovers": failovers,
    }


def journal_replay_stamp(
    cfg,
    schedule: Sequence,
    objects: Sequence,
    serve_extra: dict,
    *,
    rate_rps: float,
    membership: Optional[dict] = None,
    drill: Optional[dict] = None,
    errors: int = 0,
    p99_ms: Optional[float] = None,
    source: Optional[dict] = None,
) -> dict:
    """The ``replay`` block a serve run stamps into its flight journal —
    everything ``record`` needs to rebuild the run as a bundle.
    ``objects`` MUST be the same list the schedule was built over (the
    population, not a re-listing that might race a mutating backend);
    ``rate_rps`` is the EFFECTIVE offered load (sweep points override
    the config's). ``drill`` (from :func:`drill_replay_plan`) marks the
    run as an incident drill: the bundle carries the incident plan and
    checkpoint shape alongside the serve scenario, and replays through
    ``run_drill``. ``source`` is set by replay runs: the bundle identity
    they were driven from, so re-recording a replay reproduces the
    original bundle byte-for-byte."""
    sc = cfg.serve
    w = cfg.workload
    import dataclasses

    stamp = {
        "bundle_schema": BUNDLE_SCHEMA,
        "workload": "drill" if drill is not None else "serve",
        "scenario": {
            "arrivals": [float(r.arrival_s) for r in schedule],
            "rate_rps": float(rate_rps),
            "duration_s": float(sc.duration_s),
            "seed": int(sc.seed),
            "tenants": int(sc.tenants),
            "alpha": float(sc.alpha),
            "chunk_bytes": int(sc.chunk_bytes or w.granule_bytes),
            "classes": [dict(c) for c in sc.classes],
            "objects": sorted(
                [m.name, int(m.size), int(m.generation)] for m in objects
            ),
            "object_prefix": w.object_name_prefix,
            "bucket": w.bucket,
            "fault": dataclasses.asdict(cfg.transport.fault),
            "membership": {
                "hosts": int(sc.hosts),
                "timeline": [
                    [float(t0), float(t1), dict(spec)]
                    for t0, t1, spec in sc.membership_timeline
                ],
                "resize_window_s": float(sc.resize_window_s),
            },
            # Emitted unconditionally (None for serve) — the bundle
            # field catalog is a drift-guard surface, never optional.
            "drill": drill,
        },
        "baseline": distill_baseline(
            serve_extra, errors=errors, p99_ms=p99_ms,
            membership=membership,
        ),
        "fingerprint": config_fingerprint(cfg.to_dict()),
    }
    if source:
        stamp["source"] = dict(source)
    return stamp


def drill_replay_plan(cfg, drill_extra: dict,
                      save_interval_s: float) -> dict:
    """The drill half of a replay stamp: the incident plan (kill/join
    epochs, restore identity, save cadence), the checkpoint shape the
    run rebuilds deterministically (shard contents are
    ``shard_content``-derived, so only the SHAPE needs recording), and
    the distilled drill baseline a replay diffs against.
    ``save_interval_s`` is the EFFECTIVE interval (sweep points override
    the config's)."""
    dc, lc, sc = cfg.drill, cfg.lifecycle, cfg.serve
    return {
        "plan": {
            "kill_at_s": float(dc.kill_at_s),
            "join_at_s": float(dc.join_at_s),
            "victim": int(
                dc.victim if dc.victim >= 0 else sc.hosts - 1
            ),
            "restore_class": dc.restore_class,
            "restore_priority": int(dc.restore_priority),
            "restore_weight": float(dc.restore_weight),
            "restore_deadline_ms": float(dc.restore_deadline_ms),
            "restore_inflight": int(dc.restore_inflight),
            "restore_retries": int(dc.restore_retries),
            "restore_via_coop": bool(dc.restore_via_coop),
            "save_interval_s": float(save_interval_s),
            "delta_saves": bool(dc.delta_saves),
            "dirty_fraction": float(dc.dirty_fraction),
            "meta_rate_rps": float(dc.meta_rate_rps),
        },
        "checkpoint": {
            "objects": int(lc.objects),
            "object_bytes": int(lc.object_bytes),
            "part_bytes": int(lc.part_bytes),
            "prefix": lc.prefix,
            "seed": int(lc.seed),
            "meta_objects": int(lc.meta_objects),
            "meta_object_bytes": int(lc.meta_object_bytes),
        },
        "baseline": distill_drill(drill_extra),
    }


def distill_drill(drill_extra: dict) -> dict:
    """The replay-comparable core of a drill scorecard — the incident
    numbers a replayed drill is judged against."""
    d = drill_extra or {}
    rst = d.get("restore") or {}
    saves = d.get("saves") or {}
    amp = d.get("amplification") or {}
    slo = d.get("gold_slo") or {}
    return {
        "time_to_restore_s": rst.get("time_to_restore_s"),
        "time_to_rewarm_s": d.get("time_to_rewarm_s"),
        "restore_verified": rst.get("verified"),
        "shards_restored": rst.get("shards_restored"),
        "torn_rereads": rst.get("torn_rereads"),
        "forced_direct": rst.get("forced_direct"),
        "restore_errors": rst.get("errors"),
        "slo_restore_window": dict(slo.get("restore_window") or {}),
        "slo_steady": dict(slo.get("steady") or {}),
        "save_passes": saves.get("passes"),
        "save_uploaded_shards": saves.get("uploaded_shards"),
        "save_cas_conflicts": saves.get("cas_conflicts"),
        "save_bytes_uploaded": saves.get("bytes_uploaded"),
        "origin_amplification": amp.get("ratio"),
    }


def drill_diff(baseline: dict, replayed: dict) -> dict:
    """Drill replay-vs-original deltas, None-safe — the drill analogue
    of :func:`scorecard_diff` (which still covers the serve half)."""
    b, r = baseline or {}, replayed or {}
    slo_deltas = {}
    b_slo = b.get("slo_restore_window") or {}
    r_slo = r.get("slo_restore_window") or {}
    for cls in sorted(set(b_slo) & set(r_slo)):
        if b_slo[cls] is not None and r_slo[cls] is not None:
            slo_deltas[cls] = (r_slo[cls] - b_slo[cls]) * 100.0
    worst = min(slo_deltas.values()) if slo_deltas else None
    return {
        "time_to_restore_ratio": _ratio(
            r.get("time_to_restore_s"), b.get("time_to_restore_s")
        ),
        "verified_match": (
            bool(b.get("restore_verified"))
            == bool(r.get("restore_verified"))
        ),
        "restore_slo_delta_pts": slo_deltas,
        "worst_restore_slo_delta_pts": worst,
        "amplification_ratio": _ratio(
            r.get("origin_amplification"), b.get("origin_amplification")
        ),
        "save_pass_delta": (
            r["save_passes"] - b["save_passes"]
            if r.get("save_passes") is not None
            and b.get("save_passes") is not None else None
        ),
    }


def bundle_from_stamp(
    stamp: dict, *, name: str = "", journal_schema: int = 1,
) -> dict:
    """A bundle from a journal's ``replay`` stamp. A replay run's stamp
    carries ``source`` (the bundle it was driven from); its identity
    fields pass through so record(replay(record(run))) converges —
    re-recording a replay names, fingerprints and baselines the ORIGINAL
    scenario, not the replay of it."""
    src = stamp.get("source") or {}
    bundle = {
        "format": BUNDLE_FORMAT,
        "name": name or src.get("name") or "unnamed",
        "workload": stamp.get("workload", "serve"),
        "journal_schema": int(journal_schema),
        "config_fingerprint": (
            src.get("fingerprint") or stamp.get("fingerprint")
        ),
        "baseline": src.get("baseline") or stamp.get("baseline"),
    }
    bundle.update(stamp["scenario"])
    # Pre-drill stamps (older journals) have no drill key: rebuild them
    # as explicit serve bundles rather than missing-field refusals.
    bundle.setdefault("drill", None)
    return bundle


# ----------------------------------------------------------------- disk --


def _derive_name(path: str) -> str:
    base = os.path.basename(path)
    for ext in (".gz", ".tpb", ".json"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    return base or "unnamed"


def write_bundle(bundle: dict, path: str) -> str:
    """Atomic, byte-deterministic bundle write: canonical JSON (sorted
    keys, no whitespace), gzip with a zeroed mtime and no embedded
    filename when the path says ``.gz`` — the same input bundle always
    produces the same bytes, which is what lets a golden bundle be
    checked in and diffed."""
    payload = json.dumps(
        bundle, sort_keys=True, separators=(",", ":"),
    ).encode()
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gz"):
        with open(tmp, "wb") as f:
            with gzip.GzipFile(
                filename="", mode="wb", fileobj=f, mtime=0,
            ) as gz:
                gz.write(payload)
    else:
        with open(tmp, "wb") as f:
            f.write(payload)
    os.replace(tmp, path)
    return path


def load_bundle(path: str) -> Optional[dict]:
    """Crash-tolerant bundle read (the ``load_snapshot`` degrade model):
    a missing, unreadable, empty, truncated or non-object bundle returns
    ``None`` with a one-line stderr warning instead of a traceback.
    Gzip is detected by magic bytes, not the filename. Semantic
    validation (format, schema, fields) is :func:`validate_bundle` —
    a WELL-FORMED bundle this build can't honor is a hard error there,
    not a silent skip here."""
    import sys

    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:2] == b"\x1f\x8b":
            raw = gzip.decompress(raw)
    except (OSError, EOFError, gzip.BadGzipFile) as e:
        print(f"warning: {path}: unreadable replay bundle ({e}), ignored",
              file=sys.stderr)
        return None
    text = raw.decode("utf-8", errors="replace")
    if not text.strip():
        print(f"warning: {path}: empty replay bundle, ignored",
              file=sys.stderr)
        return None
    try:
        doc = json.loads(text)
    except json.JSONDecodeError as e:
        print(
            f"warning: {path}: truncated/partial replay bundle "
            f"({e.msg} at char {e.pos}), ignored",
            file=sys.stderr,
        )
        return None
    if not isinstance(doc, dict):
        print(
            f"warning: {path}: replay bundle is not a JSON object "
            f"({type(doc).__name__}), ignored",
            file=sys.stderr,
        )
        return None
    return doc


def validate_bundle(bundle: dict, path: str) -> None:
    """Refuse a bundle replay cannot faithfully rebuild — wrong or newer
    envelope, missing fields, a source journal newer than this build, or
    fault fields this build's FaultConfig doesn't know. One-line
    SystemExit (the config-validation discipline), never a TypeError
    three layers deep in the driver."""
    fmt = bundle.get("format")
    if fmt != BUNDLE_FORMAT:
        hint = " (newer tpubench?)" if str(fmt).startswith(
            "tpubench-bundle/"
        ) else ""
        raise SystemExit(
            f"{path}: not a replay bundle (format={fmt!r}; expected "
            f"{BUNDLE_FORMAT!r}){hint}"
        )
    missing = [k for k in _REQUIRED if k not in bundle]
    if missing:
        raise SystemExit(
            f"{path}: replay bundle missing fields: {', '.join(missing)}"
        )
    if bundle.get("workload") not in ("serve", "drill"):
        raise SystemExit(
            f"{path}: bundle workload {bundle.get('workload')!r} is not "
            "replayable (serve and drill only)"
        )
    from tpubench_torch.obs.flight import JOURNAL_SCHEMA

    js = bundle.get("journal_schema", 1)
    if isinstance(js, int) and js > JOURNAL_SCHEMA:
        raise SystemExit(
            f"{path}: bundle was recorded from journal_schema {js}; this "
            f"build understands <= {JOURNAL_SCHEMA} — refusing an "
            "unfaithful rebuild (upgrade tpubench)"
        )
    from tpubench_torch.config import FaultConfig

    try:
        FaultConfig(**(bundle.get("fault") or {}))
    except TypeError as e:
        raise SystemExit(
            f"{path}: bundle fault plan has fields this build's "
            f"FaultConfig doesn't know ({e}) — newer bundle?"
        ) from None


def record_bundle(
    paths: Iterable[str], out_path: str, name: str = "",
) -> dict:
    """``record``: distill journals into a bundle on disk.
    Multiple paths must all stamp the SAME scenario (the per-host
    journals of one run); journals without a replay stamp (pre-replay
    builds, non-serve workloads) or newer than this build refuse loudly
    rather than fabricate a scenario."""
    from tpubench_torch.obs.flight import JOURNAL_SCHEMA, load_journals

    paths = list(paths)
    docs = load_journals(paths)
    if not docs:
        raise SystemExit(
            "record: no readable flight journals among: "
            + ", ".join(paths)
        )
    stamp = None
    schema = 1
    for p, doc in zip(paths, docs):
        js = doc.get("journal_schema", 1)
        if isinstance(js, int) and js > JOURNAL_SCHEMA:
            raise SystemExit(
                f"record: {p}: journal_schema {js} is newer than this "
                f"build understands (<= {JOURNAL_SCHEMA}) — refusing to "
                "rebuild a scenario it can't be faithful to"
            )
        st = doc.get("replay")
        if st is None:
            raise SystemExit(
                f"record: {p}: no replay stamp in this journal (recorded "
                "by a pre-replay tpubench, or a workload the replay "
                "plane doesn't cover — serve runs stamp one)"
            )
        if st.get("bundle_schema", 1) > BUNDLE_SCHEMA:
            raise SystemExit(
                f"record: {p}: replay stamp bundle_schema "
                f"{st.get('bundle_schema')} is newer than this build's "
                f"{BUNDLE_SCHEMA} — upgrade tpubench"
            )
        if stamp is None:
            stamp, schema = st, js if isinstance(js, int) else 1
        elif st.get("scenario") != stamp.get("scenario"):
            raise SystemExit(
                f"record: {p}: journal stamps a DIFFERENT scenario than "
                f"{paths[0]} — one bundle per run (sweep points are "
                "separate runs; record them separately)"
            )
    bundle = bundle_from_stamp(stamp, name=name, journal_schema=schema)
    if bundle["name"] == "unnamed":
        # Explicit --name wins, then a replay journal's source bundle
        # name (so re-recording a replay is byte-identical to the
        # original bundle wherever it's written), then the filename.
        bundle["name"] = _derive_name(out_path)
    write_bundle(bundle, out_path)
    return bundle


# ------------------------------------------------------------------ diff --


def _ratio(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None or b <= 0:
        return None
    return a / b


def scorecard_diff(baseline: dict, replayed: dict) -> dict:
    """Replay-vs-original deltas, None-safe: what drifted and by how
    much, in the units the ``--fail-on`` grammar gates on (points of
    SLO, ratios of goodput/p99, raw count deltas)."""
    b, r = baseline or {}, replayed or {}
    gold_delta = None
    if b.get("gold_slo") is not None and r.get("gold_slo") is not None:
        gold_delta = (r["gold_slo"] - b["gold_slo"]) * 100.0
    rewarm_delta = None
    if b.get("rewarm_s") is not None and r.get("rewarm_s") is not None:
        rewarm_delta = r["rewarm_s"] - b["rewarm_s"]
    return {
        "gold_slo_delta_pts": gold_delta,
        "goodput_retention": _ratio(
            r.get("goodput_gbps"), b.get("goodput_gbps")
        ),
        "p99_ratio": _ratio(r.get("p99_ms"), b.get("p99_ms")),
        "gold_p99_ratio": _ratio(
            r.get("gold_p99_ms"), b.get("gold_p99_ms")
        ),
        "completed_delta": (
            r["completed"] - b["completed"]
            if r.get("completed") is not None
            and b.get("completed") is not None else None
        ),
        "shed_delta": (
            r["shed"] - b["shed"]
            if r.get("shed") is not None and b.get("shed") is not None
            else None
        ),
        "errors_delta": (
            r["errors"] - b["errors"]
            if r.get("errors") is not None and b.get("errors") is not None
            else None
        ),
        "rewarm_delta_s": rewarm_delta,
    }


# ------------------------------------------------------------- rendering --


def _pct(v: Optional[float]) -> str:
    return f"{v:.1%}" if v is not None else "n/a"


def format_replay_block(rp: dict) -> str:
    """Human rendering of ``extra["replay"]`` (CLI + ``report``) —
    original vs replayed side by side, then the diff."""
    b = rp.get("baseline") or {}
    r = rp.get("replayed") or {}
    d = rp.get("diff") or {}
    match = rp.get("config_match")
    lines = [
        f"== replay vs original ({rp.get('bundle', '?')}) ==",
        (
            "  config: "
            + (
                "IDENTICAL (fingerprint "
                f"{rp.get('fingerprint', '?')})" if match else
                f"A/B — original {rp.get('original_fingerprint', '?')} "
                f"vs replay {rp.get('fingerprint', '?')}"
            )
        ),
        (
            f"  arrivals: original={b.get('arrivals')} "
            f"replayed={r.get('arrivals')}"
            + ("" if rp.get("arrivals_match") else "  (MISMATCH)")
        ),
        (
            f"  gold SLO: {_pct(b.get('gold_slo'))} -> "
            f"{_pct(r.get('gold_slo'))}"
            + (
                f"  ({d['gold_slo_delta_pts']:+.1f} pts)"
                if d.get("gold_slo_delta_pts") is not None else ""
            )
        ),
        (
            f"  goodput:  {b.get('goodput_gbps') or 0:.4f} -> "
            f"{r.get('goodput_gbps') or 0:.4f} GB/s"
            + (
                f"  (retention {d['goodput_retention']:.1%})"
                if d.get("goodput_retention") is not None else ""
            )
        ),
        (
            f"  p99:      "
            + (
                f"{b.get('p99_ms'):.1f}ms" if b.get("p99_ms") is not None
                else "n/a"
            )
            + " -> "
            + (
                f"{r.get('p99_ms'):.1f}ms" if r.get("p99_ms") is not None
                else "n/a"
            )
            + (
                f"  ({d['p99_ratio']:.2f}x)"
                if d.get("p99_ratio") is not None else ""
            )
        ),
        (
            f"  completed={b.get('completed')}->{r.get('completed')} "
            f"shed={b.get('shed')}->{r.get('shed')} "
            f"errors={b.get('errors')}->{r.get('errors')}"
        ),
    ]
    if b.get("rewarm_s") is not None or r.get("rewarm_s") is not None:
        lines.append(
            f"  rewarm:   {b.get('rewarm_s')} -> {r.get('rewarm_s')} s"
        )
    return "\n".join(lines)
