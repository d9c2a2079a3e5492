"""``report`` — summarize and compare result JSONs offline (a copy of
``tpubench/workloads/report_cmd.py``: the same documents give the same
text in both packages).

The reference's post-processing is a matplotlib recipe pasted in its
README (read per-read latency lines, print the average, show a
histogram). This replaces it with a dependency-free report over the
framework's own result files (``write_result`` JSONs): the ssd_test
percentile block per summary (Avg/P20/P50/P90/p99/Min/Max —
``ssd_test/main.go:157-163`` format), a throughput line per run, and —
given two or more runs — pairwise deltas grouped by config axis
(transport bit, staging mode, fetch executor).

Every workload's block renders, ``fleet``'s included. ``bench.py`` lines
and multichip-sweep artifacts are plain dicts and render as in
``tpubench``.

Pure functions over parsed dicts; the CLI wires file loading around them.
"""

from __future__ import annotations

import json

from tpubench_torch.metrics.percentiles import PCT_FIELDS


def _cell(d, fmt, *path):
    """Dig ``path`` out of nested dict ``d``; format or n/a — the ONE
    cell formatter for every A/B diff line in :func:`compare_runs`."""
    for k in path:
        d = (d or {}).get(k)
    return fmt.format(d) if d is not None else "n/a"


def _transport_bit(t: dict) -> str:
    """The transport axis bit of a run's A/B label: protocol plus the
    wire variant that makes two arms comparable-but-different — h2 or
    native receive for HTTP, DirectPath for gRPC. Transport is a
    first-class A/B axis: an h2 arm and a grpc arm under the same fault
    plan must never render as twins, and :func:`compare_runs` keys its
    transport diff block off this bit differing."""
    proto = t.get("protocol", "?")
    if proto == "grpc":
        if t.get("native_receive"):
            proto += "+native"
        elif t.get("directpath"):
            proto += "+dp"
    elif t.get("http2"):
        proto += "+h2"
    elif t.get("native_receive"):
        proto += "+native"
    return proto


def _axis(run: dict) -> str:
    """The config axis label an A/B varies: transport bit (protocol +
    h2/native/DirectPath), the staging mode, and the fetch executor."""
    cfg = run.get("config", {})
    t = cfg.get("transport", {})
    w = cfg.get("workload", {})
    s = cfg.get("staging", {})
    bits = [_transport_bit(t)]
    if s.get("mode") and s.get("mode") != "none":
        bits.append(f"staging={s['mode']}")
    if w.get("fetch_executor") and w.get("fetch_executor") != "python":
        bits.append(f"executor={w['fetch_executor']}")
    sweep = run.get("extra", {}).get("sweep")
    if sweep:
        bits.append(f"size={sweep.get('size')}")
    if run.get("workload") == "train_ingest":
        ra = (cfg.get("pipeline") or {}).get("readahead", 0)
        bits.append(f"readahead={ra}" if ra else "cold")
        # Coop-vs-per-host is the pod-cache A/B's axis: a cooperative
        # run must not render as a twin of its per-host-cache baseline.
        if (cfg.get("coop") or {}).get("enabled"):
            bits.append("coop")
        # Slab-vs-bytes is the copies A/B's axis: label it so the diff
        # table reads "slab vs bytes", not two identical rows.
        copies = (run.get("extra", {}).get("pipeline") or {}).get("copies")
        if copies and copies.get("mode"):
            bits.append(copies["mode"])
    if run.get("workload") == "serve":
        # QoS-on vs QoS-off is the serve A/B's axis: the protected run
        # must not render as a twin of its baseline arm.
        sv = run.get("extra", {}).get("serve") or {}
        bits.append("serve " + ("qos" if sv.get("qos") else "qos-off"))
        if sv.get("sweep"):
            bits.append("sweep")
    dr = run.get("extra", {}).get("drill")
    if dr:
        # The drill's own A/B axes: restore-through-coop vs direct-to-
        # origin, and delta vs full saves — the two arms the scorecard
        # diff exists to compare must never render as twins.
        arm = dr.get("arm") or {}
        bits.append(
            "drill "
            + ("coop" if arm.get("restore_via_coop") else "direct")
            + ("+delta" if arm.get("delta_saves") else "+full")
        )
        if run.get("extra", {}).get("drill_sweep"):
            bits.append("save-sweep")
    rp = run.get("extra", {}).get("replay")
    if rp:
        # Replay runs label the bundle they re-drove; an A/B replay
        # (different system fingerprint than the original) must not
        # render as a twin of the faithful regression arm.
        bits.append(f"replay:{rp.get('bundle', '?')}")
        if not rp.get("config_match"):
            bits.append("ab")
    mb = run.get("extra", {}).get("membership")
    if mb:
        # Elastic-pod runs carry their own A/B axis: the cooperative-
        # leave arm (handoff bytes flowed) vs the killed-host arm must
        # not render as twins.
        bits.append(f"elastic {mb.get('hosts', 0)}h")
        actions = {e.get("action") for e in mb.get("events", ())}
        if "leave_host" in actions:
            bits.append("coop-leave")
        if "kill_host" in actions:
            bits.append("killed")
    lc = run.get("extra", {}).get("lifecycle")
    if lc:
        # Lifecycle runs label their op + the knob that shapes the A/B
        # (part size for saves, arrival process for storms) so a faulted
        # save doesn't render as a twin of its clean baseline.
        bits.append(f"lifecycle:{lc.get('op', '?')}")
        if lc.get("op") == "save" and lc.get("part_bytes"):
            bits.append(f"part={lc['part_bytes']}")
        if lc.get("op") == "meta_storm":
            bits.append(lc.get("arrival", "?"))
            if lc.get("sweep"):
                bits.append("sweep")
    # Adaptive-vs-static is an A/B axis of its own: a run the controller
    # drove must not render as a twin of its static sibling.
    if (run.get("extra", {}).get("tune") or {}).get("enabled") or \
            run.get("workload") == "tune":
        bits.append("tuned")
    return " ".join(bits)


def percentile_block(name: str, s: dict) -> str:
    """One summary in the ssd_test block format (one line; field order
    shared with the live-run renderer via PCT_FIELDS)."""
    cells = "  ".join(
        f"{h}: {s.get(k, 0.0):.3f} ms" for h, k in PCT_FIELDS
    )
    return f"{name} (n={s.get('count', 0)}): {cells}"


def summarize_run(run: dict, label: str = "") -> str:
    lines = [
        f"== {label or _axis(run)} — {run.get('workload', '?')} ==",
        (
            f"bytes={run.get('bytes_total', 0)} "
            f"wall={run.get('wall_seconds', 0.0):.3f}s "
            f"GB/s={run.get('gbps', 0.0):.4f} "
            f"GB/s/chip={run.get('gbps_per_chip', 0.0):.4f} "
            f"errors={run.get('errors', 0)}"
        ),
    ]
    for name, s in (run.get("summaries") or {}).items():
        lines.append("  " + percentile_block(name, s))
    extra = run.get("extra", {})
    staged = extra.get("staged_gbps_per_chip")
    if staged is not None:
        lines.append(f"  staged GB/s/chip={staged:.4f}")
    staging = extra.get("staging")
    if staging:
        # The overlap story: in-flight window depth, transfers-in-flight
        # gauge, and how much transfer flight time was hidden from the
        # fetch threads (staging_efficiency).
        from tpubench_torch.staging.stats import format_staging_block

        lines.append(format_staging_block(staging))
    if "checksum_ok" in extra:
        lines.append(f"  checksum_ok={extra['checksum_ok']}")
    chaos = extra.get("chaos")
    if chaos:
        # The resilience scorecard travels in the result file; render it
        # with the same body `chaos` printed live.
        from tpubench_torch.workloads.chaos import format_scorecard

        lines.append(format_scorecard(chaos))
    pipe = extra.get("pipeline")
    if pipe:
        # Ingest-pipeline scorecard (train-ingest): the body the CLI
        # printed live — stall accounting, cache hit ratio, prefetch
        # efficiency, copies per byte.
        from tpubench_torch.workloads.train_ingest import (
            format_pipeline_scorecard,
        )

        lines.append(format_pipeline_scorecard(pipe))
    sv = extra.get("serve")
    if sv:
        # Serve scorecard / load-sweep curve: the same body `serve`
        # printed live — per-class SLO attainment, Jain fairness,
        # shedding, and (sweep runs) the knee.
        from tpubench_torch.workloads.serve import format_serve_scorecard

        lines.append(format_serve_scorecard(sv))
    mb = extra.get("membership")
    if mb:
        # Elastic-membership resize scorecard: events with remap/handoff
        # accounting, SLO during resize windows vs steady state,
        # origin-byte split, time-to-rewarm.
        from tpubench_torch.workloads.serve import (
            format_membership_scorecard,
        )

        lines.append(format_membership_scorecard(mb))
    dr = extra.get("drill")
    if dr:
        # Incident-drill scorecard: same body `drill` printed live —
        # time-to-restore vs time-to-rewarm, gold SLO during the
        # restore window vs steady state, delta-save ledger, origin-byte
        # amplification.
        from tpubench_torch.workloads.drill import format_drill_scorecard

        lines.append(format_drill_scorecard(dr))
    ds = extra.get("drill_sweep")
    if ds:
        # Save-interval sweep curve with the knee identified.
        from tpubench_torch.workloads.drill import format_drill_sweep

        lines.append(format_drill_sweep(ds))
    fl = extra.get("fleet")
    if fl:
        # Virtual-time fleet block: simulated topology, virtual-vs-real
        # wall clock, the fitted service profile — printed after the
        # serve/membership scorecards it was scored by.
        from tpubench_torch.fleet.driver import format_fleet_block

        lines.append(format_fleet_block(fl))
    rp = extra.get("replay")
    if rp:
        # Replay-vs-original scorecard diff: the same body `replay`
        # printed live — original vs replayed, fingerprints, and the
        # drift deltas the --fail-on grammar gates on.
        from tpubench_torch.replay.bundle import format_replay_block

        lines.append(format_replay_block(rp))
    lc = extra.get("lifecycle")
    if lc:
        # Storage-lifecycle scorecard: same body the CLI printed live
        # (save goodput/parts/resume counts, time-to-restore, storm
        # knee curve).
        from tpubench_torch.lifecycle import format_lifecycle_scorecard

        lines.append(format_lifecycle_scorecard(lc))
    tel = extra.get("telemetry")
    if tel:
        # Live-telemetry stamp: where the run was scrapeable and what
        # the registry's final rollup said — the post-hoc counterpart of
        # `top` (and the agreement surface the acceptance test
        # pins against `report timeline`).
        gp = tel.get("goodput", {})
        line = (
            f"  telemetry: scrapes={tel.get('scrapes', 0)} "
            f"ticks={tel.get('ticks', 0)} "
            f"live goodput={gp.get('gbps', 0.0):.4f} GB/s"
        )
        if tel.get("port") is not None:
            line += f" (served on :{tel['port']})"
        otlp = tel.get("otlp")
        if otlp:
            line += (
                f"  otlp: {otlp.get('payloads', 0)} payloads -> "
                f"{otlp.get('endpoint', 'dry_run')}"
            )
        lines.append(line)
    tune = extra.get("tune")
    if tune:
        # Tune block: a `tune` result carries the full
        # sweep/adaptive/recommendation body; a workload run that merely
        # HAD the controller on carries its convergence trace — render
        # both with the body the CLI printed live.
        from tpubench_torch.workloads.tune_cmd import format_tune_block

        if "mode" in tune:
            lines.append(format_tune_block(tune))
        else:
            lines.append(format_tune_block(
                {"mode": "online", "workload": run.get("workload"),
                 "adaptive": tune,
                 "recommended": tune.get("final") or {}}
            ))
    return "\n".join(lines)


def compare_runs(runs: list[dict]) -> str:
    """Pairwise A/B table vs the FIRST run (the baseline): throughput
    ratio and p50/p99 deltas per summary, labeled by config axis."""
    if len(runs) < 2:
        return ""
    base = runs[0]
    base_label = _axis(base)
    lines = [f"A/B vs baseline [{base_label}]:"]
    for other in runs[1:]:
        label = _axis(other)
        bg, og = base.get("gbps", 0.0), other.get("gbps", 0.0)
        ratio = og / bg if bg > 0 else 0.0
        lines.append(
            f"  [{label}] GB/s {og:.4f} vs {bg:.4f} "
            f"({ratio:.3f}x baseline)"
        )
        for name, s in (other.get("summaries") or {}).items():
            b = (base.get("summaries") or {}).get(name)
            if not b:
                continue
            d50 = s.get("p50_ms", 0.0) - b.get("p50_ms", 0.0)
            d99 = s.get("p99_ms", 0.0) - b.get("p99_ms", 0.0)
            lines.append(
                f"    {name}: p50 {s.get('p50_ms', 0.0):.3f} ms "
                f"({d50:+.3f}), p99 {s.get('p99_ms', 0.0):.3f} ms "
                f"({d99:+.3f})"
            )
        cell = _cell
        # Transport diff: the first-class A/B axis the gRPC plane adds.
        # An h2 arm against a grpc arm under the same fault plan compares
        # on what the transport exists for — goodput, read tail, watchdog
        # stalls, and (when the arms wrote) checkpoint save goodput
        # through the same wire faults.
        ot_ = (other.get("config") or {}).get("transport") or {}
        bt_ = (base.get("config") or {}).get("transport") or {}
        o_bit, b_bit = _transport_bit(ot_), _transport_bit(bt_)
        if o_bit != b_bit:
            def _read_p99(doc):
                ss = doc.get("summaries") or {}
                s_ = ss.get("read") or next(iter(ss.values()), None)
                return s_.get("p99_ms") if s_ else None

            def _stalls(doc):
                return ((doc.get("extra", {}).get("tail") or {})
                        .get("watchdog") or {}).get("stalls", 0)

            def _save_gbps(doc):
                lc_ = doc.get("extra", {}).get("lifecycle") or {}
                return (lc_.get("goodput_gbps")
                        if lc_.get("op") == "save" else None)

            def _na(v, fmt):
                return fmt.format(v) if v is not None else "n/a"

            tline = (
                f"    transport [{o_bit} vs {b_bit}]: goodput "
                f"{og:.4f} vs {bg:.4f} GB/s, read p99 "
                f"{_na(_read_p99(other), '{:.3f}ms')} vs "
                f"{_na(_read_p99(base), '{:.3f}ms')}, "
                f"stalls {_stalls(other)} vs {_stalls(base)}"
            )
            osg, bsg = _save_gbps(other), _save_gbps(base)
            if osg is not None or bsg is not None:
                tline += (
                    ", save goodput "
                    f"{_na(osg, '{:.4f}')} vs {_na(bsg, '{:.4f}')} GB/s"
                )
            lines.append(tline)
        # Pipeline diff: two train-ingest runs (readahead on vs cold)
        # compare on what the pipeline exists for — stall time, stalled
        # fraction, hit ratio — not just throughput.
        op_ = other.get("extra", {}).get("pipeline")
        bp = base.get("extra", {}).get("pipeline")
        if op_ and bp:
            lines.append(
                "    pipeline: stalled "
                f"{cell(op_, '{:.1%}', 'stall', 'stalled_fraction')} vs "
                f"{cell(bp, '{:.1%}', 'stall', 'stalled_fraction')}, "
                "stall p99 "
                f"{cell(op_, '{:.2f}ms', 'stall', 'p99_ms')} vs "
                f"{cell(bp, '{:.2f}ms', 'stall', 'p99_ms')}, "
                "hit ratio "
                f"{cell(op_, '{:.1%}', 'cache', 'hit_ratio')} vs "
                f"{cell(bp, '{:.1%}', 'cache', 'hit_ratio')}"
            )
            if op_.get("coop") or bp.get("coop"):
                # Coop-vs-per-host diff: the axis that matters is origin
                # bytes fetched (per pod) — the per-host baseline pays
                # them N times; peer hit ratio says where they went
                # instead.
                lines.append(
                    "    coop: origin_bytes "
                    f"{cell(op_, '{}', 'coop', 'origin_bytes')} vs "
                    f"{cell(bp, '{}', 'coop', 'origin_bytes')}, "
                    "peer hit "
                    f"{cell(op_, '{:.1%}', 'coop', 'peer_hit_ratio')} vs "
                    f"{cell(bp, '{:.1%}', 'coop', 'peer_hit_ratio')}, "
                    "pod_coalesced "
                    f"{cell(op_, '{}', 'coop', 'pod_coalesced')} vs "
                    f"{cell(bp, '{}', 'coop', 'pod_coalesced')}"
                )
            if op_.get("copies") or bp.get("copies"):
                # The zero-copy A/B's headline: host-RAM writes per
                # delivered chunk byte (slab = 1.00, legacy bytes >= 2).
                lines.append(
                    "    copies/byte "
                    f"{cell(op_, '{:.2f}', 'copies', 'copies_per_byte')} "
                    f"({cell(op_, '{}', 'copies', 'mode')}) vs "
                    f"{cell(bp, '{:.2f}', 'copies', 'copies_per_byte')} "
                    f"({cell(bp, '{}', 'copies', 'mode')})"
                )
        osv = other.get("extra", {}).get("serve")
        bsv = base.get("extra", {}).get("serve")
        if osv and bsv and not (osv.get("sweep") or bsv.get("sweep")):
            # The QoS A/B's verdict line: did the protected class keep
            # its SLO, what did the protection cost in aggregate
            # goodput, and how fair was each arm (Jain over weight-
            # normalized per-tenant goodput).
            def _gold(sv):
                cl = sv.get("classes") or {}
                return min(
                    cl.values(), key=lambda x: x.get("priority", 0)
                ) if cl else {}

            og, bg_ = _gold(osv), _gold(bsv)
            bgp = bsv.get("goodput_gbps") or 0.0
            ogp = osv.get("goodput_gbps") or 0.0
            retention = (ogp / bgp) if bgp > 0 else None
            lines.append(
                "    serve: gold SLO "
                f"{cell(og, '{:.1%}', 'slo_attainment')} vs "
                f"{cell(bg_, '{:.1%}', 'slo_attainment')}, "
                "gold p99 "
                f"{cell(og, '{:.1f}ms', 'p99_ms')} vs "
                f"{cell(bg_, '{:.1f}ms', 'p99_ms')}, "
                "shed "
                f"{osv.get('shed', 0)} vs {bsv.get('shed', 0)}, "
                "jain "
                f"{cell(osv, '{:.3f}', 'jain_fairness')} vs "
                f"{cell(bsv, '{:.3f}', 'jain_fairness')}"
                + (
                    f", goodput retention {retention:.1%}"
                    if retention is not None else ""
                )
            )
        # Membership diff: the cooperative-leave arm against the
        # killed-host arm compares on what elastic membership exists
        # for — did the warm handoff replace origin re-fetches during
        # the resize window, and did the protected class's SLO survive
        # the reshape.
        omb = other.get("extra", {}).get("membership")
        bmb = base.get("extra", {}).get("membership")
        if omb and bmb:
            def _gold_resize(mb):
                # "gold" = the first entry: the scorecard writes classes
                # in priority order, so insertion order IS rank.
                slo = (mb.get("slo") or {}).get("resize") or {}
                for v in slo.values():
                    return v
                return None

            og_, bg2 = _gold_resize(omb), _gold_resize(bmb)
            lines.append(
                "    membership: handoff "
                f"{(omb.get('handoff') or {}).get('out_bytes', 0)}B vs "
                f"{(bmb.get('handoff') or {}).get('out_bytes', 0)}B, "
                "resize-window origin "
                f"{(omb.get('origin_bytes') or {}).get('resize_windows', 0)}B vs "
                f"{(bmb.get('origin_bytes') or {}).get('resize_windows', 0)}B, "
                "gold SLO during resize "
                + (f"{og_:.1%}" if og_ is not None else "n/a")
                + " vs "
                + (f"{bg2:.1%}" if bg2 is not None else "n/a")
                + ", failovers "
                f"{omb.get('failovers', 0)} vs {bmb.get('failovers', 0)}"
            )
        # Drill diff: the restore-through-coop arm against the direct-
        # to-origin arm (or delta vs full saves) compares on what the
        # drill exists for — time-to-restore, the protected class's SLO
        # through the restore window, origin-byte amplification, and
        # what the save cadence uploaded.
        odr = other.get("extra", {}).get("drill")
        bdr = base.get("extra", {}).get("drill")
        if odr and bdr:
            def _gold_restore_slo(doc, dr):
                # Gold = the min-priority serving class; the restore
                # class never appears in the arrival-SLO tally.
                cl = (doc.get("extra", {}).get("serve") or {}) \
                    .get("classes") or {}
                win = (dr.get("gold_slo") or {}).get("restore_window") or {}
                names = [n for n in win if n in cl]
                if not names:
                    return None
                gold = min(names, key=lambda n: cl[n].get("priority", 0))
                return win.get(gold)

            og2 = _gold_restore_slo(other, odr)
            bg3 = _gold_restore_slo(base, bdr)
            lines.append(
                "    drill: time-to-restore "
                f"{cell(odr, '{:.3f}s', 'restore', 'time_to_restore_s')} vs "
                f"{cell(bdr, '{:.3f}s', 'restore', 'time_to_restore_s')}, "
                "gold SLO in restore window "
                + (f"{og2:.1%}" if og2 is not None else "n/a")
                + " vs "
                + (f"{bg3:.1%}" if bg3 is not None else "n/a")
                + ", amplification "
                f"{cell(odr, '{:.2f}x', 'amplification', 'ratio')} vs "
                f"{cell(bdr, '{:.2f}x', 'amplification', 'ratio')}, "
                "save bytes "
                f"{(odr.get('saves') or {}).get('bytes_uploaded', 0)} vs "
                f"{(bdr.get('saves') or {}).get('bytes_uploaded', 0)}, "
                "cas conflicts "
                f"{(odr.get('saves') or {}).get('cas_conflicts', 0)} vs "
                f"{(bdr.get('saves') or {}).get('cas_conflicts', 0)}"
            )
        # Lifecycle diff: two saves (e.g. faulted vs clean, or part-size
        # A/B) compare on what the write path exists for — goodput,
        # resumed parts, part-level tail; restores on time-to-restore;
        # storms on the knee.
        olc = other.get("extra", {}).get("lifecycle")
        blc = base.get("extra", {}).get("lifecycle")
        if olc and blc and olc.get("op") == blc.get("op"):
            op = olc.get("op")
            if op == "save":
                lines.append(
                    "    ckpt-save: goodput "
                    f"{cell(olc, '{:.4f}', 'goodput_gbps')} vs "
                    f"{cell(blc, '{:.4f}', 'goodput_gbps')} GB/s, "
                    "part p99 "
                    f"{cell(olc, '{:.2f}ms', 'part_latency', 'p99_ms')} vs "
                    f"{cell(blc, '{:.2f}ms', 'part_latency', 'p99_ms')}, "
                    "resumed "
                    f"{olc.get('resumed_parts', 0)} vs "
                    f"{blc.get('resumed_parts', 0)}, corrupt "
                    f"{olc.get('corrupt_finalizes', 0)} vs "
                    f"{blc.get('corrupt_finalizes', 0)}"
                )
            elif op == "restore":
                lines.append(
                    "    ckpt-restore: time-to-restore "
                    f"{cell(olc, '{:.3f}s', 'time_to_restore_s')} vs "
                    f"{cell(blc, '{:.3f}s', 'time_to_restore_s')}, "
                    "goodput "
                    f"{cell(olc, '{:.4f}', 'goodput_gbps')} vs "
                    f"{cell(blc, '{:.4f}', 'goodput_gbps')} GB/s"
                )
            elif op == "meta_storm":
                lines.append(
                    "    meta-storm: achieved "
                    f"{cell(olc, '{:.1f}', 'achieved_rps')} vs "
                    f"{cell(blc, '{:.1f}', 'achieved_rps')} rps, "
                    "p99 "
                    f"{cell(olc, '{:.2f}ms', 'p99_ms')} vs "
                    f"{cell(blc, '{:.2f}ms', 'p99_ms')}, "
                    "knee "
                    f"{cell(olc, '{}', 'sweep', 'knee', 'offered_rps')} vs "
                    f"{cell(blc, '{}', 'sweep', 'knee', 'offered_rps')}"
                )
        # Tune diff: a static run against its adaptive sibling compares
        # on what the controller exists for — the converged operating
        # point and when it got there — alongside the throughput ratio
        # already printed above.
        for side, label in ((other, "B"), (base, "A")):
            tn = (side.get("extra", {}).get("tune") or {})
            ad = tn.get("adaptive") if "mode" in tn else tn
            if ad and ad.get("enabled"):
                conv = ad.get("windows_to_converge")
                lines.append(
                    f"    tune[{label}]: {ad.get('initial')} -> "
                    f"{ad.get('final')}"
                    + (f", converged in {conv} windows"
                       if ad.get("converged") else ", not converged")
                )
        # Replay diff: two replays of the same bundle under different
        # system configs compare on what replay exists for — how far
        # each drifted from the recorded original.
        orp = other.get("extra", {}).get("replay")
        brp = base.get("extra", {}).get("replay")
        if orp and brp:
            od, bd = orp.get("diff") or {}, brp.get("diff") or {}
            lines.append(
                f"    replay[{orp.get('bundle', '?')}]: retention "
                f"{cell(od, '{:.1%}', 'goodput_retention')} vs "
                f"{cell(bd, '{:.1%}', 'goodput_retention')}, "
                "gold SLO delta "
                f"{cell(od, '{:+.1f}pts', 'gold_slo_delta_pts')} vs "
                f"{cell(bd, '{:+.1f}pts', 'gold_slo_delta_pts')}, "
                "p99 "
                f"{cell(od, '{:.2f}x', 'p99_ratio')} vs "
                f"{cell(bd, '{:.2f}x', 'p99_ratio')}"
            )
        # Scorecard diff: two chaos runs (e.g. hedged vs unhedged over the
        # same timeline) compare on resilience, not just throughput.
        osc = (other.get("extra", {}).get("chaos") or {}).get("scorecard")
        bsc = (base.get("extra", {}).get("chaos") or {}).get("scorecard")
        if osc and bsc:
            lines.append(
                "    scorecard: retention "
                f"{cell(osc, '{:.1%}', 'goodput_retention')} vs "
                f"{cell(bsc, '{:.1%}', 'goodput_retention')}, "
                "p99 inflation "
                f"{cell(osc, '{:.2f}x', 'p99_inflation')} vs "
                f"{cell(bsc, '{:.2f}x', 'p99_inflation')}, "
                "time-to-recover "
                f"{cell(osc, '{:.3f}s', 'time_to_recover_s')} vs "
                f"{cell(bsc, '{:.3f}s', 'time_to_recover_s')}"
            )
    return "\n".join(lines)


def sweep_table(rows: list[dict]) -> str:
    """Table form of a ``tpubench sweep`` output (the list of cells the
    sweep command prints/writes)."""
    if not rows:
        return ""
    lines = ["sweep:"]
    for r in rows:
        cell = f"  {r.get('protocol', '?'):>8}"
        if "native_receive" in r:
            cell += f"/{'native' if r['native_receive'] else 'python'}"
        cell += (
            f"  size={r.get('size', '?'):>6}  GB/s={r.get('gbps', 0.0):.4f}"
            f"  p50={r.get('p50_ms', 0.0):.3f} ms"
            f"  p99={r.get('p99_ms', 0.0):.3f} ms"
        )
        lines.append(cell)
    return "\n".join(lines)


def bench_block(d: dict, label: str = "") -> str:
    """Summary of a bench.py output line (or a BENCH_rN.json wrapper's
    ``parsed`` object): the headline with its honest comparables and the
    per-config sample sets."""
    lines = [
        f"== bench {label} ==".rstrip(),
        (
            f"{d.get('metric', '?')}: {d.get('value', 0.0)} "
            f"{d.get('unit', '')}  config={d.get('config', '?')}  "
            f"shaped={d.get('shaped_verdict')}"
        ),
        (
            f"  vs_baseline={d.get('vs_baseline')}  "
            f"vs_tunnel_ceiling={d.get('vs_tunnel_ceiling')}  "
            f"staging_efficiency={d.get('staging_efficiency')}"
        ),
    ]
    ebm = d.get("efficiency_by_mode")
    if ebm:
        cells = "  ".join(
            f"{mode}: best={v.get('best')}"
            + (f" median={v['median']}" if v.get("median") is not None else "")
            for mode, v in ebm.items()
        )
        lines.append(f"  efficiency_by_mode: {cells}")
    ab = d.get("fetch_only_ab") or {}
    if ab.get("native_executor_gbps") and ab.get("python_fetch_gbps"):
        lines.append(
            f"  fetch A/B: native {ab['native_executor_gbps']} vs "
            f"python {ab['python_fetch_gbps']} GB/s ({ab.get('source', '')})"
        )
    for cfg, samples in (d.get("samples") or {}).items():
        lines.append(f"  {cfg}: {samples}")
    return "\n".join(lines)


def multichip_block(d: dict, label: str = "") -> str:
    """Summary of a MULTICHIP_SWEEP.json artifact: per-size pod-ingest
    stage split and the per-collective best rows, with the ring-algebra
    verdict."""
    lines = [f"== multichip sweep {label} ==".rstrip()]
    lines.append(
        f"sizes={d.get('sizes')}  shard_mb={d.get('shard_mb')}  "
        f"ring_algebra_ok={d.get('ring_algebra_ok')}"
    )
    for entry in d.get("pod_ingest") or []:
        for key, tag in (
            ("pod_ingest_all_gather", "all_gather"),
            ("pod_ingest_ring", "ring"),
        ):
            pi = entry.get(key) or {}
            if not pi:
                continue
            lines.append(
                f"  n={entry.get('devices', '?'):>2} {tag:>10}:"
                f" fetch {pi.get('fetch_seconds', 0):.3f}s"
                f"  stage {pi.get('stage_seconds', 0):.3f}s"
                f"  gather {pi.get('gather_seconds', 0):.3f}s"
                f"  ingest {pi.get('ingest_gbps', 0):.3f} GB/s"
                f"  verified={pi.get('verified')}"
            )
    for mode, rows in (d.get("collectives") or {}).items():
        if rows:
            best = max(rows, key=lambda r: r.get("per_chip_rx_gbps", 0))
            lines.append(
                f"  {mode}: best n={best.get('devices', '?')} "
                f"{best.get('per_chip_rx_gbps', 0):.3f} GB/s/chip rx"
            )
    return "\n".join(lines)


def run_timeline(paths: list[str]) -> str:
    """``report timeline <journal...>`` — merge per-host flight
    journals (obs/flight.py) into the pod-level per-phase p50/p99 report
    with straggler attribution. One file = single-host timeline; many =
    the cross-host aggregation pass.

    Sibling discovery rides the live aggregator's glob discipline
    (``obs/live.discover_journal_paths``), so handing the BASE path of a
    serve sweep (or a multi-host run) collects its ``.pt<i>`` /
    ``.p<idx>`` siblings automatically. Sweep points are DIFFERENT runs
    at different offered loads: they render as labeled segments (base
    run, then each point in order), never silently pooled into one
    timeline whose percentiles would belong to no run at all; per-host
    siblings of one point still merge, the cross-host pass."""
    import re

    from tpubench_torch.obs.flight import load_journals, render_timeline
    from tpubench_torch.obs.live import discover_journal_paths

    expanded: list[str] = []
    seen = set()
    for base in paths:
        # Per-base expansion, keeping a missing base so load_journals
        # still emits its one-line unreadable warning for it.
        for p in discover_journal_paths([base]) or [base]:
            if p not in seen:
                seen.add(p)
                expanded.append(p)
    groups: dict = {}
    for p in expanded:
        m = re.search(r"\.pt(\d+)", p)
        groups.setdefault(int(m.group(1)) if m else None, []).append(p)
    if len(groups) <= 1:
        return render_timeline(load_journals(expanded))
    out = [f"== serve sweep timeline: {len(groups)} segments =="]
    for point in sorted(groups, key=lambda k: (k is not None, k or 0)):
        docs = load_journals(groups[point])
        if not docs:
            continue
        label = "base run" if point is None else f"sweep point {point}"
        out.append(
            f"-- {label} ({', '.join(groups[point])}) --\n"
            + render_timeline(docs)
        )
    return "\n\n".join(out)


def run_trace(paths: list[str], *, slow_fraction: float = 0.1,
              head_rate: float = 0.05, max_keep: int = 512,
              show: int = 3) -> str:
    """``report trace <journal...>`` — merge per-host flight
    journals into cross-host span trees (the records' trace_id/span_id/
    parent_id graph), tail-sample per trace (slowest decile + unbiased
    head sample), and print the p99 blame table + the slowest trees
    with per-span critical-path durations."""
    from tpubench_torch.obs.flight import load_journals
    from tpubench_torch.obs.trace import render_trace_report

    return render_trace_report(
        load_journals(paths), slow_fraction=slow_fraction,
        head_rate=head_rate, max_keep=max_keep, show=show,
    )


def run_report(paths: list[str]) -> str:
    """Load result/sweep/bench JSONs and render the full report."""
    runs: list[dict] = []
    chunks: list[str] = []
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        if isinstance(doc, list):  # a sweep cells file
            chunks.append(sweep_table(doc))
            continue
        if doc.get("format") == "tpubench-flight-v1":
            # A flight journal handed to the plain report renders as a
            # single-host timeline (same body as `report timeline`).
            from tpubench_torch.obs.flight import render_timeline

            chunks.append(render_timeline([doc]))
            continue
        if "metric" in doc:  # a bench.py output line saved to a file
            chunks.append(bench_block(doc, label=f"({p})"))
            continue
        if "ring_algebra_ok" in doc:  # a MULTICHIP_SWEEP.json artifact
            chunks.append(multichip_block(doc, label=f"({p})"))
            continue
        if "rc" in doc and "tail" in doc:
            # A BENCH_rN.json wrapper (rc, tail, parsed): summarize the
            # parsed bench line when there is one; a failed run (no usable
            # `parsed`) is reported as such — never fed to the A/B
            # comparison as a bogus zero-throughput baseline.
            if isinstance(doc.get("parsed"), dict) and "metric" in doc["parsed"]:
                chunks.append(bench_block(doc["parsed"], label=f"({p})"))
            else:
                chunks.append(
                    f"== bench ({p}) ==\n"
                    f"  run failed or unparsed (rc={doc.get('rc')}); "
                    "see its `tail` for the crash output"
                )
            continue
        runs.append(doc)
        chunks.append(summarize_run(doc, label=f"{_axis(doc)} ({p})"))
    cmp_block = compare_runs(runs)
    if cmp_block:
        chunks.append(cmp_block)
    return "\n\n".join(c for c in chunks if c)
