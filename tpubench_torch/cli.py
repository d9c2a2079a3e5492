"""tpubench_torch CLI: ``tpubench``'s ``read``, ``train-ingest``, ``sweep``,
``pod-ingest``, ``stream``, ``gather-bench``, ``multichip-sweep``, ``probe``,
``tune``, ``ckpt-save``, ``ckpt-restore``, ``meta-storm``, ``serve``,
``chaos``, ``drill``, ``fleet``, ``record`` and ``replay`` on PyTorch and
CUDA, its filesystem workloads (``prepare``, ``read-fs``, ``write``,
``list``, ``open``, ``ssd``), ``report`` and ``top`` over the results and
journals they write, ``preflight`` (what a run needs, checked without a
device), ``check`` (the static analysis of this package's own source)
and ``info`` (what the port would run on): all 29 of ``tpubench``'s
subcommands.

    python -m tpubench_torch.cli read --protocol fake --workers 2 \\
        --read-call-per-worker 2 --object-size 5242903 \\
        --staging device_put --validate --device cpu --results-dir /tmp/r

The other clients read from a server (``--endpoint``, ``--bucket``,
``--object-name-prefix``) or a directory (``--protocol local --dir``):
``--protocol http`` (HTTP/1.1; ``--native-receive``, ``--http2``,
``--fetch-executor native``) and ``--protocol grpc`` (``--native-receive``).

The obs plane and tail tolerance take ``tpubench read``'s flags:
``--enable-tracing``, ``--flight-records``/``--flight-journal``,
``--telemetry-port``/``--telemetry-otlp``, ``--export cloud`` (dry-run
unless ``--metrics-live``), ``--hedge``/``--watchdog``/``--breaker`` (with
the ``--fault-*`` knobs of the fake store to give them something to do).
``--profile-dir`` traces the command with ``torch.profiler``.

``pod-ingest`` (``--ring``) fetches one object's byte-range shards, one
per rank, stages them and all-gathers them; ``stream`` does so for a
sequence of objects (``--objects``), fetching the next while the last is
staged and gathered (``--snapshot``/``--resume-from`` checkpoint and
continue it); ``gather-bench`` sweeps a collective (``--collective``,
``--shard-mb``, ``--reps``) over pod sizes; ``multichip-sweep`` runs
pod-ingest and the collectives in one child per pod size (``--sizes``);
``probe`` measures the host→device copy.

``train-ingest`` is a step-paced training loop over the ingest pipeline
(chunk cache, readahead prefetcher, page-locked slab pool): each step
takes ``--batch-shards`` chunks of ``--chunk-bytes``, stages them to the
card and sleeps ``--step-compute-ms``; it prints the data-stall
scorecard. ``--readahead 0`` is the cold arm, ``--no-slab-pool`` the
bytes arm, ``--pipeline-pod`` stages each step's batch as shards gathered
over the process group. ``--coop`` puts the cooperative chunk cache in
the miss path (``--coop-hosts``, ``--coop-host-id``, ``--coop-vnodes``,
``--peer-budget-bytes``, ``--no-coop-demote``); ``--coop-channel ici``
moves peer chunks by the pod's all-gather and needs ``--pipeline-pod
--readahead 0``.

``ckpt-save`` writes a sharded checkpoint (``--ckpt-objects`` ×
``--ckpt-object-bytes``) through resumable multi-part uploads
(``--ckpt-part-bytes``, ``--ckpt-writers``) and publishes its manifest
last; ``ckpt-restore`` fetches each rank's shard of every object
(``--ckpt-readers``), verifies it against the manifest's crc32s and
stages it onto the card (``--no-restore-device``: host RAM only;
``--no-ckpt-verify`` skips both commands' checks). Under ``--protocol
http|grpc`` with no ``--endpoint`` both run against an in-process fake
server. ``--results-bucket B`` (``--protocol http|grpc``) also uploads
each result file as ``results/<file>`` to bucket B.

``serve`` replays a seeded open-loop arrival schedule from many tenants
in priority classes (``--serve-rate``, ``--serve-duration``,
``--serve-arrival``, ``--serve-tenants``, ``--serve-classes``) into a
priority admission queue with deadline-aware shedding
(``--no-serve-qos``: FIFO); ``--serve-workers`` serve the requests
through the chunk cache and the backend stack, and it prints the
per-class scorecard. ``--serve-sweep`` steps the offered load to the
knee; ``--serve-hosts N`` with ``--membership-timeline`` runs an elastic
pod whose hosts are killed, paused, leave or rejoin under load. It stages
nothing onto the card. ``chaos`` runs ``--chaos-workload`` read,
pod-ingest, train-ingest or serve against the fake store or an
in-process fake server under a fault timeline (``--chaos-timeline``, or
``--chaos-fault`` / ``--chaos-start`` / ``--chaos-duration`` with the
``--fault-*`` values) and prints the resilience scorecard.

``meta-storm`` writes ``--meta-objects`` small objects and drives an
open-loop list/stat/open mix over them (``--meta-rate``,
``--meta-duration``, ``--meta-mix``, ``--meta-page-size``,
``--meta-workers``; ``--meta-sweep`` steps the offered load to the knee).
``drill`` is a serve run on an elastic pod (``--serve-hosts`` >= 2) with a
scripted incident: a host killed at ``--drill-kill-at``, a cold
replacement joining at ``--drill-join-at`` and restoring a checkpoint
(``--ckpt-*``) through the shared admission queue, while delta saves land
every ``--save-interval`` (``--restore-direct``, ``--full-saves``,
``--drill-meta-rate``, ``--drill-sweep``); it prints the drill scorecard.
``record <journal>... --out B`` distils a serve or drill run's flight
journal into a replay bundle (``tpubench``'s format); ``replay B``
re-drives it under the caller's system knobs (``--protocol fake``, or
``http`` with no ``--endpoint``) and prints the replay-vs-original block.
``fleet`` runs the elastic serve plane under virtual time at 64-4096
simulated hosts (``--fleet-hosts``, ``--fleet-pods``,
``--fleet-timeline``; ``--calibrate-from`` fits its service times from
flight journals, ``--fleet-profile`` writes or loads them,
``--fleet-sweep`` steps the offered load to the knee). None of these
touches the card.

``check`` runs the invariant-analysis passes over ``tpubench_torch/``
(``--json``, ``--allowlist``, ``--no-drift``, or a list of files): exit
0 clean, 1 on findings or a stale allowlist entry, 2 when the analyzer
itself is misconfigured. It needs no config and no device.

``sweep`` runs ``read`` over protocols × the reference's four object
sizes (``--sweep-protocols``, ``--sweep-sizes``, ``--sweep-native``) and
prints the rows; ``--protocol http --http2`` and ``--protocol grpc
--native-receive`` make ``pod-ingest`` fetch every range of the rank on
one connection. The filesystem workloads read and write files under
``--dir`` (``prepare`` writes them first; ``--no-direct`` skips
``O_DIRECT``; ``--mount-cmd``/``--unmount-cmd`` bracket the run).

``tune`` finds the operating point of ``read`` or (``--tune-workload
train-ingest``) ``train-ingest``: ``--tune-mode sweep`` (one short run per
knob value), ``online`` (the controller moves ``workers`` and the staging
depth live, or the readahead and prefetch workers; ``read --tune`` and
``train-ingest --tune`` do the same inside a plain run) or ``ab`` (both,
compared). ``--tune-profile PATH``
is where ``tune`` writes its recommendation and what every other command
applies. ``report <result.json>...`` renders results (``report timeline``
/ ``report trace <journal>...`` the flight journals; ``--fail-on`` gates
exit codes); ``top <journal>...`` is the live view (``--once`` one frame).

Every flag of ``tpubench``'s command line is taken with its meaning:
``--preset`` (the reference's four sizes, or ``smoke``; not with
``--config``), ``--save-config PATH`` (writes the effective config and
exits before any device is touched), ``--no-abort-on-error`` (per-worker
failure domains), ``--retry-deadline``/``--retry-max-attempts`` (bound
the reference's retry-for-ever), ``--profile-steps``, ``--project``,
``--ring`` and the no-op ``--staging-drain``; ``info`` prints the
effective config. A pod of H hosts is one command a host with
``--num-processes H --process-id h --coordinator host:port`` (or
``TPUBENCH_NUM_PROCESSES``/``_PROCESS_ID``/``_COORDINATOR``), as in
``tpubench``: a pod command runs there as one rank a visible card
(``dist/launch.py``), global rank h·L + l of H·L, NCCL on CUDA, gloo with
``--device cpu``; other commands run one process a host. A single
process's pod commands build a one-rank group. ``read`` then writes one
result per host (tagged ``p<h>``); the pod commands write global rank
0's.

Each command writes the same result JSON as ``tpubench``'s and prints its
path on the last line. It runs on CUDA unless ``--device cpu`` is given;
without a GPU it then exits nonzero instead of carrying on on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from tpubench_torch.config import (
    FLEET_TIMELINE_KINDS,
    MB,
    PRESET_NAMES,
    BenchConfig,
    preset,
    validate_coop_config,
    validate_drill_config,
    validate_fleet_config,
    validate_lifecycle_config,
    validate_pipeline_config,
    validate_serve_config,
    validate_telemetry_config,
    validate_tune_config,
)
from tpubench_torch.dist.launch import launched_ranks
from tpubench_torch.metrics.report import (
    RunResult,
    upload_result,
    write_result,
)

# Commands whose result is pod-global (the collectives run inside the
# workload): rank 0 writes the one report. ``read`` measures its own host,
# so every process reports.
POD_COLLECTIVE_CMDS = {"pod-ingest", "stream", "gather-bench"}
CKPT_CMDS = {
    "ckpt-save": "storage lifecycle: save a sharded checkpoint through "
                 "resumable multi-part uploads (session -> content-range "
                 "parts -> finalize, part-level retry/resume through the "
                 "fault plane); scorecard: save goodput, part p50/p99, "
                 "resumed parts, zero corrupt finalizes",
    "ckpt-restore": "storage lifecycle: restore the saved manifest, each "
                    "rank's shard of every object staged onto its card; "
                    "time-to-restore is the headline metric, bytes "
                    "verified against the manifest crc32s",
}
# Commands that touch no device, in ``tpubench`` as here: their group
# (several processes only) is gloo; each still resolves its device.
DEVICE_FREE_CMDS = {"serve", "meta-storm", "drill", "replay", "fleet"}
FS_CMDS = {
    "read-fs": "sequential FS read (read_operation)",
    "write": "durable write (write_operations)",
    "list": "listing bench (list_operation)",
    "open": "open/FD-hold bench (open_file)",
    "ssd": "block-latency percentiles (ssd_test)",
}
# sweep: size label -> (object bytes, reads a worker), read_operations.sh:8-14.
SWEEP_SIZES = {
    "256kb": (256 * 1024, 1000),
    "1mb": (1 * MB, 100),
    "100mb": (100 * MB, 10),
    "1gb": (1024 * MB, 1),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpubench_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add(name: str, help: str) -> argparse.ArgumentParser:
        p = sub.add_parser(name, help=help)
        _add_common(p)
        return p

    add("info", "print the effective config and the device capability "
                "report")
    add("read", "root read benchmark (main.go)")
    add("train-ingest", "step-paced training-loop ingest: chunk cache + "
                        "readahead prefetch + data-stall accounting (see "
                        "--cache-bytes/--readahead/--steps/"
                        "--step-compute-ms)")
    add("pod-ingest", "sharded object → every rank's device memory, "
                      "all-gathered over the process group")
    stream = add("stream", "pipelined multi-object pod ingest (fetch ∥ "
                           "stage+gather)")
    stream.add_argument("--objects", type=int, default=8)
    stream.add_argument("--snapshot", help="periodic progress snapshot JSON path")
    stream.add_argument("--resume-from",
                        help="resume a stream from a prior run's snapshot "
                             "JSON (tpubench's or the port's): objects "
                             "already delivered are skipped")
    gb = add("gather-bench", "collective bandwidth against pod size")
    gb.add_argument("--shard-mb", type=float, default=4.0)
    gb.add_argument("--reps", type=int, default=5)
    gb.add_argument("--collective",
                    choices=("all_gather", "ring", "reduce_scatter", "psum"),
                    default="",
                    help="which collective to benchmark (default "
                         "all_gather; --ring is shorthand for ring)")
    probe = add("probe", "host→device transfer-physics probe (fixed cost, "
                         "size sweep, burst/floor shaping, slow start)")
    probe.add_argument("--cycles", type=int, default=8,
                       help="identical measure cycles for burst/floor "
                            "detection")
    probe.add_argument("--cycle-sleep", type=float, default=2.0)
    tune = add("tune", "adaptive autotuner over read / train-ingest: "
                       "offline coordinate sweep or online AIMD session; "
                       "emits a convergence trace + a recommended-config "
                       "block (reusable via --tune-profile)")
    tune.add_argument("--tune-mode", choices=("sweep", "online", "ab"),
                      default="online",
                      help="sweep = offline coordinate sweep; online = "
                           "one adaptive session; ab = both plus the "
                           "static-vs-adaptive comparison")
    tune.add_argument("--tune-workload", choices=("read", "train-ingest"),
                      default="read",
                      help="workload the tuning session drives")
    for name, help_ in FS_CMDS.items():
        add(name, help_)
    for name, help_ in CKPT_CMDS.items():
        _add_lifecycle_flags(add(name, help_))
    _add_lifecycle_flags(add(
        "meta-storm", "storage lifecycle: open-loop list/stat/open storms "
                      "over many small objects, driven by the arrivals "
                      "plane (poisson/bursty/diurnal); --meta-sweep steps "
                      "offered load to the saturation knee"))
    chaos = add("chaos", "scripted fault timeline + resilience scorecard "
                         "(hermetic: fake backend or in-process fake "
                         "server; see --chaos-*)")
    chaos.add_argument("--chaos-workload",
                       choices=("read", "pod-ingest", "train-ingest",
                                "serve"),
                       default="read",
                       help="workload the fault timeline runs against "
                            "(train-ingest: the fault schedule exercises "
                            "the prefetcher — a blackhole shows up as "
                            "data-stall time, never a hang; serve: the "
                            "open-loop plane — with --serve-hosts >= 2 "
                            "the timeline may also carry host-level "
                            "kill_host/leave_host/pause_host/rejoin_host "
                            "entries that resize the pod under load)")
    chaos.add_argument("--chaos-timeline",
                       help="JSON [[t0,t1,{fault fields}],...] (seconds "
                            "from run start), or @path to a JSON file; "
                            "overrides the --chaos-fault trio")
    chaos.add_argument("--chaos-fault",
                       choices=("stall", "blackhole", "drip", "truncate",
                                "reset", "error", "latency"),
                       default="stall",
                       help="single-phase shorthand: which fault the "
                            "window injects (parameters from --fault-*)")
    chaos.add_argument("--chaos-start", type=float, default=2.0,
                       help="fault window start, seconds from run start")
    chaos.add_argument("--chaos-duration", type=float, default=2.0,
                       help="fault window length in seconds")
    # Elastic-pod knobs for chaos serve runs (--chaos-workload serve):
    # the host-level kill/leave/pause/rejoin entries ride
    # --chaos-timeline; these size the pod they act on.
    for flag, kw in (
        ("--serve-hosts", dict(type=int, dest="serve_hosts")),
        ("--serve-duration", dict(type=float, dest="serve_duration")),
        ("--serve-rate", dict(type=float, dest="serve_rate")),
        ("--serve-workers", dict(type=int, dest="serve_workers")),
        ("--resize-window", dict(type=float, dest="resize_window")),
    ):
        chaos.add_argument(flag, help=argparse.SUPPRESS, **kw)
    serve = add("serve", "open-loop multi-tenant traffic plane: arrival "
                         "processes (poisson/bursty/diurnal/trace) drive "
                         "thousands of Zipf-hot tenants with per-class "
                         "QoS — priority admission, weighted cache/"
                         "prefetch budgets, deadline-aware shedding — "
                         "through the full backend/cache stack; "
                         "--serve-sweep steps offered load to the "
                         "saturation knee")
    serve.add_argument("--serve-sweep", action="store_true",
                       help="step offered load through the configured "
                            "multipliers of --serve-rate and emit the "
                            "latency-vs-load curve with the knee "
                            "identified (p99 inflection)")
    _add_serve_flags(serve)
    drill = add("drill", "production incident drill: the elastic pod "
                         "serves open-loop multi-tenant traffic while a "
                         "scripted kill takes a host down and a cold "
                         "replacement joins and ckpt-restores THROUGH "
                         "the shared coop-cache/admission stack, with "
                         "periodic delta checkpoint saves riding under "
                         "the same traffic; scorecard: gold SLO during "
                         "the restore window vs steady state, "
                         "time-to-restore vs time-to-rewarm, origin-"
                         "byte amplification, per-phase blame")
    _add_serve_flags(drill)
    _add_lifecycle_flags(drill)
    _add_drill_flags(drill)
    fleet = add("fleet", "virtual-time fleet simulation: the SAME serve/"
                         "qos/membership/coop code under a discrete-"
                         "event driver instead of worker threads — "
                         "64-4096 simulated hosts, multi-pod topologies "
                         "with cross-pod routing, diurnal multi-tenant "
                         "mixes and correlated-failure / rolling-"
                         "upgrade membership timelines, scored by the "
                         "real serve + membership scorecards; service "
                         "times calibrate from flight journals via "
                         "--calibrate-from")
    _add_serve_flags(fleet)
    _add_fleet_flags(fleet)
    _add_replay_parsers(sub, add)
    prep = add("prepare", "generate worker-indexed data files")
    prep.add_argument("--layout", choices=("flat", "ssd"), default="flat")
    sweep = add("sweep", "protocol A/B × size sweep (execute_pb.sh)")
    sweep.add_argument("--sweep-protocols", default="http,grpc",
                       help="comma list of http,http2,grpc,fake — http2 is "
                            "the reference's ForceAttemptHTTP2 branch "
                            "(main.go:76-80) on the native h2 client")
    sweep.add_argument("--sweep-sizes", default="",
                       help=f"comma list of {','.join(SWEEP_SIZES)} "
                            "(default all)")
    sweep.add_argument("--sweep-native", action="store_true",
                       help="add a receive-path axis: every http and grpc "
                            "cell runs with the Python client AND the C++ "
                            "native receive")
    add("preflight", "validate auth/bucket/DirectPath/engine before a run")
    mcs = sub.add_parser(
        "multichip-sweep",
        help="pod-ingest + collective sweep over pod sizes (one child per "
             "size: gloo ranks on the CPU, or one rank on the card over "
             "NCCL; writes <results-dir>/multichip_sweep_torch.json)",
    )
    # The flags and their defaults live in tpubench_torch.dist.sweep.main;
    # this forwards what was typed.
    for flag in ("--sizes", "--shard-mb", "--reps", "--out", "--results-dir"):
        mcs.add_argument(flag)
    mcs.add_argument("--device", choices=("cuda", "cpu"))
    _add_top_parser(sub)
    _add_report_parser(sub)
    _add_check_parser(sub)
    return ap


def _add_check_parser(sub) -> None:
    chk = sub.add_parser(
        "check",
        help="invariant-analysis plane: AST passes mechanizing the "
             "recurring review findings (flight-op lifecycle, thread "
             "hygiene, slab-lease balance, determinism & bounds, "
             "catalog-drift guards, lock-order graph) over the "
             "tpubench_torch tree; nonzero exit on findings; vetted "
             "allowlist entries require justifications",
    )
    chk.add_argument("--json", action="store_true",
                     help="machine output (tpubench-check/1 schema)")
    chk.add_argument("--allowlist",
                     help="override the checked-in allowlist path "
                          "(tpubench_torch/analysis/allowlist.json)")
    chk.add_argument("--no-drift", action="store_true",
                     help="skip the runtime catalog-drift guards (pure "
                          "AST passes only — faster, no engine probe)")
    chk.add_argument("paths", nargs="*",
                     help="restrict analysis to these files (default: "
                          "the whole tpubench_torch tree)")


def _add_replay_parsers(sub, add) -> None:
    """``replay`` (the common flags and the SYSTEM half of the serve
    knobs: the scenario half comes from the bundle) and ``record``
    (journals in, a bundle out; no config), as ``tpubench``'s."""
    rpl = add("replay", "re-drive a recorded scenario bundle through the "
                        "CURRENT transport/cache/QoS/coop/membership "
                        "config: arrivals ride the trace schedule, faults "
                        "re-arm via FaultPlan, membership feeds the "
                        "elastic serve plane; prints the replay-vs-"
                        "original scorecard (hermetic: fake backend or "
                        "in-process fake server)")
    rpl.add_argument("bundle",
                     help="replay bundle path from `record` "
                          "(tpubench-bundle/1 JSON, .gz transparent)")
    rpl.add_argument("--serve-workers", type=int,
                     help="service worker threads for the replay arm")
    rpl.add_argument("--no-serve-qos", action="store_true",
                     help="replay the scenario with QoS off (an A/B arm "
                          "against the recorded baseline)")
    rpl.add_argument("--serve-admission-cap", type=int,
                     help="requests in service at once")
    rpl.add_argument("--serve-queue-limit", type=int,
                     help="queued requests before overload shedding")
    rpl.add_argument("--serve-readahead", type=int,
                     help="readahead depth in chunks over the replayed "
                          "schedule")
    recp = sub.add_parser(
        "record",
        help="distill a serve or drill run's flight journal(s) into a "
             "portable, versioned replay bundle (tpubench-bundle/1): "
             "arrival timeline, object population, fault plan, "
             "membership timeline, tenant/class map, config fingerprint "
             "— re-drivable via `replay`, diffable via `report "
             "--fail-on`",
    )
    recp.add_argument("journals", nargs="+",
                      help="flight-journal path(s) from ONE serve run "
                           "(per-host .p<idx> siblings merge; sweep "
                           ".pt<i> points are different runs — record "
                           "them separately)")
    recp.add_argument("--out", required=True,
                      help="bundle output path; a .gz suffix gzips "
                           "(canonical JSON either way, byte-stable "
                           "across re-records)")
    recp.add_argument("--name", default="",
                      help="scenario name stamped into the bundle "
                           "(default: the source bundle's name when "
                           "recording a replay journal, else derived "
                           "from the --out basename)")


def _add_top_parser(sub) -> None:
    topp = sub.add_parser(
        "top",
        help="live terminal view over streaming flight journals: rolling "
             "goodput GB/s(/chip), per-phase p50/p99, staging/hedge/"
             "breaker/tune counters, straggler-host highlighting",
    )
    topp.add_argument("journals", nargs="+",
                      help="flight-journal base path(s); per-host "
                           ".p<idx> siblings are discovered automatically")
    topp.add_argument("--interval", type=float, default=2.0,
                      help="refresh seconds (default 2)")
    topp.add_argument("--once", action="store_true",
                      help="print a single plain frame and exit")
    topp.add_argument("--window", type=float, default=10.0,
                      help="rolling-goodput window seconds (default 10)")
    topp.add_argument("--no-color", action="store_true",
                      help="plain frames (no ANSI highlighting)")
    topp.add_argument("--frames", type=int,
                      help="exit after N refreshes (default: run until "
                           "Ctrl-C)")


def _add_report_parser(sub) -> None:
    rep = sub.add_parser(
        "report",
        help="summarize/compare result JSONs (percentile blocks, A/B "
             "deltas, sweep and tune tables); `report timeline "
             "<journals...>` merges flight journals into per-phase "
             "p50/p99 + stragglers; `report trace <journals...>` "
             "stitches them into span trees with tail sampling, "
             "critical paths and the p99 blame table",
    )
    rep.add_argument("results", nargs="+",
                     help="result/sweep JSON paths — or `timeline`/"
                          "`trace` followed by flight-journal paths")
    rep.add_argument("--head-sample", type=float, default=0.05,
                     help="report trace: per-trace head-sample rate kept "
                          "in addition to the slowest decile (default "
                          "0.05; decided from the trace id)")
    rep.add_argument("--slow-keep", type=int, default=512,
                     help="report trace: memory bound on kept trees "
                          "(slowest win; default 512)")
    rep.add_argument("--show-traces", type=int, default=3,
                     help="report trace: how many slowest span trees to "
                          "print in full (default 3)")
    rep.add_argument("--fail-on", action="append", default=[],
                     metavar="EXPR",
                     help="regression gate <metric><op><threshold>, e.g. "
                          "'gbps<1.0'; repeatable — exit 1 when any gate "
                          "trips on any document, 2 when the metric "
                          "exists in none")


def _add_lifecycle_flags(p) -> None:
    """The storage-lifecycle flags (``tpubench``'s, the same defaults), on
    the ``ckpt-*``, ``meta-storm`` and ``drill`` parsers only."""
    p.add_argument("--ckpt-objects", type=int,
                   help="checkpoint shard-objects in the manifest "
                        "(default 4; one object per parameter shard)")
    p.add_argument("--ckpt-object-bytes", type=int,
                   help="bytes per shard-object (default 8 MiB)")
    p.add_argument("--ckpt-part-bytes", type=int,
                   help="resumable-upload part size (each part is one "
                        "content-range PUT; default 1 MiB)")
    p.add_argument("--ckpt-writers", type=int,
                   help="concurrent object uploads during ckpt-save "
                        "(default 4)")
    p.add_argument("--ckpt-readers", type=int,
                   help="concurrent shard fetches during ckpt-restore "
                        "(default 4)")
    p.add_argument("--ckpt-prefix",
                   help="object-name prefix; the manifest lands at "
                        "<prefix>MANIFEST.json (default ckpt/)")
    p.add_argument("--no-ckpt-verify", action="store_true",
                   help="skip the readback crc32 verification pass "
                        "(save) / shard byte-identity check (restore)")
    p.add_argument("--no-restore-device", action="store_true",
                   help="ckpt-restore: host-RAM restore only — skip "
                        "staging the shards onto the card")
    p.add_argument("--meta-objects", type=int,
                   help="meta-storm: small-object population size "
                        "(default 64)")
    p.add_argument("--meta-object-bytes", type=int,
                   help="meta-storm: bytes per small object (default 4 KiB)")
    p.add_argument("--meta-rate", type=float, dest="meta_rate",
                   help="meta-storm: offered metadata ops/second "
                        "(default 200)")
    p.add_argument("--meta-duration", type=float, dest="meta_duration",
                   help="meta-storm: virtual schedule seconds (default 2; "
                        "wall time scales with TPUBENCH_BENCH_SLEEP_SCALE)")
    p.add_argument("--meta-arrival", choices=("poisson", "bursty", "diurnal"),
                   help="meta-storm: arrival process (default poisson)")
    p.add_argument("--meta-mix",
                   help="meta-storm: op mix as kind:weight pairs over "
                        "list/stat/open (default list:1,stat:2,open:2)")
    p.add_argument("--meta-page-size", type=int,
                   help="meta-storm: maxResults page bound for list ops "
                        "(multi-page listings; default 16, 0 = one page)")
    p.add_argument("--meta-workers", type=int,
                   help="meta-storm: service worker threads the knee "
                        "saturates (default 8)")
    p.add_argument("--meta-sweep", action="store_true",
                   help="meta-storm: step offered load through the "
                        "multipliers and identify the saturation knee "
                        "(the --serve-sweep of metadata)")
    p.add_argument("--meta-sweep-points",
                   help="comma list of offered-load multipliers for "
                        "--meta-sweep (default 0.5,1,2,4)")
    p.add_argument("--lifecycle-seed", type=int,
                   help="arrival/mix seed (identical seeds replay "
                        "identical storms)")


def _add_drill_flags(p: argparse.ArgumentParser) -> None:
    """Flags owned by the ``drill`` subcommand — the incident script
    and the delta-save cadence (``tpubench``'s, the same defaults)."""
    p.add_argument("--drill-kill-at", type=float, dest="drill_kill_at",
                   help="virtual second the victim host is KILLED at "
                        "(default 1.0)")
    p.add_argument("--drill-join-at", type=float, dest="drill_join_at",
                   help="virtual second the cold replacement joins and "
                        "starts restoring (default 1.5; >= --drill-"
                        "kill-at)")
    p.add_argument("--drill-victim", type=int, dest="drill_victim",
                   help="host id to kill (default -1 = last host)")
    p.add_argument("--restore-class", dest="restore_class",
                   help="QoS class tag restore reads carry end-to-end "
                        "(default 'restore'; must not collide with a "
                        "serving class)")
    p.add_argument("--restore-priority", type=int, dest="restore_priority",
                   help="admission priority of restore reads "
                        "(default 1 — below gold, above best-effort)")
    p.add_argument("--restore-weight", type=float, dest="restore_weight",
                   help="cache/prefetch budget weight of the restore "
                        "class (default 2.0)")
    p.add_argument("--restore-deadline", type=float,
                   dest="restore_deadline",
                   help="restore-read deadline in ms (default 500)")
    p.add_argument("--restore-inflight", type=int, dest="restore_inflight",
                   help="restore reads in flight through the shared "
                        "admission queue (default 8)")
    p.add_argument("--restore-retries", type=int, dest="restore_retries",
                   help="re-stat retries per shard on torn reads "
                        "(default 3)")
    p.add_argument("--restore-direct", action="store_true",
                   dest="restore_direct",
                   help="A/B arm: restore reads bypass the coop cache "
                        "and fetch direct from origin (still holding "
                        "admission slots and cache budget)")
    p.add_argument("--save-interval", type=float, dest="save_interval",
                   help="virtual seconds between checkpoint saves under "
                        "traffic (default 1.0; 0 = no periodic saves)")
    p.add_argument("--full-saves", action="store_true", dest="full_saves",
                   help="A/B arm: every periodic save re-uploads ALL "
                        "shards instead of only dirty ones")
    p.add_argument("--dirty-fraction", type=float, dest="dirty_fraction",
                   help="fraction of shards each save pass dirties "
                        "(default 0.25)")
    p.add_argument("--drill-meta-rate", type=float, dest="drill_meta_rate",
                   help="concurrent metadata-storm mix, ops/second "
                        "(default 0 = no storm; shares the storm "
                        "quota ledger)")
    p.add_argument("--drill-sweep", action="store_true",
                   help="step the save interval through the multipliers "
                        "and locate the save-rate-vs-latency knee")
    p.add_argument("--drill-sweep-points",
                   help="comma list of save-interval multipliers for "
                        "--drill-sweep (default 0.5,1,2)")


def _add_fleet_flags(p: argparse.ArgumentParser) -> None:
    """Flags owned by the ``fleet`` subcommand — the simulated topology,
    the membership timeline generator, and the calibration plumbing."""
    p.add_argument("--fleet-hosts", type=int, dest="fleet_hosts",
                   help="simulated pod size, 64-4096 territory "
                        "(default 64; 0 = inherit --serve-hosts, the "
                        "agreement-gate arm)")
    p.add_argument("--fleet-pods", type=int, dest="fleet_pods",
                   help="partition the hosts into N pods with a "
                        "cross-pod routing ring above the per-pod "
                        "coop rings (default 0 = one pod per 128 "
                        "hosts, minimum one)")
    p.add_argument("--fleet-workers-per-host", type=int,
                   dest="fleet_workers_per_host",
                   help="simulated service slots per host (default 2; "
                        "0 = --serve-workers pod-wide, the "
                        "agreement-gate arm)")
    p.add_argument("--fleet-objects", type=int, dest="fleet_objects",
                   help="synthetic object population the Zipf tenant "
                        "mix draws over (default 64)")
    p.add_argument("--fleet-timeline", choices=FLEET_TIMELINE_KINDS,
                   dest="fleet_timeline",
                   help="generated membership timeline: "
                        "correlated_failure kills --fleet-fail-"
                        "fraction of the hosts at --fleet-fail-at, "
                        "rolling_upgrade pauses every host in "
                        "staggered windows (default none)")
    p.add_argument("--fleet-fail-at", type=float, dest="fleet_fail_at",
                   help="correlated_failure: virtual second the blast "
                        "lands (default 0.5)")
    p.add_argument("--fleet-fail-fraction", type=float,
                   dest="fleet_fail_fraction",
                   help="correlated_failure: fraction of hosts killed "
                        "together (default 0.1)")
    p.add_argument("--fleet-recover", type=float, dest="fleet_recover",
                   help="correlated_failure: seconds until the victims "
                        "rejoin cold (default 0 = they stay dead)")
    p.add_argument("--fleet-upgrade-pause", type=float,
                   dest="fleet_upgrade_pause",
                   help="rolling_upgrade: pause window per host in "
                        "virtual seconds (default 0.2)")
    p.add_argument("--fleet-seed", type=int, dest="fleet_seed",
                   help="victim-selection seed (identical seeds replay "
                        "identical blast patterns; default 20)")
    p.add_argument("--calibrate-from", nargs="+", dest="calibrate_from",
                   metavar="JOURNAL",
                   help="fit per-phase service times from flight "
                        "journal base paths (.p<idx> siblings and "
                        ".gz variants discovered like `top`); "
                        "phases with too few samples fall back to the "
                        "configured constants with a warning")
    p.add_argument("--fleet-profile", dest="fleet_profile",
                   help="service-time profile JSON: written here after "
                        "--calibrate-from, loaded from here otherwise "
                        "(the --tune-profile round-trip shape)")
    p.add_argument("--fleet-sweep", action="store_true",
                   dest="fleet_sweep",
                   help="step offered load through the serve sweep "
                        "multipliers under the virtual driver and "
                        "locate the knee (p99 inflection)")


def _add_serve_flags(p: argparse.ArgumentParser) -> None:
    """The serve-plane flag surface (``tpubench``'s, the same defaults),
    shared by the ``serve``, ``drill`` and ``fleet`` subcommands."""
    p.add_argument("--serve-duration", type=float,
                   help="virtual schedule length in seconds "
                        "(default 4; wall time scales with "
                        "TPUBENCH_BENCH_SLEEP_SCALE)")
    p.add_argument("--serve-rate", type=float,
                   help="aggregate offered load, requests/second "
                        "(default 200)")
    p.add_argument("--serve-arrival",
                   choices=("poisson", "bursty", "diurnal", "trace"),
                   help="arrival process (default poisson; bursty = "
                        "two-state MMPP, diurnal = sinusoidal-rate "
                        "Poisson, trace = replayed timestamps from "
                        "--serve-trace)")
    p.add_argument("--serve-trace",
                   help="replayed-trace arrivals: JSON list of "
                        "arrival seconds (implies "
                        "--serve-arrival trace)")
    p.add_argument("--serve-tenants", type=int,
                   help="synthetic tenant population (default 100), "
                        "expanded over the class shares")
    p.add_argument("--serve-classes",
                   help="priority-class spec: JSON list of {name, "
                        "share, weight, deadline_ms, priority} "
                        "dicts, inline or @path (default "
                        "gold/silver/best_effort)")
    p.add_argument("--serve-workers", type=int,
                   help="service worker threads (default 8)")
    p.add_argument("--no-serve-qos", action="store_true",
                   help="QoS off: FIFO admission, no shedding, no "
                        "weighted budgets — the baseline arm of "
                        "the QoS A/B")
    p.add_argument("--serve-admission-cap", type=int,
                   help="requests in service at once (default = "
                        "--serve-workers; live-tunable via the "
                        "workers tune knob)")
    p.add_argument("--serve-queue-limit", type=int,
                   help="queued requests before overload shedding "
                        "(QoS mode; default 8x workers)")
    p.add_argument("--serve-readahead", type=int,
                   help="readahead depth in chunks over the arrival "
                        "schedule (0 = demand-only, the default)")
    p.add_argument("--serve-burst-factor", type=float,
                   help="bursty: burst-to-quiet rate ratio "
                        "(default 4)")
    p.add_argument("--serve-burst-fraction", type=float,
                   help="bursty: fraction of each cycle bursting "
                        "(default 0.25)")
    p.add_argument("--serve-seed", type=int,
                   help="arrival/popularity seed (identical seeds "
                        "replay identical schedules)")
    p.add_argument("--serve-sweep-points",
                   help="comma list of offered-load multipliers for "
                        "--serve-sweep (default 0.25,0.5,1,2,4)")
    p.add_argument("--serve-hosts", type=int,
                   help="elastic pod: fan the serve plane across N "
                        "hermetic threaded hosts whose misses route "
                        "through coop-cache consistent-hash "
                        "ownership (default 1 = single-host plane)")
    p.add_argument("--membership-timeline",
                   help="elastic membership events: JSON list of "
                        "[t0, t1, {action: host}] entries (inline "
                        "or @path) in virtual schedule seconds — "
                        "actions kill_host / leave_host (warm "
                        "handoff) / pause_host (resumes at t1) / "
                        "rejoin_host")
    p.add_argument("--resize-window", type=float,
                   help="virtual seconds of resize window the "
                        "scorecard brackets each membership event "
                        "with (default 1.0)")


def _apply_serve_args(cfg: BenchConfig, args) -> None:
    """Fold the serve flags (on the ``serve``, ``drill``, ``replay`` and
    ``chaos`` parsers only) into ``cfg.serve`` and validate the section,
    as ``tpubench`` does for every command."""
    sv = cfg.serve
    for attr, dest in (
        ("serve_duration", "duration_s"), ("serve_rate", "rate_rps"),
        ("serve_tenants", "tenants"), ("serve_workers", "workers"),
        ("serve_admission_cap", "admission_cap"),
        ("serve_queue_limit", "queue_limit"),
        ("serve_readahead", "readahead"),
        ("serve_burst_factor", "burst_factor"),
        ("serve_burst_fraction", "burst_fraction"),
        ("serve_seed", "seed"),
        ("serve_hosts", "hosts"),
        ("resize_window", "resize_window_s"),
    ):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(sv, dest, v)
    if getattr(args, "membership_timeline", None):
        sv.membership_timeline = _json_arg(
            "--membership-timeline", args.membership_timeline)
    if getattr(args, "serve_arrival", None):
        sv.arrival = args.serve_arrival
    if getattr(args, "serve_trace", None):
        sv.trace_path = args.serve_trace
        sv.arrival = "trace"
    if getattr(args, "no_serve_qos", False):
        sv.qos = False
    if getattr(args, "serve_classes", None):
        sv.classes = _json_arg("--serve-classes", args.serve_classes)
    if getattr(args, "serve_sweep_points", None):
        sv.sweep_points = _float_list("--serve-sweep-points",
                                      args.serve_sweep_points)
    validate_serve_config(sv)


def _json_arg(flag: str, raw: str):
    """A JSON flag value, inline or ``@path``; bad JSON is a one-line
    ``SystemExit`` naming the flag."""
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            raw = f.read()
    try:
        return json.loads(raw)
    except json.JSONDecodeError as e:
        raise SystemExit(f"{flag}: invalid JSON: {e}") from None


def chaos_timeline_from_args(args) -> list:
    """The ``chaos`` fault timeline: explicit JSON (``--chaos-timeline``,
    inline or ``@file``), or the single-phase shorthand built from
    ``--chaos-fault``/``--chaos-start``/``--chaos-duration`` with fault
    parameters from the ``--fault-*`` flags (defaults per kind)."""
    if args.chaos_timeline:
        timeline = _json_arg("--chaos-timeline", args.chaos_timeline)
        if not isinstance(timeline, list):
            raise SystemExit(
                "--chaos-timeline: expected a JSON list of "
                "[t0, t1, {fault fields}] entries"
            )
        return timeline
    t0 = args.chaos_start
    t1 = t0 + args.chaos_duration

    def pick(attr, default):
        v = getattr(args, attr, None)
        return default if v is None else v

    kind = args.chaos_fault
    if kind == "stall":
        plan = {
            "stall_s": pick("fault_stall_s", 0.4),
            "stall_rate": pick("fault_stall_rate", 1.0),
            "stall_after_bytes": pick("fault_stall_after_bytes", 0),
        }
    elif kind == "blackhole":
        # Bytes stop and never resume within any sane window; hedges and
        # the watchdog are the only way out.
        plan = {
            "stall_s": 3600.0,
            "stall_rate": pick("fault_stall_rate", 1.0),
            "stall_after_bytes": pick("fault_stall_after_bytes", 0),
        }
    elif kind == "drip":
        plan = {"drip_bps": pick("fault_drip_bps", 64 * 1024)}
    elif kind == "truncate":
        plan = {"truncate_after_bytes":
                pick("fault_truncate_after_bytes", 64 * 1024)}
    elif kind == "reset":
        plan = {"reset_after_bytes": pick("fault_reset_after_bytes", 64 * 1024)}
    elif kind == "error":
        plan = {"error_rate": pick("fault_error_rate", 0.5)}
    else:  # latency
        plan = {"latency_s": pick("fault_latency_s", 0.2)}
    return [[t0, t1, plan]]


def _apply_lifecycle_args(cfg: BenchConfig, args) -> None:
    lc = cfg.lifecycle
    for attr, dest in (
        ("ckpt_objects", "objects"), ("ckpt_object_bytes", "object_bytes"),
        ("ckpt_part_bytes", "part_bytes"), ("ckpt_writers", "writers"),
        ("ckpt_readers", "readers"),
    ):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(lc, dest, v)
    if getattr(args, "ckpt_prefix", None):
        lc.prefix = args.ckpt_prefix
    if getattr(args, "no_ckpt_verify", False):
        lc.verify = False
    if getattr(args, "no_restore_device", False):
        lc.restore_device = False
    for attr, dest in (
        ("meta_objects", "meta_objects"),
        ("meta_object_bytes", "meta_object_bytes"),
        ("meta_rate", "meta_rate_rps"), ("meta_duration", "meta_duration_s"),
        ("meta_page_size", "meta_page_size"),
        ("meta_workers", "meta_workers"),
        ("lifecycle_seed", "seed"),
    ):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(lc, dest, v)
    if getattr(args, "meta_arrival", None):
        lc.meta_arrival = args.meta_arrival
    if getattr(args, "meta_mix", None):
        lc.meta_mix = args.meta_mix
    if getattr(args, "meta_sweep_points", None):
        lc.sweep_points = _float_list("--meta-sweep-points",
                                      args.meta_sweep_points)
    validate_lifecycle_config(lc)


def _float_list(flag: str, raw: str) -> list:
    try:
        return [float(x) for x in raw.split(",") if x]
    except ValueError:
        raise SystemExit(
            f"{flag} {raw!r}: expected a comma list of positive numbers"
        ) from None


def _apply_drill_args(cfg: BenchConfig, args) -> None:
    """Fold the drill flags into ``cfg.drill``; only the ``drill``
    command pays the drill's cross-plane checks (hosts >= 2, a restore
    class of its own), as in ``tpubench``."""
    dc = cfg.drill
    for attr, dest in (
        ("drill_kill_at", "kill_at_s"), ("drill_join_at", "join_at_s"),
        ("drill_victim", "victim"),
        ("restore_class", "restore_class"),
        ("restore_priority", "restore_priority"),
        ("restore_weight", "restore_weight"),
        ("restore_deadline", "restore_deadline_ms"),
        ("restore_inflight", "restore_inflight"),
        ("restore_retries", "restore_retries"),
        ("save_interval", "save_interval_s"),
        ("dirty_fraction", "dirty_fraction"),
        ("drill_meta_rate", "meta_rate_rps"),
    ):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(dc, dest, v)
    if getattr(args, "restore_direct", False):
        dc.restore_via_coop = False
    if getattr(args, "full_saves", False):
        dc.delta_saves = False
    if getattr(args, "drill_sweep_points", None):
        dc.sweep_points = _float_list("--drill-sweep-points",
                                      args.drill_sweep_points)
    if getattr(args, "cmd", None) == "drill":
        validate_drill_config(dc, cfg.serve)


def _apply_fleet_args(cfg: BenchConfig, args) -> None:
    """Fold the fleet flags into ``cfg.fleet``; only the ``fleet`` command
    pays fleet validation, so any other command carrying a config file
    with default fleet values is not refused."""
    fc = cfg.fleet
    for attr, dest in (
        ("fleet_hosts", "hosts"), ("fleet_pods", "pods"),
        ("fleet_workers_per_host", "workers_per_host"),
        ("fleet_objects", "objects"),
        ("fleet_timeline", "timeline"),
        ("fleet_fail_at", "fail_at_s"),
        ("fleet_fail_fraction", "fail_fraction"),
        ("fleet_recover", "recover_s"),
        ("fleet_upgrade_pause", "upgrade_pause_s"),
        ("fleet_seed", "seed"),
        ("fleet_profile", "profile_path"),
    ):
        v = getattr(args, attr, None)
        if v is not None:
            setattr(fc, dest, v)
    if getattr(args, "calibrate_from", None):
        fc.calibrate_from = list(args.calibrate_from)
    if getattr(args, "fleet_sweep", False):
        fc.sweep = True
    if getattr(args, "cmd", None) == "fleet":
        validate_fleet_config(fc, cfg.serve)


def _add_common(p) -> None:
    p.add_argument("--config", help="JSON config file (--save-config, this "
                                    "package's or tpubench's)")
    p.add_argument("--preset", choices=PRESET_NAMES,
                   help="named config: the reference's four object sizes "
                        "with their read counts (read_operations.sh:8-14), "
                        "or smoke (a tiny run on the fake store); not with "
                        "--config")
    p.add_argument("--protocol", choices=("http", "grpc", "local", "fake"),
                   help="storage protocol: http (JSON API), grpc (storage "
                        "v2, wire client), local (files under --dir), fake "
                        "(in-process store)")
    p.add_argument("--endpoint",
                   help="storage endpoint: http(s)://host:port for http, "
                        "insecure://host:port (h2c) or host:port (TLS) for "
                        "grpc")
    p.add_argument("--dir", help="root directory of the local protocol")
    p.add_argument("--native-receive", action="store_true",
                   help="C++ receive: http bodies stream from the socket "
                        "into the staging slot; grpc ReadObject lands in a "
                        "native buffer (pooled keep-alive connections)")
    p.add_argument("--http2", action="store_true",
                   help="every http GET over the native HTTP/2 client (the "
                        "reference's ForceAttemptHTTP2 branch, "
                        "main.go:76-80); h2c on http, TLS+ALPN on https")
    p.add_argument("--tls-ca-file",
                   help="CA bundle to trust for TLS endpoints (test "
                        "endpoints with a private CA)")
    p.add_argument("--tls-insecure-skip-verify", action="store_true",
                   help="skip TLS certificate verification (self-signed "
                        "test endpoints only)")
    p.add_argument("--key-file",
                   help="service-account key JSON for Google's endpoint "
                        "(default: application default credentials); a "
                        "test server's endpoint stays anonymous")
    p.add_argument("--bucket", help="GCS bucket name")
    p.add_argument("--project")
    p.add_argument("--object-name-prefix", dest="object_name_prefix",
                   help="object i is <prefix><i>")
    p.add_argument("--fetch-executor",
                   choices=("python", "native", "native-reactor",
                            "native-threads"),
                   help="python = worker-thread pool; native = C++ reactor "
                        "executor (slot-range GETs land in the staging "
                        "slots); native-reactor/native-threads pin a shape")
    p.add_argument("--workers", type=int)
    p.add_argument("--read-call-per-worker", type=int, dest="read_calls")
    p.add_argument("--threads", type=int, help="filesystem workloads' threads")
    p.add_argument("--read-count", type=int)
    p.add_argument("--write-count", type=int)
    p.add_argument("--block-size", type=int, help="KB", dest="block_size_kb")
    p.add_argument("--file-size-mb", type=int)
    p.add_argument("--read-type", choices=("seq", "random"))
    p.add_argument("--open-files", type=int)
    p.add_argument("--no-direct", action="store_true", help="skip O_DIRECT")
    p.add_argument("--mount-cmd",
                   help="shell template run before FS workloads; {dir} "
                        "expands (read_operations.sh:18 convention)")
    p.add_argument("--unmount-cmd",
                   help="shell template run after FS workloads; {dir} expands")
    p.add_argument("--rounds", type=int,
                   help="listing rounds (round 0 = cold, rest hot)")
    p.add_argument("--object-size", type=int, help="bytes (fake backend)")
    p.add_argument("--granule-bytes", type=int, help="fetch granule bytes")
    p.add_argument("--staging", choices=("none", "device_put", "pallas"),
                   help="device_put = copy ring; pallas = landing-kernel ring")
    p.add_argument("--validate", action="store_true",
                   help="device checksum of the landed bytes (copy ring)")
    p.add_argument("--depth", "--staging-depth", type=int,
                   dest="staging_depth",
                   help="in-flight staging depth (the staging_depth tune "
                        "knob)")
    p.add_argument("--staging-drain", choices=("inline", "thread"),
                   help="DEPRECATED no-op (kept for old scripts): depth>1 "
                        "always rides the overlapped staging executor "
                        "now; use --staging-depth 1 for the serial ring")
    p.add_argument("--no-double-buffer", action="store_true",
                   help="fully synchronous staging (depth 1)")
    p.add_argument("--slot-bytes", type=int,
                   help="staging slot target (capped by the host budget)")
    p.add_argument("--results-dir")
    p.add_argument("--results-bucket",
                   help="also upload result JSONs to this bucket via the "
                        "configured storage protocol (execute_pb.sh:5)")
    p.add_argument("--no-abort-on-error", action="store_true",
                   help="per-worker failure domains instead of errgroup abort")
    p.add_argument("--retry-deadline", type=float,
                   help="per-op retry deadline (s); bounds the reference's "
                        "retry-forever default — set this with --fault-* "
                        "rates near 1.0 or the run retries indefinitely")
    p.add_argument("--retry-max-attempts", type=int,
                   help="retry attempt cap (0 = unlimited, reference default)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--profile-dir",
                   help="trace the command with torch.profiler (host ops, "
                        "and the card's kernels and copies on CUDA) into a "
                        "Chrome trace JSON in this directory")
    p.add_argument("--profile-steps",
                   help="train-ingest: bound the capture to steps N:M "
                        "(inclusive; profiles the steady state, not "
                        "warmup); path + window stamped into "
                        "extra[\"profile\"]")
    p.add_argument("--ring", action="store_true",
                   help="pod-ingest: explicit send/recv ring instead of "
                        "all_gather; gather-bench: shorthand for "
                        "--collective ring")
    p.add_argument("--num-processes", type=int,
                   help="multi-host: host count (one process a host, one "
                        "rank a visible card); also TPUBENCH_NUM_PROCESSES")
    p.add_argument("--process-id", type=int,
                   help="multi-host: this host's index; also "
                        "TPUBENCH_PROCESS_ID")
    p.add_argument("--coordinator",
                   help="multi-host: host:port of host 0's rendezvous; "
                        "also TPUBENCH_COORDINATOR")
    p.add_argument("--save-config", help="write effective config JSON and exit")
    _add_obs_args(p)
    _add_fault_args(p)
    _add_tail_args(p)
    _add_pipeline_args(p)
    _add_tune_args(p)


def _add_pipeline_args(p) -> None:
    """The ingest pipeline's flags (``tpubench``'s, the same defaults)."""
    p.add_argument("--cache-bytes", type=int,
                   help="ingest pipeline: host chunk-cache budget in bytes "
                        "(LRU, single-flight dedup; 0 disables caching)")
    p.add_argument("--readahead", type=int,
                   help="ingest pipeline: readahead depth in chunks the "
                        "prefetcher keeps scheduled ahead of the consumer "
                        "(0 = cold demand reads, the A/B baseline)")
    p.add_argument("--readahead-bytes", type=int,
                   help="ingest pipeline: prefetch byte budget (in-flight "
                        "+ unconsumed prefetched bytes; 0 = depth-bounded)")
    p.add_argument("--prefetch-workers", type=int,
                   help="ingest pipeline: prefetch worker threads")
    p.add_argument("--steps", type=int,
                   help="train-ingest: training steps per epoch")
    p.add_argument("--epochs", type=int,
                   help="train-ingest: epochs (the plan repeats; epoch 2+ "
                        "measures the warm-cache path)")
    p.add_argument("--batch-shards", type=int,
                   help="train-ingest: chunks consumed per step")
    p.add_argument("--chunk-bytes", type=int,
                   help="ingest pipeline: chunk size in bytes "
                        "(default: workload.granule_bytes)")
    p.add_argument("--step-compute-ms", type=float,
                   help="train-ingest: synthetic per-step compute window "
                        "(ms) the prefetcher hides fetch latency behind")
    p.add_argument("--stall-threshold-ms", type=float,
                   help="train-ingest: a step whose data wait exceeds this "
                        "counts as a stalled step")
    p.add_argument("--pipeline-pod", action="store_true",
                   help="train-ingest: stage each step's batch as "
                        "byte-range shards, one per rank, and all-gather "
                        "them over the process group instead of the "
                        "slot-ring path")
    p.add_argument("--slab-bytes", type=int,
                   help="zero-copy datapath: slab size in bytes for the "
                        "page-locked chunk-buffer pool (0 = one chunk per "
                        "slab; must hold at least one chunk)")
    p.add_argument("--pool-slabs", type=int,
                   help="zero-copy datapath: slab pool capacity (0 = "
                        "auto-sized from cache budget + readahead + "
                        "batch; exhaustion spills to counted pageable "
                        "overflow leases, never blocks)")
    p.add_argument("--no-slab-pool", action="store_true",
                   help="disable the zero-copy slab datapath: chunks "
                        "materialize as bytes (2+ host-RAM copies per "
                        "chunk — the copies-per-byte A/B baseline arm)")
    p.add_argument("--coop", action="store_true",
                   help="cooperative chunk cache: consistent-hash chunk "
                        "ownership across the pod's hosts, peer-first "
                        "miss resolution, pod-wide single-flight (only "
                        "the owner fetches a chunk from origin) and "
                        "straggler-aware owner demotion")
    p.add_argument("--coop-hosts", type=int,
                   help="hosts on the ownership ring (default 0 = "
                        "--num-processes)")
    p.add_argument("--coop-host-id", type=int,
                   help="this host's ring id (default -1 = --process-id)")
    p.add_argument("--coop-vnodes", type=int,
                   help="virtual nodes per host on the consistent-hash "
                        "ring (default 64)")
    p.add_argument("--peer-budget-bytes", type=int,
                   help="serve-side byte budget: bytes concurrently "
                        "served to peers never exceed this — past it the "
                        "owner sheds and peers fall back to origin "
                        "(0 = unbounded; live-tunable)")
    p.add_argument("--coop-channel", choices=("auto", "loopback", "ici"),
                   help="peer transport: loopback = in-process "
                        "request/reply; ici = lockstep all-gather over the "
                        "pod's process group (NCCL on CUDA; needs "
                        "--pipeline-pod --readahead 0); auto = loopback")
    p.add_argument("--no-coop-demote", action="store_true",
                   help="disable straggler-aware owner demotion (keep "
                        "slow-decile hosts on the ownership ring)")


def _apply_pipeline_args(cfg: BenchConfig, args) -> None:
    pl = cfg.pipeline
    for attr in (
        "cache_bytes", "readahead", "readahead_bytes", "prefetch_workers",
        "steps", "epochs", "batch_shards", "chunk_bytes",
        "step_compute_ms", "stall_threshold_ms",
        "slab_bytes", "pool_slabs",
    ):
        v = getattr(args, attr)
        if v is not None:
            setattr(pl, attr, v)
    if args.pipeline_pod:
        pl.pod = True
    if args.no_slab_pool:
        pl.slab_pool = False
    validate_pipeline_config(pl, staging=cfg.staging)
    co = cfg.coop
    if args.coop:
        co.enabled = True
    for attr, dest in (
        ("coop_hosts", "hosts"), ("coop_host_id", "host_id"),
        ("coop_vnodes", "vnodes"),
        ("peer_budget_bytes", "peer_budget_bytes"),
    ):
        v = getattr(args, attr)
        if v is not None:
            setattr(co, dest, v)
    if args.coop_channel:
        co.channel = args.coop_channel
    if args.no_coop_demote:
        co.demote = False
    validate_coop_config(co)


def _add_tune_args(p) -> None:
    """The tune plane's flags (``tpubench``'s, the same defaults)."""
    p.add_argument("--tune", action="store_true",
                   help="run the online controller during this run: "
                        "worker fan-out (read) or readahead and prefetch "
                        "workers (train-ingest), the staging depth and the "
                        "hedge delay become live knobs driven by windowed "
                        "goodput under a p99 guardrail")
    p.add_argument("--tune-window", type=float,
                   help="tune decision window seconds (default 0.5)")
    p.add_argument("--tune-warmup", type=int,
                   help="baseline windows before the first probe "
                        "(default 2)")
    p.add_argument("--tune-p99-guard", type=float,
                   help="p99 guardrail: probes whose window p99 exceeds "
                        "baseline x this revert regardless of goodput "
                        "(default 2.0)")
    p.add_argument("--tune-epsilon", type=float,
                   help="minimum relative goodput gain to accept a probe "
                        "(default 0.05)")
    p.add_argument("--tune-duration", type=float,
                   help="online read tuning session length seconds "
                        "(default 8)")
    p.add_argument("--tune-knobs",
                   help="comma list of knobs the controller may actuate "
                        "(read: workers,staging_depth,hedge_delay_s; "
                        "train-ingest: readahead,readahead_bytes,"
                        "prefetch_workers,staging_depth,hedge_delay_s,"
                        "peer_budget_bytes,coop)")
    p.add_argument("--tune-profile",
                   help="tune profile JSON: `tune` WRITES the recommended "
                        "operating point here; every other command READS "
                        "it and applies the recommended knob values over "
                        "the config")


def _apply_tune_args(cfg: BenchConfig, args) -> None:
    tn = cfg.tune
    if args.tune:
        tn.enabled = True
    for attr, dest in (
        ("tune_window", "window_s"), ("tune_warmup", "warmup_windows"),
        ("tune_p99_guard", "p99_guard"), ("tune_epsilon", "epsilon"),
        ("tune_duration", "duration_s"),
    ):
        v = getattr(args, attr)
        if v is not None:
            setattr(tn, dest, v)
    if args.tune_knobs:
        tn.knobs = [k.strip() for k in args.tune_knobs.split(",") if k.strip()]
    validate_tune_config(tn)


def _add_obs_args(p) -> None:
    """Tracing, flight recorder, telemetry and metric export (the flags,
    defaults and help of ``tpubench read``)."""
    p.add_argument("--enable-tracing", action="store_true")
    p.add_argument("--trace-sample-rate", type=float)
    p.add_argument("--trace-exporter", choices=("console", "cloud_trace"),
                   help="span export path (with --enable-tracing)")
    p.add_argument("--flight-journal",
                   help="write the per-host flight-recorder journal JSON "
                        "here (per-read phase timelines; multi-host "
                        "processes suffix .p<idx>; a .gz path writes "
                        "gzip-compressed)")
    p.add_argument("--journal-max-bytes", type=int,
                   help="size bound for each journal write: a flush "
                        "that would exceed it drops the OLDEST records "
                        "with a counted rotation_dropped note (0 = "
                        "unbounded) — long runs streaming journals "
                        "can't fill the disk")
    p.add_argument("--telemetry-port", type=int,
                   help="serve live run telemetry over loopback HTTP: "
                        "Prometheus text exposition at /metrics + JSON "
                        "/snapshot (0 = ephemeral port, printed at "
                        "start; off by default)")
    p.add_argument("--telemetry-interval", type=float,
                   help="telemetry registry tick seconds: gauge refresh, "
                        "recorder/native-counter sampling and the "
                        "in-run journal stream cadence (default 1.0)")
    p.add_argument("--telemetry-otlp", action="store_true",
                   help="periodic OTLP-shaped JSON metric export "
                        "(dry-run capture stamped into the result "
                        "unless --telemetry-otlp-endpoint is set)")
    p.add_argument("--telemetry-otlp-endpoint",
                   help="POST OTLP/HTTP JSON metric payloads here every "
                        "telemetry.otlp_interval_s (implies "
                        "--telemetry-otlp; stdlib urllib, no SDK)")
    p.add_argument("--flight-records", type=int,
                   help="flight-recorder ring capacity per worker "
                        "(newest records kept; 0 disables the layer)")
    p.add_argument("--export", choices=("none", "json", "cloud"),
                   help="metric export: cloud = in-run periodic push of full "
                        "latency histograms (metrics_exporter.go:36-58); "
                        "dry-run capture unless --metrics-live")
    p.add_argument("--metrics-interval", type=float,
                   help="export interval seconds (reference: 30)")
    p.add_argument("--metrics-live", action="store_true",
                   help="really push to Cloud Monitoring (needs "
                        "google-cloud-monitoring + GCP creds; default is "
                        "dry-run capture stamped into the result)")


_FAULT_FLAGS = (
    # (flag, FaultConfig field, type, help)
    ("--fault-error-rate", "error_rate", float,
     "fake backend: P(open raises transient 503)"),
    ("--fault-read-error-rate", "read_error_rate", float,
     "fake backend: P(granule read fails mid-stream)"),
    ("--fault-latency", "latency_s", float,
     "fake backend: added first-byte latency (s)"),
    ("--fault-per-read-latency", "per_read_latency_s", float,
     "fake backend: added latency per granule read (s)"),
    ("--fault-stall-s", "stall_s", float,
     "chaos plane: one mid-body pause of this many seconds per reader "
     "(very large = blackhole)"),
    ("--fault-stall-after-bytes", "stall_after_bytes", int,
     "chaos plane: the stall triggers after this many delivered bytes "
     "(default 0 = at first byte)"),
    ("--fault-stall-rate", "stall_rate", float,
     "chaos plane: P(a given reader stalls at all) — <1 makes the stall "
     "a straggler, the shape hedged reads race against"),
    ("--fault-drip-bps", "drip_bps", float,
     "chaos plane: per-reader throughput cap (bytes/s; the slow-drip the "
     "stall watchdog detects)"),
    ("--fault-truncate-after-bytes", "truncate_after_bytes", int,
     "chaos plane: clean EOF after N bytes, short of the announced length"),
    ("--fault-reset-after-bytes", "reset_after_bytes", int,
     "chaos plane: kill the stream abruptly after N bytes (reset/RST "
     "shape)"),
)


def _add_fault_args(p) -> None:
    for flag, field, typ, hlp in _FAULT_FLAGS:
        p.add_argument(flag, type=typ, dest=f"fault_{field}", help=hlp)


def _add_tail_args(p) -> None:
    p.add_argument("--hedge", action="store_true",
                   help="tail tolerance: race a second ranged read when "
                        "the first byte is late; first winner streams, "
                        "loser cancelled (wins/losses/waste recorded)")
    p.add_argument("--hedge-delay", type=float,
                   help="seconds before the hedge launches (default 0.05)")
    p.add_argument("--hedge-from-p99", action="store_true",
                   help="derive the hedge delay from the run's rolling "
                        "p99 first-byte latency instead of the fixed "
                        "--hedge-delay (which becomes the floor)")
    p.add_argument("--watchdog", action="store_true",
                   help="tail tolerance: cancel+resume a stream whose "
                        "throughput stays below --stall-floor-bps for "
                        "--stall-window seconds")
    p.add_argument("--stall-window", type=float,
                   help="watchdog stall window seconds (default 1.0)")
    p.add_argument("--stall-floor-bps", type=float,
                   help="watchdog throughput floor bytes/s (default 1024)")
    p.add_argument("--breaker", action="store_true",
                   help="tail tolerance: per-backend circuit breaker "
                        "(closed→open→half-open) shedding a failing "
                        "endpoint instead of hammering it")
    p.add_argument("--breaker-failures", type=int,
                   help="consecutive failures that open the breaker "
                        "(default 5)")
    p.add_argument("--breaker-reset", type=float,
                   help="seconds the breaker stays open before probing "
                        "(default 5.0)")
    p.add_argument("--breaker-probes", type=int,
                   help="half-open probe successes required to close "
                        "(default 1)")


def build_config(args) -> BenchConfig:
    if args.preset and args.config:
        raise SystemExit("--preset and --config are mutually exclusive")
    if args.config:
        with open(args.config) as f:
            cfg = BenchConfig.from_json(f.read())
    elif args.preset:
        cfg = preset(args.preset)
    else:
        cfg = BenchConfig()
    # --tune-profile on any command but `tune` (where it is the OUTPUT
    # path) applies a written recommendation, BEFORE the flags below, so
    # an explicit flag on the same command line wins over the profile.
    if args.tune_profile and args.cmd != "tune":
        from tpubench_torch.workloads.tune_cmd import apply_tune_profile

        apply_tune_profile(cfg, args.tune_profile)
    w, s = cfg.workload, cfg.staging
    for attr, dest in (
        ("workers", "workers"), ("read_calls", "read_calls_per_worker"),
        ("object_size", "object_size"), ("granule_bytes", "granule_bytes"),
        ("bucket", "bucket"), ("project", "project"),
        ("object_name_prefix", "object_name_prefix"),
        ("fetch_executor", "fetch_executor"), ("threads", "threads"),
        ("read_count", "read_count"), ("write_count", "write_count"),
        ("block_size_kb", "block_size_kb"), ("file_size_mb", "file_size_mb"),
        ("read_type", "read_type"), ("open_files", "open_files"),
        ("mount_cmd", "mount_cmd"), ("unmount_cmd", "unmount_cmd"),
        ("rounds", "list_rounds"),
    ):
        v = getattr(args, attr)
        if v is not None:
            setattr(w, dest, v)
    t = cfg.transport
    if args.protocol:
        t.protocol = args.protocol
    if args.endpoint:
        t.endpoint = args.endpoint
    if args.dir:
        w.dir = args.dir
    if args.native_receive:
        t.native_receive = True
    if args.http2:
        t.http2 = True
    if args.key_file:
        t.key_file = args.key_file
    if args.tls_ca_file:
        t.tls_ca_file = args.tls_ca_file
    if args.tls_insecure_skip_verify:
        t.tls_insecure_skip_verify = True
    if args.staging:
        s.mode = args.staging
    if args.staging_drain:
        s.drain = args.staging_drain
    if args.staging_depth is not None:
        if args.staging_depth < 1:
            raise SystemExit(f"--depth {args.staging_depth}: must be >= 1")
        s.depth = args.staging_depth
    if args.no_double_buffer:
        s.double_buffer = False
    if args.validate:
        s.validate_checksum = True
    if args.slot_bytes is not None:
        s.slot_bytes = args.slot_bytes
    if args.results_dir:
        cfg.obs.results_dir = args.results_dir
    if args.results_bucket:
        cfg.obs.results_bucket = args.results_bucket
    if args.profile_dir:
        cfg.obs.profile_dir = args.profile_dir
    if args.profile_steps:
        cfg.obs.profile_steps = args.profile_steps
        # A malformed window fails here, not at step N of the run.
        from tpubench_torch.obs.profiling import parse_profile_steps

        parse_profile_steps(cfg.obs.profile_steps)
    if args.no_abort_on_error:
        w.abort_on_error = False
    if args.retry_deadline is not None:
        t.retry.deadline_s = args.retry_deadline
    if args.retry_max_attempts is not None:
        t.retry.max_attempts = args.retry_max_attempts
    _apply_dist_args(cfg, args)
    _apply_obs_args(cfg, args)
    for _, field, _, _ in _FAULT_FLAGS:
        v = getattr(args, f"fault_{field}")
        if v is not None:
            setattr(t.fault, field, v)
    _apply_tail_args(cfg.transport.tail, args)
    _apply_pipeline_args(cfg, args)
    _apply_tune_args(cfg, args)
    _apply_lifecycle_args(cfg, args)
    _apply_serve_args(cfg, args)
    _apply_drill_args(cfg, args)
    _apply_fleet_args(cfg, args)
    if cfg.obs.results_bucket and t.protocol not in ("http", "grpc"):
        # Fail at parse time, not after an hour-long run: upload_result
        # needs an object-store protocol ('local' roots at workload.dir,
        # 'fake' drops the bytes in a throwaway in-process store).
        raise SystemExit(
            f"--results-bucket requires --protocol http|grpc, "
            f"not {t.protocol!r}"
        )
    return cfg


def _apply_dist_args(cfg: BenchConfig, args) -> None:
    """Flags win over the environment, so one launch template serves every
    host of a pod (``tpubench/cli.py:990-1016``). They name the host; a
    rank the launcher started takes its own place from the launcher
    alone (``launch.member``)."""
    d = cfg.dist
    env = os.environ
    if env.get("TPUBENCH_NUM_PROCESSES"):
        d.num_processes = int(env["TPUBENCH_NUM_PROCESSES"])
    if env.get("TPUBENCH_PROCESS_ID"):
        d.process_id = int(env["TPUBENCH_PROCESS_ID"])
    if env.get("TPUBENCH_COORDINATOR"):
        d.coordinator_address = env["TPUBENCH_COORDINATOR"]
    pid_given = bool(env.get("TPUBENCH_PROCESS_ID"))
    if args.num_processes is not None:
        d.num_processes = args.num_processes
    if args.process_id is not None:
        d.process_id = args.process_id
        pid_given = True
    if args.coordinator:
        d.coordinator_address = args.coordinator
    if d.num_processes <= 1 and (pid_given or d.coordinator_address):
        # A pod member that dropped --num-processes must not run alone
        # while the rest of the pod waits for it.
        raise SystemExit(
            "--process-id/--coordinator set but --num-processes is 1: "
            "pass the pod's total process count on every host"
        )


def _apply_obs_args(cfg: BenchConfig, args) -> None:
    o = cfg.obs
    if args.enable_tracing:
        o.enable_tracing = True
    if args.trace_sample_rate is not None:
        o.trace_sample_rate = args.trace_sample_rate
    if args.trace_exporter:
        o.trace_exporter = args.trace_exporter
    if args.flight_journal:
        o.flight_journal = args.flight_journal
    if args.journal_max_bytes is not None:
        if args.journal_max_bytes < 0:
            raise SystemExit(
                f"--journal-max-bytes {args.journal_max_bytes}: must be "
                ">= 0 (0 = unbounded)"
            )
        o.journal_max_bytes = args.journal_max_bytes
    tel = cfg.telemetry
    if args.telemetry_port is not None:
        tel.port = args.telemetry_port
        # -1 is the documented "off" value: it must not flip the switch.
        tel.enabled = args.telemetry_port >= 0
    if args.telemetry_interval is not None:
        tel.interval_s = args.telemetry_interval
    if args.telemetry_otlp:
        tel.otlp = True
    if args.telemetry_otlp_endpoint:
        tel.otlp = True
        tel.otlp_endpoint = args.telemetry_otlp_endpoint
    validate_telemetry_config(tel)
    if args.flight_records is not None:
        if args.flight_records < 0:
            raise SystemExit(
                f"--flight-records {args.flight_records}: must be >= 0 "
                "(0 disables the flight recorder)"
            )
        o.flight_records = args.flight_records
    if args.export:
        o.export = args.export
    if args.metrics_interval is not None:
        o.metrics_interval_s = args.metrics_interval
    if args.metrics_live:
        if args.export and args.export != "cloud":
            raise SystemExit("--metrics-live requires --export cloud")
        o.export = "cloud"  # the flag implies the cloud path; never a no-op
        o.export_dry_run = False


def _apply_tail_args(tail, args) -> None:
    if args.hedge:
        tail.hedge = True
    if args.hedge_delay is not None:
        tail.hedge_delay_s = args.hedge_delay
    if args.hedge_from_p99:
        tail.hedge = True  # the adaptive delay implies hedging
        tail.hedge_from_p99 = True
    if args.watchdog:
        tail.watchdog = True
    if args.stall_window is not None:
        tail.stall_window_s = args.stall_window
    if args.stall_floor_bps is not None:
        tail.stall_floor_bps = args.stall_floor_bps
    if args.breaker:
        tail.breaker = True
    if args.breaker_failures is not None:
        tail.breaker_failures = args.breaker_failures
    if args.breaker_reset is not None:
        tail.breaker_reset_s = args.breaker_reset
    if args.breaker_probes is not None:
        tail.breaker_probes = args.breaker_probes
    if tail.hedge_delay_s < 0:
        raise SystemExit(
            f"--hedge-delay {tail.hedge_delay_s}: must be >= 0"
        )
    if tail.stall_window_s <= 0:
        raise SystemExit(
            f"--stall-window {tail.stall_window_s}: must be > 0"
        )
    if tail.stall_floor_bps < 0:
        raise SystemExit(
            f"--stall-floor-bps {tail.stall_floor_bps}: must be >= 0"
        )


def read(cfg: BenchConfig, device="cuda", backend=None) -> RunResult:
    """The ``read`` command: stage through the ring ``cfg.staging.mode``
    selects, onto ``device``, under the tracer ``obs.enable_tracing``
    asks for (shut down, so batched spans flush, when the run ends)."""
    from tpubench_torch.obs.tracing import tracer_session
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    with tracer_session(cfg) as tracer:
        return run_read(
            cfg, backend=backend, device=device, tracer=tracer,
            sink_factory=make_sink_factory(cfg, device=device),
        )


def execute(cmd: str, cfg: BenchConfig, device="cuda", backend=None,
            args=None) -> RunResult:
    """One command as ``main`` runs it: bring-up (a one-rank group for the
    pod commands of a single process), the run under ``obs.profile_dir``'s
    profiler, the topology stamped when several processes ran. ``args``
    carries the command's own flags (parser defaults when ``None``)."""
    from tpubench_torch.dist import bringup
    from tpubench_torch.obs.profiling import maybe_profile

    if args is None:
        args = build_parser().parse_args([cmd])
    # A single process's pod commands get a one-rank group. ckpt-save, a
    # host-RAM restore and serve touch no device: their group (several
    # processes only) is gloo. serve still resolves its device, as every
    # entry point does.
    chaos_wl = getattr(args, "chaos_workload", "") if cmd == "chaos" else ""
    one_rank = pod_command(cmd, cfg, args)
    group_device = device
    device_free = cmd in DEVICE_FREE_CMDS or chaos_wl == "serve"
    if (cmd in CKPT_CMDS or device_free) and not one_rank:
        group_device = "cpu"
    if device_free:
        from tpubench_torch.device import resolve_device

        resolve_device(device)
    # train-ingest owns its capture (StepProfiler: the step window, the
    # extra["profile"] stamp); the whole-run wrap steps aside for it.
    outer_profile = "" if cmd == "train-ingest" else cfg.obs.profile_dir
    with bringup.session(cfg.dist, group_device,
                         one_rank_group=one_rank) as topo:
        with maybe_profile(outer_profile, device):
            if cmd == "read":
                res = read(cfg, device=device, backend=backend)
            elif cmd == "train-ingest":
                from tpubench_torch.workloads.train_ingest import (
                    format_pipeline_scorecard,
                    run_train_ingest,
                )

                res = run_train_ingest(cfg, backend=backend, device=device)
                pipe = res.extra["pipeline"]
                print(format_pipeline_scorecard(pipe))
                pool = pipe["copies"].get("pool")
                if pool:
                    print(f"  pool: leaked_slabs={pool['leaked_slabs']} "
                          f"overflow_leases={pool['overflow_leases']} "
                          f"page-locked={pool['native']} in "
                          f"{pipe['pool_pin_seconds']:.3f} s (before the "
                          "timed window)")
            elif cmd == "pod-ingest":
                from tpubench_torch.workloads.pod_ingest import run_pod_ingest

                res = run_pod_ingest(cfg, backend=backend, ring=args.ring,
                                     device=device)
            elif cmd == "stream":
                from tpubench_torch.workloads.pod_ingest_stream import (
                    run_pod_ingest_stream,
                )

                res = run_pod_ingest_stream(
                    cfg, n_objects=args.objects, backend=backend,
                    verify=args.validate, snapshot_path=args.snapshot,
                    resume_from=args.resume_from, device=device,
                )
            elif cmd == "gather-bench":
                from tpubench_torch.workloads.gather_bench import (
                    run_gather_bench,
                )

                res = run_gather_bench(
                    cfg, shard_mb=args.shard_mb, reps=args.reps,
                    ring=args.ring, collective=args.collective, device=device,
                )
            elif cmd == "probe":
                from tpubench_torch.workloads.probe import run_probe

                res = run_probe(cfg, cycles=args.cycles,
                                sleep_s=args.cycle_sleep, device=device)
            elif cmd == "tune":
                from tpubench_torch.obs.tracing import tracer_session
                from tpubench_torch.workloads.tune_cmd import (
                    format_tune_block,
                    run_tune,
                )

                with tracer_session(cfg) as tracer:
                    res = run_tune(
                        cfg, mode=args.tune_mode,
                        workload=args.tune_workload,
                        profile_path=args.tune_profile or "",
                        tracer=tracer, backend=backend, device=device,
                    )
                print(format_tune_block(res.extra["tune"]))
            elif cmd in FS_CMDS:
                res = run_fs(cmd, cfg, direct=not args.no_direct)
            elif cmd in CKPT_CMDS:
                from tpubench_torch.lifecycle import (
                    format_lifecycle_scorecard,
                )
                from tpubench_torch.workloads.chaos import hermetic_target
                from tpubench_torch.workloads.ckpt import (
                    run_ckpt_restore,
                    run_ckpt_save,
                )

                # http/grpc with no endpoint = hermetic: the run goes to
                # the matching in-process fake server, transport.fault
                # injected on the wire; a restore's ranks share rank 0's.
                with hermetic_target(cfg, shared=one_rank):
                    if cmd == "ckpt-save":
                        res = run_ckpt_save(cfg, backend=backend)
                    else:
                        res = run_ckpt_restore(cfg, backend=backend,
                                               device=device)
                print(format_lifecycle_scorecard(res.extra["lifecycle"]))
            elif cmd == "chaos":
                res = _chaos(cfg, args, device)
            elif cmd == "serve":
                from tpubench_torch.obs.tracing import tracer_session
                from tpubench_torch.workloads.serve import (
                    format_membership_scorecard,
                    format_serve_scorecard,
                    run_serve,
                    run_serve_sweep,
                )

                with tracer_session(cfg) as tracer:
                    if args.serve_sweep:
                        res = run_serve_sweep(cfg, tracer=tracer,
                                              backend=backend, device=device)
                    else:
                        res = run_serve(cfg, backend=backend, tracer=tracer,
                                        device=device)
                print(format_serve_scorecard(res.extra["serve"]))
                if res.extra.get("membership"):
                    print(format_membership_scorecard(
                        res.extra["membership"]))
            elif cmd == "meta-storm":
                from tpubench_torch.lifecycle import (
                    format_lifecycle_scorecard,
                )
                from tpubench_torch.workloads.meta_storm import (
                    run_meta_storm,
                )

                res = run_meta_storm(cfg, backend=backend,
                                     sweep=args.meta_sweep, device=device)
                print(format_lifecycle_scorecard(res.extra["lifecycle"]))
            elif cmd == "drill":
                res = _drill(cfg, args, device, backend)
            elif cmd == "replay":
                res = _replay(cfg, args, device)
            elif cmd == "fleet":
                res = _fleet(cfg, device)
            else:
                raise SystemExit(f"unknown command {cmd!r}")
        if cfg.obs.profile_dir:
            print(f"profile trace: {cfg.obs.profile_dir}", file=sys.stderr)
        if topo["process_count"] > 1:
            res.extra["topology"] = bringup.topology_stamp(topo)
        if launched_ranks():
            print(json.dumps({"local_rank": _rank_line(res, topo, device)}),
                  flush=True)
    return res


def _rank_line(res: RunResult, topo: dict, device) -> dict:
    """What a rank of a launched command says of itself: its global rank
    and host, its device and card (``bringup.card_key``), its group's
    backend, its own errors and kernel launches (the counts of this
    process; the command's result is global rank 0's alone)."""
    import torch.distributed as dist

    from tpubench_torch.dist.bringup import card_key, rank_device
    from tpubench_torch.kernels import landing

    rank = topo["rank"]
    return {
        "rank": rank, "ranks": topo["world_size"],
        "host": topo["process_index"], "hosts": topo["process_count"],
        "device": str(rank_device(device, rank)), "card": card_key(device),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "n_chips": res.n_chips, "errors": res.errors,
        "launches": {"land": landing.land.launches,
                     "checksum": landing.checksum.launches},
    }


def pod_command(cmd: str, cfg: BenchConfig, args) -> bool:
    """Whether ``cmd`` runs collectives over the pod: ``pod-ingest``,
    ``stream``, ``gather-bench``, train-ingest's pod path (also under
    ``tune`` and ``chaos``), ``chaos`` over pod-ingest and a restore onto
    the card. A single process runs these on a one-rank group; on a host
    of several cards ``main`` launches one rank a card."""
    chaos_wl = getattr(args, "chaos_workload", "") if cmd == "chaos" else ""
    return cmd in POD_COLLECTIVE_CMDS or (
        cfg.pipeline.pod and (
            cmd in ("train-ingest", "tune") or chaos_wl == "train-ingest"
        )) or chaos_wl == "pod-ingest" or (
        cmd == "ckpt-restore" and cfg.lifecycle.restore_device)


def local_ranks(cmd: str, cfg: BenchConfig, args, device) -> int:
    """How many rank processes ``main`` runs ``cmd`` as on this host: one
    a visible card for a pod command on CUDA, whatever the host count
    (``tpubench``'s one process a host meshes every local chip); else 1,
    in process (also in a rank the launcher started)."""
    if not pod_command(cmd, cfg, args) or launched_ranks():
        return 1
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return 1
    return max(1, torch.cuda.device_count())


def refuse_coop_ids(cfg: BenchConfig, ranks: int) -> None:
    """The cooperative cache's ring members are ranks: ``coop.hosts``
    defaults to the world and ``coop.host_id`` to the global rank. One
    explicit id cannot name the ``ranks`` ranks a launch starts, so a
    command line that launches several and sets either is refused."""
    co = cfg.coop
    if co.hosts or co.host_id >= 0:
        raise SystemExit(
            f"--coop-hosts/--coop-host-id set, but this host runs {ranks} "
            "ranks, one a card, and the ring takes each rank as a host: "
            "drop them (the ring is then every rank of the pod) or run one "
            "card a host (CUDA_VISIBLE_DEVICES)"
        )


def _drill(cfg: BenchConfig, args, device, backend=None) -> RunResult:
    """The ``drill`` command: the run (or ``--drill-sweep``) under the
    tracer, against the prepopulated in-process fake server when
    ``--protocol http|grpc`` names no endpoint; the serve, resize and
    drill scorecards printed."""
    from tpubench_torch.obs.tracing import tracer_session
    from tpubench_torch.workloads.chaos import hermetic_target
    from tpubench_torch.workloads.drill import (
        format_drill_scorecard,
        format_drill_sweep,
        run_drill,
        run_drill_sweep,
    )
    from tpubench_torch.workloads.serve import (
        format_membership_scorecard,
        format_serve_scorecard,
    )

    with tracer_session(cfg) as tracer, hermetic_target(cfg, populated=True):
        if args.drill_sweep:
            res = run_drill_sweep(cfg, tracer=tracer, device=device)
        else:
            res = run_drill(cfg, backend=backend, tracer=tracer,
                            device=device)
    print(format_serve_scorecard(res.extra["serve"]))
    if res.extra.get("membership"):
        print(format_membership_scorecard(res.extra["membership"]))
    print(format_drill_scorecard(res.extra["drill"]))
    if res.extra.get("drill_sweep"):
        print(format_drill_sweep(res.extra["drill_sweep"]))
    return res


def _fleet(cfg: BenchConfig, device) -> RunResult:
    """The ``fleet`` command: the service profile (fitted from
    ``--calibrate-from`` journals and written to ``--fleet-profile``, or
    loaded from it), the run or ``--fleet-sweep``, the serve, resize and
    fleet blocks printed."""
    from tpubench_torch.fleet.calibrate import (
        fit_profile,
        load_profile,
        save_profile,
    )
    from tpubench_torch.fleet.driver import (
        format_fleet_block,
        run_fleet,
        run_fleet_sweep,
    )
    from tpubench_torch.workloads.serve import (
        format_membership_scorecard,
        format_serve_scorecard,
    )

    fc = cfg.fleet
    if fc.calibrate_from:
        profile = fit_profile(fc.calibrate_from, defaults={
            "hit": fc.hit_service_ms, "peer": fc.peer_service_ms,
            "origin": fc.origin_service_ms, "cross_pod": fc.cross_pod_ms,
        })
        fc.profile = profile.to_dict()
        if fc.profile_path:
            print("fleet profile written: "
                  f"{save_profile(profile, fc.profile_path)}")
    elif fc.profile_path and not fc.profile:
        fc.profile = load_profile(fc.profile_path).to_dict()
    if fc.sweep:
        res = run_fleet_sweep(cfg, device=device)
    else:
        res = run_fleet(cfg, device=device)
    print(format_serve_scorecard(res.extra["serve"]))
    if res.extra.get("membership"):
        print(format_membership_scorecard(res.extra["membership"]))
    print(format_fleet_block(res.extra["fleet"]))
    return res


def _replay(cfg: BenchConfig, args, device) -> RunResult:
    """The ``replay`` command: load and validate the bundle, re-drive it,
    print the scorecards and the replay-vs-original block."""
    from tpubench_torch.obs.tracing import tracer_session
    from tpubench_torch.replay.bundle import (
        format_replay_block,
        load_bundle,
        validate_bundle,
    )
    from tpubench_torch.replay.driver import run_replay
    from tpubench_torch.workloads.serve import (
        format_membership_scorecard,
        format_serve_scorecard,
    )

    bundle = load_bundle(args.bundle)
    if bundle is None:
        raise SystemExit(
            f"replay: no usable bundle at {args.bundle!r} (missing, "
            "unreadable, or truncated — see warnings above)"
        )
    validate_bundle(bundle, args.bundle)
    with tracer_session(cfg) as tracer:
        res = run_replay(cfg, bundle, tracer=tracer, device=device)
    print(format_serve_scorecard(res.extra["serve"]))
    if res.extra.get("membership"):
        print(format_membership_scorecard(res.extra["membership"]))
    if res.extra.get("drill"):
        from tpubench_torch.workloads.drill import format_drill_scorecard

        print(format_drill_scorecard(res.extra["drill"]))
    print(format_replay_block(res.extra["replay"]))
    return res


def _chaos(cfg: BenchConfig, args, device) -> RunResult:
    """The ``chaos`` command: the timeline from the flags, the run under
    the tracer, the resilience scorecard (and the resize scorecard of an
    elastic serve pod) printed."""
    from tpubench_torch.config import FaultConfig
    from tpubench_torch.obs.tracing import tracer_session
    from tpubench_torch.workloads.chaos import format_scorecard, run_chaos

    timeline = chaos_timeline_from_args(args)
    if not args.chaos_timeline:
        # Shorthand mode: the --fault-* values parameterized the PHASE —
        # reset them on the base plan, or the "fault" would run every
        # second of the timeline and the baseline/recovery segments would
        # measure nothing.
        defaults = FaultConfig()
        for fname in timeline[0][2]:
            setattr(cfg.transport.fault, fname, getattr(defaults, fname))
    with tracer_session(cfg) as tracer:
        res = run_chaos(cfg, timeline=timeline,
                        chaos_workload=args.chaos_workload, tracer=tracer,
                        device=device)
    print(format_scorecard(res.extra["chaos"]))
    if res.extra.get("membership"):
        from tpubench_torch.workloads.serve import format_membership_scorecard

        print(format_membership_scorecard(res.extra["membership"]))
    return res


def run_fs(cmd: str, cfg: BenchConfig, direct: bool = True) -> RunResult:
    """One filesystem workload, bracketed by the configured mount hooks
    (read_operations.sh:18-21; nothing without hooks)."""
    from tpubench_torch.workloads import fsbench

    runner = {
        "read-fs": lambda: fsbench.run_read_fs(cfg, direct=direct),
        "write": lambda: fsbench.run_write(cfg, direct=direct),
        "list": lambda: fsbench.run_listing(cfg),
        "open": lambda: fsbench.run_open_file(cfg, direct=direct),
        "ssd": lambda: fsbench.run_ssd_compare(cfg, direct=direct),
    }[cmd]
    with fsbench.maybe_mounted(cfg):
        return runner()


def prepare(cfg: BenchConfig, layout: str = "flat") -> None:
    """The ``prepare`` command: the data files the filesystem workloads
    read, written through the mount when hooks are configured (into the
    unmounted directory they would be hidden from every mounted run)."""
    from tpubench_torch.workloads import fsbench

    w = cfg.workload
    with fsbench.maybe_mounted(cfg):
        if layout == "flat":
            fsbench.prepare_files(w.dir, max(w.threads, w.open_files),
                                  w.file_size_mb * MB)
        else:  # the ssd_test layout
            fsbench.prepare_ssd_files(w.dir, w.threads, w.file_size_mb * MB)
    print(f"prepared files under {w.dir}")


def sweep(cfg: BenchConfig, protocols: str, sizes: str = "",
          native: bool = False, device="cuda", tag: str = "") -> list[dict]:
    """The protocol A/B × size sweep (``execute_pb.sh`` +
    ``read_operations.sh:8-14``): one ``read`` per cell on ``device`` in
    the caller's staging mode, each result written (tagged
    ``extra.sweep``); returns the rows ``tpubench sweep`` prints.
    ``native`` adds the receive-path axis (the Python client and the
    engine's native receive) to the http and grpc cells; it needs the
    engine, so a failed build fails here, before any cell runs."""
    if native:
        from tpubench_torch.native.engine import get_engine

        get_engine()
    chosen = sizes.split(",") if sizes else list(SWEEP_SIZES)
    native_axis = [False, True] if native else [None]
    rows = []
    for proto in protocols.split(","):
        for sz in chosen:
            for nat in native_axis:
                if nat and proto not in ("http", "grpc"):
                    # No receive-path axis for fake/local, nor http2 (the
                    # h2 client IS the engine).
                    continue
                size, count = SWEEP_SIZES[sz]
                c = BenchConfig.from_dict(cfg.to_dict())
                c.transport.protocol = "http" if proto == "http2" else proto
                if proto == "http2":
                    c.transport.http2 = True
                c.workload.object_size = size
                c.workload.read_calls_per_worker = min(
                    count, c.workload.read_calls_per_worker
                )
                if nat is not None:
                    c.transport.native_receive = nat
                res = read(c, device=device)
                res.extra["sweep"] = {"protocol": proto, "size": sz}
                if nat is not None:
                    res.extra["sweep"]["native_receive"] = nat
                path = write_result(res, cfg.obs.results_dir, tag=tag)
                if cfg.obs.results_bucket:
                    upload_result(cfg, path)
                row = {
                    "protocol": proto,
                    "size": sz,
                    "gbps": res.gbps,
                    "p50_ms": res.summaries["read"].p50_ms,
                    "p99_ms": res.summaries["read"].p99_ms,
                    "result": path,
                }
                if nat is not None:
                    row["native_receive"] = nat
                rows.append(row)
    return rows


def finish(res: RunResult, cfg: BenchConfig,
           pod_collective: bool) -> Optional[str]:
    """Write the result (``tpubench``'s ``_finish``) and upload it to
    ``obs.results_bucket`` when one is set: a pod command's report is
    global rank 0's alone; a per-host command (``read``) writes one per
    host, tagged ``p<host>``. Returns the result file's path (``None`` on
    a rank that writes none)."""
    from tpubench_torch.dist.launch import member

    m = member(cfg.dist)
    topo = res.extra.get("topology")
    tag = ""
    if pod_collective and m.rank != 0:
        print(f"process {m.rank}/{m.world} done (report at process 0)")
        return None
    if not pod_collective and topo and topo.get("process_count", 1) > 1:
        tag = f"p{topo['process_index']}"
    print(res.format())
    if "staging" in res.extra:
        from tpubench_torch.staging.stats import format_staging_block

        print(format_staging_block(res.extra["staging"]))
    path = write_result(res, cfg.obs.results_dir, tag=tag)
    print(f"result: {path}")
    if cfg.obs.results_bucket:
        obj = upload_result(cfg, path)
        print(f"uploaded: {cfg.obs.results_bucket}/{obj}")
    return path


def report(args) -> int:
    """The ``report`` command (device-free, no config): results, or
    ``timeline``/``trace`` over flight journals; ``--fail-on`` gates give
    exit codes 0 (hold) / 1 (tripped) / 2 (metric in no document)."""
    from tpubench_torch.workloads.report_cmd import (
        run_report,
        run_timeline,
        run_trace,
    )

    if args.results[0] in ("timeline", "trace"):
        mode = args.results[0]
        if len(args.results) < 2:
            raise SystemExit(
                f"report {mode}: at least one flight-journal path required "
                "(read writes one under --flight-journal)"
            )
        if mode == "timeline":
            print(run_timeline(args.results[1:]))
        else:
            print(run_trace(
                args.results[1:], head_rate=args.head_sample,
                max_keep=args.slow_keep, show=args.show_traces,
            ))
        return 0
    print(run_report(args.results))
    if not args.fail_on:
        return 0
    # The gates run over a second load of the same documents: run_report
    # already failed loudly on anything unreadable.
    from tpubench_torch.replay.gate import run_fail_on

    docs, labels = [], []
    for p in args.results:
        with open(p) as f:
            doc = json.load(f)
        if isinstance(doc, list):  # a sweep cells file
            for i, cell in enumerate(doc):
                docs.append(cell)
                labels.append(f"{p}[{i}]")
        elif isinstance(doc.get("parsed"), dict):
            docs.append(doc["parsed"])  # a BENCH_rN.json wrapper
            labels.append(p)
        else:
            docs.append(doc)
            labels.append(p)
    rc, lines = run_fail_on(args.fail_on, docs, paths=labels)
    for line in lines:
        print(line)
    return rc


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "check":
        # Static analysis: device-free and config-free, like report.
        from tpubench_torch.analysis import run_cli_check

        return run_cli_check(
            json_out=args.json, paths=args.paths or None,
            allowlist_path=args.allowlist, with_drift=not args.no_drift,
        )
    if args.cmd == "top":
        # Device-free and config-free, like report.
        from tpubench_torch.obs.live import run_top

        return run_top(
            args.journals, interval_s=args.interval, once=args.once,
            window_s=args.window,
            color=False if args.no_color else None,
            iterations=args.frames,
        )
    if args.cmd == "report":
        return report(args)
    if args.cmd == "record":
        # Journal distillation: device-free and config-free, like report.
        from tpubench_torch.replay.bundle import record_bundle

        bundle = record_bundle(args.journals, args.out, name=args.name)
        print(
            f"bundle written: {args.out} ({bundle['name']}: "
            f"{len(bundle['arrivals'])} arrivals, "
            f"{len(bundle['objects'])} objects, fingerprint "
            f"{bundle['config_fingerprint']})"
        )
        return 0
    if args.cmd == "multichip-sweep":
        # No config and no bring-up here: each child brings up its own.
        from tpubench_torch.dist.sweep import main as sweep_main

        fwd = []
        for flag in ("sizes", "shard_mb", "reps", "out", "results_dir",
                     "device"):
            v = getattr(args, flag)
            if v is not None:
                fwd += [f"--{flag.replace('_', '-')}", str(v)]
        return sweep_main(fwd)
    cfg = build_config(args)
    if args.save_config:
        # Before any device is resolved or any CUDA call is made, as
        # tpubench's (its save-config path stays jax-free): it runs on a
        # machine without a card.
        with open(args.save_config, "w") as f:
            f.write(cfg.to_json())
        print(f"config written: {args.save_config}")
        return 0
    if args.cmd == "info":
        from tpubench_torch.device import capability_report

        print(cfg.to_json())
        print(f"devices: {json.dumps(capability_report())}", file=sys.stderr)
        return 0
    if args.cmd == "preflight":
        # Device-free: a misconfigured machine fails this in seconds,
        # before any bring-up.
        from tpubench_torch.workloads.preflight import (
            format_preflight,
            run_preflight,
        )

        result = run_preflight(cfg)
        print(format_preflight(result))
        print(json.dumps(result))
        return 0 if result["ok"] else 1
    if args.cmd == "prepare":
        prepare(cfg, args.layout)
        return 0
    if args.cmd == "sweep":
        from tpubench_torch.dist import bringup
        from tpubench_torch.obs.profiling import maybe_profile

        # A per-host measurement: with several processes each writes its
        # own rows, tagged with its index.
        with bringup.session(cfg.dist, args.device) as topo:
            with maybe_profile(cfg.obs.profile_dir, args.device):
                rows = sweep(
                    cfg, args.sweep_protocols, args.sweep_sizes,
                    native=args.sweep_native, device=args.device,
                    tag=(f"p{topo['process_index']}"
                         if topo["process_count"] > 1 else ""),
                )
        if cfg.obs.profile_dir:
            print(f"profile trace: {cfg.obs.profile_dir}", file=sys.stderr)
        print(json.dumps(rows, indent=2))
        return 0
    ranks = local_ranks(args.cmd, cfg, args, args.device)
    if ranks > 1:
        from tpubench_torch.dist import launch

        refuse_coop_ids(cfg, ranks)
        return launch.launch(sys.argv[1:] if argv is None else list(argv),
                             ranks, results_dir=cfg.obs.results_dir,
                             pod=cfg.dist)
    res = execute(args.cmd, cfg, device=args.device, args=args)
    finish(res, cfg, pod_collective=(args.cmd in POD_COLLECTIVE_CMDS
                                     or launched_ranks() > 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
