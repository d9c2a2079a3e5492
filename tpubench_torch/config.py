"""Configuration for the PyTorch port — :mod:`tpubench.config`, copied
section for section and field for field at the same defaults.

One config JSON drives both packages: a file written by ``tpubench
--save-config`` loads here into typed sections, and
:meth:`BenchConfig.to_dict` writes it back unchanged. A section no
dataclass here knows is kept as the raw dict it was loaded as
(``BenchConfig.raw``), so it round-trips instead of being dropped.

All sizes are bytes unless the field name says otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

KB = 1024
MB = 1024 * 1024
GB = 1024 * MB


def parse_sleep_scale(purpose: str = "refill sleeps") -> float:
    """Validated ``TPUBENCH_BENCH_SLEEP_SCALE``: one definition shared by
    the chaos workload (timeline durations) and the serve plane (arrival
    gaps), so the two surfaces can never drift on what the env var
    accepts. A clear one-line rejection for non-numeric/negative/NaN values instead
    of a ValueError traceback; empty/unset = 1.0."""
    raw = os.environ.get("TPUBENCH_BENCH_SLEEP_SCALE", "")
    if not raw:
        return 1.0
    try:
        v = float(raw)
    except ValueError:
        raise SystemExit(
            f"TPUBENCH_BENCH_SLEEP_SCALE={raw!r}: expected a non-negative "
            f"number (0 disables {purpose}; 1 keeps them full-length)"
        ) from None
    if v < 0 or v != v:  # reject negatives and NaN alike
        raise SystemExit(
            f"TPUBENCH_BENCH_SLEEP_SCALE={raw!r}: must be >= 0 "
            f"(0 disables {purpose}; got a negative/NaN value)"
        )
    return v


@dataclass
class RetryConfig:
    """Request-retry policy (the reference's gax policy, ``main.go:40-42``)."""

    initial_backoff_s: float = 1.0
    max_backoff_s: float = 30.0
    multiplier: float = 2.0
    policy: str = "always"  # "always" | "idempotent" | "never"
    max_attempts: int = 0  # 0 = unbounded
    deadline_s: float = 0.0
    jitter: bool = True


@dataclass
class FaultConfig:
    """Fault injection for the fake backend (field-compatible with
    :class:`tpubench_torch.storage.fake.FaultPlan`): the open/read faults
    and the upload faults of the fake store and the fake servers."""

    error_rate: float = 0.0  # P(read-open raises transient 503)
    read_error_rate: float = 0.0  # P(granule read raises mid-stream)
    latency_s: float = 0.0  # added first-byte latency per open
    per_read_latency_s: float = 0.0  # added latency per granule read
    seed: int = 0
    stall_after_bytes: int = 0
    stall_s: float = 0.0
    stall_rate: float = 1.0
    drip_bps: float = 0.0
    truncate_after_bytes: int = 0
    reset_after_bytes: int = 0
    # --- upload-side faults (the ckpt-save chaos surface) ---
    # P(a resumable-upload part append fails with a transient 503).
    upload_error_rate: float = 0.0
    # One mid-upload pause per session (upload_stall_rate = P(a given
    # session stalls at all) — the upload twin of the read straggler).
    upload_stall_s: float = 0.0
    upload_stall_rate: float = 1.0
    # Truncate-then-reset: once a session has committed this many bytes,
    # the in-flight part commits only a PREFIX and the connection dies —
    # the mid-part shape resumable uploads exist to survive (one-shot
    # per session, so a resumed upload makes progress past it). 0 = off.
    upload_reset_after_bytes: int = 0
    phases: list = field(default_factory=list)

    @property
    def active(self) -> bool:
        return bool(
            self.error_rate
            or self.read_error_rate
            or self.latency_s
            or self.per_read_latency_s
            or self.stall_s
            or self.drip_bps
            or self.truncate_after_bytes
            or self.reset_after_bytes
            or self.upload_error_rate
            or self.upload_stall_s
            or self.upload_reset_after_bytes
            or self.phases
        )


# Fields a fault phase dict may set (everything but the schedule itself:
# nested phases would have no defined epoch).
_FAULT_PHASE_FIELDS = (
    "error_rate", "read_error_rate", "latency_s", "per_read_latency_s",
    "seed", "stall_after_bytes", "stall_s", "stall_rate", "drip_bps",
    "truncate_after_bytes", "reset_after_bytes",
    "upload_error_rate", "upload_stall_s", "upload_stall_rate",
    "upload_reset_after_bytes",
)


def validate_fault_config(fc: "FaultConfig", where: str = "fault") -> None:
    """Reject malformed fault configs with a clear one-line ``SystemExit``
    (the ``parse_sleep_scale`` style): probabilities
    outside [0, 1], negative latencies/durations/byte counts, and
    malformed or negative phase windows all fail at config-load time, not
    an hour into a run."""

    def _num(label: str, name: str, v):
        try:
            return float(v)
        except (TypeError, ValueError):
            raise SystemExit(
                f"{label}.{name}={v!r}: must be a number"
            ) from None

    def _check_fields(d: dict, label: str) -> None:
        for name in ("error_rate", "read_error_rate", "stall_rate",
                     "upload_error_rate", "upload_stall_rate"):
            v = d.get(name)
            if v is not None and not (0.0 <= _num(label, name, v) <= 1.0):
                raise SystemExit(
                    f"{label}.{name}={v!r}: must be a probability in [0, 1]"
                )
        for name in (
            "latency_s", "per_read_latency_s", "stall_s", "drip_bps",
            "stall_after_bytes", "truncate_after_bytes", "reset_after_bytes",
            "upload_stall_s", "upload_reset_after_bytes",
        ):
            v = d.get(name)
            if v is not None and _num(label, name, v) < 0:
                raise SystemExit(f"{label}.{name}={v!r}: must be >= 0")

    base = {f: getattr(fc, f) for f in _FAULT_PHASE_FIELDS}
    _check_fields(base, where)
    for i, ph in enumerate(fc.phases or ()):
        label = f"{where}.phases[{i}]"
        if not isinstance(ph, (list, tuple)) or len(ph) != 3:
            raise SystemExit(
                f"{label}: expected [t0, t1, {{fault fields}}], got {ph!r}"
            )
        t0, t1, plan = ph
        try:
            t0, t1 = float(t0), float(t1)
        except (TypeError, ValueError):
            raise SystemExit(
                f"{label}: phase window [{ph[0]!r}, {ph[1]!r}] must be numeric"
            ) from None
        if t0 < 0 or t1 < t0:
            raise SystemExit(
                f"{label}: phase window [{t0}, {t1}] must satisfy "
                "0 <= t0 <= t1"
            )
        if not isinstance(plan, dict):
            raise SystemExit(
                f"{label}: third element must be a fault-field dict, "
                f"got {plan!r}"
            )
        unknown = sorted(set(plan) - set(_FAULT_PHASE_FIELDS))
        if unknown:
            raise SystemExit(
                f"{label}: unknown fault field(s) {unknown}; "
                f"valid: {sorted(_FAULT_PHASE_FIELDS)}"
            )
        _check_fields(plan, label)


@dataclass
class TailConfig:
    """Tail tolerance (hedged reads, stall watchdog, circuit breaker)."""

    hedge: bool = False
    hedge_delay_s: float = 0.05
    hedge_from_p99: bool = False
    hedge_p99_scale: float = 1.5
    watchdog: bool = False
    stall_window_s: float = 1.0
    stall_floor_bps: float = 1024.0
    breaker: bool = False
    breaker_failures: int = 5
    breaker_reset_s: float = 5.0
    breaker_probes: int = 1

    @property
    def active(self) -> bool:
        return self.hedge or self.watchdog or self.breaker


@dataclass
class TransportConfig:
    """L1 client construction knobs (reference ``main.go:30-42,62-117``)."""

    protocol: str = "http"  # "http" | "grpc" | "local" | "fake"
    max_conns_per_host: int = 100
    max_idle_conns_per_host: int = 100
    http2: bool = False
    native_receive: bool = False
    tls_ca_file: str = ""
    tls_insecure_skip_verify: bool = False
    user_agent: str = "tpubench"
    grpc_conn_pool_size: int = 1
    directpath: bool = True
    key_file: str = ""
    endpoint: str = ""
    retry: RetryConfig = field(default_factory=RetryConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)
    tail: TailConfig = field(default_factory=TailConfig)


@dataclass
class WorkloadConfig:
    """Driver knobs: the union of every benchmark binary's flag surface."""

    workers: int = 48  # --worker, main.go:36
    read_calls_per_worker: int = 1000  # --read-call-per-worker (ref: 1e6)
    bucket: str = ""
    project: str = ""
    object_name_prefix: str = "tpubench/file_"  # main.go:50-53
    granule_bytes: int = 2 * MB  # main.go:123-125
    dir: str = ""
    threads: int = 4
    read_count: int = 1
    block_size_kb: int = 1024
    file_size_mb: int = 64
    write_count: int = 1
    fsync_every_block: bool = True
    open_files: int = 64
    hold_seconds: float = 0.0
    read_type: str = "seq"
    seed: int = 0
    mount_cmd: str = ""
    unmount_cmd: str = ""
    list_rounds: int = 5
    object_size: int = 100 * MB  # main.go:52
    abort_on_error: bool = True  # errgroup semantics, main.go:200-219
    fetch_executor: str = "python"  # "python" | "native*"


@dataclass
class StagingConfig:
    """Storage→device staging (no reference analog)."""

    mode: str = "device_put"  # "none" | "device_put" | "pallas"
    double_buffer: bool = True
    depth: int = 3  # in-flight window when double_buffer
    slot_bytes: int = 16 * MB  # granule-aggregation target
    host_budget_mb: int = 1024  # all workers' slots together
    # Page-locked slots on CUDA (the counterpart of the native
    # posix_memalign slots); plain tensors on the CPU.
    native_slots: bool = True
    zero_copy: bool = True  # fetch directly into the slot
    drain: str = "inline"  # deprecated, kept so old JSONs load
    lane: int = 128
    validate_checksum: bool = False


@dataclass
class DistConfig:
    """Multi-process fan-out (``tpubench/config.py:1381-1393``): one
    process per GPU, brought up by :func:`tpubench_torch.dist.bringup.
    initialize` (CLI ``--num-processes``/``--process-id``/
    ``--coordinator``, or ``TPUBENCH_NUM_PROCESSES``/``_PROCESS_ID``/
    ``_COORDINATOR``); 1 = single-process."""

    num_processes: int = 1
    process_id: int = 0
    coordinator_address: str = ""  # host:port of process 0
    mesh_axis: str = "pod"  # name of the 1-D pod axis


@dataclass
class ObservabilityConfig:
    """Metrics/tracing knobs (``metrics_exporter.go``, ``trace_exporter.go``)."""

    enable_tracing: bool = False
    trace_sample_rate: float = 1.0
    trace_exporter: str = ""
    metrics_interval_s: float = 30.0
    metric_prefix: str = "custom.googleapis.com/tpubench/"
    export: str = "json"  # "none" | "json" | "cloud"
    export_dry_run: bool = True
    results_bucket: str = ""
    results_dir: str = "results"
    profile_dir: str = ""
    profile_steps: str = ""
    flight_records: int = 1024
    flight_journal: str = ""
    journal_max_bytes: int = 0


@dataclass
class TelemetryConfig:
    """Live telemetry plane (:mod:`tpubench_torch.obs.telemetry`): an
    in-process pull-based metrics registry — counters, gauges, and
    fixed-bucket latency histograms on the reference view's bucket
    bounds — fed from the flight channel, the run's latency recorders and
    the native ``tb_stats_*`` counters while the run is in flight.

    Exposed as a stdlib-only loopback HTTP endpoint (Prometheus text at
    ``/metrics``, JSON at ``/snapshot``), as periodic OTLP-shaped JSON
    export, and as the journal stream. All off by default."""

    # Master switch; implied by port >= 0 or otlp.
    enabled: bool = False
    # -1 = no endpoint, 0 = ephemeral (the OS picks), >0 = fixed.
    port: int = -1
    # Registry tick (seconds): gauge refresh, recorder/native-counter
    # sampling, and the in-run journal stream cadence.
    interval_s: float = 1.0
    # OTLP-shaped JSON metric export: captured dry-run without an
    # endpoint, POSTed with stdlib urllib with one.
    otlp: bool = False
    otlp_interval_s: float = 30.0
    otlp_endpoint: str = ""

    @property
    def active(self) -> bool:
        return self.enabled or self.port >= 0 or self.otlp


def validate_telemetry_config(tc: TelemetryConfig,
                              where: str = "telemetry") -> None:
    """Parse-time sanity for the telemetry knobs (one-line SystemExit)."""
    if not (-1 <= tc.port <= 65535):
        raise SystemExit(
            f"{where}.port={tc.port!r}: must be -1 (off), 0 (ephemeral) "
            "or a valid TCP port"
        )
    if not (tc.interval_s > 0):  # also rejects NaN
        raise SystemExit(
            f"{where}.interval_s={tc.interval_s!r}: must be > 0"
        )
    if not (tc.otlp_interval_s > 0):
        raise SystemExit(
            f"{where}.otlp_interval_s={tc.otlp_interval_s!r}: must be > 0"
        )
    if tc.otlp_endpoint and not (
        tc.otlp_endpoint.startswith("http://")
        or tc.otlp_endpoint.startswith("https://")
    ):
        raise SystemExit(
            f"{where}.otlp_endpoint={tc.otlp_endpoint!r}: must be an "
            "http(s) URL (the OTLP/HTTP JSON receiver)"
        )


@dataclass
class PipelineConfig:
    """Ingest pipeline (``tpubench_torch/pipeline``): host chunk cache +
    readahead prefetcher + the step-paced ``train-ingest`` workload
    (``tpubench/config.py:272``, field for field).

    The reference (and every other tpubench workload) issues cold,
    demand-driven reads — no overlap between fetch and consumption. This
    subsystem is the input pipeline that hides storage latency behind
    compute and *measures how well it does so*: per-step data-stall time,
    cache hit ratio, prefetch efficiency (used vs wasted bytes).
    """

    # Host-RAM chunk cache budget (bytes). Entries are keyed by
    # (bucket, object, generation, range); byte-budgeted LRU eviction with
    # single-flight dedup of concurrent misses. 0 disables caching (every
    # chunk access is a backend read — the cold baseline).
    cache_bytes: int = 256 * MB
    # Readahead depth in CHUNKS: how far ahead of the consumer the
    # prefetcher walks the access plan. 0 disables prefetch entirely
    # (the cold A/B arm).
    readahead: int = 8
    # Prefetch byte budget: in-flight + cached-but-unconsumed prefetched
    # bytes never exceed this (0 = bounded by readahead depth alone).
    readahead_bytes: int = 0
    # Worker threads issuing prefetch reads through the backend stack
    # (hedging/watchdog/breaker/retry compose underneath, like any read).
    prefetch_workers: int = 2
    # --- train-ingest step loop ---
    steps: int = 8  # training steps per epoch
    epochs: int = 1  # plan repeats; epoch 2+ re-reads (cache hit path)
    batch_shards: int = 4  # chunks consumed per step
    # Chunk size (bytes); 0 = workload.granule_bytes.
    chunk_bytes: int = 0
    # Synthetic per-step compute time (ms): the window prefetch has to
    # hide the next batch's fetch latency behind.
    step_compute_ms: float = 0.0
    # A step whose data-wait exceeds this is a *stalled step* (the
    # stalled-step fraction the scorecard reports).
    stall_threshold_ms: float = 1.0
    # Pod path: stage each step's batch as byte-range shards across the
    # pod's ranks and all-gather them (dist.shard / dist.reassemble),
    # instead of the per-host slot-ring path.
    pod: bool = False
    # --- zero-copy slab datapath (tpubench_torch/mem) ---
    # Lease chunks from a refcounted page-locked slab pool: the transport
    # readinto()s wire bytes straight into a leased slab, the cache
    # stores the lease, and the consumer stages the slab view in place —
    # one host-RAM write per chunk byte. False = the legacy bytes path
    # (the copies-per-byte A/B baseline arm).
    slab_pool: bool = True
    # Slab size in bytes; 0 = the effective chunk size (chunk_bytes or
    # workload.granule_bytes). Must be >= one chunk.
    slab_bytes: int = 0
    # Pool capacity in slabs; 0 = auto-sized so the cache budget plus the
    # readahead window plus one step's batch fit without overflow.
    pool_slabs: int = 0


def validate_pipeline_config(pc: "PipelineConfig",
                             where: str = "pipeline",
                             staging: "StagingConfig" = None) -> None:
    """Parse-time sanity for the pipeline knobs (one-line SystemExit).
    With ``staging`` supplied, also
    cross-checks the overlapped staging window against the slab pool."""
    for name, lo in (
        ("cache_bytes", 0), ("readahead", 0), ("readahead_bytes", 0),
        ("prefetch_workers", 1), ("steps", 1), ("epochs", 1),
        ("batch_shards", 1), ("chunk_bytes", 0),
        ("slab_bytes", 0), ("pool_slabs", 0),
    ):
        v = getattr(pc, name)
        if v < lo:
            raise SystemExit(f"{where}.{name}={v!r}: must be >= {lo}")
    for name in ("step_compute_ms", "stall_threshold_ms"):
        v = getattr(pc, name)
        if not (v >= 0):  # also rejects NaN
            raise SystemExit(f"{where}.{name}={v!r}: must be >= 0")
    if (
        staging is not None and staging.mode == "device_put"
        and staging.double_buffer and not staging.validate_checksum
        and not pc.pod and pc.slab_pool
        and pc.pool_slabs > 0 and pc.slab_bytes > 0
    ):
        # Scope: only the device_put overlapped window holds leases past
        # submit — pallas stages synchronously, validation forces the
        # serial ring, and the pod path never builds a stager at all.
        # The overlapped executor holds one chunk lease per in-flight
        # transfer until the bytes LAND (not until submit returns), so an
        # explicitly-sized pool must have room for the in-flight window
        # on top of the cache's working set. Without this check the
        # misconfiguration only surfaces as counted overflow leases
        # mid-run — an hour in, as pool-pressure noise, not as the
        # config error it is.
        depth = max(1, staging.depth)
        inflight = depth * pc.slab_bytes
        budget = pc.pool_slabs * pc.slab_bytes
        if inflight > budget:
            raise SystemExit(
                f"staging.depth={depth} × {where}.slab_bytes="
                f"{pc.slab_bytes} = {inflight} B of in-flight leases "
                f"exceeds the slab-pool budget ({where}.pool_slabs="
                f"{pc.pool_slabs} × {pc.slab_bytes} = {budget} B): every "
                "overlapped transfer would overflow-lease — raise "
                "--pool-slabs or lower --staging-depth"
            )
    # The cross-field readahead/cache/chunk checks live in
    # run_train_ingest, where the effective chunk size is known AND only
    # the workload that actually constructs the pipeline pays them —
    # `tpubench read --cache-bytes 0` must not fail on the pipeline's
    # default readahead.


# Knobs the tune controller may actuate (``tpubench/config.py:1077``; the
# controller's ACTUATED registry maps each to its config field and CLI
# flag). The read path actuates ``workers``, ``hedge_delay_s`` and
# ``staging_depth``; ``train-ingest`` the readahead and prefetch knobs,
# and the cooperative cache ``peer_budget_bytes`` and ``coop``.
TUNE_KNOBS = (
    "workers",
    "readahead",
    "readahead_bytes",
    "prefetch_workers",
    "hedge_delay_s",
    "staging_depth",
    "peer_budget_bytes",
    "coop",
)


@dataclass
class TuneConfig:
    """Adaptive ingest autotuner (:mod:`tpubench_torch.tune`): an online
    controller that moves live knobs (worker fan-out, the hedge delay, the
    staging window's depth) during a run, from windowed goodput and p99
    latency sampled off the run's own recorders.

    Objective: maximize goodput subject to ``p99 <= p99_guard x`` the
    warmup baseline. One knob is probed per window (multiplying knobs
    double/halve); a probe that gains ``epsilon`` inside the guardrail is
    accepted, anything else reverts. A knob that reverts
    ``freeze_after_reverts`` times without an accept freezes for
    ``cooldown_windows``; when every knob is frozen the session has
    converged and the operating point holds.

    Off by default: ``enabled`` turns the controller on inside ``read``;
    ``tune`` drives offline sweeps and online sessions."""

    enabled: bool = False
    window_s: float = 0.5  # decision window (seconds)
    warmup_windows: int = 2  # baseline windows before the first probe
    p99_guard: float = 2.0  # probe p99 > baseline x this reverts
    epsilon: float = 0.05  # minimum relative goodput gain to accept
    freeze_after_reverts: int = 2
    cooldown_windows: int = 1_000_000  # effectively "until run end"
    # Online read sessions are duration-bounded: a parked elastic worker
    # could otherwise hold the run open forever.
    duration_s: float = 8.0
    knobs: list = field(default_factory=lambda: list(TUNE_KNOBS))
    seed: int = 0  # probe-direction rng


def validate_tune_config(tc: TuneConfig, where: str = "tune") -> None:
    """Parse-time sanity for the tune knobs (one-line SystemExit)."""
    if tc.window_s <= 0 or tc.window_s != tc.window_s:
        raise SystemExit(f"{where}.window_s={tc.window_s!r}: must be > 0")
    if tc.warmup_windows < 1:
        raise SystemExit(
            f"{where}.warmup_windows={tc.warmup_windows!r}: must be >= 1"
        )
    if not (tc.p99_guard >= 1.0):  # also rejects NaN
        raise SystemExit(
            f"{where}.p99_guard={tc.p99_guard!r}: must be >= 1.0 "
            "(1.0 = no tail inflation tolerated)"
        )
    if not (tc.epsilon >= 0.0):
        raise SystemExit(f"{where}.epsilon={tc.epsilon!r}: must be >= 0")
    if tc.freeze_after_reverts < 1:
        raise SystemExit(
            f"{where}.freeze_after_reverts={tc.freeze_after_reverts!r}: "
            "must be >= 1"
        )
    if tc.cooldown_windows < 1:
        raise SystemExit(
            f"{where}.cooldown_windows={tc.cooldown_windows!r}: must be >= 1"
        )
    if not (tc.duration_s > 0.0):
        raise SystemExit(
            f"{where}.duration_s={tc.duration_s!r}: must be > 0 "
            "(the online read session's wall-clock bound)"
        )
    unknown = sorted(set(tc.knobs) - set(TUNE_KNOBS))
    if unknown:
        raise SystemExit(
            f"{where}.knobs: unknown knob(s) {unknown}; "
            f"valid: {sorted(TUNE_KNOBS)}"
        )


@dataclass
class CoopConfig:
    """Pod-scale cooperative chunk cache (:mod:`tpubench_torch.pipeline.coop`):
    consistent-hash chunk ownership across the pod's hosts, peer-first
    miss resolution over a peer channel, pod-wide single-flight (only
    the owner ever fetches a chunk from origin), and straggler-aware
    owner demotion fed by the flight recorder's per-host tables.

    Off by default — the per-host cache is the baseline arm of the
    coop-vs-per-host A/B the scorecard reports (origin GCS bytes per
    POD, not per host)."""

    enabled: bool = False
    # Pod membership: number of hosts on the ring (0 = dist.num_processes)
    # and this host's id (-1 = dist.process_id). Explicit values exist
    # for embedding harnesses (the hermetic multi-"host" sim).
    hosts: int = 0
    host_id: int = -1
    # Virtual nodes per host: more = smoother key balance, identical
    # rehash-minimality (~1/N of keys move on a join/leave either way).
    vnodes: int = 64
    # Serve-side byte budget: bytes concurrently being served to peers
    # never exceed this — past it the owner sheds (peers fall back to
    # origin) instead of queueing unboundedly. 0 = unbounded. Live: the
    # `peer_budget_bytes` tune knob actuates it.
    peer_budget_bytes: int = 0
    # Peer transport: "loopback" = in-process request/reply (hermetic
    # tests, single-host dev); "ici" = lockstep all-gather over the pod's
    # process group (dist/peer.py: NCCL on CUDA, gloo on the CPU —
    # plan-synchronized pod workloads only); "auto" = loopback. The name
    # is the reference's, so saved configs load in both packages.
    channel: str = "auto"
    # Straggler demotion: owners whose per-host flight table places them
    # in the slowest decile (tail_share >= demote_share) leave the ring
    # until a later table clears them; the recorder scan runs at most
    # once per demote_interval_s.
    demote: bool = True
    demote_share: float = 0.5
    demote_interval_s: float = 2.0


def validate_coop_config(cc: "CoopConfig", where: str = "coop") -> None:
    """Parse-time sanity for the coop knobs (one-line SystemExit at
    config load — the validate_fault_config style)."""
    if cc.hosts < 0:
        raise SystemExit(f"{where}.hosts={cc.hosts!r}: must be >= 0 "
                         "(0 = dist.num_processes)")
    if cc.host_id < -1:
        raise SystemExit(f"{where}.host_id={cc.host_id!r}: must be >= -1 "
                         "(-1 = dist.process_id)")
    if cc.hosts and cc.host_id >= cc.hosts:
        raise SystemExit(
            f"{where}.host_id={cc.host_id} is outside the pod "
            f"({where}.hosts={cc.hosts})"
        )
    if cc.vnodes < 1:
        raise SystemExit(f"{where}.vnodes={cc.vnodes!r}: must be >= 1")
    if cc.peer_budget_bytes < 0:
        raise SystemExit(
            f"{where}.peer_budget_bytes={cc.peer_budget_bytes!r}: must be "
            ">= 0 (0 = unbounded)"
        )
    if cc.channel not in ("auto", "loopback", "ici"):
        raise SystemExit(
            f"{where}.channel={cc.channel!r}: must be auto|loopback|ici"
        )
    if not (0.0 < cc.demote_share <= 1.0):  # also rejects NaN
        raise SystemExit(
            f"{where}.demote_share={cc.demote_share!r}: must be in (0, 1]"
        )
    if not (cc.demote_interval_s > 0):
        raise SystemExit(
            f"{where}.demote_interval_s={cc.demote_interval_s!r}: "
            "must be > 0"
        )


@dataclass
class ServeConfig:
    """Open-loop multi-tenant traffic plane (``serve``,
    tpubench_torch/serve/ + workloads/serve.py).

    Every other workload is closed-loop — a fixed pool pulls as fast as
    it can. ``serve`` drives OPEN-LOOP arrivals (requests land on their
    own schedule whether or not the system keeps up) from many synthetic
    tenants in weighted priority classes, through the full
    open_backend → chunk cache → prefetcher → staging stack, with QoS
    enforced at the choke points: priority admission with a live cap
    (the runnable-queue admission hook), weighted per-class cache/
    prefetch byte budgets, and deadline-aware shedding under overload.
    ``serve-sweep`` steps offered load and emits the latency-vs-load
    curve to the saturation knee (the Pulsar-study methodology)."""

    # Run length (seconds of VIRTUAL schedule; wall time scales with
    # TPUBENCH_BENCH_SLEEP_SCALE via the shared parse_sleep_scale).
    duration_s: float = 4.0
    # Aggregate offered load, requests/second across all tenants.
    rate_rps: float = 200.0
    # Arrival process: poisson | bursty (two-state MMPP) | diurnal
    # (sinusoidal-rate thinned Poisson) | trace (replayed timestamps).
    arrival: str = "poisson"
    burst_factor: float = 4.0  # bursty: burst-to-quiet rate ratio
    burst_fraction: float = 0.25  # bursty: fraction of each cycle bursting
    burst_cycle_s: float = 1.0  # bursty: quiet+burst cycle length
    diurnal_period_s: float = 4.0  # diurnal: one "day" in seconds
    trace_path: str = ""  # trace: JSON list of arrival seconds
    # Tenant population: expanded over `classes` by share; each tenant
    # draws its objects from a Zipf(alpha) popularity law over the
    # shared object set (workloads/arrivals.zipf_plan).
    tenants: int = 100
    alpha: float = 1.2
    # Priority classes: list of {"name", "share" (of tenants/traffic),
    # "weight" (cache/prefetch budget split), "deadline_ms" (per-request
    # SLO), "priority" (lower = served first)} dicts. Validated by
    # validate_serve_config; malformed specs are a one-line SystemExit.
    classes: list = field(default_factory=lambda: [
        {"name": "gold", "share": 0.1, "weight": 4.0,
         "deadline_ms": 80.0, "priority": 0},
        {"name": "silver", "share": 0.3, "weight": 2.0,
         "deadline_ms": 250.0, "priority": 1},
        {"name": "best_effort", "share": 0.6, "weight": 1.0,
         "deadline_ms": 1500.0, "priority": 2},
    ])
    # Request size: one chunk per request (0 = workload.granule_bytes).
    chunk_bytes: int = 0
    # Service worker threads (the concurrency ceiling admission caps).
    workers: int = 8
    # QoS master switch: False = FIFO queue, no shedding, no weighted
    # budgets — the baseline arm of the QoS A/B.
    qos: bool = True
    # Admission cap: requests in service at once (0 = workers). Live:
    # the tune controller actuates it through the "workers" knob.
    admission_cap: int = 0
    # Queued-request bound before overload shedding (QoS mode; 0 = a
    # default of 8x workers). The baseline arm queues unboundedly.
    queue_limit: int = 0
    # Readahead over the arrival schedule (serve knows its replayed
    # trace ahead of time the way train-ingest knows its plan): depth in
    # chunks; 0 = demand-only.
    readahead: int = 0
    # serve-sweep: offered-load multipliers of rate_rps, stepped in
    # order; per-point run length (0 = duration_s).
    sweep_points: list = field(default_factory=lambda: [
        0.25, 0.5, 1.0, 2.0, 4.0,
    ])
    sweep_duration_s: float = 0.0
    seed: int = 0
    # Elastic pod membership (tpubench_torch/dist/membership.py): hosts > 1
    # fans the serve plane across an N-host hermetic threaded pod whose
    # misses route through coop-cache consistent-hash ownership, and
    # membership_timeline changes the pod's shape UNDER load —
    # ``[t0, t1, {action: host}]`` entries in virtual schedule seconds
    # (the arrival clock), actions kill_host (die, no handoff),
    # leave_host (cooperative warm handoff), pause_host (unresponsive
    # during [t0, t1], resumes at t1) and rejoin_host (clean re-entry).
    # The resize scorecard brackets each event with resize_window_s of
    # virtual time (SLO-during-resize vs steady state).
    hosts: int = 1
    membership_timeline: list = field(default_factory=list)
    resize_window_s: float = 1.0


def validate_serve_config(sc: "ServeConfig", where: str = "serve") -> None:
    """Parse-time sanity for the serve plane (one-line SystemExit at
    config load — the validate_fault_config style): malformed tenant
    class specs and arrival parameters fail before a single arrival."""
    if not (sc.duration_s > 0):  # also rejects NaN
        raise SystemExit(f"{where}.duration_s={sc.duration_s!r}: must be > 0")
    if not (sc.rate_rps > 0):
        raise SystemExit(f"{where}.rate_rps={sc.rate_rps!r}: must be > 0")
    if sc.arrival not in ("poisson", "bursty", "diurnal", "trace"):
        raise SystemExit(
            f"{where}.arrival={sc.arrival!r}: must be "
            "poisson|bursty|diurnal|trace"
        )
    if sc.arrival == "trace" and not sc.trace_path:
        raise SystemExit(
            f"{where}.arrival=trace requires {where}.trace_path "
            "(a JSON list of arrival seconds)"
        )
    if not (sc.burst_factor >= 1.0):
        raise SystemExit(
            f"{where}.burst_factor={sc.burst_factor!r}: must be >= 1"
        )
    if not (0.0 < sc.burst_fraction < 1.0):
        raise SystemExit(
            f"{where}.burst_fraction={sc.burst_fraction!r}: must be in (0, 1)"
        )
    for name in ("burst_cycle_s", "diurnal_period_s", "alpha"):
        v = getattr(sc, name)
        if not (v > 0):
            raise SystemExit(f"{where}.{name}={v!r}: must be > 0")
    for name, lo in (("tenants", 1), ("workers", 1), ("chunk_bytes", 0),
                     ("admission_cap", 0), ("queue_limit", 0),
                     ("readahead", 0)):
        v = getattr(sc, name)
        if v < lo:
            raise SystemExit(f"{where}.{name}={v!r}: must be >= {lo}")
    if not (sc.sweep_duration_s >= 0):
        raise SystemExit(
            f"{where}.sweep_duration_s={sc.sweep_duration_s!r}: must be >= 0"
        )
    if not sc.sweep_points or not all(
        isinstance(p, (int, float)) and p > 0 for p in sc.sweep_points
    ):
        raise SystemExit(
            f"{where}.sweep_points={sc.sweep_points!r}: must be a non-empty "
            "list of positive load multipliers"
        )
    if not sc.classes or not isinstance(sc.classes, list):
        raise SystemExit(
            f"{where}.classes: must be a non-empty list of class dicts"
        )
    allowed = {"name", "share", "weight", "deadline_ms", "priority"}
    seen = set()
    for i, c in enumerate(sc.classes):
        label = f"{where}.classes[{i}]"
        if not isinstance(c, dict):
            raise SystemExit(f"{label}: expected a dict, got {c!r}")
        unknown = sorted(set(c) - allowed)
        if unknown:
            raise SystemExit(
                f"{label}: unknown field(s) {unknown}; valid: "
                f"{sorted(allowed)}"
            )
        name = c.get("name")
        if not name or not isinstance(name, str):
            raise SystemExit(f"{label}: 'name' must be a non-empty string")
        if name in seen:
            raise SystemExit(f"{label}: duplicate class name {name!r}")
        seen.add(name)
        for fname, pred, what in (
            ("share", lambda v: v > 0, "> 0"),
            ("deadline_ms", lambda v: v > 0, "> 0"),
            ("weight", lambda v: v > 0, "> 0"),
        ):
            v = c.get(fname, 1.0 if fname == "weight" else None)
            try:
                ok = v is not None and pred(float(v))
            except (TypeError, ValueError):
                ok = False
            if not ok:
                raise SystemExit(f"{label}.{fname}={v!r}: must be {what}")
        pr = c.get("priority", i)
        if not isinstance(pr, int) or pr < 0:
            raise SystemExit(
                f"{label}.priority={pr!r}: must be an int >= 0"
            )
    if sc.hosts < 1:
        raise SystemExit(f"{where}.hosts={sc.hosts!r}: must be >= 1")
    if not (sc.resize_window_s > 0):  # also rejects NaN
        raise SystemExit(
            f"{where}.resize_window_s={sc.resize_window_s!r}: must be > 0"
        )
    if sc.hosts > 1 and sc.readahead > 0:
        # The elastic pod is demand-path only: schedule readahead is a
        # single-host plane feature, and silently no-opping the knob
        # would hand an A/B user bit-identical arms.
        raise SystemExit(
            f"{where}.readahead={sc.readahead} is a single-host plane "
            f"feature — the elastic pod ({where}.hosts={sc.hosts}) "
            "resolves misses through coop ownership only; set "
            f"{where}.readahead=0"
        )
    validate_membership_timeline(sc, where)


def validate_membership_timeline(sc: "ServeConfig",
                                 where: str = "serve") -> None:
    """Parse-time sanity for the elastic-membership timeline (the
    validate_fault_config phase style): entry shape, numeric windows,
    exactly one known host action per entry, host ids inside the pod.
    A timeline over a single-host pod is refused loudly — there is no
    membership to change."""
    tl = sc.membership_timeline
    if not tl:
        return
    if sc.hosts < 2:
        raise SystemExit(
            f"{where}.membership_timeline needs {where}.hosts >= 2 "
            f"(got {sc.hosts}): a pod of one has no membership to change"
        )
    for i, ph in enumerate(tl):
        label = f"{where}.membership_timeline[{i}]"
        if not isinstance(ph, (list, tuple)) or len(ph) != 3:
            raise SystemExit(
                f"{label}: expected [t0, t1, {{action: host}}], got {ph!r}"
            )
        t0, t1, spec = ph
        try:
            t0, t1 = float(t0), float(t1)
        except (TypeError, ValueError):
            raise SystemExit(
                f"{label}: window [{ph[0]!r}, {ph[1]!r}] must be numeric"
            ) from None
        if t0 < 0 or t1 < t0:
            raise SystemExit(
                f"{label}: window [{t0}, {t1}] must satisfy 0 <= t0 <= t1"
            )
        if not isinstance(spec, dict) or len(spec) != 1:
            raise SystemExit(
                f"{label}: third element must be one {{action: host}} "
                f"dict, got {spec!r}"
            )
        (action, host), = spec.items()
        if action not in MEMBER_TIMELINE_ACTIONS:
            raise SystemExit(
                f"{label}: unknown membership action {action!r}; valid: "
                f"{sorted(MEMBER_TIMELINE_ACTIONS)}"
            )
        if not isinstance(host, int) or not (0 <= host < sc.hosts):
            raise SystemExit(
                f"{label}.{action}={host!r}: host must be an int in "
                f"[0, {sc.hosts})"
            )


# Host-level membership actions a chaos/serve timeline may carry (the
# single source dist/membership.py, the chaos splitter and the timeline
# validator all read). pause_host resumes at its window's t1; the
# others fire at t0.
MEMBER_TIMELINE_ACTIONS = (
    "kill_host", "leave_host", "pause_host", "rejoin_host",
)



@dataclass
class LifecycleConfig:
    """Storage-lifecycle plane (``lifecycle/`` + the ``ckpt-save``/
    ``ckpt-restore`` workloads; the ``meta_*`` fields are
    ``meta-storm``'s, which the port does not have yet, and round-trip
    unused).

    Every prior workload READS; this is the other half of the reference
    (``benchmark-script/``'s write/list/open binaries): a checkpoint-
    shaped write path over resumable multi-part uploads, a sharded
    restore with time-to-restore as the headline, and open-loop
    list/stat/open metadata storms driven by the arrivals plane so
    metadata ops get a knee curve too."""

    # --- checkpoint shape (save + restore) ---
    # The manifest: `objects` shard-objects of `object_bytes` each (a
    # sharded model layout — one object per parameter shard).
    objects: int = 4
    object_bytes: int = 8 * MB
    # Resumable-upload part size (each part is one content-range PUT).
    part_bytes: int = 1 * MB
    # Concurrent object uploads (save) / shard fetches (restore).
    writers: int = 4
    readers: int = 4
    # Object-name prefix; the manifest lands at <prefix>MANIFEST.json.
    prefix: str = "ckpt/"
    # Readback-verify every finalized object's crc32 against the
    # manifest (save) / verify fetched shard bytes (restore): the
    # zero-corrupt-finalizes check. Costs one extra read pass on save.
    verify: bool = True
    # Restore stages each rank's shard of every object into device
    # memory (dist.shard/reassemble path); False = host-RAM restore only.
    restore_device: bool = True
    # --- metadata storm ---
    meta_objects: int = 64  # many small objects (the pathology)
    meta_object_bytes: int = 4 * KB
    meta_rate_rps: float = 200.0  # offered metadata ops/second
    meta_duration_s: float = 2.0  # virtual schedule seconds
    meta_arrival: str = "poisson"  # poisson | bursty | diurnal
    # Op mix "kind:weight,..." over list/stat/open (open = open_read of
    # the object head, the reference's open_file analogue).
    meta_mix: str = "list:1,stat:2,open:2"
    # Wire page bound for list ops (maxResults; multi-page listings).
    meta_page_size: int = 16
    # Bytes an `open` op reads from the object head before closing.
    meta_read_bytes: int = 4 * KB
    # Storm service worker threads (the concurrency the knee saturates).
    meta_workers: int = 8
    # --serve-sweep-style offered-load multipliers for the knee curve.
    sweep_points: list = field(default_factory=lambda: [0.5, 1.0, 2.0, 4.0])
    seed: int = 0


def validate_lifecycle_config(lc: "LifecycleConfig",
                              where: str = "lifecycle") -> None:
    """Parse-time sanity for the lifecycle knobs (one-line SystemExit at
    config load — the validate_fault_config style)."""
    for name, lo in (
        ("objects", 1), ("object_bytes", 1), ("part_bytes", 1),
        ("writers", 1), ("readers", 1), ("meta_objects", 1),
        ("meta_object_bytes", 0), ("meta_page_size", 0),
        ("meta_read_bytes", 0), ("meta_workers", 1),
    ):
        v = getattr(lc, name)
        if v < lo:
            raise SystemExit(f"{where}.{name}={v!r}: must be >= {lo}")
    for name in ("meta_rate_rps", "meta_duration_s"):
        v = getattr(lc, name)
        if not (v > 0):  # also rejects NaN
            raise SystemExit(f"{where}.{name}={v!r}: must be > 0")
    if not lc.prefix:
        raise SystemExit(f"{where}.prefix: must be non-empty")
    if lc.meta_arrival not in ("poisson", "bursty", "diurnal"):
        raise SystemExit(
            f"{where}.meta_arrival={lc.meta_arrival!r}: must be "
            "poisson|bursty|diurnal"
        )
    parse_meta_mix(lc.meta_mix, where=where)
    if not lc.sweep_points or not all(
        isinstance(p, (int, float)) and p > 0 for p in lc.sweep_points
    ):
        raise SystemExit(
            f"{where}.sweep_points={lc.sweep_points!r}: must be a "
            "non-empty list of positive load multipliers"
        )


META_OP_KINDS = ("list", "stat", "open")


def parse_meta_mix(spec: str, where: str = "lifecycle") -> dict[str, float]:
    """``"list:1,stat:2,open:2"`` → normalized weight dict. Unknown op
    kinds, malformed entries and non-positive weights are one-line
    SystemExits at config load."""
    out: dict[str, float] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        kind, _, w_s = entry.partition(":")
        kind = kind.strip()
        if kind not in META_OP_KINDS:
            raise SystemExit(
                f"{where}.meta_mix: unknown op kind {kind!r}; valid: "
                f"{'/'.join(META_OP_KINDS)}"
            )
        try:
            w = float(w_s) if w_s else 1.0
        except ValueError:
            raise SystemExit(
                f"{where}.meta_mix: bad weight {w_s!r} for {kind!r}"
            ) from None
        if not (w > 0):
            raise SystemExit(
                f"{where}.meta_mix: weight for {kind!r} must be > 0"
            )
        out[kind] = out.get(kind, 0.0) + w
    if not out:
        raise SystemExit(f"{where}.meta_mix={spec!r}: no ops configured")
    total = sum(out.values())
    return {k: v / total for k, v in out.items()}


@dataclass
class DrillConfig:
    """Composed incident drill (``drill``, ``workloads/drill.py``):
    restore-while-serving on the elastic pod.

    The serve plane runs its open-loop QoS traffic over ``serve.hosts``
    pod hosts; at ``kill_at_s`` the membership plane kills ``victim``;
    at ``join_at_s`` a cold replacement joins and runs a checkpoint
    restore THROUGH the shared admission queue (and, on the coop arm,
    the coop cache), so restore reads, peer traffic, and gold-class
    fetches contend for the same slots, byte budgets, and — with
    ``meta_rate_rps`` > 0 — metadata quota. Periodic checkpoint DELTA
    saves (lifecycle/delta.py) ride under the same traffic on
    ``save_interval_s``."""

    # QoS identity of restore reads: their own first-class tag in the
    # admission queue and the cache/prefetch owner budgets (never a
    # masquerading tenant). Colliding with a serving class name is a
    # config error (validate_drill_config).
    restore_class: str = "restore"
    restore_priority: int = 1  # between gold (0) and best_effort
    restore_weight: float = 2.0  # byte-budget split weight
    restore_deadline_ms: float = 500.0  # per-chunk deadline (sheds count)
    # Restore driver window: chunk reads the joiner keeps in flight
    # through the shared admission queue.
    restore_inflight: int = 8
    # Bounded re-reads when a delta save lands a new shard generation
    # under an in-flight restore read (the torn-read path).
    restore_retries: int = 3
    # Scripted incident, in virtual schedule seconds on the arrival
    # clock: victim dies at kill_at_s, replacement joins cold at
    # join_at_s. victim = -1 resolves to the last host.
    kill_at_s: float = 1.0
    join_at_s: float = 1.5
    victim: int = -1
    # A/B arm: True routes restore reads through the joiner's coop
    # cache (peer hits possible); False fetches direct-to-origin (still
    # through the admission queue — slot contention stays).
    restore_via_coop: bool = True
    # Periodic checkpoint saves under traffic: interval in virtual
    # seconds (0 = no periodic saves); delta_saves=False forces every
    # save full (the delta-vs-full A/B arm); dirty_fraction of shards
    # mutate between saves.
    save_interval_s: float = 1.0
    delta_saves: bool = True
    dirty_fraction: float = 0.25
    # Concurrent open-loop metadata storm sharing the lifecycle quota
    # ledger with standalone meta-storm runs (0 = no storm mix).
    meta_rate_rps: float = 0.0
    # drill-sweep: save-interval multipliers stepped in order.
    sweep_points: list = field(default_factory=lambda: [0.5, 1.0, 2.0])


def validate_drill_config(dc: "DrillConfig", sc: "ServeConfig",
                          where: str = "drill") -> None:
    """Parse-time sanity for the drill plane (one-line SystemExit at
    config load — the validate_fault_config style). The drill composes
    the serve plane, so it also inherits validate_serve_config."""
    if not dc.restore_class or not isinstance(dc.restore_class, str):
        raise SystemExit(
            f"{where}.restore_class={dc.restore_class!r}: must be a "
            "non-empty string"
        )
    if dc.restore_class in {c.get("name") for c in sc.classes}:
        raise SystemExit(
            f"{where}.restore_class={dc.restore_class!r} collides with a "
            "serving class name — restore traffic must carry its own QoS "
            "tag"
        )
    if not isinstance(dc.restore_priority, int) or dc.restore_priority < 0:
        raise SystemExit(
            f"{where}.restore_priority={dc.restore_priority!r}: must be "
            "an int >= 0"
        )
    for name in ("restore_weight", "restore_deadline_ms", "join_at_s"):
        v = getattr(dc, name)
        if not (v > 0):  # also rejects NaN
            raise SystemExit(f"{where}.{name}={v!r}: must be > 0")
    for name, lo in (("restore_inflight", 1), ("restore_retries", 0)):
        v = getattr(dc, name)
        if v < lo:
            raise SystemExit(f"{where}.{name}={v!r}: must be >= {lo}")
    if not (dc.kill_at_s >= 0):
        raise SystemExit(f"{where}.kill_at_s={dc.kill_at_s!r}: must be >= 0")
    if not (dc.join_at_s >= dc.kill_at_s):
        raise SystemExit(
            f"{where}.join_at_s={dc.join_at_s!r}: must be >= kill_at_s "
            f"({dc.kill_at_s}) — the replacement joins after the incident"
        )
    if sc.hosts < 2:
        raise SystemExit(
            f"{where} needs serve.hosts >= 2 (got {sc.hosts}): a pod of "
            "one has no survivor to keep serving"
        )
    if not isinstance(dc.victim, int) or not (-1 <= dc.victim < sc.hosts):
        raise SystemExit(
            f"{where}.victim={dc.victim!r}: must be -1 (last host) or an "
            f"int in [0, {sc.hosts})"
        )
    if not (dc.save_interval_s >= 0):
        raise SystemExit(
            f"{where}.save_interval_s={dc.save_interval_s!r}: must be >= 0"
        )
    if not (0.0 < dc.dirty_fraction <= 1.0):  # also rejects NaN
        raise SystemExit(
            f"{where}.dirty_fraction={dc.dirty_fraction!r}: must be in "
            "(0, 1]"
        )
    if not (dc.meta_rate_rps >= 0):
        raise SystemExit(
            f"{where}.meta_rate_rps={dc.meta_rate_rps!r}: must be >= 0"
        )
    if not dc.sweep_points or not all(
        isinstance(p, (int, float)) and p > 0 for p in dc.sweep_points
    ):
        raise SystemExit(
            f"{where}.sweep_points={dc.sweep_points!r}: must be a "
            "non-empty list of positive save-interval multipliers"
        )


# Generated fleet membership-timeline kinds (fleet/driver.py builds the
# serve-format entries; "none" defers to serve.membership_timeline).
FLEET_TIMELINE_KINDS = ("none", "correlated_failure", "rolling_upgrade")


@dataclass
class FleetConfig:
    """Virtual-time fleet simulation (``fleet``,
    ``fleet/driver.py``): the elastic serve plane run by a discrete-event
    driver instead of worker threads, so pods scale to 64-4096 hosts.

    Service times come from a :class:`tpubench_torch.fleet.calibrate.
    FleetProfile` — either the per-phase constants below, or a
    distribution fitted from flight journals (``--calibrate-from``)
    and round-tripped through ``--fleet-profile`` JSON."""

    # Simulated pod size. 0 = inherit serve.hosts (the agreement-gate
    # arm, where both drivers must see the identical config).
    hosts: int = 64
    # Pod partitioning: hosts split into contiguous pods, each with its
    # own coop ring; >1 pod adds the cross-pod routing tier. 0 = auto
    # (one pod per 128 hosts, minimum one).
    pods: int = 0
    # Simulated service slots: workers_per_host * hosts virtual workers
    # share one admission queue. 0 = use serve.workers as the GLOBAL
    # pool size (the agreement-gate arm again: the threaded plane's
    # worker count is global, not per-host).
    workers_per_host: int = 2
    # Synthetic object population (the fleet never opens a backend);
    # sizes come from workload.object_size.
    objects: int = 64
    # Per-phase service-time constants (ms) used when no fitted profile
    # is configured. Defaults approximate the hermetic fake backend's
    # regime: origin ~ a faulted granule read, peer ~ loopback RTT.
    origin_service_ms: float = 4.0
    peer_service_ms: float = 0.5
    hit_service_ms: float = 0.05
    cross_pod_ms: float = 1.5
    # Flat stand-in for the bounded transient-retry ladder a paused
    # owner costs its peers (PEER_MAX_ATTEMPTS x backoff, ~150 ms).
    pause_penalty_ms: float = 150.0
    # Generated membership timeline (FLEET_TIMELINE_KINDS); composes
    # with serve.membership_timeline entries.
    timeline: str = "none"
    fail_at_s: float = 0.5  # correlated failure / first upgrade start
    fail_fraction: float = 0.1  # fraction of the fleet that dies
    recover_s: float = 0.0  # > 0: victims rejoin (cold) this much later
    upgrade_pause_s: float = 0.2  # rolling upgrade: per-host pause
    upgrade_stagger_s: float = 0.0  # 0 = sequential (next as prev resumes)
    # Victim-selection seed: WHICH hosts die changes remap geometry, so
    # it must replay deterministically.
    seed: int = 20
    # Fitted service profile (the FleetProfile.to_dict round-trip);
    # populated by --fleet-profile / --calibrate-from. Empty = use the
    # per-phase constants above.
    profile: dict = field(default_factory=dict)
    # --fleet-profile path (read, or written by --calibrate-from).
    profile_path: str = ""
    # --calibrate-from journal base paths (``.p<idx>``/gz siblings are
    # discovered automatically).
    calibrate_from: list = field(default_factory=list)
    # --fleet-sweep: step offered load like --serve-sweep.
    sweep: bool = False


def validate_fleet_config(fc: "FleetConfig", sc: "ServeConfig",
                          where: str = "fleet") -> None:
    """Parse-time sanity for the fleet plane (the one-line SystemExit
    style). The fleet composes the serve plane, so it also inherits
    validate_serve_config (the driver syncs serve.hosts first)."""
    if not isinstance(fc.hosts, int) or not (0 <= fc.hosts <= 8192):
        raise SystemExit(
            f"{where}.hosts={fc.hosts!r}: must be an int in [0, 8192] "
            "(0 = inherit serve.hosts)"
        )
    if not isinstance(fc.pods, int) or fc.pods < 0:
        raise SystemExit(f"{where}.pods={fc.pods!r}: must be an int >= 0")
    if fc.pods > max(fc.hosts, sc.hosts):
        raise SystemExit(
            f"{where}.pods={fc.pods}: more pods than hosts "
            f"({max(fc.hosts, sc.hosts)})"
        )
    if not isinstance(fc.workers_per_host, int) or fc.workers_per_host < 0:
        raise SystemExit(
            f"{where}.workers_per_host={fc.workers_per_host!r}: must be "
            "an int >= 0 (0 = serve.workers as the global pool)"
        )
    if not isinstance(fc.objects, int) or fc.objects < 1:
        raise SystemExit(
            f"{where}.objects={fc.objects!r}: must be an int >= 1"
        )
    for name in ("origin_service_ms", "peer_service_ms", "cross_pod_ms"):
        v = getattr(fc, name)
        if not (v > 0):  # also rejects NaN
            raise SystemExit(f"{where}.{name}={v!r}: must be > 0")
    for name in ("hit_service_ms", "pause_penalty_ms", "fail_at_s",
                 "recover_s", "upgrade_stagger_s"):
        v = getattr(fc, name)
        if not (v >= 0):  # also rejects NaN
            raise SystemExit(f"{where}.{name}={v!r}: must be >= 0")
    if fc.timeline not in FLEET_TIMELINE_KINDS:
        raise SystemExit(
            f"{where}.timeline={fc.timeline!r}: must be one of "
            f"{FLEET_TIMELINE_KINDS}"
        )
    if not (0.0 < fc.fail_fraction < 1.0):  # also rejects NaN
        raise SystemExit(
            f"{where}.fail_fraction={fc.fail_fraction!r}: must be in "
            "(0, 1) — someone has to survive"
        )
    if not (fc.upgrade_pause_s > 0):
        raise SystemExit(
            f"{where}.upgrade_pause_s={fc.upgrade_pause_s!r}: must be > 0"
        )
    if not isinstance(fc.seed, int) or fc.seed < 0:
        raise SystemExit(f"{where}.seed={fc.seed!r}: must be an int >= 0")
    if not isinstance(fc.profile, dict):
        raise SystemExit(
            f"{where}.profile: must be a fleet-profile dict "
            f"(got {type(fc.profile).__name__})"
        )


# The sections the port has dataclasses for (all of ``tpubench``'s); any
# other section of a loaded config is kept as the raw dict it was.
PORTED_SECTIONS = ("workload", "transport", "staging", "dist", "obs",
                   "telemetry", "tune", "pipeline", "coop",
                   "lifecycle", "serve", "drill", "fleet")


@dataclass
class BenchConfig:
    workload: WorkloadConfig = field(default_factory=WorkloadConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    staging: StagingConfig = field(default_factory=StagingConfig)
    dist: DistConfig = field(default_factory=DistConfig)
    obs: ObservabilityConfig = field(default_factory=ObservabilityConfig)
    telemetry: TelemetryConfig = field(default_factory=TelemetryConfig)
    tune: TuneConfig = field(default_factory=TuneConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    coop: CoopConfig = field(default_factory=CoopConfig)
    lifecycle: LifecycleConfig = field(default_factory=LifecycleConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    drill: DrillConfig = field(default_factory=DrillConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    raw: dict[str, dict] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        d = {
            name: dataclasses.asdict(getattr(self, name))
            for name in PORTED_SECTIONS
        }
        d.update(json.loads(json.dumps(self.raw)))
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "BenchConfig":
        def build(tp, val):
            if not dataclasses.is_dataclass(tp) or not isinstance(val, dict):
                return val
            kwargs = {}
            for f in dataclasses.fields(tp):
                if f.name in val:
                    sub = _SUBTYPES.get(f.name)
                    kwargs[f.name] = build(sub, val[f.name]) if sub else val[f.name]
            return tp(**kwargs)

        cfg = build(cls, {k: d[k] for k in PORTED_SECTIONS if k in d})
        cfg.raw = {
            k: json.loads(json.dumps(v)) for k, v in d.items()
            if k not in PORTED_SECTIONS
        }
        return cfg

    @classmethod
    def from_json(cls, s: str) -> "BenchConfig":
        return cls.from_dict(json.loads(s))


_SUBTYPES = {
    "workload": WorkloadConfig,
    "transport": TransportConfig,
    "staging": StagingConfig,
    "dist": DistConfig,
    "obs": ObservabilityConfig,
    "telemetry": TelemetryConfig,
    "tune": TuneConfig,
    "pipeline": PipelineConfig,
    "coop": CoopConfig,
    "lifecycle": LifecycleConfig,
    "serve": ServeConfig,
    "drill": DrillConfig,
    "fleet": FleetConfig,
    "retry": RetryConfig,
    "fault": FaultConfig,
    "tail": TailConfig,
}

# --------------------------------------------------------------- presets ----
def preset(name: str) -> BenchConfig:
    """The named presets of ``tpubench`` (``--preset``): the reference's
    four file sizes with their read counts (``read_operations.sh:8-14``:
    256KB/1MB/100MB/1GB, 1000/100/10/1 reads) and ``smoke``, a tiny run
    on the fake store. An unknown name is a ``KeyError``."""
    cfg = BenchConfig()
    sweeps = {
        "256kb": (256 * KB, 1000),
        "1mb": (1 * MB, 100),
        "100mb": (100 * MB, 10),
        "1gb": (1 * GB, 1),
    }
    key = name.lower()
    if key in sweeps:
        size, count = sweeps[key]
        cfg.workload.object_size = size
        cfg.workload.file_size_mb = max(1, size // MB)
        cfg.workload.read_count = count
        cfg.workload.read_calls_per_worker = count
        return cfg
    if key == "smoke":
        cfg.workload.workers = 2
        cfg.workload.threads = 2
        cfg.workload.read_calls_per_worker = 2
        cfg.workload.object_size = 4 * MB
        cfg.workload.file_size_mb = 4
        cfg.transport.protocol = "fake"
        return cfg
    raise KeyError(f"unknown preset {name!r}; have 256kb/1mb/100mb/1gb/smoke")


PRESET_NAMES = ("256kb", "1mb", "100mb", "1gb", "smoke")

STAGING_MODES = ("none", "device_put", "pallas")


def refuse_unported(cfg: BenchConfig) -> None:
    """The checks every workload runs on its config: the telemetry and
    tune sections, and ``ValueError`` for an unknown staging mode. Every
    read-path feature of ``tpubench`` is ported now (``obs.results_bucket``
    was the last), so nothing is refused as unported here."""
    s = cfg.staging
    validate_telemetry_config(cfg.telemetry)
    validate_tune_config(cfg.tune)
    if s.mode not in STAGING_MODES:
        raise ValueError(
            f"unknown staging mode {s.mode!r} ({'|'.join(STAGING_MODES)})"
        )
