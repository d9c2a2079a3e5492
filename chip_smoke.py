#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpubench_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failure raises and exits nonzero
before the last line:

1. build — compile the CUDA kernels from ``tpubench_torch/kernels/csrc``
   with nvcc (timed) and report the card as ``nvidia-smi`` names it;
2. kernels — each kernel against its plain PyTorch version on the card,
   bit-exact, at the main path's shapes (landing 58,368×128, checksum
   58,255×128), one 512-row block, a ragged 777,777 B, the edges of the
   checksum kernel's split over this card's SMs (``checksum_plan``) and an
   all-0xFF input whose sum wraps 2³²; then each kernel's time (CUDA
   events over back-to-back launches on buffers that together exceed the
   L2 cache), its plain version's, the faster of two one-call PyTorch
   yardsticks (``library_ms``: the byte sum as ``x.sum`` in int64 or in
   int32, whose wraparound is mod 2³²; landing adds ``out.copy_(x)``) and
   the bound; last a size sweep of both kernels (64 KiB to 256 MiB) with
   the fit ``t(n) = t0 + n / B``;
3. agree — the read workload at a small size on the CPU and on the card,
   in each staging mode, with equal bytes, transfers and checksum verdicts;
   Also the native executor route (2 workers, 777,777 B objects, 256 KiB
   slots, validate) against one loopback server, on the CPU and the card;
4. read — the main path: ``tpubench_torch read`` with the fake backend at
   the reference's deployment size (48 workers × 100 MiB objects, 2 MiB
   granules, depth 3, 1024 MiB host budget, one read per worker) in its
   three staging modes: device_put+validate (checksum kernel), device_put
   depth 3 (overlapped copies) and pallas (landing kernel), driven as the
   CLI's ``read`` drives it (``run_read`` with ``make_sink_factory``), the
   factory wrapped only to note each stager's CUDA stream: the 48 stagers
   must run on 48 distinct streams. The kernel launch counters are zeroed
   just before each mode and read just after; each must equal the mode's
   transfers;
5. native — the same deployment on the C++ fetch executor
   (``--protocol http --fetch-executor native``): the port's loopback
   server (``NativeSourceServer``, one 100 MiB body for every object
   name) answers slot-range GETs that land in page-locked 7,456,640 B
   slots (15 ranges a worker, 720 transfers), each slot then copied to
   the card on its worker's stream. Modes: native_validate (one
   ``tb_checksum`` launch per transfer), native_depth3 (no kernel) and
   native_fetch_only (staging none: host fetch alone). The slot ring is
   subclassed only to note each worker's slots and stream: every slot
   must be page-locked, 48 distinct streams, the reactor engaged. Mode
   native_h2_validate: the executor's h2 pool (``--http2``) against the
   port's h2c server over phase read's store, 8 workers of one read:
   the reactor engaged, at least one h2 stream per transfer in the
   engine's counters, ``checksum_ok`` and one ``tb_checksum`` launch per
   transfer;
6. protocols — the same deployment through every storage client of the
   worker-pool route, the reference's client switch (``main.go:169-177``),
   over one store (phase read's) served by the port's hermetic servers:
   http_validate and http_pallas (HTTP/1.1 Python reader),
   http_native_validate (native receive: the socket writes into the
   page-locked slot), http2_validate (the engine's h2c client),
   grpc_validate (library mode: grpcio carrying the port's storage-v2
   codec, as ``tpubench`` runs wherever grpcio imports) and
   grpc_native_validate (a library-mode client whose reads the engine's
   gRPC client makes) against the gRPC wire fake, grpc_wire_validate (the
   wire client, pinned through ``gcs_grpc._HAVE_LIB`` as on a machine
   without grpcio; WIRE_WORKERS workers), grpc_lib (library mode on an
   explicit channel to the port's grpcio fake, ``--staging pallas``:
   ``tb_land``), local_validate (files written
   under ``build/`` and removed after) and http_retry_validate (a seeded
   fault plan on the store under the retry policy: resumes must happen).
   Each mode must stage every byte with zero errors, launch its kernel
   once per transfer, keep a distinct stream per worker on page-locked
   slots and, but for the faulted mode (whose resumed reads fill slots
   off the granule grid), ship the transfers ``expected_transfers``
   counts. Every gRPC line names the mode its clients ran
   (``grpc_mode``), which must be library but in grpc_wire_validate: a
   machine without grpcio fails the run;
7. obs — phase read's deployment with the whole obs plane on: tracing
   (the tracer ``make_tracer`` builds, with an in-memory span store),
   telemetry on an ephemeral loopback port with OTLP dry-run export,
   ``obs.export='cloud'`` dry-run and the flight journal (under ``build/``,
   removed after), in modes obs_validate (``tb_checksum``) and obs_pallas
   (``tb_land``): ``/metrics``, scraped as the session closes, must show
   the result's reads, bytes and stage transfers; 48 ``ReadObject`` spans;
   the journal parses back with the result's record count; the dry-run
   payloads are non-empty and under ``obs.metric_prefix``;
8. tail — the deployment through ``open_backend`` with hedged reads, the
   stall watchdog and the circuit breaker on, over a fresh store with a
   seeded fault plan (``TAIL_FAULT``) that makes each layer act, in modes
   tail_validate and tail_pallas: every byte staged, zero errors, hedges,
   stalls and a breaker open→closed, and the flight summary's hedge,
   stall and breaker counts equal to the layers' own counters (breaker
   notes: those that found an unfinished read to land on);
9. pod — ``pod-ingest`` through ``cli.execute`` (the
   one-rank NCCL group it brings up on a loopback port, the run, the group
   torn down) of one 1 GiB object (the largest size of the reference's
   sweep) from the fake store, modes all_gather and ring (a fetch thread
   per shard), then http2_mux and grpc_native_mux (the store behind the
   port's h2c and wire-gRPC servers, the gRPC client in library mode with
   native receive; the rank's shard fetched as one
   ``read_ranges`` batch of 8 ranges on one connection, which the pool's
   accounting must show): verified, the device checksum equal to the
   host's byte sum mod 2³², NCCL the group's backend, the gather on the
   card, one ``tb_checksum`` launch per shard per collective call
   (warm-up included) and the pod flight record staged and gathered;
   fetch, stage and gather GB/s and seconds;
9b. pod_cards — ``pod-ingest`` of the same object as a user types it
   (``cli.main``) on every card the host shows: on one card ``main``
   keeps the one NCCL rank in process (no launch; ``n_chips`` 1, the
   gather's checksum the host's sum, two ``tb_checksum`` launches). On
   n >= 2 cards (``scripts/smoke_phases.py --phases pod_cards``) ``main``
   launches one NCCL rank a card for pod-ingest (all_gather, ring,
   http2_mux, grpc_native_mux), ``stream --validate``, ``gather-bench``,
   ``ckpt-restore`` and ``train-ingest --pipeline-pod``, each rank
   reporting its card, backend, errors and launches, then ``read
   --staging pallas`` lands on every card in process;
9c. hosts — ``tpubench``'s whole command line, typed as a user types it
   (``cli.main``): ``read --preset smoke`` on the card in the landing ring
   (``--staging pallas --validate``: one ``tb_land`` a transfer) and the
   validating copy ring (one ``tb_checksum`` a transfer), ``checksum_ok``;
   ``--save-config`` in a process of its own, whose file loads back to the
   config and which made no CUDA call; every read failing
   (``--fault-read-error-rate 1.0 --retry-max-attempts 1``) with and
   without ``--no-abort-on-error``, the same exit, errors and reads on the
   card as on the CPU; two hosts of a pod (``--num-processes 2``) started
   on the one card, both refused within 60 s naming the card's UUID, no
   process left. On n >= 2 cards (``scripts/smoke_phases.py --phases
   hosts``): two hosts of n / 2 cards (``CUDA_VISIBLE_DEVICES`` halves),
   one ``tpubench_torch.cli`` process a host launching one NCCL rank a
   card, run every launched mode of pod_cards plus chaos over pod-ingest
   and tune's sweep over the train pod: ``tpubench``'s topology stamp for
   2 hosts, every rank on its own card, ``n_chips`` the card count, no
   error, each mode's result verified;
10. gather — ``gather-bench`` at world size 1, each of the four
   collectives on a 4 MiB shard: ``single_device``, no errors, every
   output equal to its input, and every ``tb_checksum`` of the two
   gathers equal to the shard's byte sum mod 2³² taken on the host;
11. probe — ``probe --cycles 3 --cycle-sleep 0.5``;
12. profile — read depth 3, read pallas and pod/all_gather again under
   ``--profile-dir`` (``build/chip_smoke/profile``): the trace's
   ``tb_checksum``/``tb_land`` events must equal the launch counters; the
   device busy share (the union of kernel and copy intervals over the
   traced window) and the fetch threads' waits on the device;
13. tune — ``tune`` through ``cli.execute`` over phase read's deployment
   and store (window 0.5 s, session 6 s, seed 3 so the first depth probe
   is a grow): tune/online_depth3 (copy ring at depth 3, knobs workers and
   staging_depth, flight journal under ``build/``), tune/online_validate
   (``tb_checksum`` ring, knob workers) and tune/sweep_pallas (the
   coordinate sweep over workers 1..48 and depth 1-4, one read a worker,
   ``tb_land``). Zero errors, every read byte staged, no controller
   error; depth 3: 48 rings attached to one registry on 48 streams, each
   ring at the last depth it took (a ring that finished at the session's
   end keeps its depth), the registry at the controller's final depth,
   every ring grown live and every slot a grow made page-locked (each
   fan-out's wall time printed); validate:
   ``checksum_ok`` and one launch per transfer; sweep: per cell
   ``checksum_ok`` and ``tb_land`` launches == the cell's transfers ==
   workers × ``expected_transfers``. Then ``report`` over the three
   results, ``report timeline``/``trace`` and ``top --once`` over the
   journal: exit 0, the controller's decisions counted;
14. sweep — ``sweep`` as the CLI runs it: sweep/pallas, the fake store
   through the landing ring over the reference's four sizes and read
   counts, cut (256kb x 250 of 1000, 1mb x 100 at 48 workers; 100mb x 1
   of 10 at 48; 1gb x 1 at 4), then sweep/validate, HTTP/1.1, HTTP/2 and gRPC
   (library mode; each with and without native receive where there is
   one) through the validating
   copy ring against phase protocols' servers (100mb, 8 workers, one
   read each). Every cell ``checksum_ok``, zero errors, every byte
   staged, its workers on distinct streams with page-locked slots, and
   one kernel launch per transfer (``tb_land`` against the rings' own
   transfers and ``expected_transfers``; ``tb_checksum`` against the
   copy ring's);
15. fs — ``prepare`` and ``list``, ``open``, ``write``, ``ssd`` (seq and
   random) at ``tpubench``'s config defaults, ``read-fs`` at the reference
   launcher's four sizes and read counts, on a directory under
   ``build/`` (removed after): zero errors, ``bytes_total`` = threads x
   size x passes; GB/s, p50/p99 and whether ``O_DIRECT`` engaged;
16. preflight — exit 0 for the fake store, 1 against a dead endpoint, 0
   with ``--key-file`` against a loopback server (anonymous, as in
   ``tpubench``), 0 in a process that sees no GPU (which must not
   initialise CUDA);
17. stream — ``stream`` through ``cli.execute`` at ``tpubench``'s
   defaults (8 objects of 100 MiB, lane 128, validated) over phase read's
   store, then resumed from its snapshot to 10 objects (8 skipped, 2
   ingested), then 4 objects over the h2c server's mux route: verified,
   every object's device checksum the true byte sum of its object,
   ``tb_checksum`` launched once per object plus once for the warm-up,
   the peak device memory that of one object; overlap efficiency and the
   stage seconds printed;
18. multichip — ``multichip-sweep --sizes 1,2 --shard-mb 8 --reps 1``
   (artifact under ``build/``): the ring algebra holds, every pod-ingest
   row verified, the size-1 child on the card over NCCL (its launches
   counted in the child), the size-2 child two gloo ranks;
19. train — ``train-ingest`` through ``cli.execute`` over phase read's
   store (48 x 100 MiB, 2 MiB chunks, 32 a step, 75 steps = one epoch of
   the 4.8 GiB dataset, 20 ms of step compute) in modes train_cold
   (readahead 0, page-locked slab pool, the overlapped copy window taking
   each lease in place: one transfer per chunk, no kernel), train_prefetch
   (readahead 64, 8 prefetch workers, 1 GiB cache; its stalls printed
   beside train_cold's, not gated), train_validate (the serial ring:
   ``tb_checksum`` per transfer), train_pallas (``tb_land`` per
   transfer), train_bytes (no slab pool: 2 copies a byte), train_warm (16
   steps x 2 epochs in a 1.25 GiB cache: epoch 2 all hits) and train_pod
   (one-rank NCCL: ``tb_checksum`` once per step and once for the
   warm-up, each step's pod sum the host's sum of its batch); every mode
   with zero errors, every byte delivered, no slab leaked. Then ``tune
   --tune-workload train-ingest`` (a sweep at 8 steps a cell, and an
   online session in ``train-ingest --tune``);
20. coop — the cooperative chunk cache at phase train's deployment:
   coop/coop_validate (``train-ingest --validate --coop``, the loopback
   channel, one host: ``checksum_ok``, ``tb_checksum`` once per slot, as
   many slots as train_validate; its GB/s printed beside
   train_validate's), coop/coop_ici (``--pipeline-pod --readahead 0
   --coop --coop-channel ici`` on the one-rank NCCL group: ``tb_checksum``
   once per step and once for the warm-up, each step's pod sum the
   host's, the channel built on NCCL and no broadcast, since a pod of
   one routes nothing); both with the coop stamp of one host (no peer
   request, origin fetches = the cache's misses), the scorecard's coop
   line, zero errors, every byte delivered, no slab leaked. Then
   coop/channel (``IciPeerChannel.broadcast`` at 128, 1000, 4096 B and
   one 2 MiB chunk on the one-rank NCCL group: every echo bit-exact, one
   ``tb_checksum`` a broadcast, the ms of each and the steady ms of a
   2 MiB broadcast) and coop/sim (``run_coop_sim`` coop on and off at 2
   and 4 hosts with page-locked slab pools, at ``tests/test_coop.py``'s
   acceptance settings: the pod's origin bytes and fetches, unique
   chunks and the most fetches of one chunk equal ``tpubench``'s CPU
   numbers; the origin bytes saved and the seconds printed);
21. ckpt — ``ckpt-save`` then ``ckpt-restore`` through ``cli.execute``,
   each mode on a store of its own: a 2 GiB checkpoint (16 objects x
   128 MiB, 16 MiB parts, 8 writers, 8 readers, verified) in the
   in-process store (ckpt_fake), behind the HTTP/1.1 fake server that
   ``hermetic_target`` starts (ckpt_http) and behind the gRPC wire fake
   (ckpt_grpc, 4 objects, library mode: grpcio's resumable writer), the
   last two under ``CKPT_FAULT``'s upload
   reset and stalls. Save: zero errors and corrupt finalizes, verified,
   8 parts an object, resumed parts under faults, the stored bytes the
   manifest's (read straight from the store), the manifest present.
   Restore onto ``cuda:0``: verified, staged, one shard an object, one
   chip, and every staged tensor equal on the card to its object's
   bytes. Then results_upload: ``read --protocol http --results-bucket``
   at phase read's deployment through the validating ring behind the
   HTTP/1.1 fake (one ``tb_checksum`` per transfer): the stored
   ``results/<file>`` equals the result file byte for byte;
22. serve — ``serve`` through ``cli.execute`` over phase read's store
   (2 MiB chunks) at ``tpubench``'s ServeConfig defaults (100 tenants in
   gold/silver/best_effort, Poisson 200/s, 8 workers, Zipf 1.2, QoS on):
   serve_default (4 s), serve_qos and serve_fifo (the QoS A/B at the
   reference acceptance's ratio and request size: 64 KiB requests at
   4 ms a read, cache off, 8 workers = 2,000/s of capacity, 3,200/s
   offered, 2 s), serve_bursty (MMPP: burst 4x, fraction 0.25, 1 s
   cycles; it must end), serve_sweep (``--serve-sweep``, the 5 default
   points of 800/s at 2 s each, 64 KiB at 4 ms: a knee must be found),
   serve_reactor (behind the HTTP/1.1 fake with ``--fetch-executor
   native``: every fetch one completion of the engine's pool, the
   reactor engaged, no Python read) and serve_elastic (4 hosts, host 1
   killed at 1.2 s and rejoined at 2.4 s: both events applied, epoch 2,
   no slab leaked, unpinned pools). Every mode: zero errors, every
   arrival completed, shed or an error, Jain reported, no kernel
   launched. Then the A/B's verdict: gold SLO with QoS >= 0.9 and above
   FIFO's, best-effort sheds, gold sheds nothing, goodput retention
   >= 0.6;
23. chaos — ``chaos`` through ``cli.execute``, a fault window inside
   each run, over the arrays of phase read's and phase pod's stores
   (``SharedStore``: ``run_chaos`` opens its own backend, whose
   ``FakeBackend.prepopulated`` then hands back those arrays under the
   armed fault plan): chaos_read_validate and chaos_read_pallas (read's
   deployment, 3 reads a worker, a 0.4 s stall in half the readers:
   ``checksum_ok`` and one ``tb_checksum`` / ``tb_land`` launch a
   transfer), chaos_pod (the 1 GiB object on the one-rank NCCL group, a
   0.2 s stall at the first byte, which the shard's fetch must show:
   verified, a ``tb_checksum`` a collective call),
   chaos_train (train's deployment at 20 steps through the validating
   ring, every read opened in [0.1, 0.6] s blackholed, hedged reads and
   the watchdog on: data-stall time and watchdog stalls, never a hang,
   one ``tb_checksum`` a slot) and chaos_serve (the elastic pod of 4
   hosts, host 2 killed at 1 s beside a 50 ms stall in half the readers:
   the kill applied, no slab leaked, every arrival accounted for, no
   kernel launched). Every mode prints its resilience scorecard, has
   zero errors and failed reads, and leaves the caller's config as it
   was. Every arm reads the fake store in process: no gRPC client runs;
24. drill — none of it launches a kernel. meta_http and meta_grpc:
   ``meta-storm`` through ``cli.execute`` at ``tpubench``'s lifecycle
   defaults (64 objects of 4 KiB, Poisson 200 ops/s for 2 s, mix
   list:1,stat:2,open:2, pages of 16, 8 workers) behind the HTTP/1.1 and
   the gRPC wire fakes (meta_grpc in library mode, its ``grpc_mode``
   printed): every op of the schedule completed, no error,
   every list the folder's 64 names over 4 pages (the store's own list
   counted once a page); meta_sweep: ``--meta-sweep`` at 3 points, its
   points and knee printed. drill_default: ``drill`` at ``tpubench``'s
   ServeConfig and DrillConfig defaults on a 4-host pod over phase
   read's objects (a store sharing its arrays; no gRPC client), a checkpoint of 16
   objects of 48 MiB in 16 MiB parts: the restore verified, the serving
   classes without error, no slab leaked, the pools unpinned, every
   stored shard's crc32 the one its saver published for that generation
   (0 corrupt finalizes); save dispositions and torn re-reads printed.
   drill_meta: the same with a 200/s storm beside it. replay_gold: both
   bundles under ``scenarios/`` validated and replayed under their
   recording config (fingerprint and arrivals match, gold SLO within 5
   points, the drill's restore verified), then drill_default's journal
   recorded, replayed and re-recorded: the two bundles byte-identical.
25. fleet — ``fleet`` through ``cli.execute``, none of it launching a
   kernel: fleet_scale (``tpubench``'s scale acceptance: 1024 hosts in 8
   pods, 100,000 tenants, diurnal 30,000/s for 1 s, 5% of the fleet
   killed at 0.5 s and rejoined 0.4 s later, seed 20: 51 kills and 51
   rejoins applied, no error, the serve, resize and fleet blocks in the
   printout and in ``report`` over the result, under 60 s of wall),
   fleet_max (4096 hosts at the FleetConfig and ServeConfig defaults
   under a rolling upgrade: every host paused and resumed, epoch 8,192,
   under 60 s), fleet_sweep (``--fleet-sweep`` at the defaults: 5
   points, the knee or none) and fleet_agree (a 4-host elastic ``serve``
   with 4 ms a read writes a journal, ``fleet --calibrate-from`` it runs
   the same scenario: the same arrivals, ``kill_host`` 1 at epoch 1 in
   both, gold SLO within 2 points; both arms' gold SLO and the fitted
   origin and peer p50/p99 printed);
26. check — ``check --json`` over ``tpubench_torch/`` on this machine,
   every drift guard run (the native-counters guard builds and probes
   the engine): exit 0, no finding, no stale allowlist entry, no guard
   skipped, every file scanned; each pass's and guard's seconds printed.

Phase kernels also holds ``tb_checksum`` at phase gather's shard (4 MiB),
at phase train's pod shard (one step's batch, 64 MiB, 524,288 × 128), at
the slots of phase coop's broadcasts (128, 1,024, 4,096 B and 2 MiB) and
at phase pod's (1 GiB, 8,388,608 × 128) against its plain version, the
last with its time and bound.

Every mode of phases read, protocols, obs and tail also checks its flight
records (one read record per read; one stage record per transfer in a copy
ring, none in the landing-kernel ring; ``stage_submit <= stage_complete ==
hbm_staged``); phase native checks that the executor route, as in
``tpubench``, carries none. Phase read adds mode device_put_depth3_noflight
(the flight recorder off) and runs it and device_put_depth3 twice more in
the reverse order; the ``flight_cost`` line gives their staged GB/s.

Phase agree also runs http_validate and grpc_validate (library mode) small,
on the CPU and on the card. Then the ``phase_seconds`` line (each phase's
wall), then the ``kernels`` summary line (launches summed over the paths that
ran each kernel, and per path; ``no_launch_paths``: every mode of phases
serve, drill, fleet and check, each at 0), the ``nvidia-smi`` name/power-limit line,
and last ``{"ok": true, "device": {...}}``. Without CUDA, or without the
rest of the repository beside it, the script fails at once.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time

MIB = 1 << 20
MOD = 1 << 32
# Peaks of one H100 SXM (NVIDIA data sheet, dense): HBM3 bandwidth and the
# int8 rate, the fastest the card does any byte-wide integer operation.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
L2_BYTES = 50 * MIB
# The reference's deployment (main.go --worker, 100 MiB objects, 2 MiB
# granules); only read_calls_per_worker is cut (1e6 → 1).
WORKERS, OBJECT_SIZE, GRANULE = 48, 100 * MIB, 2 * MIB
LAND_ROWS, CHECKSUM_ROWS = 58_368, 58_255  # main-path slot shapes (×128)
SWEEP = (64 * 1024, MIB, CHECKSUM_ROWS * 128, 64 * MIB, 256 * MIB)
# Storage clients of phase protocols: mode -> (protocol, server, transport
# switches, staging). Every mode stages through a kernel.
PROTOCOL_MODES = {
    "http_validate": ("http", "h1", {}, "validate"),
    "http_pallas": ("http", "h1", {}, "pallas"),
    "http_native_validate": ("http", "h1", {"native_receive": True}, "validate"),
    "http2_validate": ("http", "h2", {"http2": True}, "validate"),
    "grpc_validate": ("grpc", "grpc", {}, "validate"),
    "grpc_native_validate": ("grpc", "grpc", {"native_receive": True},
                             "validate"),
    "grpc_wire_validate": ("grpc", "grpc", {}, "validate"),
    "grpc_lib": ("grpc", "grpcio", {}, "pallas"),
    "local_validate": ("local", None, {}, "validate"),
    "http_retry_validate": ("http", "h1", {}, "validate"),
}
# grpc_wire_validate's workers, cut from the deployment's 48: the wire
# client is the path of a machine without grpcio, read here only to hold
# that path on the card.
WIRE_WORKERS = 16
# The faulted mode's plan (on the store, behind the server) and its retry
# policy: a 1-10 ms backoff without jitter.
RETRY_FAULT = dict(error_rate=0.05, read_error_rate=0.002)
# Phase tail's fault plan on the store (behind the tail layers): every
# open waits latency_s (twice the hedge delay, so every read hedges), a
# quarter of the readers stall for stall_s after stall_after_bytes (three
# stall windows: the watchdog fires), and a tenth of the opens fail (one
# failure opens the breaker, which probes again after breaker_reset_s).
TAIL_FAULT = dict(latency_s=0.1, stall_after_bytes=32 * MIB, stall_s=1.5,
                  stall_rate=0.25, error_rate=0.1)
TAIL = dict(hedge=True, hedge_delay_s=0.05, watchdog=True,
            stall_window_s=0.5, breaker=True, breaker_failures=1,
            breaker_reset_s=0.2)
OBS_MODES = ("obs_validate", "obs_pallas")
TAIL_MODES = ("tail_validate", "tail_pallas")
# Phase pod: one 1 GiB object, the largest size of the reference's sweep
# (benchmark-script/read_operations/read_operations.sh:8-14), on a 128-byte
# lane; one rank holds the whole of it as its shard (8,388,608 x 128).
POD_OBJECT = 1 << 30
# Threaded modes: one fetch thread per shard. Mux modes: the rank's shard
# as MUX_RANGES_PER_RANK ranges on one connection, against the port's h2c
# and wire-gRPC servers over phase pod's store.
POD_MODES = {"all_gather": [], "ring": ["--ring"],
             "http2_mux": ["--protocol", "http", "--http2"],
             "grpc_native_mux": ["--protocol", "grpc", "--native-receive"]}
GATHER_MODES = ("all_gather", "ring", "reduce_scatter", "psum")
GATHER_REPS = 5
GATHER_SHARD_MB = 4  # phase gather's shard: 32,768 x 128
BUILD = "build/chip_smoke"
# Phase native's h2 mode: the executor's h2 pool against the port's h2c
# server, which moves 0.2-0.5 GB/s, so 8 workers of one read each.
NATIVE_H2_WORKERS = 8
# Phase stream: `stream` at tpubench's defaults (8 objects of
# workload.object_size, lane 128, validated) over phase read's store; a
# resume to 10 objects; the h2 mux route on fewer objects (the Python
# server's rate). Each mode launches tb_checksum once per object and once
# for the warm-up (every object has one shape).
STREAM_MODES = {"stream": 8, "stream_resume": 10, "stream_h2_mux": 4}
MULTICHIP = ["multichip-sweep", "--sizes", "1,2", "--shard-mb", "8",
             "--reps", "1"]
# Phase ckpt: a sharded checkpoint of a 1B-parameter model in bf16, 16
# objects x 128 MiB = 2 GiB (the order of Llama-3.2-1B's published 2.47 GB
# safetensors), 16 MiB parts (the Go GCS client's resumable chunk,
# googleapi.DefaultUploadChunkSize), 8 writers and 8 readers, verified.
# Mode -> (protocol, faulted, objects): the gRPC wire path is cut to 4
# objects (against these Python fakes it moves 5-7x slower than HTTP/1.1).
CKPT_OBJECT_BYTES, CKPT_PART_BYTES, CKPT_WORKERS = 128 * MIB, 16 * MIB, 8
CKPT_MODES = {"ckpt_fake": ("fake", False, 16),
              "ckpt_http": ("http", True, 16),
              "ckpt_grpc": ("grpc", True, 4)}
# The reference's acceptance timeline scaled to the part: one reset a
# session mid part 2, a 10 ms stall in half the sessions.
CKPT_FAULT = dict(upload_reset_after_bytes=24 * MIB, upload_stall_s=0.01,
                  upload_stall_rate=0.5, seed=11)
KERNELS = {
    "land": dict(source="tpubench_torch/kernels/csrc/landing.cu",
                 replaces="tpubench/staging/pallas_stage.py:101",
                 paths=("read/pallas", "protocols/http_pallas",
                        "protocols/grpc_lib",
                        "obs/obs_pallas", "tail/tail_pallas",
                        "tune/sweep_pallas", "sweep/pallas",
                        "train/train_pallas", "chaos/read_pallas",
                        "hosts/smoke_pallas")),
    "checksum": dict(source="tpubench_torch/kernels/csrc/landing.cu",
                     replaces="tpubench/staging/pallas_stage.py:71",
                     paths=("read/device_put_validate",
                            "native/native_validate",
                            *(f"protocols/{m}" for m, v in PROTOCOL_MODES.items()
                              if v[3] == "validate"),
                            "obs/obs_validate", "tail/tail_validate",
                            "pod/all_gather", "pod/ring",
                            "pod/http2_mux", "pod/grpc_native_mux",
                            "pod_cards/pod_ingest",
                            "gather/all_gather", "gather/ring",
                            "tune/online_validate", "sweep/validate",
                            "native/native_h2_validate",
                            *(f"stream/{m}" for m in STREAM_MODES),
                            "multichip/size1", "train/train_validate",
                            "train/train_pod", "coop/coop_validate",
                            "coop/coop_ici", "coop/channel",
                            "ckpt/results_upload", "chaos/read_validate",
                            "chaos/pod", "chaos/train",
                            "hosts/smoke_validate")),
}


# Phases none of whose modes stages a byte (in tpubench as here).
NO_KERNEL_PHASES = ("serve", "drill", "fleet", "check")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the kernels' random inputs")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from tpubench_torch.device import nvidia_smi_line

    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    check(count == 1, f"expected one card, torch sees {count}")
    seconds = {}  # phase -> wall seconds

    def timed(phase: str, fn, *a):
        t0 = time.perf_counter()
        try:
            return fn(*a)
        finally:
            seconds[phase] = time.perf_counter() - t0

    timed("build", phase_build)
    kernels = timed("kernels", phase_kernels, torch, args.seed)
    timed("agree", phase_agree)
    store = timed("populate", populate)
    counts = {  # "<phase>/<mode>" -> counts
        **timed("read", phase_read, store, smi),
        **timed("native", phase_native),
        **timed("native_h2", native_h2_mode, store, smi),
        **timed("protocols", phase_protocols, store, smi, args.seed),
        **timed("obs", phase_obs, store, smi),
        **timed("tail", phase_tail, smi, args.seed),
    }
    pod_counts, pod_store = timed("pod", phase_pod, smi)
    counts.update(pod_counts)
    counts.update(timed("pod_cards", phase_pod_cards, pod_store, store, smi))
    counts.update(timed("hosts", phase_hosts, pod_store, smi))
    counts.update(timed("gather", phase_gather, smi))
    timed("probe", phase_probe, smi)
    timed("profile", phase_profile, store, pod_store, smi)
    counts.update(timed("tune", phase_tune, store, smi))
    counts.update(timed("sweep", phase_sweep, store, smi))
    timed("fs", phase_fs, smi)
    timed("preflight", phase_preflight, smi)
    counts.update(timed("stream", phase_stream, store, smi))
    counts.update(timed("multichip", phase_multichip, smi))
    train_counts, train_lines = timed("train", phase_train, store, smi)
    counts.update(train_counts)
    counts.update(timed("coop", phase_coop, store, smi, train_lines))
    counts.update(timed("ckpt", phase_ckpt, store, smi))
    counts.update(timed("serve", phase_serve, store, smi))
    counts.update(timed("chaos", phase_chaos, store, pod_store, smi))
    counts.update(timed("drill", phase_drill, store, smi))
    counts.update(timed("fleet", phase_fleet, smi))
    counts.update(timed("check", phase_check, smi))
    emit({"phase_seconds": seconds, "total_s": sum(seconds.values())})
    for k, v in kernels.items():
        by_path = {p: counts[p][k] for p in KERNELS[k]["paths"]}
        check(all(by_path.values()), f"{k}: a path did not launch it {by_path}")
        v["launches"] = sum(by_path.values())
        v["launches_by_path"] = by_path
        # The phases that stage nothing, every mode at 0 launches.
        idle = {p: c[k] for p, c in counts.items()
                if p.split("/")[0] in NO_KERNEL_PHASES}
        check(not any(idle.values()), f"{k}: launched in {idle}")
        v["no_launch_paths"] = idle
    emit({"kernels": [dict(name=k, **v) for k, v in kernels.items()]})
    print(smi or "nvidia-smi: not available", flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


# -------------------------------------------------------------- phase 1 --
def phase_build() -> None:
    from tpubench_torch.device import capability_report
    from tpubench_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.load()
    log = build.library_path().with_suffix(".log")
    ptxas = [
        ln.strip() for ln in (log.read_text().splitlines() if log.exists() else [])
        if "registers" in ln or "spill" in ln
    ]
    check(lib is not None, "kernel library did not load")
    emit({"phase": "build", "nvcc_s": build.last_build_s,
          "load_s": time.perf_counter() - t0,
          "library": str(build.library_path().relative_to(build.BUILD_DIR.parents[1])),
          "ptxas": ptxas, **capability_report()})


# -------------------------------------------------------------- phase 2 --
def _random_bytes(torch, n: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device="cuda",
                         generator=g)


def _verify(torch, landing, name: str, x, seed: int) -> int:
    """Kernel vs plain version on ``x``, from a random nonzero starting
    accumulator; returns the largest absolute difference (must be 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    start = torch.randint(-(2**31), 2**31 - 1, (1,), dtype=torch.int32,
                          device="cuda", generator=g)
    err = 0
    if name == "land":
        out, acc = landing.land(x, start.clone())
        ref_out, ref_acc = landing.land_reference(x, start.clone())
        err = int((out.to(torch.int16) - ref_out.to(torch.int16)).abs().max())
        check(out.data_ptr() != x.data_ptr(), "land must write a new buffer")
    else:
        acc = landing.checksum(x, start.clone())
        ref_acc = landing.checksum_reference(x, start.clone())
    torch.cuda.synchronize()
    a, b = landing.acc_value(acc), landing.acc_value(ref_acc)
    return max(err, min((a - b) % MOD, (b - a) % MOD))


def checksum_edges(plan, sms: int) -> dict:
    """Sizes at the edges of ``plan`` (``checksum_plan``) on ``sms`` SMs:
    the main-path split's end ± 1, one main-path chunk + 15, a second
    block of 15 bytes, a full grid whose last block holds 15 bytes, and
    15 bytes alone (under one vector)."""
    blocks, chunk = plan(CHECKSUM_ROWS * 128, sms)  # the main path fills the grid
    small = plan(1, sms)[1]
    last15 = None
    for c in range(chunk, 0, -128):
        if plan((blocks - 1) * c + 15, sms) == (blocks, c):
            last15 = (blocks - 1) * c + 15
            break
    return {"edge_minus_1": blocks * chunk - 1, "edge_plus_1": blocks * chunk + 1,
            "chunk_plus_15": chunk + 15, "second_block_15": small + 15,
            "last_block_15": last15, "under_one_vector": 15}


def timing_buffers(torch, n: int, seed: int) -> list:
    """Inputs of ``n`` bytes that together exceed twice the L2 cache, so
    each launch of a rotation reads its input from HBM."""
    nbuf = max(2, math.ceil(2 * L2_BYTES / n))
    return [_random_bytes(torch, n, seed + i) for i in range(nbuf)]


def fit_line(ms_by_size: dict) -> dict:
    """``t(n) = t0 + n / B`` by least squares on the relative error (each
    size weighs the same): ``t0`` in µs, ``B`` in TB/s."""
    w = [(n, t, 1 / t**2) for n, t in ms_by_size.items()]
    s0, sx, sy = (sum(c for *_, c in w), sum(n * c for n, _, c in w),
                  sum(t * c for _, t, c in w))
    sxx, sxy = sum(n * n * c for n, _, c in w), sum(n * t * c for n, t, c in w)
    slope = (s0 * sxy - sx * sy) / (s0 * sxx - sx * sx)
    return {"t0_us": (sy - slope * sx) / s0 * 1e3, "tbps": 1e-9 / slope}


def _time_ms(torch, fn, iters: int) -> float:
    """Device time per call of ``fn(i)``: the launches are queued behind a
    sleep kernel so the card runs them back to back, timed by events."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    e0, e1, e2 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    e0.record()
    torch.cuda._sleep(100_000_000)
    e1.record()
    h0 = time.perf_counter()
    for i in range(iters):
        fn(i)
    host_ms = (time.perf_counter() - h0) * 1e3
    e2.record()
    e2.synchronize()
    check(host_ms < e0.elapsed_time(e1),
          f"host enqueue ({host_ms:.2f} ms) outlasted the queue-ahead sleep")
    return e1.elapsed_time(e2) / iters


def phase_kernels(torch, seed: int) -> dict:
    from tpubench_torch.kernels import landing

    shapes = {
        "land": [("main_path", LAND_ROWS * 128), ("block", 512 * 128)],
        "checksum": [("main_path", CHECKSUM_ROWS * 128), ("block", 512 * 128),
                     ("gather_shard", GATHER_SHARD_MB * MIB),
                     ("train_pod_shard", TRAIN_BATCH * GRANULE),
                     *((f"coop_slot_{n}", -(-n // 128) * 128)
                       for n in COOP_CHANNEL_SIZES)],
    }
    ragged, wraps = 777_777, 17 * MIB + 13
    edges = checksum_edges(landing.checksum_plan, landing.sm_count(torch.device("cuda")))
    out = {}
    for name, cases in shapes.items():
        errs = {}
        for label, n in cases + [("ragged", ragged), *edges.items()]:
            x = _random_bytes(torch, n, seed + n)
            errs[label] = _verify(torch, landing, name, x, seed + n)
        ff = torch.full((wraps,), 0xFF, dtype=torch.uint8, device="cuda")
        check(255 * wraps > MOD, "the all-0xFF case must wrap")
        errs["all_ff_wraps"] = _verify(torch, landing, name, ff, seed)
        max_err = max(errs.values())
        check(max_err == 0, f"{name}: kernel disagrees with plain {errs}")

        # The int32 sum must give the kernel's bits to count as a yardstick.
        x = _random_bytes(torch, cases[0][1], seed)
        check(int(x.sum(dtype=torch.int32)) % MOD
              == landing.acc_value(landing.checksum_reference(x)),
              "x.sum(dtype=int32) is not the mod-2^32 byte sum")

        n = cases[0][1]
        xs = timing_buffers(torch, n, seed)
        nbuf = len(xs)
        acc = landing.new_acc("cuda")
        outs = [torch.empty_like(x) for x in xs]
        kernel, plain = _launchers(torch, landing, name, xs, acc)
        moved = 2 * n if name == "land" else n
        libs = {}
        for dtype in (torch.int64, torch.int32):
            def library(i, dtype=dtype):
                if name == "land":
                    outs[i % nbuf].copy_(xs[i % nbuf])
                return xs[i % nbuf].sum(dtype=dtype)

            call = f"x.sum(dtype={dtype})"
            libs["out.copy_(x) + " + call if name == "land" else call] = _time_ms(
                torch, library, 100)
        library_call = min(libs, key=libs.get)
        times = {
            "ms": _time_ms(torch, kernel, 200),
            "plain_ms": _time_ms(torch, plain, 20),
            "library_ms": libs[library_call],
        }
        rec = {
            "route": "cuda", "source": KERNELS[name]["source"],
            "replaces": KERNELS[name]["replaces"], "launches": None,
            "max_abs_err": max_err, **times, "library_call": library_call,
            **_bound(moved, n),
        }
        rec["roofline_share"] = rec["bound_ms"] / times["ms"]
        emit({"phase": "kernels", "kernel": name, "bytes": n, "moved": moved,
              "checks": errs, "timing_buffers": nbuf, "kernel_ms": times["ms"],
              "bound_us": rec["bound_ms"] * 1e3,
              "gbps": moved / (times["ms"] / 1e3) / 1e9,
              "library_calls_ms": libs, **rec})
        out[name] = rec
    out["checksum"]["pod_shard"] = pod_shard_checksum(torch, landing, seed)
    emit({"phase": "kernels", "sweep": sweep(torch, landing, seed)})
    return out


def pod_shard_checksum(torch, landing, seed: int) -> dict:
    """``tb_checksum`` at phase pod's shape (one rank's 1 GiB shard,
    8,388,608 x 128): bit-exact against its plain version, then timed as
    above on two such buffers (2 GiB, beyond the L2 cache)."""
    n = POD_OBJECT
    xs = [_random_bytes(torch, n, seed + i) for i in range(2)]
    err = _verify(torch, landing, "checksum", xs[0], seed)
    check(err == 0, f"checksum at the pod shard: max_abs_err {err}")
    acc = landing.new_acc("cuda")
    kernel, plain = _launchers(torch, landing, "checksum", xs, acc)
    rec = {
        "bytes": n, "max_abs_err": err,
        "ms": _time_ms(torch, kernel, 50),
        "plain_ms": _time_ms(torch, plain, 5),
        "library_ms": _time_ms(
            torch, lambda i: xs[i % 2].sum(dtype=torch.int32), 20),
        "library_call": "x.sum(dtype=torch.int32)", **_bound(n, n),
    }
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    emit({"phase": "kernels", "kernel": "checksum", "shape": "pod_shard",
          "rows": n // 128, "lane": 128, **rec})
    return rec


def _bound(moved: int, n: int) -> dict:
    """The least time for the work: bytes at the HBM rate or byte adds at
    the int8 rate, whichever is longer."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n / INT8_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _launchers(torch, landing, name: str, xs: list, acc):
    """``(kernel, plain)``: call ``i`` runs on input ``i % len(xs)``."""
    nbuf = len(xs)
    if name == "land":
        return (lambda i: landing.land(xs[i % nbuf], acc),
                lambda i: landing.land_reference(xs[i % nbuf], acc))
    return (lambda i: landing.checksum(xs[i % nbuf], acc),
            lambda i: landing.checksum_reference(xs[i % nbuf], acc))


def sweep(torch, landing, seed: int) -> dict:
    """Each kernel's time at the ``SWEEP`` sizes, timed as above, its share
    of the bound at each, and the fit ``t0 + n / B``."""
    res = {name: {"ms": {}, "roofline_share": {}} for name in KERNELS}
    for n in SWEEP:
        xs = timing_buffers(torch, n, seed)
        acc = landing.new_acc("cuda")
        for name in KERNELS:
            ms = _time_ms(torch, _launchers(torch, landing, name, xs, acc)[0], 200)
            moved = 2 * n if name == "land" else n
            res[name]["ms"][n] = ms
            res[name]["roofline_share"][n] = _bound(moved, n)["bound_ms"] / ms
        del xs
    for rec in res.values():
        rec["fit"] = fit_line(rec["ms"])
    return res


# -------------------------------------------------------------- phase 3 --
MODES = {
    "device_put_validate": dict(mode="device_put", validate_checksum=True),
    "device_put_depth3": dict(mode="device_put", depth=3),
    # The same with the flight recorder off (obs.flight_records = 0).
    "device_put_depth3_noflight": dict(mode="device_put", depth=3),
    "pallas": dict(mode="pallas"),
}


def _config(workers: int, object_size: int, granule: int, mode: str,
            slot_bytes: int | None = None):
    from tpubench_torch.config import BenchConfig

    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = workers
    cfg.workload.read_calls_per_worker = 1
    cfg.workload.object_size = object_size
    cfg.workload.granule_bytes = granule
    if slot_bytes is not None:
        cfg.staging.slot_bytes = slot_bytes
    for k, v in MODES[mode].items():
        setattr(cfg.staging, k, v)
    if mode.endswith("_noflight"):
        cfg.obs.flight_records = 0
    return cfg


def phase_agree() -> None:
    """Small input, CPU plain path vs card kernels, through the CLI's
    read entry point: the card must give the CPU reference's answers."""
    from tpubench_torch.cli import read

    for mode in MODES:
        cfg = _config(2, 777_777, 64 * 1024, mode, slot_bytes=256 * 1024)
        cfg.workload.read_calls_per_worker = 2
        ref = read(cfg, device="cpu").extra
        got = read(cfg, device="cuda").extra
        for key in ("staged_bytes", "checksum_ok", "staging_zero_copy"):
            check(ref.get(key) == got.get(key), f"agree/{mode}: {key} "
                  f"cpu={ref.get(key)} cuda={got.get(key)}")
        if "staging" in ref:
            check(ref["staging"]["transfers"] == got["staging"]["transfers"],
                  f"agree/{mode}: transfers differ")
        check(got.get("checksum_ok", True), f"agree/{mode}: checksum failed")
        emit({"phase": "agree", "mode": mode, "staged_bytes": got["staged_bytes"],
              "checksum_ok": got.get("checksum_ok")})
    _agree_native(read)
    _agree_protocols(read)


def _agree_protocols(read) -> None:
    """HTTP/1.1 and gRPC (library mode) small, each read on the CPU and on
    the card from one server: equal bytes, transfers and verdicts."""
    from tpubench_torch.storage.fake import FakeBackend

    store = FakeBackend.prepopulated("tpubench/file_", 2, 777_777)
    with _Servers(store) as servers:
        for mode in ("http_validate", "grpc_validate"):
            cfg = _protocol_config(mode, servers, workers=2, object_size=777_777)
            cfg.workload.read_calls_per_worker = 2
            cfg.workload.granule_bytes = 64 * 1024
            cfg.staging.slot_bytes = 256 * 1024
            with GrpcModes() as modes:
                ref = read(cfg, device="cpu").extra
                got = read(cfg, device="cuda").extra
            check(modes.mode == ("library" if mode == "grpc_validate"
                                 else None), f"agree/{mode}: {modes.mode}")
            for key in ("staged_bytes", "checksum_ok", "staging_zero_copy"):
                check(ref.get(key) == got.get(key), f"agree/{mode}: {key} "
                      f"cpu={ref.get(key)} cuda={got.get(key)}")
            check(ref["staging"]["transfers"] == got["staging"]["transfers"],
                  f"agree/{mode}: transfers differ")
            check(got.get("checksum_ok") is True
                  and got["staged_bytes"] == 2 * 2 * 777_777,
                  f"agree/{mode}: checksum or bytes")
            emit({"phase": "agree", "mode": mode,
                  "staged_bytes": got["staged_bytes"],
                  "transfers": got["staging"]["transfers"],
                  "checksum_ok": got["checksum_ok"],
                  **({"grpc_mode": modes.mode} if modes.mode else {})})


def _agree_native(read) -> None:
    """The executor route, small: one loopback server, read on the CPU
    and on the card with equal bytes, transfers and checksum verdict."""
    from tpubench_torch.native.engine import NativeSourceServer, get_engine
    from tpubench_torch.storage.base import deterministic_bytes

    name, size = "tpubench/file_0", 777_777
    with NativeSourceServer(get_engine(), name,
                            deterministic_bytes(name, size)) as srv:
        cfg = _native_config(srv.endpoint, 2, "native_validate")
        cfg.workload.read_calls_per_worker = 2
        cfg.staging.slot_bytes = 256 * 1024
        ref, got = read(cfg, device="cpu"), read(cfg, device="cuda")
    for key in ("staged_bytes", "checksum_ok", "slot_bytes"):
        check(ref.extra.get(key) == got.extra.get(key),
              f"agree/native: {key} cpu={ref.extra.get(key)} "
              f"cuda={got.extra.get(key)}")
    stages = [r.summaries["stage"].count for r in (ref, got)]
    check(stages[0] == stages[1] == 2 * 2 * -(-size // (256 * 1024)),
          f"agree/native: transfers {stages}")
    check(got.extra.get("checksum_ok") is True and got.errors == ref.errors == 0,
          "agree/native: checksum or errors")
    emit({"phase": "agree", "mode": "native_validate",
          "staged_bytes": got.extra["staged_bytes"], "transfers": stages[1],
          "checksum_ok": got.extra["checksum_ok"]})


def expected_transfers(object_size: int, granule: int, slot: int,
                       reads: int = 1) -> int:
    """Slots one worker ships for ``reads`` zero-copy reads, by the
    aggregator's rule (a slot ships when full, or when less than a granule
    is left at the next acquire — the one that finds a read's end too —
    or at the final flush; a slot's fill carries over to the next read) —
    an independent count to hold the launch counters and the stagers' own
    counts against."""
    transfers = fill = 0
    for _ in range(reads):
        remaining = object_size
        while True:
            if slot - fill < granule and fill > 0:
                transfers, fill = transfers + 1, 0
            n = min(granule, slot - fill, remaining)
            if n <= 0:
                break
            remaining -= n
            fill += n
            if fill >= slot:
                transfers, fill = transfers + 1, 0
    return transfers + (fill > 0)


def populate():
    """The fake store of the deployment: one 100 MiB object per worker,
    shared by phases read and protocols."""
    from tpubench_torch.storage.fake import FakeBackend

    t0 = time.perf_counter()
    store = FakeBackend.prepopulated("tpubench/file_", WORKERS, OBJECT_SIZE)
    emit({"phase": "populate", "objects": WORKERS,
          "object_size": OBJECT_SIZE, "seconds": time.perf_counter() - t0})
    return store


def _slot(cfg) -> int:
    """The slot each stager rounds the budgeted size to: whole kernel
    blocks for the landing ring, whole lanes for the copy ring."""
    from tpubench_torch.staging.device import budgeted_slot_bytes
    from tpubench_torch.staging.land_stage import BLOCK_ROWS, LANE

    unit = BLOCK_ROWS * LANE if cfg.staging.mode == "pallas" else LANE
    return -(-budgeted_slot_bytes(cfg) // unit) * unit


def _noting(factory, made: list):
    """The sink factory, wrapped only to keep each stager the workers make
    with whether its slots were page-locked (a stager drops its slots at
    finish); its stream and transfer count are read after the run."""
    def kept(worker_id):
        stager = factory(worker_id)
        made.append((stager, all(s.is_pinned() for s in stager._slots)))
        return stager

    return kept


def _check_stagers(mode: str, made: list, workers: int = WORKERS) -> int:
    """A stager a worker (48), each on its own stream, every slot
    page-locked; returns the stream count."""
    streams = {st.stream.cuda_stream for st, _ in made}
    check(len(made) == workers and len(streams) == workers,
          f"{mode}: {len(made)} stagers on {len(streams)} streams")
    check(all(pinned for _, pinned in made),
          f"{mode}: slots not all page-locked")
    return len(streams)


class GrpcModes:
    """Notes the mode of every gRPC client built inside it, by wrapping
    ``GcsGrpcBackend.__init__`` (what it builds is unchanged). ``mode``:
    "library" or "wire", ``None`` when no gRPC client was built; clients
    of both modes in one run fail it."""

    def __enter__(self):
        from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend

        self.seen: set = set()
        init, seen = GcsGrpcBackend.__init__, self.seen

        def noting(backend, *a, **k):
            init(backend, *a, **k)
            seen.add("library" if backend._lib else "wire")

        self._saved = (GcsGrpcBackend, init)
        GcsGrpcBackend.__init__ = noting
        return self

    def __exit__(self, *exc):
        cls, init = self._saved
        cls.__init__ = init

    @property
    def mode(self):
        check(len(self.seen) <= 1, f"gRPC clients in both modes: {self.seen}")
        return next(iter(self.seen), None)


class Observed:
    """Keeps what the read workload builds for one run — its flight
    recorder, its telemetry session's ``/metrics`` text (scraped just
    before the session closes) and its metrics export session — by
    wrapping the three factories the workload calls; what they build and
    do is unchanged. Also counts the breaker's flight notes, and how many
    found an unfinished op to land on."""

    def __init__(self):
        self.flights, self.scrapes, self.exports = [], [], []
        self.breaker_notes: list[tuple] = []

    def __enter__(self):
        import threading
        import urllib.request

        import tpubench_torch.storage.tail as tail_mod
        from tpubench_torch.obs import flight
        from tpubench_torch.workloads import read as read_mod

        self._saved = [
            (read_mod, n, getattr(read_mod, n)) for n in (
                "flight_from_config", "telemetry_from_config",
                "metrics_session_from_config",
            )
        ] + [(tail_mod, "_flight_annotate", tail_mod._flight_annotate)]
        make_flight, make_tel, make_export, annotate = (
            f for _, _, f in self._saved
        )
        lock = threading.Lock()

        def kept_flight(cfg):
            rec = make_flight(cfg)
            self.flights.append(rec)
            return rec

        def kept_telemetry(cfg):
            sess = make_tel(cfg)
            if sess is None:
                return None
            close = sess.close

            def scraped_close(final_extra=None):
                try:
                    if sess.port is not None:
                        with urllib.request.urlopen(
                            f"http://127.0.0.1:{sess.port}/metrics", timeout=30
                        ) as r:
                            self.scrapes.append(r.read().decode())
                finally:
                    summary = close(final_extra)
                return summary

            sess.close = scraped_close
            return sess

        def kept_export(cfg, metrics, bytes_fn=None):
            sess = make_export(cfg, metrics, bytes_fn=bytes_fn)
            self.exports.append(sess)
            return sess

        def counted(kind, **info):
            if kind == "breaker":
                op = flight.current_op()
                landed = op is not None and not op._done
                with lock:
                    self.breaker_notes.append(
                        (info.get("state") or info.get("event"), landed)
                    )
            annotate(kind, **info)

        read_mod.flight_from_config = kept_flight
        read_mod.telemetry_from_config = kept_telemetry
        read_mod.metrics_session_from_config = kept_export
        tail_mod._flight_annotate = counted
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def check_flight(tag: str, res, obs: Observed, reads: int, transfers: int,
                 pallas: bool) -> dict:
    """The flight recorder's view of a run: one read record per read; one
    stage record per transfer in a copy ring (their bytes summing to the
    staged bytes) and none in the landing-kernel ring, as in
    ``tpubench``; ``stage_submit <= stage_complete == hbm_staged`` on each
    stage record. Returns the counts."""
    summary = res.extra.get("flight")
    check(summary is not None and len(obs.flights) == 1
          and obs.flights[0] is not None, f"{tag}: no flight recorder")
    recs = obs.flights[0].records()
    check(summary["records"] == len(recs), f"{tag}: summary vs records")
    stage = [r for r in recs if r["kind"] == "stage"]
    n_reads = sum(1 for r in recs if r["kind"] == "read")
    check(n_reads == reads, f"{tag}: {n_reads} read records, want {reads}")
    want = 0 if pallas else transfers
    check(len(stage) == want, f"{tag}: {len(stage)} stage records, want {want}")
    if not pallas:
        got = sum(r["bytes"] for r in stage)
        check(got == res.extra["staged_bytes"],
              f"{tag}: stage records carry {got} B")
    for r in stage:
        ph = r["phases"]
        check(ph["stage_submit"] <= ph["stage_complete"] == ph["hbm_staged"],
              f"{tag}: stage phases out of order {ph}")
    return {"read_records": n_reads, "stage_records": len(stage),
            "stage_complete_p50_ms": summary["phases"].get(
                "stage_complete", {}).get("p50_ms")}


def _read_mode(backend, mode: str, smi) -> tuple[dict, dict]:
    """One mode of phase read, checked; returns the launch counts and the
    mode's line."""
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    cfg = _config(WORKERS, OBJECT_SIZE, GRANULE, mode)
    stagers = []
    kept = _noting(make_sink_factory(cfg, device="cuda"), stagers)
    with Observed() as obs:
        landing.reset_launches()
        res = run_read(cfg, backend=backend, device="cuda", sink_factory=kept)
        counts = {"land": landing.land.launches,
                  "checksum": landing.checksum.launches}
    streams = _check_stagers(mode, stagers)
    ex = res.extra
    stats = ex.get("staging") or {}
    slot = _slot(cfg)
    transfers = WORKERS * expected_transfers(OBJECT_SIZE, GRANULE, slot)
    if "transfers" in stats:
        check(stats["transfers"] == transfers,
              f"{mode}: {stats['transfers']} transfers, want {transfers}")
    check(res.errors == 0, f"{mode}: {res.errors} errors")
    check(ex.get("staged_bytes") == WORKERS * OBJECT_SIZE,
          f"{mode}: staged {ex.get('staged_bytes')}")
    check(ex.get("staging_zero_copy") is True, f"{mode}: not zero-copy")
    want = {"land": 0, "checksum": 0}
    if mode == "pallas":
        check(ex.get("checksum_ok") is True, "pallas: checksum mismatch")
        want["land"] = transfers
    elif mode == "device_put_validate":
        check(ex.get("checksum_ok") is True, "validate: checksum mismatch")
        want["checksum"] = transfers
    check(counts == want, f"{mode}: launches {counts}, want {want}")
    check(transfers > 0, f"{mode}: no transfers")
    if mode.endswith("_noflight"):
        check("flight" not in ex and obs.flights == [None],
              f"{mode}: the flight recorder ran")
        flight = {"read_records": 0, "stage_records": 0}
    else:
        flight = check_flight(f"read/{mode}", res, obs, WORKERS, transfers,
                              pallas=mode == "pallas")
    fb = res.summaries.get("first_byte")
    line = {
        "phase": "read", "mode": mode, "workers": WORKERS,
        "object_size": OBJECT_SIZE, "staged_bytes": ex["staged_bytes"],
        "transfers": transfers, "launches": counts, "streams": streams,
        "checksum_ok": ex.get("checksum_ok"),
        "wall_s": res.wall_seconds,
        "staged_gbps_per_chip": ex["staged_gbps_per_chip"],
        "first_byte_p50_ms": fb.p50_ms if fb else None,
        "first_byte_p99_ms": fb.p99_ms if fb else None,
        "staging_efficiency": stats.get("staging_efficiency"),
        "transfer_wait_s": ex["staging_breakdown"]["transfer_wait_s"],
        "slot_bytes": slot, "flight": flight, "card": smi,
    }
    return counts, line


def phase_read(backend, smi) -> dict:
    """Each staging mode once, then the recorder's cost: depth 3 with and
    without the flight recorder, two more runs each in the reverse order
    (so the pair runs A B B A A B), all checked."""
    launches = {}
    keys = ("staged_gbps_per_chip", "first_byte_p50_ms", "first_byte_p99_ms")
    pair = ("device_put_depth3", "device_put_depth3_noflight")
    samples = {m: {k: [] for k in keys} for m in pair}
    for mode in MODES:
        counts, line = _read_mode(backend, mode, smi)
        emit(line)
        launches[f"read/{mode}"] = counts
        if mode in samples:
            for k in keys:
                samples[mode][k].append(line[k])
    for mode in pair[::-1] * 2:
        _, line = _read_mode(backend, mode, smi)
        for k in keys:
            samples[mode][k].append(line[k])
    med = {m: {k: sorted(v)[len(v) // 2] for k, v in samples[m].items()}
           for m in pair}
    emit({"phase": "flight_cost", "samples": samples, "median": med,
          "flight_over_noflight": med[pair[0]]["staged_gbps_per_chip"]
          / med[pair[1]]["staged_gbps_per_chip"], "card": smi})
    return launches


# -------------------------------------------------------------- phase 5 --
NATIVE_MODES = {
    "native_validate": dict(mode="device_put", validate_checksum=True),
    "native_depth3": dict(mode="device_put", depth=3),
    "native_fetch_only": dict(mode="none"),
}


def _native_config(endpoint: str, workers: int, mode: str):
    from tpubench_torch.config import BenchConfig

    cfg = BenchConfig()
    cfg.transport.protocol = "http"
    cfg.transport.endpoint = endpoint
    cfg.workload.bucket = "testbucket"
    cfg.workload.object_name_prefix = "tpubench/file_"
    cfg.workload.workers = workers
    cfg.workload.read_calls_per_worker = 1
    cfg.workload.fetch_executor = "native"
    for k, v in NATIVE_MODES[mode].items():
        setattr(cfg.staging, k, v)
    return cfg


def phase_native() -> dict:
    """The main path on the C++ fetch executor, at the deployment size."""
    from tpubench_torch.cli import read
    from tpubench_torch.config import MB
    from tpubench_torch.kernels import landing
    from tpubench_torch.native import build as native_build
    from tpubench_torch.native.engine import NativeSourceServer, get_engine
    from tpubench_torch.storage.base import deterministic_bytes
    from tpubench_torch.workloads import fetch_executor

    t0 = time.perf_counter()
    engine = get_engine()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    body = deterministic_bytes("tpubench/file_0", OBJECT_SIZE)
    emit({"phase": "native_setup", "engine_load_s": build_s,
          "library": native_build.library_path().name,
          "tls_available": engine.tls_available(),
          "body_bytes": body.nbytes, "body_s": time.perf_counter() - t0})
    # The slot the runner derives: the slot target capped by the host
    # budget over workers × depth, rounded up to whole 128-byte lanes.
    st = _native_config("", WORKERS, "native_depth3").staging
    slot = min(st.slot_bytes, st.host_budget_mb * MB // (WORKERS * st.depth))
    slot = -(-slot // st.lane) * st.lane
    ranges = -(-OBJECT_SIZE // slot)
    launches = {}
    pipes: list = []  # (pinned slots, slots, stream) of each slot ring

    class Noted(fetch_executor._SlotPipeline):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            pipes.append((sum(s.is_pinned() for s in self.slots),
                           len(self.slots), self.stream.cuda_stream))

    real = fetch_executor._SlotPipeline
    fetch_executor._SlotPipeline = Noted
    try:
        with NativeSourceServer(engine, "tpubench/file_0", body) as srv:
            for mode in NATIVE_MODES:
                cfg = _native_config(srv.endpoint, WORKERS, mode)
                pipes.clear()
                landing.reset_launches()
                res = read(cfg, device="cuda")
                counts = {"land": landing.land.launches,
                          "checksum": landing.checksum.launches}
                launches[f"native/{mode}"] = counts
                _check_native(mode, res, counts, pipes, slot, ranges)
    finally:
        fetch_executor._SlotPipeline = real
    return launches


def _check_native(mode: str, res, counts: dict, pipes: list, slot: int,
                  ranges: int) -> None:
    ex = res.extra
    staged = NATIVE_MODES[mode]["mode"] != "none"
    transfers = res.summaries["stage"].count if staged else 0
    check(res.errors == 0, f"{mode}: {res.errors} errors ({ex.get('first_error')})")
    check(res.bytes_total == WORKERS * OBJECT_SIZE, f"{mode}: {res.bytes_total} B")
    check(ex.get("executor_mode") == "reactor",
          f"{mode}: executor {ex.get('executor_mode')}")
    # tpubench's executor route has no flight hooks, so no flight block.
    check("flight" not in ex, f"{mode}: the executor route carries flight")
    check("completions_per_wake" in ex, f"{mode}: no completions_per_wake")
    want = {"land": 0, "checksum": 0}
    if staged:
        check(ex.get("staged_bytes") == WORKERS * OBJECT_SIZE,
              f"{mode}: staged {ex.get('staged_bytes')}")
        check(ex.get("slot_bytes") == slot, f"{mode}: slot {ex.get('slot_bytes')}")
        check(transfers == WORKERS * ranges,
              f"{mode}: {transfers} transfers, want {WORKERS * ranges}")
        check(len(pipes) == WORKERS and all(p == n for p, n, _ in pipes),
              f"{mode}: slots not all page-locked {pipes[:3]}")
        check(len({s for *_, s in pipes}) == WORKERS,
              f"{mode}: {len({s for *_, s in pipes})} streams")
    if mode == "native_validate":
        check(ex.get("checksum_ok") is True, f"{mode}: checksum mismatch")
        want["checksum"] = transfers
    check(counts == want, f"{mode}: launches {counts}, want {want}")
    fb = res.summaries.get("first_byte")
    emit({
        "phase": "native", "mode": mode, "workers": WORKERS,
        "object_size": OBJECT_SIZE, "bytes_total": res.bytes_total,
        "staged_bytes": ex.get("staged_bytes"), "transfers": transfers,
        "slot_bytes": ex.get("slot_bytes"), "launches": counts,
        "streams": len({s for *_, s in pipes}),
        "pinned_slots": sum(p for p, *_ in pipes),
        "checksum_ok": ex.get("checksum_ok"), "wall_s": res.wall_seconds,
        "gbps_per_chip": res.gbps_per_chip,
        "staged_gbps_per_chip": ex.get("staged_gbps_per_chip"),
        "first_byte_p50_ms": fb.p50_ms if fb else None,
        "first_byte_p99_ms": fb.p99_ms if fb else None,
        "executor_mode": ex["executor_mode"],
        "completions_per_wake": ex["completions_per_wake"],
        "retries": ex.get("retries"),
        "native_transport": ex.get("native_transport"),
    })



def native_h2_mode(store, smi) -> dict:
    """Phase native, mode native_h2_validate: ``read --protocol http
    --http2 --fetch-executor native --validate`` against the port's h2c
    server over phase read's store (NATIVE_H2_WORKERS workers, one read
    each): the reactor engaged, every GET an h2 stream, ``checksum_ok``,
    one ``tb_checksum`` launch per transfer."""
    from tpubench_torch.cli import read
    from tpubench_torch.kernels import landing
    from tpubench_torch.native.engine import get_engine
    from tpubench_torch.storage.fake_h2_server import FakeH2Server

    mode = "native_h2_validate"
    engine = get_engine()
    with FakeH2Server(store) as srv:
        cfg = _native_config(srv.endpoint, NATIVE_H2_WORKERS,
                             "native_validate")
        cfg.transport.http2 = True
        stats0 = engine.stats()
        landing.reset_launches()
        res = read(cfg, device="cuda")
        counts = {"land": landing.land.launches,
                  "checksum": landing.checksum.launches}
    ex = res.extra
    delta = ex.get("native_transport", {})
    transfers = res.summaries["stage"].count
    want_bytes = NATIVE_H2_WORKERS * OBJECT_SIZE
    check(res.errors == 0, f"{mode}: {res.errors} errors ({ex.get('first_error')})")
    check(res.bytes_total == ex.get("staged_bytes") == want_bytes,
          f"{mode}: {res.bytes_total} B, staged {ex.get('staged_bytes')}")
    check(ex.get("executor_mode") == "reactor",
          f"{mode}: executor {ex.get('executor_mode')}")
    check(ex.get("checksum_ok") is True, f"{mode}: checksum mismatch")
    check(counts == {"land": 0, "checksum": transfers},
          f"{mode}: launches {counts} for {transfers} transfers")
    check(delta.get("reactor_h2_streams", 0) >= transfers
          and delta.get("h2_streams_opened", 0) >= transfers,
          f"{mode}: h2 streams {delta} for {transfers} transfers")
    fb = res.summaries.get("first_byte")
    emit({
        "phase": "native", "mode": mode, "workers": NATIVE_H2_WORKERS,
        "object_size": OBJECT_SIZE, "bytes_total": res.bytes_total,
        "staged_bytes": ex.get("staged_bytes"), "transfers": transfers,
        "slot_bytes": ex.get("slot_bytes"), "launches": counts,
        "checksum_ok": ex.get("checksum_ok"), "wall_s": res.wall_seconds,
        "gbps_per_chip": res.gbps_per_chip,
        "staged_gbps_per_chip": ex.get("staged_gbps_per_chip"),
        "first_byte_p50_ms": fb.p50_ms if fb else None,
        "first_byte_p99_ms": fb.p99_ms if fb else None,
        "executor_mode": ex["executor_mode"],
        "reactor_h2_streams": delta.get("reactor_h2_streams"),
        "h2_streams_opened": delta.get("h2_streams_opened"),
        "native_transport": delta,
        "reduced": [f"{NATIVE_H2_WORKERS} workers of one read (the port's "
                    "Python h2c server moves 0.2-0.5 GB/s)"],
        "card": smi,
    })
    return {f"native/{mode}": counts}


# -------------------------------------------------------------- phase 6 --
class _Servers:
    """The port's HTTP/1.1, HTTP/2, gRPC wire and grpcio fakes over one
    store, started together and stopped on exit (a server that fails to
    start raises; without grpcio the grpcio fake does not import)."""

    def __init__(self, store):
        from tpubench_torch.storage.fake_grpc_wire_server import (
            FakeGrpcWireServer,
        )
        from tpubench_torch.storage.fake_h2_server import FakeH2Server
        from tpubench_torch.storage.fake_server import FakeGcsServer

        from tpubench_torch.storage.fake_grpc_server import FakeGcsGrpcServer

        self.by_kind = {"h1": FakeGcsServer(store), "h2": FakeH2Server(store),
                        "grpc": FakeGrpcWireServer(store),
                        "grpcio": FakeGcsGrpcServer(store)}
        self.local_dir = ""

    def __enter__(self):
        for srv in self.by_kind.values():
            srv.start()
        return self

    def __exit__(self, *exc):
        for srv in self.by_kind.values():
            srv.stop()


def _protocol_config(mode: str, servers, workers: int = 0,
                     object_size: int = 0):
    """The mode's config at the deployment size (or ``workers`` x
    ``object_size``). Retries are bounded by a 60 s deadline, so a fault
    that never clears fails the run instead of hanging it."""
    from tpubench_torch.config import BenchConfig

    protocol, kind, switches, staging = PROTOCOL_MODES[mode]
    cfg = BenchConfig()
    t, w = cfg.transport, cfg.workload
    t.protocol = protocol
    t.directpath = False  # the gRPC fake is no Google endpoint
    if kind is not None:
        t.endpoint = servers.by_kind[kind].endpoint
    for k, v in switches.items():
        setattr(t, k, v)
    t.retry.deadline_s = 60.0
    if mode == "http_retry_validate":
        t.retry.initial_backoff_s = 0.001
        t.retry.max_backoff_s = 0.01
        t.retry.jitter = False
    w.bucket = "testbucket"
    w.object_name_prefix = "tpubench/file_"
    w.dir = servers.local_dir
    w.workers = workers or (WIRE_WORKERS if mode == "grpc_wire_validate"
                            else WORKERS)
    w.read_calls_per_worker = 1
    w.object_size = object_size or OBJECT_SIZE
    w.granule_bytes = GRANULE
    if staging == "pallas":
        cfg.staging.mode = "pallas"
    else:
        cfg.staging.validate_checksum = True
    return cfg


def _write_local(store, root: str) -> float:
    """The store's objects as files under ``root``; returns the seconds."""
    import os

    t0 = time.perf_counter()
    for i in range(WORKERS):
        name = f"tpubench/file_{i}"
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        store._objects[name].tofile(path)
    return time.perf_counter() - t0


def phase_protocols(store, smi, seed: int) -> dict:
    """The deployment through every storage client of the worker-pool
    route, driven as the CLI's ``read`` drives it (``run_read`` with
    ``make_sink_factory``), over one store behind the port's servers."""
    import shutil
    import tempfile
    from pathlib import Path

    from tpubench_torch.kernels import landing
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.storage.fake import FaultPlan
    from tpubench_torch.workloads.read import run_read

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    launches = {}
    with _Servers(store) as servers:
        servers.local_dir = tempfile.mkdtemp(prefix="protocols-", dir=build)
        try:
            emit({"phase": "protocols_setup",
                  "endpoints": {k: v.endpoint for k, v in servers.by_kind.items()},
                  "local_write_s": _write_local(store, servers.local_dir)})
            for mode in PROTOCOL_MODES:
                cfg = _protocol_config(mode, servers)
                if mode == "http_retry_validate":
                    store.fault = FaultPlan(**RETRY_FAULT, seed=seed)
                    store._rng = store.fault.rng()
                store.open_count = store.injected_errors = 0
                stagers = []
                kept = _noting(make_sink_factory(cfg, device="cuda"), stagers)
                with GrpcModes() as modes, \
                        _protocol_backend(mode, cfg) as backend, \
                        Observed() as obs:
                    landing.reset_launches()
                    try:
                        res = run_read(cfg, device="cuda", sink_factory=kept,
                                       backend=backend)
                    finally:
                        store.fault = FaultPlan()
                        store._rng = store.fault.rng()
                    counts = {"land": landing.land.launches,
                              "checksum": landing.checksum.launches}
                launches[f"protocols/{mode}"] = counts
                _check_protocol(mode, cfg, res, counts, stagers, store, smi,
                                obs, modes.mode)
        finally:
            shutil.rmtree(servers.local_dir, ignore_errors=True)
    return launches


@contextlib.contextmanager
def _protocol_backend(mode: str, cfg):
    """The backend ``run_read`` gets in ``mode`` (``None``: it opens its
    own). grpc_wire_validate pins wire mode, as on a machine without
    grpcio, for the run; grpc_lib gets a library-mode client on an
    explicit channel (``import grpc`` fails the run where grpcio is
    missing)."""
    from tpubench_torch.storage import gcs_grpc

    if mode == "grpc_wire_validate":
        saved, gcs_grpc._HAVE_LIB = gcs_grpc._HAVE_LIB, False
        try:
            yield None
        finally:
            gcs_grpc._HAVE_LIB = saved
    elif mode == "grpc_lib":
        import grpc

        from tpubench_torch.storage.retrying import RetryingBackend

        t = cfg.transport
        ch = grpc.insecure_channel(t.endpoint.removeprefix("insecure://"))
        try:
            grpc.channel_ready_future(ch).result(timeout=30)
            backend = RetryingBackend(gcs_grpc.GcsGrpcBackend(
                cfg.workload.bucket, t, channel=ch), t.retry)
            try:
                yield backend
            finally:
                backend.close()
        finally:
            ch.close()
    else:
        yield None


def _check_protocol(mode: str, cfg, res, counts: dict, stagers: list,
                    store, smi, obs: Observed, grpc_mode) -> None:
    ex = res.extra
    workers = cfg.workload.workers
    transfers = sum(st.transfers for st, _ in stagers)
    expected = workers * expected_transfers(OBJECT_SIZE, GRANULE, _slot(cfg))
    check(res.errors == 0, f"{mode}: {res.errors} errors")
    check(ex.get("checksum_ok") is True, f"{mode}: checksum mismatch")
    check(ex.get("staged_bytes") == workers * OBJECT_SIZE,
          f"{mode}: staged {ex.get('staged_bytes')}")
    check(ex.get("staging_zero_copy") is True, f"{mode}: not zero-copy")
    if cfg.transport.protocol == "grpc":
        want_mode = "wire" if mode == "grpc_wire_validate" else "library"
        check(grpc_mode == want_mode,
              f"{mode}: gRPC clients in {grpc_mode} mode, want {want_mode}")
    streams = _check_stagers(mode, stagers, workers)
    kernel = "land" if cfg.staging.mode == "pallas" else "checksum"
    want = {"land": 0, "checksum": 0, kernel: transfers}
    check(counts == want and transfers, f"{mode}: launches {counts}, want {want}")
    if mode == "http_retry_validate":
        check(store.injected_errors > 0 and store.open_count > WORKERS,
              f"{mode}: no resume ({store.injected_errors} injected, "
              f"{store.open_count} opens)")
    else:
        check(transfers == expected,
              f"{mode}: {transfers} transfers, want {expected}")
    flight = check_flight(f"protocols/{mode}", res, obs, workers, transfers,
                          pallas=cfg.staging.mode == "pallas")
    conn = ex.get("native_conn_stats")
    if mode == "http_native_validate":
        check(conn is not None and conn["connects"] <= WORKERS
              and conn["reuses"] >= 0, f"{mode}: connections {conn}")
    fb = res.summaries.get("first_byte")
    line = {
        "phase": "protocols", "mode": mode, "workers": workers,
        "object_size": OBJECT_SIZE, "staged_bytes": ex["staged_bytes"],
        "transfers": transfers, "expected_transfers": expected,
        "launches": counts, "streams": streams,
        "checksum_ok": ex["checksum_ok"], "wall_s": res.wall_seconds,
        "staged_gbps_per_chip": ex["staged_gbps_per_chip"],
        "first_byte_p50_ms": fb.p50_ms if fb else None,
        "first_byte_p99_ms": fb.p99_ms if fb else None,
        "transfer_wait_s": ex["staging_breakdown"]["transfer_wait_s"],
        "slot_bytes": _slot(cfg), "staging_zero_copy": ex["staging_zero_copy"],
        "native_conn_stats": conn,
        "native_transport": {k: v for k, v in
                             (ex.get("native_transport") or {}).items() if v},
        "opens": store.open_count, "injected_errors": store.injected_errors,
        "flight": flight, "card": smi,
    }
    if grpc_mode is not None:
        line["grpc_mode"] = grpc_mode
    if workers != WORKERS:
        line["reduced"] = [f"{workers} of {WORKERS} workers (the wire "
                           "client, the path of a machine without grpcio, "
                           "read only to hold that path)"]
    emit(line)


# -------------------------------------------------------------- phase 7 --
def _metrics(text: str) -> dict:
    """Prometheus exposition text -> {sample name: value}."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            out[key] = float(val)
    return out


def _counted_tracer(cfg):
    """The tracer ``make_tracer(cfg)`` builds, with a span store this
    script can count: with the OTel SDK, an ``OtelTracer`` exporting into
    an in-memory exporter (``make_tracer``'s has no processor when no
    exporter is named); without it, the ``RecordingTracer`` it falls back
    to. Returns ``(tracer, span_names)``."""
    from tpubench_torch.obs.tracing import OtelTracer, RecordingTracer

    try:
        from opentelemetry.sdk.trace.export import SimpleSpanProcessor
        from opentelemetry.sdk.trace.export.in_memory_span_exporter import (
            InMemorySpanExporter,
        )
    except ImportError:
        tracer = RecordingTracer(sample_rate=cfg.obs.trace_sample_rate)
        return tracer, lambda: [sp.name for sp in tracer.spans]
    spans = InMemorySpanExporter()
    tracer = OtelTracer(
        sample_rate=cfg.obs.trace_sample_rate, service_name="tpubench",
        transport=cfg.transport.protocol,
        span_processor=SimpleSpanProcessor(spans),
    )
    return tracer, lambda: [sp.name for sp in spans.get_finished_spans()]


def phase_obs(store, smi) -> dict:
    """Phase read's deployment with the whole obs plane on: tracing (the
    tracer ``make_tracer`` builds: OTel where its SDK is installed, else
    the in-process recorder; see ``_counted_tracer``), telemetry on an
    ephemeral loopback port with OTLP dry-run export,
    ``obs.export='cloud'`` dry-run, and the flight journal under
    ``build/`` (removed after)."""
    import shutil
    import tempfile
    from pathlib import Path

    from tpubench_torch.kernels import landing
    from tpubench_torch.obs.flight import load_journals
    from tpubench_torch.obs.tracing import make_tracer
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="obs-", dir=build)
    launches = {}
    try:
        for mode in OBS_MODES:
            pallas = mode == "obs_pallas"
            cfg = _config(WORKERS, OBJECT_SIZE, GRANULE,
                          "pallas" if pallas else "device_put_validate")
            cfg.obs.enable_tracing = True
            cfg.obs.export = "cloud"  # export_dry_run stays True
            cfg.obs.flight_journal = str(Path(root) / f"{mode}.json")
            cfg.telemetry.port = 0
            cfg.telemetry.otlp = True
            tracer, span_names = _counted_tracer(cfg)
            made = type(make_tracer(cfg)).__name__
            check(type(tracer).__name__ == made,
                  f"{mode}: make_tracer gives {made}, not {type(tracer).__name__}")
            stagers = []
            kept = _noting(make_sink_factory(cfg, device="cuda"), stagers)
            with Observed() as obs:
                landing.reset_launches()
                try:
                    res = run_read(cfg, backend=store, device="cuda",
                                   tracer=tracer, sink_factory=kept)
                finally:
                    tracer.shutdown()
                counts = {"land": landing.land.launches,
                          "checksum": landing.checksum.launches}
            launches[f"obs/{mode}"] = counts
            ex = res.extra
            transfers = sum(st.transfers for st, _ in stagers)
            expected = WORKERS * expected_transfers(OBJECT_SIZE, GRANULE,
                                                    _slot(cfg))
            kernel = "land" if pallas else "checksum"
            check(res.errors == 0 and ex.get("checksum_ok") is True,
                  f"{mode}: errors {res.errors}, checksum {ex.get('checksum_ok')}")
            check(transfers == expected and counts == {
                "land": 0, "checksum": 0, kernel: transfers},
                f"{mode}: {transfers} transfers (want {expected}), {counts}")
            check(ex.get("staged_bytes") == WORKERS * OBJECT_SIZE,
                  f"{mode}: staged {ex.get('staged_bytes')}")
            streams = _check_stagers(mode, stagers)
            flight = check_flight(f"obs/{mode}", res, obs, WORKERS, transfers,
                                  pallas=pallas)
            # /metrics, scraped as the session closed, against the result.
            check(len(obs.scrapes) == 1, f"{mode}: {len(obs.scrapes)} scrapes")
            m = _metrics(obs.scrapes[0])
            want = {
                "tpubench_reads_total": WORKERS,
                "tpubench_bytes_total": res.bytes_total,
                "tpubench_stage_transfers_total": 0 if pallas else transfers,
                "tpubench_stage_bytes_total":
                    0 if pallas else ex["staged_bytes"],
            }
            got = {k: m.get(k) for k in want}
            check(got == want, f"{mode}: /metrics {got}, want {want}")
            spans = span_names()
            check(spans.count("ReadObject") == WORKERS,
                  f"{mode}: {spans.count('ReadObject')} ReadObject spans")
            journal = load_journals([ex["flight_journal"]])[0]
            check(len(journal["records"]) == ex["flight"]["records"],
                  f"{mode}: journal holds {len(journal['records'])} records")
            # Dry-run exports: metric points under obs.metric_prefix, and
            # the telemetry's OTLP metric and span payloads.
            prefix = cfg.obs.metric_prefix.rstrip("/")
            check(len(obs.exports) == 1 and obs.exports[0] is not None,
                  f"{mode}: no metrics export session")
            points = obs.exports[0].exporter.exported
            check(points and all(p["type"].startswith(prefix + "/")
                                 for p in points),
                  f"{mode}: cloud dry-run payloads {len(points)}")
            otlp = ex["telemetry"]["otlp"]
            check(otlp["payloads"] >= 1 and otlp["traces"]["spans"] > 0,
                  f"{mode}: OTLP dry-run {otlp}")
            fb = res.summaries.get("first_byte")
            emit({
                "phase": "obs", "mode": mode, "workers": WORKERS,
                "object_size": OBJECT_SIZE, "staged_bytes": ex["staged_bytes"],
                "transfers": transfers, "expected_transfers": expected,
                "launches": counts, "streams": streams,
                "checksum_ok": ex["checksum_ok"], "wall_s": res.wall_seconds,
                "staged_gbps_per_chip": ex["staged_gbps_per_chip"],
                "first_byte_p50_ms": fb.p50_ms if fb else None,
                "first_byte_p99_ms": fb.p99_ms if fb else None,
                "flight": flight, "metrics": got,
                "tracer": type(tracer).__name__, "spans": len(spans),
                "read_spans": spans.count("ReadObject"),
                "journal_records": len(journal["records"]),
                "cloud_points": len(points), "otlp_payloads": otlp["payloads"],
                "otlp_spans": otlp["traces"]["spans"],
                "telemetry_ticks": ex["telemetry"]["ticks"], "card": smi,
            })
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# -------------------------------------------------------------- phase 8 --
def phase_tail(smi, seed: int) -> dict:
    """The deployment through ``open_backend`` with hedging, the stall
    watchdog and the circuit breaker on, over a fresh fake store whose
    seeded ``TAIL_FAULT`` plan makes each layer act: every read hedges,
    some readers stall mid-body, some opens fail. Retries (1-100 ms
    backoff, no jitter) are bounded by a 60 s deadline."""
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.storage import base_backend, open_backend
    from tpubench_torch.workloads.read import run_read

    launches = {}
    for mode in TAIL_MODES:
        pallas = mode == "tail_pallas"
        cfg = _config(WORKERS, OBJECT_SIZE, GRANULE,
                      "pallas" if pallas else "device_put_validate")
        t = cfg.transport
        for k, v in TAIL.items():
            setattr(t.tail, k, v)
        for k, v in TAIL_FAULT.items():
            setattr(t.fault, k, v)
        t.fault.seed = seed
        t.retry.initial_backoff_s = 0.001
        t.retry.max_backoff_s = 0.1
        t.retry.jitter = False
        t.retry.deadline_s = 60.0
        t0 = time.perf_counter()
        backend = open_backend(cfg)
        store = base_backend(backend)
        setup_s = time.perf_counter() - t0
        stagers = []
        kept = _noting(make_sink_factory(cfg, device="cuda"), stagers)
        try:
            with Observed() as obs:
                landing.reset_launches()
                res = run_read(cfg, backend=backend, device="cuda",
                               sink_factory=kept)
                counts = {"land": landing.land.launches,
                          "checksum": landing.checksum.launches}
        finally:
            backend.close()
        launches[f"tail/{mode}"] = counts
        ex = res.extra
        transfers = sum(st.transfers for st, _ in stagers)
        kernel = "land" if pallas else "checksum"
        check(res.errors == 0 and ex.get("checksum_ok") is True,
              f"{mode}: errors {res.errors}, checksum {ex.get('checksum_ok')}")
        check(ex.get("staged_bytes") == WORKERS * OBJECT_SIZE,
              f"{mode}: staged {ex.get('staged_bytes')}")
        check(transfers > 0 and counts == {
            "land": 0, "checksum": 0, kernel: transfers},
            f"{mode}: launches {counts}, transfers {transfers}")
        streams = _check_stagers(mode, stagers)
        flight = check_flight(f"tail/{mode}", res, obs, WORKERS, transfers,
                              pallas=pallas)
        tail = ex["tail"]
        notes = obs.breaker_notes
        emitted = {s: sum(1 for n, _ in notes if n == s)
                   for s in ("open", "half_open", "closed", "shed")}
        landed = sum(1 for _, ok in notes if ok)
        check(tail["hedge"]["hedges"] > 0, f"{mode}: no hedge {tail}")
        check(tail["watchdog"]["stalls"] > 0, f"{mode}: no stall {tail}")
        check(tail["breaker"]["opens"] > 0 and emitted["closed"] > 0
              and tail["breaker"]["opens"] == emitted["open"],
              f"{mode}: breaker never went open -> closed {tail['breaker']} "
              f"{emitted}")
        ft = ex["flight"]["tail"]
        check(ft["hedges"] == tail["hedge"]["hedges"]
              and ft["stalls"] == tail["watchdog"]["stalls"]
              and ft["breaker_events"] == landed,
              f"{mode}: flight {ft} vs counters {tail}, {landed} breaker "
              "notes with an op to land on")
        fb = res.summaries.get("first_byte")
        line = {
            "phase": "tail", "mode": mode, "workers": WORKERS,
            "object_size": OBJECT_SIZE, "staged_bytes": ex["staged_bytes"],
            "transfers": transfers, "launches": counts, "streams": streams,
            "checksum_ok": ex["checksum_ok"], "wall_s": res.wall_seconds,
            "staged_gbps_per_chip": ex["staged_gbps_per_chip"],
            "first_byte_p50_ms": fb.p50_ms if fb else None,
            "first_byte_p99_ms": fb.p99_ms if fb else None,
            "tail": tail, "flight_tail": ft, "breaker_notes": emitted,
            "breaker_notes_landed": landed, "flight": flight,
            "opens": store.open_count, "injected_errors": store.injected_errors,
            "store_setup_s": setup_s,
            "staging_zero_copy": ex["staging_zero_copy"], "card": smi,
        }
        if res.wall_seconds > 60:
            line["reduced"] = [f"{mode}: wall {res.wall_seconds:.1f} s > 60 s"]
        emit(line)
    return launches


# -------------------------------------------------------------- phase 9 --
def _cli(argv: list):
    """``(args, cfg)`` as the CLI parses and folds ``argv``."""
    from tpubench_torch import cli

    args = cli.build_parser().parse_args(
        [*argv, "--results-dir", f"{BUILD}/results"])
    return args, cli.build_config(args)


class PodObserved:
    """Keeps what pod-ingest builds for one run — its flight recorder, and
    for every call of its collective the group's backend, the gathered
    tensor's device and the checksum — by wrapping the workload's
    factories; what they build and do is unchanged."""

    def __init__(self):
        self.flights, self.calls = [], []

    def __enter__(self):
        import torch.distributed as dist

        from tpubench_torch.workloads import pod_ingest

        names = ("flight_from_config", "make_reassemble", "make_ring_reassemble")
        self._saved = [(n, getattr(pod_ingest, n)) for n in names]
        make_flight, gather, ring = (f for _, f in self._saved)

        def kept_flight(cfg):
            rec = make_flight(cfg)
            self.flights.append(rec)
            return rec

        def watched(make):
            def build(pod):
                fn = make(pod)

                def call(staged):
                    gathered, csum = fn(staged)
                    self.calls.append((dist.get_backend(pod.group),
                                       gathered.device.type, int(csum)))
                    return gathered, csum

                return call

            return build

        pod_ingest.flight_from_config = kept_flight
        pod_ingest.make_reassemble = watched(gather)
        pod_ingest.make_ring_reassemble = watched(ring)
        return self

    def __exit__(self, *exc):
        from tpubench_torch.workloads import pod_ingest

        for name, fn in self._saved:
            setattr(pod_ingest, name, fn)


def phase_pod(smi) -> tuple[dict, object]:
    """``pod-ingest`` through ``cli.execute`` (the
    one-rank NCCL group it brings up, the run, the group torn down) over a
    fake store holding one 1 GiB object, in modes all_gather and ring
    (the store read directly, a fetch thread per shard) and http2_mux and
    grpc_native_mux (the store behind the port's h2c and wire-gRPC
    servers, the shard fetched as one multiplexed batch on one
    connection): verified, the device checksum equal to the host's byte
    sum mod 2³², NCCL as the group's backend, the gather on the card, one
    ``tb_checksum`` launch per shard per collective call (warm-up
    included), and the pod's flight record staged and gathered. Returns
    the launch counts and the store (phase profile reads it again)."""
    import numpy as np

    from tpubench_torch.storage.fake import FakeBackend

    t0 = time.perf_counter()
    store = FakeBackend.prepopulated("tpubench/file_", 1, POD_OBJECT)
    host_sum = int(store._objects["tpubench/file_0"].sum(dtype=np.uint64)) % MOD
    emit({"phase": "pod_setup", "object_size": POD_OBJECT,
          "shard_rows": POD_OBJECT // 128, "lane": 128,
          "populate_s": time.perf_counter() - t0})
    launches = {}
    with _Servers(store) as servers:
        for mode, flags in POD_MODES.items():
            launches[f"pod/{mode}"] = _pod_mode(
                mode, flags, store, servers, host_sum, smi)
    return launches, store


def _pod_mode(mode: str, flags: list, store, servers, host_sum: int,
              smi) -> dict:
    """One mode of phase pod, checked; returns its launch counts. A mux
    mode reads through the client of its flags (retry layer included)
    from the server of its kind, and must fetch the rank's shard as one
    ``read_ranges`` batch of MUX_RANGES_PER_RANK ranges on one
    connection."""
    import torch.distributed as dist

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage import base_backend, open_backend
    from tpubench_torch.workloads.pod_ingest import MUX_RANGES_PER_RANK

    mux = mode.endswith("_mux")
    t0 = time.perf_counter()
    if mux:
        kind = "h2" if "--http2" in flags else "grpc"
        args, cfg = _cli(["pod-ingest", *flags, "--endpoint",
                          servers.by_kind[kind].endpoint, "--bucket",
                          "testbucket", "--object-name-prefix",
                          "tpubench/file_"])
        cfg.transport.directpath = False  # the gRPC fake is no Google endpoint
        backend = open_backend(cfg)
        inner = base_backend(backend)
        batches, real = [], inner.read_ranges
        inner.read_ranges = lambda name, r, b: batches.append(len(r)) or real(
            name, r, b)
    else:
        args, cfg = _cli(["pod-ingest", "--protocol", "fake", "--workers",
                          "1", "--object-size", str(POD_OBJECT), *flags])
        backend = store
    try:
        with PodObserved() as obs:
            landing.reset_launches()
            res = cli.execute("pod-ingest", cfg, device="cuda",
                              backend=backend, args=args)
            counts = {"land": landing.land.launches,
                      "checksum": landing.checksum.launches}
        conn = None
        if mux:
            pool = (inner._h2_pool() if kind == "h2"
                    else inner._native_pool())
            conn = dict(pool.stats)
    finally:
        if mux:
            backend.close()
    ex = res.extra
    want_mode = "ring" if "--ring" in flags else "all_gather"
    check(not dist.is_initialized(), f"pod/{mode}: the group outlived the run")
    check(res.errors == 0 and ex["verified"] is True,
          f"pod/{mode}: errors {res.errors}, verified {ex['verified']}")
    check(ex["mode"] == want_mode and res.bytes_total == POD_OBJECT,
          f"pod/{mode}: {ex['mode']}, {res.bytes_total} B")
    if mux:
        # h2: the stat and the one batch share one pooled connection;
        # gRPC stats over its grpcio channel, so its pool sees the batch.
        acquires = 2 if kind == "h2" else 1
        check(batches == [MUX_RANGES_PER_RANK] and conn["connects"] == 1
              and conn["connects"] + conn["reuses"] == acquires,
              f"pod/{mode}: batches {batches}, connections {conn}")
    grpc_mode = None
    if mux and kind == "grpc":
        grpc_mode = "library" if inner._lib else "wire"
        check(grpc_mode == "library", f"pod/{mode}: gRPC in {grpc_mode} mode")
    check(len(obs.calls) == 2, f"pod/{mode}: {len(obs.calls)} collective calls")
    check(all(b == "nccl" for b, _, _ in obs.calls),
          f"pod/{mode}: backends {obs.calls}")
    check(all(d == "cuda" for _, d, _ in obs.calls),
          f"pod/{mode}: gathered on {obs.calls}")
    check(all(c == host_sum for _, _, c in obs.calls),
          f"pod/{mode}: device checksum {obs.calls} vs host {host_sum}")
    check(counts == {"land": 0, "checksum": len(obs.calls)},
          f"pod/{mode}: launches {counts} for {len(obs.calls)} calls")
    recs = obs.flights[0].records()
    pod_recs = [r for r in recs if r["kind"] == "object"]
    check(len(pod_recs) == 1 and {"hbm_staged", "gather_complete"}
          <= set(pod_recs[0]["phases"]),
          f"pod/{mode}: pod record {pod_recs}")
    # One record per fetch thread; the mux route, as in tpubench, none.
    check(sum(1 for r in recs if r["kind"] == "read") == (0 if mux else 1),
          f"pod/{mode}: shard records")
    emit({"phase": "pod", "mode": mode, "object_size": POD_OBJECT,
          "shard_bytes": ex["shard_bytes"], "n_chips": res.n_chips,
          "backend": obs.calls[0][0], "verified": ex["verified"],
          "checksum": obs.calls[-1][2], "host_sum": host_sum,
          "launches": counts, "native_conn_stats": conn,
          "ranges": MUX_RANGES_PER_RANK if mux else 1,
          **({"grpc_mode": grpc_mode} if grpc_mode else {}),
          **{k: ex[k] for k in (
              "fetch_seconds", "stage_seconds", "gather_seconds",
              "compile_seconds", "fetch_gbps", "stage_gbps",
              "gather_gbps", "ici_bytes_moved")},
          "wall_s": res.wall_seconds, "gbps": res.gbps,
          "seconds": time.perf_counter() - t0,
          "reduced": ["one rank (the machine has one H100): the shard is "
                      "the whole object and no byte crosses a link"],
          "card": smi})
    return counts


# ------------------------------------------------------------ pod_cards --
# Phase pod_cards: pod commands as a user types them (``cli.main``) over
# every card of the host, one rank a card (``dist/launch.py``). On one
# card, ``main`` keeps the one rank in process; on n >= 2 cards each mode
# is n NCCL ranks. Mode -> (argv, per-rank tb_checksum launches, given
# the host's card count and the rank; None: not checked per rank).
POD_CARDS_STREAM_OBJECTS = 4
POD_CARDS_TRAIN_WORKERS, POD_CARDS_TRAIN_STEPS = 16, 20
POD_CARDS_GATHER_REPS = 5
POD_CARDS_CKPT = dict(objects=16, object_bytes=128 * MIB, part_bytes=16 * MIB)


def _pod_cards_modes(cards: int, endpoints: dict, ckpt_dir: str,
                     conf: str) -> dict:
    """The modes of phase pod_cards at ``cards`` cards (the first alone on
    one card)."""
    # The fake store holds max(workers, threads) objects, as tpubench's
    # does; pod-ingest reads the first alone.
    pod = ["pod-ingest", "--protocol", "fake", "--workers", "1",
           "--threads", "1", "--object-size", str(POD_OBJECT)]
    if cards == 1:
        return {"pod_ingest": (pod, lambda r: 2)}
    remote = ["--bucket", "testbucket", "--object-name-prefix",
              "tpubench/file_"]
    sizes = [1 << k for k in range(1, cards.bit_length())
             if 1 << k <= cards]

    def gather_calls(r: int) -> int:
        return (POD_CARDS_GATHER_REPS + 1) * sum(1 for n in sizes if r < n)

    return {
        "pod_ingest": (pod, lambda r: 2),
        "ring": ([*pod, "--ring"], lambda r: 2),
        "http2_mux": (["pod-ingest", "--protocol", "http", "--http2",
                       "--endpoint", endpoints["h2"], *remote],
                      lambda r: 2),
        "grpc_native_mux": (["pod-ingest", "--config", conf, "--protocol",
                             "grpc", "--native-receive", "--endpoint",
                             endpoints["grpc"], *remote], lambda r: 2),
        "stream": (["stream", "--protocol", "fake", "--validate",
                    "--objects", str(POD_CARDS_STREAM_OBJECTS),
                    "--workers", str(POD_CARDS_STREAM_OBJECTS),
                    "--object-size", str(OBJECT_SIZE)],
                   lambda r: POD_CARDS_STREAM_OBJECTS + 1),
        "gather_bench": (["gather-bench", "--collective", "all_gather",
                          "--shard-mb", str(GATHER_SHARD_MB), "--reps",
                          str(POD_CARDS_GATHER_REPS)], gather_calls),
        "ckpt_restore": (["ckpt-restore", "--protocol", "local", "--dir",
                          ckpt_dir], lambda r: 0),
        "train_pod": (["train-ingest", "--protocol", "fake", "--workers",
                       str(POD_CARDS_TRAIN_WORKERS), "--object-size",
                       str(OBJECT_SIZE), "--granule-bytes", str(GRANULE),
                       "--chunk-bytes", str(GRANULE), "--batch-shards",
                       str(TRAIN_BATCH), "--step-compute-ms",
                       str(TRAIN_COMPUTE_MS), "--steps",
                       str(POD_CARDS_TRAIN_STEPS), "--readahead", "0",
                       "--pipeline-pod"],
                      lambda r: POD_CARDS_TRAIN_STEPS + 1),
    }


class LaunchSpy:
    """Notes every call of ``dist.launch.launch`` (the rank count ``main``
    chose) and passes it through."""

    def __enter__(self):
        from tpubench_torch.dist import launch

        self.calls: list = []
        self._real = real = launch.launch

        def noted(argv, ranks, **kw):
            self.calls.append(ranks)
            return real(argv, ranks, **kw)

        launch.launch = noted
        return self

    def __exit__(self, *exc):
        from tpubench_torch.dist import launch

        launch.launch = self._real


def _pod_run(mode: str, argv: list, cards: int, hosts: int = 1) -> dict:
    """``argv`` as a user types it on ``hosts`` hosts of ``cards / hosts``
    cards each, its results under ``build/<phase>/<mode>``: on one host
    ``cli.main(argv)`` in this process (phase pod_cards), which launches
    one NCCL rank a card; on two, one ``python -m tpubench_torch.cli``
    process a host (phase hosts: ``--num-processes 2 --process-id h``, the
    cards split by ``CUDA_VISIBLE_DEVICES`` halves), each launching one
    rank a visible card, all meeting at one loopback coordinator. Returns
    global rank 0's result, every rank's ``local_rank`` line (from the
    rank logs; none in process), the ranks ``main`` launched (one host)
    and the seconds."""
    import contextlib
    import glob
    import io
    import shutil

    from tpubench_torch import cli
    from tpubench_torch.dist.bringup import free_port
    from tpubench_torch.dist.launch import RANK_LOG_DIR, child_env, run_ranks

    phase = "pod_cards" if hosts == 1 else "hosts"
    results = f"{BUILD}/{phase}/{mode}"
    shutil.rmtree(results, ignore_errors=True)
    launched = None
    t0 = time.perf_counter()
    if hosts == 1:
        buf = io.StringIO()
        with LaunchSpy() as spy, contextlib.redirect_stdout(buf):
            rc = cli.main([*argv, "--results-dir", results])
        launched = spy.calls
        check(rc == 0, f"{phase}/{mode}: exit {rc}\n{buf.getvalue()[-3000:]}")
    else:
        local = cards // hosts
        port = free_port()
        envs = [dict(child_env(), TPUBENCH_LAUNCH_DEADLINE_S=str(
            HOSTS_DEADLINE_S), CUDA_VISIBLE_DEVICES=",".join(
                str(c) for c in range(h * local, (h + 1) * local)))
            for h in range(hosts)]
        ran = run_ranks([_hosts_argv(argv, h, port, results)
                         for h in range(hosts)],
                        [f"{results}/host{h}.log" for h in range(hosts)],
                        envs=envs, deadline_s=HOSTS_DEADLINE_S)
        check(ran.ok, f"{phase}/{mode}: host exit codes {ran.rcs}\n"
              + "\n".join(ran.tail(h, 3000) for h in range(hosts)))
    seconds = time.perf_counter() - t0
    paths = glob.glob(f"{results}/*.json")
    check(len(paths) == 1, f"{phase}/{mode}: results {paths}")
    with open(paths[0]) as f:
        res = json.load(f)
    lines = []
    for log in sorted(glob.glob(f"{results}/{RANK_LOG_DIR}/*/rank*.log")):
        with open(log) as f:
            lines += [json.loads(ln)["local_rank"] for ln in f
                      if ln.startswith('{"local_rank"')]
    lines.sort(key=lambda x: x["rank"])
    return {"res": res, "ranks": lines, "launched": launched,
            "seconds": seconds}


def _pod_check(mode: str, run: dict, cards: int, per_rank,
               hosts: int = 1) -> dict:
    """The pod's result and every rank's line, on ``hosts`` hosts of
    ``cards / hosts``: one host launched a rank a card and stamps no
    topology (``tpubench``'s one process over its chips), several stamp
    ``tpubench``'s; ``n_chips`` the card count, no error; every rank on a
    card of its own (by UUID) over NCCL, on its host's visible
    ``cuda:(rank % local)``; ``tb_checksum`` launches as the mode makes
    them (``per_rank`` None: any) and no ``tb_land``. Returns the launches
    summed over the ranks. tune's sweep result is a carrier of its cells,
    of one chip in ``tpubench`` as here."""
    tag = f"{'pod_cards' if hosts == 1 else 'hosts'}/{mode}"
    res, lines = run["res"], run["ranks"]
    local = cards // hosts
    chips = 1 if res["workload"] == "tune" else cards
    stamp = res["extra"].get("topology")
    want_stamp = None if hosts == 1 else {
        "process_index": 0, "process_count": hosts, "local_devices": local,
        "global_devices": cards}
    if hosts == 1:
        check(run["launched"] == [cards],
              f"{tag}: main launched {run['launched']}, {cards} cards")
    check(res["n_chips"] == chips and res["errors"] == 0
          and stamp == want_stamp,
          f"{tag}: n_chips {res['n_chips']}, errors {res['errors']}, "
          f"topology {stamp}")
    check([x["rank"] for x in lines] == list(range(cards))
          and len({x["card"] for x in lines}) == cards,
          f"{tag}: rank lines {lines}")
    for x in lines:
        r = x["rank"]
        check(x["backend"] == "nccl" and x["device"] == f"cuda:{r % local}"
              and x["host"] == r // local and x["hosts"] == hosts
              and x["ranks"] == cards and x["n_chips"] == chips
              and x["errors"] == 0 and x["launches"]["land"] == 0,
              f"{tag}: rank {x}")
        if per_rank is not None:
            check(x["launches"]["checksum"] == per_rank(r),
                  f"{tag}: rank {r} launches {x['launches']}, want "
                  f"{per_rank(r)} tb_checksum")
    return {k: sum(x["launches"][k] for x in lines)
            for k in ("land", "checksum")}


def _pod_cards_read(store, cards: int, smi) -> dict:
    """``read --staging pallas`` at phase read's deployment in process
    (``run_read`` with the CLI's sink factory): worker i lands on
    ``cuda:(i % cards)``, so every card runs ``tb_land``; one launch a
    transfer, ``checksum_ok``. The factory is wrapped only to keep each
    stager."""
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging.device import make_sink_factory
    from tpubench_torch.workloads.read import run_read

    _, cfg = _cli(["read", "--protocol", "fake", "--workers", str(WORKERS),
                   "--object-size", str(OBJECT_SIZE), "--granule-bytes",
                   str(GRANULE), "--read-call-per-worker", "1",
                   "--staging", "pallas"])
    made: list = []
    factory = make_sink_factory(cfg, device="cuda")

    def kept(worker_id):
        stager = factory(worker_id)
        made.append(stager)
        return stager

    t0 = time.perf_counter()
    landing.reset_launches()
    res = run_read(cfg, backend=store, device="cuda", sink_factory=kept)
    counts = {"land": landing.land.launches,
              "checksum": landing.checksum.launches}
    transfers = sum(s.transfers for s in made)
    devices = sorted({str(s.device) for s in made})
    check(res.errors == 0 and res.extra["checksum_ok"] is True,
          f"pod_cards/read_pallas: errors {res.errors}, checksum_ok "
          f"{res.extra.get('checksum_ok')}")
    check(devices == [f"cuda:{i}" for i in range(cards)],
          f"pod_cards/read_pallas: stagers on {devices}")
    check(counts == {"land": transfers, "checksum": 0} and transfers,
          f"pod_cards/read_pallas: launches {counts}, {transfers} transfers")
    emit({"phase": "pod_cards", "mode": "read_pallas", "cards": cards,
          "ranks": 1, "backend": None, "devices": devices,
          "workers": WORKERS, "transfers": transfers, "launches": counts,
          "checksum_ok": res.extra["checksum_ok"],
          "staged_gbps": res.extra.get("staged_gbps"),
          "staged_gbps_per_chip": res.extra.get("staged_gbps_per_chip"),
          "staged_bytes": res.extra.get("staged_bytes"),
          "wall_s": res.wall_seconds, "seconds": time.perf_counter() - t0,
          "card": smi})
    return counts


def phase_pod_cards(pod_store, store, smi) -> dict:
    """Pod commands as a user types them, over every card this host
    shows. One card: ``pod-ingest`` of phase pod's 1 GiB object, which
    ``main`` keeps in process as one NCCL rank (no launch; the gather's
    checksum the host's sum, two launches). Several cards: ``main``
    launches one NCCL rank a card for pod-ingest (all_gather, ring, and
    the h2c and wire-gRPC mux routes against this process's servers),
    ``stream --validate``, ``gather-bench`` (every power of two up to the
    card count), ``ckpt-restore`` of a 2 GiB checkpoint saved here onto
    the cards, and ``train-ingest --pipeline-pod``; then ``read --staging
    pallas`` spreads its workers over the cards in process. Each rank
    reports its card, backend, errors and launches (its ``local_rank``
    line): every rank on its own card over NCCL, its checksums verified
    (``errors`` 0; pod-ingest's and stream's ``verified`` hold on every
    rank), ``n_chips`` the card count. Returns the launch counts by mode
    (over all ranks)."""
    import shutil

    import numpy as np
    import torch

    from tpubench_torch.kernels import landing

    cards = torch.cuda.device_count()
    host_sum = int(pod_store._objects["tpubench/file_0"].sum(
        dtype=np.uint64)) % MOD
    counts: dict = {}
    t_phase = time.perf_counter()
    if cards == 1:
        argv, _ = _pod_cards_modes(1, {}, "", "")["pod_ingest"]
        with SharedStore(pod_store), PodObserved() as obs:
            landing.reset_launches()
            run = _pod_run("pod_ingest", argv, 1)
            got = {"land": landing.land.launches,
                   "checksum": landing.checksum.launches}
        res = run["res"]
        check(run["launched"] == [] and not run["ranks"],
              f"pod_cards: main launched {run['launched']} on one card")
        check(res["n_chips"] == 1 and res["errors"] == 0
              and res["extra"]["verified"] is True,
              f"pod_cards/pod_ingest: {res['n_chips']} chips, errors "
              f"{res['errors']}, verified {res['extra']['verified']}")
        check([b for b, _, _ in obs.calls] == ["nccl", "nccl"]
              and all(c == host_sum for _, _, c in obs.calls),
              f"pod_cards/pod_ingest: calls {obs.calls}, host {host_sum}")
        check(got == {"land": 0, "checksum": 2},
              f"pod_cards/pod_ingest: launches {got}")
        counts["pod_cards/pod_ingest"] = got
        emit({"phase": "pod_cards", "mode": "pod_ingest", "cards": 1,
              "ranks": 1, "backend": obs.calls[0][0], "in_process": True,
              "n_chips": res["n_chips"], "verified": True,
              "checksum": obs.calls[-1][2], "host_sum": host_sum,
              "launches": got, **{k: res["extra"][k] for k in (
                  "fetch_gbps", "stage_gbps", "gather_gbps")},
              "seconds": run["seconds"], "card": smi})
        return counts
    counts["pod_cards/read_pallas"] = _pod_cards_read(store, cards, smi)
    fx = _pod_fixtures("pod_cards")
    try:
        with _Servers(pod_store) as servers:
            endpoints = {k: s.endpoint for k, s in servers.by_kind.items()}
            modes = _pod_cards_modes(cards, endpoints, fx["ckpt_dir"],
                                     fx["conf"])
            for mode, (argv, per_rank) in modes.items():
                run = _pod_run(mode, argv, cards)
                counts[f"pod_cards/{mode}"] = got = _pod_check(
                    mode, run, cards, per_rank)
                line = {"phase": "pod_cards", "mode": mode, "cards": cards,
                        "ranks": len(run["ranks"]), "backend": "nccl",
                        "n_chips": run["res"]["n_chips"], "launches": got,
                        "launches_by_rank": [x["launches"]["checksum"]
                                             for x in run["ranks"]],
                        "wall_s": run["res"]["wall_seconds"],
                        "gbps_per_chip": run["res"]["gbps_per_chip"],
                        "seconds": run["seconds"], "card": smi}
                line.update(_pod_mode_result(
                    f"pod_cards/{mode}", argv, run["res"], cards,
                    host_sum, fx["sums"]))
                emit(line)
    finally:
        shutil.rmtree(fx["ckpt_dir"], ignore_errors=True)
    emit({"phase": "pod_cards_total", "cards": cards,
          "seconds": time.perf_counter() - t_phase, "card": smi})
    return counts


def _pod_fixtures(phase: str) -> dict:
    """What the launched pod modes read besides phase pod's store: the
    engine (built here once, found by every rank), a 2 GiB checkpoint
    saved under ``build/`` for ckpt-restore, the gRPC mode's config (the
    gRPC fake is no Google endpoint) and the byte sums of stream's
    objects."""
    import contextlib
    import io
    import os
    import shutil

    import numpy as np

    from tpubench_torch import cli
    from tpubench_torch.native.engine import get_engine
    from tpubench_torch.storage.base import deterministic_bytes

    get_engine()
    ckpt_dir = f"{BUILD}/{phase}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    conf = f"{BUILD}/{phase}_grpc.json"
    os.makedirs(BUILD, exist_ok=True)
    with open(conf, "w") as f:
        json.dump({"transport": {"directpath": False}}, f)
    c = POD_CARDS_CKPT
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["ckpt-save", "--protocol", "local", "--dir", ckpt_dir,
                       "--ckpt-objects", str(c["objects"]),
                       "--ckpt-object-bytes", str(c["object_bytes"]),
                       "--ckpt-part-bytes", str(c["part_bytes"]),
                       "--results-dir", f"{BUILD}/{phase}/save"])
    check(rc == 0, f"{phase}: ckpt-save exit {rc}")
    sums = [int(deterministic_bytes(f"tpubench/file_{k}", OBJECT_SIZE).sum(
        dtype=np.uint64)) % MOD for k in range(POD_CARDS_STREAM_OBJECTS)]
    return {"ckpt_dir": ckpt_dir, "conf": conf, "sums": sums}


def _pod_mode_result(tag: str, argv: list, res: dict, cards: int,
                     host_sum: int, sums: list) -> dict:
    """Global rank 0's result of a launched pod mode, checked by its
    command: pod-ingest verified over the whole 1 GiB object, stream's
    object checksums the true byte sums, gather-bench's rows every power
    of two up to ``cards``, the restore verified and staged at ``cards``
    shards an object, the train pod's steps all taken with no slab
    leaked; returns the line's fields."""
    ex = res["extra"]
    if argv[0] == "pod-ingest":
        check(ex["verified"] is True and res["bytes_total"] == POD_OBJECT,
              f"{tag}: verified {ex['verified']}")
        return {**{k: ex[k] for k in (
            "verified", "shard_bytes", "fetch_gbps", "stage_gbps",
            "gather_gbps", "fetch_seconds", "stage_seconds",
            "gather_seconds", "compile_seconds", "ici_bytes_moved")},
            "host_sum": host_sum}
    if argv[0] == "stream":
        check(ex["verified"] is True and ex["object_checksums"] == sums,
              f"{tag}: verified {ex['verified']}, checksums "
              f"{ex['object_checksums']} vs {sums}")
        return {"verified": True, "object_checksums": sums,
                "overlap_efficiency": ex["overlap_efficiency"]}
    if argv[0] == "gather-bench":
        rows = ex["scaling"]
        check([r["devices"] for r in rows]
              == [n for n in (2, 4, 8, 16, 32) if n <= cards]
              and not ex["single_device"], f"{tag}: rows {rows}")
        return {"scaling": [{k: r[k] for k in (
            "devices", "shard_bytes", "seconds", "per_chip_rx_gbps",
            "total_gbps")} for r in rows]}
    if argv[0] == "ckpt-restore":
        lc = ex["lifecycle"]
        check(lc["verified"] is True and lc["staged"] is True
              and lc["shards_per_object"] == cards
              and lc["objects"] == POD_CARDS_CKPT["objects"],
              f"{tag}: {lc}")
        return {k: lc[k] for k in (
            "verified", "shards_per_object", "objects", "bytes",
            "time_to_restore_s", "fetch_seconds", "stage_seconds")}
    pipe = ex["pipeline"]  # train-ingest --pipeline-pod
    check(pipe["stall"]["steps"] == POD_CARDS_TRAIN_STEPS
          and pipe["copies"]["pool"]["leaked_slabs"] == 0,
          f"{tag}: {pipe['stall']}")
    return {"stall_p50_ms": pipe["stall"]["p50_ms"],
            "stall_p99_ms": pipe["stall"]["p99_ms"]}


# ------------------------------------------------------------ phase 9c --
# Phase hosts: tpubench's command line, typed as a user types it, and a
# pod of two hosts. HOSTS_SMOKE runs the smoke preset on the card in each
# ring; HOSTS_FAULT fails every read (tests/test_torch_cli_parity.py's
# run). Two "hosts" that see one card must both be refused within
# HOSTS_REFUSAL_S.
HOSTS_SMOKE = {"smoke_pallas": ["read", "--preset", "smoke", "--staging",
                                "pallas", "--validate"],
               "smoke_validate": ["read", "--preset", "smoke", "--validate"]}
HOSTS_FAULT = ["read", "--protocol", "fake", "--workers", "2",
               "--read-call-per-worker", "2", "--object-size", "100000",
               "--fault-read-error-rate", "1.0", "--retry-max-attempts", "1"]
# What the errgroup raises for HOSTS_FAULT: the first failed worker's
# injected read fault.
HOSTS_FAULT_ERROR = "WorkerError: StorageError('injected mid-stream failure')"
HOSTS_REFUSAL_S = 60.0
HOSTS_DEADLINE_S = 300.0  # one two-host mode of the multi-card pod


def _hosts_smoke(smi) -> dict:
    """``read --preset smoke`` through ``cli.main`` on the card, in the
    landing ring (``--staging pallas``: one ``tb_land`` a transfer) and
    the validating copy ring (one ``tb_checksum`` a transfer); the sink
    factory wrapped only to keep each stager and count its transfers."""
    import contextlib
    import glob
    import io
    import shutil

    from tpubench_torch import cli
    from tpubench_torch.config import preset
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging import device as staging_device

    counts = {}
    real = staging_device.make_sink_factory
    for mode, argv in HOSTS_SMOKE.items():
        made: list = []

        def kept_factory(cfg, device="cuda"):
            factory = real(cfg, device=device)

            def kept(worker_id):
                stager = factory(worker_id)
                made.append(stager)
                return stager

            return kept

        results = f"{BUILD}/hosts/{mode}"
        shutil.rmtree(results, ignore_errors=True)
        staging_device.make_sink_factory = kept_factory
        try:
            landing.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main([*argv, "--results-dir", results])
            seconds = time.perf_counter() - t0
            got = {"land": landing.land.launches,
                   "checksum": landing.checksum.launches}
        finally:
            staging_device.make_sink_factory = real
        (path,) = glob.glob(f"{results}/*.json")
        with open(path) as f:
            res = json.load(f)
        transfers = sum(s.transfers for s in made)
        kernel = "land" if "pallas" in argv else "checksum"
        want = {"land": 0, "checksum": 0, kernel: transfers}
        smoke = preset("smoke").workload
        size = smoke.workers * smoke.read_calls_per_worker * smoke.object_size
        check(rc == 0 and res["errors"] == 0
              and res["extra"]["checksum_ok"] is True
              and res["extra"]["staged_bytes"] == size,
              f"hosts/{mode}: exit {rc}, errors {res['errors']}, "
              f"checksum_ok {res['extra'].get('checksum_ok')}")
        check(got == want and transfers > 0
              and len(made) == smoke.workers,
              f"hosts/{mode}: launches {got}, {transfers} transfers by "
              f"{len(made)} stagers")
        counts[f"hosts/{mode}"] = got
        emit({"phase": "hosts", "mode": mode, "argv": argv,
              "workers": smoke.workers, "transfers": transfers,
              "launches": got, "checksum_ok": True, "staged_bytes": size,
              "seconds": seconds, "card": smi})
    return counts


def _hosts_save_config(smi) -> None:
    """``--save-config`` in a process of its own: the file loads back to
    the config the same command line folds, and the process made no CUDA
    call (``torch.cuda.is_initialized()`` false at its end)."""
    import os
    import subprocess

    from tpubench_torch import cli
    from tpubench_torch.config import BenchConfig

    path = f"{BUILD}/hosts/saved.json"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    argv = ["read", "--preset", "100mb", "--retry-deadline", "30",
            "--no-abort-on-error", "--staging", "pallas",
            "--save-config", path]
    code = ("import sys, torch; from tpubench_torch import cli; "
            f"rc = cli.main({argv!r}); "
            "print(rc, torch.cuda.is_initialized())")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0 and out.stdout.split()[-2:] == ["0", "False"],
          f"hosts/save_config: {out.returncode} {out.stdout[-500:]} "
          f"{out.stderr[-2000:]}")
    with open(path) as f:
        saved = BenchConfig.from_json(f.read()).to_dict()
    want = cli.build_config(cli.build_parser().parse_args(argv)).to_dict()
    check(saved == want, "hosts/save_config: the file is not the config")
    emit({"phase": "hosts", "mode": "save_config", "cuda_initialized": False,
          "object_size": saved["workload"]["object_size"],
          "retry_deadline_s": saved["transport"]["retry"]["deadline_s"],
          "seconds": seconds, "card": smi})


def _hosts_fault(smi) -> None:
    """``HOSTS_FAULT`` with and without ``--no-abort-on-error``, on the
    card and on the CPU: the same exit (1 for the errgroup's failure, a
    ``WorkerError`` that the command line does not catch, carrying the
    injected read fault; any other exception fails the phase), errors,
    bytes and reads."""
    import contextlib
    import glob
    import io
    import shutil

    from tpubench_torch import cli
    from tpubench_torch.workloads.common import WorkerError

    def run(argv, device, results):
        shutil.rmtree(results, ignore_errors=True)
        out = {}
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main([*argv, "--device", device,
                               "--results-dir", results])
        except WorkerError as e:  # the interpreter would exit 1
            rc = 1
            out["error"] = f"{type(e).__name__}: {e.cause!r}"
        out["rc"] = rc
        for path in glob.glob(f"{results}/*.json"):
            with open(path) as f:
                res = json.load(f)
            out.update(errors=res["errors"], bytes=res["bytes_total"],
                       reads=(res["summaries"].get("read") or {}).get(
                           "count", 0))
        return out

    for mode, extra, want in (
            ("fault_abort", [], {"rc": 1, "error": HOSTS_FAULT_ERROR}),
            ("fault_no_abort", ["--no-abort-on-error"],
             {"rc": 0, "errors": 2, "bytes": 0, "reads": 0})):
        t0 = time.perf_counter()
        card = run([*HOSTS_FAULT, *extra], "cuda", f"{BUILD}/hosts/{mode}")
        seconds = time.perf_counter() - t0
        cpu = run([*HOSTS_FAULT, *extra], "cpu", f"{BUILD}/hosts/{mode}_cpu")
        check(card == cpu == want, f"hosts/{mode}: card {card}, cpu {cpu}")
        emit({"phase": "hosts", "mode": mode, **card, "cpu": cpu,
              "seconds": seconds, "card": smi})


def _live_in_sessions(pids) -> list:
    """Pids of live (not zombie) processes in the sessions ``pids`` led."""
    import glob

    live = []
    for d in glob.glob("/proc/[0-9]*/stat"):
        try:
            with open(d) as f:
                stat = f.read()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()
        if int(fields[3]) in pids and fields[0] != "Z":
            live.append(int(d.split("/")[2]))
    return live


def _hosts_argv(argv: list, host: int, port: int, results: str) -> list:
    return [sys.executable, "-m", "tpubench_torch.cli", *argv,
            "--num-processes", "2", "--process-id", str(host),
            "--coordinator", f"127.0.0.1:{port}", "--results-dir", results]


def _hosts_one_card(smi) -> None:
    """Two hosts of a pod started on one card (``CUDA_VISIBLE_DEVICES=0``
    for both): each keeps its one rank in process, and both must refuse
    before NCCL comes up, naming the card's UUID, within
    ``HOSTS_REFUSAL_S``, leaving no process behind."""
    import os
    import shutil
    import subprocess

    import torch

    from tpubench_torch.dist.bringup import free_port
    from tpubench_torch.dist.launch import child_env

    uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
    results = f"{BUILD}/hosts/one_card"
    shutil.rmtree(results, ignore_errors=True)
    os.makedirs(results)
    port = free_port()
    env = dict(child_env(), CUDA_VISIBLE_DEVICES="0")
    argv = ["pod-ingest", "--protocol", "fake", "--workers", "1",
            "--object-size", str(MIB)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(_hosts_argv(argv, h, port, results), env=env,
                              stdin=subprocess.DEVNULL,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for h in range(2)]
    outs = []
    try:
        for p in procs:
            left = HOSTS_REFUSAL_S - (time.perf_counter() - t0)
            outs.append(p.communicate(timeout=max(1.0, left))[0])
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, 9)
            p.wait()
    seconds = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    check(len(outs) == 2 and seconds < HOSTS_REFUSAL_S,
          f"hosts/one_card: not both ended within {HOSTS_REFUSAL_S} s "
          f"(exit codes {rcs})")
    for h, out in enumerate(outs):
        check(rcs[h] != 0 and "would share one card" in out and uuid in out,
              f"hosts/one_card: host {h} exit {rcs[h]}\n{out[-3000:]}")
    left = _live_in_sessions([p.pid for p in procs])
    check(not left, f"hosts/one_card: processes left {left}")
    refusal = next(ln for ln in outs[0].splitlines()
                   if "would share one card" in ln)
    emit({"phase": "hosts", "mode": "one_card_refused", "exit_codes": rcs,
          "refusal": refusal, "seconds": seconds, "card": smi})


def _hosts_modes(cards: int, endpoints: dict, fx: dict) -> dict:
    """Phase pod_cards' launched modes, and the two that had run only on
    gloo: chaos over pod-ingest (a 0.2 s stall at the first byte of every
    shard) and tune's sweep over the train pod."""
    modes = _pod_cards_modes(cards, endpoints, fx["ckpt_dir"], fx["conf"])
    modes["chaos_pod"] = (_chaos_argv("chaos_pod"), None)
    train, _ = modes["train_pod"]
    modes["tune_train_pod"] = (
        ["tune", "--tune-workload", "train-ingest", "--tune-mode", "sweep",
         *train[1:]], None)
    return modes


def _hosts_pod(pod_store, cards: int, smi) -> dict:
    """Every launched mode on two hosts of ``cards / 2`` cards over NCCL
    (:func:`_pod_run`, :func:`_pod_check`), each pod mode's result
    checked as phase pod_cards checks it, chaos's pod arm without failed
    reads and verified, tune's sweep with every cell clean."""
    import shutil

    import numpy as np

    host_sum = int(pod_store._objects["tpubench/file_0"].sum(
        dtype=np.uint64)) % MOD
    counts = {}
    fx = _pod_fixtures("hosts")
    try:
        with _Servers(pod_store) as servers:
            endpoints = {k: s.endpoint for k, s in servers.by_kind.items()}
            for mode, (argv, per_rank) in _hosts_modes(
                    cards, endpoints, fx).items():
                run = _pod_run(mode, argv, cards, hosts=2)
                counts[f"hosts/{mode}"] = got = _pod_check(
                    mode, run, cards, per_rank, hosts=2)
                res = run["res"]
                ex = res["extra"]
                line = {"phase": "hosts", "mode": mode, "hosts": 2,
                        "cards": cards, "ranks": len(run["ranks"]),
                        "backend": "nccl", "n_chips": res["n_chips"],
                        "topology": ex["topology"], "launches": got,
                        "launches_by_rank": [x["launches"]["checksum"]
                                             for x in run["ranks"]],
                        "wall_s": res["wall_seconds"],
                        "gbps_per_chip": res["gbps_per_chip"],
                        "seconds": run["seconds"], "card": smi}
                if argv[0] == "chaos":
                    sc = ex["chaos"]["scorecard"]
                    check(ex["verified"] is True and sc["failed_reads"] == 0,
                          f"hosts/{mode}: verified {ex['verified']}, "
                          f"scorecard {sc}")
                    line.update(verified=True,
                                failed_reads=sc["failed_reads"],
                                goodput_retention=sc.get("goodput_retention"))
                elif argv[0] == "tune":
                    sw = ex["tune"]["sweep"]
                    check(sw["cells"] and all(
                        c["errors"] == 0 and c["goodput_bps"] > 0
                        for c in sw["cells"]), f"hosts/{mode}: {sw}")
                    line.update(axes=sw["axes"], cells=len(sw["cells"]),
                                recommended=ex["tune"].get("recommended"))
                else:
                    line.update(_pod_mode_result(
                        f"hosts/{mode}", argv, res, cards, host_sum,
                        fx["sums"]))
                emit(line)
    finally:
        shutil.rmtree(fx["ckpt_dir"], ignore_errors=True)
    return counts


def phase_hosts(pod_store, smi) -> dict:
    """``tpubench``'s command line on the card and the multi-host pod.
    On any card count: ``read --preset smoke`` in both rings through
    ``cli.main`` (launches counted, ``checksum_ok``), ``--save-config``
    with no CUDA call, the ``--no-abort-on-error`` fault run as on the
    CPU, and two hosts on one card refused. On n >= 2 cards
    (``scripts/smoke_phases.py --phases hosts``): every launched mode on
    two hosts of n / 2 cards. Returns the launch counts by mode."""
    import torch

    t0 = time.perf_counter()
    counts = _hosts_smoke(smi)
    _hosts_save_config(smi)
    _hosts_fault(smi)
    _hosts_one_card(smi)
    cards = torch.cuda.device_count()
    if cards >= 2:
        counts.update(_hosts_pod(pod_store, cards, smi))
    emit({"phase": "hosts_total", "cards": cards,
          "seconds": time.perf_counter() - t0, "card": smi})
    return counts


# ------------------------------------------------------------- phase 10 --
def phase_gather(smi) -> dict:
    """``gather-bench`` at world size 1 (a one-rank NCCL group), each of
    the four collectives on a 4 MiB shard: labelled ``single_device``, no
    errors, every call's output equal to its input (at n = 1 the gathers,
    the reduce-scatter and the all-reduce are identities), and every
    ``tb_checksum`` of the gathers equal to the staged shard's byte sum
    mod 2³², summed on the host."""
    import numpy as np
    import torch

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.workloads import gather_bench

    launches = {}
    for mode in GATHER_MODES:
        args, cfg = _cli(["gather-bench", "--collective", mode,
                          "--shard-mb", str(GATHER_SHARD_MB),
                          "--reps", str(GATHER_REPS)])
        # (input, output, checksum or None) of every call, compared after
        # the run.
        calls = []
        make = gather_bench.COLLECTIVES[mode]

        def watched(pod, make=make):
            fn = make(pod)

            def call(staged):
                out = fn(staged)
                calls.append((staged.array, *out) if isinstance(out, tuple)
                             else (staged.array, out, None))
                return out

            return call

        gather_bench.COLLECTIVES[mode] = watched
        try:
            landing.reset_launches()
            res = cli.execute("gather-bench", cfg, device="cuda", args=args)
            counts = {"land": landing.land.launches,
                      "checksum": landing.checksum.launches}
        finally:
            gather_bench.COLLECTIVES[mode] = make
        launches[f"gather/{mode}"] = counts
        ex = res.extra
        row = ex["scaling"][0]
        check(ex["single_device"] is True and res.errors == 0
              and len(ex["scaling"]) == 1 and row["devices"] == 1,
              f"gather/{mode}: {ex}")
        check(len(calls) == GATHER_REPS + 1, f"gather/{mode}: {len(calls)} calls")
        check(all(torch.equal(i, o) for i, o, _ in calls),
              f"gather/{mode}: output differs from input at n = 1")
        gathers = mode in ("all_gather", "ring")
        host_sums = [int(i.cpu().numpy().sum(dtype=np.uint64)) % MOD
                     for i, _, _ in calls]
        sums = [None if c is None else int(c) for _, _, c in calls]
        check(sums == (host_sums if gathers else [None] * len(calls)),
              f"gather/{mode}: checksums {sums}, host sums {host_sums}")
        want = GATHER_REPS + 1 if gathers else 0
        check(counts == {"land": 0, "checksum": want},
              f"gather/{mode}: launches {counts}, want {want}")
        emit({"phase": "gather", "mode": mode, "single_device": True,
              "shard_bytes": row["shard_bytes"], "reps": row["reps"],
              "ms_per_call": row["seconds"] * 1e3,
              "ici_bytes_moved": row["ici_bytes_moved"], "launches": counts,
              "identity": True, "checksums_equal_host": gathers,
              "card": smi})
    return launches


# ------------------------------------------------------------- phase 11 --
def phase_probe(smi) -> None:
    """``probe --cycles 3 --cycle-sleep 0.5``: the host→card copy from
    page-locked arrays, swept over sizes, and three identical cycles."""
    from tpubench_torch import cli

    args, cfg = _cli(["probe", "--cycles", "3", "--cycle-sleep", "0.5"])
    res = cli.execute("probe", cfg, device="cuda", args=args)
    ex = res.extra
    check(ex["device"].startswith("cuda") and res.gbps > 0
          and len(ex["cycle_samples_gbps"]) == 3, f"probe: {ex}")
    emit({"phase": "probe", **{k: ex[k] for k in (
        "device", "size_sweep_gbps", "sweep_anomalies",
        "fixed_cost_speedup_8MB_over_2MB", "cycle_samples_gbps", "peak_gbps",
        "median_gbps", "floor_gbps", "shaped", "slow_start")},
        "wall_s": res.wall_seconds, "card": smi})


# ------------------------------------------------------------- phase 12 --
def _union(spans: list) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_us(a: list, b: list) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _wait_vs_device(path: str) -> dict:
    """From a trace: how long the fetch threads were blocked on the
    device (``staging/transfer_wait``, the stagers' ``transfer_wait_ns``:
    summed over threads and as a union) and what share of that union the
    card was busy."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))

    waits = [span(e) for e in events if e.get("name") == "staging/transfer_wait"]
    device = _union([span(e) for e in events
                     if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")])
    wait_union = _union(waits)
    union_us = sum(e - s for s, e in wait_union)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    syncs = [e for e in events if e.get("cat") == "cuda_sync"]
    return {
        "transfer_waits": len(waits),
        "transfer_wait_s_total": sum(e - s for s, e in waits) / 1e6,
        "transfer_wait_union_s": union_us / 1e6,
        "device_busy_during_wait_share": (
            _overlap_us(wait_union, device) / union_us if union_us else None),
        "memcpy": {"count": len(copies),
                   "total_s": sum(float(e.get("dur", 0)) for e in copies) / 1e6},
        "cuda_sync": {"count": len(syncs),
                      "total_s": sum(float(e.get("dur", 0)) for e in syncs) / 1e6},
    }


def _profiled(path: str, run, smi) -> None:
    """One run under ``obs.profile_dir``: the trace's ``tb_checksum`` and
    ``tb_land`` kernel events must equal the launch counters; prints the
    device busy share (the union of kernel and copy intervals over the
    traced window) and the fetch threads' waits on the device."""
    import glob
    import os
    import shutil

    from tpubench_torch.kernels import landing
    from tpubench_torch.obs.profiling import trace_summary

    out = f"{BUILD}/profile/{path.replace('/', '_')}"
    shutil.rmtree(out, ignore_errors=True)
    landing.reset_launches()
    res = run(out)
    counts = {"land": landing.land.launches, "checksum": landing.checksum.launches}
    (trace,) = glob.glob(f"{out}/trace_*.json")
    summary = trace_summary(trace)
    in_trace = {k: sum(n for name, n in summary["kernels"].items()
                       if f"{k}_kernel" in name) for k in ("land", "checksum")}
    check(summary["device_events"] > 0, f"profile/{path}: no device event")
    check(in_trace == counts,
          f"profile/{path}: kernels in the trace {in_trace}, launches {counts}")
    check(res.errors == 0, f"profile/{path}: {res.errors} errors")
    line = {
        "phase": "profile", "path": path, "trace": trace,
        "trace_mb": os.path.getsize(trace) / 1e6, "launches": counts,
        "kernels_in_trace": in_trace,
        "events_by_category": summary["events_by_category"],
        "window_s": summary["window_us"] / 1e6,
        "device_busy_s": summary["device_busy_us"] / 1e6,
        "device_busy_share": summary["device_busy_share"],
        "regions": summary["regions"], "wall_s": res.wall_seconds,
        **_wait_vs_device(trace), "card": smi,
    }
    if "staged_gbps_per_chip" in res.extra:
        line["staged_gbps_per_chip"] = res.extra["staged_gbps_per_chip"]
    emit(line)


def phase_profile(store, pod_store, smi) -> None:
    """Phase read's device_put_depth3 and pallas modes and pod/all_gather,
    each once more through ``cli.execute`` with ``obs.profile_dir`` under
    ``build/`` (torch.profiler: every thread's host ops, the card's
    kernels and copies, the host's waits on the card)."""
    from tpubench_torch import cli

    for mode in ("device_put_depth3", "pallas"):
        def run(out, mode=mode):
            cfg = _config(WORKERS, OBJECT_SIZE, GRANULE, mode)
            cfg.obs.profile_dir = out
            return cli.execute("read", cfg, device="cuda", backend=store)

        _profiled(f"read/{mode}", run, smi)

    def run_pod(out):
        args, cfg = _cli(["pod-ingest", "--protocol", "fake", "--workers", "1",
                          "--object-size", str(POD_OBJECT),
                          "--profile-dir", out])
        return cli.execute("pod-ingest", cfg, device="cuda", backend=pod_store,
                           args=args)

    _profiled("pod/all_gather", run_pod, smi)


# ------------------------------------------------------------- phase 13 --
# Phase tune: the deployment of phase read under the tune plane, driven as
# `tpubench_torch tune` drives it (cli.execute), over phase read's store.
TUNE_WINDOW_S, TUNE_DURATION_S = 0.5, 6.0
# Seed 3 makes the controller's first staging_depth probe a grow (3 -> 6,
# staging_depth_ceiling(3)): the live grow of 48 page-locked rings runs.
TUNE_SEED = 3
TUNE_MODES = {
    "online_depth3": ["--tune-mode", "online", "--staging", "device_put",
                      "--depth", "3", "--tune-knobs", "workers,staging_depth",
                      "--read-call-per-worker", "1000"],
    "online_validate": ["--tune-mode", "online", "--staging", "device_put",
                        "--validate", "--tune-knobs", "workers",
                        "--read-call-per-worker", "1000"],
    "sweep_pallas": ["--tune-mode", "sweep", "--staging", "pallas",
                     "--tune-knobs", "workers,staging_depth",
                     "--read-call-per-worker", "1"],
}


class TuneObserved:
    """Keeps what a tune session builds: each run it makes (its config,
    result, ``tb_land`` launches and landing-ring transfers, as deltas of
    counters the phase zeroes before the session), every stager a
    StagerRegistry attached, each depth the registry fanned out (with its
    wall time and the slots it made), and each stager's live grows
    (checked page-locked after every set_depth). Wraps the functions;
    what they do is unchanged."""

    def __init__(self):
        self.runs, self.attached, self.fanouts = [], [], []
        self.land_transfers = 0
        self.grown = 0  # slots allocated by live grows
        self.grown_rings: set = set()
        self.unpinned = 0
        # id(stager) -> the last depth it took while open
        self.took: dict = {}

    def __enter__(self):
        from tpubench_torch.kernels import landing
        from tpubench_torch.staging.device import DevicePutStager
        from tpubench_torch.staging.executor import StagerRegistry
        from tpubench_torch.staging.land_stage import LandStager
        from tpubench_torch.workloads import tune_cmd

        self._saved = [(StagerRegistry, "attach", StagerRegistry.attach),
                       (StagerRegistry, "set_depth", StagerRegistry.set_depth),
                       (DevicePutStager, "set_depth",
                        DevicePutStager.set_depth),
                       (LandStager, "finish", LandStager.finish),
                       (tune_cmd, "_run_target", tune_cmd._run_target)]
        attach, fan, grow, land_finish, run = (f for _, _, f in self._saved)
        obs = self
        lock = __import__("threading").Lock()

        def counted_run(cfg, workload, **kw):
            n0, t0 = landing.land.launches, obs.land_transfers
            res = run(cfg, workload, **kw)
            obs.runs.append((cfg, res, landing.land.launches - n0,
                             obs.land_transfers - t0))
            return res

        def counted_finish(stager):
            stats = land_finish(stager)
            with lock:
                obs.land_transfers += stats["transfers"]
            return stats

        def kept_attach(reg, stager):
            obs.attached.append((reg, stager))
            return attach(reg, stager)

        def timed_fan(reg, depth):
            made0 = obs.grown
            t0 = time.perf_counter()
            fan(reg, depth)
            obs.fanouts.append({"depth": int(depth),
                                "seconds": time.perf_counter() - t0,
                                "slots_made": obs.grown - made0})

        def checked_grow(stager, depth):
            # Called on the registry's grow threads: counts under a lock.
            n0 = len(stager._slots)
            if not getattr(stager, "_closed", True):
                obs.took[id(stager)] = int(depth)
            out = grow(stager, depth)
            new = stager._slots[n0:]
            unpinned = sum(1 for t in new if not t.is_pinned())
            with lock:
                obs.grown += len(new)
                obs.unpinned += unpinned
                if new:
                    obs.grown_rings.add(id(stager))
            return out

        StagerRegistry.attach = kept_attach
        StagerRegistry.set_depth = timed_fan
        DevicePutStager.set_depth = checked_grow
        LandStager.finish = counted_finish
        tune_cmd._run_target = counted_run
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _tune_online_checks(mode: str, res, obs: TuneObserved) -> dict:
    ex, tn = res.extra, res.extra["tune"]["adaptive"]
    check(tn.get("enabled") and tn.get("error") is None,
          f"tune/{mode}: controller error {tn.get('error')}")
    check(tn["n_windows"] >= 3, f"tune/{mode}: {tn['n_windows']} windows")
    check(res.errors == 0, f"tune/{mode}: {res.errors} errors")
    check(ex.get("staged_bytes") == res.bytes_total > 0,
          f"tune/{mode}: staged {ex.get('staged_bytes')} of "
          f"{res.bytes_total}")
    out = {"n_windows": tn["n_windows"], "initial": tn["initial"],
           "final": tn["final"], "converged": tn["converged"],
           "windows_to_converge": tn["windows_to_converge"],
           "accepts": tn["accepts"], "reverts": tn["reverts"],
           "guard_violations": tn["guard_violations"],
           "values": [w["values"] for w in tn["windows"]]}
    if "staging_depth" not in tn["initial"]:
        return out
    regs = {id(r) for r, _ in obs.attached}
    stagers = [st for _, st in obs.attached]
    streams = {st.stream.cuda_stream for st in stagers}
    check(len(regs) == 1 and len(stagers) == WORKERS
          and len(streams) == WORKERS,
          f"tune/{mode}: {len(stagers)} rings in {len(regs)} registries on "
          f"{len(streams)} streams")
    commanded = obs.attached[0][0]._depth
    final = tn["final"]["staging_depth"]
    check((commanded or 3) == final,
          f"tune/{mode}: registry at {commanded}, controller at {final}")
    # A ring that finished (at the session's cancel) before a later
    # command keeps the depth it had then; every other ring ends at the
    # last depth the controller commanded.
    depths = sorted({st.depth for st in stagers})
    check(all(st.depth == obs.took.get(id(st), 3) for st in stagers),
          f"tune/{mode}: ring depths {depths} vs the depths they took")
    at_last = sum(1 for st in stagers if st.depth == (commanded or 3))
    grows = [f for f in obs.fanouts if f["slots_made"]]
    check(grows and len(obs.grown_rings) == WORKERS and obs.unpinned == 0,
          f"tune/{mode}: live grows {grows} reached "
          f"{len(obs.grown_rings)} rings, {obs.grown} slots made, "
          f"{obs.unpinned} not page-locked")
    out.update(rings=len(stagers), streams=len(streams), ring_depths=depths,
               rings_at_last_command=at_last,
               rings_grown=len(obs.grown_rings),
               fanouts=obs.fanouts, slots_grown=obs.grown,
               grow_s=[f["seconds"] for f in grows])
    return out


def phase_tune(store, smi) -> dict:
    """``tune`` over phase read's deployment, three modes (module
    docstring), then ``report``, ``report timeline``, ``report trace`` and
    ``top --once`` over what they wrote."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.metrics.report import write_result

    out_dir = f"{BUILD}/tune"
    journal = f"{out_dir}/online_depth3_journal.json"
    launches, results = {}, []
    for mode, flags in TUNE_MODES.items():
        argv = ["tune", "--protocol", "fake", "--workers", str(WORKERS),
                "--object-size", str(OBJECT_SIZE), "--granule-bytes",
                str(GRANULE), "--tune-window", str(TUNE_WINDOW_S),
                "--tune-duration", str(TUNE_DURATION_S), *flags]
        if mode == "online_depth3":
            argv += ["--flight-journal", journal]
        args, cfg = _cli(argv)
        cfg.tune.seed = TUNE_SEED
        with TuneObserved() as obs:
            landing.reset_launches()
            t0 = time.perf_counter()
            res = cli.execute("tune", cfg, device="cuda", backend=store,
                              args=args)
            wall = time.perf_counter() - t0
            counts = {"land": landing.land.launches,
                      "checksum": landing.checksum.launches}
        cells = obs.runs
        launches[f"tune/{mode}"] = counts
        results.append(write_result(res, out_dir, tag=mode))
        line = {"phase": "tune", "mode": mode, "workers": WORKERS,
                "object_size": OBJECT_SIZE, "launches": counts,
                "session_s": wall, "card": smi}
        if mode == "sweep_pallas":
            rows = []
            for c, r, n, got in cells:
                slot = _slot(c)
                want = c.workload.workers * expected_transfers(
                    OBJECT_SIZE, GRANULE, slot)
                check(r.errors == 0 and r.extra.get("checksum_ok") is True,
                      f"tune/{mode}: cell {c.workload.workers}x"
                      f"{c.staging.depth} errors {r.errors} checksum "
                      f"{r.extra.get('checksum_ok')}")
                check(n == got == want, f"tune/{mode}: cell "
                      f"{c.workload.workers}x{c.staging.depth} launches {n}, "
                      f"transfers {got}, want {want}")
                rows.append({"workers": c.workload.workers,
                             "depth": c.staging.depth, "slot_bytes": slot,
                             "transfers": got, "launches": n,
                             "staged_gbps_per_chip":
                                 r.extra["staged_gbps_per_chip"],
                             "read_p99_ms": r.summaries["read"].p99_ms})
            sw = res.extra["tune"]["sweep"]
            check(sw["axes"] == {"workers": [1, 2, 4, 8, 16, 32, 48],
                                 "staging_depth": [1, 2, 3, 4]},
                  f"tune/{mode}: axes {sw['axes']}")
            check(counts["land"] == sum(c[2] for c in cells)
                  and counts["checksum"] == 0,
                  f"tune/{mode}: launches {counts}")
            line.update(cells=rows, best=sw["best"]["values"],
                        recommended=res.extra["tune"]["recommended"])
        else:
            check(len(cells) == 1, f"tune/{mode}: {len(cells)} runs")
            line.update(_tune_online_checks(mode, res, obs))
            ex = res.extra
            transfers = ex["staging"]["transfers"]
            kernel = "checksum" if mode == "online_validate" else None
            want = {"land": 0, "checksum": 0}
            if kernel:
                check(ex.get("checksum_ok") is True,
                      f"tune/{mode}: checksum {ex.get('checksum_ok')}")
                want[kernel] = transfers
            check(counts == want, f"tune/{mode}: launches {counts}, "
                  f"want {want}")
            fb = res.summaries.get("first_byte")
            line.update(transfers=transfers,
                        staged_bytes=ex["staged_bytes"],
                        checksum_ok=ex.get("checksum_ok"),
                        wall_s=res.wall_seconds,
                        staged_gbps_per_chip=ex["staged_gbps_per_chip"],
                        first_byte_p50_ms=fb.p50_ms if fb else None,
                        first_byte_p99_ms=fb.p99_ms if fb else None)
        emit(line)
    n_windows = json.load(open(results[0]))["extra"]["tune"]["adaptive"][
        "n_windows"]
    texts = {}
    for name, argv in (
        ("report", ["report", *results]),
        ("timeline", ["report", "timeline", journal]),
        ("trace", ["report", "trace", journal]),
        ("top", ["top", "--once", "--no-color", journal]),
    ):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        check(rc == 0, f"tune/{name}: exit {rc}")
        texts[name] = (buf.getvalue(), time.perf_counter() - t0)
    check(f"tune decisions: {n_windows} " in texts["timeline"][0],
          f"tune/timeline: tune records not counted ({n_windows} windows)")
    check(f"tune={n_windows}d/" in texts["top"][0],
          f"tune/top: tune records not counted ({n_windows} windows)")
    check("== tune (sweep over read) ==" in texts["report"][0]
          and "== trace report:" in texts["trace"][0],
          "tune/report: blocks missing")
    emit({"phase": "tune_report", "results": results, "journal": journal,
          "seconds": {k: v[1] for k, v in texts.items()},
          "lines": {k: len(v[0].splitlines()) for k, v in texts.items()}})
    return launches



# ------------------------------------------------------------- phase 14 --
# Phase sweep: the fake store at the reference's 48 workers over the four
# sizes; the 1gb cell with SWEEP_1GB_WORKERS (48 x 1 GiB objects would be
# generated in host memory). Then the clients against phase protocols'
# servers (phase read's 100 MiB objects) with fewer workers.
SWEEP_1GB_WORKERS = 4
SWEEP_SERVER_WORKERS = 8
# Reads a worker cut from the reference launcher's (1000 at 256kb, 10 at
# 100mb; read_operations.sh:8-14) for the script's time on the card: the
# 256kb cell 48 x 250 reads, the 100mb cell 48 x 1 x 100 MiB.
SWEEP_256KB_READS = 250
SWEEP_100MB_READS = 1


class SweepObserved:
    """Keeps each cell a sweep runs — its config, result and kernel
    launches (deltas of the counters the phase zeroes before the sweep)
    and each ``tb_land`` ring's transfers — by wrapping ``cli.read`` and
    ``LandStager.finish``; what they do is unchanged."""

    def __init__(self):
        self.cells = []
        self._land_transfers = 0

    def __enter__(self):
        import threading

        from tpubench_torch import cli
        from tpubench_torch.kernels import landing
        from tpubench_torch.staging.land_stage import LandStager

        self._saved = [(cli, "read", cli.read),
                       (LandStager, "finish", LandStager.finish)]
        read, finish = cli.read, LandStager.finish
        lock = threading.Lock()
        obs = self

        def counted_finish(stager):
            stats = finish(stager)
            with lock:
                obs._land_transfers += stats["transfers"]
            return stats

        def counted_read(cfg, device="cuda", backend=None):
            n0 = (landing.land.launches, landing.checksum.launches,
                  obs._land_transfers)
            res = read(cfg, device=device, backend=backend)
            obs.cells.append((cfg, res, {
                "land": landing.land.launches - n0[0],
                "checksum": landing.checksum.launches - n0[1]},
                obs._land_transfers - n0[2]))
            return res

        cli.read = counted_read
        LandStager.finish = counted_finish
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def _sweep_cells(tag: str, argv: list, smi) -> tuple[dict, list]:
    """One ``sweep`` call as the CLI makes it, every cell checked: zero
    errors, ``checksum_ok``, every byte staged, 48 (or N) workers' slots
    page-locked on distinct streams, and one kernel launch per transfer.
    Returns the launches and the rows."""
    from tpubench_torch import cli
    from tpubench_torch.dist import bringup
    from tpubench_torch.kernels import landing
    from tpubench_torch.staging import device as staging_device

    args, cfg = _cli(["sweep", *argv])
    stagers = []
    real_factory = staging_device.make_sink_factory
    counts = {"land": 0, "checksum": 0}
    rows = []
    with SweepObserved() as obs, GrpcModes() as modes:
        staging_device.make_sink_factory = (
            lambda c, device="cuda": _noting(real_factory(c, device=device),
                                             stagers))
        try:
            landing.reset_launches()
            t0 = time.perf_counter()
            with bringup.session(cfg.dist, "cuda"):
                out = cli.sweep(cfg, args.sweep_protocols, args.sweep_sizes,
                                native=args.sweep_native, device="cuda")
            wall = time.perf_counter() - t0
        finally:
            staging_device.make_sink_factory = real_factory
    check(len(out) == len(obs.cells), f"{tag}: {len(out)} rows, "
          f"{len(obs.cells)} cells")
    made = 0
    for row, (c, res, n, land_transfers) in zip(out, obs.cells):
        w = c.workload
        cell = f"{tag}/{row['protocol']}/{row['size']}" + (
            "/native" if row.get("native_receive") else "")
        ex = res.extra
        workers_stagers = stagers[made:made + w.workers]
        made += w.workers
        streams = {st.stream.cuda_stream for st, _ in workers_stagers}
        reads = w.workers * w.read_calls_per_worker
        size = res.bytes_total // reads if reads else 0
        check(res.errors == 0 and ex.get("checksum_ok") is True,
              f"{cell}: errors {res.errors}, checksum {ex.get('checksum_ok')}")
        check(ex["staged_bytes"] == res.bytes_total == reads * size
              and size > 0, f"{cell}: staged {ex['staged_bytes']}")
        check(len(workers_stagers) == w.workers
              and len(streams) == w.workers
              and all(p for _, p in workers_stagers),
              f"{cell}: {len(streams)} streams for {w.workers} workers")
        if c.staging.mode == "pallas":
            want = w.workers * expected_transfers(
                size, w.granule_bytes, _slot(c), w.read_calls_per_worker)
            check(n == {"land": want, "checksum": 0} and land_transfers == want,
                  f"{cell}: launches {n}, ring transfers {land_transfers}, "
                  f"want {want}")
        else:
            transfers = ex["staging"]["transfers"]
            check(n == {"land": 0, "checksum": transfers} and transfers > 0,
                  f"{cell}: launches {n}, transfers {transfers}")
        for k in counts:
            counts[k] += n[k]
        fb = res.summaries.get("first_byte")
        rows.append({"cell": cell, "workers": w.workers,
                     "reads_per_worker": w.read_calls_per_worker,
                     "object_size": size, "launches": n,
                     "gbps": row["gbps"],
                     "staged_gbps_per_chip": ex["staged_gbps_per_chip"],
                     "read_p50_ms": row["p50_ms"], "read_p99_ms": row["p99_ms"],
                     "first_byte_p99_ms": fb.p99_ms if fb else None,
                     "streams": len(streams),
                     "native_conn_stats": ex.get("native_conn_stats"),
                     "result": row["result"]})
    if "grpc" in argv:
        check(modes.mode == "library", f"{tag}: gRPC in {modes.mode} mode")
    emit({"phase": "sweep", "mode": tag, "argv": argv, "cells": rows,
          "launches": counts, "seconds": wall, "card": smi,
          **({"grpc_mode": modes.mode} if modes.mode else {})})
    return counts, rows


def phase_sweep(store, smi) -> dict:
    """``sweep`` as the CLI runs it: first the fake store through the
    landing-kernel ring (``--staging pallas``) over the reference's four
    sizes and read counts, then HTTP/1.1, HTTP/2 and gRPC, each with the
    Python and the native receive where there is one (``--sweep-native``),
    through the validating copy ring against phase protocols' servers."""
    argv = ["--protocol", "fake", "--sweep-protocols", "fake",
            "--staging", "pallas", "--granule-bytes", str(GRANULE)]
    pallas, _ = _sweep_cells("sweep/pallas", [
        *argv, "--sweep-sizes", "256kb,1mb", "--workers", str(WORKERS),
        "--read-call-per-worker", str(SWEEP_256KB_READS)], smi)
    # sweep caps each cell's reads at --read-call-per-worker.
    mid, _ = _sweep_cells("sweep/pallas", [
        *argv, "--sweep-sizes", "100mb", "--workers", str(WORKERS),
        "--read-call-per-worker", str(SWEEP_100MB_READS)], smi)
    big, _ = _sweep_cells("sweep/pallas", [
        *argv, "--sweep-sizes", "1gb", "--workers", str(SWEEP_1GB_WORKERS)],
        smi)
    validate = {"land": 0, "checksum": 0}
    with _Servers(store) as servers:
        # Each protocol against its own server (the h2c one answers
        # HTTP/1.1 too, but slower than the HTTP/1.1 one).
        for proto, kind, native in (("http", "h1", ["--sweep-native"]),
                                    ("http2", "h2", []),
                                    ("grpc", "grpc", ["--sweep-native"])):
            n, _ = _sweep_cells("sweep/validate", [
                "--protocol", "grpc" if proto == "grpc" else "http",
                "--endpoint", servers.by_kind[kind].endpoint, "--bucket",
                "testbucket", "--object-name-prefix", "tpubench/file_",
                "--sweep-protocols", proto, *native, "--sweep-sizes", "100mb",
                "--workers", str(SWEEP_SERVER_WORKERS),
                "--read-call-per-worker", "1", "--granule-bytes",
                str(GRANULE), "--validate"], smi)
            validate = {k: validate[k] + n[k] for k in validate}
    emit({"phase": "sweep_reduced", "reduced": [
        f"fake 256kb cell: {SWEEP_256KB_READS} reads a worker (the "
        "reference's 1000; the script's time on the card)",
        f"fake 100mb cell: {SWEEP_100MB_READS} read a worker (the "
        "reference's 10; the script's time on the card)",
        f"fake 1gb cell: {SWEEP_1GB_WORKERS} workers (48 x 1 GiB objects "
        "would be generated in host memory)",
        f"server cells: 100mb only, {SWEEP_SERVER_WORKERS} workers, 1 read "
        "each (the servers hold phase read's 100 MiB objects: sweep sets "
        "object_size, which only the fake store reads; h2 and gRPC run "
        "at 0.2-0.5 GB/s behind the Python servers)"]})
    return {"sweep/pallas": {k: pallas[k] + mid[k] + big[k] for k in pallas},
            "sweep/validate": validate}


# ------------------------------------------------------------- phase 15 --


def _fs_line(cmd: str, res, seconds: float, smi, **extra) -> dict:
    """A filesystem command's line: GB/s, each latency block's p50/p99."""
    return {"phase": "fs", "mode": cmd, "workload": res.workload,
            "bytes_total": res.bytes_total, "errors": res.errors,
            "gbps": res.gbps, "wall_s": res.wall_seconds,
            **{f"{k}_p50_ms": v.p50_ms for k, v in res.summaries.items()},
            **{f"{k}_p99_ms": v.p99_ms for k, v in res.summaries.items()},
            **{k: v for k, v in res.extra.items()}, **extra,
            "seconds": seconds, "card": smi}


def phase_fs(smi) -> None:
    """``prepare`` and the five filesystem commands through the CLI's
    functions, on a directory under ``build/`` (removed after): list, open,
    write and ssd at ``tpubench``'s config defaults (4 threads, 1024 KiB
    blocks, 64 MiB files, 64 open files, 5 list rounds), read-fs at the
    reference launcher's four sizes and read counts. Zero errors and
    ``bytes_total`` = threads x size x passes; whether ``O_DIRECT``
    engaged is printed (an overlay or tmpfs disk refuses it)."""
    import shutil
    import tempfile
    from pathlib import Path

    from tpubench_torch import cli
    from tpubench_torch.config import WorkloadConfig
    from tpubench_torch.workloads.fsbench import prepare_files

    d = WorkloadConfig()
    threads, fsize = d.threads, d.file_size_mb * MIB
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="fs-", dir=build)
    t_phase = time.perf_counter()

    def run(cmd: str, *argv: str):
        args, cfg = _cli([cmd, "--dir", *argv])
        t0 = time.perf_counter()
        res = cli.execute(cmd, cfg, device="cuda", args=args)
        check(res.errors == 0, f"fs/{cmd}: {res.errors} errors")
        return res, time.perf_counter() - t0

    try:
        flat = f"{root}/flat"
        t0 = time.perf_counter()
        cli.prepare(_cli(["prepare", "--dir", flat])[1], "flat")
        files = max(threads, d.open_files)
        emit({"phase": "fs_setup", "layout": "flat", "files": files,
              "file_size": fsize, "seconds": time.perf_counter() - t0})
        res, sec = run("list", flat)
        check(res.extra["entries"] == files
              and res.extra["rounds"] == d.list_rounds
              and res.summaries["list_hot"].count == d.list_rounds - 1,
              f"fs/list: {res.extra}")
        emit(_fs_line("list", res, sec, smi))
        res, sec = run("open", flat)
        check(res.extra["open_files"] == d.open_files
              and res.summaries["open"].count == 2 * d.open_files,
              f"fs/open: {res.extra}")
        emit(_fs_line("open", res, sec, smi))
        res, sec = run("write", f"{root}/write")
        blocks = fsize // (d.block_size_kb * 1024)
        check(res.bytes_total == threads * fsize * d.write_count
              and res.summaries["block_write"].count
              == threads * blocks * d.write_count
              and res.extra["fsync_every_block"] is True,
              f"fs/write: {res.bytes_total} B, {res.extra}")
        emit(_fs_line("write", res, sec, smi))
        shutil.rmtree(flat)
        shutil.rmtree(f"{root}/write")
        ssd = f"{root}/ssd"
        cli.prepare(_cli(["prepare", "--layout", "ssd", "--dir", ssd])[1],
                    "ssd")
        for read_type in ("seq", "random"):
            res, sec = run("ssd", ssd, "--read-type", read_type)
            check(res.bytes_total == threads * fsize * d.read_count
                  and res.extra["blocks_per_pass"] == blocks,
                  f"fs/ssd {read_type}: {res.bytes_total} B")
            emit(_fs_line("ssd", res, sec, smi))
        shutil.rmtree(ssd)
        # The reference launcher's four file sizes and read counts
        # (read_operations.sh:8-14), the table sweep reads too.
        for label, (size, count) in cli.SWEEP_SIZES.items():
            sub = f"{root}/read_{label}"
            t0 = time.perf_counter()
            prepare_files(sub, threads, size)
            prep = time.perf_counter() - t0
            res, sec = run("read-fs", sub, "--read-count", str(count))
            check(res.bytes_total == threads * size * count
                  and res.summaries["pass"].count == threads * count,
                  f"fs/read-fs {label}: {res.bytes_total} B")
            emit(_fs_line("read-fs", res, sec, smi, size=label,
                          file_size=size, passes=count, prepare_s=prep))
            shutil.rmtree(sub)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "fs_done", "seconds": time.perf_counter() - t_phase,
          "reduced": []})


# ------------------------------------------------------------- phase 16 --
def phase_preflight(smi) -> None:
    """``preflight`` as the CLI runs it: exit 0 for the fake store, exit 1
    against a dead endpoint (retry deadline 2 s, so the list gives up
    before the probe's 15 s bound), and exit 0 in a process that sees no
    GPU, which never initialises CUDA."""
    import contextlib
    import io
    import os
    import subprocess

    from tpubench_torch import cli

    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.storage.fake_server import FakeGcsServer

    out = {}
    conf = f"{BUILD}/preflight_retry.json"
    os.makedirs(BUILD, exist_ok=True)
    with open(conf, "w") as f:
        json.dump({"transport": {"retry": {"deadline_s": 2.0}}}, f)
    with FakeGcsServer(FakeBackend.prepopulated("tpubench/file_", 2, 1000)) as srv:
        for name, argv in (
            ("fake", ["preflight", "--protocol", "fake"]),
            ("dead_endpoint", ["preflight", "--protocol", "http", "--config",
                               conf, "--endpoint", "http://127.0.0.1:9"]),
            # A key file against a test server's endpoint: anonymous, as in
            # tpubench (the file is never read).
            ("key_file_loopback", [
                "preflight", "--protocol", "http", "--endpoint", srv.endpoint,
                "--key-file", f"{BUILD}/no_such_key.json", "--bucket",
                "testbucket", "--object-name-prefix", "tpubench/file_"]),
        ):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            lines = buf.getvalue().strip().splitlines()
            auth = next(c for c in json.loads(lines[-1])["checks"]
                        if c["name"] == "auth")
            out[name] = {"rc": rc, "seconds": time.perf_counter() - t0,
                         "verdict": lines[-2], "auth": auth["detail"]}
    check(out["fake"]["rc"] == 0 and out["fake"]["verdict"] == "preflight: OK",
          f"preflight/fake: {out['fake']}")
    check(out["dead_endpoint"]["rc"] == 1, f"preflight/dead: {out}")
    kf = out["key_file_loopback"]
    check(kf["rc"] == 0 and kf["verdict"] == "preflight: OK"
          and "anonymous" in kf["auth"], f"preflight/key_file: {kf}")
    code = ("import sys, torch; from tpubench_torch.cli import main; "
            "rc = main(['preflight', '--protocol', 'fake']); "
            "print('cuda_initialized', torch.cuda.is_initialized()); "
            "sys.exit(rc)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    out["no_gpu"] = {"rc": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "cuda_initialized": "cuda_initialized True" in proc.stdout}
    check(proc.returncode == 0 and "preflight: OK" in proc.stdout
          and "cuda_initialized False" in proc.stdout,
          f"preflight/no_gpu: rc {proc.returncode} {proc.stderr[-500:]}")
    emit({"phase": "preflight", **out, "card": smi})



# ------------------------------------------------------------- phase 17 --
def phase_stream(store, smi) -> dict:
    """``stream`` through ``cli.execute`` (a one-rank NCCL group) at
    tpubench's defaults over phase read's store: mode stream (8 objects,
    validated, a snapshot under ``build/``), stream_resume (from that
    snapshot with ``--objects 10``: 8 skipped, 2 ingested) and
    stream_h2_mux (the store behind the port's h2c server, each object's
    shard one batch of MUX_RANGES_PER_RANK ranges on one connection).
    Every mode: verified, each object's device checksum the true byte sum
    of its object mod 2³², zero errors, every byte delivered, one
    ``tb_checksum`` launch per object and one for the warm-up; the peak
    device memory stays that of one object, not the stream's."""
    import os

    import numpy as np
    import torch

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage import base_backend, open_backend
    from tpubench_torch.storage.fake_h2_server import FakeH2Server
    from tpubench_torch.workloads.pod_ingest import MUX_RANGES_PER_RANK

    os.makedirs(BUILD, exist_ok=True)
    snap = f"{BUILD}/stream_snapshot.json"
    if os.path.exists(snap):
        os.remove(snap)
    prefix = "tpubench/file_"
    true_sums = [int(store._objects[f"{prefix}{k}"].sum(dtype=np.uint64)) % MOD
                 for k in range(max(STREAM_MODES.values()))]
    base = ["stream", "--validate", "--workers", str(WORKERS),
            "--object-size", str(OBJECT_SIZE)]
    argv = {
        "stream": [*base, "--protocol", "fake", "--snapshot", snap],
        "stream_resume": [*base, "--protocol", "fake", "--objects",
                          str(STREAM_MODES["stream_resume"]),
                          "--resume-from", snap],
        "stream_h2_mux": [*base, "--protocol", "http", "--http2",
                          "--bucket", "testbucket", "--object-name-prefix",
                          prefix, "--objects",
                          str(STREAM_MODES["stream_h2_mux"])],
    }
    launches = {}
    with FakeH2Server(store) as h2:
        for mode, av in argv.items():
            mux = mode.endswith("_mux")
            args, cfg = _cli(av + (["--endpoint", h2.endpoint] if mux else []))
            backend, batches, conn = store, [], None
            if mux:
                backend = open_backend(cfg)
                inner = base_backend(backend)
                real = inner.read_ranges
                inner.read_ranges = lambda name, r, b: batches.append(
                    len(r)) or real(name, r, b)
            t0 = time.perf_counter()
            try:
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                landing.reset_launches()
                res = cli.execute("stream", cfg, device="cuda",
                                  backend=backend, args=args)
                counts = {"land": landing.land.launches,
                          "checksum": landing.checksum.launches}
                peak = torch.cuda.max_memory_allocated() - held
                if mux:
                    conn = dict(inner._h2_pool().stats)
            finally:
                if mux:
                    backend.close()
            launches[f"stream/{mode}"] = counts
            _check_stream(mode, res, counts, peak, true_sums, batches, conn,
                          MUX_RANGES_PER_RANK)
            ex = res.extra
            emit({"phase": "stream", "mode": mode,
                  "objects": ex["objects"],
                  "objects_this_run": ex["objects_this_run"],
                  "object_size": OBJECT_SIZE, "bytes_total": res.bytes_total,
                  "verified": ex["verified"], "launches": counts,
                  "overlap_efficiency": ex["overlap_efficiency"],
                  **{k: ex[k] for k in ("fetch_seconds", "stage_seconds",
                                        "gather_seconds")},
                  "wall_s": res.wall_seconds, "gbps": res.gbps,
                  "peak_hbm_allocated_bytes": peak,
                  "hbm_held_before_bytes": held,
                  "resume": ex.get("resume"), "mux_batches": batches,
                  "native_conn_stats": conn,
                  "seconds": time.perf_counter() - t0,
                  "reduced": ["one rank (the machine has one H100)"]
                  + ([f"{STREAM_MODES[mode]} objects (the port's Python h2c "
                      "server moves 0.2-0.5 GB/s)"] if mux else []),
                  "card": smi})
    os.remove(snap)
    return launches


def _check_stream(mode: str, res, counts: dict, peak: int, true_sums: list,
                  batches: list, conn, ranges: int) -> None:
    import torch.distributed as dist

    ex = res.extra
    n = STREAM_MODES[mode]
    skipped = STREAM_MODES["stream"] if mode == "stream_resume" else 0
    ran = n - skipped
    check(not dist.is_initialized(), f"stream/{mode}: the group outlived the run")
    check(res.errors == 0 and ex["verified"] is True and not ex["holes_by_object"],
          f"stream/{mode}: errors {res.errors}, verified {ex['verified']}")
    check(ex["objects"] == n and ex["objects_this_run"] == ran,
          f"stream/{mode}: {ex['objects']} objects, {ex['objects_this_run']} run")
    check(res.bytes_total == ran * OBJECT_SIZE, f"stream/{mode}: {res.bytes_total} B")
    check(ex["object_checksums"] == true_sums[skipped:n],
          f"stream/{mode}: checksums {ex['object_checksums']} vs true "
          f"{true_sums[skipped:n]}")
    check(counts == {"land": 0, "checksum": ran + 1},
          f"stream/{mode}: launches {counts}, want {ran} objects + 1 warm-up")
    # The staged shard and its gather of one object (and the warm-up's),
    # never the stream's history.
    check(peak <= 4 * OBJECT_SIZE, f"stream/{mode}: peak HBM {peak} B")
    if mode == "stream_resume":
        r = ex["resume"]
        check(r["prior_found"] and r["objects_skipped"] == skipped
              and r["prior_bytes"] == skipped * OBJECT_SIZE,
              f"stream/{mode}: resume {r}")
    if mode.endswith("_mux"):
        check(batches == [ranges] * n and conn["connects"] == 1,
              f"stream/{mode}: batches {batches}, connections {conn}")


# ------------------------------------------------------------- phase 18 --
def phase_multichip(smi) -> dict:
    """``multichip-sweep --sizes 1,2 --shard-mb 8 --reps 1`` as the CLI
    runs it, its artifact under ``build/``: the ring algebra holds, every
    pod-ingest row verified, the size-1 child on the card over NCCL (its
    ``tb_checksum`` launches: the two collective calls of each of its two
    timed pod-ingest runs), the size-2 child two gloo ranks on the CPU."""
    import contextlib
    import io
    import os

    from tpubench_torch import cli
    from tpubench_torch.dist.sweep import ARTIFACT

    out_dir = f"{BUILD}/multichip"
    os.makedirs(out_dir, exist_ok=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*MULTICHIP, "--results-dir", out_dir])
    seconds = time.perf_counter() - t0
    with open(f"{out_dir}/{ARTIFACT}") as f:
        art = json.load(f)
    check(rc == 0 and art["ring_algebra_ok"],
          f"multichip: rc {rc}, violations {art['ring_algebra_violations']}")
    rows = {r["devices"]: r for r in art["pod_ingest"]}
    check(sorted(rows) == [1, 2], f"multichip: sizes {sorted(rows)}")
    for n, r in rows.items():
        for key in ("pod_ingest_all_gather", "pod_ingest_ring"):
            check(r[key]["verified"] is True and r[key]["errors"] == 0,
                  f"multichip: n={n} {key} {r[key]}")
    one, two = rows[1], rows[2]
    check((one["backend"], one["device"]) == ("nccl", "cuda"),
          f"multichip: size 1 ran {one['backend']} on {one['device']}")
    check((two["backend"], two["device"]) == ("gloo", "cpu"),
          f"multichip: size 2 ran {two['backend']} on {two['device']}")
    check(one["launches"] == {"land": 0, "checksum": 4},
          f"multichip: size-1 launches {one['launches']}")
    emit({"phase": "multichip", "argv": MULTICHIP, "seconds": seconds,
          "platform": art["platform"], "ring_algebra_ok": True,
          "rows": [{k: r[k] for k in ("devices", "backend", "device",
                                      "launches", "pod_ingest_all_gather",
                                      "pod_ingest_ring")}
                   for r in art["pod_ingest"]],
          "collectives": art["collectives"],
          "reduced": ["size 2 as two gloo ranks on the CPU (the machine has "
                      "one H100; NCCL takes one rank per GPU)"],
          "card": smi})
    return {"multichip/size1": one["launches"]}


# ------------------------------------------------------------- phase 19 --
# Phase train: `train-ingest` over phase read's store (48 x 100 MiB, the
# reference's deployment): 2 MiB chunks (the granule), 32 a step (64 MiB),
# 75 steps (one epoch is the 4.8 GiB dataset, every object once), 20 ms of
# step compute. TRAIN_STEPS_CUT are the modes whose steps were cut.
TRAIN_BATCH, TRAIN_STEPS, TRAIN_COMPUTE_MS = 32, 75, 20
TRAIN_WARM_STEPS, TRAIN_TUNE_STEPS = 16, 8
TRAIN_MODES = {
    "train_cold": ["--readahead", "0", "--staging", "device_put",
                   "--depth", "3"],
    "train_prefetch": ["--readahead", "64", "--prefetch-workers", "8",
                       "--cache-bytes", str(1 << 30), "--staging",
                       "device_put", "--depth", "3"],
    "train_validate": ["--validate"],
    "train_pallas": ["--staging", "pallas"],
    "train_bytes": ["--no-slab-pool", "--readahead", "64"],
    "train_warm": ["--steps", str(TRAIN_WARM_STEPS), "--epochs", "2",
                   "--readahead", "0", "--cache-bytes", str(1280 * MIB)],
    "train_pod": ["--pipeline-pod"],
}
# Phase coop: train-ingest with the cooperative cache at phase train's
# deployment (coop_validate: the loopback channel, one host; coop_ici: the
# lockstep channel on the one-rank NCCL group, which routes nothing at a
# pod of one), then the lockstep channel alone at the sizes below (the
# last one a 2 MiB chunk), then run_coop_sim's A/B at the acceptance
# settings of tests/test_coop.py with page-locked slab pools.
COOP_MODES = {
    "coop_validate": ["--validate", "--coop"],
    "coop_ici": ["--pipeline-pod", "--readahead", "0", "--coop",
                 "--coop-channel", "ici"],
}
COOP_CHANNEL_SIZES = (128, 1000, 4096, 2 * MIB)
COOP_CHANNEL_REPS = 20  # steady 2 MiB broadcasts, timed after the count
COOP_SIM = dict(accesses_per_host=96, alpha=1.2, seed=3, slab_pool=True)
COOP_SIM_FIELDS = ("origin_bytes_per_pod", "origin_fetches_per_pod",
                   "unique_chunks_fetched", "max_origin_fetches_per_chunk")
# (hosts, coop) -> COOP_SIM_FIELDS, as tpubench's run_coop_sim gives them
# on the CPU (tests/test_torch_coop.py::test_sim_parity holds the port's
# CPU run to the same numbers).
COOP_SIM_EXPECT = {
    (2, True): (7864320, 30, 30, 1), (2, False): (11534336, 44, 30, 2),
    (4, True): (8126464, 31, 31, 1), (4, False): (22282240, 85, 31, 4),
}
TRAIN_STEPS_CUT = {
    "train_warm": f"{TRAIN_WARM_STEPS} steps x 2 epochs (1 GiB, inside "
                  "the 1.25 GiB cache, so epoch 2 is all hits)",
    "tune_train": f"{TRAIN_TUNE_STEPS} steps a sweep cell",
}


class TrainObserved:
    """Keeps, for one train-ingest run, every call of the pod's collective
    (the group's backend, where the gather landed, the pod checksum) by
    wrapping the workload's ``make_reassemble``; what it builds and does
    is unchanged."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch.distributed as dist

        from tpubench_torch.workloads import train_ingest

        self._saved = make = train_ingest.make_reassemble

        def build(pod):
            fn = make(pod)

            def call(staged):
                gathered, csum = fn(staged)
                self.calls.append((dist.get_backend(pod.group),
                                   gathered.device.type, int(csum)))
                return gathered, csum

            return call

        train_ingest.make_reassemble = build
        return self

    def __exit__(self, *exc):
        from tpubench_torch.workloads import train_ingest

        train_ingest.make_reassemble = self._saved


def _train_argv(flags: list, steps: int = TRAIN_STEPS) -> list:
    """The train-ingest flags of phase train's deployment, then ``flags``
    (which may set ``--steps`` again: the last one wins)."""
    return ["--protocol", "fake", "--workers", str(WORKERS),
            "--object-size", str(OBJECT_SIZE), "--granule-bytes",
            str(GRANULE), "--chunk-bytes", str(GRANULE), "--batch-shards",
            str(TRAIN_BATCH), "--step-compute-ms", str(TRAIN_COMPUTE_MS),
            "--steps", str(steps), *flags]


def _step_sums(store, cfg) -> list:
    """The host's mod-2³² byte sum of every step's batch, from the plan
    and the store's own arrays (an independent count to hold the pod's
    device checksums against)."""
    import numpy as np

    from tpubench_torch.workloads.train_ingest import build_plan

    plan = build_plan(cfg, store)
    b = cfg.pipeline.batch_shards
    return [sum(int(store._objects[k.object][k.start:k.start + k.length]
                    .sum(dtype=np.uint64)) for k in plan[i:i + b]) % MOD
            for i in range(0, len(plan), b)]


def _train_line(mode: str, res, counts: dict, seconds: float, smi) -> dict:
    pipe = res.extra["pipeline"]
    stall, cache, pf, cp = (pipe["stall"], pipe["cache"], pipe["prefetch"],
                            pipe["copies"])
    st = res.extra.get("staging") or {}
    stage = res.summaries.get("stage")
    return {
        "phase": "train", "mode": mode, "steps": stall["steps"],
        "batch_shards": pipe["plan"]["batch_shards"],
        "chunk_bytes": pipe["plan"]["chunk_bytes"],
        "bytes_total": res.bytes_total, "wall_s": res.wall_seconds,
        "gbps_per_chip": res.gbps_per_chip, "n_chips": res.n_chips,
        "stall_p50_ms": stall["p50_ms"], "stall_p99_ms": stall["p99_ms"],
        "stalled_fraction": stall["stalled_fraction"],
        "cache": {k: cache[k] for k in ("hits", "misses", "coalesced",
                                        "hit_ratio", "evictions")},
        "prefetch": None if pf is None else {
            k: pf[k] for k in ("issued", "completed", "skipped", "cancelled",
                               "errors", "used_bytes", "wasted_bytes",
                               "efficiency")},
        "copies_per_byte": cp["copies_per_byte"], "copies_mode": cp["mode"],
        "pool": cp.get("pool"),
        "pool_pin_seconds": pipe.get("pool_pin_seconds"),
        "transfers": st.get("transfers",
                            stage.count if stage is not None else None),
        "staged_bytes": res.extra.get("staged_bytes"),
        "checksum_ok": res.extra.get("checksum_ok"),
        "staging_efficiency": st.get("staging_efficiency"),
        "launches": counts, "seconds": seconds, "card": smi,
    }


def _check_train(mode: str, res, counts: dict, obs, step_sums) -> None:
    pipe = res.extra["pipeline"]
    steps = pipe["stall"]["steps"]
    chunk = GRANULE
    check(res.errors == 0, f"train/{mode}: errors {res.errors}")
    check(res.bytes_total == steps * TRAIN_BATCH * chunk,
          f"train/{mode}: {res.bytes_total} B for {steps} steps")
    cp = pipe["copies"]
    slab = mode != "train_bytes"
    if slab:
        pool = cp["pool"]
        check(cp["mode"] == "slab" and pool["leaked_slabs"] == 0
              and pool["native"] is True,
              f"train/{mode}: copies {cp}")
        check(cp["copies_per_byte"] == 1.0,
              f"train/{mode}: {cp['copies_per_byte']} copies a byte")
    else:
        check(cp["mode"] == "bytes" and cp["copies_per_byte"] >= 2.0,
              f"train/{mode}: copies {cp}")
    pod = mode == "train_pod"
    stage = res.summaries.get("stage")
    transfers = None if pod else stage.count
    if not pod:
        check(res.extra["staged_bytes"] == res.bytes_total,
              f"train/{mode}: staged {res.extra['staged_bytes']}")
    if mode in ("train_cold", "train_prefetch", "train_bytes", "train_warm"):
        st = res.extra["staging"]
        check(st["drain"] == "overlap" and st["transfers"] == transfers,
              f"train/{mode}: staging {st}")
    if mode in ("train_cold", "train_prefetch", "train_warm"):
        # submit_owned: the window copies each lease in place.
        check(transfers == steps * TRAIN_BATCH,
              f"train/{mode}: {transfers} transfers for "
              f"{steps * TRAIN_BATCH} chunks")
    want = {"land": 0, "checksum": 0}
    if mode in ("train_validate", "train_pallas"):
        ring = "pallas" if mode == "train_pallas" else "device_put"
        slot = _slot(_config(WORKERS, OBJECT_SIZE, GRANULE,
                             "pallas" if ring == "pallas"
                             else "device_put_validate"))
        n = expected_transfers(steps * TRAIN_BATCH * chunk, GRANULE, slot)
        check(transfers == n, f"train/{mode}: {transfers} transfers, "
              f"want {n} of {slot} B")
        check(res.extra.get("checksum_ok") is True,
              f"train/{mode}: checksum {res.extra.get('checksum_ok')}")
        want["land" if ring == "pallas" else "checksum"] = transfers
    if pod:
        want["checksum"] = steps + 1
        check(len(obs.calls) == steps + 1,
              f"train/{mode}: {len(obs.calls)} collective calls")
        check(all(b == "nccl" and d == "cuda" for b, d, _ in obs.calls),
              f"train/{mode}: calls {obs.calls[:2]}")
        sums = [c for _, _, c in obs.calls]
        check(sums[0] == 0 and sums[1:] == step_sums,
              f"train/{mode}: device checksums differ from the host's")
        check(res.n_chips == 1, f"train/{mode}: n_chips {res.n_chips}")
    check(counts == want, f"train/{mode}: launches {counts}, want {want}")
    pf = pipe["prefetch"]
    if pf is not None:
        check(pf["errors"] == 0, f"train/{mode}: prefetch errors {pf}")
        check(pf["prefetched_bytes"] == pf["completed"] * chunk
              and pf["used_bytes"] + pf["wasted_bytes"]
              == pf["prefetched_bytes"]
              + pipe["cache"]["prefetch_dropped_bytes"],
              f"train/{mode}: prefetch accounting {pf}")
    if mode == "train_warm":
        n = TRAIN_WARM_STEPS * TRAIN_BATCH
        check((pipe["cache"]["hits"], pipe["cache"]["misses"]) == (n, n),
              f"train/{mode}: cache {pipe['cache']}")


def phase_train(store, smi) -> tuple[dict, dict]:
    """``train-ingest`` through ``cli.execute`` over phase read's store,
    in each mode of TRAIN_MODES, then ``tune --tune-workload train-ingest``
    (a sweep, and an online session). Every mode: zero errors, every
    step's bytes delivered, no slab leaked, the copies per byte of its
    arm; the rings' kernels launched once per transfer, the overlapped
    window one transfer per chunk, the pod's ``tb_checksum`` once per step
    and once for the warm-up, each step's pod sum the host's. Returns the
    launch counts and each mode's line."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    launches, lines = {}, {}
    t_phase = time.perf_counter()
    for mode in TRAIN_MODES:
        args, cfg = _cli(["train-ingest", *_train_argv(TRAIN_MODES[mode])])
        step_sums = _step_sums(store, cfg) if mode == "train_pod" else None
        buf = io.StringIO()
        with TrainObserved() as obs, contextlib.redirect_stdout(buf):
            landing.reset_launches()
            t0 = time.perf_counter()
            res = cli.execute("train-ingest", cfg, device="cuda",
                              backend=store, args=args)
            seconds = time.perf_counter() - t0
            counts = {"land": landing.land.launches,
                      "checksum": landing.checksum.launches}
        check("== ingest-pipeline scorecard ==" in buf.getvalue(),
              f"train/{mode}: no scorecard printed")
        _check_train(mode, res, counts, obs, step_sums)
        launches[f"train/{mode}"] = counts
        lines[mode] = _train_line(mode, res, counts, seconds, smi)
        if mode in TRAIN_STEPS_CUT:
            lines[mode]["reduced"] = [TRAIN_STEPS_CUT[mode]]
        if mode == "train_pod":
            lines[mode]["reduced"] = ["one rank (the machine has one H100)"]
            lines[mode]["step_checksums_checked"] = len(step_sums)
        if mode == "train_prefetch":
            cold = lines["train_cold"]
            lines[mode]["vs_cold"] = {
                k: [cold[k], lines[mode][k]]
                for k in ("stall_p50_ms", "stall_p99_ms", "stalled_fraction",
                          "gbps_per_chip")}
        emit(lines[mode])
    launches.update(_tune_train(store, smi))
    emit({"phase": "train_total", "seconds": time.perf_counter() - t_phase,
          "reduced": [f"{m}: {r}" for m, r in TRAIN_STEPS_CUT.items()]
          + ["train_pod: one rank"]})
    return launches, lines


def _tune_train(store, smi) -> dict:
    """``tune --tune-workload train-ingest --tune-mode sweep`` at
    TRAIN_TUNE_STEPS steps a cell, then one online session inside
    ``train-ingest --tune`` (readahead and prefetch workers, 0.2 s
    windows): every cell without errors and with goodput, ``extra.tune``
    stamped."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    out = {}
    for mode, argv, cmd in (
        ("tune_train", ["tune", "--tune-workload", "train-ingest",
                        "--tune-mode", "sweep",
                        *_train_argv([], steps=TRAIN_TUNE_STEPS)], "tune"),
        ("tune_train_online", ["train-ingest", *_train_argv([
            "--tune", "--tune-window", "0.2", "--tune-knobs",
            "readahead,prefetch_workers"])], "train-ingest"),
    ):
        args, cfg = _cli(argv)
        buf = io.StringIO()
        landing.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.execute(cmd, cfg, device="cuda", backend=store,
                              args=args)
        seconds = time.perf_counter() - t0
        counts = {"land": landing.land.launches,
                  "checksum": landing.checksum.launches}
        check(counts == {"land": 0, "checksum": 0},
              f"train/{mode}: launches {counts}")
        tune = res.extra.get("tune")
        check(tune is not None, f"train/{mode}: extra.tune not stamped")
        line = {"phase": "train", "mode": mode, "launches": counts,
                "seconds": seconds, "card": smi}
        if cmd == "tune":
            sw = tune["sweep"]
            check(set(sw["axes"]) == {"readahead", "prefetch_workers",
                                      "staging_depth"},
                  f"train/{mode}: axes {sw['axes']}")
            check(all(c["errors"] == 0 and c["goodput_bps"] > 0
                      for c in sw["cells"]),
                  f"train/{mode}: cells {sw['cells']}")
            line.update(axes=sw["axes"], cells=[
                {**c["values"], "goodput_gbps": c["goodput_bps"] / 1e9,
                 "read_p99_ms": c["p99_ms"]} for c in sw["cells"]],
                best=sw["best"]["values"], recommended=tune["recommended"],
                reduced=[TRAIN_STEPS_CUT["tune_train"]])
        else:
            check(res.errors == 0 and tune.get("error") is None
                  and tune["n_windows"] >= 2,
                  f"train/{mode}: errors {res.errors}, tune {tune}")
            check(res.bytes_total == TRAIN_STEPS * TRAIN_BATCH * GRANULE,
                  f"train/{mode}: {res.bytes_total} B")
            line.update(n_windows=tune["n_windows"],
                        initial=tune["initial"], final=tune["final"],
                        accepts=tune.get("accepts"),
                        reverts=tune.get("reverts"),
                        gbps_per_chip=res.gbps_per_chip)
        emit(line)
        out[f"train/{mode}"] = counts
    return out


class ChannelObserved:
    """Keeps every lockstep channel a run builds, by replacing
    ``tpubench_torch.dist.peer.IciPeerChannel`` (which ``coop_from_config``
    looks up at each build) with a subclass that notes its instances; what
    the channel does is unchanged."""

    def __enter__(self):
        from tpubench_torch.dist import peer

        self._saved = base = peer.IciPeerChannel
        made = self.channels = []

        class Kept(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)

        peer.IciPeerChannel = Kept
        return self

    def __exit__(self, *exc):
        from tpubench_torch.dist import peer

        peer.IciPeerChannel = self._saved


def _check_coop(mode: str, res, counts: dict, obs, chans, step_sums,
                train_transfers) -> None:
    pipe = res.extra["pipeline"]
    steps = pipe["stall"]["steps"]
    check(res.errors == 0, f"coop/{mode}: errors {res.errors}")
    check(res.bytes_total == steps * TRAIN_BATCH * GRANULE,
          f"coop/{mode}: {res.bytes_total} B for {steps} steps")
    cp = pipe["copies"]
    check(cp["mode"] == "slab" and cp["pool"]["leaked_slabs"] == 0
          and cp["pool"]["native"] is True and cp["copies_per_byte"] == 1.0,
          f"coop/{mode}: copies {cp}")
    co, pf = pipe["coop"], pipe["prefetch"]
    # Every origin fetch is a demand miss or a completed prefetch: both
    # route through the cooperative cache (the cache's misses alone at
    # readahead 0).
    fetched = pipe["cache"]["misses"] + (pf["completed"] if pf else 0)
    check(co["enabled"] and co["hosts"] == co["active_hosts"] == 1
          and co["peer_requests"] == 0 and co["owner_fetches"] == 0
          and co["origin_fetches"] == fetched > 0,
          f"coop/{mode}: coop {co}, cache {pipe['cache']}, prefetch {pf}")
    if mode == "coop_validate":
        transfers = res.summaries["stage"].count
        slot = _slot(_config(WORKERS, OBJECT_SIZE, GRANULE,
                             "device_put_validate"))
        n = expected_transfers(steps * TRAIN_BATCH * GRANULE, GRANULE, slot)
        check(transfers == n == train_transfers,
              f"coop/{mode}: {transfers} transfers, want {n} "
              f"(train_validate: {train_transfers})")
        check(res.extra.get("checksum_ok") is True
              and res.extra["staged_bytes"] == res.bytes_total,
              f"coop/{mode}: checksum {res.extra.get('checksum_ok')}")
        want = {"land": 0, "checksum": transfers}
        check(not chans.channels, f"coop/{mode}: a lockstep channel built")
    else:
        want = {"land": 0, "checksum": steps + 1}
        check(len(obs.calls) == steps + 1
              and all(b == "nccl" and d == "cuda" for b, d, _ in obs.calls),
              f"coop/{mode}: calls {obs.calls[:2]} of {len(obs.calls)}")
        sums = [c for _, _, c in obs.calls]
        check(sums[0] == 0 and sums[1:] == step_sums,
              f"coop/{mode}: device checksums differ from the host's")
        check(len(chans.channels) == 1
              and chans.channels[0].stats()["broadcasts"] == 0,
              f"coop/{mode}: channels {[c.stats() for c in chans.channels]}")
    check(counts == want, f"coop/{mode}: launches {counts}, want {want}")


def _channel_parts(data: bytes) -> dict:
    """Where a steady broadcast of ``data`` goes, step by step as the
    channel takes them (ms, mean of COOP_CHANNEL_REPS, each step waited
    for): the host copy into a page-locked buffer, its copy to the card,
    the all-gather with the pod checksum, and the owner's slot back to
    the host as bytes. Timed after the launch count is read."""
    import numpy as np
    import torch

    from tpubench_torch.dist.reassemble import (
        make_mesh,
        make_reassemble,
        shard_to_device_array,
    )

    n, lane = len(data), 128
    pod = make_mesh(device="cuda")
    gather = make_reassemble(pod)
    host = torch.zeros(-(-n // lane) * lane, dtype=torch.uint8,
                       pin_memory=True)
    flat, src = host.numpy(), np.frombuffer(data, dtype=np.uint8)
    sums = dict.fromkeys(("fill", "h2d", "gather", "d2h"), 0.0)
    for _ in range(COOP_CHANNEL_REPS):
        t0 = time.perf_counter()
        flat[:n] = src
        t1 = time.perf_counter()
        staged = shard_to_device_array([host], pod, lane)
        staged.event.synchronize()
        t2 = time.perf_counter()
        gathered, _ = gather(staged)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out = gathered.view(pod.size, -1)[0, :n].cpu().numpy().tobytes()
        t4 = time.perf_counter()
        check(out == data, "coop/channel: the timed parts' echo differs")
        for k, dt in zip(sums, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            sums[k] += dt
    return {k: v * 1e3 / COOP_CHANNEL_REPS for k, v in sums.items()}


def _coop_channel(smi) -> dict:
    """``IciPeerChannel.broadcast`` on the one-rank NCCL group at
    COOP_CHANNEL_SIZES, after a warm-up channel has set the communicator
    up: every echo bit-exact, one ``tb_checksum`` a broadcast; then the
    steady time of a 2 MiB broadcast."""
    import torch.distributed as dist

    from tpubench_torch.config import DistConfig
    from tpubench_torch.dist import bringup
    from tpubench_torch.dist.peer import IciPeerChannel
    from tpubench_torch.kernels import landing
    from tpubench_torch.pipeline.cache import ChunkKey
    from tpubench_torch.storage.base import deterministic_bytes

    keys = {n: ChunkKey("tpubench", f"coop/chunk_{n}", 1, 0, n)
            for n in COOP_CHANNEL_SIZES}
    datas = {n: deterministic_bytes(k.object, n).tobytes()
             for n, k in keys.items()}
    big = COOP_CHANNEL_SIZES[-1]
    with bringup.session(DistConfig(), "cuda", one_rank_group=True):
        check(dist.get_backend() == "nccl", "coop/channel: group not NCCL")
        warm = IciPeerChannel(device="cuda")
        for n, k in keys.items():
            warm.broadcast(0, datas[n], k)
        warm.close()
        ch = IciPeerChannel(device="cuda")
        landing.reset_launches()
        first_ms = {}
        for n, k in keys.items():
            t0 = time.perf_counter()
            got = ch.broadcast(0, datas[n], k)
            first_ms[n] = (time.perf_counter() - t0) * 1e3
            check(got == datas[n], f"coop/channel: {n} B echo differs")
        counts = {"land": landing.land.launches,
                  "checksum": landing.checksum.launches}
        st = ch.stats()
        check(st["broadcasts"] == len(keys)
              and counts == {"land": 0, "checksum": len(keys)},
              f"coop/channel: stats {st}, launches {counts}")
        t0 = time.perf_counter()
        for _ in range(COOP_CHANNEL_REPS):
            check(ch.broadcast(0, datas[big], keys[big]) == datas[big],
                  "coop/channel: steady echo differs")
        steady_ms = (time.perf_counter() - t0) * 1e3 / COOP_CHANNEL_REPS
        ch.close()
        parts = _channel_parts(datas[big])
    emit({"phase": "coop", "mode": "channel", "broadcasts": st["broadcasts"],
          "broadcast_bytes": st["broadcast_bytes"], "launches": counts,
          "ms_per_broadcast": {str(n): v for n, v in first_ms.items()},
          "steady_ms_per_2mib_broadcast": steady_ms,
          "steady_gbps": big / (steady_ms / 1e3) / 1e9,
          "steady_parts_ms": parts,
          "reps": COOP_CHANNEL_REPS, "card": smi,
          "reduced": ["world size 1 (the machine has one H100): the owner's "
                      "own slot, no peer on the wire"]})
    return counts


def _coop_sim(smi) -> None:
    """``run_coop_sim`` coop on / off at 2 and 4 hosts with page-locked
    slab pools: the pod counters equal ``tpubench``'s CPU numbers
    (COOP_SIM_EXPECT) and the port's own CPU run; zero errors, <= 1.0
    copies a byte."""
    from tpubench_torch.pipeline.coop import run_coop_sim

    for hosts in (2, 4):
        arms = {}
        for coop in (True, False):
            t0 = time.perf_counter()
            r = run_coop_sim(n_hosts=hosts, coop=coop, device="cuda",
                             **COOP_SIM)
            call_s = time.perf_counter() - t0
            cpu = run_coop_sim(n_hosts=hosts, coop=coop, device="cpu",
                               **COOP_SIM)
            got = tuple(r[f] for f in COOP_SIM_FIELDS)
            check(not r["errors"] and r["copies_per_byte_ok"],
                  f"coop/sim_{hosts}: {r['errors']}")
            check(got == COOP_SIM_EXPECT[(hosts, coop)]
                  == tuple(cpu[f] for f in COOP_SIM_FIELDS)
                  and r["peer_hits"] + r["peer_misses"]
                  == cpu["peer_hits"] + cpu["peer_misses"],
                  f"coop/sim_{hosts}: {got} (coop={coop}) against "
                  f"{COOP_SIM_EXPECT[(hosts, coop)]}")
            arms["coop" if coop else "per_host"] = dict(
                r, call_seconds=call_s, cpu_seconds=cpu["seconds"])
        c, b = arms["coop"], arms["per_host"]
        check(c["max_origin_fetches_per_chunk"] == 1
              and c["peer_hit_ratio"] == 1.0,
              f"coop/sim_{hosts}: {c['max_origin_fetches_per_chunk']} "
              f"fetches a chunk, peer hits {c['peer_hit_ratio']}")
        emit({"phase": "coop", "mode": f"sim_{hosts}hosts",
              "origin_bytes_saved_ratio":
                  1.0 - c["origin_bytes_per_pod"] / b["origin_bytes_per_pod"],
              **{f"{arm}_{f}": a[f] for arm, a in arms.items()
                 for f in COOP_SIM_FIELDS},
              "peer_hits": c["peer_hits"],
              "copies_per_byte_ok": [c["copies_per_byte_ok"],
                                     b["copies_per_byte_ok"]],
              "seconds": {arm: a["seconds"] for arm, a in arms.items()},
              "call_seconds": {arm: a["call_seconds"]
                               for arm, a in arms.items()},
              "cpu_seconds": {arm: a["cpu_seconds"]
                              for arm, a in arms.items()},
              "card": smi})


def phase_coop(store, smi, train_lines: dict) -> dict:
    """``train-ingest --coop`` through ``cli.execute`` at phase train's
    deployment (COOP_MODES), the lockstep channel alone, and the
    simulation's A/B. Every mode: zero errors, every step's bytes
    delivered, no slab leaked, the coop stamp of a pod of one (no peer
    request, origin fetches = the cache's misses) and the scorecard's coop
    line printed; coop_validate's ``tb_checksum`` once a transfer,
    coop_ici's once a step and once for the warm-up with each step's pod
    sum the host's, and its channel built on NCCL with no broadcast."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    launches = {}
    t_phase = time.perf_counter()
    for mode, flags in COOP_MODES.items():
        args, cfg = _cli(["train-ingest", *_train_argv(flags)])
        step_sums = _step_sums(store, cfg) if mode == "coop_ici" else None
        buf = io.StringIO()
        with TrainObserved() as obs, ChannelObserved() as chans, \
                contextlib.redirect_stdout(buf):
            landing.reset_launches()
            t0 = time.perf_counter()
            res = cli.execute("train-ingest", cfg, device="cuda",
                              backend=store, args=args)
            seconds = time.perf_counter() - t0
            counts = {"land": landing.land.launches,
                      "checksum": landing.checksum.launches}
        text = buf.getvalue()
        check("== ingest-pipeline scorecard ==" in text
              and "  coop: hosts=1/1 " in text,
              f"coop/{mode}: no scorecard coop line printed")
        _check_coop(mode, res, counts, obs, chans, step_sums,
                    train_lines["train_validate"]["transfers"])
        line = {**_train_line(mode, res, counts, seconds, smi),
                "phase": "coop",
                "coop": {k: res.extra["pipeline"]["coop"][k] for k in (
                    "hosts", "active_hosts", "peer_requests", "peer_hits",
                    "origin_fetches", "origin_bytes", "owner_fetches")}}
        if mode == "coop_validate":
            tv = train_lines["train_validate"]
            line["vs_train_validate"] = {
                k: [tv[k], line[k]] for k in ("gbps_per_chip", "wall_s",
                                              "stall_p50_ms")}
        else:
            tp = train_lines["train_pod"]
            line["vs_train_pod"] = {
                k: [tp[k], line[k]] for k in ("gbps_per_chip", "wall_s")}
            line["broadcasts"] = chans.channels[0].stats()["broadcasts"]
            line["step_checksums_checked"] = len(step_sums)
            line["reduced"] = ["one rank (the machine has one H100): a pod "
                               "of one routes nothing"]
        emit(line)
        launches[f"coop/{mode}"] = counts
    launches["coop/channel"] = _coop_channel(smi)
    _coop_sim(smi)
    emit({"phase": "coop_total", "seconds": time.perf_counter() - t_phase,
          "reduced": ["coop_ici and channel: one rank (several ranks run "
                      "only as gloo groups on the CPU)"]})
    return launches



class RestoreObserved:
    """Keeps every ``StagedShards`` a restore makes, by wrapping
    ``dist.reassemble.shard_to_device_array`` (``workloads.ckpt`` looks it
    up at each call); what it stages is unchanged. ``compare`` then holds
    each staged tensor against its object's bytes in ``store``, on the
    card."""

    def __init__(self):
        from tpubench_torch.dist import reassemble

        self.mod, self.made = reassemble, []

    def __enter__(self):
        self.real = self.mod.shard_to_device_array

        def kept(*a, **kw):
            st = self.real(*a, **kw)
            self.made.append(st)
            return st

        self.mod.shard_to_device_array = kept
        return self

    def __exit__(self, *exc):
        self.mod.shard_to_device_array = self.real

    def compare(self, store, names: list, size: int) -> tuple[int, bool]:
        """(staged tensors equal to their objects, all on the card); one
        rank, so each object's one shard is the whole object."""
        import torch

        equal, on_card = 0, len(self.made) == len(names)
        for name, st in zip(names, self.made):
            staged = st.ready()
            on_card &= staged.is_cuda
            want = torch.from_numpy(store._objects[name]).to(staged.device)
            equal += bool(torch.equal(staged.reshape(-1)[:size], want))
        self.made.clear()
        return equal, on_card


def _ckpt_mode(mode: str, smi) -> dict:
    """One checkpoint mode: save, then restore onto the card, on a store
    of its own; every check of phase ckpt; the mode's line."""
    import contextlib
    import io

    import numpy as np
    import torch

    from tpubench_torch import cli
    from tpubench_torch.lifecycle.manifest import (
        manifest_name,
        shard_object_name,
    )
    from tpubench_torch.storage import base_backend, open_backend
    from tpubench_torch.storage.base import deterministic_bytes
    from tpubench_torch.workloads.chaos import hermetic_target

    proto, faulted, objects = CKPT_MODES[mode]
    _, cfg = _cli([
        "ckpt-save", "--protocol", proto, "--bucket", "ckpt-bucket",
        "--ckpt-objects", str(objects),
        "--ckpt-object-bytes", str(CKPT_OBJECT_BYTES),
        "--ckpt-part-bytes", str(CKPT_PART_BYTES),
        "--ckpt-writers", str(CKPT_WORKERS),
        "--ckpt-readers", str(CKPT_WORKERS), "--workers", "1",
        "--object-size", "1",
    ])
    t = cfg.transport
    t.directpath = False  # the gRPC fake is no Google endpoint
    t.retry.initial_backoff_s, t.retry.max_backoff_s = 0.001, 0.01
    t.retry.deadline_s = 60.0
    if faulted:
        for k, v in CKPT_FAULT.items():
            setattr(t.fault, k, v)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        modes = stack.enter_context(GrpcModes())
        if proto == "fake":
            backend = open_backend(cfg)  # retry over a store of one object
            store = base_backend(backend)
        else:
            backend = None
            store = stack.enter_context(hermetic_target(cfg)).backend
        stack.enter_context(contextlib.redirect_stdout(buf))
        save = cli.execute("ckpt-save", cfg, device="cuda", backend=backend)
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with RestoreObserved() as obs:
            restore = cli.execute("ckpt-restore", cfg, device="cuda",
                                  backend=backend)
        peak = torch.cuda.max_memory_allocated() - held
        check("lifecycle [save]" in buf.getvalue()
              and "lifecycle [restore]" in buf.getvalue(),
              f"ckpt/{mode}: no scorecard printed")
        ls, lr = save.extra["lifecycle"], restore.extra["lifecycle"]
        check(save.errors == 0 and ls["corrupt_finalizes"] == 0
              and ls["verified"] is True,
              f"ckpt/{mode}: save errors {save.errors}, {ls}")
        check(ls["parts"] == objects * (CKPT_OBJECT_BYTES // CKPT_PART_BYTES),
              f"ckpt/{mode}: {ls['parts']} parts")
        check(ls["resumed_parts"] > 0 if faulted else True,
              f"ckpt/{mode}: no resumed part under faults")
        names = [shard_object_name("ckpt/", i) for i in range(objects)]
        stored_ok = all(
            np.array_equal(store._objects[n],
                           deterministic_bytes(n, CKPT_OBJECT_BYTES))
            for n in names)
        check(stored_ok, f"ckpt/{mode}: stored bytes differ")
        check(store.stat(manifest_name("ckpt/")).size > 0,
              f"ckpt/{mode}: no manifest")
        check(restore.errors == 0 and lr["verified"] is True
              and lr["staged"] is True and lr["shards_per_object"] == 1
              and restore.n_chips == 1,
              f"ckpt/{mode}: restore errors {restore.errors}, {lr}")
        equal, on_card = obs.compare(store, names, CKPT_OBJECT_BYTES)
        check(equal == objects and on_card,
              f"ckpt/{mode}: {equal}/{objects} staged tensors equal on the "
              f"card (all on the card: {on_card})")
    check(modes.mode == ("library" if proto == "grpc" else None),
          f"ckpt/{mode}: gRPC in {modes.mode} mode")
    part = ls["part_latency"]
    line = {
        "phase": "ckpt", "mode": mode, "protocol": proto,
        "objects": objects, "object_bytes": CKPT_OBJECT_BYTES,
        "part_bytes": CKPT_PART_BYTES, "writers": CKPT_WORKERS,
        "readers": CKPT_WORKERS, "fault": CKPT_FAULT if faulted else None,
        "save": {"gbps": ls["goodput_gbps"], "wall_s": save.wall_seconds,
                 "parts": ls["parts"], "resumed_parts": ls["resumed_parts"],
                 "part_p50_ms": part["p50_ms"], "part_p99_ms": part["p99_ms"],
                 "corrupt_finalizes": ls["corrupt_finalizes"]},
        "restore": {k: lr[k] for k in ("time_to_restore_s", "fetch_seconds",
                                       "stage_seconds")}
        | {"gbps": lr["goodput_gbps"], "staged_equal_on_card": equal},
        "peak_hbm_allocated_bytes": peak,
        "stored_bytes_equal": stored_ok, "seconds": time.perf_counter() - t0,
        "card": smi,
    }
    if mode == "ckpt_grpc":
        line["grpc_mode"] = modes.mode
        line["reduced"] = [f"{objects} x 128 MiB (the gRPC path runs "
                           "5-7x slower than HTTP/1.1 against the Python "
                           "fakes)"]
    return line


def _results_upload(store, smi) -> dict:
    """``read --protocol http --results-bucket`` at phase read's deployment
    (the validating ring) behind the HTTP/1.1 fake over ``store``; the
    stored ``results/<file>`` must equal the result file."""
    import contextlib
    import io
    import os

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage.fake_server import FakeGcsServer

    t0 = time.perf_counter()
    with FakeGcsServer(store) as srv:
        args, cfg = _cli([
            "read", "--protocol", "http", "--endpoint", srv.endpoint,
            "--bucket", "testbucket", "--object-name-prefix",
            "tpubench/file_", "--workers", str(WORKERS),
            "--read-call-per-worker", "1", "--object-size", str(OBJECT_SIZE),
            "--granule-bytes", str(GRANULE), "--staging", "device_put",
            "--validate", "--results-bucket", "results-bucket",
        ])
        landing.reset_launches()
        res = cli.execute("read", cfg, device="cuda", args=args)
        counts = {"land": landing.land.launches,
                  "checksum": landing.checksum.launches}
        with contextlib.redirect_stdout(io.StringIO()):
            path = cli.finish(res, cfg, pod_collective=False)
    name = f"results/{os.path.basename(path)}"
    with open(path, "rb") as f:
        local = f.read()
    same = store._objects[name].tobytes() == local
    transfers = WORKERS * expected_transfers(OBJECT_SIZE, GRANULE, _slot(cfg))
    check(res.errors == 0 and res.extra["checksum_ok"] is True
          and res.bytes_total == WORKERS * OBJECT_SIZE,
          f"ckpt/results_upload: errors {res.errors}, checksum_ok "
          f"{res.extra.get('checksum_ok')}, {res.bytes_total} B")
    check(counts == {"land": 0, "checksum": transfers},
          f"ckpt/results_upload: launches {counts}, want {transfers}")
    check(same, f"ckpt/results_upload: stored {name} differs from {path}")
    emit({"phase": "ckpt", "mode": "results_upload", "object": name,
          "result_bytes": len(local), "stored_equal": same,
          "read_gbps": res.gbps, "bytes_total": res.bytes_total,
          "launches": counts, "seconds": time.perf_counter() - t0,
          "card": smi})
    return counts


def phase_ckpt(store, smi) -> dict:
    """The checkpoint pair in each of CKPT_MODES, then results_upload
    over phase read's store (the one path here that launches a kernel)."""
    t_phase = time.perf_counter()
    for mode in CKPT_MODES:
        emit(_ckpt_mode(mode, smi))
    counts = _results_upload(store, smi)
    emit({"phase": "ckpt_total", "seconds": time.perf_counter() - t_phase,
          "reduced": ["ckpt_grpc: 4 of 16 objects", "one rank: a shard an "
                      "object (several ranks run only as gloo groups on "
                      "the CPU)"]})
    return {"ckpt/results_upload": counts}


# ------------------------------------------------------------- phase 22 --
# Phase serve: the open-loop serve plane over phase read's store (48 x
# 100 MiB, 2 MiB chunks) at tpubench's ServeConfig defaults (100 tenants
# in gold/silver/best_effort, Poisson 200/s, 8 workers, Zipf 1.2, QoS on).
# The QoS A/B and the sweep run at the reference acceptance's overload
# ratio and request size (tests/test_serve.py:446-533): 64 KiB requests,
# 4 ms a read with the cache off, so the 4 ms, not the host's copies of
# a 2 MiB request, set the capacity: 8 workers give 2,000/s; the A/B
# offers 3,200/s, the sweep steps 0.25x-4x of 800/s across it.
SERVE_SVC_S, SERVE_SVC_CHUNK = 0.004, 64 * 1024
SERVE_MODES = {
    "serve_default": dict(argv=[], seconds=4.0),
    "serve_qos": dict(argv=["--cache-bytes", "0", "--serve-rate", "3200"],
                      seconds=2.0, svc=True),
    "serve_fifo": dict(argv=["--cache-bytes", "0", "--serve-rate", "3200",
                             "--no-serve-qos"], seconds=2.0, svc=True),
    "serve_bursty": dict(argv=["--serve-arrival", "bursty",
                               "--serve-burst-factor", "4",
                               "--serve-burst-fraction", "0.25"],
                         seconds=4.0),
    "serve_sweep": dict(argv=["--serve-sweep", "--cache-bytes", "0",
                              "--serve-rate", "800"], seconds=2.0, svc=True),
    "serve_reactor": dict(argv=["--fetch-executor", "native"], seconds=2.0),
    "serve_elastic": dict(argv=["--serve-hosts", "4", "--membership-timeline",
                                json.dumps([[1.2, 1.2, {"kill_host": 1}],
                                            [2.4, 2.4, {"rejoin_host": 1}]])],
                          seconds=4.0),
}
SERVE_REDUCED = [
    "serve_qos, serve_fifo: 2 s of schedule (default 4 s)",
    "serve_sweep: 2 s a point (default 4 s)",
    "serve_reactor: 2 s of schedule (default 4 s)",
]
# Phase chaos: each arm at its phase's deployment, with a fault window
# inside the run. Read: 3 reads a worker (phase read runs 1), a 0.4 s stall
# in half the readers past 32 MiB during [2.4, 3.6] s. Pod: phase pod's
# 1 GiB object, a 0.2 s stall at the first byte during [0, 1] s (the
# shard's fetch reads it into its buffer in one call, so a stall set past
# a byte count never fires). Train: phase
# train's deployment at 20 of 75 steps through the validating ring, every
# read opened in [0.1, 0.6] s blackholed (an hour's stall) under hedged
# reads and the watchdog. Serve: a 4-host elastic pod at the serve
# defaults (3 s), host 2 killed at 1.0 s while half the readers stall
# 50 ms in [0.5, 2.0] s.
CHAOS_READS = 3
CHAOS_TRAIN_STEPS = 20
CHAOS_MODES = {
    "chaos_read_validate": dict(
        workload="read", argv=["--staging", "device_put", "--validate"],
        timeline=[[2.4, 3.6, {"stall_s": 0.4, "stall_rate": 0.5,
                              "stall_after_bytes": 32 * MIB}]]),
    "chaos_read_pallas": dict(
        workload="read", argv=["--staging", "pallas"],
        timeline=[[2.4, 3.6, {"stall_s": 0.4, "stall_rate": 0.5,
                              "stall_after_bytes": 32 * MIB}]]),
    "chaos_pod": dict(
        workload="pod-ingest", argv=[],
        timeline=[[0.0, 1.0, {"stall_s": 0.2, "stall_rate": 1.0,
                              "stall_after_bytes": 0}]]),
    "chaos_train": dict(
        workload="train-ingest", argv=["--validate"], blackhole=(0.1, 0.5),
        timeline=None),
    "chaos_serve": dict(
        workload="serve", argv=["--serve-hosts", "4",
                                "--serve-duration", "3"],
        timeline=[[1.0, 1.0, {"kill_host": 2}],
                  [0.5, 2.0, {"stall_s": 0.05, "stall_rate": 0.5}]]),
}
CHAOS_REDUCED = [
    f"chaos_read_*: {CHAOS_READS} reads a worker",
    f"chaos_train: {CHAOS_TRAIN_STEPS} of {TRAIN_STEPS} steps",
    "chaos_serve: 3 s of schedule (default 4 s)",
    "chaos_pod: one rank (the machine has one H100)",
]


class SharedStore:
    """Makes ``FakeBackend.prepopulated`` (which ``open_backend`` and
    ``chaos``'s own backend call) and ``FakeBackend.from_population``
    (which ``replay`` calls) hand back a store over the arrays of a store
    this script already holds when the objects asked for are among them:
    the same names, sizes and bytes (``deterministic_bytes``), under the
    fault plan the caller gives — regenerating 4.8 GB for every chaos
    mode would cost 10 s a mode. Any other population is built as
    before."""

    def __init__(self, *stores):
        self.stores = stores

    def __enter__(self):
        from tpubench_torch.storage.base import ObjectMeta
        from tpubench_torch.storage.fake import FakeBackend

        self.cls = FakeBackend
        self.real = {k: FakeBackend.__dict__[k]
                     for k in ("prepopulated", "from_population")}
        stores = self.stores
        real_pre = self.real["prepopulated"].__func__
        real_pop = self.real["from_population"].__func__

        def over(cls, triples, fault):
            for st in stores:
                if all(len(st._objects.get(n, ())) == size
                       for n, size, _ in triples):
                    be = cls(fault=fault)
                    for n, _, gen in triples:
                        be._objects[n] = st._objects[n]
                        be._generation[n] = gen or st._generation[n]
                    return be
            return None

        def shared(cls, prefix, count, size, fault=None):
            be = over(cls, [(f"{prefix}{i}", size, 0) for i in range(count)],
                      fault)
            return be or real_pre(cls, prefix, count, size, fault)

        def population(cls, objects, fault=None):
            objects = list(objects)
            triples = [(o.name, o.size, o.generation)
                       if isinstance(o, ObjectMeta) else tuple(o)
                       for o in objects]
            be = over(cls, [(n, int(s), int(g)) for n, s, g in triples],
                      fault)
            return be or real_pop(cls, objects, fault)

        FakeBackend.prepopulated = classmethod(shared)
        FakeBackend.from_population = classmethod(population)
        return self

    def __exit__(self, *exc):
        for k, v in self.real.items():
            setattr(self.cls, k, v)


def _launch_counts() -> dict:
    from tpubench_torch.kernels import landing

    return {"land": landing.land.launches,
            "checksum": landing.checksum.launches}


def _serve_run(mode: str, store, smi) -> dict:
    """One mode of phase serve through ``cli.execute`` (the scorecards
    printed), checked; returns the mode's line."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.storage import open_backend
    from tpubench_torch.storage.fake import FaultPlan
    from tpubench_torch.storage.fake_server import FakeGcsServer

    spec = SERVE_MODES[mode]
    argv = ["serve", "--protocol", "fake", "--workers", str(WORKERS),
            "--object-size", str(OBJECT_SIZE), "--granule-bytes",
            str(GRANULE), *spec["argv"]]
    argv += ["--serve-duration", str(spec["seconds"])]
    reactor = None
    with contextlib.ExitStack() as stack:
        if spec.get("svc"):
            store.fault = FaultPlan(per_read_latency_s=SERVE_SVC_S, seed=7)
            store._rng = store.fault.rng()

            def plain():
                store.fault = FaultPlan()
                store._rng = store.fault.rng()

            stack.callback(plain)
        backend = store
        if mode == "serve_reactor":
            srv = stack.enter_context(FakeGcsServer(store))
            argv[2] = "http"
            argv += ["--endpoint", srv.endpoint, "--bucket", "testbucket",
                     "--object-name-prefix", "tpubench/file_"]
        args, cfg = _cli(argv)
        if spec.get("svc"):
            cfg.serve.chunk_bytes = SERVE_SVC_CHUNK
        if mode == "serve_reactor":
            from tpubench_torch.native.engine import get_engine
            from tpubench_torch.storage.reactor_backend import (
                ReactorFetchBackend,
            )

            backend = stack.enter_context(contextlib.closing(
                open_backend(cfg)))
            reactor = backend
            while not isinstance(reactor, ReactorFetchBackend):
                reactor = reactor.inner
            python_reads = []
            inner = reactor.inner
            real_open = inner.open_read
            inner.open_read = lambda *a, **kw: (
                python_reads.append(a), real_open(*a, **kw))[1]
            engine = get_engine()
            done0 = engine.stats()["pool_completions"]
        buf = io.StringIO()
        landing.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.execute("serve", cfg, device="cuda", backend=backend,
                              args=args)
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
    out = buf.getvalue()
    sv = res.extra["serve"]
    check(counts == {"land": 0, "checksum": 0},
          f"serve/{mode}: the serve plane launched {counts}")
    check(res.errors == 0, f"serve/{mode}: {res.errors} errors")
    line = {"phase": "serve", "mode": mode, "launches": counts,
            "chunk_bytes": cfg.serve.chunk_bytes or GRANULE,
            "seconds": seconds, "card": smi, "reduced": SERVE_REDUCED}
    if mode == "serve_sweep":
        check("== serve load sweep ==" in out,
              f"serve/{mode}: no sweep printed")
        sweep = sv["sweep"]
        check(len(sweep["points"]) == 5 and sweep["knee"] is not None,
              f"serve/{mode}: {len(sweep['points'])} points, knee "
              f"{sweep['knee']}")
        line.update(knee=sweep["knee"], points=[
            {k: p[k] for k in ("multiplier", "offered_rps", "achieved_rps",
                               "goodput_gbps", "p99_ms", "gold_p99_ms",
                               "gold_slo_attainment", "shed")}
            for p in sweep["points"]], base_rate_rps=sweep["base_rate_rps"],
            svc_ms=SERVE_SVC_S * 1e3, wall_s=res.wall_seconds)
        return line
    check("== serve scorecard ==" in out, f"serve/{mode}: no scorecard")
    errors = sum(c["errors"] for c in sv["classes"].values())
    check(sv["arrivals"] == sv["completed"] + sv["shed"] + errors,
          f"serve/{mode}: arrivals {sv['arrivals']} != completed "
          f"{sv['completed']} + shed {sv['shed']} + errors {errors}")
    check(sv["jain_fairness"] is not None, f"serve/{mode}: no Jain index")
    req = res.summaries.get("request")
    line.update({
        "arrivals": sv["arrivals"], "completed": sv["completed"],
        "shed": sv["shed"], "shed_by_reason": sv["shed_by_reason"],
        "offered_rps": sv["offered_rps"], "achieved_rps": sv["achieved_rps"],
        "goodput_gbps": sv["goodput_gbps"], "jain": sv["jain_fairness"],
        "p50_ms": req.p50_ms if req else None,
        "p99_ms": req.p99_ms if req else None,
        "classes": {c: {k: v[k] for k in ("arrivals", "completed", "shed",
                                          "slo_attainment", "p99_ms")}
                    for c, v in sv["classes"].items()},
        "wall_s": res.wall_seconds,
    })
    if spec.get("svc"):
        line["svc_ms"] = SERVE_SVC_S * 1e3
    if mode == "serve_reactor":
        fetches = sv["cache"]["misses"]
        done = engine.stats()["pool_completions"] - done0
        check(reactor.pool_mode == "reactor" and not reactor.fell_back,
              f"serve/{mode}: pool {reactor.pool_mode}, fell back "
              f"{reactor.fell_back}")
        check(done == fetches > 0 and python_reads == [],
              f"serve/{mode}: {done} pool completions for {fetches} "
              f"fetches, {len(python_reads)} Python reads")
        line.update(pool_mode=reactor.pool_mode, pool_completions=done,
                    fetches=fetches, python_reads=len(python_reads))
    if mode == "serve_elastic":
        mb = res.extra["membership"]
        check("== membership resize scorecard ==" in out,
              f"serve/{mode}: no resize scorecard")
        acts = [(e["action"], e["host"], e["applied"]) for e in mb["events"]]
        check(acts == [("kill_host", 1, True), ("rejoin_host", 1, True)]
              and mb["epoch"] == 2,
              f"serve/{mode}: events {acts}, epoch {mb['epoch']}")
        check(mb["pool_leaked_slabs"] == 0,
              f"serve/{mode}: {mb['pool_leaked_slabs']} slabs leaked")
        check(all(h["pool"]["native"] is False for h in mb["per_host"]),
              f"serve/{mode}: a host's pool was page-locked")
        line["membership"] = {
            "events": [{k: e.get(k) for k in (
                "t_s", "action", "host", "epoch", "remap_fraction",
                "time_to_rewarm_s")} for e in mb["events"]],
            "slo": mb["slo"], "failovers": mb["failovers"],
            "peer_hit_ratio": mb["peer_hit_ratio"],
            "origin_bytes": mb["origin_bytes"],
            "pool_leaked_slabs": mb["pool_leaked_slabs"]}
    return line


def phase_serve(store, smi) -> dict:
    """Each mode of SERVE_MODES over phase read's store; then the QoS A/B's
    verdict (gold SLO with QoS >= 0.9 and above FIFO's, best-effort sheds,
    gold sheds nothing, goodput retention >= 0.6). The serve plane must
    launch no kernel. Returns the launch counts."""
    t_phase = time.perf_counter()
    lines = {}
    for mode in SERVE_MODES:
        lines[mode] = _serve_run(mode, store, smi)
        emit(lines[mode])
    on, off = lines["serve_qos"], lines["serve_fifo"]
    g_on = on["classes"]["gold"]["slo_attainment"]
    g_off = off["classes"]["gold"]["slo_attainment"]
    retention = on["goodput_gbps"] / off["goodput_gbps"]
    check(g_on is not None and g_off is not None and g_on >= 0.9
          and g_on > g_off, f"serve/qos_ab: gold SLO {g_on} vs FIFO {g_off}")
    check(on["classes"]["best_effort"]["shed"] > 0
          and on["classes"]["gold"]["shed"] == 0,
          f"serve/qos_ab: sheds {on['classes']}")
    check(retention >= 0.6, f"serve/qos_ab: goodput retention {retention}")
    emit({"phase": "serve_total", "seconds": time.perf_counter() - t_phase,
          "qos_ab": {"gold_slo": [g_on, g_off],
                     "gold_p99_ms": [on["classes"]["gold"]["p99_ms"],
                                     off["classes"]["gold"]["p99_ms"]],
                     "goodput_retention": retention},
          "card": smi, "reduced": SERVE_REDUCED})
    return {f"serve/{m}": lines[m]["launches"] for m in SERVE_MODES}


def _chaos_argv(mode: str) -> list:
    spec = CHAOS_MODES[mode]
    wl = spec["workload"]
    argv = ["chaos", "--chaos-workload", wl, "--protocol", "fake"]
    if wl == "pod-ingest":
        return argv + ["--workers", "1", "--object-size", str(POD_OBJECT),
                       "--chaos-timeline", json.dumps(spec["timeline"])]
    if wl == "train-ingest":
        t0, t1 = spec["blackhole"]
        return argv + _train_argv(spec["argv"], CHAOS_TRAIN_STEPS)[2:] + [
            "--chaos-fault", "blackhole", "--chaos-start", str(t0),
            "--chaos-duration", str(t1 - t0), "--hedge", "--hedge-delay",
            "0.05", "--watchdog", "--stall-window", "0.2"]
    argv += ["--workers", str(WORKERS), "--object-size", str(OBJECT_SIZE),
             "--granule-bytes", str(GRANULE), *spec["argv"]]
    if wl == "read":
        argv += ["--read-call-per-worker", str(CHAOS_READS)]
    return argv + ["--chaos-timeline", json.dumps(spec["timeline"])]


def _chaos_run(mode: str, stores, smi) -> tuple[dict, dict]:
    """One mode of phase chaos through ``cli.execute`` (the resilience
    scorecard printed), checked; returns its launch counts and line."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    wl = CHAOS_MODES[mode]["workload"]
    args, cfg = _cli(_chaos_argv(mode))
    before = cfg.to_dict()
    buf = io.StringIO()
    with SharedStore(*stores), PodObserved() as pod_obs, \
            contextlib.redirect_stdout(buf):
        landing.reset_launches()
        t0 = time.perf_counter()
        res = cli.execute("chaos", cfg, device="cuda", args=args)
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
    out = buf.getvalue()
    ch = res.extra["chaos"]
    sc = ch["scorecard"]
    check(f"== resilience scorecard ({wl};" in out,
          f"chaos/{mode}: no scorecard printed")
    check(res.errors == 0 and sc["failed_reads"] == 0,
          f"chaos/{mode}: errors {res.errors}, failed reads "
          f"{sc['failed_reads']}")
    check(ch["workload"] == wl and ch["sleep_scale"] == 1.0,
          f"chaos/{mode}: {ch['workload']} at scale {ch['sleep_scale']}")
    ex = res.extra
    want = {"land": 0, "checksum": 0}
    line = {"phase": "chaos", "mode": mode, "workload": wl,
            "timeline": ch["timeline"], "member_timeline":
            ch["member_timeline"], "launches": counts, "seconds": seconds,
            "wall_s": res.wall_seconds, "gbps": res.gbps,
            "scorecard": {k: sc[k] for k in (
                "fault_window_s", "goodput_retention", "p99_inflation",
                "time_to_recover_s", "failed_reads", "timeline_covered",
                "stalls", "hedge")}
            | {seg: {k: sc[seg][k] for k in ("reads", "goodput_gbps",
                                             "p50_ms", "p99_ms")}
               for seg in ("baseline", "fault", "recovery")},
            "card": smi, "reduced": CHAOS_REDUCED}
    if wl == "read":
        transfers = WORKERS * expected_transfers(
            OBJECT_SIZE, GRANULE, _slot(cfg), reads=CHAOS_READS)
        stats = ex.get("staging") or {}
        check(stats.get("transfers", transfers) == transfers,
              f"chaos/{mode}: {stats.get('transfers')} transfers, want "
              f"{transfers}")
        check(ex["checksum_ok"] is True
              and ex["staged_bytes"] == WORKERS * CHAOS_READS * OBJECT_SIZE,
              f"chaos/{mode}: checksum_ok {ex.get('checksum_ok')}, staged "
              f"{ex.get('staged_bytes')}")
        reads = sum(sc[s]["reads"] for s in ("baseline", "fault", "recovery"))
        check(reads == WORKERS * CHAOS_READS,
              f"chaos/{mode}: {reads} reads in the scorecard")
        want["land" if "pallas" in mode else "checksum"] = transfers
        line.update(transfers=transfers, checksum_ok=ex["checksum_ok"],
                    staged_gbps_per_chip=ex["staged_gbps_per_chip"])
    elif wl == "pod-ingest":
        stall_ms = CHAOS_MODES[mode]["timeline"][0][2]["stall_s"] * 1e3
        check(sc["fault"]["reads"] == 1 and sc["fault"]["p99_ms"] >= stall_ms,
              f"chaos/{mode}: the shard's fetch did not stall: "
              f"{sc['fault']}")
        check(ex["verified"] is True and pod_obs.calls
              and all(b == "nccl" and d == "cuda"
                      for b, d, _ in pod_obs.calls),
              f"chaos/{mode}: verified {ex.get('verified')}, calls "
              f"{pod_obs.calls}")
        want["checksum"] = len(pod_obs.calls)
        line.update(verified=ex["verified"], collective_calls=len(
            pod_obs.calls), fetch_gbps=ex.get("fetch_gbps"))
    elif wl == "train-ingest":
        pipe = ex["pipeline"]
        stall = pipe["stall"]
        check(stall["steps"] == CHAOS_TRAIN_STEPS
              and stall["total_stall_ms"] > 0 and stall["stalled_steps"] >= 1
              and sc["stalls"] > 0 and ex["checksum_ok"] is True,
              f"chaos/{mode}: stall {stall}, watchdog stalls {sc['stalls']}, "
              f"checksum_ok {ex.get('checksum_ok')}")
        check(res.bytes_total == CHAOS_TRAIN_STEPS * TRAIN_BATCH * GRANULE,
              f"chaos/{mode}: {res.bytes_total} B delivered")
        want["checksum"] = res.summaries["stage"].count
        line.update(stall=stall, checksum_ok=ex["checksum_ok"],
                    tail=ex.get("tail"),
                    leaked_slabs=pipe["copies"]["pool"]["leaked_slabs"])
    else:  # serve
        mb, sv = ex["membership"], ex["serve"]
        errors = sum(c["errors"] for c in sv["classes"].values())
        acts = [(e["action"], e["applied"]) for e in mb["events"]]
        check(acts == [("kill_host", True)] and mb["pool_leaked_slabs"] == 0
              and sv["arrivals"] == sv["completed"] + sv["shed"] + errors,
              f"chaos/{mode}: events {acts}, leaked "
              f"{mb['pool_leaked_slabs']}, serve {sv['arrivals']} / "
              f"{sv['completed']} / {sv['shed']} / {errors}")
        check("== membership resize scorecard ==" in out,
              f"chaos/{mode}: no resize scorecard")
        line.update(arrivals=sv["arrivals"], completed=sv["completed"],
                    shed=sv["shed"], membership_slo=mb["slo"])
    check(counts == want, f"chaos/{mode}: launches {counts}, want {want}")
    after = cfg.to_dict()  # the timeline stays, as run_chaos was given it
    after["transport"]["fault"]["phases"] = []
    check(after == before, f"chaos/{mode}: the caller's config changed")
    return counts, line


def phase_chaos(store, pod_store, smi) -> dict:
    """Each mode of CHAOS_MODES through ``cli.execute`` over the arrays
    of phase read's and phase pod's stores; every mode prints and checks
    its resilience scorecard. Returns the launch counts."""
    t_phase = time.perf_counter()
    launches = {}
    for mode in CHAOS_MODES:
        counts, line = _chaos_run(mode, (store, pod_store), smi)
        emit(line)
        launches[f"chaos/{mode.removeprefix('chaos_')}"] = counts
    emit({"phase": "chaos_total", "seconds": time.perf_counter() - t_phase,
          "card": smi, "reduced": CHAOS_REDUCED})
    return launches


# ------------------------------------------------------------- phase 24 --
# Phase drill. meta-storm at tpubench's lifecycle defaults (64 objects x
# 4 KiB, Poisson 200 ops/s for 2 s, mix list:1,stat:2,open:2, pages of 16,
# 8 workers) behind the HTTP/1.1 fake and the gRPC wire fake (every list
# targets lifecycle.prefix's meta/ folder, so each must come back whole:
# 64 names over 4 pages), then --meta-sweep at 3 points. The drill at
# tpubench's ServeConfig and DrillConfig defaults on a 4-host pod (kill at
# 1.0 s, join at 1.5 s, restore through coop, delta saves every 1.0 s at
# dirty fraction 0.25) over phase read's objects, with a checkpoint of
# phase ckpt's shape; the same with a 200/s storm sharing the pod. Then
# both goldens under scenarios/ replayed under their recording config,
# and drill_default's journal recorded, replayed and re-recorded.
META_SWEEP_POINTS = "0.5,1,2"
DRILL_HOSTS = 4
# Phase ckpt's 16 objects, cut from its 128 MiB to 48 MiB (3 parts) an
# object: at 128 MiB one drill took 31 s (the baseline save alone ~18 s),
# and at 64 MiB the phase took 84 s of the 90 s it may (three drills:
# default, storm, replayed).
DRILL_CKPT_OBJECTS, DRILL_CKPT_BYTES = 16, 48 * MIB
DRILL_META_RATE = 200.0
GOLDEN_BUNDLES = ("chaos-serve-gold", "drill-restore-gold")
# The goldens' recording config (scenarios/README.md): protocol fake,
# 4 workers of 1 MiB objects, every system knob at its default.
GOLDEN_ARGV = ["--protocol", "fake", "--workers", "4", "--object-size",
               str(MIB)]
DRILL_REDUCED = [
    f"checkpoint {DRILL_CKPT_OBJECTS} x {DRILL_CKPT_BYTES // MIB} MiB "
    "(phase ckpt's 16 x 128 MiB would not fit the phase's 90 s)",
    "meta_sweep: 3 points (0.5x, 1x, 2x of 200/s; the default steps 4)",
    "one rank: the pod's 4 hosts are threads of one process, as in "
    "tpubench",
]


class TrackerObserved:
    """Keeps each ``DeltaTracker`` a drill builds (the class looked up in
    ``lifecycle.delta`` at each run, subclassed to note its instances), so
    the stored checkpoint can be held against the crc32 the saver
    published for each generation."""

    def __enter__(self):
        from tpubench_torch.lifecycle import delta

        self.mod, self.real = delta, delta.DeltaTracker
        made = self.made = []

        class Noted(self.real):
            def __init__(self, manifest):
                super().__init__(manifest)
                made.append(self)

        delta.DeltaTracker = Noted
        return self

    def __exit__(self, *exc):
        self.mod.DeltaTracker = self.real


def _fresh_store(store):
    """A fake store over phase read's arrays (no copy): what a drill writes
    lands here and goes with it."""
    from tpubench_torch.storage.fake import FakeBackend

    be = FakeBackend()
    be._objects.update(store._objects)
    be._generation.update(store._generation)
    return be


def _meta_run(mode: str, smi) -> dict:
    """One meta-storm mode through ``cli.execute``, checked; its line."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing
    from tpubench_torch.lifecycle.storm import build_storm_schedule
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.storage.fake_grpc_wire_server import (
        FakeGrpcWireServer,
    )
    from tpubench_torch.storage.fake_server import FakeGcsServer

    store, pages = FakeBackend(), []
    real_list = store.list

    def counted_list(prefix="", page_size=0):
        pages.append(prefix)
        return real_list(prefix, page_size)

    store.list = counted_list
    argv = ["meta-storm", "--workers", "1", "--object-size", "4096"]
    with contextlib.ExitStack() as stack:
        modes = stack.enter_context(GrpcModes())
        if mode == "meta_sweep":
            argv += ["--protocol", "fake", "--meta-sweep",
                     "--meta-sweep-points", META_SWEEP_POINTS]
        else:
            srv_cls = FakeGcsServer if mode == "meta_http" else \
                FakeGrpcWireServer
            srv = stack.enter_context(srv_cls(store))
            argv += ["--protocol", "http" if mode == "meta_http" else "grpc",
                     "--endpoint", srv.endpoint, "--bucket", "testbucket"]
        args, cfg = _cli(argv)
        buf = io.StringIO()
        landing.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = cli.execute("meta-storm", cfg, device="cuda", args=args)
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
    lc, life = res.extra["lifecycle"], cfg.lifecycle
    check(counts == {"land": 0, "checksum": 0},
          f"drill/{mode}: meta-storm launched {counts}")
    check(modes.mode == ("library" if mode == "meta_grpc" else None),
          f"drill/{mode}: gRPC in {modes.mode} mode")
    check(f"lifecycle [meta_storm]" in buf.getvalue(),
          f"drill/{mode}: no scorecard printed")
    line = {"phase": "drill", "mode": mode, "launches": counts,
            **({"grpc_mode": modes.mode} if modes.mode else {}),
            "seconds": seconds, "wall_s": res.wall_seconds,
            "objects": life.meta_objects, "mix": life.meta_mix,
            "page_size": life.meta_page_size, "card": smi,
            "reduced": DRILL_REDUCED}
    if mode == "meta_sweep":
        sw = lc["sweep"]
        check(len(sw["points"]) == 3
              and all(p["errors"] == 0 for p in sw["points"]),
              f"drill/{mode}: points {sw['points']}")
        line.update(points=sw["points"], knee=sw["knee"],
                    base_rate_rps=life.meta_rate_rps)
        return line
    names = [f"{life.prefix}meta/{i:05d}" for i in range(life.meta_objects)]
    want = len(build_storm_schedule(
        names, kind=life.meta_arrival, rate_rps=life.meta_rate_rps,
        duration_s=life.meta_duration_s, mix=life.meta_mix,
        prefix=f"{life.prefix}meta/", seed=life.seed,
        burst_factor=cfg.serve.burst_factor,
        burst_fraction=cfg.serve.burst_fraction,
        burst_cycle_s=cfg.serve.burst_cycle_s,
        diurnal_period_s=cfg.serve.diurnal_period_s))
    lists = lc["by_kind_completed"].get("list", 0)
    wire_pages = len(pages)
    listed = len(real_list(f"{life.prefix}meta/"))
    per_list = -(-listed // life.meta_page_size)
    check(lc["errors"] == 0 and lc["completed"] == lc["ops"] == want,
          f"drill/{mode}: {lc['completed']} of {lc['ops']} ops (schedule "
          f"{want}), {lc['errors']} errors")
    check(listed >= life.meta_objects and lists > 0
          and lc["list_items"] == lists * listed,
          f"drill/{mode}: {lc['list_items']} items in {lists} lists of a "
          f"{listed}-object folder")
    check(per_list > 1 and wire_pages == lists * per_list,
          f"drill/{mode}: {wire_pages} pages for {lists} lists "
          f"({per_list} a list)")
    line.update(ops=lc["ops"], completed=lc["completed"],
                by_kind_completed=lc["by_kind_completed"],
                list_items=lc["list_items"], listed=listed,
                pages_per_list=per_list, offered_rps=lc["offered_rps"],
                achieved_rps=lc["achieved_rps"], p50_ms=lc["p50_ms"],
                p99_ms=lc["p99_ms"], by_kind={
                    k: {q: v[q] for q in ("count", "p50_ms", "p99_ms")}
                    for k, v in lc["by_kind"].items()})
    return line


def _drill_run(mode: str, store, smi) -> tuple[dict, str]:
    """One drill mode through ``cli.execute`` over a store sharing phase
    read's arrays, checked; returns its line and its journal."""
    import contextlib
    import io
    import zlib

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    journal = f"{BUILD}/drill/{mode}.json"
    argv = ["drill", "--protocol", "fake", "--workers", str(WORKERS),
            "--object-size", str(OBJECT_SIZE), "--granule-bytes",
            str(GRANULE), "--serve-hosts", str(DRILL_HOSTS),
            "--ckpt-objects", str(DRILL_CKPT_OBJECTS),
            "--ckpt-object-bytes", str(DRILL_CKPT_BYTES),
            "--ckpt-part-bytes", str(CKPT_PART_BYTES),
            "--flight-journal", journal]
    if mode == "drill_meta":
        argv += ["--drill-meta-rate", str(DRILL_META_RATE)]
    args, cfg = _cli(argv)
    backend = _fresh_store(store)
    buf = io.StringIO()
    with TrackerObserved() as trackers, contextlib.redirect_stdout(buf):
        landing.reset_launches()
        t0 = time.perf_counter()
        res = cli.execute("drill", cfg, device="cuda", backend=backend,
                          args=args)
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
    out = buf.getvalue()
    d, mb, sv = res.extra["drill"], res.extra["membership"], \
        res.extra["serve"]
    rst, saves = d["restore"], d["saves"]
    (tracker,) = trackers.made
    corrupt, unadopted = 0, 0
    for spec in tracker.manifest.objects:
        meta = backend.stat(spec.name)
        want = tracker.crc_for(spec.name, meta.generation)
        crc = zlib.crc32(backend._objects[spec.name]) & 0xFFFFFFFF
        if want is None:
            unadopted += 1
        elif crc != want:
            corrupt += 1
    req = res.summaries.get("request")
    line = {"phase": "drill", "mode": mode, "launches": counts,
            "seconds": seconds, "wall_s": res.wall_seconds,
            "hosts": DRILL_HOSTS, "checkpoint": {
                "objects": DRILL_CKPT_OBJECTS, "object_bytes":
                DRILL_CKPT_BYTES, "part_bytes": CKPT_PART_BYTES},
            "restore": {k: rst[k] for k in (
                "verified", "shards_restored", "bytes", "chunks",
                "torn_rereads", "shed_repushes", "forced_direct",
                "time_to_restore_s", "started_at_s", "finished_at_s")},
            "time_to_rewarm_s": d["time_to_rewarm_s"],
            "gold_slo": d["gold_slo"], "saves": saves,
            "baseline_save": d["baseline_save"],
            "corrupt_finalizes": corrupt, "unadopted_shards": unadopted,
            "amplification": d["amplification"],
            "save_part_latency": d["save_part_latency"], "meta": d["meta"],
            "serve": {k: sv[k] for k in ("arrivals", "completed", "shed",
                                         "offered_rps", "goodput_gbps")},
            "p99_ms": req.p99_ms if req else None,
            "errors_by_class": {c: v["errors"]
                                for c, v in sv["classes"].items()},
            "restore_class": {k: sv["classes"][cfg.drill.restore_class][k]
                              for k in ("arrivals", "completed", "shed",
                                        "slo_attainment", "p50_ms",
                                        "p99_ms")},
            "events": [{k: e.get(k) for k in ("t_s", "action", "host",
                                               "remap_fraction")}
                       for e in mb["events"]],
            "card": smi, "reduced": DRILL_REDUCED}
    emit(line)
    check(counts == {"land": 0, "checksum": 0},
          f"drill/{mode}: the drill launched {counts}")
    check("incident drill scorecard" in out
          and "== membership resize scorecard ==" in out,
          f"drill/{mode}: scorecards not printed")
    # A torn read errors the restore chunks in flight on its shard (the
    # restore class's errors, re-read); the serving classes must see none.
    served = {c: v["errors"] for c, v in sv["classes"].items()
              if c != cfg.drill.restore_class}
    check(not any(served.values()), f"drill/{mode}: errors {served}")
    check(rst["verified"] and rst["completed"] and rst["errors"] == 0
          and rst["shards_restored"] == DRILL_CKPT_OBJECTS,
          f"drill/{mode}: restore {rst}")
    check(mb["pool_leaked_slabs"] == 0
          and all(h["pool"]["native"] is False for h in mb["per_host"]),
          f"drill/{mode}: leaked {mb['pool_leaked_slabs']} slabs")
    check(saves["errors"] == 0 and saves["passes"] >= 1 and corrupt == 0,
          f"drill/{mode}: saves {saves}, {corrupt} corrupt shards")
    if mode == "drill_meta":
        meta = d["meta"] or {}
        check(meta.get("completed", 0) > 0 and meta.get("errors") == 0,
              f"drill/{mode}: storm {meta}")
    return line, journal


def _replay_run(tag: str, path: str, argv: list, smi,
                gate_slo: bool = True) -> tuple[dict, object]:
    """``replay`` of one bundle through ``cli.execute``, checked against
    the gates of ``scenarios/README.md`` (the gold SLO's only where
    ``gate_slo``: a golden's baseline was recorded quiet, a drill under
    load moves by a few points from run to run); its line and result."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    args, cfg = _cli(["replay", path, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        landing.reset_launches()
        t0 = time.perf_counter()
        res = cli.execute("replay", cfg, device="cuda", args=args)
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
    rp = res.extra["replay"]
    delta = rp["diff"]["gold_slo_delta_pts"]
    check(counts == {"land": 0, "checksum": 0},
          f"drill/{tag}: the replay launched {counts}")
    check("== replay vs original" in buf.getvalue(),
          f"drill/{tag}: no replay block printed")
    check(rp["config_match"] and rp["arrivals_match"],
          f"drill/{tag}: config_match {rp['config_match']} "
          f"({rp['fingerprint']} vs {rp['original_fingerprint']}), "
          f"arrivals_match {rp['arrivals_match']}")
    check(not gate_slo or (delta is not None and abs(delta) <= 5.0),
          f"drill/{tag}: gold SLO moved {delta} points")
    line = {"bundle": rp["bundle"], "seconds": seconds,
            "launches": counts, "gold_slo_delta_pts": delta,
            "baseline": rp["baseline"], "replayed": rp["replayed"],
            "diff": rp["diff"]}
    if rp.get("drill"):
        check(rp["drill"]["replayed"]["restore_verified"]
              and rp["drill"]["diff"]["verified_match"],
              f"drill/{tag}: drill replay {rp['drill']}")
        line["drill"] = rp["drill"]
    return line, res


def _replay_gold(store, journal: str, smi) -> dict:
    """Both goldens replayed under their recording config; then
    drill_default's journal recorded, replayed (its population shared with
    phase read's arrays) and re-recorded: the two bundles byte-identical."""
    import contextlib
    import io
    from pathlib import Path

    from tpubench_torch import cli
    from tpubench_torch.replay.bundle import load_bundle, validate_bundle

    t0 = time.perf_counter()
    gold = {}
    for name in GOLDEN_BUNDLES:
        path = f"scenarios/{name}.tpb.gz"
        validate_bundle(load_bundle(path), path)
        gold[name], _ = _replay_run(f"replay_gold/{name}", path,
                                    GOLDEN_ARGV, smi)
    first, second = f"{BUILD}/drill/b1.tpb.gz", f"{BUILD}/drill/b2.tpb.gz"
    rejournal = f"{BUILD}/drill/replayed.json"
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(["record", journal, "--out", first]) == 0,
              "drill/replay_gold: record failed")
    name = load_bundle(first)["name"]
    with SharedStore(store):
        rerun, res = _replay_run("replay_gold/drill_default", first, [
            "--protocol", "fake", "--workers", str(WORKERS),
            "--object-size", str(OBJECT_SIZE), "--granule-bytes",
            str(GRANULE), "--flight-journal", rejournal], smi,
            gate_slo=False)
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli.main(["record", rejournal, "--out", second, "--name",
                        name]) == 0, "drill/replay_gold: re-record failed")
    same = Path(first).read_bytes() == Path(second).read_bytes()
    check(same, "drill/replay_gold: the re-recorded bundle differs")
    return {"phase": "drill", "mode": "replay_gold", "goldens": gold,
            "rerecord": {"bundle": name, "byte_identical": same,
                         "bytes": Path(first).stat().st_size,
                         "replay": rerun},
            "launches": {"land": 0, "checksum": 0},
            "seconds": time.perf_counter() - t0, "card": smi,
            "reduced": DRILL_REDUCED}


def phase_drill(store, smi) -> dict:
    """meta_http, meta_grpc, meta_sweep, drill_default, drill_meta and
    replay_gold; none launches a kernel. Returns the launch counts."""
    import os

    t_phase = time.perf_counter()
    os.makedirs(f"{BUILD}/drill", exist_ok=True)
    launches = {}
    for mode in ("meta_http", "meta_grpc", "meta_sweep"):
        line = _meta_run(mode, smi)
        emit(line)
        launches[f"drill/{mode}"] = line["launches"]
    journal = None
    for mode in ("drill_default", "drill_meta"):
        line, j = _drill_run(mode, store, smi)
        launches[f"drill/{mode}"] = line["launches"]
        journal = journal or j
    line = _replay_gold(store, journal, smi)
    emit(line)
    launches["drill/replay_gold"] = line["launches"]
    emit({"phase": "drill_total", "seconds": time.perf_counter() - t_phase,
          "card": smi, "reduced": DRILL_REDUCED})
    return launches


# ------------------------------------------------------------- phase 25 --
# Phase fleet: the virtual-time fleet through cli.execute. fleet_scale is
# tpubench's scale acceptance (tests/test_fleet.py:520-558): 1024 hosts
# (8 pods), 100,000 tenants, diurnal arrivals at 30,000/s for 1 s, 5% of
# the fleet killed at 0.5 s and rejoined 0.4 s later, seed 20, in under
# 60 s of wall. fleet_max: the top of the README's 64-4096 range at the
# FleetConfig and ServeConfig defaults, every host paused once by a
# rolling upgrade. fleet_sweep: --fleet-sweep at the defaults.
# fleet_agree: tests/test_fleet.py:433-475's agreement gate on this host
# (a 4-host elastic serve, 4 ms a read, host 1 killed at 0.54 s; the
# virtual arm calibrated from the threaded arm's journal): gold SLO
# within 2 points, the same kill at the same epoch, the same arrivals.
FLEET_WALL_S = 60.0
FLEET_CHUNK = 64 * 1024
FLEET_SCALE_ARGV = [
    "--object-size", str(MIB), "--granule-bytes", str(FLEET_CHUNK),
    "--fleet-hosts", "1024", "--fleet-seed", "20",
    "--fleet-timeline", "correlated_failure", "--fleet-fail-at", "0.5",
    "--fleet-fail-fraction", "0.05", "--fleet-recover", "0.4",
    "--serve-seed", "20", "--serve-arrival", "diurnal",
    "--serve-duration", "1", "--serve-rate", "30000",
    "--serve-tenants", "100000"]
FLEET_MAX_HOSTS = 4096
AGREE_KILL_S = 0.54  # 0.45 of the 1.2 s schedule
AGREE_ARGV = [
    "--protocol", "fake", "--workers", "4", "--object-size", str(MIB),
    "--granule-bytes", str(FLEET_CHUNK), "--staging", "none",
    "--cache-bytes", str(64 * MIB), "--fault-per-read-latency", "0.004",
    "--serve-seed", "11", "--serve-duration", "1.2", "--serve-rate", "250",
    "--serve-tenants", "24", "--serve-workers", "4", "--serve-hosts", "4",
    "--resize-window", "0.4", "--membership-timeline",
    json.dumps([[AGREE_KILL_S, AGREE_KILL_S, {"kill_host": 1}]])]
FLEET_REDUCED = [
    "one process: every simulated host is an event of one loop, as in "
    "tpubench; the fleet touches no device",
]


def _fleet_exec(cmd: str, argv: list) -> tuple:
    """``cmd`` through ``cli.execute`` on the card, its printout captured;
    returns the result, the printout, the seconds and the launch counts."""
    import contextlib
    import io

    from tpubench_torch import cli
    from tpubench_torch.kernels import landing

    args, cfg = _cli([cmd, *argv])
    buf = io.StringIO()
    landing.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = cli.execute(cmd, cfg, device="cuda", args=args)
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    check(counts == {"land": 0, "checksum": 0},
          f"fleet/{cmd}: launched {counts}")
    return res, buf.getvalue(), seconds, counts


def _fleet_line(mode: str, res, seconds: float, counts: dict, smi) -> dict:
    fl, sv = res.extra["fleet"], res.extra["serve"]
    gold = min(sv["classes"].values(), key=lambda c: c["priority"]) \
        if sv.get("classes") else {}
    req = res.summaries.get("request")
    return {"phase": "fleet", "mode": mode, "launches": counts,
            "seconds": seconds, "hosts": fl["hosts"], "pods": fl["pods"],
            "workers": fl["workers"], "tenants": fl["tenants"],
            "timeline": fl["timeline"], "arrivals": fl["arrivals"],
            "sim": fl["sim"], "cross_pod": fl.get("cross_pod"),
            "errors": res.errors, "shed": sv.get("shed"),
            "gold_slo": gold.get("slo_attainment"),
            "gold_p99_ms": gold.get("p99_ms"),
            "p99_ms": req.p99_ms if req else None, "card": smi,
            "reduced": FLEET_REDUCED}


def _fleet_events(res, action: str) -> list:
    return [e for e in res.extra["membership"]["events"]
            if e["action"] == action]


def _fleet_scale(smi) -> dict:
    from tpubench_torch.metrics.report import write_result
    from tpubench_torch.workloads.report_cmd import run_report

    res, out, seconds, counts = _fleet_exec("fleet", FLEET_SCALE_ARGV)
    fl = res.extra["fleet"]
    kills = _fleet_events(res, "kill_host")
    rejoins = _fleet_events(res, "rejoin_host")
    report = run_report([write_result(res, f"{BUILD}/results", tag="scale")])
    line = _fleet_line("fleet_scale", res, seconds, counts, smi)
    line.update(kills=len(kills), rejoins=len(rejoins),
                remap_fraction=kills[0]["remap_fraction"] if kills else None)
    emit(line)
    check(fl["hosts"] == 1024 and fl["pods"] == 8
          and fl["tenants"] == 100_000 and fl["arrivals"] > 10_000,
          f"fleet/fleet_scale: {fl['hosts']} hosts, {fl['pods']} pods, "
          f"{fl['tenants']} tenants, {fl['arrivals']} arrivals")
    check(len(kills) == 51 and all(e["applied"] for e in kills)
          and len(rejoins) == 51 and all(e["applied"] for e in rejoins),
          f"fleet/fleet_scale: {len(kills)} kills, {len(rejoins)} rejoins")
    check(res.errors == 0, f"fleet/fleet_scale: {res.errors} errors")
    for text in (out, report):
        check(all(b in text for b in (
            "serve scorecard", "membership resize scorecard",
            "== fleet simulation ==")), "fleet/fleet_scale: a scorecard "
            "is missing from the printout or the report")
    check(seconds < FLEET_WALL_S,
          f"fleet/fleet_scale: {seconds:.1f} s (budget {FLEET_WALL_S} s)")
    return line


def _fleet_max(smi) -> dict:
    res, out, seconds, counts = _fleet_exec("fleet", [
        "--fleet-hosts", str(FLEET_MAX_HOSTS),
        "--fleet-timeline", "rolling_upgrade"])
    fl, mb = res.extra["fleet"], res.extra["membership"]
    pauses = _fleet_events(res, "pause_host")
    resumes = _fleet_events(res, "resume_host")
    line = _fleet_line("fleet_max", res, seconds, counts, smi)
    line.update(pauses=len(pauses), resumes=len(resumes), epoch=mb["epoch"])
    emit(line)
    n = FLEET_MAX_HOSTS
    check(fl["hosts"] == n and fl["pods"] == n // 128,
          f"fleet/fleet_max: {fl['hosts']} hosts in {fl['pods']} pods")
    check(len(pauses) == len(resumes) == n
          and all(e["applied"] for e in pauses + resumes)
          and mb["epoch"] == 2 * n,
          f"fleet/fleet_max: {len(pauses)} pauses, {len(resumes)} resumes, "
          f"epoch {mb['epoch']}")
    check(res.errors == 0 and "== fleet simulation ==" in out,
          f"fleet/fleet_max: {res.errors} errors")
    check(seconds < FLEET_WALL_S,
          f"fleet/fleet_max: {seconds:.1f} s (budget {FLEET_WALL_S} s)")
    return line


def _fleet_sweep(smi) -> dict:
    res, out, seconds, counts = _fleet_exec("fleet", ["--fleet-sweep"])
    sw = res.extra["serve"]["sweep"]
    line = {"phase": "fleet", "mode": "fleet_sweep", "launches": counts,
            "seconds": seconds, "hosts": res.extra["fleet"]["hosts"],
            "points": sw["points"], "knee": sw["knee"],
            "base_rate_rps": sw["base_rate_rps"],
            "sim": res.extra["fleet"]["sim"], "card": smi,
            "reduced": FLEET_REDUCED}
    emit(line)
    check(len(sw["points"]) == 5 and res.errors == 0,
          f"fleet/fleet_sweep: {len(sw['points'])} points, "
          f"{res.errors} errors")
    check("== fleet simulation ==" in out, "fleet/fleet_sweep: no block")
    return line


def _fleet_agree(smi) -> dict:
    """The threaded arm (``serve``, writing its journal) and the virtual
    arm (``fleet --calibrate-from`` that journal, the same scenario)."""
    journal = f"{BUILD}/fleet/agree.json"
    profile = f"{BUILD}/fleet/profile.json"
    threaded, _, t_seconds, t_counts = _fleet_exec(
        "serve", [*AGREE_ARGV, "--flight-journal", journal])
    virtual, out, v_seconds, v_counts = _fleet_exec("fleet", [
        *AGREE_ARGV, "--fleet-hosts", "0", "--fleet-workers-per-host", "0",
        "--calibrate-from", journal, "--fleet-profile", profile])

    def gold(res):
        return min(res.extra["serve"]["classes"].values(),
                   key=lambda c: c["priority"])["slo_attainment"]

    t_gold, v_gold = gold(threaded), gold(virtual)
    t_ev = threaded.extra["membership"]["events"][0]
    v_ev = virtual.extra["membership"]["events"][0]
    prof = virtual.extra["fleet"]["profile"]
    delta = None if t_gold is None or v_gold is None else \
        (v_gold - t_gold) * 100.0
    line = {"phase": "fleet", "mode": "fleet_agree",
            "launches": {"land": t_counts["land"] + v_counts["land"],
                         "checksum": t_counts["checksum"]
                         + v_counts["checksum"]},
            "seconds": t_seconds + v_seconds,
            "threaded": {"gold_slo": t_gold, "seconds": t_seconds,
                         "arrivals": threaded.extra["serve"]["arrivals"],
                         "event": {k: t_ev[k] for k in (
                             "action", "host", "epoch", "t_s")}},
            "virtual": {"gold_slo": v_gold, "seconds": v_seconds,
                        "arrivals": virtual.extra["serve"]["arrivals"],
                        "event": {k: v_ev[k] for k in (
                            "action", "host", "epoch", "t_s")},
                        "sim": virtual.extra["fleet"]["sim"]},
            "gold_slo_delta_pts": delta,
            "fitted": {ph: prof[ph] for ph in ("origin", "peer")},
            "card": smi, "reduced": FLEET_REDUCED}
    emit(line)
    check(prof["origin"]["source"] == "fitted",
          f"fleet/fleet_agree: origin not fitted {prof['origin']}")
    check("fleet profile written" in out, "fleet/fleet_agree: no profile")
    check(threaded.errors == virtual.errors == 0,
          f"fleet/fleet_agree: errors {threaded.errors}/{virtual.errors}")
    check(line["threaded"]["arrivals"] == line["virtual"]["arrivals"],
          "fleet/fleet_agree: the arms offered different schedules")
    check((t_ev["action"], t_ev["host"], t_ev["epoch"])
          == (v_ev["action"], v_ev["host"], v_ev["epoch"])
          == ("kill_host", 1, 1),
          f"fleet/fleet_agree: events {t_ev} vs {v_ev}")
    check(delta is not None and abs(delta) <= 2.0,
          f"fleet/fleet_agree: gold SLO threaded {t_gold} vs virtual "
          f"{v_gold} (the gate allows 2 points)")
    return line


def phase_fleet(smi) -> dict:
    """fleet_scale, fleet_max, fleet_sweep and fleet_agree; none launches
    a kernel. Returns the launch counts."""
    import os

    t_phase = time.perf_counter()
    os.makedirs(f"{BUILD}/fleet", exist_ok=True)
    launches = {}
    for mode, run in (("fleet_scale", _fleet_scale), ("fleet_max", _fleet_max),
                      ("fleet_sweep", _fleet_sweep),
                      ("fleet_agree", _fleet_agree)):
        launches[f"fleet/{mode}"] = run(smi)["launches"]
    emit({"phase": "fleet_total", "seconds": time.perf_counter() - t_phase,
          "card": smi, "reduced": FLEET_REDUCED})
    return launches


# ------------------------------------------------------------- phase 26 --
def phase_check(smi) -> dict:
    """``check --json`` over the port's tree on this machine, every drift
    guard included (the native-counters guard builds and probes the
    engine here): exit 0, no finding, no stale allowlist entry, no guard
    skipped, every file scanned. The seconds of each pass and guard are
    the run's own. No kernel launches."""
    import contextlib
    import io
    from pathlib import Path

    from tpubench_torch.analysis import run_cli_check
    from tpubench_torch.kernels import landing

    landing.reset_launches()
    buf, kept = io.StringIO(), []
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = run_cli_check(json_out=True, keep=kept)
    seconds = time.perf_counter() - t0
    doc = json.loads(buf.getvalue())
    counts = _launch_counts()
    py_files = len(list((Path(__file__).resolve().parent
                         / "tpubench_torch").rglob("*.py")))
    line = {"phase": "check", "mode": "check", "launches": counts, "rc": rc,
            "seconds": seconds, "summary": doc["summary"],
            "files_scanned": doc["files_scanned"], "passes": doc["passes"],
            "skipped": doc["skipped"], "stale": doc["stale_allowlist"],
            "pass_seconds": kept[0].seconds if kept else None, "card": smi}
    emit(line)
    check(rc == 0 and doc["summary"]["findings"] == 0
          and not doc["stale_allowlist"],
          f"check: rc {rc}, {doc['summary']}")
    check(doc["skipped"] == [] and "drift" in doc["passes"],
          f"check: guards skipped {doc['skipped']}")
    check(doc["files_scanned"] == py_files,
          f"check: {doc['files_scanned']} files of {py_files}")
    check(counts == {"land": 0, "checksum": 0}, f"check: launched {counts}")
    return {"check/check": counts}


if __name__ == "__main__":
    sys.exit(main())
