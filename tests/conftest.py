"""Test harness: force JAX onto a simulated 8-device CPU host (SURVEY §4).

Must run before anything imports jax, hence module-level env mutation in
conftest. Bench runs (bench.py) use the real TPU; tests never do.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # override (env may pin the real TPU platform)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# The TPU plugin in this image rewrites JAX_PLATFORMS at import time, so the
# env var alone is not enough — pin the platform via config too.
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def jax_cpu_devices():
    devices = jax.devices()
    assert len(devices) == 8, f"expected 8 simulated devices, got {devices}"
    return devices


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running hygiene/stress tests")
    # Tier-1 runs `-m 'not slow'` under JAX_PLATFORMS=cpu: flight-recorder
    # tests are deliberately NOT slow-marked so the observability layer is
    # exercised on every tier-1 pass; the marker exists for selective runs
    # (`-m flight`).
    config.addinivalue_line(
        "markers", "flight: flight-recorder observability tests"
    )
    # Chaos tests (tail tolerance + scheduled fault timelines) stay in
    # tier-1 — same policy as `flight`: not slow-marked, so the
    # resilience layer is exercised on every pass; the marker exists for
    # selective runs (`-m chaos`).
    config.addinivalue_line(
        "markers", "chaos: tail-tolerance / fault-timeline tests"
    )
    # Pipeline tests (chunk cache / prefetcher / train-ingest) stay in
    # tier-1 — same policy as `flight`/`chaos`: not slow-marked, so the
    # ingest pipeline is exercised on every pass; the marker exists for
    # selective runs (`-m pipeline`).
    config.addinivalue_line(
        "markers", "pipeline: ingest pipeline (cache/prefetch/train-ingest)"
    )
    # Slab tests (zero-copy datapath: refcounted pinned-buffer pool,
    # copies-per-byte accounting, lease-lifecycle-under-faults) stay in
    # tier-1 — same policy as `pipeline`: not slow-marked, so the
    # copy-regression guard runs on every pass; the marker exists for
    # selective runs (`-m slab`).
    config.addinivalue_line(
        "markers", "slab: zero-copy slab datapath (mem/ pool + copy guard)"
    )
    # Tune tests (adaptive autotuner: controller convergence, live
    # actuation, knob-drift guard) stay in tier-1 — same policy as
    # `pipeline`/`slab`: not slow-marked, so the controller is exercised
    # on every pass; the marker exists for selective runs (`-m tune`).
    config.addinivalue_line(
        "markers", "tune: adaptive autotuner (controller/sweep/actuation)"
    )
    # Staging tests (overlapped executor: depth-K in-flight window,
    # out-of-order completion, lease-release-at-completion, depth A/B)
    # stay in tier-1 — same policy as `pipeline`/`slab`: not slow-marked,
    # so the transfer-overlap regression guard runs on every pass; the
    # marker exists for selective runs (`-m staging`).
    config.addinivalue_line(
        "markers", "staging: overlapped staging executor (in-flight window)"
    )
    # Telemetry tests (live metrics registry, /metrics endpoint, journal
    # tailing, `tpubench top`) stay in tier-1 — same policy as the
    # other subsystem markers: not slow-marked, so the live-vs-post-hoc
    # agreement guard runs on every pass; the marker exists for
    # selective runs (`-m telemetry`).
    config.addinivalue_line(
        "markers", "telemetry: live telemetry plane (registry/endpoint/top)"
    )
    # Coop tests (pod-scale cooperative chunk cache: consistent-hash
    # ring, peer channels, pod-wide single-flight, straggler demotion)
    # stay in tier-1 — same policy as the other subsystem markers: the
    # hermetic multi-"host" suite runs threaded hosts over the loopback
    # peer channel in-process, so it needs no TPU or multihost env; the
    # real-ICI channel rides the env-gated `multihost` marker instead.
    config.addinivalue_line(
        "markers", "coop: cooperative chunk cache (ring/peer/single-flight)"
    )
    # Trace-plane tests (causal span trees: per-trace sampling, context
    # propagation, journal stitching, critical-path attribution, the
    # span-drift guard) stay in tier-1 — same policy as the other
    # subsystem markers: not slow-marked, so the cross-host stitch and
    # the drift guard run on every pass; the marker exists for
    # selective runs (`-m tracing`).
    config.addinivalue_line(
        "markers", "tracing: causal trace plane (context/stitch/blame)"
    )
    # Serve-plane tests (tests/test_serve.py) stay in tier-1 — same
    # policy as the other subsystem markers: the QoS A/B acceptance and
    # the knee sweep run on every pass; the marker exists for selective
    # runs (`-m serve`).
    config.addinivalue_line(
        "markers", "serve: open-loop multi-tenant serve plane "
                   "(arrivals/QoS/knee)"
    )
    # Reactor tests (the epoll-mode native executor: SPSC-ring drains,
    # doorbell coalescing, destroy ordering, stale-.so degrade) stay in
    # tier-1 — same policy as the other subsystem markers: not
    # slow-marked, so the dispatch-path rewrite is exercised on every
    # pass; the marker exists for selective runs (`-m reactor`).
    config.addinivalue_line(
        "markers", "reactor: epoll-mode native executor "
                   "(event loop/rings/doorbell)"
    )
    # Analysis tests (the invariant-analysis plane: `tpubench check`
    # passes, allowlist policy, drift registry, lock-order graph) stay
    # in tier-1 — the tree-is-clean gate is the whole point: a new
    # lifecycle/hygiene/bounds/drift violation fails CI, not review.
    # The marker exists for selective runs (`-m analysis`).
    config.addinivalue_line(
        "markers", "analysis: invariant-analysis plane "
                   "(tpubench check / drift registry / lock graph)"
    )
    # Membership tests (elastic pod membership: state machine, warm
    # handoff, killed-owner degradation, the 4-host elastic acceptance)
    # stay in tier-1 — same policy as the other subsystem markers: the
    # resize acceptance runs on every pass; the marker exists for
    # selective runs (`-m membership`).
    config.addinivalue_line(
        "markers", "membership: elastic pod membership "
                   "(state machine/handoff/resize scorecard)"
    )
    # Lifecycle tests (storage-lifecycle plane: resumable uploads +
    # preconditions + pagination, ckpt save/restore roundtrip under
    # fault timelines, meta-storm knee) stay in tier-1 — same policy as
    # the other subsystem markers: the zero-corrupt-finalizes roundtrip
    # acceptance runs on every pass; the marker exists for selective
    # runs (`-m lifecycle`).
    config.addinivalue_line(
        "markers", "lifecycle: storage-lifecycle plane "
                   "(resumable uploads/ckpt roundtrip/meta storm)"
    )
    # Multihost tests are marker-gated (see tests/test_multihost.py):
    # they need working multi-process jax.distributed, which this
    # container lacks — tier-1 collects clean skips, not failures.
    config.addinivalue_line(
        "markers", "multihost: multi-process jax.distributed tests "
                   "(TPUBENCH_MULTIHOST_TESTS=1 to enable)"
    )
    # gRPC tests run hermetically in tier-1 against the dependency-free
    # wire stack (tpubench/storage/grpc_wire) — no grpcio, no generated
    # storage-v2 stubs needed. The handful of tests that exercise the
    # OPTIONAL grpcio/gapic library mode (channel construction,
    # DirectPath c2p resolver) are env-gated like `multihost`: they need
    # the real libraries installed, which this container lacks.
    config.addinivalue_line(
        "markers", "grpc_lib: grpcio/storage-v2 library-mode tests "
                   "(TPUBENCH_GRPC_LIB_TESTS=1 to enable)"
    )
    # Record/replay plane tests stay in tier-1 (same policy as the
    # other subsystem markers): bundle byte-determinism and the
    # replay-vs-original tolerance gate run on every pass; the marker
    # exists for selective runs (`-m replay`).
    config.addinivalue_line(
        "markers", "replay: record/replay + regression plane "
                   "(bundle determinism/replay fidelity/--fail-on gate)"
    )
    # Incident-drill tests (restore-while-serving on the elastic pod +
    # delta checkpoint saves) stay in tier-1 — same policy as the other
    # subsystem markers: the hermetic kill→cold-join→restore acceptance
    # and the CAS/delta-ledger contracts run on every pass; the marker
    # exists for selective runs (`-m drill`).
    config.addinivalue_line(
        "markers", "drill: incident drill (restore-while-serving/"
                   "delta saves/drill scorecard)"
    )
    # Fleet tests (virtual-time fleet engine: event-loop kernel,
    # journal calibration, the threaded-vs-virtual agreement gate, the
    # 1024-host correlated-failure acceptance) stay in tier-1 — the
    # whole plane exists to be fast, so even the 1024-host scenario
    # runs on every pass; the marker exists for selective runs
    # (`-m fleet`).
    config.addinivalue_line(
        "markers", "fleet: virtual-time fleet simulation "
                   "(event loop/calibration/agreement gate)"
    )
    # Tests of the PyTorch port's CUDA kernels, which have no CPU mode:
    # they skip without a CUDA device (decided inside a fixture, never at
    # import) and run on the card with `pytest tests/test_torch_*.py -m cuda`.
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (tpubench_torch kernels)"
    )
