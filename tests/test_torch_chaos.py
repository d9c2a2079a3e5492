"""The port's ``chaos`` entry point (``tpubench_torch/workloads/chaos.py``)
against ``tpubench``'s.

* Exact parity (tolerance 0) on seeded inputs: ``scaled_fault_dict``,
  ``resilience_scorecard`` and ``format_scorecard`` on the same record
  lists, the CLI's shorthand timelines, every refusal message, and
  ``report``'s text over chaos documents (one, and the A/B of two).
* End to end on the CPU, at the reference tests' small shapes:
  - ``read`` under the fake store's stall window
    (``tests/test_chaos.py:141``) through both packages: the same fault
    window, the same segments and scorecard keys, every read accounted
    for; the port's arm staged through the copy ring with
    ``checksum_ok`` (``tpubench``'s chaos read stages nothing);
  - ``pod-ingest`` at 1 and 2 gloo ranks: every rank's shard fetch is a
    scorecard read, the gather verified;
  - ``train-ingest`` under a blackhole window with hedging and the
    watchdog: it shows as data-stall time and the run ends;
  - ``serve`` on a 3-host elastic pod with a ``kill_host`` together with
    a byte fault, the caller's config restored after.

The reference's chaos runs over the gRPC wire and its h2 hedge acceptance
are not driven here (one of them does not finish on the reference).
"""

from __future__ import annotations

import argparse
import json
import random
import threading
import time

import pytest

import tpubench.cli as jax_cli
from tpubench.config import BenchConfig as JaxConfig
from tpubench.workloads import chaos as jax_chaos
from tpubench.workloads import report_cmd as jax_report

from test_torch_dist import run_ranks
from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, DistConfig
from tpubench_torch.dist import bringup
from tpubench_torch.metrics.report import write_result
from tpubench_torch.workloads import chaos, report_cmd

MB = 1 << 20
# tests/test_chaos.py's stall window: stall << window, stall >> a
# healthy read.
STALL_TL = [[0.15, 0.9, {"stall_s": 0.2, "stall_rate": 0.6}]]


def chaos_cfg(cls=BenchConfig, calls=60, size=64 * 1024, pace=0.002):
    """``tests/test_chaos.py``'s ``chaos_cfg`` for either package."""
    cfg = cls()
    cfg.workload.workers = 2
    cfg.workload.read_calls_per_worker = calls
    cfg.workload.object_size = size
    cfg.workload.granule_bytes = 16 * 1024
    cfg.transport.protocol = "fake"
    cfg.transport.fault.per_read_latency_s = pace
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    return cfg


def _elastic_cfg(cls=BenchConfig, hosts=3, duration=1.2, rate=150.0):
    cfg = cls()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = MB
    cfg.workload.granule_bytes = 64 * 1024
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    cfg.pipeline.cache_bytes = 64 * MB
    sv = cfg.serve
    sv.seed, sv.duration_s, sv.rate_rps = 11, duration, rate
    sv.tenants, sv.workers, sv.hosts = 24, 4, hosts
    sv.resize_window_s = 0.4
    return cfg


def _keys_of(d):
    if isinstance(d, dict):
        return {k: _keys_of(v) for k, v in d.items()}
    return None


def _rec(t0: float, t1: float, nbytes: int, error=None, kind="read"):
    """A flight record on the scorecard's clock (epoch 0)."""
    rec = {"kind": kind, "bytes": nbytes,
           "phases": {"enqueue": int(t0 * 1e9),
                      "body_complete": int(t1 * 1e9)}}
    if error:
        rec["error"] = error
    return rec


# ------------------------------------------------------- pure functions ----


def test_scaled_fault_dict_matches_reference():
    rng = random.Random(3)
    for _ in range(40):
        plan = {f: rng.choice([0, 0.0, 0.25, 1.5]) for f in (
            "latency_s", "per_read_latency_s", "stall_s", "error_rate")}
        phases = [[rng.uniform(0, 2), rng.uniform(2, 4),
                   {"stall_s": rng.uniform(0, 1), "stall_rate": 0.5,
                    "latency_s": rng.choice([0, 0.1])}]
                  for _ in range(rng.randint(0, 3))]
        fdict = {**plan, "phases": phases, "seed": 3}
        for scale in (0.0, 0.25, 1.0, 3.0):
            before = json.dumps(fdict)
            ours = chaos.scaled_fault_dict(fdict, scale)
            assert ours == jax_chaos.scaled_fault_dict(fdict, scale)
            assert json.dumps(fdict) == before  # the input is untouched


def _record_lists():
    # tests/test_chaos.py:105's timeline: 1 read/100 ms, a slow window.
    base = [_rec(i * 0.1, i * 0.1 + 0.05, 1_000_000) for i in range(10)]
    base += [_rec(1.0 + i * 0.2, 1.5 + i * 0.2, 500_000) for i in range(5)]
    base += [_rec(2.0 + i * 0.1, 2.05 + i * 0.1, 1_000_000)
             for i in range(20)]
    yield base, [[1.0, 2.0, {}]], None
    yield [_rec(0.5, 0.6, 1000)], [[0.0, 1.0, {}]], None  # no baseline
    yield [], [[0.2, 0.4, {}]], None  # nothing read
    rng = random.Random(11)
    for _ in range(12):
        recs = []
        for _ in range(rng.randint(5, 200)):
            t0 = rng.uniform(0, 3)
            recs.append(_rec(t0, t0 + rng.expovariate(20),
                             rng.randint(1, 1 << 20),
                             error="boom" if rng.random() < 0.05 else None,
                             kind=rng.choice(["read", "read", "cache"])))
        t0 = rng.uniform(0.2, 1.5)
        phases = [[t0, t0 + rng.uniform(0, 1), {"stall_s": 0.1}],
                  [t0 + 0.1, t0 + rng.uniform(0.2, 1.5), {}]]
        tail = {
            "hedge": {"hedges": rng.randint(0, 9), "hedge_wins": 2,
                      "hedge_losses": 1, "wasted_bytes": 77},
            "watchdog": {"stalls": rng.randint(0, 3)},
            "breaker": {"opens": 1, "open_s": 0.25, "state": "closed"},
        } if rng.random() < 0.7 else None
        yield recs, phases, tail


def test_resilience_scorecard_matches_reference():
    n = 0
    for recs, phases, tail in _record_lists():
        ours = chaos.resilience_scorecard(recs, phases, 0, tail_stats=tail)
        theirs = jax_chaos.resilience_scorecard(recs, phases, 0,
                                                tail_stats=tail)
        assert ours == theirs
        doc = {"workload": "read", "scorecard": ours}
        assert chaos.format_scorecard(doc) == jax_chaos.format_scorecard(doc)
        n += 1
    assert n == 15
    first = chaos.resilience_scorecard(*next(iter(_record_lists()))[:2], 0)
    assert first["fault"]["reads"] == 3
    assert first["p99_inflation"] == pytest.approx(10.0, rel=0.05)


@pytest.mark.parametrize("fault", ["stall", "blackhole", "drip", "truncate",
                                   "reset", "error", "latency"])
def test_cli_shorthand_timelines_match_reference(fault):
    for given in ({}, {"fault_stall_s": 0.3, "fault_stall_rate": 0.5,
                       "fault_drip_bps": 1000.0, "fault_error_rate": 0.1,
                       "fault_truncate_after_bytes": 5,
                       "fault_reset_after_bytes": 7}):
        ns = argparse.Namespace(chaos_timeline=None, chaos_start=0.5,
                                chaos_duration=1.25, chaos_fault=fault,
                                **given)
        jns = argparse.Namespace(**vars(ns))
        if fault == "latency":
            ns.fault_latency_s, jns.fault_latency = 0.05, 0.05
        assert cli.chaos_timeline_from_args(ns) == \
            jax_cli.chaos_timeline_from_args(jns)
    tl = [[0.1, 0.2, {"kill_host": 1}], [0.0, 1.0, {"error_rate": 0.5}]]
    ns = argparse.Namespace(chaos_timeline=json.dumps(tl))
    assert cli.chaos_timeline_from_args(ns) == tl


REFUSALS = [
    ("no timeline", lambda cfg: None, "read"),
    ("real http", lambda cfg: (
        setattr(cfg.transport, "protocol", "http"),
        setattr(cfg.transport, "endpoint", "https://storage.googleapis.com"),
    ) and STALL_TL, "read"),
    ("real grpc", lambda cfg: (
        setattr(cfg.transport, "protocol", "grpc"),
        setattr(cfg.transport, "endpoint", "storage.googleapis.com:443"),
    ) and STALL_TL, "read"),
    ("local", lambda cfg: setattr(cfg.transport, "protocol", "local")
     or STALL_TL, "read"),
    ("bad rate", lambda cfg: [[0.1, 0.2, {"stall_rate": 1.5}]], "read"),
    ("bad window", lambda cfg: [[0.5, 0.2, {"stall_s": 1.0}]], "read"),
    ("unknown field", lambda cfg: [[0.1, 0.2, {"stall": 1.0}]], "read"),
    ("host fault, read", lambda cfg: [[0.1, 0.1, {"kill_host": 1}]], "read"),
    ("member window", lambda cfg: [[["x"], 1.0, {"kill_host": 1}]], "serve"),
    ("unknown workload", lambda cfg: STALL_TL, "stream"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=[c[0] for c in REFUSALS])
def test_refusals_match_reference(case, monkeypatch):
    """The same refusals with the same one-line messages, and the
    caller's config untouched after."""
    _, make, workload = case
    got = []
    for cls, run in ((BenchConfig, chaos.run_chaos),
                     (JaxConfig, jax_chaos.run_chaos)):
        cfg = chaos_cfg(cls)
        tl = make(cfg)
        before = json.dumps(cfg.to_dict(), sort_keys=True)
        kw = {"device": "cpu"} if run is chaos.run_chaos else {}
        with pytest.raises(SystemExit) as e:
            run(cfg, timeline=json.loads(json.dumps(tl)) if tl else None,
                chaos_workload=workload, **kw)
        got.append(str(e.value))
        if tl is None or workload == "stream":
            continue
        after = cfg.to_dict()
        after["transport"]["fault"]["phases"] = []
        base = json.loads(before)
        base["transport"]["fault"]["phases"] = []
        assert after == base
    assert got[0] == got[1]
    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "nope")
    with pytest.raises(SystemExit, match="TPUBENCH_BENCH_SLEEP_SCALE"):
        chaos.run_chaos(chaos_cfg(), timeline=STALL_TL, device="cpu")


# -------------------------------------------------------------- read arm ----


def test_read_under_stall_matches_reference(tmp_path):
    """``tests/test_chaos.py:141`` through both packages: the same fault
    window and scorecard structure, every read in a segment, the stall
    visible in the port's p99 and goodput back after the window."""
    def attempt():
        res = chaos.run_chaos(chaos_cfg(calls=100), timeline=STALL_TL,
                              device="cpu")
        jres = jax_chaos.run_chaos(chaos_cfg(JaxConfig, calls=100),
                                   timeline=[list(p) for p in STALL_TL])
        ch, jch = res.extra["chaos"], jres.extra["chaos"]
        sc, jsc = ch["scorecard"], jch["scorecard"]
        assert res.workload == jres.workload == "chaos"
        assert res.errors == jres.errors == 0
        assert ch["timeline"] == jch["timeline"]
        assert sc["fault_window_s"] == jsc["fault_window_s"]
        assert _keys_of(sc) == _keys_of(jsc)
        for s in (sc, jsc):
            assert sum(s[k]["reads"] for k in
                       ("baseline", "fault", "recovery")) == 200
            assert s["timeline_covered"] and s["failed_reads"] == 0
        assert sc["p99_inflation"] is not None and sc["p99_inflation"] > 1.5
        assert sc["time_to_recover_s"] is not None
        return res, jres

    try:  # probabilistic stalls on real clocks: one retry, as upstream
        res, jres = attempt()
    except AssertionError:
        res, jres = attempt()
    paths = [write_result(res, str(tmp_path), tag="a"),
             write_result(res, str(tmp_path), tag="b")]
    text = report_cmd.run_report(paths)
    assert text == jax_report.run_report(paths)
    assert "resilience scorecard" in text and "goodput retention" in text


@pytest.mark.parametrize("mode", ["device_put", "pallas"])
def test_read_arm_stages_through_the_ring(mode):
    """The port's read arm lands its bytes through the configured ring
    (the plain kernels on the CPU) and validates them."""
    cfg = chaos_cfg(calls=12, size=300_001, pace=0.0)
    cfg.staging.mode = mode
    cfg.staging.validate_checksum = mode == "device_put"
    cfg.staging.slot_bytes = 128 * 1024
    res = chaos.run_chaos(cfg, timeline=[[0.0, 0.05, {"latency_s": 0.001}]],
                          device="cpu")
    assert res.errors == 0 and res.extra["checksum_ok"] is True
    assert res.extra["staged_bytes"] == 2 * 12 * 300_001
    sc = res.extra["chaos"]["scorecard"]
    assert sum(sc[k]["reads"] for k in ("baseline", "fault", "recovery")) \
        == 24
    assert cfg.obs.flight_journal == "" and cfg.transport.fault.phases == [
        [0.0, 0.05, {"latency_s": 0.001}]]


def test_config_reusable_across_runs_over_http():
    """``tests/test_chaos.py:400`` on the port: a second run on the same
    config (the in-process HTTP/1.1 server) trips nothing."""
    cfg = chaos_cfg(calls=10, pace=0.0)
    cfg.transport.protocol = "http"
    r1 = chaos.run_chaos(cfg, timeline=[[0.01, 0.05, {"latency_s": 0.001}]],
                         device="cpu")
    assert cfg.transport.endpoint == "" and cfg.obs.flight_journal == ""
    r2 = chaos.run_chaos(cfg, timeline=[[0.01, 0.05, {"latency_s": 0.001}]],
                         device="cpu")
    assert r1.errors == 0 and r2.errors == 0
    assert "flight_journal" not in r2.extra


# ----------------------------------------------------------- pod-ingest ----


def _pod_cfg(world: int = 1, rank: int = 0) -> BenchConfig:
    """``tests/test_chaos.py:374``'s pod-ingest shape."""
    cfg = BenchConfig()
    cfg.workload.workers = 8
    cfg.workload.object_size = 512 * 1024
    cfg.workload.granule_bytes = 64 * 1024
    cfg.transport.protocol = "fake"
    cfg.transport.fault.per_read_latency_s = 0.001
    cfg.staging.mode = "device_put"
    cfg.obs.export = "none"
    cfg.transport.tail.hedge = True
    cfg.transport.tail.hedge_delay_s = 5.0  # never fires; stats still flow
    cfg.dist = DistConfig(num_processes=world, process_id=rank)
    return cfg


def _pod_rank(rank: int, world: int) -> dict:
    res = chaos.run_chaos(_pod_cfg(world, rank),
                          timeline=[[0.0, 0.5, {"latency_s": 0.01}]],
                          chaos_workload="pod-ingest", device="cpu")
    return {"errors": res.errors, "verified": res.extra["verified"],
            "scorecard": res.extra["chaos"]["scorecard"],
            "hedge_reads": res.extra["tail"]["hedge"]["reads"]}


def _check_pod(out: list) -> None:
    for r in out:
        sc = r["scorecard"]
        assert r["errors"] == 0 and r["verified"] is True
        assert sc["failed_reads"] == 0
        assert sc["fault"]["reads"] == 1  # this rank's shard fetch
        assert r["hedge_reads"] > 0 and sc["hedge"]["hedges"] == 0


def test_pod_ingest_arm_at_one_rank():
    with bringup.session(DistConfig(), "cpu", one_rank_group=True):
        out = [_pod_rank(0, 1)]
    _check_pod(out)


def test_pod_ingest_arm_at_two_gloo_ranks():
    _check_pod(run_ranks(_pod_rank, 2, timeout=90))


# --------------------------------------------------------- train-ingest ----


def test_train_ingest_blackhole_is_stall_time_not_a_hang():
    """A blackhole window over the step loop: every read opened in it
    stalls far past the hedge delay and the watchdog's window (the CLI's
    ``--chaos-fault blackhole`` stalls an hour; here 1 s, so that no
    stalled producer thread outlives the test). The hedged reader's
    watchdog cancels the stalled streams, the retry layer resumes them
    after the window, and the stall shows as data-stall time."""
    args = argparse.Namespace(chaos_timeline=None, chaos_start=0.0,
                              chaos_duration=0.2, chaos_fault="blackhole")
    assert cli.chaos_timeline_from_args(args)[0][2]["stall_s"] == 3600.0
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = MB
    cfg.workload.granule_bytes = 64 * 1024
    cfg.obs.export = "none"
    cfg.pipeline.steps = 10
    cfg.pipeline.batch_shards = 4
    cfg.pipeline.readahead = 2
    cfg.pipeline.prefetch_workers = 1
    cfg.pipeline.step_compute_ms = 5.0
    cfg.transport.fault.per_read_latency_s = 0.002
    cfg.transport.tail.hedge = True
    cfg.transport.tail.hedge_delay_s = 0.05
    cfg.transport.tail.watchdog = True
    cfg.transport.tail.stall_window_s = 0.1
    tl = [[0.0, 0.2, {"stall_s": 1.0, "stall_rate": 1.0,
                      "stall_after_bytes": 0}]]
    res = chaos.run_chaos(cfg, timeline=tl, chaos_workload="train-ingest",
                          device="cpu")
    assert res.workload == "chaos" and res.errors == 0
    assert res.extra["chaos"]["workload"] == "train-ingest"
    pipe = res.extra["pipeline"]
    assert pipe["stall"]["steps"] == 10
    assert pipe["stall"]["total_stall_ms"] > 100.0
    assert pipe["stall"]["stalled_steps"] >= 1
    assert res.extra["chaos"]["scorecard"]["stalls"] > 0
    deadline = time.monotonic() + 5.0
    while _hedge_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _hedge_threads(), "a stalled hedge producer outlived the run"


def _hedge_threads():
    return [t for t in threading.enumerate() if t.name.startswith("hedge-")]


# ---------------------------------------------------------------- serve ----


def test_serve_arm_composes_host_and_byte_faults(monkeypatch, tmp_path):
    """``tests/test_membership.py:608`` and ``:627`` on the port: a
    ``kill_host`` on the chaos timeline next to a byte fault, split into
    the membership plane; the caller's config comes back untouched."""
    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0.5")
    cfg = _elastic_cfg()
    tl = [[0.5, 0.5, {"kill_host": 2}], [0.2, 0.9, {"error_rate": 0.02}]]
    res = chaos.run_chaos(cfg, timeline=json.loads(json.dumps(tl)),
                          chaos_workload="serve", device="cpu")
    ch = res.extra["chaos"]
    assert ch["member_timeline"] == [[0.5, 0.5, {"kill_host": 2}]]
    assert ch["timeline"] and "error_rate" in ch["timeline"][0][2]
    assert ch["scorecard"]["fault_window_s"] == [0.1, 0.45]
    mb = res.extra["membership"]
    assert mb["events"][0]["action"] == "kill_host"
    assert mb["events"][0]["applied"] and mb["pool_leaked_slabs"] == 0
    sv = res.extra["serve"]
    assert sv["arrivals"] == sv["completed"] + sv["shed"] + sum(
        c["errors"] for c in sv["classes"].values())
    assert cfg.serve.membership_timeline == []
    assert cfg.transport.fault.phases == tl
    paths = [write_result(res, str(tmp_path))]
    text = report_cmd.run_report(paths)
    assert text == jax_report.run_report(paths)
    assert "membership resize scorecard" in text
    assert "resilience scorecard (serve" in text
