"""The port's virtual-time fleet engine (``tpubench_torch.fleet``) against
``tpubench``'s on the same inputs: the event loop, journal calibration,
the ``fleet`` config section, the generated timelines, ``run_fleet`` and
its sweep, the report block and the CLI — exact everywhere, since virtual
time makes a run a pure function of its config and seeds (only the
fields that time the simulation itself on the host's clock differ). Then
the port's own agreement gate: its threaded ``run_serve`` against its
``run_fleet`` calibrated from that run's journal, gold SLO within ±2
points (the reference's own gate) and the sweep knee on the same rung.
"""

import json
import os

import pytest
import torch

from tpubench.config import BenchConfig as JaxConfig
from tpubench.config import validate_fleet_config as jax_validate
from tpubench.fleet import calibrate as jax_cal
from tpubench.fleet import driver as jax_driver
from tpubench.fleet import vtime as jax_vtime
from tpubench.workloads import report_cmd as jax_report
from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, validate_fleet_config
from tpubench_torch.fleet import calibrate, driver, vtime
from tpubench_torch.workloads import report_cmd

MB = 1 << 20
CHUNK = 64 * 1024
DEFAULTS = {"hit": 0.05, "peer": 0.5, "origin": 4.0, "cross_pod": 1.5}
# The fields that time the simulation on the host's clock
# (``tpubench/fleet/driver.py:678-686``): the only ones two runs may differ in.
WALL_FIELDS = ("real_wall_s", "speedup", "hosts_per_wall_s")


def _both(mutate):
    """The same config in both packages (built in ``tpubench``'s, carried
    across as its ``--save-config`` JSON)."""
    ref = JaxConfig()
    mutate(ref)
    return BenchConfig.from_json(ref.to_json()), ref


def _plain(doc):
    return json.loads(json.dumps(doc))


def _without_wall(fleet: dict) -> dict:
    out = _plain(fleet)
    for k in WALL_FIELDS:
        out["sim"].pop(k, None)
    return out


# ---------------------------------------------------- the event loop --------

def _order_and_ties(ev, _clock):
    loop, fired = ev(), []
    loop.call_at(2.0, lambda: fired.append(("b", loop.clock.now())))
    loop.call_at(1.0, lambda: fired.append(("a", loop.clock.now())))
    loop.call_at(3.0, lambda: fired.append(("c1", loop.clock.now())))
    loop.call_at(3.0, lambda: fired.append(("c2", loop.clock.now())))
    end = loop.run()
    return fired, end, loop.events_fired, loop.pending


def _past_clamps(ev, _clock):
    loop, fired = ev(), []

    def first():
        fired.append(loop.clock.now())
        loop.call_after(-5.0, lambda: fired.append(loop.clock.now()))
        loop.call_at(0.25, lambda: fired.append(("past", loop.clock.now())))
        loop.call_after(0.5, lambda: fired.append(loop.clock.now()))

    loop.call_at(1.0, first)
    return fired, loop.run(), loop.events_fired


def _wait_until(ev, _clock):
    loop, state = ev(), {"ready": False, "ok": None, "timeout": None}
    loop.call_at(0.3, lambda: state.__setitem__("ready", True))
    loop.wait_until(lambda: state["ready"],
                    lambda: state.__setitem__("ok", loop.clock.now()),
                    poll_s=0.1)
    loop.wait_until(lambda: False, lambda: None, poll_s=0.05,
                    deadline_s=0.2,
                    on_timeout=lambda: state.__setitem__(
                        "timeout", loop.clock.now()))
    end = loop.run()
    try:
        loop.wait_until(lambda: True, lambda: None, poll_s=0.0)
    except ValueError as e:
        state["refused"] = str(e)
    return state, end, loop.events_fired


def _run_until(ev, _clock):
    loop, fired = ev(), []
    loop.call_at(1.0, lambda: fired.append(1.0))
    loop.call_at(5.0, lambda: fired.append(5.0))
    first = (loop.run(until_s=2.0), list(fired), loop.pending)
    return first, loop.run(), fired, loop.pending


def _ns_rounding(_ev, clock):
    c = clock()
    out = []
    for t in (0.080, 0.01, 0.123456789, 1.9999999999, 3.0000000005):
        c._advance_to(t)
        out.append((c.now(), c.now_ns()))
    return out


@pytest.mark.parametrize("scenario", [
    _order_and_ties, _past_clamps, _wait_until, _run_until, _ns_rounding,
], ids=lambda f: f.__name__.strip("_"))
def test_event_loop_and_clock_match_reference(scenario):
    ours = scenario(vtime.EventLoop, vtime.VirtualClock)
    theirs = scenario(jax_vtime.EventLoop, jax_vtime.VirtualClock)
    assert ours == theirs


def test_event_loop_kernel_contract():
    """The contract the simulated workers ride on, on the port's loop:
    FIFO at a tick, a past timestamp fires now, the horizon parks."""
    fired, end, n, pending = _order_and_ties(vtime.EventLoop, None)
    assert [f[0] for f in fired] == ["a", "b", "c1", "c2"]
    assert (end, n, pending) == (3.0, 4, 0)
    fired, _, _ = _past_clamps(vtime.EventLoop, None)
    assert fired == [1.0, 1.0, ("past", 1.0), 1.5]
    (parked, early, left), end, fired, pending = _run_until(
        vtime.EventLoop, None)
    assert (parked, early, left) == (2.0, [1.0], 1)
    assert (end, fired, pending) == (5.0, [1.0, 5.0], 0)
    ticks = _ns_rounding(None, vtime.VirtualClock)
    # Rounded, never truncated; advancing backwards clamps.
    assert ticks[:3] == [(0.080, 80_000_000), (0.080, 80_000_000),
                         (0.123456789, 123_456_789)]


# ------------------------------------------------------- calibration --------

def _journal(path, records):
    path.write_text(json.dumps({
        "format": "tpubench-flight-v1", "journal_schema": 2, "host": 0,
        "time": 0.0, "dropped": 0, "records": records,
    }))
    return str(path)


def _miss(t0, dur):
    return {"phases": {"cache_miss": t0, "body_complete": t0 + dur}}


def _owner(t0, dur):
    return {"phases": {"owner_fetch": t0, "body_complete": t0 + dur}}


def _peer(t0, dur):
    return {"phases": {"peer_request": t0, "peer_hit": t0 + dur}}


def _journals(tmp_path, case):
    if case == "fitted":
        recs = [_miss(i * 10_000_000, 4_000_000 + 37_000 * i)
                for i in range(20)]
        recs += [_owner(i, 2_500_000 + 1000 * i) for i in range(5)]
        recs += [_peer(i * 10_000_000, 1_000_000 + 9_000 * i)
                 for i in range(20)]
        return [_journal(tmp_path / "j.json", recs)]
    if case == "too_few":
        return [_journal(tmp_path / "j.json",
                         [_miss(0, 2_000_000)] * (calibrate.MIN_SAMPLES - 1))]
    good = _journal(tmp_path / "good.json",
                    [_miss(i, 3_000_000 + i) for i in range(8)]
                    + [_peer(i, 900_000) for i in range(8)])
    torn = tmp_path / "torn.json"
    torn.write_text('{"format": "tpubench-flight-v1", "records": [{')
    empty = tmp_path / "empty.json"
    empty.write_text("")
    return [good, str(torn), str(empty)]


@pytest.mark.parametrize("case", ["fitted", "too_few", "torn"])
def test_fit_profile_matches_reference(tmp_path, capsys, case):
    paths = _journals(tmp_path, case)
    ours = calibrate.fit_profile(paths, defaults=DEFAULTS)
    our_err = capsys.readouterr().err
    theirs = jax_cal.fit_profile(paths, defaults=DEFAULTS)
    their_err = capsys.readouterr().err
    assert ours.to_dict() == theirs.to_dict()
    assert ours.summary() == theirs.summary()
    assert our_err == their_err
    src = {n: d.source for n, d in ours.phases.items()}
    if case == "too_few":
        assert "using the configured constant" in our_err
        assert src["origin"] == "constant"
    else:
        assert src == {"hit": "constant", "peer": "fitted",
                       "origin": "fitted", "cross_pod": "constant"}
    if case == "torn":
        assert "warning" in our_err and "skipped" in our_err


def test_profile_round_trips_between_packages(tmp_path):
    prof = calibrate.FleetProfile.from_constants(
        hit_ms=0.05, peer_ms=0.5, origin_ms=4.0, cross_pod_ms=1.5)
    prof.phases["origin"] = calibrate.ServiceDist.fit(
        [1.0, 2.0, 3.0, 4.0] * 4)
    ours = str(tmp_path / "ours.json")
    calibrate.save_profile(prof, ours)
    back = jax_cal.load_profile(ours)
    assert back.to_dict() == prof.to_dict()
    theirs = str(tmp_path / "theirs.json")
    jax_cal.save_profile(back, theirs)
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()
    assert calibrate.load_profile(theirs).summary() == prof.summary()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"format": "something-else/9"}))
    with pytest.raises(SystemExit, match="not a fleet profile"):
        calibrate.load_profile(str(bad))


def test_service_dist_draws_match_reference():
    import numpy as np

    samples = list(np.linspace(10.0, 20.0, 64))
    ours, theirs = (calibrate.ServiceDist.fit(samples),
                    jax_cal.ServiceDist.fit(samples))
    r1 = np.random.Generator(np.random.Philox(3))
    r2 = np.random.Generator(np.random.Philox(3))
    assert [ours.sample_s(r1) for _ in range(200)] == \
        [theirs.sample_s(r2) for _ in range(200)]
    assert ours.mean_ms() == theirs.mean_ms()


# ------------------------------------------------------ config section ------

@pytest.mark.parametrize("field, value", [
    ("hosts", 100_000), ("hosts", -1), ("pods", -2),
    ("workers_per_host", -1), ("objects", 0),
    ("timeline", "meteor_strike"), ("fail_fraction", 1.0),
    ("fail_fraction", float("nan")), ("origin_service_ms", 0.0),
    ("pause_penalty_ms", -1.0), ("upgrade_pause_s", 0.0), ("seed", -1),
    ("profile", []), ("pods", 9),
])
def test_validate_fleet_config_rejects_as_reference(field, value):
    def mutate(c):
        if field == "pods" and value == 9:
            c.fleet.hosts = 8
        setattr(c.fleet, field, value)

    ours, theirs = _both(mutate)
    with pytest.raises(SystemExit) as a:
        validate_fleet_config(ours.fleet, ours.serve)
    with pytest.raises(SystemExit) as b:
        jax_validate(theirs.fleet, theirs.serve)
    assert str(a.value) == str(b.value)


def test_fleet_section_is_typed_and_round_trips():
    from tpubench_torch.convert import from_reference

    ours, theirs = _both(lambda c: setattr(c.fleet, "hosts", 7))
    assert ours.raw == {} and ours.fleet.hosts == 7
    assert ours.to_dict() == theirs.to_dict()
    validate_fleet_config(ours.fleet, ours.serve)
    carried, _ = from_reference(theirs.to_dict(), [])
    assert carried.raw == {} and carried.fleet == ours.fleet


# ------------------------------------------------- generated timelines ------

@pytest.mark.parametrize("kind, n_hosts", [
    ("correlated_failure", 16), ("correlated_failure", 1024),
    ("rolling_upgrade", 4), ("none", 8),
])
def test_build_fleet_timeline_matches_reference(kind, n_hosts):
    def mutate(c):
        fc = c.fleet
        fc.timeline, fc.fail_fraction, fc.fail_at_s = kind, 0.25, 0.5
        fc.recover_s, fc.upgrade_pause_s = 0.3, 0.1

    ours, theirs = _both(mutate)
    tl = driver.build_fleet_timeline(ours.fleet, n_hosts)
    assert tl == jax_driver.build_fleet_timeline(theirs.fleet, n_hosts)
    if kind == "correlated_failure":
        kills = [e for e in tl if "kill_host" in e[2]]
        assert len(kills) == round(0.25 * n_hosts)
        assert len(tl) == 2 * len(kills)


# ------------------------------------------------------------ run_fleet -----

def _small(c):
    """The small shape: 16 hosts in 2 pods, a correlated failure that
    recovers, diurnal arrivals from 2,000 tenants for 0.5 s."""
    c.workload.object_size = MB
    c.workload.granule_bytes = CHUNK
    c.obs.export = "none"
    fc = c.fleet
    fc.hosts, fc.pods, fc.seed = 16, 2, 20
    fc.timeline, fc.fail_at_s, fc.fail_fraction = "correlated_failure", 0.2, 0.25
    fc.recover_s = 0.15
    sv = c.serve
    sv.seed, sv.arrival, sv.duration_s = 20, "diurnal", 0.5
    sv.rate_rps, sv.tenants = 4000.0, 2000


@pytest.fixture(scope="module")
def small_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet")

    def mutate(c):
        _small(c)
        c.obs.flight_journal = str(d / "fleet.json")

    ours, theirs = _both(mutate)
    res = driver.run_fleet(ours, device="cpu")
    theirs.obs.flight_journal = str(d / "ref.json")
    return res, jax_driver.run_fleet(theirs), d


def test_run_fleet_matches_reference(small_runs):
    ours, theirs, _ = small_runs
    a, b = _plain(ours.to_dict()), _plain(theirs.to_dict())
    # The one config difference: each package wrote its own journal.
    assert a["config"]["obs"].pop("flight_journal").endswith("fleet.json")
    assert b["config"]["obs"].pop("flight_journal").endswith("ref.json")
    assert a["extra"]["serve"] == b["extra"]["serve"]
    assert a["extra"]["membership"] == b["extra"]["membership"]
    assert _without_wall(a["extra"]["fleet"]) == \
        _without_wall(b["extra"]["fleet"])
    for key in ("summaries", "bytes_total", "wall_seconds", "errors",
                "workload", "config"):
        assert a[key] == b[key], key
    fl, mb = a["extra"]["fleet"], a["extra"]["membership"]
    assert fl["hosts"] == 16 and fl["pods"] == 2 and fl["tenants"] == 2000
    assert fl["cross_pod"]["hits"] > 0
    kills = [e for e in mb["events"] if e["action"] == "kill_host"]
    assert len(kills) == 4 and all(e["applied"] for e in kills)
    assert [e["action"] for e in mb["events"]].count("rejoin_host") == 4
    assert ours.errors == 0


def test_fleet_journal_and_block_match_reference(small_runs):
    ours, theirs, d = small_runs
    assert driver.format_fleet_block(_without_wall(ours.extra["fleet"])) == \
        jax_driver.format_fleet_block(_without_wall(theirs.extra["fleet"]))
    text = driver.format_fleet_block(ours.extra["fleet"])
    assert "virtual_s" in text and "hosts/wall-second" in text
    doc = json.loads((d / "fleet.json").read_text())
    ref = json.loads((d / "ref.json").read_text())
    assert any(r.get("kind") == "fleet" for r in doc["records"])
    assert [r.get("kind") for r in doc["records"]] == \
        [r.get("kind") for r in ref["records"]]


def test_report_renders_fleet_result_as_reference(small_runs, tmp_path):
    ours, _, _ = small_runs
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(ours.to_dict()))
    text = report_cmd.run_report([str(path)])
    assert text == jax_report.run_report([str(path)])
    for block in ("serve scorecard", "membership resize scorecard",
                  "== fleet simulation ==", "kill_host"):
        assert block in text


def test_fleet_sweep_knee_on_the_reference_rung():
    def mutate(c):
        c.workload.object_size = MB
        c.workload.granule_bytes = CHUNK
        c.obs.export = "none"
        c.pipeline.cache_bytes = 0
        c.serve.seed, c.serve.duration_s = 7, 1.0
        c.serve.rate_rps, c.serve.tenants, c.serve.workers = 40.0, 30, 2
        c.serve.sweep_points = [0.5, 1.0, 8.0]
        c.fleet.hosts = c.fleet.workers_per_host = 0
        c.fleet.origin_service_ms = 20.0

    ours, theirs = _both(mutate)
    a = driver.run_fleet_sweep(ours, device="cpu")
    b = jax_driver.run_fleet_sweep(theirs)
    sa, sb = a.extra["serve"]["sweep"], b.extra["serve"]["sweep"]
    assert sa == sb
    assert sa["knee"] is not None and sa["knee"]["index"] == 2
    assert _without_wall(a.extra["fleet"]) == _without_wall(b.extra["fleet"])


def test_fleet_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _both(_small)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_fleet(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_fleet_sweep(cfg)


def test_fleet_cli_on_cpu(tmp_path, capsys):
    """``fleet --device cpu`` through the CLI: a journal calibrates a
    profile that is written, then loaded by a second run."""
    recs = [_miss(i * 10_000_000, 3_000_000 + 1000 * i) for i in range(16)]
    journal = _journal(tmp_path / "cal.json", recs)
    profile = str(tmp_path / "p.json")
    common = ["fleet", "--fleet-hosts", "8", "--serve-duration", "0.4",
              "--serve-rate", "200", "--fleet-timeline",
              "correlated_failure", "--fleet-fail-at", "0.2",
              "--results-dir", str(tmp_path), "--device", "cpu"]
    assert cli.main(common + ["--calibrate-from", journal,
                              "--fleet-profile", profile]) == 0
    out = capsys.readouterr().out
    assert "fleet profile written" in out
    for block in ("serve scorecard", "membership resize scorecard",
                  "fleet simulation"):
        assert block in out
    assert cli.main(common + ["--fleet-profile", profile]) == 0
    files = sorted(f for f in os.listdir(tmp_path)
                   if f.startswith("fleet_"))
    assert len(files) == 2
    docs = [json.loads((tmp_path / f).read_text()) for f in files]
    for doc in docs:
        assert doc["workload"] == "fleet" and doc["errors"] == 0
        assert doc["extra"]["fleet"]["profile"]["origin"]["source"] == \
            "fitted"
    with pytest.raises(SystemExit):
        cli.main(["fleet", "--fleet-hosts", "8", "--fleet-pods", "9",
                  "--device", "cpu"])


# ---------------------------------------------------- agreement gate --------

def _agreement_cfg(duration=1.2, rate=250.0, seed=11):
    """The 4-host elastic serve scenario both arms run
    (``tests/test_fleet.py``'s): threaded through ``run_serve`` (fake
    backend, 4 ms a read), virtual through ``run_fleet`` with
    ``fleet.hosts = workers_per_host = 0`` so the pod shape and worker
    count are the serve plane's."""
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = MB
    cfg.workload.granule_bytes = CHUNK
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    cfg.pipeline.cache_bytes = 64 * MB
    cfg.transport.fault.per_read_latency_s = 0.004
    cfg.transport.fault.seed = seed
    sv = cfg.serve
    sv.seed, sv.duration_s, sv.rate_rps = seed, duration, rate
    sv.tenants, sv.workers, sv.hosts = 24, 4, 4
    sv.resize_window_s = 0.4
    t = duration * 0.45
    sv.membership_timeline = [[t, t, {"kill_host": 1}]]
    cfg.fleet.hosts = 0
    cfg.fleet.workers_per_host = 0
    return cfg


def _gold(sv: dict) -> dict:
    return min(sv["classes"].values(), key=lambda c: c["priority"])


def test_agreement_gate_gold_slo_within_2_points(tmp_path):
    """The port's threaded serve and its virtual fleet, calibrated from
    the threaded run's own journal, agree on gold SLO within ±2 points
    and apply the same kill at the same epoch."""
    from tpubench_torch.workloads.serve import run_serve

    cfg = _agreement_cfg()
    cfg.obs.flight_journal = str(tmp_path / "agree.json")
    threaded = run_serve(cfg, device="cpu")
    vcfg = _agreement_cfg()
    fc = vcfg.fleet
    prof = calibrate.fit_profile([cfg.obs.flight_journal], defaults={
        "hit": fc.hit_service_ms, "peer": fc.peer_service_ms,
        "origin": fc.origin_service_ms, "cross_pod": fc.cross_pod_ms,
    })
    assert prof.phases["origin"].source == "fitted"
    fc.profile = prof.to_dict()
    virtual = driver.run_fleet(vcfg, device="cpu")
    tsv, vsv = threaded.extra["serve"], virtual.extra["serve"]
    assert tsv["arrivals"] == vsv["arrivals"]
    t_gold = _gold(tsv)["slo_attainment"]
    v_gold = _gold(vsv)["slo_attainment"]
    assert abs(t_gold - v_gold) <= 0.02, (t_gold, v_gold)
    te = threaded.extra["membership"]["events"][0]
    ve = virtual.extra["membership"]["events"][0]
    assert (te["action"], te["host"], te["epoch"]) == \
        (ve["action"], ve["host"], ve["epoch"]) == ("kill_host", 1, 1)


def test_agreement_gate_knee_on_same_rung():
    """The port's threaded serve sweep and its virtual fleet sweep put
    the knee on the same rung (service 20 ms, capacity ~100/s, rungs at
    20/s, 40/s and 320/s: only the saturated rung can trip the knee)."""
    from tpubench_torch.workloads.serve import run_serve_sweep

    def arms_cfg():
        cfg = BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.workload.workers = 4
        cfg.workload.object_size = MB
        cfg.workload.granule_bytes = CHUNK
        cfg.obs.export = "none"
        cfg.pipeline.cache_bytes = 0
        cfg.transport.fault.per_read_latency_s = 0.020
        cfg.transport.fault.seed = 7
        cfg.serve.seed, cfg.serve.duration_s = 7, 1.0
        cfg.serve.rate_rps, cfg.serve.tenants, cfg.serve.workers = 40.0, 30, 2
        cfg.serve.sweep_points = [0.5, 1.0, 8.0]
        cfg.fleet.hosts = cfg.fleet.workers_per_host = 0
        cfg.fleet.origin_service_ms = 20.0
        return cfg

    t = run_serve_sweep(arms_cfg(), device="cpu").extra["serve"]["sweep"]
    v = driver.run_fleet_sweep(arms_cfg(), device="cpu").extra["serve"][
        "sweep"]
    assert t["knee"] is not None and v["knee"] is not None
    assert t["knee"]["index"] == v["knee"]["index"]
