"""The port's serve plane (``tpubench_torch/serve/qos.py``,
``workloads/serve.py``, ``dist/membership.py``, ``replay/bundle.py``,
``storage/reactor_backend.py``, the typed ``serve`` config section and
``workloads/arrivals.mmpp_arrivals``) against ``tpubench``'s.

* Exact parity (tolerance 0: integers, strings and floats compared with
  ``==``) on seeded inputs: ``build_schedule`` request for request,
  ``build_tenants``, ``class_budget_split``, ``jain_index``, ``find_knee``,
  the admission queue under the virtual-clock cases of
  ``tests/test_serve.py``, ``Membership`` and ``ElasticFabric`` through
  one event sequence on one thread (owners, remap stats, handoff,
  counters), ``config_fingerprint`` and ``journal_replay_stamp`` for one
  ``--save-config`` JSON, ``validate_serve_config``'s messages, the CLI's
  serve flags, and ``report``'s text over serve and membership documents.
* End to end on the CPU, at the reference tests' small shapes: one run
  below capacity through both packages (every request completes; equal
  per-class arrivals and per-tenant bytes; the same scorecard keys); the
  QoS A/B and the 4-host kill-versus-leave acceptance on the port; a
  short sweep; ``serve --fetch-executor native`` behind the HTTP/1.1 fake,
  every fetch through the engine's pool; a failed pool start raises (the
  reference falls back to Python reads, the stated difference).
* The MMPP repair (ROADMAP C.6): the stuck shape ends within 1 s in the
  port and the port equals ``tpubench`` on the shapes where it ends.

The JAX package's modules imported here load no device code.
"""

from __future__ import annotations

import dataclasses
import json
import time

import pytest

from tpubench.config import BenchConfig as JaxConfig
from tpubench.config import ServeConfig as JaxServeConfig
from tpubench.config import validate_serve_config as jax_validate
from tpubench.dist import membership as jax_membership
from tpubench.pipeline import cache as jax_cache
from tpubench.pipeline import coop as jax_coop
from tpubench.pipeline import prefetch as jax_prefetch
from tpubench.replay import bundle as jax_bundle
from tpubench.serve import qos as jax_qos
from tpubench.storage import open_backend as jax_open_backend
from tpubench.storage.fake import FakeBackend as JaxFake
from tpubench.workloads import arrivals as jax_arrivals
from tpubench.workloads import report_cmd as jax_report
from tpubench.workloads import serve as jax_serve

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, ServeConfig, validate_serve_config
from tpubench_torch.dist import membership
from tpubench_torch.metrics.report import write_result
from tpubench_torch.pipeline import cache, coop, prefetch
from tpubench_torch.replay import bundle
from tpubench_torch.serve import qos
from tpubench_torch.storage import open_backend
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.workloads import arrivals, report_cmd, serve

MB = 1 << 20
CHUNK = 64 * 1024
PORT = dict(qos=qos, cache=cache, coop=coop, membership=membership,
            prefetch=prefetch, Fake=FakeBackend)
JAX = dict(qos=jax_qos, cache=jax_cache, coop=jax_coop,
           membership=jax_membership, prefetch=jax_prefetch, Fake=JaxFake)


def _serve_cfg(cls=BenchConfig, qos=True, rate=800.0, duration=1.0,
               svc_s=0.004, workers=2, seed=7):
    """``tests/test_serve.py``'s ``_serve_cfg`` for either package."""
    cfg = cls()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = 1 << 20
    cfg.workload.granule_bytes = 64 * 1024
    cfg.obs.export = "none"
    cfg.pipeline.cache_bytes = 0  # every request pays real service time
    cfg.transport.fault.per_read_latency_s = svc_s
    cfg.transport.fault.seed = seed
    cfg.serve.duration_s = duration
    cfg.serve.rate_rps = rate
    cfg.serve.tenants = 40
    cfg.serve.workers = workers
    cfg.serve.queue_limit = 16
    cfg.serve.qos = qos
    cfg.serve.seed = seed
    return cfg


def _elastic_cfg(action: str, *, hosts=4, duration=1.2, rate=250.0,
                 seed=11) -> BenchConfig:
    """``tests/test_membership.py``'s ``_elastic_cfg`` on the port."""
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = MB
    cfg.workload.granule_bytes = CHUNK
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    cfg.pipeline.cache_bytes = 64 * MB
    sv = cfg.serve
    sv.seed = seed
    sv.duration_s = duration
    sv.rate_rps = rate
    sv.tenants = 24
    sv.workers = 4
    sv.hosts = hosts
    sv.resize_window_s = 0.4
    t = duration * 0.45
    sv.membership_timeline = [[t, t, {action: 1}]]
    return cfg


def _keys_of(d):
    """The nested key structure of a scorecard (values dropped)."""
    if isinstance(d, dict):
        return {k: _keys_of(v) for k, v in d.items()}
    return None


def _req_tuple(r):
    k = r.key
    return (r.arrival_s, r.tenant.name, r.tenant.cls, r.tenant.priority,
            r.tenant.weight, r.tenant.deadline_ms, r.tenant.seed, r.index,
            (k.bucket, k.object, k.generation, k.start, k.length))


# ----------------------------------------------------------- schedule ----


@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
def test_build_schedule_matches_reference(arrival):
    """Arrival for arrival, tenant for tenant, chunk for chunk."""
    def cfg_of(cls):
        cfg = _serve_cfg(cls, rate=300.0, duration=1.0)
        cfg.serve.arrival = arrival
        cfg.serve.tenants = 30
        cfg.serve.seed = 3
        return cfg

    port_cfg, jax_cfg = cfg_of(BenchConfig), cfg_of(JaxConfig)
    be, jbe = open_backend(port_cfg), jax_open_backend(jax_cfg)
    try:
        ours = [_req_tuple(r) for r in serve.build_schedule(port_cfg, be)]
        theirs = [_req_tuple(r)
                  for r in jax_serve.build_schedule(jax_cfg, jbe)]
    finally:
        be.close()
        jbe.close()
    assert len(ours) > 100 and ours == theirs
    assert {t[2] for t in ours} == {"gold", "silver", "best_effort"}


@pytest.mark.parametrize("n", [1, 3, 7, 40, 100, 1000])
def test_tenants_and_budgets_match_reference(n):
    classes = ServeConfig().classes
    ours = [dataclasses.astuple(t) for t in qos.build_tenants(classes, n, 5)]
    theirs = [dataclasses.astuple(t)
              for t in jax_qos.build_tenants(classes, n, 5)]
    assert ours == theirs and len(ours) == n
    for total in (0, 1, 4000, 3 << 30):
        assert qos.class_budget_split(classes, total) == \
            jax_qos.class_budget_split(classes, total)


def test_jain_and_knee_match_reference():
    import numpy as np

    rng = np.random.default_rng(0)
    for vals in ([], [0.0, 0.0], [5.0, 0.0], [1.0] * 4,
                 list(rng.random(17)), list(rng.exponential(3.0, 100))):
        assert qos.jain_index(vals) == jax_qos.jain_index(vals)
    curves = [
        [{"offered_rps": 100, "achieved_rps": 100, "p99_ms": 10},
         {"offered_rps": 200, "achieved_rps": 200, "p99_ms": 12},
         {"offered_rps": 400, "achieved_rps": 395, "p99_ms": 50}],
        [{"offered_rps": r, "achieved_rps": r, "p99_ms": 10}
         for r in (100, 200, 400)],
        [{"offered_rps": 100, "achieved_rps": 100, "p99_ms": 10},
         {"offered_rps": 400, "achieved_rps": 150, "p99_ms": 15}],
        [{"offered_rps": 50, "achieved_rps": 50, "p99_ms": None},
         {"offered_rps": 0, "achieved_rps": 0, "p99_ms": 3}],
    ]
    for _ in range(20):
        offered = np.sort(rng.uniform(10, 1000, 5))
        curves.append([
            {"offered_rps": float(o),
             "achieved_rps": float(o * rng.uniform(0.7, 1.0)),
             "p99_ms": float(rng.uniform(1, 40))}
            for o in offered
        ])
    knees = [qos.find_knee(c) for c in curves]
    assert knees == [jax_qos.find_knee(c) for c in curves]
    assert knees[0]["reason"] == "p99_inflection" and knees[1] is None
    assert knees[2]["reason"] == "goodput_saturation"


# ----------------------------------------------------- admission queue ----


def _queue_cases(m) -> list:
    """The virtual-clock cases of ``tests/test_serve.py:146-246`` run on
    one package's queue; what each observed, in order."""
    q_ = m["qos"]
    key = m["cache"].ChunkKey

    def tenant(cls="gold", priority=0, deadline_ms=1000.0, i=0):
        return q_.Tenant(name=f"{cls}-{i}", cls=cls, priority=priority,
                         weight=1.0, deadline_ms=deadline_ms, seed=i)

    def req(t, name="o", enqueue_ns=0):
        return q_.Request(tenant=t, key=key("", name, 1, 0, 100),
                          arrival_s=0.0, enqueue_ns=enqueue_ns)

    out = []
    gold, be = tenant("gold", 0), tenant("best_effort", 2)
    for qos_on in (True, False):  # priority order, then the FIFO arm
        q = q_.AdmissionQueue(cap=1, qos=qos_on)
        q.push(req(be, "first"))
        q.push(req(gold, "second"))
        a = q.pop().tenant.cls
        q.done()
        out.append((a, q.pop().tenant.cls))
        q.done()
        q.close()
    q = q_.AdmissionQueue(cap=1, qos=True, clock_ns=lambda: 0)
    t0 = time.monotonic()
    out.append(q.pop(timeout=0.1))  # a stalled virtual clock returns
    assert time.monotonic() - t0 < 5.0
    q.close()
    q = q_.AdmissionQueue(cap=1, qos=True)  # the cap and its live grow
    q.push(req(gold, "a"))
    q.push(req(gold, "b"))
    out.append(q.pop() is not None)
    out.append((q.pop(timeout=0.05), q.queued))
    q.set_cap(2)
    out.append(q.pop(timeout=1.0) is not None)
    q.done()
    q.done()
    q.close()
    q = q_.AdmissionQueue(cap=1, qos=True, queue_limit=2)  # overload
    q.push(req(be, "b1"))
    q.push(req(be, "b2"))
    out.append(q.push(req(gold, "g1")))
    out.append((q.queued, q.stats()["shed"]))
    first = q.pop().tenant.cls
    q.done()
    out.append((first, q.pop().tenant.cls))
    q.done()
    q.close()
    now = [1_000_000_000]  # deadline shed at pop
    q = q_.AdmissionQueue(cap=1, qos=True, clock_ns=lambda: now[0])
    q.push(req(tenant("gold", 0, deadline_ms=1.0), "doomed", now[0]))
    now[0] += int(5e6)
    q.push(req(tenant("silver", 1), "fine", now[0]))
    got = q.pop(timeout=0.2)
    out.append((got.tenant.cls, q.stats()["shed"]))
    q.done()
    q.close()
    sheds = []  # shed during drain
    q = q_.AdmissionQueue(cap=1, qos=True,
                          on_shed=lambda r, reason: sheds.append(reason))
    for i in range(5):
        q.push(req(be, f"r{i}"))
    out.append((q.close(), q.pop(), q.push(req(be, "late"))))
    st = q.stats()
    out.append((sheds, {k: v for k, v in st.items()}))
    return out


def test_admission_queue_matches_reference():
    ours = _queue_cases(PORT)
    assert ours == _queue_cases(JAX)
    assert ours[0] == ("gold", "best_effort")
    assert ours[1] == ("best_effort", "gold")  # strict arrival order
    assert ours[2] is None
    assert ours[3:6] == [True, (None, 1), True]  # cap, then live grow
    assert ours[6] is True  # the newcomer outranked the shed victim
    assert ours[7] == (2, {"queue": {"best_effort": 1}, "deadline": {},
                           "drain": {}})
    assert ours[8] == ("gold", "best_effort")
    assert ours[9] == ("silver", {"queue": {}, "deadline": {"gold": 1},
                                  "drain": {}})
    assert ours[10] == (5, None, False)
    assert ours[11][0] == ["drain"] * 6


# --------------------------------------------------------- membership ----


def _elastic_walk(m) -> list:
    """One event sequence through ``ElasticFabric`` on one thread: four
    hosts over one origin, every host fetching every chunk through its
    ``CoopCache`` (peer-first), then kill / rejoin / pause / resume /
    leave / double kill. What the pod looked like after each step."""
    c_ = m["coop"]
    origin = m["Fake"].prepopulated(prefix="em/f_", count=4, size=MB)
    clock = iter(range(1000))
    fab = m["membership"].ElasticFabric(4, clock=lambda: float(next(clock)))
    for h in range(4):
        cache_ = m["cache"].ChunkCache(64 * MB)

        def origin_fetch(k):
            return m["prefetch"].fetch_chunk(origin, k)

        fab.add_host(c_.CoopCache(
            cache_, host_id=h, ring=fab.ring,
            channel=c_.LoopbackChannel(fab.broker, h),
            origin_fetch=origin_fetch, enabled=True,
        ))
    keys = [
        m["cache"].ChunkKey("b", o.name, o.generation, s, CHUNK)
        for o in origin.list("em/f_") for s in range(0, MB, CHUNK)
    ]

    def fetch_all(hosts):
        for h in hosts:
            for k in keys[h::3]:
                assert len(fab.coop(h).fetch(k)) == CHUNK

    out = []
    fetch_all(range(4))
    for action, host in (("kill_host", 1), ("kill_host", 1),
                         ("rejoin_host", 1), ("pause_host", 2),
                         ("resume_host", 2), ("leave_host", 3)):
        before = fab.owners_of(keys)
        ret = getattr(fab, action)(host)
        after = fab.owners_of(keys)
        live = sorted(fab.live_hosts())
        fetch_all(live)
        out.append((action, host, ret, [after[k] for k in keys], live,
                    m["membership"].remap_stats(keys, before, after),
                    fab.membership.view(), fab.aggregate()))
    out.append([e.to_dict() for e in fab.membership.events()])
    fab.close()
    return out


def test_elastic_fabric_matches_reference():
    ours = _elastic_walk(PORT)
    assert ours == _elastic_walk(JAX)
    kill, double_kill, rejoin, _, _, leave, events = ours
    assert kill[2] is True and double_kill[2] is False
    assert 0.05 <= kill[5]["remap_fraction"] <= 0.5
    assert rejoin[5]["remapped_keys"] == kill[5]["remapped_keys"]
    assert leave[2]["chunks"] > 0 and leave[7]["handoff_in_bytes"] > 0
    assert [e["action"] for e in events] == [
        "fail", "join", "pause", "resume", "leave", "handoff"]
    with pytest.raises(membership.MembershipError):
        membership.Membership([0]).resume(0)


# ----------------------------------------------------- config + stamp ----


@pytest.mark.parametrize("mutate", [
    lambda sc: setattr(sc, "duration_s", 0),
    lambda sc: setattr(sc, "duration_s", float("nan")),
    lambda sc: setattr(sc, "rate_rps", -1),
    lambda sc: setattr(sc, "arrival", "weibull"),
    lambda sc: setattr(sc, "arrival", "trace"),
    lambda sc: setattr(sc, "burst_factor", 0.5),
    lambda sc: setattr(sc, "burst_fraction", 1.5),
    lambda sc: setattr(sc, "alpha", 0),
    lambda sc: setattr(sc, "tenants", 0),
    lambda sc: setattr(sc, "queue_limit", -1),
    lambda sc: setattr(sc, "classes", []),
    lambda sc: setattr(sc, "classes", ["gold"]),
    lambda sc: setattr(sc, "classes", [{"name": "x", "share": 0.5}]),
    lambda sc: setattr(sc, "classes", [
        {"name": "x", "share": 0.5, "deadline_ms": 10.0},
        {"name": "x", "share": 0.5, "deadline_ms": 10.0}]),
    lambda sc: setattr(sc, "classes", [
        {"name": "x", "share": 0.5, "deadline_ms": 10.0, "prio": 1}]),
    lambda sc: setattr(sc, "classes", [
        {"name": "x", "share": -0.5, "deadline_ms": 10.0}]),
    lambda sc: setattr(sc, "classes", [
        {"name": "x", "share": 0.5, "deadline_ms": 10.0, "priority": -1}]),
    lambda sc: setattr(sc, "sweep_points", []),
    lambda sc: setattr(sc, "sweep_points", [1.0, -2.0]),
    lambda sc: setattr(sc, "sweep_duration_s", -1.0),
    lambda sc: setattr(sc, "hosts", 0),
    lambda sc: setattr(sc, "resize_window_s", 0),
    lambda sc: (setattr(sc, "hosts", 4), setattr(sc, "readahead", 2)),
    lambda sc: setattr(sc, "membership_timeline",
                       [[0.5, 0.5, {"kill_host": 1}]]),
    lambda sc: (setattr(sc, "hosts", 4),
                setattr(sc, "membership_timeline", [[0.5, 0.5]])),
    lambda sc: (setattr(sc, "hosts", 4),
                setattr(sc, "membership_timeline",
                        [["a", 0.5, {"kill_host": 1}]])),
    lambda sc: (setattr(sc, "hosts", 4),
                setattr(sc, "membership_timeline",
                        [[0.5, 0.2, {"kill_host": 1}]])),
    lambda sc: (setattr(sc, "hosts", 4),
                setattr(sc, "membership_timeline",
                        [[0.5, 0.5, {"explode_host": 1}]])),
    lambda sc: (setattr(sc, "hosts", 4),
                setattr(sc, "membership_timeline",
                        [[0.5, 0.5, {"kill_host": 7}]])),
])
def test_validate_serve_config_rejects_as_reference(mutate):
    """The same malformed sections refused with the same message."""
    sc, jsc = ServeConfig(), JaxServeConfig()
    mutate(sc)
    mutate(jsc)
    with pytest.raises(SystemExit) as ours:
        validate_serve_config(sc)
    with pytest.raises(SystemExit) as theirs:
        jax_validate(jsc)
    assert str(ours.value) == str(theirs.value)


def _saved_config():
    """A ``tpubench --save-config`` document with a non-default serve
    section."""
    cfg = _serve_cfg(JaxConfig, rate=300.0, duration=0.5)
    sv = cfg.serve
    sv.arrival = "bursty"
    sv.hosts = 3
    sv.classes = [
        {"name": "gold", "share": 0.2, "weight": 3.0, "deadline_ms": 50.0,
         "priority": 0},
        {"name": "rest", "share": 0.8, "weight": 1.0, "deadline_ms": 900.0,
         "priority": 1},
    ]
    sv.membership_timeline = [[0.2, 0.2, {"leave_host": 2}]]
    sv.sweep_points = [0.5, 2.0]
    return cfg


def test_serve_section_roundtrips_and_stamps_as_reference(tmp_path):
    """A ``--save-config`` JSON with a serve section loads into the port
    and dumps back unchanged; its fingerprint and a serve run's replay
    stamp are ``tpubench``'s."""
    jcfg = _saved_config()
    doc = jcfg.to_dict()
    cfg = BenchConfig.from_json(jcfg.to_json())
    assert "serve" not in cfg.raw
    assert cfg.serve.membership_timeline == [[0.2, 0.2, {"leave_host": 2}]]
    assert cfg.to_dict() == json.loads(json.dumps(doc))
    assert JaxConfig.from_dict(cfg.to_dict()).to_dict() == doc
    validate_serve_config(cfg.serve)
    assert bundle.config_fingerprint(cfg.to_dict()) == \
        jax_bundle.config_fingerprint(doc)
    assert (bundle.BUNDLE_FORMAT, bundle.BUNDLE_SCHEMA) == \
        (jax_bundle.BUNDLE_FORMAT, jax_bundle.BUNDLE_SCHEMA)
    be, jbe = open_backend(cfg), jax_open_backend(jcfg)
    try:
        objs = be.list(cfg.workload.object_name_prefix)
        jobjs = jbe.list(jcfg.workload.object_name_prefix)
        sched = serve.build_schedule(cfg, be, objects=objs)
        jsched = jax_serve.build_schedule(jcfg, jbe, objects=jobjs)
    finally:
        be.close()
        jbe.close()
    extra = {"classes": {"gold": {"priority": 0, "slo_attainment": 0.5,
                                  "p99_ms": 9.0}},
             "arrivals": len(sched), "completed": 3, "shed": 1,
             "goodput_gbps": 0.25, "achieved_rps": 7.5,
             "jain_fairness": 0.75}
    mb = {"events": [{"time_to_rewarm_s": 0.25}], "failovers": 2}
    stamp = bundle.journal_replay_stamp(
        cfg, sched, objs, extra, rate_rps=300.0, membership=mb, errors=1,
        p99_ms=12.5, source={"bundle": "b"})
    jstamp = jax_bundle.journal_replay_stamp(
        jcfg, jsched, jobjs, extra, rate_rps=300.0, membership=mb,
        errors=1, p99_ms=12.5, source={"bundle": "b"})
    assert json.dumps(stamp, sort_keys=True) == \
        json.dumps(jstamp, sort_keys=True)
    assert stamp["baseline"]["rewarm_s"] == 0.25


def test_cli_serve_flags_fold_as_reference(tmp_path):
    import tpubench.cli as jax_cli

    tl = tmp_path / "tl.json"
    tl.write_text(json.dumps([[0.5, 0.5, {"leave_host": 1}]]))
    argv = ["serve", "--protocol", "fake", "--serve-duration", "2.5",
            "--serve-rate", "150", "--serve-arrival", "bursty",
            "--serve-tenants", "12", "--serve-workers", "3",
            "--no-serve-qos", "--serve-admission-cap", "2",
            "--serve-queue-limit", "9", "--serve-burst-factor", "6",
            "--serve-burst-fraction", "0.4", "--serve-seed", "5",
            "--serve-sweep-points", "0.5,1,3", "--serve-hosts", "4",
            "--membership-timeline", f"@{tl}", "--resize-window", "0.75",
            "--serve-classes", json.dumps(ServeConfig().classes[:2])]
    ours = cli.build_config(cli.build_parser().parse_args(argv))
    saved = tmp_path / "cfg.json"
    assert jax_cli.main(argv + ["--save-config", str(saved)]) == 0
    theirs = json.loads(saved.read_text())["serve"]
    assert dataclasses.asdict(ours.serve) == theirs
    assert ours.serve.membership_timeline == [[0.5, 0.5, {"leave_host": 1}]]
    with pytest.raises(SystemExit, match="--serve-classes: invalid JSON"):
        cli.build_config(cli.build_parser().parse_args(
            ["serve", "--serve-classes", "{nope"]))


# ------------------------------------------------------------- C.6 ----


def test_mmpp_stuck_shape_ends_and_reference_shapes_match():
    """ROADMAP C.6: 120/s over 3 s, fraction 0.3, 0.5 s cycles, seed 0
    spins for ever in ``tpubench`` (t stuck at 1.15); the port ends within
    1 s. Wherever the reference ends, the arrays are equal."""
    t0 = time.monotonic()
    stuck = arrivals.mmpp_arrivals(120.0, 3.0, burst_fraction=0.3,
                                   cycle_s=0.5, seed=0)
    assert time.monotonic() - t0 < 1.0
    assert stuck == sorted(stuck) and 0 < len(stuck)
    assert all(0 <= t < 3.0 for t in stuck)
    assert any(1.15 < t < 1.5 for t in stuck)  # the quiet state after it
    shapes = [  # tests/test_serve.py and tests/test_torch_coop.py:230
        (400.0, 4.0, 8.0, 0.25, 1.0, 5), (700.0, 1.6, 6.0, 0.25, 1.0, 7),
        (200.0, 2.0, 4.0, 0.25, 1.0, 11), (200.0, 2.0, 8.0, 0.25, 1.0, 12),
        (200.0, 2.0, 4.0, 0.25, 0.5, 5), (200.0, 2.0, 4.0, 0.25, 1.0, 3),
    ]
    for rate, dur, bf, frac, cycle, seed in shapes:
        kw = dict(burst_factor=bf, burst_fraction=frac, cycle_s=cycle,
                  seed=seed)
        assert arrivals.mmpp_arrivals(rate, dur, **kw) == \
            jax_arrivals.mmpp_arrivals(rate, dur, **kw)


# ------------------------------------------------------- serve runs ----


def _capture_jain(monkeypatch, mod) -> list:
    """Record the per-tenant weight-normalized goodput list each scorecard
    hands ``jain_index`` (tenants sorted by name)."""
    seen = []
    real = mod.jain_index

    def spy(values):
        seen.append(list(values))
        return real(values)

    monkeypatch.setattr(mod, "jain_index", spy)
    return seen


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Serve runs on the port, shared by the acceptance and report
    tests: the QoS A/B at the reference acceptance's overload, the 4-host
    leave and kill arms, a short sweep."""
    d = tmp_path_factory.mktemp("serve")
    out = {}
    for arm, on in (("qos", True), ("fifo", False)):
        res = serve.run_serve(_serve_cfg(qos=on), device="cpu")
        out[arm] = write_result(res, str(d), tag=arm)
    for action in ("leave_host", "kill_host"):
        res = serve.run_serve(_elastic_cfg(action), device="cpu")
        out[action] = write_result(res, str(d), tag=action)
    cfg = _serve_cfg(rate=150.0, duration=0.4)
    cfg.serve.sweep_points = [0.5, 6.0]
    out["sweep"] = write_result(serve.run_serve_sweep(cfg, device="cpu"),
                                str(d), tag="sweep")
    return {k: json.loads(open(v).read()) | {"_path": v}
            for k, v in out.items()}


def test_below_capacity_run_matches_reference(monkeypatch):
    """Cache off, QoS off, far below capacity: both packages complete
    every request, with equal per-class arrivals and bytes, equal
    per-tenant bytes, and the same scorecard keys."""
    seen = _capture_jain(monkeypatch, serve)
    jseen = _capture_jain(monkeypatch, jax_serve)
    kw = dict(qos=False, rate=200.0, duration=0.6, svc_s=0.0)
    res = serve.run_serve(_serve_cfg(**kw), device="cpu")
    jres = jax_serve.run_serve(_serve_cfg(JaxConfig, **kw))
    sv, jsv = res.extra["serve"], jres.extra["serve"]
    for s, r in ((sv, res), (jsv, jres)):
        assert r.errors == 0 and s["shed"] == 0
        assert s["completed"] == s["arrivals"] > 50
    assert {c: (v["arrivals"], v["completed"], v["bytes"])
            for c, v in sv["classes"].items()} == \
        {c: (v["arrivals"], v["completed"], v["bytes"])
         for c, v in jsv["classes"].items()}
    assert seen == jseen and len(seen) == 1 and sum(seen[0]) > 0
    assert _keys_of(sv) == _keys_of(jsv)
    assert set(res.summaries) == set(jres.summaries)
    assert res.bytes_total == jres.bytes_total


def test_qos_ab_acceptance_on_the_port(runs):
    """``tests/test_serve.py``'s QoS A/B: gold SLO defended (>= 0.9 and
    above the FIFO arm), best-effort absorbs the shed, gold sheds
    nothing, goodput retention >= 0.6, Jain reported both arms."""
    on, off = runs["qos"]["extra"]["serve"], runs["fifo"]["extra"]["serve"]
    g_on = on["classes"]["gold"]["slo_attainment"]
    g_off = off["classes"]["gold"]["slo_attainment"]
    assert g_on >= 0.9 and g_on > g_off
    assert on["classes"]["best_effort"]["shed"] > 0
    assert on["classes"]["gold"]["shed"] == 0
    assert on["goodput_gbps"] / off["goodput_gbps"] >= 0.6
    assert on["jain_fairness"] is not None
    assert off["jain_fairness"] is not None


def test_elastic_kill_vs_leave_acceptance_on_the_port(runs):
    """``tests/test_membership.py``'s 4-host acceptance on the port."""
    for action in ("leave_host", "kill_host"):
        mb = runs[action]["extra"]["membership"]
        sv = runs[action]["extra"]["serve"]
        ev = mb["events"][0]
        assert ev["applied"] and mb["epoch"] == 1
        assert 0.05 <= ev["remap_fraction"] <= 0.5
        assert sv["arrivals"] == sv["completed"] + sv["shed"] + sum(
            c["errors"] for c in sv["classes"].values())
        assert mb["pool_leaked_slabs"] == 0
        assert ev["time_to_rewarm_s"] is not None
    coop_mb = runs["leave_host"]["extra"]["membership"]
    kill_mb = runs["kill_host"]["extra"]["membership"]
    assert runs["leave_host"]["extra"]["serve"]["arrivals"] == \
        runs["kill_host"]["extra"]["serve"]["arrivals"]
    assert coop_mb["handoff"]["out_bytes"] > 0
    assert coop_mb["handoff"]["in_bytes"] == coop_mb["handoff"]["out_bytes"]
    assert kill_mb["handoff"]["out_bytes"] == 0
    assert coop_mb["origin_bytes"]["resize_windows"] <= \
        kill_mb["origin_bytes"]["resize_windows"]
    gold_resize = next(iter(coop_mb["slo"]["resize"].values()))
    assert gold_resize is not None and gold_resize >= 0.9
    for h in coop_mb["per_host"]:  # unpinned pools, as in tpubench
        assert h["pool"]["native"] is False


def test_sweep_finds_the_knee(runs):
    sweep = runs["sweep"]["extra"]["serve"]["sweep"]
    assert [p["multiplier"] for p in sweep["points"]] == [0.5, 6.0]
    assert sweep["knee"] is not None and sweep["knee"]["index"] == 1


@pytest.mark.parametrize("docs", [
    ("qos",), ("fifo", "qos"), ("leave_host",), ("leave_host", "kill_host"),
    ("sweep",),
])
def test_report_renders_serve_and_membership_as_reference(runs, docs):
    """``report`` over serve, membership and sweep documents, one and two
    at a time (the QoS A/B and the leave-versus-kill diff): the text of
    ``tpubench``'s report, character for character."""
    paths = [runs[d]["_path"] for d in docs]
    text = report_cmd.run_report(paths)
    assert text == jax_report.run_report(paths)
    if docs == ("fifo", "qos"):
        assert "serve: gold SLO" in text and "jain" in text
    if docs == ("leave_host", "kill_host"):
        assert "membership:" in text and "resize-window origin" in text
    if docs == ("sweep",):
        assert "serve load sweep" in text and "knee:" in text


# ----------------------------------------------------------- reactor ----


def _reactor(backend):
    from tpubench_torch.storage.reactor_backend import ReactorFetchBackend

    while not isinstance(backend, ReactorFetchBackend):
        backend = backend.inner
    return backend


def test_serve_through_the_native_pool(monkeypatch):
    """``serve --fetch-executor native`` on ``http``: every origin fetch
    (a cache miss; the cache is off, so only single-flight waiters share
    one) is one completion of the engine's pool, over the reactor, and
    the Python client reads nothing."""
    from tpubench_torch.native.engine import get_engine
    from tpubench_torch.storage.fake_server import FakeGcsServer
    from tpubench_torch.storage.gcs_http import GcsHttpBackend

    python_reads = []
    real_open = GcsHttpBackend.open_read
    monkeypatch.setattr(
        GcsHttpBackend, "open_read",
        lambda self, *a, **kw: python_reads.append(a) or real_open(
            self, *a, **kw))
    cfg = _serve_cfg(qos=False, rate=200.0, duration=0.5, svc_s=0.0)
    store = FakeBackend.prepopulated(prefix=cfg.workload.object_name_prefix,
                                     count=4, size=MB)
    engine = get_engine()
    with FakeGcsServer(store) as srv:
        cfg.transport.protocol = "http"
        cfg.transport.endpoint = srv.endpoint
        cfg.workload.fetch_executor = "native"
        backend = open_backend(cfg)
        reactor = _reactor(backend)
        before = engine.stats()["pool_completions"]
        try:
            res = serve.run_serve(cfg, backend=backend, device="cpu")
        finally:
            backend.close()
    sv = res.extra["serve"]
    assert res.errors == 0 and sv["completed"] == sv["arrivals"] > 20
    assert reactor.pool_mode == "reactor" and reactor.fell_back is False
    fetches = sv["cache"]["misses"]
    assert fetches + sv["cache"]["coalesced"] == sv["completed"]
    assert engine.stats()["pool_completions"] - before == fetches > 20
    assert python_reads == []


def test_failed_pool_start_raises(monkeypatch):
    """The stated difference: where ``tpubench`` falls back to Python
    reads with a warning, the port's wrapper raises."""
    from tpubench_torch.native.engine import NativeEngine

    def refuse(self, *a, **kw):
        raise RuntimeError("pool_create failed")

    monkeypatch.setattr(NativeEngine, "pool_create", refuse)
    cfg = _serve_cfg(qos=False, rate=50.0, duration=0.2, svc_s=0.0)
    cfg.transport.protocol = "http"
    cfg.transport.endpoint = "http://127.0.0.1:9"
    cfg.workload.fetch_executor = "native"
    backend = open_backend(cfg)
    try:
        with pytest.raises(RuntimeError, match="pool_create failed"):
            _reactor(backend).open_read("tpubench/file_0", 0, 16)
    finally:
        backend.close()
    cfg.workload.fetch_executor = "python"
    assert not hasattr(open_backend(cfg).inner, "pool_mode")


def test_tune_controller_defends_gold_under_burst():
    """``serve --tune`` (``tests/test_serve.py``'s AIMD case on the port):
    the controller moves the admission cap through decision windows
    during a bursty overload; gold keeps its SLO, best-effort sheds at
    least as much; the elastic pod refuses the controller."""
    cfg = _serve_cfg(qos=True, rate=700.0, duration=1.6, workers=4)
    cfg.serve.arrival = "bursty"
    cfg.serve.burst_factor = 6.0
    cfg.serve.admission_cap = 2
    cfg.tune.enabled = True
    cfg.tune.window_s = 0.2
    cfg.tune.warmup_windows = 1
    cfg.tune.knobs = ["workers"]
    cfg.tune.seed = 7
    res = serve.run_serve(cfg, device="cpu")
    tn, sv = res.extra["tune"], res.extra["serve"]
    assert tn["n_windows"] >= 2 and "workers" in tn["initial"]
    assert sv["classes"]["gold"]["slo_attainment"] >= 0.9
    assert sv["classes"]["best_effort"]["shed"] >= \
        sv["classes"]["gold"]["shed"]
    cfg.serve.hosts = 2
    with pytest.raises(SystemExit, match="elastic pod"):
        serve.run_serve(cfg, device="cpu")


def test_pacer_keeps_the_offered_load_when_sleeps_overshoot(monkeypatch):
    """Every sleep 1 ms late (the card host's timer: any sleep under 1 ms
    took ~1.1 ms): the pacer keeps each arrival's due time, so 400
    arrivals 0.25 ms apart still take ~0.1 s; sleeping each gap from the
    previous push, as ``tpubench`` does, would take over 0.5 s. The same
    schedule's times are pushed in order either way."""
    real = time.sleep
    monkeypatch.setattr(serve.time, "sleep", lambda d: real(d + 0.001))
    pacer, pushed = serve._Pacer(), []
    t0 = time.perf_counter()
    for i in range(400):
        pacer.wait(0.00025)
        pushed.append(i)
    took = time.perf_counter() - t0
    assert pushed == list(range(400))
    assert 0.1 <= took < 0.3


def test_serve_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run_serve(_serve_cfg(duration=0.1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run_serve_sweep(_serve_cfg(duration=0.1))


def test_serve_notes_feed_the_journal_timeline(tmp_path):
    """An overloaded run's journal: ``report timeline`` counts its
    requests and sheds as ``tpubench``'s does, and carries the replay
    stamp."""
    from tpubench_torch.obs.flight import load_journals

    jpath = str(tmp_path / "serve.json")
    cfg = _serve_cfg(rate=600.0, duration=0.6)
    cfg.obs.flight_journal = jpath
    res = serve.run_serve(cfg, device="cpu")
    assert res.extra["serve"]["shed"] > 0
    body = report_cmd.run_timeline([jpath])
    assert "serve: requests=" in body and "shed=" in body
    assert body == jax_report.run_timeline([jpath])
    (doc,) = load_journals([jpath])
    stamp = doc["replay"]
    assert stamp["workload"] == "serve"
    assert len(stamp["scenario"]["arrivals"]) == res.extra["serve"]["arrivals"]
    assert stamp["fingerprint"] == bundle.config_fingerprint(cfg.to_dict())
