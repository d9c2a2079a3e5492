"""The port's invariant-analysis plane (``tpubench_torch check``) against
``tpubench``'s: the reference's fixtures (flight-op, lease, thread,
determinism, bounds, lock graph) give identical findings through both
analyzers; the port's analyzer pointed at ``tpubench/`` with
``tpubench``'s allowlist gives ``tpubench``'s own report; the port's
tree is clean with every drift guard run; the allowlist policy, the JSON
schema and the 0/1/2 exit codes are the reference's."""

import json
from pathlib import Path

import pytest

import tpubench.analysis as jax_analysis
import tpubench_torch.analysis as analysis
from tpubench.analysis import determinism as jax_det
from tpubench.analysis import lifecycle as jax_life
from tpubench.analysis import lockorder as jax_lock
from tpubench.analysis import threads as jax_threads
from tpubench_torch import cli
from tpubench_torch.analysis import determinism, drift, lifecycle, lockorder
from tpubench_torch.analysis import threads

REPO = Path(__file__).resolve().parents[1]
PASSES = {
    "flight": (lifecycle.FLIGHT_PASS, jax_life.FLIGHT_PASS),
    "resource": (lifecycle.RESOURCE_PASS, jax_life.RESOURCE_PASS),
    "thread": (threads.THREAD_PASS, jax_threads.THREAD_PASS),
    "determinism": (determinism.DETERMINISM_PASS, jax_det.DETERMINISM_PASS),
    "lock": (lockorder.LOCK_ORDER_PASS, jax_lock.LOCK_ORDER_PASS),
}

# ---------------------------------------------------------- the fixtures --
# tests/test_analysis.py's snippets, each with the finding codes
# tpubench's analyzer gives it (held here so neither side can go quiet).

_CYCLE_SRC = """
import threading
class Cache:
    def __init__(self, coop: "Coop"):
        self._lock = threading.Lock()
        self.coop = coop
    def get(self):
        with self._lock:
            self.coop.serve()
class Coop:
    def __init__(self, cache: Cache):
        self._lock = threading.Lock()
        self.cache = cache
    def serve(self):
        with self._lock:
            self.cache.get()
"""
_MULTI_ITEM_SRC = """
import threading
class C:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
    def helper(self):
        with self._b:
            pass
        return open("/dev/null")
    def m(self):
        with self._a, self.helper():
            pass
"""
_SELF_DEADLOCK_SRC = """
import threading
class C:
    def __init__(self):
        self._lock = threading.Lock()
    def helper(self):
        with self._lock:
            pass
    def m(self):
        with self._lock:
            self.helper()
"""
_CONDITION_SRC = """
import threading
class W:
    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._other = threading.Lock()
    def a(self):
        with self._cond:
            with self._other:
                pass
    def b(self):
        with self._other:
            pass
"""

FIXTURES = {
    "op_leak": ("flight", "a.py", """
def f(wf):
    op = wf.begin("obj", "t")
    do_work()
""", ["op-leak:op"]),
    "op_error_path": ("flight", "b.py", """
def f(wf):
    op = wf.begin("obj", "t")
    try:
        work()
    except Exception:
        raise
    op.finish(1)
""", ["op-error-path:op"]),
    "op_clean": ("flight", "c.py", """
def f(wf):
    op = wf.begin("obj", "t")
    try:
        work()
    except Exception as e:
        op.finish(error=e)
        raise
    op.finish(10)

def g(wf):
    with wf.begin("obj", "t") as op:
        work()

def h(wf):
    op = wf.begin("obj", "t")
    if claimed():
        op.abandon()
        return
    op.finish(1)
""", []),
    "op_dropped": ("flight", "d.py", """
def f(wf):
    wf.begin("obj", "t")
""", ["op-dropped"]),
    "op_conditional": ("flight", "cc.py", """
def f(wf, ok):
    op = wf.begin("o", "t")
    if ok:
        op.finish(1)
""", ["op-conditional-close:op"]),
    "op_handler_only": ("flight", "cc2.py", """
def f(wf):
    op = wf.begin("o", "t")
    try:
        work()
    except Exception as e:
        op.finish(error=e)
        raise
""", ["op-conditional-close:op"]),
    "op_guards_clean": ("flight", "cc3.py", """
def none_guard(wf):
    op = wf.begin("o", "t") if active() else None
    work()
    if op is not None:
        op.finish(1)

def both_branches(wf):
    op = wf.begin("o", "t")
    if claimed():
        op.abandon()
    else:
        op.finish(1)

def shared_guard(self):
    if self._flight is not None:
        op = self._flight.begin("s", "d")
        op.finish(3)

def loop_pair(wf, keys):
    for k in keys:
        op = wf.begin(k, "t")
        op.finish(1)
""", []),
    "op_annotated": ("flight", "ab.py", """
def f(wf):
    op: FlightOp = wf.begin("o", "t")
""", ["op-leak:op"]),
    "op_walrus": ("flight", "wb.py", """
def f(wf):
    if (op := wf.begin("o", "t")):
        op.finish(1)
""", []),
    "op_escape": ("flight", "e.py", """
def f(wf, q):
    op = wf.begin("obj", "t")
    q.put((3, op))
""", []),
    "stamp_without_adopt": ("flight", "t.py", """
import threading
from tpubench_torch.obs import flight as _flight

def spawn():
    def helper():
        _flight.note_phase("first_byte")
    threading.Thread(target=helper, name="h").start()
""", ["stamp-without-adopt"]),
    "stamp_adopted": ("flight", "t2.py", """
import threading
from tpubench_torch.obs import flight as _flight

def spawn(op):
    def helper():
        _flight.adopt_op(op)
        _flight.note_phase("first_byte")
    threading.Thread(target=helper, name="h").start()
""", []),
    "lease_leak": ("resource", "l.py", """
def f(pool):
    lease = pool.lease(10)
    fill(lease.view())
""", ["lease-leak:lease"]),
    "lease_clean": ("resource", "l2.py", """
def f(pool, cache, key):
    lease = pool.lease(10)
    try:
        fill(lease.view())
    except BaseException:
        lease.release()
        raise
    cache.put(key, lease)

def g(pool):
    lease = pool.lease(10)
    try:
        fill(lease.view())
    finally:
        lease.release()
""", []),
    "lease_derived": ("resource", "l3.py", """
def f(pool):
    lease = pool.lease(10)
    stream_into(lease.view())
""", ["lease-leak:lease"]),
    "thread_bad": ("thread", "th.py", """
import threading
def f():
    threading.Thread(target=f, daemon=True).start()
def g():
    try:
        work()
    except BaseException:
        pass
def h():
    try:
        work()
    except:
        log()
""", ["baseexception-swallow", "baseexception-swallow", "unnamed-thread"]),
    "thread_aliased": ("thread", "th3.py", """
import threading as _threading
def f():
    _threading.Thread(target=f, daemon=True).start()
""", ["unnamed-thread"]),
    "thread_nested_raise": ("thread", "th4.py", """
def f(register):
    try:
        work()
    except BaseException:
        def cb():
            raise ValueError()
        register(cb)
""", ["baseexception-swallow"]),
    "thread_clean": ("thread", "th2.py", """
import threading
def f():
    threading.Thread(target=f, name="worker-0", daemon=True).start()
def g(lease):
    try:
        work()
    except BaseException:
        lease.release()
        raise
def h():
    try:
        work()
    except Exception as e:
        record(e)
""", []),
    "clock_rng": ("determinism", "tpubench_torch/serve/qos.py", """
import time, random
def decide():
    return time.monotonic() + random.random()
""", ["naked-clock:time.monotonic", "naked-rng:random.random"]),
    "clock_elsewhere": ("determinism", "tpubench_torch/workloads/read.py", """
import time
def run():
    return time.time()
""", []),
    "clock_fleet": ("determinism", "tpubench_torch/fleet/driver.py", """
import time
def run():
    return time.monotonic()
""", ["naked-clock:time.monotonic"]),
    "rng_seeded": ("determinism", "tpubench_torch/workloads/arrivals.py", """
import random
import numpy as np
def make(seed):
    return random.Random(seed), np.random.Generator(np.random.Philox(seed))
def make_kw(seed):
    return np.random.default_rng(seed=seed)
""", []),
    "bounds_bad": ("determinism", "tpubench_torch/obs/widget.py", """
from collections import deque
class Sampler:
    def __init__(self):
        self.samples = []
        self.q = deque()
    def observe(self, v):
        self.samples.append(v)
""", ["unbounded-accumulator:samples", "unbounded-deque"]),
    "bounds_clean": ("determinism", "tpubench_torch/obs/widget2.py", """
from collections import deque
CAP = 512
class Sampler:
    def __init__(self):
        self.samples = []
        self.q = deque(maxlen=64)
    def observe(self, v):
        self.samples.append(v)
        if len(self.samples) >= CAP:
            del self.samples[::2]
""", []),
    "bounds_two_deques": ("determinism", "tpubench_torch/obs/widget3.py", """
from collections import deque
class A:
    def __init__(self):
        self.q = deque()
class B:
    def __init__(self):
        self.q = deque()
""", ["unbounded-deque", "unbounded-deque"]),
    "bounds_branchy_init": ("determinism", "tpubench_torch/obs/widget4.py", """
class S:
    def __init__(self, big):
        if big:
            self.samples = []
        else:
            self.samples = [0]
    def observe(self, v):
        self.samples.append(v)
""", ["unbounded-accumulator:samples"]),
    "bounds_serve_file": ("determinism", "tpubench_torch/workloads/serve.py", """
class S:
    def __init__(self):
        self.log = []
    def on(self, v):
        self.log.append(v)
""", ["unbounded-accumulator:log"]),
    "lock_cycle": ("lock", "tpubench_torch/pipeline/cache.py", _CYCLE_SRC,
                   ["cycle:Cache._lock>Coop._lock",
                    "self-deadlock:Cache._lock",
                    "self-deadlock:Coop._lock"]),
    "lock_self_deadlock": ("lock", "tpubench_torch/pipeline/cache.py",
                           _SELF_DEADLOCK_SRC, ["self-deadlock:C._lock"]),
    "lock_rlock": ("lock", "tpubench_torch/pipeline/cache.py",
                   _SELF_DEADLOCK_SRC.replace("threading.Lock()",
                                              "threading.RLock()"), []),
    "lock_condition": ("lock", "tpubench_torch/staging/executor.py",
                       _CONDITION_SRC, []),
    "lock_unlisted_file": ("lock", "tpubench_torch/workloads/read.py",
                           _CYCLE_SRC, []),
}


def _findings(finding_list, package: str = "tpubench") -> list:
    """Each finding's fields, its path and key read as if the file had
    been ``tpubench``'s."""
    return [(f.pass_id, f.path.replace(f"{package}/", "tpubench/", 1),
             f.line, f.symbol, f.code, f.message,
             f.key.replace(f":{package}/", ":tpubench/", 1))
            for f in finding_list]


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("package", ["tpubench_torch", "tpubench"])
def test_fixture_findings_match_reference(name, package):
    """Each snippet gives the port's analyzer, the file filed under either
    package (the passes name their files inside the package walked), the
    findings ``tpubench``'s gives it filed under ``tpubench/``, and the
    codes the reference's tests expect."""
    which, path, src, codes = FIXTURES[name]
    ours_pass, their_pass = PASSES[which]
    ours = ours_pass.run([analysis.SourceFile.parse(
        path.replace("tpubench_torch/", f"{package}/"), src)])
    theirs = their_pass.run([jax_analysis.SourceFile.parse(
        path.replace("tpubench_torch/", "tpubench/"), src)])
    assert _findings(ours, package) == _findings(theirs)
    assert sorted(f.code for f in ours) == sorted(codes)
    if name == "bounds_two_deques":
        assert len({f.key for f in ours}) == 2


@pytest.mark.parametrize("src", [_CYCLE_SRC, _MULTI_ITEM_SRC,
                                 _SELF_DEADLOCK_SRC, _CONDITION_SRC])
def test_lock_graph_matches_reference(src):
    path = "tpubench_torch/pipeline/cache.py"
    ours = lockorder.build_lock_graph([analysis.SourceFile.parse(path, src)])
    theirs = jax_lock.build_lock_graph(
        [jax_analysis.SourceFile.parse(path, src)])
    assert ours.edges == theirs.edges and ours.kinds == theirs.kinds
    assert ours.self_deadlocks == theirs.self_deadlocks
    assert lockorder.find_cycles(ours) == jax_lock.find_cycles(theirs)
    if src is _MULTI_ITEM_SRC:
        assert ours.edges == {"C._a": {"C._b"}}
    if src is _CONDITION_SRC:
        assert ours.edges == {"W._lock": {"W._other"}}


# ---------------------------------------------- the reference's own tree --

@pytest.fixture(scope="module")
def reference_reports():
    from tpubench.analysis.core import DEFAULT_ALLOWLIST

    ours = analysis.run_check(package="tpubench",
                              allowlist_path=DEFAULT_ALLOWLIST,
                              with_drift=False)
    return ours, jax_analysis.run_check(with_drift=False)


def test_port_analyzer_over_tpubench_gives_tpubench_report(reference_reports):
    ours, theirs = reference_reports
    assert ours.to_dict() == theirs.to_dict()
    assert ours.files_scanned == theirs.files_scanned == len(
        list((REPO / "tpubench").rglob("*.py")))
    assert [f.key for f in ours.suppressed] == \
        [f.key for f in theirs.suppressed]
    assert ours.stale_allowlist == theirs.stale_allowlist == []
    assert ours.render().splitlines()[-1] == \
        theirs.render().splitlines()[-1].replace("tpubench check", "check")


def test_load_tree_walks_the_package_asked_for():
    ours = [sf.path for sf in analysis.load_tree(package="tpubench")]
    theirs = [sf.path for sf in jax_analysis.load_tree()]
    assert ours == theirs
    port = [sf.path for sf in analysis.load_tree()]
    assert port and all(p.startswith("tpubench_torch/") for p in port)
    with pytest.raises(analysis.CheckConfigError, match="no nowhere"):
        analysis.load_tree(package="nowhere")


# ------------------------------------------------------ the port's tree --

@pytest.fixture(scope="module")
def port_check(tmp_path_factory):
    """``tpubench_torch check --json`` over the port's tree, drift guards
    included (the native-counters guard builds and probes the engine)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["check", "--json"])
    return rc, json.loads(buf.getvalue())


def test_port_tree_is_clean_with_every_drift_guard(port_check):
    rc, doc = port_check
    assert rc == 0, json.dumps(doc, indent=1)
    assert doc["summary"]["clean"] and doc["summary"]["findings"] == 0
    assert doc["stale_allowlist"] == [] and doc["skipped"] == []
    assert doc["passes"] == ["flight-op", "thread", "resource",
                             "determinism", "lock-order", "drift"]
    assert doc["files_scanned"] == len(
        list((REPO / "tpubench_torch").rglob("*.py")))
    allow = analysis.load_allowlist()
    flagged = {f["key"] for f in doc["findings"] if f["allowlisted"]}
    assert flagged == set(allow) and doc["summary"]["allowlisted"] == \
        sum(f["allowlisted"] for f in doc["findings"])
    assert all(k.split(":")[1].startswith("tpubench_torch/") for k in allow)
    assert all(j.strip() for j in allow.values())


def test_json_schema_keys_are_the_reference(port_check):
    _, doc = port_check
    src = """
def f():
    try:
        work()
    except BaseException:
        pass
"""
    theirs = jax_analysis.run_check(
        files=[jax_analysis.SourceFile.parse("x.py", src)], allowlist={},
        with_drift=False).to_dict()
    ours = analysis.run_check(
        files=[analysis.SourceFile.parse("x.py", src)], allowlist={},
        with_drift=False).to_dict()
    assert ours == theirs
    assert doc["schema"] == analysis.SCHEMA == jax_analysis.SCHEMA
    assert set(doc) == set(theirs)
    assert set(doc["findings"][0]) == set(theirs["findings"][0])
    assert set(doc["summary"]) == set(theirs["summary"])


@pytest.mark.parametrize("guard", sorted(drift.DRIFT_GUARDS))
def test_each_drift_guard_runs_clean_on_the_port(guard):
    assert analysis.run_drift_guard(guard) == []
    assert drift.DRIFT_GUARDS[guard][0].startswith("tpubench_torch/")


def test_tune_knobs_guard_holds_the_ports_flags(monkeypatch):
    """The guard compares the knob registry with the port's own parser
    (``--depth`` is a spelling of ``--staging-depth``, one dest) and
    still fires on a knob without a flag."""
    import argparse

    from tpubench_torch.tune import controller

    p = argparse.ArgumentParser()
    cli._add_common(p)
    assert p.parse_args(["--depth", "3"]).staging_depth == 3
    assert p.parse_args(["--staging-depth", "2"]).staging_depth == 2
    knobs = dict(controller.ACTUATED)
    knobs["staging_depth"] = dict(knobs["staging_depth"], cli="depth")
    monkeypatch.setattr(controller, "ACTUATED", knobs)
    assert analysis.run_drift_guard("tune-knobs") == [
        "knob staging_depth: CLI flag dest 'depth' missing"]


def test_engine_that_cannot_build_is_a_reported_skip(monkeypatch):
    """The port's engine raises on a failed build (never answers None):
    the native-counters guard reports that as a skip, never a pass."""
    from tpubench_torch.analysis.core import SourceFile
    from tpubench_torch.native import engine

    def broken():
        raise RuntimeError("g++ failed (1): no compiler\nmore")

    monkeypatch.setattr(engine, "get_engine", broken)
    with pytest.raises(analysis.DriftSkip, match="no compiler"):
        analysis.run_drift_guard("native-counters")
    rep = analysis.run_check(files=[SourceFile.parse("x.py", "x = 1\n")],
                             allowlist={})
    assert rep.skipped == [
        "drift guard 'native-counters': native toolchain unavailable: "
        "g++ failed (1): no compiler"]
    assert rep.clean


# --------------------------------------------- allowlist & exit contract --

def _allowlist(tmp_path, entries, schema="tpubench-check-allowlist/1"):
    p = tmp_path / "al.json"
    p.write_text(json.dumps({"schema": schema, "entries": entries}))
    return str(p)


@pytest.mark.parametrize("entries, schema, match", [
    ([{"key": "thread:x.py:f:baseexception-swallow", "justification": ""}],
     "tpubench-check-allowlist/1", "justification"),
    ([{"key": "", "justification": "why"}], "tpubench-check-allowlist/1",
     "missing key"),
    ([{"key": "k", "justification": "a"}, {"key": "k", "justification": "b"}],
     "tpubench-check-allowlist/1", "duplicate"),
    ([], "nope", "schema"),
], ids=["no_justification", "no_key", "duplicate", "schema"])
def test_allowlist_policy_as_reference(tmp_path, entries, schema, match):
    path = _allowlist(tmp_path, entries, schema)
    with pytest.raises(analysis.CheckConfigError, match=match) as a:
        analysis.load_allowlist(path)
    with pytest.raises(jax_analysis.CheckConfigError) as b:
        jax_analysis.load_allowlist(path)
    assert str(a.value) == str(b.value)
    with pytest.raises(analysis.CheckConfigError, match="not found"):
        analysis.load_allowlist(str(tmp_path / "no-such-allowlist.json"))


def test_allowlisted_finding_suppresses_and_stale_entry_fails():
    bad = analysis.SourceFile.parse("x.py", """
def f():
    try:
        work()
    except BaseException:
        pass
""")
    key = "thread:x.py:f:baseexception-swallow"
    rep = analysis.run_check(files=[bad], allowlist={key: "vetted: test"},
                             with_drift=False)
    assert rep.clean and rep.exit_code == 0
    assert [f.key for f in rep.suppressed] == [key]
    rep = analysis.run_check(files=[bad], allowlist={}, with_drift=False)
    assert not rep.clean and rep.exit_code == 1
    clean = analysis.SourceFile.parse("x.py", "x = 1\n")
    rep = analysis.run_check(files=[clean], allowlist={key: "vetted: test"},
                             with_drift=False)
    assert rep.stale_allowlist == [key] and rep.exit_code == 1
    other = analysis.SourceFile.parse("y.py", "x = 1\n")
    rep = analysis.run_check(files=[other], allowlist={key: "vetted: test"},
                             with_drift=False)
    assert rep.stale_allowlist == [] and rep.clean
    drift_key = "drift:x.py:metrics:drift:metrics"
    rep = analysis.run_check(files=[clean],
                             allowlist={drift_key: "vetted: test"},
                             with_drift=False)
    assert rep.stale_allowlist == [] and rep.clean


def test_exit_codes_0_1_2(tmp_path, capsys):
    """0 clean, 1 findings or a stale entry, 2 a broken analyzer config
    — through the CLI, on files of the port's tree."""
    one = "tpubench_torch/staging/device.py"
    assert cli.main(["check", "--no-drift", one]) == 0
    # DevicePutStager.finish's two teardown handlers share one vetting.
    assert "0 findings (2 allowlisted" in capsys.readouterr().out
    empty = _allowlist(tmp_path, [])
    assert cli.main(["check", "--no-drift", "--allowlist", empty, one]) == 1
    out = capsys.readouterr().out
    assert "DevicePutStager.finish" in out and "2 findings" in out
    stale = _allowlist(tmp_path, [
        {"key": "thread:tpubench_torch/fleet/vtime.py:EventLoop.run:"
                "baseexception-swallow", "justification": "long gone"}])
    assert cli.main(["check", "--no-drift", "--allowlist", stale,
                     "tpubench_torch/fleet/vtime.py"]) == 1
    assert "stale entry" in capsys.readouterr().out
    unjustified = _allowlist(tmp_path, [{"key": "k", "justification": " "}])
    assert cli.main(["check", "--no-drift", "--allowlist", unjustified,
                     one]) == 2
    assert "justification is required" in capsys.readouterr().err
    assert cli.main(["check", "--no-drift", "--allowlist",
                     str(tmp_path / "missing.json"), one]) == 2


def test_report_times_each_pass_and_guard(monkeypatch, capsys):
    """The run's own seconds: the tree's load, each pass and each drift
    guard (a skipped one too), kept on the Report and out of the JSON."""
    def skip(root):
        raise drift.DriftSkip("no engine")

    monkeypatch.setattr(drift, "DRIFT_GUARDS", {
        "ok": ("x.py", lambda root: []), "skip": ("x.py", skip)})
    kept = []
    assert analysis.run_cli_check(
        json_out=True, paths=["tpubench_torch/fleet/vtime.py"],
        keep=kept) == 0
    doc = json.loads(capsys.readouterr().out)
    (rep,) = kept
    assert set(rep.seconds) == {"load_tree", *doc["passes"],
                                "drift:ok", "drift:skip"}
    assert all(s >= 0.0 for s in rep.seconds.values())
    assert doc["skipped"] == ["drift guard 'skip': no engine"]
    assert "seconds" not in doc and rep.to_dict() == doc


def test_check_counts_real_violation_classes():
    shapes = {
        "op-leak:op": "def f(wf):\n    op = wf.begin('o', 't')\n",
        "lease-leak:lease":
            "def f(pool):\n    lease = pool.lease(1)\n    use(lease.view())\n",
        "baseexception-swallow":
            "def f():\n    try:\n        w()\n"
            "    except BaseException:\n        pass\n",
        "unnamed-thread":
            "import threading\n"
            "def f():\n    threading.Thread(target=f).start()\n",
    }
    for code, src in shapes.items():
        rep = analysis.run_check(
            files=[analysis.SourceFile.parse("fixture.py", src)],
            allowlist={}, with_drift=False)
        assert code in [f.code for f in rep.findings], code
