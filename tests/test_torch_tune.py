"""The tune plane: ``tpubench``'s controller, sampler, sweep and profiles
against the port's on the same inputs, and the port's live knobs on the
CPU (the staging depth of the copy ring, the elastic fan-out, the
executor's admission cap).

Parity is exact: the controller's decisions and stats, the sampler's
windows and the sweep documents are integer counts, strings and host
floats from the same arithmetic, so both packages must give equal values.
Sweeps run with ``_run_target`` replaced by a scripted result and the
module clock fixed, so the documents hold no measured time.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import tpubench.config as jax_config
import tpubench.tune.controller as jax_ctrl
import tpubench.workloads.tune_cmd as jax_tune
from tpubench.metrics.recorder import LatencyRecorder as JaxRecorder

import tpubench_torch.config as port_config
import tpubench_torch.tune.controller as port_ctrl
import tpubench_torch.workloads.tune_cmd as port_tune
from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.metrics.recorder import LatencyRecorder as PortRecorder
from tpubench_torch.staging import device as port_device
from tpubench_torch.staging.device import DevicePutStager
from tpubench_torch.staging.executor import StagerRegistry

PACKAGES = {
    "tpubench": (jax_config, jax_ctrl),
    "tpubench_torch": (port_config, port_ctrl),
}


# ------------------------------------------------------------ controller --


class FakeSampler:
    """Deterministic window source: ``fn()`` -> (goodput_bps, p99_ms)."""

    def __init__(self, fn):
        self.fn = fn

    def sample(self):
        g, p = self.fn()
        return {"seconds": 0.1, "goodput_bps": g, "p99_ms": p, "reads": 10}


def _knob(ctrl_mod, name="readahead", value=1, lo=1, hi=16, mode="mul",
          **kw):
    state = {"v": value}
    k = ctrl_mod.Knob(name, value, lambda v: state.__setitem__("v", v),
                      lo=lo, hi=hi, mode=mode, **kw)
    return k, state


def _noisy():
    seq = [100.0, 103.0, 97.0, 101.0, 99.0, 102.0, 98.0]
    i = [0]

    def fn():
        i[0] += 1
        return seq[i[0] % len(seq)], 1.0

    return fn


# The scenarios of tests/test_tune.py (monotone knee, guardrail, noisy
# flat, two knobs, zero goodput, immovable knob, guard flip, cooldown 1):
# name -> (TuneConfig overrides, knobs+sampler builder).
def _monotone(c):
    k, s = _knob(c, value=1, lo=1, hi=16)
    return [k], lambda: (100.0 * min(s["v"], 8), 1.0)


def _guardrail(c):
    k, s = _knob(c, value=1, lo=1, hi=64)
    return [k], lambda: (100.0 * s["v"], 1.0 if s["v"] <= 4 else 50.0)


def _flat(c):
    k, _ = _knob(c, value=4, lo=1, hi=16)
    return [k], _noisy()


def _two_knobs(c):
    ka, sa = _knob(c, "readahead", value=1, lo=1, hi=8)
    kb, sb = _knob(c, "prefetch_workers", value=1, lo=1, hi=4, mode="add")
    return [ka, kb], lambda: (50.0 * min(sa["v"], 4) + 25.0 * sb["v"], 1.0)


def _zero(c):
    k, _ = _knob(c, value=4, lo=1, hi=16)
    return [k], lambda: (0.0, None)


def _immovable(c):
    stuck = c.Knob("hedge_delay_s", 0.0, lambda v: None, lo=0.001, hi=0.4,
                   mode="mul", integer=False)
    k, s = _knob(c, value=1, lo=1, hi=8)
    return [k, stuck], lambda: (100.0 * min(s["v"], 4), 1.0)


def _guard_flip(c):
    k, s = _knob(c, value=4, lo=1, hi=64)
    return [k], lambda: (100.0, 1.0 if s["v"] <= 4 else 50.0)


def _cooldown(c):
    k, _ = _knob(c, value=4, lo=1, hi=16)
    return [k], lambda: (100.0, 1.0)


SCENARIOS = {
    "monotone": ({}, _monotone),
    "guardrail": ({"p99_guard": 2.0}, _guardrail),
    "noisy_flat": ({}, _flat),
    "two_knobs": ({}, _two_knobs),
    "zero_goodput": ({}, _zero),
    "immovable": ({}, _immovable),
    "guard_flip": ({"p99_guard": 2.0}, _guard_flip),
    "cooldown_1": ({"cooldown_windows": 1}, _cooldown),
}


def _drive(pkg: str, scenario: str, windows: int = 30) -> tuple:
    cfg_mod, ctrl_mod = PACKAGES[pkg]
    over, build = SCENARIOS[scenario]
    tc = cfg_mod.TuneConfig(**{
        **dict(window_s=0.1, warmup_windows=1, epsilon=0.05,
               freeze_after_reverts=2, seed=1),
        **over,
    })
    knobs, fn = build(ctrl_mod)
    ctrl = ctrl_mod.TuneController(tc, knobs, FakeSampler(fn))
    for _ in range(windows):
        ctrl.step()
    return ctrl.windows, ctrl.stats()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_decisions_match_reference(scenario):
    """One scripted sampler sequence, seed and window count through both
    packages' ``TuneController.step``: equal windows and equal stats."""
    ref_windows, ref_stats = _drive("tpubench", scenario)
    windows, stats = _drive("tpubench_torch", scenario)
    assert windows == ref_windows
    assert stats == ref_stats
    assert stats["converged"], scenario


def test_recorder_sampler_windows_match_reference():
    """Both samplers over the same recorded latencies, byte counts and
    clock give equal windows, including a window without samples."""
    rng = np.random.default_rng(7)
    lat = rng.integers(1_000_000, 50_000_000, size=(3, 40))
    grow = rng.integers(0, 1 << 20, size=5)
    out = {}
    for name, rec_cls, ctrl_mod in (
        ("ref", JaxRecorder, jax_ctrl), ("port", PortRecorder, port_ctrl),
    ):
        recs = [rec_cls(f"w{i}") for i in range(3)]
        state = {"bytes": 0, "t": 0.0}
        sampler = ctrl_mod.RecorderSampler(
            recs[:2], lambda: state["bytes"], clock=lambda: state["t"])
        sampler.add_recorder(recs[2])
        windows = []
        for w in range(5):
            if w != 3:  # window 3 records nothing
                for r, row in zip(recs, lat):
                    for ns in row[w * 8:(w + 1) * 8]:
                        r.record_ns(int(ns))
            state["bytes"] += int(grow[w]) if w != 3 else 0
            state["t"] += 0.25 + 0.01 * w
            windows.append(sampler.sample())
        out[name] = windows
    assert out["port"] == out["ref"]
    assert out["port"][3]["p99_ms"] is None and out["port"][3]["reads"] == 0


def test_port_tune_surface_matches_reference():
    """Knob set, actuated config paths, defaults and ceilings."""
    assert port_config.TUNE_KNOBS == jax_config.TUNE_KNOBS
    assert port_ctrl.ACTUATED == jax_ctrl.ACTUATED
    assert (BenchConfig().to_dict()["tune"]
            == jax_config.BenchConfig().to_dict()["tune"])
    for d in range(1, 10):
        assert (port_ctrl.staging_depth_ceiling(d)
                == jax_ctrl.staging_depth_ceiling(d))
    with pytest.raises(SystemExit, match="window_s"):
        port_config.validate_tune_config(port_config.TuneConfig(window_s=0))
    with pytest.raises(SystemExit, match="unknown knob"):
        port_config.validate_tune_config(port_config.TuneConfig(knobs=["x"]))


# ---------------------------------------------------------------- sweep --


class _Summary:
    def __init__(self, p99):
        self.p99_ms = p99


class _Scripted:
    """A result as ``_cell_stats`` reads it, a function of the knobs."""

    def __init__(self, cfg):
        w, d = cfg.workload.workers, cfg.staging.depth
        self.gbps = (min(w, 4) * 0.5 - max(0, w - 4) * 0.05
                     + min(d, 3) * 0.1) * (
            0.9 if cfg.staging.mode == "pallas" else 1.0)
        self.summaries = {"read": _Summary(2.0 + w * (5.0 if d > 3 else 0.5))}
        self.wall_seconds = 1.25
        self.errors = 1 if (w == 2 and d == 3) else 0
        self.extra = {}


def _sweep_cfg(mode: str) -> dict:
    ref = jax_config.BenchConfig()
    ref.transport.protocol = "fake"
    ref.workload.workers = 8
    ref.staging.mode = mode
    ref.staging.depth = 3
    ref.tune.knobs = ["workers", "staging_depth", "hedge_delay_s"]
    return ref.to_dict()


@pytest.fixture
def scripted(monkeypatch):
    clock = types.SimpleNamespace(monotonic=lambda: 100.0,
                                  time=lambda: 1_700_000_000.0)
    for mod in (jax_tune, port_tune):
        monkeypatch.setattr(mod, "_run_target",
                            lambda cfg, workload, **kw: _Scripted(cfg))
        monkeypatch.setattr(mod, "time", clock)


@pytest.mark.parametrize("mode", ["device_put", "pallas"])
def test_sweep_documents_match_reference(mode, scripted):
    d = _sweep_cfg(mode)
    ref_cfg = jax_config.BenchConfig.from_dict(d)
    cfg = BenchConfig.from_dict(d)
    axes = port_tune.sweep_axes(cfg, "read")
    assert axes == jax_tune.sweep_axes(ref_cfg, "read")
    assert axes == {"workers": [1, 2, 4, 8], "staging_depth": [1, 2, 3, 4]}
    doc = port_tune.run_sweep(cfg, "read", device="cpu")
    assert doc == jax_tune.run_sweep(ref_cfg, "read")
    assert doc["best"]["values"] == {"workers": 4, "staging_depth": 3}
    res = port_tune.run_tune(cfg, mode="sweep", device="cpu")
    ref = jax_tune.run_tune(ref_cfg, mode="sweep")
    assert res.extra["tune"] == ref.extra["tune"]
    assert res.workload == ref.workload == "tune" and res.gbps == ref.gbps
    assert (port_tune.format_tune_block(res.extra["tune"])
            == jax_tune.format_tune_block(ref.extra["tune"]))


@pytest.mark.parametrize("writer", ["tpubench", "tpubench_torch"])
def test_profile_written_by_either_package_applies_in_the_other(
        writer, scripted, tmp_path):
    d = _sweep_cfg("device_put")
    prof = str(tmp_path / "prof.json")
    if writer == "tpubench":
        jax_tune.run_tune(jax_config.BenchConfig.from_dict(d), mode="sweep",
                          profile_path=prof)
    else:
        port_tune.run_tune(BenchConfig.from_dict(d), mode="sweep",
                           profile_path=prof, device="cpu")
    doc = json.loads(open(prof).read())
    assert doc["format"] == port_tune.PROFILE_FORMAT == jax_tune.PROFILE_FORMAT
    assert doc["recommended"] == {"workers": 4, "staging_depth": 3}
    ref_cfg, cfg = jax_config.BenchConfig(), BenchConfig()
    assert (port_tune.apply_tune_profile(cfg, prof)
            == jax_tune.apply_tune_profile(ref_cfg, prof))
    assert cfg.to_dict()["workload"] == ref_cfg.to_dict()["workload"]
    assert cfg.to_dict()["staging"] == ref_cfg.to_dict()["staging"]
    assert cfg.workload.workers == 4 and cfg.staging.depth == 3
    assert (port_tune.recommended_flags(doc["recommended"])
            == "--staging-depth 3 --workers 4")
    # Knobs of sections the port keeps raw (pipeline) land in that dict
    # and round-trip to the reference.
    port_tune.apply_knob_values(cfg, {"readahead": 6})
    jax_tune.apply_knob_values(ref_cfg, {"readahead": 6})
    back = jax_config.BenchConfig.from_dict(cfg.to_dict())
    assert back.pipeline.readahead == ref_cfg.pipeline.readahead == 6


# ----------------------------------------------------------- live depth --


class GatedEngine:
    """Transfer surface whose copies land only when the test says so. At
    submit it keeps a snapshot of the slot; at completion it checks the
    slot still holds those bytes (a slot refilled while its copy was in
    flight would not)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.handles = []
        self.reused = 0

    def submit(self, array, device):
        h = {"array": array, "snap": array.clone(), "done": False}
        with self.lock:
            self.handles.append(h)
        return h

    def probe(self, h):
        return h["done"]

    def wait(self, h):
        if not torch.equal(h["array"], h["snap"]):
            self.reused += 1

    def delete(self, h):
        h["array"] = None

    def land(self, rng, k: int) -> None:
        with self.lock:
            pending = [h for h in self.handles if not h["done"]]
        for i in rng.permutation(len(pending))[:k]:
            pending[i]["done"] = True

    def pending(self) -> int:
        with self.lock:
            return sum(not h["done"] for h in self.handles)


def _stager(engine, depth=3, slot=4096, granule=1024):
    from tpubench_torch.config import StagingConfig

    return DevicePutStager(0, granule_bytes=granule,
                           cfg=StagingConfig(depth=depth), device="cpu",
                           slot_bytes=slot, transfer_engine=engine)


def _on_controller_thread(fn, *args):
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args)))
    t.start()
    t.join(10)
    assert not t.is_alive()
    return out[0]


def test_live_depth_grow_and_shrink_mid_stream(monkeypatch):
    """3→6 then 6→2 while a producer stages and copies land out of
    order: every byte arrives exactly once, no slot is refilled before
    its copy landed, the ring ends at 2 live slots (4 retired, freed
    only at finish), and a grow after finish allocates nothing."""
    engine = GatedEngine()
    st = _stager(engine)
    rng = np.random.default_rng(3)
    src = np.random.default_rng(5).integers(0, 256, 64 * 4096,
                                            dtype=np.uint8)
    stop = threading.Event()

    def lander():
        while not stop.is_set():
            engine.land(rng, 2)
            time.sleep(0.0005)

    t = threading.Thread(target=lander, daemon=True)
    t.start()
    try:
        for g in range(len(src) // 1024):
            if g == 40:
                assert _on_controller_thread(st.set_depth, 6) == 6
                assert len(st._slots) == 6 and st._window.depth == 6
            if g == 160:
                assert _on_controller_thread(st.set_depth, 2) == 2
            st.submit(memoryview(src[g * 1024:(g + 1) * 1024]))
        st.flush()
        st._window.drain()  # the lander still runs: every copy lands
        assert engine.pending() == 0
        assert st._slot_count == 2 and len(st._retired) == 4
        assert len(st._slots) == 6  # retired buffers stay until finish
    finally:
        stop.set()
        t.join(5)
    stats = st.finish()
    assert engine.reused == 0
    assert stats["staged_bytes"] == len(src) and stats["depth"] == 2
    landed = np.concatenate([h["snap"].numpy().reshape(-1)
                             for h in engine.handles])
    assert np.array_equal(landed[:len(src)], src)
    made = []
    real = port_device.new_slot
    monkeypatch.setattr(port_device, "new_slot",
                        lambda *a: made.append(1) or real(*a))
    assert st.set_depth(8) == 2 and made == [] and st._slots == []


def test_registry_replays_depth_on_late_attach():
    reg = StagerRegistry()
    early = reg.attach(_stager(GatedEngine()))
    reg.set_depth(5)
    late = reg.attach(_stager(GatedEngine()))
    serial = reg.attach(_stager(GatedEngine(), depth=1))
    assert len(reg) == 3
    assert early.depth == late.depth == 5 and len(late._slots) == 5
    assert serial.depth == 1 and len(serial._slots) == 1  # no window
    for st in (early, late, serial):
        st.finish()
    reg.set_depth(7)  # every stager finished: nothing grows
    assert early.depth == late.depth == 5


class _Ring:
    def __init__(self, fail=False):
        self.depth, self.fail, self.threads = 3, fail, []

    def set_depth(self, d):
        self.threads.append(threading.current_thread().name)
        if self.fail and d > self.depth:
            raise RuntimeError("cudaHostAlloc failed")
        self.depth = d
        return d


def test_registry_grow_runs_every_ring_and_raises_its_error():
    """A grow past the rings' deepest fans out on one thread per ring and
    returns when every ring has grown; a shrink, or a grow back within
    the retired slots, stays on the caller's thread; a ring's failure
    reaches the caller (the controller records it)."""
    reg = StagerRegistry()
    rings = [reg.attach(_Ring()) for _ in range(8)]
    reg.set_depth(6)
    assert [r.depth for r in rings] == [6] * 8
    assert all(r.threads == ["stager-grow"] for r in rings)
    reg.set_depth(2)
    reg.set_depth(5)  # within the rings' retired slots: no allocation
    assert all(r.depth == 5 and r.threads[-2:] == ["MainThread"] * 2
               for r in rings)
    bad = _Ring(fail=True)
    bad.depth = 5  # attaching replays depth 5: no grow, no failure
    reg.attach(bad)
    with pytest.raises(RuntimeError, match="cudaHostAlloc"):
        reg.set_depth(7)
    assert [r.depth for r in rings] == [7] * 8


# -------------------------------------------------------- online sessions --


def _online_cfg(mode: str, jax: bool = False):
    ref = jax_config.BenchConfig()
    ref.transport.protocol = "fake"
    ref.workload.workers = 4
    ref.workload.read_calls_per_worker = 10_000_000  # the timer ends it
    ref.workload.object_size = 300_001
    ref.workload.granule_bytes = 64 * 1024
    ref.staging.mode = mode
    ref.staging.depth = 3
    ref.staging.slot_bytes = 128 * 1024
    ref.obs.export = "none"
    ref.tune.enabled = True
    ref.tune.window_s = 0.1
    ref.tune.warmup_windows = 1
    ref.tune.duration_s = 1.0
    ref.tune.knobs = ["workers", "staging_depth"]
    return ref if jax else BenchConfig.from_dict(ref.to_dict())


def test_online_read_sessions_are_bounded_with_reference_keys(
        jax_cpu_devices):
    """A 1 s online session on the copy ring (depth 3, both knobs live)
    and on the landing ring (plain land; workers only, as in
    ``tpubench``): bounded by the duration, zero errors, every read byte
    staged, the landing ring's checksum right, and ``extra["tune"]`` with
    the reference's keys."""
    from tpubench.workloads.read import run_read as jax_run_read

    ref = jax_run_read(_online_cfg("device_put", jax=True)).extra["tune"]
    for mode, knobs in (("device_put", {"workers", "staging_depth"}),
                        ("pallas", {"workers"})):
        t0 = time.monotonic()
        res = cli.read(_online_cfg(mode), device="cpu")
        assert time.monotonic() - t0 < 10
        tn = res.extra["tune"]
        assert res.errors == 0 and res.bytes_total > 0
        assert res.extra["staged_bytes"] == res.bytes_total
        if mode == "pallas":
            assert res.extra["checksum_ok"] is True
        assert set(tn) == set(ref)
        assert {k for w in tn["windows"] for k in w} <= {
            k for w in ref["windows"] for k in w} | {"probe", "knob",
                                                     "converged"}
        assert set(tn["initial"]) == knobs and tn["n_windows"] >= 3
        assert tn["error"] is None
        assert res.extra["flight"]["tune"]["decisions"] == tn["n_windows"]


def test_native_executor_workers_knob_completes_every_read():
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.storage.fake_server import FakeGcsServer
    from tpubench_torch.workloads.read import run_read

    store = FakeBackend.prepopulated("tpubench/file_", count=3,
                                     size=128 * 1024)
    srv = FakeGcsServer(store).start()
    try:
        cfg = BenchConfig()
        cfg.transport.protocol = "http"
        cfg.transport.endpoint = srv.endpoint
        cfg.workload.bucket = "b"
        cfg.workload.workers = 3
        cfg.workload.read_calls_per_worker = 6
        cfg.workload.object_size = 128 * 1024
        cfg.workload.fetch_executor = "native"
        cfg.staging.mode = "none"
        cfg.obs.export = "none"
        cfg.tune.enabled = True
        cfg.tune.window_s = 0.05
        cfg.tune.knobs = ["workers"]
        res = run_read(cfg, device="cpu")
    finally:
        srv.stop()
    assert res.errors == 0
    assert res.bytes_total == 3 * 6 * 128 * 1024  # nothing dropped
    assert res.extra["tune"]["initial"] == {"workers": 3}


# ------------------------------------------------------------------ CLI --


def test_cli_tune_online_and_profile_round_trip(tmp_path, capsys):
    prof = tmp_path / "prof.json"
    common = ["--protocol", "fake", "--workers", "2",
              "--read-call-per-worker", "100000", "--object-size", "200003",
              "--granule-bytes", "65536", "--slot-bytes", "131072",
              "--staging", "device_put", "--depth", "3", "--export", "none",
              "--device", "cpu", "--results-dir", str(tmp_path)]
    assert cli.main(["tune", "--tune-mode", "online", "--tune-window",
                     "0.05", "--tune-duration", "0.4", "--tune-profile",
                     str(prof)] + common) == 0
    out = capsys.readouterr().out
    assert "== tune (online over read) ==" in out and "recommended" in out
    rec = json.loads(prof.read_text())["recommended"]
    assert set(rec) == {"workers", "staging_depth"}
    args = cli.build_parser().parse_args(
        ["read", "--tune-profile", str(prof), "--device", "cpu"])
    cfg = cli.build_config(args)
    assert (cfg.workload.workers, cfg.staging.depth) == (
        rec["workers"], rec["staging_depth"])
    # An explicit flag on the same command line wins over the profile.
    args = cli.build_parser().parse_args(
        ["read", "--tune-profile", str(prof), "--workers", "7"])
    assert cli.build_config(args).workload.workers == 7


def test_tune_over_http_spawns_the_hermetic_server():
    """``--protocol http`` with no endpoint: the sweep reads over HTTP/1.1
    from an in-process fake server that ``run_tune`` starts and stops;
    the config's endpoint is restored after."""
    cfg = BenchConfig()
    cfg.transport.protocol = "http"
    cfg.workload.bucket = "b"
    cfg.workload.workers = 2
    cfg.workload.read_calls_per_worker = 1
    cfg.workload.object_size = 200_003
    cfg.workload.granule_bytes = 64 * 1024
    cfg.staging.slot_bytes = 128 * 1024
    cfg.staging.validate_checksum = True
    cfg.obs.export = "none"
    cfg.tune.knobs = ["workers"]
    res = port_tune.run_tune(cfg, mode="sweep", device="cpu")
    cells = res.extra["tune"]["sweep"]["cells"]
    assert [c["values"] for c in cells] == [{"workers": 2}, {"workers": 1}]
    assert all(c["errors"] == 0 and c["goodput_bps"] > 0 for c in cells)
    assert cfg.transport.endpoint == ""


def test_tune_refusals():
    """An online session over ``train-ingest`` runs on the CPU: the
    controller moves the readahead and prefetch knobs inside the step
    loop and the result carries ``extra.tune``.
    Without ``--device cpu`` and without CUDA the command still raises
    instead of running on the CPU."""
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 2
    cfg.workload.object_size = 256 * 1024
    cfg.workload.granule_bytes = 64 * 1024
    cfg.pipeline.steps = 40
    cfg.pipeline.batch_shards = 2
    cfg.pipeline.readahead = 2
    cfg.pipeline.step_compute_ms = 5.0
    cfg.tune.window_s = 0.02
    cfg.tune.warmup_windows = 1
    cfg.tune.knobs = ["readahead", "prefetch_workers"]
    res = port_tune.run_tune(cfg, workload="train-ingest", device="cpu")
    assert res.workload == "tune" and res.errors == 0
    tune = res.extra["tune"]
    assert tune["workload"] == "train-ingest"
    ad = tune["adaptive"]
    assert ad["enabled"] and ad["n_windows"] >= 2 and ad.get("error") is None
    assert set(ad["initial"]) == {"readahead", "prefetch_workers"}
    assert res.bytes_total == 40 * 2 * 64 * 1024
    assert res.extra["pipeline"]["stall"]["steps"] == 40
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_tune.run_tune(cfg)
