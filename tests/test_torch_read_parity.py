"""The slice as a whole: one config and one dataset through ``tpubench
read`` (JAX on the CPU) and ``tpubench_torch read`` (PyTorch on the CPU).

Both packages run the same config dict over the same fake-store
population (carried across by ``tpubench_torch.convert.from_reference``)
in the three staging modes of the main path, on the zero-copy route and
the copying route. Bytes, transfers, host and device checksums must be
equal — exactly; the results must have the same keys, ``extra`` included.
The flight recorder's summary (``extra["flight"]``, on by default in both)
is compared by structure: record counts per kind, the set of phase names
and the key sets, exactly; its times are not compared.

Not compared for equality, and why:
* timings (wall, GB/s, latencies) — they measure the run, not its result;
* ``n_chips``, ``gbps_per_chip``, ``staged_gbps_per_chip`` and ``device`` —
  the JAX test harness simulates 8 CPU devices, the port on the CPU has 1;
* ``native_slots`` — the JAX stager uses the native engine's aligned
  buffers where it builds, the port pins slots only on CUDA.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from tpubench.config import BenchConfig as JaxBenchConfig
from tpubench.staging import device as jax_staging
from tpubench.storage.fake import FakeBackend as JaxFakeBackend
from tpubench.workloads.read import run_read as jax_run_read

from tpubench_torch import cli, convert
from tpubench_torch.config import BenchConfig, refuse_unported
from tpubench_torch.kernels import landing
from tpubench_torch.obs.tracing import NoopTracer, make_tracer
from tpubench_torch.staging.device import make_sink_factory
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.workloads.read import run_read

OBJECT_SIZE = 777_777  # not a granule multiple: the short-tail path
WORKERS = 2
EXTRA_ONLY_IN_JAX: set = set()

MODES = {
    "device_put_validate": dict(mode="device_put", validate_checksum=True),
    "device_put_depth2": dict(mode="device_put", depth=2),
    "pallas": dict(mode="pallas"),
}


@pytest.fixture(autouse=True)
def _need_devices(jax_cpu_devices):
    pass


def _reference_config(mode: str, zero_copy: bool) -> dict:
    cfg = JaxBenchConfig()
    cfg.workload.workers = WORKERS
    cfg.workload.read_calls_per_worker = 2
    cfg.workload.object_size = OBJECT_SIZE
    cfg.workload.granule_bytes = 64 * 1024
    cfg.transport.protocol = "fake"
    cfg.staging.slot_bytes = 256 * 1024
    cfg.staging.zero_copy = zero_copy
    for k, v in MODES[mode].items():
        setattr(cfg.staging, k, v)
    return cfg.to_dict()


def _population():
    prefix = JaxBenchConfig().workload.object_name_prefix
    return [(f"{prefix}{i}", OBJECT_SIZE, 1) for i in range(WORKERS)]


class _Recording:
    """Sink wrapper keeping each worker's stager stats: the result pools
    them, and the checksums themselves are compared per worker."""

    def __init__(self, inner, stats: dict, worker_id: int):
        self._inner, self._stats, self._id = inner, stats, worker_id
        if hasattr(inner, "acquire"):
            self.acquire, self.commit = inner.acquire, inner.commit

    def submit(self, mv):
        self._inner.submit(mv)

    def finish(self):
        st = self._inner.finish()
        self._stats[self._id] = st
        return st


def _recording(factory, stats: dict):
    return lambda i: _Recording(factory(i), stats, i)


def flight_structure(summary: dict) -> dict:
    """What of a flight summary must agree between the packages: key
    sets, record counts per kind (reads and stage transfers), the
    overlapped-transfer count, the tail and retry counts, the phase names
    and the staged bytes — everything but times."""
    return {
        "keys": sorted(summary),
        "records": summary["records"],
        "stage_records": summary["staging"]["transfers"],
        "stage_bytes": summary["staging"]["transfer_bytes"],
        "overlapped": summary["staging"]["overlapped"],
        "errors": summary["errors"],
        "retries": summary["retries"],
        "tail": summary["tail"],
        "phases": sorted(summary["phases"]),
        "phase_keys": sorted(
            {k for v in summary["phases"].values() for k in v}
        ),
        "hosts": summary["hosts"],
    }


def _run_both(mode: str, zero_copy: bool):
    cfg_dict = _reference_config(mode, zero_copy)
    jcfg = JaxBenchConfig.from_dict(cfg_dict)
    jstats, tstats = {}, {}
    jres = jax_run_read(
        jcfg, backend=JaxFakeBackend.from_population(_population()),
        sink_factory=_recording(jax_staging.make_sink_factory(jcfg), jstats),
    ).to_dict()
    tcfg, tbackend = convert.from_reference(cfg_dict, _population())
    tres = run_read(
        tcfg, backend=tbackend, device="cpu",
        sink_factory=_recording(make_sink_factory(tcfg, device="cpu"), tstats),
    ).to_dict()
    return jres, tres, jstats, tstats


@pytest.mark.parametrize("zero_copy", [True, False], ids=["zero_copy", "copying"])
@pytest.mark.parametrize("mode", list(MODES))
def test_read_parity(mode, zero_copy):
    jres, tres, jstats, tstats = _run_both(mode, zero_copy)
    total = WORKERS * 2 * OBJECT_SIZE
    for res in (jres, tres):
        assert res["errors"] == 0
        assert res["bytes_total"] == total
        assert res["extra"]["staged_bytes"] == total
        assert res["extra"]["staging_zero_copy"] is zero_copy
    assert set(jres) == set(tres)
    assert set(jres["extra"]) - EXTRA_ONLY_IN_JAX == set(tres["extra"])
    assert set(jres["summaries"]) == set(tres["summaries"])
    assert jres["config"] == tres["config"]
    je, te = jres["extra"], tres["extra"]
    assert flight_structure(je["flight"]) == flight_structure(te["flight"])
    # One read record per read; one stage record per transfer in the
    # device_put rings, none in the pallas ring (as in tpubench).
    stage = te["flight"]["staging"]["transfers"]
    assert te["flight"]["records"] - stage == WORKERS * 2
    if mode == "pallas":
        assert stage == 0
    else:
        assert stage == te["staging"]["transfers"]
        assert te["flight"]["staging"]["transfer_bytes"] == total
    assert je.get("checksum_ok") == te.get("checksum_ok")
    if "staging" in je:
        for key in ("transfers", "staged_bytes", "depth", "drain", "workers"):
            assert je["staging"][key] == te["staging"][key], key
    assert set(je["staging_breakdown"]) == set(te["staging_breakdown"])
    for name in jres["summaries"]:
        assert (jres["summaries"][name]["count"]
                == tres["summaries"][name]["count"]), name
    assert set(jstats) == set(tstats) == set(range(WORKERS))
    for i in range(WORKERS):
        assert set(jstats[i]) == set(tstats[i])
        for key in ("staged_bytes", "transfers", "slot_bytes", "depth",
                    "checksum_ok", "checksum_host", "checksum_device"):
            assert jstats[i].get(key) == tstats[i].get(key), (i, key)


@pytest.mark.parametrize("mode", list(MODES))
def test_stager_stats_parity(mode):
    """Per-worker stager stats (what the result pools): equal transfers,
    slot size, staged bytes and both checksums, on the same bytes."""
    cfg_dict = _reference_config(mode, zero_copy=True)
    jcfg = JaxBenchConfig.from_dict(cfg_dict)
    tcfg = BenchConfig.from_dict(cfg_dict)
    data = memoryview(deterministic_bytes("parity/stager", OBJECT_SIZE).tobytes())
    jst = jax_staging.make_sink_factory(jcfg)(0)
    tst = make_sink_factory(tcfg, device="cpu")(0)
    for st in (jst, tst):
        for off in range(0, OBJECT_SIZE, 64 * 1024):
            st.submit(data[off : off + 64 * 1024])
    js, ts = jst.finish(), tst.finish()
    assert set(js) == set(ts)
    for key in ("staged_bytes", "transfers", "slot_bytes", "depth",
                "checksum_ok", "checksum_host", "checksum_device"):
        assert js.get(key) == ts.get(key), key
    assert ts["device"] == "cpu"


def test_port_runs_no_kernel_on_cpu():
    """The CPU run goes through the plain versions: no kernel launch."""
    landing.reset_launches()
    _run_both("pallas", True)
    _run_both("device_put_validate", True)
    assert landing.land.launches == 0
    assert landing.checksum.launches == 0


def test_saved_reference_config_loads_and_round_trips():
    """A JSON written by ``tpubench --save-config`` loads in the port,
    every section typed (``fleet`` the last to be), and writes back
    equal."""
    ref = JaxBenchConfig()
    ref.workload.workers = 7
    ref.staging.mode = "pallas"
    ref.serve.rate_rps = 123.0
    ref.fleet.hosts = 5
    ref.coop.hosts = 3
    cfg = BenchConfig.from_json(ref.to_json())
    assert cfg.workload.workers == 7 and cfg.staging.mode == "pallas"
    assert cfg.serve.rate_rps == 123.0 and cfg.coop.hosts == 3
    assert cfg.raw == {} and cfg.fleet.hosts == 5
    assert cfg.to_dict() == ref.to_dict()
    assert BenchConfig.from_json(cfg.to_json()).to_dict() == ref.to_dict()


def test_ported_defaults_match_reference():
    ref, port = JaxBenchConfig().to_dict(), BenchConfig().to_dict()
    for section in ("workload", "transport", "staging", "dist", "obs",
                    "telemetry", "lifecycle", "serve"):
        assert port[section] == ref[section], section


def _switched(section: str, name: str, value):
    ref = JaxBenchConfig()
    ref.transport.protocol = "fake"
    obj = ref
    for part in section.split("."):
        obj = getattr(obj, part)
    setattr(obj, name, value)
    return ref


def test_read_uploads_its_result_to_a_bucket(tmp_path, capsys):
    """``read --results-bucket B`` (``obs.results_bucket``) uploads the
    result file to bucket B as ``results/<file>`` over the run's own
    protocol, after writing it: the stored object equals the file byte for
    byte. An in-process or local protocol is refused at parse time."""
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.storage.fake_server import FakeGcsServer

    store = FakeBackend.prepopulated("tpubench/file_", 1, 70_001)
    with FakeGcsServer(store) as srv:
        rc = cli.main([
            "read", "--protocol", "http", "--endpoint", srv.endpoint,
            "--bucket", "data", "--object-name-prefix", "tpubench/file_",
            "--workers", "1", "--read-call-per-worker", "1",
            "--staging", "device_put", "--device", "cpu",
            "--results-dir", str(tmp_path), "--results-bucket", "B",
        ])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    path = out[-2].removeprefix("result: ")
    name = f"results/{path.rsplit('/', 1)[-1]}"
    assert out[-1] == f"uploaded: B/{name}"
    stored = store._objects[name].tobytes()
    assert stored == open(path, "rb").read()
    assert json.loads(stored)["config"]["obs"]["results_bucket"] == "B"
    with pytest.raises(SystemExit, match="requires --protocol http"):
        cli.main(["read", "--protocol", "fake", "--results-bucket", "B",
                  "--device", "cpu", "--results-dir", str(tmp_path)])


def test_tune_over_train_ingest_is_refused(tmp_path):
    """``tune --tune-workload train-ingest --tune-mode sweep`` runs
    through the CLI on the CPU: every cell of the sweep (readahead,
    prefetch workers, staging depth) finishes with zero errors and moves
    bytes."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([
            "tune", "--tune-workload", "train-ingest", "--tune-mode",
            "sweep", "--protocol", "fake", "--workers", "2",
            "--object-size", str(256 * 1024), "--granule-bytes",
            str(64 * 1024), "--steps", "3", "--batch-shards", "2",
            "--readahead", "2", "--prefetch-workers", "1",
            "--device", "cpu", "--results-dir", str(tmp_path),
        ])
    assert rc == 0
    assert "== tune (sweep over train-ingest) ==" in buf.getvalue()
    doc = json.loads(next(tmp_path.glob("tune_*.json")).read_text())
    sweep = doc["extra"]["tune"]["sweep"]
    assert set(sweep["axes"]) == {"readahead", "prefetch_workers",
                                  "staging_depth"}
    cells = sweep["cells"]
    assert len(cells) == 1 + sum(len(v) - 1 for v in sweep["axes"].values())
    assert all(c["errors"] == 0 and c["goodput_bps"] > 0 for c in cells)


@pytest.mark.parametrize("switch", [
    ("obs", "flight_journal", "journal.json"),
    ("obs", "enable_tracing", True),
    ("obs", "export", "cloud"),
    ("telemetry", "port", 0),
    ("transport.tail", "hedge", True),
    ("transport.tail", "watchdog", True),
    ("transport.tail", "breaker", True),
    ("dist", "num_processes", 2),
    ("obs", "profile_dir", "prof"),
    ("tune", "enabled", True),
    ("transport", "key_file", "/nonexistent/key.json"),
    ("transport", "http2", True),
], ids=lambda sw: f"{sw[0]}.{sw[1]}")
def test_lifted_switch_runs_on_cpu(switch, tmp_path, monkeypatch):
    """The switches ported so far run through the ``read`` command on the
    CPU and leave their block in the result (before, each was refused);
    tracing gets a real tracer. ``dist.num_processes`` runs this process
    as one host of a two-process pod (``cli.read`` brings no group up; a
    pod of processes runs in ``tests/test_torch_dist.py``): process 1's
    journal takes the ``.p1`` suffix. ``obs.profile_dir`` runs through
    ``cli.execute``, which holds the profiler, and leaves a trace.
    ``tune.enabled`` runs the online controller (the staging depth is its
    one knob at one worker) and stamps its trace. ``transport.key_file``
    on a store that needs no credentials changes nothing (as in
    ``tpubench``); ``transport.http2`` with ``fetch_executor='native'``
    reads from the port's h2c server through the executor's h2 pool."""
    monkeypatch.chdir(tmp_path)
    ref = _switched(*switch)
    ref.workload.workers = 1
    ref.workload.read_calls_per_worker = 1
    ref.workload.object_size = 300_001
    ref.workload.granule_bytes = 64 * 1024
    ref.staging.slot_bytes = 128 * 1024
    if switch[0] == "dist":
        ref.dist.process_id = 1
        ref.obs.flight_journal = "journal.json"
    cfg = BenchConfig.from_dict(ref.to_dict())
    refuse_unported(cfg)
    if switch[1] == "profile_dir":
        res = cli.execute("read", cfg, device="cpu")
    elif switch[1] == "http2":
        from tpubench_torch.storage.fake import FakeBackend
        from tpubench_torch.storage.fake_h2_server import FakeH2Server

        t, w = cfg.transport, cfg.workload
        t.protocol, w.fetch_executor = "http", "native"
        w.bucket, w.object_name_prefix = "testbucket", "tpubench/file_"
        with FakeH2Server(FakeBackend.prepopulated(
                w.object_name_prefix, 1, w.object_size)) as srv:
            t.endpoint = srv.endpoint
            res = cli.read(cfg, device="cpu")
        assert res.extra["executor_mode"] == "reactor"
        assert res.extra["native_transport"]["reactor_h2_streams"] > 0
    else:
        res = cli.read(cfg, device="cpu")
    assert res.errors == 0 and res.extra["staged_bytes"] == 300_001
    want = {
        "flight_journal": "flight_journal", "enable_tracing": "flight",
        "export": "metrics_export", "port": "telemetry",
        "hedge": "tail", "watchdog": "tail", "breaker": "tail",
        "num_processes": "flight_journal", "profile_dir": "flight",
        "enabled": "tune", "key_file": "flight",
        "http2": "fetch_executor",
    }[switch[1]]
    assert want in res.extra
    if switch[1] == "flight_journal":
        assert (tmp_path / "journal.json").is_file()
    if switch[1] == "num_processes":
        assert (tmp_path / "journal.json.p1").is_file()
        assert not (tmp_path / "journal.json").exists()
    if switch[1] == "profile_dir":
        assert len(list((tmp_path / "prof").glob("trace_*.json"))) == 1
    if switch[1] == "enable_tracing":
        assert not isinstance(make_tracer(cfg), NoopTracer)
    if switch[1] == "enabled":
        assert res.extra["tune"]["initial"] == {"staging_depth": 3}


def test_deterministic_bytes_match_reference():
    from tpubench.storage.base import deterministic_bytes as jax_bytes

    for name, size in (("a", 0), ("tpubench/file_0", 4097), ("x/y", 65_536)):
        assert np.array_equal(deterministic_bytes(name, size), jax_bytes(name, size))
