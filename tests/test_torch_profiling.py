"""``tpubench_torch/obs/profiling.py`` (``torch.profiler``) against
``tpubench/obs/profiling.py`` (``jax.profiler``): ``parse_profile_steps``
on the same specs, a trace written by ``--profile-dir`` on ``read
--device cpu``, the step-windowed capture, and the trace summary's
device busy share on a scripted trace."""

import json

import pytest

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, refuse_unported
from tpubench_torch.obs import profiling

SPECS = ["", "2:5", "0:0", "3:3", " 1:2", "5:2", "-1:3", "a:b", "1", "1:2:3",
         "1:", ":4"]


def _outcome(fn, spec):
    try:
        return ("ok", fn(spec))
    except SystemExit as e:
        return ("exit", str(e))


@pytest.mark.parametrize("spec", SPECS)
def test_parse_profile_steps_matches_reference(spec):
    from tpubench.obs.profiling import parse_profile_steps as jax_parse

    assert (_outcome(profiling.parse_profile_steps, spec)
            == _outcome(jax_parse, spec))


def test_profile_dir_on_read_writes_a_trace(tmp_path, capsys):
    prof = tmp_path / "prof"
    rc = cli.main(["read", "--protocol", "fake", "--workers", "2",
                   "--read-call-per-worker", "1", "--object-size", "300001",
                   "--granule-bytes", "65536", "--staging", "device_put",
                   "--validate", "--device", "cpu",
                   "--results-dir", str(tmp_path / "r"),
                   "--profile-dir", str(prof)])
    assert rc == 0
    assert f"profile trace: {prof}" in capsys.readouterr().err
    (trace,) = prof.glob("trace_*.json")
    summary = profiling.trace_summary(str(trace))
    assert summary["events_by_category"].get("cpu_op", 0) > 0
    assert summary["device_events"] == 0 and summary["window_us"] > 0
    (res,) = (tmp_path / "r").glob("read_*.json")
    assert json.loads(res.read_text())["extra"]["checksum_ok"] is True


def test_profile_dir_is_no_longer_refused():
    cfg = BenchConfig()
    cfg.obs.profile_dir = "/tmp/p"
    cfg.transport.protocol = "fake"
    refuse_unported(cfg)


def test_annotate_names_a_region(tmp_path):
    with profiling.maybe_profile(str(tmp_path), device="cpu") as cap:
        with profiling.annotate("pod_ingest/gather"):
            sum(range(1000))
    names = {e.get("name") for e in json.load(open(cap.path))["traceEvents"]}
    assert "pod_ingest/gather" in names
    assert cap.summary["events_by_category"]["user_annotation"] >= 1
    with profiling.maybe_profile("") as none:
        assert none is None


def test_hot_region_is_traced_only_under_a_profiler(tmp_path):
    """A region entered per transfer costs nothing unprofiled (no
    ``record_function``) and, under a trace, is named on the thread that
    entered it."""
    import contextlib
    import threading

    assert isinstance(profiling.hot_region("staging/transfer_wait"),
                      contextlib.nullcontext)

    def fetch_thread():
        with profiling.hot_region("staging/transfer_wait"):
            sum(range(1000))

    with profiling.maybe_profile(str(tmp_path), device="cpu") as cap:
        t = threading.Thread(target=fetch_thread)
        t.start()
        t.join()
    assert cap.summary["regions"]["staging/transfer_wait"]["count"] == 1


def test_step_profiler_captures_its_window(tmp_path):
    sp = profiling.StepProfiler(str(tmp_path), 1, 2, device="cpu")
    for step in range(4):
        sp.on_step_begin(step)
        with profiling.annotate(f"step{step}"):
            pass
        sp.on_step_end(step)
    sp.close()
    assert sp.info() == {"dir": str(tmp_path), "steps": [1, 2],
                         "captured": True}
    (trace,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.load(open(trace))["traceEvents"]}
    assert {"step1", "step2"} <= names and "step0" not in names
    assert profiling.StepProfiler("", 0, 1).info() is None


def _trace(path, events):
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_trace_summary_busy_share(tmp_path):
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "checksum_kernel(...)",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 20, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "checksum_kernel(...)",
         "ts": 60, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 500},
    ]
    s = profiling.trace_summary(_trace(tmp_path / "t.json", ev))
    assert s["window_us"] == 100 and s["device_busy_us"] == 40
    assert s["device_busy_share"] == 0.4 and s["device_events"] == 3
    assert s["kernels"] == {"checksum_kernel(...)": 2}


def test_a_cuda_trace_without_device_events_is_an_error(tmp_path):
    class Prof:
        def export_chrome_trace(self, path):
            _trace(tmp_path / "x.json", [])
            (tmp_path / "x.json").rename(path)

    with pytest.raises(RuntimeError, match="no CUDA event"):
        profiling._export(Prof(), str(tmp_path / "p"), cuda=True)
    path, summary = profiling._export(Prof(), str(tmp_path / "q"), cuda=False)
    assert summary["device_events"] == 0
