"""``report``, ``report timeline``, ``report trace`` and ``top`` of the
port against ``tpubench``'s on the same documents: result JSONs and a
flight journal written by the port on the CPU (a validated read, a tuned
read, a tune sweep), and the bench/multichip artifacts committed at the
root of the repository. The text must be equal, character for character
(``top``'s journal ages read one fixed clock in both), and ``--fail-on``
must give the same exit codes and lines. The drill, drill-sweep and
replay blocks render as ``tpubench``'s; a document carrying the block of
a workload the port does not have yet (fleet) is refused, naming its
ROADMAP item.
"""

import json
import types
from pathlib import Path

import pytest

import tpubench.cli as jax_cli
import tpubench.obs.live as jax_live
from tpubench.obs.trace import render_trace_report as jax_render_trace
from tpubench.workloads import report_cmd as jax_report

import tpubench_torch.obs.live as port_live
from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.metrics.report import write_result
from tpubench_torch.obs.flight import load_journals
from tpubench_torch.obs.trace import render_trace_report
from tpubench_torch.workloads import report_cmd, tune_cmd

REPO = Path(__file__).resolve().parents[1]


def _cfg(mode="device_put", **staging):
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 3
    cfg.workload.read_calls_per_worker = 2
    cfg.workload.object_size = 300_001
    cfg.workload.granule_bytes = 64 * 1024
    cfg.staging.mode = mode
    cfg.staging.slot_bytes = 128 * 1024
    for k, v in staging.items():
        setattr(cfg.staging, k, v)
    cfg.obs.export = "none"
    return cfg


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """Result files and journals written by the port on the CPU."""
    d = tmp_path_factory.mktemp("report")
    out = {}
    cfg = _cfg(validate_checksum=True)
    cfg.obs.flight_journal = str(d / "validate.json")
    out["validate"] = write_result(cli.read(cfg, device="cpu"), str(d),
                                   tag="validate")
    cfg = _cfg(depth=3)
    cfg.workload.read_calls_per_worker = 10_000_000
    cfg.tune.enabled = True
    cfg.tune.window_s = 0.05
    cfg.tune.warmup_windows = 1
    cfg.tune.duration_s = 0.5
    cfg.tune.knobs = ["workers", "staging_depth"]
    cfg.obs.flight_journal = str(d / "tuned.json")
    out["tuned"] = write_result(cli.read(cfg, device="cpu"), str(d),
                                tag="tuned")
    cfg = _cfg("pallas")
    cfg.workload.read_calls_per_worker = 1
    cfg.tune.knobs = ["workers", "staging_depth"]
    out["sweep"] = write_result(
        tune_cmd.run_tune(cfg, mode="sweep", device="cpu"), str(d),
        tag="sweep")
    out["journals"] = [str(d / "validate.json"), str(d / "tuned.json")]
    return out


def test_report_text_matches_reference(docs):
    paths = [docs["validate"], docs["tuned"], docs["sweep"]]
    text = report_cmd.run_report(paths)
    assert text == jax_report.run_report(paths)
    assert "checksum_ok=True" in text and "tuned" in text
    assert "static sweep" in text and "A/B vs baseline" in text
    assert "tune[B]:" in text


@pytest.mark.parametrize("name", ["BENCH_r05.json", "MULTICHIP_SWEEP.json",
                                  "BENCH_r01.json"])
def test_report_of_committed_artifacts_matches_reference(name):
    """``bench.py`` lines (and their BENCH_rN.json wrappers) and the multichip
    sweep artifact are plain dicts: the port renders them as tpubench
    does."""
    path = str(REPO / name)
    assert report_cmd.run_report([path]) == jax_report.run_report([path])


def test_timeline_and_trace_match_reference(docs):
    """One journal and two merged: equal timeline and trace text; the
    tuned run's controller decisions are counted."""
    for paths in ([docs["journals"][1]], docs["journals"]):
        text = report_cmd.run_timeline(paths)
        assert text == jax_report.run_timeline(paths)
        trace = report_cmd.run_trace(paths, show=2)
        assert trace == jax_report.run_trace(paths, show=2)
    assert "tune decisions:" in report_cmd.run_timeline(
        [docs["journals"][1]])
    loaded = load_journals(docs["journals"])
    assert (render_trace_report(loaded, head_rate=0.5, max_keep=4)
            == jax_render_trace(loaded, head_rate=0.5, max_keep=4))


def test_top_frame_matches_reference(docs, monkeypatch, capsys):
    clock = types.SimpleNamespace(time=lambda: 2_000_000_000.0,
                                  sleep=lambda s: None)
    monkeypatch.setattr(port_live, "time", clock)
    monkeypatch.setattr(jax_live, "time", clock)
    assert cli.main(["top", "--once", "--no-color", *docs["journals"]]) == 0
    port = capsys.readouterr().out
    assert jax_cli.main(["top", "--once", "--no-color",
                         *docs["journals"]]) == 0
    assert port == capsys.readouterr().out
    assert port.startswith("tpubench top — 2 journal(s)") and "tune=" in port


@pytest.mark.parametrize("gates, rc", [
    (["errors>0"], 0),
    (["gbps>0", "errors>0"], 1),
    (["no_such_metric<1"], 2),
])
def test_fail_on_exit_codes_match_reference(docs, gates, rc, capsys):
    argv = ["report", docs["validate"], docs["tuned"]]
    for g in gates:
        argv += ["--fail-on", g]
    assert cli.main(argv) == rc
    port = capsys.readouterr().out
    assert jax_cli.main(argv) == rc
    assert port == capsys.readouterr().out


def test_report_cli_timeline_and_trace(docs, capsys):
    assert cli.main(["report", "timeline", *docs["journals"]]) == 0
    assert cli.main(["report", "trace", docs["journals"][0],
                     "--show-traces", "1"]) == 0
    out = capsys.readouterr().out
    assert "phase segments (ms):" in out and "== trace report:" in out
    with pytest.raises(SystemExit, match="flight-journal path"):
        cli.main(["report", "trace"])


def test_train_ingest_report_prints_the_reference_scorecard(tmp_path):
    """The pipeline block renders: the port's ``report`` of a
    train-ingest result holds the text of ``tpubench``'s
    ``format_pipeline_scorecard`` for the same block, and both packages'
    ``report`` give the same document text; a 2-run report adds the
    pipeline A/B lines in both."""
    from tpubench.workloads.train_ingest import (
        format_pipeline_scorecard as jax_scorecard,
    )
    from tpubench_torch.workloads.train_ingest import (
        format_pipeline_scorecard,
        run_train_ingest,
    )

    paths = []
    for readahead in (0, 2):
        cfg = BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.workload.workers = 2
        cfg.workload.object_size = 200_000
        cfg.workload.granule_bytes = 64 * 1024
        cfg.pipeline.steps, cfg.pipeline.epochs = 3, 2
        cfg.pipeline.readahead = readahead
        cfg.staging.depth = 3
        res = run_train_ingest(cfg, device="cpu")
        paths.append(write_result(res, str(tmp_path), tag=f"ra{readahead}"))
    for path in paths:
        pipe = json.loads(Path(path).read_text())["extra"]["pipeline"]
        text = jax_scorecard(pipe)
        assert format_pipeline_scorecard(pipe) == text
        out = report_cmd.run_report([path])
        assert text in out and out == jax_report.run_report([path])
    both = report_cmd.run_report(paths)
    assert both == jax_report.run_report(paths)
    assert "pipeline: stalled" in both


def test_fleet_block_renders_as_reference(docs, tmp_path):
    """A fleet run's block (the last one the port's report lacked)
    renders as ``tpubench``'s report renders it."""
    from tpubench_torch.fleet.driver import run_fleet

    cfg = BenchConfig()
    cfg.workload.object_size = 1 << 20
    cfg.workload.granule_bytes = 64 * 1024
    cfg.obs.export = "none"
    cfg.fleet.hosts, cfg.serve.duration_s = 4, 0.2
    doc = json.loads(Path(docs["validate"]).read_text())
    doc["extra"]["fleet"] = run_fleet(cfg, device="cpu").extra["fleet"]
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc))
    text = report_cmd.run_report([str(path)])
    assert text == jax_report.run_report([str(path)])
    assert "== fleet simulation ==" in text and "hosts=4" in text


# The blocks of tpubench's drill, drill-sweep and replay documents, as
# their workloads write them (the values of a small CPU run).
DRILL_BLOCKS = {
    "drill": {
        "arm": {"restore_via_coop": True, "delta_saves": True},
        "incident": {"kill_at_s": 1.0, "join_at_s": 1.5, "victim": 3},
        "restore_class": "restore",
        "restore": {"requested": True, "completed": True, "verified": True,
                    "shards": 16, "shards_restored": 16, "bytes": 1 << 31,
                    "chunks": 1024, "torn_rereads": 2, "shed_repushes": 1,
                    "forced_direct": 0, "errors": 0,
                    "time_to_restore_s": 3.25, "via_coop": True},
        "saves": {"passes": 4, "interval_s": 1.0, "delta": True,
                  "uploaded_shards": 16, "dirty_shards": 16,
                  "skipped_clean": 48, "cas_conflicts": 0,
                  "full_fallbacks": 0, "bytes_uploaded": 1 << 31,
                  "errors": 0},
        "gold_slo": {"restore_window": {"gold": 0.95, "silver": None},
                     "steady": {"gold": 1.0, "silver": 0.5}},
        "time_to_rewarm_s": 0.5,
        "amplification": {"checkpoint_bytes": 1 << 31,
                          "restore_bytes": 1 << 31,
                          "origin_bytes_total": 3 << 30, "ratio": 1.5},
        "meta": {"ops": 400, "completed": 400, "errors": 0,
                 "offered_rps": 200.0, "achieved_rps": 199.0,
                 "p50_ms": 1.0, "p99_ms": 4.5},
    },
    "drill_sweep": {
        "points": [{"save_interval_s": 2.0, "save_passes": 2,
                    "bytes_uploaded": 1 << 20,
                    "gold_slo_restore_window": 1.0, "p99_ms": 3.5},
                   {"save_interval_s": 0.5, "save_passes": 8,
                    "bytes_uploaded": 1 << 22,
                    "gold_slo_restore_window": None, "p99_ms": None}],
        "knee": {"offered_rps": 2.0, "reason": "p99 inflection"},
    },
    "replay": {
        "bundle": "gold", "fingerprint": "f", "original_fingerprint": "o",
        "config_match": False, "arrivals_match": True,
        "baseline": {"arrivals": 10, "completed": 10, "shed": 0,
                     "errors": 0, "gold_slo": 1.0, "goodput_gbps": 0.5,
                     "p99_ms": 4.0, "rewarm_s": 0.5},
        "replayed": {"arrivals": 10, "completed": 9, "shed": 1,
                     "errors": 0, "gold_slo": 0.9, "goodput_gbps": 0.45,
                     "p99_ms": 6.0, "rewarm_s": 0.75},
        "diff": {"gold_slo_delta_pts": -10.0, "goodput_retention": 0.9,
                 "p99_ratio": 1.5},
    },
}


@pytest.mark.parametrize("block", ["drill", "drill_sweep", "replay"])
def test_drill_and_replay_blocks_render_as_reference(docs, block, tmp_path):
    """The blocks once refused render now, as ``tpubench``'s ``report``
    renders them, alone and against the plain run."""
    doc = json.loads(Path(docs["validate"]).read_text())
    doc["extra"][block] = DRILL_BLOCKS[block]
    if block == "drill_sweep":
        doc["extra"]["drill"] = DRILL_BLOCKS["drill"]
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc))
    for paths in ([str(path)], [docs["validate"], str(path)]):
        text = report_cmd.run_report(paths)
        assert text == jax_report.run_report(paths)
    marker = {"drill": "incident drill scorecard",
              "drill_sweep": "save-interval sweep",
              "replay": "== replay vs original (gold) =="}[block]
    assert marker in text


LIFECYCLE_BLOCKS = {
    "save": {"op": "save", "goodput_gbps": 1.25, "objects": 16,
             "bytes": 1 << 31, "parts": 128, "part_bytes": 16 << 20,
             "part_latency": {"p50_ms": 40.5, "p99_ms": 90.25, "count": 128},
             "resumed_parts": 16, "corrupt_finalizes": 0, "verified": True},
    "restore": {"op": "restore", "time_to_restore_s": 1.5,
                "goodput_gbps": 1.43, "objects": 16, "bytes": 1 << 31,
                "fetch_seconds": 1.25, "stage_seconds": 0.25,
                "staged": True, "shards_per_object": 1, "verified": True},
    "meta_storm": {"op": "meta_storm", "ops": 400, "offered_rps": 200.0,
                   "achieved_rps": 198.5, "errors": 0,
                   "latency": {"p50_ms": 1.5, "p99_ms": 9.0},
                   "by_kind": {"list": {"count": 80, "p50_ms": 2.0,
                                        "p99_ms": 9.5}}},
}


@pytest.mark.parametrize("op", list(LIFECYCLE_BLOCKS))
def test_lifecycle_block_renders_as_reference(docs, op, tmp_path):
    """The ``lifecycle`` block renders as ``tpubench``'s, every op's
    branch, and so do the A/B lines between two documents of one op."""
    base = json.loads(Path(docs["validate"]).read_text())
    paths = []
    for i, scale in enumerate((1.0, 0.5)):
        doc = json.loads(json.dumps(base))
        block = dict(LIFECYCLE_BLOCKS[op])
        if "goodput_gbps" in block:
            block["goodput_gbps"] *= scale
        doc["extra"]["lifecycle"] = block
        path = tmp_path / f"doc{i}.json"
        path.write_text(json.dumps(doc))
        paths.append(str(path))
    text = report_cmd.run_report(paths)
    assert text == jax_report.run_report(paths)
    assert f"lifecycle [{op}]" in text
