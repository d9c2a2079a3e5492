"""The port's record / replay plane (``tpubench_torch/replay/bundle.py``,
``replay/driver.py``, the ``record`` and ``replay`` subcommands) against
``tpubench``'s, on the CPU.

* Bytes: ``write_bundle`` of one dict is the same file in both packages;
  the port's ``record`` of a journal ``tpubench`` wrote (serve and drill)
  is ``tpubench``'s bundle byte for byte; record → replay → record is
  byte-identical in the port (serve and drill).
* Both goldens under ``scenarios/`` replay under their recording config
  and pass the gates of ``scenarios/README.md``: the fingerprint matches,
  the arrivals match, gold SLO within 5 points (the drill's restore
  verified too), and ``report --fail-on`` holds.
* Refusals and degrade paths give ``tpubench``'s messages:
  ``load_bundle``, ``validate_bundle``, ``record_bundle``, a protocol that
  is not hermetic. The port raises where ``tpubench`` passes over a
  failed warm-up read (the stated difference).
* ``scorecard_diff``, ``drill_diff`` and ``format_replay_block`` equal
  ``tpubench``'s; ``record`` and ``replay`` through the CLI, and
  ``report`` of a replay equal to ``tpubench``'s text.
* The parser has 27 of the reference's 29 subcommands: only ``fleet`` and
  ``check`` are missing.

At ``TPUBENCH_BENCH_SLEEP_SCALE=0`` and small shapes (4 × 1 MiB objects,
a few hundred arrivals).
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path

import pytest

from tpubench.config import BenchConfig as JaxConfig
from tpubench.replay import bundle as jax_bundle
from tpubench.workloads import drill as jax_drill
from tpubench.workloads import report_cmd as jax_report
from tpubench.workloads import serve as jax_serve

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig
from tpubench_torch.metrics.report import write_result
from tpubench_torch.replay import bundle, driver
from tpubench_torch.workloads import drill, report_cmd, serve

REPO = Path(__file__).resolve().parents[1]
GOLDENS = {
    "chaos-serve-gold": REPO / "scenarios" / "chaos-serve-gold.tpb.gz",
    "drill-restore-gold": REPO / "scenarios" / "drill-restore-gold.tpb.gz",
}
MB = 1 << 20


@pytest.fixture(autouse=True)
def _no_sleep(monkeypatch):
    monkeypatch.setenv("TPUBENCH_BENCH_SLEEP_SCALE", "0")


def _serve_cfg(cls=BenchConfig, journal=None, qos=True):
    """``tests/test_replay.py``'s serve shape."""
    cfg = cls()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = MB
    cfg.workload.granule_bytes = 64 * 1024
    cfg.obs.export = "none"
    if journal is not None:
        cfg.obs.flight_journal = str(journal)
    sv = cfg.serve
    sv.duration_s, sv.rate_rps, sv.tenants = 1.5, 80.0, 30
    sv.workers, sv.qos, sv.seed = 2, qos, 7
    return cfg


def _drill_cfg(cls=BenchConfig, journal=None):
    """``tests/test_drill.py``'s drill shape."""
    cfg = _serve_cfg(cls, journal)
    cfg.workload.granule_bytes = 2 * MB
    sv = cfg.serve
    sv.duration_s, sv.rate_rps, sv.tenants = 3.0, 60.0, 24
    sv.workers, sv.hosts = 4, 3
    lc = cfg.lifecycle
    lc.objects, lc.object_bytes, lc.part_bytes, lc.seed = 3, 256 * 1024, \
        64 * 1024, 7
    dc = cfg.drill
    dc.kill_at_s, dc.join_at_s, dc.save_interval_s = 1.0, 1.4, 0.8
    return cfg


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """A serve and a drill journal written by ``tpubench``."""
    import os

    d = tmp_path_factory.mktemp("journals")
    old = os.environ.get("TPUBENCH_BENCH_SLEEP_SCALE")
    os.environ["TPUBENCH_BENCH_SLEEP_SCALE"] = "0"
    try:
        jax_serve.run_serve(_serve_cfg(JaxConfig, d / "serve.json"))
        jax_drill.run_drill(_drill_cfg(JaxConfig, d / "drill.json"))
    finally:
        if old is None:
            del os.environ["TPUBENCH_BENCH_SLEEP_SCALE"]
        else:
            os.environ["TPUBENCH_BENCH_SLEEP_SCALE"] = old
    return {"serve": str(d / "serve.json"), "drill": str(d / "drill.json")}


def test_write_bundle_bytes_match_reference(tmp_path):
    doc = {"format": bundle.BUNDLE_FORMAT, "name": "x", "z": 1,
           "a": [2, 3.5, {"k": None}]}
    for suffix in (".tpb.gz", ".tpb"):
        ours = bundle.write_bundle(doc, str(tmp_path / f"p{suffix}"))
        theirs = jax_bundle.write_bundle(doc, str(tmp_path / f"r{suffix}"))
        assert Path(ours).read_bytes() == Path(theirs).read_bytes()
        assert bundle.load_bundle(ours) == doc
    golden = bundle.load_bundle(str(GOLDENS["chaos-serve-gold"]))
    out = bundle.write_bundle(golden, str(tmp_path / "g.tpb.gz"))
    assert Path(out).read_bytes() == GOLDENS["chaos-serve-gold"].read_bytes()


@pytest.mark.parametrize("kind", ["serve", "drill"])
def test_record_of_a_reference_journal_matches_reference(kind, journals,
                                                         tmp_path):
    ours = bundle.record_bundle([journals[kind]], str(tmp_path / "p.tpb.gz"),
                                name="j")
    theirs = jax_bundle.record_bundle([journals[kind]],
                                      str(tmp_path / "r.tpb.gz"), name="j")
    assert ours == theirs and ours["workload"] == kind
    assert (tmp_path / "p.tpb.gz").read_bytes() == \
        (tmp_path / "r.tpb.gz").read_bytes()
    assert set(ours) == set(bundle.BUNDLE_FIELDS)


@pytest.mark.parametrize("kind", ["serve", "drill"])
def test_record_replay_record_is_byte_identical(kind, tmp_path):
    make = _serve_cfg if kind == "serve" else _drill_cfg
    run = serve.run_serve if kind == "serve" else drill.run_drill
    cfg = make(journal=tmp_path / "j1.json")
    run(cfg, device="cpu")
    first = bundle.record_bundle([cfg.obs.flight_journal],
                                 str(tmp_path / "b1.tpb.gz"))
    rcfg = make(journal=tmp_path / "j2.json")
    res = driver.run_replay(rcfg, first, device="cpu")
    rp = res.extra["replay"]
    assert rp["config_match"] and rp["arrivals_match"], rp
    second = bundle.record_bundle([rcfg.obs.flight_journal],
                                  str(tmp_path / "b2.tpb.gz"),
                                  name=first["name"])
    assert second == first
    assert (tmp_path / "b1.tpb.gz").read_bytes() == \
        (tmp_path / "b2.tpb.gz").read_bytes()
    if kind == "drill":
        assert rp["drill"]["replayed"]["restore_verified"]
        assert rp["drill"]["diff"]["verified_match"]


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_replays_and_passes_the_gates(name, tmp_path):
    path = str(GOLDENS[name])
    gold = bundle.load_bundle(path)
    bundle.validate_bundle(gold, path)
    assert gold["name"] == name
    cfg = BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.workload.workers = 4
    cfg.workload.object_size = MB
    cfg.obs.export = "none"
    res = driver.run_replay(cfg, gold, device="cpu")
    rp = res.extra["replay"]
    assert rp["config_match"], (rp["fingerprint"],
                                rp["original_fingerprint"])
    assert rp["arrivals_match"], rp
    assert abs(rp["diff"]["gold_slo_delta_pts"]) <= 5.0, rp
    if gold["workload"] == "drill":
        assert rp["drill"]["replayed"]["restore_verified"]
        assert rp["drill"]["diff"]["verified_match"]
    rpath = write_result(res, str(tmp_path))
    assert cli.main(["report", rpath, "--fail-on", "config_match==0",
                     "--fail-on", "arrivals_match==0"]) == 0
    assert cli.main(["report", rpath, "--fail-on", "gold_slo<=1.0"]) == 1


def test_load_bundle_degrades_as_reference(tmp_path, capsys):
    full = gzip.compress(json.dumps({"format": "x"}).encode())
    cases = {"empty.tpb": b"", "torn.tpb": b'{"format": "tpubench-bun',
             "torn.tpb.gz": full[: len(full) // 2], "list.tpb": b"[1, 2]"}
    assert bundle.load_bundle(str(tmp_path / "nope")) is None
    for fname, raw in cases.items():
        p = tmp_path / fname
        p.write_bytes(raw)
        assert bundle.load_bundle(str(p)) is None
        ours = capsys.readouterr().err
        assert jax_bundle.load_bundle(str(p)) is None
        assert ours == capsys.readouterr().err and "replay bundle" in ours


def test_refusals_match_reference(journals, tmp_path):
    gold = bundle.load_bundle(str(GOLDENS["chaos-serve-gold"]))
    bad = [
        {"format": "something-else"},
        dict(gold, format="tpubench-bundle/9"),
        {k: v for k, v in gold.items() if k != "arrivals"},
        dict(gold, workload="read"),
        dict(gold, journal_schema=99),
        dict(gold, fault=dict(gold["fault"], wormhole_s=1.0)),
    ]
    for doc in bad:
        with pytest.raises(SystemExit) as a:
            bundle.validate_bundle(doc, "p")
        with pytest.raises(SystemExit) as b:
            jax_bundle.validate_bundle(doc, "p")
        assert str(a.value) == str(b.value)
    bare = tmp_path / "bare.json"
    doc = json.loads(Path(journals["serve"]).read_text())
    doc.pop("replay")
    bare.write_text(json.dumps(doc))
    for paths in ([str(bare)], [journals["serve"], journals["drill"]]):
        with pytest.raises(SystemExit) as a:
            bundle.record_bundle(paths, str(tmp_path / "x.tpb.gz"))
        with pytest.raises(SystemExit) as b:
            jax_bundle.record_bundle(paths, str(tmp_path / "y.tpb.gz"))
        assert str(a.value) == str(b.value)
    cfg = _serve_cfg()
    cfg.transport.protocol = "grpc"
    with pytest.raises(SystemExit, match="hermetic"):
        driver.run_replay(cfg, gold, device="cpu")


def test_failed_warm_up_raises(monkeypatch):
    """The stated difference: ``tpubench`` passes over a failed warm-up
    read and replays anyway; the port raises."""
    from tpubench_torch.storage.base import StorageError
    from tpubench_torch.storage.fake import FakeBackend

    def refuse(self, name, start=0, length=None):
        raise StorageError("refused", transient=False, code=403)

    monkeypatch.setattr(FakeBackend, "open_read", refuse)
    gold = bundle.load_bundle(str(GOLDENS["chaos-serve-gold"]))
    cfg = _serve_cfg()
    cfg.transport.retry.policy = "never"
    with pytest.raises(StorageError, match="refused"):
        driver.run_replay(cfg, gold, device="cpu")


def test_diffs_and_block_match_reference():
    base = {"arrivals": 10, "completed": 9, "shed": 1, "errors": 0,
            "goodput_gbps": 0.5, "gold_slo": 0.9, "gold_p99_ms": 4.0,
            "p99_ms": 8.0, "rewarm_s": 0.25}
    new = dict(base, completed=10, shed=0, goodput_gbps=0.45,
               gold_slo=0.95, p99_ms=9.0, rewarm_s=0.5)
    assert bundle.scorecard_diff(base, new) == \
        jax_bundle.scorecard_diff(base, new)
    db = {"time_to_restore_s": 0.5, "restore_verified": True,
          "slo_restore_window": {"gold": 1.0, "silver": 0.5},
          "save_passes": 4, "origin_amplification": 2.0}
    dn = dict(db, time_to_restore_s=0.75, save_passes=3,
              slo_restore_window={"gold": 0.9, "silver": None})
    assert bundle.drill_diff(db, dn) == jax_bundle.drill_diff(db, dn)
    for match in (True, False):
        rp = {"bundle": "b", "fingerprint": "f", "original_fingerprint": "o",
              "config_match": match, "arrivals_match": not match,
              "baseline": base, "replayed": new,
              "diff": bundle.scorecard_diff(base, new)}
        assert bundle.format_replay_block(rp) == \
            jax_bundle.format_replay_block(rp)
    ex = {"restore": {"time_to_restore_s": 1.5, "verified": True},
          "saves": {"passes": 2}, "amplification": {"ratio": 3.0},
          "gold_slo": {"restore_window": {"gold": 1.0}, "steady": {}}}
    assert bundle.distill_drill(ex) == jax_bundle.distill_drill(ex)


def test_cli_record_and_replay_and_report(tmp_path, capsys):
    cfg = _serve_cfg(journal=tmp_path / "j.json")
    serve.run_serve(cfg, device="cpu")
    out = str(tmp_path / "s.tpb.gz")
    assert cli.main(["record", cfg.obs.flight_journal, "--out", out]) == 0
    assert "bundle written: " in capsys.readouterr().out
    rdir = tmp_path / "r"
    assert cli.main(["replay", out, "--protocol", "fake", "--workers", "4",
                     "--object-size", str(MB), "--granule-bytes",
                     str(64 * 1024), "--serve-workers", "2", "--device",
                     "cpu", "--results-dir", str(rdir)]) == 0
    printed = capsys.readouterr().out
    assert "== replay vs original (s) ==" in printed
    (path,) = rdir.glob("replay_*.json")
    doc = json.loads(path.read_text())
    assert doc["extra"]["replay"]["config_match"]
    text = report_cmd.run_report([str(path)])
    assert text == jax_report.run_report([str(path)])
    assert "replay:s" in text


def test_replay_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gold = bundle.load_bundle(str(GOLDENS["chaos-serve-gold"]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_replay(_serve_cfg(), gold)


def _choices(usage: str) -> set:
    """The subcommand set of an argparse usage line ``{a,b,...}``."""
    start = usage.index("{")
    return set(usage[start + 1:usage.index("}", start)].split(","))


def test_parser_has_all_29_reference_subcommands(capsys):
    """The port's parser has all 29 of ``tpubench``'s subcommands (the
    last two, ``fleet`` and ``check``, included), and no other."""
    import tpubench.cli as jax_cli

    with pytest.raises(SystemExit):
        jax_cli.main(["--help"])
    theirs = _choices(capsys.readouterr().out)
    ours = _choices(cli.build_parser().format_usage())
    assert len(theirs) == 29 and ours == theirs
    assert {"fleet", "check"} <= ours
