"""The port's command line against ``tpubench``'s: the same flags on every
subcommand, the same config from the same argv.

* every option string of ``tpubench``'s parser, on each of the 29
  subcommands, parses in the port's (with a value of the reference
  option's kind), and the port's options beyond them are exactly its own
  extras (``--depth``, ``--device``, ``--granule-bytes``, ``--key-file``,
  ``--slot-bytes``; ``multichip-sweep``'s ``--device`` and
  ``--results-dir``);
* a corpus of argvs (each of the nine common flags the port lacked, each
  preset, ``--preset`` with ``--config``, a bad ``--profile-steps``)
  gives the same ``to_json()`` dict, or the same ``SystemExit``, in both
  packages' ``build_config``;
* a ``--save-config`` file of either package loads in the other's
  ``BenchConfig.from_json`` to the same dict;
* ``read`` over the fake store with every read failing
  (``--fault-read-error-rate 1.0 --retry-max-attempts 1``) exits as
  ``tpubench``'s does, with the same errors and completed reads, with
  and without ``--no-abort-on-error``; ``--retry-deadline`` ends a run
  whose every open fails, in both.

``tpubench`` builds its parser inside ``main``; the fixture takes it
from there by stopping ``parse_args``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import pytest

from tpubench_torch import cli
from tpubench_torch.config import PRESET_NAMES, preset

PORT_EXTRAS = {"--depth", "--device", "--granule-bytes", "--key-file",
               "--slot-bytes"}
SWEEP_EXTRAS = {"--device", "--results-dir"}
# Positionals a subcommand needs before its options parse.
POSITIONALS = {"report": ["r.json"], "top": ["j.json"],
               "record": ["j.json", "--out", "b.json"],
               "replay": ["b.json"], "check": []}


class _Stop(Exception):
    pass


def _reference_parser() -> argparse.ArgumentParser:
    """The parser ``tpubench.cli.main`` builds, stopped at ``parse_args``."""
    from tpubench import cli as ref

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    argparse.ArgumentParser.parse_args = stop
    try:
        ref.main(["read"])
    except _Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen["parser"]


@pytest.fixture(scope="module")
def ref_parser():
    return _reference_parser()


def _subparsers(parser) -> dict:
    (sub,) = [a for a in parser._actions
              if isinstance(a, argparse._SubParsersAction)]
    return dict(sub.choices)


def _options(p) -> dict:
    return {s: a for a in p._actions for s in a.option_strings}


def _value(action) -> list:
    """An argument list for ``action`` of the reference parser."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(list(action.choices)[0])]
    if action.type in (int, float):
        return ["1"]
    return ["x"]


def test_every_subcommand_is_in_both(ref_parser):
    ref, port = _subparsers(ref_parser), _subparsers(cli.build_parser())
    assert len(ref) == 29
    assert sorted(port) == sorted(ref)


@pytest.mark.parametrize("cmd", sorted(
    ["info", "read", "train-ingest", "pod-ingest", "stream", "gather-bench",
     "multichip-sweep", "probe", "tune", "read-fs", "write", "list", "open",
     "ssd", "ckpt-save", "ckpt-restore", "meta-storm", "chaos", "serve",
     "drill", "fleet", "replay", "record", "prepare", "sweep", "preflight",
     "top", "report", "check"]))
def test_every_reference_option_parses_in_the_port(cmd, ref_parser):
    ref_sub = _subparsers(ref_parser)[cmd]
    parser = cli.build_parser()
    port_sub = _subparsers(parser)[cmd]
    ref_opts, port_opts = _options(ref_sub), _options(port_sub)
    extras = set(port_opts) - set(ref_opts)
    if cmd == "multichip-sweep":
        assert extras == SWEEP_EXTRAS
    elif "--config" in ref_opts:  # the subcommands with the common flags
        assert extras == PORT_EXTRAS
    else:
        assert extras == set()
    head = [cmd, *POSITIONALS.get(cmd, [])]
    for opt, action in sorted(ref_opts.items()):
        if opt in ("-h", "--help") or (cmd == "record" and opt == "--out"):
            continue
        args = parser.parse_args([*head, opt, *_value(action)])
        assert args.cmd == cmd, opt


# --------------------------------------------------------- the config --
CORPUS = {
    **{f"preset_{name}": ["read", "--preset", name] for name in PRESET_NAMES},
    "project": ["read", "--project", "my-project"],
    "staging_drain": ["read", "--staging-drain", "thread"],
    "profile_steps": ["train-ingest", "--profile-steps", "2:5"],
    "no_abort_on_error": ["read", "--no-abort-on-error"],
    "retry_deadline": ["read", "--retry-deadline", "2.5"],
    "retry_max_attempts": ["read", "--retry-max-attempts", "3"],
    "ring": ["pod-ingest", "--ring"],
    "ring_elsewhere": ["read", "--ring"],
    "save_config": ["read", "--save-config", "unused.json"],
    "preset_and_flags": ["read", "--preset", "1gb", "--workers", "8",
                         "--retry-deadline", "1", "--no-abort-on-error",
                         "--project", "p"],
    "info": ["info", "--preset", "smoke", "--retry-max-attempts", "2"],
    "fleet": ["fleet", "--preset", "100mb", "--fleet-hosts", "64"],
    "chaos": ["chaos", "--preset", "smoke", "--ring",
              "--staging-drain", "inline"],
    "bad_profile_steps": ["train-ingest", "--profile-steps", "5:2"],
    "malformed_profile_steps": ["train-ingest", "--profile-steps", "abc"],
}


def _ref_build(argv: list):
    from tpubench import cli as ref

    return ref.build_config(_reference_parser().parse_args(argv))


def _both(argv: list):
    """Each package's ``build_config(argv)``: the dict, or the
    ``SystemExit`` message."""
    out = []
    for build in (_ref_build,
                  lambda a: cli.build_config(cli.build_parser().parse_args(a))):
        try:
            out.append(build(argv).to_dict())
        except SystemExit as e:
            out.append(("SystemExit", str(e)))
    return out


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_build_config_matches_the_reference(case, monkeypatch):
    for var in ("TPUBENCH_NUM_PROCESSES", "TPUBENCH_PROCESS_ID",
                "TPUBENCH_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    ref, port = _both(CORPUS[case])
    assert port == ref
    if case.endswith("profile_steps") and case != "profile_steps":
        assert port[0] == "SystemExit"


def test_preset_and_config_are_mutually_exclusive(tmp_path):
    conf = tmp_path / "c.json"
    conf.write_text(preset("1mb").to_json())
    ref, port = _both(["read", "--preset", "smoke", "--config", str(conf)])
    assert port == ref == ("SystemExit",
                           "--preset and --config are mutually exclusive")


def test_presets_match_and_refuse_an_unknown_name():
    from tpubench import config as ref_config

    assert PRESET_NAMES == ref_config.PRESET_NAMES
    for name in PRESET_NAMES:
        assert preset(name).to_dict() == ref_config.preset(name).to_dict()
    assert preset("SMOKE").to_dict() == ref_config.preset("SMOKE").to_dict()
    for make in (preset, ref_config.preset):
        with pytest.raises(KeyError, match="unknown preset 'huge'"):
            make("huge")


def test_save_config_files_load_across_the_packages(tmp_path, capsys):
    from tpubench import cli as ref
    from tpubench.config import BenchConfig as RefConfig
    from tpubench_torch.config import BenchConfig

    port_file, ref_file = tmp_path / "port.json", tmp_path / "ref.json"
    common = ["--preset", "100mb", "--retry-deadline", "3", "--project", "p",
              "--no-abort-on-error", "--staging-drain", "thread"]
    assert cli.main(["read", *common, "--save-config", str(port_file)]) == 0
    assert ref.main(["read", *common, "--save-config", str(ref_file)]) == 0
    assert "config written" in capsys.readouterr().out
    port_text, ref_text = port_file.read_text(), ref_file.read_text()
    assert json.loads(port_text) == json.loads(ref_text)
    assert RefConfig.from_json(port_text).to_dict() == json.loads(port_text)
    assert BenchConfig.from_json(ref_text).to_dict() == json.loads(ref_text)
    # And the port's --config reads the reference's file.
    loaded = cli.build_config(cli.build_parser().parse_args(
        ["read", "--config", str(ref_file)]))
    assert loaded.to_dict() == json.loads(ref_text)


def test_info_takes_the_common_flags(capsys):
    assert cli.main(["info", "--preset", "smoke", "--workers", "3"]) == 0
    out = capsys.readouterr()
    cfg = json.loads(out.out)
    assert cfg["workload"]["workers"] == 3
    assert cfg["transport"]["protocol"] == "fake"
    assert out.err.startswith("devices: ")


# ------------------------------------------------------- fault runs --
FAULT_ARGV = ["read", "--protocol", "fake", "--workers", "2",
              "--read-call-per-worker", "2", "--object-size", "100000",
              "--fault-read-error-rate", "1.0", "--retry-max-attempts", "1"]
# What the errgroup raises for FAULT_ARGV: the first failed worker's
# injected read fault.
FAULT_ABORT_ERROR = ("WorkerError: StorageError('injected mid-stream "
                     "failure')")


def _run(main, argv: list, results: str, worker_error) -> dict:
    """``main(argv)`` as the command line would end: its exit code (1 for
    the errgroup's failure, ``worker_error``, which the interpreter does
    not catch: its type and the worker's error under ``error``; anything
    else raised fails the test), and the result it wrote, if any."""
    t0 = time.monotonic()
    out = {}
    try:
        rc = main([*argv, "--results-dir", results])
    except SystemExit as e:
        rc = e.code
    except worker_error as e:
        rc = 1
        out["error"] = f"{type(e).__name__}: {e.cause!r}"
    out.update(rc=rc, seconds=time.monotonic() - t0)
    paths = glob.glob(os.path.join(results, "read_*.json"))
    if paths:
        (path,) = paths
        with open(path) as f:
            res = json.load(f)
        read = res["summaries"].get("read") or {}
        out.update(errors=res["errors"], bytes=res["bytes_total"],
                   reads=read.get("count", 0))
    return out


@pytest.mark.parametrize("abort", [True, False], ids=["abort", "no_abort"])
def test_fault_run_matches_the_reference(abort, tmp_path):
    from tpubench import cli as ref
    from tpubench.workloads.common import WorkerError as RefWorkerError

    from tpubench_torch.workloads.common import WorkerError

    argv = FAULT_ARGV + ([] if abort else ["--no-abort-on-error"])
    want = _run(ref.main, argv, str(tmp_path / "ref"), RefWorkerError)
    got = _run(cli.main, [*argv, "--device", "cpu"], str(tmp_path / "port"),
               WorkerError)
    for r in (want, got):
        r.pop("seconds")
    assert got == want
    if abort:  # errgroup: the first failure ends the command
        assert got == {"rc": 1, "error": FAULT_ABORT_ERROR}
    else:  # failure domains: every worker fails alone, the run reports
        assert got == {"rc": 0, "errors": 2, "bytes": 0, "reads": 0}


def test_retry_deadline_bounds_the_run_in_both(tmp_path):
    """Every open fails with a transient 503, which the reference's
    policy retries for ever: ``--retry-deadline`` ends each worker's
    retries, and the run reports its failed workers."""
    from tpubench import cli as ref

    argv = ["read", "--protocol", "fake", "--workers", "2",
            "--read-call-per-worker", "2", "--object-size", "100000",
            "--fault-error-rate", "1.0", "--retry-deadline", "0.5",
            "--no-abort-on-error"]
    for name, main, extra in (("ref", ref.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        got = _run(main, [*argv, *extra], str(tmp_path / name), ())
        assert got["rc"] == 0 and got["errors"] == 2, name
        assert got["seconds"] < 30, name
