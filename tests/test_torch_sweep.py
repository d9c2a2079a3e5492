"""``sweep`` of the port against ``tpubench``'s: the counterparts of
``tests/test_cli.py``'s ``test_cli_sweep_fake``, ``test_cli_sweep_native_ab``
and ``test_cli_sweep_http1_vs_http2``, run through both CLIs
(``tpubench`` on 8 simulated JAX CPU devices, the port with ``--device
cpu``) against the same servers: the same rows (protocol, size, receive
path), and per cell the same bytes, staged bytes, ``checksum_ok`` and
``extra.sweep``; then ``report`` over the port's rows prints
``tpubench``'s text. Times (GB/s, p50/p99) are compared by key only."""

import json

import pytest
import torch

from tpubench.cli import main as jax_main

from tpubench_torch import cli
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_h2_server import FakeH2Server
from tpubench_torch.storage.fake_server import FakeGcsServer

PREFIX = "bench/file_"


@pytest.fixture(autouse=True)
def _devices(jax_cpu_devices):
    pass


def _sweep(main, argv, out_dir, capsys) -> list:
    rc = main([*argv, "--results-dir", str(out_dir)])
    assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    for r in rows:
        with open(r.pop("result")) as f:
            r["doc"] = json.load(f)
    return rows


def _both(argv, tmp_path, capsys):
    ref = _sweep(jax_main, argv, tmp_path / "ref", capsys)
    port = _sweep(cli.main, [*argv, "--device", "cpu"], tmp_path / "port",
                  capsys)
    return ref, port


def _same_rows(ref, port):
    assert len(port) == len(ref)
    for r, p in zip(ref, port):
        assert set(p) == set(r)
        for k in ("protocol", "size", "native_receive"):
            assert p.get(k) == r.get(k)
        assert p["gbps"] > 0
        rd, pd = r["doc"], p["doc"]
        assert pd["bytes_total"] == rd["bytes_total"]
        assert pd["errors"] == rd["errors"] == 0
        for k in ("sweep", "staged_bytes", "checksum_ok"):
            assert pd["extra"].get(k) == rd["extra"].get(k), k
        assert pd["extra"]["checksum_ok"] is True
        assert set(pd["extra"]) == set(rd["extra"])


@pytest.mark.parametrize("staging", [["--staging", "pallas"],
                                     ["--staging", "device_put", "--validate"]])
def test_cli_sweep_fake(tmp_path, capsys, staging):
    ref, port = _both(
        ["sweep", "--protocol", "fake", "--sweep-protocols", "fake",
         "--sweep-sizes", "256kb,1mb", "--workers", "2",
         "--read-call-per-worker", "2", *staging], tmp_path, capsys)
    _same_rows(ref, port)
    assert [(p["protocol"], p["size"]) for p in port] == [
        ("fake", "256kb"), ("fake", "1mb")]
    # Each cell: 2 workers x min(2, the size's read count) reads.
    assert [p["doc"]["bytes_total"] for p in port] == [
        2 * 2 * 256 * 1024, 2 * 2 * 1024 * 1024]


def _store():
    be = FakeBackend()
    for i in range(2):  # sweep prepares nothing: the objects it reads
        name = f"{PREFIX}{i}"
        be._objects[name] = deterministic_bytes(name, 256 * 1024)
        be._generation[name] = 1
    return be


def _server_argv(endpoint):
    return ["sweep", "--protocol", "http", "--endpoint", endpoint,
            "--bucket", "testbucket", "--object-name-prefix", PREFIX,
            "--sweep-sizes", "256kb", "--workers", "2",
            "--read-call-per-worker", "2", "--validate"]


def test_cli_sweep_native_ab(tmp_path, capsys):
    """``--sweep-native``: each http cell with the Python client and with
    the engine's native receive, against one live server."""
    with FakeGcsServer(_store()) as srv:
        ref, port = _both([*_server_argv(srv.endpoint), "--sweep-protocols",
                           "http", "--sweep-native"], tmp_path, capsys)
    _same_rows(ref, port)
    assert [p.get("native_receive") for p in port] == [False, True]
    assert port[1]["doc"]["extra"]["sweep"] == {
        "protocol": "http", "size": "256kb", "native_receive": True}


def test_cli_sweep_http1_vs_http2(tmp_path, capsys):
    """The h1-vs-h2 A/B (the reference's ForceAttemptHTTP2 branch,
    main.go:76-80) against one dual-protocol server."""
    with FakeH2Server(_store()) as srv:
        ref, port = _both([*_server_argv(srv.endpoint), "--sweep-protocols",
                           "http,http2"], tmp_path, capsys)
    _same_rows(ref, port)
    assert [p["protocol"] for p in port] == ["http", "http2"]
    assert port[1]["doc"]["config"]["transport"]["http2"] is True


def test_report_sweep_table_equals_reference(tmp_path, capsys):
    """``report`` over a sweep's rows: the port prints ``tpubench``'s
    text, character for character."""
    rc = cli.main(["sweep", "--protocol", "fake", "--sweep-protocols", "fake",
                   "--sweep-sizes", "256kb", "--workers", "1",
                   "--read-call-per-worker", "1", "--staging", "none",
                   "--device", "cpu", "--results-dir", str(tmp_path)])
    assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    rows.append({"protocol": "grpc", "size": "1mb", "gbps": 1.4,
                 "p50_ms": 7.0, "p99_ms": 15.0, "native_receive": True})
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(rows))
    texts = []
    for main in (jax_main, cli.main):
        assert main(["report", str(path)]) == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1]
    assert "sweep:" in texts[1] and "grpc/native" in texts[1]


def test_sweep_native_fails_at_start_without_the_engine(tmp_path,
                                                        monkeypatch):
    """``--sweep-native`` needs the engine: a failed build fails the
    command before any cell runs (no result written)."""
    from tpubench_torch.native import engine

    def broken():
        raise RuntimeError("engine build failed")

    monkeypatch.setattr(engine, "get_engine", broken)
    with pytest.raises(RuntimeError, match="engine build failed"):
        cli.main(["sweep", "--protocol", "fake", "--sweep-protocols", "http",
                  "--sweep-native", "--device", "cpu",
                  "--results-dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def test_sweep_refuses_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["sweep", "--protocol", "fake", "--sweep-protocols", "fake",
                  "--sweep-sizes", "256kb", "--workers", "1",
                  "--results-dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists()


def test_sweep_uploads_each_cell_to_a_bucket(tmp_path, capsys):
    """``sweep --results-bucket B`` uploads every cell's result file as
    ``results/<file>`` (the per-cell upload of ``tpubench sweep``): the
    stored objects equal the files byte for byte."""
    store = _store()
    with FakeGcsServer(store) as srv:
        rc = cli.main([*_server_argv(srv.endpoint), "--sweep-protocols",
                       "http", "--sweep-native", "--results-bucket", "B",
                       "--device", "cpu", "--results-dir", str(tmp_path)])
        assert rc == 0
    rows = json.loads(capsys.readouterr().out)
    assert len(rows) == 2
    for row in rows:
        name = f"results/{row['result'].rsplit('/', 1)[-1]}"
        with open(row["result"], "rb") as f:
            assert store._objects[name].tobytes() == f.read()