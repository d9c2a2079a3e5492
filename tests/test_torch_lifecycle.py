"""The port's write side and checkpoint pair against ``tpubench``'s, on the
CPU.

* **Write side, every backend** (the in-process store, local files, the
  HTTP/1.1 server, the h2 server's HTTP/1.1 side, the gRPC wire server):
  one operation sequence through both packages — a media write, a 3-part
  resumable write hit by a mid-part reset, its finalize, a 412 on both
  write paths, a delete, a paged list — under the same seeded
  ``FaultPlan``. Outcomes (metadata, status codes, ``transient`` flags,
  ``resumed_parts``) and the stored bytes must be equal, exactly.
* **The resuming writer's edge cases**: a watermark that regressed below
  the part's start, the ``bytes */*`` probe, a 308 with no ``Range``.
* **Workloads**: save → restore through both packages (scorecards equal
  but for times and the shard count: ``tpubench`` lays an object over its
  8 simulated devices, a port rank holds one shard); a failed save
  publishes no manifest; a corrupted shard makes ``verified`` false at 1
  and 2 gloo ranks, while a clean checkpoint restores byte-identical at
  both; a checkpoint either package saved restores in the other;
  ``ckpt-save --protocol grpc`` through the CLI; ``report`` text equal to
  ``tpubench``'s; a staging failure raises; ``ckpt-restore`` without
  ``--device cpu`` and without CUDA raises before any work.

Small sizes (≤ 256 KiB objects, 64 KiB parts, retry backoff ≤ 10 ms). The
JAX package is imported inside the tests: the gloo ranks import this
module and need only torch.
"""

from __future__ import annotations

import json
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from tpubench_torch import cli
from tpubench_torch.config import BenchConfig, DistConfig, RetryConfig
from tpubench_torch.dist import bringup
from tpubench_torch.lifecycle.manifest import read_manifest, shard_object_name
from tpubench_torch.storage.base import StorageError, deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.workloads import ckpt

from test_torch_dist import run_ranks

PART = 64 * 1024
RESET = 100_000  # mid part 2 of a 3-part upload
OBJ = 200_003  # not a lane multiple: a short last shard
SEED = 11

pytestmark = pytest.mark.filterwarnings("ignore:.*directpath")


def _pkg(name: str):
    """The storage classes of ``tpubench`` or of the port."""
    import importlib

    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        config=mod("config"), fake=mod("storage.fake"),
        local=mod("storage.local_fs"), h1=mod("storage.fake_server"),
        h2=mod("storage.fake_h2_server"),
        grpcsrv=mod("storage.fake_grpc_wire_server"),
        http=mod("storage.gcs_http"), grpc=mod("storage.gcs_grpc"),
        retrying=mod("storage.retrying"), base=mod("storage.base"),
    )


def _stop(server) -> None:
    """Stop a fake server without waiting out a blocked ``accept``."""
    import socket

    sock = getattr(server, "_sock", None)
    if sock is not None:
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    server.stop()


def _read_all(backend, name: str) -> bytes:
    r = backend.open_read(name)
    out = bytearray()
    buf = memoryview(bytearray(1 << 16))
    try:
        while True:
            n = r.readinto(buf)
            if n <= 0:
                break
            out += buf[:n]
    finally:
        r.close()
    return bytes(out)


def _write_sequence(p, kind: str, tmp: Path) -> dict:
    """The operation sequence through package ``p`` on backend ``kind``;
    returns every outcome and the stored bytes."""
    store = p.fake.FakeBackend(
        fault=p.fake.FaultPlan(upload_reset_after_bytes=RESET, seed=SEED)
    )
    server = None
    if kind == "fake":
        client = store
    elif kind == "local":
        client = p.local.LocalFsBackend(str(tmp))
    else:
        cls = {"h1": p.h1.FakeGcsServer, "h2_h11": p.h2.FakeH2Server,
               "grpc": p.grpcsrv.FakeGrpcWireServer}[kind]
        server = cls(store).start()
        t = p.config.TransportConfig(endpoint=server.endpoint)
        client = (p.grpc.GcsGrpcBackend("b", transport=t) if kind == "grpc"
                  else p.http.GcsHttpBackend("b", transport=t))
    be = p.retrying.RetryingBackend(client, p.config.RetryConfig(
        initial_backoff_s=0.001, max_backoff_s=0.01, policy="idempotent",
        max_attempts=6, deadline_s=10.0,
    ))
    out: list = []

    def rec(label, fn):
        try:
            r = fn()
        except p.base.StorageError as e:
            out.append((label, "err", e.code, e.transient))
            return None
        out.append((label, "ok", tuple(r) if isinstance(r, list) else r))
        return r

    meta = lambda m: (m.name, m.size, m.generation)  # noqa: E731
    data_a = deterministic_bytes("w/a", 70_001).tobytes()
    data_b = deterministic_bytes("w/b", 3 * PART)
    try:
        rec("media", lambda: meta(be.write("w/a", data_a,
                                           if_generation_match=0)))
        w = be.open_write("w/b", if_generation_match=0)
        for k in range(3):
            rec(f"part{k}", lambda: w.write(data_b[k * PART:(k + 1) * PART]))
        rec("finalize", lambda: meta(w.finalize()))
        rec("resumed_parts", lambda: w.resumed_parts)
        rec("media_412", lambda: be.write("w/a", b"x", if_generation_match=0))
        w2 = be.open_write("w/b", if_generation_match=0)
        rec("part_412", lambda: w2.write(b"y" * 10))
        rec("finalize_412", lambda: w2.finalize())
        rec("list_all", lambda: [meta(m) for m in be.list(
            "w/", page_size=1)])
        rec("delete", lambda: be.delete("w/a"))
        listed = rec("list", lambda: [meta(m) for m in be.list(
            "w/", page_size=1)])
        stored = {n: _read_all(be, n) for n, _, _ in listed or ()}
    finally:
        be.close()
        if server is not None:
            _stop(server)
    return {"outcomes": out, "stored": stored,
            "grpc_lib": getattr(client, "_lib", None)}


# The outcomes where the port's repair of ROADMAP C.7 parts from
# ``tpubench``: the wire gRPC client follows ``next_page_token`` (the
# reference returns the first page), and the h2 fake's HTTP/1.1 side
# deletes (the reference answers 404, so ``w/a`` stays and is listed).
C7_DIFFS = {"h2_h11": {"delete", "list"}, "grpc": {"list_all"}}


@pytest.mark.parametrize(
    "kind", ["fake", "local", "h1", "h2_h11", "grpc", "grpc_lib"])
def test_write_side_matches_reference(kind, tmp_path, monkeypatch):
    import tpubench.storage.gcs_grpc as jax_gcs_grpc

    from tpubench_torch.storage import gcs_grpc

    # Both packages pick gRPC library mode when grpcio imports, and
    # tpubench's wire fake serves grpcio only its first call of a method
    # (ROADMAP C.11): the reference is held to wire mode here. The port's
    # switch is pinned with it in case grpc (wire client against wire
    # client) and left to choose in case grpc_lib (library mode over the
    # port's repaired wire fake).
    lib = kind == "grpc_lib"
    kind = "grpc" if lib else kind
    monkeypatch.setattr(jax_gcs_grpc, "_HAVE_LIB", False)
    monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", None if lib else False)
    ref = bounded(lambda: _write_sequence(_pkg("tpubench"), kind,
                                          tmp_path / "ref"))
    port = bounded(lambda: _write_sequence(_pkg("tpubench_torch"), kind,
                                           tmp_path / "port"))
    if kind == "grpc":
        assert port["grpc_lib"] is lib
    diffs = C7_DIFFS.get(kind, set())
    assert ([o for o in port["outcomes"] if o[0] not in diffs]
            == [o for o in ref["outcomes"] if o[0] not in diffs])
    outcomes = {o[0]: o for o in port["outcomes"]}
    ref_outcomes = {o[0]: o for o in ref["outcomes"]}
    both = (("w/a", 70_001, 1), ("w/b", 3 * PART, 1))
    if kind == "h2_h11":
        assert ref_outcomes["delete"][1:] == ("err", 404, False)
        assert outcomes["delete"] == ("delete", "ok", None)
        assert ref_outcomes["list"][2] == both
        assert outcomes["list"][2] == both[1:]
        assert "w/a" in ref["stored"] and "w/a" not in port["stored"]
    elif kind == "grpc":
        assert ref_outcomes["list_all"][2] == both[:1]
        assert outcomes["list_all"][2] == both
    else:
        assert port["stored"] == ref["stored"]
    assert port["stored"]["w/b"] == ref["stored"]["w/b"]
    want = deterministic_bytes("w/b", 3 * PART).tobytes()
    assert port["stored"]["w/b"] == want
    assert outcomes["list_all"][2] == both
    # The reset cost the upload one resumed part where the store injects
    # it, and the 412s were never retried (non-transient, both paths).
    assert outcomes["resumed_parts"][2] == (0 if kind == "local" else 1)
    assert outcomes["media_412"][1:] == ("err", 412, False)
    assert outcomes["finalize_412"][1:] == ("err", 412, False)


def bounded(fn, timeout_s: float = 30.0):
    """``fn()`` on a daemon thread, failing the test if it has not
    returned after ``timeout_s`` (a wire-fake hang must not hold a
    worker until the suite's limit)."""
    import threading

    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), f"timed out after {timeout_s} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def test_grpc_wire_list_follows_every_page():
    """C.7, first half: a listing larger than ``page_size`` comes back
    whole over the wire gRPC client, one RPC per page."""
    from tpubench_torch.config import TransportConfig
    from tpubench_torch.storage.fake_grpc_wire_server import (
        FakeGrpcWireServer,
    )
    from tpubench_torch.storage.gcs_grpc import GcsGrpcBackend

    store = FakeBackend.prepopulated("m/", 40, 100)
    server = FakeGrpcWireServer(store).start()
    client = GcsGrpcBackend(
        "b", transport=TransportConfig(endpoint=server.endpoint))
    try:
        names = bounded(lambda: [m.name for m in client.list(
            "m/", page_size=16)])
        unpaged = bounded(lambda: [m.name for m in client.list("m/")])
    finally:
        client.close()
        _stop(server)
    assert names == unpaged == [m.name for m in store.list("m/")]
    assert len(names) == 40


def test_h2_fake_deletes_on_its_http11_side():
    """C.7, second half: a delete over ``--http2`` against the h2 fake
    rides its HTTP/1.1 side and removes the object."""
    from tpubench_torch.config import TransportConfig
    from tpubench_torch.storage.fake_h2_server import FakeH2Server
    from tpubench_torch.storage.gcs_http import GcsHttpBackend

    store = FakeBackend.prepopulated("d/", 2, 1000)
    server = FakeH2Server(store).start()
    client = GcsHttpBackend("b", TransportConfig(
        endpoint=server.endpoint, http2=True))
    try:
        bounded(lambda: client.delete("d/0"))
        with pytest.raises(StorageError) as ei:
            bounded(lambda: client.stat("d/0"))
        assert ei.value.code == 404
        assert [m.name for m in bounded(lambda: client.list("d/"))] == [
            "d/1"]
    finally:
        client.close()
        _stop(server)


# ------------------------------------------------ resuming writer edges ----


class _ScriptedWriter:
    """An inner writer whose probe answers a scripted watermark."""

    def __init__(self, committed: int):
        self.offset = committed
        self.probe = committed
        self.fail_next = True

    def write(self, data) -> int:
        if self.fail_next:
            self.fail_next = False
            raise StorageError("reset", transient=True, code=104)
        self.offset += len(data)
        return self.offset

    def committed(self) -> int:
        self.offset = self.probe
        return self.offset

    def finalize(self):
        raise AssertionError("not reached")

    def abort(self) -> None:
        pass


class _ScriptedBackend:
    def __init__(self, inner):
        self.inner = inner

    def open_write(self, name, if_generation_match=None):
        return self.inner


def _fast_retry(**kw) -> RetryConfig:
    return RetryConfig(initial_backoff_s=0.001, max_backoff_s=0.01,
                       policy="idempotent", max_attempts=4, **kw)


def test_resuming_writer_refuses_a_regressed_watermark():
    """The server's watermark fell below this part's start: the missing
    bytes belong to an earlier part, so the resume must fail, not
    resend from the wrong offset."""
    from tpubench_torch.storage.retrying import RetryingBackend

    inner = _ScriptedWriter(committed=100)
    w = RetryingBackend(_ScriptedBackend(inner), _fast_retry()).open_write("x")
    inner.probe = 40  # after the reset the server holds only 40 bytes
    with pytest.raises(StorageError, match="regressed") as ei:
        w.write(b"z" * 50)
    assert not ei.value.transient


def test_resume_probe_and_a_308_without_range():
    """``committed()`` is the ``bytes */*`` probe; a 308 with no ``Range``
    means nothing is persisted (an empty session), and a part answered
    with less than it sent resumes from the probe."""
    from tpubench_torch.storage.fake_server import FakeGcsServer
    from tpubench_torch.storage.gcs_http import (
        GcsHttpBackend,
        _committed_from_range,
    )
    from tpubench_torch.storage.retrying import RetryingBackend

    assert _committed_from_range(None) == 0
    assert _committed_from_range("bytes=0-99") == 100
    assert _committed_from_range("bytes=5-9") == 0
    store = FakeBackend(fault=FaultPlan(upload_reset_after_bytes=150))
    with FakeGcsServer(store) as srv:
        cfg = BenchConfig()
        cfg.transport.endpoint = srv.endpoint
        rb = RetryingBackend(GcsHttpBackend("B", cfg.transport), _fast_retry())
        w = rb.open_write("p")
        assert w.committed() == 0  # 308 without Range
        w.write(b"a" * 100)
        assert w.committed() == 100
        w.write(b"b" * 100)  # the reset commits 50 of these first
        assert w.committed() == 200 and w.resumed_parts == 1
        assert w.finalize().size == 200
        assert _read_all(rb, "p") == b"a" * 100 + b"b" * 100


def test_crc32_combine_matches_zlib():
    rng = np.random.default_rng(SEED)
    for n1, n2 in ((0, 0), (1, 0), (0, 7), (128, 1), (5000, 70_001)):
        a = rng.integers(0, 256, n1, dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, n2, dtype=np.uint8).tobytes()
        assert ckpt.crc32_combine(
            zlib.crc32(a), zlib.crc32(b), len(b)
        ) == zlib.crc32(a + b)


# ------------------------------------------------------------ workloads ----


def _cfg(p_config, **lifecycle):
    cfg = p_config.BenchConfig()
    cfg.transport.protocol = "fake"
    cfg.transport.retry.initial_backoff_s = 0.001
    cfg.transport.retry.max_backoff_s = 0.01
    cfg.transport.retry.max_attempts = 6
    cfg.obs.flight_records = 0
    lc = cfg.lifecycle
    lc.objects, lc.object_bytes, lc.part_bytes = 3, OBJ, PART
    lc.writers, lc.readers = 2, 2
    for k, v in lifecycle.items():
        setattr(lc, k, v)
    return cfg


def _one_rank():
    return bringup.session(DistConfig(), "cpu", one_rank_group=True)


TIME_KEYS = {"goodput_gbps", "part_latency", "time_to_restore_s",
             "fetch_seconds", "stage_seconds"}


class _Staged:
    """Keeps every ``StagedShards`` a restore makes, by wrapping
    ``dist.reassemble.shard_to_device_array`` (``ckpt`` looks it up at
    each call); what it stages is unchanged."""

    def __init__(self):
        from tpubench_torch.dist import reassemble

        self.mod, self.real, self.made = reassemble, None, []

    def __enter__(self):
        self.real = self.mod.shard_to_device_array

        def kept(*a, **kw):
            st = self.real(*a, **kw)
            self.made.append(st)
            return st

        self.mod.shard_to_device_array = kept
        return self

    def __exit__(self, *exc):
        self.mod.shard_to_device_array = self.real

    def by_object(self, names: list, size: int, rank: int = 0,
                  world: int = 1) -> dict:
        """``name -> (shard start, shard length, staged bytes)``, in the
        manifest's order."""
        from tpubench_torch.dist.shard import ShardTable

        out = {}
        for name, st in zip(names, self.made):
            sh = ShardTable.build(size, world, align=128).shard(rank)
            got = st.ready().reshape(-1)[:sh.length].numpy().copy()
            out[name] = (sh.start, sh.length, got)
        return out


def _names(n: int, prefix: str = "ckpt/") -> list:
    return [shard_object_name(prefix, i) for i in range(n)]


def _restore_collect(cfg, store):
    """The port's restore at one rank, with every staged shard's bytes."""
    with _Staged() as seen, _one_rank():
        res = ckpt.run_ckpt_restore(cfg, backend=store, device="cpu")
    n = cfg.lifecycle.objects
    return res, seen.by_object(_names(n, cfg.lifecycle.prefix), OBJ)


def test_save_restore_parity_and_report(jax_cpu_devices, tmp_path):
    import tpubench.config as jcfg
    from tpubench.metrics.report import write_result as jax_write_result
    from tpubench.storage.fake import FakeBackend as JaxFakeBackend
    from tpubench.storage.fake import FaultPlan as JaxFaultPlan
    from tpubench.workloads import ckpt as jax_ckpt
    from tpubench.workloads import report_cmd as jax_report

    from tpubench_torch import config as tcfg
    from tpubench_torch.metrics.report import write_result
    from tpubench_torch.workloads import report_cmd

    jstore = JaxFakeBackend(fault=JaxFaultPlan(
        upload_reset_after_bytes=RESET, seed=SEED))
    tstore = FakeBackend(fault=FaultPlan(
        upload_reset_after_bytes=RESET, seed=SEED))
    from tpubench.storage.retrying import RetryingBackend as JaxRetrying

    from tpubench_torch.storage.retrying import RetryingBackend

    jc, tc = _cfg(jcfg), _cfg(tcfg)
    jsave = jax_ckpt.run_ckpt_save(
        jc, backend=JaxRetrying(jstore, jc.transport.retry))
    tsave = ckpt.run_ckpt_save(
        tc, backend=RetryingBackend(tstore, tc.transport.retry))
    strip = lambda lc: {k: v for k, v in lc.items()  # noqa: E731
                        if k not in TIME_KEYS}
    assert strip(tsave.extra["lifecycle"]) == strip(jsave.extra["lifecycle"])
    lc = tsave.extra["lifecycle"]
    assert lc["resumed_parts"] == 3 and lc["corrupt_finalizes"] == 0
    assert lc["parts"] == 3 * 4 and lc["verified"] and tsave.errors == 0
    def meta(ms):
        return [(m.name, m.size, m.generation) for m in ms]

    assert meta(tstore.list()) == meta(jstore.list())
    for m in tstore.list():
        assert _read_all(tstore, m.name) == _read_all(jstore, m.name)

    jres = jax_ckpt.run_ckpt_restore(_cfg(jcfg), backend=jstore)
    tres, staged = _restore_collect(_cfg(tcfg), tstore)
    jl, tl = jres.extra["lifecycle"], tres.extra["lifecycle"]
    # Known difference: tpubench lays an object over its 8 simulated
    # devices, a port rank holds one shard.
    assert (jl["shards_per_object"], tl["shards_per_object"]) == (8, 1)
    assert {k: v for k, v in strip(tl).items() if k != "shards_per_object"} \
        == {k: v for k, v in strip(jl).items() if k != "shards_per_object"}
    assert tl["verified"] is True and tl["staged"] is True
    assert tres.errors == jres.errors == 0
    assert len(staged) == 3
    for name, (start, length, got) in staged.items():
        assert (start, length) == (0, OBJ)
        assert np.array_equal(got, deterministic_bytes(name, OBJ))

    paths = [write_result(tsave, str(tmp_path), tag="save"),
             write_result(tres, str(tmp_path), tag="restore")]
    for path in paths:
        assert report_cmd.run_report([path]) == jax_report.run_report([path])
    both = report_cmd.run_report(paths)
    assert both == jax_report.run_report(paths)
    assert "lifecycle [save]" in both and "lifecycle [restore]" in both
    jpath = jax_write_result(jsave, str(tmp_path / "ref"), tag="save")
    assert report_cmd.run_report([jpath]) == jax_report.run_report([jpath])


def test_failed_save_publishes_no_manifest():
    """Every part append fails: the save reports its errors and publishes
    no manifest, in both packages."""
    import tpubench.config as jcfg
    from tpubench.storage.fake import FakeBackend as JaxFakeBackend
    from tpubench.storage.fake import FaultPlan as JaxFaultPlan
    from tpubench.workloads import ckpt as jax_ckpt

    from tpubench_torch import config as tcfg

    out = []
    from tpubench.storage.retrying import RetryingBackend as JaxRetrying

    from tpubench_torch.storage.retrying import RetryingBackend

    for p_cfg, store, retrying, run in (
        (jcfg, JaxFakeBackend(fault=JaxFaultPlan(upload_error_rate=1.0)),
         JaxRetrying, jax_ckpt.run_ckpt_save),
        (tcfg, FakeBackend(fault=FaultPlan(upload_error_rate=1.0)),
         RetryingBackend, ckpt.run_ckpt_save),
    ):
        cfg = _cfg(p_cfg)
        cfg.workload.abort_on_error = False
        cfg.transport.retry.max_attempts = 2
        res = run(cfg, backend=retrying(store, cfg.transport.retry))
        out.append((res.errors, res.extra["lifecycle"]["worker_errors"],
                    [m.name for m in store.list()]))
    assert out[0] == out[1]
    errors, worker_errors, names = out[1]
    assert errors == worker_errors == 2 and names == []


def _corrupt(store, name: str, offset: int) -> None:
    arr = store._objects[name]
    arr[offset] ^= 0xFF


def test_corrupted_shard_fails_verification_at_one_rank():
    store = FakeBackend()
    ckpt.run_ckpt_save(_cfg_port(), backend=store)
    _corrupt(store, shard_object_name("ckpt/", 1), OBJ - 5)
    res, _ = _restore_collect(_cfg_port(), store)
    lc = res.extra["lifecycle"]
    assert lc["verified"] is False and res.errors == 1
    assert lc["staged"] is True  # the bytes landed; they are wrong


def _cfg_port(**lifecycle):
    from tpubench_torch import config as tcfg

    return _cfg(tcfg, **lifecycle)


def _two_rank_restore(rank: int, world: int) -> dict:
    """Per rank: its own store with the same checkpoint, restored clean
    and then with one byte of rank 1's shard of object 2 flipped."""
    cfg = _cfg_port()
    store = FakeBackend()
    ckpt.run_ckpt_save(cfg, backend=store)
    out = {}
    for case in ("clean", "corrupt"):
        if case == "corrupt":
            _corrupt(store, shard_object_name("ckpt/", 2), OBJ - 3)
        with _Staged() as seen:
            res = ckpt.run_ckpt_restore(cfg, backend=store, device="cpu")
        out[case] = {"lifecycle": res.extra["lifecycle"],
                     "errors": res.errors, "n_chips": res.n_chips,
                     "staged": seen.by_object(_names(3), OBJ, rank, world)}
    return out


def test_two_rank_restore_byte_identical_and_corruption_seen_everywhere():
    ranks = run_ranks(_two_rank_restore, 2, timeout=90)
    for rank, out in enumerate(ranks):
        clean, bad = out["clean"], out["corrupt"]
        assert clean["lifecycle"]["verified"] is True and clean["errors"] == 0
        assert clean["lifecycle"]["shards_per_object"] == 2
        assert clean["n_chips"] == 2
        for name, (start, length, got) in clean["staged"].items():
            want = deterministic_bytes(name, OBJ)[start:start + length]
            assert np.array_equal(got, want), (rank, name)
        # The flipped byte lies in rank 1's shard; both ranks see it.
        assert bad["lifecycle"]["verified"] is False
        assert bad["errors"] >= 1
    assert sum(len(out["clean"]["staged"]) for out in ranks) == 6


def test_checkpoints_cross_between_packages(jax_cpu_devices, tmp_path):
    """A checkpoint ``tpubench`` saved into a directory restores with the
    port, byte for byte, and one the port saved restores in
    ``tpubench``."""
    import tpubench.config as jcfg
    from tpubench.storage.local_fs import LocalFsBackend as JaxLocal
    from tpubench.workloads import ckpt as jax_ckpt

    from tpubench_torch.storage.local_fs import LocalFsBackend

    from tpubench_torch import convert

    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jc = _cfg(jcfg, prefix="run7/", objects=2)
    assert jax_ckpt.run_ckpt_save(
        jc, backend=JaxLocal(str(ref_dir))).errors == 0
    # The reference's config carries its lifecycle section across whole.
    cfg, _ = convert.from_reference(jc.to_dict(), [])
    assert cfg.to_dict()["lifecycle"] == jc.to_dict()["lifecycle"]
    manifest = read_manifest(LocalFsBackend(str(ref_dir)), "run7/")
    assert [o.name for o in manifest.objects] == [
        "run7/shard_00000", "run7/shard_00001"]
    res, staged = _restore_collect(cfg, LocalFsBackend(str(ref_dir)))
    assert res.extra["lifecycle"]["verified"] is True and res.errors == 0
    assert len(staged) == 2
    for name, (_, _, got) in staged.items():
        assert np.array_equal(got, deterministic_bytes(name, OBJ))
    assert ckpt.run_ckpt_save(
        cfg, backend=LocalFsBackend(str(port_dir))).errors == 0
    jres = jax_ckpt.run_ckpt_restore(
        _cfg(jcfg, prefix="run7/", objects=2, restore_device=False),
        backend=JaxLocal(str(port_dir)))
    assert jres.extra["lifecycle"]["verified"] is True and jres.errors == 0
    assert sorted(p.name for p in port_dir.rglob("*")) == \
        sorted(p.name for p in ref_dir.rglob("*"))


def test_ckpt_save_over_grpc_through_the_cli(tmp_path, capsys, monkeypatch):
    """``ckpt-save --protocol grpc`` with no endpoint runs against the
    port's gRPC wire fake (StartResumableWrite → BidiWriteObject →
    QueryWriteStatus), with the config's upload reset on the wire: in
    wire mode (pinned, as where grpcio does not import) each session
    resumes the one part its reset broke; in library mode, the CLI's own
    choice where grpcio imports, both writers share one connection, so a
    reset can break the other writer's part too (ROADMAP's known
    differences)."""
    from tpubench_torch.storage import gcs_grpc

    conf = tmp_path / "c.json"
    conf.write_text(json.dumps({"transport": {
        "fault": {"upload_reset_after_bytes": RESET, "seed": SEED},
        "retry": {"initial_backoff_s": 0.001, "max_backoff_s": 0.01,
                  "max_attempts": 6},
    }}))
    for have_lib in (False, None):
        monkeypatch.setattr(gcs_grpc, "_HAVE_LIB", have_lib)
        rc = cli.main([
            "ckpt-save", "--config", str(conf), "--protocol", "grpc",
            "--ckpt-objects", "2", "--ckpt-object-bytes", str(OBJ),
            "--ckpt-part-bytes", str(PART), "--ckpt-writers", "2",
            "--results-dir", str(tmp_path / f"r{have_lib}"),
        ])
        assert rc == 0
        path = capsys.readouterr().out.strip().splitlines()[-1]
        res = json.loads(Path(path.removeprefix("result: ")).read_text())
        lc = res["extra"]["lifecycle"]
        assert lc["verified"] is True and lc["corrupt_finalizes"] == 0
        assert lc["parts"] == 2 * 4 and res["errors"] == 0
        if have_lib is False:
            assert lc["resumed_parts"] == 2
        else:
            assert 2 <= lc["resumed_parts"] <= lc["parts"]


def test_staging_failure_raises(monkeypatch):
    """A failed copy onto the device raises; nothing falls back to a
    host-RAM restore."""
    from tpubench_torch.dist import reassemble

    store = FakeBackend()
    ckpt.run_ckpt_save(_cfg_port(), backend=store)

    def broken(*a, **kw):
        raise RuntimeError("injected copy failure")

    monkeypatch.setattr(reassemble, "shard_to_device_array", broken)
    with _one_rank(), pytest.raises(RuntimeError, match="injected copy"):
        ckpt.run_ckpt_restore(_cfg_port(), backend=store, device="cpu")
    res = ckpt.run_ckpt_restore(_cfg_port(restore_device=False),
                                backend=store)
    assert res.extra["lifecycle"]["staged"] is False
    assert res.extra["lifecycle"]["verified"] is True


def test_ckpt_restore_without_cuda_or_device_cpu_raises(tmp_path,
                                                        monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["ckpt-restore", "--protocol", "local", "--dir",
                  str(tmp_path), "--results-dir", str(tmp_path / "r")])
    assert not (tmp_path / "r").exists() and not dist.is_initialized()
