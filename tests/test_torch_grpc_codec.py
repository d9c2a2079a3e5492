"""gRPC library mode on the port's own storage-v2 codec.

* Codec parity: every request and response message library mode sends
  or reads, generated by hypothesis (an empty and a 2 MiB ``content``,
  ``if_generation_match`` 0 and absent, the ``write_status`` oneof both
  ways), is encoded by ``grpc_wire/proto.py`` to the bytes the generated
  ``google.cloud._storage_v2`` types give, and each side decodes the
  other's bytes to the same fields.
* The card's installation: grpcio without ``google.cloud._storage_v2``
  and ``google.auth``, both blocked in ``sys.modules`` of a subprocess.
  ``read --protocol grpc`` (validate, pallas), write, resumable write, a
  paged list, stat and delete run in library mode over both fakes (the
  grpcio fake has no resumable sessions: that write runs over the wire
  fake).

Library-mode read parity with ``tpubench`` is
``test_torch_grpc_lib.py::test_library_read_parity``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from google.cloud._storage_v2 import types as s2
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.storage.grpc_wire import proto as wp

REPO = Path(__file__).resolve().parents[1]
TWO_MIB = deterministic_bytes("codec/content", 2 * 1024 * 1024).tobytes()
INT64 = st.integers(0, 2**63 - 1)
INT32 = st.integers(0, 2**31 - 1)
# The messages library mode sends (requests) and reads (responses).
REQUESTS = (wp.ReadObjectRequest, wp.GetObjectRequest, wp.ListObjectsRequest,
            wp.DeleteObjectRequest, wp.WriteObjectRequest,
            wp.StartResumableWriteRequest, wp.QueryWriteStatusRequest,
            wp.BidiWriteObjectRequest)
RESPONSES = (wp.ReadObjectResponse, wp.Object, wp.ListObjectsResponse,
             wp.WriteObjectResponse, wp.StartResumableWriteResponse,
             wp.QueryWriteStatusResponse, wp.BidiWriteObjectResponse)
# Oneofs among the declared fields (at most one member is set): the
# write requests' first_message, the write responses' write_status.
FIRST_MESSAGE = ("upload_id", "write_object_spec")
WRITE_STATUS = ("persisted_size", "resource")
ONEOF = {wp.WriteObjectRequest: FIRST_MESSAGE,
         wp.BidiWriteObjectRequest: FIRST_MESSAGE,
         wp.WriteObjectResponse: WRITE_STATUS,
         wp.QueryWriteStatusResponse: WRITE_STATUS,
         wp.BidiWriteObjectResponse: WRITE_STATUS}


def _field(attr: str, kind):
    if isinstance(kind, tuple):
        tag, cls = kind
        sub = _message(cls)
        return st.none() | sub if tag == "msg" else st.lists(sub, max_size=3)
    if kind == "bytes":
        return st.sampled_from((b"", TWO_MIB)) | st.binary(max_size=64)
    return {
        "str": st.text(max_size=16),
        "varint": INT32 if attr == "page_size" else INT64,
        "ovarint": st.none() | st.just(0) | INT64,
        "bool": st.booleans(),
        "fixed32": st.none() | st.integers(0, 2**32 - 1),
    }[kind]


def _message(cls):
    fields = {a: _field(a, k) for a, k in cls.FIELDS.values()}
    members = ONEOF.get(cls, ())
    rest = {a: v for a, v in fields.items() if a not in members}
    # One member of the oneof set (a persisted size of 0 included), or none.
    return st.one_of(st.builds(cls, **rest), *(
        st.builds(cls, **rest, **{a: fields[a].filter(
            lambda v: v is not None and v != "")})
        for a in members))


def _to_s2(m: "wp.Msg"):
    """The generated type's message with the fields ``m`` sets (proto-plus
    names the ``object`` field ``object_``). A field of implicit presence
    at its default is not set: the codec never encodes one, where a oneof
    member (``upload_id`` of ``first_message``) set to ``""`` would be."""
    kw = {}
    for attr, kind in m.FIELDS.values():
        v = getattr(m, attr)
        if v is None or (not isinstance(kind, tuple)
                         and kind in ("str", "bytes", "varint", "bool")
                         and not v):
            continue
        if isinstance(kind, tuple):
            v = _to_s2(v) if kind[0] == "msg" else [_to_s2(x) for x in v]
        kw["object_" if attr == "object" else attr] = v
    return getattr(s2, type(m).__name__)(**kw)


def _fields(m: "wp.Msg") -> dict:
    out = {}
    for attr, kind in m.FIELDS.values():
        v = getattr(m, attr)
        if isinstance(kind, tuple) and v is not None:
            v = _fields(v) if kind[0] == "msg" else [_fields(x) for x in v]
        out[attr] = v
    return out


@pytest.mark.parametrize("cls", REQUESTS + RESPONSES,
                         ids=lambda c: c.__name__)
@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(data=st.data())
def test_codec_matches_generated_types(cls, data):
    m = data.draw(_message(cls))
    ref = _to_s2(m)
    ref_bytes = type(ref).serialize(ref)
    assert m.encode() == ref_bytes
    assert _fields(cls.decode(ref_bytes)) == _fields(m)
    assert type(ref).deserialize(m.encode()) == ref


@pytest.mark.parametrize("case", ["generation_match_0", "generation_absent",
                                  "persisted_0", "resource", "content_2mib"])
def test_codec_named_cases(case):
    """The shapes library mode depends on, spelled out: explicit presence
    of ``if_generation_match=0`` and of a persisted size of 0, the oneof's
    ``resource`` decoding with no persisted size, and a 2 MiB message
    decoding with its content whole."""
    spec = lambda g: wp.WriteObjectSpec(  # noqa: E731
        resource=wp.Object(name="o", bucket="projects/_/buckets/b"),
        if_generation_match=g)
    if case == "generation_match_0":
        m = wp.BidiWriteObjectRequest(write_object_spec=spec(0))
        assert m.encode().endswith(b"\x18\x00")
    elif case == "generation_absent":
        m = wp.BidiWriteObjectRequest(write_object_spec=spec(None))
        assert b"\x18" not in m.encode()
    elif case == "persisted_0":
        m = wp.QueryWriteStatusResponse(persisted_size=0)
        assert m.encode() == b"\x08\x00"
    elif case == "resource":
        m = wp.BidiWriteObjectResponse(resource=wp.Object(name="o", size=5))
        assert wp.BidiWriteObjectResponse.decode(m.encode()).persisted_size \
            is None
    else:
        m = wp.ReadObjectResponse(
            checksummed_data=wp.ChecksummedData(content=TWO_MIB, crc32c=7),
            metadata=wp.Object(name="o", size=len(TWO_MIB)))
        got = wp.ReadObjectResponse.decode(m.encode())
        assert got.checksummed_data.content == TWO_MIB
        assert type(got.checksummed_data.content) is bytes
    ref = _to_s2(m)
    assert m.encode() == type(ref).serialize(ref)


# The card's installation: grpcio, and neither the storage-v2 types nor
# google-auth (a module set to None in sys.modules does not import).
_CARD = r'''
import json, sys
sys.modules["google.cloud._storage_v2"] = None
sys.modules["google.auth"] = None
from tpubench_torch.cli import main
from tpubench_torch.config import TransportConfig
from tpubench_torch.storage import gcs_grpc
from tpubench_torch.storage.base import StorageError, deterministic_bytes
from tpubench_torch.storage.fake import FakeBackend
from tpubench_torch.storage.fake_grpc_server import FakeGcsGrpcServer
from tpubench_torch.storage.fake_grpc_wire_server import FakeGrpcWireServer

modes = []
init = gcs_grpc.GcsGrpcBackend.__init__
def noting(self, *a, **k):
    init(self, *a, **k)
    modes.append(self._lib)
gcs_grpc.GcsGrpcBackend.__init__ = noting

SIZE, PART = 300_001, 64 * 1024
out = {}
for kind, cls in (("grpcio", FakeGcsGrpcServer), ("wire", FakeGrpcWireServer)):
    store = FakeBackend.prepopulated("tpubench/file_", 2, SIZE)
    srv = cls(store).start()
    got = out[kind] = {}
    try:
        for staging in (["--validate"], ["--staging", "pallas"]):
            rc = main(["read", "--protocol", "grpc", "--endpoint",
                       srv.endpoint, "--bucket", "testbucket", "--workers",
                       "2", "--read-call-per-worker", "1", "--object-size",
                       str(SIZE), "--granule-bytes", "65536", *staging,
                       "--device", "cpu", "--results-dir", sys.argv[1]])
            got[staging[-1]] = rc
        c = gcs_grpc.GcsGrpcBackend(
            "testbucket", TransportConfig(endpoint=srv.endpoint,
                                          directpath=False))
        data = deterministic_bytes("w/a", 3 * PART).tobytes()
        got["write"] = c.write("w/a", data).size
        if kind == "wire":
            w = c.open_write("w/b", if_generation_match=0)
            got["parts"] = [w.write(data[k * PART:(k + 1) * PART])
                            for k in range(3)]
            got["finalize"] = w.finalize().size
            got["committed"] = w.committed()
        r = c.open_read("w/a")
        buf, back = memoryview(bytearray(1 << 20)), bytearray()
        while (n := r.readinto(buf)) > 0:
            back += buf[:n]
        r.close()
        got["read_back"] = bytes(back) == data
        got["list"] = [m.name for m in c.list("", page_size=2)]
        got["stat"] = c.stat("tpubench/file_1").size
        c.delete("w/a")
        try:
            c.stat("w/a")
        except StorageError as e:
            got["stat_deleted"] = [e.code, e.transient]
        c.close()
    finally:
        srv.stop()
print(json.dumps({"modes": modes, "out": out, "loaded": sorted(
    m for m, v in sys.modules.items() if v is not None and m.startswith(
        ("google.cloud._storage_v2", "google.auth")))}))
'''


def test_library_mode_on_the_cards_installation(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _CARD, str(tmp_path)], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1])
    assert got["loaded"] == []
    # Two CLI reads and one client per server, every one library mode.
    assert got["modes"] == [True] * 6
    names = ["tpubench/file_0", "tpubench/file_1", "w/a"]
    part = 64 * 1024
    for kind in ("grpcio", "wire"):
        o = got["out"][kind]
        assert o["--validate"] == o["pallas"] == 0
        assert o["write"] == 3 * part and o["read_back"] is True
        assert sorted(o["list"]) == sorted(names + (["w/b"] if kind == "wire"
                                                    else []))
        assert o["stat"] == 300_001 and o["stat_deleted"] == [404, False]
    wire = got["out"]["wire"]
    assert wire["parts"] == [part, 2 * part, 3 * part]
    assert wire["finalize"] == wire["committed"] == 3 * part
    results = [json.loads(Path(line.removeprefix("result: ")).read_text())
               for line in lines if line.startswith("result: ")]
    assert len(results) == 4
    for res in results:
        assert res["errors"] == 0 and res["extra"]["checksum_ok"] is True
        assert res["extra"]["staged_bytes"] == 2 * 300_001
