"""The port's stagers and transfer window against the JAX package's.

Stagers: the same bytes through the JAX stager (CPU backend) and the
port's (``device="cpu"``) give equal staged bytes, transfers, slot size
and host/device checksums — exactly. The window's contracts (out-of-order
completion, backpressure at depth, live depth, error abort, release at
completion) are driven by a test-controlled fake engine, as
``tests/test_staging.py`` drives the JAX window.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpubench.config import StagingConfig as JaxStagingConfig
from tpubench.staging.device import DevicePutStager as JaxDevicePutStager
from tpubench.staging.pallas_stage import PallasStager

from tpubench_torch import device as port_device
from tpubench_torch.config import StagingConfig
from tpubench_torch.staging.device import DevicePutStager, LockedSink
from tpubench_torch.staging.executor import InflightWindow, TransferEngine
from tpubench_torch.staging.land_stage import LandStager
from tpubench_torch.storage.base import deterministic_bytes

GRANULE = 64 * 1024
COMPARED = ("staged_bytes", "transfers", "slot_bytes", "depth",
            "checksum_ok", "checksum_host", "checksum_device")


def _feed(stager, data: np.ndarray, zero_copy: bool) -> dict:
    mv = memoryview(data.tobytes())
    off = 0
    while off < len(mv):
        n = min(GRANULE, len(mv) - off)
        if zero_copy:
            dst = stager.acquire()
            dst[:n] = mv[off : off + n]
            stager.commit(n)
        else:
            stager.submit(mv[off : off + n])
        off += n
    return stager.finish()


def _cfgs(**kw):
    j, t = JaxStagingConfig(), StagingConfig()
    for k, v in kw.items():
        setattr(j, k, v)
        setattr(t, k, v)
    return j, t


def _assert_same(js: dict, ts: dict) -> None:
    assert set(js) == set(ts)
    for key in COMPARED:
        assert js.get(key) == ts.get(key), key


@pytest.mark.parametrize("zero_copy", [True, False], ids=["zero_copy", "copying"])
@pytest.mark.parametrize("case", [
    dict(cfg=dict(validate_checksum=True), slot=256 * 1024, size=1_000_003),
    dict(cfg=dict(depth=3), slot=256 * 1024, size=1_000_003),
    dict(cfg=dict(double_buffer=False, validate_checksum=True),
         slot=128 * 1024, size=300_000),
    # Partial-slot padding: one slot far larger than the data.
    dict(cfg=dict(validate_checksum=True), slot=4 << 20, size=100_001),
], ids=["validate_ring", "depth3_window", "depth1", "partial_slot"])
def test_device_put_stager_matches_reference(jax_cpu_devices, case, zero_copy):
    jcfg, tcfg = _cfgs(**case["cfg"])
    data = deterministic_bytes("torch/stager", case["size"])
    js = _feed(JaxDevicePutStager(0, GRANULE, cfg=jcfg, slot_bytes=case["slot"]),
               data, zero_copy)
    ts = _feed(DevicePutStager(0, GRANULE, cfg=tcfg, device="cpu",
                               slot_bytes=case["slot"]), data, zero_copy)
    _assert_same(js, ts)
    assert ts["staged_bytes"] == case["size"]
    assert ts["drain"] == js["drain"]
    if "checksum_ok" in ts:
        assert ts["checksum_ok"] is True


@pytest.mark.parametrize("depth", [1, 3])
def test_land_stager_matches_pallas_stager(jax_cpu_devices, depth):
    jcfg, tcfg = _cfgs(depth=depth)
    data = deterministic_bytes("torch/land", 1_000_000)
    js = _feed(PallasStager(0, GRANULE, cfg=jcfg, slot_bytes=100_000), data, True)
    ts = _feed(LandStager(0, GRANULE, cfg=tcfg, device="cpu",
                          slot_bytes=100_000), data, True)
    _assert_same(js, ts)
    assert ts["slot_bytes"] == 131_072  # rounded up to whole 512x128 blocks
    assert ts["checksum_ok"] is True and ts["staged_bytes"] == 1_000_000


def test_round_robin_devices_match_reference(jax_cpu_devices, monkeypatch):
    """Worker i stages onto device i % count, as the JAX stagers do over
    jax.local_devices() (8 simulated here)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: len(jax_cpu_devices))
    for i in range(11):
        ref = JaxDevicePutStager(i, GRANULE, slot_bytes=GRANULE, depth=1).device
        assert port_device.worker_device("cuda", i) == torch.device("cuda", ref.id)
    assert port_device.worker_device("cuda:1", 5) == torch.device("cuda", 1)


def test_cpu_transfer_is_a_real_copy():
    """On the CPU the transfer copies (the JAX CPU backend may alias the
    slot), so slot reuse after the completion gate is safe on both."""
    eng = TransferEngine()
    slot = torch.arange(256, dtype=torch.uint8)
    h = eng.submit(slot, torch.device("cpu"))
    assert eng.probe(h) is True
    eng.wait(h)
    slot.zero_()
    assert int(h[0].sum()) == sum(range(256))
    eng.delete(h)
    assert h[0] is None


def test_locked_sink_serializes_concurrent_producers():
    cfg = StagingConfig()
    cfg.validate_checksum = True
    sink = LockedSink(DevicePutStager(0, 1024, cfg=cfg, device="cpu",
                                      slot_bytes=4096))
    assert not hasattr(sink, "acquire")
    chunks = [bytes([i + 1]) * 1024 for i in range(4)]
    threads = [
        threading.Thread(target=lambda c=c: [sink.submit(c) for _ in range(20)])
        for c in chunks
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    st = sink.finish()
    assert st["staged_bytes"] == 4 * 20 * 1024 and st["checksum_ok"]


# ------------------------------------------------ the transfer window ----
class ManualEngine:
    """Transfers complete only when the test calls complete(i)."""

    class H:
        def __init__(self, array):
            self.array = array
            self.ready = threading.Event()

    def __init__(self, fail_submit: bool = False):
        self.submitted: list = []
        self.deleted: list = []
        self.fail_submit = fail_submit

    def submit(self, array, device):
        if self.fail_submit:
            raise RuntimeError("device gone")
        h = self.H(array)
        self.submitted.append(h)
        return h

    def probe(self, h):
        return h.ready.is_set()

    def wait(self, h):
        if not h.ready.wait(timeout=10.0):
            raise TimeoutError("manual transfer never completed")

    def delete(self, h):
        self.deleted.append(h)

    def complete(self, i: int) -> None:
        self.submitted[i].ready.set()


def _eventually(pred, timeout=5.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.002)
    raise AssertionError(msg)


def test_window_completes_out_of_order():
    eng = ManualEngine()
    w = InflightWindow(3, None, engine=eng)
    done: list[int] = []
    for i in range(3):
        w.enqueue(bytes([i]), 1, on_complete=lambda i=i: done.append(i))
    _eventually(lambda: len(eng.submitted) == 3)
    eng.complete(2)
    _eventually(lambda: done == [2], msg=f"completion order {done}")
    eng.complete(0)
    eng.complete(1)
    w.close()
    assert sorted(done) == [0, 1, 2] and done[0] == 2
    s = w.stats()
    assert s["out_of_order_completions"] >= 1
    assert s["transfers"] == 3 and s["staged_bytes"] == 3
    assert len(eng.deleted) == 3


def test_window_releases_at_completion_not_submit():
    """A slot handed to the window is freed only when its copy lands."""
    eng = ManualEngine()
    w = InflightWindow(2, None, engine=eng)
    released = threading.Event()
    w.enqueue(b"slot", 4, on_complete=released.set)
    _eventually(lambda: len(eng.submitted) == 1)
    time.sleep(0.02)
    assert not released.is_set()
    eng.complete(0)
    assert released.wait(2.0)
    w.close()


def test_window_backpressure_at_depth():
    eng = ManualEngine()
    w = InflightWindow(2, None, engine=eng)
    w.enqueue(b"a", 1)
    w.enqueue(b"b", 1)
    _eventually(lambda: len(eng.submitted) == 2)
    entered, returned = threading.Event(), threading.Event()

    def third():
        entered.set()
        w.enqueue(b"c", 1)
        returned.set()

    t = threading.Thread(target=third, daemon=True)
    t.start()
    entered.wait(2.0)
    time.sleep(0.05)
    assert not returned.is_set(), "enqueue must block at depth K"
    eng.complete(0)
    assert returned.wait(2.0), "completion must unblock the producer"
    eng.complete(1)
    _eventually(lambda: len(eng.submitted) == 3)
    eng.complete(2)
    w.close()
    assert w.stats()["transfer_wait_ns"] > 0


def test_window_set_depth_live():
    eng = ManualEngine()
    w = InflightWindow(1, None, engine=eng)
    w.enqueue(b"a", 1)
    _eventually(lambda: len(eng.submitted) == 1)
    w.set_depth(3)
    w.enqueue(b"b", 1)  # would deadlock at depth 1
    w.enqueue(b"c", 1)
    _eventually(lambda: len(eng.submitted) == 3)
    for i in range(3):
        eng.complete(i)
    w.close()
    assert w.depth == 3 and w.stats()["inflight_max"] == 3


def test_window_error_aborts_the_producer():
    """A failed submit frees the slot and aborts the producer at its next
    enqueue instead of letting the fetch burn the stream."""
    eng = ManualEngine(fail_submit=True)
    w = InflightWindow(2, None, engine=eng)
    freed: list[int] = []
    w.enqueue(b"a", 1, on_complete=lambda: freed.append(0))
    _eventually(lambda: w.error is not None)
    with pytest.raises(RuntimeError, match="device gone"):
        w.enqueue(b"b", 1, on_complete=lambda: freed.append(1))
    w.close()
    assert sorted(freed) == [0, 1]


def test_overlapped_stager_error_aborts_fetch_promptly():
    cfg = StagingConfig()
    cfg.depth = 2
    st = DevicePutStager(0, 1024, cfg=cfg, device="cpu", slot_bytes=2048,
                         transfer_engine=ManualEngine(fail_submit=True))
    assert st._overlap
    with pytest.raises(RuntimeError, match="device gone"):
        st.submit(memoryview(bytes(64 * 1024)))
    with pytest.raises(RuntimeError, match="device gone"):
        st.finish()
