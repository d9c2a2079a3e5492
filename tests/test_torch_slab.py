"""The port's zero-copy slab datapath (``tpubench_torch/mem``): the
refcounted slab pool, the lease lifecycle through the cache, the
prefetcher and the staging window, copies-per-byte accounting, and the
slab-vs-bytes A/B of ``train-ingest`` — the counterparts of
``tests/test_slab.py``, on the CPU (the page-locked pool on the card is in
``tests/test_torch_cuda.py``).

The lease-lifetime test holds the overlapped window to releasing a
lease only after its copy's event has completed: a transfer engine whose
events answer "pending" a set number of times."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from tpubench_torch import cli
from tpubench_torch.config import (
    BenchConfig,
    StagingConfig,
    TailConfig,
    validate_pipeline_config,
)
from tpubench_torch.mem.slab import (
    CopyMeter,
    SlabLease,
    SlabPool,
    payload_view,
    release_payload,
)
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.pipeline.prefetch import Prefetcher, fetch_chunk
from tpubench_torch.staging.device import DevicePutStager, LockedSink
from tpubench_torch.staging.executor import TransferEngine
from tpubench_torch.storage.base import (
    StorageError,
    deterministic_bytes,
    iter_ranges,
)
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.workloads.train_ingest import run_train_ingest


def key(name="o", gen=1, start=0, length=100, bucket="b") -> ChunkKey:
    return ChunkKey(bucket, name, gen, start, length)


def make_pool(slab_bytes=4096, n_slabs=4) -> SlabPool:
    return SlabPool(slab_bytes, n_slabs, device="cpu")


# --------------------------------------------------------------- the pool --


def test_pool_lease_write_read_retire():
    p = make_pool()
    assert p.native is False  # no page-locking on the CPU
    lease = p.lease(100)
    assert len(lease) == 100
    lease.view()[:] = b"q" * 100
    assert bytes(payload_view(lease)) == b"q" * 100
    t = lease.as_tensor()
    assert t.dtype == torch.uint8 and t.shape == (100,)
    assert bytes(t.numpy()) == b"q" * 100
    t[0] = ord("z")  # the tensor aliases the slab: no copy
    assert bytes(lease.view()[:1]) == b"z"
    assert p.stats()["leased"] == 1
    lease.release()
    s = p.stats()
    assert s["leased"] == 0
    assert s["leases"] == 1 and s["retires"] == 1
    assert s["overflow_leases"] == 0
    assert p.close()["leaked_slabs"] == 0


def test_pool_stats_keep_the_reference_keys():
    from tpubench.mem.slab import SlabPool as JaxSlabPool

    ref = JaxSlabPool(4096, 2, use_native=False)
    port = make_pool(n_slabs=2)
    for pool in (ref, port):
        pool.lease(10).release()
        pool.lease(20)
    assert port.stats() == ref.stats()  # both "native": False here
    assert port.close() == ref.close()


def test_pool_refcount_shares_and_last_release_retires():
    p = make_pool(n_slabs=1)
    lease = p.lease(64)
    lease.incref()  # second holder (e.g. the cache)
    lease.release()  # first holder lets go: slab must stay leased
    assert p.stats()["leased"] == 1
    lease.view()[:1] = b"x"  # memory still valid for the second holder
    lease.release()  # last reference retires
    assert p.stats()["leased"] == 0
    with pytest.raises(ValueError):
        lease.release()  # over-release is a hard error, not a corruption
    with pytest.raises(ValueError):
        lease.incref()  # resurrection is too
    with pytest.raises(ValueError, match="released"):
        lease.as_tensor()


def test_pool_overflow_never_blocks_and_is_counted():
    p = make_pool(n_slabs=2)
    a, b = p.lease(10), p.lease(10)
    c = p.lease(10)  # pool empty: transient overflow allocation
    assert c.overflow and not a.overflow
    assert not c.as_tensor().is_pinned()  # overflow is pageable
    s = p.stats()
    assert s["overflow_leases"] == 1
    assert s["peak_leased"] == 3
    for x in (a, b, c):
        x.release()
    assert p.stats()["leased"] == 0
    # Overflow slabs are dropped, not pooled: pool footprint stays 2 slabs.
    assert len(p._free) == 2


def test_pool_rejects_oversized_lease_and_bad_sizes():
    p = make_pool(slab_bytes=128)
    with pytest.raises(ValueError, match="exceeds slab_bytes"):
        p.lease(129)
    with pytest.raises(ValueError):
        SlabPool(0, 4, device="cpu")
    with pytest.raises(ValueError):
        SlabPool(128, 0, device="cpu")


def test_pool_close_reports_leaks_and_keeps_leaked_memory_alive():
    p = make_pool(n_slabs=2)
    lease = p.lease(32)
    lease.view()[:] = b"L" * 32
    s = p.close()
    assert s["leaked_slabs"] == 1
    assert bytes(lease.view()) == b"L" * 32  # no dangling view
    with pytest.raises(ValueError):
        p.lease(1)  # closed pool refuses new leases
    lease.release()  # late release still settles cleanly
    assert p.stats()["leased"] == 0


def test_pool_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SlabPool(4096, 2)


def test_payload_helpers_are_bytes_transparent():
    assert bytes(payload_view(b"abc")) == b"abc"
    release_payload(b"abc")  # no-op, no error


# ------------------------------------------------------ cache integration --


def test_cache_eviction_retires_lease_but_not_under_a_consumer():
    pool = make_pool(slab_bytes=100, n_slabs=4)
    c = ChunkCache(capacity_bytes=200)

    def fill(k, byte):
        lease = pool.lease(100)
        lease.view()[:] = byte * 100
        c.insert(k, lease)
        lease.release()  # inserter's reference: the cache now owns it
        return lease

    a, b, d = key(start=0), key(start=100), key(start=200)
    fill(a, b"a")
    fill(b, b"b")
    got = c.get(a)  # consumer reference taken under the cache lock
    assert isinstance(got, SlabLease)
    fill(d, b"d")  # evicts b (LRU after the hit on a)
    assert c.get(b) is None
    assert pool.stats()["leased"] == 2  # a + d resident (b's slab back)
    fill(key(start=300), b"e")  # evicts a WHILE the consumer holds it
    assert c.get(a) is None
    assert bytes(got.view()) == b"a" * 100  # ...but the bytes survive
    got.release()  # consumer done: NOW the slab retires
    c.close()
    assert pool.close()["leaked_slabs"] == 0


def test_cache_single_flight_waiters_each_own_a_lease_reference():
    pool = make_pool(slab_bytes=64, n_slabs=2)
    c = ChunkCache(capacity_bytes=1 << 20)
    k = key(length=64)
    gate = threading.Event()

    def fetch():
        gate.wait(5)
        lease = pool.lease(64)
        lease.view()[:] = b"v" * 64
        return lease

    results = []
    threads = [
        threading.Thread(target=lambda: results.append(c.get_or_fetch(k, fetch)))
        for _ in range(4)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        with c._lock:
            if sum(fl.consumer_waiters for fl in c._inflight.values()) >= 3:
                break
        time.sleep(0.005)
    gate.set()
    for t in threads:
        t.join()
    assert len(results) == 4
    assert all(bytes(payload_view(r)) == b"v" * 64 for r in results)
    # 4 consumer references + the cache's: releasing the consumers leaves
    # exactly the resident entry's reference.
    for r in results:
        release_payload(r)
    assert pool.stats()["leased"] == 1
    c.close()
    assert pool.stats()["leased"] == 0
    assert pool.close()["leaked_slabs"] == 0


def test_cache_refused_insert_retires_slab_via_owner_release():
    pool = make_pool(slab_bytes=50, n_slabs=2)
    c = ChunkCache(capacity_bytes=1 << 20)
    c.insert(key(gen=2, start=0), b"N" * 50)  # gen 2 sighted first
    stale = pool.lease(50)
    c.insert(key(gen=1, start=50), stale, origin="prefetch")
    assert c.stats()["stale_rejects"] == 1
    stale.release()
    assert pool.stats()["leased"] == 0
    c.close()
    assert pool.close()["leaked_slabs"] == 0


# --------------------------------------------------------- fetch lifecycle --


def _fault_backend(size=8192, **fault_kw) -> FakeBackend:
    fault = FaultPlan(**fault_kw) if fault_kw else None
    return FakeBackend.prepopulated("s/", count=2, size=size, fault=fault)


def test_fetch_chunk_zero_copy_matches_reference_bytes():
    be = _fault_backend()
    pool = make_pool(slab_bytes=4096, n_slabs=2)
    meter = CopyMeter()
    k = ChunkKey("b", "s/0", 1, 512, 4096)
    lease = fetch_chunk(be, k, pool=pool, meter=meter)
    want = deterministic_bytes("s/0", 8192).tobytes()[512 : 512 + 4096]
    assert bytes(payload_view(lease)) == want
    assert meter.stats() == {
        "landed_bytes": 4096, "copied_bytes": 0, "copies_per_byte": 1.0,
    }
    lease.release()
    data = fetch_chunk(be, k, pool=None, meter=meter)  # the bytes arm
    assert data == want
    assert meter.stats()["copies_per_byte"] == pytest.approx(1.5)  # mixed
    assert pool.close()["leaked_slabs"] == 0


@pytest.mark.parametrize("fault_kw, exc", [
    # drip_bps caps each readinto below the chunk size so the byte-
    # threshold faults fire MID-chunk.
    ({"truncate_after_bytes": 1024, "drip_bps": 20480}, IOError),
    ({"reset_after_bytes": 1024, "drip_bps": 20480}, StorageError),
    ({"read_error_rate": 1.0}, StorageError),
], ids=["truncate", "reset", "read_error"])
def test_fetch_chunk_fault_returns_lease_to_pool(fault_kw, exc):
    be = _fault_backend(**fault_kw)
    pool = make_pool(slab_bytes=4096, n_slabs=2)
    k = ChunkKey("b", "s/0", 1, 0, 4096)
    for _ in range(3):  # repeated failures must not creep the pressure
        with pytest.raises(exc):
            fetch_chunk(be, k, pool=pool)
        assert pool.stats()["leased"] == 0
    s = pool.stats()
    assert s["leases"] == s["retires"] == 3
    assert pool.close()["leaked_slabs"] == 0


def test_fetch_chunk_generation_change_returns_lease():
    be = _fault_backend()
    pool = make_pool(slab_bytes=4096, n_slabs=1)
    k = ChunkKey("b", "s/0", 1, 0, 4096)
    be._generation["s/0"] = 2  # the object was overwritten under the plan
    with pytest.raises(StorageError, match="generation changed"):
        fetch_chunk(be, k, pool=pool)
    assert pool.stats()["leased"] == 0
    assert pool.close()["leaked_slabs"] == 0


def test_fetch_chunk_zero_copy_through_full_tail_stack():
    """The zero-copy readinto composes through Retrying(Hedged(Watchdog(
    Breaker(fake)))): correct bytes, one write per byte, lease settled."""
    from tpubench_torch.storage import open_backend

    cfg = BenchConfig()
    cfg.workload.workers = 1
    cfg.workload.object_size = 16 * 1024
    cfg.transport.protocol = "fake"
    cfg.transport.tail = TailConfig(
        hedge=True, hedge_delay_s=5.0,  # never actually hedges
        watchdog=True, stall_window_s=30.0, stall_floor_bps=1.0,
        breaker=True,
    )
    be = open_backend(cfg)
    pool = make_pool(slab_bytes=16 * 1024, n_slabs=1)
    meter = CopyMeter()
    try:
        k = ChunkKey("", "tpubench/file_0", 1, 4096, 8192)
        lease = fetch_chunk(be, k, pool=pool, meter=meter)
        want = deterministic_bytes(
            "tpubench/file_0", 16 * 1024
        ).tobytes()[4096 : 4096 + 8192]
        assert bytes(payload_view(lease)) == want
        assert meter.stats()["copies_per_byte"] == 1.0
        lease.release()
    finally:
        be.close()
    assert pool.close()["leaked_slabs"] == 0


def test_prefetcher_chaos_run_leaks_no_slabs():
    """Truncation faults on every stream: the prefetch errors stay
    advisory AND every lease comes back; a clean pass parks its leases in
    the cache, all released by the cache's teardown."""
    be = _fault_backend(size=64 * 1024, truncate_after_bytes=1000,
                        drip_bps=163840)
    pool = make_pool(slab_bytes=16 * 1024, n_slabs=4)
    cache = ChunkCache(1 << 20)
    meta = be.stat("s/0")
    plan = [
        ChunkKey("b", "s/0", meta.generation, s, ln)
        for s, ln in iter_ranges(meta.size, 16 * 1024)
    ]
    pf = Prefetcher(be, cache, plan, workers=2, depth=4, pool=pool)
    pf.advance(0)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and pf.errors < 4:
        time.sleep(0.01)
    pf.close()
    assert pf.errors >= 4
    assert cache.stats()["resident_bytes"] == 0
    assert pool.stats()["leased"] == 0
    be2 = _fault_backend(size=64 * 1024)
    pf2 = Prefetcher(be2, cache, plan, workers=2, depth=len(plan), pool=pool)
    pf2.advance(0)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all(cache.contains(k) for k in plan):
            break
        time.sleep(0.005)
    pf2.close()
    assert pf2.stats()["completed"] == len(plan)
    assert pool.stats()["leased"] == len(plan)  # cache-held, not leaked
    cache.close()
    assert pool.stats()["leased"] == 0
    assert pool.close()["leaked_slabs"] == 0


# ----------------------------------------------- lease lifetime in staging --


class _PendingEvent:
    """The event after a lease's copy: ``query()`` answers False for its
    first ``polls`` calls, and at each such answer notes whether the
    lease is still held (not yet retired to its pool)."""

    def __init__(self, polls: int, lease: SlabLease, held: list):
        self.polls = polls
        self.answers = 0
        self.done = False
        self.lease = lease
        self.held = held

    def query(self) -> bool:
        if not self.done and self.answers < self.polls:
            self.answers += 1
            self.held.append(self.lease._slab is not None)
            return False
        self.done = True
        return True

    def synchronize(self) -> None:
        assert self.done, "waited on a copy before it reported complete"


class _PendingEngine(TransferEngine):
    """The window's real CPU transfer surface, with each transfer's
    event replaced by a :class:`_PendingEvent` over the lease it copies
    (``by_ptr``: the latest lease of each slab address); the landed copy
    of each transfer is kept."""

    def __init__(self, by_ptr: dict, polls: int = 3):
        super().__init__(None)
        self.by_ptr, self.polls = by_ptr, polls
        self.held: list = []
        self.events: list = []
        self.landed: list = []

    def submit(self, array, device):
        handle = super().submit(array, device)
        lease = self.by_ptr[array.data_ptr()]
        ev = _PendingEvent(self.polls, lease, self.held)
        self.events.append(ev)
        self.landed.append(handle[0])
        handle[1] = ev
        return handle


@pytest.mark.parametrize("locked", [False, True], ids=["stager", "locked"])
def test_lease_released_only_after_its_copy_event_completes(locked):
    """``submit_owned`` on the overlapped window: while a copy's event
    still reports pending, its lease stays held (its slab is not back in
    the pool, where the next fetch would overwrite it); once the event
    completes, the lease retires. Leases come from a two-slab pool and
    are reused; every landed chunk equals its source."""
    pool = make_pool(slab_bytes=4096, n_slabs=2)
    by_ptr: dict = {}
    eng = _PendingEngine(by_ptr, polls=3)
    st = DevicePutStager(0, granule_bytes=1024, cfg=StagingConfig(depth=3),
                         slot_bytes=2048, transfer_engine=eng, device="cpu")
    sink = LockedSink(st) if locked else st
    sources = []
    for i in range(8):
        deadline = time.monotonic() + 5
        while pool.leased >= 2 and time.monotonic() < deadline:
            time.sleep(0.001)  # reuse the pool's slabs, never overflow
        lease = pool.lease(4096 - i)
        data = deterministic_bytes(f"lease/{i}", 4096 - i)
        lease.view()[:] = data.tobytes()
        by_ptr[lease.as_tensor().data_ptr()] = lease
        sources.append(data)
        sink.submit_owned(lease)
    stats = sink.finish()
    assert len(eng.events) == 8 and all(ev.done for ev in eng.events)
    assert len(eng.held) == 8 * 3 and all(eng.held), (
        "a lease went back to the pool while its copy was pending"
    )
    for landed, src in zip(eng.landed, sources):
        assert np.array_equal(landed.numpy(), src)
    assert stats["staged_bytes"] == sum(len(s) for s in sources)
    assert stats["transfers"] == 8
    s = pool.stats()
    assert s["overflow_leases"] == 0 and s["leases"] == s["retires"] == 8
    assert pool.close()["leaked_slabs"] == 0


def test_submit_owned_on_the_serial_ring_copies_and_releases():
    """Validation keeps the serial ring: the lease's bytes are copied into
    the slot (checksummed) and the lease released after the fill."""
    pool = make_pool(slab_bytes=4096, n_slabs=1)
    st = DevicePutStager(
        0, granule_bytes=1024,
        cfg=StagingConfig(depth=3, validate_checksum=True),
        slot_bytes=2048, device="cpu",
    )
    lease = pool.lease(3000)
    lease.view()[:] = deterministic_bytes("serial", 3000).tobytes()
    st.submit_owned(lease)
    assert pool.leased == 0
    stats = st.finish()
    assert stats["staged_bytes"] == 3000 and stats["checksum_ok"]
    assert stats["transfers"] == 2
    assert pool.close()["leaked_slabs"] == 0


# ------------------------------------------------- train-ingest A/B + CLI --


def _ti_cfg(slab=True, readahead=4, steps=4, epochs=1, **kw) -> BenchConfig:
    cfg = BenchConfig()
    cfg.workload.workers = 2
    cfg.workload.object_size = 256 * 1024
    cfg.workload.granule_bytes = 64 * 1024
    cfg.transport.protocol = "fake"
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    cfg.pipeline.steps = steps
    cfg.pipeline.epochs = epochs
    cfg.pipeline.batch_shards = 2
    cfg.pipeline.readahead = readahead
    cfg.pipeline.slab_pool = slab
    for k, v in kw.items():
        setattr(cfg.pipeline, k, v)
    return cfg


def test_train_ingest_slab_vs_bytes_ab_and_report(tmp_path):
    """Same run, slab arm vs bytes arm: identical bytes, copies per byte
    1.0 vs 2.0, the pool clean; ``report`` renders the copies lines and
    the A/B diff, as ``tpubench report`` does."""
    from tpubench_torch.metrics.report import write_result
    from tpubench_torch.workloads.report_cmd import run_report

    slab = run_train_ingest(_ti_cfg(slab=True, epochs=2), device="cpu")
    plain = run_train_ingest(_ti_cfg(slab=False, epochs=2), device="cpu")
    assert slab.bytes_total == plain.bytes_total > 0
    assert slab.errors == plain.errors == 0
    cs, cb = (r.extra["pipeline"]["copies"] for r in (slab, plain))
    assert cs["mode"] == "slab" and cb["mode"] == "bytes"
    assert cs["copies_per_byte"] == 1.0
    assert cb["copies_per_byte"] >= 2.0
    assert cs["landed_bytes"] == cb["landed_bytes"] == 512 * 1024
    pool = cs["pool"]
    assert pool["leaked_slabs"] == 0 and pool["leased"] == 0
    assert pool["overflow_leases"] == 0
    assert slab.extra["pipeline"]["pool_pin_seconds"] >= 0
    p_bytes = write_result(plain, str(tmp_path), tag="bytes")
    p_slab = write_result(slab, str(tmp_path), tag="slab")
    out = run_report([p_bytes, p_slab])
    assert "copies: mode=slab 1.00/byte" in out
    assert "copies: mode=bytes 2.00/byte" in out
    assert "copies/byte 1.00 (slab) vs 2.00 (bytes)" in out


def test_train_ingest_slab_with_device_put_staging():
    """Both copy rings take the slab: the overlapped window stages each
    lease in place (one transfer per chunk), the validating ring copies
    it into slots; staged bytes equal consumed bytes, the pool settles."""
    for depth, validate, transfers in ((3, False, 8), (3, True, 4)):
        cfg = _ti_cfg(slab=True)
        cfg.staging.mode = "device_put"
        cfg.staging.depth = depth
        cfg.staging.validate_checksum = validate
        cfg.staging.slot_bytes = 128 * 1024
        res = run_train_ingest(cfg, device="cpu")
        assert res.errors == 0
        assert res.extra["staged_bytes"] == res.bytes_total == 512 * 1024
        assert res.extra["staging"]["transfers"] == transfers
        assert res.extra.get("checksum_ok", True) is True
        copies = res.extra["pipeline"]["copies"]
        assert copies["copies_per_byte"] == 1.0
        assert copies["pool"]["leaked_slabs"] == 0


def test_pool_autosize_counts_cache_budget_in_chunks_not_slabs():
    cfg = _ti_cfg(slab=True, epochs=2, slab_bytes=256 * 1024)  # 4x chunk
    cfg.pipeline.cache_bytes = 1 << 20  # 16 chunks — covers the 8 unique
    res = run_train_ingest(cfg, device="cpu")
    pool = res.extra["pipeline"]["copies"]["pool"]
    assert pool["slab_bytes"] == 256 * 1024
    assert pool["overflow_leases"] == 0, pool
    assert pool["leaked_slabs"] == 0


def test_validate_pipeline_config_rejects_negative_slab_knobs():
    for name, v in (("slab_bytes", -1), ("pool_slabs", -2)):
        cfg = BenchConfig()
        setattr(cfg.pipeline, name, v)
        with pytest.raises(SystemExit, match=name):
            validate_pipeline_config(cfg.pipeline)


def test_validate_pipeline_config_pool_vs_window():
    """An explicitly sized pool smaller than the overlapped window's
    in-flight leases is refused, as in ``tpubench``."""
    from tpubench.config import BenchConfig as JaxBenchConfig
    from tpubench.config import validate_pipeline_config as jax_validate

    for port, ref in ((BenchConfig(), JaxBenchConfig()),):
        for c in (port, ref):
            c.pipeline.pool_slabs, c.pipeline.slab_bytes = 2, 4096
            c.staging.depth = 3
        with pytest.raises(SystemExit) as e_port:
            validate_pipeline_config(port.pipeline, staging=port.staging)
        with pytest.raises(SystemExit) as e_ref:
            jax_validate(ref.pipeline, staging=ref.staging)
        assert str(e_port.value) == str(e_ref.value)
        port.staging.validate_checksum = True  # the serial ring holds none
        validate_pipeline_config(port.pipeline, staging=port.staging)


def test_slab_config_roundtrips_json_and_cli_flags(tmp_path):
    cfg = BenchConfig()
    cfg.pipeline.slab_pool = False
    cfg.pipeline.slab_bytes = 4096
    cfg.pipeline.pool_slabs = 7
    got = BenchConfig.from_json(cfg.to_json())
    assert (got.pipeline.slab_pool, got.pipeline.slab_bytes,
            got.pipeline.pool_slabs) == (False, 4096, 7)
    args = cli.build_parser().parse_args([
        "train-ingest", "--protocol", "fake", "--slab-bytes",
        str(128 * 1024), "--pool-slabs", "9", "--no-slab-pool",
    ])
    pl = cli.build_config(args).pipeline
    assert (pl.slab_bytes, pl.pool_slabs, pl.slab_pool) == (128 * 1024, 9,
                                                           False)


def test_flight_journal_carries_copies_and_overflow_notes(tmp_path):
    """An undersized pool notes overflow on the read's flight record,
    ``report timeline`` counts it, and the journal carries the copies
    stamp."""
    from tpubench_torch.workloads.report_cmd import run_timeline

    jpath = str(tmp_path / "flight.json")
    cfg = _ti_cfg(slab=True, epochs=2, pool_slabs=1)  # deliberately tiny
    cfg.obs.flight_journal = jpath
    res = run_train_ingest(cfg, device="cpu")
    copies = res.extra["pipeline"]["copies"]
    assert copies["pool"]["overflow_leases"] > 0
    assert copies["pool"]["leaked_slabs"] == 0  # overflow still settles
    with open(jpath) as f:
        doc = json.load(f)
    assert doc["pipeline_copies"]["mode"] == "slab"
    notes = [n for r in doc["records"] for n in r.get("notes", ())]
    assert any(n.get("kind") == "slab" for n in notes)
    assert "slab_overflows=" in run_timeline([jpath])
