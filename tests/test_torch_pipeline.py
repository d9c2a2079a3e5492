"""The port's ingest pipeline and ``train-ingest``
(``tpubench_torch/pipeline``, ``workloads/train_ingest.py``) against
``tpubench``'s on the CPU.

* The chunk cache and the prefetcher: the unit cases of
  ``tests/test_pipeline.py`` (the modules are copies), unchanged.
* ``train-ingest`` through both packages on one seeded fake store and one
  config: with ``--readahead 0`` the plan, the cache's counters, the
  bytes, the staging transfers, the copies block and (validating and
  landing rings) the device and host checksums are equal; with readahead
  on, the quantities that do not depend on timing are. The pod path
  against ``tpubench``'s 8-device mesh: the port at one rank and as a
  2-rank gloo group, every step's gather equal to the step's bytes in
  both packages. Tolerance: exact (bytes and integers).
* The guards (``SystemExit``\\ s, ``--coop-channel ici`` off the pod
  path), ``--coop`` at one process, and the CLI in each arm.
"""

import io
import json
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from test_torch_dist import run_ranks
from tpubench_torch import cli, convert
from tpubench_torch.config import BenchConfig, DistConfig
from tpubench_torch.dist import bringup
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.pipeline.prefetch import Prefetcher, read_chunk
from tpubench_torch.storage.base import deterministic_bytes, iter_ranges
from tpubench_torch.storage.fake import FakeBackend, FaultPlan
from tpubench_torch.workloads import train_ingest
from tpubench_torch.workloads.train_ingest import (
    build_plan,
    format_pipeline_scorecard,
    run_train_ingest,
)

PREFIX = "tpubench/file_"
CHUNK = 64 * 1024
# The parity store: four objects (the plan walks max(workers, threads=4)
# of them) of seeded sizes, none a whole number of chunks.
_rng = np.random.default_rng(1010)
POPULATION = [(f"{PREFIX}{i}", int(_rng.integers(150_000, 300_000)), 1)
              for i in range(4)]


def key(name="o", gen=1, start=0, length=100, bucket="b") -> ChunkKey:
    return ChunkKey(bucket, name, gen, start, length)


def _wait_for_waiters(c: ChunkCache, n: int, timeout=5.0) -> None:
    """Block until ``n`` consumers are registered on the cache's
    in-flight fetches (coalesced is only COUNTED on successful joins,
    so tests gate on waiter registration instead)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with c._lock:
            waiting = sum(fl.consumer_waiters for fl in c._inflight.values())
        if waiting >= n:
            return
        time.sleep(0.005)
    raise AssertionError(f"never saw {n} waiters")


# ------------------------------------------------------------ chunk cache --


def test_cache_hit_miss_and_lru_eviction():
    c = ChunkCache(capacity_bytes=250)
    a, b, d = key(start=0), key(start=100), key(start=200)
    c.insert(a, b"x" * 100)
    c.insert(b, b"y" * 100)
    assert c.get(a) == b"x" * 100  # a is now most-recently-used
    c.insert(d, b"z" * 100)  # 300 > 250: evicts LRU = b, not a
    assert c.get(b) is None
    assert c.get(a) is not None
    assert c.get(d) is not None
    s = c.stats()
    assert s["evictions"] == 1
    assert s["evicted_bytes"] == 100
    assert s["resident_bytes"] == 200
    assert s["hits"] == 3


def test_cache_get_or_fetch_counts_and_caches():
    c = ChunkCache(capacity_bytes=1 << 20)
    calls = []
    k = key()
    for _ in range(3):
        got = c.get_or_fetch(k, lambda: calls.append(1) or b"d" * 100)
    assert got == b"d" * 100
    assert len(calls) == 1
    s = c.stats()
    assert s["misses"] == 1 and s["hits"] == 2
    assert s["hit_ratio"] == pytest.approx(2 / 3)


def test_cache_single_flight_dedups_concurrent_misses():
    c = ChunkCache(capacity_bytes=1 << 20)
    k = key()
    gate = threading.Event()
    fetches = []

    def fetch():
        fetches.append(1)
        gate.wait(5)
        return b"v" * 64

    results = []
    threads = [
        threading.Thread(target=lambda: results.append(c.get_or_fetch(k, fetch)))
        for _ in range(6)
    ]
    for t in threads:
        t.start()
    # Let the losers pile onto the in-flight fetch, then release it.
    _wait_for_waiters(c, 5)
    gate.set()
    for t in threads:
        t.join()
    assert len(fetches) == 1  # ONE backend read for six concurrent misses
    assert results == [b"v" * 64] * 6
    s = c.stats()
    assert s["misses"] == 1
    assert s["coalesced"] == 5


def test_cache_single_flight_error_propagates_to_waiters():
    c = ChunkCache(capacity_bytes=1 << 20)
    k = key()
    gate = threading.Event()

    def fetch():
        gate.wait(5)
        raise IOError("backend down")

    errs = []

    def worker():
        try:
            c.get_or_fetch(k, fetch)
        except IOError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    _wait_for_waiters(c, 2)
    gate.set()
    for t in threads:
        t.join()
    # The two waiters retried as owners after the joined fetch failed
    # (the fall-through), and the retry failed too: all three error.
    assert errs == ["backend down"] * 3
    # The failed fetch cached nothing: the next access re-fetches.
    assert c.get(k) is None


def test_cache_demand_coalescing_onto_prefetch_counts_as_used():
    """The overlap the pipeline exists for: a demand read that joins an
    IN-FLIGHT prefetch consumed those bytes — they must count as
    prefetch-used, never as waste."""
    c = ChunkCache(capacity_bytes=1 << 20)
    k = key(length=64)
    gate = threading.Event()

    def prefetch_fetch():
        gate.wait(5)
        return b"p" * 64

    t = threading.Thread(
        target=lambda: c.get_or_fetch(
            k, prefetch_fetch, origin="prefetch", consumer=False
        )
    )
    t.start()
    for _ in range(200):  # wait for the prefetch to own the flight
        if c.contains(k):
            break
        time.sleep(0.005)
    got = []
    consumer = threading.Thread(
        target=lambda: got.append(c.get_or_fetch(k, lambda: b"never"))
    )
    consumer.start()
    _wait_for_waiters(c, 1)
    gate.set()
    t.join()
    consumer.join()
    assert got == [b"p" * 64]
    s = c.stats()
    assert s["coalesced"] == 1
    assert s["prefetch_used_bytes"] == 64
    assert s["prefetch_wasted_bytes"] == 0
    assert c.unused_prefetched_bytes() == 0


def test_cache_get_or_fetch_info_reports_source():
    c = ChunkCache(capacity_bytes=1 << 20)
    k = key(length=8)
    data, source = c.get_or_fetch_info(k, lambda: b"x" * 8)
    assert (data, source) == (b"x" * 8, "fetched")
    data, source = c.get_or_fetch_info(k, lambda: b"never")
    assert (data, source) == (b"x" * 8, "hit")


def test_cache_generation_invalidation():
    c = ChunkCache(capacity_bytes=1 << 20)
    c.insert(key(gen=1, start=0), b"a" * 50)
    c.insert(key(gen=1, start=50), b"b" * 50)
    c.insert(key(name="other", gen=1), b"c" * 50)
    # First sighting of generation 2 drops BOTH gen-1 chunks of the
    # object — and nothing of the other object.
    c.insert(key(gen=2, start=0), b"A" * 50)
    assert c.get(key(gen=1, start=0)) is None
    assert c.get(key(gen=1, start=50)) is None
    assert c.get(key(name="other", gen=1)) is not None
    assert c.get(key(gen=2, start=0)) == b"A" * 50
    assert c.stats()["generation_invalidations"] == 2


def test_cache_zero_capacity_is_cold_but_still_serves():
    c = ChunkCache(capacity_bytes=0)
    calls = []
    k = key(length=10)
    for _ in range(2):
        assert c.get_or_fetch(k, lambda: calls.append(1) or b"x" * 10) == b"x" * 10
    assert len(calls) == 2  # nothing cached
    assert c.stats()["misses"] == 2
    assert c.stats()["resident_bytes"] == 0


def test_cache_oversize_chunk_served_uncached():
    c = ChunkCache(capacity_bytes=64)
    c.insert(key(start=0, length=32), b"k" * 32)
    c.insert(key(start=100, length=100), b"h" * 100)  # > whole budget
    assert c.stats()["oversize_skips"] == 1
    # The resident working set survived (no evict-everything-for-nothing).
    assert c.get(key(start=0, length=32)) is not None


def test_cache_demand_retries_after_joined_prefetch_fails():
    """A demand read that coalesces onto a FAILED prefetch must fall
    through to its own fetch (fresh retry window) instead of inheriting
    the advisory prefetch's error — readahead must never make a run
    less fault-tolerant than cold reads."""
    c = ChunkCache(capacity_bytes=1 << 20)
    k = key(length=32)
    gate = threading.Event()

    def failing_prefetch():
        gate.wait(5)
        raise IOError("prefetch retry window exhausted")

    t = threading.Thread(
        target=lambda: pytest.raises(IOError, c.get_or_fetch, k,
                                     failing_prefetch, "prefetch", False)
    )
    t.start()
    for _ in range(200):  # the prefetch owns the in-flight slot
        if c.contains(k):
            break
        time.sleep(0.005)
    got = []
    consumer = threading.Thread(
        target=lambda: got.append(
            c.get_or_fetch_info(k, lambda: b"demand" + b"!" * 26)
        )
    )
    consumer.start()
    _wait_for_waiters(c, 1)
    gate.set()  # prefetch fails NOW; the waiting consumer must recover
    t.join()
    consumer.join()
    assert got and got[0][0] == b"demand" + b"!" * 26
    assert got[0][1] == "fetched"  # its own attempt, not the error
    s = c.stats()
    # ONE access, ONE count: the failed join is not a coalesce — the
    # access resolved as a miss (own fetch). hit_ratio's denominator
    # must not double-charge fault-window accesses.
    assert s["coalesced"] == 0 and s["misses"] == 1


def test_cache_generation_invalidation_of_prefetched_counts_separately():
    """Generation churn dropping unused prefetched entries is NOT budget
    thrash: it lands in prefetch_invalidated_bytes (waste for the
    efficiency report) and never in prefetch_wasted_bytes (the
    cancel-on-eviction depth clamp's signal)."""
    c = ChunkCache(capacity_bytes=1 << 20)
    c.insert(key(gen=1, start=0), b"a" * 64, origin="prefetch")
    c.insert(key(gen=2, start=64), b"b" * 64)  # gen bump invalidates
    s = c.stats()
    assert s["prefetch_invalidated_bytes"] == 64
    assert s["prefetch_wasted_bytes"] == 0
    assert c.unused_prefetched_bytes() == 0  # resident counter settled


def test_cache_rejects_insert_of_superseded_generation():
    """An in-flight gen-1 fetch finishing AFTER gen 2 was sighted must
    not resurrect stale bytes (later gen-2 sightings would never drop
    them — invalidation fires only on strictly newer generations)."""
    c = ChunkCache(capacity_bytes=1 << 20)
    c.insert(key(gen=2, start=0), b"N" * 50)  # gen 2 sighted first
    c.insert(key(gen=1, start=50), b"O" * 50, origin="prefetch")  # stale
    assert c.get(key(gen=1, start=50)) is None
    s = c.stats()
    assert s["stale_rejects"] == 1
    # Never-cached bytes count as DROPPED, not wasted: the prefetcher's
    # byte-budget identity (inserted - used - wasted = resident unused)
    # must only see bytes that were actually resident.
    assert s["prefetch_dropped_bytes"] == 50
    assert s["prefetch_wasted_bytes"] == 0
    assert s["resident_bytes"] == 50  # only the gen-2 entry


def test_cache_prefetch_used_vs_wasted_accounting():
    c = ChunkCache(capacity_bytes=200)
    c.insert(key(start=0), b"a" * 100, origin="prefetch")
    c.insert(key(start=100), b"b" * 100, origin="prefetch")
    assert c.get(key(start=0)) is not None  # used
    c.insert(key(start=200), b"c" * 100, origin="prefetch")  # evicts LRU
    s = c.stats()
    assert s["prefetch_used_bytes"] == 100
    # start=100 was evicted before any use → wasted.
    assert s["prefetch_wasted_bytes"] == 100
    assert c.unused_prefetched_bytes() == 100  # start=200 still unused


# ------------------------------------------------------------- prefetcher --


def _fake_backend(count=2, size=64 * 1024, **fault_kw) -> FakeBackend:
    fault = FaultPlan(**fault_kw) if fault_kw else None
    return FakeBackend.prepopulated("p/", count=count, size=size, fault=fault)


def _plan(backend, chunk=16 * 1024, count=2):
    plan = []
    for i in range(count):
        name = f"p/{i}"
        meta = backend.stat(name)
        plan += [
            ChunkKey("b", name, meta.generation, s, ln)
            for s, ln in iter_ranges(meta.size, chunk)
        ]
    return plan


def test_read_chunk_reads_exact_range():
    be = _fake_backend()
    k = ChunkKey("b", "p/0", 1, 1000, 5000)
    data = read_chunk(be, k)
    assert data == deterministic_bytes("p/0", 64 * 1024).tobytes()[1000:6000]


def test_prefetcher_warms_the_window_and_consumer_hits():
    be = _fake_backend()
    cache = ChunkCache(1 << 20)
    plan = _plan(be)
    pf = Prefetcher(be, cache, plan, workers=2, depth=4)
    pf.advance(0)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all(cache.contains(k) for k in plan[:4]):
            break
        time.sleep(0.005)
    pf.close()
    assert all(cache.contains(k) for k in plan[:4])
    st = pf.stats()
    assert st["completed"] >= 4
    assert st["errors"] == 0
    # Consumer hits what prefetch warmed; prefetch's own fill never
    # counted as a hit (consumer=False path).
    assert cache.stats()["hits"] == 0
    assert cache.get_or_fetch(plan[0], lambda: b"") == read_chunk(be, plan[0])
    assert cache.stats()["hits"] == 1


def test_prefetcher_full_plan_zero_waste_when_consumed():
    """The acceptance invariant: depth <= plan length and a consumer that
    walks the whole plan → every prefetched byte is used, zero wasted."""
    be = _fake_backend()
    cache = ChunkCache(1 << 20)
    plan = _plan(be)
    pf = Prefetcher(be, cache, plan, workers=2, depth=len(plan))
    pf.advance(0)  # depth == plan length: the whole plan is scheduled
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all(cache.contains(k) for k in plan):
            break
        time.sleep(0.005)
    for i, k in enumerate(plan):
        pf.advance(i)
        cache.get_or_fetch(k, lambda k=k: read_chunk(be, k))
    pf.advance(len(plan))
    pf.close()
    st = pf.stats()
    assert st["wasted_bytes"] == 0
    assert st["used_bytes"] == sum(k.length for k in set(plan))
    assert st["efficiency"] == 1.0


def test_prefetcher_respects_byte_budget():
    be = _fake_backend()
    cache = ChunkCache(1 << 20)
    plan = _plan(be, chunk=16 * 1024)
    # Budget of ~2 chunks: the window never schedules the full depth.
    pf = Prefetcher(be, cache, plan, workers=1, depth=8,
                    byte_budget=2 * 16 * 1024 + 1)
    pf.advance(0)
    time.sleep(0.2)
    pf.close()
    assert pf.issued <= 3  # 2 within budget (+1 for inflight settling)
    assert cache.stats()["prefetch_inserted_bytes"] <= 3 * 16 * 1024


def test_prefetcher_cancels_entries_behind_the_cursor():
    gate = threading.Event()

    class SlowBackend:
        def __init__(self, inner):
            self.inner = inner

        def open_read(self, name, start=0, length=None):
            gate.wait(5)
            return self.inner.open_read(name, start=start, length=length)

    be = SlowBackend(_fake_backend())
    cache = ChunkCache(1 << 20)
    plan = _plan(be.inner)
    pf = Prefetcher(be, cache, plan, workers=1, depth=6)
    pf.advance(0)  # queue [0..6); worker blocks on chunk 0
    time.sleep(0.05)
    pf.advance(4)  # chunks 1..3 are now behind the consumer
    gate.set()
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and pf.cancelled < 3:
        time.sleep(0.01)
    pf.close()
    assert pf.cancelled >= 3  # stale window entries dropped, not fetched


def test_prefetcher_error_recorded_not_raised():
    be = _fake_backend(error_rate=1.0)  # every open fails
    cache = ChunkCache(1 << 20)
    plan = _plan(be)
    pf = Prefetcher(be, cache, plan, workers=1, depth=2)
    pf.advance(0)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and pf.errors < 1:
        time.sleep(0.01)
    pf.close()
    assert pf.errors >= 1
    assert "injected open failure" in (pf.last_error or "")
    assert cache.stats()["resident_bytes"] == 0


# ------------------------------------------------ train-ingest, the port --


def _ti_cfg(readahead=4, cache=256 << 20, steps=4, epochs=1,
            compute_ms=0.0) -> BenchConfig:
    cfg = BenchConfig()
    cfg.workload.workers = 2
    cfg.workload.object_size = 256 * 1024
    cfg.workload.granule_bytes = CHUNK
    cfg.transport.protocol = "fake"
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    cfg.pipeline.steps = steps
    cfg.pipeline.epochs = epochs
    cfg.pipeline.batch_shards = 2
    cfg.pipeline.readahead = readahead
    cfg.pipeline.cache_bytes = cache
    cfg.pipeline.step_compute_ms = compute_ms
    return cfg


def test_train_ingest_smoke_counts_and_sections():
    res = run_train_ingest(_ti_cfg(), device="cpu")
    assert res.workload == "train_ingest" and res.errors == 0
    assert res.bytes_total == 4 * 2 * CHUNK
    pipe = res.extra["pipeline"]
    assert {"cache", "prefetch", "stall", "plan", "copies"} <= set(pipe)
    assert pipe["stall"]["steps"] == 4
    assert res.summaries["step"].count == res.summaries["stall"].count == 4
    assert "read" in res.summaries
    out = format_pipeline_scorecard(pipe)
    assert "ingest-pipeline scorecard" in out and "data stalls" in out


def test_train_ingest_cold_arm_has_no_prefetch():
    res = run_train_ingest(_ti_cfg(readahead=0, cache=0), device="cpu")
    pipe = res.extra["pipeline"]
    assert pipe["prefetch"] is None
    assert pipe["cache"]["hits"] == 0 and pipe["cache"]["misses"] == 4 * 2
    assert "prefetch: off" in format_pipeline_scorecard(pipe)


def test_train_ingest_warm_epoch_is_all_hits():
    """Epoch 2 of a plan that fits the cache is served from it: misses
    are the unique chunks, hits every access of the second pass."""
    res = run_train_ingest(_ti_cfg(readahead=0, steps=4, epochs=2),
                           device="cpu")
    c = res.extra["pipeline"]["cache"]
    assert (c["misses"], c["hits"], c["evictions"]) == (8, 8, 0)
    assert res.bytes_total == 16 * CHUNK


@pytest.mark.parametrize("kw, match", [
    (dict(readahead=8, cache=0), "cache_bytes"),
    (dict(readahead=4, cache=32 * 1024), "smaller than one chunk"),
    (dict(readahead_bytes=1024), "readahead_bytes"),
    (dict(slab_bytes=1024), "slab_bytes"),
], ids=["no_cache", "cache_below_chunk", "budget_below_chunk",
        "slab_below_chunk"])
def test_train_ingest_cross_field_guards(kw, match):
    """``run_train_ingest``'s three cross-field guards (cache, readahead
    budget, slab vs the effective chunk), with ``tpubench``'s text."""
    from tpubench.workloads.train_ingest import run_train_ingest as ref_run

    cfg = _ti_cfg(readahead=kw.pop("readahead", 4),
                  cache=kw.pop("cache", 256 << 20))
    for k, v in kw.items():
        setattr(cfg.pipeline, k, v)
    ref_cfg = _reference_config(cfg.to_dict())
    with pytest.raises(SystemExit, match=match) as port:
        run_train_ingest(cfg, device="cpu")
    with pytest.raises(SystemExit) as ref:
        ref_run(ref_cfg)
    assert str(port.value) == str(ref.value)


def test_train_ingest_cold_arm_takes_any_cache_budget():
    cfg = _ti_cfg(readahead=0, cache=32 * 1024)
    assert run_train_ingest(cfg, device="cpu").errors == 0


def test_train_ingest_coop_is_refused(tmp_path):
    """``--coop`` runs (a pod of one routes nothing, the stamp is
    written); what is still refused is the lockstep channel without the
    plan-synchronized pod path."""
    cfg = _ti_cfg()
    cfg.coop.enabled = True
    res = run_train_ingest(cfg, device="cpu")
    co = res.extra["pipeline"]["coop"]
    assert res.errors == 0 and co["hosts"] == 1 and co["peer_requests"] == 0
    assert co["origin_fetches"] == res.extra["pipeline"]["plan"]["unique_chunks"]
    argv = ["train-ingest", "--protocol", "fake", "--coop", "--steps", "2",
            "--device", "cpu", "--results-dir", str(tmp_path)]
    with redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    assert "coop: hosts=1/1" in out.getvalue()
    doc = json.loads(next(tmp_path.glob("train_ingest_*.json")).read_text())
    assert doc["config"]["coop"]["enabled"] is True
    assert doc["extra"]["pipeline"]["coop"]["peer_requests"] == 0
    with pytest.raises(SystemExit, match="lockstep"):
        cli.main([*argv, "--coop-channel", "ici"])


def test_train_ingest_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_train_ingest(_ti_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["train-ingest", "--protocol", "fake", "--steps", "1",
                  "--results-dir", str(tmp_path)])


def test_train_ingest_flight_journal_step_records(tmp_path):
    """Step records carry the stall phases when a step waited; chunk
    accesses carry cache_hit / cache_miss; ``report timeline`` reads the
    journal."""
    from tpubench_torch.workloads.report_cmd import run_timeline

    jpath = str(tmp_path / "flight.json")
    cfg = _ti_cfg(readahead=0, epochs=2)
    cfg.obs.flight_journal = jpath
    res = run_train_ingest(cfg, device="cpu")
    with open(jpath) as f:
        recs = json.load(f)["records"]
    steps = [r for r in recs if r.get("kind") == "step"]
    assert len(steps) == 8 and all(r["bytes"] == 2 * CHUNK for r in steps)
    assert all("stall_end" in r["phases"] for r in steps[:4])  # cold pass
    hits = [r for r in recs if r.get("kind") == "cache"]
    assert len(hits) == res.extra["pipeline"]["cache"]["hits"] == 8
    assert "pipeline: steps=8" in run_timeline([jpath])


ARMS = {
    "cold": (["--readahead", "0"], "copies: mode=slab 1.00/byte"),
    "readahead": (["--readahead", "4"], "copies: mode=slab 1.00/byte"),
    "bytes": (["--no-slab-pool"], "copies: mode=bytes 2.00/byte"),
    "pallas": (["--staging", "pallas"], "copies: mode=slab 1.00/byte"),
    "validate": (["--validate"], "copies: mode=slab 1.00/byte"),
    "pod": (["--pipeline-pod"], "copies: mode=slab 1.00/byte"),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_cli_train_ingest_arms(arm, tmp_path):
    """Each arm through the CLI on the CPU: the scorecard (copies line,
    the pool's leak count), the result JSON; the rings' checksums hold."""
    flags, copies_line = ARMS[arm]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main([
            "train-ingest", "--protocol", "fake", "--workers", "2",
            "--object-size", str(4 * CHUNK), "--granule-bytes", str(CHUNK),
            "--steps", "3", "--batch-shards", "2", "--epochs", "2",
            "--slot-bytes", str(128 * 1024), "--device", "cpu",
            "--results-dir", str(tmp_path), *flags,
        ])
    out = buf.getvalue()
    assert rc == 0
    assert "ingest-pipeline scorecard" in out and copies_line in out
    if arm != "bytes":
        assert "leaked_slabs=0" in out
    files = list(tmp_path.glob("train_ingest_*.json"))
    assert len(files) == 1
    doc = json.loads(files[0].read_text())
    assert doc["errors"] == 0 and doc["bytes_total"] == 6 * 2 * CHUNK
    assert doc["extra"]["pipeline"]["stall"]["steps"] == 6
    if arm in ("pallas", "validate"):
        assert doc["extra"]["checksum_ok"] is True
    if arm == "pod":
        assert doc["n_chips"] == 1 and "staging" not in doc["extra"]


def test_cli_train_ingest_rejects_bad_flags(tmp_path):
    with pytest.raises(SystemExit, match="steps"):
        cli.main(["train-ingest", "--protocol", "fake", "--steps", "0",
                  "--device", "cpu", "--results-dir", str(tmp_path)])


def test_pipeline_section_carries_across_both_ways():
    """One config JSON drives both packages: ``tpubench``'s pipeline
    section loads into the port's dataclass field for field and writes
    back unchanged; the port's flags write what ``tpubench`` reads."""
    from tpubench.config import BenchConfig as JaxBenchConfig

    ref = JaxBenchConfig()
    for name, v in (("readahead", 17), ("cache_bytes", 12345), ("pod", True),
                    ("slab_pool", False), ("pool_slabs", 7),
                    ("step_compute_ms", 2.5)):
        setattr(ref.pipeline, name, v)
    cfg, _ = convert.from_reference(ref.to_dict(), POPULATION)
    assert cfg.to_dict()["pipeline"] == ref.to_dict()["pipeline"]
    assert JaxBenchConfig.from_dict(cfg.to_dict()).pipeline == ref.pipeline
    args = cli.build_parser().parse_args([
        "train-ingest", "--readahead", "3", "--batch-shards", "5",
        "--chunk-bytes", "4096", "--pipeline-pod", "--no-slab-pool"])
    back = JaxBenchConfig.from_dict(cli.build_config(args).to_dict())
    assert (back.pipeline.readahead, back.pipeline.batch_shards,
            back.pipeline.chunk_bytes, back.pipeline.pod,
            back.pipeline.slab_pool) == (3, 5, 4096, True, False)


# ------------------------------------------- parity against tpubench -----


def _reference_config(d: dict):
    from tpubench.config import BenchConfig as JaxBenchConfig

    return JaxBenchConfig.from_dict(d)


def _parity_dict(readahead: int, staging: str, epochs: int = 2,
                 cache_chunks: int = 6) -> dict:
    """One config for both packages: tpubench's ``to_dict()``. Five steps
    of three chunks are the store's 15 chunks (four of them short); a
    6-chunk cache evicts through the second epoch, a 16-chunk one serves
    all of it."""
    cfg = _ti_cfg(readahead=readahead, steps=5, epochs=epochs)
    cfg.pipeline.batch_shards = 3
    cfg.pipeline.cache_bytes = cache_chunks * CHUNK
    cfg.staging.slot_bytes = 128 * 1024
    if staging == "validate":
        cfg.staging.mode, cfg.staging.validate_checksum = "device_put", True
    elif staging == "depth3":
        cfg.staging.mode, cfg.staging.depth = "device_put", 3
    else:
        cfg.staging.mode = staging
    return _reference_config(cfg.to_dict()).to_dict()


def _ref_sink_stats(monkeypatch) -> list:
    """Wrap tpubench's sink factory to keep each stager's finish stats
    (tpubench's train-ingest result leaves the checksums out)."""
    import tpubench.staging.device as jdev

    real, kept = jdev.make_sink_factory, []

    def factory(cfg, *a, **k):
        make = real(cfg, *a, **k)
        if make is None:
            return None

        def build(i):
            st = make(i)
            fin = st.finish
            st.finish = lambda: kept.append(fin()) or kept[-1]
            return st

        return build

    monkeypatch.setattr(jdev, "make_sink_factory", factory)
    return kept


def _both(d: dict, monkeypatch):
    from tpubench.storage.fake import FakeBackend as JaxFakeBackend
    from tpubench.workloads.train_ingest import run_train_ingest as ref_run

    kept = _ref_sink_stats(monkeypatch)
    ref = ref_run(_reference_config(d),
                  backend=JaxFakeBackend.from_population(POPULATION))
    cfg, store = convert.from_reference(d, POPULATION)
    port = run_train_ingest(cfg, backend=store, device="cpu")
    return ref, port, (kept[0] if kept else {})


def _copies(res) -> dict:
    c = json.loads(json.dumps(res.extra["pipeline"]["copies"]))
    if "pool" in c:
        c["pool"].pop("native")  # page-locked on the card vs posix_memalign
    return c


@pytest.mark.parametrize("staging, cache_chunks", [
    ("none", 6), ("none", 16), ("depth3", 6), ("validate", 6), ("pallas", 6),
], ids=["none", "warm", "depth3", "validate", "pallas"])
def test_parity_cold(staging, cache_chunks, monkeypatch, jax_cpu_devices):
    from tpubench.storage.fake import FakeBackend as JaxFakeBackend
    from tpubench.workloads.train_ingest import build_plan as ref_plan

    d = _parity_dict(0, staging, cache_chunks=cache_chunks)
    assert ref_plan(_reference_config(d),
                    JaxFakeBackend.from_population(POPULATION)) == build_plan(
        BenchConfig.from_dict(d), FakeBackend.from_population(POPULATION))
    ref, port, ref_sink = _both(d, monkeypatch)
    rp, pp = ref.extra["pipeline"], port.extra["pipeline"]
    assert pp["cache"] == rp["cache"]
    if cache_chunks == 6:
        assert (pp["cache"]["hits"], pp["cache"]["evictions"]) == (0, 24)
    else:
        assert (pp["cache"]["hits"], pp["cache"]["evictions"]) == (15, 0)
    assert pp["plan"] == rp["plan"] and pp["stall"]["steps"] == 10
    assert port.bytes_total == ref.bytes_total == 2 * sum(
        size for _, size, _ in POPULATION)
    assert _copies(port) == _copies(ref)
    assert port.errors == ref.errors == 0
    # tpubench's rings count every local device of its 8-device CPU mesh;
    # the port's stage onto one device.
    assert port.n_chips == 1
    assert port.extra.get("staged_bytes") == ref.extra.get("staged_bytes")
    if staging != "none":
        assert port.extra["staged_bytes"] == port.bytes_total
        # One stage record per transfer in every ring.
        assert (port.summaries["stage"].count
                == ref.summaries["stage"].count
                == ref_sink.get("transfers", port.summaries["stage"].count))
        if staging != "pallas":  # the landing ring reports no overlap block
            assert (port.extra["staging"]["transfers"]
                    == ref.extra["staging"]["transfers"])
    if staging in ("validate", "pallas"):
        for k in ("checksum_ok", "checksum_device", "checksum_host"):
            assert port.extra[k] == ref_sink[k]
        assert port.extra["checksum_ok"] is True


def _prefetch_identities(res) -> dict:
    pipe = res.extra["pipeline"]
    pf, c = pipe["prefetch"], pipe["cache"]
    plan = pipe["plan"]
    assert pf["errors"] == 0
    assert pf["issued"] == pf["completed"] + pf["skipped"] + pf["errors"]
    assert pf["used_bytes"] + pf["wasted_bytes"] == (
        pf["prefetched_bytes"] + c["prefetch_dropped_bytes"])
    assert c["hits"] + c["misses"] + c["coalesced"] == plan["chunks"]
    assert c["misses"] + pf["completed"] >= plan["unique_chunks"]
    return {"bytes": res.bytes_total,
            "staged": res.extra.get("staged_bytes"),
            "errors": res.errors,
            "leaked": pipe["copies"]["pool"]["leaked_slabs"]}


@pytest.mark.parametrize("staging", ["none", "depth3"])
def test_parity_readahead(staging, monkeypatch, jax_cpu_devices):
    """Readahead on: what does not depend on timing is equal."""
    ref, port, _ = _both(_parity_dict(4, staging), monkeypatch)
    assert _prefetch_identities(port) == _prefetch_identities(ref)
    assert port.extra["pipeline"]["copies"]["copies_per_byte"] == 1.0


# ------------------------------------------------------------ pod path ---


def _step_blobs(plan: list, batch: int) -> list:
    objs = {name: deterministic_bytes(name, size)
            for name, size, _ in POPULATION}
    return [
        b"".join(objs[k.object][k.start : k.start + k.length].tobytes()
                 for k in plan[lo : lo + batch])
        for lo in range(0, len(plan), batch)
    ]


def _pod_dict() -> dict:
    d = _parity_dict(0, "none", epochs=1)
    d["pipeline"]["pod"] = True
    d["pipeline"]["steps"] = 4
    return d


def _port_pod_run(world: int):
    """The port's pod path in this process's group, with every gather
    (the warm-up's first) kept as bytes."""
    gathers = []
    real = train_ingest.make_reassemble

    def watched(pod):
        fn = real(pod)

        def call(staged):
            gathered, csum = fn(staged)
            gathers.append((gathered.cpu().numpy().reshape(-1).tobytes(),
                            int(csum)))
            return gathered, csum

        return call

    train_ingest.make_reassemble = watched
    try:
        cfg, store = convert.from_reference(_pod_dict(), POPULATION)
        res = run_train_ingest(cfg, backend=store, device="cpu")
    finally:
        train_ingest.make_reassemble = real
    return res, gathers


def _pod_rank(rank: int, world: int) -> dict:
    res, gathers = _port_pod_run(world)
    return {"bytes": res.bytes_total, "n_chips": res.n_chips,
            "errors": res.errors, "gathers": gathers,
            "cache": res.extra["pipeline"]["cache"]}


def _check_gathers(gathers: list, blobs: list) -> None:
    assert len(gathers) == len(blobs) + 1  # the warm-up first
    assert not any(gathers[0][0])  # the warm-up's batch is zeros
    for (g, csum), blob in zip(gathers[1:], blobs):
        assert g[: len(blob)] == blob and not any(g[len(blob):])
        assert csum == sum(blob) % (1 << 32)


def test_pod_path_parity(monkeypatch, jax_cpu_devices):
    """Every step's gather equals the step's bytes: ``tpubench`` on its
    8-device mesh, the port at one rank and as a 2-rank gloo group. The
    cache's counters agree; ``n_chips`` is the pod's size in each."""
    import jax
    import tpubench.dist.reassemble as jre
    from tpubench.storage.fake import FakeBackend as JaxFakeBackend
    from tpubench.workloads.train_ingest import run_train_ingest as ref_run

    d = _pod_dict()
    blobs = _step_blobs(build_plan(BenchConfig.from_dict(d),
                                   FakeBackend.from_population(POPULATION)),
                        d["pipeline"]["batch_shards"])
    ref_gathers = []
    real = jre.make_reassemble

    def watched(mesh, axis="pod"):
        fn = real(mesh, axis)

        def call(arr):
            g, csum = fn(arr)
            ref_gathers.append((np.asarray(jax.device_get(g)).reshape(-1)
                                .tobytes(), int(csum)))
            return g, csum

        return call

    monkeypatch.setattr(jre, "make_reassemble", watched)
    ref = ref_run(_reference_config(d),
                  backend=JaxFakeBackend.from_population(POPULATION))
    _check_gathers(ref_gathers, blobs)
    assert ref.n_chips == 8

    with bringup.session(DistConfig(), "cpu", one_rank_group=True):
        one, one_gathers = _port_pod_run(1)
    _check_gathers(one_gathers, blobs)
    assert one.n_chips == 1 and one.errors == ref.errors == 0
    assert one.bytes_total == ref.bytes_total == sum(len(b) for b in blobs)
    assert one.extra["pipeline"]["cache"] == ref.extra["pipeline"]["cache"]

    for r in run_ranks(_pod_rank, 2, timeout=90.0):
        _check_gathers(r["gathers"], blobs)
        assert (r["n_chips"], r["errors"], r["bytes"]) == (
            2, 0, ref.bytes_total)
        assert r["cache"] == ref.extra["pipeline"]["cache"]
