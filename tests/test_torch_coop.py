"""The port's cooperative chunk cache (``tpubench_torch/pipeline/coop.py``,
``dist/peer.py``, ``workloads/arrivals.py``) against ``tpubench``'s.

* Parity on seeded inputs, exact (tolerance 0: integers and bytes): ring
  owners for 4,096 keys at 1, 2, 4 and 8 hosts (also after demote/restore
  and add/remove), Zipf plans and weights, every arrival process, peer
  chunk names, the trace-context lane, ``run_coop_sim``'s pod counters at
  2 and 4 hosts with coop on and off, ``validate_coop_config``'s messages,
  the CLI's coop flags, the scorecard and ``report`` over a coop result.
* The unit cases of ``tests/test_coop.py`` on the port (the modules are
  copies), its acceptance criterion among them.
* Two gloo ranks (``test_torch_dist.run_ranks``, a 60 s deadline and a
  30 s group timeout): ``IciPeerChannel.broadcast`` both ways at four
  sizes, bit-exact, with the owner recovering the follower's trace link;
  ``CoopCache`` over it from both sides; and lockstep ``train-ingest
  --pipeline-pod --readahead 0 --coop --coop-channel ici`` against the
  coop-off arm: every step's gather is the step's bytes, the pod fetches
  each unique chunk from origin once (half the coop-off arm's fetches),
  and each rank's peer hits are the other's owner fetches.

The JAX package is imported inside the tests: the ranks import this
module, and need only torch.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from test_torch_dist import run_ranks
from tpubench_torch import cli, convert
from tpubench_torch.config import BenchConfig, CoopConfig, validate_coop_config
from tpubench_torch.dist.peer import IciPeerChannel, _decode_ctx, _encode_ctx
from tpubench_torch.obs.tracing import TraceContext
from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey
from tpubench_torch.pipeline.coop import (
    PEER_BACKOFF_INITIAL_S,
    PEER_BACKOFF_MAX_S,
    PEER_MAX_ATTEMPTS,
    TRANSFER_SAMPLE_CAP,
    CoopCache,
    HashRing,
    LoopbackBroker,
    LoopbackChannel,
    PeerBackend,
    PeerMissError,
    chunk_point,
    coop_from_config,
    decode_chunk_name,
    encode_chunk_name,
    register_shared_broker,
    run_coop_sim,
    shared_broker,
    wrap_peer_backend,
    zipf_plan,
)
from tpubench_torch.storage.base import ObjectMeta, StorageError
from tpubench_torch.workloads import arrivals, train_ingest
from tpubench_torch.workloads.train_ingest import run_train_ingest

MB = 1024 * 1024
SEED = 11
# The reference's acceptance settings (tests/test_coop.py:646-648).
ACCEPT = dict(n_hosts=4, accesses_per_host=96, alpha=1.2, seed=3,
              slab_pool=True)
SIM_FIELDS = ("origin_bytes_per_pod", "origin_fetches_per_pod",
              "unique_chunks_fetched", "max_origin_fetches_per_chunk")
RANK_DEADLINE_S, GROUP_TIMEOUT_S = 60.0, 30.0


def key(name="o", gen=1, start=0, length=100, bucket="b") -> ChunkKey:
    return ChunkKey(bucket, name, gen, start, length)


def _keys(n: int, length: int = 1024) -> list[ChunkKey]:
    return [
        ChunkKey("b", f"obj_{i // 8}", 1, (i % 8) * length, length)
        for i in range(n)
    ]


def _seeded_keys(n: int, seed: int = SEED) -> list[tuple]:
    """``n`` chunk identities (bucket, object, generation, start, length)
    drawn from a seed, as plain tuples either package's ChunkKey takes."""
    rng = np.random.default_rng(seed)
    return [
        (f"b{int(rng.integers(3))}", f"obj_{int(rng.integers(1 << 20))}",
         int(rng.integers(1, 5)), int(rng.integers(1 << 30)),
         int(rng.integers(1, 1 << 22)))
        for _ in range(n)
    ]


def _owned_by(ring: HashRing, host: int, length: int = 64) -> ChunkKey:
    k = ChunkKey("b", "hot", 1, 0, length)
    while ring.owner(k) != host:
        k = ChunkKey("b", k.object, 1, k.start + length, length)
    return k


# ------------------------------------------------------ parity: hashing ---


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
def test_ring_owner_parity(hosts):
    """Ownership is a pure function of membership: 4,096 seeded keys land
    on the same host in both packages, and still do after a demote, its
    restore, a join and a leave."""
    from tpubench.pipeline.cache import ChunkKey as JKey
    from tpubench.pipeline.coop import HashRing as JRing
    from tpubench.pipeline.coop import chunk_point as j_point

    ids = _seeded_keys(4096)
    port, ref = HashRing(range(hosts)), JRing(range(hosts))

    def same(tag):
        got = [port.owner(ChunkKey(*t)) for t in ids]
        assert got == [ref.owner(JKey(*t)) for t in ids], tag
        return got

    before = same("initial")
    assert [chunk_point(ChunkKey(*t)) for t in ids[:256]] == [
        j_point(JKey(*t)) for t in ids[:256]]
    assert port.demote(hosts - 1) == ref.demote(hosts - 1)
    same("demoted")
    assert port.restore(hosts - 1) == ref.restore(hosts - 1)
    assert same("restored") == before
    port.add_host(hosts)
    ref.add_host(hosts)
    same("joined")
    port.remove_host(0)
    ref.remove_host(0)
    same("left")


def test_ring_join_remaps_about_one_over_n():
    n = 5
    ks = _keys(2000)
    ring = HashRing(range(n))
    before = {k: ring.owner(k) for k in ks}
    grown = HashRing(range(n + 1))
    moved = sum(1 for k in ks if grown.owner(k) != before[k])
    assert moved <= 2.0 * len(ks) / (n + 1)
    for k in ks:  # a join only steals keys, to the new host
        if grown.owner(k) != before[k]:
            assert grown.owner(k) == n


def test_ring_leave_remaps_only_the_leavers_keys():
    n = 5
    ks = _keys(2000)
    full = HashRing(range(n))
    before = {k: full.owner(k) for k in ks}
    shrunk = HashRing(range(n - 1))
    for k in ks:
        if before[k] != n - 1:
            assert shrunk.owner(k) == before[k]
        else:
            assert shrunk.owner(k) != n - 1


def test_ring_demote_restore_returns_exact_original_points():
    ring = HashRing([0, 1, 2])
    ks = _keys(600)
    before = {k: ring.owner(k) for k in ks}
    assert ring.demote(1)
    assert ring.demoted == {1} and ring.active_hosts == {0, 2}
    for k in ks:
        assert ring.owner(k) != 1
        if before[k] != 1:
            assert ring.owner(k) == before[k]
    assert not ring.demote(1)
    assert ring.restore(1)
    assert {k: ring.owner(k) for k in ks} == before
    assert not ring.restore(1)


def test_ring_empty_and_single_host_and_full_identity():
    assert HashRing([]).owner(key()) is None
    ring = HashRing([7])
    assert ring.owner(key()) == 7
    ring.demote(7)
    assert ring.owner(key()) is None
    k = key()
    assert chunk_point(k) == chunk_point(key())
    for other in (key(gen=2), key(start=100), key(bucket="other")):
        assert chunk_point(k) != chunk_point(other)


# -------------------------------------------------- parity: arrivals ---


def _objects(pkg_meta, n=4, size=4 * 1024):
    return [pkg_meta(name=f"o{i}", size=size + 37 * i, generation=1 + i)
            for i in range(n)]


@pytest.mark.parametrize("seed, alpha", [(0, 1.2), (9, 0.8), (12345, 2.0)])
def test_zipf_plan_and_weights_parity(seed, alpha):
    from tpubench.storage.base import ObjectMeta as JMeta
    from tpubench.workloads import arrivals as jarr

    port_objs, ref_objs = _objects(ObjectMeta), _objects(JMeta)
    pk, pw = arrivals.zipf_keys_weights(port_objs, 1024, bucket="bk",
                                        alpha=alpha)
    rk, rw = jarr.zipf_keys_weights(ref_objs, 1024, bucket="bk",
                                    alpha=alpha)
    assert [tuple(k) for k in pk] == [tuple(k) for k in rk]
    assert np.array_equal(pw, rw)
    plan = zipf_plan(port_objs, 1024, 300, alpha=alpha, seed=seed)
    assert [tuple(k) for k in plan] == [
        tuple(k) for k in jarr.zipf_plan(ref_objs, 1024, 300, alpha=alpha,
                                         seed=seed)]
    assert plan == zipf_plan(port_objs, 1024, 300, alpha=alpha, seed=seed)
    with pytest.raises(ValueError, match="empty"):
        zipf_plan([], 1024, 10)


@pytest.mark.parametrize("kind", list(arrivals.ARRIVAL_KINDS))
def test_arrivals_parity(kind):
    """Every arrival process gives ``tpubench``'s timeline for a seed, and
    the replay gaps agree."""
    from tpubench.workloads import arrivals as jarr

    trace = [1.5, 0.5, -1.0, 1.25, 9.0]
    # The burst shapes of tests/test_serve.py: both packages' mmpp loop
    # spins forever where a float boundary step leaves t unchanged (e.g.
    # 120/s over 3 s, fraction 0.3, 0.5 s cycles, seed 0: stuck at
    # t = 1.15), so only shapes the reference's own tests run are used.
    for seed, bf, cycle in ((11, 4.0, 1.0), (12, 8.0, 1.0), (5, 4.0, 0.5)):
        kw = dict(seed=seed, burst_factor=bf, burst_fraction=0.25,
                  burst_cycle_s=cycle, diurnal_period_s=1.5, trace=trace)
        port = arrivals.make_arrivals(kind, 200.0, 2.0, **kw)
        assert port == jarr.make_arrivals(kind, 200.0, 2.0, **kw)
        assert arrivals.scaled_gaps(port, 0.1) == jarr.scaled_gaps(port, 0.1)
        assert port == sorted(port) and all(0 <= t < 2.0 for t in port)
    with pytest.raises(ValueError, match="unknown arrival kind"):
        arrivals.make_arrivals("nope", 1.0, 1.0)
    assert arrivals.poisson_arrivals(0, 1) == []


# ---------------------------------------------- parity: wire formats ---


def test_chunk_name_parity():
    from tpubench.pipeline.cache import ChunkKey as JKey
    from tpubench.pipeline.coop import decode_chunk_name as j_decode
    from tpubench.pipeline.coop import encode_chunk_name as j_encode

    for t in _seeded_keys(64) + [("bkt", "dir/obj.bin", 42, 4096, 1024)]:
        k = ChunkKey(*t)
        name = encode_chunk_name(k)
        assert name == j_encode(JKey(*t))
        assert decode_chunk_name(name, k.start, k.length) == k
        assert tuple(j_decode(name, k.start, k.length)) == t


@pytest.mark.parametrize("sampled", [True, False])
def test_trace_context_lane_parity(sampled):
    """The follower's 25-byte lane is byte for byte ``tpubench``'s, and
    decodes back; a slot under 25 bytes carries no lane."""
    from tpubench.dist.peer import _decode_ctx as j_decode
    from tpubench.dist.peer import _encode_ctx as j_encode
    from tpubench.obs.tracing import TraceContext as JCtx

    rng = np.random.default_rng(SEED)
    for _ in range(8):
        tid = rng.bytes(16).hex()
        sid = rng.bytes(8).hex()
        ours, theirs = np.zeros(128, np.uint8), np.zeros(128, np.uint8)
        _encode_ctx(ours, TraceContext(tid, sid, sampled))
        j_encode(theirs, JCtx(tid, sid, sampled))
        assert ours.tobytes() == theirs.tobytes()
        assert ours[0] == (0xA5 if sampled else 0xA4)
        assert _decode_ctx(ours) == TraceContext(tid, sid, sampled)
        assert j_decode(ours) == JCtx(tid, sid, sampled)
    short = np.zeros(24, np.uint8)
    _encode_ctx(short, TraceContext("a" * 32, "b" * 16))
    assert not short.any() and _decode_ctx(short) is None
    assert _decode_ctx(np.zeros(128, np.uint8)) is None


# --------------------------------------------------- parity: the sim ---


@pytest.mark.parametrize("coop", [True, False], ids=["coop", "per_host"])
@pytest.mark.parametrize("n_hosts", [2, 4])
def test_sim_parity(n_hosts, coop):
    """``run_coop_sim`` at the acceptance settings: the pod's origin bytes
    and fetches, unique chunks, the most fetches of one chunk and the peer
    requests equal ``tpubench``'s."""
    from tpubench.pipeline.coop import run_coop_sim as ref_sim

    kw = {**ACCEPT, "n_hosts": n_hosts, "coop": coop}
    port, ref = run_coop_sim(device="cpu", **kw), ref_sim(**kw)
    assert not port["errors"] and not ref["errors"]
    for f in SIM_FIELDS:
        assert port[f] == ref[f], f
    assert (port["peer_hits"] + port["peer_misses"]
            == ref["peer_hits"] + ref["peer_misses"])
    assert port["copies_per_byte_ok"] and port["seconds"] > 0
    assert port["backend_opens"] == port["origin_fetches_per_pod"]


def test_acceptance_coop_vs_per_host_ab_zipf_pod():
    """``tests/test_coop.py``'s acceptance criterion on the port: >= 40%
    fewer origin bytes, one origin fetch per chunk, every peer request
    served, and <= 1.0 copies a byte through the slab pool."""
    coop = run_coop_sim(coop=True, device="cpu", **ACCEPT)
    base = run_coop_sim(coop=False, device="cpu", **ACCEPT)
    assert not coop["errors"] and not base["errors"]
    drop = 1.0 - coop["origin_bytes_per_pod"] / base["origin_bytes_per_pod"]
    assert drop >= 0.40, drop
    assert coop["max_origin_fetches_per_chunk"] == 1
    assert base["max_origin_fetches_per_chunk"] >= 2
    assert coop["peer_hits"] > 0 and coop["peer_hit_ratio"] == 1.0
    assert coop["copies_per_byte_ok"] and base["copies_per_byte_ok"]
    assert all(h["copies"]["copies_per_byte"] <= 1.0 for h in coop["per_host"])


def test_sim_straggler_delay_and_device():
    res = run_coop_sim(n_hosts=2, accesses_per_host=24, seed=2,
                       host_delay_s={0: 0.01, 1: 0.01}, device="cpu")
    assert not res["errors"]
    p50s = [h["coop"]["transfer_p50_ms"] for h in res["per_host"]
            if h["coop"]["transfer_p50_ms"] is not None]
    assert p50s and all(p >= 10.0 for p in p50s)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run_coop_sim(n_hosts=2, accesses_per_host=4)


# ------------------------------------------------------- peer backend ---


class _FlakyChannel:
    """PeerChannel double: fails transiently ``fail`` times, then
    serves ``data``."""

    lockstep = False

    def __init__(self, host_id: int, data: bytes, fail: int = 0,
                 miss: bool = False):
        self.host_id = host_id
        self._data = data
        self._fail = fail
        self._miss = miss
        self.requests = 0

    def request(self, owner: int, k: ChunkKey) -> bytes:
        self.requests += 1
        if self._miss:
            raise PeerMissError("owner shed")
        if self._fail > 0:
            self._fail -= 1
            raise StorageError("peer channel flake", transient=True, code=503)
        return self._data

    def close(self) -> None:
        pass


def _retry_cfg():
    r = BenchConfig().transport.retry
    r.policy, r.max_attempts = "always", 4
    r.initial_backoff_s = r.max_backoff_s = 0.0
    return r


def _remote_key(ring: HashRing, length: int = 8) -> ChunkKey:
    return _owned_by(ring, 1, length)


def test_peer_backend_composes_under_retry():
    ring = HashRing([0, 1])
    k = _remote_key(ring)
    ch = _FlakyChannel(0, b"x" * 8, fail=2)
    be = wrap_peer_backend(ch, ring, _retry_cfg())
    r = be.open_read(encode_chunk_name(k), start=k.start, length=k.length)
    buf = bytearray(8)
    assert r.readinto(memoryview(buf)) == 8 and bytes(buf) == b"x" * 8
    assert ch.requests == 3


def test_peer_miss_is_non_transient_and_surfaces_immediately():
    ring = HashRing([0, 1])
    k = _remote_key(ring)
    ch = _FlakyChannel(0, b"", miss=True)
    with pytest.raises(PeerMissError) as ei:
        wrap_peer_backend(ch, ring, _retry_cfg()).open_read(
            encode_chunk_name(k), start=k.start, length=k.length)
    assert not ei.value.transient and ei.value.code == 404
    assert ch.requests == 1


def test_peer_backend_short_serve_is_transient():
    ring = HashRing([0, 1])
    k = _remote_key(ring)
    with pytest.raises(StorageError) as ei:
        PeerBackend(_FlakyChannel(0, b"xy"), ring).open_read(
            encode_chunk_name(k), start=k.start, length=k.length)
    assert ei.value.transient


def test_peer_retry_attempts_and_backoff_are_bounded():
    ring = HashRing([0, 1])
    k = _remote_key(ring)
    cfg = _retry_cfg()
    cfg.max_attempts = 0  # the gax default: retry forever
    ch = _FlakyChannel(0, b"x" * 8, fail=10**6)
    with pytest.raises(StorageError):
        wrap_peer_backend(ch, ring, cfg).open_read(
            encode_chunk_name(k), start=k.start, length=k.length)
    assert ch.requests == PEER_MAX_ATTEMPTS
    gax = BenchConfig().transport.retry  # 1 s / 30 s
    be = wrap_peer_backend(_FlakyChannel(0, b"x"), ring, gax)
    assert be.retry.initial_backoff_s == PEER_BACKOFF_INITIAL_S
    assert be.retry.max_backoff_s == PEER_BACKOFF_MAX_S
    be = wrap_peer_backend(_FlakyChannel(0, b"x"), ring, _retry_cfg())
    assert be.retry.initial_backoff_s == be.retry.max_backoff_s == 0.0
    never = BenchConfig().transport.retry
    never.policy = "never"
    assert isinstance(wrap_peer_backend(_FlakyChannel(0, b""), ring, never),
                      PeerBackend)


def test_peer_backend_self_owned_key_and_serving_owner():
    be = PeerBackend(_FlakyChannel(0, b""), HashRing([0]))
    k = key(length=8)
    with pytest.raises(PeerMissError):
        be.open_read(encode_chunk_name(k), start=k.start, length=k.length)
    with pytest.raises(ValueError, match="length"):
        be.open_read(encode_chunk_name(k))
    ring = HashRing([0, 1])
    k = _remote_key(ring)
    be = PeerBackend(_FlakyChannel(0, b"x" * 8), ring)
    assert be.last_serving_owner() is None
    be.open_read(encode_chunk_name(k), start=k.start, length=k.length)
    assert be.last_serving_owner() == 1
    with pytest.raises(StorageError):
        be.write("n", b"")
    assert be.list() == []


def test_loopback_broker_routes_sheds_pauses_and_pushes():
    broker = LoopbackBroker()
    served, accepted = [], []
    broker.register(1, lambda k: served.append(k) or b"z" * k.length,
                    accept=lambda k, d, o: accepted.append((k, o)) or True)
    ch = LoopbackChannel(broker, 0)
    assert ch.request(1, key(length=4)) == b"zzzz" and len(served) == 1
    with pytest.raises(PeerMissError):
        ch.request(9, key())  # never registered: definitive
    broker.register(2, lambda k: None)
    with pytest.raises(PeerMissError):
        ch.request(2, key())  # shedding owner
    broker.pause(1)
    with pytest.raises(StorageError) as ei:
        ch.request(1, key())
    assert ei.value.transient and ei.value.code == 503
    assert not broker.push(0, 1, key(), b"d")  # paused: bounced
    broker.resume(1)
    assert broker.push(0, 1, key(), b"d", owner="gold")
    assert accepted == [(key(), "gold")]
    assert not broker.push(0, 2, key(), b"d")  # no accept registered
    ch.close()  # unregisters host 0 only
    assert ch.request(1, key(length=1)) == b"z"


# ------------------------------------------------------- CoopCache ---


def _pod(n_hosts: int, origin, **kw):
    broker = LoopbackBroker()
    ring = HashRing(range(n_hosts))
    coops = []
    for h in range(n_hosts):
        cc = CoopCache(ChunkCache(64 * MB), host_id=h, ring=ring,
                       channel=LoopbackChannel(broker, h),
                       origin_fetch=origin, **kw)
        broker.register(h, cc.serve, accept=cc.accept_handoff)
        coops.append(cc)
    return broker, ring, coops


def _origin(log=None, fill=b"d"):
    def origin(k: ChunkKey) -> bytes:
        if log is not None:
            log.append(k)
        return fill * k.length

    return origin


def test_follower_miss_resolves_over_peer_channel():
    fetches = []
    _, ring, coops = _pod(2, _origin(fetches))
    k = _owned_by(ring, 1)
    assert coops[0].fetch(k) == b"d" * k.length
    assert len(fetches) == 1
    s0, s1 = coops[0].stats(), coops[1].stats()
    assert (s0["peer_requests"], s0["peer_hits"], s0["peer_hit_ratio"],
            s0["peer_bytes"], s0["origin_fetches"]) == (1, 1, 1.0, k.length, 0)
    assert s1["peer_serves"] == 1 and s1["owner_fetches"] == 1
    assert coops[0].fetch(k) == b"d" * k.length  # a serve-side cache hit
    assert len(fetches) == 1


def test_owner_disabled_and_single_host_fetch_origin():
    fetches = []
    _, ring, coops = _pod(2, _origin(fetches))
    assert coops[0].fetch(_owned_by(ring, 0)) == b"d" * 64
    s = coops[0].stats()
    assert s["owner_fetches"] == 1 and s["peer_requests"] == 0
    _, ring, coops = _pod(2, _origin(fetches), enabled=False)
    k = _owned_by(ring, 1)
    coops[0].fetch(k)
    assert coops[0].stats()["peer_requests"] == 0
    assert coops[1].serve(k) is None  # disabled hosts shed
    for c in coops:
        c.set_enabled(True)  # the `coop` tune knob
    coops[0].fetch(_owned_by(ring, 1, length=32))
    assert coops[0].stats()["peer_requests"] == 1
    _, _, (one,) = _pod(1, _origin())
    one.fetch(key(length=16))
    s = one.stats()
    assert s["peer_requests"] == 0 and s["origin_fetches"] == 1


def test_peer_miss_falls_back_to_origin_and_serve_errors_shed():
    _, ring, coops = _pod(2, _origin(), peer_budget_bytes=8)
    k = _owned_by(ring, 1, length=64)  # 64 B ask > 8 B serve budget
    assert coops[0].fetch(k) == b"d" * 64
    s0, s1 = coops[0].stats(), coops[1].stats()
    assert (s0["peer_misses"], s0["peer_hits"], s0["origin_fetches"]) == (
        1, 0, 1)
    assert s1["budget_rejects"] == 1 and s1["peer_serves"] == 0
    coops[1].set_peer_budget(MB)  # the peer_budget_bytes tune knob
    assert coops[1].peer_budget_bytes == MB
    coops[0].fetch(_owned_by(ring, 1, length=32))
    assert coops[0].stats()["peer_hits"] == 1

    def down(k):
        raise RuntimeError("origin down")

    _, ring, coops = _pod(2, down)
    assert coops[1].serve(_owned_by(ring, 1)) is None
    assert coops[1].stats()["serve_errors"] == 1


def test_pod_wide_single_flight_concurrent_misses_one_origin_fetch():
    n_hosts = 3
    counts: dict = {}
    ledger, release = threading.Lock(), threading.Event()

    def origin(k):
        with ledger:
            counts[k] = counts.get(k, 0) + 1
        release.wait(5.0)
        return b"d" * k.length

    _, ring, coops = _pod(n_hosts, origin)
    k = _owned_by(ring, 0)
    results = [None] * n_hosts
    barrier = threading.Barrier(n_hosts + 1)

    def run_host(i):
        barrier.wait()
        results[i] = coops[i].cache.get_or_fetch(k, lambda: coops[i].fetch(k))

    threads = [threading.Thread(target=run_host, args=(i,))
               for i in range(n_hosts)]
    for t in threads:
        t.start()
    barrier.wait()
    time.sleep(0.1)
    release.set()
    for t in threads:
        t.join(10.0)
    assert all(r == b"d" * k.length for r in results)
    assert counts == {k: 1}
    assert coops[0].stats()["peer_serves"] == n_hosts - 1
    assert sum(c.stats()["pod_coalesced"] for c in coops) >= 1


def test_apply_straggler_table_demotes_and_restores():
    _, ring, coops = _pod(3, _origin())
    out = coops[0].apply_straggler_table([
        {"host": 1, "tail_share": 0.9, "p99_ms": 50.0},
        {"host": 0, "tail_share": 0.1, "p99_ms": 1.0},
        {"host": 2, "tail_share": 0.0, "p99_ms": 1.0},
    ])
    assert out == {"demoted": [1], "restored": []} and ring.demoted == {1}
    assert all(ring.owner(k) != 1 for k in _keys(300))
    assert coops[1].serve(_owned_by(HashRing([1]), 1)) is None
    out = coops[0].apply_straggler_table(
        [{"host": h, "tail_share": 0.33, "p99_ms": 1.0} for h in range(3)])
    assert out == {"demoted": [], "restored": [1]} and ring.demoted == set()
    s = coops[0].stats()
    assert s["demotions"] == 1 and s["restores"] == 1
    # One host owning the whole tail of a one-row table is no straggler.
    assert coops[0].apply_straggler_table(
        [{"host": 0, "tail_share": 1.0}]) == {"demoted": [], "restored": []}


def test_maybe_refresh_demotions_is_rate_limited():
    now, calls = [0.0], []

    class _Flight:
        def records(self):
            calls.append(1)
            return []

    cc = CoopCache(ChunkCache(MB), host_id=0, ring=HashRing([0, 1]),
                   channel=LoopbackChannel(LoopbackBroker(), 0),
                   origin_fetch=_origin(), demote_interval_s=2.0,
                   clock=lambda: now[0])
    fl = _Flight()
    cc.maybe_refresh_demotions(fl)
    assert not calls
    now[0] = 2.5
    cc.maybe_refresh_demotions(fl)
    cc.maybe_refresh_demotions(fl)
    assert len(calls) == 1
    now[0] = 5.0
    cc.maybe_refresh_demotions(fl)
    assert len(calls) == 2


def test_routed_fetch_phases_and_demotion_records():
    from tpubench_torch.obs.flight import FlightRecorder, monotone

    flight = FlightRecorder()
    wf = flight.worker("w0")
    _, ring, coops = _pod(2, _origin())
    k_hit = _owned_by(ring, 1)
    op = wf.begin(k_hit.object, "peer")
    with op:
        coops[0].fetch(k_hit)
        op.finish(k_hit.length)
    coops[1].set_enabled(False)
    k_miss = _owned_by(ring, 1, length=32)
    op = wf.begin(k_miss.object, "peer")
    with op:
        coops[0].fetch(k_miss)
        op.finish(k_miss.length)
    hit, miss = flight.records()
    assert {"peer_request", "peer_hit"} <= set(hit["phases"])
    assert "peer_miss" not in hit["phases"]
    assert {"peer_request", "peer_miss"} <= set(miss["phases"])
    assert "peer_hit" not in miss["phases"]
    assert monotone(hit) and monotone(miss)

    flight = FlightRecorder()
    cc = CoopCache(ChunkCache(MB), host_id=0, ring=HashRing([0, 1, 2]),
                   channel=LoopbackChannel(LoopbackBroker(), 0),
                   origin_fetch=_origin(), flight_ring=flight.worker("coop"))
    cc.apply_straggler_table([{"host": 2, "tail_share": 0.8},
                              {"host": 0, "tail_share": 0.1}])
    cc.apply_straggler_table([{"host": h, "tail_share": 0.3}
                              for h in range(3)])
    notes = [n for r in flight.records() for n in r.get("notes", ())
             if n.get("kind") == "coop"]
    assert [(n["event"], n["host"]) for n in notes] == [
        ("demote", 2), ("restore", 2)]


def test_local_transfer_rows_demote_a_slow_owner():
    from tpubench_torch.obs.flight import FlightRecorder

    now = [0.0]
    broker = LoopbackBroker()
    ring = HashRing(range(3))
    coops = []
    for h in range(3):
        cc = CoopCache(ChunkCache(64 * MB), host_id=h, ring=ring,
                       channel=LoopbackChannel(broker, h),
                       origin_fetch=_origin(), demote_interval_s=1.0,
                       clock=lambda: now[0])
        broker.register(h, cc.serve, delay_s=0.005 if h == 1 else 0.0)
        coops.append(cc)
    pulled, start = {1: 0, 2: 0}, 0
    while min(pulled.values()) < 12:
        k = ChunkKey("b", "o", 1, start, 64)
        start += 64
        if ring.owner(k) in pulled:
            coops[0].fetch(k)
            pulled[ring.owner(k)] += 1
    by_host = {r["host"]: r for r in coops[0]._local_transfer_rows()}
    assert by_host[1]["tail_share"] >= 0.5 and by_host[2]["tail_share"] < 0.5
    now[0] = 2.0
    coops[0].maybe_refresh_demotions(FlightRecorder())
    assert ring.demoted == {1} and coops[0].stats()["demotions"] == 1
    assert all(o != 1 for o, _ in coops[0]._transfer_ns)
    now[0] = 4.0
    coops[0].maybe_refresh_demotions(FlightRecorder())
    assert ring.demoted == set() and coops[0].stats()["restores"] == 1
    assert coops[0]._transfer_ns.maxlen == TRANSFER_SAMPLE_CAP


def test_per_host_estimate_excludes_serve_driven_owner_fetches():
    _, ring, coops = _pod(2, _origin(fill=b"e"))
    k = _owned_by(ring, 0, length=256)
    coops[1].fetch(k)
    s0, s1 = coops[0].stats(), coops[1].stats()
    assert s0["origin_bytes"] == s0["serve_origin_bytes"] == 256
    assert s0["per_host_origin_estimate_bytes"] == 0
    assert s1["peer_bytes"] == s1["per_host_origin_estimate_bytes"] == 256


def test_warm_handoff_drains_to_new_owners():
    """A departing host hands its hot set to each chunk's new owner; the
    next miss there is a local hit. Purging a departed host's samples
    leaves the others'."""
    broker, ring, coops = _pod(3, _origin())
    ks = [_owned_by(ring, 2, length=64 + i) for i in range(4)]
    for k in ks:
        coops[2].cache.get_or_fetch(k, lambda k=k: coops[2].fetch(k))
    after = HashRing([0, 1])
    out = coops[2].drain_hot_set(
        lambda h, k, d, tag: broker.push(2, h, k, d, tag), after.owner)
    assert out == {"chunks": 4, "bytes": sum(k.length for k in ks),
                   "rejected": 0, "skipped": 0}
    landed = sum(c.stats()["handoff_in_chunks"] for c in coops[:2])
    assert landed == 4
    for k in ks:
        assert coops[after.owner(k)].cache.get(k) == b"d" * k.length
    assert not coops[0].accept_handoff(key(length=5), b"xx")  # wrong size
    coops[0]._transfer_ns.extend([(1, 5), (2, 6)])
    coops[0].purge_host_samples(1)
    assert list(coops[0]._transfer_ns) == [(2, 6)]
    coops[0].reset_member_state()
    assert not coops[0]._transfer_ns


def test_prefetcher_routes_misses_through_fetch_fn():
    from tpubench_torch.pipeline.prefetch import Prefetcher
    from tpubench_torch.storage.fake import FakeBackend

    backend = FakeBackend.prepopulated(prefix="p/o_", count=2, size=4096)
    plan = [ChunkKey("", m.name, m.generation, 0, 4096)
            for m in backend.list("p/o_")]
    routed = []

    def fetch_fn(k):
        routed.append(k)
        return b"r" * k.length

    cache = ChunkCache(MB)
    pf = Prefetcher(backend, cache, plan, depth=2, fetch_fn=fetch_fn)
    pf.advance(0)
    deadline = time.monotonic() + 5.0
    while len(routed) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    pf.close()
    assert sorted(r.object for r in routed) == sorted(k.object for k in plan)
    assert cache.get(plan[0]) == b"r" * 4096


# -------------------------------------------------- config, CLI, build ---


_BAD = [("hosts", -1), ("host_id", -2), ("vnodes", 0),
        ("peer_budget_bytes", -1), ("channel", "dcn"), ("demote_share", 0.0),
        ("demote_share", 1.5), ("demote_share", float("nan")),
        ("demote_interval_s", 0.0)]


def test_validate_coop_config_parity():
    """Every bad value is refused with ``tpubench``'s one-line text."""
    from tpubench.config import CoopConfig as JCoop
    from tpubench.config import validate_coop_config as j_validate

    cases = [{f: v} for f, v in _BAD] + [{"hosts": 2, "host_id": 2}]
    for bad in cases:
        with pytest.raises(SystemExit) as ours:
            validate_coop_config(CoopConfig(**bad))
        with pytest.raises(SystemExit) as theirs:
            j_validate(JCoop(**bad))
        assert str(ours.value) == str(theirs.value), bad
    validate_coop_config(CoopConfig())
    validate_coop_config(CoopConfig(hosts=4, host_id=3, channel="ici"))
    assert BenchConfig().to_dict()["coop"] == {
        **JCoop().__dict__}


def test_cli_coop_flags_fold_like_tpubench(tmp_path):
    from tpubench.cli import main as j_main
    from tpubench.config import BenchConfig as JBenchConfig

    flags = ["--coop", "--coop-hosts", "4", "--coop-host-id", "2",
             "--coop-vnodes", "16", "--peer-budget-bytes", "1048576",
             "--coop-channel", "loopback", "--no-coop-demote"]
    theirs = tmp_path / "theirs.json"
    assert j_main(["read", "--protocol", "fake", *flags,
                   "--save-config", str(theirs)]) == 0
    ref = JBenchConfig.from_json(theirs.read_text())
    cfg = cli.build_config(cli.build_parser().parse_args(
        ["train-ingest", "--protocol", "fake", *flags]))
    assert cfg.to_dict()["coop"] == ref.to_dict()["coop"]
    assert BenchConfig.from_json(theirs.read_text()).coop == cfg.coop
    assert (cfg.coop.enabled, cfg.coop.hosts, cfg.coop.host_id,
            cfg.coop.vnodes, cfg.coop.peer_budget_bytes, cfg.coop.channel,
            cfg.coop.demote) == (True, 4, 2, 16, 1 << 20, "loopback", False)
    with pytest.raises(SystemExit) as ei:
        cli.main(["read", "--protocol", "fake", "--coop", "--coop-hosts",
                  "2", "--coop-host-id", "5"])
    assert "outside the pod" in str(ei.value)


def test_coop_from_config_off_degenerate_and_multihost_loopback():
    cfg = BenchConfig()
    cache = ChunkCache(MB)
    assert coop_from_config(cfg, cache, lambda k: b"") is None
    cfg.coop.enabled = True  # a pod of one: built, routes nothing
    coop = coop_from_config(cfg, cache, lambda k: b"x" * 16)
    assert coop.host_id == 0 and len(coop.ring.hosts) == 1
    assert coop.fetch(key(length=16)) == b"x" * 16
    assert coop.stats()["peer_requests"] == 0 and not coop.lockstep
    coop.close()
    cfg.dist.num_processes, cfg.dist.process_id = 4, 2
    with pytest.raises(SystemExit) as ei:
        coop_from_config(cfg, ChunkCache(MB), lambda k: b"y" * 8)
    msg = str(ei.value)
    assert "loopback channel cannot reach" in msg
    assert "--coop-channel ici" in msg and "shared pod fabric" in msg
    broker = LoopbackBroker()
    register_shared_broker(broker)
    try:
        assert shared_broker() is broker
        coops = []
        for h in range(4):
            cfg.dist.process_id = h
            coops.append(coop_from_config(cfg, ChunkCache(MB),
                                          lambda k: b"s" * k.length))
        k = _owned_by(coops[0].ring, 3)
        assert coops[0].fetch(k) == b"s" * k.length
        assert coops[0].stats()["peer_hits"] == 1
    finally:
        register_shared_broker(None)
    assert shared_broker() is None


def test_ici_channel_needs_a_group():
    """``coop.channel="ici"`` with no joined group raises at the build."""
    cfg = BenchConfig()
    cfg.coop.enabled, cfg.coop.channel = True, "ici"
    with pytest.raises(RuntimeError, match="no process group joined"):
        coop_from_config(cfg, ChunkCache(MB), lambda k: b"", device="cpu")


def test_ici_channel_at_one_rank():
    """At world size 1 every broadcast is the rank's own, bit-exact; a
    host outside the group raises (``tpubench``'s one-process mesh maps
    host h to slot h % 8 instead: the known difference); request is not
    a lockstep operation."""
    from tpubench_torch.config import DistConfig
    from tpubench_torch.dist import bringup

    with bringup.session(DistConfig(), "cpu", one_rank_group=True):
        ch = IciPeerChannel(device="cpu")
        assert ch.lockstep and ch.host_id == 0
        for n in (128, 1000, 4096):
            data = bytes(np.random.default_rng(n).integers(0, 256, n,
                                                           dtype=np.uint8))
            assert ch.broadcast(0, data, key(length=n)) == data
        assert ch.stats() == {"broadcasts": 3, "broadcast_bytes": 5224,
                              "mesh_devices": 1, "multiprocess": False}
        with pytest.raises(ValueError, match="outside the pod"):
            ch.broadcast(1, None, key(length=8))
        with pytest.raises(ValueError, match="outside the pod"):
            IciPeerChannel(host_id=2, device="cpu")
        with pytest.raises(ValueError, match="contributed no data"):
            ch.broadcast(0, None, key(length=8))
        with pytest.raises(NotImplementedError):
            ch.request(0, key(length=8))
        ch.close()


# ------------------------------------------------- train-ingest + tune ---


def _ti_cfg(**pipe) -> BenchConfig:
    cfg = BenchConfig()
    cfg.workload.workers = 2
    cfg.workload.object_size = 256 * 1024
    cfg.workload.granule_bytes = 64 * 1024
    cfg.transport.protocol = "fake"
    cfg.staging.mode = "none"
    cfg.obs.export = "none"
    cfg.pipeline.steps = 4
    cfg.pipeline.batch_shards = 2
    for k, v in pipe.items():
        setattr(cfg.pipeline, k, v)
    cfg.coop.enabled = True
    return cfg


def test_train_ingest_coop_stamp_scorecard_and_report(tmp_path):
    """Coop through the workload at one process: the stamp has
    ``tpubench``'s keys, a pod of one routes nothing, ``report`` prints
    ``coop: hosts=1/1`` in both packages' words."""
    from tpubench.config import BenchConfig as JBenchConfig
    from tpubench.workloads.report_cmd import run_report as j_report
    from tpubench.workloads.train_ingest import run_train_ingest as j_run
    from tpubench_torch.metrics.report import write_result
    from tpubench_torch.workloads.report_cmd import run_report

    cfg = _ti_cfg()
    res = run_train_ingest(cfg, device="cpu")
    ref = j_run(JBenchConfig.from_dict(cfg.to_dict()))
    co, jco = res.extra["pipeline"]["coop"], ref.extra["pipeline"]["coop"]
    assert set(co) == set(jco)
    assert co["enabled"] and co["hosts"] == 1 and co["peer_requests"] == 0
    assert co["origin_fetches"] == jco["origin_fetches"] > 0
    pipe = res.extra["pipeline"]
    assert co["origin_fetches"] == (pipe["cache"]["misses"]
                                    + pipe["prefetch"]["completed"])
    path = write_result(res, str(tmp_path), tag="coop")
    out = run_report([path])
    assert "coop: hosts=1/1" in out and out == j_report([path])


def test_train_ingest_coop_readahead_routes_through_coop():
    res = run_train_ingest(_ti_cfg(readahead=4), device="cpu")
    pipe = res.extra["pipeline"]
    assert res.errors == 0 and pipe["prefetch"]["errors"] == 0
    assert pipe["coop"]["origin_fetches"] == pipe["plan"]["unique_chunks"]
    assert pipe["copies"]["copies_per_byte"] == 1.0


def test_train_ingest_rejects_lockstep_with_async_consumers():
    cfg = _ti_cfg(readahead=2)
    cfg.coop.channel = "ici"
    with pytest.raises(SystemExit, match="lockstep"):
        run_train_ingest(cfg, device="cpu")
    cfg.pipeline.readahead, cfg.pipeline.pod = 0, False
    with pytest.raises(SystemExit, match="lockstep"):
        run_train_ingest(cfg, device="cpu")


def test_sweep_axes_and_controller_coop_knobs():
    from tpubench_torch.metrics.recorder import LatencyRecorder
    from tpubench_torch.workloads.tune_cmd import sweep_axes

    cfg = BenchConfig()
    cfg.tune.knobs = ["coop", "peer_budget_bytes"]
    assert sweep_axes(cfg, "train-ingest") == {}
    cfg.coop.enabled, cfg.coop.peer_budget_bytes = True, 1 << 20
    axes = sweep_axes(cfg, "train-ingest")
    assert axes["coop"] == [0, 1]
    assert axes["peer_budget_bytes"] == [1 << 19, 1 << 20, 1 << 21, 1 << 22]
    assert sweep_axes(cfg, "read") == {}
    cfg.coop.channel = "ici"
    assert sweep_axes(cfg, "train-ingest") == {}

    class _Coop:
        peer_budget_bytes, enabled = 1 << 20, True

        def __init__(self, lockstep):
            self.lockstep = lockstep

        def set_peer_budget(self, v):
            pass

        def set_enabled(self, v):
            pass

    cfg.tune.enabled = True
    args = (cfg, LatencyRecorder("read"), lambda: 0, None, None, 8, None)
    build = train_ingest._build_train_ingest_controller
    assert build(*args, coop=_Coop(lockstep=True)) is None
    ctl = build(*args, coop=_Coop(lockstep=False))
    assert ctl is not None


def test_tune_sweep_over_coop_train_ingest():
    """``tune --tune-workload train-ingest`` sweeps the coop axes and runs
    every cell (cells at coop=0 are the per-host arm)."""
    from tpubench_torch.workloads import tune_cmd

    cfg = _ti_cfg(readahead=2)
    cfg.coop.peer_budget_bytes = 256 * 1024
    cfg.tune.knobs = ["coop", "peer_budget_bytes"]
    res = tune_cmd.run_tune(cfg, mode="sweep", workload="train-ingest",
                            device="cpu")
    sw = res.extra["tune"]["sweep"]
    assert set(sw["axes"]) == {"coop", "peer_budget_bytes"}
    assert all(c["errors"] == 0 and c["goodput_bps"] > 0 for c in sw["cells"])


def test_read_coop_flag_prints_noop_notice(tmp_path, capsys):
    rc = cli.main(["read", "--protocol", "fake", "--coop", "--workers", "1",
                   "--read-call-per-worker", "1", "--object-size", "65536",
                   "--staging", "none", "--device", "cpu",
                   "--results-dir", str(tmp_path)])
    assert rc == 0
    assert "--coop has no effect" in capsys.readouterr().err


# --------------------------------------------------------- two ranks ---

TRACE = TraceContext("0123456789abcdef" * 2, "fedcba9876543210", True)


def _channel_cases(rank: int, world: int) -> dict:
    """Broadcasts both ways at four sizes, the follower's trace context in
    its lane, then CoopCache over the channel with ring [0, 1]."""
    out = {"echo": [], "links": [], "cache": None}
    ch = IciPeerChannel(device="cpu")
    for owner in (0, 1):
        for n in (128, 1000, 4096, 64 * 1024):
            data = np.random.default_rng(owner * 100_000 + n).integers(
                0, 256, n, dtype=np.uint8).tobytes()
            k = ChunkKey("b", f"o{owner}", 1, 0, n)
            mine = owner == rank
            got = ch.broadcast(owner, data if mine else None, k,
                               ctx=None if mine else TRACE)
            out["echo"].append(got == data)
            if mine:
                out["links"].append(ch.last_request_links())
    # Every rank owns its own slot here, so every rank raises before the
    # collective: no rank is left waiting in it.
    try:
        ch.broadcast(rank, None, ChunkKey("b", "o", 1, 0, 8))
    except ValueError as e:
        out["no_data"] = str(e)
    try:
        ch.request(0, ChunkKey("b", "o", 1, 0, 8))
    except NotImplementedError as e:
        out["request"] = str(e)
    out["stats"] = ch.stats()

    fetches = []
    ring = HashRing([0, 1])
    cc = CoopCache(ChunkCache(MB), host_id=rank, ring=ring,
                   channel=IciPeerChannel(device="cpu"),
                   origin_fetch=_origin(fetches, fill=b"L"))
    k0, k1 = _owned_by(ring, 0, length=256), _owned_by(ring, 1, length=200)
    got = [bytes(cc.fetch(k)) for k in (k0, k1)]
    out["cache"] = {"got": [g == b"L" * len(g) for g in got],
                    "lengths": [len(g) for g in got],
                    "fetches": [tuple(f) for f in fetches],
                    "stats": cc.stats(),
                    "broadcasts": cc._channel.stats()["broadcasts"]}
    cc.close()
    return out


@pytest.fixture(scope="module")
def channel_ranks():
    return run_ranks(_channel_cases, 2, timeout=RANK_DEADLINE_S,
                     pg_timeout_s=GROUP_TIMEOUT_S)


def test_ici_channel_broadcast_two_ranks(channel_ranks):
    for rank, r in enumerate(channel_ranks):
        assert r["echo"] == [True] * 8, rank
        # The owner recovers the follower's context from its lane.
        assert r["links"] == [[TRACE]] * 4, rank
        assert "contributed no data" in r["no_data"]
        assert "lockstep-only" in r["request"]
        assert r["stats"] == {"broadcasts": 8,
                              "broadcast_bytes": 2 * (128 + 1000 + 4096
                                                      + 64 * 1024),
                              "mesh_devices": 2, "multiprocess": True}


def test_coop_lockstep_owner_and_follower_paths(channel_ranks):
    """``tests/test_coop.py::test_coop_lockstep_owner_path_counts`` with
    the follower side: each chunk comes from origin once, on its owner,
    and reaches the follower through the broadcast."""
    c0, c1 = (r["cache"] for r in channel_ranks)
    for rank, c in enumerate((c0, c1)):
        assert c["got"] == [True, True] and c["lengths"] == [256, 200]
        assert c["broadcasts"] == 2
        s = c["stats"]
        assert (s["owner_fetches"], s["origin_fetches"], s["peer_requests"],
                s["peer_hits"], s["peer_bytes"]) == (
            1, 1, 1, 1, 200 if rank == 0 else 256), rank
        assert s["peer_hit_ratio"] == 1.0
    assert [f[4] for f in c0["fetches"]] == [256]
    assert [f[4] for f in c1["fetches"]] == [200]


def _lockstep_train(rank: int, world: int) -> dict:
    """The pod path of ``test_torch_pipeline.test_pod_path_parity`` with
    coop on the ici channel, and the same run with coop off."""
    from test_torch_pipeline import POPULATION, _pod_dict

    out = {}
    for arm in ("off", "ici"):
        gathers = []
        real = train_ingest.make_reassemble

        def watched(pod, real=real, gathers=gathers):
            fn = real(pod)

            def call(staged):
                gathered, csum = fn(staged)
                gathers.append((gathered.numpy().reshape(-1).tobytes(),
                                int(csum)))
                return gathered, csum

            return call

        cfg, store = convert.from_reference(_pod_dict(), POPULATION)
        cfg.dist.num_processes, cfg.dist.process_id = world, rank
        if arm == "ici":
            cfg.coop.enabled, cfg.coop.channel = True, "ici"
            cfg.coop.hosts = world
        train_ingest.make_reassemble = watched
        try:
            res = run_train_ingest(cfg, backend=store, device="cpu")
        finally:
            train_ingest.make_reassemble = real
        out[arm] = {"gathers": gathers, "opens": store.open_count,
                    "errors": res.errors, "bytes": res.bytes_total,
                    "plan": res.extra["pipeline"]["plan"],
                    "coop": res.extra["pipeline"].get("coop")}
    return out


@pytest.fixture(scope="module")
def lockstep_ranks():
    return run_ranks(_lockstep_train, 2, timeout=RANK_DEADLINE_S,
                     pg_timeout_s=GROUP_TIMEOUT_S)


def test_lockstep_train_ingest_gathers_every_step(lockstep_ranks):
    from test_torch_pipeline import POPULATION, _check_gathers, _pod_dict, \
        _step_blobs
    from tpubench_torch.storage.fake import FakeBackend
    from tpubench_torch.workloads.train_ingest import build_plan

    d = _pod_dict()
    blobs = _step_blobs(build_plan(BenchConfig.from_dict(d),
                                   FakeBackend.from_population(POPULATION)),
                        d["pipeline"]["batch_shards"])
    for r in lockstep_ranks:
        for arm in ("off", "ici"):
            _check_gathers(r[arm]["gathers"], blobs)
            assert r[arm]["errors"] == 0
            assert r[arm]["bytes"] == sum(len(b) for b in blobs)


def test_lockstep_pod_fetches_each_chunk_once(lockstep_ranks):
    """Pod-wide origin fetches equal the plan's unique chunks, half the
    coop-off arm's; each rank's peer hits are the other's owner fetches."""
    unique = lockstep_ranks[0]["ici"]["plan"]["unique_chunks"]
    coop = [r["ici"]["coop"] for r in lockstep_ranks]
    assert sum(c["origin_fetches"] for c in coop) == unique
    assert sum(r["ici"]["opens"] for r in lockstep_ranks) == unique
    assert sum(r["off"]["opens"] for r in lockstep_ranks) == 2 * unique
    assert coop[0]["peer_hits"] == coop[1]["owner_fetches"] > 0
    assert coop[1]["peer_hits"] == coop[0]["owner_fetches"] > 0
    for c in coop:
        assert c["hosts"] == 2 and c["peer_misses"] == 0
        assert c["peer_requests"] == c["peer_hits"]
        assert c["demotions"] == 0
