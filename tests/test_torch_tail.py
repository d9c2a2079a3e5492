"""Tail tolerance of the port (``tpubench_torch/storage/tail.py``) against
``tpubench/storage/tail.py``: every scenario runs on both packages with the
same scripted inputs (numpy-seeded, a fake clock where a clock decides) and
must give the same result — exactly, since states, counts and bytes are
integers (tolerance 0; the breaker's ``open_s`` is a sum of the same float
steps in the same order, so it is equal too).

The hedged reader races real threads: its cases use gates and delays far
apart (a 2 ms hedge delay against a straggler held on an event), so their
counters do not depend on scheduling; each case releases its gates and
waits for every hedge producer to end, so no thread outlives a test.
"""

import threading
import time

import numpy as np
import pytest

import tpubench.config as jax_config
import tpubench.obs.flight as jax_flight
import tpubench.obs.tracing as jax_tracing
import tpubench.storage as jax_storage
import tpubench.storage.retrying as jax_retrying
import tpubench.storage.tail as jax_tail
from tpubench.storage.base import read_object_through as jax_read_through

import tpubench_torch.config as t_config
import tpubench_torch.obs.flight as t_flight
import tpubench_torch.obs.tracing as t_tracing
import tpubench_torch.storage as t_storage
import tpubench_torch.storage.retrying as t_retrying
import tpubench_torch.storage.tail as t_tail
from tpubench_torch.storage.base import deterministic_bytes
from tpubench_torch.storage.base import read_object_through as t_read_through

# One namespace per package, so a scenario is written once.
JAX = dict(
    config=jax_config, flight=jax_flight, tracing=jax_tracing,
    storage=jax_storage, retrying=jax_retrying, tail=jax_tail,
    read_through=jax_read_through,
)
PORT = dict(
    config=t_config, flight=t_flight, tracing=t_tracing,
    storage=t_storage, retrying=t_retrying, tail=t_tail,
    read_through=t_read_through,
)
PACKAGES = pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ScriptedReader:
    """Returns scripted chunk sizes and advances the clock per call."""

    def __init__(self, chunks, clock, dts):
        self.chunks = list(chunks)
        self.dts = list(dts)
        self.clock = clock
        self.first_byte_ns = None
        self.closed = False

    def readinto(self, buf):
        self.clock.advance(self.dts.pop(0) if self.dts else 0.0)
        if not self.chunks:
            return 0
        n = min(len(buf), self.chunks.pop(0))
        buf[:n] = b"x" * n
        return n

    def close(self):
        self.closed = True


def _hedge_threads():
    return [t for t in threading.enumerate() if t.name.startswith("hedge-")]


@pytest.fixture(autouse=True)
def _no_hedge_thread_left():
    yield
    deadline = time.monotonic() + 2.0
    while _hedge_threads() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not _hedge_threads(), "a hedge producer outlived its test"


# -------------------------------------------------------------- breaker ----


def _breaker_trace(pkg, seed: int) -> list:
    """A seeded script of breaker operations under a fake clock; the
    breaker's state after every step, then its snapshot."""
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    br = pkg["tail"].CircuitBreaker(
        failures=int(rng.integers(1, 4)), reset_s=1.0,
        probes=int(rng.integers(1, 3)), clock=clock,
    )
    out = []
    probe = False
    for op in rng.integers(0, 5, size=200):
        if op == 0:
            adm = br.allow()
            probe = bool(adm and adm.probe)
            out.append(("allow", bool(adm), probe))
        elif op == 1:
            br.record_success(probe=probe)
            probe = False
        elif op == 2:
            br.record_failure(probe=probe)
            probe = False
        elif op == 3:
            clock.advance(float(rng.choice([0.1, 0.6, 1.2])))
        else:
            if probe:
                br.abandon_probe()
                probe = False
        out.append(br.state)
    out.append(br.snapshot())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_transitions_and_snapshot_match(seed):
    jax_trace = _breaker_trace(JAX, seed)
    port_trace = _breaker_trace(PORT, seed)
    assert port_trace == jax_trace
    assert {"closed", "open", "half_open"} & set(port_trace[:-1])


class _FlakyBackend:
    """Fails every open while ``broken``; serves a fake store otherwise."""

    def __init__(self, pkg):
        self.broken = True
        self.inner = pkg["storage"].FakeBackend.prepopulated("f/", 1, 100)
        self._error = pkg["storage"].StorageError

    def open_read(self, name, start=0, length=None):
        if self.broken:
            raise self._error("boom", transient=True, code=503)
        return self.inner.open_read(name, start, length)

    def close(self):
        pass


@PACKAGES
def test_breaker_backend_sheds_and_recovers(pkg):
    clock = FakeClock()
    fb = _FlakyBackend(pkg)
    tail = pkg["tail"]
    bb = tail.BreakerBackend(fb, pkg["config"].TailConfig(
        breaker=True, breaker_failures=2, breaker_reset_s=3.0,
    ), clock=clock)
    for _ in range(2):
        with pytest.raises(pkg["storage"].StorageError):
            bb.open_read("f/0")
    assert bb.breaker.state == "open"
    with pytest.raises(tail.CircuitOpenError):
        bb.open_read("f/0")  # shed without touching the inner backend
    fb.broken = False
    clock.advance(3.5)
    r = bb.open_read("f/0")  # the half-open probe goes through
    buf = memoryview(bytearray(256))
    while r.readinto(buf) > 0:
        pass
    r.close()
    assert bb.breaker.state == "closed"
    stats = tail.collect_tail_stats(bb)
    assert stats == {"breaker": {
        "state": "closed", "opens": 1, "open_s": 3.5, "shed": 1, "probes": 1,
    }}


# ------------------------------------------------------------- watchdog ----


def _watchdog_outcome(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    chunks = rng.integers(1, 4096, size=40).tolist()
    dts = rng.choice([0.01, 0.2, 1.5], size=40).tolist()
    inner = ScriptedReader(chunks, clock, dts)
    stalls = []
    r = pkg["tail"].WatchdogReader(
        inner, window_s=1.0, floor_bps=2000.0, clock=clock,
        on_stall=lambda: stalls.append(clock()),
    )
    buf = memoryview(bytearray(4096))
    out = []
    try:
        while True:
            n = r.readinto(buf)
            out.append(n)
            if n == 0:
                break
    except pkg["tail"].StallError as e:
        out.append(("stall", str(e)))
    out.append(("stalls", stalls, inner.closed))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_watchdog_stalls_match_under_scripted_clock(seed):
    assert _watchdog_outcome(PORT, seed) == _watchdog_outcome(JAX, seed)


def _watchdog_resume(pkg) -> tuple:
    """A backend whose first stream drips (one stall), then serves fast;
    the watchdog under the retry layer resumes at the delivered offset."""
    clock = FakeClock()
    size = 200_000
    data = deterministic_bytes("f/0", size).tobytes()

    class SlowThenFine:
        def __init__(self):
            self.opens = []

        def open_read(self, name, start=0, length=None):
            self.opens.append(start)
            end = size if length is None else start + length
            slow = len(self.opens) == 1
            return _Slice(data[start:end], clock, 1.0 if slow else 0.0)

        def close(self):
            pass

    be = SlowThenFine()
    tcfg = pkg["config"].TailConfig(
        watchdog=True, stall_window_s=2.0, stall_floor_bps=10_000.0,
    )
    wb = pkg["tail"].wrap_tail(be, tcfg, clock=clock)
    rb = pkg["retrying"].RetryingBackend(wb, pkg["config"].RetryConfig(
        jitter=False, initial_backoff_s=0.0, max_backoff_s=0.0,
        max_attempts=5,
    ), sleep=lambda s: None, clock=clock)
    got = bytearray()
    total, _ = pkg["read_through"](
        rb.open_read("f/0"), memoryview(bytearray(8192)),
        sink=lambda mv: got.extend(mv),
    )
    assert bytes(got) == data
    return total, be.opens, pkg["tail"].collect_tail_stats(rb)


class _Slice:
    def __init__(self, data: bytes, clock, dt: float):
        self._mv, self._pos, self._clock, self._dt = memoryview(data), 0, clock, dt
        self.first_byte_ns = None

    def readinto(self, buf):
        self._clock.advance(self._dt)
        n = min(len(buf), len(self._mv) - self._pos)
        buf[:n] = self._mv[self._pos : self._pos + n]
        self._pos += n
        return n

    def close(self):
        pass


def test_watchdog_stall_resumes_under_retry_layer_as_reference():
    jax_out, port_out = _watchdog_resume(JAX), _watchdog_resume(PORT)
    assert port_out == jax_out
    total, opens, stats = port_out
    assert total == 200_000 and len(opens) == 2 and opens[1] > 0
    assert stats == {"watchdog": {"stalls": 1}}


# ---------------------------------------------------------------- hedging --


class GatedBackend:
    """The first ``block_first`` opens block on an event (stragglers);
    later opens stream at once."""

    def __init__(self, pkg, size=100_000, block_first=1, annotate=False):
        self.inner = pkg["storage"].FakeBackend.prepopulated("f/", 1, size)
        self.gate = threading.Event()
        self.opens = 0
        self.block_first = block_first
        self._flight = pkg["flight"] if annotate else None
        self.threads = []

    def open_read(self, name, start=0, length=None):
        self.opens += 1
        self.threads.append(threading.current_thread().name)
        if self._flight is not None:
            self._flight.note_phase("connect")  # as the pooled clients do
            self._flight.annotate("conn", open=self.opens)
        r = self.inner.open_read(name, start, length)
        if self.opens <= self.block_first:
            orig = r.readinto

            def gated(buf):
                self.gate.wait(timeout=10.0)
                return orig(buf)

            r.readinto = gated
        return r

    def close(self):
        self.inner.close()


def _hedge_rescue(pkg) -> dict:
    gb = GatedBackend(pkg, annotate=True)
    hb = pkg["tail"].HedgedBackend(
        gb, pkg["config"].TailConfig(hedge=True, hedge_delay_s=0.002),
        chunk_bytes=16 * 1024,
    )
    wf = pkg["flight"].WorkerFlight("w0", 8)
    op = wf.begin("f/0", "fake")
    got = bytearray()
    try:
        total, fb_ns = pkg["read_through"](
            hb.open_read("f/0"), memoryview(bytearray(16 * 1024)),
            sink=lambda mv: got.extend(mv),
        )
        op.finish(total)
    finally:
        gb.gate.set()  # release the straggler so its thread exits
    assert bytes(got) == deterministic_bytes("f/0", 100_000).tobytes()
    assert fb_ns is not None
    rec = wf.records()[0]
    assert pkg["flight"].current_op() is None  # finished ops uninstall
    return {
        "total": total,
        "opens": gb.opens,
        "stats": pkg["tail"].collect_tail_stats(hb)["hedge"],
        "phases": sorted(rec["phases"]),
        "notes": sorted(
            (n["kind"], n.get("event", ""), n.get("open", 0))
            for n in rec.get("notes", ())
        ),
        "producer_threads": sorted(gb.threads),
    }


def test_hedge_rescues_straggler_as_reference():
    """The straggling primary is overtaken by its hedge: same counters,
    and the producers' connect phase and notes land on the read's record
    (they adopt the consumer's op) in both packages."""
    out = _hedge_rescue(PORT)
    assert out == _hedge_rescue(JAX)
    assert out["stats"]["hedges"] == out["stats"]["hedge_wins"] == 1
    assert out["producer_threads"] == ["hedge-0", "hedge-1"]
    assert "connect" in out["phases"]
    assert ("hedge", "launch", 0) in out["notes"]
    assert ("hedge", "win", 0) in out["notes"]


def _hedge_trace_context(pkg) -> tuple:
    """With the flight recorder off, a hedge producer still parents its
    spans under the read's tracer span (it adopts the trace context)."""
    tracer = pkg["tracing"].RecordingTracer()
    seen = []

    class SpanningBackend(GatedBackend):
        def open_read(self, name, start=0, length=None):
            with tracer.span("inner.open"):
                seen.append(pkg["tracing"].current_trace())
            return super().open_read(name, start, length)

    gb = SpanningBackend(pkg, block_first=0)
    hb = pkg["tail"].HedgedBackend(
        gb, pkg["config"].TailConfig(hedge=True, hedge_delay_s=5.0),
        chunk_bytes=16 * 1024,
    )
    with tracer.span("ReadObject"):
        total, _ = pkg["read_through"](
            hb.open_read("f/0"), memoryview(bytearray(16 * 1024))
        )
    spans = {s.name: s for s in tracer.spans}
    inner, root = spans["inner.open"], spans["ReadObject"]
    assert pkg["tracing"].current_trace() is None
    return total, inner.parent_id == root.span_id, inner.trace_id == root.trace_id


def test_hedge_producer_adopts_trace_context_as_reference():
    assert _hedge_trace_context(PORT) == _hedge_trace_context(JAX) == (
        100_000, True, True,
    )


class SteppingClock:
    """A scripted clock for the hedged reader's consumer thread: each call
    returns the time and moves it on by ``step`` until ``stop()`` is true,
    after which it stands still. Hedge launches and stall verdicts then
    follow from the count of the reader's own clock reads, not from the
    machine's speed."""

    def __init__(self, step: float):
        self.t, self.step = 0.0, step
        self.stop = lambda: False

    def __call__(self) -> float:
        t = self.t
        if not self.stop():
            self.t += self.step
        return t


def _hedged_blackhole_resume(pkg) -> tuple:
    """Primary and hedge both blackholed: the hedged reader's async
    watchdog raises StallError while both producers block, the retry
    layer reopens, and the third open delivers exact bytes.

    On the scripted clock (0.1 s a read) the first reader hedges at its
    first loop turn (2 ms delay) and stalls at its fourth (0.3 s window);
    from the stall on the clock stands still, so the resumed reader can
    neither hedge nor stall: three opens in all."""
    gb = GatedBackend(pkg, block_first=2)
    clock = SteppingClock(0.1)
    t = pkg["config"].TailConfig(
        hedge=True, hedge_delay_s=0.002, watchdog=True,
        stall_window_s=0.3, stall_floor_bps=1.0,
    )
    hb = pkg["tail"].wrap_tail(gb, t, clock=clock, chunk_bytes=16 * 1024)
    clock.stop = lambda: hb.stats["stalls"] > 0
    rb = pkg["retrying"].RetryingBackend(hb, pkg["config"].RetryConfig(
        jitter=False, initial_backoff_s=0.0, max_backoff_s=0.0,
        max_attempts=10,
    ))
    got = bytearray()
    try:
        total, _ = pkg["read_through"](
            rb.open_read("f/0"), memoryview(bytearray(16 * 1024)),
            sink=lambda mv: got.extend(mv),
        )
    finally:
        gb.gate.set()
    assert bytes(got) == deterministic_bytes("f/0", 100_000).tobytes()
    st = pkg["tail"].collect_tail_stats(rb)
    return (total, gb.opens, st["hedge"]["reads"], st["hedge"]["hedges"],
            st["watchdog"]["stalls"])


def test_hedged_async_watchdog_resume_as_reference():
    assert _hedged_blackhole_resume(PORT) == _hedged_blackhole_resume(JAX) == (
        100_000, 3, 2, 1, 1,
    )


# ------------------------------------------------------------ composition --


@PACKAGES
def test_wrap_tail_layers_and_identity(pkg):
    tail, cfgmod = pkg["tail"], pkg["config"]
    be = pkg["storage"].FakeBackend.prepopulated("f/", 1, 40_000)
    assert tail.wrap_tail(be, cfgmod.TailConfig()) is be
    assert tail.wrap_tail(be, None) is be
    assert tail.collect_tail_stats(be) == {}
    chain = []
    b = tail.wrap_tail(be, cfgmod.TailConfig(
        hedge=True, watchdog=True, breaker=True, hedge_delay_s=5.0,
    ), chunk_bytes=8 * 1024)
    while b is not None:
        chain.append(type(b).__name__)
        b = getattr(b, "inner", None)
    assert chain == ["HedgedBackend", "BreakerBackend", "FakeBackend"]
    w = tail.wrap_tail(be, cfgmod.TailConfig(watchdog=True))
    assert type(w).__name__ == "WatchdogBackend"
    assert tail.find_tail_layer(w, tail.WatchdogBackend) is w
    assert tail.find_tail_layer(be, tail.HedgedBackend) is None


def test_open_backend_puts_tail_inside_retry():
    """``open_backend`` wraps the tail layers inside the retry decorator,
    with the granule as the hedge chunk, as ``tpubench``'s does."""
    def chain(storage, cfg):
        b, names = storage.open_backend(cfg), []
        while b is not None:
            names.append(type(b).__name__)
            chunk = getattr(b, "chunk_bytes", None)
            if chunk is not None:
                names.append(chunk)
            b = getattr(b, "inner", None)
        return names

    out = []
    for cfgmod, storage in ((jax_config, jax_storage), (t_config, t_storage)):
        cfg = cfgmod.BenchConfig()
        cfg.transport.protocol = "fake"
        cfg.workload.workers, cfg.workload.object_size = 1, 10
        cfg.workload.granule_bytes = 12_345
        cfg.transport.tail.hedge = cfg.transport.tail.breaker = True
        out.append(chain(storage, cfg))
    assert out[0] == out[1] == [
        "RetryingBackend", "HedgedBackend", 12_345, "BreakerBackend",
        "FakeBackend",
    ]


@PACKAGES
def test_stall_and_open_errors_are_transient(pkg):
    from_retry = (
        jax_storage.retry if pkg is JAX else t_storage.retry
    )._is_retryable
    for err in (pkg["tail"].StallError("s"), pkg["tail"].CircuitOpenError("o")):
        assert err.transient
        assert from_retry(err, "idempotent")
    assert pkg["tail"].StallError("s").code == 598
    assert pkg["tail"].CircuitOpenError("o").code == 503
