"""Shared pool of native connection handles (engine ``tb_conn``) — a copy
of ``tpubench/storage/native_pool.py``.

Both native receive paths — HTTP (:mod:`.gcs_http`) and gRPC/h2
(:mod:`.gcs_grpc`) — pool engine connection handles with one discipline:

* bounded idle pool (``max_idle_conns_per_host``, main.go:32 analog);
* ``connects`` / ``reuses`` / ``stale_retries`` accounting under the pool
  lock;
* one immediate retransmit on a fresh connection when the FIRST use of a
  pooled handle fails (a socket that died while idle is a normal pool
  condition, not a request failure).

The backends supply the protocol-specific parts: how to run one request
and which errors prove the server answered (those are never retried as
staleness). :func:`run_multiplexed_batch` is the batch loop both
``read_ranges`` readers share (many h2 streams on one connection).
"""

from __future__ import annotations

import threading
from typing import Callable

from tpubench_torch.native.engine import (
    PERMANENT_CODES,
    NativeError,
    get_engine,
)
from tpubench_torch.obs.flight import annotate as flight_annotate
from tpubench_torch.obs.flight import note_phase as flight_note
from tpubench_torch.storage.base import StorageError


def build_native_pool(
    transport, host: str, port: int, tls: bool, alpn_h2: bool = False
) -> "NativeConnPool":
    """The one way both backends build their native pool: engine and TLS
    checks, then a connect closure that classifies failures on the
    engine's code ABI. A failed engine build raises. Callers guard the
    lazy single assignment with their own lock."""
    engine = get_engine()
    if tls and not engine.tls_available():
        raise StorageError(
            "transport.native_receive on a TLS endpoint, but the engine "
            "could not load OpenSSL (libssl.so.3)", transient=False
        )

    def connect() -> int:
        try:
            return engine.connect(
                host, port, tls=tls, sni=host,
                cafile=transport.tls_ca_file,
                insecure=transport.tls_insecure_skip_verify,
                alpn_h2=alpn_h2,
            )
        except NativeError as e:
            # Handshake/verification failures are TB_ETLS, permanent.
            raise StorageError(
                f"native connect {host}:{port}: {e}",
                transient=e.code not in PERMANENT_CODES,
            ) from e

    return NativeConnPool(engine, connect, transport.max_idle_conns_per_host)


class BufferPool:
    """Free-list of aligned receive buffers, bucketed by exact size.

    A fresh ``posix_memalign`` per GET is an mmap + page-fault storm on
    every read; benchmark object sizes repeat, so exact-size buckets hit
    almost always."""

    def __init__(self, engine, max_per_size: int = 8):
        self._engine = engine
        self._lock = threading.Lock()
        self._free: dict[int, list] = {}
        self._max_per_size = max_per_size
        self._closed = False

    def acquire(self, size: int):
        with self._lock:
            bucket = self._free.get(size)
            if bucket:
                return bucket.pop()
        return self._engine.alloc(size)

    def release(self, buf) -> None:
        with self._lock:
            if not self._closed:
                bucket = self._free.setdefault(buf.size, [])
                if len(bucket) < self._max_per_size:
                    bucket.append(buf)
                    return
        # Pool full, or closed (a straggler finishing during shutdown
        # must not repopulate a drained pool): free now.
        buf.free()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            buckets, self._free = list(self._free.values()), {}
        for bucket in buckets:
            for buf in bucket:
                buf.free()


class NativeConnPool:
    """Pool of engine connection handles with one stale-use retry.

    ``connect`` returns a fresh handle and raises for itself; its failures
    propagate unchanged."""

    def __init__(self, engine, connect: Callable[[], int], max_idle: int):
        self.engine = engine
        self._connect = connect
        self._idle: list[int] = []
        self._lock = threading.Lock()
        self._max_idle = max_idle
        self.stats = {"connects": 0, "reuses": 0, "stale_retries": 0}
        # The receive buffers share the connection pool's lifecycle.
        self.buffers = BufferPool(engine)

    # Tests reach into the idle list to inject dead handles.
    @property
    def idle(self) -> list[int]:
        return self._idle

    def _new(self) -> int:
        h = self._connect()
        with self._lock:
            self.stats["connects"] += 1
        flight_note("connect")  # flight-recorder phase (no-op off-op)
        return h

    def fresh(self) -> int:
        """A guaranteed-fresh connection (stale-retry path: a second
        pooled handle could be just as stale as the first)."""
        return self._new()

    def acquire(self) -> tuple[int, bool]:
        """(handle, reused): a pooled idle handle when there is one, else
        a fresh connection. The caller owns it until :meth:`release` or
        :meth:`discard` (streaming readers hold it across body reads)."""
        with self._lock:
            conn = self._idle.pop() if self._idle else 0
            if conn:
                self.stats["reuses"] += 1
        if conn:
            return conn, True
        return self._new(), False

    def release(self, conn: int, reusable: bool) -> None:
        """Back to the idle pool when ``reusable`` and there is room,
        else closed."""
        if reusable:
            with self._lock:
                if len(self._idle) < self._max_idle:
                    self._idle.append(conn)
                    return
        self.engine.conn_close(conn)

    def discard(self, conn: int) -> None:
        """Close a handle whose stream state is unknown (request failed)."""
        self.engine.conn_close(conn)

    def note_stale_retry(self) -> None:
        with self._lock:
            self.stats["stale_retries"] += 1
        flight_annotate("retry", reason="stale")

    def run(
        self,
        request: Callable[[int], dict],
        retry_stale: Callable[[NativeError], bool] = (
            lambda e: e.code not in PERMANENT_CODES
        ),
    ) -> dict:
        """Run one request on a pooled (or fresh) handle.

        On success the handle goes back to the idle pool when there is
        room. On :class:`NativeError` the handle is closed (stream state
        unknown); if this was the first use of a pooled handle and
        ``retry_stale(e)`` holds, the request runs once more on a fresh
        connection before the error propagates."""
        conn, reused = self.acquire()
        while True:
            try:
                r = request(conn)
            except NativeError as e:
                self.engine.conn_close(conn)
                if reused and retry_stale(e):
                    reused = False
                    self.note_stale_retry()
                    conn = self._new()
                    continue
                raise
            except BaseException:
                # Includes KeyboardInterrupt: never strand the connection.
                self.engine.conn_close(conn)
                raise
            self.release(conn, True)
            return r

    def close(self) -> None:
        with self._lock:
            conns, self._idle = self._idle, []
        for h in conns:
            self.engine.conn_close(h)
        self.buffers.close()


def range_addresses(ranges, buffers, done: list) -> list[int]:
    """The address each range's bytes land at (its buffer's first byte),
    marking zero-length ranges done. The engine writes ``length`` bytes
    through the raw pointer, so a read-only or strided buffer, or one
    shorter than its range, raises ``ValueError`` here."""
    import numpy as np

    addrs = []
    for i, ((_, length), b) in enumerate(zip(ranges, buffers)):
        arr = b if isinstance(b, np.ndarray) else np.frombuffer(b, np.uint8)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            raise ValueError(
                f"range {i}: buffer must be writable and C-contiguous"
            )
        if arr.nbytes < length:
            raise ValueError(f"range {i}: buffer {arr.nbytes} < length {length}")
        addrs.append(arr.ctypes.data)
        if length == 0:
            done[i] = True
    return addrs


def fail_unfinished(done: list, errs: list, err: StorageError) -> list:
    """Classify ``err`` onto every unfinished range (the batch readers'
    per-range contract: report, don't throw)."""
    for i in range(len(done)):
        if not done[i]:
            errs[i] = err
            done[i] = True
    return errs


def run_multiplexed_batch(
    pool: NativeConnPool,
    n: int,
    done: list,
    errs: list,
    submit: Callable[[int, int], None],
    classify: Callable[[int, dict], object],
    name: str,
    window: int = 16,
    answered: Callable[[NativeError], bool] = lambda e: False,
) -> list:
    """The multiplexed-stream batch loop of both h2 batch readers (gRPC
    ReadObject streams and whole-client HTTP/2 ranged GETs).

    ``submit(conn, i)`` opens range *i*'s stream on ``conn``;
    ``classify(i, completion)`` maps a completion to ``None`` or a
    classified StorageError; ``answered(e)`` is True when a
    connection-fatal error proves the server answered (an explicit
    grpc-status): such an error is never retried as pool staleness.
    Streams are submitted in ``window``-sized waves below the 32-stream
    connection cap; the whole batch is sent once more on a fresh
    connection when the first use of a pooled handle fails before any
    completion. Fills ``errs`` in place and returns it; a connect failure
    classifies onto every unfinished range."""

    def fail_all(err: StorageError) -> list:
        return fail_unfinished(done, errs, err)

    try:
        conn, reused = pool.acquire()
    except StorageError as e:
        return fail_all(e)
    except Exception as e:  # noqa: BLE001 — per-range contract
        return fail_all(
            StorageError(f"read_ranges setup: {e}", transient=True)
        )
    engine = pool.engine
    while True:
        submitted = 0
        completed = 0
        got_any = False
        pending = [i for i in range(n) if not done[i]]
        try:
            while completed < len(pending):
                while (
                    submitted < len(pending)
                    and submitted - completed < window
                ):
                    submit(conn, pending[submitted])
                    submitted += 1
                c = engine.h2_poll(conn)
                if c is None:
                    raise StorageError(
                        f"read_ranges {name}: stream vanished",
                        transient=True,
                    )
                got_any = True
                i = c["tag"]
                errs[i] = classify(i, c)
                done[i] = True
                completed += 1
            pool.release(conn, True)
            return errs
        except NativeError as e:
            pool.discard(conn)
            stale = (
                reused
                and not got_any
                and e.code not in PERMANENT_CODES
                and not answered(e)
            )
            if stale:
                # Whole-batch retransmit on a fresh connection.
                reused = False
                pool.note_stale_retry()
                try:
                    conn = pool.fresh()
                except StorageError as e2:
                    return fail_all(e2)
                continue
            return fail_all(
                StorageError(
                    f"read_ranges {name}: {e}",
                    transient=e.code not in PERMANENT_CODES,
                )
            )
        except StorageError as e:
            pool.discard(conn)
            return fail_all(e)
        except BaseException:
            pool.discard(conn)
            raise
