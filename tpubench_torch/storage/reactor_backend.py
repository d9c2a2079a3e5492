"""Serve-plane fetches through the native executor's pool (a copy of
``tpubench/storage/reactor_backend.py``).

:class:`ReactorFetchBackend` slots between ``open_backend``'s protocol
switch and the tail/retry wrappers: every ``open_read`` becomes one
ranged GET submitted to a SHARED native fetch pool (the epoll reactor by
default), so serve workers stop burning a Python socket read per chunk —
the fetch hot loop runs on the event loop's thread(s), and N serve
workers multiplex over a handful of keep-alive connections (TLS or h2
included).

Contracts kept deliberately narrow:

* the pool is LAZY — a workload that never calls ``open_read`` (the
  read runners drive ``tb_pool_*`` themselves) never spins it up;
* completions land in a per-request ``bytearray`` and the reader serves
  from it; ``generation`` is ``None`` = *unknown* (the engine does not
  surface ``x-goog-generation``), the documented degrade the chunk
  cache already accepts from native transports;
* failures raise :class:`StorageError` with the SAME transient/permanent
  split as the executor runners (engine PERMANENT_CODES + HTTP
  408/429/5xx), so the tail/retry stack above composes unchanged;
* if the native engine cannot be built or the pool cannot be created,
  ``open_read`` RAISES. ``tpubench`` falls back to the inner backend's
  Python read path with one counted warning; the port has no fallback
  (a failed engine build is an error everywhere in the port). A
  ``native`` pool that engaged the thread pool instead of the reactor
  warns once and a pinned ``native-reactor`` one raises, as the read
  path's executor does (``fetch_executor.check_executor_engaged``).
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

from tpubench_torch.storage.base import StorageBackend, StorageError


class _RangeReader:
    """Reader over one completed ranged GET (bytes already in memory)."""

    def __init__(self, data: memoryview, first_byte_ns: Optional[int]):
        self._data = data
        self._off = 0
        self.first_byte_ns = first_byte_ns
        self.generation = None  # engine path: generation unknown

    def readinto(self, buf) -> int:
        mv = memoryview(buf)
        n = min(len(mv), len(self._data) - self._off)
        if n <= 0:
            return 0
        mv[:n] = self._data[self._off:self._off + n]
        self._off += n
        return n

    def close(self) -> None:
        self._data = b""


class _Pending:
    __slots__ = ("event", "completion", "buf", "view")

    def __init__(self, buf: bytearray, view):
        self.event = threading.Event()
        self.completion: Optional[dict] = None
        self.buf = buf      # keepalive: the engine writes into it
        self.view = view    # ctypes view pinning the bytearray exporter


class ReactorFetchBackend:
    """StorageBackend adapter routing ``open_read`` through the native
    fetch pool. Everything else delegates to ``inner`` (a
    ``GcsHttpBackend``)."""

    #: completion wait bound — mirrors the executor runners' 120 s stall
    #: guard; the engine's own 60 s I/O sweep fails tasks well before it.
    WAIT_S = 180.0

    def __init__(self, inner, connections: int = 8, cap: int = 256,
                 fetch_executor: str = "native"):
        from tpubench_torch.workloads.fetch_executor import executor_mode

        self.inner = inner
        self._connections = connections
        self._cap = cap
        self._fetch_executor = fetch_executor
        self._mode = executor_mode(fetch_executor)
        self._pool = None
        self._engine = None
        # True when a "native" pool engaged the thread pool instead of the
        # reactor (one warning printed); never a fall back to Python.
        self.fell_back = False
        self._lock = threading.Lock()
        self._pending: dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        self._next_tag = 0
        self._sem = threading.Semaphore(cap)
        self._drainer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.pool_mode: Optional[str] = None  # what actually engaged

    # ------------------------------------------------------ pool plumbing --

    def _ensure_pool(self):
        """Lazy shared pool. A failed engine build or pool creation
        raises (no Python fallback)."""
        with self._lock:
            if self._pool is not None:
                return self._pool
            from tpubench_torch.native.engine import get_engine
            from tpubench_torch.workloads.fetch_executor import (
                _make_pool,
                check_executor_engaged,
            )

            if not hasattr(self.inner, "native_request_parts"):
                raise TypeError(
                    "the reactor-fetch wrapper needs the HTTP backend's "
                    f"native request surface, not {type(self.inner).__name__}"
                )
            engine = get_engine()
            pool = _make_pool(
                engine, self.inner, self._connections, self._cap,
                mode=self._mode,
            )
            self.fell_back = check_executor_engaged(pool, self._fetch_executor)
            self._engine = engine
            self._pool = pool
            self.pool_mode = pool.mode
            self._drainer = threading.Thread(
                target=self._drain_loop, name="reactor-fetch-drain",
                daemon=True,
            )
            self._drainer.start()
            return pool

    def _drain_loop(self) -> None:
        # The ONE draining thread (SPSC ring contract); serve workers
        # block on per-tag events, so completion fan-out costs no locks
        # on the ring itself.
        while True:
            cs = self._pool.next_batch(timeout_ms=100)
            for c in cs:
                with self._pending_lock:
                    p = self._pending.get(c["tag"])
                if p is not None:
                    p.completion = c
                    p.event.set()
            if self._stop.is_set() and not cs:
                with self._pending_lock:
                    idle = not self._pending
                if idle:
                    return

    # ---------------------------------------------------------- read path --

    def open_read(self, name: str, start: int = 0,
                  length: Optional[int] = None):
        pool = self._ensure_pool()
        if length is None:
            length = max(0, self.inner.stat(name).size - start)
        if length == 0:
            return _RangeReader(memoryview(b""), None)
        host, port, path, headers = self.inner.native_request_parts(name)
        headers += f"Range: bytes={start}-{start + length - 1}\r\n"
        buf = bytearray(length)
        view = (ctypes.c_char * length).from_buffer(buf)
        p = _Pending(buf, view)
        self._sem.acquire()
        try:
            with self._pending_lock:
                tag = self._next_tag
                self._next_tag += 1
                self._pending[tag] = p
            try:
                pool.submit_to(
                    host, port, path, ctypes.addressof(view), length,
                    headers=headers, tag=tag,
                )
            except Exception:
                with self._pending_lock:
                    self._pending.pop(tag, None)
                raise
            if not p.event.wait(self.WAIT_S):
                # Deliberately LEAVE the pending entry (and its buffer)
                # registered: the engine may still write into the buffer,
                # so dropping the last reference would be a
                # write-after-free. The drainer settles it eventually.
                raise StorageError(
                    f"{name}: reactor fetch timed out after {self.WAIT_S}s",
                    transient=True,
                )
            with self._pending_lock:
                del self._pending[tag]
        finally:
            self._sem.release()
        return self._complete(name, length, p)

    def _complete(self, name: str, length: int, p: _Pending):
        from tpubench_torch.native.engine import PERMANENT_CODES
        from tpubench_torch.storage.gcs_http import _TRANSIENT

        c = p.completion
        result, status = c["result"], c["status"]
        if result < 0:
            raise StorageError(
                f"{name}: engine error {result}",
                transient=result not in PERMANENT_CODES, code=result,
            )
        if status not in (200, 206):
            raise StorageError(
                f"{name}: HTTP {status}",
                transient=status in _TRANSIENT, code=status,
            )
        if result != length:
            raise StorageError(
                f"{name}: ranged GET returned {result} bytes, "
                f"wanted {length}",
                transient=True,
            )
        del p.view  # release the exporter before handing bytes out
        fb = c["first_byte_ns"] or None
        return _RangeReader(memoryview(p.buf), fb)

    # --------------------------------------------------------- delegation --

    def write(self, name, data, if_generation_match=None):
        return self.inner.write(
            name, data, if_generation_match=if_generation_match
        )

    def open_write(self, name, if_generation_match=None):
        return self.inner.open_write(
            name, if_generation_match=if_generation_match
        )

    def list(self, prefix: str = "", page_size: int = 0):
        return self.inner.list(prefix, page_size=page_size)

    def stat(self, name: str):
        return self.inner.stat(name)

    def delete(self, name: str) -> None:
        self.inner.delete(name)

    def close(self) -> None:
        with self._lock:
            pool, drainer = self._pool, self._drainer
            self._pool, self._drainer = None, None
        if drainer is not None:
            self._stop.set()
            drainer.join(timeout=10)
        if pool is not None:
            pool.close()
        self.inner.close()


def maybe_wrap_reactor_fetch(inner, cfg) -> StorageBackend:
    """``open_backend`` hook: route backend reads through the native
    fetch pool when the config asks for a native fetch executor on an
    HTTP backend. Lazy — wrapping costs nothing until ``open_read``."""
    fe = cfg.workload.fetch_executor
    if not fe.startswith("native"):
        return inner
    return ReactorFetchBackend(
        inner,
        connections=max(2, min(16, cfg.serve.workers)),
        cap=max(64, 4 * cfg.serve.workers),
        fetch_executor=fe,
    )
