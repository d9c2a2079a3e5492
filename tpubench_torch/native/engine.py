"""ctypes binding of the native engine (``csrc/engine.cc``): the part the
executor route calls — the fetch executor (:class:`NativeFetchPool`), the
loopback source server (:class:`NativeSourceServer`), the transport
counters and the TLS probe. A copy of the same surface of
``tpubench/native/engine.py``.

The library is built from this package's own sources
(:mod:`tpubench_torch.native.build`), so every symbol is declared
directly; a failed build or load raises from :func:`get_engine`.
"""

from __future__ import annotations

import ctypes
import json
import os
import threading
from typing import Optional

import numpy as np

from tpubench_torch.native.build import build_library
from tpubench_torch.storage.base import ObjectMeta, object_meta_dict


class NativeError(OSError):
    """Engine failure. ``code`` is the raw negative return: -1000-series
    protocol codes (see ``PERMANENT_CODES``) or ``-errno`` for socket
    failures. Callers classify on the code, never on message text."""

    def __init__(self, msg: str, code: int = 0):
        super().__init__(msg)
        self.code = code


# Engine error-code ABI (mirrors the engine.cc TB_* enum).
TB_EPROTO = -1001
TB_ETOOBIG = -1002
TB_ERESOLVE = -1003
TB_ESHORT = -1004
TB_ECHUNKED = -1005
TB_ETLS = -1006
TB_EGRPC = -1007

_PROTO_ERRORS = {
    TB_EPROTO: "malformed HTTP response",
    TB_ETOOBIG: "body exceeds buffer",
    TB_ERESOLVE: "hostname resolution failed",
    TB_ESHORT: "short response: connection closed early",
    TB_ECHUNKED: "chunked transfer encoding (unsupported by the native receive path)",
    TB_ETLS: "TLS unavailable, handshake failed, or certificate rejected",
    TB_EGRPC: "RPC finished with a nonzero grpc-status",
}

# Protocol-shape failures: re-sending the same request to the same server
# reproduces them, so retry is futile. Resolution failures and short
# bodies are network conditions — transient.
PERMANENT_CODES = frozenset({TB_EPROTO, TB_ETOOBIG, TB_ECHUNKED, TB_ETLS})


def _check(rc: int, what: str) -> int:
    if rc < 0:
        if rc in _PROTO_ERRORS:
            raise NativeError(f"{what}: {_PROTO_ERRORS[rc]}", code=rc)
        raise NativeError(f"{what}: {os.strerror(-rc)} (errno {-rc})", code=rc)
    return rc


class NativeEngine:
    """The loaded library with every entry point the route calls declared
    (a pointer passed as a default ``int`` would be cut to 32 bits)."""

    def __init__(self):
        lib = ctypes.CDLL(str(build_library()))
        c = ctypes
        i64p = c.POINTER(c.c_int64)
        lib.tb_tls_available.restype = c.c_int
        lib.tb_tls_available.argtypes = []
        lib.tb_pool_create.restype = c.c_int64
        lib.tb_pool_create.argtypes = [
            c.c_int, c.c_int, c.c_int, c.c_char_p, c.c_int,
        ]
        lib.tb_pool_create2.restype = c.c_int64
        lib.tb_pool_create2.argtypes = [
            c.c_int, c.c_int, c.c_int, c.c_char_p, c.c_int, c.c_int,
        ]
        lib.tb_pool_submit.restype = c.c_int
        lib.tb_pool_submit.argtypes = [
            c.c_int64, c.c_char_p, c.c_int, c.c_char_p, c.c_char_p,
            c.c_void_p, c.c_int64, c.c_uint64,
        ]
        lib.tb_pool_ring_next_batch.restype = c.c_int
        lib.tb_pool_ring_next_batch.argtypes = [
            c.c_int64, c.c_int, c.c_int, c.POINTER(c.c_uint64), i64p,
            c.POINTER(c.c_int), i64p, i64p, i64p,
        ]
        lib.tb_pool_destroy.restype = c.c_int
        lib.tb_pool_destroy.argtypes = [c.c_int64]
        lib.tb_srv_start.restype = c.c_void_p
        lib.tb_srv_start.argtypes = [
            c.c_void_p, c.c_int64, c.c_char_p, c.POINTER(c.c_int),
        ]
        lib.tb_srv_stop.restype = c.c_int
        lib.tb_srv_stop.argtypes = [c.c_void_p]
        lib.tb_stats_count.restype = c.c_int
        lib.tb_stats_count.argtypes = []
        lib.tb_stats_name.restype = c.c_char_p
        lib.tb_stats_name.argtypes = [c.c_int]
        lib.tb_stats_read.restype = c.c_int
        lib.tb_stats_read.argtypes = [i64p, c.c_int]
        self.lib = lib

    def stats(self) -> dict[str, int]:
        """Engine-wide transport counter snapshot (bytes on the wire,
        connects, pool wakes and completions, reactor ring depths).
        Cumulative per process; callers diff two snapshots to scope a
        run."""
        n = int(self.lib.tb_stats_count())
        arr = (ctypes.c_int64 * n)()
        got = self.lib.tb_stats_read(arr, n)
        return {
            self.lib.tb_stats_name(i).decode(): int(arr[i])
            for i in range(min(n, got))
        }

    def tls_available(self) -> bool:
        return bool(self.lib.tb_tls_available())

    def pool_create(
        self,
        threads: int,
        cap: int = 256,
        *,
        tls: bool = False,
        cafile: str = "",
        insecure: bool = False,
        mode: str = "threads",
        loops: int = 0,
    ) -> "NativeFetchPool":
        """Native fetch executor. ``mode="threads"``: ``threads`` worker
        pthreads, one keep-alive connection each. ``mode="reactor"``: epoll
        event loop(s) owning all connections (``threads`` is then the
        connection budget), completions over lock-free SPSC rings;
        ``loops`` sets the event-loop thread count (0 = one). A reactor
        that cannot be created falls back to the thread pool —
        :attr:`NativeFetchPool.mode` says what engaged."""
        if mode == "reactor":
            mbits = 1 | (max(0, min(loops, 16)) << 8)
            h = self.lib.tb_pool_create2(
                threads, cap, 1 if tls else 0, cafile.encode(),
                1 if insecure else 0, mbits,
            )
            if h != 0:
                return NativeFetchPool(self, h, mode="reactor")
        h = self.lib.tb_pool_create(
            threads, cap, 1 if tls else 0, cafile.encode(),
            1 if insecure else 0,
        )
        if h == 0:
            raise NativeError(
                "tb_pool_create failed"
                + (" (TLS requested but OpenSSL unavailable?)" if tls else ""),
                code=-12,
            )
        return NativeFetchPool(self, h, mode="threads")


class NativeFetchPool:
    """Handle over the C++ fetch executor (``tb_pool_*``).

    Contract: the memory a task lands in is OWNED BY THE POOL until its
    completion comes back from :meth:`next_batch` (identified by
    ``tag``). ``close()`` joins the workers after queued tasks finish
    (thread pool) or cancels outstanding work after joining the event
    loop (reactor) — either way, after close() returns nothing writes
    into caller memory. Completions ride an SPSC ring: drain from ONE
    thread at a time.
    """

    def __init__(self, engine: NativeEngine, handle: int,
                 mode: str = "threads"):
        self._engine = engine
        self._h = handle
        self.mode = mode  # "threads" | "reactor" — what actually engaged

    def submit_to(
        self,
        host: str,
        port: int,
        path: str,
        address: int,
        nbytes: int,
        headers: str = "",
        tag: int = 0,
    ) -> None:
        """Submit a GET whose body lands at ``(address, nbytes)`` — e.g.
        a page-locked staging slot's ``data_ptr()``. ``address`` 0 is
        discard mode (the body streams through a per-thread scratch and
        only its length is reported). The memory must stay valid until
        the completion returns."""
        rc = self._engine.lib.tb_pool_submit(
            self._h, host.encode(), port, path.encode(), headers.encode(),
            address, nbytes, tag,
        )
        if rc != 0:
            _check(rc, "pool_submit")

    def next_batch(self, timeout_ms: int = -1, max_n: int = 64) -> list[dict]:
        """Drain up to ``max_n`` completions in one handoff; ``[]`` on
        timeout. ``result`` < 0 is the engine error code for that task
        (the pool keeps running). The wait releases the interpreter lock
        (a ``ctypes.CDLL`` call)."""
        n = max(1, min(int(max_n), 256))
        tags = (ctypes.c_uint64 * n)()
        results = (ctypes.c_int64 * n)()
        statuses = (ctypes.c_int * n)()
        fbs = (ctypes.c_int64 * n)()
        totals = (ctypes.c_int64 * n)()
        starts = (ctypes.c_int64 * n)()
        rc = self._engine.lib.tb_pool_ring_next_batch(
            self._h, timeout_ms, n, tags, results, statuses, fbs, totals,
            starts,
        )
        if rc < 0:
            _check(rc, "pool_next_batch")
        return [
            {
                "tag": int(tags[i]),
                "result": int(results[i]),
                "status": int(statuses[i]),
                "first_byte_ns": int(fbs[i]),
                "total_ns": int(totals[i]),
                "start_ns": int(starts[i]),
            }
            for i in range(rc)
        ]

    def close(self) -> None:
        if self._h:
            self._engine.lib.tb_pool_destroy(self._h)
            self._h = 0

    def __enter__(self) -> "NativeFetchPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NativeSourceServer:
    """In-process HTTP/1.1 object server on native threads (``tb_srv_*``).

    Serves ONE body for every object name (media GETs with Range →
    200/206 slices, anything else → the metadata JSON of ``name``) with
    no Python in the serving path. The server BORROWS ``body``: this
    wrapper keeps it alive until ``stop()``.
    """

    _leaked_pins: list = []  # bodies of servers whose threads never exited

    def __init__(self, engine: NativeEngine, name: str, body):
        self._engine = engine
        self._body = np.ascontiguousarray(
            np.frombuffer(body, dtype=np.uint8)
            if not isinstance(body, np.ndarray) else body
        )
        meta = json.dumps(
            object_meta_dict(ObjectMeta(name, self._body.nbytes, 1))
        )
        port = ctypes.c_int(0)
        self._h = engine.lib.tb_srv_start(
            self._body.ctypes.data, self._body.nbytes, meta.encode(),
            ctypes.byref(port),
        )
        if not self._h:
            raise NativeError("tb_srv_start failed", 0)
        self.port = port.value
        self.host = "127.0.0.1"

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._h:
            rc = self._engine.lib.tb_srv_stop(self._h)
            self._h = None
            if rc != 0:
                # A connection thread is still alive (stalled peer): the C
                # side leaked its struct rather than free under the
                # thread, so the body stays referenced for the process.
                NativeSourceServer._leaked_pins.append(self._body)
            self._body = None

    def __enter__(self) -> "NativeSourceServer":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


_engine: Optional[NativeEngine] = None
_engine_lock = threading.Lock()


def get_engine() -> NativeEngine:
    """The process's engine, built and loaded on first call. A failed
    build or load raises (and is tried again on the next call)."""
    global _engine
    with _engine_lock:
        if _engine is None:
            _engine = NativeEngine()
        return _engine
