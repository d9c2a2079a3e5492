"""ctypes binding of the native engine (``csrc/engine.cc``): the part the
port's routes call — the fetch executor (:class:`NativeFetchPool`), the
loopback source server (:class:`NativeSourceServer`), the transport
counters and the TLS probe, and the storage clients' surface: connection
handles (``connect``/``conn_*``, plain or TLS), the streaming HTTP/1.1
GET that lands body bytes in caller memory (``conn_get_begin`` /
``conn_body_read`` / ``conn_get_end``), the HTTP/2 GET stream
(``h2_submit_get`` / ``h2_poll``), the gRPC ReadObject (``grpc_read``), the
batch calls of the multiplexed ``read_ranges`` (``grpc_submit``,
``grpc_submit_to``, ``h2_submit_get_to``: many streams on one connection,
completions from ``h2_poll``), one GET on a handle (``conn_request``),
the timed block I/O of the filesystem workloads (``open``, ``close``,
``file_size``, ``pread_blocks``, ``read_file_seq``, ``pwrite_blocks``,
``fill_random``) and aligned buffers (:class:`AlignedBuffer`). A copy of
the same surface of ``tpubench/native/engine.py``.

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


def buffer_address(dst) -> tuple[int, int]:
    """``(address, nbytes)`` of a writable, contiguous buffer (memoryview,
    bytearray, numpy array — e.g. the free view of a page-locked slot),
    without copying it. An empty buffer has no address to give: ``(0,
    0)``."""
    mv = memoryview(dst)
    if mv.nbytes == 0:
        return 0, 0
    return ctypes.addressof(ctypes.c_char.from_buffer(mv)), mv.nbytes


class AlignedBuffer:
    """``posix_memalign``'d receive buffer (``tb_alloc_aligned``), seen
    through a numpy view; the h2 and gRPC native clients land whole
    bodies here. Freed by :meth:`free` (or when collected)."""

    def __init__(self, engine: "NativeEngine", size: int, align: int = 4096):
        self._engine = engine
        self.size = size
        ptr = engine.lib.tb_alloc_aligned(size, align)
        if not ptr:
            raise MemoryError(f"aligned alloc of {size} failed")
        self._ptr = ptr
        self.array = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(size,)
        )

    @property
    def address(self) -> int:
        return self._ptr

    def view(self, n: Optional[int] = None) -> memoryview:
        return memoryview(self.array)[: self.size if n is None else n]

    def free(self) -> None:
        if self._ptr:
            self.array = None
            self._engine.lib.tb_free_aligned(self._ptr)
            self._ptr = 0

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


class NativeEngine:
    """The loaded library with every entry point the port calls declared
    (a pointer passed as a default ``int`` would be cut to 32 bits)."""

    def __init__(self):
        lib = ctypes.CDLL(str(build_library()))
        c = ctypes
        i64p = c.POINTER(c.c_int64)
        ip = c.POINTER(c.c_int)
        lib.tb_tls_available.restype = c.c_int
        lib.tb_tls_available.argtypes = []
        lib.tb_alloc_aligned.restype = c.c_void_p
        lib.tb_alloc_aligned.argtypes = [c.c_size_t, c.c_size_t]
        lib.tb_free_aligned.restype = None
        lib.tb_free_aligned.argtypes = [c.c_void_p]
        lib.tb_open.restype = c.c_int
        lib.tb_open.argtypes = [c.c_char_p, c.c_int, ip]
        lib.tb_close.restype = c.c_int
        lib.tb_close.argtypes = [c.c_int]
        lib.tb_file_size.restype = c.c_int64
        lib.tb_file_size.argtypes = [c.c_char_p]
        lib.tb_pread_blocks.restype = c.c_int64
        lib.tb_pread_blocks.argtypes = [
            c.c_int, c.c_void_p, c.c_int64, i64p, c.c_int64, i64p,
        ]
        lib.tb_read_file_seq.restype = c.c_int64
        lib.tb_read_file_seq.argtypes = [
            c.c_int, c.c_void_p, c.c_int64, c.c_int64, i64p,
        ]
        lib.tb_pwrite_blocks.restype = c.c_int64
        lib.tb_pwrite_blocks.argtypes = [
            c.c_int, c.c_void_p, c.c_int64, i64p, c.c_int64, c.c_int, i64p,
        ]
        lib.tb_fill_random.restype = None
        lib.tb_fill_random.argtypes = [c.c_void_p, c.c_int64, c.c_uint64]
        lib.tb_http_connect.restype = c.c_int
        lib.tb_http_connect.argtypes = [c.c_char_p, c.c_int]
        lib.tb_http_close.restype = c.c_int
        lib.tb_http_close.argtypes = [c.c_int]
        lib.tb_conn_plain.restype = c.c_int64
        lib.tb_conn_plain.argtypes = [c.c_int]
        lib.tb_conn_tls.restype = c.c_int64
        lib.tb_conn_tls.argtypes = [
            c.c_int, c.c_char_p, c.c_char_p, c.c_int, c.c_int,
        ]
        lib.tb_conn_close.restype = c.c_int
        lib.tb_conn_close.argtypes = [c.c_int64]
        lib.tb_conn_request.restype = c.c_int64
        lib.tb_conn_request.argtypes = [
            c.c_int64, c.c_char_p, c.c_int, c.c_char_p, c.c_char_p,
            c.c_void_p, c.c_int64, ip, i64p, i64p, ip,
        ]
        lib.tb_conn_get_begin.restype = c.c_int64
        lib.tb_conn_get_begin.argtypes = [
            c.c_int64, c.c_char_p, c.c_int, c.c_char_p, c.c_char_p,
            ip, i64p, i64p,
        ]
        lib.tb_conn_body_read.restype = c.c_int64
        lib.tb_conn_body_read.argtypes = [c.c_int64, c.c_void_p, c.c_int64]
        lib.tb_conn_get_end.restype = c.c_int
        lib.tb_conn_get_end.argtypes = [c.c_int64, ip]
        lib.tb_grpc_submit.restype = c.c_int64
        lib.tb_grpc_submit.argtypes = [
            c.c_int64, c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p,
            c.c_int64, c.c_int64, c.c_void_p, c.c_int64, c.c_uint64,
        ]
        lib.tb_h2_submit_get.restype = c.c_int64
        lib.tb_h2_submit_get.argtypes = [
            c.c_int64, c.c_char_p, c.c_char_p, c.c_char_p,
            c.c_void_p, c.c_int64, c.c_uint64,
        ]
        lib.tb_grpc_poll.restype = c.c_int64
        lib.tb_grpc_poll.argtypes = [
            c.c_int64, c.POINTER(c.c_uint64), i64p, ip, ip, i64p, i64p,
        ]
        lib.tb_grpc_read.restype = c.c_int64
        lib.tb_grpc_read.argtypes = [
            c.c_int64, c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p,
            c.c_int64, c.c_int64, c.c_void_p, c.c_int64, i64p, i64p, ip,
        ]
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

    def alloc(self, size: int, align: int = 4096) -> AlignedBuffer:
        return AlignedBuffer(self, size, align)

    # ---------------------------------------------------------- block I/O --
    # The filesystem workloads' timed loops: per-thread latency arrays, the
    # interpreter lock released for the whole call.

    def open(self, path: str, write: bool = False, create: bool = False,
             direct: bool = False) -> tuple[int, bool]:
        """``(fd, direct_applied)``. A filesystem that rejects ``O_DIRECT``
        (tmpfs, overlay) gets a buffered open instead, and
        ``direct_applied`` says so."""
        flags = (1 if write else 0) | (2 if create else 0) | (4 if direct else 0)
        applied = ctypes.c_int(0)
        fd = self.lib.tb_open(path.encode(), flags, ctypes.byref(applied))
        _check(fd, f"open {path}")
        return fd, bool(applied.value)

    def close(self, fd: int) -> None:
        _check(self.lib.tb_close(fd), "close")

    def file_size(self, path: str) -> int:
        return _check(self.lib.tb_file_size(path.encode()), f"stat {path}")

    def pread_blocks(self, fd: int, buf: AlignedBuffer, block_size: int,
                     offsets: np.ndarray) -> tuple[int, np.ndarray]:
        """One timed ``pread`` of ``block_size`` bytes into ``buf`` per
        offset; ``(total bytes, per-block ns latencies)``. A short final
        block (EOF) is legal."""
        if block_size > buf.size:
            raise ValueError(f"block {block_size} > buffer {buf.size}")
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        lat = np.zeros(len(offs), dtype=np.int64)
        total = self.lib.tb_pread_blocks(
            fd, buf.address, block_size,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(offs),
            lat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        _check(total, "pread_blocks")
        return total, lat

    def read_file_seq(self, fd: int, buf: AlignedBuffer,
                      passes: int = 1) -> tuple[int, np.ndarray]:
        """Stream the whole file through ``buf`` ``passes`` times, each pass
        from offset 0; ``(total bytes, per-pass ns latencies)``."""
        lat = np.zeros(passes, dtype=np.int64)
        total = self.lib.tb_read_file_seq(
            fd, buf.address, buf.size, passes,
            lat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        _check(total, "read_file_seq")
        return total, lat

    def pwrite_blocks(self, fd: int, buf: AlignedBuffer, block_size: int,
                      offsets: np.ndarray,
                      fsync_each: bool = True) -> tuple[int, np.ndarray]:
        """One timed ``pwrite`` of ``buf``'s first ``block_size`` bytes per
        offset, each followed by ``fsync`` when ``fsync_each`` (the
        latency then includes it); ``(total bytes, per-block ns)``."""
        if block_size > buf.size:
            raise ValueError(f"block {block_size} > buffer {buf.size}")
        offs = np.ascontiguousarray(offsets, dtype=np.int64)
        lat = np.zeros(len(offs), dtype=np.int64)
        total = self.lib.tb_pwrite_blocks(
            fd, buf.address, block_size,
            offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(offs),
            1 if fsync_each else 0,
            lat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        _check(total, "pwrite_blocks")
        return total, lat

    def fill_random(self, buf: AlignedBuffer, n: Optional[int] = None,
                    seed: int = 1) -> None:
        """xorshift64* bytes over ``buf`` (its first ``n``), from ``seed``."""
        n = buf.size if n is None else n
        if not 0 <= n <= buf.size:
            raise ValueError(f"fill of {n} B outside a {buf.size} B buffer")
        self.lib.tb_fill_random(buf.address, n, seed)

    # ------------------------------------------------------ conn handles --
    # The same receive loop over plaintext TCP or TLS (dlopen'd OpenSSL).

    def connect(
        self,
        host: str,
        port: int,
        *,
        tls: bool = False,
        sni: str = "",
        cafile: str = "",
        insecure: bool = False,
        alpn_h2: bool = False,
    ) -> int:
        """Open a connection handle. TLS verification: peer cert against
        ``cafile`` (or the system store) plus hostname/IP match on ``sni``
        — ``insecure`` skips both (self-signed test endpoints).
        ``alpn_h2`` offers and requires ALPN h2 (the gRPC and HTTP/2
        clients)."""
        fd = _check(self.lib.tb_http_connect(host.encode(), port),
                    f"connect {host}:{port}")
        if not tls:
            return _check(self.lib.tb_conn_plain(fd), "conn_plain")
        h = self.lib.tb_conn_tls(
            fd, (sni or host).encode(), cafile.encode(),
            1 if insecure else 0, 1 if alpn_h2 else 0,
        )
        if h <= 0:
            self.lib.tb_http_close(fd)  # handshake failed: fd still ours
            _check(int(h), f"tls handshake {host}:{port}")
        return h

    def conn_close(self, handle: int) -> None:
        self.lib.tb_conn_close(handle)

    def conn_request(
        self, handle: int, host: str, port: int, path: str,
        buf: AlignedBuffer, headers: str = "",
    ) -> dict:
        """One whole GET on a connection handle, the body landing in
        ``buf``; ``reusable`` says whether the connection may carry
        another request. On NativeError the caller must
        :meth:`conn_close` the handle (stream state unknown)."""
        status = ctypes.c_int(0)
        fb = ctypes.c_int64(0)
        total_ns = ctypes.c_int64(0)
        reusable = ctypes.c_int(0)
        n = self.lib.tb_conn_request(
            handle, host.encode(), port, path.encode(), headers.encode(),
            buf.address, buf.size, ctypes.byref(status), ctypes.byref(fb),
            ctypes.byref(total_ns), ctypes.byref(reusable),
        )
        _check(n, f"conn_request {host}:{port}{path}")
        return {
            "status": status.value,
            "length": n,
            "first_byte_ns": fb.value,
            "total_ns": total_ns.value,
            "reusable": bool(reusable.value),
        }

    def conn_get_begin(
        self, handle: int, host: str, port: int, path: str, headers: str = "",
    ) -> dict:
        """Streaming GET, phase 1: send the request and parse the response
        headers. Body bytes then stream via :meth:`conn_body_read`
        straight into caller memory. ``content_len`` is -1 for a
        close-delimited body. On NativeError the caller must
        :meth:`conn_close` the handle."""
        status = ctypes.c_int(0)
        clen = ctypes.c_int64(-1)
        fb = ctypes.c_int64(0)
        rc = self.lib.tb_conn_get_begin(
            handle, host.encode(), port, path.encode(), headers.encode(),
            ctypes.byref(status), ctypes.byref(clen), ctypes.byref(fb),
        )
        _check(rc, f"conn_get_begin {host}:{port}{path}")
        return {
            "status": status.value,
            "content_len": clen.value,
            "first_byte_ns": fb.value,
        }

    def conn_body_read(self, handle: int, dst, want: int) -> int:
        """Streaming GET, phase 2: up to ``want`` body bytes land directly
        in ``dst`` (a writable buffer: a staging slot's free view, a
        granule buffer). Returns 0 at body end. The recv runs without the
        GIL. ``want`` is clamped to the destination's size — the engine
        fills ``want`` fully on close-delimited bodies, so an unclamped
        over-ask would overflow the buffer."""
        addr, nbytes = buffer_address(dst)
        want = min(want, nbytes)
        if want <= 0:
            return 0
        return _check(
            self.lib.tb_conn_body_read(handle, addr, want), "conn_body_read"
        )

    def conn_get_end(self, handle: int) -> bool:
        """Streaming GET, phase 3: whether the connection may carry
        another request (False when the body was abandoned mid-stream)."""
        reusable = ctypes.c_int(0)
        _check(
            self.lib.tb_conn_get_end(handle, ctypes.byref(reusable)),
            "conn_get_end",
        )
        return bool(reusable.value)

    # ------------------------------------------------------- h2 and gRPC --
    def h2_submit_get(
        self, handle: int, authority: str, path: str, buf: AlignedBuffer,
        headers: str = "", tag: int = 0,
    ) -> None:
        """Open one HTTP/2 GET stream (the reference's HTTP/2 client
        branch, main.go:76-80): DATA payload bytes land in ``buf``; the
        completion from :meth:`h2_poll` carries ``:status``."""
        self.h2_submit_get_to(handle, authority, path, buf.address,
                              buf.size, headers=headers, tag=tag)

    def h2_submit_get_to(
        self, handle: int, authority: str, path: str, address: int,
        nbytes: int, headers: str = "", tag: int = 0,
    ) -> None:
        """:meth:`h2_submit_get` into raw memory ``(address, nbytes)`` (a
        shard buffer), which must stay valid until the stream's completion
        comes back. Several streams may be open on one connection (up to
        32); ``-EAGAIN`` when the table is full."""
        rc = self.lib.tb_h2_submit_get(
            handle, authority.encode(), path.encode(), headers.encode(),
            address, nbytes, tag,
        )
        if rc != 0:
            _check(int(rc), f"h2_submit_get {path}")

    def grpc_submit(
        self, handle: int, authority: str, bucket_path: str,
        object_name: str, buf: AlignedBuffer, read_offset: int = 0,
        read_limit: int = 0, headers: str = "", tag: int = 0,
    ) -> None:
        """Open one ReadObject as a concurrent h2 stream on the connection
        (grpc-go multiplexes by default; this is the native equivalent),
        content landing in ``buf``. Up to 32 streams a connection;
        ``NativeError(-EAGAIN)`` when the table is full (poll a completion
        first). Completions come back from :meth:`h2_poll` by ``tag``."""
        self.grpc_submit_to(
            handle, authority, bucket_path, object_name, buf.address,
            buf.size, read_offset=read_offset, read_limit=read_limit,
            headers=headers, tag=tag,
        )

    def grpc_submit_to(
        self, handle: int, authority: str, bucket_path: str,
        object_name: str, address: int, nbytes: int, read_offset: int = 0,
        read_limit: int = 0, headers: str = "", tag: int = 0,
    ) -> None:
        """:meth:`grpc_submit` into raw memory ``(address, nbytes)``, which
        must stay valid until the stream's completion comes back."""
        rc = self.lib.tb_grpc_submit(
            handle, authority.encode(), bucket_path.encode(),
            object_name.encode(), headers.encode(), read_offset, read_limit,
            address, nbytes, tag,
        )
        if rc != 0:
            _check(int(rc), f"grpc_submit {object_name}")

    def h2_poll(self, handle: int) -> Optional[dict]:
        """Wait for the next stream completion on the connection; None
        when no stream is active. ``result`` >= 0 is the byte count
        landed, negative that stream's error code (the connection
        survives). Raises NativeError on connection-fatal errors (the
        caller must then conn_close)."""
        tag = ctypes.c_uint64(0)
        result = ctypes.c_int64(0)
        gs = ctypes.c_int(-1)
        hs = ctypes.c_int(-1)
        fb = ctypes.c_int64(0)
        total = ctypes.c_int64(0)
        rc = self.lib.tb_grpc_poll(
            handle, ctypes.byref(tag), ctypes.byref(result),
            ctypes.byref(gs), ctypes.byref(hs),
            ctypes.byref(fb), ctypes.byref(total),
        )
        if rc < 0:
            _check(int(rc), "h2_poll")
        if rc == 0:
            return None
        return {
            "tag": tag.value,
            "result": result.value,
            "grpc_status": gs.value,
            "http_status": hs.value,
            "first_byte_ns": fb.value,
            "total_ns": total.value,
        }

    def grpc_read(
        self, handle: int, authority: str, bucket_path: str,
        object_name: str, buf: AlignedBuffer, read_offset: int = 0,
        read_limit: int = 0, headers: str = "",
    ) -> dict:
        """One google.storage.v2.Storage/ReadObject on a connection handle
        (the engine's h2 client): content bytes land in ``buf``.
        Sequential RPCs reuse the handle (h2 streams 1, 3, 5, ...). On a
        nonzero grpc-status the NativeError carries ``grpc_status``; on
        any error the caller must :meth:`conn_close` the handle."""
        fb = ctypes.c_int64(0)
        total_ns = ctypes.c_int64(0)
        grpc_status = ctypes.c_int(-1)
        n = self.lib.tb_grpc_read(
            handle, authority.encode(), bucket_path.encode(),
            object_name.encode(), headers.encode(), read_offset, read_limit,
            buf.address, buf.size, ctypes.byref(fb), ctypes.byref(total_ns),
            ctypes.byref(grpc_status),
        )
        if n < 0:
            try:
                _check(n, f"grpc_read {object_name}")
            except NativeError as e:
                e.grpc_status = grpc_status.value  # type: ignore[attr-defined]
                raise
        return {
            "length": n,
            "first_byte_ns": fb.value,
            "total_ns": total_ns.value,
            "grpc_status": grpc_status.value,
        }

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
        h2: bool = False,
    ) -> "NativeFetchPool":
        """Native fetch executor. ``mode="threads"``: ``threads`` worker
        pthreads, one keep-alive connection each. ``mode="reactor"``: epoll
        event loop(s) owning all connections (``threads`` is then the
        connection budget), completions over lock-free SPSC rings;
        ``loops`` sets the event-loop thread count (0 = one). ``h2=True``
        (reactor only) multiplexes the GETs as concurrent HTTP/2 streams:
        ALPN on TLS, prior-knowledge h2c on plaintext. A reactor that
        cannot be created falls back to the thread pool —
        :attr:`NativeFetchPool.mode` says what engaged — except under
        ``h2``, which raises: the thread pool speaks HTTP/1.1 only."""
        if mode == "reactor":
            mbits = 1 | (max(0, min(loops, 16)) << 8)
            if h2:
                mbits |= 0x10000 if tls else 0x20000
            h = self.lib.tb_pool_create2(
                threads, cap, 1 if tls else 0, cafile.encode(),
                1 if insecure else 0, mbits,
            )
            if h != 0:
                return NativeFetchPool(self, h, mode="reactor")
        if h2:
            # Serving HTTP/1.1 under an h2 request would mislabel the run.
            raise NativeError(
                "h2 fetch pool requires reactor mode (reactor creation "
                "failed)",
                code=-22,
            )
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


def peek_engine() -> Optional[NativeEngine]:
    """The engine if this process has already loaded it — never builds
    (per-run counter deltas of the read workload)."""
    return _engine
