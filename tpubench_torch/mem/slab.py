"""Refcounted slab pool: the allocation substrate of the zero-copy ingest
datapath (``tpubench/mem/slab.py``).

A :class:`SlabPool` owns ``n_slabs`` fixed-size slabs, each a 1-D uint8
tensor. On CUDA every slab is page-locked (``pin_memory=True``, as the
staging slots are): an asynchronous copy to the card reads straight out
of it. A slab that cannot be page-locked raises; there is no pageable
fallback for the pool's own slabs. On the CPU the slabs are plain
tensors.

Lifecycle is **lease → share → release**:

* :meth:`SlabPool.lease` hands out a :class:`SlabLease` with refcount 1
  (the leaser's reference). The transport ``readinto``\\ s wire bytes
  straight into ``lease.view()``.
* Every party that needs the bytes to outlive the current lock scope
  takes its own reference (:meth:`SlabLease.incref`): the chunk cache
  takes one at insert, and hands one to each consumer it serves.
* :meth:`SlabLease.release` drops a reference; the LAST release retires
  the slab to the pool's free list. A cache eviction racing a consumer
  mid-read therefore never frees memory under the reader, and a slab
  handed to the staging window goes back only when its copy has landed.

Exhaustion never deadlocks: a lease requested from an empty pool is
served from a transient, pageable **overflow** allocation (counted in
``stats()['overflow_leases']``: sustained overflow means the pool is
undersized), dropped rather than pooled on retirement. Nothing is
page-locked once the pool is built.

Leak detection: :meth:`SlabPool.close` reports (and keeps alive, so no
view dangles) anything still leased; ``stats()['leaked_slabs']`` must be
0 after a clean run.

``stats()`` keeps ``tpubench``'s keys; its ``native`` means "page-locked"
here, as ``staging.native_slots`` does.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import torch

from tpubench_torch.device import DeviceLike, resolve_device


def _new_slab(nbytes: int, pinned: bool) -> tuple:
    """``(tensor, ndarray)`` over one slab; the array is the tensor's
    memory, kept so a view costs no conversion."""
    t = torch.empty(nbytes, dtype=torch.uint8, pin_memory=pinned)
    if pinned and not t.is_pinned():
        raise RuntimeError("slab is not page-locked")
    return t, t.numpy()


class SlabLease:
    """One leased slab: a bounded writable view plus a refcount.

    ``len(lease)`` is the payload size it was leased for (not the slab
    capacity), so cache byte accounting treats leases and ``bytes``
    uniformly. The underlying memory is valid until the LAST reference
    releases."""

    __slots__ = ("_pool", "_slab", "nbytes", "_refs", "overflow")

    def __init__(self, pool: "SlabPool", slab: tuple, nbytes: int,
                 overflow: bool):
        self._pool = pool
        self._slab = slab  # (tensor, ndarray)
        self.nbytes = nbytes
        self._refs = 1
        self.overflow = overflow

    def __len__(self) -> int:
        return self.nbytes

    def _live(self) -> tuple:
        if self._slab is None:
            raise ValueError("slab lease already fully released")
        return self._slab

    def view(self, n: Optional[int] = None) -> memoryview:
        """Writable memoryview of the first ``n`` (default: leased) bytes."""
        want = self.nbytes if n is None else n
        return memoryview(self._live()[1][:want])

    def tobytes(self) -> bytes:
        """Copying escape hatch (not the hot path)."""
        return bytes(self.view())

    def as_tensor(self) -> torch.Tensor:
        """Zero-copy 1-D uint8 tensor over the leased payload (page-locked
        on CUDA): what the overlapped staging window copies to the card
        directly, so a chunk goes wire → slab → HBM with no host copy in
        between. It aliases the slab: valid only while the caller's
        reference is held (the window's reaper releases at transfer
        completion, which is exactly that lifetime)."""
        return self._live()[0][: self.nbytes]

    def incref(self) -> "SlabLease":
        with self._pool._lock:
            if self._refs <= 0:
                raise ValueError("incref on a fully released slab lease")
            self._refs += 1
        return self

    def release(self) -> None:
        """Drop one reference; the last one retires the slab to the pool."""
        self._pool._release(self)


class SlabPool:
    """Fixed-size slab pool (module docstring). Thread-safe.

    ``device`` is where the leased bytes go: ``"cuda"`` page-locks every
    slab (``pin_seconds`` is the time that took), ``"cpu"`` does not."""

    def __init__(self, slab_bytes: int, n_slabs: int, *,
                 device: DeviceLike = "cuda"):
        if slab_bytes <= 0:
            raise ValueError(f"slab_bytes={slab_bytes}: must be > 0")
        if n_slabs <= 0:
            raise ValueError(f"n_slabs={n_slabs}: must be > 0")
        self.slab_bytes = int(slab_bytes)
        self.n_slabs = int(n_slabs)
        self._lock = threading.Lock()
        self._closed = False
        self.native = resolve_device(device).type == "cuda"
        t0 = time.perf_counter()
        self._free: list = [
            _new_slab(self.slab_bytes, self.native)
            for _ in range(self.n_slabs)
        ]
        self.pin_seconds = time.perf_counter() - t0
        # Counters (the extra["pipeline"]["copies"]["pool"] stamp).
        self.leases = 0
        self.retires = 0
        self.overflow_leases = 0
        self.peak_leased = 0
        self._leased = 0
        self.leaked_slabs = 0

    # ------------------------------------------------------------ surface --
    def lease(self, nbytes: int) -> SlabLease:
        """A slab sized to hold ``nbytes`` (refcount 1, caller-owned).
        Raises ValueError when ``nbytes`` exceeds the slab size — the
        caller's chunking is wrong, not the pool's."""
        if nbytes > self.slab_bytes:
            raise ValueError(
                f"lease of {nbytes} B exceeds slab_bytes={self.slab_bytes}"
            )
        with self._lock:
            if self._closed:
                raise ValueError("pool closed")
            slab = self._free.pop() if self._free else None
            overflow = slab is None
            self.leases += 1
            if overflow:
                self.overflow_leases += 1
            self._leased += 1
            self.peak_leased = max(self.peak_leased, self._leased)
        if overflow:
            # Transient pageable allocation outside the pool: never pooled
            # on retirement, so the pool's footprint stays n_slabs slabs
            # plus whatever is overflowed right now, and nothing is
            # page-locked on the step path.
            slab = _new_slab(self.slab_bytes, False)
        return SlabLease(self, slab, int(nbytes), overflow)

    def _release(self, lease: SlabLease) -> None:
        with self._lock:
            if lease._refs <= 0:
                raise ValueError("release of a fully released slab lease")
            lease._refs -= 1
            if lease._refs > 0:
                return
            slab, lease._slab = lease._slab, None
            self._leased -= 1
            self.retires += 1
            if not (lease.overflow or self._closed):
                self._free.append(slab)

    def close(self) -> dict:
        """Drop pooled slabs; anything still leased is counted as leaked
        and (deliberately) kept alive — a dangling view would be worse
        than the leak it reports. Returns final :meth:`stats`."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._free = []
                self.leaked_slabs = self._leased
            return self.stats_locked()

    # -------------------------------------------------------------- stats --
    def stats_locked(self) -> dict:
        return {
            "slab_bytes": self.slab_bytes,
            "slabs": self.n_slabs,
            "native": self.native,
            "leased": self._leased,
            "peak_leased": self.peak_leased,
            "leases": self.leases,
            "retires": self.retires,
            "overflow_leases": self.overflow_leases,
            "leaked_slabs": self.leaked_slabs,
        }

    def stats(self) -> dict:
        with self._lock:
            return self.stats_locked()

    @property
    def leased(self) -> int:
        with self._lock:
            return self._leased


# ------------------------------------------------------- payload helpers --
# A chunk payload is either immutable ``bytes`` (the A/B baseline arm) or
# a SlabLease (the zero-copy arm); these two helpers are the only
# polymorphism consumers need.


def payload_view(data) -> memoryview:
    """Read view of a chunk payload (bytes or SlabLease), no copy."""
    if isinstance(data, SlabLease):
        return data.view()
    return memoryview(data)


def release_payload(data) -> None:
    """Drop the caller's reference on a payload (no-op for bytes)."""
    if isinstance(data, SlabLease):
        data.release()


class CopyMeter:
    """Counts host-RAM writes of chunk payload bytes on the ingest path.

    ``landed_bytes`` is the unavoidable write: wire → first host buffer
    (slab or bytearray). ``copied_bytes`` is every write AFTER that —
    ``bytes()`` materialization, cache insert copies, coalesce copies.
    ``copies_per_byte`` = (landed + copied) / landed: exactly 1.0 means
    a chunk is written once off the wire and never copied again (the
    slab path's contract); the bytes path pays >= 2.0.

    Staging writes (host cache → slot ring / HBM) are out of scope: both
    A/B arms pay them alike, and the staging subsystem accounts them
    (``staged_bytes``). So is transport-internal buffering (a hedged
    read's racing streams buffer once more inside ``storage/tail.py`` on
    both arms).
    """

    __slots__ = ("_lock", "landed_bytes", "copied_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        self.landed_bytes = 0
        self.copied_bytes = 0

    def landed(self, n: int) -> None:
        with self._lock:
            self.landed_bytes += int(n)

    def copied(self, n: int) -> None:
        with self._lock:
            self.copied_bytes += int(n)

    def copies_per_byte(self) -> Optional[float]:
        with self._lock:
            if not self.landed_bytes:
                return None
            return (self.landed_bytes + self.copied_bytes) / self.landed_bytes

    def stats(self) -> dict:
        with self._lock:
            landed, copied = self.landed_bytes, self.copied_bytes
        return {
            "landed_bytes": landed,
            "copied_bytes": copied,
            "copies_per_byte": (
                (landed + copied) / landed if landed else None
            ),
        }
