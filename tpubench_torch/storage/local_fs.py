"""Local/FUSE filesystem backend (reference ``benchmark-script/`` L0
path) — the read side of ``tpubench/storage/local_fs.py``.

Objects are relative file paths under a directory root, read with
``pread`` straight into the caller's buffer (a granule buffer or a staging
slot). The write side (``_FsWriter``, ``write``/``open_write``/``delete``)
comes with the write workloads (``ROADMAP.md`` A.6).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from tpubench_torch.storage.base import ObjectMeta, StorageError


class _FileReader:
    def __init__(self, fd: int, start: int, length: int):
        self._fd = fd
        self._pos = start
        self._end = start + length
        self.first_byte_ns: Optional[int] = None

    def readinto(self, buf: memoryview) -> int:
        want = min(len(buf), self._end - self._pos)
        if want <= 0:
            return 0
        try:
            n = os.preadv(self._fd, [buf[:want]], self._pos)
        except OSError as e:
            raise StorageError(f"pread failed: {e}", transient=False) from e
        if n == 0:
            return 0
        if self.first_byte_ns is None:
            self.first_byte_ns = time.perf_counter_ns()
        self._pos += n
        return n

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1


class LocalFsBackend:
    def __init__(self, root: str):
        if not root:
            raise ValueError("local backend needs workload.dir")
        self.root = root

    def _path(self, name: str) -> str:
        root = os.path.normpath(self.root)
        p = os.path.normpath(os.path.join(root, name))
        if p != root and not p.startswith(root + os.sep):
            raise StorageError(f"path escapes root: {name}", transient=False)
        return p

    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        path = self._path(name)
        try:
            fd = os.open(path, os.O_RDONLY)
        except FileNotFoundError:
            raise StorageError(f"object not found: {name}", transient=False, code=404)
        except OSError as e:
            raise StorageError(f"open failed: {e}", transient=False) from e
        size = os.fstat(fd).st_size
        end = size if length is None else min(start + length, size)
        return _FileReader(fd, start, max(0, end - start))

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]:
        # page_size is a wire concept; a directory walk has no pages.
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fname in files:
                if fname.endswith(".part"):
                    continue  # in-flight resumable uploads are invisible
                full = os.path.join(dirpath, fname)
                rel = os.path.relpath(full, self.root)
                if rel.startswith(prefix):
                    out.append(ObjectMeta(rel, os.path.getsize(full), 1))
        return sorted(out, key=lambda m: m.name)

    def stat(self, name: str) -> ObjectMeta:
        path = self._path(name)
        try:
            return ObjectMeta(name, os.path.getsize(path), 1)
        except FileNotFoundError:
            raise StorageError(f"object not found: {name}", transient=False, code=404)

    def close(self) -> None:
        pass
