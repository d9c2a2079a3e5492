"""Local/FUSE filesystem backend (reference ``benchmark-script/`` L0
path) — a copy of ``tpubench/storage/local_fs.py``.

Objects are relative file paths under a directory root, read with
``pread`` straight into the caller's buffer (a granule buffer or a staging
slot). Writes are one-shot (``write``) or resumable (``open_write``: parts
append to a hidden ``.part`` sibling, renamed into place at finalize).
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


class _FsWriter:
    """ObjectWriter over a hidden ``.part`` staging file (see
    LocalFsBackend.open_write). ``offset`` tracks the fsynced size —
    the durable committed watermark a crashed-and-resumed session can
    re-probe with ``committed()``."""

    def __init__(self, backend: "LocalFsBackend", name: str,
                 if_generation_match):
        self._backend = backend
        self.name = name
        self._igm = if_generation_match
        self._final_path = backend._path(name)
        self._part_path = self._final_path + ".part"
        os.makedirs(os.path.dirname(self._part_path), exist_ok=True)
        # Resume an interrupted session when a part file already exists
        # (the FS twin of re-probing a live session URL).
        self.offset = (
            os.path.getsize(self._part_path)
            if os.path.exists(self._part_path) else 0
        )
        self._done = False

    def write(self, data) -> int:
        if self._done:
            raise StorageError(
                f"writer for {self.name!r} already finalized",
                transient=False, code=400,
            )
        payload = memoryview(data).cast("B")
        try:
            fd = os.open(self._part_path, os.O_WRONLY | os.O_CREAT)
            try:
                os.lseek(fd, self.offset, os.SEEK_SET)
                written = 0
                while written < len(payload):
                    # os.write may write SHORT (near-full fs, signals);
                    # an unchecked return would advance the watermark
                    # past bytes that never landed.
                    n = os.write(fd, payload[written:])
                    if n <= 0:
                        raise OSError("zero-byte write")
                    written += n
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError as e:
            raise StorageError(f"part write failed: {e}", transient=False) from e
        self.offset += len(payload)
        return self.offset

    def committed(self) -> int:
        self.offset = (
            os.path.getsize(self._part_path)
            if os.path.exists(self._part_path) else self.offset
        )
        return self.offset

    def finalize(self) -> ObjectMeta:
        if self._done:
            return ObjectMeta(self.name, self.offset, 1)
        self._backend._check_generation(self.name, self._igm)
        try:
            os.replace(self._part_path, self._final_path)
        except OSError as e:
            raise StorageError(f"finalize failed: {e}", transient=False) from e
        self._done = True
        return ObjectMeta(self.name, self.offset, 1)

    def abort(self) -> None:
        try:
            os.remove(self._part_path)
        except OSError:
            pass


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

    def _check_generation(self, name: str, want) -> None:
        """FS generation model (the one a filesystem can honestly offer):
        an existing file is generation 1, an absent one 0 — so
        ``if_generation_match=0`` is the create-only precondition and 1
        the overwrite-only one. Mismatch is the same non-transient 412
        the object stores raise."""
        if want is None:
            return
        current = 1 if os.path.exists(self._path(name)) else 0
        if current != want:
            raise StorageError(
                f"if_generation_match={want} does not match FS state "
                f"{current} of {name!r}", transient=False, code=412,
            )

    def write(self, name: str, data: bytes,
              if_generation_match=None) -> ObjectMeta:
        self._check_generation(name, if_generation_match)
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        return ObjectMeta(name, len(data), 1)

    def open_write(self, name: str, if_generation_match=None):
        """Resumable session, FS edition: parts append to a hidden
        ``.part`` sibling (committed offset = its size, durable via
        fsync per part — the write_operations fsync discipline), finalize
        fsyncs and atomically renames into place. The precondition is
        checked at finalize, commit-time like the object stores."""
        return _FsWriter(self, name, if_generation_match)

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

    def delete(self, name: str) -> None:
        try:
            os.remove(self._path(name))
        except FileNotFoundError:
            raise StorageError(f"object not found: {name}", transient=False, code=404)

    def close(self) -> None:
        pass
