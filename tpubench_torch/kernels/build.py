"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` have a plain C interface, so they compile in
seconds without PyTorch's headers. The shared library lands in
``build/tpubench_torch/`` at the repository root, named by a hash of the
sources and the flags: editing a source builds a new library on first use,
and ``rm -rf build/tpubench_torch`` forces a rebuild. The compiler's
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is
kept beside the library as ``<name>.log``.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "landing.cu",)
BUILD_DIR = _PKG.parents[1] / "build" / "tpubench_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Seconds the last build in this process took (0.0 = library was cached).
last_build_s = 0.0


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``. Raises when there is none."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from tpubench_torch/kernels/csrc on first use"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtb_landing-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless the hashed file already exists. The
    output goes to a temporary name first and is renamed into place, so a
    concurrent or interrupted build never leaves a half-written library."""
    global last_build_s
    lib = library_path()
    if lib.exists():
        last_build_s = 0.0
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_s = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The built library with every entry point's ``argtypes`` declared
    (a pointer passed as a default ``int`` would be cut to 32 bits)."""
    global _lib
    if _lib is not None:  # every launch comes here: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.tb_land.argtypes = [ptr, ptr, ptr, i64, ptr]
            lib.tb_checksum.argtypes = [ptr, ptr, i64, i32, i64, ptr]
            lib.tb_stream_create.argtypes = [ctypes.POINTER(ptr)]
            for fn in (lib.tb_land, lib.tb_checksum, lib.tb_stream_create):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
