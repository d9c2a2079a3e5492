"""Build the native data-path engine (host C++: the fetch executor
``tb_pool_*``, the loopback source server ``tb_srv_*``, HTTP/1.1 and TLS)
with ``g++`` and return the shared library's path.

The sources under ``csrc/`` compile in a few seconds. The library lands in
``build/tpubench_torch/`` at the repository root, named by a hash of the
sources and the flags: editing a source builds a new library on first use,
and ``rm -rf build/tpubench_torch`` forces a rebuild. A failed build
raises; nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "engine.cc",)
HEADERS = (CSRC / "hpack_huffman.h",)
BUILD_DIR = _PKG.parents[1] / "build" / "tpubench_torch"
# -ldl: the engine dlopens OpenSSL (libssl.so.3) at first TLS use.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall")
LINK_FLAGS = ("-ldl",)

_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libtb_engine-{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile the engine unless the hashed library already exists. The
    output goes to a pid-suffixed temporary name first and is renamed into
    place, so concurrent builds (several test processes) or an interrupted
    one never leave a half-written library."""
    with _lock:
        lib = library_path()
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES),
               *LINK_FLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
        return lib
