"""Build the native data-path engine (host C++: the fetch executor
``tb_pool_*``, the loopback source server ``tb_srv_*``, HTTP/1.1 and TLS)
with ``g++`` and return the shared library's path — plus the sanitizer
matrix of the engine's stress harness.

The sources under ``csrc/`` compile in a few seconds. The library lands in
``build/tpubench_torch/`` at the repository root, named by a hash of the
sources and the flags: editing a source builds a new library on first use,
and ``rm -rf build/tpubench_torch`` forces a rebuild. A failed build
raises; nothing here runs at import.

The matrix (:func:`build_stress`) builds ``engine.cc`` + ``stress.cc``
(per-thread arrays, fetch pool, srv/discard, reactor exactly-once, stale
churn, destroy hammer, h2c multiplexing, TLS mid-handshake faults) as one
executable under TSAN, ASAN with leak checking, and non-recovering UBSAN,
beside the library and keyed the same way. A compiler without a
sanitizer's runtime raises :class:`SanitizerUnavailable`, so the cell is
skipped, not failed.
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
STRESS_SOURCE = CSRC / "stress.cc"
BUILD_DIR = _PKG.parents[1] / "build" / "tpubench_torch"
# -ldl: the engine dlopens OpenSSL (libssl.so.3) at first TLS use.
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall")
LINK_FLAGS = ("-ldl",)

_lock = threading.Lock()


# sanitizer name -> (compile flags, runtime env). halt_on_error +
# exitcode=66 everywhere: a finding is a hard failure, never a warning
# scrolled past. ASAN runs with leak detection ON — the destroy-hammer
# phase is exactly where an engine teardown leak would hide; UBSAN
# compiles with -fno-sanitize-recover so UB traps instead of logging.
SANITIZERS: dict[str, tuple[list[str], dict[str, str]]] = {
    "thread": (
        ["-fsanitize=thread"],
        {"TSAN_OPTIONS": "halt_on_error=1 exitcode=66"},
    ),
    "address": (
        ["-fsanitize=address", "-fno-omit-frame-pointer"],
        {"ASAN_OPTIONS": "detect_leaks=1:halt_on_error=1:exitcode=66"},
    ),
    "undefined": (
        ["-fsanitize=undefined", "-fno-sanitize-recover=all"],
        {"UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1:"
                          "exitcode=66"},
    ),
}
STRESS_FLAGS = ("-O1", "-g", "-std=c++17")
# -ldl as for the library: engine.cc dlopens OpenSSL at first use.
STRESS_LINK_FLAGS = ("-lpthread", "-ldl")

# stderr markers that mean "a sanitizer spoke" — asserted absent even
# when the exit code lies (forked children, _exit paths).
SANITIZER_FINDING_MARKERS = (
    "WARNING: ThreadSanitizer",
    "ERROR: AddressSanitizer",
    "ERROR: LeakSanitizer",
    "runtime error:",
)


class SanitizerUnavailable(RuntimeError):
    """The toolchain cannot build/link this sanitizer — a skip, not a
    failure (containers often ship g++ without every libsan)."""


def _hashed(stem: str, files, flags) -> Path:
    h = hashlib.sha256()
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}"


def library_path() -> Path:
    lib = _hashed("libtb_engine", SOURCES + HEADERS, CXX_FLAGS + LINK_FLAGS)
    return lib.with_name(lib.name + ".so")


def stress_path(sanitizer: str) -> Path:
    flags, _env = SANITIZERS[sanitizer]
    return _hashed(f"stress_{sanitizer}",
                   SOURCES + HEADERS + (STRESS_SOURCE,),
                   STRESS_FLAGS + tuple(flags) + STRESS_LINK_FLAGS)


def sanitizer_env(sanitizer: str) -> dict[str, str]:
    return dict(SANITIZERS[sanitizer][1])


def build_stress(sanitizer: str) -> Path:
    """Build ``engine.cc`` + ``stress.cc`` under ``sanitizer`` (unless the
    hashed executable already exists) and return its path.

    Raises :class:`SanitizerUnavailable` when the compile/link failure
    names the sanitizer runtime, ``RuntimeError`` on a genuine source
    build break (that one must fail the caller)."""
    flags, _env = SANITIZERS[sanitizer]
    out = stress_path(sanitizer)
    with _lock:
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *STRESS_FLAGS, *flags, *map(str, SOURCES),
               str(STRESS_SOURCE), "-o", str(tmp), *STRESS_LINK_FLAGS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            err = proc.stderr.lower()
            if any(tok in err for tok in ("sanitize", "asan", "tsan",
                                          "ubsan")):
                raise SanitizerUnavailable(
                    f"{sanitizer}: {proc.stderr.strip()[-200:]}"
                )
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        return out


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
