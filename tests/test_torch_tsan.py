"""Sanitizer matrix for the port's native engine: one stress binary
(``tpubench_torch/native/csrc``'s ``engine.cc`` + ``stress.cc``: per-thread
arrays, fetch pool, srv/discard, reactor exactly-once, stale churn,
destroy hammer, h2c multiplexing, TLS mid-handshake garbage/reset, and
destroy with handshakes in flight) built three ways by
``tpubench_torch.native.build.build_stress`` — TSAN (races), ASAN with
leak checking (heap errors; the destroy-hammer phase is where an
engine-teardown leak would hide), UBSAN non-recovering (UB traps). A
compiler lacking a sanitizer runtime skips that cell; a finding in any
cell is a hard failure.

The file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_tsan.py -m slow
"""

import os
import shutil
import subprocess

import pytest

from tpubench_torch.native.build import (
    SANITIZER_FINDING_MARKERS,
    SANITIZERS,
    SanitizerUnavailable,
    build_stress,
    sanitizer_env,
)


@pytest.mark.slow
@pytest.mark.parametrize("sanitizer", sorted(SANITIZERS))
def test_engine_clean_under_sanitizer(tmp_path, sanitizer):
    if not shutil.which("g++"):
        pytest.skip("g++ unavailable")
    try:
        binary = build_stress(sanitizer)
    except SanitizerUnavailable as e:
        pytest.skip(f"sanitizer runtime unavailable: {e}")

    scratch = tmp_path / "scratch"
    scratch.mkdir()
    run = subprocess.run(
        [str(binary), str(scratch)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **sanitizer_env(sanitizer)},
    )
    assert run.returncode == 0, (
        f"{sanitizer} stress failed (rc={run.returncode}):\n"
        f"{run.stdout}\n{run.stderr}"
    )
    for marker in SANITIZER_FINDING_MARKERS:
        assert marker not in run.stderr, (
            f"{sanitizer} finding:\n{run.stderr}"
        )
    assert "stress ok" in run.stdout
