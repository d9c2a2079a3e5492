"""Landing kernels of the port against the JAX package's Pallas kernels.

On the CPU the port's wrappers route to the plain PyTorch versions; those
are held here, bit for bit, against ``pallas_land``/``pallas_checksum``
(run in interpret mode, as ``tests/test_pallas.py`` runs them) and against
the XLA op ``_accum_checksum`` at a ragged size. The CUDA kernels
themselves run only on the card (marker ``cuda``, skipped without a
device; also ``chip_smoke.py``). Every comparison is exact: addition mod
2³² does not depend on the order of the adds.

The JAX reference is imported inside its tests, so that the ``cuda`` cases
also run on a machine that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from tpubench_torch.kernels import build, landing

MOD = 1 << 32
MAIN_CHECKSUM = 58_255 * 128  # the validate ring's slot on the main path
_BLOCKS, _CHUNK = landing.checksum_plan(MAIN_CHECKSUM, 132)
# Edges of tb_checksum's split on a 132-SM card: the main-path split's end
# ± 1, one chunk + 15, a second block of 15 bytes, a full grid whose last
# block holds 15 bytes (under one vector).
CHECKSUM_EDGES = [_BLOCKS * _CHUNK - 1, _BLOCKS * _CHUNK + 1, _CHUNK + 15,
                  landing.CHECKSUM_MIN_CHUNK + 15, (_BLOCKS - 1) * _CHUNK + 15]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bytes(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


@pytest.mark.parametrize("k", [1, 3])
def test_land_reference_matches_pallas_land(jax_cpu_devices, k):
    import jax

    from tpubench.staging.pallas_stage import pallas_land

    x = _bytes(k, 512 * k * 128).reshape(-1, 128)
    jl, jc = pallas_land(jax.device_put(x))
    landed, acc = landing.land_reference(torch.from_numpy(x.copy()))
    assert np.array_equal(landed.numpy(), np.asarray(jl))
    assert landing.acc_value(acc) == int(jc)


@pytest.mark.parametrize("k", [1, 3])
def test_checksum_reference_matches_pallas_checksum(jax_cpu_devices, k):
    import jax

    from tpubench.staging.pallas_stage import pallas_checksum

    x = _bytes(10 + k, 512 * k * 128).reshape(-1, 128)
    want = int(pallas_checksum(jax.device_put(x)))
    got = landing.acc_value(landing.checksum_reference(torch.from_numpy(x)))
    assert got == want == int(x.sum(dtype=np.uint64)) % MOD


def test_checksum_reference_matches_accum_checksum_ragged(jax_cpu_devices):
    """The validate ring's shape: a lane-rounded slot that is no multiple
    of the 512-row block (777,777 B zero-padded to whole 128-byte rows),
    added onto a nonzero running accumulator."""
    import jax

    from tpubench.staging.device import _accum_checksum

    n = 777_777
    rows = -(-n // 128)
    x = np.zeros(rows * 128, dtype=np.uint8)
    x[:n] = _bytes(7, n)
    x = x.reshape(rows, 128)
    start = 0xFFFF0000
    want = int(_accum_checksum(jax.numpy.uint32(start), jax.device_put(x)))
    acc = torch.tensor([start - MOD], dtype=torch.int32)
    got = landing.acc_value(landing.checksum_reference(torch.from_numpy(x), acc))
    assert got == want


def _chunks(n: int, sms: int):
    blocks, chunk = landing.checksum_plan(n, sms)
    return [(b * chunk, min(n, (b + 1) * chunk)) for b in range(blocks)]


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 65_536, 777_777, MAIN_CHECKSUM,
                               17 * (1 << 20) + 13])
def test_checksum_plan_covers_every_byte_once(n, sms):
    """tb_checksum's split: the chunks tile [0, n) end to end with none
    empty, start on whole 16-byte vectors, and never outnumber the grid."""
    blocks, chunk = landing.checksum_plan(n, sms)
    chunks = _chunks(n, sms)
    assert 1 <= blocks <= max(1, sms * landing.CHECKSUM_BLOCKS_PER_SM)
    assert chunk % 16 == 0 and blocks * chunk >= n
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(lo < hi for lo, hi in chunks) or n == 0
    assert all(lo % 16 == 0 for lo, _ in chunks)


def test_checksum_edges_are_edges_of_the_plan():
    assert (_BLOCKS, _CHUNK) == (264, 28_288)  # ~56 KB per SM
    assert _chunks(CHECKSUM_EDGES[0], 132)[-1][1] % 16 == 15
    assert landing.checksum_plan(CHECKSUM_EDGES[1], 132)[1] > _CHUNK
    assert [hi - lo for lo, hi in _chunks(CHECKSUM_EDGES[3], 132)] == [4096, 15]
    last = _chunks(CHECKSUM_EDGES[4], 132)
    assert len(last) == 264 and last[-1][1] - last[-1][0] == 15


def _emulate_tb_checksum(x: np.ndarray, start: int, sms: int) -> int:
    """tb_checksum's arithmetic in numpy: each block sums its chunk's whole
    16-byte vectors (four bytes per __dp4a) and then its scalar tail; the
    block sums are added onto the accumulator one atomicAdd at a time,
    mod 2³²."""
    acc = start
    for lo, hi in _chunks(x.size, sms):
        body = (hi - lo) & ~15
        words = x[lo:lo + body].view(np.uint32).astype(np.uint64)
        partial = sum(int(((words >> s) & 0xFF).sum()) for s in (0, 8, 16, 24))
        partial += int(x[lo + body:hi].sum(dtype=np.uint64))
        acc = (acc + partial % MOD) % MOD
    return acc


@pytest.mark.parametrize("sms", [1, 132])
def test_checksum_emulation_matches_pallas_and_reference(jax_cpu_devices, sms):
    import jax

    from tpubench.staging.pallas_stage import pallas_checksum

    rng = np.random.default_rng(sms)
    start = int(rng.integers(0, MOD))
    x = _bytes(30 + sms, 2 * 512 * 128)
    pallas = int(pallas_checksum(jax.device_put(x.reshape(-1, 128))))
    assert _emulate_tb_checksum(x, start, sms) == (start + pallas) % MOD
    for n in [0, 15, 777_777, *CHECKSUM_EDGES]:
        x = _bytes(n, n)
        acc = torch.tensor([start - MOD if start >= MOD // 2 else start],
                           dtype=torch.int32)
        want = landing.acc_value(landing.checksum_reference(torch.from_numpy(x), acc))
        assert _emulate_tb_checksum(x, start, sms) == want


def test_accumulator_chaining_wraps_past_2_32():
    """One accumulator across many slots (the stagers' use) wraps mod 2³²
    exactly like the Python-int sum."""
    total = 0xF0000000
    acc = torch.tensor([total - MOD], dtype=torch.int32)
    for seed in range(6):
        x = np.full(1 << 20, 0xFF, dtype=np.uint8) if seed % 2 else _bytes(seed, 1 << 20)
        landing.checksum(torch.from_numpy(x), acc)
        total += int(x.sum(dtype=np.uint64))
    assert total > MOD  # the chain really wrapped
    assert landing.acc_value(acc) == total % MOD
    landed, acc2 = landing.land(torch.from_numpy(_bytes(9, 4096)), acc)
    assert acc2 is acc  # added in place, as the kernel does


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    landing.reset_launches()
    x = torch.from_numpy(_bytes(3, 3 * 65_536 + 5))
    landed, acc = landing.land(x)
    assert torch.equal(landed, x) and landed.data_ptr() != x.data_ptr()
    assert landing.acc_value(acc) == landing.acc_value(landing.land_reference(x)[1])
    assert landing.acc_value(landing.checksum(x)) == int(x.numpy().sum(dtype=np.uint64)) % MOD
    assert landing.land.launches == 0 and landing.checksum.launches == 0


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(64, dtype=torch.int32), TypeError),
    (torch.zeros(64, 4, dtype=torch.uint8).t(), ValueError),
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        landing.land(bad)
    with pytest.raises(err):
        landing.checksum(bad)


def test_accumulator_is_checked():
    x = torch.zeros(128, dtype=torch.uint8)
    with pytest.raises(TypeError):
        landing.checksum(x, torch.zeros(1, dtype=torch.int64))
    with pytest.raises(TypeError):
        landing.land(x, torch.zeros(2, dtype=torch.int32))


def test_library_is_keyed_by_source_hash(monkeypatch, tmp_path):
    """The kernel library is named by a hash of sources and flags (so an
    edited source rebuilds), and a missing nvcc raises — no fallback."""
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-DX",))
    assert build.library_path() != path
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if not build.os.access("/usr/local/cuda/bin/nvcc", build.os.X_OK):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.nvcc()


def test_source_notes_name_the_tpu_kernels():
    src = build.SOURCES[0].read_text()
    for needle in ("pallas_land", "pallas_checksum", "_accum_checksum",
                   "atomicAdd", "bytes / HBM bandwidth", "persistent grid",
                   "checksum_plan", "before its first add", "L2::256B"):
        assert needle in src


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512 * 128, 58_368 * 128, MAIN_CHECKSUM,
                               777_777, 15, 0, *CHECKSUM_EDGES, 256 << 20])
def test_cuda_kernels_match_plain_versions(cuda, n):
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randint(0, 256, (n,), dtype=torch.uint8, device=cuda, generator=g)
    landing.reset_launches()
    landed, acc = landing.land(x)
    ref_landed, ref_acc = landing.land_reference(x)
    assert torch.equal(landed, ref_landed)
    assert landing.acc_value(acc) == landing.acc_value(ref_acc)
    assert landing.acc_value(landing.checksum(x)) == landing.acc_value(
        landing.checksum_reference(x))
    assert landing.land.launches == 1 and landing.checksum.launches == 1


@pytest.mark.cuda
def test_cuda_accumulator_wraps(cuda):
    x = torch.full((17 << 20,), 0xFF, dtype=torch.uint8, device=cuda)
    assert landing.acc_value(landing.checksum(x)) == (255 * x.numel()) % MOD
    acc = landing.new_acc(cuda)
    for _ in range(3):
        landing.land(x, acc)
    assert landing.acc_value(acc) == (3 * 255 * x.numel()) % MOD


@pytest.mark.cuda
def test_cuda_misaligned_input_is_refused(cuda):
    x = torch.zeros(4096, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        landing.land(x[1:])
