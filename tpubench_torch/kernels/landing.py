"""Landing kernels: wrappers, plain versions and launch counters.

* :func:`land` — fused landing pass: a copy of a staged slot plus its
  mod-2³² byte sum added into a device accumulator (CUDA ``tb_land``,
  replacing ``pallas_land``).
* :func:`checksum` — the same byte sum without the copy (CUDA
  ``tb_checksum``, replacing ``pallas_checksum`` and ``_accum_checksum``).

The accumulator is a ``(1,)`` int32 tensor whose bits are the uint32 sum
(int32 two's-complement wraparound is exactly mod-2³² arithmetic, the
same trick the TPU kernels use); read it with :func:`acc_value`. Both
kernels ADD into it in place, so one accumulator chains across slots.

Routing is by the tensor's device and nothing else: a CPU tensor goes to
the plain PyTorch version (``land_reference``/``checksum_reference``), a
CUDA tensor to the kernel — and a failed build or launch raises. The
kernel runs on the current stream of ``x``'s device (the stagers make
their own stream current), where its output and a fresh accumulator are
allocated too.

``land.launches`` and ``checksum.launches`` count kernel launches (never
plain-version calls), so a run can show which kernels it went through.

:func:`checksum_plan` is how ``tb_checksum`` splits its input over the
card: it runs here, in Python, and the kernel is handed its result.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from tpubench_torch.kernels import build

_MOD = 1 << 32
# tb_checksum's grid: two persistent blocks per SM, each owning one chunk
# of whole 128-byte rows, at least one 16-byte vector for each of a
# block's 256 threads.
CHECKSUM_BLOCKS_PER_SM = 2
CHECKSUM_ALIGN = 128
CHECKSUM_MIN_CHUNK = 256 * 16
# The counters are bumped from many worker threads: `+= 1` on an
# attribute is a read-modify-write the interpreter may interleave.
_count_lock = threading.Lock()


def _check_input(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"{what}: expected uint8, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be 16-byte aligned")


def _check_acc(acc: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if acc.dtype != torch.int32 or acc.shape != (1,):
        raise TypeError(f"{what}: accumulator must be int32 of shape (1,)")
    if acc.device != x.device:
        raise ValueError(
            f"{what}: accumulator on {acc.device}, input on {x.device}"
        )


def new_acc(device) -> torch.Tensor:
    """A zeroed accumulator on ``device`` (allocated and filled on the
    current stream — create it under the stream that will add into it)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def acc_value(acc: torch.Tensor) -> int:
    """The accumulator as a uint32 Python int (a device readback)."""
    return int(acc.item()) & 0xFFFFFFFF


# ---------------------------------------------------------- plain versions --
def _add_into(acc: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    total = x.to(torch.int64).sum()
    if acc is None:
        acc = torch.zeros(1, dtype=torch.int32, device=x.device)
    v = (acc.to(torch.int64) + total) & 0xFFFFFFFF
    acc.copy_(torch.where(v >= _MOD // 2, v - _MOD, v).to(torch.int32))
    return acc


def land_reference(x: torch.Tensor, acc: Optional[torch.Tensor] = None):
    """Plain version of :func:`land`: ``(x.clone(), acc + sum(x) mod 2³²)``."""
    return x.clone(), _add_into(acc, x)


def checksum_reference(x: torch.Tensor,
                       acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`checksum`: ``acc + sum(x) mod 2³²``."""
    return _add_into(acc, x)


# ----------------------------------------------------------------- kernels --
def checksum_plan(n: int, sms: int,
                  per_sm: int = CHECKSUM_BLOCKS_PER_SM) -> tuple[int, int]:
    """``(blocks, chunk)`` for ``tb_checksum`` over ``n`` bytes on a card
    with ``sms`` SMs: block ``b`` sums ``[b*chunk, min(n, (b+1)*chunk))``.
    At most ``sms * per_sm`` blocks, every chunk starts on a multiple of
    ``CHECKSUM_ALIGN``, and ``n == 0`` still gets one (empty) block."""
    grid = sms * per_sm
    chunk = -(-n // grid)
    chunk = max(CHECKSUM_MIN_CHUNK, -(-chunk // CHECKSUM_ALIGN) * CHECKSUM_ALIGN)
    return max(1, -(-n // chunk)), chunk


_sms: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """SMs of the CUDA ``device``, read once per device."""
    index = torch.cuda.current_device() if device.index is None else device.index
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn} failed: CUDA error {rc}")


def land(x: torch.Tensor, acc: Optional[torch.Tensor] = None):
    """Landed copy of ``x`` and ``acc`` with ``x``'s byte sum added
    (mod 2³²). ``acc=None`` starts from a fresh zero accumulator, which
    makes the pair equal to ``pallas_land(x)``."""
    _check_input(x, "land")
    if acc is not None:
        _check_acc(acc, x, "land")
    if x.device.type == "cpu":
        return land_reference(x, acc)
    lib = build.load()
    with torch.cuda.device(x.device):
        s = torch.cuda.current_stream()
        if acc is None:
            acc = new_acc(x.device)
        out = torch.empty_like(x)
        rc = lib.tb_land(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(acc.data_ptr()), ctypes.c_int64(x.numel()),
            ctypes.c_void_p(s.cuda_stream),
        )
    _raise_on(rc, "tb_land")
    with _count_lock:
        land.launches += 1
    return out, acc


def checksum(x: torch.Tensor,
             acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``acc`` with ``x``'s byte sum added (mod 2³²); ``acc=None`` starts
    from zero, matching ``pallas_checksum(x)``. Any length is accepted."""
    _check_input(x, "checksum")
    if acc is not None:
        _check_acc(acc, x, "checksum")
    if x.device.type == "cpu":
        return checksum_reference(x, acc)
    lib = build.load()
    blocks, chunk = checksum_plan(x.numel(), sm_count(x.device))
    with torch.cuda.device(x.device):
        s = torch.cuda.current_stream()
        if acc is None:
            acc = new_acc(x.device)
        rc = lib.tb_checksum(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(acc.data_ptr()),
            ctypes.c_int64(x.numel()), ctypes.c_int(blocks),
            ctypes.c_int64(chunk), ctypes.c_void_p(s.cuda_stream),
        )
    _raise_on(rc, "tb_checksum")
    with _count_lock:
        checksum.launches += 1
    return acc


land.launches = 0
checksum.launches = 0


def reset_launches() -> None:
    with _count_lock:
        land.launches = 0
        checksum.launches = 0
