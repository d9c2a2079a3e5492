"""Device resolution, streams and the capability report.

The counterpart of ``jax.local_devices()`` and ``n_chips`` in the JAX
stagers: worker ``i`` stages onto ``cuda:(i % torch.cuda.device_count())``.
The port runs on CUDA unless the caller asks for the CPU; asking for CUDA
on a machine without it raises instead of carrying on on the CPU.

On CUDA, :func:`worker_stream` gives each worker a stream of its own. On
the CPU there are no streams or events: :func:`worker_stream` returns
``None``, :func:`on_stream` is then a no-op, and :func:`record_event`
returns an event that is already complete (CPU work is synchronous).
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
import threading
from typing import Optional, Union

import torch

from tpubench_torch.kernels import build

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` (the default) or ``cpu`` as a ``torch.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (CLI: --device "
                "cpu) to run the port on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (cuda|cpu)")
    return dev


def worker_device(device: DeviceLike, worker_id: int) -> torch.device:
    """The device worker ``worker_id`` stages onto: round-robin over the
    visible cards when ``device`` names no index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", worker_id % torch.cuda.device_count())
    return dev


def device_count(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


# One stream per (card, worker), made by the kernels' library at the
# worker's first staging run and kept for the life of the process: later
# runs' stagers for that worker take it again, so the streams made are the
# most workers run at once. No stream's life hangs on a stager's (a
# weakref finalizer on torch.cuda.ExternalStream objects crashed the
# interpreter's last garbage collection on the H100 under torch 2.11).
_worker_streams: dict[tuple[int, int], "torch.cuda.ExternalStream"] = {}
_streams_lock = threading.Lock()


def worker_stream(device: torch.device,
                  worker_id: int) -> Optional["torch.cuda.ExternalStream"]:
    """The CUDA stream of worker ``worker_id`` on ``device`` (``None`` on
    the CPU), which no other worker's stager uses. ``torch.cuda.Stream``
    would hand out PyTorch's 32 pooled streams per device in rotation, so
    48 workers would share them in pairs."""
    if device.type != "cuda":
        return None
    index = torch.cuda.current_device() if device.index is None else device.index
    with _streams_lock:
        stream = _worker_streams.get((index, worker_id))
        if stream is None:
            handle = ctypes.c_void_p()
            with torch.cuda.device(index):
                rc = build.load().tb_stream_create(ctypes.byref(handle))
            if rc != 0:
                raise RuntimeError(f"tb_stream_create failed: CUDA error {rc}")
            stream = torch.cuda.ExternalStream(
                handle.value, device=torch.device("cuda", index)
            )
            _worker_streams[(index, worker_id)] = stream
    return stream


def on_stream(stream):
    """Make ``stream`` (and its device) current; a no-op for ``None``."""
    if stream is None:
        return contextlib.nullcontext()
    return torch.cuda.stream(stream)


class _Complete:
    """Event stand-in for CPU work, which is done when it returns."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


_COMPLETE = _Complete()


def record_event(stream):
    """An event recorded on ``stream`` after the work enqueued so far."""
    if stream is None:
        return _COMPLETE
    ev = torch.cuda.Event()
    ev.record(stream)
    return ev


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU, whose
    work is done when it returns)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports
    it, or ``None`` where the tool is missing or fails."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def capability_report() -> dict:
    """What the port would run on: the card's name and count, and the
    ``nvidia-smi`` name and power limit (the ``devices:`` line of
    ``tpubench info``)."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cuda_available": cuda,
        "count": torch.cuda.device_count() if cuda else 0,
        "name": torch.cuda.get_device_name(0) if cuda else None,
        "nvidia_smi": nvidia_smi_line(),
    }
