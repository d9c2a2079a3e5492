"""Landing-kernel staging ring — the port of ``PallasStager``
(``tpubench/staging/pallas_stage.py``), selected by ``staging.mode =
"pallas"`` so one config drives both packages.

A slot's launch is one asynchronous host→device copy followed by the
landing kernel (:func:`tpubench_torch.kernels.landing.land`: a copy of the
staged slot plus its byte sum added into the stager's device accumulator),
both on the stager's own stream, then an event. The ring rotates and the
PREVIOUS in-flight launch of a slot drains lazily at the next ``acquire``
of that slot (the backpressure point), so fetch and landing overlap up to
``depth`` slots. It always validates: the checksum is free inside the
landing pass, and ``finish`` pays ONE device readback of the accumulator.

Slots round up to whole 512×128 blocks, as the TPU kernel's grid needs,
so ``transfers`` and ``slot_bytes`` match the JAX package exactly.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from tpubench_torch.config import StagingConfig
from tpubench_torch.device import (
    device_count,
    on_stream,
    record_event,
    worker_device,
    worker_stream,
)
from tpubench_torch.kernels import landing
from tpubench_torch.metrics.recorder import LatencyRecorder
from tpubench_torch.obs.profiling import hot_region
from tpubench_torch.staging.device import (
    TRANSFER_WAIT,
    GranuleAggregator,
    new_slot,
)
from tpubench_torch.staging.executor import copy_to_device

LANE = 128
BLOCK_ROWS = 512  # the TPU kernel's block: (512, 128) uint8 = 64 KiB


class LandStager(GranuleAggregator):
    """Staging sink: slot → async copy → landing kernel (copy+checksum).

    ``depth`` follows StagingConfig like the copy ring
    (``double_buffer``/``depth``; 1 = fully synchronous)."""

    def __init__(
        self,
        worker_id: int,
        granule_bytes: int,
        cfg: Optional[StagingConfig] = None,
        device=None,
        slot_bytes: Optional[int] = None,
        depth: Optional[int] = None,
    ):
        cfg = cfg or StagingConfig()
        self.device = worker_device(device, worker_id)
        self.n_chips = device_count(self.device)
        if cfg.lane != LANE:
            raise ValueError(f"landing ring is lane-{LANE} only, got {cfg.lane}")
        self._granule = granule_bytes
        if depth is None:
            depth = max(1, cfg.depth) if cfg.double_buffer else 1
        self.depth = depth
        if slot_bytes is None:
            slot_bytes = cfg.slot_bytes
        slot_bytes = max(slot_bytes, granule_bytes)
        block_bytes = BLOCK_ROWS * LANE
        self._slot_bytes = -(-slot_bytes // block_bytes) * block_bytes
        self._shape = (self._slot_bytes // LANE, LANE)
        pinned = cfg.native_slots and self.device.type == "cuda"
        self._slots = [new_slot(self._shape, pinned) for _ in range(depth)]
        self._slot_flat = [s.numpy().reshape(-1) for s in self._slots]
        self.stream = worker_stream(self.device, worker_id)
        # Per-slot in-flight landing: (landed, done_event, submit_ns, bytes).
        self._inflight: list[Optional[tuple]] = [None] * depth
        self._k = 0
        self._fill = 0
        self.staged_bytes = 0
        self.transfers = 0
        self.stage_recorder = LatencyRecorder(f"w{worker_id}/pallas_stage")
        self.transfer_wait_ns = 0
        self.put_submit_ns = 0
        self.checksum_reduce_ns = 0
        self._host_sum = 0
        # The kernel adds every slot's sum into this accumulator on the
        # device (created on the stager's stream, which orders its zero
        # fill before the first kernel); finish reads it back once.
        with on_stream(self.stream):
            self._dev_acc = landing.new_acc(self.device)

    def _drain(self, k: int) -> None:
        item = self._inflight[k]
        if item is None:
            return
        _landed, done, submit_ns, n = item
        with hot_region(TRANSFER_WAIT):
            t0 = time.perf_counter_ns()
            done.synchronize()  # copy + landing of slot k complete: reusable
            self.transfer_wait_ns += time.perf_counter_ns() - t0
        self.stage_recorder.record_ns(time.perf_counter_ns() - submit_ns)
        self.staged_bytes += n
        self._inflight[k] = None

    def _free_view(self) -> memoryview:
        k = self._k
        self._drain(k)  # backpressure: previous landing of THIS slot
        return memoryview(self._slot_flat[k])[self._fill :]

    def _launch(self) -> None:
        k = self._k
        flat = self._slot_flat[k]
        n = self._fill
        if n < self._slot_bytes:
            flat[n:] = 0
        # Host-side sum on the fetch thread, before the ring rotates.
        self._host_sum = (
            self._host_sum + int(flat[:n].sum(dtype=np.uint64))
        ) % (1 << 32)
        t0 = time.perf_counter_ns()
        with on_stream(self.stream):
            staged = copy_to_device(self._slots[k], self.device)
            landed, _ = landing.land(staged, self._dev_acc)
            done = record_event(self.stream)
        self.put_submit_ns += time.perf_counter_ns() - t0
        self._inflight[k] = (landed, done, t0, n)
        self.transfers += 1
        self._fill = 0
        self._k = (k + 1) % self.depth
        if self.depth == 1:
            self._drain(k)

    def finish(self) -> dict:
        self.flush()
        for k in range(self.depth):
            self._drain(k)
        self._slots = []
        self._slot_flat = []
        # ONE readback for the whole run, timed on its own.
        t0 = time.perf_counter_ns()
        with on_stream(self.stream):
            dev_sum = landing.acc_value(self._dev_acc)
        self.checksum_reduce_ns = time.perf_counter_ns() - t0
        return {
            "staged_bytes": self.staged_bytes,
            "transfers": self.transfers,
            "slot_bytes": self._slot_bytes,
            "n_chips": self.n_chips,
            "depth": self.depth,
            "stage_recorder": self.stage_recorder,
            "device": str(self.device),
            "transfer_wait_ns": self.transfer_wait_ns,
            "put_submit_ns": self.put_submit_ns,
            "checksum_reduce_ns": self.checksum_reduce_ns,
            "checksum_ok": dev_sum == self._host_sum,
            "checksum_device": dev_sum,
            "checksum_host": self._host_sum,
        }
