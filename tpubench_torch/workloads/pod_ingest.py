"""Pod-scale ingest (``tpubench/workloads/pod_ingest.py``): fetch → stage →
gather, each stage timed separately.

One logical object's byte-range shards are fetched concurrently, one
shard per rank (each rank fetches only its own), staged into each rank's
device memory and all-gathered over the process group so every rank holds
the whole object: the pod, not one host, is the unit under test. Where the
reference runs one process driving n chips, the port runs n ranks, one
device each; on the card's machine (one GPU) the pod is one rank.

Stages, as in the reference:

* fetch — into page-locked host buffers (plain tensors on the CPU): one
  :class:`WorkerGroup` thread per local shard, or, where the client
  multiplexes (native-receive gRPC, whole-client HTTP/2), every range of
  the rank as concurrent streams of one connection
  (:func:`fetch_shards_mux`). A reference process drives several chips,
  so its mux fetch carries several shards; a rank here holds one, which
  the mux route fetches as :data:`MUX_RANGES_PER_RANK` ranges. Failures
  become holes under ``abort_on_error=False``;
* stage — host → device copies on a stream of their own, timed to the
  event recorded after them;
* warm-up — the first call of the collective. The reference reports its
  compile time as ``compile_seconds``; here the key holds the warm-up:
  NCCL's communicator set-up and the first launches;
* gather — ``all_gather_into_tensor`` (or the send/recv ring) plus the
  pod's mod-2³² checksum (``tb_checksum`` per rank, then an all-reduce),
  timed to ``torch.cuda.synchronize()``;
* verify — one rank: the device checksum equals the host's byte sum and
  the gather equals the fetched bytes; several: each rank finds its own
  shard at its offset of the gather.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from tpubench_torch.config import BenchConfig, refuse_unported
from tpubench_torch.device import resolve_device, synchronize
from tpubench_torch.dist.reassemble import (
    Pod,
    gathered_to_bytes,
    make_mesh,
    make_reassemble,
    make_ring_reassemble,
    pod_all,
    pod_sum,
    shard_to_device_array,
)
from tpubench_torch.dist.shard import ShardTable
from tpubench_torch.metrics.report import RunResult
from tpubench_torch.obs.exporters import cloud_exporter_from_config
from tpubench_torch.obs.flight import (
    flight_from_config,
    host_journal_path,
    transport_label,
)
from tpubench_torch.obs.profiling import annotate
from tpubench_torch.obs.telemetry import telemetry_from_config
from tpubench_torch.obs.tracing import trace_scope
from tpubench_torch.staging.device import new_slot
from tpubench_torch.storage import open_backend
from tpubench_torch.storage.base import StorageBackend
from tpubench_torch.workloads.common import (
    WorkerGroup,
    fetch_shard,
    fetch_shards_mux,
    global_hole_totals,
    mux_supported,
    zero_failed_shards,
)

# Ranges a rank's shard is fetched as on the mux route: the chips of a
# reference host on its simulated 8-device mesh, so one rank here sends
# the same 8 ranges of an object as one ``tpubench`` process does.
MUX_RANGES_PER_RANK = 8


@dataclass
class PodIngestWorkload:
    cfg: BenchConfig
    backend: StorageBackend
    pod: Pod
    ring: bool = False  # explicit send/recv ring instead of all_gather
    verify: bool = True
    # The last run's gathered (n, rows, lane) tensor on the rank's device.
    gathered: Optional[torch.Tensor] = None

    def run(self, object_name: Optional[str] = None) -> RunResult:
        # Constructed up front: a live-mode misconfiguration fails before
        # the benchmark runs, not after it.
        cloud_exp = cloud_exporter_from_config(self.cfg)

        w = self.cfg.workload
        lane = self.cfg.staging.lane
        pod = self.pod
        dev = pod.device
        name = object_name or f"{w.object_name_prefix}0"
        n = pod.size
        size = self.backend.stat(name).size
        mux = mux_supported(self.backend)
        if mux:
            # The rank's shard is MUX_RANGES_PER_RANK whole ranges of the
            # finer table; the gather's layout follows the coarse one.
            fine = ShardTable.build(size, n * MUX_RANGES_PER_RANK, align=lane)
            table = ShardTable(size, n, lane,
                               MUX_RANGES_PER_RANK * fine.shard_bytes)
        else:
            table = ShardTable.build(size, n, align=lane)

        # ---- fetch: this rank fetches only its own byte range ---------
        rank = pod.rank
        local_idx = [rank]
        pinned = dev.type == "cuda"
        slots = [new_slot((table.shard_bytes // lane, lane), pinned)
                 for _ in local_idx]
        buffers = [s.numpy().reshape(-1) for s in slots]

        # Flight recorder: one record per shard fetch plus one pod-level
        # record spanning fetch → stage → gather.
        flight = flight_from_config(self.cfg)
        tlabel = transport_label(self.cfg)
        jpath_stream = (
            host_journal_path(self.cfg.obs.flight_journal, rank, n)
            if self.cfg.obs.flight_journal else None
        )
        tel = telemetry_from_config(self.cfg)
        if tel is not None:
            tel.resource["workload"] = "pod_ingest"
            tel.set_chips(n)
            if flight is not None:
                tel.attach_flight(flight)
                if jpath_stream:
                    tel.stream_journal(
                        flight, jpath_stream,
                        extra_fn=lambda: {
                            "workload": "pod_ingest", "n_chips": n,
                            "chips_global": True,
                        },
                        max_bytes=self.cfg.obs.journal_max_bytes,
                    )
            tel.start()

        # install=False: the pod op is a side-channel record; the shard
        # reads parent under it explicitly through trace_scope.
        pod_op = (
            flight.worker("pod").begin(name, tlabel, kind="object",
                                       install=False)
            if flight is not None else None
        )
        pod_ctx = pod_op.trace_context() if pod_op is not None else None

        def fetch(k: int, cancel) -> None:
            with trace_scope(pod_ctx):
                op = (
                    flight.worker(f"shard{local_idx[k]}").begin(name, tlabel)
                    if flight is not None else None
                )
                try:
                    fetch_shard(self.backend, name, table,
                                local_idx[k], buffers[k])
                except BaseException as e:
                    if op is not None:
                        op.finish(error=e)
                    raise
                if op is not None:
                    op.mark("body_complete")
                    op.finish(table.shard(local_idx[k]).length)

        if mux:
            k = MUX_RANGES_PER_RANK
            fetch_idx = [rank * k + j for j in range(k)]
            fetch_bufs = [buffers[0][j * fine.shard_bytes:
                                     (j + 1) * fine.shard_bytes]
                          for j in range(k)]
        t0 = time.perf_counter()
        try:
            with annotate("pod_ingest/fetch"):
                if mux:
                    gres = fetch_shards_mux(self.backend, self.cfg, name,
                                            fine, fetch_idx, fetch_bufs)
                else:
                    gres = WorkerGroup(abort_on_error=w.abort_on_error).run(
                        len(local_idx), fetch, name="fetch"
                    )
        except BaseException as e:
            if pod_op is not None:
                pod_op.finish(error=e)
            raise
        t_fetch = time.perf_counter() - t0
        if pod_op is not None:
            pod_op.mark("body_complete")

        # Failure domains: with abort_on_error=False a failed shard (a
        # failed range on the mux route) is a zeroed hole in the gather,
        # reported below.
        if mux:
            holes = zero_failed_shards(gres, fine, fetch_bufs, fetch_idx)
        else:
            holes = zero_failed_shards(gres, table, buffers, local_idx)

        # ---- stage: host shard buffers → the rank's device -------------
        t0 = time.perf_counter()
        with annotate("pod_ingest/stage"):
            staged = shard_to_device_array(slots, pod, lane)
            staged.event.synchronize()
        t_stage = time.perf_counter() - t0
        if pod_op is not None:
            pod_op.mark("hbm_staged")

        # ---- gather (warm-up first, reported apart) --------------------
        fn = (make_ring_reassemble if self.ring else make_reassemble)(pod)
        t0 = time.perf_counter()
        with annotate("pod_ingest/warmup"):
            fn(staged)
            synchronize(dev)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        with annotate("pod_ingest/gather"):
            gathered, csum = fn(staged)
            synchronize(dev)
        t_gather = time.perf_counter() - t0
        if pod_op is not None:
            pod_op.mark("gather_complete")
        self.gathered = gathered

        # ---- verify --------------------------------------------------------
        ok = True
        if self.verify:
            if n == 1:
                # Single rank: full equality + global checksum.
                host_sum = sum(
                    int(b.sum(dtype=np.uint64)) for b in buffers
                ) % (1 << 32)
                ok = int(csum.item()) % (1 << 32) == host_sum
                got = gathered_to_bytes(gathered, size)
                expected = b"".join(b.tobytes() for b in buffers)
                ok = ok and got == expected[:size]
            else:
                # Several ranks: each finds its own shard at its offset of
                # the (replicated) gather and the pod's device checksum
                # equal to the pod's host sum; verified when every rank
                # did (the reference's single process checks every shard).
                garr = gathered.cpu().numpy().reshape(n, -1)
                ok = all(
                    np.array_equal(garr[i], buffers[k])
                    for k, i in enumerate(local_idx)
                )
                host_sum = pod_sum(
                    sum(int(b.sum(dtype=np.uint64)) for b in buffers), pod)
                ok = pod_all(
                    ok and int(csum.item()) % (1 << 32) == host_sum, pod)

        wall = t_fetch + t_stage + t_gather
        # Throughput counts delivered bytes: holes moved nothing, pod-wide.
        ghole = global_hole_totals(holes, pod)
        delivered = size - ghole["bytes"]
        res = RunResult(
            workload="pod_ingest",
            config=self.cfg.to_dict(),
            bytes_total=delivered,
            wall_seconds=wall,
            gbps=(delivered / 1e9) / wall if wall > 0 else 0.0,
            gbps_per_chip=((delivered / 1e9) / wall / n) if wall > 0 else 0.0,
            n_chips=n,
            errors=ghole["shards"] + (0 if ok else 1),
        )
        res.extra.update(
            {
                "holes": holes,  # this rank's failed shards
                "holes_global": ghole,  # pod-wide totals
                "mode": "ring" if self.ring else "all_gather",
                "fetch_seconds": t_fetch,
                "stage_seconds": t_stage,
                "gather_seconds": t_gather,
                "compile_seconds": t_compile,
                "object_size": size,
                "fetch_gbps": (delivered / 1e9) / t_fetch if t_fetch > 0 else 0.0,
                "stage_gbps": (delivered / 1e9) / t_stage if t_stage > 0 else 0.0,
                "gather_gbps": (delivered / 1e9) / t_gather if t_gather > 0 else 0.0,
                # Each rank receives the other n-1 shards.
                "ici_bytes_moved": table.shard_bytes * n * (n - 1),
                "verified": ok,
                "shard_bytes": table.shard_bytes,
            }
        )
        if pod_op is not None:
            pod_op.finish(delivered)
        if tel is not None:
            res.extra["telemetry"] = tel.close()
        if flight is not None:
            res.extra["flight"] = flight.summary()
            if jpath_stream:
                res.extra["flight_journal"] = flight.write_journal(
                    jpath_stream,
                    extra={"workload": "pod_ingest", "n_chips": n,
                           "chips_global": True},
                    max_bytes=self.cfg.obs.journal_max_bytes,
                )
        # One-burst workload: cloud export is a single final flush.
        if cloud_exp is not None:
            for key in ("fetch_gbps", "stage_gbps", "gather_gbps"):
                cloud_exp.export_point(key, res.extra[key])
            cloud_exp.export_point("bytes_ingested", float(delivered))
            cloud_exp.export_point("ingest_gbps", res.gbps)
            cloud_exp.close()
            res.extra["metrics_export"] = cloud_exp.summary()
        return res


def run_pod_ingest(
    cfg: BenchConfig,
    backend: Optional[StorageBackend] = None,
    ring: bool = False,
    verify: bool = True,
    object_name: Optional[str] = None,
    device="cuda",
    pod: Optional[Pod] = None,
) -> RunResult:
    """Run pod-ingest on ``pod``: by default every rank of the process
    group this process joined, on ``device``. The group is the caller's
    (``cli.execute`` brings it up, one rank for a single process)."""
    resolve_device(device)
    refuse_unported(cfg)
    pod = pod or make_mesh(axis=cfg.dist.mesh_axis, device=device)
    owns = backend is None
    backend = backend or open_backend(cfg)
    try:
        return PodIngestWorkload(cfg, backend, pod, ring=ring,
                                 verify=verify).run(object_name)
    finally:
        if owns:
            backend.close()
