"""Process bring-up (``tpubench/dist/bringup.py``): the port's counterpart
of ``jax.distributed.initialize`` is ``torch.distributed.
init_process_group`` with the coordinator's address (``tcp://host:port``),
the world size and the rank given explicitly — NCCL when the run is on
CUDA, gloo on the CPU. Rank ``r`` runs on ``cuda:(r % device_count)``,
as worker ``i`` of the read path does (:func:`tpubench_torch.device.
worker_device`).

A single-process ``read`` brings nothing up, as in the reference. The pod
commands (``cli.pod_command``) need a group even then: the CLI
(``cli.execute``, the one place that brings groups up) builds a one-rank
group on a loopback port for them, so their collectives run through NCCL
on one card too. On a host of several cards ``cli.main`` runs a pod
command as one rank a card (:mod:`tpubench_torch.dist.launch`), each
joining here from the environment the launcher gives it; the rank binds
its card (``set_device``) before NCCL is brought up.
"""

from __future__ import annotations

import contextlib
import datetime
import socket
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from tpubench_torch.config import DistConfig
from tpubench_torch.device import DeviceLike, resolve_device


def rank_device(device: DeviceLike, rank: int) -> torch.device:
    """The device rank ``rank`` runs on."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def free_port() -> int:
    """An unused TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def topology() -> dict:
    """The topology keys of ``tpubench``'s bring-up for the joined group
    (one device per rank)."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1}
    world = dist.get_world_size()
    return {
        "process_index": dist.get_rank(),
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def initialize(cfg: DistConfig, device: DeviceLike = "cuda",
               one_rank_group: bool = False,
               timeout_s: Optional[float] = None) -> dict:
    """Join the process group ``cfg`` describes and return the topology.

    Idempotent: a process already in a group keeps it (its world size and
    rank must match ``cfg`` when ``cfg`` names several processes). With
    one process nothing is brought up unless ``one_rank_group``, which
    builds a group of one rank on a free loopback port. ``timeout_s``
    bounds the rendezvous and every collective of the group (``torch``'s
    default when None): a rank that loses step then fails instead of
    waiting."""
    dev = resolve_device(device)
    world = cfg.num_processes
    if dist.is_initialized():
        if world > 1 and (dist.get_world_size(), dist.get_rank()) != (
                world, cfg.process_id):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the config asks for rank "
                f"{cfg.process_id} of {world}"
            )
        return topology()
    if world <= 1:
        if not one_rank_group:
            return topology()
        address, rank, world = f"127.0.0.1:{free_port()}", 0, 1
    else:
        if not cfg.coordinator_address:
            raise ValueError(
                f"dist.num_processes={world} needs the coordinator's "
                "host:port (--coordinator / TPUBENCH_COORDINATOR)"
            )
        if not 0 <= cfg.process_id < world:
            raise ValueError(
                f"dist.process_id={cfg.process_id}: must be in [0, {world})"
            )
        address, rank = cfg.coordinator_address, cfg.process_id
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(dev, rank))
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=world, rank=rank,
        **kw,
    )
    if backend == "nccl" and world > 1:
        try:
            _refuse_shared_gpus(torch.cuda.current_device(),
                                torch.cuda.device_count())
        except BaseException:
            dist.destroy_process_group()
            raise
    return topology()


def shared_gpus(device_index: int, group=None) -> list[tuple[str, int, list]]:
    """``(host, device index, ranks)`` for every GPU that more than one
    rank of ``group`` would run on, found over ``group`` (a gloo group:
    this asks NCCL nothing)."""
    seen: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(seen, (socket.gethostname(), device_index),
                           group=group)
    by_gpu: dict = {}
    for rank, key in enumerate(seen):
        by_gpu.setdefault(tuple(key), []).append(rank)
    return [(h, i, ranks) for (h, i), ranks in sorted(by_gpu.items())
            if len(ranks) > 1]


def _refuse_shared_gpus(device_index: int, device_count: int) -> None:
    """NCCL cannot put two ranks on one GPU: raise, naming the host's
    device count, before any NCCL communicator exists (the check runs
    over a gloo side group; NCCL's comes up at the first collective)."""
    side = dist.new_group(backend="gloo")
    try:
        shared = shared_gpus(device_index, side)
    finally:
        dist.destroy_process_group(side)
    if shared:
        host, index, ranks = shared[0]
        raise RuntimeError(
            f"ranks {ranks} would share cuda:{index} on {host}, which has "
            f"{device_count} CUDA device(s): NCCL needs one rank per GPU "
            "(run at most that many processes per host)"
        )


def barrier(group=None) -> None:
    """Wait for every rank of ``group``; under NCCL on this rank's card
    (named, so NCCL guesses nothing from the global rank)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


@contextlib.contextmanager
def session(cfg: DistConfig, device: DeviceLike = "cuda",
            one_rank_group: bool = False) -> Iterator[dict]:
    """:func:`initialize` for the length of a command: the group this call
    brought up is destroyed when the block ends (one joined earlier
    stays)."""
    joined = dist.is_initialized()
    topo = initialize(cfg, device, one_rank_group)
    try:
        yield topo
    finally:
        if not joined and dist.is_initialized():
            dist.destroy_process_group()
