"""Pod-level reassembly of byte-range shards (``tpubench/dist/
reassemble.py``) over ``torch.distributed``.

Each rank holds one lane-aligned byte-range shard of a logical object on
its device. The reference runs one jitted ``shard_map`` over a 1-D mesh of
chips; here a :class:`Pod` of ranks (a process group, one device each)
runs the NCCL collective that does the same job (gloo on the CPU):

* :func:`make_reassemble` — ``all_gather_into_tensor``; the production
  path;
* :func:`make_ring_reassemble` — the explicit ring: n−1 hops, each one
  ``batch_isend_irecv`` to the next rank and from the previous one;
* :func:`make_reduce_scatter` — uint8 sum (wraps mod 256), left 1/n per
  rank;
* :func:`make_allreduce` — uint8 sum, replicated.

The two gathers also return the pod's mod-2³² byte sum: each rank sums its
shard with ``tb_checksum`` (the port of ``pallas_checksum``; its plain
version on the CPU) and the pod adds the sums with an int64 ``all_reduce``
taken mod 2³² — NCCL and gloo have no uint32 sum, and the modulus makes
the result equal to ``psum`` over the per-chip uint32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpubench_torch.device import DeviceLike, on_stream, record_event
from tpubench_torch.dist.bringup import rank_device
from tpubench_torch.kernels import landing

_MOD = 1 << 32
# torch 2.13 deprecates the *_tensor names for *_single; the card's torch
# (2.11) has only the former. Same arguments, same collective.
all_gather_into_tensor = (getattr(dist, "all_gather_single", None)
                          or dist.all_gather_into_tensor)
reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                         or dist.reduce_scatter_tensor)


@dataclass(frozen=True)
class Pod:
    """A 1-D pod: the process group, this rank's device and the axis name
    (the reference's ``Mesh``). ``ranks`` are the members' global ranks in
    pod order."""

    group: object
    device: torch.device
    ranks: tuple
    axis: str = "pod"

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This process's position in the pod."""
        return self.ranks.index(dist.get_rank())


def make_mesh(ranks: Optional[Sequence[int]] = None, axis: str = "pod",
              device: DeviceLike = "cuda") -> Optional[Pod]:
    """The pod over all ranks of the joined group, or over ``ranks``
    (a new group: every rank of the world must call this, and the ranks
    outside ``ranks`` get ``None``). Bring the group up first
    (:func:`tpubench_torch.dist.bringup.session`; ``cli.execute`` does
    for the pod commands)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group joined: bring one up first "
            "(tpubench_torch.dist.bringup.session; cli.execute does)"
        )
    world = dist.get_world_size()
    if ranks is None or list(ranks) == list(range(world)):
        group, ranks = dist.group.WORLD, tuple(range(world))
    else:
        ranks = tuple(ranks)
        group = dist.new_group(list(ranks))
        if dist.get_rank() not in ranks:
            return None
    return Pod(group, rank_device(device, dist.get_rank()), ranks, axis)


@dataclass
class StagedShards:
    """The local shards on the rank's device, ``(local, rows, lane)``
    uint8, and the event recorded after their copies."""

    array: torch.Tensor
    event: object

    def ready(self) -> torch.Tensor:
        """The array, ordered after its copies on the current stream."""
        if self.array.is_cuda:
            torch.cuda.current_stream(self.array.device).wait_event(self.event)
        return self.array


def shard_to_device_array(host_shards: Sequence[torch.Tensor], pod: Pod,
                          lane: int = 128) -> StagedShards:
    """Copy this rank's shard (a page-locked host tensor on CUDA) to its
    device as a ``(1, rows, lane)`` uint8 tensor, on a stream of its own;
    the copy is complete when the returned event is. Where the reference
    takes a process's shards for its local chips, a rank has one device,
    so one shard."""
    if len(host_shards) != 1:
        raise ValueError(f"pass one shard per rank; got {len(host_shards)}")
    rows = host_shards[0].numel() // lane
    dev = pod.device
    out = torch.empty((len(host_shards), rows, lane), dtype=torch.uint8,
                      device=dev)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(dev))
        out.record_stream(stream)
    with on_stream(stream):
        for k, s in enumerate(host_shards):
            out[k].copy_(s.view(rows, lane), non_blocking=True)
        event = record_event(stream)
    return StagedShards(out, event)


def _pod_checksum(local: torch.Tensor, pod: Pod) -> torch.Tensor:
    """The pod's mod-2³² byte sum as an int64 ``(1,)`` tensor: one
    ``tb_checksum`` per local shard, then an int64 all-reduce."""
    acc = None
    for k in range(local.shape[0]):
        acc = landing.checksum(local[k].reshape(-1), acc)
    total = acc.to(torch.int64) & (_MOD - 1)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=pod.group)
    return total % _MOD


def pod_sum(local_sum: int, pod: Pod) -> int:
    """The pod's mod-2³² host byte sum from each rank's own (an int64
    all-reduce on the rank's device; identity at one rank)."""
    if pod.size == 1:
        return local_sum % _MOD
    t = torch.tensor([local_sum % _MOD], dtype=torch.int64, device=pod.device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=pod.group)
    return int(t.item()) % _MOD


def pod_all(flag: bool, pod: Pod) -> bool:
    """Whether ``flag`` holds on every rank of the pod (a MIN
    all-reduce)."""
    if pod.size == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64, device=pod.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=pod.group)
    return bool(t.item())


def make_reassemble(pod: Pod):
    """``fn(staged) -> (gathered (n, rows, lane), checksum)``: the
    all-gather, identical on every rank."""

    def fn(staged: StagedShards):
        local = staged.ready()
        n, (rows, lane) = pod.size, local.shape[1:]
        gathered = torch.empty((n, rows, lane), dtype=torch.uint8,
                               device=local.device)
        # gloo takes only the concatenated form of the output.
        all_gather_into_tensor(gathered.view(n * rows, lane), local[0],
                               group=pod.group)
        return gathered, _pod_checksum(local, pod)

    return fn


def make_ring_reassemble(pod: Pod):
    """The explicit ring (the reference's ``ppermute`` ring): hop ``s``
    sends the row received at hop ``s-1`` (at hop 0 the rank's own) to the
    next rank and receives row ``(r-s-1) % n`` from the previous one."""

    def fn(staged: StagedShards):
        local = staged.ready()
        n, r = pod.size, pod.rank
        out = torch.empty((n,) + tuple(local.shape[1:]), dtype=torch.uint8,
                          device=local.device)
        out[r].copy_(local[0])
        nxt, prv = pod.ranks[(r + 1) % n], pod.ranks[(r - 1) % n]
        for step in range(n - 1):
            ops = [
                dist.P2POp(dist.isend, out[(r - step) % n], nxt, pod.group),
                dist.P2POp(dist.irecv, out[(r - step - 1) % n], prv, pod.group),
            ]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out, _pod_checksum(local, pod)

    return fn


def make_reduce_scatter(pod: Pod):
    """``fn(staged) -> (1, rows/n, lane)``: the uint8 sum of every rank's
    block, row-split across the pod (``rows`` must divide by n)."""

    def fn(staged: StagedShards):
        local = staged.ready()[0]
        n, rows = pod.size, local.shape[0]
        if rows % n:
            raise ValueError(f"{rows} rows do not split over {n} ranks")
        out = torch.empty((rows // n,) + tuple(local.shape[1:]),
                          dtype=torch.uint8, device=local.device)
        reduce_scatter_tensor(out, local, op=dist.ReduceOp.SUM,
                              group=pod.group)
        return out[None]

    return fn


def make_allreduce(pod: Pod):
    """``fn(staged) -> (1, rows, lane)``: the uint8 sum of every rank's
    block, on every rank."""

    def fn(staged: StagedShards):
        out = staged.ready()[0].clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=pod.group)
        return out[None]

    return fn


def gathered_to_bytes(gathered: torch.Tensor, object_size: int) -> bytes:
    """Trim the padded gather back to the true object bytes (host-side)."""
    flat = np.asarray(gathered.cpu().numpy()).reshape(-1)
    return flat[:object_size].tobytes()
