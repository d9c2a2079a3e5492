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
joining here with the place the launcher gives it (``launch.member``);
the rank binds its card (``set_device``) before NCCL is brought up.

Every rank meets the others at one ``TCPStore`` on the coordinator's
address (served by global rank 0: a second host that also claims
``--process-id 0`` cannot bind it and is refused), and before the group
forms the hosts compare notes there: a pod whose hosts see different
card counts, or two hosts with one ``--process-id``, is refused on every
rank, naming what clashed. Once an NCCL group exists, two ranks on one
physical card (keyed by the card's UUID) are refused over a gloo side
group, before NCCL makes a communicator.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
from typing import Iterator, Optional

import torch
import torch.distributed as dist

from tpubench_torch.config import DistConfig
from tpubench_torch.device import DeviceLike, resolve_device
from tpubench_torch.dist.launch import Member, member

# The keys of ``tpubench``'s topology stamp (``extra["topology"]``).
TOPOLOGY_KEYS = ("process_index", "process_count", "local_devices",
                 "global_devices")
# How long a rank waits for the coordinator and for every host to arrive
# (``TCPStore``'s own default) when the caller gives no timeout.
RENDEZVOUS_TIMEOUT_S = 300.0
_HOSTS_KEY = "tpubench/hosts"


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


def topology(m: Member) -> dict:
    """The topology of the joined group, ``m`` this process's place in it,
    as ``tpubench`` reports it: this host's index and the host count
    (``process_index``/``process_count``), the cards of a host and of the
    pod (``local_devices``/``global_devices``, one rank a card); the
    global ``rank`` and ``world_size`` under keys of their own. Outside a
    group, ``tpubench``'s single-process pair."""
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1}
    rank, world, local = dist.get_rank(), dist.get_world_size(), m.local_ranks
    return {
        "process_index": rank // local,
        "process_count": world // local,
        "local_devices": local,
        "global_devices": world,
        "rank": rank,
        "world_size": world,
    }


def topology_stamp(topo: dict) -> dict:
    """``topo`` cut to the keys of ``tpubench``'s ``extra["topology"]``."""
    return {k: topo[k] for k in TOPOLOGY_KEYS}


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
    m = member(cfg)
    if dist.is_initialized():
        if m.world > 1 and (dist.get_world_size(), dist.get_rank()) != (
                m.world, m.rank):
            raise RuntimeError(
                f"this process is rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the config asks for rank "
                f"{m.rank} of {m.world}"
            )
        return topology(m)
    if m.world <= 1:
        if not one_rank_group:
            return topology(m)
        m = Member(0, 1, address=f"127.0.0.1:{free_port()}")
    else:
        if not m.address:
            raise ValueError(
                f"dist.num_processes={cfg.num_processes} needs the "
                "coordinator's host:port (--coordinator / "
                "TPUBENCH_COORDINATOR)"
            )
        if not 0 <= m.host < m.hosts:
            raise ValueError(
                f"dist.process_id={m.host}: must be in [0, {m.hosts})"
            )
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(dev, m.rank))
    wait_s = RENDEZVOUS_TIMEOUT_S if timeout_s is None else timeout_s
    store = rendezvous(m, wait_s)
    if m.world > 1:
        check_hosts(store, m, wait_s)
    kw = {} if timeout_s is None else {
        "timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, store=store, world_size=m.world,
                            rank=m.rank, **kw)
    if m.world > 1 and backend == "nccl":
        try:
            refuse_shared_cards(card_key(dev))
        except BaseException:
            dist.destroy_process_group()
            raise
    return topology(m)


def rendezvous(m: Member, timeout_s: float) -> dist.TCPStore:
    """The pod's store at ``m.address``: served by global rank 0, reached
    by every other rank (each waits up to ``timeout_s`` for it). Rank 0
    never joins a store it did not start: a port already taken (a second
    host claiming ``--process-id 0``, another pod, another service) is
    refused at once, naming the address."""
    host, port = m.address.rsplit(":", 1)
    kw = dict(timeout=datetime.timedelta(seconds=timeout_s),
              wait_for_workers=False)
    if m.rank != 0:
        return dist.TCPStore(host, int(port), is_master=False, **kw)
    try:
        return dist.TCPStore(host, int(port), is_master=True, **kw)
    except (RuntimeError, OSError) as e:
        raise RuntimeError(
            f"rank 0 cannot serve the rendezvous at {m.address} ({e}): the "
            "port is taken; is another host also --process-id 0?"
        ) from e


def check_hosts(store, m: Member, timeout_s: float) -> None:
    """Compare the hosts of the pod at the store, before the group forms:
    each host's local rank 0 posts its index, host count, rank count
    (its visible cards) and name; every rank reads the first
    ``m.hosts`` posts and raises on every rank, naming each host, when two
    claim one index, the rank counts differ or the host counts do."""
    if m.local_rank == 0:
        n = store.add(_HOSTS_KEY, 1)
        store.set(f"{_HOSTS_KEY}/{n}", json.dumps({
            "host": m.host, "hosts": m.hosts, "ranks": m.local_ranks,
            "name": f"{socket.gethostname()}:{os.getpid()}"}))
    keys = [f"{_HOSTS_KEY}/{i}" for i in range(1, m.hosts + 1)]
    try:
        store.wait(keys, datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(
            f"rank {m.rank}: {store.add(_HOSTS_KEY, 0)} of {m.hosts} "
            f"host(s) reached {m.address} within {timeout_s:g} s"
        ) from e
    posts = [json.loads(store.get(k)) for k in keys]
    names = ", ".join(f"host {p['host']} ({p['name']}): {p['ranks']} "
                      f"card(s), --num-processes {p['hosts']}" for p in posts)
    ids = [p["host"] for p in posts]
    dup = sorted({i for i in ids if ids.count(i) > 1})
    if dup:
        raise RuntimeError(
            f"two hosts claim --process-id {dup[0]}: {names}; give each "
            "host its own index in [0, --num-processes)"
        )
    if len({p["ranks"] for p in posts}) > 1:
        raise RuntimeError(
            f"the hosts see different card counts ({names}): every host "
            "runs one rank a visible card, so each must see as many "
            "(CUDA_VISIBLE_DEVICES)"
        )
    if len({p["hosts"] for p in posts}) > 1:
        raise RuntimeError(f"the hosts disagree on --num-processes: {names}")


def card_key(device: DeviceLike) -> str:
    """What tells this rank's card from every other: the CUDA card's UUID
    (two processes that see it under different indices, as
    ``CUDA_VISIBLE_DEVICES`` halves give, still agree on it); on the CPU,
    the process (each rank its own "card")."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = torch.cuda.current_device()
        return (f"{torch.cuda.get_device_name(idx)} "
                f"GPU-{torch.cuda.get_device_properties(idx).uuid}")
    return f"cpu {socket.gethostname()}:{os.getpid()}"


def shared_gpus(card, group=None) -> list[tuple[str, object, list]]:
    """``(hosts, card, ranks)`` for every card (``card`` is this rank's
    :func:`card_key`) that more than one rank of ``group`` would run on,
    with the names of the hosts those ranks run on, found over ``group``
    (a gloo group: this asks NCCL nothing)."""
    seen: list = [None] * dist.get_world_size(group)
    dist.all_gather_object(seen, (card, socket.gethostname()), group=group)
    by_card: dict = {}
    for rank, (key, host) in enumerate(seen):
        by_card.setdefault(key, []).append((rank, host))
    return [(", ".join(sorted({h for _, h in on})), key, [r for r, _ in on])
            for key, on in sorted(by_card.items()) if len(on) > 1]


def refuse_shared_cards(card: str) -> None:
    """NCCL cannot put two ranks on one GPU: raise on every rank, naming
    the card, before any NCCL communicator exists (the check runs over a
    gloo side group; NCCL's comes up at the first collective)."""
    side = dist.new_group(backend="gloo")
    try:
        shared = shared_gpus(card, side)
    finally:
        dist.destroy_process_group(side)
    if shared:
        hosts, key, ranks = shared[0]
        raise RuntimeError(
            f"ranks {ranks} (on {hosts}) would share one card, {key}: "
            "NCCL needs one rank per GPU (give each host its own cards, "
            "CUDA_VISIBLE_DEVICES, and start one command a host)"
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
