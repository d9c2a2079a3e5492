"""Lockstep peer channel for the cooperative chunk cache
(``tpubench/dist/peer.py``) over ``torch.distributed``.

The loopback channel (:mod:`tpubench_torch.pipeline.coop`) is
request/reply — right for threads in one process, impossible over a
collective transport, where data moves only when every participant
enters the same call. This channel therefore speaks the ``lockstep``
variant of the peer interface: for each cooperatively-fetched chunk,
EVERY host calls :meth:`IciPeerChannel.broadcast` with the same
``(owner, key)`` — the owner contributes the chunk bytes, the others
contribute nothing — and the payload rides the pod's all-gather
(:func:`tpubench_torch.dist.reassemble.make_reassemble`: NCCL on CUDA,
gloo on the CPU; on CUDA it also takes the pod's ``tb_checksum``), after
which every host copies the owner's slot back out. No new transport:
the same all-gather the pod-ingest workloads ride, reused as a byte
mover. The class keeps the reference's name, and the config its
spelling ``coop.channel="ici"``, so saved configs and readers of either
package find their counterpart.

Each host is a rank of the joined process group, and host ``h``'s slot
is rank ``h``'s (``tpubench``'s single-process simulated mesh maps host
``h`` to slot ``h % 8`` instead; here a host outside the group raises).
The owner's slot carries the chunk padded to ``lane``; a follower's slot
carries its trace context in its first 25 bytes (below). Only the
owner's slot and the followers' 25-byte lanes are copied back to the
host, not the whole gathered array.

Scope (documented, enforced by the workload guard): lockstep requires
*plan-synchronized* misses — every host walks the same access plan in
the same order with identical cache configuration, the shape of the
``pipeline.pod`` train-ingest path. Asynchronous consumers (readahead
prefetch workers, independent read pools) must use the request/reply
channel instead; a desynchronized collective would hang the pod.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from tpubench_torch.device import DeviceLike
from tpubench_torch.obs.tracing import TraceContext
from tpubench_torch.pipeline.cache import ChunkKey

# Trace-context lane: a follower's slot in the broadcast is otherwise
# all-zero padding, so its first 25 bytes carry the requester's trace
# context — flag byte (also encoding the per-trace sampled bit: 0xA5
# sampled, 0xA4 unsampled) + 16-byte trace id + 8-byte span id. After the
# all-gather EVERY host holds every slot, so the owner recovers which
# remote spans caused this collective transfer and records them as trace
# LINKS (a collective has no single remote parent — all followers entered
# together).
_CTX_FLAG_SAMPLED = 0xA5
_CTX_FLAG_UNSAMPLED = 0xA4
_CTX_BYTES = 1 + 16 + 8


def _encode_ctx(buf: np.ndarray, ctx: TraceContext) -> None:
    if buf.shape[0] < _CTX_BYTES:
        return  # sub-25-byte slot (degenerate tiny chunk): skip the lane
    flag = _CTX_FLAG_SAMPLED if ctx.sampled else _CTX_FLAG_UNSAMPLED
    raw = bytes([flag]) + bytes.fromhex(
        ctx.trace_id.zfill(32)[:32]
    ) + bytes.fromhex(ctx.span_id.zfill(16)[:16])
    buf[:_CTX_BYTES] = np.frombuffer(raw, dtype=np.uint8)


def _decode_ctx(slot: np.ndarray) -> Optional[TraceContext]:
    if slot.shape[0] < _CTX_BYTES or int(slot[0]) not in (
        _CTX_FLAG_SAMPLED, _CTX_FLAG_UNSAMPLED,
    ):
        return None
    raw = slot[1:_CTX_BYTES].tobytes()
    return TraceContext(
        raw[:16].hex(), raw[16:24].hex(),
        int(slot[0]) == _CTX_FLAG_SAMPLED,
    )


class IciPeerChannel:
    """Lockstep peer channel over the pod's process group (module
    docstring).

    ``pod`` defaults to every rank of the joined group on ``device``
    (:func:`tpubench_torch.dist.reassemble.make_mesh`); with no group
    joined this raises, and so does a CUDA pod whose group is not NCCL.
    ``host_id`` defaults to this process's rank, and must be it: a rank
    carries its own slot. One page-locked (on CUDA) host buffer per padded
    chunk size is kept across calls."""

    lockstep = True

    def __init__(self, pod=None, axis: str = "pod",
                 host_id: Optional[int] = None, lane: int = 128,
                 device: DeviceLike = "cuda"):
        from tpubench_torch.dist.reassemble import make_mesh

        self._pod = pod if pod is not None else make_mesh(
            axis=axis, device=device)
        if (self._pod.device.type == "cuda"
                and dist.get_backend(self._pod.group) != "nccl"):
            raise RuntimeError(
                "coop channel ici: a CUDA pod needs an NCCL process group, "
                f"this one is {dist.get_backend(self._pod.group)}"
            )
        self._lane = lane
        self.host_id = (
            int(host_id) if host_id is not None else self._pod.rank
        )
        if self._slot_for_host(self.host_id) != self._pod.rank:
            raise ValueError(
                f"host {self.host_id} is not this process's rank "
                f"{self._pod.rank}: each rank carries its own slot"
            )
        self._multiprocess = self._pod.size > 1
        self._reassemble = None  # built once, at the first broadcast
        self._bufs: dict = {}  # slot bytes -> (tensor, flat ndarray)
        self.broadcasts = 0
        self.broadcast_bytes = 0
        self._last_links: list[TraceContext] = []

    # ------------------------------------------------------------ helpers --
    def _slot_for_host(self, host: int) -> int:
        """The pod slot carrying ``host``'s payload: rank ``host``'s."""
        if not 0 <= host < self._pod.size:
            raise ValueError(
                f"host {host} is outside the pod's {self._pod.size} rank(s)"
            )
        return host

    def _reassemble_fn(self):
        if self._reassemble is None:
            from tpubench_torch.dist.reassemble import make_reassemble

            self._reassemble = make_reassemble(self._pod)
        return self._reassemble

    def _buffer(self, nbytes: int):
        buf = self._bufs.get(nbytes)
        if buf is None:
            t = torch.zeros(nbytes, dtype=torch.uint8,
                            pin_memory=self._pod.device.type == "cuda")
            buf = self._bufs[nbytes] = (t, t.numpy())
        return buf

    # ------------------------------------------------------------- surface --
    def broadcast(self, owner: int, data, key: ChunkKey,
                  ctx: Optional[TraceContext] = None) -> bytes:
        """Collective chunk transfer: every host enters with the same
        ``(owner, key)``; only the owner passes ``data`` (bytes or any
        buffer of ``key.length`` bytes, read before this returns). Returns
        the owner's bytes on every host (including the owner — callers
        there usually already hold the payload and ignore the echo). A
        follower's ``ctx`` (its peer-hop trace context) rides its own
        otherwise-zero slot; :meth:`last_request_links` returns the
        contexts recovered from the most recent gather — the owner
        records them as trace links."""
        from tpubench_torch.dist.reassemble import shard_to_device_array

        lane = self._lane
        nbytes = key.length
        rows = max(1, math.ceil(nbytes / lane))
        slot = self._slot_for_host(owner)
        tensor, flat = self._buffer(rows * lane)
        if self._pod.rank == slot:
            if data is None:
                raise ValueError(
                    f"host {self.host_id} owns broadcast slot {slot} "
                    "but contributed no data"
                )
            flat[:nbytes] = np.frombuffer(data, dtype=np.uint8, count=nbytes)
            flat[nbytes:] = 0
        else:
            flat[:] = 0
            if ctx is not None:
                _encode_ctx(flat, ctx)
        staged = shard_to_device_array([tensor], self._pod, lane)
        # The host buffer is reused by the next call: its copy to the
        # device must be complete first.
        staged.event.synchronize()
        gathered, _ = self._reassemble_fn()(staged)
        n = self._pod.size
        flat_g = gathered.view(n, rows * lane)
        # Back to the host: the owner's slot and the followers' lanes only.
        payload = flat_g[slot, :nbytes].cpu().numpy().tobytes()
        lanes = flat_g[:, :_CTX_BYTES].cpu().numpy()
        self.broadcasts += 1
        self.broadcast_bytes += nbytes
        links = []
        for i in range(n):
            if i == slot:
                continue
            c = _decode_ctx(lanes[i])
            if c is not None:
                links.append(c)
        self._last_links = links
        return payload

    def last_request_links(self) -> list[TraceContext]:
        """Follower trace contexts recovered from the most recent
        broadcast's gather (empty when no follower was traced)."""
        return list(self._last_links)

    def request(self, owner: int, key: ChunkKey) -> bytes:
        """Request/reply is not expressible over bare collectives —
        the coop layer detects ``lockstep`` and uses broadcast."""
        raise NotImplementedError(
            "IciPeerChannel is lockstep-only: use broadcast() "
            "(the CoopCache routes through it automatically)"
        )

    def close(self) -> None:
        self._reassemble = None
        self._bufs = {}

    def stats(self) -> dict:
        return {
            "broadcasts": self.broadcasts,
            "broadcast_bytes": self.broadcast_bytes,
            "mesh_devices": self._pod.size,
            "multiprocess": self._multiprocess,
        }
