"""Multi-process fan-out and pod-level reassembly (``tpubench/dist`` on
``torch.distributed``).

* :mod:`.bringup` — process-group bring-up (NCCL on CUDA, gloo on the CPU);
* :mod:`.shard` — host×worker→object and object→byte-range shard tables;
* :mod:`.reassemble` — the pod of ranks and its four collectives
  (all-gather, send/recv ring, reduce-scatter, all-reduce) over the shards,
  with the per-rank checksum taken by ``tb_checksum``;
* :mod:`.peer` — the cooperative cache's lockstep peer channel
  (``IciPeerChannel``), which moves a chunk by the pod's all-gather;
* :mod:`.launch` — one rank process a card of this host, started,
  watched and ended together (``cli.main`` runs a pod command so on a
  host of several cards; the sweep's pod sizes go through it too).

Where the reference has one process driving n local chips, the port has n
ranks, one device each, which one command launches.
"""
