"""Page-locked host memory for the zero-copy ingest datapath
(``tpubench/mem``).

A refcounted pool of fixed-size slabs (:class:`~tpubench_torch.mem.slab.
SlabPool`) that the whole pipeline leases end to end: the transport
``readinto``\\ s the wire bytes straight into a leased slab, the cache
stores the lease, and the consumer stages the slab in place, so a chunk
is written once off the wire and never copied again. On CUDA each slab is
page-locked, so its copy to the card is asynchronous.

:class:`~tpubench_torch.mem.slab.CopyMeter` is the proof: it counts every
host-RAM write of chunk payload bytes, and ``copies_per_byte`` is stamped
into ``extra["pipeline"]["copies"]``.
"""

from tpubench_torch.mem.slab import (
    CopyMeter,
    SlabLease,
    SlabPool,
    payload_view,
    release_payload,
)

__all__ = [
    "CopyMeter",
    "SlabLease",
    "SlabPool",
    "payload_view",
    "release_payload",
]
