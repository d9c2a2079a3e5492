"""Ingest pipeline (``tpubench/pipeline``): a bounded host-RAM chunk cache
(:mod:`.cache`), a plan-walking readahead prefetcher (:mod:`.prefetch`),
and the step-paced ``train-ingest`` workload
(:mod:`tpubench_torch.workloads.train_ingest`) that measures how well they
hide storage latency behind compute: per-step data-stall time, cache hit
ratio, prefetch efficiency.

Chunk payloads ride the zero-copy slab datapath (:mod:`tpubench_torch.mem`):
leased page-locked slabs filled once off the wire, cached and staged as
they are (``copies_per_byte == 1.0``). The cooperative cache
(:mod:`.coop`) shares the pod's chunks between hosts: consistent-hash
ownership, peer-first misses, pod-wide single-flight.
"""

from tpubench_torch.pipeline.cache import ChunkCache, ChunkKey  # noqa: F401
from tpubench_torch.pipeline.prefetch import (  # noqa: F401
    Prefetcher,
    fetch_chunk,
    read_chunk,
)
