"""Shard assignment math (pure Python; a copy of ``tpubench/dist/shard.py``).

Two tables:

* **worker→object** (the reference's DP axis): worker ``i`` on host ``h``
  owns object ``prefix + (h * workers_per_host + i)`` — the multi-host
  generalization of ``ObjectNamePrefix + workerId`` (``main.go:121``).
* **object→byte-range** (the CP-analog, SURVEY §5.7): one logical object
  split into ``n_shards`` equal lane-aligned ranges, one per chip, so the
  reassembled pod array has a static, XLA-friendly shape. Only the last
  shard can be short; padding is explicit and trimmed after gather.
"""

from __future__ import annotations

from dataclasses import dataclass


def worker_object_index(host: int, worker: int, workers_per_host: int) -> int:
    return host * workers_per_host + worker


@dataclass(frozen=True)
class Shard:
    index: int
    start: int  # byte offset into the object
    length: int  # true bytes to fetch (0 for all-padding shards)
    padded_length: int  # equal for all shards; >= length


@dataclass(frozen=True)
class ShardTable:
    """Equal-size lane-aligned decomposition of one object."""

    object_size: int
    n_shards: int
    align: int  # lane width; every shard length is a multiple of this
    shard_bytes: int  # padded per-shard size

    @classmethod
    def build(cls, object_size: int, n_shards: int, align: int = 128) -> "ShardTable":
        if object_size <= 0 or n_shards <= 0:
            raise ValueError("object_size and n_shards must be positive")
        per = -(-object_size // n_shards)  # ceil
        per = -(-per // align) * align  # round up to lane multiple
        return cls(object_size, n_shards, align, per)

    @property
    def padded_size(self) -> int:
        return self.shard_bytes * self.n_shards

    def shard(self, i: int) -> Shard:
        if not 0 <= i < self.n_shards:
            raise IndexError(i)
        start = i * self.shard_bytes
        length = max(0, min(self.object_size - start, self.shard_bytes))
        return Shard(i, start, length, self.shard_bytes)

    def shards(self) -> list[Shard]:
        return [self.shard(i) for i in range(self.n_shards)]

    def chip_shards(self, host: int, chips_per_host: int) -> list[Shard]:
        """The shards host ``host`` must fetch for its local chips."""
        lo = host * chips_per_host
        return [self.shard(i) for i in range(lo, min(lo + chips_per_host, self.n_shards))]
