"""Carry a reference run's state across to the port.

For this system the state is not parameters but a config and a dataset:
:func:`from_reference` takes ``tpubench``'s ``BenchConfig.to_dict()`` and a
fake-store population of ``(name, size, generation)`` triples, and returns
the port's config and a :class:`FakeBackend` holding identical bytes (the
bytes are a function of name and size, :func:`deterministic_bytes`).
Every section loads into the port's dataclass for it field for field
(``fleet``, the last to get one, included), and ``BenchConfig.to_dict()``
writes back the dict ``tpubench``'s ``BenchConfig.from_dict`` reads, so
one config JSON drives both packages either way.

A stream's state is its snapshot (:func:`stream_state`): the format is
``tpubench``'s, so a snapshot ``tpubench stream`` wrote resumes the port's
stream, and the other way round.

A checkpoint's state is its manifest and its shard-objects: the manifest
format (:func:`tpubench_torch.lifecycle.manifest.read_manifest`), the
object names and their bytes are ``tpubench``'s, and the ``lifecycle``
section loads field for field, so a checkpoint either package saved
restores in the other.
"""

from __future__ import annotations

from typing import Iterable

from tpubench_torch.config import BenchConfig
from tpubench_torch.storage import fault_plan
from tpubench_torch.storage.fake import FakeBackend


def from_reference(cfg_dict: dict, population: Iterable):
    """``(BenchConfig, FakeBackend)`` from a reference config dict and a
    fake-store population; the backend carries the config's fault plan."""
    cfg = BenchConfig.from_dict(cfg_dict)
    backend = FakeBackend.from_population(population, fault=fault_plan(cfg))
    return cfg, backend


def stream_state(snapshot: dict) -> dict:
    """What a stream resumes from, out of a snapshot either package's
    stream wrote: ``objects_done`` (objects delivered, holed or not),
    ``resume_point`` (consecutive complete objects; a snapshot older than
    the key resumes at ``objects_done``) and ``bytes`` (of complete
    objects)."""
    resume = int(snapshot.get("resume_point", snapshot.get("objects_done", 0)))
    return {
        "objects_done": int(snapshot.get("objects_done", resume)),
        "resume_point": resume,
        "bytes": int(snapshot.get("bytes", 0)),
    }

