"""gax-style backoff (a copy of ``Backoff`` in ``tpubench/storage/retry.py``).

Reference policy (``main.go:40-42,179-184``): ``storage.RetryAlways`` with
``gax.Backoff{Max: 30s, Multiplier: 2.0}``. gax semantics: each pause is a
uniformly random duration in [0, cur] (jitter), after which
``cur = min(cur * multiplier, max)``. The fetch executor's retry scheduler
draws its pauses from here; the retrying backend wrapper of the Python
route (``retry_call``) comes with ROADMAP A.2.
"""

from __future__ import annotations

import random
from typing import Optional

from tpubench_torch.config import RetryConfig


class Backoff:
    """Stateful pause generator with gax semantics."""

    def __init__(self, cfg: RetryConfig, rng: Optional[random.Random] = None):
        self.cfg = cfg
        self._cur = cfg.initial_backoff_s
        self._rng = rng or random.Random()

    def pause(self) -> float:
        d = self._rng.uniform(0, self._cur) if self.cfg.jitter else self._cur
        self._cur = min(self._cur * self.cfg.multiplier, self.cfg.max_backoff_s)
        return d
