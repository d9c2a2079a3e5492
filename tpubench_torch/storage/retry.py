"""gax-style retry/backoff (a copy of ``tpubench/storage/retry.py``).

Reference policy (``main.go:40-42,179-184``): ``storage.RetryAlways`` with
``gax.Backoff{Max: 30s, Multiplier: 2.0}``. gax semantics: each pause is a
uniformly random duration in [0, cur] (jitter), after which
``cur = min(cur * multiplier, max)``. :func:`retry_call` reproduces that,
adds an optional attempt cap and deadline (absent in the reference — tests
need termination), and classifies retryability via
``StorageError.transient``. The fetch executor's retry scheduler draws its
pauses from :class:`Backoff` too.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from tpubench_torch.config import RetryConfig
from tpubench_torch.obs.flight import annotate as _flight_annotate
from tpubench_torch.storage.base import StorageError

T = TypeVar("T")


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


def _is_retryable(exc: BaseException, policy: str) -> bool:
    if policy == "never":
        return False
    if policy == "always":
        # RetryAlways (main.go:182): any storage-level failure retries.
        return isinstance(exc, (StorageError, ConnectionError, TimeoutError, OSError))
    # "idempotent": only errors the backend marked transient (503s, resets).
    return isinstance(exc, StorageError) and exc.transient


def retry_call(
    fn: Callable[[], T],
    cfg: RetryConfig,
    *,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
    rng: Optional[random.Random] = None,
) -> T:
    """Run ``fn`` under the retry policy. ``sleep``/``clock`` are injectable
    for deterministic tests."""
    backoff = Backoff(cfg, rng=rng)
    start = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as exc:  # noqa: BLE001 — classified below
            attempt += 1
            if not _is_retryable(exc, cfg.policy):
                raise
            if cfg.max_attempts and attempt >= cfg.max_attempts:
                raise
            pause = backoff.pause()
            if cfg.deadline_s and (clock() - start) + pause > cfg.deadline_s:
                raise
            if on_retry is not None:
                on_retry(attempt, exc, pause)
            # Flight-recorder annotation: the retry becomes part of THIS
            # read's record (no-op when no op is active).
            _flight_annotate(
                "retry", attempt=attempt, error=type(exc).__name__
            )
            sleep(pause)
