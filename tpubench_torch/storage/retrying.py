"""Client-level retry decorator for any backend — a copy of
``tpubench/storage/retrying.py``.

The reference attaches retry at the *client* (``client.SetRetry``,
main.go:179-184) and the Go storage library transparently restarts an
interrupted download from the current offset. This wrapper reproduces both
for every backend:

* ``open_read``/``stat``/``list`` are retried under the gax policy;
* a reader hit by a transient mid-stream error is re-opened at
  ``start + bytes_already_delivered`` (ranged read) and continues, so the
  caller sees one uninterrupted stream. Bytes the failed reader handed
  out stay delivered; the resumed reader fills the caller's next buffer
  from the first byte not yet delivered, so no byte is delivered twice.

The failure budget is *consecutive*: the attempt counter and the
backoff/deadline window reset as soon as bytes flow again, so a long
stream with sporadic-but-recovering transient faults never exhausts
``max_attempts`` — only a fault the resume path cannot make progress past
does. ``rng``/``sleep``/``clock`` are injectable so tests run
deterministically without real sleeps.

Writes ride the same policy through ``_ResumingWriter``: a transient
mid-part failure re-probes the committed offset and resends only the tail.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

from tpubench_torch.config import RetryConfig
from tpubench_torch.obs.flight import annotate as _flight_annotate
from tpubench_torch.storage.base import ObjectMeta, StorageBackend, StorageError
from tpubench_torch.storage.retry import Backoff, _is_retryable, retry_call


class _ResumingReader:
    def __init__(
        self,
        backend: StorageBackend,
        name: str,
        start: int,
        length: Optional[int],
        retry: RetryConfig,
        *,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._backend = backend
        self._name = name
        self._start = start
        self._length = length
        self._retry = retry
        self._rng = rng
        self._sleep = sleep
        self._clock = clock
        self._delivered = 0
        self.first_byte_ns: Optional[int] = None
        # Consecutive-failure state: persists across readinto calls while
        # no bytes flow, resets on progress (see module docstring).
        self._attempts = 0
        self._backoff: Optional[Backoff] = None
        self._window_start: Optional[float] = None
        self._inner = retry_call(
            lambda: backend.open_read(name, start, length), retry,
            sleep=sleep, clock=clock, rng=rng,
        )
        self.reopen_count = 0

    def _reopen(self) -> None:
        try:
            self._inner.close()
        except Exception:
            pass
        new_start = self._start + self._delivered
        new_length = None if self._length is None else self._length - self._delivered
        self._inner = retry_call(
            lambda: self._backend.open_read(self._name, new_start, new_length),
            self._retry,
            sleep=self._sleep, clock=self._clock, rng=self._rng,
        )
        self.reopen_count += 1

    def readinto(self, buf: memoryview) -> int:
        while True:
            try:
                n = self._inner.readinto(buf)
            except BaseException as exc:  # noqa: BLE001 — classified below
                self._attempts += 1
                if not _is_retryable(exc, self._retry.policy):
                    raise
                if self._retry.max_attempts and (
                    self._attempts >= self._retry.max_attempts
                ):
                    raise
                # Same bounding as retry_call: gax backoff pause between
                # resume attempts, and deadline_s ends an otherwise
                # endless zero-progress resume loop. Made lazily: the
                # happy path pays nothing; dropped again once bytes flow.
                if self._backoff is None:
                    self._backoff = Backoff(self._retry, rng=self._rng)
                    self._window_start = self._clock()
                pause = self._backoff.pause()
                if self._retry.deadline_s and (
                    self._clock() - self._window_start
                ) + pause > self._retry.deadline_s:
                    raise
                # backoff_s rides the note so the trace export can turn
                # the retry into a span covering its pause.
                _flight_annotate(
                    "retry", attempt=self._attempts, reason="resume",
                    error=type(exc).__name__, backoff_s=round(pause, 6),
                )
                self._sleep(pause)
                self._reopen()
                continue
            if n > 0 and self.first_byte_ns is None:
                self.first_byte_ns = self._inner.first_byte_ns
            if n > 0:
                self._delivered += n
                if self._attempts:
                    # Bytes flow again: the next fault gets the full gax
                    # allowance (fresh counter, backoff and deadline).
                    self._attempts = 0
                    self._backoff = None
                    self._window_start = None
            return n

    def close(self) -> None:
        self._inner.close()


class _ResumingWriter:
    """The write-path twin of :class:`_ResumingReader`: a resumable
    upload whose part sends ride the gax policy. A transient mid-part
    failure re-probes the server's committed offset (the 308-with-Range
    resume query) and resends only the tail; the consecutive-failure
    budget resets whenever committed bytes ADVANCE, so a long upload
    with sporadic-but-recovering faults never exhausts ``max_attempts``
    — only a fault the resume cannot make progress past does.
    ``resumed_parts`` counts parts that needed at least one resume (the
    ckpt-save scorecard's resumed-part count)."""

    def __init__(
        self,
        backend: StorageBackend,
        name: str,
        if_generation_match,
        retry: RetryConfig,
        *,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        # ``retry`` arrives already pinned to transient-only
        # classification by RetryingBackend._write_retry (the one
        # definition of the write-path policy pin).
        self._retry = retry
        self._rng = rng
        self._sleep = sleep
        self._clock = clock
        self._inner = retry_call(
            lambda: backend.open_write(
                name, if_generation_match=if_generation_match
            ),
            retry, sleep=sleep, clock=clock, rng=rng,
        )
        self.name = name
        self.resumed_parts = 0

    @property
    def offset(self) -> int:
        return self._inner.offset

    def write(self, data) -> int:
        mv = memoryview(data)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        base = self._inner.offset
        end = base + len(mv)
        attempts = 0
        backoff: Optional[Backoff] = None
        window_start: Optional[float] = None
        best = base  # highest committed offset observed (progress marker)
        resumed = False
        while True:
            try:
                off = self._inner.offset
                if off < base:
                    # The server's watermark regressed past this part's
                    # start: the missing bytes belong to an EARLIER part
                    # this call no longer holds — unrecoverable here.
                    raise StorageError(
                        f"upload {self.name}: committed {off} regressed "
                        f"past part start {base}", transient=False,
                    )
                if off < end:
                    self._inner.write(mv[off - base:])
                if resumed:
                    self.resumed_parts += 1
                return self._inner.offset
            except BaseException as exc:  # noqa: BLE001 — classified below
                attempts += 1
                if not _is_retryable(exc, self._retry.policy):
                    raise
                if self._retry.max_attempts and (
                    attempts >= self._retry.max_attempts
                ):
                    raise
                if backoff is None:
                    backoff = Backoff(self._retry, rng=self._rng)
                    window_start = self._clock()
                pause = backoff.pause()
                if self._retry.deadline_s and (
                    self._clock() - window_start
                ) + pause > self._retry.deadline_s:
                    raise
                _flight_annotate(
                    "retry", attempt=attempts, reason="upload_resume",
                    error=type(exc).__name__, backoff_s=round(pause, 6),
                )
                self._sleep(pause)
                resumed = True
                try:
                    committed = self._inner.committed()
                except Exception:  # noqa: BLE001 — probe failure: the
                    committed = None  # next loop iteration burns budget
                if committed is not None and committed > best:
                    # Bytes landed since the last look: the fault
                    # recovered, so the NEXT one gets the full allowance.
                    best = committed
                    attempts = 0
                    backoff = None
                    window_start = None

    def committed(self) -> int:
        return retry_call(
            self._inner.committed, self._retry,
            sleep=self._sleep, clock=self._clock, rng=self._rng,
        )

    def finalize(self) -> ObjectMeta:
        # Safe under retry: every backend's finalize is idempotent by
        # contract (a completed session replays its stored meta), and a
        # 412 precondition mismatch is non-transient — never retried.
        return retry_call(
            self._inner.finalize, self._retry,
            sleep=self._sleep, clock=self._clock, rng=self._rng,
        )

    def abort(self) -> None:
        self._inner.abort()


class RetryingBackend:
    """Wraps any backend with the reference's client-level retry.

    ``rng``/``sleep``/``clock`` flow through to every retry loop (open
    retries and mid-stream resumes) for deterministic tests. ``inner`` is
    the wrapped backend (the workload unwraps it to read the base
    client's connection counters)."""

    def __init__(
        self,
        inner: StorageBackend,
        retry: Optional[RetryConfig] = None,
        *,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.inner = inner
        self.retry = retry or RetryConfig()
        self._rng = rng
        self._sleep = sleep
        self._clock = clock

    def _call(self, fn):
        return retry_call(
            fn, self.retry, sleep=self._sleep, clock=self._clock, rng=self._rng
        )

    def _write_retry(self) -> RetryConfig:
        """The ONE write-path policy pin (write + open_write): the
        reference's RetryAlways (main.go:182) is its READ policy — "any
        storage failure retries" is safe when the remedy is re-reading.
        On the write path a non-transient 412 precondition mismatch (or
        a 400 offset bug) reproduces on every replay, so retrying it
        forever would turn the idempotency anchor into a livelock —
        transient-only classification is the only correct behavior."""
        if self.retry.policy != "always":
            return self.retry
        import dataclasses

        return dataclasses.replace(self.retry, policy="idempotent")

    def open_read(self, name: str, start: int = 0, length: Optional[int] = None):
        return _ResumingReader(
            self.inner, name, start, length, self.retry,
            rng=self._rng, sleep=self._sleep, clock=self._clock,
        )

    def write(self, name: str, data: bytes,
              if_generation_match=None) -> ObjectMeta:
        return retry_call(
            lambda: self.inner.write(
                name, data, if_generation_match=if_generation_match
            ),
            self._write_retry(),
            sleep=self._sleep, clock=self._clock, rng=self._rng,
        )

    def open_write(self, name: str, if_generation_match=None):
        return _ResumingWriter(
            self.inner, name, if_generation_match, self._write_retry(),
            rng=self._rng, sleep=self._sleep, clock=self._clock,
        )

    def list(self, prefix: str = "", page_size: int = 0) -> list[ObjectMeta]:
        return self._call(lambda: self.inner.list(prefix, page_size=page_size))

    def stat(self, name: str) -> ObjectMeta:
        return self._call(lambda: self.inner.stat(name))

    def delete(self, name: str) -> None:
        return self._call(lambda: self.inner.delete(name))

    def close(self) -> None:
        self.inner.close()
