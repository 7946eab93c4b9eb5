"""Bounded retry with exponential backoff and jitter for transient IO
errors (counterpart of hyperspace_tpu/utils/retry.py).

A transient ``EIO`` (a flaky mount) or ``ENOSPC`` (space reclaimed a
moment later) should not abort an index build whose data files are
already written.  Retries are bounded, and each delay is jittered so two
racing writers do not collide again in lockstep.  Only the classic
transient errnos retry; everything else, ``FileExistsError`` (the
optimistic-concurrency signal) included, propagates at once.

Each retry it absorbs records an ``io.retry`` decision in the active
run report (telemetry/report.py) and counts in ``io.retry.attempts``.
"""

from __future__ import annotations

import dataclasses
import errno
import random
import time
from typing import Callable, Optional, TypeVar

from hyperspace_tpu_torch.telemetry import metrics, report

T = TypeVar("T")

TRANSIENT_ERRNOS = frozenset(
    {errno.EIO, errno.ENOSPC, errno.EAGAIN, errno.EINTR})


def is_transient(exc: BaseException) -> bool:
    return (isinstance(exc, OSError)
            and not isinstance(exc, FileExistsError)
            and exc.errno in TRANSIENT_ERRNOS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` tries in all; the delay before retry *i* is
    ``initial_backoff_ms * 2**(i-1)``, capped at ``max_backoff_ms``, times
    a uniform [0.5, 1.0) jitter factor."""

    max_attempts: int = 3
    initial_backoff_ms: float = 10.0
    max_backoff_ms: float = 1000.0

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        base = min(self.initial_backoff_ms * (2.0 ** attempt),
                   self.max_backoff_ms)
        return base * (0.5 + 0.5 * rng.random()) / 1000.0

    def call(self, fn: Callable[[], T],
             rng: Optional[random.Random] = None) -> T:
        """Run ``fn``, retrying transient OSErrors within the budget; the
        jitter draws from ``rng`` (a fresh ``random.Random`` if None)."""
        rng = rng if rng is not None else random.Random()
        attempt = 0
        while True:
            try:
                return fn()
            except OSError as e:
                attempt += 1
                if not is_transient(e) or attempt >= max(1, self.max_attempts):
                    raise
                metrics.inc("io.retry.attempts")
                report.record("io.retry", attempt=attempt,
                              error=f"{type(e).__name__}: {e}")
                time.sleep(self.delay_s(attempt - 1, rng))


def policy_from_conf(conf) -> RetryPolicy:
    """The RetryPolicy of the conf's ``io_retry_*`` fields."""
    return RetryPolicy(
        max_attempts=int(conf.io_retry_max_attempts),
        initial_backoff_ms=float(conf.io_retry_initial_backoff_ms),
        max_backoff_ms=float(conf.io_retry_max_backoff_ms))
