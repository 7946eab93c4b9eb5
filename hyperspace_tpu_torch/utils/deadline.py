"""Per-query deadlines (counterpart of hyperspace_tpu/utils/deadline.py):
a contextvar that a caller sets and the query path checks at its phase
boundaries.

A caller runs a query inside :func:`scope`; every :func:`check` past the
deadline raises :class:`DeadlineExceededError`, so a query that has
spent its budget stops at the next boundary instead of running on for
an answer nobody waits for.  The checks are coarse: each operator's
entry and exit in ``Executor.execute`` and collect's ``planning`` seam,
never per row.  With no deadline set a check is one contextvar read.

Worker threads started inside the executor (``utils/parallel_map``) do
not inherit the contextvar: their per-file work finishes and the abort
lands at the next boundary on the query's own thread.  A phase is never
torn mid-flight.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Iterator, Optional

from hyperspace_tpu_torch.exceptions import DeadlineExceededError

__all__ = ["DeadlineExceededError", "scope", "remaining", "check",
           "active"]

_deadline: "contextvars.ContextVar[Optional[float]]" = \
    contextvars.ContextVar("hyperspace_torch_deadline", default=None)


@contextlib.contextmanager
def scope(seconds: Optional[float]) -> Iterator[None]:
    """Run the with-block under a deadline ``seconds`` from now.  None or
    a value <= 0 sets none.  Scopes nest, and an inner scope never
    extends an outer deadline: the tighter one applies, and the outer
    one is restored on exit."""
    if seconds is None or seconds <= 0:
        yield
        return
    target = time.monotonic() + seconds
    outer = _deadline.get()
    if outer is not None:
        target = min(target, outer)
    token = _deadline.set(target)
    try:
        yield
    finally:
        _deadline.reset(token)


def active() -> bool:
    return _deadline.get() is not None


def remaining() -> Optional[float]:
    """Seconds until the deadline (negative once past it), or None when
    none is set."""
    dl = _deadline.get()
    if dl is None:
        return None
    return dl - time.monotonic()


def check(phase: str = "") -> None:
    """Raise :class:`DeadlineExceededError` if the deadline has passed."""
    dl = _deadline.get()
    if dl is None:
        return
    over = time.monotonic() - dl
    if over > 0:
        where = f" at {phase}" if phase else ""
        raise DeadlineExceededError(
            f"deadline exceeded{where} ({over * 1000.0:.0f} ms past)")
