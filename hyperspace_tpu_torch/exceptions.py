"""Framework error types (counterpart of hyperspace_tpu/exceptions.py)."""

from __future__ import annotations


class HyperspaceError(Exception):
    """Base error for all hyperspace_tpu_torch failures."""


class ConcurrentWriteError(HyperspaceError):
    """Optimistic-concurrency conflict: a log id was committed by another
    writer between ``base_id`` capture and ``write_log``."""


class NoChangesError(HyperspaceError):
    """Raised by an action's validate() when the operation would be a
    no-op; ``Action.run`` then commits nothing and returns "noop"."""


class DegradedIndexError(HyperspaceError):
    """An index's operation log is unreadable and the degraded fallback
    (``conf.degraded_fallback_to_source``) is off."""
