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


class CorruptMetadataError(HyperspaceError):
    """A source table's metadata file (a Delta ``_delta_log`` commit or
    checkpoint, an Iceberg metadata JSON, manifest list or manifest) is
    truncated or corrupt.  The message names the file, so it can be
    repaired or removed."""


class DegradedIndexError(HyperspaceError):
    """An index's operation log is unreadable and the degraded fallback
    (``conf.degraded_fallback_to_source``) is off."""


class DeviceSyncError(HyperspaceError):
    """The strict-mode sync guard (execution/sync_guard.py,
    ``conf.device_guard_enabled``): a device→host read-back ran outside
    the attributed seams (``sync_guard.pull``/``scalar``, the timeline's
    kernel seams).  It propagates like a deadline expiry: a re-plan or a
    fallback would only repeat the unattributed read-back."""


class DeadlineExceededError(HyperspaceError):
    """The deadline (utils/deadline.py) passed: the query stopped at a
    phase boundary.  Never a degraded-mode trigger: it propagates to the
    caller, since a re-plan would spend more time past the deadline."""
