"""Structured telemetry events, one per lifecycle action and per rule
application (counterpart of hyperspace_tpu/telemetry/events.py).

The event hierarchy follows telemetry/HyperspaceEvent.scala:28-156:
AppInfo, the action events with index name, state and message, the
index-usage event with the rewritten plan, and the port's degraded and
scrub events.  The logger is pluggable (HyperspaceEventLogging.scala:
30-68), no-op by default: ``set_event_logger`` installs one, and
``conf.event_logger`` names one (a registered name or a dotted class
path, loaded through ``utils/reflection.py``).  ``CollectingEventLogger``
is the test double.  Every site emits through ``emit_event``, which also
feeds the run report and the metrics registry (telemetry/report.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class AppInfo:
    """Originating app info (HyperspaceEvent.scala:28-34)."""

    sparkUser: str = ""
    appId: str = ""
    appName: str = "hyperspace_tpu_torch"


@dataclasses.dataclass
class HyperspaceEvent:
    app_info: AppInfo = dataclasses.field(default_factory=AppInfo)
    timestamp_ms: int = dataclasses.field(
        default_factory=lambda: int(time.time() * 1000))
    message: str = ""

    @property
    def kind(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class _IndexActionEvent(HyperspaceEvent):
    index_name: str = ""
    state: str = ""  # "" while running, final state or "FAILURE: ..." at end


class CreateActionEvent(_IndexActionEvent):
    pass


class DeleteActionEvent(_IndexActionEvent):
    pass


class RestoreActionEvent(_IndexActionEvent):
    pass


class VacuumActionEvent(_IndexActionEvent):
    pass


class CancelActionEvent(_IndexActionEvent):
    pass


class RefreshActionEvent(_IndexActionEvent):
    pass


class OptimizeActionEvent(_IndexActionEvent):
    pass


@dataclasses.dataclass
class IndexDegradedEvent(HyperspaceEvent):
    """An index was SKIPPED at query time because its operation log is
    unreadable, torn past recovery, or the backing store is erroring —
    the query fell back to the source scan instead of raising
    (``conf.degraded_fallback_to_source``).  The Hyperspace
    contract: a broken index may stop accelerating a query, never break
    it."""

    index_name: str = ""
    reason: str = ""


@dataclasses.dataclass
class IndexScrubEvent(HyperspaceEvent):
    """One ``verify_index`` pass over an index's data files
    (actions/verify.py): how many files were checked in which mode
    (``quick`` = stat-level, ``full`` = re-read + re-hash) and how many
    were flagged (and quarantined).  ``flagged == 0`` is the healthy
    heartbeat a scrub cron watches for."""

    index_name: str = ""
    mode: str = ""
    files_checked: int = 0
    files_flagged: int = 0


@dataclasses.dataclass
class HyperspaceIndexUsageEvent(HyperspaceEvent):
    """Emitted when a rule rewrites a query to use indexes
    (HyperspaceEvent.scala:150-156)."""

    index_names: List[str] = dataclasses.field(default_factory=list)
    plan_before: str = ""
    plan_after: str = ""


class EventLogger:
    def log_event(self, event: HyperspaceEvent) -> None:
        raise NotImplementedError


class NoOpEventLogger(EventLogger):
    def log_event(self, event: HyperspaceEvent) -> None:
        pass


class CollectingEventLogger(EventLogger):
    """Buffers events for assertions (MockEventLogger analog)."""

    def __init__(self) -> None:
        self.events: List[HyperspaceEvent] = []

    def log_event(self, event: HyperspaceEvent) -> None:
        self.events.append(event)

    def reset(self) -> None:
        self.events.clear()


_logger: EventLogger = NoOpEventLogger()
_logger_explicit = False  # set_event_logger installed a logger
_conf_applied = False     # a conf key already resolved a logger


def get_event_logger() -> EventLogger:
    return _logger


def emit_event(event: HyperspaceEvent) -> None:
    """The canonical emission path: hand ``event`` to the installed logger
    AND to the observability layer (telemetry/report.py), which folds it
    into the active query's run report and the process metrics registry.
    Sites call this instead of ``get_event_logger().log_event`` so the
    event taxonomy feeds metrics from exactly one mapping."""
    _logger.log_event(event)
    from hyperspace_tpu_torch.telemetry import report

    report.observe_event(event)


def set_event_logger(logger: Optional[EventLogger]) -> None:
    """Install a logger programmatically — this wins over the conf key;
    passing ``NoOpEventLogger()`` is an explicit opt-out.  ``None`` resets
    to the default state (conf resolution applies again)."""
    global _logger, _logger_explicit, _conf_applied
    if logger is None:
        _logger = NoOpEventLogger()
        _logger_explicit = False
        _conf_applied = False
    else:
        _logger = logger
        _logger_explicit = True


# Named registry + dotted-path loading (the reflective
# spark.hyperspace.eventLoggerClass conf, HyperspaceEventLogging.scala:42-64).
LOGGER_REGISTRY: Dict[str, type] = {
    "": NoOpEventLogger,
    "NoOpEventLogger": NoOpEventLogger,
    "CollectingEventLogger": CollectingEventLogger,
}


def resolve_event_logger(name: str) -> EventLogger:
    """Instantiate a logger by registered name or ``module:Class`` /
    ``module.Class`` dotted path.  Raises ValueError (with context) for
    anything that does not resolve to an EventLogger subclass."""
    cls = LOGGER_REGISTRY.get(name)
    if cls is None:
        from hyperspace_tpu_torch.utils.reflection import load_class

        try:
            cls = load_class(name, EventLogger, ValueError)
        except ValueError as e:
            raise ValueError(f"Unknown event logger: {name!r} ({e})") from e
    return cls()


def apply_conf_event_logger(name: str) -> None:
    """Install the conf-selected logger unless the application already
    called set_event_logger — the explicit act wins even when it installed
    a NoOp (an opt-out), matching the reference's first-resolution-wins
    singleton (HyperspaceEventLogging.scala:42-64)."""
    global _logger, _conf_applied
    if not name or _logger_explicit or _conf_applied:
        return  # first resolution wins; explicit set always wins
    _logger = resolve_event_logger(name)  # not via set_event_logger: conf
    # application must stay overridable by a later explicit set.
    _conf_applied = True
