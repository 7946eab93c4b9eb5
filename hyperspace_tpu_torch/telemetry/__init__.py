"""Telemetry: spans (``trace``), the metrics registry (``metrics``),
events (``events``), per-query run reports (``report``), the timeline
with kernel attribution (``timeline``), per-action build reports
(``build_report``), the perf ledger (``perf_ledger``), the bench diff
(``bench_compare``), the flight recorder (``flight_recorder``), the SLO
math (``slo``) and the doctor (``doctor``); docs/16-observability.md is
the catalog."""

from hyperspace_tpu_torch.telemetry.events import (
    AppInfo,
    HyperspaceEvent,
    CreateActionEvent,
    DeleteActionEvent,
    RestoreActionEvent,
    VacuumActionEvent,
    CancelActionEvent,
    RefreshActionEvent,
    OptimizeActionEvent,
    HyperspaceIndexUsageEvent,
    IndexDegradedEvent,
    IndexScrubEvent,
    EventLogger,
    NoOpEventLogger,
    CollectingEventLogger,
    emit_event,
    get_event_logger,
    set_event_logger,
)
from hyperspace_tpu_torch.telemetry.build_report import (
    BuildReport,
)
from hyperspace_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
)
from hyperspace_tpu_torch.telemetry.report import (
    QueryRunReport,
)
from hyperspace_tpu_torch.telemetry.trace import (
    CollectingTraceSink,
    JsonlTraceSink,
    Span,
    TraceSink,
    current_span,
    disable_tracing,
    enable_tracing,
    profiler_trace,
    span,
    tracing_enabled,
)
