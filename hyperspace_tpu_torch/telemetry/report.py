"""Per-query run reports: why this query ran the way it did (counterpart
of hyperspace_tpu/telemetry/report.py).

``Dataset.collect()`` opens a :class:`QueryRunReport` for the duration of
the query; the optimizer, the rules, the executor, the kernel seams and
the containment path append structured *decisions* to it through
:func:`record`, a contextvar lookup plus an append, always on.  When
tracing is enabled the query's root span is attached too, so the report
carries per-span timings.  Retrieval: ``ds.last_run_report()``
(thread-local on the session, like ``last_execution_stats``) or the
"Last run report" section of ``explain(verbose=True)``.

:func:`observe_event` is the second feeder: every telemetry event
emitted through ``events.emit_event`` is translated here into the active
report's decisions and the process metrics registry, one mapping from the
event taxonomy to the metric catalog.
"""

from __future__ import annotations

import contextvars
import time
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry.trace import Span


class QueryRunReport:
    """The explain-yourself artifact of one ``collect()``.

    ``decisions`` is an append-only list of dicts, each with a ``kind``:

    ========================  ===============================================
    ``rule``                  one optimizer rule ran: ``rule``, ``applied``,
                              ``skipped_reason`` when it failed and was
                              skipped
    ``indexes.considered``    ACTIVE entries the optimizer pass loaded
    ``index.used``            a rule rewrote the plan to use ``index``
    ``degraded``              an index was skipped or a rule fell back:
                              ``index``, ``reason``
    ``quarantine``            execution-failure containment quarantined
                              files: ``index``, ``files``
    ``replan``                the query re-planned (``mode``:
                              ``containment`` or ``source-fallback``)
    ``io.retry``              a transient IO error was retried:
                              ``attempt``, ``error``
    ``scan``                  one executed scan's IO: ``relation``,
                              ``is_index``, ``files_read``,
                              ``files_listed``, ``bytes_read``
    ``kernel``                one timed device program (the timeline's
                              seams): ``name``, ``device_ms``, ``device``
    ========================  ===============================================
    """

    def __init__(self) -> None:
        self.started_at = time.time()
        self.duration_ms = 0.0
        self.outcome = "ok"  # "ok" | "degraded" | "error"
        self.decisions: List[Dict[str, Any]] = []
        self.indexes_considered: List[str] = []
        self.indexes_used: List[str] = []
        self.root_span: Optional[Span] = None

    @property
    def degraded(self) -> bool:
        return any(d["kind"] == "degraded" for d in self.decisions)

    def degraded_reasons(self) -> List[str]:
        return [d.get("reason", "") for d in self.decisions
                if d["kind"] == "degraded"]

    def skipped_indexes(self) -> List[str]:
        """Indexes that were considered (or degraded, or quarantined) but
        did not end up serving the query."""
        named = {d.get("index", "") for d in self.decisions
                 if d["kind"] in ("degraded", "quarantine") and d.get("index")}
        return sorted((set(self.indexes_considered) | named)
                      - set(self.indexes_used))

    def rules(self) -> List[Dict[str, Any]]:
        return [d for d in self.decisions if d["kind"] == "rule"]

    def scans(self) -> List[Dict[str, Any]]:
        """Per-scan IO records of the execution (kind ``scan``)."""
        return [d for d in self.decisions if d["kind"] == "scan"]

    def bytes_read(self, is_index: Optional[bool] = None) -> int:
        """Total bytes the query's scans read: all scans, or only the
        index or only the source side.  A containment re-plan's scans
        count too: the report describes what the query cost."""
        return sum(d.get("bytes_read", 0) for d in self.scans()
                   if is_index is None or bool(d.get("is_index")) == is_index)

    def span_timings(self) -> List[Dict[str, Any]]:
        """Flattened (name, duration_ms, status) rows of the attached
        trace, in document order; empty when tracing was off."""
        if self.root_span is None:
            return []
        return [{"name": s.name, "duration_ms": round(s.duration_ms, 3),
                 "status": s.status} for s in self.root_span.walk()]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "started_at": self.started_at,
            "duration_ms": round(self.duration_ms, 3),
            "outcome": self.outcome,
            "indexes_considered": list(self.indexes_considered),
            "indexes_used": list(self.indexes_used),
            "indexes_skipped": self.skipped_indexes(),
            "decisions": [dict(d) for d in self.decisions],
            "spans": (self.root_span.to_dict()
                      if self.root_span is not None else None),
        }

    def render(self) -> str:
        """Human-readable report (what explain(verbose=True) embeds)."""
        lines = [f"Query run report: outcome={self.outcome} "
                 f"duration={self.duration_ms:.1f}ms"]
        lines.append(f"  indexes considered: "
                     f"{', '.join(self.indexes_considered) or '(none)'}")
        lines.append(f"  indexes used:       "
                     f"{', '.join(self.indexes_used) or '(none)'}")
        skipped = self.skipped_indexes()
        if skipped:
            lines.append(f"  indexes skipped:    {', '.join(skipped)}")
        for d in self.decisions:
            kind = d["kind"]
            if kind == "rule":
                state = "applied" if d.get("applied") else (
                    f"skipped ({d['skipped_reason']})"
                    if d.get("skipped_reason") else "no match")
                lines.append(f"  rule {d.get('rule')}: {state}")
            elif kind == "degraded":
                lines.append(f"  degraded: index={d.get('index') or '?'} "
                             f"reason={d.get('reason')}")
            elif kind == "quarantine":
                lines.append(f"  quarantine: index={d.get('index')} "
                             f"files={d.get('files')}")
            elif kind == "replan":
                lines.append(f"  re-planned: {d.get('mode')}")
            elif kind == "scan":
                side = "index" if d.get("is_index") else "source"
                lines.append(
                    f"  scan [{side}] {d.get('relation')}: "
                    f"{d.get('files_read')}/{d.get('files_listed')} files, "
                    f"{d.get('bytes_read', 0)} bytes")
        timings = self.span_timings()
        if timings:
            lines.append("  where time went:")
            for row in timings:
                flag = "" if row["status"] == "ok" else f" [{row['status']}]"
                lines.append(f"    {row['name']:<28}"
                             f"{row['duration_ms']:>10.2f} ms{flag}")
        return "\n".join(lines)


_active: "contextvars.ContextVar[Optional[QueryRunReport]]" = \
    contextvars.ContextVar("hyperspace_torch_run_report", default=None)


def start() -> "contextvars.Token":
    """Install a fresh report for the calling context; pair with
    :func:`finish`."""
    return _active.set(QueryRunReport())


def finish(token: "contextvars.Token") -> QueryRunReport:
    report = _active.get()
    _active.reset(token)
    report.duration_ms = (time.time() - report.started_at) * 1000.0
    if report.outcome == "ok" and report.degraded:
        report.outcome = "degraded"
    return report


def active() -> Optional[QueryRunReport]:
    return _active.get()


def record(kind: str, **data: Any) -> None:
    """Append one decision to the active report (a no-op outside a
    query)."""
    report = _active.get()
    if report is None:
        return
    data["kind"] = kind
    report.decisions.append(data)
    if kind == "indexes.considered":
        for n in data.get("names", ()):
            if n not in report.indexes_considered:
                report.indexes_considered.append(n)
    elif kind == "index.used":
        n = data.get("index", "")
        if n and n not in report.indexes_used:
            report.indexes_used.append(n)


def observe_event(event) -> None:
    """Translate one telemetry event (``events.emit_event``) into the
    active report and the metrics registry."""
    from hyperspace_tpu_torch.telemetry.events import (
        HyperspaceIndexUsageEvent,
        IndexDegradedEvent,
        IndexScrubEvent,
        _IndexActionEvent,
    )

    if isinstance(event, IndexDegradedEvent):
        metrics.inc("degraded.fallbacks")
        record("degraded", index=event.index_name, reason=event.reason)
    elif isinstance(event, HyperspaceIndexUsageEvent):
        for name in event.index_names:
            record("index.used", index=name, message=event.message)
    elif isinstance(event, IndexScrubEvent):
        metrics.inc("scrub.files_checked", event.files_checked)
        metrics.inc("scrub.files_flagged", event.files_flagged)
    elif isinstance(event, _IndexActionEvent):
        if event.state.startswith("CONFLICT_RETRY"):
            metrics.inc("action.conflict.retries")
        elif event.state.startswith("FAILURE"):
            metrics.inc("action.failures")
