"""Query and action tracing: nested spans over the whole stack
(counterpart of hyperspace_tpu/telemetry/trace.py).

A span is one timed region with outcome tags (``span("exec.scan",
files=3)``); spans nest through a ``contextvar``, so a query's trace is a
tree (optimize under collect, rules under optimize, file reads under the
scan), and the finished ROOT span goes to the registered sinks: a
collecting sink for tests, a JSONL sink for runs (``conf.telemetry_trace_
sink``, bounded by ``conf.telemetry_trace_max_bytes``).

Cost contract: tracing is off by default (``conf.telemetry_tracing_
enabled``), and the disabled path is one module-global bool check that
returns a shared no-op context manager: no allocation, no contextvar
touch, no clock read.  Spans sit at file, action and operator
granularity, never per row.

Worker threads (``utils/parallel_map``, the spill build's pools) do not
inherit the submitting thread's span: their spans are roots of their own,
which keeps the tree race-free without locks.

``profiler_trace(log_dir)`` is the device zoom level: ``torch.profiler``
over the with-block, written for TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

_enabled = False  # module-global: the whole disabled-path cost is this bool


class Span:
    """One timed region: name, outcome tags, nested children."""

    __slots__ = ("name", "tags", "children", "status", "error",
                 "start_s", "duration_ms", "_t0")

    def __init__(self, name: str, tags: Dict[str, Any]) -> None:
        self.name = name
        self.tags = tags
        self.children: List["Span"] = []
        self.status = "ok"
        self.error = ""
        self.start_s = 0.0
        self.duration_ms = 0.0
        self._t0 = 0.0

    def set(self, **tags: Any) -> None:
        """Attach/overwrite outcome tags on the live span."""
        self.tags.update(tags)

    def walk(self) -> Iterator["Span"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> List["Span"]:
        return [s for s in self.walk() if s.name == name]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "duration_ms": round(self.duration_ms, 3),
            "status": self.status,
        }
        if self.error:
            d["error"] = self.error
        if self.tags:
            d["tags"] = dict(self.tags)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class _NoopSpan:
    """Shared do-nothing span/context-manager: the disabled fast path AND
    the parentless ``current_span()`` answer, so instrumentation can tag
    unconditionally."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False

    def set(self, **tags: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "hyperspace_torch_span", default=None)


class _SpanCtx:
    """Context manager for one live span: links into the parent via the
    contextvar, times the region, records exception outcomes, and emits
    the root to the sinks on close."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span) -> None:
        self.span = span
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> Span:
        span = self.span
        parent = _current.get()
        if parent is not None:
            parent.children.append(span)
        self._token = _current.set(span)
        span.start_s = time.time()
        span._t0 = time.perf_counter()
        return span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self.span
        span.duration_ms = (time.perf_counter() - span._t0) * 1000.0
        if exc is not None:
            span.status = "error"
            span.error = f"{type(exc).__name__}: {exc}"
        if self._token is not None:
            parent = self._token.old_value
            if parent is contextvars.Token.MISSING:
                parent = None
            _current.reset(self._token)
            if parent is None:
                _deliver(span)
        return False


def span(name: str, **tags: Any):
    """Open a span named ``name`` (``with span("optimize") as s: ...``).
    Disabled tracing returns the shared no-op — the hot-path contract."""
    if not _enabled:
        return NOOP_SPAN
    return _SpanCtx(Span(name, tags))


def current_span():
    """The innermost live span, or the shared no-op when tracing is off /
    no span is open — callers tag without any enabled check."""
    cur = _current.get()
    return cur if cur is not None else NOOP_SPAN


# The wire trace context of the served request running on this context
# (interop/server.py sets it on the worker around the job): a
# (trace_id, request_id) pair.  It exists with tracing off too, so the
# flight recorder can name records by the client's ids, and
# ``Dataset.collect`` can tell a served query (its worker records it)
# from a local one.
_request_ctx: "contextvars.ContextVar[Optional[Tuple[str, str]]]" = \
    contextvars.ContextVar("hyperspace_torch_request_ctx", default=None)


@contextlib.contextmanager
def request_scope(trace_id: str, request_id: str) -> Iterator[None]:
    """Run the with-block under the given wire trace context."""
    token = _request_ctx.set((trace_id, request_id))
    try:
        yield
    finally:
        _request_ctx.reset(token)


def current_request_context() -> Optional[Tuple[str, str]]:
    """(trace_id, request_id) of the served request this context runs,
    or None outside the serving path."""
    return _request_ctx.get()


def tracing_enabled() -> bool:
    return _enabled


def enable_tracing() -> None:
    global _enabled
    _enabled = True


def disable_tracing() -> None:
    global _enabled
    _enabled = False


# -- sinks ------------------------------------------------------------------
class TraceSink:
    def emit(self, root: Span) -> None:
        raise NotImplementedError


class CollectingTraceSink(TraceSink):
    """Buffers finished root spans for assertions (the
    ``CollectingEventLogger`` analog for traces)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def emit(self, root: Span) -> None:
        with self._lock:
            self.spans.append(root)

    def find(self, name: str) -> List[Span]:
        with self._lock:
            roots = list(self.spans)
        return [s for r in roots for s in r.find(name)]

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()


class JsonlTraceSink(TraceSink):
    """One JSON object per finished root span, appended to ``path``
    (``conf.telemetry_trace_sink``).

    Bounded by size-based rotation (``conf.telemetry_trace_max_bytes``;
    0 = unbounded): once
    the sink file would grow past ``max_bytes`` it is rotated to
    ``<path>.1`` (replacing the previous rotation) and a fresh file
    starts — a long-lived traced server keeps at most ~2x ``max_bytes``
    of trace on disk instead of growing without limit."""

    def __init__(self, path: str, max_bytes: int = 0) -> None:
        self.path = path
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()

    def emit(self, root: Span) -> None:
        line = json.dumps(root.to_dict(), default=str)
        try:
            with self._lock:
                self._rotate_if_needed(len(line) + 1)
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line + "\n")
        except OSError:
            pass  # a full disk must never fail the traced query

    def _rotate_if_needed(self, incoming: int) -> None:
        if self.max_bytes <= 0:
            return
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return  # no file yet
        if size + incoming <= self.max_bytes:
            return
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass  # rotation is best-effort; appends keep working


_sinks: List[TraceSink] = []
_sinks_lock = threading.Lock()


def add_sink(sink: TraceSink) -> TraceSink:
    with _sinks_lock:
        _sinks.append(sink)
    return sink


def remove_sink(sink: TraceSink) -> None:
    with _sinks_lock:
        if sink in _sinks:
            _sinks.remove(sink)


def clear_sinks() -> None:
    with _sinks_lock:
        _sinks.clear()


def _deliver(root: Span) -> None:
    with _sinks_lock:
        sinks = list(_sinks)
    for s in sinks:
        try:
            s.emit(root)
        except Exception:  # noqa: BLE001 — a broken sink must never
            pass           # fail the traced query


def configure_from_conf(conf) -> None:
    """Apply the telemetry conf fields (at session construction and per
    query, so a field set later still takes effect): enables tracing when
    ``telemetry_tracing_enabled`` is set and installs a JSONL sink for
    ``telemetry_trace_sink`` (once per path).  The conf never disables:
    ``disable_tracing()`` is the explicit opt-out."""
    if getattr(conf, "telemetry_tracing_enabled", False):
        enable_tracing()
    path = getattr(conf, "telemetry_trace_sink", "")
    if path:
        max_bytes = int(getattr(conf, "telemetry_trace_max_bytes", 0))
        with _sinks_lock:
            # Check+append under one lock hold: this runs per query, and
            # two concurrent first-queries must not double-install.
            for s in _sinks:
                if isinstance(s, JsonlTraceSink) and s.path == path:
                    s.max_bytes = max_bytes  # conf.set after install wins
                    break
            else:
                _sinks.append(JsonlTraceSink(path, max_bytes=max_bytes))


# -- the device zoom level -------------------------------------------------
@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[None]:
    """Profile the with-block's host and CUDA activity with
    ``torch.profiler`` and write it under ``log_dir`` (TensorBoard's
    profile plugin or Perfetto read it): spans time the engine's
    decisions, the profiler times the kernels.

    >>> with profiler_trace("/tmp/hs-trace"):
    ...     hs.create_index(df, config)
    """
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
