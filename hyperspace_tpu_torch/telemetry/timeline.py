"""Intra-phase pipeline timeline: who was busy when, on which lane
(counterpart of hyperspace_tpu/telemetry/timeline.py).

The build report proves where a build's time goes; summed phase seconds
cannot show whether the read lane sits idle while the route runs, how
the device overlaps host IO, or where memory peaks inside a phase.  This
module records *intervals*, ``(lane, kind, start_ns, end_ns)``, for every
build report phase (actions and the spill build's worker threads report
through ``BuildReport.add_phase``), every executor operator dispatch and
every timed device program, into one process-wide bounded ring, plus a
background memory sampler (host RSS and ``torch.cuda.memory_allocated``
of the session's device, at a conf cadence).

On top of the raw intervals:

  - **gap/overlap analysis** (:func:`busy_report`): the share of the wall
    window each lane is busy, and the pairwise "X idle while Y busy"
    matrix.
  - **device/kernel attribution** (:func:`kernel_begin` /
    :func:`kernel_end`): seams in ``ops/`` and ``execution/executor.py``
    bracket each kernel and device program.  On ``cuda`` the pair is two
    ``torch.cuda.Event(enable_timing=True)`` records on the current
    stream; the end synchronizes on its own event only and attributes
    ``elapsed_time`` to the ``exec.kernel.<name>.device_ms`` histogram,
    the ``exec.device.<index>.kernel_ms`` counter, a ``device:<index>``
    lane interval and a ``kernel`` run-report decision.  On the CPU the
    pair reads ``time.monotonic_ns()`` and the device id is -1.  Builds
    and bucketed joins issue work from up to 8 threads onto one stream,
    so an event pair also brackets whatever other threads queued between
    its two records: a seam's ms is an upper bound on its program's own
    device time.  Host-to-device traffic lands in
    ``exec.transfer.h2d.bytes`` (:func:`record_transfer`).
  - **Perfetto/Chrome trace-event export** (:func:`export_chrome_trace`):
    intervals, memory counter tracks and span trees as trace-event JSON
    for ui.perfetto.dev, also rebuilt from a perf-ledger record
    (:func:`ledger_to_trace_events`) or a serialized span tree
    (:func:`spans_to_trace_events`).

Cost contract: off by default (``conf.timeline_enabled``); the disabled
path is one module-global bool check: no allocation, no clock read, and
the kernel seams make no ``torch.cuda`` call (a forced sync is exactly
the cost the switch exists to avoid).  Enabled, the ring is bounded
(``conf.timeline_max_intervals``, the oldest dropped and counted).  Only
the timeline's own bookkeeping is guarded: a CUDA error raised by the
event sync propagates like every other device error.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.telemetry import metrics

_enabled = False  # module-global: the whole disabled-path cost is this bool

_DEFAULT_MAX_INTERVALS = 8192
_DEFAULT_MAX_SAMPLES = 4096


def timeline_enabled() -> bool:
    return _enabled


def enable_timeline() -> None:
    global _enabled
    _enabled = True


def disable_timeline() -> None:
    global _enabled
    _enabled = False


def configure_from_conf(conf) -> None:
    """Apply the timeline conf fields (per action run and per collect):
    enables the recorder when ``timeline_enabled`` is set and applies the
    ring bound.  The conf never disables: ``disable_timeline()`` is the
    explicit opt-out."""
    if getattr(conf, "timeline_enabled", False):
        enable_timeline()
    try:
        _RECORDER.set_capacity(int(getattr(
            conf, "timeline_max_intervals", _DEFAULT_MAX_INTERVALS)))
    except (TypeError, ValueError):
        pass


class TimelineRecorder:
    """Lock-safe bounded ring of intervals + memory samples.

    An interval is ``(lane, kind, start_ns, end_ns)`` (monotonic
    nanoseconds); a memory sample is ``(ts_ns, rss_mb, device_bytes)``.
    Bounded: past capacity the OLDEST entries drop and
    ``timeline.dropped`` counts them — the ring is a diagnosis window,
    not an archive."""

    def __init__(self, capacity: int = _DEFAULT_MAX_INTERVALS) -> None:
        self._lock = threading.Lock()
        self._capacity = capacity
        self._intervals: List[Tuple[str, str, int, int]] = []
        self._samples: List[Tuple[int, float, int]] = []

    def set_capacity(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(1, int(capacity))

    def record(self, lane: str, kind: str, start_ns: int,
               end_ns: int) -> None:
        dropped = 0
        with self._lock:
            self._intervals.append((lane, kind, int(start_ns),
                                    int(end_ns)))
            while len(self._intervals) > self._capacity:
                del self._intervals[0]
                dropped += 1
            size = len(self._intervals)
        metrics.set_gauge("timeline.ring_size", size)
        if dropped:
            metrics.inc("timeline.dropped", dropped)

    def add_memory_sample(self, ts_ns: int, rss_mb: float,
                          device_bytes: int) -> None:
        with self._lock:
            self._samples.append((int(ts_ns), float(rss_mb),
                                  int(device_bytes)))
            while len(self._samples) > _DEFAULT_MAX_SAMPLES:
                del self._samples[0]

    def intervals(self, lane: Optional[str] = None
                  ) -> List[Tuple[str, str, int, int]]:
        with self._lock:
            out = list(self._intervals)
        return out if lane is None else [iv for iv in out if iv[0] == lane]

    def memory_samples(self) -> List[Tuple[int, float, int]]:
        with self._lock:
            return list(self._samples)

    def reset(self) -> None:
        with self._lock:
            self._intervals.clear()
            self._samples.clear()


# One recorder per process, like the metrics registry: the build/executor
# lanes it observes are process-level resources.
_RECORDER = TimelineRecorder()


def recorder() -> TimelineRecorder:
    return _RECORDER


def reset() -> None:
    _RECORDER.reset()


def record_interval(lane: str, kind: str, start_ns: int,
                    end_ns: int) -> None:
    """Record one finished interval into the process ring (no-op when
    the timeline is disabled — one bool check)."""
    if not _enabled:
        return
    _RECORDER.record(lane, kind, start_ns, end_ns)


def op_begin() -> Optional[int]:
    """Start timestamp for an operator/kernel interval, or None when the
    timeline is disabled (callers pass it straight to the matching end
    helper — the disabled path never reads a clock)."""
    return time.monotonic_ns() if _enabled else None


def op_end(lane: str, kind: str, t0_ns: Optional[int]) -> None:
    if t0_ns is None:
        return
    _RECORDER.record(lane, kind, t0_ns, time.monotonic_ns())


# ---------------------------------------------------------------------------
# Device/kernel attribution (the event-timed seams around device programs)
# ---------------------------------------------------------------------------
class _KernelMark:
    """The start of one timed device program: the host clock, and on
    ``cuda`` the start event recorded on the current stream."""

    __slots__ = ("t0_ns", "event", "device")

    def __init__(self, t0_ns: int, event, device) -> None:
        self.t0_ns = t0_ns
        self.event = event
        self.device = device


def kernel_begin(device=None) -> Optional[_KernelMark]:
    """Mark the start of a device program on ``device`` (a
    ``torch.device``), or None when the timeline is disabled: then no
    clock is read and no ``torch.cuda`` call is made.  On ``cuda`` the
    mark holds a timing event recorded on the device's current stream;
    elsewhere it holds the host clock only."""
    if not _enabled:
        return None
    event = None
    if device is not None and getattr(device, "type", None) == "cuda":
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
    return _KernelMark(time.monotonic_ns(), event, device)


def _device_id_of(out: Any, fallback=None) -> int:
    """``tensor.device.index`` of the first tensor in ``out`` (a tensor or
    a tuple, list or dict of them), or of ``fallback`` when ``out`` holds
    none; -1 for the CPU."""
    stack = [out]
    while stack:
        leaf = stack.pop(0)
        if isinstance(leaf, dict):
            stack[:0] = list(leaf.values())
        elif isinstance(leaf, (list, tuple)):
            stack[:0] = list(leaf)
        elif hasattr(leaf, "device") and hasattr(leaf, "dtype"):
            fallback = leaf.device
            break
    if fallback is None or getattr(fallback, "type", None) != "cuda":
        return -1
    index = fallback.index
    if index is None:
        import torch

        index = torch.cuda.current_device()
    return int(index)


def kernel_end(name: str, mark: Optional[_KernelMark],
               out: Any = None, shards: int = 0) -> None:
    """Close one device program begun with :func:`kernel_begin`.  On
    ``cuda``: record the end event on the current stream, synchronize on
    that event only (the counterpart of ``jax.block_until_ready``) and
    take ``elapsed_time``; on the CPU, the host clock.  The milliseconds
    go to the ``exec.kernel.<name>.device_ms`` histogram, the
    ``exec.device.<index>.kernel_ms`` counter, a ``device:<index>`` lane
    interval and a ``kernel`` decision on the active run report.  A no-op
    (no sync, no ``torch.cuda`` call) when the mark is None.

    ``shards`` > 0 names a program that ran over a mesh of that many
    logical shards (parallel/): the milliseconds go to every mesh
    position, ``exec.device.<position>.kernel_ms`` and a
    ``device:<position>`` lane each, as the JAX package gives an SPMD
    program's time to every mesh device.  Logical shards may share one
    card and run one after another, so the position, not the card's
    index, keys the attribution."""
    if mark is None:
        return
    if mark.event is not None:
        import torch

        from hyperspace_tpu_torch.execution import sync_guard

        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(mark.device))
        with sync_guard.allowed():  # the seam's own sync is attributed
            end.synchronize()  # a device error raised here propagates
        ms = float(mark.event.elapsed_time(end))
        end_ns = time.monotonic_ns()
        start_ns = end_ns - int(ms * 1e6)
    else:
        end_ns = time.monotonic_ns()
        start_ns = mark.t0_ns
        ms = (end_ns - start_ns) / 1e6
    try:
        from hyperspace_tpu_torch.telemetry import report as run_report

        metrics.observe(f"exec.kernel.{name}.device_ms", ms)
        ids = list(range(shards)) if shards > 0 \
            else [_device_id_of(out, mark.device)]
        for dev in ids:
            metrics.inc(f"exec.device.{dev}.kernel_ms", ms)
            _RECORDER.record(f"device:{dev}", f"kernel.{name}", start_ns,
                             end_ns)
        run_report.record("kernel", name=name, device_ms=round(ms, 3),
                          device=ids[0],
                          **({"devices": ids} if shards > 0 else {}))
    except Exception:  # noqa: BLE001 - the timeline's own bookkeeping
        metrics.inc("timeline.errors")


def record_transfer(direction: str, nbytes: int) -> None:
    """Count one host↔device transfer (``direction`` is ``h2d`` or
    ``d2h``).  Disabled path: one bool check."""
    if not _enabled or nbytes <= 0:
        return
    metrics.inc(f"exec.transfer.{direction}.bytes", int(nbytes))


def device_ms_summary(report) -> float:
    """Total attributed device-kernel milliseconds of one run report —
    what the flight recorder stamps on a record so ``slow_queries()``
    can tell a device-bound tail from a queue-bound one."""
    try:
        return round(sum(float(d.get("device_ms", 0.0))
                         for d in report.decisions
                         if d.get("kind") == "kernel"), 3)
    except Exception:  # noqa: BLE001 — a foreign report shape reads 0
        return 0.0


# ---------------------------------------------------------------------------
# Background memory sampler
# ---------------------------------------------------------------------------
def _rss_mb() -> float:
    """CURRENT host RSS in MB (``/proc/self/statm`` — getrusage reports
    the historical peak, useless for per-phase high-water marks)."""
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            pages = int(f.read().split()[1])
        import resource

        return pages * resource.getpagesize() / (1024.0 * 1024.0)
    except Exception:  # noqa: BLE001 — non-Linux: no current-RSS source
        return 0.0


def _device_live_bytes(device) -> int:
    """Bytes allocated on a CUDA ``device`` (``torch.cuda.
    memory_allocated``); 0 for the CPU or no device."""
    if device is None or getattr(device, "type", None) != "cuda":
        return 0
    import torch

    return int(torch.cuda.memory_allocated(device))


class MemorySampler:
    """Daemon thread sampling (host RSS, bytes allocated on ``device``)
    every ``cadence_ms`` into a sink (a :class:`BuildReport` exposing
    ``add_memory_sample``) and the process ring.  Bounded lifetime: it
    stops itself after ``max_s`` even if the owner leaked it (an injected
    crash skips the owner's finally)."""

    def __init__(self, cadence_ms: float, sink=None,
                 max_s: float = 3600.0, device=None) -> None:
        self.cadence_s = max(0.001, float(cadence_ms) / 1000.0)
        self.sink = sink
        self.device = device
        self.max_s = max_s
        self.samples = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="hs-memory-sampler", daemon=True)

    def start(self) -> "MemorySampler":
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 2.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout_s)

    def _run(self) -> None:
        deadline = time.monotonic() + self.max_s
        while not self._stop.wait(self.cadence_s):
            if time.monotonic() > deadline:
                return
            ts = time.monotonic_ns()
            rss = _rss_mb()
            try:
                dev = _device_live_bytes(self.device)
            except Exception:  # noqa: BLE001 - a sample is diagnostics;
                dev = 0        # the sampled work reports its own errors
            self.samples += 1
            metrics.inc("timeline.memory.samples")
            _RECORDER.add_memory_sample(ts, rss, dev)
            sink = self.sink
            if sink is not None:
                try:
                    sink.add_memory_sample(ts, rss, dev)
                except Exception:  # noqa: BLE001 — diagnostics never
                    pass           # fail the sampled work


def start_sampler(conf, sink=None, device=None) -> Optional[MemorySampler]:
    """Start a sampler when the timeline is enabled and the cadence conf
    is positive; None otherwise (callers hold the returned handle and
    ``stop()`` it in a finally)."""
    if not _enabled:
        return None
    try:
        cadence = float(getattr(conf, "timeline_memory_sample_ms", 25.0))
    except (TypeError, ValueError):
        cadence = 25.0
    if cadence <= 0:
        return None
    return MemorySampler(cadence, sink, device=device).start()


# ---------------------------------------------------------------------------
# Gap/overlap analysis
# ---------------------------------------------------------------------------
def _merge(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Union of possibly-overlapping (start, end) spans."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _measure(spans: List[Tuple[int, int]], lo: int, hi: int) -> int:
    return sum(min(e, hi) - max(s, lo) for s, e in spans
               if min(e, hi) > max(s, lo))


def _subtract(a: List[Tuple[int, int]], b: List[Tuple[int, int]]
              ) -> List[Tuple[int, int]]:
    """Merged spans of ``a`` minus merged spans of ``b``."""
    out: List[Tuple[int, int]] = []
    j = 0
    for s, e in a:
        cur = s
        while j < len(b) and b[j][1] <= cur:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            bs, be = b[k]
            if bs > cur:
                out.append((cur, bs))
            cur = max(cur, be)
            if cur >= e:
                break
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def busy_report(intervals: Iterable[Sequence],
                lanes: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Gap/overlap analysis over ``intervals`` (items shaped
    ``(lane, kind, start_ns, end_ns)`` or ``(lane, start_ns, end_ns)``).

    Returns::

        {"window_s": wall seconds spanned,
         "lanes": {lane: {"busy_s": ..., "busy_fraction": ...}},
         "idle_while_busy": {x: {y: fraction of the wall window where
                                 lane x is IDLE while lane y is BUSY}}}

    ``idle_while_busy["read"]["spill_route"]`` near 1.0 says the read
    lane waited on the route."""
    by_lane: Dict[str, List[Tuple[int, int]]] = {}
    for item in intervals:
        if len(item) == 4:
            lane, _kind, s, e = item
        else:
            lane, s, e = item
        if lanes is not None and lane not in lanes:
            continue
        by_lane.setdefault(str(lane), []).append((int(s), int(e)))
    merged = {lane: _merge(spans) for lane, spans in by_lane.items()}
    merged = {lane: spans for lane, spans in merged.items() if spans}
    if not merged:
        return {"window_s": 0.0, "lanes": {}, "idle_while_busy": {}}
    lo = min(s[0][0] for s in merged.values())
    hi = max(s[-1][1] for s in merged.values())
    window = max(1, hi - lo)
    lane_stats = {}
    for lane, spans in sorted(merged.items()):
        busy = _measure(spans, lo, hi)
        lane_stats[lane] = {"busy_s": round(busy / 1e9, 4),
                            "busy_fraction": round(busy / window, 4)}
    matrix: Dict[str, Dict[str, float]] = {}
    for x, x_spans in sorted(merged.items()):
        row: Dict[str, float] = {}
        for y, y_spans in sorted(merged.items()):
            if x == y:
                continue
            # y busy while x idle = measure(y \ x) over the wall window.
            row[y] = round(
                _measure(_subtract(y_spans, x_spans), lo, hi) / window, 4)
        matrix[x] = row
    return {"window_s": round(window / 1e9, 4), "lanes": lane_stats,
            "idle_while_busy": matrix}


# ---------------------------------------------------------------------------
# Perfetto / Chrome trace-event export
# ---------------------------------------------------------------------------
def _lane_tids(lanes: Iterable[str]) -> Dict[str, int]:
    return {lane: i + 1 for i, lane in enumerate(sorted(set(lanes)))}


def to_trace_events(intervals: Iterable[Sequence] = (),
                    memory_samples: Iterable[Sequence] = (),
                    span_roots: Iterable = (),
                    pid: int = 1) -> List[Dict[str, Any]]:
    """Render intervals + memory samples + span trees as Chrome
    trace-event dicts (``ph: X`` complete events on one tid per lane,
    ``ph: C`` counter tracks for memory, ``ph: M`` thread-name
    metadata) — the list ``{"traceEvents": [...]}`` wraps."""
    events: List[Dict[str, Any]] = []
    ivs = [tuple(i) for i in intervals]
    tids = _lane_tids(i[0] for i in ivs)
    for lane, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"ph": "M", "pid": pid, "tid": tid,
                       "name": "thread_name", "args": {"name": lane}})
    for lane, kind, s, e in ivs:
        events.append({"name": kind, "cat": "timeline", "ph": "X",
                       "ts": s / 1000.0, "dur": max(0.0, (e - s) / 1000.0),
                       "pid": pid, "tid": tids[lane],
                       "args": {"lane": lane}})
    for ts, rss_mb, dev_bytes in memory_samples:
        events.append({"name": "memory", "cat": "memory", "ph": "C",
                       "ts": ts / 1000.0, "pid": pid,
                       "args": {"host_rss_mb": round(float(rss_mb), 1),
                                "device_live_mb": round(
                                    int(dev_bytes) / (1024.0 * 1024.0),
                                    3)}})
    base_us = 0.0
    if ivs:
        base_us = min(i[2] for i in ivs) / 1000.0
    for root in span_roots:
        events.extend(spans_to_trace_events(root, base_ts_us=base_us,
                                            pid=pid, tid=0))
    return events


def spans_to_trace_events(root, base_ts_us: float = 0.0, pid: int = 1,
                          tid: int = 0) -> List[Dict[str, Any]]:
    """One span tree (a live ``trace.Span`` or its ``to_dict`` form) as
    nested ``ph: X`` events.  Serialized spans keep only durations, so
    children are laid out sequentially inside their parent: the tree's
    shape, not its real concurrency."""
    if root is None:
        return []
    node = root.to_dict() if hasattr(root, "to_dict") else dict(root)
    events: List[Dict[str, Any]] = []

    def emit(span: Dict[str, Any], start_us: float) -> float:
        dur_us = max(0.0, float(span.get("duration_ms", 0.0)) * 1000.0)
        args = dict(span.get("tags") or {})
        if span.get("status") not in (None, "ok"):
            args["status"] = span.get("status")
            if span.get("error"):
                args["error"] = span["error"]
        events.append({"name": str(span.get("name", "span")),
                       "cat": "span", "ph": "X", "ts": start_us,
                       "dur": dur_us, "pid": pid, "tid": tid,
                       "args": args})
        child_us = start_us
        for child in span.get("children", ()) or ():
            if isinstance(child, dict):
                child_us += emit(child, child_us)
        return dur_us

    emit(node, base_ts_us)
    return events


def ledger_to_trace_events(record: Dict[str, Any], pid: int = 1
                           ) -> List[Dict[str, Any]]:
    """Reconstruct a timeline from one perf-ledger record: its
    ``phases_s`` laid out sequentially (summed phase seconds carry no
    interleaving — the reconstruction shows magnitude, the live ring
    shows overlap)."""
    phases = record.get("phases_s") or {}
    events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 1, "name": "thread_name",
         "args": {"name": str(record.get("name", "ledger"))}}]
    cursor = 0.0
    for name, seconds in sorted(phases.items(),
                                key=lambda kv: -float(kv[1])):
        dur_us = max(0.0, float(seconds) * 1e6)
        events.append({"name": f"phase.{name}", "cat": "ledger",
                       "ph": "X", "ts": cursor, "dur": dur_us,
                       "pid": pid, "tid": 1,
                       "args": {"seconds": round(float(seconds), 4)}})
        cursor += dur_us
    return events


def export_chrome_trace(path: str,
                        intervals: Optional[Iterable[Sequence]] = None,
                        memory_samples: Optional[Iterable[Sequence]]
                        = None,
                        span_roots: Iterable = ()) -> int:
    """Write a ``{"traceEvents": [...]}`` JSON file loadable in
    ui.perfetto.dev / chrome://tracing; defaults to the process ring.
    Returns the number of events written."""
    from hyperspace_tpu_torch.telemetry.trace import span

    with span("timeline.export", path=path) as sp:
        if intervals is None:
            intervals = _RECORDER.intervals()
        if memory_samples is None:
            memory_samples = _RECORDER.memory_samples()
        events = to_trace_events(intervals, memory_samples, span_roots)
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, default=str)
        sp.set(events=len(events))
        return len(events)


@contextlib.contextmanager
def lane(lane_name: str, kind: str):
    """Context manager recording the with-block as one interval on
    ``lane_name`` (enabled-checked once at entry)."""
    t0 = op_begin()
    try:
        yield
    finally:
        op_end(lane_name, kind, t0)
