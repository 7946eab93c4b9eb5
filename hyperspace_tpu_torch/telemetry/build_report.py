"""Per-action build reports (counterpart of
hyperspace_tpu/telemetry/build_report.py): where an index build or
maintenance run spent its time, its bytes and its memory.

Every action run through ``actions/base.Action.run()`` owns one
:class:`BuildReport`:

  - **phases**: seconds per named phase (``read``, ``spill_route``,
    ``kernel``, ``spill_finish``, ``write``, ``sketch``, the protocol's
    ``validate`` and ``commit``, and the pipelined build's stalls
    ``prefetch`` and ``finalize``), summed over the prefetch, route and
    finalize threads, so an overlapped build's phases may sum past its
    wall.  ``kernel`` is the device's (the build's hash and sort, or
    their host mirror below the build threshold); every other phase is
    the host's, which gives ``device_s`` and ``host_s``.
  - **bytes**: decoded source bytes in (``bytes_read``), index data bytes
    out (``bytes_written``, ``files_written``), and the spill build's
    temporary run bytes (``spill_bytes``, ``spill_runs``).
  - **memory**: the peak host RSS and, on a CUDA session, the card's
    allocated bytes, sampled once at the action's end.
  - **the mesh**: ``mesh_devices``, the shards a mesh route spanned (0:
    the single device throughout), and ``device_kernel_ms``, the route's
    milliseconds per mesh position.

Finish exports the report into the metrics registry
(``build.phase.<name>.seconds``, ``build.spill.bytes``,
``build.bytes.written``, ``build.actions``, the ``build.peak_rss_mb``
gauge), synthesizes ``build.phase.<name>`` child spans onto the live
``action.*`` span, appends a perf-ledger record
(telemetry/perf_ledger.py) and publishes the report as
``session.last_build_report_value`` and :func:`last_report`, which
``Hyperspace.last_build_report()`` returns.  With the timeline on
(telemetry/timeline.py) every phase also lands as an interval on its
lane, and the memory sampler's samples give per-phase high-water marks.
``conf.build_profiling_enabled`` (on by default) gates the memory
sampling, the metric export, the phase spans and the ledger append; the
phases and bytes are always kept.  ``conflict_retries`` counts the write
conflicts the action's transaction loop absorbed (actions/base.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

# Phase -> attribution: ``kernel`` is the build's hash and sort (or their
# bit-identical host mirror); everything else is host work and IO.
_DEVICE_PHASES = frozenset({"kernel"})


def _phase_key(name: str) -> str:
    """``<phase>_s`` keys (``build_stats_log``'s) as bare phase names."""
    return name[:-2] if name.endswith("_s") else name


class BuildReport:
    """What one action run did, and where its time went."""

    def __init__(self, action: str = "", index: str = "") -> None:
        self.action = action
        self.index = index
        self.started_at = time.time()
        self.wall_s = 0.0
        self.outcome = "ok"  # "ok" | "noop" | "error"
        self.error = ""
        self.conflict_retries = 0
        self.phases: Dict[str, float] = {}
        self.bytes_read = 0
        self.bytes_written = 0
        self.files_written = 0
        self.spill_bytes = 0
        self.spill_runs = 0
        self.peak_rss_mb: Optional[float] = None
        self.device_live_bytes: Optional[int] = None
        # Action-specific annotations (a refresh's mode and diff counts);
        # flat scalars only.
        self.properties: Dict[str, Any] = {}
        # Kernel milliseconds attributed per mesh position: a route over a
        # mesh of logical shards (parallel/) gives its milliseconds to
        # each position.  The shards may share one card and run one after
        # another, so the position, not the card's index, is the key.
        self.device_kernel_ms: Dict[int, float] = {}
        # Timeline intervals (lane = phase name) and memory samples, kept
        # while the timeline is on (telemetry/timeline.py).
        self.intervals: list = []
        self.memory_samples: list = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    # -- recording (thread-safe: the spill's pools call in) -----------------
    def add_phase(self, name: str, seconds: float) -> None:
        from hyperspace_tpu_torch.telemetry import timeline

        name = _phase_key(name)
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + float(seconds)
        if timeline.timeline_enabled():
            # The caller timed [now - seconds, now].
            end_ns = time.monotonic_ns()
            start_ns = end_ns - int(float(seconds) * 1e9)
            with self._lock:
                if len(self.intervals) < 8192:  # a runaway phase loop
                    self.intervals.append((name, start_ns, end_ns))
            timeline.record_interval(name, "build.phase", start_ns, end_ns)

    def add_device_kernel_ms(self, device_id: int, ms: float) -> None:
        """Attribute ``ms`` of kernel time to one mesh position."""
        with self._lock:
            self.device_kernel_ms[int(device_id)] = \
                self.device_kernel_ms.get(int(device_id), 0.0) + float(ms)

    def add_memory_sample(self, ts_ns: int, rss_mb: float,
                          device_bytes: int) -> None:
        """One memory-sampler observation (the sink contract of
        ``timeline.MemorySampler``)."""
        with self._lock:
            if len(self.memory_samples) < 8192:
                self.memory_samples.append(
                    (int(ts_ns), float(rss_mb), int(device_bytes)))

    def add_bytes(self, *, read: int = 0, written: int = 0, files: int = 0,
                  spill: int = 0, spill_runs: int = 0) -> None:
        with self._lock:
            self.bytes_read += int(read)
            self.bytes_written += int(written)
            self.files_written += int(files)
            self.spill_bytes += int(spill)
            self.spill_runs += int(spill_runs)

    def sample_memory(self, device=None) -> None:
        """The peak host RSS, and on a CUDA ``device`` the bytes allocated
        on it (``torch.cuda.memory_allocated``); once, at the action's
        end."""
        try:
            import resource

            self.peak_rss_mb = round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                / 1024.0, 1)
        except Exception:  # noqa: BLE001 — non-POSIX: report without it
            pass
        if device is None or getattr(device, "type", None) != "cuda":
            return
        import torch

        self.device_live_bytes = int(torch.cuda.memory_allocated(device))

    # -- derived -------------------------------------------------------------
    def phase_total_s(self) -> float:
        return sum(self.phases.values())

    @property
    def mesh_devices(self) -> int:
        """The shards of the mesh this build's routes spanned (0: the
        single-device path throughout)."""
        return int(self.properties.get("mesh_devices", 0) or 0)

    @property
    def device_s(self) -> float:
        return sum(v for k, v in self.phases.items() if k in _DEVICE_PHASES)

    @property
    def host_s(self) -> float:
        return sum(v for k, v in self.phases.items()
                   if k not in _DEVICE_PHASES)

    def lane_report(self) -> Dict[str, Any]:
        """Gap/overlap analysis over this build's intervals (the timeline
        must have been on): per-lane busy shares and the pairwise "X idle
        while Y busy" matrix."""
        from hyperspace_tpu_torch.telemetry import timeline

        with self._lock:
            intervals = list(self.intervals)
        return timeline.busy_report(intervals)

    def phase_memory_mb(self) -> Dict[str, float]:
        """Per-phase high-water host RSS (MB): the largest sampled RSS
        whose timestamp falls inside one of the phase's intervals."""
        with self._lock:
            intervals = list(self.intervals)
            samples = list(self.memory_samples)
        out: Dict[str, float] = {}
        for lane, s, e in intervals:
            for ts, rss_mb, _dev in samples:
                if s <= ts <= e and rss_mb > out.get(lane, 0.0):
                    out[lane] = rss_mb
        return {k: round(v, 1) for k, v in sorted(out.items())}

    # -- lifecycle (driven by actions/base.Action.run) -----------------------
    def finish(self, outcome: str = "ok", error: str = "") -> None:
        self.wall_s = time.perf_counter() - self._t0
        self.outcome = outcome
        self.error = error

    def export_metrics(self) -> None:
        """This report into the process metrics registry (the
        docs/16-observability.md catalog)."""
        from hyperspace_tpu_torch.telemetry import metrics

        metrics.inc("build.actions")
        metrics.observe("build.wall.seconds", self.wall_s * 1000.0)
        for name, s in self.phases.items():
            metrics.inc(f"build.phase.{name}.seconds", s)
        if self.spill_bytes:
            metrics.inc("build.spill.bytes", self.spill_bytes)
        if self.spill_runs:
            metrics.inc("build.spill.runs", self.spill_runs)
        if self.bytes_written:
            metrics.inc("build.bytes.written", self.bytes_written)
        if self.bytes_read:
            metrics.inc("build.bytes.read", self.bytes_read)
        if self.peak_rss_mb is not None:
            metrics.set_gauge("build.peak_rss_mb", self.peak_rss_mb)
        if self.device_live_bytes is not None:
            metrics.set_gauge("build.device.live_bytes",
                              self.device_live_bytes)

    def attach_to_span(self, sp) -> None:
        """Summarize onto the live ``action.*`` span and add one
        ``build.phase.<name>`` child per phase."""
        from hyperspace_tpu_torch.telemetry.trace import Span

        sp.set(build_wall_s=round(self.wall_s, 4),
               build_phase_total_s=round(self.phase_total_s(), 4),
               build_bytes_written=self.bytes_written,
               build_spill_bytes=self.spill_bytes)
        children = getattr(sp, "children", None)
        if children is None:
            return  # tracing off: sp is the shared no-op
        for name, s in sorted(self.phases.items()):
            child = Span(f"build.phase.{name}", {})
            child.start_s = self.started_at
            child.duration_ms = s * 1000.0
            children.append(child)

    # -- serialization -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            "action": self.action,
            "index": self.index,
            "started_at": self.started_at,
            "wall_s": round(self.wall_s, 4),
            "outcome": self.outcome,
            **({"error": self.error} if self.error else {}),
            "conflict_retries": self.conflict_retries,
            "phases_s": {k: round(v, 4)
                         for k, v in sorted(self.phases.items())},
            "device_s": round(self.device_s, 4),
            "host_s": round(self.host_s, 4),
            "bytes_read": self.bytes_read,
            "bytes_written": self.bytes_written,
            "files_written": self.files_written,
            "spill_bytes": self.spill_bytes,
            "spill_runs": self.spill_runs,
            "peak_rss_mb": self.peak_rss_mb,
            "device_live_bytes": self.device_live_bytes,
            **({"properties": dict(sorted(self.properties.items()))}
               if self.properties else {}),
            **({"device_kernel_ms": {
                str(k): round(v, 3)
                for k, v in sorted(self.device_kernel_ms.items())}}
               if self.device_kernel_ms else {}),
            # Present only when the timeline was on for this run.
            **({"lanes": self.lane_report()} if self.intervals else {}),
            **({"phase_peak_rss_mb": self.phase_memory_mb()}
               if self.memory_samples and self.intervals else {}),
        }

    def render(self) -> str:
        lines = [f"Build report: {self.action} index={self.index or '?'} "
                 f"outcome={self.outcome} wall={self.wall_s:.3f}s"]
        if self.conflict_retries:
            lines.append(f"  conflicts absorbed: {self.conflict_retries}")
        for name, s in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            side = "device" if name in _DEVICE_PHASES else "host"
            lines.append(f"  phase {name:<14}{s:>10.3f} s  [{side}]")
        lines.append(f"  bytes: read={self.bytes_read} "
                     f"written={self.bytes_written} "
                     f"spill={self.spill_bytes} "
                     f"(runs={self.spill_runs}, "
                     f"files={self.files_written})")
        if self.peak_rss_mb is not None:
            lines.append(f"  peak host RSS: {self.peak_rss_mb:.1f} MB")
        if self.device_live_bytes is not None:
            lines.append(f"  live device buffers: "
                         f"{self.device_live_bytes} bytes")
        return "\n".join(lines)


# The last finished report, process-wide (the session keeps its own; this
# serves actions made without one).
_last: Optional[BuildReport] = None
_last_lock = threading.Lock()


def publish(report: BuildReport, session=None) -> None:
    global _last
    with _last_lock:
        _last = report
    if session is not None:
        session.last_build_report_value = report


def last_report() -> Optional[BuildReport]:
    with _last_lock:
        return _last


def profiling_enabled(conf) -> bool:
    return bool(getattr(conf, "build_profiling_enabled", True))
