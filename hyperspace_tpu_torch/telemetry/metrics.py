"""Process-wide metrics registry: named counters, gauges and histograms
(counterpart of hyperspace_tpu/telemetry/metrics.py).

Where a trace explains one query, the registry aggregates across queries
and actions: transient-IO retries, CAS conflicts of the op log, queries
that degraded to the source, device-cache hits, kernel milliseconds.  The
shape follows the Prometheus client contract (counters only go up, gauges
are set, histograms bucket observations) without the dependency: a
snapshot dict (``Hyperspace.metrics()``) and a text exposition
(``render_prometheus``, ``Hyperspace.metrics_text()``) whose ``# HELP``
lines come from the docs/16-observability.md catalog
(``lint/catalog.py``).

Every mutation takes the registry lock; names come from a fixed catalog
in code, and the registry caps the number of series anyway.  Histograms
keep fixed log-scale buckets plus count, sum, min and max.  There is no
enable switch: an increment is a dict update under a lock, at file,
action and kernel granularity, never per row.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

# Hard cap on distinct metric names: the in-code catalog is ~dozens; hitting
# this means a caller is interpolating unbounded data into names.
_MAX_SERIES = 4096

# Histogram bucket upper bounds (milliseconds-oriented log scale; also fine
# for counts).  Fixed for every histogram: cross-metric comparability beats
# per-metric tuning here, and the bound keeps memory O(1).
_BUCKETS = (1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
            1000.0, 2500.0, 5000.0, 10000.0, float("inf"))


class _Histogram:
    __slots__ = ("count", "sum", "min", "max", "buckets", "exemplars")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets = [0] * len(_BUCKETS)
        # Per-bucket exemplar: (trace_id, value) of the most recent
        # RETAINED observation landing in that bucket — the link from a
        # p99 bucket to a flight-recorder trace id (docs/16).
        self.exemplars: Dict[int, tuple] = {}

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        for i, bound in enumerate(_BUCKETS):
            if value <= bound:
                self.buckets[i] += 1
                if exemplar:
                    self.exemplars[i] = (exemplar, value)
                break

    def snapshot(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": self.min,
            "max": self.max,
            "mean": round(self.sum / self.count, 6) if self.count else None,
            "buckets": {("+Inf" if b == float("inf") else b): n
                        for b, n in zip(_BUCKETS, self.buckets)},
        }


class MetricsRegistry:
    """Thread-safe registry of counters, gauges, and histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._histograms: Dict[str, _Histogram] = {}

    def _room(self) -> bool:
        return (len(self._counters) + len(self._gauges)
                + len(self._histograms)) < _MAX_SERIES

    def inc(self, name: str, value: float = 1.0) -> None:
        """Increment counter ``name`` (created at 0 on first use)."""
        with self._lock:
            if name in self._counters or self._room():
                self._counters[name] = self._counters.get(name, 0.0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            if name in self._gauges or self._room():
                self._gauges[name] = float(value)

    def observe(self, name: str, value: float,
                exemplar: Optional[str] = None) -> None:
        """Record one observation into histogram ``name``.  ``exemplar``
        (a flight-recorder trace id) is remembered per bucket and
        rendered in the text exposition, linking a latency bucket to the
        retained trace that landed there."""
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                if not self._room():
                    return
                h = self._histograms[name] = _Histogram()
            h.observe(float(value), exemplar)

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def typed_snapshot(self) -> Dict[str, Dict[str, object]]:
        """Point-in-time snapshot split by series kind (counters, gauges,
        histograms), for a reader that must tell them apart, such as the
        doctor's per-device kernel-ms map.  Histogram dicts also carry
        ``exemplars`` (bucket index -> ``(trace_id, value)``)."""
        with self._lock:
            out: Dict[str, Dict[str, object]] = {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {},
            }
            for name, h in self._histograms.items():
                snap = h.snapshot()
                snap["exemplars"] = {str(i): list(ex)
                                     for i, ex in h.exemplars.items()}
                out["histograms"][name] = snap
            return out

    def snapshot(self) -> Dict[str, object]:
        """Point-in-time dict of every series, plus the derived ratios the
        catalog promises (``cache.device.hit_ratio``)."""
        with self._lock:
            out: Dict[str, object] = {}
            out.update(sorted(self._counters.items()))
            out.update(sorted(self._gauges.items()))
            for name, h in sorted(self._histograms.items()):
                out[name] = h.snapshot()
            hits = self._counters.get("cache.device.hits", 0.0)
            misses = self._counters.get("cache.device.misses", 0.0)
            if hits + misses > 0:
                out["cache.device.hit_ratio"] = round(
                    hits / (hits + misses), 4)
            return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (names dotted→underscored, histograms
        as ``_bucket``/``_sum``/``_count`` series with ``le`` labels).
        ``# HELP`` lines come from the docs/16 metric catalog — parsed by
        the lint registry (the same single source the telemetry-catalog
        rule enforces), so the exposition and the docs cannot drift.
        Histogram buckets carry OpenMetrics-style exemplars linking them
        to retained flight-recorder trace ids."""
        def prom(name: str) -> str:
            return "hyperspace_" + name.replace(".", "_").replace("-", "_")

        help_for = _catalog_help()
        lines: List[str] = []

        def head(name: str, kind: str) -> None:
            doc = help_for(name)
            if doc:
                lines.append(f"# HELP {prom(name)} {doc}")
            lines.append(f"# TYPE {prom(name)} {kind}")

        with self._lock:
            for name, v in sorted(self._counters.items()):
                head(name, "counter")
                lines.append(f"{prom(name)} {v:g}")
            for name, v in sorted(self._gauges.items()):
                head(name, "gauge")
                lines.append(f"{prom(name)} {v:g}")
            for name, h in sorted(self._histograms.items()):
                head(name, "histogram")
                cumulative = 0
                for i, (bound, n) in enumerate(zip(_BUCKETS, h.buckets)):
                    cumulative += n
                    le = "+Inf" if bound == float("inf") else f"{bound:g}"
                    line = f'{prom(name)}_bucket{{le="{le}"}} {cumulative}'
                    ex = h.exemplars.get(i)
                    if ex is not None:
                        line += (f' # {{trace_id="{ex[0]}"}} '
                                 f'{ex[1]:g}')
                    lines.append(line)
                lines.append(f"{prom(name)}_sum {h.sum:g}")
                lines.append(f"{prom(name)}_count {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# Lazily loaded docs/16 catalog help (name-pattern -> text), shared by
# every render.  The lint parser reads the checked-out docs; an installed
# package without docs/ renders without HELP lines, never fails.
_HELP_ENTRIES = None


def _catalog_help():
    """A ``name -> help-or-None`` lookup over the docs/16 metric catalog
    (placeholder rows like ``rule.<slug>.applied`` match concrete
    names)."""
    global _HELP_ENTRIES
    if _HELP_ENTRIES is None:
        try:
            from hyperspace_tpu_torch.lint.catalog import metric_help_entries

            _HELP_ENTRIES = metric_help_entries()
        except Exception:  # noqa: BLE001 — docs absent: no HELP lines
            _HELP_ENTRIES = []

    def lookup(name: str) -> Optional[str]:
        try:
            from hyperspace_tpu_torch.lint.catalog import name_matches_entry

            for entry, doc in _HELP_ENTRIES:
                if name_matches_entry(name, entry):
                    return doc
        except Exception:  # noqa: BLE001
            pass
        return None

    return lookup


def help_lookup():
    """The docs/16 HELP lookup, for an exposition rendered outside the
    registry (telemetry/fleet.py's, one block per process)."""
    return _catalog_help()


# One registry per process: the subsystems it observes (device cache, IO
# pool, op-log stores) are process-level resources themselves.
_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def inc(name: str, value: float = 1.0) -> None:
    _REGISTRY.inc(name, value)


def set_gauge(name: str, value: float) -> None:
    _REGISTRY.set_gauge(name, value)


def observe(name: str, value: float, exemplar: Optional[str] = None) -> None:
    _REGISTRY.observe(name, value, exemplar)


def snapshot() -> Dict[str, object]:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()
