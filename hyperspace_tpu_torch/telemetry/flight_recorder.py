"""The flight recorder (counterpart of
hyperspace_tpu/telemetry/flight_recorder.py): a bounded, always-on ring
of completed query records with tail-based retention.

Spans live for one call, the run report is overwritten by the next
query, and metrics aggregate away the one query an operator is asked
about.  The recorder keeps the interesting tail: every completed query
is *offered*; slow (``conf.flight_recorder_slow_ms``), error and
deadline-expired ones are always kept, healthy ones sampled 1-in-N
(``conf.flight_recorder_healthy_sample_n``), and the ring is bounded
(``conf.flight_recorder_max_records``) with healthy records evicted
before interesting ones.

One record is a flat dict:

  - ``trace_id`` / ``request_id``: the wire trace context a served
    request carried (``interop.query`` adopts or mints it), else minted
  - ``kind``: ``sql`` / ``spec`` (a served request,
    ``interop/server.py``), ``local`` (``Dataset.collect`` outside a
    request scope), ``maintenance`` (a lifecycle-daemon action) or
    ``unknown`` (a request shed or refused before its kind was read)
  - ``outcome``: ``OK`` or a wire code (``BUSY`` / ``DEADLINE`` /
    ``BADREQ`` / ``FAILED``) for served and maintenance records; a
    local query's run-report outcome (``ok`` / ``degraded`` /
    ``error``)
  - ``latency_ms`` / ``queue_wait_ms`` (served: enqueue to a worker) /
    ``ts`` / ``slow`` / ``reason``
  - ``plan_fingerprint``: the plan-cache key when one was computed
  - ``device_ms``: the attributed kernel milliseconds of the run
  - ``spans``: the ``serve.request`` → ``query.collect`` span tree
    (tracing on), ``report``: the whole QueryRunReport dict

A served request that answered ``OK`` also feeds the
``serve.latency_ms`` histogram, with its trace id as the bucket's
exemplar when its record was retained.

Serialization is paid for retained records only: the offer is a few
conf reads and a counter.

:func:`dump_diagnostics` (``Hyperspace.dump_diagnostics()``, and
``QueryServer.drain`` once in-flight requests finished) writes the ring,
a metrics snapshot and the perf ledger's tail as ONE bundle through the
conf-chosen store (``perf_ledger.store_for``) under
``<systemPath>/_hyperspace_diagnostics``, readable after a restart
through :func:`bundles` and bounded by
``conf.flight_recorder_max_bundles``.  Dumps run inside
``faults.quiet()`` and never raise.  pyarrow is imported inside the
functions.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

FLIGHT_DIR = "_hyperspace_diagnostics"
BUNDLE_VERSION = 1
# How many trailing perf-ledger records ride along in a bundle.
PERF_TAIL = 32

_seq_lock = threading.Lock()
_seq = 0


def _conf_int(conf, attr: str, default: int) -> int:
    try:
        return int(getattr(conf, attr, default))
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    """Lock-safe bounded ring of completed request records."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._records: List[Dict[str, Any]] = []
        self._healthy_seen = 0

    # -- retention ----------------------------------------------------------
    def offer(self, conf, outcome: str, latency_ms: float
              ) -> Optional[str]:
        """Retention decision for one completed request: the reason it
        will be kept (``error`` / ``slow`` / ``sample``), or None for a
        healthy request outside the sample.  Cheap by design — callers
        serialize span trees / reports only on a non-None answer."""
        if not bool(getattr(conf, "flight_recorder_enabled", True)):
            return None
        if outcome not in ("OK", "ok"):
            return "error"  # errors, deadlines, and sheds: always kept
        slow_ms = float(getattr(conf, "flight_recorder_slow_ms", 1000.0))
        if slow_ms > 0 and latency_ms >= slow_ms:
            return "slow"
        sample_n = _conf_int(conf, "flight_recorder_healthy_sample_n", 16)
        if sample_n <= 0:
            return None
        with self._lock:
            self._healthy_seen += 1
            if self._healthy_seen % sample_n == 1 or sample_n == 1:
                return "sample"
        return None

    def record(self, conf, *, kind: str, outcome: str, latency_ms: float,
               trace_id: str, request_id: str,
               queue_wait_ms: Optional[float] = None, error: str = "",
               span=None, report=None) -> bool:
        """Offer one completed request; returns True when it was
        retained.  ``span`` is the finished root
        :class:`~hyperspace_tpu_torch.telemetry.trace.Span` (or None),
        ``report`` the finished QueryRunReport (or None) — serialized
        here, only for retained records.  Never raises."""
        from hyperspace_tpu_torch.telemetry import metrics

        try:
            metrics.inc("flight.recorded")
            reason = self.offer(conf, outcome, latency_ms)
            if reason is None:
                return False
            slow_ms = float(getattr(conf, "flight_recorder_slow_ms",
                                    1000.0))
            rec: Dict[str, Any] = {
                "ts": time.time(),
                "trace_id": trace_id,
                "request_id": request_id,
                "kind": kind,
                "outcome": outcome,
                "error": error,
                "latency_ms": round(float(latency_ms), 3),
                "queue_wait_ms": (None if queue_wait_ms is None
                                  else round(float(queue_wait_ms), 3)),
                "slow": bool(slow_ms > 0 and latency_ms >= slow_ms),
                "reason": reason,
                "plan_fingerprint": _plan_fingerprint(report),
                # Attributed device-kernel ms (timeline seams; 0.0 when
                # the timeline was off or nothing ran on device): the
                # device-bound vs queue-bound discriminator for tails —
                # compare against queue_wait_ms and latency_ms.
                "device_ms": _device_ms(report),
                "spans": span.to_dict() if span is not None else None,
                "report": report.to_dict() if report is not None else None,
            }
            cap = max(1, _conf_int(conf, "flight_recorder_max_records",
                                   256))
            with self._lock:
                self._records.append(rec)
                while len(self._records) > cap:
                    self._evict_one_locked()
                metrics.set_gauge("flight.ring_size", len(self._records))
            metrics.inc("flight.retained")
            return True
        except Exception:  # noqa: BLE001 — a diagnostics failure must
            return False   # never fail the request it describes

    def _evict_one_locked(self) -> None:
        """Drop the oldest HEALTHY-sampled record; only when none is left
        does an interesting (error/slow) record age out."""
        from hyperspace_tpu_torch.telemetry import metrics

        for i, rec in enumerate(self._records):
            if rec.get("reason") == "sample":
                del self._records[i]
                metrics.inc("flight.evicted.healthy")
                return
        del self._records[0]

    # -- reads --------------------------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(r) for r in self._records]

    def find(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The most recent retained record for ``trace_id`` (records of
        one trace share the id; latest wins), or None."""
        with self._lock:
            for rec in reversed(self._records):
                if rec.get("trace_id") == trace_id:
                    return dict(rec)
        return None

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._healthy_seen = 0


# One recorder per process, like the metrics registry.
_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(conf, **kwargs) -> bool:
    return _RECORDER.record(conf, **kwargs)


def reset() -> None:
    _RECORDER.reset()


def _device_ms(report) -> float:
    """Attributed device-kernel milliseconds of the run (the timeline
    seams record ``kernel`` decisions into the report)."""
    if report is None:
        return 0.0
    from hyperspace_tpu_torch.telemetry.timeline import device_ms_summary

    return device_ms_summary(report)


def _plan_fingerprint(report) -> str:
    """The plan-cache key recorded into the run report (dataset.collect),
    if one was computed for this query."""
    if report is None:
        return ""
    try:
        for d in report.decisions:
            if d.get("kind") == "plan_cache" and d.get("fingerprint"):
                return str(d["fingerprint"])
    except Exception:  # noqa: BLE001 — a foreign report shape reads empty
        pass
    return ""


def record_local(conf, rep) -> None:
    """Feed one local ``Dataset.collect`` into the recorder, under a
    minted trace id that ``slow_queries()`` and ``trace()`` address it
    by.  Never raises."""
    try:
        from hyperspace_tpu_torch.interop.query import mint_trace_id

        _RECORDER.record(
            conf, kind="local",
            outcome=getattr(rep, "outcome", "ok"),
            latency_ms=float(getattr(rep, "duration_ms", 0.0)),
            trace_id=mint_trace_id(), request_id=mint_trace_id(),
            span=getattr(rep, "root_span", None), report=rep)
    except Exception:  # noqa: BLE001 — diagnostics never fail a query
        pass


# ---------------------------------------------------------------------------
# Slow-query surfacing
# ---------------------------------------------------------------------------
def slow_queries_table(conf=None):
    """The retained ring as an arrow table, oldest first — the shape
    ``Hyperspace.slow_queries()`` and the interop ``slow_queries`` verb
    return.  Structured payloads (span tree, run report) ride in
    ``recordJson`` so the schema stays flat."""
    import pyarrow as pa

    recs = _RECORDER.records()
    return pa.table({
        "ts": pa.array([float(r.get("ts", 0.0)) for r in recs],
                       type=pa.float64()),
        "traceId": pa.array([str(r.get("trace_id", "")) for r in recs],
                            type=pa.string()),
        "requestId": pa.array([str(r.get("request_id", ""))
                               for r in recs], type=pa.string()),
        "kind": pa.array([str(r.get("kind", "")) for r in recs],
                         type=pa.string()),
        "outcome": pa.array([str(r.get("outcome", "")) for r in recs],
                            type=pa.string()),
        "latencyMs": pa.array([float(r.get("latency_ms", 0.0))
                               for r in recs], type=pa.float64()),
        "queueWaitMs": pa.array([r.get("queue_wait_ms") for r in recs],
                                type=pa.float64()),
        "deviceMs": pa.array([float(r.get("device_ms", 0.0) or 0.0)
                              for r in recs], type=pa.float64()),
        "slow": pa.array([bool(r.get("slow")) for r in recs],
                         type=pa.bool_()),
        "reason": pa.array([str(r.get("reason", "")) for r in recs],
                           type=pa.string()),
        "error": pa.array([str(r.get("error", "")) for r in recs],
                          type=pa.string()),
        "recordJson": pa.array([json.dumps(r, default=str) for r in recs],
                               type=pa.string()),
    })


# ---------------------------------------------------------------------------
# Diagnostics bundles (the conf-chosen store)
# ---------------------------------------------------------------------------
def flight_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), FLIGHT_DIR)


def diagnostics_bundle(conf) -> Dict[str, Any]:
    """The live diagnostics bundle: the retained ring, a metrics
    snapshot, and the perf-ledger tail — what ``dump_diagnostics``
    persists and ``Hyperspace.diagnostics()`` returns."""
    from hyperspace_tpu_torch.telemetry import metrics, perf_ledger

    try:
        perf_tail = perf_ledger.records(conf)[-PERF_TAIL:]
    except Exception:  # noqa: BLE001 — an unreadable ledger reads empty
        perf_tail = []
    return {
        "v": BUNDLE_VERSION,
        "ts": time.time(),
        "pid": os.getpid(),
        "records": _RECORDER.records(),
        "metrics": metrics.snapshot(),
        "perf_tail": perf_tail,
    }


def _next_bundle_key() -> str:
    global _seq
    with _seq_lock:
        _seq += 1
        seq = _seq
    return f"b-{int(time.time() * 1000):013d}-{os.getpid()}-{seq:05d}"


def dump_diagnostics(conf) -> Optional[str]:
    """Persist the current bundle; returns its key, or None when the
    recorder is disabled / the dump failed.  Never raises, and runs
    fault-quiet (a drain's diagnostics dump must not consume an armed
    fault counter or die to an injected crash)."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for
    from hyperspace_tpu_torch.telemetry.trace import span

    if not bool(getattr(conf, "flight_recorder_enabled", True)):
        return None
    try:
        with faults.quiet(), span("flight.dump"):
            store = store_for(conf, flight_root(conf))
            payload = json.dumps(diagnostics_bundle(conf),
                                 default=str).encode("utf-8")
            key = None
            for _ in range(4):
                key = _next_bundle_key()
                if store.put_if_absent(key, payload):
                    break
            else:
                metrics.inc("flight.dump.errors")
                return None
            cap = max(1, _conf_int(conf, "flight_recorder_max_bundles", 8))
            keys = store.list_keys()
            if len(keys) > cap:
                for old in sorted(keys)[:len(keys) - cap]:
                    store.delete(old)
            metrics.inc("flight.dump.bundles")
            return key
    except Exception:  # noqa: BLE001 — diagnostics IO never fails callers
        metrics.inc("flight.dump.errors")
        return None


def bundles(conf) -> List[Dict[str, Any]]:
    """Every parseable persisted bundle, oldest first (``key`` attached).
    Torn/unparseable bundles are skipped — diagnostics are advisory."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    out: List[Dict[str, Any]] = []
    try:
        with faults.quiet():
            store = store_for(conf, flight_root(conf))
            for key in sorted(store.list_keys()):
                try:
                    rec = json.loads(store.read(key).decode("utf-8"))
                except (FileNotFoundError, ValueError,
                        UnicodeDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                rec["key"] = key
                out.append(rec)
    except Exception:  # noqa: BLE001 — unreadable diagnostics read empty
        pass
    return out


def clear_bundles(conf) -> None:
    """Wipe persisted bundles (tests)."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    with faults.quiet():
        store = store_for(conf, flight_root(conf))
        for key in store.list_keys():
            store.delete(key)
