"""The fleet plane: cross-process heartbeats, merged metrics and the
cluster doctor's checks (counterpart of hyperspace_tpu/telemetry/
fleet.py, with its store keys, snapshot fields and ``SNAPSHOT_VERSION``,
so either package reads the other's heartbeats).

The metrics registry, the flight recorder, the timeline and the doctor
are per process, while the index tree is shared.  This module carries
telemetry across processes through the same log-store seam
(``telemetry/perf_ledger.store_for``), on ``PosixLogStore`` and on
``EmulatedObjectStore``:

  - **Heartbeat publisher** (:class:`FleetPublisher`): a daemon thread,
    on only when ``conf.fleet_telemetry_enabled`` is set, that writes
    ONE bounded snapshot per process every ``fleet_publish_interval_s``
    under ``<systemPath>/_hyperspace_fleet``: the process identity and
    role (``server``/``daemon``/``client``), the typed metrics snapshot,
    the ``health.status`` grade, the per-device kernel-ms map, the
    serving address and draining flag, and the tail of the flight
    recorder's interesting (error/slow) records.  The first publish is a
    put-if-absent, refreshes ride a generation-CAS loop, and heartbeats
    older than ``fleet_prune_after_s`` are deleted.  Publishing runs
    under ``faults.quiet()`` and never raises.
  - **Federation readers**: :func:`fleet_status_table` (one row per
    heartbeat, graded fresh or stale), :func:`fleet_metrics` (counters
    summed, gauges kept per process, fixed-bucket histograms summed
    bucket by bucket with their exemplars), :func:`render_fleet_prometheus`
    (every series with a ``process="<id>"`` label), and
    :func:`find_trace` / :func:`fleet_slow_queries_table` over the local
    ring, every heartbeat and the persisted diagnostics bundles.
  - **Cluster doctor checks** (:func:`fleet_checks`): a stale heartbeat
    is crit, the lease holder or a build-claim holder without a fresh
    heartbeat is crit, more than one daemon without a lease warns, the
    merged shed ratio and SLO burn grade the serving fleet, and the
    per-process and per-device kernel ms grade skew.

Nothing here touches the card.  The snapshot holds Python numbers only:
the kernel milliseconds reach the registry as floats from CUDA events
(``telemetry/timeline.kernel_end``), so the publisher thread never
synchronizes a device and never trips the armed sync guard.

The per-device kernel-ms map keys each device by its CUDA index (a mesh
program by its shard position).  Two processes on one card both report
device ``"0"``, so ``fleet.skew``'s per-device ratio adds them together
on a one-card host; there only the per-process ratio shows a straggler.

Not here yet: the SLO alert engine (the JAX package's
telemetry/alerts.py).  The snapshot's ``alerts`` is ``[]``, what the
JAX engine carries when it is off (its default), and ``fleet.alerts``
grades the FIRING alerts that other processes' fresh heartbeats carry.

A heartbeat is stale past ``fleet_stale_after_s`` (0: twice the publish
interval, so a SIGKILLed process reads crit within two intervals) and
pruned past ``fleet_prune_after_s``.  pyarrow is imported inside the
table builders.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

FLEET_DIR = "_hyperspace_fleet"
SNAPSHOT_VERSION = 1
_KEY_PREFIX = "hb-"
# The interesting flight records a snapshot carries, at most.
FLEET_RECORDS_MAX = 32
# Below this many milliseconds between the max and the median, kernel-ms
# totals are start-up noise, not a straggler.
SKEW_FLOOR_MS = 50.0

# -- process identity and role ------------------------------------------------
_ROLE_RANK = {"client": 0, "daemon": 1, "server": 2}
_role = "client"
_identity: Optional[str] = None
_identity_lock = threading.Lock()
# A serving process's address and draining flag, carried in its heartbeat
# so the front door (interop/server.FleetQueryClient) maps endpoints to
# rows and skips a server in its drain grace window.  QueryServer's
# start() and drain() set them.
_serving_address = ""
_serving_draining = False


def process_identity() -> str:
    """This process's identity, ``<host>-<pid>-<start_ms>``: a restart
    mints a new one, so the old heartbeat goes stale and is later pruned
    instead of being overwritten.  The lease holder, the build claims'
    holders and the heartbeat all use it."""
    global _identity
    with _identity_lock:
        if _identity is None:
            import platform

            _identity = (f"{platform.node() or 'host'}-{os.getpid()}-"
                         f"{int(time.time() * 1000)}")
        return _identity


def process_role() -> str:
    return _role


def set_process_role(role: str) -> None:
    """Raise this process's published role (``server`` > ``daemon`` >
    ``client``: a server that also runs the lifecycle daemon reports
    ``server``).  A lower role is ignored."""
    global _role
    if _ROLE_RANK.get(role, -1) > _ROLE_RANK.get(_role, 0):
        _role = role


def set_serving_address(address: str) -> None:
    """The ``host:port`` this process serves on."""
    global _serving_address
    _serving_address = str(address or "")


def set_serving_draining(draining: bool) -> None:
    """The heartbeat's ``draining`` flag: ``QueryServer.drain`` sets it
    and publishes at once, so the front door stops routing here during
    the grace window, not only after the final deregister."""
    global _serving_draining
    _serving_draining = bool(draining)


# -- conf accessors -----------------------------------------------------------
def enabled(conf) -> bool:
    return bool(getattr(conf, "fleet_telemetry_enabled", False))


def publish_interval_s(conf) -> float:
    return max(0.05, float(getattr(conf, "fleet_publish_interval_s", 5.0)))


def stale_after_s(conf) -> float:
    """The age past which a heartbeat reads as a dead or hung process;
    the conf's 0 means twice the publish interval."""
    explicit = float(getattr(conf, "fleet_stale_after_s", 0.0))
    return explicit if explicit > 0 else 2.0 * publish_interval_s(conf)


def prune_after_s(conf) -> float:
    return float(getattr(conf, "fleet_prune_after_s", 600.0))


def fleet_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), FLEET_DIR)


def _store(conf):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    return store_for(conf, fleet_root(conf))


# -- the snapshot -------------------------------------------------------------
def device_kernel_ms_map(counters: Dict[str, Any]) -> Dict[str, float]:
    """The per-device attributed kernel-ms map out of a counters dict
    (the ``exec.device.<id>.kernel_ms`` series)."""
    out: Dict[str, float] = {}
    for name, value in counters.items():
        if not name.startswith("exec.device.") \
                or not name.endswith(".kernel_ms"):
            continue
        dev = name[len("exec.device."):-len(".kernel_ms")]
        try:
            out[dev] = float(value)
        except (TypeError, ValueError):
            continue
    return out


def build_snapshot(conf) -> Dict[str, Any]:
    """This process's current heartbeat: identity and role, the typed
    metrics snapshot, the health grade, the per-device kernel-ms map and
    the tail of the interesting flight records."""
    from hyperspace_tpu_torch.telemetry import flight_recorder, metrics

    typed = metrics.registry().typed_snapshot()
    interesting = [r for r in flight_recorder.recorder().records()
                   if r.get("reason") != "sample"]
    return {
        "v": SNAPSHOT_VERSION,
        "ts": time.time(),
        "process": process_identity(),
        "host": process_identity().rsplit("-", 2)[0],
        "pid": os.getpid(),
        "role": process_role(),
        "health": typed["gauges"].get("health.status"),
        "address": _serving_address,
        "draining": _serving_draining,
        "metrics": typed,
        "device_kernel_ms": device_kernel_ms_map(typed["counters"]),
        "records": interesting[-FLEET_RECORDS_MAX:],
        # Active SLO alerts: none without an alert engine.
        "alerts": [],
    }


def publish_once(conf) -> bool:
    """Publish (or CAS-refresh) this process's heartbeat and prune
    ancient ones.  Fault-quiet and never raises: an armed fault budget
    is never spent here, and a broken store costs
    ``fleet.publish.errors``, not a query."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.trace import span

    if not enabled(conf):
        return False
    try:
        with faults.quiet(), span("fleet.publish") as sp:
            store = _store(conf)
            key = _KEY_PREFIX + process_identity()
            payload = json.dumps(build_snapshot(conf),
                                 default=str).encode("utf-8")
            committed = False
            for _ in range(4):
                # Generation 0 is the put-if-absent form; a refresh CASes
                # against the generation just read.
                gen = store.generation(key)
                if store.put_if_generation_match(key, payload, gen):
                    committed = True
                    break
            if not committed:
                metrics.inc("fleet.publish.errors")
                return False
            _prune_stale(store, conf)
            metrics.inc("fleet.publishes")
            sp.set(bytes=len(payload))
            return True
    except Exception:  # noqa: BLE001 - fleet telemetry never fails its
        metrics.inc("fleet.publish.errors")  # process
        return False


def _prune_stale(store, conf) -> None:
    """Delete heartbeats older than ``fleet_prune_after_s``.  An
    unparseable one is left to its owner's next refresh."""
    from hyperspace_tpu_torch.telemetry import metrics

    cutoff = prune_after_s(conf)
    if cutoff <= 0:
        return
    own = _KEY_PREFIX + process_identity()
    now = time.time()
    for key in store.list_keys(_KEY_PREFIX):
        if key == own:
            continue
        try:
            rec = json.loads(store.read(key).decode("utf-8"))
            ts = float(rec.get("ts", 0.0))
        except (FileNotFoundError, ValueError, UnicodeDecodeError,
                TypeError):
            continue
        if now - ts > cutoff:
            store.delete(key)
            metrics.inc("fleet.pruned")


# -- the publisher thread -----------------------------------------------------
class FleetPublisher:
    """One heartbeat thread per session (``publisher_for``), opt-in
    through ``conf.fleet_telemetry_enabled``."""

    def __init__(self, session) -> None:
        self.session = session
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "FleetPublisher":
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        if not enabled(self.session.conf):
            raise HyperspaceError(
                "Fleet telemetry is opt-in: set "
                "conf.fleet_telemetry_enabled = True (or publish one "
                "snapshot with telemetry.fleet.publish_once)")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hs-fleet-publisher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0,
             deregister: bool = True) -> None:
        """Stop heartbeating and, by default, delete this process's
        heartbeat: a planned exit must not read as a dead process.  A
        SIGKILLed process never runs this, which is how it is flagged."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if deregister and enabled(self.session.conf):
            deregister_process(self.session.conf)

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.is_set():
            publish_once(self.session.conf)
            self._stop.wait(publish_interval_s(self.session.conf))


def publisher_for(session) -> FleetPublisher:
    """The session's publisher, made at first use (its thread starts
    only in :meth:`FleetPublisher.start`)."""
    p = getattr(session, "_fleet_publisher", None)
    if p is None:
        p = FleetPublisher(session)
        session._fleet_publisher = p
    return p


def maybe_start(session) -> Optional[FleetPublisher]:
    """Start the publisher when the conf turns it on; never raises (a
    telemetry failure must not break a session or a server)."""
    try:
        if not enabled(session.conf):
            return None
        return publisher_for(session).start()
    except Exception:  # noqa: BLE001 - telemetry never breaks callers
        return None


# -- federation reads ---------------------------------------------------------
def live_snapshots(conf) -> List[Dict[str, Any]]:
    """Every parseable heartbeat, stale ones included (the doctor grades
    them), with its ``key`` and ``age_s``.  An unreadable store reads
    empty; torn snapshots are skipped.  Fault-quiet."""
    from hyperspace_tpu_torch.io import faults

    out: List[Dict[str, Any]] = []
    now = time.time()
    try:
        with faults.quiet():
            store = _store(conf)
            for key in sorted(store.list_keys(_KEY_PREFIX)):
                try:
                    rec = json.loads(store.read(key).decode("utf-8"))
                except (FileNotFoundError, ValueError,
                        UnicodeDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                rec["key"] = key
                rec["age_s"] = max(0.0, now - float(rec.get("ts", 0.0)
                                                    or 0.0))
                out.append(rec)
    except Exception:  # noqa: BLE001 - an unreadable fleet reads empty
        pass
    return out


def fresh_snapshots(conf) -> List[Dict[str, Any]]:
    cutoff = stale_after_s(conf)
    return [s for s in live_snapshots(conf) if s["age_s"] <= cutoff]


_HEALTH_NAMES = {0: "ok", 1: "warn", 2: "crit"}


def fleet_status_table(conf):
    """One row per heartbeat, what ``Hyperspace.fleet_status()`` and the
    ``fleet_status`` verb serve.  Columns: process, host, pid, role,
    address (the serving ``host:port``, empty for others), status (the
    last published ``health.status`` grade, empty before the process's
    first ``doctor()``), ageSeconds, fresh, draining, records (the
    interesting flight records carried), snapshotJson."""
    import pyarrow as pa

    snaps = live_snapshots(conf)
    cutoff = stale_after_s(conf)

    def health_name(s) -> str:
        h = s.get("health")
        try:
            return _HEALTH_NAMES.get(int(h), "") if h is not None else ""
        except (TypeError, ValueError):
            return ""

    return pa.table({
        "process": pa.array([str(s.get("process", "")) for s in snaps],
                            type=pa.string()),
        "host": pa.array([str(s.get("host", "")) for s in snaps],
                         type=pa.string()),
        "pid": pa.array([int(s.get("pid", 0) or 0) for s in snaps],
                        type=pa.int64()),
        "role": pa.array([str(s.get("role", "")) for s in snaps],
                         type=pa.string()),
        "address": pa.array([str(s.get("address", "") or "")
                             for s in snaps], type=pa.string()),
        "status": pa.array([health_name(s) for s in snaps],
                           type=pa.string()),
        "ageSeconds": pa.array([round(float(s.get("age_s", 0.0)), 3)
                                for s in snaps], type=pa.float64()),
        "fresh": pa.array([float(s.get("age_s", 0.0)) <= cutoff
                           for s in snaps], type=pa.bool_()),
        "draining": pa.array([bool(s.get("draining", False))
                              for s in snaps], type=pa.bool_()),
        "records": pa.array([len(s.get("records") or [])
                             for s in snaps], type=pa.int64()),
        "snapshotJson": pa.array([json.dumps(s, default=str)
                                  for s in snaps], type=pa.string()),
    })


# -- merge semantics ----------------------------------------------------------
def merge_metrics(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge typed metric snapshots: counters by sum, gauges per process
    (``name -> {process: value}``: a fleet-wide sum of ``health.status``
    means nothing), histograms bucket by bucket over the shared fixed
    scale, with count and sum summed, min and max folded, the mean
    recomputed and the exemplars carried (per bucket, the last
    process's wins).  Pure."""
    counters: Dict[str, float] = {}
    gauges: Dict[str, Dict[str, float]] = {}
    histograms: Dict[str, Dict[str, Any]] = {}
    processes: List[str] = []
    for snap in snapshots:
        proc = str(snap.get("process", ""))
        processes.append(proc)
        typed = snap.get("metrics") or {}
        for name, value in (typed.get("counters") or {}).items():
            try:
                counters[name] = counters.get(name, 0.0) + float(value)
            except (TypeError, ValueError):
                continue
        for name, value in (typed.get("gauges") or {}).items():
            try:
                gauges.setdefault(name, {})[proc] = float(value)
            except (TypeError, ValueError):
                continue
        for name, h in (typed.get("histograms") or {}).items():
            if not isinstance(h, dict):
                continue
            merged = histograms.setdefault(name, {
                "count": 0, "sum": 0.0, "min": None, "max": None,
                "buckets": {}, "exemplars": {}})
            merged["count"] += int(h.get("count", 0) or 0)
            merged["sum"] += float(h.get("sum", 0.0) or 0.0)
            for bound, n in (h.get("buckets") or {}).items():
                b = str(bound)
                merged["buckets"][b] = merged["buckets"].get(b, 0) \
                    + int(n or 0)
            for side, fold in (("min", min), ("max", max)):
                v = h.get(side)
                if v is not None:
                    cur = merged[side]
                    merged[side] = float(v) if cur is None \
                        else fold(cur, float(v))
            for bucket, ex in (h.get("exemplars") or {}).items():
                merged["exemplars"][str(bucket)] = ex
    for merged in histograms.values():
        merged["mean"] = round(merged["sum"] / merged["count"], 6) \
            if merged["count"] else None
    return {"processes": processes, "counters": counters,
            "gauges": gauges, "histograms": histograms}


def _merge_inputs(conf) -> List[Dict[str, Any]]:
    """The fresh heartbeats, with this process's own replaced by its
    live registry (a scrape sees this process current between heartbeats
    and with its publisher off)."""
    own = process_identity()
    snaps = [s for s in fresh_snapshots(conf)
             if str(s.get("process", "")) != own]
    snaps.append(build_snapshot(conf))
    return snaps


def fleet_metrics(conf) -> Dict[str, Any]:
    """The fleet-merged metrics over every fresh heartbeat and this
    process's live registry: ``Hyperspace.fleet_metrics()``."""
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.trace import span

    with span("fleet.merge") as sp:
        snaps = _merge_inputs(conf)
        merged = merge_metrics(snaps)
        metrics.inc("fleet.merges")
        metrics.set_gauge("fleet.processes", len(merged["processes"]))
        sp.set(processes=len(merged["processes"]))
        return merged


def render_fleet_prometheus(conf) -> str:
    """The merged Prometheus text exposition: every process's series with
    a ``process="<id>"`` label, what ``MetricsScrapeServer(fleet=True)``
    serves."""
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.trace import span

    def prom(name: str) -> str:
        return "hyperspace_" + name.replace(".", "_").replace("-", "_")

    help_for = metrics.help_lookup()
    with span("fleet.merge") as sp:
        snaps = _merge_inputs(conf)
        metrics.inc("fleet.merges")
        metrics.set_gauge("fleet.processes", len(snaps))
        sp.set(processes=len(snaps))
        lines: List[str] = []
        typed_of = {str(s.get("process", "")): (s.get("metrics") or {})
                    for s in snaps}
        headed: set = set()

        def head(name: str, kind: str) -> None:
            if name in headed:
                return
            headed.add(name)
            doc = help_for(name)
            if doc:
                lines.append(f"# HELP {prom(name)} {doc}")
            lines.append(f"# TYPE {prom(name)} {kind}")

        for proc in sorted(typed_of):
            typed = typed_of[proc]
            label = f'process="{proc}"'
            for name, v in sorted((typed.get("counters") or {}).items()):
                head(name, "counter")
                lines.append(f"{prom(name)}{{{label}}} {float(v):g}")
            for name, v in sorted((typed.get("gauges") or {}).items()):
                head(name, "gauge")
                lines.append(f"{prom(name)}{{{label}}} {float(v):g}")
            for name, h in sorted((typed.get("histograms")
                                   or {}).items()):
                if not isinstance(h, dict):
                    continue
                head(name, "histogram")
                cumulative = 0
                buckets = h.get("buckets") or {}
                exemplars = h.get("exemplars") or {}
                for i, bound in enumerate(_bucket_order(buckets)):
                    cumulative += int(buckets.get(bound, 0) or 0)
                    line = (f'{prom(name)}_bucket{{{label},'
                            f'le="{_le(bound)}"}} {cumulative}')
                    ex = exemplars.get(str(i))
                    if isinstance(ex, (list, tuple)) and len(ex) == 2:
                        line += (f' # {{trace_id="{ex[0]}"}} '
                                 f'{float(ex[1]):g}')
                    lines.append(line)
                lines.append(f"{prom(name)}_sum{{{label}}} "
                             f"{float(h.get('sum', 0.0) or 0.0):g}")
                lines.append(f"{prom(name)}_count{{{label}}} "
                             f"{int(h.get('count', 0) or 0)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _bucket_order(buckets: Dict[str, Any]) -> List[str]:
    """Bucket bounds come back from JSON as strings: numeric order, with
    ``+Inf`` last."""
    def sort_key(b: str) -> float:
        try:
            return float(b)
        except ValueError:
            return float("inf")

    return sorted(buckets, key=sort_key)


def _le(bound: str) -> str:
    try:
        return f"{float(bound):g}"
    except ValueError:
        return "+Inf"


# -- federated slow queries and trace resolution ------------------------------
def _fleet_records(conf) -> List[Dict[str, Any]]:
    """The records, each with its ``process``, of the local ring, every
    heartbeat (stale ones too: a dead process's tail is what an operator
    wants) and the persisted diagnostics bundles; deduplicated by
    (trace_id, request_id, ts), since a process's ring also rides its
    heartbeat.  Oldest first."""
    from hyperspace_tpu_torch.telemetry import flight_recorder

    own = process_identity()
    out: List[Dict[str, Any]] = []
    seen: set = set()

    def add(rec: Dict[str, Any], proc: str) -> None:
        key = (rec.get("trace_id"), rec.get("request_id"),
               round(float(rec.get("ts", 0.0) or 0.0), 3))
        if key in seen:
            return
        seen.add(key)
        out.append({**rec, "process": proc})

    for rec in flight_recorder.recorder().records():
        add(rec, own)
    for snap in live_snapshots(conf):
        proc = str(snap.get("process", ""))
        for rec in snap.get("records") or []:
            if isinstance(rec, dict):
                add(rec, proc)
    for bundle in flight_recorder.bundles(conf):
        proc = f"bundle-{bundle.get('pid', '?')}"
        for rec in bundle.get("records") or []:
            if isinstance(rec, dict):
                add(rec, proc)
    out.sort(key=lambda r: float(r.get("ts", 0.0) or 0.0))
    return out


def fleet_slow_queries_table(conf):
    """``slow_queries(fleet=True)``: the federated records as a pyarrow
    table, the JAX package's columns with ``process``."""
    import pyarrow as pa

    recs = _fleet_records(conf)
    return pa.table({
        "ts": pa.array([float(r.get("ts", 0.0) or 0.0) for r in recs],
                       type=pa.float64()),
        "process": pa.array([str(r.get("process", "")) for r in recs],
                            type=pa.string()),
        "traceId": pa.array([str(r.get("trace_id", "")) for r in recs],
                            type=pa.string()),
        "requestId": pa.array([str(r.get("request_id", ""))
                               for r in recs], type=pa.string()),
        "kind": pa.array([str(r.get("kind", "")) for r in recs],
                         type=pa.string()),
        "outcome": pa.array([str(r.get("outcome", "")) for r in recs],
                            type=pa.string()),
        "latencyMs": pa.array([float(r.get("latency_ms", 0.0) or 0.0)
                               for r in recs], type=pa.float64()),
        "slow": pa.array([bool(r.get("slow")) for r in recs],
                         type=pa.bool_()),
        "reason": pa.array([str(r.get("reason", "")) for r in recs],
                           type=pa.string()),
        "error": pa.array([str(r.get("error", "")) for r in recs],
                          type=pa.string()),
        "recordJson": pa.array([json.dumps(r, default=str)
                                for r in recs], type=pa.string()),
    })


def find_trace(conf, trace_id: str) -> Optional[Dict[str, Any]]:
    """``trace(id, fleet=True)``: ``trace_id`` in the local ring first,
    then in every heartbeat, then in the persisted bundles; the record
    carries a ``process`` naming where it ran.  None when nowhere."""
    from hyperspace_tpu_torch.telemetry import flight_recorder

    tid = trace_id.lower()
    rec = flight_recorder.recorder().find(tid)
    if rec is not None:
        return {**rec, "process": process_identity()}
    best: Optional[Dict[str, Any]] = None
    for snap in live_snapshots(conf):
        for r in snap.get("records") or []:
            if isinstance(r, dict) and r.get("trace_id") == tid:
                best = {**r, "process": str(snap.get("process", ""))}
    if best is not None:
        return best
    for bundle in flight_recorder.bundles(conf):
        for r in bundle.get("records") or []:
            if isinstance(r, dict) and r.get("trace_id") == tid:
                best = {**r,
                        "process": f"bundle-{bundle.get('pid', '?')}"}
    return best


# -- cluster doctor checks ----------------------------------------------------
def fleet_checks(session) -> List[Any]:
    """The cluster checks of ``doctor(fleet=True)``, each guarded like
    the local ones (a blind check is a warn, never a crash).  Read-only:
    the doctor verb answers inline while the admission queue sheds."""
    from hyperspace_tpu_torch.telemetry.doctor import _guarded

    conf = session.conf
    return [
        _guarded("fleet.heartbeats",
                 lambda: _check_heartbeats(conf)),
        _guarded("fleet.daemons", lambda: _check_daemons(conf)),
        _guarded("fleet.serving", lambda: _check_fleet_serving(conf)),
        _guarded("fleet.skew", lambda: _check_fleet_skew(conf)),
        _guarded("fleet.build_claims",
                 lambda: _check_build_claims(conf)),
        _guarded("fleet.alerts", lambda: _check_fleet_alerts(conf)),
    ]


def _check_fleet_alerts(conf):
    """A FIRING SLO alert that another process's fresh heartbeat carries
    grades the cluster crit (severity ``page``) or warn.  Without an
    alert engine in this package, this process carries none."""
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck
    from hyperspace_tpu_torch.telemetry.slo import FIRING

    firing: List[Dict[str, Any]] = []
    own = process_identity()
    for snap in fresh_snapshots(conf):
        proc = str(snap.get("process", ""))
        if proc == own:
            continue
        for a in snap.get("alerts") or []:
            if isinstance(a, dict) and a.get("state") == FIRING:
                firing.append({**a, "process": proc})
    if not firing:
        return DoctorCheck("fleet.alerts", "ok",
                           "no firing SLO alerts across the fleet", {})
    pages = [a for a in firing if a.get("severity") == "page"]
    status = "crit" if pages else "warn"
    names = sorted({f"{a.get('alert')}@{a.get('process', '')[:24]}"
                    for a in firing})
    return DoctorCheck(
        "fleet.alerts", status,
        f"{len(firing)} firing SLO alert(s) across the fleet: "
        f"{', '.join(names[:4])} — incident bundles are in "
        f"diagnostics_bundles()", {"firing": firing})


def _check_heartbeats(conf):
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck

    snaps = live_snapshots(conf)
    cutoff = stale_after_s(conf)
    fresh = [s for s in snaps if s["age_s"] <= cutoff]
    stale = {str(s.get("process", "")): round(s["age_s"], 1)
             for s in snaps if s["age_s"] > cutoff}
    metrics.set_gauge("fleet.processes", len(fresh))
    if not snaps:
        return DoctorCheck(
            "fleet.heartbeats", "ok",
            "no fleet heartbeats published (set "
            "conf.fleet_telemetry_enabled in each process)", {})
    if stale:
        return DoctorCheck(
            "fleet.heartbeats", "crit",
            f"{len(stale)}/{len(snaps)} process(es) stale past "
            f"{cutoff:.1f}s — dead or hung; their last published state "
            f"is still readable via fleet_status()",
            {"stale": stale, "fresh": len(fresh)})
    return DoctorCheck(
        "fleet.heartbeats", "ok",
        f"{len(fresh)} process(es) publishing fresh heartbeats",
        {"fresh": len(fresh)})


def _check_daemons(conf):
    from hyperspace_tpu_torch.lifecycle import lease as _lease
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck

    fresh = fresh_snapshots(conf)
    daemons = [str(s.get("process", "")) for s in fresh
               if s.get("role") == "daemon"]
    rec = _lease.status(conf)
    if rec is None:
        # No lease record: concurrent maintainers are uncoordinated.
        if len(daemons) > 1:
            return DoctorCheck(
                "fleet.daemons", "warn",
                f"{len(daemons)} processes report the lifecycle-daemon "
                f"role with no maintenance lease — concurrent "
                f"maintainers waste work rebasing on each other (set "
                f"conf.lifecycle_lease_enabled to elect one)",
                {"daemons": daemons})
        return DoctorCheck("fleet.daemons", "ok",
                           f"{len(daemons)} lifecycle daemon(s) in the "
                           f"fleet", {"daemons": daemons})
    holder = str(rec.get("holder", ""))
    epoch = int(rec.get("epoch", 0) or 0)
    live = {str(s.get("process", "")) for s in fresh}
    data = {"holder": holder, "epoch": epoch,
            "lease_fresh": bool(rec.get("fresh")), "daemons": daemons}
    if rec.get("fresh"):
        if not live:
            # Nobody heartbeats: the lease alone proves one maintainer,
            # and there is nothing to cross-check it against.
            return DoctorCheck(
                "fleet.daemons", "ok",
                f"maintenance lease epoch {epoch} held by {holder}; no "
                f"fleet heartbeats to cross-check", data)
        if holder in live:
            standbys = max(0, len(daemons) - 1)
            return DoctorCheck(
                "fleet.daemons", "ok",
                f"maintenance lease epoch {epoch} held by live process "
                f"{holder} ({standbys} standby daemon(s))", data)
        return DoctorCheck(
            "fleet.daemons", "crit",
            f"maintenance lease epoch {epoch} held by {holder}, which "
            f"publishes no live heartbeat — the holder died holding "
            f"the lease; takeover happens when it expires "
            f"(ttl {_lease.ttl_s(conf):.0f}s)", data)
    if daemons:
        return DoctorCheck(
            "fleet.daemons", "warn",
            f"maintenance lease epoch {epoch} expired with "
            f"{len(daemons)} candidate daemon(s) — takeover pending "
            f"next poll", data)
    return DoctorCheck(
        "fleet.daemons", "ok",
        f"maintenance lease epoch {epoch} expired and no daemons "
        f"running", data)


def _check_fleet_serving(conf):
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck, _slo_burn

    merged = merge_metrics(fresh_snapshots(conf))
    requests = float(merged["counters"].get("serve.requests", 0.0))
    shed = float(merged["counters"].get("serve.shed", 0.0))
    if requests <= 0:
        return DoctorCheck("fleet.serving", "ok",
                           "no served traffic across the fleet", {})
    shed_ratio = shed / requests
    warn_ratio = float(getattr(conf, "doctor_shed_warn_ratio", 0.05))
    slo_ms = float(getattr(conf, "doctor_latency_slo_ms", 1000.0))
    burn = _slo_burn(merged["histograms"].get("serve.latency_ms"),
                     slo_ms)
    data = {"requests": int(requests),
            "shed_ratio": round(shed_ratio, 4),
            "slo_ms": slo_ms, "slo_burn": round(burn, 4),
            "processes": len(merged["processes"])}
    if (warn_ratio > 0 and shed_ratio >= 5 * warn_ratio) or burn >= 0.5:
        return DoctorCheck(
            "fleet.serving", "crit",
            f"fleet overloaded: aggregate shed ratio {shed_ratio:.2f}, "
            f"SLO burn {burn:.2f}", data)
    if (warn_ratio > 0 and shed_ratio >= warn_ratio) or burn >= 0.1:
        return DoctorCheck(
            "fleet.serving", "warn",
            f"aggregate shed ratio {shed_ratio:.2f}, SLO burn "
            f"{burn:.2f}", data)
    return DoctorCheck(
        "fleet.serving", "ok",
        f"{int(requests)} requests fleet-wide, shed ratio "
        f"{shed_ratio:.2f}, SLO burn {burn:.2f}", data)


def skew_ratio(values: List[float]) -> float:
    """max/median over attributed kernel-ms totals, the straggler grade;
    0.0 when there is nothing to compare (fewer than two lanes, or
    totals under the noise floor)."""
    import statistics

    vals = [float(v) for v in values if v is not None]
    if len(vals) < 2:
        return 0.0
    med = statistics.median(vals)
    mx = max(vals)
    if med <= 0 or mx - med < SKEW_FLOOR_MS:
        return 0.0
    return mx / med


def _check_fleet_skew(conf):
    """Per-process and per-device kernel-ms skew over the fresh
    heartbeats.  Devices are keyed by their CUDA index (a mesh program
    by shard position), so on a one-card host every process adds to
    device ``"0"`` and only the per-process ratio shows a straggler."""
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck

    warn_at = float(getattr(conf, "doctor_device_skew_warn", 4.0))
    per_process: Dict[str, float] = {}
    per_device: Dict[str, float] = {}
    for snap in fresh_snapshots(conf):
        proc = str(snap.get("process", ""))
        dev_map = snap.get("device_kernel_ms") or {}
        total = 0.0
        for dev, ms in dev_map.items():
            try:
                ms = float(ms)
            except (TypeError, ValueError):
                continue
            total += ms
            per_device[str(dev)] = per_device.get(str(dev), 0.0) + ms
        if total > 0:
            per_process[proc] = total
    proc_ratio = skew_ratio(list(per_process.values()))
    dev_ratio = skew_ratio(list(per_device.values()))
    data = {"per_process_ms": {k: round(v, 1)
                               for k, v in per_process.items()},
            "per_device_ms": {k: round(v, 1)
                              for k, v in per_device.items()},
            "process_ratio": round(proc_ratio, 2),
            "device_ratio": round(dev_ratio, 2)}
    if warn_at > 0 and (proc_ratio >= warn_at or dev_ratio >= warn_at):
        which = "process" if proc_ratio >= warn_at else "device"
        return DoctorCheck(
            "fleet.skew", "warn",
            f"kernel-ms skew across the fleet: max/median per-{which} "
            f"ratio {max(proc_ratio, dev_ratio):.1f} >= {warn_at:g} — "
            f"a straggler {which}", data)
    return DoctorCheck("fleet.skew", "ok",
                       "no cross-process or cross-device kernel-ms "
                       "skew", data)


def _check_build_claims(conf):
    """Leftover multi-host build claims (parallel/multihost_build.py)
    graded against the heartbeats: an expired claim with no live holder
    is crash debris that any claimant reclaims (warn); a fresh claim
    whose holder publishes no fresh heartbeat is a dead or hung host
    fencing the item until the claim TTL runs out (crit).  Read-only;
    the journaled trail comes from the claim protocol itself."""
    from hyperspace_tpu_torch.parallel.multihost_build import (
        scan_build_claims,
    )
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck

    claims = scan_build_claims(conf)
    if not claims:
        return DoctorCheck("fleet.build_claims", "ok",
                           "no leftover multi-host build claims", {})
    fresh = {str(s.get("process", "")) for s in fresh_snapshots(conf)}
    now = time.time()
    expired_orphans, fresh_dead = [], []
    for rec in claims:
        live = str(rec.get("holder", "")) in fresh
        if float(rec.get("expires_at", 0.0)) < now:
            if not live:
                expired_orphans.append(rec)
        elif fresh and not live:
            # Gradeable only when somebody heartbeats (as fleet.daemons'
            # lease-only case).
            fresh_dead.append(rec)

    def brief(recs):
        return [{"build": r.get("build_id"), "item": r.get("item"),
                 "holder": r.get("holder")} for r in recs]

    data = {"pending": len(claims),
            "expired_no_heartbeat": brief(expired_orphans),
            "fresh_dead_holder": brief(fresh_dead)}
    if fresh_dead:
        return DoctorCheck(
            "fleet.build_claims", "crit",
            f"{len(fresh_dead)} fresh build claim(s) held by "
            f"process(es) with no fresh heartbeat — a dead or hung "
            f"host is fencing work; the build stalls until the claim "
            f"TTL expires", data)
    if expired_orphans:
        return DoctorCheck(
            "fleet.build_claims", "warn",
            f"{len(expired_orphans)} expired build claim(s) with no "
            f"live holder — crash debris; survivors (or the next "
            f"build) reclaim them after the TTL", data)
    return DoctorCheck(
        "fleet.build_claims", "ok",
        f"{len(claims)} in-flight build claim(s), every holder "
        f"heartbeating", data)


def deregister_process(conf) -> None:
    """Delete this process's heartbeat (a planned exit); fault-quiet,
    never raises."""
    from hyperspace_tpu_torch.io import faults

    try:
        with faults.quiet():
            _store(conf).delete(_KEY_PREFIX + process_identity())
    except Exception:  # noqa: BLE001 - best-effort cleanup
        pass


def clear(conf) -> None:
    """Delete every heartbeat (tests)."""
    from hyperspace_tpu_torch.io import faults

    with faults.quiet():
        store = _store(conf)
        for key in store.list_keys():
            store.delete(key)
