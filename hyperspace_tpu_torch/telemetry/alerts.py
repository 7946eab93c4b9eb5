"""The SLO alert engine: continuous evaluation, a persisted alert state
machine and incident bundles captured at the page (counterpart of
hyperspace_tpu/telemetry/alerts.py, with its store layout, record fields
and ``RECORD_VERSION``, so either package reads the other's alert log).

``doctor()`` grades only when someone calls it; this module is the loop
that calls it first.  An evaluator thread, on only when
``conf.alerts_enabled`` is set and ticking every ``alerts_interval_s``
(0: the fleet heartbeat's ``fleet_publish_interval_s``), samples the
metrics registry and evaluates four objectives with the multi-window
multi-burn-rate math of telemetry/slo.py:

  ================  =========================================================
  ``availability``  ``serve.ok`` good against ``serve.errors`` +
                    ``serve.shed`` + ``serve.send_timeouts`` bad (an
                    answer that never reached the wire counts against
                    the caller), at ``alerts_availability_target``;
                    the fast pair of windows pages, the slow pair warns.
  ``latency``       the ``serve.latency_ms`` histogram split at
                    ``doctor_latency_slo_ms``, at
                    ``alerts_latency_target`` (the same rules).
  ``staleness``     the most stale ACTIVE index's seconds through the
                    lifecycle change detector, at
                    ``alerts_staleness_warn_s`` (warn).
  ``build_claims``  fresh multi-host build claims whose holder publishes
                    no fresh heartbeat (a dead host fencing work): any
                    one pages.
  ================  =========================================================

Each alert runs the flap-damped pending → firing → resolved machine
(``slo.step_state``).  Every change of state is one record under
``<systemPath>/_hyperspace_alerts``, written through the store of
``conf.log_store_class`` (``perf_ledger.store_for``; fault-quiet, never
raises), so a firing alert survives a restart and resolves from the next
engine.  On the change to firing the engine captures an incident bundle
into the diagnostics store (``_hyperspace_diagnostics``): the flight
recorder's ring, a metrics snapshot and the perf tail, plus the doctor's
report, the timeline's trace events and the alert's evaluation window.

Surfacing: ``Hyperspace.alerts()`` / ``alert_history()``, the inline
``alerts`` verb of the query server, the fleet heartbeat (it carries the
active alerts; ``alerts(fleet=True)`` lists them by process and a firing
one grades the cluster doctor's ``fleet.alerts``), the doctor CLI's
``--alerts`` gate, and ``conf.alerts_notify_command``, which runs off the
evaluation thread with the transition record as JSON on stdin.

Metrics: the counters ``alerts.evaluations``, ``alerts.transitions``,
``alerts.bundles_captured``, ``alerts.notifications`` and
``alerts.errors`` and the gauge ``alerts.firing``; the spans
``alert.evaluate`` and ``alert.capture``.  Nothing here touches the
card: the registry holds Python floats, and the doctor's checks are
stat-level.  pyarrow is imported inside the table builders.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.telemetry import slo

ALERT_DIR = "_hyperspace_alerts"
RECORD_VERSION = 1
# The in-memory sample ring per objective (at a 5 s cadence it covers the
# 3 d slow window at 1/12 resolution; tiny test windows exactly).
MAX_SAMPLES = 4096
# Active (pending or firing) alerts one heartbeat carries, at most.
FLEET_ALERTS_MAX = 16

_seq_lock = threading.Lock()
_seq = 0


# -- conf accessors -----------------------------------------------------------
def enabled(conf) -> bool:
    return bool(conf.alerts_enabled)


def interval_s(conf) -> float:
    """The evaluation cadence: ``conf.alerts_interval_s`` when set (at
    least 0.05 s), else the fleet heartbeat's."""
    explicit = float(conf.alerts_interval_s)
    if explicit > 0:
        return max(0.05, explicit)
    from hyperspace_tpu_torch.telemetry import fleet

    return fleet.publish_interval_s(conf)


def alert_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), ALERT_DIR)


def _store(conf):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    return store_for(conf, alert_root(conf))


def _rules(conf) -> List[slo.BurnRule]:
    return slo.default_rules(
        fast_short_s=float(conf.alerts_fast_short_s),
        fast_long_s=float(conf.alerts_fast_long_s),
        fast_factor=float(conf.alerts_fast_factor),
        slow_short_s=float(conf.alerts_slow_short_s),
        slow_long_s=float(conf.alerts_slow_long_s),
        slow_factor=float(conf.alerts_slow_factor))


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


def _next_key() -> str:
    return (f"a-{int(time.time() * 1000):013d}-{os.getpid()}-"
            f"{_next_seq():05d}")


# -- persistence --------------------------------------------------------------
def append_transition(conf, record: Dict[str, Any]) -> Optional[str]:
    """Persist one change of state; its key, or None on failure.  Never
    raises and runs fault-quiet: alert IO neither fails the engine nor
    spends an armed fault aimed at the system under test.  Past
    ``conf.alerts_max_entries`` the oldest records go, but never the
    newest of any alert: that record is its state across a restart."""
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.telemetry import metrics

    try:
        with faults.quiet():
            store = _store(conf)
            rec = {"v": RECORD_VERSION, "ts": time.time(), **record}
            payload = json.dumps(rec, default=str).encode("utf-8")
            key = None
            for _ in range(4):
                key = _next_key()
                if store.put_if_absent(key, payload):
                    break
            else:
                metrics.inc("alerts.errors")
                return None
            cap = int(conf.alerts_max_entries)
            if cap > 0:
                keys = sorted(store.list_keys())
                if len(keys) > cap:
                    protected = set(_latest_keys(conf))
                    for old in keys[:len(keys) - cap]:
                        if old not in protected:
                            store.delete(old)
            return key
    except Exception:  # noqa: BLE001 - alert IO never fails the engine
        metrics.inc("alerts.errors")
        return None


def records(conf) -> List[Dict[str, Any]]:
    """Every parseable transition record, oldest first, each with its
    ``key``; a torn or unparseable record is skipped."""
    from hyperspace_tpu_torch.io import faults

    out: List[Dict[str, Any]] = []
    try:
        with faults.quiet():
            store = _store(conf)
            for key in sorted(store.list_keys()):
                try:
                    rec = json.loads(store.read(key).decode("utf-8"))
                except (FileNotFoundError, ValueError, UnicodeDecodeError):
                    continue
                if not isinstance(rec, dict):
                    continue
                rec["key"] = key
                out.append(rec)
    except Exception:  # noqa: BLE001 - an unreadable log reads empty
        pass
    return out


def _latest_keys(conf) -> List[str]:
    """The newest record's key of each alert (what a prune keeps)."""
    latest: Dict[str, str] = {}
    for rec in records(conf):
        name = str(rec.get("alert", ""))
        if name:
            latest[name] = str(rec.get("key", ""))
    return list(latest.values())


def load_states(conf) -> Dict[str, Dict[str, Any]]:
    """The state of each alert from the persisted log, the newest record
    of each winning: how a firing alert survives a restart."""
    states: Dict[str, Dict[str, Any]] = {}
    for rec in records(conf):
        name = str(rec.get("alert", ""))
        if not name:
            continue
        states[name] = {"state": str(rec.get("state", slo.RESOLVED)),
                        "streak": 0,
                        "since": float(rec.get("since", rec.get("ts", 0.0))
                                       or 0.0),
                        "severity": str(rec.get("severity", "")),
                        "bundle_key": rec.get("bundle_key"),
                        "detail": rec.get("detail") or {}}
    return states


def clear(conf) -> None:
    """Delete every persisted alert record."""
    from hyperspace_tpu_torch.io import faults

    with faults.quiet():
        store = _store(conf)
        for key in store.list_keys():
            store.delete(key)


def _active(states: Dict[str, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Pending and firing alerts as the compact dicts a heartbeat
    carries, by name, at most ``FLEET_ALERTS_MAX``."""
    out = []
    for name, st in sorted(states.items()):
        if st.get("state") in (slo.PENDING, slo.FIRING):
            out.append({"alert": name, "state": st["state"],
                        "severity": st.get("severity", ""),
                        "since": st.get("since", 0.0),
                        "bundle_key": st.get("bundle_key")})
    return out[:FLEET_ALERTS_MAX]


# -- the engine ---------------------------------------------------------------
class AlertEngine:
    """One evaluator per session (``engine_for``), opt-in through
    ``conf.alerts_enabled`` like the fleet publisher.  ``run_once()`` is
    the one evaluation the thread loops on; tests drive it directly."""

    def __init__(self, session) -> None:
        self.session = session
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._samples: Dict[str, List[slo.Sample]] = {}
        self._states: Optional[Dict[str, Dict[str, Any]]] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "AlertEngine":
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        if not enabled(self.session.conf):
            raise HyperspaceError(
                "The SLO alert engine is opt-in: set conf.alerts_enabled "
                "(evaluation rides the fleet-heartbeat cadence unless "
                "conf.alerts_interval_s overrides it)")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="hs-alert-engine", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None

    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.run_once()
            self._stop.wait(interval_s(self.session.conf))

    # -- evaluation ---------------------------------------------------------
    def run_once(self) -> List[Dict[str, Any]]:
        """One evaluation: sample, evaluate every objective, step the
        state machines, then persist, capture and notify each change.
        The transition records written (empty most ticks).  Never raises
        and runs fault-quiet."""
        from hyperspace_tpu_torch.io import faults
        from hyperspace_tpu_torch.telemetry import metrics
        from hyperspace_tpu_torch.telemetry.trace import span

        conf = self.session.conf
        transitions: List[Dict[str, Any]] = []
        try:
            with faults.quiet(), span("alert.evaluate") as sp:
                now = time.time()
                # Store and file-system reads stay outside the state lock:
                # load the states, run the probes, step the machines under
                # the lock, then commit the changes (bundle and record).
                self.current_states()
                probes = {"staleness": self._probe_staleness(),
                          "build_claims": self._probe_dead_claims(conf)}
                changes: List[Dict[str, Any]] = []
                with self._lock:
                    evaluations = self._evaluate_objectives(conf, now,
                                                            probes)
                    for name, ev in evaluations.items():
                        change = self._step_alert(conf, name, ev, now)
                        if change is not None:
                            changes.append(change)
                    firing = sum(1 for st in self._states.values()
                                 if st.get("state") == slo.FIRING)
                for change in changes:
                    transitions.append(
                        self._commit_transition(conf, change))
                metrics.inc("alerts.evaluations")
                metrics.set_gauge("alerts.firing", firing)
                if transitions:
                    metrics.inc("alerts.transitions", len(transitions))
                sp.set(firing=firing, transitions=len(transitions))
        except Exception:  # noqa: BLE001 - evaluation never fails callers
            metrics.inc("alerts.errors")
        for rec in transitions:
            _notify(conf, rec)
        return transitions

    def _evaluate_objectives(self, conf, now: float,
                             probes: Dict[str, Optional[float]],
                             ) -> Dict[str, Dict[str, Any]]:
        from hyperspace_tpu_torch.telemetry import metrics

        typed = metrics.registry().typed_snapshot()
        counters = typed["counters"]
        rules = _rules(conf)
        out: Dict[str, Dict[str, Any]] = {}

        # A response the server failed to deliver (serve.send_timeouts)
        # is an unavailable request to its caller, and the only trace
        # some wire faults leave on the server.
        good = float(counters.get("serve.ok", 0.0))
        bad = (float(counters.get("serve.errors", 0.0))
               + float(counters.get("serve.shed", 0.0))
               + float(counters.get("serve.send_timeouts", 0.0)))
        ring = self._append_sample("availability", now, good, bad)
        out["availability"] = slo.evaluate_objective(
            ring, now, rules, float(conf.alerts_availability_target))

        g_lat, b_lat = slo.hist_split(
            typed["histograms"].get("serve.latency_ms"),
            float(conf.doctor_latency_slo_ms))
        ring = self._append_sample("latency", now, g_lat, b_lat)
        out["latency"] = slo.evaluate_objective(
            ring, now, rules, float(conf.alerts_latency_target))

        out["staleness"] = slo.threshold_objective(
            probes.get("staleness"), float(conf.alerts_staleness_warn_s),
            "warn")
        out["build_claims"] = slo.threshold_objective(
            probes.get("build_claims"), 1.0, "page")
        return out

    def _append_sample(self, objective: str, now: float, good: float,
                       bad: float) -> List[slo.Sample]:
        ring = self._samples.setdefault(objective, [])
        ring.append(slo.Sample(now, good, bad))
        if len(ring) > MAX_SAMPLES:
            del ring[:len(ring) - MAX_SAMPLES]
        return ring

    def _probe_staleness(self) -> Optional[float]:
        """The most stale ACTIVE index's seconds (stat-level, the
        doctor's detector); None when the probe cannot run."""
        try:
            from hyperspace_tpu_torch.index.log_entry import States
            from hyperspace_tpu_torch.lifecycle.change_detector import (
                detect_changes,
            )

            manager = self.session.index_collection_manager
            worst = 0.0
            now = time.time()
            for entry in manager.get_indexes():
                if entry.state != States.ACTIVE:
                    continue
                change = detect_changes(self.session, entry)
                if change.changed:
                    age = (max(0.0, now - change.newest_change_ms / 1000.0)
                           if change.newest_change_ms > 0 else 0.0)
                    worst = max(worst, age)
            return worst
        except Exception:  # noqa: BLE001 - a blind probe never pages
            return None

    def _probe_dead_claims(self, conf) -> Optional[float]:
        """Fresh multi-host build claims whose holder publishes no fresh
        heartbeat (``fleet.build_claims``' crit case); None without
        heartbeats to hold them against."""
        try:
            from hyperspace_tpu_torch.parallel.multihost_build import (
                scan_build_claims,
            )
            from hyperspace_tpu_torch.telemetry import fleet

            claims = scan_build_claims(conf)
            if not claims:
                return 0.0
            fresh = {str(s.get("process", ""))
                     for s in fleet.fresh_snapshots(conf)}
            if not fresh:
                return None
            now = time.time()
            return float(sum(
                1 for rec in claims
                if float(rec.get("expires_at", 0.0)) >= now
                and str(rec.get("holder", "")) not in fresh))
        except Exception:  # noqa: BLE001 - a blind probe never pages
            return None

    def _step_alert(self, conf, name: str, evaluation: Dict[str, Any],
                    now: float) -> Optional[Dict[str, Any]]:
        """Step one alert's machine (pure; the caller holds the state
        lock).  A change of state returns its descriptor, which
        :meth:`_commit_transition` persists outside the lock."""
        prev = self._states.get(name)
        prev_state = str(prev.get("state", slo.RESOLVED)) if prev \
            else slo.RESOLVED
        new_state, transition = slo.step_state(
            prev, bool(evaluation.get("breached")),
            str(evaluation.get("severity", "")), now,
            pending_evals=int(conf.alerts_pending_evals),
            resolve_evals=int(conf.alerts_resolve_evals))
        new_state["detail"] = evaluation
        if prev is not None and prev.get("bundle_key") \
                and new_state["state"] != slo.RESOLVED:
            new_state["bundle_key"] = prev["bundle_key"]
        self._states[name] = new_state
        if new_state["state"] == prev_state:
            return None
        return {"name": name, "prev_state": prev_state,
                "transition": transition or "",
                "state": new_state["state"],
                "severity": new_state.get("severity", ""),
                "since": new_state.get("since", now),
                "evaluation": evaluation}

    def _commit_transition(self, conf,
                           change: Dict[str, Any]) -> Dict[str, Any]:
        """Persist one change: the incident bundle on a change to firing,
        then the transition record; all store IO, outside the lock."""
        name = change["name"]
        bundle_key = None
        if change["transition"] == "firing":
            bundle_key = self._capture_incident(conf, name,
                                                change["evaluation"])
            with self._lock:
                st = self._states.get(name)
                if st is not None and st["state"] != slo.RESOLVED:
                    st["bundle_key"] = bundle_key
        rec = {"alert": name, "state": change["state"],
               "prev_state": change["prev_state"],
               "severity": change["severity"],
               "transition": change["transition"],
               "since": change["since"],
               "bundle_key": bundle_key, "detail": change["evaluation"]}
        rec["key"] = append_transition(conf, rec)
        return rec

    def _capture_incident(self, conf, name: str,
                          evaluation: Dict[str, Any]) -> Optional[str]:
        """The why at the moment of the page: the diagnostics bundle, the
        doctor's report, the timeline's trace events and this alert's
        evaluation window, in the diagnostics store (at most
        ``conf.flight_recorder_max_bundles``), where every process's
        ``trace``/``slow_queries`` readers find it.  The bundle's key, or
        None on failure: a lost capture must not lose the record."""
        from hyperspace_tpu_torch.telemetry import (
            flight_recorder,
            metrics,
            timeline,
        )
        from hyperspace_tpu_torch.telemetry.perf_ledger import store_for
        from hyperspace_tpu_torch.telemetry.trace import span

        try:
            with span("alert.capture", alert=name) as sp:
                bundle = flight_recorder.diagnostics_bundle(conf)
                try:
                    from hyperspace_tpu_torch.telemetry.doctor import doctor

                    report = doctor(self.session).to_dict()
                except Exception:  # noqa: BLE001 - a blind doctor still
                    report = None  # leaves an incident to capture
                rec = timeline.recorder()
                window = {
                    obj: [[s.ts, s.good, s.bad] for s in ring[-256:]]
                    for obj, ring in self._samples.items()}
                bundle["incident"] = {
                    "alert": name,
                    "ts": time.time(),
                    "evaluation": evaluation,
                    "doctor": report,
                    "timeline": timeline.to_trace_events(
                        rec.intervals(), rec.memory_samples(), ()),
                    "window": window,
                }
                store = store_for(conf, flight_recorder.flight_root(conf))
                payload = json.dumps(bundle, default=str).encode("utf-8")
                key = None
                for _ in range(4):
                    key = (f"b-{int(time.time() * 1000):013d}-"
                           f"{os.getpid()}-i{_next_seq():05d}")
                    if store.put_if_absent(key, payload):
                        break
                else:
                    return None
                cap = max(1, int(conf.flight_recorder_max_bundles))
                keys = store.list_keys()
                if len(keys) > cap:
                    for old in sorted(keys)[:len(keys) - cap]:
                        store.delete(old)
                metrics.inc("alerts.bundles_captured")
                sp.set(key=key, bytes=len(payload))
                return key
        except Exception:  # noqa: BLE001 - capture never loses the page
            return None

    # -- reads --------------------------------------------------------------
    def current_states(self) -> Dict[str, Dict[str, Any]]:
        """The state of each alert, loaded from the persisted log at the
        first read (so it answers before the first evaluation).  The
        store read runs outside the lock; the first loader wins."""
        with self._lock:
            if self._states is not None:
                return {k: dict(v) for k, v in self._states.items()}
        loaded = load_states(self.session.conf)
        with self._lock:
            if self._states is None:
                self._states = loaded
            return {k: dict(v) for k, v in self._states.items()}

    def active_alerts(self) -> List[Dict[str, Any]]:
        """The pending and firing alerts, as a heartbeat carries them."""
        return _active(self.current_states())


def engine_for(session) -> AlertEngine:
    """The session's engine, made at first use (its thread starts only
    through :meth:`AlertEngine.start`)."""
    e = getattr(session, "_alert_engine", None)
    if e is None:
        e = AlertEngine(session)
        session._alert_engine = e
    return e


def maybe_start(session) -> Optional[AlertEngine]:
    """Start the engine when ``conf.alerts_enabled`` is set.  Never
    raises: alerting must not break a session's or a server's start."""
    try:
        if not enabled(session.conf):
            return None
        return engine_for(session).start()
    except Exception:  # noqa: BLE001 - telemetry never breaks callers
        return None


def carried_alerts(conf) -> List[Dict[str, Any]]:
    """The active alerts a fleet heartbeat carries, from the persisted
    log (conf only: the publisher thread holds no session).  Empty, and
    no store touched, while the engine is off.  Never raises."""
    try:
        if not enabled(conf):
            return []
        return _active(load_states(conf))
    except Exception:  # noqa: BLE001 - telemetry never breaks publishers
        return []


# -- notification seam --------------------------------------------------------
def _notify(conf, record: Dict[str, Any]) -> None:
    """Run ``conf.alerts_notify_command`` with the transition record as
    JSON on stdin, on a short-lived thread of its own (the evaluation
    never waits on a webhook); for ``firing`` and ``resolved`` only.
    Never raises."""
    command = str(conf.alerts_notify_command or "")
    if not command or record.get("transition") not in ("firing",
                                                       "resolved"):
        return

    def run() -> None:
        import subprocess

        from hyperspace_tpu_torch.telemetry import metrics

        try:
            payload = json.dumps(record, default=str).encode("utf-8")
            env = dict(os.environ)
            env["HYPERSPACE_ALERT"] = str(record.get("alert", ""))
            env["HYPERSPACE_ALERT_STATE"] = str(record.get("state", ""))
            proc = subprocess.Popen(  # noqa: S602 - operator-configured
                command, shell=True, stdin=subprocess.PIPE, env=env)
            proc.communicate(payload, timeout=30.0)
            metrics.inc("alerts.notifications")
        except Exception:  # noqa: BLE001 - a failed webhook never
            metrics.inc("alerts.errors")  # touches the engine

    threading.Thread(target=run, name="hs-alert-notify",
                     daemon=True).start()


# -- tables -------------------------------------------------------------------
_ALERT_COLUMNS = ("process", "alert", "state", "severity", "since",
                  "bundleKey", "detailJson")


def alerts_table(session, fleet: bool = False):
    """One row per alert of this engine: what ``Hyperspace.alerts()``
    and the ``alerts`` verb serve.  ``fleet=True`` adds every fresh
    heartbeat's carried alerts, and ``process`` names where each row
    comes from."""
    import pyarrow as pa

    rows: List[Dict[str, Any]] = []
    for name, st in sorted(engine_for(session).current_states().items()):
        rows.append({"process": "", "alert": name,
                     "state": str(st.get("state", "")),
                     "severity": str(st.get("severity", "")),
                     "since": float(st.get("since", 0.0) or 0.0),
                     "bundleKey": str(st.get("bundle_key") or ""),
                     "detailJson": json.dumps(st.get("detail") or {},
                                              default=str)})
    if fleet:
        from hyperspace_tpu_torch.telemetry import fleet as _fleet

        own = _fleet.process_identity()
        for row in rows:
            row["process"] = own
        for snap in _fleet.fresh_snapshots(session.conf):
            proc = str(snap.get("process", ""))
            if proc == own:
                continue
            for a in snap.get("alerts") or []:
                if not isinstance(a, dict):
                    continue
                rows.append({
                    "process": proc,
                    "alert": str(a.get("alert", "")),
                    "state": str(a.get("state", "")),
                    "severity": str(a.get("severity", "")),
                    "since": float(a.get("since", 0.0) or 0.0),
                    "bundleKey": str(a.get("bundle_key") or ""),
                    "detailJson": json.dumps({}),
                })
    return pa.table({
        c: pa.array([r[c] for r in rows],
                    type=pa.float64() if c == "since" else pa.string())
        for c in _ALERT_COLUMNS})


def history_table(conf):
    """The persisted transition log, oldest first: what
    ``Hyperspace.alert_history()`` returns."""
    import pyarrow as pa

    recs = records(conf)

    def text(field: str):
        return pa.array([str(r.get(field, "")) for r in recs],
                        type=pa.string())

    return pa.table({
        "key": text("key"),
        "ts": pa.array([float(r.get("ts", 0.0) or 0.0) for r in recs],
                       type=pa.float64()),
        "alert": text("alert"),
        "state": text("state"),
        "prevState": text("prev_state"),
        "severity": text("severity"),
        "transition": text("transition"),
        "bundleKey": pa.array([str(r.get("bundle_key") or "")
                               for r in recs], type=pa.string()),
        "recordJson": pa.array([json.dumps(r, default=str)
                                for r in recs], type=pa.string()),
    })


def fleet_alert_check(session):
    """``doctor(fleet=True)``'s ``fleet.alerts``: a FIRING alert of this
    engine or of any fresh heartbeat is a page the engine already
    decided to send, so it grades the cluster crit (severity ``page``)
    or warn."""
    from hyperspace_tpu_torch.telemetry import fleet as _fleet
    from hyperspace_tpu_torch.telemetry.doctor import DoctorCheck

    own = _fleet.process_identity()
    firing: List[Dict[str, Any]] = []
    if enabled(session.conf):
        for a in engine_for(session).active_alerts():
            if a.get("state") == slo.FIRING:
                firing.append({**a, "process": own})
    for snap in _fleet.fresh_snapshots(session.conf):
        proc = str(snap.get("process", ""))
        if proc == own:
            continue
        for a in snap.get("alerts") or []:
            if isinstance(a, dict) and a.get("state") == slo.FIRING:
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
