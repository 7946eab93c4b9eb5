"""``Hyperspace.doctor()`` (counterpart of
hyperspace_tpu/telemetry/doctor.py): one aggregated ok/warn/crit health
report.

The quarantine records, the change detector, the daemon's backoffs, the
perf ledger and the degraded-event counters each answer their own
question; the doctor runs every check, grades each ``ok`` / ``warn`` /
``crit``, and reports the worst as the overall status, also published
as the ``health.status`` gauge (0/1/2).

Checks (none raises: a check that cannot run reports itself ``warn``
with the error, since "the doctor is blind here" is itself a finding):

  ==================  =======================================================
  ``integrity``       per-index quarantine records: any quarantined file is
                      ``crit`` (queries still answer through containment,
                      but data is damaged and a repair is pending); a
                      degraded index listing is ``crit`` too.
  ``staleness``       per-ACTIVE-index change detection: a source that
                      drifted from the recorded files is ``warn``, with
                      the appended/deleted/mutated counts and seconds.
  ``cdc.merge_debt``  an index past its merge-debt budget is ``warn``; one
                      carrying a delete overlay it cannot apply at scan
                      time (no lineage, or hybrid scan off) is ``crit``.
  ``maintenance``     the daemon's failure backoffs in force are ``warn``.
  ``perf``            the perf ledger's latest ``wall_s`` per action name
                      against the median of its predecessors: 25% and
                      0.5 s slower is ``warn``.
  ``serving``         shed ratio and latency-SLO burn over the ``serve.*``
                      metrics of the query servers in this process.
  ``client``          open circuit breakers of a front door
                      (``FleetQueryClient``) in this process are ``warn``.
  ``degraded``        ``degraded.fallbacks`` / ``quarantine.files``
                      nonzero in this process is ``warn``.
  ``device_skew``     max/median of the per-device attributed kernel ms
                      (``exec.device.<id>.kernel_ms``) at or past
                      ``conf.doctor_device_skew_warn`` is ``warn``.
  ==================  =======================================================

``fleet=True`` adds the cluster checks over the published heartbeats
(telemetry/fleet.py: ``fleet.heartbeats``, ``fleet.daemons``,
``fleet.serving``, ``fleet.skew``, ``fleet.build_claims``,
``fleet.alerts``) and grades them apart as ``health.fleet.status``.

Not here: the JAX doctor's ``lint`` check (this package has no lint
baseline) and the CLI's ``--alerts`` gate (the SLO alert engine,
telemetry/alerts.py, is not in this package yet).  The report is cheap: stat-level listings, process
counters and one ledger read.  pyarrow is imported inside ``table``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Dict, List, Optional

SEVERITY = {"ok": 0, "warn": 1, "crit": 2}
_STATUS = {v: k for k, v in SEVERITY.items()}

@dataclasses.dataclass
class DoctorCheck:
    name: str
    status: str            # "ok" | "warn" | "crit"
    summary: str
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "status": self.status,
                "summary": self.summary, "data": dict(self.data)}


class DoctorReport:
    def __init__(self, checks: List[DoctorCheck]) -> None:
        self.ts = time.time()
        self.checks = checks

    @property
    def status(self) -> str:
        worst = max((SEVERITY[c.status] for c in self.checks), default=0)
        return _STATUS[worst]

    def check(self, name: str) -> Optional[DoctorCheck]:
        for c in self.checks:
            if c.name == name:
                return c
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {"ts": self.ts, "status": self.status,
                "checks": [c.to_dict() for c in self.checks]}

    def render(self) -> str:
        lines = [f"Doctor: {self.status.upper()}"]
        for c in self.checks:
            lines.append(f"  [{c.status:<4}] {c.name:<12} {c.summary}")
        return "\n".join(lines)

    def table(self):
        """Arrow shape the interop ``doctor`` verb serves: one row per
        check plus the ``overall`` row."""
        import json

        import pyarrow as pa

        names = ["overall"] + [c.name for c in self.checks]
        statuses = [self.status] + [c.status for c in self.checks]
        summaries = [f"{len(self.checks)} checks"] \
            + [c.summary for c in self.checks]
        data = [json.dumps({})] + [json.dumps(c.data, default=str)
                                   for c in self.checks]
        return pa.table({
            "check": pa.array(names, type=pa.string()),
            "status": pa.array(statuses, type=pa.string()),
            "summary": pa.array(summaries, type=pa.string()),
            "dataJson": pa.array(data, type=pa.string()),
        })


def _guarded(name: str, fn) -> DoctorCheck:
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — a blind check is a finding,
        return DoctorCheck(  # never a crash
            name, "warn", f"check failed: {type(e).__name__}: {e}")


def doctor(session, fleet: bool = False) -> DoctorReport:
    """Run every health check against ``session``'s index tree and this
    process's telemetry; publish ``health.status``.  ``fleet=True`` also
    runs the cluster checks over the published heartbeats
    (telemetry/fleet.py) and publishes their worst grade as the
    ``health.fleet.status`` gauge."""
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.trace import span

    with span("doctor.run") as sp:
        checks = [
            _guarded("integrity", lambda: _check_integrity(session)),
            _guarded("staleness", lambda: _check_staleness(session)),
            _guarded("cdc.merge_debt",
                     lambda: _check_merge_debt(session)),
            _guarded("maintenance", lambda: _check_maintenance(session)),
            _guarded("perf", lambda: _check_perf(session)),
            _guarded("serving", lambda: _check_serving(session)),
            _guarded("client", lambda: _check_client(session)),
            _guarded("degraded", lambda: _check_degraded(session)),
            _guarded("device_skew",
                     lambda: _check_device_skew(session)),
        ]
        # health.status grades this process alone: a fleet-wide crit
        # must neither mask nor fake its own state.
        local = DoctorReport(checks)
        metrics.inc("doctor.runs")
        metrics.set_gauge("health.status", SEVERITY[local.status])
        if fleet:
            from hyperspace_tpu_torch.telemetry import fleet as _fleet

            fleet_part = _fleet.fleet_checks(session)
            worst = max((SEVERITY[c.status] for c in fleet_part),
                        default=0)
            metrics.set_gauge("health.fleet.status", worst)
            checks = checks + fleet_part
        report = DoctorReport(checks)
        sp.set(status=report.status, checks=len(checks))
        return report


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------
def _check_integrity(session) -> DoctorCheck:
    manager = session.index_collection_manager
    entries = manager.get_indexes()
    quarantined: Dict[str, int] = {}
    for entry in entries:
        count = len(manager.quarantine_manager(entry.name).records(
            [f.name for f in entry.content.file_infos()]))
        if count:
            quarantined[entry.name] = count
    if getattr(manager, "last_listing_degraded", False):
        return DoctorCheck(
            "integrity", "crit",
            "index listing degraded: at least one index log is unreadable",
            {"indexes": len(entries)})
    if quarantined:
        total = sum(quarantined.values())
        return DoctorCheck(
            "integrity", "crit",
            f"{total} quarantined file(s) across "
            f"{len(quarantined)} index(es) — queries answer via "
            f"containment; run refresh_index(mode=\"repair\")",
            {"quarantined": quarantined})
    return DoctorCheck("integrity", "ok",
                       f"{len(entries)} index(es), no quarantine records",
                       {"indexes": len(entries)})


def _check_staleness(session) -> DoctorCheck:
    from hyperspace_tpu_torch.index.log_entry import States
    from hyperspace_tpu_torch.lifecycle.change_detector import detect_changes

    manager = session.index_collection_manager
    entries = [e for e in manager.get_indexes()
               if e.state == States.ACTIVE]
    stale: Dict[str, Dict[str, Any]] = {}
    now = time.time()
    for entry in entries:
        try:
            change = detect_changes(session, entry)
        except Exception as e:  # noqa: BLE001 — an unlistable source is
            stale[entry.name] = {"error": str(e)}  # itself staleness risk
            continue
        if change.changed:
            staleness_s = (max(0.0, now - change.newest_change_ms / 1000.0)
                           if change.newest_change_ms > 0 else 0.0)
            stale[entry.name] = {"appended": change.appended,
                                 "deleted": change.deleted,
                                 "mutated": change.mutated,
                                 "staleness_s": round(staleness_s, 1)}
    if stale:
        return DoctorCheck(
            "staleness", "warn",
            f"{len(stale)}/{len(entries)} ACTIVE index(es) behind their "
            f"source — refresh (or enable the lifecycle daemon)",
            {"stale": stale})
    return DoctorCheck("staleness", "ok",
                       f"{len(entries)} ACTIVE index(es) current",
                       {"indexes": len(entries)})


def _check_merge_debt(session) -> DoctorCheck:
    """CDC merge-on-read debt (lifecycle/cdc.py): WARN when an index's
    pending overlay outgrew ``conf.lifecycle_cdc_merge_debt_ratio`` (a
    refresh is overdue), CRIT when an index
    carries a delete overlay it cannot apply at scan time — no lineage
    column, or hybrid scan disabled — because hybrid candidate math
    drops such an entry and every query over it silently falls back to
    a full source scan."""
    from hyperspace_tpu_torch.index.log_entry import States
    from hyperspace_tpu_torch.lifecycle.cdc import merge_debt

    conf = session.conf
    budget = float(getattr(conf, "lifecycle_cdc_merge_debt_ratio", 0.2))
    hybrid_on = bool(getattr(conf, "hybrid_scan_enabled", False))
    entries = [e for e in session.index_collection_manager.get_indexes()
               if e.state == States.ACTIVE]
    unreadable: Dict[str, Dict[str, Any]] = {}
    over: Dict[str, Dict[str, Any]] = {}
    for entry in entries:
        debt = merge_debt(entry)
        if debt.total_bytes == 0:
            continue
        if debt.deleted_files > 0 and (not debt.readable or not hybrid_on):
            unreadable[entry.name] = debt.to_dict()
        elif debt.ratio > budget:
            over[entry.name] = debt.to_dict()
    if unreadable:
        return DoctorCheck(
            "cdc.merge_debt", "crit",
            f"{len(unreadable)} index(es) carry a delete overlay they "
            f"cannot apply at scan time — queries fall back to source; "
            f"run refresh_index(mode=\"incremental\")",
            {"unreadable": unreadable})
    if over:
        return DoctorCheck(
            "cdc.merge_debt", "warn",
            f"{len(over)} index(es) past the merge-debt budget "
            f"({budget:.2f}) — a real refresh is overdue",
            {"over_budget": over, "budget": budget})
    return DoctorCheck(
        "cdc.merge_debt", "ok",
        f"{len(entries)} ACTIVE index(es) within the merge-debt budget",
        {"budget": budget})


def _check_maintenance(session) -> DoctorCheck:
    from hyperspace_tpu_torch.lifecycle.daemon import daemon_for

    backoffs = daemon_for(session).backoff_snapshot()
    if backoffs:
        return DoctorCheck(
            "maintenance", "warn",
            f"{len(backoffs)} index(es) in failure backoff — the daemon "
            f"cannot maintain them right now",
            {"backoffs": backoffs})
    return DoctorCheck("maintenance", "ok", "no failure backoffs", {})


def _check_perf(session, min_history: int = 4,
                threshold_pct: float = 25.0,
                min_abs_s: float = 0.5) -> DoctorCheck:
    """Latest-vs-history trend per recorded action name, judged by the
    bench_compare direction rules (``wall_s`` → lower is better)."""
    from hyperspace_tpu_torch.telemetry import bench_compare, perf_ledger

    direction = bench_compare._direction("wall_s")
    by_name: Dict[str, List[float]] = {}
    for rec in perf_ledger.records(session.conf):
        if rec.get("kind") != "action" or rec.get("outcome") != "ok":
            continue
        try:
            by_name.setdefault(str(rec.get("name", "")), []).append(
                float(rec.get("wall_s", 0.0)))
        except (TypeError, ValueError):
            continue
    regressions: Dict[str, Dict[str, float]] = {}
    for name, walls in by_name.items():
        if len(walls) < min_history:
            continue
        latest = walls[-1]
        baseline = statistics.median(walls[-9:-1])
        if baseline <= 0:
            continue
        worse = latest - baseline if direction == "lower" \
            else baseline - latest
        if worse > min_abs_s and worse / baseline * 100.0 > threshold_pct:
            regressions[name] = {"latest_s": round(latest, 3),
                                 "baseline_s": round(baseline, 3)}
    if regressions:
        return DoctorCheck(
            "perf", "warn",
            f"{len(regressions)} action(s) trending slower than their "
            f"ledger history",
            {"regressions": regressions})
    return DoctorCheck("perf", "ok",
                       f"{len(by_name)} action name(s) in the ledger, "
                       f"no regression trend", {})


def _check_serving(session) -> DoctorCheck:
    from hyperspace_tpu_torch.telemetry import metrics

    conf = session.conf
    snap = metrics.snapshot()
    requests = float(snap.get("serve.requests", 0.0) or 0.0)
    shed = float(snap.get("serve.shed", 0.0) or 0.0)
    if requests <= 0:
        return DoctorCheck("serving", "ok", "no served traffic", {})
    shed_ratio = shed / requests
    warn_ratio = float(getattr(conf, "doctor_shed_warn_ratio", 0.05))
    slo_ms = float(getattr(conf, "doctor_latency_slo_ms", 1000.0))
    burn = _slo_burn(snap.get("serve.latency_ms"), slo_ms)
    data = {"requests": int(requests), "shed_ratio": round(shed_ratio, 4),
            "slo_ms": slo_ms, "slo_burn": round(burn, 4)}
    if (warn_ratio > 0 and shed_ratio >= 5 * warn_ratio) or burn >= 0.5:
        return DoctorCheck(
            "serving", "crit",
            f"overloaded: shed ratio {shed_ratio:.2f}, SLO burn "
            f"{burn:.2f}", data)
    if (warn_ratio > 0 and shed_ratio >= warn_ratio) or burn >= 0.1:
        return DoctorCheck(
            "serving", "warn",
            f"shed ratio {shed_ratio:.2f}, SLO burn {burn:.2f}", data)
    return DoctorCheck(
        "serving", "ok",
        f"{int(requests)} requests, shed ratio {shed_ratio:.2f}, "
        f"SLO burn {burn:.2f}", data)


def _check_client(session) -> DoctorCheck:
    """Front-door health of the fleet clients in this process
    (interop/server.FleetQueryClient, a proxy server's included): open
    circuit breakers mean whole endpoints are routed around, so the
    check warns while ``client.breaker.open_now`` is above 0."""
    from hyperspace_tpu_torch.telemetry import metrics

    snap = metrics.snapshot()
    open_now = int(float(snap.get("client.breaker.open_now", 0.0) or 0.0))
    opens = float(snap.get("client.breaker.open", 0.0) or 0.0)
    hedged = float(snap.get("client.hedge.sent", 0.0) or 0.0)
    wins = float(snap.get("client.hedge.wins", 0.0) or 0.0)
    data = {"breaker_open_now": open_now, "breaker_opens": int(opens),
            "hedges_sent": int(hedged), "hedge_wins": int(wins)}
    if open_now > 0:
        return DoctorCheck(
            "client", "warn",
            f"{open_now} endpoint breaker(s) OPEN — requests are being "
            f"routed around them; check those servers", data)
    if opens > 0 or hedged > 0:
        return DoctorCheck(
            "client", "ok",
            f"breakers closed ({int(opens)} open event(s) so far), "
            f"{int(hedged)} hedge(s) sent / {int(wins)} won", data)
    return DoctorCheck("client", "ok", "no front-door traffic", data)


def _slo_burn(hist_snapshot, slo_ms: float) -> float:
    """Fraction of latency observations ABOVE the SLO, from a histogram
    snapshot's cumulative-by-construction fixed buckets (the first
    bucket bound ≥ the SLO splits under/over conservatively)."""
    if not isinstance(hist_snapshot, dict) or slo_ms <= 0:
        return 0.0
    count = float(hist_snapshot.get("count", 0) or 0)
    buckets = hist_snapshot.get("buckets")
    if count <= 0 or not isinstance(buckets, dict):
        return 0.0
    under = 0.0
    for bound, n in buckets.items():
        b = float("inf") if bound == "+Inf" else float(bound)
        if b <= slo_ms:
            under += float(n)
    return max(0.0, (count - under) / count)


def _check_device_skew(session) -> DoctorCheck:
    """The straggler check of one process: max/median over the
    per-device attributed kernel-ms counters
    (``exec.device.<id>.kernel_ms``), graded against
    ``conf.doctor_device_skew_warn``."""
    from hyperspace_tpu_torch.telemetry import metrics
    from hyperspace_tpu_torch.telemetry.fleet import (
        device_kernel_ms_map,
        skew_ratio,
    )

    warn_at = float(getattr(session.conf, "doctor_device_skew_warn",
                            4.0))
    typed = metrics.registry().typed_snapshot()
    per_device = device_kernel_ms_map(typed["counters"])
    ratio = skew_ratio(list(per_device.values()))
    data = {"per_device_ms": {k: round(v, 1)
                              for k, v in sorted(per_device.items())},
            "ratio": round(ratio, 2)}
    if warn_at > 0 and ratio >= warn_at:
        return DoctorCheck(
            "device_skew", "warn",
            f"per-device kernel-ms skew: max/median {ratio:.1f} >= "
            f"{warn_at:g} — one device is a straggler", data)
    return DoctorCheck(
        "device_skew", "ok",
        f"{len(per_device)} device(s) attributed, no kernel-ms skew",
        data)


def _check_degraded(session) -> DoctorCheck:
    from hyperspace_tpu_torch.telemetry import metrics

    snap = metrics.snapshot()
    fallbacks = float(snap.get("degraded.fallbacks", 0.0) or 0.0)
    contained = float(snap.get("quarantine.files", 0.0) or 0.0)
    if fallbacks or contained:
        return DoctorCheck(
            "degraded", "warn",
            f"{int(fallbacks)} degraded fallback(s), "
            f"{int(contained)} execution-time quarantine(s) this process",
            {"fallbacks": int(fallbacks), "quarantines": int(contained)})
    return DoctorCheck("degraded", "ok",
                       "no degraded events this process", {})


# ---------------------------------------------------------------------------
# Headless CLI: cron and CI gate on health without writing Python
# ---------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    """Grade a system path and exit ok=0 / warn=1 / crit=2::

        python -m hyperspace_tpu_torch.telemetry.doctor --system-path /lake/ix
        python -m hyperspace_tpu_torch.telemetry.doctor --json \\
            --conf hybrid_scan_enabled=true
        python -m hyperspace_tpu_torch.telemetry.doctor --fleet \\
            --system-path /lake/ix

    ``--fleet`` adds the cluster checks over the published heartbeats;
    ``--json`` prints the machine-readable report; ``--conf
    field=value`` sets a ``HyperspaceConf`` field (repeatable; the value
    is parsed as the field's type); ``--device`` picks the session's
    device (default ``cuda``)."""
    import argparse
    import json as _json

    parser = argparse.ArgumentParser(
        prog="doctor",
        description="Aggregated ok/warn/crit health report "
                    "(exit code 0/1/2)")
    parser.add_argument("--system-path", default=None,
                        help="the system path to grade (default: the "
                             "conf default)")
    parser.add_argument("--device", default="cuda",
                        help="the session's device (default: cuda)")
    parser.add_argument("--fleet", action="store_true",
                        help="add the cluster checks over the published "
                             "fleet heartbeats")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the full report as JSON")
    parser.add_argument("--conf", action="append", default=[],
                        metavar="FIELD=VALUE",
                        help="a session conf field (repeatable)")
    args = parser.parse_args(argv)

    from hyperspace_tpu_torch.session import HyperspaceSession

    session = HyperspaceSession(args.system_path, device=args.device)
    for item in args.conf:
        key, sep, value = item.partition("=")
        if not sep or not hasattr(session.conf, key):
            parser.error(f"--conf needs FIELD=VALUE of a conf field, "
                         f"got {item!r}")
        setattr(session.conf, key, _parse_value(
            getattr(session.conf, key), value))
    report = doctor(session, fleet=args.fleet)
    if args.as_json:
        print(_json.dumps(report.to_dict(), default=str, indent=2))
    else:
        print(report.render())
    return SEVERITY[report.status]


def _parse_value(current: Any, text: str) -> Any:
    """``text`` as the type of the field's current value."""
    if isinstance(current, bool):
        return text.strip().lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(text)
    if isinstance(current, float):
        return float(text)
    return text


if __name__ == "__main__":
    raise SystemExit(main())
