"""Top-level user API (counterpart of hyperspace_tpu/hyperspace.py):
``create_index``, ``delete_index``, ``restore_index``, ``vacuum_index``,
``refresh_index``, ``optimize_index``, ``verify_index``, ``cancel``,
``indexes``, ``index``, ``explain``, ``last_build_report`` and the
advisor's verbs ``whatif``, ``captured_workload``,
``clear_captured_workload``, ``recommend_indexes`` and
``apply_recommendations``, and the lifecycle's ``maintenance_cycle``,
``start_maintenance``, ``stop_maintenance`` and ``lifecycle_history``,
telemetry's ``metrics``, ``metrics_text``, ``reset_metrics``,
``perf_history`` and ``export_timeline``, and the diagnostics'
``doctor``, ``slow_queries``, ``trace``, ``diagnostics``,
``dump_diagnostics`` and ``diagnostics_bundles``, the fleet plane's
``fleet_status``, ``fleet_metrics``, ``start_fleet_telemetry`` and
``stop_fleet_telemetry``, and the SLO alert engine's ``alerts``,
``alert_history``, ``start_alerting`` and ``stop_alerting``."""

from __future__ import annotations

from typing import Union

from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.index.index_config import (
    DataSkippingIndexConfig,
    IndexConfig,
)
from hyperspace_tpu_torch.index.statistics import index_statistics_table
from hyperspace_tpu_torch.session import HyperspaceSession


class Hyperspace:
    def __init__(self, session: HyperspaceSession) -> None:
        self.session = session
        self.index_manager = session.index_collection_manager

    def create_index(self, dataset: Dataset,
                     config: Union[IndexConfig, DataSkippingIndexConfig]) -> None:
        self.index_manager.create(dataset, config)

    def delete_index(self, name: str) -> None:
        self.index_manager.delete(name)

    def restore_index(self, name: str) -> None:
        self.index_manager.restore(name)

    def vacuum_index(self, name: str) -> None:
        self.index_manager.vacuum(name)

    def refresh_index(self, name: str, mode: str = "full"):
        """Bring ``name`` up to date with its source: ``mode`` "full"
        rebuilds, "incremental" indexes only the appended and deleted
        files, "quick" records them for hybrid scan, and "repair"
        rebuilds only the buckets whose files are quarantined, from the
        recorded source snapshot, then clears their records.  Returns a
        ``RefreshSummary`` (outcome "noop" when the source is unchanged,
        or when nothing is quarantined)."""
        return self.index_manager.refresh(name, mode)

    def verify_index(self, name: str, mode: str = "quick"):
        """Scrub ``name``'s index data files against its log entry and
        return the per-file report, an arrow table (file, status,
        detail, quarantined).  "quick" checks existence, size and mtime;
        "full" also reads every file again and hashes it against the
        digest recorded when it was written.  Damaged files are
        quarantined: later queries keep the index and read only the
        damaged buckets from the source, and
        ``refresh_index(name, mode="repair")`` rebuilds them."""
        return self.index_manager.verify(name, mode)

    def optimize_index(self, name: str, mode: str = "quick"):
        """Merge each bucket's small index files into one sorted run, cut
        at ``conf.index_max_rows_per_file`` ("quick": only files under
        ``conf.optimize_file_size_threshold``; "full": every file).
        Returns an ``OptimizeSummary`` (outcome "noop" when no bucket
        held files to merge)."""
        return self.index_manager.optimize(name, mode)

    def cancel(self, name: str) -> None:
        self.index_manager.cancel(name)

    def indexes(self):
        """The summary of every index, a pyarrow Table with one row per
        index (``index.statistics.INDEX_SUMMARY_COLUMNS``)."""
        return self.index_manager.indexes()

    def index(self, name: str):
        """The extended statistics of ``name``, a pyarrow Table of one row
        (``index.statistics.EXTENDED_COLUMNS``), or of none when there is
        no such index."""
        entry = self.index_manager.get_index(name)
        return index_statistics_table([entry] if entry else [], extended=True,
                                      index_path=self.index_manager.index_path)

    def explain(self, dataset: Dataset, verbose: bool = False) -> str:
        """The plans of ``dataset`` with and without the indexes, side by
        side, the differences highlighted, and the indexes used; verbose
        adds the physical operators, each scan's IO, the optimizer's
        decisions and the session's last run report."""
        from hyperspace_tpu_torch.plananalysis.explain import explain_string

        return explain_string(dataset, self.session, verbose=verbose)

    def whatif(self, dataset: Dataset, candidates):
        """Plan ``dataset`` as if ``candidates`` (``IndexConfig``s or
        hypothetical entries) were built: the real optimizer's two plans
        and the estimated bytes each scans, with nothing executed and no
        file written.  Returns a ``WhatIfReport``."""
        from hyperspace_tpu_torch.advisor.hypothetical import whatif

        return whatif(self.session, dataset, candidates)

    def captured_workload(self):
        """The captured workload (``conf.advisor_capture_enabled``), a
        pyarrow Table with one row per query shape: its hits, its filter,
        join, group and projected columns, and the bytes it scanned."""
        from hyperspace_tpu_torch.advisor.workload import workload_table

        return workload_table(self.session.conf)

    def clear_captured_workload(self) -> None:
        from hyperspace_tpu_torch.advisor.workload import clear

        clear(self.session.conf)

    def recommend_indexes(self, top_k: int = 5):
        """Candidate covering indexes for the captured workload, best
        first, a pyarrow Table: ``candidate``, ``relation``,
        ``indexedColumns``, ``includedColumns``, ``supportingQueries``,
        ``supportingHits``, ``estBenefitBytes``, ``estBuildCostBytes``,
        ``score`` (advisor/candidates.py's model)."""
        from hyperspace_tpu_torch.advisor.recommend import recommend_indexes

        return recommend_indexes(self.session, top_k)

    def apply_recommendations(self, top_k: int = 1) -> list:
        """Build the top ``top_k`` recommendations through the normal
        ``create_index`` path; returns the names built.  A candidate an
        ACTIVE index already covers is skipped."""
        from hyperspace_tpu_torch.advisor.recommend import (
            apply_recommendations,
        )

        return apply_recommendations(self.session, top_k)

    def maintenance_cycle(self) -> list:
        """Run one maintenance cycle now (lifecycle/daemon.py): detect,
        decide, act, journal.  Returns the journal records it wrote, one
        per decision, "did nothing" ones included."""
        from hyperspace_tpu_torch.lifecycle.daemon import daemon_for

        return daemon_for(self.session).run_once()

    def start_maintenance(self):
        """Start the opt-in maintenance daemon thread
        (``conf.lifecycle_enabled`` must be true); returns the
        ``MaintenanceDaemon``."""
        from hyperspace_tpu_torch.lifecycle.daemon import daemon_for

        return daemon_for(self.session).start()

    def stop_maintenance(self) -> None:
        """Stop the daemon thread (idempotent); raises the error that
        stopped it, if one did."""
        from hyperspace_tpu_torch.lifecycle.daemon import daemon_for

        daemon_for(self.session).stop()

    def lifecycle_history(self):
        """The decision journal as a pyarrow table, oldest first
        (lifecycle/journal.py has the columns), read from
        ``<systemPath>/_hyperspace_lifecycle``."""
        from hyperspace_tpu_torch.lifecycle.journal import history_table

        return history_table(self.session.conf)

    def last_build_report(self):
        """The ``BuildReport`` (telemetry/build_report.py) of the last
        action run through this session, or else of the last one in the
        process: its phase seconds, device and host split, bytes and
        memory; None before the first action."""
        report = self.session.last_build_report_value
        if report is not None:
            return report
        from hyperspace_tpu_torch.telemetry.build_report import last_report

        return last_report()

    # -- telemetry (docs/16-observability.md) --------------------------------
    def perf_history(self, index: str = None, section: str = None,
                     limit: int = None):
        """The perf ledger (telemetry/perf_ledger.py) as a pyarrow table,
        one row per recorded run under ``<systemPath>/_hyperspace_perf``,
        oldest first: key, kind, name, ts, wallSeconds, outcome,
        phasesJson, bytesWritten, spillBytes, recordJson.  ``index``
        keeps that index's action records, ``section`` that bench
        section's records, ``limit`` the most recent N."""
        from hyperspace_tpu_torch.telemetry.perf_ledger import history_table

        return history_table(self.session.conf, index=index,
                             section=section, limit=limit)

    def export_timeline(self, path: str, trace_id: str = None,
                        ledger_key: str = None) -> str:
        """Write a Perfetto/Chrome trace-event JSON file to ``path``.

        By default: the live timeline ring (build-phase, executor and
        ``device:<index>`` kernel lanes and the memory counter track;
        ``conf.timeline_enabled`` must have been on) and the span tree of
        this thread's last query when tracing was on.  ``ledger_key``
        rebuilds the phases of that perf-ledger record instead, and
        ``trace_id`` the span tree of that retained flight-recorder
        record (telemetry/flight_recorder.py); both work after the
        fact, without the ring."""
        from hyperspace_tpu_torch.telemetry import timeline

        if trace_id is not None:
            from hyperspace_tpu_torch.telemetry import flight_recorder

            rec = flight_recorder.recorder().find(trace_id.lower())
            if rec is None:
                raise ValueError(
                    f"no retained flight record for trace id {trace_id!r}")
            timeline.export_chrome_trace(
                path, intervals=(), memory_samples=(),
                span_roots=[rec["spans"]] if rec.get("spans") else ())
            return path
        if ledger_key is not None:
            import json

            from hyperspace_tpu_torch.telemetry import perf_ledger
            from hyperspace_tpu_torch.telemetry.trace import span

            for rec in perf_ledger.records(self.session.conf):
                if rec.get("key") == ledger_key:
                    events = timeline.ledger_to_trace_events(rec)
                    with span("timeline.export", path=path) as sp:
                        with open(path, "w", encoding="utf-8") as f:
                            json.dump({"traceEvents": events,
                                       "displayTimeUnit": "ms"}, f)
                        sp.set(events=len(events))
                    return path
            raise ValueError(f"no perf-ledger record {ledger_key!r}")
        roots = []
        rep = self.session.last_run_report_value
        if rep is not None and rep.root_span is not None:
            roots.append(rep.root_span)
        timeline.export_chrome_trace(path, span_roots=roots)
        return path

    def metrics(self) -> dict:
        """A snapshot of the process-wide metrics registry
        (telemetry/metrics.py): counters such as ``io.retry.attempts``,
        ``log.cas.conflicts``, ``rule.filter.applied``,
        ``degraded.fallbacks``, ``exec.device.0.kernel_ms``, histograms
        such as ``exec.kernel.route_partition.device_ms``, and derived
        ratios such as ``cache.device.hit_ratio``."""
        from hyperspace_tpu_torch.telemetry import metrics as m

        return m.snapshot()

    def metrics_text(self) -> str:
        """The same registry as a Prometheus text exposition."""
        from hyperspace_tpu_torch.telemetry import metrics as m

        return m.registry().render_prometheus()

    def reset_metrics(self) -> None:
        """Zero every series."""
        from hyperspace_tpu_torch.telemetry import metrics as m

        m.reset()

    # -- diagnostics (telemetry/doctor.py, telemetry/flight_recorder.py) -----
    def doctor(self, fleet: bool = False):
        """One health report over what this process knows
        (telemetry/doctor.py): quarantine records, per-index staleness,
        merge debt, the daemon's backoffs, the perf-ledger trend, the
        degraded events and the per-device kernel-ms skew, graded
        ok/warn/crit, the worst check winning, and published as the
        ``health.status`` gauge.  ``fleet=True`` adds the cluster checks
        over the published heartbeats (telemetry/fleet.py): a stale
        heartbeat (a dead or hung process) is crit, so is a lease or
        build-claim holder without one; more than one daemon without a
        lease warns; the merged shed ratio, SLO burn and kernel-ms skew
        grade the fleet.  Their worst grade is published as
        ``health.fleet.status``."""
        from hyperspace_tpu_torch.telemetry.doctor import doctor

        return doctor(self.session, fleet=fleet)

    def slow_queries(self, fleet: bool = False):
        """The flight recorder's retained ring as a pyarrow table, oldest
        first: slow (>= ``conf.flight_recorder_slow_ms``), error and
        deadline queries always, healthy ones sampled 1-in-N.  Columns:
        ts, traceId, requestId, kind, outcome, latencyMs, queueWaitMs,
        deviceMs, slow, reason, error, recordJson (the whole record).
        ``fleet=True`` federates (telemetry/fleet.py): this process's
        ring, every heartbeat's interesting tail and the persisted
        diagnostics bundles, deduplicated, with a ``process`` column
        naming where each request ran."""
        if fleet:
            from hyperspace_tpu_torch.telemetry.fleet import (
                fleet_slow_queries_table,
            )

            return fleet_slow_queries_table(self.session.conf)
        from hyperspace_tpu_torch.telemetry.flight_recorder import (
            slow_queries_table,
        )

        return slow_queries_table(self.session.conf)

    def trace(self, trace_id: str, fleet: bool = False):
        """The retained flight record (a dict) of ``trace_id``, or None.
        ``fleet=True`` also looks in every heartbeat's interesting tail
        and then the persisted bundles, so a query another process served
        is found here by its echoed id; the record's ``process`` names
        where it ran."""
        if fleet:
            from hyperspace_tpu_torch.telemetry.fleet import find_trace

            return find_trace(self.session.conf, trace_id)
        from hyperspace_tpu_torch.telemetry import flight_recorder

        return flight_recorder.recorder().find(trace_id.lower())

    def diagnostics(self) -> dict:
        """The live diagnostics bundle: the flight recorder's ring, a
        metrics snapshot and the perf ledger's tail, what
        :meth:`dump_diagnostics` writes."""
        from hyperspace_tpu_torch.telemetry.flight_recorder import (
            diagnostics_bundle,
        )

        return diagnostics_bundle(self.session.conf)

    def dump_diagnostics(self):
        """Write :meth:`diagnostics` as one bundle under
        ``<systemPath>/_hyperspace_diagnostics`` (at most
        ``conf.flight_recorder_max_bundles`` kept); returns its key, or
        None when the recorder is off or the write failed."""
        from hyperspace_tpu_torch.telemetry.flight_recorder import (
            dump_diagnostics,
        )

        return dump_diagnostics(self.session.conf)

    def diagnostics_bundles(self) -> list:
        """Every written diagnostics bundle, oldest first, each with its
        ``key``: what a restarted process reads back."""
        from hyperspace_tpu_torch.telemetry.flight_recorder import bundles

        return bundles(self.session.conf)

    # -- the fleet plane (telemetry/fleet.py) -----------------------------
    def fleet_status(self):
        """Every published heartbeat as a pyarrow table: process, host,
        pid, role, address, status (its last health grade), ageSeconds,
        fresh, draining, records, snapshotJson; what the ``fleet_status``
        verb serves."""
        from hyperspace_tpu_torch.telemetry.fleet import fleet_status_table

        return fleet_status_table(self.session.conf)

    def fleet_metrics(self) -> dict:
        """The metrics merged over every fresh heartbeat and this
        process's live registry: counters summed, gauges per process
        (``name -> {process: value}``), fixed-bucket histograms summed
        bucket by bucket with their exemplars.  Keys: ``processes``,
        ``counters``, ``gauges``, ``histograms``."""
        from hyperspace_tpu_torch.telemetry.fleet import fleet_metrics

        return fleet_metrics(self.session.conf)

    def start_fleet_telemetry(self):
        """Start this session's heartbeat thread
        (``conf.fleet_telemetry_enabled`` must be set; it publishes every
        ``conf.fleet_publish_interval_s``).  Sessions, ``QueryServer`` and
        the lifecycle daemon start it when the conf is on at their start;
        this is the handle for a conf set later.  Returns the
        :class:`~hyperspace_tpu_torch.telemetry.fleet.FleetPublisher`."""
        from hyperspace_tpu_torch.telemetry.fleet import publisher_for

        return publisher_for(self.session).start()

    def stop_fleet_telemetry(self) -> None:
        """Stop the heartbeat thread and delete this process's heartbeat
        (idempotent)."""
        from hyperspace_tpu_torch.telemetry.fleet import publisher_for

        publisher_for(self.session).stop()

    # -- SLO alerting (telemetry/alerts.py) -------------------------------
    def alerts(self, fleet: bool = False):
        """The SLO alert states as a pyarrow table, one row per objective
        (availability, latency, staleness, build_claims): process, alert,
        state (pending/firing/resolved), severity, since, bundleKey (the
        incident bundle captured at the page) and detailJson; what the
        ``alerts`` verb serves.  ``fleet=True`` adds every fresh
        heartbeat's carried alerts, and ``process`` names each row's."""
        from hyperspace_tpu_torch.telemetry.alerts import alerts_table

        return alerts_table(self.session, fleet=fleet)

    def alert_history(self):
        """The persisted transition log under
        ``<systemPath>/_hyperspace_alerts`` as a pyarrow table, oldest
        first: every change of state the engine recorded, on either store
        class and across restarts."""
        from hyperspace_tpu_torch.telemetry.alerts import history_table

        return history_table(self.session.conf)

    def start_alerting(self):
        """Start the SLO evaluator thread (``conf.alerts_enabled`` must be
        set; it ticks every ``conf.alerts_interval_s``, or with the fleet
        heartbeat when that is 0).  Returns the
        :class:`~hyperspace_tpu_torch.telemetry.alerts.AlertEngine`."""
        from hyperspace_tpu_torch.telemetry.alerts import engine_for

        return engine_for(self.session).start()

    def stop_alerting(self) -> None:
        """Stop the evaluator thread (idempotent; the persisted states
        remain for the next engine)."""
        from hyperspace_tpu_torch.telemetry.alerts import engine_for

        engine_for(self.session).stop()

