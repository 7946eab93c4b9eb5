"""The maintenance daemon (counterpart of
hyperspace_tpu/lifecycle/daemon.py): detect, decide, act, journal, repeat.

Opt-in (``conf.lifecycle_enabled``): one background thread per session
runs one cycle every ``conf.lifecycle_interval_s`` seconds, or sooner
when the source watch (io/watch.py, ``conf.watch_enabled``) sees a
change; ``Hyperspace.maintenance_cycle()`` runs the same
``MaintenanceDaemon.run_once`` one step at a time.  A cycle:

  1. sheds, journaling one ``skipped`` decision, while the process
     drains (``notify_drain``) or its resident set is past
     ``conf.serving_shed_rss_watermark_mb``; with the lease on
     (lifecycle/lease.py), stands by while another process holds it;
  2. for every ACTIVE index: detection (lifecycle/change_detector.py),
     the quarantine count, the policy (lifecycle/policy.py) and, when
     the refresh ladder leaves the index idle, the compaction rung
     (lifecycle/cdc.py); each decision runs through the collection
     manager (``refresh``, ``optimize``, ``delete``, ``create``), so
     every refresh, repair, rebuild and advisor build launches the
     build's kernels on the session's device as a call by hand would;
  3. with ``conf.lifecycle_byte_budget`` set, the advisor pass: drop
     cold indexes while over the budget, build recommended ones that fit;
  4. journals every decision (lifecycle/journal.py), "did nothing"
     included.

An index-side failure (``execution.containment.is_index_side_error``: a
read or log error, a ``HyperspaceError``) of an action or of the source
listing is journaled ``error`` and backs its index off exponentially
(``conf.lifecycle_backoff_initial_s`` doubling up to ``_max_s``), as in
the JAX package.  Any other error, a CUDA error, ``torch.OutOfMemoryError``
or the kernel loader's ``KernelError`` among them, is journaled
``error`` and then raised: ``run_once`` (and so ``maintenance_cycle``)
fails with it, the thread stops on it and ``stop`` raises it.  A daemon
that backed off from a broken card would hide it.

The thread is given no device: the kernels take theirs from the tensors
the build hands them and launch on that device's current stream, the
thread's default stream.

Each cycle is a ``lifecycle.cycle`` span and each executed decision a
``lifecycle.action`` span under it, with the ``lifecycle.*`` counters
and the ``lifecycle.staleness_s`` gauge (docs/16-observability.md).  A
refresh the daemon dispatches goes through the manager's transaction
loop, so one that races a refresh run by hand rebases and ends in
"done" or a journaled "noop" instead of a backoff.  Each executed
decision is also offered to the flight recorder as a ``maintenance``
record (telemetry/flight_recorder.py).  A started daemon publishes the
role ``daemon`` in its fleet heartbeat (telemetry/fleet.py).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.execution.containment import is_index_side_error
from hyperspace_tpu_torch.lifecycle import journal, lease as _lease, policy
from hyperspace_tpu_torch.lifecycle.change_detector import detect_changes
from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry.trace import span

# Process-wide drain latch: a draining server parks the daemon too.
_drain = threading.Event()


def notify_drain() -> None:
    _drain.set()


def clear_drain() -> None:
    """Re-arm after a drain."""
    _drain.clear()


def draining() -> bool:
    return _drain.is_set()


def _current_rss_mb() -> float:
    """The current resident set in MB (Linux /proc; else the POSIX peak,
    which can only over-shed)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / float(1 << 20)
    except Exception:  # noqa: BLE001 - not Linux
        try:
            import resource

            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024.0
        except Exception:  # noqa: BLE001
            return 0.0


def daemon_for(session) -> "MaintenanceDaemon":
    """The session's daemon, made on first use (its thread starts only
    through ``MaintenanceDaemon.start``)."""
    d = getattr(session, "_lifecycle_daemon", None)
    if d is None:
        d = MaintenanceDaemon(session)
        session._lifecycle_daemon = d
    return d


class MaintenanceDaemon:
    def __init__(self, session) -> None:
        self.session = session
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cycle = 0
        # Set by the source watcher: ends the sleep between cycles.
        self._wake = threading.Event()
        self._watcher = None
        # index name -> (consecutive failures, monotonic not-before)
        self._backoff: Dict[str, Tuple[int, float]] = {}
        # candidate name -> advisor Candidate, for the CREATE decisions
        # ranked earlier in the same cycle.
        self._pending_candidates: Dict[str, object] = {}
        self._lease: Optional[_lease.MaintenanceLease] = None
        # The error that stopped the thread, raised by stop().
        self._error: Optional[BaseException] = None

    # -- the daemon thread ---------------------------------------------------
    def start(self) -> "MaintenanceDaemon":
        if not self.session.conf.lifecycle_enabled:
            raise HyperspaceError(
                "The maintenance daemon is opt-in: set "
                "conf.lifecycle_enabled = True (or drive cycles "
                "yourself via Hyperspace.maintenance_cycle())")
        if self._thread is not None and self._thread.is_alive():
            return self
        # A maintainer publishes the role "daemon" in its fleet heartbeat
        # (telemetry/fleet.py): the fleet doctor warns when more than one
        # runs over a tree without a lease.  maybe_start never raises.
        from hyperspace_tpu_torch.telemetry import fleet

        fleet.set_process_role("daemon")
        fleet.maybe_start(self.session)
        self._stop.clear()
        self._error = None
        self._thread = threading.Thread(
            target=self._run, name="hs-lifecycle-daemon", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        """Stop the thread and release the lease; raises the error that
        stopped the thread, if one did."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None
        if self._lease is not None:
            self._lease.release()
        error, self._error = self._error, None
        if error is not None:
            raise error

    def watcher(self):
        """The running ``SourceWatcher``, or None."""
        return self._watcher

    def lease(self) -> Optional[_lease.MaintenanceLease]:
        """This daemon's lease handle, or None before the first
        lease-enabled cycle."""
        return self._lease

    def backoff_snapshot(self) -> Dict[str, dict]:
        """Indexes in failure backoff: name -> {failures, retry_in_s};
        entries whose window has passed are left out."""
        now = time.monotonic()
        return {name: {"failures": failures,
                       "retry_in_s": round(not_before - now, 1)}
                for name, (failures, not_before) in self._backoff.items()
                if not_before > now}

    def _run(self) -> None:
        self._watcher = self._maybe_watch()
        try:
            while not self._stop.is_set():
                # Armed before the cycle: an event during it still
                # shortens the next sleep.
                self._wake.clear()
                try:
                    self.run_once()
                except Exception as e:  # noqa: BLE001 - narrowed below
                    if not is_index_side_error(e):
                        self._error = e
                        return
                    metrics.inc("lifecycle.actions.errors")
                self._wake.wait(float(self.session.conf.lifecycle_interval_s))
        finally:
            if self._watcher is not None:
                self._watcher.stop()
                self._watcher = None

    def _maybe_watch(self):
        """With ``conf.watch_enabled``, a started ``SourceWatcher`` over
        every ACTIVE index's source roots; None when off or it cannot
        start (the interval still bounds staleness)."""
        conf = self.session.conf
        if not conf.watch_enabled:
            return None
        try:
            from hyperspace_tpu_torch.index.log_entry import States
            from hyperspace_tpu_torch.io.watch import SourceWatcher

            roots = []
            for entry in self.session.index_collection_manager \
                    .get_indexes([States.ACTIVE]):
                for rel in entry.relations:
                    roots.extend(rel.root_paths)
            return SourceWatcher(conf, sorted(set(roots)),
                                 wake=self._wake).start()
        except Exception:  # noqa: BLE001 - push detection is advisory
            metrics.inc("lifecycle.watch.errors")
            return None

    # -- one cycle (Hyperspace.maintenance_cycle) ----------------------------
    def run_once(self) -> List[dict]:
        """One maintenance cycle; returns the journal records it wrote."""
        self._cycle += 1
        out: List[dict] = []
        with span("lifecycle.cycle", cycle=self._cycle) as sp:
            metrics.inc("lifecycle.cycles")
            self._cycle_body(out, sp)
        return out

    def _cycle_body(self, out: List[dict], sp) -> None:
        from hyperspace_tpu_torch.index.log_entry import States

        conf = self.session.conf
        shed = self._shed_reason(conf)
        if shed is not None:
            metrics.inc("lifecycle.skipped")
            out.append(self._journal(
                policy.MaintenanceDecision(policy.KIND_NONE, reason=shed),
                outcome="skipped"))
            sp.set(skipped=shed)
            return
        if _lease.enabled(conf):
            if self._lease is None:
                self._lease = _lease.MaintenanceLease(conf)
            if not self._lease.ensure():
                # Another daemon holds the lease over this system path.
                metrics.inc("lifecycle.skipped")
                holder = (_lease.status(conf) or {}).get("holder", "?")
                out.append(self._journal(
                    policy.MaintenanceDecision(
                        policy.KIND_NONE,
                        reason=f"lease standby: held by {holder}"),
                    outcome="skipped"))
                sp.set(skipped="lease standby")
                return
        try:
            entries = self.session.index_collection_manager \
                .get_indexes([States.ACTIVE])
        except Exception as e:  # noqa: BLE001 - a listing failure is
            # journaled; anything else also propagates
            out.append(self._journal(
                policy.MaintenanceDecision(
                    policy.KIND_NONE, reason=f"index listing failed: {e}"),
                outcome="error", error=str(e)))
            if not is_index_side_error(e):
                raise
            return
        for entry in entries:
            out.append(self._maintain_index(entry))
        out.extend(self._advisor_pass(entries))
        sp.set(decisions=len(out))

    def _shed_reason(self, conf) -> Optional[str]:
        if draining():
            return "server draining: maintenance parked"
        rss_mark = float(conf.serving_shed_rss_watermark_mb)
        if rss_mark > 0:
            rss = _current_rss_mb()
            if rss > rss_mark:
                return (f"memory watermark: rss {rss:.0f} MB > "
                        f"{rss_mark:.0f} MB")
        return None

    # -- per-index maintenance ----------------------------------------------
    def _maintain_index(self, entry) -> dict:
        conf = self.session.conf
        name = entry.name
        failures, not_before = self._backoff.get(name, (0, 0.0))
        if time.monotonic() < not_before:
            metrics.inc("lifecycle.backoff.skips")
            return self._journal(
                policy.MaintenanceDecision(
                    policy.KIND_NONE, name,
                    reason=f"backing off after {failures} failure(s); "
                           f"{not_before - time.monotonic():.1f}s left"),
                outcome="skipped")
        try:
            change = detect_changes(self.session, entry)
            quarantined = len(self.session.index_collection_manager
                              .quarantine_manager(name).records(
                                  [f.name for f in entry.content.file_infos()]))
        except Exception as e:  # noqa: BLE001 - a source that cannot be
            # listed backs off like a failed action
            rec = self._journal(
                policy.MaintenanceDecision(
                    policy.KIND_NONE, name,
                    reason="change detection failed"),
                outcome="error", error=str(e))
            if not is_index_side_error(e):
                raise
            self._note_failure(name, failures)
            metrics.inc("lifecycle.actions.errors")
            return rec
        decision = policy.decide_refresh(
            change,
            quarantined=quarantined,
            lineage=entry.has_lineage_column(),
            hybrid_scan=bool(conf.hybrid_scan_enabled),
            quick_append_ratio=float(conf.lifecycle_quick_append_ratio),
            full_churn_ratio=float(conf.lifecycle_full_churn_ratio),
            cdc_merge_on_read=bool(conf.lifecycle_cdc_enabled),
            merge_debt_ratio=float(conf.lifecycle_cdc_merge_debt_ratio))
        if decision.kind == policy.KIND_NONE:
            self._backoff.pop(name, None)
            compaction = self._decide_compaction(entry)
            if compaction is not None:
                return self._execute(compaction, change=change)
            return self._journal(decision, outcome="noop", change=change)
        if change.newest_change_ms > 0:
            metrics.set_gauge(
                "lifecycle.staleness_s",
                max(0.0, time.time() - change.newest_change_ms / 1000.0))
        return self._execute(decision, change=change)

    def _decide_compaction(self, entry):
        """The compaction rung, consulted only when the refresh ladder
        left the index idle."""
        conf = self.session.conf
        if not conf.lifecycle_compaction_enabled:
            return None
        from hyperspace_tpu_torch.lifecycle import cdc

        stats = cdc.compaction_stats(
            entry, int(conf.optimize_file_size_threshold))
        return cdc.decide_compaction(
            stats,
            min_small_files=int(conf.lifecycle_compaction_min_small_files),
            mode=str(conf.lifecycle_compaction_mode))

    def _execute(self, decision: policy.MaintenanceDecision,
                 change=None) -> dict:
        """Run one decision through the collection manager and journal
        its outcome.  An index-side failure backs off; any other is
        journaled, then raised."""
        name = decision.index
        failures, _ = self._backoff.get(name, (0, 0.0))
        t0 = time.perf_counter()
        manager = self.session.index_collection_manager
        outcome, error, raised = "done", "", None
        try:
            with span("lifecycle.action", index=name, kind=decision.kind,
                      mode=decision.mode):
                metrics.inc("lifecycle.actions")
                if decision.kind in (policy.KIND_REFRESH,
                                     policy.KIND_REPAIR):
                    summary = manager.refresh(name, decision.mode)
                    if summary is not None and summary.outcome == "noop":
                        outcome = "noop"
                elif decision.kind == policy.KIND_OPTIMIZE:
                    summary = manager.optimize(name,
                                               decision.mode or "quick")
                    if summary is not None and summary.outcome == "noop":
                        outcome = "noop"
                elif decision.kind == policy.KIND_DELETE:
                    manager.delete(name)
                elif decision.kind == policy.KIND_CREATE:
                    self._build_candidate(decision)
                else:
                    raise HyperspaceError(
                        f"Unknown decision kind {decision.kind!r}")
            self._backoff.pop(name, None)
        except NoChangesError:
            # A racing writer did the work between detection and dispatch.
            outcome = "noop"
            self._backoff.pop(name, None)
        except Exception as e:  # noqa: BLE001 - narrowed below
            outcome, error = "error", str(e)
            metrics.inc("lifecycle.actions.errors")
            if is_index_side_error(e):
                self._note_failure(name, failures)
            else:
                raised = e
        wall_s = time.perf_counter() - t0
        self._record_flight(decision, outcome, error, wall_s)
        rec = self._journal(decision, outcome=outcome, error=error,
                            wall_s=wall_s, change=change)
        if raised is not None:
            raise raised
        return rec

    def _record_flight(self, decision: policy.MaintenanceDecision,
                       outcome: str, error: str, wall_s: float) -> None:
        """A daemon action lands in the flight recorder beside the
        queries (kind ``maintenance``); never raises."""
        from hyperspace_tpu_torch.interop.query import mint_trace_id
        from hyperspace_tpu_torch.telemetry import flight_recorder

        flight_recorder.record(
            self.session.conf, kind="maintenance",
            outcome="OK" if outcome in ("done", "noop") else "FAILED",
            latency_ms=wall_s * 1000.0,
            trace_id=mint_trace_id(), request_id=mint_trace_id(),
            error=error or f"{decision.kind} {decision.index} "
                           f"{decision.mode}".strip())

    def _note_failure(self, name: str, prior_failures: int) -> None:
        conf = self.session.conf
        failures = prior_failures + 1
        initial = float(conf.lifecycle_backoff_initial_s)
        cap = float(conf.lifecycle_backoff_max_s)
        delay = min(cap, initial * (2.0 ** (failures - 1)))
        self._backoff[name] = (failures, time.monotonic() + delay)

    # -- the advisor pass ----------------------------------------------------
    def _advisor_pass(self, entries) -> List[dict]:
        """Under the byte budget: gather the inputs, let the policy
        rank, execute the creates and deletes."""
        budget = int(self.session.conf.lifecycle_byte_budget)
        if budget <= 0:
            return []
        try:
            inputs, cand_by_name = self._advisor_inputs(entries, budget)
        except Exception as e:  # noqa: BLE001 - narrowed below
            rec = self._journal(
                policy.MaintenanceDecision(
                    policy.KIND_NONE, reason="advisor pass failed"),
                outcome="error", error=str(e))
            if not is_index_side_error(e):
                raise
            return [rec]
        decisions = policy.decide_advisor(inputs)
        if not decisions:
            return [self._journal(
                policy.MaintenanceDecision(
                    policy.KIND_NONE,
                    reason=f"advisor: within the {budget}-byte budget, "
                           f"no affordable candidates"),
                outcome="noop")]
        self._pending_candidates = cand_by_name
        return [self._execute(d) for d in decisions]

    def _advisor_inputs(self, entries, budget: int):
        from hyperspace_tpu_torch.advisor import recommend
        from hyperspace_tpu_torch.advisor import workload as _workload

        _workload.flush_pending(self.session.conf)
        recs = _workload.records(self.session.conf)
        index_bytes = {
            e.name: sum(f.size for f in e.content.file_infos())
            for e in entries}
        # Cold: no captured fingerprint touches any of the index's
        # indexed columns over its roots.  With no captured workload at
        # all nothing is cold: an empty capture never justifies a drop.
        cold: List[str] = []
        if recs:
            hot = set()
            for rec in recs:
                for t in rec.get("tables", []):
                    roots = tuple(sorted(t.get("roots", [])))
                    for c in (list(t.get("eq", []))
                              + list(t.get("range", []))
                              + list(t.get("join", []))):
                        hot.add((roots, c.lower()))
            for e in entries:
                if not e.is_covering:
                    continue
                roots = tuple(sorted(
                    r for rel in e.relations for r in rel.root_paths))
                if not any((roots, c.lower()) in hot
                           for c in e.indexed_columns):
                    cold.append(e.name)
        cands = [c for c in recommend.scored_candidates(self.session)
                 if c.score > 0
                 and not recommend._already_covered(self.session, c)]
        inputs = policy.AdvisorInputs(
            byte_budget=budget,
            index_bytes=index_bytes,
            cold_indexes=cold,
            candidates=[(c.name, c.est_build_cost_bytes) for c in cands])
        return inputs, {c.name: c for c in cands}

    def _build_candidate(self, decision: policy.MaintenanceDecision) -> None:
        from hyperspace_tpu_torch.advisor.recommend import _unique_name
        from hyperspace_tpu_torch.dataset import Dataset
        from hyperspace_tpu_torch.index.index_config import IndexConfig

        cand = self._pending_candidates.get(decision.index)
        if cand is None:
            raise HyperspaceError(
                f"advisor candidate {decision.index!r} vanished between "
                f"ranking and build")
        name = _unique_name(self.session, cand.name)
        ds = Dataset(cand.source_scan(), self.session)
        self.session.index_collection_manager.create(
            ds, IndexConfig(name, cand.indexed, cand.included))

    # -- journaling ----------------------------------------------------------
    def _journal(self, decision: policy.MaintenanceDecision, *,
                 outcome: str, error: str = "", wall_s: float = 0.0,
                 change=None) -> dict:
        metrics.inc("lifecycle.decisions")
        rec = {
            "cycle": self._cycle,
            "decision": decision.kind,
            "index": decision.index,
            "mode": decision.mode,
            "reason": decision.reason,
            "outcome": outcome,
            "wall_s": round(wall_s, 4),
        }
        if error:
            rec["error"] = error[:500]
        if change is not None:
            rec.update(appended=change.appended, deleted=change.deleted,
                       mutated=change.mutated)
        journal.append(self.session.conf, rec)
        return rec
