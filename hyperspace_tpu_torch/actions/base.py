"""The action state machine: begin -> op -> end with optimistic
concurrency (counterpart of hyperspace_tpu/actions/base.py).

  - ``base_id`` is captured from the latest log id when the action is
    made;
  - ``begin()`` writes a transient-state entry at ``base_id + 1``; the
    create-if-absent write is what detects a concurrent writer;
  - ``op()`` does the work;
  - ``end()`` writes the final-state entry at ``base_id + 2`` and moves
    the ``latestStable`` pointer to it.

An action that dies mid-flight leaves the transient entry as the latest
log record; ``cancel()`` rolls it back, and so does the manager's auto
recovery before the next verb.  The ``action.commit`` fault site
(io/faults.py) sits between ``op()`` and ``end()``.  ``run()`` returns
"ok" for a committed run and "noop" when ``validate()`` raised
``NoChangesError`` (nothing is written).

``run()`` is an optimistic transaction loop.  When the collection
manager armed ``concurrency_max_retries`` (``conf.
concurrency_max_retries``), a ``ConcurrentWriteError`` does not abort
the action: it emits a ``CONFLICT_RETRY n/max`` action event, sleeps a
jittered backoff, rebases (``_rebase``: the base id and the previous
entry from the state the winning writer left) and runs validate, begin,
op and end again.  A retry whose validation finds nothing left to do
(the winner did the work) ends as a "noop"; one that finds an impossible
state (a create over a now-ACTIVE index) raises the validation error.  A
directly constructed action keeps 0 retries: the first conflict raises.

Telemetry (telemetry/): each run is an ``action.<Class>`` span, emits
its class's action events (the running state, the final state, or
``FAILURE``), samples memory on the timeline while it runs, and
finishes its ``BuildReport``: ``validate`` and ``commit`` are phases,
the report is published with its outcome ("error" for a run that
raised), exported to the metrics registry, attached to the span as
``build.phase.*`` children and appended to the perf ledger.
"""

from __future__ import annotations

import copy
import random
import time
from typing import Optional, Type

from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteError,
    HyperspaceError,
    NoChangesError,
)
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.io import faults
from hyperspace_tpu_torch.telemetry import build_report
from hyperspace_tpu_torch.telemetry.events import _IndexActionEvent, emit_event
from hyperspace_tpu_torch.utils.retry import RetryPolicy


class Action:
    # Subclasses set these.
    transient_state: str = ""
    final_state: str = ""
    event_class: Optional[Type[_IndexActionEvent]] = None
    # The transaction loop's conflict budget and backoff; the collection
    # manager sets them on the instance from the conf (index/manager.py).
    concurrency_max_retries: int = 0
    conflict_backoff: RetryPolicy = RetryPolicy()

    def __init__(self, log_manager: IndexLogManager) -> None:
        self.log_manager = log_manager
        latest = self.log_manager.get_latest_id()
        self.base_id: int = 0 if latest is None else latest
        self.previous_log_entry: Optional[IndexLogEntry] = \
            self.log_manager.get_latest_log()
        # Conflicts the transaction loop absorbed in this run.
        self.conflict_retries: int = 0
        # Owned by the action, so the spill build's worker threads record
        # into it; run() finishes and publishes it.
        self.build_report = build_report.BuildReport(action=type(self).__name__)

    @property
    def index_name(self) -> str:
        entry = self.previous_log_entry
        return entry.name if entry is not None else ""

    def validate(self) -> None:
        """Raise HyperspaceError (NoChangesError for a benign no-op)
        before any state is written."""

    def log_entry_for_begin(self) -> IndexLogEntry:
        """The entry begin() writes: by default a copy of the previous
        one (actions on an existing index); create builds a fresh one."""
        if self.previous_log_entry is None:
            raise HyperspaceError("No existing index log entry for this action")
        return copy.deepcopy(self.previous_log_entry)

    def op(self) -> None:
        raise NotImplementedError

    def log_entry(self) -> IndexLogEntry:
        """The entry committed by end(), built after op()."""
        raise NotImplementedError

    def begin(self) -> None:
        entry = self.log_entry_for_begin()
        entry.state = self.transient_state
        self.log_manager.write_log_or_raise(self.base_id + 1, entry)

    def end(self) -> None:
        entry = self.log_entry()
        entry.state = self.final_state
        self.log_manager.delete_latest_stable_log()
        self.log_manager.write_log_or_raise(self.base_id + 2, entry)
        self.log_manager.create_latest_stable_log(self.base_id + 2)

    def _rebase(self) -> None:
        """After a conflict: validate against, and write at ids derived
        from, the state the winning writer committed.  Refresh extends
        this with its stable entry and file-id tracker."""
        latest = self.log_manager.get_latest_id()
        self.base_id = 0 if latest is None else latest
        self.previous_log_entry = self.log_manager.get_latest_log()

    def _emit(self, state: str, message: str = "") -> None:
        if self.event_class is not None:
            emit_event(self.event_class(
                index_name=self.index_name, state=state, message=message))

    def run(self) -> str:
        report = self.build_report
        # The report times run() itself, not the action's construction.
        report._t0 = time.perf_counter()
        report.started_at = time.time()
        report.index = self.index_name
        # The timeline (telemetry/timeline.py): this session's conf, and
        # while enabled a memory sampler for the run's duration.  The
        # finally covers InjectedCrash too.
        from hyperspace_tpu_torch.telemetry import timeline

        sampler = None
        session = getattr(self, "session", None)
        if session is not None:
            timeline.configure_from_conf(session.conf)
            if build_report.profiling_enabled(session.conf):
                sampler = timeline.start_sampler(session.conf, report,
                                                 device=session.device)
        try:
            return self._run_transaction(random.Random())
        finally:
            if sampler is not None:
                sampler.stop()

    def _run_transaction(self, rng: random.Random) -> str:
        """The conflict-retrying loop under the action's span."""
        from hyperspace_tpu_torch.telemetry.trace import span

        with span(f"action.{type(self).__name__}",
                  index=self.index_name) as sp:
            try:
                while True:
                    try:
                        outcome = self._attempt()
                        if outcome == "ok":
                            # A committed index change makes every cached
                            # optimize result suspect: the next lookup of
                            # a plan cache re-plans (execution/plan_cache.py).
                            from hyperspace_tpu_torch.execution import (
                                plan_cache,
                            )

                            plan_cache.bump_generation()
                        sp.set(conflict_retries=self.conflict_retries)
                        self._finish_report(outcome, "", sp)
                        return outcome
                    except ConcurrentWriteError as e:
                        if self.conflict_retries >= \
                                self.concurrency_max_retries:
                            self._emit("FAILURE", "concurrent modification")
                            raise
                        self.conflict_retries += 1
                        self._emit(
                            f"CONFLICT_RETRY {self.conflict_retries}/"
                            f"{self.concurrency_max_retries}",
                            f"concurrent write at base_id={self.base_id}: "
                            f"{e}")
                        # Jittered, so two rebased racers do not collide
                        # again in lockstep.
                        time.sleep(self.conflict_backoff.delay_s(
                            self.conflict_retries - 1, rng))
                        self._rebase()
            except Exception as e:
                # A failed run still reports.  InjectedCrash is a
                # BaseException and skips this, as a real kill would.
                self._finish_report("error", str(e), sp)
                raise

    def _attempt(self) -> str:
        """One turn of the loop: validate, begin, op, end."""
        report = self.build_report
        t0 = time.perf_counter()
        try:
            self.validate()
        except NoChangesError as e:
            self._emit(States.ACTIVE, f"No-op: {e}")
            return "noop"
        finally:
            report.add_phase("validate", time.perf_counter() - t0)
        try:
            t0 = time.perf_counter()
            self.begin()
            report.add_phase("commit", time.perf_counter() - t0)
            self.op()
            # Crash checkpoint: the work is done, the final entry is not
            # committed; the state a killed process leaves, which cancel()
            # and auto recovery roll back.
            faults.check("action.commit")
            t0 = time.perf_counter()
            self.end()
            report.add_phase("commit", time.perf_counter() - t0)
            self._emit(self.final_state)
            return "ok"
        except ConcurrentWriteError:
            raise  # the loop decides: retry or FAILURE
        except Exception as e:
            self._emit("FAILURE", str(e))
            raise

    def _finish_report(self, outcome: str, error: str, sp) -> None:
        """Finish and publish this run's report; with profiling on, also
        export its metrics, add its phase spans and append its ledger
        record.  An action made without a session publishes it
        process-wide only.  The diagnostics never fail the action: an
        error there is counted in ``build.report.errors``."""
        from hyperspace_tpu_torch.telemetry import metrics, perf_ledger

        report = self.build_report
        report.conflict_retries = self.conflict_retries
        report.index = report.index or self.index_name
        session = getattr(self, "session", None)
        conf = session.conf if session is not None else None
        profiled = conf is None or build_report.profiling_enabled(conf)
        if profiled:
            report.sample_memory(getattr(session, "device", None))
        report.finish(outcome, error)
        build_report.publish(report, session)
        try:
            if profiled:
                report.export_metrics()
                report.attach_to_span(sp)
            if conf is not None and profiled:
                perf_ledger.append(conf, {
                    "kind": "action",
                    "name": f"{report.action}({report.index})"
                    if report.index else report.action,
                    **{k: v for k, v in report.to_dict().items()
                       if k != "started_at"},
                    "fingerprint": perf_ledger.fingerprint(conf)})
        except Exception:  # noqa: BLE001 - diagnostics only
            metrics.inc("build.report.errors")
