"""A plan bound to its session (counterpart of hyperspace_tpu/dataset.py):
what ``session.read.parquet`` returns, what ``Hyperspace.create_index``
takes, and the query verbs ``filter``, ``select`` (column names and
computed columns), ``with_column``, ``with_window``, ``join``,
``group_by(...).agg(...)``, ``agg``, ``sort``, ``limit``, ``distinct``,
``union``, ``intersect``, ``subtract``, ``cache``, ``collect``,
``to_pandas``, ``count``, ``columns``, ``show``, ``explain`` (with
``whatif=``, the advisor's what-if), ``explain_string`` and
``last_run_report``.

``collect(plan_cache=None)`` first applies the session's conf to the
strict sync guard (execution/sync_guard.py) for the session's device,
checks the deadline (utils/deadline.py) at its ``planning`` seam, takes
the optimized plan from ``plan_cache`` (execution/plan_cache.py) on a
fresh hit, and offers the finished run report to the flight recorder
(telemetry/flight_recorder.py).  A past deadline and a sync-guard
violation propagate: no containment, fallback or re-plan takes them.

``collect()`` optimizes the plan (the index rules run when hyperspace is
enabled on the session), executes it into an arrow table and publishes
the executor's stats as ``session.last_execution_stats`` and its run
report (telemetry/report.py) as ``last_run_report()``; with
``conf.advisor_capture_enabled`` the report then feeds the advisor's
workload capture (advisor/workload.py), which never fails the query.

When reading index data fails at execution, ``collect`` contains the
damage (the JAX package's execution-time containment), with
``conf.degraded_fallback_to_source`` set:

  - with ``conf.integrity_quarantine_on_failure``, it probes every index
    file the plan reads (execution/containment.py), quarantines the
    damaged ones and runs the query again, planned with the indexes: the
    damaged buckets are now read from the source;
  - with ``conf.auto_repair_enabled``, after that answer it rebuilds the
    quarantined buckets (``refresh_index(mode="repair")``);
  - when nothing was quarantined, or the re-plan's own index read
    failed, it runs the query against the source without the indexes.

Each step is recorded in the run report as the JAX package records it:
the quarantine (and the ``quarantine.files`` counter), an
``IndexDegradedEvent`` naming the index and the error (which the report
turns into a ``degraded`` decision), and the re-plan.  Planning itself
degrades too: when optimizing with the indexes fails on the index's side
(an index whose every file is gone), ``collect`` emits an
``IndexDegradedEvent``, records a planning-stage re-plan, and plans
without the indexes.  ``collect`` is a ``query.collect`` span with
``execute``, ``containment.probe``, ``execute.replan`` and
``optimize.replan`` spans under it (telemetry/).

One deliberate narrowing against the JAX package, which takes any
failure there: only a failure to READ index data starts containment,
an ``OSError`` or a pyarrow ``ArrowException`` raised while the executor
read index files (``Executor.index_read_failures``).  A CUDA or
kernel-loader error, or any other error of a device op, propagates
unchanged and quarantines nothing, since no fallback may hide the card;
so does a failed auto repair's error other than a ``HyperspaceError``
or a read error.  ``last_execution_stats["containment"]`` records what
was done: the files quarantined and the re-plan's mode
("containment" or "source-fallback"); the run report records the
quarantine and the containment re-plan, as the JAX package's does."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from hyperspace_tpu_torch.plan.expr import Col, Expr, Lit
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Compute,
    Distinct,
    Filter,
    InMemory,
    Join,
    Limit,
    LogicalPlan,
    Project,
    SetOp,
    Sort,
    Union,
    Window,
    WithColumns,
)
from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry import report as run_report
from hyperspace_tpu_torch.telemetry import trace
from hyperspace_tpu_torch.telemetry.events import (
    IndexDegradedEvent,
    emit_event,
)


class GroupedDataset:
    """``ds.group_by(...)``, waiting for its aggregations."""

    def __init__(self, dataset: "Dataset", group_by: Sequence[str]) -> None:
        self._dataset = dataset
        self._group_by = list(group_by)

    def agg(self, **named_specs) -> "Dataset":
        """Specs are ``out=(input, func)``, the input a column name or an
        expression: ``agg(revenue=(col("p") * (1 - col("d")), "sum"))``,
        the TPC-H Q3/Q10 shape."""
        aggs = [(func, agg_in, out)
                for out, (agg_in, func) in named_specs.items()]
        return Dataset(Aggregate(self._group_by, aggs, self._dataset.plan),
                       self._dataset.session)

    def count(self, name: str = "count") -> "Dataset":
        """The row count per group (count(*): null keys count too)."""
        if not self._group_by:
            raise ValueError(
                "group_by().count() needs group columns; use "
                "Dataset.count() for the total row count")
        return Dataset(Aggregate(self._group_by, [("count_all", "", name)],
                                 self._dataset.plan), self._dataset.session)


class Dataset:
    def __init__(self, plan: LogicalPlan, session) -> None:
        self.plan = plan
        self.session = session

    def filter(self, condition: Expr) -> "Dataset":
        return Dataset(Filter(condition, self.plan), self.session)

    def select(self, *columns: str, **computed: Expr) -> "Dataset":
        """Columns by name, and computed ones as keywords:
        ``select("o_orderkey", revenue=col("p") * (1 - col("d")))``.
        Names alone stay a Project (the shape the rules match); any
        computed output makes a Compute."""
        bad = [c for c in columns if not isinstance(c, str)]
        if bad:
            raise ValueError(
                f"select() positional arguments are column names; pass "
                f"expressions as keywords (alias=expr), got {bad[0]!r}")
        if not computed:
            return Dataset(Project(list(columns), self.plan), self.session)
        exprs = [(c, Col(c)) for c in columns]
        for name, e in computed.items():
            if isinstance(e, str):
                # A rename (col) or a constant (lit)?  The caller says.
                raise ValueError(
                    f"select({name}={e!r}): pass col({e!r}) to project a "
                    f"column under a new name, or lit({e!r}) for a string "
                    f"constant")
            exprs.append((name, e if isinstance(e, Expr) else Lit(e)))
        return Dataset(Compute(exprs, self.plan), self.session)

    def with_column(self, name: str, expr: Expr) -> "Dataset":
        """Append one computed column, or replace the one of that name,
        keeping every other."""
        return Dataset(WithColumns([(name, expr)], self.plan), self.session)

    def with_window(self, name: str, func: str,
                    partition_by: Sequence[str] = (),
                    order_by: Sequence = (),
                    value: str = None, offset: int = 1,
                    frame=None) -> "Dataset":
        """Append one analytic column, ``func(value) OVER (PARTITION BY
        partition_by ORDER BY order_by [ROWS frame])``: row_number, rank,
        dense_rank, ntile, sum, min, max, mean, count, lag, lead,
        first_value or last_value (semantics in ``plan.nodes.Window``).

            ds.with_window("rk", "rank", partition_by=["grp"],
                           order_by=[("revenue", False)])

        ``order_by`` entries are column names or (column, ascending)
        pairs; ``offset`` is lag's and lead's shift and ntile's tile
        count; ``frame`` is a ROWS frame (lo, hi) of row offsets,
        negative preceding and None unbounded: ``(None, 0)`` is ROWS
        BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW."""
        normalized = []
        for k in order_by:
            if isinstance(k, str):
                normalized.append((k, True))
            elif (isinstance(k, (tuple, list)) and len(k) == 2
                    and isinstance(k[0], str)):
                normalized.append((k[0], bool(k[1])))
            else:
                raise ValueError(
                    f"Window order key must be a column name or a "
                    f"(column, ascending) pair, got {k!r}")
        if frame is not None:
            if not isinstance(frame, (tuple, list)) or len(frame) != 2:
                raise ValueError(
                    f"frame must be an (lo, hi) pair of row offsets "
                    f"(None = unbounded), got {frame!r}")
            frame = (frame[0], frame[1])
        return Dataset(Window(name, func, value, list(partition_by),
                              normalized, self.plan, offset=offset,
                              frame=frame), self.session)

    def join(self, other: "Dataset", condition: Expr,
             how: str = "inner") -> "Dataset":
        return Dataset(Join(self.plan, other.plan, condition, how), self.session)

    def group_by(self, *columns: str) -> GroupedDataset:
        return GroupedDataset(self, columns)

    def agg(self, **named_specs) -> "Dataset":
        """A global aggregation: ``ds.agg(n=("k", "count"))``."""
        return GroupedDataset(self, ()).agg(**named_specs)

    def sort(self, *keys, ascending: bool = True) -> "Dataset":
        """Order by ``keys``: column names, which take ``ascending``, or
        (column, ascending) pairs."""
        normalized = []
        for k in keys:
            if isinstance(k, str):
                normalized.append((k, ascending))
            elif (isinstance(k, (tuple, list)) and len(k) == 2
                    and isinstance(k[0], str)
                    and isinstance(k[1], (bool, int, np.bool_, np.integer))):
                normalized.append((k[0], bool(k[1])))
            else:
                raise ValueError(
                    f"Sort key must be a column name or a "
                    f"(column, ascending) pair, got {k!r}")
        return Dataset(Sort(normalized, self.plan), self.session)

    def limit(self, n: int) -> "Dataset":
        return Dataset(Limit(n, self.plan), self.session)

    def distinct(self) -> "Dataset":
        """The distinct rows of the whole output (SQL DISTINCT)."""
        return Dataset(Distinct(self.plan), self.session)

    def union(self, other: "Dataset") -> "Dataset":
        """UNION ALL by name (Spark's ``unionByName(allowMissingColumns=
        True)``): a column one side lacks is null there, and numeric
        widths widen.  ``.distinct()`` after it is SQL's UNION."""
        return Dataset(Union([self.plan, other.plan]), self.session)

    def intersect(self, other: "Dataset") -> "Dataset":
        """SQL INTERSECT: the distinct rows in both, compared by position
        and null-safely."""
        return Dataset(SetOp("intersect", self.plan, other.plan),
                       self.session)

    def subtract(self, other: "Dataset") -> "Dataset":
        """SQL EXCEPT: the distinct rows of this dataset that ``other``
        lacks, compared null-safely."""
        return Dataset(SetOp("except", self.plan, other.plan), self.session)

    def cache(self) -> "Dataset":
        """This dataset's result now, as a Dataset over the in-memory
        table: later queries over it read no file, and later changes of
        the files do not reach it.  Keeping index columns on the device
        is the device column cache's job (execution/device_cache.py)."""
        return Dataset(InMemory(self.collect()), self.session)

    def optimized_plan(self, use_indexes: bool = True) -> LogicalPlan:
        return self.session.optimize(self.plan, use_indexes=use_indexes)

    def collect(self, plan_cache=None):
        """The result as a pyarrow Table.  A run report
        (telemetry/report.py) is open while it runs, and is published as
        ``session.last_run_report_value`` (``last_run_report()``); the
        finished report is offered to the flight recorder
        (telemetry/flight_recorder.py).  The first thing ``collect`` does
        is apply the session's conf to the strict sync guard
        (execution/sync_guard.py), for the session's device.

        ``plan_cache`` is an optimize-result cache
        (execution/plan_cache.py): a fresh hit skips the optimizer and
        runs the cached plan; a plan that fails at execution is dropped
        from it before containment runs.  A past deadline
        (utils/deadline.py) and a sync-guard violation propagate, never
        degraded, re-planned or contained."""
        from hyperspace_tpu_torch.execution import sync_guard
        from hyperspace_tpu_torch.telemetry import flight_recorder, timeline

        # A conf field set after the session was made still takes effect.
        trace.configure_from_conf(self.session.conf)
        timeline.configure_from_conf(self.session.conf)
        sync_guard.arm(self.session.conf, self.session.device)
        token = run_report.start()
        query_span = None
        try:
            with trace.span("query.collect") as sp:
                query_span = sp  # the real Span when tracing is on
                out, executor = self._collect_traced(plan_cache)
        except Exception:
            run_report.active().outcome = "error"
            raise
        finally:
            rep = run_report.finish(token)
            if isinstance(query_span, trace.Span):
                rep.root_span = query_span
            self.session.last_run_report_value = rep
            if trace.current_request_context() is None:
                # A local query: recorded here, so slow_queries() works
                # without a server.  A served one is recorded by its
                # worker, with the wire ids and its queue wait.  Never
                # raises: diagnostics never fail a query.
                flight_recorder.record_local(self.session.conf, rep)
        executor.finalize_stats()
        self.session.last_execution_stats = executor.stats
        if self.session.conf.advisor_capture_enabled:
            # The finished report feeds the advisor's workload capture,
            # which never raises (advisor/workload.py).
            from hyperspace_tpu_torch.advisor import workload

            workload.capture(self.session, self.plan, rep,
                             result_rows=out.num_rows)
        return out

    def _collect_traced(self, plan_cache):
        """(answer, its executor): plan (from the cache on a hit), then
        execute, containing a read failure of index files."""
        from hyperspace_tpu_torch.execution.containment import (
            always_propagates,
            index_scans_of,
        )
        from hyperspace_tpu_torch.execution.executor import Executor
        from hyperspace_tpu_torch.utils import deadline

        # A query whose budget is spent stops before planning.
        deadline.check("planning")
        executor = Executor(self.session)
        plan = None
        cache_key = None
        if plan_cache is not None:
            cache_key = plan_cache.key_for(self.session, self.plan)
            if cache_key is not None:
                plan = plan_cache.get(cache_key)
                if plan is not None:
                    # The rules that record the indexes used did not run:
                    # name the cached plan's index scans instead.
                    run_report.record("plan_cache", hit=True,
                                      fingerprint=cache_key)
                    for name in index_scans_of(plan):
                        run_report.record("index.used", index=name,
                                          message="served from plan cache")
        if plan is None:
            try:
                plan = self.optimized_plan()
            except Exception as e:  # noqa: BLE001 - _replan re-raises
                plan = self._replan_without_indexes(e)
            else:
                if cache_key is not None:
                    plan_cache.put(cache_key, plan)
                    run_report.record("plan_cache", hit=False,
                                      fingerprint=cache_key)
        try:
            with trace.span("execute"):
                out = executor.execute(plan)
        except Exception as e:  # noqa: BLE001 - _contain re-raises
            if cache_key is not None and not always_propagates(e):
                # The next query derives its plan anew instead of
                # replaying this failure.
                plan_cache.invalidate(cache_key)
            out, executor = self._contain(plan, executor, e)
        return out, executor

    def last_run_report(self):
        """The run report of this session's most recent ``collect()`` on
        the calling thread (None before any query): the indexes
        considered and used, each rule's decision, every executed scan's
        IO, and what containment did."""
        return self.session.last_run_report_value

    def explain(self, verbose: bool = False, whatif=None) -> str:
        """The plans with and without the indexes, side by side
        (``Hyperspace.explain`` without the Hyperspace object).  With
        ``whatif``, a list of ``IndexConfig``s (or hypothetical entries),
        the advisor's what-if instead: the plan as if they were built
        beside the plan without, and the estimated bytes each scans;
        nothing runs and no file is written (advisor/hypothetical.py)."""
        if whatif is not None:
            from hyperspace_tpu_torch.advisor.hypothetical import (
                whatif as _whatif,
            )

            return _whatif(self.session, self, whatif).render()
        from hyperspace_tpu_torch.plananalysis.explain import explain_string

        return explain_string(self, self.session, verbose=verbose)

    def explain_string(self) -> str:
        """The unoptimized plan's tree."""
        return self.plan.tree_string()

    def _replan_without_indexes(self, error: Exception) -> LogicalPlan:
        """The plan without the indexes after planning with them raised
        ``error`` on the index's side (every file of an index gone, so
        not even its schema reads), the failure recorded as a
        ``degraded`` decision and a planning-stage re-plan.  ``error``
        itself when it is a device or kernel error, a past deadline or
        a sync-guard violation, or when the fallback is off."""
        from hyperspace_tpu_torch.execution.containment import (
            is_index_side_error,
        )

        if not (self.session.is_hyperspace_enabled()
                and self.session.conf.degraded_fallback_to_source
                and is_index_side_error(error)):
            raise error
        emit_event(IndexDegradedEvent(
            reason=f"index-aware planning failed: {error!r}",
            message="re-planned without index rewrites"))
        run_report.record("replan", mode="source-fallback",
                          stage="planning")
        with trace.span("optimize.replan", mode="source-fallback"):
            return self.optimized_plan(use_indexes=False)

    def _contain(self, plan: LogicalPlan, failed, error: Exception):
        """(answer, its executor) after ``failed`` raised ``error`` running
        ``plan``; ``error`` itself unless it is a read error of index
        files and the conf allows the fallback."""
        from hyperspace_tpu_torch.exceptions import HyperspaceError
        from hyperspace_tpu_torch.execution.containment import (
            always_propagates,
            index_scans_of,
            is_read_error,
            quarantine_damaged_index_files,
        )
        from hyperspace_tpu_torch.execution.executor import Executor

        conf = self.session.conf
        if not (failed.index_read_failures and is_read_error(error)
                and conf.degraded_fallback_to_source):
            raise error
        record = {"error": repr(error), "quarantined": []}
        if conf.integrity_quarantine_on_failure:
            with trace.span("containment.probe") as sp:
                record["quarantined"] = quarantine_damaged_index_files(
                    self.session, plan)
                sp.set(quarantined=len(record["quarantined"]))
        names = index_scans_of(plan)
        if record["quarantined"]:
            metrics.inc("quarantine.files", len(record["quarantined"]))
            run_report.record("quarantine", index=",".join(names),
                              files=record["quarantined"])
            emit_event(IndexDegradedEvent(
                index_name=",".join(names),
                reason=f"index scan failed at execution: {error!r}; "
                       f"quarantined {len(record['quarantined'])} damaged "
                       f"file(s)",
                message="re-planned with damaged buckets read from source"))
            run_report.record("replan", mode="containment", stage="execution")
            executor = Executor(self.session)
            try:
                with trace.span("execute.replan", mode="containment"):
                    out = executor.execute(self.optimized_plan())
            except Exception as e:  # noqa: BLE001 - re-raised unless a
                # read error of index files, which the source answers
                if not (executor.index_read_failures and is_read_error(e)):
                    raise
            else:
                record["replan"] = "containment"
                executor.stats["containment"] = record
                if conf.auto_repair_enabled:
                    for name in names:
                        try:
                            self.session.index_collection_manager.refresh(
                                name, "repair")
                        except Exception as e:  # noqa: BLE001 - a repair
                            # failure costs no answer, but a device error
                            # propagates
                            if always_propagates(e) or (
                                    not isinstance(e, HyperspaceError)
                                    and not is_read_error(e)):
                                raise
                            record.setdefault("repair_errors", []).append(
                                repr(e))
                return out, executor
        emit_event(IndexDegradedEvent(
            index_name=",".join(names),
            reason=f"index scan failed at execution: {error!r}",
            message="re-executed against the source scan"))
        run_report.record("replan", mode="source-fallback", stage="execution")
        executor = Executor(self.session)
        with trace.span("execute.replan", mode="source-fallback"):
            out = executor.execute(self.optimized_plan(use_indexes=False))
        record["replan"] = "source-fallback"
        executor.stats["containment"] = record
        return out, executor

    def to_pandas(self):
        return self.collect().to_pandas()

    def count(self) -> int:
        return self.collect().num_rows

    @property
    def columns(self) -> List[str]:
        return self.plan.output_columns(self.session.schema_of)

    def show(self, n: int = 20) -> None:
        """Print the first ``n`` rows; the whole result is collected."""
        table = self.collect()
        head = table.slice(0, n)
        names = head.column_names
        rows = [[str(v) for v in row.values()] for row in head.to_pylist()]
        widths = [max(len(name), *(len(r[i]) for r in rows), 1) if rows
                  else len(name) for i, name in enumerate(names)]
        print(" ".join(name.rjust(w) for name, w in zip(names, widths)))
        for r in rows:
            print(" ".join(v.rjust(w) for v, w in zip(r, widths)))
        if table.num_rows > n:
            print(f"... ({table.num_rows - n} more rows)")
