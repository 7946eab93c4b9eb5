"""A plan bound to its session (counterpart of hyperspace_tpu/dataset.py):
what ``session.read.parquet`` returns, what ``Hyperspace.create_index``
takes, and the query verbs ``filter``, ``select`` (column names),
``join``, ``group_by(...).agg(...)``, ``agg``, ``sort``, ``limit``,
``cache``, ``collect`` and ``count``.

``collect()`` optimizes the plan (the index rules run when hyperspace is
enabled on the session), executes it into an arrow table and publishes
the executor's stats as ``session.last_execution_stats``.

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

One deliberate narrowing against the JAX package, which takes any
failure there: only a failure to READ index data starts containment,
an ``OSError`` or a pyarrow ``ArrowException`` raised while the executor
read index files (``Executor.index_read_failures``).  A CUDA or
kernel-loader error, or any other error of a device op, propagates
unchanged and quarantines nothing, since no fallback may hide the card;
so does a failed auto repair's error other than a ``HyperspaceError``
or a read error.  ``last_execution_stats["containment"]`` records what
was done: the files quarantined and the re-plan's mode
("containment" or "source-fallback")."""

from __future__ import annotations

from typing import Sequence

import numpy as np

from hyperspace_tpu_torch.plan.expr import Expr
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Filter,
    InMemory,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Sort,
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

    def select(self, *columns: str) -> "Dataset":
        bad = [c for c in columns if not isinstance(c, str)]
        if bad:
            raise ValueError(f"select() takes column names, got {bad[0]!r}")
        return Dataset(Project(list(columns), self.plan), self.session)

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

    def cache(self) -> "Dataset":
        """This dataset's result now, as a Dataset over the in-memory
        table: later queries over it read no file, and later changes of
        the files do not reach it.  Keeping index columns on the device
        is the device column cache's job (execution/device_cache.py)."""
        return Dataset(InMemory(self.collect()), self.session)

    def optimized_plan(self, use_indexes: bool = True) -> LogicalPlan:
        return self.session.optimize(self.plan, use_indexes=use_indexes)

    def collect(self):
        """The result as a pyarrow Table."""
        from hyperspace_tpu_torch.execution.executor import Executor

        executor = Executor(self.session)
        plan = self.optimized_plan()
        try:
            out = executor.execute(plan)
        except Exception as e:  # noqa: BLE001 - _contain re-raises the rest
            out, executor = self._contain(plan, executor, e)
        self.session.last_execution_stats = executor.stats
        return out

    def _contain(self, plan: LogicalPlan, failed, error: Exception):
        """(answer, its executor) after ``failed`` raised ``error`` running
        ``plan``; ``error`` itself unless it is a read error of index
        files and the conf allows the fallback."""
        from hyperspace_tpu_torch.exceptions import HyperspaceError
        from hyperspace_tpu_torch.execution.containment import (
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
            record["quarantined"] = quarantine_damaged_index_files(
                self.session, plan)
        if record["quarantined"]:
            executor = Executor(self.session)
            try:
                out = executor.execute(self.optimized_plan())
            except Exception as e:  # noqa: BLE001 - re-raised unless a
                # read error of index files, which the source answers
                if not (executor.index_read_failures and is_read_error(e)):
                    raise
            else:
                record["replan"] = "containment"
                executor.stats["containment"] = record
                if conf.auto_repair_enabled:
                    for name in index_scans_of(plan):
                        try:
                            self.session.index_collection_manager.refresh(
                                name, "repair")
                        except Exception as e:  # noqa: BLE001 - a repair
                            # failure costs no answer, but a device error
                            # propagates
                            if not isinstance(e, HyperspaceError) \
                                    and not is_read_error(e):
                                raise
                            record.setdefault("repair_errors", []).append(
                                repr(e))
                return out, executor
        executor = Executor(self.session)
        out = executor.execute(self.optimized_plan(use_indexes=False))
        record["replan"] = "source-fallback"
        executor.stats["containment"] = record
        return out, executor

    def count(self) -> int:
        return self.collect().num_rows
