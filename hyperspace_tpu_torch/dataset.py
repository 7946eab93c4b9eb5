"""A plan bound to its session (counterpart of hyperspace_tpu/dataset.py):
what ``session.read.parquet`` returns, what ``Hyperspace.create_index``
takes, and the query verbs ``filter``, ``select`` (column names),
``join``, ``group_by(...).agg(...)``, ``agg``, ``sort``, ``limit``,
``cache``, ``collect`` and ``count``.

``collect()`` optimizes the plan (the index rules run when hyperspace is
enabled on the session), executes it into an arrow table and publishes
the executor's stats as ``session.last_execution_stats``.  An error of
the execution propagates: nothing re-plans without the indexes."""

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

    def optimized_plan(self) -> LogicalPlan:
        return self.session.optimize(self.plan)

    def collect(self):
        """The result as a pyarrow Table."""
        from hyperspace_tpu_torch.execution.executor import Executor

        executor = Executor(self.session)
        out = executor.execute(self.optimized_plan())
        self.session.last_execution_stats = executor.stats
        return out

    def count(self) -> int:
        return self.collect().num_rows
