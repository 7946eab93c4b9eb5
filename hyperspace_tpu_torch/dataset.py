"""A plan bound to its session (counterpart of hyperspace_tpu/dataset.py):
what ``session.read.parquet`` returns, what ``Hyperspace.create_index``
takes, and the query verbs ``filter``, ``select`` (column names),
``join`` and ``collect``.

``collect()`` optimizes the plan (the index rules run when hyperspace is
enabled on the session), executes it into an arrow table and publishes
the executor's stats as ``session.last_execution_stats``.  An error of
the execution propagates: nothing re-plans without the indexes."""

from __future__ import annotations

from hyperspace_tpu_torch.plan.expr import Expr
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project


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

    def optimized_plan(self) -> LogicalPlan:
        return self.session.optimize(self.plan)

    def collect(self):
        """The result as a pyarrow Table."""
        from hyperspace_tpu_torch.execution.executor import Executor

        executor = Executor(self.session)
        out = executor.execute(self.optimized_plan())
        self.session.last_execution_stats = executor.stats
        return out
