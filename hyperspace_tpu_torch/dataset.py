"""A plan bound to its session (counterpart of
hyperspace_tpu/dataset.py): what ``session.read.parquet`` returns and
``Hyperspace.create_index`` takes.  Query verbs are not ported yet."""

from __future__ import annotations

from hyperspace_tpu_torch.plan.nodes import LogicalPlan


class Dataset:
    def __init__(self, plan: LogicalPlan, session) -> None:
        self.plan = plan
        self.session = session
