"""The engine session (counterpart of hyperspace_tpu/session.py): conf,
the device the data plane runs on, readers, the source provider manager,
schema resolution and the optimizer.

``enable_hyperspace()`` switches the index rewrite rules on; ``optimize``
then runs, in the JAX package's order: filter pushdown, column pruning,
JoinIndexRule, FilterIndexRule, BucketPruneRule, DataSkippingFilterRule
(last: a covering rewrite beats file pruning), and pushdown and pruning
once more (the rules rebuild sides in Filter-above-Project form);
``use_indexes=False`` skips the rules (the source plan of
``Dataset.collect``'s fallback).  Each pass records the indexes it
considered and each rule's decision in the active run report
(telemetry/report.py); ``last_run_report_value`` holds the report of
the calling thread's last ``Dataset.collect``.  Not ported: the
degraded fallback that answers from the source when a rule fails, and
the plan cache."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Union

import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan, ScanRelation
from hyperspace_tpu_torch.sources.manager import FileBasedSourceProviderManager
from hyperspace_tpu_torch.telemetry import report


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """``None`` means the card: ``cuda``, which must be available.  There
    is no silent fall back to the CPU; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hyperspace_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class DataReader:
    """``session.read.parquet(path)``."""

    def __init__(self, session: "HyperspaceSession") -> None:
        self._session = session

    def parquet(self, *paths: str, **options: str):
        from hyperspace_tpu_torch.dataset import Dataset

        rel = ScanRelation(root_paths=tuple(paths), file_format="parquet",
                           options=tuple(sorted(options.items())))
        return Dataset(Scan(rel), self._session)


class HyperspaceSession:
    def __init__(self, system_path: Optional[str] = None,
                 device: Union[None, str, torch.device] = None,
                 conf: Optional[HyperspaceConf] = None) -> None:
        self.device = resolve_device(device)
        self.conf = conf if conf is not None else HyperspaceConf()
        if system_path is not None:
            self.conf.system_path = system_path
        # Per-build phase seconds, one dict per CreateAction run.
        self.build_stats_log: List[Dict[str, float]] = []
        # The BuildReport of the last action run with this session.
        self.last_build_report_value = None
        self._hyperspace_enabled = False
        self._schema_cache: Dict[ScanRelation, Dict[str, str]] = {}
        # The executor's stats of the most recent Dataset.collect().
        self.last_execution_stats: Optional[Dict[str, List[Dict[str, Any]]]] = None
        # The run report of the calling thread's most recent collect().
        self._run_report = threading.local()

    @property
    def last_run_report_value(self):
        return getattr(self._run_report, "value", None)

    @last_run_report_value.setter
    def last_run_report_value(self, value) -> None:
        self._run_report.value = value

    @property
    def read(self) -> DataReader:
        return DataReader(self)

    @property
    def source_provider_manager(self) -> FileBasedSourceProviderManager:
        return FileBasedSourceProviderManager()

    @property
    def index_collection_manager(self):
        from hyperspace_tpu_torch.index.manager import IndexCollectionManager

        return IndexCollectionManager(self)

    def schema_of(self, scan: Scan) -> List[str]:
        return list(self.schema_map_of(scan).keys())

    def schema_map_of(self, scan: Scan) -> Dict[str, str]:
        """Column name -> arrow dtype string of a Parquet scan, cached by
        the relation's value."""
        key = scan.relation
        if key not in self._schema_cache:
            if scan.relation.file_paths is not None:
                from hyperspace_tpu_torch.io.parquet import read_schema

                self._schema_cache[key] = read_schema(scan.relation.file_paths[0])
            else:
                self._schema_cache[key] = \
                    self.source_provider_manager.get_relation(scan).schema()
        return self._schema_cache[key]

    def enable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    def optimize(self, plan: LogicalPlan, use_indexes: bool = True) -> LogicalPlan:
        from hyperspace_tpu_torch.index.log_entry import States
        from hyperspace_tpu_torch.plan.pruning import prune_columns
        from hyperspace_tpu_torch.plan.pushdown import push_filters
        from hyperspace_tpu_torch.plan.subquery import rewrite_subqueries
        from hyperspace_tpu_torch.plan.temporal import canonicalize_temporal
        from hyperspace_tpu_torch.rules.bucket_prune import BucketPruneRule
        from hyperspace_tpu_torch.rules.data_skipping import (
            DataSkippingFilterRule,
        )
        from hyperspace_tpu_torch.rules.filter_rule import FilterIndexRule
        from hyperspace_tpu_torch.rules.join_rule import JoinIndexRule

        # The rules swap nodes by identity: a Dataset reused under two
        # branches must not share one node object.
        plan = _uniquify(plan)
        # Subqueries first: folding a scalar and materializing NOT IN
        # optimize and execute their subplans (this method again), and
        # every pass below sees only joins, filters and literals.
        plan = rewrite_subqueries(plan, self)
        plan = push_filters(plan, self.schema_of)
        # year(col) ranges after pushdown: the filter must sit over its
        # scan for the column's type to be known.
        plan = canonicalize_temporal(plan, self.schema_map_of)
        plan = prune_columns(plan, self.schema_of)
        if not (self._hyperspace_enabled and use_indexes):
            return plan
        entries = self.index_collection_manager.get_indexes([States.ACTIVE])
        report.record("indexes.considered", names=[e.name for e in entries])
        for rule in (JoinIndexRule, FilterIndexRule, BucketPruneRule,
                     DataSkippingFilterRule):
            plan = _apply_rule(rule.__name__, rule(self, entries).apply, plan)
        plan = push_filters(plan, self.schema_of)
        return prune_columns(plan, self.schema_of)


def _apply_rule(name: str, apply_fn, plan: LogicalPlan) -> LogicalPlan:
    """Run one rewrite rule and record whether it changed the plan."""
    new_plan = apply_fn(plan)
    report.record("rule", rule=name, applied=new_plan is not plan)
    return new_plan


def _uniquify(plan: LogicalPlan) -> LogicalPlan:
    """The same plan with no node object appearing twice."""
    new_children = tuple(_uniquify(c) for c in plan.children)
    if isinstance(plan, Scan):
        return Scan(plan.relation)
    return plan.with_children(new_children)
