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
the calling thread's last ``Dataset.collect``.

Each rule runs behind the degraded boundary (``_apply_rule_degradable``):
a rule that fails on index metadata or data (a read error, a log entry
that does not decode, a ``HyperspaceError``) costs the query its
acceleration, not its answer.  The plan stays un-rewritten, and the
report records the rule as skipped with its reason and a ``degraded``
decision; with ``conf.degraded_fallback_to_source`` off the error
propagates.  A CUDA or other torch error, and the kernel loader's
``KernelError``, always propagate.

``optimize(..., hypothetical=[...])`` is the advisor's what-if channel
(advisor/hypothetical.py): entries tagged hypothetical are considered
beside the persisted ACTIVE ones for that one pass; the plan is for
analysis only, since the executor refuses its hypothetical scans.

Each optimize pass is an ``optimize`` span and each rule an
``optimize.rule.<slug>`` span with a ``rule.<slug>.applied`` (or
``.skipped``) counter; a skipped rule emits an ``IndexDegradedEvent``
(telemetry/).  A conf with ``fault_injection_enabled`` arms the fault
injector (io/faults.py) and ``event_logger`` installs its event logger
when the session is made.  Not ported: the plan cache."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Union

import torch

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan, ScanRelation
from hyperspace_tpu_torch.sources.manager import FileBasedSourceProviderManager
from hyperspace_tpu_torch.telemetry import metrics, report, trace


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
    """``session.read.parquet(path)``, ``.csv``, ``.json``, ``.orc``,
    ``.avro``, ``.text``, ``.delta``, ``.iceberg`` and
    ``.format(fmt).load(path)``; a path of the plain formats may be a
    glob pattern.  Options ride the relation (``header="false"`` for a
    CSV without a header row, ``versionAsOf`` or ``timestampAsOf`` for a
    Delta table, ``snapshot-id`` or ``as-of-timestamp`` for an Iceberg
    table)."""

    def __init__(self, session: "HyperspaceSession") -> None:
        self._session = session

    def _make(self, fmt: str, *paths: str, **options: str):
        from hyperspace_tpu_torch.dataset import Dataset

        rel = ScanRelation(root_paths=tuple(paths), file_format=fmt,
                           options=tuple(sorted(options.items())))
        return Dataset(Scan(rel), self._session)

    def parquet(self, *paths: str, **options: str):
        return self._make("parquet", *paths, **options)

    def csv(self, *paths: str, **options: str):
        return self._make("csv", *paths, **options)

    def json(self, *paths: str, **options: str):
        return self._make("json", *paths, **options)

    def orc(self, *paths: str, **options: str):
        return self._make("orc", *paths, **options)

    def avro(self, *paths: str, **options: str):
        return self._make("avro", *paths, **options)

    def text(self, *paths: str, **options: str):
        return self._make("text", *paths, **options)

    def delta(self, path: str, **options: str):
        """A Delta table, at its latest version unless ``versionAsOf``
        (a version) or ``timestampAsOf`` (epoch ms or an ISO timestamp)
        travels back."""
        return self._make("delta", path, **options)

    def iceberg(self, path: str, **options: str):
        """An Iceberg table, at its current snapshot unless ``snapshot_id``
        or ``as_of_timestamp`` (epoch ms) travels back; an option's
        underscores become dashes (``snapshot-id``)."""
        renamed = {k.replace("_", "-"): v for k, v in options.items()}
        return self._make("iceberg", path, **renamed)

    def format(self, fmt: str):
        reader = self

        class _FormatReader:
            def load(self, *paths: str, **options: str):
                return reader._make(fmt, *paths, **options)

        return _FormatReader()


class HyperspaceSession:
    def __init__(self, system_path: Optional[str] = None,
                 device: Union[None, str, torch.device] = None,
                 conf: Optional[HyperspaceConf] = None) -> None:
        self.device = resolve_device(device)
        self.conf = conf if conf is not None else HyperspaceConf()
        if system_path is not None:
            self.conf.system_path = system_path
        if self.conf.event_logger:
            from hyperspace_tpu_torch.telemetry.events import (
                apply_conf_event_logger,
            )

            apply_conf_event_logger(self.conf.event_logger)
        if self.conf.fault_injection_enabled:
            from hyperspace_tpu_torch.io import faults

            faults.install_from_conf(self.conf)
        # Tracing and its sink from the conf; collect() applies them again,
        # so a field set later still takes effect.
        trace.configure_from_conf(self.conf)
        # Per-build phase seconds, one dict per CreateAction run.
        self.build_stats_log: List[Dict[str, float]] = []
        # The BuildReport of the last action run with this session.
        self.last_build_report_value = None
        self._hyperspace_enabled = False
        self._schema_cache: Dict[ScanRelation, Dict[str, str]] = {}
        # The executor's stats and the run report of the calling thread's
        # most recent Dataset.collect(): thread-local, so a query on
        # another thread never overwrites what a caller reads right after
        # its own collect().
        self._exec_stats = threading.local()
        self._run_report = threading.local()
        # The lake schemas of one optimize pass (``_lake_schema_memo``),
        # per thread: a pass sees one snapshot of each table.
        self._lake_memo_tls = threading.local()
        # The fleet heartbeat (telemetry/fleet.py) starts here when the
        # conf turns it on, so every process of a fleet shows in
        # fleet_status(); a conf set later goes through
        # Hyperspace.start_fleet_telemetry.  Never raises.
        from hyperspace_tpu_torch.telemetry import fleet

        fleet.maybe_start(self)

    @property
    def _lake_schema_memo(self) -> Optional[Dict[ScanRelation, Dict[str, str]]]:
        return getattr(self._lake_memo_tls, "memo", None)

    @_lake_schema_memo.setter
    def _lake_schema_memo(
            self, value: Optional[Dict[ScanRelation, Dict[str, str]]]) -> None:
        self._lake_memo_tls.memo = value

    @property
    def last_execution_stats(self) -> Optional[Dict[str, List[Dict[str, Any]]]]:
        return getattr(self._exec_stats, "value", None)

    @last_execution_stats.setter
    def last_execution_stats(
            self, value: Optional[Dict[str, List[Dict[str, Any]]]]) -> None:
        self._exec_stats.value = value

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
        # Made per access, so a conf change takes effect; the session
        # rides along for the providers' closest_index.
        return FileBasedSourceProviderManager(self.conf, session=self)

    @property
    def index_collection_manager(self):
        """The manager, its listing cached on the session for
        ``conf.cache_expiry_seconds`` (index/cache.py)."""
        from hyperspace_tpu_torch.index.cache import (
            CachingIndexCollectionManager,
        )

        return CachingIndexCollectionManager(self)

    def schema_of(self, scan: Scan) -> List[str]:
        return list(self.schema_map_of(scan).keys())

    def schema_map_of(self, scan: Scan) -> Dict[str, str]:
        """Column name -> arrow dtype string of a scan, read in its
        format and cached by the relation's value; a hypothetical index
        scan has no file and carries its schema itself.  A lake table's
        (Delta) comes from its provider and is never cached by value: an
        overwrite can change the schema behind the same relation.  Within
        one optimize pass it is memoised (``_lake_schema_memo``).  A scan
        of a file subset (an index scan, a hybrid subset) takes the first
        of its files that answers, read in the physical format, so one
        damaged file fails at execution, where containment takes it, not
        at planning; a source subset also gets the partition columns
        below its root paths."""
        from hyperspace_tpu_torch.sources.interfaces import (
            LAKE_DATA_FORMATS,
            physical_read_format,
        )

        rel = scan.relation
        if rel.hypothetical and rel.hypothetical_schema is not None:
            return dict(rel.hypothetical_schema)
        if rel.file_format.lower() in LAKE_DATA_FORMATS \
                and rel.file_paths is None:
            memo = self._lake_schema_memo
            if memo is None:
                return self.source_provider_manager.get_relation(scan).schema()
            if rel not in memo:
                memo[rel] = \
                    self.source_provider_manager.get_relation(scan).schema()
            return memo[rel]
        if rel not in self._schema_cache:
            if rel.file_paths is not None:
                from hyperspace_tpu_torch.io.parquet import read_schema

                schema = None
                for i, path in enumerate(rel.file_paths):
                    try:
                        schema = read_schema(
                            path, physical_read_format(rel.file_format),
                            rel.options_dict)
                        break
                    except Exception:  # noqa: BLE001 - the next file
                        if i == len(rel.file_paths) - 1:
                            raise
                if rel.index_scan_of is None:
                    from hyperspace_tpu_torch.io.partitions import (
                        partition_spec_for_roots,
                    )

                    for k, t in partition_spec_for_roots(
                            rel.root_paths).items():
                        schema.setdefault(k, t)
                self._schema_cache[rel] = schema
            else:
                self._schema_cache[rel] = \
                    self.source_provider_manager.get_relation(scan).schema()
        return self._schema_cache[rel]

    def enable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = True
        return self

    def disable_hyperspace(self) -> "HyperspaceSession":
        self._hyperspace_enabled = False
        return self

    def is_hyperspace_enabled(self) -> bool:
        return self._hyperspace_enabled

    def optimize(self, plan: LogicalPlan, use_indexes: bool = True,
                 hypothetical=None) -> LogicalPlan:
        # The rules swap nodes by identity: a Dataset reused under two
        # branches must not share one node object.
        plan = _uniquify(plan)
        # Saved and restored, not cleared: a subquery's pass runs inside
        # this one and must leave the outer pass's memo in place.
        prev_memo = self._lake_schema_memo
        self._lake_schema_memo = {}
        try:
            with trace.span("optimize", use_indexes=use_indexes):
                return self._optimize(plan, use_indexes, hypothetical)
        finally:
            self._lake_schema_memo = prev_memo

    def _optimize(self, plan: LogicalPlan, use_indexes: bool,
                  hypothetical) -> LogicalPlan:
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
        entries = [e for e in
                   self.index_collection_manager.get_indexes([States.ACTIVE])
                   if not e.is_hypothetical]
        if hypothetical:
            bad = [e.name for e in hypothetical if not e.is_hypothetical]
            if bad:
                from hyperspace_tpu_torch.exceptions import HyperspaceError

                raise HyperspaceError(
                    f"optimize(hypothetical=...) entries must carry the "
                    f"hypothetical tag; got untagged {bad}: use "
                    f"advisor.hypothetical.hypothetical_entry()")
            entries = entries + list(hypothetical)
        # Listed entries are cached across queries (index/cache.py), and
        # their tags memoize per plan node: each pass starts clean.
        for e in entries:
            e._tags.clear()
        report.record("indexes.considered", names=[e.name for e in entries])
        for rule in (JoinIndexRule, FilterIndexRule, BucketPruneRule,
                     DataSkippingFilterRule):
            plan = self._apply_rule_degradable(
                rule.__name__, rule(self, entries).apply, plan)
        plan = push_filters(plan, self.schema_of)
        return prune_columns(plan, self.schema_of)

    def _apply_rule_degradable(self, name: str, apply_fn,
                               plan: LogicalPlan) -> LogicalPlan:
        """Run one rewrite rule and record its decision: applied, no
        match, or skipped with its reason when it failed on the index's
        side (then the plan comes back un-rewritten, and a ``degraded``
        decision names the rule).  Every other error propagates, and so
        does an ``InjectedCrash``, a ``BaseException``."""
        from hyperspace_tpu_torch.execution.containment import (
            is_index_side_error,
        )

        slug = _rule_slug(name)
        with trace.span(f"optimize.rule.{slug}") as sp:
            try:
                new_plan = apply_fn(plan)
            except Exception as e:  # noqa: BLE001 - narrowed just below
                if not (self.conf.degraded_fallback_to_source
                        and is_index_side_error(e)):
                    raise
                from hyperspace_tpu_torch.telemetry.events import (
                    IndexDegradedEvent,
                    emit_event,
                )

                sp.set(applied=False, skipped=repr(e))
                metrics.inc(f"rule.{slug}.skipped")
                report.record("rule", rule=name, applied=False,
                              skipped_reason=f"{e!r}")
                emit_event(IndexDegradedEvent(
                    reason=f"{name} failed: {e!r}",
                    message=f"{name} skipped; query answers from the "
                            "source scan"))
                return plan
            applied = new_plan is not plan
            sp.set(applied=applied)
            if applied:
                metrics.inc(f"rule.{slug}.applied")
            report.record("rule", rule=name, applied=applied)
            return new_plan


def _rule_slug(rule_name: str) -> str:
    """``FilterIndexRule`` -> ``filter``, ``BucketPruneRule`` ->
    ``bucket_prune``: the metric catalog's name for a rule class."""
    name = rule_name
    for suffix in ("Rule", "Index", "Filter"):
        if name.endswith(suffix) and name != suffix:
            name = name[:-len(suffix)]
    out = []
    for i, ch in enumerate(name):
        if ch.isupper() and i > 0:
            out.append("_")
        out.append(ch.lower())
    return "".join(out)


def _uniquify(plan: LogicalPlan) -> LogicalPlan:
    """The same plan with no node object appearing twice."""
    new_children = tuple(_uniquify(c) for c in plan.children)
    if isinstance(plan, Scan):
        return Scan(plan.relation)
    return plan.with_children(new_children)
