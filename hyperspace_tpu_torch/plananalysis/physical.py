"""Physical-operator analysis for explain (counterpart of
hyperspace_tpu/plananalysis/physical.py).

The executor makes its physical choices at run time; this module
predicts them from the optimized plan with the executor's own
applicability check (``execution.executor.bucketed_join_precheck``), so
the predicted join operator is the one that runs, and it counts each
scan's files and bytes after bucket and sketch pruning (a lake table's
files are its provider's snapshot).  The operator names are the JAX
package's.
"""

from __future__ import annotations

import os
from collections import Counter
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.execution.executor import bucketed_join_precheck
from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.io.files import list_data_files
from hyperspace_tpu_torch.io.parquet import bucket_id_of_file, schema_to_arrow
from hyperspace_tpu_torch.plan.expr import as_equi_join_pairs
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    BucketUnion,
    Compute,
    Distinct,
    Filter,
    InMemory,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    Sort,
    Union,
    WithColumns,
)
from hyperspace_tpu_torch.sources.interfaces import LAKE_DATA_FORMATS


def _scan_detail(session, scan: Scan) -> Tuple[str, str]:
    """(operator name, detail) for a scan: files read / listed and bytes,
    honouring bucket pruning and sketch pruning."""
    rel = scan.relation
    name = "IndexScanExec" if rel.index_scan_of else "FileScanExec"
    target = rel.index_scan_of or ",".join(rel.root_paths)
    if rel.file_paths is not None:
        paths = list(rel.file_paths)
    else:
        try:
            if rel.file_format.lower() in LAKE_DATA_FORMATS:
                # A lake table's files are its snapshot's.
                paths = [f.name for f in session.source_provider_manager
                         .get_relation(scan).all_files()]
            else:
                paths = [f.name for f in list_data_files(rel.root_paths)]
        except OSError:
            return name, target
    total = len(paths)
    if rel.prune_to_buckets is not None:
        wanted = set(rel.prune_to_buckets)
        paths = [p for p in paths
                 if (b := bucket_id_of_file(p)) is None or b in wanted]
    read_bytes = 0
    for p in paths:
        try:
            read_bytes += os.path.getsize(p)
        except OSError:
            pass
    mb = read_bytes / (1024 * 1024)
    stats = rel.data_skipping_stats
    if stats is not None:
        total = max(total, stats[1])
    return name, f"{target}: files {len(paths)}/{total}, {mb:.2f} MB"


def _join_key_types(session, plan: Join):
    """Arrow types of the (single-pair) join keys, resolved against the
    leaf scans' schemas; (None, None) when unresolvable."""
    pairs = as_equi_join_pairs(plan.condition)
    if pairs is None or len(pairs) != 1:
        return None, None
    by_name = {}
    for leaf in plan.leaf_relations():
        try:
            for col, t in session.schema_map_of(leaf).items():
                by_name.setdefault(col.lower(), t)
        except Exception:  # noqa: BLE001 - an unreadable leaf names no type
            continue
    a, b = pairs[0]
    return by_name.get(a.lower()), by_name.get(b.lower())


def _join_operator(session, plan: Join) -> str:
    """The strategy the executor will take, named like Spark's physical
    operators, decided by the executor's own precheck."""
    try:
        if bucketed_join_precheck(session, plan) is not None:
            return "PerBucketMergeJoinExec"  # shuffle-free, bucket-aligned
    except Exception:  # noqa: BLE001 - a failed precheck is no bucketed join
        pass
    pairs = as_equi_join_pairs(plan.condition)
    if pairs is not None and len(pairs) == 1:
        lt, rt = _join_key_types(session, plan)
        if lt is not None and rt is not None:
            try:
                is_num = (columnar.is_numeric_type(
                    schema_to_arrow({"c": lt}).field(0).type)
                    and columnar.is_numeric_type(
                        schema_to_arrow({"c": rt}).field(0).type))
            except Exception:  # noqa: BLE001 - an unknown type is not numeric
                is_num = False
            if is_num:
                return "SortMergeJoinExec"
    return "DigestHashJoinExec"  # composite/string keys (exact, verified)


def physical_operators(session, plan: Optional[LogicalPlan]
                       ) -> Tuple[Counter, List[str]]:
    """(operator counts, per-scan detail lines) for one optimized plan."""
    counts: Counter = Counter()
    details: List[str] = []
    if plan is None:
        return counts, details

    def walk(node: LogicalPlan) -> None:
        if isinstance(node, Scan):
            name, detail = _scan_detail(session, node)
            counts[name] += 1
            details.append(detail)
        elif isinstance(node, Join):
            counts[_join_operator(session, node)] += 1
        elif isinstance(node, Aggregate):
            counts["HashAggregateExec"] += 1
        elif isinstance(node, Distinct):
            counts["DistinctExec"] += 1
        elif isinstance(node, Sort):
            counts["SortExec"] += 1
        elif isinstance(node, Limit):
            counts["LimitExec"] += 1
        elif isinstance(node, Filter):
            counts["FilterExec"] += 1
        elif isinstance(node, Project):
            counts["ProjectExec"] += 1
        elif isinstance(node, (Compute, WithColumns)):
            counts["ProjectExec"] += 1  # computed projection, same phys op
        elif isinstance(node, BucketUnion):
            counts["BucketUnionExec"] += 1
        elif isinstance(node, Union):
            counts["UnionExec"] += 1
        elif isinstance(node, InMemory):
            counts["InMemoryExec"] += 1
        else:
            counts[type(node).__name__] += 1
        for c in node.children:
            walk(c)

    walk(plan)
    return counts, details
