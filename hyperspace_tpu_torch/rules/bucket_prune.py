"""BucketPruneRule (counterpart of hyperspace_tpu/rules/bucket_prune.py):
bucket pruning for index scans the join rule rewrote.

The filter rule prunes buckets while it rewrites a Filter over a Scan,
but it skips a scan the join rule already rewrote, so a point filter on
a join side would read every bucket.  This pass runs after the rewrite
rules and gives any ``Filter -> [Project] -> bucketed index Scan`` whose
predicate pins every indexed column a ``prune_to_buckets`` set, with the
filter rule's own ``_bucket_pruning``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project, Scan


class BucketPruneRule:
    def __init__(self, session, entries: List[IndexLogEntry]) -> None:
        self.session = session
        self._by_name = {e.name.lower(): e for e in entries}

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        from hyperspace_tpu_torch.rules.filter_rule import _bucket_pruning

        def visit(node: LogicalPlan) -> LogicalPlan:
            if not isinstance(node, Filter):
                return node
            scan, wrap = _index_scan_below(node.children[0])
            if scan is None:
                return node
            rel = scan.relation
            if rel.prune_to_buckets is not None:
                # Already pruned by the filter rule from this condition.
                return node
            entry = self._by_name.get((rel.index_scan_of or "").lower())
            if entry is None:
                return node
            prune = _bucket_pruning(node.condition, entry)
            if prune is None:
                return node
            new_scan = Scan(dataclasses.replace(rel, prune_to_buckets=prune))
            child = new_scan if wrap is None else wrap.with_children((new_scan,))
            return Filter(node.condition, child)

        return plan.transform_up(visit)


def _index_scan_below(node: LogicalPlan):
    """(scan, wrapping Project or None) when ``node`` is an index scan with
    a bucket spec, optionally under one pruning Project."""
    wrap: Optional[Project] = None
    if isinstance(node, Project):
        wrap, node = node, node.children[0]
    if (isinstance(node, Scan) and node.relation.index_scan_of
            and node.relation.bucket_spec):
        return node, wrap
    return None, None
