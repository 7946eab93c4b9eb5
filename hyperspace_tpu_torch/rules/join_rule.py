"""JoinIndexRule (counterpart of hyperspace_tpu/rules/join_rule.py):
rewrite both sides of an inner equi-join to bucketed index scans, so the
executor joins bucket by bucket.

  - applicability: an inner join whose condition is a conjunction of
    column == column equalities, each side a linear plan over one
    supported relation, every equality spanning the two sides one to one;
  - index choice: per side, the indexed columns equal that side's join
    keys (as sets) and the index covers the side's required columns; a
    left and a right index pair up when their indexed-column orders match
    through the key mapping; ``rankers.rank_join_index_pairs`` picks one;
  - rewrite: both scans become index scans WITH the bucket spec; under
    hybrid scan a side whose source changed becomes a ``BucketUnion`` of
    the index and its appended files (``rules.hybrid``), whose rows the
    executor routes into the index's buckets.  An index with any
    quarantined file is no join candidate: the source branch of its
    damaged buckets has no bucket structure to align (the filter rule
    still serves it with containment).

Each rewrite emits a ``HyperspaceIndexUsageEvent`` (telemetry/events.py),
which records the index as used in the active run report.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.plan.expr import Expr, as_equi_join_pairs
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    Compute,
    Filter,
    Join,
    LogicalPlan,
    WithColumns,
)
from hyperspace_tpu_torch.rules import rule_utils
from hyperspace_tpu_torch.rules.rankers import rank_join_index_pairs
from hyperspace_tpu_torch.telemetry.events import (
    HyperspaceIndexUsageEvent,
    emit_event,
)
from hyperspace_tpu_torch.utils.resolver import resolve


class JoinIndexRule:
    def __init__(self, session, entries: Optional[List[IndexLogEntry]] = None) -> None:
        self.session = session
        self._entries = entries

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        if isinstance(plan, Join):
            rewritten = self._try_rewrite(plan)
            if rewritten is not None:
                return rewritten
        new_children = tuple(self.apply(c) for c in plan.children)
        if new_children != plan.children:
            return plan.with_children(new_children)
        return plan

    def _try_rewrite(self, join: Join) -> Optional[LogicalPlan]:
        spm = self.session.source_provider_manager
        if join.how != "inner":
            return None
        pairs = as_equi_join_pairs(join.condition)
        if not pairs:
            return None
        if not (join.left.is_linear() and join.right.is_linear()):
            return None
        left_leaves = join.left.leaf_relations()
        right_leaves = join.right.leaf_relations()
        if len(left_leaves) != 1 or len(right_leaves) != 1:
            return None
        l_scan, r_scan = left_leaves[0], right_leaves[0]
        if rule_utils.is_index_applied(l_scan) or rule_utils.is_index_applied(r_scan):
            return None
        if not (spm.is_supported_relation(l_scan) and spm.is_supported_relation(r_scan)):
            return None

        l_schema = self.session.schema_of(l_scan)
        r_schema = self.session.schema_of(r_scan)
        # Orient every pair as (left column, right column), one to one.
        l_keys: List[str] = []
        r_keys: List[str] = []
        for a, b in pairs:
            if resolve([a], l_schema) and resolve([b], r_schema):
                l_keys.append(a)
                r_keys.append(b)
            elif resolve([b], l_schema) and resolve([a], r_schema):
                l_keys.append(b)
                r_keys.append(a)
            else:
                return None
        l_map: Dict[str, str] = {}
        r_map: Dict[str, str] = {}
        for lk, rk in zip(l_keys, r_keys):
            lk_l, rk_l = lk.lower(), rk.lower()
            if l_map.get(lk_l, rk_l) != rk_l or r_map.get(rk_l, lk_l) != lk_l:
                return None  # one column equated to two on the other side
            l_map[lk_l] = rk_l
            r_map[rk_l] = lk_l

        entries = self._entries
        if entries is None:
            entries = self.session.index_collection_manager.get_indexes(
                [States.ACTIVE])
        from hyperspace_tpu_torch.rules.hybrid import quarantined_split

        def candidates(scan):
            return [e for e in rule_utils.get_candidate_indexes(
                        self.session, entries, scan)
                    if not quarantined_split(self.session, e)[0]]

        l_usable = _usable_indexes(candidates(l_scan), l_keys,
                                   self._required_columns(join.left))
        r_usable = _usable_indexes(candidates(r_scan), r_keys,
                                   self._required_columns(join.right))
        hybrid = self.session.conf.hybrid_scan_enabled
        best = rank_join_index_pairs(
            _compatible_pairs(l_usable, r_usable, l_keys, r_keys),
            l_scan, r_scan, hybrid)
        if best is None:
            return None
        l_entry, r_entry = best

        def rewrite_side(side_plan, scan, entry):
            if hybrid:
                from hyperspace_tpu_torch.rules.hybrid import (
                    hybrid_file_lists,
                    transform_plan_to_use_hybrid_scan,
                )

                appended, deleted = hybrid_file_lists(entry, scan)
                if appended or deleted:
                    return transform_plan_to_use_hybrid_scan(
                        self.session, side_plan, scan, entry, bucket_union=True)
            return rule_utils.transform_plan_to_use_index_only_scan(
                side_plan, scan, entry, use_bucket_spec=True)

        new_plan = Join(rewrite_side(join.left, l_scan, l_entry),
                        rewrite_side(join.right, r_scan, r_entry),
                        join.condition, join.how, residual=join.residual)
        emit_event(HyperspaceIndexUsageEvent(
            index_names=[l_entry.name, r_entry.name],
            plan_before=Join(join.left, join.right, join.condition,
                             join.how).tree_string(),
            plan_after=new_plan.tree_string(),
            message="JoinIndexRule applied"))
        return new_plan

    def _required_columns(self, side_plan: LogicalPlan) -> List[str]:
        """The source columns a side must provide: its output plus the
        columns its filters read.  A computed column (a Compute's or
        WithColumns' expression, an aggregate's output) needed above is
        replaced by the columns its expression or input reads, since the
        computation runs above the scan; group keys pass through."""
        needed: Set[str] = set(side_plan.output_columns(self.session.schema_of))

        def walk(node: LogicalPlan) -> None:
            if isinstance(node, Filter):
                needed.update(node.condition.referenced_columns())
            elif isinstance(node, (Compute, WithColumns)):
                for name, e in node.exprs:
                    if name in needed:
                        needed.discard(name)
                        needed.update(e.referenced_columns())
            elif isinstance(node, Aggregate):
                for _func, agg_in, out in node.aggs:
                    if out in needed:
                        needed.discard(out)
                        if isinstance(agg_in, Expr):
                            needed.update(agg_in.referenced_columns())
                        elif agg_in:
                            needed.add(agg_in)
                needed.update(node.group_by)
            for c in node.children:
                walk(c)

        walk(side_plan)
        return sorted(needed)


def _usable_indexes(candidates: List[IndexLogEntry], keys: List[str],
                    required: List[str]) -> List[IndexLogEntry]:
    """Indexed columns equal the join keys (as sets) and every required
    column is covered."""
    keyset = {k.lower() for k in keys}
    req = {c.lower() for c in required}
    return [e for e in candidates
            if {c.lower() for c in e.indexed_columns} == keyset
            and req <= {c.lower() for c in e.derived_dataset.all_columns}]


def _compatible_pairs(left: List[IndexLogEntry], right: List[IndexLogEntry],
                      l_keys: List[str], r_keys: List[str]
                      ) -> List[Tuple[IndexLogEntry, IndexLogEntry]]:
    """Index pairs whose indexed-column orders agree through the join-key
    mapping."""
    key_map = {lk.lower(): rk.lower() for lk, rk in zip(l_keys, r_keys)}
    out = []
    for le in left:
        expected_right_order = [key_map[c.lower()] for c in le.indexed_columns]
        for re in right:
            if [c.lower() for c in re.indexed_columns] == expected_right_order:
                out.append((le, re))
    return out
