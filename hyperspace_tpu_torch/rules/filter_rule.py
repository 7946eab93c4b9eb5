"""FilterIndexRule (counterpart of hyperspace_tpu/rules/filter_rule.py):
rewrite Filter[->Project] over a Scan to an index-only scan.

  - pattern: a Filter directly over a supported Scan (seeing through one
    pruning Project), optionally under a Project;
  - applicability: the index's FIRST indexed column appears in the
    predicate (ANY indexed column for a Z-order index, whose files are
    narrow on every indexed dimension), and the index covers the filter
    and output columns;
  - rewrite: swap the scan; when the predicate pins every indexed column
    to a finite set (equality, IN, or an OR of those), the buckets those
    values hash to are computed with ``ops.hash.bucket_ids_np`` (the
    build kernel's bit-equal host mirror) and only their files are read.
    Under hybrid scan an index whose source changed is swapped in as the
    index merged with the appended files (``rules.hybrid``), and an index
    with quarantined buckets as the index without them merged with their
    rows read from the source; the bucket pruning applies to its index
    part.  Otherwise the index files whose
    per-file min/max (the ``_sketch.parquet`` each build version writes)
    cannot satisfy the predicate are dropped too
    (``rules.data_skipping.prune_index_files_by_sketch``).

Each rewrite emits a ``HyperspaceIndexUsageEvent`` (telemetry/events.py),
which records the index as used in the active run report.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.plan.expr import BinOp, Col, Expr, IsIn, Lit, Or, split_conjuncts
from hyperspace_tpu_torch.plan.nodes import Filter, LogicalPlan, Project, Scan
from hyperspace_tpu_torch.rules import rule_utils
from hyperspace_tpu_torch.rules.rankers import rank_filter_indexes
from hyperspace_tpu_torch.telemetry.events import (
    HyperspaceIndexUsageEvent,
    emit_event,
)
from hyperspace_tpu_torch.utils.resolver import resolve


class FilterIndexRule:
    def __init__(self, session, entries: Optional[List[IndexLogEntry]] = None) -> None:
        self.session = session
        self._entries = entries

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        """Rewrite every matching site.  One forward pass suffices:
        ``transform_up`` keeps untouched subtrees' identities, so later
        matches still find their nodes in the rewritten plan."""
        for matched in _extract_filter_nodes(plan):
            new_plan = self._try_rewrite(plan, matched)
            if new_plan is not None:
                plan = new_plan
        return plan

    def _try_rewrite(self, plan: LogicalPlan, matched) -> Optional[LogicalPlan]:
        scan, filter_node, project_cols = matched
        if rule_utils.is_index_applied(scan):
            return None
        if not self.session.source_provider_manager.is_supported_relation(scan):
            return None
        schema = self.session.schema_of(scan)
        filter_cols = sorted(filter_node.condition.referenced_columns())
        output_cols = project_cols if project_cols is not None else schema
        if resolve(filter_cols, schema) is None:
            return None
        entries = self._entries
        if entries is None:
            entries = self.session.index_collection_manager.get_indexes(
                [States.ACTIVE])
        candidates = rule_utils.get_candidate_indexes(self.session, entries, scan)
        hybrid = self.session.conf.hybrid_scan_enabled
        best = rank_filter_indexes(
            _find_covering_indexes(candidates, filter_cols, output_cols),
            scan, hybrid, filter_cols=filter_cols)
        if best is None:
            return None
        prune = _bucket_pruning(filter_node.condition, best)
        from hyperspace_tpu_torch.rules.hybrid import (
            hybrid_file_lists,
            quarantined_split,
            transform_plan_to_use_hybrid_scan,
        )

        changed = hybrid and any(hybrid_file_lists(best, scan))
        # Quarantined buckets take the hybrid transform even on an exact
        # signature match: the index side drops them and a BucketIn
        # branch reads their rows from the source.
        if changed or quarantined_split(self.session, best)[1]:
            new_plan = transform_plan_to_use_hybrid_scan(
                self.session, plan, scan, best, bucket_union=False,
                prune_to_buckets=prune)
        else:
            use_bucket_spec = (self.session.conf.filter_rule_use_bucket_spec
                               or prune is not None)
            from hyperspace_tpu_torch.rules.data_skipping import (
                prune_index_files_by_sketch,
            )

            pruned = prune_index_files_by_sketch(best, filter_node.condition)
            file_paths, file_stats = (None, None) if pruned is None \
                else (pruned[0], (len(pruned[0]), pruned[1]))
            new_plan = rule_utils.transform_plan_to_use_index_only_scan(
                plan, scan, best, use_bucket_spec, prune, file_paths,
                file_stats)
        emit_event(HyperspaceIndexUsageEvent(
            index_names=[best.name],
            plan_before=plan.tree_string(),
            plan_after=new_plan.tree_string(),
            message="FilterIndexRule applied"))
        return new_plan


def _extract_filter_nodes(plan: LogicalPlan
                          ) -> List[Tuple[Scan, Filter, Optional[List[str]]]]:
    """Every Project(Filter(Scan)) / Filter(Scan) match in the plan,
    seeing through a pruning Project directly over the Scan."""
    out: List[Tuple[Scan, Filter, Optional[List[str]]]] = []
    claimed: Optional[LogicalPlan] = None  # matched under a Project
    if isinstance(plan, Project) and isinstance(plan.child, Filter):
        scan = _scan_below(plan.child.child)
        if scan is not None:
            out.append((scan, plan.child, list(plan.columns)))
            claimed = plan.child
    elif isinstance(plan, Filter):
        scan = _scan_below(plan.child)
        if scan is not None:
            # With no outer Project, the pruning Project (if any) defines
            # the output columns.
            cols = list(plan.child.columns) \
                if isinstance(plan.child, Project) else None
            out.append((scan, plan, cols))
    for child in plan.children:
        if child is claimed:
            for sub in child.children:
                out.extend(_extract_filter_nodes(sub))
        else:
            out.extend(_extract_filter_nodes(child))
    return out


def _scan_below(node: LogicalPlan) -> Optional[Scan]:
    """The scan at ``node``, unwrapping at most one pruning Project."""
    if isinstance(node, Scan):
        return node
    if isinstance(node, Project) and isinstance(node.child, Scan):
        return node.child
    return None


def _find_covering_indexes(candidates: Sequence[IndexLogEntry],
                           filter_cols: List[str],
                           output_cols: List[str]) -> List[IndexLogEntry]:
    """The first indexed column is in the predicate, and the index holds
    the filter and output columns (case-insensitive).  A Z-order index
    needs ANY indexed column in the predicate: its Morton clustering
    makes the per-file pruning work on every indexed dimension, where
    lexicographic data clusters the first column alone."""
    filter_set = {c.lower() for c in filter_cols}
    needed = filter_set | {c.lower() for c in output_cols}
    out = []
    for entry in candidates:
        if entry.derived_dataset.properties.get("layout") == "zorder":
            if not filter_set & {c.lower() for c in entry.indexed_columns}:
                continue
        elif entry.indexed_columns[0].lower() not in filter_set:
            continue
        if needed <= {c.lower() for c in entry.derived_dataset.all_columns}:
            out.append(entry)
    return out


def _pinned_values(e: Expr) -> Optional[Tuple[str, set]]:
    """(column, finite value set) when ``e`` pins one column: an
    equality, an IN list, or an OR of those over the same column."""
    if isinstance(e, BinOp) and e.op == "==":
        if isinstance(e.left, Col) and isinstance(e.right, Lit):
            return e.left.name.lower(), {e.right.value}
        if isinstance(e.right, Col) and isinstance(e.left, Lit):
            return e.right.name.lower(), {e.left.value}
        return None
    if isinstance(e, IsIn) and isinstance(e.child, Col):
        return e.child.name.lower(), set(e.values)
    if isinstance(e, Or):
        left = _pinned_values(e.left)
        right = _pinned_values(e.right)
        if left is not None and right is not None and left[0] == right[0]:
            return left[0], left[1] | right[1]
    return None


def _bucket_pruning(condition: Expr, entry: IndexLogEntry
                    ) -> Optional[Tuple[int, ...]]:
    """The buckets that can hold matching rows, or None when the
    predicate does not pin every indexed column by top-level conjuncts
    (or pins more than 1024 value combinations)."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io.columnar import to_hash_words
    from hyperspace_tpu_torch.io.parquet import schema_to_arrow
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    pinned: dict = {}
    for conj in split_conjuncts(condition):
        hit = _pinned_values(conj)
        if hit is not None:
            name, values = hit
            pinned.setdefault(name, set()).update(values)
    indexed = [c.lower() for c in entry.indexed_columns]
    if not all(c in pinned for c in indexed):
        return None
    value_sets = [sorted(pinned[c], key=repr) for c in indexed]
    n_combos = 1
    for vs in value_sets:
        n_combos *= len(vs)
    if n_combos == 0 or n_combos > 1024:
        return None
    # Literals hash as the indexed column's stored type: an int literal
    # probing a float64 column must hash the bits the build hashed.
    types = {f.name.lower(): f.type
             for f in schema_to_arrow(entry.derived_dataset.schema)}
    combos = list(itertools.product(*value_sets))
    word_cols = []
    for i, name in enumerate(indexed):
        try:
            values = pa.array([c[i] for c in combos], type=types.get(name))
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            return None  # a literal the column type cannot hold
        word_cols.append(to_hash_words(values))
    buckets = bucket_ids_np([np.asarray(w) for w in word_cols], entry.num_buckets)
    return tuple(sorted(set(int(b) for b in buckets)))
