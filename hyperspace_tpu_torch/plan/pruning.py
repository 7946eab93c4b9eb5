"""Column pruning (counterpart of hyperspace_tpu/plan/pruning.py): push
minimal Projects down to each
relation, so a join side asks only for the columns it needs (which lets
a covering index apply) and scans read only those columns.

Top-down: track the columns each subtree must produce and insert a
Project directly above a Scan that yields more.  The root's output is
never changed."""

from __future__ import annotations

from typing import List, Optional, Set

from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    BucketUnion,
    Compute,
    Distinct,
    Filter,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    SetOp,
    Sort,
    Union,
    Window,
    WithColumns,
)
from hyperspace_tpu_torch.utils.resolver import resolve


def prune_columns(plan: LogicalPlan, schema_of) -> LogicalPlan:
    """``schema_of(scan)`` resolves leaf schemas."""
    return _prune(plan, None, schema_of)


def _prune(plan: LogicalPlan, required: Optional[Set[str]],
           schema_of) -> LogicalPlan:
    if isinstance(plan, Project):
        # Narrowed to the parent's needs first.
        cols = plan.columns
        if required is not None:
            narrowed = [c for c in cols if c in required]
            if not narrowed and cols:
                narrowed = [cols[0]]  # keep one column for the row count
            cols = narrowed
        new_child = _prune(plan.child, set(cols), schema_of)
        # Collapse Project(A, Project(B, x)) when A is within B, so the
        # pass is idempotent and scans stay one Project away.
        if isinstance(new_child, Project) \
                and set(cols) <= set(new_child.columns):
            new_child = new_child.child
        if new_child is not plan.child or cols != plan.columns:
            return Project(cols, new_child)
        return plan
    if isinstance(plan, Compute):
        # Like a Project: its subtree must produce the columns its
        # expressions read.
        new_child = _prune(plan.child, set(plan.input_columns()), schema_of)
        if new_child is not plan.child:
            return Compute(plan.exprs, new_child)
        return plan
    if isinstance(plan, WithColumns):
        # A computed column nothing above requires is dropped (its inputs
        # would otherwise survive pruning for a discarded value); the
        # kept ones' inputs and the parent's other needs flow down.
        if required is None:
            keep = plan.exprs
        else:
            keep = tuple((n, e) for n, e in plan.exprs if n in required)
        expr_refs: Set[str] = set()
        for _n, e in keep:
            expr_refs |= e.referenced_columns()
        child_required = None if required is None else (
            (required - {n for n, _e in keep}) | expr_refs)
        new_child = _prune(plan.child, child_required, schema_of)
        if not keep:
            return new_child
        # Lengths, not tuples, compare: == on an Expr builds a BinOp.
        if new_child is not plan.child or len(keep) != len(plan.exprs):
            return WithColumns(keep, new_child)
        return plan
    if isinstance(plan, Window):
        if required is not None and plan.name not in required:
            # Nothing above reads the analytic column: drop the node.
            return _prune(plan.child, required, schema_of)
        refs = set(plan.partition_by) | {c for c, _a in plan.order_by}
        if plan.value:
            refs.add(plan.value)
        child_required = None if required is None else (
            (required - {plan.name}) | refs)
        new_child = _prune(plan.child, child_required, schema_of)
        if new_child is not plan.child:
            return plan.with_children((new_child,))
        return plan
    if isinstance(plan, Aggregate):
        # Like a Project, an Aggregate defines what its subtree must
        # produce: the group keys and the aggregated inputs (count_all's
        # empty input is no column; an expression gives its columns).
        child_required = set(plan.group_by) | set(plan.input_columns())
        new_child = _prune(plan.child, child_required, schema_of)
        if new_child is not plan.child:
            return Aggregate(plan.group_by, plan.aggs, new_child)
        return plan
    if isinstance(plan, Filter):
        child_required = None if required is None else (
            required | set(plan.condition.referenced_columns()))
        new_child = _prune(plan.child, child_required, schema_of)
        if new_child is not plan.child:
            return Filter(plan.condition, new_child)
        return plan
    if isinstance(plan, Sort):
        child_required = None if required is None else (
            required | {c for c, _asc in plan.keys})
        new_child = _prune(plan.child, child_required, schema_of)
        if new_child is not plan.child:
            return Sort(plan.keys, new_child)
        return plan
    if isinstance(plan, Limit):
        new_child = _prune(plan.child, required, schema_of)
        if new_child is not plan.child:
            return Limit(plan.n, new_child)
        return plan
    if isinstance(plan, Distinct):
        # DISTINCT compares whole rows: narrowing its child would change
        # the row multiplicity.
        new_child = _prune(plan.child, None, schema_of)
        if new_child is not plan.child:
            return Distinct(new_child)
        return plan
    if isinstance(plan, SetOp):
        # Set operations compare whole rows on both sides.
        new_left = _prune(plan.left, None, schema_of)
        new_right = _prune(plan.right, None, schema_of)
        if new_left is not plan.left or new_right is not plan.right:
            return SetOp(plan.kind, new_left, new_right)
        return plan
    if isinstance(plan, Join):
        cond_cols = set(plan.condition.referenced_columns())
        if plan.residual is not None:
            # The residual reads both sides' columns over matched pairs.
            cond_cols |= set(plan.residual.referenced_columns())
        left_schema = plan.left.output_columns(schema_of)
        right_schema = plan.right.output_columns(schema_of)
        if required is None:
            side_requireds = [None, None]  # the root keeps every column
            if plan.how in ("semi", "anti"):
                # Existence joins emit no right-side column.
                side_requireds[1] = {
                    c for c in cond_cols
                    if resolve([c], right_schema) is not None}
        else:
            side_requireds = [set(), set()]
            for c in required | cond_cols:
                on_left = resolve([c], left_schema) is not None
                on_right = resolve([c], right_schema) is not None
                if not on_left and not on_right:
                    # Unresolvable: leave both sides alone and let
                    # execution raise the real error.
                    side_requireds = [None, None]
                    break
                if on_left:
                    side_requireds[0].add(c)
                if on_right:
                    side_requireds[1].add(c)
        sides = []
        changed = False
        for side, side_required in zip((plan.left, plan.right), side_requireds):
            new_side = _prune(side, side_required, schema_of)
            changed = changed or new_side is not side
            sides.append(new_side)
        if changed:
            return Join(sides[0], sides[1], plan.condition, plan.how,
                        residual=plan.residual)
        return plan
    if isinstance(plan, (BucketUnion, Union)):
        new_children = tuple(_prune(c, required, schema_of)
                             for c in plan.children)
        if any(n is not o for n, o in zip(new_children, plan.children)):
            return plan.with_children(new_children)
        return plan
    if isinstance(plan, Scan):
        if required is None:
            return plan
        schema = plan.output_columns(schema_of)
        if not required and schema:
            required = {schema[0]}
        resolved = resolve(sorted(required), schema)
        if resolved is None:
            return plan
        if len(set(resolved)) >= len(schema):
            return plan
        # Schema order keeps the projected output deterministic.
        keep: List[str] = [c for c in schema if c in set(resolved)]
        return Project(keep, plan)
    return plan
