"""Filter pushdown (counterpart of hyperspace_tpu/plan/pushdown.py):
WHERE conjuncts sink below joins and projects, so the index rules find
each filter sitting on the scan it constrains.

Rules, applied to fixpoint:
  - Filter over Filter: merge into one conjunction (order kept).
  - Filter over Project: swap when every referenced column survives the
    projection.
  - Filter over Join: each conjunct moves to the side that resolves ALL
    its columns; the left side wins a name both sides have (the joined
    table shows the left copy under that name).  Inner joins push to
    either side; semi, anti and left joins to the left only; right joins
    to the right only; full joins keep the filter above.  Constant and
    cross-side conjuncts stay above the join.
"""

from __future__ import annotations

from typing import Callable, List

from hyperspace_tpu_torch.plan.expr import And, Expr, conjoin, split_conjuncts
from hyperspace_tpu_torch.plan.nodes import Filter, Join, LogicalPlan, Project
from hyperspace_tpu_torch.utils.resolver import resolve


def push_filters(plan: LogicalPlan, schema_of: Callable) -> LogicalPlan:
    """Sink every Filter as far down as the rules above allow."""
    children = tuple(push_filters(c, schema_of) for c in plan.children)
    plan = plan.with_children(children)
    if not isinstance(plan, Filter):
        return plan
    return _push_one(plan, schema_of)


def _push_one(node: Filter, schema_of: Callable) -> LogicalPlan:
    child = node.child
    if isinstance(child, Filter):
        merged = Filter(And(node.condition, child.condition), child.child)
        return _push_one(merged, schema_of)
    if isinstance(child, Project):
        refs = node.condition.referenced_columns()
        if refs and refs <= set(child.columns):
            below = _push_one(Filter(node.condition, child.child), schema_of)
            return Project(child.columns, below)
        return node
    if isinstance(child, Join):
        sides = _pushable_sides(child.how)
        if sides == (False, False):
            return node
        left_cols = child.left.output_columns(schema_of)
        right_cols = child.right.output_columns(schema_of)
        left_pushed: List[Expr] = []
        right_pushed: List[Expr] = []
        kept: List[Expr] = []
        for conj in split_conjuncts(node.condition):
            refs = sorted(conj.referenced_columns())
            if not refs:
                kept.append(conj)
            elif sides[0] and resolve(refs, left_cols) is not None:
                left_pushed.append(conj)
            elif sides[1] and resolve(refs, right_cols) is not None \
                    and (sides[0] or resolve(refs, left_cols) is None):
                # A right join pushes right only, and never a name that
                # also resolves on the left: the joined output binds it
                # to the left copy.
                right_pushed.append(conj)
            else:
                kept.append(conj)
        if not left_pushed and not right_pushed:
            return node
        new_left = child.left
        if left_pushed:
            new_left = _push_one(Filter(conjoin(left_pushed), new_left),
                                 schema_of)
        new_right = child.right
        if right_pushed:
            new_right = _push_one(Filter(conjoin(right_pushed), new_right),
                                  schema_of)
        out: LogicalPlan = Join(new_left, new_right, child.condition,
                                child.how, residual=child.residual)
        if kept:
            out = Filter(conjoin(kept), out)
        return out
    return node


def _pushable_sides(how: str):
    if how == "inner":
        return (True, True)
    if how in ("semi", "anti", "left"):
        return (True, False)
    if how == "right":
        return (False, True)
    return (False, False)
