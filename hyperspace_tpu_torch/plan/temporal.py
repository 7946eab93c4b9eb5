"""Temporal predicate canonicalization (counterpart of
hyperspace_tpu/plan/temporal.py): ``year(col) CMP lit`` becomes a range.

An ``Extract`` is opaque to every pruning analysis (data-skipping
sketches, bucket pruning, Z-order) and to the device predicate; a range
over the column itself serves all of them:

    year(c) == 1994  ->  (c >= 1994-01-01) & (c < 1995-01-01)
    year(c) >= 1994  ->   c >= 1994-01-01
    year(c) >  1994  ->   c >= 1995-01-01
    year(c) <= 1994  ->   c <  1995-01-01
    year(c) <  1994  ->   c <  1994-01-01

Null semantics are preserved: a null date nulls the extraction (row
drops) exactly as it nulls the range comparison.  The rewrite fires only
when the column resolves to a temporal-typed SCAN column — on anything
else (or for month/day/quarter, which do not map to one contiguous
range) the Extract stays and evaluates host-side.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, Optional

from hyperspace_tpu_torch.plan.expr import (
    And,
    BinOp,
    Col,
    Expr,
    Extract,
    IsIn,
    Lit,
    Not,
    Or,
)
from hyperspace_tpu_torch.plan.nodes import (
    Filter,
    LogicalPlan,
    Project,
    Scan,
)

_TEMPORAL_PREFIXES = ("date32", "date64", "timestamp")


def _rewritable_type(type_str: str) -> bool:
    """Date/timestamp WITHOUT a timezone.  pc.year on a tz-aware column
    extracts in LOCAL time, while range boundaries built here compare on
    the UTC epoch — rewriting would silently move rows near midnight
    New Year across years.  Tz-aware columns keep the host Extract."""
    s = str(type_str)
    return s.startswith(_TEMPORAL_PREFIXES) and "tz=" not in s


def _scan_types(plan: LogicalPlan,
                schema_map_of: Callable) -> Optional[Dict[str, str]]:
    """The type map of the Scan under a chain of row-preserving,
    column-passthrough nodes (Filter/Project), else None.  Compute &
    friends rename or derive columns, so the mapping would be unsound."""
    node = plan
    while isinstance(node, (Filter, Project)):
        node = node.child
    if isinstance(node, Scan):
        return schema_map_of(node)
    return None


def _year_range(op: str, y: int):
    if not 1 <= y <= 9998:
        # datetime.date's domain is year 1..9999 (and == / <= need y+1);
        # out-of-range literals keep the host Extract, which evaluates
        # them to an empty (or full) match without crashing optimize().
        return None
    start = datetime.date(y, 1, 1)
    if op == "==":
        return start, datetime.date(y + 1, 1, 1)
    if op == ">=":
        return start, None
    if op == ">":
        return datetime.date(y + 1, 1, 1), None
    if op == "<=":
        return None, datetime.date(y + 1, 1, 1)
    if op == "<":
        return None, start
    return None  # pragma: no cover — BinOp.OPS is closed


def _rewrite_expr(e: Expr, types: Dict[str, str]) -> Expr:
    if isinstance(e, BinOp):
        sides = ((e.left, e.right, e.op),
                 # Mirrored literal-first form: 1994 <= year(c).
                 (e.right, e.left, {"<": ">", "<=": ">=", ">": "<",
                                    ">=": "<=", "==": "=="}[e.op]))
        for ext, other, op in sides:
            if (isinstance(ext, Extract) and ext.field == "year"
                    and isinstance(ext.child, Col)
                    and isinstance(other, Lit)
                    and isinstance(other.value, int)
                    and not isinstance(other.value, bool)
                    and _rewritable_type(types.get(ext.child.name, ""))):
                rng = _year_range(op, other.value)
                if rng is None:
                    break
                lo, hi = rng
                c = ext.child
                if lo is not None and hi is not None:
                    return And(BinOp(">=", c, Lit(lo)),
                               BinOp("<", c, Lit(hi)))
                if lo is not None:
                    return BinOp(">=", c, Lit(lo))
                return BinOp("<", c, Lit(hi))
        return e
    if isinstance(e, And):
        return And(_rewrite_expr(e.left, types), _rewrite_expr(e.right, types))
    if isinstance(e, Or):
        return Or(_rewrite_expr(e.left, types), _rewrite_expr(e.right, types))
    if isinstance(e, Not):
        return Not(_rewrite_expr(e.child, types))
    if isinstance(e, IsIn) and isinstance(e.child, Extract) \
            and e.child.field == "year" and isinstance(e.child.child, Col) \
            and _rewritable_type(types.get(e.child.child.name, "")) \
            and e.values \
            and all(isinstance(v, int) and not isinstance(v, bool)
                    and 1 <= v <= 9998 for v in e.values):
        # year(c) IN (1994, 1996) -> OR of year ranges.  Pruning analyses
        # handle OR-of-ranges; a null date still drops either way.
        out = None
        for v in sorted(set(e.values)):
            lo, hi = _year_range("==", v)
            rng = And(BinOp(">=", e.child.child, Lit(lo)),
                      BinOp("<", e.child.child, Lit(hi)))
            out = rng if out is None else Or(out, rng)
        return out
    return e


def canonicalize_temporal(plan: LogicalPlan,
                          schema_map_of: Callable) -> LogicalPlan:
    """Rewrite every Filter condition in ``plan`` (bottom-up)."""
    children = tuple(canonicalize_temporal(c, schema_map_of)
                     for c in plan.children)
    plan = plan.with_children(children)
    if isinstance(plan, Filter):
        types = _scan_types(plan.child, schema_map_of)
        if types:
            new_cond = _rewrite_expr(plan.condition, types)
            if new_cond is not plan.condition:
                return Filter(new_cond, plan.child)
    return plan
