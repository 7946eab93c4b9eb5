"""Subquery rewrites (counterpart of hyperspace_tpu/plan/subquery.py):
scalar folding, IN as a semi join, correlated scalars as an aggregate
and a join, EXISTS as a semi or anti join.

They run at optimize time before every other pass, so pruning, the index
rules and the device routes see only plain joins, filters and literals:

  - An UNCORRELATED ``scalar(sub)``: the subplan is optimized and
    executed once and its one value becomes a literal (0 rows: NULL;
    more than one: an error, as in Spark).  A folded threshold is a
    plain constant, so data skipping, bucket pruning and the device
    predicate serve it.
  - ``in_subquery(col, sub)`` as a top-level conjunct: a SEMI join on
    col == the subquery's one output column.
  - ``~in_subquery(col, sub)``: a NULL-AWARE anti join.  SQL's NOT IN
    is three-valued: any null in the subquery answers no rows, and a
    null probe matches nothing but survives only an empty subquery.
    The subquery is MATERIALIZED once; its null count and row count
    decide the shape (an always-false filter, the filter dropped, or an
    anti join against the ``InMemory`` table with ``probe IS NOT
    NULL``).
  - A CORRELATED ``scalar(sub)`` (``outer_ref`` equality conjuncts under
    a global aggregate): an aggregate by the correlation keys, then an
    INNER join.  That is right because a missing group gives a NULL
    scalar, which drops the row from the comparison anyway (positions
    where NULL could turn TRUE, OR / IS NULL / CASE, are refused); the
    COUNT family LEFT joins and reads a missing group as 0, since SQL's
    count is never NULL.  Only in filter predicates.
  - EXISTS: a correlated one becomes a SEMI join on its equalities
    (``~exists``: ANTI), an inequality correlation riding an equality
    becomes the join's ``residual`` (TPC-H Q21); an uncorrelated one is
    probed once and folds to TRUE or FALSE.

Each optimize() pass folds a given ScalarSubquery object once (shared
nodes share the result), but separate optimize() calls execute subplans
again: a result is never kept across passes, where it could go stale
against the files.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from hyperspace_tpu_torch.plan.expr import (
    And,
    Arith,
    Exists,
    conjoin,
    BinOp,
    Case,
    Cast,
    Col,
    Expr,
    Extract,
    InSubquery,
    IsIn,
    IsNull,
    Lit,
    Neg,
    Not,
    Or,
    OuterRef,
    ScalarSubquery,
    StringFn,
    StringMatch,
    split_conjuncts,
)
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
    Sort,
    Union,
    Window,
)


class SubqueryError(ValueError):
    """Unsupported subquery shape — the message says what to rewrite."""


def _walk_exprs(e: Expr, fn) -> None:
    fn(e)
    for attr in ("left", "right", "child", "otherwise"):
        c = getattr(e, attr, None)
        if isinstance(c, Expr):
            _walk_exprs(c, fn)
    if isinstance(e, StringFn):
        for a in e.args:
            _walk_exprs(a, fn)
    if isinstance(e, Case):
        for c, v in e.branches:
            _walk_exprs(c, fn)
            _walk_exprs(v, fn)


def _contains(e: Expr, kinds) -> bool:
    found = []
    _walk_exprs(e, lambda x: found.append(x) if isinstance(x, kinds) else None)
    return bool(found)


def _plan_has_subqueries(plan: LogicalPlan) -> bool:
    for e in _plan_exprs(plan):
        if _contains(e, (ScalarSubquery, InSubquery, OuterRef, Exists)):
            return True
    return any(_plan_has_subqueries(c) for c in plan.children)


def _plan_exprs(plan: LogicalPlan) -> List[Expr]:
    out: List[Expr] = []
    if isinstance(plan, Filter):
        out.append(plan.condition)
    if isinstance(plan, Join):
        out.append(plan.condition)
    if hasattr(plan, "exprs"):  # Compute / WithColumns
        out += [e for _n, e in plan.exprs]
    if isinstance(plan, Aggregate):
        out += [a for _f, a, _o in plan.aggs if isinstance(a, Expr)]
    return out


def _plan_has_outer_refs(plan: LogicalPlan) -> bool:
    for e in _plan_exprs(plan):
        if _contains(e, OuterRef):
            return True
    return any(_plan_has_outer_refs(c) for c in plan.children)


def _map_expr(e: Expr, fn) -> Expr:
    """Rebuild ``e`` with ``fn`` applied to every node (bottom-up)."""
    if isinstance(e, BinOp):
        return fn(BinOp(e.op, _map_expr(e.left, fn), _map_expr(e.right, fn)))
    if isinstance(e, Arith):
        return fn(Arith(e.op, _map_expr(e.left, fn), _map_expr(e.right, fn)))
    if isinstance(e, And):
        return fn(And(_map_expr(e.left, fn), _map_expr(e.right, fn)))
    if isinstance(e, Or):
        return fn(Or(_map_expr(e.left, fn), _map_expr(e.right, fn)))
    if isinstance(e, Not):
        return fn(Not(_map_expr(e.child, fn)))
    if isinstance(e, Neg):
        return fn(Neg(_map_expr(e.child, fn)))
    if isinstance(e, IsNull):
        return fn(IsNull(_map_expr(e.child, fn)))
    if isinstance(e, IsIn):
        return fn(IsIn(_map_expr(e.child, fn), e.values))
    if isinstance(e, Cast):
        out = Cast(Lit(None), e.type_name)
        out.child = _map_expr(e.child, fn)
        return fn(out)
    if isinstance(e, Extract):
        return fn(Extract(e.field, _map_expr(e.child, fn)))
    if isinstance(e, StringMatch):
        return fn(StringMatch(e.kind, _map_expr(e.child, fn), e.pattern))
    if isinstance(e, StringFn):
        return fn(StringFn(e.name, [_map_expr(a, fn) for a in e.args]))
    if isinstance(e, Case):
        return fn(Case([(_map_expr(c, fn), _map_expr(v, fn))
                        for c, v in e.branches],
                       _map_expr(e.otherwise, fn)))
    return fn(e)


def _const_fold(e: Expr) -> Expr:
    """Collapse literal-only arithmetic left behind by scalar folding
    (``col > lit(7999) - lit(500)`` -> ``col > lit(7499)``) so pruning
    analyses see one plain constant.  Spark semantics: null propagates,
    division is DOUBLE with x/0 -> null."""

    def fold(x: Expr) -> Expr:
        if isinstance(x, Arith) and isinstance(x.left, Lit) \
                and isinstance(x.right, Lit):
            a, b = x.left.value, x.right.value
            if a is None or b is None:
                return Lit(None)
            if not isinstance(a, (int, float)) \
                    or not isinstance(b, (int, float)) \
                    or isinstance(a, bool) or isinstance(b, bool):
                return x
            if x.op == "+":
                return Lit(a + b)
            if x.op == "-":
                return Lit(a - b)
            if x.op == "*":
                return Lit(a * b)
            return Lit(None) if b == 0 else Lit(float(a) / float(b))
        if isinstance(x, Neg) and isinstance(x.child, Lit) \
                and isinstance(x.child.value, (int, float)) \
                and not isinstance(x.child.value, bool):
            return Lit(-x.child.value)
        return x

    return _map_expr(e, fold)


def _fold_scalar_memo(sq: "ScalarSubquery", session, state) -> Lit:
    """Per-pass memo: one execution per ScalarSubquery OBJECT within a
    single rewrite pass (shared nodes share the result); the object is
    pinned in the state so its id cannot be recycled mid-pass."""
    lit = state["folds"].get(id(sq))
    if lit is None:
        lit = _fold_scalar(sq.plan, session)
        state["folds"][id(sq)] = lit
        state["refs"].append(sq)
    return lit


def _fold_scalar(sub: LogicalPlan, session) -> Lit:
    """Execute an uncorrelated scalar subplan once; fold to a literal."""
    from hyperspace_tpu_torch.execution.executor import Executor

    table = Executor(session).execute(session.optimize(sub))
    if table.num_columns != 1:
        raise SubqueryError(
            f"Scalar subquery must produce exactly one column, got "
            f"{table.column_names}")
    if table.num_rows > 1:
        raise SubqueryError(
            f"Scalar subquery returned {table.num_rows} rows; at most one "
            f"is allowed")
    if table.num_rows == 0:
        return Lit(None)
    return Lit(table.column(0)[0].as_py())


def _simplify_exists(plan: LogicalPlan):
    """Existence-simplify an EXISTS subplan top-down.  Returns one of
    ("always", None)  — the subplan yields >=1 row for EVERY outer row
                        (a global aggregate always emits exactly one),
    ("empty", None)   — it can never yield a row (LIMIT 0),
    ("plan", p)       — check existence of ``p``.
    Shedding rules: Project/Compute/Sort shape columns or order only;
    DISTINCT preserves existence; LIMIT n>=1 preserves PER-OUTER-ROW
    existence (SQL's common ``EXISTS (... LIMIT 1)`` idiom — the limit
    applies to each outer row's subquery result, so dropping it is the
    only sound rewrite; keeping it would cap the whole inner table);
    a GROUPED aggregate emits >=1 group iff its input has >=1 row."""
    while True:
        if isinstance(plan, (Project, Compute, Sort, Distinct, Window)):
            # A TOP-level Window only appends a column: existence-safe
            # to shed (filters over its outputs below stay barriers).
            plan = plan.child
            continue
        if isinstance(plan, Limit):
            if plan.n <= 0:
                return ("empty", None)
            plan = plan.child
            continue
        if isinstance(plan, Aggregate):
            if not plan.group_by:
                return ("always", None)
            plan = plan.child
            continue
        return ("plan", plan)


def _split_correlations(plan: LogicalPlan, residuals=None):
    """Remove ``inner == outer_ref`` conjuncts from the Filters of a
    subplan chain; returns (new_plan, [(outer_name, inner_name)]).

    When ``residuals`` (a list) is given, NON-equality correlated
    conjuncts (``inner <> outer_ref``, ``inner < outer_ref`` — TPC-H
    Q21's literal EXISTS shape) are collected into it instead of
    raising, provided every inner column they reference hoists cleanly
    past the intervening Computes; the caller turns them into a
    residual join predicate."""
    pairs: List[Tuple[str, str]] = []
    trapped: List[str] = []

    def passes_computes(col_name: str, computes) -> bool:
        """A correlation column may hoist across a Compute/WithColumns
        only when the node passes it through UNCHANGED — a redefining
        entry would make the hoisted join condition bind to recomputed
        values; a Compute (which keeps ONLY its entries) must list an
        identity entry, while WithColumns passes unlisted columns
        through implicitly."""
        from hyperspace_tpu_torch.plan.nodes import WithColumns

        for comp in computes:
            entry = next((e for name, e in comp.exprs
                          if name == col_name), None)
            if entry is not None:
                if not (isinstance(entry, Col) and entry.name == col_name):
                    return False  # redefined
            elif not isinstance(comp, WithColumns):
                return False  # Compute drops unlisted columns
        return True

    def strip(node: LogicalPlan, computes) -> LogicalPlan:
        # HOIST BARRIERS: a correlation conjunct below a row-count-
        # changing node (or a non-inner join's unsafe side) cannot move
        # into the join condition — removing it there would change what
        # the upper node sees.  Leftover outer_refs below a barrier are
        # caught by the callers' _plan_has_outer_refs check and raise a
        # clean SubqueryError instead of silently changing answers.
        # Window included: its analytic values (rank, running sums) are
        # computed over the subquery's rows, so a correlation hoisted
        # above one would change them.
        if isinstance(node, (Limit, Distinct, Aggregate, Union,
                             BucketUnion, Window)):
            return node
        if isinstance(node, Join) and node.how != "inner":
            return node
        from hyperspace_tpu_torch.plan.nodes import WithColumns

        if isinstance(node, (Compute, WithColumns)):
            # Transparent per-column: hoisting decisions below consult
            # the identity check above.
            computes = computes + [node]
        children = tuple(strip(c, computes) for c in node.children)
        node = node.with_children(children)
        if not isinstance(node, Filter):
            return node
        keep = []
        for conj in split_conjuncts(node.condition):
            corr = _as_correlation(conj)
            if corr is not None and passes_computes(corr[1], computes):
                pairs.append(corr)
            else:
                if _contains(conj, OuterRef):
                    if corr is not None:
                        trapped.append(corr[1])
                        keep.append(conj)  # redefining Compute above ->
                        continue           # specific error at the caller
                    if residuals is not None:
                        inner_refs = conj.referenced_columns()
                        if all(passes_computes(c, computes)
                               for c in inner_refs):
                            residuals.append(conj)
                            continue
                        trapped.extend(sorted(inner_refs))
                        keep.append(conj)
                        continue
                    raise SubqueryError(
                        f"Correlated subquery predicates must be "
                        f"inner_col == outer_ref(...) equality conjuncts; "
                        f"got {conj!r}")
                keep.append(conj)
        if not keep:
            return node.child
        return Filter(conjoin(keep), node.child)

    return strip(plan, []), pairs, trapped


def _as_correlation(conj: Expr) -> Optional[Tuple[str, str]]:
    if isinstance(conj, BinOp) and conj.op == "==":
        if isinstance(conj.left, Col) and isinstance(conj.right, OuterRef):
            return (conj.right.name, conj.left.name)
        if isinstance(conj.right, Col) and isinstance(conj.left, OuterRef):
            return (conj.left.name, conj.right.name)
    return None


def _null_rejecting_path(e: Expr, target: Expr) -> bool:
    """True when every ancestor of ``target`` inside ``e`` propagates a
    NULL operand to a not-TRUE result (BinOp/Arith/Neg/Not/And/IsIn/
    Cast/StringMatch all do).  Or, IsNull, and Case can turn the NULL of
    a missing correlation group into TRUE — under those, the inner-join
    rewrite would silently drop rows SQL keeps, so the caller must
    reject instead."""
    if e is target:
        return True
    nullable_safe = (BinOp, Arith, Neg, Not, And, IsIn, Cast, StringMatch,
                     Extract)
    for attr in ("left", "right", "child", "otherwise"):
        c = getattr(e, attr, None)
        if isinstance(c, Expr) and _subtree_has(c, target):
            return isinstance(e, nullable_safe) \
                and _null_rejecting_path(c, target)
    if isinstance(e, Case):
        for cond, v in e.branches:
            if _subtree_has(cond, target) or _subtree_has(v, target):
                return False
    return False


def _subtree_has(e: Expr, target: Expr) -> bool:
    found = []
    _walk_exprs(e, lambda x: found.append(x) if x is target else None)
    return bool(found)


def _rewrite_correlated_scalar(outer: LogicalPlan, pred: Expr,
                               sq: ScalarSubquery,
                               session, state) -> LogicalPlan:
    """Filter(pred(sq)) over ``outer`` -> Project(outer cols)(
    Filter(pred')(outer JOIN sub-aggregated-by-correlation-keys))."""
    sub = sq.plan
    # Post-aggregate scalar arithmetic (TPC-DS q1's
    # ``SELECT avg(x) * 1.2``): a single-output Compute over the
    # aggregate folds into the comparison after the hoist.
    post = None
    if isinstance(sub, Compute) and len(sub.exprs) == 1 \
            and isinstance(sub.child, Aggregate):
        post = sub.exprs[0]
        sub = sub.child
        agg_out = sub.aggs[0][2] if len(sub.aggs) == 1 else None
        if agg_out is None or not (
                post[1].referenced_columns() <= {agg_out}):
            raise SubqueryError(
                "A correlated scalar subquery's computed output may "
                "only reference its own aggregate")
    count_like = (isinstance(sub, Aggregate) and len(sub.aggs) == 1
                  and sub.aggs[0][0] in ("count", "count_all",
                                         "count_distinct"))
    if not count_like and not _null_rejecting_path(pred, sq):
        raise SubqueryError(
            "A correlated scalar subquery under OR / IS NULL / CASE is "
            "unsupported: a missing correlation group yields NULL, and "
            "those operators can turn NULL into TRUE — the inner-join "
            "rewrite would drop rows SQL keeps.  Restructure so the "
            "scalar comparison is its own AND conjunct")
    if not isinstance(sub, Aggregate) or sub.group_by \
            or len(sub.aggs) != 1:
        raise SubqueryError(
            "A correlated scalar subquery must be a single global "
            "aggregate (agg(out=(input, func))) over filters containing "
            "inner_col == outer_ref(...) conjuncts — the TPC-DS q1 shape")
    stripped, pairs, trapped = _split_correlations(sub.child)
    if trapped:
        raise SubqueryError(
            f"Correlation column(s) {sorted(set(trapped))} are redefined "
            f"by an intervening select()/with_column() inside the "
            f"subquery; keep them passed through unchanged")
    if not pairs:
        raise SubqueryError(
            "Correlated scalar subquery has no outer_ref equality "
            "conjunct; use an uncorrelated scalar() instead")
    if _plan_has_outer_refs(stripped):
        raise SubqueryError(
            "outer_ref outside a Filter equality conjunct is unsupported")
    missing = {i for _o, i in pairs} - set(
        stripped.output_columns(session.schema_of))
    if missing:
        raise SubqueryError(
            f"Correlated scalar subquery projects away its correlation "
            f"column(s) {sorted(missing)}; keep them visible")
    k = state["n"]
    state["n"] += 1
    func, agg_in, out_name = sub.aggs[0]
    inner_cols = [i for _o, i in pairs]
    agged = Aggregate(inner_cols, [(func, agg_in, out_name)], stripped)
    fresh_agg = f"__sq{k}_agg"
    renames = [(f"__sq{k}_c{j}", Col(i)) for j, (_o, i) in enumerate(pairs)]
    renamed = Compute(renames + [(fresh_agg, Col(out_name))], agged)
    cond = None
    for j, (o, _i) in enumerate(pairs):
        eq = BinOp("==", Col(o), Col(f"__sq{k}_c{j}"))
        cond = eq if cond is None else And(cond, eq)
    if count_like:
        # SQL's COUNT over an empty correlated group is 0, not NULL: an
        # inner join would silently drop exactly those outer rows, so
        # count-family scalars LEFT join and coalesce the miss to 0.
        joined = Join(outer, renamed, cond, "left")
        replacement: Expr = Case([(IsNull(Col(fresh_agg)), Lit(0))],
                                 Col(fresh_agg))
    else:
        joined = Join(outer, renamed, cond, "inner")
        replacement = Col(fresh_agg)
    if post is not None:
        base = replacement
        replacement = _map_expr(
            post[1], lambda e: base
            if isinstance(e, Col) and e.name == out_name else e)
    new_pred = _map_expr(pred, lambda e: replacement if e is sq else e)
    outer_cols = outer.output_columns(session.schema_of)
    return Project(list(outer_cols), Filter(new_pred, joined))


def _single_output_column(plan: LogicalPlan, session) -> str:
    cols = plan.output_columns(session.schema_of)
    if len(cols) != 1:
        raise SubqueryError(
            f"IN-subquery must produce exactly one column, got {cols}")
    return cols[0]


def _rewrite_filter(node: Filter, session, state) -> LogicalPlan:
    """Rewrite ONE subquery construct in ``node``; caller loops."""
    conjuncts = split_conjuncts(node.condition)

    def rebuild(remaining: List[Expr], child: LogicalPlan) -> LogicalPlan:
        if not remaining:
            return child
        return Filter(conjoin(remaining), child)

    for idx, conj in enumerate(conjuncts):
        rest = conjuncts[:idx] + conjuncts[idx + 1:]
        if isinstance(conj, InSubquery):
            if not isinstance(conj.child, Col):
                raise SubqueryError(
                    f"IN-subquery left side must be a column, got "
                    f"{conj.child!r}")
            if _plan_has_outer_refs(conj.plan):
                raise SubqueryError(
                    "Correlated IN-subqueries are unsupported; use a "
                    "semi join with the correlation as the join condition")
            sub_col = _single_output_column(conj.plan, session)
            # Residual conjuncts reference only the outer child's columns
            # (they came from the same Filter), so they push BELOW the
            # join — keeping them in the Filter-over-scan shape the index
            # rules pattern-match.
            return Join(rebuild(rest, node.child), conj.plan,
                        BinOp("==", conj.child, Col(sub_col)), "semi")
        if isinstance(conj, Exists) or (
                isinstance(conj, Not) and isinstance(conj.child, Exists)):
            negated = isinstance(conj, Not)
            ex = conj.child if negated else conj
            kind, simplified = _simplify_exists(ex.plan)
            if kind == "always":
                # A global aggregate yields exactly one row per outer
                # row: EXISTS is TRUE (NOT EXISTS FALSE), correlated or
                # not.
                if negated:
                    return rebuild(rest + [Lit(False)], node.child)
                return rebuild(rest, node.child)
            if kind == "empty":
                if negated:
                    return rebuild(rest, node.child)
                return rebuild(rest + [Lit(False)], node.child)
            residuals: List[Expr] = []
            stripped, pairs, trapped = _split_correlations(simplified,
                                                           residuals)
            if trapped:
                raise SubqueryError(
                    f"Correlation column(s) {sorted(set(trapped))} are "
                    f"redefined by an intervening select()/with_column() "
                    f"inside the EXISTS subquery; keep them passed "
                    f"through unchanged")
            if _plan_has_outer_refs(stripped):
                raise SubqueryError(
                    "EXISTS correlation must be conjuncts over "
                    "outer_ref() in the subquery's filters")
            if residuals and not pairs:
                raise SubqueryError(
                    "EXISTS with only non-equality correlations needs "
                    "at least one inner == outer_ref equality conjunct "
                    "(pure nested-loop existence is unsupported)")
            if not pairs:
                # Uncorrelated: existence is one probe, folded here.
                from hyperspace_tpu_torch.execution.executor import Executor

                any_row = Executor(session).execute(
                    session.optimize(Limit(1, stripped))).num_rows > 0
                if any_row != negated:
                    return rebuild(rest, node.child)  # always TRUE
                return rebuild(rest + [Lit(False)], node.child)
            inner_cols = [i for _o, i in pairs]
            res_refs = sorted({c for r in residuals
                               for c in r.referenced_columns()})
            needed = sorted(set(inner_cols) | set(res_refs))
            missing = set(needed) - set(
                stripped.output_columns(session.schema_of))
            if missing:
                raise SubqueryError(
                    f"EXISTS correlation column(s) {sorted(missing)} are "
                    f"projected away inside the subquery; keep them "
                    f"visible (or drop the intermediate projection)")
            if not residuals:
                cond = conjoin([BinOp("==", Col(o), Col(i))
                                for o, i in pairs])
                # Only existence matters: project the sub to the
                # correlation columns (its own SELECT list — often
                # `SELECT 1` — is shed).
                sub_side = Project(sorted(set(inner_cols)), stripped)
                return Join(rebuild(rest, node.child), sub_side, cond,
                            "anti" if negated else "semi")
            # Inequality correlations (TPC-H Q21's literal EXISTS:
            # l2.l_suppkey <> l1.l_suppkey riding the l_orderkey
            # equality): the inner side's columns rename to fresh names
            # (self-joins share spellings), the equality pairs become
            # the semi/anti join keys, and the non-equality conjuncts
            # follow as a RESIDUAL predicate over matched pairs.
            k = state["n"]
            state["n"] += 1
            ren = {c: f"__sq{k}_{c}" for c in needed}
            sub_side = Compute([(ren[c], Col(c)) for c in needed],
                               stripped)
            cond = conjoin([BinOp("==", Col(o), Col(ren[i]))
                            for o, i in pairs])

            def bind(e: Expr) -> Expr:
                if isinstance(e, OuterRef):
                    return Col(e.name)
                if isinstance(e, Col):
                    return Col(ren[e.name])
                return e

            residual = conjoin([_map_expr(r, bind) for r in residuals])
            return Join(rebuild(rest, node.child), sub_side, cond,
                        "anti" if negated else "semi",
                        residual=residual)
        if isinstance(conj, Not) and isinstance(conj.child, InSubquery):
            inq = conj.child
            if not isinstance(inq.child, Col):
                raise SubqueryError(
                    f"NOT IN subquery left side must be a column, got "
                    f"{inq.child!r}")
            if _plan_has_outer_refs(inq.plan):
                raise SubqueryError("Correlated NOT IN is unsupported")
            _single_output_column(inq.plan, session)
            # Materialize the subquery ONCE (index rewrites applied by the
            # nested optimize); the null/empty decisions and the anti join
            # all read the same table instead of re-executing the subplan.
            from hyperspace_tpu_torch.execution.executor import Executor
            from hyperspace_tpu_torch.plan.nodes import InMemory

            table = Executor(session).execute(session.optimize(inq.plan))
            if table.column(0).null_count > 0:
                # Any null in the subquery: NOT IN never holds (3VL).
                return rebuild(rest + [Lit(False)], node.child)
            if table.num_rows == 0:
                # Empty subquery: vacuously true for EVERY probe row,
                # null probes included — drop the conjunct.
                return rebuild(rest, node.child)
            # A null probe matches nothing in the anti join (kept), but
            # SQL says null NOT IN (non-empty) is NULL -> dropped; the
            # IS NOT NULL guard pushes below with the residuals.
            return Join(
                rebuild(rest + [Not(IsNull(inq.child))], node.child),
                InMemory(table),
                BinOp("==", inq.child, Col(table.column_names[0])), "anti")
        # Correlated or foldable scalar subqueries inside this conjunct.
        found: List[ScalarSubquery] = []
        _walk_exprs(conj, lambda e: found.append(e)
                    if isinstance(e, ScalarSubquery) else None)
        for sq in found:
            if _plan_has_outer_refs(sq.plan):
                # Residual conjuncts push below the generated join.
                return _rewrite_correlated_scalar(
                    rebuild(rest, node.child), conj, sq, session, state)
            lit = _fold_scalar_memo(sq, session, state)
            new_conj = _const_fold(
                _map_expr(conj, lambda e: lit if e is sq else e))
            return rebuild(conjuncts[:idx] + [new_conj]
                           + conjuncts[idx + 1:], node.child)
        if isinstance(conj, (ScalarSubquery,)) or _contains(
                conj, (InSubquery, Exists)):
            raise SubqueryError(
                f"Unsupported subquery position: {conj!r} (IN/EXISTS "
                f"subqueries must be top-level conjuncts, possibly under "
                f"NOT)")
    return node


def rewrite_subqueries(plan: LogicalPlan, session,
                       _state: Optional[dict] = None) -> LogicalPlan:
    """Eliminate every subquery construct from ``plan`` (bottom-up)."""
    state = _state if _state is not None else {
        "n": 0, "folds": {}, "refs": []}
    if _state is None and not _plan_has_subqueries(plan):
        return plan  # common case: zero overhead beyond one walk
    children = tuple(rewrite_subqueries(c, session, state)
                     for c in plan.children)
    plan = plan.with_children(children)
    if isinstance(plan, Filter):
        # Loop: each pass eliminates one construct and may leave more.
        for _ in range(64):
            out = _rewrite_filter(plan, session, state)
            if out is plan:
                return plan
            out = rewrite_subqueries(out, session, state)
            if not isinstance(out, Filter):
                return out
            plan = out
        raise SubqueryError("Subquery rewrite did not converge")
    # Everywhere else (Compute, aggregate inputs, join conditions):
    # uncorrelated scalars fold; anything needing a join is unsupported.
    for e in _plan_exprs(plan):
        if _contains(e, (InSubquery, OuterRef, Exists)):
            raise SubqueryError(
                f"Subqueries are supported in filter() predicates only; "
                f"found one inside {type(plan).__name__}")
    if isinstance(plan, Compute):
        new_exprs = []
        changed = False
        for name, e in plan.exprs:
            if _contains(e, ScalarSubquery):
                folds = {}

                def fold_once(x, folds=folds):
                    # Explicit membership check: setdefault would evaluate
                    # (and so EXECUTE) the subquery once per occurrence of
                    # a shared node.
                    if isinstance(x, ScalarSubquery) and id(x) not in folds:
                        folds[id(x)] = _fold_scalar_memo(x, session, state)

                _walk_exprs(e, fold_once)
                e = _map_expr(e, lambda x: folds[id(x)]
                              if isinstance(x, ScalarSubquery) else x)
                changed = True
            new_exprs.append((name, e))
        if changed:
            return Compute(new_exprs, plan.child)
    else:
        for e in _plan_exprs(plan):
            if _contains(e, ScalarSubquery):
                raise SubqueryError(
                    f"Scalar subqueries are supported in filter() and "
                    f"select() expressions only; found one inside "
                    f"{type(plan).__name__}")
    return plan
