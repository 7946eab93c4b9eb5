"""Logical plan nodes (counterpart of hyperspace_tpu/plan/nodes.py):
``Scan``, ``Filter``, ``Project``, ``Join``, ``Aggregate``, ``Sort``,
``Limit``, ``InMemory``, the hybrid-scan merges ``BucketUnion`` and
``Union``, and the analytic operators ``Compute``, ``Window``,
``WithColumns``, ``Distinct`` and ``SetOp``.  A plan is a small immutable tree; the rules
rewrite it with ``transform_up``/``with_children``.  Class names are part
of the plan signature, so they match the JAX package's, and
``tree_string`` prints a plan as the JAX package does."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.plan.expr import Col as ColRef, Expr


@dataclasses.dataclass(frozen=True)
class ScanRelation:
    """Where and how to read a relation's data.

    ``index_scan_of`` marks a scan already rewritten to an index (so no
    rule applies twice); ``bucket_spec`` is (num_buckets, bucket columns,
    sort columns) of bucketed index data; ``file_paths``, when set,
    replaces the listing of ``root_paths``; ``prune_to_buckets`` keeps
    only the index files of those buckets.  ``data_skipping_of`` names
    the data-skipping index that pruned a source scan's file list, and
    ``data_skipping_stats`` is (files kept, files in all) of a scan whose
    files a sketch pruned.  ``hypothetical`` marks a scan rewritten onto
    a what-if index (advisor/hypothetical.py): it has no file, the
    executor refuses it, and ``hypothetical_schema`` ((column, dtype)
    pairs) stands in for the footer it lacks."""

    root_paths: Tuple[str, ...]
    file_format: str = "parquet"
    options: Tuple[Tuple[str, str], ...] = ()
    index_scan_of: Optional[str] = None
    bucket_spec: Optional[Tuple[int, Tuple[str, ...], Tuple[str, ...]]] = None
    file_paths: Optional[Tuple[str, ...]] = None
    prune_to_buckets: Optional[Tuple[int, ...]] = None
    data_skipping_of: Optional[str] = None
    data_skipping_stats: Optional[Tuple[int, int]] = None
    hypothetical: bool = False
    hypothetical_schema: Optional[Tuple[Tuple[str, str], ...]] = None

    @property
    def options_dict(self) -> Dict[str, str]:
        return dict(self.options)


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def leaf_relations(self) -> List["Scan"]:
        if isinstance(self, Scan):
            return [self]
        out: List[Scan] = []
        for c in self.children:
            out.extend(c.leaf_relations())
        return out

    def is_linear(self) -> bool:
        """True if no node has more than one child."""
        if len(self.children) > 1:
            return False
        return all(c.is_linear() for c in self.children)

    def output_columns(self, schema_of) -> List[str]:
        """Columns this plan produces; ``schema_of(scan)`` resolves leaf
        schemas."""
        raise NotImplementedError

    def transform_up(self, fn) -> "LogicalPlan":
        new_children = tuple(c.transform_up(fn) for c in self.children)
        node = self.with_children(new_children) \
            if new_children != self.children else self
        return fn(node)

    def with_children(self, children: Tuple["LogicalPlan", ...]) -> "LogicalPlan":
        raise NotImplementedError

    def simple_string(self) -> str:
        raise NotImplementedError

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.simple_string()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)


class Scan(LogicalPlan):
    def __init__(self, relation: ScanRelation) -> None:
        self.relation = relation
        self.children = ()

    def output_columns(self, schema_of) -> List[str]:
        return schema_of(self)

    def with_children(self, children) -> "Scan":
        assert not children
        return self

    def simple_string(self) -> str:
        rel = self.relation
        if rel.index_scan_of:
            tag = f"Hyperspace(Type: CI, Name: {rel.index_scan_of})"
            if rel.prune_to_buckets is not None:
                tag += (f" [buckets: {len(rel.prune_to_buckets)}"
                        f"/{rel.bucket_spec[0]}]")
            if rel.data_skipping_stats is not None:
                kept, total = rel.data_skipping_stats
                tag += f" [files: {kept}/{total}]"
            return f"Scan {tag}"
        base = f"Scan {','.join(rel.root_paths)} ({rel.file_format})"
        if rel.data_skipping_of:
            tag = f"Hyperspace(Type: DS, Name: {rel.data_skipping_of})"
            if rel.data_skipping_stats is not None:
                kept, total = rel.data_skipping_stats
                tag += f" [files: {kept}/{total}]"
            return f"{base} {tag}"
        return base


class Filter(LogicalPlan):
    def __init__(self, condition: Expr, child: LogicalPlan) -> None:
        self.condition = condition
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        return self.child.output_columns(schema_of)

    def with_children(self, children) -> "Filter":
        (child,) = children
        return Filter(self.condition, child)

    def simple_string(self) -> str:
        return f"Filter {self.condition!r}"


class Project(LogicalPlan):
    def __init__(self, columns: Sequence[str], child: LogicalPlan) -> None:
        self.columns = list(columns)
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        return list(self.columns)

    def with_children(self, children) -> "Project":
        (child,) = children
        return Project(self.columns, child)

    def simple_string(self) -> str:
        return f"Project [{', '.join(self.columns)}]"


class Compute(LogicalPlan):
    """A projection by expressions: the output is exactly ``exprs``,
    (name, Expr) pairs, a passthrough column being ``(name, Col(name))``.
    The rules never match a Compute; pruning asks its child for the
    columns its expressions read, so a plain Project lands over the scan
    below and the rules match that."""

    def __init__(self, exprs: Sequence[Tuple[str, Expr]],
                 child: LogicalPlan) -> None:
        if not exprs:
            raise ValueError("Compute needs at least one output expression")
        names = [n for n, _ in exprs]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate output names in select: {names}")
        self.exprs = tuple((n, e) for n, e in exprs)
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def input_columns(self) -> List[str]:
        out: set = set()
        for _n, e in self.exprs:
            out |= e.referenced_columns()
        return sorted(out)

    def output_columns(self, schema_of) -> List[str]:
        return [n for n, _e in self.exprs]

    def with_children(self, children) -> "Compute":
        (child,) = children
        return Compute(self.exprs, child)

    def simple_string(self) -> str:
        parts = []
        for n, e in self.exprs:
            if isinstance(e, ColRef) and e.name == n:
                parts.append(n)
            else:
                parts.append(f"{e!r} AS {n}")
        return f"Compute [{', '.join(parts)}]"


class Window(LogicalPlan):
    """One analytic column, ``func(value) OVER (PARTITION BY keys ORDER
    BY keys [ROWS frame])``, appended to the child's output (replacing a
    column of the same name).

    Spark's semantics:
      - row_number, rank, dense_rank and ntile need an ORDER BY; their
        results are int32;
      - an aggregate (sum, min, max, mean, count) without an ORDER BY
        reduces the whole partition; with one it runs over the default
        RANGE frame (UNBOUNDED PRECEDING to CURRENT ROW), so rows tied on
        the order keys share one value;
      - lag and lead shift ``value`` by ``offset`` rows inside the
        partition (null outside it); ntile's tile count is ``offset``;
      - ``frame`` is an explicit ROWS frame (lo, hi) of row offsets
        (None: unbounded) for an aggregate, first_value or last_value;
      - the order keys sort nulls first ascending and last descending.
    """

    RANKING = ("row_number", "rank", "dense_rank", "ntile")
    AGGREGATES = ("sum", "min", "max", "mean", "count")
    SHIFTS = ("lag", "lead")
    POSITIONAL = ("first_value", "last_value")

    def __init__(self, name: str, func: str, value: Optional[str],
                 partition_by: Sequence[str],
                 order_by: Sequence[Tuple[str, bool]],
                 child: LogicalPlan, offset: int = 1,
                 frame: Optional[Tuple[Optional[int],
                                       Optional[int]]] = None) -> None:
        all_funcs = (self.RANKING + self.AGGREGATES + self.SHIFTS
                     + self.POSITIONAL)
        if func not in all_funcs:
            raise ValueError(
                f"Unsupported window function {func!r}; one of "
                f"{all_funcs}")
        if func in self.RANKING + self.SHIFTS and not order_by:
            raise ValueError(f"{func}() requires an ORDER BY")
        if func in self.RANKING and func != "ntile" and value is not None:
            raise ValueError(f"{func}() takes no value column")
        if func in self.AGGREGATES and func != "count" and value is None:
            raise ValueError(f"window {func}() needs a value column")
        if func in self.SHIFTS:
            if value is None:
                raise ValueError(f"{func}() needs a value column")
            if not isinstance(offset, int) or offset < 0:
                raise ValueError(f"{func}() offset must be a "
                                 f"non-negative int, got {offset!r}")
        if func == "ntile":
            if not isinstance(offset, int) or offset < 1:
                raise ValueError(f"ntile(n) needs a positive integer "
                                 f"tile count, got {offset!r}")
            if value is not None:
                raise ValueError("ntile() takes no value column")
        if func in self.POSITIONAL and value is None:
            raise ValueError(f"{func}() needs a value column")
        if frame is not None:
            if func not in self.AGGREGATES + self.POSITIONAL:
                raise ValueError(
                    f"A ROWS frame only applies to aggregate/"
                    f"first_value/last_value windows, not {func}()")
            if not order_by:
                raise ValueError("A ROWS frame requires an ORDER BY")
            lo, hi = frame
            for b in (lo, hi):
                if b is not None and not isinstance(b, int):
                    raise ValueError(f"Frame bounds must be ints or "
                                     f"None (unbounded), got {b!r}")
            if lo is not None and hi is not None and lo > hi:
                raise ValueError(
                    f"Frame lower bound {lo} is above upper bound {hi}")
            frame = (lo, hi)
        self.name = name
        self.func = func
        self.value = value
        self.offset = int(offset)
        self.frame = frame
        self.partition_by = tuple(partition_by)
        self.order_by = tuple((c, bool(a)) for c, a in order_by)
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        base = self.child.output_columns(schema_of)
        return list(base) + ([self.name] if self.name not in base else [])

    def with_children(self, children) -> "Window":
        (child,) = children
        return Window(self.name, self.func, self.value, self.partition_by,
                      self.order_by, child, offset=self.offset,
                      frame=self.frame)

    @staticmethod
    def _bound_string(off: Optional[int], upper: bool) -> str:
        if off is None:
            return ("UNBOUNDED FOLLOWING" if upper
                    else "UNBOUNDED PRECEDING")
        if off == 0:
            return "CURRENT ROW"
        return (f"{off} FOLLOWING" if off > 0
                else f"{-off} PRECEDING")

    def simple_string(self) -> str:
        arg = self.value or ""
        if self.func in self.SHIFTS:
            arg = f"{arg}, {self.offset}"
        elif self.func == "ntile":
            arg = str(self.offset)
        over = []
        if self.partition_by:
            over.append(f"PARTITION BY {', '.join(self.partition_by)}")
        if self.order_by:
            keys = ", ".join(f"{c}{'' if a else ' DESC'}"
                             for c, a in self.order_by)
            over.append(f"ORDER BY {keys}")
        if self.frame is not None:
            lo, hi = self.frame
            over.append(f"ROWS BETWEEN {self._bound_string(lo, False)} "
                        f"AND {self._bound_string(hi, True)}")
        return (f"Window {self.name} := {self.func}({arg}) "
                f"OVER ({' '.join(over)})")


class WithColumns(LogicalPlan):
    """The child's output with computed columns appended, or replacing
    the columns of the same names (``ds.with_column``)."""

    def __init__(self, exprs: Sequence[Tuple[str, Expr]],
                 child: LogicalPlan) -> None:
        if not exprs:
            raise ValueError("with_column needs at least one expression")
        names = [n for n, _ in exprs]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate with_column names: {names}")
        self.exprs = tuple((n, e) for n, e in exprs)
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        base = self.child.output_columns(schema_of)
        new = [n for n, _e in self.exprs if n not in base]
        return list(base) + new

    def with_children(self, children) -> "WithColumns":
        (child,) = children
        return WithColumns(self.exprs, child)

    def simple_string(self) -> str:
        parts = ", ".join(f"{n} := {e!r}" for n, e in self.exprs)
        return f"WithColumns [{parts}]"


class Join(LogicalPlan):
    """Equi-join of any SQL join type.  The join index rule rewrites
    inner equi-joins only; index scans under any type still run bucket
    by bucket.

    ``residual`` is a predicate over the matched pairs, applied after the
    equi match and before the join type shapes the output (null: no
    match).  Only the subquery rewrite makes one, for an inequality
    correlation (TPC-H Q21's ``l2.l_suppkey <> l1.l_suppkey`` riding the
    ``l_orderkey`` equality); ``Dataset.join`` stays equi-only."""

    HOW = ("inner", "left", "right", "full", "semi", "anti")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 condition: Expr, how: str = "inner",
                 residual: Optional[Expr] = None) -> None:
        if how not in self.HOW:
            raise ValueError(f"Unsupported join type {how!r}; "
                             f"expected one of {self.HOW}")
        self.condition = condition
        self.how = how
        self.residual = residual
        self.children = (left, right)

    @property
    def left(self) -> LogicalPlan:
        return self.children[0]

    @property
    def right(self) -> LogicalPlan:
        return self.children[1]

    def output_columns(self, schema_of) -> List[str]:
        if self.how in ("semi", "anti"):
            return self.left.output_columns(schema_of)
        return (self.left.output_columns(schema_of)
                + self.right.output_columns(schema_of))

    def with_children(self, children) -> "Join":
        left, right = children
        return Join(left, right, self.condition, self.how,
                    residual=self.residual)

    def simple_string(self) -> str:
        if self.residual is not None:
            return (f"Join {self.how} on {self.condition!r} "
                    f"residual {self.residual!r}")
        return f"Join {self.how} on {self.condition!r}"


class Distinct(LogicalPlan):
    """The distinct rows of the child's whole output (SQL DISTINCT)."""

    def __init__(self, child: LogicalPlan) -> None:
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        return self.child.output_columns(schema_of)

    def with_children(self, children) -> "Distinct":
        (child,) = children
        return Distinct(child)

    def simple_string(self) -> str:
        return "Distinct"


class SetOp(LogicalPlan):
    """INTERSECT or EXCEPT with SQL set semantics: the distinct rows of
    the left side that do (intersect) or do not (except) appear in the
    right side, rows compared null-safely (NULL equals NULL, unlike a
    join predicate).  Columns pair by position."""

    KINDS = ("intersect", "except")

    def __init__(self, kind: str, left: LogicalPlan,
                 right: LogicalPlan) -> None:
        if kind not in self.KINDS:
            raise ValueError(f"SetOp kind must be one of {self.KINDS}, "
                             f"got {kind!r}")
        self.kind = kind
        self.children = (left, right)

    @property
    def left(self) -> LogicalPlan:
        return self.children[0]

    @property
    def right(self) -> LogicalPlan:
        return self.children[1]

    def output_columns(self, schema_of) -> List[str]:
        return self.left.output_columns(schema_of)

    def with_children(self, children) -> "SetOp":
        left, right = children
        return SetOp(self.kind, left, right)

    def simple_string(self) -> str:
        return self.kind.upper()


class Sort(LogicalPlan):
    """Total order by ``keys``, (column, ascending) pairs.  The rewrite
    rules pass through it."""

    def __init__(self, keys: Sequence[Tuple[str, bool]],
                 child: LogicalPlan) -> None:
        if not keys:
            raise ValueError("Sort needs at least one key")
        self.keys = tuple((c, bool(asc)) for c, asc in keys)
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        return self.child.output_columns(schema_of)

    def with_children(self, children) -> "Sort":
        (child,) = children
        return Sort(self.keys, child)

    def simple_string(self) -> str:
        keys = ", ".join(f"{c} {'ASC' if asc else 'DESC'}"
                         for c, asc in self.keys)
        return f"Sort [{keys}]"


class Limit(LogicalPlan):
    """First ``n`` rows of the child's order."""

    def __init__(self, n: int, child: LogicalPlan) -> None:
        if n < 0:
            raise ValueError(f"Limit must be non-negative, got {n}")
        self.n = int(n)
        self.children = (child,)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        return self.child.output_columns(schema_of)

    def with_children(self, children) -> "Limit":
        (child,) = children
        return Limit(self.n, child)

    def simple_string(self) -> str:
        return f"Limit {self.n}"


class Aggregate(LogicalPlan):
    """Group-by and aggregations: ``aggs`` holds (function, input,
    output name) triples, functions from arrow's hash-aggregate set
    (``count_all`` counts rows and ignores its input).  An input is a
    column name or an ``Expr``, as in ``sum(l_extendedprice * (1 -
    l_discount))``.  An empty ``group_by`` is a global aggregation.  The
    rewrite rules never match an Aggregate; they rewrite the patterns
    below it."""

    FUNCTIONS = ("sum", "min", "max", "mean", "count", "count_all",
                 "count_distinct", "stddev", "variance")

    def __init__(self, group_by: Sequence[str],
                 aggs: Sequence[Tuple[str, Any, str]],
                 child: LogicalPlan) -> None:
        for func, agg_in, _out in aggs:
            if func not in self.FUNCTIONS:
                raise ValueError(
                    f"Unsupported aggregate function {func!r}; "
                    f"expected one of {self.FUNCTIONS}")
            if not isinstance(agg_in, (str, Expr)):
                raise ValueError(
                    f"Aggregate input must be a column name or expression, "
                    f"got {agg_in!r}")
        self.group_by = tuple(group_by)
        self.aggs = tuple(aggs)
        self.children = (child,)

    def input_columns(self) -> List[str]:
        """Source columns the aggregations read (group keys excluded)."""
        out: set = set()
        for _f, agg_in, _o in self.aggs:
            if isinstance(agg_in, Expr):
                out |= agg_in.referenced_columns()
            elif agg_in:
                out.add(agg_in)
        return sorted(out)

    @property
    def child(self) -> LogicalPlan:
        return self.children[0]

    def output_columns(self, schema_of) -> List[str]:
        return list(self.group_by) + [out for _f, _c, out in self.aggs]

    def with_children(self, children) -> "Aggregate":
        (child,) = children
        return Aggregate(self.group_by, self.aggs, child)

    def simple_string(self) -> str:
        def render(f, agg_in):
            if f == "count_all":
                return "*"
            return repr(agg_in) if isinstance(agg_in, Expr) else str(agg_in)

        aggs = ", ".join(f"{f}({render(f, c)}) AS {out}"
                         for f, c, out in self.aggs)
        return f"Aggregate [{', '.join(self.group_by)}] [{aggs}]"


class InMemory(LogicalPlan):
    """A materialized arrow table as a leaf.  The bucket-aligned join
    uses it to join a bucket whose sides it already read."""

    def __init__(self, table) -> None:
        self.table = table
        self.children = ()

    def output_columns(self, schema_of) -> List[str]:
        return list(self.table.column_names)

    def with_children(self, children) -> "InMemory":
        assert not children
        return InMemory(self.table)

    def simple_string(self) -> str:
        return f"InMemory [{self.table.num_rows} rows]"


class BucketUnion(LogicalPlan):
    """Union of children bucketed alike (``bucket_spec``): a hybrid-scan
    join side, an index and its appended source rows.  The bucket-aligned
    join routes the appended rows into the index's buckets; executed
    whole it is a strict by-name concatenation."""

    def __init__(self, children: Sequence[LogicalPlan],
                 bucket_spec: Tuple[int, Tuple[str, ...], Tuple[str, ...]]) -> None:
        self.bucket_spec = bucket_spec
        self.children = tuple(children)

    def output_columns(self, schema_of) -> List[str]:
        return self.children[0].output_columns(schema_of)

    def with_children(self, children) -> "BucketUnion":
        return BucketUnion(children, self.bucket_spec)

    def simple_string(self) -> str:
        return f"BucketUnion (buckets={self.bucket_spec[0]})"


class Union(LogicalPlan):
    """Union by name: the first child's columns, then any names only later
    children produce.  ``strict`` keeps arrow's default promotion (nulls
    only), so an index and its own source rows never widen silently
    (int64 with float64 would corrupt keys above 2**53); otherwise
    numeric widths widen."""

    def __init__(self, children: Sequence[LogicalPlan],
                 strict: bool = False) -> None:
        self.children = tuple(children)
        self.strict = bool(strict)

    def output_columns(self, schema_of) -> List[str]:
        out = list(self.children[0].output_columns(schema_of))
        seen = set(out)
        for c in self.children[1:]:
            for name in c.output_columns(schema_of):
                if name not in seen:
                    seen.add(name)
                    out.append(name)
        return out

    def with_children(self, children) -> "Union":
        return Union(children, strict=self.strict)

    def simple_string(self) -> str:
        return "Union"
