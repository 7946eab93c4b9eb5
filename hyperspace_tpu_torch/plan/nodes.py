"""Logical plan nodes (counterpart of hyperspace_tpu/plan/nodes.py, the
nodes a filter, join or aggregate query needs): ``Scan``, ``Filter``,
``Project``, ``Join``, ``Aggregate``, ``Sort``, ``Limit``, ``InMemory``,
and the hybrid-scan merges ``BucketUnion`` and ``Union``.  A plan is a small immutable tree; the rules
rewrite it with ``transform_up``/``with_children``.  Class names are part
of the plan signature, so they match the JAX package's, and
``tree_string`` prints a plan as the JAX package does."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.plan.expr import Expr


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
    files a sketch pruned."""

    root_paths: Tuple[str, ...]
    file_format: str = "parquet"
    options: Tuple[Tuple[str, str], ...] = ()
    index_scan_of: Optional[str] = None
    bucket_spec: Optional[Tuple[int, Tuple[str, ...], Tuple[str, ...]]] = None
    file_paths: Optional[Tuple[str, ...]] = None
    prune_to_buckets: Optional[Tuple[int, ...]] = None
    data_skipping_of: Optional[str] = None
    data_skipping_stats: Optional[Tuple[int, int]] = None

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


class Join(LogicalPlan):
    """Equi-join of any SQL join type.  The join index rule rewrites
    inner equi-joins only; index scans under any type still run bucket
    by bucket."""

    HOW = ("inner", "left", "right", "full", "semi", "anti")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 condition: Expr, how: str = "inner") -> None:
        if how not in self.HOW:
            raise ValueError(f"Unsupported join type {how!r}; "
                             f"expected one of {self.HOW}")
        self.condition = condition
        self.how = how
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
        return Join(left, right, self.condition, self.how)

    def simple_string(self) -> str:
        return f"Join {self.how} on {self.condition!r}"


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
