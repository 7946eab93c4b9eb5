"""Physical execution of a filter or join plan into an arrow table
(counterpart of hyperspace_tpu/execution/executor.py, its Scan, Filter,
Project, Join, InMemory, Union and BucketUnion nodes).

Numeric work runs on the session's device: a predicate over null-free
numeric columns as the torch closure of ``ops.filter.compile_predicate``,
the match pairs of an equi-join on one numeric key by
``ops.join.sorted_equi_join`` (composite and string keys by
``hashed_equi_join``).  Strings, nulls and division stay on the arrow
host path, which owns SQL's three-valued logic.  Below
``conf.device_min_rows(kind)`` rows a filter or join takes the host
route instead (the arrow predicate, ``sorted_equi_join_np``); the
default threshold of 0 always takes the device.  No device error is
caught to answer from the host instead.

A join whose sides are ``(Project|Filter)*`` chains over index scans
with matching bucket specs runs bucket by bucket: equal keys meet only
inside one bucket, so each per-bucket join reads and joins 1/B of the
data; up to 8 buckets run at once on the shared thread pool.  A side may
also be a hybrid scan's ``BucketUnion(index chain, appended files)``:
the appended rows are routed into the index's buckets by the build's
bucket hash on the session's device (the hash kernel on the card), and
each bucket joins its index files followed by its routed rows.

A ``Union`` or ``BucketUnion`` executed whole concatenates its children
in order, by name; a strict one promotes nulls only.

Scan semantics: ``relation.file_paths`` replaces the listing of the root
paths (index scans); ``relation.prune_to_buckets`` drops index files
whose bucket id (from the file name) is not wanted.

``stats`` records per scan the files and rows read, per filter and per
join kernel the route taken ("device" or "host") and its rows, and per
join "bucketed" (with whether a side was hybrid) or "plain";
``Dataset.collect`` publishes it as ``session.last_execution_stats``.

Not ported: every other plan node, the device column cache (columns are
uploaded per query), the mesh filter and join, residual join predicates,
the lake formats, hypothetical scans and the telemetry spans.  pyarrow
is imported inside the functions.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.io.files import list_data_files
from hyperspace_tpu_torch.io.parquet import (
    bucket_id_of_file,
    read_schema,
    read_table,
    schema_to_arrow,
)
from hyperspace_tpu_torch.plan.expr import (
    And,
    Arith,
    BinOp,
    Col,
    Expr,
    IsIn,
    Lit,
    Neg,
    Not,
    Or,
    as_equi_join_pairs,
)
from hyperspace_tpu_torch.plan.nodes import (
    BucketUnion,
    Filter,
    InMemory,
    Join,
    LogicalPlan,
    Project,
    Scan,
    Union,
)


class Executor:
    def __init__(self, session) -> None:
        self.session = session
        self.stats: Dict[str, list] = {"joins": [], "scans": []}

    def execute(self, plan: LogicalPlan):
        if isinstance(plan, InMemory):
            return plan.table
        if isinstance(plan, Scan):
            return self._scan(plan)
        if isinstance(plan, Filter):
            return self._filter(plan)
        if isinstance(plan, Project):
            if isinstance(plan.child, Scan):
                # Read only the projected columns from disk.
                return self._scan(plan.child, columns=plan.columns)
            return self.execute(plan.child).select(plan.columns)
        if isinstance(plan, Join):
            return self._join(plan)
        if isinstance(plan, (BucketUnion, Union)):
            import pyarrow as pa

            tables = [self.execute(c) for c in plan.children]
            # BucketUnion merges an index with its own source's rows: a
            # width mismatch there is schema drift and must raise.
            promote = "permissive" if isinstance(plan, Union) \
                and not plan.strict else "default"
            return pa.concat_tables(tables, promote_options=promote)
        raise ValueError(f"Unknown plan node: {type(plan).__name__}")

    # -- scan ---------------------------------------------------------------
    def _scan(self, plan: Scan, columns: Optional[List[str]] = None):
        rel = plan.relation
        if rel.file_paths is not None:
            paths = list(rel.file_paths)
        else:
            paths = [f.name for f in list_data_files(rel.root_paths)]
        all_paths = paths
        if rel.prune_to_buckets is not None:
            wanted = set(rel.prune_to_buckets)
            paths = [p for p in paths
                     if (b := bucket_id_of_file(p)) is None or b in wanted]
        bytes_read = 0
        for p in paths:
            try:
                bytes_read += os.path.getsize(p)
            except OSError:
                pass  # read_table raises a better error for a missing file
        record = {
            "relation": rel.index_scan_of or ",".join(rel.root_paths),
            "is_index": bool(rel.index_scan_of),
            "files_read": len(paths),
            "files_listed": len(all_paths),
            "bytes_read": bytes_read,
        }
        self.stats["scans"].append(record)
        if not paths:
            # Every file pruned: an empty table that keeps the schema, so
            # the nodes above still resolve their columns.
            import pyarrow as pa

            empty = schema_to_arrow(read_schema(all_paths[0])).empty_table() \
                if all_paths else pa.table({})
            return empty.select(columns) if columns else empty
        out = read_table(paths, columns)
        if columns:
            out = out.select(columns)
        record["rows"] = out.num_rows
        return out

    # -- filter -------------------------------------------------------------
    def _filter(self, plan: Filter):
        import pyarrow as pa

        table = self.execute(plan.child)
        if table.num_rows == 0:
            return table
        return table.filter(pa.array(self._eval_predicate(plan.condition, table)))

    def _eval_predicate(self, expr: Expr, table) -> np.ndarray:
        """The device path needs at least one column, every referenced
        column numeric and null-free, and ``device_min_rows("filter")``
        rows; all else takes the arrow path."""
        cols = expr.referenced_columns()
        on_device = bool(cols) \
            and table.num_rows >= self.session.conf.device_min_rows("filter") \
            and all(columnar.is_numeric_type(table.schema.field(c).type)
                    and table.column(c).null_count == 0 for c in cols) \
            and _device_compatible(expr, table)
        self.stats.setdefault("filters", []).append({
            "strategy": "device" if on_device else "host",
            "rows": table.num_rows})
        if on_device:
            return self._eval_device(expr, table)
        return _eval_arrow(expr, table)

    def _device_column(self, table, column: str) -> torch.Tensor:
        """The column uploaded to the session's device (no cache)."""
        host = columnar.to_device_numeric(table.column(column))
        return torch.from_numpy(np.require(host, requirements="W")) \
            .to(self.session.device)

    def _eval_device(self, expr: Expr, table) -> np.ndarray:
        from hyperspace_tpu_torch.ops.filter import compile_predicate

        order = sorted(expr.referenced_columns())
        fn, literals = compile_predicate(_normalize_literals(expr, table), order)
        mask = fn([self._device_column(table, c) for c in order], literals)
        return mask.cpu().numpy()

    # -- join ---------------------------------------------------------------
    def _join(self, plan: Join, _record: bool = True):
        bucketed = self._try_bucketed_join(plan)
        if bucketed is not None:
            return bucketed
        if _record:
            self.stats["joins"].append({"strategy": "plain", "how": plan.how})
        return self._host_join_tables(self.execute(plan.left),
                                      self.execute(plan.right),
                                      plan.condition, plan.how)

    def _host_join_tables(self, left, right, condition: Expr, how: str):
        """Join two tables.  Match pairs come from the inner equi-join
        over the rows whose keys are all valid (null keys never match);
        the join type then shapes the output from them: null extension by
        arrow's null-index take, existence joins by membership."""
        import pyarrow as pa

        pairs = as_equi_join_pairs(condition)
        if pairs is None:
            raise ValueError(f"Non-equi join condition: {condition!r}")
        l_keys, r_keys = [], []
        for a, b in pairs:
            if a in left.column_names and b in right.column_names:
                l_keys.append(a)
                r_keys.append(b)
            elif b in left.column_names and a in right.column_names:
                l_keys.append(b)
                r_keys.append(a)
            else:
                raise ValueError(f"Join columns {a!r}/{b!r} not found")
        # Outer and anti joins still emit null-key rows: keep positions.
        l_map = _valid_key_positions(left, l_keys)
        r_map = _valid_key_positions(right, r_keys)
        lv = left if len(l_map) == left.num_rows else left.take(pa.array(l_map))
        rv = right if len(r_map) == right.num_rows else right.take(pa.array(r_map))
        li, ri = self._inner_match_pairs(lv, rv, l_keys, r_keys)
        li = l_map[li] if len(l_map) != left.num_rows else li
        ri = r_map[ri] if len(r_map) != right.num_rows else ri

        if how == "inner":
            return _concat_horizontal(left.take(pa.array(li)),
                                      right.take(pa.array(ri)))
        if how == "semi":
            return left.take(pa.array(np.unique(li)))
        if how == "anti":
            mask = np.ones(left.num_rows, dtype=bool)
            mask[li] = False
            return left.filter(pa.array(mask))
        # Outer joins: matched pairs first, then each preserved side's
        # unmatched rows, null-extended (a null index takes a null row).
        l_parts, r_parts = [li], [ri]
        l_masks = [np.zeros(len(li), dtype=bool)]
        r_masks = [np.zeros(len(ri), dtype=bool)]
        if how in ("left", "full"):
            unmatched = np.setdiff1d(np.arange(left.num_rows), li)
            l_parts.append(unmatched)
            r_parts.append(np.zeros(len(unmatched), dtype=ri.dtype))
            l_masks.append(np.zeros(len(unmatched), dtype=bool))
            r_masks.append(np.ones(len(unmatched), dtype=bool))
        if how in ("right", "full"):
            unmatched = np.setdiff1d(np.arange(right.num_rows), ri)
            l_parts.append(np.zeros(len(unmatched), dtype=li.dtype))
            r_parts.append(unmatched)
            l_masks.append(np.ones(len(unmatched), dtype=bool))
            r_masks.append(np.zeros(len(unmatched), dtype=bool))
        l_idx = pa.array(np.concatenate(l_parts), mask=np.concatenate(l_masks))
        r_idx = pa.array(np.concatenate(r_parts), mask=np.concatenate(r_masks))
        return _concat_horizontal(left.take(l_idx), right.take(r_idx))

    def _inner_match_pairs(self, left, right, l_keys: List[str],
                           r_keys: List[str]):
        """(left_indices, right_indices) of the inner matches between two
        tables whose keys hold no null, as int64 numpy arrays."""
        from hyperspace_tpu_torch.ops.join import (
            UnsupportedJoinKeys,
            hashed_equi_join,
            sorted_equi_join,
            sorted_equi_join_np,
        )

        max_rows = max(left.num_rows, right.num_rows)
        use_device = max_rows >= self.session.conf.device_min_rows("join")
        if (len(l_keys) == 1
                and columnar.is_numeric_type(left.schema.field(l_keys[0]).type)
                and columnar.is_numeric_type(right.schema.field(r_keys[0]).type)):
            lk = columnar.to_device_numeric(left.column(l_keys[0]))
            rk = columnar.to_device_numeric(right.column(r_keys[0]))
            if use_device:
                li, ri = sorted_equi_join(lk, rk, self.session.device)
            else:
                li, ri = sorted_equi_join_np(lk, rk)
            self.stats.setdefault("join_kernels", []).append({
                "strategy": "device" if use_device else "host",
                "rows": int(max_rows)})
            return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)
        # Composite or string keys: the digest join with exact
        # verification; pandas only for key pairs with no common domain.
        try:
            li, ri = hashed_equi_join(
                left, right, l_keys, r_keys,
                self.session.device if use_device else None)
            return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)
        except UnsupportedJoinKeys:
            ldf = left.to_pandas()
            rdf = right.to_pandas()
            ldf["__li"] = np.arange(len(ldf))
            rdf["__ri"] = np.arange(len(rdf))
            merged = ldf.merge(rdf, left_on=l_keys, right_on=r_keys,
                               how="inner", suffixes=("", "__r"))
            return (merged["__li"].to_numpy(dtype=np.int64),
                    merged["__ri"].to_numpy(dtype=np.int64))

    def _try_bucketed_join(self, plan: Join):
        """Join bucket by bucket when both sides are (Project|Filter)*
        chains over index scans with matching bucket specs, or hybrid
        ``BucketUnion``s of such a chain and appended rows (what
        JoinIndexRule builds).  An outer or anti join joins a bucket only
        one side has against a zero-row table of the other side, so its
        unmatched rows are emitted as the plain path would."""
        import pyarrow as pa

        from hyperspace_tpu_torch.utils.parallel_map import parallel_map_ordered

        precheck = bucketed_join_precheck(self.session, plan)
        if precheck is None:
            return None
        left_side, right_side, l_files, r_files = precheck
        scans_mark = len(self.stats["scans"])
        l_parts = self._side_bucket_parts(left_side, l_files)
        r_parts = None if l_parts is None \
            else self._side_bucket_parts(right_side, r_files)
        shared = [] if l_parts is None or r_parts is None \
            else sorted(set(l_parts) & set(r_parts))
        if not shared:
            # A side that could not be routed, or no bucket on both
            # sides: the plain path gives the right answer, null
            # extension and the joined schema included.  What the
            # probing read is not counted twice.
            del self.stats["scans"][scans_mark:]
            return None
        extra_left = sorted(set(l_parts) - set(r_parts)) \
            if plan.how in ("left", "full", "anti") else []
        extra_right = sorted(set(r_parts) - set(l_parts)) \
            if plan.how in ("right", "full") else []
        self.stats["joins"].append({
            "strategy": "bucketed",
            "how": plan.how,
            "buckets": len(shared) + len(extra_left) + len(extra_right),
            "hybrid": bool(left_side.appended or right_side.appended),
        })
        # The zero-row donors come from one shared bucket, read once and
        # reused for that bucket's own join.
        pre = {}
        l_donor = r_donor = None
        if extra_left or extra_right:
            donor = shared[0]
            lt0 = self.execute(l_parts[donor]())
            rt0 = self.execute(r_parts[donor]())
            pre[donor] = (lt0, rt0)
            l_donor, r_donor = lt0.slice(0, 0), rt0.slice(0, 0)

        def join_bucket(bucket: int):
            if bucket in extra_left:
                sub = Join(l_parts[bucket](), InMemory(r_donor),
                           plan.condition, plan.how)
            elif bucket in extra_right:
                sub = Join(InMemory(l_donor), r_parts[bucket](),
                           plan.condition, plan.how)
            elif bucket in pre:
                lt, rt = pre[bucket]
                sub = Join(InMemory(lt), InMemory(rt), plan.condition, plan.how)
            else:
                sub = Join(l_parts[bucket](), r_parts[bucket](),
                           plan.condition, plan.how)
            # Per-bucket scans carry no bucket spec: the plain path.
            return self._join(sub, _record=False)

        parts = parallel_map_ordered(
            join_bucket, sorted(shared + extra_left + extra_right),
            max_workers=8)
        return pa.concat_tables(parts, promote_options="default")

    def _side_bucket_parts(self, side: "_BucketedSide", by_bucket):
        """bucket id -> zero-argument function making that bucket's
        sub-plan for one join side, or None when the side's appended rows
        cannot be routed.  A bucket's sub-plan reads its index files
        followed by its routed appended rows."""
        appended_by_bucket: Dict = {}
        if side.appended is not None:
            num_buckets, cols, _ = side.scan.relation.bucket_spec
            routed = self._route_to_buckets(self.execute(side.appended), cols,
                                            num_buckets, side.scan)
            if routed is None:
                return None
            appended_by_bucket = routed

        def make(bucket: int) -> LogicalPlan:
            parts: List[LogicalPlan] = []
            if bucket in by_bucket:
                parts.append(_rewrap(side.scan, side.inner, by_bucket[bucket]))
            if bucket in appended_by_bucket:
                parts.append(InMemory(appended_by_bucket[bucket]))
            node = parts[0] if len(parts) == 1 else Union(parts, strict=True)
            for w in reversed(side.outer):
                node = w.with_children((node,))
            return node

        return {b: (lambda b=b: make(b))
                for b in set(by_bucket) | set(appended_by_bucket)}

    def _route_to_buckets(self, table, cols, num_buckets: int,
                          index_scan: Scan) -> Optional[Dict]:
        """``table``'s rows by the index's bucket, each bucket's rows in
        table order.  The bucket ids come from the build's hash on the
        session's device (the hash kernel on the card; bit-equal to the
        host mirror ``bucket_ids_np``).  Key columns are cast to the
        index's stored type first: the hash reads raw bits, so an int64
        row hashed as float64 would land in another bucket.  None when a
        key column is missing or does not cast."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from hyperspace_tpu_torch.ops.hash import bucket_ids

        if table.num_rows == 0:
            return {}
        by_lower = {c.lower(): c for c in table.column_names}
        stored = {k.lower(): v
                  for k, v in self.session.schema_map_of(index_scan).items()}
        word_cols = []
        for c in cols:
            name = by_lower.get(c.lower())
            if name is None:
                return None
            column = table.column(name)
            stored_type = stored.get(c.lower())
            if stored_type is not None and str(column.type) != stored_type:
                target = schema_to_arrow({"c": stored_type}).field(0).type
                try:
                    column = pc.cast(column, target)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError,
                        pa.ArrowTypeError):
                    return None
            word_cols.append(torch.from_numpy(np.ascontiguousarray(
                columnar.to_hash_words(column))).to(self.session.device))
        ids = bucket_ids(word_cols, num_buckets).cpu().numpy()
        # A stable sort by bucket keeps each bucket's rows in table order.
        order = np.argsort(ids, kind="stable")
        present, starts, counts = np.unique(ids[order], return_index=True,
                                            return_counts=True)
        routed = table.take(pa.array(order))
        return {int(b): routed.slice(int(s), int(n))
                for b, s, n in zip(present, starts, counts)}


# ---------------------------------------------------------------------------
# predicate routing and the arrow host path
# ---------------------------------------------------------------------------
def _device_compatible(expr: Expr, table) -> bool:
    """Whether the device predicate gives the arrow path's answer on
    ``expr``: temporal columns only against temporal literals or a
    column of the same type, no bool-vs-number mix, no division."""
    import pyarrow as pa

    if isinstance(expr, BinOp):
        sides = (expr.left, expr.right)
        if not all(isinstance(s, (Col, Lit)) for s in sides):
            # Compound operands: int/float columns and numeric literals
            # under + - * and negation only.
            return all(_arith_device_ok(s, table) for s in sides)
        cols_in_cmp = [s for s in sides if isinstance(s, Col)]
        if not cols_in_cmp:
            return False  # a constant predicate: the arrow path owns it
        col_types = [table.schema.field(c.name).type for c in cols_in_cmp]
        if len(col_types) == 2 and (pa.types.is_boolean(col_types[0])
                                    != pa.types.is_boolean(col_types[1])):
            return False  # arrow raises on bool vs number
        if any(pa.types.is_temporal(t) for t in col_types):
            if len(col_types) == 2 and (
                    not all(pa.types.is_temporal(t) for t in col_types)
                    or col_types[0] != col_types[1]):
                return False
            if any(isinstance(s, Lit)
                   and isinstance(s.value, (int, float, bool, np.integer,
                                            np.floating, np.bool_))
                   for s in sides):
                return False  # epoch numbers against a plain number
        for side in sides:
            if not isinstance(side, Lit):
                continue
            v = side.value
            bool_lit = isinstance(v, (bool, np.bool_))
            if bool_lit != pa.types.is_boolean(col_types[0]) and (
                    bool_lit or isinstance(v, (int, float, np.integer,
                                               np.floating))):
                return False  # arrow raises on bool vs number
            if not isinstance(v, (int, float, bool)):
                if columnar.literal_to_numeric(v, col_types[0]) is None:
                    return False
        return True
    if isinstance(expr, (And, Or)):
        return (_device_compatible(expr.left, table)
                and _device_compatible(expr.right, table))
    if isinstance(expr, Not):
        return _device_compatible(expr.child, table)
    if isinstance(expr, IsIn):
        return (_arith_device_ok(expr.child, table)
                and all(isinstance(v, (int, float, bool)) for v in expr.values))
    return False


def _arith_device_ok(e: Expr, table) -> bool:
    """A device value expression: int/float columns, int/float literals
    (not bool) and + - * and negation over them."""
    import pyarrow as pa

    if isinstance(e, Col):
        try:
            t = table.schema.field(e.name).type
        except KeyError:
            return False
        return pa.types.is_integer(t) or pa.types.is_floating(t)
    if isinstance(e, Lit):
        return isinstance(e.value, (int, float)) and not isinstance(e.value, bool)
    if isinstance(e, Arith):
        return (e.op != "/" and _arith_device_ok(e.left, table)
                and _arith_device_ok(e.right, table))
    if isinstance(e, Neg):
        return _arith_device_ok(e.child, table)
    return False


def _normalize_literals(expr: Expr, table) -> Expr:
    """Temporal and bool literals compared with a column, in the
    column's int64 device domain."""
    if isinstance(expr, BinOp):
        left, right = expr.left, expr.right
        if isinstance(left, Col) and isinstance(right, Lit):
            t = table.schema.field(left.name).type
            return BinOp(expr.op, left,
                         Lit(columnar.literal_to_numeric(right.value, t)))
        if isinstance(right, Col) and isinstance(left, Lit):
            t = table.schema.field(right.name).type
            return BinOp(expr.op,
                         Lit(columnar.literal_to_numeric(left.value, t)), right)
        return expr
    if isinstance(expr, And):
        return And(_normalize_literals(expr.left, table),
                   _normalize_literals(expr.right, table))
    if isinstance(expr, Or):
        return Or(_normalize_literals(expr.left, table),
                  _normalize_literals(expr.right, table))
    if isinstance(expr, Not):
        return Not(_normalize_literals(expr.child, table))
    return expr


def _eval_arrow(expr: Expr, table) -> np.ndarray:
    """The host predicate: arrow compute with SQL's three-valued logic;
    null counts as false."""
    import pyarrow as pa

    result = _arrow_eval(expr, table)
    if isinstance(result, pa.Scalar):
        value = result.as_py()
        return np.full(table.num_rows, bool(value) if value is not None else False)
    mask = np.asarray(result.to_numpy(zero_copy_only=False))
    if mask.dtype != np.bool_:
        # Nulls surface as None in an object array.
        mask = np.array([bool(v) if v is not None else False for v in mask])
    return mask


def _parse_float64(column):
    """A string column as float64; a string that does not parse becomes
    NaN, which no comparison matches (the row drops, as for Spark's
    null)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    try:
        return pc.cast(column, pa.float64())
    except (pa.ArrowInvalid, pa.ArrowTypeError):
        import pandas as pd

        values = pd.to_numeric(pd.Series(column.to_numpy(zero_copy_only=False)),
                               errors="coerce")
        return pa.array(values.to_numpy(dtype=np.float64, na_value=np.nan),
                        type=pa.float64())


def _arrow_eval(expr: Expr, table):
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(expr, Col):
        return table.column(expr.name)
    if isinstance(expr, Lit):
        return pa.scalar(expr.value)
    if isinstance(expr, BinOp):
        left = _arrow_eval(expr.left, table)
        right = _arrow_eval(expr.right, table)
        ops = {"==": pc.equal, "<": pc.less, "<=": pc.less_equal,
               ">": pc.greater, ">=": pc.greater_equal}
        try:
            return ops[expr.op](left, right)
        except pa.ArrowNotImplementedError:
            # Spark's coercion: a string column against a numeric scalar
            # compares as float64 ('05' == 5); any other scalar is cast
            # to the column's type ("2024" against an int64 column).
            # Uncastable values raise.
            def coerced(scalar, column):
                if (pa.types.is_string(column.type)
                        and (pa.types.is_integer(scalar.type)
                             or pa.types.is_floating(scalar.type))):
                    return (pc.cast(scalar, pa.float64()),
                            _parse_float64(column))
                return pc.cast(scalar, column.type), column

            try:
                if isinstance(left, pa.Scalar) and not isinstance(right, pa.Scalar):
                    lhs, rhs = coerced(left, right)
                    return ops[expr.op](lhs, rhs)
                if isinstance(right, pa.Scalar) and not isinstance(left, pa.Scalar):
                    rhs, lhs = coerced(right, left)
                    return ops[expr.op](lhs, rhs)
            except (pa.ArrowInvalid, pa.ArrowTypeError, ValueError, TypeError):
                pass
            raise
    if isinstance(expr, Arith):
        left = _arrow_eval(expr.left, table)
        right = _arrow_eval(expr.right, table)
        if expr.op == "/":
            # float64 division; x / 0 is null.
            left = pc.cast(left, pa.float64())
            right = pc.cast(right, pa.float64())
            zero = pc.equal(right, pa.scalar(0.0))
            safe = pc.if_else(zero, pa.scalar(1.0), right)
            return pc.if_else(zero, pa.scalar(None, type=pa.float64()),
                              pc.divide(left, safe))
        fn = {"+": pc.add, "-": pc.subtract, "*": pc.multiply}[expr.op]
        return fn(left, right)
    if isinstance(expr, Neg):
        return pc.negate(_arrow_eval(expr.child, table))
    if isinstance(expr, And):
        return pc.and_kleene(_arrow_eval(expr.left, table),
                             _arrow_eval(expr.right, table))
    if isinstance(expr, Or):
        return pc.or_kleene(_arrow_eval(expr.left, table),
                            _arrow_eval(expr.right, table))
    if isinstance(expr, Not):
        return pc.invert(_arrow_eval(expr.child, table))
    if isinstance(expr, IsIn):
        child = _arrow_eval(expr.child, table)
        # SQL: NULL IN (...) is NULL, and x IN (no match..., NULL) is NULL
        # (arrow's is_in says false); both matter under NOT.
        values = [v for v in expr.values if v is not None]
        null_in_list = len(values) != len(expr.values)
        null_bool = pa.scalar(None, type=pa.bool_())
        result = pc.is_in(child, value_set=pa.array(values)) if values \
            else pa.scalar(False)
        if null_in_list:
            result = pc.if_else(result, pa.scalar(True), null_bool)
        if isinstance(child, pa.Scalar):
            return result if child.is_valid else null_bool
        return pc.if_else(pc.is_valid(child), result, null_bool)
    raise ValueError(f"Unsupported expression: {expr!r}")


# ---------------------------------------------------------------------------
# join helpers
# ---------------------------------------------------------------------------
def _concat_horizontal(left, right):
    """The left columns, then the right ones; a right name the output
    already has becomes ``name__1`` (``__2``, ...)."""
    import pyarrow as pa

    names = list(left.column_names)
    cols = list(left.columns)
    for name, column in zip(right.column_names, right.columns):
        out_name = name
        n = 1
        while out_name in names:
            out_name = f"{name}__{n}"
            n += 1
        names.append(out_name)
        cols.append(column)
    return pa.table(dict(zip(names, cols)))


def _valid_key_positions(table, keys: List[str]) -> np.ndarray:
    """Positions of the rows whose join keys are all non-null."""
    import pyarrow.compute as pc

    valid = np.ones(table.num_rows, dtype=bool)
    for k in keys:
        column = table.column(k)
        if column.null_count > 0:
            valid &= np.asarray(pc.is_valid(column).to_numpy(zero_copy_only=False))
    return np.nonzero(valid)[0] if not valid.all() else np.arange(table.num_rows)


class _BucketedSide:
    """A join side for the bucket-aligned join: its bucketed index
    ``scan``, the ``inner`` wrappers between a hybrid BucketUnion and the
    scan (none without a union), the ``outer`` wrappers above, and the
    ``appended`` subtree (None for a plain index chain)."""

    def __init__(self, scan: Scan, inner: List[LogicalPlan],
                 outer: List[LogicalPlan],
                 appended: Optional[LogicalPlan]) -> None:
        self.scan = scan
        self.inner = inner
        self.outer = outer
        self.appended = appended


def _is_bucketed_index_scan(node: LogicalPlan) -> bool:
    return (isinstance(node, Scan) and bool(node.relation.bucket_spec)
            and node.relation.file_paths is not None
            and bool(node.relation.index_scan_of))


def _unwrap_chain(node: LogicalPlan):
    wrappers: List[LogicalPlan] = []
    while isinstance(node, (Project, Filter)):
        wrappers.append(node)
        node = node.children[0]
    return wrappers, node


def _bucketed_side(node: LogicalPlan) -> Optional[_BucketedSide]:
    """Match ``(Project|Filter)*`` over a bucketed index scan or over a
    hybrid ``BucketUnion(index chain, appended subtree)``."""
    outer, node = _unwrap_chain(node)
    if _is_bucketed_index_scan(node):
        return _BucketedSide(node, [], outer, None)
    if isinstance(node, BucketUnion) and len(node.children) == 2:
        # The index chain is found by its shape, not its position.
        for index_child, appended_child in (node.children,
                                            node.children[::-1]):
            inner, leaf = _unwrap_chain(index_child)
            if _is_bucketed_index_scan(leaf):
                return _BucketedSide(leaf, inner, outer, appended_child)
    return None


def bucketed_join_precheck(session, plan: Join):
    """(left side, right side, left files by bucket, right files by
    bucket) when ``plan`` can run bucket by bucket, else None.

    Multi-column keys qualify when the join pairs map the two sides'
    bucket columns position by position: the same hash inputs in the
    same order put equal key tuples in the same bucket."""
    pairs = as_equi_join_pairs(plan.condition)
    if not pairs:
        return None
    left_side, right_side = _bucketed_side(plan.left), _bucketed_side(plan.right)
    if left_side is None or right_side is None:
        return None
    l_scan, r_scan = left_side.scan, right_side.scan
    l_spec, r_spec = l_scan.relation.bucket_spec, r_scan.relation.bucket_spec
    if l_spec[0] != r_spec[0]:
        return None
    l_cols = tuple(c.lower() for c in l_spec[1])
    r_cols = tuple(c.lower() for c in r_spec[1])
    if len(pairs) != len(l_cols) or len(l_cols) != len(r_cols):
        return None
    l_to_r = {}
    for a, b in pairs:
        la, rb = a.lower(), b.lower()
        fwd = la in l_cols and rb in r_cols
        rev = rb in l_cols and la in r_cols
        if fwd and rev and la != rb:
            # Both orientations fit: the per-bucket join resolves sides by
            # table columns and could pick the other one.  Plain path.
            return None
        if fwd:
            l_to_r[la] = rb
        elif rev:
            l_to_r[rb] = la
        else:
            return None
    if [l_to_r.get(c) for c in l_cols] != list(r_cols):
        return None
    # Buckets align only when both sides hashed the same bit patterns:
    # an int64 key and a float64 key put equal values in different
    # buckets.
    for lc, rc in zip(l_spec[1], r_spec[1]):
        l_type = session.schema_map_of(l_scan).get(lc)
        r_type = session.schema_map_of(r_scan).get(rc)
        if l_type is None or r_type is None or l_type != r_type:
            return None
    l_files = _files_by_bucket(l_scan)
    r_files = _files_by_bucket(r_scan)
    if l_files is None or r_files is None:
        return None
    return left_side, right_side, l_files, r_files


def _files_by_bucket(scan: Scan):
    """Bucket id -> files, honouring the scan's own bucket pruning."""
    allowed = None if scan.relation.prune_to_buckets is None \
        else set(scan.relation.prune_to_buckets)
    out: Dict[int, List[str]] = {}
    for p in scan.relation.file_paths:
        b = bucket_id_of_file(p)
        if b is None:
            return None
        if allowed is not None and b not in allowed:
            continue
        out.setdefault(b, []).append(p)
    return out


def _rewrap(scan: Scan, wrappers, files) -> LogicalPlan:
    import dataclasses

    rel = dataclasses.replace(scan.relation, file_paths=tuple(files),
                              bucket_spec=None, prune_to_buckets=None)
    node: LogicalPlan = Scan(rel)
    for w in reversed(wrappers):
        node = w.with_children((node,))
    return node
