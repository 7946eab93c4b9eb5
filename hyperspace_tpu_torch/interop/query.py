"""JSON query spec -> Dataset (counterpart of
hyperspace_tpu/interop/query.py): the wire form of the plan verbs.

A spec is one JSON object:

    {"source": {"format": "parquet", "path": "/data/lineitem"},
     "filter": {"op": ">=", "col": "l_orderkey", "value": 100},
     "select": ["l_orderkey", "l_quantity"],
     "join":   {"source": {...}, "on": {"op": "==", "col": "a",
                                        "right_col": "b"}},
     "group_by": ["l_orderkey"],
     "aggs":   {"total": ["l_quantity", "sum"]}}

Verbs compose in the engine's canonical order: source -> filter -> join
-> group_by/aggs -> sort -> limit -> select (a select before grouping is
expressed by the pruning pass anyway).  Expressions use the same operator
names as the plan IR (==, <, <=, >, >=, and, or, not, in, is_null).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict

from hyperspace_tpu_torch.plan.expr import (
    And,
    Arith,
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
    StringMatch,
)

# The session in scope while a spec decodes: subquery specs need it to
# build their Dataset trees (thread-local: specs may decode concurrently
# on several threads).
_SPEC_TLS = threading.local()

# -- wire trace context ------------------------------------------------------
# A request spec may carry ``trace_id`` / ``request_id``: 16 lowercase hex
# chars (8 random bytes), minted by the client so a failure is
# correlatable from EITHER side of the wire.  The server adopts a valid
# id and MINTS its own for a missing/malformed one — a bad trace id must
# never reject a request (observability is advisory, the query is not).
TRACE_ID_HEX_CHARS = 16
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{16}$")


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace/request id (8 random bytes)."""
    return os.urandom(TRACE_ID_HEX_CHARS // 2).hex()


def valid_trace_id(value) -> bool:
    """Exactly 16 lowercase hex chars (uppercase normalizes on adopt)."""
    return isinstance(value, str) and \
        _TRACE_ID_RE.match(value.lower()) is not None


def pop_trace_context(spec):
    """Extract (and remove) the trace context from a decoded request
    spec: ``(trace_id, request_id, adopted)``.  ``adopted`` is True when
    the client's trace_id was usable; malformed/missing ids — wrong
    length, non-hex, non-string — fall back to server-minted ones.
    Never raises: the spec keys are popped even when unusable, so they
    cannot leak into query decoding."""
    raw_trace = spec.pop("trace_id", None)
    raw_request = spec.pop("request_id", None)
    adopted = valid_trace_id(raw_trace)
    trace_id = raw_trace.lower() if adopted else mint_trace_id()
    request_id = raw_request.lower() if valid_trace_id(raw_request) \
        else mint_trace_id()
    return trace_id, request_id, adopted


def _subquery_plan(spec: Dict[str, Any]):
    session = getattr(_SPEC_TLS, "session", None)
    if session is None:
        raise ValueError("Subquery specs are only valid inside a full "
                         "query spec (dataset_from_spec)")
    return dataset_from_spec(session, spec).plan


_CMP_OPS = ("==", "<", "<=", ">", ">=")
_ARITH_OPS = ("+", "-", "*", "/")


def value_expr_from_json(obj: Any) -> Expr:
    """A VALUE expression: bare JSON literal, {"col": name},
    {"value": v}, arithmetic {"op": "+", "left": ..., "right": ...},
    or {"op": "neg", "child": ...}."""
    if not isinstance(obj, dict):
        return Lit(obj)
    op = obj.get("op")
    if op in _ARITH_OPS:
        return Arith(op, value_expr_from_json(obj["left"]),
                     value_expr_from_json(obj["right"]))
    if op == "neg":
        return Neg(value_expr_from_json(obj["child"]))
    if op == "cast":
        return Cast(value_expr_from_json(obj["child"]), obj["type"])
    if op == "extract":
        # {"op": "extract", "field": "year", "child": {"col": "d"}}
        return Extract(obj["field"], value_expr_from_json(obj["child"]))
    if op == "scalar_subquery":
        # {"op": "scalar_subquery", "query": {full query spec}} — the
        # session resolves via the _SPEC_TLS thread-local that
        # dataset_from_spec sets while decoding.
        return ScalarSubquery(_subquery_plan(obj["query"]))
    if op == "outer_ref":
        return OuterRef(obj["name"])
    if op == "case":
        # {"op": "case", "branches": [[cond, value], ...],
        #  "otherwise": value?}  Conditions are BOOLEAN expressions.
        branches = [(expr_from_json(c), value_expr_from_json(v))
                    for c, v in obj["branches"]]
        otherwise = value_expr_from_json(obj["otherwise"]) \
            if "otherwise" in obj else Lit(None)
        return Case(branches, otherwise)
    if op is None and "col" in obj:
        return Col(obj["col"])
    if op is None and "value" in obj:
        return Lit(obj["value"])
    raise ValueError(f"Unknown value expression: {obj!r}")


def expr_from_json(obj: Dict[str, Any]) -> Expr:
    op = obj.get("op")
    if op in _CMP_OPS:
        if "left" in obj:
            # Structured form: both sides are value expressions
            # (arithmetic comparisons like l_ep * l_d > 100).
            return BinOp(op, value_expr_from_json(obj["left"]),
                         value_expr_from_json(obj["right"]))
        left = Col(obj["col"])
        if "right_col" in obj:
            return BinOp(op, left, Col(obj["right_col"]))
        return BinOp(op, left, Lit(obj["value"]))
    if op == "and":
        return And(expr_from_json(obj["left"]), expr_from_json(obj["right"]))
    if op == "or":
        return Or(expr_from_json(obj["left"]), expr_from_json(obj["right"]))
    if op == "not":
        return Not(expr_from_json(obj["child"]))
    if op == "in":
        return IsIn(Col(obj["col"]), list(obj["values"]))
    if op == "is_null":
        return IsNull(Col(obj["col"]))
    if op == "in_subquery":
        # {"op": "in_subquery", "col": "k", "query": {full query spec}};
        # wrap in {"op": "not", ...} for SQL's null-aware NOT IN.
        return InSubquery(Col(obj["col"]), _subquery_plan(obj["query"]))
    if op in StringMatch.KINDS:
        return StringMatch(op, Col(obj["col"]), obj["pattern"])
    raise ValueError(f"Unknown expression op: {op!r}")


# Wire input never reaches arbitrary attributes: explicit reader allowlist.
_SOURCE_FORMATS = ("parquet", "csv", "json", "orc", "avro", "text",
                   "delta", "iceberg")


def _read_source(session, source: Dict[str, Any]):
    fmt = source.get("format", "parquet")
    if fmt not in _SOURCE_FORMATS:
        raise ValueError(f"Unknown source format: {fmt!r}")
    path = source["path"]
    options = source.get("options", {})
    reader = getattr(session.read, fmt)
    return reader(path, **options) if options else reader(path)


def dataset_from_spec(session, spec: Dict[str, Any]):
    """Build a Dataset from ``spec`` against ``session`` (whose hyperspace
    enablement and indexes govern rewrites, exactly as for local use)."""
    prev = getattr(_SPEC_TLS, "session", None)
    _SPEC_TLS.session = session
    try:
        return _dataset_from_spec(session, spec)
    finally:
        _SPEC_TLS.session = prev


def _dataset_from_spec(session, spec: Dict[str, Any]):
    ds = _read_source(session, spec["source"])
    if "filter" in spec:
        ds = ds.filter(expr_from_json(spec["filter"]))
    if "join" in spec:
        j = spec["join"]
        other = _read_source(session, j["source"])
        if "filter" in j:
            other = other.filter(expr_from_json(j["filter"]))
        ds = ds.join(other, expr_from_json(j["on"]), j.get("how", "inner"))
    if "union" in spec:
        # UNION ALL with another full spec (query.py composes recursively).
        ds = ds.union(dataset_from_spec(session, spec["union"]))
    if "aggs" in spec or "group_by" in spec:
        grouped = ds.group_by(*spec.get("group_by", []))
        # {out: [col_or_value_expr, func]}; expression inputs arrive as
        # structured objects (value_expr_from_json).
        aggs = {out: (value_expr_from_json(src) if isinstance(src, dict)
                      else src, func)
                for out, (src, func) in spec.get("aggs", {}).items()}
        ds = grouped.agg(**aggs) if aggs else grouped.count()
    if "window" in spec:
        # [{"name": out, "func": "rank", "partition_by": [...],
        #   "order_by": ["c" | ["c", false], ...], "value": "v"?}, ...]
        for w in spec["window"]:
            keys = [k if isinstance(k, str) else tuple(k)
                    for k in w.get("order_by", [])]
            ds = ds.with_window(w["name"], w["func"],
                                partition_by=w.get("partition_by", ()),
                                order_by=keys, value=w.get("value"))
    if "qualify" in spec:
        # SQL QUALIFY: a filter over window outputs ("filter" runs
        # before windows, like WHERE).
        ds = ds.filter(expr_from_json(spec["qualify"]))
    if "sort" in spec:
        # ["col", ...] or [["col", false], ...] for descending; malformed
        # entries fail Dataset.sort's validation with a clear message.
        keys = [k if isinstance(k, str) else tuple(k) for k in spec["sort"]]
        ds = ds.sort(*keys)
    if "limit" in spec:
        ds = ds.limit(int(spec["limit"]))
    if "select" in spec:
        # Entries are column names, or {"name": out, "expr": value-expr}
        # for computed projections.  When any computed entry is present the
        # Compute node is built directly in spec order — Dataset.select's
        # names-then-keywords signature would move computed columns after
        # all plain names, losing the caller's interleaving.
        entries = spec["select"]
        if any(isinstance(c, dict) for c in entries):
            from hyperspace_tpu_torch.dataset import Dataset
            from hyperspace_tpu_torch.plan.nodes import Compute

            exprs = [(c, Col(c)) if isinstance(c, str)
                     else (c["name"], value_expr_from_json(c["expr"]))
                     for c in entries]
            ds = Dataset(Compute(exprs, ds.plan), ds.session)
        else:
            ds = ds.select(*entries)
    return ds
