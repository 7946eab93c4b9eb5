"""Expression language of the logical plan (counterpart of
hyperspace_tpu/plan/expr.py).

Column references, literals, comparisons, + - * / arithmetic, negation,
the boolean connectives, IN, IS [NOT] NULL, the containment rewrite's
``BucketIn``, the string predicates (LIKE and friends), ``Cast``,
``Case``, the string functions, ``Extract`` and the subquery nodes
(``ScalarSubquery``, ``InSubquery``, ``Exists``, ``OuterRef``).
``repr`` is the JAX package's, so plans print alike.  Strings, CASE,
CAST and ``Extract`` are evaluated on the host (the arrow path); the
subquery nodes never reach the executor (``plan/subquery.py`` rewrites
them away at optimize time).  Nothing here imports pyarrow: ``Cast``
checks its type name through ``io.parquet`` inside the constructor.
"""

from __future__ import annotations

import re
from typing import Any, Iterable, List, Optional, Sequence, Set, Tuple


class Expr:
    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _lift(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _lift(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    def __eq__(self, other: Any) -> "Expr":  # type: ignore[override]
        return BinOp("==", self, _lift(other))

    def __ne__(self, other: Any) -> "Expr":  # type: ignore[override]
        return Not(BinOp("==", self, _lift(other)))

    def __lt__(self, other: Any) -> "Expr":
        return BinOp("<", self, _lift(other))

    def __le__(self, other: Any) -> "Expr":
        return BinOp("<=", self, _lift(other))

    def __gt__(self, other: Any) -> "Expr":
        return BinOp(">", self, _lift(other))

    def __ge__(self, other: Any) -> "Expr":
        return BinOp(">=", self, _lift(other))

    def __add__(self, other: Any) -> "Expr":
        return Arith("+", self, _lift(other))

    def __radd__(self, other: Any) -> "Expr":
        return Arith("+", _lift(other), self)

    def __sub__(self, other: Any) -> "Expr":
        return Arith("-", self, _lift(other))

    def __rsub__(self, other: Any) -> "Expr":
        return Arith("-", _lift(other), self)

    def __mul__(self, other: Any) -> "Expr":
        return Arith("*", self, _lift(other))

    def __rmul__(self, other: Any) -> "Expr":
        return Arith("*", _lift(other), self)

    def __truediv__(self, other: Any) -> "Expr":
        return Arith("/", self, _lift(other))

    def __rtruediv__(self, other: Any) -> "Expr":
        return Arith("/", _lift(other), self)

    def __neg__(self) -> "Expr":
        return Neg(self)

    def isin(self, values: Iterable[Any]) -> "Expr":
        return IsIn(self, list(values))

    def is_null(self) -> "Expr":
        return IsNull(self)

    def is_not_null(self) -> "Expr":
        return Not(IsNull(self))

    def cast(self, type_name: str) -> "Expr":
        """CAST with Spark's non-ANSI semantics: a value that does not
        convert (``'abc'`` AS INT, an overflow) becomes null.
        ``type_name`` is an arrow type name (int8..int64, float32/float64,
        string, bool, date32, timestamp[us], ...) or a Spark spelling."""
        return Cast(self, type_name)

    # String predicates, evaluated on the host: strings never take the
    # device path.
    def like(self, pattern: str) -> "Expr":
        """SQL LIKE: ``%`` any run, ``_`` one character (case sensitive)."""
        return StringMatch("like", self, pattern)

    def startswith(self, prefix: str) -> "Expr":
        return StringMatch("startswith", self, prefix)

    def endswith(self, suffix: str) -> "Expr":
        return StringMatch("endswith", self, suffix)

    def contains(self, needle: str) -> "Expr":
        return StringMatch("contains", self, needle)

    def __hash__(self) -> int:
        return hash(repr(self))

    def referenced_columns(self) -> Set[str]:
        out: Set[str] = set()
        _collect_columns(self, out)
        return out


class Col(Expr):
    def __init__(self, name: str) -> None:
        self.name = name

    def __repr__(self) -> str:
        return f"col({self.name!r})"


class Lit(Expr):
    def __init__(self, value: Any) -> None:
        self.value = value

    def __repr__(self) -> str:
        return f"lit({self.value!r})"


class BinOp(Expr):
    """Comparison: ==, <, <=, >, >=."""

    OPS = ("==", "<", "<=", ">", ">=")

    def __init__(self, op: str, left: Expr, right: Expr) -> None:
        if op not in self.OPS:
            raise ValueError(f"Unsupported op {op!r}")
        self.op = op
        self.left = left
        self.right = right

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


class Arith(Expr):
    """Numeric arithmetic: + - * /.  Division gives a float64 and a zero
    denominator gives null (the row drops in any comparison), so it is
    evaluated on the host only; + - * keep arrow's type promotion."""

    OPS = ("+", "-", "*", "/")

    def __init__(self, op: str, left: Expr, right: Expr) -> None:
        if op not in self.OPS:
            raise ValueError(f"Unsupported arithmetic op {op!r}")
        self.op = op
        self.left = left
        self.right = right

    def __repr__(self) -> str:
        return f"({self.left!r} {self.op} {self.right!r})"


class Neg(Expr):
    def __init__(self, child: Expr) -> None:
        self.child = child

    def __repr__(self) -> str:
        return f"(-{self.child!r})"


class And(Expr):
    def __init__(self, left: Expr, right: Expr) -> None:
        self.left = left
        self.right = right

    def __repr__(self) -> str:
        return f"({self.left!r} & {self.right!r})"


class Or(Expr):
    def __init__(self, left: Expr, right: Expr) -> None:
        self.left = left
        self.right = right

    def __repr__(self) -> str:
        return f"({self.left!r} | {self.right!r})"


class Not(Expr):
    def __init__(self, child: Expr) -> None:
        self.child = child

    def __repr__(self) -> str:
        return f"~{self.child!r}"


class IsIn(Expr):
    def __init__(self, child: Expr, values: List[Any]) -> None:
        self.child = child
        self.values = values

    def __repr__(self) -> str:
        return f"{self.child!r}.isin({self.values!r})"


class BucketIn(Expr):
    """Rows whose bucket over ``columns`` (the build's hash, bit-equal on
    every route) is in ``buckets``.  Only the quarantine containment
    rewrite builds it (rules/hybrid.py): the branch that replaces a
    quarantined bucket is ``Filter(BucketIn(indexed, num_buckets, {b}),
    Scan(source))``, so exactly the rows the damaged bucket held are read
    from the source.  Never null (a null key hashes to its own bucket, as
    in the build); evaluated on the arrow route, and opaque to the device
    predicate and to every pruning analysis."""

    def __init__(self, columns: Sequence[str], num_buckets: int,
                 buckets: Sequence[int]) -> None:
        if not columns or num_buckets <= 0:
            raise ValueError("BucketIn needs columns and num_buckets > 0")
        self.columns = tuple(columns)
        self.num_buckets = int(num_buckets)
        self.buckets = tuple(sorted({int(b) for b in buckets}))

    def __repr__(self) -> str:
        return (f"bucket_in({list(self.columns)!r}, {self.num_buckets}, "
                f"{list(self.buckets)!r})")


class StringMatch(Expr):
    """SQL string predicate: like, startswith, endswith or contains.  A
    null input gives null (the row drops), as SQL's LIKE does."""

    KINDS = ("like", "startswith", "endswith", "contains")

    def __init__(self, kind: str, child: Expr, pattern: str) -> None:
        if kind not in self.KINDS:
            raise ValueError(f"Unsupported string match {kind!r}")
        if not isinstance(pattern, str):
            raise ValueError(
                f"{kind} pattern must be a string, got {pattern!r}")
        self.kind = kind
        self.child = child
        self.pattern = pattern

    def __repr__(self) -> str:
        return f"{self.child!r}.{self.kind}({self.pattern!r})"


# Spark's type names as arrow aliases, so cast("long") is an int64 and not
# a string.
_CAST_ALIASES = {
    "long": "int64", "bigint": "int64",
    "integer": "int32", "int": "int32",
    "short": "int16", "smallint": "int16",
    "byte": "int8", "tinyint": "int8",
    "double": "float64", "float": "float32",
    "boolean": "bool", "str": "string",
    # Spark's DATE counts days; its TIMESTAMP microseconds.
    "date": "date32", "timestamp": "timestamp[us]",
}


class Cast(Expr):
    """CAST(child AS type) with Spark's non-ANSI null on failure.  The
    type name is checked here: an unknown name raises instead of falling
    back to a string column, which would compare wrongly."""

    def __init__(self, child: Expr, type_name: str) -> None:
        if not isinstance(type_name, str) or not type_name:
            raise ValueError(f"cast type must be a type name, got "
                             f"{type_name!r}")
        # Type names are case-insensitive, but only the head is
        # lowercased: the payload of timestamp[us, tz=America/New_York]
        # holds a case-sensitive zone name.
        m = re.match(r"([^\[\(]*)(.*)", type_name, re.DOTALL)
        head, payload = m.group(1).strip().lower(), m.group(2)
        # An alias applies to a bare name only: "timestamp[ns]" keeps its
        # own unit.
        name = (head if payload else _CAST_ALIASES.get(head, head)) + payload
        from hyperspace_tpu_torch.io.parquet import is_cast_type_name

        if not is_cast_type_name(name):
            raise ValueError(
                f"Unknown cast type {type_name!r}; use an arrow type name "
                f"(int8..int64, float32/float64, string, bool, date32, "
                f"timestamp[us], ...) or a Spark spelling "
                f"({', '.join(sorted(_CAST_ALIASES))})")
        self.child = child
        self.type_name = name

    def __repr__(self) -> str:
        return f"{self.child!r}.cast({self.type_name!r})"


class Case(Expr):
    """CASE WHEN ... THEN ... [ELSE ...] END with Spark's semantics: the
    branches are tried in order, a null condition is false, and with no
    ELSE the result is null.  Built with ``when()``:

        when(col("p") > 5, 1).when(col("p") > 2, 2).otherwise(0)
    """

    def __init__(self, branches, otherwise: "Expr") -> None:
        if not branches:
            raise ValueError("CASE needs at least one WHEN branch")
        self.branches = tuple((c, v) for c, v in branches)
        self.otherwise = otherwise

    def __repr__(self) -> str:
        parts = " ".join(f"WHEN {c!r} THEN {v!r}" for c, v in self.branches)
        return f"CASE {parts} ELSE {self.otherwise!r} END"


class CaseBuilder:
    """WHEN branches so far; ``.otherwise(value)`` or ``.end()`` (no
    ELSE: null when no branch matches) makes the ``Case``."""

    def __init__(self, branches) -> None:
        self._branches = branches

    def when(self, condition: "Expr", value: Any) -> "CaseBuilder":
        return CaseBuilder(self._branches + [(condition, _lift(value))])

    def otherwise(self, value: Any) -> Case:
        return Case(self._branches, _lift(value))

    def end(self) -> Case:
        """No ELSE: null when no branch matches."""
        return Case(self._branches, Lit(None))


def when(condition: Expr, value: Any) -> CaseBuilder:
    """Start a CASE: ``when(cond, value).otherwise(default)``."""
    return CaseBuilder([(condition, _lift(value))])


class StringFn(Expr):
    """Spark's scalar string functions upper, lower, length, trim (and
    ltrim, rtrim), substring and concat, evaluated on the host.  A null
    input gives null (concat: any null argument); substring's start is
    1-based and its length optional."""

    NAMES = ("upper", "lower", "length", "trim", "ltrim", "rtrim",
             "substring", "concat")

    def __init__(self, name: str, args: Sequence["Expr"]) -> None:
        if name not in self.NAMES:
            raise ValueError(f"Unsupported string function {name!r}; "
                             f"one of {self.NAMES}")
        if name == "substring":
            if len(args) not in (2, 3):
                raise ValueError("substring(expr, start[, length])")
            for a in args[1:]:
                if not (isinstance(a, Lit) and isinstance(a.value, int)
                        and not isinstance(a.value, bool)):
                    raise ValueError(
                        "substring start/length must be integer literals")
            if args[1].value < 1:
                raise ValueError(
                    "substring start is 1-BASED and must be >= 1 "
                    "(Spark's 0/negative-start forms are not supported)")
            if len(args) == 3 and args[2].value < 0:
                raise ValueError("substring length must be >= 0")
        elif name == "concat":
            if len(args) < 2:
                raise ValueError("concat needs at least two arguments")
        elif len(args) != 1:
            raise ValueError(f"{name}() takes one argument")
        self.name = name
        self.args = tuple(args)

    def __repr__(self) -> str:
        inner = ", ".join(repr(a) for a in self.args)
        return f"{self.name}({inner})"


def _col_or(e: "Expr | str") -> Expr:
    return Col(e) if isinstance(e, str) else e


def upper(e: "Expr | str") -> StringFn:
    return StringFn("upper", [_col_or(e)])


def lower(e: "Expr | str") -> StringFn:
    return StringFn("lower", [_col_or(e)])


def length(e: "Expr | str") -> StringFn:
    return StringFn("length", [_col_or(e)])


def trim(e: "Expr | str") -> StringFn:
    return StringFn("trim", [_col_or(e)])


def substring(e: "Expr | str", start: int, length_: "int | None" = None
              ) -> StringFn:
    """SQL SUBSTRING: 1-based ``start``, optional ``length``."""
    args = [_col_or(e), Lit(int(start))]
    if length_ is not None:
        args.append(Lit(int(length_)))
    return StringFn("substring", args)


def concat(*parts: "Expr | str") -> StringFn:
    return StringFn("concat",
                    [Col(p) if isinstance(p, str) else _lift(p)
                     for p in parts])


class Extract(Expr):
    """A calendar field of a date or timestamp: Spark's ``year``,
    ``month``, ``dayofmonth`` and ``quarter``, as an int32.  Evaluated on
    the host; ``year(col) CMP literal`` over a temporal scan column
    becomes a range on the column at optimize time (plan/temporal.py), so
    data skipping and the device predicate serve it."""

    FIELDS = ("year", "month", "day", "quarter")

    def __init__(self, field: str, child: Expr) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"Unsupported extract field {field!r}; "
                             f"one of {self.FIELDS}")
        self.field = field
        self.child = child

    def __repr__(self) -> str:
        return f"{self.field}({self.child!r})"


def year(e: "Expr | str") -> Extract:
    return Extract("year", _col_or(e))


def month(e: "Expr | str") -> Extract:
    return Extract("month", _col_or(e))


def dayofmonth(e: "Expr | str") -> Extract:
    return Extract("day", _col_or(e))


def quarter(e: "Expr | str") -> Extract:
    return Extract("quarter", _col_or(e))


class IsNull(Expr):
    """SQL IS NULL: true for null values, where a comparison with a null
    drops the row.  The device filter path and every pruning analysis
    treat it as an opaque shape; it is evaluated on the arrow path."""

    def __init__(self, child: Expr) -> None:
        self.child = child

    def __repr__(self) -> str:
        return f"{self.child!r}.is_null()"


class ScalarSubquery(Expr):
    """A one-column subquery used as a value.  Rewritten at optimize time
    (plan/subquery.py): an uncorrelated one runs once and becomes a
    literal; a correlated one (holding ``outer_ref`` markers) becomes an
    aggregate by the correlation keys and a join.  It never reaches the
    executor."""

    def __init__(self, plan) -> None:
        # A Dataset or a LogicalPlan (duck-typed: dataset imports this
        # module).
        self.plan = getattr(plan, "plan", plan)

    def __repr__(self) -> str:
        return f"scalar_subquery({type(self.plan).__name__})"


class InSubquery(Expr):
    """``child IN (SELECT one column ...)``: a semi join at optimize
    time; under NOT, a null-aware anti join (SQL's NOT IN answers no row
    when the subquery yields a null)."""

    def __init__(self, child: Expr, plan) -> None:
        self.child = child
        self.plan = getattr(plan, "plan", plan)

    def __repr__(self) -> str:
        return f"{self.child!r}.isin(subquery({type(self.plan).__name__}))"


class OuterRef(Expr):
    """A column of the outer query, inside a subquery (Spark's
    OuterReference).  The rewrite turns the equality around it into a
    join key."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __repr__(self) -> str:
        return f"outer_ref({self.name!r})"


class Exists(Expr):
    """``EXISTS (SELECT ... [WHERE inner == outer_ref(...)])``: a
    correlated one becomes a semi join on the correlation equalities
    (``~exists``: an anti join), with any inequality correlation as the
    join's residual; an uncorrelated one is probed once and folds to
    true or false.  Only the existence of rows counts, so the subquery's
    own projection is dropped."""

    def __init__(self, plan) -> None:
        self.plan = getattr(plan, "plan", plan)

    def __repr__(self) -> str:
        return f"exists({type(self.plan).__name__})"


def exists(ds) -> Exists:
    """EXISTS: ``filter(exists(sub))`` or ``filter(~exists(sub))``."""
    return Exists(ds)


def scalar(ds) -> ScalarSubquery:
    """A scalar subquery: ``filter(col('v') > scalar(sub) * 1.2)``."""
    return ScalarSubquery(ds)


def in_subquery(column: "Expr | str", ds) -> InSubquery:
    """IN over a subquery: ``filter(in_subquery('k', sub))``."""
    return InSubquery(_col_or(column), ds)


def outer_ref(name: str) -> OuterRef:
    return OuterRef(name)


def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)


def _lift(v: Any) -> Expr:
    return v if isinstance(v, Expr) else Lit(v)


def _collect_columns(e: Expr, out: Set[str]) -> None:
    if isinstance(e, Col):
        out.add(e.name)
    elif isinstance(e, (BinOp, Arith, And, Or)):
        _collect_columns(e.left, out)
        _collect_columns(e.right, out)
    elif isinstance(e, (Neg, Not, IsIn, IsNull, StringMatch, Cast, Extract,
                        InSubquery)):
        _collect_columns(e.child, out)
    elif isinstance(e, BucketIn):
        out.update(e.columns)
    elif isinstance(e, StringFn):
        for a in e.args:
            _collect_columns(a, out)
    elif isinstance(e, Case):
        for c, v in e.branches:
            _collect_columns(c, out)
            _collect_columns(v, out)
        _collect_columns(e.otherwise, out)
    # ScalarSubquery and OuterRef read no column of the outer query; the
    # subquery rewrite runs before every pass that asks.


def split_conjuncts(e: Expr) -> List[Expr]:
    """Flatten a chain of Ands."""
    if isinstance(e, And):
        return split_conjuncts(e.left) + split_conjuncts(e.right)
    return [e]


def conjoin(conjuncts: Sequence[Expr]) -> Expr:
    """Left-fold a non-empty conjunct list back into one And chain —
    ``split_conjuncts``' inverse."""
    if not conjuncts:
        raise ValueError("conjoin needs at least one conjunct")
    cond = conjuncts[0]
    for c in conjuncts[1:]:
        cond = And(cond, c)
    return cond


def as_equi_join_pairs(condition: Expr) -> Optional[List[Tuple[str, str]]]:
    """If ``condition`` is a conjunction of column == column equalities,
    the (left_name, right_name) pairs; else None."""
    pairs = []
    for conj in split_conjuncts(condition):
        if (isinstance(conj, BinOp) and conj.op == "=="
                and isinstance(conj.left, Col) and isinstance(conj.right, Col)):
            pairs.append((conj.left.name, conj.right.name))
        else:
            return None
    return pairs
