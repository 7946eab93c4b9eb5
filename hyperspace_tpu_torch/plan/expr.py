"""Expression language of the logical plan (counterpart of
hyperspace_tpu/plan/expr.py, its filter-and-join subset).

Column references, literals, comparisons, + - * / arithmetic, negation,
the boolean connectives, IN, IS [NOT] NULL and the containment rewrite's
``BucketIn``.  ``repr`` is the JAX package's, so plans print alike.
String predicates, ``Cast``, ``Case``, ``Extract`` and the subquery
nodes are not ported.
"""

from __future__ import annotations

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


class IsNull(Expr):
    """SQL IS NULL: true for null values, where a comparison with a null
    drops the row.  The device filter path and every pruning analysis
    treat it as an opaque shape; it is evaluated on the arrow path."""

    def __init__(self, child: Expr) -> None:
        self.child = child

    def __repr__(self) -> str:
        return f"{self.child!r}.is_null()"


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
    elif isinstance(e, (Neg, Not, IsIn, IsNull)):
        _collect_columns(e.child, out)
    elif isinstance(e, BucketIn):
        out.update(e.columns)


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
