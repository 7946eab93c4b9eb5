"""The device predicate (counterpart of hyperspace_tpu/ops/filter.py).

A predicate over numeric columns becomes a closure of torch ops over a
list of column tensors: elementwise compares, ``&``, ``|``, ``~``,
``torch.isin`` and + - * arithmetic.  In the JAX package this was one
jitted XLA program; here the ops run eagerly on the columns' device.
Closures are memoised by expression structure (``_PREDICATE_CACHE``, the
JAX package's key), with the literal values left out of the key: they are
arguments of the closure, so queries that differ only in their
constants share one closure.

Dtypes follow the JAX package's device path, which runs in 64-bit mode
with weakly typed literals: columns arrive as int64 or float64
(``io.columnar.to_device_numeric``), an int literal computes as int64 and
a float literal as float64.  Each literal becomes a 0-dim tensor of that
dtype on the columns' device, so torch promotes an int64 column compared
with a float literal to float64, as JAX does (a Python float would
promote it to torch's default float32 and change the mask above 2**24).
IN values are cast to the column's dtype, as ``jnp.asarray(values,
dtype=column.dtype)`` does: ``IsIn(int_col, [2.5])`` matches 2.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

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
)

_CMP = {
    "==": lambda a, b: a == b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}
_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
}

# Predicate closures keyed by (expression structure with IN values,
# column order); literal values are not in the key.
_PREDICATE_CACHE: Dict[Tuple, Callable] = {}
_PREDICATE_CACHE_MAX = 512


def _literal(value, device: torch.device) -> torch.Tensor:
    """A literal as the 0-dim tensor JAX computes it in: float64 for a
    float, int64 otherwise."""
    dtype = torch.float64 if isinstance(value, float) else torch.int64
    return torch.full((), value, dtype=dtype, device=device)


def _bind(fn: Callable) -> Callable:
    """``fn(cols, literal tensors)`` as ``f(cols, literals)``: a list of
    values, each typed on its own (``_literal``), or one 1-D tensor whose
    dtype types them all, as the JAX join→aggregate's
    ``jnp.asarray(np.asarray(lits))`` does (``[1, 2.5]`` is float64)."""

    def bound(cols: Sequence[torch.Tensor], lits) -> torch.Tensor:
        if isinstance(lits, torch.Tensor):
            return fn(cols, list(lits.unbind()))
        device = cols[0].device if len(cols) else torch.device("cpu")
        return fn(cols, [_literal(v, device) for v in lits])

    return bound


def _structure_value_key(e: Expr, parts: List, literals: List) -> None:
    """Pre-order fingerprint of a VALUE expression; collects literals in
    the order ``_build_value`` binds them."""
    if isinstance(e, Col):
        parts += ("c", e.name)
        return
    if isinstance(e, Lit):
        parts.append("L")
        literals.append(e.value)
        return
    if isinstance(e, Arith):
        if e.op == "/":
            # x / 0 must be null, and the device path has no nulls.
            raise ValueError(f"Division is not device-evaluable: {e!r}")
        parts += ("a", e.op)
        _structure_value_key(e.left, parts, literals)
        _structure_value_key(e.right, parts, literals)
        return
    if isinstance(e, Neg):
        parts.append("neg")
        _structure_value_key(e.child, parts, literals)
        return
    raise ValueError(f"Unsupported value expression: {e!r}")


def _structure_key(e: Expr, parts: List, literals: List) -> None:
    """Pre-order fingerprint of a predicate; collects literals in the
    order ``_build_predicate`` binds them."""
    if isinstance(e, BinOp):
        parts += ("b", e.op)
        _structure_value_key(e.left, parts, literals)
        _structure_value_key(e.right, parts, literals)
        return
    if isinstance(e, (And, Or)):
        parts.append("&" if isinstance(e, And) else "|")
        _structure_key(e.left, parts, literals)
        _structure_key(e.right, parts, literals)
        return
    if isinstance(e, Not):
        parts.append("~")
        _structure_key(e.child, parts, literals)
        return
    if isinstance(e, IsIn):
        if not isinstance(e.child, Col):
            raise ValueError(f"IsIn over non-column: {e!r}")
        parts += ("in", e.child.name, tuple(e.values))
        return
    raise ValueError(f"Unsupported predicate node: {e!r}")


def _build_value(e: Expr, col_ix: Dict[str, int], literals: List) -> Callable:
    if isinstance(e, Col):
        i = col_ix[e.name]
        return lambda cols, lits: cols[i]
    if isinstance(e, Lit):
        j = len(literals)
        literals.append(e.value)
        return lambda cols, lits: lits[j]
    if isinstance(e, Arith):
        if e.op == "/":
            raise ValueError(f"Division is not device-evaluable: {e!r}")
        fl = _build_value(e.left, col_ix, literals)
        fr = _build_value(e.right, col_ix, literals)
        op = _ARITH[e.op]
        return lambda cols, lits: op(fl(cols, lits), fr(cols, lits))
    if isinstance(e, Neg):
        f = _build_value(e.child, col_ix, literals)
        return lambda cols, lits: -f(cols, lits)
    raise ValueError(f"Unsupported value expression: {e!r}")


def _build_predicate(e: Expr, col_ix: Dict[str, int], literals: List) -> Callable:
    if isinstance(e, BinOp):
        op = _CMP[e.op]
        fl = _build_value(e.left, col_ix, literals)
        fr = _build_value(e.right, col_ix, literals)
        return lambda cols, lits: op(fl(cols, lits), fr(cols, lits))
    if isinstance(e, (And, Or)):
        fl = _build_predicate(e.left, col_ix, literals)
        fr = _build_predicate(e.right, col_ix, literals)
        if isinstance(e, And):
            return lambda cols, lits: fl(cols, lits) & fr(cols, lits)
        return lambda cols, lits: fl(cols, lits) | fr(cols, lits)
    if isinstance(e, Not):
        f = _build_predicate(e.child, col_ix, literals)
        return lambda cols, lits: ~f(cols, lits)
    if isinstance(e, IsIn):
        if not isinstance(e.child, Col):
            raise ValueError(f"IsIn over non-column: {e!r}")
        i = col_ix[e.child.name]
        values = list(e.values)
        return lambda cols, lits: torch.isin(
            cols[i], torch.tensor(values, dtype=cols[i].dtype,
                                  device=cols[i].device))
    raise ValueError(f"Unsupported predicate node: {e!r}")


def build_value_fn(expr: Expr, column_order: Sequence[str]
                   ) -> Tuple[Callable, List]:
    """(fn, literals) for a VALUE expression (columns, literals, + - *,
    negation): ``fn(columns, literals)`` is the elementwise result.
    Raises ValueError outside that subset (division is host-only)."""
    col_ix = {name: i for i, name in enumerate(column_order)}
    literals: List = []
    return _bind(_build_value(expr, col_ix, literals)), literals


def compile_predicate(expr: Expr, column_order: Sequence[str]
                      ) -> Tuple[Callable, List]:
    """(fn, literals): ``fn(columns, literals)`` is the boolean mask of
    ``expr`` over ``columns``, tensors in ``column_order`` on one device.
    The closure is memoised by expression structure, so a query that
    differs only in its literals gets the same ``fn``."""
    parts: List = []
    extracted: List = []
    _structure_key(expr, parts, extracted)
    key = (tuple(parts), tuple(column_order))
    cached = _PREDICATE_CACHE.get(key)
    if cached is not None:
        return cached, extracted
    literals: List = []
    fn = _bind(_build_predicate(
        expr, {name: i for i, name in enumerate(column_order)}, literals))
    # A closure whose literal order diverged must never be cached: later
    # queries would bind their literals to the wrong positions.
    if literals != extracted:
        raise AssertionError("literal traversal order diverged")
    if len(_PREDICATE_CACHE) >= _PREDICATE_CACHE_MAX:
        _PREDICATE_CACHE.clear()
    _PREDICATE_CACHE[key] = fn
    return fn, literals
