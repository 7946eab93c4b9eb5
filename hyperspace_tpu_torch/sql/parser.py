"""A recursive-descent SELECT parser lowering to the Dataset DSL
(counterpart of hyperspace_tpu/sql/parser.py: the same dialect, the same
lowering onto the port's verbs and ``plan/expr.py`` nodes, and the same
error texts and positions).

Supported surface (the shapes the reference's TPC corpus uses):

    SELECT [DISTINCT] items | *
    FROM table [alias] | (subquery) [alias]
    [ [INNER|LEFT [OUTER]|RIGHT [OUTER]|FULL [OUTER]|[LEFT] SEMI|
       [LEFT] ANTI] JOIN source ON cond ]...
    [WHERE cond] [GROUP BY keys] [HAVING cond]
    [ORDER BY out [ASC|DESC], ...] [LIMIT n]

Expressions: literals (numbers, 'strings', DATE 'yyyy-mm-dd', TRUE/
FALSE/NULL), [alias.]column, + - * /, comparisons (= <> != < <= > >=),
AND/OR/NOT, BETWEEN, [NOT] IN (list | subquery), [NOT] LIKE, IS [NOT]
NULL, CASE WHEN, CAST(x AS type), EXTRACT(field FROM x) and
year/month/day/quarter(x), aggregate calls (sum/min/max/avg/count/
count(DISTINCT x)/stddev/variance), window calls ``func(...) OVER
(PARTITION BY ... ORDER BY ...)`` as top-level select items, scalar
subqueries ``(SELECT ...)``.  A column qualified by an alias not in the
current scope becomes ``outer_ref`` — SQL's correlated subquery form.

[NOT] EXISTS (SELECT ... WHERE inner = alias.outer) lowers to the
SEMI/ANTI join rewrite (plan/subquery.py); the subquery's own select
list is existence-only, so ``SELECT 1`` works.  In NON-aggregate select
lists, unaliased computed items auto-name as ``_c<position>``;
aggregate select items still require AS aliases (their names become the
aggregate outputs).
"""

from __future__ import annotations

import datetime
import re
from typing import Any, Dict, List, Optional, Tuple

from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.plan.expr import (
    And,
    BinOp,
    Case,
    Cast,
    Col,
    Exists,
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
)
from hyperspace_tpu_torch.plan.nodes import Compute
from hyperspace_tpu_torch.plan.subquery import _contains, _map_expr, _walk_exprs


class SqlError(ValueError):
    """Parse or lowering failure, with position context."""


# ---- markers local to lowering -----------------------------------------

class _AggCall(Expr):
    def __init__(self, func: str, arg: Optional[Expr]) -> None:
        self.func = func  # engine spelling (mean, count_all, ...)
        # Named "child" so the shared expression walkers
        # (plan/subquery._walk_exprs) descend into it.
        self.child = arg

    def __repr__(self) -> str:
        return f"_agg_{self.func}({self.child!r})"


class _WindowCall(Expr):
    def __init__(self, func, value, partition_by, order_by,
                 offset: int = 1, frame=None) -> None:
        self.func = func
        self.value = value
        self.partition_by = partition_by
        self.order_by = order_by
        self.offset = offset
        self.frame = frame

    def __repr__(self) -> str:
        # STRUCTURAL repr: ORDER BY-expression resolution matches select
        # items by repr, so two windows differing only in value/keys/
        # frame must never collide.
        return (f"_window_{self.func}({self.value!r}, "
                f"p={list(self.partition_by)!r}, "
                f"o={list(self.order_by)!r}, k={self.offset}, "
                f"f={self.frame!r})")


_AGG_FUNCS = {"sum": "sum", "min": "min", "max": "max", "avg": "mean",
              "mean": "mean", "count": "count", "stddev": "stddev",
              "variance": "variance"}
_WINDOW_FUNCS = ("row_number", "rank", "dense_rank", "ntile", "sum",
                 "min", "max", "avg", "count", "lag", "lead",
                 "first_value", "last_value")
_EXTRACT_FUNCS = {"year": "year", "month": "month", "day": "day",
                  "dayofmonth": "day", "quarter": "quarter"}

_NAME_KINDS = ("ident", "qident")

_TOKEN_RE = re.compile(r"""
    \s+
  | --[^\n]*
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^']|'')*')
  | (?P<bq>`[^`]*`)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><>|!=|<=|>=|=|<|>|\(|\)|,|\.|\*|\+|-|/|;)
""", re.VERBOSE)


def _tokenize(text: str) -> List[Tuple[str, str, int]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SqlError(f"Unexpected character {text[pos]!r} at "
                           f"position {pos}: ...{text[pos:pos+20]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            out.append(("num", m.group("num"), m.start()))
        elif m.lastgroup == "str":
            out.append(("str", m.group("str")[1:-1].replace("''", "'"),
                        m.start()))
        elif m.lastgroup == "bq":
            # Backtick-quoted identifier (TPC-DS q32/q92 alias spelling):
            # its OWN token kind, so quoting a reserved word (`from`,
            # `order`) never trips the keyword matchers — only the
            # name-position readers accept it (_NAME_KINDS).
            out.append(("qident", m.group("bq")[1:-1], m.start()))
        elif m.lastgroup == "ident":
            out.append(("ident", m.group("ident"), m.start()))
        elif m.lastgroup == "op":
            out.append(("op", m.group("op"), m.start()))
    out.append(("eof", "", len(text)))
    return out


class _Parser:
    def __init__(self, text: str, session, tables: Dict[str, Any],
                 outer_aliases: Tuple[str, ...] = (),
                 outer_columns: frozenset = frozenset()) -> None:
        self.text = text
        self.tokens = _tokenize(text)
        self.i = 0
        self.session = session
        self.tables = tables
        self.outer_aliases = outer_aliases
        # Column names visible in the ENCLOSING query's scope: a bare
        # name unknown here but known there is an implicit correlation
        # (TPC-DS q32/q92 correlate through bare names).
        self.outer_columns = outer_columns
        self.aliases: List[str] = []  # this query's own scope
        # FROM-order source registry: ({names}, [columns] or None) per
        # source, for qualified-reference validation.
        self.sources: List[Tuple[set, Optional[List[str]]]] = []
        # Comma-style self-join lift: alias -> column prefix for later
        # occurrences of an already-seen table, whose columns are
        # renamed so every column has exactly one owning source.
        self.qual_rename: Dict[str, str] = {}
        self._in_join_on = False

    # -- token plumbing --------------------------------------------------
    def peek(self, offset: int = 0):
        return self.tokens[min(self.i + offset, len(self.tokens) - 1)]

    def next(self):
        t = self.tokens[self.i]
        self.i = min(self.i + 1, len(self.tokens) - 1)
        return t

    def at_kw(self, *words: str) -> bool:
        t = self.peek()
        return t[0] == "ident" and t[1].upper() in words

    def take_kw(self, *words: str) -> bool:
        if self.at_kw(*words):
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.take_kw(word):
            self.fail(f"expected {word}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t[0] == "op" and t[1] in ops

    def take_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.take_op(op):
            self.fail(f"expected {op!r}")

    def fail(self, msg: str) -> None:
        t = self.peek()
        raise SqlError(f"{msg} at position {t[2]} (near {t[1]!r}): "
                       f"...{self.text[t[2]:t[2] + 30]!r}")

    # -- query -----------------------------------------------------------
    def parse_select(self, allow_tail: bool = True):
        self.expect_kw("SELECT")
        distinct = self.take_kw("DISTINCT")
        # FROM declares the aliases the select list references, so parse
        # it FIRST: skip ahead to the depth-0 FROM, build the sources,
        # then come back for the items with the scope populated.
        items_start = self.i
        self._skip_to_from()
        self.expect_kw("FROM")
        ds = self.parse_from()
        after_from = self.i
        self.i = items_start
        items = self.parse_select_items()
        if not self.at_kw("FROM"):
            self.fail("expected FROM after the select list")
        self.i = after_from
        where = None
        if self.take_kw("WHERE"):
            where = self.parse_expr()
        if isinstance(ds, _CommaJoin):
            ds, where = _assemble_comma_join(self, ds.items, where)
        group_by: List[str] = []
        if self.take_kw("GROUP"):
            self.expect_kw("BY")
            group_by = self.parse_group_keys()
        having = None
        if self.take_kw("HAVING"):
            having = self.parse_expr()
        order_by: List[Tuple[str, bool]] = []
        limit = None
        if allow_tail:
            # Inside a UNION chain the trailing ORDER BY/LIMIT bind the
            # WHOLE union (SQL), so branch parses leave them untouched.
            if self.take_kw("ORDER"):
                self.expect_kw("BY")
                order_by = self.parse_order_keys()
            if self.take_kw("LIMIT"):
                limit = self.parse_limit_count()
        return _lower(self, ds, items, distinct, where, group_by, having,
                      order_by, limit)

    def parse_limit_count(self) -> int:
        t = self.next()
        if t[0] != "num":
            self.fail("expected a number after LIMIT")
        return int(t[1])

    def _parse_frame_bound(self):
        """One frame bound → ("unb", ±1) or ("off", signed_row_offset)."""
        if self.take_kw("UNBOUNDED"):
            if self.take_kw("PRECEDING"):
                return ("unb", -1)
            if self.take_kw("FOLLOWING"):
                return ("unb", 1)
            self.fail("expected PRECEDING or FOLLOWING after UNBOUNDED")
        if self.take_kw("CURRENT"):
            self.expect_kw("ROW")
            return ("off", 0)
        t = self.next()
        if t[0] != "num" or "." in str(t[1]):
            self.fail("expected UNBOUNDED, CURRENT ROW, or an integer "
                      "frame offset")
        k = int(t[1])
        if self.take_kw("PRECEDING"):
            return ("off", -k)
        if self.take_kw("FOLLOWING"):
            return ("off", k)
        self.fail("expected PRECEDING or FOLLOWING after the frame "
                  "offset")

    def parse_frame_clause(self):
        """Optional window frame.  ROWS frames lower to the engine's
        (lo, hi) row-offset pair (None = unbounded); RANGE accepts only
        the shapes equal to SQL's DEFAULT frame (UNBOUNDED PRECEDING ..
        CURRENT ROW, the form TPC-DS q51 spells out) and returns None so peers share values."""
        is_range = False
        if self.take_kw("ROWS"):
            pass
        elif self.take_kw("RANGE"):
            is_range = True
        else:
            return None
        if self.take_kw("BETWEEN"):
            lo_b = self._parse_frame_bound()
            self.expect_kw("AND")
            hi_b = self._parse_frame_bound()
        else:  # SQL shorthand: <bound> means BETWEEN <bound> AND CURRENT
            lo_b = self._parse_frame_bound()
            hi_b = ("off", 0)
        if lo_b == ("unb", 1):
            self.fail("frame cannot start at UNBOUNDED FOLLOWING")
        if hi_b == ("unb", -1):
            self.fail("frame cannot end at UNBOUNDED PRECEDING")
        lo = None if lo_b[0] == "unb" else lo_b[1]
        hi = None if hi_b[0] == "unb" else hi_b[1]
        if is_range:
            if not (lo is None and hi == 0):
                self.fail("Only RANGE BETWEEN UNBOUNDED PRECEDING AND "
                          "CURRENT ROW is supported; use a ROWS frame "
                          "for offset frames")
            return None  # identical to the default frame
        if lo is not None and hi is not None and lo > hi:
            self.fail(f"frame lower bound {lo} is above upper bound "
                      f"{hi}")
        return (lo, hi)

    def _skip_to_from(self) -> None:
        depth = 0
        while True:
            t = self.peek()
            if t[0] == "eof":
                self.fail("expected FROM")
            if t[0] == "op" and t[1] == "(":
                depth += 1
            elif t[0] == "op" and t[1] == ")":
                depth -= 1
            elif depth == 0 and t[0] == "ident" and t[1].upper() == "FROM":
                return
            self.next()

    def parse_select_items(self):
        if self.take_op("*"):
            return [("*", None)]
        items = []
        while True:
            e = self.parse_expr()
            alias = None
            if self.take_kw("AS"):
                t = self.next()
                if t[0] not in _NAME_KINDS:
                    self.fail("expected an alias after AS")
                alias = t[1]
            elif self.peek()[0] in _NAME_KINDS and not self.at_kw(
                    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT"):
                alias = self.next()[1]
            items.append((alias, e))
            if not self.take_op(","):
                return items

    def parse_group_keys(self) -> List[str]:
        keys = []
        while True:
            e = self.parse_expr()
            keys.append(e)
            if not self.take_op(","):
                return keys

    def parse_order_keys(self):
        """ORDER BY entries: (column_name, asc) for plain references, or
        (Expr, asc) for expression keys (``ORDER BY sum(x) DESC`` — the
        TPC-DS corpus orders by unaliased aggregates); _lower resolves
        expression keys against the select outputs structurally."""
        keys = []
        while True:
            e = self.parse_expr()
            asc = True
            if self.take_kw("DESC"):
                asc = False
            else:
                self.take_kw("ASC")
            keys.append((e.name if isinstance(e, Col) else e, asc))
            if not self.take_op(","):
                return keys

    # -- FROM / JOIN -----------------------------------------------------
    def parse_from(self):
        """One FROM clause.  Comma-separated sources (the TPC-DS corpus
        idiom, ``FROM store_sales, date_dim, item WHERE ...``) return a
        _CommaJoin placeholder: the join tree is assembled AFTER the
        WHERE clause parses, from its equi-join conjuncts — explicit
        JOIN ... ON binds tighter than the comma, per SQL."""
        items = [self._parse_from_item()]
        while self.take_op(","):
            items.append(self._parse_from_item())
        if len(items) == 1:
            return items[0]
        return _CommaJoin(items)

    def _parse_from_item(self):
        ds = self.parse_source()
        while True:
            how = self.parse_join_type()
            if how is None:
                return ds
            right = self.parse_source()
            self.expect_kw("ON")
            # Join conditions resolve each side independently (the
            # engine's equi-join pairs), so same-named keys on both
            # sides are fine there — skip the ambiguity check.
            self._in_join_on = True
            try:
                cond = self.parse_expr()
            finally:
                self._in_join_on = False
            ds = ds.join(right, cond, how=how)

    def parse_join_type(self) -> Optional[str]:
        if self.take_kw("JOIN"):
            return "inner"
        if self.take_kw("INNER"):
            self.expect_kw("JOIN")
            return "inner"
        for kw, how in (("LEFT", "left"), ("RIGHT", "right"),
                        ("FULL", "full"), ("SEMI", "semi"),
                        ("ANTI", "anti")):
            if self.at_kw(kw):
                self.next()
                if kw == "LEFT" and self.at_kw("SEMI", "ANTI"):
                    how = "semi" if self.take_kw("SEMI") else "anti"
                else:
                    self.take_kw("OUTER")
                self.expect_kw("JOIN")
                return how
        return None

    def parse_source(self):
        if self.take_op("("):
            sub = self.fork()
            sub.outer_aliases = self.outer_aliases
            ds = sub.parse_select()
            self.i = sub.i
            self.expect_op(")")
            names = set()
            if self.peek()[0] in _NAME_KINDS \
                    and not self._at_clause_kw():
                alias = self.next()[1]
                self.aliases.append(alias)
                names.add(alias)
            self._register_source(names, ds)
            return ds
        t = self.next()
        if t[0] not in _NAME_KINDS:
            self.fail("expected a table name")
        name = t[1]
        src = self.tables.get(name)
        if src is None:
            raise SqlError(
                f"Unknown table {name!r}; pass it in sql(..., tables="
                f"{{{name!r}: dataset_or_parquet_path}})")
        ds = self.session.read.parquet(src) if isinstance(src, str) else src
        alias = None
        if self.peek()[0] in _NAME_KINDS \
                and not self._at_clause_kw():
            alias = self.next()[1]
        seen_before = any(name in ns for ns, _c in self.sources)
        if alias is None and seen_before:
            # Without an alias there is nothing to address the second
            # instance by: every qualified reference would bind to
            # whichever registration happened to come first.  Error
            # crisply instead of answering from an ambiguous plan.
            raise SqlError(
                f"Table {name!r} appears more than once in FROM and "
                f"the later occurrence needs an alias (e.g. "
                f"{name} a JOIN {name} b ON ...) so qualified "
                f"references are unambiguous")
        if alias is not None and seen_before:
            # Self-join lift: a LATER occurrence of an already-seen
            # table becomes an independent scan instance with its
            # columns renamed to ``<alias>__<column>`` — every column
            # then has exactly one owning source, so the comma-join
            # assembly's owner() resolution (and qualified-reference
            # validation) work unchanged.  Only the alias addresses the
            # instance; unaliased select items keep the lifted engine
            # name (``m.name`` -> output column ``m__name``) — use AS
            # for SQL-style output names.
            try:
                cols = list(ds.columns)
            except Exception:
                self.fail(f"self-joined table {name!r} needs a "
                          f"resolvable schema")
            ds = ds.select(**{f"{alias}__{c}": Col(c) for c in cols})
            self.qual_rename[alias] = f"{alias}__"
            self.aliases.append(alias)
            self._register_source({alias}, ds)
            return ds
        names = {name}
        self.aliases.append(name)
        if alias is not None:
            self.aliases.append(alias)
            names.add(alias)
        self._register_source(names, ds)
        return ds

    def fork(self) -> "_Parser":
        """A fresh per-select scope sharing this parser's token stream
        (no re-tokenization) and position."""
        child = _Parser.__new__(_Parser)
        child.text = self.text
        child.tokens = self.tokens
        child.i = self.i
        child.session = self.session
        child.tables = self.tables
        child.outer_aliases = ()
        child.outer_columns = frozenset()
        child.aliases = []
        child.sources = []
        child.qual_rename = {}
        child._in_join_on = False
        return child

    def _register_source(self, names: set, ds) -> None:
        try:
            cols = list(ds.columns)
        except Exception:
            cols = None  # unresolvable schema: skip validation
        self.sources.append((names, cols))

    def _at_clause_kw(self) -> bool:
        return self.at_kw("WHERE", "GROUP", "HAVING", "ORDER", "LIMIT",
                          "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "SEMI",
                          "ANTI", "ON", "AS", "UNION", "INTERSECT",
                          "EXCEPT", "MINUS")

    # -- expressions (precedence climbing) -------------------------------
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.take_kw("OR"):
            e = Or(e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.take_kw("AND"):
            e = And(e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.take_kw("NOT"):
            return Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        e = self.parse_additive()
        if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.next()[1]
            rhs = self.parse_additive()
            if op == "=":
                return BinOp("==", e, rhs)
            if op in ("<>", "!="):
                return Not(BinOp("==", e, rhs))
            return BinOp(op, e, rhs)
        if self.at_kw("BETWEEN"):
            self.next()
            lo = self.parse_additive()
            self.expect_kw("AND")
            hi = self.parse_additive()
            return And(BinOp(">=", e, lo), BinOp("<=", e, hi))
        negated = False
        if self.at_kw("NOT") and self.peek(1)[0] == "ident" \
                and self.peek(1)[1].upper() in ("IN", "LIKE"):
            self.next()
            negated = True
        if self.take_kw("IN"):
            self.expect_op("(")
            if self.at_kw("SELECT"):
                sub = self._parse_subquery()
                out: Expr = InSubquery(e, sub.plan)
            else:
                values = [self._literal_value(self.parse_additive())]
                while self.take_op(","):
                    values.append(self._literal_value(self.parse_additive()))
                out = IsIn(e, values)
            if not isinstance(out, InSubquery):
                self.expect_op(")")
            return Not(out) if negated else out
        if self.take_kw("LIKE"):
            t = self.next()
            if t[0] != "str":
                self.fail("LIKE needs a string pattern")
            out = StringMatch("like", e, t[1])
            return Not(out) if negated else out
        if self.take_kw("IS"):
            neg = self.take_kw("NOT")
            self.expect_kw("NULL")
            out = IsNull(e)
            return Not(out) if neg else out
        return e

    def _literal_value(self, e: Expr):
        if isinstance(e, Neg) and isinstance(e.child, Lit) \
                and isinstance(e.child.value, (int, float)):
            return -e.child.value
        if not isinstance(e, Lit):
            self.fail("IN lists take literals (use an IN subquery for "
                      "computed sets)")
        return e.value

    def parse_additive(self) -> Expr:
        e = self.parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next()[1]
            if self.at_kw("INTERVAL"):
                # Constant date arithmetic — TPC-DS's
                # ``cast('1999-02-22' AS DATE) + INTERVAL 30 days``
                # (q12/q20/q37/q82/q98): folds to a date literal at
                # parse time.  Non-constant date expressions would need
                # runtime interval arithmetic — rejected loudly.
                days = self._parse_interval_days()
                base = _fold_const_date(e)
                if base is None:
                    self.fail("INTERVAL arithmetic needs a constant "
                              "date left-hand side (a DATE literal or "
                              "cast('...' AS DATE))")
                delta = datetime.timedelta(days=days)
                e = Lit(base + delta if op == "+" else base - delta)
                continue
            e = (e + self.parse_multiplicative()) if op == "+" \
                else (e - self.parse_multiplicative())
        return e

    def _parse_interval_days(self) -> int:
        self.expect_kw("INTERVAL")
        t = self.next()
        if t[0] != "num" or "." in str(t[1]):
            self.fail("INTERVAL needs an integer count")
        unit = self.next()
        if unit[0] != "ident" or unit[1].upper() not in ("DAY", "DAYS"):
            self.fail("Only INTERVAL <n> DAYS is supported")
        return int(t[1])

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while self.at_op("*", "/"):
            op = self.next()[1]
            e = (e * self.parse_unary()) if op == "*" \
                else (e / self.parse_unary())
        return e

    def parse_unary(self) -> Expr:
        if self.take_op("-"):
            return Neg(self.parse_unary())
        if self.take_op("+"):
            return self.parse_unary()
        return self.parse_primary()

    def _parse_subquery(self):
        own_cols = set()
        for _names, cols in self.sources:
            own_cols |= set(cols or ())
        # fork() shares the token stream — no re-lex of the whole text
        # per subquery — then the correlation scope attaches.
        sub = self.fork()
        sub.outer_aliases = tuple(self.aliases) + self.outer_aliases
        sub.outer_columns = frozenset(own_cols) | self.outer_columns
        ds = sub.parse_select()
        self.i = sub.i
        self.expect_op(")")
        return ds

    def parse_primary(self) -> Expr:
        t = self.peek()
        if self.take_op("("):
            if self.at_kw("SELECT"):
                return ScalarSubquery(self._parse_subquery().plan)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t[0] == "num":
            self.next()
            text = t[1]
            return Lit(float(text) if any(c in text for c in ".eE")
                       else int(text))
        if t[0] == "str":
            self.next()
            return Lit(t[1])
        if t[0] == "qident":
            self.next()
            return Col(t[1])
        if t[0] != "ident":
            self.fail("expected an expression")
        word = t[1]
        upper = word.upper()
        if upper == "DATE":
            self.next()
            s = self.next()
            if s[0] != "str":
                self.fail("DATE needs a 'yyyy-mm-dd' string")
            try:
                return Lit(datetime.date.fromisoformat(s[1]))
            except ValueError as e:
                raise SqlError(f"Bad DATE literal {s[1]!r}: {e}") from e
        if upper in ("TRUE", "FALSE"):
            self.next()
            return Lit(upper == "TRUE")
        if upper == "NULL":
            self.next()
            return Lit(None)
        if upper == "CASE":
            return self.parse_case()
        if upper == "CAST":
            self.next()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("AS")
            type_name = self.next()[1]
            self.expect_op(")")
            return Cast(e, type_name)
        if upper == "EXTRACT":
            self.next()
            self.expect_op("(")
            field = self.next()[1].lower()
            if field not in _EXTRACT_FUNCS:
                self.fail(f"EXTRACT field must be one of "
                          f"{sorted(_EXTRACT_FUNCS)}")
            self.expect_kw("FROM")
            e = self.parse_expr()
            self.expect_op(")")
            return Extract(_EXTRACT_FUNCS[field], e)
        if upper == "EXISTS":
            self.next()
            self.expect_op("(")
            if not self.at_kw("SELECT"):
                self.fail("EXISTS needs a (SELECT ...) subquery")
            return Exists(self._parse_subquery().plan)
        if self.peek(1)[0] == "op" and self.peek(1)[1] == "(":
            return self.parse_call()
        # [alias.]column
        self.next()
        if self.take_op("."):
            c = self.next()
            if c[0] not in _NAME_KINDS:
                self.fail("expected a column after '.'")
            if word in self.aliases:
                return self._qualified_col(word, c[1])
            if word in self.outer_aliases:
                return OuterRef(c[1])
            raise SqlError(
                f"Unknown table alias {word!r} (in scope: "
                f"{self.aliases + list(self.outer_aliases)})")
        if self.outer_columns and word in self.outer_columns \
                and not any(cols is None or word in cols
                            for _n, cols in self.sources):
            # Unknown in every LOCAL source (all of which have resolved
            # schemas) but known in the enclosing scope: SQL's implicit
            # correlated reference.  Innermost scope always wins when a
            # local source could plausibly own the name.
            return OuterRef(word)
        return Col(word)

    def _qualified_col(self, alias: str, column: str) -> Expr:
        """``alias.column`` with BINDING validation: the engine's Col has
        no qualifier, and a joined table exposes the FIRST (leftmost)
        source's copy under an ambiguous name — so a reference that
        would silently bind to a different table must error instead.
        A self-join-lifted alias translates to its renamed column."""
        prefix = self.qual_rename.get(alias, "")
        column = prefix + column
        target = next((cols for names, cols in self.sources
                       if alias in names), None)
        if target is not None:
            if column not in target:
                shown = [c[len(prefix):] if prefix else c for c in target]
                raise SqlError(
                    f"Column {column[len(prefix):]!r} does not exist in "
                    f"table {alias!r} (columns: {shown})")
            first = next((names for names, cols in self.sources
                          if cols is not None and column in cols), None)
            if not self._in_join_on and first is not None \
                    and alias not in first:
                raise SqlError(
                    f"Ambiguous column {alias}.{column}: another table "
                    f"earlier in FROM also has {column!r}, and the "
                    f"joined output exposes that copy under this name — "
                    f"rename one side via a derived table "
                    f"(SELECT {column} AS ... FROM ...)")
        return Col(column)

    def parse_case(self) -> Expr:
        """Both CASE forms.  The simple form (``CASE expr WHEN v THEN r
        ...``) desugars to the searched form with ``expr = v``
        conditions, exactly as Spark's parser does — so a NULL operand
        matches no WHEN (NULL = v is NULL, never true) and falls
        through to ELSE."""
        self.expect_kw("CASE")
        operand: Optional[Expr] = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.take_kw("WHEN"):
            cond = self.parse_expr()
            if operand is not None:
                cond = BinOp("==", operand, cond)
            self.expect_kw("THEN")
            branches.append((cond, self.parse_expr()))
        otherwise: Expr = Lit(None)
        if self.take_kw("ELSE"):
            otherwise = self.parse_expr()
        self.expect_kw("END")
        if not branches:
            self.fail("CASE needs at least one WHEN")
        return Case(branches, otherwise)

    def parse_call(self) -> Expr:
        name = self.next()[1].lower()
        self.expect_op("(")
        distinct = False
        star = False
        arg: Optional[Expr] = None
        args: List[Expr] = []
        if self.take_op("*"):
            star = True
        elif not self.at_op(")"):
            if self.take_kw("DISTINCT"):
                distinct = True
            arg = self.parse_expr()
            args.append(arg)
            while self.take_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        if name in ("substr", "substring"):
            if distinct or star:
                self.fail("substring() takes plain expression arguments")
            if len(args) not in (2, 3):
                self.fail("substring(expr, start[, length])")
            folded = [args[0]]
            for a in args[1:]:
                if isinstance(a, Neg) and isinstance(a.child, Lit):
                    a = Lit(-a.child.value)  # unary minus parses as Neg
                if not (isinstance(a, Lit) and isinstance(a.value, int)
                        and not isinstance(a.value, bool)):
                    self.fail("substring start/length must be integer "
                              "literals")
                folded.append(a)
            try:
                return StringFn("substring", folded)
            except ValueError as e:
                self.fail(str(e))
        if name in ("upper", "lower", "length", "trim", "ltrim", "rtrim"):
            if distinct or star or len(args) != 1:
                self.fail(f"{name}() takes one argument")
            return StringFn(name, args)
        if name == "concat":
            if distinct or star or len(args) < 2:
                self.fail("concat() needs at least two plain arguments")
            return StringFn("concat", args)
        if name in ("coalesce", "ifnull", "nvl", "nullif") \
                and (distinct or star):
            self.fail(f"{name}() takes plain expression arguments")
        if name in ("coalesce", "ifnull", "nvl"):
            if len(args) < 2:
                self.fail(f"{name}() needs at least two arguments")
            # COALESCE(a, b, c) -> CASE WHEN a IS NOT NULL THEN a
            #                           WHEN b IS NOT NULL THEN b ELSE c
            branches = [(Not(IsNull(a)), a) for a in args[:-1]]
            return Case(branches, args[-1])
        if name == "nullif":
            if len(args) != 2:
                self.fail("nullif() takes exactly two arguments")
            return Case([(BinOp("==", args[0], args[1]), Lit(None))],
                        args[0])
        if len(args) > 1 and name not in ("lag", "lead"):
            self.fail(f"{name}() takes one argument")
        # OVER -> window call
        if self.at_kw("OVER"):
            self.next()
            self.expect_op("(")
            partition: List[str] = []
            order: List[Tuple[str, bool]] = []
            if self.take_kw("PARTITION"):
                self.expect_kw("BY")
                while True:
                    c = self.parse_primary()
                    if not isinstance(c, Col):
                        self.fail("PARTITION BY keys must be columns")
                    partition.append(c.name)
                    if not self.take_op(","):
                        break
            if self.take_kw("ORDER"):
                self.expect_kw("BY")
                while True:
                    c = self.parse_primary()
                    if not isinstance(c, Col):
                        self.fail("window ORDER BY keys must be columns")
                    asc = True
                    if self.take_kw("DESC"):
                        asc = False
                    else:
                        self.take_kw("ASC")
                    order.append((c.name, asc))
                    if not self.take_op(","):
                        break
            frame = self.parse_frame_clause()
            self.expect_op(")")
            if name not in _WINDOW_FUNCS:
                self.fail(f"Unsupported window function {name}")
            if distinct:
                self.fail("DISTINCT is not supported in window functions")
            func = {"avg": "mean"}.get(name, name)
            value = None
            offset = 1
            if func in ("sum", "min", "max", "mean", "count", "lag",
                        "lead", "first_value", "last_value") \
                    and arg is not None:
                if isinstance(arg, Col):
                    value = arg.name
                elif isinstance(arg, _AggCall) and func in (
                        "sum", "min", "max", "mean", "count",
                        "first_value", "last_value"):
                    # Window over an aggregate output — TPC-DS's
                    # ``sum(sum(x)) OVER (...)`` idiom (q51/q12/q20):
                    # the inner aggregate materializes as a hidden
                    # GROUP BY output and the window runs over it.
                    value = arg
                else:
                    self.fail("window function arguments must be "
                              "columns (or aggregates in a GROUP BY "
                              "query)")
            if func in ("lag", "lead"):
                if len(args) > 2:
                    self.fail(f"{func}(value[, offset]) takes at most "
                              f"two arguments")
                if len(args) == 2:
                    off = args[1]
                    if not isinstance(off, Lit) \
                            or not isinstance(off.value, int):
                        self.fail(f"{func}() offset must be an integer "
                                  f"literal")
                    offset = off.value
            if func == "ntile":
                if not args or not isinstance(args[0], Lit) \
                        or not isinstance(args[0].value, int):
                    self.fail("ntile(n) needs an integer literal "
                              "tile count")
                offset = args[0].value
                value = None
            return _WindowCall(func, value, partition, order, offset,
                               frame=frame)
        if name in _AGG_FUNCS:
            func = _AGG_FUNCS[name]
            if name == "count":
                if star:
                    return _AggCall("count_all", None)
                if distinct:
                    return _AggCall("count_distinct", arg)
                return _AggCall("count", arg)
            if distinct:
                self.fail(f"DISTINCT is only supported inside count()")
            if arg is None:
                self.fail(f"{name}() needs an argument")
            return _AggCall(func, arg)
        if name in _EXTRACT_FUNCS:
            if arg is None:
                self.fail(f"{name}() needs an argument")
            return Extract(_EXTRACT_FUNCS[name], arg)
        self.fail(f"Unknown function {name}")


# ---- lowering ----------------------------------------------------------

def _map(e: Expr, fn) -> Expr:
    return _map_expr(e, fn)


def _contains_agg(e: Expr) -> bool:
    return _contains(e, _AggCall)


def _contains_window(e: Expr) -> bool:
    return _contains(e, _WindowCall)


def _lower(p: _Parser, ds, items, distinct, where, group_by, having,
           order_by, limit):
    if where is not None:
        _reject_markers(where, "WHERE")
        ds = ds.filter(where)

    star = len(items) == 1 and items[0][0] == "*" and items[0][1] is None
    has_agg = any(_contains_agg(e) for _a, e in items
                  if e is not None and not isinstance(e, _WindowCall))
    aggregate_query = bool(group_by) or has_agg

    # Output in SELECT-LIST ORDER: (name, None) for a plain column of the
    # current dataset, (name, expr) for a computed output.
    out_items: List[Tuple[str, Optional[Expr]]] = []
    windows_to_apply: List[Tuple[str, _WindowCall]] = []
    # ORDER BY may reference select items by EXPRESSION (TPC-DS's
    # ``ORDER BY sum(x) DESC``): map each original item's structure to
    # its output name for structural resolution below.
    repr_to_name: Dict[str, str] = {}

    if aggregate_query:
        if star:
            raise SqlError("SELECT * cannot be combined with GROUP "
                           "BY/aggregates; list the outputs")
        # Group keys: plain columns, or references to computed select
        # aliases (SELECT year(d) AS y ... GROUP BY y) which materialize
        # as with_column first.
        alias_exprs = {a: e for a, e in items
                       if a is not None and e is not None
                       and not _contains_window(e)
                       and not _contains_agg(e)}
        keys: List[str] = []
        for k in group_by:
            if isinstance(k, Col):
                if k.name in alias_exprs and not (
                        isinstance(alias_exprs[k.name], Col)
                        and alias_exprs[k.name].name == k.name):
                    # Renaming aliases (x AS g) materialize too — the
                    # group key must exist under the alias name.
                    ds = ds.with_column(k.name, alias_exprs[k.name])
                keys.append(k.name)
            else:
                raise SqlError(
                    f"GROUP BY keys must be column names or select "
                    f"aliases, got {k!r}")
        agg_specs: Dict[str, tuple] = {}
        hidden = [0]

        def agg_name(call: _AggCall, alias: Optional[str]) -> str:
            if alias is not None:
                name = alias
            else:
                name = f"__agg{hidden[0]}"
                hidden[0] += 1
            inp = "" if call.func == "count_all" else (
                call.child.name if isinstance(call.child, Col) else call.child)
            agg_specs[name] = (inp, call.func)
            return name

        def bind_window(w: _WindowCall) -> _WindowCall:
            """A window in an aggregate query runs over the GROUPED
            rows; an aggregate VALUE (sum(sum(x)) OVER ...) becomes a
            hidden aggregate output the window then reads."""
            if isinstance(w.value, _AggCall):
                hidden_name = agg_name(w.value, None)
                return _WindowCall(w.func, hidden_name, w.partition_by,
                                   w.order_by, w.offset, frame=w.frame)
            return w

        for alias, e in items:
            if e is None:
                continue
            if isinstance(e, _WindowCall):
                if alias is None:
                    raise SqlError("Window select items need AS aliases")
                windows_to_apply.append((alias, bind_window(e)))
                out_items.append((alias, None))
                repr_to_name[repr(e)] = alias
                continue
            if isinstance(e, _AggCall):
                name = agg_name(e, alias)
                out_items.append((name, None))
                repr_to_name[repr(e)] = name
                continue
            if _contains_window(e):
                # Window nested in an expression (TPC-DS q12's
                # ``agg*100/sum(sum(x)) over (...)`` ratio): each window
                # materializes as a hidden analytic column; the final
                # Compute (which runs after the windows apply) reads it.
                if alias is None:
                    raise SqlError(
                        f"Computed window select items need AS "
                        f"aliases: {e!r}")

                def repl(x):
                    if isinstance(x, _WindowCall):
                        hidden_w = f"__win{len(windows_to_apply)}"
                        windows_to_apply.append((hidden_w,
                                                 bind_window(x)))
                        return Col(hidden_w)
                    if isinstance(x, _AggCall):
                        return Col(agg_name(x, None))
                    return x

                out_items.append((alias, _map(e, repl)))
                repr_to_name[repr(e)] = alias
                continue
            if _contains_agg(e):
                # Unaliased computed aggregates auto-name positionally
                # (scalar subqueries read the single output by position:
                # TPC-DS q1's ``SELECT avg(x) * 1.2``).
                alias = alias or f"_c{len(out_items)}"
                new_e = _map(e, lambda x: Col(agg_name(x, None))
                             if isinstance(x, _AggCall) else x)
                _reject_markers(new_e, "SELECT expressions",
                                (_WindowCall,))
                out_items.append((alias, new_e))
                repr_to_name[repr(e)] = alias
                continue
            # Non-aggregate item: must be a group key (or its alias) —
            # possibly RENAMED in the output (``sr_customer_sk AS
            # ctr_customer_sk ... GROUP BY sr_customer_sk``, TPC-DS q1).
            if isinstance(e, Col) and e.name in keys:
                name = alias or e.name
                out_items.append(
                    (name, None if name == e.name else e))
                repr_to_name[repr(e)] = name
                continue
            name = alias or (e.name if isinstance(e, Col) else None)
            if name is None or name not in keys:
                raise SqlError(
                    f"Select item {e!r} is neither aggregated nor a "
                    f"GROUP BY key")
            out_items.append((name, None))
            repr_to_name[repr(e)] = name
        if not keys:
            ds = ds.agg(**agg_specs)
        else:
            ds = ds.group_by(*keys).agg(**agg_specs)
        if having is not None:
            _reject_markers(having, "HAVING", (_WindowCall,))

            def map_having(x):
                if isinstance(x, _AggCall):
                    # Match an existing SELECT output structurally; a
                    # HAVING-only aggregate is deliberately rejected (it
                    # would need a hidden output threaded through the
                    # final projection) — alias the aggregate in SELECT.
                    for name, (inp, func) in agg_specs.items():
                        want = "" if x.func == "count_all" else (
                            x.child.name if isinstance(x.child, Col)
                            else x.child)
                        if func == x.func and repr(inp) == repr(want):
                            return Col(name)
                    raise SqlError(
                        f"HAVING aggregate {x!r} must also appear in the "
                        f"SELECT list")
                return x

            ds = ds.filter(_map(having, map_having))
    else:
        if having is not None:
            raise SqlError("HAVING without GROUP BY/aggregates")
        if not star:
            for alias, e in items:
                if e is None:
                    continue
                if isinstance(e, _WindowCall):
                    if alias is None:
                        raise SqlError(
                            "Window select items need AS aliases")
                    if isinstance(e.value, _AggCall):
                        raise SqlError(
                            "Window over an aggregate needs a GROUP BY")
                    windows_to_apply.append((alias, e))
                    out_items.append((alias, None))
                elif isinstance(e, Col) and alias is None:
                    out_items.append((e.name, None))
                elif _contains_window(e):
                    if alias is None:
                        raise SqlError(
                            f"Computed window select items need AS "
                            f"aliases: {e!r}")

                    def repl(x):
                        if isinstance(x, _WindowCall):
                            if isinstance(x.value, _AggCall):
                                raise SqlError("Window over an "
                                               "aggregate needs a "
                                               "GROUP BY")
                            hidden_w = f"__win{len(windows_to_apply)}"
                            windows_to_apply.append((hidden_w, x))
                            return Col(hidden_w)
                        return x

                    out_items.append((alias, _map(e, repl)))
                else:
                    _reject_markers(e, "SELECT expressions",
                                    (_WindowCall,))
                    # Unaliased computed items auto-name (Spark names
                    # them after the expression text; `_c<i>` is stabler).
                    out_items.append((alias or f"_c{len(out_items)}", e))

    for alias, w in windows_to_apply:
        ds = ds.with_window(alias, w.func, partition_by=w.partition_by,
                            order_by=w.order_by, value=w.value,
                            offset=w.offset, frame=w.frame)

    # Resolve ORDER BY before the output projection: keys may be select
    # outputs, expressions matching select items (TPC-DS's ``ORDER BY
    # sum(x) DESC``), or columns available pre-projection but not
    # selected (q12 orders by the group key i_item_id without selecting
    # it) — those thread through as HIDDEN outputs and drop after the
    # sort.
    sort_keys: List[Tuple[str, bool]] = []
    hidden_sort_cols: List[str] = []
    if order_by:
        out_names = {n for n, _e in out_items}
        for k, asc in order_by:
            if isinstance(k, str):
                name = k
            else:
                name = repr_to_name.get(repr(k))
                if name is None:
                    raise SqlError(
                        f"ORDER BY expression {k!r} must match a select "
                        f"output; alias it in SELECT and order by the "
                        f"alias")
            if not star and out_items and name not in out_names:
                try:
                    available = name in ds.columns
                except Exception:
                    available = False
                if not available:
                    raise SqlError(
                        f"ORDER BY key {name!r} is neither a select "
                        f"output nor an available column")
                if distinct:
                    raise SqlError(
                        f"ORDER BY {name!r} with DISTINCT must be a "
                        f"select output")
                out_items.append((name, None))
                out_names.add(name)
                hidden_sort_cols.append(name)
            sort_keys.append((name, asc))

    if not star and out_items:
        names = [n for n, _e in out_items]
        if len(set(names)) != len(names):
            raise SqlError(f"Duplicate select output names: {names}")
        if all(e is None for _n, e in out_items):
            # Skip a no-op projection (SELECT exactly the current
            # output, in order): keeps plans identical to DSL forms
            # that never wrote a select — and leaves subquery plans as
            # bare Aggregates, the shape the correlated-scalar rewrite
            # requires.
            try:
                noop = ds.columns == names
            except Exception:
                noop = False
            if not noop:
                ds = ds.select(*names)
        else:
            # Computed outputs interleave with plain ones: build the
            # Compute in SELECT-LIST order (Dataset.select's
            # names-then-keywords signature would reorder them).
            exprs = [(n, Col(n) if e is None else e) for n, e in out_items]
            ds = Dataset(Compute(exprs, ds.plan), ds.session)
    if distinct:
        ds = ds.distinct()
    if sort_keys:
        ds = ds.sort(*sort_keys)
        if hidden_sort_cols:
            keep = [n for n, _e in out_items
                    if n not in hidden_sort_cols]
            ds = ds.select(*keep)
    if limit is not None:
        ds = ds.limit(limit)
    return ds


def _reject_markers(e: Expr, where: str, kinds=None) -> None:
    kinds = kinds or (_AggCall, _WindowCall)

    def check(x):
        if isinstance(x, kinds):
            raise SqlError(f"Aggregate/window calls are not allowed in "
                           f"{where} (window calls must be top-level "
                           f"select items)")
    _walk_exprs(e, check)


def _fold_const_date(e: Expr):
    """datetime.date value of a constant date expression (DATE literal
    or cast of a string literal to date), else None."""
    if isinstance(e, Lit) and isinstance(e.value, datetime.date):
        return e.value
    if isinstance(e, Cast) and str(e.type_name).lower() in ("date",
                                                            "date32") \
            and isinstance(e.child, Lit) and isinstance(e.child.value,
                                                        str):
        try:
            return datetime.date.fromisoformat(e.child.value)
        except ValueError:
            return None
    return None


class _CommaJoin:
    """Placeholder for comma-separated FROM sources; resolved against
    the WHERE conjuncts by _assemble_comma_join."""

    def __init__(self, items) -> None:
        self.items = items


def _split_conjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, And):
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _assemble_comma_join(p: "_Parser", items, where):
    """Build the inner-join tree for ``FROM a, b, c WHERE ...`` from the
    WHERE clause's column-equality conjuncts (classic implicit-join SQL,
    the TPC-DS corpus style): each step joins one not-yet-connected
    source through an equi predicate; everything else stays a filter
    above the joins.  Pure cross joins are rejected — the engine
    executes equi-joins."""
    if where is None:
        p.fail("comma-separated FROM needs WHERE equi-join predicates "
               "(cross joins are not supported)")
    cols_of = []
    for it in items:
        try:
            cols_of.append(set(it.columns))
        except Exception:
            p.fail("comma-joined sources need resolvable schemas")

    def owner(name: str):
        hits = [i for i, cs in enumerate(cols_of) if name in cs]
        return hits[0] if len(hits) == 1 else None

    conjuncts = _split_conjuncts(where)
    used: set = set()
    joined = {0}
    ds = items[0]
    while len(joined) < len(items):
        progressed = False
        for ci, c in enumerate(conjuncts):
            if ci in used:
                continue
            if not (isinstance(c, BinOp) and c.op == "=="
                    and isinstance(c.left, Col)
                    and isinstance(c.right, Col)):
                continue
            oa, ob = owner(c.left.name), owner(c.right.name)
            if oa is None or ob is None:
                continue
            if (oa in joined) == (ob in joined):
                continue
            new = ob if oa in joined else oa
            ds = ds.join(items[new], c, how="inner")
            joined.add(new)
            used.add(ci)
            progressed = True
            break
        if not progressed:
            # Distinguish the REAL limitation: an UNALIASED duplicate of
            # a table leaves every shared column ambiguous to owner(),
            # so no equi conjunct can ever connect them.  (An ALIASED
            # duplicate is lifted into an independent renamed instance
            # by parse_source and never reaches this branch.)
            pending = [i for i in range(len(items)) if i not in joined]
            if any(cols_of[i] == cols_of[j]
                   for i in pending for j in range(len(items)) if i != j):
                p.fail(
                    "comma-style self-join needs an alias on each "
                    "occurrence (FROM emp e, emp m): identical column "
                    "sets make the join columns ambiguous")
            p.fail(
                "comma-separated FROM requires WHERE equi-join "
                "predicates connecting every table (cross joins are "
                "not supported)")
    remaining = None
    for ci, c in enumerate(conjuncts):
        if ci in used:
            continue
        remaining = c if remaining is None else And(remaining, c)
    return ds, remaining


def _align_positional(op_name: str, ds, nxt):
    """Spark SQL resolves set operations BY POSITION: the second
    branch's columns are renamed to the first branch's names pairwise,
    regardless of their own names."""
    prev_cols, next_cols = None, None
    try:
        prev_cols, next_cols = ds.columns, nxt.columns
    except Exception:
        return nxt  # unresolvable schema: let execution surface it
    if len(prev_cols) != len(next_cols):
        raise SqlError(
            f"{op_name} branches must produce the same number of "
            f"columns: {prev_cols} vs {next_cols}")
    if len(set(prev_cols)) != len(prev_cols):
        raise SqlError(
            f"{op_name} over duplicate column names is not "
            f"supported: {prev_cols}; alias them apart")
    if list(prev_cols) != list(next_cols):
        nxt = nxt.select(**{pn: Col(nc) for pn, nc
                            in zip(prev_cols, next_cols)})
    return nxt


def _parse_intersect_chain(p: "_Parser", allow_tail: bool):
    """select (INTERSECT select)* — INTERSECT binds tighter than
    UNION/EXCEPT, per the SQL grammar."""
    ds = p.parse_select(allow_tail=allow_tail)
    while p.take_kw("INTERSECT"):
        if p.take_kw("ALL"):
            p.fail("INTERSECT ALL is not supported; use INTERSECT")
        p.take_kw("DISTINCT")
        branch = p.fork()
        nxt = branch.parse_select(allow_tail=False)
        p.i = branch.i
        ds = ds.intersect(_align_positional("INTERSECT", ds, nxt))
    return ds


def _parse_query(p: "_Parser"):
    """Full query expression: set-operation chain plus the trailing
    ORDER BY / LIMIT that binds the WHOLE chain (SQL)."""
    has_setop = _has_top_level_setop(p)
    ds = _parse_intersect_chain(p, allow_tail=not has_setop)
    while True:
        if p.take_kw("UNION"):
            # SQL set semantics: bare UNION dedups the accumulated
            # result; UNION ALL keeps bags.  Left-associative.
            dedup = True
            if p.take_kw("ALL"):
                dedup = False
            else:
                p.take_kw("DISTINCT")
            # Each branch is its own select scope (fresh sources /
            # aliases, like the INTERSECT fork): `FROM orders` in both
            # branches is two scans, not a duplicate registration.
            branch = p.fork()
            nxt = _parse_intersect_chain(branch, allow_tail=False)
            p.i = branch.i
            ds = ds.union(_align_positional("UNION", ds, nxt))
            if dedup:
                ds = ds.distinct()
        elif p.take_kw("EXCEPT") or p.take_kw("MINUS"):
            if p.take_kw("ALL"):
                p.fail("EXCEPT ALL is not supported; use EXCEPT")
            p.take_kw("DISTINCT")
            branch = p.fork()
            nxt = _parse_intersect_chain(branch, allow_tail=False)
            p.i = branch.i
            ds = ds.subtract(_align_positional("EXCEPT", ds, nxt))
        else:
            break
    if has_setop:
        if p.take_kw("ORDER"):
            p.expect_kw("BY")
            keys = p.parse_order_keys()
            if any(not isinstance(k, str) for k, _a in keys):
                p.fail("ORDER BY after a set operation must use output "
                       "column names")
            ds = ds.sort(*keys)
        if p.take_kw("LIMIT"):
            ds = ds.limit(p.parse_limit_count())
    return ds


def sql(session, text: str, tables: Dict[str, Any]):
    """Parse ``text`` and lower it to a Dataset against ``session``.

    ``tables`` maps SQL table names to Datasets or parquet directory
    paths (the FROM resolution — the engine has no catalog).  Supports
    WITH (common table expressions), UNION [ALL], INTERSECT, and
    EXCEPT/MINUS — the constructs the TPC-DS corpus leans on (q51's
    ``WITH ... AS`` shape, q14's INTERSECT)."""
    p = _Parser(text, session, dict(tables))
    if p.take_kw("WITH"):
        if p.take_kw("RECURSIVE"):
            p.fail("WITH RECURSIVE is not supported")
        while True:
            t = p.next()
            if t[0] not in _NAME_KINDS:
                p.fail("expected a CTE name after WITH")
            cte_name = t[1]
            p.expect_kw("AS")
            p.expect_op("(")
            # fork() shares the token stream — re-tokenizing the whole
            # SQL text per CTE (the old _Parser(p.text, ...) constructor
            # route) cost one full lex per CTE for nothing.  The body
            # needs its OWN tables snapshot: earlier CTEs are visible,
            # its registrations must not leak back.
            body = p.fork()
            body.tables = dict(p.tables)
            cte_ds = _parse_query(body)
            p.i = body.i
            p.expect_op(")")
            # Later CTEs and the main query see this one by name;
            # same-named external tables are shadowed (SQL scoping).
            p.tables[cte_name] = cte_ds
            if not p.take_op(","):
                break
    ds = _parse_query(p)
    while p.take_op(";"):  # .sql files commonly end with a semicolon
        pass
    t = p.peek()
    if t[0] != "eof":
        p.fail("unexpected trailing input")
    return ds


_SETOP_KWS = ("UNION", "INTERSECT", "EXCEPT", "MINUS")


def _has_top_level_setop(p: "_Parser") -> bool:
    """Any set operator at THIS query's nesting level — the scan stops
    where the enclosing parenthesis closes, so a parenthesized subquery
    context never sees its parent's operators."""
    depth = 0
    for kind, val, _pos in p.tokens[p.i:]:
        if kind == "op" and val == "(":
            depth += 1
        elif kind == "op" and val == ")":
            depth -= 1
            if depth < 0:
                return False
        elif depth == 0 and kind == "ident" and val.upper() in _SETOP_KWS:
            return True
    return False
