"""DataSkippingFilterRule: shrink a scan's file list using per-file
sketches (counterpart of hyperspace_tpu/rules/data_skipping.py).

Runs after the covering-index rules (a full rewrite beats file pruning).
Pattern: the same Filter-over-Scan shapes FilterIndexRule matches.  For each
top-level conjunct of the predicate that constrains exactly one sketched
column with ==/</<=/>/>=/IN, a file whose [min, max] interval cannot satisfy
the constraint is dropped from the scan's file list.  The scan still reads
the SOURCE data — only fewer files of it.

Staleness safety WITHOUT signatures: pruning only ever drops a file that is
(a) present in the sketch under the exact (name, size, mtime) it was
sketched with, and (b) provably non-matching.  Files the sketch has never
seen (appends) or whose stats changed (rewrites) always survive, so a stale
sketch can only prune less, never wrongly — the index stays useful through
source mutations with no hybrid-scan machinery.

``prune_index_files_by_sketch`` does the same for a covering index's own
files, by the ``_sketch.parquet`` each build version writes.  Host work:
pyarrow is imported when a function runs.  A pruned scan emits a
``HyperspaceIndexUsageEvent``, which records its index as used in the
active run report (telemetry/).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.actions.data_skipping import (
    INDEX_FILE_SKETCH,
    SKETCH_FILE_MTIME,
    SKETCH_FILE_NAME,
    SKETCH_FILE_SIZE,
    SKETCH_ROW_COUNT,
    _bloom_col,
    _max_col,
    _min_col,
    _null_col,
    _values_col,
    bloom_may_contain,
    bloom_positions,
    read_sketch,
)
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.plan.expr import (
    And,
    BinOp,
    Col,
    Expr,
    IsIn,
    IsNull,
    Lit,
    Not,
    Or,
)
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Scan
from hyperspace_tpu_torch.rules import rule_utils
from hyperspace_tpu_torch.rules.filter_rule import _extract_filter_nodes
from hyperspace_tpu_torch.telemetry.events import (
    HyperspaceIndexUsageEvent,
    emit_event,
)

# In-process memo of loaded sketches keyed by the sketch files' identity
# (name, size, mtime): correct across rebuilds AND across same-name indexes
# in different system paths — (name, log id) would collide there.
_SKETCH_CACHE: Dict[Tuple, List[dict]] = {}
_SKETCH_CACHE_MAX = 64


class _Constraint:
    """Closed-interval + optional value-set constraint on one column."""

    def __init__(self) -> None:
        self.lo = None          # value, inclusive unless lo_open
        self.lo_open = False
        self.hi = None
        self.hi_open = False
        self.values: Optional[set] = None  # IN / == value set
        # Explicit null-ness constraints (IS NULL / IS NOT NULL):
        # sketches store per-file null counts, so a file with no nulls
        # cannot satisfy IS NULL, and an all-null file cannot satisfy
        # IS NOT NULL.
        self.require_null = False
        self.require_non_null = False

    def add_cmp(self, op: str, value) -> None:
        if op == "==":
            self.values = {value} if self.values is None \
                else self.values & {value}
        elif op in (">", ">="):
            if self.lo is None or value > self.lo or \
                    (value == self.lo and op == ">"):
                self.lo, self.lo_open = value, op == ">"
        elif op in ("<", "<="):
            if self.hi is None or value < self.hi or \
                    (value == self.hi and op == "<"):
                self.hi, self.hi_open = value, op == "<"

    def add_values(self, values) -> None:
        vs = set(values)
        self.values = vs if self.values is None else self.values & vs

    def file_may_match(self, fmin, fmax) -> bool:
        """Could a file with non-null range [fmin, fmax] hold a matching
        row?  ``None`` min/max means the file has no non-null values — no
        predicate matches null, so it cannot."""
        if fmin is None or fmax is None:
            return False
        try:
            if self.values is not None:
                if not any(fmin <= v <= fmax for v in self.values):
                    return False
            if self.lo is not None:
                if fmax < self.lo or (self.lo_open and fmax == self.lo):
                    return False
            if self.hi is not None:
                if fmin > self.hi or (self.hi_open and fmin == self.hi):
                    return False
        except TypeError:
            return True  # incomparable literal/stat types: never mis-prune
        return True


_MIRROR = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}


def _copy(c: _Constraint) -> _Constraint:
    out = _Constraint()
    out.lo, out.lo_open = c.lo, c.lo_open
    out.hi, out.hi_open = c.hi, c.hi_open
    out.values = None if c.values is None else set(c.values)
    out.require_null = c.require_null
    out.require_non_null = c.require_non_null
    return out


def _is_false(c: _Constraint) -> bool:
    """An unsatisfiable constraint: empty value set, or IS NULL combined
    with anything only non-null rows can satisfy."""
    if c.values is not None and len(c.values) == 0:
        return True
    return c.require_null and (c.require_non_null
                               or c.values is not None
                               or c.lo is not None or c.hi is not None)


def _union(a: _Constraint, b: _Constraint) -> Optional[_Constraint]:
    """Sound OR of two single-column constraints: pure value sets union
    exactly; anything involving ranges widens to the covering interval
    (values collapse to [min, max]); unbounded sides make the union
    unconstrained (None).  An unsatisfiable branch (empty value set, e.g.
    from ``a==0 AND a==1``) is the union identity."""
    if _is_false(a):
        return _copy(b)
    if _is_false(b):
        return _copy(a)
    out = _Constraint()
    # Null-ness survives an OR only when BOTH branches require it.
    out.require_null = a.require_null and b.require_null
    out.require_non_null = a.require_non_null and b.require_non_null
    if a.values is not None and b.values is not None \
            and a.lo is None and a.hi is None and b.lo is None and b.hi is None:
        out.values = a.values | b.values
        return out

    def bounds(c: _Constraint):
        lo, lo_open, hi, hi_open = c.lo, c.lo_open, c.hi, c.hi_open
        if c.values is not None:
            try:
                vmin, vmax = min(c.values), max(c.values)
            except TypeError:
                return None
            lo = vmin if lo is None else min(lo, vmin)
            hi = vmax if hi is None else max(hi, vmax)
            lo_open = hi_open = False
        return lo, lo_open, hi, hi_open

    def flags_only():
        return out if (out.require_null or out.require_non_null) else None

    ba, bb = bounds(a), bounds(b)
    if ba is None or bb is None:
        return flags_only()
    try:
        if ba[0] is None or bb[0] is None:
            out.lo = None
        else:
            out.lo, out.lo_open = min((ba[0], ba[1]), (bb[0], bb[1]),
                                      key=lambda t: (t[0], t[1]))
        if ba[2] is None or bb[2] is None:
            out.hi = None
        else:
            out.hi, out.hi_open = max((ba[2], not ba[3]), (bb[2], not bb[3]),
                                      key=lambda t: (t[0], t[1]))
            out.hi_open = not out.hi_open
    except TypeError:
        return flags_only()
    if out.lo is None and out.hi is None:
        return flags_only()
    return out


def _intersect_into(target: _Constraint, c: _Constraint) -> None:
    """AND ``c`` into ``target`` (both constrain the same column)."""
    target.require_null |= c.require_null
    target.require_non_null |= c.require_non_null
    if c.values is not None:
        target.values = set(c.values) if target.values is None \
            else target.values & c.values
    if c.lo is not None:
        target.add_cmp(">" if c.lo_open else ">=", c.lo)
    if c.hi is not None:
        target.add_cmp("<" if c.hi_open else "<=", c.hi)


def _analyze(expr: Expr) -> Optional[Dict[str, _Constraint]]:
    """Per-column constraints implied by ``expr`` (names lowercased).
    {} = no usable constraint; never over-constrains (pruning stays
    conservative): an AND merges by intersection, an OR keeps only columns
    constrained on BOTH branches, merged by sound union."""
    if isinstance(expr, BinOp) and expr.op in _MIRROR:
        c = _Constraint()
        if isinstance(expr.left, Col) and isinstance(expr.right, Lit):
            c.add_cmp(expr.op, expr.right.value)
            return {expr.left.name.lower(): c}
        if isinstance(expr.right, Col) and isinstance(expr.left, Lit):
            c.add_cmp(_MIRROR[expr.op], expr.left.value)
            return {expr.right.name.lower(): c}
        return {}
    if isinstance(expr, IsIn) and isinstance(expr.child, Col):
        c = _Constraint()
        c.add_values(expr.values)
        return {expr.child.name.lower(): c}
    if isinstance(expr, IsNull) and isinstance(expr.child, Col):
        c = _Constraint()
        c.require_null = True
        return {expr.child.name.lower(): c}
    if isinstance(expr, Not) and isinstance(expr.child, IsNull) \
            and isinstance(expr.child.child, Col):
        c = _Constraint()
        c.require_non_null = True
        return {expr.child.child.name.lower(): c}
    if isinstance(expr, And):
        left = _analyze(expr.left) or {}
        right = _analyze(expr.right) or {}
        out = dict(left)
        for name, c in right.items():
            if name in out:
                _intersect_into(out[name], c)
            else:
                out[name] = c
        return out
    if isinstance(expr, Or):
        left = _analyze(expr.left)
        right = _analyze(expr.right)
        if not left or not right:
            return {}  # an unconstrained branch admits anything
        out: Dict[str, _Constraint] = {}
        for name in left.keys() & right.keys():
            u = _union(left[name], right[name])
            if u is not None:
                out[name] = u
        return out
    return {}


def extract_constraints(condition: Expr,
                        sketched: List[str]) -> Dict[str, _Constraint]:
    """Per-column constraints over the sketched columns.  Conjunctions
    intersect; disjunctions union soundly (pure value sets exactly, ranges
    as covering intervals) — so ``a == 1 OR a == 5`` prunes by the value
    pair and ``(a BETWEEN 1 AND 5) OR (a BETWEEN 90 AND 95)`` by the
    covering interval [1, 95]; opposite-unbounded sides (``a<3 OR a>90``)
    correctly yield no constraint.  NOT and other shapes contribute
    nothing (always conservative)."""
    analyzed = _analyze(condition) or {}
    lowered = {c.lower(): c for c in sketched}
    return {lowered[name]: c for name, c in analyzed.items()
            if name in lowered}


class _TypedProbe:
    """The constraint's equality/IN probe values COERCED to the sketched
    column's stored type — the same coercion execution applies to literals
    (executor's _arrow_eval cast), so membership tests agree with what a
    scan would actually match.  Uncoercible probes disable value-based
    pruning for the column (always conservative)."""

    def __init__(self, values=None, positions=None) -> None:
        self.values = values        # set of typed python values, or None
        self.positions = positions  # bloom bit positions, or None


def _typed_probe(entry: IndexLogEntry, col_name: str,
                 constraint: _Constraint, sketch_type: str) -> _TypedProbe:
    if not constraint.values:
        return _TypedProbe()
    type_str = entry.derived_dataset.schema.get(col_name)
    if not type_str:
        return _TypedProbe()
    import pyarrow as pa

    from hyperspace_tpu_torch.io.parquet import _dtype_from_string

    try:
        arr = pa.array(sorted(constraint.values, key=repr),
                       type=_dtype_from_string(type_str))
    except (pa.ArrowInvalid, pa.ArrowTypeError, ValueError, TypeError):
        return _TypedProbe()
    positions = bloom_positions(arr) if sketch_type == "BloomFilter" else None
    return _TypedProbe(set(arr.to_pylist()), positions)


def _file_ok(row: dict, col_name: str, constraint: _Constraint,
             probe: _TypedProbe) -> bool:
    if _is_false(constraint):
        return False
    nulls = row.get(_null_col(col_name))
    if constraint.require_null and nulls is not None and nulls == 0:
        return False  # no null anywhere in the file: IS NULL never holds
    if constraint.require_non_null:
        rows = row.get(SKETCH_ROW_COUNT)
        if nulls is not None and rows is not None and nulls >= rows:
            return False  # all-null file: IS NOT NULL never holds
    if constraint.require_null:
        # A null row satisfies no range/value constraint, so when ONLY
        # null rows are wanted the min/max checks below do not apply.
        return True
    fvalues = row.get(_values_col(col_name))
    if constraint.values is not None and fvalues is not None \
            and probe.values is not None:
        if not (set(fvalues) & probe.values):
            return False
    if not constraint.file_may_match(row.get(_min_col(col_name)),
                                     row.get(_max_col(col_name))):
        return False
    bloom = row.get(_bloom_col(col_name))
    if bloom is not None and probe.positions is not None \
            and not bloom_may_contain(bloom, probe.positions):
        return False
    return True


def _sketch_rows(entry: IndexLogEntry) -> List[dict]:
    key = tuple(sorted((f.name, f.size, f.mtime)
                       for f in entry.content.file_infos()))
    rows = _SKETCH_CACHE.get(key)
    if rows is None:
        rows = read_sketch(entry).to_pylist()
        if len(_SKETCH_CACHE) >= _SKETCH_CACHE_MAX:
            _SKETCH_CACHE.clear()
        _SKETCH_CACHE[key] = rows
    return rows


class DataSkippingFilterRule:
    def __init__(self, session,
                 entries: Optional[List[IndexLogEntry]] = None) -> None:
        self.session = session
        self._entries = entries

    def apply(self, plan: LogicalPlan) -> LogicalPlan:
        """Prune EVERY matching filter site in one forward pass
        (transform_up keeps untouched subtrees' identities; the session
        uniquifies the plan, so identity swaps touch exactly one site)."""
        files_memo: Dict = {}  # relation value -> listed files, per pass
        for matched in _extract_filter_nodes(plan):
            new_plan = self._try_apply(plan, matched, files_memo)
            if new_plan is not None:
                plan = new_plan
        return plan

    def _try_apply(self, plan: LogicalPlan, matched,
                   files_memo: Dict) -> Optional[LogicalPlan]:
        scan, filter_node, _ = matched
        if rule_utils.is_index_applied(scan) or \
                scan.relation.data_skipping_of is not None:
            return None
        spm = self.session.source_provider_manager
        if not spm.is_supported_relation(scan):
            return None

        entries = self._entries
        if entries is None:
            entries = self.session.index_collection_manager.get_indexes(
                [States.ACTIVE])
        ds_entries = [e for e in entries if not e.is_covering]
        if not ds_entries:
            return None

        # Cheap predicate check FIRST: the file listing (a full directory
        # walk + stat) only happens when some entry can actually constrain.
        # A bare IS NOT NULL (the ubiquitous join null-guard) is NOT
        # actionable on its own — it could only drop fully-all-null
        # files, which almost never exist, so paying the listing for it
        # on every such query would be a poor trade.
        def actionable(c: _Constraint) -> bool:
            return (c.values is not None or c.lo is not None
                    or c.hi is not None or c.require_null)

        with_constraints = []
        for entry in ds_entries:
            constraints = extract_constraints(
                filter_node.condition, entry.derived_dataset.sketched_columns)
            if constraints and any(actionable(c)
                                   for c in constraints.values()):
                with_constraints.append((entry, constraints))
        if not with_constraints:
            return None

        memo_key = scan.relation
        if memo_key not in files_memo:
            files_memo[memo_key] = spm.get_relation(scan).all_files()
        current = files_memo[memo_key]
        best: Optional[Tuple[IndexLogEntry, List[str]]] = None
        for entry, constraints in with_constraints:
            sketch_by_key = {
                (r[SKETCH_FILE_NAME], r[SKETCH_FILE_SIZE],
                 r[SKETCH_FILE_MTIME]): r
                for r in _sketch_rows(entry)
            }
            type_by_col = dict(zip(entry.derived_dataset.sketched_columns,
                                   entry.derived_dataset.sketch_types))
            probes = {col: _typed_probe(entry, col, c,
                                        type_by_col.get(col, "MinMax"))
                      for col, c in constraints.items()}
            surviving: List[str] = []
            for f in current:
                row = sketch_by_key.get((f.name, f.size, f.mtime))
                if row is None:
                    surviving.append(f.name)  # unknown to the sketch: keep
                    continue
                ok = all(_file_ok(row, col, c, probes[col])
                         for col, c in constraints.items())
                if ok:
                    surviving.append(f.name)
            if len(surviving) < len(current):
                if best is None or len(surviving) < len(best[1]):
                    best = (entry, surviving)
        if best is None:
            return None
        entry, surviving = best
        if not surviving:
            # Provably empty result; keep one file so the scan retains its
            # schema — the filter yields zero rows from it.
            surviving = [current[0].name]

        import dataclasses as dc

        new_rel = dc.replace(scan.relation,
                             file_paths=tuple(surviving),
                             data_skipping_of=entry.name,
                             data_skipping_stats=(len(surviving), len(current)))
        new_scan = Scan(new_rel)

        def swap(node: LogicalPlan) -> LogicalPlan:
            return new_scan if node is scan else node

        new_plan = plan.transform_up(swap)
        emit_event(HyperspaceIndexUsageEvent(
            index_names=[entry.name],
            plan_before=plan.tree_string(),
            plan_after=new_plan.tree_string(),
            message="DataSkippingFilterRule applied"))
        return new_plan


# ---------------------------------------------------------------------------
# Index-file pruning for covering indexes
# ---------------------------------------------------------------------------
_INDEX_SKETCH_CACHE: Dict[Tuple, List[dict]] = {}


def _load_index_sketch(path: str) -> List[dict]:
    import os

    st = os.stat(path)
    key = (path, st.st_size, st.st_mtime_ns)
    rows = _INDEX_SKETCH_CACHE.get(key)
    if rows is None:
        from hyperspace_tpu_torch.io.parquet import read_parquet_file

        rows = read_parquet_file(path, None).to_pylist()
        if len(_INDEX_SKETCH_CACHE) >= _SKETCH_CACHE_MAX:
            _INDEX_SKETCH_CACHE.clear()
        _INDEX_SKETCH_CACHE[key] = rows
    return rows


def prune_index_files_by_sketch(entry: IndexLogEntry, condition: Expr
                                ) -> Optional[Tuple[List[str], int]]:
    """For a covering index, drop index FILES whose per-file min/max (the
    ``_sketch.parquet`` each build version writes) provably excludes the
    predicate.  Returns (surviving file paths, total) or None when nothing
    prunes (no constraints, no sketches, or everything survives).  Versions
    without a sketch keep all their files — always conservative."""
    import os

    if not entry.is_covering:
        return None
    constraints = extract_constraints(condition, entry.indexed_columns)
    # This sketch stores min/max only: a require_null constraint cannot
    # prune here — file_may_match treats None min/max (an all-null file)
    # as non-matching, which is exactly the file holding the NULL rows.
    # And a require_non_null-ONLY constraint (the ubiquitous join
    # null-guard) could only drop fully-all-null index files, which
    # never repays the listing + sketch reads — same actionability
    # trade as DataSkippingFilterRule.  Keep value/range constraints.
    constraints = {c: k for c, k in constraints.items()
                   if not k.require_null
                   and (k.values is not None or k.lo is not None
                        or k.hi is not None)}
    if not constraints:
        return None
    files = [f.name for f in entry.content.file_infos()]
    by_dir: Dict[str, List[str]] = {}
    for f in files:
        by_dir.setdefault(os.path.dirname(f), []).append(f)
    surviving: List[str] = []
    any_sketch = False
    for d, fs in by_dir.items():
        sketch_path = os.path.join(d, INDEX_FILE_SKETCH)
        if not os.path.isfile(sketch_path):
            surviving.extend(fs)
            continue
        try:
            sketch_rows = _load_index_sketch(sketch_path)
        except Exception:  # noqa: BLE001 — a corrupt or unreadable sketch
            # must never fail the query: keeping every file is sound.
            surviving.extend(fs)
            continue
        any_sketch = True
        by_name = {r[SKETCH_FILE_NAME]: r for r in sketch_rows}
        for f in fs:
            row = by_name.get(f)
            if row is None:
                surviving.append(f)
                continue
            ok = all(
                c.file_may_match(row.get(_min_col(col)),
                                 row.get(_max_col(col)))
                for col, c in constraints.items())
            if ok:
                surviving.append(f)
    if not any_sketch or len(surviving) >= len(files):
        return None
    if not surviving:
        surviving = [files[0]]  # keep schema; filter yields zero rows
    return surviving, len(files)
