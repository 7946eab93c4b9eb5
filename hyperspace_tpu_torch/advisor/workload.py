"""Workload capture: a bounded, deduplicated log of query shapes
(counterpart of hyperspace_tpu/advisor/workload.py).

With ``conf.advisor_capture_enabled`` on, ``Dataset.collect`` feeds one
record per query here, built from the user's logical plan and the
query's run report (its per-scan bytes).  A fingerprint is structural
only: per source relation, the columns its filters pin (eq) or bound
(range), its join keys, group and projected columns; never a literal.

Records persist through the LogStore seam (io/log_store.py) under
``<systemPath>/_hyperspace_workload/``, one key per fingerprint, so they
survive restarts and merge across processes by generation CAS.  Repeats
of a known shape fold into an in-process hit counter that flushes at
power-of-two totals (or every ``MAX_PENDING`` pending hits);
``flush_pending`` forces it out, and ``records`` overlays it in memory.
At most ``conf.advisor_capture_max_entries`` shapes are kept; new ones
past the cap are dropped.

Capture never fails a query: ``capture`` catches its own errors, after
the answer exists (counted in ``advisor.capture.errors``); an
``InjectedCrash`` still propagates.  Each capture is an
``advisor.capture`` span counted in ``advisor.queries_captured``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Tuple

from hyperspace_tpu_torch.plan.expr import (
    BinOp,
    Col,
    IsIn,
    Lit,
    as_equi_join_pairs,
    split_conjuncts,
)
from hyperspace_tpu_torch.plan.nodes import Aggregate, Filter, Join, LogicalPlan
from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry.trace import span

WORKLOAD_DIR = "_hyperspace_workload"
RECORD_VERSION = 1
# Pending hits flush whenever they reach this, even off a power of two
# (the most an abrupt exit loses).
MAX_PENDING = 32


def workload_root(conf) -> str:
    from hyperspace_tpu_torch.index.manager import system_path_of

    return os.path.join(system_path_of(conf), WORKLOAD_DIR)


def store_for(conf):
    """The capture store: the class ``conf.log_store_class`` names,
    rooted at the workload directory."""
    from hyperspace_tpu_torch.io.log_store import store_from_conf

    return store_from_conf(conf, workload_root(conf))


def _relation_key(rel) -> str:
    return json.dumps({"roots": sorted(rel.root_paths),
                       "format": rel.file_format.lower(),
                       "options": sorted(rel.options)}, sort_keys=True)


def _classify_conjunct(e) -> Optional[Tuple[str, List[str]]]:
    """("eq" or "range", columns) of one conjunct, None when it is
    neither: eq pins a column to a finite set (equality, IN), range
    bounds it against a literal."""
    if isinstance(e, BinOp):
        cols = sorted(e.referenced_columns())
        if not cols:
            return None
        lit_side = isinstance(e.left, Lit) or isinstance(e.right, Lit)
        if e.op == "==" and lit_side:
            return "eq", cols
        if e.op in ("<", "<=", ">", ">=") and lit_side:
            return "range", cols
        return None
    if isinstance(e, IsIn) and isinstance(e.child, Col):
        return "eq", [e.child.name]
    return None


def _resolve_one(col: str, schema: List[str]) -> Optional[str]:
    lowered = col.lower()
    for s in schema:
        if s.lower() == lowered:
            return s
    return None


def fingerprint(session, plan: LogicalPlan) -> Optional[Dict[str, Any]]:
    """The structural fingerprint of ``plan``, None when it reads no
    source relation (nothing to index)."""
    scans = [s for s in plan.leaf_relations()
             if s.relation.index_scan_of is None]
    if not scans:
        return None
    tables: Dict[str, Dict[str, Any]] = {}
    schema_of: Dict[str, List[str]] = {}
    for s in scans:
        key = _relation_key(s.relation)
        if key not in tables:
            tables[key] = {"roots": list(s.relation.root_paths),
                           "format": s.relation.file_format.lower(),
                           "options": [list(kv) for kv in s.relation.options],
                           "eq": [], "range": [], "join": [], "group": [],
                           "projected": []}
            try:
                schema_of[key] = list(session.schema_of(s))
            except Exception:  # noqa: BLE001 - an unreadable relation
                # still fingerprints, without column attribution
                schema_of[key] = []

    def attribute(cols: List[str], field: str,
                  candidate_keys: List[str]) -> None:
        for c in cols:
            for key in candidate_keys:
                resolved = _resolve_one(c, schema_of.get(key, []))
                if resolved is not None:
                    bucket = tables[key][field]
                    if resolved not in bucket:
                        bucket.append(resolved)
                    break

    all_keys = list(tables)

    def walk(node: LogicalPlan) -> None:
        if isinstance(node, Filter):
            below = [_relation_key(s.relation)
                     for s in node.leaf_relations()
                     if s.relation.index_scan_of is None]
            keys = sorted(set(below)) or all_keys
            for conj in split_conjuncts(node.condition):
                hit = _classify_conjunct(conj)
                if hit is not None:
                    attribute(hit[1], hit[0], keys)
        elif isinstance(node, Join):
            for a, b in as_equi_join_pairs(node.condition) or ():
                attribute([a, b], "join", all_keys)
        elif isinstance(node, Aggregate):
            attribute(list(node.group_by), "group", all_keys)
        for c in node.children:
            walk(c)

    walk(plan)
    try:
        output = plan.output_columns(session.schema_of)
    except Exception:  # noqa: BLE001 - attribution is best effort
        output = []
    for key in all_keys:
        needed = list(output) + tables[key]["eq"] + tables[key]["range"] \
            + tables[key]["join"] + tables[key]["group"]
        attribute(needed, "projected", [key])
        for field in ("eq", "range", "join", "group", "projected"):
            tables[key][field] = sorted(tables[key][field])
    return {"tables": [tables[k] for k in sorted(tables)]}


def fingerprint_key(fp: Dict[str, Any]) -> str:
    digest = hashlib.sha1(
        json.dumps(fp, sort_keys=True).encode("utf-8")).hexdigest()[:16]
    return urllib.parse.quote(f"q-{digest}", safe="")


@dataclasses.dataclass
class _Pending:
    fp: Dict[str, Any]
    hits: int = 0
    bytes_total: int = 0
    duration_ms_total: float = 0.0
    last: Dict[str, Any] = dataclasses.field(default_factory=dict)
    stored_hits: Optional[int] = None  # None: the store's state unknown
    dropped: bool = False  # past the cap: never persisted


_lock = threading.Lock()
_pending: Dict[Tuple[str, str], _Pending] = {}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def capture(session, plan: LogicalPlan, report,
            result_rows: Optional[int] = None) -> None:
    """Record one executed query; never raises an ``Exception``."""
    try:
        with span("advisor.capture"):
            _capture_inner(session, plan, report, result_rows)
            metrics.inc("advisor.queries_captured")
    except Exception:  # noqa: BLE001 - capture never costs an answer
        metrics.inc("advisor.capture.errors")


def _capture_inner(session, plan, report, result_rows) -> None:
    fp = fingerprint(session, plan)
    if fp is None:
        return
    key = fingerprint_key(fp)
    root = workload_root(session.conf)

    bytes_scanned = report.bytes_read() if report is not None else 0
    source_bytes = report.bytes_read(is_index=False) if report else 0
    scans = report.scans() if report is not None else []
    # Per-table measured bytes: a source scan's relation is its roots
    # joined by commas.
    by_roots = {",".join(t["roots"]): t for t in fp["tables"]}
    table_bytes: Dict[str, int] = {}
    for d in scans:
        t = by_roots.get(d.get("relation", ""))
        if t is not None:
            tkey = ",".join(t["roots"])
            table_bytes[tkey] = table_bytes.get(tkey, 0) \
                + int(d.get("bytes_read", 0))
    rows_scanned = 0
    stats = session.last_execution_stats or {}
    for s in stats.get("scans", []):
        rows_scanned += int(s.get("rows", 0) or 0)
    selectivity = None
    if result_rows is not None and rows_scanned > 0:
        selectivity = round(min(1.0, result_rows / rows_scanned), 6)

    last = {"bytes_scanned": int(bytes_scanned),
            "source_bytes": int(source_bytes),
            "table_bytes": table_bytes,
            "result_rows": result_rows,
            "selectivity": selectivity,
            "duration_ms": round(getattr(report, "duration_ms", 0.0), 3),
            "ts": time.time()}

    with _lock:
        p = _pending.get((root, key))
        if p is None:
            p = _Pending(fp=fp)
            _pending[(root, key)] = p
        p.hits += 1
        p.bytes_total += int(bytes_scanned)
        p.duration_ms_total += last["duration_ms"]
        p.last = last
        if p.dropped:
            return
        total = (p.stored_hits or 0) + p.hits
        if p.stored_hits is not None and not _is_pow2(total) \
                and p.hits < MAX_PENDING:
            return  # folded; flushed at the next boundary
        _flush_locked(session.conf, key, p)


def _new_record(p: _Pending, hits: int, bytes_total: int,
                duration_ms_total: float) -> Dict[str, Any]:
    return {"v": RECORD_VERSION, "tables": p.fp["tables"], "hits": hits,
            "bytes_scanned_total": bytes_total,
            "duration_ms_total": round(duration_ms_total, 3)}


def _merge(rec: Dict[str, Any], p: _Pending) -> None:
    """Fold ``p``'s pending counters and last values into ``rec``."""
    rec["hits"] = int(rec.get("hits", 0)) + p.hits
    rec["bytes_scanned_total"] = \
        int(rec.get("bytes_scanned_total", 0)) + p.bytes_total
    rec["duration_ms_total"] = round(
        float(rec.get("duration_ms_total", 0.0)) + p.duration_ms_total, 3)
    for k, v in p.last.items():
        rec[f"last_{k}"] = v


def _flush_locked(conf, key: str, p: _Pending) -> None:
    """Merge ``p``'s pending counters into the store by generation CAS,
    a few tries; losing every race defers to the next flush."""
    store = store_for(conf)
    for _ in range(4):
        data, gen = store.read_with_generation(key)
        if data is None:
            if len(store.list_keys()) >= int(conf.advisor_capture_max_entries):
                metrics.inc("advisor.capture.dropped")
                p.dropped = True
                return
            rec = _new_record(p, p.hits, p.bytes_total, p.duration_ms_total)
            rec.update({f"last_{k}": v for k, v in p.last.items()})
            if store.put_if_absent(key, json.dumps(rec).encode("utf-8")):
                p.stored_hits = p.hits
                p.hits = p.bytes_total = 0
                p.duration_ms_total = 0.0
                return
        else:
            try:
                rec = json.loads(data.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                # A torn record: rewritten whole from what is known.
                rec = _new_record(p, 0, 0, 0.0)
            _merge(rec, p)
            payload = json.dumps(rec).encode("utf-8")
            if store.put_if_generation_match(key, payload, gen):
                p.stored_hits = rec["hits"]
                p.hits = p.bytes_total = 0
                p.duration_ms_total = 0.0
                return
    metrics.inc("advisor.capture.cas_giveup")


def flush_pending(conf) -> None:
    """Write every pending hit counter of this conf's workload out to the
    store."""
    root = workload_root(conf)
    with _lock:
        for (r, key), p in list(_pending.items()):
            if r == root and p.hits > 0 and not p.dropped:
                _flush_locked(conf, key, p)


def reset_cache() -> None:
    """Drop the in-process pending counters."""
    with _lock:
        _pending.clear()


def records(conf) -> List[Dict[str, Any]]:
    """Every persisted record with this process's pending counters
    overlaid in memory (a pure read), most hits first; unparseable
    records are skipped."""
    store = store_for(conf)
    out: List[Dict[str, Any]] = []
    by_key: Dict[str, Dict[str, Any]] = {}
    for key in store.list_keys():
        try:
            rec = json.loads(store.read(key).decode("utf-8"))
        except (FileNotFoundError, ValueError, UnicodeDecodeError):
            continue
        if not isinstance(rec, dict) or "tables" not in rec:
            continue
        rec["key"] = key
        out.append(rec)
        by_key[key] = rec
    root = workload_root(conf)
    with _lock:
        for (r, key), p in _pending.items():
            if r != root or p.hits <= 0 or p.dropped:
                continue
            rec = by_key.get(key)
            if rec is None:
                rec = _new_record(p, 0, 0, 0.0)
                rec["key"] = key
                out.append(rec)
                by_key[key] = rec
            _merge(rec, p)
    return sorted(out, key=lambda r: (-int(r.get("hits", 0)), r["key"]))


def workload_table(conf):
    """The captured workload as a pyarrow table, one row per shape."""
    import pyarrow as pa

    rows: Dict[str, list] = {
        "key": [], "hits": [], "relations": [], "eqColumns": [],
        "rangeColumns": [], "joinColumns": [], "groupColumns": [],
        "projectedColumns": [], "lastBytesScanned": [],
        "bytesScannedTotal": [], "lastDurationMs": [], "lastSelectivity": []}
    for rec in records(conf):
        tables = rec.get("tables", [])

        def gather(field):
            return sorted({c for t in tables for c in t.get(field, [])})

        rows["key"].append(rec["key"])
        rows["hits"].append(int(rec.get("hits", 0)))
        rows["relations"].append(
            [",".join(t.get("roots", [])) for t in tables])
        rows["eqColumns"].append(gather("eq"))
        rows["rangeColumns"].append(gather("range"))
        rows["joinColumns"].append(gather("join"))
        rows["groupColumns"].append(gather("group"))
        rows["projectedColumns"].append(gather("projected"))
        rows["lastBytesScanned"].append(int(rec.get("last_bytes_scanned", 0)))
        rows["bytesScannedTotal"].append(
            int(rec.get("bytes_scanned_total", 0)))
        rows["lastDurationMs"].append(
            float(rec.get("last_duration_ms", 0.0)))
        sel = rec.get("last_selectivity")
        rows["lastSelectivity"].append(
            float(sel) if sel is not None else None)
    return pa.table(rows)


def clear(conf) -> None:
    """Wipe the captured workload: the store and the pending counters."""
    store = store_for(conf)
    for key in store.list_keys():
        store.delete(key)
    root = workload_root(conf)
    with _lock:
        for rk in [rk for rk in _pending if rk[0] == root]:
            del _pending[rk]
