"""Candidate enumeration and scoring over the captured workload
(counterpart of hyperspace_tpu/advisor/candidates.py).

A candidate is a covering index shaped the way the rewrite rules want
it: *indexed*, the columns the workload's filters pin or its joins key
on; *included*, the columns those queries project, so the rewritten scan
never reads the source.  Scores are in bytes:

  benefit      = sum over supporting fingerprints of
                   hits * max(0, measured bytes - est_index_bytes)
  est_index    = relation bytes * covered-column share
                   (/ num_buckets when the query pins every indexed
                    column by equality)
  build_cost   = relation bytes * covered-column share
  score        = benefit - build_cost

The model is coarse on purpose: its sign and order are what matter, and
the what-if pass gives the real optimizer's answer for one candidate.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, List, Tuple

from hyperspace_tpu_torch.plan.nodes import Scan, ScanRelation
from hyperspace_tpu_torch.telemetry import metrics


@dataclasses.dataclass
class Candidate:
    """One scored candidate covering index."""

    name: str
    roots: Tuple[str, ...]
    file_format: str
    options: Tuple[Tuple[str, str], ...]
    indexed: List[str]
    included: List[str]
    supporting_keys: List[str] = dataclasses.field(default_factory=list)
    supporting_hits: int = 0
    est_benefit_bytes: float = 0.0
    est_build_cost_bytes: float = 0.0

    @property
    def score(self) -> float:
        return self.est_benefit_bytes - self.est_build_cost_bytes

    def source_scan(self) -> Scan:
        return Scan(ScanRelation(root_paths=tuple(self.roots),
                                 file_format=self.file_format,
                                 options=tuple(self.options)))


def _sanitize(name: str) -> str:
    out = re.sub(r"[^a-z0-9_]+", "_", name.lower()).strip("_")
    return (out or "idx")[:64]


def _candidate_name(roots: Tuple[str, ...], indexed: List[str]) -> str:
    base = os.path.basename(roots[0].rstrip("/")) if roots else "rel"
    return _sanitize(f"adv_{base}_{'_'.join(indexed)}")


def generate_candidates(records: List[Dict[str, Any]],
                        max_candidates: int) -> List[Candidate]:
    """Candidates from workload records (``workload.records``): one per
    filtered column and one per join-key set of each relation, merged by
    (relation, indexed columns) with their included columns unioned, at
    most ``max_candidates`` of the most supported."""
    by_key: Dict[Tuple, Candidate] = {}
    for rec in records:
        hits = int(rec.get("hits", 0)) or 1
        for t in rec.get("tables", []):
            roots = tuple(t.get("roots", []))
            fmt = t.get("format", "parquet")
            options = tuple(tuple(kv) for kv in t.get("options", []))
            projected = list(t.get("projected", []))
            groups: List[List[str]] = [[c] for c in
                                       t.get("eq", []) + t.get("range", [])]
            if t.get("join"):
                groups.append(sorted(t["join"]))
            for indexed in groups:
                key = (roots, fmt, tuple(c.lower() for c in indexed))
                cand = by_key.get(key)
                if cand is None:
                    cand = Candidate(
                        name=_candidate_name(roots, indexed),
                        roots=roots, file_format=fmt, options=options,
                        indexed=list(indexed), included=[])
                    by_key[key] = cand
                lowered = {c.lower() for c in cand.indexed}
                for c in projected:
                    if c.lower() not in lowered and c not in cand.included:
                        cand.included.append(c)
                cand.included.sort()
                cand.supporting_hits += hits
                if rec.get("key") and rec["key"] not in cand.supporting_keys:
                    cand.supporting_keys.append(rec["key"])
    ranked = sorted(by_key.values(),
                    key=lambda c: (-c.supporting_hits, c.name))
    return ranked[:max(0, int(max_candidates))]


def _relation_stats(session, cand: Candidate,
                    records: List[Dict[str, Any]]) -> Tuple[float, int]:
    """(source bytes, schema width) of the candidate's relation: from the
    live listing, else the largest source bytes the workload measured."""
    try:
        rel = session.source_provider_manager.get_relation(
            cand.source_scan())
        files = rel.all_files()
        width = len(rel.schema()) or 1
        return float(sum(f.size for f in files)), width
    except Exception:  # noqa: BLE001 - a score is advisory
        best = 0.0
        roots_key = ",".join(cand.roots)
        for rec in records:
            tb = rec.get("last_table_bytes") or {}
            best = max(best, float(tb.get(roots_key, 0)),
                       float(rec.get("last_source_bytes", 0)))
        width = max(1, len(cand.indexed) + len(cand.included))
        return best, width


def score_candidates(session, candidates: List[Candidate],
                     records: List[Dict[str, Any]]) -> List[Candidate]:
    """Fill in each candidate's benefit and build cost (the module's
    model); the list sorted by score, best first, ties by name."""
    by_rec_key = {rec.get("key"): rec for rec in records}
    num_buckets = max(1, int(session.conf.num_buckets))
    for cand in candidates:
        rel_bytes, width = _relation_stats(session, cand, records)
        frac = min(1.0, (len(cand.indexed) + len(cand.included))
                   / max(1, width))
        cand.est_build_cost_bytes = rel_bytes * frac
        benefit = 0.0
        roots_key = ",".join(cand.roots)
        indexed_lower = {c.lower() for c in cand.indexed}
        for key in cand.supporting_keys:
            rec = by_rec_key.get(key)
            if rec is None:
                continue
            hits = int(rec.get("hits", 0)) or 1
            eq_pinned = False
            for t in rec.get("tables", []):
                if tuple(t.get("roots", [])) != cand.roots:
                    continue
                eq_pinned = indexed_lower <= {c.lower()
                                              for c in t.get("eq", [])}
            tb = rec.get("last_table_bytes") or {}
            measured = float(tb.get(roots_key,
                                    rec.get("last_source_bytes", 0)))
            est_scan = rel_bytes * frac
            if eq_pinned:
                est_scan /= num_buckets
            benefit += hits * max(0.0, measured - est_scan)
        cand.est_benefit_bytes = benefit
        metrics.inc("advisor.candidates_scored")
    return sorted(candidates, key=lambda c: (-c.score, c.name))
