"""Ranked recommendations and their one-call apply (counterpart of
hyperspace_tpu/advisor/recommend.py).

``Hyperspace.recommend_indexes(top_k)`` reads the captured workload (its
pending counters flushed first), enumerates candidates, scores them
(advisor/candidates.py) and returns a pyarrow table.
``apply_recommendations(top_k)`` builds the winners through the normal
create path (the same validation, log protocol and build as
``create_index``, so both CUDA kernels run on the card), skipping a
candidate an ACTIVE index already covers.
"""

from __future__ import annotations

from typing import List, Optional

from hyperspace_tpu_torch.advisor import candidates as _cand
from hyperspace_tpu_torch.advisor import workload as _workload
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import States
from hyperspace_tpu_torch.telemetry.trace import span


def scored_candidates(session) -> List[_cand.Candidate]:
    _workload.flush_pending(session.conf)
    recs = _workload.records(session.conf)
    cands = _cand.generate_candidates(
        recs, session.conf.advisor_max_candidates)
    return _cand.score_candidates(session, cands, recs)


def recommend_indexes(session, top_k: int = 5):
    """The ranked recommendation table (``Hyperspace.recommend_indexes``)."""
    import pyarrow as pa

    with span("advisor.recommend", top_k=top_k):
        ranked = scored_candidates(session)[:max(0, int(top_k))]
    return pa.table({
        "candidate": [c.name for c in ranked],
        "relation": [",".join(c.roots) for c in ranked],
        "indexedColumns": [list(c.indexed) for c in ranked],
        "includedColumns": [list(c.included) for c in ranked],
        "supportingQueries": [len(c.supporting_keys) for c in ranked],
        "supportingHits": [c.supporting_hits for c in ranked],
        "estBenefitBytes": [round(c.est_benefit_bytes, 1) for c in ranked],
        "estBuildCostBytes": [round(c.est_build_cost_bytes, 1)
                              for c in ranked],
        "score": [round(c.score, 1) for c in ranked],
    })


def _already_covered(session, cand: _cand.Candidate) -> bool:
    """Whether an ACTIVE covering index over the candidate's relation has
    its indexed columns and covers its included ones."""
    try:
        entries = session.index_collection_manager.get_indexes(
            [States.ACTIVE])
    except Exception:  # noqa: BLE001 - a failed listing must not stop
        return False   # the build; the create validates again
    want_indexed = sorted(c.lower() for c in cand.indexed)
    want_cols = {c.lower() for c in cand.indexed + cand.included}
    roots = set(cand.roots)
    for e in entries:
        if not e.is_covering:
            continue
        if sorted(c.lower() for c in e.indexed_columns) != want_indexed:
            continue
        if not want_cols <= {c.lower()
                             for c in e.derived_dataset.all_columns}:
            continue
        if roots <= {r for rel in e.relations for r in rel.root_paths}:
            return True
    return False


def _unique_name(session, base: str) -> str:
    mgr = session.index_collection_manager
    name, n = base, 1
    while True:
        try:
            taken = mgr.get_index(name) is not None
        except Exception:  # noqa: BLE001 - an unreadable log still
            taken = True   # occupies the name
        if not taken:
            return name
        n += 1
        name = f"{base}_{n}"


def apply_recommendations(session, top_k: int = 1,
                          min_score: Optional[float] = None) -> List[str]:
    """Build the top ``top_k`` recommendations through the normal create
    path; returns the names built.  ``min_score`` (bytes) skips the
    candidates below it."""
    from hyperspace_tpu_torch.dataset import Dataset

    built: List[str] = []
    with span("advisor.apply", top_k=top_k):
        for cand in scored_candidates(session)[:max(0, int(top_k))]:
            if min_score is not None and cand.score < min_score:
                continue
            if _already_covered(session, cand):
                continue
            name = _unique_name(session, cand.name)
            ds = Dataset(cand.source_scan(), session)
            session.index_collection_manager.create(
                ds, IndexConfig(name, cand.indexed, cand.included))
            built.append(name)
    return built
