"""Shared rule machinery (counterpart of hyperspace_tpu/rules/rule_utils.py):
which ACTIVE indexes are valid for a scan, and the swap of a scan for an
index-only scan.

An index is a candidate for a scan when the signature recorded at build
time equals the one recomputed over the scan's files now (once per
provider per rule pass; the result is memoised on the entry, keyed by
the scan).  With ``conf.hybrid_scan_enabled`` the file-overlap test of
``rules.hybrid`` replaces the signature match; without it an entry
whose quick refresh recorded source changes is not a candidate.  An
index-only scan of an index with the lineage column is projected to the
index's own columns, so enabling the indexes never changes a query's
output schema.  An entry whose quarantine leaves no containment plan
(``rules.hybrid.quarantine_excludes_entry``) is no candidate; a partly
quarantined one stays one, and the rules read its damaged buckets from
the source.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, IndexLogEntryTags
from hyperspace_tpu_torch.index.signatures import get_provider
from hyperspace_tpu_torch.plan.nodes import LogicalPlan, Project, Scan, ScanRelation


def is_index_applied(scan: Scan) -> bool:
    return scan.relation.index_scan_of is not None


def get_candidate_indexes(session, entries: Sequence[IndexLogEntry],
                          scan: Scan) -> List[IndexLogEntry]:
    """The covering entries whose signature matches ``scan`` now."""
    entries = [e for e in entries if e.is_covering]
    if is_index_applied(scan):
        return []
    from hyperspace_tpu_torch.rules.hybrid import (
        get_hybrid_scan_candidates,
        quarantine_excludes_entry,
    )

    entries = [e for e in entries
               if not quarantine_excludes_entry(session, e)]
    if session.conf.hybrid_scan_enabled:
        return get_hybrid_scan_candidates(session, entries, scan)
    signature_cache: Dict[str, Optional[str]] = {}

    def current_signature(provider_name: str) -> Optional[str]:
        if provider_name not in signature_cache:
            signature_cache[provider_name] = get_provider(provider_name).signature(
                scan,
                lambda s: session.source_provider_manager.get_relation(s).all_files())
        return signature_cache[provider_name]

    out: List[IndexLogEntry] = []
    for entry in entries:
        if entry.has_source_update():
            # Only hybrid scan can use a quick-refreshed entry.
            continue
        matched = entry.get_tag(IndexLogEntryTags.SIGNATURE_MATCHED, scan)
        if matched is None:
            sig = entry.signature()
            matched = current_signature(sig.provider) == sig.value
            entry.set_tag(IndexLogEntryTags.SIGNATURE_MATCHED, matched, scan)
        if matched:
            out.append(entry)
    return out


def index_scan_relation(entry: IndexLogEntry, use_bucket_spec: bool,
                        prune_to_buckets: Optional[Tuple[int, ...]] = None,
                        file_paths: Optional[Sequence[str]] = None,
                        file_stats: Optional[Tuple[int, int]] = None
                        ) -> ScanRelation:
    """The relation that reads an index's bucketed Parquet files, or
    ``file_paths``, the subset a sketch kept (``file_stats``: kept, in
    all).  A what-if entry's relation carries the hypothetical tag and
    the entry's schema."""
    files = list(file_paths) if file_paths is not None \
        else [f.name for f in entry.content.file_infos()]
    root = os.path.dirname(files[0]) if files else ""
    cols = tuple(entry.indexed_columns)
    return ScanRelation(
        root_paths=(root,),
        file_format="parquet",
        index_scan_of=entry.name,
        bucket_spec=(entry.num_buckets, cols, cols) if use_bucket_spec else None,
        file_paths=tuple(files),
        prune_to_buckets=prune_to_buckets,
        data_skipping_stats=file_stats,
        hypothetical=entry.is_hypothetical,
        hypothetical_schema=tuple(
            (c, entry.derived_dataset.schema.get(c, "string"))
            for c in entry.derived_dataset.all_columns)
        if entry.is_hypothetical else None,
    )


def transform_plan_to_use_index_only_scan(
        plan: LogicalPlan, target: Scan, entry: IndexLogEntry,
        use_bucket_spec: bool,
        prune_to_buckets: Optional[Tuple[int, ...]] = None,
        file_paths: Optional[Sequence[str]] = None,
        file_stats: Optional[Tuple[int, int]] = None) -> LogicalPlan:
    """Swap ``target`` for an index-only scan throughout ``plan``."""
    new_node: LogicalPlan = Scan(index_scan_relation(
        entry, use_bucket_spec, prune_to_buckets, file_paths, file_stats))
    if entry.has_lineage_column():
        new_node = Project(entry.derived_dataset.all_columns, new_node)
    return plan.transform_up(lambda node: new_node if node is target else node)
