"""Hybrid scan: a stale index answers a query over its changed source
(counterpart of hyperspace_tpu/rules/hybrid.py).

  - candidates: an index whose recorded source files no longer match the
    current ones is still usable while they share bytes, the appended
    bytes are at most ``conf.hybrid_scan_max_appended_ratio`` of the
    current bytes, and the deleted bytes at most
    ``conf.hybrid_scan_max_deleted_ratio`` of the indexed bytes (deletes
    need the lineage column).  The shared bytes are tagged on the entry
    for the rankers.
  - transform: the index side becomes
    ``Filter(Not(IsIn(_data_file_id, deleted ids)))`` over the index scan
    when files were deleted, projected to the index's own columns; the
    appended files are read by a scan of their own and merged with
    ``BucketUnion`` on a join side (the executor routes their rows into
    the index's buckets) or ``Union(strict=True)`` on a filter side.
  - quarantine containment: an index data file recorded as damaged
    (index/quarantine.py) drops its whole bucket from the index side,
    and that bucket's rows are read again from the common source files
    by a ``Project(Filter(BucketIn(indexed, numBuckets, buckets),
    Scan(common source files)))`` branch unioned back in, the merge
    shape of the appended files.  One damaged bucket costs one bucket's
    rows of source, not the whole index; a join side cannot take the
    branch (it has no bucket structure to align) and is refused.
  - versions: before the overlap test, each candidate over the scanned
    relation is swapped for ``relation.closest_index(entry)``, the index
    log version a time-travelled lake read is best served by (Delta's
    ``versionAsOf``/``timestampAsOf``); an entry over another relation
    keeps its own, so no other index's old versions are read.
"""

from __future__ import annotations

import os
from typing import FrozenSet, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.actions.create import DATA_FILE_ID_COLUMN
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import (
    FileInfo,
    IndexLogEntry,
    IndexLogEntryTags,
)
from hyperspace_tpu_torch.plan.expr import BucketIn, Col, IsIn, Not
from hyperspace_tpu_torch.plan.nodes import (
    BucketUnion,
    Filter,
    LogicalPlan,
    Project,
    Scan,
    ScanRelation,
    Union,
)
from hyperspace_tpu_torch.rules import rule_utils

_HYBRID_INFO_TAG = "hybridScanFileLists"  # (appended, deleted) FileInfo lists
_QUARANTINE_TAG = "quarantineSplit"  # (excluded paths, buckets or None)


def _file_key(f: FileInfo) -> Tuple[str, int, int]:
    return (f.name, f.size, f.mtime)


def get_hybrid_scan_candidates(session, entries: Sequence[IndexLogEntry],
                               scan: Scan) -> List[IndexLogEntry]:
    """The entries usable for ``scan`` under hybrid scan, each tagged with
    its shared bytes and its (appended, deleted) file lists."""
    relation = session.source_provider_manager.get_relation(scan)
    current = relation.all_files()
    current_by_key = {_file_key(f): f for f in current}
    conf = session.conf
    out: List[IndexLogEntry] = []
    scan_roots = {os.path.abspath(p) for p in relation.root_paths}

    def same_relation(e: IndexLogEntry) -> bool:
        return any(os.path.abspath(p) in scan_roots
                   for r in e.relations for p in r.root_paths)

    entries = [relation.closest_index(e) if same_relation(e) else e
               for e in entries]
    for entry in entries:
        cached = entry.get_tag(IndexLogEntryTags.IS_HYBRIDSCAN_CANDIDATE, scan)
        if cached is not None:
            if cached:
                out.append(entry)
            continue
        indexed_keys = {_file_key(f): f for f in entry.source_file_infos()}
        common_keys = indexed_keys.keys() & current_by_key.keys()
        common_bytes = sum(k[1] for k in common_keys)
        appended = [f for k, f in current_by_key.items() if k not in common_keys]
        deleted = [f for k, f in indexed_keys.items() if k not in common_keys]
        appended_bytes = sum(f.size for f in appended)
        deleted_bytes = sum(f.size for f in deleted)
        ok = common_bytes > 0
        if ok and appended_bytes:
            ok = appended_bytes / (common_bytes + appended_bytes) \
                <= conf.hybrid_scan_max_appended_ratio
        if ok and deleted_bytes:
            ok = (entry.has_lineage_column()
                  and deleted_bytes / (common_bytes + deleted_bytes)
                  <= conf.hybrid_scan_max_deleted_ratio)
        entry.set_tag(IndexLogEntryTags.IS_HYBRIDSCAN_CANDIDATE, ok, scan)
        entry.set_tag(IndexLogEntryTags.COMMON_BYTES, common_bytes, scan)
        entry.set_tag(_HYBRID_INFO_TAG, (appended, deleted), scan)
        if ok:
            out.append(entry)
    return out


def quarantined_split(session, entry: IndexLogEntry
                      ) -> Tuple[FrozenSet[str], Optional[Tuple[int, ...]]]:
    """(excluded index file paths, affected bucket ids) of ``entry``.

    A quarantined file takes its whole bucket with it: a bucket split
    over several files must drop entirely, or the source branch would
    repeat its healthy files' rows.  ``buckets`` None with files
    excluded means no containment plan exists (a quarantined file whose
    bucket its name does not tell, or every file excluded): the
    candidate selection drops the entry and the source answers.  The
    result is a tag of the entry, which the optimizer reads again from
    the log on every pass, so the store is listed once per entry per
    query."""
    cached = entry.get_tag(_QUARANTINE_TAG)
    if cached is not None:
        return cached
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    infos = entry.content.file_infos()
    qpaths = session.index_collection_manager \
        .quarantine_manager(entry.name).paths([f.name for f in infos])
    result: Tuple[FrozenSet[str], Optional[Tuple[int, ...]]] = (frozenset(), ())
    flagged = [f.name for f in infos if f.name in qpaths]
    if flagged:
        buckets = {bucket_id_of_file(p) for p in flagged}
        if None in buckets:
            result = (frozenset(f.name for f in infos), None)
        else:
            excluded = frozenset(f.name for f in infos
                                 if bucket_id_of_file(f.name) in buckets)
            # Nothing healthy left: containment would be a source scan.
            result = (excluded, None) if len(excluded) == len(infos) \
                else (excluded, tuple(sorted(buckets)))
    entry.set_tag(_QUARANTINE_TAG, result)
    return result


def quarantine_excludes_entry(session, entry: IndexLogEntry) -> bool:
    """Whether the quarantine leaves ``entry`` no containment plan (drop
    it from the candidates; the source answers)."""
    excluded, buckets = quarantined_split(session, entry)
    return bool(excluded) and buckets is None


def hybrid_file_lists(entry: IndexLogEntry, scan: Scan
                      ) -> Tuple[List[FileInfo], List[FileInfo]]:
    """(appended, deleted) of ``entry`` against ``scan``: the candidate
    selection's tag when it ran, else the lists a quick refresh
    recorded in the entry."""
    info = entry.get_tag(_HYBRID_INFO_TAG, scan)
    if info is not None:
        return info
    return entry.appended_files(), entry.deleted_files()


def transform_plan_to_use_hybrid_scan(session, plan: LogicalPlan, target: Scan,
                                      entry: IndexLogEntry, bucket_union: bool,
                                      prune_to_buckets=None) -> LogicalPlan:
    """Swap ``target`` for the index merged with the appended files and
    with the source rows of its quarantined buckets.
    ``prune_to_buckets`` restricts the index side's buckets; the appended
    side is raw source data and is always read."""
    appended, deleted = hybrid_file_lists(entry, target)
    excluded, qbuckets = quarantined_split(session, entry)
    if excluded and qbuckets is None:
        # The candidate selection drops such entries; reaching here means
        # a caller skipped that check.
        raise HyperspaceError(
            f"index {entry.name!r} has unusable quarantined files")
    if excluded and bucket_union:
        # JoinIndexRule drops quarantined entries from its candidates.
        raise HyperspaceError(
            f"index {entry.name!r} has quarantined buckets; bucket-aligned "
            "join merge is not possible")
    visible_cols = entry.derived_dataset.all_columns
    index_files = None if not excluded else tuple(
        f.name for f in entry.content.file_infos() if f.name not in excluded)
    index_side: LogicalPlan = Scan(rule_utils.index_scan_relation(
        entry, use_bucket_spec=bucket_union or prune_to_buckets is not None,
        prune_to_buckets=prune_to_buckets, file_paths=index_files))
    if deleted:
        index_side = Filter(
            Not(IsIn(Col(DATA_FILE_ID_COLUMN), sorted({f.id for f in deleted}))),
            index_side)
    index_side = Project(visible_cols, index_side)
    src = target.relation

    def source_scan(files) -> Scan:
        return Scan(ScanRelation(
            root_paths=src.root_paths, file_format=src.file_format,
            options=src.options, file_paths=tuple(f.name for f in files)))

    repair_side: Optional[LogicalPlan] = None
    if qbuckets:
        # The quarantined buckets' rows, read from the COMMON source
        # files (recorded minus deleted): appended files' rows come
        # through the appended branch, and deleted ones must not return.
        # BucketIn hashes as the build did, so the branch holds exactly
        # the rows the dropped files held.
        deleted_keys = {_file_key(f) for f in deleted}
        common = [f for f in entry.source_file_infos()
                  if _file_key(f) not in deleted_keys]
        if common:
            repair_side = Project(visible_cols, Filter(
                BucketIn(tuple(entry.indexed_columns), entry.num_buckets,
                         qbuckets),
                source_scan(common)))
    sides = [index_side]
    if appended:
        sides.append(Project(visible_cols, source_scan(appended)))
    if repair_side is not None:
        sides.append(repair_side)
    if len(sides) == 1:
        merged: LogicalPlan = index_side
    elif bucket_union:
        # A join side (never one with quarantined buckets, refused above).
        cols = tuple(entry.indexed_columns)
        merged = BucketUnion(sides, (entry.num_buckets, cols, cols))
    else:
        merged = Union(sides, strict=True)
    return plan.transform_up(lambda node: merged if node is target else node)
