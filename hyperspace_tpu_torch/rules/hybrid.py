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

Not ported: quarantine containment (it belongs with verify and repair)
and ``closest_index``, which serves lake formats only.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from hyperspace_tpu_torch.actions.create import DATA_FILE_ID_COLUMN
from hyperspace_tpu_torch.index.log_entry import (
    FileInfo,
    IndexLogEntry,
    IndexLogEntryTags,
)
from hyperspace_tpu_torch.plan.expr import Col, IsIn, Not
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


def _file_key(f: FileInfo) -> Tuple[str, int, int]:
    return (f.name, f.size, f.mtime)


def get_hybrid_scan_candidates(session, entries: Sequence[IndexLogEntry],
                               scan: Scan) -> List[IndexLogEntry]:
    """The entries usable for ``scan`` under hybrid scan, each tagged with
    its shared bytes and its (appended, deleted) file lists."""
    current = session.source_provider_manager.get_relation(scan).all_files()
    current_by_key = {_file_key(f): f for f in current}
    conf = session.conf
    out: List[IndexLogEntry] = []
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
    """Swap ``target`` for the index merged with the appended files.
    ``prune_to_buckets`` restricts the index side's buckets; the appended
    side is raw source data and is always read."""
    appended, deleted = hybrid_file_lists(entry, target)
    visible_cols = entry.derived_dataset.all_columns
    index_side: LogicalPlan = Scan(rule_utils.index_scan_relation(
        entry, use_bucket_spec=bucket_union or prune_to_buckets is not None,
        prune_to_buckets=prune_to_buckets))
    if deleted:
        index_side = Filter(
            Not(IsIn(Col(DATA_FILE_ID_COLUMN), sorted({f.id for f in deleted}))),
            index_side)
    index_side = Project(visible_cols, index_side)
    if appended:
        src = target.relation
        appended_side: LogicalPlan = Project(visible_cols, Scan(ScanRelation(
            root_paths=src.root_paths, file_format=src.file_format,
            options=src.options,
            file_paths=tuple(f.name for f in appended))))
        cols = tuple(entry.indexed_columns)
        if bucket_union:
            merged: LogicalPlan = BucketUnion([index_side, appended_side],
                                              (entry.num_buckets, cols, cols))
        else:
            merged = Union([index_side, appended_side], strict=True)
    else:
        merged = index_side
    return plan.transform_up(lambda node: merged if node is target else node)
