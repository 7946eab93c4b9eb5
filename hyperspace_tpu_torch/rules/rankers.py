"""Candidate rankers (counterpart of hyperspace_tpu/rules/rankers.py):
choose the best index for a filter and the best index pair for a join.
Under hybrid scan the index sharing the most bytes with the current
source wins first (the least appended and deleted data to merge at query
time); the shared bytes are tags keyed by the scan they were computed
for."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, IndexLogEntryTags
from hyperspace_tpu_torch.plan.nodes import Scan


def _common_bytes(entry: IndexLogEntry, scan: Scan) -> int:
    v = entry.get_tag(IndexLogEntryTags.COMMON_BYTES, scan)
    return v if v is not None else 0


def _size_index_files(entry: IndexLogEntry) -> int:
    return sum(f.size for f in entry.content.file_infos())


def _tie_break_key(entry: IndexLogEntry,
                   filter_cols: Optional[Sequence[str]]) -> tuple:
    """A candidate whose FIRST indexed column the predicate names first
    (bucket pruning and the sort order serve that column), then the
    fewest included columns, the smallest index files, and the name:
    a deterministic winner whatever order the log listing gives."""
    first_not_filtered = 1
    if filter_cols is not None and entry.indexed_columns:
        lowered = {c.lower() for c in filter_cols}
        first_not_filtered = \
            0 if entry.indexed_columns[0].lower() in lowered else 1
    return (first_not_filtered, len(entry.included_columns),
            _size_index_files(entry), entry.name)


def rank_filter_indexes(candidates: List[IndexLogEntry], scan: Scan,
                        hybrid_scan: bool,
                        filter_cols: Optional[Sequence[str]] = None
                        ) -> Optional[IndexLogEntry]:
    if not candidates:
        return None
    if hybrid_scan:
        return min(candidates,
                   key=lambda e: (-_common_bytes(e, scan),)
                   + _tie_break_key(e, filter_cols))
    return min(candidates, key=lambda e: _tie_break_key(e, filter_cols))


def rank_join_index_pairs(
        pairs: List[Tuple[IndexLogEntry, IndexLogEntry]],
        l_scan: Scan, r_scan: Scan,
        hybrid_scan: bool) -> Optional[Tuple[IndexLogEntry, IndexLogEntry]]:
    """Prefer pairs with equal bucket counts, then, under hybrid scan, the
    most shared bytes, else the most buckets."""
    if not pairs:
        return None

    def key(pair: Tuple[IndexLogEntry, IndexLogEntry]):
        l, r = pair
        equal_buckets = l.num_buckets == r.num_buckets
        if hybrid_scan:
            return (equal_buckets,
                    _common_bytes(l, l_scan) + _common_bytes(r, r_scan))
        return (equal_buckets, l.num_buckets + r.num_buckets)

    return max(pairs, key=key)
