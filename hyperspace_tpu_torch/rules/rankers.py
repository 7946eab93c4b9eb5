"""Candidate rankers (counterpart of hyperspace_tpu/rules/rankers.py,
without the hybrid-scan common-bytes order): choose the best index for a
filter and the best index pair for a join."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry


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


def rank_filter_indexes(candidates: List[IndexLogEntry],
                        filter_cols: Optional[Sequence[str]] = None
                        ) -> Optional[IndexLogEntry]:
    if not candidates:
        return None
    return min(candidates, key=lambda e: _tie_break_key(e, filter_cols))


def rank_join_index_pairs(
        pairs: List[Tuple[IndexLogEntry, IndexLogEntry]]
) -> Optional[Tuple[IndexLogEntry, IndexLogEntry]]:
    """Prefer pairs with equal bucket counts, then more buckets."""
    if not pairs:
        return None
    return max(pairs, key=lambda p: (p[0].num_buckets == p[1].num_buckets,
                                     p[0].num_buckets + p[1].num_buckets))
