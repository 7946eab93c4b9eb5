"""Row-level CDC (counterpart of hyperspace_tpu/lifecycle/cdc.py):
merge-on-read debt and the compaction rung of the policy.

  - ``merge_debt``: with lineage and hybrid scan, a quick refresh
    records deleted and rewritten source files as the entry's pending
    deletes and the new versions as pending appends; the hybrid rule
    serves that overlay at scan time, bit-equal to a rebuild.  This
    measures the debt, so the policy keeps taking quick refreshes while
    it is cheap and schedules the incremental refresh when it is not.
  - ``compaction_stats`` / ``decide_compaction``: each incremental
    refresh lands one more file per touched bucket; when an otherwise
    idle index carries enough mergeable small files, the daemon
    schedules an optimize.

Pure functions over an index log entry, no IO.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

from hyperspace_tpu_torch.lifecycle.policy import KIND_OPTIMIZE, MaintenanceDecision


@dataclasses.dataclass(frozen=True)
class MergeDebt:
    """The merge-on-read overlay an index entry currently carries:
    pending appended/deleted source files a quick refresh recorded and
    the hybrid rule resolves at scan time."""

    index: str
    appended_files: int      # pending appends (served from source)
    deleted_files: int       # pending deletes (lineage-filtered out)
    appended_bytes: int
    deleted_bytes: int
    recorded_bytes: int      # the entry's recorded source bytes
    lineage: bool            # can the delete overlay be applied?

    @property
    def total_bytes(self) -> int:
        return self.appended_bytes + self.deleted_bytes

    @property
    def ratio(self) -> float:
        """Debt bytes over recorded source bytes — the number the
        ``conf.lifecycle_cdc_merge_debt_ratio`` budget bounds."""
        return self.total_bytes / max(1, self.recorded_bytes)

    @property
    def readable(self) -> bool:
        """False when the entry carries a delete overlay it cannot
        apply (no lineage column): hybrid candidate math drops such an
        entry, so every query over it falls back to a full source scan
        — the index serves nothing until a real refresh."""
        return self.deleted_files == 0 or self.lineage

    def to_dict(self) -> dict:
        return {"index": self.index,
                "appended_files": self.appended_files,
                "deleted_files": self.deleted_files,
                "appended_bytes": self.appended_bytes,
                "deleted_bytes": self.deleted_bytes,
                "recorded_bytes": self.recorded_bytes,
                "ratio": round(self.ratio, 4),
                "readable": self.readable}


def merge_debt(entry) -> MergeDebt:
    """Measure ``entry``'s merge-on-read overlay (pure, no IO)."""
    appended = entry.appended_files()
    deleted = entry.deleted_files()
    return MergeDebt(
        index=entry.name,
        appended_files=len(appended),
        deleted_files=len(deleted),
        appended_bytes=sum(f.size for f in appended),
        deleted_bytes=sum(f.size for f in deleted),
        recorded_bytes=sum(f.size for f in entry.source_file_infos()),
        lineage=entry.has_lineage_column())


@dataclasses.dataclass(frozen=True)
class CompactionStats:
    """Small-file shape of one index's current content tree."""

    index: str
    total_files: int
    small_files: int         # below the optimize size threshold
    mergeable_files: int     # small files sharing a bucket with another
    mergeable_buckets: int   # buckets holding >1 small file

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def compaction_stats(entry, size_threshold: int) -> CompactionStats:
    """Count the files a quick ``optimizeIndex`` would merge — the same
    candidate math as ``OptimizeAction._candidates`` (files below the
    threshold, grouped by the bucket id recovered from the file name,
    buckets with a single candidate skipped) without reading any
    Parquet footers."""
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    infos = entry.content.file_infos() if entry.is_covering else []
    by_bucket = defaultdict(int)
    small = 0
    for f in infos:
        bucket = bucket_id_of_file(f.name)
        if bucket is None or f.size >= size_threshold:
            continue
        small += 1
        by_bucket[bucket] += 1
    mergeable = {b: n for b, n in by_bucket.items() if n > 1}
    return CompactionStats(
        index=entry.name,
        total_files=len(infos),
        small_files=small,
        mergeable_files=sum(mergeable.values()),
        mergeable_buckets=len(mergeable))


def decide_compaction(stats: CompactionStats, *, min_small_files: int,
                      mode: str = "quick"
                      ) -> Optional[MaintenanceDecision]:
    """The compaction rung of the policy ladder: schedule an optimize
    when the index carries at least ``min_small_files`` mergeable
    small files.  Returns None (not a KIND_NONE decision) when below
    threshold — compaction only ever ADDS a decision for an index the
    refresh ladder left idle, it never masks a refresh."""
    if min_small_files <= 0 or stats.mergeable_files < min_small_files:
        return None
    return MaintenanceDecision(
        KIND_OPTIMIZE, stats.index, mode=mode,
        reason=f"{stats.mergeable_files} small index file(s) across "
               f"{stats.mergeable_buckets} bucket(s) >= "
               f"{min_small_files}: compacting ({mode})")
