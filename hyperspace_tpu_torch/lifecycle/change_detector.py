"""Source change detection (counterpart of
hyperspace_tpu/lifecycle/change_detector.py): one source listing and set
arithmetic per index, no data read.

``diff_file_sets`` is the refresh actions' diff, free of any action, and
``recorded_scan`` their scan of the recorded source.  ``detect_changes``
applies both to an index entry: the source is listed again from the
entry's recorded relation and diffed against
the entry's effective recorded set, its content files plus a quick
refresh's pending appends minus its pending deletes, so files a quick
refresh already accounted for do not read as new forever.  The pending
lists are carried as debt (``hybrid_debt_bytes``, ``merge_debt_bytes``)
for the policy to weigh.

Each pass is a ``lifecycle.detect`` span tagged with its counts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from hyperspace_tpu_torch.index.log_entry import FileInfo, IndexLogEntry
from hyperspace_tpu_torch.plan.nodes import Scan, ScanRelation
from hyperspace_tpu_torch.telemetry.trace import span


def diff_file_sets(current: List[FileInfo], recorded: List[FileInfo],
                   ) -> Tuple[List[FileInfo], List[FileInfo], List[str]]:
    """``(appended, deleted, mutated_names)``.  ``appended``/``deleted``
    are keyed by the ``(name, size, mtime)`` triple, so a file rewritten
    in place is in both; ``mutated_names`` are the names in both sets
    whose size or mtime changed."""
    recorded_triples = {(f.name, f.size, f.mtime) for f in recorded}
    current_triples = {(f.name, f.size, f.mtime) for f in current}
    appended = [f for f in current
                if (f.name, f.size, f.mtime) not in recorded_triples]
    deleted = [f for f in recorded
               if (f.name, f.size, f.mtime) not in current_triples]
    current_names = {f.name for f in current}
    recorded_names = {f.name for f in recorded}
    mutated = sorted({f.name for f in appended if f.name in recorded_names}
                     | {f.name for f in deleted if f.name in current_names})
    return appended, deleted, mutated


@dataclasses.dataclass(frozen=True)
class ChangeSummary:
    """What one detection pass saw for one ACTIVE index: counts only."""

    index: str
    appended: int            # files present now, absent from the record
    deleted: int             # files recorded, gone (or replaced) now
    mutated: int             # names in both with drifted size/mtime
    appended_bytes: int      # bytes of the appended files
    recorded_files: int      # size of the effective recorded set
    recorded_bytes: int
    hybrid_debt_bytes: int = 0  # quick-refresh appends awaiting indexing
    newest_change_ms: int = 0   # max mtime over appended files (epoch ms)
    deleted_bytes: int = 0      # bytes of the newly deleted files
    merge_debt_bytes: int = 0   # pending delete-overlay bytes (CDC debt)

    @property
    def changed(self) -> bool:
        return (self.appended + self.deleted + self.mutated) > 0

    @property
    def churn_ratio(self) -> float:
        """Changed-file share of the recorded set (a mutation counts
        once, not as an append and a delete)."""
        mutated = self.mutated
        return (max(0, self.appended - mutated)
                + max(0, self.deleted - mutated)
                + mutated) / max(1, self.recorded_files)

    @property
    def append_ratio(self) -> float:
        """New plus pending appended bytes over recorded bytes: the
        hybrid-scan debt a quick refresh would leave."""
        return (self.appended_bytes + self.hybrid_debt_bytes) \
            / max(1, self.recorded_bytes)

    @property
    def merge_debt_ratio(self) -> float:
        """The merge-on-read debt a quick refresh would leave: new
        appends and deletes plus the pending overlay in both directions,
        over recorded bytes."""
        return (self.appended_bytes + self.hybrid_debt_bytes
                + self.deleted_bytes + self.merge_debt_bytes) \
            / max(1, self.recorded_bytes)

    def to_dict(self) -> dict:
        return {"index": self.index, "appended": self.appended,
                "deleted": self.deleted, "mutated": self.mutated,
                "appended_bytes": self.appended_bytes,
                "recorded_files": self.recorded_files,
                "recorded_bytes": self.recorded_bytes,
                "hybrid_debt_bytes": self.hybrid_debt_bytes,
                "deleted_bytes": self.deleted_bytes,
                "merge_debt_bytes": self.merge_debt_bytes}


def _mtime_epoch_ms(mtime) -> int:
    """``FileInfo.mtime`` in epoch milliseconds whatever its unit: epoch
    seconds are about 2e9, so anything past 1e11 is a finer unit."""
    m = float(mtime)
    while m > 1e11:
        m /= 1000.0
    return int(m * 1000.0)


def _effective_recorded(entry: IndexLogEntry) -> List[FileInfo]:
    """Content files plus pending quick-refresh appends minus pending
    deletes: the source state the entry already accounts for."""
    pending_deleted = {(f.name, f.size, f.mtime)
                       for f in entry.deleted_files()}
    out = [f for f in entry.source_file_infos()
           if (f.name, f.size, f.mtime) not in pending_deleted]
    out.extend(entry.appended_files())
    return out


def recorded_scan(session, rel) -> Scan:
    """The scan of a recorded source relation as it is now: its
    provider's ``refresh_relation_metadata`` drops the options that pin
    a snapshot (Delta's ``versionAsOf``), so the latest version is
    listed."""
    rel = session.source_provider_manager.refresh_relation_metadata(rel)
    return Scan(ScanRelation(root_paths=tuple(rel.root_paths),
                             file_format=rel.file_format,
                             options=tuple(sorted(rel.options.items()))))


def current_source_files(session, entry: IndexLogEntry) -> List[FileInfo]:
    """The index's source as it is now, listed from the recorded
    relation (stat-level only)."""
    if len(entry.relations) != 1:
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        raise HyperspaceError(
            "Change detection supports single-relation indexes")
    return session.source_provider_manager.get_relation(
        recorded_scan(session, entry.relations[0])).all_files()


def detect_changes(session, entry: IndexLogEntry) -> ChangeSummary:
    """One detection pass for one ACTIVE entry: list the source, diff it
    against the effective recorded set, count (a ``lifecycle.detect``
    span)."""
    with span("lifecycle.detect", index=entry.name) as sp:
        current = current_source_files(session, entry)
        recorded = _effective_recorded(entry)
        appended, deleted, mutated = diff_file_sets(current, recorded)
        summary = ChangeSummary(
            index=entry.name,
            appended=len(appended),
            deleted=len(deleted),
            mutated=len(mutated),
            appended_bytes=sum(f.size for f in appended),
            recorded_files=len(recorded),
            recorded_bytes=sum(f.size for f in recorded),
            hybrid_debt_bytes=sum(f.size for f in entry.appended_files()),
            newest_change_ms=max((_mtime_epoch_ms(f.mtime)
                                  for f in appended), default=0),
            deleted_bytes=sum(f.size for f in deleted),
            merge_debt_bytes=sum(f.size for f in entry.deleted_files()),
        )
        sp.set(appended=summary.appended, deleted=summary.deleted,
               mutated=summary.mutated)
        return summary
