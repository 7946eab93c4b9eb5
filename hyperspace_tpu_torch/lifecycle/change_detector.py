"""Source change detection (counterpart of
hyperspace_tpu/lifecycle/change_detector.py, its diff only): the refresh
actions' file-set diff, free of any action."""

from __future__ import annotations

from typing import List, Tuple

from hyperspace_tpu_torch.index.log_entry import FileInfo


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
