"""The autonomous index lifecycle (counterpart of hyperspace_tpu/lifecycle/):

  - ``change_detector``: source listing and set arithmetic, no data read
  - ``policy``: a change summary and the index's state in, a decision out
  - ``cdc``: merge-on-read debt and the compaction rung
  - ``daemon``: executes decisions through the collection manager, backs
    off from index-side failures, sheds on drain and memory pressure
  - ``journal``: every decision, durable under
    ``<systemPath>/_hyperspace_lifecycle``
  - ``lease``: one maintaining process per system path

with the source watch in ``io/watch.py`` waking the daemon on change.
"""

from hyperspace_tpu_torch.lifecycle.cdc import (
    CompactionStats,
    MergeDebt,
    compaction_stats,
    decide_compaction,
    merge_debt,
)
from hyperspace_tpu_torch.lifecycle.change_detector import (
    ChangeSummary,
    detect_changes,
    diff_file_sets,
)
from hyperspace_tpu_torch.lifecycle.daemon import MaintenanceDaemon
from hyperspace_tpu_torch.lifecycle.policy import MaintenanceDecision

__all__ = [
    "ChangeSummary",
    "CompactionStats",
    "MaintenanceDaemon",
    "MaintenanceDecision",
    "MergeDebt",
    "compaction_stats",
    "decide_compaction",
    "detect_changes",
    "diff_file_sets",
    "merge_debt",
]
