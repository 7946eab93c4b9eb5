"""The index advisor: capture -> what-if -> recommend -> build
(counterpart of hyperspace_tpu/advisor/).

  - ``workload``: opt-in capture of a bounded, deduplicated log of query
    fingerprints (columns and measured bytes, never values), persisted
    through the LogStore seam;
  - ``hypothetical``: ACTIVE-looking entries with no data file, planned
    against (``session.optimize(hypothetical=[...])``,
    ``ds.explain(whatif=[...])``) but never executed or written;
  - ``candidates`` and ``recommend``: candidate covering indexes from the
    workload, ranked by estimated benefit minus build cost
    (``Hyperspace.recommend_indexes``, ``apply_recommendations``).

No module here imports pyarrow when it loads.
"""

from hyperspace_tpu_torch.advisor.hypothetical import (
    WhatIfReport,
    hypothetical_entry,
    whatif,
)
from hyperspace_tpu_torch.advisor.recommend import (
    apply_recommendations,
    recommend_indexes,
)
from hyperspace_tpu_torch.advisor.workload import capture, workload_table

__all__ = [
    "WhatIfReport",
    "hypothetical_entry",
    "whatif",
    "recommend_indexes",
    "apply_recommendations",
    "capture",
    "workload_table",
]
