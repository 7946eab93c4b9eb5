"""hyperspace_tpu_torch: hyperspace_tpu ported to PyTorch and CUDA.

Covering indexes (bucket-hashed, sorted, column-pruned copies of a
Parquet source) built on one NVIDIA GPU: the bucket hash and the bucket
histogram are CUDA kernels (``ops/kernels.py``, ``csrc/``), the stable
lexsort is ``torch.sort``.  Filter, join and aggregate queries are
rewritten to read the indexes (``session.enable_hyperspace()``) and run
on the same device: the predicate as torch ops over the index columns,
the join bucket by bucket with a sorted equi-join in each bucket, a
GROUP BY as a sort and segment reductions, and the TPC-H Q3/Q10 shape
(``filter ⋈ index``, ``group_by``, ``agg``, ``sort`` by the aggregate,
``limit``) as one fused join→aggregate whose joined rows stay on the
device.  A repeat query over the same index files takes their columns
from card memory (``execution/device_cache.py``) instead of converting
and uploading them again.  Which route each operation takes is calibrated
for the session's device (``utils/calibrate.py``); every action publishes
a build report (``telemetry/build_report.py``); per-file sketches prune
the files a scan reads (``DataSkippingIndexConfig``, and each covering
build's ``_sketch.parquet``).  Queries can be SQL text
(``hyperspace_tpu_torch.sql.sql``); ``Hyperspace.explain`` shows a
query's plans with and without the indexes, ``Dataset.last_run_report``
what the last collect decided and read, and ``Hyperspace.indexes`` and
``index`` the index statistics.  The failure envelope injects faults at
the IO and op-log seams (``io/faults.py``), retries transient IO errors,
recovers a crashed action and answers from the source when an index
cannot be read; the advisor (``advisor/``) captures the workload and
recommends, plans against (what-if) and builds indexes for it.  The
lifecycle (``lifecycle/``) maintains the indexes unattended: it detects
source changes (pushed by ``io/watch.py``), picks the cheapest refresh,
repair, compaction or advisor build, runs it and journals every
decision.  Strict mode (``execution/sync_guard.py``) makes every
device→host read-back go through attributed seams; queries take
deadlines (``utils/deadline.py``) and a plan cache
(``execution/plan_cache.py``); the flight recorder, the SLO math and the
doctor (``telemetry/``) explain them after the fact, and a JSON spec
becomes a query (``interop/``).  The JAX package ``hyperspace_tpu`` is
the reference; this package imports nothing of it, and no ``jax``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from hyperspace_tpu_torch.actions.optimize import OptimizeSummary
from hyperspace_tpu_torch.actions.refresh import RefreshSummary
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.dataset import Dataset
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.hyperspace import Hyperspace
from hyperspace_tpu_torch.index.index_config import (
    DataSkippingIndexConfig,
    IndexConfig,
)
from hyperspace_tpu_torch.plan.expr import (
    col,
    concat,
    dayofmonth,
    exists,
    in_subquery,
    length,
    lit,
    lower,
    month,
    outer_ref,
    quarter,
    scalar,
    substring,
    trim,
    upper,
    when,
    year,
)
from hyperspace_tpu_torch.session import HyperspaceSession

__all__ = [
    "Hyperspace",
    "HyperspaceSession",
    "HyperspaceConf",
    "HyperspaceError",
    "IndexConfig",
    "DataSkippingIndexConfig",
    "Dataset",
    "RefreshSummary",
    "OptimizeSummary",
    "col",
    "lit",
    "when",
    "year",
    "month",
    "dayofmonth",
    "quarter",
    "scalar",
    "in_subquery",
    "exists",
    "outer_ref",
    "upper",
    "lower",
    "length",
    "trim",
    "substring",
    "concat",
]
