"""The Delta Lake source: the ``_delta_log`` reader, the writer and the
provider (counterpart of hyperspace_tpu/sources/delta/)."""

from hyperspace_tpu_torch.sources.delta.log import DeltaLog
from hyperspace_tpu_torch.sources.delta.provider import (
    DeltaLakeRelation,
    DeltaLakeSource,
)
from hyperspace_tpu_torch.sources.delta.writer import write_delta

__all__ = ["DeltaLog", "DeltaLakeRelation", "DeltaLakeSource", "write_delta"]
