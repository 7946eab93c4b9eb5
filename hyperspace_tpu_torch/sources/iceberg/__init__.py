"""The Iceberg source: the metadata reader, the writer and the provider
(counterpart of hyperspace_tpu/sources/iceberg/)."""

from hyperspace_tpu_torch.sources.iceberg.metadata import IcebergTable
from hyperspace_tpu_torch.sources.iceberg.provider import (
    IcebergRelation,
    IcebergSource,
)
from hyperspace_tpu_torch.sources.iceberg.writer import (
    delete_file_iceberg,
    write_iceberg,
)

__all__ = ["IcebergTable", "IcebergRelation", "IcebergSource",
           "write_iceberg", "delete_file_iceberg"]
