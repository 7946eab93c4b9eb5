"""Session configuration of the build (counterpart of
hyperspace_tpu/config.py, holding the fields the build reads; defaults
are the JAX package's)."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from hyperspace_tpu_torch.io.parquet import INDEX_COMPRESSION_DEFAULT


@dataclasses.dataclass
class HyperspaceConf:
    system_path: Optional[str] = None
    num_buckets: int = 200
    # Split each bucket's sorted run into files of at most this many rows
    # (0 = one file per bucket).
    index_max_rows_per_file: int = 0
    signature_provider: str = "IndexSignatureProvider"
    # The most rows one build holds on the device at once; env
    # HS_DEVICE_BATCH_ROWS overrides the default.
    device_batch_rows: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HS_DEVICE_BATCH_ROWS", 1 << 20)))
    # Parquet codec for index data files ("none" = uncompressed).
    index_file_compression: str = INDEX_COMPRESSION_DEFAULT
