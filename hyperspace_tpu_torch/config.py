"""Session configuration (counterpart of hyperspace_tpu/config.py,
holding the fields the build, the refresh and optimize verbs, the query
path and the device column cache read; defaults are the JAX package's
but for the routing thresholds).

The JAX package derives ``device_min_rows`` and ``resident_min_rows``
from a calibration of the attachment, falling back to 2**26 cold and
2**22-2**24 resident rows; calibration (``utils/calibrate.py``) is not
ported yet and will replace these defaults, so the port's thresholds,
the resident one included, default to 0: every filter, join and grouped
aggregate takes the device path, as the port's build does.  A threshold
set above a batch's rows sends that batch to the host route (arrow
predicate, numpy join, arrow group-by), as in the JAX package; once the
batch's columns are resident in the device column cache, the resident
threshold governs instead, so a host route needs both raised."""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

from hyperspace_tpu_torch.io.parquet import INDEX_COMPRESSION_DEFAULT


@dataclasses.dataclass
class HyperspaceConf:
    system_path: Optional[str] = None
    num_buckets: int = 200
    # Stamp each index row with its source file's id (``_data_file_id``):
    # what incremental refresh with deletes and hybrid scan over deleted
    # files need.
    lineage_enabled: bool = False
    # Hybrid scan: a stale index answers with its deleted files' rows
    # filtered out and the appended files read beside it, while the
    # appended (deleted) bytes stay within these shares of the current
    # (indexed) bytes.
    hybrid_scan_enabled: bool = False
    hybrid_scan_max_appended_ratio: float = 0.3
    hybrid_scan_max_deleted_ratio: float = 0.2
    # Quick optimize compacts only index files smaller than this.
    optimize_file_size_threshold: int = 256 * 1024 * 1024
    # Split each bucket's sorted run into files of at most this many rows
    # (0 = one file per bucket).
    index_max_rows_per_file: int = 0
    signature_provider: str = "IndexSignatureProvider"
    # The most rows one build holds on the device at once; env
    # HS_DEVICE_BATCH_ROWS overrides the default.
    device_batch_rows: int = dataclasses.field(
        default_factory=lambda: int(
            os.environ.get("HS_DEVICE_BATCH_ROWS", 1 << 20)))
    # The spill build's pipeline: off runs the forced-serial reference
    # (inline reads, inline routing, sequential finalize), the same bytes.
    build_pipeline_enabled: bool = True
    # Source files decoded ahead of the route (the prefetch backpressure).
    build_prefetch_depth: int = 2
    # Threads that merge and write the closed bucket groups.
    build_finalize_workers: int = 4
    # Parquet codec for index data files ("none" = uncompressed).
    index_file_compression: str = INDEX_COMPRESSION_DEFAULT
    # Filter rule: carry the bucket spec on index scans even when the
    # predicate prunes no bucket.
    filter_rule_use_bucket_spec: bool = False
    # Rows from which a filter / a join / a grouped aggregate runs on the
    # session's device.
    device_filter_min_rows: int = 0
    device_join_min_rows: int = 0
    device_agg_min_rows: int = 0
    # The device column cache (execution/device_cache.py): byte budget
    # for the post-decode columns kept on the device across queries,
    # keyed by file identity; 0 disables it.
    device_cache_bytes: int = 1 << 30
    # "auto": cache when the device path runs anyway; "eager": take the
    # device on first use for scans whose columns can be cached (pay the
    # upload once, serve repeats from card memory); "off": never cache.
    device_cache_policy: str = "auto"
    # Rows from which an operation whose inputs are already resident (or
    # will be, under "eager") runs on the device; every kind.
    device_resident_min_rows: int = 0

    def device_min_rows(self, kind: str) -> int:
        """The host-versus-device threshold of ``kind`` ("filter", "join",
        "agg" or "join_agg").  The fused join→aggregate has no field of
        its own: the join's threshold governs it, since it is the join's
        device decision with the aggregation behind it."""
        field = "join" if kind == "join_agg" else kind
        return int(getattr(self, f"device_{field}_min_rows"))

    def resident_min_rows(self, kind: str) -> int:
        """The threshold of ``kind`` when its inputs are already on the
        device (only the round trip is left to repay); one value for
        every kind until calibration derives them."""
        return int(self.device_resident_min_rows)
