"""The monolithic covering-index build over the mesh (counterpart of
hyperspace_tpu/parallel/build.py).

On one device the build is ``ops.sort.bucket_sort_permutation``.  Over a
mesh it becomes: rows split over the shards -> hash -> the bucket
shuffle -> per-shard lexsort (``parallel/shuffle.py``), the scan,
hash-shuffle and per-task sort of a cluster build.  The host contract is
the single device's: a ``(bucket_ids, perm)`` pair for
``io.parquet.write_bucketed``, so the action does not depend on how many
shards did the work.  pyarrow is imported by the caller only.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.parallel.mesh import Mesh
from hyperspace_tpu_torch.parallel.shuffle import bucket_shuffle


def distributed_bucket_sort_permutation(
    table, indexed_columns: Sequence[str], num_buckets: int, mesh: Mesh,
) -> Tuple[np.ndarray, np.ndarray]:
    """(bucket_ids, perm) of the arrow ``table`` computed over ``mesh``:
    ``perm`` (int64) orders the rows by (bucket, indexed columns) with
    row order in ties, and ``bucket_ids`` (int32) are the per-row
    buckets in row order, ``bucket_sort_permutation``'s contract.

    Z-order builds never come here: a hash shuffle would cut the curve
    into per-shard samples (``actions/create._write_table_bucketed``)."""
    hash_words = [columnar.to_hash_words(table.column(c))
                  for c in indexed_columns]
    order_words = [columnar.to_order_words(table.column(c))
                   for c in indexed_columns]
    result, _ = bucket_shuffle(hash_words, order_words, num_buckets, mesh)
    bucket_ids = np.empty(table.num_rows, dtype=np.int32)
    bucket_ids[result.perm] = result.buckets_sorted
    return bucket_ids, result.perm
