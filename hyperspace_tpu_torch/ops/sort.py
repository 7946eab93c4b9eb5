"""Bucket/sort permutation and per-bucket row counts of the index build.

Counterpart of hyperspace_tpu/ops/sort.py.  PyTorch runs eagerly, so the
JAX package's capacity padding (one compiled program per capacity) has
no counterpart here: padding only parked pad rows after the real ones,
so ``perm[:n]`` is the same without it.

The fused hash and sort is a timeline seam (``exec.kernel.bucket_sort``)
and so is the histogram (``exec.kernel.bucket_histogram``): with the
timeline on, each is bracketed by a CUDA-event pair
(telemetry/timeline.py); off, a seam is one bool check.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.ops.hash import route_partition_np, route_sort
from hyperspace_tpu_torch.ops.kernels import bucket_histogram
from hyperspace_tpu_torch.telemetry import timeline


def bucket_sort_permutation(
    word_cols: Sequence[torch.Tensor],
    order_words: Sequence[torch.Tensor],
    num_buckets: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused hash + sort of the build.

    Args:
      word_cols: per key column (n, 2) uint32 hash words.
      order_words: per key column (n, 2) uint32 monotone order words.
      num_buckets: bucket count.

    Returns:
      (bucket_ids int32 (n,), perm int64 (n,)) on the inputs' device,
      where perm orders rows by (bucket, *key columns).
    """
    t0 = timeline.kernel_begin(word_cols[0].device if word_cols else None)
    out = route_sort(word_cols, order_words, num_buckets)
    timeline.kernel_end("bucket_sort", t0, out)
    return out


def bucket_sort_permutation_np(
    word_cols: Sequence[np.ndarray],
    order_words: Sequence[np.ndarray],
    num_buckets: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bit-identical host mirror of ``bucket_sort_permutation``, which the
    build takes below ``device_min_rows("build")``: the same bucket ids
    (``bucket_ids_np``) and a stable lexsort over the same (bucket,
    order-word) keys; it is the spill route's mirror
    ``ops.hash.route_partition_np``."""
    return route_partition_np(word_cols, order_words, num_buckets)


def bucket_counts(buckets: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Rows per bucket as (num_buckets,) int32 — the CUDA histogram kernel
    on the card, its plain version on the CPU."""
    t0 = timeline.kernel_begin(buckets.device)
    out = bucket_histogram(buckets, num_buckets)
    timeline.kernel_end("bucket_histogram", t0, out)
    return out
