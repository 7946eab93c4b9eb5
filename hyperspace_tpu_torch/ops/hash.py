"""Bucket hash and the fused hash + stable-lexsort route of the build.

Counterpart of hyperspace_tpu/ops/hash.py.  Every key column arrives as
an (n, 2) uint32 "hash words" tensor (``io.columnar.to_hash_words``), so
one kernel serves any key schema.  The hash itself is the CUDA kernel
``ops.kernels.hash_buckets``; the stable lexsort by (bucket, key words)
stays a library sort (``torch.sort(stable=True)``), as it was an XLA
program outside any Pallas kernel in the JAX package.

``route_partition`` is the spill build's per-chunk pass: the same
hash and sorts, and the histogram kernel's counts as the run cuts;
``route_partition_mesh`` is the same pass over the logical shards of a
mesh (``parallel/sharded_build.py``).

``bucket_ids`` and ``route_partition`` are timeline seams
(telemetry/timeline.py): with the timeline on, each is bracketed by a
CUDA-event pair and attributed as ``exec.kernel.bucket_ids`` /
``exec.kernel.route_partition``; off, a seam is one bool check.

The numpy host mirrors ``bucket_ids_np`` / ``route_partition_np`` are
copies of the JAX package's: bucket pruning hashes filter literals with
``bucket_ids_np``, and ``route_partition_np`` is the oracle the tests
hold the device path to; no build path calls them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.ops.kernels import bucket_histogram, hash_buckets
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.telemetry import timeline

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_SEED = np.uint32(0x3C074A61)


def combine_hashes(word_cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row hash from per-column (n, 2) uint32 hash words, as (n,) int32
    holding the uint32 bits."""
    return hash_buckets(word_cols, 0)


def bucket_ids(word_cols: Sequence[torch.Tensor], num_buckets: int) -> torch.Tensor:
    """Per-row bucket assignment in [0, num_buckets) as int32."""
    t0 = timeline.kernel_begin(word_cols[0].device if word_cols else None)
    out = _bucket_ids(word_cols, num_buckets)
    timeline.kernel_end("bucket_ids", t0, out)
    return out


def _bucket_ids(word_cols: Sequence[torch.Tensor],
                num_buckets: int) -> torch.Tensor:
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    return hash_buckets(word_cols, num_buckets)


def order_key64(words: torch.Tensor) -> torch.Tensor:
    """(n, 2) uint32 (hi, lo) order words -> (n,) int64 whose signed order
    equals the unsigned 64-bit order of ``(hi << 32) | lo``: the value is
    ``((hi ^ 0x80000000) << 32) | lo`` read as int64, computed without
    overflow as ``(hi - 2**31) * 2**32 + lo``."""
    w = words.to(torch.int64)
    return (w[:, 0] - (1 << 31)) * (1 << 32) + w[:, 1]


def route_sort(word_cols: Sequence[torch.Tensor],
               order_words: Sequence[torch.Tensor],
               num_buckets: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash -> stable lexsort by (bucket, *key columns) -> (buckets, perm).

    Counterpart of ``_route_sort_impl``: ``buckets`` is (n,) int32 in row
    order, ``perm`` (n,) int64 orders the rows by bucket, then by each key
    column's order words in config order.  An LSD pass per key, least
    significant first, each a stable argsort of that key gathered through
    the current permutation; the bucket pass comes last.  Empty
    ``order_words`` groups rows by bucket with their original order kept.
    Every sort is stable: tie order is part of the index bytes."""
    buckets = _bucket_ids(word_cols, num_buckets)
    n = buckets.shape[0]
    order_words = list(order_words)
    for w in order_words:
        if w.shape != (n, 2) or w.device != buckets.device:
            raise ValueError(
                f"order words must be ({n}, 2) on {buckets.device}; got "
                f"{tuple(w.shape)} on {w.device}")
    perm = torch.arange(n, dtype=torch.int64, device=buckets.device)
    for w in reversed(order_words):
        key = order_key64(w)[perm]
        perm = perm[torch.sort(key, stable=True).indices]
    key = buckets[perm]
    perm = perm[torch.sort(key, stable=True).indices]
    return buckets, perm


def route_partition(word_cols: Sequence[np.ndarray],
                    order_words: Sequence[np.ndarray], num_buckets: int,
                    device) -> Tuple[np.ndarray, np.ndarray]:
    """Route + partition of one spill chunk on ``device``: the chunk's
    key words go up, ``route_sort`` (the hash kernel, then the stable
    sorts) orders its rows by (bucket, *key words), the histogram kernel
    counts the rows of each bucket, and both come back to the host.

    Counterpart of the JAX package's ``route_partition``, which brings
    the bucket ids back and cuts the runs on the host; here the counts
    are the cuts: bucket ``b``'s run in ``perm`` starts at the sum of the
    counts before it.  Empty ``order_words`` (rank-mapped keys) keeps
    the chunk's row order within each bucket.

    Returns ``(perm, counts)``: (n,) int64 and (num_buckets,) int64."""
    device = torch.device(device)
    words = [torch.from_numpy(np.ascontiguousarray(w)).to(device)
             for w in word_cols]
    order = [torch.from_numpy(np.ascontiguousarray(w)).to(device)
             for w in order_words]
    t0 = timeline.kernel_begin(device)
    if t0 is not None:
        timeline.record_transfer("h2d", sum(w.nbytes for w in words + order))
    buckets, perm = route_sort(words, order, num_buckets)
    counts = bucket_histogram(buckets, num_buckets)
    timeline.kernel_end("route_partition", t0, perm)
    return (sync_guard.pull(perm, "route_partition.perm"),
            sync_guard.pull(counts, "route_partition.counts")
            .astype(np.int64))


def route_partition_mesh(word_cols: Sequence[np.ndarray],
                         order_words: Sequence[np.ndarray], num_buckets: int,
                         mesh) -> Tuple[np.ndarray, np.ndarray]:
    """``route_partition`` over the logical shards of ``mesh``: the same
    ``(perm, counts)``, bit for bit, with each shard owning the buckets
    ``b % n`` and one attributed read-back per shard
    (``parallel/sharded_build.py``)."""
    from hyperspace_tpu_torch.parallel.sharded_build import (
        mesh_route_partition,
    )

    return mesh_route_partition(word_cols, order_words, num_buckets, mesh)


# ---------------------------------------------------------------------------
# numpy host mirrors (copies of hyperspace_tpu/ops/hash.py's)
# ---------------------------------------------------------------------------
def _fmix32_np(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * _C1
    h = h ^ (h >> np.uint32(13))
    h = h * _C2
    h = h ^ (h >> np.uint32(16))
    return h


def bucket_ids_np(word_cols: Sequence[np.ndarray], num_buckets: int) -> np.ndarray:
    """Host mirror of ``bucket_ids`` — bit-identical uint32 math in numpy
    (wrap-around multiplication is exact in both)."""
    with np.errstate(over="ignore"):
        h = np.full(np.asarray(word_cols[0]).shape[0], _SEED, dtype=np.uint32)
        for words in word_cols:
            words = np.asarray(words, dtype=np.uint32)
            h = _fmix32_np(h * np.uint32(31) ^ _fmix32_np(words[:, 0]))
            h = _fmix32_np(h * np.uint32(31) ^ _fmix32_np(words[:, 1]))
    return (h % np.uint32(num_buckets)).astype(np.int32)


def route_partition_np(
    word_cols: Sequence[np.ndarray],
    order_words: Sequence[np.ndarray],
    num_buckets: int,
):
    """Bit-identical host mirror of :func:`route_sort`: ``bucket_ids_np``
    and a stable ``np.lexsort`` over the same (bucket, order-word) keys.
    ``order_words`` items may be (n, 2) uint32 word pairs or (n,) uint64
    codes."""
    with np.errstate(over="ignore"):
        buckets = bucket_ids_np([np.asarray(w) for w in word_cols],
                                num_buckets)
    keys = []
    for w in reversed(list(order_words)):
        w = np.asarray(w)
        keys.append(w if w.ndim == 1
                    else (w[:, 0].astype(np.uint64) << np.uint64(32))
                    | w[:, 1].astype(np.uint64))
    keys.append(buckets)
    perm = np.lexsort(tuple(keys)).astype(np.int32)
    return buckets.astype(np.int32), perm
