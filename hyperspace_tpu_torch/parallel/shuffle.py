"""The bucket shuffle over the mesh (counterpart of
hyperspace_tpu/parallel/shuffle.py).

The cluster-wide hash shuffle of the build (``repartition(numBuckets,
indexedCols)``) over the logical shards of ``parallel/mesh.py``.  Every
shard, on its own device:

  1. hashes its rows to buckets with the build's hash kernel
     (``ops.kernels.hash_buckets``: one launch per shard on the card, its
     plain version on the CPU) and maps each bucket to its owning shard:
     RANGE-partitioned here (``dest = bucket // ceil(num_buckets / n)``),
     so each shard emits a contiguous, sorted run of buckets;
  2. packs its rows as records ``[bucket, row id, order keys...,
     payload...]`` and orders them by destination (``scatter_to_buffer``,
     a stable sort, so each destination's rows keep row order);
  3. exchanges: receiver ``d`` gets the concatenation, in source order,
     of each source's slice for ``d`` -- the index-op form of
     ``lax.all_to_all(..., tiled=True)``;
  4. lexsorts what it received by (bucket, order keys, global row id)
     (``sort_received``), after which every shard holds its buckets'
     rows sorted, ready for the writer.

PyTorch runs eagerly at exact sizes, so the exchange moves the exact
per-(source, destination) row counts (one read-back of the count matrix
sizes the slices): there is no padded send buffer and no overflow retry,
and ``ShuffleResult.capacity`` reports the largest per-(source,
destination) count.  ``perm``, ``buckets_sorted`` and
``device_row_counts`` are the JAX package's, since the global row id
decides every tie.  The records are int64: the uint32 words of the JAX
package's records become one int64 order key per key column
(``ops.hash.order_key64``, whose signed order is the words' unsigned
order) and int64-held payload words, since torch on the CPU lacks
uint32 comparisons and sorts.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.ops.hash import order_key64
from hyperspace_tpu_torch.ops.kernels import hash_buckets
from hyperspace_tpu_torch.parallel.mesh import (
    Mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
    shard_bounds,
)

# Record columns before the order keys.
_BUCKET, _ROW, _KEYS = 0, 1, 2


class ShuffleResult(NamedTuple):
    """Host view of a finished shuffle.

    ``perm`` lists original row indices in (bucket, key) order and
    ``buckets_sorted[i]`` is the bucket of row ``perm[i]``, the contract
    of the single-device ``bucket_sort_permutation``.
    ``device_row_counts[d]`` is how many of those rows shard ``d`` holds
    (its slice of ``perm``, in shard order).  ``capacity`` is the largest
    per-(source, destination) row count the exchange moved."""

    perm: np.ndarray
    buckets_sorted: np.ndarray
    device_row_counts: np.ndarray
    capacity: int


def scatter_to_buffer(record: torch.Tensor, dest: torch.Tensor,
                      n_dest: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(send, counts): ``record``'s rows ordered by destination, each
    destination's rows in their own order (a stable sort), and the rows
    per destination, (n_dest,) int64 (a scatter-add: ``torch.bincount``
    would read its maximum back to the host)."""
    order = torch.sort(dest, stable=True).indices
    counts = torch.zeros(n_dest, dtype=torch.int64, device=dest.device)
    return record[order], counts.scatter_add_(0, dest, torch.ones_like(dest))


def make_row_records(bucket: torch.Tensor, row_ids: torch.Tensor,
                     order_keys: Sequence[torch.Tensor],
                     payload: Optional[torch.Tensor]) -> torch.Tensor:
    """The routed row record, (L, 2 + K + E) int64:
    ``[bucket, global row id, order keys..., payload words...]``."""
    cols = [bucket.to(torch.int64)[:, None], row_ids[:, None]]
    cols += [k[:, None] for k in order_keys]
    if payload is not None:
        cols.append(payload.to(torch.int64))
    return torch.cat(cols, dim=1)


def sort_received(recv: torch.Tensor, n_key_cols: int) -> torch.Tensor:
    """One shard's final order: (bucket, order keys in config order),
    with the GLOBAL ROW ID as the last tiebreak, so that equal keys come
    out in original row order whatever the arrival order (the single
    device's stable sort).  An LSD lexsort: a stable sort per key, least
    significant first."""
    perm = torch.sort(recv[:, _ROW], stable=True).indices
    for k in reversed(range(_KEYS, _KEYS + n_key_cols)):
        perm = perm[torch.sort(recv[perm, k], stable=True).indices]
    perm = perm[torch.sort(recv[perm, _BUCKET], stable=True).indices]
    return recv[perm]


def marshal_shuffle_inputs(hash_words: Sequence[np.ndarray],
                           order_words: Sequence[np.ndarray],
                           payload_words: Optional[np.ndarray], mesh: Mesh,
                           site: str = "shuffle"):
    """The inputs placed on the mesh by the rule-driven shard fns: per
    shard, its key columns' (L, 2) uint32 hash words, its (L, 2) uint32
    order words, its (L, E) payload words (None without a payload) and
    its global row ids; and the gather fns of the outputs."""
    specs = match_partition_rules(("hash_words", "order_words", "payload",
                                   "counts"))
    shard_fns, gather_fns = make_shard_and_gather_fns(mesh, specs, site)
    n = int(hash_words[0].shape[0])
    hw = [shard_fns["hash_words"](np.asarray(w, np.uint32))
          for w in hash_words]
    ow = [shard_fns["order_words"](np.asarray(w, np.uint32))
          for w in order_words]
    pl = shard_fns["payload"](np.asarray(payload_words, np.uint32)) \
        if payload_words is not None else None
    shards = []
    for d, ((lo, hi), dev) in enumerate(zip(shard_bounds(n, mesh.size),
                                            mesh.devices)):
        shards.append(([w[d] for w in hw], [w[d] for w in ow],
                       None if pl is None else pl[d],
                       torch.arange(lo, hi, dtype=torch.int64, device=dev)))
    return shards, gather_fns


def route_to_owners(shards, num_buckets: int, mesh: Mesh, owner,
                    gather_counts) -> Tuple[List[torch.Tensor], np.ndarray]:
    """The shuffle's body, one shard after another: hash (one kernel
    launch per non-empty shard on the card), records, scatter by
    ``owner(bucket)``, the exchange, and ``sort_received``.  Returns each
    shard's received records in their final order and the (source,
    destination) row counts, read back once (``gather_counts``) to size
    the exchange."""
    sends, counts = [], []
    n_keys = 0
    for hw, ow, pl, rows in shards:
        bucket = hash_buckets(hw, num_buckets)
        keys = [order_key64(w) for w in ow]
        n_keys = len(keys)
        record = make_row_records(bucket, rows, keys, pl)
        send, c = scatter_to_buffer(record, owner(bucket.to(torch.int64)),
                                    mesh.size)
        sends.append(send)
        counts.append(c)
    matrix = gather_counts(counts).reshape(mesh.size, mesh.size)
    offsets = np.zeros_like(matrix)
    np.cumsum(matrix[:, :-1], axis=1, out=offsets[:, 1:])
    recvs = []
    for e, dev in enumerate(mesh.devices):
        recv = torch.cat([
            sends[s][int(offsets[s, e]):int(offsets[s, e] + matrix[s, e])]
            .to(dev) for s in range(mesh.size)])
        recvs.append(sort_received(recv, n_keys))
    return recvs, matrix


def bucket_shuffle(hash_words: Sequence[np.ndarray],
                   order_words: Sequence[np.ndarray], num_buckets: int,
                   mesh: Mesh, payload_words: Optional[np.ndarray] = None
                   ) -> Tuple[ShuffleResult, Optional[np.ndarray]]:
    """The shuffle of ``n`` global rows over ``mesh``.

    Args:
      hash_words: per key column, (n, 2) uint32 (``to_hash_words``).
      order_words: per key column, (n, 2) uint32 (``to_order_words``).
      num_buckets: bucket count, range-partitioned over the shards.
      mesh: a ``parallel.mesh.Mesh``.
      payload_words: optional (n, E) uint32 words routed with each row.

    Returns:
      (ShuffleResult, routed payload): the payload (n, E) uint32 in
      ``perm`` order, None without one.
    """
    n = int(hash_words[0].shape[0])
    if n == 0:
        return empty_shuffle_result(mesh.size, payload_words)
    per_shard = -(-num_buckets // mesh.size)  # ceil: range ownership
    shards, gather_fns = marshal_shuffle_inputs(
        hash_words, order_words, payload_words, mesh)
    recvs, matrix = route_to_owners(
        shards, num_buckets, mesh, lambda b: b // per_shard,
        gather_fns["counts"])
    perm, buckets_sorted, payload, counts = unpack_shuffle_output(
        recvs, len(order_words), payload_words is not None)
    return ShuffleResult(perm=perm, buckets_sorted=buckets_sorted,
                         device_row_counts=counts,
                         capacity=int(matrix.max())), payload


def empty_shuffle_result(n_devices: int, payload_words):
    return ShuffleResult(
        perm=np.empty(0, np.int64),
        buckets_sorted=np.empty(0, np.int32),
        device_row_counts=np.zeros(n_devices, np.int32),
        capacity=0,
    ), (np.empty((0, payload_words.shape[1]), np.uint32)
        if payload_words is not None else None)


def unpack_shuffle_output(recvs: Sequence[torch.Tensor], n_key_cols: int,
                          has_payload: bool):
    """(perm, buckets_sorted, payload, per-shard counts) on the host:
    each shard's bucket, row id and payload columns pulled by one
    attributed read-back, concatenated in shard order."""
    perm_parts, bucket_parts, payload_parts = [], [], []
    for recv in recvs:
        cols = recv[:, :_KEYS]
        if has_payload:
            cols = torch.cat([cols, recv[:, _KEYS + n_key_cols:]], dim=1)
        rows = sync_guard.pull(cols, "shuffle.routed")
        perm_parts.append(rows[:, _ROW])
        bucket_parts.append(rows[:, _BUCKET].astype(np.int32))
        if has_payload:
            payload_parts.append(rows[:, _KEYS:].astype(np.uint32))
    counts = np.array([len(p) for p in perm_parts], dtype=np.int32)
    payload = np.concatenate(payload_parts) if has_payload else None
    return (np.concatenate(perm_parts), np.concatenate(bucket_parts),
            payload, counts)
