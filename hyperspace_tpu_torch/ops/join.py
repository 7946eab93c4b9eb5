"""The device equi-join over sorted keys (counterpart of
hyperspace_tpu/ops/join.py).

  1. stable-sort the right keys (``torch.sort(stable=True)``; index data
     arrives sorted within each bucket),
  2. ``torch.searchsorted`` the left keys into them: per left row the
     match range [lo, hi),
  3. expand the ranges to (left, right) pairs with
     ``torch.repeat_interleave`` and gathers.

Step 3's output size is the match count, read back to the host once
(``(hi - lo).sum()``, the one synchronisation, as in the JAX package).
PyTorch runs eagerly, so the count is used exactly, with no power-of-two
capacity.  Pairs come in left-row order, each left row's matches in the
right side's stable sorted order: the JAX package's order.

Keys that are integers on both sides and fit in int32 are narrowed to
int32 on the host before the upload, as the JAX package does, which
halves the bytes moved and sorted.  Float keys sort and search as int64
codes of the total order ``jnp.sort`` uses: -0.0 equals 0.0, and every
NaN equals every other NaN and sorts after +inf, so NaN keys match NaN
keys on both packages' device paths.  torch's own float ``searchsorted``
gives other ranges once a NaN is in the sorted keys.

``sorted_equi_join_mesh`` is the mesh entry: both sides partitioned by
key-hash ownership over the logical shards of a mesh, each shard joining
its own keys (``parallel/join.py``).

pyarrow is imported inside the functions that take arrow tables.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.telemetry import timeline

Keys = Union[np.ndarray, torch.Tensor]

_FNV_OFFSET = np.uint64(0xcbf29ce484222325)
_FNV_PRIME = np.uint64(0x100000001b3)
_MAGNITUDE_BITS = 0x7FFF_FFFF_FFFF_FFFF


def _sort_codes(keys: torch.Tensor) -> torch.Tensor:
    """Integer keys as they are; float keys as int64 codes whose order
    and equality are the total order of ``jnp.sort`` (-0.0 == 0.0, one
    NaN class after +inf)."""
    if not keys.is_floating_point():
        return keys
    k = keys.to(torch.float64)
    k = torch.where(k == 0, torch.zeros_like(k), k)
    k = torch.where(torch.isnan(k), torch.full_like(k, float("nan")), k)
    bits = k.view(torch.int64)
    return torch.where(bits < 0, bits ^ _MAGNITUDE_BITS, bits)


def _match_ranges(left_keys: torch.Tensor, right_keys_sorted: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.searchsorted(right_keys_sorted, left_keys, side="left")
    hi = torch.searchsorted(right_keys_sorted, left_keys, side="right")
    return lo, hi


def _expand(lo: torch.Tensor, hi: torch.Tensor, total: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left row, position in the sorted right keys) of every match."""
    counts = hi - lo
    left_idx = torch.repeat_interleave(
        torch.arange(lo.shape[0], device=lo.device), counts, output_size=total)
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(total, device=lo.device) - starts[left_idx]
    return left_idx, lo[left_idx] + within


def _fits32(a: np.ndarray) -> bool:
    if np.can_cast(a.dtype, np.int32):
        return True
    return bool(a.min() >= -2**31 and a.max() <= 2**31 - 1)


def sorted_equi_join(left_keys: Keys, right_keys: Keys,
                     device: Union[None, str, torch.device] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Inner equi-join on one numeric key: (left_indices, right_indices)
    into the inputs, as int64 numpy arrays, in left-row order.

    Two numpy key arrays are narrowed to int32 when both sides allow it,
    then uploaded to ``device`` (``cuda`` when None).  Tensor keys (the
    device column cache's) stay on their own device, unnarrowed, like the
    JAX package's resident arrays, and a numpy side beside one is
    uploaded to that device as it is.  Neither input is written."""
    empty = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
    tensors = [k for k in (left_keys, right_keys) if isinstance(k, torch.Tensor)]
    if not tensors:
        if (np.issubdtype(left_keys.dtype, np.integer)
                and np.issubdtype(right_keys.dtype, np.integer)
                and left_keys.size and right_keys.size
                and _fits32(left_keys) and _fits32(right_keys)):
            left_keys = left_keys.astype(np.int32, copy=False)
            right_keys = right_keys.astype(np.int32, copy=False)
        device = torch.device(device if device is not None else "cuda")
    else:
        device = tensors[0].device
    lk, rk = (k if isinstance(k, torch.Tensor)
              else torch.from_numpy(np.require(k, requirements="CW")).to(device)
              for k in (left_keys, right_keys))
    timeline.record_transfer("h2d", sum(
        a.nbytes for a in (left_keys, right_keys)
        if not isinstance(a, torch.Tensor)))
    if lk.device != rk.device:
        raise ValueError(f"join keys on two devices: {lk.device}, {rk.device}")
    if lk.numel() == 0 or rk.numel() == 0:
        return empty
    t0 = timeline.kernel_begin(lk.device)
    left_idx, right_idx = match_pairs(lk, rk)
    timeline.kernel_end("join", t0, (left_idx, right_idx))
    return (sync_guard.pull(left_idx, "join.left_idx"),
            sync_guard.pull(right_idx, "join.right_idx"))


def match_pairs(lk: torch.Tensor, rk: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left indices, right indices) of every match of two key tensors
    on one device, as int64 tensors there, in left-row order and each
    left row's matches in the right side's stable sorted order."""
    # Sort the right keys in their own dtype, then search in the common
    # one (``jnp.searchsorted`` promotes both sides).
    r_perm = torch.sort(_sort_codes(rk), stable=True).indices
    common = torch.promote_types(lk.dtype, rk.dtype)
    lo, hi = _match_ranges(_sort_codes(lk.to(common)),
                           _sort_codes(rk[r_perm].to(common)))
    # The one synchronisation: the match count sizes the output.
    total = int(sync_guard.scalar((hi - lo).sum(), "join.match_count"))
    left_idx, right_pos = _expand(lo, hi, total)
    return left_idx, r_perm[right_pos]


def _key_owner_shards(keys: np.ndarray, n_shards: int):
    """(shards, originals): per mesh shard, the key values it owns and
    their input positions.  The owner is the key's bucket mod the shard
    count, by the build's hash on the host (``bucket_ids_np``), the mod
    ownership of the sharded build route: EQUAL keys always share an
    owner, so the per-shard joins find every match."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    words = columnar.to_hash_words(pa.chunked_array([pa.array(keys)]))
    owner = bucket_ids_np([words], n_shards)
    order = np.argsort(owner, kind="stable")
    bounds = np.searchsorted(owner[order], np.arange(n_shards + 1), "left")
    originals = [order[bounds[d]:bounds[d + 1]] for d in range(n_shards)]
    return [keys[o] for o in originals], originals


def sorted_equi_join_mesh(left_keys: np.ndarray, right_keys: np.ndarray,
                          mesh) -> Tuple[np.ndarray, np.ndarray]:
    """The inner equi-join over the logical shards of ``mesh``: the match
    set of ``sorted_equi_join`` (pair order is not part of the contract),
    both sides partitioned by key ownership and every shard joining only
    its own keys (``parallel/join.copartitioned_join_ragged``, no
    exchange; only the match indices come back).  Host inputs only:
    cached tensors keep the single-device join."""
    from hyperspace_tpu_torch.parallel.join import copartitioned_join_ragged

    left_keys = np.asarray(left_keys)
    right_keys = np.asarray(right_keys)
    if left_keys.size == 0 or right_keys.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    l_shards, l_orig = _key_owner_shards(left_keys, mesh.size)
    r_shards, r_orig = _key_owner_shards(right_keys, mesh.size)
    dev_ids, l_local, r_local = copartitioned_join_ragged(
        l_shards, r_shards, mesh)
    if dev_ids.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    # Shard d's pairs are one contiguous run (shard order).
    bounds = np.searchsorted(dev_ids, np.arange(mesh.size + 1), "left")
    li = np.concatenate([l_orig[d][l_local[bounds[d]:bounds[d + 1]]]
                         for d in range(mesh.size)])
    ri = np.concatenate([r_orig[d][r_local[bounds[d]:bounds[d + 1]]]
                         for d in range(mesh.size)])
    return li.astype(np.int64), ri.astype(np.int64)


def sorted_equi_join_np(left_keys: np.ndarray, right_keys: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host mirror of ``sorted_equi_join``: the same sort, search and
    expand in numpy, the route below the device threshold."""
    left_keys = np.asarray(left_keys)
    right_keys = np.asarray(right_keys)
    if left_keys.size == 0 or right_keys.size == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    r_perm = np.argsort(right_keys, kind="stable")
    rk_sorted = right_keys[r_perm]
    lo = np.searchsorted(rk_sorted, left_keys, side="left")
    hi = np.searchsorted(rk_sorted, left_keys, side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    left_idx = np.repeat(np.arange(left_keys.shape[0]), counts)
    starts = np.cumsum(counts) - counts
    within = np.arange(total) - np.repeat(starts, counts)
    right_idx = r_perm[lo[left_idx] + within]
    return left_idx.astype(np.int64), right_idx.astype(np.int64)


def key_digests(table, key_columns, null_salt: int = 1) -> np.ndarray:
    """(n,) uint64 FNV-1a digest per row over each key column's 64-bit
    hash words (``io.columnar.to_hash_words``: equal values, -0.0 and 0.0
    and equal strings included, give equal words).  Equal key tuples get
    equal digests; collisions only add candidates, which
    ``hashed_equi_join`` verifies away.  A row with a null key gets a
    digest of its own (row, ``null_salt``), so nulls never match and
    never make a cross product of candidates."""
    import pyarrow.compute as pc

    from hyperspace_tpu_torch.io import columnar

    n = table.num_rows
    acc = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    nulls = np.zeros(n, dtype=bool)
    with np.errstate(over="ignore"):
        for c in key_columns:
            column = table.column(c)
            if column.null_count > 0:
                nulls |= np.asarray(pc.is_null(column))
            words = np.asarray(columnar.to_hash_words(column))
            w64 = (words[:, 0].astype(np.uint64) << np.uint64(32)) \
                | words[:, 1].astype(np.uint64)
            acc = (acc ^ w64) * _FNV_PRIME
        if nulls.any():
            acc[nulls] = (np.flatnonzero(nulls).astype(np.uint64)
                          * _FNV_PRIME) ^ (np.uint64(null_salt) << np.uint64(62))
    return acc


class UnsupportedJoinKeys(Exception):
    """A key pair the hashed join cannot compare exactly (string vs int)."""


def hashed_equi_join(left, right, l_keys, r_keys,
                     device: Optional[torch.device]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Inner equi-join on composite or string keys of two arrow tables:
    64-bit digests joined by ``sorted_equi_join`` on ``device`` (by
    ``sorted_equi_join_np`` when ``device`` is None), then every
    candidate pair checked column by column against the values.  Mixed
    int/float key pairs compare as float64; NaN keys match NaN.

    Raises UnsupportedJoinKeys for a key pair with no exact common
    domain."""
    import pyarrow as pa
    import pyarrow.compute as pc

    lcols, rcols = [], []
    for lc, rc in zip(l_keys, r_keys):
        la, ra = left.column(lc), right.column(rc)
        if la.type != ra.type:
            if (pa.types.is_floating(la.type) or pa.types.is_integer(la.type)) \
                    and (pa.types.is_floating(ra.type)
                         or pa.types.is_integer(ra.type)):
                la = pc.cast(la, pa.float64())
                ra = pc.cast(ra, pa.float64())
            else:
                raise UnsupportedJoinKeys(f"{la.type} vs {ra.type}")
        lcols.append(la)
        rcols.append(ra)
    ltab = pa.table({f"k{i}": c for i, c in enumerate(lcols)})
    rtab = pa.table({f"k{i}": c for i, c in enumerate(rcols)})
    ld = key_digests(ltab, ltab.column_names, null_salt=1).view(np.int64)
    rd = key_digests(rtab, rtab.column_names, null_salt=2).view(np.int64)
    li, ri = sorted_equi_join_np(ld, rd) if device is None \
        else sorted_equi_join(ld, rd, device)
    if li.size == 0:
        return li, ri
    keep = np.ones(li.size, dtype=bool)
    for lc, rc in zip(ltab.columns, rtab.columns):
        la = lc.take(pa.array(li))
        ra = rc.take(pa.array(ri))
        eq = pc.fill_null(pc.equal(la, ra), False)
        mask = np.asarray(eq.to_numpy(zero_copy_only=False), dtype=bool)
        if pa.types.is_floating(la.type):
            mask |= (np.asarray(pc.fill_null(pc.is_nan(la), False))
                     & np.asarray(pc.fill_null(pc.is_nan(ra), False)))
        keep &= mask
    return li[keep], ri[keep]
