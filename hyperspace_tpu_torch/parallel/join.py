"""The co-partitioned equi-join over the mesh (counterpart of
hyperspace_tpu/parallel/join.py): no exchange, by construction.

When both sides are bucketed by the join key with one bucket count,
equal keys are co-located, so each shard joins its own keys with no
shuffle.  Per shard, on its own device, as the single-device join
(``ops/join.py``) does it: ``_ranges_local`` stable-sorts the right keys
(as the total-order codes of ``ops.join._sort_codes``: -0.0 equals 0.0,
NaN equals NaN) and searches the left keys into them; the count pass
reads every shard's match count back at once, and the materialise pass
expands each shard's ranges at its exact count.  Shards hold exactly
their keys (PyTorch runs eagerly at exact sizes), so there is no padding
slot to keep out of a match window.  Matches never cross shards.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.ops.join import _expand, _match_ranges, _sort_codes
from hyperspace_tpu_torch.parallel.mesh import Mesh


def _ranges_local(lk: torch.Tensor, rk: torch.Tensor):
    """(lo, hi, r_order) of one shard: each left key's match range
    ``[lo, hi)`` in the right keys' stable sorted order ``r_order``,
    searched in the two sides' common dtype."""
    r_order = torch.sort(_sort_codes(rk), stable=True).indices
    common = torch.promote_types(lk.dtype, rk.dtype)
    lo, hi = _match_ranges(_sort_codes(lk.to(common)),
                           _sort_codes(rk[r_order].to(common)))
    return lo, hi, r_order


def copartitioned_join(left_keys: np.ndarray, right_keys: np.ndarray,
                       mesh: Mesh) -> Tuple[np.ndarray, np.ndarray]:
    """Inner equi-join of DENSE co-partitioned key shards: (D, L) and
    (D, R) arrays whose row ``d`` is shard ``d``'s keys.  Returns GLOBAL
    (left, right) index pairs into the flattened (D*L,) / (D*R,)
    arrays."""
    D, L = left_keys.shape
    R = right_keys.shape[1]
    dev_ids, li, ri = copartitioned_join_ragged(list(left_keys),
                                                list(right_keys), mesh)
    return li + dev_ids * L, ri + dev_ids * R


def copartitioned_join_ragged(left_shards: Sequence, right_shards: Sequence,
                              mesh: Mesh
                              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Join ragged per-shard key arrays (one 1-D array per mesh shard on
    each side).  Returns (shard ids, left local, right local), int64: for
    each match, its shard and the positions within that shard's two
    inputs, shard by shard, each shard's pairs in left-row order."""
    from hyperspace_tpu_torch.telemetry import timeline

    D = mesh.size
    if len(left_shards) != D or len(right_shards) != D:
        raise ValueError(f"{len(left_shards)}/{len(right_shards)} key "
                         f"shards for a mesh of {D}")
    empty = np.empty(0, np.int64)
    lks = [torch.from_numpy(np.require(k, requirements="CW")).to(dev)
           for k, dev in zip(left_shards, mesh.devices)]
    rks = [torch.from_numpy(np.require(k, requirements="CW")).to(dev)
           for k, dev in zip(right_shards, mesh.devices)]
    timeline.record_transfer("h2d", sum(int(np.asarray(k).nbytes) for k in
                                        (*left_shards, *right_shards)))
    mark = timeline.kernel_begin(mesh.devices[0])
    ranges = [_ranges_local(lk, rk) if lk.numel() and rk.numel() else None
              for lk, rk in zip(lks, rks)]
    # The count pass: every shard's match count in one read-back.
    first = mesh.devices[0]
    totals = sync_guard.pull(torch.stack([
        (r[1] - r[0]).sum().to(first) if r is not None
        else torch.zeros((), dtype=torch.int64, device=first)
        for r in ranges]), "mesh_join.counts")
    if not totals.any():
        timeline.kernel_end("mesh_join", mark, None, shards=D)
        return empty, empty, empty
    # The materialise pass, each shard at its exact count.
    lis: List[torch.Tensor] = []
    ris: List[torch.Tensor] = []
    for r, total in zip(ranges, totals):
        if r is None or not total:
            continue
        lo, hi, r_order = r
        left_idx, right_pos = _expand(lo, hi, int(total))
        lis.append(left_idx.to(first))
        ris.append(r_order[right_pos].to(first))
    timeline.kernel_end("mesh_join", mark, (lis, ris), shards=D)
    li = sync_guard.pull(torch.cat(lis), "mesh_join.li")
    ri = sync_guard.pull(torch.cat(ris), "mesh_join.ri")
    dev_ids = np.repeat(np.arange(D, dtype=np.int64), totals)
    return dev_ids, li.astype(np.int64), ri.astype(np.int64)
