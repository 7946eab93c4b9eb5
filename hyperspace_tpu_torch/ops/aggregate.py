"""Grouped aggregation on the device (counterpart of
hyperspace_tpu/ops/aggregate.py): sort the rows by their group keys,
then reduce each run of equal keys.  ``grouped_aggregate_mesh`` is the
mesh entry: the rows partitioned by group-key ownership over the
logical shards of a mesh, each group reduced whole on its owner
(``parallel/aggregate.py``).

  1. ``_group_sort``: a stable LSD lexsort of the rows by the key
     columns (``torch.sort(stable=True)``, last key first); a group
     starts where a sorted key differs from the row before.  The group
     starts (``torch.nonzero``, so the group count) are the one
     synchronisation.
  2. ``_segment_reduce``: per group the first row, the row count and
     each reduction over the sorted rows.  Float sums, minima and maxima
     reduce each run of rows by ``torch.segment_reduce`` with the counts
     as lengths (a fixed order on the card, where ``index_add_`` on
     floats is nondeterministic); integer ones by ``index_add_`` and
     ``scatter_reduce``, which are exact in any order.

The JAX package sorts uint32 order words and pads the rows to a
capacity.  Every group key here is in the int64 domain (ints, bools and
temporals as ``io.columnar.to_device_numeric`` gives them), whose order
as int64 is the order of those words, so the keys sort as they are; and
PyTorch runs eagerly, so the group count is used exactly.  Float group
keys never reach this module: the executor keeps them on the host.

Supported: sum, min, max, mean, count and count_all over null-free int64
or float64 values.  ``mean`` sums in the value's own dtype, then divides
in float64 by the count.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.telemetry import timeline

AGG_OPS = ("sum", "min", "max", "mean", "count", "count_all")

Array = Union[np.ndarray, torch.Tensor]


def _group_sort(key_cols: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm, boundaries): the rows lexsorted by ``key_cols`` (the first
    column is the primary key; equal keys keep row order), and per sorted
    row whether it starts a group."""
    n = key_cols[0].shape[0]
    device = key_cols[0].device
    perm = torch.arange(n, device=device)
    for key in reversed(key_cols):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    boundaries = torch.zeros(n, dtype=torch.bool, device=device)
    if n:
        boundaries[0] = True
    for key in key_cols:
        s = key[perm]
        boundaries[1:] |= s[1:] != s[:-1]
    return perm, boundaries


def _segment_reduce(perm: torch.Tensor, boundaries: torch.Tensor,
                    starts: torch.Tensor, value_cols: Sequence[torch.Tensor],
                    ops: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    """(first rows, counts, one result per op), each with one entry per
    group in ascending key order.  ``starts`` are the sorted positions
    where groups start; ``value_cols`` holds one column per op that is
    not a count, in ops order."""
    n = perm.shape[0]
    num_groups = starts.shape[0]
    first_rows = perm[starts]
    ends = torch.cat([starts[1:], starts.new_full((1,), n)])
    lengths = ends - starts
    seg_ids = torch.cumsum(boundaries.to(torch.int64), 0) - 1
    counts = lengths.to(torch.int32)
    outs = []
    vi = 0
    for op in ops:
        if op in ("count", "count_all"):
            outs.append(counts)
            continue
        vals = value_cols[vi][perm]
        vi += 1
        kind = "sum" if op == "mean" else op
        if vals.is_floating_point():
            r = torch.segment_reduce(vals, kind, lengths=lengths)
        elif kind == "sum":
            r = torch.zeros(num_groups, dtype=vals.dtype, device=vals.device)
            r.index_add_(0, seg_ids, vals)
        else:
            r = torch.empty(num_groups, dtype=vals.dtype, device=vals.device)
            r.scatter_reduce_(0, seg_ids, vals, "a" + kind, include_self=False)
        if op == "mean":
            r = r.to(torch.float64) / torch.clamp(lengths, min=1)
        outs.append(r)
    return (first_rows, counts) + tuple(outs)


def to_device(a: Array, device: Optional[torch.device]) -> torch.Tensor:
    """A numpy array uploaded to ``device`` (``cuda`` when None); a
    tensor stays where it is."""
    if isinstance(a, torch.Tensor):
        return a
    device = torch.device(device if device is not None else "cuda")
    out = torch.from_numpy(np.require(a, requirements="CW")).to(device)
    timeline.record_transfer("h2d", out.nbytes)
    return out


def empty_result(ops: Sequence[str]):
    """The (first rows, counts, results) of no group: the JAX package's
    empty arrays (each result float64, whatever its op)."""
    return (np.empty(0, np.int64), np.empty(0, np.int32),
            [np.empty(0) for _ in ops])


def grouped_aggregate(key_cols: Sequence[Array], value_cols: Sequence[Array],
                      ops: Sequence[str], device=None
                      ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Grouped aggregation on ``device`` (``cuda`` when None; tensors
    stay on their own device).

    Args:
      key_cols: per group-key column, n int64 values.
      value_cols: one length-n int64 or float64 column per aggregate that
        is not a count, in ops order (counts reduce no values).
      ops: per aggregate, one of AGG_OPS.

    Returns:
      (first_rows, counts, results): for each of G groups in ascending
      key order, the index of its first row in the input order (the
      executor takes the key values from the arrow table with it), its
      row count (int32) and one result array per aggregate.
    """
    for op in ops:
        if op not in AGG_OPS:
            raise ValueError(f"Unsupported device aggregate {op!r}")
    keys = [to_device(k, device) for k in key_cols]
    values = [to_device(v, keys[0].device) for v in value_cols]
    if keys[0].shape[0] == 0:
        return empty_result(ops)
    t0 = timeline.kernel_begin(keys[0].device)
    perm, boundaries = _group_sort(keys)
    starts = torch.nonzero(boundaries).flatten()  # the one synchronisation
    out = _segment_reduce(perm, boundaries, starts, values, ops)
    timeline.kernel_end("aggregate", t0, out)
    first_rows = sync_guard.pull(out[0], "aggregate.first_rows")
    counts = sync_guard.pull(out[1], "aggregate.counts")
    return first_rows, counts, [sync_guard.pull(r, "aggregate.results")
                                for r in out[2:]]


def grouped_aggregate_mesh(key_cols: Sequence[np.ndarray],
                           value_cols: Sequence[np.ndarray],
                           ops: Sequence[str], mesh
                           ) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """``grouped_aggregate`` over the logical shards of ``mesh``: the same
    contract and group order, each group's rows on one shard, so every
    reduction is exact (``parallel/aggregate.py``).  Host inputs only."""
    from hyperspace_tpu_torch.parallel.aggregate import mesh_grouped_aggregate

    return mesh_grouped_aggregate(key_cols, value_cols, ops, mesh)
