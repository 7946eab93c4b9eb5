"""The fused join→aggregate on the device (counterpart of
hyperspace_tpu/ops/join_agg.py): the TPC-H Q3/Q10 shape,
``aggregate(filter ⋈ index)``, with the joined rows never leaving the
device.

  1. the sorted equi-join of the two key columns
     (``ops.join.match_pairs``: ``_sort_codes``, ``_match_ranges``,
     ``_expand``); the match count is read back once;
  2. every referenced column gathered through the match indices;
  3. each expression input (``sum(price * (1 - discount))``) evaluated
     on the gathered columns (``ops.filter.build_value_fn``), its
     literals typed as one vector, as the JAX package types them;
  4. the group sort and the per-group reductions of ``ops.aggregate``
     (the group starts are the second read back);
  5. with ``topn``, the k groups ranking first by one aggregate
     (``_topk_groups``), so only k groups come back; else all of them.

Only per-group results reach the host: counts, reductions, and the
(left, right) row indices of each group's first joined row, with which
the executor takes the group-key values from its arrow tables in their
own types.

``join_group_aggregate_mesh`` is the mesh entry: three stages over the
logical shards of a mesh, the joined rows crossing the host between
them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.ops.aggregate import (
    Array,
    _group_sort,
    _segment_reduce,
    to_device,
)
from hyperspace_tpu_torch.ops.join import match_pairs
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.telemetry import timeline


def _topk_groups(col: torch.Tensor, k: int, ascending: bool) -> torch.Tensor:
    """Positions of the k groups ranking first by ``col`` (ORDER BY
    <aggregate> LIMIT k), in rank order.

    ``jax.lax.top_k`` ranks equal values by the lower index first; a
    stable descending sort does the same (``torch.topk`` gives no tie
    order).  As in the JAX package: ascending order ranks floats by
    ``-col`` and integers by ``~col`` (``-col`` overflows at the int64
    minimum), and a NaN ranks as ``-inf``, after the flip, so it never
    beats a number.  Groups are counted exactly here, so no slot is
    padding."""
    if col.is_floating_point():
        work = -col if ascending else col
        work = torch.where(torch.isnan(work),
                           torch.full_like(work, float("-inf")), work)
    else:
        work = ~col if ascending else col
    order = torch.sort(work, descending=True, stable=True).indices
    return order[:k]


def _empty(agg_ops: Sequence[str]):
    return (np.empty(0, np.int64), np.empty(0, np.int64),
            np.empty(0, np.int32), [np.empty(0) for _ in agg_ops])


def join_group_aggregate(
    l_key: Array,
    r_key: Array,
    columns: Sequence[Array],
    column_sides: Sequence[str],
    group_col_ix: Sequence[int],
    agg_ops: Sequence[str],
    value_fns: Sequence[Callable],
    literals: Sequence[Sequence],
    topn: Optional[Tuple[int, bool, int]] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray]]:
    """Inner-join two sides on one numeric key each, then group and
    aggregate the joined rows, on ``device`` (``cuda`` when None; tensors
    stay on their own device).

    Args:
      l_key/r_key: the key columns (int64 or float64).
      columns: the referenced columns, each of the side named by
        ``column_sides`` ("l" or "r") and as long as its key.
      group_col_ix: indices into ``columns`` of the group keys, in
        group-by order (int64-domain values).
      agg_ops: per aggregate, one of ``ops.aggregate.AGG_OPS``.
      value_fns/literals: per aggregate that is not a count, a bound
        function of ``build_value_fn`` over the gathered columns and its
        literals.
      topn: optional (aggregate index, ascending, k): keep the k groups
        that rank first by that aggregate.

    Returns:
      (li_first, ri_first, counts, results): per group, the (left, right)
      input rows of its first joined row (int64), its row count (int32)
      and one result array per aggregate; groups in ascending key order,
      or in rank order with ``topn``.  No match gives empty arrays, every
      result float64, as in the JAX package.
    """
    lk = to_device(l_key, device)
    rk = to_device(r_key, lk.device)
    if lk.shape[0] == 0 or rk.shape[0] == 0:
        return _empty(agg_ops)
    t0 = timeline.kernel_begin(lk.device)
    li, ri = match_pairs(lk, rk)
    if li.shape[0] == 0:
        timeline.kernel_end("join_agg", t0, li)
        return _empty(agg_ops)
    gathered = [to_device(c, lk.device)[li if side == "l" else ri]
                for c, side in zip(columns, column_sides)]
    value_cols = [
        fn(gathered, torch.from_numpy(np.asarray(lits)).to(lk.device))
        for fn, lits in zip(value_fns, literals)]
    perm, boundaries = _group_sort([gathered[i] for i in group_col_ix])
    starts = torch.nonzero(boundaries).flatten()  # the second read back
    out = _segment_reduce(perm, boundaries, starts, value_cols, agg_ops)
    first_rows, counts, results = out[0], out[1], out[2:]
    if topn is not None:
        agg_i, ascending, k = topn
        sel = _topk_groups(results[agg_i], min(int(k), starts.shape[0]),
                           bool(ascending))
        first_rows, counts = first_rows[sel], counts[sel]
        results = [r[sel] for r in results]
    timeline.kernel_end("join_agg", t0, (first_rows, counts, results))
    return (sync_guard.pull(li[first_rows], "join_agg.left_rows"),
            sync_guard.pull(ri[first_rows], "join_agg.right_rows"),
            sync_guard.pull(counts, "join_agg.counts"),
            [sync_guard.pull(r, "join_agg.results") for r in results])


def join_group_aggregate_mesh(
    l_key,
    r_key,
    columns: Sequence,
    column_sides: Sequence[str],
    group_col_ix: Sequence[int],
    agg_ops: Sequence[str],
    value_fns: Sequence[Callable],
    literals: Sequence[Sequence],
    mesh,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[np.ndarray]]:
    """``join_group_aggregate``'s result (groups in ascending key order)
    over the logical shards of ``mesh``, in three stages:

      1. the inner join, both sides partitioned by join-key ownership
         (``ops.join.sorted_equi_join_mesh``: no exchange, only the match
         indices come back);
      2. each aggregate's input evaluated row-split over the shards
         (``parallel/filter.eval_predicate_on_mesh``);
      3. the grouped aggregation with GROUP-key ownership
         (``parallel/aggregate.mesh_grouped_aggregate``: each group
         reduced whole on one shard).

    The joined rows cross the host between the stages (O(matches)
    traffic: the price of moving from join-key to group-key ownership),
    and their order is the mesh join's, so float sums may round apart
    from the fused path's.  No ``topn``: a caller that wants it keeps
    the fused path.  Host inputs only."""
    from hyperspace_tpu_torch.ops.join import sorted_equi_join_mesh
    from hyperspace_tpu_torch.parallel.aggregate import mesh_grouped_aggregate
    from hyperspace_tpu_torch.parallel.filter import eval_predicate_on_mesh

    l_key, r_key = np.asarray(l_key), np.asarray(r_key)
    if l_key.shape[0] == 0 or r_key.shape[0] == 0:
        return _empty(agg_ops)
    li, ri = sorted_equi_join_mesh(l_key, r_key, mesh)
    if li.size == 0:
        return _empty(agg_ops)
    gathered = [np.asarray(c)[li if side == "l" else ri]
                for c, side in zip(columns, column_sides)]
    # The literals typed as one vector, as the fused path types them.
    value_cols = [eval_predicate_on_mesh(fn, gathered, np.asarray(lits), mesh)
                  for fn, lits in zip(value_fns, literals)]
    first_rows, counts, results = mesh_grouped_aggregate(
        [gathered[i] for i in group_col_ix], value_cols, agg_ops, mesh)
    return li[first_rows], ri[first_rows], counts, results
