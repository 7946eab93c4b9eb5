"""Grouped aggregation over the mesh: groups owned by one shard each, no
merge pass (counterpart of hyperspace_tpu/parallel/aggregate.py).

The single-device aggregate (``ops/aggregate.py``) sorts the rows by
their group keys and reduces each run.  Over the mesh the ROWS are
partitioned by group-key bucket: shard ``d`` owns every group whose key
words hash (``ops.hash.bucket_ids_np``, the build's hash on the host) to
a bucket with ``bucket % n == d``, the mod ownership of the sharded
build route.  A group's rows all carry the same words, so they land
wholly on one shard, and every reduction (sum, min, max, mean, count)
runs over the complete group on its owner: there is no partial
aggregate to merge, and mean is an ordinary per-group division.

Each shard runs the single device's ``_group_sort`` and
``_segment_reduce`` on its own device; its group starts (``nonzero``)
are its read-back, as on one device.  Each output plane comes back in
one attributed pull, and one host lexsort over the group keys gives the
groups in ascending key order, the single device's contract.  The
partition keeps each shard's rows in original order and the stable sort
keeps each group's rows in it, so every group reduces its rows in the
single device's order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.io.columnar import split_words64
from hyperspace_tpu_torch.ops.aggregate import (
    AGG_OPS,
    _group_sort,
    _segment_reduce,
    empty_result,
)
from hyperspace_tpu_torch.ops.hash import bucket_ids_np
from hyperspace_tpu_torch.parallel.mesh import (
    Mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
)


def key_owner(key_cols: Sequence[np.ndarray], n_shards: int) -> np.ndarray:
    """The owning shard of each row: the bucket, mod ``n_shards``, of its
    int64 keys' order words (the JAX package's ``to_order_words`` of an
    int64 column)."""
    words = [split_words64(np.asarray(k, np.int64).view(np.uint64)
                           ^ np.uint64(1 << 63)) for k in key_cols]
    return bucket_ids_np(words, n_shards)


def mesh_grouped_aggregate(key_cols: Sequence[np.ndarray],
                           value_cols: Sequence[np.ndarray],
                           ops: Sequence[str], mesh: Mesh
                           ) -> Tuple[np.ndarray, np.ndarray,
                                      List[np.ndarray]]:
    """Grouped aggregation over ``mesh``, with the contract and group
    order of ``ops.aggregate.grouped_aggregate``: per group in ascending
    key order, the index of its first row in the input, its row count
    (int32) and one result per aggregate.  Inputs are HOST arrays: int64
    group keys, one int64 or float64 column per aggregate that is not a
    count."""
    from hyperspace_tpu_torch.telemetry import metrics, timeline
    from hyperspace_tpu_torch.telemetry.trace import span

    for op in ops:
        if op not in AGG_OPS:
            raise ValueError(f"Unsupported device aggregate {op!r}")
    key_cols = [np.asarray(k, np.int64) for k in key_cols]
    value_cols = [np.asarray(v) for v in value_cols]
    n = int(key_cols[0].shape[0])
    if n == 0:
        return empty_result(ops)
    size = mesh.size
    owner = key_owner(key_cols, size)
    part_perm = np.argsort(owner, kind="stable")
    offsets = np.searchsorted(owner[part_perm], np.arange(size + 1), "left")

    with span("exec.mesh.agg", devices=size, rows=n):
        specs = match_partition_rules(("key_words", "value_cols", "perm",
                                       "counts", "values"))
        _, gather_fns = make_shard_and_gather_fns(mesh, specs,
                                                  site="mesh.agg")
        mark = timeline.kernel_begin(mesh.devices[0])
        if mark is not None:
            timeline.record_transfer("h2d", sum(
                int(a.nbytes) for a in (*key_cols, *value_cols)))
        outs = []
        for d, dev in enumerate(mesh.devices):
            rows = part_perm[offsets[d]:offsets[d + 1]]
            if not len(rows):
                continue
            keys = [torch.from_numpy(k[rows]).to(dev) for k in key_cols]
            values = [torch.from_numpy(v[rows]).to(dev) for v in value_cols]
            perm, boundaries = _group_sort(keys)
            starts = torch.nonzero(boundaries).flatten()  # the read-back
            first, counts, *results = _segment_reduce(
                perm, boundaries, starts, values, ops)
            # Local first rows -> input rows, on the shard's device.
            outs.append((torch.from_numpy(rows).to(dev)[first], counts,
                         results))
        timeline.kernel_end("mesh_aggregate", mark, outs, shards=size)
        # The host gather seam: one attributed pull per output plane.
        first_rows = gather_fns["perm"]([o[0] for o in outs])
        counts = gather_fns["counts"]([o[1] for o in outs])
        results = [gather_fns["values"]([o[2][i] for o in outs])
                   for i in range(len(ops))]
        metrics.set_gauge("exec.mesh.devices", size)
        metrics.inc("exec.mesh.gather.pulls", 2 + len(results))

    # One ascending-key order over all the shards' groups (the first key
    # is the primary one).
    order = np.lexsort([k[first_rows] for k in reversed(key_cols)])
    return first_rows[order], counts[order], [r[order] for r in results]
