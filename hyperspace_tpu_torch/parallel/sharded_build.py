"""The spill build's per-chunk route over the mesh (counterpart of
hyperspace_tpu/parallel/sharded_build.py).

On one device a spill chunk runs ``ops.hash.route_partition``: the hash,
the stable lexsort by (bucket, keys) and the histogram's run cuts.  Over
a mesh the same chunk becomes: rows split over the shards -> the hash per
shard (one kernel launch each on the card) -> the exchange delivering
every row to its owner (shard ``d`` OWNS every bucket with
``bucket % n == d``) -> per shard, the stable lexsort of its rows
(``shuffle.sort_received``) and the histogram kernel over their buckets
-> the HOST GATHER SEAM: one attributed ``sync_guard.pull`` per shard
(``mesh.route.gather.d<d>``), its sorted row ids and its counts.  The
host then merges by bucket: a bucket lives on exactly one shard and each
shard's rows are grouped by ascending bucket, so placing each shard's
bucket runs at the global run offsets the counts give is the stable sort
by bucket of the shard-order concatenation.

The result equals ``route_partition``'s (and ``route_partition_np``'s)
bit for bit: the same hash, each shard sorting on (bucket, order keys,
GLOBAL row id), and no tie across shards.  So the layout never depends
on how many shards routed the chunk, and the spill build's run files are
the single device's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.ops.kernels import bucket_histogram
from hyperspace_tpu_torch.parallel.mesh import Mesh
from hyperspace_tpu_torch.parallel.shuffle import (
    marshal_shuffle_inputs,
    route_to_owners,
)


def bucket_group_bounds(num_buckets: int, groups: int) -> list:
    """Contiguous bucket ranges shared by every ownership layer: group
    ``g`` owns the buckets ``bounds[g] <= b < bounds[g + 1]``.  The spill
    build's groups (``actions/create._BucketSpill``) are cut with it."""
    return [-(-g * num_buckets // groups) for g in range(groups + 1)]


def mesh_route_partition(word_cols: Sequence[np.ndarray],
                         order_words: Sequence[np.ndarray],
                         num_buckets: int, mesh: Mesh
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The route + partition of one spill chunk over ``mesh``.

    The contract of ``ops.hash.route_partition``: ``(perm, counts)``,
    (n,) int64 ordering the chunk's rows by (bucket, *order words) with
    original row order in ties (grouped by bucket only when
    ``order_words`` is empty), and (num_buckets,) int64 rows per bucket,
    from the histogram kernel of each shard."""
    from hyperspace_tpu_torch.telemetry import metrics, timeline
    from hyperspace_tpu_torch.telemetry.trace import span

    n = int(word_cols[0].shape[0])
    if n == 0:
        return np.empty(0, np.int64), np.zeros(num_buckets, np.int64)
    size = mesh.size
    with span("exec.mesh.route", devices=size, rows=n):
        mark = timeline.kernel_begin(mesh.devices[0])
        if mark is not None:
            timeline.record_transfer("h2d", sum(
                int(np.asarray(w).nbytes) for w in (*word_cols, *order_words)))
        shards, gather_fns = marshal_shuffle_inputs(
            word_cols, order_words, None, mesh, site="mesh.route")
        recvs, _ = route_to_owners(shards, num_buckets, mesh,
                                   lambda b: b % size, gather_fns["counts"])
        outs = [torch.cat([r[:, 1], bucket_histogram(
            r[:, 0].to(torch.int32), num_buckets).to(torch.int64)])
                for r in recvs]
        timeline.kernel_end("mesh_route", mark, outs, shards=size)
        # THE host gather seam: one attributed pull per shard, its row
        # ids in its final order followed by its bucket counts.
        pulled = [sync_guard.pull(o, f"mesh.route.gather.d{d}")
                  for d, o in enumerate(outs)]
        metrics.inc("exec.mesh.gather.pulls", len(pulled))
        metrics.inc("exec.mesh.route.chunks")
        metrics.set_gauge("exec.mesh.devices", size)

    rows = [p[:-num_buckets] for p in pulled]
    shard_counts = [p[-num_buckets:] for p in pulled]
    counts = np.sum(shard_counts, axis=0)
    starts = np.zeros(num_buckets, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    perm = np.empty(n, np.int64)
    for r, c in zip(rows, shard_counts):
        # This shard's run of bucket b starts at its local offset; it
        # goes to the global offset of b.
        local = np.zeros(num_buckets, np.int64)
        np.cumsum(c[:-1], out=local[1:])
        perm[np.arange(len(r)) + np.repeat(starts - local, c)] = r
    return perm, counts
