"""The distributed data plane (counterpart of hyperspace_tpu/parallel/):
the mesh of logical shards, the bucket shuffle, the sharded spill route,
the monolithic mesh build, and the co-partitioned join, filter and
grouped aggregate; the 2-axis ``(dcn, ici)`` mesh, its two-stage
shuffle and the process group (``multihost.py``); and the crash-tolerant
multi-host build under work claims (``multihost_build.py``).  Each
shard's work runs on its own device, one shard after another; the
build's hash and histogram are the CUDA kernels of ``ops/kernels.py`` on
the card.
"""

from hyperspace_tpu_torch.parallel.aggregate import mesh_grouped_aggregate
from hyperspace_tpu_torch.parallel.build import (
    distributed_bucket_sort_permutation,
)
from hyperspace_tpu_torch.parallel.filter import eval_predicate_on_mesh
from hyperspace_tpu_torch.parallel.join import (
    copartitioned_join,
    copartitioned_join_ragged,
)
from hyperspace_tpu_torch.parallel.mesh import (
    SHARD_AXIS,
    Mesh,
    active_mesh,
    build_mesh,
    local_devices,
    make_shard_and_gather_fns,
    match_partition_rules,
)
from hyperspace_tpu_torch.parallel.multihost import (
    build_mesh_2d,
    hierarchical_bucket_shuffle,
    initialize_distributed,
)
from hyperspace_tpu_torch.parallel.sharded_build import (
    bucket_group_bounds,
    mesh_route_partition,
)
from hyperspace_tpu_torch.parallel.shuffle import ShuffleResult, bucket_shuffle

__all__ = [
    "SHARD_AXIS",
    "Mesh",
    "active_mesh",
    "build_mesh",
    "build_mesh_2d",
    "bucket_shuffle",
    "bucket_group_bounds",
    "local_devices",
    "match_partition_rules",
    "make_shard_and_gather_fns",
    "mesh_grouped_aggregate",
    "mesh_route_partition",
    "ShuffleResult",
    "distributed_bucket_sort_permutation",
    "eval_predicate_on_mesh",
    "hierarchical_bucket_shuffle",
    "initialize_distributed",
    "copartitioned_join",
    "copartitioned_join_ragged",
]
