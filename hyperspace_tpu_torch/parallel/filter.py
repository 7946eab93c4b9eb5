"""Predicate evaluation over the mesh: the distributed scan filter
(counterpart of hyperspace_tpu/parallel/filter.py).

The predicate is the port's elementwise closure
(``ops.filter.compile_predicate``); its columns are split row-wise over
the shards, each shard evaluates its rows on its own device with no
exchange, and the masks are concatenated and read back once.  The mesh
spans this process's devices: the input is a host batch, which one
process owns.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from hyperspace_tpu_torch.parallel.mesh import (
    Mesh,
    make_shard_and_gather_fns,
    match_partition_rules,
)


def eval_predicate_on_mesh(fn: Callable, columns: Sequence[np.ndarray],
                           literals, mesh: Mesh) -> np.ndarray:
    """The mask (or value) of ``fn(columns, literals)`` with ``columns``
    split row-wise over ``mesh``.  ``literals`` is a list of values, or a
    1-D array whose dtype types them all (the fused join->aggregate's),
    placed on every shard."""
    specs = match_partition_rules(("values", "literals", "mask"))
    shard_fns, gather_fns = make_shard_and_gather_fns(
        mesh, specs, site="mesh_filter")
    cols = [shard_fns["values"](np.asarray(c)) for c in columns]
    lits = shard_fns["literals"](literals) \
        if isinstance(literals, np.ndarray) else [literals] * mesh.size
    masks = [fn([c[d] for c in cols], lits[d]) for d in range(mesh.size)]
    return gather_fns["mask"](masks)
