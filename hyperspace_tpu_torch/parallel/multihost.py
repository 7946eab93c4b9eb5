"""The two-stage (dcn, ici) bucket shuffle and the distributed runtime
(counterpart of hyperspace_tpu/parallel/multihost.py).

A pod is not flat: chips inside a slice talk over a fast link (ICI on a
TPU pod, NVLink between the cards of one host), slices over a slower
network (DCN).  ``hierarchical_bucket_shuffle`` runs the bucket shuffle
in two stages over a 2-axis mesh ``(dcn, ici)``:

  1. every shard sends each row to the row's DESTINATION SLICE, at its
     own intra-slice position, so a row crosses the slow axis once;
  2. inside the destination slice, rows fan out to their owning shard;
  3. each shard sorts what it received as the flat shuffle does.

Bucket ownership is the flat shuffle's (a range partition over the
flattened (slice, position) order), so ``perm``, ``buckets_sorted``,
``device_row_counts`` and the payload equal
``parallel.shuffle.bucket_shuffle``'s on the same shards: only the
traffic changes.  Both exchanges are index ops across the shards, as in
the flat shuffle, and each shard's bucket ids come from the hash kernel
(one launch per shard on the card).  PyTorch runs eagerly at exact
sizes: one read-back of the (source, owner) count matrix sizes the
slices of both stages, so there is no padded buffer and no overflow
retry, and ``ShuffleResult.capacity`` is the largest stage-2 slice.

Across processes, ``initialize_distributed`` is the counterpart of
``jax.distributed.initialize`` over ``torch.distributed``, and
``process_bucket_shuffle`` runs the same two stages when the dcn axis
crosses the process boundary: each process is one slice, stage 1 is an
``all_to_all_single`` over the process group, stage 2 index ops inside
the process.  Under Gloo (the CPU, and two processes that share one
card: NCCL takes no two ranks on one device) the records pass through
host memory.

This collective path assumes every process stays alive: a killed
process leaves the others waiting in the exchange.  The crash-tolerant
cross-host build is ``parallel/multihost_build.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.ops.hash import order_key64
from hyperspace_tpu_torch.ops.kernels import hash_buckets
from hyperspace_tpu_torch.parallel import mesh as parallel_mesh
from hyperspace_tpu_torch.parallel.mesh import Mesh
from hyperspace_tpu_torch.parallel.shuffle import (
    _BUCKET,
    ShuffleResult,
    empty_shuffle_result,
    make_row_records,
    marshal_shuffle_inputs,
    scatter_to_buffer,
    sort_received,
    unpack_shuffle_output,
)

DCN_AXIS = "dcn"
ICI_AXIS = "ici"


class Mesh2D(Mesh):
    """A ``(dcn, ici)`` mesh: ``shape`` is (slices, shards per slice) and
    ``devices`` the flattened, slice-major order, the 1-axis mesh's."""

    __slots__ = ("shape",)
    axis_names = (DCN_AXIS, ICI_AXIS)

    def __init__(self, devices: Sequence, shape: Tuple[int, int]) -> None:
        super().__init__(devices)
        if shape[0] * shape[1] != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices do not form a "
                             f"{shape[0]} x {shape[1]} mesh")
        self.shape = (int(shape[0]), int(shape[1]))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device=None) -> str:
    """Join this process to the process group (one call per process).
    ``coordinator_address`` is ``host:port`` of rank 0's store; with no
    arguments the ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``
    environment is read.  ``device`` is this process's device (``cuda``
    when None).  The backend is NCCL only when every process of this host
    can have a card of its own, else Gloo.  Returns the backend."""
    import torch.distributed as dist

    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed on cuda, and no CUDA "
                           "device is available; pass device='cpu'")
    world = int(num_processes) if num_processes is not None else None
    backend = "gloo"
    if device.type == "cuda" and world is not None \
            and torch.cuda.device_count() >= world:
        backend = "nccl"
    if coordinator_address is None:
        dist.init_process_group(backend=backend, init_method="env://")
    else:
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=world, rank=int(process_id))
    return backend


def build_mesh_2d(n_slices: int, chips_per_slice: Optional[int] = None,
                  devices: Optional[Sequence] = None,
                  device=None) -> Mesh2D:
    """A ``(dcn, ici)`` mesh over ``devices`` (the local devices of a
    session on ``device`` by default, ``parallel/mesh.local_devices``):
    axis 0 crosses slices, axis 1 stays within one."""
    if devices is None:
        devices = parallel_mesh.local_devices(device)
    devices = list(devices)
    if chips_per_slice is None:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices do not split into {n_slices} slices")
        chips_per_slice = len(devices) // n_slices
    return Mesh2D(devices[:n_slices * chips_per_slice],
                  (n_slices, chips_per_slice))


def _exchange(sends: Sequence[torch.Tensor], sizes: np.ndarray, group,
              devices) -> List[torch.Tensor]:
    """One exchange inside ``group`` (shard indices): receiver ``group[e]``
    gets, in source order, each source's slice for ``e``; ``sizes[i, e]``
    rows go from ``group[i]`` to ``group[e]``, each send ordered by
    receiver."""
    offsets = np.zeros_like(sizes)
    np.cumsum(sizes[:, :-1], axis=1, out=offsets[:, 1:])
    return [torch.cat([
        sends[i][int(offsets[i, e]):int(offsets[i, e] + sizes[i, e])]
        .to(devices[group[e]]) for i in range(len(group))])
        for e in range(len(group))]


def hierarchical_bucket_shuffle(
    hash_words: Sequence[np.ndarray],
    order_words: Sequence[np.ndarray],
    num_buckets: int,
    mesh: Mesh,
    payload_words: Optional[np.ndarray] = None,
) -> Tuple[ShuffleResult, Optional[np.ndarray]]:
    """The two-stage bucket shuffle over a ``build_mesh_2d`` mesh, with
    ``bucket_shuffle``'s arguments and result, and its output."""
    if tuple(getattr(mesh, "axis_names", ())) != (DCN_AXIS, ICI_AXIS):
        raise ValueError(
            f"hierarchical shuffle needs a (dcn, ici) mesh, got "
            f"{getattr(mesh, 'axis_names', None)}")
    S, Pn = mesh.shape
    n_dev = mesh.size
    if int(hash_words[0].shape[0]) == 0:
        return empty_shuffle_result(n_dev, payload_words)
    per_device = -(-num_buckets // n_dev)  # range ownership, as flat
    shards, gather_fns = marshal_shuffle_inputs(
        hash_words, order_words, payload_words, mesh, site="shuffle.hier")
    records, owners = [], []
    for hw, ow, pl, rows in shards:
        bucket = hash_buckets(hw, num_buckets)
        records.append(make_row_records(bucket, rows,
                                        [order_key64(w) for w in ow], pl))
        owners.append(bucket.to(torch.int64) // per_device)
    # Rows from each source shard to each owning shard: both stages'
    # slice sizes, from one read-back.
    matrix = gather_fns["counts"]([
        torch.zeros(n_dev, dtype=torch.int64, device=o.device)
        .scatter_add_(0, o, torch.ones_like(o)) for o in owners
    ]).reshape(n_dev, n_dev)
    by_slice = matrix.reshape(n_dev, S, Pn)

    # Stage 1 (dcn): at each position p, the shards (s, p) of every slice
    # exchange each row to its owner's slice.
    sends1 = [scatter_to_buffer(r, o // Pn, S)[0]
              for r, o in zip(records, owners)]
    recv1: List[Optional[torch.Tensor]] = [None] * n_dev
    for p in range(Pn):
        group = [s * Pn + p for s in range(S)]
        sizes = by_slice[group].sum(axis=2)  # [source slice, dest slice]
        for e, t in enumerate(_exchange([sends1[i] for i in group], sizes,
                                        group, mesh.devices)):
            recv1[group[e]] = t

    # Stage 2 (ici): inside each slice, to the owning position.
    recvs: List[Optional[torch.Tensor]] = [None] * n_dev
    n_keys = len(order_words)
    capacity = 0
    for s in range(S):
        group = [s * Pn + p for p in range(Pn)]
        # Shard (s, p') holds, from every slice, the rows owned in slice s
        # that stage 1 sent at position p'.
        sizes = by_slice[:, s, :].reshape(S, Pn, Pn).sum(axis=0)
        capacity = max(capacity, int(sizes.max()))
        sends2 = [scatter_to_buffer(
            recv1[i], (recv1[i][:, _BUCKET] // per_device) % Pn, Pn)[0]
            for i in group]
        for e, t in enumerate(_exchange(sends2, sizes, group,
                                        mesh.devices)):
            recvs[group[e]] = sort_received(t, n_keys)
    perm, buckets_sorted, payload, counts = unpack_shuffle_output(
        recvs, n_keys, payload_words is not None)
    return ShuffleResult(perm=perm, buckets_sorted=buckets_sorted,
                         device_row_counts=counts,
                         capacity=capacity), payload


def process_bucket_shuffle(
    hash_words: Sequence[np.ndarray],
    order_words: Sequence[np.ndarray],
    num_buckets: int,
    row_offset: int,
    shards_per_process: int,
    device=None,
) -> List[torch.Tensor]:
    """The two-stage shuffle when the dcn axis crosses processes: this
    process is slice ``rank`` of ``world_size`` in the process group
    (``initialize_distributed``), holding global rows ``[row_offset,
    row_offset + n)`` over ``shards_per_process`` logical shards on
    ``device``.  Stage 1 is one ``all_to_all_single`` of the int64
    records per position (the counts first), staged through host memory
    under Gloo; stage 2 index ops inside the process.  Returns each local
    shard's received records in their final order (bucket, global row id
    and order keys first, as ``bucket_shuffle``'s records): the rows the
    flat shuffle over ``world_size * shards_per_process`` shards gives
    those shards."""
    import torch.distributed as dist

    from hyperspace_tpu_torch.parallel.mesh import shard_bounds

    device = torch.device(device if device is not None else "cuda")
    S, Pn = dist.get_world_size(), int(shards_per_process)
    stage = torch.device("cpu") if dist.get_backend() == "gloo" else device
    per_device = -(-num_buckets // (S * Pn))
    n = int(hash_words[0].shape[0])
    sends = []
    for lo, hi in shard_bounds(n, Pn):
        words = [torch.from_numpy(np.ascontiguousarray(w[lo:hi])).to(device)
                 for w in hash_words]
        bucket = hash_buckets(words, num_buckets)
        rows = torch.arange(row_offset + lo, row_offset + hi,
                            dtype=torch.int64, device=device)
        keys = [order_key64(torch.from_numpy(
            np.ascontiguousarray(w[lo:hi])).to(device)) for w in order_words]
        owner = bucket.to(torch.int64) // per_device
        sends.append(scatter_to_buffer(
            make_row_records(bucket, rows, keys, None), owner // Pn, S))
    recv1 = []
    for send, counts in sends:
        counts = counts.to(stage)
        got = torch.empty_like(counts)
        dist.all_to_all_single(got, counts)
        out_split = sync_guard.pull(got, "shuffle.process.counts").tolist()
        in_split = sync_guard.pull(counts, "shuffle.process.counts").tolist()
        out = torch.empty((sum(out_split), send.shape[1]),
                          dtype=send.dtype, device=stage)
        dist.all_to_all_single(out, send.to(stage), out_split, in_split)
        recv1.append(out.to(device))
    # Stage 2: inside this process, to the owning position.
    sends2, sizes = [], []
    for r in recv1:
        send, counts = scatter_to_buffer(
            r, (r[:, _BUCKET] // per_device) % Pn, Pn)
        sends2.append(send)
        sizes.append(sync_guard.pull(counts, "shuffle.process.counts"))
    recvs = _exchange(sends2, np.stack(sizes), list(range(Pn)),
                      [device] * Pn)
    return [sort_received(t, len(order_words)) for t in recvs]
