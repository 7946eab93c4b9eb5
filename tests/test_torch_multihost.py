"""hyperspace_tpu_torch/parallel/multihost.py on the CPU: the two-stage
(dcn, ici) bucket shuffle over 8 logical CPU shards against the port's
flat shuffle and the JAX package's ``hierarchical_bucket_shuffle`` on
its 8-device CPU mesh, on the same seeded numpy inputs (the mirror of
tests/test_parallel.py::TestHierarchicalShuffle); and two OS processes
joined by ``initialize_distributed`` over Gloo, whose stage 1 crosses
the process boundary (the mirror of tests/test_multiprocess.py).

Run as ``python tests/test_torch_multihost.py <host:port> <world> <rank>
<device>``, this file is that smoke's worker.

A deliberate difference, pinned here: the port's exchanges move exact
per-(source, destination) counts, so there is no overflow retry and
``capacity`` is the largest stage-2 slice.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 4), (4, 2), (8, 1), (1, 8)]
ROWS_PER_PROCESS = 600
SMOKE_BUCKETS = 16


def _int64_words(values):
    from hyperspace_tpu_torch.io.columnar import _monotone_uint64, split_words64

    values = np.ascontiguousarray(values, dtype=np.int64)
    return split_words64(values.view(np.uint64)), \
        split_words64(_monotone_uint64(values))


@pytest.fixture(scope="module")
def cpu8():
    import torch

    return [torch.device("cpu")] * 8


def _hier_case():
    rng = np.random.default_rng(5)
    n = 512
    keys = rng.integers(-1000, 1000, n)
    payload = rng.integers(0, 2**32, (n, 3), dtype=np.uint32)
    hw, ow = _int64_words(keys)
    return [hw], [ow], payload


def _assert_same(a, a_pl, b, b_pl):
    np.testing.assert_array_equal(a.perm, b.perm)
    np.testing.assert_array_equal(a.buckets_sorted, b.buckets_sorted)
    np.testing.assert_array_equal(a.device_row_counts, b.device_row_counts)
    np.testing.assert_array_equal(a_pl, b_pl)


class TestHierarchicalShuffle:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_the_flat_shuffle(self, cpu8, shape):
        from hyperspace_tpu_torch.parallel import (
            Mesh,
            bucket_shuffle,
            build_mesh_2d,
            hierarchical_bucket_shuffle,
        )

        hw, ow, payload = _hier_case()
        flat, flat_pl = bucket_shuffle(hw, ow, 16, Mesh(cpu8),
                                       payload_words=payload)
        mesh2d = build_mesh_2d(shape[0], shape[1], devices=cpu8)
        assert mesh2d.shape == shape and mesh2d.axis_names == ("dcn", "ici")
        hier, hier_pl = hierarchical_bucket_shuffle(hw, ow, 16, mesh2d,
                                                    payload_words=payload)
        _assert_same(hier, hier_pl, flat, flat_pl)
        np.testing.assert_array_equal(hier_pl, payload[hier.perm])

    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_the_jax_hierarchical_shuffle(self, cpu8, shape):
        import jax

        import hyperspace_tpu.parallel as jpar
        from hyperspace_tpu_torch.parallel import (
            build_mesh_2d,
            hierarchical_bucket_shuffle,
        )

        assert len(jax.devices()) == 8, "conftest gives 8 virtual devices"
        hw, ow, payload = _hier_case()
        ours, our_pl = hierarchical_bucket_shuffle(
            hw, ow, 16, build_mesh_2d(*shape, devices=cpu8),
            payload_words=payload)
        theirs, their_pl = jpar.hierarchical_bucket_shuffle(
            hw, ow, 16, jpar.build_mesh_2d(*shape), payload_words=payload)
        _assert_same(ours, our_pl, theirs, their_pl)

    def test_one_bucket_skew(self, cpu8):
        """Every row hashes to one bucket: the JAX package's stage
        buffers overflow and retry; the port's exact slices need no
        retry, and ``capacity`` is the largest stage-2 slice."""
        from hyperspace_tpu_torch.parallel import (
            build_mesh_2d,
            hierarchical_bucket_shuffle,
        )

        n = 256
        hw, ow = _int64_words(np.full(n, 42))
        result, _ = hierarchical_bucket_shuffle(
            [hw], [ow], 16, build_mesh_2d(2, 4, devices=cpu8))
        assert result.perm.shape[0] == n
        assert np.array_equal(np.sort(result.perm), np.arange(n))
        assert sorted(result.device_row_counts, reverse=True)[0] == n
        # 8 sources of 32 rows: stage 1 gathers each slice's 4 x 32 at the
        # owner's slice, position by position; stage 2 moves each
        # position's 2 x 32 rows (one per source slice) to the owner.
        assert result.capacity == 64

    def test_zero_rows(self, cpu8):
        from hyperspace_tpu_torch.parallel import (
            build_mesh_2d,
            hierarchical_bucket_shuffle,
        )

        empty = np.zeros((0, 2), np.uint32)
        result, _ = hierarchical_bucket_shuffle(
            [empty], [empty], 8, build_mesh_2d(2, 4, devices=cpu8))
        assert result.perm.shape[0] == 0
        assert result.device_row_counts.sum() == 0

    def test_rejects_a_one_axis_mesh(self, cpu8):
        from hyperspace_tpu_torch.parallel import (
            Mesh,
            hierarchical_bucket_shuffle,
        )

        with pytest.raises(ValueError, match="dcn"):
            hierarchical_bucket_shuffle(
                [np.zeros((4, 2), np.uint32)],
                [np.zeros((4, 2), np.uint32)], 8, Mesh(cpu8))

    def test_one_hash_launch_per_shard_and_one_count_pull(self, cpu8,
                                                          monkeypatch):
        from hyperspace_tpu_torch.execution import sync_guard
        from hyperspace_tpu_torch.parallel import (
            build_mesh_2d,
            hierarchical_bucket_shuffle,
        )
        from hyperspace_tpu_torch.parallel import multihost

        calls, sites = [], []
        real_hash, real_pull = multihost.hash_buckets, sync_guard.pull
        monkeypatch.setattr(multihost, "hash_buckets",
                            lambda w, b: calls.append(b) or real_hash(w, b))
        monkeypatch.setattr(sync_guard, "pull",
                            lambda x, site="": sites.append(site)
                            or real_pull(x, site))
        hw, ow, _ = _hier_case()
        hierarchical_bucket_shuffle(hw, ow, 16,
                                    build_mesh_2d(4, 2, devices=cpu8))
        assert calls == [16] * 8
        assert sites.count("shuffle.hier.counts") == 1

    def test_the_default_devices_are_the_local_devices(self, cpu8,
                                                       monkeypatch):
        from hyperspace_tpu_torch.parallel import build_mesh_2d
        from hyperspace_tpu_torch.parallel import mesh as tmesh

        monkeypatch.setattr(tmesh, "local_devices",
                            lambda device=None: list(cpu8))
        assert build_mesh_2d(2, device="cpu").shape == (2, 4)
        with pytest.raises(ValueError, match="slices"):
            build_mesh_2d(3, device="cpu")


# ---------------------------------------------------------------------------
# Two OS processes over Gloo
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _smoke_keys(world: int) -> np.ndarray:
    return np.random.default_rng(11).integers(
        -5000, 5000, world * ROWS_PER_PROCESS)


def _worker(address: str, world: int, rank: int, device: str) -> None:
    """One process of the smoke: slice ``rank`` of ``world``, 2 logical
    shards on ``device``; its shards' records are held to numpy."""
    import torch.distributed as dist

    from hyperspace_tpu_torch.io.columnar import _monotone_uint64
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np
    from hyperspace_tpu_torch.parallel.multihost import (
        initialize_distributed,
        process_bucket_shuffle,
    )

    backend = initialize_distributed(address, world, rank, device=device)
    assert backend == "gloo", backend
    shards = 2
    keys = _smoke_keys(world)
    lo = rank * ROWS_PER_PROCESS
    hw, ow = _int64_words(keys[lo:lo + ROWS_PER_PROCESS])
    outs = process_bucket_shuffle([hw], [ow], SMOKE_BUCKETS, lo, shards,
                                  device=device)
    # numpy: the rows shard d owns, in (bucket, key, global row) order.
    full_hw, _ = _int64_words(keys)
    buckets = bucket_ids_np([full_hw], SMOKE_BUCKETS)
    owner = buckets // -(-SMOKE_BUCKETS // (world * shards))
    code = _monotone_uint64(keys)
    for p, out in enumerate(outs):
        rows = np.flatnonzero(owner == rank * shards + p)
        rows = rows[np.lexsort((rows, code[rows], buckets[rows]))]
        got = out.cpu().numpy()
        np.testing.assert_array_equal(got[:, 1], rows)
        np.testing.assert_array_equal(got[:, 0], buckets[rows])
    dist.barrier()
    dist.destroy_process_group()
    print(f"proc{rank}: two-stage smoke OK over {world * shards} shards "
          f"({world} processes x {shards})")


def test_two_process_gloo_smoke():
    address = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), address, "2", str(rank),
         "cpu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    outputs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=60)
            outputs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {rank} (rc={p.returncode}):\n{out}"
        assert f"proc{rank}: two-stage smoke OK over 4 shards" in out, out


def test_initialize_distributed_on_cuda_without_cuda_raises():
    import torch

    from hyperspace_tpu_torch.parallel import initialize_distributed

    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed("127.0.0.1:1", 2, 0)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
