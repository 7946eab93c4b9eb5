"""hyperspace_tpu_torch/parallel/ on the CPU: the port's mesh of 8
logical shards against the JAX package's 8-device CPU mesh (the
conftest's ``--xla_force_host_platform_device_count=8``) and against the
port's own single-device route, on the same seeded numpy inputs.

The mirror of tests/test_parallel.py (without its hierarchical shuffle,
which is multi-host) and of the kernel half of
tests/test_parallel_mesh.py.  Keys, orders and bucket ids are held bit
for bit; float aggregates within 1e-9 relative.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import hyperspace_tpu.parallel as jpar
from hyperspace_tpu.io import columnar as jcolumnar
from hyperspace_tpu.utils.compat import enable_x64
from hyperspace_tpu_torch import parallel as tpar
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.io.columnar import split_words64
from hyperspace_tpu_torch.parallel import mesh as tmesh
from hyperspace_tpu_torch.telemetry import metrics, timeline

RTOL = 1e-9
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jmesh():
    import jax

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jpar.build_mesh()


@pytest.fixture(scope="module")
def mesh():
    return tmesh.Mesh([CPU] * 8)


@pytest.fixture()
def eight_shards(monkeypatch):
    """The seam: 8 logical shards on the CPU session's device."""
    monkeypatch.setattr(tmesh, "local_devices", lambda device=None: [CPU] * 8)


class _Guard:
    def __init__(self, enabled: bool) -> None:
        self.device_guard_enabled = enabled


@pytest.fixture()
def armed_guard():
    device_type = sync_guard._device_type
    sync_guard.arm(_Guard(True), "cpu")
    yield
    sync_guard.arm(_Guard(False))
    sync_guard._device_type = device_type


def _snap(name: str) -> float:
    return float(metrics.snapshot().get(name, 0.0) or 0.0)


@pytest.fixture()
def pulled_sites(monkeypatch):
    """The site of every ``sync_guard.pull`` call, in order."""
    sites = []
    real = sync_guard.pull

    def spy(x, site=""):
        sites.append(site)
        return real(x, site)

    monkeypatch.setattr(sync_guard, "pull", spy)
    return sites


def _words(values):
    col = pa.chunked_array([pa.array(values)])
    return columnar.to_hash_words(col), columnar.to_order_words(col)


# ---------------------------------------------------------------------------
# The rule table and the shard/gather fns
# ---------------------------------------------------------------------------
class TestPartitionRules:
    _ENGINE = ("hash_words", "order_words", "row_words", "valid", "payload",
               "counts", "overflow", "n_valid", "key_words", "value_cols",
               "mask", "perm", "some_threshold", "literals")

    def test_data_and_per_shard_planes_split_rowwise(self):
        specs = tmesh.match_partition_rules(
            ("hash_words", "order_words", "row_words", "valid", "key_words",
             "value_cols", "counts", "overflow", "n_valid"))
        assert set(specs.values()) == {tmesh.SHARD_AXIS}

    def test_unknown_names_replicate_via_catchall(self):
        assert tmesh.match_partition_rules(("some_threshold",)) \
            == {"some_threshold": None}

    def test_first_match_wins(self):
        rules = ((r"^x$", None), (r".", tmesh.SHARD_AXIS))
        assert tmesh.match_partition_rules(("x", "y"), rules) \
            == {"x": None, "y": tmesh.SHARD_AXIS}

    def test_no_match_raises_without_catchall(self):
        with pytest.raises(ValueError, match="No partition rule"):
            tmesh.match_partition_rules(("zzz",), ((r"^x$", None),))

    def test_table_places_every_plane_as_the_jax_table(self):
        from jax.sharding import PartitionSpec as P

        from hyperspace_tpu.parallel.mesh import match_partition_rules

        ours = tmesh.match_partition_rules(self._ENGINE)
        theirs = match_partition_rules(self._ENGINE)
        for name in self._ENGINE:
            assert (ours[name] == tmesh.SHARD_AXIS) \
                == (theirs[name] == P("shard")), name


class TestShardGather:
    def test_round_trip_bit_equal(self, mesh):
        arr = np.random.default_rng(0).integers(
            0, 2**32, size=(64, 2), dtype=np.uint32)
        shard_fns, gather_fns = tmesh.make_shard_and_gather_fns(
            mesh, tmesh.match_partition_rules(("hash_words",)))
        shards = shard_fns["hash_words"](arr)
        assert len(shards) == 8 and all(s.shape == (8, 2) for s in shards)
        assert np.array_equal(gather_fns["hash_words"](shards), arr)

    @pytest.mark.parametrize("n", [32, 37, 3])
    def test_shard_slices_are_the_jax_shards(self, mesh, jmesh, n):
        """Shard d holds rows [d*L, (d+1)*L), L = ceil(n/8): the rows of
        the JAX package's d-th device shard, without its padding."""
        arr = np.arange(n, dtype=np.uint32)
        shard_fns, _ = tmesh.make_shard_and_gather_fns(
            mesh, tmesh.match_partition_rules(("valid",)))
        ours = shard_fns["valid"](arr)
        local = -(-n // 8)
        padded = np.pad(arr, (0, local * 8 - n))
        jshard_fns, _ = jpar.make_shard_and_gather_fns(
            jmesh, jpar.match_partition_rules(("valid",)))
        theirs = {(s.index[0].start or 0): np.asarray(s.data) for s in
                  jshard_fns["valid"](padded).addressable_shards}
        for d, shard in enumerate(ours):
            want = theirs[d * local][:max(0, min(n - d * local, local))]
            assert np.array_equal(shard.numpy(), want)

    def test_replicated_spec_puts_the_whole_array_on_every_shard(self, mesh):
        shard_fns, _ = tmesh.make_shard_and_gather_fns(
            mesh, tmesh.match_partition_rules(("some_threshold",)))
        shards = shard_fns["some_threshold"](np.arange(5))
        assert [s.tolist() for s in shards] == [list(range(5))] * 8

    def test_gather_is_one_attributed_pull(self, mesh, armed_guard,
                                           pulled_sites):
        """Under the armed guard a raw read-back raises; the seam is one
        attributed pull per array, at ``<site>.<name>``."""
        shard_fns, gather_fns = tmesh.make_shard_and_gather_fns(
            mesh, tmesh.match_partition_rules(("valid",)), site="t")
        shards = shard_fns["valid"](np.arange(16, dtype=np.int64))
        out = gather_fns["valid"](shards)
        assert np.array_equal(out, np.arange(16))
        assert pulled_sites == ["t.valid"]


# ---------------------------------------------------------------------------
# The conf gate
# ---------------------------------------------------------------------------
class TestActiveMesh:
    def _conf(self, **kw):
        from hyperspace_tpu_torch.config import HyperspaceConf

        c = HyperspaceConf()
        for k, v in kw.items():
            setattr(c, k, v)
        return c

    def test_auto_spans_the_local_devices(self, eight_shards):
        m = tmesh.active_mesh(self._conf(), CPU)
        assert m is not None and m.size == 8 and set(m.devices) == {CPU}

    def test_off_disables(self, eight_shards):
        for mode in ("off", "false", "OFF"):
            assert tmesh.active_mesh(self._conf(mesh_enabled=mode), CPU) \
                is None

    def test_max_devices_caps_the_span(self, eight_shards):
        assert tmesh.active_mesh(self._conf(mesh_max_devices=4), CPU).size \
            == 4

    def test_one_device_cap_means_no_mesh(self, eight_shards):
        assert tmesh.active_mesh(self._conf(mesh_max_devices=1), CPU) is None
        assert tmesh.active_mesh(self._conf(mesh_enabled="on",
                                            mesh_max_devices=1), CPU) is None

    def test_one_device_under_auto_is_no_mesh(self):
        """A CPU session sees one device, as one card does: no mesh."""
        assert tmesh.local_devices(CPU) == [CPU]
        for mode in ("auto", "on"):
            assert tmesh.active_mesh(self._conf(mesh_enabled=mode), CPU) \
                is None

    def test_invalid_mode_raises(self, eight_shards):
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        with pytest.raises(HyperspaceError):
            tmesh.active_mesh(self._conf(mesh_enabled="sideways"), CPU)

    def test_conf_defaults_are_the_jax_ones(self):
        from hyperspace_tpu.config import HyperspaceConf

        ours, theirs = self._conf(), HyperspaceConf()
        for field in ("parallel_build", "mesh_enabled", "mesh_max_devices",
                      "mesh_filter_min_rows", "mesh_join_min_rows",
                      "mesh_agg_min_rows"):
            assert getattr(ours, field) == getattr(theirs, field), field


# ---------------------------------------------------------------------------
# The bucket shuffle
# ---------------------------------------------------------------------------
def _shuffle_case(name):
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    if name == "uniform":
        return [rng.integers(0, 10_000, 5_000)], 16, None
    if name == "skewed":  # one key: every row to one shard
        return [np.full(2_000, 42, dtype=np.int64)], 16, None
    if name == "ranges":  # 20 buckets over 8 shards: 3 per shard
        return [rng.integers(0, 1_000, 2_000)], 20, None
    if name == "payload":
        payload = (np.arange(1_000, dtype=np.uint32)[:, None]
                   * np.uint32(7)).repeat(3, axis=1)
        return [rng.integers(0, 500, 1_000)], 8, payload
    if name == "strings":
        return [["apple", "banana", "cherry", "dates"] * 250], 8, None
    if name == "two_keys_with_ties":
        return [rng.integers(0, 20, 3_000),
                rng.integers(-3, 3, 3_000).astype(np.float64)], 16, None
    raise AssertionError(name)


_SHUFFLE_CASES = ("uniform", "skewed", "ranges", "payload", "strings",
                  "two_keys_with_ties")


class TestBucketShuffle:
    def test_zero_rows(self, mesh):
        empty = np.empty((0, 2), np.uint32)
        result, payload = tpar.bucket_shuffle([empty], [empty], 8, mesh)
        assert result.perm.size == 0 and payload is None
        assert result.device_row_counts.tolist() == [0] * 8
        _, payload = tpar.bucket_shuffle(
            [empty], [empty], 8, mesh,
            payload_words=np.empty((0, 3), np.uint32))
        assert payload.shape == (0, 3)

    @pytest.mark.parametrize("case", _SHUFFLE_CASES)
    def test_bit_equal_to_the_jax_shuffle(self, mesh, jmesh, case):
        keys, num_buckets, payload = _shuffle_case(case)
        hw, ow = zip(*[_words(k) for k in keys])
        ours, our_pl = tpar.bucket_shuffle(list(hw), list(ow), num_buckets,
                                           mesh, payload_words=payload)
        theirs, their_pl = jpar.bucket_shuffle(
            [jcolumnar.to_hash_words(pa.chunked_array([pa.array(k)]))
             for k in keys],
            [jcolumnar.to_order_words(pa.chunked_array([pa.array(k)]))
             for k in keys], num_buckets, jmesh, payload_words=payload)
        assert np.array_equal(ours.perm, theirs.perm)
        assert ours.perm.dtype == np.int64
        assert np.array_equal(ours.buckets_sorted, theirs.buckets_sorted)
        assert ours.buckets_sorted.dtype == np.int32
        assert np.array_equal(ours.device_row_counts,
                              theirs.device_row_counts)
        if payload is not None:
            assert np.array_equal(our_pl, their_pl)
            assert np.array_equal(our_pl, payload[ours.perm])
        # Range ownership: shard d holds buckets // ceil(B / 8) == d.
        per = -(-num_buckets // 8)
        starts = np.cumsum(ours.device_row_counts) - ours.device_row_counts
        for d, (s, c) in enumerate(zip(starts, ours.device_row_counts)):
            assert (ours.buckets_sorted[s:s + c] // per == d).all()

    @pytest.mark.parametrize("case", _SHUFFLE_CASES)
    def test_perm_is_the_single_device_route(self, mesh, case):
        from hyperspace_tpu_torch.ops.sort import bucket_sort_permutation

        keys, num_buckets, _ = _shuffle_case(case)
        hw, ow = zip(*[_words(k) for k in keys])
        ours, _ = tpar.bucket_shuffle(list(hw), list(ow), num_buckets, mesh)
        buckets, perm = bucket_sort_permutation(
            [torch.from_numpy(w) for w in hw],
            [torch.from_numpy(w) for w in ow], num_buckets)
        assert np.array_equal(ours.perm, perm.numpy())
        assert np.array_equal(ours.buckets_sorted, buckets.numpy()[perm])

    def test_capacity_is_the_largest_exchange_slice(self, mesh):
        keys, num_buckets, _ = _shuffle_case("skewed")
        hw, ow = _words(keys[0])
        ours, _ = tpar.bucket_shuffle([hw], [ow], num_buckets, mesh)
        assert ours.capacity == 250  # each source sends its 250 rows to one
        assert sorted(ours.device_row_counts.tolist())[-1] == 2_000

    def test_distributed_build_permutation_is_the_jax_one(self, mesh, jmesh):
        rng = np.random.default_rng(4)
        table = pa.table({"k": rng.integers(0, 200, size=4_000),
                          "v": rng.normal(size=4_000)})
        b_ours, p_ours = tpar.distributed_bucket_sort_permutation(
            table, ["k"], 16, mesh)
        b_theirs, p_theirs = jpar.distributed_bucket_sort_permutation(
            table, ["k"], 16, jmesh)
        assert np.array_equal(b_ours, b_theirs)
        assert np.array_equal(p_ours, p_theirs)


# ---------------------------------------------------------------------------
# The sharded route + partition of a spill chunk
# ---------------------------------------------------------------------------
class TestMeshRoutePartition:
    @pytest.mark.parametrize("n, tied", [(8, False), (37, False),
                                         (1000, False), (4096, False),
                                         (4096, True)])
    def test_bit_equal_to_the_jax_mesh_and_the_single_device(
            self, mesh, jmesh, n, tied):
        """``tied``: three code values per key column, so the global row
        id decides most ties."""
        from hyperspace_tpu.parallel.sharded_build import (
            mesh_route_partition as jax_route,
        )
        from hyperspace_tpu_torch.ops.hash import route_partition

        rng = np.random.default_rng(n)
        hw = [rng.integers(0, 2**32, size=(n, 2), dtype=np.uint32)
              for _ in range(2)]
        codes = [rng.integers(0, 3 if tied else 2**64, size=n,
                              dtype=np.uint64) for _ in range(2)]
        words = [split_words64(c) for c in codes]
        perm, counts = tpar.mesh_route_partition(hw, words, 16, mesh)
        b_jax, p_jax = jax_route(hw, words, 16, jmesh, pad_to=64)
        assert np.array_equal(perm, p_jax)
        assert np.array_equal(counts, np.bincount(b_jax, minlength=16))
        p_one, c_one = route_partition(hw, words, 16, CPU)
        assert np.array_equal(perm, p_one) and np.array_equal(counts, c_one)
        assert perm.dtype == counts.dtype == np.int64

    def test_grouped_only_mode_is_bit_equal(self, mesh, jmesh):
        """Rank-mapped keys route without order words: row order within
        each bucket survives the mesh."""
        from hyperspace_tpu.parallel.sharded_build import (
            mesh_route_partition as jax_route,
        )

        hw = [np.random.default_rng(5).integers(
            0, 2**32, size=(513, 2), dtype=np.uint32)]
        perm, counts = tpar.mesh_route_partition(hw, [], 12, mesh)
        b_jax, p_jax = jax_route(hw, [], 12, jmesh, pad_to=64)
        assert np.array_equal(perm, p_jax)
        assert np.array_equal(counts, np.bincount(b_jax, minlength=12))

    def test_one_attributed_pull_per_shard(self, mesh, armed_guard,
                                           pulled_sites):
        hw = [np.random.default_rng(9).integers(
            0, 2**32, size=(256, 2), dtype=np.uint32)]
        before = {k: _snap(k) for k in ("exec.mesh.gather.pulls",
                                        "exec.mesh.route.chunks")}
        tpar.mesh_route_partition(hw, [], 16, mesh)
        assert _snap("exec.mesh.gather.pulls") \
            == before["exec.mesh.gather.pulls"] + 8
        assert _snap("exec.mesh.route.chunks") \
            == before["exec.mesh.route.chunks"] + 1
        assert metrics.snapshot()["exec.mesh.devices"] == 8
        # The read-back of the count matrix, then one gather per shard.
        assert pulled_sites == ["mesh.route.counts"] + [
            f"mesh.route.gather.d{d}" for d in range(8)]

    def test_mod_ownership_covers_every_bucket(self, mesh):
        from hyperspace_tpu_torch.ops.hash import bucket_ids_np

        hw = [np.random.default_rng(11).integers(
            0, 2**32, size=(512, 2), dtype=np.uint32)]
        perm, counts = tpar.mesh_route_partition(hw, [], 20, mesh)
        buckets = bucket_ids_np(hw, 20)
        assert np.all(np.diff(buckets[perm]) >= 0)
        assert np.array_equal(np.sort(perm), np.arange(512))
        assert np.array_equal(counts, np.bincount(buckets, minlength=20))

    def test_zero_rows(self, mesh):
        perm, counts = tpar.mesh_route_partition(
            [np.empty((0, 2), np.uint32)], [], 16, mesh)
        assert perm.size == 0 and counts.tolist() == [0] * 16


# ---------------------------------------------------------------------------
# The co-partitioned join
# ---------------------------------------------------------------------------
def _sorted_triples(dev, li, ri):
    return sorted(zip(np.asarray(dev).tolist(), np.asarray(li).tolist(),
                      np.asarray(ri).tolist()))


class TestCopartitionedJoin:
    def test_dense_matches_numpy_and_the_jax_join(self, mesh, jmesh):
        rng = np.random.default_rng(5)
        left = np.stack([rng.integers(0, 40, size=64) * 8 + d
                         for d in range(8)])
        right = np.stack([rng.integers(0, 40, size=96) * 8 + d
                          for d in range(8)])
        li, ri = tpar.copartitioned_join(left, right, mesh)
        lk, rk = left.reshape(-1), right.reshape(-1)
        assert sorted(zip(lk[li].tolist(), rk[ri].tolist())) \
            == sorted((a, b) for a in lk for b in rk if a == b)
        with enable_x64():
            jli, jri = jpar.copartitioned_join(left, right, jmesh)
        assert np.array_equal(li, jli) and np.array_equal(ri, jri)

    @pytest.mark.parametrize("dtype", [np.int64, np.float64])
    def test_ragged_shards(self, mesh, jmesh, dtype):
        rng = np.random.default_rng(6)
        left = [(rng.integers(0, 30, size=int(rng.integers(1, 50))) * 8
                 + d).astype(dtype) for d in range(8)]
        right = [(rng.integers(0, 30, size=int(rng.integers(1, 70))) * 8
                  + d).astype(dtype) for d in range(8)]
        dev, ll, rl = tpar.copartitioned_join_ragged(left, right, mesh)
        assert _sorted_triples(dev, ll, rl) == sorted(
            (d, a, b) for d in range(8)
            for a, lv in enumerate(left[d])
            for b, rv in enumerate(right[d]) if lv == rv)
        jdev, jll, jrl = jpar.copartitioned_join_ragged(left, right, jmesh)
        assert np.array_equal(dev, jdev)
        assert np.array_equal(ll, jll) and np.array_equal(rl, jrl)

    def test_nan_and_inf_keys(self, mesh, jmesh):
        """Shards hold only their keys, so no padding slot can enter an
        inf or NaN key's match window; -0.0 matches 0.0."""
        left = [np.array([np.inf, 0.0])] + [np.array([float(d)])
                                           for d in range(1, 8)]
        right = [np.array([np.inf, np.nan, -0.0])] + \
            [np.array([float(d)] * 4) for d in range(1, 8)]
        dev, ll, rl = tpar.copartitioned_join_ragged(left, right, mesh)
        for d, a, b in zip(dev, ll, rl):
            assert a < len(left[d]) and b < len(right[d])
        want = sorted((d, a, b) for d in range(8)
                      for a, lv in enumerate(left[d])
                      for b, rv in enumerate(right[d]) if lv == rv)
        assert _sorted_triples(dev, ll, rl) == want
        assert _sorted_triples(*jpar.copartitioned_join_ragged(
            left, right, jmesh)) == want

    def test_no_matches(self, mesh):
        li, ri = tpar.copartitioned_join(np.zeros((8, 4), np.int64),
                                         np.ones((8, 4), np.int64), mesh)
        assert li.size == 0 and ri.size == 0

    def test_sorted_equi_join_mesh_is_the_jax_match_set(self, mesh, jmesh):
        from hyperspace_tpu.ops.join import sorted_equi_join_mesh as jax_join
        from hyperspace_tpu_torch.ops.join import (
            sorted_equi_join_mesh,
            sorted_equi_join_np,
        )

        rng = np.random.default_rng(3)
        lk = rng.integers(0, 200, size=4_000).astype(np.int64)
        rk = rng.integers(0, 200, size=1_500).astype(np.int64)
        li, ri = sorted_equi_join_mesh(lk, rk, mesh)
        jli, jri = jax_join(lk, rk, jmesh)
        assert np.array_equal(li, jli) and np.array_equal(ri, jri)
        hli, hri = sorted_equi_join_np(lk, rk)
        assert sorted(zip(li.tolist(), ri.tolist())) \
            == sorted(zip(hli.tolist(), hri.tolist()))


# ---------------------------------------------------------------------------
# The filter, the grouped aggregate and the join -> aggregate
# ---------------------------------------------------------------------------
class TestMeshFilter:
    def test_mask_is_the_single_device_and_the_jax_mesh_mask(self, mesh,
                                                             jmesh):
        from hyperspace_tpu.ops.filter import compile_predicate as jax_pred
        from hyperspace_tpu.plan.expr import col as jcol
        from hyperspace_tpu.plan.expr import lit as jlit
        from hyperspace_tpu_torch.ops.filter import compile_predicate
        from hyperspace_tpu_torch.plan.expr import col, lit

        rng = np.random.default_rng(5)
        n = 10_003  # not a multiple of 8
        a, b = rng.integers(0, 200, n), rng.random(n)
        fn, literals = compile_predicate(
            (col("a") >= lit(100)) & (col("b") < lit(0.5)), ["a", "b"])
        got = tpar.eval_predicate_on_mesh(fn, [a, b], literals, mesh)
        want = fn([torch.from_numpy(a), torch.from_numpy(b)], literals)
        assert got.shape == (n,) and np.array_equal(got, want.numpy())
        jfn, jlits = jax_pred(
            (jcol("a") >= jlit(100)) & (jcol("b") < jlit(0.5)), ["a", "b"])
        with enable_x64():
            theirs = jpar.eval_predicate_on_mesh(jfn, [a, b], jlits, jmesh)
        assert np.array_equal(got, theirs)


def _aggregate_inputs(n=4_000, keys=1):
    rng = np.random.default_rng(4)
    key_cols = [rng.integers(0, 113, size=n).astype(np.int64)]
    if keys == 2:
        key_cols.append(rng.integers(-2, 3, size=n).astype(np.int64))
    ints = rng.integers(0, 10_000, size=n).astype(np.int64)
    floats = rng.random(n) * 1e4
    return key_cols, ["sum", "count_all", "min", "max", "mean", "sum"], \
        [ints, ints, ints, floats, floats]


def _same_results(ours, theirs, rtol=RTOL):
    for a, b in zip(ours, theirs):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
        else:
            assert np.array_equal(a, b)


class TestMeshAggregate:
    @pytest.mark.parametrize("keys", [1, 2])
    def test_single_device_and_jax_mesh_agree(self, mesh, jmesh, keys):
        from hyperspace_tpu.ops.aggregate import (
            grouped_aggregate_mesh as jax_mesh_agg,
        )
        from hyperspace_tpu_torch.ops.aggregate import (
            grouped_aggregate,
            grouped_aggregate_mesh,
        )

        key_cols, ops, values = _aggregate_inputs(keys=keys)
        f1, c1, r1 = grouped_aggregate(key_cols, values, ops, device=CPU)
        f2, c2, r2 = grouped_aggregate_mesh(key_cols, values, ops, mesh)
        assert np.array_equal(f1, f2) and np.array_equal(c1, c2)
        _same_results(r2, r1, rtol=0)  # same rows, same order: bit for bit
        kw = [np.asarray(jcolumnar.to_order_words(
            pa.chunked_array([pa.array(k)]))) for k in key_cols]
        f3, c3, r3 = jax_mesh_agg(kw, values, ops, jmesh, pad_to=64)
        assert np.array_equal(f2, f3) and np.array_equal(c2, c3)
        _same_results(r2, r3)

    def test_zero_rows_and_bad_op(self, mesh):
        first, counts, results = tpar.mesh_grouped_aggregate(
            [np.empty(0, np.int64)], [], ["count_all"], mesh)
        assert first.size == counts.size == 0 and len(results) == 1
        with pytest.raises(ValueError):
            tpar.mesh_grouped_aggregate([np.arange(3)], [np.arange(3)],
                                        ["median"], mesh)

    def test_each_group_is_reduced_on_one_shard(self, mesh):
        from hyperspace_tpu_torch.parallel.aggregate import key_owner

        key_cols, _, _ = _aggregate_inputs()
        owner = key_owner(key_cols, 8)
        for k in np.unique(key_cols[0]):
            assert len(np.unique(owner[key_cols[0] == k])) == 1
        assert len(np.unique(owner)) == 8


class TestJoinGroupAggregateMesh:
    def test_fused_and_jax_mesh_agree(self, mesh, jmesh):
        from hyperspace_tpu.ops.filter import build_value_fn as jax_value_fn
        from hyperspace_tpu.ops.join_agg import (
            join_group_aggregate_mesh as jax_mesh_join_agg,
        )
        from hyperspace_tpu.plan.expr import Col as JCol
        from hyperspace_tpu.plan.expr import Lit as JLit
        from hyperspace_tpu_torch.ops.filter import build_value_fn
        from hyperspace_tpu_torch.ops.join_agg import (
            join_group_aggregate,
            join_group_aggregate_mesh,
        )
        from hyperspace_tpu_torch.plan.expr import Col, Lit

        rng = np.random.default_rng(6)
        l_key = rng.integers(0, 400, size=3_000).astype(np.int64)
        r_key = np.arange(400, dtype=np.int64)
        group = rng.integers(0, 7, size=400).astype(np.int64)
        qty = rng.integers(1, 50, size=3_000).astype(np.int64)
        price = rng.random(3_000) * 1e3
        columns = [l_key, qty, price, r_key, group]
        sides = ["l", "l", "l", "r", "r"]
        names = ["l_key", "qty", "price", "r_key", "group"]
        ops = ["sum", "count_all", "sum", "max"]
        fns, lits = zip(build_value_fn(Col("qty"), names),
                        build_value_fn(Col("price") * (Lit(1) - Col("qty")),
                                       names),
                        build_value_fn(Col("price"), names))
        jfns, jlits = zip(jax_value_fn(JCol("qty"), names),
                          jax_value_fn(JCol("price") * (JLit(1)
                                                        - JCol("qty")),
                                       names),
                          jax_value_fn(JCol("price"), names))
        fused = join_group_aggregate(l_key, r_key, columns, sides, [4], ops,
                                     fns, lits, device=CPU)
        ours = join_group_aggregate_mesh(l_key, r_key, columns, sides, [4],
                                         ops, fns, lits, mesh)
        theirs = jax_mesh_join_agg(l_key, r_key, columns, sides, [4], ops,
                                   jfns, jlits, jmesh, pad_to=64)
        for other in (fused, theirs):
            # Same groups in the same order (any row of a group is a
            # witness of its key), the same counts and reductions.
            assert np.array_equal(group[ours[1]], group[np.asarray(other[1])])
            assert np.array_equal(ours[2], np.asarray(other[2]))
            _same_results(ours[3], other[3])

    def test_no_match(self, mesh):
        from hyperspace_tpu_torch.ops.join_agg import join_group_aggregate_mesh

        out = join_group_aggregate_mesh(
            np.arange(3), np.arange(10, 13), [np.arange(3), np.arange(3)],
            ["l", "r"], [1], ["count_all"], [], [], mesh)
        assert [len(a) for a in out[:3]] == [0, 0, 0]


def test_mesh_programs_attribute_to_every_shard(mesh):
    """With the timeline on, a mesh program's ms lands on every mesh
    position's ``exec.device.<position>.kernel_ms``."""
    from hyperspace_tpu_torch.ops.join import sorted_equi_join_mesh

    rng = np.random.default_rng(8)
    lk = rng.integers(0, 50, size=512).astype(np.int64)
    rk = rng.integers(0, 50, size=512).astype(np.int64)
    timeline.enable_timeline()
    try:
        before = metrics.snapshot()
        sorted_equi_join_mesh(lk, rk, mesh)
        tpar.mesh_route_partition([_words(lk)[0]], [], 16, mesh)
        after = metrics.snapshot()
    finally:
        timeline.disable_timeline()
    for name in ("mesh_join", "mesh_route"):
        key = f"exec.kernel.{name}.device_ms"
        count = before.get(key, {"count": 0})["count"]
        assert after[key]["count"] == count + 1
    for d in range(8):
        key = f"exec.device.{d}.kernel_ms"
        assert after.get(key, 0) > before.get(key, 0), key
