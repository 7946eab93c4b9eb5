"""The device column cache of hyperspace_tpu_torch (on the CPU) against
the JAX package's (execution/device_cache.py and the executor's
residency routing).

Every test of tests/test_device_cache.py but the three window tests
(tests/test_torch_window.py holds those), and the residency tests of
tests/test_join_agg.py, run here as one sequence of queries through
both packages over the same data, each package with its own copy of
the files and its own system path.  Both sessions get the same explicit
thresholds: the cold ones the JAX package's static 2**26 rows (what it
uses without calibration), the resident ones as each JAX test sets
them, and no mesh on the JAX side.  After every collect the two must
agree on the rows in order (floats within 1e-9 relative), the
strategies and ``resident`` flags of every filter, join kernel, join
and aggregate, and the collect's ``device_cache`` hits and misses; then
the JAX test's own assertions are made on the port's run.

The port-only tests run each device query kind cold and then warm twice
and hold every cached tensor to its checksum (no consumer may write into
a cached column), show that the cache key names the device, and count
the LRU's books under 8 threads."""

import hashlib
import os
import random
import sys
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.execution import device_cache as jax_cache
from hyperspace_tpu_torch.execution import device_cache as torch_cache

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
COLD = 1 << 26
NEVER = 1 << 60
RTOL = 1e-9


def _clear_caches():
    jax_cache.global_cache().clear()
    torch_cache.global_cache().clear()


@pytest.fixture(autouse=True)
def _empty_caches():
    _clear_caches()
    yield
    _clear_caches()


def _name(pkg) -> str:
    return "jax" if pkg is hyperspace_tpu else "torch"


def _session(pkg, system_path, policy="eager", resident=1, cold=COLD):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = pkg.HyperspaceSession(system_path=system_path, **kw)
    if pkg is hyperspace_tpu:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    s.conf.device_filter_min_rows = cold
    s.conf.device_join_min_rows = cold
    s.conf.device_agg_min_rows = cold
    s.conf.device_cache_policy = policy
    s.conf.device_resident_min_rows = resident
    if pkg is hyperspace_tpu_torch:
        # The device build (the CPU default takes the host mirror).
        s.conf.device_build_min_rows = 0
    return s


def _view(stats) -> dict:
    """What the two packages must agree on after a collect."""
    out = {k: [(d["strategy"], d.get("resident")) for d in stats.get(k, [])]
           for k in ("filters", "join_kernels", "joins", "aggregates")}
    out["device_cache"] = stats.get("device_cache")
    return out


def _assert_same_rows(got, want, label=""):
    assert got.column_names == want.column_names, label
    assert got.schema.equals(want.schema), (label, got.schema, want.schema)
    assert got.num_rows == want.num_rows, label
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(), rtol=RTOL,
                                       err_msg=f"{label} {name}")
        else:
            assert g.to_pylist() == w.to_pylist(), (label, name)


class Trace:
    """The collects of one package's run, each with its ``_view``."""

    def __init__(self, session) -> None:
        self.session = session
        self.steps = []

    def collect(self, ds):
        table = ds.collect()
        self.steps.append((table, _view(self.session.last_execution_stats)))
        return table

    def view(self, i: int = -1) -> dict:
        return self.steps[i][1]


def _both(tmp_path, make_data, run, **session_kw) -> Trace:
    """``run(pkg, session, data, trace)`` through each package over its
    own copy of ``make_data(root)``; the two traces must agree step by
    step.  Returns the port's trace."""
    traces = []
    for pkg in PKGS:
        root = str(tmp_path / _name(pkg))
        os.makedirs(root)
        data = make_data(root)
        s = _session(pkg, os.path.join(root, "ix"), **session_kw)
        trace = Trace(s)
        run(pkg, s, data, trace)
        traces.append(trace)
    jax_trace, port_trace = traces
    assert len(port_trace.steps) == len(jax_trace.steps)
    for i, ((jt, jv), (tt, tv)) in enumerate(zip(jax_trace.steps,
                                                port_trace.steps)):
        assert tv == jv, (i, tv, jv)
        _assert_same_rows(tt, jt, f"step {i}")
    return port_trace


# ---------------------------------------------------------------------------
# the LRU and the fingerprint (tests/test_device_cache.py TestLRU,
# TestFingerprint)
# ---------------------------------------------------------------------------
def _lru_pair():
    """(cache, value of n bytes, key) of each package."""
    return [(jax_cache.DeviceColumnCache(),
             lambda n: np.empty(n, dtype=np.uint8),
             lambda *k: k),
            (torch_cache.DeviceColumnCache(),
             lambda n: torch.empty(n, dtype=torch.uint8),
             lambda *k: ("cpu",) + k)]


def _lru_stats(cache) -> dict:
    return {k: v for k, v in cache.stats().items() if k != "rejected"}


def test_byte_budget_evicts_lru():
    seen = []
    for c, value, key in _lru_pair():
        c.put(key("f", "a", "num"), value(400), budget_bytes=1000)
        c.put(key("f", "b", "num"), value(400), budget_bytes=1000)
        assert c.get(key("f", "a", "num")) is not None  # a most recent
        c.put(key("f", "c", "num"), value(400), budget_bytes=1000)
        assert c.get(key("f", "b", "num")) is None  # b was LRU: evicted
        assert c.get(key("f", "a", "num")) is not None
        assert c.get(key("f", "c", "num")) is not None
        assert c.stats()["evictions"] == 1
        assert c.bytes_cached == 800
        seen.append(_lru_stats(c))
    assert seen[0] == seen[1]


def test_oversize_entry_rejected():
    seen = []
    for c, value, key in _lru_pair():
        c.put(key("f", "a", "num"), value(2000), budget_bytes=1000)
        assert c.stats()["entries"] == 0
        assert c.was_rejected(key("f", "a", "num"))
        seen.append(_lru_stats(c))
    assert seen[0] == seen[1]


def test_contains_does_not_skew_hit_stats():
    seen = []
    for c, value, key in _lru_pair():
        c.put(key("f", "a", "num"), value(10), budget_bytes=100)
        assert c.contains(key("f", "a", "num"))
        assert not c.contains(key("f", "b", "num"))
        assert c.stats()["hits"] == 0 and c.stats()["misses"] == 0
        seen.append(_lru_stats(c))
    assert seen[0] == seen[1]


def test_fingerprint_changes_with_content_identity(tmp_path):
    p = tmp_path / "x.parquet"
    p.write_bytes(b"aaaa")
    fp1 = torch_cache.files_fingerprint([str(p)])
    assert fp1 == torch_cache.files_fingerprint([str(p)])
    assert fp1 == jax_cache.files_fingerprint([str(p)])
    p.write_bytes(b"bbbbbb")  # size and mtime change
    fp2 = torch_cache.files_fingerprint([str(p)])
    assert fp2 != fp1
    assert fp2 == jax_cache.files_fingerprint([str(p)])


def test_fingerprint_of_a_missing_file_is_none(tmp_path):
    gone = [str(tmp_path / "gone.parquet")]
    assert torch_cache.files_fingerprint(gone) is None
    assert jax_cache.files_fingerprint(gone) is None


# ---------------------------------------------------------------------------
# residency through the executor (tests/test_device_cache.py)
# ---------------------------------------------------------------------------
def _env_data(root: str) -> str:
    data = os.path.join(root, "data")
    os.makedirs(data)
    rng = np.random.default_rng(2)
    n = 20_000
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "g": pa.array((np.arange(n) % 64).astype(np.int64)),
        "v": pa.array(rng.random(n)),
    }), os.path.join(data, "p.parquet"))
    return data


def test_warm_repeat_filter_fires_resident_device_path(tmp_path):
    def run(pkg, s, data, trace):
        q = s.read.parquet(data).filter(pkg.col("k") >= 19_000)
        trace.collect(q)
        trace.collect(q)
        s.conf.device_cache_policy = "off"
        s.conf.device_filter_min_rows = NEVER
        trace.collect(q)

    t = _both(tmp_path, _env_data, run)
    assert t.view(0)["filters"] == [("device", False)]
    assert t.view(0)["device_cache"] == {"hits": 0, "misses": 1}
    assert t.view(1)["filters"] == [("device", True)]
    assert t.view(1)["device_cache"] == {"hits": 1, "misses": 0}
    assert t.steps[0][0].equals(t.steps[1][0])
    assert t.view(2)["filters"] == [("host", None)]
    assert sorted(t.steps[2][0].column("k").to_pylist()) \
        == sorted(t.steps[1][0].column("k").to_pylist())


def test_auto_policy_populates_only_when_device_path_runs(tmp_path):
    def run(pkg, s, data, trace):
        c = pkg.col
        s.conf.device_cache_policy = "auto"
        s.conf.device_filter_min_rows = NEVER
        trace.collect(s.read.parquet(data).filter(c("k") >= 100))
        s.conf.device_filter_min_rows = 1
        trace.collect(s.read.parquet(data).filter(c("k") >= 100))
        # The cold threshold raised again: residency routes the repeat.
        s.conf.device_filter_min_rows = NEVER
        trace.collect(s.read.parquet(data).filter(c("k") >= 200))

    t = _both(tmp_path, _env_data, run)
    assert t.view(0)["device_cache"] is None
    assert t.view(0)["filters"] == [("host", None)]
    assert t.view(1)["device_cache"]["misses"] == 1
    assert t.view(2)["filters"] == [("device", True)]
    assert t.view(2)["device_cache"]["hits"] == 1


def test_warm_repeat_aggregate_resident(tmp_path):
    def run(pkg, s, data, trace):
        q = (s.read.parquet(data).group_by("g")
             .agg(total=("v", "sum"), n=("k", "count")).sort("g"))
        trace.collect(q)
        trace.collect(q)
        s.conf.device_cache_policy = "off"
        s.conf.device_agg_min_rows = NEVER
        trace.collect(q)

    t = _both(tmp_path, _env_data, run)
    assert t.view(0)["aggregates"] == [("device-segment", False)]
    assert t.view(1)["aggregates"] == [("device-segment", True)]
    assert t.view(1)["device_cache"]["hits"] == 2  # group key + value
    first, second, host = (step[0] for step in t.steps)
    assert first.column("g").equals(second.column("g"))
    np.testing.assert_allclose(first.column("total").to_numpy(),
                               second.column("total").to_numpy())
    assert t.view(2)["aggregates"] == []
    np.testing.assert_allclose(host.column("total").to_numpy(),
                               second.column("total").to_numpy())
    assert host.column("n").equals(second.column("n"))


def test_file_change_invalidates_residency(tmp_path):
    def run(pkg, s, data, trace):
        q = s.read.parquet(data).filter(pkg.col("k") >= 19_000)
        trace.collect(q)
        trace.collect(q)
        # A file appended: the scan's fingerprint changes, and nothing
        # cached for the old file set may answer.
        pq.write_table(pa.table({
            "k": pa.array([1_000_000], type=pa.int64()),
            "g": pa.array([0], type=pa.int64()),
            "v": pa.array([0.5]),
        }), os.path.join(data, "p2.parquet"))
        trace.collect(q)

    t = _both(tmp_path, _env_data, run)
    n1 = t.steps[0][0].num_rows
    assert t.steps[1][0].num_rows == n1
    assert t.view(1)["filters"] == [("device", True)]
    assert t.steps[2][0].num_rows == n1 + 1
    assert t.view(2)["filters"] == [("device", False)]


def test_computed_agg_inputs_never_served_stale(tmp_path):
    """Two expression aggregates over the same files never share a
    cached hidden column."""
    def run(pkg, s, data, trace):
        for mult in (2, 4):
            trace.collect(s.read.parquet(data).group_by("g")
                          .agg(total=(pkg.col("v") * mult, "sum")).sort("g"))

    t = _both(tmp_path, _env_data, run)
    a, b = t.steps[0][0], t.steps[1][0]
    np.testing.assert_allclose(b.column("total").to_numpy(),
                               2 * a.column("total").to_numpy())


def test_cache_off_policy_unchanged_behavior(tmp_path):
    def run(pkg, s, data, trace):
        s.conf.device_filter_min_rows = 1
        trace.collect(s.read.parquet(data).filter(pkg.col("k") >= 100))

    t = _both(tmp_path, _env_data, run, policy="off")
    assert t.steps[0][0].num_rows == 20_000 - 100
    assert t.view(0)["filters"] == [("device", False)]
    assert torch_cache.global_cache().stats()["entries"] == 0
    assert jax_cache.global_cache().stats()["entries"] == 0


def test_eager_policy_ignores_uncacheable_computed_inputs(tmp_path):
    """Eager does not lower the threshold of an aggregate whose
    expression input can never be cached."""
    def run(pkg, s, data, trace):
        trace.collect(s.read.parquet(data).group_by("g")
                      .agg(total=(pkg.col("v") * 2, "sum")))

    t = _both(tmp_path, _env_data, run)
    assert t.view(0)["aggregates"] == []  # arrow's group-by


def test_eager_stops_lowering_after_budget_rejection(tmp_path):
    """A column too big for the budget is rejected once; eager then stops
    routing repeats to the device."""
    def run(pkg, s, data, trace):
        s.conf.device_cache_bytes = 1024  # under any 20,000-row column
        q = s.read.parquet(data).filter(pkg.col("k") >= 19_000)
        trace.collect(q)
        trace.collect(q)

    t = _both(tmp_path, _env_data, run)
    assert [step[0].num_rows for step in t.steps] == [1000, 1000]
    assert t.view(0)["filters"] == [("device", False)]
    assert t.view(1)["filters"] == [("host", None)]


def test_refresh_rebuild_invalidates_index_residency(tmp_path):
    """A full refresh writes a new version directory: the query's file
    list (so its fingerprint) changes, and the answer follows the data."""
    n = 20_000

    def make_data(root):
        data = os.path.join(root, "data")
        os.makedirs(data)
        pq.write_table(pa.table({
            "k": pa.array(np.arange(n, dtype=np.int64)),
            "v": pa.array(np.arange(n, dtype=np.int64) % 5),
        }), os.path.join(data, "p.parquet"))
        return data

    def run(pkg, s, data, trace):
        s.conf.num_buckets = 2
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(data), pkg.IndexConfig("rix", ["k"], ["v"]))
        s.enable_hyperspace()
        _clear_caches()
        q = s.read.parquet(data).filter(pkg.col("k") >= n - 100).select("k", "v")
        trace.collect(q)
        trace.collect(q)  # warm: resident on the index files
        pq.write_table(pa.table({
            "k": pa.array(np.arange(n, n + 50, dtype=np.int64)),
            "v": pa.array(np.zeros(50, dtype=np.int64)),
        }), os.path.join(data, "p2.parquet"))
        hs.refresh_index("rix", mode="full")
        trace.collect(q)

    t = _both(tmp_path, make_data, run)
    assert [step[0].num_rows for step in t.steps] == [100, 100, 150]
    assert t.view(1)["filters"] == [("device", True)]
    assert t.view(2)["filters"] == [("device", False)]


def test_dataset_cache_materializes(tmp_path):
    def make_data(root):
        d = os.path.join(root, "data")
        os.makedirs(d)
        pq.write_table(pa.table({"k": pa.array([1, 2, 3], type=pa.int64())}),
                       os.path.join(d, "p.parquet"))
        return d

    def run(pkg, s, d, trace):
        c = pkg.col
        cached = s.read.parquet(d).filter(c("k") > 1).cache()
        trace.collect(cached)
        # Like a cached RDD: a later file does not reach it.
        pq.write_table(pa.table({"k": pa.array([9], type=pa.int64())}),
                       os.path.join(d, "p2.parquet"))
        trace.collect(cached)
        trace.collect(s.read.parquet(d).filter(c("k") > 1))
        trace.collect(cached.filter(c("k") == 3))

    t = _both(tmp_path, make_data, run)
    assert [step[0].num_rows for step in t.steps] == [2, 2, 3, 1]


def test_cached_dataset_self_join_uniquifies(tmp_path):
    """A cached Dataset on both sides of a join: the optimizer gives each
    side its own InMemory node over the one shared table."""
    def make_data(root):
        d = os.path.join(root, "data")
        os.makedirs(d)
        pq.write_table(pa.table({"k": pa.array([1, 2, 3], type=pa.int64()),
                                 "v": pa.array([10, 20, 30], type=pa.int64())}),
                       os.path.join(d, "p.parquet"))
        return d

    def run(pkg, s, d, trace):
        c = s.read.parquet(d).cache()
        joined = c.join(c, pkg.col("k") == pkg.col("k"))
        leaves = []

        def walk(p):
            if type(p).__name__ == "InMemory":
                leaves.append(p)
            for ch in p.children:
                walk(ch)

        walk(joined.optimized_plan())
        assert len(leaves) == 2
        assert leaves[0] is not leaves[1]
        assert leaves[0].table is leaves[1].table
        trace.collect(joined)

    t = _both(tmp_path, make_data, run)
    assert t.steps[-1][0].num_rows == 3


def _join_data(root: str):
    left_dir = os.path.join(root, "orders")
    right_dir = os.path.join(root, "lineitem")
    os.makedirs(left_dir)
    os.makedirs(right_dir)
    rng = np.random.default_rng(5)
    n_o, n_l = 8_000, 30_000
    pq.write_table(pa.table({
        "o_orderkey": pa.array(np.arange(n_o, dtype=np.int64)),
        "o_totalprice": pa.array(rng.random(n_o) * 100_000),
    }), os.path.join(left_dir, "p.parquet"))
    pq.write_table(pa.table({
        "l_orderkey": pa.array(rng.integers(0, n_o, n_l).astype(np.int64)),
        "l_quantity": pa.array(rng.integers(1, 50, n_l).astype(np.int64)),
    }), os.path.join(right_dir, "p.parquet"))
    return left_dir, right_dir


def _join_q(pkg, s, dirs, price_cap=20_000.0):
    left_dir, right_dir = dirs
    c = pkg.col
    return (s.read.parquet(left_dir).filter(c("o_totalprice") < price_cap)
            .join(s.read.parquet(right_dir),
                  c("o_orderkey") == c("l_orderkey")))


def test_warm_repeat_join_fires_resident_device_path(tmp_path):
    def run(pkg, s, dirs, trace):
        trace.collect(_join_q(pkg, s, dirs))
        trace.collect(_join_q(pkg, s, dirs))
        s.conf.device_cache_policy = "off"
        s.conf.device_join_min_rows = NEVER
        trace.collect(_join_q(pkg, s, dirs))

    t = _both(tmp_path, _join_data, run)
    assert t.view(0)["join_kernels"] == [("device", False)]
    # Both key columns, one of them filter-derived, from the cache.
    assert t.view(1)["join_kernels"] == [("device", True)]
    assert t.view(1)["device_cache"]["hits"] >= 2
    assert t.view(1)["device_cache"]["misses"] == 0
    assert t.steps[0][0].num_rows == t.steps[1][0].num_rows
    assert t.view(2)["join_kernels"] == [("host", False)]
    assert sorted(t.steps[2][0].column("l_quantity").to_pylist()) \
        == sorted(t.steps[1][0].column("l_quantity").to_pylist())


def test_changed_filter_predicate_never_serves_stale_join(tmp_path):
    def run(pkg, s, dirs, trace):
        trace.collect(_join_q(pkg, s, dirs, 20_000.0))
        trace.collect(_join_q(pkg, s, dirs, 20_000.0))
        # Another predicate: another derived identity, so the filtered
        # key column is uploaded again, never taken from the old rows.
        trace.collect(_join_q(pkg, s, dirs, 60_000.0))
        s.conf.device_cache_policy = "off"
        s.conf.device_join_min_rows = NEVER
        trace.collect(_join_q(pkg, s, dirs, 60_000.0))

    t = _both(tmp_path, _join_data, run)
    assert t.view(1)["join_kernels"] == [("device", True)]
    assert t.view(2)["join_kernels"] == [("device", False)]
    assert t.steps[2][0].num_rows > t.steps[1][0].num_rows
    assert t.steps[3][0].num_rows == t.steps[2][0].num_rows


def test_null_keys_resident_join_matches_host(tmp_path):
    def make_data(root):
        _left, right_dir = _join_data(root)
        nl_dir = os.path.join(root, "orders_nulls")
        os.makedirs(nl_dir)
        keys = np.arange(8_000, dtype=np.int64)
        pq.write_table(pa.table({
            "o_orderkey": pa.array(
                [None if i % 7 == 0 else int(k) for i, k in enumerate(keys)],
                type=pa.int64()),
            "o_totalprice": pa.array(np.linspace(0, 100_000, 8_000)),
        }), os.path.join(nl_dir, "p.parquet"))
        return nl_dir, right_dir

    def run(pkg, s, dirs, trace):
        nl_dir, right_dir = dirs

        def q():
            return s.read.parquet(nl_dir).join(
                s.read.parquet(right_dir),
                pkg.col("o_orderkey") == pkg.col("l_orderkey"))

        trace.collect(q())
        trace.collect(q())
        s.conf.device_cache_policy = "off"
        s.conf.device_join_min_rows = NEVER
        trace.collect(q())

    t = _both(tmp_path, make_data, run)
    assert t.view(1)["join_kernels"] == [("device", True)]
    assert t.steps[0][0].num_rows == t.steps[1][0].num_rows \
        == t.steps[2][0].num_rows


# ---------------------------------------------------------------------------
# the fused join→aggregate (tests/test_join_agg.py)
# ---------------------------------------------------------------------------
def _tpch_data(root: str):
    orders = os.path.join(root, "orders")
    lineitem = os.path.join(root, "lineitem")
    os.makedirs(orders)
    os.makedirs(lineitem)
    rng = np.random.default_rng(11)
    n_o, n_l = 5_000, 40_000
    pq.write_table(pa.table({
        "o_orderkey": pa.array(np.arange(n_o, dtype=np.int64)),
        "o_shippriority": pa.array(rng.integers(0, 5, n_o).astype(np.int64)),
        "o_totalprice": pa.array(rng.random(n_o) * 100_000),
    }), os.path.join(orders, "p.parquet"))
    pq.write_table(pa.table({
        "l_orderkey": pa.array(rng.integers(0, n_o, n_l).astype(np.int64)),
        "l_extendedprice": pa.array(rng.random(n_l) * 1000),
        "l_discount": pa.array(rng.random(n_l) * 0.1),
        "l_quantity": pa.array(rng.integers(1, 50, n_l).astype(np.int64)),
    }), os.path.join(lineitem, "p.parquet"))
    return orders, lineitem


def _q3(pkg, s, dirs):
    """Q3 shape: a filtered side, the join key, an expression revenue."""
    orders, lineitem = dirs
    c = pkg.col
    return (s.read.parquet(orders).filter(c("o_totalprice") < 50_000.0)
            .join(s.read.parquet(lineitem), c("o_orderkey") == c("l_orderkey"))
            .group_by("o_orderkey", "o_shippriority")
            .agg(revenue=(c("l_extendedprice") * (1 - c("l_discount")), "sum"),
                 n=(c("l_quantity"), "count"),
                 qmax=(c("l_quantity"), "max"),
                 avg_price=(c("l_extendedprice"), "mean"))
            .sort("o_orderkey"))


def test_fused_warm_repeat_is_resident(tmp_path):
    def run(pkg, s, dirs, trace):
        trace.collect(_q3(pkg, s, dirs))
        trace.collect(_q3(pkg, s, dirs))

    t = _both(tmp_path, _tpch_data, run)
    assert t.view(0)["aggregates"] == [("device-join-agg", False)]
    # Every referenced column, the filter-derived orders side's too,
    # from the cache: nothing uploaded again.
    assert t.view(1)["aggregates"] == [("device-join-agg", True)]
    assert t.view(1)["joins"] == [("device-fused-agg", True)]
    assert t.view(1)["device_cache"]["misses"] == 0
    _assert_same_rows(t.steps[1][0], t.steps[0][0])


def test_off_policy_untouched_path(tmp_path):
    """With the cache off and the cold thresholds the fused path is not
    even attempted: the regular strategies are recorded."""
    def run(pkg, s, dirs, trace):
        trace.collect(_q3(pkg, s, dirs))

    t = _both(tmp_path, _tpch_data, run, policy="off")
    aggs, joins = t.view(0)["aggregates"], t.view(0)["joins"]
    assert not aggs or aggs[-1][0] != "device-join-agg"
    assert joins and joins[-1][0] != "device-fused-agg"


def test_small_join_keeps_normal_path_under_eager(tmp_path):
    """The footers' pre-gate: when even the largest side is under the
    lower of the cold and resident thresholds, the sides are not read
    for a doomed attempt."""
    def make_data(root):
        dirs = _tpch_data(root)
        small = os.path.join(root, "small")
        os.makedirs(small)
        pq.write_table(pa.table({
            "o_orderkey": pa.array([1, 2, 3], type=pa.int64()),
            "o_shippriority": pa.array([0, 1, 0], type=pa.int64()),
        }), os.path.join(small, "p.parquet"))
        return small, dirs[1]

    def run(pkg, s, dirs, trace):
        small, lineitem = dirs
        c = pkg.col
        trace.collect(s.read.parquet(small)
                      .join(s.read.parquet(lineitem),
                            c("o_orderkey") == c("l_orderkey"))
                      .group_by("o_shippriority")
                      .agg(n=(c("l_quantity"), "count"))
                      .sort("o_shippriority"))

    # The JAX package's static resident threshold of the fused path.
    t = _both(tmp_path, make_data, run, resident=1 << 20)
    aggs = t.view(0)["aggregates"]
    assert not aggs or aggs[-1][0] != "device-join-agg"


# ---------------------------------------------------------------------------
# port only
# ---------------------------------------------------------------------------
N_ORDERS = 1_000
N_LINEITEM = 4_000
NUM_BUCKETS = 16


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    """orders and lineitem in 4 files each, ``li_idx`` on ``l_orderkey``
    and ``ord_idx`` on ``o_orderkey``, 16 buckets, built by the port."""
    root = str(tmp_path_factory.mktemp("device_cache"))
    rng = np.random.default_rng(43)
    tables = {
        "orders": pa.table({
            "o_orderkey": rng.permutation(N_ORDERS).astype(np.int64),
            "o_custkey": rng.integers(0, 60, N_ORDERS),
            "o_totalprice": rng.random(N_ORDERS) * 1e4}),
        "lineitem": pa.table({
            "l_orderkey": rng.integers(0, N_ORDERS, N_LINEITEM),
            "l_quantity": rng.integers(1, 50, N_LINEITEM),
            "l_extendedprice": rng.random(N_LINEITEM) * 1e4,
            "l_discount": rng.random(N_LINEITEM) * 0.1})}
    paths = {}
    for name, table in tables.items():
        paths[name] = os.path.join(root, name)
        os.makedirs(paths[name])
        step = table.num_rows // 4
        for f in range(4):
            pq.write_table(table.slice(f * step, step),
                           os.path.join(paths[name], f"part-{f:05d}.parquet"))
    s = hyperspace_tpu_torch.HyperspaceSession(
        system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.num_buckets = NUM_BUCKETS
    # The device routes (the CPU defaults take the host).
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    hs = hyperspace_tpu_torch.Hyperspace(s)
    hs.create_index(s.read.parquet(paths["lineitem"]), hyperspace_tpu_torch.IndexConfig(
        "li_idx", ["l_orderkey"], ["l_quantity", "l_extendedprice", "l_discount"]))
    hs.create_index(s.read.parquet(paths["orders"]), hyperspace_tpu_torch.IndexConfig(
        "ord_idx", ["o_orderkey"], ["o_totalprice", "o_custkey"]))
    return os.path.join(root, "ix"), paths


def _kind_query(kind: str, s, paths):
    c = hyperspace_tpu_torch.col
    li = s.read.parquet(paths["lineitem"])
    orders = s.read.parquet(paths["orders"])
    revenue = c("l_extendedprice") * (1 - c("l_discount"))
    if kind == "filter":
        return li.filter((c("l_orderkey") >= 100) & (c("l_orderkey") < 700)) \
            .select("l_orderkey", "l_extendedprice")
    if kind in ("join", "bucketed_join"):
        return orders.filter(c("o_totalprice") < 6_000.0) \
            .join(li, c("o_orderkey") == c("l_orderkey")) \
            .select("o_orderkey", "o_totalprice", "l_quantity")
    if kind == "grouped_aggregate":
        return li.filter(c("l_orderkey") < 800).group_by("l_quantity") \
            .agg(total=("l_extendedprice", "sum"), low=("l_discount", "min"),
                 n=("l_orderkey", "count")).sort("l_quantity")
    assert kind == "fused_topn"
    return orders.filter(c("o_totalprice") < 6_000.0) \
        .join(li, c("o_orderkey") == c("l_orderkey")) \
        .group_by("o_custkey").agg(revenue=(revenue, "sum")) \
        .sort(("revenue", False)).limit(5)


KIND_ROUTES = {
    "filter": {"filters": ["device"]},
    "join": {"filters": ["device"], "join_kernels": ["device"],
             "joins": ["plain"]},
    "bucketed_join": {"filters": ["device"] * NUM_BUCKETS,
                      "join_kernels": ["device"] * NUM_BUCKETS,
                      "joins": ["bucketed"]},
    "grouped_aggregate": {"filters": ["device"],
                          "aggregates": ["device-segment"]},
    "fused_topn": {"filters": ["device"], "joins": ["device-fused-agg"],
                   "aggregates": ["device-join-agg"]},
}


def _checksums() -> dict:
    cache = torch_cache.global_cache()
    return {key: hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
            for key, t in list(cache._entries.items())}


@pytest.mark.parametrize("kind", sorted(KIND_ROUTES))
def test_every_device_query_kind_warm_equals_cold(indexed, kind):
    """Cold (an empty cache), then warm twice: the same answer, every
    device entry resident and no miss when warm, and not one byte of a
    cached column changed by the queries that read it."""
    system_path, paths = indexed
    s = hyperspace_tpu_torch.HyperspaceSession(system_path=system_path,
                                               device="cpu")
    s.conf.num_buckets = NUM_BUCKETS
    for k in ("filter", "join", "agg", "resident"):
        setattr(s.conf, f"device_{k}_min_rows", 0)  # the device routes
    if kind != "join":
        s.enable_hyperspace()
    ds = _kind_query(kind, s, paths)
    cold = ds.collect()
    stats = s.last_execution_stats
    assert cold.num_rows > 0
    routes = {k: [d["strategy"] for d in stats.get(k, [])]
              for k in KIND_ROUTES[kind]}
    assert routes == KIND_ROUTES[kind]
    assert stats["device_cache"]["hits"] == 0
    misses = stats["device_cache"]["misses"]
    assert misses > 0
    if kind == "bucketed_join":
        # Per bucket the price column and the two join keys: counted
        # exactly from 8 worker threads.
        assert stats["joins"][0]["buckets"] == NUM_BUCKETS
        assert misses == 3 * NUM_BUCKETS
    before = _checksums()
    assert len(before) == misses
    for _ in range(2):
        warm = ds.collect()
        stats = s.last_execution_stats
        assert warm.equals(cold)
        assert stats["device_cache"] == {"hits": misses, "misses": 0}
        for k in ("filters", "join_kernels", "aggregates"):
            for d in stats.get(k, []):
                assert d["resident"] is True, (k, d)
        assert _checksums() == before


def test_cache_key_names_the_device(indexed):
    """A column cached for another device is never served: re-keyed
    under ``cuda:0``, the entries miss for the ``cpu`` session, which
    uploads its own and answers right."""
    system_path, paths = indexed
    s = hyperspace_tpu_torch.HyperspaceSession(system_path=system_path,
                                               device="cpu")
    for k in ("filter", "join", "agg", "resident"):
        setattr(s.conf, f"device_{k}_min_rows", 0)  # the device routes
    s.enable_hyperspace()
    ds = _kind_query("filter", s, paths)
    want = ds.collect()
    cache = torch_cache.global_cache()
    keys = list(cache._entries)
    assert keys and all(k[0] == "cpu" for k in keys)
    for key in keys:
        t = cache.peek(key)
        cache.pop(key)
        # What a card would hold: the wrong values, on another device.
        cache.put(("cuda:0",) + key[1:], torch.full_like(t, 7), 1 << 30)
    got = ds.collect()
    assert got.equals(want)
    assert s.last_execution_stats["device_cache"] == {"hits": 0,
                                                      "misses": len(keys)}
    assert all(t.device.type == "cpu" for t in cache._entries.values())


def test_byte_budget_lru_books_under_threads():
    """8 threads put, get, probe and pop at once: every get is counted as
    a hit or a miss, and the cached bytes stay the sum of the entries and
    within the budget."""
    cache = torch_cache.DeviceColumnCache()
    budget = 20_000
    gets = [0] * 8
    errors = []

    def worker(i):
        rng = random.Random(i)
        try:
            for _ in range(3_000):
                key = ("cpu", "f", f"c{rng.randrange(40)}", "num")
                op = rng.random()
                if op < 0.4:
                    cache.put(key, torch.empty(rng.randrange(1, 3_000),
                                               dtype=torch.uint8), budget)
                elif op < 0.8:
                    cache.get(key)
                    gets[i] += 1
                elif op < 0.9:
                    cache.contains(key)
                else:
                    cache.pop(key)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    stats = cache.stats()
    assert stats["hits"] + stats["misses"] == sum(gets)
    sizes = {k: v.numel() for k, v in cache._entries.items()}
    assert stats["bytes"] == cache.bytes_cached == sum(sizes.values())
    assert cache.bytes_cached <= budget
    assert stats["entries"] == len(sizes)


@pytest.mark.parametrize("literals", [
    (1, 1.0), (1, True), (1, "1"), (0.1, np.float32(0.1)),
    (np.int64(5), np.int32(5)), (1, [1]),
])
def test_predicates_that_differ_never_print_alike(literals):
    """A filter's derived identity hashes the predicate's text, so two
    predicates with different answers must print differently."""
    c = hyperspace_tpu_torch.col
    a, b = literals
    if isinstance(b, list):
        assert repr(c("k") == a) != repr(c("k").isin(b))
        return
    assert repr(c("k") < a) != repr(c("k") < b)
    assert repr((c("k") < a) & (c("v") > 0)) != repr((c("k") < b) & (c("v") > 0))
