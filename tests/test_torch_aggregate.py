"""Grouped aggregation, sort/limit and the fused join→aggregate of
hyperspace_tpu_torch (on the CPU) against the JAX package.

At the ops level the same numpy-seeded inputs go through
``grouped_aggregate``, ``_topk_groups`` and ``join_group_aggregate`` of
both packages.  End to end, a small orders/lineitem pair (4 files each)
is indexed by each package in its own system path (``li_idx`` on
``l_orderkey``, ``ord_idx`` on ``o_orderkey``, 8 buckets) and the TPC-H
Q3/Q10 shapes, grouped and global aggregates, sort/limit and the shapes
the fused path declines run through both, with hyperspace on and off, on
the device route (thresholds 0) and the host route (1 << 62).

Held alike: column names and arrow types, rows in order, integers and
keys exactly, floats within 1e-9 relative (summation order differs), and
the strategies the executors record."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch

N_ORDERS = 600
N_LINEITEM = 3000
NUM_BUCKETS = 8
HIGH = 1 << 62
RTOL = 1e-9
OPS = ["sum", "min", "max", "mean", "count", "count_all"]


# ---------------------------------------------------------------------------
# ops level
# ---------------------------------------------------------------------------
def _jax_grouped(key_arrays, value_cols, ops):
    from hyperspace_tpu.io.columnar import to_order_words
    from hyperspace_tpu.ops.aggregate import grouped_aggregate

    words = [np.asarray(to_order_words(a)) for a in key_arrays]
    return grouped_aggregate(words, value_cols, ops)


def _torch_grouped(key_arrays, value_cols, ops):
    from hyperspace_tpu_torch.io.columnar import to_device_numeric
    from hyperspace_tpu_torch.ops.aggregate import grouped_aggregate

    keys = [to_device_numeric(a) for a in key_arrays]
    return grouped_aggregate(keys, value_cols, ops, device="cpu")


def _assert_close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def _keys(case, rng, n):
    if case == "one_int_heavy_ties":
        return [pa.array(rng.integers(0, 5, n))]
    if case == "two_int":
        return [pa.array(rng.integers(0, 4, n)), pa.array(rng.integers(-3, 3, n))]
    if case == "negative_and_extremes":
        lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
        return [pa.array(rng.choice(np.array([lo, -7, -1, 0, 3, hi]), n))]
    if case == "bool":
        return [pa.array(rng.random(n) < 0.3)]
    if case == "date32_and_int":
        return [pa.array(rng.integers(18000, 18010, n).astype(np.int32),
                         type=pa.date32()),
                pa.array(rng.integers(0, 3, n))]
    raise AssertionError(case)


@pytest.mark.parametrize("value_dtype", ["int64", "float64"])
@pytest.mark.parametrize("case", ["one_int_heavy_ties", "two_int",
                                  "negative_and_extremes", "bool",
                                  "date32_and_int"])
def test_grouped_aggregate_matches_jax(case, value_dtype):
    rng = np.random.default_rng(3)
    n = 500
    keys = _keys(case, rng, n)
    if value_dtype == "int64":
        values = rng.integers(-10**12, 10**12, n)
        values[::97] = np.iinfo(np.int64).max // 7
    else:
        values = rng.standard_normal(n) * 1e6
    # One value column per aggregate that is not a count.
    value_cols = [values, values[::-1].copy(), values * 3, values + 1]
    jfirst, jcounts, jres = _jax_grouped(keys, value_cols, OPS)
    tfirst, tcounts, tres = _torch_grouped(keys, value_cols, OPS)
    # Groups in ascending key order, each found at its first row.
    np.testing.assert_array_equal(tfirst, np.asarray(jfirst))
    np.testing.assert_array_equal(tcounts, np.asarray(jcounts))
    assert tcounts.dtype == np.int32
    for op, t, j in zip(OPS, tres, jres):
        _assert_close(t, j, op)
        if op in ("sum", "min", "max"):
            assert t.dtype == values.dtype, op
        if op == "mean":
            assert t.dtype == np.float64


def test_grouped_aggregate_rejects_an_unknown_op():
    from hyperspace_tpu_torch.ops.aggregate import grouped_aggregate

    with pytest.raises(ValueError, match="median"):
        grouped_aggregate([np.arange(3)], [np.arange(3)], ["median"],
                          device="cpu")


def _jax_topk(values, k, ascending, n_valid=None):
    import jax.numpy as jnp

    from hyperspace_tpu.ops.join_agg import _topk_groups
    from hyperspace_tpu.utils.compat import enable_x64

    with enable_x64():
        idx = _topk_groups(jnp.asarray(values),
                           len(values) if n_valid is None else n_valid,
                           k=k, ascending=ascending, capacity=len(values))
    return np.asarray(idx).tolist()


def _torch_topk(values, k, ascending):
    from hyperspace_tpu_torch.ops.join_agg import _topk_groups

    return _topk_groups(torch.from_numpy(values), k, ascending).tolist()


_LO, _HI = np.iinfo(np.int64).min, np.iinfo(np.int64).max
TOPK_CASES = {
    # JAX's TestTopkGroups, then ties at the k boundary.
    "int64_min_ascending": (np.array([5, _LO, 7, 0]), 2, True),
    "int64_max_descending": (np.array([5, _HI, -3, 0]), 2, False),
    "nan_descending": (np.array([1.0, np.nan, 3.0, -2.0]), 2, False),
    "nan_ascending": (np.array([1.0, np.nan, 3.0, -2.0]), 2, True),
    "ties_at_k_descending": (np.array([5, 3, 5, 9, 5, 1]), 3, False),
    "ties_at_k_ascending": (np.array([2.5, 1.0, 2.5, 0.5, 2.5]), 3, True),
    "nan_and_minus_inf_tie": (np.array([np.nan, -np.inf, 4.0, np.nan]), 3,
                              False),
    "int32_counts_ascending": (np.array([3, 1, 1, 2], dtype=np.int32), 2,
                               True),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_groups_selects_the_jax_slots(case):
    values, k, ascending = TOPK_CASES[case]
    assert _torch_topk(values, k, ascending) == _jax_topk(values, k, ascending)


def test_topk_groups_padding_case_of_jax():
    """JAX's padding case: slots past the group count never win.  The
    port counts groups exactly, so its column holds the valid slots
    only."""
    values = np.array([4, 2, 9, 9])
    for ascending in (False, True):
        assert _torch_topk(values[:2], 2, ascending) == \
            _jax_topk(values, 2, ascending, n_valid=2)


def _join_inputs(rng):
    n_l, n_r = 400, 300
    l_key = rng.integers(0, 120, n_l)
    r_key = rng.integers(0, 150, n_r)
    cols = {
        "l_key": ("l", l_key),
        "l_grp": ("l", rng.integers(0, 7, n_l)),
        "l_val": ("l", rng.random(n_l) * 1e3),
        "l_int": ("l", rng.integers(-50, 50, n_l)),
        "r_key": ("r", r_key),
        "r_grp": ("r", rng.integers(-2, 3, n_r)),
        "r_disc": ("r", rng.random(n_r) * 0.1),
    }
    return cols


def _run_join_agg(pkg, cols, group, aggs, topn, empty=False):
    """``aggs``: (op, expression builder over ``pkg.col``, or None)."""
    if pkg is hyperspace_tpu:
        from hyperspace_tpu.ops.filter import build_value_fn
        from hyperspace_tpu.ops.join_agg import join_group_aggregate
        from hyperspace_tpu.utils.compat import enable_x64

        kw = {}
    else:
        from hyperspace_tpu_torch.ops.filter import build_value_fn
        from hyperspace_tpu_torch.ops.join_agg import join_group_aggregate

        kw = {"device": "cpu"}
    order = sorted(cols)
    arrays = [cols[c][1] for c in order]
    if empty:
        arrays = [a + 10**6 if c == "r_key" else a
                  for c, a in zip(order, arrays)]
    fns, lits = [], []
    for op, build in aggs:
        if op in ("count", "count_all"):
            continue
        fn, lit = build_value_fn(build(pkg.col), order)
        fns.append(fn)
        lits.append(lit)
    call = lambda: join_group_aggregate(  # noqa: E731
        arrays[order.index("l_key")], arrays[order.index("r_key")], arrays,
        [cols[c][0] for c in order], [order.index(g) for g in group],
        [op for op, _b in aggs], fns, lits, topn=topn, **kw)
    if pkg is hyperspace_tpu:
        with enable_x64():
            return call()
    return call()


JOIN_AGG_CASES = {
    "left_group_revenue": (["l_grp"], [
        ("sum", lambda c: c("l_val") * (1 - c("r_disc"))),
        ("count_all", None), ("max", lambda c: c("l_int")),
        ("mean", lambda c: c("l_val"))], None),
    "right_group_ints": (["r_grp"], [
        ("sum", lambda c: c("l_int") * 2 + 1), ("min", lambda c: c("l_int")),
        ("count", None)], None),
    "two_sides_group": (["r_grp", "l_grp"], [
        ("sum", lambda c: c("l_val")), ("count_all", None)], None),
    "topn_descending": (["l_grp", "r_grp"], [
        ("sum", lambda c: c("l_val") * (1 - c("r_disc")))], (0, False, 5)),
    "topn_ascending_count": (["r_grp"], [
        ("count_all", None), ("sum", lambda c: c("l_int"))], (0, True, 3)),
    # An int column under int and float literals: JAX types the literal
    # vector as one (float64 here), so ``l_int * 3037000500 * 3037000500``
    # does not wrap around as int64 arithmetic would.
    "mixed_literals": (["l_grp"], [
        ("sum", lambda c: c("l_int") * 3037000500 * 3037000500 + 0.5),
        ("sum", lambda c: c("l_int") * 3037000500 * 3037000500)], None),
}


@pytest.mark.parametrize("case", sorted(JOIN_AGG_CASES))
def test_join_group_aggregate_matches_jax(case):
    group, aggs, topn = JOIN_AGG_CASES[case]
    cols = _join_inputs(np.random.default_rng(8))
    jli, jri, jcounts, jres = _run_join_agg(hyperspace_tpu, cols, group, aggs,
                                            topn)
    tli, tri, tcounts, tres = _run_join_agg(hyperspace_tpu_torch, cols, group,
                                            aggs, topn)
    assert len(tcounts) > 1
    # The first joined row of each group: its keys, in the same order.
    for g in group:
        side, values = cols[g]
        _assert_close(values[tli if side == "l" else tri],
                      values[np.asarray(jli) if side == "l" else np.asarray(jri)],
                      g)
    np.testing.assert_array_equal(tcounts, np.asarray(jcounts))
    for (op, _b), t, j in zip(aggs, tres, jres):
        _assert_close(t, np.asarray(j), op)
    if case == "mixed_literals":
        assert tres[0].dtype == np.float64 and tres[1].dtype == np.int64


def test_join_group_aggregate_of_no_match_is_empty_like_jax():
    cols = _join_inputs(np.random.default_rng(8))
    aggs = JOIN_AGG_CASES["left_group_revenue"][1]
    jout = _run_join_agg(hyperspace_tpu, cols, ["l_grp"], aggs, None, True)
    tout = _run_join_agg(hyperspace_tpu_torch, cols, ["l_grp"], aggs, None, True)
    for t, j in zip(tout[:3], jout[:3]):
        assert len(t) == len(j) == 0
    assert [r.dtype for r in tout[3]] == [np.asarray(r).dtype for r in jout[3]]


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------
def _write(root, name, table, n_files=4):
    path = os.path.join(root, name)
    os.makedirs(path)
    step = -(-table.num_rows // n_files)
    for f in range(n_files):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))
    return path


def _session(pkg, system_path, threshold):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = pkg.HyperspaceSession(system_path=system_path, **kw)
    s.conf.num_buckets = NUM_BUCKETS
    s.conf.device_filter_min_rows = threshold
    s.conf.device_join_min_rows = threshold
    s.conf.device_agg_min_rows = threshold
    if pkg is hyperspace_tpu:
        # The port has no mesh: the JAX package's single-device path,
        # uncached.
        s.conf.mesh_enabled = "off"
        s.conf.device_cache_policy = "off"
    else:
        # The port's device column cache stays on, so the repeats of a
        # query are answered from its cached columns; residency never
        # lowers a threshold here, so routes stay the uncached ones.
        s.conf.device_resident_min_rows = HIGH
        # The device build (the CPU default takes the host mirror).
        s.conf.device_build_min_rows = 0
    return s


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("aggregate"))
    rng = np.random.default_rng(41)
    orders = pa.table({
        "o_orderkey": rng.permutation(N_ORDERS).astype(np.int64),
        "o_custkey": rng.integers(0, 90, N_ORDERS),
        "o_totalprice": rng.random(N_ORDERS) * 1e4,
        "o_shippriority": rng.integers(0, 5, N_ORDERS),
        "o_clerk": np.array([f"clerk{v}" for v in rng.integers(0, 9, N_ORDERS)],
                            dtype=object),
    })
    l_key = rng.integers(0, N_ORDERS + 40, N_LINEITEM)
    lineitem = pa.table({
        "l_orderkey": l_key,
        "l_quantity": rng.integers(1, 50, N_LINEITEM),
        "l_extendedprice": rng.random(N_LINEITEM) * 1e4,
        "l_discount": rng.random(N_LINEITEM) * 0.1,
        "l_shipdate": np.arange(N_LINEITEM, dtype=np.int64),
    })
    # A lineitem whose join keys and prices hold nulls: no index.
    mask = rng.random(N_LINEITEM) < 0.1
    nullable = pa.table({
        "n_orderkey": pa.array(l_key, mask=mask),
        "n_price": pa.array(lineitem.column("l_extendedprice").to_numpy(),
                            mask=rng.random(N_LINEITEM) < 0.05),
        "n_quantity": lineitem.column("l_quantity"),
    })
    paths = {"orders": _write(root, "orders", orders),
             "lineitem": _write(root, "lineitem", lineitem),
             "nullable": _write(root, "nullable", nullable)}
    for pkg, name in ((hyperspace_tpu, "jax"), (hyperspace_tpu_torch, "torch")):
        s = _session(pkg, os.path.join(root, name), 0)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(paths["lineitem"]), pkg.IndexConfig(
            "li_idx", ["l_orderkey"],
            ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]))
        hs.create_index(s.read.parquet(paths["orders"]), pkg.IndexConfig(
            "ord_idx", ["o_orderkey"],
            ["o_totalprice", "o_custkey", "o_shippriority", "o_clerk"]))
    return root, paths


def _revenue(c):
    return c("l_extendedprice") * (1 - c("l_discount"))


def q3(pkg, s, paths):
    """bench.py's ``q_q3``."""
    c = pkg.col
    return (s.read.parquet(paths["orders"])
            .filter(c("o_totalprice") < 2_000.0)
            .join(s.read.parquet(paths["lineitem"]),
                  c("o_orderkey") == c("l_orderkey"))
            .group_by("o_custkey").agg(revenue=(_revenue(c), "sum"))
            .sort(("revenue", False)).limit(10))


def _queries(pkg, s, paths):
    c = pkg.col
    li = s.read.parquet(paths["lineitem"])
    orders = s.read.parquet(paths["orders"])
    nullable = s.read.parquet(paths["nullable"])
    return {
        "q3": q3(pkg, s, paths),
        # bench.py's ``q_q10`` with its l_shipdate window inside the data.
        "q10": (li.filter((c("l_shipdate") >= 500) & (c("l_shipdate") < 2_000))
                .join(orders, c("l_orderkey") == c("o_orderkey"))
                .group_by("o_custkey").agg(revenue=(_revenue(c), "sum"))
                .sort(("revenue", False)).limit(20)),
        # tests/test_join_agg.py's Q3 shape: count, max and mean beside
        # the revenue, two group keys, every group back.
        "q3_variant": (orders.filter(c("o_totalprice") < 5_000.0)
                       .join(li, c("o_orderkey") == c("l_orderkey"))
                       .group_by("o_orderkey", "o_shippriority")
                       .agg(revenue=(_revenue(c), "sum"),
                            n=(c("l_quantity"), "count"),
                            qmax=(c("l_quantity"), "max"),
                            avg_price=(c("l_extendedprice"), "mean"))
                       .sort("o_orderkey")),
        "group_count": li.group_by("l_orderkey").count(),
        "global_agg": li.agg(total=("l_extendedprice", "sum"),
                             n=("l_quantity", "count"),
                             low=("l_discount", "min"),
                             avg=(c("l_quantity") * 2, "mean")),
        # A sort by a group column: the select_k path, not the top-N one.
        "sort_limit": (orders.filter(c("o_orderkey") < 400)
                       .group_by("o_shippriority")
                       .agg(total=("o_totalprice", "sum"),
                            low=("o_totalprice", "min"),
                            high=("o_totalprice", "max"),
                            avg=("o_totalprice", "mean"),
                            n=("o_custkey", "count_all"))
                       .sort(("o_shippriority", False)).limit(3)),
        # Shapes the fused path declines.
        "string_group_key": (orders.join(li, c("o_orderkey") == c("l_orderkey"))
                             .group_by("o_clerk")
                             .agg(revenue=(_revenue(c), "sum"))
                             .sort("o_clerk")),
        "nullable_join_key": (orders.join(nullable,
                                          c("o_orderkey") == c("n_orderkey"))
                              .group_by("o_shippriority")
                              .agg(q=("n_quantity", "sum"))
                              .sort("o_shippriority")),
        "nullable_input": (orders.join(nullable,
                                       c("o_orderkey") == c("n_orderkey"))
                           .group_by("o_custkey")
                           .agg(p=("n_price", "sum"))
                           .sort(("p", False)).limit(7)),
        "count_of_division": (orders.join(li, c("o_orderkey") == c("l_orderkey"))
                              .group_by("o_shippriority")
                              .agg(n=(c("l_extendedprice") / c("l_discount"),
                                      "count"))
                              .sort("o_shippriority")),
    }


def _run(pkg, root, paths, query, enabled, threshold):
    s = _session(pkg, os.path.join(root, "jax" if pkg is hyperspace_tpu
                                   else "torch"), threshold)
    if enabled:
        s.enable_hyperspace()
    ds = _queries(pkg, s, paths)[query]
    return ds.collect(), ds.optimized_plan(), s.last_execution_stats


def _index_scans(plan):
    if type(plan).__name__ == "Scan":
        rel = plan.relation
        return [rel.index_scan_of] if rel.index_scan_of else []
    return sorted(n for c in plan.children for n in _index_scans(c))


def _assert_tables_match(got, want):
    assert got.column_names == want.column_names
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(
                g.to_numpy(zero_copy_only=False),
                w.to_numpy(zero_copy_only=False), rtol=RTOL, err_msg=name)
        else:
            assert g.to_pylist() == w.to_pylist(), name


def _routes(stats):
    return {k: [(d["strategy"], d.get("topn")) for d in stats.get(k, [])]
            for k in ("filters", "joins", "join_kernels", "aggregates")}


FUSED = ("q3", "q10", "q3_variant")
DECLINED = ("string_group_key", "nullable_input", "count_of_division")


@pytest.mark.parametrize("threshold", [0, HIGH], ids=["device", "host"])
@pytest.mark.parametrize("enabled", [True, False], ids=["indexed", "source"])
@pytest.mark.parametrize("query", ["q3", "q10", "q3_variant", "group_count",
                                   "global_agg", "sort_limit",
                                   "string_group_key", "nullable_join_key",
                                   "nullable_input", "count_of_division"])
def test_query_equals_jax(data, query, enabled, threshold):
    root, paths = data
    jt, jplan, jstats = _run(hyperspace_tpu, root, paths, query, enabled,
                             threshold)
    tt, tplan, tstats = _run(hyperspace_tpu_torch, root, paths, query, enabled,
                             threshold)
    assert tt.num_rows > 0
    if query == "group_count" and threshold == HIGH:
        # Arrow's threaded group-by leaves the group order open (GROUP BY
        # without ORDER BY): the same rows, in any order.
        tt, jt = (t.sort_by("l_orderkey") for t in (tt, jt))
    _assert_tables_match(tt, jt)
    assert _index_scans(tplan) == _index_scans(jplan)
    assert _routes(tstats) == _routes(jstats)
    routes = _routes(tstats)
    aggregates = [r for r, _n in routes["aggregates"]]
    joins = [r for r, _n in routes["joins"]]
    if enabled and query in ("q3", "q10", "q3_variant"):
        assert _index_scans(tplan) == ["li_idx", "ord_idx"]
    if threshold == HIGH:
        # The host route: nothing on the device.
        assert not aggregates
        assert all(r == "host" for r, _n in routes["filters"]
                   + routes["join_kernels"])
        return
    if query in FUSED:
        topn = {"q3": 10, "q10": 20, "q3_variant": None}[query]
        assert routes["joins"] == [("device-fused-agg", None)]
        assert routes["aggregates"] == [("device-join-agg", topn)]
    if query in ("group_count", "sort_limit"):
        assert aggregates == ["device-segment"]
    if query in DECLINED:
        assert "device-fused-agg" not in joins
    if query == "sort_limit" and enabled:
        assert _index_scans(tplan) == ["ord_idx"]


def test_fused_path_reads_both_indexes_whole_and_declines_a_bucketed_plan(data):
    """With the join threshold over 1 << 22 rows the fused path is left
    alone (as in the JAX package): the indexed join runs bucket by bucket
    and the device aggregate groups its rows."""
    root, paths = data
    out = []
    for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
        s = _session(pkg, os.path.join(root, "jax" if pkg is hyperspace_tpu
                                       else "torch"), 0)
        s.conf.device_join_min_rows = (1 << 22) + 1
        s.enable_hyperspace()
        ds = _queries(pkg, s, paths)["q3_variant"]
        out.append((ds.collect(), _routes(s.last_execution_stats)))
    (jt, jr), (tt, tr) = out
    _assert_tables_match(tt, jt)
    assert tr == jr
    assert [r for r, _n in tr["joins"]] == ["bucketed"]
    assert [r for r, _n in tr["aggregates"]] == ["device-segment"]


def test_empty_join_and_filter_keep_the_jax_schema(data):
    """A filter that selects nothing (a side with no row takes the host
    join), and a join with no match (the fused path's empty result)."""
    root, paths = data
    for name, lo in (("empty_filter", 10**9), ("no_match", N_ORDERS + 1)):
        out = []
        for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
            s = _session(pkg, os.path.join(root, "jax" if pkg is hyperspace_tpu
                                           else "torch"), 0)
            s.enable_hyperspace()
            c = pkg.col
            li = s.read.parquet(paths["lineitem"])
            if name == "empty_filter":
                li = li.filter(c("l_shipdate") >= lo)
            else:
                li = li.filter(c("l_orderkey") >= lo)
            ds = (s.read.parquet(paths["orders"])
                  .join(li, c("o_orderkey") == c("l_orderkey"))
                  .group_by("o_custkey")
                  .agg(revenue=(_revenue(c), "sum"), n=("l_quantity", "count"),
                       q=("l_quantity", "max"))
                  .sort(("revenue", False)).limit(10))
            out.append((ds.collect(), _routes(s.last_execution_stats)))
        (jt, jr), (tt, tr) = out
        assert tt.num_rows == 0, name
        assert tt.schema.equals(jt.schema), (name, tt.schema, jt.schema)
        assert tr == jr, name


def test_empty_group_set_keeps_the_jax_schema(data):
    root, paths = data
    out = []
    for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
        s = _session(pkg, os.path.join(root, "jax" if pkg is hyperspace_tpu
                                       else "torch"), 0)
        c = pkg.col
        ds = (s.read.parquet(paths["orders"]).filter(c("o_orderkey") < 0)
              .group_by("o_shippriority")
              .agg(total=("o_totalprice", "sum"), n=("o_custkey", "count")))
        out.append(ds.collect())
    assert out[1].num_rows == 0 and out[1].schema.equals(out[0].schema)


def test_a_filter_stays_above_an_aggregate_sort_and_limit(data):
    """Pushdown has no branch for these nodes: a filter over them stays
    where it is, in both packages."""
    root, paths = data
    texts = []
    for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
        s = _session(pkg, os.path.join(root, "jax" if pkg is hyperspace_tpu
                                       else "torch"), 0)
        c = pkg.col
        ds = (s.read.parquet(paths["orders"])
              .group_by("o_shippriority").agg(total=("o_totalprice", "sum"))
              .filter(c("o_shippriority") > 1)
              .sort("o_shippriority").limit(2).filter(c("total") > 0.0))
        texts.append((ds.optimized_plan().tree_string().replace(root, ""),
                      ds.collect()))
    assert texts[1][0] == texts[0][0]
    assert texts[1][0].splitlines()[0].startswith("Filter")
    _assert_tables_match(texts[1][1], texts[0][1])


def test_dataset_verbs_validate_like_jax(data):
    root, paths = data
    s = _session(hyperspace_tpu_torch, os.path.join(root, "torch"), 0)
    ds = s.read.parquet(paths["orders"])
    with pytest.raises(ValueError, match="Sort key"):
        ds.sort(("o_custkey", "desc"))
    with pytest.raises(ValueError, match="non-negative"):
        ds.limit(-1)
    with pytest.raises(ValueError, match="Unsupported aggregate"):
        ds.group_by("o_custkey").agg(x=("o_totalprice", "median"))
    with pytest.raises(ValueError, match="group columns"):
        ds.group_by().count()
    assert ds.count() == N_ORDERS
    assert ds.sort("o_custkey", ascending=False).limit(5).count() == 5
