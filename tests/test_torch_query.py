"""Filter and join queries through hyperspace_tpu_torch (on the CPU)
against the JAX package's, end to end: a small lineitem/orders pair
(4 files each, seeded numpy), indexed by each package in its own system
path (``li_idx`` on ``l_orderkey``, ``ord_idx`` on ``o_orderkey``, 4
buckets), queried with hyperspace enabled and disabled, with the
routing thresholds at 0 (the device path) and high (the host path).

The result tables must be equal row for row and in order, the optimized
plans must print alike (the JAX package's per-file sketch pruning, which
the port's build has no sketch for, is left out of the comparison), and
the execution stats must record the same strategies.  No tolerance:
these queries copy values, they compute none."""

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

N_ORDERS = 1000
N_LINEITEM = 4000
NUM_BUCKETS = 4
HIGH = 1 << 40


def _write(root, name, table, n_files=4):
    path = os.path.join(root, name)
    os.makedirs(path)
    step = -(-table.num_rows // n_files)
    for f in range(n_files):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))
    return path


def _session(pkg, system_path, threshold, **kw):
    s = pkg.HyperspaceSession(system_path=system_path, **kw)
    s.conf.num_buckets = NUM_BUCKETS
    s.conf.device_filter_min_rows = threshold
    s.conf.device_join_min_rows = threshold
    if pkg is hyperspace_tpu:
        # The port has no mesh: compare with the JAX package's
        # single-device path, uncached.
        s.conf.mesh_enabled = "off"
        s.conf.device_cache_policy = "off"
    else:
        # The port's device column cache stays on, so the repeats of a
        # query are answered from its cached columns; residency never
        # lowers a threshold here, so routes stay the uncached ones.
        s.conf.device_resident_min_rows = HIGH
        # The device build and aggregate (the CPU defaults take the host).
        s.conf.device_agg_min_rows = 0
        s.conf.device_build_min_rows = 0
    return s


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("query"))
    rng = np.random.default_rng(31)
    orders = pa.table({
        "o_orderkey": rng.permutation(N_ORDERS).astype(np.int64),
        "o_custkey": rng.integers(0, 200, N_ORDERS),
        "o_totalprice": rng.random(N_ORDERS) * 1e4,
        "o_shippriority": rng.integers(0, 5, N_ORDERS),
    })
    lineitem = pa.table({
        "l_orderkey": rng.integers(0, N_ORDERS + 50, N_LINEITEM),
        "l_quantity": rng.integers(1, 50, N_LINEITEM).astype(np.float64),
        "l_extendedprice": rng.random(N_LINEITEM) * 1e4,
        "l_discount": rng.random(N_LINEITEM) * 0.1,
        "l_comment": np.array([f"c{v}" for v in rng.integers(0, 30, N_LINEITEM)],
                              dtype=object),
    })
    paths = {"orders": _write(root, "orders", orders),
             "lineitem": _write(root, "lineitem", lineitem)}
    for pkg, name, kw in ((hyperspace_tpu, "jax", {}),
                          (hyperspace_tpu_torch, "torch", {"device": "cpu"})):
        s = _session(pkg, os.path.join(root, name), 0, **kw)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(paths["lineitem"]), pkg.IndexConfig(
            "li_idx", ["l_orderkey"],
            ["l_quantity", "l_extendedprice", "l_discount"]))
        hs.create_index(s.read.parquet(paths["orders"]), pkg.IndexConfig(
            "ord_idx", ["o_orderkey"],
            ["o_totalprice", "o_custkey", "o_shippriority"]))
    return root, paths


def _queries(pkg, s, paths):
    c = pkg.col
    li = s.read.parquet(paths["lineitem"])
    orders = s.read.parquet(paths["orders"])
    join_cols = ("o_orderkey", "o_totalprice", "l_quantity", "l_extendedprice")
    return {
        "point": li.filter(c("l_orderkey") == 123).select(
            "l_orderkey", "l_quantity"),
        "range": li.filter((c("l_orderkey") >= 100) & (c("l_orderkey") < 400))
        .select("l_orderkey", "l_extendedprice", "l_discount"),
        "join": orders.join(li, c("o_orderkey") == c("l_orderkey"))
        .select(*join_cols),
        "filtered_join": orders.filter(c("o_totalprice") < 2000.0)
        .join(li, c("o_orderkey") == c("l_orderkey")).select(*join_cols),
    }


def _run(pkg, root, paths, query, enabled, threshold):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = _session(pkg, os.path.join(root, "jax" if pkg is hyperspace_tpu
                                   else "torch"), threshold, **kw)
    if enabled:
        s.enable_hyperspace()
    ds = _queries(pkg, s, paths)[query]
    table = ds.collect()
    return table, ds.optimized_plan(), s.last_execution_stats


def _plan_text(plan, root):
    text = plan.tree_string().replace(root, "<root>")
    return re.sub(r" \[files: \d+/\d+\]", "", text)


def _index_scans(plan):
    """(index name, pruned buckets) of the index scans of either
    package's plan."""
    if type(plan).__name__ == "Scan":
        rel = plan.relation
        return [(rel.index_scan_of, rel.prune_to_buckets)] \
            if rel.index_scan_of else []
    return [s for c in plan.children for s in _index_scans(c)]


def _strategies(stats):
    return {k: sorted(d["strategy"] for d in stats.get(k, []))
            for k in ("filters", "joins", "join_kernels")}


@pytest.mark.parametrize("threshold", [0, HIGH], ids=["device", "host"])
@pytest.mark.parametrize("enabled", [True, False], ids=["indexed", "source"])
@pytest.mark.parametrize("query", ["point", "range", "join", "filtered_join"])
def test_query_equals_jax(data, query, enabled, threshold):
    root, paths = data
    jt, jplan, jstats = _run(hyperspace_tpu, root, paths, query, enabled,
                             threshold)
    tt, tplan, tstats = _run(hyperspace_tpu_torch, root, paths, query, enabled,
                             threshold)
    assert tt.num_rows > 0
    assert tt.column_names == jt.column_names
    assert tt.schema.equals(jt.schema)
    assert tt.equals(jt)
    assert _plan_text(tplan, root) == _plan_text(jplan, root)
    assert _index_scans(tplan) == _index_scans(jplan)
    assert bool(_index_scans(tplan)) == enabled
    assert _strategies(tstats) == _strategies(jstats)
    route = "device" if threshold == 0 else "host"
    assert set(_strategies(tstats)["filters"]
               + _strategies(tstats)["join_kernels"]) == {route}
    if enabled and query.endswith("join"):
        assert _strategies(tstats)["joins"] == ["bucketed"]
        assert len(tstats["join_kernels"]) == NUM_BUCKETS
    if enabled and query == "point":
        assert len(_index_scans(tplan)[0][1]) == 1


@pytest.mark.parametrize("bucket_spec", [False, True], ids=["plain", "bucketed"])
@pytest.mark.parametrize("how", ["left", "right", "full", "semi", "anti"])
def test_other_join_types_equal_jax(data, how, bucket_spec):
    """Outer and existence joins: the join rule leaves them alone and the
    filter rule indexes each filtered side.  With
    ``filter_rule_use_bucket_spec`` those index scans keep their bucket
    spec and the join runs bucket by bucket, a bucket only one side has
    joined against a zero-row table of the other side."""
    root, paths = data
    out = []
    for pkg, name, kw in ((hyperspace_tpu, "jax", {}),
                          (hyperspace_tpu_torch, "torch", {"device": "cpu"})):
        s = _session(pkg, os.path.join(root, name), 0, **kw).enable_hyperspace()
        s.conf.filter_rule_use_bucket_spec = bucket_spec
        c = pkg.col
        li = s.read.parquet(paths["lineitem"]).filter(c("l_orderkey") < 300)
        orders = s.read.parquet(paths["orders"]).filter(
            (c("o_orderkey") > 100) & (c("o_orderkey") < 600))
        cols = ["o_orderkey", "o_totalprice"] \
            + ([] if how in ("semi", "anti") else ["l_orderkey", "l_quantity"])
        ds = orders.join(li, c("o_orderkey") == c("l_orderkey"), how) \
            .select(*cols)
        out.append((ds.collect(), _strategies(s.last_execution_stats),
                    _plan_text(ds.optimized_plan(), root)))
    (jt, js, jp), (tt, ts, tp) = out
    assert tt.num_rows > 0 and tt.equals(jt) and ts == js and tp == jp
    assert ts["joins"] == (["bucketed"] if bucket_spec else ["plain"])


def test_string_and_mixed_predicates_take_the_host_path_like_jax(data):
    root, paths = data
    out = []
    for pkg, name, kw in ((hyperspace_tpu, "jax", {}),
                          (hyperspace_tpu_torch, "torch", {"device": "cpu"})):
        s = _session(pkg, os.path.join(root, name), 0, **kw)
        c = pkg.col
        li = s.read.parquet(paths["lineitem"])
        ds = li.filter((c("l_comment") == "c7") | (c("l_quantity") / 2 > 20))
        out.append((ds.collect(), _strategies(s.last_execution_stats)))
    (jt, js), (tt, ts) = out
    assert tt.num_rows > 0 and tt.equals(jt) and ts == js
    assert ts["filters"] == ["host"]


@pytest.mark.parametrize("threshold", [0, HIGH], ids=["device", "host"])
def test_isin_with_a_float_on_an_int_column_follows_the_route(data, threshold):
    """A reference fault the port keeps: the device path casts IN values
    to the column's dtype (2.5 matches 2), the arrow path does not (2.5
    matches nothing), so the answer depends on the route."""
    root, paths = data
    counts = []
    for pkg, name, kw in ((hyperspace_tpu, "jax", {}),
                          (hyperspace_tpu_torch, "torch", {"device": "cpu"})):
        s = _session(pkg, os.path.join(root, name), threshold, **kw)
        ds = s.read.parquet(paths["orders"]).filter(
            pkg.col("o_orderkey").isin([2.5]))
        counts.append(ds.collect().num_rows)
    assert counts == ([1, 1] if threshold == 0 else [0, 0])


@pytest.mark.parametrize("target", ["ops.join.sorted_equi_join",
                                    "ops.filter.compile_predicate"])
def test_a_device_error_is_not_answered_from_the_host(data, monkeypatch,
                                                       target):
    """No fallback hides the device path: its error reaches the caller."""
    import importlib

    root, paths = data
    module, attr = target.rsplit(".", 1)

    def broken(*args, **kwargs):
        raise RuntimeError("device path failed")

    monkeypatch.setattr(importlib.import_module(f"hyperspace_tpu_torch.{module}"),
                        attr, broken)
    s = _session(hyperspace_tpu_torch, os.path.join(root, "torch"), 0,
                 device="cpu").enable_hyperspace()
    ds = _queries(hyperspace_tpu_torch, s, paths)["filtered_join"]
    with pytest.raises(RuntimeError, match="device path failed"):
        ds.collect()


def test_an_index_is_not_used_once_its_source_changes(data, tmp_path):
    """The signature recorded at build time no longer matches the
    source's files: the rules leave the scan alone, in both packages."""
    root, paths = data
    src = str(tmp_path / "orders")
    os.makedirs(src)
    for name in sorted(os.listdir(paths["orders"])):
        with open(os.path.join(paths["orders"], name), "rb") as f, \
                open(os.path.join(src, name), "wb") as g:
            g.write(f.read())
    out = []
    for pkg, kw in ((hyperspace_tpu, {}),
                    (hyperspace_tpu_torch, {"device": "cpu"})):
        system = str(tmp_path / pkg.__name__)
        s = _session(pkg, system, 0, **kw)
        pkg.Hyperspace(s).create_index(s.read.parquet(src), pkg.IndexConfig(
            "o_idx", ["o_orderkey"], ["o_totalprice"]))
        s.enable_hyperspace()
        ds = s.read.parquet(src).filter(pkg.col("o_orderkey") == 7) \
            .select("o_orderkey", "o_totalprice")
        before = _index_scans(ds.optimized_plan())
        out.append((before, ds))
    pq.write_table(pa.table({"o_orderkey": [7], "o_custkey": [1],
                             "o_totalprice": [1.5], "o_shippriority": [0]}),
                   os.path.join(src, "part-99999.parquet"))
    tables = []
    for before, ds in out:
        assert [n for n, _ in before] == ["o_idx"]
        assert _index_scans(ds.optimized_plan()) == []
        tables.append(ds.collect())
    assert tables[1].num_rows == 2 and tables[1].equals(tables[0])


def test_an_entry_with_a_recorded_source_update_is_not_a_candidate(data):
    from hyperspace_tpu_torch.index.log_entry import Content, FileInfo, Update
    from hyperspace_tpu_torch.rules.rule_utils import get_candidate_indexes

    root, paths = data
    s = _session(hyperspace_tpu_torch, os.path.join(root, "torch"), 0,
                 device="cpu")
    entry = s.index_collection_manager.get_index("ord_idx")
    scan = s.read.parquet(paths["orders"]).plan
    assert not entry.has_source_update()
    assert get_candidate_indexes(s, [entry], scan) == [entry]
    appended = Content.from_leaf_files([FileInfo("/x/part-1.parquet", 1, 1, 0)])
    entry.source.relations[0].update = Update(appended_files=appended)
    assert entry.has_source_update()
    assert get_candidate_indexes(s, [entry], s.read.parquet(paths["orders"]).plan) == []


def test_a_pruned_scan_with_no_file_keeps_its_schema(tmp_path):
    """A key whose bucket holds no file prunes the scan to nothing: an
    empty table with the index's columns, in both packages."""
    src = str(tmp_path / "src")
    os.makedirs(src)
    pq.write_table(pa.table({"k": np.array([1, 2, 3] * 10),
                             "v": np.arange(30.0)}),
                   os.path.join(src, "part-0.parquet"))
    out = []
    for pkg, kw in ((hyperspace_tpu, {}),
                    (hyperspace_tpu_torch, {"device": "cpu"})):
        s = _session(pkg, str(tmp_path / pkg.__name__), 0, **kw)
        s.conf.num_buckets = 64
        pkg.Hyperspace(s).create_index(s.read.parquet(src),
                                       pkg.IndexConfig("k_idx", ["k"], ["v"]))
        s.enable_hyperspace()
        ds = s.read.parquet(src).filter(pkg.col("k") == 50).select("k", "v")
        out.append((ds.collect(), s.last_execution_stats["scans"]))
    (jt, jscans), (tt, tscans) = out
    assert tt.num_rows == 0 and tt.equals(jt)
    assert tscans[0]["files_read"] == jscans[0]["files_read"] == 0
