"""Computed columns, DISTINCT and the set operations of
hyperspace_tpu_torch (on the CPU) against the JAX package.

The same seeded tables (nulls, NaN, -0.0, int8/int32/int64 and float32
columns) go through both packages: ``select`` with computed columns
(a ``Compute``), ``with_column`` appending and replacing (a
``WithColumns``), ``distinct``, ``intersect``, ``subtract`` and ``union``
by name.  Rows are held in order and bit for bit (these operators copy
values or compute them elementwise with arrow), except ``distinct``'s:
arrow's threaded group-by gives no fixed row order in either package,
so its rows are compared sorted.  ``intersect`` and ``subtract`` keep
each distinct row at its first occurrence in left-row order, which is
compared as it is.

The pruned plans of a window and a ``with_column`` whose output nothing
reads (the node is dropped) print alike, and a join under a computed
``select`` takes the same indexes in both packages (the computed name
resolves to its expression's columns)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)


def _session(pkg, system_path):
    if pkg is hyperspace_tpu_torch:
        s = pkg.HyperspaceSession(system_path=system_path, device="cpu")
        s.conf.device_build_min_rows = 0
        return s
    s = pkg.HyperspaceSession(system_path=system_path)
    s.conf.mesh_enabled = "off"
    return s


def _write(root, name, table, n_files=1):
    path = os.path.join(str(root), name)
    os.makedirs(path)
    step = -(-table.num_rows // n_files)
    for f in range(n_files):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))
    return path


def _assert_same(got, want):
    """Names, types and values in order; floats bit for bit."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        assert g.type == w.type, name
        if pa.types.is_floating(w.type):
            assert g.is_valid().equals(w.is_valid()), name
            zero = pa.scalar(0.0, type=w.type)
            gv = np.asarray(g.fill_null(zero).to_numpy(zero_copy_only=False))
            wv = np.asarray(w.fill_null(zero).to_numpy(zero_copy_only=False))
            assert np.array_equal(gv.view(np.uint8), wv.view(np.uint8)), name
        else:
            assert g.to_pylist() == w.to_pylist(), name


def _sorted(table):
    """The rows in a total order: floats by their bits, so -0.0 and 0.0
    (equal to a sort) and NaN each have their place."""
    import pyarrow.compute as pc

    keys = {}
    for name in table.column_names:
        column = table.column(name).combine_chunks()
        if pa.types.is_floating(column.type):
            bits = np.asarray(column.cast(pa.float64()).fill_null(0.0)
                              .to_numpy(zero_copy_only=False)).view(np.int64)
            column = pa.array(bits, mask=~np.asarray(
                column.is_valid().to_numpy(zero_copy_only=False)))
        keys[name] = column
    order = pc.sort_indices(pa.table(keys), sort_keys=[
        (c, "ascending") for c in table.column_names])
    return table.take(order)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("setops")
    n = 600

    def make(n, seed):
        r = np.random.default_rng(seed)
        return pa.table({
            "a": pa.array(r.choice([None, 1, 2, 3], n), type=pa.int64()),
            "b": pa.array(r.integers(-3, 3, n).astype(np.int8)),
            "c": pa.array(r.choice([None, "x", "y"], n).tolist()),
            "f": pa.array(r.choice([np.nan, -0.0, 0.0, 1.5, 2.5], n)),
            "h": pa.array(r.integers(0, 4, n).astype(np.float32)),
            "w": pa.array(r.integers(0, 3, n).astype(np.int32)),
            "rid": pa.array(np.arange(n, dtype=np.int64)),
        })

    return (_write(root, "left", make(n, 1), n_files=3),
            _write(root, "right", make(n // 2, 2)))


def _both(tmp_path, build, data):
    out = []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        left = s.read.parquet(data[0])
        right = s.read.parquet(data[1])
        out.append(build(left, right, pkg.col, pkg.lit).collect())
    return out


COMPUTED = {
    "arith_and_literal": lambda l, r, col, lit: l.select(
        "rid", s=col("a") + col("b"), p=col("f") * col("h"),
        q=col("w") - 1, k=7, half=col("a") / 2),
    "rename_and_negate": lambda l, r, col, lit: l.select(
        ren=col("c"), neg=-col("f"), wide=col("w") * col("a")),
    "division_by_zero_is_null": lambda l, r, col, lit: l.select(
        "rid", d=col("h") / col("b")),
    "string_literal": lambda l, r, col, lit: l.select("a", tag=lit("z")),
    "over_a_filter": lambda l, r, col, lit: l.filter(col("b") > 0).select(
        "rid", t=col("b") * 10),
    "with_column_append": lambda l, r, col, lit: l.with_column(
        "t", col("a") * col("b")),
    "with_column_replace": lambda l, r, col, lit: l.with_column(
        "f", col("f") + 1).with_column("c", lit("same")),
    "with_column_then_select": lambda l, r, col, lit: l.with_column(
        "t", col("w") + col("b")).select("t", "rid"),
    "with_column_unused": lambda l, r, col, lit: l.with_column(
        "t", col("w") + col("b")).select("rid", "a"),
}


@pytest.mark.parametrize("case", sorted(COMPUTED))
def test_computed_columns_match_jax(tmp_path, data, case):
    j, t = _both(tmp_path, COMPUTED[case], data)
    _assert_same(t, j)


SETOPS = {
    "intersect_rows": lambda l, r, col, lit: l.select("a", "c", "f").intersect(
        r.select("a", "c", "f")),
    "subtract_rows": lambda l, r, col, lit: l.select("a", "c", "f").subtract(
        r.select("a", "c", "f")),
    "intersect_mixed_widths": lambda l, r, col, lit: l.select(
        "w", "b").intersect(r.select("b", "w")),
    "subtract_float32": lambda l, r, col, lit: l.select("h", "c").subtract(
        r.select("h", "c")),
    "intersect_nothing": lambda l, r, col, lit: l.filter(
        col("rid") < 10).select("rid").intersect(
        r.filter(col("rid") > 100).select("rid")),
    "subtract_everything": lambda l, r, col, lit: l.filter(
        col("rid") < 10).select("rid").subtract(
        r.filter(col("rid") > 100).select("rid")),
    "intersect_empty_left": lambda l, r, col, lit: l.filter(
        col("rid") < 0).select("a").intersect(r.select("a")),
    "intersect_after_window": lambda l, r, col, lit: l.with_window(
        "rk", "dense_rank", partition_by=["c"], order_by=["f"]).select(
        "c", "rk").intersect(r.select("c", rk=col("w") + 1)),
    "union_by_name_missing_column": lambda l, r, col, lit: l.filter(
        col("rid") < 5).select("a", "c").union(
        r.filter(col("rid") < 3).select("c")),
    "union_widens": lambda l, r, col, lit: l.filter(col("rid") < 4).select(
        x=col("w")).union(r.filter(col("rid") < 4).select(x=col("a"))),
    "union_int_and_float": lambda l, r, col, lit: l.filter(
        col("rid") < 4).select(x=col("b")).union(
        r.filter(col("rid") < 4).select(x=col("h"))),
}


@pytest.mark.parametrize("case", sorted(SETOPS))
def test_set_operations_match_jax_in_order(tmp_path, data, case):
    j, t = _both(tmp_path, SETOPS[case], data)
    _assert_same(t, j)


def test_intersect_and_subtract_semantics(tmp_path, data):
    """Null-safe, distinct, first occurrence in left-row order."""
    j, t = _both(tmp_path, SETOPS["intersect_rows"], data)
    rows = t.to_pylist()
    # repr tells -0.0 from 0.0 and makes NaN equal to NaN, as the codes.
    keys = [tuple(repr(v) for v in r.values()) for r in rows]
    assert len(keys) == len(set(keys))
    assert any(r["a"] is None for r in rows)
    _, t2 = _both(tmp_path, SETOPS["subtract_rows"], data)
    only = {tuple(repr(v) for v in r.values()) for r in t2.to_pylist()}
    assert not set(keys) & only


@pytest.mark.parametrize("columns", [("a", "c"), ("f", "h"), ("b", "w", "c"),
                                     ("a", "b", "c", "f", "h", "w")])
def test_distinct_matches_jax_as_sorted_rows(tmp_path, data, columns):
    j, t = _both(tmp_path, lambda l, r, col, lit: l.select(
        *columns).distinct(), data)
    assert t.num_rows == j.num_rows
    _assert_same(_sorted(t), _sorted(j))


def test_distinct_union_is_sql_union(tmp_path, data):
    j, t = _both(tmp_path, lambda l, r, col, lit: l.select("a", "c").union(
        r.select("a", "c")).distinct(), data)
    _assert_same(_sorted(t), _sorted(j))


def test_distinct_over_no_rows(tmp_path, data):
    j, t = _both(tmp_path, lambda l, r, col, lit: l.filter(
        col("rid") < 0).select("a", "c").distinct(), data)
    assert t.num_rows == 0
    _assert_same(t, j)


ERRORS = {
    "select_string_value": (lambda l, r, col, lit: l.select(x="a"),
                            "col\\('a'\\)"),
    "select_positional_expression": (
        lambda l, r, col, lit: l.select(col("a")), "column names"),
    "select_duplicate_names": (
        lambda l, r, col, lit: l.select("a", a=col("b")), "Duplicate"),
    "setop_column_counts": (
        lambda l, r, col, lit: l.select("a").intersect(r.select("a", "b"))
        .collect(), "equal column counts"),
    "distinct_duplicate_names": (
        lambda l, r, col, lit: l.select("a").join(
            r.select("a"), col("a") == col("a")).select("a", "a")
        .distinct().collect(), "unique column names|duplicate"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_match_jax(tmp_path, data, case):
    build, match = ERRORS[case]
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        left = s.read.parquet(data[0])
        right = s.read.parquet(data[1])
        with pytest.raises(ValueError, match=match):
            build(left, right, pkg.col, pkg.lit)


PLANS = {
    "window_unused": lambda ds, col: ds.with_window(
        "w", "sum", partition_by=["a"], value="f").select("a", "rid"),
    "window_used": lambda ds, col: ds.with_window(
        "w", "sum", partition_by=["a"], order_by=[("rid", False)],
        value="f", frame=(-2, 0)).select("w", "rid"),
    "with_column_unused": lambda ds, col: ds.with_column(
        "t", col("w") * 2).select("c"),
    "with_column_partly_used": lambda ds, col: ds.with_column(
        "t", col("w") * 2).with_column("u", col("h") + 1).select("u", "c"),
    "compute_over_filter": lambda ds, col: ds.filter(col("b") > 0).select(
        "rid", t=col("b") * col("h")),
    "distinct_keeps_its_input": lambda ds, col: ds.select(
        "a", "c").distinct().select("a"),
    "setop_keeps_its_inputs": lambda ds, col: ds.select("a", "c").subtract(
        ds.select("a", "c")).select("c"),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_pruned_plans_print_alike(tmp_path, data, case):
    texts = []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        plan = PLANS[case](s.read.parquet(data[0]), pkg.col).optimized_plan()
        texts.append(plan.tree_string())
    assert texts[1] == texts[0]
    if case.endswith("unused"):
        assert "Window" not in texts[1] and "WithColumns" not in texts[1]


def test_nodes_print_alike():
    """``simple_string`` of every new node, frames included."""
    texts = []
    for pkg in PKGS:
        from importlib import import_module

        nodes = import_module(f"{pkg.__name__}.plan.nodes")
        col = pkg.col
        leaf = nodes.InMemory(pa.table({"a": [1]}))
        plans = [
            nodes.Compute([("a", col("a")), ("b", col("a") * 2)], leaf),
            nodes.WithColumns([("b", col("a") + 1)], leaf),
            nodes.Distinct(leaf),
            nodes.SetOp("intersect", leaf, leaf),
            nodes.SetOp("except", leaf, leaf),
        ]
        for frame in (None, (None, 0), (-2, 3), (1, None), (None, None)):
            plans.append(nodes.Window("w", "sum", "a", ["a"],
                                      [("a", False)], leaf, frame=frame))
        plans.append(nodes.Window("l", "lag", "a", [], [("a", True)], leaf,
                                  offset=3))
        plans.append(nodes.Window("t", "ntile", None, ["a"], [("a", True)],
                                  leaf, offset=4))
        texts.append([p.simple_string() for p in plans])
    assert texts[1] == texts[0]


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("setops_idx"))
    rng = np.random.default_rng(31)
    n_orders, n_li = 800, 3000
    orders = pa.table({
        "o_orderkey": rng.permutation(n_orders).astype(np.int64),
        "o_custkey": rng.integers(0, 100, n_orders),
        "o_totalprice": rng.random(n_orders) * 1e4,
    })
    lineitem = pa.table({
        "l_orderkey": rng.integers(0, n_orders, n_li),
        "l_extendedprice": rng.random(n_li) * 1e4,
        "l_discount": rng.random(n_li) * 0.1,
        "l_comment": np.array([f"c{v}" for v in rng.integers(0, 9, n_li)],
                              dtype=object),
    })
    paths = {"orders": _write(root, "orders", orders, 2),
             "lineitem": _write(root, "lineitem", lineitem, 2)}
    for pkg in PKGS:
        s = _session(pkg, os.path.join(root, pkg.__name__))
        s.conf.num_buckets = 4
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(paths["lineitem"]), pkg.IndexConfig(
            "li_idx", ["l_orderkey"], ["l_extendedprice", "l_discount"]))
        hs.create_index(s.read.parquet(paths["orders"]), pkg.IndexConfig(
            "ord_idx", ["o_orderkey"], ["o_totalprice"]))
    return root, paths


def _index_names(plan):
    rel = getattr(plan, "relation", None)
    out = [rel.index_scan_of] if rel is not None and rel.index_scan_of \
        else []
    for c in plan.children:
        out.extend(_index_names(c))
    return sorted(out)


JOINS = {
    # A computed column on a join side: it must resolve to the columns
    # its expression reads, which the indexes cover.
    "computed_side": lambda o, li, col: o.select(
        "o_orderkey", price2=col("o_totalprice") * 2).join(
        li.select("l_orderkey", rev=col("l_extendedprice")
                  * (1 - col("l_discount"))),
        col("o_orderkey") == col("l_orderkey")),
    "with_column_side": lambda o, li, col: o.join(
        li.with_column("rev", col("l_extendedprice") * 2).select(
            "l_orderkey", "rev"),
        col("o_orderkey") == col("l_orderkey")).select(
        "o_orderkey", "o_totalprice", "rev"),
    "computed_above_join": lambda o, li, col: o.join(
        li, col("o_orderkey") == col("l_orderkey")).select(
        "o_orderkey", rev=col("l_extendedprice") * (1 - col("l_discount"))),
    "uncovered_side": lambda o, li, col: o.select(
        "o_orderkey", c2=col("o_custkey") * 2).join(
        li.select("l_orderkey", "l_extendedprice"),
        col("o_orderkey") == col("l_orderkey")),
}


@pytest.mark.parametrize("case", sorted(JOINS))
def test_join_rule_under_computed_select(indexed, case):
    root, paths = indexed
    names, tables = [], []
    for pkg in PKGS:
        s = _session(pkg, os.path.join(root, pkg.__name__))
        s.conf.num_buckets = 4
        s.enable_hyperspace()
        ds = JOINS[case](s.read.parquet(paths["orders"]),
                         s.read.parquet(paths["lineitem"]), pkg.col)
        names.append(_index_names(ds.optimized_plan()))
        tables.append(_sorted(ds.collect()))
    assert names[1] == names[0]
    want = [] if case == "uncovered_side" else ["li_idx", "ord_idx"]
    assert names[1] == want
    _assert_same(tables[1], tables[0])
