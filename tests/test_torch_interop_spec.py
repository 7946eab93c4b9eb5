"""The port's JSON query spec codec (interop/query.py) held to the JAX
package's: the interop-spec cases of tests/test_sort_limit.py,
test_expressions.py, test_datetime.py and test_window.py, each decoded
by both packages over the same files, the JAX package's answer the
oracle (and each case's own assertion kept), then the rest of the
codec's verbs and its errors.

Both packages read parquet, csv, json, orc, avro, text, delta and
iceberg sources (a csv, a delta and an iceberg spec case below)."""

from __future__ import annotations

import datetime
import importlib
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PACKAGES = (JAX, TORCH)


def _session(pkg, root: str):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, pkg.__name__),
                              **kw)
    s.conf.num_buckets = 4
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    return s


def _both(root: str, spec: dict):
    """The spec's answer through each package: {pkg: arrow table}."""
    out = {}
    for pkg in PACKAGES:
        q = importlib.import_module(f"{pkg.__name__}.interop.query")
        out[pkg] = q.dataset_from_spec(_session(pkg, root), spec).collect()
    return out


def _write(path: str, table: pa.Table, files: int = 1) -> None:
    os.makedirs(path)
    n = table.num_rows
    for i in range(files):
        pq.write_table(table.slice(i * n // files, n // files),
                       os.path.join(path, f"part-{i:05d}.parquet"))


@pytest.fixture()
def sort_env(tmp_path):
    """tests/test_sort_limit.py's env."""
    data = str(tmp_path / "data")
    rng = np.random.default_rng(5)
    n = 1000
    _write(data, pa.table({
        "k": pa.array(rng.permutation(n).astype(np.int64)),
        "v": pa.array(rng.integers(0, 50, n), type=pa.int64()),
        "pad": pa.array(rng.random(n)),
    }))
    return str(tmp_path), data


@pytest.fixture()
def expr_env(tmp_path):
    """tests/test_expressions.py's env."""
    data = str(tmp_path / "data")
    rng = np.random.default_rng(11)
    n = 2000
    t = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "price": pa.array(rng.random(n) * 100),
        "disc": pa.array(rng.random(n) * 0.1),
        "qty": pa.array(rng.integers(0, 50, n), type=pa.int64()),
        "tag": pa.array([("a", "b", "c")[i % 3] for i in range(n)]),
    })
    _write(data, t, files=2)
    return str(tmp_path), data, t.to_pandas()


@pytest.fixture()
def date_env(tmp_path):
    """tests/test_datetime.py's env."""
    data = str(tmp_path / "data")
    rng = np.random.default_rng(21)
    n = 40_000
    days = (np.arange(n) * 2556 // n).astype("timedelta64[D]")
    dates = np.datetime64(datetime.date(1992, 1, 1)) + days
    t = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "d": pa.array(dates),
        "v": pa.array(rng.random(n)),
    })
    _write(data, t, files=8)
    return str(tmp_path), data, t.to_pandas()


@pytest.fixture()
def window_env(tmp_path):
    """tests/test_window.py's env."""
    data = str(tmp_path / "sales")
    rng = np.random.default_rng(13)
    n = 4000
    t = pa.table({
        "grp": pa.array((np.arange(n) % 23).astype(np.int64)),
        "cls": pa.array([("a", "b", "c")[i % 3] for i in range(n)]),
        "rev": pa.array(np.round(rng.uniform(0, 50, n), 0)),
        "qty": pa.array(rng.integers(1, 20, n), type=pa.int64()),
        "rid": pa.array(np.arange(n, dtype=np.int64)),
    })
    _write(data, t)
    return str(tmp_path), data, t.to_pandas()


# ---------------------------------------------------------------------------
# The four files' spec cases
# ---------------------------------------------------------------------------
def test_interop_spec_sort_limit(sort_env):
    root, data = sort_env
    out = _both(root, {
        "source": {"format": "parquet", "path": data},
        "sort": [["k", True]],
        "limit": 4,
        "select": ["k"],
    })
    assert out[TORCH].equals(out[JAX])
    assert out[TORCH].column("k").to_pylist() == [0, 1, 2, 3]


def test_interop_spec_computed_select_and_agg(expr_env):
    root, data, df = expr_env
    spec = {
        "source": {"format": "parquet", "path": data},
        "filter": {"op": ">", "left": {"op": "*", "left": {"col": "price"},
                                       "right": {"col": "qty"}},
                   "right": {"value": 100.0}},
        "group_by": ["tag"],
        "aggs": {"rev": [{"op": "*", "left": {"col": "price"},
                          "right": {"op": "-", "left": 1,
                                    "right": {"col": "disc"}}}, "sum"]},
        "sort": ["tag"],
    }
    out = _both(root, spec)
    assert out[TORCH].column("tag").to_pylist() \
        == out[JAX].column("tag").to_pylist()
    np.testing.assert_allclose(out[TORCH].column("rev").to_numpy(),
                               out[JAX].column("rev").to_numpy(),
                               rtol=1e-9)
    mask = df["price"] * df["qty"] > 100.0
    sub = df[mask]
    want = (sub.assign(rev=sub["price"] * (1 - sub["disc"]))
            .groupby("tag").agg(rev=("rev", "sum")).reset_index()
            .sort_values("tag"))
    np.testing.assert_allclose(out[TORCH].column("rev").to_numpy(),
                               want["rev"].to_numpy())


def test_interop_codec_case_and_like(expr_env):
    root, data, df = expr_env
    out = _both(root, {
        "source": {"format": "parquet", "path": data},
        "filter": {"op": "like", "col": "tag", "pattern": "%a%"},
        "group_by": ["tag"],
        "aggs": {"n_high": [{"op": "case",
                             "branches": [[{"op": ">=", "col": "qty",
                                            "value": 25}, 1]],
                             "otherwise": 0}, "sum"]},
    })
    assert out[TORCH].equals(out[JAX])
    sub = df[df["tag"].str.contains("a")]
    assert out[TORCH].column("n_high").to_pylist() == \
        [int((sub["qty"] >= 25).sum())]


def test_extract_over_interop_spec(date_env):
    root, data, df = date_env
    out = _both(root, {
        "source": {"format": "parquet", "path": data},
        "select": ["k", {"name": "y", "expr":
                         {"op": "extract", "field": "year",
                          "child": {"col": "d"}}}],
        "limit": 5,
    })
    assert out[TORCH].equals(out[JAX])
    assert out[TORCH].column_names == ["k", "y"]
    assert out[TORCH].column("y").to_pylist() == \
        pd.to_datetime(df["d"].iloc[:5]).dt.year.tolist()


def test_window_over_spec(window_env):
    root, data, df = window_env
    out = _both(root, {
        "source": {"format": "parquet", "path": data},
        "window": [{"name": "rk", "func": "rank",
                    "partition_by": ["grp"],
                    "order_by": [["rev", False]]}],
        "qualify": {"op": "<=", "col": "rk", "value": 1},
    })
    assert out[TORCH].equals(out[JAX])
    want = int((df.groupby("grp")["rev"].transform("max")
                == df["rev"]).sum())
    assert out[TORCH].num_rows == want


# ---------------------------------------------------------------------------
# The rest of the codec, both packages
# ---------------------------------------------------------------------------
def _rows(t: pa.Table):
    return sorted(tuple(r.values()) for r in t.to_pylist())


@pytest.fixture()
def join_env(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    rng = np.random.default_rng(3)
    n = 600
    _write(a, pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(-20, 20, n), type=pa.int64()),
        "x": pa.array([None if i % 11 == 0 else float(i) for i in range(n)]),
        "s": pa.array([("alpha", "beta", "gamma")[i % 3] for i in range(n)]),
    }), files=2)
    _write(b, pa.table({
        "kb": pa.array(np.arange(0, n, 3, dtype=np.int64)),
        "w": pa.array(rng.integers(0, 5, n // 3), type=pa.int64()),
    }))
    return str(tmp_path), a, b


def _specs(a: str, b: str) -> dict:
    src = {"format": "parquet", "path": a}
    other = {"format": "parquet", "path": b}
    return {
        "join": {"source": src, "join": {
            "source": other, "filter": {"op": "<", "col": "w", "value": 3},
            "on": {"op": "==", "col": "k", "right_col": "kb"}},
            "select": ["k", "v", "w"]},
        "left_join": {"source": src, "join": {
            "source": other, "how": "left",
            "on": {"op": "==", "col": "k", "right_col": "kb"}},
            "select": ["k", "w"]},
        "bool_ops": {"source": src, "filter": {
            "op": "or", "left": {"op": "and",
                                 "left": {"op": ">=", "col": "k", "value": 10},
                                 "right": {"op": "not", "child": {
                                     "op": "is_null", "col": "x"}}},
            "right": {"op": "in", "col": "v", "values": [1, 2, 3]}},
            "select": ["k", "v"]},
        "union": {"source": src, "filter": {"op": "<", "col": "k",
                                            "value": 5},
                  "union": {"source": src, "filter": {
                      "op": ">", "col": "k", "value": 595}},
                  "select": ["k"]},
        "neg_cast": {"source": src, "select": [
            "k", {"name": "nv", "expr": {"op": "neg",
                                         "child": {"col": "v"}}},
            {"name": "vs", "expr": {"op": "cast", "type": "string",
                                    "child": {"col": "v"}}}],
            "limit": 20},
        "count_groups": {"source": src, "group_by": ["s"],
                         "sort": [["s", False]]},
        "in_subquery": {"source": src, "filter": {
            "op": "in_subquery", "col": "k", "query": {
                "source": other, "filter": {"op": "==", "col": "w",
                                            "value": 2},
                "select": ["kb"]}}, "select": ["k"]},
        "not_in_subquery": {"source": src, "filter": {"op": "not", "child": {
            "op": "in_subquery", "col": "k", "query": {
                "source": other, "select": ["kb"]}}}, "select": ["k"]},
        "scalar_subquery": {"source": src, "filter": {
            "op": ">", "left": {"col": "v"}, "right": {
                "op": "scalar_subquery", "query": {
                    "source": src, "aggs": {"m": ["v", "mean"]}}}},
            "select": ["k", "v"]},
        "string_match": {"source": src, "filter": {
            "op": "startswith", "col": "s", "pattern": "ga"},
            "aggs": {"n": ["k", "count"]}},
    }


@pytest.mark.parametrize("name", sorted(_specs("a", "b")))
def test_codec_verbs_equal_the_jax_package(join_env, name):
    root, a, b = join_env
    out = _both(root, _specs(a, b)[name])
    assert out[TORCH].num_rows > 0
    assert out[TORCH].column_names == out[JAX].column_names
    assert _rows(out[TORCH]) == _rows(out[JAX])


@pytest.mark.parametrize("spec, match", [
    ({"source": {"format": "excel", "path": "x"}}, "Unknown source format"),
    ({"source": {"path": "x"}, "filter": {"op": "~", "col": "k"}},
     "Unknown expression op"),
    ({"source": {"path": "x"}, "select": [
        "k", {"name": "y", "expr": {"op": "pow", "child": 1}}]},
     "Unknown value expression"),
])
def test_codec_errors_equal_the_jax_package(join_env, spec, match):
    root, a, _ = join_env
    spec = dict(spec)
    spec["source"] = {**spec["source"], "path": a}
    for pkg in PACKAGES:
        q = importlib.import_module(f"{pkg.__name__}.interop.query")
        with pytest.raises(ValueError, match=match):
            q.dataset_from_spec(_session(pkg, root), spec).collect()


def test_subquery_specs_need_a_session():
    for pkg in PACKAGES:
        q = importlib.import_module(f"{pkg.__name__}.interop.query")
        with pytest.raises(ValueError, match="only valid inside"):
            q.value_expr_from_json({"op": "scalar_subquery",
                                    "query": {"source": {"path": "x"}}})


@pytest.mark.parametrize("travel", [False, True],
                         ids=["latest", "snapshot-id"])
def test_iceberg_spec_equals_the_jax_package(join_env, travel):
    """A spec over an Iceberg table (two snapshots of join_env's ``a``),
    at its current snapshot and travelled back to the first by
    ``snapshot-id``, joined with a parquet source, answers as the JAX
    package's."""
    from hyperspace_tpu_torch.sources.iceberg import write_iceberg

    root, a, b = join_env
    t = os.path.join(root, "t")
    rows = pq.read_table(a, partitioning=None)
    first = write_iceberg(rows.slice(0, 400), t)
    write_iceberg(rows.slice(400), t)
    spec = {"source": {"format": "iceberg", "path": t},
            "filter": {"op": "<", "col": "v", "value": 5},
            "join": {"source": {"format": "parquet", "path": b},
                     "on": {"op": "==", "col": "k", "right_col": "kb"}},
            "select": ["k", "v", "s", "w"]}
    if travel:
        spec["source"]["options"] = {"snapshot-id": str(first)}
    out = _both(root, spec)
    keys = out[TORCH].column("k").to_pylist()
    assert keys and (max(keys) < 400) == travel
    assert out[TORCH].column_names == out[JAX].column_names
    assert _rows(out[TORCH]) == _rows(out[JAX])


@pytest.mark.parametrize("options", [{}, {"versionAsOf": "0"}],
                         ids=["latest", "versionAsOf"])
def test_delta_spec_equals_the_jax_package(join_env, options):
    """A spec over a Delta table (two commits of join_env's ``a``), at
    its latest version and travelled back to the first, joined with a
    parquet source, answers as the JAX package's."""
    from hyperspace_tpu_torch.sources.delta import write_delta

    root, a, b = join_env
    t = os.path.join(root, "t")
    rows = pq.read_table(a, partitioning=None)
    write_delta(rows.slice(0, 400), t)
    write_delta(rows.slice(400), t, mode="append")
    spec = {"source": {"format": "delta", "path": t, "options": options},
            "filter": {"op": "<", "col": "v", "value": 5},
            "join": {"source": {"format": "parquet", "path": b},
                     "on": {"op": "==", "col": "k", "right_col": "kb"}},
            "select": ["k", "v", "s", "w"]}
    if not options:
        del spec["source"]["options"]
    out = _both(root, spec)
    keys = out[TORCH].column("k").to_pylist()
    assert keys and (max(keys) < 400) == bool(options)
    assert out[TORCH].column_names == out[JAX].column_names
    assert _rows(out[TORCH]) == _rows(out[JAX])


def test_csv_spec_equals_the_jax_package(join_env):
    """A spec over a csv source (with its ``header`` option) and a join
    with a parquet one answers as the JAX package's."""
    import pyarrow.csv as pacsv

    root, a, b = join_env
    c = os.path.join(root, "c")
    os.makedirs(c)
    pacsv.write_csv(pq.read_table(a, partitioning=None),
                    os.path.join(c, "part-0.csv"))
    spec = {"source": {"format": "csv", "path": c,
                       "options": {"header": "true"}},
            "filter": {"op": "<", "col": "v", "value": 0},
            "join": {"source": {"format": "parquet", "path": b},
                     "on": {"op": "==", "col": "k", "right_col": "kb"}},
            "select": ["k", "v", "s", "w"]}
    out = _both(root, spec)
    assert out[TORCH].num_rows > 0
    assert out[TORCH].column_names == out[JAX].column_names
    assert _rows(out[TORCH]) == _rows(out[JAX])
