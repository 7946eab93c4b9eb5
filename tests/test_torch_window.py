"""Window functions of hyperspace_tpu_torch (on the CPU) against the JAX
package.

The same seeded data goes through both packages' ``with_window`` (each
package's own session, ``device="cpu"`` for the port): the tests of
tests/test_window.py and tests/test_window_frames.py, each held to the
JAX package's answer and to the literal values those tests check.  The
SQL, spec and ``cast`` front ends are not ported yet, so their tests
run here as the same windows written with the DSL.

Held alike on the host engine: column names and arrow types, rows in
order, and every value bit for bit, floats too (both engines sort with
arrow's stable sort and sum the same sorted rows left to right; NaN and
the sign of zero included).  The device-segment route (whole-partition
aggregates through ``ops.aggregate.grouped_aggregate``) is held to the
JAX package's device and host routes, its float sums within 1e-9
relative (another summation order), its strategies and ``resident``
flags exactly.

The unit cases hold each function of ``ops/window.py`` to its numpy
counterpart in ``hyperspace_tpu/ops/window.py``: ints, ranks and arg rows
exactly (``-0.0`` against ``0.0`` and NaN ties included), float sums and
means bit for bit."""

import datetime
import decimal
import os
import random

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.execution import device_cache as jax_cache
from hyperspace_tpu.ops import window as JW
from hyperspace_tpu_torch.execution import device_cache as torch_cache
from hyperspace_tpu_torch.ops import window as TW

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
RTOL = 1e-9


def _session(pkg, system_path):
    if pkg is hyperspace_tpu_torch:
        return pkg.HyperspaceSession(system_path=system_path, device="cpu")
    s = pkg.HyperspaceSession(system_path=system_path)
    s.conf.mesh_enabled = "off"
    return s


def _write(root, table, name="t"):
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    pq.write_table(table, os.path.join(d, "part.parquet"))
    return d


def _assert_same_column(got, want, name=""):
    """Two arrow columns of one type, equal value for value: floats bit
    for bit (NaN and -0.0 included), others by value."""
    if isinstance(got, pa.ChunkedArray):
        got = got.combine_chunks()
    if isinstance(want, pa.ChunkedArray):
        want = want.combine_chunks()
    assert got.type == want.type, name
    assert len(got) == len(want), name
    if pa.types.is_floating(want.type):
        assert got.is_valid().equals(want.is_valid()), name
        zero = pa.scalar(0.0, type=want.type)
        g = np.asarray(got.fill_null(zero).to_numpy(zero_copy_only=False))
        w = np.asarray(want.fill_null(zero).to_numpy(zero_copy_only=False))
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name
    else:
        assert got.to_pylist() == want.to_pylist(), name


def _assert_same_table(got, want):
    assert got.column_names == want.column_names
    for name in want.column_names:
        _assert_same_column(got.column(name), want.column(name), name)


def _both(tmp_path, data, build, sort=None):
    """(JAX table, port table) of ``build(dataset, col)`` over the
    parquet directory ``data``, the port's held to the JAX package's;
    ``sort`` keys sort both first (for outputs without a fixed order)."""
    out = []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        table = build(s.read.parquet(data), pkg.col).collect()
        if sort is not None:
            table = table.sort_by([(k, "ascending") for k in sort])
        out.append(table)
    _assert_same_table(out[1], out[0])
    return out


@pytest.fixture(scope="module")
def sales(tmp_path_factory):
    """tests/test_window.py's table: 4000 rows, 23 groups, 3 classes,
    revenue rounded to few values (ties are common)."""
    root = tmp_path_factory.mktemp("window")
    rng = np.random.default_rng(13)
    n = 4000
    t = pa.table({
        "grp": pa.array((np.arange(n) % 23).astype(np.int64)),
        "cls": pa.array([("a", "b", "c")[i % 3] for i in range(n)]),
        "rev": pa.array(np.round(rng.uniform(0, 50, n), 0)),
        "qty": pa.array(rng.integers(1, 20, n), type=pa.int64()),
        "rid": pa.array(np.arange(n, dtype=np.int64)),
        "q32": pa.array(rng.integers(1, 20, n).astype(np.int32)),
    })
    return _write(root, t, "sales"), t.to_pandas()


# ---------------------------------------------------------------------------
# tests/test_window.py
# ---------------------------------------------------------------------------
def test_row_number_and_ranks_match_jax(tmp_path, sales):
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: (
        ds.with_window("rn", "row_number", partition_by=["grp"],
                       order_by=[("rev", False), "rid"])
        .with_window("rk", "rank", partition_by=["grp"],
                     order_by=[("rev", False)])
        .with_window("dr", "dense_rank", partition_by=["grp"],
                     order_by=[("rev", False)])))
    out = got.to_pandas().sort_values("rid")
    g = df.sort_values("rid").groupby("grp")["rev"]
    np.testing.assert_array_equal(
        out["rk"], g.rank(method="min", ascending=False).astype(int))
    np.testing.assert_array_equal(
        out["dr"], g.rank(method="dense", ascending=False).astype(int))
    assert got.schema.field("rn").type == pa.int32()


def test_partition_aggregate_no_order(tmp_path, sales):
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: (
        ds.with_window("total", "sum", partition_by=["grp"], value="qty")
        .with_window("m", "mean", partition_by=["grp"], value="rev")
        .with_window("n", "count", partition_by=["grp"])))
    out = got.to_pandas().sort_values("rid")
    base = df.sort_values("rid")
    np.testing.assert_array_equal(
        out["total"], base.groupby("grp")["qty"].transform("sum"))
    np.testing.assert_array_equal(
        out["n"], base.groupby("grp")["rid"].transform("size"))


def test_running_sum_range_frame_shares_ties(tmp_path, sales):
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: ds.with_window(
        "run", "sum", partition_by=["grp"], order_by=["rev"], value="qty"))
    sdf = df.sort_values(["grp", "rev"], kind="stable")
    cs = sdf.groupby("grp")["qty"].cumsum()
    want = cs.groupby([sdf["grp"], sdf["rev"]]).transform("max")
    merged = got.to_pandas().set_index("rid")["run"]
    np.testing.assert_array_equal(merged.loc[sdf["rid"]].to_numpy(),
                                  want.to_numpy())


def test_running_min_max_and_global_window(tmp_path, sales):
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: (
        ds.with_window("lo", "min", order_by=["rid"], value="rev")
        .with_window("hi", "max", order_by=["rid"], value="rev")))
    out = got.to_pandas().sort_values("rid")
    np.testing.assert_array_equal(out["lo"], df["rev"].cummin())
    np.testing.assert_array_equal(out["hi"], df["rev"].cummax())


def test_nulls_in_value_and_keys(tmp_path):
    d = _write(tmp_path, pa.table({
        "g": pa.array([1, 1, 1, None, None], type=pa.int64()),
        "o": pa.array([1, 2, 3, 1, 2], type=pa.int64()),
        "v": pa.array([None, 4.0, None, None, 2.0]),
    }))
    _, got = _both(tmp_path, d, lambda ds, col: (
        ds.with_window("rs", "sum", partition_by=["g"], order_by=["o"],
                       value="v")
        .with_window("n", "count", partition_by=["g"], value="v")
        .sort("g", "o")))
    # Null partition keys form their own partition.
    assert got.column("rs").to_pylist() == [None, 2.0, None, 4.0, 4.0]
    assert got.column("n").to_pylist() == [1, 1, 1, 1, 1]


@pytest.mark.parametrize("func", ["rank", "row_number", "dense_rank",
                                  "lag", "ntile"])
def test_ranking_and_shifts_require_order_by(tmp_path, sales, func):
    data, _ = sales
    value = "qty" if func == "lag" else None
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "ix"))
        with pytest.raises(ValueError, match="ORDER BY"):
            s.read.parquet(data).with_window("r", func, partition_by=["grp"],
                                             value=value)


def test_top_rank_per_partition(tmp_path, sales):
    """tests/test_window.py's spec query (rank, then rk <= 1) in the
    DSL."""
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: (
        ds.with_window("rk", "rank", partition_by=["grp"],
                       order_by=[("rev", False)])
        .filter(col("rk") <= 1)))
    want = int((df.groupby("grp")["rev"].transform("max")
                == df["rev"]).sum())
    assert got.num_rows == want


def _window_queries(ds, col):
    """tests/test_window.py's TPC-DS shapes (q36, q44, q47)."""
    return {
        "w36": ds.group_by("cls", "grp")
        .agg(margin=(col("rev") * col("qty"), "sum"))
        .with_window("rk", "rank", partition_by=["cls"],
                     order_by=[("margin", False)])
        .filter(col("rk") <= 3).sort("cls", "rk"),
        "w44": ds.group_by("grp").agg(avg_rev=("rev", "mean"))
        .with_window("best", "row_number",
                     order_by=[("avg_rev", False), "grp"])
        .with_window("worst", "row_number",
                     order_by=[("avg_rev", True), "grp"])
        .filter((col("best") <= 5) | (col("worst") <= 5)).sort("best"),
        "w47": ds.group_by("grp", "cls").agg(s=("qty", "sum"))
        .with_window("avg_s", "mean", partition_by=["grp"], value="s")
        .filter((col("avg_s") > 0)
                & ((col("s") - col("avg_s")) / col("avg_s") > 0.05))
        .sort("grp", "cls"),
    }


@pytest.mark.parametrize("name", ["w36", "w44", "w47"])
def test_window_plans_and_answers_match_jax(tmp_path, sales, name):
    data, _ = sales
    plans, tables = [], []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        s.enable_hyperspace()
        ds = _window_queries(s.read.parquet(data), pkg.col)[name]
        plans.append(ds.optimized_plan().tree_string())
        tables.append(ds.collect())
    assert plans[1] == plans[0]
    assert "Window" in plans[1]
    _assert_same_table(tables[1], tables[0])


FUNCS = ["row_number", "rank", "dense_rank", "sum", "count", "min", "max",
         "mean"]
PARTS = [(), ("grp",), ("cls",), ("grp", "cls")]


@pytest.mark.parametrize("part", PARTS, ids=lambda p: "_".join(p) or "none")
@pytest.mark.parametrize("func", FUNCS)
def test_window_grid_matches_jax(tmp_path, sales, func, part):
    """tests/test_window.py's fuzz space, swept whole: each function by
    each partitioning, ascending and descending, with and without an
    ORDER BY."""
    data, _ = sales
    ranking = func in ("row_number", "rank", "dense_rank")
    for asc in (True, False):
        for with_order in ((True,) if ranking else (True, False)):
            order = [("rev", asc), ("rid", True)] if func == "row_number" \
                else ([("rev", asc)] if with_order else [])
            value = None if ranking or func == "count" else "qty"
            _both(tmp_path, data, lambda ds, col: ds.with_window(
                "w", func, partition_by=list(part), order_by=order,
                value=value))


def test_running_min_on_strings_raises_clearly(tmp_path):
    d = _write(tmp_path, pa.table({
        "g": pa.array([1, 1], type=pa.int64()),
        "o": pa.array([1, 2], type=pa.int64()),
        "s": pa.array(["b", "a"]),
    }))
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "ix"))
        with pytest.raises(ValueError, match="Running window min"):
            (s.read.parquet(d).with_window(
                "m", "min", partition_by=["g"], order_by=["o"],
                value="s").collect())
    _, got = _both(tmp_path, d, lambda ds, col: ds.with_window(
        "m", "min", partition_by=["g"], value="s"))
    assert got.column("m").to_pylist() == ["a", "a"]


def test_window_sum_type_stable_on_empty_input(tmp_path, sales):
    data, _ = sales
    _, full = _both(tmp_path, data, lambda ds, col: ds.with_window(
        "sm", "sum", partition_by=["grp"], value="q32"))
    _, empty = _both(tmp_path, data, lambda ds, col: ds.filter(
        col("rid") < 0).with_window("sm", "sum", partition_by=["grp"],
                                    value="q32"))
    assert empty.num_rows == 0
    assert full.schema.field("sm").type == empty.schema.field("sm").type \
        == pa.int64()


def test_lag_lead_match_jax(tmp_path, sales):
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: (
        ds.with_window("prev", "lag", partition_by=["grp"],
                       order_by=["rid"], value="qty")
        .with_window("nxt", "lead", partition_by=["grp"],
                     order_by=["rid"], value="qty")
        .with_window("prev2", "lag", partition_by=["grp"],
                     order_by=["rid"], value="qty", offset=2)
        .with_window("same", "lag", partition_by=["grp"],
                     order_by=["rid"], value="rev", offset=0)))
    assert got.schema.field("prev").type == pa.int64()
    out = got.to_pandas().sort_values("rid")
    g = df.sort_values("rid").groupby("grp")["qty"]
    np.testing.assert_array_equal(out["prev"].to_numpy(),
                                  g.shift(1).to_numpy())
    np.testing.assert_array_equal(out["nxt"].to_numpy(),
                                  g.shift(-1).to_numpy())
    np.testing.assert_array_equal(out["prev2"].to_numpy(),
                                  g.shift(2).to_numpy())


def test_lag_q47_shape(tmp_path, sales):
    """tests/test_window.py's q47 prev-period SQL, in the DSL."""
    data, df = sales
    _, got = _both(tmp_path, data, lambda ds, col: (
        ds.select("grp", "rid", "qty")
        .with_window("prev_qty", "lag", partition_by=["grp"],
                     order_by=["rid"], value="qty", offset=1)))
    want = df.sort_values("rid").groupby("grp")["qty"].shift(1)
    np.testing.assert_array_equal(
        got.to_pandas().sort_values("rid")["prev_qty"].to_numpy(),
        want.to_numpy())


def test_lag_preserves_int64_exactly(tmp_path):
    big = 2**53 + 1
    d = _write(tmp_path, pa.table({
        "g": pa.array([1, 1], type=pa.int64()),
        "o": pa.array([1, 2], type=pa.int64()),
        "v": pa.array([big, 7], type=pa.int64()),
    }))
    _, got = _both(tmp_path, d, lambda ds, col: (
        ds.with_window("p", "lag", partition_by=["g"], order_by=["o"],
                       value="v")
        .with_window("nx", "lead", partition_by=["g"], order_by=["o"],
                     value="v").sort("o")))
    assert got.column("p").to_pylist() == [None, big]
    assert got.column("nx").to_pylist() == [7, None]
    assert got.schema.field("p").type == pa.int64()


# ---------------------------------------------------------------------------
# tests/test_window_frames.py
# ---------------------------------------------------------------------------
def _base():
    return pa.table({
        "g": pa.array([1, 1, 1, 1, 2, 2, 2], type=pa.int64()),
        "o": pa.array([1, 2, 3, 4, 1, 2, 3], type=pa.int64()),
        "v": pa.array([10, None, 30, 40, 5, 6, None], type=pa.int64()),
    })


def _ties():
    return pa.table({
        "g": pa.array([1, 1, 1], type=pa.int64()),
        "o": pa.array([1, 1, 2], type=pa.int64()),  # rows 0, 1 are peers
        "v": pa.array([10, 20, 30], type=pa.int64()),
    })


_DAYS = [datetime.date(2026, 1, x) for x in (5, 2, 9, 1)]


def _w(name, func, part=("g",), order=("o",), value="v", **kw):
    return lambda ds, col: ds.with_window(
        name, func, partition_by=list(part), order_by=list(order),
        value=value, **kw)


# name -> (table, query, sort keys, column, expected values); the names
# are tests/test_window_frames.py's (its SQL tests in the DSL).
FRAME_CASES = {
    "rows_unbounded_preceding_current": (
        _base, _w("rs", "sum", frame=(None, 0)), ("g", "o"), "rs",
        [10, 10, 40, 80, 5, 11, 11]),
    "range_frame_on_ties": (
        _ties, _w("rs", "sum"), ("o",), "rs", [30, 30, 60]),
    "rows_frame_on_ties": (
        _ties, _w("rs", "sum", frame=(None, 0)), ("rs",), "rs",
        [10, 30, 60]),
    "rows_centered_frame": (
        _base, _w("m", "sum", frame=(-1, 1)), ("g", "o"), "m",
        [10, 40, 70, 70, 11, 11, 6]),
    "rows_suffix_frame_min": (
        _base, _w("m", "min", frame=(0, None)), ("g", "o"), "m",
        [10, 30, 30, 40, 5, 6, None]),
    "rows_frame_empty_yields_null": (
        _base, _w("s", "sum", frame=(2, 3)), ("g", "o"), "s",
        [70, 40, None, None, None, None, None]),
    "rows_frame_count_star_counts_rows": (
        _base, _w("c", "count", value=None, frame=(-1, 0)), ("g", "o"), "c",
        [1, 2, 2, 2, 1, 2, 2]),
    "rows_frame_bounded_max_dates": (
        lambda: pa.table({"o": pa.array([1, 2, 3, 4], type=pa.int64()),
                          "dt": pa.array(_DAYS, type=pa.date32())}),
        _w("mx", "max", part=(), value="dt", frame=(-1, 0)), ("o",), "mx",
        [_DAYS[0], _DAYS[0], _DAYS[2], _DAYS[2]]),
    "first_value_default_frame": (
        _base, _w("fv", "first_value"), ("g", "o"), "fv",
        [10, 10, 10, 10, 5, 5, 5]),
    "last_value_default_frame": (
        _base, _w("lv", "last_value"), ("g", "o"), "lv",
        [10, None, 30, 40, 5, 6, None]),
    "last_value_unbounded_following": (
        _base, _w("lv", "last_value", frame=(None, None)), ("g", "o"), "lv",
        [40, 40, 40, 40, None, None, None]),
    "first_value_without_order_by_whole_partition": (
        _base, _w("fv", "first_value", order=()), ("g", "o"), "fv",
        [10, 10, 10, 10, 5, 5, 5]),
    "ntile_spark_distribution": (
        lambda: pa.table({"o": pa.array(list(range(7)), type=pa.int64())}),
        _w("t", "ntile", part=(), value=None, offset=3), ("o",), "t",
        [1, 1, 1, 2, 2, 3, 3]),
    "ntile_more_tiles_than_rows": (
        lambda: pa.table({"o": pa.array([1, 2], type=pa.int64())}),
        _w("t", "ntile", part=(), value=None, offset=5), ("o",), "t", [1, 2]),
    "running_int_sum_exact_above_2_53": (
        lambda: pa.table({"g": pa.array([1, 1, 1], type=pa.int64()),
                          "o": pa.array([1, 2, 3], type=pa.int64()),
                          "v": pa.array([2**55, None, 3], type=pa.int64())}),
        _w("rs", "sum"), ("o",), "rs", [2**55, 2**55, 2**55 + 3]),
    "user_part_column_does_not_collide": (
        lambda: pa.table({"__part": pa.array([1, 1, 2], type=pa.int64()),
                          "o": pa.array([1, 2, 1], type=pa.int64())}),
        _w("rn", "row_number", part=("__part",), value=None),
        ("__part", "o"), "rn", [1, 2, 1]),
    "sql_rows_shorthand": (
        _base, _w("s1", "sum", frame=(-1, 0)), ("g", "o"), "s1",
        [10, 10, 30, 70, 5, 11, 6]),
    "sql_ntile_2": (
        _base, _w("nt", "ntile", value=None, offset=2), ("g", "o"), "nt",
        [1, 1, 2, 2, 1, 1, 2]),
    "frame_entirely_outside_partition_min": (
        lambda: pa.table({"o": pa.array([1], type=pa.int64()),
                          "v": pa.array([7], type=pa.int64())}),
        _w("m", "min", part=(), frame=(2, None)), ("o",), "m", [None]),
    "frame_entirely_outside_partition_max": (
        lambda: pa.table({"o": pa.array([1, 2, 3], type=pa.int64()),
                          "v": pa.array([7, 8, 9], type=pa.int64())}),
        _w("m", "max", part=(), frame=(None, -5)), ("o",), "m",
        [None, None, None]),
    "uint64_window_min_above_2_63": (
        lambda: pa.table({"o": pa.array([1, 2], type=pa.int64()),
                          "v": pa.array([2**63 + 10, 1], type=pa.uint64())}),
        _w("m", "min", part=(), frame=(None, None)), ("o",), "m", [1, 1]),
    "decimal_window_min_exact": (
        lambda: pa.table({
            "o": pa.array([1, 2], type=pa.int64()),
            "v": pa.array([decimal.Decimal("12345678901234567.89"),
                           decimal.Decimal("12345678901234567.88")],
                          type=pa.decimal128(38, 2))}),
        _w("m", "min", part=(), order=()), ("o",), "m",
        [decimal.Decimal("12345678901234567.88")] * 2),
    "nan_does_not_poison_other_frames_sum": (
        lambda: pa.table({"o": pa.array([1, 2, 3], type=pa.int64()),
                          "v": pa.array([float("nan"), 1.0, 2.0])}),
        _w("s", "sum", part=(), frame=(0, 0)), ("o",), "s",
        [None, 1.0, 2.0]),
    "nan_does_not_poison_other_frames_mean": (
        lambda: pa.table({"o": pa.array([1, 2, 3], type=pa.int64()),
                          "v": pa.array([float("nan"), 1.0, 2.0])}),
        _w("m", "mean", part=(), frame=(None, 0)), ("o",), "m",
        [None, 1.0, 1.5]),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_frame_case_matches_jax(tmp_path, case):
    make, query, keys, column, want = FRAME_CASES[case]
    d = _write(tmp_path, make())
    _, got = _both(tmp_path, d, query, sort=keys)
    assert got.column(column).to_pylist() == want


def test_sql_rows_between_and_range_default(tmp_path):
    """tests/test_window_frames.py's ROWS BETWEEN ... CURRENT ROW and
    RANGE default forms: the same running sum."""
    d = _write(tmp_path, _base())
    for frame in ((None, 0), None):
        _, got = _both(tmp_path, d, lambda ds, col: ds.with_window(
            "rs", "sum", partition_by=["g"], order_by=["o"], value="v",
            frame=frame).sort("g", "o"))
        assert got.column("rs").to_pylist() == [10, 10, 40, 80, 5, 11, 11]


def test_sql_first_value_and_ntile_together(tmp_path):
    d = _write(tmp_path, _base())
    _, got = _both(tmp_path, d, lambda ds, col: (
        ds.with_window("fv", "first_value", partition_by=["g"],
                       order_by=["o"], value="v")
        .with_window("nt", "ntile", partition_by=["g"], order_by=["o"],
                     offset=2)
        .select("g", "o", "fv", "nt").sort("g", "o")))
    assert got.column("fv").to_pylist() == [10, 10, 10, 10, 5, 5, 5]


def test_uint64_window_sum_overflow_raises(tmp_path):
    d = _write(tmp_path, pa.table({
        "o": pa.array([1, 2], type=pa.int64()),
        "v": pa.array([2**63 + 10, 1], type=pa.uint64()),
    }))
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "ix"))
        with pytest.raises(ValueError, match="overflows"):
            s.read.parquet(d).with_window(
                "s", "sum", order_by=["o"], value="v",
                frame=(None, None)).collect()


def test_decimal_running_frame_raises(tmp_path):
    d = _write(tmp_path, pa.table({
        "o": pa.array([1, 2], type=pa.int64()),
        "v": pa.array([decimal.Decimal("1.25"), decimal.Decimal("2.50")],
                      type=pa.decimal128(38, 2)),
    }))
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "ix"))
        with pytest.raises(ValueError, match="not supported"):
            s.read.parquet(d).with_window(
                "s", "sum", order_by=["o"], value="v").collect()
    _, got = _both(tmp_path, d, lambda ds, col: ds.with_window(
        "s", "sum", value="v").with_window("m", "mean", value="v"))
    assert got.schema.field("s").type == pa.float64()


def test_bool_window_sum_schema_stable_on_empty(tmp_path):
    d = _write(tmp_path, pa.table({
        "o": pa.array([1, 2], type=pa.int64()),
        "v": pa.array([True, False], type=pa.bool_()),
    }))
    _, full = _both(tmp_path, d, lambda ds, col: ds.with_window(
        "s", "sum", value="v"))
    _, empty = _both(tmp_path, d, lambda ds, col: ds.filter(
        col("o") < 0).with_window("s", "sum", value="v"))
    assert full.schema.field("s").type == empty.schema.field("s").type \
        == pa.int64()
    assert full.column("s").to_pylist() == [1, 1]


def test_frame_survives_column_pruning(tmp_path):
    d = _write(tmp_path, pa.table({
        "g": pa.array([1, 1, 1], type=pa.int64()),
        "o": pa.array([1, 2, 3], type=pa.int64()),
        "v": pa.array([10, 20, 30], type=pa.int64()),
        "unused": pa.array([0, 0, 0], type=pa.int64()),
    }))
    _, got = _both(tmp_path, d, lambda ds, col: ds.with_window(
        "s", "sum", partition_by=["g"], order_by=["o"], value="v",
        frame=(-1, 0)).select("o", "s").sort("o"))
    assert got.column("s").to_pylist() == [10, 30, 50]


def test_order_by_distinguishes_same_func_windows(tmp_path):
    """tests/test_window_frames.py's two sum(sum(..)) windows over a
    GROUP BY, ordered by the first, in the DSL."""
    d = _write(tmp_path, pa.table({
        "g": pa.array([1, 1, 2, 2], type=pa.int64()),
        "a": pa.array([1, 2, 100, 200], type=pa.int64()),
        "b": pa.array([50, 60, 1, 2], type=pa.int64()),
    }))
    _, got = _both(tmp_path, d, lambda ds, col: (
        ds.group_by("g").agg(sa=("a", "sum"), sb=("b", "sum"))
        .with_window("m", "sum", partition_by=["g"], value="sa")
        .with_window("n", "sum", partition_by=["g"], value="sb")
        .sort("m").select("g", "m", "n")))
    assert got.column("m").to_pylist() == [3, 300]


_INVALID = {
    "frame_requires_order_by": (
        dict(func="sum", value="v", frame=(None, 0)), "ORDER BY"),
    "frame_rejected_for_ranking": (
        dict(func="rank", order_by=["o"], frame=(None, 0)), "frame"),
    "frame_lo_above_hi": (
        dict(func="sum", value="v", order_by=["o"], frame=(2, 1)),
        "above upper bound"),
    "frame_bound_not_int": (
        dict(func="sum", value="v", order_by=["o"], frame=(0.5, 1)),
        "ints or None"),
    "frame_not_a_pair": (
        dict(func="sum", value="v", order_by=["o"], frame=(1,)),
        "pair of row offsets"),
    "ntile_count": (dict(func="ntile", order_by=["o"], offset=0),
                    "positive integer"),
    "rank_takes_no_value": (dict(func="rank", order_by=["o"], value="v"),
                            "takes no value"),
    "sum_needs_a_value": (dict(func="sum"), "needs a value column"),
    "unknown_function": (dict(func="median", value="v"),
                         "Unsupported window function"),
    "order_key_shape": (dict(func="rank", order_by=[("o", True, 1)]),
                        "order key"),
}


@pytest.mark.parametrize("case", sorted(_INVALID))
def test_invalid_windows_raise_alike(tmp_path, case):
    """The validation errors (tests/test_window_frames.py's frame checks
    and the node's others) in both packages."""
    kwargs, match = _INVALID[case]
    d = _write(tmp_path, _base())
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "ix"))
        kw = dict(kwargs)
        func = kw.pop("func")
        with pytest.raises(ValueError, match=match):
            s.read.parquet(d).with_window("w", func, partition_by=["g"],
                                          **kw)


FUZZ_FRAMES = [None, (None, 0), (None, None), (0, None), (-1, 1), (-2, 0),
               (0, 2), (1, 3), (-3, -1)]


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_frames_match_jax(tmp_path, trial):
    """tests/test_window_frames.py's fuzz tables (nulls, ties, short
    partitions): every frame function by every frame, two tables each."""
    rng = random.Random(1234 + trial)
    for sub in range(2):
        n = rng.randint(1, 40)
        d = _write(tmp_path, pa.table({
            "g": pa.array([rng.randint(0, 3) for _ in range(n)],
                          type=pa.int64()),
            "o": pa.array([rng.randint(0, 6) for _ in range(n)],
                          type=pa.int64()),
            "v": pa.array([rng.choice([None] + list(range(-5, 20)))
                           for _ in range(n)], type=pa.int64()),
            "f": pa.array([rng.choice([None, float("nan"), -0.0, 0.0, 1.5,
                                       -2.25, 1e300])
                           for _ in range(n)]),
        }), name=f"fz{sub}")
        for func in ("sum", "count", "mean", "min", "max", "first_value",
                     "last_value"):
            for frame in FUZZ_FRAMES:
                order = [("o", rng.random() < 0.5)]
                if frame is None and func not in ("first_value",
                                                  "last_value") \
                        and rng.random() < 0.5:
                    order = []
                for value in ("v", "f"):
                    _both(tmp_path, d, lambda ds, col: ds.with_window(
                        "w", func, partition_by=["g"], order_by=order,
                        value=value, frame=frame))


# ---------------------------------------------------------------------------
# tests/test_device_cache.py's window tests: the device-segment route
# ---------------------------------------------------------------------------
@pytest.fixture()
def cache_data(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    rng = np.random.default_rng(2)
    n = 20_000
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "g": pa.array((np.arange(n) % 64).astype(np.int64)),
        "v": pa.array(rng.random(n)),
        "i": pa.array(rng.integers(-10**12, 10**12, n)),
    }), os.path.join(data, "p.parquet"))
    jax_cache.global_cache().clear()
    torch_cache.global_cache().clear()
    yield data
    jax_cache.global_cache().clear()
    torch_cache.global_cache().clear()


def _device_session(pkg, path):
    """The JAX test's conf: eager caching, resident threshold 1; the
    port's CPU session also needs its cold "agg" threshold at 1 (its
    static default keeps the host), the JAX package's routes by the
    resident threshold alone."""
    s = _session(pkg, path)
    s.conf.device_cache_policy = "eager"
    s.conf.device_resident_min_rows = 1
    if pkg is hyperspace_tpu_torch:
        s.conf.device_agg_min_rows = 1
    return s


def _to_host_route(s):
    s.conf.device_cache_policy = "off"
    s.conf.device_agg_min_rows = 1 << 60


def _assert_close_column(got, want):
    got = got.combine_chunks() if isinstance(got, pa.ChunkedArray) else got
    want = want.combine_chunks() if isinstance(want, pa.ChunkedArray) \
        else want
    assert got.type == want.type
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=RTOL)


def test_warm_repeat_window_aggregate_resident(tmp_path, cache_data):
    """Both chained whole-partition windows take the device-segment
    route (the identity carries through the first window), resident on
    the repeat; answers held to the JAX package's device and host
    routes."""
    def q(s):
        return (s.read.parquet(cache_data)
                .with_window("total", "sum", partition_by=["g"], value="v")
                .with_window("n", "count", partition_by=["g"])
                .with_window("lo", "min", partition_by=["g"], value="i")
                .with_window("avg", "mean", partition_by=["g"], value="i")
                .sort("k").collect())

    runs = {}
    for pkg in PKGS:
        s = _device_session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        first = q(s)
        st1 = s.last_execution_stats
        second = q(s)
        st2 = s.last_execution_stats
        _to_host_route(s)
        host = q(s)
        assert "windows" not in (s.last_execution_stats or {})
        runs[pkg] = (first, st1, second, st2, host)
    first, st1, second, st2, host = runs[hyperspace_tpu_torch]
    assert len(st1["windows"]) == 4
    assert all(w["strategy"] == "device-segment" for w in st1["windows"])
    assert st1["windows"][0]["resident"] is False
    assert len(st2["windows"]) == 4
    assert all(w["resident"] for w in st2["windows"])
    assert first.column("total").equals(second.column("total"))
    j_first, j_st1, j_second, j_st2, j_host = runs[hyperspace_tpu]
    assert st1["windows"] == j_st1["windows"]
    assert st2["windows"] == j_st2["windows"]
    assert st2["device_cache"] == j_st2["device_cache"]
    # The host engines agree bit for bit, the device routes within RTOL.
    _assert_same_table(host, j_host)
    for got in (first, second):
        for name in ("k", "g", "v", "i", "n", "lo"):
            _assert_same_column(got.column(name), j_first.column(name), name)
        for name in ("total", "avg"):
            _assert_close_column(got.column(name), j_second.column(name))
            _assert_close_column(got.column(name), host.column(name))


def test_device_window_ineligible_shapes_stay_host(tmp_path, cache_data):
    shapes = {
        "running": dict(func="sum", partition_by=["g"], order_by=["k"],
                        value="v"),
        "two_keys": dict(func="sum", partition_by=["g", "k"], value="v"),
        "float_key": dict(func="max", partition_by=["v"], value="i"),
        "rank": dict(func="rank", partition_by=["g"], order_by=["v"]),
    }
    for label, kw in shapes.items():
        tables = []
        for pkg in PKGS:
            s = _device_session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
            kw2 = dict(kw)
            func = kw2.pop("func")
            tables.append(s.read.parquet(cache_data)
                          .with_window("w", func, **kw2).collect())
            assert "windows" not in (s.last_execution_stats or {}), label
        _assert_same_table(tables[1], tables[0])


def test_device_count_star_window_matches_host(tmp_path, cache_data):
    def q(s):
        return (s.read.parquet(cache_data)
                .with_window("n", "count", partition_by=["g"])
                .sort("k").collect())

    s = _device_session(hyperspace_tpu_torch, str(tmp_path / "ix"))
    dev = q(s)
    assert s.last_execution_stats["windows"][-1]["strategy"] \
        == "device-segment"
    _to_host_route(s)
    host = q(s)
    assert "windows" not in (s.last_execution_stats or {})
    assert host.column("n").equals(dev.column("n"))
    assert dev.schema.field("n").type == pa.int64()
    sj = _device_session(hyperspace_tpu, str(tmp_path / "ixj"))
    _assert_same_table(dev, q(sj))


def test_a_window_replacing_a_cached_column_is_not_served_stale(tmp_path):
    """A window named like a source column replaces it; the identity it
    carries no longer covers that column, so a device aggregate over it
    reads the window's values, not the source column cached before.
    The JAX package keeps the column cacheable and answers with the
    source's values (a reference fault, ROADMAP Queue C)."""
    d = str(tmp_path / "data")
    os.makedirs(d)
    n = 1000
    pq.write_table(pa.table({
        "g": pa.array((np.arange(n) % 8).astype(np.int64)),
        "v": pa.array(np.arange(n, dtype=np.float64)),
    }), os.path.join(d, "p.parquet"))
    v = np.arange(n, dtype=np.float64)
    source_sums = [v[np.arange(n) % 8 == g].sum() for g in range(8)]
    window_sums = [v[np.arange(n) % 8 == g].max() * (n // 8)
                   for g in range(8)]
    got = {}
    for pkg in PKGS:
        s = _device_session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
        s.conf.device_agg_min_rows = 1
        ds = s.read.parquet(d)
        first = ds.group_by("g").agg(s=("v", "sum")).sort("g").collect()
        assert first.column("s").to_pylist() == source_sums
        got[pkg] = (ds.with_window("v", "max", partition_by=["g"], value="v")
                    .group_by("g").agg(s=("v", "sum")).sort("g").collect()
                    .column("s").to_pylist())
        assert s.last_execution_stats["aggregates"][-1]["strategy"] \
            == "device-segment"
    assert got[hyperspace_tpu_torch] == window_sums
    assert got[hyperspace_tpu] == source_sums


def test_device_window_on_a_cuda_session_needs_the_card(tmp_path):
    """Without a card a session refuses ``cuda``; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        hyperspace_tpu_torch.HyperspaceSession(
            system_path=str(tmp_path / "ix"))


# ---------------------------------------------------------------------------
# ops/window.py against hyperspace_tpu/ops/window.py
# ---------------------------------------------------------------------------
def _layout(seed: int, n: int):
    """(new_part, new_tie) boundary masks of a sorted layout."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, 5, n))
    new_part = np.ones(n, dtype=bool)
    new_part[1:] = part[1:] != part[:-1]
    new_tie = new_part | (rng.random(n) < 0.4)
    return new_part, new_tie


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_segments_and_ranking_match_jax(seed):
    for n in (1, 2, 17, 300):
        new_part, new_tie = _layout(seed, n)
        ps, pe = JW.segment_bounds(new_part)
        tps, tpe = TW.segment_bounds(_t(new_part))
        np.testing.assert_array_equal(tps.numpy(), ps)
        np.testing.assert_array_equal(tpe.numpy(), pe)
        np.testing.assert_array_equal(TW.row_number(tps).numpy(),
                                      JW.row_number(ps))
        np.testing.assert_array_equal(
            TW.rank_from_ties(tps, _t(new_tie)).numpy(),
            JW.rank_from_ties(ps, new_tie))
        np.testing.assert_array_equal(
            TW.dense_rank_from_ties(_t(new_part), _t(new_tie)).numpy(),
            JW.dense_rank_from_ties(new_part, new_tie))
        for k in (1, 2, 3, 7, 500):
            got = TW.ntile(tps, tpe, k)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), JW.ntile(ps, pe, k))


def _values(kind: str, n: int, rng):
    if kind == "int64":
        return rng.integers(-50, 50, n).astype(np.int64)
    if kind == "int64_wraps":
        return rng.choice(np.array([2**62, 2**62 + 1, -3, 2**53 + 1]), n)
    if kind == "float_zeros_nan":
        # -0.0 against 0.0 and NaN ties decide the arg rows.
        return rng.choice(np.array([0.0, -0.0, 1.5, np.nan, -2.25, 1e300,
                                    np.inf]), n)
    if kind == "float_normal":
        return rng.standard_normal(n) * 1e6
    if kind == "uint64":
        return rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    if kind == "bool":
        return rng.random(n) < 0.5
    raise AssertionError(kind)


KINDS = ["int64", "int64_wraps", "float_zeros_nan", "float_normal", "uint64",
         "bool"]
UNIT_FRAMES = [None, "whole", (None, 0), (None, None), (0, None), (-1, 1),
               (-6, 0), (1, 3), (-3, -1), (-40, 40)]


@pytest.mark.parametrize("frame", UNIT_FRAMES, ids=str)
@pytest.mark.parametrize("kind", KINDS)
def test_frame_functions_match_jax(kind, frame):
    rng = np.random.default_rng(KINDS.index(kind))
    for n in (1, 5, 257):
        new_part, new_tie = _layout(n, n)
        vals = _values(kind, n, rng)
        if kind == "bool":
            vals = vals.astype(np.int8)  # as the executor lowers bools
        valid = rng.random(n) < 0.8
        has_order = frame != "whole"
        fr = None if frame == "whole" else frame
        ps, pe = JW.segment_bounds(new_part)
        _, te = JW.segment_bounds(new_tie)
        lo, hi = JW.frame_bounds(ps, pe, te, fr, has_order)
        tps, tpe = TW.segment_bounds(_t(new_part))
        _, tte = TW.segment_bounds(_t(new_tie))
        tlo, thi = TW.frame_bounds(tps, tpe, tte, fr, has_order)
        np.testing.assert_array_equal(tlo.numpy(), lo)
        np.testing.assert_array_equal(thi.numpy(), hi)
        tv = vals if kind == "uint64" else _t(vals)
        tvalid = _t(valid)
        np.testing.assert_array_equal(
            TW.frame_count(tvalid, tlo, thi).numpy(),
            JW.frame_count(valid, lo, hi))
        np.testing.assert_array_equal(
            TW.frame_count(None, tlo, thi).numpy(),
            JW.frame_count(None, lo, hi))
        js, jc = JW.frame_sum(vals, valid, lo, hi)
        ts, tc = TW.frame_sum(tv, tvalid, tlo, thi)
        ts = ts if isinstance(ts, np.ndarray) else ts.numpy()
        np.testing.assert_array_equal(tc.numpy(), jc)
        assert ts.dtype == js.dtype
        assert np.array_equal(ts.view(np.uint8), js.view(np.uint8))
        with np.errstate(all="ignore"):
            jm, jmc = JW.frame_mean(vals, valid, lo, hi)
        tm, tmc = TW.frame_mean(tv, tvalid, tlo, thi)
        np.testing.assert_array_equal(tmc.numpy(), jmc)
        some = jmc > 0
        assert np.array_equal(tm.numpy()[some].view(np.uint8),
                              jm[some].view(np.uint8))
        for is_min in (True, False):
            ja, jac = JW.frame_min_max(vals, valid, lo, hi, ps, pe, fr,
                                       is_min)
            ta, tac = TW.frame_min_max(tv, tvalid, tlo, thi, tps, tpe, fr,
                                       is_min)
            np.testing.assert_array_equal(tac.numpy(), jac)
            np.testing.assert_array_equal(ta.numpy(), ja)
        for first in (True, False):
            ja, jn = JW.frame_first_last(lo, hi, first)
            ta, tn = TW.frame_first_last(tlo, thi, first)
            np.testing.assert_array_equal(ta.numpy(), ja)
            np.testing.assert_array_equal(tn.numpy(), jn)


def test_float_prefix_sums_bit_equal_to_numpy():
    """torch's CPU cumsum adds float64 left to right as numpy's does, so
    the prefix over a million rows is numpy's bit for bit, a leading run
    of -0.0 included."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(1_000_000) * 1e4
    x[:3] = -0.0
    want = np.zeros(x.size + 1)
    np.cumsum(x, out=want[1:])
    got = TW._prefix(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_partition_codes_match_jax():
    rng = np.random.default_rng(4)
    n = 500
    table = pa.table({
        "i": pa.array(rng.choice([None, 1, 2, 3], n), type=pa.int64()),
        "s": pa.array(rng.choice([None, "a", "b"], n).tolist()),
        "f": pa.array(rng.choice([np.nan, -0.0, 0.0, 1.0], n)),
        "i8": pa.array(rng.integers(-3, 3, n).astype(np.int8)),
    })
    for keys in ([], ["i"], ["s"], ["f"], ["i", "s"], ["i", "s", "f", "i8"]):
        got = TW.partition_codes(table, keys)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      JW.partition_codes(table, keys))
    wide = pa.table({f"k{j}": pa.array(np.arange(n) * (j + 1) % 97)
                     for j in range(12)})
    np.testing.assert_array_equal(
        TW.partition_codes(wide, wide.column_names).numpy(),
        JW.partition_codes(wide, wide.column_names))
