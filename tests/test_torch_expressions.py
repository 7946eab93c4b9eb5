"""The string, CASE, CAST and date expressions of hyperspace_tpu_torch
(on the CPU) against the JAX package, with the year-range
canonicalization.

The same seeded tables go through both packages: the non-SQL cases of
tests/test_expressions.py (string predicates, CASE, CAST, IN with nulls,
the temporal routing-parity cases), tests/test_string_functions.py and
tests/test_datetime.py (extract, canonicalization, data skipping on
``year``, a date key, Z-order on a date, a tz-aware column, years out of
range).  Rows are compared in order where the query sorts them, else as
sets; ints, strings and dates must be equal, floats within 1e-9
relative.  A query either package refuses must be refused by the other
with the same error type and message.  The optimized plans of the
canonicalized filters print alike, and each new node takes the host
route in both packages."""

import datetime
import importlib
import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
HIGH = 10**9
RTOL = 1e-9
BASE = datetime.date(1992, 1, 1)


def _session(pkg, system_path, threshold=None):
    if pkg is hyperspace_tpu_torch:
        s = pkg.HyperspaceSession(system_path=system_path, device="cpu")
        s.conf.device_build_min_rows = 0
        # Residency never lowers a threshold here: routes stay the cold ones.
        s.conf.device_resident_min_rows = HIGH
    else:
        s = pkg.HyperspaceSession(system_path=system_path)
        s.conf.mesh_enabled = "off"
        s.conf.device_cache_policy = "off"
    s.conf.num_buckets = 4
    if threshold is not None:
        s.conf.device_filter_min_rows = threshold
    return s


def _write(root, name, table, n_files=1):
    path = os.path.join(str(root), name)
    os.makedirs(path)
    step = -(-table.num_rows // n_files)
    for f in range(n_files):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("expr")
    rng = np.random.default_rng(11)
    n = 2000
    base = np.datetime64("2024-01-01")
    days = (np.arange(40_000) * 2556 // 40_000).astype("timedelta64[D]")
    paths = {
        "env": _write(root, "env", pa.table({
            "k": pa.array(np.arange(n, dtype=np.int64)),
            "price": pa.array(rng.random(n) * 100),
            "disc": pa.array(rng.random(n) * 0.1),
            "qty": pa.array(rng.integers(0, 50, n), type=pa.int64()),
            "tag": pa.array([("a", "b", "c")[i % 3] for i in range(n)]),
        }), n_files=2),
        "sn": _write(root, "sn", pa.table({"t": pa.array(["abc", None, "abd"])})),
        "cn": _write(root, "cn", pa.table({
            "x": pa.array([1, None, 3], type=pa.int64())})),
        "ninv": _write(root, "ninv", pa.table({
            "x": pa.array([1, 2, None], type=pa.int64())})),
        "cast": _write(root, "cast", pa.table({
            "s": pa.array(["12", "abc", None, "7"]),
            "f": pa.array([1.9, -2.9, 3.5, 1e300])})),
        "cast_dec": _write(root, "cast_dec", pa.table({
            "s": pa.array(["3.5", "-2.9", "1e2", "abc", None, " 7 ", "inf"])})),
        "cast_big": _write(root, "cast_big", pa.table({
            "s": pa.array(["9223372036854775807", "1234567890123456789",
                           "bad", "9223372036854775808",
                           "-9223372036854775808", "3.5"])})),
        "cast_sep": _write(root, "cast_sep", pa.table({
            "s": pa.array(["1_000", "25"])})),
        "tmp_arith": _write(root, "tmp_arith", pa.table({
            "d1": pa.array(base + np.arange(200, dtype="timedelta64[D]")),
            "d2": pa.array(np.repeat(base, 200)),
            "k": pa.array(np.arange(200, dtype=np.int64))})),
        "const": _write(root, "const", pa.table({
            "k": pa.array(np.arange(100, dtype=np.int64))})),
        "boolcol": _write(root, "boolcol", pa.table({
            "k": pa.array(np.arange(100, dtype=np.int64)),
            "b": pa.array([i % 2 == 0 for i in range(100)])})),
        "strings": _write(root, "strings", pa.table({
            "k": pa.array([0, 1, 2, 3], type=pa.int64()),
            "s": pa.array(["Hello", "  pad  ", None, "13-555-0101"]),
            "t": pa.array(["X", "Y", "Z", None])})),
        "dates": _write(root, "dates", pa.table({
            "k": pa.array(np.arange(40_000, dtype=np.int64)),
            "d": pa.array(np.datetime64(BASE) + days),
            "v": pa.array(np.random.default_rng(21).random(40_000)),
        }), n_files=8),
        "ts": _write(root, "ts", pa.table({
            "k": pa.array(np.arange(4000, dtype=np.int64)),
            "ts": pa.array(np.datetime64("1993-06-01T00:00:00", "us")
                           + np.arange(4000).astype("timedelta64[h]") * 3)})),
        "date_nulls": _write(root, "date_nulls", pa.table({
            "d": pa.array([datetime.date(2000, 5, 5), None])})),
        "tz": _write(root, "tz", pa.table({
            "t": pa.array([datetime.datetime(1994, 1, 1, 1, 0),
                           datetime.datetime(1994, 6, 1, 0, 0)],
                          type=pa.timestamp("us", tz="America/New_York"))})),
    }
    return str(root), paths


def _assert_same(got, want, ordered):
    """Names and types equal; rows in order or as sets; floats within
    RTOL relative, everything else equal."""
    assert got.column_names == want.column_names
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    assert got.num_rows == want.num_rows
    if not ordered and want.num_rows:
        keys = [(c, "ascending") for c in want.column_names]
        got = got.take(pc.sort_indices(got, sort_keys=keys))
        want = want.take(pc.sort_indices(want, sort_keys=keys))
    for name in want.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        if pa.types.is_floating(w.type):
            assert g.is_valid().equals(w.is_valid()), name
            gv = np.asarray(g.fill_null(0.0).to_numpy(zero_copy_only=False))
            wv = np.asarray(w.fill_null(0.0).to_numpy(zero_copy_only=False))
            np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=0, err_msg=name)
        else:
            assert g.to_pylist() == w.to_pylist(), name


def _outcome(build, pkg, s, paths):
    """("ok", table, stats, plan) or ("err", type name, message)."""
    try:
        ds = build(pkg, s, paths)
        return ("ok", ds.collect(), s.last_execution_stats, ds.optimized_plan())
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("err", type(e).__name__, str(e))


def _both(tmp_path, data, build, threshold=None, setup=None):
    root, paths = data
    out = []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"), threshold)
        if setup is not None:
            setup(pkg, s, paths)
        out.append(_outcome(build, pkg, s, paths))
    return out


def _plan_text(plan, root):
    text = plan.tree_string().replace(root, "<root>")
    return re.sub(r" \[files: \d+/\d+\]", "", text)


def _filter_routes(stats):
    return sorted(f["strategy"] for f in stats.get("filters", []))


def _expr(P):
    """The package's ``plan.expr`` module."""
    return importlib.import_module(P.__name__ + ".plan.expr")


# -- queries: name -> (build, ordered) ----------------------------------------
def _q(name, fn, ordered=False):
    return (lambda P, s, paths: fn(P, s.read.parquet(paths[name])), ordered)


QUERIES = {
    # tests/test_expressions.py
    "like_exact": _q("env", lambda P, d: d.filter(P.col("tag").like("a"))),
    "like_percent": _q("env", lambda P, d: d.filter(P.col("tag").like("%a%"))),
    "like_underscore": _q("env", lambda P, d: d.filter(P.col("tag").like("_"))),
    "startswith": _q("env", lambda P, d: d.filter(P.col("tag").startswith("b"))),
    "endswith": _q("env", lambda P, d: d.filter(P.col("tag").endswith("c"))),
    "contains": _q("env", lambda P, d: d.filter(P.col("tag").contains("b"))),
    "like_null_drops": _q("sn", lambda P, d: d.filter(P.col("t").like("ab%"))),
    "not_like_null_drops": _q("sn", lambda P, d: d.filter(~P.col("t").like("ab_"))),
    "not_like_exact": _q("sn", lambda P, d: d.filter(~P.col("t").like("abc"))),
    "case_when": _q("env", lambda P, d: d.select(
        "k", bucket=P.when(P.col("qty") >= 40, "high")
        .when(P.col("qty") >= 20, "mid").otherwise("low")).sort("k"), True),
    "case_no_else": _q("env", lambda P, d: d.select(
        "k", flag=P.when(P.col("qty") >= 40, 1).end())),
    "case_null_condition": _q("cn", lambda P, d: d.select(
        y=P.when(P.col("x") > 2, "big").otherwise("small")), True),
    "case_in_aggregate_q12": _q("env", lambda P, d: d.group_by("tag").agg(
        high=(P.when(P.col("qty") >= 25, 1).otherwise(0), "sum"),
        low=(P.when(P.col("qty") < 25, 1).otherwise(0), "sum")).sort("tag"),
        True),
    "case_in_filter": _q("env", lambda P, d: d.filter(
        P.when(P.col("qty") > 25, 1).otherwise(0) == 1)),
    "isin_null_probe": _q("cn", lambda P, d: d.filter(P.col("x").isin([1, 2]))),
    "not_isin_null_probe": _q("cn", lambda P, d: d.filter(~P.col("x").isin([1, 2]))),
    "isin_null_in_list": _q("ninv", lambda P, d: d.filter(P.col("x").isin([1, None]))),
    "not_isin_null_in_list": _q("ninv", lambda P, d: d.filter(
        ~P.col("x").isin([1, None]))),
    "isin_only_null": _q("ninv", lambda P, d: d.filter(P.col("x").isin([None]))),
    "not_isin_only_null": _q("ninv", lambda P, d: d.filter(~P.col("x").isin([None]))),
    "cast_string_to_int64": _q("cast", lambda P, d: d.select(
        i=P.col("s").cast("int64")), True),
    "cast_float_to_int32": _q("cast", lambda P, d: d.select(
        i=P.col("f").cast("int32")), True),
    "cast_in_filter": _q("cast", lambda P, d: d.filter(
        P.col("s").cast("int64") > 10)),
    "cast_spark_long": _q("env", lambda P, d: d.select(
        x=P.col("k").cast("long")).limit(1), True),
    "cast_case_insensitive": _q("env", lambda P, d: d.select(
        a=P.col("k").cast("STRING"), b=P.col("k").cast("Long")).limit(1), True),
    "cast_timezone_case": _q("env", lambda P, d: d.select(
        t=P.col("k").cast("TIMESTAMP[us, tz=America/New_York]")).limit(1), True),
    "cast_decimal_string": _q("cast_dec", lambda P, d: d.select(
        i=P.col("s").cast("int")), True),
    "cast_int64_strings_exact": _q("cast_big", lambda P, d: d.select(
        i=P.col("s").cast("bigint")), True),
    "cast_python_only_syntax": _q("cast_sep", lambda P, d: d.select(
        i=P.col("s").cast("int"), j=P.lit("1_000").cast("int")), True),
    "cast_float_column_to_string": _q("env", lambda P, d: d.select(
        "k", p=P.col("price").cast("string"), q=P.col("qty").cast("float32"))),
    # tests/test_string_functions.py
    "string_basic": _q("strings", lambda P, d: d.select(
        "k", u=P.upper("s"), lo=P.lower("s"), n=P.length("s"),
        tr=P.trim("s")), True),
    "substring": _q("strings", lambda P, d: d.select(
        a=P.substring("s", 1, 2), b=P.substring("s", 4),
        c=P.substring("s", 1, 0)), True),
    "concat_nulls_whole_result": _q("strings", lambda P, d: d.select(
        j=P.concat("s", P.lit("-"), "t")), True),
    "q22_phone_prefix": _q("strings", lambda P, d: d.filter(
        P.substring("s", 1, 2).isin(["13", "He"]))),
    "concat_casts_non_strings": _q("strings", lambda P, d: d.select(
        "k", x=P.concat("t", P.lit("_"), "k")).sort("k"), True),
    "nested_string_functions": _q("strings", lambda P, d: d.filter(
        P.col("s").is_not_null()).select(
        "k", n=P.length(P.trim("s")), pre=P.upper(P.substring("s", 1, 3)))),
    "substring_group_by": _q("strings", lambda P, d: d.filter(
        P.col("s").is_not_null()).select(first_ch=P.substring("s", 1, 1))
        .group_by("first_ch").count("n").sort("first_ch"), True),
    # tests/test_datetime.py
    "extract_fields": _q("dates", lambda P, d: d.select(
        "k", y=P.year("d"), m=P.month("d"), dom=P.dayofmonth("d"),
        q=P.quarter("d")).sort("k"), True),
    "extract_null_select": _q("date_nulls", lambda P, d: d.select(
        y=P.year("d")), True),
    "extract_null_filter": _q("date_nulls", lambda P, d: d.filter(
        P.year("d") == 2000)),
    "month_not_rewritten": _q("dates", lambda P, d: d.filter(P.month("d") == 7)),
    "date_string_literal": _q("dates", lambda P, d: d.filter(
        P.col("d") >= "1997-01-01").select("k")),
    "date_literal": _q("dates", lambda P, d: d.filter(
        P.col("d") >= datetime.date(1997, 1, 1)).select("k")),
    "cast_date_aliases": _q("dates", lambda P, d: d.limit(1).select(
        a=P.col("d").cast("DATE"), b=P.col("d").cast("timestamp"),
        c=P.col("d").cast("timestamp[ns]"), s=P.col("k").cast("string")), True),
    "tz_aware_not_canonicalized": _q("tz", lambda P, d: d.filter(
        P.year("t") == 1994)),
    "year_of_a_computed_column": _q("dates", lambda P, d: d.select(
        "k", e=P.col("d")).filter(P.year("e") == 1995).select("k")),
}

YEAR_PREDICATES = {
    "eq": lambda P: P.year("d") == 1994,
    "ge": lambda P: P.year("d") >= 1995,
    "gt": lambda P: P.year("d") > 1995,
    "le": lambda P: P.year("d") <= 1993,
    "lt": lambda P: P.year("d") < 1993,
    "literal_first": lambda P: 1994 == P.year("d"),
    "isin": lambda P: P.year("d").isin([1993, 1995]),
    "and_other": lambda P: (P.year("d") == 1996) & (P.col("v") > 0.5),
    "not": lambda P: ~(P.year("d") == 1996),
    "or": lambda P: (P.year("d") == 1993) | (P.year("d") == 1997),
    "out_ge_9999": lambda P: P.year("d") >= 9999,
    "out_eq_0": lambda P: P.year("d") == 0,
    "out_eq_negative": lambda P: P.year("d") == -5,
    "out_eq_10000": lambda P: P.year("d") == 10_000,
    "out_isin_mixed": lambda P: P.year("d").isin([1994, 10_000]),
    "in_range_le_9998": lambda P: P.year("d") <= 9998,
    "bool_literal_not_rewritten": lambda P: P.year("d") == True,  # noqa: E712
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_expression_query_equals_jax(tmp_path, data, name):
    build, ordered = QUERIES[name]
    (jk, *jrest), (tk, *trest) = _both(tmp_path, data, build)
    assert (tk, jk) == ("ok", "ok"), (trest, jrest)
    _assert_same(trest[0], jrest[0], ordered)
    assert _plan_text(trest[2], data[0]) == _plan_text(jrest[2], data[0])
    assert _filter_routes(trest[1]) == _filter_routes(jrest[1])


@pytest.mark.parametrize("name", sorted(YEAR_PREDICATES))
def test_year_canonicalization_equals_jax(tmp_path, data, name):
    """The optimized plans print alike (no ``year(`` left where the
    rewrite fires), and the rows are equal."""
    pred = YEAR_PREDICATES[name]
    out = _both(tmp_path, data, lambda P, s, paths: s.read.parquet(
        paths["dates"]).filter(pred(P)).select("k", "d"))
    (jk, jt, _js, jplan), (tk, tt, _ts, tplan) = out
    _assert_same(tt, jt, ordered=False)
    text = _plan_text(tplan, data[0])
    assert text == _plan_text(jplan, data[0])
    rewritten = name not in ("out_ge_9999", "out_eq_0", "out_eq_negative",
                             "out_eq_10000", "out_isin_mixed",
                             "bool_literal_not_rewritten")
    assert ("year(" not in text) == rewritten, text


def test_year_on_timestamp_canonicalizes_and_keeps_the_host_route(tmp_path,
                                                                  data):
    """On a timestamp[us] column the range literals are dates, which the
    device domain has no value for: both packages canonicalize and then
    evaluate the range on the host; on a date32 column the same filter
    takes the device in both."""
    for name, column in (("ts", "ts"), ("dates", "d")):
        out = _both(tmp_path / name, data, lambda P, s, paths: s.read.parquet(
            paths[name]).filter(P.year(column) == 1994).select("k"),
            threshold=0)
        (jk, jt, js, jplan), (tk, tt, ts, tplan) = out
        _assert_same(tt, jt, ordered=False)
        assert tt.num_rows > 0
        assert "year(" not in tplan.tree_string()
        want = ["host"] if name == "ts" else ["device"]
        assert _filter_routes(ts) == _filter_routes(js) == want


ERRORS = {
    "cast_unknown_type": lambda P: P.col("k").cast("varchar(10)"),
    "cast_empty_type": lambda P: P.col("k").cast(""),
    "cast_not_a_name": lambda P: P.col("k").cast(7),
    "substring_start_zero": lambda P: P.substring("s", 0, 3),
    "substring_negative_length": lambda P: P.substring("s", 1, -2),
    "substring_column_start": lambda P: _expr(P).StringFn(
        "substring", [P.col("s"), P.col("k")]),
    "substring_bool_start": lambda P: _expr(P).StringFn(
        "substring", [P.col("s"), P.lit(True)]),
    "substring_four_arguments": lambda P: _expr(P).StringFn(
        "substring", [P.col("s"), P.lit(1), P.lit(2), P.lit(3)]),
    "concat_one_argument": lambda P: P.concat("s"),
    "upper_two_arguments": lambda P: _expr(P).StringFn(
        "upper", [P.col("s"), P.col("t")]),
    "unknown_string_function": lambda P: _expr(P).StringFn(
        "reverse", [P.col("s")]),
    "like_non_string_pattern": lambda P: P.col("s").like(5),
    "unknown_string_match": lambda P: _expr(P).StringMatch(
        "ilike", P.col("s"), "a"),
    "extract_unknown_field": lambda P: _expr(P).Extract("week", P.col("d")),
    "case_no_branch": lambda P: _expr(P).Case([], P.lit(0)),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_construction_errors_equal_jax(name):
    got = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as info:
            ERRORS[name](pkg)
        got.append(str(info.value))
    assert got[0] == got[1]


ROUTING = {
    # tests/test_expressions.py's routing-parity cases: the outcome must
    # not depend on the device threshold, in either package.
    "temporal_arithmetic": ("tmp_arith", lambda P: (P.col("d1") - P.col("d2")) > 30),
    "constant_conjunct": ("const", lambda P: (P.col("k") > 0)
                          & (P.lit("a") == P.lit("b"))),
    "temporal_vs_number": ("tmp_arith", lambda P: P.col("d1") > 30),
    "temporal_vs_int_column": ("tmp_arith", lambda P: P.col("d1") > P.col("k")),
    "temporal_vs_date": ("tmp_arith", lambda P: P.col("d1")
                         >= datetime.date(2024, 2, 1)),
    "temporal_isin_numbers": ("tmp_arith", lambda P: P.col("d1").isin([30, 40])),
    "temporal_vs_numpy_int": ("tmp_arith", lambda P: P.col("d1") > np.int64(30)),
    "numeric_isin": ("tmp_arith", lambda P: P.col("k").isin([3, 5])),
    "bool_literal_in_arithmetic": ("boolcol", lambda P: (P.col("k")
                                                         + P.lit(True)) > 50),
    "int_vs_bool_literal": ("boolcol", lambda P: P.col("k") == P.lit(True)),
    "bool_vs_number": ("boolcol", lambda P: P.col("b") > 0),
    "bool_vs_bool": ("boolcol", lambda P: P.col("b") == P.lit(True)),
    "bool_vs_int_column": ("boolcol", lambda P: P.col("b") > P.col("k")),
    "case_in_filter": ("env", lambda P: P.when(P.col("qty") > 25, 1)
                       .otherwise(0) == 1),
    "like_in_filter": ("env", lambda P: P.col("tag").like("a%")),
    "date_range": ("dates", lambda P: P.col("d") >= datetime.date(1996, 1, 1)),
}


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_routing_parity_equals_jax(tmp_path, data, name):
    source, pred = ROUTING[name]
    results = {}
    for threshold in (HIGH, 1):
        out = _both(tmp_path / str(threshold), data,
                    lambda P, s, paths: s.read.parquet(paths[source])
                    .filter(pred(P)).select(*(["k"] if source != "sn"
                                              else ["t"])),
                    threshold=threshold)
        summary = []
        for res in out:
            if res[0] == "ok":
                summary.append(("ok", res[1].num_rows,
                                _filter_routes(res[2])))
            else:
                summary.append(("err", res[1]))
        assert summary[0] == summary[1], summary
        results[threshold] = summary[1]
    host, dev = results[HIGH], results[1]
    assert host[:2] == dev[:2], f"{name}: {host} vs {dev}"


NEW_NODES = {
    "cast": ("env", lambda P: P.col("qty").cast("int32") > 5),
    "extract": ("dates", lambda P: P.month("d") == 3),
    "string_fn": ("env", lambda P: P.length("tag") == 1),
    "string_match": ("env", lambda P: P.col("tag").startswith("a")),
    "case": ("env", lambda P: P.when(P.col("qty") > 3, 1).otherwise(0) == 1),
    "numeric_case_under_and": ("env", lambda P: (P.col("k") > 5) & (
        P.when(P.col("qty") > 3, P.col("k")).otherwise(0) > 2)),
}


@pytest.mark.parametrize("name", sorted(NEW_NODES))
def test_each_new_node_takes_the_host_route(tmp_path, data, name):
    """Thresholds at 0: every referenced column is numeric and null-free
    where it can be, yet the predicate takes the host route in both
    packages, and the port's device gate refuses it."""
    from hyperspace_tpu_torch.execution.executor import _device_compatible

    source, pred = NEW_NODES[name]
    out = _both(tmp_path, data, lambda P, s, paths: s.read.parquet(
        paths[source]).filter(pred(P)).select("k"), threshold=0)
    (jk, jt, js, _jp), (tk, tt, ts, _tp) = out
    _assert_same(tt, jt, ordered=False)
    assert tt.num_rows > 0
    assert _filter_routes(ts) == _filter_routes(js) == ["host"]
    table = pq.read_table(data[1][source])
    assert not _device_compatible(pred(hyperspace_tpu_torch), table)


def _setup_index(make_config):
    def setup(P, s, paths):
        P.Hyperspace(s).create_index(s.read.parquet(paths["dates"]),
                                     make_config(P))
        s.enable_hyperspace()
    return setup


def test_data_skipping_prunes_on_year_predicate_like_jax(tmp_path, data):
    out = _both(tmp_path, data,
                lambda P, s, paths: s.read.parquet(paths["dates"])
                .filter(P.year("d") == 1993).select("k", "d"),
                setup=_setup_index(lambda P: P.DataSkippingIndexConfig(
                    "d_ds", ["d"])))
    (jk, jt, js, jplan), (tk, tt, ts, tplan) = out
    _assert_same(tt, jt, ordered=False)
    kept = []
    for plan in (jplan, tplan):
        pruned = [sc for sc in plan.leaf_relations()
                  if sc.relation.data_skipping_of]
        assert pruned, plan.tree_string()
        kept.append(len(pruned[0].relation.file_paths))
    assert kept[0] == kept[1] < 8
    assert _plan_text(tplan, data[0]) == _plan_text(jplan, data[0])


def test_covering_index_on_date_key_like_jax(tmp_path, data):
    probe = datetime.date(1994, 6, 1)
    out = _both(tmp_path, data,
                lambda P, s, paths: s.read.parquet(paths["dates"])
                .filter(P.col("d") == probe).select("k"),
                setup=_setup_index(lambda P: P.IndexConfig(
                    "d_idx", ["d"], ["k", "v"])))
    (jk, jt, js, jplan), (tk, tt, ts, tplan) = out
    _assert_same(tt, jt, ordered=False)
    assert tt.num_rows > 0
    for plan in (jplan, tplan):
        assert [sc for sc in plan.leaf_relations()
                if sc.relation.index_scan_of], plan.tree_string()


def test_zorder_on_a_date_dimension_like_jax(tmp_path, data):
    def setup(P, s, paths):
        s.conf.num_buckets = 1
        s.conf.index_max_rows_per_file = 5000
        P.Hyperspace(s).create_index(
            s.read.parquet(paths["dates"]),
            P.IndexConfig("dz", ["d", "v"], ["k"], layout="zorder"))
        s.conf.num_buckets = 4
        s.conf.index_max_rows_per_file = 0
        s.enable_hyperspace()

    lo, hi = datetime.date(1995, 1, 1), datetime.date(1995, 3, 1)
    out = _both(tmp_path, data,
                lambda P, s, paths: s.read.parquet(paths["dates"])
                .filter((P.year("d") == 1995) & (P.col("d") >= lo)
                        & (P.col("d") < hi)).select("k", "d"),
                setup=setup)
    (jk, jt, js, _jp), (tk, tt, ts, _tp) = out
    _assert_same(tt, jt, ordered=False)
    assert tt.num_rows > 0
    jscan, tscan = js["scans"][-1], ts["scans"][-1]
    assert tscan["is_index"] and jscan["is_index"]
    assert tscan["files_read"] == jscan["files_read"] < 8


def test_bucket_in_under_case_reaches_the_bucket_hash(data):
    """Every new arm evaluates its operands through the executor's
    ``bucket_ids``, so a containment ``BucketIn`` under a CASE, a CAST or
    a string function is the bare ``BucketIn``'s rows."""
    from hyperspace_tpu_torch.execution.executor import _arrow_eval, _eval_arrow
    from hyperspace_tpu_torch.io.columnar import to_hash_words
    from hyperspace_tpu_torch.ops.hash import bucket_ids_np

    P = hyperspace_tpu_torch
    E = _expr(P)
    table = pq.read_table(data[1]["env"])

    def bucket_ids(t, columns, num_buckets):
        return bucket_ids_np([to_hash_words(t.column(c)) for c in columns],
                             num_buckets)

    member = E.BucketIn(["k"], 4, [1, 3])
    want = _eval_arrow(member, table, bucket_ids)
    assert 0 < want.sum() < table.num_rows
    for expr in (P.when(member, 1).otherwise(0) == 1,
                 P.when(~member, "out").otherwise("in") == "in",
                 E.Cast(member, "int8") == 1,
                 P.concat(E.Cast(member, "string"), P.lit("!")) == "true!"):
        assert np.array_equal(_eval_arrow(expr, table, bucket_ids), want), expr
    with pytest.raises(ValueError, match="bucket hash"):
        _arrow_eval(P.when(member, 1).otherwise(0), table)
