"""SQL through hyperspace_tpu_torch (on the CPU) against the JAX package.

Every SQL text of tests/test_sql.py and tests/test_sql_setops.py, and the
SQL cases of tests/test_string_functions.py, tests/test_window_frames.py
and tests/test_window.py, goes through ``sql()`` of both packages over
those tests' own fixtures' data; where the JAX fixture built indexes, the
port builds the same indexes over the same files (``twin_session``).
The optimized plans must print alike with the paths substituted, the
rows must be equal (in order where the text orders or cuts them, else as
sets; floats within 1e-9 relative), and every error the JAX package
raises must be raised by the port with the same type and message (the
port's own ``SqlError`` where the JAX package raises its ``SqlError``).

Then chip_smoke.py's phase M at a small size: phase L's queries as SQL
text (``m_texts``) optimize to the DSL twins' plans in both packages,
but for ``M_PLAN_EXCEPTIONS``, and answer numpy's rows."""

from __future__ import annotations

import importlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke
import hyperspace_tpu
import hyperspace_tpu_torch
from tests.test_plan_stability import _simplify
from tests.test_sql import _corpus
from tests.test_sql import env as sql_env  # noqa: F401 (fixture)
from tests.test_sql_setops import env as setops_env  # noqa: F401 (fixture)
from tests.test_string_functions import env as strings_env  # noqa: F401
from tests.test_window import env as window_env  # noqa: F401 (fixture)
from tests.test_window_frames import _base, _write

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
RTOL = 1e-9


def twin_session(js, system_path: str):
    """A port session beside the JAX session ``js``: its bucket count and
    hyperspace switch, and each of its indexes built again over the same
    source files."""
    P = hyperspace_tpu_torch
    ts = P.HyperspaceSession(system_path=system_path, device="cpu")
    hs = P.Hyperspace(ts)
    for e in js.index_collection_manager.get_indexes():
        source = ts.read.parquet(*e.relations[0].root_paths)
        if e.is_covering:
            ts.conf.num_buckets = e.num_buckets
            config = P.IndexConfig(e.name, e.indexed_columns,
                                   e.included_columns)
        else:
            config = P.DataSkippingIndexConfig(
                e.name, e.derived_dataset.sketched_columns,
                e.derived_dataset.sketch_types)
        hs.create_index(source, config)
    ts.conf.num_buckets = js.conf.num_buckets
    if js.is_hyperspace_enabled():
        ts.enable_hyperspace()
    return ts


def sql_of(pkg):
    return importlib.import_module(pkg.__name__ + ".sql")


def run_sql(pkg, session, text: str, tables: dict, paths: dict):
    """("ok", simplified optimized plan, table) or ("err", exception)."""
    try:
        ds = sql_of(pkg).sql(session, text, tables=tables)
        plan = _simplify(ds.optimized_plan().tree_string(), paths)
        return ("ok", plan, ds.collect())
    except Exception as e:  # noqa: BLE001 - the outcome under comparison
        return ("err", e)


def assert_same_rows(got: pa.Table, want: pa.Table, ordered: bool) -> None:
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


def assert_same_outcome(got, want, rows: str) -> None:
    """The port's outcome ``got`` equals the JAX package's ``want``; the
    rows compared as ``rows`` says: "ordered", "set", or "cut" (a LIMIT
    without ORDER BY picks rows in no defined order: only the schema and
    the row count are compared, as the JAX package's own tests do)."""
    if want[0] == "err":
        assert got[0] == "err", f"the port answered; JAX raised {want[1]!r}"
        assert type(got[1]).__name__ == type(want[1]).__name__
        assert str(got[1]) == str(want[1])
        if isinstance(want[1], hyperspace_tpu.sql.SqlError):
            assert isinstance(got[1], hyperspace_tpu_torch.sql.SqlError)
        return
    assert got[0] == "ok", f"the port raised {got[1]!r}"
    assert got[1] == want[1], f"plans differ\n{got[1]}\n--- JAX ---\n{want[1]}"
    if rows == "cut":
        assert got[2].schema.equals(want[2].schema)
        assert got[2].num_rows == want[2].num_rows
    else:
        assert_same_rows(got[2], want[2], rows == "ordered")


def _top_level(text: str, words: str) -> bool:
    """``words`` occur in ``text`` outside every parenthesis."""
    upper = text.upper()
    depth = 0
    for i, ch in enumerate(upper):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth == 0 and upper.startswith(words, i):
            return True
    return False


def _rows_kind(text: str) -> str:
    if _top_level(text, "ORDER BY"):
        return "ordered"
    return "cut" if _top_level(text, "LIMIT") else "set"


# ----------------------------------------------------------------- envs
# Each env gives, per package, (session, tables for sql(), paths for the
# plans' substitution).

@pytest.fixture(scope="module")
def tpch(sql_env, tmp_path_factory):
    """tests/test_sql.py's orders, lineitem and customer, with its two
    indexes in each package."""
    js, paths = sql_env
    ts = twin_session(js, str(tmp_path_factory.mktemp("tsql") / "ix"))
    return {pkg: (s, dict(paths), dict(paths))
            for pkg, s in zip(PKGS, (js, ts))}


def _plain_env(tmp_path, paths: dict):
    out = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
        s = pkg.HyperspaceSession(
            system_path=str(tmp_path / f"ix_{pkg.__name__}"), **kw)
        out[pkg] = (s, dict(paths), dict(paths))
    return out


def _table_dir(tmp_path, name: str, table: pa.Table) -> str:
    d = str(tmp_path / name)
    os.makedirs(d)
    pq.write_table(table, os.path.join(d, "p.parquet"))
    return d


def _env_ab(request, tmp_path):
    """TestReviewFixes' two joined tables a and b."""
    return _plain_env(tmp_path, {name: _table_dir(tmp_path, name, pa.table({
        "k": pa.array([1, 2, 3], type=pa.int64()),
        "x": pa.array([10, 20, 30], type=pa.int64())})) for name in "ab"})


def _env_nulls(request, tmp_path):
    """TestNullFunctions' table of nulls."""
    return _plain_env(tmp_path, {"t": _table_dir(tmp_path, "t", pa.table({
        "a": pa.array([1, None, None], type=pa.int64()),
        "b": pa.array([None, 2, None], type=pa.int64())}))})


def _env_reader(request, tmp_path):
    """The texts that name the session's reader as a table."""
    out = _plain_env(tmp_path, {})
    return {pkg: (s, {"t": s.read}, paths)
            for pkg, (s, _t, paths) in out.items()}


def _env_setops(request, tmp_path):
    _js, tables = request.getfixturevalue("setops_env")
    return _plain_env(tmp_path, tables)


def _env_strings(request, tmp_path):
    _js, d = request.getfixturevalue("strings_env")
    return _plain_env(tmp_path, {"t": d})


def _env_frames(request, tmp_path):
    return _plain_env(tmp_path, {"t": _base(tmp_path)})


def _env_wsel(request, tmp_path):
    return _plain_env(tmp_path, {"wsel": _write(tmp_path, pa.table({
        "g": pa.array([1, 1, 2, 2], type=pa.int64()),
        "a": pa.array([1, 2, 100, 200], type=pa.int64()),
        "b": pa.array([50, 60, 1, 2], type=pa.int64()),
    }), name="wsel")})


def _env_sales(request, tmp_path):
    js, data, _df = request.getfixturevalue("window_env")
    out = _plain_env(tmp_path, {"sales": data})
    out[hyperspace_tpu] = (js,) + out[hyperspace_tpu][1:]
    out[hyperspace_tpu_torch][0].conf.num_buckets = js.conf.num_buckets
    return out


ENVS = {"ab": _env_ab, "nulls": _env_nulls, "reader": _env_reader,
        "setops": _env_setops, "strings": _env_strings,
        "frames": _env_frames, "wsel": _env_wsel, "sales": _env_sales}


# ---------------------------------------------------------------- texts
# tests/test_sql.py, over its env fixture (orders, lineitem, customer).
TPCH_TEXTS = {
    "index_rewrites_fire":
        "SELECT o_orderkey, o_totalprice, l_quantity FROM orders "
        "JOIN lineitem ON o_orderkey = l_orderkey",
    "answers_match_pandas":
        "SELECT l_returnflag, sum(l_quantity) AS q FROM lineitem "
        "GROUP BY l_returnflag ORDER BY l_returnflag",
    "simple_case":
        "SELECT l_orderkey, "
        "CASE l_returnflag WHEN 'R' THEN 'returned' "
        "WHEN 'A' THEN 'accepted' ELSE 'other' END AS status "
        "FROM lineitem",
    "simple_case_no_else":
        "SELECT sum(CASE l_shipmode WHEN 'AIR' THEN l_quantity "
        "END) AS air_qty FROM lineitem",
    "simple_case_no_else_null":
        "SELECT count(*) AS n FROM lineitem "
        "WHERE CASE l_shipmode WHEN 'AIR' THEN 1 END IS NULL",
    "error_unknown_table": "SELECT a FROM nope",
    "error_exists_needs_subquery":
        "SELECT o_orderkey FROM orders WHERE EXISTS (42)",
    "error_trailing": "SELECT o_orderkey FROM orders extra nonsense ; ",
    "error_unknown_alias": "SELECT x.o_orderkey FROM orders o",
    "error_not_group_key":
        "SELECT o_custkey, o_totalprice FROM orders GROUP BY o_custkey",
    "error_position": "SELECT FROM orders",
    "full_outer_join":
        "SELECT c_custkey, o_orderkey FROM customer "
        "FULL OUTER JOIN orders ON c_custkey = o_custkey",
    "negative_in_list":
        "SELECT o_orderkey FROM orders WHERE o_orderkey IN (-1, 3, 5)",
    "nested_window":
        "SELECT row_number() OVER (ORDER BY o_orderkey) + 0 "
        "AS r FROM orders ORDER BY r LIMIT 3",
    "error_window_in_where":
        "SELECT o_orderkey FROM orders "
        "WHERE row_number() OVER (ORDER BY o_orderkey) < 5",
    "select_order_interleaved":
        "SELECT o_totalprice + 1 AS y, o_orderkey FROM orders LIMIT 2",
    "select_order_interleaved_agg":
        "SELECT sum(o_totalprice) + 0 AS s2, o_custkey "
        "FROM orders GROUP BY o_custkey LIMIT 2",
    "group_by_renaming_alias":
        "SELECT o_custkey AS g, count(*) AS c FROM orders "
        "GROUP BY g ORDER BY g LIMIT 3",
    "error_count_distinct_window":
        "SELECT count(DISTINCT o_custkey) OVER "
        "(PARTITION BY o_orderkey) AS c FROM orders",
    "year_through_join":
        "SELECT o_orderkey FROM orders JOIN lineitem "
        "ON o_orderkey = l_orderkey WHERE year(o_orderdate) = 1995",
    "exists": """
            SELECT o_orderkey FROM orders o
            WHERE o_totalprice < 500 AND EXISTS (
                SELECT 1 FROM lineitem l
                WHERE l.l_orderkey = o.o_orderkey AND l.l_quantity > 45)
            ORDER BY o_orderkey
        """,
    "not_exists": """
            SELECT c_custkey FROM customer c
            WHERE NOT EXISTS (
                SELECT 1 FROM orders o WHERE o.o_custkey = c.c_custkey)
        """,
    "select_one_auto_alias": "SELECT 1, o_orderkey FROM orders LIMIT 2",
    "union_all":
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey < 3 "
        "UNION ALL "
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey < 5",
    "union_distinct":
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey < 3 "
        "UNION "
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey < 5 "
        "ORDER BY k",
    "union_tail_binds_whole":
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey IN (7, 3) "
        "UNION ALL "
        "SELECT o_orderkey AS k FROM orders WHERE o_orderkey IN (9, 1) "
        "ORDER BY k DESC LIMIT 3",
    "union_by_name_merges":
        "SELECT c_custkey AS id, c_acctbal AS v "
        "FROM customer WHERE c_custkey < 2 "
        "UNION ALL "
        "SELECT o_orderkey AS id, o_totalprice AS v "
        "FROM orders WHERE o_orderkey < 2",
    "union_by_position":
        "SELECT o_orderkey FROM orders UNION ALL "
        "SELECT c_custkey FROM customer",
    "error_union_arity":
        "SELECT o_orderkey, o_custkey FROM orders UNION ALL "
        "SELECT c_custkey FROM customer",
    "union_branch_with_exists": """
            SELECT o_orderkey AS k FROM orders
            WHERE EXISTS (SELECT 1 FROM lineitem l
                          WHERE l.l_orderkey = orders.o_orderkey
                            AND l.l_quantity > 48)
            UNION
            SELECT o_orderkey AS k FROM orders WHERE o_totalprice > 995
            ORDER BY k
        """,
    "window_over_derived_in_subquery": """
            SELECT * FROM (
                SELECT o_custkey, o_totalprice,
                       row_number() OVER (PARTITION BY o_custkey
                                          ORDER BY o_totalprice DESC)
                           AS rn
                FROM orders
                WHERE o_custkey IN (SELECT c_custkey FROM customer
                                    WHERE c_mktsegment = 'BUILDING')
            ) ranked
            WHERE rn = 1 ORDER BY o_custkey
        """,
    "year_exists_lag": """
            SELECT o_custkey, o_orderkey,
                   lag(o_totalprice) OVER (PARTITION BY o_custkey
                                           ORDER BY o_orderkey) AS prev
            FROM orders
            WHERE year(o_orderdate) >= 1993
              AND EXISTS (SELECT 1 FROM lineitem l
                          WHERE l.l_orderkey = orders.o_orderkey)
            ORDER BY o_custkey, o_orderkey
        """,
    "scalar_with_coalesce": """
            SELECT o_orderkey FROM orders
            WHERE coalesce(o_totalprice, 0.0) >
                  (SELECT avg(o2.o_totalprice) AS a FROM orders o2)
        """,
    "backtick_identifier":
        "SELECT count(*) AS `Row Count ` FROM orders",
    "bare_name_outer_correlation": """
            SELECT count(*) AS n FROM orders
            WHERE o_totalprice > (
                SELECT 1.5 * avg(l_quantity) FROM lineitem
                WHERE l_orderkey = o_orderkey)
        """,
    "bare_name_local_wins": """
            SELECT count(*) AS n FROM orders o1
            WHERE o_totalprice > (
                SELECT avg(o_totalprice) FROM orders)
        """,
    "backtick_keyword_from":
        "SELECT o_orderkey AS `from` FROM orders LIMIT 2",
    "backtick_keyword_order": "SELECT count(*) AS `order` FROM orders",
    "error_unaliased_comma_self_join":
        "SELECT o_orderkey FROM orders, orders WHERE o_totalprice > 1",
    "error_aliased_self_join_cross":
        "SELECT o_orderkey FROM orders o1, orders o2 "
        "WHERE o_totalprice > 1",
    "error_unconnected_cross":
        "SELECT o_orderkey FROM orders, customer WHERE o_totalprice > 1",
    "comma_self_join": """
            SELECT count(*) AS n FROM orders o1, orders o2
            WHERE o1.o_custkey = o2.o_custkey
        """,
    "comma_self_join_filters": """
            SELECT o1.o_orderkey AS a, o2.o_orderkey AS b
            FROM orders o1, orders o2
            WHERE o1.o_custkey = o2.o_custkey
              AND o1.o_totalprice > 900 AND o2.o_totalprice < 100
        """,
    "comma_self_join_lifted_name": """
            SELECT o1.o_orderkey, o2.o_orderkey
            FROM orders o1, orders o2
            WHERE o1.o_custkey = o2.o_custkey LIMIT 1
        """,
    "error_lifted_alias_column":
        "SELECT o2.nope FROM orders o1, orders o2 "
        "WHERE o1.o_custkey = o2.o_custkey",
    "comma_three_way_self_join": """
            SELECT count(*) AS n FROM customer c1, customer c2, customer c3
            WHERE c1.c_mktsegment = c2.c_mktsegment
              AND c2.c_mktsegment = c3.c_mktsegment
        """,
    "explicit_self_join": """
            SELECT count(*) AS n
            FROM orders o1 JOIN orders o2
              ON o1.o_custkey = o2.o_custkey
        """,
    "explicit_self_join_filters": """
            SELECT o1.o_orderkey AS a, o2.o_orderkey AS b
            FROM orders o1 JOIN orders o2
              ON o1.o_custkey = o2.o_custkey
            WHERE o1.o_totalprice > 900 AND o2.o_totalprice < 100
        """,
    "left_self_join": """
            SELECT count(*) AS n
            FROM orders o1 LEFT JOIN orders o2
              ON o1.o_custkey = o2.o_custkey
            WHERE o1.o_totalprice > 990
        """,
    "self_join_group_order_qualified": """
            SELECT o1.o_custkey AS k, count(*) AS n
            FROM orders o1 JOIN orders o2
              ON o1.o_custkey = o2.o_custkey
            GROUP BY o1.o_custkey
            ORDER BY o1.o_custkey
        """,
    "explicit_three_way_self_join": """
            SELECT count(*) AS n
            FROM customer c1
            JOIN customer c2 ON c1.c_mktsegment = c2.c_mktsegment
            JOIN customer c3 ON c2.c_mktsegment = c3.c_mktsegment
        """,
    "error_unaliased_duplicate_join":
        "SELECT count(*) AS n FROM orders JOIN orders "
        "ON o_custkey = o_custkey",
    "error_unaliased_duplicate_comma":
        "SELECT count(*) AS n FROM orders, orders",
    "error_one_aliased_one_not":
        "SELECT count(*) AS n FROM orders o1 JOIN orders "
        "ON o1.o_custkey = o_custkey",
}

# The other envs: (env, text).
OTHER_TEXTS = {
    # tests/test_sql.py's own small tables.
    "error_ambiguous_qualified": (
        "ab", "SELECT a.k FROM a JOIN b ON a.k = b.k WHERE b.x > 20"),
    "left_bound_qualified": (
        "ab", "SELECT a.k FROM a JOIN b ON a.k = b.k WHERE a.x > 20"),
    "error_column_does_not_exist": ("ab", "SELECT a.nope FROM a"),
    "coalesce_and_nullif": (
        "nulls", "SELECT coalesce(a, b, 0) AS c, nullif(a, 1) AS n FROM t"),
    "coalesce_in_predicate": (
        "nulls", "SELECT a FROM t WHERE coalesce(a, b, 0) > 0"),
    "error_single_arg_functions": (
        "reader", "SELECT sum(a, b) AS x FROM t GROUP BY a"),
    "error_coalesce_distinct": (
        "reader", "SELECT coalesce(DISTINCT a, b) AS c FROM t"),
    # tests/test_sql_setops.py.
    "cte_single": ("setops", """
            WITH big AS (SELECT k, v FROM t1 WHERE v >= 30)
            SELECT k FROM big ORDER BY k
        """),
    "cte_chain": ("setops", """
            WITH big AS (SELECT k, v FROM t1 WHERE v >= 30),
                 biggest AS (SELECT k FROM big WHERE v >= 50)
            SELECT count(*) AS n FROM biggest
        """),
    "cte_shadows_table": ("setops", """
            WITH t1 AS (SELECT k2 AS k FROM t2)
            SELECT count(*) AS n FROM t1
        """),
    "cte_used_twice": ("setops", """
            WITH base AS (SELECT k, v FROM t1 WHERE k IS NOT NULL)
            SELECT a.k AS k FROM base a
            JOIN base b ON a.k = b.k
            WHERE a.v >= 50
        """),
    "cte_body_union": ("setops", """
            WITH u AS (SELECT k FROM t1 WHERE k = 1
                       UNION ALL SELECT k2 FROM t2 WHERE k2 = 6)
            SELECT count(*) AS n FROM u
        """),
    "error_with_recursive": (
        "setops", "WITH RECURSIVE r AS (SELECT k FROM t1) "
                  "SELECT * FROM r"),
    "intersect_positional": ("setops", """
            SELECT k FROM t1 INTERSECT SELECT k2 FROM t2
            ORDER BY k
        """),
    "except": ("setops", """
            SELECT k FROM t1 EXCEPT SELECT k2 FROM t2
            ORDER BY k
        """),
    "minus": ("setops", "SELECT k FROM t1 MINUS SELECT k2 FROM t2"),
    "intersect_binds_tighter": ("setops", """
            SELECT k FROM t1 WHERE k = 1
            UNION
            SELECT k FROM t1 WHERE k IS NOT NULL
            INTERSECT
            SELECT k2 FROM t2 WHERE k2 = 3
        """),
    "setop_trailing_order_limit": ("setops", """
            SELECT k FROM t1 WHERE k IS NOT NULL
            EXCEPT SELECT k2 FROM t2
            ORDER BY k DESC LIMIT 1
        """),
    "error_except_all": (
        "setops", "SELECT k FROM t1 EXCEPT ALL SELECT k2 FROM t2"),
    "error_setop_arity": (
        "setops", "SELECT k, v FROM t1 INTERSECT SELECT k2 FROM t2"),
    "intersect_tuples": ("setops", """
            SELECT k, v FROM t1 INTERSECT SELECT k2, v2 FROM t2
            ORDER BY k
        """),
    "intersect_not_null": (
        "setops", "SELECT k FROM t1 WHERE k IS NOT NULL "
                  "INTERSECT SELECT k2 FROM t2 WHERE k2 IS NOT NULL"),
    # tests/test_string_functions.py.
    "string_surface": ("strings", """
        SELECT k, upper(s) AS u, substring(s, 1, 2) AS pre,
               concat(t, '_', t) AS tt, length(trim(s)) AS n
        FROM t WHERE s IS NOT NULL ORDER BY k
    """),
    "string_in_where": (
        "strings", "SELECT k FROM t WHERE substring(s, 1, 2) = '13'"),
    "error_upper_two_args": (
        "strings", "SELECT upper(s, t) AS x FROM t"),
    "error_substring_column_start": (
        "strings", "SELECT substring(s, k) AS x FROM t"),
    "string_group_key": ("strings", """
        SELECT substring(s, 1, 1) AS first_ch, count(*) AS n
        FROM t WHERE s IS NOT NULL
        GROUP BY first_ch ORDER BY first_ch
    """),
    "error_substring_zero_start": (
        "strings", "SELECT substring(s, 0, 2) AS x FROM t"),
    "error_substring_bool_start": (
        "strings", "SELECT substring(s, TRUE) AS x FROM t"),
    "error_substring_negative_start": (
        "strings", "SELECT substring(s, -1, 2) AS x FROM t"),
    "concat_casts": (
        "strings", "SELECT k, concat(t, '_', k) AS x FROM t ORDER BY k"),
    # tests/test_window_frames.py.
    "rows_between": ("frames", """
        SELECT g, o, sum(v) OVER (PARTITION BY g ORDER BY o
            ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs
        FROM t ORDER BY g, o
    """),
    "rows_shorthand_and_bounded": ("frames", """
        SELECT g, o,
               sum(v) OVER (PARTITION BY g ORDER BY o
                            ROWS 1 PRECEDING) AS s1,
               sum(v) OVER (PARTITION BY g ORDER BY o
                            ROWS BETWEEN 1 PRECEDING
                                     AND 1 FOLLOWING) AS s2
        FROM t ORDER BY g, o
    """),
    "first_last_ntile": ("frames", """
        SELECT g, o,
               first_value(v) OVER (PARTITION BY g ORDER BY o) AS fv,
               ntile(2) OVER (PARTITION BY g ORDER BY o) AS nt
        FROM t ORDER BY g, o
    """),
    "range_default_form": ("frames", """
        SELECT g, o, sum(v) OVER (PARTITION BY g ORDER BY o
            RANGE BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW) AS rs
        FROM t ORDER BY g, o
    """),
    "error_range_offset_form": ("frames", """
            SELECT sum(v) OVER (ORDER BY o
                RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) AS rs
            FROM t
        """),
    "order_by_same_func_windows": ("wsel", """
        SELECT g,
               sum(sum(a)) OVER (PARTITION BY g) AS m,
               sum(sum(b)) OVER (PARTITION BY g) AS n
        FROM wsel GROUP BY g
        ORDER BY sum(sum(a)) OVER (PARTITION BY g)
    """),
    # tests/test_window.py.
    "lag_q47_shape": ("sales", """
            SELECT grp, rid, qty,
                   lag(qty, 1) OVER (PARTITION BY grp ORDER BY rid)
                       AS prev_qty
            FROM sales
        """),
}

# tests/test_sql.py's corpus of SQL texts with DSL twins, by name.
CORPUS_NAMES = (
    "q_point_filter", "q_pricing_summary", "q_join_where",
    "q_revenue_q3_shape", "q_case_when", "q_year_extract",
    "q_between_like", "q_semi_join", "q_anti_join_agg", "q_in_subquery",
    "q_scalar_subquery", "q_correlated_scalar", "q_having",
    "q_window_rank")


def _compare(env: dict, name: str, text: str) -> None:
    """Both packages run ``text``; the JAX package answers unless the
    case's name starts with ``error_``, and the port does the same."""
    outcomes = []
    for pkg in PKGS:
        session, tables, paths = env[pkg]
        outcomes.append(run_sql(pkg, session, text, tables, paths))
    want = "err" if name.startswith("error_") else "ok"
    assert outcomes[0][0] == want, outcomes[0][1]
    assert_same_outcome(outcomes[1], outcomes[0], _rows_kind(text))


@pytest.mark.parametrize("name", CORPUS_NAMES)
def test_corpus_text(tpch, name):
    js, _tables, paths = tpch[hyperspace_tpu]
    texts = {n: text for n, text, _dsl in _corpus(js, paths)}
    assert set(texts) == set(CORPUS_NAMES)
    _compare(tpch, name, texts[name])


@pytest.mark.parametrize("name", sorted(TPCH_TEXTS))
def test_text_over_tpch_tables(tpch, name):
    _compare(tpch, name, TPCH_TEXTS[name])


@pytest.mark.parametrize("name", sorted(OTHER_TEXTS))
def test_text_over_own_tables(request, tmp_path, name):
    env_name, text = OTHER_TEXTS[name]
    _compare(ENVS[env_name](request, tmp_path), name, text)


def test_error_cases_raise_the_ports_sql_error(tpch):
    """A rejected text raises ``SqlError`` from the port's own module,
    a ValueError, never the JAX package's class."""
    ts, tables, _paths = tpch[hyperspace_tpu_torch]
    with pytest.raises(hyperspace_tpu_torch.sql.SqlError) as info:
        hyperspace_tpu_torch.sql.sql(ts, TPCH_TEXTS["error_position"], tables)
    assert isinstance(info.value, ValueError)
    assert not isinstance(info.value, hyperspace_tpu.sql.SqlError)
    assert hyperspace_tpu_torch.sql.SqlError is \
        hyperspace_tpu_torch.sql.parser.SqlError


# ------------------------------------------------------ phase M, small
M_SIZES = {"L_ORDERS": 20_000, "L_LINEITEM": 80_000,
           "L_STRING_KEYS": (8_000, 8_200), "L_NULL_KEYS": (0, 400),
           "L_SUPPLIERS": 400, "L_CUSTOMERS": 2_000}


@pytest.fixture(scope="module")
def phase_m_data(tmp_path_factory):
    """chip_smoke.py's phase L tables at a small size and, per package, a
    session with phase L's three indexes."""
    saved = {k: getattr(chip_smoke, k) for k in M_SIZES}
    for k, v in M_SIZES.items():
        setattr(chip_smoke, k, v)
    try:
        root = str(tmp_path_factory.mktemp("phase_m"))
        orders, li, phrases = chip_smoke.l_gen()
        o_cols, li_cols = chip_smoke.l_arrow(orders, li, phrases)
        tables = chip_smoke.m_tables(root)
        chip_smoke.write_files(o_cols, tables["orders"])
        chip_smoke.write_files(li_cols, tables["lineitem"])
        want = chip_smoke.l_expected(orders, li, phrases)
        texts = chip_smoke.m_texts(want["q21_keys"])
        sessions = {}
        for pkg in PKGS:
            kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
            s = pkg.HyperspaceSession(
                system_path=os.path.join(root, f"ix_{pkg.__name__}"), **kw)
            s.conf.num_buckets = chip_smoke.NUM_BUCKETS
            hs = pkg.Hyperspace(s)
            for src, config in (
                    ("lineitem", pkg.IndexConfig(
                        chip_smoke.L_LI_INDEX, ["l_orderkey"],
                        chip_smoke.L_LI_INCLUDED)),
                    ("orders", pkg.IndexConfig(
                        chip_smoke.L_ORD_INDEX, ["o_orderkey"],
                        chip_smoke.L_ORD_INCLUDED)),
                    ("lineitem", pkg.DataSkippingIndexConfig(
                        chip_smoke.L_DS_INDEX, ["l_shipdate"]))):
                hs.create_index(s.read.parquet(tables[src]), config)
            s.enable_hyperspace()
            dsl = chip_smoke.l_queries(s, root, want["q21_keys"], pkg=pkg)
            sessions[pkg] = (s, dsl)
        yield root, tables, want, texts, sessions
    finally:
        for k, v in saved.items():
            setattr(chip_smoke, k, v)


M_NAMES = ("year_1995", "year_isin", "month_3", "q12", "q13_orders",
           "strings_digit_sum", "strings_functions", "strings_matches",
           "q4", "q17_shape", "q22_scalar", "in", "not_in", "not_in_null",
           "q21_shape")


@pytest.mark.parametrize("name", M_NAMES)
def test_phase_m_sql_twins(phase_m_data, name):
    """Phase L's query ``name`` as SQL text: its plan equals its DSL
    twin's in the JAX package exactly when phase M requires it on the
    card, the port's SQL plan is the JAX package's, and its rows are
    numpy's (phase M's own check) and the JAX package's."""
    root, tables, want, texts, sessions = phase_m_data
    assert set(texts) == set(M_NAMES) == set(sessions[hyperspace_tpu][1])
    outcomes = {}
    for pkg in PKGS:
        s, dsl = sessions[pkg]
        ds_dsl, keys = dsl[name]
        ds = sql_of(pkg).sql(s, texts[name], tables)
        plan = ds.optimized_plan().tree_string()
        equal = plan == ds_dsl.optimized_plan().tree_string()
        assert equal == (name not in chip_smoke.M_PLAN_EXCEPTIONS), \
            (pkg.__name__, plan)
        outcomes[pkg] = ("ok", _simplify(plan, tables), ds.collect())
    assert_same_outcome(outcomes[hyperspace_tpu_torch],
                        outcomes[hyperspace_tpu],
                        "ordered" if keys is None else "set")
    chip_smoke.require_rows(f"phase M {name}",
                            outcomes[hyperspace_tpu_torch][2], want[name],
                            keys, rtol=chip_smoke.AGG_RTOL)


def test_phase_m_on_the_cpu(phase_m_data):
    """phase_m itself over a port session holding phase L's indexes: the
    plans, answers and routes (against a stand-in of phase L's record,
    this session's own DSL routes), the explain checks and the
    statistics hold, and no kernel launches."""
    root, tables, want, texts, sessions = phase_m_data
    s, dsl = sessions[hyperspace_tpu_torch]
    chip_smoke.set_min_rows(s, 0)
    pl = {"queries": {}}
    for name, (ds, _keys) in dsl.items():
        ds.collect()
        stats = s.last_execution_stats
        pl["queries"][name] = {
            "median_ms": 0.0, **chip_smoke.routes(stats),
            "aggregates": sorted({d["strategy"]
                                  for d in stats.get("aggregates", [])})}
    ctx = {"session": s, "hs": hyperspace_tpu_torch.Hyperspace(s),
           "want": want, "queries": dsl}
    out = chip_smoke.phase_m(root, torch.device("cpu"), pl, ctx)
    assert set(out["queries"]) == set(M_NAMES)
    assert out["index"]["numBuckets"] == chip_smoke.NUM_BUCKETS
    assert not any(out["launches"].values())
    assert [q for q, r in out["queries"].items() if not r["plan_equal"]] \
        == sorted(chip_smoke.M_PLAN_EXCEPTIONS, key=M_NAMES.index)
