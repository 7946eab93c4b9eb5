"""Subqueries through hyperspace_tpu_torch (on the CPU) against the JAX
package: scalar folding, IN as a semi join, null-aware NOT IN, the
correlated scalar as an aggregate and a join, EXISTS, and the inequality
correlations that become a join's residual.

Every case of tests/test_subqueries.py goes through both packages on the
same seeded tables: the rows must be equal (in order where the query
sorts them, else as sets; floats within 1e-9 relative), the optimized
plans must print alike, and every ``SubqueryError`` or ``ValueError`` the
JAX package raises must be raised by the port with the same message.
``TestInequalityCorrelations``' fuzz is held to a naive evaluation in
each package.  A join's residual survives pushdown, pruning and the
join rule, and keeps the join off the bucket-aligned and fused routes."""

import os
import re

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
HIGH = 10**9
RTOL = 1e-9


def _session(pkg, system_path, threshold=None):
    if pkg is hyperspace_tpu_torch:
        s = pkg.HyperspaceSession(system_path=system_path, device="cpu")
        s.conf.device_build_min_rows = 0
        s.conf.device_resident_min_rows = HIGH
    else:
        s = pkg.HyperspaceSession(system_path=system_path)
        s.conf.mesh_enabled = "off"
        s.conf.device_cache_policy = "off"
    s.conf.num_buckets = 4
    if threshold is not None:
        for kind in ("filter", "join", "agg"):
            setattr(s.conf, f"device_{kind}_min_rows", threshold)
    return s


def _write(root, name, table, n_files=1):
    path = os.path.join(str(root), name)
    os.makedirs(path)
    step = -(-max(table.num_rows, 1) // n_files)
    for f in range(n_files):
        pq.write_table(table.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))
    return path


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("subq")
    rng = np.random.default_rng(5)
    n = 3000
    r17 = np.random.default_rng(17)
    paths = {
        "sales": _write(root, "sales", pa.table({
            "s_store": pa.array((np.arange(n) % 40).astype(np.int64)),
            "s_cust": pa.array(rng.integers(0, 200, n), type=pa.int64()),
            "s_return": pa.array(np.round(rng.uniform(0, 100, n), 3)),
        })),
        "stores": _write(root, "stores", pa.table({
            "st_key": pa.array(np.arange(40, dtype=np.int64)),
            "st_state": pa.array([("TN", "CA", "NY", "WA")[i % 4]
                                  for i in range(40)]),
        })),
        "mono": _write(root, "mono", pa.table({
            "k": pa.array(np.arange(8000, dtype=np.int64))}), n_files=8),
        "x": _write(root, "x", pa.table({
            "x": pa.array([1, 2, None, 4], type=pa.int64())})),
        "y_plain": _write(root, "y_plain", pa.table({
            "y": pa.array([2, 9], type=pa.int64())})),
        "y_null": _write(root, "y_null", pa.table({
            "y": pa.array([2, None], type=pa.int64())})),
        "y_empty": _write(root, "y_empty", pa.table({
            "y": pa.array([], type=pa.int64())})),
        "outer": _write(root, "outer", pa.table({
            "k": pa.array([1, 2, 3], type=pa.int64()),
            "x": pa.array([0, 0, 5], type=pa.int64())})),
        "inner": _write(root, "inner", pa.table({
            "ik": pa.array([1, 1, 3], type=pa.int64()),
            "v": pa.array([10, 20, 30], type=pa.int64())})),
        "rows": _write(root, "rows", pa.table({
            "g": pa.array(r17.integers(0, 60, 800), type=pa.int64()),
            "s": pa.array(r17.integers(0, 8, 800), type=pa.int64()),
            "v": pa.array(r17.integers(0, 100, 800), type=pa.int64()),
        })),
    }
    rows = pq.read_table(paths["rows"])
    paths["rows2"] = _write(root, "rows2", rows.rename_columns(
        ["g2", "s2", "v2"]))
    return str(root), paths


def _assert_same(got, want, ordered):
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


def _plan_text(plan, root):
    text = plan.tree_string().replace(root, "<root>")
    return re.sub(r" \[files: \d+/\d+\]", "", text)


def _nodes(P):
    import importlib

    return importlib.import_module(P.__name__ + ".plan.nodes")


def _run(pkg, s, build, paths):
    """("ok", table, plan text source, stats) or ("err", type, message)."""
    try:
        ds = build(pkg, s, paths)
        plan = ds.optimized_plan()
        return ("ok", ds.collect(), plan, s.last_execution_stats)
    except Exception as e:  # noqa: BLE001 - the error itself is compared
        return ("err", type(e).__name__, str(e))


def _both(tmp_path, data, build, setup=None, threshold=None):
    root, paths = data
    out = []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"), threshold)
        if setup is not None:
            setup(pkg, s, paths)
        out.append(_run(pkg, s, build, paths))
    return out


def _sales(P, s, paths):
    return s.read.parquet(paths["sales"])


def _corr_mean(P, s, paths):
    return (_sales(P, s, paths)
            .filter(P.col("s_store") == P.outer_ref("s_store"))
            .agg(m=("s_return", "mean")))


def _tn(P, s, paths, state="TN"):
    return (s.read.parquet(paths["stores"])
            .filter(P.col("st_state") == state).select("st_key"))


def _corr_stores(P, s, paths):
    return (s.read.parquet(paths["stores"])
            .filter(P.col("st_key") == P.outer_ref("s_store")))


def _limit_barrier(P, s, paths):
    N = _nodes(P)
    stores = s.read.parquet(paths["stores"]).plan
    return P.Dataset(N.Filter(P.col("st_key") == P.outer_ref("s_store"),
                              N.Limit(5, stores)), s)


def _trapped(P, s, paths):
    N = _nodes(P)
    stores = s.read.parquet(paths["stores"]).plan
    return P.Dataset(N.Filter(P.col("st_state") == "TN", N.Limit(5, N.Filter(
        P.col("st_key") == P.outer_ref("s_store"), stores))), s)


def _not_in(sub):
    return lambda P, s, paths: s.read.parquet(paths["x"]).filter(
        ~P.in_subquery("x", s.read.parquet(paths[sub]).select("y")))


# name -> (build, ordered, plan check)
CASES = {
    "uncorrelated_scalar_folds": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.col("s_return") > P.scalar(_sales(P, s, paths)
                                     .agg(m=("s_return", "mean"))) * 1.2),
        False, lambda t: "scalar_subquery" not in t),
    "scalar_empty_is_null": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.col("s_return") > P.scalar(_sales(P, s, paths).filter(
            P.col("s_return") < -1).agg(m=("s_return", "mean")))), False, None),
    "scalar_multirow_raises": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.col("s_store") == P.scalar(s.read.parquet(paths["stores"])
                                     .select("st_key"))), False, None),
    "scalar_two_columns_raises": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.col("s_store") == P.scalar(s.read.parquet(paths["stores"]))),
        False, None),
    "in_subquery_semi_join": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.in_subquery("s_store", _tn(P, s, paths))), False,
        lambda t: "semi" in t.lower()),
    "not_in_plain": (_not_in("y_plain"), False, lambda t: "anti" in t),
    "not_in_null_in_subquery": (_not_in("y_null"), False, None),
    "not_in_empty_subquery": (_not_in("y_empty"), False, None),
    "correlated_scalar_q1_shape": (lambda P, s, paths: _sales(P, s, paths)
                                   .filter(P.col("s_return")
                                           > P.scalar(_corr_mean(P, s, paths)) * 1.2)
                                   .select("s_store", "s_cust", "s_return"),
                                   False, lambda t: "outer_ref" not in t
                                   and "scalar_subquery" not in t),
    "correlated_scalar_multi_key": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.col("s_return") == P.scalar(_sales(P, s, paths).filter(
            (P.col("s_store") == P.outer_ref("s_store"))
            & (P.col("s_cust") == P.outer_ref("s_cust")))
            .agg(mx=("s_return", "max")))), False, None),
    "correlated_not_aggregate_raises": (lambda P, s, paths: _sales(P, s, paths)
                                        .filter(P.col("s_cust") == P.scalar(
                                            _sales(P, s, paths).filter(
                                                P.col("s_store")
                                                == P.outer_ref("s_store"))
                                            .select("s_cust"))), False, None),
    "correlated_in_raises": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.in_subquery("s_cust", _sales(P, s, paths).filter(
            P.col("s_store") == P.outer_ref("s_store")).select("s_cust"))),
        False, None),
    "scalar_in_aggregate_raises": (lambda P, s, paths: _sales(P, s, paths)
                                   .group_by("s_store").agg(x=(
                                       P.col("s_return") - P.scalar(
                                           _sales(P, s, paths).agg(
                                               m=("s_return", "mean"))), "sum")),
                                   False, None),
    "scalar_in_select_folds": (lambda P, s, paths: _sales(P, s, paths).limit(3)
                               .select("s_store", ratio=P.col("s_return")
                                       / P.scalar(_sales(P, s, paths).agg(
                                           m=("s_return", "mean")))),
                               True, None),
    "correlated_scalar_under_or_raises": (lambda P, s, paths: _sales(P, s, paths)
                                          .filter((P.col("s_return")
                                                   > P.scalar(_corr_mean(P, s, paths)))
                                                  | (P.col("s_cust") == 1)),
                                          False, None),
    "correlated_scalar_under_not": (lambda P, s, paths: _sales(P, s, paths).filter(
        ~(P.col("s_return") > P.scalar(_corr_mean(P, s, paths)))), False, None),
    "correlated_count_empty_group_is_zero": (
        lambda P, s, paths: s.read.parquet(paths["outer"]).filter(
            P.col("x") >= P.scalar(s.read.parquet(paths["inner"]).filter(
                P.col("ik") == P.outer_ref("k")).agg(cnt=("v", "count"))))
        .sort("k"), True, lambda t: "Join left" in t),
    "exists_correlated_semi": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_corr_stores(P, s, paths).filter(P.col("st_state") == "TN")
                 .select(one=P.lit(1)))), False, lambda t: "semi" in t),
    "not_exists_correlated_anti": (lambda P, s, paths: _sales(P, s, paths).filter(
        ~P.exists(_corr_stores(P, s, paths).filter(P.col("st_state") == "TN")
                  .select(one=P.lit(1)))), False, lambda t: "anti" in t),
    "exists_uncorrelated_nonempty": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(s.read.parquet(paths["stores"]).filter(
            P.col("st_state") == "TN"))), False, None),
    "exists_uncorrelated_empty": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(s.read.parquet(paths["stores"]).filter(
            P.col("st_state") == "XX"))), False, None),
    "not_exists_uncorrelated_empty": (lambda P, s, paths: _sales(P, s, paths)
                                      .filter(~P.exists(s.read.parquet(
                                          paths["stores"]).filter(
                                          P.col("st_state") == "XX"))),
                                      False, None),
    "exists_limit_1": (lambda P, s, paths: _sales(P, s, paths).filter(P.exists(
        _corr_stores(P, s, paths).select(one=P.lit(1)).limit(1))), False, None),
    "exists_limit_0": (lambda P, s, paths: _sales(P, s, paths).filter(P.exists(
        _corr_stores(P, s, paths).limit(0))), False, None),
    "not_exists_limit_0": (lambda P, s, paths: _sales(P, s, paths).filter(
        ~P.exists(_corr_stores(P, s, paths).limit(0))), False, None),
    "exists_distinct": (lambda P, s, paths: _sales(P, s, paths).filter(P.exists(
        _corr_stores(P, s, paths).select(one=P.lit(1)).distinct())), False, None),
    "exists_global_aggregate": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_corr_stores(P, s, paths).agg(m=("st_key", "max")))),
        False, None),
    "not_exists_global_aggregate": (lambda P, s, paths: _sales(P, s, paths)
                                    .filter(~P.exists(_corr_stores(P, s, paths)
                                                      .agg(m=("st_key", "max")))),
                                    False, None),
    "exists_grouped_aggregate": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_corr_stores(P, s, paths).group_by("st_state")
                 .agg(m=("st_key", "max")))), False, None),
    "exists_above_limit_barrier": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_limit_barrier(P, s, paths))), False, None),
    "exists_trapped_below_limit_raises": (lambda P, s, paths: _sales(P, s, paths)
                                          .filter(P.exists(_trapped(P, s, paths))),
                                          False, None),
    "exists_below_window_raises": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_corr_stores(P, s, paths)
                 .with_window("rk", "rank", order_by=[("st_key", False)])
                 .filter(P.col("rk") <= 1))), False, None),
    "exists_redefined_by_select_raises": (
        lambda P, s, paths: _sales(P, s, paths).filter(P.exists(
            _corr_stores(P, s, paths).select(st_key=P.col("st_key") * 2)
            .filter(P.col("st_key") >= 0))), False, None),
    "exists_redefined_by_with_column_raises": (
        lambda P, s, paths: _sales(P, s, paths).filter(P.exists(
            _corr_stores(P, s, paths)
            .with_column("st_key", P.col("st_key") * 2 + 1)
            .filter(P.col("st_key") >= 0))), False, None),
    "exists_with_column_adding": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_corr_stores(P, s, paths)
                 .with_column("extra", P.col("st_key") * 2)
                 .filter(P.col("extra") >= 0))), False, None),
    "exists_projected_away_raises": (lambda P, s, paths: _sales(P, s, paths)
                                     .filter(P.exists(_sales(P, s, paths).filter(
                                         P.col("s_cust") == P.outer_ref("s_cust"))
                                         .select("s_return")
                                         .filter(P.col("s_return") >= 0))),
                                     False, None),
    "exists_identity_compute": (lambda P, s, paths: _sales(P, s, paths).filter(
        P.exists(_corr_stores(P, s, paths)
                 .select("st_key", doubled=P.col("st_key") * 2)
                 .filter(P.col("doubled") >= 0))), False, None),
    "correlated_scalar_projected_away_raises": (
        lambda P, s, paths: _sales(P, s, paths).filter(
            P.col("s_return") > P.scalar(_sales(P, s, paths).filter(
                P.col("s_store") == P.outer_ref("s_store"))
                .select("s_return").agg(m=("s_return", "mean")))), False, None),
    "correlated_scalar_post_arithmetic": (
        lambda P, s, paths: _sales(P, s, paths).filter(
            P.col("s_return") > P.scalar(_sales(P, s, paths).filter(
                P.col("s_store") == P.outer_ref("s_store"))
                .agg(m=("s_return", "mean")).select(t=P.col("m") * 1.1))),
        False, None),
    "scalar_post_arithmetic_foreign_column_raises": (
        lambda P, s, paths: _sales(P, s, paths).filter(
            P.col("s_return") > P.scalar(_sales(P, s, paths).filter(
                P.col("s_store") == P.outer_ref("s_store"))
                .agg(m=("s_return", "mean")).select(t=P.col("s_store") * 1.1))),
        False, None),
    "correlated_scalar_without_equality_raises": (
        lambda P, s, paths: _sales(P, s, paths).filter(
            P.col("s_return") > P.scalar(_sales(P, s, paths).filter(
                P.col("s_store") < P.outer_ref("s_store"))
                .agg(m=("s_return", "mean")))), False, None),
    "in_subquery_two_columns_raises": (lambda P, s, paths: _sales(P, s, paths)
                                       .filter(P.in_subquery(
                                           "s_store", s.read.parquet(
                                               paths["stores"]))), False, None),
    "in_subquery_expression_probe_raises": (
        lambda P, s, paths: _sales(P, s, paths).filter(P.in_subquery(
            P.col("s_store") + 1, _tn(P, s, paths))), False, None),
    "in_subquery_under_or_raises": (lambda P, s, paths: _sales(P, s, paths)
                                    .filter(P.in_subquery("s_store", _tn(P, s, paths))
                                            | (P.col("s_cust") == 1)),
                                    False, None),
    "exists_in_select_raises": (lambda P, s, paths: _sales(P, s, paths).select(
        "s_store", e=P.exists(_tn(P, s, paths))), False, None),
    "two_subqueries_in_one_filter": (lambda P, s, paths: _sales(P, s, paths)
                                     .filter(P.in_subquery("s_store", _tn(P, s, paths))
                                             & (P.col("s_return") > P.scalar(
                                                 _corr_mean(P, s, paths)))
                                             & ~P.exists(_corr_stores(P, s, paths)
                                                         .filter(P.col("st_key") > 30)
                                                         .select(one=P.lit(1)))),
                                     False, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_subquery_equals_jax(tmp_path, data, name):
    build, ordered, check = CASES[name]
    (jk, *jrest), (tk, *trest) = _both(tmp_path, data, build)
    assert tk == jk, (trest, jrest)
    if jk == "err":
        assert trest == jrest
        assert name.endswith("_raises"), jrest
        return
    assert not name.endswith("_raises")
    _assert_same(trest[0], jrest[0], ordered)
    text = _plan_text(trest[1], data[0])
    assert text == _plan_text(jrest[1], data[0])
    if check is not None:
        assert check(text), text
    assert sorted(f["strategy"] for f in trest[2].get("joins", [])) \
        == sorted(f["strategy"] for f in jrest[2].get("joins", []))


def test_subquery_errors_are_subquery_errors(tmp_path, data):
    """The errors of the shapes above are each package's SubqueryError,
    a ValueError."""
    from hyperspace_tpu.plan.subquery import SubqueryError as JaxError
    from hyperspace_tpu_torch.plan.subquery import SubqueryError

    assert issubclass(SubqueryError, ValueError)
    for name in ("scalar_multirow_raises", "exists_below_window_raises",
                 "correlated_scalar_under_or_raises"):
        for pkg, err in ((hyperspace_tpu, JaxError),
                         (hyperspace_tpu_torch, SubqueryError)):
            s = _session(pkg, str(tmp_path / f"{name}_{pkg.__name__}"))
            with pytest.raises(err):
                CASES[name][0](pkg, s, data[1]).collect()


def test_scalar_fold_enables_pruning_like_jax(tmp_path, data):
    """A folded threshold is a plain constant: data skipping prunes on
    it, to the same file in both packages."""
    def setup(P, s, paths):
        P.Hyperspace(s).create_index(s.read.parquet(paths["mono"]),
                                     P.DataSkippingIndexConfig("kds", ["k"]))
        s.enable_hyperspace()

    out = _both(tmp_path, data, lambda P, s, paths: s.read.parquet(
        paths["mono"]).filter(P.col("k") > P.scalar(s.read.parquet(
            paths["mono"]).agg(m=("k", "max"))) - 500), setup=setup)
    (_jk, jt, jplan, _js), (_tk, tt, tplan, _ts) = out
    _assert_same(tt, jt, ordered=False)
    assert tt.num_rows == 500
    for plan in (jplan, tplan):
        pruned = [sc for sc in plan.leaf_relations()
                  if sc.relation.data_skipping_of]
        assert pruned and len(pruned[0].relation.file_paths) == 1


@pytest.mark.parametrize("enabled", [True, False], ids=["indexed", "source"])
@pytest.mark.parametrize("threshold", [0, HIGH], ids=["device", "host"])
def test_rewrite_composes_with_index_rules_like_jax(tmp_path, data, enabled,
                                                    threshold):
    """A semi join and a correlated scalar over an indexed relation: the
    covering index still applies on the outer side, the answers are
    equal with the rules on and off, and a folded scalar's filter takes
    the device route at threshold 0."""
    def setup(P, s, paths):
        P.Hyperspace(s).create_index(
            s.read.parquet(paths["sales"]),
            P.IndexConfig("sq_ix", ["s_store"], ["s_cust", "s_return"]))
        if enabled:
            s.enable_hyperspace()

    queries = {
        "semi": lambda P, s, paths: _sales(P, s, paths).filter(
            P.in_subquery("s_store", _tn(P, s, paths, "CA"))
            & (P.col("s_store") == 1)),
        "correlated": lambda P, s, paths: _sales(P, s, paths).filter(
            (P.col("s_return") > P.scalar(_corr_mean(P, s, paths)))
            & (P.col("s_store") < 20)).select("s_store", "s_return"),
        "folded": lambda P, s, paths: _sales(P, s, paths).filter(
            (P.col("s_store") == 3) & (P.col("s_return") > P.scalar(
                _sales(P, s, paths).agg(m=("s_return", "mean"))))),
    }
    for name, build in queries.items():
        out = _both(tmp_path / name, data, build, setup=setup,
                    threshold=threshold)
        (jk, jt, jplan, js), (tk, tt, tplan, ts) = out
        _assert_same(tt, jt, ordered=False)
        assert tt.num_rows > 0
        assert _plan_text(tplan, data[0]) == _plan_text(jplan, data[0])
        used = [sc for sc in tplan.leaf_relations()
                if sc.relation.index_scan_of]
        assert bool(used) == enabled, tplan.tree_string()
        routes = sorted(f["strategy"] for f in ts.get("filters", []))
        assert routes == sorted(f["strategy"] for f in js.get("filters", []))
        if name == "folded":
            assert routes == ["device" if threshold == 0 else "host"]


def _count_executors(monkeypatch, pkg):
    import importlib

    ex_mod = importlib.import_module(pkg.__name__ + ".execution.executor")
    calls = []
    orig = ex_mod.Executor.execute

    def counting(self, plan):
        calls.append(id(self))
        return orig(self, plan)

    monkeypatch.setattr(ex_mod.Executor, "execute", counting)
    return calls


def test_not_in_materializes_subquery_once_like_jax(tmp_path, data,
                                                    monkeypatch):
    """The null and empty probes and the anti join share one execution of
    the subquery: two executors run, the subquery's and the query's."""
    counts = []
    for pkg in PKGS:
        calls = _count_executors(monkeypatch, pkg)
        s = _session(pkg, str(tmp_path / pkg.__name__))
        got = _sales(pkg, s, data[1]).filter(
            ~pkg.in_subquery("s_store", _tn(pkg, s, data[1]))).count()
        counts.append((got, len(set(calls))))
    assert counts[0] == counts[1]
    assert counts[1][1] == 2


def test_fold_memoized_within_one_pass_like_jax(tmp_path, data, monkeypatch):
    """One ScalarSubquery object referenced twice is executed once per
    optimize pass."""
    import importlib

    counts = []
    for pkg in PKGS:
        sq_mod = importlib.import_module(pkg.__name__ + ".plan.subquery")
        calls = []
        orig = sq_mod._fold_scalar

        def counting(sub, session, orig=orig, calls=calls):
            calls.append(1)
            return orig(sub, session)

        monkeypatch.setattr(sq_mod, "_fold_scalar", counting)
        s = _session(pkg, str(tmp_path / pkg.__name__))
        sub = pkg.scalar(_sales(pkg, s, data[1]).agg(m=("s_return", "mean")))
        out = _sales(pkg, s, data[1]).filter(
            (pkg.col("s_return") > sub) & (pkg.col("s_return") < sub * 2))
        counts.append((out.collect().num_rows, len(calls)))
    assert counts[0] == counts[1]
    assert counts[1][1] == 1


class TestInequalityCorrelations:
    """EXISTS and NOT EXISTS with non-equality correlations (<> < >)
    riding an equality correlation, the TPC-H Q21 shape: each package
    against a naive per-row evaluation, and against each other."""

    @staticmethod
    def _naive(df, op, negate):
        keep = []
        for _idx, r in df.iterrows():
            grp = df[df.g == r.g]
            if op == "ne":
                m = grp[grp.s != r.s]
            elif op == "lt":
                m = grp[grp.v < r.v]
            else:
                m = grp[(grp.s != r.s) & (grp.v > r.v)]
            keep.append((len(m) > 0) != negate)
        return df[pd.Series(keep, index=df.index)]

    @staticmethod
    def _query(P, s, paths, op, negate):
        rows = lambda: s.read.parquet(paths["rows"])  # noqa: E731
        corr = P.col("g") == P.outer_ref("g")
        if op == "ne":
            inner = rows().filter(corr & (P.col("s") != P.outer_ref("s")))
        elif op == "lt":
            inner = rows().filter(corr & (P.col("v") < P.outer_ref("v")))
        else:
            inner = rows().filter(corr & (P.col("s") != P.outer_ref("s"))
                                  & (P.col("v") > P.outer_ref("v")))
        pred = P.exists(inner)
        return rows().filter(~pred if negate else pred)

    @pytest.mark.parametrize("op,negate", [
        ("ne", False), ("ne", True), ("lt", False), ("lt", True),
        ("mixed", False), ("mixed", True)])
    def test_fuzz_vs_naive(self, tmp_path, data, op, negate):
        out = _both(tmp_path, data,
                    lambda P, s, paths: self._query(P, s, paths, op, negate))
        (_jk, jt, jplan, _js), (_tk, tt, tplan, ts) = out
        df = pq.read_table(data[1]["rows"]).to_pandas()
        want = (self._naive(df, op, negate)
                .sort_values(["g", "s", "v"]).reset_index(drop=True))
        for table in (jt, tt):
            got = (table.to_pandas().sort_values(["g", "s", "v"])
                   .reset_index(drop=True))
            assert len(got) == len(want), (op, negate, len(got), len(want))
            assert (got.values == want.values).all()
        _assert_same(tt, jt, ordered=False)
        text = _plan_text(tplan, data[0])
        assert text == _plan_text(jplan, data[0])
        assert "residual" in text
        assert [j["strategy"] for j in ts["joins"]] == ["plain"]

    def test_residual_join_shows_in_plan(self, tmp_path, data):
        out = _both(tmp_path, data,
                    lambda P, s, paths: self._query(P, s, paths, "ne", False))
        texts = [_plan_text(r[2], data[0]) for r in out]
        assert texts[0] == texts[1] and "residual" in texts[1], texts

    def test_only_inequality_correlation_rejected(self, tmp_path, data):
        out = _both(tmp_path, data, lambda P, s, paths: s.read.parquet(
            paths["rows"]).filter(P.exists(s.read.parquet(paths["rows"]).filter(
                P.col("s") != P.outer_ref("s")))))
        assert out[0] == out[1]
        assert out[1][0] == "err" and "equality conjunct" in out[1][2]


def want_differs_from_equi(left, df):
    """The residual drops some matched pairs of the equi-join."""
    pairs = left.merge(df, on="g")
    return bool((pairs.s_x == pairs.s_y).any())


def _residual_join(P, s, paths, how="inner"):
    """rows ⋈ rows2 (the same rows, columns renamed) on g with the
    residual ``s <> s2``, built directly: ``Dataset.join`` is
    equi-only."""
    N = _nodes(P)
    left = s.read.parquet(paths["rows"]).filter(P.col("v") < 50)
    right = s.read.parquet(paths["rows2"]).filter(P.col("v2") > 10)
    join = N.Join(left.plan, right.plan, P.col("g") == P.col("g2"), how,
                  residual=~(P.col("s") == P.col("s2")))
    return P.Dataset(N.Filter(P.col("v") > 5, join), s)


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_residual_survives_pushdown_pruning_and_the_join_rule(tmp_path, data,
                                                              how):
    """The residual stays on the join through filter pushdown (the
    filter above sinks to the left side), column pruning (its columns
    stay required on both sides) and the join rule; a plain-equi answer
    would differ.  Both packages give the same rows and plans."""
    def setup(P, s, paths):
        hs = P.Hyperspace(s)
        hs.create_index(s.read.parquet(paths["rows"]),
                        P.IndexConfig("rows_ix", ["g"], ["s", "v"]))
        hs.create_index(s.read.parquet(paths["rows2"]),
                        P.IndexConfig("rows2_ix", ["g2"], ["s2", "v2"]))
        s.enable_hyperspace()

    for use_index in (False, True):
        out = _both(tmp_path / str(use_index), data,
                    lambda P, s, paths: _residual_join(P, s, paths, how),
                    setup=setup if use_index else None)
        (jk, jt, jplan, js), (tk, tt, tplan, ts) = out
        assert (jk, tk) == ("ok", "ok")
        _assert_same(tt, jt, ordered=False)
        text = _plan_text(tplan, data[0])
        assert text == _plan_text(jplan, data[0])
        assert "residual ~(col('s') == col('s2'))" in text, text
        # The filter above sank below the join, to the left side.
        assert text.splitlines()[0].startswith("Join"), text
        scans = [sc.relation.index_scan_of for sc in tplan.leaf_relations()]
        if use_index and how == "inner":
            # The join rule's rewrite, bucket specs and all; the residual
            # still keeps the bucket-aligned route off.
            assert scans == ["rows_ix", "rows2_ix"], text
        assert [j["strategy"] for j in ts["joins"]] == ["plain"]
    # Against a naive evaluation of the same join.
    df = pq.read_table(data[1]["rows"]).to_pandas()
    left = df[(df.v < 50) & (df.v > 5)].reset_index(drop=True)
    assert want_differs_from_equi(left, df)
    right = df[df.v > 10].rename(columns={"g": "g2", "s": "s2", "v": "v2"})
    pairs = left.reset_index().merge(right, left_on="g", right_on="g2")
    pairs = pairs[pairs.s != pairs.s2]
    want = {"inner": len(pairs),
            "left": len(pairs) + int((~left.index.isin(pairs["index"])).sum()),
            "semi": pairs["index"].nunique(),
            "anti": int((~left.index.isin(pairs["index"])).sum())}[how]
    assert tt.num_rows == want


def test_residual_join_declines_the_fused_join_aggregate(tmp_path, data):
    """An aggregate over an inner join with a residual: the port's fused
    join→aggregate declines it (it would drop the residual), at
    thresholds that take it for the same join without one."""
    N = _nodes(hyperspace_tpu_torch)
    P = hyperspace_tpu_torch
    s = _session(P, str(tmp_path / "ix"), threshold=0)
    s.conf.device_cache_policy = "eager"
    rows = s.read.parquet(data[1]["rows"])
    right = rows.select(g2=P.col("g"), s2=P.col("s"))
    results = {}
    for residual in (None, ~(P.col("s") == P.col("s2"))):
        join = N.Join(rows.plan, right.plan, P.col("g") == P.col("g2"),
                      "inner", residual=residual)
        out = P.Dataset(join, s).group_by("g").agg(n=("v", "count")) \
            .sort("g").collect()
        results[residual is None] = (out, s.last_execution_stats)
    plain_out, plain_stats = results[True]
    res_out, res_stats = results[False]
    assert plain_stats["joins"][-1]["strategy"] == "device-fused-agg"
    assert [j["strategy"] for j in res_stats["joins"]] == ["plain"]
    df = pq.read_table(data[1]["rows"]).to_pandas()
    pairs = df.merge(df.rename(columns={"g": "g2", "s": "s2", "v": "v2"}),
                     left_on="g", right_on="g2")
    want = pairs[pairs.s != pairs.s2].groupby("g").size()
    assert res_out.column("g").to_pylist() == want.index.tolist()
    assert res_out.column("n").to_pylist() == want.tolist()
    assert plain_out.column("n").to_pylist() \
        == pairs.groupby("g").size().tolist()
