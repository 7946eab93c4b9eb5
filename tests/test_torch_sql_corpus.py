"""The TPC-H and TPC-DS SQL corpora through hyperspace_tpu_torch (on the
CPU) against the JAX package.

The 22 TPC-H texts of tests/test_sql_tpch.py run over the catalog of
tests/test_plan_stability_tpch.py, and the 20 TPC-DS v1.4 texts of
tests/test_tpcds.py over its 24-table catalog (tests/resources/
tpcds_schema.py); the texts and the catalogs are those modules' own,
and the port builds the JAX fixtures' indexes again over the same files
(``twin_session``).  For each text the port's optimized plan, simplified
as the plan-stability suites simplify it, must equal the JAX package's
live plan, and the port's canonical answer with the index rules on and
with them off must equal the JAX package's.  The rewrites fire in the
port where the JAX package's tests require them to."""

from __future__ import annotations

import os

import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from tests.test_plan_stability import _simplify
from tests.test_plan_stability_tpch import TPCH_NAMES
from tests.test_plan_stability_tpch import _canonical as tpch_canonical
from tests.test_plan_stability_tpch import catalog as tpch_catalog  # noqa
from tests.test_sql_tpch import _sql_texts
from tests.test_tpcds import TPCDS_NAMES, TPCDS_QUERIES
from tests.test_tpcds import _canonical as tpcds_canonical
from tests.test_tpcds import catalog as tpcds_catalog  # noqa: F401
from tests.test_torch_sql import sql_of, twin_session

# test_tpch_rewrites_fire_where_expected's queries, by their SQL prefix.
TPCH_REWRITTEN = ("t02", "t03", "t04", "t05", "t06", "t08", "t09", "t10",
                  "t11", "t12", "t14", "t15", "t16", "t17", "t19")
# test_tpcds_rewrites_fire_where_expected's query.
TPCDS_REWRITTEN = ("q3",)


def _pair(catalog, root: str) -> dict:
    js, paths = catalog
    return {hyperspace_tpu: js, hyperspace_tpu_torch: twin_session(js, root),
            "paths": paths}


@pytest.fixture(scope="module")
def tpch(tpch_catalog, tmp_path_factory):
    return _pair(tpch_catalog, str(tmp_path_factory.mktemp("tpch_torch")
                                   / "indexes"))


@pytest.fixture(scope="module")
def tpcds(tpcds_catalog, tmp_path_factory):
    return _pair(tpcds_catalog, str(tmp_path_factory.mktemp("tpcds_torch")
                                    / "ix"))


def _index_scans(plan, covering_only: bool = False) -> list:
    """The indexes the scans of ``plan`` read: covering ones, and unless
    ``covering_only`` the data-skipping ones too."""
    out = []
    for s in plan.leaf_relations():
        name = s.relation.index_scan_of
        if not name and not covering_only:
            name = s.relation.data_skipping_of
        if name:
            out.append(name)
    return sorted(out)


def _check(pair: dict, text: str, tables, canonical):
    """Plans and answers of ``text`` in both packages; returns the port's
    optimized plan."""
    paths = pair["paths"]
    plans, answers = {}, {}
    for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
        s = pair[pkg]
        ds = sql_of(pkg).sql(s, text, tables=tables(s))
        plan = ds.optimized_plan()
        plans[pkg] = (_simplify(plan.tree_string(), paths), _index_scans(plan))
        answers[pkg] = canonical(ds.collect())
    assert plans[hyperspace_tpu_torch] == plans[hyperspace_tpu], (
        f"\n{plans[hyperspace_tpu_torch][0]}--- JAX ---\n"
        f"{plans[hyperspace_tpu][0]}")
    assert answers[hyperspace_tpu_torch] == answers[hyperspace_tpu]
    ts = pair[hyperspace_tpu_torch]
    ts.disable_hyperspace()
    try:
        off = canonical(sql_of(hyperspace_tpu_torch).sql(
            ts, text, tables=tables(ts)).collect())
    finally:
        ts.enable_hyperspace()
    assert off == answers[hyperspace_tpu], "rules off: the answer diverged"
    return plan


@pytest.mark.parametrize("prefix", TPCH_NAMES)
def test_tpch_sql_text(tpch, prefix):
    texts = _sql_texts()
    assert set(texts) == set(TPCH_NAMES)
    paths = tpch["paths"]
    plan = _check(tpch, texts[prefix],
                  lambda s: {t: s.read.parquet(p) for t, p in paths.items()},
                  tpch_canonical)
    if prefix in TPCH_REWRITTEN:
        assert _index_scans(plan), f"{prefix}: expected an index rewrite"


@pytest.mark.parametrize("name", TPCDS_NAMES)
def test_tpcds_sql_text(tpcds, name):
    assert len(TPCDS_NAMES) == 20
    plan = _check(tpcds, TPCDS_QUERIES[name], lambda s: tpcds["paths"],
                  tpcds_canonical)
    if name in TPCDS_REWRITTEN:
        assert _index_scans(plan, covering_only=True), \
            f"{name}: no index scan in the optimized plan"


def test_the_port_built_the_same_indexes(tpch, tpcds):
    """The twins hold the JAX catalogs' indexes, ACTIVE, with their
    columns and bucket counts (statistics as the JAX package lists
    them, apart from locations and sizes)."""
    keep = ("name", "indexedColumns", "includedColumns", "numBuckets",
            "schema", "state", "numIndexFiles")
    for pair in (tpch, tpcds):
        rows = {}
        for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
            table = pkg.Hyperspace(pair[pkg]).indexes()
            rows[pkg] = [{k: r[k] for k in keep} for r in table.to_pylist()]
        assert rows[hyperspace_tpu_torch] == rows[hyperspace_tpu]
        assert {r["state"] for r in rows[hyperspace_tpu]} == {"ACTIVE"}
        assert os.path.isdir(pair[hyperspace_tpu_torch].conf.system_path)
