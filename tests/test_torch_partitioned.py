"""Hive-partitioned sources through the port, held to the JAX package: the
13 cases of tests/test_partitioned.py, each run through both packages
over the same ``key=value`` directory tree (made from numpy): the
partition columns' values and types, the query rows (in order where the
plan fixes one, as canonical rows where it does not), the plans' index
and data-skipping scans, and the index files' sha256 per bucket.  Then
the partition columns through the spill build, an ORC source and the
projection of partition columns alone."""

from __future__ import annotations

import hashlib
import os
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from tests.utils import canonical_rows

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)


def _name(pkg) -> str:
    return "jax" if pkg is JAX else "torch"


def _session(pkg, root: str, num_buckets: int = 2):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, _name(pkg)),
                              **kw)
    s.conf.num_buckets = num_buckets
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    return s


def _write_partitioned(root, dates=("2024", "2025"), rows_per=5):
    n = 0
    for d in dates:
        part = os.path.join(root, f"date={d}")
        os.makedirs(part, exist_ok=True)
        pq.write_table(pa.table({
            "id": pa.array(np.arange(n, n + rows_per, dtype=np.int64)),
            "v": pa.array(np.arange(n, n + rows_per, dtype=np.int64) * 10),
        }), os.path.join(part, "part-0.parquet"))
        n += rows_per
    return root


def _bucket_digests(entry) -> dict:
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[os.path.basename(f.name)[:12]].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(d) for b, d in out.items()}


def _index_scans(plan) -> list:
    return [s.relation.index_scan_of for s in plan.leaf_relations()
            if s.relation.index_scan_of]


def _both(tmp_path, run) -> dict:
    """``run(pkg, session)`` per package, each on its own system path."""
    return {_name(pkg): run(pkg, _session(pkg, str(tmp_path)))
            for pkg in PKGS}


def _same_tables(out: dict) -> None:
    assert out["torch"].schema == out["jax"].schema
    assert out["torch"].equals(out["jax"])


class TestReads:
    def test_partition_column_materializes(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))
        out = _both(tmp_path, lambda pkg, s: s.read.parquet(root).collect())
        _same_tables(out)
        t = out["torch"]
        assert t.schema.field("date").type == pa.int64()
        assert sorted(set(t.column("date").to_pylist())) == [2024, 2025]

    def test_filter_on_partition_column(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))
        out = _both(tmp_path, lambda pkg, s: s.read.parquet(root)
                    .filter(pkg.col("date") == 2024).select("id", "date")
                    .collect())
        _same_tables(out)
        assert out["torch"].num_rows == 5
        assert set(out["torch"].column("date").to_pylist()) == {2024}

    def test_string_literal_coerces_to_partition_type(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))
        out = _both(tmp_path, lambda pkg, s: s.read.parquet(root)
                    .filter(pkg.col("date") == "2024").select("id").collect())
        _same_tables(out)
        assert out["torch"].num_rows == 5

    def test_int_partition_type_inference(self, tmp_path):
        root = str(tmp_path / "data")
        for y in (2024, 2025):
            os.makedirs(os.path.join(root, f"year={y}"))
            pq.write_table(pa.table({"id": pa.array([1], type=pa.int64())}),
                           os.path.join(root, f"year={y}", "p.parquet"))
        out = _both(tmp_path, lambda pkg, s: s.read.parquet(root)
                    .filter(pkg.col("year") >= 2025).collect())
        _same_tables(out)
        assert out["torch"].num_rows == 1
        assert out["torch"].schema.field("year").type == pa.int64()

    def test_hive_null_partition(self, tmp_path):
        root = str(tmp_path / "data")
        os.makedirs(os.path.join(root, "k=__HIVE_DEFAULT_PARTITION__"))
        pq.write_table(pa.table({"id": pa.array([1], type=pa.int64())}),
                       os.path.join(root, "k=__HIVE_DEFAULT_PARTITION__",
                                    "p.parquet"))
        out = _both(tmp_path, lambda pkg, s: s.read.parquet(root).collect())
        _same_tables(out)
        assert out["torch"].column("k").to_pylist() == [None]

    def test_index_version_dirs_are_not_partitions(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))

        def run(pkg, s):
            pkg.Hyperspace(s).create_index(
                s.read.parquet(root), pkg.IndexConfig("pi", ["id"], ["v"]))
            s.enable_hyperspace()
            ds = s.read.parquet(root).filter(pkg.col("id") == 3) \
                .select("id", "v")
            assert _index_scans(ds.optimized_plan()) == ["pi"]
            return ds.collect()

        out = _both(tmp_path, run)
        _same_tables(out)
        assert set(out["torch"].column_names) == {"id", "v"}
        assert out["torch"].num_rows == 1


class TestIndexing:
    def test_partition_column_as_included(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))

        def run(pkg, s):
            pkg.Hyperspace(s).create_index(
                s.read.parquet(root), pkg.IndexConfig("pi", ["id"], ["date"]))
            s.enable_hyperspace()
            ds = s.read.parquet(root).filter(pkg.col("id") == 7) \
                .select("id", "date")
            assert _index_scans(ds.optimized_plan()) == ["pi"]
            got = ds.collect()
            s.disable_hyperspace()
            assert canonical_rows(got) == canonical_rows(ds.collect())
            return got, _bucket_digests(s.index_collection_manager
                                        .get_index("pi"))

        out = _both(tmp_path, run)
        assert out["torch"][0].equals(out["jax"][0])
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][0].column("date").to_pylist() == [2025]

    def test_partition_column_as_indexed(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))

        def run(pkg, s):
            pkg.Hyperspace(s).create_index(
                s.read.parquet(root), pkg.IndexConfig("pd", ["date"], ["id"]))
            s.enable_hyperspace()
            ds = s.read.parquet(root).filter(pkg.col("date") == 2024) \
                .select("date", "id")
            assert _index_scans(ds.optimized_plan()) == ["pd"]
            return ds.collect(), _bucket_digests(
                s.index_collection_manager.get_index("pd"))

        out = _both(tmp_path, run)
        assert out["torch"][0].equals(out["jax"][0])
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][0].num_rows == 5

    def test_hybrid_scan_new_partition(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"))
        sessions = {}
        for pkg in PKGS:
            s = _session(pkg, str(tmp_path))
            s.conf.hybrid_scan_enabled = True
            # One new file of three: past the default 0.3 byte ratio, so
            # raised for the plan to merge the new partition through
            # hybrid scan.
            s.conf.hybrid_scan_max_appended_ratio = 0.9
            pkg.Hyperspace(s).create_index(
                s.read.parquet(root), pkg.IndexConfig("pi", ["id"], ["date"]))
            sessions[_name(pkg)] = s
        part = os.path.join(root, "date=2026")
        os.makedirs(part)
        pq.write_table(pa.table({
            "id": pa.array([100], type=pa.int64()),
            "v": pa.array([0], type=pa.int64()),
        }), os.path.join(part, "part-0.parquet"))
        out = {}
        for pkg in PKGS:
            s = sessions[_name(pkg)]
            s.enable_hyperspace()
            ds = s.read.parquet(root).filter(pkg.col("id") >= 0) \
                .select("id", "date")
            plan = ds.optimized_plan()
            assert _index_scans(plan) == ["pi"]
            assert "Union" in plan.tree_string()
            got = ds.collect()
            s.disable_hyperspace()
            assert canonical_rows(got) == canonical_rows(ds.collect())
            out[_name(pkg)] = got
        assert canonical_rows(out["torch"]) == canonical_rows(out["jax"])
        assert 2026 in out["torch"].column("date").to_pylist()

    def test_data_skipping_on_partition_column(self, tmp_path):
        root = _write_partitioned(str(tmp_path / "data"),
                                  dates=("2021", "2022", "2023", "2024"))

        def run(pkg, s):
            pkg.Hyperspace(s).create_index(
                s.read.parquet(root), pkg.DataSkippingIndexConfig("dsp",
                                                                  ["date"]))
            s.enable_hyperspace()
            ds = s.read.parquet(root).filter(pkg.col("date") == 2023) \
                .select("id", "date")
            scans = [r.relation for r in ds.optimized_plan().leaf_relations()
                     if r.relation.data_skipping_of]
            assert scans and scans[0].data_skipping_stats == (1, 4)
            got = ds.collect()
            s.disable_hyperspace()
            assert canonical_rows(got) == canonical_rows(ds.collect())
            return got, [os.path.relpath(p, root)
                         for p in scans[0].file_paths]

        out = _both(tmp_path, run)
        assert out["torch"][0].equals(out["jax"][0])
        assert out["torch"][1] == out["jax"][1] == [
            os.path.join("date=2023", "part-0.parquet")]
        assert out["torch"][0].num_rows == 5


class TestSpecConsistency:
    def test_mixed_type_partition_values_build(self, tmp_path):
        root = str(tmp_path / "data")
        for k in ("1", "x"):
            os.makedirs(os.path.join(root, f"k={k}"))
            pq.write_table(pa.table({"id": pa.array([1], type=pa.int64())}),
                           os.path.join(root, f"k={k}", "p.parquet"))

        def run(pkg, s):
            full = s.read.parquet(root).collect()
            assert full.schema.field("k").type == pa.string()
            pkg.Hyperspace(s).create_index(
                s.read.parquet(root), pkg.IndexConfig("mi", ["id"], ["k"]))
            s.enable_hyperspace()
            got = s.read.parquet(root).filter(pkg.col("id") == 1) \
                .select("id", "k").collect()
            return full, got, _bucket_digests(
                s.index_collection_manager.get_index("mi"))

        out = _both(tmp_path, run)
        for i in (0, 1):
            assert out["torch"][i].equals(out["jax"][i])
        assert out["torch"][2] == out["jax"][2]
        assert sorted(out["torch"][0].column("k").to_pylist()) == ["1", "x"]
        assert sorted(out["torch"][1].column("k").to_pylist()) == ["1", "x"]

    def test_file_column_wins_over_path_value(self, tmp_path):
        d = os.path.join(str(tmp_path / "data"), "date=2024")
        os.makedirs(d)
        pq.write_table(pa.table({
            "id": pa.array([1], type=pa.int64()),
            "date": pa.array([1999], type=pa.int64()),
        }), os.path.join(d, "p.parquet"))
        root = str(tmp_path / "data")
        out = _both(tmp_path, lambda pkg, s: (
            s.read.parquet(root).collect(),
            s.read.parquet(root).select("id", "date").collect()))
        for i in (0, 1):
            assert out["torch"][i].equals(out["jax"][i])
            assert out["torch"][i].column("date").to_pylist() == [1999]

    def test_mixed_schema_file_vs_path_conflict_is_per_file(self, tmp_path):
        root = str(tmp_path / "data")
        d = os.path.join(root, "date=2024")
        os.makedirs(d)
        pq.write_table(pa.table({
            "id": pa.array([1], type=pa.int64()),
            "date": pa.array([1999], type=pa.int64()),
        }), os.path.join(d, "part-0.parquet"))
        pq.write_table(pa.table({"id": pa.array([2], type=pa.int64())}),
                       os.path.join(d, "part-1.parquet"))
        for sel in (None, ("id", "date")):
            def run(pkg, s):
                df = s.read.parquet(root)
                return (df.select(*sel) if sel else df).collect()

            out = _both(tmp_path, run)
            assert out["torch"].equals(out["jax"])
            by_id = dict(zip(out["torch"].column("id").to_pylist(),
                             out["torch"].column("date").to_pylist()))
            assert by_id == {1: 1999, 2: 2024}


class TestBeyondTheOracle:
    def test_spill_build_carries_the_partition_column(self, tmp_path):
        """The spill build reads each file with the relation's one spec;
        its buckets equal the monolithic build's and the JAX package's."""
        root = str(tmp_path / "data")
        rng = np.random.default_rng(11)
        for k in ("a", "b", "7"):
            for f in range(2):
                part = os.path.join(root, f"region={k}")
                os.makedirs(part, exist_ok=True)
                pq.write_table(pa.table({
                    "id": rng.integers(0, 500, 300),
                    "x": rng.random(300)}),
                    os.path.join(part, f"part-{f}.parquet"))
        digests = {}
        for pkg in PKGS:
            for batch in (1 << 20, 400):
                s = _session(pkg, str(tmp_path / f"b{batch}"), num_buckets=4)
                s.conf.device_batch_rows = batch
                pkg.Hyperspace(s).create_index(
                    s.read.parquet(root),
                    pkg.IndexConfig("si", ["id"], ["region", "x"]))
                if pkg is TORCH:
                    assert ("spill_route_s" in s.build_stats_log[-1]) == \
                        (batch == 400)
                digests[(_name(pkg), batch)] = _bucket_digests(
                    s.index_collection_manager.get_index("si"))
        first = digests[("jax", 1 << 20)]
        assert len(first) == 4
        assert all(d == first for d in digests.values())

    def test_partitioned_orc_source(self, tmp_path):
        """Partition columns of another format come from the paths, and
        a projection of them alone keeps the row count."""
        import pyarrow.orc as paorc

        root = str(tmp_path / "data")
        for d in ("1", "2"):
            os.makedirs(os.path.join(root, f"day={d}"))
            paorc.write_table(pa.table({
                "id": pa.array(np.arange(4, dtype=np.int64) + 10 * int(d)),
                "s": pa.array([f"s{d}"] * 4)}),
                os.path.join(root, f"day={d}", "p.orc"))

        def run(pkg, s):
            df = s.read.orc(root)
            return (s.schema_map_of(df.plan), df.collect(),
                    df.select("day").collect(),
                    df.filter(pkg.col("day") == 2).select("id", "day")
                    .collect())

        out = _both(tmp_path, run)
        assert out["torch"][0] == out["jax"][0] == {
            "id": "int64", "s": "string", "day": "int64"}
        for i in (1, 2, 3):
            assert out["torch"][i].equals(out["jax"][i])
        assert out["torch"][2].num_rows == 8
        assert out["torch"][3].column("id").to_pylist() == [20, 21, 22, 23]

    @pytest.mark.parametrize("columns", [["date"], ["date", "id"]])
    def test_parquet_projection_of_partition_columns(self, tmp_path,
                                                     columns):
        root = _write_partitioned(str(tmp_path / "data"))
        out = _both(tmp_path, lambda pkg, s: s.read.parquet(root)
                    .select(*columns).collect())
        assert out["torch"].equals(out["jax"])
        assert out["torch"].num_rows == 10
        assert out["torch"].column_names == columns
