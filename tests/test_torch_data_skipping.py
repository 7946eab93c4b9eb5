"""Data skipping through the port, held to the JAX package: the cases of
tests/test_data_skipping.py, each run through both packages over the
same source files (made from a seed with numpy), with the same sketch
tables, log entries up to paths, pruned file lists and answers; and the
``_sketch.parquet`` a covering create, refresh and optimize write beside
their bucket files.  Both packages run their default CPU routes."""

from __future__ import annotations

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.actions.data_skipping import read_sketch as jax_read_sketch
from hyperspace_tpu_torch.actions.data_skipping import read_sketch as torch_read_sketch
from tests.utils import canonical_rows

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)


def _name(pkg) -> str:
    return "jax" if pkg is hyperspace_tpu else "torch"


def _session(pkg, root, num_buckets=4):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, _name(pkg)), **kw)
    s.conf.num_buckets = num_buckets
    if pkg is hyperspace_tpu:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    return s


def _read_sketch(pkg, entry):
    fn = jax_read_sketch if pkg is hyperspace_tpu else torch_read_sketch
    return fn(entry)


def _write_partitioned(root, n_files=5, rows_per_file=100):
    """Files with disjoint id ranges, so min/max pruning decides."""
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n_files):
        start = i * rows_per_file
        t = pa.table({
            "id": np.arange(start, start + rows_per_file, dtype=np.int64),
            "name": pa.array([f"n{j}" for j in range(start, start + rows_per_file)]),
            "v": np.arange(start, start + rows_per_file, dtype=np.int64) * 2,
        })
        p = os.path.join(root, f"part-{i:05d}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    return paths


def _ds_scans(plan):
    return [s for s in plan.leaf_relations() if s.relation.data_skipping_of]


def _kept(plan):
    """(data-skipping index, files kept, files in all, kept basenames) of
    the one pruned scan, or None."""
    scans = _ds_scans(plan)
    if not scans:
        return None
    rel = scans[0].relation
    return (rel.data_skipping_of, rel.data_skipping_stats,
            sorted(os.path.basename(p) for p in rel.file_paths))


def _both(tmp_path, data, configs, query=None, rows=None):
    """Per package: a session over ``tmp_path`` with the indexes of
    ``configs`` built over ``data``, hyperspace on; with ``query`` (a
    function of the session returning a Dataset) also its pruning and its
    rows with hyperspace on and off, which must agree across packages and
    with each other."""
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        hs = pkg.Hyperspace(s)
        for cfg in configs:
            hs.create_index(s.read.parquet(data), cfg(pkg))
        s.enable_hyperspace()
        res = {"session": s, "hs": hs}
        if query is not None:
            ds = query(s)
            res["kept"] = _kept(ds.optimized_plan())
            res["on"] = canonical_rows(ds.collect())
            s.disable_hyperspace()
            res["off"] = canonical_rows(ds.collect())
            s.enable_hyperspace()
            assert res["on"] == res["off"], _name(pkg)
            if rows is not None:
                assert len(res["on"]) == rows, _name(pkg)
        out[_name(pkg)] = res
    if query is not None:
        assert out["torch"]["kept"] == out["jax"]["kept"]
        assert out["torch"]["on"] == out["jax"]["on"]
    return out


def _ds(name, cols, types=None):
    return lambda pkg: pkg.DataSkippingIndexConfig(name, cols, types)


def _ci(name, indexed, included):
    return lambda pkg: pkg.IndexConfig(name, indexed, included)


def _sketch_rows(pkg, entry):
    return sorted(_read_sketch(pkg, entry).to_pylist(),
                  key=lambda r: r["_ds_file_name"])


def _normalized(entry_dict, roots):
    """A log entry's JSON with the system paths and the sketch file's
    random name taken out, and its timestamp dropped (digests stay)."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items() if k != "timestamp"}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, str):
            for r in roots:
                x = x.replace(r, "<ix>")
            return re.sub(r"sketch-[0-9a-f]{12}\.parquet", "sketch.parquet", x)
        return x
    return walk(entry_dict)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------
class TestBuild:
    def test_create_writes_sketch_and_log(self, tmp_path):
        data = str(tmp_path / "data")
        _write_partitioned(data)
        out = _both(tmp_path, data, [_ds("ds1", ["id"])])
        sketches = {}
        for pkg in PKGS:
            s = out[_name(pkg)]["session"]
            entry = s.index_collection_manager.get_index("ds1")
            assert not entry.is_covering
            assert entry.kind_abbr == "DS"
            assert entry.derived_dataset.sketched_columns == ["id"]
            assert entry.derived_dataset.sketch_types == ["MinMax"]
            files = entry.content.file_infos()
            assert len(files) == 1 and "sketch-" in files[0].name
            sketch = pq.read_table(files[0].name)
            assert sketch.num_rows == 5
            assert set(sketch.column_names) >= {"_ds_file_name", "min__id",
                                                "max__id"}
            sketches[_name(pkg)] = sketch
        assert sketches["torch"].equals(sketches["jax"])

    def test_log_entry_json_equals_up_to_paths(self, tmp_path):
        data = str(tmp_path / "data")
        _write_partitioned(data, n_files=2)
        out = _both(tmp_path, data, [_ds("ds1", ["id", "v"])])
        roots = [str(tmp_path / n) for n in ("jax", "torch")]
        dicts = {}
        for pkg in PKGS:
            s = out[_name(pkg)]["session"]
            entry = s.index_collection_manager.get_index("ds1")
            assert entry.derived_dataset.sketched_columns == ["id", "v"]
            d = entry.to_dict()
            # The content tree as its leaf files: the trees differ in the
            # directory names of the two system paths.
            d["content"] = [[f.name, f.size, f.digest]
                            for f in entry.content.file_infos()]
            dicts[_name(pkg)] = _normalized(d, roots)
        assert dicts["torch"] == dicts["jax"]
        # Either package reads the other's entry.
        from hyperspace_tpu.index.log_entry import IndexLogEntry as JaxEntry
        from hyperspace_tpu_torch.index.log_entry import IndexLogEntry as TorchEntry

        jentry = out["jax"]["session"].index_collection_manager.get_index("ds1")
        assert TorchEntry.from_dict(jentry.to_dict()).derived_dataset \
            .to_dict() == jentry.derived_dataset.to_dict()
        tentry = out["torch"]["session"].index_collection_manager.get_index("ds1")
        assert JaxEntry.from_dict(tentry.to_dict()).derived_dataset \
            .sketched_columns == ["id", "v"]

    def test_listed_alongside_covering(self, tmp_path):
        data = str(tmp_path / "data")
        _write_partitioned(data, n_files=2)
        out = _both(tmp_path, data, [_ci("ci1", ["id"], ["name"]),
                                     _ds("ds1", ["id"])])
        jnames = out["jax"]["hs"].indexes().column("name").to_pylist()
        tnames = out["torch"]["hs"].indexes().column("name").to_pylist()
        assert sorted(tnames) == sorted(jnames) == ["ci1", "ds1"]

    @pytest.mark.parametrize("pkg", PKGS, ids=_name)
    def test_unresolvable_column_rejected(self, tmp_path, pkg):
        data = str(tmp_path / "data")
        _write_partitioned(data, n_files=1)
        s = _session(pkg, str(tmp_path))
        with pytest.raises(pkg.HyperspaceError, match="sketched column"):
            pkg.Hyperspace(s).create_index(
                s.read.parquet(data), pkg.DataSkippingIndexConfig("ds1", ["nope"]))

    @pytest.mark.parametrize("pkg", PKGS, ids=_name)
    def test_optimize_rejected(self, tmp_path, pkg):
        data = str(tmp_path / "data")
        _write_partitioned(data, n_files=2)
        s = _session(pkg, str(tmp_path))
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(data),
                        pkg.DataSkippingIndexConfig("ds1", ["id"]))
        with pytest.raises(pkg.HyperspaceError, match="covering"):
            hs.optimize_index("ds1")

    @pytest.mark.parametrize("pkg", PKGS, ids=_name)
    def test_bad_sketch_type_rejected(self, pkg):
        with pytest.raises(pkg.HyperspaceError, match="Unknown sketch type"):
            pkg.DataSkippingIndexConfig("x", ["a"], ["Bloom"])
        with pytest.raises(pkg.HyperspaceError, match="length"):
            pkg.DataSkippingIndexConfig("x", ["a", "b"], ["MinMax"])


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------
def _col(s):
    return hyperspace_tpu.col if isinstance(s, hyperspace_tpu.HyperspaceSession) \
        else hyperspace_tpu_torch.col


# (name, predicate over col, selected columns, expected (kept, total) or
# None for no pruning, expected rows)
RULE_CASES = [
    ("point", lambda c: c("id") == 123, ("id", "name"), (1, 5), 1),
    ("range", lambda c: (c("id") >= 150) & (c("id") < 250), ("id", "v"),
     (2, 5), 100),
    ("isin", lambda c: c("id").isin([5, 450]), ("id",), (2, 5), 2),
    ("no_match", lambda c: c("id") == 10_000, ("id", "name"), (1, 5), 0),
    ("unsketchable", lambda c: c("name") == "n3", ("id",), None, 1),
    ("or_of_equalities", lambda c: (c("id") == 1) | (c("id") == 499), ("id",),
     (2, 5), 2),
    ("or_of_ranges", lambda c: ((c("id") >= 10) & (c("id") < 20))
     | ((c("id") >= 110) & (c("id") < 120)), ("id",), (2, 5), 20),
    ("opposite_unbounded_or", lambda c: (c("id") < 3) | (c("id") > 490),
     ("id",), None, 3 + 9),
]


@pytest.mark.parametrize("case", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_prunes_as_the_jax_package(tmp_path, case):
    _, pred, cols, stats, rows = case
    data = str(tmp_path / "data")
    _write_partitioned(data)
    out = _both(tmp_path, data, [_ds("ds1", ["id"])],
                lambda s: s.read.parquet(data).filter(pred(_col(s))).select(*cols),
                rows)
    kept = out["torch"]["kept"]
    if stats is None:
        assert kept is None
    else:
        assert kept[:2] == ("ds1", stats)
    if case[0] == "no_match":
        ds = out["torch"]["session"].read.parquet(data) \
            .filter(hyperspace_tpu_torch.col("id") == 10_000).select(*cols)
        assert set(ds.collect().column_names) == set(cols)


def test_covering_index_wins_over_ds(tmp_path):
    data = str(tmp_path / "data")
    _write_partitioned(data)
    out = _both(tmp_path, data, [_ci("ci1", ["id"], ["name"]), _ds("ds1", ["id"])],
                lambda s: s.read.parquet(data).filter(_col(s)("id") == 3)
                .select("id", "name"), 1)
    for res in out.values():
        plan = (res["session"].read.parquet(data)
                .filter(_col(res["session"])("id") == 3)
                .select("id", "name").optimized_plan())
        covering = [s for s in plan.leaf_relations() if s.relation.index_scan_of]
        assert covering and not _ds_scans(plan)


def test_plan_shows_ds_usage(tmp_path):
    """The explain tag of a pruned scan: the same line in both plans."""
    data = str(tmp_path / "data")
    _write_partitioned(data)
    out = _both(tmp_path, data, [_ds("ds1", ["id"])])
    lines = {}
    for name, res in out.items():
        s = res["session"]
        plan = s.read.parquet(data).filter(_col(s)("id") == 1).select("id") \
            .optimized_plan().tree_string()
        lines[name] = [ln.strip() for ln in plan.splitlines() if "DS" in ln]
    assert lines["torch"] == lines["jax"]
    assert len(lines["torch"]) == 1
    assert "Hyperspace(Type: DS, Name: ds1) [files: 1/5]" in lines["torch"][0]


def test_reused_dataset_branches_prune_independently(tmp_path):
    """One Dataset under two join branches: each branch prunes by its own
    predicate."""
    data = str(tmp_path / "data")
    _write_partitioned(data)
    for lo_hi, want in (((10, 490), 0), ((200, 100), 100)):
        def query(s, lo_hi=lo_hi):
            c = _col(s)
            base = s.read.parquet(data)
            return (base.filter(c("id") < lo_hi[0])
                    .join(base.filter(c("id") >= lo_hi[1]), c("id") == c("id"))
                    .select("id"))
        _both(tmp_path / f"q{want}", data, [_ds("ds1", ["id"])], query, want)


# ---------------------------------------------------------------------------
# a changing source
# ---------------------------------------------------------------------------
def _sessions(tmp_path, data, configs):
    out = _both(tmp_path, data, configs)
    return [(pkg, out[_name(pkg)]["session"], out[_name(pkg)]["hs"])
            for pkg in PKGS]


def test_appended_files_always_survive(tmp_path):
    data = str(tmp_path / "data")
    _write_partitioned(data, n_files=3)
    sessions = _sessions(tmp_path, data, [_ds("ds1", ["id"])])
    pq.write_table(pa.table({
        "id": pa.array([10_000], type=pa.int64()),
        "name": pa.array(["new"]),
        "v": pa.array([0], type=pa.int64()),
    }), os.path.join(data, "part-99999.parquet"))
    got = {}
    for pkg, s, _hs in sessions:
        ds = s.read.parquet(data).filter(pkg.col("id") == 10_000).select("id", "name")
        got[_name(pkg)] = (_kept(ds.optimized_plan()), canonical_rows(ds.collect()))
    assert got["torch"] == got["jax"]
    assert got["torch"][1] == [(10_000, "new")]


def test_refresh_incremental_updates_sketch(tmp_path):
    data = str(tmp_path / "data")
    paths = _write_partitioned(data, n_files=3)
    sessions = _sessions(tmp_path, data, [_ds("ds1", ["id"])])
    os.remove(paths[0])
    pq.write_table(pa.table({
        "id": pa.array([900], type=pa.int64()),
        "name": pa.array(["x"]),
        "v": pa.array([1], type=pa.int64()),
    }), os.path.join(data, "part-00009.parquet"))
    got = {}
    for pkg, s, hs in sessions:
        hs.refresh_index("ds1", "incremental")
        entry = s.index_collection_manager.get_index("ds1")
        rows = _sketch_rows(pkg, entry)
        names = [os.path.basename(r["_ds_file_name"]) for r in rows]
        assert "part-00000.parquet" not in names
        assert "part-00009.parquet" in names
        assert len(rows) == 3
        ds = s.read.parquet(data).filter(pkg.col("id") == 900).select("id", "name")
        kept = _kept(ds.optimized_plan())
        assert kept[:2] == ("ds1", (1, 3))
        got[_name(pkg)] = (rows, kept, canonical_rows(ds.collect()))
    assert got["torch"] == got["jax"]
    assert len(got["torch"][2]) == 1


def test_refresh_noop_when_unchanged(tmp_path):
    data = str(tmp_path / "data")
    _write_partitioned(data, n_files=2)
    summaries = {}
    for pkg, s, hs in _sessions(tmp_path, data, [_ds("ds1", ["id"])]):
        summary = hs.refresh_index("ds1", "incremental")
        assert s.index_collection_manager.get_index("ds1").state == "ACTIVE"
        summaries[_name(pkg)] = (summary.outcome, summary.version)
    assert summaries["torch"] == summaries["jax"] == ("noop", None)


def test_lifecycle_delete_restore_vacuum(tmp_path):
    data = str(tmp_path / "data")
    _write_partitioned(data, n_files=2)
    for pkg, s, hs in _sessions(tmp_path, data, [_ds("ds1", ["id"])]):
        hs.delete_index("ds1")
        assert s.index_collection_manager.get_index("ds1").state == "DELETED"
        hs.restore_index("ds1")
        assert s.index_collection_manager.get_index("ds1").state == "ACTIVE"
        hs.delete_index("ds1")
        hs.vacuum_index("ds1")
        entry = s.index_collection_manager.get_index("ds1")
        assert entry is None or entry.state == "DOESNOTEXIST", _name(pkg)


# ---------------------------------------------------------------------------
# value lists and bloom filters
# ---------------------------------------------------------------------------
def test_value_list_prunes_where_minmax_cannot(tmp_path):
    """Every file's min/max spans [0, 99]; only the value list prunes."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(4):
        cats = [0, 99, 2 * i, 2 * i + 1] * 25
        pq.write_table(pa.table({
            "cat": pa.array(cats, type=pa.int64()),
            "v": pa.array(np.arange(100, dtype=np.int64)),
        }), os.path.join(data, f"part-{i:05d}.parquet"))
    out = _both(tmp_path, data, [_ds("vls", ["cat"], ["ValueList"])],
                lambda s: s.read.parquet(data).filter(_col(s)("cat") == 5)
                .select("cat", "v"), 25)
    assert out["torch"]["kept"][:2] == ("vls", (1, 4))
    rows = {n: _sketch_rows(pkg, out[n]["session"].index_collection_manager
                            .get_index("vls")) for pkg, n in zip(PKGS, ("jax", "torch"))}
    assert rows["torch"] == rows["jax"]
    assert all("values__cat" in r for r in rows["torch"])


def test_high_cardinality_falls_back_to_minmax(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(2):
        pq.write_table(pa.table({
            "k": pa.array(np.arange(i * 1000, (i + 1) * 1000, dtype=np.int64)),
        }), os.path.join(data, f"part-{i:05d}.parquet"))
    out = _both(tmp_path, data, [_ds("hc", ["k"], ["ValueList"])],
                lambda s: s.read.parquet(data).filter(_col(s)("k") == 1500)
                .select("k"), 1)
    assert out["torch"]["kept"][:2] == ("hc", (1, 2))
    rows = _sketch_rows(hyperspace_tpu_torch, out["torch"]["session"]
                        .index_collection_manager.get_index("hc"))
    assert all(r["values__k"] is None for r in rows)


def test_bloom_prunes_high_cardinality_equality(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(4):
        ids = [f"user-{i:02d}-{j:04d}" for j in range(500)] + ["aaa", "zzz"]
        pq.write_table(pa.table({
            "uid": pa.array(ids),
            "v": pa.array(np.arange(len(ids), dtype=np.int64)),
        }), os.path.join(data, f"part-{i:05d}.parquet"))
    out = _both(tmp_path, data, [_ds("bf", ["uid"], ["BloomFilter"])],
                lambda s: s.read.parquet(data)
                .filter(_col(s)("uid") == "user-02-0123").select("uid", "v"), 1)
    _, (kept, total), _ = out["torch"]["kept"]
    assert total == 4 and kept <= 2
    rows = {n: _sketch_rows(pkg, out[n]["session"].index_collection_manager
                            .get_index("bf")) for pkg, n in zip(PKGS, ("jax", "torch"))}
    assert rows["torch"] == rows["jax"]
    assert all(len(r["bloom__uid"]) == 1024 for r in rows["torch"])


def test_bloom_never_false_negative(tmp_path):
    """Every key of the source is found through the bloom filter."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    rng = np.random.default_rng(8)
    for i in range(3):
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 1_000_000, 400), type=pa.int64()),
        }), os.path.join(data, f"part-{i:05d}.parquet"))
    s = _session(hyperspace_tpu_torch, str(tmp_path))
    hyperspace_tpu_torch.Hyperspace(s).create_index(
        s.read.parquet(data),
        hyperspace_tpu_torch.DataSkippingIndexConfig("bfk", ["k"], ["BloomFilter"]))
    s.enable_hyperspace()
    keys = s.read.parquet(data).select("k").collect().column("k").to_pylist()
    for probe in keys[::97]:
        got = (s.read.parquet(data)
               .filter(hyperspace_tpu_torch.col("k") == probe).select("k").collect())
        assert got.num_rows >= 1, probe


def test_string_literal_probe_coerces_like_execution(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    for i in range(3):
        pq.write_table(pa.table({"cat": pa.array([0, 99, i], type=pa.int64())}),
                       os.path.join(data, f"part-{i:05d}.parquet"))
    _both(tmp_path, data, [_ds("c", ["cat"], ["ValueList"])],
          lambda s: s.read.parquet(data).filter(_col(s)("cat") == "1").select("cat"),
          1)


# ---------------------------------------------------------------------------
# IS [NOT] NULL
# ---------------------------------------------------------------------------
def _write_nulls(data):
    """File 0: no nulls; file 1: mixed; file 2: an all-null v."""
    os.makedirs(data)
    for i, v in enumerate(([10, 11, 12], [13, None, 15], [None, None, None])):
        pq.write_table(pa.table({
            "id": pa.array([3 * i, 3 * i + 1, 3 * i + 2], type=pa.int64()),
            "v": pa.array(v, type=pa.int64())}),
            os.path.join(data, f"part-{i:05d}.parquet"))


NULL_CASES = [
    ("is_null", lambda c: c("v").is_null(), 2, [4, 6, 7, 8]),
    ("bare_is_not_null", lambda c: c("v").is_not_null(), None, [0, 1, 2, 3, 5]),
    ("is_not_null_with_range", lambda c: c("v").is_not_null() & (c("v") >= 13),
     1, [3, 5]),
    ("null_and_range_contradiction", lambda c: c("v").is_null() & (c("v") > 5),
     1, []),
    ("or_null_range", lambda c: c("v").is_null() | (c("v") >= 13), None,
     [3, 4, 5, 6, 7, 8]),
    ("or_null_null", lambda c: c("v").is_null() | c("v").is_null(), 2,
     [4, 6, 7, 8]),
]


@pytest.mark.parametrize("case", NULL_CASES, ids=[c[0] for c in NULL_CASES])
def test_nullness_prunes_as_the_jax_package(tmp_path, case):
    _, pred, files, ids = case
    data = str(tmp_path / "nulldata")
    _write_nulls(data)
    out = _both(tmp_path, data, [_ds("nds", ["v"])],
                lambda s: s.read.parquet(data).filter(pred(_col(s))).select("id"))
    kept = out["torch"]["kept"]
    if files is None:
        assert kept is None
    else:
        assert len(kept[2]) == files
    assert [r[0] for r in out["torch"]["on"]] == ids


@pytest.mark.parametrize("case", NULL_CASES, ids=[c[0] for c in NULL_CASES])
def test_is_null_evaluates_as_arrow_does(case):
    """The host evaluation of IS NULL in the port, against the JAX
    package's, on a column with nulls."""
    from hyperspace_tpu.execution.executor import _arrow_eval as jax_eval
    from hyperspace_tpu_torch.execution.executor import _arrow_eval as torch_eval

    t = pa.table({"v": pa.array([10, None, 13, None, 15], type=pa.int64())})
    _, pred, _, _ = case
    assert torch_eval(pred(hyperspace_tpu_torch.col), t).to_pylist() \
        == jax_eval(pred(hyperspace_tpu.col), t).to_pylist()


@pytest.mark.parametrize("pkg", PKGS, ids=_name)
def test_covering_sketch_never_prunes_null_holders(tmp_path, pkg):
    """IS NULL through a covering index's min/max sketch keeps the
    all-null index files: they hold exactly the matching rows."""
    data = str(tmp_path / "cidata")
    os.makedirs(data)
    n = 6000
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array([float(i) if i % 3 else None for i in range(n)]),
    }), os.path.join(data, "p.parquet"))
    s = _session(pkg, str(tmp_path), num_buckets=1)
    s.conf.index_max_rows_per_file = 1000
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(data), pkg.IndexConfig("ci_null", ["v"], ["k"]))
    s.conf.index_max_rows_per_file = 0
    s.enable_hyperspace()
    ds = s.read.parquet(data).filter(pkg.col("v").is_null()).select("k")
    on = sorted(ds.collect().column("k").to_pylist())
    s.disable_hyperspace()
    off = sorted(ds.collect().column("k").to_pylist())
    assert on == off
    assert len(on) == n // 3


# ---------------------------------------------------------------------------
# the covering builds' _sketch.parquet
# ---------------------------------------------------------------------------
def _index_sketches(entry):
    """Per version directory of ``entry``: its _sketch.parquet rows with
    each file named by its bucket and without its mtime, sorted."""
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    out = {}
    for d in sorted({os.path.dirname(f.name) for f in entry.content.file_infos()}):
        rows = pq.read_table(os.path.join(d, "_sketch.parquet")).to_pylist()
        for r in rows:
            r["_ds_file_name"] = bucket_id_of_file(r.pop("_ds_file_name"))
            r.pop("_ds_file_mtime")
        out[os.path.basename(d)] = sorted(rows, key=lambda r: tuple(map(repr, r.values())))
    return out


def test_covering_create_refresh_optimize_write_the_same_sketch(tmp_path):
    rng = np.random.default_rng(21)
    data = str(tmp_path / "data")
    os.makedirs(data)

    def write(i, n):
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 500, n), type=pa.int64()),
            "d": pa.array(rng.random(n)),
            "s": pa.array([f"s{x}" for x in rng.integers(0, 50, n)]),
        }), os.path.join(data, f"part-{i:05d}.parquet"))

    for i in range(3):
        write(i, 700)
    sessions = _sessions(tmp_path, data, [_ci("ci", ["k", "s"], ["d"])])
    steps = {}
    for step in ("create", "refresh", "optimize"):
        if step == "refresh":
            write(3, 300)
        for pkg, s, hs in sessions:
            if pkg is hyperspace_tpu_torch:
                s.conf.device_build_min_rows = 0  # the device route
            if step == "refresh":
                hs.refresh_index("ci", "incremental")
            elif step == "optimize":
                hs.optimize_index("ci", "full")
            entry = s.index_collection_manager.get_index("ci")
            steps.setdefault(step, {})[_name(pkg)] = _index_sketches(entry)
        assert steps[step]["torch"] == steps[step]["jax"], step
    assert set(steps["refresh"]["torch"]) == {"v__=0", "v__=1"}
    assert list(steps["optimize"]["torch"]) == ["v__=2"]
    assert all(r["min__k"] <= r["max__k"]
               for rows in steps["create"]["torch"].values() for r in rows)
