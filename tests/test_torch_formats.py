"""Source formats through the port, held to the JAX package: the cases of
tests/test_formats.py (the csv, json, orc and avro lifecycle, the text
lifecycle, the text newline split, Avro's incremental refresh and the
unsupported-format rejection), each run through both packages over the
same files (made from a seed with numpy): the index files' sha256 per
bucket, the log entry's ``file_format`` and ``root_paths``, and the
query rows in order.  Then what the formats add beside them: the CSV
``header`` option, ``format(fmt).load``, the schema each format reads,
the spill build over CSV, a sketch over JSON and the scan identity that
keys the device column cache.

``test_profiler_trace_writes_output`` has no counterpart by design: the
port has no ``utils/profiling.py`` (its traces come from
``torch.profiler``)."""

from __future__ import annotations

import hashlib
import json
import os
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.io.avro import write_container

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
SYNC = bytes(range(16))
AVRO_SCHEMA = {"type": "record", "name": "row", "fields": [
    {"name": "id", "type": "long"},
    {"name": "name", "type": "string"},
    {"name": "x", "type": "double"}]}


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


def _rows(n: int, seed: int = 3, start: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.arange(start, start + n, dtype=np.int64)
    rng.shuffle(ids)
    return {"id": ids, "name": [f"n{i}" for i in ids],
            "x": rng.random(n) * 100.0}


def _write_csv(root: str, n: int = 50, files: int = 2) -> None:
    os.makedirs(root)
    cols = _rows(n)
    step = -(-n // files)
    for f in range(files):
        with open(os.path.join(root, f"part-{f}.csv"), "w") as out:
            out.write("id,name,x\n")
            for i in range(f * step, min(n, (f + 1) * step)):
                out.write(f"{cols['id'][i]},{cols['name'][i]},"
                          f"{float(cols['x'][i])!r}\n")


def _write_json(root: str, n: int = 50, files: int = 2) -> None:
    os.makedirs(root)
    cols = _rows(n)
    step = -(-n // files)
    for f in range(files):
        with open(os.path.join(root, f"part-{f}.json"), "w") as out:
            for i in range(f * step, min(n, (f + 1) * step)):
                out.write(json.dumps({"id": int(cols["id"][i]),
                                      "name": cols["name"][i],
                                      "x": float(cols["x"][i])}) + "\n")


def _write_orc(root: str, n: int = 50, files: int = 2) -> None:
    import pyarrow.orc as paorc

    os.makedirs(root)
    t = pa.table(_rows(n))
    step = -(-n // files)
    for f in range(files):
        paorc.write_table(t.slice(f * step, step),
                          os.path.join(root, f"part-{f}.orc"))


def _avro_records(cols: dict, lo: int, hi: int) -> list:
    return [{"id": int(cols["id"][i]), "name": cols["name"][i],
             "x": float(cols["x"][i])} for i in range(lo, hi)]


def _write_avro(root: str, n: int = 50, files: int = 2) -> None:
    os.makedirs(root)
    cols = _rows(n)
    step = -(-n // files)
    for f in range(files):
        write_container(os.path.join(root, f"part-{f}.avro"), AVRO_SCHEMA,
                        _avro_records(cols, f * step, min(n, (f + 1) * step)),
                        sync=SYNC)


WRITERS = {"csv": _write_csv, "json": _write_json, "orc": _write_orc,
           "avro": _write_avro}


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


def _lifecycle(tmp_path, fmt: str, indexed, included, query, want_rows):
    """Per package: create the index over ``data`` read as ``fmt``, the
    query with hyperspace on (through the index) and off, then delete and
    vacuum.  Returns package name -> (entry, rows on, bucket digests)."""
    data = str(tmp_path / "data")
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        hs = pkg.Hyperspace(s)
        df = getattr(s.read, fmt)(data)
        hs.create_index(df, pkg.IndexConfig("fi", indexed, included))
        entry = s.index_collection_manager.get_index("fi")
        assert entry.relations[0].file_format == fmt
        assert all(f.name.endswith(".parquet")
                   for f in entry.content.file_infos())
        s.enable_hyperspace()
        ds = query(pkg, df)
        assert _index_scans(ds.optimized_plan()) == ["fi"]
        got = ds.collect()
        s.disable_hyperspace()
        assert got.equals(ds.collect()), _name(pkg)
        assert got.num_rows == want_rows
        digests = _bucket_digests(entry)
        hs.delete_index("fi")
        hs.vacuum_index("fi")
        assert not os.path.exists(os.path.dirname(
            entry.content.file_infos()[0].name))
        out[_name(pkg)] = (entry, got, digests)
    j, t = out["jax"], out["torch"]
    assert t[2] == j[2]
    assert t[0].relations[0].root_paths == j[0].relations[0].root_paths
    assert t[0].relations[0].file_format == j[0].relations[0].file_format
    assert t[0].derived_dataset.schema == j[0].derived_dataset.schema
    assert t[1].equals(j[1])
    return out


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "avro"])
def test_index_lifecycle_over_format(tmp_path, fmt):
    WRITERS[fmt](str(tmp_path / "data"))
    _lifecycle(tmp_path, fmt, ["id"], ["name"],
               lambda pkg, df: df.filter(pkg.col("id") == 7)
               .select("id", "name"), 1)


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "avro"])
def test_range_query_over_format(tmp_path, fmt):
    """A range through the index, every column read back in the format's
    types (CSV and JSON infer them from the text)."""
    WRITERS[fmt](str(tmp_path / "data"), n=400, files=4)
    out = _lifecycle(
        tmp_path, fmt, ["id"], ["name", "x"],
        lambda pkg, df: df.filter((pkg.col("id") >= 100)
                                  & (pkg.col("id") < 180))
        .select("id", "name", "x").sort("id"), 80)
    got = out["torch"][1]
    assert got.column("id").to_pylist() == list(range(100, 180))
    assert got.schema.field("x").type == pa.float64()


def test_index_lifecycle_over_text(tmp_path):
    root = str(tmp_path / "data")
    os.makedirs(root)
    with open(os.path.join(root, "part-0.txt"), "w") as f:
        for i in range(50):
            f.write(f"line-{i}\n")
    out = _lifecycle(tmp_path, "text", ["value"], [],
                     lambda pkg, df: df.filter(pkg.col("value") == "line-7"),
                     1)
    assert out["torch"][1].column("value").to_pylist() == ["line-7"]


def test_text_splits_newlines_only(tmp_path):
    root = str(tmp_path / "data")
    os.makedirs(root)
    with open(os.path.join(root, "part-0.txt"), "wb") as f:
        f.write("a b\nc\x0bd\r\ne\rlast\n".encode("utf-8"))
    got = {}
    for pkg in PKGS:
        got[_name(pkg)] = _session(pkg, str(tmp_path)).read.text(root).collect()
    assert got["torch"].column("value").to_pylist() == ["a b", "c\x0bd", "e",
                                                       "last"]
    assert got["torch"].equals(got["jax"])


def test_avro_incremental_refresh(tmp_path):
    """An appended Avro file (the same bytes for both packages: one
    ``sync``) is the only file the incremental refresh indexes."""
    root = str(tmp_path / "data")
    _write_avro(root)
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.avro(root), pkg.IndexConfig("ai", ["id"],
                                                            ["name"]))
        out[_name(pkg)] = (s, hs)
    write_container(os.path.join(root, "part-9.avro"), AVRO_SCHEMA,
                    [{"id": 999, "name": "appended", "x": 0.5}], sync=SYNC)
    entries, rows = {}, {}
    for pkg in PKGS:
        s, hs = out[_name(pkg)]
        hs.refresh_index("ai", "incremental")
        s.enable_hyperspace()
        ds = s.read.avro(root).filter(pkg.col("id") == 999) \
            .select("id", "name")
        assert _index_scans(ds.optimized_plan()) == ["ai"]
        rows[_name(pkg)] = ds.collect()
        entries[_name(pkg)] = s.index_collection_manager.get_index("ai")
    assert rows["torch"].column("name").to_pylist() == ["appended"]
    assert rows["torch"].equals(rows["jax"])
    assert _bucket_digests(entries["torch"]) == _bucket_digests(entries["jax"])
    assert [f.name for f in entries["torch"].appended_files()] == \
        [f.name for f in entries["jax"].appended_files()]


def test_unsupported_format_rejected(tmp_path):
    for pkg in PKGS:
        from importlib import import_module

        s = _session(pkg, str(tmp_path))
        s.conf.supported_file_formats = "parquet"
        nodes = import_module(f"{pkg.__name__}.plan.nodes")
        dataset = import_module(f"{pkg.__name__}.dataset")
        exceptions = import_module(f"{pkg.__name__}.exceptions")
        ds = dataset.Dataset(nodes.Scan(nodes.ScanRelation(
            root_paths=(str(tmp_path),), file_format="csv")), s)
        with pytest.raises(exceptions.HyperspaceError):
            pkg.Hyperspace(s).create_index(ds, pkg.IndexConfig("x", ["id"]))


def test_csv_without_a_header_row(tmp_path):
    """``header="false"``: the columns are named f0, f1, ... and the
    first line is a row."""
    root = str(tmp_path / "data")
    os.makedirs(root)
    with open(os.path.join(root, "part-0.csv"), "w") as f:
        for i in range(20):
            f.write(f"{i},v{i}\n")
    got = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        ds = s.read.csv(root, header="false")
        assert s.schema_of(ds.plan) == ["f0", "f1"]
        got[_name(pkg)] = ds.filter(pkg.col("f0") < 3).collect()
    assert got["torch"].num_rows == 3
    assert got["torch"].equals(got["jax"])


@pytest.mark.parametrize("fmt", ["csv", "json", "orc", "avro", "text",
                                 "parquet"])
def test_format_load_and_schema_equal_the_jax_package(tmp_path, fmt):
    root = str(tmp_path / "data")
    if fmt == "text":
        os.makedirs(root)
        with open(os.path.join(root, "a.txt"), "w") as f:
            f.write("x\ny\n")
    elif fmt == "parquet":
        import pyarrow.parquet as pq

        os.makedirs(root)
        pq.write_table(pa.table(_rows(30)), os.path.join(root, "a.parquet"))
    else:
        WRITERS[fmt](root, n=30)
    got = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        ds = s.read.format(fmt).load(root)
        got[_name(pkg)] = (s.schema_map_of(ds.plan), ds.collect())
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1].equals(got["jax"][1])


def test_spill_build_over_csv_equals_the_jax_package(tmp_path):
    """Past one batch a CSV source takes the spill build, whose buckets
    equal the monolithic build's and the JAX package's."""
    _write_csv(str(tmp_path / "data"), n=3000, files=6)
    digests = {}
    for pkg in PKGS:
        for batch in (1 << 20, 500):
            s = _session(pkg, str(tmp_path / f"b{batch}"), num_buckets=4)
            s.conf.device_batch_rows = batch
            hs = pkg.Hyperspace(s)
            hs.create_index(s.read.csv(str(tmp_path / "data")),
                            pkg.IndexConfig("ci", ["id"], ["x", "name"]))
            if pkg is TORCH:
                spilled = "spill_route_s" in s.build_stats_log[-1]
                assert spilled == (batch == 500)
            digests[(_name(pkg), batch)] = _bucket_digests(
                s.index_collection_manager.get_index("ci"))
    first = digests[("jax", 1 << 20)]
    assert len(first) == 4
    assert all(d == first for d in digests.values())


def test_data_skipping_over_json_reads_the_data(tmp_path):
    """A JSON source has no footer: its sketch reads each file, and the
    rule prunes on it as the JAX package's does."""
    _write_json(str(tmp_path / "data"), n=400, files=4)
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        hs = pkg.Hyperspace(s)
        df = s.read.json(str(tmp_path / "data"))
        hs.create_index(df, pkg.DataSkippingIndexConfig("dj", ["x"]))
        s.enable_hyperspace()
        ds = df.filter(pkg.col("x") > 1e9).select("id")
        scans = [r.relation for r in ds.optimized_plan().leaf_relations()
                 if r.relation.data_skipping_of]
        out[_name(pkg)] = (scans[0].data_skipping_stats if scans else None,
                           ds.collect())
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0][1] == 4 and out["torch"][0][0] <= 1
    assert out["torch"][1].num_rows == 0
    assert out["torch"][1].equals(out["jax"][1])


def test_scan_identity_keys_the_format_options_and_partitions(tmp_path):
    """The device column cache keys a scan's columns by its files; the
    same files read in another format, with other options or with
    partition columns give other columns, so they key apart, while a
    plain Parquet scan keeps the files' own fingerprint."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.execution.device_cache import files_fingerprint
    from hyperspace_tpu_torch.execution.executor import Executor

    _write_csv(str(tmp_path / "csv"), n=20, files=1)
    part = tmp_path / "pq" / "k=1"
    part.mkdir(parents=True)
    pq.write_table(pa.table(_rows(20)), str(part / "a.parquet"))
    s = _session(TORCH, str(tmp_path))

    def identity(ds):
        ex = Executor(s)
        return ex._scan_identity(ex._scan(ds.plan))[0]

    csv = str(tmp_path / "csv")
    got = [identity(s.read.csv(csv)), identity(s.read.csv(csv, header="false")),
           identity(s.read.text(csv)), identity(s.read.parquet(str(part))),
           identity(s.read.parquet(str(tmp_path / "pq")))]
    assert len(set(got)) == len(got)
    assert got[3] == files_fingerprint([str(part / "a.parquet")])
