"""The Iceberg source through the port, held to the JAX package: the 23
cases of tests/test_iceberg.py but ``TestAvro`` (which
tests/test_torch_avro.py holds), that is ``TestIcebergTable``,
``TestIcebergProvider``, ``TestIcebergSchemaEdges`` and
``TestIcebergClosestIndex``, each run through both packages over one
table on disk, written once, with the case's own assertions kept; the
comparisons are the index files' sha256 per bucket, the log entries
(``relations[0].file_format``, ``options``, ``icebergSnapshots``), the
metadata and the planned files both ``IcebergTable`` readers give, and
the query rows in order (sorted where the case sorts).  Then what the
port adds beside them: the writers' parity (each package's table read
through both readers, the metadata, manifest lists and manifests equal
after masking ids, names and timestamps), one table through an append,
an incremental refresh, time travel served by an older index log
version and an overwrite with a schema change, and a time travel whose
history names an expired snapshot.

Every comparison is exact: no float aggregate is computed here.  Snapshot
ids, file names and timestamps are random or the wall clock's, so the
two packages' tables are compared only after masking them, and index
bytes only over one table.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.test_iceberg import _table
from tests.test_torch_delta import (
    JAX,
    PKGS,
    TORCH,
    _both,
    _bucket_digests,
    _index_scans,
    _mod,
    _name,
)


def _md_view(md) -> tuple:
    return (md.location, md.table_uuid, md.current_snapshot_id,
            [(s.snapshot_id, s.timestamp_ms, s.manifest_list, s.summary)
             for s in md.snapshots],
            md.schema, md.partition_spec, md.properties, md.last_column_id,
            md.metadata_version)


def _tables(path: str) -> list:
    return [_mod(pkg, "sources.iceberg").IcebergTable(path) for pkg in PKGS]


def _metadata_equal(path: str):
    """Both readers' latest metadata of ``path``, which must be equal;
    the port's."""
    mds = [t.load_metadata() for t in _tables(path)]
    assert _md_view(mds[0]) == _md_view(mds[1])
    return mds[1]


def _planned_equal(path: str, snapshot_id=None) -> list:
    """Both readers' planned files of ``path`` at ``snapshot_id`` (the
    current snapshot by default), which must be equal; the port's."""
    planned = []
    for table in _tables(path):
        md = table.load_metadata()
        snap = md.snapshot_by_id(snapshot_id) if snapshot_id is not None \
            else None
        planned.append(table.plan_files(snap, md))
    assert [[(f.path, f.size, f.record_count) for f in files]
            for files in planned] == [[(f.path, f.size, f.record_count)
                                       for f in planned[1]]] * 2
    return planned[1]


def _entry_view(entry) -> tuple:
    rel = entry.relations[0]
    return (rel.file_format, rel.options, rel.root_paths,
            entry.properties.get("icebergSnapshots"),
            sorted((f.name, f.size, f.mtime, f.id)
                   for f in entry.source_file_infos()))


def _same_entries(envs: dict, name: str) -> dict:
    """Both packages' latest entry of ``name``: equal views and index
    files byte for byte.  Returns package name -> entry."""
    entries = {k: s.index_collection_manager.get_index(name)
               for k, (_, s, _) in envs.items()}
    assert _entry_view(entries["torch"]) == _entry_view(entries["jax"])
    assert _bucket_digests(entries["torch"]) == \
        _bucket_digests(entries["jax"])
    return entries


def _create(envs: dict, path: str, name: str = "iidx") -> dict:
    for _, (pkg, s, hs) in envs.items():
        hs.create_index(s.read.iceberg(path),
                        pkg.IndexConfig(name, ["id"], ["name"]))
    return _same_entries(envs, name)


def _collect_both(tmp_path, make) -> dict:
    """``make(pkg, session)``'s dataset collected by each package."""
    return {k: make(pkg, s).collect()
            for k, (pkg, s, _) in _both(tmp_path).items()}


# ---------------------------------------------------------------------------
# Table metadata (TestIcebergTable)
# ---------------------------------------------------------------------------
class TestIcebergTable:
    def test_write_read_roundtrip(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        snap_id = write_iceberg(_table([1, 2, 3]), path)
        md = _metadata_equal(path)
        assert md.current_snapshot_id == snap_id
        files = _planned_equal(path)
        assert len(files) == 1
        assert all(os.path.isfile(f.path) for f in files)
        assert files[0].record_count == 3
        assert [f["id"] for f in md.schema["fields"]] == [1, 2, 3]

    def test_append_accumulates_files(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        s0 = write_iceberg(_table([1, 2]), path)
        s1 = write_iceberg(_table([3, 4]), path)
        assert len(_metadata_equal(path).snapshots) == 2
        assert len(_planned_equal(path, s0)) == 1
        assert len(_planned_equal(path, s1)) == 2

    def test_truncated_metadata_json_names_the_bad_file(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import (
            IcebergTable,
            write_iceberg,
        )

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2]), path)
        v = IcebergTable(path).latest_metadata_version()
        md_path = os.path.join(path, "metadata", f"v{v}.metadata.json")
        with open(md_path, "r", encoding="utf-8") as f:
            body = f.read()
        with open(md_path, "w", encoding="utf-8") as f:
            f.write(body[:len(body) // 2])
        for pkg, table in zip(PKGS, _tables(path)):
            error = _mod(pkg, "exceptions").CorruptMetadataError
            with pytest.raises(error) as e:
                table.load_metadata()
            assert md_path in str(e.value)

    def test_truncated_manifest_names_the_bad_file(self, tmp_path):
        """A torn manifest list raises each package's diagnostic, naming
        the file and its role."""
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2]), path)
        manifest_list = _metadata_equal(path).current_snapshot().manifest_list
        with open(manifest_list, "rb") as f:
            body = f.read()
        with open(manifest_list, "wb") as f:
            f.write(body[:len(body) // 2])
        messages = []
        for pkg, table in zip(PKGS, _tables(path)):
            error = _mod(pkg, "exceptions").CorruptMetadataError
            with pytest.raises(error) as e:
                table.plan_files()
            assert manifest_list in str(e.value)
            assert "manifest list" in str(e.value)
            messages.append(str(e.value))
        assert messages[0] == messages[1]

    def test_overwrite_replaces_files(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2]), path)
        old = {f.path for f in _planned_equal(path)}
        write_iceberg(_table([9]), path, mode="overwrite")
        new = {f.path for f in _planned_equal(path)}
        assert new.isdisjoint(old)
        assert all(os.path.isfile(p) for p in old)

    def test_delete_file_commit(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import (
            delete_file_iceberg,
            write_iceberg,
        )

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2]), path)
        write_iceberg(_table([3, 4]), path)
        files = _planned_equal(path)
        delete_file_iceberg(path, files[0].path)
        left = _planned_equal(path)
        assert len(left) == 1
        assert left[0].path != files[0].path
        for pkg in PKGS:
            with pytest.raises(FileNotFoundError, match="not a live file"):
                _mod(pkg, "sources.iceberg").delete_file_iceberg(
                    path, files[0].path)

    def test_append_schema_mismatch_raises(self, tmp_path):
        """Both writers refuse an append of another schema with the same
        message; leaving out a column is allowed, and an overwrite
        changes the schema."""
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2]), path)
        bad = pa.table({"id": pa.array([3], type=pa.int64()),
                        "extra": pa.array(["x"])})
        retyped = pa.table({"id": pa.array([3.0], type=pa.float64()),
                            "name": pa.array(["n"]),
                            "other": pa.array([30], type=pa.int64())})
        for data in (bad, retyped):
            messages = []
            for pkg in PKGS:
                with pytest.raises(ValueError, match="does not match") as e:
                    _mod(pkg, "sources.iceberg").write_iceberg(
                        data, path, mode="append")
                messages.append(str(e.value))
            assert messages[0] == messages[1]
        write_iceberg(pa.table({"id": pa.array([9], type=pa.int64())}), path,
                      mode="append")
        assert sorted(r["id"] for r in _collect_both(
            tmp_path, lambda pkg, s: s.read.iceberg(path))["torch"]
            .to_pylist()) == [1, 2, 9]
        write_iceberg(bad, path, mode="overwrite")
        assert len(_planned_equal(path)) == 1

    def test_snapshot_for_timestamp(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        s0 = write_iceberg(_table([1]), path)
        s1 = write_iceberg(_table([2]), path)
        messages = []
        for table in _tables(path):
            md = table.load_metadata()
            t0 = md.snapshot_by_id(s0).timestamp_ms
            assert md.snapshot_for_timestamp(t0).snapshot_id == s0
            t1 = md.snapshot_by_id(s1).timestamp_ms
            assert t1 > t0
            assert md.snapshot_for_timestamp(t1).snapshot_id == s1
            with pytest.raises(ValueError, match="No snapshot") as e:
                md.snapshot_for_timestamp(t0 - 1)
            messages.append(str(e.value))
            with pytest.raises(ValueError, match="not found"):
                md.snapshot_by_id(12345)
        assert messages[0] == messages[1]

    def test_concurrent_metadata_commit_loses(self, tmp_path):
        """Two commits from one metadata version: the first creates the
        next ``v<N>.metadata.json``, the second, from either package's
        writer, gets ``FileExistsError``, and the table reads the
        winner's snapshot."""
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table([1]), path)
        assert os.path.isfile(os.path.join(path, "metadata",
                                           "v1.metadata.json"))

        def commit(pkg, snapshot_id: int) -> int:
            writer = _mod(pkg, "sources.iceberg.writer")
            table = _mod(pkg, "sources.iceberg").IcebergTable(path)
            md = table.load_metadata(1)
            return writer._commit(table, md, [], snapshot_id, 10**13,
                                  md.schema, md.properties, "append",
                                  md.table_uuid)

        assert commit(TORCH, 77) == 2
        for pkg in PKGS:
            with pytest.raises(FileExistsError):
                commit(pkg, 78)
        assert _metadata_equal(path).current_snapshot_id == 77
        with open(os.path.join(path, "metadata", "version-hint.text")) as f:
            assert f.read() == "2"


# ---------------------------------------------------------------------------
# The provider through create, query, refresh and time travel
# ---------------------------------------------------------------------------
class TestIcebergProvider:
    def test_create_index_pins_snapshot(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        snap = write_iceberg(_table([1, 2, 3, 4]), path)
        entry = _create(_both(tmp_path), path)["torch"]
        rel = entry.relations[0]
        assert rel.file_format == "iceberg"
        assert rel.options["snapshot-id"] == str(snap)
        assert rel.options["as-of-timestamp"] == str(
            _metadata_equal(path).snapshot_by_id(snap).timestamp_ms)

    def test_signature_is_snapshot_plus_location(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        snap = write_iceberg(_table([1, 2]), path)
        for k, (pkg, s, _) in _both(tmp_path).items():
            scan = s.read.iceberg(path).plan
            assert isinstance(scan, _mod(pkg, "plan.nodes").Scan), k
            rel = s.source_provider_manager.get_relation(scan)
            assert rel.signature() == f"{snap}{os.path.abspath(path)}", k

    def test_query_rewrite_and_answer_parity(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table(list(range(100))), path)
        envs = _both(tmp_path)
        _create(envs, path)
        got = {}
        for k, (pkg, s, _) in envs.items():
            ds = s.read.iceberg(path).filter(pkg.col("id") == 42) \
                .select("id", "name")
            s.disable_hyperspace()
            expected = ds.collect()
            s.enable_hyperspace()
            assert _index_scans(ds.optimized_plan()), k
            got[k] = ds.collect()
            assert got[k].equals(expected), k
        assert got["torch"].equals(got["jax"])
        assert got["torch"].column("id").to_pylist() == [42]

    def test_stale_after_append_then_refresh(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2, 3]), path)
        envs = _both(tmp_path)
        _create(envs, path)
        write_iceberg(_table([4, 5]), path)
        for k, (pkg, s, hs) in envs.items():
            s.enable_hyperspace()
            ds = s.read.iceberg(path).filter(pkg.col("id") == 4) \
                .select("id", "name")
            assert not _index_scans(ds.optimized_plan()), k
            hs.refresh_index("iidx", "incremental")
        entries = _same_entries(envs, "iidx")
        history = entries["torch"].properties["icebergSnapshots"]
        assert history.startswith("2:") and ",4:" in history
        got = {}
        for k, (pkg, s, _) in envs.items():
            ds = s.read.iceberg(path).filter(pkg.col("id") == 4) \
                .select("id", "name")
            assert _index_scans(ds.optimized_plan()), k
            got[k] = ds.collect()
        assert got["torch"].num_rows == 1
        assert got["torch"].equals(got["jax"])

    def test_time_travel_snapshot_id_read(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        s0 = write_iceberg(_table(list(range(20))), path)
        write_iceberg(_table([100, 101]), path)
        out = _collect_both(tmp_path, lambda pkg, s: s.read.iceberg(
            path, snapshot_id=str(s0)).select("id"))
        assert out["torch"].num_rows == 20
        assert out["torch"].equals(out["jax"])

    def test_time_travel_as_of_timestamp_read(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        s0 = write_iceberg(_table([1, 2]), path)
        t0 = _metadata_equal(path).snapshot_by_id(s0).timestamp_ms
        write_iceberg(_table([3]), path)
        out = _collect_both(tmp_path, lambda pkg, s: s.read.iceberg(
            path, as_of_timestamp=str(t0)).select("id"))
        assert out["torch"].num_rows == 2
        assert out["torch"].equals(out["jax"])

    def test_hybrid_scan_on_appended_iceberg(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table(list(range(50))), path)
        envs = _both(tmp_path)
        _create(envs, path)
        write_iceberg(_table([100]), path)
        got, used = {}, {}
        for k, (pkg, s, _) in envs.items():
            s.conf.hybrid_scan_enabled = True
            s.enable_hyperspace()
            ds = s.read.iceberg(path).filter(pkg.col("id") >= 49) \
                .select("id", "name")
            used[k] = len(_index_scans(ds.optimized_plan()))
            got[k] = ds.collect()
            s.disable_hyperspace()
            assert got[k].sort_by("id").equals(ds.collect().sort_by("id")), k
        assert got["torch"].equals(got["jax"])
        assert used["torch"] == used["jax"]
        assert got["torch"].sort_by("id").column("id").to_pylist() \
            == [49, 100]

    def test_deleted_file_hybrid_scan_with_lineage(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import (
            delete_file_iceberg,
            write_iceberg,
        )

        path = str(tmp_path / "t")
        write_iceberg(_table(list(range(30))), path)
        write_iceberg(_table(list(range(30, 60))), path)
        envs = _both(tmp_path, lineage_enabled=True)
        _create(envs, path)
        delete_file_iceberg(path, _planned_equal(path)[0].path)
        got, used = {}, {}
        for k, (pkg, s, _) in envs.items():
            s.conf.hybrid_scan_enabled = True
            s.enable_hyperspace()
            ds = s.read.iceberg(path).filter(pkg.col("id") >= 0) \
                .select("id", "name")
            used[k] = len(_index_scans(ds.optimized_plan()))
            got[k] = ds.collect().sort_by("id")
            s.disable_hyperspace()
            assert got[k].equals(ds.collect().sort_by("id")), k
        assert got["torch"].num_rows == 30
        assert got["torch"].equals(got["jax"])
        assert used["torch"] == used["jax"]

    def test_refresh_drops_snapshot_pin(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(_table([1]), path)
        for k, (pkg, s, _) in _both(tmp_path).items():
            rel = _mod(pkg, "index.log_entry").Relation(
                root_paths=[path], content=None, schema={},
                file_format="iceberg",
                options={"snapshot-id": "5", "as-of-timestamp": "7",
                         "keep": "me"})
            out = s.source_provider_manager.refresh_relation_metadata(rel)
            assert out.options == {"keep": "me"}, k
            assert s.source_provider_manager.internal_file_format_name(
                rel) == "parquet", k


# ---------------------------------------------------------------------------
# Schemas of empty and overwritten tables (TestIcebergSchemaEdges)
# ---------------------------------------------------------------------------
class TestIcebergSchemaEdges:
    def test_empty_active_file_set_keeps_schema(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import (
            delete_file_iceberg,
            write_iceberg,
        )

        path = str(tmp_path / "t")
        write_iceberg(_table([1, 2]), path)
        delete_file_iceberg(path, _planned_equal(path)[0].path)
        assert _planned_equal(path) == []
        out = _collect_both(tmp_path, lambda pkg, s: s.read.iceberg(path)
                            .select("id", "name"))
        assert out["torch"].num_rows == 0
        assert set(out["torch"].schema.names) == {"id", "name"}
        assert out["torch"].schema == out["jax"].schema

    def test_overwrite_commits_schema_change(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(pa.table({"a": pa.array([1], type=pa.int64())}), path)
        write_iceberg(pa.table({"b": pa.array(["x"]),
                                "c": pa.array([2], type=pa.int64())}),
                      path, mode="overwrite")
        md = _metadata_equal(path)
        assert [f["name"] for f in md.schema["fields"]] == ["b", "c"]
        out = _collect_both(tmp_path, lambda pkg, s: s.read.iceberg(path)
                            .select("b", "c"))
        assert out["torch"].num_rows == 1
        assert out["torch"].equals(out["jax"])

    def test_overwrite_keeps_field_id_history(self, tmp_path):
        """Field ids stay unique across the table's history, through
        either package's writer: a surviving column keeps its id, a new
        one takes a fresh id above ``last-column-id``."""
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        write_iceberg(pa.table({"a": pa.array([1], type=pa.int64())}), path)
        _mod(JAX, "sources.iceberg").write_iceberg(
            pa.table({"b": pa.array(["x"]), "a": pa.array([2], type=pa.int64())}),
            path, mode="overwrite")
        md = _metadata_equal(path)
        assert {f["name"]: f["id"] for f in md.schema["fields"]} \
            == {"b": 2, "a": 1}
        write_iceberg(pa.table({"c": pa.array([1.5])}), path, mode="overwrite")
        md = _metadata_equal(path)
        assert md.schema["fields"][0]["id"] == 3
        assert md.last_column_id == 3


# ---------------------------------------------------------------------------
# Time travel served by older index versions (TestIcebergClosestIndex)
# ---------------------------------------------------------------------------
class TestIcebergClosestIndex:
    def test_snapshot_history_recorded(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        s0 = write_iceberg(_table([1, 2]), path)
        envs = _both(tmp_path)
        entry = _create(envs, path, "ci")["torch"]
        assert entry.properties["icebergSnapshots"] == f"2:{s0}"
        s1 = write_iceberg(_table([3]), path)
        for _, (_, _, hs) in envs.items():
            hs.refresh_index("ci", "incremental")
        entry = _same_entries(envs, "ci")["torch"]
        assert entry.properties["icebergSnapshots"] == f"2:{s0},4:{s1}"

    def test_time_travel_uses_closest_index_version(self, tmp_path):
        """A read of snapshot s0 after an append and a refresh is served
        by the index log version built at s0: the index scan reads that
        entry's files, and the appended rows are not in the answer."""
        from hyperspace_tpu_torch.sources.iceberg import write_iceberg

        path = str(tmp_path / "t")
        s0 = write_iceberg(_table(list(range(20))), path)
        envs = _both(tmp_path)
        _create(envs, path, "ci")
        write_iceberg(_table([100, 101]), path)
        got = {}
        for k, (pkg, s, hs) in envs.items():
            hs.refresh_index("ci", "incremental")
            s.conf.hybrid_scan_enabled = True
            s.enable_hyperspace()
            ds = s.read.iceberg(path, snapshot_id=str(s0)) \
                .filter(pkg.col("id") >= 0).select("id", "name")
            scans = _index_scans(ds.optimized_plan())
            old = s.index_collection_manager.get_index("ci", 2)
            assert [sorted(r.file_paths) for r in scans] == [sorted(
                f.name for f in old.content.file_infos())], k
            got[k] = ds.collect()
        _same_entries(envs, "ci")
        assert got["torch"].num_rows == 20
        assert got["torch"].equals(got["jax"])


# ---------------------------------------------------------------------------
# The writers' parity
# ---------------------------------------------------------------------------
def _write_sequence(pkg, path: str) -> None:
    """Every commit shape of the writer: a create, appends, a file
    delete, an upsert, a row delete, a row delete that matches nothing
    and an overwrite that changes the schema."""
    writer = _mod(pkg, "sources.iceberg.writer")
    table = _mod(pkg, "sources.iceberg").IcebergTable
    writer.write_iceberg(_table(list(range(10))), path)
    for i in range(1, 6):
        writer.write_iceberg(_table(list(range(i * 10, i * 10 + 10))), path)
    # The file of ids 20-29 (the planned order is by random name).
    victim = next(f.path for f in table(path).plan_files()
                  if 20 in pq.read_table(f.path).column("id").to_pylist())
    writer.delete_file_iceberg(path, victim)
    writer.upsert_iceberg(_table([3, 500], names=["three", "five"]), path,
                          "id")
    writer.delete_rows_iceberg(path, "id", [41, 42])
    current = table(path).load_metadata().current_snapshot_id
    assert writer.delete_rows_iceberg(path, "id", [999]) == current
    writer.write_iceberg(pa.table({"id": pa.array([7], type=pa.int64()),
                                   "w": pa.array([1.5])}), path,
                         mode="overwrite")


def _masked_table(path: str) -> list:
    """Each metadata version, its snapshots' manifest lists and their
    manifests (all read by both packages' Avro readers, which must
    agree), with snapshot ids numbered by their place in the history,
    the table uuid, timestamps, locations and lengths masked, and each
    data file named by its rows; entries in a canonical order."""
    from hyperspace_tpu_torch.io import avro as port_avro

    jax_avro = _mod(JAX, "io.avro")

    def read(p: str) -> tuple:
        got = port_avro.read_container_with_metadata(p)
        assert got == jax_avro.read_container_with_metadata(p)
        return got

    md_dir = os.path.join(path, "metadata")
    versions = sorted(int(n[1:-len(".metadata.json")])
                      for n in os.listdir(md_dir)
                      if n.endswith(".metadata.json"))
    with open(os.path.join(md_dir, f"v{versions[-1]}.metadata.json")) as f:
        ids = {s["snapshot-id"]: f"<s{i}>"
               for i, s in enumerate(json.load(f)["snapshots"])}

    def rows(p: str) -> list:
        return pq.read_table(p).to_pylist()

    out = []
    for v in versions:
        with open(os.path.join(md_dir, f"v{v}.metadata.json")) as f:
            doc = json.load(f)
        for k in ("table-uuid", "last-updated-ms", "location"):
            doc[k] = f"<{k}>"
        doc["current-snapshot-id"] = ids[doc["current-snapshot-id"]]
        for snap in doc["snapshots"]:
            lists, list_meta = read(snap["manifest-list"])
            manifests = []
            for mf in lists:
                entries, meta = read(mf["manifest_path"])
                for e in entries:
                    e["snapshot_id"] = ids[e["snapshot_id"]]
                    df = e["data_file"]
                    df["file_path"] = rows(df["file_path"])
                manifests.append((meta["avro.schema"], meta["schema"],
                                  meta["format-version"], sorted(
                                      entries, key=lambda e: json.dumps(
                                          e, sort_keys=True, default=str))))
                mf.update(manifest_path="<path>", manifest_length="<len>",
                          added_snapshot_id=ids[mf["added_snapshot_id"]])
            snap.update({"snapshot-id": ids[snap["snapshot-id"]],
                         "timestamp-ms": "<ts>",
                         "manifest-list": (lists, list_meta["avro.schema"],
                                           manifests)})
        out.append(doc)
    with open(os.path.join(md_dir, "version-hint.text")) as f:
        out.append(f.read())
    return out


def test_the_writers_write_the_same_table(tmp_path):
    """The same commits through each package's writer: the metadata
    versions, manifest lists and manifests equal after masking ids, file
    names and timestamps (each data file compared by its rows), the
    timestamps rising, and each table planned and read the same through
    both packages at every snapshot."""
    paths = {}
    for pkg in PKGS:
        paths[_name(pkg)] = str(tmp_path / f"t_{_name(pkg)}")
        _write_sequence(pkg, paths[_name(pkg)])
    tables = {k: _masked_table(p) for k, p in paths.items()}
    assert len(tables["torch"]) == 11 and tables["torch"][-1] == "10"
    assert tables["torch"] == tables["jax"]
    for k, p in paths.items():
        md = _metadata_equal(p)
        stamps = [s.timestamp_ms for s in md.snapshots]
        assert stamps == sorted(set(stamps)), k
        assert [f["name"] for f in md.schema["fields"]] == ["id", "w"]
        assert md.last_column_id == 4
        for snap in md.snapshots:
            _planned_equal(p, snap.snapshot_id)
        out = _collect_both(tmp_path / k, lambda pkg, s: s.read.iceberg(
            p, snapshot_id=str(md.snapshots[8].snapshot_id))
            .filter(pkg.col("id") >= 0).select("id", "name", "other"))
        assert out["torch"].equals(out["jax"]), k
        assert out["torch"].num_rows == 49
    for i in (6, 8, 9):
        reads = [_collect_both(tmp_path / f"{k}{i}", lambda pkg, s: s.read
                               .iceberg(p, snapshot_id=str(
                                   _metadata_equal(p).snapshots[i]
                                   .snapshot_id)))["torch"]
                 for k, p in paths.items()]
        assert reads[0].sort_by("id").equals(reads[1].sort_by("id"))


# ---------------------------------------------------------------------------
# One table through its snapshots, both packages
# ---------------------------------------------------------------------------
def _batch(rng, n: int, start: int) -> pa.Table:
    return pa.table({
        "id": pa.array(rng.integers(0, 200, n), type=pa.int64()),
        "v": pa.array(rng.random(n)),
        "rid": pa.array(np.arange(start, start + n, dtype=np.int64))})


def _rows(envs: dict, path: str, **options) -> tuple:
    """The range 20 <= id < 90 of ``path`` through each package's index:
    equal rows and as many index scans; the port's."""
    out = {}
    for k, (pkg, s, _) in envs.items():
        s.enable_hyperspace()
        ds = s.read.iceberg(path, **options) \
            .filter((pkg.col("id") >= 20) & (pkg.col("id") < 90)) \
            .select("id", "v", "rid")
        out[k] = (ds.collect(), _index_scans(ds.optimized_plan()))
        s.disable_hyperspace()
    assert out["torch"][0].equals(out["jax"][0])
    assert [r.file_paths for r in out["torch"][1]] and \
        len(out["torch"][1]) == len(out["jax"][1])
    return out["torch"]


def test_a_table_through_its_snapshots_equals_the_jax_package(tmp_path):
    """The current snapshot, an append and an incremental refresh, reads
    at ``snapshot_id`` and ``as_of_timestamp`` served from the older
    index log version, and an overwrite with a schema change and a full
    refresh: the index files, the entries and the rows equal the JAX
    package's at every step."""
    from hyperspace_tpu_torch.sources.iceberg import write_iceberg

    path = str(tmp_path / "t")
    rng = np.random.default_rng(19)
    snaps = [write_iceberg(_batch(rng, 100, i * 100), path) for i in range(3)]
    envs = _both(tmp_path, lineage_enabled=True)
    for _, (pkg, s, hs) in envs.items():
        hs.create_index(s.read.iceberg(path),
                        pkg.IndexConfig("tv", ["id"], ["v", "rid"]))
    assert _same_entries(envs, "tv")["torch"].properties[
        "icebergSnapshots"] == f"2:{snaps[2]}"
    latest, _ = _rows(envs, path)
    snaps.append(write_iceberg(_batch(rng, 60, 300), path))
    for _, (_, _, hs) in envs.items():
        hs.refresh_index("tv", "incremental")
    entries = _same_entries(envs, "tv")
    assert entries["torch"].properties["icebergSnapshots"] \
        == f"2:{snaps[2]},4:{snaps[3]}"
    after, _ = _rows(envs, path)
    assert after.num_rows > latest.num_rows
    ts2 = _metadata_equal(path).snapshot_by_id(snaps[2]).timestamp_ms
    for _, (_, s, _) in envs.items():
        s.conf.hybrid_scan_enabled = True
    old_files = sorted(f.name for f in envs["torch"][1]
                       .index_collection_manager.get_index("tv", 2)
                       .content.file_infos())
    for options in ({"snapshot_id": str(snaps[2])},
                    {"as_of_timestamp": str(ts2)}):
        got, scans = _rows(envs, path, **options)
        assert got.equals(latest), options
        assert [sorted(r.file_paths) for r in scans] == [old_files], options
    write_iceberg(pa.table({"id": pa.array([5, 50, 60], type=pa.int64()),
                            "v": pa.array([0.5, 0.25, 0.125]),
                            "rid": pa.array([1, 2, 3], type=pa.int64()),
                            "extra": pa.array(["a", "b", "c"])}),
                  path, mode="overwrite")
    for _, (_, s, hs) in envs.items():
        s.conf.hybrid_scan_enabled = False
        hs.refresh_index("tv", "full")
    entries = _same_entries(envs, "tv")
    assert entries["torch"].properties["icebergSnapshots"].count(",") == 2
    assert "extra" in entries["torch"].relations[0].schema
    got, _ = _rows(envs, path)
    assert got.sort_by("id").column("id").to_pylist() == [50, 60]


def test_closest_index_skips_an_expired_snapshot(tmp_path):
    """The history's first snapshot expired (dropped from the metadata,
    as an expire-snapshots commit does): a read of the second snapshot
    skips the expired pair and is served by the index log version built
    at the second, in both packages."""
    from hyperspace_tpu_torch.sources.iceberg import write_iceberg

    path = str(tmp_path / "t")
    rng = np.random.default_rng(23)
    s0 = write_iceberg(_batch(rng, 80, 0), path)
    envs = _both(tmp_path, lineage_enabled=True)
    for _, (pkg, s, hs) in envs.items():
        hs.create_index(s.read.iceberg(path),
                        pkg.IndexConfig("ex", ["id"], ["v", "rid"]))
    s1 = write_iceberg(_batch(rng, 40, 80), path)
    for _, (_, _, hs) in envs.items():
        hs.refresh_index("ex", "incremental")
    want, _ = _rows(envs, path)
    write_iceberg(_batch(rng, 40, 120), path)
    md_dir = os.path.join(path, "metadata")
    with open(os.path.join(md_dir, "v3.metadata.json")) as f:
        doc = json.load(f)
    doc["snapshots"] = [s for s in doc["snapshots"] if s["snapshot-id"] != s0]
    with open(os.path.join(md_dir, "v4.metadata.json"), "x") as f:
        json.dump(doc, f)
    with open(os.path.join(md_dir, "version-hint.text"), "w") as f:
        f.write("4")
    assert _same_entries(envs, "ex")["torch"].properties[
        "icebergSnapshots"] == f"2:{s0},4:{s1}"
    for _, (_, s, _) in envs.items():
        s.conf.hybrid_scan_enabled = True
    v4_files = sorted(f.name for f in envs["torch"][1]
                      .index_collection_manager.get_index("ex", 4)
                      .content.file_infos())
    got, scans = _rows(envs, path, snapshot_id=str(s1))
    assert got.equals(want)
    assert [sorted(r.file_paths) for r in scans] == [v4_files]
    for pkg in PKGS:
        with pytest.raises(ValueError, match="not found"):
            _mod(pkg, "sources.iceberg").IcebergTable(path).load_metadata() \
                .snapshot_by_id(s0)
