"""The Delta Lake source through the port, held to the JAX package: the 22
cases of tests/test_delta.py (``TestDeltaLog``, ``TestDeltaProvider``,
``TestDeltaSchemaEdges``), each run through both packages over one
table on disk, written once, with the case's own assertions kept; the
comparisons are the index files' sha256 per bucket, the log entries
(``relations[0].file_format``, ``options``, ``deltaVersions``), the
snapshots both ``DeltaLog`` readers replay and the query rows in order
(sorted where the case sorts).  Then what the port adds beside them:
the writers' parity (each package's table read through both, the
actions equal after masking ids, names and timestamps), the fuzzed
predicates of ``tests/test_fuzz_equivalence.py``'s Delta net, the plan
of ``tests/test_plan_stability.py``'s ``q28_delta_point_filter``, one
table through its latest version, an append and an incremental refresh,
time travel served by an older index log version and an overwrite with a
schema change, and the snapshot as the only listing of a lake table.

The log unit cases write with the port's writer; a torn commit and a
torn checkpoint raise each package's own ``CorruptMetadataError``.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings

import hyperspace_tpu
import hyperspace_tpu_torch
from tests.test_delta import _table
from tests.test_fuzz_equivalence import _EXAMPLES, predicates
from tests.utils import canonical_rows

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)


def _name(pkg) -> str:
    return "jax" if pkg is JAX else "torch"


def _mod(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _session(pkg, root: str, **conf):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, _name(pkg)),
                              **kw)
    s.conf.num_buckets = 4
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    else:
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{kind}_min_rows", 0)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _both(tmp_path, **conf) -> dict:
    """name -> (package, session, Hyperspace) over ``tmp_path``."""
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "ix"), **conf)
        out[_name(pkg)] = (pkg, s, pkg.Hyperspace(s))
    return out


def _snapshot_view(snap) -> tuple:
    m = snap.metadata
    return (snap.version,
            [(f.path, f.size, f.modification_time) for f in snap.files],
            (m.schema_string, m.partition_columns, m.configuration, m.id),
            [(t.path, t.deletion_timestamp) for t in snap.tombstones])


def _snapshots_equal(path: str, version=None) -> tuple:
    """Both readers' snapshot of ``path``, which must be equal."""
    views = [_snapshot_view(_mod(pkg, "sources.delta").DeltaLog(path)
                            .snapshot(version)) for pkg in PKGS]
    assert views[0] == views[1]
    return views[1]


def _bucket_digests(entry) -> dict:
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[os.path.basename(f.name)[:12]].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(d) for b, d in out.items()}


def _entry_view(entry) -> tuple:
    rel = entry.relations[0]
    return (rel.file_format, rel.options, rel.root_paths,
            entry.properties.get("deltaVersions"),
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


def _index_scans(plan) -> list:
    return [s.relation for s in plan.leaf_relations()
            if s.relation.index_scan_of]


# ---------------------------------------------------------------------------
# The _delta_log protocol (TestDeltaLog)
# ---------------------------------------------------------------------------
class TestDeltaLog:
    def test_write_read_roundtrip(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        assert write_delta(_table([1, 2, 3]), path) == 0
        version, files, meta, _ = _snapshots_equal(path)
        assert version == 0 and len(files) == 1
        assert all(os.path.isfile(p) for p, _, _ in files)
        assert json.loads(meta[0])["type"] == "struct"

    def test_append_and_time_travel(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2]), path)
        write_delta(_table([3, 4]), path, mode="append")
        assert DeltaLog(path).latest_version() == 1
        assert len(_snapshots_equal(path, 0)[1]) == 1
        assert len(_snapshots_equal(path, 1)[1]) == 2

    def test_truncated_commit_names_the_bad_file(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2]), path)
        write_delta(_table([3, 4]), path, mode="append")
        commit = os.path.join(path, "_delta_log", f"{1:020d}.json")
        with open(commit, "r", encoding="utf-8") as f:
            body = f.read()
        with open(commit, "w", encoding="utf-8") as f:
            f.write(body[:len(body) // 2])
        for pkg in PKGS:
            error = _mod(pkg, "exceptions").CorruptMetadataError
            with pytest.raises(error) as e:
                _mod(pkg, "sources.delta").DeltaLog(path).snapshot()
            assert commit in str(e.value)
        assert len(_snapshots_equal(path, 0)[1]) == 1

    def test_truncated_checkpoint_names_the_bad_file(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2]), path)
        cp = os.path.join(path, "_delta_log", f"{0:020d}.checkpoint.parquet")
        with open(cp, "wb") as f:
            f.write(b"PAR1garbage")
        for pkg in PKGS:
            error = _mod(pkg, "exceptions").CorruptMetadataError
            with pytest.raises(error) as e:
                _mod(pkg, "sources.delta").DeltaLog(path).snapshot()
            assert cp in str(e.value)

    def test_overwrite_removes_old_files(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2]), path)
        old = {p for p, _, _ in _snapshots_equal(path)[1]}
        write_delta(_table([9]), path, mode="overwrite")
        _, files, _, tombstones = _snapshots_equal(path)
        assert {p for p, _, _ in files}.isdisjoint(old)
        assert {p for p, _ in tombstones} == old
        assert all(os.path.isfile(p) for p in old)

    def test_missing_commit_raises(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1]), path)
        write_delta(_table([2]), path, mode="append")
        os.remove(os.path.join(path, "_delta_log", f"{0:020d}.json"))
        for pkg in PKGS:
            with pytest.raises(ValueError, match="missing commits"):
                _mod(pkg, "sources.delta").DeltaLog(path).snapshot()

    def test_concurrent_commit_loses(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1]), path)
        DeltaLog(path).write_commit(1, [{"commitInfo": {"timestamp": 1}}])
        for pkg in PKGS:
            with pytest.raises(FileExistsError):
                _mod(pkg, "sources.delta").DeltaLog(path).write_commit(
                    1, [{"commitInfo": {"timestamp": 2}}])

    def test_checkpoint_replay(self, tmp_path):
        """A checkpoint made by hand and later commits replay alike in
        both readers (the path of tables other writers made)."""
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2]), path)
        write_delta(_table([3]), path, mode="append")
        snap = DeltaLog(path).snapshot()
        rows = [{"metaData": {"schemaString": snap.metadata.schema_string,
                              "partitionColumns": []},
                 "add": None}]
        for f in snap.files:
            rows.append({"metaData": None,
                         "add": {"path": os.path.relpath(f.path, path),
                                 "size": f.size,
                                 "modificationTime": f.modification_time}})
        pq.write_table(pa.Table.from_pylist(rows),
                       os.path.join(path, "_delta_log",
                                    f"{1:020d}.checkpoint.parquet"))
        os.remove(os.path.join(path, "_delta_log", f"{0:020d}.json"))
        os.remove(os.path.join(path, "_delta_log", f"{1:020d}.json"))
        write_delta(_table([4]), path, mode="append")
        version, files, _, _ = _snapshots_equal(path)
        assert version == 2 and len(files) == 3

    def test_version_for_timestamp(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1]), path)
        write_delta(_table([2]), path, mode="append")
        log = DeltaLog(path)
        ts0, ts1 = log._commit_timestamp(0), log._commit_timestamp(1)
        assert ts0 < ts1
        for pkg in PKGS:
            jlog = _mod(pkg, "sources.delta").DeltaLog(path)
            assert jlog.version_for_timestamp(ts0) == 0
            assert jlog.version_for_timestamp(ts1) == 1
            with pytest.raises(ValueError, match="No commit"):
                jlog.version_for_timestamp(ts0 - 1)

    @pytest.mark.parametrize("value", ["1700000000000", "2026-07-29 12:00:00",
                                       "2026-07-29T12:00:00+02:00",
                                       "2026-07-29"])
    def test_timestamp_as_of_accepts_strings(self, value):
        from datetime import datetime, timezone

        got = {_name(pkg): _mod(pkg, "sources.delta.provider")
               ._timestamp_ms(value) for pkg in PKGS}
        assert got["torch"] == got["jax"]
        if value == "2026-07-29 12:00:00":
            assert got["torch"] == int(datetime(
                2026, 7, 29, 12, 0, 0, tzinfo=timezone.utc).timestamp() * 1000)
        for pkg in PKGS:
            with pytest.raises(ValueError, match="timestampAsOf"):
                _mod(pkg, "sources.delta.provider")._timestamp_ms(
                    "not-a-time")


# ---------------------------------------------------------------------------
# The provider through create, query, refresh and time travel
# ---------------------------------------------------------------------------
class TestDeltaProvider:
    def _create(self, envs, path, name="didx", included=("name",)):
        for _, (pkg, s, hs) in envs.items():
            hs.create_index(s.read.delta(path),
                            pkg.IndexConfig(name, ["id"], list(included)))
        return _same_entries(envs, name)

    def test_create_index_records_version_and_history(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2, 3, 4]), path)
        entry = self._create(_both(tmp_path), path)["torch"]
        rel = entry.relations[0]
        assert rel.file_format == "delta"
        assert rel.options["versionAsOf"] == "0"
        assert entry.properties["deltaVersions"] == "2:0"

    def test_query_rewrite_and_answer_parity(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table(list(range(100))), path)
        envs = _both(tmp_path)
        self._create(envs, path)
        got = {}
        for k, (pkg, s, _) in envs.items():
            ds = s.read.delta(path).filter(pkg.col("id") == 42) \
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
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table([1, 2, 3]), path)
        envs = _both(tmp_path)
        self._create(envs, path)
        write_delta(_table([4, 5]), path, mode="append")
        for k, (pkg, s, hs) in envs.items():
            s.enable_hyperspace()
            ds = s.read.delta(path).filter(pkg.col("id") == 4) \
                .select("id", "name")
            assert not _index_scans(ds.optimized_plan()), k
            hs.refresh_index("didx", "incremental")
        entries = _same_entries(envs, "didx")
        assert entries["torch"].properties["deltaVersions"] == "2:0,4:1"
        got = {}
        for k, (pkg, s, _) in envs.items():
            ds = s.read.delta(path).filter(pkg.col("id") == 4) \
                .select("id", "name")
            assert _index_scans(ds.optimized_plan()), k
            got[k] = ds.collect()
        assert got["torch"].num_rows == 1
        assert got["torch"].equals(got["jax"])

    def test_hybrid_scan_on_appended_delta(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table(list(range(50))), path)
        envs = _both(tmp_path)
        self._create(envs, path)
        write_delta(_table([100]), path, mode="append")
        got, used = {}, {}
        for k, (pkg, s, _) in envs.items():
            s.conf.hybrid_scan_enabled = True
            s.enable_hyperspace()
            ds = s.read.delta(path).filter(pkg.col("id") >= 49) \
                .select("id", "name")
            used[k] = len(_index_scans(ds.optimized_plan()))
            got[k] = ds.collect()
            s.disable_hyperspace()
            assert got[k].sort_by("id").equals(ds.collect().sort_by("id")), k
        assert got["torch"].equals(got["jax"])
        assert used["torch"] == used["jax"]
        assert got["torch"].sort_by("id").column("id").to_pylist() \
            == [49, 100]

    def test_time_travel_read_uses_closest_index_version(self, tmp_path):
        """``versionAsOf="0"`` after an append and a refresh is served by
        the index log version built at delta version 0 (the exact case of
        ``closest_index``): the index scan reads that entry's files, and
        the appended rows are not in the answer."""
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(_table(list(range(20))), path)
        envs = _both(tmp_path)
        self._create(envs, path)
        write_delta(_table([100, 101]), path, mode="append")
        got = {}
        for k, (pkg, s, hs) in envs.items():
            hs.refresh_index("didx", "incremental")
            s.conf.hybrid_scan_enabled = True
            s.enable_hyperspace()
            ds = s.read.delta(path, versionAsOf="0") \
                .filter(pkg.col("id") >= 0).select("id", "name")
            scans = _index_scans(ds.optimized_plan())
            old = s.index_collection_manager.get_index("didx", 2)
            assert [sorted(r.file_paths) for r in scans] == [sorted(
                f.name for f in old.content.file_infos())], k
            got[k] = ds.collect()
        assert got["torch"].num_rows == 20
        assert got["torch"].equals(got["jax"])

    def test_deleted_file_needs_lineage_for_hybrid(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
        from hyperspace_tpu_torch.sources.delta.writer import delete_where_file

        path = str(tmp_path / "t")
        write_delta(_table(list(range(30))), path)
        write_delta(_table(list(range(30, 60))), path, mode="append")
        envs = _both(tmp_path, lineage_enabled=True)
        self._create(envs, path)
        delete_where_file(path, DeltaLog(path).snapshot().files[0].path)
        got, used = {}, {}
        for k, (pkg, s, _) in envs.items():
            s.conf.hybrid_scan_enabled = True
            s.enable_hyperspace()
            ds = s.read.delta(path).filter(pkg.col("id") >= 0) \
                .select("id", "name")
            used[k] = len(_index_scans(ds.optimized_plan()))
            got[k] = ds.collect().sort_by("id")
            s.disable_hyperspace()
            assert got[k].equals(ds.collect().sort_by("id")), k
        assert got["torch"].num_rows == 30
        assert got["torch"].equals(got["jax"])
        assert used["torch"] == used["jax"]


# ---------------------------------------------------------------------------
# Schemas of empty, overwritten and widened tables (TestDeltaSchemaEdges)
# ---------------------------------------------------------------------------
def _collect_both(tmp_path, make) -> dict:
    """``make(pkg, session)``'s dataset collected by each package."""
    return {k: make(pkg, s).collect()
            for k, (pkg, s, _) in _both(tmp_path).items()}


class TestDeltaSchemaEdges:
    def test_empty_active_file_set_keeps_schema(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
        from hyperspace_tpu_torch.sources.delta.writer import delete_where_file

        path = str(tmp_path / "t")
        write_delta(_table([1, 2]), path)
        delete_where_file(path, DeltaLog(path).snapshot().files[0].path)
        out = _collect_both(tmp_path, lambda pkg, s: s.read.delta(path)
                            .select("id", "name"))
        assert out["torch"].num_rows == 0
        assert set(out["torch"].schema.names) == {"id", "name"}
        assert out["torch"].schema == out["jax"].schema

    def test_overwrite_commits_schema_change(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(pa.table({"a": pa.array([1], type=pa.int64())}), path)
        write_delta(pa.table({"b": pa.array(["x"]),
                              "c": pa.array([2], type=pa.int64())}),
                    path, mode="overwrite")
        meta = _snapshots_equal(path)[2]
        assert [f["name"] for f in json.loads(meta[0])["fields"]] \
            == ["b", "c"]
        out = _collect_both(tmp_path, lambda pkg, s: s.read.delta(path)
                            .select("b", "c"))
        assert out["torch"].num_rows == 1
        assert out["torch"].equals(out["jax"])

    def test_join_resolves_schema_added_mid_session(self, tmp_path):
        """A column an overwrite adds resolves in a later query of the
        same session, through the pruning pass over a join: lake schemas
        are not cached by the relation's value."""
        from hyperspace_tpu_torch.sources.delta import write_delta

        t1, t2 = str(tmp_path / "t1"), str(tmp_path / "t2")
        write_delta(pa.table({"k": pa.array([1, 2], type=pa.int64()),
                              "a": pa.array([10, 20], type=pa.int64())}), t1)
        write_delta(pa.table({"k": pa.array([1], type=pa.int64()),
                              "v": pa.array([7], type=pa.int64())}), t2)
        envs = _both(tmp_path)
        for _, (_, s, _) in envs.items():
            s.read.delta(t1).select("k", "a").collect()
        write_delta(pa.table({"k": pa.array([1], type=pa.int64()),
                              "a": pa.array([30], type=pa.int64()),
                              "b": pa.array(["x"])}), t1, mode="overwrite")
        out = {k: s.read.delta(t1).join(s.read.delta(t2),
                                        pkg.col("k") == pkg.col("k"))
               .select("b", "v").collect()
               for k, (pkg, s, _) in envs.items()}
        assert out["torch"].to_pydict() == {"b": ["x"], "v": [7]}
        assert out["torch"].equals(out["jax"])

    def test_mixed_schema_pushdown_promotes_nulls(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        write_delta(pa.table({"k": pa.array([1, 2], type=pa.int64())}), path)
        write_delta(pa.table({"k": pa.array([3], type=pa.int64()),
                              "v": pa.array([9], type=pa.int64())}),
                    path, mode="append")
        out = _collect_both(tmp_path, lambda pkg, s: s.read.delta(path)
                            .select("k", "v"))
        assert out["torch"].sort_by("k").to_pydict() == {
            "k": [1, 2, 3], "v": [None, None, 9]}
        assert out["torch"].equals(out["jax"])

    def test_writer_emits_checkpoints(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import write_delta

        path = str(tmp_path / "t")
        for i in range(12):
            write_delta(_table([i]), path, mode="append")
        log_dir = os.path.join(path, "_delta_log")
        assert os.path.isfile(os.path.join(
            log_dir, f"{10:020d}.checkpoint.parquet"))
        with open(os.path.join(log_dir, "_last_checkpoint")) as f:
            assert json.load(f)["version"] == 10
        replayed = _snapshots_equal(path)
        for v in range(10):
            os.remove(os.path.join(log_dir, f"{v:020d}.json"))
        through_checkpoint = _snapshots_equal(path)
        assert through_checkpoint == replayed
        assert through_checkpoint[0] == 11
        assert len(through_checkpoint[1]) == 12
        out = _collect_both(tmp_path, lambda pkg, s: s.read.delta(path)
                            .select("id"))
        assert out["torch"].num_rows == 12
        assert out["torch"].equals(out["jax"])

    def test_checkpoint_carries_remove_tombstones(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
        from hyperspace_tpu_torch.sources.delta.writer import delete_where_file

        path = str(tmp_path / "t")
        for i in range(9):
            write_delta(_table([i]), path, mode="append")
        victim = DeltaLog(path).snapshot().files[0].path
        delete_where_file(path, victim)
        write_delta(_table([99]), path, mode="append")
        log_dir = os.path.join(path, "_delta_log")
        cp = os.path.join(log_dir, f"{10:020d}.checkpoint.parquet")
        removes = [r["remove"] for r in pq.read_table(cp).to_pylist()
                   if r.get("remove")]
        assert [os.path.basename(victim)] == \
            [os.path.basename(r["path"]) for r in removes]
        assert removes[0]["deletionTimestamp"] > 0
        for v in range(10):
            os.remove(os.path.join(log_dir, f"{v:020d}.json"))
        _, files, _, tombstones = _snapshots_equal(path)
        assert victim not in {p for p, _, _ in files}
        assert victim in {p for p, _ in tombstones}


# ---------------------------------------------------------------------------
# The writers' parity
# ---------------------------------------------------------------------------
def _write_sequence(pkg, path: str) -> None:
    """Every commit shape of the writer: a create, appends (one through
    a checkpoint), a file delete, an upsert, a row delete and an
    overwrite that changes the schema."""
    writer = _mod(pkg, "sources.delta.writer")
    log = _mod(pkg, "sources.delta").DeltaLog
    writer.write_delta(_table(list(range(10))), path)
    for i in range(1, 8):
        writer.write_delta(_table(list(range(i * 10, i * 10 + 10))), path,
                           mode="append")
    # The file of ids 20-29 (the snapshot's order is by random name).
    victim = next(f.path for f in log(path).snapshot().files
                  if 20 in pq.read_table(f.path).column("id").to_pylist())
    writer.delete_where_file(path, victim)
    writer.upsert_delta(_table([3, 500], names=["three", "five"]), path, "id")
    writer.delete_rows_delta(path, "id", [41, 42])
    assert writer.delete_rows_delta(path, "id", [999]) == 10
    writer.write_delta(pa.table({"id": pa.array([7], type=pa.int64()),
                                 "w": pa.array([1.5])}), path,
                       mode="overwrite")


def _masked_commits(path: str) -> list:
    """Each commit's actions, with the table id, the data file names
    (numbered in order of first appearance) and every timestamp masked,
    each name's file content by its rows, in a canonical order."""
    names: dict = {}

    def name(p: str) -> str:
        return names.setdefault(p, f"<file{len(names)}>")

    out = []
    log_dir = os.path.join(path, "_delta_log")
    for v in sorted(int(n[:20]) for n in os.listdir(log_dir)
                    if n.endswith(".json")):
        actions = []
        with open(os.path.join(log_dir, f"{v:020d}.json")) as f:
            for line in f:
                action = json.loads(line)
                for kind, body in action.items():
                    body = dict(body)
                    for ts in ("timestamp", "modificationTime",
                               "deletionTimestamp", "createdTime"):
                        if ts in body:
                            body[ts] = "<ts>"
                    if "id" in body:
                        body["id"] = "<id>"
                    if "path" in body:
                        rows = pq.read_table(os.path.join(path, body["path"])) \
                            .to_pylist()
                        body["path"] = name(body["path"])
                        body["rows"] = rows
                    actions.append({kind: body})
        # Within a commit the removes follow the random file names.
        out.append(sorted(actions, key=lambda a: json.dumps(a,
                                                            sort_keys=True)))
    return out


def test_the_writers_write_the_same_table(tmp_path):
    """The same commits through each package's writer: the actions equal
    after masking ids, file names and timestamps (each file's rows
    compared instead), the checkpoints alike, and each table read the
    same through both packages."""
    paths = {}
    for pkg in PKGS:
        paths[_name(pkg)] = str(tmp_path / f"t_{_name(pkg)}")
        _write_sequence(pkg, paths[_name(pkg)])
    commits = {k: _masked_commits(p) for k, p in paths.items()}
    assert len(commits["torch"]) == 12
    assert commits["torch"] == commits["jax"]
    cps = {}
    for k, p in paths.items():
        cp = pq.read_table(os.path.join(p, "_delta_log",
                                        f"{10:020d}.checkpoint.parquet"))
        rows = cp.to_pylist()
        for r in rows:
            for kind in ("add", "remove"):
                if r[kind]:
                    r[kind]["path"] = os.path.basename(r[kind]["path"])[:11]
                    for ts in ("modificationTime", "deletionTimestamp"):
                        if ts in r[kind]:
                            r[kind][ts] = "<ts>"
            if r["metaData"]:
                r["metaData"]["id"] = "<id>"
        # A checkpoint's files follow their random names too.
        cps[k] = (cp.schema, sorted(rows, key=lambda r: json.dumps(
            r, sort_keys=True, default=str)))
    assert cps["torch"] == cps["jax"]
    for k, p in paths.items():
        views = [_snapshot_view(_mod(pkg, "sources.delta").DeltaLog(p)
                                .snapshot(8)) for pkg in PKGS]
        assert views[0] == views[1], k
        out = _collect_both(tmp_path / k, lambda pkg, s: s.read.delta(
            p, versionAsOf="10").filter(pkg.col("id") >= 0)
            .select("id", "name", "other"))
        assert out["torch"].equals(out["jax"]), k
        assert out["torch"].num_rows == 69
    for version in (8, 10, 11):
        reads = [_collect_both(tmp_path / f"{k}{version}",
                               lambda pkg, s: s.read.delta(
                                   p, versionAsOf=str(version)))["torch"]
                 for k, p in paths.items()]
        assert reads[0].sort_by("id").equals(reads[1].sort_by("id"))


# ---------------------------------------------------------------------------
# One table through its versions, both packages
# ---------------------------------------------------------------------------
def test_a_table_through_its_versions_equals_the_jax_package(tmp_path):
    """The latest version, an append and an incremental refresh, reads at
    ``versionAsOf`` and ``timestampAsOf`` served from the older index log
    version, and an overwrite with a schema change and a full refresh:
    the index files, the entries and the rows equal the JAX package's at
    every step."""
    from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta

    path = str(tmp_path / "t")
    rng = np.random.default_rng(17)

    def batch(n: int, start: int) -> pa.Table:
        return pa.table({
            "id": pa.array(rng.integers(0, 200, n), type=pa.int64()),
            "v": pa.array(rng.random(n)),
            "rid": pa.array(np.arange(start, start + n, dtype=np.int64))})

    for i in range(3):
        write_delta(batch(100, i * 100), path, mode="append")
    envs = _both(tmp_path, lineage_enabled=True)
    for _, (pkg, s, hs) in envs.items():
        hs.create_index(s.read.delta(path),
                        pkg.IndexConfig("tv", ["id"], ["v", "rid"]))
    assert _same_entries(envs, "tv")["torch"].properties["deltaVersions"] \
        == "2:2"

    def rows(**options) -> dict:
        out = {}
        for k, (pkg, s, _) in envs.items():
            s.enable_hyperspace()
            ds = s.read.delta(path, **options) \
                .filter((pkg.col("id") >= 20) & (pkg.col("id") < 90)) \
                .select("id", "v", "rid")
            out[k] = (ds.collect(), _index_scans(ds.optimized_plan()))
            s.disable_hyperspace()
        assert out["torch"][0].equals(out["jax"][0])
        assert [r.file_paths for r in out["torch"][1]] and \
            len(out["torch"][1]) == len(out["jax"][1])
        return out["torch"]

    latest, _ = rows()
    write_delta(batch(60, 300), path, mode="append")
    for _, (_, s, hs) in envs.items():
        hs.refresh_index("tv", "incremental")
    entries = _same_entries(envs, "tv")
    assert entries["torch"].properties["deltaVersions"] == "2:2,4:3"
    after, _ = rows()
    assert after.num_rows > latest.num_rows
    ts2 = DeltaLog(path)._commit_timestamp(2)
    for k, (_, s, _) in envs.items():
        s.conf.hybrid_scan_enabled = True
    old_files = sorted(f.name for f in envs["torch"][1]
                       .index_collection_manager.get_index("tv", 2)
                       .content.file_infos())
    for options in ({"versionAsOf": "2"}, {"timestampAsOf": str(ts2)}):
        got, scans = rows(**options)
        assert got.equals(latest), options
        assert [sorted(r.file_paths) for r in scans] == [old_files], options
    write_delta(pa.table({"id": pa.array([5, 50, 60], type=pa.int64()),
                          "v": pa.array([0.5, 0.25, 0.125]),
                          "rid": pa.array([1, 2, 3], type=pa.int64()),
                          "extra": pa.array(["a", "b", "c"])}),
                path, mode="overwrite")
    for _, (_, s, hs) in envs.items():
        s.conf.hybrid_scan_enabled = False
        hs.refresh_index("tv", "full")
    entries = _same_entries(envs, "tv")
    assert entries["torch"].properties["deltaVersions"] == "2:2,4:3,6:4"
    assert "extra" in entries["torch"].relations[0].schema
    got, _ = rows()
    assert got.sort_by("id").column("id").to_pylist() == [50, 60]


def test_a_lake_table_is_listed_by_its_snapshot_only(tmp_path, monkeypatch):
    """A Delta table with a removed file and a checkpoint: the scan, the
    signature, the hybrid rule and the change detector see its snapshot's
    files, never a removed file, the log or a listing of the
    directory."""
    from hyperspace_tpu_torch import Hyperspace, IndexConfig, col
    from hyperspace_tpu_torch.execution import executor
    from hyperspace_tpu_torch.index.signatures import get_provider
    from hyperspace_tpu_torch.lifecycle.change_detector import (
        current_source_files,
    )
    from hyperspace_tpu_torch.plan.nodes import Scan
    from hyperspace_tpu_torch.rules.hybrid import get_hybrid_scan_candidates
    from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
    from hyperspace_tpu_torch.sources.delta.writer import delete_where_file
    from hyperspace_tpu_torch.utils.hashing import fold_md5

    path = str(tmp_path / "t")
    for i in range(9):
        write_delta(_table(list(range(i * 10, i * 10 + 10))), path,
                    mode="append")
    s = _session(TORCH, str(tmp_path / "ix"), lineage_enabled=True,
                 hybrid_scan_enabled=True)
    hs = Hyperspace(s)
    hs.create_index(s.read.delta(path), IndexConfig("ls", ["id"], ["name"]))
    removed = DeltaLog(path).snapshot().files[0].path
    delete_where_file(path, removed)                   # v9
    write_delta(_table([500]), path, mode="append")    # v10, a checkpoint
    assert os.path.isfile(os.path.join(path, "_delta_log",
                                       f"{10:020d}.checkpoint.parquet"))
    live = [(f.path, f.size, f.modification_time)
            for f in DeltaLog(path).snapshot().files]
    assert removed not in {p for p, _, _ in live} and len(live) == 9

    def no_listing(roots, *args, **kwargs):
        raise AssertionError(f"listed {roots}")

    read = []
    real_read = executor.read_table

    def spy(paths, *args, **kwargs):
        read.extend(paths)
        return real_read(paths, *args, **kwargs)

    monkeypatch.setattr(executor, "list_data_files", no_listing)
    monkeypatch.setattr(executor, "read_table", spy)
    monkeypatch.setattr(
        "hyperspace_tpu_torch.sources.default.provider.list_data_files",
        no_listing)
    scan = s.read.delta(path)
    assert scan.collect().num_rows == 81
    assert sorted(read) == sorted(p for p, _, _ in live)
    sig = get_provider("FileBasedSignatureProvider").signature(
        scan.plan, lambda sc: s.source_provider_manager.get_relation(sc)
        .all_files())
    assert sig == fold_md5(f"{size}{mtime}{p}" for p, size, mtime in live)
    entry = s.index_collection_manager.get_index("ls")
    plan = scan.plan
    assert isinstance(plan, Scan)
    (cand,) = get_hybrid_scan_candidates(s, [entry], plan)
    appended, deleted = cand.get_tag("hybridScanFileLists", plan)
    indexed = {f.name for f in entry.source_file_infos()}
    assert [f.name for f in deleted] == [removed]
    assert [f.name for f in appended] == [p for p, _, _ in live
                                          if p not in indexed]
    assert len(appended) == 1
    current = current_source_files(s, entry)
    assert [(f.name, f.size, f.mtime) for f in current] == live
    read.clear()
    s.enable_hyperspace()
    got = scan.filter(col("id") >= 0).select("id", "name").collect()
    assert got.num_rows == 81
    assert removed not in read
    assert not [p for p in read if "_delta_log" in p]


# ---------------------------------------------------------------------------
# tests/test_fuzz_equivalence.py's Delta net and test_plan_stability's q28
# ---------------------------------------------------------------------------
def _port_expr(e):
    """A JAX package expression rebuilt from the port's classes of the
    same names and fields."""
    from hyperspace_tpu_torch.plan import expr as port_expr

    if isinstance(e, (list, tuple)):
        return type(e)(_port_expr(x) for x in e)
    if type(e).__module__ == "hyperspace_tpu.plan.expr":
        out = object.__new__(getattr(port_expr, type(e).__name__))
        out.__dict__.update({k: _port_expr(v) for k, v in vars(e).items()})
        return out
    return e


@pytest.fixture(scope="module")
def delta_catalog(tmp_path_factory):
    """The Delta net's table (three appends of 150 rows from
    ``default_rng(11)``, an index on ``a`` with lineage, then an append
    and a file delete), indexed by both packages, hybrid scan on."""
    from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
    from hyperspace_tpu_torch.sources.delta.writer import delete_where_file

    root = tmp_path_factory.mktemp("torch_fuzz_delta")
    table_path = str(root / "t")
    rng = np.random.default_rng(11)

    def chunk(n, start):
        return pa.table({
            "a": pa.array(rng.integers(0, 100, n), type=pa.int64()),
            "b": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
            "f": pa.array(np.round(rng.uniform(-10, 10, n), 3)),
            "d": pa.array(np.datetime64("1993-01-01")
                          + rng.integers(0, 1461, n)
                          .astype("timedelta64[D]")),
            "rid": pa.array(np.arange(start, start + n, dtype=np.int64)),
        })

    for i in range(3):
        write_delta(chunk(150, i * 150), table_path, mode="append")
    envs = _both(root, lineage_enabled=True, hybrid_scan_enabled=True,
                 hybrid_scan_max_appended_ratio=1.0,
                 hybrid_scan_max_deleted_ratio=1.0)
    for _, (pkg, s, hs) in envs.items():
        hs.create_index(s.read.delta(table_path),
                        pkg.IndexConfig("da", ["a"], ["b", "f", "d", "rid"]))
    write_delta(chunk(100, 450), table_path, mode="append")
    delete_where_file(table_path,
                      DeltaLog(table_path).snapshot().files[0].path)
    return envs, table_path


@settings(max_examples=max(30, _EXAMPLES // 2), deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(pred=predicates())
def test_delta_hybrid_answer_equivalence(delta_catalog, pred):
    """Any fuzzed predicate over the mutated table: the port's indexed
    answer equals its unindexed one and the JAX package's indexed one."""
    envs, table_path = delta_catalog
    got = {}
    for k, (pkg, s, _) in envs.items():
        ds = s.read.delta(table_path) \
            .filter(pred if pkg is JAX else _port_expr(pred)) \
            .select("a", "b", "f", "rid")
        s.enable_hyperspace()
        got[k] = canonical_rows(ds.collect())
        s.disable_hyperspace()
        if pkg is TORCH:
            assert got[k] == canonical_rows(ds.collect()), f"pred={pred!r}"
    assert got["torch"] == got["jax"], f"pred={pred!r}"


def test_q28_delta_point_filter_plan_and_rows(tmp_path):
    """``q28_delta_point_filter`` over a Delta ``dorders`` of 400 rows
    and ``idx_dorders`` in 4 buckets: the plan equals the approved one and
    the JAX package's, and so do the rows."""
    from tests.test_plan_stability import APPROVED_DIR, _simplify

    from hyperspace_tpu_torch.sources.delta import write_delta

    rng = np.random.default_rng(3)
    dorders = str(tmp_path / "dorders")
    write_delta(pa.table({
        "d_key": np.arange(400, dtype=np.int64),
        "d_price": pa.array(rng.uniform(1, 1000, 400), type=pa.float64()),
    }), dorders)
    envs = _both(tmp_path)
    plans, rows = {}, {}
    for k, (pkg, s, hs) in envs.items():
        hs.create_index(s.read.delta(dorders),
                        pkg.IndexConfig("idx_dorders", ["d_key"],
                                        ["d_price"]))
        s.enable_hyperspace()
        ds = s.read.delta(dorders).filter(pkg.col("d_key") == 123) \
            .select("d_key", "d_price")
        plans[k] = _simplify(ds.optimized_plan().tree_string(),
                             {"dorders": dorders})
        rows[k] = ds.collect()
    with open(os.path.join(APPROVED_DIR, "q28_delta_point_filter",
                           "simplified.txt"), encoding="utf-8") as f:
        assert plans["torch"] == f.read()
    assert plans["torch"] == plans["jax"]
    assert rows["torch"].equals(rows["jax"])
    assert rows["torch"].column("d_key").to_pylist() == [123]
