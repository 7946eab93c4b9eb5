"""Row-level CDC through hyperspace_tpu_torch (on the CPU): the
merge-on-read rung of the policy, the merge debt measured on an index
entry, ``OptimizeSummary`` and the autonomous compaction rung.

The cases of tests/test_cdc.py, each held to what it asserts, on the
port alone (the policy rung against the JAX package's too), on the
default store (``EmulatedObjectStore``); the case the JAX file
parametrizes by store runs on ``PosixLogStore`` too
(``TestPosixStore``).  Its merge-on-read cases run over a Parquet
source, whose deletes and in-place rewrites reach the index as the lake
commits do, and over a Delta table (``TestDeltaMergeOnRead``,
``TestDeltaMutatedFileDetection``: the ``delta`` cases of
``TestMergeOnRead``, its tight budget, the Delta half of the no-op row
delete with both packages' writers, and the in-place rewrite in the
log) and over an Iceberg table (``TestIcebergMergeOnRead``,
``TestIcebergMutatedFileDetection``: the ``iceberg`` cases of
``TestMergeOnRead``, the Iceberg half of the no-op row delete with both
packages' writers, and the in-place rewrite seen through the file's
mtime).  The doctor's merge-debt check (``TestDoctorMergeDebt``) waits
for ROADMAP.md Queue A item 9.  The watch seam's cases are in
tests/test_torch_watch.py.  Every comparison is exact.
"""

from __future__ import annotations

import glob
import importlib
import os
import signal
import subprocess
import sys

import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
from hyperspace_tpu_torch.actions.optimize import OptimizeSummary
from hyperspace_tpu_torch.lifecycle import cdc, policy
from hyperspace_tpu_torch.lifecycle.change_detector import (
    ChangeSummary,
    detect_changes,
)
from tests.test_cdc import _table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _session(tmp_path, **conf):
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    s.conf.num_buckets = 4
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _change(**kw) -> ChangeSummary:
    base = dict(index="i", appended=0, deleted=0, mutated=0,
                appended_bytes=0, recorded_files=10,
                recorded_bytes=1000, hybrid_debt_bytes=0)
    base.update(kw)
    return ChangeSummary(**base)


# ---------------------------------------------------------------------------
# The CDC policy rung (pure), each case also through the JAX package
# ---------------------------------------------------------------------------
class TestPolicyCDC:
    def _decide(self, change, **kw):
        kw.setdefault("quarantined", 0)
        kw.setdefault("lineage", True)
        kw.setdefault("hybrid_scan", True)
        kw.setdefault("quick_append_ratio", 0.1)
        kw.setdefault("full_churn_ratio", 0.5)
        kw.setdefault("cdc_merge_on_read", True)
        kw.setdefault("merge_debt_ratio", 0.2)
        got = policy.decide_refresh(change, **kw)
        jcd = importlib.import_module(
            "hyperspace_tpu.lifecycle.change_detector")
        jpol = importlib.import_module("hyperspace_tpu.lifecycle.policy")
        want = jpol.decide_refresh(
            jcd.ChangeSummary(**{k: getattr(change, k) for k in
                                 change.__dataclass_fields__}), **kw)
        assert got.to_dict() == want.to_dict()
        return got

    def test_deletes_ride_quick_as_merge_debt(self):
        d = self._decide(_change(deleted=1, deleted_bytes=50))
        assert (d.kind, d.mode) == ("refresh", "quick")
        assert "CDC merge-on-read" in d.reason

    def test_mutations_ride_quick_too(self):
        d = self._decide(_change(appended=1, deleted=1, mutated=1,
                                 appended_bytes=50, deleted_bytes=50))
        assert (d.kind, d.mode) == ("refresh", "quick")

    def test_debt_past_budget_escalates_to_incremental(self):
        d = self._decide(_change(deleted=1, deleted_bytes=50,
                                 merge_debt_bytes=400))
        assert (d.kind, d.mode) == ("refresh", "incremental")
        assert "merge debt ratio" in d.reason

    def test_accumulated_debt_alone_schedules_the_refresh(self):
        d = self._decide(_change(merge_debt_bytes=500))
        assert (d.kind, d.mode) == ("refresh", "incremental")
        assert "accumulated merge debt" in d.reason

    def test_no_lineage_still_full(self):
        d = self._decide(_change(deleted=1), lineage=False)
        assert (d.kind, d.mode) == ("refresh", "full")

    def test_hybrid_off_still_incremental(self):
        d = self._decide(_change(deleted=1), hybrid_scan=False)
        assert (d.kind, d.mode) == ("refresh", "incremental")

    def test_cdc_off_preserves_the_ladder(self):
        d = self._decide(_change(deleted=1), cdc_merge_on_read=False)
        assert (d.kind, d.mode) == ("refresh", "incremental")

    def test_compaction_decision_thresholds(self):
        stats = cdc.CompactionStats(index="i", total_files=10,
                                    small_files=6, mergeable_files=5,
                                    mergeable_buckets=2)
        assert cdc.decide_compaction(stats, min_small_files=6) is None
        assert cdc.decide_compaction(stats, min_small_files=0) is None
        d = cdc.decide_compaction(stats, min_small_files=4, mode="quick")
        assert d is not None and d.kind == policy.KIND_OPTIMIZE
        assert d.mode == "quick" and "small index file" in d.reason


# ---------------------------------------------------------------------------
# Merge-on-read over a Parquet source
# ---------------------------------------------------------------------------
def _parquet_env(tmp_path, files: int = 20, **conf):
    """``files`` Parquet files of 10 ids each, so one rewritten file is a
    low churn and the CDC rung decides."""
    src = str(tmp_path / "t")
    os.makedirs(src)
    for i in range(files):
        pq.write_table(_table(range(i * 10, (i + 1) * 10)),
                       os.path.join(src, f"part-{i:05d}.parquet"))
    s = _session(tmp_path, lineage_enabled=True, hybrid_scan_enabled=True,
                 lifecycle_cdc_enabled=True, **conf)
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(src), IndexConfig("cdx", ["id"], ["name"]))
    s.enable_hyperspace()
    return s, hs, src


def _canonical(t: pa.Table) -> list:
    return sorted(zip(t.column("id").to_pylist(),
                      t.column("name").to_pylist()))


def _upsert(src: str, file_no: int, key: int, tag: int) -> None:
    """Rewrite one file in place with ``key``'s row given a new payload,
    as an upsert's file rewrite does (a new size: the rewrite drops the
    file's last row)."""
    path = os.path.join(src, f"part-{file_no:05d}.parquet")
    ids = [i for i in pq.read_table(path).column("id").to_pylist()][:-1]
    table = _table(ids)
    names = [f"n{i}-{tag}" if i == key else n
             for i, n in zip(ids, table.column("name").to_pylist())]
    pq.write_table(table.set_column(1, "name", pa.array(names)), path)


class TestMergeOnRead:
    def test_upsert_stream_rides_quick_bit_equal(self, tmp_path):
        """A stream of rewrites and deletes: each cycle journals the CDC
        quick refresh, and every answer through the overlay equals the
        source scan's.  40 files, so the overlay's deleted share stays
        under ``hybrid_scan_max_deleted_ratio`` and the index answers."""
        s, hs, src = _parquet_env(tmp_path, files=40,
                                  lifecycle_cdc_merge_debt_ratio=5.0)
        for i in range(3):
            _upsert(src, file_no=i, key=5 + i * 10, tag=i + 1)
            os.remove(os.path.join(src, f"part-{10 + i:05d}.parquet"))
            recs = hs.maintenance_cycle()
            quick = [r for r in recs if r["decision"] == "refresh"
                     and r["mode"] == "quick" and r["outcome"] == "done"]
            assert quick, recs
            assert "CDC merge-on-read" in quick[0]["reason"]
            ds = s.read.parquet(src).filter(col("id") >= 0) \
                .select("id", "name")
            assert "cdx" in {leaf.relation.index_scan_of for leaf in
                             ds.optimized_plan().leaf_relations()}
            got = ds.collect()
            s.disable_hyperspace()
            try:
                want = (s.read.parquet(src).filter(col("id") >= 0)
                        .select("id", "name").collect())
            finally:
                s.enable_hyperspace()
            assert _canonical(got) == _canonical(want)
            rows = dict(_canonical(got))
            assert rows[5 + i * 10] == f"n{5 + i * 10}-{i + 1}"
            assert 100 + i * 10 not in rows  # the deleted file's first id

    def test_merge_debt_is_measured_on_the_entry(self, tmp_path):
        s, hs, src = _parquet_env(tmp_path,
                                  lifecycle_cdc_merge_debt_ratio=5.0)
        _upsert(src, file_no=0, key=3, tag=9)
        hs.maintenance_cycle()
        entry = s.index_collection_manager.get_index("cdx")
        debt = cdc.merge_debt(entry)
        assert debt.deleted_files >= 1 and debt.appended_files >= 1
        assert debt.total_bytes > 0 and debt.ratio > 0
        assert debt.readable
        assert debt.to_dict()["index"] == "cdx"

    def test_tight_budget_escalates_to_incremental(self, tmp_path):
        s, hs, src = _parquet_env(tmp_path,
                                  lifecycle_cdc_merge_debt_ratio=0.0001)
        _upsert(src, file_no=0, key=3, tag=9)
        recs = hs.maintenance_cycle()
        inc = [r for r in recs if r["decision"] == "refresh"
               and r["mode"] == "incremental" and r["outcome"] == "done"]
        assert inc, recs
        entry = s.index_collection_manager.get_index("cdx")
        assert cdc.merge_debt(entry).total_bytes == 0

    def test_inplace_rewrite_reads_as_mutated(self, tmp_path):
        s, hs, src = _parquet_env(tmp_path)
        entry = s.index_collection_manager.get_index("cdx")
        _upsert(src, file_no=4, key=41, tag=2)
        change = detect_changes(s, entry)
        assert change.mutated == 1
        assert change.appended == 1 and change.deleted == 1
        assert change.deleted_bytes > 0


# ---------------------------------------------------------------------------
# Merge-on-read over a Delta source (tests/test_cdc.py's delta cases)
# ---------------------------------------------------------------------------
def _delta_env(tmp_path, **conf):
    """A Delta table of 20 commits of 10 ids each, so one rewritten file
    is a low churn and the CDC rung decides, and its index ``cdx``."""
    from hyperspace_tpu_torch.sources.delta import write_delta

    path = str(tmp_path / "t")
    for i in range(20):
        write_delta(_table(range(i * 10, (i + 1) * 10)), path, mode="append")
    s = _session(tmp_path, lineage_enabled=True, hybrid_scan_enabled=True,
                 lifecycle_cdc_enabled=True, **conf)
    hs = Hyperspace(s)
    hs.create_index(s.read.delta(path), IndexConfig("cdx", ["id"], ["name"]))
    s.enable_hyperspace()
    return s, hs, path


class TestDeltaMergeOnRead:
    def test_upsert_stream_rides_quick_bit_equal(self, tmp_path):
        """Upserts and row deletes through the Delta log: each cycle
        journals the CDC quick refresh, and every answer equals the
        source scan's, the upserted key with its new payload and the
        deleted key gone."""
        from hyperspace_tpu_torch.sources.delta.writer import (
            delete_rows_delta,
            upsert_delta,
        )

        s, hs, path = _delta_env(tmp_path, lifecycle_cdc_merge_debt_ratio=5.0)
        for i in range(3):
            upsert_delta(_table([5 + i, 200 + i], tag=i + 1), path, "id")
            delete_rows_delta(path, "id", [17 + i])
            recs = hs.maintenance_cycle()
            quick = [r for r in recs if r["decision"] == "refresh"
                     and r["mode"] == "quick" and r["outcome"] == "done"]
            assert quick, recs
            assert "CDC merge-on-read" in quick[0]["reason"]
            got = (s.read.delta(path).filter(col("id") >= 0)
                   .select("id", "name").collect())
            s.disable_hyperspace()
            try:
                want = (s.read.delta(path).filter(col("id") >= 0)
                        .select("id", "name").collect())
            finally:
                s.enable_hyperspace()
            assert _canonical(got) == _canonical(want)
            rows = dict(_canonical(got))
            assert rows[5 + i] == f"n{5 + i}-{i + 1}"
            assert 17 + i not in rows

    def test_merge_debt_is_measured_on_the_entry(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta.writer import upsert_delta

        s, hs, path = _delta_env(tmp_path, lifecycle_cdc_merge_debt_ratio=5.0)
        upsert_delta(_table([3, 300], tag=9), path, "id")
        hs.maintenance_cycle()
        entry = s.index_collection_manager.get_index("cdx")
        debt = cdc.merge_debt(entry)
        assert debt.deleted_files >= 1 and debt.appended_files >= 1
        assert debt.total_bytes > 0 and debt.ratio > 0
        assert debt.readable
        assert debt.to_dict()["index"] == "cdx"

    def test_tight_budget_escalates_to_incremental(self, tmp_path):
        from hyperspace_tpu_torch.sources.delta.writer import upsert_delta

        s, hs, path = _delta_env(tmp_path,
                                 lifecycle_cdc_merge_debt_ratio=0.0001)
        upsert_delta(_table([3, 300], tag=9), path, "id")
        recs = hs.maintenance_cycle()
        inc = [r for r in recs if r["decision"] == "refresh"
               and r["mode"] == "incremental" and r["outcome"] == "done"]
        assert inc, recs
        entry = s.index_collection_manager.get_index("cdx")
        assert cdc.merge_debt(entry).total_bytes == 0
        # The refresh indexed the latest version: its pin moved on.
        assert entry.relations[0].options["versionAsOf"] == "20"
        assert entry.properties["deltaVersions"].endswith(":20")

    def test_delete_rows_noop_when_nothing_matches(self, tmp_path):
        """No matching row: no commit, the current version back, from
        both packages' writers over one table."""
        from hyperspace_tpu_torch.sources.delta import DeltaLog, write_delta
        from hyperspace_tpu_torch.sources.delta.writer import delete_rows_delta

        path = str(tmp_path / "t")
        write_delta(_table(range(10)), path)
        v = DeltaLog(path).latest_version()
        assert delete_rows_delta(path, "id", [999]) == v
        jwriter = importlib.import_module(
            "hyperspace_tpu.sources.delta.writer")
        assert jwriter.delete_rows_delta(path, "id", [999]) == v
        assert DeltaLog(path).commit_versions() == [0]


class TestDeltaMutatedFileDetection:
    def test_delta_inplace_rewrite_reads_as_mutated(self, tmp_path):
        """A commit adding again the same path with another size and
        mtime (what an in-place rewrite leaves in the log) reads as
        mutated, not as an unrelated append."""
        import time

        from hyperspace_tpu_torch.sources.delta import DeltaLog

        s, hs, path = _delta_env(tmp_path)
        log = DeltaLog(path)
        victim = log.snapshot().files[0]
        rel = victim.path[len(log.table_path.rstrip("/")) + 1:]
        bigger = pa.concat_tables([pq.read_table(victim.path)] * 2)
        pq.write_table(bigger, victim.path)
        now_ms = int(time.time() * 1000)
        log.write_commit(log.latest_version() + 1, [
            {"remove": {"path": rel, "deletionTimestamp": now_ms,
                        "dataChange": True}},
            {"add": {"path": rel, "partitionValues": {},
                     "size": os.stat(victim.path).st_size,
                     "modificationTime": victim.modification_time + 1,
                     "dataChange": True}},
            {"commitInfo": {"timestamp": now_ms, "operation": "WRITE"}},
        ])
        entry = s.index_collection_manager.get_index("cdx")
        change = detect_changes(s, entry)
        assert change.mutated == 1
        assert change.appended == 1 and change.deleted == 1
        assert change.deleted_bytes > 0


# ---------------------------------------------------------------------------
# Merge-on-read over an Iceberg source (tests/test_cdc.py's iceberg cases)
# ---------------------------------------------------------------------------
def _iceberg_env(tmp_path, **conf):
    """An Iceberg table of 20 snapshots of 10 ids each, so one rewritten
    file is a low churn and the CDC rung decides, and its index
    ``cdx``."""
    from hyperspace_tpu_torch.sources.iceberg import write_iceberg

    path = str(tmp_path / "t")
    for i in range(20):
        write_iceberg(_table(range(i * 10, (i + 1) * 10)), path)
    s = _session(tmp_path, lineage_enabled=True, hybrid_scan_enabled=True,
                 lifecycle_cdc_enabled=True, **conf)
    hs = Hyperspace(s)
    hs.create_index(s.read.iceberg(path), IndexConfig("cdx", ["id"], ["name"]))
    s.enable_hyperspace()
    return s, hs, path


class TestIcebergMergeOnRead:
    def test_upsert_stream_rides_quick_bit_equal(self, tmp_path):
        """Upserts and row deletes as copy-on-write snapshots: each cycle
        journals the CDC quick refresh, and every answer equals the
        source scan's, the upserted key with its new payload and the
        deleted key gone."""
        from hyperspace_tpu_torch.sources.iceberg.writer import (
            delete_rows_iceberg,
            upsert_iceberg,
        )

        s, hs, path = _iceberg_env(tmp_path,
                                   lifecycle_cdc_merge_debt_ratio=5.0)
        for i in range(3):
            upsert_iceberg(_table([5 + i, 200 + i], tag=i + 1), path, "id")
            delete_rows_iceberg(path, "id", [17 + i])
            recs = hs.maintenance_cycle()
            quick = [r for r in recs if r["decision"] == "refresh"
                     and r["mode"] == "quick" and r["outcome"] == "done"]
            assert quick, recs
            assert "CDC merge-on-read" in quick[0]["reason"]
            got = (s.read.iceberg(path).filter(col("id") >= 0)
                   .select("id", "name").collect())
            s.disable_hyperspace()
            try:
                want = (s.read.iceberg(path).filter(col("id") >= 0)
                        .select("id", "name").collect())
            finally:
                s.enable_hyperspace()
            assert _canonical(got) == _canonical(want)
            rows = dict(_canonical(got))
            assert rows[5 + i] == f"n{5 + i}-{i + 1}"
            assert 17 + i not in rows

    def test_merge_debt_is_measured_on_the_entry(self, tmp_path):
        from hyperspace_tpu_torch.sources.iceberg.writer import upsert_iceberg

        s, hs, path = _iceberg_env(tmp_path,
                                   lifecycle_cdc_merge_debt_ratio=5.0)
        upsert_iceberg(_table([3, 300], tag=9), path, "id")
        hs.maintenance_cycle()
        entry = s.index_collection_manager.get_index("cdx")
        debt = cdc.merge_debt(entry)
        assert debt.deleted_files >= 1 and debt.appended_files >= 1
        assert debt.total_bytes > 0 and debt.ratio > 0
        assert debt.readable
        assert debt.to_dict()["index"] == "cdx"

    def test_delete_rows_noop_when_nothing_matches(self, tmp_path):
        """No matching row: no commit, the current snapshot id back, from
        both packages' writers over one table."""
        from hyperspace_tpu_torch.sources.iceberg import (
            IcebergTable,
            write_iceberg,
        )
        from hyperspace_tpu_torch.sources.iceberg.writer import (
            delete_rows_iceberg,
        )

        path = str(tmp_path / "t2")
        write_iceberg(_table(range(10)), path)
        snap = IcebergTable(path).load_metadata().current_snapshot_id
        assert delete_rows_iceberg(path, "id", [999]) == snap
        jwriter = importlib.import_module(
            "hyperspace_tpu.sources.iceberg.writer")
        assert jwriter.delete_rows_iceberg(path, "id", [999]) == snap
        assert IcebergTable(path).metadata_versions() == [1]


class TestIcebergMutatedFileDetection:
    def test_iceberg_inplace_rewrite_reads_as_mutated(self, tmp_path):
        """A file's size comes from the manifest and its mtime from the
        file: a rewrite in place, with no new snapshot, reads as
        mutated."""
        import time

        s, hs, path = _iceberg_env(tmp_path)
        entry = s.index_collection_manager.get_index("cdx")
        victim = entry.source_file_infos()[0]
        time.sleep(0.02)  # mtimes are in ms: make the rewrite's differ
        pq.write_table(pq.read_table(victim.name), victim.name)
        change = detect_changes(s, entry)
        assert change.mutated == 1
        assert change.appended == 1 and change.deleted == 1


# ---------------------------------------------------------------------------
# OptimizeSummary and autonomous compaction
# ---------------------------------------------------------------------------
def _shred_index(tmp_path, rounds: int = 3, store: str = ""):
    """An initial build and ``rounds`` incremental refreshes, each landing
    one small file per touched bucket; ``store`` pins a class of
    io/log_store.py, "" keeps the default."""
    src = str(tmp_path / "src")
    os.makedirs(src, exist_ok=True)
    pq.write_table(_table(range(200)), os.path.join(src, "p0.parquet"))
    s = _session(tmp_path, lineage_enabled=True)
    if store:
        s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
    s.conf.num_buckets = 2
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(src), IndexConfig("cix", ["id"], ["v"]))
    for i in range(rounds):
        pq.write_table(_table(range(1000 + i * 100, 1000 + i * 100 + 50)),
                       os.path.join(src, f"p{i + 1}.parquet"))
        hs.refresh_index("cix", "incremental")
    return s, hs, src


class TestOptimizeSummary:
    def test_optimize_returns_counts_and_version(self, tmp_path):
        s, hs, src = _shred_index(tmp_path)
        entry = s.index_collection_manager.get_index("cix")
        stats = cdc.compaction_stats(entry,
                                     s.conf.optimize_file_size_threshold)
        assert stats.mergeable_files >= 2 and stats.mergeable_buckets >= 1
        summary = hs.optimize_index("cix")
        assert isinstance(summary, OptimizeSummary)
        assert summary.outcome == "ok" and summary.mode == "quick"
        assert summary.compacted_files == stats.mergeable_files
        assert summary.compacted_buckets == stats.mergeable_buckets
        assert 0 < summary.written_files < summary.compacted_files
        assert summary.version is not None
        assert summary.to_dict()["index"] == "cix"
        again = hs.optimize_index("cix")
        assert again.outcome == "noop" and again.version is None
        assert again.compacted_files == 0

    def test_compaction_stats_skip_non_covering(self, tmp_path):
        s, hs, src = _shred_index(tmp_path, rounds=0)
        entry = s.index_collection_manager.get_index("cix")
        big = cdc.compaction_stats(entry, size_threshold=1)
        assert big.small_files == 0 and big.mergeable_files == 0

    def test_compaction_stats_equal_jax(self, tmp_path):
        """The JAX package's ``compaction_stats`` over the port's entry
        (read back through the JAX log manager) counts the same."""
        s, hs, src = _shred_index(tmp_path)
        jlog = importlib.import_module("hyperspace_tpu.index.log_manager")
        jcdc = importlib.import_module("hyperspace_tpu.lifecycle.cdc")
        path = s.index_collection_manager.index_path("cix")
        jentry = jlog.IndexLogManager(path).get_latest_stable_log()
        entry = s.index_collection_manager.get_index("cix")
        for threshold in (1, 10_000, s.conf.optimize_file_size_threshold):
            assert cdc.compaction_stats(entry, threshold).to_dict() == \
                jcdc.compaction_stats(jentry, threshold).to_dict()
        assert cdc.merge_debt(entry).to_dict() == \
            jcdc.merge_debt(jentry).to_dict()


class TestAutonomousCompaction:
    def test_daemon_journals_the_optimize(self, tmp_path):
        s, hs, src = _shred_index(tmp_path)
        s.conf.lifecycle_compaction_enabled = True
        s.conf.lifecycle_compaction_min_small_files = 2
        s.enable_hyperspace()
        recs = hs.maintenance_cycle()
        opt = [r for r in recs if r["decision"] == "optimize"]
        assert opt and opt[0]["outcome"] == "done", recs
        assert "small index file" in opt[0]["reason"]
        assert opt[0]["mode"] == "quick"
        recs = hs.maintenance_cycle()
        assert all(r["decision"] != "optimize" or r["outcome"] == "noop"
                   for r in recs), recs
        got = (s.read.parquet(src).filter(col("id") >= 0)
               .select("id", "v").collect())
        want = pq.read_table(sorted(glob.glob(os.path.join(src, "*.parquet"))),
                             columns=["id", "v"])
        assert sorted(zip(got.column("id").to_pylist(),
                          got.column("v").to_pylist())) == \
            sorted(zip(want.column("id").to_pylist(),
                       want.column("v").to_pylist()))

    def test_compaction_never_masks_a_refresh(self, tmp_path):
        s, hs, src = _shred_index(tmp_path)
        s.conf.lifecycle_compaction_enabled = True
        s.conf.lifecycle_compaction_min_small_files = 2
        pq.write_table(_table(range(5000, 5050)),
                       os.path.join(src, "late.parquet"))
        recs = hs.maintenance_cycle()
        assert any(r["decision"] == "refresh" and r["outcome"] == "done"
                   for r in recs), recs
        assert all(r["decision"] != "optimize" for r in recs), recs

    def test_sigkill_mid_compaction_converges(self, tmp_path):
        """A SIGKILL in a port process after the optimize's first bucket
        file is written, before its commit: the stable entry still
        serves, the transient OPTIMIZING entry is left, and the next
        cycle rolls it back and lands the compaction."""
        store = getattr(self, "store", "")
        s, hs, src = _shred_index(tmp_path, store=store)
        child = f"""
import os, signal
import hyperspace_tpu_torch.actions.optimize as opt
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession

s = HyperspaceSession({str(tmp_path / 'ix')!r}, device="cpu")
if {store!r}:
    s.conf.log_store_class = "hyperspace_tpu_torch.io.log_store." + {store!r}
s.conf.num_buckets = 2
_orig = opt.write_bucket_run
def _killer(*a, **kw):
    out = _orig(*a, **kw)
    os.kill(os.getpid(), signal.SIGKILL)
    return out
opt.write_bucket_run = _killer
Hyperspace(s).optimize_index("cix", "quick")
print("UNREACHABLE")
"""
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.run([sys.executable, "-c", child], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == -signal.SIGKILL, (proc.stdout, proc.stderr)
        assert "UNREACHABLE" not in proc.stdout
        mgr = s.index_collection_manager._log_manager("cix")
        assert mgr.get_latest_log().state == "OPTIMIZING"
        entry = s.index_collection_manager.get_index("cix")
        assert entry is not None and entry.state == "ACTIVE"
        s.enable_hyperspace()
        got = (s.read.parquet(src).filter(col("id") == 3)
               .select("id", "v").collect())
        assert got.column("v").to_pylist() == [30]
        s.conf.auto_recovery_enabled = True
        s.conf.lifecycle_compaction_enabled = True
        s.conf.lifecycle_compaction_min_small_files = 2
        recs = hs.maintenance_cycle()
        opt_recs = [r for r in recs if r["decision"] == "optimize"]
        assert opt_recs and opt_recs[0]["outcome"] == "done", recs
        assert mgr.get_latest_log().state == "ACTIVE"
        recs = hs.maintenance_cycle()
        assert all(r["decision"] != "optimize" or r["outcome"] == "noop"
                   for r in recs), recs


class TestPosixStore:
    """The case tests/test_cdc.py parametrizes by store, on
    ``PosixLogStore``."""

    store = "PosixLogStore"
    test_sigkill_mid_compaction_converges = \
        TestAutonomousCompaction.test_sigkill_mid_compaction_converges
