"""The index advisor through hyperspace_tpu_torch (on the CPU) against the
JAX package: workload capture, hypothetical indexes and what-if,
recommendations and their apply.

One case per case of tests/test_advisor.py, each run
through both packages over the same seeded Parquet tables and compared
exactly: ``captured_workload()`` in every column but the timing
(``lastDurationMs``), the recommendation table, ``WhatIfReport.to_dict()``
and its rendered text, and the plans and answers after
``apply_recommendations``.  The estimates are computed from the same
file sizes in both packages, since the port writes the JAX package's
index bytes.  Left out: the telemetry class (spans and metrics wait for
Queue A item 9); the capture's ``advisor.capture.dropped`` metric is
held to the records the port kept instead.  Both packages take their
default store (``EmulatedObjectStore``); ``TestCaptureStores`` runs the
JAX file's ``BOTH_STORES`` cases with both packages pinned to each store
class.
"""

from __future__ import annotations

import glob
import importlib
import os

import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from tests.test_advisor import _write_tables

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
STORE_CLASSES = ("PosixLogStore", "EmulatedObjectStore")
# Every column of the workload table but the timing.
WORKLOAD_COLUMNS = ["key", "hits", "relations", "eqColumns", "rangeColumns",
                    "joinColumns", "groupColumns", "projectedColumns",
                    "lastBytesScanned", "bytesScannedTotal",
                    "lastSelectivity"]


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


class _Side:
    def __init__(self, pkg, root, fact, dim, store=None):
        self.pkg = pkg
        # A store class of io/log_store.py pinned on the session; None
        # keeps the package's default.
        self.store = store
        self.root = os.path.join(str(root), pkg.__name__)
        self.ix = os.path.join(self.root, "ix")
        self.fact, self.dim = fact, dim
        self.s = self.session()
        self.hs = pkg.Hyperspace(self.s)
        self.wl = _m(pkg, "advisor.workload")

    def session(self):
        if self.pkg is JAX:
            s = JAX.HyperspaceSession(system_path=self.ix)
        else:
            s = TORCH.HyperspaceSession(system_path=self.ix, device="cpu")
        if self.store:
            s.conf.log_store_class = \
                f"{self.pkg.__name__}.io.log_store.{self.store}"
        s.conf.num_buckets = 4
        return s

    def filter_q(self, s=None, key=123):
        s = s or self.s
        return (s.read.parquet(self.fact)
                .filter(self.pkg.col("k") == key).select("k", "v"))

    def join_q(self):
        col = self.pkg.col
        return (self.s.read.parquet(self.fact)
                .join(self.s.read.parquet(self.dim), col("k") == col("k2"))
                .select("k", "v", "u"))

    def config(self, name, indexed, included):
        return self.pkg.IndexConfig(name, indexed, included)

    def workload(self, hs=None):
        return (hs or self.hs).captured_workload().select(
            WORKLOAD_COLUMNS).to_pylist()

    def files(self):
        return sorted(os.path.relpath(p, self.ix)
                      for p in glob.glob(os.path.join(self.ix, "**"),
                                         recursive=True)
                      if os.path.isfile(p))


@pytest.fixture()
def sides(tmp_path):
    fact, dim = _write_tables(tmp_path)
    for pkg in PKGS:
        _m(pkg, "advisor.workload").reset_cache()
    yield [_Side(pkg, tmp_path, fact, dim) for pkg in PKGS]
    for pkg in PKGS:
        _m(pkg, "advisor.workload").reset_cache()


def _same(got):
    assert got[1] == got[0]
    return got[1]


# ---------------------------------------------------------------------------
# Workload capture
# ---------------------------------------------------------------------------
@pytest.fixture(params=STORE_CLASSES)
def store_sides(request, tmp_path):
    """Both packages with their sessions pinned to one store class."""
    fact, dim = _write_tables(tmp_path)
    for pkg in PKGS:
        _m(pkg, "advisor.workload").reset_cache()
    yield [_Side(pkg, tmp_path, fact, dim, store=request.param)
           for pkg in PKGS]
    for pkg in PKGS:
        _m(pkg, "advisor.workload").reset_cache()


class TestCaptureStores:
    """The JAX file's ``BOTH_STORES`` cases, through each store class."""

    def test_dedup_and_hit_merge(self, store_sides):
        TestCapture.test_dedup_and_hit_merge(self, store_sides)
        assert {type(s.wl.store_for(s.s.conf)).__name__
                for s in store_sides} == {store_sides[0].store}

    def test_capture_survives_restart(self, store_sides):
        TestCapture.test_capture_survives_restart(self, store_sides)


class TestCapture:
    def test_dedup_and_hit_merge(self, sides):
        got = []
        for side in sides:
            side.s.conf.advisor_capture_enabled = True
            for _ in range(4):  # a power of two: hits=4 is flushed
                side.filter_q().collect()
            got.append(side.workload())
        rows = _same(got)
        assert len(rows) == 1 and rows[0]["hits"] == 4
        assert rows[0]["eqColumns"] == ["k"]
        assert "v" in rows[0]["projectedColumns"]
        assert rows[0]["lastBytesScanned"] > 0

    def test_distinct_shapes_get_distinct_records(self, sides):
        got = []
        for side in sides:
            side.s.conf.advisor_capture_enabled = True
            side.filter_q().collect()
            side.join_q().collect()
            side.filter_q(key=999).collect()
            got.append(side.workload())
        rows = _same(got)
        assert sorted(r["hits"] for r in rows) == [1, 2]
        joins = [r["joinColumns"] for r in rows if r["joinColumns"]]
        assert joins == [["k", "k2"]]

    def test_capture_survives_restart(self, sides):
        got = []
        for side in sides:
            side.s.conf.advisor_capture_enabled = True
            for _ in range(2):
                side.filter_q().collect()
            side.wl.flush_pending(side.s.conf)
            side.wl.reset_cache()  # a fresh process
            fresh = side.session()
            first = side.workload(side.pkg.Hyperspace(fresh))
            fresh.conf.advisor_capture_enabled = True
            for _ in range(2):
                side.filter_q(fresh).collect()
            got.append((first, side.workload(side.pkg.Hyperspace(fresh))))
        first, second = _same(got)
        assert [r["hits"] for r in first] == [2]
        assert [r["hits"] for r in second] == [4]

    def test_capture_files_are_the_jax_packages(self, sides):
        """Under the default store both packages write the same keys, so
        each reads the other's capture."""
        for side in sides:
            side.s.conf.advisor_capture_enabled = True
            for _ in range(2):
                side.filter_q().collect()
            side.wl.flush_pending(side.s.conf)
        names = [sorted(os.listdir(side.wl.workload_root(side.s.conf)))
                 for side in sides]
        assert names[0] == names[1] and len(names[0]) == 3  # lock, key, .g
        for reader, writer in ((sides[0], sides[1]), (sides[1], sides[0])):
            kwargs = {} if reader.pkg is JAX else {"device": "cpu"}
            conf = reader.pkg.HyperspaceSession(system_path=writer.ix,
                                                **kwargs).conf
            theirs = reader.wl.records(conf)
            mine = writer.wl.records(writer.s.conf)
            assert [(r["key"], r["hits"]) for r in theirs] == \
                [(r["key"], r["hits"]) for r in mine] and len(mine) == 1

    def test_bounded_by_max_entries(self, sides):
        got = []
        for side in sides:
            side.s.conf.advisor_capture_enabled = True
            side.s.conf.advisor_capture_max_entries = 2
            for c in ("v", "pad0", "pad1", "pad2"):  # four shapes, cap two
                (side.s.read.parquet(side.fact)
                 .filter(side.pkg.col(c) >= 0).select("k", c).collect())
            dropped = sum(1 for p in side.wl._pending.values() if p.dropped)
            got.append((side.workload(), dropped))
        rows, dropped = _same(got)
        assert len(rows) == 2 and dropped == 2

    def test_disabled_capture_writes_nothing(self, sides):
        got = []
        for side in sides:
            assert side.s.conf.advisor_capture_enabled is False
            side.filter_q().collect()
            side.join_q().collect()
            got.append((os.path.exists(os.path.join(
                side.ix, side.wl.WORKLOAD_DIR)),
                side.hs.captured_workload().num_rows))
        assert _same(got) == (False, 0)

    def test_capture_failure_never_breaks_the_query(self, sides,
                                                    monkeypatch):
        def boom(*a, **k):
            raise RuntimeError("store down")

        got = []
        for side in sides:
            side.s.conf.advisor_capture_enabled = True
            monkeypatch.setattr(side.wl, "store_for", boom)
            got.append(side.filter_q().collect().to_pylist())
        assert len(_same(got)) == 1


# ---------------------------------------------------------------------------
# Hypothetical indexes / what-if
# ---------------------------------------------------------------------------
class TestWhatIf:
    def test_filter_rule_matches_hypothetical(self, sides):
        got = []
        for side in sides:
            report = side.hs.whatif(side.filter_q(),
                                    [side.config("hypo", ["k"], ["v"])])
            got.append((report.to_dict(), report.render()))
        d, text = _same(got)
        assert d["hypothetical_used"] == ["hypo"]
        assert "Hyperspace(Type: CI, Name: hypo)" in d["plan_after"]
        assert d["est_bytes_delta"] > 0

    def test_join_rule_matches_hypothetical_both_sides(self, sides):
        got = []
        for side in sides:
            report = side.hs.whatif(side.join_q(),
                                    [side.config("h_l", ["k"], ["v"]),
                                     side.config("h_r", ["k2"], ["u"])])
            got.append(report.to_dict())
        assert _same(got)["hypothetical_used"] == ["h_l", "h_r"]

    def test_whatif_writes_zero_files(self, sides):
        got = []
        for side in sides:
            side.hs.whatif(side.filter_q(),
                           [side.config("hypo", ["k"], ["v"])])
            got.append(side.files())
        assert _same(got) == []

    def test_executor_rejects_hypothetical_plan(self, sides):
        got = []
        for side in sides:
            hyp = _m(side.pkg, "advisor.hypothetical")
            ds = side.filter_q()
            entry = hyp.hypothetical_entry(side.s, ds,
                                           side.config("hypo", ["k"], ["v"]))
            side.s.enable_hyperspace()
            plan = side.s.optimize(ds.plan, hypothetical=[entry])
            assert any(s.relation.hypothetical
                       for s in plan.leaf_relations())
            executor = _m(side.pkg, "execution.executor").Executor(side.s)
            with pytest.raises(side.pkg.HyperspaceError,
                               match="hypothetical") as ei:
                executor.execute(plan)
            got.append((plan.tree_string(), str(ei.value).split(";")[0]))
        _same(got)

    def test_log_managers_refuse_to_persist(self, sides):
        got = []
        for side in sides:
            hyp = _m(side.pkg, "advisor.hypothetical")
            entry = hyp.hypothetical_entry(side.s, side.filter_q(),
                                           side.config("hypo", ["k"], ["v"]))
            messages = []
            for cls in (_m(side.pkg, "index.log_manager").IndexLogManager,
                        _m(side.pkg, "index.object_log_manager")
                        .ObjectStoreLogManager):
                mgr = cls(os.path.join(side.ix, "hypo"))
                mgr.configure(side.s.conf)
                with pytest.raises(side.pkg.HyperspaceError,
                                   match="hypothetical") as ei:
                    mgr.write_log(1, entry)
                messages.append(str(ei.value).split(":")[0])
            got.append((messages,
                        side.s.index_collection_manager.get_indexes(),
                        side.files()))
        assert _same(got)[1:] == ([], [])

    def test_untagged_entry_rejected_by_optimize_channel(self, sides):
        for side in sides:
            hyp = _m(side.pkg, "advisor.hypothetical")
            ds = side.filter_q()
            entry = hyp.hypothetical_entry(side.s, ds,
                                           side.config("hypo", ["k"], ["v"]))
            del entry.properties["hypothetical"]
            side.s.enable_hyperspace()
            with pytest.raises(side.pkg.HyperspaceError,
                               match="hypothetical tag"):
                side.s.optimize(ds.plan, hypothetical=[entry])

    def test_real_optimize_never_sees_whatif_entries(self, sides):
        got = []
        for side in sides:
            ds = side.filter_q()
            side.hs.whatif(ds, [side.config("hypo", ["k"], ["v"])])
            side.s.enable_hyperspace()
            plan = ds.optimized_plan()
            assert not any(s.relation.index_scan_of
                           for s in plan.leaf_relations())
            got.append((plan.tree_string(), ds.collect().to_pylist()))
        assert len(_same(got)[1]) == 1

    def test_explain_whatif_renders(self, sides):
        got = [side.filter_q().explain(
            whatif=[side.config("hypo", ["k"], ["v"])]) for side in sides]
        text = _same(got)
        assert "What-if" in text and "hypo" in text
        assert "Estimated bytes scanned" in text

    def test_whatif_under_quarantined_real_index(self, sides):
        got = []
        for side in sides:
            side.hs.create_index(side.s.read.parquet(side.fact),
                                 side.config("real", ["k"], ["v"]))
            mgr = side.s.index_collection_manager
            q = mgr.quarantine_manager("real")
            for f in mgr.get_index("real").content.file_infos():
                q.add(f.name, "test damage")
            report = side.hs.whatif(side.filter_q(),
                                    [side.config("hypo", ["k"],
                                                 ["pad0", "v"])])
            got.append(report.to_dict())
        assert _same(got)["hypothetical_used"] == ["hypo"]


# ---------------------------------------------------------------------------
# Ranker determinism over hypothetical entries
# ---------------------------------------------------------------------------
class TestRankerDeterminism:
    def test_filter_ties_break_deterministically(self, sides):
        for side in sides:
            hyp = _m(side.pkg, "advisor.hypothetical")
            rank = _m(side.pkg, "rules.rankers").rank_filter_indexes
            tags = _m(side.pkg, "index.log_entry").IndexLogEntryTags
            ds = side.filter_q()
            lean = hyp.hypothetical_entry(side.s, ds,
                                          side.config("lean", ["k"], ["v"]))
            fat = hyp.hypothetical_entry(
                side.s, ds, side.config("fat", ["k"], ["v", "pad0", "pad1"]))
            scan = ds.plan.leaf_relations()[0]
            for order in ([lean, fat], [fat, lean]):
                assert rank(order, scan, hybrid_scan=False).name == "lean"
            for e in (lean, fat):
                e.set_tag(tags.COMMON_BYTES, 100, scan)
            for order in ([lean, fat], [fat, lean]):
                assert rank(order, scan, hybrid_scan=True).name == "lean"

    def test_same_shape_candidates_tie_break_by_name(self, sides):
        for side in sides:
            hyp = _m(side.pkg, "advisor.hypothetical")
            rank = _m(side.pkg, "rules.rankers").rank_filter_indexes
            ds = side.filter_q()
            a = hyp.hypothetical_entry(side.s, ds,
                                       side.config("aaa", ["k"], ["v"]))
            b = hyp.hypothetical_entry(side.s, ds,
                                       side.config("bbb", ["k"], ["v"]))
            scan = ds.plan.leaf_relations()[0]
            for order in ([a, b], [b, a]):
                assert rank(order, scan, hybrid_scan=False).name == "aaa"


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------
class TestStatistics:
    def test_summary_carries_size_and_count(self, sides):
        got = []
        for side in sides:
            side.hs.create_index(side.s.read.parquet(side.fact),
                                 side.config("ci", ["k"], ["v"]))
            table = side.hs.indexes()
            detail = side.hs.index("ci")
            assert table.column("sizeIndexFiles").to_pylist() \
                == detail.column("sizeIndexFiles").to_pylist()
            got.append((table.column("numIndexFiles").to_pylist(),
                        table.column("sizeIndexFiles").to_pylist()))
        counts, sizes = _same(got)
        assert counts[0] >= 1 and sizes[0] > 0

    def test_location_falls_back_to_index_root(self, sides):
        got = []
        for side in sides:
            hyp = _m(side.pkg, "advisor.hypothetical")
            stats = _m(side.pkg, "index.statistics")
            entry = hyp.hypothetical_entry(
                side.s, side.filter_q(), side.config("noFiles", ["k"], ["v"]))
            mgr = side.s.index_collection_manager
            if side.pkg is JAX:
                table = stats.index_statistics_table(
                    [entry], path_resolver=mgr.path_resolver)
                want = mgr.path_resolver.get_index_path("noFiles")
            else:
                table = stats.index_statistics_table(
                    [entry], index_path=mgr.index_path)
                want = mgr.index_path("noFiles")
            assert table.column("indexLocation").to_pylist() == [want]
            got.append((os.path.relpath(want, side.ix),
                        table.column("numIndexFiles").to_pylist()))
        assert _same(got) == ("noFiles", [0])


# ---------------------------------------------------------------------------
# The acceptance loop
# ---------------------------------------------------------------------------
class TestRecommendLoop:
    def test_capture_recommend_apply_rerun(self, sides):
        got = []
        for side in sides:
            s, hs = side.s, side.hs
            s.conf.advisor_capture_enabled = True
            s.enable_hyperspace()
            expected = side.filter_q().collect()
            for _ in range(3):
                side.filter_q().collect()
            side.join_q().collect()
            before = side.filter_q()
            before.collect()
            rep_before = before.last_run_report()
            src_before = rep_before.bytes_read(is_index=False)
            assert src_before > 0 and not rep_before.indexes_used
            rec = hs.recommend_indexes(top_k=3)
            top = rec.to_pylist()[0]
            report = hs.whatif(side.filter_q(),
                               [side.config(top["candidate"],
                                            top["indexedColumns"],
                                            top["includedColumns"])])
            files_before_apply = [f for f in side.files()
                                  if side.wl.WORKLOAD_DIR not in f]
            built = hs.apply_recommendations(top_k=1)
            states = hs.indexes().column("state").to_pylist()
            rerun = side.filter_q()
            out = rerun.collect()
            rep_after = rerun.last_run_report()
            got.append({
                "recommendations": rec.to_pylist(),
                "whatif": report.to_dict(),
                "files_before_apply": files_before_apply,
                "built": built, "states": states,
                "plan_after": rerun.optimized_plan().tree_string(),
                "rows": out.to_pylist(), "expected": expected.to_pylist(),
                "used": rep_after.indexes_used,
                "bytes_before": src_before,
                "bytes_after": rep_after.bytes_read(),
                "again": hs.apply_recommendations(top_k=1),
            })
        r = _same(got)
        top = r["recommendations"][0]
        assert top["indexedColumns"] == ["k"] and "v" in \
            top["includedColumns"] and top["estBenefitBytes"] > 0
        est_delta = r["whatif"]["est_bytes_delta"]
        assert est_delta > 0 and r["files_before_apply"] == []
        assert r["built"] == [top["candidate"]] and r["states"] == ["ACTIVE"]
        assert r["rows"] == r["expected"] and r["built"][0] in r["used"]
        measured = r["bytes_before"] - r["bytes_after"]
        assert 0 < measured and est_delta / 16 <= measured <= est_delta * 16
        assert r["again"] == []

    def test_recommend_empty_workload(self, sides):
        got = [side.hs.recommend_indexes().to_pylist() for side in sides]
        assert _same(got) == []


def test_phase_o_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase O end to end at a small size: the captured
    workload, deterministic recommendations, what-if writing nothing,
    apply, and the queries again through the built indexes."""
    import torch

    from tests.test_torch_faults import chip_smoke_at_small_size

    chip_smoke, orders, li, root = chip_smoke_at_small_size(monkeypatch,
                                                            tmp_path)
    out = chip_smoke.phase_o(orders, li, root, torch.device("cpu"))
    assert [w["hits"] for w in out["workload"]] == [2, 2, 2, 2]
    assert out["built"] == ["adv_lineitem_l_orderkey",
                            "adv_orders_o_orderkey"]
    for name, q in out["queries"].items():
        assert q["after"]["bytes_read"] < q["before"]["bytes_read"], name
    assert "hypothetical" in out["whatif_refused"]
