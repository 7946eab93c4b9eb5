"""The autonomous index lifecycle through hyperspace_tpu_torch (on the
CPU) against the JAX package: change detection, the maintenance policy,
the decision journal and the maintenance daemon.

Three kinds of case:

- **The pure functions against the JAX package's.**  A seeded grid of
  ``ChangeSummary`` inputs crossing the quarantine count, lineage, hybrid
  scan, CDC and the three ratios at and around each threshold goes
  through both packages' ``decide_refresh``: kind, mode and reason
  string equal.  The same for ``decide_advisor``, ``decide_compaction``
  and the ``ChangeSummary`` and ``MergeDebt`` properties.
- **Scenarios.**  Both packages index one shared Parquet source in their
  own system paths (each on its default store, ``EmulatedObjectStore``), go
  through the same mutations and ``maintenance_cycle()`` calls, and after
  every cycle must agree on: the journal records (every field but
  ``ts``, ``wall_s`` and ``key``; a backoff reason's remaining seconds
  are a clock reading and are masked), each index's log ids and states,
  each bucket's sha256, and the query answers in order.
- **The JAX package's own cases** (tests/test_lifecycle.py), each held
  to what it asserts, on the port alone, on the default store
  (``EmulatedObjectStore``); ``TestPosixStore`` runs the cases the JAX
  file parametrizes by store on ``PosixLogStore``, and
  ``test_cycle_converges_through_armed_store_fault`` runs over
  ``ObjectStoreLogManager``.  Its flight-recorder case waits for item 9.

And the port's one deliberate difference: a device error (a
``torch.OutOfMemoryError``, the kernel loader's ``KernelError``) raised
inside the daemon's refresh is journaled and then propagates, where an
index-side error backs off.
"""

from __future__ import annotations

import glob
import hashlib
import importlib
import os
import re
import threading
import time
from collections import defaultdict

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
from hyperspace_tpu_torch.actions.refresh import RefreshSummary
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import FileInfo
from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
from hyperspace_tpu_torch.lifecycle import journal as lifecycle_journal
from hyperspace_tpu_torch.lifecycle import policy
from hyperspace_tpu_torch.lifecycle.change_detector import (
    ChangeSummary,
    detect_changes,
    diff_file_sets,
)
from hyperspace_tpu_torch.lifecycle.daemon import (
    clear_drain,
    daemon_for,
    notify_drain,
)
from tests.test_lifecycle import _append, _write_source
from tests.test_torch_integrity import _bitrot

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
OBJECT_MANAGER = (
    "hyperspace_tpu_torch.index.object_log_manager.ObjectStoreLogManager")
NUM_BUCKETS = 4


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _port_session(system_path: str, store: str = "") -> HyperspaceSession:
    """A port session on the CPU with the device routes pinned on (the
    kernels' plain versions run); ``store`` pins a class of
    io/log_store.py, "" keeps the default."""
    s = HyperspaceSession(system_path=system_path, device="cpu")
    if store:
        s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    return s


@pytest.fixture()
def env(tmp_path):
    src = str(tmp_path / "src")
    _write_source(src)
    session = _port_session(str(tmp_path / "ix"))
    session.conf.num_buckets = NUM_BUCKETS
    session.conf.lineage_enabled = True
    hs = Hyperspace(session)
    hs.create_index(session.read.parquet(src),
                    IndexConfig("lix", ["k"], ["v"]))
    yield session, hs, src


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The drain latch, the fault plans and the workload caches are
    process-wide in both packages."""
    for pkg in PKGS:
        _m(pkg, "advisor.workload").reset_cache()
    yield
    for pkg in PKGS:
        _m(pkg, "lifecycle.daemon").clear_drain()
        _m(pkg, "io.faults").clear()
        _m(pkg, "advisor.workload").reset_cache()


# ---------------------------------------------------------------------------
# The pure functions against the JAX package's
# ---------------------------------------------------------------------------
QUICK, FULL, MERGE = 0.1, 0.5, 0.2
RECORDED_FILES, RECORDED_BYTES = 20, 2000


def _summary_grid(n: int = 640) -> list:
    """(summary fields, decide kwargs) pairs from a seeded grid: file
    counts around the full-churn ratio (9, 10, 11 of 20 files), bytes
    around the quick (199, 200, 201 of 2000) and merge-debt (399, 400,
    401) ratios, with and without quarantine, lineage, hybrid and CDC."""
    rng = np.random.default_rng(1515)
    counts = np.array([0, 0, 1, 2, 5, 9, 10, 11])
    byte_steps = np.array([0, 50, 150, 199, 200, 201, 399, 400, 401])
    out = []
    for _ in range(n):
        appended = int(rng.choice(counts))
        deleted = int(rng.choice(counts))
        mutated = int(min(rng.integers(0, 3), appended, deleted))
        fields = dict(
            index="i", appended=appended, deleted=deleted, mutated=mutated,
            appended_bytes=int(rng.choice(byte_steps)) if appended else 0,
            recorded_files=RECORDED_FILES, recorded_bytes=RECORDED_BYTES,
            hybrid_debt_bytes=int(rng.choice([0, 0, 100, 199, 200, 201])),
            newest_change_ms=int(rng.integers(0, 2)) * 1_700_000_000_000,
            deleted_bytes=int(rng.choice(byte_steps)) if deleted else 0,
            merge_debt_bytes=int(rng.choice([0, 0, 150, 200, 201, 399,
                                             400, 401])))
        kwargs = dict(
            quarantined=int(rng.choice([0, 0, 0, 0, 1, 3])),
            lineage=bool(rng.integers(0, 2)),
            hybrid_scan=bool(rng.integers(0, 4) > 0),
            quick_append_ratio=QUICK, full_churn_ratio=FULL,
            cdc_merge_on_read=bool(rng.integers(0, 2)),
            merge_debt_ratio=MERGE)
        out.append((fields, kwargs))
    return out


class TestPureFunctionsAgainstJax:
    def test_decide_refresh_grid(self):
        jpol, tpol = _m(JAX, "lifecycle.policy"), policy
        jcd = _m(JAX, "lifecycle.change_detector")
        grid = _summary_grid()
        assert len(grid) >= 500
        seen = set()
        for fields, kwargs in grid:
            want = jpol.decide_refresh(jcd.ChangeSummary(**fields), **kwargs)
            got = tpol.decide_refresh(ChangeSummary(**fields), **kwargs)
            assert got.to_dict() == want.to_dict(), (fields, kwargs)
            seen.add((got.kind, got.mode, re.sub(r"[\d.]+", "#", got.reason)))
        # Every rung and every reason of the ladder is crossed.
        assert {(k, m) for k, m, _ in seen} == {
            ("none", ""), ("repair", "repair"), ("refresh", "full"),
            ("refresh", "incremental"), ("refresh", "quick")}
        assert len({r for _, _, r in seen}) >= 12

    def test_change_summary_properties(self):
        jcd = _m(JAX, "lifecycle.change_detector")
        for fields, _ in _summary_grid(200):
            j, t = jcd.ChangeSummary(**fields), ChangeSummary(**fields)
            assert (t.changed, t.churn_ratio, t.append_ratio,
                    t.merge_debt_ratio, t.to_dict()) == \
                (j.changed, j.churn_ratio, j.append_ratio,
                 j.merge_debt_ratio, j.to_dict())
        # The epoch-ms normalisation of the lister's nanoseconds.
        cd = _m(TORCH, "lifecycle.change_detector")
        for mtime in (0, 1_700_000_000, 1_700_000_000_123,
                      1_700_000_000_123_456_789, 12.5):
            assert cd._mtime_epoch_ms(mtime) == jcd._mtime_epoch_ms(mtime)

    def test_decide_advisor_grid(self):
        jpol = _m(JAX, "lifecycle.policy")
        rng = np.random.default_rng(77)
        kinds = set()
        for _ in range(300):
            names = [f"ix{i}" for i in range(int(rng.integers(0, 5)))]
            index_bytes = {n: int(rng.integers(1, 1000)) for n in names}
            cold = [n for n in names if rng.integers(0, 2)] \
                + (["gone"] if rng.integers(0, 4) == 0 else [])
            cands = [(f"c{i}", float(rng.choice([-5.0, 0.0, 10.5, 300.0,
                                                 900.0])))
                     for i in range(int(rng.integers(0, 4)))]
            total = sum(index_bytes.values())
            budget = int(rng.choice([0, -1, total, total - 1, total + 1,
                                     total // 2, total + 500]))
            args = dict(byte_budget=budget, index_bytes=index_bytes,
                        cold_indexes=cold, candidates=cands)
            want = jpol.decide_advisor(jpol.AdvisorInputs(**args))
            got = policy.decide_advisor(policy.AdvisorInputs(**args))
            assert [d.to_dict() for d in got] == \
                [d.to_dict() for d in want], args
            kinds.update(d.kind for d in got)
        assert kinds == {"create", "delete"}

    def test_decide_compaction_grid(self):
        jcdc, tcdc = _m(JAX, "lifecycle.cdc"), _m(TORCH, "lifecycle.cdc")
        rng = np.random.default_rng(91)
        fired = 0
        for _ in range(200):
            mergeable = int(rng.integers(0, 12))
            fields = dict(index="i", total_files=mergeable + 3,
                          small_files=mergeable + 1,
                          mergeable_files=mergeable,
                          mergeable_buckets=int(rng.integers(0, 5)))
            kw = dict(min_small_files=int(rng.choice(
                [0, -1, mergeable - 1, mergeable, mergeable + 1, 8])),
                mode=str(rng.choice(["quick", "full"])))
            want = jcdc.decide_compaction(jcdc.CompactionStats(**fields), **kw)
            got = tcdc.decide_compaction(tcdc.CompactionStats(**fields), **kw)
            assert (got and got.to_dict()) == (want and want.to_dict())
            assert tcdc.CompactionStats(**fields).to_dict() == \
                jcdc.CompactionStats(**fields).to_dict()
            fired += got is not None
        assert 0 < fired < 200

    def test_merge_debt_properties(self):
        jcdc, tcdc = _m(JAX, "lifecycle.cdc"), _m(TORCH, "lifecycle.cdc")
        rng = np.random.default_rng(5)
        for _ in range(100):
            fields = dict(index="i",
                          appended_files=int(rng.integers(0, 3)),
                          deleted_files=int(rng.integers(0, 3)),
                          appended_bytes=int(rng.integers(0, 500)),
                          deleted_bytes=int(rng.integers(0, 500)),
                          recorded_bytes=int(rng.choice([0, 1000, 3333])),
                          lineage=bool(rng.integers(0, 2)))
            j, t = jcdc.MergeDebt(**fields), tcdc.MergeDebt(**fields)
            assert (t.total_bytes, t.ratio, t.readable, t.to_dict()) == \
                (j.total_bytes, j.ratio, j.readable, j.to_dict())


# ---------------------------------------------------------------------------
# Scenarios through both packages
# ---------------------------------------------------------------------------
def _digests(entry) -> dict:
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(v) for b, v in out.items()}


def _normal(rec: dict, jax: bool = False) -> dict:
    """A journal record without its clock readings.  ``jax``: the JAX
    package's repair reports a committed repair as "noop" (ROADMAP.md
    Queue C, a reference fault the port does not copy), so its journal
    says "noop" where the port's says "done"."""
    out = {k: v for k, v in rec.items() if k not in ("ts", "wall_s", "key")}
    if "reason" in out:
        out["reason"] = re.sub(r"[\d.]+s left", "#s left", out["reason"])
    if jax and out.get("decision") == "repair" and out["outcome"] == "noop":
        out["outcome"] = "done"
    return out


class _Pair:
    """One shared source, indexed by both packages in their own system
    paths with the same conf."""

    def __init__(self, tmp_path, files: int = 20, **conf) -> None:
        self.src = str(tmp_path / "src")
        _write_source(self.src, n=100 * files, files=files)
        self.sides = {}
        for pkg in PKGS:
            path = str(tmp_path / ("jax" if pkg is JAX else "torch"))
            if pkg is JAX:
                s = JAX.HyperspaceSession(system_path=path)
                s.conf.mesh_enabled = "off"
                s.conf.parallel_build = "off"
                s.conf.device_cache_policy = "off"
            else:
                s = _port_session(path)
            s.conf.num_buckets = NUM_BUCKETS
            s.conf.lineage_enabled = True
            for k, v in conf.items():
                setattr(s.conf, k, v)
            self.sides[pkg] = (s, pkg.Hyperspace(s))
        self.names = ["lix"]
        self.both(lambda pkg, s, hs: hs.create_index(
            s.read.parquet(self.src),
            pkg.IndexConfig("lix", ["k"], ["v", "d"])))

    def both(self, fn) -> list:
        return [fn(pkg, *self.sides[pkg]) for pkg in PKGS]

    def set(self, **conf) -> None:
        for s, _ in self.sides.values():
            for k, v in conf.items():
                setattr(s.conf, k, v)

    def cycle(self, arm=None) -> list:
        """One ``maintenance_cycle()`` in each package (``arm(pkg)`` run
        just before it, the package's fault plan cleared just after);
        returns the port's records once everything agrees."""
        got = []
        for pkg in PKGS:
            try:
                if arm is not None:
                    arm(pkg)
                got.append(self.sides[pkg][1].maintenance_cycle())
            finally:
                _m(pkg, "io.faults").clear()
        assert [_normal(r) for r in got[1]] == \
            [_normal(r, jax=True) for r in got[0]]
        self.check()
        return got[1]

    def check(self) -> None:
        jrecs, trecs = self.both(
            lambda pkg, s, hs: [_normal(r, jax=pkg is JAX) for r in
                                _m(pkg, "lifecycle.journal").records(s.conf)])
        assert trecs == jrecs
        names = self.both(lambda pkg, s, hs: sorted(
            e.name for e in s.index_collection_manager.get_indexes()))
        assert names[1] == names[0]
        for name in set(names[0]) | set(self.names):
            logs = self.both(lambda pkg, s, hs: self._log(s, name))
            assert logs[1] == logs[0], name
            entries = self.both(lambda pkg, s, hs:
                                s.index_collection_manager.get_index(name))
            if entries[0] is not None and entries[0].state == "ACTIVE":
                assert _digests(entries[1]) == _digests(entries[0]), name
        for q in ("all", "point", "d7"):
            rows = self.both(lambda pkg, s, hs: self.query(pkg, s, q,
                                                           capture=False))
            assert rows[1] == rows[0], q

    @staticmethod
    def _log(s, name: str) -> list:
        mgr = s.index_collection_manager._log_manager(name)
        return [(i, getattr(mgr.get_log(i), "state", None))
                for i in mgr.log_ids()]

    def query(self, pkg, s, q: str, capture: bool = True) -> list:
        """Query ``q``'s rows; the checks' queries are not captured, so
        the workload the advisor reads is the scenario's own."""
        s.enable_hyperspace()
        ds = s.read.parquet(self.src)
        ds = {"all": ds.filter(pkg.col("k") >= 0).select("k", "v"),
              "point": ds.filter(pkg.col("k") == 1234).select("k", "v", "d"),
              "d7": ds.filter(pkg.col("d") == 7).select("d", "v")}[q]
        captured = s.conf.advisor_capture_enabled
        s.conf.advisor_capture_enabled = captured and capture
        try:
            return ds.collect().to_pylist()
        finally:
            s.conf.advisor_capture_enabled = captured

    def files(self) -> list:
        return sorted(glob.glob(os.path.join(self.src, "*.parquet")))

    def rewrite(self, path: str) -> None:
        """Rewrite ``path`` in place with its first half of rows."""
        t = pq.read_table(path)
        pq.write_table(t.slice(0, t.num_rows // 2), path)


def _one(recs: list, **want) -> dict:
    hits = [r for r in recs if all(r.get(k) == v for k, v in want.items())]
    assert len(hits) == 1, recs
    return hits[0]


class TestScenariosAgainstJax:
    def test_none(self, tmp_path):
        pair = _Pair(tmp_path)
        rec = _one(pair.cycle(), decision="none")
        assert (rec["outcome"], rec["reason"]) == ("noop", "source unchanged")

    def test_quick_append(self, tmp_path):
        pair = _Pair(tmp_path, hybrid_scan_enabled=True)
        _append(pair.src, start=50_000, n=20)
        rec = _one(pair.cycle(), decision="refresh")
        assert (rec["mode"], rec["outcome"], rec["appended"]) == \
            ("quick", "done", 1)
        # Pending bytes within the budget: a journaled none after.
        rec = _one(pair.cycle(), decision="none")
        assert "pending bytes within the hybrid-scan debt budget" \
            in rec["reason"]

    def test_incremental_append(self, tmp_path):
        pair = _Pair(tmp_path, hybrid_scan_enabled=True)
        for i in range(3):  # 3 of 20 files: past the 0.1 quick budget
            _append(pair.src, start=60_000 + 1000 * i)
        rec = _one(pair.cycle(), decision="refresh")
        assert (rec["mode"], rec["outcome"], rec["appended"]) == \
            ("incremental", "done", 3)
        assert "beyond the quick budget" in rec["reason"]

    def test_cdc_quick_then_incremental_over_debt(self, tmp_path):
        pair = _Pair(tmp_path, hybrid_scan_enabled=True,
                     lifecycle_cdc_enabled=True)
        files = pair.files()
        os.remove(files[3])
        pair.rewrite(files[7])
        rec = _one(pair.cycle(), decision="refresh")
        assert (rec["mode"], rec["outcome"]) == ("quick", "done")
        assert (rec["appended"], rec["deleted"], rec["mutated"]) == (1, 2, 1)
        assert "CDC merge-on-read" in rec["reason"]
        for debt in _m(TORCH, "lifecycle.cdc"), _m(JAX, "lifecycle.cdc"):
            pkg = TORCH if debt.__name__.startswith("hyperspace_tpu_torch") \
                else JAX
            s = pair.sides[pkg][0]
            d = debt.merge_debt(s.index_collection_manager.get_index("lix"))
            assert (d.deleted_files, d.appended_files, d.readable) == \
                (2, 1, True)
        for path in files[10:13]:  # the carried overlay outgrows 0.2
            os.remove(path)
        rec = _one(pair.cycle(), decision="refresh")
        assert (rec["mode"], rec["outcome"]) == ("incremental", "done")
        assert "merge debt ratio" in rec["reason"]

    def test_full_on_churn(self, tmp_path):
        pair = _Pair(tmp_path)
        for path in pair.files()[:10]:
            os.remove(path)
        rec = _one(pair.cycle(), decision="refresh")
        assert (rec["mode"], rec["outcome"], rec["deleted"]) == \
            ("full", "done", 10)
        assert rec["reason"].startswith("churn ratio 0.50 >= 0.50")

    def test_repair_of_a_quarantined_file(self, tmp_path):
        pair = _Pair(tmp_path)
        for pkg in PKGS:
            s, hs = pair.sides[pkg]
            entry = s.index_collection_manager.get_index("lix")
            _bitrot(sorted(entry.content.file_infos(),
                           key=lambda f: bucket_id_of_file(f.name))[0].name)
            hs.verify_index("lix", "full")
        rec = _one(pair.cycle(), decision="repair")
        assert (rec["mode"], rec["outcome"]) == ("repair", "done")
        assert rec["reason"].startswith("1 quarantined index file(s)")
        _one(pair.cycle(), decision="none")

    def test_compaction(self, tmp_path):
        pair = _Pair(tmp_path)
        for i in range(2):
            _append(pair.src, start=70_000 + 1000 * i)
            _one(pair.cycle(), decision="refresh", mode="incremental")
        pair.set(lifecycle_compaction_enabled=True,
                 lifecycle_compaction_min_small_files=2)
        rec = _one(pair.cycle(), decision="optimize")
        assert (rec["mode"], rec["outcome"]) == ("quick", "done")
        assert "small index file(s) across" in rec["reason"]
        rec = _one(pair.cycle(), index="lix")
        assert rec["decision"] == "none"

    def test_advisor_create_and_delete(self, tmp_path):
        pair = _Pair(tmp_path, advisor_capture_enabled=True)
        for _ in range(3):
            pair.both(lambda pkg, s, hs: pair.query(pkg, s, "d7"))
        entry = pair.sides[TORCH][0].index_collection_manager.get_index("lix")
        lix_bytes = sum(f.size for f in entry.content.file_infos())
        src_bytes = sum(os.path.getsize(p) for p in pair.files())
        pair.set(lifecycle_byte_budget=lix_bytes + 4 * src_bytes)
        recs = pair.cycle()
        create = _one(recs, decision="create")
        assert create["outcome"] == "done"
        assert create["reason"].startswith("advisor-recommended; est ")
        pair.names.append(create["index"])
        # Under a budget below the total, the cold index (the captured
        # query never touches ``k``) goes.
        pair.set(lifecycle_byte_budget=lix_bytes)
        delete = _one(pair.cycle(), decision="delete")
        assert (delete["index"], delete["outcome"]) == ("lix", "done")
        assert "cold index" in delete["reason"]

    def test_shed_on_drain_and_rss_watermark(self, tmp_path, monkeypatch):
        pair = _Pair(tmp_path)
        _append(pair.src, start=80_000)

        def drain(pkg):
            _m(pkg, "lifecycle.daemon").notify_drain()

        rec = _one(pair.cycle(arm=drain), outcome="skipped")
        assert rec["reason"] == "server draining: maintenance parked"
        for pkg in PKGS:
            _m(pkg, "lifecycle.daemon").clear_drain()
        # Both processes read one fixed resident set: the two reads of a
        # live process would differ.
        monkeypatch.setattr(_m(JAX, "interop.server"), "_current_rss_mb",
                            lambda: 4321.0)
        monkeypatch.setattr(_m(TORCH, "lifecycle.daemon"), "_current_rss_mb",
                            lambda: 4321.0)
        pair.set(serving_shed_rss_watermark_mb=100.0)
        rec = _one(pair.cycle(), outcome="skipped")
        assert rec["reason"] == "memory watermark: rss 4321 MB > 100 MB"
        pair.set(serving_shed_rss_watermark_mb=0.0)
        _one(pair.cycle(), decision="refresh", outcome="done")

    def test_backoff_after_an_armed_fault(self, tmp_path):
        # Each package's backoff starts at its own failed cycle; the
        # second cycle of both must fall inside both backoffs, so the
        # backoff outlasts a cycle and the cross-package check between.
        pair = _Pair(tmp_path, lifecycle_backoff_initial_s=2.0,
                     auto_recovery_enabled=True)
        _append(pair.src, start=90_000)

        def arm(pkg):
            faults = _m(pkg, "io.faults")
            faults.install(faults.FaultPlan(site="data.write", kind="eio",
                                            at=1, count=-1))

        rec = _one(pair.cycle(arm=arm), decision="refresh")
        assert rec["outcome"] == "error" and "injected" in rec["error"]
        rec = _one(pair.cycle(), index="lix")
        assert rec["outcome"] == "skipped" \
            and rec["reason"].startswith("backing off after 1 failure(s)")
        time.sleep(2.05)
        _one(pair.cycle(), decision="refresh", outcome="done")


# ---------------------------------------------------------------------------
# tests/test_lifecycle.py's cases on the port
# ---------------------------------------------------------------------------
class TestChangeDetector:
    def test_diff_triple_contract(self):
        recorded = [FileInfo("/d/a", 10, 1, 0), FileInfo("/d/b", 20, 1, 1)]
        current = [FileInfo("/d/a", 10, 1, 0), FileInfo("/d/b", 25, 2, 1),
                   FileInfo("/d/c", 5, 3, 2)]
        appended, deleted, mutated = diff_file_sets(current, recorded)
        assert {f.name for f in appended} == {"/d/b", "/d/c"}
        assert {f.name for f in deleted} == {"/d/b"}
        assert mutated == ["/d/b"]

    def test_detect_counts(self, env):
        session, hs, src = env
        entry = session.index_collection_manager.get_index("lix")
        assert detect_changes(session, entry).changed is False
        _append(src, start=10_000)
        victims = sorted(glob.glob(os.path.join(src, "*.parquet")))
        os.remove(victims[0])
        t = pq.read_table(victims[1])
        pq.write_table(t.slice(0, max(1, t.num_rows // 2)), victims[1])
        summary = detect_changes(session, entry)
        assert summary.appended == 2  # the new file and the rewrite
        assert summary.deleted == 2   # the removal and the rewrite
        assert summary.mutated == 1
        assert summary.appended_bytes > 0
        assert summary.newest_change_ms > 1e12  # epoch ms

    def test_quick_refresh_becomes_debt_not_appends(self, env):
        session, hs, src = env
        session.conf.hybrid_scan_enabled = True
        _append(src, start=20_000, n=20)
        summary = hs.refresh_index("lix", "quick")
        assert summary.mode == "quick" and summary.appended == 1
        entry = session.index_collection_manager.get_index("lix")
        change = detect_changes(session, entry)
        assert change.appended == 0
        assert change.hybrid_debt_bytes > 0


def _change(**kw) -> ChangeSummary:
    base = dict(index="i", appended=0, deleted=0, mutated=0,
                appended_bytes=0, recorded_files=10,
                recorded_bytes=1000, hybrid_debt_bytes=0)
    base.update(kw)
    return ChangeSummary(**base)


class TestPolicy:
    def _decide(self, change, *, quarantined=0, lineage=True,
                hybrid_scan=True, quick=0.1, full=0.5):
        return policy.decide_refresh(
            change, quarantined=quarantined, lineage=lineage,
            hybrid_scan=hybrid_scan, quick_append_ratio=quick,
            full_churn_ratio=full)

    def test_quarantine_outranks_everything(self):
        d = self._decide(_change(appended=9, deleted=9), quarantined=2)
        assert (d.kind, d.mode) == ("repair", "repair")

    def test_unchanged_is_a_journalable_none(self):
        d = self._decide(_change())
        assert d.kind == "none" and "unchanged" in d.reason

    def test_small_append_quick_under_hybrid(self):
        d = self._decide(_change(appended=1, appended_bytes=50))
        assert (d.kind, d.mode) == ("refresh", "quick")

    def test_append_without_hybrid_goes_incremental(self):
        d = self._decide(_change(appended=1, appended_bytes=50),
                         hybrid_scan=False)
        assert (d.kind, d.mode) == ("refresh", "incremental")

    def test_debt_beyond_budget_escalates(self):
        d = self._decide(_change(hybrid_debt_bytes=500))
        assert (d.kind, d.mode) == ("refresh", "incremental")

    def test_deletes_with_lineage_incremental(self):
        d = self._decide(_change(deleted=1))
        assert (d.kind, d.mode) == ("refresh", "incremental")

    def test_deletes_without_lineage_full(self):
        d = self._decide(_change(deleted=1), lineage=False)
        assert (d.kind, d.mode) == ("refresh", "full")

    def test_churn_threshold_full(self):
        d = self._decide(_change(appended=3, deleted=3, mutated=1))
        assert (d.kind, d.mode) == ("refresh", "full")

    def test_mutation_counts_once_in_churn(self):
        c = _change(appended=2, deleted=2, mutated=2)
        assert c.churn_ratio == pytest.approx(0.2)

    def test_advisor_disabled_without_budget(self):
        assert policy.decide_advisor(policy.AdvisorInputs(
            byte_budget=0, index_bytes={"a": 100}, cold_indexes=["a"],
            candidates=[("c", 10)])) == []

    def test_advisor_creates_within_budget_only(self):
        out = policy.decide_advisor(policy.AdvisorInputs(
            byte_budget=1000, index_bytes={"a": 500}, cold_indexes=[],
            candidates=[("big", 600), ("fits", 400)]))
        assert [(d.kind, d.index) for d in out] == [("create", "fits")]

    def test_advisor_drops_largest_cold_first_until_under_budget(self):
        out = policy.decide_advisor(policy.AdvisorInputs(
            byte_budget=1000,
            index_bytes={"hot": 600, "cold_small": 200, "cold_big": 500},
            cold_indexes=["cold_small", "cold_big"]))
        assert [(d.kind, d.index) for d in out] == [("delete", "cold_big")]


class TestRefreshSummary:
    def test_noop_refresh_returns_summary_not_exception(self, env):
        session, hs, src = env
        summary = hs.refresh_index("lix", "incremental")
        assert isinstance(summary, RefreshSummary)
        assert summary.outcome == "noop"
        assert summary.version is None
        assert (summary.appended, summary.deleted) == (0, 0)

    def test_committed_refresh_reports_counts_and_version(self, env):
        session, hs, src = env
        _append(src, start=30_000)
        summary = hs.refresh_index("lix", "incremental")
        assert summary.outcome == "ok"
        assert summary.mode == "incremental"
        assert summary.appended == 1 and summary.deleted == 0
        assert summary.version is not None
        assert session.index_collection_manager.get_index("lix") is not None

    def test_summary_surfaces_in_build_report_properties(self, env):
        session, hs, src = env
        _append(src, start=31_000)
        hs.refresh_index("lix", "incremental")
        props = hs.last_build_report().properties
        assert props["refresh_mode"] == "incremental"
        assert props["refresh_appended"] == 1
        assert props["refresh_deleted"] == 0
        assert hs.last_build_report().to_dict()["properties"] == props


class TestJournal:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def test_roundtrip_restart_and_bound(self, tmp_path):
        session = _port_session(str(tmp_path / "ix"), self.store)
        session.conf.lifecycle_journal_max_entries = 5
        for i in range(8):
            assert lifecycle_journal.append(session.conf, {
                "decision": "none", "index": f"i{i}",
                "outcome": "noop"}) is not None
        recs = lifecycle_journal.records(session.conf)
        assert len(recs) == 5  # bounded, oldest pruned
        assert [r["index"] for r in recs] == [f"i{i}" for i in range(3, 8)]
        fresh = _port_session(str(tmp_path / "ix"), self.store)
        table = Hyperspace(fresh).lifecycle_history()
        assert table.num_rows == 5
        assert table.column("decision").to_pylist() == ["none"] * 5

    def test_history_table_equals_jax(self, tmp_path):
        """One journal directory read by both packages' history tables:
        the same columns and values, both packages on the same store
        class."""
        session = _port_session(str(tmp_path / "ix"), self.store)
        lifecycle_journal.append(session.conf, {
            "cycle": 3, "decision": "refresh", "index": "a", "mode": "quick",
            "reason": "r", "outcome": "done", "wall_s": 0.25,
            "appended": 2, "deleted": None, "mutated": 0})
        lifecycle_journal.append(session.conf, {"decision": "lease",
                                                "error": "boom"})
        jconf = JAX.HyperspaceSession(system_path=str(tmp_path / "ix")).conf
        if self.store:
            jconf.log_store_class = f"hyperspace_tpu.io.log_store.{self.store}"
        want = _m(JAX, "lifecycle.journal").history_table(jconf)
        got = Hyperspace(session).lifecycle_history()
        assert got.schema == want.schema
        assert got.to_pylist() == want.to_pylist()

    def test_append_never_consumes_fault_budget(self, tmp_path):
        from hyperspace_tpu_torch.io import faults

        session = _port_session(str(tmp_path / "ix"))
        plan = faults.FaultPlan(site="store.put", kind="eio", at=1, count=1)
        faults.install(plan)
        try:
            assert lifecycle_journal.append(
                session.conf, {"decision": "none",
                               "outcome": "noop"}) is not None
            assert plan._calls == 0
        finally:
            faults.clear()


class TestMaintenanceCycle:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def test_acceptance_loop(self, tmp_path):
        """Capture on, append, one cycle: the journal shows the
        incremental refresh and the advisor's build within the budget,
        readable after a restart."""
        src = str(tmp_path / "src")
        _write_source(src)
        session = _port_session(str(tmp_path / "ix"), self.store)
        session.conf.num_buckets = NUM_BUCKETS
        session.conf.lineage_enabled = True
        session.conf.advisor_capture_enabled = True
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("lix", ["k"], ["v"]))
        session.enable_hyperspace()
        for _ in range(3):
            (session.read.parquet(src).filter(col("d") == 7)
             .select("d", "v").collect())
        entry = session.index_collection_manager.get_index("lix")
        index_bytes = sum(f.size for f in entry.content.file_infos())
        src_bytes = sum(os.path.getsize(p) for p in
                        glob.glob(os.path.join(src, "*.parquet")))
        session.conf.lifecycle_byte_budget = index_bytes + 4 * src_bytes
        _append(src, start=40_000)
        recs = hs.maintenance_cycle()
        assert any(r["decision"] == "refresh"
                   and r["mode"] == "incremental"
                   and r["outcome"] == "done"
                   and r["appended"] == 1 for r in recs), recs
        assert any(r["decision"] == "create" and r["outcome"] == "done"
                   for r in recs), recs
        names = hs.indexes().column("name").to_pylist()
        assert any(n != "lix" for n in names)
        fresh = _port_session(str(tmp_path / "ix"), self.store)
        table = Hyperspace(fresh).lifecycle_history()
        assert table.num_rows >= len(recs)
        assert "refresh" in table.column("decision").to_pylist()

    def test_did_nothing_is_journaled(self, env):
        session, hs, src = env
        recs = hs.maintenance_cycle()
        assert len(recs) == 1
        assert recs[0]["decision"] == "none"
        assert recs[0]["outcome"] == "noop"
        assert "unchanged" in recs[0]["reason"]
        assert hs.lifecycle_history().num_rows == 1

    def test_drain_parks_the_cycle(self, env):
        session, hs, src = env
        _append(src, start=41_000)
        notify_drain()
        try:
            recs = hs.maintenance_cycle()
        finally:
            clear_drain()
        assert len(recs) == 1 and recs[0]["outcome"] == "skipped"
        assert "draining" in recs[0]["reason"]
        recs = hs.maintenance_cycle()
        assert any(r["decision"] == "refresh" and r["outcome"] == "done"
                   for r in recs)

    def test_rss_watermark_sheds_the_cycle(self, env):
        session, hs, src = env
        session.conf.serving_shed_rss_watermark_mb = 1.0  # always over
        recs = hs.maintenance_cycle()
        assert recs[0]["outcome"] == "skipped"
        assert "memory watermark" in recs[0]["reason"]

    def test_failed_action_journals_error_and_backs_off(self, env):
        from hyperspace_tpu_torch.io import faults

        session, hs, src = env
        session.conf.lifecycle_backoff_initial_s = 0.15
        session.conf.auto_recovery_enabled = True
        _append(src, start=42_000)
        faults.install(faults.FaultPlan(site="data.write", kind="eio",
                                        at=1, count=-1))
        try:
            recs = hs.maintenance_cycle()
        finally:
            faults.clear()
        assert any(r["decision"] == "refresh" and r["outcome"] == "error"
                   for r in recs), recs
        recs = hs.maintenance_cycle()
        assert any("backing off" in r["reason"]
                   and r["outcome"] == "skipped" for r in recs), recs
        assert daemon_for(session).backoff_snapshot()["lix"]["failures"] == 1
        time.sleep(0.2)
        recs = hs.maintenance_cycle()
        assert any(r["decision"] == "refresh" and r["outcome"] == "done"
                   for r in recs), recs
        assert daemon_for(session).backoff_snapshot() == {}

    def test_daemon_thread_is_opt_in(self, env):
        session, hs, src = env
        with pytest.raises(HyperspaceError, match="opt-in"):
            hs.start_maintenance()
        session.conf.lifecycle_enabled = True
        session.conf.lifecycle_interval_s = 0.05
        _append(src, start=43_000)
        daemon = hs.start_maintenance()
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                recs = lifecycle_journal.records(session.conf)
                if any(r.get("decision") == "refresh"
                       and r.get("outcome") == "done" for r in recs):
                    break
                time.sleep(0.05)
            else:
                pytest.fail("daemon never refreshed the stale index")
        finally:
            hs.stop_maintenance()
        assert daemon is daemon_for(session)


# ---------------------------------------------------------------------------
# The deliberate difference: device errors propagate
# ---------------------------------------------------------------------------
def _device_errors():
    from hyperspace_tpu_torch.ops.kernels import KernelError

    return [torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                   "1024.00 TiB"),
            KernelError("nvcc failed on hash_buckets.cu")]


class TestDeviceErrorsPropagate:
    @pytest.mark.parametrize("which", [0, 1], ids=["oom", "kernel"])
    def test_cycle_journals_then_raises(self, env, monkeypatch, which):
        """The error is raised inside the refresh's hash (the wrapper the
        build calls), journaled ``error`` and raised out of
        ``maintenance_cycle``; no backoff is set, so the next cycle, with
        the card healthy again, refreshes."""
        from hyperspace_tpu_torch.ops import hash as ops_hash

        session, hs, src = env
        error = _device_errors()[which]
        calls = []

        def broken(*a, **kw):
            calls.append(1)
            raise error

        monkeypatch.setattr(ops_hash, "hash_buckets", broken)
        _append(src, start=44_000)
        with pytest.raises(type(error)) as info:
            hs.maintenance_cycle()
        assert info.value is error and calls
        recs = lifecycle_journal.records(session.conf)
        rec = _one(recs, decision="refresh")
        assert (rec["mode"], rec["outcome"]) == ("incremental", "error")
        assert rec["error"] == str(error)
        assert daemon_for(session).backoff_snapshot() == {}
        monkeypatch.undo()
        # The refresh died mid-flight: auto recovery rolls its transient
        # entry back before the next one.
        session.conf.auto_recovery_enabled = True
        _one(hs.maintenance_cycle(), decision="refresh", outcome="done")

    def test_thread_stops_and_stop_raises(self, env, monkeypatch):
        from hyperspace_tpu_torch.ops import hash as ops_hash

        session, hs, src = env
        error = _device_errors()[0]

        def broken(*a, **kw):
            raise error

        monkeypatch.setattr(ops_hash, "hash_buckets", broken)
        session.conf.lifecycle_enabled = True
        session.conf.lifecycle_interval_s = 0.05
        _append(src, start=45_000)
        daemon = hs.start_maintenance()
        deadline = time.monotonic() + 10.0
        while daemon._thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not daemon._thread.is_alive()
        n_records = len(lifecycle_journal.records(session.conf))
        time.sleep(0.15)  # a stopped thread journals nothing more
        assert len(lifecycle_journal.records(session.conf)) == n_records
        with pytest.raises(torch.OutOfMemoryError):
            hs.stop_maintenance()
        hs.stop_maintenance()  # raised once; stopping again is quiet

    def test_index_side_error_still_backs_off(self, env, monkeypatch):
        from hyperspace_tpu_torch.ops import hash as ops_hash

        session, hs, src = env

        def broken(*a, **kw):
            raise OSError(5, "read failed")

        monkeypatch.setattr(ops_hash, "hash_buckets", broken)
        _append(src, start=46_000)
        rec = _one(hs.maintenance_cycle(), decision="refresh")
        assert rec["outcome"] == "error"
        assert daemon_for(session).backoff_snapshot()["lix"]["failures"] == 1


# ---------------------------------------------------------------------------
# Mid-refresh query correctness
# ---------------------------------------------------------------------------
def _canonical(table) -> list:
    return sorted(zip(table.column("k").to_pylist(),
                      table.column("v").to_pylist()))


def _reference(paths) -> list:
    return _canonical(pq.read_table(sorted(paths), columns=["k", "v"]))


class TestMidRefreshCorrectness:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def test_reader_sees_bit_equal_answers(self, tmp_path):
        """A thread appends and refreshes incrementally while the reader
        queries (hybrid scan on, the device column cache on): whenever
        the listing is the same before and after a collect, the answer
        equals a direct read of exactly those files, so no collect reads
        columns of a version the refresh replaced."""
        src = str(tmp_path / "src")
        _write_source(src)
        session = _port_session(str(tmp_path / "ix"), self.store)
        session.conf.num_buckets = NUM_BUCKETS
        session.conf.lineage_enabled = True
        session.conf.hybrid_scan_enabled = True
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("lix", ["k"], ["v"]))
        session.enable_hyperspace()
        stop = threading.Event()
        errors: list = []

        def appender() -> None:
            try:
                for i in range(3):
                    _append(src, start=50_000 + i * 1000)
                    time.sleep(0.02)
                    hs.refresh_index("lix", "incremental")
                    time.sleep(0.02)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"appender: {e!r}")
            finally:
                stop.set()

        t = threading.Thread(target=appender, daemon=True)
        t.start()
        compares = 0
        while (not stop.is_set() or compares == 0) and not errors:
            l1 = sorted(glob.glob(os.path.join(src, "*.parquet")))
            res = (session.read.parquet(src).filter(col("k") >= 0)
                   .select("k", "v").collect())
            l2 = sorted(glob.glob(os.path.join(src, "*.parquet")))
            if l1 != l2:
                continue
            compares += 1
            assert _canonical(res) == _reference(l1)
        t.join(timeout=60)
        assert not errors, errors
        assert compares >= 1
        res = (session.read.parquet(src).filter(col("k") >= 0)
               .select("k", "v").collect())
        assert _canonical(res) == _reference(
            glob.glob(os.path.join(src, "*.parquet")))

    def test_daemon_thread_refresh_races_reads(self, tmp_path):
        """The same race with the daemon thread doing the refreshes: each
        append is refreshed by the daemon while the main thread reads."""
        src = str(tmp_path / "src")
        _write_source(src)
        session = _port_session(str(tmp_path / "ix"))
        session.conf.num_buckets = NUM_BUCKETS
        session.conf.lineage_enabled = True
        session.conf.lifecycle_enabled = True
        session.conf.lifecycle_interval_s = 0.01
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("lix", ["k"], ["v"]))
        session.enable_hyperspace()
        hs.start_maintenance()
        try:
            compares = 0
            for i in range(3):
                _append(src, start=55_000 + i * 1000)
                deadline = time.monotonic() + 10.0
                done = 0
                while done <= i and time.monotonic() < deadline:
                    l1 = sorted(glob.glob(os.path.join(src, "*.parquet")))
                    res = (session.read.parquet(src).filter(col("k") >= 0)
                           .select("k", "v").collect())
                    assert _canonical(res) == _reference(l1)
                    compares += 1
                    done = sum(1 for r in
                               lifecycle_journal.records(session.conf)
                               if r.get("decision") == "refresh"
                               and r.get("outcome") == "done")
                assert done > i, "the daemon never refreshed"
        finally:
            hs.stop_maintenance()
        assert compares >= 3


# ---------------------------------------------------------------------------
# chip_smoke's phase P, rehearsed on the CPU
# ---------------------------------------------------------------------------
    def test_cycle_converges_through_armed_store_fault(self, tmp_path):
        """Over the object-store log with a transient eio armed at
        ``store.put``, the daemon's refresh still commits (the retry
        absorbs it) and the answers stay right."""
        from hyperspace_tpu_torch.io import faults

        src = str(tmp_path / "src")
        _write_source(src)
        session = _port_session(str(tmp_path / "ix"), self.store)
        session.conf.log_manager_class = OBJECT_MANAGER
        session.conf.num_buckets = NUM_BUCKETS
        session.conf.lineage_enabled = True
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("lix", ["k"], ["v"]))
        session.enable_hyperspace()
        _append(src, start=60_000)
        plan = faults.FaultPlan(site="store.put", kind="eio", at=1, count=1)
        faults.install(plan)
        try:
            recs = hs.maintenance_cycle()
        finally:
            faults.clear()
        assert plan._calls >= 1
        assert any(r["decision"] == "refresh" and r["outcome"] == "done"
                   for r in recs), recs
        mgr = session.index_collection_manager._log_manager("lix")
        assert type(mgr).__name__ == "ObjectStoreLogManager"
        assert mgr.get_latest_stable_log().state == "ACTIVE"
        res = (session.read.parquet(src).filter(col("k") >= 0)
               .select("k", "v").collect())
        assert _canonical(res) == _reference(
            glob.glob(os.path.join(src, "*.parquet")))


class TestPosixStore:
    """The cases tests/test_lifecycle.py parametrizes by store class, on
    ``PosixLogStore``."""

    store = "PosixLogStore"
    test_roundtrip_restart_and_bound = \
        TestJournal.test_roundtrip_restart_and_bound
    test_history_table_equals_jax = TestJournal.test_history_table_equals_jax
    test_acceptance_loop = TestMaintenanceCycle.test_acceptance_loop
    test_reader_sees_bit_equal_answers = \
        TestMidRefreshCorrectness.test_reader_sees_bit_equal_answers
    test_cycle_converges_through_armed_store_fault = \
        TestMidRefreshCorrectness.test_cycle_converges_through_armed_store_fault


def test_phase_p_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase P end to end at 80,000 lineitem rows in 64 files
    (its file numbers are SF1's): every cycle's decision, mode, outcome
    and reason, the twin's digests, numpy's answers, the lease handoff,
    the watch-driven staleness and the allocation error (which the CPU
    refuses) journaled and raised.  The kernels' plain versions count no
    launch, so the launch checks run only on the card."""
    import chip_smoke

    conf_batch = HyperspaceSession(device="cpu").conf.device_batch_rows
    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 64), ("ROWS_PER_FILE", 1_250),
                        ("DEFAULT_BATCH_ROWS", conf_batch),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("P_REWRITE_DROP", 100),
                        ("PRICE_BELOW", 20_000.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    out = chip_smoke.phase_p(orders, li, root, torch.device("cpu"))
    assert [(c["decision"], c["mode"], c["outcome"]) for c in out["cycles"]] \
        == [(d, m, o) for _, d, m, o, _, _ in chip_smoke.P_CYCLES]
    assert out["advisor"]["deleted"] == chip_smoke.P_COLD
    assert "lease standby" in out["lease_standby"]
    assert out["staleness_s"] < chip_smoke.P_STALENESS_LIMIT_S
    assert out["staleness_mode"] == "incremental"
    assert out["device_error"].startswith("RuntimeError")
    assert not any(out["launches"].values())
