"""Degraded-mode querying through hyperspace_tpu_torch (on the CPU)
against the JAX package: an index whose log is torn past recovery, whose
data vanished or whose log cannot be read stops accelerating queries and
never breaks one (``conf.degraded_fallback_to_source``).

One case per case of tests/test_degraded.py, each run through both
packages over the same Parquet source and compared: answers, whether an
index was scanned, the run report's decisions, outcome,
``skipped_indexes()`` and ``degraded_reasons()``, and the exception in
strict mode.  The JAX package reports degradation through telemetry
events; the port records the same ``degraded`` decision at the same two
seams, so the comparison is of the run reports.  Left out, as they wait
for the port's telemetry (ROADMAP.md, Queue A item 9): the span timings
of ``test_run_report_names_skipped_index_and_reason`` and the metrics
registry of ``test_run_report_metrics_count_degradation`` (its count is
held to the JAX registry's instead).  ``test_erroring_store_degrades_
via_injected_faults`` runs the JAX package's object store; the port has
none (Queue A item 11), so its log listing errors instead, past the
retry budget.

Beyond the oracle: a device-side error raised inside a rule, or by the
kernel loader, propagates unchanged and degrades nothing.
"""

from __future__ import annotations

import glob
import os
import re
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.telemetry.events import (
    CollectingEventLogger,
    IndexDegradedEvent,
    set_event_logger,
)

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)


class _Side:
    def __init__(self, pkg, root, d):
        self.pkg = pkg
        self.d = d
        self.ix = os.path.join(str(root), pkg.__name__, "ix")
        if pkg is JAX:
            self.s = JAX.HyperspaceSession(system_path=self.ix)
        else:
            self.s = TORCH.HyperspaceSession(system_path=self.ix,
                                             device="cpu")
        self.s.conf.num_buckets = 2
        self.hs = pkg.Hyperspace(self.s)
        self.hs.create_index(self.s.read.parquet(d),
                             pkg.IndexConfig("dg", ["k"], ["v"]))
        self.s.enable_hyperspace()

    def ds(self):
        return (self.s.read.parquet(self.d).filter(self.pkg.col("k") == 7)
                .select("k", "v"))

    def join(self):
        col = self.pkg.col
        return (self.s.read.parquet(self.d).filter(col("k") < 5)
                .join(self.s.read.parquet(self.d), col("k") == col("k"))
                .select("k", "v"))

    def index_scanned(self) -> bool:
        return any(x["is_index"] for x in self.s.last_execution_stats["scans"])

    def corrupt_log(self) -> None:
        for f in glob.glob(os.path.join(self.ix, "dg", "_hyperspace_log",
                                        "*")):
            with open(f, "w", encoding="utf-8") as fh:
                fh.write('{"torn')
        self.s.index_collection_manager.clear_cache()


@pytest.fixture()
def sides(tmp_path):
    """Both packages' index over one small Parquet source, verified to
    accelerate a filter."""
    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(200, dtype=np.int64)),
                             "v": pa.array(np.arange(200) * 2.0)}),
                   os.path.join(d, "p.parquet"))
    out = [_Side(pkg, tmp_path, d) for pkg in PKGS]
    for side in out:
        assert side.ds().collect().column("v").to_pylist() == [14.0]
        assert side.index_scanned()
    yield out
    set_event_logger(None)
    for pkg in PKGS:
        importlib_faults(pkg).clear()


def importlib_faults(pkg):
    import importlib

    return importlib.import_module(f"{pkg.__name__}.io.faults")


_ERROR_ARGS = re.compile(r"(\w+(?:Error|Exception|Invalid))\(.*?\)(?=;|$)",
                         re.M)


def _norm(text: str) -> str:
    """An error's arguments out of a reason (each package's reader words
    the message of a missing file its own way; the type is compared)."""
    return _ERROR_ARGS.sub(r"\1(...)", text)


def _report_view(rep):
    """A run report without its timings: decisions (a quarantine's file
    paths by count, error arguments out of reasons), outcome, indexes."""
    decisions = []
    for d in rep.decisions:
        d = dict(d)
        if "files" in d:
            d["files"] = len(d["files"])
        for k in ("reason", "skipped_reason"):
            if k in d:
                d[k] = _norm(d[k])
        decisions.append(d)
    return {"decisions": decisions, "outcome": rep.outcome,
            "degraded": rep.degraded, "considered": rep.indexes_considered,
            "used": rep.indexes_used, "skipped": rep.skipped_indexes(),
            "reasons": [_norm(r) for r in rep.degraded_reasons()],
            "render": re.sub(r"files=\[.*?\]", "files=[...]",
                             _norm(rep.render().split("\n", 1)[1]))}


def test_corrupt_log_falls_back_to_source_scan(sides):
    got = []
    for side in sides:
        side.corrupt_log()
        ds = side.ds()
        out = ds.collect()
        got.append((out.column("v").to_pylist(), side.index_scanned(),
                    _report_view(ds.last_run_report())))
    assert got[1] == got[0]
    rows, scanned, view = got[1]
    assert rows == [14.0] and not scanned
    degraded = [d for d in view["decisions"] if d["kind"] == "degraded"]
    assert degraded and degraded[0]["index"] == "dg"
    assert "torn past recovery" in degraded[0]["reason"]


def test_corrupt_log_join_falls_back(sides):
    got = []
    for side in sides:
        baseline = side.join().collect()
        side.corrupt_log()
        ds = side.join()
        out = ds.collect()
        assert sorted(out.column("k").to_pylist()) == \
            sorted(baseline.column("k").to_pylist())
        got.append((sorted(out.to_pylist(), key=lambda r: (r["k"], r["v"])),
                    _report_view(ds.last_run_report())))
    assert got[1] == got[0]


def test_run_report_names_skipped_index_and_reason(sides):
    got = []
    for side in sides:
        side.corrupt_log()
        ds = side.ds()
        out = ds.collect()
        rep = ds.last_run_report()
        got.append((out.column("v").to_pylist(), _report_view(rep)))
    assert got[1] == got[0]
    view = got[1][1]
    assert view["degraded"] and view["outcome"] == "degraded"
    assert "dg" in view["skipped"]
    assert any("torn past recovery" in r for r in view["reasons"])
    assert view["used"] == []
    assert "dg" in view["render"] and "torn past recovery" in view["render"]


def test_run_report_metrics_count_degradation(sides):
    """The JAX registry's ``degraded.fallbacks`` counts the port's
    ``degraded`` decisions."""
    from hyperspace_tpu.telemetry import metrics

    counts = []
    for side in sides:
        side.corrupt_log()
        if side.pkg is JAX:
            metrics.reset()
        ds = side.ds()
        ds.collect()
        counts.append(metrics.snapshot()["degraded.fallbacks"]
                      if side.pkg is JAX else
                      len(ds.last_run_report().degraded_reasons()))
    assert counts[1] == counts[0] >= 1


def test_strict_mode_raises(sides):
    got = []
    for side in sides:
        side.corrupt_log()
        side.s.conf.degraded_fallback_to_source = False
        with pytest.raises(Exception) as ei:
            side.ds().collect()
        got.append((type(ei.value).__name__, "dg" in str(ei.value),
                    side.ds().last_run_report().outcome))
    assert got[1] == got[0] == ("DegradedIndexError", True, "error")


def test_degraded_listing_is_not_cached(sides):
    got = []
    for side in sides:
        log_dir = os.path.join(side.ix, "dg", "_hyperspace_log")
        backup = os.path.join(side.ix, "dg", "_log_backup")
        shutil.copytree(log_dir, backup)
        side.corrupt_log()
        set_event_logger(CollectingEventLogger())
        side.s.read.parquet(side.d).filter(side.pkg.col("k") == 7).collect()
        first = side.index_scanned()
        # Repaired WITHOUT clearing the cache: the degraded listing was
        # never cached.
        shutil.rmtree(log_dir)
        shutil.copytree(backup, log_dir)
        out = side.ds().collect()
        got.append((first, out.column("v").to_pylist(), side.index_scanned()))
    assert got[1] == got[0] == (False, [14.0], True)


def test_missing_index_data_degrades_rule_not_query(sides):
    got = []
    for side in sides:
        for v in glob.glob(os.path.join(side.ix, "dg", "v__=*")):
            shutil.rmtree(v)
        side.s.index_collection_manager.clear_cache()
        log = CollectingEventLogger()
        set_event_logger(log)
        ds = side.ds()
        out = ds.collect()
        view = _report_view(ds.last_run_report())
        if side.pkg is JAX:
            events = [e for e in log.events
                      if isinstance(e, IndexDegradedEvent)]
            assert events, [e.kind for e in log.events]
        got.append((out.column("v").to_pylist(), side.index_scanned(), view))
    assert got[1] == got[0]
    rows, scanned, view = got[1]
    assert rows == [14.0] and not scanned and view["degraded"]
    # The schema of the index was read by the fixture's query, so the
    # plan takes the index and its read fails at execution: containment.
    kinds = [d["kind"] for d in view["decisions"]]
    at = kinds.index("quarantine")
    assert kinds[at:at + 3] == ["quarantine", "degraded", "replan"]


def test_missing_index_data_degrades_planning(sides):
    """A session that never read the index's schema meets the vanished
    files while planning: the plan without the indexes answers, and the
    report holds the planning-stage re-plan."""
    got = []
    for side in sides:
        for v in glob.glob(os.path.join(side.ix, "dg", "v__=*")):
            shutil.rmtree(v)
        if side.pkg is JAX:
            s = JAX.HyperspaceSession(system_path=side.ix)
        else:
            s = TORCH.HyperspaceSession(system_path=side.ix, device="cpu")
        s.conf.num_buckets = 2
        s.enable_hyperspace()
        ds = s.read.parquet(side.d).filter(side.pkg.col("k") == 7) \
            .select("k", "v")
        out = ds.collect()
        got.append((out.column("v").to_pylist(),
                    any(x["is_index"] for x in s.last_execution_stats["scans"]),
                    _report_view(ds.last_run_report())))
    assert got[1] == got[0]
    rows, scanned, view = got[1]
    assert rows == [14.0] and not scanned and view["outcome"] == "degraded"
    assert {"kind": "replan", "mode": "source-fallback",
            "stage": "planning"} in view["decisions"]


def test_erroring_store_degrades_via_injected_faults(sides):
    """Reads of the index's log fail past the retry budget: the query
    still answers from the source.  Each package reads the log through
    its ``ObjectStoreLogManager`` with every ``store.read`` failing, as
    the JAX case does."""
    got = []
    for side in sides:
        faults = importlib_faults(side.pkg)
        side.s.conf.log_manager_class = (
            f"{side.pkg.__name__}.index.object_log_manager"
            ".ObjectStoreLogManager")
        plan = faults.FaultPlan(site="store.read", kind="eio", count=-1)
        side.s.index_collection_manager.clear_cache()
        faults.install(plan)
        try:
            ds = side.ds()
            out = ds.collect()
        finally:
            faults.clear()
        rep = ds.last_run_report()
        degraded = [d for d in rep.decisions if d["kind"] == "degraded"]
        got.append((out.column("v").to_pylist(), side.index_scanned(),
                    [d["index"] for d in degraded], rep.outcome,
                    rep.skipped_indexes(), plan._calls > 0))
    assert got[1] == got[0]
    assert got[1][:3] == ([14.0], False, ["dg"]) and got[1][-1]


def test_erroring_posix_log_degrades_via_injected_faults(sides):
    """The same through the default POSIX log: its pointer gone and its
    id listing failing (``io.list``, the three attempts of the budget,
    after the system path's listing), each package alike."""
    got = []
    for side in sides:
        faults = importlib_faults(side.pkg)
        os.unlink(os.path.join(side.ix, "dg", "_hyperspace_log",
                               "latestStable"))
        plan = faults.FaultPlan(site="io.list", kind="eio", at=2, count=3)
        side.s.index_collection_manager.clear_cache()
        faults.install(plan)
        try:
            ds = side.ds()
            out = ds.collect()
        finally:
            faults.clear()
        rep = ds.last_run_report()
        degraded = [d for d in rep.decisions if d["kind"] == "degraded"]
        got.append((out.column("v").to_pylist(), side.index_scanned(),
                    [d["index"] for d in degraded], rep.outcome,
                    rep.skipped_indexes()))
    assert got[1][:3] == ([14.0], False, ["dg"])
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# Beyond the oracle: what never degrades
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("error", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    "out_of_memory", "kernel_error"])
def test_a_device_error_inside_a_rule_propagates(sides, monkeypatch, error):
    """A CUDA error, torch's out-of-memory error and the kernel loader's
    ``KernelError`` raised inside a rule propagate unchanged: no rule is
    recorded as skipped, nothing is degraded, and the index stays."""
    import torch

    from hyperspace_tpu_torch.ops import kernels
    from hyperspace_tpu_torch.rules import filter_rule

    side = sides[1]
    if error == "out_of_memory":
        error = torch.OutOfMemoryError("CUDA out of memory")
    elif error == "kernel_error":
        error = kernels.KernelError("hash_buckets.cu: launch failed (700)")

    def broken(self, plan):
        raise error

    monkeypatch.setattr(filter_rule.FilterIndexRule, "apply", broken)
    ds = side.ds()
    with pytest.raises(type(error)) as ei:
        ds.collect()
    assert ei.value is error
    rep = ds.last_run_report()
    assert rep.outcome == "error" and not rep.degraded
    assert not any(d.get("skipped_reason") for d in rep.rules())
    monkeypatch.undo()
    assert side.ds().collect().column("v").to_pylist() == [14.0]
    assert side.index_scanned()


def test_an_index_side_error_inside_a_rule_degrades(sides, monkeypatch):
    """The same seam with an index-side error (a read error of index
    metadata) degrades, as in the JAX package; with the fallback off it
    propagates."""
    from hyperspace_tpu_torch.rules import filter_rule

    side = sides[1]

    def broken(self, plan):
        raise OSError(5, "injected: input/output error")

    monkeypatch.setattr(filter_rule.FilterIndexRule, "apply", broken)
    ds = side.ds()
    assert ds.collect().column("v").to_pylist() == [14.0]
    rep = ds.last_run_report()
    assert rep.outcome == "degraded" and not side.index_scanned()
    assert [d["rule"] for d in rep.rules() if d.get("skipped_reason")] == [
        "FilterIndexRule"]
    assert rep.degraded_reasons() == [
        "FilterIndexRule failed: OSError(5, 'injected: input/output error')"]
    side.s.conf.degraded_fallback_to_source = False
    with pytest.raises(OSError):
        side.ds().collect()


def test_a_device_error_while_listing_propagates(sides, monkeypatch):
    """A non-index error while the manager reads a log propagates from
    the listing too, and is not cached as a degraded listing."""
    from hyperspace_tpu_torch.index import log_manager

    side = sides[1]
    side.s.index_collection_manager.clear_cache()

    def broken(self):
        raise RuntimeError("CUDA error: device-side assert triggered")

    monkeypatch.setattr(log_manager.IndexLogManager, "get_latest_stable_log",
                        broken)
    with pytest.raises(RuntimeError, match="device-side assert"):
        side.ds().collect()
    monkeypatch.undo()
    assert side.ds().collect().column("v").to_pylist() == [14.0]
    assert side.index_scanned()
