"""Build reports in the port, held to the JAX package's
telemetry/build_report.py: for the same action over the same source,
the same outcome, phase names, bytes read and written, files written,
spill bytes and refresh properties, and bytes that equal the disk's.
Then what tests/test_build_report.py holds the JAX package to: the
metric and span export, the report of a conflict-retried action, the
perf ledger (round trip, restart, bound, fault budget, and a ledger the
port wrote read by the JAX package) and the bench regression watchdog
(telemetry/bench_compare.py)."""

from __future__ import annotations

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.actions import create as jax_create
from hyperspace_tpu.telemetry import build_report as jax_br
from hyperspace_tpu_torch.actions import create as torch_create
from hyperspace_tpu_torch.telemetry import build_report as torch_br

PKGS = (hyperspace_tpu, hyperspace_tpu_torch)


def _name(pkg) -> str:
    return "jax" if pkg is hyperspace_tpu else "torch"


def _write_source(path, n=4_000, files=4, seed=11, first=0):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = pa.table({
        "k": pa.array(rng.integers(0, max(1, n // 8), n), type=pa.int64()),
        "v": rng.random(n),
    })
    step = -(-n // files)
    for i in range(files):
        pq.write_table(t.slice(i * step, step),
                       os.path.join(path, f"part-{first + i:05d}.parquet"))


def _session(pkg, root, **conf):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, _name(pkg)), **kw)
    s.conf.num_buckets = 4
    if pkg is hyperspace_tpu:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    else:
        s.conf.device_build_min_rows = 0  # the device route
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _disk(entry, version=None):
    """(bytes, files) of an entry's index data files, all or of one
    version directory."""
    files = [f for f in entry.content.file_infos()
             if version is None or f"v__={version}" in f.name]
    return sum(os.path.getsize(f.name) for f in files), len(files)


def _view(report):
    # The prefetcher's peak depends on the read thread's timing.
    props = {k: v for k, v in report.properties.items()
             if k != "prefetch_peak_chunks"}
    return {"action": report.action, "index": report.index,
            "outcome": report.outcome, "phases": sorted(report.phases),
            "bytes_read": report.bytes_read,
            "bytes_written": report.bytes_written,
            "files_written": report.files_written,
            "spill_runs": report.spill_runs,
            "properties": props}


def _run_both(tmp_path, src, action=None, between=None, **conf):
    """A create of ``bi`` over ``src`` through each package, then
    ``between()`` once, then ``action(pkg, session, hs)`` through each;
    returns each package's last report, session and Hyperspace."""
    made = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path), **conf)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(src), pkg.IndexConfig("bi", ["k"], ["v"]))
        made[pkg] = (s, hs)
    if between is not None:
        between()
    out = {}
    for pkg, (s, hs) in made.items():
        if action is not None:
            action(pkg, s, hs)
        out[_name(pkg)] = (hs.last_build_report(), s, hs)
    return out


def test_create_reports_as_the_jax_package(tmp_path):
    src = str(tmp_path / "src")
    _write_source(src)
    out = _run_both(tmp_path, src)
    views = {n: _view(r) for n, (r, _s, _hs) in out.items()}
    assert views["torch"] == views["jax"]
    assert views["torch"]["properties"] == {"prefetch_depth": 2}
    report, s, hs = out["torch"]
    assert report.action == "CreateAction" and report.outcome == "ok"
    for phase in ("read", "kernel", "write", "sketch", "validate", "commit"):
        assert phase in report.phases, report.phases
    entry = s.index_collection_manager.get_index("bi")
    assert (report.bytes_written, report.files_written) == _disk(entry)
    assert report.bytes_read > 0 and report.spill_bytes == 0
    assert report.device_s == pytest.approx(report.phases["kernel"])
    assert report.host_s == pytest.approx(
        report.phase_total_s() - report.phases["kernel"])
    assert s.last_build_report_value is report
    assert 0.5 <= report.phase_total_s() / report.wall_s <= 1.5
    assert report.peak_rss_mb is not None
    assert report.device_live_bytes is None  # a CPU session
    d = report.to_dict()
    assert d["bytes_written"] == report.bytes_written
    assert set(d) == set(out["jax"][0].to_dict())
    assert "phase kernel" in report.render()


def test_spill_bytes_match_the_bytes_written(tmp_path, monkeypatch):
    src = str(tmp_path / "src")
    _write_source(src, n=40_000)
    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", jax_create), ("torch", torch_create)):
        real = mod._write_chunk_file

        def tee(table, path, slices, _real=real, _name=name):
            n = _real(table, path, slices)
            seen[_name].append((n, len(slices)))
            return n

        monkeypatch.setattr(mod, "_write_chunk_file", tee)
    out = _run_both(tmp_path, src, device_batch_rows=4096)
    views = {n: _view(r) for n, (r, _s, _hs) in out.items()}
    assert views["torch"] == views["jax"]
    for name, (report, s, _hs) in out.items():
        assert seen[name]
        assert report.spill_bytes == sum(n for n, _ in seen[name])
        assert report.spill_runs == sum(r for _, r in seen[name])
        assert report.phases.get("spill_route", 0) > 0
        assert report.phases.get("spill_finish", 0) > 0
        entry = s.index_collection_manager.get_index("bi")
        assert (report.bytes_written, report.files_written) == _disk(entry)
    assert out["torch"][0].spill_bytes == out["jax"][0].spill_bytes


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_refresh_reports_its_mode_diff_and_bytes(tmp_path, mode):
    src = str(tmp_path / "src")
    _write_source(src, n=2_000, files=2)

    def refresh(pkg, s, hs):
        assert hs.refresh_index("bi", mode).outcome == "ok"

    out = _run_both(tmp_path, src, refresh, between=lambda: _write_source(
        src, n=300, files=1, seed=5, first=7))
    views = {n: _view(r) for n, (r, _s, _hs) in out.items()}
    assert views["torch"] == views["jax"]
    report, s, _hs = out["torch"]
    assert {k: v for k, v in report.properties.items()
            if k.startswith("refresh")} == {
        "refresh_mode": mode, "refresh_appended": 1, "refresh_deleted": 0}
    entry = s.index_collection_manager.get_index("bi")
    assert (report.bytes_written, report.files_written) == _disk(entry, 1)


def test_noop_and_error_outcomes(tmp_path):
    src = str(tmp_path / "src")
    _write_source(src, n=500, files=1)

    def noop(pkg, s, hs):
        assert hs.refresh_index("bi", "full").outcome == "noop"

    out = _run_both(tmp_path, src, noop)
    for name, (report, _s, _hs) in out.items():
        assert report.outcome == "noop" and report.action == "RefreshAction"
        assert report.bytes_written == 0 and report.files_written == 0
        assert sorted(report.phases) == ["validate"]
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / "bad"))
        with pytest.raises(pkg.HyperspaceError):
            pkg.Hyperspace(s).create_index(
                s.read.parquet(src), pkg.IndexConfig("bad", ["nope"], []))
        report = s.last_build_report_value
        assert report.outcome == "error" and "nope" in report.error
        assert report.to_dict()["error"] == report.error


def test_optimize_reports_phases_and_bytes(tmp_path):
    src = str(tmp_path / "src")
    _write_source(src, n=40_000)

    def optimize(pkg, s, hs):
        s.conf.index_max_rows_per_file = 0
        assert hs.optimize_index("bi", "full").outcome == "ok"

    out = _run_both(tmp_path, src, optimize, num_buckets=2,
                    index_max_rows_per_file=2_000)
    views = {n: _view(r) for n, (r, _s, _hs) in out.items()}
    assert views["torch"] == views["jax"]
    report, s, _hs = out["torch"]
    assert report.action == "OptimizeAction" and report.index == "bi"
    for phase in ("read", "sort", "write", "sketch"):
        assert report.phases.get(phase, 0) > 0, report.phases
    entry = s.index_collection_manager.get_index("bi")
    assert report.bytes_read > 0
    assert (report.bytes_written, report.files_written) == _disk(entry)


def test_lifecycle_verbs_publish_process_wide(tmp_path):
    """Actions made without a session publish their report process-wide,
    as the JAX package's do; the session keeps its last action's."""
    src = str(tmp_path / "src")
    _write_source(src, n=500, files=1)
    got = {}
    for pkg, br in ((hyperspace_tpu, jax_br), (hyperspace_tpu_torch, torch_br)):
        s = _session(pkg, str(tmp_path))
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(src), pkg.IndexConfig("bi", ["k"], ["v"]))
        created = s.last_build_report_value
        seq = []
        for verb in ("delete_index", "restore_index", "delete_index",
                     "vacuum_index"):
            getattr(hs, verb)("bi")
            seq.append((br.last_report().action, br.last_report().outcome,
                        sorted(br.last_report().phases)))
        assert hs.last_build_report() is created
        got[_name(pkg)] = seq
    assert got["torch"] == got["jax"]
    assert [a for a, _o, _p in got["torch"]] == [
        "DeleteAction", "RestoreAction", "DeleteAction", "VacuumAction"]


@pytest.mark.parametrize("enabled", [True, False])
def test_profiling_switch_gates_the_memory_sampling(tmp_path, enabled):
    src = str(tmp_path / "src")
    _write_source(src, n=1_000, files=2)
    s = _session(hyperspace_tpu_torch, str(tmp_path),
                 build_profiling_enabled=enabled)
    hs = hyperspace_tpu_torch.Hyperspace(s)
    hs.create_index(s.read.parquet(src),
                    hyperspace_tpu_torch.IndexConfig("di", ["k"], ["v"]))
    report = hs.last_build_report()
    assert report is not None and report.outcome == "ok"
    assert (report.peak_rss_mb is not None) == enabled
    assert report.phases.get("kernel", 0) > 0  # phases stay on


# ---------------------------------------------------------------------------
# Export, the conflict-retried report, the switch's other gates
# ---------------------------------------------------------------------------
def test_metrics_and_span_export(tmp_path):
    from hyperspace_tpu_torch.telemetry import metrics, trace

    src = str(tmp_path / "src")
    _write_source(src, n=2_000, files=2)
    sink = trace.add_sink(trace.CollectingTraceSink())
    trace.enable_tracing()
    try:
        s = _session(hyperspace_tpu_torch, str(tmp_path))
        before = metrics.registry().counter("build.actions")
        hs = hyperspace_tpu_torch.Hyperspace(s)
        hs.create_index(s.read.parquet(src),
                        hyperspace_tpu_torch.IndexConfig("mi", ["k"], ["v"]))
    finally:
        trace.disable_tracing()
        trace.remove_sink(sink)
    assert metrics.registry().counter("build.actions") == before + 1
    assert metrics.registry().counter("build.phase.read.seconds") > 0
    action_spans = sink.find("action.CreateAction")
    assert action_spans
    names = {sp.name for sp in action_spans[-1].walk()}
    assert {"build.phase.read", "build.phase.kernel",
            "build.phase.write"} <= names, names
    assert action_spans[-1].tags["build_bytes_written"] == \
        hs.last_build_report().bytes_written


def test_report_survives_conflict_retry(tmp_path):
    from hyperspace_tpu_torch.actions.refresh import RefreshAction
    from hyperspace_tpu_torch.exceptions import ConcurrentWriteError
    from hyperspace_tpu_torch.utils.retry import RetryPolicy

    src = str(tmp_path / "src")
    _write_source(src, n=2_000, files=2)
    s = _session(hyperspace_tpu_torch, str(tmp_path))
    hs = hyperspace_tpu_torch.Hyperspace(s)
    hs.create_index(s.read.parquet(src),
                    hyperspace_tpu_torch.IndexConfig("bi", ["k"], ["v"]))
    _write_source(src, n=300, files=1, seed=5, first=7)
    mgr = s.index_collection_manager
    log_manager = mgr._log_manager("bi")
    action = RefreshAction(log_manager, mgr._data_manager("bi"), s,
                           previous=log_manager.get_latest_stable_log())
    action.concurrency_max_retries = 2
    action.conflict_backoff = RetryPolicy(max_attempts=2,
                                          initial_backoff_ms=1.0,
                                          max_backoff_ms=2.0)
    real_write = log_manager.write_log_or_raise
    fails = {"n": 1}

    def flaky_write(log_id, entry):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise ConcurrentWriteError("injected conflict")
        return real_write(log_id, entry)

    log_manager.write_log_or_raise = flaky_write
    action.run()
    report = action.build_report
    assert report.outcome == "ok"
    assert report.conflict_retries == 1
    assert report.to_dict()["conflict_retries"] == 1
    assert report.phases.get("read", 0) > 0
    assert s.last_build_report_value is report


def test_disabled_profiling_skips_export_and_ledger(tmp_path):
    from hyperspace_tpu_torch.telemetry import metrics

    src = str(tmp_path / "src")
    _write_source(src, n=2_000, files=2)
    s = _session(hyperspace_tpu_torch, str(tmp_path),
                 build_profiling_enabled=False)
    hs = hyperspace_tpu_torch.Hyperspace(s)
    before = metrics.registry().counter("build.actions")
    hs.create_index(s.read.parquet(src),
                    hyperspace_tpu_torch.IndexConfig("di", ["k"], ["v"]))
    report = hs.last_build_report()
    assert report is not None and report.peak_rss_mb is None
    assert metrics.registry().counter("build.actions") == before
    assert hs.perf_history().num_rows == 0


# ---------------------------------------------------------------------------
# The perf ledger
# ---------------------------------------------------------------------------
from hyperspace_tpu.telemetry import perf_ledger as jax_ledger  # noqa: E402
from hyperspace_tpu_torch.telemetry import perf_ledger  # noqa: E402


def test_ledger_round_trip_and_restart(tmp_path):
    src = str(tmp_path / "src")
    _write_source(src, n=2_000, files=2)
    s = _session(hyperspace_tpu_torch, str(tmp_path))
    hs = hyperspace_tpu_torch.Hyperspace(s)
    hs.create_index(s.read.parquet(src),
                    hyperspace_tpu_torch.IndexConfig("li", ["k"], ["v"]))
    hs.optimize_index("li", mode="full")
    table = hs.perf_history()
    assert table.num_rows == 2
    assert set(table.column("kind").to_pylist()) == {"action"}
    names = table.column("name").to_pylist()
    assert names == ["CreateAction(li)", "OptimizeAction(li)"]
    rec = json.loads(table.column("recordJson").to_pylist()[0])
    assert rec["fingerprint"]["num_buckets"] == 4
    assert rec["fingerprint"]["torch"] == __import__("torch").__version__
    assert "phases_s" in rec and rec["wall_s"] > 0
    s2 = _session(hyperspace_tpu_torch, str(tmp_path))
    assert hyperspace_tpu_torch.Hyperspace(s2).perf_history().num_rows == 2


def test_ledger_bounded_keeps_newest(tmp_path):
    s = _session(hyperspace_tpu_torch, str(tmp_path),
                 perf_ledger_max_entries=3)
    for i in range(6):
        perf_ledger.append(s.conf, {"kind": "bench", "name": f"s{i}",
                                    "wall_s": float(i)})
    recs = perf_ledger.records(s.conf)
    assert [r["name"] for r in recs] == ["s3", "s4", "s5"]


def test_ledger_append_never_consumes_fault_budget(tmp_path):
    from hyperspace_tpu_torch.io import faults

    s = _session(hyperspace_tpu_torch, str(tmp_path))
    plan = faults.FaultPlan(site="store.put", kind="eio", at=1, count=1)
    faults.install(plan)
    try:
        assert perf_ledger.append(s.conf, {"kind": "bench", "name": "x",
                                           "wall_s": 0.0}) is not None
        assert plan._calls == 0
    finally:
        faults.clear()


def test_ledger_disabled_appends_nothing(tmp_path):
    s = _session(hyperspace_tpu_torch, str(tmp_path),
                 perf_ledger_enabled=False)
    assert perf_ledger.append(s.conf, {"kind": "bench", "name": "x"}) is None
    assert perf_ledger.records(s.conf) == []


def test_index_listing_ignores_ledger_dir(tmp_path):
    src = str(tmp_path / "src")
    _write_source(src, n=500, files=1)
    s = _session(hyperspace_tpu_torch, str(tmp_path))
    hs = hyperspace_tpu_torch.Hyperspace(s)
    hs.create_index(s.read.parquet(src),
                    hyperspace_tpu_torch.IndexConfig("bi", ["k"], ["v"]))
    assert os.path.isdir(os.path.join(s.conf.system_path,
                                      perf_ledger.PERF_DIR))
    assert hs.indexes().column("name").to_pylist() == ["bi"]


def test_jax_package_reads_the_ports_ledger(tmp_path):
    """A ledger the port wrote reads through the JAX package's
    ``records``, with the same keys and version; both packages keep
    their default store (``EmulatedObjectStore``)."""
    src = str(tmp_path / "src")
    _write_source(src, n=1_000, files=2)
    out = _run_both(tmp_path, src)
    torch_s, jax_s = out["torch"][1], out["jax"][1]
    assert perf_ledger.RECORD_VERSION == jax_ledger.RECORD_VERSION
    mine = perf_ledger.records(torch_s.conf)
    theirs = jax_ledger.records(jax_s.conf,
                                root=perf_ledger.perf_root(torch_s.conf))
    assert theirs == mine and len(mine) == 1
    reference = jax_ledger.records(jax_s.conf)
    assert len(reference) == 1
    assert set(mine[0]) == set(reference[0])
    # The environment half of the fingerprint names torch, not jax.
    extra = set(mine[0]["fingerprint"]) - set(reference[0]["fingerprint"])
    assert {"torch", "cuda"} <= extra <= {"torch", "cuda", "device_name"}
    assert mine[0]["v"] == reference[0]["v"] == jax_ledger.RECORD_VERSION
    assert mine[0]["name"] == reference[0]["name"] == "CreateAction(bi)"
    assert mine[0]["phases_s"].keys() == reference[0]["phases_s"].keys()


# ---------------------------------------------------------------------------
# The regression watchdog (telemetry/bench_compare.py)
# ---------------------------------------------------------------------------
from hyperspace_tpu.telemetry import bench_compare as jax_compare  # noqa: E402
from hyperspace_tpu_torch.telemetry import bench_compare  # noqa: E402


def _write_results(path, sections) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"bench": "hyperspace-tpu"}) + "\n")
        for rec in sections:
            f.write(json.dumps(rec) + "\n")
    return str(path)


def _sections(filter_median=0.01, speedup=4.0, build_s=2.0,
              spill_route=1.0, scan_median=2.0):
    return [
        {"section": "setup", "status": "ok", "elapsed_s": 3.0,
         "index_build_s": build_s,
         "index_build_phases": [
             {"index": "li_idx", "read_s": 0.5,
              "spill_route_s": spill_route, "write_s": 0.4}]},
        {"section": "sf1_queries", "status": "ok", "elapsed_s": 2.0,
         "filter_scan_s": {"median": scan_median, "min": scan_median,
                           "max": scan_median, "reps": 3},
         "filter_indexed_s": {"median": filter_median,
                              "min": filter_median, "max": filter_median,
                              "reps": 3},
         "filter_speedup": speedup},
    ]


class TestBenchCompare:
    def test_identical_runs_no_regression(self, tmp_path):
        a = _write_results(tmp_path / "a.jsonl", _sections())
        b = _write_results(tmp_path / "b.jsonl", _sections())
        result, report = bench_compare.compare_files(a, b, 25.0, 0.0)
        assert result.ok and result.compared >= 3
        assert "no regression" in report

    def test_timing_regression_flagged_with_attribution(self, tmp_path):
        base = _write_results(tmp_path / "base.jsonl", _sections())
        cur = _write_results(tmp_path / "cur.jsonl",
                             _sections(build_s=5.0, spill_route=4.0))
        result, report = bench_compare.compare_files(cur, base, 25.0, 0.1)
        assert not result.ok
        assert "index_build_s" in {r["metric"] for r in result.regressions}
        assert result.regressions[0]["section"] == "setup"
        assert "per-phase attribution" in report
        assert "spill_route" in report
        assert "+3.000" in report

    def test_speedup_regression_flagged(self, tmp_path):
        base = _write_results(tmp_path / "base.jsonl",
                              _sections(speedup=8.0))
        cur = _write_results(tmp_path / "cur.jsonl", _sections(speedup=4.0))
        result, _report = bench_compare.compare_files(cur, base, 25.0, 0.5)
        assert any(r["metric"] == "filter_speedup"
                   for r in result.regressions)

    def test_ratio_noise_guard_uses_reference_seconds(self, tmp_path):
        base = _write_results(tmp_path / "base.jsonl",
                              _sections(speedup=8.0, scan_median=0.004))
        cur = _write_results(tmp_path / "cur.jsonl",
                             _sections(speedup=4.0, scan_median=0.004))
        result, _ = bench_compare.compare_files(cur, base, 25.0, 0.5)
        assert not any(r["metric"] == "filter_speedup"
                       for r in result.regressions)

    def test_abs_floor_suppresses_toy_noise(self, tmp_path):
        base = _write_results(tmp_path / "base.jsonl",
                              _sections(filter_median=0.01))
        cur = _write_results(tmp_path / "cur.jsonl",
                             _sections(filter_median=0.02))
        result, _ = bench_compare.compare_files(cur, base, 25.0, 0.5)
        assert not any(r["metric"].startswith("filter_indexed_s")
                       for r in result.regressions)
        result2, _ = bench_compare.compare_files(cur, base, 25.0, 0.0)
        assert any(r["metric"] == "filter_indexed_s.median"
                   for r in result2.regressions)

    def test_missing_baseline_raises(self, tmp_path):
        cur = _write_results(tmp_path / "cur.jsonl", _sections())
        with pytest.raises(bench_compare.BaselineError):
            bench_compare.compare_files(cur, str(tmp_path / "nope.jsonl"))

    def test_headline_shaped_baseline_loads(self, tmp_path):
        headline = {"metric": "tpch_sf1_indexed_query_speedup_geomean",
                    "value": 4.5, "unit": "x", "vs_baseline": 4.5,
                    "detail": {"filter_speedup": 4.0,
                               "index_build_s": 2.0,
                               "platform": "cpu"}}
        base = tmp_path / "BENCH_rXX.json"
        base.write_text(json.dumps(headline))
        cur = _write_results(tmp_path / "cur.jsonl",
                             _sections(speedup=1.0, build_s=2.0))
        result, _ = bench_compare.compare_files(str(cur), str(base),
                                                25.0, 0.5)
        assert any(r["metric"] == "filter_speedup"
                   for r in result.regressions)

    @pytest.mark.parametrize("cur_kw", [{}, {"build_s": 5.0,
                                             "spill_route": 4.0},
                                        {"speedup": 1.0}])
    def test_reports_equal_the_jax_package(self, tmp_path, cur_kw):
        base = _write_results(tmp_path / "base.jsonl", _sections())
        cur = _write_results(tmp_path / "cur.jsonl", _sections(**cur_kw))
        mine = bench_compare.compare_files(cur, base, 25.0, 0.1)
        theirs = jax_compare.compare_files(cur, base, 25.0, 0.1)
        assert mine[1] == theirs[1]
        assert mine[0].regressions == theirs[0].regressions
