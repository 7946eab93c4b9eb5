"""Build reports in the port, held to the JAX package's
telemetry/build_report.py: for the same action over the same source,
the same outcome, phase names, bytes read and written, files written,
spill bytes and refresh properties, and bytes that equal the disk's."""

from __future__ import annotations

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
