"""The port's fleet plane (hyperspace_tpu_torch/telemetry/fleet.py) held
to tests/test_fleet.py and to the JAX package's own module.

Every class of tests/test_fleet.py runs here on ``cpu`` sessions of the
port, over both store classes where the JAX case loops over them:
TestMergeSemantics, TestPublisher, TestDoctor, TestFederatedRecords,
TestInterop, TestSubprocessFleet (real port subprocesses, each wait with
its own timeout) and TestBuildClaimsCheck.

Then the two packages side by side (TestAgainstJax): ``merge_metrics``
and ``skew_ratio`` on the same inputs; ``fleet_status_table`` of each
package over a fleet directory the other wrote, equal in every column
but ``ageSeconds`` (``snapshotJson`` compared without the read-time
``age_s``); a heartbeat of each package read by the other; and the six
fleet checks over the same store contents (snapshots at fixed ``ts``, a
lease record, build claims; both modules' clocks pinned) with equal
names, statuses and data.  Besides: a publish with the sync guard armed,
and the one process identity shared by the lease holder and the
heartbeat."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.request

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu.telemetry.fleet as jax_fleet
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
from hyperspace_tpu_torch.telemetry import fleet, flight_recorder, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSIX = "hyperspace_tpu_torch.io.log_store.PosixLogStore"
EMULATED = "hyperspace_tpu_torch.io.log_store.EmulatedObjectStore"
BACKENDS = [POSIX, EMULATED]
STORES = ["PosixLogStore", "EmulatedObjectStore"]
WAIT_S = 60.0  # every child's announcement and exit

# A child process: mint a trace id, retain one interesting flight record,
# bump a test counter and publish; then exit ("once") or heartbeat until
# killed ("hold").
_CHILD = r"""
import json, os, sys, time
from hyperspace_tpu_torch import HyperspaceSession
from hyperspace_tpu_torch.interop.query import mint_trace_id
from hyperspace_tpu_torch.telemetry import fleet, flight_recorder, metrics

system_path, store_class, mode, counter, interval = sys.argv[1:6]
s = HyperspaceSession(system_path=system_path, device="cpu")
s.conf.log_store_class = store_class
s.conf.fleet_telemetry_enabled = True
s.conf.fleet_publish_interval_s = float(interval)
tid = mint_trace_id()
metrics.inc("fleet.test.queries", float(counter))
flight_recorder.record(
    s.conf, kind="spec", outcome="FAILED", latency_ms=12.5,
    trace_id=tid, request_id=mint_trace_id(), error="seeded in child")
if mode == "hold":
    fleet.publisher_for(s).start()
else:
    assert fleet.publish_once(s.conf)
print(json.dumps({"process": fleet.process_identity(), "trace": tid,
                  "pid": os.getpid(),
                  "jax": sorted(m for m in ("jax", "hyperspace_tpu")
                                if m in sys.modules)}), flush=True)
if mode == "hold":
    time.sleep(600)
"""


def _spawn(system_path, store_class, mode, counter, interval):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(system_path), store_class,
         mode, str(counter), str(interval)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)


def _read_children(procs):
    """Each child's announcement line, read with a bounded wait."""
    out = []
    for p in procs:
        box = {}
        reader = threading.Thread(
            target=lambda: box.update(line=p.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(WAIT_S)
        line = box.get("line")
        if not line:
            p.kill()
            pytest.fail(f"a child never announced itself: "
                        f"{p.communicate(timeout=WAIT_S)[1][-2000:]}")
        child = json.loads(line)
        assert child["jax"] == [], child  # the port's child imports no JAX
        out.append(child)
    return out


def _kill_all(procs):
    for p in procs:
        p.kill()
        p.wait(timeout=WAIT_S)
        for stream in (p.stdout, p.stderr):
            stream.close()


def _session(tmp_path, store_class=EMULATED, interval=30.0):
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    s.conf.log_store_class = store_class
    s.conf.fleet_publish_interval_s = interval
    return s


def _put_snapshot(conf, snap, module=fleet, store_for=None):
    """Plant a snapshot of a process this test does not spawn."""
    if store_for is None:
        from hyperspace_tpu_torch.telemetry.perf_ledger import store_for
    store = store_for(conf, module.fleet_root(conf))
    key = "hb-" + snap["process"]
    payload = json.dumps(snap, default=str).encode("utf-8")
    assert store.put_if_generation_match(key, payload,
                                         store.generation(key))


def _foreign(process, ts=None, role="client", counters=None,
             gauges=None, histograms=None, records=None,
             device_kernel_ms=None, **extra):
    return {
        "v": 1, "ts": time.time() if ts is None else ts,
        "process": process, "host": "h", "pid": 1, "role": role,
        "health": None,
        "metrics": {"counters": counters or {}, "gauges": gauges or {},
                    "histograms": histograms or {}},
        "device_kernel_ms": device_kernel_ms or {},
        "records": records or [],
        **extra,
    }


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    flight_recorder.reset()
    fleet.set_serving_draining(False)
    from hyperspace_tpu_torch.lifecycle import daemon as lifecycle_daemon

    lifecycle_daemon.clear_drain()


# ---------------------------------------------------------------------------
# Merge semantics (pure)
# ---------------------------------------------------------------------------
class TestMergeSemantics:
    def test_counters_sum_and_gauges_per_process(self):
        merged = fleet.merge_metrics([
            _foreign("a", counters={"x": 2.0, "y": 1.0},
                     gauges={"g": 5.0}),
            _foreign("b", counters={"x": 3.0}, gauges={"g": 7.0}),
        ])
        assert merged["counters"]["x"] == 5.0
        assert merged["counters"]["y"] == 1.0
        assert merged["gauges"]["g"] == {"a": 5.0, "b": 7.0}
        assert merged["processes"] == ["a", "b"]

    def test_histograms_bucket_sum_with_exemplar_carry(self):
        h1 = {"count": 2, "sum": 30.0, "min": 10.0, "max": 20.0,
              "buckets": {"10.0": 1, "25.0": 1},
              "exemplars": {"3": ["aaaa000011112222", 10.0]}}
        h2 = {"count": 1, "sum": 5.0, "min": 5.0, "max": 5.0,
              "buckets": {"5.0": 1},
              "exemplars": {"2": ["bbbb000011112222", 5.0]}}
        merged = fleet.merge_metrics([
            _foreign("a", histograms={"lat": h1}),
            _foreign("b", histograms={"lat": h2}),
        ])["histograms"]["lat"]
        assert merged["count"] == 3
        assert merged["sum"] == 35.0
        assert merged["min"] == 5.0 and merged["max"] == 20.0
        assert merged["mean"] == pytest.approx(35.0 / 3)
        assert merged["buckets"] == {"10.0": 1, "25.0": 1, "5.0": 1}
        assert merged["exemplars"]["3"] == ["aaaa000011112222", 10.0]
        assert merged["exemplars"]["2"] == ["bbbb000011112222", 5.0]

    def test_typed_snapshot_round_trips_through_json(self):
        metrics.reset()
        metrics.inc("c", 2.0)
        metrics.set_gauge("g", 1.5)
        metrics.observe("h", 3.0, exemplar="cccc000011112222")
        typed = json.loads(json.dumps(
            metrics.registry().typed_snapshot()))
        merged = fleet.merge_metrics([
            {"process": "p", "metrics": typed}])
        assert merged["counters"]["c"] == 2.0
        assert merged["gauges"]["g"] == {"p": 1.5}
        assert merged["histograms"]["h"]["count"] == 1
        assert any(ex[0] == "cccc000011112222"
                   for ex in merged["histograms"]["h"]
                   ["exemplars"].values())

    def test_skew_ratio(self):
        assert fleet.skew_ratio([100.0]) == 0.0
        assert fleet.skew_ratio([1.0, 2.0]) == 0.0  # under the floor
        assert fleet.skew_ratio([100.0, 100.0, 800.0]) == 8.0


# ---------------------------------------------------------------------------
# The snapshot and the publisher (in process)
# ---------------------------------------------------------------------------
class TestPublisher:
    def test_snapshot_shape_and_interesting_records(self, tmp_path):
        s = _session(tmp_path)
        metrics.reset()
        metrics.inc("exec.device.0.kernel_ms", 12.0)
        flight_recorder.reset()
        s.conf.flight_recorder_healthy_sample_n = 1
        flight_recorder.record(
            s.conf, kind="local", outcome="ok", latency_ms=1.0,
            trace_id="a" * 16, request_id="a" * 16)  # a healthy sample
        flight_recorder.record(
            s.conf, kind="spec", outcome="FAILED", latency_ms=1.0,
            trace_id="b" * 16, request_id="b" * 16, error="x")
        snap = fleet.build_snapshot(s.conf)
        assert snap["process"] == fleet.process_identity()
        assert snap["role"] in ("client", "daemon", "server")
        assert snap["device_kernel_ms"] == {"0": 12.0}
        assert snap["alerts"] == []
        # Only the interesting record rides the snapshot.
        assert [r["trace_id"] for r in snap["records"]] == ["b" * 16]
        assert set(snap) == set(jax_fleet.build_snapshot(
            hyperspace_tpu.HyperspaceSession(
                system_path=str(tmp_path / "jx")).conf))

    def test_publish_disabled_is_noop(self, tmp_path):
        s = _session(tmp_path)
        assert fleet.publish_once(s.conf) is False
        assert fleet.live_snapshots(s.conf) == []

    @pytest.mark.parametrize("store_class", BACKENDS)
    def test_publish_refresh_and_status(self, tmp_path, store_class):
        s = _session(tmp_path, store_class)
        s.conf.fleet_telemetry_enabled = True
        assert fleet.publish_once(s.conf)
        first = fleet.live_snapshots(s.conf)
        assert len(first) == 1
        ts1 = first[0]["ts"]
        time.sleep(0.02)
        assert fleet.publish_once(s.conf)  # the CAS refresh, same key
        snaps = fleet.live_snapshots(s.conf)
        assert len(snaps) == 1
        assert snaps[0]["ts"] > ts1
        table = fleet.fleet_status_table(s.conf)
        assert table.num_rows == 1
        assert table.column("process")[0].as_py() == \
            fleet.process_identity()
        assert table.column("fresh")[0].as_py() is True

    def test_stale_flag_and_prune(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        s.conf.fleet_telemetry_enabled = True
        _put_snapshot(s.conf, _foreign("dead-1-1", ts=time.time() - 120))
        _put_snapshot(s.conf, _foreign("old-2-2", ts=time.time() - 9000))
        table = fleet.fleet_status_table(s.conf)
        fresh = dict(zip(table.column("process").to_pylist(),
                         table.column("fresh").to_pylist()))
        assert fresh == {"dead-1-1": False, "old-2-2": False}
        # A publish prunes heartbeats past fleet_prune_after_s (600) and
        # keeps the merely stale one for the doctor.
        assert fleet.publish_once(s.conf)
        procs = set(fleet.fleet_status_table(s.conf)
                    .column("process").to_pylist())
        assert "old-2-2" not in procs
        assert "dead-1-1" in procs
        assert fleet.process_identity() in procs
        assert metrics.registry().counter("fleet.pruned") >= 1

    def test_publish_never_consumes_fault_budget(self, tmp_path):
        """A ``store.put`` fault armed for the engine is not spent by the
        fleet plane, and the publish succeeds."""
        from hyperspace_tpu_torch.io import faults

        s = _session(tmp_path)
        s.conf.fleet_telemetry_enabled = True
        plan = faults.FaultPlan(site="store.put", kind="eio", at=1,
                                count=1)
        faults.install(plan)
        try:
            assert fleet.publish_once(s.conf)
            assert plan._calls == 0
            assert fleet.live_snapshots(s.conf)
            assert plan._calls == 0
        finally:
            faults.clear()

    def test_publish_failure_never_breaks_a_query(self, tmp_path):
        """A broken fleet store costs a counter, never a query."""
        data = tmp_path / "d"
        data.mkdir()
        pq.write_table(pa.table({"a": [1, 2, 3]}), data / "f.parquet")
        s = HyperspaceSession(system_path="/proc/hs-no-such-root/ix",
                              device="cpu")
        s.conf.fleet_telemetry_enabled = True
        errors0 = metrics.registry().counter("fleet.publish.errors")
        assert fleet.publish_once(s.conf) is False
        assert metrics.registry().counter("fleet.publish.errors") \
            == errors0 + 1
        s2 = _session(tmp_path)
        s2.conf.fleet_telemetry_enabled = True
        assert s2.read.parquet(str(data)).collect().num_rows == 3

    def test_publisher_thread_start_requires_conf(self, tmp_path):
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        s = _session(tmp_path)
        with pytest.raises(HyperspaceError):
            fleet.publisher_for(s).start()
        assert fleet.maybe_start(s) is None
        s.conf.fleet_telemetry_enabled = True
        s.conf.fleet_publish_interval_s = 0.05
        pub = fleet.maybe_start(s)
        try:
            assert pub is not None and pub.running()
            deadline = time.monotonic() + 10
            while not fleet.live_snapshots(s.conf) \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert len(fleet.live_snapshots(s.conf)) == 1
        finally:
            pub.stop()
        assert not pub.running()
        assert fleet.live_snapshots(s.conf) == []  # deregistered

    def test_session_starts_the_publisher_when_the_conf_is_on(
            self, tmp_path):
        from hyperspace_tpu_torch.config import HyperspaceConf

        conf = HyperspaceConf()
        conf.log_store_class = EMULATED
        conf.fleet_telemetry_enabled = True
        conf.fleet_publish_interval_s = 0.05
        s = HyperspaceSession(system_path=str(tmp_path / "ix"),
                              device="cpu", conf=conf)
        hs = Hyperspace(s)
        try:
            assert fleet.publisher_for(s).running()
            deadline = time.monotonic() + 10
            while hs.fleet_status().num_rows == 0 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert hs.fleet_status().column("process").to_pylist() == \
                [fleet.process_identity()]
        finally:
            hs.stop_fleet_telemetry()
        assert hs.fleet_status().num_rows == 0
        assert hs.start_fleet_telemetry().running()
        hs.stop_fleet_telemetry()

    def test_role_escalates_never_lowers(self, monkeypatch):
        monkeypatch.setattr(fleet, "_role", "client")
        fleet.set_process_role("daemon")
        assert fleet.process_role() == "daemon"
        fleet.set_process_role("server")
        assert fleet.process_role() == "server"
        fleet.set_process_role("client")
        assert fleet.process_role() == "server"

    def test_publish_with_the_sync_guard_armed(self, tmp_path):
        """The heartbeat holds Python numbers only: with the strict sync
        guard armed for the session's device, a publish (here and from
        the publisher thread) makes no host conversion of a tensor."""
        from hyperspace_tpu_torch.exceptions import DeviceSyncError
        from hyperspace_tpu_torch.execution import sync_guard

        s = _session(tmp_path)
        s.conf.fleet_telemetry_enabled = True
        s.conf.fleet_publish_interval_s = 0.05
        metrics.inc("exec.device.0.kernel_ms", 3.5)
        flight_recorder.record(
            s.conf, kind="spec", outcome="FAILED", latency_ms=1.0,
            trace_id="c" * 16, request_id="c" * 16, error="x")
        s.conf.device_guard_enabled = True
        sync_guard.arm(s.conf, s.device)
        violations0 = metrics.registry().counter("guard.sync.violations")
        publishes0 = metrics.registry().counter("fleet.publishes")
        try:
            with pytest.raises(DeviceSyncError):
                torch.ones(()).item()  # the guard is armed
            assert fleet.publish_once(s.conf)
            pub = fleet.publisher_for(s).start()
            deadline = time.monotonic() + 10
            while metrics.registry().counter("fleet.publishes") \
                    < publishes0 + 3 and time.monotonic() < deadline:
                time.sleep(0.02)
            pub.stop()
        finally:
            s.conf.device_guard_enabled = False
            sync_guard.arm(s.conf)
        assert metrics.registry().counter("fleet.publishes") \
            >= publishes0 + 3
        # The deliberate .item() above is the only violation.
        assert metrics.registry().counter("guard.sync.violations") \
            == violations0 + 1
        snap = fleet.build_snapshot(s.conf)
        for kind in ("counters", "gauges"):
            assert all(type(v) is float
                       for v in snap["metrics"][kind].values())


# ---------------------------------------------------------------------------
# The doctor: one process's device skew and the fleet checks
# ---------------------------------------------------------------------------
class TestDoctor:
    def test_device_skew_check(self, tmp_path):
        s = _session(tmp_path)
        hs = Hyperspace(s)
        metrics.reset()
        metrics.inc("exec.device.0.kernel_ms", 100.0)
        metrics.inc("exec.device.1.kernel_ms", 100.0)
        metrics.inc("exec.device.2.kernel_ms", 100.0)
        check = hs.doctor().check("device_skew")
        assert check.status == "ok"
        metrics.inc("exec.device.2.kernel_ms", 900.0)  # 10x skew
        check = hs.doctor().check("device_skew")
        assert check.status == "warn"
        assert check.data["ratio"] >= 4.0
        # 0 turns the grading off.
        s.conf.doctor_device_skew_warn = 0.0
        assert hs.doctor().check("device_skew").status == "ok"
        metrics.reset()

    def test_fleet_checks_absent_without_flag(self, tmp_path):
        hs = Hyperspace(_session(tmp_path))
        assert hs.doctor().check("fleet.heartbeats") is None

    def test_heartbeat_crit_and_daemon_warn(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        report = hs.doctor(fleet=True)
        assert report.check("fleet.heartbeats").status == "ok"
        _put_snapshot(s.conf, _foreign("p1-1-1", role="daemon"))
        _put_snapshot(s.conf, _foreign("p2-2-2", role="daemon"))
        _put_snapshot(s.conf, _foreign("p3-3-3", ts=time.time() - 300))
        report = hs.doctor(fleet=True)
        hb = report.check("fleet.heartbeats")
        assert hb.status == "crit"
        assert "p3-3-3" in hb.data["stale"]
        assert report.check("fleet.daemons").status == "warn"
        assert report.status == "crit"
        snap = metrics.snapshot()
        assert snap.get("health.fleet.status") == 2.0

    def test_fleet_serving_aggregate_and_skew(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        _put_snapshot(s.conf, _foreign(
            "srv1-1-1", counters={"serve.requests": 100.0,
                                  "serve.shed": 60.0}))
        _put_snapshot(s.conf, _foreign(
            "srv2-2-2", counters={"serve.requests": 100.0},
            device_kernel_ms={"0": 100.0}))
        _put_snapshot(s.conf, _foreign(
            "srv3-3-3", device_kernel_ms={"0": 100.0}))
        _put_snapshot(s.conf, _foreign(
            "srv4-4-4", device_kernel_ms={"0": 2000.0}))
        report = hs.doctor(fleet=True)
        serving = report.check("fleet.serving")
        # 60 sheds over 200 requests, a 0.3 ratio: crit past 5x the
        # default 0.05.
        assert serving.status == "crit"
        assert serving.data["requests"] == 200
        skew = report.check("fleet.skew")
        assert skew.status == "warn"
        assert skew.data["process_ratio"] >= 4.0
        # Every process on device "0": only the per-process ratio shows
        # the straggler.
        assert skew.data["device_ratio"] == 0.0

    def test_own_lease_reads_held_by_live_process(self, tmp_path):
        """The lease holder and the heartbeat share one identity: the
        port's own lease reads "held by live process"."""
        from hyperspace_tpu_torch.lifecycle import lease

        s = _session(tmp_path, interval=30.0)
        s.conf.lifecycle_lease_enabled = True
        s.conf.fleet_telemetry_enabled = True
        held = lease.MaintenanceLease(s.conf)
        assert held.owner == fleet.process_identity() \
            == lease.process_identity()
        assert held.ensure() is True
        assert fleet.publish_once(s.conf)
        check = Hyperspace(s).doctor(fleet=True).check("fleet.daemons")
        assert check.status == "ok"
        assert "held by live process" in check.summary
        assert check.data["holder"] == fleet.process_identity()

    def test_own_firing_alert_rides_the_heartbeat_and_grades_crit(
            self, tmp_path):
        """This process's engine pages: its heartbeat carries the alert,
        and ``doctor(fleet=True)`` grades ``fleet.alerts`` crit from the
        own engine, with no other process in the fleet."""
        from hyperspace_tpu_torch.telemetry import alerts

        s = _session(tmp_path)
        for field, value in (("alerts_enabled", True),
                             ("alerts_availability_target", 0.9),
                             ("alerts_fast_short_s", 0.2),
                             ("alerts_fast_long_s", 0.4),
                             ("alerts_fast_factor", 1.5),
                             ("alerts_pending_evals", 1)):
            setattr(s.conf, field, value)
        engine = alerts.engine_for(s)
        deadline = time.monotonic() + WAIT_S
        while engine.current_states().get("availability", {}).get(
                "state") != "firing" and time.monotonic() < deadline:
            metrics.inc("serve.errors", 25)
            engine.run_once()
            time.sleep(0.08)
        s.conf.fleet_telemetry_enabled = True
        assert fleet.publish_once(s.conf)
        own = [snap for snap in fleet.fresh_snapshots(s.conf)
               if snap["process"] == fleet.process_identity()]
        assert [(a["alert"], a["state"], a["severity"])
                for a in own[0]["alerts"]] == [
            ("availability", "firing", "page")]
        check = Hyperspace(s).doctor(fleet=True).check("fleet.alerts")
        assert check.status == "crit"
        assert [(a["alert"], a["process"]) for a in check.data["firing"]] \
            == [("availability", fleet.process_identity())]

    def test_doctor_cli_fleet_flag(self, tmp_path, capsys):
        from hyperspace_tpu_torch.telemetry import doctor as doctor_mod

        s = _session(tmp_path, interval=30.0)
        _put_snapshot(s.conf, _foreign("gone-5-5", ts=time.time() - 300))
        argv = ["--system-path", str(tmp_path / "ix"), "--device", "cpu",
                "--json", "--conf", f"log_store_class={EMULATED}",
                "--conf", "fleet_publish_interval_s=30"]
        assert doctor_mod.main(argv) in (0, 1)
        local = json.loads(capsys.readouterr().out)
        assert not any(c["name"].startswith("fleet.")
                       for c in local["checks"])
        assert doctor_mod.main(argv + ["--fleet"]) == 2
        report = json.loads(capsys.readouterr().out)
        hb = [c for c in report["checks"]
              if c["name"] == "fleet.heartbeats"][0]
        assert hb["status"] == "crit" and "gone-5-5" in hb["data"]["stale"]


# ---------------------------------------------------------------------------
# Federated slow queries and traces (in process: snapshots and bundles)
# ---------------------------------------------------------------------------
class TestFederatedRecords:
    def test_union_and_precedence(self, tmp_path):
        s = _session(tmp_path)
        flight_recorder.reset()
        flight_recorder.clear_bundles(s.conf)
        flight_recorder.record(
            s.conf, kind="spec", outcome="FAILED", latency_ms=1.0,
            trace_id="1" * 16, request_id="1" * 16, error="local")
        _put_snapshot(s.conf, _foreign(
            "live-9-9", records=[{
                "ts": time.time(), "trace_id": "2" * 16,
                "request_id": "2" * 16, "kind": "sql",
                "outcome": "DEADLINE", "latency_ms": 7.0,
                "slow": True, "reason": "error", "error": "remote"}]))
        # A drained process's record survives only in its bundle.
        flight_recorder.record(
            s.conf, kind="spec", outcome="FAILED", latency_ms=1.0,
            trace_id="3" * 16, request_id="3" * 16, error="bundled")
        assert flight_recorder.dump_diagnostics(s.conf)
        table = fleet.fleet_slow_queries_table(s.conf)
        by_trace = dict(zip(table.column("traceId").to_pylist(),
                            table.column("process").to_pylist()))
        assert by_trace["1" * 16] == fleet.process_identity()
        assert by_trace["2" * 16] == "live-9-9"
        rec = fleet.find_trace(s.conf, "2" * 16)
        assert rec["process"] == "live-9-9"
        assert rec["outcome"] == "DEADLINE"
        # The local ring wins for an id it retains.
        assert fleet.find_trace(s.conf, "1" * 16)["process"] == \
            fleet.process_identity()
        # With the ring gone (a restart), the bundle still answers.
        flight_recorder.reset()
        rec = fleet.find_trace(s.conf, "3" * 16)
        assert rec is not None
        assert rec["process"].startswith("bundle-")
        assert fleet.find_trace(s.conf, "f" * 16) is None
        flight_recorder.clear_bundles(s.conf)

    def test_hyperspace_api_flags(self, tmp_path):
        s = _session(tmp_path)
        hs = Hyperspace(s)
        flight_recorder.reset()
        local = hs.slow_queries()
        assert "process" not in local.column_names
        fed = hs.slow_queries(fleet=True)
        assert "process" in fed.column_names
        assert hs.trace("e" * 16, fleet=True) is None


# ---------------------------------------------------------------------------
# Interop: the inline verb and the fleet scrape mode
# ---------------------------------------------------------------------------
class TestInterop:
    def test_fleet_status_verb_and_doctor_fleet(self, tmp_path):
        from hyperspace_tpu_torch.interop.server import (
            QueryClient,
            QueryServer,
        )

        s = _session(tmp_path)
        s.conf.fleet_telemetry_enabled = True
        assert fleet.publish_once(s.conf)
        with QueryServer(s) as server:
            with QueryClient(server.address) as qc:
                table = qc.query({"verb": "fleet_status"})
                assert fleet.process_identity() in \
                    table.column("process").to_pylist()
            with QueryClient(server.address) as qc:
                table = qc.query({"verb": "doctor", "fleet": True})
                assert "fleet.heartbeats" in \
                    table.column("check").to_pylist()

    def test_drain_deregisters_heartbeat(self, tmp_path):
        """A drained server is a planned exit: its heartbeat is deleted,
        so the fleet doctor never pages on a rolling restart."""
        from hyperspace_tpu_torch.interop.server import QueryServer

        s = _session(tmp_path)
        s.conf.fleet_telemetry_enabled = True
        s.conf.fleet_publish_interval_s = 0.05
        server = QueryServer(s).start()
        try:
            deadline = time.monotonic() + 10
            while not fleet.live_snapshots(s.conf) \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            snaps = fleet.live_snapshots(s.conf)
            assert snaps and snaps[0]["role"] == "server"
            assert snaps[0]["address"] == \
                f"{server.address[0]}:{server.address[1]}"
            server.drain(grace_s=5.0)
            assert fleet.live_snapshots(s.conf) == []
            assert Hyperspace(s).doctor(fleet=True).check(
                "fleet.heartbeats").status == "ok"
        finally:
            server.stop()

    def test_scrape_fleet_mode(self, tmp_path):
        from hyperspace_tpu_torch.interop.server import MetricsScrapeServer

        s = _session(tmp_path)
        s.conf.fleet_telemetry_enabled = True
        _put_snapshot(s.conf, _foreign(
            "peer-8-8", counters={"serve.requests": 3.0}))
        with pytest.raises(ValueError):
            MetricsScrapeServer(fleet=True)
        with MetricsScrapeServer(session=s, fleet=True) as ms:
            host, port = ms.address
            body = urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=30) \
                .read().decode("utf-8")
        assert 'process="peer-8-8"' in body
        assert f'process="{fleet.process_identity()}"' in body
        assert 'hyperspace_serve_requests{process="peer-8-8"} 3' in body


# ---------------------------------------------------------------------------
# Real port subprocesses over one tree
# ---------------------------------------------------------------------------
class TestSubprocessFleet:
    @pytest.mark.parametrize("store_class", BACKENDS)
    def test_three_process_merge_and_trace(self, tmp_path, store_class):
        """3 processes publish over the shared tree: the merged counter
        is their sum, and a trace minted in one resolves from here."""
        s = _session(tmp_path, store_class, interval=30.0)
        hs = Hyperspace(s)
        procs = [_spawn(tmp_path / "ix", store_class, "once", c, 30.0)
                 for c in (2, 3, 4)]
        try:
            children = _read_children(procs)
            for p in procs:
                assert p.wait(timeout=WAIT_S) == 0
            status = hs.fleet_status()
            assert status.num_rows == 3
            assert all(status.column("fresh").to_pylist())
            merged = hs.fleet_metrics()
            assert merged["counters"]["fleet.test.queries"] == 9.0
            for child in children:
                rec = hs.trace(child["trace"], fleet=True)
                assert rec is not None
                assert rec["process"] == child["process"]
                assert rec["error"] == "seeded in child"
        finally:
            _kill_all(procs)

    def test_acceptance_kill_flips_fleet_doctor_to_crit(self, tmp_path):
        """3 live publishers, all fresh; the counters merge; a record of
        process B resolves from here; SIGKILL B, and doctor(fleet=True)
        reads crit naming B within 2 publish intervals."""
        interval = 0.4
        s = _session(tmp_path, interval=interval)
        hs = Hyperspace(s)
        procs = [_spawn(tmp_path / "ix", EMULATED, "hold", 5, interval)
                 for _ in range(3)]
        try:
            children = _read_children(procs)
            deadline = time.monotonic() + WAIT_S
            state = {}
            while time.monotonic() < deadline:
                status = hs.fleet_status()
                fresh = dict(zip(status.column("process").to_pylist(),
                                 status.column("fresh").to_pylist()))
                merged = hs.fleet_metrics()["counters"].get(
                    "fleet.test.queries", 0.0)
                hb = hs.doctor(fleet=True).check("fleet.heartbeats")
                state = {"fresh": fresh, "merged": merged,
                         "hb": hb.status}
                if all(fresh.get(c["process"]) for c in children) \
                        and merged == 15.0 and hb.status == "ok":
                    break
                time.sleep(0.05)
            else:
                pytest.fail(f"fleet never reached steady state: {state}")
            victim = children[1]
            assert hs.trace(victim["trace"], fleet=True)["process"] \
                == victim["process"]
            os.kill(victim["pid"], signal.SIGKILL)
            t_kill = time.monotonic()
            while time.monotonic() < t_kill + 2 * interval + 2.0:
                hb = hs.doctor(fleet=True).check("fleet.heartbeats")
                if hb.status == "crit":
                    break
                time.sleep(0.05)
            assert hb.status == "crit"
            assert victim["process"] in hb.data["stale"]
            assert time.monotonic() - t_kill <= 2 * interval + 2.0
            # The dead process's record is still readable until pruned.
            assert hs.trace(victim["trace"], fleet=True) is not None
        finally:
            _kill_all(procs)

    def test_restart_mints_new_identity(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        p1 = _spawn(tmp_path / "ix", EMULATED, "once", 1, 30.0)
        p2 = None
        try:
            first = _read_children([p1])[0]
            assert p1.wait(timeout=WAIT_S) == 0
            p2 = _spawn(tmp_path / "ix", EMULATED, "once", 1, 30.0)
            second = _read_children([p2])[0]
            assert p2.wait(timeout=WAIT_S) == 0
        finally:
            _kill_all([p for p in (p1, p2) if p is not None])
        assert first["process"] != second["process"]
        procs = set(hs.fleet_status().column("process").to_pylist())
        assert {first["process"], second["process"]} <= procs
        assert hs.trace(first["trace"], fleet=True)["process"] \
            == first["process"]
        assert hs.trace(second["trace"], fleet=True)["process"] \
            == second["process"]


# ---------------------------------------------------------------------------
# The multi-host build claims check
# ---------------------------------------------------------------------------
class TestBuildClaimsCheck:
    """``fleet.build_claims`` grades leftover multi-host build claims
    against the heartbeats: expired with nobody alive is debris (warn);
    fresh with a dead holder stalls a build a whole TTL (crit)."""

    def _plant_claim(self, conf, holder, ttl_s, build="build-1-abc"):
        from hyperspace_tpu_torch.lifecycle.lease import WorkClaims
        from hyperspace_tpu_torch.parallel import multihost_build
        from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

        store = store_for(conf, os.path.join(
            multihost_build.build_root(conf), build))
        claims = WorkClaims(store, conf, owner=holder, ttl_s=ttl_s)
        assert claims.try_claim("chunk-00000") is not None

    def test_no_claims_is_ok(self, tmp_path):
        hs = Hyperspace(_session(tmp_path, interval=30.0))
        assert hs.doctor(fleet=True).check(
            "fleet.build_claims").status == "ok"

    def test_expired_claim_no_heartbeat_warns(self, tmp_path):
        from hyperspace_tpu_torch.lifecycle import journal

        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        self._plant_claim(s.conf, "dead-host-1-1", ttl_s=0.2)
        time.sleep(0.3)
        before = len(journal.records(s.conf))
        check = hs.doctor(fleet=True).check("fleet.build_claims")
        assert check.status == "warn"
        assert check.data["expired_no_heartbeat"][0]["holder"] \
            == "dead-host-1-1"
        # Read-only: grading writes nothing.
        assert len(journal.records(s.conf)) == before

    def test_fresh_claim_dead_holder_is_crit(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        self._plant_claim(s.conf, "dead-host-1-1", ttl_s=60.0)
        _put_snapshot(s.conf, _foreign("other-host-2-2"))
        check = hs.doctor(fleet=True).check("fleet.build_claims")
        assert check.status == "crit"
        assert check.data["fresh_dead_holder"][0]["item"] == "chunk-00000"

    def test_fresh_claim_heartbeating_holder_is_ok(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        self._plant_claim(s.conf, "live-host-3-3", ttl_s=60.0)
        _put_snapshot(s.conf, _foreign("live-host-3-3"))
        check = hs.doctor(fleet=True).check("fleet.build_claims")
        assert check.status == "ok"
        assert check.data["pending"] == 1

    def test_fresh_claim_without_any_heartbeats_not_crit(self, tmp_path):
        s = _session(tmp_path, interval=30.0)
        hs = Hyperspace(s)
        self._plant_claim(s.conf, "host-4-4", ttl_s=60.0)
        assert hs.doctor(fleet=True).check(
            "fleet.build_claims").status == "ok"

    def test_build_hosts_publish_heartbeats(self, tmp_path):
        """With the fleet plane on, each host subprocess of a 2-host
        build publishes a heartbeat under its own identity."""
        import numpy as np

        from hyperspace_tpu_torch import IndexConfig

        src = tmp_path / "src"
        src.mkdir()
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({"k": rng.integers(0, 500, 3000),
                                 "v": rng.random(3000)}),
                       src / "p.parquet")
        s = _session(tmp_path, interval=30.0)
        s.conf.num_buckets = 4
        s.conf.device_batch_rows = 1000
        s.conf.device_build_min_rows = 0
        s.conf.multihost_build_hosts = 2
        s.conf.multihost_build_poll_s = 0.02
        s.conf.fleet_telemetry_enabled = True
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(str(src)),
                        IndexConfig("m", ["k"], ["v"]))
        assert hs.last_build_report().properties["multihost_hosts"] == 2
        rows = [r for r in fleet.live_snapshots(s.conf)
                if r["pid"] != os.getpid()]
        assert len(rows) == 2
        assert len({r["process"] for r in rows}) == 2
        assert all(r["role"] == "client" for r in rows)


# ---------------------------------------------------------------------------
# The two packages side by side
# ---------------------------------------------------------------------------
_MERGE_CASES = {
    "counters_gauges": [
        _foreign("a", ts=1.0, counters={"x": 2.0, "y": 1.0},
                 gauges={"g": 5.0}),
        _foreign("b", ts=1.0, counters={"x": 3.0, "bad": "nan?"},
                 gauges={"g": 7.0, "h": None})],
    "histograms": [
        _foreign("a", ts=1.0, histograms={"lat": {
            "count": 2, "sum": 30.0, "min": 10.0, "max": 20.0,
            "buckets": {"10.0": 1, "25.0": 1},
            "exemplars": {"3": ["aaaa000011112222", 10.0]}}}),
        _foreign("b", ts=1.0, histograms={"lat": {
            "count": 1, "sum": 5.0, "min": 5.0, "max": 5.0,
            "buckets": {"5.0": 1, "+Inf": 0},
            "exemplars": {"2": ["bbbb000011112222", 5.0]}},
            "other": {"count": 0, "sum": 0.0, "buckets": {}}})],
    "empty": [],
    "no_metrics": [{"process": "p"}, {"metrics": None}],
}


class TestAgainstJax:
    @pytest.mark.parametrize("case", sorted(_MERGE_CASES))
    def test_merge_metrics_equal(self, case):
        snaps = _MERGE_CASES[case]
        assert fleet.merge_metrics(json.loads(json.dumps(snaps))) == \
            jax_fleet.merge_metrics(json.loads(json.dumps(snaps)))

    @pytest.mark.parametrize("values", [
        [], [100.0], [1.0, 2.0], [100.0, 100.0, 800.0], [0.0, 0.0, 90.0],
        [5.0, None, 500.0], [10.0, 20.0, 30.0, 400.0]])
    def test_skew_ratio_equal(self, values):
        assert fleet.skew_ratio(values) == jax_fleet.skew_ratio(values)

    def _pair(self, tmp_path, store: str, name: str = "ix"):
        path = str(tmp_path / name)
        js = hyperspace_tpu.HyperspaceSession(system_path=path)
        js.conf.log_store_class = f"hyperspace_tpu.io.log_store.{store}"
        js.conf.fleet_publish_interval_s = 30.0
        ts = HyperspaceSession(system_path=path, device="cpu")
        ts.conf.log_store_class = \
            f"hyperspace_tpu_torch.io.log_store.{store}"
        ts.conf.fleet_publish_interval_s = 30.0
        return js, ts

    @staticmethod
    def _table_rows(table) -> list:
        rows = table.drop(["ageSeconds"]).to_pylist()
        for row in rows:
            snap = json.loads(row["snapshotJson"])
            snap.pop("age_s")
            row["snapshotJson"] = snap
        return rows

    @pytest.mark.parametrize("store", STORES)
    def test_status_tables_equal_both_ways(self, tmp_path, store):
        """Each package's ``fleet_status_table`` over a fleet directory
        the other wrote (a real publish and planted heartbeats) equals
        the writer's own, every column but ``ageSeconds``."""
        from hyperspace_tpu.telemetry.perf_ledger import (
            store_for as jax_store_for,
        )

        planted = [
            _foreign("srv-7-7", role="server", address="127.0.0.1:9001",
                     draining=True, gauges={"health.status": 1.0},
                     records=[{"trace_id": "d" * 16}]),
            _foreign("gone-8-8", ts=time.time() - 300),
        ]
        js, ts = self._pair(tmp_path, store, "by_port")
        ts.conf.fleet_telemetry_enabled = True
        assert fleet.publish_once(ts.conf)
        for snap in planted:
            _put_snapshot(ts.conf, snap)
        by_port = fleet.fleet_status_table(ts.conf)
        assert by_port.num_rows == 3
        assert self._table_rows(jax_fleet.fleet_status_table(js.conf)) \
            == self._table_rows(by_port)

        js, ts = self._pair(tmp_path, store, "by_jax")
        js.conf.fleet_telemetry_enabled = True
        assert jax_fleet.publish_once(js.conf)
        for snap in planted:
            _put_snapshot(js.conf, snap, jax_fleet, jax_store_for)
        by_jax = jax_fleet.fleet_status_table(js.conf)
        assert by_jax.num_rows == 3
        assert self._table_rows(fleet.fleet_status_table(ts.conf)) \
            == self._table_rows(by_jax)
        assert by_jax.schema == by_port.schema

    @pytest.mark.parametrize("store", STORES)
    def test_each_reads_the_others_heartbeat(self, tmp_path, store):
        js, ts = self._pair(tmp_path, store, "port_writes")
        ts.conf.fleet_telemetry_enabled = True
        assert fleet.publish_once(ts.conf)
        got = jax_fleet.fresh_snapshots(js.conf)
        assert [s["process"] for s in got] == [fleet.process_identity()]
        assert got[0]["v"] == jax_fleet.SNAPSHOT_VERSION
        assert jax_fleet.find_trace(js.conf, "0" * 16) is None

        js, ts = self._pair(tmp_path, store, "jax_writes")
        js.conf.fleet_telemetry_enabled = True
        assert jax_fleet.publish_once(js.conf)
        got = fleet.fresh_snapshots(ts.conf)
        assert [s["process"] for s in got] == \
            [jax_fleet.process_identity()]
        merged = fleet.fleet_metrics(ts.conf)
        assert jax_fleet.process_identity() in merged["processes"]

    @pytest.mark.parametrize("store", STORES)
    def test_the_six_checks_equal(self, tmp_path, store, monkeypatch):
        """The six fleet checks of both packages over one store: fixed
        ``ts`` snapshots (a stale one, two daemons, servers with shed
        and skew, a firing page alert), the lease of one daemon, build
        claims of a live and a dead host; both modules' clocks pinned."""
        from hyperspace_tpu.lifecycle import lease as jax_lease
        from hyperspace_tpu.parallel import (
            multihost_build as jax_multihost_build,
        )
        from hyperspace_tpu.telemetry.perf_ledger import (
            store_for as jax_store_for,
        )

        js, ts = self._pair(tmp_path, store)
        js.conf.lifecycle_lease_enabled = True
        now = time.time()
        snaps = [
            _foreign("d1-1-1", ts=now - 1, role="daemon",
                     device_kernel_ms={"0": 100.0}),
            _foreign("d2-2-2", ts=now - 2, role="daemon",
                     device_kernel_ms={"0": 120.0}),
            _foreign("stale-3-3", ts=now - 300),
            _foreign("srv-4-4", ts=now - 3, role="server",
                     counters={"serve.requests": 100.0,
                               "serve.shed": 8.0},
                     histograms={"serve.latency_ms": {
                         "count": 100, "sum": 5000.0, "min": 1.0,
                         "max": 2000.0,
                         "buckets": {"50.0": 80, "2500.0": 20},
                         "exemplars": {}}},
                     device_kernel_ms={"0": 2000.0, "1": 90.0},
                     alerts=[{"alert": "latency", "state": "firing",
                              "severity": "page", "since": now - 60,
                              "bundle_key": None}]),
        ]
        for snap in snaps:
            _put_snapshot(js.conf, snap, jax_fleet, jax_store_for)
        assert jax_lease.MaintenanceLease(js.conf, owner="d1-1-1") \
            .ensure() is True
        for holder, build in (("d2-2-2", "build-1-abc"),
                              ("dead-host-9-9", "build-2-def")):
            claims = jax_lease.WorkClaims(
                jax_store_for(js.conf, os.path.join(
                    jax_multihost_build.build_root(js.conf), build)),
                js.conf, owner=holder, ttl_s=60.0)
            assert claims.try_claim("chunk-00000") is not None
        clock = types.SimpleNamespace(time=lambda: now)
        monkeypatch.setattr(jax_fleet, "time", clock)
        monkeypatch.setattr(fleet, "time", clock)

        def outcome(checks):
            return [(c.name, c.status, c.data) for c in checks]

        want = outcome(jax_fleet.fleet_checks(js))
        got = outcome(fleet.fleet_checks(ts))
        assert [c[0] for c in got] == [
            "fleet.heartbeats", "fleet.daemons", "fleet.serving",
            "fleet.skew", "fleet.build_claims", "fleet.alerts"]
        assert got == want
        assert [c[1] for c in got] == ["crit", "ok", "warn", "warn",
                                       "crit", "crit"]
