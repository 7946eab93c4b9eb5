"""The port's SLO alert engine (hyperspace_tpu_torch/telemetry/alerts.py)
held to tests/test_alerts.py and to the JAX package's own engine.

tests/test_alerts.py's classes run here on ``cpu`` sessions of the port:
persistence over both store classes (the round trip, a firing alert
across a restart, the prune that keeps each alert's newest record, the
store-free disabled case), the end-to-end wire fault (a served workload,
an armed ``net.send`` black-hole, the fast-burn page, the incident
bundle read from a fresh session, disarm and resolve), the surfacing
(``Hyperspace.alerts()``/``alert_history()``, the ``alerts`` verb, the
heartbeat's carried alerts, the cluster doctor, the notify seam, the
doctor CLI's exit codes through ``python -m
hyperspace_tpu_torch.telemetry.doctor``) and the bench diff's directions.
The pure window math is test_torch_diagnostics.py's
``test_slo_math_equals_the_jax_package``; the chaos drill's invariant
waits for interop/chaos.py.

Then both engines side by side (TestAgainstJax): the same counter
sequence under one pinned clock gives the same transition records and
the same persisted states on both store classes, and each package reads
the other's alert log.  Besides: an incident captured with the sync
guard armed.  Every engine here is stepped by hand with ``run_once``;
every wait has its own deadline."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import types

import pytest
import torch

import hyperspace_tpu
from hyperspace_tpu.telemetry import alerts as jax_alerts
from hyperspace_tpu.telemetry import metrics as jax_metrics
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
from hyperspace_tpu_torch.telemetry import alerts, fleet, flight_recorder
from hyperspace_tpu_torch.telemetry import metrics, slo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STORES = ["PosixLogStore", "EmulatedObjectStore"]
DEADLINE_S = 20.0  # every wait for a state in this file
TINY = {
    "alerts_enabled": True,
    "alerts_interval_s": 0.05,
    "alerts_availability_target": 0.9,
    "alerts_fast_short_s": 0.2,
    "alerts_fast_long_s": 0.4,
    "alerts_fast_factor": 1.5,
    "alerts_pending_evals": 1,
    "alerts_resolve_evals": 1,
}


def _session(tmp_path, store="EmulatedObjectStore", name="sys", **fields):
    s = HyperspaceSession(system_path=str(tmp_path / name), device="cpu")
    s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
    for field, value in fields.items():
        setattr(s.conf, field, value)
    return s


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    from hyperspace_tpu_torch.io import faults

    faults.clear()
    flight_recorder.reset()
    fleet.set_serving_address("")
    fleet.set_serving_draining(False)


def _drive_to_firing(engine, bad_counter="serve.errors") -> None:
    """Tick with injected bad traffic until availability fires."""
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        metrics.inc(bad_counter, 25)
        engine.run_once()
        if engine.current_states().get("availability", {}).get("state") \
                == slo.FIRING:
            return
        time.sleep(0.08)
    raise AssertionError(f"availability never fired under {bad_counter}")


def _drive_to_resolved(engine) -> None:
    deadline = time.monotonic() + DEADLINE_S
    while time.monotonic() < deadline:
        metrics.inc("serve.ok", 50)
        engine.run_once()
        if engine.current_states().get("availability", {}).get("state") \
                != slo.FIRING:
            return
        time.sleep(0.08)
    raise AssertionError("availability never resolved after recovery")


# ---------------------------------------------------------------------------
# Persistence: both store classes, restart-proof state
# ---------------------------------------------------------------------------
class TestPersistence:
    @pytest.mark.parametrize("store", STORES)
    def test_transition_log_round_trip(self, tmp_path, store):
        s = _session(tmp_path, store)
        key = alerts.append_transition(s.conf, {
            "alert": "availability", "state": "firing",
            "prev_state": "pending", "severity": "page",
            "transition": "firing", "since": 1.0,
            "bundle_key": "b-xyz", "detail": {"why": "test"}})
        assert key is not None and key.startswith("a-")
        recs = alerts.records(s.conf)
        assert [r["alert"] for r in recs] == ["availability"]
        assert recs[0]["v"] == alerts.RECORD_VERSION == \
            jax_alerts.RECORD_VERSION
        assert recs[0]["key"] == key
        states = alerts.load_states(s.conf)
        assert states["availability"]["state"] == "firing"
        assert states["availability"]["bundle_key"] == "b-xyz"
        assert states["availability"]["detail"] == {"why": "test"}

    @pytest.mark.parametrize("store", STORES)
    def test_firing_survives_restart_and_reresolves(self, tmp_path, store):
        s1 = _session(tmp_path, store, **TINY)
        engine1 = alerts.engine_for(s1)
        _drive_to_firing(engine1)
        st = engine1.current_states()["availability"]
        assert st["state"] == slo.FIRING and st["severity"] == "page"

        # The restart: a fresh session over the same tree, a fresh engine.
        s2 = _session(tmp_path, store, **TINY)
        engine2 = alerts.engine_for(s2)
        assert engine2 is not engine1
        assert engine2.current_states()["availability"]["state"] \
            == slo.FIRING
        assert alerts.carried_alerts(s2.conf)[0]["alert"] == "availability"
        _drive_to_resolved(engine2)
        last = alerts.records(s2.conf)[-1]
        assert (last["alert"], last["transition"], last["prev_state"]) \
            == ("availability", "resolved", "firing")
        assert alerts.carried_alerts(s2.conf) == []

    def test_prune_never_drops_latest_per_alert(self, tmp_path):
        s = _session(tmp_path, alerts_max_entries=4)
        alerts.append_transition(s.conf, {
            "alert": "latency", "state": "firing", "severity": "page",
            "transition": "firing", "since": 1.0})
        for i in range(8):
            alerts.append_transition(s.conf, {
                "alert": "availability",
                "state": "firing" if i % 2 == 0 else "resolved",
                "transition": "firing" if i % 2 == 0 else "resolved",
                "since": float(i)})
        states = alerts.load_states(s.conf)
        # The latency record outlived eight newer appends: it alone
        # holds that alert's state.
        assert states["latency"]["state"] == "firing"
        assert states["availability"]["state"] == "resolved"
        assert states["availability"]["since"] == 7.0
        assert len(alerts.records(s.conf)) <= 4 + 1

    def test_carried_alerts_store_free_when_disabled(self, tmp_path):
        s = _session(tmp_path)
        alerts.append_transition(s.conf, {
            "alert": "availability", "state": "firing",
            "severity": "page", "transition": "firing", "since": 1.0})
        assert alerts.carried_alerts(s.conf) == []
        fresh = _session(tmp_path, name="other")
        assert alerts.carried_alerts(fresh.conf) == []
        assert not os.path.exists(alerts.alert_root(fresh.conf))
        s.conf.alerts_enabled = True
        assert [a["alert"] for a in alerts.carried_alerts(s.conf)] == \
            ["availability"]

    def test_engine_start_requires_opt_in(self, tmp_path):
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        s = _session(tmp_path)
        with pytest.raises(HyperspaceError, match="opt-in"):
            alerts.engine_for(s).start()
        assert alerts.maybe_start(s) is None  # never raises
        with pytest.raises(HyperspaceError, match="opt-in"):
            Hyperspace(s).start_alerting()

    def test_session_and_hyperspace_start_the_thread(self, tmp_path):
        from hyperspace_tpu_torch.config import HyperspaceConf

        conf = HyperspaceConf()
        conf.alerts_enabled = True
        conf.alerts_interval_s = 0.05
        s = HyperspaceSession(system_path=str(tmp_path / "sys"),
                              device="cpu", conf=conf)
        engine = alerts.engine_for(s)
        try:
            assert engine.running()
            e0 = metrics.registry().counter("alerts.evaluations")
            deadline = time.monotonic() + DEADLINE_S
            while metrics.registry().counter("alerts.evaluations") < e0 + 2 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert metrics.registry().counter("alerts.evaluations") >= e0 + 2
        finally:
            Hyperspace(s).stop_alerting()
        assert not engine.running()
        assert Hyperspace(s).start_alerting() is engine and engine.running()
        Hyperspace(s).stop_alerting()


# ---------------------------------------------------------------------------
# End to end: wire fault -> page -> bundle -> disarm -> resolve
# ---------------------------------------------------------------------------
class TestEndToEnd:
    def test_wire_fault_fires_bundles_and_resolves(self, tmp_path):
        from hyperspace_tpu_torch.interop import QueryServer
        from hyperspace_tpu_torch.io import faults

        s = _session(tmp_path)
        server = QueryServer(s, port=0).start()
        port = server.address[1]
        # Enabled after the start, so no thread races the ticks below.
        for field, value in TINY.items():
            setattr(s.conf, field, value)
        engine = alerts.engine_for(s)
        assert not engine.running()

        def probe(read=True):
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=2.0)
            try:
                sock.sendall(b'{"verb": "metrics"}\n')
                if read:
                    sock.recv(65536)
            finally:
                sock.close()

        try:
            for _ in range(8):
                probe()
                engine.run_once()
                time.sleep(0.08)
            assert engine.current_states().get(
                "availability", {}).get("state") != slo.FIRING

            # Every response send black-holes: each probe is one
            # serve.send_timeouts bad event.
            faults.install(faults.FaultPlan(
                site="net.send", kind="black-hole", at=1,
                count=10 ** 6, hang_s=0.01))
            deadline = time.monotonic() + DEADLINE_S
            fired_after = None
            ticks = 0
            while time.monotonic() < deadline:
                for _ in range(6):
                    try:
                        probe(read=False)
                    except OSError:
                        pass
                time.sleep(0.1)
                engine.run_once()
                ticks += 1
                if engine.current_states().get(
                        "availability", {}).get("state") == slo.FIRING:
                    fired_after = ticks
                    break
            assert fired_after is not None, "fast burn never fired"
            # The page lands once the 0.4 s long window has bad coverage.
            assert fired_after <= 1 + int(0.4 / 0.1) + 1, fired_after
            st = engine.current_states()["availability"]
            assert st["severity"] == "page"
            bundle_key = st.get("bundle_key")
            assert bundle_key, "the firing transition captured no bundle"
            faults.clear()

            deadline = time.monotonic() + DEADLINE_S
            while time.monotonic() < deadline:
                for _ in range(6):
                    probe()
                time.sleep(0.1)
                engine.run_once()
                if engine.current_states()["availability"]["state"] \
                        != slo.FIRING:
                    break
            assert engine.current_states()["availability"]["state"] \
                == slo.RESOLVED
        finally:
            faults.clear()
            server.stop()

        # A fresh session reads the incident back: the bundle parses and
        # its trace ids resolve through the federated path.
        fresh = _session(tmp_path, **TINY)
        bundle = next(b for b in flight_recorder.bundles(fresh.conf)
                      if b.get("key") == bundle_key)
        incident = bundle["incident"]
        assert incident["alert"] == "availability"
        assert incident["evaluation"]["breached"]
        assert "availability" in incident["window"]
        assert incident["doctor"]["status"] in ("ok", "warn", "crit")
        tids = [r.get("trace_id") for r in bundle.get("records", [])
                if isinstance(r, dict) and r.get("trace_id")]
        if tids:
            hit = fleet.find_trace(fresh.conf, tids[0])
            assert hit is not None and hit.get("trace_id") == tids[0]
        transitions = [r["transition"] for r in alerts.records(fresh.conf)
                       if r["alert"] == "availability"]
        assert transitions == ["firing", "resolved"]


# ---------------------------------------------------------------------------
# Surfacing: API, interop verb, federation, notify, CLI
# ---------------------------------------------------------------------------
class TestSurfacing:
    @staticmethod
    def _fired_session(tmp_path, **extra):
        s = _session(tmp_path, **TINY, **extra)
        _drive_to_firing(alerts.engine_for(s))
        return s

    def test_hyperspace_alerts_and_history(self, tmp_path):
        s = self._fired_session(tmp_path)
        hs = Hyperspace(s)
        table = hs.alerts()
        assert table.column_names == ["process", "alert", "state",
                                      "severity", "since", "bundleKey",
                                      "detailJson"]
        row = [r for r in table.to_pylist()
               if r["alert"] == "availability"][0]
        assert row["state"] == "firing" and row["severity"] == "page"
        assert row["bundleKey"].startswith("b-")
        assert json.loads(row["detailJson"])["breached"] is True
        assert sorted(table.column("alert").to_pylist()) == [
            "availability", "build_claims", "latency", "staleness"]
        hist = hs.alert_history()
        assert hist.column_names == ["key", "ts", "alert", "state",
                                     "prevState", "severity", "transition",
                                     "bundleKey", "recordJson"]
        assert "firing" in hist.column("transition").to_pylist()
        assert json.loads(hist.column("recordJson")[0].as_py())

    def test_interop_alerts_verb_inline(self, tmp_path):
        from hyperspace_tpu_torch.interop import QueryClient, QueryServer

        s = self._fired_session(tmp_path)
        try:
            with QueryServer(s) as server:
                # The start started the engine's thread (the conf is on).
                assert alerts.engine_for(s).running()
                with QueryClient(server.address) as qc:
                    table = qc.query({"verb": "alerts"})
                    assert "availability" in \
                        table.column("alert").to_pylist()
                    fleet_t = qc.query({"verb": "alerts", "fleet": True})
                    assert all(p for p in
                               fleet_t.column("process").to_pylist())
                    with pytest.raises(Exception, match="alerts"):
                        qc.query({"verb": "nonsense"})
        finally:
            alerts.engine_for(s).stop()

    def test_fleet_snapshot_carries_alerts(self, tmp_path):
        s = self._fired_session(tmp_path)
        snap = fleet.build_snapshot(s.conf)
        carried = [a for a in snap["alerts"] if a["alert"] == "availability"]
        assert carried and carried[0]["state"] == "firing"
        assert set(carried[0]) == {"alert", "state", "severity", "since",
                                   "bundle_key"}

    def test_fleet_federation_and_cluster_doctor(self, tmp_path,
                                                 monkeypatch):
        s = self._fired_session(tmp_path)
        remote = {"process": "host-2:9:deadbeef",
                  "alerts": [{"alert": "latency", "state": "firing",
                              "severity": "warn", "since": 1.0,
                              "bundle_key": "b-far"}]}
        monkeypatch.setattr(fleet, "fresh_snapshots", lambda conf: [remote])
        table = alerts.alerts_table(s, fleet=True)
        by_proc = dict(zip(table.column("alert").to_pylist(),
                           table.column("process").to_pylist()))
        assert by_proc["latency"] == "host-2:9:deadbeef"
        assert by_proc["availability"] == fleet.process_identity()

        check = alerts.fleet_alert_check(s)
        assert check.status == "crit"  # this process's firing page
        assert {a["alert"] for a in check.data["firing"]} == {
            "availability", "latency"}

    def test_notify_seam(self, tmp_path):
        sink = tmp_path / "notify.json"
        s = self._fired_session(tmp_path,
                                alerts_notify_command=f"cat > {sink}")
        deadline = time.monotonic() + DEADLINE_S
        while time.monotonic() < deadline and not (
                sink.exists() and sink.read_text()):
            time.sleep(0.05)
        payload = json.loads(sink.read_text())
        assert payload["alert"] == "availability"
        assert payload["transition"] == "firing"
        assert payload["key"] == alerts.records(s.conf)[-1]["key"]

    def test_doctor_cli_exit_codes(self, tmp_path):
        sys_path = str(tmp_path / "sys")

        def run(*args):
            return subprocess.run(
                [sys.executable, "-m", "hyperspace_tpu_torch.telemetry.doctor",
                 "--system-path", sys_path, "--device", "cpu", *args],
                capture_output=True, text=True, cwd=REPO, timeout=120,
                env=dict(os.environ, PYTHONPATH=REPO))

        ok = run("--json")
        assert ok.returncode == 0, ok.stderr
        report = json.loads(ok.stdout)
        assert report["status"] == "ok"
        assert any(c["name"] == "integrity" for c in report["checks"])

        self._fired_session(tmp_path)  # persists a firing page
        gated = run("--alerts", "--json")
        assert gated.returncode == 2, gated.stdout + gated.stderr
        report = json.loads(gated.stdout)
        assert any(c["name"] == "alerts" and c["status"] == "crit"
                   for c in report["checks"])
        # Without --alerts the local checks alone still grade ok.
        assert run().returncode == 0

    def test_alert_metrics(self, tmp_path):
        s = _session(tmp_path, **TINY)
        engine = alerts.engine_for(s)
        e0 = metrics.registry().counter("alerts.evaluations")
        b0 = metrics.registry().counter("alerts.bundles_captured")
        t0 = metrics.registry().counter("alerts.transitions")
        _drive_to_firing(engine)
        assert metrics.registry().counter("alerts.evaluations") > e0
        assert metrics.snapshot().get("alerts.firing") == 1.0
        assert metrics.registry().counter("alerts.bundles_captured") \
            == b0 + 1
        _drive_to_resolved(engine)
        assert metrics.snapshot().get("alerts.firing") == 0.0
        assert metrics.registry().counter("alerts.transitions") == t0 + 2

    def test_capture_with_the_sync_guard_armed(self, tmp_path):
        """The engine's thread makes no host conversion of a tensor: with
        the strict sync guard armed for the session's device, an incident
        (the doctor included) is captured and nothing is violated."""
        from hyperspace_tpu_torch.exceptions import DeviceSyncError
        from hyperspace_tpu_torch.execution import sync_guard

        s = _session(tmp_path, **TINY)
        engine = alerts.engine_for(s)
        s.conf.device_guard_enabled = True
        sync_guard.arm(s.conf, s.device)
        violations0 = metrics.registry().counter("guard.sync.violations")
        try:
            with pytest.raises(DeviceSyncError):
                torch.ones(()).item()  # the guard is armed
            _drive_to_firing(engine)
            carried = alerts.carried_alerts(s.conf)
        finally:
            s.conf.device_guard_enabled = False
            sync_guard.arm(s.conf)
        assert engine.current_states()["availability"]["bundle_key"]
        assert carried[0]["alert"] == "availability"
        # The deliberate .item() above is the only violation.
        assert metrics.registry().counter("guard.sync.violations") \
            == violations0 + 1


class TestBenchCompareDirections:
    def test_firing_and_ratio_are_lower_better(self):
        from hyperspace_tpu.telemetry import bench_compare as jax_bc
        from hyperspace_tpu_torch.telemetry.bench_compare import _direction

        for name in ("alerts.firing", "alerts.overhead_ratio",
                     "chaos.hedge_win_rate"):
            assert _direction(name) == jax_bc._direction(name)
        assert _direction("alerts.firing") == "lower"
        assert _direction("alerts.overhead_ratio") == "lower"
        assert _direction("chaos.hedge_win_rate") is None

    def test_unitless_lower_metric_skips_seconds_floor(self):
        from hyperspace_tpu_torch.telemetry.bench_compare import (
            RunMetrics,
            compare_runs,
        )

        base = RunMetrics(path="a", metrics={"alerts.firing": 1.0},
                          key_section={}, phases={})
        cur = RunMetrics(path="b", metrics={"alerts.firing": 2.0},
                         key_section={}, phases={})
        result = compare_runs(cur, base, threshold_pct=5.0, min_abs_s=0.5)
        assert [r["metric"] for r in result.regressions] == \
            ["alerts.firing"]


# ---------------------------------------------------------------------------
# The two engines side by side
# ---------------------------------------------------------------------------
# Per tick: serve.ok, serve.errors, serve.shed, serve.send_timeouts
# increments and serve.latency_ms observations (the SLO bound is 1000 ms).
_SEQUENCE = (
    [(50, 0, 0, 0, [10.0] * 5)] * 6          # healthy
    + [(20, 10, 0, 0, [10.0] * 3)] * 3       # errors: pending, then firing
    + [(10, 0, 5, 5, [2000.0] * 5)] * 4      # sheds, lost sends, slow
    + [(60, 0, 0, 0, [10.0] * 6)] * 2        # one good tick, then another
    + [(5, 3, 0, 0, [10.0])]                 # a relapse
    + [(80, 0, 0, 0, [10.0] * 8)] * 8        # recovery
)
_PARITY_CONF = {
    "alerts_availability_target": 0.9,
    "alerts_latency_target": 0.9,
    "alerts_fast_short_s": 0.2,
    "alerts_fast_long_s": 0.4,
    "alerts_fast_factor": 1.5,
    "alerts_slow_short_s": 0.6,
    "alerts_slow_long_s": 1.2,
    "alerts_slow_factor": 1.0,
    "alerts_pending_evals": 2,
    "alerts_resolve_evals": 2,
}


def _drive_sequence(module, metrics_mod, session, clock):
    metrics_mod.reset()
    for field, value in _PARITY_CONF.items():
        setattr(session.conf, field, value)
    engine = module.engine_for(session)
    for ok, errors, shed, lost, lat in _SEQUENCE:
        clock[0] += 0.1
        metrics_mod.inc("serve.ok", ok)
        metrics_mod.inc("serve.errors", errors)
        metrics_mod.inc("serve.shed", shed)
        metrics_mod.inc("serve.send_timeouts", lost)
        for ms in lat:
            metrics_mod.observe("serve.latency_ms", ms)
        engine.run_once()
    return engine


def _without_stamps(rec: dict) -> dict:
    return {k: v for k, v in rec.items()
            if k not in ("key", "bundle_key", "ts")}


class TestAgainstJax:
    @pytest.mark.parametrize("store", STORES)
    def test_engines_agree(self, tmp_path, store, monkeypatch):
        """Both engines over the same layout (an empty index tree) get
        the same counters under one pinned clock: the same transition
        records (alert, from, to, severity, the evaluation) and the same
        persisted states, keys and bundle keys aside."""
        js = hyperspace_tpu.HyperspaceSession(
            system_path=str(tmp_path / "jax"))
        js.conf.log_store_class = f"hyperspace_tpu.io.log_store.{store}"
        ts = _session(tmp_path, store, name="port")
        clock = [1.7e9]
        pinned = types.SimpleNamespace(time=lambda: clock[0])
        monkeypatch.setattr(jax_alerts, "time", pinned)
        monkeypatch.setattr(alerts, "time", pinned)
        try:
            _drive_sequence(jax_alerts, jax_metrics, js, clock)
            clock[0] = 1.7e9
            _drive_sequence(alerts, metrics, ts, clock)
        finally:
            jax_metrics.reset()
            metrics.reset()

        want = jax_alerts.records(js.conf)
        got = alerts.records(ts.conf)
        moves = [(r["alert"], r["prev_state"], r["state"], r["severity"])
                 for r in got]
        assert moves == [(r["alert"], r["prev_state"], r["state"],
                          r["severity"]) for r in want]
        # The sequence pends, fires, rides a one-tick recovery, resolves,
        # on both objectives it hurts.
        assert ("availability", "resolved", "pending", "page") in moves
        assert ("availability", "pending", "firing", "page") in moves
        assert ("availability", "firing", "resolved", "") in moves
        assert any(m[0] == "latency" and m[2] == "firing" for m in moves)
        assert [_without_stamps(r) for r in got] == \
            [_without_stamps(r) for r in want]
        assert all(r["bundle_key"] for r in got
                   if r["transition"] == "firing")

        def states(module, conf):
            return {name: _without_stamps(st)
                    for name, st in module.load_states(conf).items()}

        assert states(alerts, ts.conf) == states(jax_alerts, js.conf)
        # Each package reads the other's alert log.
        cross_t = _session(tmp_path, store, name="jax")
        cross_j = hyperspace_tpu.HyperspaceSession(
            system_path=str(tmp_path / "port"))
        cross_j.conf.log_store_class = f"hyperspace_tpu.io.log_store.{store}"
        assert alerts.load_states(cross_t.conf) == \
            jax_alerts.load_states(js.conf)
        assert jax_alerts.load_states(cross_j.conf) == \
            alerts.load_states(ts.conf)
        assert alerts.history_table(cross_t.conf).to_pylist() == \
            jax_alerts.history_table(js.conf).to_pylist()
