"""The serving side of the port's fleet plane held to
tests/test_fleet_serving.py: ``TestFrontDoor::test_draining_row_skipped``
and the less-loaded fresh row preferred (the front door routing on fleet
rows), ``TestDrainingHeartbeat`` (a drain flags its heartbeat draining,
then deregisters it), ``TestDaemonsCheck`` (the lease-aware
``fleet.daemons`` check, each grade also held to the JAX package's over
the same store) and ``TestFleetChurn`` (port servers in subprocesses on
the CPU behind one ``FleetQueryClient``: a SIGKILL mid-burst loses no
request, a SIGTERM drain is a planned exit).

Where the JAX case holds a worker with an 8-million-row group-by, this
file holds it with a gate the test opens, not with wall time."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu.telemetry.fleet as jax_fleet
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
from hyperspace_tpu_torch.interop import (
    FleetQueryClient,
    QueryClient,
    QueryServer,
)
from hyperspace_tpu_torch.interop import server as server_mod
from hyperspace_tpu_torch.telemetry import fleet, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 60.0  # every join, wait and child announcement in this file


def _counter(name):
    return metrics.registry().counter(name)


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    from hyperspace_tpu_torch.lifecycle import daemon as lifecycle_daemon

    lifecycle_daemon.clear_drain()
    fleet.set_serving_draining(False)


@pytest.fixture()
def env(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    rng = np.random.default_rng(11)
    n = 1000
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(0, 100, n), type=pa.int64()),
    }), os.path.join(data, "f.parquet"))
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    s.conf.num_buckets = 4
    return s, data


def _point_spec(data, k):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "==", "col": "k", "value": int(k)},
            "select": ["k", "v"]}


def _row(srv_or_label, draining=False, load=0.0, process=None):
    label = srv_or_label if isinstance(srv_or_label, str) else \
        f"{srv_or_label.address[0]}:{srv_or_label.address[1]}"
    return {"v": 1, "ts": time.time(),
            "process": process or f"p-{label.rsplit(':', 1)[1]}",
            "host": "h", "pid": 1, "role": "server", "health": None,
            "address": label, "draining": draining,
            "metrics": {"counters": {},
                        "gauges": {"serve.inflight": load,
                                   "serve.queue_depth": 0.0},
                        "histograms": {}},
            "device_kernel_ms": {}, "records": []}


def _plant(conf, snap):
    from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

    store = store_for(conf, fleet.fleet_root(conf))
    key = "hb-" + snap["process"]
    assert store.put_if_generation_match(
        key, json.dumps(snap).encode(), store.generation(key))


# ---------------------------------------------------------------------------
# The front door routes on fleet rows
# ---------------------------------------------------------------------------
class TestFrontDoor:
    def test_draining_row_skipped(self, env):
        """A draining server's row says so and the router stops picking
        it: requests go to the survivor instead of bouncing off BUSY."""
        s, data = env
        s.conf.fleet_publish_interval_s = 30.0
        with QueryServer(s) as a, QueryServer(s) as b:
            _plant(s.conf, _row(a, draining=True))
            _plant(s.conf, _row(b, draining=False))
            with FleetQueryClient([a.address, b.address],
                                  conf=s.conf) as fc:
                for k in range(6):
                    assert fc.query(_point_spec(data, k)) \
                        .column("k").to_pylist() == [k]
                assert fc._endpoints[0].draining is True
                assert fc._endpoints[1].draining is False
                # Every request went around the draining endpoint.
                assert fc._endpoints[0].inflight == 0
                assert not fc._endpoints[0].idle

    def test_less_loaded_fresh_row_preferred(self, env):
        """The published load decides: the endpoint whose row reports 9
        in flight gets nothing while the other reports 0; a row gone
        stale leaves both routable on local counts."""
        s, data = env
        s.conf.fleet_publish_interval_s = 30.0
        with QueryServer(s) as a, QueryServer(s) as b:
            _plant(s.conf, _row(a, load=9.0))
            _plant(s.conf, _row(b, load=0.0))
            with FleetQueryClient([a.address, b.address], conf=s.conf,
                                  status_refresh_s=0.0) as fc:
                picks = {ep.label: 0 for ep in fc._endpoints}
                real_pick = fc._pick

                def pick(*args, **kw):
                    ep = real_pick(*args, **kw)
                    picks[ep.label] += 1
                    return ep

                fc._pick = pick
                for k in range(8):
                    assert fc.query(_point_spec(data, k)) \
                        .column("k").to_pylist() == [k]
                assert fc._endpoints[0].load == 9.0
                assert picks == {fc._endpoints[0].label: 0,
                                 fc._endpoints[1].label: 8}
                # Both rows stale: routing falls back to local counts.
                stale = dict(_row(a, load=9.0), ts=time.time() - 600)
                _plant(s.conf, stale)
                _plant(s.conf, dict(_row(b), ts=time.time() - 600))
                for k in range(8):
                    fc.query(_point_spec(data, k))
                assert fc._endpoints[0].load is None
                assert picks[fc._endpoints[0].label] >= 1

    def test_refresh_is_throttled_and_needs_a_conf(self, env,
                                                   monkeypatch):
        s, _data = env
        calls = []
        real = fleet.fresh_snapshots

        def counting(conf):
            calls.append(conf)
            return real(conf)

        monkeypatch.setattr(fleet, "fresh_snapshots", counting)
        fc = FleetQueryClient(["127.0.0.1:1"], conf=s.conf,
                              status_refresh_s=60.0)
        for _ in range(5):
            fc._pick(set())
        assert len(calls) == 1
        FleetQueryClient(["127.0.0.1:1"])._pick(set())
        assert len(calls) == 1


# ---------------------------------------------------------------------------
# A drain publishes a draining heartbeat during its grace window
# ---------------------------------------------------------------------------
class _Gate:
    """Holds served queries over one source until the test opens it."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.opened = threading.Event()
        self.reached = threading.Event()

    def wrap(self, fn):
        def gated():
            self.reached.set()
            if not self.opened.wait(BOUND_S):
                raise TimeoutError("the test never opened the gate")
            return fn()
        return gated


@pytest.fixture()
def gate(tmp_path, monkeypatch):
    slow = str(tmp_path / "slow")
    os.makedirs(slow)
    pq.write_table(pa.table({"g": pa.array(np.arange(50) % 5),
                             "x": pa.array(np.arange(50) * 0.5)}),
                   os.path.join(slow, "p.parquet"))
    g = _Gate(slow)
    real = server_mod._Responder._make_query_fn

    def make(self, spec):
        fn, kind = real(self, spec)
        source = spec.get("source")
        if isinstance(source, dict) and source.get("path") == g.path:
            return g.wrap(fn), kind
        return fn, kind

    monkeypatch.setattr(server_mod._Responder, "_make_query_fn", make)
    yield g
    g.opened.set()  # never leave a worker waiting


class TestDrainingHeartbeat:
    def test_drain_flags_row_then_deregisters(self, env, gate):
        s, _data = env
        s.conf.fleet_telemetry_enabled = True
        s.conf.fleet_publish_interval_s = 0.2
        server = QueryServer(s).start()
        try:
            addr = f"{server.address[0]}:{server.address[1]}"
            done = {}

            def slow():
                with QueryClient(server.address, timeout_s=BOUND_S) as c:
                    done["t"] = c.query({
                        "source": {"format": "parquet", "path": gate.path},
                        "group_by": ["g"], "aggs": {"t": ["x", "sum"]},
                        "sort": [["g", True]]})

            t = threading.Thread(target=slow, daemon=True)
            t.start()
            assert gate.reached.wait(BOUND_S)  # in flight: drain waits
            drainer = threading.Thread(
                target=lambda: done.update(
                    clean=server.drain(grace_s=BOUND_S)), daemon=True)
            drainer.start()
            # In the grace window the heartbeat reads draining=True.
            deadline = time.monotonic() + 10
            row = None
            while time.monotonic() < deadline:
                rows = [r for r in fleet.fresh_snapshots(s.conf)
                        if r.get("address") == addr]
                if rows and rows[0].get("draining"):
                    row = rows[0]
                    break
                time.sleep(0.05)
            assert row is not None, "no draining heartbeat published"
            assert row["role"] == "server"
            gate.opened.set()
            t.join(timeout=BOUND_S)
            drainer.join(timeout=BOUND_S)
            assert done["clean"] is True
            assert done["t"].column("g").to_pylist() == [0, 1, 2, 3, 4]
            # A finished drain is a planned exit: deregistered.
            assert all(r.get("address") != addr
                       for r in fleet.live_snapshots(s.conf))
        finally:
            server.stop()
            s.conf.fleet_telemetry_enabled = False


# ---------------------------------------------------------------------------
# The lease-aware fleet.daemons check
# ---------------------------------------------------------------------------
class TestDaemonsCheck:
    def _foreign(self, process, role="server"):
        return {"v": 1, "ts": time.time(), "process": process,
                "host": "h", "pid": 1, "role": role, "health": None,
                "address": "", "draining": False,
                "metrics": {"counters": {}, "gauges": {},
                            "histograms": {}},
                "device_kernel_ms": {}, "records": []}

    def _session(self, tmp_path, ttl=30.0):
        s = HyperspaceSession(system_path=str(tmp_path / "ix"),
                              device="cpu")
        s.conf.fleet_publish_interval_s = 30.0
        s.conf.lifecycle_lease_enabled = True
        s.conf.lifecycle_lease_ttl_s = ttl
        return s

    def _check(self, s):
        """The port's ``fleet.daemons``, held to the JAX package's over
        the same store (both on their default ``EmulatedObjectStore``)."""
        check = Hyperspace(s).doctor(fleet=True).check("fleet.daemons")
        js = hyperspace_tpu.HyperspaceSession(
            system_path=s.conf.system_path)
        js.conf.fleet_publish_interval_s = 30.0
        want = [c for c in jax_fleet.fleet_checks(js)
                if c.name == "fleet.daemons"][0]
        assert (check.status, check.data) == (want.status, want.data)
        return check

    def test_crit_when_holder_has_no_heartbeat(self, tmp_path):
        from hyperspace_tpu_torch.lifecycle import lease

        s = self._session(tmp_path)
        held = lease.MaintenanceLease(s.conf, owner="ghost-9-9")
        assert held.ensure() is True
        _plant(s.conf, self._foreign("live-1-1"))
        check = self._check(s)
        assert check.status == "crit"
        assert "ghost-9-9" in check.summary
        assert check.data["holder"] == "ghost-9-9"

    def test_ok_when_holder_is_live(self, tmp_path):
        from hyperspace_tpu_torch.lifecycle import lease

        s = self._session(tmp_path)
        held = lease.MaintenanceLease(s.conf, owner="live-1-1")
        assert held.ensure() is True
        _plant(s.conf, self._foreign("live-1-1"))
        _plant(s.conf, self._foreign("standby-2-2", role="daemon"))
        check = self._check(s)
        assert check.status == "ok"
        assert check.data["holder"] == "live-1-1"

    def test_warn_when_expired_with_candidates(self, tmp_path):
        from hyperspace_tpu_torch.lifecycle import lease

        s = self._session(tmp_path, ttl=0.2)
        held = lease.MaintenanceLease(s.conf, owner="was-1-1")
        assert held.ensure() is True
        time.sleep(0.3)  # the lease expires un-renewed
        _plant(s.conf, self._foreign("cand-2-2", role="daemon"))
        check = self._check(s)
        assert check.status == "warn"
        assert "takeover" in check.summary

    def test_legacy_warn_without_lease_preserved(self, tmp_path):
        s = self._session(tmp_path)
        s.conf.lifecycle_lease_enabled = False
        _plant(s.conf, self._foreign("d1-1-1", role="daemon"))
        _plant(s.conf, self._foreign("d2-2-2", role="daemon"))
        check = self._check(s)
        assert check.status == "warn"
        assert "lease" in check.summary

    def test_a_started_daemon_publishes_its_role(self, tmp_path):
        from hyperspace_tpu_torch.lifecycle.daemon import MaintenanceDaemon

        s = self._session(tmp_path)
        s.conf.lifecycle_enabled = True
        s.conf.lifecycle_interval_s = 3600.0
        s.conf.fleet_telemetry_enabled = True
        role = fleet.process_role()
        daemon = MaintenanceDaemon(s).start()
        try:
            deadline = time.monotonic() + 10
            while not fleet.live_snapshots(s.conf) \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            rows = fleet.live_snapshots(s.conf)
            assert [r["process"] for r in rows] == \
                [fleet.process_identity()]
            # A server of this process outranks the daemon role.
            assert rows[0]["role"] == ("server" if role == "server"
                                       else "daemon")
        finally:
            daemon.stop()
            fleet.publisher_for(s).stop()


# ---------------------------------------------------------------------------
# The churn drill: port servers in subprocesses behind one front door
# ---------------------------------------------------------------------------
_SERVER_CHILD = r"""
import json, os, sys
from hyperspace_tpu_torch import HyperspaceSession
from hyperspace_tpu_torch.interop import QueryServer, dataset_from_spec

system_path, interval = sys.argv[1], float(sys.argv[2])
s = HyperspaceSession(system_path=system_path, device="cpu")
s.conf.fleet_telemetry_enabled = True
s.conf.fleet_publish_interval_s = interval
# Warm the query path before announcing.
dataset_from_spec(s, json.loads(sys.argv[3])).collect()
server = QueryServer(s, handle_sigterm=True).start()
print(json.dumps({"port": server.address[1], "pid": os.getpid(),
                  "jax": sorted(m for m in ("jax", "hyperspace_tpu")
                                if m in sys.modules)}), flush=True)
server.drained.wait()
sys.exit(0)
"""


def _spawn_servers(system_path, data, n):
    env = dict(os.environ, PYTHONPATH=REPO)
    warm = json.dumps(_point_spec(data, 0))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SERVER_CHILD, system_path, "0.2", warm],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for _ in range(n)]
    children = []
    try:
        for p in procs:
            box = {}
            reader = threading.Thread(
                target=lambda: box.update(line=p.stdout.readline()),
                daemon=True)
            reader.start()
            reader.join(BOUND_S)
            line = box.get("line")
            assert line, "a server child never announced itself"
            child = json.loads(line)
            assert child["jax"] == [], child
            children.append(child)
    except BaseException:
        _kill_all(procs)
        raise
    return procs, children


def _kill_all(procs):
    for p in procs:
        p.kill()
        p.wait(timeout=BOUND_S)
        for stream in (p.stdout, p.stderr):
            stream.close()


def _churn_data(tmp_path, n):
    data = str(tmp_path / "data")
    os.makedirs(data)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64) * 2),
    }), os.path.join(data, "f.parquet"))
    return data


class TestFleetChurn:
    def test_sigkill_mid_burst_loses_nothing(self, tmp_path):
        n = 1000
        data = _churn_data(tmp_path, n)
        s = HyperspaceSession(system_path=str(tmp_path / "ix"),
                              device="cpu")
        s.conf.fleet_telemetry_enabled = True
        s.conf.fleet_publish_interval_s = 0.2
        procs, children = _spawn_servers(str(tmp_path / "ix"), data, 3)
        try:
            endpoints = [("127.0.0.1", c["port"]) for c in children]
            retry0 = _counter("client.retry")
            conn0 = _counter("client.retry.connection")
            fail0 = _counter("client.failover")
            with FleetQueryClient(endpoints, conf=s.conf) as fc:
                def check(k):
                    t = fc.query(_point_spec(data, k),
                                 deadline_ms=BOUND_S * 1000)
                    assert t.column("v").to_pylist() == [2 * k], k

                # Warm: every server serving and heartbeating.
                deadline = time.monotonic() + BOUND_S
                while sum(1 for r in fleet.fresh_snapshots(s.conf)
                          if r.get("address")) < 3 \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                for k in range(20):
                    check(k)
                # The fleet rows matched the children (by address).
                assert sum(1 for ep in fc._endpoints
                           if ep.load is not None) >= 1
                os.kill(children[0]["pid"], signal.SIGKILL)
                procs[0].wait(timeout=BOUND_S)
                for k in range(60):      # the burst through the churn
                    check(k % n)
            # No retryable request was lost, and the router failed over.
            assert _counter("client.retry") - retry0 >= 1
            assert _counter("client.retry.connection") - conn0 >= 1
            assert _counter("client.failover") - fail0 >= 1
        finally:
            _kill_all(procs)

    def test_sigterm_drain_is_planned_exit(self, tmp_path):
        data = _churn_data(tmp_path, 100)
        s = HyperspaceSession(system_path=str(tmp_path / "ix"),
                              device="cpu")
        s.conf.fleet_telemetry_enabled = True
        s.conf.fleet_publish_interval_s = 0.2
        procs, children = _spawn_servers(str(tmp_path / "ix"), data, 2)
        try:
            endpoints = [("127.0.0.1", c["port"]) for c in children]
            gone = f"127.0.0.1:{children[0]['port']}"
            with FleetQueryClient(endpoints, conf=s.conf) as fc:
                for k in range(6):
                    fc.query(_point_spec(data, k))
                os.kill(children[0]["pid"], signal.SIGTERM)
                assert procs[0].wait(timeout=BOUND_S) == 0  # drained
                # The drained server deleted its heartbeat; the survivor
                # still serves.
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    live = {r.get("address")
                            for r in fleet.live_snapshots(s.conf)}
                    if gone not in live:
                        break
                    time.sleep(0.1)
                assert gone not in live
                assert f"127.0.0.1:{children[1]['port']}" in live
                for k in range(6):
                    t = fc.query(_point_spec(data, k))
                    assert t.num_rows == 1
                report = Hyperspace(s).doctor(fleet=True)
                assert report.check("fleet.heartbeats").status == "ok"
        finally:
            _kill_all(procs)
