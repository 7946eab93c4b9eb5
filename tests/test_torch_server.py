"""The port's query server and client (hyperspace_tpu_torch/interop/
server.py) held to tests/test_interop.py and to the JAX package's own
server.

The cases of tests/test_interop.py that the server's core covers run
here against the port's server on a ``cpu`` session: TestServer,
TestObservabilityVerbs, TestConcurrentClients, the loopback-bind guard,
SQL over the wire, a non-object request and the C++ Arrow client.  A
slow query is held by a gate the test opens, not by wall time.

Then the wire in both directions, over the same seeded Parquet data and
the same indexes: the JAX ``QueryClient`` against the port's server and
the port's ``QueryClient`` against the JAX server must get the JAX
pair's tables (rows in order where the spec orders them, floats within
1e-9 relative, everything else exact), the same wire codes and status
lines for a ``BADREQ``, a ``FAILED`` and a ``BUSY``, the same verb
columns, and, after the same request sequence, the same ``serve.*``
metric names and flight-record kinds and outcomes."""

from __future__ import annotations

import importlib
import json
import os
import re
import socket
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu.interop.server as jax_server
import hyperspace_tpu_torch
from hyperspace_tpu_torch import Hyperspace, IndexConfig, col
from hyperspace_tpu_torch.interop import (
    QueryClient,
    QueryFailedError,
    QueryServer,
    dataset_from_spec,
    request_query,
)
from hyperspace_tpu_torch.interop import server as server_mod
from hyperspace_tpu_torch.lifecycle import daemon as lifecycle_daemon

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
BOUND_S = 30.0  # every join, wait and socket read in this file
FLOAT_RTOL = 1e-9
_TRACE = re.compile(r"trace=[0-9a-f]{16}")


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    for pkg in (JAX, TORCH):
        _m(pkg, "telemetry.flight_recorder").reset()
        _m(pkg, "lifecycle.daemon").clear_drain()


def _write_data(root: str, seed: int = 4) -> tuple:
    data = os.path.join(root, "data")
    dim = os.path.join(root, "dim")
    os.makedirs(data)
    os.makedirs(dim)
    rng = np.random.default_rng(seed)
    n = 1000
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(0, 100, n), type=pa.int64()),
        "name": pa.array([f"n{i % 7}" for i in range(n)]),
        "x": pa.array(rng.random(n)),
    }), os.path.join(data, "f.parquet"))
    pq.write_table(pa.table({
        "k2": pa.array(np.arange(0, 2 * n, 2, dtype=np.int64)),
        "z": pa.array((np.arange(n) % 3).astype(np.int64)),
    }), os.path.join(dim, "d.parquet"))
    return data, dim


def _session(pkg, root: str, device_routes: bool = True):
    """A session of ``pkg``; ``device_routes`` pins the port's routing
    thresholds to 0 (its device routes on CPU tensors), else both
    packages keep their defaults and so take the same host routes."""
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=root, **kw)
    s.conf.num_buckets = 4
    if pkg is TORCH:
        if device_routes:
            for kind in ("filter", "join", "agg", "build"):
                setattr(s.conf, f"device_{kind}_min_rows", 0)
    else:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    return s


@pytest.fixture()
def env(tmp_path):
    data, _dim = _write_data(str(tmp_path))
    return _session(TORCH, str(tmp_path / "ix")), data


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
    rng = np.random.default_rng(0)
    pq.write_table(pa.table({
        "g": pa.array(rng.integers(0, 500, 5000), type=pa.int64()),
        "x": pa.array(rng.random(5000)),
    }), os.path.join(slow, "p.parquet"))
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


def _start(target, *args) -> threading.Thread:
    t = threading.Thread(target=target, args=args, daemon=True)
    t.start()
    return t


def _join(threads) -> None:
    for t in threads:
        t.join(timeout=BOUND_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


# ---------------------------------------------------------------------------
# tests/test_interop.py's server cases, against the port's server
# ---------------------------------------------------------------------------
class TestServer:
    def test_query_over_socket_with_index_rewrite(self, env):
        s, data = env
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ki", ["k"], ["v"]))
        s.enable_hyperspace()
        spec = {"source": {"format": "parquet", "path": data},
                "filter": {"op": "==", "col": "k", "value": 77},
                "select": ["k", "v"]}
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                out = client.query(spec)
                table = client.query({"verb": "last_run_report"})
        # Answer parity with the in-process path (rewrite included).
        want = dataset_from_spec(s, spec).collect()
        assert out.equals(want)
        assert out.num_rows == 1
        # Both ran with the index: the served run's report says so, and
        # so do this thread's stats of the local run.
        report = json.loads(table.column("report_json").to_pylist()[0])
        assert report["indexes_used"] == ["ki"]
        assert any(x["is_index"] for x in s.last_execution_stats["scans"])

    def test_error_reported_on_wire(self, env):
        s, _ = env
        with QueryServer(s) as server:
            with pytest.raises(RuntimeError, match="Query failed"):
                request_query(server.address, {"source": {
                    "format": "nope", "path": "/nowhere"}})

    def test_oversize_request_gets_clear_error(self, env):
        s, data = env
        huge = {"source": {"format": "parquet", "path": data},
                "filter": {"op": "in", "col": "k",
                           "values": list(range(300_000))}}
        with QueryServer(s) as server:
            with pytest.raises(RuntimeError, match="exceeds"):
                request_query(server.address, huge)

    def test_raw_socket_protocol(self, env):
        """The wire a non-Python client implements: a JSON line out, an
        'OK trace=<id>' line and an IPC stream back."""
        s, data = env
        with QueryServer(s) as server:
            with socket.create_connection(server.address,
                                          timeout=BOUND_S) as sock:
                sock.sendall(json.dumps({
                    "source": {"format": "parquet", "path": data},
                    "select": ["k"],
                }).encode() + b"\n")
                f = sock.makefile("rb")
                status = f.readline()
                assert _TRACE.fullmatch(status[3:].decode().strip())
                assert status.startswith(b"OK trace=")
                table = pa.ipc.open_stream(f).read_all()
        assert table.num_rows == 1000


class TestObservabilityVerbs:
    def test_metrics_verb(self, env):
        s, data = env
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                client.query({"source": {"format": "parquet",
                                         "path": data},
                              "select": ["k"]})
                table = client.query({"verb": "metrics"})
        assert set(table.column_names) == {"name", "value"}
        series = dict(zip(table.column("name").to_pylist(),
                          table.column("value").to_pylist()))
        assert series.get("io.files.read", 0) >= 1
        assert series.get("serve.latency_ms.count", 0) >= 1

    def test_last_run_report_verb_same_connection(self, env):
        s, data = env
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ki", ["k"], ["v"]))
        s.enable_hyperspace()
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                client.query({"source": {"format": "parquet", "path": data},
                              "filter": {"op": "==", "col": "k",
                                         "value": 7},
                              "select": ["k", "v"]})
                table = client.query({"verb": "last_run_report"})
        report = json.loads(table.column("report_json").to_pylist()[0])
        assert report is not None
        assert report["indexes_used"] == ["ki"]
        assert any(d["kind"] == "scan" and d.get("is_index")
                   for d in report["decisions"])

    def test_last_run_report_before_any_query_is_null(self, env):
        s, _data = env
        with QueryServer(s) as server:
            table = request_query(server.address,
                                  {"verb": "last_run_report"})
        assert json.loads(table.column("report_json").to_pylist()[0]) is None

    def test_workload_verb(self, env):
        s, data = env
        s.conf.advisor_capture_enabled = True
        from hyperspace_tpu_torch.advisor import workload as wl

        wl.reset_cache()
        ds = dataset_from_spec(s, {
            "source": {"format": "parquet", "path": data},
            "filter": {"op": "==", "col": "k", "value": 5},
            "select": ["k", "v"]})
        ds.collect()
        with QueryServer(s) as server:
            table = request_query(server.address, {"verb": "workload"})
        assert table.num_rows == 1
        assert table.column("eqColumns").to_pylist() == [["k"]]
        assert table.column("hits").to_pylist() == [1]

    def test_unknown_verb_reported_on_wire(self, env):
        s, _data = env
        with QueryServer(s) as server:
            with pytest.raises(RuntimeError, match="Unknown verb"):
                request_query(server.address, {"verb": "nope"})

    def test_the_nine_verbs_answer(self, env):
        s, data = env
        s.conf.flight_recorder_slow_ms = 0.0001  # every request is kept
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ki", ["k"], ["v"]))
        hs.maintenance_cycle()
        s.enable_hyperspace()
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                client.query({"source": {"format": "parquet", "path": data},
                              "filter": {"op": "==", "col": "k",
                                         "value": 7}})
                trace_id = client.last_trace_id
                got = {verb: client.query({"verb": verb, **extra})
                       for verb, extra in (
                           ("metrics", {}), ("last_run_report", {}),
                           ("workload", {}),
                           ("perf_history", {"index": "ki", "limit": 5}),
                           ("build_report", {}), ("slow_queries", {}),
                           ("trace", {"id": trace_id}), ("doctor", {}),
                           ("lifecycle", {}))}
        assert got["perf_history"].num_rows >= 1
        build = json.loads(got["build_report"].column(
            "report_json").to_pylist()[0])
        assert build is not None
        slow = got["slow_queries"]
        assert slow.column("traceId").to_pylist() == [trace_id]
        assert slow.column("kind").to_pylist() == ["spec"]
        rec = json.loads(got["trace"].column("record_json").to_pylist()[0])
        assert (rec["kind"], rec["outcome"]) == ("spec", "OK")
        assert rec["queue_wait_ms"] is not None
        assert "overall" in got["doctor"].column("check").to_pylist()
        assert got["lifecycle"].num_rows >= 1

    @pytest.mark.parametrize("spec, module", [
        ({"verb": "doctor", "fleet": True}, "telemetry/fleet.py"),
        ({"verb": "fleet_status"}, "telemetry/fleet.py"),
        ({"verb": "alerts"}, "telemetry/alerts.py"),
        ({"verb": "alerts", "fleet": True}, "telemetry/alerts.py"),
    ], ids=["doctor_fleet", "fleet_status", "alerts", "alerts_fleet"])
    def test_fleet_and_alert_verbs_answer(self, env, spec, module,
                                          monkeypatch):
        """The verbs of telemetry/fleet.py and telemetry/alerts.py, which
        failed naming their module before the port had it, answer as the
        JAX server does over the same system path: the same heartbeat
        rows from ``fleet_status`` (``ageSeconds`` and the read-time
        ``age_s`` aside) and the same fleet checks from ``doctor``.
        ``alerts`` serves ``Hyperspace.alerts()``, the JAX package's
        table over the same alert log; with ``fleet`` it adds a fresh
        heartbeat's carried alert, attributed to its process."""
        s, _data = env
        if module == "telemetry/alerts.py":
            self._check_alerts_verb(s, spec)
            return
        import types

        from hyperspace_tpu.telemetry import fleet as jax_fleet
        from hyperspace_tpu_torch.telemetry import fleet
        from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

        # Both fleet modules read one pinned clock: ages are equal.
        now = time.time()
        for module_ in (fleet, jax_fleet):
            monkeypatch.setattr(module_, "time",
                                types.SimpleNamespace(time=lambda: now))
        store = store_for(s.conf, fleet.fleet_root(s.conf))
        for name, age in (("live-1-1", 0.0), ("gone-2-2", 900.0)):
            snap = {"v": 1, "ts": now - age, "process": name,
                    "host": "h", "pid": 1, "role": "server",
                    "health": 1.0, "address": "", "draining": False,
                    "metrics": {"counters": {}, "gauges": {},
                                "histograms": {}},
                    "device_kernel_ms": {}, "records": []}
            assert store.put_if_generation_match(
                f"hb-{name}", json.dumps(snap).encode(), 0)
        js = _session(JAX, s.conf.system_path)

        def rows(table):
            out = table.to_pylist()
            if spec["verb"] == "doctor":
                return [r for r in out if r["check"].startswith("fleet.")]
            for r in out:
                r.pop("ageSeconds")
                r["snapshotJson"] = {
                    k: v for k, v in json.loads(r["snapshotJson"]).items()
                    if k != "age_s"}
            return out

        with QueryServer(s) as server:
            got = request_query(server.address, spec)
        with jax_server.QueryServer(js) as server:
            want = request_query(server.address, spec)
        assert got.schema == want.schema
        assert rows(got) == rows(want)
        assert len(rows(got)) == (6 if spec["verb"] == "doctor" else 2)

    @staticmethod
    def _check_alerts_verb(s, spec):
        from hyperspace_tpu.telemetry import alerts as jax_alerts
        from hyperspace_tpu_torch.telemetry import alerts, fleet
        from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

        assert alerts.append_transition(s.conf, {
            "alert": "availability", "state": "firing",
            "prev_state": "pending", "severity": "page",
            "transition": "firing", "since": 7.0, "bundle_key": "b-own",
            "detail": {"breached": True}})
        carried = {"alert": "latency", "state": "firing",
                   "severity": "warn", "since": 3.0, "bundle_key": "b-far"}
        store = store_for(s.conf, fleet.fleet_root(s.conf))
        snap = {"v": 1, "ts": time.time(), "process": "remote-3-3",
                "host": "h", "pid": 3, "role": "server", "health": 0.0,
                "address": "", "draining": False,
                "metrics": {"counters": {}, "gauges": {}, "histograms": {}},
                "device_kernel_ms": {}, "records": [], "alerts": [carried]}
        assert store.put_if_generation_match(
            "hb-remote-3-3", json.dumps(snap).encode(), 0)
        fleet_flag = spec.get("fleet", False)
        with QueryServer(s) as server:
            got = request_query(server.address, spec)
        assert got == Hyperspace(s).alerts(fleet=fleet_flag)
        rows = got.to_pylist()
        own = {"alert": "availability", "state": "firing",
               "severity": "page", "since": 7.0, "bundleKey": "b-own",
               "detailJson": json.dumps({"breached": True})}
        far = {"process": "remote-3-3", "alert": "latency",
               "state": "firing", "severity": "warn", "since": 3.0,
               "bundleKey": "b-far", "detailJson": "{}"}
        if fleet_flag:
            assert rows == [{"process": fleet.process_identity(), **own},
                            far]
        else:
            assert rows == [{"process": "", **own}]
        want = jax_alerts.alerts_table(_session(JAX, s.conf.system_path),
                                       fleet=fleet_flag)
        assert want.schema == got.schema
        assert want.to_pylist()[len(rows) - 1:] == rows[len(rows) - 1:]

    def test_verb_arguments_are_checked(self, env):
        s, _data = env
        with QueryServer(s) as server:
            for spec in ({"verb": 1}, {"verb": "doctor", "fleet": "yes"},
                         {"verb": "trace"}, {"verb": "trace", "id": "ab"},
                         {"verb": "perf_history", "limit": -1},
                         {"verb": "perf_history", "index": 3}):
                with pytest.raises(QueryFailedError) as ei:
                    request_query(server.address, spec)
                assert ei.value.code == "BADREQ", spec


def test_non_loopback_bind_requires_allow_remote(env):
    s, _data = env
    with pytest.raises(ValueError, match="no authentication"):
        QueryServer(s, host="0.0.0.0")
    # Loopback spellings stay frictionless.
    QueryServer(s, host="localhost").stop()
    # An explicit opt-in lifts the guard.
    QueryServer(s, host="0.0.0.0", allow_remote=True).stop()


def test_empty_host_binds_all_interfaces_requires_opt_in(env):
    s, _data = env
    with pytest.raises(ValueError, match="no authentication"):
        QueryServer(s, host="")


class TestConcurrentClients:
    def test_pipelined_queries_one_connection(self, env):
        s, data = env
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                for k in (3, 7, 11):
                    out = client.query({
                        "source": {"format": "parquet", "path": data},
                        "filter": {"op": "==", "col": "k", "value": k},
                        "select": ["k", "v"]})
                    assert out.column("k").to_pylist() == [k]

    def test_slow_query_does_not_stall_other_clients(self, env, gate):
        """A query holding one worker must not serialize a point query on
        another connection: the point query answers while the slow one
        is still held."""
        s, data = env
        done = {}

        def slow():
            done["slow"] = request_query(server.address, {
                "source": {"format": "parquet", "path": gate.path},
                "group_by": ["g"], "aggs": {"t": ["x", "sum"]},
                "sort": [["t", False]], "limit": 5})

        with QueryServer(s) as server:
            held = _start(slow)
            assert gate.reached.wait(BOUND_S)
            with QueryClient(server.address, timeout_s=BOUND_S) as client:
                out = client.query({
                    "source": {"format": "parquet", "path": data},
                    "filter": {"op": "==", "col": "k", "value": 5},
                    "select": ["k"]})
            assert not gate.opened.is_set() and held.is_alive()
            gate.opened.set()
            _join([held])
        assert out.num_rows == 1
        assert done["slow"].num_rows == 5

    def test_many_concurrent_clients_all_correct(self, env):
        s, data = env
        results = []
        lock = threading.Lock()

        def worker(k):
            out = request_query(server.address, {
                "source": {"format": "parquet", "path": data},
                "filter": {"op": "==", "col": "k", "value": int(k)},
                "select": ["k", "v"]})
            with lock:
                results.append((k, out.column("k").to_pylist()))

        with QueryServer(s) as server:
            _join([_start(worker, k) for k in range(16)])
        assert sorted(results) == [(k, [k]) for k in range(16)]

    def test_client_broken_after_error_requires_reconnect(self, env):
        s, data = env
        with QueryServer(s) as server:
            client = QueryClient(server.address, timeout_s=BOUND_S)
            try:
                with pytest.raises(RuntimeError, match="Query failed"):
                    client.query({"source": {"format": "nope",
                                             "path": "/x"}})
                assert client.is_stale()
                # Dead socket: later calls say so clearly.
                with pytest.raises(ConnectionError,
                                   match="new QueryClient"):
                    client.query({"source": {"format": "parquet",
                                             "path": data},
                                  "select": ["k"]})
            finally:
                client.close()


def test_sql_over_the_wire(env):
    """{"sql": ..., "tables": {...}} requests run the port's SQL front
    end against the server's session."""
    s, data = env
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(data),
                    IndexConfig("wire_sql_ix", ["k"], ["v"]))
    s.enable_hyperspace()
    with QueryServer(s) as server:
        out = request_query(server.address, {
            "sql": "SELECT k, v FROM t WHERE k = 7",
            "tables": {"t": data},
        })
        assert out.column("k").to_pylist() == [7]
        out2 = request_query(server.address, {
            "sql": "SELECT name, sum(v) AS total FROM t GROUP BY name "
                   "ORDER BY name LIMIT 3",
            "tables": {"t": data},
        })
        assert out2.column_names == ["name", "total"]
        assert out2.num_rows == 3
        with pytest.raises(RuntimeError, match="Unknown table"):
            request_query(server.address, {"sql": "SELECT x FROM nope",
                                           "tables": {}})


def test_non_object_request_clear_error(env):
    s, _data = env
    with QueryServer(s) as server:
        with pytest.raises(RuntimeError, match="JSON object"):
            request_query(server.address, "run sql please")


def test_cpp_arrow_ipc_client(env, tmp_path):
    """A process in another language speaks the wire end to end: the C++
    client (native/interop_client.cc, Arrow C++ from pyarrow's bundled
    headers and library) sends SQL to the port's server, and its rows
    and sums must match direct execution.  Skips where the JAX case
    does."""
    import glob
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ in this environment")
    pya_dir = os.path.dirname(pa.__file__)
    libs = sorted(glob.glob(os.path.join(pya_dir, "libarrow.so.*")))
    libs = [p for p in libs if p.split(".so.")[1].isdigit()]
    if not libs:
        pytest.skip("no bundled libarrow to link against")
    libname = os.path.basename(libs[-1])
    src = os.path.join(os.path.dirname(__file__), os.pardir, "native",
                       "interop_client.cc")
    exe = str(tmp_path / "interop_client")
    build = subprocess.run(
        [gxx, "-std=c++20", src, f"-I{pya_dir}/include", f"-L{pya_dir}",
         f"-l:{libname}", f"-Wl,-rpath,{pya_dir}", "-o", exe],
        capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-2000:]

    s, data = env
    with QueryServer(s) as server:
        host, port = server.address
        req = json.dumps({
            "sql": "SELECT k, v FROM t WHERE k >= 3 AND k < 9",
            "tables": {"t": data}})
        out = subprocess.run([exe, host, str(port), req],
                             capture_output=True, text=True, timeout=60)
        assert out.returncode == 0, out.stderr
        lines = {}
        for line in out.stdout.splitlines():
            parts = line.split()
            if parts[0] == "rows":
                lines["rows"] = int(parts[1])
            elif parts[0] == "sum":
                lines[f"sum_{parts[1]}"] = float(parts[2])
        expect = (s.read.parquet(data)
                  .filter((col("k") >= 3) & (col("k") < 9)).collect())
        assert lines["rows"] == expect.num_rows
        import pyarrow.compute as pc

        assert lines["sum_k"] == float(pc.sum(expect.column("k")).as_py())
        # A bad request: a non-zero exit with the server's error.
        bad = subprocess.run(
            [exe, host, str(port),
             json.dumps({"sql": "SELECT x FROM nope", "tables": {}})],
            capture_output=True, text=True, timeout=60)
        assert bad.returncode != 0
        assert "server error" in bad.stderr


# ---------------------------------------------------------------------------
# The wire in both directions: the port against the JAX package
# ---------------------------------------------------------------------------
def _specs(data: str, dim: str) -> list:
    """(name, request, ordered): ``ordered`` when the request fixes the
    row order."""
    src = {"format": "parquet", "path": data}
    return [
        ("point", {"source": src,
                   "filter": {"op": "==", "col": "k", "value": 77},
                   "select": ["k", "v", "x"]}, False),
        ("range", {"source": src,
                   "filter": {"op": "and",
                              "left": {"op": ">=", "col": "k", "value": 100},
                              "right": {"op": "<", "col": "k", "value": 300}},
                   "select": ["k", "x"], "sort": ["k"]}, True),
        ("join", {"source": src,
                  "join": {"source": {"format": "parquet", "path": dim},
                           "on": {"op": "==", "col": "k",
                                  "right_col": "k2"}},
                  "select": ["k", "v", "z"]}, False),
        ("agg", {"source": src, "group_by": ["name"],
                 "aggs": {"t": ["x", "sum"], "n": ["v", "count"],
                          "m": ["x", "mean"]},
                 "sort": ["name"]}, True),
        ("top", {"source": src,
                 "join": {"source": {"format": "parquet", "path": dim},
                          "on": {"op": "==", "col": "k", "right_col": "k2"}},
                 "group_by": ["z"],
                 "aggs": {"revenue": [{"op": "*", "left": {"col": "x"},
                                       "right": {"op": "-", "left": 1,
                                                 "right": {"col": "v"}}},
                                      "sum"]},
                 "sort": [["revenue", False]], "limit": 2}, True),
        ("sql", {"sql": "SELECT name, sum(x) AS total, count(*) AS n "
                        "FROM t WHERE k < 500 GROUP BY name ORDER BY name",
                 "tables": {"t": data}}, True),
        ("sql_point", {"sql": "SELECT k, v FROM t WHERE k = 7",
                       "tables": {"t": data}}, False),
    ]


def _same_table(label: str, got, want, ordered: bool) -> None:
    assert got.column_names == want.column_names, label
    assert got.num_rows == want.num_rows, label
    if not ordered:
        keys = [(c, "ascending") for c in want.column_names]
        got, want = got.sort_by(keys), want.sort_by(keys)
    for name in want.column_names:
        g = got.column(name).to_numpy(zero_copy_only=False)
        w = want.column(name).to_numpy(zero_copy_only=False)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL, atol=0,
                                       err_msg=f"{label}.{name}")
        else:
            assert g.tolist() == w.tolist(), f"{label}.{name}"


def _indexed_session(pkg, root: str, data: str, dim: str,
                     device_routes: bool = False):
    s = _session(pkg, root, device_routes=device_routes)
    s.conf.flight_recorder_slow_ms = 0.0001  # every request is kept
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(data),
                    pkg.IndexConfig("ki", ["k"], ["v", "x", "name"]))
    hs.create_index(s.read.parquet(dim),
                    pkg.IndexConfig("di", ["k2"], ["z"]))
    s.enable_hyperspace()
    return s


@pytest.fixture()
def both(tmp_path):
    """Both packages' sessions over the same data, each with the same two
    indexes built by its own package.  Both keep their default routes, so
    an engine error is raised at the same place with the same message."""
    data, dim = _write_data(str(tmp_path), seed=23)
    sessions = {pkg: _indexed_session(pkg, str(tmp_path / pkg.__name__),
                                      data, dim)
                for pkg in (JAX, TORCH)}
    return sessions, data, dim


def _server_module(pkg):
    return jax_server if pkg is JAX else server_mod


class TestWireBothWays:
    def test_tables_match_the_jax_pair(self, both, tmp_path):
        """Every client against every server; the port's server also on a
        session whose thresholds send each query down its device routes
        (on CPU tensors here)."""
        sessions, data, dim = both
        servers = {"jax": (JAX, sessions[JAX]),
                   "torch": (TORCH, sessions[TORCH]),
                   "torch_device": (TORCH, _indexed_session(
                       TORCH, str(tmp_path / "device"), data, dim,
                       device_routes=True))}
        answers = {}
        for label, (server_pkg, session) in servers.items():
            srv = _server_module(server_pkg)
            with srv.QueryServer(session) as server:
                for client_pkg in (JAX, TORCH):
                    client_cls = _server_module(client_pkg).QueryClient
                    with client_cls(server.address,
                                    timeout_s=BOUND_S) as client:
                        for name, spec, _ in _specs(data, dim):
                            answers[(client_pkg.__name__, label, name)] = \
                                client.query(spec)
        for name, _spec, ordered in _specs(data, dim):
            want = answers[(JAX.__name__, "jax", name)]
            assert want.num_rows > 0, name
            for key, got in answers.items():
                if key[2] == name:
                    _same_table(f"{key[0]}->{key[1]} {name}", got, want,
                                ordered)

    def test_status_lines_match(self, both):
        """The same BADREQ, FAILED and BUSY lines, byte for byte but the
        trace id; and each package's client reads the other's server."""
        sessions, data, _dim = both
        requests = [
            ("badreq", json.dumps({"sql": 1}).encode() + b"\n"),
            ("badreq_json", b"not json\n"),
            ("failed", json.dumps({
                "source": {"format": "parquet", "path": data},
                "filter": {"op": "==", "col": "nope",
                           "value": 1}}).encode() + b"\n"),
            ("busy", json.dumps({
                "source": {"format": "parquet",
                           "path": data}}).encode() + b"\n"),
        ]
        lines, errors = {}, {}
        for server_pkg in (JAX, TORCH):
            srv = _server_module(server_pkg)
            with srv.QueryServer(sessions[server_pkg]) as server:
                for name, payload in requests:
                    server.pool.draining = name == "busy"
                    with socket.create_connection(server.address,
                                                  timeout=BOUND_S) as sock:
                        sock.sendall(payload)
                        line = sock.makefile("rb").readline().decode()
                    assert _TRACE.search(line), line
                    lines[(server_pkg, name)] = _TRACE.sub("trace=<id>", line)
                client_pkg = TORCH if server_pkg is JAX else JAX
                client_mod = _server_module(client_pkg)
                for name, payload in requests:
                    server.pool.draining = name == "busy"
                    with pytest.raises(client_mod.QueryFailedError) as ei:
                        client_mod.request_query(server.address,
                                                 json.loads(payload)
                                                 if name != "badreq_json"
                                                 else "x")
                    errors[(server_pkg, name)] = (
                        ei.value.code, ei.value.retryable,
                        type(ei.value).__name__)
                server.pool.draining = False
        for name, _ in requests:
            assert lines[(TORCH, name)] == lines[(JAX, name)], name
        assert lines[(TORCH, "badreq")].startswith("ERR BADREQ ")
        assert lines[(TORCH, "failed")].startswith("ERR FAILED KeyError: ")
        assert re.fullmatch(r"ERR BUSY server is draining; retry elsewhere "
                            r"retry-after-ms=\d+ trace=<id>\n",
                            lines[(TORCH, "busy")])
        assert errors[(TORCH, "busy")] == ("BUSY", True, "ServerBusyError")
        assert errors[(TORCH, "failed")] == ("FAILED", False,
                                             "QueryFailedError")
        for name, _ in requests:
            assert errors[(TORCH, name)] == errors[(JAX, name)], name

    def test_metrics_and_flight_records_match(self, both):
        """One request sequence through each server (the other package's
        client): the same ``serve.*`` metric names and the same record
        kinds and outcomes."""
        sessions, data, dim = both
        got = {}
        for server_pkg in (JAX, TORCH):
            client_mod = _server_module(TORCH if server_pkg is JAX else JAX)
            metrics = _m(server_pkg, "telemetry.metrics")
            recorder = _m(server_pkg, "telemetry.flight_recorder")
            metrics.reset()
            recorder.reset()
            srv = _server_module(server_pkg)
            with srv.QueryServer(sessions[server_pkg]) as server:
                with client_mod.QueryClient(server.address,
                                            timeout_s=BOUND_S) as client:
                    for _name, spec, _ in _specs(data, dim)[:3]:
                        client.query(spec)
                    client.query(_specs(data, dim)[1][1])  # a cache hit
                    client.query({"verb": "metrics"})
                for bad in ({"sql": 1},
                            {"source": {"format": "parquet", "path": data},
                             "filter": {"op": "==", "col": "nope",
                                        "value": 1}},
                            {**_specs(data, dim)[0][1], "deadline_ms": 0}):
                    with pytest.raises(client_mod.QueryFailedError):
                        client_mod.request_query(server.address, bad)
                server.pool.draining = True
                with pytest.raises(client_mod.ServerBusyError):
                    client_mod.request_query(server.address,
                                             _specs(data, dim)[0][1])
                server.pool.draining = False
            names = sorted(k for k in metrics.snapshot()
                           if k.startswith("serve."))
            records = sorted((r["kind"], r["outcome"])
                             for r in recorder.recorder().records())
            got[server_pkg] = (names, records)
        assert got[TORCH] == got[JAX]
        names, records = got[TORCH]
        assert {"serve.plan_cache.hits", "serve.latency_ms",
                "serve.shed.draining", "serve.err.failed"} <= set(names)
        assert ("spec", "OK") in records and ("spec", "BUSY") in records

    def test_verb_columns_match(self, both):
        sessions, data, _dim = both
        columns = {}
        for server_pkg in (JAX, TORCH):
            srv = _server_module(server_pkg)
            with srv.QueryServer(sessions[server_pkg]) as server:
                with srv.QueryClient(server.address,
                                     timeout_s=BOUND_S) as client:
                    client.query({"source": {"format": "parquet",
                                             "path": data},
                                  "select": ["k"]})
                    trace_id = client.last_trace_id
                    for verb, extra in (
                            ("metrics", {}), ("last_run_report", {}),
                            ("workload", {}), ("perf_history", {}),
                            ("build_report", {}), ("slow_queries", {}),
                            ("trace", {"id": trace_id}), ("lifecycle", {})):
                        columns[(server_pkg, verb)] = client.query(
                            {"verb": verb, **extra}).column_names
        for (pkg, verb), names in columns.items():
            assert names == columns[(JAX, verb)], verb


def test_phase_t_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase T end to end at 80,000 lineitem rows on a
    ``cpu`` session: it builds ``li_idx`` and ``ord_idx`` itself (no
    phase before it ran), serves the seven queries alone and from
    concurrent clients, the plan-cache pairs, the hybrid join, the
    burst, the deadline, the drain and the verbs.  The plain kernels
    count no launch, so the launch checks run on the card."""
    import torch

    import chip_smoke

    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0), ("T_TIMED_RUNS", 1),
                        ("T_CLIENTS", 4), ("T_ROUNDS", 1),
                        ("T_CACHE_PAIRS", 1), ("T_APPENDED_ROWS", 1000)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    out = chip_smoke.phase_t(orders, li, root, torch.device("cpu"))
    assert out["rebuilt"] == [chip_smoke.INDEX_NAME, chip_smoke.ORDERS_INDEX]
    assert set(out["queries"]) == set(chip_smoke.t_specs(root))
    assert out["concurrent"]["requests"] == 4 * 7
    assert out["plan_cache"] == {"hits": 7, "misses": 7}
    assert out["hybrid"]["rows"] > 0
    assert out["burst"]["busy"] == chip_smoke.T_BURST
    assert out["drain"]["clean"] is True
    assert set(out["verbs"]) == set(chip_smoke.T_VERBS)
    assert not any(out["launches"].values())  # plain kernels count none
    assert sorted(os.listdir(os.path.join(root, "lineitem"))) == \
        [f"part-{f:05d}.parquet" for f in range(8)]
    assert not lifecycle_daemon.draining()
