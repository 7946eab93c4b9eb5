"""The port's per-tenant admission and async IO mode
(hyperspace_tpu_torch/interop/server.py) held to
tests/test_fleet_serving.py's ``TestTenantAdmission`` and
``TestAsyncIOMode``, each scenario run on the JAX package and on the
port (a ``cpu`` session) with the outcomes compared.

Where the JAX file sleeps 0.4 s and trusts its held query to be still
running, these cases poll ``pool.tenant_snapshot()`` under a deadline
until the hot tenant shows.  The held query is cut from the JAX file's
8,000,000-row group-by with three aggregates to 7,000,000 rows with
seven (a product of two columns among them), which still runs about
1 s on one CPU, so the hot tenant holds the one worker long after the
poll sees it.  The tenant counters are process-wide, so each scenario
resets both packages' metrics first."""

from __future__ import annotations

import importlib
import json
import os
import socket
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
BOUND_S = 120.0  # every join and wait in this file
SOCKET_S = 60.0  # the sockets that wait out the held query
HELD_ROWS = 7_000_000


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _server(pkg):
    return _m(pkg, "interop.server")


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    for pkg in PKGS:
        _m(pkg, "telemetry.flight_recorder").reset()
        _m(pkg, "lifecycle.daemon").clear_drain()


def _set(pkg, session, field: str, key: str, value) -> None:
    """A serving conf value: the port's field, the JAX package's key."""
    if pkg is TORCH:
        setattr(session.conf, field, value)
    else:
        session.conf.set(key, value)


def _quota(pkg, session, n: int) -> None:
    _set(pkg, session, "serving_tenant_max_queued",
         "hyperspace.serving.tenant.maxQueued", n)


def _io_mode(pkg, session, mode: str) -> None:
    _set(pkg, session, "serving_io_mode", "hyperspace.serving.ioMode", mode)


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
    sessions = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg is TORCH else {}
        s = pkg.HyperspaceSession(
            system_path=str(tmp_path / f"ix_{pkg.__name__}"), **kw)
        s.conf.num_buckets = 4
        sessions[pkg] = s
    return sessions, data


@pytest.fixture(scope="module")
def slow_dir(tmp_path_factory):
    """A group-by that holds a worker about 1 s on one CPU."""
    d = str(tmp_path_factory.mktemp("tenants") / "big")
    os.makedirs(d)
    rng = np.random.default_rng(7)
    pq.write_table(pa.table({
        "g": pa.array(rng.integers(0, HELD_ROWS // 4, HELD_ROWS),
                      type=pa.int64()),
        "x": pa.array(rng.random(HELD_ROWS)),
        "y": pa.array(rng.random(HELD_ROWS)),
    }), os.path.join(d, "p.parquet"))
    return d


def _point_spec(data, k):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "==", "col": "k", "value": int(k)},
            "select": ["k", "v"]}


def _slow_spec(slow_dir):
    xy = {"op": "*", "left": {"col": "x"}, "right": {"col": "y"}}
    return {"source": {"format": "parquet", "path": slow_dir},
            "group_by": ["g"],
            "aggs": {"t": ["x", "sum"], "m": ["x", "mean"],
                     "y2": ["y", "sum"], "lo": ["y", "min"],
                     "hi": ["x", "max"], "p": [xy, "sum"],
                     "q": [xy, "mean"]},
            "sort": [["t", False]], "limit": 5}


def _wait_for(cond, what: str) -> None:
    end = time.monotonic() + BOUND_S
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


def _hold(pkg, server, slow_dir, tenant: str):
    """Start ``tenant``'s held query on its own connection; return the
    thread and its result box once the pool counts the tenant."""
    srv = _server(pkg)
    out = {}

    def run():
        try:
            with srv.QueryClient(server.address, tenant=tenant,
                                 timeout_s=SOCKET_S) as c:
                out["table"] = c.query(_slow_spec(slow_dir))
        except Exception as e:  # noqa: BLE001 - checked by the caller
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    _wait_for(lambda: server.pool.tenant_snapshot().get(tenant, 0) >= 1
              or not t.is_alive(), f"{tenant} to be admitted")
    assert t.is_alive(), out
    return t, out


def _held_answer(out) -> tuple:
    """The held group-by's answer as comparable values: the top groups
    exactly, their sums to 6 decimals (summation order may differ
    between the packages)."""
    assert "error" not in out, out
    table = out["table"]
    return (table.num_rows, table.column("g").to_pylist(),
            np.round(np.asarray(table.column("t")), 6).tolist())


# ---------------------------------------------------------------------------
# tests/test_fleet_serving.py::TestTenantAdmission
# ---------------------------------------------------------------------------
class TestTenantAdmission:
    def test_quota_sheds_hot_tenant_only(self, env, slow_dir):
        sessions, data = env

        def run(pkg):
            srv, metrics = _server(pkg), _m(pkg, "telemetry.metrics")
            s = sessions[pkg]
            s.conf.serving_workers = 1
            _quota(pkg, s, 1)
            metrics.reset()
            with srv.QueryServer(s) as server:
                t, out = _hold(pkg, server, slow_dir, "hot")
                with srv.QueryClient(server.address, tenant="hot",
                                     timeout_s=SOCKET_S) as c:
                    with pytest.raises(srv.ServerBusyError,
                                       match="quota") as ei:
                        c.query(_point_spec(data, 1))
                shed = ei.value
                assert shed.retryable and shed.retry_after_ms is not None
                # Another tenant is admitted while "hot" is at its quota:
                # it waits for the worker instead of being shed.
                with srv.QueryClient(server.address, tenant="cold",
                                     timeout_s=SOCKET_S) as c:
                    cold = c.query(_point_spec(data, 2))
                t.join(timeout=BOUND_S)
                assert not t.is_alive()
            snap = metrics.snapshot()
            return (shed.code, shed.message, type(shed).__name__,
                    cold.column("k").to_pylist(), _held_answer(out),
                    snap.get("serve.shed.tenant"),
                    snap.get("serve.tenant.hot.shed"),
                    snap.get("serve.tenant.hot.queued"),
                    snap.get("serve.tenant.cold.queued"))

        got = {pkg: run(pkg) for pkg in PKGS}
        assert got[TORCH] == got[JAX]
        code, message, cls, cold, held, *counters = got[TORCH]
        assert (code, cls, cold) == ("BUSY", "ServerBusyError", [2])
        assert message == ("tenant 'hot' is at its queued quota (1); "
                           "retry later")
        assert held[0] == 5
        assert counters == [1.0, 1.0, 0.0, 0.0]

    def test_tenants_verb_reports(self, env, slow_dir):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            s = sessions[pkg]
            s.conf.serving_workers = 1
            _quota(pkg, s, 1)
            _m(pkg, "telemetry.metrics").reset()
            with srv.QueryServer(s) as server:
                t, out = _hold(pkg, server, slow_dir, "tv-a")
                with srv.QueryClient(server.address, tenant="tv-a",
                                     timeout_s=SOCKET_S) as c:
                    with pytest.raises(srv.ServerBusyError):
                        c.query(_point_spec(data, 1))
                # Verbs answer inline, while the worker is pinned.
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    during = c.query({"verb": "tenants"})
                t.join(timeout=BOUND_S)
                assert not t.is_alive()
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    after = c.query({"verb": "tenants"})
            return (during.schema, during.to_pylist(), after.to_pylist(),
                    _held_answer(out))

        got = {pkg: run(pkg) for pkg in PKGS}
        assert got[TORCH] == got[JAX]
        schema, during, after, held = got[TORCH]
        assert schema.names == ["tenant", "queued", "shed"]
        assert during == [{"tenant": "tv-a", "queued": 1, "shed": 1}]
        assert after == [{"tenant": "tv-a", "queued": 0, "shed": 1}]
        assert held[0] == 5

    def test_tenant_must_be_string(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    with pytest.raises(srv.QueryFailedError,
                                       match="tenant") as ei:
                        c.query({**_point_spec(data, 1), "tenant": 7})
                # A null tenant is no tenant.
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    untagged = c.query({**_point_spec(data, 3),
                                        "tenant": None})
            return (ei.value.code, ei.value.message,
                    untagged.column("k").to_pylist())

        got = {pkg: run(pkg) for pkg in PKGS}
        assert got[TORCH] == got[JAX]
        assert got[TORCH] == ("BADREQ", '"tenant" must be a string', [3])


# ---------------------------------------------------------------------------
# tests/test_fleet_serving.py::TestAsyncIOMode
# ---------------------------------------------------------------------------
class TestAsyncIOMode:
    def test_bad_mode_rejected(self, env):
        sessions, _data = env
        for pkg in PKGS:
            s = sessions[pkg]
            _io_mode(pkg, s, "fiber")
            with pytest.raises(ValueError, match="ioMode"):
                _server(pkg).QueryServer(s)
            _io_mode(pkg, s, "threaded")

    def test_bit_equal_results_and_errors(self, env):
        """Async against threaded in each package, and the port against
        the JAX package: equal tables, equal ``(code, message)`` of an
        error, the same ``metrics`` schema (its values differ between
        two live servers by design)."""
        sessions, data = env
        specs = [_point_spec(data, 3),
                 {"source": {"format": "parquet", "path": data},
                  "group_by": ["v"], "aggs": {"n": ["k", "count"]},
                  "sort": [["v", True]], "limit": 10},
                 {"verb": "metrics"}]
        got = {}
        for pkg in PKGS:
            srv = _server(pkg)
            for mode in ("threaded", "async"):
                _io_mode(pkg, sessions[pkg], mode)
                try:
                    with srv.QueryServer(sessions[pkg]) as server:
                        with srv.QueryClient(server.address,
                                             timeout_s=SOCKET_S) as c:
                            tables = [c.query(sp) for sp in specs]
                        with pytest.raises(srv.QueryFailedError) as ei:
                            with srv.QueryClient(server.address,
                                                 timeout_s=SOCKET_S) as c:
                                c.query({"sql": 123, "tables": {}})
                finally:
                    _io_mode(pkg, sessions[pkg], "threaded")
                got[(pkg, mode)] = (tables,
                                    (ei.value.code, ei.value.message))
        want_tables, want_err = got[(JAX, "threaded")]
        assert want_err[0] == "BADREQ"
        for key, (tables, err) in got.items():
            assert tables[0].equals(want_tables[0]), key
            assert tables[1].equals(want_tables[1]), key
            assert tables[2].schema == want_tables[2].schema, key
            assert err == want_err, key

    def test_async_connection_cap_and_drain(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            s = sessions[pkg]
            s.conf.serving_max_connections = 1
            _io_mode(pkg, s, "async")
            try:
                server = srv.QueryServer(s).start()
                c1 = srv.QueryClient(server.address, timeout_s=SOCKET_S)
                first = c1.query(_point_spec(data, 5))
                # Past the cap: the loop answers ERR BUSY without ever
                # registering the connection.
                with pytest.raises(srv.ServerBusyError,
                                   match="capacity") as ei:
                    srv.QueryClient(server.address, timeout_s=SOCKET_S) \
                        .query(_point_spec(data, 6))
                c1.close()
                clean = server.drain(grace_s=10)
                with pytest.raises(OSError):
                    socket.create_connection(server.address, timeout=2)
            finally:
                _m(pkg, "lifecycle.daemon").clear_drain()
                _io_mode(pkg, s, "threaded")
            return (first.column("k").to_pylist(), ei.value.code,
                    ei.value.message, clean)

        got = {pkg: run(pkg) for pkg in PKGS}
        assert got[TORCH] == got[JAX]
        assert got[TORCH] == ([5], "BUSY",
                              "connection capacity reached; retry later",
                              True)

    def test_pipelined_requests_ahead_of_their_answers(self, env):
        """Two request lines in one send: the async loop hands the second
        off from its buffer, with no read event, and both answers come
        back in order, byte for byte the threaded server's but for the
        trace ids."""
        sessions, data = env
        s = sessions[TORCH]
        srv = _server(TORCH)
        lines = b"".join(
            (json.dumps({**_point_spec(data, k),
                             "trace_id": f"{k:016x}",
                             "request_id": f"{k:016x}"}) + "\n").encode()
            for k in (8, 9))
        got = {}
        for mode in ("threaded", "async"):
            s.conf.serving_io_mode = mode
            try:
                with srv.QueryServer(s) as server:
                    with socket.create_connection(server.address,
                                                  timeout=SOCKET_S) as sock:
                        sock.sendall(lines)
                        f = sock.makefile("rb")
                        answers = []
                        for _ in range(2):
                            status = f.readline()
                            with pa.ipc.open_stream(f) as reader:
                                answers.append((status, reader.read_all()))
            finally:
                s.conf.serving_io_mode = "threaded"
            got[mode] = answers
        assert [st for st, _ in got["async"]] == \
            [st for st, _ in got["threaded"]] == \
            [b"OK trace=0000000000000008\n", b"OK trace=0000000000000009\n"]
        for (_, a), (_, b) in zip(got["async"], got["threaded"]):
            assert a.equals(b)
        assert [t.column("k").to_pylist() for _, t in got["async"]] == \
            [[8], [9]]
