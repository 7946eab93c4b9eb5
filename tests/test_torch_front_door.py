"""The port's front door (hyperspace_tpu_torch/interop/server.py:
``FleetQueryClient``, ``_Endpoint``, the proxy mode of ``QueryServer`` and
``MetricsScrapeServer``) held to the JAX package's.

The oracle cases are tests/test_netfaults.py's ``TestStalePoolEviction``,
``TestDeadlineBudget``, ``TestCircuitBreaker``, ``TestHedging``,
``TestSigstopGrayFailure`` and ``TestDoctorClientCheck``,
tests/test_fleet_serving.py's ``TestFrontDoor`` (but
``test_draining_row_skipped``, which reads fleet heartbeats this package
does not publish yet) and tests/test_build_report.py's two scrape-server
cases.  A case whose outcome does not hang on timing runs through both
packages, each against its own servers, and the two outcomes (answers,
error codes, counter deltas, breaker states) must be equal.

- The SIGKILL and SIGSTOP drills spawn servers of the port on the CPU,
  which import no JAX (each child says so); the client is the port's.
- ``test_hedge_beats_slow_primary`` has failed in the JAX package's own
  runs, so it runs on the port alone and holds to what the JAX case
  asserts (3 hedges sent, at least 1 and at most 3 won) on bounded
  timing: the primary's read is held 1 s, the hedge fires after 40 ms.
- Every socket timeout is at most 2 s.  A fleet client's socket timeouts
  come from its deadline budget, so where a JAX case passes no deadline
  the port's passes ``DEADLINE_MS`` (1950 ms: no attempt's timeout is
  above 2 s), and the case that hints a 30 s retry-after caps the
  backoff at 500 ms so that its retry fits that budget.
- The first JAX query of a process compiles for seconds; a module
  fixture runs each spec shape once on the JAX package first.

Then what the JAX package has no test for: the proxy's answers equal in
both packages, an upstream ``BUSY`` crossing the proxy as ``BUSY`` with
its hint, a verb answered by the proxy itself, the proxy under both IO
modes, and a device error in a backend arriving as ``FAILED``, never
retried.
"""

from __future__ import annotations

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
SOCKET_S = 2.0          # every socket's timeout in this file at most
DEADLINE_MS = 1950.0    # a budget whose attempts time out within 2 s
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _server(pkg):
    return _m(pkg, "interop.server")


def _metrics(pkg):
    return _m(pkg, "telemetry.metrics")


def _counter(pkg, name: str) -> float:
    return _metrics(pkg).registry().counter(name)


def _gauge(pkg, name: str) -> float:
    return float(_metrics(pkg).snapshot().get(name, 0.0) or 0.0)


def _both(scenario) -> dict:
    """``scenario(pkg)`` for each package; the two outcomes must be
    equal.  Returns them by package."""
    out = {pkg: scenario(pkg) for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    return out


def _write_data(path: str, n: int = 500, mult: int = 3) -> str:
    os.makedirs(path)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64) * mult),
    }), os.path.join(path, "f.parquet"))
    return path


def _session(pkg, system_path: str):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=system_path, **kw)
    s.conf.num_buckets = 4
    return s


def _io_mode(pkg, session, mode: str) -> None:
    if pkg is TORCH:
        session.conf.serving_io_mode = mode
    else:
        session.conf.set("hyperspace.serving.ioMode", mode)


def _point_spec(data, k):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "==", "col": "k", "value": int(k)},
            "select": ["k", "v"]}


def _range_spec(data, lo, hi):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "and",
                       "left": {"op": ">=", "col": "k", "value": lo},
                       "right": {"op": "<", "col": "k", "value": hi}},
            "select": ["k", "v"]}


def _agg_spec(data):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "<", "col": "k", "value": 100},
            "group_by": ["k"], "aggs": {"t": ["v", "sum"]},
            "sort": ["k"], "limit": 5}


def _v(table) -> list:
    return table.column("v").to_pylist()


@pytest.fixture(scope="module", autouse=True)
def _warm_jax(tmp_path_factory):
    """Each spec shape of this file once through the JAX package, so the
    compile of a process's first query never meets a 2 s socket."""
    root = tmp_path_factory.mktemp("warm")
    data = _write_data(str(root / "data"))
    session = _session(JAX, str(root / "ix"))
    q = _m(JAX, "interop.query")
    for spec in (_point_spec(data, 1), _range_spec(data, 5, 9),
                 _agg_spec(data)):
        q.dataset_from_spec(session, spec).collect()


@pytest.fixture(autouse=True)
def _clear_net_state():
    yield
    for pkg in PKGS:
        _m(pkg, "io.faults").clear()
        _m(pkg, "interop.netfaults").clear_parked()
        _metrics(pkg).set_gauge("client.breaker.open_now", 0.0)


@pytest.fixture()
def env(tmp_path):
    data = _write_data(str(tmp_path / "data"))
    sessions = {pkg: _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
                for pkg in PKGS}
    return sessions, data


def _close_listener(listener: socket.socket) -> None:
    """Close a listener and wake its blocked accept (a close alone leaves
    the accepting thread blocked on Linux)."""
    try:
        listener.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    listener.close()


class _BusyEndpoint:
    """Answers every request line with a retryable ``ERR BUSY`` and a
    retry-after hint, then closes."""

    def __init__(self, retry_after_ms=300):
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()
        self._hint = retry_after_ms
        self.hits = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            try:
                conn.settimeout(SOCKET_S)
                f = conn.makefile("rb")
                if f.readline():
                    self.hits += 1
                    conn.sendall(
                        f"ERR BUSY admission queue full; retry later "
                        f"retry-after-ms={self._hint}\n".encode())
                conn.close()
            except OSError:
                pass

    def close(self):
        self._stop = True
        _close_listener(self._listener)


class _SilentEndpoint:
    """Accepts and reads, never answers: a gray server."""

    def __init__(self):
        self._listener = socket.create_server(("127.0.0.1", 0))
        self.address = self._listener.getsockname()
        self._stop = False
        self._conns = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            self._conns.append(conn)  # held open; never answered

    def close(self):
        self._stop = True
        _close_listener(self._listener)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# The fault repaired first: an upstream error keeps its code
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("code", ["BUSY", "DEADLINE", "BADREQ", "FAILED"])
def test_an_upstream_error_keeps_its_code(code):
    """``_classify_error`` of a proxied ``QueryFailedError`` is its own
    code and message, so a ``BUSY`` stays retryable across the proxy
    (the port answered ``FAILED`` before)."""
    def run(pkg):
        srv = _server(pkg)
        exc = srv.parse_wire_error(
            f"ERR {code} upstream said no retry-after-ms=40 "
            f"trace=0123456789abcdef")
        return srv._classify_error(exc), exc.retry_after_ms

    assert _both(run)[TORCH] == ((code, "upstream said no"), 40)


def test_as_address_reads_both_forms():
    def run(pkg):
        srv = _server(pkg)
        got = [srv._as_address("127.0.0.1:9001"),
               srv._as_address(("::1", "9002"))]
        for bad in ("127.0.0.1", ":9001", "host:port"):
            with pytest.raises(ValueError, match="host:port"):
                srv._as_address(bad)
        return got

    assert _both(run)[TORCH] == [("127.0.0.1", 9001), ("::1", 9002)]


def test_the_conf_fields_set_the_client():
    """The ``client_*`` fields (the JAX package's ``hyperspace.client.*``
    keys) with their defaults, read when the client is made; a keyword
    argument wins over the conf."""
    keys = {"client_hedge_enabled": ("hyperspace.client.hedge.enabled",
                                     True),
            "client_hedge_delay_ms": ("hyperspace.client.hedge.delayMs",
                                      25.0),
            "client_breaker_enabled": (
                "hyperspace.client.breaker.enabled", True),
            "client_breaker_failures": (
                "hyperspace.client.breaker.failures", 3),
            "client_breaker_cooldown_ms": (
                "hyperspace.client.breaker.cooldownMs", 750.0)}

    def settings(fc) -> tuple:
        return (fc._hedge_enabled, fc._hedge_delay_ms, fc._breaker_enabled,
                fc._breaker_failures, fc._breaker_cooldown_ms)

    def run(pkg):
        conf = _m(pkg, "config").HyperspaceConf()
        fleet = _server(pkg).FleetQueryClient
        defaults = settings(fleet(["127.0.0.1:1"], conf=conf))
        for field, (key, value) in keys.items():
            if pkg is TORCH:
                setattr(conf, field, value)
            else:
                conf.set(key, value)
        return (defaults, settings(fleet(["127.0.0.1:1"], conf=conf)),
                settings(fleet(["127.0.0.1:1"], conf=conf,
                               breaker_failures=9))[3],
                settings(fleet(["127.0.0.1:1"])))

    assert _both(run)[TORCH] == (
        (False, 0.0, False, 5, 2000.0), (True, 25.0, True, 3, 750.0), 9,
        (False, 0.0, False, 5, 2000.0))


# ---------------------------------------------------------------------------
# test_netfaults.py::TestStalePoolEviction
# ---------------------------------------------------------------------------
_SERVER_CHILD = r"""
import json, os, sys
from hyperspace_tpu_torch import HyperspaceSession
from hyperspace_tpu_torch.interop import QueryServer, dataset_from_spec
s = HyperspaceSession(system_path=sys.argv[1], device="cpu")
port = int(sys.argv[2])
# Warm the query path first: a cold process's first query must not spend
# a client's whole 1.95 s budget.
dataset_from_spec(s, json.loads(sys.argv[3])).collect()
server = QueryServer(s, port=port, handle_sigterm=True).start()
print(json.dumps({"port": server.address[1], "pid": os.getpid(),
                  "jax": sorted(m for m in ("jax", "hyperspace_tpu")
                                if m in sys.modules)}), flush=True)
server.drained.wait()
sys.exit(0)
"""


def _spawn(system_path: str, data: str, port: int = 0):
    """A port server in a child process on the CPU, warmed by a point
    query over ``data``: (process, its announcement)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, "-c", _SERVER_CHILD, system_path, str(port),
         json.dumps(_point_spec(data, 0))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)
    line = p.stdout.readline()
    assert line, p.stderr.read()
    child = json.loads(line)
    assert child["jax"] == [], child  # the port's server imports no JAX
    return p, child


class TestStalePoolEviction:
    def test_bounced_server_socket_evicted_without_retry(self, tmp_path):
        """SIGKILL and a restart on the same port leave half-open TCP in
        the client's pool; the checkout's peek evicts it: a new dial, not
        a reset charged to the retries."""
        from hyperspace_tpu_torch.interop import FleetQueryClient

        data = _write_data(str(tmp_path / "data"), n=100)
        ix = str(tmp_path / "ix")
        proc, child = _spawn(ix, data)
        port = child["port"]
        fc = FleetQueryClient([("127.0.0.1", port)])
        try:
            assert _v(fc.query(_point_spec(data, 2),
                               deadline_ms=DEADLINE_MS)) == [6]
            assert fc._endpoints[0].idle  # the connection was pooled
            proc.kill()
            proc.wait(timeout=30)
            proc, _ = _spawn(ix, data, port)  # the bounce: same port
            retry0 = _counter(TORCH, "client.retry")
            evict0 = _counter(TORCH, "client.pool.evicted")
            assert _v(fc.query(_point_spec(data, 8),
                               deadline_ms=DEADLINE_MS)) == [24]
            assert _counter(TORCH, "client.pool.evicted") - evict0 >= 1
            assert _counter(TORCH, "client.retry") - retry0 == 0
        finally:
            fc.close()
            proc.kill()
            proc.wait(timeout=30)

    def test_healthy_pooled_socket_not_evicted(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.FleetQueryClient([server.address]) as fc:
                    evict0 = _counter(pkg, "client.pool.evicted")
                    got = [_v(fc.query(_point_spec(data, k),
                                       deadline_ms=DEADLINE_MS))
                           for k in range(5)]
                    pooled = len(fc._endpoints[0].idle)
                    return (got, pooled,
                            _counter(pkg, "client.pool.evicted") - evict0)

        assert _both(run)[TORCH] == ([[0], [3], [6], [9], [12]], 1, 0)


# ---------------------------------------------------------------------------
# test_netfaults.py::TestDeadlineBudget
# ---------------------------------------------------------------------------
class TestDeadlineBudget:
    def test_busy_retries_spend_one_budget(self, env):
        _sessions, data = env

        def run(pkg):
            busy = [_BusyEndpoint(retry_after_ms=300) for _ in range(2)]
            try:
                with _server(pkg).FleetQueryClient(
                        [b.address for b in busy], max_attempts=10) as fc:
                    t0 = time.monotonic()
                    with pytest.raises(Exception) as ei:
                        fc.query(_point_spec(data, 1), deadline_ms=700)
                    elapsed = time.monotonic() - t0
            finally:
                for b in busy:
                    b.close()
            # 10 attempts x 300 ms hinted backoff would be ~3 s; ONE
            # 700 ms budget caps the whole call.
            return (type(ei.value).__name__, ei.value.code, elapsed < 1.8,
                    sum(b.hits for b in busy) >= 2)

        assert _both(run)[TORCH] == ("ServerBusyError", "BUSY", True, True)

    def test_gray_endpoint_timeout_leaves_failover_budget(self, env):
        """The per-attempt socket timeout spreads the budget: a silent
        endpoint costs a slice of it, and the next attempt still has
        budget to succeed."""
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            silent = _SilentEndpoint()
            try:
                with srv.QueryServer(sessions[pkg]) as server:
                    with srv.FleetQueryClient(
                            [silent.address, server.address],
                            max_attempts=4) as fc:
                        t0 = time.monotonic()
                        answers = [_v(fc.query(_point_spec(data, k),
                                               deadline_ms=DEADLINE_MS))
                                   for k in range(4)]
                        elapsed = time.monotonic() - t0
            finally:
                silent.close()
            return answers, elapsed < 4 * DEADLINE_MS / 1000.0

        assert _both(run)[TORCH] == ([[0], [3], [6], [9]], True)

    def test_deadline_exhausted_raises_timeout(self, env):
        _sessions, data = env

        def run(pkg):
            silent = _SilentEndpoint()
            try:
                with _server(pkg).FleetQueryClient(
                        [silent.address], max_attempts=3) as fc:
                    t0 = time.monotonic()
                    with pytest.raises(OSError) as ei:
                        fc.query(_point_spec(data, 1), deadline_ms=600)
                    elapsed = time.monotonic() - t0
            finally:
                silent.close()
            return type(ei.value).__name__, elapsed < 2.5

        assert _both(run)[TORCH] == ("ConnectionError", True)


# ---------------------------------------------------------------------------
# test_netfaults.py::TestCircuitBreaker
# ---------------------------------------------------------------------------
class TestCircuitBreaker:
    def test_transitions(self):
        def run(pkg):
            ep = _server(pkg)._Endpoint(("127.0.0.1", 1))
            seen = [ep.breaker_blocked(time.monotonic()),
                    ep.breaker_failure(3, 10.0),
                    ep.breaker_failure(3, 10.0),
                    ep.breaker_failure(3, 10.0),      # the third opens
                    ep.breaker_state,
                    ep.breaker_blocked(time.monotonic()),
                    ep.breaker_on_pick(time.monotonic())]  # cooling
            ep.breaker_until = time.monotonic() - 0.01    # cooldown over
            seen += [ep.breaker_on_pick(time.monotonic()),  # half-open
                     ep.breaker_state,
                     ep.breaker_blocked(time.monotonic()),  # probe out
                     ep.breaker_failure(3, 10.0),           # re-opens
                     ep.breaker_state]
            ep.breaker_until = time.monotonic() - 0.01
            seen += [ep.breaker_on_pick(time.monotonic()),
                     ep.breaker_success(),                  # closes
                     ep.breaker_state,
                     ep.breaker_blocked(time.monotonic())]
            return seen

        assert _both(run)[TORCH] == [
            False, False, False, True, "open", True, False,
            True, "half-open", True, True, "open",
            True, True, "closed", False]

    def test_success_resets_failure_streak(self):
        def run(pkg):
            ep = _server(pkg)._Endpoint(("127.0.0.1", 1))
            ep.breaker_failure(3, 10.0)
            ep.breaker_failure(3, 10.0)
            return (ep.breaker_success(), ep.breaker_fails,
                    ep.breaker_failure(3, 10.0))

        assert _both(run)[TORCH] == (False, 0, False)

    def test_open_breaker_routes_away_until_probe(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            busy = _BusyEndpoint(retry_after_ms=50)
            open0 = _counter(pkg, "client.breaker.open")
            close0 = _counter(pkg, "client.breaker.close")
            try:
                with srv.QueryServer(sessions[pkg]) as server:
                    with srv.FleetQueryClient(
                            [busy.address, server.address],
                            breaker_enabled=True, breaker_failures=1,
                            breaker_cooldown_ms=60_000.0) as fc:
                        answers = [_v(fc.query(_point_spec(data, k),
                                               deadline_ms=DEADLINE_MS))
                                   for k in range(8)]
                        state = fc._endpoints[0].breaker_state
                        open_now = _gauge(pkg, "client.breaker.open_now")
                    closed_now = _gauge(pkg, "client.breaker.open_now")
            finally:
                busy.close()
            # The busy endpoint tripped its breaker at its first failure
            # and was never routed to again (the cooldown outlives this).
            return (answers, busy.hits, state, open_now, closed_now,
                    _counter(pkg, "client.breaker.open") - open0,
                    _counter(pkg, "client.breaker.close") - close0)

        assert _both(run)[TORCH] == (
            [[3 * k] for k in range(8)], 1, "open", 1.0, 0.0, 1.0, 0.0)

    def test_half_open_probe_closes_on_recovery(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.FleetQueryClient(
                        [server.address, server.address],
                        breaker_enabled=True, breaker_failures=1,
                        breaker_cooldown_ms=50.0) as fc:
                    # An open breaker on endpoint 0, as if it had failed;
                    # the server is healthy, so the probe closes it.
                    fc._endpoints[0].breaker_failure(1, 0.05)
                    half0 = _counter(pkg, "client.breaker.half_open")
                    close0 = _counter(pkg, "client.breaker.close")
                    time.sleep(0.08)  # the cooldown passes
                    for k in range(6):
                        fc.query(_point_spec(data, k),
                                 deadline_ms=DEADLINE_MS)
                    return (fc._endpoints[0].breaker_state,
                            _counter(pkg, "client.breaker.half_open")
                            - half0,
                            _counter(pkg, "client.breaker.close") - close0,
                            _gauge(pkg, "client.breaker.open_now"))

        assert _both(run)[TORCH] == ("closed", 1.0, 1.0, 0.0)

    def test_all_breakers_open_still_serves(self, env):
        """Breakers shape routing; they never refuse work outright."""
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.FleetQueryClient([server.address],
                                          breaker_enabled=True,
                                          breaker_failures=1) as fc:
                    fc._endpoints[0].breaker_failure(1, 60.0)
                    return _v(fc.query(_point_spec(data, 9),
                                       deadline_ms=DEADLINE_MS))

        assert _both(run)[TORCH] == [27]


# ---------------------------------------------------------------------------
# test_netfaults.py::TestHedging
# ---------------------------------------------------------------------------
def _slow_recv(pkg, ms: float) -> None:
    """One read of the next response held ``ms``: the primary's, the
    first through the seam."""
    faults = _m(pkg, "io.faults")
    faults.install(faults.FaultPlan(site="net.recv", kind="slow", at=1,
                                    count=1, latency_ms=ms))


class TestHedging:
    def test_hedge_beats_slow_primary(self, env):
        """The port alone (the JAX case has failed in its own runs), on
        bounded timing: the primary's read is held 1 s, the hedge fires
        after 40 ms on the other endpoint and reads at once."""
        sessions, data = env
        srv, faults = _server(TORCH), _m(TORCH, "io.faults")
        with srv.QueryServer(sessions[TORCH]) as s1, \
                srv.QueryServer(sessions[TORCH]) as s2:
            with srv.FleetQueryClient([s1.address, s2.address],
                                      hedge_enabled=True,
                                      hedge_delay_ms=40.0,
                                      max_attempts=2) as fc:
                for k in range(4):  # both endpoints warm, no faults
                    fc.query(_point_spec(data, k), deadline_ms=DEADLINE_MS)
                sent0 = _counter(TORCH, "client.hedge.sent")
                wins0 = _counter(TORCH, "client.hedge.wins")
                for k in range(3):
                    _slow_recv(TORCH, 1000.0)
                    assert _v(fc.query(_point_spec(data, k),
                                       deadline_ms=DEADLINE_MS)) == [3 * k]
                    faults.clear()
        sent = _counter(TORCH, "client.hedge.sent") - sent0
        wins = _counter(TORCH, "client.hedge.wins") - wins0
        assert sent == 3
        assert 1 <= wins <= sent

    def test_no_hedge_when_primary_fast(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.FleetQueryClient(
                        [server.address, server.address],
                        hedge_enabled=True, hedge_delay_ms=2000.0) as fc:
                    fc.query(_point_spec(data, 0), deadline_ms=DEADLINE_MS)
                    sent0 = _counter(pkg, "client.hedge.sent")
                    got = [_v(fc.query(_point_spec(data, k),
                                       deadline_ms=DEADLINE_MS))
                           for k in range(5)]
                    return got, _counter(pkg, "client.hedge.sent") - sent0

        assert _both(run)[TORCH] == ([[3 * k] for k in range(5)], 0.0)

    def test_loser_response_never_cross_wires(self, env):
        """After a hedge wins, the slow primary still reads its OWN late
        answer, dropped by request_id: the queries after it on the same
        pooled connections stay right."""
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as s1, \
                    srv.QueryServer(sessions[pkg]) as s2:
                with srv.FleetQueryClient([s1.address, s2.address],
                                          hedge_enabled=True,
                                          hedge_delay_ms=30.0,
                                          max_attempts=2) as fc:
                    for k in range(4):
                        fc.query(_point_spec(data, k),
                                 deadline_ms=DEADLINE_MS)
                    _slow_recv(pkg, 300.0)
                    first = _v(fc.query(_point_spec(data, 10),
                                        deadline_ms=DEADLINE_MS))
                    _m(pkg, "io.faults").clear()
                    time.sleep(0.5)  # the loser finishes its late read
                    return first, [_v(fc.query(_point_spec(data, k),
                                               deadline_ms=DEADLINE_MS))
                                   for k in range(20, 30)]

        assert _both(run)[TORCH] == ([30], [[3 * k] for k in range(20, 30)])

    def test_single_endpoint_never_hedges(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.FleetQueryClient([server.address],
                                          hedge_enabled=True,
                                          hedge_delay_ms=1.0) as fc:
                    sent0 = _counter(pkg, "client.hedge.sent")
                    got = [_v(fc.query(_point_spec(data, k),
                                       deadline_ms=DEADLINE_MS))
                           for k in range(3)]
                    return got, _counter(pkg, "client.hedge.sent") - sent0

        assert _both(run)[TORCH] == ([[0], [3], [6]], 0.0)

    def test_adaptive_delay_tracks_ewma(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.FleetQueryClient([server.address],
                                          hedge_enabled=True) as fc:
                    first = fc._hedge_delay_s()  # no history yet
                    for k in range(5):
                        fc.query(_point_spec(data, k),
                                 deadline_ms=DEADLINE_MS)
                    return (first, fc._lat_ewma_ms > 0.0,
                            0.010 <= fc._hedge_delay_s() <= 0.500)

        assert _both(run)[TORCH] == (0.050, True, True)


# ---------------------------------------------------------------------------
# test_netfaults.py::TestSigstopGrayFailure, on servers of the port
# ---------------------------------------------------------------------------
class TestSigstopGrayFailure:
    def test_stopped_server_times_out_and_fails_over(self, tmp_path):
        from hyperspace_tpu_torch.interop import FleetQueryClient

        data = _write_data(str(tmp_path / "data"), n=200, mult=5)
        procs, stopped_pid = [], None
        try:
            children = []
            for _ in range(2):
                p, child = _spawn(str(tmp_path / "ix"), data)
                procs.append(p)
                children.append(child)
            endpoints = [("127.0.0.1", c["port"]) for c in children]
            retry0 = _counter(TORCH, "client.retry")
            fail0 = _counter(TORCH, "client.failover")
            hedge0 = _counter(TORCH, "client.hedge.sent")
            with FleetQueryClient(endpoints, max_attempts=4) as fc:
                for k in range(4):  # both servers warm
                    assert _v(fc.query(_point_spec(data, k),
                                       deadline_ms=DEADLINE_MS)) == [5 * k]
                stopped_pid = children[0]["pid"]
                os.kill(stopped_pid, signal.SIGSTOP)  # alive, serves nothing
                answered = [_v(fc.query(_point_spec(data, k),
                                        deadline_ms=DEADLINE_MS))
                            for k in range(6)]
                os.kill(stopped_pid, signal.SIGCONT)
                stopped_pid = None
                # Late answers of the woken server died with their
                # discarded connections: what follows stays right.
                for k in range(6):
                    assert _v(fc.query(_point_spec(data, k),
                                       deadline_ms=DEADLINE_MS)) == [5 * k]
            # None lost: every request answered right.
            assert answered == [[5 * k] for k in range(6)]
            retries = _counter(TORCH, "client.retry") - retry0
            failovers = _counter(TORCH, "client.failover") - fail0
            assert retries >= 1            # the gray timeouts surfaced
            assert 1 <= failovers <= retries  # and routed away, once each
            assert _counter(TORCH, "client.hedge.sent") - hedge0 == 0
        finally:
            if stopped_pid is not None:
                try:
                    os.kill(stopped_pid, signal.SIGCONT)
                except OSError:
                    pass
            for p in procs:
                p.kill()
                p.wait(timeout=30)


# ---------------------------------------------------------------------------
# test_netfaults.py::TestDoctorClientCheck
# ---------------------------------------------------------------------------
class TestDoctorClientCheck:
    def test_warns_while_breaker_open(self, env):
        sessions, _data = env

        def run(pkg):
            _metrics(pkg).set_gauge("client.breaker.open_now", 2.0)
            try:
                check = pkg.Hyperspace(sessions[pkg]).doctor() \
                    .check("client")
                return check.status, "breaker" in check.summary
            finally:
                _metrics(pkg).set_gauge("client.breaker.open_now", 0.0)

        assert _both(run)[TORCH] == ("warn", True)

    def test_ok_with_closed_breakers(self, env):
        sessions, _data = env

        def run(pkg):
            _metrics(pkg).set_gauge("client.breaker.open_now", 0.0)
            return pkg.Hyperspace(sessions[pkg]).doctor() \
                .check("client").status

        assert _both(run)[TORCH] == "ok"


# ---------------------------------------------------------------------------
# test_fleet_serving.py::TestFrontDoor (but test_draining_row_skipped)
# ---------------------------------------------------------------------------
class TestFrontDoor:
    def test_busy_retries_on_other_endpoint(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            busy = _BusyEndpoint(retry_after_ms=120)
            retry0 = _counter(pkg, "client.retry.busy")
            fail0 = _counter(pkg, "client.failover")
            try:
                with srv.QueryServer(sessions[pkg]) as real:
                    with srv.FleetQueryClient(
                            [busy.address, real.address]) as fc:
                        keys = [fc.query(_point_spec(data, k),
                                         deadline_ms=DEADLINE_MS)
                                .column("k").to_pylist() for k in range(6)]
            finally:
                busy.close()
            # Round-robin over equal loads sent SOME requests into the
            # busy endpoint; each was retried onto the survivor.
            return (keys, busy.hits >= 1,
                    _counter(pkg, "client.retry.busy") - retry0
                    >= busy.hits,
                    _counter(pkg, "client.failover") - fail0 >= 1)

        assert _both(run)[TORCH] == ([[k] for k in range(6)], True, True,
                                     True)

    def test_busy_endpoint_penalized_by_hint(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            busy = _BusyEndpoint(retry_after_ms=30_000)  # parked for good
            try:
                with srv.QueryServer(sessions[pkg]) as real:
                    with srv.FleetQueryClient(
                            [busy.address, real.address],
                            backoff_cap_ms=500.0) as fc:
                        for k in range(8):
                            fc.query(_point_spec(data, k),
                                     deadline_ms=DEADLINE_MS)
                        hits_mid = busy.hits
                        # The 30 s penalty outlives the loop: once hit,
                        # the busy endpoint is never picked again.
                        for k in range(8):
                            fc.query(_point_spec(data, k),
                                     deadline_ms=DEADLINE_MS)
                        penalized = fc._endpoints[0].penalized_until \
                            > time.monotonic()
            finally:
                busy.close()
            return hits_mid, busy.hits, penalized

        assert _both(run)[TORCH] == (1, 1, True)

    def test_permanent_errors_not_retried(self, env):
        sessions, data = env
        bad = {"source": {"format": "parquet", "path": data},
               "filter": {"op": "==", "col": "no_such_col", "value": 1}}

        def run(pkg):
            srv = _server(pkg)
            retry0 = _counter(pkg, "client.retry")
            codes = []
            with srv.QueryServer(sessions[pkg]) as a, \
                    srv.QueryServer(sessions[pkg]) as b:
                with srv.FleetQueryClient([a.address, b.address]) as fc:
                    for spec in (bad, {"sql": 123, "tables": {}}):
                        with pytest.raises(srv.QueryFailedError) as ei:
                            fc.query(spec, deadline_ms=DEADLINE_MS)
                        codes.append(ei.value.code)
            # A permanent error run elsewhere fails N times for nothing.
            return codes, _counter(pkg, "client.retry") - retry0

        assert _both(run)[TORCH] == (["FAILED", "BADREQ"], 0.0)

    def test_a_device_error_in_a_backend_is_failed_and_not_retried(
            self, env, monkeypatch):
        """The port's own: ``torch.OutOfMemoryError`` raised by a backend's
        query reaches the client as ``FAILED``, with its type named, and
        is not run again on the other endpoint."""
        import torch

        from hyperspace_tpu_torch.interop import query as query_mod

        sessions, data = env
        calls = []

        def oom(session, spec):
            calls.append(spec)
            raise torch.OutOfMemoryError("CUDA out of memory (injected)")

        monkeypatch.setattr(query_mod, "dataset_from_spec", oom)
        srv = _server(TORCH)
        retry0 = _counter(TORCH, "client.retry")
        with srv.QueryServer(sessions[TORCH]) as a, \
                srv.QueryServer(sessions[TORCH]) as b:
            with srv.FleetQueryClient([a.address, b.address]) as fc:
                with pytest.raises(srv.QueryFailedError) as ei:
                    fc.query(_point_spec(data, 1), deadline_ms=DEADLINE_MS)
        assert ei.value.code == "FAILED" and not ei.value.retryable
        assert "OutOfMemoryError" in ei.value.message
        assert len(calls) == 1
        assert _counter(TORCH, "client.retry") - retry0 == 0


# ---------------------------------------------------------------------------
# The proxy (no JAX test: both packages' proxies side by side)
# ---------------------------------------------------------------------------
def _proxy_answers(pkg, session, data) -> list:
    """Two backends and a proxy over them in front of ``session``; a
    plain client of the proxy asks a point, a range and an aggregate."""
    srv = _server(pkg)
    with srv.QueryServer(session) as a, srv.QueryServer(session) as b:
        with srv.QueryServer(session,
                             proxy_endpoints=[a.address, b.address]) as p:
            with srv.QueryClient(p.address, timeout_s=SOCKET_S) as c:
                return [c.query(spec).to_pylist() for spec in (
                    _point_spec(data, 7), _range_spec(data, 5, 9),
                    _agg_spec(data))]


class TestProxy:
    def test_both_proxies_answer_alike(self, env):
        sessions, data = env

        def run(pkg):
            return _proxy_answers(pkg, sessions[pkg], data)

        got = _both(run)[TORCH]
        assert got[0] == [{"k": 7, "v": 21}]
        assert [r["k"] for r in got[1]] == [5, 6, 7, 8]
        assert got[2] == [{"k": k, "t": 3 * k} for k in range(5)]

    @pytest.mark.parametrize("mode", ["threaded", "async"])
    def test_the_proxy_under_both_io_modes(self, env, mode):
        """Both IO modes share the request engine, so the proxy's front
        (its own IO mode) and its backends answer alike."""
        sessions, data = env

        def run(pkg):
            _io_mode(pkg, sessions[pkg], mode)
            return _proxy_answers(pkg, sessions[pkg], data)

        assert _both(run)[TORCH][0] == [{"k": 7, "v": 21}]

    def test_an_upstream_busy_crosses_as_busy_with_its_hint(self, env):
        sessions, data = env

        def run(pkg):
            srv = _server(pkg)
            busy = _BusyEndpoint(retry_after_ms=50)
            try:
                with srv.QueryServer(sessions[pkg],
                                     proxy_endpoints=[busy.address]) as p:
                    with srv.QueryClient(p.address,
                                         timeout_s=SOCKET_S) as c:
                        with pytest.raises(srv.QueryFailedError) as ei:
                            c.query(_point_spec(data, 1))
            finally:
                busy.close()
            e = ei.value
            # The proxy's fleet client tried the backend max(3, 1) times.
            return (type(e).__name__, e.code, e.retryable, e.message,
                    e.retry_after_ms, busy.hits)

        assert _both(run)[TORCH] == (
            "ServerBusyError", "BUSY", True,
            "admission queue full; retry later", 50, 3)

    def test_a_verb_is_answered_by_the_proxy_itself(self, env):
        """Verbs read the proxy's own process: the busy backend never
        sees them."""
        sessions, _data = env

        def run(pkg):
            srv = _server(pkg)
            busy = _BusyEndpoint(retry_after_ms=50)
            try:
                with srv.QueryServer(sessions[pkg],
                                     proxy_endpoints=[busy.address]) as p:
                    with srv.QueryClient(p.address,
                                         timeout_s=SOCKET_S) as c:
                        table = c.query({"verb": "metrics"})
                        tenants = c.query({"verb": "tenants"})
            finally:
                busy.close()
            return (table.column_names, table.num_rows > 0,
                    tenants.column_names, busy.hits)

        assert _both(run)[TORCH] == (["name", "value"], True,
                                     ["tenant", "queued", "shed"], 0)

    def test_stop_and_drain_close_the_proxy_client(self, env):
        sessions, data = env
        srv = _server(TORCH)
        with srv.QueryServer(sessions[TORCH]) as backend:
            for finish in ("stop", "drain"):
                proxy = srv.QueryServer(
                    sessions[TORCH],
                    proxy_endpoints=[backend.address]).start()
                try:
                    with srv.QueryClient(proxy.address,
                                         timeout_s=SOCKET_S) as c:
                        assert _v(c.query(_point_spec(data, 3))) == [9]
                    fleet = proxy._server.proxy_client
                    assert fleet._endpoints[0].idle  # a pooled upstream
                finally:
                    if finish == "stop":
                        proxy.stop()
                    else:
                        assert proxy.drain(grace_s=SOCKET_S)
                        _m(TORCH, "lifecycle.daemon").clear_drain()
                assert fleet._endpoints[0].idle == []


# ---------------------------------------------------------------------------
# test_build_report.py's scrape-server cases, and the port's own
# ---------------------------------------------------------------------------
def _scrape(address, path: str = "/metrics"):
    """(body, content type, status) of one GET."""
    host, port = address
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=SOCKET_S) as resp:
        return (resp.read().decode("utf-8"), resp.headers["Content-Type"],
                resp.status)


class TestMetricsScrapeServer:
    def test_metrics_scrape_server(self, tmp_path):
        src = str(tmp_path / "src")
        os.makedirs(src)
        rng = np.random.default_rng(3)
        pq.write_table(pa.table({
            "k": pa.array(rng.integers(0, 500, 4_000), type=pa.int64()),
            "v": pa.array(rng.random(4_000))}),
            os.path.join(src, "part-0.parquet"))

        def run(pkg):
            session = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
            pkg.Hyperspace(session).create_index(
                session.read.parquet(src),
                pkg.IndexConfig("bi", ["k"], ["v"]))
            with _server(pkg).MetricsScrapeServer() as ms:
                body, ctype, _ = _scrape(ms.address)
            return ("text/plain" in ctype,
                    "hyperspace_build_actions" in body,
                    "hyperspace_build_phase_read_seconds" in body)

        assert _both(run)[TORCH] == (True, True, True)

    def test_scrape_server_refuses_non_loopback_without_optin(self):
        def run(pkg):
            with pytest.raises(ValueError, match="non-loopback"):
                _server(pkg).MetricsScrapeServer(host="0.0.0.0")
            return True

        assert _both(run)[TORCH] is True

    def test_the_root_path_serves_and_others_are_404(self):
        def run(pkg):
            with _server(pkg).MetricsScrapeServer() as ms:
                _, ctype, status = _scrape(ms.address, "/?x=1")
                with pytest.raises(urllib.error.HTTPError) as ei:
                    _scrape(ms.address, "/nope")
            return status, "text/plain" in ctype, ei.value.code

        assert _both(run)[TORCH] == (200, True, 404)

    def test_a_scrape_carries_the_client_series(self, env):
        sessions, data = env
        srv = _server(TORCH)
        with srv.QueryServer(sessions[TORCH]) as server:
            busy = _BusyEndpoint(retry_after_ms=10)
            try:
                with srv.FleetQueryClient([busy.address, server.address],
                                          breaker_enabled=True,
                                          breaker_failures=1) as fc:
                    for k in range(4):
                        fc.query(_point_spec(data, k),
                                 deadline_ms=DEADLINE_MS)
                    with srv.MetricsScrapeServer() as ms:
                        body, _, _ = _scrape(ms.address)
            finally:
                busy.close()
        for series in ("hyperspace_serve_ok", "hyperspace_client_retry",
                       "hyperspace_client_retry_busy",
                       "hyperspace_client_failover",
                       "hyperspace_client_breaker_open_now"):
            assert f"\n{series} " in body, series
        assert "# HELP hyperspace_client_failover " in body

    def test_fleet_is_not_here_yet(self, tmp_path):
        """``MetricsScrapeServer(fleet=True)``, which raised before the
        port had the fleet plane, now serves as the JAX package's: it
        needs a session, and a peer's heartbeat reaches the scrape as
        the same lines, each labelled with that peer's process."""
        peer = {"v": 1, "ts": time.time(), "process": "peer-8-8",
                "host": "h", "pid": 1, "role": "server", "health": None,
                "address": "", "draining": False,
                "metrics": {"counters": {"serve.requests": 3.0},
                            "gauges": {"serve.inflight": 1.0},
                            "histograms": {"serve.latency_ms": {
                                "count": 2, "sum": 30.0, "min": 10.0,
                                "max": 20.0,
                                "buckets": {"10.0": 1, "25.0": 1,
                                            "+Inf": 0},
                                "exemplars": {"7": ["a" * 16, 10.0]}}}},
                "device_kernel_ms": {}, "records": []}

        def run(pkg):
            srv, fleet = _server(pkg), _m(pkg, "telemetry.fleet")
            with pytest.raises(ValueError, match="session"):
                srv.MetricsScrapeServer(fleet=True)
            s = _session(pkg, str(tmp_path / f"ix_{pkg.__name__}"))
            store = _m(pkg, "telemetry.perf_ledger").store_for(
                s.conf, fleet.fleet_root(s.conf))
            assert store.put_if_generation_match(
                "hb-peer-8-8", json.dumps(peer).encode(), 0)
            with srv.MetricsScrapeServer(session=s, fleet=True) as ms:
                body, ctype, status = _scrape(ms.address)
            own = f'process="{fleet.process_identity()}"'
            assert own in body
            return status, ctype, [line for line in body.splitlines()
                                   if 'process="peer-8-8"' in line]

        got = _both(run)[TORCH]
        assert got[0] == 200
        assert 'hyperspace_serve_requests{process="peer-8-8"} 3' in got[2]
