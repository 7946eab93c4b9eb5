"""The port's wire-fault seams (hyperspace_tpu_torch/interop/netfaults.py
and the ``net.*`` channel of io/faults.py) held to tests/test_netfaults.py.

Every case of ``TestNetFaultPlan``, ``TestNetSeams`` and
``TestWirePathFaults`` runs through both packages, each with its own
fault plan armed, and the two outcomes must be equal: the
``QueryClient`` cases (a torn response raises ``ConnectionError``, a
slow read adds its delay, an accept reset seen by a plain client) and
the ``FleetQueryClient`` ones (a refused dial, a torn response, a reset
read and a reset accept each retried to the right answer).  Then what
is the port's own: a plan of one package arms none of the other's
seams, and with no wire plan armed the server writes its response
straight to the socket, with no whole-frame buffer.

Every socket has a timeout of at most 2 s (a fleet client's come from
its deadline budget, ``FLEET_DEADLINE_MS``), every hang at most 0.25 s,
and an autouse fixture clears both packages' plans and parked sockets.
"""

from __future__ import annotations

import importlib
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
SOCKET_S = 2.0  # every socket's timeout in this file
# A fleet client's budget: no attempt's socket timeout is above 2 s.
FLEET_DEADLINE_MS = 1950.0


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _faults(pkg):
    return _m(pkg, "io.faults")


def _netfaults(pkg):
    return _m(pkg, "interop.netfaults")


def _server(pkg):
    return _m(pkg, "interop.server")


@pytest.fixture(autouse=True)
def _clear_net_state():
    yield
    for pkg in PKGS:
        _faults(pkg).clear()
        _netfaults(pkg).clear_parked()
        _m(pkg, "telemetry.flight_recorder").reset()


def _both(scenario) -> dict:
    """``scenario(pkg)`` for each package; the two outcomes must be
    equal.  Returns them by package."""
    out = {pkg: scenario(pkg) for pkg in PKGS}
    assert out[TORCH] == out[JAX]
    return out


def _raised(fn):
    """``(exception class name, message)`` of what ``fn`` raised, or
    ``None`` when it returned."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the outcome under test
        return type(e).__name__, str(e)
    return None


@pytest.fixture()
def env(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    n = 500
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(np.arange(n, dtype=np.int64) * 3),
    }), os.path.join(data, "f.parquet"))
    sessions = {}
    for pkg in PKGS:
        kw = {"device": "cpu"} if pkg is TORCH else {}
        s = pkg.HyperspaceSession(
            system_path=str(tmp_path / f"ix_{pkg.__name__}"), **kw)
        s.conf.num_buckets = 4
        sessions[pkg] = s
    return sessions, data


def _point_spec(data, k):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "==", "col": "k", "value": int(k)},
            "select": ["k", "v"]}


# ---------------------------------------------------------------------------
# tests/test_netfaults.py::TestNetFaultPlan, through both packages
# ---------------------------------------------------------------------------
class TestNetFaultPlan:
    def test_net_sites_registered(self):
        def run(pkg):
            return [site in _faults(pkg).SITES for site in
                    ("net.connect", "net.send", "net.recv", "net.accept")]

        assert _both(run)[TORCH] == [True] * 4

    def test_net_kind_requires_net_site(self):
        def run(pkg):
            with pytest.raises(ValueError, match="net") as ei:
                _faults(pkg).FaultPlan(site="store.put", kind="reset")
            return str(ei.value)

        _both(run)

    def test_storage_kind_rejected_at_net_site(self):
        def run(pkg):
            with pytest.raises(ValueError, match="net") as ei:
                _faults(pkg).FaultPlan(site="net.send", kind="eio")
            return str(ei.value)

        _both(run)

    def test_net_checkpoint_fires_only_net_channel(self):
        def run(pkg):
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.send", kind="reset",
                                            at=1, count=-1))
            # The storage checkpoints never see a net plan; the net
            # checkpoint arbitrates site and order as usual.
            storage = faults.FaultPlan(
                site="net.send", kind="reset")._should_fire("net.send")
            return (storage, faults.net("net.recv") is None,
                    faults.net("net.send") is not None)

        assert _both(run)[TORCH] == (False, True, True)

    def test_quiet_suppresses_net_faults(self):
        def run(pkg):
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.send", kind="reset",
                                            at=1, count=-1))
            with faults.quiet():
                quiet = faults.net("net.send")
            return quiet is None, faults.net("net.send") is not None

        assert _both(run)[TORCH] == (True, True)

    def test_at_count_window(self):
        def run(pkg):
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.connect",
                                            kind="refused", at=2, count=1))
            return [faults.net("net.connect") is not None
                    for _ in range(3)]

        # Call 1 is before ``at``, call 2 fires, call 3 finds it spent.
        assert _both(run)[TORCH] == [False, True, False]

    def test_conf_arming_carries_shaping(self, tmp_path):
        def run(pkg):
            faults = _faults(pkg)
            if pkg is TORCH:
                s = pkg.HyperspaceSession(
                    system_path=str(tmp_path / "t"), device="cpu")
                s.conf.fault_injection_enabled = True
                s.conf.fault_injection_site = "net.recv"
                s.conf.fault_injection_kind = "slow"
                s.conf.fault_injection_latency_ms = 7.5
                s.conf.fault_injection_hang_s = 0.125
            else:
                s = pkg.HyperspaceSession(system_path=str(tmp_path / "j"))
                s.conf.set("hyperspace.system.faultInjection.enabled", True)
                s.conf.set("hyperspace.system.faultInjection.site",
                           "net.recv")
                s.conf.set("hyperspace.system.faultInjection.kind", "slow")
                s.conf.set("hyperspace.system.faultInjection.latencyMs",
                           7.5)
                s.conf.set("hyperspace.system.faultInjection.hangS", 0.125)
            faults.install_from_conf(s.conf)
            plan = faults.active()
            return plan.site, plan.kind, plan.latency_ms, plan.hang_s

        assert _both(run)[TORCH] == ("net.recv", "slow", 7.5, 0.125)


# ---------------------------------------------------------------------------
# tests/test_netfaults.py::TestNetSeams, against raw TCP sockets
# ---------------------------------------------------------------------------
def _tcp_pair():
    listener = socket.create_server(("127.0.0.1", 0))
    client = socket.create_connection(listener.getsockname(),
                                      timeout=SOCKET_S)
    server, _ = listener.accept()
    server.settimeout(SOCKET_S)
    listener.close()
    return client, server


class TestNetSeams:
    def test_connect_refused(self):
        def run(pkg):
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.connect",
                                            kind="refused"))
            return _raised(lambda: _netfaults(pkg).connect(
                ("127.0.0.1", 1), timeout=SOCKET_S))

        name, msg = _both(run)[TORCH]
        assert name == "ConnectionRefusedError" and "injected" in msg

    def test_connect_black_hole_hangs_then_times_out(self):
        def run(pkg):
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.connect",
                                            kind="black-hole", hang_s=0.08))
            t0 = time.monotonic()
            out = _raised(lambda: _netfaults(pkg).connect(
                ("127.0.0.1", 1), timeout=SOCKET_S))
            return out, time.monotonic() - t0 >= 0.08

        (name, msg), waited = _both(run)[TORCH]
        assert name == "TimeoutError" and "black-hole" in msg and waited

    def test_connect_slow_still_dials(self):
        def run(pkg):
            listener = socket.create_server(("127.0.0.1", 0))
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.connect", kind="slow",
                                            latency_ms=60.0))
            t0 = time.monotonic()
            sock = _netfaults(pkg).connect(listener.getsockname(),
                                           timeout=SOCKET_S)
            waited = time.monotonic() - t0 >= 0.06
            sock.close()
            listener.close()
            return waited

        assert _both(run)[TORCH] is True

    def test_send_torn_frame_delivers_half_then_reset(self):
        def run(pkg):
            client, server = _tcp_pair()
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.send",
                                            kind="torn-frame"))
            payload = b"x" * 4096
            raised = _raised(lambda: _netfaults(pkg).send_all(client,
                                                              payload))
            got = b""
            try:
                while True:
                    chunk = server.recv(65536)
                    if not chunk:
                        break
                    got += chunk
            except OSError:
                pass  # the RST surfaces as ECONNRESET: torn all the same
            server.close()
            return raised[0], "torn frame" in raised[1], len(got)

        name, torn, landed = _both(run)[TORCH]
        assert name == "ConnectionResetError" and torn
        assert 0 < landed < 4096

    def test_send_disarmed_passes_through(self):
        def run(pkg):
            client, server = _tcp_pair()
            _netfaults(pkg).send_all(client, b"hello")
            got = server.recv(64)
            client.close()
            server.close()
            return got

        assert _both(run)[TORCH] == b"hello"

    def test_before_recv_black_hole(self):
        def run(pkg):
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.recv",
                                            kind="black-hole", hang_s=0.05))
            t0 = time.monotonic()
            out = _raised(_netfaults(pkg).before_recv)
            return out, time.monotonic() - t0 >= 0.05

        (name, _msg), waited = _both(run)[TORCH]
        assert name == "TimeoutError" and waited

    def test_on_accept_reset_consumes_connection(self):
        def run(pkg):
            client, server = _tcp_pair()
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.accept",
                                            kind="reset"))
            consumed = _netfaults(pkg).on_accept(server) is False
            try:
                dead = client.recv(1) == b""  # a FIN counts as dead too
            except OSError:
                dead = True
            client.close()
            return consumed, dead

        assert _both(run)[TORCH] == (True, True)

    def test_on_accept_black_hole_parks_open(self):
        def run(pkg):
            client, server = _tcp_pair()
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.accept",
                                            kind="black-hole"))
            consumed = _netfaults(pkg).on_accept(server) is False
            # Parked: the peer sees neither data nor a FIN.
            client.settimeout(0.2)
            silent = _raised(lambda: client.recv(1))
            _netfaults(pkg).clear_parked()
            client.close()
            return consumed, silent[0]

        assert _both(run)[TORCH] == (True, "TimeoutError")

    def test_on_accept_disarmed_and_slow_pass_through(self):
        def run(pkg):
            client, server = _tcp_pair()
            passes = [_netfaults(pkg).on_accept(server)]
            faults = _faults(pkg)
            faults.install(faults.FaultPlan(site="net.accept", kind="slow"))
            passes.append(_netfaults(pkg).on_accept(server))
            client.close()
            server.close()
            return passes

        assert _both(run)[TORCH] == [True, True]


# ---------------------------------------------------------------------------
# tests/test_netfaults.py::TestWirePathFaults, the QueryClient halves
# ---------------------------------------------------------------------------
def _io_mode(pkg, session, mode: str) -> None:
    if pkg is TORCH:
        session.conf.serving_io_mode = mode
    else:
        session.conf.set("hyperspace.serving.ioMode", mode)


class TestWirePathFaults:
    @pytest.mark.parametrize("mode", ["threaded", "async"])
    def test_torn_response_frame_is_retryable(self, env, mode):
        """A torn-frame on the server's response surfaces as a
        ``ConnectionError`` (never an Arrow decode error), and a fresh
        client then gets the right answer.  Seam order: the client's
        request send is call 1, the server's response send call 2."""
        sessions, data = env

        def run(pkg):
            srv, faults = _server(pkg), _faults(pkg)
            _io_mode(pkg, sessions[pkg], mode)
            with srv.QueryServer(sessions[pkg]) as server:
                faults.install(faults.FaultPlan(
                    site="net.send", kind="torn-frame", at=2, count=1))
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    torn = _raised(lambda: c.query(_point_spec(data, 3)))
                faults.clear()
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    again = c.query(_point_spec(data, 3))
            # A reset read of the stream and a truncated one are both
            # a ConnectionError, never ArrowInvalid.
            return torn[0], again.column("v").to_pylist()

        assert _both(run)[TORCH] == ("ConnectionError", [9])

    def test_slow_recv_shapes_latency_only(self, env):
        sessions, data = env

        def run(pkg):
            srv, faults = _server(pkg), _faults(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    c.query(_point_spec(data, 1))  # warm: the dataset open
                    faults.install(faults.FaultPlan(
                        site="net.recv", kind="slow", at=1, count=1,
                        latency_ms=120.0))
                    t0 = time.monotonic()
                    got = c.query(_point_spec(data, 6))
                    waited = time.monotonic() - t0 >= 0.12
            return got.column("v").to_pylist(), waited

        assert _both(run)[TORCH] == ([18], True)

    @pytest.mark.parametrize("mode", ["threaded", "async"])
    def test_accept_reset_raises_connection_error(self, env, mode):
        """An armed ``net.accept`` reset seen by a plain ``QueryClient``:
        a ``ConnectionError`` on the first connection, the right answer on
        the next (the plan fired once).  The reset can reach the client
        while it dials (``ConnectionResetError``) or while it reads; both
        are ``ConnectionError``s."""
        sessions, data = env

        def run(pkg):
            srv, faults = _server(pkg), _faults(pkg)
            _io_mode(pkg, sessions[pkg], mode)

            def first(server):
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    c.query(_point_spec(data, 5))

            with srv.QueryServer(sessions[pkg]) as server:
                faults.install(faults.FaultPlan(
                    site="net.accept", kind="reset", at=1, count=1))
                with pytest.raises(ConnectionError):
                    first(server)
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    again = c.query(_point_spec(data, 5))
            return again.column("v").to_pylist()

        assert _both(run)[TORCH] == [15]

    def test_accept_black_hole_times_out_the_client(self, env):
        sessions, data = env

        def run(pkg):
            srv, faults = _server(pkg), _faults(pkg)
            with srv.QueryServer(sessions[pkg]) as server:
                faults.install(faults.FaultPlan(site="net.accept",
                                                kind="black-hole"))
                t0 = time.monotonic()
                with srv.QueryClient(server.address, timeout_s=0.5) as c:
                    out = _raised(lambda: c.query(_point_spec(data, 5)))
                waited = time.monotonic() - t0 >= 0.5
                _netfaults(pkg).clear_parked()
            return out[0], "timed out" in out[1], waited

        assert _both(run)[TORCH] == ("ConnectionError", True, True)


# ---------------------------------------------------------------------------
# tests/test_netfaults.py::TestWirePathFaults, the FleetQueryClient cases
# ---------------------------------------------------------------------------
class TestFleetWirePathFaults:
    """Each fault fires once; the fleet client retries on its second
    endpoint (the same server twice, as in the JAX cases) and answers
    right, with at least one retry counted."""

    @pytest.fixture(autouse=True)
    def _warm(self, env):
        """The JAX package's first query of a process compiles for
        seconds: once here, outside any budget."""
        sessions, data = env
        _m(JAX, "interop.query").dataset_from_spec(
            sessions[JAX], _point_spec(data, 0)).collect()

    @staticmethod
    def _fleet_answer(pkg, session, data, k, plan):
        """``plan`` armed right after the fleet client's first use, then
        the point query of ``k``: (its v column, retries counted)."""
        srv, faults = _server(pkg), _faults(pkg)
        retries = _m(pkg, "telemetry.metrics").registry().counter
        with srv.QueryServer(session) as server:
            with srv.FleetQueryClient([server.address,
                                       server.address]) as fc:
                retry0 = retries("client.retry")
                faults.install(faults.FaultPlan(**plan))
                got = fc.query(_point_spec(data, k),
                               deadline_ms=FLEET_DEADLINE_MS)
                faults.clear()
                return (got.column("v").to_pylist(),
                        retries("client.retry") - retry0 >= 1)

    @pytest.mark.parametrize("plan, k, want", [
        ({"site": "net.connect", "kind": "refused", "at": 1, "count": 1},
         7, [21]),
        # The client's request send is call 1, the response's call 2.
        ({"site": "net.send", "kind": "torn-frame", "at": 2, "count": 1},
         3, [9]),
        ({"site": "net.recv", "kind": "reset", "at": 1, "count": 1},
         4, [12]),
        ({"site": "net.accept", "kind": "reset", "at": 1, "count": 1},
         5, [15]),
    ], ids=["connect_refused_fails_over", "torn_response_frame_is_retryable",
            "recv_reset_fails_over", "accept_reset_fails_over"])
    def test_fault_fails_over(self, env, plan, k, want):
        sessions, data = env

        def run(pkg):
            return self._fleet_answer(pkg, sessions[pkg], data, k, plan)

        assert _both(run)[TORCH] == (want, True)


# ---------------------------------------------------------------------------
# The port's own: one package's plan, and the path with no wire plan
# ---------------------------------------------------------------------------
def test_a_plan_arms_only_its_own_package(env):
    """A wire plan of either package fires none of the other's seams
    and counts none of their calls."""
    sessions, data = env
    for armed in PKGS:
        other = TORCH if armed is JAX else JAX
        faults = _faults(armed)
        plan = faults.FaultPlan(site="net.send", kind="reset", at=1,
                                count=-1)
        faults.install(plan)
        try:
            assert _netfaults(other).armed() is False
            assert _faults(other).net("net.send") is None
            srv = _server(other)
            with srv.QueryServer(sessions[other]) as server:
                with srv.QueryClient(server.address,
                                     timeout_s=SOCKET_S) as c:
                    assert c.query(_point_spec(data, 2)) \
                        .column("v").to_pylist() == [6]
            assert plan._calls == 0
        finally:
            faults.clear()


@pytest.mark.parametrize("mode", ["threaded", "async"])
def test_no_wire_plan_writes_straight_to_the_socket(env, monkeypatch,
                                                    mode):
    """With no plan, or a plan on a file site, the server never takes the
    buffered detour: ``netfaults.send_all`` sees only the client's
    request lines, sent from this thread.  A wire plan that never fires
    (``net.connect`` at its 1000th call) sends the response through it."""
    sessions, data = env
    server_mod = _server(TORCH)
    netfaults = server_mod.netfaults
    real_send = netfaults.send_all
    me = threading.current_thread()
    senders = []

    def send_all(sock, payload):
        senders.append("client" if threading.current_thread() is me
                       else "server")
        real_send(sock, payload)

    monkeypatch.setattr(netfaults, "send_all", send_all)
    faults = _faults(TORCH)
    sessions[TORCH].conf.serving_io_mode = mode
    got = []
    with server_mod.QueryServer(sessions[TORCH]) as server:
        with server_mod.QueryClient(server.address,
                                    timeout_s=SOCKET_S) as c:
            for plan in (None,
                         faults.FaultPlan(site="log.write", kind="eio"),
                         faults.FaultPlan(site="net.connect",
                                          kind="refused", at=1000)):
                faults.install(plan)
                got.append(c.query(_point_spec(data, 4))
                           .column("v").to_pylist())
    assert got == [[12]] * 3
    assert senders == ["client", "client", "client", "server"]
