"""The port's serving layer (hyperspace_tpu_torch/interop/server.py) held
to tests/test_serving.py: the wire-error taxonomy, the retry-after hint,
admission and shedding, deadlines, the plan cache, the send timeout, a
mixed stress and the drain, SIGTERM included.

Where the JAX file leans on an 8,000,000-row group-by to hold a worker,
these cases hold it with a gate instead: :func:`gate` wraps the server's
``_Responder._make_query_fn`` so a query over the ``slow`` table waits
on a ``threading.Event`` that the test opens.  The outcomes are then
deterministic.  Every socket has a timeout, every server is stopped in a
``finally`` or a ``with``, every join and wait has a bound, and every
server binds port 0.  The parsing cases run through both packages and
must agree."""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu.interop.server as jax_server
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
from hyperspace_tpu_torch.exceptions import DeadlineExceededError
from hyperspace_tpu_torch.interop import (
    QueryClient,
    QueryFailedError,
    QueryServer,
    ServerBusyError,
    parse_wire_error,
    request_query,
)
from hyperspace_tpu_torch.interop import server as server_mod
from hyperspace_tpu_torch.lifecycle import daemon as lifecycle_daemon
from hyperspace_tpu_torch.telemetry import flight_recorder, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUND_S = 30.0  # every join, wait and socket read in this file


@pytest.fixture(autouse=True)
def _clean_process_state():
    yield
    flight_recorder.reset()
    lifecycle_daemon.clear_drain()  # drain() sets the process-wide latch


@pytest.fixture()
def env(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    rng = np.random.default_rng(11)
    n = 1000
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(0, 100, n), type=pa.int64()),
        "w": pa.array((np.arange(n) % 5).astype(np.int64)),
    }), os.path.join(data, "f.parquet"))
    slow = str(tmp_path / "slow")
    os.makedirs(slow)
    pq.write_table(pa.table({
        "g": pa.array(rng.integers(0, 200, 4000), type=pa.int64()),
        "x": pa.array(rng.random(4000)),
        "y": pa.array(rng.random(4000)),
    }), os.path.join(slow, "p.parquet"))
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    s.conf.num_buckets = 4
    for kind in ("filter", "join", "agg", "build"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    return s, data, slow


class _Gate:
    """Holds every served query over one source until the test opens it;
    counts the queries that reached it."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.opened = threading.Event()
        self._cond = threading.Condition()
        self.running = 0

    def wrap(self, fn):
        def gated():
            with self._cond:
                self.running += 1
                self._cond.notify_all()
            if not self.opened.wait(BOUND_S):
                raise TimeoutError("the test never opened the gate")
            return fn()
        return gated

    def wait_running(self, n: int) -> None:
        with self._cond:
            assert self._cond.wait_for(lambda: self.running >= n, BOUND_S), \
                f"{self.running} of {n} gated queries reached a worker"

    def open(self) -> None:
        self.opened.set()


@pytest.fixture()
def gate(env, monkeypatch):
    g = _Gate(env[2])
    real = server_mod._Responder._make_query_fn

    def make(self, spec):
        fn, kind = real(self, spec)
        source = spec.get("source")
        if isinstance(source, dict) and source.get("path") == g.path:
            return g.wrap(fn), kind
        return fn, kind

    monkeypatch.setattr(server_mod._Responder, "_make_query_fn", make)
    yield g
    g.open()  # never leave a worker waiting


def _slow_spec(slow):
    return {"source": {"format": "parquet", "path": slow},
            "group_by": ["g"],
            "aggs": {"t": ["x", "sum"], "m": ["x", "mean"],
                     "y2": ["y", "sum"]},
            "sort": [["t", False]], "limit": 5}


def _point_spec(data, k):
    return {"source": {"format": "parquet", "path": data},
            "filter": {"op": "==", "col": "k", "value": int(k)},
            "select": ["k", "v"]}


def _counter(name):
    return metrics.registry().counter(name)


def _until(cond, what: str) -> None:
    """Wait (bounded) for a condition another thread makes true."""
    end = time.monotonic() + BOUND_S
    while not cond():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.005)


def _start(target, *args, **kwargs) -> threading.Thread:
    t = threading.Thread(target=target, args=args, kwargs=kwargs,
                         daemon=True)
    t.start()
    return t


def _join(threads) -> None:
    for t in threads:
        t.join(timeout=BOUND_S)
    assert not any(t.is_alive() for t in threads), "a thread hung"


def _fields(e):
    return (type(e).__name__, e.code, e.message, e.retryable, e.trace_id,
            e.retry_after_ms, str(e))


# ---------------------------------------------------------------------------
# Wire-error taxonomy
# ---------------------------------------------------------------------------
class TestTaxonomy:
    @pytest.mark.parametrize("parse", [jax_server.parse_wire_error,
                                       parse_wire_error],
                             ids=["jax", "torch"])
    def test_parse_coded_and_bare_forms(self, parse):
        e = parse("ERR BUSY admission queue full (depth 4)")
        assert type(e).__name__ == "ServerBusyError"
        assert e.code == "BUSY" and e.retryable
        assert "queue full" in e.message
        e = parse("ERR DEADLINE deadline exceeded at Join")
        assert e.code == "DEADLINE" and e.retryable
        e = parse("ERR BADREQ request must be a JSON object")
        assert e.code == "BADREQ" and not e.retryable
        # Pre-taxonomy servers sent bare messages: still parse, FAILED.
        e = parse("ERR something broke badly")
        assert e.code == "FAILED" and not e.retryable
        assert e.message == "something broke badly"
        assert "Query failed: something broke badly" in str(e)

    def test_both_packages_parse_alike(self):
        for line in ("ERR BUSY admission queue full (depth 4)",
                     "ERR DEADLINE deadline exceeded at Join",
                     "ERR BADREQ request must be a JSON object",
                     "ERR FAILED KeyError: 'x' trace=0123456789abcdef",
                     "ERR something broke badly", "ERR BUSY",
                     "ERR BUSY queue full retry-after-ms=240 "
                     "trace=0123456789abcdef"):
            assert _fields(parse_wire_error(line)) == \
                _fields(jax_server.parse_wire_error(line)), line

    def test_badreq_on_wire(self, env):
        s, data, _ = env
        with QueryServer(s) as server:
            with pytest.raises(QueryFailedError, match="must be a string") \
                    as ei:
                request_query(server.address, {"sql": 123, "tables": {}})
        assert ei.value.code == "BADREQ"
        assert not ei.value.retryable

    def test_failed_on_engine_error(self, env):
        s, data, _ = env
        spec = {"source": {"format": "parquet", "path": data},
                "filter": {"op": "==", "col": "no_such_col", "value": 1}}
        with QueryServer(s) as server:
            with pytest.raises(QueryFailedError) as ei:
                request_query(server.address, spec)
        assert ei.value.code == "FAILED"

    def test_bad_deadline_is_badreq(self, env):
        s, data, _ = env
        with QueryServer(s) as server:
            with pytest.raises(QueryFailedError, match="deadline_ms") as ei:
                request_query(server.address,
                              {**_point_spec(data, 1), "deadline_ms": -5})
        assert ei.value.code == "BADREQ"

    def test_device_error_crosses_as_failed_and_the_worker_survives(
            self, env, monkeypatch):
        """A kernel or CUDA error is FAILED with its type name, counted,
        and never rerun elsewhere; the worker serves the next query."""
        s, data, _ = env
        s.conf.serving_workers = 1
        real = server_mod._Responder._make_query_fn
        calls = []

        def boom(self, spec):
            fn, kind = real(self, spec)
            if spec.get("filter", {}).get("value") == 13:
                def fail():
                    calls.append(1)
                    raise RuntimeError("CUDA error: an illegal memory "
                                       "access was encountered")
                return fail, kind
            return fn, kind

        monkeypatch.setattr(server_mod._Responder, "_make_query_fn", boom)
        failed0 = _counter("serve.err.failed")
        with QueryServer(s) as server:
            with pytest.raises(QueryFailedError, match="illegal memory") \
                    as ei:
                request_query(server.address, _point_spec(data, 13))
            out = request_query(server.address, _point_spec(data, 14))
        assert ei.value.code == "FAILED"
        assert ei.value.message.startswith("RuntimeError: CUDA error")
        assert calls == [1]
        assert _counter("serve.err.failed") - failed0 == 1
        assert out.column("k").to_pylist() == [14]


class TestRetryAfter:
    @pytest.mark.parametrize("parse", [jax_server.parse_wire_error,
                                       parse_wire_error],
                             ids=["jax", "torch"])
    def test_parse_hint_and_compat(self, parse):
        e = parse("ERR BUSY queue full retry-after-ms=240 "
                  "trace=0123456789abcdef")
        assert type(e).__name__ == "ServerBusyError"
        assert e.retry_after_ms == 240
        assert e.trace_id == "0123456789abcdef"
        assert "queue full" in e.message
        e = parse("ERR BUSY queue full retry-after-ms=100")
        assert e.retry_after_ms == 100 and e.trace_id is None
        e = parse("ERR BUSY queue full")
        assert e.retry_after_ms is None and e.retryable
        e = parse("ERR something broke badly")
        assert e.code == "FAILED" and e.retry_after_ms is None

    def test_busy_shed_carries_hint_on_wire(self, env):
        s, data, _ = env
        with QueryServer(s) as server:
            server.pool.draining = True  # the cheapest deterministic shed
            with pytest.raises(ServerBusyError) as ei:
                request_query(server.address, _point_spec(data, 1))
        assert ei.value.retry_after_ms is not None
        assert ei.value.retry_after_ms >= 100  # the idle-queue floor
        assert ei.value.trace_id is not None   # the hint and the echo

    def test_hint_tracks_queue_wait_ewma(self, env):
        s, _data, _ = env
        with QueryServer(s) as server:
            pool = server.pool
            with pool._lock:
                pool._queue_wait_ewma_ms = 5000.0
            assert pool.retry_after_hint_ms() == 10_000  # ~2x the wait
            with pool._lock:
                pool._queue_wait_ewma_ms = 10_000_000.0
            assert pool.retry_after_hint_ms() == 30_000  # capped
            with pool._lock:
                pool._queue_wait_ewma_ms = 0.0
            assert pool.retry_after_hint_ms() == 100     # floored


# ---------------------------------------------------------------------------
# Admission control and shedding
# ---------------------------------------------------------------------------
class TestAdmission:
    def test_queue_full_sheds_busy_and_counters_match(self, env, gate):
        s, _data, slow = env
        s.conf.serving_workers = 1
        s.conf.serving_queue_depth = 1
        shed0 = _counter("serve.shed.queue_full")
        results, errors = [], []
        lock = threading.Lock()

        def client():
            try:
                out = request_query(server.address, _slow_spec(slow))
                with lock:
                    results.append(out)
            except QueryFailedError as e:
                with lock:
                    errors.append(e)

        with QueryServer(s) as server:
            held = [_start(client)]
            gate.wait_running(1)  # the one worker holds the first
            held.append(_start(client))
            _until(lambda: server.pool._queue.qsize() == 1,
                   "the second request queued")
            storm = [_start(client) for _ in range(6)]
            _join(storm)  # every one of them shed without waiting
            gate.open()
            _join(held)
        # 1 running + 1 queued were admitted; the other six shed FAST.
        assert len(results) == 2 and len(errors) == 6
        assert all(isinstance(e, ServerBusyError) for e in errors)
        assert all(e.retryable for e in errors)
        for out in results:
            assert out.num_rows == 5
        assert _counter("serve.shed.queue_full") - shed0 == len(errors)

    def test_connection_capacity_rejected_in_accept_loop(self, env, gate):
        s, _data, slow = env
        s.conf.serving_workers = 2
        s.conf.serving_max_connections = 2
        done = []

        def slow_client():
            done.append(request_query(server.address, _slow_spec(slow)))

        with QueryServer(s) as server:
            holders = [_start(slow_client) for _ in range(2)]
            gate.wait_running(2)  # both connections open and serving
            with pytest.raises(ServerBusyError, match="connection capacity"):
                request_query(server.address, {"verb": "metrics"})
            gate.open()
            _join(holders)
        assert len(done) == 2

    def test_thread_count_bounded_under_connection_storm(self, env):
        """clients >> max_connections + workers: handler threads never
        exceed max_connections (refusals happen IN the accept loop) and
        the storm leaves no thread behind."""
        s, data, _ = env
        s.conf.serving_workers = 2
        s.conf.serving_max_connections = 4
        s.conf.serving_queue_depth = 2

        def handler_threads():
            return [t for t in threading.enumerate()
                    if "process_request_thread" in t.name]

        peak = [0]
        stop = threading.Event()

        def sampler():
            while not stop.is_set():
                peak[0] = max(peak[0], len(handler_threads()))
                time.sleep(0.002)

        outcomes = []
        lock = threading.Lock()

        def client(i):
            try:
                out = request_query(server.address,
                                    _point_spec(data, i % 1000))
                with lock:
                    outcomes.append(("ok", out.column("k").to_pylist()))
            except (QueryFailedError, ConnectionError) as e:
                with lock:
                    outcomes.append(("err", getattr(e, "code", "conn")))

        with QueryServer(s) as server:
            smp = _start(sampler)
            for _wave in range(3):
                _join([_start(client, i) for i in range(20)])
            stop.set()
            _join([smp])
            assert peak[0] <= 4, peak[0]
            assert len(outcomes) == 60
            for kind, val in outcomes:
                if kind == "ok":
                    assert len(val) == 1
                else:
                    assert val in ("BUSY", "conn")
            assert any(kind == "ok" for kind, _ in outcomes)
        _until(lambda: not handler_threads(), "the handler threads to end")

    def test_rss_watermark_sheds(self, env):
        s, data, _ = env
        s.conf.serving_shed_rss_watermark_mb = 1.0  # any process is > 1 MB
        shed0 = _counter("serve.shed.memory")
        with QueryServer(s) as server:
            with pytest.raises(ServerBusyError, match="memory watermark"):
                request_query(server.address, _point_spec(data, 1))
        assert _counter("serve.shed.memory") - shed0 == 1

    def test_queue_wait_watermark_sheds(self, env, gate):
        s, data, slow = env
        s.conf.serving_workers = 1
        s.conf.serving_shed_queue_wait_watermark_ms = 50.0
        with QueryServer(s) as server:
            held = [_start(request_query, server.address, _slow_spec(slow))]
            gate.wait_running(1)
            held.append(_start(request_query, server.address,
                               _slow_spec(slow)))
            _until(lambda: server.pool._queue.qsize() == 1,
                   "the second request queued")
            with server.pool._lock:
                server.pool._queue_wait_ewma_ms = 500.0
            with pytest.raises(ServerBusyError, match="queue-wait"):
                request_query(server.address, _point_spec(data, 1))
            gate.open()
            _join(held)


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------
class TestDeadline:
    def test_expiry_surfaces_deadline_code(self, env, gate):
        s, _data, slow = env
        exp0 = _counter("serve.deadline.expired")
        with QueryServer(s) as server:
            with pytest.raises(QueryFailedError, match="deadline") as ei:
                request_query(server.address,
                              {**_slow_spec(slow), "deadline_ms": 30})
            gate.open()
            assert server.pool.wait_idle(BOUND_S)
        assert ei.value.code == "DEADLINE"
        assert ei.value.retryable
        assert _counter("serve.deadline.expired") - exp0 >= 1
        # The worker recorded what the client was answered.
        outcomes = [(r["kind"], r["outcome"], r["error"][:9])
                    for r in flight_recorder.recorder().records()]
        assert ("spec", "DEADLINE", "abandoned") in outcomes

    def test_conf_default_deadline_applies(self, env, gate):
        s, _data, slow = env
        s.conf.serving_default_deadline_ms = 30.0
        with QueryServer(s) as server:
            with pytest.raises(QueryFailedError) as ei:
                request_query(server.address, _slow_spec(slow))
            gate.open()
        assert ei.value.code == "DEADLINE"

    def test_expired_in_the_queue_is_never_run(self, env, gate):
        s, data, slow = env
        s.conf.serving_workers = 1
        with QueryServer(s) as server:
            held = _start(request_query, server.address, _slow_spec(slow))
            gate.wait_running(1)
            with pytest.raises(QueryFailedError) as ei:
                request_query(server.address,
                              {**_slow_spec(slow), "deadline_ms": 20})
            gate.open()
            _join([held])
            assert server.pool.wait_idle(BOUND_S)
        assert ei.value.code == "DEADLINE"
        assert gate.running == 1  # the queued one never reached the gate

    def test_within_deadline_succeeds(self, env):
        s, data, _ = env
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                out = client.query(_point_spec(data, 7), deadline_ms=30_000)
        assert out.column("k").to_pylist() == [7]

    def test_deadline_never_triggers_degraded_fallback(self, env):
        """An expired deadline propagates and never re-plans from the
        source (the dataset.collect guard)."""
        from hyperspace_tpu_torch.utils import deadline

        s, data, _ = env
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data),
                        IndexConfig("dl_ix", ["k"], ["v"]))
        s.enable_hyperspace()
        ds = s.read.parquet(data)
        with deadline.scope(1e-9):
            with pytest.raises(DeadlineExceededError):
                ds.collect()
        rep = ds.last_run_report()
        assert rep.outcome == "error"
        assert not [d for d in rep.decisions if d["kind"] == "replan"]


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------
class TestPlanCache:
    def test_repeat_query_hits_cache(self, env):
        s, data, _ = env
        with QueryServer(s) as server:
            hits0 = _counter("serve.plan_cache.hits")
            with QueryClient(server.address) as client:
                a = client.query(_point_spec(data, 5))
                b = client.query(_point_spec(data, 5))
        assert a.equals(b)
        assert a.column("k").to_pylist() == [5]
        assert _counter("serve.plan_cache.hits") - hits0 >= 1

    def test_disabled_cache_never_hits(self, env):
        s, data, _ = env
        s.conf.serving_plan_cache_enabled = False
        with QueryServer(s) as server:
            assert server.plan_cache is None
            hits0 = _counter("serve.plan_cache.hits")
            with QueryClient(server.address) as client:
                for _ in range(2):
                    client.query(_point_spec(data, 5))
        assert _counter("serve.plan_cache.hits") == hits0

    def test_different_literals_never_conflated(self, env):
        """One shape, other literals: the literal digest in the key keeps
        bucket-pruned plans apart."""
        s, data, _ = env
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data),
                        IndexConfig("pc_ix", ["k"], ["v"]))
        s.enable_hyperspace()
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                for k in (5, 7, 5, 7, 11):
                    out = client.query(_point_spec(data, k))
                    assert out.column("k").to_pylist() == [k]

    def test_index_build_invalidates_cached_plans(self, env):
        """create_index while the server runs bumps the plan-cache
        generation: the next served request re-plans onto the index."""
        s, data, _ = env
        s.enable_hyperspace()
        with QueryServer(s) as server:
            with QueryClient(server.address) as client:
                out = client.query(_point_spec(data, 9))
                assert out.column("k").to_pylist() == [9]
                hs = Hyperspace(s)
                hs.create_index(s.read.parquet(data),
                                IndexConfig("inv_ix", ["k"], ["v"]))
                out2 = client.query(_point_spec(data, 9))
                assert out2.column("k").to_pylist() == [9]
                table = client.query({"verb": "last_run_report"})
        report = json.loads(table.column("report_json").to_pylist()[0])
        assert report["indexes_used"] == ["inv_ix"]

    def test_ttl_and_generation_staleness(self, env):
        from hyperspace_tpu_torch import col
        from hyperspace_tpu_torch.execution import plan_cache as pc

        s, data, _ = env
        cache = pc.PlanCache(budget_bytes=1 << 20, ttl_s=1e9)
        ds = s.read.parquet(data).filter(col("k") == 3)
        key = cache.key_for(s, ds.plan)
        assert key is not None
        plan = ds.optimized_plan()
        cache.put(key, plan)
        assert cache.get(key) is plan
        pc.bump_generation()
        assert cache.get(key) is None  # generation-stale
        cache.put(key, plan)
        cache.ttl_s = 0.0
        time.sleep(0.01)
        assert cache.get(key) is None  # TTL-stale


# ---------------------------------------------------------------------------
# Send-side timeout (the dead reader)
# ---------------------------------------------------------------------------
class TestSendTimeout:
    def test_dead_reader_frees_the_connection_thread(self, env, tmp_path):
        """A client that asks for ~24 MB and then never READS: the send
        timeout frees the handler, and the server keeps serving."""
        s, data, _ = env
        big = str(tmp_path / "big")
        os.makedirs(big)
        n = 1_000_000
        pq.write_table(pa.table({
            "g": pa.array(np.arange(n, dtype=np.int64)),
            "x": pa.array(np.linspace(0.0, 1.0, n)),
            "y": pa.array(np.linspace(1.0, 2.0, n)),
        }), os.path.join(big, "p.parquet"))
        s.conf.serving_send_timeout_s = 1.0
        st0 = _counter("serve.send_timeouts")
        with QueryServer(s) as server:
            sock = socket.create_connection(server.address, timeout=BOUND_S)
            try:
                # A tiny receive buffer, so the server's send side fills
                # and blocks.
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
                sock.sendall(json.dumps({
                    "source": {"format": "parquet", "path": big},
                }).encode() + b"\n")
                # Never read a byte: the dead reader.
                _until(lambda: _counter("serve.send_timeouts") - st0 >= 1,
                       "the send timeout")
                out = request_query(server.address, _point_spec(data, 3))
                assert out.column("k").to_pylist() == [3]
            finally:
                sock.close()


# ---------------------------------------------------------------------------
# Mixed-workload stress: correctness under concurrency
# ---------------------------------------------------------------------------
class TestStress:
    def test_mixed_filter_join_agg_no_lost_or_interleaved(self, env,
                                                          tmp_path):
        s, data, _ = env
        dim = str(tmp_path / "dim")
        os.makedirs(dim)
        pq.write_table(pa.table({
            "k2": pa.array(np.arange(1000, dtype=np.int64)),
            "z": pa.array((np.arange(1000) % 3).astype(np.int64)),
        }), os.path.join(dim, "f.parquet"))
        join_spec = {
            "source": {"format": "parquet", "path": data},
            "join": {"source": {"format": "parquet", "path": dim},
                     "on": {"op": "==", "col": "k", "right_col": "k2"}},
            "group_by": ["z"], "aggs": {"n": ["v", "count"]}}
        agg_spec = {"source": {"format": "parquet", "path": data},
                    "group_by": ["w"], "aggs": {"t": ["v", "sum"]}}
        want_t = None  # the sorted answer, set once the server runs
        failures = []
        lock = threading.Lock()

        def worker(i):
            try:
                with QueryClient(server.address, timeout_s=BOUND_S) as client:
                    for r in range(5):
                        kind = (i + r) % 3
                        if kind == 0:
                            out = client.query(_point_spec(data, i * 7 + r))
                            assert out.column("k").to_pylist() == \
                                [i * 7 + r]
                        elif kind == 1:
                            out = client.query(join_spec)
                            assert out.num_rows == 3
                            assert sum(out.column("n").to_pylist()) == 1000
                        else:
                            out = client.query(agg_spec)
                            assert out.sort_by("w").equals(want_t)
            except Exception as e:  # noqa: BLE001 - collected for report
                with lock:
                    failures.append((i, repr(e)))

        # More threads than cores, and a short switch interval, so a lost
        # update or a torn frame between workers would show.
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with QueryServer(s) as server:
                want_t = request_query(server.address,
                                       agg_spec).sort_by("w")
                _join([_start(worker, i) for i in range(12)])
        finally:
            sys.setswitchinterval(interval)
        assert not failures, failures


# ---------------------------------------------------------------------------
# Graceful drain
# ---------------------------------------------------------------------------
class TestDrain:
    def test_drain_completes_inflight_then_closes(self, env, gate):
        s, _data, slow = env
        s.conf.serving_workers = 2
        result, drained = {}, {}
        server = QueryServer(s).start()
        try:
            t = _start(lambda: result.update(
                out=request_query(server.address, _slow_spec(slow))))
            gate.wait_running(1)  # admitted and executing
            drainer = _start(lambda: drained.update(
                clean=server.drain(grace_s=BOUND_S)))
            _until(lambda: server.pool.draining, "the drain to begin")
            gate.open()
            _join([t, drainer])
            assert drained["clean"] is True
            assert lifecycle_daemon.draining()  # the daemon is parked too
            assert result["out"].num_rows == 5  # in flight, and FINISHED
            assert server.drained.is_set()
            with pytest.raises(OSError):
                socket.create_connection(server.address, timeout=2)
        finally:
            server.stop()  # idempotent after drain

    def test_drain_sheds_new_requests_busy(self, env, gate):
        s, data, slow = env
        s.conf.serving_workers = 1
        slow_done = {}
        server = QueryServer(s).start()
        client = QueryClient(server.address, timeout_s=BOUND_S)
        try:
            assert client.query(_point_spec(data, 1)).num_rows == 1
            t = _start(lambda: slow_done.update(
                out=request_query(server.address, _slow_spec(slow))))
            gate.wait_running(1)
            drainer = _start(server.drain, grace_s=BOUND_S)
            _until(lambda: server.pool.draining, "the drain to begin")
            with pytest.raises(ServerBusyError, match="draining"):
                client.query(_point_spec(data, 2))
            gate.open()
            _join([t, drainer])
            assert slow_done["out"].num_rows == 5
        finally:
            client.close()
            server.stop()

    def test_sigterm_drains_inflight_in_subprocess(self, env, tmp_path):
        """The real signal path, in a process of its own (no handler is
        installed in this one): SIGTERM mid-query, the response still
        arrives whole, then the process exits 0.  The served query is
        held until the drain has begun."""
        _s, _data, slow = env
        script = textwrap.dedent("""
            import json, sys, time
            from hyperspace_tpu_torch import HyperspaceSession
            from hyperspace_tpu_torch.interop import QueryServer
            from hyperspace_tpu_torch.interop import server as srv

            s = HyperspaceSession(system_path=sys.argv[1], device="cpu")
            server = QueryServer(s, handle_sigterm=True)
            real = srv._Responder._make_query_fn

            def make(self, spec):
                fn, kind = real(self, spec)

                def held():
                    print(json.dumps({"running": True}), flush=True)
                    end = time.monotonic() + 60
                    while not server.pool.draining:
                        if time.monotonic() > end:
                            raise TimeoutError("no SIGTERM came")
                        time.sleep(0.005)
                    return fn()
                return held, kind

            srv._Responder._make_query_fn = make
            server.start()
            print(json.dumps({"port": server.address[1]}), flush=True)
            sys.exit(0 if server.drained.wait(120) else 3)
        """)
        env_vars = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-c", script, str(tmp_path / "ix2")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env_vars)
        try:
            port = json.loads(proc.stdout.readline())["port"]
            sock = socket.create_connection(("127.0.0.1", port),
                                            timeout=60)
            sock.sendall(json.dumps(_slow_spec(slow)).encode() + b"\n")
            assert json.loads(proc.stdout.readline()) == {"running": True}
            proc.send_signal(signal.SIGTERM)
            f = sock.makefile("rb")
            assert f.readline().startswith(b"OK")  # in flight: COMPLETED
            table = pa.ipc.open_stream(f).read_all()
            assert table.num_rows == 5
            sock.close()
            assert proc.wait(timeout=60) == 0
        finally:
            proc.kill()
            proc.wait(timeout=30)
