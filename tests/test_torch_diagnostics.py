"""The port's diagnostics held to the JAX package's: the trace context
(interop/query.py), the flight recorder (telemetry/flight_recorder.py),
the SLO math (telemetry/slo.py) and the doctor (telemetry/doctor.py).

tests/test_flight_recorder.py is the oracle for the recorder.  Its cases
that need no server run here against both packages: trace-context
parsing, retention, the local feed, HELP lines and exemplars, bundles.
The bundle cases run on each package's default store
(``EmulatedObjectStore``), and on ``PosixLogStore`` pinned in both
(``TestBundlesPosix``); ``test_request_scope_suppresses_local_feed``
holds a collect inside a served request's scope unrecorded in both.
One seeded workload through both packages must keep the same records
(kinds, outcomes, reasons), and ``slo.py`` must
give the JAX functions' results on seeded samples.  The doctor runs the
same steps in both packages and must grade every check alike, leaving
out the JAX doctor's ``lint`` check (the port has no lint baseline);
``fleet=True`` answers in both alike (tests/test_torch_fleet.py holds the
fleet plane itself); ``test_phase_r_on_the_cpu`` rehearses chip_smoke's
phase R."""

from __future__ import annotations

import importlib
import json
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession
from hyperspace_tpu_torch.telemetry import flight_recorder, metrics, timeline
from hyperspace_tpu_torch.telemetry import trace

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PACKAGES = (JAX, TORCH)
IDS = ("jax", "torch")


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


@pytest.fixture(autouse=True)
def _fresh_rings():
    for pkg in PACKAGES:
        _m(pkg, "telemetry.flight_recorder").reset()
    yield
    for pkg in PACKAGES:
        _m(pkg, "telemetry.flight_recorder").reset()
    trace.disable_tracing()
    timeline.disable_timeline()


def _session(pkg, root: str, name: str = "ix", store: str = ""):
    """A session of ``pkg``; ``store`` pins a class of its
    io/log_store.py, else both packages keep their default
    (``EmulatedObjectStore``)."""
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, name), **kw)
    s.conf.num_buckets = 4
    for kind in ("filter", "join", "agg", "build"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    if store:
        s.conf.log_store_class = f"{pkg.__name__}.io.log_store.{store}"
    return s


def _write(path: str, n: int = 1000, start: int = 0, name: str = "f") -> None:
    os.makedirs(path, exist_ok=True)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(start, start + n, dtype=np.int64)),
        "v": pa.array((np.arange(n) % 5).astype(np.int64)),
    }), os.path.join(path, f"{name}.parquet"))


@pytest.fixture()
def env(tmp_path):
    data = str(tmp_path / "data")
    _write(data)
    return str(tmp_path), data


# ---------------------------------------------------------------------------
# Trace-context parsing (TestTraceContextParsing)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES, ids=IDS)
class TestTraceContextParsing:
    def test_mint_shape(self, pkg):
        q = _m(pkg, "interop.query")
        tid = q.mint_trace_id()
        assert q.valid_trace_id(tid) and len(tid) == 16
        assert q.mint_trace_id() != tid

    def test_valid_ids_adopted_and_popped(self, pkg):
        q = _m(pkg, "interop.query")
        spec = {"trace_id": "00ff00ff00ff00ff",
                "request_id": "1234567890abcdef", "sql": "x"}
        tid, rid, adopted = q.pop_trace_context(spec)
        assert adopted
        assert tid == "00ff00ff00ff00ff" and rid == "1234567890abcdef"
        assert "trace_id" not in spec and "request_id" not in spec

    def test_uppercase_normalizes(self, pkg):
        q = _m(pkg, "interop.query")
        tid, _rid, adopted = q.pop_trace_context(
            {"trace_id": "00FF00FF00FF00FF"})
        assert adopted and tid == "00ff00ff00ff00ff"

    @pytest.mark.parametrize("bad", [
        "short", "00ff00ff00ff00ff00", "zzzzzzzzzzzzzzzz",
        "00ff00ff00ff00f ", "", 1234567890123456, 12.5, None, True,
        ["00ff00ff00ff00ff"], {"id": "00ff00ff00ff00ff"},
    ])
    def test_malformed_ids_fall_back_to_minted(self, pkg, bad):
        q = _m(pkg, "interop.query")
        spec = {"trace_id": bad, "request_id": bad, "source": {}}
        tid, rid, adopted = q.pop_trace_context(spec)
        assert not adopted
        assert q.valid_trace_id(tid) and q.valid_trace_id(rid)
        assert "trace_id" not in spec and "request_id" not in spec

    def test_missing_ids_minted_independently(self, pkg):
        q = _m(pkg, "interop.query")
        tid, rid, adopted = q.pop_trace_context({})
        assert not adopted and q.valid_trace_id(tid) \
            and q.valid_trace_id(rid)
        tid2, rid2, adopted2 = q.pop_trace_context(
            {"trace_id": "a" * 16, "request_id": "nope"})
        assert adopted2 and tid2 == "a" * 16 and q.valid_trace_id(rid2)


def test_interop_exports_the_jax_query_names():
    """The spec codec's, the server's and the fleet client's names, as
    the JAX package exports them."""
    assert set(_m(TORCH, "interop").__all__) == \
        set(_m(JAX, "interop").__all__)


# ---------------------------------------------------------------------------
# Retention (TestRetention)
# ---------------------------------------------------------------------------
def _conf(pkg, **over):
    c = _m(pkg, "config").HyperspaceConf()
    for k, v in over.items():
        setattr(c, k, v)
    return c


def _rec(pkg, recorder, conf, outcome, latency_ms=1.0, tid=None):
    mint = _m(pkg, "interop.query").mint_trace_id
    return recorder.record(
        conf, kind="spec", outcome=outcome, latency_ms=latency_ms,
        trace_id=tid or mint(), request_id=mint())


@pytest.mark.parametrize("pkg", PACKAGES, ids=IDS)
class TestRetention:
    def _r(self, pkg):
        return _m(pkg, "telemetry.flight_recorder").FlightRecorder()

    def test_interesting_outcomes_always_retained(self, pkg):
        r = self._r(pkg)
        conf = _conf(pkg, flight_recorder_healthy_sample_n=0)
        for outcome in ("FAILED", "DEADLINE", "BUSY", "BADREQ", "error",
                        "degraded"):
            assert _rec(pkg, r, conf, outcome)
        assert not _rec(pkg, r, conf, "OK")
        assert {x["outcome"] for x in r.records()} == {
            "FAILED", "DEADLINE", "BUSY", "BADREQ", "error", "degraded"}
        assert all(x["reason"] == "error" for x in r.records())

    def test_slow_threshold_retains(self, pkg):
        r = self._r(pkg)
        conf = _conf(pkg, flight_recorder_slow_ms=50.0,
                     flight_recorder_healthy_sample_n=0)
        assert not _rec(pkg, r, conf, "OK", latency_ms=49.0)
        assert _rec(pkg, r, conf, "OK", latency_ms=51.0)
        (rec,) = r.records()
        assert rec["slow"] and rec["reason"] == "slow"

    def test_healthy_sampling_one_in_n(self, pkg):
        r = self._r(pkg)
        conf = _conf(pkg, flight_recorder_healthy_sample_n=4)
        assert sum(_rec(pkg, r, conf, "OK") for _ in range(16)) == 4

    def test_disabled_keeps_nothing(self, pkg):
        r = self._r(pkg)
        conf = _conf(pkg, flight_recorder_enabled=False)
        assert not _rec(pkg, r, conf, "FAILED")
        assert r.records() == []

    def test_healthy_evicted_before_interesting(self, pkg):
        r = self._r(pkg)
        conf = _conf(pkg, flight_recorder_max_records=16,
                     flight_recorder_healthy_sample_n=1)
        for _ in range(12):
            assert _rec(pkg, r, conf, "OK")
        mint = _m(pkg, "interop.query").mint_trace_id
        error_ids = [mint() for _ in range(8)]
        for tid in error_ids:
            assert _rec(pkg, r, conf, "DEADLINE", tid=tid)
        recs = r.records()
        assert len(recs) == 16
        assert set(error_ids) <= {x["trace_id"] for x in recs}
        assert sum(1 for x in recs if x["outcome"] == "OK") == 8

    def test_ring_bound_under_threaded_storm(self, pkg):
        r = self._r(pkg)
        conf = _conf(pkg, flight_recorder_max_records=32,
                     flight_recorder_healthy_sample_n=1)
        errors: list = []

        def storm(seed: int) -> None:
            try:
                for i in range(200):
                    outcome = ("FAILED", "DEADLINE", "BUSY", "OK")[
                        (seed + i) % 4]
                    _rec(pkg, r, conf, outcome, latency_ms=float(i % 7))
                    if i % 50 == 0:
                        assert len(r.records()) <= 32
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=storm, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors
        recs = r.records()
        assert len(recs) == 32
        assert all(x["outcome"] != "OK" for x in recs)

    def test_record_never_raises_on_broken_input(self, pkg):
        r = self._r(pkg)

        class Broken:
            decisions = ()

            def to_dict(self):
                raise RuntimeError("boom")

        mint = _m(pkg, "interop.query").mint_trace_id
        assert not r.record(_conf(pkg), kind="spec", outcome="FAILED",
                            latency_ms=1.0, trace_id=mint(),
                            request_id=mint(), report=Broken())
        assert r.records() == []


# ---------------------------------------------------------------------------
# The local feed and slow_queries() (TestLocalFeed)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES, ids=IDS)
class TestLocalFeed:
    def test_slow_local_query_lands_in_slow_queries(self, pkg, env):
        root, data = env
        s = _session(pkg, root)
        s.conf.flight_recorder_slow_ms = 0.0001
        hs = pkg.Hyperspace(s)
        s.read.parquet(data).filter(pkg.col("k") == 5).collect()
        t = hs.slow_queries()
        assert t.num_rows == 1
        assert t.column("kind")[0].as_py() == "local"
        assert t.column("outcome")[0].as_py() == "ok"
        tid = t.column("traceId")[0].as_py()
        assert _m(pkg, "interop.query").valid_trace_id(tid)
        assert hs.trace(tid)["trace_id"] == tid
        assert t.column_names == TORCH_SLOW_COLUMNS

    def test_failed_local_query_retained_with_error_outcome(self, pkg, env):
        root, data = env
        s = _session(pkg, root)
        hs = pkg.Hyperspace(s)
        with pytest.raises(Exception):
            s.read.parquet(data).filter(pkg.col("nope") == 1).collect()
        t = hs.slow_queries()
        assert t.num_rows == 1
        assert t.column("outcome")[0].as_py() == "error"

    def test_request_scope_suppresses_local_feed(self, pkg, env):
        """Inside a served request's scope the server's worker records;
        collect must not record the query a second time."""
        root, data = env
        s = _session(pkg, root)
        s.conf.flight_recorder_slow_ms = 0.0001
        mint = _m(pkg, "interop.query").mint_trace_id
        trace = _m(pkg, "telemetry.trace")
        with trace.request_scope(mint(), mint()):
            assert trace.current_request_context() is not None
            s.read.parquet(data).filter(pkg.col("k") == 5).collect()
        assert trace.current_request_context() is None
        assert _m(pkg, "telemetry.flight_recorder").recorder().records() == []


TORCH_SLOW_COLUMNS = ["ts", "traceId", "requestId", "kind", "outcome",
                      "latencyMs", "queueWaitMs", "deviceMs", "slow",
                      "reason", "error", "recordJson"]


def test_fleet_verbs_raise_in_the_port(env):
    """The three ``fleet=True`` verbs, which raised before the port had
    the fleet plane, now answer as the JAX package's: the same fleet
    checks and grades from ``doctor``, the same columns and records from
    ``slow_queries``, and ``trace`` resolving a record of the package's
    own ring with ``process`` naming this process (None for an unknown
    id).  Each package runs under its own system path."""
    root, _ = env

    def run(pkg):
        s = _session(pkg, root, name=f"fleet_{pkg.__name__}")
        hs = pkg.Hyperspace(s)
        own = _m(pkg, "telemetry.fleet").process_identity()
        _m(pkg, "telemetry.flight_recorder").record(
            s.conf, kind="spec", outcome="FAILED", latency_ms=2.0,
            trace_id="a" * 16, request_id="b" * 16, error="seeded")
        report = hs.doctor(fleet=True)
        table = hs.slow_queries(fleet=True)
        rec = hs.trace("a" * 16, fleet=True)
        return {
            "checks": [(c.name, c.status, c.data) for c in report.checks
                       if c.name.startswith("fleet.")],
            "columns": table.column_names,
            "rows": [{k: r[k] for k in ("traceId", "requestId", "kind",
                                        "outcome", "error", "reason")}
                     for r in table.to_pylist()],
            "processes": {r["process"] == own for r in table.to_pylist()},
            "trace": (rec["process"] == own, rec["error"]),
            "unknown": hs.trace("c" * 16, fleet=True)}

    got, want = run(TORCH), run(JAX)
    assert got == want
    assert [c[0] for c in got["checks"]] == [
        "fleet.heartbeats", "fleet.daemons", "fleet.serving",
        "fleet.skew", "fleet.build_claims", "fleet.alerts"]
    assert got["trace"] == (True, "seeded") and got["unknown"] is None


# ---------------------------------------------------------------------------
# HELP lines and exemplars (TestMetricsSurfacing, no server)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES, ids=IDS)
class TestMetricsSurfacing:
    def test_help_lines_from_docs16_catalog(self, pkg):
        reg = _m(pkg, "telemetry.metrics").MetricsRegistry()
        reg.inc("serve.requests")
        reg.inc("rule.filter.applied")
        reg.inc("flight.retained")
        text = reg.render_prometheus()
        assert "# HELP hyperspace_serve_requests " in text
        assert "# HELP hyperspace_rule_filter_applied " in text
        assert "# HELP hyperspace_flight_retained " in text
        assert "# TYPE hyperspace_serve_requests counter" in text
        reg.inc("not.in.catalog")
        assert "# HELP hyperspace_not_in_catalog" \
            not in reg.render_prometheus()

    def test_exemplar_links_bucket_to_trace_id(self, pkg):
        reg = _m(pkg, "telemetry.metrics").MetricsRegistry()
        tid = _m(pkg, "interop.query").mint_trace_id()
        reg.observe("serve.latency_ms", 12.0, exemplar=tid)
        reg.observe("serve.latency_ms", 700.0)
        text = reg.render_prometheus()
        assert f'# {{trace_id="{tid}"}} 12' in text
        assert text.count("trace_id=") == 1
        snap = reg.snapshot()["serve.latency_ms"]
        assert set(snap) == {"count", "sum", "min", "max", "mean",
                             "buckets"}


def test_prometheus_text_equals_the_jax_package():
    texts = []
    for pkg in PACKAGES:
        reg = _m(pkg, "telemetry.metrics").MetricsRegistry()
        reg.inc("flight.recorded", 3)
        reg.set_gauge("flight.ring_size", 2)
        reg.observe("serve.latency_ms", 12.0, exemplar="a" * 16)
        reg.set_gauge("health.status", 1)
        texts.append(reg.render_prometheus())
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# Bundles on the default store (TestBundles)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES, ids=IDS)
class TestBundles:
    # A class of io/log_store.py pinned in both packages; "" keeps the
    # default.
    store = ""

    def test_bundle_survives_restart(self, pkg, tmp_path):
        fr = _m(pkg, "telemetry.flight_recorder")
        mint = _m(pkg, "interop.query").mint_trace_id
        s = _session(pkg, str(tmp_path), store=self.store)
        tid = mint()
        assert fr.record(s.conf, kind="spec", outcome="DEADLINE",
                         latency_ms=42.0, trace_id=tid, request_id=mint(),
                         error="deadline expired")
        key = fr.dump_diagnostics(s.conf)
        assert key is not None
        fr.reset()
        s2 = _session(pkg, str(tmp_path), store=self.store)
        got = pkg.Hyperspace(s2).diagnostics_bundles()
        assert [b["key"] for b in got] == [key]
        bundle = got[0]
        assert bundle["v"] == fr.BUNDLE_VERSION
        recs = [r for r in bundle["records"] if r["trace_id"] == tid]
        assert recs and recs[0]["outcome"] == "DEADLINE"
        assert "metrics" in bundle and "perf_tail" in bundle

    def test_bundles_bounded_oldest_pruned(self, pkg, tmp_path):
        fr = _m(pkg, "telemetry.flight_recorder")
        s = _session(pkg, str(tmp_path), store=self.store)
        s.conf.flight_recorder_max_bundles = 2
        keys = [fr.dump_diagnostics(s.conf) for _ in range(4)]
        assert all(keys)
        got = fr.bundles(s.conf)
        assert [b["key"] for b in got] == sorted(keys)[-2:]
        fr.clear_bundles(s.conf)
        assert fr.bundles(s.conf) == []

    def test_dump_never_consumes_fault_budget(self, pkg, tmp_path):
        faults = _m(pkg, "io.faults")
        fr = _m(pkg, "telemetry.flight_recorder")
        s = _session(pkg, str(tmp_path), store=self.store)
        plan = faults.FaultPlan(site="store.put", kind="eio", at=1, count=1)
        faults.install(plan)
        try:
            assert fr.dump_diagnostics(s.conf) is not None
            assert plan._calls == 0
        finally:
            faults.clear()

    def test_dump_failure_swallowed(self, pkg, tmp_path):
        fr = _m(pkg, "telemetry.flight_recorder")
        reg = _m(pkg, "telemetry.metrics").registry()
        kw = {"device": "cpu"} if pkg is TORCH else {}
        s = pkg.HyperspaceSession(
            system_path="/proc/definitely/not/writable", **kw)
        err0 = reg.counter("flight.dump.errors")
        assert fr.dump_diagnostics(s.conf) is None
        assert reg.counter("flight.dump.errors") > err0

    def test_disabled_recorder_skips_dump(self, pkg, tmp_path):
        fr = _m(pkg, "telemetry.flight_recorder")
        s = _session(pkg, str(tmp_path), store=self.store)
        s.conf.flight_recorder_enabled = False
        assert fr.dump_diagnostics(s.conf) is None

    def test_index_listing_ignores_diagnostics_dir(self, pkg, env):
        root, data = env
        fr = _m(pkg, "telemetry.flight_recorder")
        s = _session(pkg, root, store=self.store)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(data),
                        pkg.IndexConfig("ix", ["k"], ["v"]))
        assert fr.dump_diagnostics(s.conf) is not None
        assert os.path.isdir(os.path.join(s.conf.system_path,
                                          fr.FLIGHT_DIR))
        assert hs.indexes().num_rows == 1


class TestBundlesPosix(TestBundles):
    """The bundle cases with both packages pinned to ``PosixLogStore``."""

    store = "PosixLogStore"


# ---------------------------------------------------------------------------
# One seeded workload: the same records kept
# ---------------------------------------------------------------------------
def _workload_records(pkg, root: str, data: str):
    """Builds, queries (hits and misses of the slow threshold, a failure)
    and a maintenance cycle through ``pkg``; the kept records without
    ids, timestamps and latencies."""
    fr = _m(pkg, "telemetry.flight_recorder")
    fr.reset()
    s = _session(pkg, root, pkg.__name__)
    s.conf.flight_recorder_healthy_sample_n = 3
    hs = pkg.Hyperspace(s)
    c = pkg.col
    hs.create_index(s.read.parquet(data), pkg.IndexConfig("ix", ["k"], ["v"]))
    s.enable_hyperspace()
    rng = np.random.default_rng(41)
    for i, k in enumerate(rng.integers(0, 1000, 7)):
        s.conf.flight_recorder_slow_ms = 0.0001 if i % 3 == 2 else 1e9
        s.read.parquet(data).filter(c("k") == int(k)).select("k", "v") \
            .collect()
    s.conf.flight_recorder_slow_ms = 1e9
    with pytest.raises(Exception):
        s.read.parquet(data).filter(c("nope") == 1).collect()
    s.read.parquet(data).group_by("v").count().collect()
    _write(data, n=10, start=5000, name=f"append_{pkg.__name__}")
    hs.maintenance_cycle()
    return [(r["kind"], r["outcome"], r["reason"], r["slow"],
             bool(r["spans"]) if r["kind"] == "local" else None,
             r["report"]["outcome"] if r["report"] else None)
            for r in fr.recorder().records()]


def test_same_records_kept_as_the_jax_package(tmp_path):
    got = {}
    for pkg in PACKAGES:
        data = str(tmp_path / f"data_{pkg.__name__}")
        _write(data)
        got[pkg] = _workload_records(pkg, str(tmp_path), data)
    assert got[TORCH] == got[JAX]
    kinds = [r[0] for r in got[TORCH]]
    assert kinds.count("maintenance") == 1 and "local" in kinds
    assert ("local", "error", "error", False, False, "error") \
        in got[TORCH]
    assert any(r[2] == "slow" for r in got[TORCH])
    assert any(r[2] == "sample" for r in got[TORCH])


def test_daemon_records_maintenance_flights(env):
    """A daemon action lands in the ring as ``maintenance`` (the JAX case
    test_daemon_initiated_builds_hit_the_flight_recorder)."""
    root, data = env
    s = _session(TORCH, root)
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(data),
                    hyperspace_tpu_torch.IndexConfig("ix", ["k"], ["v"]))
    _write(data, n=900, start=5000, name="more")
    recs = hs.maintenance_cycle()
    assert [r["outcome"] for r in recs] == ["done"]
    (rec,) = [r for r in flight_recorder.recorder().records()
              if r["kind"] == "maintenance"]
    assert rec["outcome"] == "OK"
    assert rec["error"].startswith("refresh ix")


# ---------------------------------------------------------------------------
# slo.py against the JAX functions
# ---------------------------------------------------------------------------
def _samples(pkg, rng, n: int):
    slo = _m(pkg, "telemetry.slo")
    ts = np.cumsum(rng.random(n) * 20.0)
    good = np.cumsum(rng.integers(0, 100, n))
    bad = np.cumsum(rng.integers(0, 8, n))
    out = [slo.Sample(float(t), float(g), float(b))
           for t, g, b in zip(ts, good, bad)]
    if n > 4:  # a restart: counters fall back
        out[n // 2] = slo.Sample(out[n // 2].ts, 0.0, 0.0)
    rng.shuffle(out)  # skewed arrival order
    return out


def _slo_results(pkg, seed: int):
    slo = _m(pkg, "telemetry.slo")
    rng = np.random.default_rng(seed)
    res = []
    for n in (0, 1, 3, 17, 60):
        samples = _samples(pkg, rng, n)
        now = max((s.ts for s in samples), default=0.0)
        for window in (5.0, 40.0, 400.0, 0.0):
            res.append(slo.window_delta(samples, now, window))
        rules = slo.default_rules(5.0, 60.0, 2.0, 30.0, 300.0, 1.0) + [
            slo.BurnRule("tight", 1.0, 10.0, 0.5, "warn")]
        for target in (0.9, 0.99, 1.0):
            res.append(slo.evaluate_objective(samples, now, rules, target))
        for good, bad, budget in ((90, 10, 0.01), (0, 0, 0.1), (5, 5, 0.0)):
            res.append(slo.burn_rate(good, bad, budget))
    hist = {"count": 10, "buckets": {"1": 3, "10": 4, "100": 2,
                                     "+Inf": 1}}
    for slo_ms in (0.5, 1.0, 10.0, 1000.0, 0.0):
        res.append(slo.hist_split(hist, slo_ms))
    res.append(slo.hist_split({"count": "x", "buckets": {}}, 5.0))
    for value, threshold in ((None, 1.0), (3.0, 1.0), (0.5, 1.0),
                             (2.0, 0.0)):
        res.append(slo.threshold_objective(value, threshold, "page"))
    state = None
    for i, breached in enumerate(rng.random(40) < 0.5):
        state, tr = slo.step_state(state, bool(breached), "page", float(i),
                                   int(rng.integers(1, 4)),
                                   int(rng.integers(1, 4)))
        res.append((dict(state), tr))
    return res


@pytest.mark.parametrize("seed", [1, 7, 23])
def test_slo_math_equals_the_jax_package(seed):
    assert _slo_results(TORCH, seed) == _slo_results(JAX, seed)


# ---------------------------------------------------------------------------
# The doctor against the JAX doctor
# ---------------------------------------------------------------------------
def _doctor_steps(pkg, root: str):
    """The same steps through ``pkg``; the doctor's grades after each,
    ``lint`` left out."""
    fr_metrics = _m(pkg, "telemetry.metrics")
    fr_metrics.reset()
    data = os.path.join(root, f"src_{pkg.__name__}")
    _write(data, n=2000)
    _write(data, n=500, start=4000, name="g")
    s = _session(pkg, root, f"ix_{pkg.__name__}")
    hs = pkg.Hyperspace(s)
    steps = {}

    def grade(label):
        report = hs.doctor()
        steps[label] = {c.name: c.status for c in report.checks
                        if c.name != "lint"}
        steps[label]["overall"] = report.status

    grade("empty")
    s.conf.lineage_enabled = True
    hs.create_index(s.read.parquet(data), pkg.IndexConfig("ix", ["k"], ["v"]))
    grade("built")
    _write(data, n=100, start=9000, name="appended")
    grade("appended")
    hs.refresh_index("ix", "incremental")
    grade("refreshed")
    entry = s.index_collection_manager.get_index("ix")
    victim = sorted(f.name for f in entry.content.file_infos())[0]
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    hs.verify_index("ix", "full")
    grade("damaged")
    hs.refresh_index("ix", "repair")
    grade("repaired")
    os.remove(os.path.join(data, "g.parquet"))
    hs.refresh_index("ix", "quick")
    grade("delete_overlay_hybrid_off")
    s.conf.hybrid_scan_enabled = True
    grade("delete_overlay_hybrid_on")
    s.conf.lifecycle_cdc_merge_debt_ratio = 0.01
    grade("over_budget")
    s.conf.lifecycle_cdc_merge_debt_ratio = 0.2
    hs.refresh_index("ix", "incremental")
    _m(pkg, "lifecycle.daemon").daemon_for(s)._note_failure("ix", 0)
    grade("backoff")
    _m(pkg, "lifecycle.daemon").daemon_for(s)._backoff.clear()
    fr_metrics.inc("degraded.fallbacks")
    grade("degraded")
    fr_metrics.reset()
    fr_metrics.inc("exec.device.0.kernel_ms", 10.0)
    fr_metrics.inc("exec.device.1.kernel_ms", 12.0)
    fr_metrics.inc("exec.device.2.kernel_ms", 900.0)
    grade("skew")
    fr_metrics.reset()
    ledger = _m(pkg, "telemetry.perf_ledger")
    for wall in (1.0, 1.1, 0.9, 1.0, 4.0):
        ledger.append(s.conf, {"kind": "action", "name": "Slow(ix)",
                               "outcome": "ok", "wall_s": wall})
    grade("perf")
    fr_metrics.inc("serve.requests", 100)
    fr_metrics.inc("serve.shed", 30)
    grade("shed")
    fr_metrics.reset()
    fr_metrics.inc("client.breaker.open_now", 1)
    grade("breaker")
    fr_metrics.reset()
    return steps


def test_doctor_grades_equal_the_jax_doctor(tmp_path):
    got = {pkg: _doctor_steps(pkg, str(tmp_path)) for pkg in PACKAGES}
    assert got[TORCH] == got[JAX]
    steps = got[TORCH]
    assert set(steps["empty"].values()) == {"ok"}
    assert steps["appended"]["staleness"] == "warn"
    assert steps["damaged"]["integrity"] == "crit"
    assert steps["repaired"]["integrity"] == "ok"
    assert steps["delete_overlay_hybrid_off"]["cdc.merge_debt"] == "crit"
    assert steps["over_budget"]["cdc.merge_debt"] == "warn"
    assert steps["backoff"]["maintenance"] == "warn"
    assert steps["degraded"]["degraded"] == "warn"
    assert steps["skew"]["device_skew"] == "warn"
    assert steps["perf"]["perf"] == "warn"
    assert steps["shed"]["serving"] == "crit"
    assert steps["breaker"]["client"] == "warn"


def test_doctor_over_a_shared_system_path(tmp_path):
    """The JAX doctor reads the port's system path (the same log and
    quarantine records) and grades integrity and staleness alike."""
    data = str(tmp_path / "src")
    _write(data)
    s = _session(TORCH, str(tmp_path))
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(data),
                    hyperspace_tpu_torch.IndexConfig("ix", ["k"], ["v"]))
    js = _session(JAX, str(tmp_path))

    def grades():
        return [{c.name: c.status for c in pkg.Hyperspace(sess).doctor()
                 .checks if c.name in ("integrity", "staleness")}
                for pkg, sess in ((JAX, js), (TORCH, s))]

    assert grades() == [{"integrity": "ok", "staleness": "ok"}] * 2
    _write(data, n=10, start=5000, name="late")
    entry = s.index_collection_manager.get_index("ix")
    s.index_collection_manager.quarantine_manager("ix").add(
        entry.content.file_infos()[0].name, "test")
    assert grades() == [{"integrity": "crit", "staleness": "warn"}] * 2


def test_doctor_report_surface(env):
    root, _ = env
    hs = Hyperspace(_session(TORCH, root))
    report = hs.doctor()
    assert report.status == "ok" and report.check("perf").status == "ok"
    assert report.check("lint") is None
    assert report.render().startswith("Doctor: OK")
    table = report.table()
    assert table.column("check")[0].as_py() == "overall"
    assert table.num_rows == len(report.checks) + 1
    assert json.loads(json.dumps(report.to_dict()))["status"] == "ok"
    assert metrics.snapshot()["health.status"] == 0.0


def test_doctor_main_exit_codes(tmp_path, capsys):
    from hyperspace_tpu_torch.telemetry import doctor

    code = doctor.main(["--system-path", str(tmp_path / "ix"),
                        "--device", "cpu", "--json",
                        "--conf", "doctor_device_skew_warn=2.5"])
    assert code == 0
    assert json.loads(capsys.readouterr().out)["status"] == "ok"
    with pytest.raises(SystemExit):
        doctor.main(["--device", "cpu", "--conf", "no_such_field=1"])


# ---------------------------------------------------------------------------
# export_timeline(trace_id=)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", PACKAGES, ids=IDS)
def test_export_timeline_from_a_flight_record(pkg, env):
    root, data = env
    s = _session(pkg, root)
    s.conf.flight_recorder_slow_ms = 0.001
    s.conf.telemetry_tracing_enabled = True
    s.conf.timeline_enabled = True
    try:
        hs = pkg.Hyperspace(s)
        s.read.parquet(data).filter(pkg.col("k") < 10).collect()
    finally:
        _m(pkg, "telemetry.trace").disable_tracing()
        _m(pkg, "telemetry.timeline").disable_timeline()
    rec = _m(pkg, "telemetry.flight_recorder").recorder().records()[-1]
    assert rec["spans"]
    path = os.path.join(root, "from_record.json")
    hs.export_timeline(path, trace_id=rec["trace_id"].upper())
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    assert "query.collect" in names
    with pytest.raises(ValueError, match="no retained flight record"):
        hs.export_timeline(path, trace_id="deadbeefdeadbeef")


# ---------------------------------------------------------------------------
# chip_smoke phase R on the CPU
# ---------------------------------------------------------------------------
def test_phase_r_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase R end to end at 80,000 lineitem rows: phase C's
    and D's indexes, then the strict build (bucket for bucket the
    unguarded one's) and the seven queries under the armed guard, the
    injected ``.item()``, the plan cache, the deadlines, the flight
    recorder and the doctor.  The CPU has no CUDA allocator to read and
    the plain kernels count no launch, so those checks are stubbed here
    and run on the card."""
    import chip_smoke
    from hyperspace_tpu_torch import IndexConfig as Config
    from hyperspace_tpu_torch.execution import sync_guard

    conf_batch = HyperspaceSession(device="cpu").conf.device_batch_rows
    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("DEFAULT_BATCH_ROWS", conf_batch),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0), ("R_PAIRS", 1),
                        ("R_APPENDED_ROWS", 100)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *_a, **_k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *_a, **_k: 0)
    monkeypatch.setattr(chip_smoke, "require_launches",
                        lambda *_a, **_k: None)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    dev = torch.device("cpu")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    s = HyperspaceSession(system_path=os.path.join(root, "indexes"),
                          device="cpu")
    s.conf.num_buckets = chip_smoke.NUM_BUCKETS
    chip_smoke.set_min_rows(s, 0)
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(os.path.join(root, "lineitem")),
                    Config(chip_smoke.INDEX_NAME, chip_smoke.INDEXED,
                           chip_smoke.INCLUDED))
    hs.create_index(s.read.parquet(os.path.join(root, "orders")),
                    Config(chip_smoke.ORDERS_INDEX, ["o_orderkey"],
                           ["o_totalprice", "o_custkey", "o_shippriority"]))
    out = chip_smoke.phase_r(orders, li, root, dev)
    strict = out["strict"]
    assert strict["violations"] == 0 and strict["attributed"] > 0
    assert strict["d2h_bytes"] >= strict["d2h_floor"] \
        >= 80_000 * 8
    assert "Tensor.item()" in strict["injected"]
    assert len(strict["pairs"]["armed_ms"]) == 1
    assert out["plan_cache"]["stats"]["hits"] == 7
    assert out["plan_cache"]["saved_ms"] > 0
    assert "deadline exceeded" in out["deadline"]["expired"]
    assert out["flight"]["errors"] == 2
    grades = out["doctor"]["grades"]
    assert grades["clean"]["integrity"] == "ok"
    assert grades["damaged"]["integrity"] == "crit"
    assert grades["appended"]["staleness"] == "warn"
    assert not any(out["launches"].values())  # the plain kernels count none
    assert not sync_guard.armed()
    assert not timeline.timeline_enabled()
