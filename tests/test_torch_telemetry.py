"""The port's telemetry core held to the JAX package's
(tests/test_telemetry.py is the oracle): span nesting, also under
exceptions, contextvar isolation across the IO threads, the shared no-op
of disabled tracing, the metrics registry and its Prometheus text (equal
to the JAX package's for the same contents), the JSONL sink and its
bound, run reports, the metrics the query, scrub, retry, conflict and CAS
paths feed, and the conf switches.  A seeded workload (create, an
incremental refresh, a filter, a join and a grouped aggregate with the
indexes on) goes through both packages on the CPU: the span trees, the
event sequences, the metric names, the fixed counters and the counts of
the timing histograms must match.  Also the port's fixed faults: the
index configs' case-insensitive equality and hash, the public names
``RefreshSummary``, ``OptimizeSummary`` and ``FileIdTracker.max_id``,
and thread-local ``last_execution_stats``."""

from __future__ import annotations

import importlib
import json
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
from hyperspace_tpu_torch.telemetry import events, metrics, report, timeline, trace
from hyperspace_tpu_torch.telemetry.trace import (
    NOOP_SPAN,
    CollectingTraceSink,
    JsonlTraceSink,
    current_span,
    span,
)

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    """The port's tracing, sinks, timeline and event logger are
    process-global, like the JAX package's (which tests/conftest.py
    resets)."""
    yield
    trace.disable_tracing()
    trace.clear_sinks()
    timeline.disable_timeline()
    timeline.reset()
    events.set_event_logger(None)
    _m(JAX, "telemetry.events").set_event_logger(None)


@pytest.fixture()
def traced():
    trace.enable_tracing()
    sink = trace.add_sink(CollectingTraceSink())
    yield sink
    trace.remove_sink(sink)
    trace.disable_tracing()


# -- spans ------------------------------------------------------------------
def test_span_nesting_and_delivery(traced):
    with span("outer", a=1) as outer:
        with span("inner") as inner:
            inner.set(rows=3)
    assert [s.name for s in traced.spans] == ["outer"]
    assert outer.children == [inner]
    assert inner.tags["rows"] == 3
    assert outer.duration_ms >= inner.duration_ms >= 0.0
    assert outer.status == inner.status == "ok"


def test_span_nesting_under_exceptions(traced):
    with pytest.raises(ValueError):
        with span("root"):
            with span("child"):
                raise ValueError("boom")
    (root,) = traced.spans
    assert root.status == "error" and "boom" in root.error
    (child,) = root.children
    assert child.status == "error"
    with span("next"):
        pass
    assert [s.name for s in traced.spans] == ["root", "next"]


def test_disabled_span_is_shared_noop():
    trace.disable_tracing()
    s = span("anything", big_tag="x")
    assert s is NOOP_SPAN
    with s as live:
        live.set(whatever=1)
    assert current_span() is NOOP_SPAN


def test_current_span_tagging(traced):
    with span("outer"):
        current_span().set(late=True)
    assert traced.spans[0].tags["late"] is True


def test_contextvar_isolation_across_threads(traced):
    from hyperspace_tpu_torch.utils.parallel_map import parallel_map_ordered

    def work(i: int) -> int:
        with span(f"worker.{i}"):
            return i

    with span("submitter") as submitter:
        out = parallel_map_ordered(work, list(range(8)))
    assert out == list(range(8))
    assert all(not c.name.startswith("worker.") for c in submitter.children)
    delivered = {s.name for s in traced.spans}
    assert "submitter" in delivered
    assert {f"worker.{i}" for i in range(8)} <= delivered


def test_jsonl_sink_format(tmp_path, traced):
    path = str(tmp_path / "trace.jsonl")
    sink = trace.add_sink(JsonlTraceSink(path))
    try:
        with span("root", files=2):
            with span("leaf"):
                pass
    finally:
        trace.remove_sink(sink)
    (line,) = open(path, encoding="utf-8").read().splitlines()
    d = json.loads(line)
    assert d["name"] == "root" and d["status"] == "ok"
    assert d["tags"] == {"files": 2}
    assert d["children"][0]["name"] == "leaf"
    assert d["duration_ms"] >= 0.0


def test_jsonl_sink_rotates_past_max_bytes(tmp_path, traced):
    path = str(tmp_path / "trace.jsonl")
    sink = trace.add_sink(JsonlTraceSink(path, max_bytes=300))
    try:
        for i in range(20):
            with span("root", i=i):
                pass
    finally:
        trace.remove_sink(sink)
    assert os.path.getsize(path) <= 300
    assert os.path.exists(path + ".1")
    last = json.loads(open(path, encoding="utf-8").read().splitlines()[-1])
    assert last["tags"] == {"i": 19}


def test_span_to_dict_roundtrip_error(traced):
    with pytest.raises(RuntimeError):
        with span("r"):
            raise RuntimeError("x")
    d = traced.spans[0].to_dict()
    assert d["status"] == "error" and d["error"].startswith("RuntimeError")


# -- metrics ----------------------------------------------------------------
def test_metrics_snapshot_and_reset():
    reg = metrics.MetricsRegistry()
    reg.inc("a.count")
    reg.inc("a.count", 2)
    reg.set_gauge("b.gauge", 7.5)
    reg.observe("c.hist", 3.0)
    reg.observe("c.hist", 400.0)
    snap = reg.snapshot()
    assert snap["a.count"] == 3.0
    assert snap["b.gauge"] == 7.5
    assert snap["c.hist"]["count"] == 2
    assert snap["c.hist"]["min"] == 3.0 and snap["c.hist"]["max"] == 400.0
    reg.reset()
    assert reg.snapshot() == {}


def test_metrics_hit_ratio_derived():
    reg = metrics.MetricsRegistry()
    reg.inc("cache.device.hits", 3)
    reg.inc("cache.device.misses", 1)
    assert reg.snapshot()["cache.device.hit_ratio"] == 0.75


def test_metrics_prometheus_rendering():
    reg = metrics.MetricsRegistry()
    reg.inc("io.retry.attempts", 2)
    reg.set_gauge("cache.device.bytes", 1024)
    reg.observe("span.ms", 12.0)
    text = reg.render_prometheus()
    assert "# TYPE hyperspace_io_retry_attempts counter" in text
    assert "hyperspace_io_retry_attempts 2" in text
    assert "hyperspace_cache_device_bytes 1024" in text
    assert 'hyperspace_span_ms_bucket{le="25"} 1' in text
    assert "hyperspace_span_ms_count 1" in text
    # The HELP lines come from docs/16's catalog.
    assert "# HELP hyperspace_io_retry_attempts " in text


_REGISTRY_CONTENTS = {
    "counters": [("io.retry.attempts", 2), ("rule.filter.applied", 1),
                 ("exec.device.0.kernel_ms", 1.25),
                 ("build.phase.spill_route.seconds", 0.5),
                 ("not.in.the.catalog", 3)],
    "gauges": [("cache.device.bytes", 1024), ("timeline.ring_size", 7)],
    "histograms": [("exec.kernel.route_partition.device_ms", 0.031),
                   ("exec.kernel.route_partition.device_ms", 12.0),
                   ("build.wall.seconds", 1800.0)],
}


@pytest.mark.parametrize("part", sorted(_REGISTRY_CONTENTS) + ["all"])
def test_metrics_text_equals_the_jax_package(part):
    """The same registry contents render to the same exposition, HELP
    lines from the docs/16 catalog included."""
    texts = []
    for pkg in (JAX, TORCH):
        reg = _m(pkg, "telemetry.metrics").MetricsRegistry()
        for kind, items in _REGISTRY_CONTENTS.items():
            if part not in (kind, "all"):
                continue
            for name, value in items:
                {"counters": reg.inc, "gauges": reg.set_gauge,
                 "histograms": reg.observe}[kind](name, value)
        texts.append(reg.render_prometheus())
    assert texts[0] and texts[1] == texts[0]


def test_metrics_bounded_series():
    reg = metrics.MetricsRegistry()
    for i in range(5000):
        reg.inc(f"runaway.{i}")
    assert len(reg.snapshot()) <= 4096
    reg.inc("runaway.0")
    assert reg.counter("runaway.0") == 2.0


def test_metrics_thread_safety():
    reg = metrics.MetricsRegistry()

    def bump():
        for _ in range(1000):
            reg.inc("n")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.counter("n") == 8000.0


# -- end to end: the query lifecycle ----------------------------------------
def _cpu_session(path, **conf):
    s = HyperspaceSession(system_path=path, device="cpu")
    s.conf.num_buckets = 2
    for kind in ("filter", "join", "agg", "build"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


@pytest.fixture()
def indexed(tmp_path):
    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(200, dtype=np.int64)),
                             "v": pa.array(np.arange(200) * 2.0)}),
                   os.path.join(d, "p.parquet"))
    s = _cpu_session(str(tmp_path / "ix"))
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(d), IndexConfig("tix", ["k"], ["v"]))
    s.enable_hyperspace()
    return s, hs, d


def test_query_trace_covers_lifecycle(indexed, traced):
    s, hs, d = indexed
    ds = s.read.parquet(d).filter(col("k") == 7).select("k", "v")
    assert ds.collect().column("v").to_pylist() == [14.0]
    (root,) = [r for r in traced.spans if r.name == "query.collect"]
    names = {sp.name for sp in root.walk()}
    assert {"query.collect", "optimize", "optimize.rule.filter",
            "execute", "exec.scan", "io.read"} <= names
    scan = root.find("exec.scan")[0]
    assert scan.tags["is_index"] is True
    assert scan.tags["files_read"] >= 1
    assert scan.tags["rows"] >= 1


def test_run_report_on_clean_query(indexed):
    s, hs, d = indexed
    ds = s.read.parquet(d).filter(col("k") == 7).select("k", "v")
    ds.collect()
    rep = ds.last_run_report()
    assert rep.outcome == "ok" and not rep.degraded
    assert rep.indexes_considered == ["tix"]
    assert rep.indexes_used == ["tix"]
    assert rep.skipped_indexes() == []
    rules = {r["rule"]: r["applied"] for r in rep.rules()}
    assert rules["FilterIndexRule"] is True
    assert rep.span_timings() == []
    assert json.dumps(rep.to_dict())
    assert "FilterIndexRule: applied" in rep.render()


def test_run_report_thread_local(indexed):
    s, hs, d = indexed
    ds = s.read.parquet(d).filter(col("k") == 7).select("k", "v")
    ds.collect()
    mine = ds.last_run_report()
    seen = {}

    def other():
        seen["report"] = ds.last_run_report()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert mine is not None and seen["report"] is None


def test_rule_and_query_metrics_feed(indexed):
    s, hs, d = indexed
    metrics.reset()
    s.read.parquet(d).filter(col("k") == 7).select("k", "v").collect()
    snap = hs.metrics()
    assert snap["rule.filter.applied"] >= 1
    assert snap["io.files.read"] >= 1
    text = hs.metrics_text()
    assert "hyperspace_rule_filter_applied" in text
    hs.reset_metrics()
    assert "rule.filter.applied" not in hs.metrics()


def test_scrub_metrics_feed(indexed):
    s, hs, d = indexed
    metrics.reset()
    hs.verify_index("tix", mode="full")
    snap = hs.metrics()
    assert snap["scrub.files_checked"] >= 1
    assert snap.get("scrub.files_flagged", 0.0) == 0.0


def test_io_retry_metric_and_report_record():
    from hyperspace_tpu_torch.io import faults
    from hyperspace_tpu_torch.utils.retry import RetryPolicy

    metrics.reset()
    faults.install(faults.FaultPlan(site="data.read", kind="eio", count=2))
    token = report.start()
    try:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            faults.check("data.read")
            return "ok"

        out = RetryPolicy(initial_backoff_ms=0.1).call(flaky)
    finally:
        rep = report.finish(token)
        faults.clear()
    assert out == "ok" and calls["n"] == 3
    assert metrics.snapshot()["io.retry.attempts"] == 2.0
    retries = [dec for dec in rep.decisions if dec["kind"] == "io.retry"]
    assert len(retries) == 2 and "Error" in retries[0]["error"]


def test_conflict_retry_action_events(tmp_path):
    """The transaction loop emits a CONFLICT_RETRY action event per
    absorbed conflict (attempt in the state, reason in the message) and
    feeds ``action.conflict.retries``."""
    from hyperspace_tpu_torch.actions.create import CreateAction
    from hyperspace_tpu_torch.exceptions import ConcurrentWriteError
    from hyperspace_tpu_torch.telemetry.events import (
        CollectingEventLogger,
        CreateActionEvent,
        set_event_logger,
    )

    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array([1, 2], type=pa.int64()),
                             "v": [1.0, 2.0]}), os.path.join(d, "p.parquet"))
    s = _cpu_session(str(tmp_path / "ix"), num_buckets=1,
                     io_retry_initial_backoff_ms=0.1)
    hs = Hyperspace(s)
    log = CollectingEventLogger()
    set_event_logger(log)
    metrics.reset()
    real_attempt = CreateAction._attempt
    state = {"left": 2}

    def flaky_attempt(self):
        if state["left"] > 0:
            state["left"] -= 1
            raise ConcurrentWriteError("injected racer won")
        return real_attempt(self)

    CreateAction._attempt = flaky_attempt
    try:
        hs.create_index(s.read.parquet(d), IndexConfig("cfx", ["k"], ["v"]))
    finally:
        CreateAction._attempt = real_attempt
        set_event_logger(None)
    retries = [e for e in log.events if isinstance(e, CreateActionEvent)
               and e.state.startswith("CONFLICT_RETRY")]
    assert [e.state.split()[1] for e in retries] == ["1/3", "2/3"]
    assert all("injected racer won" in e.message for e in retries)
    assert metrics.snapshot()["action.conflict.retries"] == 2.0
    assert s.index_collection_manager.get_index("cfx") is not None
    assert hs.last_build_report().conflict_retries == 2


def test_cas_conflict_metric(tmp_path):
    """Each store class counts its puts and its lost compare-and-swaps
    (the JAX oracle's store is the emulated object store)."""
    from hyperspace_tpu_torch.io.log_store import (
        EmulatedObjectStore,
        PosixLogStore,
    )

    for i, cls in enumerate((EmulatedObjectStore, PosixLogStore)):
        metrics.reset()
        store = cls(str(tmp_path / f"store{i}"))
        assert store.put_if_absent("key", b"a")
        assert not store.put_if_absent("key", b"b")
        snap = metrics.snapshot()
        assert snap["log.store.puts"] == 2.0
        assert snap["log.cas.conflicts"] == 1.0


def test_conf_enables_tracing_and_sink(tmp_path):
    path = str(tmp_path / "sink.jsonl")
    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array([1], type=pa.int64()),
                             "v": [2.0]}), os.path.join(d, "p.parquet"))
    s = _cpu_session(str(tmp_path / "ix"))
    s.conf.telemetry_tracing_enabled = True
    s.conf.telemetry_trace_sink = path
    s.read.parquet(d).select("k").collect()
    roots = [json.loads(ln) for ln in open(path, encoding="utf-8")]
    assert any(r["name"] == "query.collect" for r in roots)


def test_profiler_trace_writes_a_torch_profile(tmp_path):
    import torch

    out = tmp_path / "prof"
    with trace.profiler_trace(str(out)):
        torch.arange(1000).sum()
    assert any(out.iterdir())


def test_explain_verbose_shows_optimizer_decisions(indexed):
    s, hs, d = indexed
    ds = s.read.parquet(d).filter(col("k") == 7).select("k", "v")
    out = hs.explain(ds, verbose=True)
    assert "Optimizer decisions:" in out
    assert "indexes considered: tix" in out
    assert "rule FilterIndexRule: applied" in out
    trace.enable_tracing()
    ds.collect()
    out = hs.explain(ds, verbose=True)
    assert "Last run report:" in out
    assert "where time went:" in out


def test_degraded_rule_emits_the_event_and_the_metric(indexed):
    """A rule that fails on index metadata degrades through an
    ``IndexDegradedEvent``: the run report's ``degraded`` decision, the
    ``degraded.fallbacks`` and ``rule.<slug>.skipped`` counters."""
    from hyperspace_tpu_torch.rules.filter_rule import FilterIndexRule

    s, hs, d = indexed
    log = events.CollectingEventLogger()
    events.set_event_logger(log)
    metrics.reset()
    real = FilterIndexRule.apply

    def broken(self, plan):
        raise OSError("index metadata unreadable")

    FilterIndexRule.apply = broken
    try:
        ds = s.read.parquet(d).filter(col("k") == 7).select("k", "v")
        assert ds.collect().column("v").to_pylist() == [14.0]
    finally:
        FilterIndexRule.apply = real
    rep = ds.last_run_report()
    assert rep.outcome == "degraded"
    assert rep.degraded_reasons() == [
        "FilterIndexRule failed: OSError('index metadata unreadable')"]
    assert [type(e).__name__ for e in log.events] == ["IndexDegradedEvent"]
    snap = metrics.snapshot()
    assert snap["degraded.fallbacks"] == 1.0
    assert snap["rule.filter.skipped"] == 1.0


# -- the same seeded workload through both packages --------------------------
def _write(path, name, lo, n, seed, columns):
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    key, val = columns
    pq.write_table(pa.table({
        key: pa.array(np.arange(lo, lo + n) % 97, type=pa.int64()),
        val: rng.random(n)}), os.path.join(path, name))


def _xsession(pkg, root):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, pkg.__name__),
                              **kw)
    s.conf.num_buckets = 4
    for kind in ("filter", "join", "agg", "build"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    # Both packages keep their default store, EmulatedObjectStore.
    return s


def _span_paths(roots):
    paths = set()

    def walk(sp, prefix):
        path = prefix + (sp.name,)
        paths.add(path)
        for c in sp.children:
            walk(c, path)

    for r in roots:
        walk(r, ())
    return paths


def _event_view(e):
    names = getattr(e, "index_names", None)
    return (type(e).__name__,
            tuple(names) if names is not None else e.index_name,
            e.message, getattr(e, "state", None))


# Series only one package can have: the JAX package counts live jax
# buffers on its CPU device where a CPU session of the port has no device
# memory to count.
_JAX_ONLY_SERIES = {"build.device.live_bytes", "mem.device.live_bytes"}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """One seeded workload through both packages: two creates, an
    append, an incremental refresh, then a filter, a join and a grouped
    aggregate through the indexes, with tracing on and an event logger
    installed."""
    root = str(tmp_path_factory.mktemp("xpkg"))
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    _write(a, "p0.parquet", 0, 600, 1, ("k", "v"))
    _write(a, "p1.parquet", 600, 600, 2, ("k", "v"))
    _write(b, "p0.parquet", 0, 300, 3, ("kb", "w"))
    sessions, out = {}, {}
    logs, sinks = {}, {}
    for pkg in (JAX, TORCH):
        tr = _m(pkg, "telemetry.trace")
        tr.enable_tracing()
        sinks[pkg] = tr.add_sink(tr.CollectingTraceSink())
        logs[pkg] = _m(pkg, "telemetry.events").CollectingEventLogger()
        _m(pkg, "telemetry.events").set_event_logger(logs[pkg])
        _m(pkg, "telemetry.metrics").reset()
        # The rings are process-wide: their healthy 1-in-N sample must
        # start from the same count in both packages.
        _m(pkg, "telemetry.flight_recorder").reset()
    try:
        for pkg in (JAX, TORCH):
            s = _xsession(pkg, root)
            hs = pkg.Hyperspace(s)
            hs.create_index(s.read.parquet(a), pkg.IndexConfig("ia", ["k"], ["v"]))
            hs.create_index(s.read.parquet(b),
                            pkg.IndexConfig("ib", ["kb"], ["w"]))
            sessions[pkg] = (s, hs)
        _write(a, "p2.parquet", 1200, 300, 4, ("k", "v"))
        for pkg in (JAX, TORCH):
            s, hs = sessions[pkg]
            hs.refresh_index("ia", "incremental")
            s.enable_hyperspace()
            c = pkg.col
            rows = [
                s.read.parquet(a).filter(c("k") == 7).select("k", "v")
                .collect().num_rows,
                s.read.parquet(a).join(s.read.parquet(b), c("k") == c("kb"))
                .select("k", "v", "w").collect().num_rows,
                s.read.parquet(a).group_by("k").agg(sv=("v", "sum"))
                .collect().num_rows,
            ]
            out[pkg] = {
                "rows": rows,
                "spans": _span_paths(sinks[pkg].spans),
                "events": [_event_view(e) for e in logs[pkg].events],
                "metrics": _m(pkg, "telemetry.metrics").snapshot(),
                "joins": s.last_execution_stats,
            }
    finally:
        for pkg in (JAX, TORCH):
            tr = _m(pkg, "telemetry.trace")
            tr.disable_tracing()
            tr.remove_sink(sinks[pkg])
            _m(pkg, "telemetry.events").set_event_logger(None)
    return out


def test_workload_answers_match(workload):
    assert workload[TORCH]["rows"] == workload[JAX]["rows"]
    assert all(n > 0 for n in workload[TORCH]["rows"])


def test_span_trees_match_the_jax_package(workload):
    jax_paths, torch_paths = workload[JAX]["spans"], workload[TORCH]["spans"]
    assert torch_paths == jax_paths
    names = {p[-1] for p in torch_paths}
    assert {"action.CreateAction", "action.RefreshIncrementalAction",
            "query.collect", "optimize.rule.join", "exec.join",
            "exec.aggregate", "io.write", "store.put"} <= names


def test_event_sequences_match_the_jax_package(workload):
    assert workload[TORCH]["events"] == workload[JAX]["events"]
    kinds = [e[0] for e in workload[TORCH]["events"]]
    assert "CreateActionEvent" in kinds and "RefreshActionEvent" in kinds
    assert "HyperspaceIndexUsageEvent" in kinds


def test_metric_names_match_the_jax_package(workload):
    jax_names = set(workload[JAX]["metrics"]) - _JAX_ONLY_SERIES
    assert set(workload[TORCH]["metrics"]) == jax_names


_FIXED_COUNTERS = ("build.actions", "rule.join.applied",
                   "rule.filter.applied", "io.files.written",
                   "io.files.read", "build.bytes.read",
                   "build.bytes.written", "log.store.puts",
                   "perf.ledger.appends", "cache.device.misses",
                   "cache.device.hits")


@pytest.mark.parametrize("name", _FIXED_COUNTERS)
def test_fixed_counters_match_the_jax_package(workload, name):
    jax_value = workload[JAX]["metrics"].get(name)
    assert workload[TORCH]["metrics"].get(name) == jax_value


def test_timing_histogram_counts_match_the_jax_package(workload):
    def counts(snap):
        return {k: v["count"] for k, v in snap.items() if isinstance(v, dict)}

    assert counts(workload[TORCH]["metrics"]) == \
        counts(workload[JAX]["metrics"])


# -- the port's fixed faults --------------------------------------------------
@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_case_insensitive_equality(pkg):
    assert pkg.IndexConfig("IDX", ["A"], ["B", "c"]) == \
        pkg.IndexConfig("idx", ["a"], ["C", "b"])
    assert pkg.IndexConfig("idx", ["a"]) != pkg.IndexConfig("idx", ["b"])
    assert hash(pkg.IndexConfig("IDX", ["A"])) == \
        hash(pkg.IndexConfig("idx", ["a"]))


@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
def test_data_skipping_config_equality_and_hash(pkg):
    a = pkg.DataSkippingIndexConfig("DS", ["K", "v"], ["MinMax", "ValueList"])
    b = pkg.DataSkippingIndexConfig("ds", ["k", "V"], ["MinMax", "ValueList"])
    assert a == b and hash(a) == hash(b)
    assert len({a, b}) == 1
    assert a != pkg.DataSkippingIndexConfig("ds", ["k", "v"])


def test_summaries_are_public_names():
    from hyperspace_tpu_torch.actions.optimize import OptimizeSummary
    from hyperspace_tpu_torch.actions.refresh import RefreshSummary

    assert TORCH.RefreshSummary is RefreshSummary
    assert TORCH.OptimizeSummary is OptimizeSummary
    assert {"RefreshSummary", "OptimizeSummary"} <= set(TORCH.__all__)


def test_from_directory_lists_and_tracks(tmp_path):
    from hyperspace_tpu_torch.index.log_entry import Content, FileIdTracker

    d = tmp_path / "data"
    sub = d / "sub"
    sub.mkdir(parents=True)
    (d / "a.parquet").write_bytes(b"xx")
    (d / "_metadata").write_bytes(b"meta")
    (d / ".hidden").write_bytes(b"h")
    (sub / "b.parquet").write_bytes(b"yyy")
    tracker = FileIdTracker()
    content = Content.from_directory(str(d), tracker)
    assert sorted(content.files()) == [str(d / "a.parquet"),
                                       str(sub / "b.parquet")]
    assert tracker.max_id == 1


def test_last_execution_stats_is_thread_local(tmp_path):
    """Thread A collects source ``a``, then thread B collects ``b``; A
    then reads the stats of its own scan, not B's."""
    roots = {}
    for name, n in (("a", 30), ("b", 70)):
        d = str(tmp_path / name)
        os.makedirs(d)
        pq.write_table(pa.table({"k": pa.array(np.arange(n))}),
                       os.path.join(d, "p.parquet"))
        roots[name] = d
    s = _cpu_session(str(tmp_path / "ix"))
    a_done, b_done = threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        s.read.parquet(roots["a"]).collect()
        a_done.set()
        b_done.wait(30)
        seen["a"] = s.last_execution_stats["scans"][0]["relation"]

    def thread_b():
        a_done.wait(30)
        s.read.parquet(roots["b"]).collect()
        seen["b"] = s.last_execution_stats["scans"][0]["relation"]
        b_done.set()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {"a": roots["a"], "b": roots["b"]}
    assert s.last_execution_stats is None  # this thread ran no query
