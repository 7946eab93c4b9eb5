"""The port's timeline, kernel attribution, Perfetto export and
``perf_history`` filters, held to the JAX package's tests/test_timeline.py
(its doctor, flight-recorder and server cases wait for those modules):

  - the recorder's bound and the busy/gap analysis, on hand-built
    intervals and on a real spill-forced build;
  - the background memory sampler and per-phase high-water marks;
  - the seams: with the timeline off, ``kernel_begin`` returns None and
    no ``torch.cuda`` call is reached through a build or a query; on, a
    kernel's time lands in ``exec.kernel.<name>.device_ms``, the
    ``exec.device.<index>.kernel_ms`` counter, a ``device:<index>`` lane
    and the run report;
  - Perfetto trace-event export from the live ring and from a
    perf-ledger record.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
from hyperspace_tpu_torch.telemetry import metrics, perf_ledger, timeline


@pytest.fixture(autouse=True)
def _timeline_cleanup():
    """The enable flag and the interval ring are process-global."""
    yield
    timeline.disable_timeline()
    timeline.reset()


def _write_source(path: str, n: int = 40_000, files: int = 4,
                  seed: int = 13) -> None:
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = pa.table({
        "k": pa.array(rng.integers(0, max(1, n // 8), n), type=pa.int64()),
        "v": rng.random(n),
    })
    step = -(-n // files)
    for i in range(files):
        pq.write_table(t.slice(i * step, step),
                       os.path.join(path, f"part-{i:05d}.parquet"))


def _session(tmp_path, name: str = "ix", **conf) -> HyperspaceSession:
    s = HyperspaceSession(system_path=str(tmp_path / name), device="cpu")
    s.conf.num_buckets = 4
    s.conf.device_build_min_rows = 0  # the device route (the CPU here)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


# ---------------------------------------------------------------------------
# Recorder + gap/overlap math
# ---------------------------------------------------------------------------
class TestRecorder:
    def test_disabled_is_a_noop(self):
        timeline.disable_timeline()
        timeline.reset()
        metrics.reset()
        assert timeline.op_begin() is None
        assert timeline.kernel_begin() is None
        assert timeline.kernel_begin(torch.device("cpu")) is None
        timeline.record_interval("a", "k", 0, 10)
        timeline.kernel_end("x", None, None)
        timeline.record_transfer("h2d", 1024)
        assert timeline.recorder().intervals() == []
        assert "exec.transfer.h2d.bytes" not in metrics.snapshot()

    def test_enabled_records_and_bounds(self):
        timeline.enable_timeline()
        rec = timeline.recorder()
        rec.set_capacity(8)
        try:
            for i in range(20):
                timeline.record_interval("lane", "k", i, i + 1)
            ivs = rec.intervals()
            assert len(ivs) == 8
            assert ivs[0][2] == 12  # the oldest 12 dropped
            assert metrics.snapshot().get("timeline.dropped", 0) >= 12
        finally:
            rec.set_capacity(timeline._DEFAULT_MAX_INTERVALS)

    def test_lane_context_manager(self):
        timeline.enable_timeline()
        timeline.reset()
        with timeline.lane("read", "chunk"):
            pass
        ivs = timeline.recorder().intervals("read")
        assert len(ivs) == 1 and ivs[0][1] == "chunk"

    def test_busy_report_overlap_math(self):
        report = timeline.busy_report([("A", "x", 0, 100),
                                       ("B", "x", 50, 150)])
        assert report["lanes"]["A"]["busy_fraction"] == pytest.approx(
            100 / 150, abs=1e-3)
        assert report["lanes"]["B"]["busy_fraction"] == pytest.approx(
            100 / 150, abs=1e-3)
        assert report["idle_while_busy"]["A"]["B"] == pytest.approx(
            50 / 150, abs=1e-3)
        assert report["idle_while_busy"]["B"]["A"] == pytest.approx(
            50 / 150, abs=1e-3)

    def test_busy_report_fully_serialized(self):
        report = timeline.busy_report([("read", "x", 0, 100),
                                       ("spill", "x", 100, 200)])
        assert report["idle_while_busy"]["read"]["spill"] \
            == pytest.approx(0.5, abs=1e-3)
        assert report["idle_while_busy"]["spill"]["read"] \
            == pytest.approx(0.5, abs=1e-3)

    def test_busy_report_merges_overlapping_spans(self):
        report = timeline.busy_report([("A", "x", 0, 60),
                                       ("A", "x", 40, 100)])
        assert report["lanes"]["A"]["busy_fraction"] == pytest.approx(1.0)

    def test_busy_report_empty(self):
        assert timeline.busy_report([]) == {
            "window_s": 0.0, "lanes": {}, "idle_while_busy": {}}

    @pytest.mark.parametrize("intervals", [
        [("A", "x", 0, 100), ("B", "x", 50, 150)],
        [("read", "x", 0, 100), ("spill", "x", 100, 200),
         ("read", "y", 150, 400), ("device:0", "k", 10, 20)],
    ])
    def test_busy_report_equals_the_jax_package(self, intervals):
        from hyperspace_tpu.telemetry import timeline as jax_timeline

        assert timeline.busy_report(intervals) == \
            jax_timeline.busy_report(intervals)


class TestMemorySampler:
    def test_sampler_feeds_sink_and_ring(self):
        timeline.enable_timeline()
        timeline.reset()

        class Sink:
            def __init__(self):
                self.samples = []

            def add_memory_sample(self, ts, rss, dev):
                self.samples.append((ts, rss, dev))

        sink = Sink()
        sampler = timeline.MemorySampler(cadence_ms=2.0, sink=sink)
        sampler.start()
        time.sleep(0.08)
        sampler.stop()
        assert sink.samples, "the sampler produced nothing in 80 ms"
        assert timeline.recorder().memory_samples()
        ts, rss, dev = sink.samples[0]
        assert rss > 0
        assert dev == 0  # no CUDA device to count

    def test_start_sampler_respects_gate(self, tmp_path):
        s = _session(tmp_path)
        timeline.disable_timeline()
        assert timeline.start_sampler(s.conf) is None
        timeline.enable_timeline()
        s.conf.timeline_memory_sample_ms = 0.0
        assert timeline.start_sampler(s.conf) is None
        s.conf.timeline_memory_sample_ms = 5.0
        sampler = timeline.start_sampler(s.conf, device=s.device)
        assert sampler is not None
        sampler.stop()


# ---------------------------------------------------------------------------
# The spill-forced build: lanes, matrix, per-phase memory
# ---------------------------------------------------------------------------
@pytest.fixture(scope="class")
def spill_build(tmp_path_factory):
    """One spill-forced build with the timeline and a fast sampler on."""
    tmp_path = tmp_path_factory.mktemp("spill")
    src = str(tmp_path / "src")
    _write_source(src, n=120_000, files=6)
    session = _session(tmp_path, timeline_enabled=True,
                       timeline_memory_sample_ms=2.0)
    session.conf.device_batch_rows = 8192  # force the spill build
    hs = Hyperspace(session)
    timeline.reset()
    hs.create_index(session.read.parquet(src),
                    IndexConfig("spix", ["k"], ["v"]))
    yield session, hs
    timeline.disable_timeline()
    timeline.reset()


class TestSpillBuildTimeline:
    def test_lanes_matrix_ring_and_live_export(self, spill_build, tmp_path):
        """First in the class on purpose: the per-test cleanup empties
        the process ring, so the ring and export checks run in the slot
        the class fixture built in."""
        _session_, hs = spill_build
        report = hs.last_build_report()
        assert report.spill_bytes > 0, "the build did not spill"
        lanes = report.lane_report()
        for lane_name in ("read", "spill_route", "spill_finish"):
            assert lane_name in lanes["lanes"], sorted(lanes["lanes"])
        matrix = lanes["idle_while_busy"]
        assert max(matrix["read"]["spill_route"],
                   matrix["read"]["spill_finish"]) > 0.0, matrix
        kinds = {iv[1] for iv in timeline.recorder().intervals()}
        assert "build.phase" in kinds
        # Each routed chunk is one route_partition seam on the CPU lane.
        route = [iv for iv in timeline.recorder().intervals("device:-1")
                 if iv[1] == "kernel.route_partition"]
        assert len(route) == 15  # ceil(120,000 / 8,192) chunks
        path = str(tmp_path / "trace.json")
        hs.export_timeline(path)
        with open(path, "r", encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        _validate_trace_events(events)
        names = {e["name"] for e in events}
        assert "build.phase" in names
        assert "memory" in names
        assert "kernel.route_partition" in names
        ring_lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert {"read", "spill_route", "device:-1"} <= ring_lanes

    def test_memory_sampler_ran_and_phase_high_water(self, spill_build):
        _session_, hs = spill_build
        report = hs.last_build_report()
        assert report.memory_samples, "no background memory samples"
        peaks = report.phase_memory_mb()
        assert peaks, "no sample landed inside any phase interval"
        assert all(v > 0 for v in peaks.values()), peaks

    def test_to_dict_carries_lanes_and_peaks(self, spill_build):
        _session_, hs = spill_build
        d = hs.last_build_report().to_dict()
        assert "lanes" in d and "idle_while_busy" in d["lanes"]
        assert "phase_peak_rss_mb" in d

    def test_disabled_build_records_nothing(self, tmp_path):
        timeline.disable_timeline()
        timeline.reset()
        src = str(tmp_path / "src")
        _write_source(src, n=5_000, files=2)
        session = _session(tmp_path)
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("offix", ["k"], ["v"]))
        report = hs.last_build_report()
        assert report.intervals == []
        assert report.memory_samples == []
        assert "lanes" not in report.to_dict()


# ---------------------------------------------------------------------------
# Kernel attribution and the seams' cost contract
# ---------------------------------------------------------------------------
class TestKernelAttribution:
    def test_device_filter_emits_kernel_metrics(self, tmp_path):
        src = str(tmp_path / "src")
        _write_source(src, n=10_000, files=2)
        session = _session(tmp_path, timeline_enabled=True)
        session.conf.device_filter_min_rows = 0  # the device route
        metrics.reset()
        out = session.read.parquet(src).filter(col("k") < 100).collect()
        assert out.num_rows > 0
        snap = metrics.snapshot()
        hist = snap.get("exec.kernel.filter.device_ms")
        assert isinstance(hist, dict) and hist["count"] >= 1, sorted(snap)
        assert snap["exec.device.-1.kernel_ms"] > 0
        assert snap.get("exec.transfer.h2d.bytes", 0) > 0
        assert snap.get("exec.transfer.d2h.bytes", 0) > 0
        rep = session.last_run_report_value
        kernels = [d for d in rep.decisions if d.get("kind") == "kernel"]
        assert kernels and kernels[0]["name"] == "filter"
        assert kernels[0]["device"] == -1
        assert timeline.device_ms_summary(rep) > 0
        lanes = {iv[0] for iv in timeline.recorder().intervals()}
        assert "device:-1" in lanes, lanes

    def test_timeline_off_means_no_kernel_sync_or_metrics(self, tmp_path):
        timeline.disable_timeline()
        src = str(tmp_path / "src")
        _write_source(src, n=10_000, files=2)
        session = _session(tmp_path)
        session.conf.device_filter_min_rows = 0
        metrics.reset()
        session.read.parquet(src).filter(col("k") < 100).collect()
        assert "exec.kernel.filter.device_ms" not in metrics.snapshot()

    def test_executor_operator_intervals(self, tmp_path):
        src = str(tmp_path / "src")
        _write_source(src, n=5_000, files=2)
        session = _session(tmp_path, timeline_enabled=True)
        timeline.reset()
        session.read.parquet(src).collect()
        kinds = {iv[1] for iv in timeline.recorder().intervals("exec")}
        assert "Scan" in kinds, kinds

    def test_aggregate_and_join_seams(self, tmp_path):
        src = str(tmp_path / "src")
        _write_source(src, n=8_000, files=2)
        session = _session(tmp_path, timeline_enabled=True)
        for kind in ("filter", "join", "agg"):
            setattr(session.conf, f"device_{kind}_min_rows", 0)
        metrics.reset()
        a = session.read.parquet(src)
        a.group_by("k").agg(s=("v", "sum")).collect()
        b = session.read.parquet(src).select("k").distinct() \
            .with_column("kk", col("k"))
        a.join(b.select("kk"), col("k") == col("kk")).collect()
        snap = metrics.snapshot()
        assert snap["exec.kernel.aggregate.device_ms"]["count"] >= 1
        assert snap["exec.kernel.join.device_ms"]["count"] >= 1

    def test_seams_off_reach_no_cuda_call(self, tmp_path, monkeypatch):
        """With the timeline off a seam is one bool check: a build, a
        refresh and queries through every seam never reach a
        ``torch.cuda`` call (each patched to raise), while the seams
        themselves are passed."""
        calls = {"begin": 0}
        real_begin = timeline.kernel_begin

        def counting_begin(device=None):
            calls["begin"] += 1
            return real_begin(device)

        def boom(*_a, **_k):
            raise AssertionError("torch.cuda reached with the timeline off")

        for name in ("Event", "current_stream", "synchronize",
                     "memory_allocated"):
            monkeypatch.setattr(torch.cuda, name, boom)
        monkeypatch.setattr(timeline, "kernel_begin", counting_begin)
        timeline.disable_timeline()
        # A CUDA device passed to the seam takes no clock and no event.
        assert real_begin(torch.device("cuda")) is None
        src = str(tmp_path / "src")
        _write_source(src, n=20_000, files=2)
        session = _session(tmp_path, device_batch_rows=4096)
        for kind in ("filter", "join", "agg"):
            setattr(session.conf, f"device_{kind}_min_rows", 0)
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("seam", ["k"], ["v"]))
        _write_source(str(tmp_path / "src"), n=100, files=1, seed=5)
        session.enable_hyperspace()
        session.read.parquet(src).filter(col("k") < 100).collect()
        session.read.parquet(src).group_by("k").agg(s=("v", "sum")).collect()
        assert calls["begin"] > 0
        # And the patch is live: the same seam on, with a CUDA device,
        # reaches torch.cuda.Event.
        timeline.enable_timeline()
        with pytest.raises(AssertionError, match="torch.cuda reached"):
            real_begin(torch.device("cuda"))

    def test_bookkeeping_error_is_counted_not_raised(self, monkeypatch):
        timeline.enable_timeline()
        metrics.reset()

        def broken(*_a, **_k):
            raise RuntimeError("ring broken")

        monkeypatch.setattr(timeline._RECORDER, "record", broken)
        mark = timeline.kernel_begin(torch.device("cpu"))
        timeline.kernel_end("k", mark, torch.zeros(3))
        assert metrics.snapshot()["timeline.errors"] == 1.0


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------
def _validate_trace_events(events) -> None:
    assert isinstance(events, list) and events
    for ev in events:
        assert isinstance(ev, dict)
        assert ev.get("ph") in ("X", "C", "M"), ev
        assert isinstance(ev.get("pid"), int)
        if ev["ph"] == "M":
            assert ev.get("name") == "thread_name"
            assert isinstance(ev["args"]["name"], str)
            continue
        assert isinstance(ev.get("name"), str) and ev["name"]
        assert isinstance(ev.get("ts"), (int, float))
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float))
            assert ev["dur"] >= 0
        if ev["ph"] == "C":
            assert all(isinstance(v, (int, float))
                       for v in ev["args"].values()), ev


class TestPerfettoExport:
    def test_trace_event_builder_schema(self):
        from hyperspace_tpu.telemetry import timeline as jax_timeline

        kwargs = dict(intervals=[("read", "build.phase", 1000, 5000),
                                 ("spill_route", "build.phase", 2000, 9000)],
                      memory_samples=[(1500, 123.4, 1 << 20)])
        events = timeline.to_trace_events(**kwargs)
        _validate_trace_events(events)
        assert events == jax_timeline.to_trace_events(**kwargs)
        named = {e["args"]["name"] for e in events if e["ph"] == "M"}
        assert named == {"read", "spill_route"}
        x = [e for e in events if e["ph"] == "X"]
        assert min(e["ts"] for e in x) == pytest.approx(1.0)
        c = [e for e in events if e["ph"] == "C"]
        assert c and c[0]["args"]["host_rss_mb"] == pytest.approx(123.4)

    def test_live_export_carries_the_last_query_spans(self, tmp_path):
        from hyperspace_tpu_torch.telemetry import trace

        src = str(tmp_path / "src")
        _write_source(src, n=5_000, files=2)
        session = _session(tmp_path, timeline_enabled=True,
                           telemetry_tracing_enabled=True)
        try:
            hs = Hyperspace(session)
            session.read.parquet(src).collect()
        finally:
            trace.disable_tracing()
        path = str(tmp_path / "live.json")
        hs.export_timeline(path)
        with open(path, "r", encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        _validate_trace_events(events)
        names = {e["name"] for e in events}
        assert "query.collect" in names and "Scan" in names, names

    def test_export_by_trace_id_names_the_flight_recorder(self, tmp_path):
        """An id the flight recorder does not hold raises, naming it, as
        the JAX package's test_export_unknown_trace_id_raises asserts
        (the round trip is in tests/test_torch_diagnostics.py)."""
        hs = Hyperspace(_session(tmp_path))
        with pytest.raises(ValueError, match="no retained flight record"):
            hs.export_timeline(str(tmp_path / "x.json"),
                               trace_id="deadbeefdeadbeef")

    def test_reconstruct_from_perf_ledger_entry(self, tmp_path):
        src = str(tmp_path / "src")
        _write_source(src, n=5_000, files=2)
        session = _session(tmp_path)
        hs = Hyperspace(session)
        hs.create_index(session.read.parquet(src),
                        IndexConfig("lx", ["k"], ["v"]))
        history = hs.perf_history(index="lx")
        assert history.num_rows >= 1
        key = history.column("key").to_pylist()[-1]
        path = str(tmp_path / "from_ledger.json")
        hs.export_timeline(path, ledger_key=key)
        with open(path, "r", encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        _validate_trace_events(events)
        names = {e["name"] for e in events}
        assert any(n.startswith("phase.") for n in names), names

    def test_export_unknown_ledger_key_raises(self, tmp_path):
        hs = Hyperspace(_session(tmp_path))
        with pytest.raises(ValueError, match="no perf-ledger record"):
            hs.export_timeline(str(tmp_path / "x.json"),
                               ledger_key="r-0000000000000-0-00000")


# ---------------------------------------------------------------------------
# perf_history filters
# ---------------------------------------------------------------------------
class TestPerfHistoryFilters:
    @pytest.fixture()
    def seeded(self, tmp_path):
        src = str(tmp_path / "src")
        _write_source(src, n=6_000, files=2)
        session = _session(tmp_path)
        hs = Hyperspace(session)
        ds = session.read.parquet(src)
        hs.create_index(ds, IndexConfig("aa", ["k"], ["v"]))
        hs.create_index(ds, IndexConfig("bb", ["k"], ["v"]))
        perf_ledger.append(session.conf, {
            "kind": "bench", "name": "sf1_queries", "outcome": "ok",
            "wall_s": 1.0})
        return session, hs

    def test_index_filter(self, seeded):
        _session_, hs = seeded
        table = hs.perf_history(index="aa")
        names = table.column("name").to_pylist()
        assert names and all(n.endswith("(aa)") for n in names)
        assert hs.perf_history(index="nope").num_rows == 0

    def test_section_filter(self, seeded):
        _session_, hs = seeded
        table = hs.perf_history(section="sf1_queries")
        assert table.num_rows == 1
        assert table.column("kind").to_pylist() == ["bench"]

    def test_limit_keeps_most_recent(self, seeded):
        _session_, hs = seeded
        full = hs.perf_history()
        assert full.num_rows >= 3
        table = hs.perf_history(limit=2)
        assert table.num_rows == 2
        assert table.column("key").to_pylist() \
            == full.column("key").to_pylist()[-2:]


# ---------------------------------------------------------------------------
# chip_smoke's phase Q, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_phase_q_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase Q end to end at 80,000 lineitem rows: phase C's
    and D's indexes, then the traced build and queries with the timeline
    on, the seams, the export, the ledger, the exposition and the off/on
    pairs.  The CPU has no CUDA events or allocator to read, and the
    plain kernels count no launch, so those checks are stubbed here and
    run on the card."""
    import chip_smoke
    from hyperspace_tpu_torch import IndexConfig as Config

    conf_batch = HyperspaceSession(device="cpu").conf.device_batch_rows
    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("DEFAULT_BATCH_ROWS", conf_batch),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0), ("Q_PAIRS", 1)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *_a, **_k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *_a, **_k: 0)
    monkeypatch.setattr(chip_smoke, "require_launches",
                        lambda *_a, **_k: None)
    monkeypatch.setattr(chip_smoke, "q_event_calls",
                        lambda dev, queries: {"cudaEventRecord": int(
                            timeline.timeline_enabled())})
    monkeypatch.setattr(chip_smoke, "Q_EVENT_CALLS", ("cudaEventRecord",))
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
    out = chip_smoke.phase_q(orders, li, root, dev)
    chunks = -(-80_000 // conf_batch)
    assert out["route_partition_seams"] == chunks
    assert 0 < out["route_partition_seam_ms"] <= out["spill_route_ms"]
    assert {"filter", "join", "join_agg", "aggregate",
            "route_partition"} <= set(out["seams"])
    assert "device:-1" in out["exported_lanes"]
    assert out["memory_samples"] > 0
    assert out["families"] > 10
    assert out["event_calls_off"] == {"cudaEventRecord": 0}
    assert out["event_calls_on"] == {"cudaEventRecord": 1}
    assert len(out["walls"]["build_on_s"]) == 1
    assert not any(out["launches"].values())  # the plain kernels count none
    floor = chip_smoke.q_check_seams(
        {**out, "build_launches": {"hash_buckets": chunks,
                                   "bucket_histogram": chunks}},
        [{"name": "hash_buckets", "shapes": [
            {"shape": {"n": conf_batch}, "kernel_ms": 1e-6}]},
         {"name": "bucket_histogram", "shapes": [
             {"shape": {"n": conf_batch}, "kernel_ms": 1e-6}]}])
    assert floor["seam_floor_ms"] == pytest.approx(2 * chunks * 1e-6)
    assert not timeline.timeline_enabled()
