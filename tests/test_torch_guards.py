"""The port's query-path guards: the strict-mode sync guard
(execution/sync_guard.py), deadlines (utils/deadline.py), the plan cache
(execution/plan_cache.py), and the two errors that no containment,
fallback or backoff may take (``DeviceSyncError``,
``DeadlineExceededError``).

The JAX package's guard cannot be the oracle here: under jax 0.9.0
``jaxlib.xla_extension`` does not exist, so
``hyperspace_tpu/execution/sync_guard.py:140-146`` installs nothing, and
tests/test_sync_guard.py's ``test_armed_catches_item_float_bool_int``,
``test_error_names_the_seams_and_the_conf_key`` and
``test_deliberate_item_in_ops_kernel_is_caught`` fail there.  The port
is held to what each of that file's cases asserts instead (the class
``TestGuardUnit`` and ``TestGuardEndToEnd`` below, one case each, under
the JAX case's name), on a ``cpu`` session, where every tensor counts.
The deadline and plan-cache cases hold the port to the JAX package's
own modules on the same inputs."""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig, col
from hyperspace_tpu_torch.exceptions import (
    DeadlineExceededError,
    DeviceSyncError,
    HyperspaceError,
)
from hyperspace_tpu_torch.execution import plan_cache, sync_guard
from hyperspace_tpu_torch.execution.containment import is_index_side_error
from hyperspace_tpu_torch.telemetry import metrics, timeline
from hyperspace_tpu_torch.utils import deadline

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch


class _Conf:
    def __init__(self, enabled: bool) -> None:
        self.device_guard_enabled = enabled


@pytest.fixture(autouse=True)
def _disarm_after():
    device_type = sync_guard._device_type
    yield
    sync_guard.arm(_Conf(False))
    sync_guard._device_type = device_type
    timeline.disable_timeline()


def _snap(name: str) -> float:
    return float(metrics.snapshot().get(name, 0.0) or 0.0)


def _write(path: str, n: int = 2_000, files: int = 2, seed: int = 5,
           start: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = pa.table({
        "k": pa.array(np.arange(start, start + n, dtype=np.int64)),
        "g": pa.array(rng.integers(0, 7, n), type=pa.int64()),
        "v": pa.array(rng.integers(-50, 50, n), type=pa.int64()),
        "x": pa.array(rng.random(n)),
        "u": pa.array(rng.integers(0, 1 << 40, n).astype(np.uint64)),
    })
    step = -(-n // files)
    for i in range(files):
        pq.write_table(t.slice(i * step, step),
                       os.path.join(path, f"p{start}-{i:03d}.parquet"))


def _session(root: str, name: str = "ix", **conf) -> HyperspaceSession:
    s = HyperspaceSession(system_path=os.path.join(root, name), device="cpu")
    s.conf.num_buckets = 4
    for kind in ("filter", "join", "agg", "build"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


@pytest.fixture()
def env(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    _write(a, seed=5)
    _write(b, n=700, seed=6)
    return str(tmp_path), a, b


def _rows(t: pa.Table):
    return sorted(tuple(r.values()) for r in t.to_pylist())


# ---------------------------------------------------------------------------
# The guard, case by case against tests/test_sync_guard.py
# ---------------------------------------------------------------------------
class TestGuardUnit:
    def test_off_by_default_leaves_conversions_alone(self):
        sync_guard.arm(_Conf(False), "cpu")
        x = torch.arange(4)
        assert x[1].item() == 1
        assert float(x[2]) == 2.0
        assert x.numpy().tolist() == [0, 1, 2, 3]

    def test_armed_catches_item_float_bool_int(self):
        sync_guard.arm(_Conf(True), "cpu")
        x = torch.arange(4)
        before = _snap("guard.sync.violations")
        for convert in (lambda: x[0].item(), lambda: float(x[1]),
                        lambda: bool(x[2]), lambda: int(x[3])):
            with pytest.raises(DeviceSyncError):
                convert()
        assert _snap("guard.sync.violations") >= before + 4

    @pytest.mark.parametrize("convert", [
        lambda x: x.numpy(), lambda x: x.tolist(), lambda x: np.asarray(x),
        lambda x: [10, 20, 30][x[1]], lambda x: x.any().item(),
    ], ids=["numpy", "tolist", "array", "index", "any_item"])
    def test_armed_catches_the_torch_read_backs(self, convert):
        """The torch surface beyond the JAX one: ``numpy``, ``tolist``,
        ``__array__`` and ``__index__``."""
        sync_guard.arm(_Conf(True), "cpu")
        with pytest.raises(DeviceSyncError):
            convert(torch.arange(3))

    def test_cpu_and_to_cpu_pass_when_nothing_crosses(self):
        """``cpu()`` and ``to(cpu)`` of a CPU tensor copy nothing; a dtype
        ``to`` stays where it is."""
        sync_guard.arm(_Conf(True), "cpu")
        x = torch.arange(3)
        assert x.cpu() is x
        assert x.to("cpu").dtype == torch.int64
        assert x.to(torch.float64).dtype == torch.float64

    def test_a_cuda_guard_leaves_host_tensors_alone(self):
        """Armed for a ``cuda`` session, host torch work on CPU tensors
        passes."""
        sync_guard.arm(_Conf(True), "cuda")
        x = torch.arange(4)
        assert x[3].item() == 3 and x.numpy().sum() == 6
        assert x.cpu().tolist() == [0, 1, 2, 3]

    def test_attributed_seams_stay_legal_and_counted(self):
        sync_guard.arm(_Conf(True), "cpu")
        x = torch.arange(8)
        before = _snap("guard.sync.attributed")
        assert sync_guard.scalar(torch.sum(x), "t.sum") == 28
        np.testing.assert_array_equal(sync_guard.pull(x, "t.pull"),
                                      np.arange(8))
        assert _snap("guard.sync.attributed") >= before + 2

    def test_pull_feeds_the_d2h_bytes(self):
        sync_guard.arm(_Conf(False), "cpu")
        timeline.enable_timeline()
        metrics.reset()
        sync_guard.pull(torch.arange(16, dtype=torch.int64), "t")
        assert _snap("exec.transfer.d2h.bytes") == 128.0

    def test_host_tensors_on_a_cuda_session_count_no_transfer(self):
        """A CPU tensor on a ``cuda`` session crosses no bus: the seams
        convert it without adding to ``exec.transfer.d2h.bytes`` or
        ``guard.sync.attributed``."""
        sync_guard.arm(_Conf(True), "cuda")
        timeline.enable_timeline()
        metrics.reset()
        x = torch.arange(16, dtype=torch.int64)
        np.testing.assert_array_equal(sync_guard.pull(x, "t"),
                                      np.arange(16))
        assert sync_guard.scalar(x.sum(), "t") == 120
        assert _snap("exec.transfer.d2h.bytes") == 0.0
        assert _snap("guard.sync.attributed") == 0.0

    @pytest.mark.parametrize("device", ["cpu:0", torch.device("cpu", 0)],
                             ids=["string", "device"])
    def test_arm_takes_a_device_with_an_index(self, device):
        """``arm`` keys the guard on the device's type, so a device with
        an index arms it for every tensor of that type."""
        sync_guard.arm(_Conf(True), device)
        with pytest.raises(DeviceSyncError):
            torch.arange(2)[0].item()

    def test_host_values_pass_through_both_seams(self):
        sync_guard.arm(_Conf(True), "cpu")
        assert sync_guard.scalar(7, "t") == 7
        np.testing.assert_array_equal(
            sync_guard.pull(np.arange(3), "t"), np.arange(3))

    def test_disarm_restores_normal_conversions(self):
        sync_guard.arm(_Conf(True), "cpu")
        sync_guard.arm(_Conf(False))
        assert torch.arange(3)[2].item() == 2

    def test_error_names_the_seams_and_the_conf_key(self):
        sync_guard.arm(_Conf(True), "cpu")
        with pytest.raises(DeviceSyncError, match="sync_guard") as ei:
            torch.arange(2)[0].item()
        assert "device_guard_enabled" in str(ei.value)
        assert "pull()/scalar()" in str(ei.value)

    def test_armed_flag_is_global_allowance_thread_local(self):
        """A worker thread is caught too; an allowance window on one
        thread does not open the guard for another."""
        sync_guard.arm(_Conf(True), "cpu")
        caught = []
        opened = threading.Event()
        done = threading.Event()

        def worker():
            opened.wait(10)
            try:
                torch.arange(2)[1].item()
            except DeviceSyncError:
                caught.append(True)
            done.set()

        t = threading.Thread(target=worker)
        t.start()
        with sync_guard.allowed():
            assert torch.arange(2)[1].item() == 1
            opened.set()
            done.wait(10)
        t.join(10)
        assert caught == [True]


def _sneaky_filter(monkeypatch):
    """A predicate program that smuggles in an unattributed ``.item()``,
    as tests/test_sync_guard.py monkeypatches the JAX one."""
    from hyperspace_tpu_torch.ops import filter as ops_filter

    orig = ops_filter.compile_predicate

    def sneaky(expr, order):
        fn, lits = orig(expr, order)

        def bad_fn(cols, literals):
            cols[0][0].item()  # the unattributed sync
            return fn(cols, literals)

        return bad_fn, lits

    monkeypatch.setattr(ops_filter, "compile_predicate", sneaky)


class TestGuardEndToEnd:
    def test_deliberate_item_in_ops_kernel_is_caught(self, env, monkeypatch):
        root, a, _ = env
        s = _session(root, device_guard_enabled=True)
        _sneaky_filter(monkeypatch)
        before = _snap("guard.sync.violations")
        with pytest.raises(DeviceSyncError):
            s.read.parquet(a).filter(col("k") > 5).collect()
        assert _snap("guard.sync.violations") >= before + 1
        rep = s.last_run_report_value
        assert rep.outcome == "error"
        assert not [d for d in rep.decisions
                    if d.get("kind") in ("replan", "degraded", "quarantine")]

    def test_same_kernel_passes_with_guard_off(self, env, monkeypatch):
        root, a, _ = env
        s = _session(root)
        _sneaky_filter(monkeypatch)
        out = s.read.parquet(a).filter(col("k") > 5).collect()
        assert out.num_rows == 2_000 - 6

    def test_clean_device_query_is_legal_under_strict_mode(self, env):
        root, a, _ = env
        s = _session(root, device_guard_enabled=True)
        strict = s.read.parquet(a).filter(col("k") >= 32).collect()
        assert s.last_execution_stats["filters"][-1]["strategy"] == "device"
        s.conf.device_guard_enabled = False
        s.conf.device_filter_min_rows = 1 << 60  # the host route
        host = s.read.parquet(a).filter(col("k") >= 32).collect()
        assert _rows(strict) == _rows(host)

    def test_build_and_join_survive_strict_mode(self, env):
        root, a, b = env
        s = _session(root, device_guard_enabled=True)
        s.read.parquet(a).limit(1).collect()  # the first collect arms
        assert sync_guard.armed()
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(a), IndexConfig("ix_guard", ["k"],
                                                       ["v"]))
        s.enable_hyperspace()
        out = (s.read.parquet(a).filter(col("k") >= 8)
               .select("k", "v").collect())
        assert out.num_rows == 2_000 - 8


# ---------------------------------------------------------------------------
# Every read-back of the port passes strict mode with its plain answer
# ---------------------------------------------------------------------------
def _flow_filter(s, a, b):
    return s.read.parquet(a).filter((col("g") == 3) & (col("v") > 0)) \
        .select("k", "v").collect()


def _flow_join(s, a, b):
    right = s.read.parquet(b).select(kb=col("k"), vb=col("v"))
    return s.read.parquet(a).join(right, col("k") == col("kb")) \
        .select("k", "g", "vb").collect()


def _flow_aggregate(s, a, b):
    return s.read.parquet(a).group_by("g").agg(
        sv=("v", "sum"), mx=("x", "max"), n=("v", "count")).collect()


def _flow_join_aggregate(s, a, b):
    right = s.read.parquet(b).select(kb=col("k"), vb=col("v"))
    return s.read.parquet(a).join(right, col("k") == col("kb")) \
        .group_by("g").agg(r=(col("x") * 2.0, "sum")) \
        .sort(("r", False)).limit(3).collect()


def _flow_window(s, a, b):
    ds = s.read.parquet(a)
    for name, func, kw in (
            ("rn", "row_number", {}), ("rk", "rank", {}),
            ("dr", "dense_rank", {}), ("nt", "ntile", {"offset": 3}),
            ("lg", "lag", {"value": "v"}), ("fv", "first_value",
                                            {"value": "x"}),
            ("rs", "sum", {"value": "v", "frame": (None, 0)}),
            ("us", "sum", {"value": "u", "frame": (-2, 2)}),
            ("um", "mean", {"value": "u", "frame": (-1, 1)}),
            ("mn", "min", {"value": "x", "frame": (-3, 3)}),
            ("mx", "max", {"value": "x", "frame": (None, 0)}),
            ("cn", "count", {"frame": (-1, 0)})):
        ds = ds.with_window(name, func, partition_by=["g"],
                            order_by=[("v", True), ("k", True)], **kw)
    return ds.with_window("w", "sum", partition_by=["g"], value="v") \
        .collect()


def _flow_setop(s, a, b):
    return s.read.parquet(a).select("g").intersect(
        s.read.parquet(b).select("g")).collect()


def _flow_build_spill(s, a, b):
    s.conf.device_batch_rows = 512
    Hyperspace(s).create_index(s.read.parquet(a),
                               IndexConfig("sp", ["k"], ["v"]))
    s.enable_hyperspace()
    return s.read.parquet(a).filter(col("k") == 77).select("k", "v") \
        .collect()


def _flow_build_zorder(s, a, b):
    Hyperspace(s).create_index(
        s.read.parquet(a), IndexConfig("zx", ["g", "v"], ["k"],
                                       layout="zorder"))
    s.enable_hyperspace()
    return s.read.parquet(a).filter(col("v") > 40).select("k", "v") \
        .collect()


def _flow_repair_bucket_in(s, a, b):
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(a), IndexConfig("rp", ["k"], ["v"]))
    s.enable_hyperspace()
    victim = sorted(f for f in _index_files(s, "rp"))[0]
    _bitrot(victim)
    hs.verify_index("rp", "full")
    contained = s.read.parquet(a).filter(col("k") < 900) \
        .select("k", "v").collect()
    assert s.last_execution_stats["bucket_in"][-1]["strategy"] == "device"
    hs.refresh_index("rp", "repair")
    return pa.concat_tables([contained, s.read.parquet(a)
                             .filter(col("k") < 900).select("k", "v")
                             .collect()])


def _flow_hybrid_join(s, a, b):
    hs = Hyperspace(s)
    b2 = b + "_renamed"
    os.makedirs(b2)
    t = pa.concat_tables(pq.read_table(os.path.join(b, f))
                         for f in sorted(os.listdir(b)))
    pq.write_table(t.select(["k", "g"]).rename_columns(["kb", "gb"]),
                   os.path.join(b2, "p.parquet"))
    hs.create_index(s.read.parquet(a), IndexConfig("ha", ["k"], ["v"]))
    hs.create_index(s.read.parquet(b2), IndexConfig("hb", ["kb"], ["gb"]))
    _write(a, n=100, files=1, seed=9, start=500)
    s.conf.hybrid_scan_enabled = True
    s.enable_hyperspace()
    out = s.read.parquet(a).join(s.read.parquet(b2), col("k") == col("kb")) \
        .select("k", "v", "gb").collect()
    assert [j["hybrid"] for j in s.last_execution_stats["joins"]] == [True]
    return out


FLOWS = {
    "filter": _flow_filter, "join": _flow_join,
    "aggregate": _flow_aggregate, "join_aggregate": _flow_join_aggregate,
    "window": _flow_window, "setop": _flow_setop,
    "build_spill": _flow_build_spill, "build_zorder": _flow_build_zorder,
    "repair_bucket_in": _flow_repair_bucket_in,
    "hybrid_join": _flow_hybrid_join,
}


def _index_files(s, name):
    entry = s.index_collection_manager.get_index(name)
    return [f.name for f in entry.content.file_infos()]


def _bitrot(path: str) -> None:
    st = os.stat(path)
    with open(path, "r+b") as f:
        off = max(0, st.st_size // 2 - 4)
        f.seek(off)
        chunk = f.read(8)
        f.seek(off)
        f.write(bytes(x ^ 0xFF for x in chunk))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_every_read_back_passes_strict_mode(tmp_path, flow):
    """Each flow runs once unguarded and once with the guard armed for
    the ``cpu`` session (every tensor counts): the same answer, no
    violation, and attributed read-backs."""
    out = {}
    for strict in (False, True):
        root = str(tmp_path / ("strict" if strict else "plain"))
        a, b = os.path.join(root, "a"), os.path.join(root, "b")
        _write(a, seed=5)
        _write(b, n=700, seed=6)
        s = _session(root, device_guard_enabled=strict)
        sync_guard.arm(s.conf, s.device)
        v0 = _snap("guard.sync.violations")
        a0 = _snap("guard.sync.attributed")
        out[strict] = FLOWS[flow](s, a, b)
        if strict:
            assert sync_guard.armed()
            assert _snap("guard.sync.violations") == v0
            assert _snap("guard.sync.attributed") > a0
    assert out[True].num_rows > 0
    assert _rows(out[True]) == _rows(out[False])


@pytest.mark.parametrize("case", [
    "route_partition", "grouped_aggregate", "join_group_aggregate",
    "sorted_equi_join", "key64_to_codes", "frame_sum_uint64",
    "frame_mean_uint64", "bucket_offsets"])
def test_each_op_read_back_is_attributed(case):
    """The ops' read-backs one by one, armed: each returns numpy through
    ``sync_guard.pull``/``scalar``."""
    from hyperspace_tpu_torch.io import columnar
    from hyperspace_tpu_torch.io.parquet import bucket_offsets
    from hyperspace_tpu_torch.ops import aggregate, hash, join, join_agg
    from hyperspace_tpu_torch.ops import window as W
    from hyperspace_tpu_torch.ops import zorder

    rng = np.random.default_rng(3)
    n = 257
    keys = rng.integers(0, 40, n).astype(np.int64)
    words = rng.integers(0, 1 << 31, n).astype(np.uint32)
    cpu = torch.device("cpu")
    sync_guard.arm(_Conf(True), "cpu")
    a0 = _snap("guard.sync.attributed")
    if case == "route_partition":
        hw = columnar.to_hash_words(pa.array(keys))
        perm, counts = hash.route_partition([hw], [], 8, cpu)
        assert counts.sum() == n and sorted(perm) == list(range(n))
    elif case == "grouped_aggregate":
        first, counts, (s,) = aggregate.grouped_aggregate(
            [keys], [keys], ["sum"], cpu)
        assert counts.sum() == n and s.sum() == keys.sum()
    elif case == "join_group_aggregate":
        li, ri, counts, res = join_agg.join_group_aggregate(
            keys, keys[:50], [keys], ["l"], [0], ["count"], [], [],
            device=cpu)
        assert counts.sum() > 0 and len(li) == len(ri) == len(counts)
    elif case == "sorted_equi_join":
        li, ri = join.sorted_equi_join(keys, keys[:50], device=cpu)
        assert np.array_equal(keys[li], keys[:50][ri])
    elif case == "key64_to_codes":
        key, _ = zorder.zorder_sort(
            [torch.from_numpy(np.stack([words, words[::-1]], axis=1))])
        assert zorder.key64_to_codes(key).dtype == np.uint64
    elif case in ("frame_sum_uint64", "frame_mean_uint64"):
        ps = torch.zeros(n, dtype=torch.int64)
        pe = torch.full((n,), n - 1, dtype=torch.int64)
        lo, hi = W.frame_bounds(ps, pe, pe, (-2, 2), True)
        valid = torch.ones(n, dtype=torch.bool)
        vals = keys.astype(np.uint64)
        fn = W.frame_sum if case == "frame_sum_uint64" else W.frame_mean
        fn(vals, valid, lo, hi)
    elif case == "bucket_offsets":
        off = bucket_offsets(torch.from_numpy((keys % 4).astype(np.int32)),
                             4)
        assert off[-1] == n
    assert _snap("guard.sync.attributed") > a0


# ---------------------------------------------------------------------------
# Deadlines (against hyperspace_tpu/utils/deadline.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [JAX, TORCH], ids=["jax", "torch"])
class TestDeadlineScopes:
    def _dl(self, pkg):
        import importlib

        return importlib.import_module(f"{pkg.__name__}.utils.deadline")

    def test_none_and_nonpositive_are_noops(self, pkg):
        dl = self._dl(pkg)
        for value in (None, 0, -1.0):
            with dl.scope(value):
                assert not dl.active() and dl.remaining() is None
                dl.check("x")

    def test_nesting_keeps_the_tighter_deadline(self, pkg):
        dl = self._dl(pkg)
        with dl.scope(60.0):
            outer = dl.remaining()
            with dl.scope(3600.0):  # cannot extend the outer one
                assert dl.remaining() <= outer
            with dl.scope(0.5):
                assert dl.remaining() <= 0.5
            assert 59.0 < dl.remaining() <= 60.0
        assert not dl.active()

    def test_check_raises_past_the_deadline(self, pkg):
        dl = self._dl(pkg)
        with dl.scope(0.001):
            time.sleep(0.005)
            with pytest.raises(pkg.exceptions.DeadlineExceededError,
                               match="deadline exceeded at Scan"):
                dl.check("Scan")

    def test_worker_threads_do_not_inherit(self, pkg):
        dl = self._dl(pkg)
        seen = []
        with dl.scope(60.0):
            t = threading.Thread(target=lambda: seen.append(dl.active()))
            t.start()
            t.join()
        assert seen == [False]


def test_parallel_map_workers_do_not_inherit_the_deadline():
    from hyperspace_tpu_torch.utils.parallel_map import parallel_map_ordered

    main = threading.get_ident()
    with deadline.scope(60.0):
        seen = parallel_map_ordered(
            lambda _: (threading.get_ident(), deadline.active()),
            list(range(8)))
    on_workers = [active for ident, active in seen if ident != main]
    assert not any(on_workers)
    assert all(active for ident, active in seen if ident == main)


class TestDeadlineInTheExecutor:
    def test_a_passed_deadline_stops_at_planning(self, env):
        root, a, _ = env
        s = _session(root)
        with deadline.scope(1e-9):
            time.sleep(0.001)
            with pytest.raises(DeadlineExceededError, match="planning"):
                s.read.parquet(a).collect()
        assert s.last_run_report_value.outcome == "error"

    def test_operator_entry_and_exit_are_checked(self, env, monkeypatch):
        """A scan that spends the budget stops the aggregate above it at
        the scan's exit."""
        from hyperspace_tpu_torch.execution.executor import Executor

        root, a, _ = env
        s = _session(root)
        orig = Executor._scan

        def slow_scan(self, plan, **kw):
            out = orig(self, plan, **kw)
            time.sleep(0.05)
            return out

        monkeypatch.setattr(Executor, "_scan", slow_scan)
        with deadline.scope(0.02):
            # An exit check of the scan or of an operator that reads it
            # inside itself; never the planning seam, passed in time.
            with pytest.raises(DeadlineExceededError,
                               match="at (Scan|Project|Aggregate) "):
                s.read.parquet(a).group_by("g").count().collect()

    def test_within_the_deadline_answers(self, env):
        root, a, _ = env
        s = _session(root)
        with deadline.scope(60.0):
            out = s.read.parquet(a).group_by("g").count().collect()
        assert out.num_rows == 7


# ---------------------------------------------------------------------------
# Neither error is ever contained, degraded or backed off
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("err", [DeadlineExceededError, DeviceSyncError])
class TestTheyPropagate:
    def test_not_an_index_side_error(self, err):
        assert isinstance(err("x"), HyperspaceError)
        assert not is_index_side_error(err("x"))

    def test_rule_degradation_does_not_take_it(self, env, monkeypatch,
                                               err):
        """An index rule that raises it during planning: propagated, the
        rule not degraded (a plain ``HyperspaceError`` there degrades
        the rule and the query answers)."""
        from hyperspace_tpu_torch.rules import filter_rule

        root, a, _ = env
        s = _session(root)
        Hyperspace(s).create_index(s.read.parquet(a),
                                   IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()

        def boom(*args, **kwargs):
            raise err("from a rule")

        monkeypatch.setattr(filter_rule.FilterIndexRule, "apply", boom)
        with pytest.raises(err, match="from a rule"):
            s.read.parquet(a).filter(col("k") == 3).select("k", "v") \
                .collect()
        kinds = [d.get("kind") for d in s.last_run_report_value.decisions]
        assert "replan" not in kinds and "degraded" not in kinds

        def other(*args, **kwargs):
            raise HyperspaceError("index metadata")

        monkeypatch.setattr(filter_rule.FilterIndexRule, "apply", other)
        out = s.read.parquet(a).filter(col("k") == 3).select("k", "v") \
            .collect()
        assert out.num_rows == 1
        assert "degraded" in [d.get("kind")
                              for d in s.last_run_report_value.decisions]

    def test_planning_fallback_does_not_take_it(self, env, monkeypatch,
                                                err):
        """Planning with the indexes raises it: propagated, no
        source-fallback re-plan (a plain ``HyperspaceError`` there
        re-plans without the indexes)."""
        from hyperspace_tpu_torch.session import HyperspaceSession as S

        root, a, _ = env
        s = _session(root)
        Hyperspace(s).create_index(s.read.parquet(a),
                                   IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()
        orig = S.optimize
        raised = [err("while planning")]

        def optimize(self, plan, use_indexes=True):
            if use_indexes and raised:
                raise raised[0]
            return orig(self, plan, use_indexes=use_indexes)

        monkeypatch.setattr(S, "optimize", optimize)
        ds = s.read.parquet(a).filter(col("k") == 3).select("k", "v")
        with pytest.raises(err, match="while planning"):
            ds.collect()
        kinds = [d.get("kind") for d in s.last_run_report_value.decisions]
        assert "replan" not in kinds and "degraded" not in kinds
        raised[0] = HyperspaceError("index metadata")
        assert ds.collect().num_rows == 1
        assert "replan" in [d.get("kind")
                            for d in s.last_run_report_value.decisions]

    def test_containment_does_not_take_it(self, env, monkeypatch, err):
        """Raised while the executor reads index files: no probe, no
        quarantine, no re-plan; the plan-cache entry stays."""
        from hyperspace_tpu_torch.execution.executor import Executor

        root, a, _ = env
        s = _session(root)
        Hyperspace(s).create_index(s.read.parquet(a),
                                   IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()
        cache = plan_cache.PlanCache()
        ds = s.read.parquet(a).filter(col("k") == 3).select("k", "v")
        ds.collect(plan_cache=cache)
        orig = Executor._scan

        def failing(self, plan, **kw):
            self.index_read_failures.append("x")
            raise err("mid-scan")

        monkeypatch.setattr(Executor, "_scan", failing)
        with pytest.raises(err, match="mid-scan"):
            ds.collect(plan_cache=cache)
        monkeypatch.setattr(Executor, "_scan", orig)
        kinds = [d.get("kind") for d in s.last_run_report_value.decisions]
        assert not {"replan", "quarantine", "degraded"} & set(kinds)
        assert s.index_collection_manager.quarantine_manager("ix") \
            .records() == []
        ds.collect(plan_cache=cache)
        assert cache.stats()["hits"] == 2

    def test_the_daemon_raises_it(self, env, monkeypatch, err):
        from hyperspace_tpu_torch.lifecycle.daemon import daemon_for

        root, a, _ = env
        s = _session(root)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(a), IndexConfig("ix", ["k"], ["v"]))
        _write(a, n=50, files=1, seed=8, start=9_000)
        def boom(self, name, mode):
            raise err("in a refresh")

        monkeypatch.setattr(type(s.index_collection_manager), "refresh",
                            boom)
        with pytest.raises(err, match="in a refresh"):
            hs.maintenance_cycle()
        assert daemon_for(s).backoff_snapshot() == {}


# ---------------------------------------------------------------------------
# The plan cache (against hyperspace_tpu/execution/plan_cache.py)
# ---------------------------------------------------------------------------
def _pkg_session(pkg, root, name):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, name), **kw)
    s.conf.num_buckets = 4
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    # Both packages keep their default store, EmulatedObjectStore.
    return s


def _cache_decisions(pkg, root, a):
    """One sequence through ``pkg``: miss, hit, another literal, a
    committed action (stale), then a hit again; returns per step the
    rows, the plan_cache decisions and the indexes used, the cache's
    stats and which keys differ."""
    import importlib

    pc = importlib.import_module(f"{pkg.__name__}.execution.plan_cache")
    s = _pkg_session(pkg, root, pkg.__name__)
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(a), pkg.IndexConfig("ix", ["k"], ["v"]))
    s.enable_hyperspace()
    cache = pc.PlanCache()
    c = pkg.col
    steps = []

    def run(k):
        out = s.read.parquet(a).filter(c("k") == k).select("k", "v") \
            .collect(plan_cache=cache)
        d = [x for x in s.last_run_report_value.decisions
             if x.get("kind") == "plan_cache"]
        used = [x.get("index") for x in s.last_run_report_value.decisions
                if x.get("kind") == "index.used"]
        steps.append((out.num_rows, [x["hit"] for x in d], used))

    run(7)
    run(7)
    run(8)
    # A committed action (a full refresh of an unchanged source would be
    # a noop and commit nothing).
    hs.create_index(s.read.parquet(a), pkg.IndexConfig("ig", ["g"], ["v"]))
    run(7)
    run(7)
    key7 = cache.key_for(s, s.read.parquet(a).filter(c("k") == 7)
                         .select("k", "v").plan)
    key8 = cache.key_for(s, s.read.parquet(a).filter(c("k") == 8)
                         .select("k", "v").plan)
    s.disable_hyperspace()
    key7_off = cache.key_for(s, s.read.parquet(a).filter(c("k") == 7)
                             .select("k", "v").plan)
    st = cache.stats()
    return steps, (st["hits"], st["misses"]), \
        (key7 != key8, key7 != key7_off, key7 is not None)


def test_plan_cache_matches_the_jax_package(tmp_path):
    a = str(tmp_path / "a")
    _write(a, seed=5)
    metrics.reset()
    got = {pkg: _cache_decisions(pkg, str(tmp_path), a)
           for pkg in (JAX, TORCH)}
    assert got[TORCH] == got[JAX]
    steps = got[TORCH][0]
    assert [h for _, h, _ in steps] == [[False], [True], [False], [False],
                                        [True]]
    assert steps[1][2] == ["ix"]  # a hit still names the index used
    assert _snap("serve.plan_cache.stale") == 1.0


def test_plan_cache_invalidated_when_execution_fails(env, monkeypatch):
    from hyperspace_tpu_torch.execution.executor import Executor

    root, a, _ = env
    s = _session(root)
    cache = plan_cache.PlanCache()
    ds = s.read.parquet(a).filter(col("k") == 3)
    ds.collect(plan_cache=cache)
    key = cache.key_for(s, ds.plan)
    assert cache.get(key) is not None

    def failing(self, plan, **kw):
        raise OSError("disk gone")

    monkeypatch.setattr(Executor, "_scan", failing)
    with pytest.raises(OSError):
        ds.collect(plan_cache=cache)
    assert cache._lru.peek(key) is None


def test_plan_cache_ttl_and_uncacheable(env):
    root, a, _ = env
    s = _session(root)
    cache = plan_cache.PlanCache(ttl_s=0.0)
    ds = s.read.parquet(a).filter(col("k") == 3)
    ds.collect(plan_cache=cache)
    time.sleep(0.01)
    ds.collect(plan_cache=cache)
    assert cache.stats()["hits"] == 0
    from hyperspace_tpu_torch.plan.nodes import InMemory

    assert cache.key_for(s, InMemory(pa.table({"a": [1]}))) is None


def test_committed_actions_bump_the_generation(env):
    root, a, _ = env
    s = _session(root)
    hs = Hyperspace(s)
    g0 = plan_cache.current_generation()
    hs.create_index(s.read.parquet(a), IndexConfig("ix", ["k"], ["v"]))
    hs.refresh_index("ix", "full")  # unchanged source: a noop
    g1 = plan_cache.current_generation()
    hs.delete_index("ix")
    hs.restore_index("ix")
    assert (g1 - g0, plan_cache.current_generation() - g1) == (1, 2)
