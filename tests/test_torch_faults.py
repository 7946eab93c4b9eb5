"""The op log's failure envelope through hyperspace_tpu_torch (on the CPU)
against the JAX package: fault injection (io/faults.py), bounded retry
(utils/retry.py), crash-consistent log writes and renames, and a build
that dies mid-flight and recovers.

One case per case of tests/test_log_manager.py and of the POSIX cases of
tests/test_build_pipeline.py::TestFaultMatrix: each scenario runs through
both packages, each arming the fault in its own injector (a plan is
process-global in each package and arms only that package's sites), and
what each leaves behind is compared exactly: log ids and states, the
latestStable pointer, exception types, the index files' sha256 per
bucket after recovery and query rows in order.

The fault matrix runs with the temporary directory pointed at the test's
own, so the spill directories it counts (and the orphans a build start
reaps) are this test's alone: with the shared temporary directory the
JAX cases see other workers' spill directories come and go, which is how
``test_crash_at_commit[object_store]`` and
``test_io_delete_during_finalize`` failed in earlier runs (ROADMAP.md,
Queue C).
"""

from __future__ import annotations

import errno
import hashlib
import importlib
import os
import random
import tempfile
import time
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch.index.log_manager import (
    IndexLogManager as _TorchIndexLogManager,
)
from tests.test_build_pipeline import OBJECT_MANAGER, POSIX_MANAGER
from tests.test_build_pipeline import _build as _jax_build
from tests.test_build_pipeline import _write_source
from tests.utils import sample_entry

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


@pytest.fixture(autouse=True)
def _disarm_both():
    yield
    for pkg in PKGS:
        _m(pkg, "io.faults").clear()


def _arm(pkg, **plan):
    faults = _m(pkg, "io.faults")
    faults.install(faults.FaultPlan(**plan))
    return faults


def _entry(pkg, state):
    e = sample_entry(state=state)
    e.timestamp = 1_700_000_000_000  # the same payload bytes in both
    if pkg is JAX:
        return e
    return _m(TORCH, "index.log_entry").IndexLogEntry.from_dict(e.to_dict())


def _log_manager(pkg, root):
    return _m(pkg, "index.log_manager").IndexLogManager(
        os.path.join(str(root), pkg.__name__, "idx"))


def _stable_idx(pkg, root):
    """CREATING at 1, ACTIVE at 2, latestStable -> 2."""
    mgr = _log_manager(pkg, root)
    states = _m(pkg, "index.log_entry").States
    mgr.write_log(1, _entry(pkg, states.CREATING))
    mgr.write_log(2, _entry(pkg, states.ACTIVE))
    mgr.create_latest_stable_log(2)
    return mgr


def _log_view(mgr):
    """Ids, the state of each (None: torn), the resolved stable entry
    and the log directory's file names."""
    ids = mgr.log_ids()
    stable = mgr.get_latest_stable_log()
    return {"ids": ids,
            "states": [(e.state if e is not None else None)
                       for e in (mgr.get_log(i) for i in ids)],
            "stable": None if stable is None else (stable.id, stable.state),
            "files": sorted(os.listdir(mgr.log_dir))
            if os.path.isdir(mgr.log_dir) else []}


def _both(fn, tmp_path):
    """``fn(pkg, root)`` through both packages; their observations must be
    equal."""
    got = [fn(pkg, tmp_path / pkg.__name__) for pkg in PKGS]
    assert got[1] == got[0]
    return got[1]


def _raised(fn):
    """The exception ``fn`` raised (a BaseException: a crash is one), or
    None."""
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - InjectedCrash included
        return e
    return None


# ---------------------------------------------------------------------------
# tests/test_log_manager.py
# ---------------------------------------------------------------------------

def test_write_log_create_if_absent(tmp_path):
    def run(pkg, root):
        mgr = _log_manager(pkg, root)
        states = _m(pkg, "index.log_entry").States
        e = _entry(pkg, states.CREATING)
        return [mgr.write_log(1, e), mgr.write_log(1, e), mgr.get_latest_id(),
                mgr.get_log(1).state, _log_view(mgr)]

    out = _both(run, tmp_path)
    assert out[:4] == [True, False, 1, "CREATING"]


def test_latest_stable_pointer_and_fallback(tmp_path):
    def run(pkg, root):
        mgr = _log_manager(pkg, root)
        states = _m(pkg, "index.log_entry").States
        mgr.write_log(1, _entry(pkg, states.CREATING))
        mgr.write_log(2, _entry(pkg, states.ACTIVE))
        mgr.create_latest_stable_log(2)
        out = [mgr.get_latest_stable_log().state]
        mgr.write_log(3, _entry(pkg, states.REFRESHING))
        out.append(mgr.get_latest_stable_log().id)
        mgr.delete_latest_stable_log()
        out.append(mgr.get_latest_stable_log().id)
        return out + [_log_view(mgr)]

    assert _both(run, tmp_path)[:3] == ["ACTIVE", 2, 2]


def test_get_latest_log_empty(tmp_path):
    def run(pkg, root):
        mgr = _m(pkg, "index.log_manager").IndexLogManager(
            os.path.join(str(root), "nope"))
        return [mgr.get_latest_id(), mgr.get_latest_log(),
                mgr.get_latest_stable_log()]

    assert _both(run, tmp_path) == [None, None, None]


class TestFaultInjection:
    def test_torn_trailing_entry_is_skipped(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            states = _m(pkg, "index.log_entry").States
            faults = _arm(pkg, site="log.write", kind="torn")
            err = _raised(lambda: mgr.write_log(
                3, _entry(pkg, states.REFRESHING)))
            faults.clear()
            out = [type(err).__name__,
                   os.path.isfile(os.path.join(mgr.log_dir, "3")),
                   mgr.get_latest_id(), mgr.get_log(3),
                   mgr.get_latest_log().state,
                   mgr.get_latest_stable_log().id]
            mgr.delete_latest_stable_log()
            out.append(mgr.get_latest_stable_log().id)
            out.append(mgr.write_log(4, _entry(pkg, states.DELETING)))
            out.append(mgr.get_latest_log().state)
            with open(os.path.join(mgr.log_dir, "3"), "rb") as f:
                out.append(hashlib.sha256(f.read()).hexdigest())
            return out + [_log_view(mgr)]

        out = _both(run, tmp_path)
        assert out[:9] == ["InjectedCrash", True, 3, None, "ACTIVE", 2, 2,
                           True, "DELETING"]

    @pytest.mark.parametrize("kind", ["eio", "enospc"])
    def test_transient_write_error_retries(self, tmp_path, kind):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            states = _m(pkg, "index.log_entry").States
            _arm(pkg, site="log.write", kind=kind, count=1)
            ok = mgr.write_log(3, _entry(pkg, states.DELETING))
            return [ok, mgr.get_log(3).state, _log_view(mgr)]

        assert _both(run, tmp_path)[:2] == [True, "DELETING"]

    def test_retry_budget_is_bounded(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            states = _m(pkg, "index.log_entry").States
            mgr.retry = _m(pkg, "utils.retry").RetryPolicy(
                max_attempts=2, initial_backoff_ms=1)
            faults = _arm(pkg, site="log.write", kind="eio", count=-1)
            err = _raised(lambda: mgr.write_log(
                3, _entry(pkg, states.DELETING)))
            calls = faults.active()._calls
            faults.clear()
            view = _log_view(mgr)
            return [type(err).__name__, err.errno, calls, view,
                    mgr.write_log(3, _entry(pkg, states.DELETING))]

        out = _both(run, tmp_path)
        assert out[:3] == ["OSError", errno.EIO, 2] and out[4] is True

    def test_concurrent_write_conflict_is_not_retried(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            states = _m(pkg, "index.log_entry").States
            mgr.retry = _m(pkg, "utils.retry").RetryPolicy(
                max_attempts=5, initial_backoff_ms=200)
            t0 = time.perf_counter()
            ok = mgr.write_log(2, _entry(pkg, states.ACTIVE))
            return [ok, time.perf_counter() - t0 < 0.2]

        assert _both(run, tmp_path) == [False, True]

    def test_crash_before_rename_resolves_last_good_entry(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            states = _m(pkg, "index.log_entry").States
            mgr.write_log(3, _entry(pkg, states.DELETING))
            mgr.delete_latest_stable_log()
            mgr.write_log(4, _entry(pkg, states.DELETED))
            faults = _arm(pkg, site="log.rename", kind="crash-before-rename")
            err = _raised(lambda: mgr.create_latest_stable_log(4))
            faults.clear()
            resolved = mgr.get_latest_stable_log()
            out = [type(err).__name__,
                   os.path.isfile(os.path.join(mgr.log_dir,
                                               "latestStable.tmp")),
                   os.path.isfile(os.path.join(mgr.log_dir, "latestStable")),
                   resolved.id, resolved.state, _log_view(mgr)]
            mgr.create_latest_stable_log(2)
            return out + [mgr.get_latest_stable_log().state]

        out = _both(run, tmp_path)
        assert out[:5] == ["InjectedCrash", True, False, 4, "DELETED"]
        assert out[6] == "ACTIVE"

    def test_crash_after_rename_is_durable(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            states = _m(pkg, "index.log_entry").States
            mgr.write_log(3, _entry(pkg, states.DELETING))
            mgr.write_log(4, _entry(pkg, states.DELETED))
            faults = _arm(pkg, site="log.rename", kind="crash-after-rename")
            err = _raised(lambda: mgr.create_latest_stable_log(4))
            faults.clear()
            stable = mgr.get_latest_stable_log()
            return [type(err).__name__, stable.id, stable.state,
                    _log_view(mgr)]

        assert _both(run, tmp_path)[:3] == ["InjectedCrash", 4, "DELETED"]

    def test_file_listing_retries_transient_errors(self, tmp_path):
        def run(pkg, root):
            d = root / "data"
            d.mkdir(parents=True)
            (d / "p.parquet").write_bytes(b"x")
            list_data_files = _m(pkg, "io.files").list_data_files
            faults = _arm(pkg, site="io.list", kind="eio", count=1)
            names = [os.path.basename(f.name)
                     for f in list_data_files([str(d)])]
            faults.clear()
            _arm(pkg, site="io.list", kind="eio", count=-1)
            err = _raised(lambda: list_data_files([str(d)]))
            return [names, type(err).__name__, err.errno]

        assert _both(run, tmp_path) == [["p.parquet"], "OSError", errno.EIO]

    def test_log_discovery_rides_listing_retry(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            faults = _arm(pkg, site="io.list", kind="eio", count=1)
            out = [mgr.get_latest_id()]
            faults.clear()
            faults = _arm(pkg, site="io.list", kind="eio", count=1)
            out.append(mgr.log_ids())
            faults.clear()
            mgr.retry = _m(pkg, "utils.retry").RetryPolicy(
                max_attempts=2, initial_backoff_ms=1)
            _arm(pkg, site="io.list", kind="eio", count=-1)
            err = _raised(mgr.get_latest_id)
            return out + [type(err).__name__]

        assert _both(run, tmp_path) == [2, [1, 2], "OSError"]

    def test_data_read_site_retries_transient_errors(self, tmp_path):
        """The JAX package's ``read_parquet_file`` is the port's
        ``read_table`` of one file; ``read_schema`` is both's."""
        p = str(tmp_path / "t.parquet")
        pq.write_table(pa.table({"a": pa.array(np.arange(5))}), p)

        def run(pkg, root):
            parquet = _m(pkg, "io.parquet")
            read_one = parquet.read_parquet_file if pkg is JAX \
                else (lambda path: parquet.read_table([path]))
            faults = _arm(pkg, site="data.read", kind="eio", count=1)
            table = read_one(p)
            faults.clear()
            faults = _arm(pkg, site="data.read", kind="eio", count=1)
            schema = parquet.read_schema(p)
            faults.clear()
            _arm(pkg, site="data.read", kind="eio", count=-1)
            err = _raised(lambda: read_one(p))
            return [table.to_pydict(), schema, type(err).__name__, err.errno]

        assert _both(run, tmp_path)[1:] == [{"a": "int64"}, "OSError",
                                            errno.EIO]

    def test_end_protocol_crash_between_delete_and_write(self, tmp_path):
        def run(pkg, root):
            mgr = _stable_idx(pkg, root)
            mgr.delete_latest_stable_log()
            return [mgr.get_latest_stable_log().id, _log_view(mgr)]

        assert _both(run, tmp_path)[0] == 2


class TorchConditionalPutLogManager(_TorchIndexLogManager):
    """The port's counterpart of tests/test_log_manager.py's
    ``ConditionalPutLogManager``: commits go through a put-if-absent
    ledger shared by the class."""

    committed_ids: set = set()
    instances: list = []

    def __init__(self, index_path):
        super().__init__(index_path)
        type(self).instances.append(index_path)

    def write_log(self, log_id, entry):
        key = (self.index_path, log_id)
        if key in type(self).committed_ids:
            return False
        ok = super().write_log(log_id, entry)
        if ok:
            type(self).committed_ids.add(key)
        return ok


def test_log_manager_class_is_conf_pluggable(tmp_path):
    """Each package plugs its conditional-put log manager in through
    ``conf.log_manager_class``: the ledgers saw the same ids (the begin
    at 1, the commit at 2), the queries answer alike, and an unknown
    class name, or the port naming a class of the JAX package, fails
    loudly."""
    from tests.test_log_manager import ConditionalPutLogManager

    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(100, dtype=np.int64)),
                             "v": pa.array(np.arange(100) * 0.5)}),
                   os.path.join(d, "p.parquet"))
    out = {}
    for pkg in PKGS:
        if pkg is JAX:
            s = JAX.HyperspaceSession(system_path=str(tmp_path / "jax"))
            manager = ConditionalPutLogManager
            s.conf.log_manager_class = (
                "tests.test_log_manager.ConditionalPutLogManager")
        else:
            s = TORCH.HyperspaceSession(system_path=str(tmp_path / "torch"),
                                        device="cpu")
            manager = TorchConditionalPutLogManager
            s.conf.log_manager_class = (
                "tests.test_torch_faults.TorchConditionalPutLogManager")
        manager.instances.clear()
        manager.committed_ids.clear()
        s.conf.num_buckets = 2
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(d), pkg.IndexConfig("plg", ["k"],
                                                           ["v"]))
        assert manager.instances, "custom backend unused"
        ids = sorted(i for (_p, i) in manager.committed_ids)
        s.enable_hyperspace()
        rows = (s.read.parquet(d).filter(pkg.col("k") == 7).select("k", "v")
                .collect().to_pylist())
        out[pkg.__name__] = (ids, rows)
        s.conf.log_manager_class = "nope.Missing"
        with pytest.raises(pkg.HyperspaceError, match="Cannot load"):
            hs.create_index(s.read.parquet(d), pkg.IndexConfig("x", ["k"], []))
        if pkg is TORCH:
            s.conf.log_manager_class = POSIX_MANAGER
            with pytest.raises(TORCH.HyperspaceError, match="JAX package"):
                hs.create_index(s.read.parquet(d),
                                TORCH.IndexConfig("x", ["k"], []))
    assert out["hyperspace_tpu_torch"] == out["hyperspace_tpu"]
    assert out["hyperspace_tpu"] == ([1, 2], [{"k": 7, "v": 3.5}])


# ---------------------------------------------------------------------------
# tests/test_build_pipeline.py::TestFaultMatrix, the POSIX backend
# ---------------------------------------------------------------------------

def _torch_build(root, data, name, **conf):
    """The port's counterpart of test_build_pipeline._build: a spill-forced
    pipelined build on the CPU, the build's device route (the kernels'
    plain versions) pinned."""
    s = TORCH.HyperspaceSession(system_path=os.path.join(root, f"ix-{name}"),
                                device="cpu")
    s.conf.num_buckets = 4
    s.conf.device_batch_rows = 512
    s.conf.build_pipeline_enabled = True
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    hs = TORCH.Hyperspace(s)
    hs.create_index(s.read.parquet(data),
                    TORCH.IndexConfig(name, ["k"], ["v", "w"]))
    return s, hs, s.index_collection_manager.get_index(name)


# The log manager of each package per backend of
# tests/test_build_pipeline.py's ``backend`` fixture.
_MANAGERS = {
    JAX: {"posix": POSIX_MANAGER, "object_store": OBJECT_MANAGER},
    TORCH: {"posix": "hyperspace_tpu_torch.index.log_manager.IndexLogManager",
            "object_store": "hyperspace_tpu_torch.index.object_log_manager"
                            ".ObjectStoreLogManager"},
}


def _build_pkg(pkg, root, data, name, backend="posix", **conf):
    if pkg is JAX:
        return _jax_build(root, data, name, pipelined=True,
                          backend=_MANAGERS[JAX][backend], **conf)
    return _torch_build(root, data, name,
                        log_manager_class=_MANAGERS[TORCH][backend], **conf)


def _session_of(pkg, root, name, backend="posix"):
    kw = {} if pkg is JAX else {"device": "cpu"}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, f"ix-{name}"),
                              **kw)
    s.conf.log_manager_class = _MANAGERS[pkg][backend]
    return s


def _spill_dirs():
    root = tempfile.gettempdir()
    return {n for n in os.listdir(root)
            if n.startswith(("hs_build_spill_", "hs_zbuild_"))}


def _bucket_digests(entry):
    """bucket -> sorted sha256 of its files."""
    bucket_of = _m(TORCH, "io.parquet").bucket_id_of_file
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_of(f.name)].append(hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(d) for b, d in out.items()}


@pytest.fixture()
def own_tmp(tmp_path, monkeypatch):
    """The temporary directory of the spill builds: the test's own."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def _fault_then_recover(tmp_path, name, plan, pkg_check=None,
                        backend="posix"):
    """Build under ``plan`` through each package, then inspect the log
    and rebuild the name with auto recovery; returns the per-package
    observations (equal across the packages; over the object-store log
    the log directory's file names too)."""
    data = str(tmp_path / "data")
    _write_source(data)
    got = []
    for pkg in PKGS:
        root = str(tmp_path / pkg.__name__)
        before = _spill_dirs()
        faults = _arm(pkg, **plan)
        try:
            err = _raised(lambda: _build_pkg(pkg, root, data, name, backend))
        finally:
            faults.clear()
        mgr = _session_of(pkg, root, name, backend).index_collection_manager \
            ._log_manager(name)
        obs = {"error": type(err).__name__,
               "spill_left": sorted(_spill_dirs() - before),
               "after_fault": _log_view(mgr)}
        s, _, entry = _build_pkg(pkg, root, data, name, backend,
                                 auto_recovery_enabled=True)
        obs["recovered"] = entry.state
        obs["after_recovery"] = _log_view(mgr)
        obs["digests"] = _bucket_digests(entry)
        s.enable_hyperspace()
        obs["rows"] = (s.read.parquet(data).filter(pkg.col("k") == 123)
                       .select("k", "v").collect().to_pylist())
        if pkg_check is not None:
            pkg_check(pkg, s, name)
        got.append(obs)
    if backend == "posix":
        for obs in got:
            obs["after_fault"].pop("files")
            obs["after_recovery"].pop("files")
    assert got[1] == got[0]
    return got[1]


class TestFaultMatrix:
    @pytest.mark.parametrize("kind", ["eio", "enospc", "torn"])
    def test_data_write_faults(self, tmp_path, own_tmp, kind):
        out = _fault_then_recover(tmp_path, "f",
                                  {"site": "data.write", "kind": kind})
        assert out["error"] == ("InjectedCrash" if kind == "torn"
                                else "OSError")
        assert out["spill_left"] == []
        assert out["after_fault"]["states"] == ["CREATING"]
        assert out["after_fault"]["stable"] is None
        assert out["recovered"] == "ACTIVE"
        assert out["after_recovery"]["states"] == [
            "CREATING", "DOESNOTEXIST", "CREATING", "ACTIVE"]
        assert out["rows"]

    def test_crash_at_commit(self, tmp_path, own_tmp):
        out = _fault_then_recover(tmp_path, "c",
                                  {"site": "action.commit", "kind": "crash"})
        assert out["error"] == "InjectedCrash"
        assert out["spill_left"] == []
        assert out["after_fault"]["states"] == ["CREATING"]
        assert out["after_fault"]["stable"] is None
        assert out["recovered"] == "ACTIVE"

    def test_io_delete_during_finalize(self, tmp_path, own_tmp):
        """The first io.delete of a pipelined spill build is a finalize
        worker's removal of its group's consumed runs: an eio there fails
        the build, leaves no spill directory and a rebuildable name."""
        out = _fault_then_recover(tmp_path, "d",
                                  {"site": "io.delete", "kind": "eio"})
        assert out["error"] == "OSError"
        assert out["spill_left"] == []
        assert out["recovered"] == "ACTIVE"


class TestFaultMatrixObjectStore:
    """The ``object_store`` backend of tests/test_build_pipeline.py's
    fault matrix: each package's ``ObjectStoreLogManager`` over its
    default ``EmulatedObjectStore``; the log directories hold the same
    file names, sidecars included."""

    @pytest.mark.parametrize("backend", ["object_store"])
    @pytest.mark.parametrize("kind", ["eio", "torn"])
    def test_data_write_faults(self, tmp_path, own_tmp, kind, backend):
        out = _fault_then_recover(tmp_path, "f",
                                  {"site": "data.write", "kind": kind},
                                  backend=backend)
        assert out["error"] == ("InjectedCrash" if kind == "torn"
                                else "OSError")
        assert out["spill_left"] == []
        assert out["after_fault"]["states"] == ["CREATING"]
        assert out["after_fault"]["stable"] is None
        assert out["recovered"] == "ACTIVE"
        assert out["after_recovery"]["states"] == [
            "CREATING", "DOESNOTEXIST", "CREATING", "ACTIVE"]
        assert "latestStable.g" in out["after_recovery"]["files"]

    @pytest.mark.parametrize("backend", ["object_store"])
    def test_crash_at_commit(self, tmp_path, own_tmp, backend):
        out = _fault_then_recover(tmp_path, "c",
                                  {"site": "action.commit", "kind": "crash"},
                                  backend=backend)
        assert out["error"] == "InjectedCrash"
        assert out["spill_left"] == []
        assert out["after_fault"]["states"] == ["CREATING"]
        assert out["after_fault"]["stable"] is None
        assert out["after_fault"]["files"] == [".lock", "1", "1.g"]
        assert out["recovered"] == "ACTIVE"


# ---------------------------------------------------------------------------
# Beyond the oracles
# ---------------------------------------------------------------------------

def test_a_plan_arms_only_its_own_package(tmp_path):
    """A JAX plan leaves the port's sites alone, and a port plan the JAX
    package's."""
    for armed in PKGS:
        other = TORCH if armed is JAX else JAX
        mgrs = {pkg: _stable_idx(pkg, tmp_path / armed.__name__)
                for pkg in PKGS}

        def write(pkg):
            states = _m(pkg, "index.log_entry").States
            return _raised(lambda: mgrs[pkg].write_log(
                3, _entry(pkg, states.DELETING)))

        faults = _arm(armed, site="log.write", kind="crash")
        try:
            assert write(other) is None
            assert type(write(armed)).__name__ == "InjectedCrash"
        finally:
            faults.clear()


def test_fault_plan_refuses_what_can_never_fire():
    faults = _m(TORCH, "io.faults")
    with pytest.raises(ValueError, match="Unknown fault site"):
        # hslint: allow[fault-site-registry] the misspelt site under test
        faults.FaultPlan(site="log.wirte", kind="eio")
    with pytest.raises(ValueError, match="Unknown fault kind"):
        faults.FaultPlan(site="log.write", kind="explode")
    # A wire kind pairs only with a wire site and a file kind only with a
    # file site, in both packages: a mismatched plan would never fire.
    for pkg in PKGS:
        pkg_faults = _m(pkg, "io.faults")
        pkg_faults.FaultPlan(site="net.send", kind="reset")
        for site, kind in (("net.send", "eio"), ("log.write", "reset")):
            with pytest.raises(ValueError, match="net"):
                pkg_faults.FaultPlan(site=site, kind=kind)


def test_corruption_kinds_count_only_corruption_calls(tmp_path):
    """``at=N`` counts the calls that can fire the kind: a bitrot plan at
    data.write skips the write checkpoint and damages the 2nd file."""
    def run(pkg, root):
        os.makedirs(root)
        faults = _m(pkg, "io.faults")
        plan = faults.FaultPlan(site="data.write", kind="bitrot", at=2)
        faults.install(plan)
        paths = []
        try:
            for i in range(3):
                p = os.path.join(str(root), f"f{i}")
                with open(p, "wb") as f:
                    f.write(bytes(range(64)))
                faults.check("data.write")
                faults.corrupt_file("data.write", p)
                paths.append(p)
        finally:
            faults.clear()
        out = []
        for p in paths:
            with open(p, "rb") as f:
                out.append(hashlib.sha256(f.read()).hexdigest())
        return out + [plan._calls, plan._fired]

    out = _both(run, tmp_path)
    assert out[0] == out[2] != out[1] and out[3:] == [3, 1]


def test_install_from_conf_arms_the_session(tmp_path):
    conf = TORCH.HyperspaceConf()
    conf.fault_injection_enabled = True
    conf.fault_injection_site = "io.list"
    conf.fault_injection_kind = "eio"
    conf.fault_injection_at = 2
    conf.fault_injection_count = 3
    TORCH.HyperspaceSession(str(tmp_path / "ix"), device="cpu", conf=conf)
    plan = _m(TORCH, "io.faults").active()
    assert (plan.site, plan.kind, plan.at, plan.count) == ("io.list", "eio",
                                                           2, 3)
    assert _m(JAX, "io.faults").active() is None


def test_store_sites(tmp_path):
    """``store.put`` torn commits half the payload with a real generation;
    ``store.read``, ``store.list`` and ``store.delete`` raise the armed
    error; both packages' POSIX stores leave the same bytes."""
    def run(pkg, root):
        store = _m(pkg, "io.log_store").PosixLogStore(str(root))
        faults = _m(pkg, "io.faults")
        out = [store.put_if_absent("a", b"0123456789")]
        faults.install(faults.FaultPlan(site="store.put", kind="torn"))
        out.append(type(_raised(lambda: store.put_if_generation_match(
            "a", b"abcdefghij", 1))).__name__)
        faults.clear()
        out.append(store.read_with_generation("a"))
        for site, call in (("store.read", lambda: store.read("a")),
                           ("store.list", store.list_keys),
                           ("store.delete", lambda: store.delete("a")),
                           ("store.put", lambda: store.put_if_absent(
                               "b", b"x"))):
            faults.install(faults.FaultPlan(site=site, kind="eio"))
            out.append((site, type(_raised(call)).__name__))
            faults.clear()
        return out + [store.list_keys(), store.generation("a")]

    out = _both(run, tmp_path)
    assert out[1] == "InjectedCrash" and out[2] == (b"abcde", 2)
    assert out[-2:] == [["a"], 2]


def test_retry_jitter_takes_an_explicit_rng():
    retry = _m(TORCH, "utils.retry")
    policy = retry.RetryPolicy(max_attempts=4, initial_backoff_ms=8,
                               max_backoff_ms=20)
    a = [policy.delay_s(i, random.Random(7)) for i in range(4)]
    b = [policy.delay_s(i, random.Random(7)) for i in range(4)]
    jax_policy = _m(JAX, "utils.retry").RetryPolicy(
        max_attempts=4, initial_backoff_ms=8, max_backoff_ms=20)
    assert a == b == [jax_policy.delay_s(i, random.Random(7))
                      for i in range(4)]
    assert all(0.004 <= d < 0.020 for d in a)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(errno.EAGAIN, "again")
        return "ok"

    assert policy.call(flaky, rng=random.Random(1)) == "ok"
    assert len(calls) == 3
    assert not retry.is_transient(FileExistsError(errno.EEXIST, "x"))
    assert retry.is_transient(OSError(errno.ENOSPC, "x"))
    assert not retry.is_transient(RuntimeError("CUDA error"))


def test_an_absorbed_retry_is_in_the_run_report(tmp_path):
    """A data.read eio at query time is retried, and the query's run
    report holds the ``io.retry`` decision, as the JAX package's does."""
    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(50, dtype=np.int64)),
                             "v": pa.array(np.arange(50) * 1.0)}),
                   os.path.join(d, "p.parquet"))
    got = []
    for pkg in PKGS:
        s = _session_of(pkg, str(tmp_path / pkg.__name__), "r") \
            if pkg is JAX else TORCH.HyperspaceSession(
                str(tmp_path / "torch"), device="cpu")
        ds = s.read.parquet(d).filter(pkg.col("k") == 7).select("k", "v")
        faults = _arm(pkg, site="data.read", kind="eio")
        try:
            rows = ds.collect().to_pylist()
        finally:
            faults.clear()
        retries = [{k: v for k, v in r.items()}
                   for r in ds.last_run_report().decisions
                   if r["kind"] == "io.retry"]
        got.append((rows, retries))
    assert got[1] == got[0]
    assert got[0][1] == [{"kind": "io.retry", "attempt": 1,
                          "error": "OSError: [Errno 5] injected: "
                                   "input/output error"}]


def test_a_kernel_loader_error_is_no_os_error(monkeypatch):
    """The loader's OSError (no nvcc, a library that does not load)
    becomes a ``KernelError``, which no read-error fallback takes."""
    kernels = _m(TORCH, "ops.kernels")
    containment = _m(TORCH, "execution.containment")

    def broken():
        raise FileNotFoundError(errno.ENOENT, "nvcc")

    monkeypatch.setattr(kernels, "_build_kernels", broken)
    err = _raised(kernels.build_kernels)
    assert isinstance(err, kernels.KernelError)
    assert isinstance(err, RuntimeError) and not isinstance(err, OSError)
    assert not containment.is_read_error(err)
    assert not containment.is_index_side_error(err)


def test_the_call_counter_is_exact_across_threads():
    """The spill build reaches a site from several threads at once: ``at``
    and ``count`` hold exactly."""
    import threading

    faults = _m(TORCH, "io.faults")
    plan = faults.FaultPlan(site="data.write", kind="eio", at=50, count=10)
    faults.install(plan)
    fired = []
    lock = threading.Lock()

    def worker():
        for _ in range(25):
            try:
                faults.check("data.write")
            except OSError:
                with lock:
                    fired.append(1)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (plan._calls, plan._fired, len(fired)) == (200, 10, 10)


def test_quiet_sections_neither_fire_nor_count():
    faults = _m(TORCH, "io.faults")
    plan = faults.FaultPlan(site="io.list", kind="eio", at=2)
    faults.install(plan)
    faults.check("io.list")
    with faults.quiet():
        for _ in range(3):
            faults.check("io.list")
    assert plan._calls == 1
    with pytest.raises(OSError):
        faults.check("io.list")


def test_the_listing_cache_serves_within_its_ttl(tmp_path):
    """``get_indexes`` serves from the session's cache for
    ``cache_expiry_seconds``; every lifecycle verb clears it; both
    packages alike."""
    d = str(tmp_path / "data")
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(40, dtype=np.int64))}),
                   os.path.join(d, "p.parquet"))
    got = []
    for pkg in PKGS:
        root = str(tmp_path / pkg.__name__)
        s = JAX.HyperspaceSession(system_path=root) if pkg is JAX else \
            TORCH.HyperspaceSession(system_path=root, device="cpu")
        s.conf.num_buckets = 2
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(d), pkg.IndexConfig("a", ["k"], []))
        mgr = s.index_collection_manager
        seen = [[e.name for e in mgr.get_indexes()]]
        # A second session adds an index: the first one's cache still
        # serves its listing until the TTL or one of its own verbs.
        other = JAX.HyperspaceSession(system_path=root) if pkg is JAX else \
            TORCH.HyperspaceSession(system_path=root, device="cpu")
        other.conf.num_buckets = 2
        pkg.Hyperspace(other).create_index(other.read.parquet(d),
                                           pkg.IndexConfig("b", ["k"], []))
        seen.append([e.name for e in mgr.get_indexes()])
        hs.delete_index("a")
        seen.append([(e.name, e.state) for e in mgr.get_indexes()])
        s.conf.cache_expiry_seconds = 0
        pkg.Hyperspace(other).delete_index("b")
        time.sleep(0.01)
        seen.append([(e.name, e.state) for e in mgr.get_indexes()])
        got.append(seen)
    assert got[1] == got[0] == [
        ["a"], ["a"], [("a", "DELETED"), ("b", "ACTIVE")],
        [("a", "DELETED"), ("b", "DELETED")]]


def chip_smoke_at_small_size(monkeypatch, tmp_path):
    """chip_smoke with its data cut to 80,000 lineitem rows in 8 files, its
    default batch the conf's, and phase C's and D's tables written: (the
    module, orders, lineitem, the root).  Phases N and O then run on the
    CPU, where the kernels' plain versions count no launch."""
    import chip_smoke

    conf_batch = TORCH.HyperspaceConf().device_batch_rows
    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("DEFAULT_BATCH_ROWS", conf_batch),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0)):
        monkeypatch.setattr(chip_smoke, name, value)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    return chip_smoke, orders, li, root


def test_phase_n_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase N end to end at a small size: every fault step
    with its outcome, the recovered bytes equal to the clean build's,
    the retried query, the degraded query and the card-side error (an
    allocation the CPU refuses) inside a rule."""
    import torch

    chip_smoke, orders, li, root = chip_smoke_at_small_size(monkeypatch,
                                                            tmp_path)
    out = chip_smoke.phase_n(orders, li, root, torch.device("cpu"))
    outcomes = {s["step"]: s["outcome"] for s in out["steps"]}
    assert outcomes["data.write torn"] == "InjectedCrash"
    assert outcomes["data.write eio"] == "OSError"
    assert outcomes["action.commit crash"] == "InjectedCrash"
    assert outcomes["recovered refresh"] == "ok"
    assert out["degraded"]["skipped"] == ["n_deg"]
    assert out["queries"]["q3"]["retry"]["kind"] == "io.retry"
    assert not any(out["launches"].values())
    assert _m(TORCH, "io.faults").active() is None
