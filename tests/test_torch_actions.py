"""The port's action state machine, held to the JAX package's
tests/test_actions.py (transitions, validation, cancel recovery, action
events and the conf-selected event logger) and to
tests/test_concurrency.py's ``TestConflictRetry`` (the optimistic
transaction loop).  Two writers race through the manager in both
packages: the loser rebases and commits, with the JAX package's log ids,
and the maintenance daemon's refresh that races a refresh by hand ends
in "done" or a journaled "noop", as in the JAX package."""

from __future__ import annotations

import importlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch.actions.cancel import CancelAction
from hyperspace_tpu_torch.actions.delete import DeleteAction
from hyperspace_tpu_torch.actions.restore import RestoreAction
from hyperspace_tpu_torch.actions.vacuum import VacuumAction
from hyperspace_tpu_torch.exceptions import ConcurrentWriteError, HyperspaceError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.telemetry.events import (
    CollectingEventLogger,
    set_event_logger,
)
from tests.utils import sample_entry

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


@pytest.fixture(autouse=True)
def _reset_loggers():
    yield
    for pkg in (JAX, TORCH):
        _m(pkg, "telemetry.events").set_event_logger(None)


def _entry(state):
    return IndexLogEntry.from_dict(sample_entry(state=state).to_dict())


@pytest.fixture()
def active_index(tmp_index_root):
    """An index committed as ACTIVE at log id 2 (the layout after a
    create)."""
    path = os.path.join(tmp_index_root, "idx")
    mgr = IndexLogManager(path)
    mgr.write_log(1, _entry(States.CREATING))
    mgr.write_log(2, _entry(States.ACTIVE))
    mgr.create_latest_stable_log(2)
    return path, mgr


def test_delete_then_restore(active_index):
    path, mgr = active_index
    DeleteAction(mgr).run()
    assert mgr.get_latest_log().state == States.DELETED
    assert mgr.get_latest_log().id == 4
    assert mgr.get_latest_stable_log().state == States.DELETED
    RestoreAction(mgr).run()
    assert mgr.get_latest_log().state == States.ACTIVE
    assert mgr.get_latest_stable_log().id == 6


def test_delete_requires_active(active_index):
    path, mgr = active_index
    DeleteAction(mgr).run()
    with pytest.raises(HyperspaceError):
        DeleteAction(mgr).run()


def test_restore_requires_deleted(active_index):
    _, mgr = active_index
    with pytest.raises(HyperspaceError):
        RestoreAction(mgr).run()


def test_vacuum_removes_data(active_index):
    path, mgr = active_index
    dm = IndexDataManager(path)
    os.makedirs(dm.version_path(0))
    os.makedirs(dm.version_path(1))
    with pytest.raises(HyperspaceError):
        VacuumAction(mgr, dm).run()
    DeleteAction(mgr).run()
    VacuumAction(mgr, dm).run()
    assert dm.versions() == []
    assert mgr.get_latest_log().state == States.DOESNOTEXIST


def test_cancel_rolls_back_to_stable(active_index):
    path, mgr = active_index
    mgr.write_log(3, _entry(States.REFRESHING))
    with pytest.raises(HyperspaceError):
        DeleteAction(mgr).run()
    CancelAction(mgr).run()
    latest = mgr.get_latest_log()
    assert latest.state == States.ACTIVE
    assert latest.id == 4
    DeleteAction(mgr).run()
    assert mgr.get_latest_log().state == States.DELETED


def test_cancel_vacuuming_goes_to_doesnotexist(active_index):
    path, mgr = active_index
    mgr.write_log(3, _entry(States.VACUUMING))
    CancelAction(mgr).run()
    assert mgr.get_latest_log().state == States.DOESNOTEXIST


def test_cancel_rejects_stable(active_index):
    _, mgr = active_index
    with pytest.raises(HyperspaceError):
        CancelAction(mgr).run()


def test_action_events_emitted(active_index):
    _, mgr = active_index
    logger = CollectingEventLogger()
    set_event_logger(logger)
    try:
        DeleteAction(mgr).run()
    finally:
        set_event_logger(None)
    kinds = [e.kind for e in logger.events]
    assert "DeleteActionEvent" in kinds
    assert logger.events[-1].state == States.DELETED


def test_failed_action_emits_failure(active_index):
    _, mgr = active_index
    logger = CollectingEventLogger()
    set_event_logger(logger)
    try:
        with pytest.raises(HyperspaceError):
            RestoreAction(mgr).run()
    finally:
        set_event_logger(None)
    # A validation error is raised before any state is written: the
    # loop emits nothing for it, as in the JAX package.
    assert logger.events == []


class TestConfEventLogger:
    def test_conf_selected_logger_receives_events(self, tmp_path):
        from hyperspace_tpu_torch import (
            Hyperspace,
            HyperspaceConf,
            HyperspaceSession,
            IndexConfig,
        )
        from hyperspace_tpu_torch.telemetry.events import get_event_logger
        from tests.utils import write_sample_parquet

        set_event_logger(None)
        conf = HyperspaceConf()
        conf.event_logger = "CollectingEventLogger"
        s = HyperspaceSession(system_path=str(tmp_path / "ix"), conf=conf,
                              device="cpu")
        logger = get_event_logger()
        assert type(logger).__name__ == "CollectingEventLogger"
        data = str(tmp_path / "data")
        write_sample_parquet(data, n_files=1)
        s.conf.num_buckets = 2
        Hyperspace(s).create_index(s.read.parquet(data),
                                   IndexConfig("i", ["id"], ["name"]))
        assert "CreateActionEvent" in [e.kind for e in logger.events]

    def test_explicit_noop_beats_conf(self, tmp_path):
        from hyperspace_tpu_torch import HyperspaceConf, HyperspaceSession
        from hyperspace_tpu_torch.telemetry.events import (
            NoOpEventLogger,
            get_event_logger,
        )

        set_event_logger(None)
        explicit = NoOpEventLogger()
        set_event_logger(explicit)
        conf = HyperspaceConf()
        conf.event_logger = "CollectingEventLogger"
        HyperspaceSession(system_path=str(tmp_path / "ix"), conf=conf,
                          device="cpu")
        assert get_event_logger() is explicit

    def test_dotted_path_and_unknown_name(self):
        from hyperspace_tpu_torch.telemetry.events import resolve_event_logger

        logger = resolve_event_logger(
            "hyperspace_tpu_torch.telemetry.events.CollectingEventLogger")
        assert type(logger).__name__ == "CollectingEventLogger"
        with pytest.raises(ValueError, match="Unknown event logger"):
            resolve_event_logger("nope")

    def test_reflection_refuses_a_class_of_another_base(self):
        from hyperspace_tpu_torch.telemetry.events import EventLogger
        from hyperspace_tpu_torch.utils.reflection import load_class

        with pytest.raises(ValueError, match="is not a EventLogger"):
            load_class("hyperspace_tpu_torch.config:HyperspaceConf",
                       EventLogger)
        with pytest.raises(ValueError, match="Invalid class path"):
            load_class("NoModule", EventLogger)


# ---------------------------------------------------------------------------
# The optimistic transaction loop (tests/test_concurrency.py's
# TestConflictRetry)
# ---------------------------------------------------------------------------
def _add(d, name, lo, hi):
    os.makedirs(d, exist_ok=True)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(lo, hi, dtype=np.int64)),
        "v": pa.array(np.arange(lo, hi) * 1.0),
    }), os.path.join(d, name))


def _session(pkg, root, **conf):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, "ix"), **kw)
    s.conf.num_buckets = 2
    if pkg is TORCH:
        s.conf.device_build_min_rows = 0
    else:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _env(pkg, root):
    d = os.path.join(root, "data")
    _add(d, "p.parquet", 0, 100)
    s = _session(pkg, root)
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(d), pkg.IndexConfig("rr", ["k"], ["v"]))
    return s, hs, d


class TestConflictRetry:
    def test_racing_refresh_retries_and_commits(self, tmp_path):
        from hyperspace_tpu_torch import col
        from hyperspace_tpu_torch.actions.refresh import (
            RefreshIncrementalAction,
        )

        s, hs, d = _env(TORCH, str(tmp_path))
        api = s.index_collection_manager
        _add(d, "p2.parquet", 100, 150)
        r2 = RefreshIncrementalAction(api._log_manager("rr"),
                                      api._data_manager("rr"), s)
        r2.concurrency_max_retries = 3
        hs.refresh_index("rr", mode="incremental")  # the winner
        _add(d, "p3.parquet", 150, 180)             # r2's own delta
        assert r2.run() == "ok"
        assert r2.conflict_retries == 1
        ids = api._log_manager("rr").log_ids()
        assert ids == list(range(1, len(ids) + 1)), ids
        entry = api.get_index("rr")
        assert entry is not None and entry.state == "ACTIVE"
        s.enable_hyperspace()
        for k, v in ((120, 120.0), (170, 170.0)):
            out = (s.read.parquet(d).filter(col("k") == k)
                   .select("k", "v").collect())
            assert out.column("v").to_pylist() == [v]
        assert any(x["is_index"] for x in s.last_execution_stats["scans"])

    def test_racing_refresh_with_no_own_delta_noops(self, tmp_path):
        from hyperspace_tpu_torch.actions.refresh import (
            RefreshIncrementalAction,
        )

        s, hs, d = _env(TORCH, str(tmp_path))
        api = s.index_collection_manager
        _add(d, "p2.parquet", 100, 150)
        r2 = RefreshIncrementalAction(api._log_manager("rr"),
                                      api._data_manager("rr"), s)
        r2.concurrency_max_retries = 3
        hs.refresh_index("rr", mode="incremental")
        before = api._log_manager("rr").log_ids()
        assert r2.run() == "noop"
        assert r2.conflict_retries == 1
        assert api._log_manager("rr").log_ids() == before

    def test_exhausted_retries_still_raise(self, tmp_path):
        from hyperspace_tpu_torch.actions.refresh import (
            RefreshIncrementalAction,
        )

        s, hs, d = _env(TORCH, str(tmp_path))
        api = s.index_collection_manager
        _add(d, "p2.parquet", 100, 150)
        r2 = RefreshIncrementalAction(api._log_manager("rr"),
                                      api._data_manager("rr"), s)
        assert r2.concurrency_max_retries == 0  # direct construction
        hs.refresh_index("rr", mode="incremental")
        _add(d, "p3.parquet", 150, 180)
        logger = CollectingEventLogger()
        set_event_logger(logger)
        with pytest.raises(ConcurrentWriteError):
            r2.run()
        assert [(e.state, e.message) for e in logger.events] == [
            ("FAILURE", "concurrent modification")]
        assert r2.build_report.outcome == "error"

    def test_dispatched_actions_inherit_conf_budget(self, tmp_path):
        import unittest.mock as mock

        from hyperspace_tpu_torch.index.manager import IndexCollectionManager

        s, hs, d = _env(TORCH, str(tmp_path))
        s.conf.concurrency_max_retries = 7
        captured = {}
        real_dispatch = IndexCollectionManager._dispatch

        def spy(self, action):
            real_dispatch(self, action)
            captured["retries"] = action.concurrency_max_retries
            captured["backoff"] = action.conflict_backoff

        with mock.patch.object(IndexCollectionManager, "_dispatch", spy):
            hs.delete_index("rr")
        assert captured["retries"] == 7
        assert captured["backoff"].initial_backoff_ms == \
            s.conf.io_retry_initial_backoff_ms


def _race_through_the_manager(pkg, root, own_delta: bool,
                              through_daemon: bool = False):
    """A refresh dispatched through the manager (or the maintenance
    daemon) whose ``begin()`` first lets a second writer commit a refresh
    of the same index by hand: the dispatched one meets a write conflict
    and rebases.  Returns the log ids, the CONFLICT_RETRY events, the
    outcome and the index's row count."""
    s, hs, d = _env(pkg, root)
    s.conf.io_retry_initial_backoff_ms = 0.1
    s.conf.io_retry_max_backoff_ms = 0.2
    _add(d, "p2.parquet", 100, 150)
    other_session = _session(pkg, root)
    refresh_mod = _m(pkg, "actions.refresh")
    if own_delta:
        # An action lists its source at its first validation and keeps
        # that listing across retries: the other writer lists before p3
        # lands, the dispatched refresh after, so p3 is its own delta.
        api = other_session.index_collection_manager
        other_action = refresh_mod.RefreshIncrementalAction(
            api._log_manager("rr"), api._data_manager("rr"), other_session)
        other_action.validate()
        _add(d, "p3.parquet", 150, 180)
        other = other_action.run
    else:
        other = lambda: pkg.Hyperspace(other_session).refresh_index(  # noqa: E731
            "rr", "incremental")
    base = refresh_mod.RefreshActionBase
    real_begin = base.begin
    raced = {"done": False}

    def racing_begin(self):
        if not raced["done"]:
            raced["done"] = True
            other()  # the other writer commits first
        return real_begin(self)

    events = _m(pkg, "telemetry.events")
    logger = events.CollectingEventLogger()
    events.set_event_logger(logger)
    base.begin = racing_begin
    try:
        if through_daemon:
            s.conf.hybrid_scan_enabled = False
            records = hs.maintenance_cycle()
            outcome = [(r["decision"], r["outcome"]) for r in records]
        else:
            outcome = hs.refresh_index("rr", "incremental").outcome
    finally:
        base.begin = real_begin
        events.set_event_logger(None)
    mgr = s.index_collection_manager._log_manager("rr")
    retries = [(type(e).__name__, e.state) for e in logger.events
               if e.state.startswith("CONFLICT_RETRY")]
    report = hs.last_build_report()
    entry = s.index_collection_manager.get_index("rr")
    rows = sum(int(pq.read_metadata(f.name).num_rows)
               for f in entry.content.file_infos())
    return {"ids": mgr.log_ids(), "retries": retries, "outcome": outcome,
            "rows": rows, "state": entry.state,
            "conflict_retries": report.conflict_retries}


@pytest.mark.parametrize("own_delta", [True, False],
                         ids=["own-delta", "no-own-delta"])
def test_two_writers_through_the_manager(tmp_path, own_delta):
    got = {pkg: _race_through_the_manager(
        pkg, str(tmp_path / pkg.__name__), own_delta) for pkg in (JAX, TORCH)}
    jax_run, torch_run = got[JAX], got[TORCH]
    assert torch_run["conflict_retries"] >= 1
    assert torch_run["retries"] == [("RefreshActionEvent", "CONFLICT_RETRY 1/3")]
    assert torch_run == jax_run
    assert torch_run["outcome"] == ("ok" if own_delta else "noop")
    assert torch_run["rows"] == (180 if own_delta else 150)
    ids = torch_run["ids"]
    assert ids == list(range(1, len(ids) + 1))


def test_daemon_refresh_racing_a_refresh_by_hand(tmp_path):
    """The daemon's refresh meets a refresh run by hand: it rebases and
    ends in a journaled "noop" (the winner did the work), as in the JAX
    package, with no backoff."""
    got = {pkg: _race_through_the_manager(
        pkg, str(tmp_path / pkg.__name__), False, through_daemon=True)
        for pkg in (JAX, TORCH)}
    torch_run = got[TORCH]
    assert torch_run["outcome"] == [("refresh", "noop")]
    assert torch_run["retries"] == [("RefreshActionEvent", "CONFLICT_RETRY 1/3")]
    assert torch_run == got[JAX]
