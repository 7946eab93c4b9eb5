"""The source watch through hyperspace_tpu_torch (on the CPU): the
change directory, the poll, inotify and store backends, the notification
bus's torn marker, fault quietness and cap, and the daemon's wake, which
bounds staleness below the cycle interval.

The watch cases of tests/test_cdc.py (``TestWatchSeam``,
``TestDaemonWatchWake``) on the port, each held to what it asserts, over
the default store (``EmulatedObjectStore``) and, in ``TestWatchSeamPosix``,
over ``PosixLogStore``.  The bus's layout is the JAX package's, so a
marker one package publishes wakes the other's watcher when both name
the same store class.
"""

from __future__ import annotations

import os
import time

import pyarrow.parquet as pq
import pytest

from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
from hyperspace_tpu_torch.io import watch
from hyperspace_tpu_torch.lifecycle import journal as lifecycle_journal
from hyperspace_tpu_torch.lifecycle.daemon import daemon_for
from tests.test_cdc import _table


def _session(tmp_path, store="", **conf):
    """A port session; ``store`` pins a class of io/log_store.py, ""
    keeps the default."""
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    if store:
        s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
    s.conf.num_buckets = 4
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _wait_wake(watcher, timeout_s: float = 8.0) -> float:
    t0 = time.monotonic()
    assert watcher.wake.wait(timeout_s), \
        f"no wake within {timeout_s}s (mode={watcher.mode})"
    return time.monotonic() - t0


class TestWatchSeam:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def test_change_dir_finds_the_commit_log(self, tmp_path):
        plain = tmp_path / "plain"
        plain.mkdir()
        assert watch.change_dir(str(plain)) == str(plain)
        delta = tmp_path / "delta"
        (delta / "_delta_log").mkdir(parents=True)
        assert watch.change_dir(str(delta)) == str(delta / "_delta_log")
        ice = tmp_path / "ice"
        (ice / "metadata").mkdir(parents=True)
        assert watch.change_dir(str(ice)) == str(ice / "metadata")

    def test_poll_backend_wakes_on_write(self, tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        s = _session(tmp_path, self.store, watch_poll_interval_s=0.05,
                     watch_debounce_ms=10.0)
        w = watch.SourceWatcher(s.conf, [str(src)], mode="poll").start()
        try:
            assert w.mode == "poll"
            pq.write_table(_table([1]), str(src / "a.parquet"))
            _wait_wake(w)
            events = w.drain()
            assert events and events[0].root == str(src)
        finally:
            w.stop()

    def test_inotify_mode_detects_or_degrades(self, tmp_path):
        """Forced inotify works on Linux; where the kernel refuses it,
        the watcher degrades to poll (never raises) and still detects."""
        src = tmp_path / "src"
        src.mkdir()
        s = _session(tmp_path, self.store, watch_poll_interval_s=0.05,
                     watch_debounce_ms=10.0)
        w = watch.SourceWatcher(s.conf, [str(src)], mode="inotify").start()
        try:
            assert w.mode in ("inotify", "poll")
            pq.write_table(_table([1]), str(src / "a.parquet"))
            _wait_wake(w)
        finally:
            w.stop()

    def test_auto_resolves_to_inotify_or_store(self, tmp_path):
        """``auto`` takes inotify when the kernel offers it, else the
        store bus; a watched root that does not exist leaves inotify
        out, and the watcher runs on the store."""
        src = tmp_path / "src"
        src.mkdir()
        s = _session(tmp_path, self.store)
        w = watch.SourceWatcher(s.conf, [str(src)])
        assert w.mode in ("inotify", "store")
        w.stop()
        gone = watch.SourceWatcher(s.conf, [str(tmp_path / "missing")])
        assert gone.mode == "store"
        gone.stop()

    def test_store_bus_publish_wakes_watcher(self, tmp_path):
        """A publish after a commit puts a marker on the bus; a store-mode
        watcher made before it wakes on it."""
        src = tmp_path / "src"
        src.mkdir()
        s = _session(tmp_path, self.store, watch_poll_interval_s=0.05,
                     watch_debounce_ms=10.0)
        w = watch.SourceWatcher(s.conf, [str(src)], mode="store").start()
        try:
            assert w.mode == "store"
            key = watch.publish(s.conf, str(src), detail="commit 7")
            assert key is not None
            _wait_wake(w)
            events = w.drain()
            assert any(e.root == str(src) and "commit 7" in e.detail
                       for e in events), events
        finally:
            w.stop()

    def test_a_jax_marker_wakes_the_port(self, tmp_path):
        """The JAX package's ``publish`` (on the same store class) lands
        a marker the port's store watcher reads."""
        from hyperspace_tpu import HyperspaceSession as JaxSession
        from hyperspace_tpu.io import watch as jax_watch

        src = tmp_path / "src"
        src.mkdir()
        s = _session(tmp_path, self.store, watch_poll_interval_s=0.05,
                     watch_debounce_ms=10.0)
        w = watch.SourceWatcher(s.conf, [str(src)], mode="store").start()
        try:
            js = JaxSession(system_path=str(tmp_path / "ix"))
            if self.store:  # else both keep their default store
                js.conf.log_store_class = \
                    f"hyperspace_tpu.io.log_store.{self.store}"
            assert jax_watch.publish(js.conf, str(src), detail="jax 3")
            _wait_wake(w)
            assert any("jax 3" in e.detail for e in w.drain())
        finally:
            w.stop()

    def test_torn_marker_still_wakes(self, tmp_path):
        s = _session(tmp_path, self.store, watch_poll_interval_s=0.05,
                     watch_debounce_ms=0.0)
        w = watch.SourceWatcher(s.conf, [], mode="store").start()
        try:
            store = watch._store(s.conf)
            assert store.put_if_absent("w-torn", b"{not json")
            _wait_wake(w)
        finally:
            w.stop()

    def test_publish_is_fault_quiet(self, tmp_path):
        from hyperspace_tpu_torch.io import faults

        s = _session(tmp_path, self.store)
        plan = faults.FaultPlan(site="store.put", kind="eio", at=1, count=1)
        faults.install(plan)
        try:
            assert watch.publish(s.conf, str(tmp_path)) is not None
            assert plan._calls == 0
        finally:
            faults.clear()

    def test_marker_cap_bounds_the_bus(self, tmp_path):
        s = _session(tmp_path, self.store)
        for i in range(watch._MARKER_CAP + 10):
            assert watch.publish(s.conf, str(tmp_path), detail=str(i))
        store = watch._store(s.conf)
        assert len(store.list_keys()) <= watch._MARKER_CAP

    def test_a_marker_under_a_listing_window_wakes_once_it_lists(
            self, tmp_path):
        """Under an object store's listing window a marker is hidden
        from the watcher's listing; it wakes the watcher once the window
        has passed, and only once."""
        src = tmp_path / "src"
        src.mkdir()
        s = _session(tmp_path, self.store, watch_poll_interval_s=0.05,
                     watch_debounce_ms=10.0, object_store_stale_list_ms=400.0)
        w = watch.SourceWatcher(s.conf, [str(src)], mode="store").start()
        try:
            t0 = time.monotonic()
            assert watch.publish(s.conf, str(src), detail="late")
            _wait_wake(w)
            waited = time.monotonic() - t0
            assert any("late" in e.detail for e in w.drain())
            # The posix store lists at once; the object store after the
            # window.
            assert (waited >= 0.4) == (self.store != "PosixLogStore")
            w.wake.clear()
            assert not w.wake.wait(0.3)
        finally:
            w.stop()


class TestWatchSeamPosix(TestWatchSeam):
    store = "PosixLogStore"


class TestDaemonWatchWake:
    @pytest.mark.parametrize("mode", ["poll", "auto"])
    def test_event_bounds_staleness_below_the_poll_interval(self, tmp_path,
                                                            mode):
        """With a 30 s cycle interval and the watch on, an append is
        refreshed within seconds: the wake, not the interval, bounds
        staleness."""
        src = str(tmp_path / "src")
        os.makedirs(src)
        pq.write_table(_table(range(100)), os.path.join(src, "p0.parquet"))
        s = _session(tmp_path, lineage_enabled=True,
                     lifecycle_enabled=True, lifecycle_interval_s=30.0,
                     watch_enabled=True, watch_mode=mode,
                     watch_poll_interval_s=0.05, watch_debounce_ms=10.0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(src), IndexConfig("wix", ["id"],
                                                         ["v"]))
        hs.start_maintenance()
        try:
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:  # the first cycle ran
                if lifecycle_journal.records(s.conf):
                    break
                time.sleep(0.05)
            else:
                pytest.fail("daemon never completed its first cycle")
            watcher = daemon_for(s).watcher()
            assert watcher is not None
            assert watcher.mode == ("poll" if mode == "poll"
                                    else watcher.mode)
            assert watcher.mode in ("poll", "inotify", "store")
            t0 = time.monotonic()
            pq.write_table(_table(range(100, 120)),
                           os.path.join(src, "p1.parquet"))
            if watcher.mode == "store":
                watch.publish(s.conf, src, detail="p1")
            deadline = time.monotonic() + 15.0
            while time.monotonic() < deadline:
                recs = lifecycle_journal.records(s.conf)
                if any(r.get("decision") == "refresh"
                       and r.get("outcome") == "done" for r in recs):
                    break
                time.sleep(0.05)
            else:
                pytest.fail("append never refreshed")
            assert time.monotonic() - t0 < 15.0
        finally:
            hs.stop_maintenance()
        assert daemon_for(s).watcher() is None  # stopped with the thread
