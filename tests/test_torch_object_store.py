"""The object store and the pluggable log through hyperspace_tpu_torch (on
the CPU) against the JAX package.

Every case of tests/test_object_store.py runs through both packages with
the same inputs, and their observations must be equal: the store
contract on both store classes, the emulated store's semantics (flat
percent-encoded keys, the listing window), the fault matrix at
``store.put/read/list/delete``, ``ObjectStoreLogManager``'s protocol
(put-if-absent ids, the forward probe past a stale listing, torn entries,
the retry budget, the pointer's compare-and-swap and a storm of them),
the manager chosen through the conf (the port's conf field where the JAX
case sets its string key), and the data corruption matrix on both
quarantine store classes.

Beyond the oracle: stores that one package writes and the other reads
(file names, sidecars, generations); an index the JAX package builds
and refreshes on the object-store log, which the port lists, queries and
refreshes, and whose port-written entries the JAX package reads back;
quarantine and journal records under each package's default store; the
conf defaults; a listing window over the quarantine, the vacuum and the
repair; and two port processes racing for the ids of one log.
"""

from __future__ import annotations

import errno
import glob
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import threading
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from tests.utils import sample_entry

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
STORES = ("PosixLogStore", "EmulatedObjectStore")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _store_cls(pkg, name: str):
    return getattr(_m(pkg, "io.log_store"), name)


def _manager_path(pkg) -> str:
    return f"{pkg.__name__}.index.object_log_manager.ObjectStoreLogManager"


def _both(fn, tmp_path):
    """``fn(pkg, root)`` through both packages, each under its own root;
    their observations must be equal."""
    got = []
    for pkg in PKGS:
        faults = _m(pkg, "io.faults")
        try:
            got.append(fn(pkg, tmp_path / pkg.__name__))
        finally:
            faults.clear()
    assert got[1] == got[0]
    return got[1]


def _raised(fn):
    try:
        fn()
    except BaseException as e:  # noqa: BLE001 - InjectedCrash included
        return e
    return None


def _files(root) -> list:
    return sorted(os.listdir(root)) if os.path.isdir(root) else []


def _entry(pkg, state):
    e = sample_entry(state=state)
    e.timestamp = 1_700_000_000_000  # the same payload bytes in both
    if pkg is JAX:
        return e
    return _m(TORCH, "index.log_entry").IndexLogEntry.from_dict(e.to_dict())


def _obj_mgr(pkg, root, stale_list_s=0.0, attempts=3):
    mgr = _m(pkg, "index.object_log_manager").ObjectStoreLogManager(
        os.path.join(str(root), "idx"))
    mgr.retry = _m(pkg, "utils.retry").RetryPolicy(
        max_attempts=attempts, initial_backoff_ms=1)
    mgr.stale_list_s = stale_list_s
    return mgr


# ---------------------------------------------------------------------------
# The store contract, on both store classes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("store", STORES)
class TestLogStoreContract:
    def test_put_if_absent_exactly_once(self, tmp_path, store):
        def run(pkg, root):
            st = _store_cls(pkg, store)(str(root / "bucket"))
            return (st.put_if_absent("k", b"v1"), st.put_if_absent("k", b"v2"),
                    st.read("k"), st.generation("k"), _files(st.root))

        assert _both(run, tmp_path)[:4] == (True, False, b"v1", 1)

    def test_generation_cas(self, tmp_path, store):
        def run(pkg, root):
            st = _store_cls(pkg, store)(str(root / "bucket"))
            st.put_if_absent("k", b"v1")
            return (st.put_if_generation_match("k", b"v2", 1),
                    st.put_if_generation_match("k", b"v3", 1),
                    st.read_with_generation("k"))

        assert _both(run, tmp_path) == (True, False, (b"v2", 2))

    def test_delete_then_recreate(self, tmp_path, store):
        def run(pkg, root):
            st = _store_cls(pkg, store)(str(root / "bucket"))
            st.put_if_absent("k", b"v1")
            st.delete("k")
            return (st.generation("k"), st.read_with_generation("k"),
                    type(_raised(lambda: st.read("k"))).__name__,
                    st.put_if_absent("k", b"v2"), _files(st.root))

        assert _both(run, tmp_path)[:4] == (0, (None, 0),
                                            "FileNotFoundError", True)

    def test_list_keys_prefix(self, tmp_path, store):
        def run(pkg, root):
            st = _store_cls(pkg, store)(str(root / "bucket"))
            for k in ("1", "2", "latestStable"):
                st.put_if_absent(k, b"x")
            return st.list_keys(), st.list_keys(prefix="latest")

        assert _both(run, tmp_path) == (["1", "2", "latestStable"],
                                        ["latestStable"])

    def test_missing_key_reads(self, tmp_path, store):
        def run(pkg, root):
            st = _store_cls(pkg, store)(str(root / "bucket"))
            return st.generation("nope"), st.exists("nope"), st.list_keys()

        assert _both(run, tmp_path) == (0, False, [])

    def test_stores_read_each_other(self, tmp_path, store):
        """One root, written in turn by each package's store of the same
        class: the same file names, sidecars, generations and listing."""
        root = str(tmp_path / "shared")
        j, t = _store_cls(JAX, store)(root), _store_cls(TORCH, store)(root)
        # A posix key names a file: no "/" in it.
        key = "a/b%c" if store == "EmulatedObjectStore" else "a%2Fb"
        assert t.put_if_absent(key, b"one")
        assert not j.put_if_absent(key, b"two")
        assert j.put_if_generation_match(key, b"two", 1)
        assert t.read_with_generation(key) == (b"two", 2)
        assert not t.put_if_generation_match(key, b"x", 1)
        assert j.put_if_absent("latestStable", b"3")
        assert t.list_keys() == j.list_keys() == [key, "latestStable"]
        with open(os.path.join(root, "7"), "wb") as f:
            f.write(b"legacy")  # no sidecar: generation 1
        assert t.generation("7") == j.generation("7") == 1
        t.delete(key)
        assert j.read_with_generation(key) == (None, 0)
        names = _files(root)
        assert ".lock" in names and "latestStable.g" in names
        assert t._encode(key) == j._encode(key) == (
            "a%2Fb%25c" if store == "EmulatedObjectStore" else key)


# ---------------------------------------------------------------------------
# The emulated object store's semantics
# ---------------------------------------------------------------------------
class TestEmulatedObjectStoreSemantics:
    def test_flat_keys_with_slashes(self, tmp_path):
        def run(pkg, root):
            st = _store_cls(pkg, "EmulatedObjectStore")(str(root / "b"))
            assert st.put_if_absent("a/b/c", b"x")
            dirs = [n for n in os.listdir(st.root)
                    if os.path.isdir(os.path.join(st.root, n))]
            return st.read("a/b/c"), st.list_keys(), dirs, _files(st.root)

        out = _both(run, tmp_path)
        assert out[:3] == (b"x", ["a/b/c"], [])
        assert "a%2Fb%2Fc" in out[3]

    def test_stale_list_window_hides_recent_commits(self, tmp_path):
        def run(pkg, root):
            st = _store_cls(pkg, "EmulatedObjectStore")(
                str(root / "b"), stale_list_s=60.0)
            st.put_if_absent("7", b"x")
            return (st.list_keys(), st.exists("7"), st.read("7"),
                    st.put_if_absent("7", b"y"))

        assert _both(run, tmp_path) == ([], True, b"x", False)

    def test_the_window_passes(self, tmp_path):
        """A key is listed once the window has passed since its commit;
        the posix store ignores the window."""
        def run(pkg, root):
            st = _store_cls(pkg, "EmulatedObjectStore")(
                str(root / "b"), stale_list_s=0.2)
            posix = _store_cls(pkg, "PosixLogStore")(
                str(root / "p"), stale_list_s=60.0)
            st.put_if_absent("7", b"x")
            posix.put_if_absent("7", b"x")
            hidden = st.list_keys()
            import time
            time.sleep(0.25)
            return hidden, st.list_keys(), posix.list_keys(), \
                posix.stale_list_s

        assert _both(run, tmp_path) == ([], ["7"], ["7"], 0.0)

    def test_cross_thread_cas_single_winner(self, tmp_path):
        def run(pkg, root):
            st = _store_cls(pkg, "EmulatedObjectStore")(str(root / "b"))
            st.put_if_absent("k", b"v0")
            wins = []
            barrier = threading.Barrier(8)

            def racer(i):
                barrier.wait()
                if st.put_if_generation_match("k", b"w%d" % i, 1):
                    wins.append(i)

            threads = [threading.Thread(target=racer, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return len(wins), st.read("k") == b"w%d" % wins[0], \
                st.generation("k")

        assert _both(run, tmp_path) == (1, True, 2)

    def test_cross_package_cas_single_winner(self, tmp_path):
        """Threads of both packages race one key of one root: exactly one
        swap wins (the flock arbitrates across the two stores)."""
        root = str(tmp_path / "b")
        stores = [_store_cls(pkg, "EmulatedObjectStore")(root)
                  for pkg in PKGS]
        stores[0].put_if_absent("k", b"v0")
        wins = []
        barrier = threading.Barrier(8)

        def racer(i):
            barrier.wait()
            if stores[i % 2].put_if_generation_match("k", b"w%d" % i, 1):
                wins.append(i)

        threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(wins) == 1
        assert stores[1].read("k") == stores[0].read("k") == b"w%d" % wins[0]


# ---------------------------------------------------------------------------
# The fault matrix at the store's sites
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("store", STORES)
class TestStoreFaultMatrix:
    @pytest.mark.parametrize("kind", ["eio", "enospc"])
    def test_transient_put_is_not_committed(self, tmp_path, store, kind):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            st = _store_cls(pkg, store)(str(root / "bucket"))
            faults.install(faults.FaultPlan(site="store.put", kind=kind))
            err = _raised(lambda: st.put_if_absent("k", b"v"))
            faults.clear()
            return (isinstance(err, OSError), st.generation("k"),
                    st.put_if_absent("k", b"v"))

        assert _both(run, tmp_path) == (True, 0, True)

    def test_torn_put_commits_partial_with_generation(self, tmp_path, store):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            st = _store_cls(pkg, store)(str(root / "bucket"))
            faults.install(faults.FaultPlan(site="store.put", kind="torn"))
            err = _raised(lambda: st.put_if_absent("k", b"0123456789"))
            faults.clear()
            return (type(err).__name__, st.read_with_generation("k"),
                    st.put_if_absent("k", b"again"))

        assert _both(run, tmp_path) == ("InjectedCrash", (b"01234", 1), False)

    def test_read_and_list_faults_fire(self, tmp_path, store):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            st = _store_cls(pkg, store)(str(root / "bucket"))
            st.put_if_absent("k", b"v")
            out = []
            for site, call in (("store.read", lambda: st.read("k")),
                               ("store.list", st.list_keys),
                               ("store.delete", lambda: st.delete("k"))):
                faults.install(faults.FaultPlan(site=site, kind="eio"))
                err = _raised(call)
                faults.clear()
                out.append((site, isinstance(err, OSError),
                            getattr(err, "errno", None)))
            return out, st.read("k")

        out, data = _both(run, tmp_path)
        assert data == b"v"
        assert [o[1:] for o in out] == [(True, errno.EIO)] * 3


# ---------------------------------------------------------------------------
# ObjectStoreLogManager
# ---------------------------------------------------------------------------
def _states(pkg, mgr):
    return [(i, None if e is None else e.state)
            for i, e in ((i, mgr.get_log(i)) for i in mgr.log_ids())]


class TestObjectStoreLogManager:
    def test_protocol_parity_with_posix_manager(self, tmp_path):
        def run(pkg, root):
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            out = [mgr.get_latest_id(),
                   mgr.write_log(1, _entry(pkg, S.CREATING)),
                   mgr.write_log(1, _entry(pkg, S.CREATING)),
                   mgr.write_log(2, _entry(pkg, S.ACTIVE)),
                   mgr.create_latest_stable_log(2),
                   mgr.get_latest_stable_log().state]
            mgr.write_log(3, _entry(pkg, S.REFRESHING))
            out += [mgr.get_latest_stable_log().id, mgr.log_ids(),
                    _files(mgr.store.root),
                    mgr.store.read("2"), mgr.store.read("latestStable")]
            return out

        out = _both(run, tmp_path)
        assert out[:8] == [None, True, False, True, True, "ACTIVE", 2,
                           [1, 2, 3]]
        assert out[9] == out[10]  # the pointer is a copy of entry 2

    def test_stale_listing_never_hides_ids_from_writers(self, tmp_path):
        def run(pkg, root):
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root, stale_list_s=60.0)
            wrote = [mgr.write_log(i, _entry(pkg, S.CREATING))
                     for i in (1, 2, 3)]
            return (wrote, mgr.store.list_keys(), mgr.get_latest_id(),
                    mgr.log_ids(), mgr.write_log(3, _entry(pkg, S.ACTIVE)))

        assert _both(run, tmp_path) == ([True] * 3, [], 3, [1, 2, 3], False)

    def test_probe_past_an_empty_hint_tries_zero_then_one(self, tmp_path):
        """An action never writes id 0, so an empty listing probes 0 and
        then 1; a log that starts at 0 is found too."""
        def run(pkg, root):
            S = _m(pkg, "index.log_entry").States
            a = _obj_mgr(pkg, root / "a", stale_list_s=60.0)
            b = _obj_mgr(pkg, root / "b", stale_list_s=60.0)
            a.write_log(1, _entry(pkg, S.CREATING))
            b.write_log(0, _entry(pkg, S.CREATING))
            b.write_log(1, _entry(pkg, S.ACTIVE))
            return a.get_latest_id(), a.log_ids(), b.get_latest_id(), \
                b.log_ids()

        assert _both(run, tmp_path) == (1, [1], 1, [0, 1])

    def test_torn_entry_burned_and_skipped(self, tmp_path):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            mgr.write_log(1, _entry(pkg, S.CREATING))
            mgr.write_log(2, _entry(pkg, S.ACTIVE))
            mgr.create_latest_stable_log(2)
            faults.install(faults.FaultPlan(site="store.put", kind="torn"))
            err = _raised(lambda: mgr.write_log(3, _entry(pkg, S.REFRESHING)))
            faults.clear()
            return (type(err).__name__, mgr.get_latest_id(), mgr.get_log(3),
                    mgr.get_latest_log().id, mgr.get_latest_stable_log().id,
                    mgr.write_log(4, _entry(pkg, S.DELETING)),
                    mgr.store.read("3"))

        out = _both(run, tmp_path)
        assert out[:6] == ("InjectedCrash", 3, None, 2, 2, True)

    def test_transient_store_errors_retry(self, tmp_path):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            out = []
            for site, call in (
                    ("store.put",
                     lambda: mgr.write_log(1, _entry(pkg, S.CREATING))),
                    ("store.read", lambda: mgr.get_log(1).state),
                    ("store.list", mgr.get_latest_id)):
                plan = faults.FaultPlan(site=site, kind="eio", count=1)
                faults.install(plan)
                out.append((call(), plan._fired))
                faults.clear()
            return out

        assert _both(run, tmp_path) == [(True, 1), ("CREATING", 1), (1, 1)]

    def test_retry_budget_bounded(self, tmp_path):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root, attempts=2)
            plan = faults.FaultPlan(site="store.put", kind="eio", count=-1)
            faults.install(plan)
            err = _raised(lambda: mgr.write_log(1, _entry(pkg, S.CREATING)))
            faults.clear()
            return (getattr(err, "errno", None), plan._fired,
                    mgr.write_log(1, _entry(pkg, S.CREATING)))

        assert _both(run, tmp_path) == (errno.EIO, 2, True)

    def test_pointer_cas_yields_to_newer_stable(self, tmp_path):
        def run(pkg, root):
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            for i, st in ((1, S.CREATING), (2, S.ACTIVE), (3, S.DELETED)):
                mgr.write_log(i, _entry(pkg, st))
            return (mgr.create_latest_stable_log(3),
                    mgr.create_latest_stable_log(2),
                    mgr.get_latest_stable_log().id,
                    mgr.store.generation("latestStable"),
                    mgr.create_latest_stable_log(9))

        assert _both(run, tmp_path) == (True, True, 3, 1, False)

    def test_corrupt_pointer_overwritten_by_cas(self, tmp_path):
        def run(pkg, root):
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            mgr.write_log(1, _entry(pkg, S.CREATING))
            mgr.write_log(2, _entry(pkg, S.ACTIVE))
            mgr.store.put_if_absent("latestStable", b'{"torn')
            resolved = mgr.get_latest_stable_log().id
            ok = mgr.create_latest_stable_log(2)
            data, gen = mgr.store.read_with_generation("latestStable")
            return resolved, ok, gen, b'"ACTIVE"' in data

        assert _both(run, tmp_path) == (2, True, 2, True)

    def test_delete_latest_stable_log_is_a_no_op(self, tmp_path):
        def run(pkg, root):
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            mgr.write_log(1, _entry(pkg, S.ACTIVE))
            mgr.create_latest_stable_log(1)
            return (mgr.delete_latest_stable_log(),
                    mgr.store.exists("latestStable"))

        assert _both(run, tmp_path) == (True, True)

    def test_cas_storm_no_lost_update(self, tmp_path):
        def run(pkg, root):
            faults = _m(pkg, "io.faults")
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            n = 12
            for i in range(1, n + 1):
                mgr.write_log(i, _entry(pkg, S.ACTIVE))
            faults.install(faults.FaultPlan(site="store.put", kind="eio",
                                            at=3, count=4))
            barrier = threading.Barrier(n)
            errors = []

            def racer(i):
                try:
                    barrier.wait()
                    mgr.create_latest_stable_log(i)
                except Exception as e:  # noqa: BLE001
                    errors.append(repr(e))

            threads = [threading.Thread(target=racer, args=(i,))
                       for i in range(1, n + 1)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            faults.clear()
            resolved = mgr.get_latest_stable_log()
            pointer = mgr._parse(mgr.store.read("latestStable"))
            return errors, resolved.id, pointer.id

        assert _both(run, tmp_path) == ([], 12, 12)

    def test_cas_attempts_bounded(self, tmp_path, monkeypatch):
        """A swap that loses every round gives up after ``_CAS_ATTEMPTS``
        and leaves the pointer to the reverse scan."""
        def run(pkg, root):
            olm = _m(pkg, "index.object_log_manager")
            S = _m(pkg, "index.log_entry").States
            mgr = _obj_mgr(pkg, root)
            mgr.write_log(1, _entry(pkg, S.ACTIVE))
            calls = []

            def lose(*a, **kw):
                calls.append(1)
                return False

            monkeypatch.setattr(mgr.store, "put_if_generation_match", lose)
            mgr.retry = _m(pkg, "utils.retry").RetryPolicy(
                max_attempts=1, initial_backoff_ms=0.0)
            ok = mgr.create_latest_stable_log(1)
            monkeypatch.undo()
            return ok, len(calls) == olm._CAS_ATTEMPTS, \
                mgr.get_latest_stable_log().id

        assert _both(run, tmp_path) == (False, True, 1)


def _write_data(d: str) -> None:
    os.makedirs(d)
    pq.write_table(pa.table({"k": pa.array(np.arange(100, dtype=np.int64)),
                             "v": pa.array(np.arange(100) * 0.5)}),
                   os.path.join(d, "p.parquet"))


def _session(pkg, system_path: str):
    if pkg is JAX:
        s = JAX.HyperspaceSession(system_path=system_path)
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    else:
        s = TORCH.HyperspaceSession(system_path=system_path, device="cpu")
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{kind}_min_rows", 0)
    return s


def test_object_store_manager_via_conf(tmp_path):
    """The log manager and its window chosen through the conf (the JAX
    case's string key, the port's conf field) run a whole lifecycle
    (create, then query) through the object-store protocol."""
    d = str(tmp_path / "data")
    _write_data(d)
    got = []
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path / pkg.__name__))
        s.conf.num_buckets = 2
        s.conf.log_manager_class = _manager_path(pkg)
        if pkg is JAX:
            s.conf.set("hyperspace.system.objectStore.staleListMs", 60000)
        else:
            s.conf.object_store_stale_list_ms = 60000
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(d), pkg.IndexConfig("obj", ["k"], ["v"]))
        mgr = s.index_collection_manager._log_manager("obj")
        s.enable_hyperspace()
        out = (s.read.parquet(d).filter(pkg.col("k") == 7).select("k", "v")
               .collect())
        got.append((type(mgr).__name__, type(mgr.store).__name__,
                    mgr.stale_list_s, mgr.store.list_keys(), mgr.log_ids(),
                    out.column("v").to_pylist(),
                    any(x["is_index"] for x in s.last_execution_stats["scans"]),
                    _files(mgr.store.root)))
    assert got[1] == got[0]
    assert got[1][:7] == ("ObjectStoreLogManager", "EmulatedObjectStore",
                          60.0, [], [1, 2], [3.5], True)


def test_conf_defaults_equal_the_jax_packages():
    jconf = JAX.HyperspaceSession(system_path="/nonexistent").conf
    tconf = TORCH.HyperspaceSession(system_path="/nonexistent",
                                    device="cpu").conf
    for field in ("log_manager_class", "log_store_class"):
        j, t = getattr(jconf, field), getattr(tconf, field)
        assert t == j.replace("hyperspace_tpu.", "hyperspace_tpu_torch.", 1)
    assert tconf.object_store_stale_list_ms == \
        jconf.object_store_stale_list_ms == 0.0
    assert tconf.log_store_class.endswith(".EmulatedObjectStore")


def test_a_class_of_the_jax_package_is_refused(tmp_path):
    """A class path into the JAX package raises before anything is
    imported, in a process that never imported jax."""
    script = f"""
import sys
from hyperspace_tpu_torch import HyperspaceSession
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.quarantine import quarantine_manager_for
from hyperspace_tpu_torch.telemetry.perf_ledger import store_for
s = HyperspaceSession({str(tmp_path / 'ix')!r}, device="cpu")
msgs = []
for field, path, call in (
        ("log_store_class", "hyperspace_tpu.io.log_store.PosixLogStore",
         lambda: store_for(s.conf)),
        ("log_store_class", "hyperspace_tpu.io.log_store.EmulatedObjectStore",
         lambda: quarantine_manager_for(s.conf, {str(tmp_path / 'q')!r})),
        ("log_manager_class",
         "hyperspace_tpu.index.object_log_manager.ObjectStoreLogManager",
         lambda: s.index_collection_manager._log_manager("x"))):
    setattr(s.conf, field, path)
    try:
        call()
    except HyperspaceError as e:
        msgs.append(str(e))
    s = HyperspaceSession({str(tmp_path / 'ix')!r}, device="cpu")
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
print(len(msgs), all("JAX package" in m for m in msgs), bad)
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "3 True []", proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# The data corruption matrix on both quarantine store classes
# ---------------------------------------------------------------------------
def _integrity_fixture(pkg, root, store):
    d = str(root / "data")
    os.makedirs(d)
    rng = np.random.default_rng(11)
    for i in range(2):
        pq.write_table(pa.table({
            "k": pa.array(np.arange(i * 90, (i + 1) * 90,
                                    dtype=np.int64) % 23),
            "v": pa.array(rng.random(90))}),
            os.path.join(d, f"p{i}.parquet"))
    s = _session(pkg, str(root / "ix"))
    s.conf.num_buckets = 3
    s.conf.log_store_class = f"{pkg.__name__}.io.log_store.{store}"

    def query():
        return (s.read.parquet(d).filter(pkg.col("k") < 9)
                .select("k", "v").collect()
                .sort_by([("k", "ascending"), ("v", "ascending")]))

    return s, pkg.Hyperspace(s), d, query


def _statuses(report):
    return dict(zip(report.column("file").to_pylist(),
                    report.column("status").to_pylist()))


@pytest.mark.parametrize("store", STORES)
def test_data_write_bitrot_converges(tmp_path, store):
    def run(pkg, root):
        faults = _m(pkg, "io.faults")
        s, hs, d, query = _integrity_fixture(pkg, root, store)
        expected = query()
        faults.install(faults.FaultPlan(site="data.write", kind="bitrot",
                                        at=1, count=1))
        hs.create_index(s.read.parquet(d), pkg.IndexConfig("cw", ["k"], ["v"]))
        faults.clear()
        statuses = _statuses(hs.verify_index("cw", mode="full"))
        flagged = sorted(os.path.basename(f) for f, st in statuses.items()
                         if st != "ok")
        qm = s.index_collection_manager.quarantine_manager("cw")
        n_quarantined = len(qm.paths())
        s.enable_hyperspace()
        contained = query().equals(expected)
        hs.refresh_index("cw", mode="repair")
        after = (qm.paths(), set(_statuses(hs.verify_index(
            "cw", mode="full")).values()))
        return (len(flagged), sorted(set(statuses.values())), n_quarantined,
                contained, after, query().equals(expected),
                any(x["is_index"] for x in s.last_execution_stats["scans"]),
                type(qm.store).__name__)

    out = _both(run, tmp_path)
    assert out == (1, ["digest-mismatch", "ok"], 1, True, (set(), {"ok"}),
                   True, True, store)


@pytest.mark.parametrize("store", STORES)
def test_data_write_truncate_never_commits(tmp_path, store):
    def run(pkg, root):
        faults = _m(pkg, "io.faults")
        s, hs, d, query = _integrity_fixture(pkg, root, store)
        expected = query()
        faults.install(faults.FaultPlan(site="data.write", kind="truncate",
                                        at=1, count=1))
        err = _raised(lambda: hs.create_index(
            s.read.parquet(d), pkg.IndexConfig("cw", ["k"], ["v"])))
        faults.clear()
        absent = s.index_collection_manager.get_index("cw") is None
        s.enable_hyperspace()
        first = query().equals(expected)
        s.conf.auto_recovery_enabled = True
        hs.create_index(s.read.parquet(d), pkg.IndexConfig("cw", ["k"], ["v"]))
        return (err is not None, absent, first, query().equals(expected),
                any(x["is_index"] for x in s.last_execution_stats["scans"]))

    assert _both(run, tmp_path) == (True, True, True, True, True)


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("kind", ["bitrot", "truncate"])
def test_data_read_corruption_converges(tmp_path, store, kind):
    def run(pkg, root):
        faults = _m(pkg, "io.faults")
        read_parquet_file = _m(pkg, "io.parquet").read_parquet_file
        s, hs, d, query = _integrity_fixture(pkg, root, store)
        expected = query()
        hs.create_index(s.read.parquet(d), pkg.IndexConfig("cr", ["k"], ["v"]))
        victim = s.index_collection_manager.get_index("cr") \
            .content.file_infos()[0].name
        faults.install(faults.FaultPlan(site="data.read", kind=kind,
                                        at=1, count=1))
        _raised(lambda: read_parquet_file(victim, None))
        faults.clear()
        status = _statuses(hs.verify_index("cr", mode="full"))[victim]
        qm = s.index_collection_manager.quarantine_manager("cr")
        quarantined = qm.paths() == {victim}
        s.enable_hyperspace()
        contained = query().equals(expected)
        hs.refresh_index("cr", mode="repair")
        return (status in ("digest-mismatch", "size-mismatch"), quarantined,
                contained, qm.paths(), query().equals(expected))

    assert _both(run, tmp_path) == (True, True, True, set(), True)


def test_corruption_kinds_do_not_fire_at_check_sites(tmp_path):
    def run(pkg, root):
        faults = _m(pkg, "io.faults")
        plan = faults.FaultPlan(site="log.write", kind="bitrot", at=1, count=1)
        faults.install(plan)
        try:
            faults.check("log.write")
            return faults.fire("log.write"), plan._calls
        finally:
            faults.clear()

    assert _both(run, tmp_path) == (None, 0)


# ---------------------------------------------------------------------------
# One index on the object-store log, both packages in turn
# ---------------------------------------------------------------------------
def _source(d: str, part: int, lo: int, n: int) -> None:
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(part)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(lo, lo + n, dtype=np.int64) % 97),
        "v": pa.array(rng.random(n))}), os.path.join(d, f"p{part}.parquet"))


def _object_session(pkg, system_path, stale_ms=0.0):
    s = _session(pkg, system_path)
    s.conf.num_buckets = 4
    s.conf.lineage_enabled = True
    s.conf.log_manager_class = _manager_path(pkg)
    s.conf.object_store_stale_list_ms = stale_ms
    return s


def _log_view(s, name):
    mgr = s.index_collection_manager._log_manager(name)
    stable = mgr.get_latest_stable_log()
    return {"ids": mgr.log_ids(),
            "states": [e.state for e in (mgr.get_log(i)
                                         for i in mgr.log_ids())],
            "stable": (stable.id, stable.state),
            "files": sorted(f.name for f in stable.content.file_infos()),
            "log_dir": _files(mgr.store.root)}


def _answers(pkg, s, d):
    s.enable_hyperspace()
    out = []
    for q in (pkg.col("k") == 5, pkg.col("k") < 20):
        t = (s.read.parquet(d).filter(q).select("k", "v").collect()
             .sort_by([("k", "ascending"), ("v", "ascending")]))
        out.append((t.to_pylist(),
                    any(x["is_index"] for x in s.last_execution_stats["scans"])))
    return out


def _bucket_digests(view):
    bucket_of = _m(TORCH, "io.parquet").bucket_id_of_file
    out = defaultdict(list)
    for f in view["files"]:
        with open(f, "rb") as fh:
            out[bucket_of(f)].append(hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(v) for b, v in out.items()}


def test_an_object_store_log_read_and_written_by_both(tmp_path):
    """The JAX package builds and refreshes an index on its
    ``ObjectStoreLogManager`` over ``EmulatedObjectStore``; the port (under
    a 60 s listing window) lists it, answers from it and refreshes it,
    and the JAX package reads the port's entries.  A copy refreshed by
    the JAX package instead holds the same bucket bytes."""
    d = str(tmp_path / "data")
    _source(d, 0, 0, 400)
    sp = str(tmp_path / "ix")
    js = _object_session(JAX, sp)
    jhs = JAX.Hyperspace(js)
    jhs.create_index(js.read.parquet(d), JAX.IndexConfig("ox", ["k"], ["v"]))
    _source(d, 1, 400, 50)
    jhs.refresh_index("ox", "incremental")

    ts = _object_session(TORCH, sp, stale_ms=60_000.0)
    jview = _log_view(js, "ox")
    tview = _log_view(ts, "ox")
    assert tview == jview
    assert jview["ids"] == [1, 2, 3, 4]
    assert jview["states"] == ["CREATING", "ACTIVE", "REFRESHING", "ACTIVE"]
    tmgr = ts.index_collection_manager._log_manager("ox")
    assert tmgr.store.list_keys() == []  # the window hides every key
    assert _answers(TORCH, ts, d) == _answers(JAX, js, d)

    twin = str(tmp_path / "twin")
    shutil.copytree(sp, twin)
    _source(d, 2, 450, 60)
    assert TORCH.Hyperspace(ts).refresh_index("ox", "incremental").outcome \
        == "ok"
    jtwin = _object_session(JAX, twin)
    JAX.Hyperspace(jtwin).refresh_index("ox", "incremental")

    js.index_collection_manager.clear_cache()
    jview, tview = _log_view(js, "ox"), _log_view(ts, "ox")
    assert tview == jview
    assert jview["ids"] == [1, 2, 3, 4, 5, 6]
    assert jview["states"][-2:] == ["REFRESHING", "ACTIVE"]
    assert _log_view(jtwin, "ox")["log_dir"] == jview["log_dir"]
    assert _bucket_digests(jview) == _bucket_digests(_log_view(jtwin, "ox"))
    assert _answers(JAX, js, d) == _answers(TORCH, ts, d)
    assert all(scanned for _rows, scanned in _answers(JAX, js, d))
    # The pointer's generation moved once per stable commit, whoever
    # wrote it.
    assert tmgr.store.generation("latestStable") == 3


def _default_sessions(tmp_path):
    d = str(tmp_path / "data")
    _source(d, 0, 0, 300)
    sp = str(tmp_path / "ix")
    js, ts = _session(JAX, sp), _session(TORCH, sp)
    for s in (js, ts):
        s.conf.num_buckets = 4
    JAX.Hyperspace(js).create_index(js.read.parquet(d),
                                    JAX.IndexConfig("qx", ["k"], ["v"]))
    return js, ts


def test_quarantine_records_under_both_defaults(tmp_path):
    """Each package on its default store: a record either writes, the
    other reads (path, reason, size), and the file names are the
    emulated store's (the quarantine key percent-encoded once more)."""
    js, ts = _default_sessions(tmp_path)
    jqm = js.index_collection_manager.quarantine_manager("qx")
    tqm = ts.index_collection_manager.quarantine_manager("qx")
    assert type(jqm.store).__name__ == type(tqm.store).__name__ \
        == "EmulatedObjectStore"
    files = [f.name for f in js.index_collection_manager.get_index("qx")
             .content.file_infos()]
    a, b = files[0], files[1]
    assert jqm.add(a, "jax wrote", size=11)
    assert tqm.paths() == {a} and tqm.is_quarantined(a)
    rec = tqm.records()[0]
    assert (rec["path"], rec["reason"], rec["size"]) == (a, "jax wrote", 11)
    assert not tqm.add(a, "again")
    assert tqm.add(b, "torch wrote")
    assert jqm.paths() == {a, b}
    assert {r["reason"] for r in jqm.records()} == {"jax wrote", "torch wrote"}
    names = [n for n in _files(jqm.store.root)
             if n != ".lock" and not n.endswith(".g")]
    assert names and all("%253D" in n and "%252F" in n for n in names)
    tqm.remove(a)
    assert jqm.paths() == {b}
    jqm.clear()
    assert tqm.paths() == set()


def test_journal_records_under_both_defaults(tmp_path):
    js, ts = _default_sessions(tmp_path)
    jj = _m(JAX, "lifecycle.journal")
    tj = _m(TORCH, "lifecycle.journal")
    assert jj.append(js.conf, {"decision": "none", "index": "qx",
                               "outcome": "noop", "reason": "jax"})
    assert tj.append(ts.conf, {"decision": "refresh", "index": "qx",
                               "outcome": "done", "reason": "torch"})
    mine, theirs = tj.records(ts.conf), jj.records(js.conf)
    assert mine == theirs
    assert [r["reason"] for r in mine] == ["jax", "torch"]
    assert tj.history_table(ts.conf).to_pylist() == \
        jj.history_table(js.conf).to_pylist()
    assert type(tj._store(ts.conf)).__name__ == "EmulatedObjectStore"


# ---------------------------------------------------------------------------
# The quarantine under a listing window (the port probes its candidates)
# ---------------------------------------------------------------------------
def test_quarantine_under_a_listing_window(tmp_path):
    """With a 60 s window a fresh record is not listed, yet verify,
    the rules, the repair and the vacuum find it by point reads."""
    d = str(tmp_path / "data")
    _source(d, 0, 0, 400)
    s = _session(TORCH, str(tmp_path / "ix"))
    s.conf.num_buckets = 4
    s.conf.object_store_stale_list_ms = 60_000.0
    hs = TORCH.Hyperspace(s)
    hs.create_index(s.read.parquet(d), TORCH.IndexConfig("wx", ["k"], ["v"]))
    entry = s.index_collection_manager.get_index("wx")
    victim = entry.content.file_infos()[1].name
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        f.write(b"\xff" * 8)
    statuses = _statuses(hs.verify_index("wx", mode="full"))
    assert statuses[victim] == "digest-mismatch"
    qm = s.index_collection_manager.quarantine_manager("wx")
    assert qm.store.list_keys() == []
    assert qm.paths() == set()  # the listing alone misses it
    candidates = [f.name for f in entry.content.file_infos()]
    assert qm.paths(candidates) == {victim}
    assert [r["path"] for r in qm.records(candidates)] == [victim]
    s.enable_hyperspace()
    ds = s.read.parquet(d).filter(TORCH.col("k") < 50).select("k", "v")
    got = ds.collect().sort_by([("k", "ascending"), ("v", "ascending")])
    plan = ds.optimized_plan().tree_string() \
        if hasattr(ds.optimized_plan(), "tree_string") \
        else str(ds.optimized_plan())
    assert "BucketIn" in plan or s.last_execution_stats.get("bucket_in")
    expected = pq.read_table(d).filter(
        pa.compute.less(pq.read_table(d)["k"], 50)).select(["k", "v"]) \
        .sort_by([("k", "ascending"), ("v", "ascending")])
    assert got.equals(expected)
    assert hs.refresh_index("wx", "repair").outcome == "ok"
    assert qm.paths(candidates) == set()
    assert set(_statuses(hs.verify_index("wx", mode="full")).values()) \
        == {"ok"}
    # A record of a file of an old version, dropped with the version.
    new_files = [f.name for f in s.index_collection_manager.get_index("wx")
                 .content.file_infos()]
    assert qm.add(new_files[0], "test")
    version = int(new_files[0].split("v__=")[1].split(os.sep)[0])
    s.index_collection_manager._data_manager("wx").delete(version)
    assert not qm.is_quarantined(new_files[0])


# ---------------------------------------------------------------------------
# Two processes racing for the ids of one object-store log
# ---------------------------------------------------------------------------
_RACER = r"""
import json, os, sys
from hyperspace_tpu_torch.index.object_log_manager import ObjectStoreLogManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.utils.retry import RetryPolicy

index_path, who, n, payload = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
mgr = ObjectStoreLogManager(index_path)
mgr.retry = RetryPolicy(max_attempts=3, initial_backoff_ms=1)
mgr.stale_list_s = 0.05
won = []
for _ in range(n):
    for _attempt in range(200):
        nxt = (mgr.get_latest_id() or 0) + 1
        e = IndexLogEntry.from_dict(json.loads(payload))
        e.properties["writer"] = who
        if mgr.write_log(nxt, e):
            won.append(nxt)
            mgr.create_latest_stable_log(nxt)
            break
    else:
        sys.exit(3)
print(json.dumps(won))
"""


def test_two_processes_race_for_ids(tmp_path):
    """Two port processes each commit 15 entries to one log under a
    listing window: every id from 1 to 30 is won exactly once, and the
    pointer ends at 30."""
    e = sample_entry(state="ACTIVE")
    e.timestamp = 1_700_000_000_000
    payload = json.dumps(e.to_dict())
    index_path = str(tmp_path / "idx")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RACER, index_path, who, "15", payload],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for who in ("a", "b")]
    won = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            won.append(json.loads(out))
    finally:
        for p in procs:
            p.kill()
    assert sorted(won[0] + won[1]) == list(range(1, 31))
    mgr = _m(TORCH, "index.object_log_manager").ObjectStoreLogManager(
        index_path)
    assert mgr.get_latest_stable_log().id == 30
    writers = {mgr.get_log(i).properties["writer"] for i in range(1, 31)}
    assert writers == {"a", "b"}


# ---------------------------------------------------------------------------
# chip_smoke's phase S, rehearsed on the CPU
# ---------------------------------------------------------------------------
def test_phase_s_on_the_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase S end to end at 80,000 lineitem rows: the
    object-store build bit for bit the posix twin's, the seven queries,
    the quarantine under the listing window and the repair, the
    incremental refresh, the two faulted quick refreshes, the race and
    the commit times.  The CPU has no CUDA allocator to read and the
    plain kernels count no launch, so those checks are stubbed here and
    run on the card."""
    import torch

    import chip_smoke
    from hyperspace_tpu_torch import HyperspaceSession

    conf_batch = HyperspaceSession(device="cpu").conf.device_batch_rows
    for name, value in (("N_LINEITEM", 80_000), ("N_ORDERS", 20_000),
                        ("N_FILES", 8), ("ROWS_PER_FILE", 10_000),
                        ("DEFAULT_BATCH_ROWS", conf_batch),
                        ("POINT_KEY", 1234), ("RANGE", (2000, 6000)),
                        ("Q10_WINDOW", (10_000, 40_000)),
                        ("AGG_ORDERKEY_BELOW", 10_000),
                        ("PRICE_BELOW", 20_000.0), ("S_COMMITS", 5)):
        monkeypatch.setattr(chip_smoke, name, value)
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *_a, **_k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *_a, **_k: 0)
    monkeypatch.setattr(chip_smoke, "require_launches",
                        lambda *_a, **_k: None)
    orders, li = chip_smoke.gen_data()
    root = str(tmp_path / "smoke")
    chip_smoke.write_files(li, os.path.join(root, "lineitem"))
    chip_smoke.write_files(orders, os.path.join(root, "orders"))
    out = chip_smoke.phase_s(orders, li, root, torch.device("cpu"))
    assert out["build"]["listed"] == [] and out["build"]["probed"] == [1, 2]
    assert out["race"]["outcomes"] in (["ok", "noop"], ["noop", "ok"])
    assert out["race"]["conflict_retries"] >= 1
    torn = out["faults"]["torn_entry"]
    assert torn["ids"] == [torn["burned"], torn["burned"] + 1,
                           torn["burned"] + 2]
    ids = out["pointer_ids"]
    assert ids == sorted(ids) and ids[-1] == out["log"]["ids"][-1]
    assert set(out["commit_ms"]) == {"EmulatedObjectStore", "PosixLogStore",
                                     "posix log (IndexLogManager)"}
    assert not any(out["launches"].values())  # the plain kernels count none
    assert not os.path.exists(os.path.join(root, chip_smoke.S_SOURCE))
