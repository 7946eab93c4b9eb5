"""The work claims and the crash-tolerant multi-host build through
hyperspace_tpu_torch (on the CPU) against the JAX package: the mirror of
tests/test_multihost_build.py.

  - ``WorkClaims`` over both store classes: a done record is final; an
    expired claim is reclaimed and its zombie fenced; a double reclaim
    has one winner; a torn claim reads as absent and is reclaimed; the
    store-latency margin stands the holder down before its expiry.  One
    script run through both packages journals the same ``claim`` records
    (mode, outcome, item, epoch, in order).
  - The build: two host subprocesses on the CPU write, bucket for
    bucket, the bytes of the port's single-process build and of the JAX
    package's; one ``claim``/``commit`` record; no claim left behind; a
    host SIGKILLed mid-route costs one claim TTL, not the build; a host
    asked for ``cuda`` without CUDA raises.

A deliberate difference, pinned here: a chunk claim's result carries the
host's kernel launches, summed into the build report as
``multihost_launches`` (a key the JAX package lacks; the plain kernels
on the CPU count none, so an in-process host with counting kernels
checks the sum).
"""

from __future__ import annotations

import hashlib
import importlib
import os
import signal
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
from hyperspace_tpu_torch.lifecycle import journal as lifecycle_journal
from hyperspace_tpu_torch.lifecycle.lease import WorkClaims
from hyperspace_tpu_torch.parallel import multihost_build
from hyperspace_tpu_torch.telemetry.perf_ledger import store_for

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
STORES = ("PosixLogStore", "EmulatedObjectStore")


def _m(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _session(tmp_path, store, pkg=TORCH):
    if pkg is TORCH:
        s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
        s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
        return s
    s = JAX.HyperspaceSession(system_path=str(tmp_path / "ix"))
    s.conf.set("hyperspace.index.logStoreClass",
               f"hyperspace_tpu.io.log_store.{store}")
    return s


def _claims(s, owner, ttl_s=0.5, pkg=TORCH):
    store = _m(pkg, "telemetry.perf_ledger").store_for(
        s.conf, os.path.join(str(s.conf.system_path), "_claims_test"))
    return _m(pkg, "lifecycle.lease").WorkClaims(store, s.conf, owner=owner,
                                                 ttl_s=ttl_s)


def _claim_events(conf, pkg=TORCH):
    return [r for r in _m(pkg, "lifecycle.journal").records(conf)
            if r.get("decision") == "claim"]


# ---------------------------------------------------------------------------
# WorkClaims (in-process, both store classes)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("store", STORES)
class TestWorkClaims:
    def test_claim_complete_is_final(self, tmp_path, store):
        s = _session(tmp_path, store)
        a = _claims(s, "a", ttl_s=5.0)
        b = _claims(s, "b", ttl_s=5.0)
        claim = a.try_claim("chunk-00000")
        assert claim is not None and claim["epoch"] == 1
        assert b.try_claim("chunk-00000") is None      # live holder
        assert a.renew(claim)
        assert a.complete(claim, {"rows": 7})
        assert a.result("chunk-00000") == {"rows": 7}
        assert b.try_claim("chunk-00000") is None      # done is final
        assert b.pending(["chunk-00000", "chunk-00001"]) == ["chunk-00001"]
        modes = [e["mode"] for e in _claim_events(s.conf)]
        assert "acquire" in modes and "complete" in modes

    def test_expired_reclaim_fences_zombie(self, tmp_path, store):
        s = _session(tmp_path, store)
        a = _claims(s, "a", ttl_s=0.3)
        b = _claims(s, "b", ttl_s=5.0)
        stale = a.try_claim("group-000")
        assert stale is not None
        time.sleep(0.4)
        taken = b.try_claim("group-000")
        assert taken is not None and taken["epoch"] == 2
        assert a.renew(stale) is False
        assert a.complete(stale, {"rows": 1}) is False
        assert b.complete(taken, {"rows": 2})
        assert b.result("group-000") == {"rows": 2}
        modes = [e["mode"] for e in _claim_events(s.conf)]
        assert "reclaim" in modes and modes.count("fence") == 2

    def test_double_reclaim_single_winner(self, tmp_path, store):
        s = _session(tmp_path, store)
        a = _claims(s, "a", ttl_s=0.2)
        b = _claims(s, "b", ttl_s=5.0)
        c = _claims(s, "c", ttl_s=5.0)
        assert a.try_claim("chunk-00003") is not None
        time.sleep(0.3)
        stale_read = c.get("chunk-00003")              # c reads first ...
        won = b.try_claim("chunk-00003")               # ... b commits
        assert won is not None and won["epoch"] == 2
        c.get = lambda item: stale_read                # c acts on its read
        assert c.try_claim("chunk-00003") is None      # a lost CAS
        rec, _g = b.get("chunk-00003")
        assert rec["holder"] == "b"

    def test_torn_claim_reads_absent_then_reclaimed(self, tmp_path, store):
        s = _session(tmp_path, store)
        a = _claims(s, "a", ttl_s=5.0)
        assert a.store.put_if_generation_match(
            WorkClaims.PREFIX + "chunk-00001", b"\x00torn not json", 0)
        rec, gen = a.get("chunk-00001")
        assert rec is None and gen >= 1
        claim = a.try_claim("chunk-00001")
        assert claim is not None
        assert claim["epoch"] > gen
        assert a.complete(claim, {})
        modes = [e["mode"] for e in _claim_events(s.conf)]
        assert "reclaim" in modes

    def test_rtt_margin_stands_down_before_expiry(self, tmp_path, store):
        s = _session(tmp_path, store)
        a = _claims(s, "a", ttl_s=0.9)
        b = _claims(s, "b", ttl_s=5.0)
        claim = a.try_claim("group-001")
        assert claim is not None
        a._lat_ewma_s = 10.0                           # a degraded link
        assert a.margin_s() == pytest.approx(0.3)      # clamped to TTL/3
        time.sleep(0.65)
        assert time.time() < claim["expires_at"]       # not expired ...
        assert not a.holds(claim)                      # ... stands down
        assert b.try_claim("group-001") is None
        assert a.renew(claim)
        assert a.holds(claim)

    def test_the_journal_is_the_jax_packages(self, tmp_path, store):
        """One script through both packages: the same claim records in
        mode, outcome, item and epoch, in the same order."""
        def script(pkg):
            s = _session(tmp_path / pkg.__name__, store, pkg)
            a = _claims(s, "a", ttl_s=0.3, pkg=pkg)
            b = _claims(s, "b", ttl_s=5.0, pkg=pkg)
            first = a.try_claim("chunk-00000")
            assert a.renew(first) and a.complete(first, {"rows": 3})
            stale = a.try_claim("group-000")
            time.sleep(0.4)
            taken = b.try_claim("group-000")
            assert a.renew(stale) is False
            assert a.complete(stale, {}) is False
            assert b.complete(taken, {"rows": 3})
            b.store.put_if_generation_match(
                "claim-chunk-00001", b"\x00torn", 0)
            torn = b.try_claim("chunk-00001")
            assert b.complete(torn, {})
            return [(e["mode"], e["outcome"], e["item"], e["epoch"])
                    for e in _claim_events(s.conf, pkg)]

        ours = script(TORCH)
        assert ours == script(JAX)
        assert [m for m, *_ in ours] == [
            "acquire", "complete", "acquire", "reclaim", "fence", "fence",
            "complete", "reclaim", "complete"]


# ---------------------------------------------------------------------------
# The build: host subprocesses, one index
# ---------------------------------------------------------------------------
N_ROWS = 24000


@pytest.fixture(scope="module")
def mh_source(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh_src")
    rng = np.random.default_rng(7)
    t = pa.table({
        "k": pa.array(rng.integers(0, 500, size=N_ROWS), type=pa.int64()),
        "g": pa.array(rng.integers(0, 7, size=N_ROWS), type=pa.int64()),
        "v": pa.array(rng.integers(0, 1000, size=N_ROWS), type=pa.int64()),
    })
    step = -(-N_ROWS // 3)
    for f in range(3):
        pq.write_table(t.slice(f * step, step),
                       os.path.join(str(root), f"part-{f:05d}.parquet"))
    return str(root)


def _mh_session(tmp_path, src, hosts, ttl_s=1.5):
    s = HyperspaceSession(system_path=str(tmp_path / f"ix_h{hosts}"),
                          device="cpu")
    s.conf.num_buckets = 8
    s.conf.device_batch_rows = 4096
    s.conf.device_build_min_rows = 0   # the device route on every host
    s.conf.multihost_build_hosts = hosts
    s.conf.multihost_build_claim_ttl_s = ttl_s
    s.conf.multihost_build_poll_s = 0.02
    hs = Hyperspace(s)
    hs.create_index(s.read.parquet(src), IndexConfig("mh", ["k"], ["g", "v"]))
    return s, hs


def _bucket_digests(s):
    entry = s.index_collection_manager.get_index("mh")
    out = {}
    for fi in entry.content.file_infos():
        with open(fi.name, "rb") as fh:
            out.setdefault(bucket_id_of_file(fi.name), []).append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(v) for b, v in out.items()}


@pytest.fixture(scope="module")
def single_host_digests(mh_source, tmp_path_factory):
    s, _hs = _mh_session(tmp_path_factory.mktemp("mh_single"), mh_source, 0)
    return _bucket_digests(s)


@pytest.fixture(scope="module")
def jax_digests(mh_source, tmp_path_factory):
    s = JAX.HyperspaceSession(
        system_path=str(tmp_path_factory.mktemp("mh_jax") / "ix"))
    s.conf.num_buckets = 8
    s.conf.device_batch_rows = 4096
    s.conf.device_build_min_rows = 0
    JAX.Hyperspace(s).create_index(s.read.parquet(mh_source),
                                   JAX.IndexConfig("mh", ["k"], ["g", "v"]))
    return _bucket_digests(s)


def test_the_single_process_builds_agree(single_host_digests, jax_digests):
    assert single_host_digests == jax_digests
    assert len(single_host_digests) == 8


def test_two_host_build_bit_equal(tmp_path, mh_source, single_host_digests,
                                  jax_digests):
    s, hs = _mh_session(tmp_path, mh_source, 2)
    assert _bucket_digests(s) == single_host_digests == jax_digests
    props = hs.last_build_report().properties
    assert props["multihost_hosts"] == 2
    assert props["multihost_chunks"] == -(-N_ROWS // 4096)
    assert props["multihost_groups"] == 8
    assert props["multihost_route_wall_s"] > 0
    # The plain kernels on the CPU count no launch.
    assert props["multihost_launches"] == {"hash_buckets": 0,
                                           "bucket_histogram": 0}
    commits = [e for e in _claim_events(s.conf) if e["mode"] == "commit"]
    assert len(commits) == 1
    assert multihost_build.scan_build_claims(s.conf) == []
    assert not os.listdir(multihost_build.build_root(s.conf))
    # Every promoted file carries the digest of its bytes.
    entry = s.index_collection_manager.get_index("mh")
    assert all(fi.digest for fi in entry.content.file_infos())


def test_sigkill_mid_route_survivor_completes(tmp_path, mh_source,
                                              single_host_digests,
                                              monkeypatch):
    """SIGKILL one host once routing is underway: the survivor reclaims
    its expired claims and lands the same bytes, with one commit."""
    killed = {}
    orig_spawn = multihost_build.spawn_hosts

    def spawn_and_kill(conf, build_id, n, device="cuda"):
        procs = orig_spawn(conf, build_id, n, device=device)
        store = multihost_build._store(conf, build_id)
        watch = WorkClaims(store, conf, owner="watcher", ttl_s=1.0)

        def watcher():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not killed:
                done = sum(
                    1 for key in store.list_keys(WorkClaims.PREFIX)
                    if (rec := watch.get(key[len(WorkClaims.PREFIX):])[0])
                    and rec.get("done")
                    and rec["item"].startswith("chunk-"))
                if done >= 1 and procs[0].poll() is None:
                    os.kill(procs[0].pid, signal.SIGKILL)
                    killed["after_chunks"] = done
                    return
                time.sleep(0.02)

        threading.Thread(target=watcher, daemon=True).start()
        return procs

    monkeypatch.setattr(multihost_build, "spawn_hosts", spawn_and_kill)
    s, _hs = _mh_session(tmp_path, mh_source, 2)
    assert killed, "the watcher never fired; the drill proved nothing"
    assert _bucket_digests(s) == single_host_digests
    events = _claim_events(s.conf)
    assert len([e for e in events if e["mode"] == "commit"]) == 1
    done_items = [e["item"] for e in events if e["mode"] == "complete"]
    assert len(done_items) == len(set(done_items))
    assert multihost_build.scan_build_claims(s.conf) == []


class _ThreadHost:
    """A host run on a thread of this process, with Popen's surface."""

    def __init__(self, target) -> None:
        self.returncode = None
        self.error = None

        def run():
            try:
                target()
                self.returncode = 0
            except BaseException as e:  # noqa: BLE001 - reported by poll
                self.error = e
                self.returncode = 1

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        self._thread.join(timeout)
        return self.returncode

    def kill(self):
        pass


def test_chunk_launches_sum_into_the_report(tmp_path, mh_source,
                                            monkeypatch):
    """With kernels that count (one hash and one histogram launch per
    route), a host's chunk results carry its launches and the report
    sums them: one of each per chunk."""
    from hyperspace_tpu_torch.ops import hash as ops_hash
    from hyperspace_tpu_torch.ops import kernels

    real_route = ops_hash.route_partition

    def counting_route(*args, **kwargs):
        out = real_route(*args, **kwargs)
        for k in (kernels.HASH_BUCKETS, kernels.BUCKET_HISTOGRAM):
            with k._count_lock:
                k.launches += 1
        return out

    def thread_host(conf, build_id, n, device="cuda"):
        assert n == 1
        return [_ThreadHost(lambda: multihost_build.run_host(
            conf, build_id, owner="thread-host", device=device))]

    monkeypatch.setattr(ops_hash, "route_partition", counting_route)
    monkeypatch.setattr(multihost_build, "spawn_hosts", thread_host)
    s, hs = _mh_session(tmp_path, mh_source, 1)
    chunks = -(-N_ROWS // 4096)
    assert hs.last_build_report().properties["multihost_launches"] == {
        "hash_buckets": chunks, "bucket_histogram": chunks}


def test_a_host_on_cuda_without_cuda_raises(tmp_path, mh_source, capfd,
                                            monkeypatch):
    """The spec names the session's device; a host asked for ``cuda`` in
    a process without CUDA exits with an error and routes nothing on the
    CPU, and the coordinator fails the build."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without CUDA")
    orig_spawn = multihost_build.spawn_hosts
    monkeypatch.setattr(
        multihost_build, "spawn_hosts",
        lambda conf, build_id, n, device="cuda": orig_spawn(
            conf, build_id, n, device="cuda"))
    with pytest.raises(HyperspaceError, match="every host exited"):
        _mh_session(tmp_path, mh_source, 1)
    assert "no CUDA device" in capfd.readouterr().err
    s = HyperspaceSession(system_path=str(tmp_path / "ix_h1"), device="cpu")
    assert s.index_collection_manager.get_index("mh") is None
    with pytest.raises(HyperspaceError, match="no CUDA device"):
        multihost_build.run_host(s.conf, "build-0-none", device="cuda")


def test_reap_removes_only_dead_coordinators(tmp_path):
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    root = multihost_build.build_root(s.conf)
    dead = os.path.join(root, "build-999999999-deadbeef")
    live = os.path.join(root, f"build-{os.getpid()}-cafe")
    other = os.path.join(root, "unstamped")
    for d in (dead, live, other):
        os.makedirs(d)
    assert multihost_build.reap_orphan_build_dirs(s.conf) == 1
    assert sorted(os.listdir(root)) == sorted(
        [os.path.basename(live), "unstamped"])


def test_plan_cuts_and_refusals(tmp_path):
    assert multihost_build._chunk_ranges(10, 4) == [[0, 4], [4, 8], [8, 10]]
    assert multihost_build._chunk_ranges(0, 4) == []
    assert multihost_build._code_column_names(
        ["k", "__hs_sort0"], ["k"], {"k": "int64"}, False) == ["__hs_sort0_"]
    assert multihost_build._code_column_names(
        ["s"], ["s"], {"s": "string"}, False) == []
    src = tmp_path / "src"
    src.mkdir()
    pq.write_table(pa.table({"k": [1, 2, 3]}), str(src / "p.parquet"))
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    s.conf.multihost_build_hosts = 2
    with pytest.raises(HyperspaceError, match="zorder"):
        Hyperspace(s).create_index(
            s.read.parquet(str(src)),
            IndexConfig("z", ["k"], [], layout="zorder"))
