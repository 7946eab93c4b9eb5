"""The maintenance lease through hyperspace_tpu_torch (on the CPU): the
acquire, standby, renew, takeover, fence and release protocol, the
daemon's standby gate, and a SIGKILLed holder's takeover with the
pending refresh executed exactly once.

The cases of tests/test_lease.py over both store classes (the default
``EmulatedObjectStore``, and ``PosixLogStore`` in the ``...Posix``
classes), each held to what it asserts, on the port alone; the holder
of the churn case is a port process.  The lease metrics the JAX cases
read (``lease.fenced``) wait for ROADMAP.md Queue A item 9: the fence is
read from the journal here.  The record's layout is the JAX package's,
so the two packages contend for one lease under the same store class.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
from hyperspace_tpu_torch.lifecycle import journal as lifecycle_journal
from hyperspace_tpu_torch.lifecycle import lease

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _session(tmp_path, ttl_s=0.5, store=""):
    """A session with the lease on; ``store`` pins a class of
    io/log_store.py, "" keeps the default (``EmulatedObjectStore``)."""
    s = HyperspaceSession(system_path=str(tmp_path / "ix"), device="cpu")
    if store:
        s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    s.conf.lifecycle_lease_enabled = True
    s.conf.lifecycle_lease_ttl_s = ttl_s
    return s


def _lease_events(conf):
    return [r for r in lifecycle_journal.records(conf)
            if r.get("decision") == "lease"]


def _write_part(src: str, name: str, lo: int, n: int, seed: int) -> None:
    rng = np.random.default_rng(seed)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(lo, lo + n, dtype=np.int64)),
        "d": pa.array(rng.integers(0, 50, n), type=pa.int64()),
        "v": rng.random(n),
    }), os.path.join(src, name))


class TestLeaseProtocol:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def test_acquire_standby_renew(self, tmp_path):
        s = _session(tmp_path, ttl_s=5.0, store=self.store)
        a = lease.MaintenanceLease(s.conf, owner="a")
        b = lease.MaintenanceLease(s.conf, owner="b")
        assert a.ensure() is True
        assert a.holds()
        assert b.ensure() is False
        assert not b.holds()
        assert a.ensure() is True
        rec = lease.status(s.conf)
        assert rec["holder"] == "a" and rec["epoch"] == 1 and rec["fresh"]
        events = [e["mode"] for e in _lease_events(s.conf)]
        assert "acquire" in events and "renew" in events

    def test_expiry_takeover_fences_zombie(self, tmp_path):
        s = _session(tmp_path, ttl_s=0.3, store=self.store)
        a = lease.MaintenanceLease(s.conf, owner="a")
        b = lease.MaintenanceLease(s.conf, owner="b")
        assert a.ensure() is True
        time.sleep(0.4)
        assert not a.holds()
        fenced0 = sum(e["mode"] == "fence" for e in _lease_events(s.conf))
        assert b.ensure() is True
        assert b.epoch == 2
        rec = lease.status(s.conf)
        assert rec["holder"] == "b" and rec["epoch"] == 2
        assert a.renew() is False
        assert not a.holds()
        events = _lease_events(s.conf)
        assert sum(e["mode"] == "fence" for e in events) == fenced0 + 1
        modes = [e["mode"] for e in events]
        assert "takeover" in modes and "fence" in modes
        fence = [e for e in events if e["mode"] == "fence"][-1]
        assert (fence["holder"], fence["outcome"]) == ("a", "error")
        assert b.ensure() is True

    def test_release_hands_off_instantly(self, tmp_path):
        s = _session(tmp_path, ttl_s=30.0, store=self.store)
        a = lease.MaintenanceLease(s.conf, owner="a")
        b = lease.MaintenanceLease(s.conf, owner="b")
        assert a.ensure() is True
        assert b.ensure() is False
        a.release()
        assert not a.holds()
        assert b.ensure() is True
        assert b.epoch == 2

    def test_torn_record_reads_absent(self, tmp_path):
        s = _session(tmp_path, store=self.store)
        store = lease._store(s.conf)
        assert type(store).__name__ == (self.store or "EmulatedObjectStore")
        assert store.put_if_generation_match(
            lease.LEASE_KEY, b"\x00garbage not json", 0)
        assert lease.status(s.conf) is None
        a = lease.MaintenanceLease(s.conf, owner="a")
        assert a.ensure() is True

    def test_margin_covers_measured_store_latency(self, tmp_path):
        s = _session(tmp_path, ttl_s=30.0, store=self.store)
        a = lease.MaintenanceLease(s.conf, owner="a")
        assert a.margin_s() == 0.6  # a cold EWMA: 2% of the TTL
        a._observe_latency(4.0)
        assert a.margin_s() == 8.0  # two round trips
        a._observe_latency(100.0)
        assert a.margin_s() == 10.0  # clamped to a third of the TTL

    def test_the_jax_package_contends_for_the_same_lease(self, tmp_path):
        """One record through both packages' stores: a JAX holder puts the
        port's candidate on standby, and its release hands over."""
        from hyperspace_tpu import HyperspaceSession as JaxSession
        from hyperspace_tpu.lifecycle import lease as jax_lease

        s = _session(tmp_path, ttl_s=30.0, store=self.store)
        js = JaxSession(system_path=str(tmp_path / "ix"))
        if self.store:  # else both packages keep their default store
            js.conf.log_store_class = f"hyperspace_tpu.io.log_store.{self.store}"
        js.conf.lifecycle_lease_ttl_s = 30.0
        j = jax_lease.MaintenanceLease(js.conf, owner="jax")
        t = lease.MaintenanceLease(s.conf, owner="torch")
        assert j.ensure() is True
        assert t.ensure() is False
        assert lease.status(s.conf)["holder"] == "jax"
        j.release()
        assert t.ensure() is True and t.epoch == 2
        assert jax_lease.status(js.conf)["holder"] == "torch"

    def test_process_identity_is_host_pid_start(self):
        ident = lease.process_identity()
        assert ident == lease.process_identity()
        host, pid, start = ident.rsplit("-", 2)
        assert host and int(pid) == os.getpid() and int(start) > 1e12


class TestDaemonGate:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def _env(self, tmp_path):
        src = str(tmp_path / "src")
        os.makedirs(src)
        _write_part(src, "part-00000000.parquet", 0, 2000, 3)
        s = _session(tmp_path, ttl_s=30.0, store=self.store)
        s.conf.num_buckets = 4
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(src),
                        IndexConfig("lix", ["k"], ["v"]))
        return s, hs, src

    def test_standby_cycle_skips_and_journals(self, tmp_path):
        s, hs, src = self._env(tmp_path)
        other = lease.MaintenanceLease(s.conf, owner="somebody-else")
        assert other.ensure() is True
        recs = hs.maintenance_cycle()
        assert len(recs) == 1
        assert recs[0]["outcome"] == "skipped"
        assert "lease standby" in recs[0]["reason"]
        assert "somebody-else" in recs[0]["reason"]
        other.release()
        recs = hs.maintenance_cycle()
        assert all(r.get("outcome") != "skipped" for r in recs)
        rec = lease.status(s.conf)
        assert rec is not None and rec["holder"] != "somebody-else"

    def test_stop_releases_the_lease(self, tmp_path):
        s, hs, src = self._env(tmp_path)
        hs.maintenance_cycle()
        assert lease.status(s.conf)["fresh"]
        hs.stop_maintenance()
        assert not lease.status(s.conf)["fresh"]
        assert _lease_events(s.conf)[-1]["mode"] == "release"


_HOLDER_CHILD = r"""
import json, os, sys, time
from hyperspace_tpu_torch import HyperspaceSession
from hyperspace_tpu_torch.lifecycle import lease

system_path, ttl, store = sys.argv[1:4]
s = HyperspaceSession(system_path=system_path, device="cpu")
if store:
    s.conf.log_store_class = f"hyperspace_tpu_torch.io.log_store.{store}"
s.conf.lifecycle_lease_enabled = True
s.conf.lifecycle_lease_ttl_s = float(ttl)
hold = lease.MaintenanceLease(s.conf, owner="holder-child")
deadline = time.time() + 30
while not hold.ensure() and time.time() < deadline:
    time.sleep(0.02)
assert hold.holds(), "child never acquired the lease"
print(json.dumps({"pid": os.getpid(), "epoch": hold.epoch}), flush=True)
while True:          # renew hot, so the SIGKILL lands mid-renew loop
    hold.ensure()
    time.sleep(0.02)
"""


class TestLeaseChurn:
    store = ""  # a class of io/log_store.py; "" keeps the default

    def test_sigkill_holder_takeover_no_double_execution(self, tmp_path):
        src = str(tmp_path / "src")
        os.makedirs(src)
        _write_part(src, "part-00000000.parquet", 0, 2000, 5)
        ttl = 1.0
        s = _session(tmp_path, ttl_s=ttl, store=self.store)
        s.conf.num_buckets = 4
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(src),
                        IndexConfig("lix", ["k"], ["v"]))
        # A pending refresh the eventual holder must run exactly once.
        _write_part(src, "part-00010000.parquet", 2000, 200, 6)

        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-c", _HOLDER_CHILD, str(tmp_path / "ix"),
             str(ttl), self.store],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        try:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            child = json.loads(line)
            recs = hs.maintenance_cycle()
            assert len(recs) == 1 and recs[0]["outcome"] == "skipped"
            assert "holder-child" in recs[0]["reason"]
            os.kill(child["pid"], signal.SIGKILL)
            proc.wait(timeout=30)
            took_over = False
            deadline = time.monotonic() + ttl + 10.0
            while time.monotonic() < deadline:
                recs = hs.maintenance_cycle()
                if recs and all(r.get("outcome") != "skipped"
                                for r in recs):
                    took_over = True
                    break
                time.sleep(0.2)
            assert took_over, "lease never taken over after SIGKILL"
        finally:
            proc.kill()
            proc.wait(timeout=30)

        rec = lease.status(s.conf)
        assert rec["holder"] != "holder-child"
        assert rec["epoch"] > child["epoch"]
        records = lifecycle_journal.records(s.conf)
        done_actions = [r for r in records
                        if r.get("decision") == "refresh"
                        and r.get("outcome") == "done"]
        assert len(done_actions) == 1, done_actions
        events = _lease_events(s.conf)
        assert "holder-child" in {e["holder"] for e in events}
        takeovers = [e for e in events if e["mode"] == "takeover"]
        assert any(e["epoch"] > child["epoch"] for e in takeovers)


class TestLeaseProtocolPosix(TestLeaseProtocol):
    store = "PosixLogStore"


class TestDaemonGatePosix(TestDaemonGate):
    store = "PosixLogStore"


class TestLeaseChurnPosix(TestLeaseChurn):
    store = "PosixLogStore"
