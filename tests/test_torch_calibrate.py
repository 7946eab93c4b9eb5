"""Calibrated routing thresholds in the port, held to the JAX package's
utils/calibrate.py: the same thresholds from the same profile, the same
static constants, explicit values winning, one probe per device, the
CPU's routes, and a build below the build threshold writing the same
bytes through its host mirror."""

from __future__ import annotations

import hashlib
import os
import threading
import time
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.utils import calibrate as jax_cal
from hyperspace_tpu_torch.actions import create as torch_create
from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
from hyperspace_tpu_torch.utils import calibrate as torch_cal

KINDS = tuple(jax_cal.STATIC_MIN_ROWS)


def _profiles():
    """Latency x bandwidth x host rates, drawn from a seed: a remote
    tunnel's physics through a card on its own bus, with and without a
    measured join_agg rate."""
    rng = np.random.default_rng(17)
    out = []
    for latency in (1e-1, 2e-3, 2e-4, 3e-5):
        for bandwidth in (4e6, 2e8, 1.2e10, 2e11):
            rates = {k: float(10 ** rng.uniform(6.5, 9.3))
                     for k in ("filter", "join", "agg", "build")}
            if rng.random() < 0.5:
                rates["join_agg"] = 1.0 / (1.0 / rates["join"]
                                           + 1.0 / rates["agg"])
            out.append((latency, bandwidth, rates))
    return out


@pytest.mark.parametrize("latency,bandwidth,rates", _profiles())
def test_thresholds_equal_the_jax_packages(latency, bandwidth, rates):
    kw = dict(latency_s=latency, h2d_bytes_per_s=bandwidth,
              d2h_bytes_per_s=bandwidth / 2, host_rows_per_s=rates)
    jp = jax_cal.DeviceProfile(platform="tpu", **kw)
    tp = torch_cal.DeviceProfile(platform="cuda", **kw)
    for kind in KINDS:
        assert tp.min_rows(kind) == jp.min_rows(kind), kind
        assert tp.resident_min_rows(kind) == jp.resident_min_rows(kind), kind


def test_static_constants_equal():
    assert torch_cal.STATIC_MIN_ROWS == jax_cal.STATIC_MIN_ROWS
    assert torch_cal.STATIC_RESIDENT_MIN_ROWS == jax_cal.STATIC_RESIDENT_MIN_ROWS
    assert torch_cal.NEVER_MIN_ROWS == jax_cal.NEVER_MIN_ROWS
    assert torch_cal._BYTES_PER_ROW == jax_cal._BYTES_PER_ROW


@pytest.mark.parametrize("calibrate", ["0", "1"])
def test_disabled_calibration_and_the_cpu_give_the_static_constants(
        monkeypatch, calibrate):
    """HS_CALIBRATE=0 keeps the constants on any device; the CPU keeps
    them with calibration on, and is never probed for routing."""
    monkeypatch.setenv("HS_CALIBRATE", calibrate)

    def no_probe(device):
        raise AssertionError(f"probed {device}")

    monkeypatch.setattr(torch_cal, "_probe_transfer", no_probe)
    conf = hyperspace_tpu_torch.HyperspaceConf()
    devices = ["cpu"] if calibrate == "1" else ["cpu", "cuda"]
    monkeypatch.setenv("HS_CALIBRATE", "0")
    jconf = hyperspace_tpu.HyperspaceConf()
    want = {k: jconf.device_min_rows(k) for k in KINDS}
    want_res = {k: jconf.resident_min_rows(k) for k in KINDS}
    monkeypatch.setenv("HS_CALIBRATE", calibrate)
    for device in devices:
        assert {k: conf.device_min_rows(k, device) for k in KINDS} == want
        assert {k: conf.resident_min_rows(k, device) for k in KINDS} == want_res
    assert want == torch_cal.STATIC_MIN_ROWS


def test_explicit_value_wins_and_an_explicit_join_governs_join_agg(monkeypatch):
    local = torch_cal.DeviceProfile(
        platform="cuda", latency_s=2e-4, h2d_bytes_per_s=12e9,
        d2h_bytes_per_s=12e9,
        host_rows_per_s={"filter": 1.2e9, "join": 3e7, "agg": 2e7,
                         "build": 2.5e7})
    jlocal = jax_cal.DeviceProfile(
        platform="tpu", latency_s=local.latency_s,
        h2d_bytes_per_s=local.h2d_bytes_per_s,
        d2h_bytes_per_s=local.d2h_bytes_per_s,
        host_rows_per_s=dict(local.host_rows_per_s))
    monkeypatch.setattr(torch_cal, "device_profile",
                        lambda device, refresh=False: local)
    monkeypatch.setattr(jax_cal, "device_profile", lambda refresh=False: jlocal)
    conf = hyperspace_tpu_torch.HyperspaceConf()
    jconf = hyperspace_tpu.HyperspaceConf()
    for kind in KINDS:
        assert conf.device_min_rows(kind, "cuda") == jconf.device_min_rows(kind)
        assert conf.resident_min_rows(kind, "cuda") \
            == jconf.resident_min_rows(kind)
    # join_agg is a kind of its own (40 bytes a row) ...
    assert conf.device_min_rows("join_agg", "cuda") == local.min_rows("join_agg")
    assert local.min_rows("join_agg") != local.min_rows("join")
    # ... until the join threshold is set.
    for c in (conf, jconf):
        c.device_join_min_rows = 123
        c.device_resident_min_rows = 7
    assert conf.device_min_rows("join", "cuda") == 123
    assert conf.device_min_rows("join_agg", "cuda") \
        == jconf.device_min_rows("join_agg") == 123
    assert conf.resident_min_rows("agg", "cuda") \
        == jconf.resident_min_rows("agg") == 7
    conf.device_join_min_rows = None
    assert conf.device_min_rows("join", "cuda") == local.min_rows("join")


def test_concurrent_first_calls_probe_once(monkeypatch):
    monkeypatch.setenv("HS_CALIBRATE", "1")
    monkeypatch.setattr(torch_cal, "_PROFILES", {})
    monkeypatch.setattr(torch_cal, "_FAILED", set())
    calls = []

    def slow_probe(device):
        calls.append(str(device))
        time.sleep(0.05)
        return "cuda", 1e-4, 1e10, 1e10

    monkeypatch.setattr(torch_cal, "_probe_transfer", slow_probe)
    monkeypatch.setattr(torch_cal, "_probe_host_rates",
                        lambda: {k: 1e8 for k in KINDS})
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(torch_cal.device_profile("cuda:0")))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["cuda:0"]
    assert len(got) == 8 and all(p is got[0] for p in got)
    # Another device gets its own probe.
    torch_cal.device_profile("cuda:1")
    assert calls == ["cuda:0", "cuda:1"]


def test_a_failed_probe_keeps_the_static_constants(monkeypatch):
    monkeypatch.setenv("HS_CALIBRATE", "1")
    monkeypatch.setattr(torch_cal, "_PROFILES", {})
    monkeypatch.setattr(torch_cal, "_FAILED", set())

    def broken(device):
        raise RuntimeError("no card")

    monkeypatch.setattr(torch_cal, "_probe_transfer", broken)
    for kind in KINDS:
        assert torch_cal.calibrated_min_rows(kind, "cuda:0") \
            == torch_cal.STATIC_MIN_ROWS[kind]
    summary = torch_cal.profile_summary("cuda:0")
    assert summary == {
        "calibrated": False,
        "thresholds": dict(torch_cal.STATIC_MIN_ROWS),
        "resident_thresholds": dict(torch_cal.STATIC_RESIDENT_MIN_ROWS)}
    with pytest.raises(KeyError):
        torch_cal.calibrated_min_rows("scan", "cuda:0")


def test_real_probe_smoke_on_the_cpu(monkeypatch):
    """The probe runs on the CPU: positive physics, valid thresholds,
    cached; the CPU still routes by the constants."""
    monkeypatch.setenv("HS_CALIBRATE", "1")
    monkeypatch.setattr(torch_cal, "_PROFILES", {})
    profile = torch_cal.device_profile("cpu", refresh=True)
    assert profile is not None and profile.platform == "cpu"
    assert profile.latency_s > 0
    assert profile.h2d_bytes_per_s > 0 and profile.d2h_bytes_per_s > 0
    for kind, rate in profile.host_rows_per_s.items():
        assert rate > 0, kind
        assert 0 < profile.min_rows(kind) <= torch_cal.NEVER_MIN_ROWS
    assert torch_cal.device_profile("cpu") is profile
    summary = torch_cal.profile_summary("cpu")
    assert summary["calibrated"] is True
    assert summary["thresholds"] == torch_cal.STATIC_MIN_ROWS
    assert summary["resident_thresholds"] == torch_cal.STATIC_RESIDENT_MIN_ROWS


# ---------------------------------------------------------------------------
# routes of a default CPU session
# ---------------------------------------------------------------------------
def _write(path, cols, files=2):
    os.makedirs(path)
    t = pa.table(cols)
    step = -(-t.num_rows // files)
    for f in range(files):
        pq.write_table(t.slice(f * step, step),
                       os.path.join(path, f"part-{f:05d}.parquet"))


def _routes(stats):
    return {k: [d["strategy"] for d in stats.get(k, [])]
            for k in ("filters", "joins", "join_kernels", "aggregates")}


def test_a_default_cpu_session_routes_as_the_jax_package(tmp_path):
    """No threshold set: filters, joins and grouped aggregates take the
    host in both packages, with the same answers."""
    rng = np.random.default_rng(3)
    _write(str(tmp_path / "o"), {"ok": np.arange(300, dtype=np.int64),
                                 "cust": rng.integers(0, 9, 300)})
    _write(str(tmp_path / "l"), {"lk": rng.integers(0, 300, 1200),
                                 "p": rng.random(1200)})
    got = {}
    for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
        kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
        s = pkg.HyperspaceSession(str(tmp_path / pkg.__name__), **kw)
        s.conf.num_buckets = 4
        if pkg is hyperspace_tpu:
            s.conf.mesh_enabled = "off"
            s.conf.parallel_build = "off"
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(str(tmp_path / "o")),
                        pkg.IndexConfig("oi", ["ok"], ["cust"]))
        hs.create_index(s.read.parquet(str(tmp_path / "l")),
                        pkg.IndexConfig("li", ["lk"], ["p"]))
        s.enable_hyperspace()
        c = pkg.col
        o, li = s.read.parquet(str(tmp_path / "o")), s.read.parquet(str(tmp_path / "l"))
        queries = {
            "filter": li.filter(c("lk") < 100).select("lk", "p"),
            "join": o.join(li, c("ok") == c("lk")).select("ok", "p"),
            "agg": o.group_by("cust").agg(n=("ok", "count")).sort("cust"),
        }
        out = {}
        for name, ds in queries.items():
            rows = ds.collect()
            out[name] = (sorted(rows.to_pylist(), key=repr),
                         _routes(s.last_execution_stats))
        got[pkg.__name__] = out
    assert got["hyperspace_tpu_torch"] == got["hyperspace_tpu"]
    routes = got["hyperspace_tpu_torch"]
    assert routes["filter"][1]["filters"] == ["host"]
    assert routes["join"][1]["join_kernels"] == ["host"] * 4
    assert routes["agg"][1]["aggregates"] == []


# ---------------------------------------------------------------------------
# the build's host mirror
# ---------------------------------------------------------------------------
def _digests(entry):
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(v) for b, v in out.items()}


@pytest.mark.parametrize("batch_rows", [1 << 20, 1500], ids=["monolithic", "spilled"])
def test_a_build_below_the_threshold_writes_the_device_routes_bytes(
        tmp_path, monkeypatch, batch_rows):
    rng = np.random.default_rng(11)
    data = str(tmp_path / "data")
    _write(data, {"k": rng.integers(0, 700, 5000),
                  "s": np.array([f"s{x}" for x in rng.integers(0, 40, 5000)]),
                  "v": rng.random(5000)}, files=4)
    calls = defaultdict(int)
    for name in ("bucket_sort_permutation_np", "route_partition_np",
                 "bucket_sort_permutation", "route_partition"):
        real = getattr(torch_create, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(torch_create, name, counted)
    digests = {}
    for label, pkg, build_min in (("jax", hyperspace_tpu, None),
                                  ("host", hyperspace_tpu_torch, None),
                                  ("explicit", hyperspace_tpu_torch, 1 << 30),
                                  ("device", hyperspace_tpu_torch, 0)):
        kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
        s = pkg.HyperspaceSession(str(tmp_path / label), **kw)
        s.conf.num_buckets = 8
        s.conf.device_batch_rows = batch_rows
        if pkg is hyperspace_tpu:
            s.conf.parallel_build = "off"
        else:
            s.conf.device_build_min_rows = build_min
        calls.clear()
        pkg.Hyperspace(s).create_index(s.read.parquet(data),
                                       pkg.IndexConfig("ix", ["k", "s"], ["v"]))
        digests[label] = _digests(s.index_collection_manager.get_index("ix"))
        if pkg is hyperspace_tpu_torch:
            host = calls["bucket_sort_permutation_np"] + calls["route_partition_np"]
            device = calls["bucket_sort_permutation"] + calls["route_partition"]
            assert (host > 0, device > 0) == (label != "device",
                                              label == "device"), (label, calls)
            if batch_rows < 5000:
                assert calls["route_partition_np" if label != "device"
                             else "route_partition"] == 4
    assert digests["host"] == digests["device"] == digests["jax"] \
        == digests["explicit"]
    assert len(digests["host"]) == 8
