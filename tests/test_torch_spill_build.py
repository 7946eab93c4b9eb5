"""The spill build and the lifecycle verbs of hyperspace_tpu_torch (on the
CPU) against the JAX package's, on one seeded Parquet source (4,000 rows
in 5 files, ``device_batch_rows=512``, so 8 chunks spill): the same bytes
in every bucket, and the same log states, index files and outcomes.
"""

import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.io.parquet import bucket_id_of_file
from hyperspace_tpu.ops.hash import route_partition_np
from hyperspace_tpu_torch.actions import create as torch_create
from hyperspace_tpu_torch.ops.hash import route_partition

N_ROWS = 4000
BATCH = 512


def _write_source(root, n=N_ROWS, n_files=5, drop_last=None):
    """The seeded source; ``drop_last`` names a column the last file lacks
    (a column added to the source after that file was written)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(11)
    t = pa.table({
        "k": pa.array(rng.integers(0, 700, n), type=pa.int64()),
        "s": pa.array([f"key-{v:04d}" for v in rng.integers(0, 300, n)]),
        "v": pa.array(rng.random(n)),
        "w": pa.array(rng.integers(-50, 50, n), type=pa.int32()),
    })
    step = -(-n // n_files)
    for i in range(n_files):
        part = t.slice(i * step, step)
        if drop_last is not None and i == n_files - 1:
            part = part.drop_columns([drop_last])
        pq.write_table(part, os.path.join(root, f"part-{i:05d}.parquet"))


def _append_file(data, name="part-90000.parquet", k=9999):
    pq.write_table(pa.table({
        "k": pa.array([k, k + 1], type=pa.int64()),
        "s": pa.array(["key-9999", "key-0001"]),
        "v": pa.array([0.5, 0.25]),
        "w": pa.array([1, 2], type=pa.int32()),
    }), os.path.join(data, name))


def _session(pkg, system_path, num_buckets=4, batch_rows=BATCH,
             pipelined=True, max_rows_per_file=0):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = pkg.HyperspaceSession(system_path=system_path, **kw)
    s.conf.num_buckets = num_buckets
    s.conf.device_batch_rows = batch_rows
    s.conf.build_pipeline_enabled = pipelined
    s.conf.index_max_rows_per_file = max_rows_per_file
    if pkg is hyperspace_tpu:
        s.conf.parallel_build = "off"  # the single-chip spill path
    else:
        # The device routes (the CPU defaults take the host mirror).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{kind}_min_rows", 0)
    return s


def _build(pkg, system_path, data, config, **conf):
    s = _session(pkg, system_path, **conf)
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(data), pkg.IndexConfig(*config))
    return s, hs, s.index_collection_manager.get_index(config[0])


def _bucket_digests(entry):
    """bucket -> sorted content digests of its files."""
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(digests) for b, digests in out.items()}


def _index_defining(entry):
    """The fields that define a log entry: everything but its timestamp and
    where the index data lives on disk."""
    d = entry.to_dict()
    data_files = []

    def walk(node, base):
        path = os.path.join(base, node["name"]) if base else node["name"]
        for f in node["files"]:
            data_files.append((os.path.basename(path),
                               bucket_id_of_file(f["name"]), f["size"],
                               f["digest"]))
        for sub in node["subDirs"]:
            walk(sub, path)

    walk(d["content"]["root"], "")
    return {
        "name": d["name"], "state": d["state"], "id": d["id"],
        "derivedDataset": d["derivedDataset"],
        "source": d["source"], "properties": d["properties"],
        "data_files": sorted(data_files),
    }


def _on_disk(system_path, name):
    """The index directory's layout: log ids and, per version directory,
    its data files' buckets.  The JAX package's per-version
    ``_sketch.parquet`` is not ported and not compared."""
    root = os.path.join(system_path, name)
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out[rel] = sorted(bucket_id_of_file(f) if f.startswith("part-")
                          else f for f in files if f != "_sketch.parquet")
    return out


def _both(tmp_path, data, config, **conf):
    """The same build through both packages."""
    j = _build(hyperspace_tpu, str(tmp_path / "jax"), data, config, **conf)
    t = _build(hyperspace_tpu_torch, str(tmp_path / "torch"), data, config,
               **conf)
    return j, t


@pytest.mark.parametrize("num_buckets", [1, 4])
@pytest.mark.parametrize("max_rows_per_file", [0, 257])
@pytest.mark.parametrize("key", ["k", "s"])
@pytest.mark.parametrize("pipelined", [True, False])
def test_spill_build_is_bit_equal_to_jax(tmp_path, pipelined, key,
                                         max_rows_per_file, num_buckets):
    data = str(tmp_path / "data")
    _write_source(data)
    (_, _, jentry), (ts, _, tentry) = _both(
        tmp_path, data, ("ix", [key], ["v", "w"]), num_buckets=num_buckets,
        pipelined=pipelined, max_rows_per_file=max_rows_per_file)
    phases = ts.build_stats_log[-1]
    assert "spill_route_s" in phases and "spill_finish_s" in phases
    assert ("finalize_s" in phases) == pipelined
    digests = _bucket_digests(tentry)
    assert digests == _bucket_digests(jentry)
    assert len(digests) == num_buckets
    if max_rows_per_file:
        assert sum(len(d) for d in digests.values()) > num_buckets
    assert _index_defining(tentry) == _index_defining(jentry)


@pytest.mark.parametrize("key", ["k", "s"])
def test_spill_build_is_bit_equal_to_the_monolithic_build(tmp_path, key):
    data = str(tmp_path / "data")
    _write_source(data)
    config = ("ix", [key], ["v", "w"])
    s1, _, spilled = _build(hyperspace_tpu_torch, str(tmp_path / "a"), data,
                            config)
    s2, _, mono = _build(hyperspace_tpu_torch, str(tmp_path / "b"), data,
                         config, batch_rows=1 << 20)
    assert "spill_route_s" in s1.build_stats_log[-1]
    assert "kernel_s" in s2.build_stats_log[-1]
    assert _bucket_digests(spilled) == _bucket_digests(mono)


def test_two_column_key_spill_is_bit_equal_to_jax(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    (_, _, jentry), (_, _, tentry) = _both(tmp_path, data,
                                           ("ix2", ["s", "w"], ["v"]))
    assert _bucket_digests(tentry) == _bucket_digests(jentry)
    assert _index_defining(tentry) == _index_defining(jentry)


@pytest.mark.parametrize("batch_rows", [BATCH, 1 << 20])
def test_a_file_without_an_included_column_reads_as_nulls(tmp_path,
                                                          batch_rows):
    data = str(tmp_path / "data")
    _write_source(data, drop_last="w")
    (_, _, jentry), (_, _, tentry) = _both(
        tmp_path, data, ("ix", ["k"], ["v", "w"]), batch_rows=batch_rows)
    assert _bucket_digests(tentry) == _bucket_digests(jentry)
    nulls = sum(pq.read_table(f.name).column("w").null_count
                for f in tentry.content.file_infos())
    assert nulls == N_ROWS // 5


def test_a_source_of_exactly_one_batch_does_not_spill(tmp_path, monkeypatch):
    data = str(tmp_path / "data")
    _write_source(data)
    made = []
    real_mkdtemp = tempfile.mkdtemp

    def mkdtemp(*args, **kwargs):
        made.append(kwargs.get("prefix"))
        return real_mkdtemp(*args, **kwargs)

    monkeypatch.setattr(torch_create.tempfile, "mkdtemp", mkdtemp)
    config = ("ix", ["k"], ["v", "w"])
    s1, _, whole = _build(hyperspace_tpu_torch, str(tmp_path / "a"), data,
                          config, batch_rows=N_ROWS)
    assert made == []
    assert "spill_route_s" not in s1.build_stats_log[-1]
    s2, _, spilled = _build(hyperspace_tpu_torch, str(tmp_path / "b"), data,
                            config, batch_rows=N_ROWS - 1)
    assert len(made) == 1 and made[0].startswith("hs_build_spill_")
    assert "spill_route_s" in s2.build_stats_log[-1]
    assert _bucket_digests(whole) == _bucket_digests(spilled)


def test_reap_only_provably_dead_owners(tmp_path):
    root = str(tmp_path / "tmproot")
    os.makedirs(root)
    # A pid that existed and is now provably dead.
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = os.path.join(root, f"hs_build_spill_{proc.pid}_abc")
    mine = os.path.join(root, f"hs_build_spill_{os.getpid()}_def")
    legacy = os.path.join(root, "hs_build_spill_legacy")
    other = os.path.join(root, "something_else")
    for d in (dead, mine, legacy, other):
        os.makedirs(d)
    assert torch_create.reap_orphan_spill_dirs(tmp_root=root) == 1
    assert not os.path.exists(dead)
    assert os.path.exists(mine)     # our own live build
    assert os.path.exists(legacy)   # ownership unprovable: left
    assert os.path.exists(other)    # not a spill dir


@pytest.mark.parametrize("pipelined", [True, False])
def test_a_failed_route_propagates_and_leaves_no_spill_dir(tmp_path,
                                                           monkeypatch,
                                                           pipelined):
    data = str(tmp_path / "data")
    _write_source(data)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    calls = []
    lock = threading.Lock()

    def broken(*args):
        with lock:
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("route failed")
        return route_partition(*args)

    monkeypatch.setattr(torch_create, "route_partition", broken)
    s = _session(hyperspace_tpu_torch, str(tmp_path / "torch"),
                 pipelined=pipelined)
    with pytest.raises(RuntimeError, match="route failed"):
        hyperspace_tpu_torch.Hyperspace(s).create_index(
            s.read.parquet(data),
            hyperspace_tpu_torch.IndexConfig("ix", ["k"], ["v"]))
    assert len(calls) >= 3
    assert os.listdir(str(tmp)) == []
    assert s.index_collection_manager.get_index("ix") is None


@pytest.mark.parametrize("num_buckets", [1, 7, 200])
@pytest.mark.parametrize("n_order", [0, 1, 2])
def test_route_partition_matches_the_jax_host_mirror(num_buckets, n_order):
    rng = np.random.default_rng(num_buckets * 10 + n_order)
    n = 3001
    # Few distinct values: many ties, whose order is part of the bytes.
    words = [rng.integers(0, 40, (n, 2)).astype(np.uint32) for _ in range(2)]
    order = [rng.integers(0, 5, (n, 2)).astype(np.uint32)
             for _ in range(n_order)]
    perm, counts = route_partition(words, order, num_buckets, "cpu")
    want_buckets, want_perm = route_partition_np(words, order, num_buckets)
    assert np.array_equal(perm, want_perm)
    assert np.array_equal(counts,
                          np.bincount(want_buckets, minlength=num_buckets))


def test_full_refresh_after_an_append_is_bit_equal_to_jax(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    config = ("ix", ["k"], ["v", "w"])
    (js, jhs, _), (ts, ths, _) = _both(tmp_path, data, config)
    _append_file(data)
    jsum = jhs.refresh_index("ix", "full")
    tsum = ths.refresh_index("ix", "full")
    assert tsum.to_dict() == jsum.to_dict()
    assert tsum.outcome == "ok" and tsum.appended == 1 and tsum.version == 4
    jentry = js.index_collection_manager.get_index("ix")
    tentry = ts.index_collection_manager.get_index("ix")
    assert _bucket_digests(tentry) == _bucket_digests(jentry)
    assert _index_defining(tentry) == _index_defining(jentry)
    assert _on_disk(str(tmp_path / "torch"), "ix") == \
        _on_disk(str(tmp_path / "jax"), "ix")
    assert "spill_route_s" in ts.build_stats_log[-1]


def test_an_unchanged_source_refreshes_to_noop(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    (js, jhs, _), (ts, ths, _) = _both(tmp_path, data,
                                       ("ix", ["k"], ["v"]))
    before = _on_disk(str(tmp_path / "torch"), "ix")
    jsum = jhs.refresh_index("ix")
    tsum = ths.refresh_index("ix")
    assert tsum.to_dict() == jsum.to_dict()
    assert tsum.outcome == "noop" and tsum.version is None
    assert _on_disk(str(tmp_path / "torch"), "ix") == before


def _transient(pkg, system_path, name, state):
    """Leave ``name`` as an action that died mid-flight leaves it: a
    transient entry above the latest one."""
    s = _session(pkg, system_path)
    log = s.index_collection_manager._log_manager(name)
    entry = log.get_latest_log()
    entry.state = state
    log.write_log_or_raise(log.get_latest_id() + 1, entry)


# Each step: a verb, or ("stuck", state) for an action that died.
_LIFECYCLE = [
    "delete", "restore", ("stuck", "REFRESHING"), "cancel", "delete",
    ("stuck", "RESTORING"), "cancel", "vacuum",
]


def test_lifecycle_verbs_match_jax(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    config = ("ix", ["k"], ["v", "w"])
    _both(tmp_path, data, config)
    _append_file(data)
    paths = {}
    for pkg, name in ((hyperspace_tpu, "jax"), (hyperspace_tpu_torch, "torch")):
        paths[pkg] = str(tmp_path / name)
        s = _session(pkg, paths[pkg])
        assert pkg.Hyperspace(s).refresh_index("ix").outcome == "ok"

    def state(pkg):
        mgr = _session(pkg, paths[pkg]).index_collection_manager
        log = mgr._log_manager("ix")
        return (_index_defining(log.get_latest_log()),
                log.get_latest_stable_log().state,
                _on_disk(paths[pkg], "ix"))

    seen = []
    for step in _LIFECYCLE:
        for pkg in (hyperspace_tpu, hyperspace_tpu_torch):
            if isinstance(step, tuple):
                _transient(pkg, paths[pkg], "ix", step[1])
            else:
                hs = pkg.Hyperspace(_session(pkg, paths[pkg]))
                getattr(hs, step if step == "cancel" else f"{step}_index")("ix")
        tstate = state(hyperspace_tpu_torch)
        assert tstate == state(hyperspace_tpu), step
        seen.append(tstate[0]["state"])
    assert seen == ["DELETED", "ACTIVE", "REFRESHING", "ACTIVE", "DELETED",
                    "RESTORING", "DELETED", "DOESNOTEXIST"]
    # Vacuum removed both versions (create and refresh); the log stays.
    assert _on_disk(paths[hyperspace_tpu_torch], "ix").keys() == \
        {".", "_hyperspace_log"}


@pytest.mark.parametrize("verb, state", [
    ("delete_index", "DELETED"), ("restore_index", "ACTIVE"),
    ("vacuum_index", "ACTIVE"), ("cancel", "ACTIVE"),
    ("refresh_index", "DELETED"),
])
def test_verbs_refuse_the_wrong_state(tmp_path, verb, state):
    data = str(tmp_path / "data")
    _write_source(data)
    s, hs, _ = _build(hyperspace_tpu_torch, str(tmp_path / "torch"), data,
                      ("ix", ["k"], ["v"]))
    if state == "DELETED":
        hs.delete_index("ix")
    before = _on_disk(str(tmp_path / "torch"), "ix")
    with pytest.raises(hyperspace_tpu_torch.HyperspaceError):
        getattr(hs, verb)("ix")
    assert _on_disk(str(tmp_path / "torch"), "ix") == before
