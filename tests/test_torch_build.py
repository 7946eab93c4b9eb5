"""``create_index`` through hyperspace_tpu_torch (on the CPU) against the
JAX package's on one seeded Parquet source: the same bytes in every
bucket, and the same index-defining fields in the committed log entry.
"""

import hashlib
import os
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.io.parquet import bucket_id_of_file


def _write_source(root, n=4000, n_files=5):
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
        pq.write_table(t.slice(i * step, step),
                       os.path.join(root, f"part-{i:05d}.parquet"))


def _bucket_digests(entry):
    """bucket -> sorted content digests of its files."""
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(digests) for b, digests in out.items()}


def _build(pkg, system_path, data, num_buckets, config, max_rows_per_file=0,
           **session_kw):
    s = pkg.HyperspaceSession(system_path=system_path, **session_kw)
    s.conf.num_buckets = num_buckets
    s.conf.index_max_rows_per_file = max_rows_per_file
    if pkg is hyperspace_tpu_torch:
        # The device route (the CPU default takes the host mirror).
        s.conf.device_build_min_rows = 0
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(data), pkg.IndexConfig(*config))
    return s, hs, s.index_collection_manager.get_index(config[0])


def _index_defining(entry_dict):
    """The fields that define an index: everything but the log id's
    timestamp and where the index data lives on disk (the data files'
    content digests included)."""
    dd = entry_dict["derivedDataset"]
    rel = entry_dict["source"]["plan"]["properties"]["relations"]
    data_files = []

    def walk(node):
        for f in node["files"]:
            data_files.append((bucket_id_of_file(f["name"]), f["size"],
                               f["digest"]))
        for sub in node["subDirs"]:
            walk(sub)

    walk(entry_dict["content"]["root"])
    return {
        "name": entry_dict["name"],
        "state": entry_dict["state"],
        "id": entry_dict["id"],
        "derivedDataset": dd,
        "source": {"relations": rel,
                   "fingerprint": entry_dict["source"]["plan"]["properties"]
                   ["fingerprint"]},
        "properties": entry_dict["properties"],
        "data_files": sorted(data_files),
    }


@pytest.mark.parametrize("num_buckets", [1, 4, 16])
@pytest.mark.parametrize("config", [
    ("ix", ["k"], ["v", "w"]),
    ("ix2", ["s", "w"], ["v"]),
])
def test_port_index_is_bit_equal_to_jax(tmp_path, num_buckets, config):
    data = str(tmp_path / "data")
    _write_source(data)
    js, jhs, jentry = _build(hyperspace_tpu, str(tmp_path / "jax"), data,
                             num_buckets, config)
    ts, ths, tentry = _build(hyperspace_tpu_torch, str(tmp_path / "torch"),
                             data, num_buckets, config, device="cpu")
    assert _bucket_digests(tentry) == _bucket_digests(jentry)
    assert len(_bucket_digests(tentry)) == min(num_buckets, 4000)
    assert _index_defining(tentry.to_dict()) == _index_defining(jentry.to_dict())
    location = "indexLocation"
    jrows = [{k: v for k, v in r.items() if k != location}
             for r in jhs.indexes().to_pylist()]
    trows = [{k: v for k, v in r.items() if k != location}
             for r in ths.indexes().to_pylist()]
    assert trows == jrows
    assert ts.build_stats_log[-1]["index"] == config[0]


def test_split_bucket_runs_are_bit_equal_to_jax(tmp_path):
    """``index_max_rows_per_file`` cuts each bucket's sorted run into
    several files, the same cuts in both packages."""
    data = str(tmp_path / "data")
    _write_source(data)
    config = ("ix", ["k"], ["v", "w"])
    _, _, jentry = _build(hyperspace_tpu, str(tmp_path / "jax"), data, 4,
                          config, max_rows_per_file=300)
    _, _, tentry = _build(hyperspace_tpu_torch, str(tmp_path / "torch"), data,
                          4, config, max_rows_per_file=300, device="cpu")
    digests = _bucket_digests(tentry)
    assert digests == _bucket_digests(jentry)
    assert sum(len(d) for d in digests.values()) > 4


def test_entry_reads_back_through_the_log(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    s, hs, entry = _build(hyperspace_tpu_torch, str(tmp_path / "torch"), data,
                          4, ("ix", ["k"], ["v"]), device="cpu")
    mgr = s.index_collection_manager
    assert [e.name for e in mgr.get_indexes(["ACTIVE"])] == ["ix"]
    assert mgr.get_index("IX").to_dict() == entry.to_dict()  # case-insensitive
    log_dir = os.path.join(str(tmp_path / "torch"), "ix", "_hyperspace_log")
    assert sorted(os.listdir(log_dir)) == ["1", "2", "latestStable"]
    assert mgr._log_manager("ix").get_log(1).state == "CREATING"


def test_create_refuses_an_existing_index(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    s, hs, _ = _build(hyperspace_tpu_torch, str(tmp_path / "torch"), data, 4,
                      ("ix", ["k"], ["v"]), device="cpu")
    with pytest.raises(hyperspace_tpu_torch.HyperspaceError, match="already"):
        hs.create_index(s.read.parquet(data),
                        hyperspace_tpu_torch.IndexConfig("ix", ["k"], ["v"]))


def test_create_refuses_unknown_columns(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    s = hyperspace_tpu_torch.HyperspaceSession(str(tmp_path / "torch"),
                                               device="cpu")
    with pytest.raises(hyperspace_tpu_torch.HyperspaceError, match="resolve"):
        hyperspace_tpu_torch.Hyperspace(s).create_index(
            s.read.parquet(data),
            hyperspace_tpu_torch.IndexConfig("ix", ["nope"], ["v"]))
