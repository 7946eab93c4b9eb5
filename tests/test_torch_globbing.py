"""Glob roots and the globbing pattern through the port, held to the JAX
package: the four glob cases of tests/test_globbing.py, each through
both packages over the same directories (made from numpy): the rows
read, the log entry's ``root_paths``, the refresh that finds a new
directory, the rejection of a pattern that misses a root, and a
literal path with glob characters.  Then the same over a CSV source and
a hive-partitioned tree read through a glob.

The five conf-key cases of tests/test_globbing.py (the legacy and
canonical string keys) have no counterpart: the port's conf has fields,
not string keys."""

from __future__ import annotations

import hashlib
import os
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)


def _name(pkg) -> str:
    return "jax" if pkg is JAX else "torch"


def _session(pkg, root: str):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=os.path.join(root, _name(pkg)),
                              **kw)
    s.conf.num_buckets = 2
    if pkg is JAX:
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    return s


def _write(dirpath, start, n, fmt="parquet"):
    os.makedirs(dirpath, exist_ok=True)
    t = pa.table({
        "id": np.arange(start, start + n, dtype=np.int64),
        "name": pa.array([f"n{i}" for i in range(start, start + n)]),
    })
    if fmt == "csv":
        import pyarrow.csv as pacsv

        pacsv.write_csv(t, os.path.join(dirpath, "part-0.csv"))
    else:
        pq.write_table(t, os.path.join(dirpath, "part-0.parquet"))


def _bucket_digests(entry) -> dict:
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[os.path.basename(f.name)[:12]].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(d) for b, d in out.items()}


def _index_scans(plan) -> list:
    return [s.relation.index_scan_of for s in plan.leaf_relations()
            if s.relation.index_scan_of]


class TestGlobRead:
    def test_glob_path_reads_all_matching_dirs(self, tmp_path):
        _write(str(tmp_path / "data" / "d1"), 0, 5)
        _write(str(tmp_path / "data" / "d2"), 5, 5)
        got = {_name(pkg): _session(pkg, str(tmp_path)).read.parquet(
            str(tmp_path / "data" / "*")).collect() for pkg in PKGS}
        assert got["torch"].num_rows == 10
        assert got["torch"].equals(got["jax"])


class TestGlobbingPattern:
    @pytest.mark.parametrize("fmt", ["parquet", "csv"])
    def test_create_records_pattern_and_refresh_picks_up_new_dir(
            self, tmp_path, fmt):
        d1 = str(tmp_path / "data" / "2024")
        _write(d1, 0, 10, fmt)
        pattern = str(tmp_path / "data" / "*")
        sessions = {}
        for pkg in PKGS:
            s = _session(pkg, str(tmp_path))
            s.conf.globbing_pattern = pattern
            hs = pkg.Hyperspace(s)
            hs.create_index(s.read.format(fmt).load(d1),
                            pkg.IndexConfig("gidx", ["id"], ["name"]))
            entry = s.index_collection_manager.get_index("gidx")
            assert entry.relations[0].root_paths == [pattern]
            sessions[_name(pkg)] = (s, hs)
        _write(str(tmp_path / "data" / "2025"), 100, 5, fmt)
        out = {}
        for pkg in PKGS:
            s, hs = sessions[_name(pkg)]
            summary = hs.refresh_index("gidx", "incremental")
            assert (summary.outcome, summary.appended) == ("ok", 1)
            s.conf.globbing_pattern = ""
            s.enable_hyperspace()
            ds = s.read.format(fmt).load(pattern) \
                .filter(pkg.col("id") == 104).select("id", "name")
            assert _index_scans(ds.optimized_plan()) == ["gidx"]
            entry = s.index_collection_manager.get_index("gidx")
            out[_name(pkg)] = (ds.collect(), _bucket_digests(entry),
                               entry.relations[0].root_paths)
        assert out["torch"][0].num_rows == 1
        assert out["torch"][0].equals(out["jax"][0])
        assert out["torch"][1] == out["jax"][1]
        assert out["torch"][2] == out["jax"][2] == [pattern]

    def test_pattern_not_covering_roots_rejected(self, tmp_path):
        d1 = str(tmp_path / "data" / "d1")
        elsewhere = str(tmp_path / "other" / "d2")
        _write(d1, 0, 5)
        _write(elsewhere, 5, 5)
        for pkg in PKGS:
            from importlib import import_module

            s = _session(pkg, str(tmp_path))
            s.conf.globbing_pattern = str(tmp_path / "data" / "*")
            error = import_module(f"{pkg.__name__}.exceptions").HyperspaceError
            with pytest.raises(error, match="globbing pattern"):
                pkg.Hyperspace(s).create_index(
                    s.read.parquet(elsewhere),
                    pkg.IndexConfig("gidx", ["id"], ["name"]))
            assert s.index_collection_manager.get_index("gidx") is None

    def test_literal_path_with_glob_chars_not_expanded(self, tmp_path):
        from hyperspace_tpu.io.files import list_data_files as jax_list
        from hyperspace_tpu_torch.io.files import list_data_files

        weird = tmp_path / "run[1]"
        weird.mkdir()
        (weird / "f.parquet").write_bytes(b"x")
        decoy = tmp_path / "run1"
        decoy.mkdir()
        (decoy / "g.parquet").write_bytes(b"y")
        got = list_data_files([str(weird)])
        assert len(got) == 1
        assert "run[1]" in got[0].name
        assert [(f.name, f.size, f.mtime) for f in got] == \
            [(f.name, f.size, f.mtime) for f in jax_list([str(weird)])]


def test_expand_globs_equals_the_jax_package(tmp_path):
    from hyperspace_tpu.io.files import expand_globs as jax_expand
    from hyperspace_tpu_torch.io.files import expand_globs

    for d in ("a1", "a2", "b1", "run[1]"):
        (tmp_path / d).mkdir()
    roots = [str(tmp_path / "a*"), str(tmp_path / "?1"),
             str(tmp_path / "run[1]"), str(tmp_path / "none*"),
             str(tmp_path / "b1")]
    assert expand_globs(roots) == jax_expand(roots)
    assert expand_globs(roots)[:2] == [str(tmp_path / "a1"),
                                       str(tmp_path / "a2")]


def test_glob_over_hive_partitions(tmp_path):
    """A glob that names the partition directories reads their files with
    no partition column (only segments below a root count); the tree's
    root reads it, and both agree with the JAX package."""
    root = tmp_path / "data"
    for k in (0, 1, 2):
        _write(str(root / f"k={k}"), 10 * k, 3)
    out = {}
    for pkg in PKGS:
        s = _session(pkg, str(tmp_path))
        out[_name(pkg)] = (s.read.parquet(str(root / "k=*")).collect(),
                           s.read.parquet(str(root)).collect())
    for i in (0, 1):
        assert out["torch"][i].equals(out["jax"][i])
    assert out["torch"][0].column_names == ["id", "name"]
    assert out["torch"][1].column("k").to_pylist() == [0] * 3 + [1] * 3 \
        + [2] * 3
