"""The Z-order layout through hyperspace_tpu_torch (on the CPU) against the
JAX package: Morton codes, cell-aligned file cuts, the forced single
bucket, both build paths (monolithic and two-pass), full and incremental
refresh, optimize, repair, and filter pruning on every indexed column.

Each case writes one seeded Parquet source and runs it through both
packages, each in its own system path.  Within a build mode every index
file's sha256 is compared as a set, with the recorded layout and bucket
count, the files a query keeps and its rows in order.  The port's
sessions take the device route (every threshold 0: the torch Z-order
pass on CPU tensors) unless a case runs the host mirror too.  Beyond
tests/test_zorder.py and the Z-order cases of test_external_build,
test_mutable_data and test_datetime: the torch codes bit for bit against
the numpy mirror (ties, negatives, NaN, -0.0, the code's top bit), the
float32 scale step at 60,000,000 rows, the reaping of a dead build's
``hs_zbuild_`` directory, and a Z-order repair against the JAX
package's.
"""

from __future__ import annotations

import datetime
import hashlib
import os
import subprocess
import sys
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch.actions import create as torch_create

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)
ROUTES = ("device", "host")


def _session(pkg, path, route="device", **conf):
    if pkg is TORCH:
        s = TORCH.HyperspaceSession(system_path=path, device="cpu")
        rows = 0 if route == "device" else 1 << 62
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{kind}_min_rows", rows)
    else:
        s = JAX.HyperspaceSession(system_path=path)
        s.conf.parallel_build = "off"
        s.conf.mesh_enabled = "off"
    s.conf.num_buckets = 1
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _both(tmp_path, route="device", tag="ix", **conf):
    """{pkg: (session, Hyperspace)} over separate system paths."""
    out = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{tag}_{pkg.__name__}")
        s = _session(pkg, path, route=route, **conf)
        out[pkg] = (s, pkg.Hyperspace(s))
    return out


def _grid_data(root, n=4096, seed=0):
    """Two independent uniform dimensions (tests/test_zorder.py's)."""
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    pq.write_table(pa.table({
        "x": pa.array(rng.integers(0, 1 << 16, n), type=pa.int64()),
        "y": pa.array(rng.integers(0, 1 << 16, n), type=pa.int64()),
        "payload": pa.array(rng.random(n)),
    }), os.path.join(root, "part-0.parquet"))
    return root


def _split_source(root, table, parts=4):
    os.makedirs(root)
    n = table.num_rows
    for i in range(parts):
        pq.write_table(table.slice(i * n // parts, n // parts),
                       os.path.join(root, f"part-{i:05d}.parquet"))
    return root


def _entry(s, name):
    return s.index_collection_manager.get_index(name)


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _digests(s, name):
    """Sorted sha256 of the index ``name``'s data files."""
    return sorted(_sha256(f.name)
                  for f in _entry(s, name).content.file_infos())


def _recorded(s, name):
    e = _entry(s, name)
    return e.num_buckets, dict(e.derived_dataset.properties), _digests(s, name)


def _require_same_index(sides, name):
    """Both packages' index ``name``: one bucket, layout "zorder", the
    same file bytes; returns the port's recorded triple."""
    got = {pkg: _recorded(s, name) for pkg, (s, _) in sides.items()}
    assert got[TORCH] == got[JAX]
    assert got[TORCH][0] == 1
    assert got[TORCH][1]["layout"] == "zorder"
    return got[TORCH]


def _kept(s, ds, name):
    """((files kept, files in all), sorted sha256 of the kept files) of
    the scan of index ``name``."""
    plan = ds.optimized_plan()
    scans = [x for x in plan.leaf_relations()
             if x.relation.index_scan_of == name]
    assert scans, plan.tree_string()
    rel = scans[0].relation
    files = sorted(_sha256(p) for p in rel.file_paths)
    stats = rel.data_skipping_stats
    return (tuple(stats) if stats is not None
            else (len(files), len(files))), files


def _query_both(sides, data, cond, select, name):
    """The query through both packages: the same files kept (by count
    and by sha256) and the same rows, equal to the scan's answer; returns
    (kept, total).  The rows' order across files follows the files'
    random names, so rows compare sorted; within a file the bytes fix
    it."""
    kept, rows = {}, {}
    keys = [(c, "ascending") for c in select]
    for pkg, (s, _) in sides.items():
        s.enable_hyperspace()
        ds = s.read.parquet(data).filter(cond(pkg.col)).select(*select)
        kept[pkg] = _kept(s, ds, name)
        got = ds.collect().sort_by(keys)
        s.disable_hyperspace()
        assert got.equals(ds.collect().sort_by(keys))
        rows[pkg] = got
    assert kept[TORCH] == kept[JAX]
    assert rows[TORCH].equals(rows[JAX])
    return kept[TORCH][0]


def _zcfg(pkg, name, indexed, included=(), layout="zorder"):
    return pkg.IndexConfig(name, indexed, list(included), layout=layout)


def _file_contents(s, name):
    """Each data file's rows, files in a canonical order (their names
    are random): the layout as content."""
    tables = [pq.read_table(f.name).to_pydict()
              for f in _entry(s, name).content.file_infos()]
    return sorted(tables, key=lambda t: sorted(
        (k, repr(v)) for k, v in t.items()))


# ---------------------------------------------------------------------------
# Codes and cuts
# ---------------------------------------------------------------------------
class TestKernel:
    def test_codes_interleave_ranks(self):
        """tests/test_zorder.py's expected codes, from the port's numpy
        mirror, its torch version and the JAX package's function."""
        from hyperspace_tpu.ops.zorder import (
            zorder_order_words_np as jax_words_np,
        )
        from hyperspace_tpu_torch.ops.zorder import (
            interleave16_np,
            zorder_order_words,
            zorder_order_words_np,
        )

        rng = np.random.default_rng(1)
        n = 512
        cols = []
        for _ in range(3):
            v = rng.permutation(n).astype(np.uint32)
            w = np.zeros((n, 2), np.uint32)
            w[:, 0] = v
            cols.append(w)
        codes = [np.clip(c[:, 0].astype(np.float32) * (65535.0 / (n - 1)),
                         0, 65535).astype(np.uint32) for c in cols]
        ehi, elo = interleave16_np(codes)
        want = np.stack([ehi, elo], axis=1)
        assert np.array_equal(zorder_order_words_np(cols), want)
        assert np.array_equal(jax_words_np(cols), want)
        got = zorder_order_words([torch.from_numpy(c) for c in cols])
        assert np.array_equal(got.numpy().astype(np.uint32), want)

    def test_split_chunks_align_to_cell_boundaries(self):
        from hyperspace_tpu.io.parquet import (
            zorder_split_chunks as jax_split,
        )
        from hyperspace_tpu_torch.io.parquet import zorder_split_chunks

        codes = np.array([0, 1, 2, 3, 3, 5, 6, 7, 12, 13, 14, 15],
                         dtype=np.uint64)
        assert zorder_split_chunks(codes, 4, max_rows_per_file=6) \
            == [(0, 6), (6, 2), (8, 4)]
        big = np.array([0] * 7 + [9] * 2, dtype=np.uint64)
        assert zorder_split_chunks(big, 4, 4) == [(0, 4), (4, 3), (7, 2)]
        assert zorder_split_chunks(codes, 4, 0) == [(0, 12)]
        assert zorder_split_chunks(np.array([], dtype=np.uint64), 4, 4) == []
        rng = np.random.default_rng(5)
        for bits, max_rows in ((32, 37), (48, 100), (64, 7)):
            z = np.sort(rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
                        << np.uint64(64 - bits) >> np.uint64(64 - bits))
            assert zorder_split_chunks(z, bits, max_rows) \
                == jax_split(z, bits, max_rows)

    def test_too_many_columns_rejected(self):
        for pkg in PKGS:
            with pytest.raises(pkg.HyperspaceError,
                               match="Z-order supports at most 4 indexed "
                                     "columns"):
                pkg.IndexConfig("z", ["a", "b", "c", "d", "e"],
                                layout="zorder")
            with pytest.raises(pkg.HyperspaceError,
                               match=r"Unknown layout 'diagonal'; expected "
                                     r"one of \('lexicographic', 'zorder'\)"):
                pkg.IndexConfig("z", ["a"], layout="diagonal")
        # Four columns are the most a 64-bit code holds.
        assert TORCH.IndexConfig("z", ["a", "b", "c", "d"],
                                 layout="zorder").layout == "zorder"


def _order_words_cases(rng, n):
    """Per column kind, the port's order words of a column with ties:
    int64 with negatives, float64 with NaN, -0.0 and 0.0, date32 and
    strings."""
    from hyperspace_tpu_torch.io import columnar

    f = rng.standard_normal(n)
    f[::7] = np.nan
    f[1::5] = -0.0
    f[2::11] = 0.0
    cols = [
        pa.array(rng.integers(-5, 5, n), type=pa.int64()),
        pa.array(f),
        pa.array(rng.integers(-3000, 3000, n).astype("datetime64[D]")),
        pa.array([f"s{v:03d}" for v in rng.integers(0, 40, n)]),
    ]
    return [columnar.to_order_words(c) for c in cols]


@pytest.mark.parametrize("k_cols", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 5, 1000])
def test_torch_codes_equal_the_numpy_mirror(k_cols, n):
    """The torch Z-order pass on CPU tensors against
    ``zorder_order_words_np`` and the JAX package's function, bit for
    bit, and its permutation against numpy's stable argsort of the
    codes; at 4 columns the codes use the top bit."""
    from hyperspace_tpu.ops.zorder import (
        zorder_order_words_np as jax_words_np,
    )
    from hyperspace_tpu_torch.ops.zorder import (
        key64_to_codes,
        words_to_codes64,
        zorder_order_words,
        zorder_order_words_np,
        zorder_sort,
    )

    rng = np.random.default_rng(100 * k_cols + n)
    words = _order_words_cases(rng, n)[:k_cols]
    want = zorder_order_words_np(words)
    assert np.array_equal(want, jax_words_np(words))
    tensors = [torch.from_numpy(w) for w in words]
    got = zorder_order_words(tensors)
    assert got.dtype == torch.int64 and got.shape == (n, 2)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    key, perm = zorder_sort(tensors)
    codes = words_to_codes64(want)
    assert np.array_equal(key64_to_codes(key), codes)
    assert np.array_equal(perm.numpy(), np.argsort(codes, kind="stable"))
    if k_cols == 4 and n == 1000:
        assert (codes >> np.uint64(63)).any()


def test_top_bit_codes_sort_unsigned():
    """Words whose top bit is set sort after the others, as unsigned:
    ranks of [1, 2**63 + 5, 3] are [0, 2, 1]."""
    from hyperspace_tpu_torch.io.columnar import split_words64
    from hyperspace_tpu_torch.ops.zorder import stable_ranks

    keys = np.array([1, (1 << 63) + 5, 3], dtype=np.uint64)
    ranks = stable_ranks(torch.from_numpy(split_words64(keys)))
    assert ranks.tolist() == [0, 2, 1]
    assert ranks.tolist() == np.argsort(np.argsort(keys, kind="stable"),
                                        kind="stable").tolist()


def test_scale_step_at_sf10_rows():
    """The float32 rank scale at n = 60,000,000 (past 2**24, where
    float32 rounds the ranks): sampled ranks, the ends and the values
    around 2**24 and 2**25, against numpy's expression."""
    from hyperspace_tpu_torch.ops.zorder import rank_scale, scale_ranks

    n = 60_000_000
    rng = np.random.default_rng(11)
    edges = np.array([0, 1, 2, n - 2, n - 1, (1 << 24) - 1, 1 << 24,
                      (1 << 24) + 1, (1 << 25) + 3, 33_554_433, 59_999_999],
                     dtype=np.int64)
    ranks = np.concatenate([rng.integers(0, n, 200_000), edges])
    want = np.clip(ranks.astype(np.float32)
                   * (np.float32(65535.0) / np.float32(max(n - 1, 1))),
                   0, 65535).astype(np.uint32)
    got = scale_ranks(torch.from_numpy(ranks), n).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    assert rank_scale(n).dtype == np.float32
    assert got[-7] == 65535 and got[len(ranks) - len(edges)] == 0


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ROUTES)
def test_zorder_forces_single_bucket(tmp_path, route):
    data = _grid_data(str(tmp_path / "data"))
    sides = _both(tmp_path, route=route, num_buckets=16)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data), _zcfg(pkg, "zi", ["x", "y"]))
    _require_same_index(sides, "zi")


@pytest.mark.parametrize("layout", ["zorder", "lexicographic"])
def test_layout_recorded(tmp_path, layout):
    """tests/test_zorder.py's test_zorder_layout_recorded and
    test_lexicographic_unchanged_by_default: the entry records the
    layout, the same in both packages."""
    data = _grid_data(str(tmp_path / "data"))
    sides = _both(tmp_path)
    got = {}
    for pkg, (s, hs) in sides.items():
        indexed = ["x", "y"] if layout == "zorder" else ["x"]
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "ix", indexed, layout=layout))
        got[pkg] = _recorded(s, "ix")
    assert got[TORCH] == got[JAX]
    assert got[TORCH][1]["layout"] == layout


def test_zorder_prunes_on_every_dimension(tmp_path):
    """16 files along the curve: a 1/8 range on EITHER dimension prunes,
    with the JAX package's files kept and rows; a lexicographic index on
    the same columns does not apply to the y-only predicate."""
    data = _grid_data(str(tmp_path / "data"))
    sides = _both(tmp_path, index_max_rows_per_file=256)
    lo, hi = 1000, 9000
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "zi", ["x", "y"], ["payload"]))
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "li", ["x", "y"], ["payload"],
                              layout="lexicographic"))
        hs.delete_index("li")
    _require_same_index(sides, "zi")
    kept = {}
    for dim in ("x", "y"):
        kept[dim] = _query_both(
            sides, data, lambda c, d=dim: (c(d) >= lo) & (c(d) < hi),
            ("x", "y", "payload"), "zi")
    assert kept["x"][0] < 16 and kept["y"][0] < 16, kept
    assert max(kept["x"][0], kept["y"][0]) <= 8, kept
    for pkg, (s, hs) in sides.items():
        hs.restore_index("li")
        hs.delete_index("zi")
        s.enable_hyperspace()
        col = pkg.col
        plan = (s.read.parquet(data).filter((col("y") >= lo) & (col("y") < hi))
                .select("x", "y").optimized_plan())
        assert not [x for x in plan.leaf_relations()
                    if x.relation.index_scan_of], plan.tree_string()


def test_range_on_first_column_prunes_index_files(tmp_path):
    """A lexicographic index gains file pruning on its first column from
    the build's _sketch.parquet; both packages keep the same files."""
    rng = np.random.default_rng(2)
    n = 2000
    data = str(tmp_path / "data")
    os.makedirs(data)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.random(n)),
    }), os.path.join(data, "p.parquet"))
    sides = _both(tmp_path, num_buckets=8)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "ki", ["k"], ["v"], layout="lexicographic"))
    assert _digests(sides[TORCH][0], "ki") == _digests(sides[JAX][0], "ki")
    _query_both(sides, data, lambda c: c("k") == 77, ("k", "v"), "ki")


@pytest.mark.parametrize("deletes", [False, True])
def test_incremental_refresh_appends_zorder_version(tmp_path, deletes):
    """The changed rows' version through the Z-order write (the layout
    pinned), the JAX package's bytes: appended files alone give bucket-0
    files in two versions; with lineage and a deleted file the whole
    index is rewritten as one new version.  The rewrite reads the old
    index in its files' order, which their random names set, so the keys
    are distinct: the codes, and so the bytes, do not depend on it."""
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    rng = np.random.default_rng(3)
    n = 3 * 1024 + 512
    xs = rng.choice(1 << 16, n, replace=False)
    ys = rng.choice(1 << 16, n, replace=False)
    data = str(tmp_path / "data")
    os.makedirs(data)

    def part(name, lo, hi):
        pq.write_table(pa.table({
            "x": pa.array(xs[lo:hi], type=pa.int64()),
            "y": pa.array(ys[lo:hi], type=pa.int64()),
            "payload": pa.array(rng.random(hi - lo)),
        }), os.path.join(data, name))

    for i in range(3):
        part(f"part-{i}.parquet", i * 1024, (i + 1) * 1024)
    sides = _both(tmp_path, index_max_rows_per_file=256,
                  lineage_enabled=deletes)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "zi", ["x", "y"], ["payload"]))
    part("part-append.parquet", 3 * 1024, n)
    if deletes:
        os.remove(os.path.join(data, "part-1.parquet"))
    for pkg, (s, hs) in sides.items():
        hs.refresh_index("zi", "incremental")
    _require_same_index(sides, "zi")
    files = [f.name for f in
             _entry(sides[TORCH][0], "zi").content.file_infos()]
    assert all(bucket_id_of_file(f) == 0 for f in files)
    assert len({os.path.dirname(f) for f in files}) == (1 if deletes else 2)
    _query_both(sides, data, lambda c: c("y") >= (1 << 15),
                ("x", "y", "payload"), "zi")


def test_refresh_keeps_zorder_layout(tmp_path):
    """A full refresh rebuilds Z-order (not lexicographic) and a y-only
    predicate still matches the index."""
    data = _grid_data(str(tmp_path / "data"))
    sides = _both(tmp_path)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "zi", ["x", "y"], ["payload"]))
    pq.write_table(pa.table({
        "x": pa.array([1], type=pa.int64()),
        "y": pa.array([2], type=pa.int64()),
        "payload": pa.array([0.5]),
    }), os.path.join(data, "part-append.parquet"))
    for pkg, (s, hs) in sides.items():
        summary = hs.refresh_index("zi", "full")
        if pkg is TORCH:
            assert (summary.outcome, summary.appended) == ("ok", 1)
    _require_same_index(sides, "zi")
    _query_both(sides, data, lambda c: c("y") >= 0, ("x", "y"), "zi")


@pytest.mark.parametrize("route", ROUTES)
def test_zorder_build_with_reserved_column_name(tmp_path, route):
    """A source column named __z beside the two-pass build's code
    column."""
    rng = np.random.default_rng(0)
    n = 4000
    data = str(tmp_path / "zz")
    os.makedirs(data)
    pq.write_table(pa.table({
        "a": pa.array(np.arange(n, dtype=np.int64)),
        "b": pa.array(rng.random(n)),
        "__z": pa.array(rng.integers(0, 9, n), type=pa.int64()),
    }), os.path.join(data, "p.parquet"))
    sides = _both(tmp_path, route=route, device_batch_rows=512,
                  index_max_rows_per_file=500)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "zres", ["a", "b"], ["__z"]))
        assert "spill_route_s" in s.build_stats_log[-1]  # the two-pass build
    _require_same_index(sides, "zres")
    _query_both(sides, data, lambda c: c("a") == 7, ("a", "__z"), "zres")


@pytest.mark.parametrize("route", ROUTES)
def test_string_key_streaming_build_matches_monolithic_layout(tmp_path,
                                                              route):
    """String keys are rank-mapped, so the two-pass build ranks them
    globally: its files equal the monolithic build's row for row, and
    each mode's bytes equal the JAX package's."""
    rng = np.random.default_rng(4)
    n = 3000
    # Anti-sorted across files: later files hold earlier strings.
    tags = sorted(f"s{i:05d}" for i in rng.integers(0, 800, n))[::-1]
    data = _split_source(str(tmp_path / "sk"), pa.table({
        "name": pa.array(tags),
        "y": pa.array(rng.random(n) * 100),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }))
    contents = {}
    for mode, batch in (("streaming", 512), ("monolithic", 1 << 30)):
        sides = _both(tmp_path, route=route, tag=mode,
                      device_batch_rows=batch, index_max_rows_per_file=300)
        for pkg, (s, hs) in sides.items():
            hs.create_index(s.read.parquet(data),
                            _zcfg(pkg, "z", ["name", "y"], ["v"]))
        _require_same_index(sides, "z")
        contents[mode] = _file_contents(sides[TORCH][0], "z")
    assert contents["streaming"] == contents["monolithic"]


def test_three_dimension_zorder_prunes_on_third_dim(tmp_path):
    rng = np.random.default_rng(2)
    n = 16_000
    data = _split_source(str(tmp_path / "z3"), pa.table({
        "a": pa.array(rng.integers(0, 1000, n), type=pa.int64()),
        "b": pa.array(rng.random(n) * 100),
        "c": pa.array(rng.integers(0, 10_000, n), type=pa.int64()),
        "v": pa.array(np.arange(n, dtype=np.int64)),
    }))
    sides = _both(tmp_path, device_batch_rows=2048,
                  index_max_rows_per_file=250)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "z3", ["a", "b", "c"], ["v"]))
    _require_same_index(sides, "z3")
    kept, total = _query_both(
        sides, data, lambda c: (c("c") >= 2000) & (c("c") < 3000),
        ("c", "v"), "z3")
    assert kept <= total // 2, (kept, total)


def _external_source(root, seed=9, n=8000):
    rng = np.random.default_rng(seed)
    return _split_source(root, pa.table({
        "x": pa.array(rng.integers(0, 1 << 16, n), type=pa.int64()),
        "y": pa.array(rng.random(n) * 1000),
    }))


def test_chunked_zorder_build(tmp_path):
    """tests/test_external_build.py::test_chunked_zorder_build: the
    two-pass build at a 512-row batch, answered right."""
    data = _external_source(str(tmp_path / "data"), seed=1)
    sides = _both(tmp_path, device_batch_rows=512, num_buckets=4)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data), _zcfg(pkg, "zc", ["x", "y"]))
    _require_same_index(sides, "zc")
    _query_both(sides, data, lambda c: c("x") >= 900, ("x", "y"), "zc")


@pytest.mark.parametrize("route", ROUTES)
def test_chunked_zorder_preserves_global_layout(tmp_path, route):
    """The two-pass build keeps the GLOBAL curve: the monolithic build's
    files row for row, and a 5% second-dimension range prunes."""
    from hyperspace_tpu_torch.io.parquet import bucket_id_of_file

    n = 8000
    data = _external_source(str(tmp_path / "data"), n=n)
    sides = _both(tmp_path, route=route, num_buckets=4,
                  device_batch_rows=512, index_max_rows_per_file=n // 64)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data), _zcfg(pkg, "zs", ["x", "y"]))
    _require_same_index(sides, "zs")
    s = sides[TORCH][0]
    files = [f.name for f in _entry(s, "zs").content.file_infos()]
    assert len(files) >= 8
    assert all(bucket_id_of_file(f) == 0 for f in files)
    mono = _session(TORCH, str(tmp_path / "mono"), route=route,
                    device_batch_rows=1 << 30, index_max_rows_per_file=n // 64)
    TORCH.Hyperspace(mono).create_index(mono.read.parquet(data),
                                        _zcfg(TORCH, "zs", ["x", "y"]))
    assert "spill_route_s" not in mono.build_stats_log[-1]
    assert _file_contents(mono, "zs") == _file_contents(s, "zs")
    kept, total = _query_both(
        sides, data, lambda c: (c("y") >= 100.0) & (c("y") < 150.0),
        ("x", "y"), "zs")
    assert kept <= total // 2, (kept, total)


def test_two_pass_files_are_cell_aligned(tmp_path):
    """Within each file the codes are non-decreasing, and every cut
    between consecutive files lies on a cell boundary or at the row
    cap."""
    from hyperspace_tpu_torch.io.parquet import (
        zorder_codes_host,
        zorder_split_chunks,
    )

    n = 8000
    max_rows = n // 64
    data = _external_source(str(tmp_path / "data"), n=n)
    s = _session(TORCH, str(tmp_path / "ix"), device_batch_rows=512,
                 index_max_rows_per_file=max_rows)
    TORCH.Hyperspace(s).create_index(s.read.parquet(data),
                                     _zcfg(TORCH, "zs", ["x", "y"]))
    source = pq.read_table(data)
    codes, bits = zorder_codes_host(source, ["x", "y"])
    order = np.argsort(codes, kind="stable")
    chunks = zorder_split_chunks(codes[order], bits, max_rows)
    want = sorted(tuple(source.take(pa.array(order[off:off + rows]))
                        .column("x").to_pylist()) for off, rows in chunks)
    got = sorted(tuple(pq.read_table(f.name).column("x").to_pylist())
                 for f in _entry(s, "zs").content.file_infos())
    assert got == want
    level = max(1, min(bits, int(np.ceil(np.log2(-(-n // max_rows))))))
    cells = codes[order] >> np.uint64(bits - level)
    for (off, rows), nxt in zip(chunks, chunks[1:]):
        assert rows == max_rows or cells[off + rows - 1] != cells[nxt[0]]


def test_optimize_keeps_zorder_layout_order(tmp_path):
    """Compaction re-sorts in Morton order with cell-aligned cuts: the
    JAX package's bytes, and second-dimension pruning survives."""
    data = _grid_data(str(tmp_path / "grid"))
    sides = _both(tmp_path, optimize_file_size_threshold=1 << 30)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data), _zcfg(pkg, "zo", ["x", "y"]))
        pre_id = _entry(s, "zo").id
        s.conf.index_max_rows_per_file = 256
        hs.optimize_index("zo", "full")
        assert _entry(s, "zo").id != pre_id
    _require_same_index(sides, "zo")
    assert len(_entry(sides[TORCH][0], "zo").content.file_infos()) >= 16
    kept, total = _query_both(
        sides, data, lambda c: (c("y") >= 1000) & (c("y") < 9000),
        ("x", "y"), "zo")
    assert kept <= total // 2, (kept, total)


def test_zorder_on_date_dimension(tmp_path):
    """tests/test_datetime.py's date dimension: a two-month window reads
    a strict subset of the 8 files, as many as the JAX package."""
    base = datetime.date(1992, 1, 1)
    n = 40_000
    rng = np.random.default_rng(21)
    days = (np.arange(n) * 2556 // n).astype("timedelta64[D]")
    data = _split_source(str(tmp_path / "data"), pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "d": pa.array(np.datetime64(base) + days),
        "v": pa.array(rng.random(n)),
    }), parts=8)
    sides = _both(tmp_path, index_max_rows_per_file=5000)
    for pkg, (s, hs) in sides.items():
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "dz", ["d", "v"], ["k"]))
    _require_same_index(sides, "dz")
    lo, hi = datetime.date(1995, 1, 1), datetime.date(1995, 3, 1)
    read = {}
    for pkg, (s, _) in sides.items():
        s.conf.index_max_rows_per_file = 0
        s.enable_hyperspace()
        col = pkg.col
        got = (s.read.parquet(data).filter((col("d") >= lo) & (col("d") < hi))
               .select("k", "d").collect())
        scans = s.last_execution_stats["scans"]
        assert scans[-1]["is_index"] and scans[-1]["files_read"] < 8, scans
        read[pkg] = (scans[-1]["files_read"], got.sort_by("k").to_pylist())
    assert read[TORCH] == read[JAX]


@pytest.mark.parametrize("route", ROUTES)
def test_zorder_repair_matches_jax(tmp_path, route):
    """Bit rot in one file of a Z-order index: a full verify flags it,
    repair rebuilds the one bucket, and the files equal the JAX
    package's repaired ones and the build's; verify is clean after."""
    data = _grid_data(str(tmp_path / "data"))
    sides = _both(tmp_path, route=route, index_max_rows_per_file=512)
    built = {}
    for pkg, (s, hs) in sides.items():
        # Both packages keep their default store, EmulatedObjectStore.
        hs.create_index(s.read.parquet(data),
                        _zcfg(pkg, "zi", ["x", "y"], ["payload"]))
        built[pkg] = _digests(s, "zi")
        victim = _entry(s, "zi").content.file_infos()[3].name
        st = os.stat(victim)
        with open(victim, "r+b") as f:
            f.seek(st.st_size // 2)
            b = f.read(1)
            f.seek(st.st_size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns))
        report = hs.verify_index("zi", mode="full")
        flagged = [p for p, status in zip(report.column("file").to_pylist(),
                                          report.column("status").to_pylist())
                   if status != "ok"]
        assert flagged == [victim]
        hs.refresh_index("zi", mode="repair")
        report = hs.verify_index("zi", mode="full")
        assert set(report.column("status").to_pylist()) == {"ok"}
    assert built[TORCH] == built[JAX]
    recorded = _require_same_index(sides, "zi")
    assert recorded[2] == built[TORCH]
    _query_both(sides, data, lambda c: (c("y") >= 1000) & (c("y") < 9000),
                ("x", "y", "payload"), "zi")


def test_zbuild_dir_of_a_dead_build_is_reaped(tmp_path, monkeypatch):
    """A two-pass build killed before its cleanup leaves an
    ``hs_zbuild_<pid>_*`` directory: the next build removes it once the
    pid is provably dead, and its own directory is gone after it."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    dead = tmp / f"hs_zbuild_{proc.pid}_abc"
    (dead / "file=000000").mkdir(parents=True)
    (dead / "file=000000" / "run-00000.arrow").write_bytes(b"x")
    mine = tmp / f"hs_zbuild_{os.getpid()}_live"
    mine.mkdir()
    assert torch_create.reap_orphan_spill_dirs(tmp_root=str(tmp)) == 1
    assert not dead.exists() and mine.exists()
    mine.rmdir()
    dead.mkdir()
    data = _external_source(str(tmp_path / "data"), n=2000)
    s = _session(TORCH, str(tmp_path / "ix"), device_batch_rows=512,
                 index_max_rows_per_file=100)
    TORCH.Hyperspace(s).create_index(s.read.parquet(data),
                                     _zcfg(TORCH, "zs", ["x", "y"]))
    assert "spill_route_s" in s.build_stats_log[-1]
    assert os.listdir(tmp) == []
