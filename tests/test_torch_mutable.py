"""An index over a changing source through hyperspace_tpu_torch (on the
CPU) against the JAX package: the lineage column, quick and incremental
refresh, optimize, and hybrid-scan filter and join queries.

One seeded Parquet source (8 files of 300 rows: an int64 key ``k``, a
string key ``s``, a float and an int32 column) is indexed by both
packages in their own system paths, 4 buckets; then files are appended
and deleted, and both packages refresh, optimize and query the same
files.  Everything is compared bit for bit: lineage ids, each bucket's
sha256, log entries and summaries, query rows and their order, plans,
pruned buckets and routes.
"""

import hashlib
import os
import re
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.io.parquet import bucket_id_of_file

N_FILES = 8
ROWS_PER_FILE = 300
NUM_BUCKETS = 4
SPILL_BATCH = 512
PACKAGES = (hyperspace_tpu, hyperspace_tpu_torch)


def _table(rng, n):
    return pa.table({
        "k": pa.array(rng.integers(0, 200, n), type=pa.int64()),
        "s": pa.array([f"key-{v:03d}" for v in rng.integers(0, 150, n)]),
        "v": pa.array(rng.random(n)),
        "w": pa.array(rng.integers(-50, 50, n), type=pa.int32()),
    })


def _write_source(root):
    os.makedirs(root)
    rng = np.random.default_rng(23)
    for i in range(N_FILES):
        pq.write_table(_table(rng, ROWS_PER_FILE),
                       os.path.join(root, f"part-{i:05d}.parquet"))


def _mutate(root, append=0, delete=(), seed=1, rows=ROWS_PER_FILE):
    """Append ``append`` new files (rows from ``seed``) and delete the
    original files numbered in ``delete``."""
    rng = np.random.default_rng(seed)
    for i in range(append):
        pq.write_table(_table(rng, rows),
                       os.path.join(root, f"part-{9000 + 10 * seed + i:05d}.parquet"))
    for i in delete:
        os.remove(os.path.join(root, f"part-{i:05d}.parquet"))


def _session(pkg, system_path, lineage=False, batch_rows=1 << 20):
    kw = {"device": "cpu"} if pkg is hyperspace_tpu_torch else {}
    s = pkg.HyperspaceSession(system_path=system_path, **kw)
    s.conf.num_buckets = NUM_BUCKETS
    s.conf.lineage_enabled = lineage
    s.conf.device_batch_rows = batch_rows
    s.conf.device_filter_min_rows = 0
    s.conf.device_join_min_rows = 0
    if pkg is hyperspace_tpu_torch:
        # The device routes everywhere (the CPU defaults take the host).
        s.conf.device_agg_min_rows = 0
        s.conf.device_build_min_rows = 0
        s.conf.device_resident_min_rows = 0
    if pkg is hyperspace_tpu:
        # The port's single-device path: no mesh; the JAX side uncached,
        # the port's cache on, so changed files must never be served
        # from it.
        s.conf.parallel_build = "off"
        s.conf.mesh_enabled = "off"
        s.conf.device_cache_policy = "off"
    return s


def _system(tmp_path, pkg):
    return str(tmp_path / ("jax" if pkg is hyperspace_tpu else "torch"))


def _create(tmp_path, data, config, **conf):
    """The same index built by both packages: {pkg: (session, hs)}."""
    out = {}
    for pkg in PACKAGES:
        s = _session(pkg, _system(tmp_path, pkg), **conf)
        hs = pkg.Hyperspace(s)
        hs.create_index(s.read.parquet(data), pkg.IndexConfig(*config))
        out[pkg] = (s, hs)
    return out


def _entry(both, pkg, name="ix"):
    return both[pkg][0].index_collection_manager.get_index(name)


def _bucket_digests(entry):
    """bucket -> sorted sha256 of its files."""
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(d) for b, d in out.items()}


def _index_defining(entry):
    """A log entry without its timestamp and its system path: the data
    files as (version directory, bucket, size)."""
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
    return {"name": d["name"], "state": d["state"], "id": d["id"],
            "derivedDataset": d["derivedDataset"], "source": d["source"],
            "properties": d["properties"], "data_files": sorted(data_files)}


def _assert_same_index(both):
    jentry, tentry = _entry(both, hyperspace_tpu), _entry(both, hyperspace_tpu_torch)
    assert _index_defining(tentry) == _index_defining(jentry)
    assert _bucket_digests(tentry) == _bucket_digests(jentry)
    return tentry


def _index_rows(entry):
    return sum(pq.read_metadata(f.name).num_rows
               for f in entry.content.file_infos())


@pytest.mark.parametrize("batch_rows", [1 << 20, SPILL_BATCH],
                         ids=["monolithic", "spill"])
@pytest.mark.parametrize("key", ["k", "s"])
def test_lineage_create_is_bit_equal_to_jax(tmp_path, key, batch_rows):
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", [key], ["v", "w"]), lineage=True,
                   batch_rows=batch_rows)
    tentry = _assert_same_index(both)
    assert tentry.has_lineage_column()
    assert tentry.derived_dataset.schema["_data_file_id"] == "int64"
    phases = both[hyperspace_tpu_torch][0].build_stats_log[-1]
    assert ("spill_route_s" in phases) == (batch_rows == SPILL_BATCH)
    # Every row's id is its source file's.
    ids = {f.id: f.name for f in tentry.source_file_infos()}
    assert sorted(ids) == list(range(N_FILES))
    index = pa.concat_tables(pq.read_table(f.name)
                             for f in tentry.content.file_infos())
    for fid, name in ids.items():
        mine = index.filter(pa.compute.equal(index.column("_data_file_id"), fid))
        src = pq.read_table(name)
        assert sorted(zip(mine.column(key).to_pylist(),
                          mine.column("v").to_pylist())) == \
            sorted(zip(src.column(key).to_pylist(), src.column("v").to_pylist()))


# Within hybrid scan's default limits: appended 2 of 9 files' bytes
# (under 0.3), deleted 1 of 8 (under 0.2).
_CHANGES = {"append": dict(append=2), "delete": dict(delete=(5,)),
            "both": dict(append=2, delete=(1,))}


def _refresh_both(both, mode, name="ix"):
    out = [both[pkg][1].refresh_index(name, mode).to_dict() for pkg in PACKAGES]
    assert out[1] == out[0]
    return out[1]


@pytest.mark.parametrize("change", sorted(_CHANGES))
@pytest.mark.parametrize("key", ["k", "s"])
def test_incremental_refresh_is_bit_equal_to_jax(tmp_path, key, change):
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", [key], ["v", "w"]), lineage=True)
    _mutate(data, **_CHANGES[change])
    summary = _refresh_both(both, "incremental")
    appended = _CHANGES[change].get("append", 0)
    deleted = len(_CHANGES[change].get("delete", ()))
    assert (summary["outcome"], summary["appended"], summary["deleted"],
            summary["mode"]) == ("ok", appended, deleted, "incremental")
    tentry = _assert_same_index(both)
    assert _index_rows(tentry) == (N_FILES + appended - deleted) * ROWS_PER_FILE
    versions = {os.path.basename(os.path.dirname(f.name))
                for f in tentry.content.file_infos()}
    # Appended only: the old files stay, and the content trees merge.
    assert versions == ({"v__=0", "v__=1"} if not deleted else {"v__=1"})
    # The appended files got fresh ids after the recorded ones.
    new_ids = sorted(f.id for f in tentry.source_file_infos()
                     if "part-090" in f.name)
    assert new_ids == list(range(N_FILES, N_FILES + appended))


@pytest.mark.parametrize("batch_rows", [1 << 20, SPILL_BATCH],
                         ids=["monolithic", "spill"])
def test_full_refresh_keeps_the_lineage_column_like_jax(tmp_path, batch_rows):
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", ["s"], ["v"]), lineage=True,
                   batch_rows=batch_rows)
    for pkg in PACKAGES:
        # The previous entry pins lineage, whatever the conf says now.
        both[pkg][0].conf.lineage_enabled = False
    _mutate(data, **_CHANGES["both"])
    assert _refresh_both(both, "full")["outcome"] == "ok"
    tentry = _assert_same_index(both)
    assert tentry.has_lineage_column()
    assert "_data_file_id" in tentry.derived_dataset.schema


def test_incremental_refresh_with_deletes_needs_lineage(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", ["k"], ["v"]))
    _mutate(data, append=1, delete=(2,))
    errors = []
    for pkg in PACKAGES:
        with pytest.raises(pkg.HyperspaceError) as info:
            both[pkg][1].refresh_index("ix", "incremental")
        errors.append(str(info.value))
    assert errors[1] == errors[0] and "requires lineage" in errors[0]
    _assert_same_index(both)
    # Appended only, an index without lineage refreshes incrementally.
    _mutate(data, append=1, seed=2)
    os.remove(os.path.join(data, "part-09010.parquet"))
    pq.write_table(_table(np.random.default_rng(4), 10),
                   os.path.join(data, "part-00002.parquet"))
    assert _refresh_both(both, "full")["outcome"] == "ok"
    _mutate(data, append=1, seed=3)
    assert _refresh_both(both, "incremental")["appended"] == 1
    _assert_same_index(both)


@pytest.mark.parametrize("change", sorted(_CHANGES))
def test_quick_refresh_then_incremental_are_equal_to_jax(tmp_path, change):
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", ["k"], ["v", "w"]), lineage=True)
    _mutate(data, **_CHANGES[change])
    summary = _refresh_both(both, "quick")
    assert summary["outcome"] == "ok" and summary["mode"] == "quick"
    tentry = _assert_same_index(both)
    assert tentry.has_source_update()
    assert len(tentry.appended_files()) == _CHANGES[change].get("append", 0)
    assert len(tentry.deleted_files()) == len(_CHANGES[change].get("delete", ()))
    # The log round-trips through both packages' parsers.
    from hyperspace_tpu.index.log_entry import IndexLogEntry as JaxEntry
    from hyperspace_tpu_torch.index.log_entry import IndexLogEntry as TorchEntry

    d = tentry.to_dict()
    assert JaxEntry.from_dict(d).to_dict() == d
    assert TorchEntry.from_dict(d).to_dict() == d
    assert _refresh_both(both, "quick")["outcome"] == "ok"
    summary = _refresh_both(both, "incremental")
    assert summary["outcome"] == "ok"
    tentry = _assert_same_index(both)
    assert not tentry.has_source_update()
    assert _refresh_both(both, "incremental")["outcome"] == "noop"


def _optimize_both(both, mode):
    out = [both[pkg][1].optimize_index("ix", mode).to_dict() for pkg in PACKAGES]
    assert out[1] == out[0]
    return out[1]


def _two_versions(tmp_path, max_rows_per_file=0):
    """An index whose buckets each hold files of two versions: a lineage
    create, then an appended-only incremental refresh."""
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", ["k"], ["v", "w"]), lineage=True)
    for pkg in PACKAGES:
        both[pkg][0].conf.index_max_rows_per_file = max_rows_per_file
    _mutate(data, append=3, rows=40)
    _refresh_both(both, "incremental")
    return data, both


@pytest.mark.parametrize("mode", ["quick", "full"])
def test_optimize_is_bit_equal_to_jax(tmp_path, mode):
    _, both = _two_versions(tmp_path)
    before = _index_rows(_entry(both, hyperspace_tpu_torch))
    summary = _optimize_both(both, mode)
    assert (summary["outcome"], summary["compacted_buckets"],
            summary["compacted_files"], summary["written_files"]) == \
        ("ok", NUM_BUCKETS, 2 * NUM_BUCKETS, NUM_BUCKETS)
    tentry = _assert_same_index(both)
    assert _index_rows(tentry) == before
    assert len(tentry.content.file_infos()) == NUM_BUCKETS
    noop = _optimize_both(both, mode)
    assert noop["outcome"] == "noop" and noop["version"] is None


def test_quick_optimize_leaves_files_over_the_threshold(tmp_path):
    _, both = _two_versions(tmp_path)
    files = _entry(both, hyperspace_tpu_torch).content.file_infos()
    sizes = sorted(f.size for f in files)
    by_bucket = defaultdict(list)
    for f in files:
        by_bucket[bucket_id_of_file(f.name)].append(f.size)
    # Under the first threshold only the appended runs qualify, one per
    # bucket: nothing to merge.  Under the second one bucket's older file
    # qualifies too.
    for threshold in (sizes[NUM_BUCKETS], sizes[NUM_BUCKETS + 1]):
        for pkg in PACKAGES:
            both[pkg][0].conf.optimize_file_size_threshold = threshold
        merged = [b for b, fs in by_bucket.items()
                  if sum(size < threshold for size in fs) > 1]
        summary = _optimize_both(both, "quick")
        assert (summary["outcome"], summary["compacted_buckets"]) == \
            (("ok", len(merged)) if merged else ("noop", 0))
    assert len(merged) == 1
    tentry = _assert_same_index(both)
    assert len(tentry.content.file_infos()) == 2 * NUM_BUCKETS - 1


def test_optimize_with_a_row_cap_is_bit_equal_to_jax(tmp_path):
    _, both = _two_versions(tmp_path, max_rows_per_file=200)
    summary = _optimize_both(both, "full")
    assert summary["outcome"] == "ok"
    tentry = _assert_same_index(both)
    assert all(pq.read_metadata(f.name).num_rows <= 200
               for f in tentry.content.file_infos())
    assert _optimize_both(both, "full")["outcome"] == "noop"


# -- hybrid scan ------------------------------------------------------------
def _queries(pkg, s, data, other):
    c = pkg.col
    src = s.read.parquet(data)
    return {
        "point": src.filter(c("k") == 17).select("k", "v"),
        "range": src.filter((c("k") >= 40) & (c("k") < 90)).select("k", "v", "w"),
        "join": s.read.parquet(other).join(src, c("ok") == c("k"))
        .select("ok", "price", "k", "v"),
    }


def _write_other(root):
    os.makedirs(root)
    rng = np.random.default_rng(5)
    keys = rng.permutation(200).astype(np.int64)
    for i in range(2):
        pq.write_table(pa.table({"ok": keys[i * 100:(i + 1) * 100],
                                 "price": rng.random(100)}),
                       os.path.join(root, f"part-{i:05d}.parquet"))


def _plan_text(plan, root):
    return re.sub(r" \[files: \d+/\d+\]", "",
                  plan.tree_string().replace(root, "<root>"))


def _index_scans(plan):
    if type(plan).__name__ == "Scan":
        rel = plan.relation
        return [(rel.index_scan_of, rel.prune_to_buckets)] \
            if rel.index_scan_of else []
    return [s for c in plan.children for s in _index_scans(c)]


def _node_names(plan):
    return [type(plan).__name__] + [n for c in plan.children
                                    for n in _node_names(c)]


def _hybrid_env(tmp_path, change, quick):
    data, other = str(tmp_path / "data"), str(tmp_path / "other")
    _write_source(data)
    _write_other(other)
    both = _create(tmp_path, data, ("ix", ["k"], ["v", "w"]), lineage=True)
    for pkg in PACKAGES:
        s, hs = both[pkg]
        hs.create_index(s.read.parquet(other),
                        pkg.IndexConfig("ox", ["ok"], ["price"]))
    _mutate(data, **_CHANGES[change])
    if quick:
        _refresh_both(both, "quick")
    return data, other, both


@pytest.mark.parametrize("quick", [False, True], ids=["stale", "quick"])
@pytest.mark.parametrize("change", sorted(_CHANGES))
@pytest.mark.parametrize("query", ["point", "range", "join"])
def test_hybrid_scan_queries_equal_jax(tmp_path, query, change, quick):
    data, other, both = _hybrid_env(tmp_path, change, quick)
    out = {}
    for pkg in PACKAGES:
        s = both[pkg][0]
        s.conf.hybrid_scan_enabled = True
        s.enable_hyperspace()
        ds = _queries(pkg, s, data, other)[query]
        out[pkg] = (ds.collect(), ds.optimized_plan(), s.last_execution_stats)
    (jt, jplan, jstats), (tt, tplan, tstats) = out.values()
    assert tt.num_rows > 0
    assert tt.schema.equals(jt.schema)
    assert tt.equals(jt)
    root = str(tmp_path)
    assert _plan_text(tplan, root) == _plan_text(jplan, root)
    assert _index_scans(tplan) == _index_scans(jplan)
    assert "ix" in [n for n, _ in _index_scans(tplan)]
    names = _node_names(tplan)
    merge = "BucketUnion" if query == "join" else "Union"
    assert (merge in names) == ("append" in _CHANGES[change])
    assert ("_data_file_id" in tplan.tree_string()) == (change != "append")
    for kind in ("filters", "joins", "join_kernels"):
        assert [d["strategy"] for d in tstats.get(kind, [])] == \
            [d["strategy"] for d in jstats.get(kind, [])]
    if query == "join":
        # "hybrid": a side routed appended rows into its buckets.
        assert [(d["strategy"], d["hybrid"]) for d in tstats["joins"]] == \
            [(d["strategy"], d["hybrid"]) for d in jstats["joins"]] == \
            [("bucketed", "append" in _CHANGES[change])]
    if query == "point":
        assert len(_index_scans(tplan)[0][1]) == 1
    # The answer is the source's, as a multiset of rows.
    s = both[hyperspace_tpu_torch][0].disable_hyperspace()
    src = _queries(hyperspace_tpu_torch, s, data, other)[query].collect()
    assert sorted(tuple(r.values()) for r in src.to_pylist()) == \
        sorted(tuple(r.values()) for r in tt.to_pylist())


def test_a_failed_route_is_not_answered_from_the_host(tmp_path, monkeypatch):
    """The hybrid join routes the appended rows with the build's hash on
    the session's device; its error reaches the caller."""
    from hyperspace_tpu_torch.ops import hash as torch_hash

    data, other, both = _hybrid_env(tmp_path, "append", quick=False)

    def broken(*args, **kwargs):
        raise RuntimeError("route failed")

    monkeypatch.setattr(torch_hash, "bucket_ids", broken)
    s = both[hyperspace_tpu_torch][0].enable_hyperspace()
    s.conf.hybrid_scan_enabled = True
    with pytest.raises(RuntimeError, match="route failed"):
        _queries(hyperspace_tpu_torch, s, data, other)["join"].collect()


def test_hybrid_scan_off_skips_a_quick_refreshed_index(tmp_path):
    data, other, both = _hybrid_env(tmp_path, "both", quick=True)
    for pkg in PACKAGES:
        s = both[pkg][0].enable_hyperspace()
        ds = _queries(pkg, s, data, other)["point"]
        assert _index_scans(ds.optimized_plan()) == []


@pytest.mark.parametrize("ratio", ["appended", "deleted"])
def test_a_ratio_over_its_threshold_excludes_the_index(tmp_path, ratio):
    data, other, both = _hybrid_env(tmp_path, "both", quick=False)
    for limit, used in ((1.0, True), (0.05, False)):
        for pkg in PACKAGES:
            s = both[pkg][0].enable_hyperspace()
            s.conf.hybrid_scan_enabled = True
            setattr(s.conf, f"hybrid_scan_max_{ratio}_ratio", limit)
            ds = _queries(pkg, s, data, other)["range"]
            scans = [n for n, _ in _index_scans(ds.optimized_plan())]
            assert scans == (["ix"] if used else []), (pkg.__name__, limit)


def test_hybrid_scan_needs_lineage_for_deleted_files(tmp_path):
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", ["k"], ["v"]))
    _mutate(data, delete=(3,))
    for pkg in PACKAGES:
        s = both[pkg][0].enable_hyperspace()
        s.conf.hybrid_scan_enabled = True
        ds = s.read.parquet(data).filter(pkg.col("k") == 17).select("k", "v")
        assert _index_scans(ds.optimized_plan()) == []


def test_queries_after_incremental_and_optimize_equal_jax(tmp_path):
    """Buckets with files in two versions, then compacted: the index is
    used again with hybrid scan off, and the answers stay the JAX
    package's."""
    data, other, both = _hybrid_env(tmp_path, "both", quick=True)
    _refresh_both(both, "incremental")
    _mutate(data, append=1, seed=7)
    _refresh_both(both, "incremental")
    for step in ("two versions", "optimized"):
        if step == "optimized":
            assert _optimize_both(both, "quick")["outcome"] == "ok"
        for query in ("point", "range", "join"):
            out = []
            for pkg in PACKAGES:
                s = both[pkg][0].enable_hyperspace()
                ds = _queries(pkg, s, data, other)[query]
                out.append((ds.collect(), ds.optimized_plan()))
            (jt, jplan), (tt, tplan) = out
            assert tt.equals(jt), (step, query)
            assert _plan_text(tplan, str(tmp_path)) == \
                _plan_text(jplan, str(tmp_path))
            assert "ix" in [n for n, _ in _index_scans(tplan)]
            assert "_data_file_id" not in tt.column_names


def test_the_lineage_column_stays_out_of_query_output(tmp_path):
    """An index covering every source column answers a query with no
    select; its lineage column must not show in the output."""
    data = str(tmp_path / "data")
    _write_source(data)
    both = _create(tmp_path, data, ("ix", ["k"], ["s", "v", "w"]),
                   lineage=True)
    out = []
    for pkg in PACKAGES:
        s = both[pkg][0].enable_hyperspace()
        ds = s.read.parquet(data).filter(pkg.col("k") == 17)
        assert [n for n, _ in _index_scans(ds.optimized_plan())] == ["ix"]
        out.append(ds.collect())
    assert out[1].num_rows > 0 and out[1].equals(out[0])
    assert out[1].column_names == ["k", "s", "v", "w"]


@pytest.mark.parametrize("source_type, stored", [
    (pa.int64(), "int64"), (pa.int32(), "int64"), (pa.int64(), "double"),
    (pa.string(), "string")])
def test_route_to_buckets_matches_the_jax_host_mirror(tmp_path, source_type,
                                                      stored):
    """The port routes appended rows with the build's hash on the
    session's device; the JAX package with the host mirror
    ``bucket_ids_np``.  Same buckets, same rows in each, in order, after
    casting the key to the index's stored type."""
    from hyperspace_tpu.execution.executor import Executor as JaxExecutor
    from hyperspace_tpu.plan import nodes as jax_nodes
    from hyperspace_tpu_torch.execution.executor import Executor as TorchExecutor
    from hyperspace_tpu_torch.plan import nodes as torch_nodes

    rng = np.random.default_rng(9)
    n = 1000
    raw = rng.integers(0, 60, n)
    keys = pa.array([f"k{v}" for v in raw]) if source_type == pa.string() \
        else pa.array(raw).cast(source_type)
    table = pa.table({"K": keys, "x": np.arange(n)})
    index_dir = tmp_path / "index"
    index_dir.mkdir()
    index_file = str(index_dir / "part-b00000-x.parquet")
    pq.write_table(pa.table({"k": pa.array([], type=pa.type_for_alias(stored))}),
                   index_file)
    out = []
    for pkg, executor, nodes in ((hyperspace_tpu, JaxExecutor, jax_nodes),
                                 (hyperspace_tpu_torch, TorchExecutor,
                                  torch_nodes)):
        s = _session(pkg, _system(tmp_path, pkg))
        scan = nodes.Scan(nodes.ScanRelation(
            root_paths=(str(index_dir),), index_scan_of="ix",
            bucket_spec=(7, ("k",), ("k",)), file_paths=(index_file,)))
        out.append(executor(s)._route_to_buckets(table, ("k",), 7, scan))
    jroutes, troutes = out
    assert sorted(troutes) == sorted(jroutes) and len(troutes) > 1
    for b in jroutes:
        assert troutes[b].equals(jroutes[b]), b


# ---------------------------------------------------------------------------
# More hybrid shapes, each held to the JAX package.
# ---------------------------------------------------------------------------
def _assert_same_rows(got, want):
    """Equal rows in the same order; float columns bit for bit, so that
    NaN equals NaN and -0.0 differs from 0.0 (``Table.equals`` takes no
    NaN as equal)."""
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        if pa.types.is_floating(w.type) and w.null_count == 0:
            assert g.null_count == 0, name
            assert np.array_equal(g.to_numpy().view(np.int64),
                                  w.to_numpy().view(np.int64)), name
        else:
            assert g.equals(w), name


def _hybrid_both(both, make_ds, hybrid=True):
    """``make_ds(pkg, session)`` through both packages with hyperspace
    (and hybrid scan) on: the tables, plans and stats, after checking
    that rows, order, plans, index scans and strategies agree."""
    out = []
    for pkg in PACKAGES:
        s = both[pkg][0].enable_hyperspace()
        s.conf.hybrid_scan_enabled = hybrid
        ds = make_ds(pkg, s)
        out.append((ds.collect(), ds.optimized_plan(), s.last_execution_stats))
    (jt, jplan, jstats), (tt, tplan, tstats) = out
    assert tt.schema.equals(jt.schema)
    _assert_same_rows(tt, jt)
    root = os.path.dirname(both[hyperspace_tpu_torch][0].conf.system_path)
    assert _plan_text(tplan, root) == _plan_text(jplan, root)
    assert _index_scans(tplan) == _index_scans(jplan)
    for kind in ("filters", "joins", "join_kernels", "aggregates"):
        assert [d["strategy"] for d in tstats.get(kind, [])] == \
            [d["strategy"] for d in jstats.get(kind, [])], kind
    return tt, tplan, tstats


def test_hybrid_join_with_files_appended_on_both_sides(tmp_path):
    data, other, both = _hybrid_env(tmp_path, "both", quick=False)
    rng = np.random.default_rng(77)
    pq.write_table(pa.table({"ok": rng.integers(0, 200, 30),
                             "price": rng.random(30)}),
                   os.path.join(other, "part-09000.parquet"))
    tt, tplan, tstats = _hybrid_both(both, lambda pkg, s: _queries(
        pkg, s, data, other)["join"])
    assert tt.num_rows > 0
    assert _node_names(tplan).count("BucketUnion") == 2
    assert [(d["strategy"], d["hybrid"]) for d in tstats["joins"]] == \
        [("bucketed", True)]


def test_hybrid_string_keyed_join_with_appends_and_deletes(tmp_path):
    data, names = str(tmp_path / "data"), str(tmp_path / "names")
    _write_source(data)
    os.makedirs(names)
    rng = np.random.default_rng(12)
    pq.write_table(pa.table({
        "name": [f"key-{v:03d}" for v in rng.permutation(150)],
        "score": rng.random(150)}), os.path.join(names, "part-00000.parquet"))
    both = _create(tmp_path, data, ("sx", ["s"], ["v"]), lineage=True)
    for pkg in PACKAGES:
        s, hs = both[pkg]
        hs.create_index(s.read.parquet(names),
                        pkg.IndexConfig("nx", ["name"], ["score"]))
    _mutate(data, **_CHANGES["both"])
    tt, tplan, tstats = _hybrid_both(both, lambda pkg, s: s.read.parquet(names)
                                     .join(s.read.parquet(data),
                                           pkg.col("name") == pkg.col("s"))
                                     .select("name", "score", "s", "v"))
    assert tt.num_rows > 0
    assert sorted(n for n, _ in _index_scans(tplan)) == ["nx", "sx"]
    assert "_data_file_id" in tplan.tree_string()
    assert [d["hybrid"] for d in tstats["joins"]] == [True]


@pytest.mark.parametrize("query", ["point", "isin", "join"])
def test_hybrid_scan_over_an_appended_file_with_null_keys(tmp_path, query):
    data, other, both = _hybrid_env(tmp_path, "delete", quick=False)
    rng = np.random.default_rng(31)
    n = 120
    keys = rng.integers(0, 200, n)
    keys[:3] = 17
    pq.write_table(pa.table({
        "k": pa.array(keys, mask=rng.random(n) < 0.25, type=pa.int64()),
        "s": pa.array([f"key-{v:03d}" for v in rng.integers(0, 150, n)]),
        "v": pa.array(rng.random(n)),
        "w": pa.array(rng.integers(-50, 50, n), type=pa.int32()),
    }), os.path.join(data, "part-09100.parquet"))

    def make(pkg, s):
        c = pkg.col
        src = s.read.parquet(data)
        if query == "point":
            return src.filter(c("k") == 17).select("k", "v")
        if query == "isin":
            return src.filter(c("k").isin([17, 40, 41])).select("k", "v", "w")
        return s.read.parquet(other).join(src, c("ok") == c("k")) \
            .select("ok", "price", "k", "v")

    tt, tplan, _ = _hybrid_both(both, make)
    assert tt.num_rows > 0 and tt.column("k").null_count == 0
    assert ("BucketUnion" if query == "join" else "Union") in _node_names(tplan)


def _float_table(rng, n, special):
    keys = np.round(rng.standard_normal(n) * 4, 1)
    keys[:len(special)] = special
    return pa.table({"f": pa.array(keys), "v": pa.array(rng.random(n))})


@pytest.mark.parametrize("hybrid", [False, True], ids=["clean", "hybrid"])
def test_float_keyed_join_with_signed_zero_nan_and_inf(tmp_path, hybrid):
    special = [-0.0, 0.0, np.nan, np.inf, -np.inf, np.nan]
    data, other = str(tmp_path / "data"), str(tmp_path / "other")
    rng = np.random.default_rng(4)
    for root, name in ((data, "v"), (other, "g")):
        os.makedirs(root)
        for i in range(8):
            t = _float_table(rng, 80, special[i % 3::2])
            if root == other:
                t = t.rename_columns(["g", "gv"])
            pq.write_table(t, os.path.join(root, f"part-{i:05d}.parquet"))
    both = _create(tmp_path, data, ("fx", ["f"], ["v"]), lineage=True)
    for pkg in PACKAGES:
        s, hs = both[pkg]
        hs.create_index(s.read.parquet(other),
                        pkg.IndexConfig("gx", ["g"], ["gv"]))
    if hybrid:
        # Within the default ratios: 1 of 8 files deleted, 40 rows added.
        pq.write_table(_float_table(rng, 40, special),
                       os.path.join(data, "part-09000.parquet"))
        os.remove(os.path.join(data, "part-00001.parquet"))
    tt, tplan, tstats = _hybrid_both(both, lambda pkg, s: s.read.parquet(other)
                                     .join(s.read.parquet(data),
                                           pkg.col("g") == pkg.col("f"))
                                     .select("g", "gv", "f", "v"),
                                     hybrid=hybrid)
    assert tt.num_rows > 0
    f = tt.column("f").to_numpy()
    assert np.isnan(f).any() and np.isinf(f).any() and (f == 0).any()
    assert sorted(n for n, _ in _index_scans(tplan)) == ["fx", "gx"]
    assert [d["hybrid"] for d in tstats["joins"]] == [hybrid]


@pytest.mark.parametrize("quick", [False, True], ids=["stale", "quick"])
def test_q3_through_hybrid_scan_equals_jax(tmp_path, quick):
    """The TPC-H Q3 shape over a lineitem-like side with appended and
    deleted files: the fused join→aggregate reads the hybrid side whole
    (index files less the deleted files' rows, then the appended rows)."""
    data, other, both = _hybrid_env(tmp_path, "both", quick=quick)

    def q3(pkg, s):
        c = pkg.col
        return (s.read.parquet(other).filter(c("price") < 0.8)
                .join(s.read.parquet(data), c("ok") == c("k"))
                .group_by("w").agg(revenue=(c("v") * (1 - c("price")), "sum"))
                .sort(("revenue", False)).limit(6))

    out = []
    for pkg in PACKAGES:
        s = both[pkg][0].enable_hyperspace()
        s.conf.hybrid_scan_enabled = True
        ds = q3(pkg, s)
        out.append((ds.collect(), ds.optimized_plan(), s.last_execution_stats))
    (jt, jplan, jstats), (tt, tplan, tstats) = out
    assert tt.num_rows == 6
    assert tt.schema.equals(jt.schema)
    assert tt.column("w").to_pylist() == jt.column("w").to_pylist()
    np.testing.assert_allclose(tt.column("revenue").to_numpy(),
                               jt.column("revenue").to_numpy(), rtol=1e-9)
    root = str(tmp_path)
    assert _plan_text(tplan, root) == _plan_text(jplan, root)
    assert sorted(n for n, _ in _index_scans(tplan)) == ["ix", "ox"]
    assert "BucketUnion" in _node_names(tplan)
    assert "_data_file_id" in tplan.tree_string()
    for kind in ("joins", "aggregates"):
        assert [d["strategy"] for d in tstats[kind]] == \
            [d["strategy"] for d in jstats[kind]]
    assert tstats["joins"][-1]["strategy"] == "device-fused-agg"
    assert tstats["aggregates"][-1]["topn"] == 6
