"""The integrity loop through hyperspace_tpu_torch (on the CPU) against
the JAX package: content digests on every index file, ``verify_index``,
per-bucket quarantine served from the source, execution-time containment
and ``refresh_index(mode="repair")``.

The classes of tests/test_integrity.py run through both packages over
the same seeded Parquet source, each package indexing it in its own
system path.  Beyond them: log-entry JSON with digests, scrub reports,
quarantine records written by one package and read by the other,
repaired bucket files by sha256, ``BucketIn`` masks against the JAX
host mirror, a device error that containment must not catch, and both
routes of the repair and of ``BucketIn`` (the kernel's plain version on
the CPU, and the host mirror).  ``test_quarantine_store_backends``'s
cases run through each package's ``PosixLogStore`` and
``EmulatedObjectStore``; the cross-package quarantine cases run with both
packages on their default store (``TestCrossPackageQuarantine``) and
with both pinned to ``PosixLogStore`` (``...Posix``).
"""

from __future__ import annotations

import glob
import hashlib
import os
import re
import shutil
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu.io.parquet import bucket_id_of_file

NUM_BUCKETS = 4
PKGS = (hyperspace_tpu, hyperspace_tpu_torch)
JAX, TORCH = PKGS


def _name(pkg) -> str:
    return "jax" if pkg is JAX else "torch"


def _mod(pkg, module: str):
    """``pkg``'s module ``module`` (a dotted path under the package)."""
    import importlib

    return importlib.import_module(f"{pkg.__name__}.{module}")


def _session(pkg, root, subdir="ix", route="device"):
    """A session of ``pkg`` over ``root/<pkg>/<subdir>``; the port's takes
    the device routes (``route="device"``: thresholds 0, the kernels'
    plain versions on the CPU) or the host ones (``"host"``)."""
    if pkg is JAX:
        s = JAX.HyperspaceSession(
            system_path=os.path.join(str(root), "jax", subdir))
        s.conf.mesh_enabled = "off"
        s.conf.parallel_build = "off"
    else:
        s = TORCH.HyperspaceSession(
            system_path=os.path.join(str(root), "torch", subdir), device="cpu")
        rows = 0 if route == "device" else 1 << 62
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{kind}_min_rows", rows)
    s.conf.num_buckets = NUM_BUCKETS
    return s


def _write_source(d, n_files=3, rows=120, seed=7):
    os.makedirs(d)
    rng = np.random.default_rng(seed)
    for i in range(n_files):
        pq.write_table(pa.table({
            "k": pa.array((np.arange(rows) + i * rows) % 37, type=pa.int64()),
            "v": pa.array(rng.random(rows)),
        }), os.path.join(d, f"p{i}.parquet"))


class _Side:
    """One package's session, Hyperspace and the fixture's query."""

    def __init__(self, pkg, root, d, route="device", name="ix", **conf):
        self.pkg = pkg
        self.s = _session(pkg, root, route=route)
        for k, v in conf.items():
            setattr(self.s.conf, k, v)
        self.hs = pkg.Hyperspace(self.s)
        self.d = d
        self.name = name
        self.hs.create_index(self.s.read.parquet(d),
                             pkg.IndexConfig(name, ["k"], ["v"]))
        self.s.enable_hyperspace()

    def ds(self, cond=None):
        col = self.pkg.col
        cond = cond if cond is not None else (lambda c: c("k") == 5)
        return self.s.read.parquet(self.d).filter(cond(col)).select("k", "v")

    def query(self):
        return self.ds().collect()

    def expected(self, ds=None):
        ds = ds if ds is not None else self.ds()
        self.s.disable_hyperspace()
        try:
            return ds.collect()
        finally:
            self.s.enable_hyperspace()

    @property
    def mgr(self):
        return self.s.index_collection_manager

    def entry(self, name=None):
        return self.mgr.get_index(name or self.name)

    def files(self, name=None):
        return [f.name for f in self.entry(name).content.file_infos()]

    def qm(self, name=None):
        return self.mgr.quarantine_manager(name or self.name)

    def victim_for_value(self, value=5):
        """The index file of the bucket ``value`` hashes to: the file the
        ``k == value`` query reads."""
        from hyperspace_tpu.io.columnar import to_hash_words
        from hyperspace_tpu.ops.hash import bucket_ids_np

        b = int(bucket_ids_np([np.asarray(to_hash_words(
            pa.array([value], type=pa.int64())))], NUM_BUCKETS)[0])
        return next(p for p in self.files() if bucket_id_of_file(p) == b)


@pytest.fixture()
def both(tmp_path):
    d = str(tmp_path / "data")
    _write_source(d)
    return {pkg: _Side(pkg, tmp_path, d) for pkg in PKGS}


@pytest.fixture(params=PKGS, ids=_name)
def side(request, tmp_path):
    d = str(tmp_path / "data")
    _write_source(d)
    return _Side(request.param, tmp_path, d)


def _bitrot(path: str) -> None:
    """Flip 8 bytes in the middle, keeping size and mtime."""
    st = os.stat(path)
    with open(path, "r+b") as f:
        off = max(0, st.st_size // 2 - 4)
        f.seek(off)
        chunk = f.read(8)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in chunk))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def _bitrot_pages(path: str) -> None:
    """Garble every data page, leaving the footer valid and size and
    mtime as they were: only the digest attributes the damage."""
    st = os.stat(path)
    with open(path, "rb") as f:
        data = bytearray(f.read())
    footer_start = len(data) - 8 - int.from_bytes(data[-8:-4], "little")
    assert footer_start > 4
    for i in range(4, footer_start):
        data[i] ^= 0xFF
    with open(path, "wb") as f:
        f.write(data)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))


def _truncate(path: str) -> None:
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


def _sorted(t: pa.Table) -> pa.Table:
    return t.sort_by([("k", "ascending"), ("v", "ascending")])


def _bucket_in_filters(plan, bucket_in_cls):
    out = []

    def walk(node):
        cond = getattr(node, "condition", None)
        if type(node).__name__ == "Filter" and isinstance(cond, bucket_in_cls):
            out.append(node)
        for c in node.children:
            walk(c)

    walk(plan)
    return out


def _bucket_ins(pkg, plan):
    return _bucket_in_filters(plan, _mod(pkg, "plan.expr").BucketIn)


def _report(table, root):
    """A verify report's rows with the system path and the random part of
    the file names taken out."""
    def clean(x):
        return re.sub(r"part-b(\d{5})-[0-9a-f]{12}", r"part-b\1", x)

    return [{**r, "file": clean(os.path.relpath(r["file"], root)),
             "detail": clean(r["detail"].replace(root, "<ix>"))}
            for r in table.to_pylist()]


def _bucket_sha256(entry):
    """bucket -> sorted sha256 of its files."""
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(v) for b, v in out.items()}


# ---------------------------------------------------------------------------
# Digest on write
# ---------------------------------------------------------------------------
class TestDigestOnWrite:
    def test_create_records_digests(self, side):
        integrity = _mod(side.pkg, "io.integrity")
        infos = side.entry().content.file_infos()
        assert infos and all(
            f.digest and f.digest.startswith(integrity.DEFAULT_ALGO + ":")
            for f in infos)
        for f in infos:
            assert integrity.digest_file(f.name) == f.digest

    def test_source_files_have_no_digest(self, side):
        assert all(f.digest is None for f in side.entry().source_file_infos())

    def test_refresh_and_optimize_record_digests(self, side):
        rng = np.random.default_rng(8)
        pq.write_table(pa.table({
            "k": pa.array(np.arange(50) % 37, type=pa.int64()),
            "v": pa.array(rng.random(50))}),
            os.path.join(side.d, "p3.parquet"))
        side.hs.refresh_index("ix", mode="full")
        assert all(f.digest for f in side.entry().content.file_infos())
        side.s.conf.optimize_file_size_threshold = 1 << 30
        side.hs.optimize_index("ix", mode="full")
        assert all(f.digest for f in side.entry().content.file_infos())

    def test_digest_on_write_disabled(self, side, tmp_path):
        d = str(tmp_path / "data2")
        os.makedirs(d)
        pq.write_table(pa.table({"k": pa.array(np.arange(40) % 7,
                                               type=pa.int64()),
                                 "v": pa.array(np.arange(40) * 1.0)}),
                       os.path.join(d, "p.parquet"))
        side.s.conf.integrity_digest_on_write = False
        side.hs.create_index(side.s.read.parquet(d),
                             side.pkg.IndexConfig("nodig", ["k"], ["v"]))
        assert all(f.digest is None
                   for f in side.entry("nodig").content.file_infos())
        report = side.hs.verify_index("nodig", mode="full")
        assert set(report.column("status").to_pylist()) == {"unknown"}
        assert not any(report.column("quarantined").to_pylist())
        side.s.conf.integrity_digest_on_write = True

    def test_digests_equal_across_packages(self):
        """One algorithm, one format: the same bytes give the same digest
        in both packages, with either algorithm, and a digest one package
        wrote verifies in the other."""
        jint, tint = _mod(JAX, "io.integrity"), _mod(TORCH, "io.integrity")
        assert tint.DEFAULT_ALGO == jint.DEFAULT_ALGO
        data = np.random.default_rng(3).bytes(3 << 20)  # over one read
        for algo in ("xxh64", "blake2b16"):
            assert tint.digest_bytes(data, algo) == jint.digest_bytes(data, algo)
        assert tint.verify_file(__file__, jint.digest_file(__file__,
                                                           "blake2b16"))
        assert jint.verify_file(__file__, tint.digest_file(__file__))
        assert tint.verify_file(__file__, "md5:00") is None

    def test_recorder_is_bounded_and_follows_the_conf(self, tmp_path):
        tint = _mod(TORCH, "io.integrity")
        paths = []
        for i in range(3):
            p = str(tmp_path / f"f{i}")
            with open(p, "wb") as f:
                f.write(bytes([i]) * 10)
            paths.append(p)
        old = tint._MAX_RECORDED
        tint._MAX_RECORDED = 2
        tint.set_enabled(True)
        try:
            for p in paths:
                assert tint.record_file(p) == tint.digest_file(p)
            assert tint.recorded_digest(paths[0]) is None
            assert tint.recorded_digest(paths[2]) == tint.digest_file(paths[2])
        finally:
            tint._MAX_RECORDED = old
        conf = TORCH.HyperspaceSession(str(tmp_path), device="cpu").conf
        conf.integrity_digest_on_write = False
        tint.configure_from_conf(conf)
        try:
            assert tint.record_file(paths[1]) is None
        finally:
            tint.set_enabled(True)
        tint.clear_recorded()
        assert tint.recorded_digest(paths[2]) is None


# ---------------------------------------------------------------------------
# Log entries, digests included
# ---------------------------------------------------------------------------
def _entry_json(entry, roots):
    """A log entry's JSON with its timestamp dropped, the system paths
    and a sketch file's random name taken out: digests stay."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items() if k != "timestamp"}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if isinstance(x, str):
            for r in roots:
                x = x.replace(r, "<ix>")
            x = re.sub(r"sketch-[0-9a-f]{12}\.parquet", "sketch.parquet", x)
            return re.sub(r"part-b(\d{5})-[0-9a-f]{12}", r"part-b\1", x)
        return x

    d = entry.to_dict()
    # The content tree as its leaf files (the trees differ in the
    # directory names of the two system paths), with their digests.
    d["content"] = sorted(walk([f.name, f.size, f.digest]) for f in
                          entry.content.file_infos())
    return walk(d)


class TestEntries:
    @pytest.mark.parametrize("verb", ["create", "incremental", "optimize",
                                      "sketch"])
    def test_log_entry_json_equal(self, tmp_path, verb):
        d = str(tmp_path / "data")
        _write_source(d)
        roots = [str(tmp_path / n) for n in ("jax", "torch")]
        sides = {}
        for pkg in PKGS:
            s = _session(pkg, tmp_path)
            s.conf.lineage_enabled = True
            s.conf.optimize_file_size_threshold = 1 << 30
            hs = pkg.Hyperspace(s)
            config = pkg.DataSkippingIndexConfig("ix", ["k"]) \
                if verb == "sketch" else pkg.IndexConfig("ix", ["k"], ["v"])
            hs.create_index(s.read.parquet(d), config)
            sides[pkg] = (s, hs)
        if verb in ("incremental", "optimize"):
            pq.write_table(pa.table({
                "k": pa.array([5, 6, 40], type=pa.int64()),
                "v": pa.array([0.5, 0.25, 0.125])}),
                os.path.join(d, "p9.parquet"))
        out = {}
        for pkg, (s, hs) in sides.items():
            if verb in ("incremental", "optimize"):
                assert hs.refresh_index("ix", mode="incremental") \
                    .outcome == "ok"
            if verb == "optimize":
                assert hs.optimize_index("ix", mode="quick").outcome == "ok"
            entry = s.index_collection_manager.get_index("ix")
            assert all(f.digest for f in entry.content.file_infos())
            out[pkg] = _entry_json(entry, roots)
        assert out[TORCH] == out[JAX]


# ---------------------------------------------------------------------------
# Scrub
# ---------------------------------------------------------------------------
class TestScrub:
    def test_clean_scrub_both_modes(self, side):
        for mode in ("quick", "full"):
            report = side.hs.verify_index("ix", mode=mode)
            assert set(report.column("status").to_pylist()) == {"ok"}
            assert report.num_rows == len(side.files())
            assert report.schema.names == ["file", "status", "detail",
                                           "quarantined"]

    def test_full_scrub_flags_exactly_the_bitrotted_file(self, side):
        victim = side.files()[0]
        _bitrot(victim)
        quick = side.hs.verify_index("ix", mode="quick")
        assert set(quick.column("status").to_pylist()) == {"ok"}
        full = side.hs.verify_index("ix", mode="full")
        by = dict(zip(full.column("file").to_pylist(),
                      full.column("status").to_pylist()))
        assert by[victim] == "digest-mismatch"
        assert sum(1 for v in by.values() if v != "ok") == 1
        assert side.qm().paths() == {victim}

    def test_quick_scrub_flags_truncate_and_missing(self, side):
        truncated, missing = side.files()[0], side.files()[1]
        _truncate(truncated)
        os.unlink(missing)
        report = side.hs.verify_index("ix", mode="quick")
        by = dict(zip(report.column("file").to_pylist(),
                      report.column("status").to_pylist()))
        assert by[truncated] == "size-mismatch"
        assert by[missing] == "missing"
        assert side.qm().paths() == {truncated, missing}

    def test_full_scrub_releases_restored_file(self, side, tmp_path):
        victim = side.files()[0]
        backup = str(tmp_path / f"backup-{_name(side.pkg)}.parquet")
        st = os.stat(victim)
        shutil.copy2(victim, backup)
        _bitrot(victim)
        side.hs.verify_index("ix", mode="full")
        assert victim in side.qm().paths()
        shutil.copy2(backup, victim)
        os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns))
        # Quick mode read no byte, so it releases nothing.
        side.hs.verify_index("ix", mode="quick")
        assert victim in side.qm().paths()
        report = side.hs.verify_index("ix", mode="full")
        assert set(report.column("status").to_pylist()) == {"ok"}
        assert side.qm().paths() == set()

    def test_full_scrub_collects_stale_records(self, side):
        stale = os.path.join(side.mgr.index_path("ix")
                             if side.pkg is TORCH else
                             side.mgr.path_resolver.get_index_path("ix"),
                             "v__=0", "part-b00009-gone.parquet")
        side.qm().add(stale, "test")
        side.hs.verify_index("ix", mode="quick")
        assert stale in side.qm().paths()
        side.hs.verify_index("ix", mode="full")
        assert side.qm().paths() == set()

    def test_verify_unknown_mode_and_missing_index(self, side):
        err = _mod(side.pkg, "exceptions").HyperspaceError
        with pytest.raises(err, match="mode"):
            side.hs.verify_index("ix", mode="paranoid")
        with pytest.raises(err, match="does not exist"):
            side.hs.verify_index("nope", mode="quick")

    @pytest.mark.parametrize("damage", ["clean", "bitrot", "truncate",
                                        "missing", "mtime", "restored"])
    @pytest.mark.parametrize("mode", ["quick", "full"])
    def test_scrub_reports_equal_across_packages(self, both, tmp_path,
                                                 damage, mode):
        """The same damage to the same bucket's file gives the same report
        table in both packages, up to the system path."""
        reports = {}
        for pkg, sd in both.items():
            victim = sd.files()[1]
            if damage == "bitrot":
                _bitrot(victim)
            elif damage == "truncate":
                _truncate(victim)
            elif damage == "missing":
                os.unlink(victim)
            elif damage == "mtime":
                st = os.stat(victim)
                os.utime(victim, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
            elif damage == "restored":
                sd.qm().add(victim, "earlier scrub")
            root = str(tmp_path / _name(pkg))
            rows = _report(sd.hs.verify_index("ix", mode=mode), root)
            for r in rows:
                # The mtimes in a detail differ between the two copies.
                r["detail"] = re.sub(r"mtime \d+ != recorded \d+",
                                     "mtime drift", r["detail"])
            reports[pkg] = rows
            reports[pkg, "quarantine"] = sorted(
                re.sub(r"-[0-9a-f]{12}\.", ".", os.path.relpath(p, root))
                for p in sd.qm().paths())
        assert reports[TORCH] == reports[JAX]
        assert reports[TORCH, "quarantine"] == reports[JAX, "quarantine"]


# ---------------------------------------------------------------------------
# Containment
# ---------------------------------------------------------------------------
class TestContainment:
    def test_quarantined_bucket_served_from_source(self, both):
        """Bit rot in one file, a full scrub flags exactly it, the query
        still reads the index with only that bucket from the source (in
        strict mode: containment is a plan, not a fallback), with the
        JAX package's rows in its order; repair rebuilds that bucket
        alone and the scrub is clean again."""
        rows = {}
        for pkg, sd in both.items():
            expected = sd.expected()
            victim = sd.files()[0]
            victim_bucket = bucket_id_of_file(victim)
            _bitrot(victim)
            full = sd.hs.verify_index("ix", mode="full")
            flagged = [f for f, st_ in zip(full.column("file").to_pylist(),
                                           full.column("status").to_pylist())
                       if st_ != "ok"]
            assert flagged == [victim]
            sd.s.conf.degraded_fallback_to_source = False
            ds = sd.ds()
            plan = ds.optimized_plan()
            index_scans = [n for n in plan.leaf_relations()
                           if n.relation.index_scan_of == "ix"]
            assert index_scans
            for n in index_scans:
                assert victim not in (n.relation.file_paths or ())
            filters = _bucket_ins(pkg, plan)
            assert len(filters) == 1
            assert filters[0].condition.buckets == (victim_bucket,)
            assert filters[0].condition.num_buckets == NUM_BUCKETS
            got = ds.collect()
            assert _sorted(got).equals(_sorted(expected))
            rows[pkg] = got.to_pylist()

            before = set(sd.files())
            summary = sd.hs.refresh_index("ix", mode="repair")
            assert summary.mode == "repair"
            # The JAX package's RepairAction.run drops the outcome, so
            # its summary reads "noop" for a committed repair.
            assert summary.outcome == ("ok" if pkg is TORCH else "noop")
            after = set(sd.files())
            kept = before & after
            assert victim not in after
            assert all(bucket_id_of_file(p) != victim_bucket for p in kept)
            assert {bucket_id_of_file(p) for p in after - kept} \
                == {victim_bucket}
            report = sd.hs.verify_index("ix", mode="full")
            assert set(report.column("status").to_pylist()) == {"ok"}
            assert sd.qm().paths() == set()
            assert not _bucket_ins(pkg, ds.optimized_plan())
            assert _sorted(ds.collect()).equals(_sorted(expected))
        assert rows[TORCH] == rows[JAX]

    def test_multifile_bucket_drops_whole_bucket(self, tmp_path):
        d = str(tmp_path / "data")
        os.makedirs(d)
        rng = np.random.default_rng(3)
        pq.write_table(pa.table({
            "k": pa.array(np.arange(400) % 11, type=pa.int64()),
            "v": pa.array(rng.random(400))}), os.path.join(d, "p.parquet"))
        rows = {}
        for pkg in PKGS:
            s = _session(pkg, tmp_path)
            s.conf.num_buckets = 2
            s.conf.index_max_rows_per_file = 40
            hs = pkg.Hyperspace(s)
            hs.create_index(s.read.parquet(d), pkg.IndexConfig("mf", ["k"], ["v"]))
            ds = s.read.parquet(d).filter(pkg.col("k") < 6).select("k", "v")
            expected = ds.collect()
            s.enable_hyperspace()
            files = [f.name for f in
                     s.index_collection_manager.get_index("mf").content.file_infos()]
            bucket = bucket_id_of_file(files[0])
            siblings = [p for p in files if bucket_id_of_file(p) == bucket]
            assert len(siblings) > 1
            _bitrot(files[0])
            hs.verify_index("mf", mode="full")
            for node in ds.optimized_plan().leaf_relations():
                if node.relation.index_scan_of == "mf":
                    assert not set(siblings) & set(node.relation.file_paths)
            got = ds.collect()
            assert _sorted(got).equals(_sorted(expected))
            # A bucket's files are read in the order of their random
            # names, so only the multiset of rows is the packages' own.
            rows[pkg] = _sorted(got).to_pylist()
        assert rows[TORCH] == rows[JAX]

    def test_quarantine_persists_across_sessions(self, side, tmp_path):
        expected = side.expected()
        _bitrot(side.files()[0])
        side.hs.verify_index("ix", mode="full")
        s2 = _session(side.pkg, tmp_path)
        s2.enable_hyperspace()
        ds = s2.read.parquet(side.d).filter(side.pkg.col("k") == 5) \
            .select("k", "v")
        assert _bucket_ins(side.pkg, ds.optimized_plan())
        assert _sorted(ds.collect()).equals(_sorted(expected))

    def test_join_rule_skips_quarantined_entry(self, both):
        out = {}
        for pkg, sd in both.items():
            col = pkg.col
            ds = (sd.s.read.parquet(sd.d).filter(col("k") < 3)
                  .join(sd.s.read.parquet(sd.d), col("k") == col("k"))
                  .select("k", "v"))
            base = sd.expected(ds)
            _bitrot(sd.files()[0])
            sd.hs.verify_index("ix", mode="full")
            plan = ds.optimized_plan()
            joins = [n for n in _walk(plan) if type(n).__name__ == "Join"]
            assert joins
            for j in joins:
                for child in j.children:
                    assert not any(n.relation.bucket_spec
                                   for n in child.leaf_relations()
                                   if n.relation.index_scan_of)
            got = ds.collect()
            assert sorted(got.column("k").to_pylist()) == \
                sorted(base.column("k").to_pylist())
            out[pkg] = sorted(got.to_pylist(), key=lambda r: (r["k"], r["v"]))
        assert out[TORCH] == out[JAX]

    def test_fully_quarantined_index_falls_back_to_source(self, side):
        expected = side.expected()
        for path in side.files():
            _bitrot(path)
        side.hs.verify_index("ix", mode="full")
        got = side.query()
        assert _sorted(got).equals(_sorted(expected))
        assert not any(x["is_index"] for x in side.s.last_execution_stats["scans"])


def _walk(plan):
    yield plan
    for c in plan.children:
        yield from _walk(c)


# ---------------------------------------------------------------------------
# Execution-time containment
# ---------------------------------------------------------------------------
class TestExecutionContainment:
    def test_truncate_discovered_at_execution(self, both):
        rows = {}
        for pkg, sd in both.items():
            expected = sd.expected()
            victim = sd.victim_for_value()
            _truncate(victim)
            got = sd.query()
            assert _sorted(got).equals(_sorted(expected))
            assert victim in sd.qm().paths()
            assert any(x["is_index"] for x in sd.s.last_execution_stats["scans"])
            rows[pkg] = got.to_pylist()
        assert rows[TORCH] == rows[JAX]
        record = both[TORCH].s.last_execution_stats["containment"]
        assert record["replan"] == "containment"
        assert record["quarantined"] == [both[TORCH].victim_for_value()]

    def test_bitrot_discovered_at_execution_via_digest_probe(self, side):
        expected = side.expected()
        victim = side.victim_for_value()
        _bitrot_pages(victim)
        pq.read_metadata(victim)
        got = side.query()
        assert _sorted(got).equals(_sorted(expected))
        recs = {r["path"]: r["reason"] for r in side.qm().records()}
        assert "digest mismatch" in recs[victim]

    def test_containment_disabled_falls_back_whole_index(self, side):
        expected = side.expected()
        side.s.conf.integrity_quarantine_on_failure = False
        _truncate(side.victim_for_value())
        got = side.query()
        assert _sorted(got).equals(_sorted(expected))
        assert side.qm().paths() == set()
        assert not any(x["is_index"] for x in side.s.last_execution_stats["scans"])

    def test_strict_mode_raises_the_read_error(self, side):
        """Without the source fallback the read error propagates and
        nothing is quarantined."""
        side.s.conf.degraded_fallback_to_source = False
        _truncate(side.victim_for_value())
        with pytest.raises((OSError, pa.ArrowException)):
            side.query()
        assert side.qm().paths() == set()

    def test_containment_is_recorded(self, both):
        """The port's execution stats name what the JAX package's run
        report names: the quarantined file and the containment re-plan
        (the run report itself is not ported)."""
        from hyperspace_tpu.telemetry import trace

        for pkg, sd in both.items():
            _truncate(sd.victim_for_value())
        jds = both[JAX].ds()
        trace.enable_tracing()
        try:
            jds.collect()
        finally:
            trace.disable_tracing()
        rep = jds.last_run_report()
        quarantines = [d for d in rep.decisions if d["kind"] == "quarantine"]
        assert quarantines[0]["files"] == [both[JAX].victim_for_value()]
        assert any(d["kind"] == "replan" and d["mode"] == "containment"
                   for d in rep.decisions)
        both[TORCH].query()
        record = both[TORCH].s.last_execution_stats["containment"]
        assert record["quarantined"] == [both[TORCH].victim_for_value()]
        assert record["replan"] == "containment"
        assert "Arrow" in record["error"] or "Error" in record["error"]

    def test_auto_repair_heals_after_containment(self, both):
        digests = {}
        for pkg, sd in both.items():
            expected = sd.expected()
            sd.s.conf.auto_repair_enabled = True
            victim = sd.victim_for_value()
            _truncate(victim)
            got = sd.query()
            assert _sorted(got).equals(_sorted(expected))
            assert sd.qm().paths() == set()
            report = sd.hs.verify_index("ix", mode="full")
            assert set(report.column("status").to_pylist()) == {"ok"}
            assert victim not in sd.files()
            digests[pkg] = _bucket_sha256(sd.entry())
        assert digests[TORCH] == digests[JAX]


# ---------------------------------------------------------------------------
# No fallback hides a device error
# ---------------------------------------------------------------------------
class TestDeviceErrorsPropagate:
    def test_device_filter_error_propagates(self, tmp_path, monkeypatch):
        d = str(tmp_path / "data")
        _write_source(d)
        sd = _Side(TORCH, tmp_path, d)
        from hyperspace_tpu_torch.ops import filter as tfilter

        def broken(*args, **kwargs):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(tfilter, "compile_predicate", broken)
        assert sd.s.conf.integrity_quarantine_on_failure
        assert sd.s.conf.degraded_fallback_to_source
        with pytest.raises(RuntimeError, match="illegal memory access"):
            sd.ds(lambda c: c("k") < 20).collect()
        assert sd.qm().paths() == set()
        # The same with a quarantined bucket: the BucketIn branch's hash
        # kernel fails, and nothing answers from the source instead.
        monkeypatch.undo()
        _bitrot(sd.files()[0])
        sd.hs.verify_index("ix", mode="full")
        from hyperspace_tpu_torch.ops import hash as thash

        monkeypatch.setattr(thash, "bucket_ids", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            sd.query()
        assert sd.qm().paths() == {sd.files()[0]}

    def test_device_error_in_the_containment_replan_propagates(
            self, tmp_path, monkeypatch):
        """A read error starts containment; the re-plan's device error
        still propagates: the source fallback is not taken."""
        d = str(tmp_path / "data")
        _write_source(d)
        sd = _Side(TORCH, tmp_path, d)
        victim = sd.victim_for_value()
        _truncate(victim)
        from hyperspace_tpu_torch.ops import hash as thash

        def broken(*args, **kwargs):
            raise RuntimeError("hash_buckets.cu: launch failed")

        monkeypatch.setattr(thash, "bucket_ids", broken)
        with pytest.raises(RuntimeError, match="launch failed"):
            sd.query()
        # The probe ran before the re-plan: the file is quarantined.
        assert sd.qm().paths() == {victim}

    def test_is_read_error(self):
        from hyperspace_tpu_torch.execution.containment import is_read_error

        assert is_read_error(OSError("eio"))
        assert is_read_error(pa.ArrowInvalid("bad footer"))
        assert is_read_error(FileNotFoundError("gone"))
        assert not is_read_error(RuntimeError("CUDA error"))
        assert not is_read_error(ValueError("x"))


# ---------------------------------------------------------------------------
# Repair
# ---------------------------------------------------------------------------
class TestRepair:
    def test_repair_noop_without_quarantine(self, side):
        lm = side.mgr._log_manager("ix")
        before = lm.get_latest_id()
        summary = side.hs.refresh_index("ix", mode="repair")
        assert summary.outcome == "noop"
        assert lm.get_latest_id() == before

    def test_repair_rejects_drifted_source(self, side):
        err = _mod(side.pkg, "exceptions").HyperspaceError
        _bitrot(side.files()[0])
        side.hs.verify_index("ix", mode="full")
        src = sorted(glob.glob(os.path.join(side.d, "*.parquet")))[0]
        t = pq.read_table(src)
        pq.write_table(t.slice(0, t.num_rows - 1), src)
        with pytest.raises(err, match="refresh"):
            side.hs.refresh_index("ix", mode="repair")

    def test_repair_rejects_missing_source(self, side):
        err = _mod(side.pkg, "exceptions").HyperspaceError
        _bitrot(side.files()[0])
        side.hs.verify_index("ix", mode="full")
        os.remove(sorted(glob.glob(os.path.join(side.d, "*.parquet")))[0])
        with pytest.raises(err, match="gone"):
            side.hs.refresh_index("ix", mode="repair")

    def test_repair_refuses_a_data_skipping_index(self, side):
        err = _mod(side.pkg, "exceptions").HyperspaceError
        side.hs.create_index(side.s.read.parquet(side.d),
                             side.pkg.DataSkippingIndexConfig("ds", ["k"]))
        sketch = side.files("ds")[0]
        side.qm("ds").add(sketch, "test")
        with pytest.raises(err, match="covering"):
            side.hs.refresh_index("ds", mode="repair")

    def test_repair_with_lineage_preserves_hybrid_deletes(self, side, tmp_path):
        d = str(tmp_path / "lin")
        os.makedirs(d)
        rng = np.random.default_rng(5)
        for i in range(2):
            pq.write_table(pa.table({
                "k": pa.array(np.arange(60) % 13, type=pa.int64()),
                "v": pa.array(rng.random(60))}),
                os.path.join(d, f"p{i}.parquet"))
        side.s.conf.lineage_enabled = True
        side.hs.create_index(side.s.read.parquet(d),
                             side.pkg.IndexConfig("lin", ["k"], ["v"]))
        entry = side.entry("lin")
        assert entry.has_lineage_column()
        _bitrot(entry.content.file_infos()[0].name)
        side.hs.verify_index("lin", mode="full")
        side.hs.refresh_index("lin", mode="repair")
        repaired = side.entry("lin")
        assert repaired.has_lineage_column()
        new = [f.name for f in repaired.content.file_infos()
               if f.name not in {x.name for x in entry.content.file_infos()}]
        assert new
        for p in new:
            assert "_data_file_id" in pq.read_schema(p).names

    @pytest.mark.parametrize("lineage", [False, True], ids=["plain", "lineage"])
    @pytest.mark.parametrize("route", ["device", "host"])
    def test_repair_bytes_equal_jax(self, tmp_path, lineage, route):
        """Each repaired bucket's files have the sha256 of the JAX
        package's repair of the same damage, through either route of the
        port; both equal the build before the damage (the repair
        re-derives the bucket's rows in the build's order)."""
        d = str(tmp_path / "data")
        _write_source(d, n_files=4, rows=150)
        digests = {}
        for pkg in PKGS:
            sd = _Side(pkg, tmp_path, d, route=route, lineage_enabled=lineage,
                       index_max_rows_per_file=70)
            pristine = _bucket_sha256(sd.entry())
            damaged = [p for p in sd.files() if bucket_id_of_file(p) in (1, 3)]
            _bitrot(damaged[0])
            _truncate(damaged[-1])
            sd.hs.verify_index("ix", mode="full")
            assert {bucket_id_of_file(p) for p in sd.qm().paths()} == {1, 3}
            report_before = len(sd.s.build_stats_log) \
                if pkg is TORCH else None
            sd.hs.refresh_index("ix", mode="repair")
            digests[pkg] = _bucket_sha256(sd.entry())
            assert not {bucket_id_of_file(p) for p in sd.qm().paths()}
            assert digests[pkg] == pristine
            assert all(f.digest for f in sd.entry().content.file_infos())
            if pkg is TORCH:
                phases = sd.s.build_stats_log[report_before]
                assert {"read_s", "kernel_s", "write_s", "sketch_s"} \
                    <= set(phases)
                assert sd.hs.last_build_report().action == "RepairAction"
        assert digests[TORCH] == digests[JAX]

    def test_repair_routes_launch_the_kernels(self, tmp_path):
        """Above the build threshold the repair hashes through
        ``ops.hash.bucket_ids`` and cuts its runs with
        ``io.parquet.bucket_offsets`` (the kernels' wrappers); below it
        it takes the host mirror and the wrappers' counts stay 0."""
        from hyperspace_tpu_torch.ops import kernels

        d = str(tmp_path / "data")
        _write_source(d)
        for route, want in (("device", 1), ("host", 0)):
            sd = _Side(TORCH, tmp_path / route, d, route=route)
            _bitrot(sd.files()[2])
            sd.hs.verify_index("ix", mode="full")
            calls = {"hash": 0, "hist": 0}
            real_hash, real_hist = kernels.hash_buckets, kernels.bucket_histogram

            def hash_spy(*a, **k):
                calls["hash"] += 1
                return real_hash(*a, **k)

            def hist_spy(*a, **k):
                calls["hist"] += 1
                return real_hist(*a, **k)

            import hyperspace_tpu_torch.ops.hash as thash
            import hyperspace_tpu_torch.ops.sort as tsort

            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(thash, "hash_buckets", hash_spy)
                mp.setattr(tsort, "bucket_histogram", hist_spy)
                sd.hs.refresh_index("ix", mode="repair")
            # On the host route the histogram's plain version still cuts
            # the runs of the host ids (a CPU tensor).
            assert calls == {"hash": want, "hist": 1}


# ---------------------------------------------------------------------------
# BucketIn
# ---------------------------------------------------------------------------
def _key_tables():
    rng = np.random.default_rng(11)
    n = 64
    ints = rng.integers(-1000, 1000, n)
    floats = rng.random(n) * 100 - 50
    floats[:4] = [0.0, -0.0, np.nan, -np.nan]
    strings = [f"s{v}" for v in rng.integers(0, 40, n)]
    mask = rng.random(n) < 0.2
    return pa.table({
        "i": pa.array(ints, type=pa.int64()),
        "f": pa.array(floats),
        "s": pa.array(strings),
        "n": pa.array(ints, mask=mask, type=pa.int64()),
        "t": pa.array([None if m else s for s, m in zip(strings, mask)]),
    })


class TestBucketIn:
    @pytest.mark.parametrize("columns", [("i",), ("f",), ("s",), ("n",), ("t",),
                                         ("i", "s"), ("f", "n"), ("t", "f")])
    @pytest.mark.parametrize("route", ["device", "host"])
    def test_mask_equals_the_jax_host_mirror(self, tmp_path, columns, route):
        from hyperspace_tpu.execution.executor import _arrow_eval as jax_eval
        from hyperspace_tpu.plan.expr import BucketIn as JaxBucketIn
        from hyperspace_tpu_torch.execution.executor import Executor
        from hyperspace_tpu_torch.plan.expr import BucketIn

        table = _key_tables()
        s = _session(TORCH, tmp_path, route=route)
        for num_buckets, buckets in ((7, (0, 3, 5)), (200, tuple(range(0, 200, 3)))):
            ex = Executor(s)
            got = ex._eval_predicate(BucketIn(columns, num_buckets, buckets),
                                     table)
            want = jax_eval(JaxBucketIn(columns, num_buckets, buckets), table)
            assert got.dtype == np.bool_
            assert want.null_count == 0
            assert got.tolist() == want.to_pylist()
            assert 0 < got.sum() < len(got)
            assert ex.stats["bucket_in"] == [{"strategy": route,
                                              "rows": table.num_rows}]
            assert ex.stats["filters"][0]["strategy"] == "host"

    def test_bucket_in_under_and_or_not(self, tmp_path):
        from hyperspace_tpu.execution.executor import _arrow_eval as jax_eval
        from hyperspace_tpu.plan import expr as je
        from hyperspace_tpu_torch.execution.executor import Executor
        from hyperspace_tpu_torch.plan import expr as te

        def expr(mod):
            b = mod.BucketIn(("i",), 5, (1, 2))
            return mod.Or(mod.And(b, mod.Col("f") > 0), mod.Not(b))

        table = _key_tables()
        got = Executor(_session(TORCH, tmp_path))._eval_predicate(
            expr(te), table)
        assert got.tolist() == jax_eval(expr(je), table).to_pylist()

    def test_bucket_in_is_opaque(self, tmp_path):
        """The device predicate refuses it, its columns are referenced,
        and it prints as the JAX package's."""
        from hyperspace_tpu.plan.expr import BucketIn as JaxBucketIn
        from hyperspace_tpu_torch.ops.filter import compile_predicate
        from hyperspace_tpu_torch.plan.expr import BucketIn

        b = BucketIn(("k", "s"), 8, (5, 1, 5))
        assert b.buckets == (1, 5)
        assert b.referenced_columns() == {"k", "s"}
        assert repr(b) == repr(JaxBucketIn(("k", "s"), 8, (5, 1, 5)))
        with pytest.raises(ValueError):
            compile_predicate(b, ["k", "s"])
        with pytest.raises(ValueError):
            BucketIn((), 8, (1,))

    def test_containment_branch_routes(self, tmp_path):
        """The containment query's BucketIn takes the kernel's route with
        the build threshold at 0 and the host mirror above the rows."""
        d = str(tmp_path / "data")
        _write_source(d)
        rows = {}
        for route in ("device", "host"):
            sd = _Side(TORCH, tmp_path / route, d, route=route)
            _bitrot(sd.victim_for_value())
            sd.hs.verify_index("ix", mode="full")
            rows[route] = sd.query().to_pylist()
            assert [r["strategy"] for r in
                    sd.s.last_execution_stats["bucket_in"]] == [route]
        assert rows["device"] == rows["host"]


# ---------------------------------------------------------------------------
# Quarantine records across the packages
# ---------------------------------------------------------------------------
class TestCrossPackageQuarantine:
    """Both packages take their default store, ``EmulatedObjectStore``
    (file names percent-encoded once more than the keys)."""

    # conf.log_store_class per package; None keeps the default.
    store_classes = {JAX: None, TORCH: None}

    def _twin(self, tmp_path):
        """One index, built by the JAX package, read by both."""
        d = str(tmp_path / "data")
        _write_source(d)
        pinned = {pkg: {"log_store_class": cls}
                  for pkg, cls in self.store_classes.items() if cls}
        jside = _Side(JAX, tmp_path, d, **pinned.get(JAX, {}))
        ts = TORCH.HyperspaceSession(
            system_path=jside.s.conf.system_path, device="cpu")
        for k, v in pinned.get(TORCH, {}).items():
            setattr(ts.conf, k, v)
        ts.conf.num_buckets = NUM_BUCKETS
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(ts.conf, f"device_{kind}_min_rows", 0)
        ts.enable_hyperspace()
        return jside, ts

    def test_records_read_both_ways(self, tmp_path):
        jside, ts = self._twin(tmp_path)
        tqm = ts.index_collection_manager.quarantine_manager("ix")
        jqm = jside.qm()
        a, b = jside.files()[0], jside.files()[1]
        assert jqm.add(a, "jax wrote", size=11)
        assert tqm.paths() == {a} and tqm.is_quarantined(a)
        rec = tqm.records()[0]
        assert (rec["path"], rec["reason"], rec["size"]) == (a, "jax wrote", 11)
        assert not tqm.add(a, "again")
        assert tqm.add(b, "torch wrote")
        assert jqm.paths() == {a, b}
        assert jqm.store.generation(jqm._key(b)) == 1
        assert {r["reason"] for r in jqm.records()} == {"jax wrote",
                                                        "torch wrote"}
        tqm.remove(a)
        assert jqm.paths() == {b}
        jqm.clear()
        assert tqm.paths() == set()

    def test_jax_verify_contained_by_the_port(self, tmp_path):
        jside, ts = self._twin(tmp_path)
        expected = jside.expected()
        victim = jside.victim_for_value()
        _bitrot(victim)
        jside.hs.verify_index("ix", mode="full")
        ds = ts.read.parquet(jside.d).filter(TORCH.col("k") == 5) \
            .select("k", "v")
        plan = ds.optimized_plan()
        assert len(_bucket_ins(TORCH, plan)) == 1
        got = ds.collect()
        assert got.to_pylist() == jside.query().to_pylist()
        assert _sorted(got).equals(_sorted(expected))
        # The port repairs what the JAX package quarantined, and the JAX
        # package's scrub finds it clean.
        assert TORCH.Hyperspace(ts).refresh_index("ix", "repair").outcome == "ok"
        report = jside.hs.verify_index("ix", mode="full")
        assert set(report.column("status").to_pylist()) == {"ok"}
        assert jside.qm().paths() == set()

    def test_port_verify_read_by_jax(self, tmp_path):
        jside, ts = self._twin(tmp_path)
        victim = jside.files()[2]
        _bitrot(victim)
        tport = TORCH.Hyperspace(ts).verify_index("ix", mode="full")
        assert tport.column("status").to_pylist().count("digest-mismatch") == 1
        assert jside.qm().paths() == {victim}
        assert _bucket_ins(JAX, jside.ds().optimized_plan())


class TestCrossPackageQuarantinePosix(TestCrossPackageQuarantine):
    """The same cases with both packages pinned to ``PosixLogStore``."""

    store_classes = {JAX: "hyperspace_tpu.io.log_store.PosixLogStore",
                     TORCH: "hyperspace_tpu_torch.io.log_store.PosixLogStore"}


# ---------------------------------------------------------------------------
# Hybrid scan and quarantine
# ---------------------------------------------------------------------------
class TestHybridQuarantine:
    def test_appended_files_plus_quarantined_bucket(self, both, tmp_path):
        rng = np.random.default_rng(9)
        rows = {}
        for pkg, sd in both.items():
            sd.s.conf.hybrid_scan_enabled = True
            if pkg is JAX:
                pq.write_table(pa.table({
                    "k": pa.array(np.full(10, 5), type=pa.int64()),
                    "v": pa.array(rng.random(10))}),
                    os.path.join(sd.d, "appended.parquet"))
            _bitrot(sd.files()[0])
            sd.hs.verify_index("ix", mode="full")
            ds = sd.ds()
            fresh_expected = sd.expected(ds)
            plan = ds.optimized_plan()
            assert any(n.relation.index_scan_of == "ix"
                       for n in plan.leaf_relations())
            assert _bucket_ins(pkg, plan)
            got = ds.collect()
            assert _sorted(got).equals(_sorted(fresh_expected))
            rows[pkg] = got.to_pylist()
        assert rows[TORCH] == rows[JAX]

    def test_quarantine_with_lineage_deletes(self, tmp_path):
        """Deleted source files under hybrid scan and a quarantined
        bucket: the source branch reads the common files only."""
        d = str(tmp_path / "data")
        _write_source(d, n_files=6)
        sides = {pkg: _Side(pkg, tmp_path, d, lineage_enabled=True,
                            hybrid_scan_enabled=True) for pkg in PKGS}
        os.remove(os.path.join(d, "p3.parquet"))  # 1/6 of the bytes
        rows = {}
        for pkg, sd in sides.items():
            _bitrot(sd.files()[0])
            sd.hs.verify_index("ix", mode="full")
            ds = sd.ds(lambda c: c("k") < 30)
            plan = ds.optimized_plan()
            assert _bucket_ins(pkg, plan)
            sources = [n.relation.file_paths for n in plan.leaf_relations()
                       if not n.relation.index_scan_of]
            assert sources and all(
                "p3.parquet" not in {os.path.basename(p) for p in paths}
                for paths in sources)
            expected = sd.expected(ds)
            got = ds.collect()
            assert _sorted(got).equals(_sorted(expected))
            rows[pkg] = got.to_pylist()
        assert rows[TORCH] == rows[JAX]


# ---------------------------------------------------------------------------
# Lifecycle
# ---------------------------------------------------------------------------
class TestLifecycle:
    def test_vacuum_clears_quarantine_records(self, side):
        _bitrot(side.files()[0])
        side.hs.verify_index("ix", mode="full")
        assert side.qm().paths()
        side.hs.delete_index("ix")
        side.hs.vacuum_index("ix")
        assert side.qm().paths() == set()

    def test_versions_skips_stray_files(self, side):
        path = side.mgr.index_path("ix") if side.pkg is TORCH \
            else side.mgr.path_resolver.get_index_path("ix")
        with open(os.path.join(path, "v__=7"), "w") as f:
            f.write("not a directory")
        dm = _mod(side.pkg, "index.data_manager").IndexDataManager
        assert dm(path).versions() == [0]

    def test_delete_version_clears_its_records(self, side):
        path = side.mgr.index_path("ix") if side.pkg is TORCH \
            else side.mgr.path_resolver.get_index_path("ix")
        qm = side.qm()
        qm.add(os.path.join(path, "v__=0", "a.parquet"), "x")
        qm.add(os.path.join(path, "v__=1", "b.parquet"), "y")
        side.mgr._data_manager("ix").delete(0)
        assert qm.paths() == {os.path.join(path, "v__=1", "b.parquet")}

    def test_quarantine_store_backends(self, side):
        """The quarantine through both store classes, each package's
        own."""
        victim = side.files()[0]
        pkg = side.pkg.__name__
        for cls in ("PosixLogStore", "EmulatedObjectStore"):
            side.s.conf.log_store_class = f"{pkg}.io.log_store.{cls}"
            qm = side.qm()
            assert type(qm.store).__name__ == cls
            qm.clear()
            assert qm.add(victim, "test")
            assert not qm.add(victim, "test-again")
            assert qm.paths() == {victim}
            assert qm.is_quarantined(victim)
            recs = qm.records()
            assert recs[0]["path"] == victim and recs[0]["reason"] == "test"
            qm.remove(victim)
            assert qm.paths() == set()

    def test_log_store_layout_equals_jax(self, tmp_path):
        """Byte for byte: the data file, the ``.g`` sidecar's generation
        and the listing, written by one store and read by the other."""
        from hyperspace_tpu.io.log_store import PosixLogStore as JaxStore
        from hyperspace_tpu_torch.io.log_store import PosixLogStore

        root = str(tmp_path / "store")
        t, j = PosixLogStore(root), JaxStore(root)
        assert t.put_if_absent("a%2Fb", b"one")
        assert not j.put_if_absent("a%2Fb", b"two")
        assert j.put_if_generation_match("a%2Fb", b"two", 1)
        assert (t.read("a%2Fb"), t.generation("a%2Fb")) == (b"two", 2)
        assert not t.put_if_generation_match("a%2Fb", b"x", 1)
        assert j.put_if_absent("c", b"3")
        assert t.list_keys() == j.list_keys() == ["a%2Fb", "c"]
        with open(os.path.join(root, "d"), "wb") as f:
            f.write(b"legacy")  # no sidecar: generation 1
        assert t.generation("d") == j.generation("d") == 1
        t.delete("a%2Fb")
        assert not j.exists("a%2Fb") and j.read_with_generation("a%2Fb") \
            == (None, 0)
        t.delete("missing")
        with pytest.raises(FileNotFoundError):
            t.read("missing")
