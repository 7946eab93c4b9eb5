"""The mesh routes of hyperspace_tpu_torch end to end, on the CPU: the
sharded spill build, the string-key build, the distributed monolithic
build and the Z-order build under the mesh, each held to the JAX
package's 8-device build by per-bucket sha256; and each executor route's
strategy and rows against the JAX package's, with the mesh off equal to
the single-device path.

The port gets 8 logical shards by replacing ``parallel/mesh.local_devices``
with 8 copies of the CPU session's device (the seam); the JAX package
has the conftest's 8 CPU devices.  The mirror of the end-to-end half of
tests/test_parallel_mesh.py and of tests/test_parallel.py's create and
executor cases.
"""

import hashlib
import json
from collections import defaultdict

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import hyperspace_tpu
import hyperspace_tpu_torch
from hyperspace_tpu_torch.io.parquet import bucket_id_of_file
from hyperspace_tpu_torch.parallel import mesh as tmesh

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
CPU = torch.device("cpu")
RTOL = 1e-9
_KINDS = ("filter", "join", "agg", "build", "resident")


@pytest.fixture()
def eight_shards(monkeypatch):
    monkeypatch.setattr(tmesh, "local_devices", lambda device=None: [CPU] * 8)


def _write_source(root, n=6_000, files=4, string_keys=False):
    rng = np.random.default_rng(42)
    root.mkdir(exist_ok=True)
    if string_keys:
        k = pa.array([f"k-{v:05d}" for v in rng.integers(0, n // 4, size=n)])
    else:
        k = pa.array(rng.integers(0, n // 4, size=n), type=pa.int64())
    table = pa.table({
        "k": k,
        "g": pa.array(rng.integers(0, 9, size=n), type=pa.int64()),
        "v": pa.array(rng.integers(0, 1000, size=n), type=pa.int64()),
        "f": pa.array(rng.random(n) * 100.0),
    })
    step = -(-n // files)
    for f in range(files):
        pq.write_table(table.slice(f * step, step),
                       str(root / f"part-{f:05d}.parquet"))
    return str(root)


def _session(pkg, path, mesh_enabled="auto", batch_rows=None, **conf):
    kw = {"device": "cpu"} if pkg is TORCH else {}
    s = pkg.HyperspaceSession(system_path=str(path), **kw)
    s.conf.num_buckets = 16
    if batch_rows is not None:
        s.conf.device_batch_rows = batch_rows
    for kind in _KINDS:
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    s.conf.mesh_enabled = mesh_enabled
    for k, v in conf.items():
        setattr(s.conf, k, v)
    return s


def _digests(session, name):
    entry = session.index_collection_manager.get_index(name)
    out = defaultdict(list)
    for f in entry.content.file_infos():
        with open(f.name, "rb") as fh:
            out[bucket_id_of_file(f.name)].append(
                hashlib.sha256(fh.read()).hexdigest())
    return {b: sorted(d) for b, d in out.items()}


def _build(pkg, path, src, config, **conf):
    s = _session(pkg, path, **conf)
    hs = pkg.Hyperspace(s)
    hs.create_index(s.read.parquet(src), pkg.IndexConfig(*config))
    return s, hs


# ---------------------------------------------------------------------------
# The builds
# ---------------------------------------------------------------------------
class TestMeshBuilds:
    @pytest.mark.parametrize("string_keys", [False, True],
                             ids=["int_keys", "string_keys"])
    def test_sharded_spill_build_bit_equal_per_bucket_sha256(
            self, tmp_path, eight_shards, string_keys):
        """THE acceptance loop: the sharded spill build's files equal the
        single device's and the JAX package's 8-device build's."""
        src = _write_source(tmp_path / "src", string_keys=string_keys)
        config = ("mx", ["k"], ["g", "v"])
        digests = {}
        for mode in ("off", "auto"):
            s, hs = _build(TORCH, tmp_path / f"t_{mode}", src, config,
                           mesh_enabled=mode, batch_rows=1024)
            report = hs.last_build_report()
            assert report.spill_bytes > 0, "the build did not spill"
            if mode == "auto":
                assert report.mesh_devices == 8
                assert sorted(report.to_dict()["device_kernel_ms"]) \
                    == [str(d) for d in range(8)]
            else:
                assert report.mesh_devices == 0
                assert "device_kernel_ms" not in report.to_dict()
            digests[mode] = _digests(s, "mx")
        js, jhs = _build(JAX, tmp_path / "jax", src, config,
                         batch_rows=1024, parallel_build="off")
        assert jhs.last_build_report().mesh_devices == 8
        assert digests["off"] == digests["auto"] == _digests(js, "mx")

    def test_serial_pipeline_and_mesh_agree(self, tmp_path, eight_shards):
        src = _write_source(tmp_path / "src", n=4_000)
        digests = {}
        for tag, mode, pipelined in (("serial", "off", False),
                                     ("piped", "off", True),
                                     ("mesh", "auto", True),
                                     ("mesh_serial", "auto", False)):
            s, _ = _build(TORCH, tmp_path / tag, src, ("tx", ["k"], ["v"]),
                          mesh_enabled=mode, batch_rows=1024,
                          build_pipeline_enabled=pipelined)
            digests[tag] = _digests(s, "tx")
        assert len({json.dumps(d, sort_keys=True)
                    for d in digests.values()}) == 1

    def test_build_report_reaches_the_perf_ledger(self, tmp_path,
                                                  eight_shards):
        src = _write_source(tmp_path / "src", n=3_000)
        _, hs = _build(TORCH, tmp_path / "ix", src, ("lx", ["k"], ["v"]),
                       batch_rows=1024)
        rows = [r for r in hs.perf_history().to_pylist()
                if "lx" in (r.get("name") or "")]
        assert rows, "no ledger record of the build"
        rec = json.loads(rows[-1]["recordJson"])
        assert len(rec.get("device_kernel_ms", {})) == 8
        assert rec.get("properties", {}).get("mesh_devices") == 8

    @pytest.mark.parametrize("batch_rows", [None, 1024],
                             ids=["one_batch", "beyond_one_batch"])
    def test_distributed_monolithic_build(self, tmp_path, eight_shards,
                                          monkeypatch, batch_rows):
        """parallel_build="on": the bucket shuffle over the 8 shards, one
        monolithic build even beyond one batch, the JAX package's bytes."""
        import hyperspace_tpu_torch.parallel.build as tbuild

        src = _write_source(tmp_path / "src")
        config = ("dx", ["k"], ["g", "f"])
        calls = []
        real = tbuild.bucket_shuffle

        def spy(*args, **kw):
            calls.append(args[3].size)
            return real(*args, **kw)

        monkeypatch.setattr(tbuild, "bucket_shuffle", spy)
        s, hs = _build(TORCH, tmp_path / "on", src, config,
                       parallel_build="on", batch_rows=batch_rows)
        assert calls == [8]
        assert hs.last_build_report().spill_bytes == 0
        one, _ = _build(TORCH, tmp_path / "off", src, config,
                        parallel_build="off", mesh_enabled="off")
        js, _ = _build(JAX, tmp_path / "jax", src, config,
                       parallel_build="on", batch_rows=batch_rows)
        assert _digests(s, "dx") == _digests(one, "dx") == _digests(js, "dx")

    def test_auto_with_one_device_takes_the_single_device_build(
            self, tmp_path, monkeypatch):
        """Without the seam a CPU session sees one device: under "auto"
        neither the spill route nor the monolithic build takes the mesh."""
        import hyperspace_tpu_torch.parallel.build as tbuild

        src = _write_source(tmp_path / "src", n=2_000)
        calls = []
        monkeypatch.setattr(tbuild, "bucket_shuffle",
                            lambda *a, **k: calls.append(1))
        for batch_rows in (512, None):  # spilled, then monolithic
            _, hs = _build(TORCH, tmp_path / f"ix{batch_rows}", src,
                           ("ax", ["k"], ["v"]), batch_rows=batch_rows)
            assert hs.last_build_report().mesh_devices == 0
        assert not calls

    def test_zorder_build_under_mesh_keeps_global_layout(self, tmp_path,
                                                         eight_shards):
        """A Z-order build never takes the hash shuffle: one bucket in
        global Morton order, the JAX package's files, and the second
        dimension still prunes files."""
        rng = np.random.default_rng(8)
        src = tmp_path / "src"
        src.mkdir()
        n = 8_000
        pq.write_table(pa.table({
            "x": pa.array(rng.integers(0, 1 << 16, n), type=pa.int64()),
            "y": pa.array(rng.random(n) * 1000),
        }), str(src / "part-0.parquet"))
        out = {}
        for pkg in (TORCH, JAX):
            s = _session(pkg, tmp_path / pkg.__name__, parallel_build="on",
                         index_max_rows_per_file=n // 64)
            hs = pkg.Hyperspace(s)
            df = s.read.parquet(str(src))
            hs.create_index(df, pkg.IndexConfig("zd", ["x", "y"],
                                                layout="zorder"))
            digests = _digests(s, "zd")
            assert list(digests) == [0]
            s.enable_hyperspace()
            q = df.filter((pkg.col("y") >= 100.0) & (pkg.col("y") < 150.0)) \
                .select("x", "y")
            scans = [sc for sc in q.optimized_plan().leaf_relations()
                     if sc.relation.index_scan_of]
            kept, total = scans[0].relation.data_skipping_stats
            assert kept < total
            keys = [("x", "ascending"), ("y", "ascending")]
            got = q.collect().sort_by(keys)
            s.disable_hyperspace()
            assert got.equals(q.collect().sort_by(keys))
            out[pkg] = (digests, got.to_pydict())
        assert out[TORCH] == out[JAX]


# ---------------------------------------------------------------------------
# The executor's routes
# ---------------------------------------------------------------------------
def _queries(pkg, s, src, rsrc):
    col = pkg.col
    df, rf = s.read.parquet(src), s.read.parquet(rsrc)
    return {
        "filter": df.filter(col("v") < 500).select("k", "v", "f"),
        "join": df.join(rf, col("k") == col("rk")).select("k", "v", "w"),
        "aggregate": df.group_by("g").agg(
            sv=("v", "sum"), c=("", "count_all"), m=("f", "mean"),
            lo=("f", "min")),
        "join_aggregate": df.join(rf, col("k") == col("rk"))
        .group_by("g").agg(r=(col("f") * col("w"), "sum"),
                           c=("", "count_all")),
    }


_STRATEGIES = {
    # route -> (JAX/port strategies with the mesh, without it)
    "filter": ({"filters": ["device-mesh"]}, {"filters": ["device"]}),
    "flat_join": ({"join_kernels": ["mesh"]}, {"join_kernels": ["device"]}),
    "bucketed_join": ({"joins": ["bucketed-mesh"]}, {"joins": ["bucketed"]}),
    "aggregate": ({"aggregates": ["mesh-segment"]},
                  {"aggregates": ["device-segment"]}),
    "join_aggregate": ({"joins": ["mesh-fused-agg"],
                        "aggregates": ["mesh-join-agg"]},
                       {"joins": ["device-fused-agg"],
                        "aggregates": ["device-join-agg"]}),
}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_routes")
    src = _write_source(root / "src", n=5_000)
    rsrc = root / "r"
    rsrc.mkdir()
    rng = np.random.default_rng(3)
    pq.write_table(pa.table({
        "rk": pa.array(np.arange(1_250), type=pa.int64()),
        "w": pa.array(rng.random(1_250))}), str(rsrc / "p.parquet"))
    return root, src, str(rsrc)


def _indexed(pkg, root, src, rsrc):
    s = _session(pkg, root / f"ix_{pkg.__name__}")
    hs = pkg.Hyperspace(s)
    if not hs.indexes().num_rows:
        hs.create_index(s.read.parquet(src),
                        pkg.IndexConfig("qx", ["k"], ["g", "v", "f"]))
        hs.create_index(s.read.parquet(rsrc),
                        pkg.IndexConfig("rx", ["rk"], ["w"]))
    for k in ("mesh_filter_min_rows", "mesh_join_min_rows",
              "mesh_agg_min_rows"):
        setattr(s.conf, k, 0)
    return s


def _strategies(stats, kinds):
    return {k: sorted({d["strategy"] for d in stats.get(k, [])})
            for k in kinds}


def _same_rows(a, b):
    a, b = a.to_pandas(), b.to_pandas()
    assert list(a.columns) == list(b.columns)
    a = a.sort_values(list(a.columns)).reset_index(drop=True)
    b = b.sort_values(list(b.columns)).reset_index(drop=True)
    for c in a.columns:
        if a[c].dtype.kind == "f":
            np.testing.assert_allclose(a[c], b[c], rtol=RTOL, atol=0)
        else:
            assert a[c].tolist() == b[c].tolist(), c


@pytest.mark.parametrize("route", list(_STRATEGIES))
def test_each_route_against_the_jax_mesh(sources, eight_shards, route):
    """The route's strategy names and rows with the mesh, as the JAX
    package's 8-device mesh gives them, and equal to the port's own
    single-device route with the mesh off."""
    root, src, rsrc = sources
    query = "join" if route.endswith("_join") else route
    hyperspace = route != "flat_join"  # the flat join reads the sources
    want, without = _STRATEGIES[route]
    results = {}
    for pkg in (TORCH, JAX):
        s = _indexed(pkg, root, src, rsrc)
        if hyperspace:
            s.enable_hyperspace()
        out = _queries(pkg, s, src, rsrc)[query].collect()
        assert _strategies(s.last_execution_stats, want) == want, pkg
        if route == "bucketed_join":
            assert s.last_execution_stats["joins"][0]["devices"] == 8
        results[pkg] = out
        if pkg is TORCH:
            s.conf.mesh_enabled = "off"
            single = _queries(pkg, s, src, rsrc)[query].collect()
            assert _strategies(s.last_execution_stats, without) == without
            _same_rows(out, single)
            s.conf.mesh_enabled = "auto"
        s.disable_hyperspace()
    assert results[TORCH].num_rows > 0
    _same_rows(results[TORCH], results[JAX])


def test_mesh_off_answers_are_the_single_device_path(sources, eight_shards):
    """``mesh_enabled="off"`` reproduces the single-device answer byte
    for byte (arrow equality) on a filter query."""
    root, src, rsrc = sources
    s = _indexed(TORCH, root, src, rsrc)
    q = _queries(TORCH, s, src, rsrc)["filter"]
    s.conf.mesh_enabled = "off"
    base = q.collect()
    assert _strategies(s.last_execution_stats, ["filters"]) \
        == {"filters": ["device"]}
    s.conf.mesh_enabled = "auto"
    meshed = q.collect()
    assert _strategies(s.last_execution_stats, ["filters"]) \
        == {"filters": ["device-mesh"]}
    assert meshed.equals(base)


def test_one_device_under_auto_keeps_every_route(sources):
    """Without the seam a CPU session sees one device: under "auto",
    with every mesh threshold at 0, no mesh route is taken."""
    root, src, rsrc = sources
    s = _indexed(TORCH, root, src, rsrc)
    s.enable_hyperspace()
    seen = set()
    for q in _queries(TORCH, s, src, rsrc).values():
        q.collect()
        stats = s.last_execution_stats
        seen |= {d["strategy"] for k in ("filters", "joins", "join_kernels",
                                         "aggregates")
                 for d in stats.get(k, [])}
    s.disable_hyperspace()
    assert not any("mesh" in st for st in seen), seen
    assert {"device", "bucketed", "device-segment",
            "device-fused-agg"} <= seen


def test_below_threshold_probe_reads_each_bucket_once(sources, eight_shards):
    """Under ``mesh_join_min_rows`` (by the footers) the bucketed join
    keeps the thread pool, and each bucket's files are read once."""
    root, src, rsrc = sources
    s = _indexed(TORCH, root, src, rsrc)
    s.conf.mesh_join_min_rows = 1 << 60
    s.enable_hyperspace()
    out = _queries(TORCH, s, src, rsrc)["join"].collect()
    s.disable_hyperspace()
    stats = s.last_execution_stats
    assert [j["strategy"] for j in stats["joins"]] == ["bucketed"]
    assert out.num_rows > 0
    assert len([sc for sc in stats["scans"] if sc["is_index"]]) == 32
