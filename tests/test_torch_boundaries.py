"""The port's boundaries: it imports neither ``jax`` nor anything of
``hyperspace_tpu``, and its entry points run on the card unless asked
for the CPU."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

import hyperspace_tpu_torch
from hyperspace_tpu_torch.session import HyperspaceSession

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "hyperspace_tpu_torch")

# ``hyperspace_tpu.`` (a module of the JAX package) and ``hyperspace_tpu``
# imported whole; ``hyperspace_tpu_torch`` itself never matches.
_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+jax\b", re.M),
    re.compile(r"\bhyperspace_tpu\.\w"),
    re.compile(r"^\s*from\s+hyperspace_tpu\s", re.M),
    re.compile(r"^\s*import\s+hyperspace_tpu\b(?!_)", re.M),
]


# The query-path guards and diagnostics, the object store, the server and
# its wire-fault seams, the fleet plane.
_GUARDS_AND_DIAGNOSTICS = (
    "execution/sync_guard.py", "utils/deadline.py",
    "execution/plan_cache.py", "interop/__init__.py", "interop/query.py",
    "telemetry/flight_recorder.py", "telemetry/slo.py",
    "telemetry/doctor.py", "io/log_store.py",
    "index/object_log_manager.py", "interop/server.py",
    "interop/netfaults.py", "telemetry/fleet.py")

# The source formats, hive partitions and globs.
_FORMATS = ("io/partitions.py", "io/avro.py", "io/files.py",
            "io/parquet.py", "sources/default/provider.py",
            "sources/manager.py")

# The source-provider plug-in, the Delta Lake and the Iceberg sources.
_LAKE = ("io/schemas.py", "sources/interfaces.py",
         "sources/delta/__init__.py", "sources/delta/log.py",
         "sources/delta/writer.py", "sources/delta/provider.py",
         "sources/iceberg/__init__.py", "sources/iceberg/metadata.py",
         "sources/iceberg/writer.py", "sources/iceberg/provider.py")


# The mesh of logical shards and its data plane; the (dcn, ici) mesh and
# the multi-host build (pyarrow inside functions only).
_PARALLEL = ("parallel/__init__.py", "parallel/mesh.py", "parallel/shuffle.py",
             "parallel/sharded_build.py", "parallel/build.py",
             "parallel/join.py", "parallel/filter.py",
             "parallel/aggregate.py", "parallel/multihost.py",
             "parallel/multihost_build.py")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        out.extend(os.path.join(dirpath, n) for n in names
                   if n.endswith((".py", ".cu", ".cpp", ".h", ".cuh")))
    return sorted(out)


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    for module in ("actions/refresh.py", "actions/delete.py",
                   "actions/restore.py", "actions/vacuum.py",
                   "actions/cancel.py", "lifecycle/change_detector.py",
                   "actions/optimize.py", "rules/hybrid.py",
                   "ops/aggregate.py", "ops/join_agg.py",
                   "execution/device_cache.py", "utils/calibrate.py",
                   "telemetry/build_report.py", "actions/data_skipping.py",
                   "rules/data_skipping.py", "ops/zorder.py",
                   "ops/window.py", "plan/temporal.py", "plan/subquery.py",
                   "sql/parser.py", "plananalysis/display.py",
                   "plananalysis/explain.py", "plananalysis/physical.py",
                   "telemetry/report.py", "index/statistics.py",
                   "io/faults.py", "utils/retry.py", "index/cache.py",
                   "advisor/__init__.py", "advisor/hypothetical.py",
                   "advisor/workload.py", "advisor/candidates.py",
                   "advisor/recommend.py", "lifecycle/__init__.py",
                   "lifecycle/policy.py", "lifecycle/cdc.py",
                   "lifecycle/journal.py", "lifecycle/lease.py",
                   "lifecycle/daemon.py", "io/watch.py",
                   "telemetry/trace.py", "telemetry/metrics.py",
                   "telemetry/events.py", "telemetry/timeline.py",
                   "telemetry/perf_ledger.py", "telemetry/bench_compare.py",
                   "telemetry/__init__.py", "utils/reflection.py",
                   "lint/catalog.py", *_GUARDS_AND_DIAGNOSTICS, *_FORMATS,
                   *_LAKE, *_PARALLEL):
        assert os.path.join(PORT, module) in sources
    for path in sources:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for pattern in _FORBIDDEN:
            assert not pattern.search(text), f"{path}: {pattern.pattern}"


def test_no_module_of_the_port_imports_pyarrow_when_loaded():
    """pyarrow is imported inside functions only, so the kernels and the
    data plane load without it."""
    import ast

    sources = [p for p in _port_sources()
               if p.endswith(".py") and p.startswith(PORT)]
    assert len(sources) > 20
    for module in ("actions/optimize.py", "actions/refresh.py",
                   "rules/hybrid.py", "ops/aggregate.py", "ops/join_agg.py",
                   "execution/device_cache.py", "utils/calibrate.py",
                   "telemetry/build_report.py", "actions/data_skipping.py",
                   "rules/data_skipping.py", "actions/verify.py",
                   "actions/repair.py", "execution/containment.py",
                   "ops/zorder.py", "ops/window.py",
                   "execution/executor.py", "plan/pruning.py",
                   "plan/temporal.py", "plan/subquery.py", "plan/expr.py",
                   "sql/__init__.py", "sql/parser.py",
                   "plananalysis/__init__.py", "plananalysis/display.py",
                   "plananalysis/explain.py", "plananalysis/physical.py",
                   "telemetry/report.py", "index/statistics.py",
                   "io/faults.py", "utils/retry.py", "index/cache.py",
                   "advisor/__init__.py", "advisor/hypothetical.py",
                   "advisor/workload.py", "advisor/candidates.py",
                   "advisor/recommend.py", "lifecycle/__init__.py",
                   "lifecycle/change_detector.py", "lifecycle/policy.py",
                   "lifecycle/cdc.py", "lifecycle/journal.py",
                   "lifecycle/lease.py", "lifecycle/daemon.py",
                   "io/watch.py", "telemetry/trace.py",
                   "telemetry/metrics.py", "telemetry/events.py",
                   "telemetry/timeline.py", "telemetry/perf_ledger.py",
                   "telemetry/bench_compare.py", "utils/reflection.py",
                   "lint/catalog.py", *_GUARDS_AND_DIAGNOSTICS, *_FORMATS,
                   *_LAKE, *_PARALLEL):
        assert os.path.join(PORT, module) in sources
    for path in sources:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "pyarrow" for n in names), path


def test_the_plan_never_imports_pyarrow():
    """No module under ``plan/`` imports pyarrow, not even inside a
    function: ``Cast`` checks its type name through ``io.parquet``."""
    import ast

    from hyperspace_tpu_torch.plan.expr import Cast, col

    plan_dir = os.path.join(PORT, "plan")
    modules = sorted(n for n in os.listdir(plan_dir) if n.endswith(".py"))
    assert {"expr.py", "temporal.py", "subquery.py"} <= set(modules)
    for name in modules:
        with open(os.path.join(plan_dir, name), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "pyarrow" for n in names), name
    assert Cast(col("k"), "Long").type_name == "int64"
    with pytest.raises(ValueError, match="Unknown cast type"):
        Cast(col("k"), "varchar(10)")


def test_the_sql_front_end_and_the_display_never_import_pyarrow():
    """``sql/`` and ``plananalysis/display.py`` import no pyarrow, not
    even inside a function: parsing and rendering need no arrow."""
    import ast

    sql_dir = os.path.join(PORT, "sql")
    paths = [os.path.join(sql_dir, n) for n in sorted(os.listdir(sql_dir))
             if n.endswith(".py")]
    paths.append(os.path.join(PORT, "plananalysis", "display.py"))
    assert {os.path.basename(p) for p in paths} >= {
        "__init__.py", "parser.py", "display.py"}
    for path in paths:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(n.split(".")[0] == "pyarrow" for n in names), path


def test_the_format_readers_are_imported_inside_io_functions_only():
    """``pyarrow.csv``, ``pyarrow.json`` and ``pyarrow.orc`` are imported
    only under ``io/``, and there only inside a function."""
    import ast

    readers = {"pyarrow.csv", "pyarrow.json", "pyarrow.orc"}
    found = []
    for path in _port_sources():
        if not path.endswith(".py") or not path.startswith(PORT):
            continue
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        top = set(map(id, tree.body))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names = {node.module or ""} | {
                    f"{node.module}.{a.name}" for a in node.names}
            else:
                continue
            if names & readers:
                rel = os.path.relpath(path, PORT)
                assert rel.startswith("io" + os.sep), rel
                assert id(node) not in top, rel
                found.append(rel)
    assert set(found) == {os.path.join("io", "parquet.py")}
    assert len(found) == 4  # csv, json, orc read; orc schema


def test_the_formats_and_partitions_import_no_jax(tmp_path):
    """A CSV build and query, a hive-partitioned Parquet read, an Avro
    read and a glob through the port, with the new modules loaded
    without pyarrow first."""
    script = textwrap.dedent(f"""
        import os, sys
        from hyperspace_tpu_torch.io import avro, files, partitions
        from hyperspace_tpu_torch.sources import manager
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.csv as pacsv
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        root = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        t = pa.table({{"k": rng.integers(0, 50, 300), "v": rng.random(300)}})
        os.makedirs(os.path.join(root, "csv"))
        pacsv.write_csv(t, os.path.join(root, "csv", "part-0.csv"))
        for d in (1, 2):
            part = os.path.join(root, "hive", f"day={{d}}")
            os.makedirs(part)
            pq.write_table(t, os.path.join(part, "part-0.parquet"))
        os.makedirs(os.path.join(root, "avro"))
        avro.write_container(
            os.path.join(root, "avro", "a.avro"),
            {{"type": "record", "name": "r",
              "fields": [{{"name": "k", "type": "long"}}]}},
            [{{"k": 1}}, {{"k": 2}}])
        s = HyperspaceSession(os.path.join(root, "ix"), device="cpu")
        s.conf.num_buckets = 4
        hs = Hyperspace(s)
        hs.create_index(s.read.csv(os.path.join(root, "csv")),
                        IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()
        got = s.read.csv(os.path.join(root, "csv")).filter(col("k") == 7) \
            .select("k", "v").collect()
        assert got.num_rows == int((t.column("k").to_numpy() == 7).sum())
        hive = s.read.parquet(os.path.join(root, "hive")).collect()
        assert sorted(set(hive.column("day").to_pylist())) == [1, 2]
        assert s.read.parquet(os.path.join(root, "hive", "day=*")) \
            .collect().num_rows == 600
        assert s.read.avro(os.path.join(root, "avro")).collect() \
            .column("k").to_pylist() == [1, 2]
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_delta_source_imports_no_jax(tmp_path):
    """Every module under ``sources/`` and ``io/schemas.py`` load without
    pyarrow; then a Delta table and an Iceberg table, each written,
    indexed, queried at its latest and an older version, appended to and
    refreshed through the port."""
    script = textwrap.dedent(f"""
        import os, sys
        from hyperspace_tpu_torch.io import schemas
        from hyperspace_tpu_torch.sources import interfaces, manager
        from hyperspace_tpu_torch.sources.default import provider
        from hyperspace_tpu_torch.sources.delta import (log, provider as dp,
                                                        writer)
        from hyperspace_tpu_torch.sources.iceberg import (
            metadata, provider as ip, writer as iw)
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        root = {str(tmp_path)!r}
        t = os.path.join(root, "t")
        rng = np.random.default_rng(0)
        for i in range(2):
            writer.write_delta(pa.table({{"k": rng.integers(0, 50, 300),
                                          "v": rng.random(300)}}), t)
        s = HyperspaceSession(os.path.join(root, "ix"), device="cpu")
        s.conf.num_buckets = 4
        hs = Hyperspace(s)
        hs.create_index(s.read.delta(t), IndexConfig("ix", ["k"], ["v"]))
        writer.write_delta(pa.table({{"k": [7], "v": [0.5]}}), t)
        hs.refresh_index("ix", "incremental")
        entry = s.index_collection_manager.get_index("ix")
        assert entry.properties["deltaVersions"] == "2:1,4:2"
        s.enable_hyperspace()
        s.conf.hybrid_scan_enabled = True
        now = s.read.delta(t).filter(col("k") == 7).select("k").count()
        then = s.read.delta(t, versionAsOf="1").filter(col("k") == 7) \
            .select("k").count()
        assert now == then + 1
        it = os.path.join(root, "it")
        first = iw.write_iceberg(pa.table({{"k": rng.integers(0, 50, 300),
                                            "v": rng.random(300)}}), it)
        hs.create_index(s.read.iceberg(it), IndexConfig("ii", ["k"], ["v"]))
        iw.write_iceberg(pa.table({{"k": [7], "v": [0.5]}}), it)
        hs.refresh_index("ii", "incremental")
        entry = s.index_collection_manager.get_index("ii")
        assert entry.properties["icebergSnapshots"].startswith(
            f"2:{{first}},4:")
        now = s.read.iceberg(it).filter(col("k") == 7).select("k").count()
        then = s.read.iceberg(it, snapshot_id=str(first)) \
            .filter(col("k") == 7).select("k").count()
        assert now == then + 1
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_mesh_imports_no_jax(tmp_path):
    """``parallel/`` loads without pyarrow; then, on 8 logical CPU shards
    (the ``local_devices`` seam), a sharded spill build, a distributed
    build and the mesh filter, join and aggregate run through the port
    without loading jax or the JAX package."""
    script = textwrap.dedent(f"""
        import os, sys
        import torch
        from hyperspace_tpu_torch import parallel
        from hyperspace_tpu_torch.parallel import (aggregate, build, filter,
                                                   join, mesh, sharded_build,
                                                   shuffle)
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        mesh.local_devices = lambda device=None: [torch.device("cpu")] * 8
        root = {str(tmp_path)!r}
        src = os.path.join(root, "src")
        os.makedirs(src)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{"k": rng.integers(0, 500, 3000),
                                  "v": rng.random(3000)}}),
                       os.path.join(src, "p.parquet"))
        s = HyperspaceSession(os.path.join(root, "ix"), device="cpu")
        s.conf.num_buckets = 4
        s.conf.device_batch_rows = 1000
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
            if kind in ("filter", "join", "agg"):
                setattr(s.conf, f"mesh_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(src), IndexConfig("a", ["k"], ["v"]))
        assert hs.last_build_report().mesh_devices == 8
        s.conf.parallel_build = "on"
        hs.create_index(s.read.parquet(src), IndexConfig("b", ["k"], ["v"]))
        s.enable_hyperspace()
        df = s.read.parquet(src)
        assert df.filter(col("k") < 10).select("k").count() \
            == int((pq.read_table(src).column("k").to_numpy() < 10).sum())
        df.group_by("k").agg(n=("", "count_all")).collect()
        strategies = {{d["strategy"] for d in
                       s.last_execution_stats["aggregates"]}}
        assert strategies == {{"mesh-segment"}}, strategies
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_multihost_build_hosts_import_no_jax(tmp_path):
    """``multihost`` and ``multihost_build`` load without pyarrow; then a
    2-host build on the CPU, whose host subprocesses each record, after
    ``host_main`` returns, the jax and JAX-package modules they loaded:
    none, as in the coordinator."""
    script = textwrap.dedent(f"""
        import os, sys
        from hyperspace_tpu_torch.parallel import multihost, multihost_build
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig)

        root = {str(tmp_path)!r}
        probe = (
            "; import os, sys; bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.') or m == 'hyperspace_tpu' "
            "or m.startswith('hyperspace_tpu.')); "
            "open(os.path.join(" + repr(root) + ", 'host-%d.txt' "
            "% os.getpid()), 'w').write(repr(bad))")
        multihost_build.HOST_CODE += probe
        src = os.path.join(root, "src")
        os.makedirs(src)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{"k": rng.integers(0, 500, 3000),
                                  "v": rng.random(3000)}}),
                       os.path.join(src, "p.parquet"))
        s = HyperspaceSession(os.path.join(root, "ix"), device="cpu")
        s.conf.num_buckets = 4
        s.conf.device_batch_rows = 1000
        s.conf.device_build_min_rows = 0
        s.conf.multihost_build_hosts = 2
        s.conf.multihost_build_poll_s = 0.02
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(src), IndexConfig("m", ["k"], ["v"]))
        assert hs.last_build_report().properties["multihost_hosts"] == 2
        hosts = sorted(f for f in os.listdir(root) if f.startswith("host-"))
        assert len(hosts) == 2, hosts
        for f in hosts:
            with open(os.path.join(root, f)) as fh:
                print("HOST", f, fh.read())
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout
    hosts = [line for line in proc.stdout.splitlines()
             if line.startswith("HOST ")]
    assert len(hosts) == 2 and all(h.endswith(" []") for h in hosts), \
        proc.stdout


def test_the_fleet_plane_imports_no_jax(tmp_path):
    """``telemetry/fleet.py`` loads without jax and pyarrow; then a
    heartbeat published, read back, merged, rendered and graded by the
    fleet doctor, with its status table: nothing of jax or the JAX
    package loaded."""
    script = textwrap.dedent(f"""
        import os, sys
        from hyperspace_tpu_torch.telemetry import fleet
        loaded = [m for m in sys.modules if m == "pyarrow"
                  or m.startswith("pyarrow.") or m == "jax"
                  or m.startswith("jax.")]
        assert not loaded, loaded
        from hyperspace_tpu_torch import Hyperspace, HyperspaceSession

        s = HyperspaceSession(os.path.join({str(tmp_path)!r}, "ix"),
                              device="cpu")
        s.conf.fleet_telemetry_enabled = True
        assert fleet.publish_once(s.conf)
        hs = Hyperspace(s)
        assert hs.fleet_status().num_rows == 1
        assert fleet.process_identity() in hs.fleet_metrics()["processes"]
        assert "process=" in fleet.render_fleet_prometheus(s.conf)
        report = hs.doctor(fleet=True)
        assert report.check("fleet.heartbeats").status == "ok"
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_a_build_through_the_port_imports_no_jax(tmp_path):
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{"k": rng.integers(0, 50, 300),
                                  "v": rng.random(300)}}),
                       os.path.join(data, "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        # The device routes (the CPU defaults send work to the host).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        assert hs.indexes().to_pylist()[0]["state"] == "ACTIVE"
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_spill_build_and_the_lifecycle_verbs_import_no_jax(tmp_path):
    """A build over more rows than one device batch (the spill build), a
    full refresh after an append, and delete / restore / delete / vacuum,
    each through the port's entry points."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        for i in range(3):
            pq.write_table(pa.table({{"k": rng.integers(0, 50, 300),
                                      "v": rng.random(300)}}),
                           os.path.join(data, f"part-{{i}}.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        # The device routes (the CPU defaults send work to the host).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        s.conf.device_batch_rows = 256
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        assert "spill_route_s" in s.build_stats_log[-1]
        pq.write_table(pa.table({{"k": [7], "v": [0.5]}}),
                       os.path.join(data, "part-9.parquet"))
        assert hs.refresh_index("ix").outcome == "ok"
        for verb in ("delete_index", "restore_index", "delete_index",
                     "vacuum_index"):
            getattr(hs, verb)("ix")
        assert hs.indexes().to_pylist()[0]["state"] == "DOESNOTEXIST"
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_failure_envelope_and_the_advisor_import_no_jax(tmp_path):
    """The fault injector, the retry and the listing cache load without
    pyarrow; then a build that crashes at commit and recovers, a degraded
    query over a torn log, and the advisor's capture, what-if, recommend
    and apply, each through the port's entry points."""
    script = textwrap.dedent(f"""
        import glob, os, sys
        import hyperspace_tpu_torch.io.faults as faults
        import hyperspace_tpu_torch.utils.retry
        import hyperspace_tpu_torch.index.cache
        import hyperspace_tpu_torch.advisor
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{"k": np.arange(300), "v": rng.random(300)}}),
                       os.path.join(data, "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        faults.install(faults.FaultPlan(site="action.commit", kind="crash"))
        try:
            hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        except faults.InjectedCrash:
            pass
        finally:
            faults.clear()
        s.conf.auto_recovery_enabled = True
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        s.conf.advisor_capture_enabled = True
        s.enable_hyperspace()
        for _ in range(2):
            s.read.parquet(data).filter(col("v") < 0.5).select("k").collect()
        assert "What-if" in (s.read.parquet(data).filter(col("v") < 0.5)
                             .select("k").explain(
                                 whatif=[IndexConfig("h", ["v"], ["k"])]))
        assert hs.recommend_indexes().num_rows == 1
        assert hs.apply_recommendations() == ["adv_data_v"]
        for f in glob.glob({str(tmp_path / "ix")!r} + "/ix/_hyperspace_log/*"):
            open(f, "w").write('{{"torn')
        s.index_collection_manager.clear_cache()
        ds = s.read.parquet(data).filter(col("k") == 7).select("k", "v")
        assert ds.collect().num_rows == 1
        assert ds.last_run_report().outcome == "degraded"
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_lifecycle_imports_no_jax(tmp_path):
    """The lifecycle and the source watch load without pyarrow (the
    journal's history table imports it when called); then a maintenance
    cycle that refreshes, the history table, the lease and a watcher,
    each through the port's entry points."""
    script = textwrap.dedent(f"""
        import os, sys
        import hyperspace_tpu_torch.lifecycle
        import hyperspace_tpu_torch.lifecycle.journal as journal
        import hyperspace_tpu_torch.lifecycle.lease as lease
        import hyperspace_tpu_torch.lifecycle.daemon
        import hyperspace_tpu_torch.io.watch as watch
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{"k": np.arange(300), "v": rng.random(300)}}),
                       os.path.join(data, "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        s.conf.lifecycle_lease_enabled = True
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        pq.write_table(pa.table({{"k": np.arange(300, 310),
                                 "v": rng.random(10)}}),
                       os.path.join(data, "part-1.parquet"))
        recs = hs.maintenance_cycle()
        assert [(r["decision"], r["mode"], r["outcome"]) for r in recs] == [
            ("refresh", "full", "done")], recs
        assert hs.lifecycle_history().num_rows == 2  # acquire, refresh
        assert lease.status(s.conf)["fresh"]
        w = watch.SourceWatcher(s.conf, [data], mode="poll").start()
        w.stop()
        hs.stop_maintenance()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_telemetry_core_imports_no_jax(tmp_path):
    """The telemetry modules load without pyarrow; then a traced build
    and query with the timeline on, the metrics text (its HELP lines
    parsed from docs/16 by the port's own ``lint/catalog.py``), the perf
    ledger and a Perfetto export, each through the port's entry points,
    load neither jax nor the JAX package."""
    script = textwrap.dedent(f"""
        import os, sys
        import hyperspace_tpu_torch.telemetry
        from hyperspace_tpu_torch.telemetry import (bench_compare, events,
            metrics, perf_ledger, timeline, trace)
        import hyperspace_tpu_torch.lint.catalog
        import hyperspace_tpu_torch.utils.reflection
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        pq.write_table(pa.table({{"k": np.arange(300), "v": np.ones(300)}}),
                       os.path.join(data, "part-0.parquet"))
        from hyperspace_tpu_torch import HyperspaceConf
        conf = HyperspaceConf(event_logger="CollectingEventLogger")
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu",
                              conf=conf)
        s.conf.num_buckets = 4
        s.conf.telemetry_tracing_enabled = True
        s.conf.timeline_enabled = True
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()
        assert s.read.parquet(data).filter(col("k") == 3).collect().num_rows == 1
        assert "# HELP hyperspace_build_actions" in hs.metrics_text()
        assert hs.perf_history().num_rows == 1
        hs.export_timeline({str(tmp_path / "t.json")!r})
        assert hs.metrics()["exec.kernel.filter.device_ms"]["count"] == 1
        assert events.get_event_logger().events
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_queries_through_the_port_import_no_jax(tmp_path):
    """A filter query and a join query, each rewritten to the indexes,
    through ``collect()``, and the join again from the device column
    cache."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        rng = np.random.default_rng(0)
        paths = {{}}
        for name, key in (("a", "k"), ("b", "j")):
            paths[name] = os.path.join({str(tmp_path)!r}, name)
            os.makedirs(paths[name])
            pq.write_table(pa.table({{key: rng.integers(0, 50, 300),
                                      name + "v": rng.random(300)}}),
                           os.path.join(paths[name], "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        # The device routes (the CPU defaults send work to the host).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(paths["a"]), IndexConfig("ia", ["k"], ["av"]))
        hs.create_index(s.read.parquet(paths["b"]), IndexConfig("ib", ["j"], ["bv"]))
        s.enable_hyperspace()
        a, b = s.read.parquet(paths["a"]), s.read.parquet(paths["b"])
        assert a.filter(col("k") == 7).select("k", "av").collect().num_rows > 0
        assert s.last_execution_stats["scans"][0]["is_index"]
        assert a.join(b, col("k") == col("j")).collect().num_rows > 0
        assert s.last_execution_stats["joins"][0]["strategy"] == "bucketed"
        assert a.join(b, col("k") == col("j")).collect().num_rows > 0
        assert s.last_execution_stats["device_cache"]["misses"] == 0
        assert all(d["resident"]
                   for d in s.last_execution_stats["join_kernels"])
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_sql_explain_and_statistics_import_no_jax(tmp_path):
    """A join query as SQL text through ``collect()``, its verbose explain
    with the run report, and the index statistics, each through the
    port's entry points."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig
        from hyperspace_tpu_torch.sql import sql

        rng = np.random.default_rng(0)
        paths = {{}}
        for name, key in (("a", "k"), ("b", "j")):
            paths[name] = os.path.join({str(tmp_path)!r}, name)
            os.makedirs(paths[name])
            pq.write_table(pa.table({{key: rng.integers(0, 50, 300),
                                      name + "v": rng.random(300)}}),
                           os.path.join(paths[name], "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(paths["a"]), IndexConfig("ia", ["k"], ["av"]))
        hs.create_index(s.read.parquet(paths["b"]), IndexConfig("ib", ["j"], ["bv"]))
        s.enable_hyperspace()
        ds = sql(s, "SELECT k, sum(bv) AS t FROM a JOIN b ON k = j "
                    "WHERE av < 0.5 GROUP BY k ORDER BY k", paths)
        assert ds.collect().num_rows > 0
        assert ds.last_run_report().indexes_used == ["ia", "ib"]
        text = hs.explain(ds, verbose=True)
        assert "PerBucketMergeJoinExec" in text and "Last run report:" in text
        assert hs.index("ia").column("numBuckets").to_pylist() == [4]
        assert hs.indexes().column("name").to_pylist() == ["ia", "ib"]
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_refresh_modes_hybrid_scan_and_optimize_import_no_jax(tmp_path):
    """A lineage index through quick refresh, a hybrid-scan filter and
    join, incremental refresh and optimize, each through the port's entry
    points."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        rng = np.random.default_rng(0)
        paths = {{}}
        for name, key, n_files in (("a", "k", 6), ("b", "j", 1)):
            paths[name] = os.path.join({str(tmp_path)!r}, name)
            os.makedirs(paths[name])
            for i in range(n_files):
                pq.write_table(pa.table({{key: rng.integers(0, 50, 300),
                                          name + "v": rng.random(300)}}),
                               os.path.join(paths[name], f"part-{{i}}.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        # The device routes (the CPU defaults send work to the host).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        s.conf.lineage_enabled = True
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(paths["a"]), IndexConfig("ia", ["k"], ["av"]))
        hs.create_index(s.read.parquet(paths["b"]), IndexConfig("ib", ["j"], ["bv"]))
        pq.write_table(pa.table({{"k": [7], "av": [0.5]}}),
                       os.path.join(paths["a"], "part-9.parquet"))
        os.remove(os.path.join(paths["a"], "part-0.parquet"))
        assert hs.refresh_index("ia", "quick").outcome == "ok"
        s.conf.hybrid_scan_enabled = True
        s.enable_hyperspace()
        a, b = s.read.parquet(paths["a"]), s.read.parquet(paths["b"])
        assert a.filter(col("k") == 7).select("k", "av").collect().num_rows > 0
        assert a.join(b, col("k") == col("j")).collect().num_rows > 0
        assert s.last_execution_stats["joins"][0]["hybrid"]
        assert hs.refresh_index("ia", "incremental").outcome == "ok"
        pq.write_table(pa.table({{"k": [8], "av": [0.25]}}),
                       os.path.join(paths["a"], "part-10.parquet"))
        assert hs.refresh_index("ia", "incremental").outcome == "ok"
        assert hs.optimize_index("ia", "full").outcome == "ok"
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_aggregate_queries_through_the_port_import_no_jax(tmp_path):
    """The TPC-H Q3 shape through both indexes (the fused join→aggregate
    with its top-N), a grouped aggregate through the filter rule, and a
    global one, each through ``collect()``; the new ops modules load
    without pyarrow."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        from hyperspace_tpu_torch.ops import aggregate, join_agg
        assert "pyarrow" not in sys.modules
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        rng = np.random.default_rng(0)
        paths = {{}}
        for name, cols in (("o", {{"ok": rng.permutation(100),
                                   "cust": rng.integers(0, 9, 100)}}),
                           ("l", {{"lk": rng.integers(0, 100, 400),
                                   "p": rng.random(400),
                                   "d": rng.random(400) * 0.1}})):
            paths[name] = os.path.join({str(tmp_path)!r}, name)
            os.makedirs(paths[name])
            pq.write_table(pa.table(cols),
                           os.path.join(paths[name], "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        # The device routes (the CPU defaults send work to the host).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(paths["o"]), IndexConfig("io", ["ok"], ["cust"]))
        hs.create_index(s.read.parquet(paths["l"]), IndexConfig("il", ["lk"], ["p", "d"]))
        s.enable_hyperspace()
        o, l = s.read.parquet(paths["o"]), s.read.parquet(paths["l"])
        q3 = (o.filter(col("ok") < 60).join(l, col("ok") == col("lk"))
              .group_by("cust").agg(rev=(col("p") * (1 - col("d")), "sum"))
              .sort(("rev", False)).limit(3))
        assert q3.collect().num_rows == 3
        st = s.last_execution_stats
        assert st["joins"][-1]["strategy"] == "device-fused-agg"
        assert st["aggregates"][-1]["topn"] == 3
        assert sorted(x["relation"] for x in st["scans"]) == ["il", "io"]
        g = o.filter(col("ok") < 50).group_by("cust").count().collect()
        assert g.column("count").to_pylist() and \
            s.last_execution_stats["aggregates"][-1]["strategy"] == "device-segment"
        assert l.agg(n=("p", "count")).collect().to_pylist() == [{{"n": 400}}]
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_calibration_reports_and_data_skipping_import_no_jax(tmp_path):
    """The calibration probe, a build report and a data-skipping index
    with a pruned query, each through the port's entry points."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (DataSkippingIndexConfig, Hyperspace,
                                          HyperspaceSession, IndexConfig, col)
        from hyperspace_tpu_torch.utils import calibrate

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        for i in range(4):
            pq.write_table(pa.table({{"k": np.arange(i * 100, (i + 1) * 100),
                                      "v": np.arange(100) * 0.5}}),
                           os.path.join(data, f"part-{{i}}.parquet"))
        os.environ["HS_CALIBRATE"] = "1"
        assert calibrate.profile_summary("cpu")["calibrated"] is True
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ci", ["v"], ["k"]))
        assert hs.last_build_report().bytes_written > 0
        hs.create_index(s.read.parquet(data), DataSkippingIndexConfig("ds", ["k"]))
        s.enable_hyperspace()
        ds = s.read.parquet(data).filter(col("k") == 250).select("k")
        assert "[files: 1/4]" in ds.optimized_plan().tree_string()
        assert ds.collect().num_rows == 1
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_integrity_loop_imports_no_jax(tmp_path):
    """verify_index quick and full, a query contained around a
    quarantined bucket, a truncated file found at execution, and
    refresh_index(mode="repair"), each through the port's entry points;
    the integrity modules load without pyarrow."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        from hyperspace_tpu_torch.actions import repair, verify
        from hyperspace_tpu_torch.execution import containment
        from hyperspace_tpu_torch.index import quarantine
        from hyperspace_tpu_torch.io import integrity, log_store
        assert "pyarrow" not in sys.modules
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        for i in range(3):
            pq.write_table(pa.table({{"k": rng.integers(0, 50, 300),
                                      "v": rng.random(300)}}),
                           os.path.join(data, f"part-{{i}}.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        # The device routes (the CPU defaults send work to the host).
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        files = [f.name for f in
                 s.index_collection_manager.get_index("ix").content.file_infos()]
        assert hs.verify_index("ix", "quick").column("status").to_pylist() \
            == ["ok"] * 4
        with open(files[1], "r+b") as f:
            f.seek(100)
            f.write(b"rot")
        assert "digest-mismatch" in \
            hs.verify_index("ix", "full").column("status").to_pylist()
        s.enable_hyperspace()
        q = s.read.parquet(data).filter(col("k") < 30).select("k", "v")
        assert "bucket_in" in q.optimized_plan().tree_string()
        n = q.collect().num_rows
        with open(files[2], "r+b") as f:
            f.truncate(100)
        assert q.collect().num_rows == n
        assert s.last_execution_stats["containment"]["replan"] == "containment"
        assert hs.refresh_index("ix", "repair").outcome == "ok"
        assert set(hs.verify_index("ix", "full").column("status").to_pylist()) \
            == {{"ok"}}
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_zorder_layout_imports_no_jax(tmp_path):
    """A Z-order index built monolithic and two-pass, refreshed
    incrementally, optimized, repaired and queried on its second column,
    each through the port's entry points; ``ops/zorder.py`` loads
    without pyarrow."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        from hyperspace_tpu_torch.ops import zorder
        assert "pyarrow" not in sys.modules
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        def part(i):
            pq.write_table(pa.table({{"x": rng.integers(0, 1000, 300),
                                      "y": rng.random(300)}}),
                           os.path.join(data, f"part-{{i}}.parquet"))
        for i in range(4):
            part(i)
        for batch, name in ((1 << 20, "mono"), (256, "two_pass")):
            s = HyperspaceSession({str(tmp_path / "ix")!r} + name,
                                  device="cpu")
            s.conf.device_batch_rows = batch
            s.conf.index_max_rows_per_file = 100
            # The device routes (the CPU defaults send work to the host).
            for kind in ("filter", "join", "agg", "build", "resident"):
                setattr(s.conf, f"device_{{kind}}_min_rows", 0)
            hs = Hyperspace(s)
            hs.create_index(s.read.parquet(data),
                            IndexConfig("z", ["x", "y"], layout="zorder"))
            assert ("spill_route_s" in s.build_stats_log[-1]) \
                == (name == "two_pass")
        part(9)
        assert hs.refresh_index("z", "incremental").outcome == "ok"
        assert hs.optimize_index("z", "full").outcome == "ok"
        files = [f.name for f in
                 s.index_collection_manager.get_index("z").content.file_infos()]
        with open(files[1], "r+b") as f:
            f.seek(100)
            f.write(b"rot")
        hs.verify_index("z", "full")
        assert hs.refresh_index("z", "repair").outcome == "ok"
        s.enable_hyperspace()
        q = s.read.parquet(data).filter(col("y") < 0.1).select("x", "y")
        assert "z" in [x.relation.index_scan_of
                       for x in q.optimized_plan().leaf_relations()]
        assert q.collect().num_rows > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_analytic_operators_import_no_jax(tmp_path):
    """Windows on the host engine and on the device-segment route,
    computed columns, DISTINCT and the set operations, each through the
    port's entry points; ``ops/window.py``, the executor and pruning
    load without pyarrow."""
    script = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        from hyperspace_tpu_torch.ops import window
        from hyperspace_tpu_torch.execution import executor
        from hyperspace_tpu_torch.plan import pruning
        assert "pyarrow" not in sys.modules
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import HyperspaceSession, col

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{"g": rng.integers(0, 5, 400),
                                  "o": rng.integers(0, 50, 400),
                                  "v": rng.random(400)}}),
                       os.path.join(data, "p.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.device_agg_min_rows = 0
        ds = s.read.parquet(data)
        out = (ds.with_window("t", "sum", partition_by=["g"], value="v")
               .with_window("r", "rank", partition_by=["g"], order_by=["o"])
               .with_window("m", "min", partition_by=["g"], order_by=["o"],
                            value="v", frame=(-2, 2))
               .select("g", "t", "r", "m", w=col("v") * 2).collect())
        assert out.num_rows == 400
        assert s.last_execution_stats["windows"][0]["strategy"] \\
            == "device-segment"
        assert ds.select("g").distinct().count() == 5
        assert ds.select("g").intersect(ds.select("g")).count() == 5
        assert ds.select("g").subtract(ds.select("g")).count() == 0
        assert ds.union(ds.with_column("x", col("o") + 1)).count() == 800
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_a_device_error_in_the_fused_join_aggregate_propagates(tmp_path,
                                                               monkeypatch):
    """Nothing catches an error of the fused path's device work to answer
    from the host instead."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch import col
    from hyperspace_tpu_torch.ops import join_agg

    for name, cols in (("o", {"ok": np.arange(50), "cust": np.arange(50) % 7}),
                       ("l", {"lk": np.arange(200) % 50,
                              "p": np.linspace(0, 1, 200)})):
        os.makedirs(tmp_path / name)
        pq.write_table(pa.table(cols), str(tmp_path / name / "part-0.parquet"))
    s = HyperspaceSession(str(tmp_path / "ix"), device="cpu")
    for kind in ("filter", "join", "agg", "build", "resident"):
        setattr(s.conf, f"device_{kind}_min_rows", 0)
    ds = (s.read.parquet(str(tmp_path / "o"))
          .join(s.read.parquet(str(tmp_path / "l")), col("ok") == col("lk"))
          .group_by("cust").agg(total=("p", "sum")))
    assert ds.collect().num_rows == 7
    assert s.last_execution_stats["joins"][-1]["strategy"] == "device-fused-agg"

    def broken(*args, **kwargs):
        raise RuntimeError("device join failed")

    monkeypatch.setattr(join_agg, "match_pairs", broken)
    with pytest.raises(RuntimeError, match="device join failed"):
        ds.collect()
    with pytest.raises(RuntimeError, match="device join failed"):
        ds.sort(("total", False)).limit(2).collect()


def test_session_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HyperspaceSession(str(tmp_path))
    with pytest.raises(RuntimeError):
        hyperspace_tpu_torch.HyperspaceSession(system_path=str(tmp_path),
                                               device=None)
    assert HyperspaceSession(str(tmp_path), device="cpu").device.type == "cpu"


def test_the_plan_language_imports_no_jax(tmp_path):
    """A correlated EXISTS with an inequality (a residual anti join), a
    folded scalar, CASE, CAST, a string function and a canonicalized
    year through the port's entry points; the plan modules load without
    pyarrow."""
    script = textwrap.dedent(f"""
        import os, sys, datetime
        import numpy as np
        from hyperspace_tpu_torch.plan import expr, subquery, temporal
        assert "pyarrow" not in sys.modules
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (HyperspaceSession, col, exists,
                                          outer_ref, scalar, substring, when,
                                          year)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        rng = np.random.default_rng(0)
        pq.write_table(pa.table({{
            "g": rng.integers(0, 20, 400), "s": rng.integers(0, 4, 400),
            "d": pa.array(np.datetime64("1994-06-01")
                          + np.arange(400).astype("timedelta64[D]")),
            "t": pa.array([("MAIL", "SHIP")[i % 2] for i in range(400)])}}),
            os.path.join(data, "p.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        rows = lambda: s.read.parquet(data)
        q = rows().filter(~exists(rows().filter(
            (col("g") == outer_ref("g")) & (col("s") != outer_ref("s")))))
        assert "residual" in q.optimized_plan().tree_string()
        df = pq.read_table(data).to_pandas()
        want = sum(df[df.g == g].s.nunique() == 1 for g in df.g)
        assert q.count() == want
        y = rows().filter((year("d") == 1995)
                          & (col("s") > scalar(rows().agg(m=("s", "mean")))))
        assert "year(" not in y.optimized_plan().tree_string()
        out = y.select(c=when(col("g") > 10, 1).otherwise(0),
                       p=substring("t", 1, 2),
                       n=col("g").cast("string")).collect()
        assert out.num_rows > 0 and set(out.column("p").to_pylist()) <= {{"MA", "SH"}}
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_guards_and_diagnostics_import_no_jax(tmp_path):
    """The guards and diagnostics load without pyarrow (the slow-query
    table, the doctor's table and the bundles import it when called);
    then a strict collect, a plan-cache hit, a deadline, the flight
    recorder, a bundle, the doctor and a JSON spec, each through the
    port's entry points, load neither jax nor the JAX package."""
    script = textwrap.dedent(f"""
        import os, sys
        from hyperspace_tpu_torch.execution import plan_cache, sync_guard
        from hyperspace_tpu_torch.utils import deadline
        from hyperspace_tpu_torch import interop
        from hyperspace_tpu_torch.telemetry import doctor, flight_recorder, slo
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        pq.write_table(pa.table({{"k": np.arange(300), "v": np.ones(300)}}),
                       os.path.join(data, "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        s.conf.device_guard_enabled = True
        s.conf.flight_recorder_slow_ms = 0.001
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()
        cache = plan_cache.PlanCache()
        ds = s.read.parquet(data).filter(col("k") == 7).select("k", "v")
        for _ in range(2):
            with deadline.scope(60.0):
                assert ds.collect(plan_cache=cache).num_rows == 1
        assert sync_guard.armed() and cache.stats()["hits"] == 1
        spec = {{"source": {{"format": "parquet", "path": data}},
                 "filter": {{"op": "==", "col": "k", "value": 7}}}}
        assert interop.dataset_from_spec(s, spec).collect().num_rows == 1
        assert hs.slow_queries().num_rows == 3
        assert hs.dump_diagnostics() and len(hs.diagnostics_bundles()) == 1
        assert hs.doctor().table().num_rows == 10
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_object_store_log_imports_no_jax(tmp_path):
    """A build and a query through ``ObjectStoreLogManager`` over
    ``EmulatedObjectStore`` under a listing window, then every conf
    field naming a class of the JAX package: each raises
    ``HyperspaceError``, and neither jax nor the JAX package is
    imported."""
    script = textwrap.dedent(f"""
        import os, sys
        import hyperspace_tpu_torch.io.log_store
        import hyperspace_tpu_torch.index.object_log_manager
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig, col)
        from hyperspace_tpu_torch.exceptions import HyperspaceError

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        pq.write_table(pa.table({{"k": np.arange(300),
                                  "v": np.arange(300) * 0.5}}),
                       os.path.join(data, "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        for kind in ("filter", "join", "agg", "build", "resident"):
            setattr(s.conf, f"device_{{kind}}_min_rows", 0)
        s.conf.log_manager_class = (
            "hyperspace_tpu_torch.index.object_log_manager"
            ".ObjectStoreLogManager")
        s.conf.object_store_stale_list_ms = 60000.0
        hs = Hyperspace(s)
        hs.create_index(s.read.parquet(data), IndexConfig("ix", ["k"], ["v"]))
        mgr = s.index_collection_manager._log_manager("ix")
        assert mgr.store.list_keys() == [] and mgr.log_ids() == [1, 2]
        s.enable_hyperspace()
        out = s.read.parquet(data).filter(col("k") == 7).select("v").collect()
        assert out.column("v").to_pylist() == [3.5]
        refused = 0
        for field, path in (
                ("log_store_class", "hyperspace_tpu.io.log_store.PosixLogStore"),
                ("log_manager_class",
                 "hyperspace_tpu.index.log_manager.IndexLogManager")):
            t = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
            setattr(t.conf, field, path)
            try:
                Hyperspace(t).create_index(t.read.parquet(data),
                                           IndexConfig("x", ["k"], ["v"]))
            except HyperspaceError as e:
                refused += "JAX package" in str(e)
        assert refused == 2, refused
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_the_query_server_imports_no_jax(tmp_path):
    """The server, its client and the wire-fault seams load without
    pyarrow; then a served query, a verb and a drain over loopback, on a
    ``cpu`` session, and a torn response and a tenant on an async
    server, load neither jax nor the JAX package."""
    script = textwrap.dedent(f"""
        import os, sys
        from hyperspace_tpu_torch.interop import netfaults, server
        from hyperspace_tpu_torch.interop import QueryClient, QueryServer
        assert not any(m == "pyarrow" or m.startswith("pyarrow.")
                       for m in sys.modules), "pyarrow at load"
        import numpy as np
        import pyarrow as pa
        import pyarrow.parquet as pq
        from hyperspace_tpu_torch import (Hyperspace, HyperspaceSession,
                                          IndexConfig)

        data = {str(tmp_path / "data")!r}
        os.makedirs(data)
        pq.write_table(pa.table({{"k": np.arange(300), "v": np.ones(300)}}),
                       os.path.join(data, "part-0.parquet"))
        s = HyperspaceSession({str(tmp_path / "ix")!r}, device="cpu")
        s.conf.num_buckets = 4
        Hyperspace(s).create_index(s.read.parquet(data),
                                   IndexConfig("ix", ["k"], ["v"]))
        s.enable_hyperspace()
        srv = QueryServer(s).start()
        try:
            with QueryClient(srv.address, timeout_s=60) as c:
                out = c.query({{"source": {{"format": "parquet",
                                            "path": data}},
                                "filter": {{"op": "==", "col": "k",
                                            "value": 7}}}})
                assert out.num_rows == 1
                assert c.query({{"verb": "metrics"}}).num_rows > 0
            assert srv.drain(grace_s=30)
        finally:
            srv.stop()
        from hyperspace_tpu_torch.io import faults
        s.conf.serving_io_mode = "async"
        s.conf.serving_tenant_max_queued = 1
        with QueryServer(s) as srv:
            faults.install(faults.FaultPlan("net.send", "torn-frame", at=2))
            try:
                with QueryClient(srv.address, timeout_s=60) as c:
                    c.query({{"source": {{"format": "parquet",
                                          "path": data}}}})
            except ConnectionError:
                pass
            else:
                raise AssertionError("the torn response was read")
            finally:
                faults.clear()
            with QueryClient(srv.address, tenant="t", timeout_s=60) as c:
                assert c.query({{"verb": "tenants"}}).num_rows == 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))
        print("LEAKED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LEAKED []" in proc.stdout


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """Every import statement of chip_smoke.py, at any depth (phase T's
    server and client included), names neither jax nor the JAX
    package."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "hyperspace_tpu_torch.interop" in names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "hyperspace_tpu"), name
