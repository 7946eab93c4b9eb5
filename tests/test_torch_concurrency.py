"""Cross-process races over the port's stores (the mirror of
tests/test_concurrency.py's store cases): separate OS processes, each
importing only hyperspace_tpu_torch and running on the CPU, race one log
id, the ``latestStable`` pointer, one ``create_index``, and a storm of
create/refresh/optimize with faults through the emulated object store.
Every assertion is the JAX case's.

The workers are module functions run by ``spawn``-context pools: a
fresh interpreter imports this module, which imports neither ``jax`` nor
the JAX package at load.
"""

from __future__ import annotations

import multiprocessing as mp
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

_OBJECT_LOG = ("hyperspace_tpu_torch.index.object_log_manager."
               "ObjectStoreLogManager")


def _sample_entry(name: str = "myIndex", state: str = "ACTIVE"):
    """tests/utils.sample_entry with the port's classes."""
    from hyperspace_tpu_torch.index.log_entry import (
        Content,
        CoveringIndex,
        Directory,
        FileInfo,
        IndexLogEntry,
        LogicalPlanFingerprint,
        Relation,
        Signature,
        Source,
    )

    schema = {"id": "int64", "name": "int64"}
    return IndexLogEntry(
        name=name,
        derived_dataset=CoveringIndex(indexed_columns=["id"],
                                      included_columns=["name"],
                                      num_buckets=4, schema=schema),
        content=Content(Directory.from_leaf_files(
            [FileInfo("/idx/v__=0/part-0.parquet", 10, 10, -1)])),
        source=Source(
            relations=[Relation(
                root_paths=["/data/t"],
                content=Content(Directory.from_leaf_files(
                    [FileInfo("/data/t/f1.parquet", 100, 100, 0)])),
                schema=schema, file_format="parquet")],
            fingerprint=LogicalPlanFingerprint(
                [Signature("IndexSignatureProvider", "sig0")])),
        state=state,
    )


def _make_log_manager(kind: str, index_path: str):
    if kind == "posix":
        from hyperspace_tpu_torch.index.log_manager import IndexLogManager

        return IndexLogManager(index_path)
    from hyperspace_tpu_torch.index.object_log_manager import (
        ObjectStoreLogManager,
    )

    return ObjectStoreLogManager(index_path)


def _leaked() -> list:
    import sys

    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "hyperspace_tpu" or m.startswith("hyperspace_tpu."))


def _race_write_log(args):
    index_path, worker, kind = args
    mgr = _make_log_manager(kind, index_path)
    entry = _sample_entry(name=f"w{worker}")
    entry.id = 5
    try:
        mgr.write_log_or_raise(5, entry)
        return ("win", worker, _leaked())
    except Exception as e:  # noqa: BLE001 - the loser's error is the result
        return ("lose", type(e).__name__, _leaked())


def _race_cas_pointer(args):
    index_path, log_id = args
    return _make_log_manager("objstore", index_path) \
        .create_latest_stable_log(log_id)


def _race_create_index(args):
    root, worker = args
    os.environ["HS_DEVICE_BATCH_ROWS"] = "1024"
    from hyperspace_tpu_torch import Hyperspace, HyperspaceSession, IndexConfig

    s = HyperspaceSession(system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.num_buckets = 2
    hs = Hyperspace(s)
    try:
        hs.create_index(s.read.parquet(os.path.join(root, "data")),
                        IndexConfig("racy", ["id"], ["name"]))
        return ("win", worker, _leaked())
    except Exception as e:  # noqa: BLE001 - the loser's error is the result
        return ("lose", type(e).__name__, _leaked())


@pytest.mark.parametrize("kind", ["posix", "objstore"])
def test_write_log_same_id_across_processes(tmp_path, kind):
    """Exactly one winner for a contended log id across OS processes,
    on both backends: posix O_EXCL and the object store's conditional
    put."""
    index_path = str(tmp_path / "idx")
    os.makedirs(index_path)
    ctx = mp.get_context("spawn")
    with ctx.Pool(4) as pool:
        results = pool.map(_race_write_log,
                           [(index_path, i, kind) for i in range(8)])
    assert all(r[2] == [] for r in results), results
    wins = [r for r in results if r[0] == "win"]
    assert len(wins) == 1, results
    entry = _make_log_manager(kind, index_path).get_log(5)
    assert entry is not None and entry.id == 5


def test_cas_pointer_storm_across_processes(tmp_path):
    """8 processes race ``latestStable`` toward different stable ids over
    the emulated object store: the final pointer is the maximum id and
    parses to a stable entry."""
    index_path = str(tmp_path / "idx")
    os.makedirs(index_path)
    mgr = _make_log_manager("objstore", index_path)
    for i in range(1, 9):
        assert mgr.write_log(i, _sample_entry(state="ACTIVE"))
    ctx = mp.get_context("spawn")
    with ctx.Pool(4) as pool:
        results = pool.map(_race_cas_pointer,
                           [(index_path, i) for i in range(1, 9)])
    assert all(results), results
    resolved = mgr.get_latest_stable_log()
    assert resolved is not None and resolved.id == 8


def test_create_index_race_one_winner(tmp_path):
    root = str(tmp_path)
    data = os.path.join(root, "data")
    os.makedirs(data)
    pq.write_table(pa.table({
        "id": pa.array(np.arange(200, dtype=np.int64)),
        "name": pa.array([f"n{i}" for i in range(200)]),
    }), os.path.join(data, "p.parquet"))
    ctx = mp.get_context("spawn")
    with ctx.Pool(3) as pool:
        results = pool.map(_race_create_index,
                           [(root, i) for i in range(3)])
    assert all(r[2] == [] for r in results), results
    wins = [r for r in results if r[0] == "win"]
    # Exactly one: begin()'s log write is create-if-absent, and a late
    # starter fails validate() on the winner's ACTIVE entry.
    assert len(wins) == 1, results
    from hyperspace_tpu_torch import HyperspaceSession, col

    s = HyperspaceSession(system_path=os.path.join(root, "ix"), device="cpu")
    entry = s.index_collection_manager.get_index("racy")
    assert entry is not None and entry.state == "ACTIVE"
    s.enable_hyperspace()
    out = (s.read.parquet(data).filter(col("id") == 5)
           .select("id", "name").collect())
    assert out.num_rows == 1


def _stress_worker(args):
    """One racer of the create/refresh/optimize storm: its own session on
    the object-store log, faults armed through the conf, conflict
    retries and auto recovery on.  Returns (worker, [(op, outcome)])."""
    root, worker, fault = args
    os.environ["HS_DEVICE_BATCH_ROWS"] = "1024"
    from hyperspace_tpu_torch import (
        Hyperspace,
        HyperspaceConf,
        HyperspaceSession,
        IndexConfig,
    )
    from hyperspace_tpu_torch.exceptions import (
        ConcurrentWriteError,
        HyperspaceError,
    )
    from hyperspace_tpu_torch.io import faults

    conf = HyperspaceConf()
    conf.num_buckets = 2
    conf.auto_recovery_enabled = True
    conf.log_manager_class = _OBJECT_LOG
    conf.object_store_stale_list_ms = 50
    if fault is not None:
        conf.fault_injection_enabled = True
        (conf.fault_injection_site, conf.fault_injection_kind,
         conf.fault_injection_at) = fault
        conf.fault_injection_count = 1
    s = HyperspaceSession(system_path=os.path.join(root, "ix"), device="cpu",
                          conf=conf)
    hs = Hyperspace(s)
    d = os.path.join(root, "data")
    outcomes = []

    def attempt(op, fn):
        try:
            fn()
            outcomes.append((op, "ok"))
        except ConcurrentWriteError:
            outcomes.append((op, "conflict"))
        except HyperspaceError as e:
            outcomes.append((op, f"refused:{type(e).__name__}"))
        except faults.InjectedCrash:
            outcomes.append((op, "crashed"))
        except BaseException as e:  # noqa: BLE001 - reported to the parent
            outcomes.append((op, f"error:{type(e).__name__}:{e}"))

    attempt("create", lambda: hs.create_index(
        s.read.parquet(d), IndexConfig("storm", ["k"], ["v"])))
    pq.write_table(pa.table({
        "k": pa.array(np.arange(1000 + worker * 10,
                                1010 + worker * 10, dtype=np.int64)),
        "v": pa.array(np.arange(10) * 1.0),
    }), os.path.join(d, f"w{worker}.parquet"))
    attempt("refresh", lambda: hs.refresh_index("storm", mode="incremental"))
    attempt("optimize", lambda: hs.optimize_index("storm"))
    return (worker, outcomes, _leaked())


def test_multiprocess_stress_objectstore_with_faults(tmp_path):
    """Race create/refresh/optimize across processes through
    EmulatedObjectStore (a listing window armed) with injected faults,
    then the log's invariants: contiguous ids, ``latestStable`` a
    parseable stable entry, every aborted writer rolled back by a final
    recovering pass, and the index answering every committed delta."""
    root = str(tmp_path)
    d = os.path.join(root, "data")
    os.makedirs(d)
    pq.write_table(pa.table({
        "k": pa.array(np.arange(200, dtype=np.int64)),
        "v": pa.array(np.arange(200) * 1.0),
    }), os.path.join(d, "p.parquet"))
    faults_by_worker = [
        None,                          # a clean writer
        ("store.put", "eio", 2),       # a transient store error
        ("store.put", "torn", 3),      # killed mid-put: a burned id
    ]
    ctx = mp.get_context("spawn")
    with ctx.Pool(3) as pool:
        results = pool.map(_stress_worker,
                           [(root, i, faults_by_worker[i]) for i in range(3)])
    assert all(r[2] == [] for r in results), results
    outcomes = {w: dict(ops) for w, ops, _ in results}
    create_wins = [w for w, o in outcomes.items() if o["create"] == "ok"]
    assert len(create_wins) <= 1, outcomes
    for w, o in outcomes.items():
        for op, res in o.items():
            assert res.split(":")[0] in ("ok", "conflict", "refused",
                                         "crashed"), (w, op, res, outcomes)

    from hyperspace_tpu_torch import (
        Hyperspace,
        HyperspaceSession,
        IndexConfig,
        col,
    )
    from hyperspace_tpu_torch.index.log_entry import States

    s = HyperspaceSession(system_path=os.path.join(root, "ix"), device="cpu")
    s.conf.num_buckets = 2
    s.conf.log_manager_class = _OBJECT_LOG
    s.conf.auto_recovery_enabled = True
    mgr = s.index_collection_manager._log_manager("storm")
    ids = mgr.log_ids()
    assert ids == list(range(1, len(ids) + 1)), ids
    stable = mgr.get_latest_stable_log()
    assert stable is None or stable.state in States.STABLE
    hs = Hyperspace(s)
    if stable is None or stable.state != States.ACTIVE:
        hs.create_index(s.read.parquet(d),
                        IndexConfig("storm", ["k"], ["v"]))
    else:
        hs.refresh_index("storm", mode="incremental")
    entry = s.index_collection_manager.get_index("storm")
    assert entry is not None and entry.state == States.ACTIVE
    s.enable_hyperspace()
    for w in range(3):
        k = 1000 + w * 10 + 5
        out = (s.read.parquet(d).filter(col("k") == k)
               .select("k", "v").collect())
        assert out.column("v").to_pylist() == [5.0], (w, out)
    assert any(x["is_index"] for x in s.last_execution_stats["scans"])
