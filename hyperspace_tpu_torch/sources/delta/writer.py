"""A Delta table writer (counterpart of
hyperspace_tpu/sources/delta/writer.py): append, overwrite, file and
row deletes, and upserts, as Parquet part files and JSON commits that
any Delta reader understands.

``write_delta`` commits version 0 with the protocol and a ``metaData``
action, later versions with the new file (overwrite: a remove of every
active file first, and a new ``metaData`` when the schema changed, the
table id kept).  ``delete_where_file`` removes one data file;
``upsert_delta`` and ``delete_rows_delta`` rewrite each file holding a
matching key (a remove of it and an add of its surviving rows, the
file-level shape a MERGE or DELETE commit leaves) in one commit.  Commit
timestamps are wall-clock ms made strictly monotonic, so
``timestampAsOf`` resolves to one version; the add actions carry the
same ms as ``modificationTime``.  Every CHECKPOINT_INTERVAL-th commit
writes ``N.checkpoint.parquet`` (the protocol's explicit schema, the
unexpired tombstones with it) and ``_last_checkpoint``, each through a
temporary file and a rename; a checkpoint that fails leaves the commit,
already durable, as it is.  Tables are unpartitioned.  pyarrow is
imported inside the functions.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import List

from hyperspace_tpu_torch.io.schemas import (
    arrow_schema_from_spark,
    spark_schema_string,
)
from hyperspace_tpu_torch.sources.delta.log import DeltaLog

__all__ = ["write_delta", "delete_where_file", "upsert_delta",
           "delete_rows_delta", "spark_schema_string",
           "arrow_schema_from_spark"]

CHECKPOINT_INTERVAL = 10

# delta.deletedFileRetentionDuration's default, one week: a checkpoint
# keeps the tombstones younger than this.
TOMBSTONE_RETENTION_MS = 7 * 24 * 3600 * 1000


def _part_name() -> str:
    return f"part-00000-{uuid.uuid4().hex}-c000.snappy.parquet"


def _write_part(table, log: DeltaLog, now_ms: int) -> dict:
    """``table`` as a new part file of the table; its add action."""
    import pyarrow.parquet as pq

    name = _part_name()
    path = f"{log.table_path}/{name}"
    os.makedirs(log.table_path, exist_ok=True)
    pq.write_table(table, path)
    return {"add": {"path": name, "partitionValues": {},
                    "size": os.stat(path).st_size,
                    "modificationTime": now_ms, "dataChange": True}}


def _next_commit_ts(log: DeltaLog, version: int) -> int:
    """Wall-clock ms, past the previous commit's timestamp."""
    now_ms = int(time.time() * 1000)
    prev_ts = log._commit_timestamp(version - 1) if version > 0 else None
    if prev_ts is not None and now_ms <= prev_ts:
        now_ms = prev_ts + 1
    return now_ms


def _relativize(path: str, root: str) -> str:
    prefix = root.rstrip("/") + "/"
    return path[len(prefix):] if path.startswith(prefix) else path


def _metadata_action(table_id: str, schema_string: str, configuration,
                     created_ms=None) -> dict:
    meta = {"id": table_id,
            "format": {"provider": "parquet", "options": {}},
            "schemaString": schema_string,
            "partitionColumns": [],
            "configuration": configuration}
    if created_ms is not None:
        meta["createdTime"] = created_ms
    return {"metaData": meta}


def write_delta(table, path: str, mode: str = "append") -> int:
    """Write ``table`` to the Delta table at ``path`` ("append" adds a
    file; "overwrite" removes every active file and adds the new one);
    returns the committed version."""
    if mode not in ("append", "overwrite"):
        raise ValueError(f"Unknown write mode {mode!r}")
    log = DeltaLog(path)
    version = log.latest_version() + 1 if log.exists() else 0
    now_ms = _next_commit_ts(log, version)
    actions: List[dict] = []
    if version == 0:
        actions.append({"protocol": {"minReaderVersion": 1,
                                     "minWriterVersion": 2}})
        actions.append(_metadata_action(uuid.uuid4().hex,
                                        spark_schema_string(table.schema),
                                        {}, now_ms))
    elif mode == "overwrite":
        snapshot = log.snapshot()
        for f in snapshot.files:
            actions.append({"remove": {
                "path": _relativize(f.path, log.table_path),
                "deletionTimestamp": now_ms, "dataChange": True}})
        new_schema = spark_schema_string(table.schema)
        if new_schema != snapshot.metadata.schema_string:
            actions.append(_metadata_action(
                snapshot.metadata.id or uuid.uuid4().hex, new_schema,
                dict(snapshot.metadata.configuration)))
    actions.append(_write_part(table, log, now_ms))
    actions.append({"commitInfo": {"timestamp": now_ms, "operation": "WRITE",
                                   "operationParameters": {"mode": mode}}})
    log.write_commit(version, actions)
    _maybe_checkpoint(log, version)
    return version


def _checkpoint_schema():
    import pyarrow as pa

    return pa.schema([
        ("protocol", pa.struct([("minReaderVersion", pa.int32()),
                                ("minWriterVersion", pa.int32())])),
        ("metaData", pa.struct([
            ("id", pa.string()),
            ("format", pa.struct([("provider", pa.string())])),
            ("schemaString", pa.string()),
            ("partitionColumns", pa.list_(pa.string())),
            ("configuration", pa.map_(pa.string(), pa.string())),
            ("createdTime", pa.int64()),
        ])),
        ("add", pa.struct([
            ("path", pa.string()),
            ("partitionValues", pa.map_(pa.string(), pa.string())),
            ("size", pa.int64()),
            ("modificationTime", pa.int64()),
            ("dataChange", pa.bool_()),
        ])),
        ("remove", pa.struct([
            ("path", pa.string()),
            ("deletionTimestamp", pa.int64()),
            ("dataChange", pa.bool_()),
        ])),
    ])


def _maybe_checkpoint(log: DeltaLog, version: int) -> None:
    """``version.checkpoint.parquet`` and ``_last_checkpoint`` at every
    CHECKPOINT_INTERVAL-th version.  The rows restate the snapshot with
    ``dataChange`` false; tombstones younger than the retention window,
    or of unknown age (0), ride along."""
    if version == 0 or version % CHECKPOINT_INTERVAL != 0:
        return
    import pyarrow as pa
    import pyarrow.parquet as pq

    try:
        snap = log.snapshot(version)
        empty = {"protocol": None, "metaData": None, "add": None,
                 "remove": None}
        rows = [
            {**empty, "protocol": {"minReaderVersion": 1,
                                   "minWriterVersion": 2}},
            {**empty, "metaData": {
                "id": snap.metadata.id,
                "format": {"provider": "parquet"},
                "schemaString": snap.metadata.schema_string,
                "partitionColumns": snap.metadata.partition_columns,
                "configuration": list(snap.metadata.configuration.items()),
                "createdTime": None}},
        ]
        for f in snap.files:
            rows.append({**empty, "add": {
                "path": _relativize(f.path, log.table_path),
                "partitionValues": [], "size": f.size,
                "modificationTime": f.modification_time,
                "dataChange": False}})
        horizon = int(time.time() * 1000) - TOMBSTONE_RETENTION_MS
        for t in snap.tombstones:
            if t.deletion_timestamp >= horizon or t.deletion_timestamp == 0:
                rows.append({**empty, "remove": {
                    "path": _relativize(t.path, log.table_path),
                    "deletionTimestamp": t.deletion_timestamp,
                    "dataChange": False}})
        cp_path = os.path.join(log.log_path,
                               f"{version:020d}.checkpoint.parquet")
        tmp = cp_path + f".tmp{os.getpid()}"
        pq.write_table(pa.Table.from_pylist(rows, schema=_checkpoint_schema()),
                       tmp)
        os.replace(tmp, cp_path)
        last = os.path.join(log.log_path, "_last_checkpoint")
        tmp = last + f".tmp{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"version": version, "size": len(rows)}, f)
        os.replace(tmp, last)
    except Exception:  # noqa: BLE001 - the commit is durable already;
        pass  # the JSON log stays replayable without the checkpoint


def delete_where_file(path: str, file_path: str) -> int:
    """Commit the removal of one data file; returns the version."""
    log = DeltaLog(path)
    version = log.latest_version() + 1
    now_ms = _next_commit_ts(log, version)
    log.write_commit(version, [
        {"remove": {"path": _relativize(file_path, log.table_path),
                    "deletionTimestamp": now_ms, "dataChange": True}},
        {"commitInfo": {"timestamp": now_ms, "operation": "DELETE"}},
    ])
    _maybe_checkpoint(log, version)
    return version


def _rewrite_actions(log: DeltaLog, key: str, key_set,
                     now_ms: int) -> List[dict]:
    """A remove of every active file holding a row whose ``key`` is in
    ``key_set`` and, unless every row matched, an add of its surviving
    rows as a new part file."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    actions: List[dict] = []
    for f in log.snapshot().files:
        data = pq.read_table(f.path)
        if key not in data.column_names:
            raise ValueError(f"Key column {key!r} not in {f.path}")
        mask = pc.is_in(data.column(key), value_set=key_set.cast(
            data.schema.field(key).type))
        if not pc.any(mask).as_py():
            continue
        actions.append({"remove": {
            "path": _relativize(f.path, log.table_path),
            "deletionTimestamp": now_ms, "dataChange": True}})
        survivors = data.filter(pc.invert(mask))
        if survivors.num_rows:
            actions.append(_write_part(survivors, log, now_ms))
    return actions


def upsert_delta(table, path: str, key: str) -> int:
    """MERGE ``table`` into the table at ``path`` on column ``key``:
    rows with a matching key are replaced, the others inserted, in one
    commit (created as version 0 when the table does not exist).
    Returns the version."""
    log = DeltaLog(path)
    if not log.exists():
        return write_delta(table, path, mode="append")
    version = log.latest_version() + 1
    now_ms = _next_commit_ts(log, version)
    actions = _rewrite_actions(log, key, table.column(key).combine_chunks(),
                               now_ms)
    actions.append(_write_part(table, log, now_ms))
    actions.append({"commitInfo": {
        "timestamp": now_ms, "operation": "MERGE",
        "operationParameters": {"matchedPredicates": key}}})
    log.write_commit(version, actions)
    _maybe_checkpoint(log, version)
    return version


def delete_rows_delta(path: str, key: str, values) -> int:
    """DELETE the rows whose ``key`` is in ``values``, in one commit;
    returns its version, or the current version when no row matched (no
    commit then)."""
    import pyarrow as pa

    log = DeltaLog(path)
    version = log.latest_version() + 1
    now_ms = _next_commit_ts(log, version)
    actions = _rewrite_actions(log, key, pa.array(list(values)), now_ms)
    if not actions:
        return version - 1
    actions.append({"commitInfo": {
        "timestamp": now_ms, "operation": "DELETE",
        "operationParameters": {"predicate": key}}})
    log.write_commit(version, actions)
    _maybe_checkpoint(log, version)
    return version
