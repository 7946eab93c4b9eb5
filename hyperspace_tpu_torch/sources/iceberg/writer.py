"""An Iceberg table writer (counterpart of
hyperspace_tpu/sources/iceberg/writer.py): appends, overwrites, file and
row deletes and upserts, as HadoopTables-style tables that
``metadata.IcebergTable`` reads.

Every commit writes its data files under ``data/``, one manifest of all
the snapshot's entries (added, existing and deleted) and its manifest
list under ``metadata/``, then ``v<N+1>.metadata.json`` by an exclusive
create, the commit point: of two writers racing for one version, one
wins and the other gets ``FileExistsError``.  ``version-hint.text``
follows.  A snapshot's ``timestamp-ms`` is the wall clock in ms, past
the latest snapshot's, so ``as-of-timestamp`` resolves to one snapshot.

An append must match the table's schema (an optional column may be left
out); an overwrite may change it, and then a surviving column (same name
and type) keeps its field id while every other takes a fresh id above
``last-column-id``, so field ids stay unique across the table's history.
``upsert_iceberg`` and ``delete_rows_iceberg`` rewrite each live file
holding a matching key in one snapshot (the file deleted, its surviving
rows added as a new file: the copy-on-write shape a MERGE or DELETE
leaves).  Snapshot ids and file names come from ``uuid4``.  Tables are
unpartitioned.  pyarrow is imported inside the functions.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Dict, List, Optional

from hyperspace_tpu_torch.io import avro
from hyperspace_tpu_torch.io.schemas import iceberg_schema
from hyperspace_tpu_torch.sources.iceberg.metadata import (
    MANIFEST_ENTRY_SCHEMA,
    MANIFEST_LIST_SCHEMA,
    METADATA_DIR,
    STATUS_ADDED,
    STATUS_DELETED,
    STATUS_EXISTING,
    VERSION_HINT,
    DataFile,
    IcebergTable,
    TableMetadata,
)


def _new_snapshot_id() -> int:
    return uuid.uuid4().int & ((1 << 62) - 1)


def _evolve_schema(metadata: TableMetadata, arrow_schema) -> Dict:
    """The schema of an overwrite: a column of the same name and type as
    one of the table's keeps its id, any other takes the next id above
    ``last-column-id`` (a dropped column's id is never reused)."""
    fresh = iceberg_schema(arrow_schema)
    old_by_name = {f["name"]: f for f in metadata.schema.get("fields", [])}
    next_id = max(metadata.last_column_id,
                  max((f["id"] for f in old_by_name.values()), default=0))
    fields = []
    for f in fresh["fields"]:
        old = old_by_name.get(f["name"])
        if old is not None and old.get("type") == f["type"]:
            fields.append({**f, "id": old["id"]})
        else:
            next_id += 1
            fields.append({**f, "id": next_id})
    return {"type": "struct", "schema-id": 0, "fields": fields}


def _check_append_schema(metadata: TableMetadata, arrow_schema,
                         path: str) -> None:
    """Refuse an append with a column the table lacks or of another
    type; leaving out a column is allowed (readers fill it with nulls)."""
    fresh = {f["name"]: f["type"] for f in iceberg_schema(arrow_schema)["fields"]}
    existing = {f["name"]: f["type"]
                for f in metadata.schema.get("fields", [])}
    problems = [f"unknown column {n!r} ({t})" for n, t in sorted(fresh.items())
                if n not in existing]
    problems += [f"column {n!r} is {t}, table has {existing[n]}"
                 for n, t in sorted(fresh.items())
                 if n in existing and t != existing[n]]
    if problems:
        raise ValueError(
            f"Appended data schema does not match Iceberg table {path}: "
            f"{'; '.join(problems)}; use mode='overwrite' to change the "
            f"schema")


def _write_manifest(table_path: str, entries: List[Dict],
                    snapshot_id: int) -> Dict:
    """A manifest of ``entries``; its manifest list entry."""
    path = os.path.join(table_path, METADATA_DIR,
                        f"{uuid.uuid4().hex}-m0.avro")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    avro.write_container(path, MANIFEST_ENTRY_SCHEMA, entries,
                         metadata={"schema": json.dumps(MANIFEST_ENTRY_SCHEMA),
                                   "format-version": "1"})
    count = {s: sum(1 for e in entries if e["status"] == s)
             for s in (STATUS_ADDED, STATUS_EXISTING, STATUS_DELETED)}
    return {
        "manifest_path": path,
        "manifest_length": os.stat(path).st_size,
        "partition_spec_id": 0,
        "added_snapshot_id": snapshot_id,
        "added_data_files_count": count[STATUS_ADDED],
        "existing_data_files_count": count[STATUS_EXISTING],
        "deleted_data_files_count": count[STATUS_DELETED],
    }


def _commit(table: IcebergTable, metadata: Optional[TableMetadata],
            manifest_files: List[Dict], snapshot_id: int, now_ms: int,
            schema: Dict, properties: Dict[str, str],
            operation: str, table_uuid: str) -> int:
    """The manifest list, then the next metadata version by an exclusive
    create (the commit point), then ``version-hint.text``."""
    md_dir = os.path.join(table.table_path, METADATA_DIR)
    os.makedirs(md_dir, exist_ok=True)
    list_path = os.path.join(
        md_dir, f"snap-{snapshot_id}-1-{uuid.uuid4().hex}.avro")
    avro.write_container(list_path, MANIFEST_LIST_SCHEMA, manifest_files,
                         metadata={"format-version": "1"})
    snapshots = [
        {"snapshot-id": s.snapshot_id, "timestamp-ms": s.timestamp_ms,
         "manifest-list": s.manifest_list, "summary": s.summary}
        for s in (metadata.snapshots if metadata else [])
    ]
    snapshots.append({
        "snapshot-id": snapshot_id,
        "timestamp-ms": now_ms,
        "manifest-list": list_path,
        "summary": {"operation": operation},
    })
    version = (metadata.metadata_version + 1) if metadata else 1
    doc = {
        "format-version": 1,
        "table-uuid": table_uuid,
        "location": table.table_path,
        "last-updated-ms": now_ms,
        # Never below an earlier one, also when the highest id was dropped.
        "last-column-id": max(
            [f["id"] for f in schema["fields"]]
            + [metadata.last_column_id if metadata else 0]),
        "schema": schema,
        "partition-spec": [],
        "properties": properties,
        "current-snapshot-id": snapshot_id,
        "snapshots": snapshots,
    }
    md_path = os.path.join(md_dir, f"v{version}.metadata.json")
    with open(md_path, "x", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
    with open(os.path.join(md_dir, VERSION_HINT), "w", encoding="utf-8") as f:
        f.write(str(version))
    return version


def _entry(status: int, snapshot_id: int, f: DataFile) -> Dict:
    return {"status": status, "snapshot_id": snapshot_id,
            "data_file": {"file_path": f.path, "file_format": "PARQUET",
                          "record_count": f.record_count,
                          "file_size_in_bytes": f.size}}


def _next_ts(metadata: Optional[TableMetadata]) -> int:
    """Wall-clock ms, past the latest snapshot's ``timestamp-ms``."""
    now_ms = int(time.time() * 1000)
    if metadata and metadata.snapshots:
        latest_ts = max(s.timestamp_ms for s in metadata.snapshots)
        if now_ms <= latest_ts:
            now_ms = latest_ts + 1
    return now_ms


def _write_data_file(table: IcebergTable, data) -> DataFile:
    import pyarrow.parquet as pq

    data_dir = os.path.join(table.table_path, "data")
    os.makedirs(data_dir, exist_ok=True)
    file_path = os.path.join(data_dir, f"{uuid.uuid4().hex}-00000.parquet")
    pq.write_table(data, file_path)
    return DataFile(file_path, os.stat(file_path).st_size, data.num_rows)


def write_iceberg(data, path: str, mode: str = "append") -> int:
    """Write the arrow table ``data`` to the Iceberg table at ``path``
    ("append" adds a file; "overwrite" replaces the live files and may
    change the schema); returns the new snapshot id."""
    if mode not in ("append", "overwrite"):
        raise ValueError(f"Unknown write mode {mode!r}")
    table = IcebergTable(path)
    exists = table.exists()
    metadata = table.load_metadata() if exists else None
    now_ms = _next_ts(metadata)
    if metadata and mode == "append":
        _check_append_schema(metadata, data.schema, path)
        schema = metadata.schema
    elif metadata:
        schema = _evolve_schema(metadata, data.schema)
    else:
        schema = iceberg_schema(data.schema)
    table_uuid = metadata.table_uuid if metadata else str(uuid.uuid4())
    properties = metadata.properties if metadata else {}
    new_file = _write_data_file(table, data)
    snapshot_id = _new_snapshot_id()
    carried: List[DataFile] = []
    if exists and mode == "append":
        carried = table.plan_files(metadata=metadata)
    entries = [_entry(STATUS_EXISTING, snapshot_id, f) for f in carried]
    entries.append(_entry(STATUS_ADDED, snapshot_id, new_file))
    manifest = _write_manifest(table.table_path, entries, snapshot_id)
    _commit(table, metadata, [manifest], snapshot_id, now_ms, schema,
            properties, mode, table_uuid)
    return snapshot_id


def delete_file_iceberg(path: str, file_path: str) -> int:
    """Commit a snapshot without the live data file ``file_path``;
    returns its id."""
    table = IcebergTable(path)
    metadata = table.load_metadata()
    now_ms = _next_ts(metadata)
    live = table.plan_files(metadata=metadata)
    target = os.path.abspath(file_path)
    if not any(f.path == target for f in live):
        raise FileNotFoundError(f"{file_path} is not a live file of {path}")
    snapshot_id = _new_snapshot_id()
    entries = [_entry(STATUS_EXISTING, snapshot_id, f)
               for f in live if f.path != target]
    entries.extend(_entry(STATUS_DELETED, snapshot_id, f)
                   for f in live if f.path == target)
    manifest = _write_manifest(table.table_path, entries, snapshot_id)
    _commit(table, metadata, [manifest], snapshot_id, now_ms, metadata.schema,
            metadata.properties, "delete", metadata.table_uuid)
    return snapshot_id


def _rewrite_entries(table: IcebergTable, live: List[DataFile], key: str,
                     key_set, snapshot_id: int) -> List[Dict]:
    """A live file holding a row whose ``key`` is in ``key_set`` becomes
    a deleted entry and, unless every row matched, its surviving rows an
    added file; the other files stay as existing entries."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    entries: List[Dict] = []
    for f in live:
        data = pq.read_table(f.path)
        if key not in data.column_names:
            raise ValueError(f"Key column {key!r} not in {f.path}")
        mask = pc.is_in(data.column(key), value_set=key_set.cast(
            data.schema.field(key).type))
        if not pc.any(mask).as_py():
            entries.append(_entry(STATUS_EXISTING, snapshot_id, f))
            continue
        entries.append(_entry(STATUS_DELETED, snapshot_id, f))
        survivors = data.filter(pc.invert(mask))
        if survivors.num_rows:
            entries.append(_entry(STATUS_ADDED, snapshot_id,
                                  _write_data_file(table, survivors)))
    return entries


def upsert_iceberg(data, path: str, key: str) -> int:
    """MERGE ``data`` into the table at ``path`` on column ``key``: rows
    with a matching key are replaced, the others inserted, in one
    snapshot (the table is created when it does not exist).  Returns the
    snapshot id."""
    table = IcebergTable(path)
    if not table.exists():
        return write_iceberg(data, path, mode="append")
    metadata = table.load_metadata()
    _check_append_schema(metadata, data.schema, path)
    now_ms = _next_ts(metadata)
    snapshot_id = _new_snapshot_id()
    live = table.plan_files(metadata=metadata)
    entries = _rewrite_entries(table, live, key,
                               data.column(key).combine_chunks(),
                               snapshot_id)
    entries.append(_entry(STATUS_ADDED, snapshot_id,
                          _write_data_file(table, data)))
    manifest = _write_manifest(table.table_path, entries, snapshot_id)
    _commit(table, metadata, [manifest], snapshot_id, now_ms,
            metadata.schema, metadata.properties, "overwrite",
            metadata.table_uuid)
    return snapshot_id


def delete_rows_iceberg(path: str, key: str, values) -> int:
    """DELETE the rows whose ``key`` is in ``values``, in one snapshot;
    returns its id, or the current snapshot's when no row matched (no
    commit then)."""
    import pyarrow as pa

    table = IcebergTable(path)
    metadata = table.load_metadata()
    now_ms = _next_ts(metadata)
    snapshot_id = _new_snapshot_id()
    live = table.plan_files(metadata=metadata)
    entries = _rewrite_entries(table, live, key, pa.array(list(values)),
                               snapshot_id)
    if all(e["status"] == STATUS_EXISTING for e in entries):
        return metadata.current_snapshot_id
    manifest = _write_manifest(table.table_path, entries, snapshot_id)
    _commit(table, metadata, [manifest], snapshot_id, now_ms,
            metadata.schema, metadata.properties, "delete",
            metadata.table_uuid)
    return snapshot_id
