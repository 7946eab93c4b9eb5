"""The on-disk metadata model of an index (counterpart of
hyperspace_tpu/index/log_entry.py).

  - ``FileInfo``            — (name, size, mtime, id, digest)
  - ``Directory``/``Content`` — directory tree of index/source files
  - ``CoveringIndex``, ``DataSkippingIndex`` — derived-dataset specs
  - ``Signature``/``LogicalPlanFingerprint`` — validity fingerprint
  - ``Update``              — appended/deleted files a quick refresh recorded
  - ``Relation``/``Source`` — snapshot of the source relation
  - ``IndexLogEntry``       — the versioned log record
  - ``FileIdTracker``       — stable (path, size, mtime) -> id map

The JSON written by ``to_dict`` has the JAX package's shape, so either
package parses the other's log.  An index data file carries the content
digest its writer recorded (``io/integrity.py``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

from hyperspace_tpu_torch.utils.paths import is_data_file

LOG_ENTRY_VERSION = "0.1"

# The property that marks a what-if entry (advisor/hypothetical.py).
HYPOTHETICAL_PROPERTY = "hypothetical"


class States:
    ACTIVE = "ACTIVE"
    CREATING = "CREATING"
    DELETED = "DELETED"
    DELETING = "DELETING"
    REFRESHING = "REFRESHING"
    VACUUMING = "VACUUMING"
    RESTORING = "RESTORING"
    OPTIMIZING = "OPTIMIZING"
    DOESNOTEXIST = "DOESNOTEXIST"

    STABLE: FrozenSet[str] = frozenset({"ACTIVE", "DELETED", "DOESNOTEXIST"})


@dataclasses.dataclass(frozen=True)
class FileInfo:
    """One leaf file; ``id`` comes from the FileIdTracker.  ``digest`` is
    the content digest (``"<algo>:<hex>"``, io/integrity.py) recorded
    when an index data file was written; source files, and files written
    with digest on write off, carry None, which a full scrub reports as
    "unknown"."""

    name: str
    size: int
    mtime: int
    id: int = -1
    digest: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "size": self.size,
             "modifiedTime": self.mtime, "id": self.id}
        if self.digest is not None:
            # A digest-less file keeps the JSON shape it had before
            # digests existed.
            d["digest"] = self.digest
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FileInfo":
        return FileInfo(d["name"], d["size"], d["modifiedTime"],
                        d.get("id", -1), d.get("digest"))


@dataclasses.dataclass
class Directory:
    """Recursive directory node."""

    name: str
    files: List[FileInfo] = dataclasses.field(default_factory=list)
    subdirs: List["Directory"] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "files": [f.to_dict() for f in self.files],
            "subDirs": [d.to_dict() for d in self.subdirs],
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Directory":
        return Directory(
            d["name"],
            [FileInfo.from_dict(f) for f in d.get("files", [])],
            [Directory.from_dict(s) for s in d.get("subDirs", [])],
        )

    def merge(self, other: "Directory") -> "Directory":
        """Two trees rooted at the same name as one: files unioned (the
        first tree's copy kept for an equal (name, size, mtime)) and
        same-named subdirectories merged, each list sorted by name."""
        if self.name != other.name:
            raise ValueError(f"Directory merge root mismatch: {self.name!r} "
                             f"vs {other.name!r}")
        seen = {(f.name, f.size, f.mtime): f for f in self.files}
        for f in other.files:
            seen.setdefault((f.name, f.size, f.mtime), f)
        by_name = {d.name: d for d in self.subdirs}
        merged_subdirs: List[Directory] = []
        other_names = set()
        for sub in other.subdirs:
            other_names.add(sub.name)
            merged_subdirs.append(by_name[sub.name].merge(sub)
                                  if sub.name in by_name else sub)
        merged_subdirs.extend(sub for sub in self.subdirs
                              if sub.name not in other_names)
        return Directory(self.name, sorted(seen.values(), key=lambda f: f.name),
                         sorted(merged_subdirs, key=lambda d: d.name))

    @staticmethod
    def from_leaf_files(files: Sequence[FileInfo]) -> "Directory":
        """The minimal tree holding exactly ``files`` (absolute paths;
        leaves store the basename)."""
        root = Directory(name="/")
        for f in files:
            parts = [p for p in os.path.dirname(f.name).split(os.sep) if p]
            node = root
            for part in parts:
                nxt = next((d for d in node.subdirs if d.name == part), None)
                if nxt is None:
                    nxt = Directory(name=part)
                    node.subdirs.append(nxt)
                node = nxt
            node.files.append(FileInfo(os.path.basename(f.name), f.size,
                                       f.mtime, f.id, f.digest))
        return root

    @staticmethod
    def from_directory(path: str, file_id_tracker: "FileIdTracker") -> "Directory":
        """Recursively list ``path``, skipping non-data files and
        registering each leaf with the tracker.  The result is rooted at
        "/" with the full ancestor chain."""
        path = os.path.abspath(path)
        node = Directory._scan(path, file_id_tracker)
        parent = os.path.dirname(path)
        for part in reversed([p for p in parent.split(os.sep) if p]):
            node = Directory(part, [], [node])
        return Directory("/", [], [node]) if node.name != "/" else node

    @staticmethod
    def _scan(path: str, file_id_tracker: "FileIdTracker") -> "Directory":
        files: List[FileInfo] = []
        subdirs: List[Directory] = []
        if os.path.isdir(path):
            for entry in sorted(os.scandir(path), key=lambda e: e.name):
                if entry.is_dir():
                    subdirs.append(Directory._scan(entry.path, file_id_tracker))
                elif is_data_file(entry.name):
                    from hyperspace_tpu_torch.io import integrity

                    st = entry.stat()
                    fid = file_id_tracker.add_file(
                        os.path.abspath(entry.path), st.st_size, int(st.st_mtime_ns))
                    # The digest its writer recorded; a source file has
                    # none.
                    files.append(FileInfo(
                        entry.name, st.st_size, int(st.st_mtime_ns), fid,
                        integrity.recorded_digest(os.path.abspath(entry.path))))
        return Directory(os.path.basename(path) or "/", files, subdirs)


@dataclasses.dataclass
class Content:
    """A directory tree plus accessors over its leaf files."""

    root: Directory

    def to_dict(self) -> Dict[str, Any]:
        return {"root": self.root.to_dict()}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Content":
        return Content(Directory.from_dict(d["root"]))

    def files(self) -> List[str]:
        """All leaf file paths, absolute."""
        return [f.name for f in self.file_infos()]

    def file_infos(self) -> List[FileInfo]:
        """Leaf files with absolute-path names."""
        out: List[FileInfo] = []

        def walk(node: Directory, base: str) -> None:
            base = "/" if node.name == "/" else os.path.join(base, node.name)
            for f in node.files:
                out.append(FileInfo(os.path.join(base, f.name), f.size,
                                    f.mtime, f.id, f.digest))
            for sub in node.subdirs:
                walk(sub, base)

        walk(self.root, "")
        return out

    @staticmethod
    def from_directory(path: str, file_id_tracker: "FileIdTracker") -> "Content":
        return Content(Directory.from_directory(path, file_id_tracker))

    @staticmethod
    def from_leaf_files(files: Sequence[FileInfo]) -> Optional["Content"]:
        if not files:
            return None
        return Content(Directory.from_leaf_files(files))

    def merge(self, other: "Content") -> "Content":
        return Content(self.root.merge(other.root))


@dataclasses.dataclass
class CoveringIndex:
    """Data bucketed by hash of ``indexed_columns`` into ``num_buckets``
    files, sorted within buckets by the same columns, plus stored
    ``included_columns``."""

    KIND = "CoveringIndex"
    KIND_ABBR = "CI"

    indexed_columns: List[str]
    included_columns: List[str]
    num_buckets: int
    schema: Dict[str, str]  # column name -> arrow dtype string
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.KIND,
            "properties": {
                "columns": {
                    "indexed": self.indexed_columns,
                    "included": self.included_columns,
                },
                "numBuckets": self.num_buckets,
                "schema": self.schema,
                "properties": self.properties,
            },
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "CoveringIndex":
        if d.get("kind") != CoveringIndex.KIND:
            raise ValueError(f"Unknown derived dataset kind: {d.get('kind')!r}")
        p = d["properties"]
        return CoveringIndex(
            list(p["columns"]["indexed"]),
            list(p["columns"]["included"]),
            p["numBuckets"],
            dict(p["schema"]),
            dict(p.get("properties", {})),
        )

    @property
    def all_columns(self) -> List[str]:
        return self.indexed_columns + self.included_columns


@dataclasses.dataclass
class DataSkippingIndex:
    """Per-source-file sketches over ``sketched_columns``: queries keep
    scanning the source, and the rule only shrinks the file list."""

    KIND = "DataSkippingIndex"
    KIND_ABBR = "DS"

    sketched_columns: List[str]
    sketch_types: List[str]  # per column: MinMax, ValueList or BloomFilter
    schema: Dict[str, str]  # sketched column name -> arrow dtype string
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": self.KIND,
            "properties": {
                "sketches": [
                    {"column": c, "type": t}
                    for c, t in zip(self.sketched_columns, self.sketch_types)
                ],
                "schema": self.schema,
                "properties": self.properties,
            },
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DataSkippingIndex":
        p = d["properties"]
        return DataSkippingIndex(
            [s["column"] for s in p["sketches"]],
            [s["type"] for s in p["sketches"]],
            dict(p.get("schema", {})),
            dict(p.get("properties", {})),
        )

    @property
    def all_columns(self) -> List[str]:
        return list(self.sketched_columns)


_DERIVED_DATASET_KINDS = {
    CoveringIndex.KIND: CoveringIndex,
    DataSkippingIndex.KIND: DataSkippingIndex,
}


def derived_dataset_from_dict(d: Dict[str, Any]):
    cls = _DERIVED_DATASET_KINDS.get(d.get("kind"))
    if cls is None:
        raise ValueError(f"Unknown derived dataset kind: {d.get('kind')!r}")
    return cls.from_dict(d)


@dataclasses.dataclass(frozen=True)
class Signature:
    provider: str
    value: str

    def to_dict(self) -> Dict[str, Any]:
        return {"provider": self.provider, "value": self.value}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Signature":
        return Signature(d["provider"], d["value"])


@dataclasses.dataclass
class LogicalPlanFingerprint:
    """Fingerprint of the source plan at index-build time."""

    signatures: List[Signature]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "kind": "LogicalPlan",
            "properties": {"signatures": [s.to_dict() for s in self.signatures]},
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LogicalPlanFingerprint":
        return LogicalPlanFingerprint(
            [Signature.from_dict(s) for s in d["properties"]["signatures"]])


@dataclasses.dataclass
class Update:
    """The appended and deleted source files a quick refresh recorded."""

    appended_files: Optional[Content] = None
    deleted_files: Optional[Content] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "appendedFiles": self.appended_files.to_dict()
            if self.appended_files else None,
            "deletedFiles": self.deleted_files.to_dict()
            if self.deleted_files else None,
        }

    @staticmethod
    def from_dict(d: Optional[Dict[str, Any]]) -> Optional["Update"]:
        if d is None:
            return None
        return Update(
            Content.from_dict(d["appendedFiles"]) if d.get("appendedFiles") else None,
            Content.from_dict(d["deletedFiles"]) if d.get("deletedFiles") else None,
        )


@dataclasses.dataclass
class Relation:
    """Snapshot of one source relation: root paths, the file content tree
    at build time, schema, format, options, and the update a quick
    refresh recorded since."""

    root_paths: List[str]
    content: Content
    schema: Dict[str, str]
    file_format: str
    options: Dict[str, str] = dataclasses.field(default_factory=dict)
    update: Optional[Update] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rootPaths": self.root_paths,
            "data": {
                "properties": {
                    "content": self.content.to_dict(),
                    "update": self.update.to_dict() if self.update else None,
                }
            },
            "dataSchemaJson": self.schema,
            "fileFormat": self.file_format,
            "options": self.options,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Relation":
        props = d["data"]["properties"]
        return Relation(
            list(d["rootPaths"]),
            Content.from_dict(props["content"]),
            dict(d["dataSchemaJson"]),
            d["fileFormat"],
            dict(d.get("options", {})),
            Update.from_dict(props.get("update")),
        )


@dataclasses.dataclass
class Source:
    """Source plan snapshot: relations + fingerprint."""

    relations: List[Relation]
    fingerprint: LogicalPlanFingerprint

    def to_dict(self) -> Dict[str, Any]:
        return {
            "plan": {
                "properties": {
                    "relations": [r.to_dict() for r in self.relations],
                    "fingerprint": self.fingerprint.to_dict(),
                }
            }
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Source":
        p = d["plan"]["properties"]
        return Source(
            [Relation.from_dict(r) for r in p["relations"]],
            LogicalPlanFingerprint.from_dict(p["fingerprint"]),
        )


@dataclasses.dataclass
class IndexLogEntry:
    """One record in the operation log."""

    name: str
    derived_dataset: Any  # CoveringIndex or DataSkippingIndex
    content: Content
    source: Source
    properties: Dict[str, str] = dataclasses.field(default_factory=dict)
    state: str = States.DOESNOTEXIST
    id: int = 0
    timestamp: int = dataclasses.field(default_factory=lambda: int(time.time() * 1000))
    # In-memory memo tags, never serialized.
    _tags: Dict[Any, Any] = dataclasses.field(default_factory=dict, repr=False,
                                              compare=False)

    VERSION = LOG_ENTRY_VERSION

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": self.VERSION,
            "id": self.id,
            "state": self.state,
            "timestamp": self.timestamp,
            "name": self.name,
            "derivedDataset": self.derived_dataset.to_dict(),
            "content": self.content.to_dict(),
            "source": self.source.to_dict(),
            "properties": self.properties,
        }

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "IndexLogEntry":
        if d.get("version") != LOG_ENTRY_VERSION:
            raise ValueError(f"Unsupported log entry version: {d.get('version')!r}")
        return IndexLogEntry(
            name=d["name"],
            derived_dataset=derived_dataset_from_dict(d["derivedDataset"]),
            content=Content.from_dict(d["content"]),
            source=Source.from_dict(d["source"]),
            properties=dict(d.get("properties", {})),
            state=d["state"],
            id=d["id"],
            timestamp=d["timestamp"],
        )

    @property
    def indexed_columns(self) -> List[str]:
        # A data-skipping entry exposes its sketched columns here; the
        # rewrite rules filter by kind before reading these.
        if not self.is_covering:
            return list(self.derived_dataset.sketched_columns)
        return self.derived_dataset.indexed_columns

    @property
    def included_columns(self) -> List[str]:
        if not self.is_covering:
            return []
        return self.derived_dataset.included_columns

    @property
    def num_buckets(self) -> int:
        return getattr(self.derived_dataset, "num_buckets", 0)

    @property
    def is_hypothetical(self) -> bool:
        """True for the advisor's what-if entries (advisor/hypothetical.py):
        ACTIVE-looking, with no data file.  Only
        ``session.optimize(hypothetical=[...])`` plans with them; the log
        refuses to persist them and the executor to scan them."""
        return self.properties.get(HYPOTHETICAL_PROPERTY, "").lower() \
            == "true"

    @property
    def is_covering(self) -> bool:
        return isinstance(self.derived_dataset, CoveringIndex)

    @property
    def kind_abbr(self) -> str:
        return self.derived_dataset.KIND_ABBR

    @property
    def relations(self) -> List[Relation]:
        return self.source.relations

    def source_file_infos(self) -> List[FileInfo]:
        """Every source file recorded at build or refresh time."""
        out: List[FileInfo] = []
        for rel in self.relations:
            out.extend(rel.content.file_infos())
        return out

    def source_files_size(self) -> int:
        return sum(f.size for f in self.source_file_infos())

    def signature(self) -> Signature:
        """The one stored signature of the source plan."""
        sigs = self.source.fingerprint.signatures
        if len(sigs) != 1:
            raise ValueError(f"Expected exactly one signature, got {len(sigs)}")
        return sigs[0]

    def has_lineage_column(self) -> bool:
        return self.properties.get("lineage", "false").lower() == "true"

    def appended_files(self) -> List[FileInfo]:
        """The files a quick refresh recorded as appended."""
        out: List[FileInfo] = []
        for rel in self.relations:
            if rel.update and rel.update.appended_files:
                out.extend(rel.update.appended_files.file_infos())
        return out

    def deleted_files(self) -> List[FileInfo]:
        """The files a quick refresh recorded as deleted."""
        out: List[FileInfo] = []
        for rel in self.relations:
            if rel.update and rel.update.deleted_files:
                out.extend(rel.update.deleted_files.file_infos())
        return out

    def has_source_update(self) -> bool:
        """True when a quick refresh recorded appended or deleted source
        files: the index data alone is then stale."""
        return bool(self.appended_files() or self.deleted_files())

    def copy_with_update(self, fingerprint: LogicalPlanFingerprint,
                         appended: Sequence[FileInfo],
                         deleted: Sequence[FileInfo]) -> "IndexLogEntry":
        """This entry with ``appended``/``deleted`` recorded as its
        relation's update and ``fingerprint`` as its source's: the quick
        refresh, which leaves the index data as it is."""
        if len(self.relations) != 1:
            raise ValueError("copy_with_update supports single-relation sources")
        new_rel = dataclasses.replace(
            self.relations[0],
            update=Update(appended_files=Content.from_leaf_files(list(appended)),
                          deleted_files=Content.from_leaf_files(list(deleted))))
        return dataclasses.replace(self, source=Source([new_rel], fingerprint),
                                   _tags={})

    # Tags are keyed by (tag, plan node): one entry can match the
    # signature of one relation and not another's.
    def set_tag(self, key: str, value: Any, plan: Any = None) -> None:
        self._tags[(key, id(plan))] = value

    def get_tag(self, key: str, plan: Any = None) -> Optional[Any]:
        return self._tags.get((key, id(plan)))


class IndexLogEntryTags:
    SIGNATURE_MATCHED = "signatureMatched"
    IS_HYBRIDSCAN_CANDIDATE = "isHybridScanCandidate"
    COMMON_BYTES = "commonBytes"


class FileIdTracker:
    """Stable (path, size, mtime) -> id map; ids are handed out
    monotonically."""

    def __init__(self) -> None:
        self._ids: Dict[Tuple[str, int, int], int] = {}
        self._max_id = -1

    @property
    def max_id(self) -> int:
        return self._max_id

    def add_file(self, path: str, size: int, mtime: int) -> int:
        key = (path, size, mtime)
        fid = self._ids.get(key)
        if fid is None:
            self._max_id += 1
            fid = self._max_id
            self._ids[key] = fid
        return fid

    def add_file_info(self, f: FileInfo) -> None:
        """Seed from a previous entry's recorded file, keeping its id."""
        if f.id < 0:
            raise ValueError(f"FileInfo without id: {f.name}")
        key = (f.name, f.size, f.mtime)
        existing = self._ids.get(key)
        if existing is not None and existing != f.id:
            raise ValueError(f"Conflicting id for {f.name}: {existing} vs {f.id}")
        self._ids[key] = f.id
        self._max_id = max(self._max_id, f.id)

    @staticmethod
    def from_log_entry(entry: IndexLogEntry) -> "FileIdTracker":
        """A tracker holding the ids of ``entry``'s source files, so a
        refresh gives unchanged files the ids they had."""
        tracker = FileIdTracker()
        for f in entry.source_file_infos():
            tracker.add_file_info(f)
        return tracker
