"""Hive-style partition columns: ``key=value`` directory segments of a
source file's path read as columns (counterpart of
hyperspace_tpu/io/partitions.py).

Only the segments between a root path and the file name count, so the
``v__=N`` version directories of an index and whatever lies outside the
roots never become columns.  A key's type is inferred over the whole
directory tree below the roots (``partition_spec_for_roots``), never over
the files one call reads: int64 when every value parses as an integer,
else string, so that ``k=1`` and ``k=x`` read as one type in every scan,
build chunk and hybrid subset.  ``__HIVE_DEFAULT_PARTITION__`` reads as
null.

pyarrow is imported when a function runs, never when the module is
imported.
"""

from __future__ import annotations

import os
import urllib.parse
from typing import Dict, List, Optional, Sequence

HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _relative_segments(path: str, roots: Sequence[str]) -> List[str]:
    path = os.path.abspath(path)
    for root in roots:
        root = os.path.abspath(root).rstrip("/")
        if path.startswith(root + "/"):
            rel = path[len(root) + 1:]
            return rel.split("/")[:-1]  # the directories, not the file
    return []


def partition_values(path: str, roots: Sequence[str]) -> Dict[str, Optional[str]]:
    """The raw (string or null) partition values in ``path`` below the
    first of ``roots`` that holds it."""
    out: Dict[str, Optional[str]] = {}
    for seg in _relative_segments(path, roots):
        if "=" not in seg:
            continue
        key, _, value = seg.partition("=")
        if not key:
            continue
        value = urllib.parse.unquote(value)
        out[key] = None if value == HIVE_NULL else value
    return out


def _is_int(v: str) -> bool:
    try:
        int(v)
        return True
    except ValueError:
        return False


def _infer_types(values_by_key: Dict[str, List[Optional[str]]]) -> Dict[str, str]:
    spec: Dict[str, str] = {}
    for k, vals in values_by_key.items():
        non_null = [v for v in vals if v is not None]
        spec[k] = "int64" if non_null and all(_is_int(v) for v in non_null) \
            else "string"
    return spec


def partition_spec_for_roots(roots: Sequence[str]) -> Dict[str, str]:
    """Partition column -> arrow type name, inferred from the directory
    tree under ``roots`` (globs expanded); empty when the layout is not
    partitioned."""
    from hyperspace_tpu_torch.io.files import expand_globs

    values_by_key: Dict[str, List[Optional[str]]] = {}

    def walk(d: str) -> None:
        try:
            entries = sorted(os.listdir(d))
        except OSError:
            return
        for name in entries:
            child = os.path.join(d, name)
            if not os.path.isdir(child) or os.path.islink(child):
                continue
            if "=" in name:
                key, _, value = name.partition("=")
                if key:
                    value = urllib.parse.unquote(value)
                    values_by_key.setdefault(key, []).append(
                        None if value == HIVE_NULL else value)
            walk(child)

    for root in expand_globs(roots):
        if os.path.isdir(root):
            walk(os.path.abspath(root))
    return _infer_types(values_by_key)


def typed_value(raw: Optional[str], arrow_type: str):
    """A raw path value as the spec's type (None stays None)."""
    if raw is None:
        return None
    return int(raw) if arrow_type == "int64" else raw


def attach_partition_columns(table, path: str, roots: Sequence[str],
                             spec: Dict[str, str],
                             columns: Optional[Sequence[str]] = None):
    """``table`` (the rows of the file ``path``) with the file's partition
    values appended as constant columns, only those in ``columns`` when
    a projection was pushed down.  A column the file holds wins over the
    path value."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io.parquet import _dtype_from_string

    raw = partition_values(path, roots)
    wanted = None if columns is None else set(columns)
    for key, arrow_type in spec.items():
        if key in table.column_names:
            continue
        if wanted is not None and key not in wanted:
            continue
        value = typed_value(raw.get(key), arrow_type)
        table = table.append_column(
            key, pa.array([value] * table.num_rows,
                          type=_dtype_from_string(arrow_type)))
    return table
