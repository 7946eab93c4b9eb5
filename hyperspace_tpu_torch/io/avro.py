"""A minimal Avro object container codec, read and write (counterpart
of hyperspace_tpu/io/avro.py): the default source's ``avro`` format
reads data files through it, and no Avro library is needed.

It covers null, boolean, int, long, float, double, bytes, string, fixed,
enum, record, array, map and unions.  Files are written with the null
codec and read with the null or deflate codec.  A container is the magic
``Obj\\x01``, the file metadata map (``avro.schema``, ``avro.codec``), a
16-byte sync marker, then blocks of (record count, byte size, records,
sync).  Ints and longs are zigzag varints, bytes and strings carry their
length first, floats are IEEE little-endian, arrays and maps come in
blocks, and a union value starts with its branch index.  Given the same
``sync``, ``write_container`` writes the same bytes as the JAX package's.

pyarrow is imported when an Arrow function runs, never when the module
is imported.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import Any, Dict, Iterable, List, Optional, Union

Schema = Union[str, Dict[str, Any], List[Any]]

MAGIC = b"Obj\x01"

_PRIMITIVES = {"null", "boolean", "int", "long", "float", "double", "bytes",
               "string"}


# ---------------------------------------------------------------------------
# Binary encoding
# ---------------------------------------------------------------------------
def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(buf: io.BytesIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def read_long(buf: io.BytesIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("Truncated Avro varint")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7


class _Resolver:
    """Named-type registry so records/fixeds can be referenced by name."""

    def __init__(self) -> None:
        self.named: Dict[str, Schema] = {}

    def register(self, schema: Dict[str, Any]) -> None:
        name = schema.get("name")
        if name:
            ns = schema.get("namespace")
            self.named[name] = schema
            if ns:
                self.named[f"{ns}.{name}"] = schema

    def resolve(self, schema: Schema) -> Schema:
        if isinstance(schema, str) and schema not in _PRIMITIVES:
            if schema not in self.named:
                raise ValueError(f"Unknown Avro type name: {schema}")
            return self.named[schema]
        return schema


def _walk_register(schema: Schema, resolver: _Resolver) -> None:
    if isinstance(schema, dict):
        if schema.get("type") in ("record", "fixed", "enum"):
            resolver.register(schema)
        if schema.get("type") == "record":
            for f in schema.get("fields", []):
                _walk_register(f["type"], resolver)
        elif schema.get("type") == "array":
            _walk_register(schema["items"], resolver)
        elif schema.get("type") == "map":
            _walk_register(schema["values"], resolver)
    elif isinstance(schema, list):
        for s in schema:
            _walk_register(s, resolver)


def _encode(buf: io.BytesIO, schema: Schema, value: Any,
            resolver: _Resolver) -> None:
    schema = resolver.resolve(schema)
    if isinstance(schema, list):  # union: pick the first matching branch
        idx = _union_index(schema, value, resolver)
        write_long(buf, idx)
        _encode(buf, schema[idx], value, resolver)
        return
    t = schema["type"] if isinstance(schema, dict) else schema
    if isinstance(t, (dict, list)):  # {"type": {...nested...}}
        _encode(buf, t, value, resolver)
        return
    if t == "null":
        return
    if t == "boolean":
        buf.write(b"\x01" if value else b"\x00")
    elif t in ("int", "long"):
        write_long(buf, int(value))
    elif t == "float":
        buf.write(struct.pack("<f", float(value)))
    elif t == "double":
        buf.write(struct.pack("<d", float(value)))
    elif t == "bytes":
        data = bytes(value)
        write_long(buf, len(data))
        buf.write(data)
    elif t == "string":
        data = str(value).encode("utf-8")
        write_long(buf, len(data))
        buf.write(data)
    elif t == "fixed":
        data = bytes(value)
        if len(data) != schema["size"]:
            raise ValueError(f"fixed size mismatch: {len(data)} != {schema['size']}")
        buf.write(data)
    elif t == "enum":
        write_long(buf, schema["symbols"].index(value))
    elif t == "record":
        for f in schema["fields"]:
            if f["name"] in value:
                field_value = value[f["name"]]
            elif "default" in f:
                field_value = f["default"]
            else:
                raise ValueError(f"Missing field {f['name']} for record "
                                 f"{schema.get('name')}")
            _encode(buf, f["type"], field_value, resolver)
    elif t == "array":
        items = list(value)
        if items:
            write_long(buf, len(items))
            for item in items:
                _encode(buf, schema["items"], item, resolver)
        write_long(buf, 0)
    elif t == "map":
        entries = dict(value)
        if entries:
            write_long(buf, len(entries))
            for k, v in entries.items():
                _encode(buf, "string", k, resolver)
                _encode(buf, schema["values"], v, resolver)
        write_long(buf, 0)
    else:
        raise ValueError(f"Unsupported Avro type: {t}")


def _union_index(union: List[Any], value: Any, resolver: _Resolver) -> int:
    def kind(s: Schema) -> str:
        s = resolver.resolve(s)
        return s["type"] if isinstance(s, dict) else s

    for i, branch in enumerate(union):
        k = kind(branch)
        if value is None and k == "null":
            return i
        if value is None:
            continue
        if k == "null":
            continue
        if k == "boolean" and isinstance(value, bool):
            return i
        if k in ("int", "long") and isinstance(value, int) and not isinstance(value, bool):
            return i
        if k in ("float", "double") and isinstance(value, float):
            return i
        if k == "string" and isinstance(value, str):
            return i
        if k in ("bytes", "fixed") and isinstance(value, (bytes, bytearray)):
            return i
        if k == "record" and isinstance(value, dict):
            return i
        if k == "array" and isinstance(value, (list, tuple)):
            return i
        if k == "map" and isinstance(value, dict):
            return i
    raise ValueError(f"Value {value!r} matches no branch of union {union}")


def _decode(buf: io.BytesIO, schema: Schema, resolver: _Resolver) -> Any:
    schema = resolver.resolve(schema)
    if isinstance(schema, list):
        idx = read_long(buf)
        return _decode(buf, schema[idx], resolver)
    t = schema["type"] if isinstance(schema, dict) else schema
    if isinstance(t, (dict, list)):
        return _decode(buf, t, resolver)
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return buf.read(read_long(buf))
    if t == "string":
        return buf.read(read_long(buf)).decode("utf-8")
    if t == "fixed":
        return buf.read(schema["size"])
    if t == "enum":
        return schema["symbols"][read_long(buf)]
    if t == "record":
        return {f["name"]: _decode(buf, f["type"], resolver)
                for f in schema["fields"]}
    if t == "array":
        out: List[Any] = []
        while True:
            count = read_long(buf)
            if count == 0:
                return out
            if count < 0:  # block size follows; we don't need it
                read_long(buf)
                count = -count
            for _ in range(count):
                out.append(_decode(buf, schema["items"], resolver))
    if t == "map":
        entries: Dict[str, Any] = {}
        while True:
            count = read_long(buf)
            if count == 0:
                return entries
            if count < 0:
                read_long(buf)
                count = -count
            for _ in range(count):
                k = _decode(buf, "string", resolver)
                entries[k] = _decode(buf, schema["values"], resolver)
    raise ValueError(f"Unsupported Avro type: {t}")


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------
def write_container(path: str, schema: Schema, records: Iterable[Dict[str, Any]],
                    metadata: Optional[Dict[str, str]] = None,
                    sync: Optional[bytes] = None) -> None:
    resolver = _Resolver()
    _walk_register(schema, resolver)
    sync = sync or os.urandom(16)
    meta: Dict[str, Any] = {"avro.schema": json.dumps(schema),
                            "avro.codec": "null"}
    for k, v in (metadata or {}).items():
        meta[k] = v

    body = io.BytesIO()
    count = 0
    for rec in records:
        _encode(body, schema, rec, resolver)
        count += 1

    buf = io.BytesIO()
    buf.write(MAGIC)
    meta_schema = {"type": "map", "values": "bytes"}
    _encode(buf, meta_schema, {k: (v.encode() if isinstance(v, str) else v)
                               for k, v in meta.items()}, resolver)
    buf.write(sync)
    if count:
        data = body.getvalue()
        write_long(buf, count)
        write_long(buf, len(data))
        buf.write(data)
        buf.write(sync)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def read_container(path: str) -> List[Dict[str, Any]]:
    records, _ = read_container_with_metadata(path)
    return records


def _read_header(buf, path: str) -> Dict[str, Any]:
    """Decode the container header (magic + file-metadata map), leaving the
    stream positioned at the 16-byte sync marker.  Keys normalized to str,
    values left as bytes.  Works on any .read()-able stream."""
    if buf.read(4) != MAGIC:
        raise ValueError(f"Not an Avro object container file: {path}")
    meta = _decode(buf, {"type": "map", "values": "bytes"}, _Resolver())
    return {(k.decode() if isinstance(k, bytes) else k): v
            for k, v in meta.items()}


def read_container_with_metadata(path: str):
    with open(path, "rb") as f:
        buf = io.BytesIO(f.read())
    meta = _read_header(buf, path)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate"):
        raise ValueError(f"Unsupported Avro codec: {codec}")
    resolver = _Resolver()
    _walk_register(schema, resolver)
    sync = buf.read(16)
    out: List[Dict[str, Any]] = []
    while True:
        try:
            count = read_long(buf)
        except EOFError:
            break
        size = read_long(buf)
        data = buf.read(size)
        if codec == "deflate":
            data = zlib.decompress(data, -15)
        block = io.BytesIO(data)
        for _ in range(count):
            out.append(_decode(block, schema, resolver))
        marker = buf.read(16)
        if marker != sync:
            raise ValueError(f"Avro sync marker mismatch in {path}")
    return out, meta


# ---------------------------------------------------------------------------
# Arrow bridge (Avro as a default-source DATA format)
# ---------------------------------------------------------------------------
# The default source reads Avro data files beside csv, json, orc, parquet
# and text; these helpers turn a container into an arrow Table.

def avro_schema_to_arrow(schema: Schema):
    """Arrow schema for a top-level Avro record schema."""
    import pyarrow as pa

    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        raise ValueError(f"Avro data files must carry a record schema, "
                         f"got: {schema!r}")
    return pa.schema([(f["name"], _avro_type_to_arrow(f["type"]))
                      for f in schema["fields"]])


def _avro_type_to_arrow(t: Schema):
    import pyarrow as pa

    prims = {"null": pa.null(), "boolean": pa.bool_(), "int": pa.int32(),
             "long": pa.int64(), "float": pa.float32(),
             "double": pa.float64(), "bytes": pa.binary(),
             "string": pa.string()}
    if isinstance(t, str):
        if t in prims:
            return prims[t]
        raise ValueError(f"Unsupported Avro type for Arrow: {t!r}")
    if isinstance(t, list):  # union: ["null", X] → nullable X
        non_null = [x for x in t if x != "null"]
        if len(non_null) == 1:
            return _avro_type_to_arrow(non_null[0])
        raise ValueError(f"Unsupported Avro union for Arrow: {t!r}")
    if isinstance(t, dict):
        kind = t.get("type")
        if kind == "array":
            return pa.list_(_avro_type_to_arrow(t["items"]))
        if kind == "map":
            return pa.map_(pa.string(), _avro_type_to_arrow(t["values"]))
        if kind == "fixed":
            return pa.binary(int(t["size"]))
        if kind == "enum":
            return pa.string()
        if kind == "record":
            return pa.struct([(f["name"], _avro_type_to_arrow(f["type"]))
                              for f in t["fields"]])
        if kind in prims:  # {"type": "long", ...} annotated primitive
            return prims[kind]
    raise ValueError(f"Unsupported Avro type for Arrow: {t!r}")


def read_schema_only(path: str) -> Schema:
    """The writer schema from a container file's header (no record decode —
    read_schema must stay cheap for large data files)."""
    with open(path, "rb") as f:
        meta = _read_header(f, path)
    return json.loads(meta["avro.schema"].decode("utf-8"))


def to_arrow_table(path: str, columns=None):
    """Decode a container file into an arrow Table (column subset honored
    after decode; the row-oriented format has no column projection)."""
    import pyarrow as pa

    records, meta = read_container_with_metadata(path)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    table = pa.Table.from_pylist(records, schema=avro_schema_to_arrow(schema))
    if columns is not None:
        table = table.select([c for c in columns if c in table.column_names])
    return table
