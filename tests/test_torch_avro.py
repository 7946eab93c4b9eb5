"""The port's Avro codec (io/avro.py) held to the JAX package's: the codec
cases of tests/test_iceberg.py's ``TestAvro`` (the round trip of every
type, the zigzag varint, a bad magic), files written by either package
with the same ``sync`` holding the same bytes and each read back by the
other, and the Arrow bridge (schema, table, column subset) equal."""

from __future__ import annotations

import io

import pytest

from hyperspace_tpu.io import avro as jax_avro
from hyperspace_tpu_torch.io import avro

SCHEMA = {
    "type": "record", "name": "rec",
    "fields": [
        {"name": "s", "type": "string"},
        {"name": "n", "type": "long"},
        {"name": "maybe", "type": ["null", "long"], "default": None},
        {"name": "xs", "type": {"type": "array", "items": "int"}},
        {"name": "kv", "type": {"type": "map", "values": "string"}},
        {"name": "inner", "type": {
            "type": "record", "name": "inner_rec",
            "fields": [{"name": "d", "type": "double"},
                       {"name": "b", "type": "boolean"}]}},
    ],
}
RECORDS = [
    {"s": "héllo", "n": -(2**40), "maybe": None, "xs": [1, 2, 3],
     "kv": {"a": "1"}, "inner": {"d": 2.5, "b": True}},
    {"s": "", "n": 0, "maybe": 7, "xs": [],
     "kv": {}, "inner": {"d": -0.5, "b": False}},
]
FLAT = {"type": "record", "name": "row", "fields": [
    {"name": "id", "type": "long"},
    {"name": "name", "type": "string"},
    {"name": "x", "type": ["null", "double"]},
    {"name": "f", "type": "float"},
    {"name": "raw", "type": "bytes"},
    {"name": "color", "type": {"type": "enum", "name": "c",
                               "symbols": ["red", "blue"]}}]}
FLAT_RECORDS = [{"id": i, "name": f"n{i}", "x": None if i % 3 else i / 7,
                 "f": i * 0.5, "raw": bytes([i % 256]) * 3,
                 "color": "red" if i % 2 else "blue"} for i in range(40)]
SYNC = b"0123456789abcdef"


def test_roundtrip(tmp_path):
    path = str(tmp_path / "t.avro")
    avro.write_container(path, SCHEMA, RECORDS)
    back, meta = avro.read_container_with_metadata(path)
    assert back == RECORDS
    assert "avro.schema" in meta
    assert jax_avro.read_container_with_metadata(path)[0] == RECORDS


@pytest.mark.parametrize("n", [0, -1, 1, 63, -64, 2**31, -(2**31), 2**62,
                               -(2**62)])
def test_zigzag_varint(n):
    buf = io.BytesIO()
    avro.write_long(buf, n)
    ref = io.BytesIO()
    jax_avro.write_long(ref, n)
    assert buf.getvalue() == ref.getvalue()
    buf.seek(0)
    assert avro.read_long(buf) == n


def test_bad_magic_raises(tmp_path):
    path = str(tmp_path / "bad.avro")
    with open(path, "wb") as f:
        f.write(b"nope")
    with pytest.raises(ValueError, match="container"):
        avro.read_container(path)
    with pytest.raises(ValueError, match="container"):
        avro.read_schema_only(path)


@pytest.mark.parametrize("schema, records", [(SCHEMA, RECORDS),
                                             (FLAT, FLAT_RECORDS),
                                             (FLAT, [])],
                         ids=["nested", "flat", "empty"])
def test_same_sync_same_bytes(tmp_path, schema, records):
    mine, theirs = str(tmp_path / "mine.avro"), str(tmp_path / "theirs.avro")
    avro.write_container(mine, schema, records, metadata={"k": "v"},
                         sync=SYNC)
    jax_avro.write_container(theirs, schema, records, metadata={"k": "v"},
                             sync=SYNC)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert avro.read_container(theirs) == records
    assert jax_avro.read_container(mine) == records
    assert avro.read_schema_only(mine) == jax_avro.read_schema_only(mine) \
        == schema


def test_arrow_bridge_equals_the_jax_package(tmp_path):
    path = str(tmp_path / "flat.avro")
    avro.write_container(path, FLAT, FLAT_RECORDS, sync=SYNC)
    assert avro.avro_schema_to_arrow(FLAT) == \
        jax_avro.avro_schema_to_arrow(FLAT)
    for columns in (None, ["x", "id"], ["id", "missing"], []):
        got = avro.to_arrow_table(path, columns)
        assert got.equals(jax_avro.to_arrow_table(path, columns))
    table = avro.to_arrow_table(path)
    assert table.num_rows == 40
    assert table.column("x").null_count == 26
    with pytest.raises(ValueError, match="record schema"):
        avro.avro_schema_to_arrow({"type": "array", "items": "long"})


def test_deflate_blocks_are_read(tmp_path):
    """A container whose blocks are deflated (another writer's codec)
    reads as the JAX package reads it."""
    import json
    import zlib

    body = io.BytesIO()
    resolver = avro._Resolver()
    avro._walk_register(FLAT, resolver)
    for rec in FLAT_RECORDS:
        avro._encode(body, FLAT, rec, resolver)
    packed = zlib.compressobj(wbits=-15)
    data = packed.compress(body.getvalue()) + packed.flush()
    out = io.BytesIO()
    out.write(avro.MAGIC)
    avro._encode(out, {"type": "map", "values": "bytes"},
                 {"avro.schema": json.dumps(FLAT).encode(),
                  "avro.codec": b"deflate"}, resolver)
    out.write(SYNC)
    avro.write_long(out, len(FLAT_RECORDS))
    avro.write_long(out, len(data))
    out.write(data)
    out.write(SYNC)
    path = str(tmp_path / "deflate.avro")
    with open(path, "wb") as f:
        f.write(out.getvalue())
    assert avro.read_container(path) == FLAT_RECORDS == \
        jax_avro.read_container(path)
