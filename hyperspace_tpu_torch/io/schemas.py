"""Schema vocabularies (counterpart of hyperspace_tpu/io/schemas.py):
arrow type strings, Spark's StructType JSON and Iceberg's schema JSON.

The engine's own vocabulary is arrow type strings (io/columnar.py).  A
Delta table's ``metaData.schemaString`` is Spark StructType JSON, and an
Iceberg table's schema is its JSON with field ids; the writers and
readers of both lake formats map through the tables here, with one
fallback for timestamps and decimals.  pyarrow is never imported: a
schema argument is anything that iterates fields with ``name`` and
``type``.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict

_ARROW_TO_SPARK = {
    "int8": "byte",
    "int16": "short",
    "int32": "integer",
    "int64": "long",
    "float": "float",
    "double": "double",
    "bool": "boolean",
    "string": "string",
    "large_string": "string",
    "date32[day]": "date",
    "binary": "binary",
}

_SPARK_TO_ARROW = {v: k for k, v in _ARROW_TO_SPARK.items() if v != "string"}
_SPARK_TO_ARROW["string"] = "string"

_ARROW_TO_ICEBERG = {
    "bool": "boolean",
    "int8": "int",
    "int16": "int",
    "int32": "int",
    "int64": "long",
    "float": "float",
    "double": "double",
    "string": "string",
    "large_string": "string",
    "date32[day]": "date",
    "binary": "binary",
}

_ICEBERG_TO_ARROW = {
    "boolean": "bool",
    "int": "int32",
    "long": "int64",
    "float": "float",
    "double": "double",
    "date": "date32[day]",
    "string": "string",
    "binary": "binary",
    "timestamp": "timestamp[us]",
    "timestamptz": "timestamp[us, tz=UTC]",
}

_DECIMAL_ARROW_RE = re.compile(r"^decimal128\((\d+),\s*(\d+)\)$")
_DECIMAL_RE = re.compile(r"^decimal\((\d+),\s*(\d+)\)$")


def _arrow_fallback(arrow_type: str, decimal_fmt: str) -> str:
    """An arrow type no table names: any timestamp, a decimal, else
    string."""
    if arrow_type.startswith("timestamp"):
        return "timestamp"
    m = _DECIMAL_ARROW_RE.match(arrow_type)
    if m:
        return decimal_fmt.format(p=m.group(1), s=m.group(2))
    return "string"


def arrow_type_to_spark(arrow_type: str) -> str:
    t = _ARROW_TO_SPARK.get(arrow_type)
    return t if t is not None else _arrow_fallback(arrow_type,
                                                   "decimal({p},{s})")


def spark_type_to_arrow(spark_type: Any) -> str:
    """A nested Spark type (a dict) reads as string."""
    if not isinstance(spark_type, str):
        return "string"
    if spark_type == "timestamp":
        return "timestamp[us]"
    m = _DECIMAL_RE.match(spark_type)
    if m:
        return f"decimal128({m.group(1)}, {m.group(2)})"
    return _SPARK_TO_ARROW.get(spark_type, "string")


def arrow_type_to_iceberg(arrow_type: str) -> str:
    t = _ARROW_TO_ICEBERG.get(arrow_type)
    return t if t is not None else _arrow_fallback(arrow_type,
                                                   "decimal({p},{s})")


def iceberg_type_to_arrow(iceberg_type: Any) -> str:
    if isinstance(iceberg_type, str):
        if iceberg_type in _ICEBERG_TO_ARROW:
            return _ICEBERG_TO_ARROW[iceberg_type]
        m = _DECIMAL_RE.match(iceberg_type)
        if m:
            return f"decimal128({m.group(1)}, {m.group(2)})"
    return "string"


def spark_schema_string(schema) -> str:
    """An arrow schema as Spark StructType JSON, the
    ``metaData.schemaString`` every Delta reader expects."""
    fields = [{"name": f.name, "type": arrow_type_to_spark(str(f.type)),
               "nullable": True, "metadata": {}} for f in schema]
    return json.dumps({"type": "struct", "fields": fields})


def arrow_schema_from_spark(schema_string: str) -> Dict[str, str]:
    """Spark StructType JSON as a name -> arrow type string dict."""
    parsed = json.loads(schema_string)
    return {f["name"]: spark_type_to_arrow(f["type"])
            for f in parsed.get("fields", [])}


def iceberg_schema(schema) -> Dict[str, Any]:
    """An arrow schema as Iceberg schema JSON, field ids from 1."""
    fields = [{"id": i, "name": f.name, "required": False,
               "type": arrow_type_to_iceberg(str(f.type))}
              for i, f in enumerate(schema, start=1)]
    return {"type": "struct", "schema-id": 0, "fields": fields}


def arrow_schema_from_iceberg(schema: Dict[str, Any]) -> Dict[str, str]:
    """Iceberg schema JSON as a name -> arrow type string dict."""
    return {f["name"]: iceberg_type_to_arrow(f.get("type"))
            for f in schema.get("fields", [])}
