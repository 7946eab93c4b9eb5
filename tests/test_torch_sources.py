"""The source-provider plug-in through the port, held to the JAX package:
``io/schemas.py``'s type tables and fallbacks, function by function over
every type; the manager's exactly-one dispatch and its errors for no
answer and for two; the default providers (``default,delta,iceberg``
in both) and ``conf.source_providers`` naming a provider not registered;
and
``FileBasedRelation._select_closest_version``, the index version a
versioned source's read picks, in its floor, exact, before-first and
diff-bytes cases."""

from __future__ import annotations

import dataclasses
import importlib

import pyarrow as pa
import pytest

import hyperspace_tpu
import hyperspace_tpu_torch

JAX, TORCH = hyperspace_tpu, hyperspace_tpu_torch
PKGS = (JAX, TORCH)


def _mod(pkg, module: str):
    return importlib.import_module(f"{pkg.__name__}.{module}")


def _schemas():
    return [_mod(pkg, "io.schemas") for pkg in PKGS]


# ---------------------------------------------------------------------------
# io/schemas.py
# ---------------------------------------------------------------------------
_JAX_SCHEMAS = importlib.import_module("hyperspace_tpu.io.schemas")
_ARROW_TYPES = sorted(set(_JAX_SCHEMAS._ARROW_TO_SPARK)
                      | set(_JAX_SCHEMAS._ARROW_TO_ICEBERG)) + [
    "timestamp[us]", "timestamp[ns, tz=UTC]", "decimal128(10, 2)",
    "decimal128(38,0)", "list<item: int64>", "null", "uint8"]
_SPARK_TYPES = sorted(_JAX_SCHEMAS._SPARK_TO_ARROW) + [
    "timestamp", "decimal(12,3)", "decimal(5, 1)", "short_decimal",
    {"type": "array", "elementType": "long"}, None]
_ICEBERG_TYPES = sorted(_JAX_SCHEMAS._ICEBERG_TO_ARROW) + [
    "decimal(9, 2)", "decimal(38,10)", "uuid", {"type": "list"}, None]


def test_the_type_tables_equal_the_jax_package():
    jax_s, torch_s = _schemas()
    for table in ("_ARROW_TO_SPARK", "_SPARK_TO_ARROW", "_ARROW_TO_ICEBERG",
                  "_ICEBERG_TO_ARROW"):
        assert getattr(torch_s, table) == getattr(jax_s, table), table


@pytest.mark.parametrize("arrow_type", _ARROW_TYPES)
def test_arrow_types_map_as_in_the_jax_package(arrow_type):
    jax_s, torch_s = _schemas()
    assert torch_s.arrow_type_to_spark(arrow_type) \
        == jax_s.arrow_type_to_spark(arrow_type)
    assert torch_s.arrow_type_to_iceberg(arrow_type) \
        == jax_s.arrow_type_to_iceberg(arrow_type)


@pytest.mark.parametrize("spark_type", _SPARK_TYPES, ids=repr)
def test_spark_types_map_as_in_the_jax_package(spark_type):
    jax_s, torch_s = _schemas()
    assert torch_s.spark_type_to_arrow(spark_type) \
        == jax_s.spark_type_to_arrow(spark_type)


@pytest.mark.parametrize("iceberg_type", _ICEBERG_TYPES, ids=repr)
def test_iceberg_types_map_as_in_the_jax_package(iceberg_type):
    jax_s, torch_s = _schemas()
    assert torch_s.iceberg_type_to_arrow(iceberg_type) \
        == jax_s.iceberg_type_to_arrow(iceberg_type)


def test_the_fallbacks():
    _, torch_s = _schemas()
    assert torch_s.arrow_type_to_spark("timestamp[ns, tz=UTC]") == "timestamp"
    assert torch_s.arrow_type_to_spark("decimal128(10, 2)") == "decimal(10,2)"
    assert torch_s.arrow_type_to_iceberg("list<item: int64>") == "string"
    assert torch_s.spark_type_to_arrow("decimal(12,3)") \
        == "decimal128(12, 3)"
    assert torch_s.spark_type_to_arrow({"type": "struct"}) == "string"
    assert torch_s.iceberg_type_to_arrow("timestamptz") \
        == "timestamp[us, tz=UTC]"


def test_schemas_round_trip_as_in_the_jax_package():
    schema = pa.schema([
        ("b", pa.bool_()), ("i8", pa.int8()), ("i16", pa.int16()),
        ("i32", pa.int32()), ("i64", pa.int64()), ("f", pa.float32()),
        ("d", pa.float64()), ("s", pa.string()), ("ls", pa.large_string()),
        ("day", pa.date32()), ("bin", pa.binary()),
        ("ts", pa.timestamp("us")), ("tz", pa.timestamp("ms", tz="UTC")),
        ("dec", pa.decimal128(12, 4)), ("l", pa.list_(pa.int64()))])
    jax_s, torch_s = _schemas()
    spark = torch_s.spark_schema_string(schema)
    assert spark == jax_s.spark_schema_string(schema)
    assert torch_s.arrow_schema_from_spark(spark) \
        == jax_s.arrow_schema_from_spark(spark)
    iceberg = torch_s.iceberg_schema(schema)
    assert iceberg == jax_s.iceberg_schema(schema)
    assert torch_s.arrow_schema_from_iceberg(iceberg) \
        == jax_s.arrow_schema_from_iceberg(iceberg)
    assert torch_s.arrow_schema_from_spark(spark)["day"] == "date32[day]"


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------
def _fake_provider(pkg, name: str, answer):
    """A provider class named ``name`` owning the format "fake"; its
    relation is ``answer`` (a string)."""
    base = _mod(pkg, "sources.interfaces").FileBasedSourceProvider

    def owns(fmt: str) -> bool:
        return fmt == "fake"

    class Fake(base):
        def __init__(self, conf) -> None:
            self.conf = conf

        def is_supported_relation(self, scan):
            return True if owns(scan.relation.file_format) else None

        def get_relation(self, scan):
            return answer if owns(scan.relation.file_format) else None

        def internal_file_format_name(self, relation):
            return "parquet" if owns(relation.file_format) else None

        def refresh_relation_metadata(self, relation):
            return relation if owns(relation.file_format) else None

        def enrich_index_properties(self, relation, properties):
            return {**properties, name: "1"} \
                if owns(relation.file_format) else None

    Fake.name = name
    return Fake


@pytest.fixture
def fakes(monkeypatch):
    """Both packages' registries with ``fake_a`` and ``fake_b``, which
    answer for the format "fake"."""
    for pkg in PKGS:
        registry = _mod(pkg, "sources.manager").PROVIDER_REGISTRY
        for name in ("fake_a", "fake_b"):
            monkeypatch.setitem(registry, name,
                                _fake_provider(pkg, name, f"{name} relation"))


def _manager(pkg, providers: str):
    conf = pkg.HyperspaceConf()
    conf.source_providers = providers
    return _mod(pkg, "sources.manager").FileBasedSourceProviderManager(conf)


def _scan(pkg, fmt: str):
    nodes = _mod(pkg, "plan.nodes")
    return nodes.Scan(nodes.ScanRelation(root_paths=("/x",), file_format=fmt,
                                         options=()))


def _relation(pkg, fmt: str, **options):
    log_entry = _mod(pkg, "index.log_entry")
    return log_entry.Relation(["/x"], None, {}, fmt, dict(options))


def test_exactly_one_provider_answers(fakes):
    for pkg in PKGS:
        m = _manager(pkg, "default,delta,fake_a")
        assert m.get_relation(_scan(pkg, "fake")) == "fake_a relation"
        assert m.is_supported_relation(_scan(pkg, "fake"))
        assert m.is_supported_relation(_scan(pkg, "delta"))
        assert m.internal_file_format_name(_relation(pkg, "fake")) \
            == "parquet"
        assert m.internal_file_format_name(_relation(pkg, "delta")) \
            == "parquet"
        assert m.internal_file_format_name(_relation(pkg, "csv")) == "csv"
        assert m.enrich_index_properties(_relation(pkg, "fake"),
                                         {"k": "v"}) == {"k": "v",
                                                         "fake_a": "1"}
        rel = _relation(pkg, "delta", versionAsOf="3", timestampAsOf="9",
                        keep="1")
        assert m.refresh_relation_metadata(rel).options == {"keep": "1"}


@pytest.mark.parametrize("providers, match", [
    ("default,delta", "No source provider answered get_relation"),
    ("default,fake_a,fake_b",
     r"Multiple source providers answered get_relation: "
     r"\['fake_a', 'fake_b'\]"),
], ids=["none", "two"])
def test_no_answer_or_two_answers_raise(fakes, providers, match):
    for pkg in PKGS:
        m = _manager(pkg, providers)
        with pytest.raises(_mod(pkg, "exceptions").HyperspaceError,
                           match=match):
            m.get_relation(_scan(pkg, "fake"))
        assert m.is_supported_relation(_scan(pkg, "fake")) is False
        with pytest.raises(_mod(pkg, "exceptions").HyperspaceError,
                           match=match.replace("get_relation",
                                               "refresh_relation_metadata")):
            m.refresh_relation_metadata(_relation(pkg, "fake"))


def test_the_default_providers():
    for pkg in PKGS:
        assert pkg.HyperspaceConf().source_providers \
            == "default,delta,iceberg"
        registry = _mod(pkg, "sources.manager").PROVIDER_REGISTRY
        _manager(pkg, "default,delta,iceberg")
        assert {"default", "delta", "iceberg"} <= set(registry)


@pytest.mark.parametrize("providers, unknown", [
    ("default,delta,iceberg,nope", ["nope"]),
    ("iceberg,other", ["other"]),
    ("default,nope", ["nope"]),
    ("nope, delta ,other", ["nope", "other"]),
])
def test_an_unregistered_provider_raises(providers, unknown):
    """A name not in the registry raises, in both packages alike, when
    the manager is made, and a session's first read raises it."""
    from hyperspace_tpu_torch import HyperspaceSession
    from hyperspace_tpu_torch.exceptions import HyperspaceError

    with pytest.raises(HyperspaceError,
                       match=r"Unknown source providers: "
                             + repr(unknown).replace("[", r"\[")):
        _manager(TORCH, providers)
    s = HyperspaceSession("/unused", device="cpu")
    s.conf.source_providers = providers
    with pytest.raises(HyperspaceError, match="Unknown source providers"):
        s.read.parquet("/unused").columns
    with pytest.raises(_mod(JAX, "exceptions").HyperspaceError,
                       match=r"Unknown source providers: "
                             + repr(unknown).replace("[", r"\[")):
        _manager(JAX, providers)


# ---------------------------------------------------------------------------
# _select_closest_version
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class _File:
    name: str
    size: int
    mtime: int


class _Entry:
    def __init__(self, name: str, log_version: int, files) -> None:
        self.name = name
        self.log_version = log_version
        self._files = list(files)

    def source_file_infos(self):
        return self._files

    def source_files_size(self) -> int:
        return sum(f.size for f in self._files)


class _Manager:
    def __init__(self, entries) -> None:
        self._entries = entries

    def get_index(self, name, version=None):
        return self._entries.get(version)


class _Session:
    def __init__(self, entries) -> None:
        self.index_collection_manager = _Manager(entries)


def _files(*specs):
    return [_File(f"/t/{n}", size, 1) for n, size in specs]


# Index log version -> the files it recorded, at delta versions 1, 3, 5.
_HISTORY = [(2, 1), (4, 3), (6, 5)]
_RECORDED = {2: _files(("a", 100)),
             4: _files(("a", 100), ("b", 100), ("c", 100)),
             6: _files(("a", 100), ("b", 100), ("c", 100), ("d", 100))}


@pytest.mark.parametrize("current_pos, files, missing, want", [
    (7, _files(("a", 100)), (), "latest"),        # past the newest
    (5, _files(("a", 100)), (), "latest"),        # at the newest
    (0, _files(("a", 100)), (), 2),               # before the first
    (3, _files(("a", 100)), (), 4),               # exact
    (1, _files(("a", 100)), (), 2),               # exact, the first
    # Between 1 and 3: a, b differ from v2's file set by 100 bytes and
    # from v4's by 100 too: a tie goes to the later.
    (2, _files(("a", 100), ("b", 100)), (), 4),
    # a alone and a large new file: closer to v2 (x: 500 against 700).
    (2, _files(("a", 100), ("x", 500)), (), 2),
    # a to d and a small new file: closer to v6 (10 against 110).
    (4, _files(("a", 100), ("b", 100), ("c", 100), ("d", 100),
               ("e", 10)), (), 6),
    (4, _files(("a", 100), ("b", 100), ("c", 100)), (), 4),
    (0, _files(("a", 100)), (2,), "latest"),      # before, v2 unreadable
    (2, _files(("a", 100)), (2,), 4),             # between, one missing
    (2, _files(("a", 100)), (2, 4), "latest"),    # between, both missing
], ids=["past", "at-newest", "before-first", "exact", "exact-first",
        "diff-tie", "diff-prev", "diff-next", "diff-next-equal",
        "before-missing", "between-one-missing", "between-both-missing"])
def test_select_closest_version(current_pos, files, missing, want):
    """The floor, exact, before-first and diff-bytes choices, and a
    version whose entry cannot be read, equal in both packages."""
    got = {}
    for pkg in PKGS:
        base = _mod(pkg, "sources.interfaces").FileBasedRelation

        class Rel(base):
            def all_files(self, tracker=None):
                return files

        latest = _Entry("ix", 8, _RECORDED[6])
        entries = {v: _Entry("ix", v, f) for v, f in _RECORDED.items()
                   if v not in missing}
        rel = Rel(_scan(pkg, "fake"))
        chosen = rel._select_closest_version(latest, _Session(entries),
                                             _HISTORY, current_pos)
        got[pkg.__name__] = "latest" if chosen is latest \
            else chosen.log_version
        assert rel.closest_index(latest) is latest  # no versions: itself
        assert rel._select_closest_version(latest, None, _HISTORY,
                                           current_pos) is latest
        assert rel._select_closest_version(latest, _Session(entries), [],
                                           current_pos) is latest
    assert got["hyperspace_tpu_torch"] == got["hyperspace_tpu"] == want
