"""User-facing index specifications (counterpart of
hyperspace_tpu/index/index_config.py): a covering index's name, indexed
and included columns and row layout, validated (non-empty name and
indexed columns, a known layout, at most 4 Z-order columns, no duplicate
columns across the two lists, case-insensitive), and a data-skipping
index's name, sketched columns and sketch types."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from hyperspace_tpu_torch.exceptions import HyperspaceError

LAYOUTS = ("lexicographic", "zorder")


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    index_name: str
    indexed_columns: List[str]
    included_columns: List[str] = dataclasses.field(default_factory=list)
    # Row order of the index: "lexicographic" by the indexed columns, or
    # "zorder": one bucket in Morton order of the indexed columns' ranks,
    # so per-file min/max prunes ranges on every indexed column
    # (ops/zorder.py).
    layout: str = "lexicographic"

    def __init__(self, index_name: str, indexed_columns: Sequence[str],
                 included_columns: Sequence[str] = (),
                 layout: str = "lexicographic") -> None:
        object.__setattr__(self, "index_name", index_name)
        object.__setattr__(self, "indexed_columns", list(indexed_columns))
        object.__setattr__(self, "included_columns", list(included_columns))
        object.__setattr__(self, "layout", layout)
        self._validate()

    def _validate(self) -> None:
        if not self.index_name or not self.index_name.strip():
            raise HyperspaceError("Index name cannot be empty")
        if not self.indexed_columns:
            raise HyperspaceError("Indexed columns cannot be empty")
        if self.layout not in LAYOUTS:
            raise HyperspaceError(
                f"Unknown layout {self.layout!r}; expected one of {LAYOUTS}")
        if self.layout == "zorder" and len(self.indexed_columns) > 4:
            raise HyperspaceError("Z-order supports at most 4 indexed columns")
        lowered_indexed = [c.lower() for c in self.indexed_columns]
        lowered_included = [c.lower() for c in self.included_columns]
        if len(set(lowered_indexed)) != len(lowered_indexed):
            raise HyperspaceError("Duplicate indexed column names are not allowed")
        if len(set(lowered_included)) != len(lowered_included):
            raise HyperspaceError("Duplicate included column names are not allowed")
        if set(lowered_indexed) & set(lowered_included):
            raise HyperspaceError(
                "Duplicate column names in indexed/included columns are not allowed")

    # Case-insensitive equality and hash (IndexConfig.scala:55-66): names
    # and indexed columns lowered, included columns lowered and sorted.
    # The generated dataclass pair would be case-sensitive and unhashable
    # (list fields).
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, IndexConfig):
            return NotImplemented
        return (
            self.index_name.lower() == other.index_name.lower()
            and [c.lower() for c in self.indexed_columns]
            == [c.lower() for c in other.indexed_columns]
            and sorted(c.lower() for c in self.included_columns)
            == sorted(c.lower() for c in other.included_columns)
        )

    def __hash__(self) -> int:
        return hash((
            self.index_name.lower(),
            tuple(c.lower() for c in self.indexed_columns),
            tuple(sorted(c.lower() for c in self.included_columns)),
        ))

    @property
    def all_columns(self) -> List[str]:
        return list(self.indexed_columns) + list(self.included_columns)


SKETCH_TYPES = ("MinMax", "ValueList", "BloomFilter")


@dataclasses.dataclass(frozen=True)
class DataSkippingIndexConfig:
    """A data-skipping index: per-source-file sketches over
    ``sketched_columns``; queries scan the source with fewer files.

    Sketch types, per column:
      - "MinMax" (default): the value range from the Parquet footers;
        prunes range and point predicates on clustered columns.
      - "ValueList": the distinct values when at most 64; prunes equality
        and IN on low-cardinality columns whose range spans everything.
      - "BloomFilter": an 8192-bit bloom filter over the distinct values;
        prunes equality and IN at any cardinality, with false positives
        only."""

    index_name: str
    sketched_columns: List[str]
    sketch_types: List[str] = dataclasses.field(default_factory=list)

    def __init__(self, index_name: str,
                 sketched_columns: Sequence[str],
                 sketch_types: Optional[Sequence[str]] = None) -> None:
        object.__setattr__(self, "index_name", index_name)
        object.__setattr__(self, "sketched_columns", list(sketched_columns))
        object.__setattr__(
            self, "sketch_types",
            list(sketch_types) if sketch_types is not None
            else ["MinMax"] * len(self.sketched_columns))
        self._validate()

    def _validate(self) -> None:
        if not self.index_name or not self.index_name.strip():
            raise HyperspaceError("Index name cannot be empty")
        if not self.sketched_columns:
            raise HyperspaceError("Sketched columns cannot be empty")
        lowered = [c.lower() for c in self.sketched_columns]
        if len(set(lowered)) != len(lowered):
            raise HyperspaceError("Duplicate sketched column names are not allowed")
        if len(self.sketch_types) != len(self.sketched_columns):
            raise HyperspaceError(
                "sketch_types must match sketched_columns in length")
        bad = [t for t in self.sketch_types if t not in SKETCH_TYPES]
        if bad:
            raise HyperspaceError(
                f"Unknown sketch type(s) {bad}; expected {SKETCH_TYPES}")

    # The same case-insensitive contract as IndexConfig's.
    def __eq__(self, other: object) -> bool:
        if not isinstance(other, DataSkippingIndexConfig):
            return NotImplemented
        return (self.index_name.lower() == other.index_name.lower()
                and [c.lower() for c in self.sketched_columns]
                == [c.lower() for c in other.sketched_columns]
                and self.sketch_types == other.sketch_types)

    def __hash__(self) -> int:
        return hash((self.index_name.lower(),
                     tuple(c.lower() for c in self.sketched_columns),
                     tuple(self.sketch_types)))
