"""User-facing index specification (counterpart of
hyperspace_tpu/index/index_config.py): name + indexed columns + included
columns, validated (non-empty name and indexed columns, no duplicate
columns across the two lists, case-insensitive)."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from hyperspace_tpu_torch.exceptions import HyperspaceError


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    index_name: str
    indexed_columns: List[str]
    included_columns: List[str] = dataclasses.field(default_factory=list)

    def __init__(self, index_name: str, indexed_columns: Sequence[str],
                 included_columns: Sequence[str] = ()) -> None:
        object.__setattr__(self, "index_name", index_name)
        object.__setattr__(self, "indexed_columns", list(indexed_columns))
        object.__setattr__(self, "included_columns", list(included_columns))
        self._validate()

    def _validate(self) -> None:
        if not self.index_name or not self.index_name.strip():
            raise HyperspaceError("Index name cannot be empty")
        if not self.indexed_columns:
            raise HyperspaceError("Indexed columns cannot be empty")
        lowered_indexed = [c.lower() for c in self.indexed_columns]
        lowered_included = [c.lower() for c in self.included_columns]
        if len(set(lowered_indexed)) != len(lowered_indexed):
            raise HyperspaceError("Duplicate indexed column names are not allowed")
        if len(set(lowered_included)) != len(lowered_included):
            raise HyperspaceError("Duplicate included column names are not allowed")
        if set(lowered_indexed) & set(lowered_included):
            raise HyperspaceError(
                "Duplicate column names in indexed/included columns are not allowed")

    @property
    def all_columns(self) -> List[str]:
        return list(self.indexed_columns) + list(self.included_columns)
