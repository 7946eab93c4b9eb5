"""Logical plan leaf (counterpart of hyperspace_tpu/plan/nodes.py, its
``ScanRelation``/``Scan`` subset): the one node a build reads.  The class
name ``Scan`` is part of the plan signature, so it matches the JAX
package's."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ScanRelation:
    """Where and how to read a relation's data."""

    root_paths: Tuple[str, ...]
    file_format: str = "parquet"
    options: Tuple[Tuple[str, str], ...] = ()

    @property
    def options_dict(self) -> Dict[str, str]:
        return dict(self.options)


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    def leaf_relations(self) -> List["Scan"]:
        if isinstance(self, Scan):
            return [self]
        out: List[Scan] = []
        for c in self.children:
            out.extend(c.leaf_relations())
        return out


class Scan(LogicalPlan):
    def __init__(self, relation: ScanRelation) -> None:
        self.relation = relation
        self.children = ()
