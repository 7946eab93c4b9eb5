"""Case-insensitive column-name resolution (counterpart of
hyperspace_tpu/utils/resolver.py): requested names resolve against a
schema and come back in the schema's own spelling."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence


def resolve(requested: Sequence[str], available: Iterable[str]) -> Optional[List[str]]:
    """Resolve all of ``requested`` against ``available``; None if any
    fails."""
    lookup: Dict[str, str] = {}
    for name in available:
        lookup.setdefault(name.lower(), name)
    out: List[str] = []
    for name in requested:
        hit = lookup.get(name.lower())
        if hit is None:
            return None
        out.append(hit)
    return out
