"""Case-insensitive column-name resolution (counterpart of
hyperspace_tpu/utils/resolver.py): requested names resolve against a
schema and come back in the schema's own spelling."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

from hyperspace_tpu_torch.exceptions import HyperspaceError


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


def resolve_or_raise(requested: Sequence[str], available: Iterable[str],
                     what: str = "column") -> List[str]:
    """``resolve``, raising ``HyperspaceError`` with the names that do
    not resolve."""
    available = list(available)
    resolved = resolve(requested, available)
    if resolved is None:
        missing = [n for n in requested if resolve([n], available) is None]
        raise HyperspaceError(
            f"Could not resolve {what}(s) {missing} against schema {available}")
    return resolved
