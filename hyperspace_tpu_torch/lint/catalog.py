"""The docs/16-observability.md metric catalog, parsed at run time for
the Prometheus ``# HELP`` lines of ``telemetry/metrics.render_prometheus``
(counterpart of the runtime half of hyperspace_tpu/lint/catalog.py).
The static checker around it is not ported; this module holds only the
table parser and the name matcher, so the exposition reads the same
catalog text as the JAX package's."""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

OBS_DOC_PATH = "docs/16-observability.md"

_TOKEN_RE = re.compile(r"`([A-Za-z0-9_.<>-]+)`")
_PLACEHOLDER_SEG_RE = re.compile(r"^<[A-Za-z0-9_]+>$")
_MD_LINK_RE = re.compile(r"\[([^\]]+)\]\([^)]*\)")


def _expand_cell_tokens(cell: str) -> List[str]:
    """Backticked names from one table cell, expanding the catalog's
    leading-dot shorthand: ``advisor.capture.dropped`` / ``.errors``
    means advisor.capture.errors (the shorthand replaces that many
    trailing segments of the cell's first full token)."""
    tokens = _TOKEN_RE.findall(cell)
    out: List[str] = []
    anchor: Optional[str] = None
    for tok in tokens:
        if tok.startswith("."):
            if anchor is None:
                continue
            short = tok[1:].split(".")
            base = anchor.split(".")
            if len(short) >= len(base):
                continue
            out.append(".".join(base[:-len(short)] + short))
        else:
            out.append(tok)
            if anchor is None:
                anchor = tok
    return out


def _table_first_cells(text: str, start_heading: str,
                       stop_prefix: str = "#") -> List[Tuple[str, int]]:
    """(first-cell, line) of each table row between ``start_heading`` and
    the next heading."""
    lines = text.splitlines()
    out: List[Tuple[str, int]] = []
    in_section = False
    for i, line in enumerate(lines, start=1):
        if line.strip().startswith(start_heading):
            in_section = True
            continue
        if in_section and line.startswith(stop_prefix):
            break
        if in_section and line.lstrip().startswith("|") \
                and line.count("|") >= 2:
            cell = line.split("|")[1]
            if set(cell.strip()) <= {"-", ":", " "}:
                continue  # separator row
            out.append((cell, i))
    return out


def metric_help_entries() -> List[Tuple[str, str]]:
    """``(name-pattern, help-text)`` pairs from the docs/16 metric table,
    read from the checkout; a package installed without ``docs/`` gets
    no entries."""
    root = __file__
    for _ in range(3):  # lint/catalog.py -> lint -> package -> repo
        root = os.path.dirname(root)
    try:
        with open(os.path.join(root, OBS_DOC_PATH),
                  "r", encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return []
    out: List[Tuple[str, str]] = []
    lines = text.splitlines()
    for cell, lineno in _table_first_cells(text, "| Metric "):
        row = lines[lineno - 1]
        cells = [c.strip() for c in row.split("|")]
        doc = cells[-2] if len(cells) >= 4 else ""
        doc = _MD_LINK_RE.sub(r"\1", doc).replace("`", "")
        doc = " ".join(doc.split())
        for tok in _expand_cell_tokens(cell):
            out.append((tok, doc))
    return out


def _segs(name: str) -> List[str]:
    return name.split(".")


def name_matches_entry(name: str, entry: str) -> bool:
    """Does a concrete-or-pattern usage name match a catalog entry?
    ``name`` segments of ``\\x00``-bearing text are wildcards (from
    f-strings); entry segments like ``<slug>`` are placeholders."""
    a, b = _segs(name), _segs(entry)
    if len(a) != len(b):
        return False
    for ua, ub in zip(a, b):
        if "\x00" in ua or _PLACEHOLDER_SEG_RE.match(ub):
            continue
        if ua != ub:
            return False
    return True
