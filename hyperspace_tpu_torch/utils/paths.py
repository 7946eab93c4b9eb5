"""Path helpers (counterpart of hyperspace_tpu/utils/paths.py)."""

from __future__ import annotations

import os


def normalize_path(path: str) -> str:
    """Absolute, scheme-less canonical form of a local path."""
    return os.path.abspath(os.path.expanduser(path))


def is_data_file(name: str) -> bool:
    """Files starting with '_' or '.' are metadata, not data."""
    base = os.path.basename(name)
    return not (base.startswith("_") or base.startswith("."))
