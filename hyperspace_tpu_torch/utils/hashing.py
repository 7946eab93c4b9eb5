"""Host-side hashing helpers for signatures (counterpart of
hyperspace_tpu/utils/hashing.py): md5 of a string and an order-sensitive
md5 fold."""

from __future__ import annotations

import hashlib
from typing import Iterable


def md5_hex(value: str) -> str:
    return hashlib.md5(value.encode("utf-8")).hexdigest()


def fold_md5(parts: Iterable[str], init: str = "") -> str:
    """h_{i+1} = md5(h_i + part_i)."""
    acc = init
    for part in parts:
        acc = md5_hex(acc + part)
    return acc
