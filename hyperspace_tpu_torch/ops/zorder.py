"""Z-order (Morton) codes of the build (counterpart of
hyperspace_tpu/ops/zorder.py).

A multi-column index sorted lexicographically clusters only its FIRST
indexed column.  The Z-order layout interleaves the bits of every indexed
column's rank, so each index file's value range stays narrow on every
dimension and the per-file min/max sketches prune ranges on any of them.

Per indexed column, from its (n, 2) uint32 monotone order words
(``io.columnar.to_order_words``):

  1. the rank of each row: its position in a stable sort of the 64-bit
     words (``rank[argsort(key, stable)] = arange(n)``: ordinal, so equal
     keys get distinct ranks in row order);
  2. the rank scaled to 16 bits in float32, ``rank * (65535 / (n - 1))``
     with the quotient and the product each rounded to float32, clipped
     to [0, 65535] and truncated;
  3. the 16-bit codes of the K columns interleaved, bit j of column k at
     position ``j * K + (K - 1 - k)``, into a (hi, lo) uint32 pair.

``zorder_order_words`` is the torch version, on the words' device: the
JAX package computes the codes in host numpy, and here they run as torch
ops on the session's device at or above ``device_min_rows("build")``.
``zorder_order_words_np`` and ``interleave16_np`` are copies of the JAX
package's numpy functions: the host mirror below that threshold, and the
oracle of the tests.

torch has no ``>>``, ``<<`` or ``%`` on uint32 on the CPU (ROADMAP Queue
C), so the torch version computes in int64: sort keys go through
``ops.hash.order_key64`` (a Morton code or order word with its top bit
set must not sort as a negative number), and the interleave builds each
32-bit half in its own int64.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.ops.hash import order_key64

MAX_ZORDER_COLUMNS = 4  # 4 x 16 bits = the 64-bit (hi, lo) code


def _check_columns(k_cols: int) -> None:
    if not 1 <= k_cols <= MAX_ZORDER_COLUMNS:
        raise ValueError(
            f"Z-order supports 1..{MAX_ZORDER_COLUMNS} columns, got {k_cols}")


def rank_scale(n: int) -> np.float32:
    """The float32 factor from an ordinal rank to a 16-bit code:
    ``float32(65535) / float32(max(n - 1, 1))``, divided in float32 as
    numpy divides it."""
    return np.float32(65535.0) / np.float32(max(n - 1, 1))


def stable_ranks(words: torch.Tensor) -> torch.Tensor:
    """(n,) int64 ordinal rank of each row by its (n, 2) order words: the
    row's position in a stable sort of the unsigned 64-bit keys."""
    n = words.shape[0]
    order = torch.sort(order_key64(words), stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=words.device)
    rank[order] = torch.arange(n, dtype=torch.int64, device=words.device)
    return rank


def scale_ranks(rank: torch.Tensor, n: int) -> torch.Tensor:
    """Ordinal ranks of ``n`` rows -> (.,) int64 16-bit codes: the int64
    ranks converted to float32 directly (round to nearest, as numpy's
    ``astype``), multiplied by the float32 ``rank_scale(n)``, clipped to
    [0, 65535] and truncated."""
    scale = torch.tensor(rank_scale(n), dtype=torch.float32,
                         device=rank.device)
    return (rank.to(torch.float32) * scale).clamp_(0, 65535).to(torch.int64)


def interleave16(codes: Sequence[torch.Tensor]) -> torch.Tensor:
    """K (n,) int64 16-bit codes -> (n, 2) int64 holding the uint32 (hi,
    lo) Morton words: bit j of code k lands at ``j * K + (K - 1 - k)``."""
    k_cols = len(codes)
    halves = [torch.zeros_like(codes[0]), torch.zeros_like(codes[0])]  # lo, hi
    for j in range(16):
        for k, code in enumerate(codes):
            pos = j * k_cols + (k_cols - 1 - k)
            halves[pos >> 5].bitwise_or_(((code >> j) & 1) << (pos & 31))
    return torch.stack([halves[1], halves[0]], dim=1)


def zorder_order_words(order_words: Sequence[torch.Tensor]) -> torch.Tensor:
    """The Morton words of the rows as ONE (n, 2) order column, from each
    indexed column's (n, 2) uint32 order words, on their device: int64
    holding the uint32 (hi, lo) pair, bit for bit
    ``zorder_order_words_np``'s."""
    _check_columns(len(order_words))
    n = order_words[0].shape[0]
    return interleave16([scale_ranks(stable_ranks(w), n)
                         for w in order_words])


def zorder_sort(order_words: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The build's Z-order pass on the words' device: ``(key, perm)``,
    each row's Morton code as ``order_key64``'s int64 (see
    ``key64_to_codes``) and the stable permutation into Morton order
    (ties in row order, as numpy's stable argsort of the codes)."""
    key = order_key64(zorder_order_words(order_words))
    return key, torch.sort(key, stable=True).indices


def key64_to_codes(key: torch.Tensor) -> np.ndarray:
    """``order_key64`` int64 keys, on any device -> the (n,) uint64 codes
    ``(hi << 32) | lo`` on the host (the key is the code with its top bit
    flipped)."""
    return sync_guard.pull(key, "zorder.codes").view(np.uint64) \
        ^ np.uint64(1 << 63)


def zorder_order_words_np(order_words: Sequence[np.ndarray]) -> np.ndarray:
    """Host mirror of ``zorder_order_words``: (n, 2) uint32 Morton words
    from per-column (n, 2) uint32 order words."""
    k_cols = len(order_words)
    _check_columns(k_cols)
    n = order_words[0].shape[0]
    denom = np.float32(max(n - 1, 1))
    codes = []
    for w in order_words:
        w = np.asarray(w, dtype=np.uint32)
        key = (w[:, 0].astype(np.uint64) << np.uint64(32)) | w[:, 1]
        rank = np.empty(n, np.int64)
        rank[np.argsort(key, kind="stable")] = np.arange(n)
        codes.append(np.clip(
            rank.astype(np.float32) * (np.float32(65535.0) / denom),
            0, 65535).astype(np.uint32))
    hi, lo = interleave16_np(codes)
    return np.stack([hi, lo], axis=1)


def interleave16_np(codes: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Host mirror of ``interleave16``: (hi, lo) uint32."""
    k_cols = len(codes)
    n = codes[0].shape[0]
    hi = np.zeros(n, np.uint64)
    lo = np.zeros(n, np.uint64)
    for j in range(16):
        for k, code in enumerate(codes):
            bit = (code.astype(np.uint64) >> j) & 1
            pos = j * k_cols + (k_cols - 1 - k)
            if pos < 32:
                lo |= bit << pos
            else:
                hi |= bit << (pos - 32)
    return hi.astype(np.uint32), lo.astype(np.uint32)


def words_to_codes64(words: np.ndarray) -> np.ndarray:
    """(n, 2) uint32 (hi, lo) Morton words -> (n,) uint64 codes."""
    w = words.astype(np.uint64)
    return (w[:, 0] << np.uint64(32)) | w[:, 1]
