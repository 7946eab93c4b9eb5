"""Window functions over sorted partition segments (counterpart of
hyperspace_tpu/ops/window.py, which is host numpy).

The executor sorts the table once by (partition, order keys) and hands
these functions tensors in that sorted layout; each window function is a
segment operation with no per-partition loop:

  - ranking (row_number, rank, dense_rank, ntile): arithmetic on the
    partition and tie boundary masks;
  - frame aggregates (sum, count, mean): prefix-sum differences, int64
    for integer inputs (exact above 2**53; a prefix that wraps past 2**63
    still gives the right difference under two's complement);
  - frame min and max: the ARG row, so the caller takes the value from
    the source column in its own type.  Prefix and suffix frames use a
    Hillis-Steele doubling scan clamped at partition starts, frames
    bounded on both sides a sparse table; ties keep the leftmost row by
    explicit comparisons (``torch.argmin`` promises no tie order), which
    decides between ``-0.0`` and ``0.0``;
  - first_value and last_value: the frame's boundary row.

Frames are inclusive ROWS frames [lo, hi] in sorted coordinates
(:func:`frame_bounds`); the default RANGE frame is lo = partition start,
hi = the end of the row's tie group.  NaN counts as missing in sums,
means, minima and maxima, as in the JAX package.

Every function but :func:`partition_codes` is plain torch and runs where
its inputs live: int64, float64 and bool tensors (other int and float
dtypes are widened as the JAX package widens them).  On the CPU the
results are the JAX package's bit for bit: torch's CPU ``cumsum``
accumulates float64 left to right as numpy's does, and ``_prefix``
repairs the one place they differ (numpy's running sum starts at x[0],
torch's at 0 + x[0], so a leading run of ``-0.0`` keeps its sign only in
numpy's).  On the card a scan sums in another order: a float frame sum
there differs from the CPU's by rounding of the prefix, which reaches
the whole table's sum, not the frame's.

uint64 values: torch has no uint64 ``cumsum`` on the CPU, so
:func:`frame_sum` keeps the JAX package's numpy branch for a numpy
uint64 array (sums in uint64, which the caller checks against int64's
range); :func:`frame_mean` widens such an array to float64 in numpy and
:func:`frame_min_max` compares it as int64 with the sign bit flipped,
which keeps its order.

:func:`partition_codes` reads an arrow table and imports pyarrow inside
the function.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from hyperspace_tpu_torch.execution import sync_guard

__all__ = [
    "partition_codes", "segment_bounds", "frame_bounds",
    "row_number", "rank_from_ties", "dense_rank_from_ties", "ntile",
    "frame_count", "frame_sum", "frame_mean", "frame_min_max",
    "frame_first_last",
]

Values = Union[torch.Tensor, np.ndarray]

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def partition_codes(table, keys) -> torch.Tensor:
    """Null-safe group codes (int64, on the CPU) of the rows over the
    columns ``keys``: equal tuples, nulls equal to nulls, share a code.
    The codes are dense but not ordered by value; they are the JAX
    package's codes."""
    import pyarrow as pa
    import pyarrow.compute as pc

    n = table.num_rows
    if not keys:
        return torch.zeros(n, dtype=torch.int64)
    combined = torch.zeros(n, dtype=torch.int64)
    for name in keys:
        column = table.column(name)
        if isinstance(column, pa.ChunkedArray):
            column = column.combine_chunks()
        enc = column.dictionary_encode()
        idx = pc.fill_null(enc.indices, -1).to_numpy(zero_copy_only=False)
        card = len(enc.dictionary) + 1  # + 1 for the null slot
        codes = torch.from_numpy(idx.astype(np.int64)) + 1
        if n and card > 1 and sync_guard.scalar(
                combined.max(), "window.codes_max") > (2**62) // card:
            # Densify again before the product could overflow int64.
            _, combined = torch.unique(combined, sorted=True,
                                       return_inverse=True)
        combined = combined * card + codes
    _, dense = torch.unique(combined, sorted=True, return_inverse=True)
    return dense.to(torch.int64)


def _segment_ids(new_seg: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(new_seg.to(torch.int64), 0) - 1


def segment_bounds(new_seg: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row its segment's first and last index (inclusive), from a
    boundary mask over the sorted layout (``new_seg[0]`` is True).
    Gathers by segment id, not running maxima: ``torch.cummax`` of one
    long row is slow on the card."""
    n = new_seg.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=new_seg.device)
    if n == 0:
        return idx, idx
    seg_id = _segment_ids(new_seg)
    starts = idx[new_seg]
    last = torch.cat([starts[1:] - 1, idx[-1:]])
    return starts[seg_id], last[seg_id]


def frame_bounds(part_start: torch.Tensor, part_end: torch.Tensor,
                 tie_end: Optional[torch.Tensor],
                 frame: Optional[Tuple[Optional[int], Optional[int]]],
                 has_order: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive [lo, hi] row bounds per row, sorted coordinates.
    ``frame=None`` is SQL's default: the whole partition without an
    ORDER BY, else RANGE UNBOUNDED PRECEDING to CURRENT ROW with its
    peers (``tie_end``).  A ROWS frame (lo_off, hi_off) is relative to
    the row, None meaning unbounded."""
    if frame is None:
        if not has_order:
            return part_start, part_end
        return part_start, tie_end
    idx = torch.arange(part_start.shape[0], dtype=torch.int64,
                       device=part_start.device)
    lo_off, hi_off = frame
    lo = part_start if lo_off is None else \
        torch.maximum(part_start, idx + lo_off)
    hi = part_end if hi_off is None else torch.minimum(part_end, idx + hi_off)
    return lo, hi


# ---------------------------------------------------------------- ranking

def row_number(part_start: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(part_start.shape[0], dtype=torch.int64,
                       device=part_start.device)
    return (idx - part_start + 1).to(torch.int32)


def dense_rank_from_ties(new_part: torch.Tensor,
                         new_tie: torch.Tensor) -> torch.Tensor:
    """The boundary masks start True, and every partition start is a
    tie start."""
    cum = torch.cumsum(new_tie.to(torch.int64), 0)
    # The tie groups before the row's partition: cum - 1 at its start
    # (the start row's own flag is set).
    offset = (cum - 1)[new_part][_segment_ids(new_part)]
    return (cum - offset).to(torch.int32)


def rank_from_ties(part_start: torch.Tensor,
                   new_tie: torch.Tensor) -> torch.Tensor:
    """``new_tie`` starts True."""
    idx = torch.arange(part_start.shape[0], dtype=torch.int64,
                       device=part_start.device)
    rn = idx - part_start + 1
    tie_start = idx[new_tie][_segment_ids(new_tie)]
    return rn[tie_start].to(torch.int32)


def ntile(part_start: torch.Tensor, part_end: torch.Tensor,
          k: int) -> torch.Tensor:
    """Spark's NTile: the first ``size % k`` tiles get one more row."""
    i = torch.arange(part_start.shape[0], dtype=torch.int64,
                     device=part_start.device) - part_start
    size = part_end - part_start + 1
    base, rem = size // k, size % k
    cut = rem * (base + 1)
    big = i // torch.clamp(base + 1, min=1)
    small = rem + (i - cut) // torch.clamp(base, min=1)
    return (torch.where(i < cut, big, small) + 1).to(torch.int32)


# ----------------------------------------------------------- frame aggs

def _prefix(x: torch.Tensor) -> torch.Tensor:
    """[0, x0, x0 + x1, ...], summed left to right on the CPU."""
    s = torch.cumsum(x, 0)
    if x.is_floating_point() and x.shape[0]:
        # numpy's running sum starts at x[0] and keeps a leading run of
        # -0.0 negative; torch's starts at 0 + x[0] = +0.0.
        neg_zero = (x == 0) & torch.signbit(x)
        first_other = torch.argmax((~neg_zero).to(torch.int32))
        idx = torch.arange(x.shape[0], device=x.device)
        s = s.masked_fill((idx < first_other) | neg_zero.all(), -0.0)
    return torch.cat([x.new_zeros(1), s])


def _between(c: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """c[hi + 1] - c[lo] of a prefix ``c`` of n + 1 entries, the indices
    clamped into it (a clamped entry belongs to an empty frame, which
    the callers mask)."""
    n = c.shape[0] - 1
    return c[torch.clamp(hi + 1, 0, n)] - c[torch.clamp(lo, 0, n)]


def frame_count(valid: Optional[torch.Tensor], lo: torch.Tensor,
                hi: torch.Tensor) -> torch.Tensor:
    """count(value) over each frame (``valid`` None: count(*))."""
    if valid is None:
        return torch.clamp(hi - lo + 1, min=0)
    out = _between(_prefix(valid.to(torch.int64)), lo, hi)
    return torch.where(hi < lo, 0, out)


def frame_sum(vals: Values, valid: torch.Tensor, lo: torch.Tensor,
              hi: torch.Tensor) -> Tuple[Values, torch.Tensor]:
    """(sums, valid counts).  Integers and bools sum in int64, floats in
    float64 with NaN as missing; a numpy uint64 array sums in uint64 in
    numpy and its sums come back as that numpy array."""
    if isinstance(vals, np.ndarray):
        work = np.where(sync_guard.pull(valid, "window.valid"), vals,
                        0).astype(np.uint64)
        s = np.zeros(work.shape[0] + 1, dtype=np.uint64)
        np.cumsum(work, out=s[1:])
        n = work.shape[0]
        lo_np = sync_guard.pull(lo, "window.lo")
        hi_np = sync_guard.pull(hi, "window.hi")
        sums = s[np.clip(hi_np + 1, 0, n)] - s[np.clip(lo_np, 0, n)]
        cnt = frame_count(valid, lo, hi)
        return np.where(sync_guard.pull(cnt > 0, "window.nonempty"),
                        sums, 0), cnt
    if vals.is_floating_point():
        valid = valid & ~torch.isnan(vals)
        work = torch.where(valid, vals, 0.0).to(torch.float64)
    else:
        work = torch.where(valid, vals, 0).to(torch.int64)
    sums = _between(_prefix(work), lo, hi)
    cnt = frame_count(valid, lo, hi)
    return torch.where(cnt > 0, sums, 0), cnt


def frame_mean(vals: Values, valid: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(means, valid counts); a frame with no valid value divides by 0
    and is masked by its count."""
    if isinstance(vals, np.ndarray):
        work = torch.from_numpy(
            np.where(sync_guard.pull(valid, "window.valid"), vals,
                     0).astype(np.float64)) \
            .to(valid.device)
    elif vals.is_floating_point():
        valid = valid & ~torch.isnan(vals)
        work = torch.where(valid, vals, 0.0).to(torch.float64)
    else:
        work = torch.where(valid, vals, 0).to(torch.float64)
    cnt = frame_count(valid, lo, hi)
    return _between(_prefix(work), lo, hi) / cnt, cnt


def _better(cand_v, cand_a, cur_v, cur_a, pick_smaller: bool):
    """Whether the candidate (value, row) replaces the current one: a
    strictly better value, or an equal value at an earlier row."""
    strict = cand_v < cur_v if pick_smaller else cand_v > cur_v
    return strict | ((cand_v == cur_v) & (cand_a < cur_a))


def _arg_scan(work: torch.Tensor, part_start: torch.Tensor,
              pick_smaller: bool) -> torch.Tensor:
    """Hillis-Steele prefix ARGmin/ARGmax clamped at partition starts:
    after pass k, arg[i] is the extremum's row over [max(part_start_i,
    i - 2**k + 1), i]; log2(n) passes."""
    n = work.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=work.device)
    arg = idx.clone()
    best = work.clone()
    shift = 1
    while shift < n:
        src = idx - shift
        ok = src >= part_start
        if not sync_guard.scalar(ok.any(), "window.scan_live"):
            break
        src = torch.clamp(src, min=0)
        s_best, s_arg = best[src], arg[src]
        take = ok & _better(s_best, s_arg, best, arg, pick_smaller)
        best = torch.where(take, s_best, best)
        arg = torch.where(take, s_arg, arg)
        shift *= 2
    return arg


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) of positive int64 values below 2**53, exactly."""
    return torch.frexp(x.to(torch.float64)).exponent.to(torch.int64) - 1


def _sparse_arg(work: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                pick_smaller: bool) -> torch.Tensor:
    """Sparse-table range ARGmin/ARGmax for frames bounded on both sides:
    O(n log max width) memory, the widths being the frame's row offsets
    clamped at the partition edges."""
    n = work.shape[0]
    width = torch.clamp(hi - lo + 1, min=1)
    max_w = int(sync_guard.scalar(width.max(), "window.max_width")) \
        if n else 1
    levels = max(max_w.bit_length() - 1, 0)
    val_tab = [work]
    arg_tab = [torch.arange(n, dtype=torch.int64, device=work.device)]
    for k in range(1, levels + 1):
        half = 1 << (k - 1)
        if half >= n:
            break
        prev_v, prev_a = val_tab[-1], arg_tab[-1]
        left_v, right_v = prev_v[:n - half], prev_v[half:]
        left_a, right_a = prev_a[:n - half], prev_a[half:]
        take = _better(right_v, right_a, left_v, left_a, pick_smaller)
        val_tab.append(torch.cat([torch.where(take, right_v, left_v),
                                  prev_v[n - half:]]))
        arg_tab.append(torch.cat([torch.where(take, right_a, left_a),
                                  prev_a[n - half:]]))
    k_i = _floor_log2(width)
    out = torch.empty(n, dtype=torch.int64, device=work.device)
    for k in range(levels + 1):
        mask = k_i == k
        if not sync_guard.scalar(mask.any(), "window.level_live"):
            continue
        a = lo[mask]
        b = torch.clamp(hi[mask] - (1 << k) + 1, min=0)
        va, aa = val_tab[k][a], arg_tab[k][a]
        vb, ab = val_tab[k][b], arg_tab[k][b]
        out[mask] = torch.where(_better(vb, ab, va, aa, pick_smaller), ab, aa)
    return out


def frame_min_max(vals: Values, valid: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, part_start: torch.Tensor,
                  part_end: torch.Tensor,
                  frame: Optional[Tuple[Optional[int], Optional[int]]],
                  is_min: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(arg rows, valid counts): the row (sorted coordinates) of each
    frame's minimum or maximum, for the caller to take from the source
    column.  Nulls and NaN are skipped (a sentinel value); a frame with
    no valid value is masked by its count."""
    if isinstance(vals, np.ndarray):
        if vals.dtype != np.uint64:
            raise ValueError(f"frame_min_max takes a numpy array only for "
                             f"uint64 values, got {vals.dtype}")
        # Flipping the sign bit maps uint64's order onto int64's.
        flipped = (vals ^ np.uint64(1 << 63)).view(np.int64)
        work = torch.from_numpy(flipped.copy()).to(valid.device)
        skip = ~valid
        sentinel = _INT64_MAX if is_min else _INT64_MIN
    elif vals.is_floating_point():
        work = vals.to(torch.float64)
        skip = ~valid | torch.isnan(work)
        sentinel = float("inf") if is_min else float("-inf")
    else:  # ints and bools
        work = vals.to(torch.int64)
        skip = ~valid
        sentinel = _INT64_MAX if is_min else _INT64_MIN
    work = work.masked_fill(skip, sentinel)
    n = work.shape[0]
    lo_c = torch.clamp(lo, 0, max(n - 1, 0))
    hi_c = torch.clamp(hi, 0, max(n - 1, 0))
    if frame is None or frame[0] is None:
        arg = _arg_scan(work, part_start, pick_smaller=is_min)[hi_c]
    elif frame[1] is None:
        # A suffix frame: the prefix scan over the mirrored rows.
        rev_start = (n - 1) - part_end.flip(0)
        scan = _arg_scan(work.flip(0), rev_start, pick_smaller=is_min)
        arg = (n - 1) - scan[(n - 1) - lo_c]
    else:
        arg = _sparse_arg(work, torch.minimum(lo_c, hi_c), hi_c,
                          pick_smaller=is_min)
    return arg, frame_count(~skip, lo, hi)


def frame_first_last(lo: torch.Tensor, hi: torch.Tensor,
                     first: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(arg rows, nonempty mask) of first_value / last_value: the frame's
    boundary row (nulls respected, Spark's default)."""
    arg = lo if first else hi
    nonempty = hi >= lo
    return torch.where(nonempty, arg, 0), nonempty
