"""Arrow columns -> the arrays the device takes.

Counterpart of hyperspace_tpu/io/columnar.py (its build and query
subset):

  - ``to_hash_words``: any column -> (n, 2) uint32 words for the bucket
    hash.  Numerics bitcast on the host; strings, binary and decimals are
    hashed with pandas' vectorized hasher, exactly as the JAX package
    does, because the bucket of every row must be the same bits.
  - ``to_order_words``: any column -> (n, 2) uint32 monotone words whose
    (hi, lo) order equals the column's value order; ``to_order_codes64``
    the same order as one uint64 per row.
  - ``to_device_numeric`` / ``literal_to_numeric``: a null-free numeric
    column as float64 or int64 (temporal and bool as int64), and a
    literal in the same domain, for the device predicate and join.

pyarrow (and pandas, for variable-length keys) is imported when a
function runs, never when the module is imported: the port's kernels and
data plane run without it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# Sentinel hash words for NULL: all nulls land in one deterministic bucket.
_NULL_WORDS = (np.uint32(0x9E3779B9), np.uint32(0x7F4A7C15))


def _combine(column):
    import pyarrow as pa

    if isinstance(column, pa.ChunkedArray):
        column = column.combine_chunks()
    if pa.types.is_dictionary(column.type):
        column = column.cast(column.type.value_type)
    return column


def _null_mask(column) -> Optional[np.ndarray]:
    """Boolean mask of null positions, or None when the column has no nulls."""
    import pyarrow.compute as pc

    if column.null_count == 0:
        return None
    return np.asarray(pc.is_null(column).to_numpy(zero_copy_only=False), dtype=bool)


def _temporal_to_int64(column):
    """Temporal -> int64 in the column's own storage unit (date32 stays
    days, timestamp[us] stays micros)."""
    import pyarrow as pa

    t = column.type
    if pa.types.is_date32(t) or pa.types.is_time32(t):
        return column.cast(pa.int32()).cast(pa.int64())
    return column.cast(pa.int64())


def _numeric_int64(column, fill_null_zero: bool) -> np.ndarray:
    """int/bool/temporal column -> int64 numpy array in the native domain."""
    import pyarrow as pa
    import pyarrow.compute as pc

    t = column.type
    if pa.types.is_temporal(t):
        column = _temporal_to_int64(column)
    elif pa.types.is_boolean(t) or not pa.types.is_int64(t):
        column = column.cast(pa.int64())
    if fill_null_zero and column.null_count > 0:
        column = pc.fill_null(column, 0)
    return column.to_numpy(zero_copy_only=False).astype(np.int64, copy=False)


def is_numeric_type(t) -> bool:
    import pyarrow as pa

    return (pa.types.is_integer(t) or pa.types.is_floating(t)
            or pa.types.is_boolean(t) or pa.types.is_temporal(t))


def to_hash_words(column) -> np.ndarray:
    """(n, 2) uint32 hash words; equal values always map to equal words;
    nulls all map to one sentinel word pair (one deterministic bucket)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    column = _combine(column)
    t = column.type
    nulls = _null_mask(column)
    if pa.types.is_floating(t):
        if nulls is not None:
            column = pc.fill_null(column, 0.0)
        arr = column.to_numpy(zero_copy_only=False).astype(np.float64)
        arr = np.where(arr == 0.0, 0.0, arr)  # -0.0 == 0.0 must hash equal
        # All NaN bit patterns hash alike.
        arr = np.where(np.isnan(arr), np.float64("nan"), arr)
        bits = arr.view(np.uint64)
    elif is_numeric_type(t):
        bits = _numeric_int64(column, fill_null_zero=True).view(np.uint64)
    else:
        # Variable-length (string/binary/decimal): vectorized stable hash.
        import pandas.util

        arr = column.to_numpy(zero_copy_only=False)
        bits = pandas.util.hash_array(np.asarray(arr, dtype=object))
    out = split_words64(bits.view(np.uint64) if bits.dtype != np.uint64 else bits)
    if nulls is not None:
        out[nulls, 0] = _NULL_WORDS[0]
        out[nulls, 1] = _NULL_WORDS[1]
    return out


def to_order_key(column) -> np.ndarray:
    """(n,) numeric key whose ordering equals the column's value ordering.
    Nulls sort with the placeholder value."""
    import pyarrow as pa
    import pyarrow.compute as pc

    column = _combine(column)
    t = column.type
    if pa.types.is_floating(t):
        if column.null_count > 0:
            column = pc.fill_null(column, 0.0)
        return column.to_numpy(zero_copy_only=False).astype(np.float64)
    if is_numeric_type(t):
        return _numeric_int64(column, fill_null_zero=True)
    # Strings: dense rank (np.unique inverse is rank-ordered).
    arr = column.to_numpy(zero_copy_only=False)
    _, inverse = np.unique(np.asarray(arr, dtype=object), return_inverse=True)
    return inverse.astype(np.int64)


def _monotone_uint64(keys: np.ndarray) -> np.ndarray:
    """Order-preserving map of an int64/float64 key array into uint64
    (int64: flip the sign bit; float64: the IEEE total-order trick)."""
    if keys.dtype == np.float64:
        bits = keys.view(np.int64)
        return np.where(bits >= 0,
                        bits.view(np.uint64) + np.uint64(1 << 63),
                        ~bits.view(np.uint64))
    if keys.dtype != np.int64:
        raise TypeError(f"order keys must be int64 or float64, got {keys.dtype}")
    return keys.view(np.uint64) ^ np.uint64(1 << 63)


def split_words64(values: np.ndarray) -> np.ndarray:
    """(n,) uint64 -> (n, 2) uint32 (hi, lo)."""
    out = np.empty((len(values), 2), dtype=np.uint32)
    out[:, 0] = (values >> np.uint64(32)).astype(np.uint32)
    out[:, 1] = (values & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def join_words64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Inverse of ``split_words64``."""
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def to_order_words(column) -> np.ndarray:
    """(n, 2) uint32 monotone words: lexicographic (hi, lo) order equals
    the column's value order."""
    return split_words64(_monotone_uint64(to_order_key(column)))


def to_order_codes64(column) -> np.ndarray:
    """(n,) uint64 monotone codes: ``to_order_words`` without the split
    into 32-bit words.  The spill build sorts its runs on these on the
    host and carries them along the run files as the writer's sort
    codes."""
    return _monotone_uint64(to_order_key(column))


def to_device_numeric(column) -> Optional[np.ndarray]:
    """The column as a float64 or int64 numpy array, ready to upload to
    the device; None when it is not numeric or holds a null (SQL null
    semantics stay on the arrow host path)."""
    import pyarrow as pa

    column = _combine(column)
    t = column.type
    if not is_numeric_type(t) or column.null_count > 0:
        return None
    if pa.types.is_floating(t):
        return column.to_numpy(zero_copy_only=False).astype(np.float64)
    return _numeric_int64(column, fill_null_zero=False)


def literal_to_numeric(value, t) -> Optional[float]:
    """A literal in ``to_device_numeric``'s domain for a column of arrow
    type ``t``; None when it does not fit that domain."""
    import pyarrow as pa

    if pa.types.is_temporal(t):
        try:
            arr = pa.array([value], type=t)
        except (pa.ArrowInvalid, pa.ArrowTypeError):
            return None
        return int(_temporal_to_int64(arr)[0].as_py())
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, (int, float)):
        return value
    return None
