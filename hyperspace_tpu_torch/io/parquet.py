"""Columnar IO: read source files (Parquet, CSV, JSON, ORC, Avro and
text, with hive partition columns) and index files, write bucketed index
data (a whole sorted table, or one bucket's run of the spill build).

Counterpart of hyperspace_tpu/io/parquet.py.  Index data is Parquet
whatever the source's format.  The bucketed writer writes one sorted
Parquet file per non-empty bucket (more when ``max_rows_per_file``
splits a bucket), named ``part-bNNNNN-*`` so a file maps to its bucket
without reading footers.  The layout and the
bytes per bucket are the JAX package's, so either package reads the
other's index files.  A Z-order index (one bucket) cuts its files where
the top bits of the rows' Morton codes change (``zorder_split_chunks``),
so each file stays inside one cell of the curve.  Each file is hashed as
it lands
(``io/integrity.record_file``, in the writer threads), so the committed
entry carries its content digest.

Every single-file read goes through the ``data.read`` fault site once
and retries transient IO errors (``_read_retry``); a Parquet file read
without partition columns passes the corruption checkpoint of that site
first.  Every index data file written goes through the
``data.write`` site, and its corruption checkpoint comes after the
digest of the intended bytes (io/faults.py).  Reads are ``io.read``
spans and writes ``io.write`` spans, counted in ``io.files.read`` and
``io.files.written`` (telemetry/).

pyarrow is imported when a function runs, never when the module is
imported.
"""

from __future__ import annotations

import contextvars
import os
import re
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.io import faults, integrity
from hyperspace_tpu_torch.ops.sort import bucket_counts
from hyperspace_tpu_torch.telemetry import metrics
from hyperspace_tpu_torch.telemetry.trace import span

_BUCKET_FILE_RE = re.compile(r"part-b(\d{5})-")

# Parquet codec for index data; "none" means uncompressed.
INDEX_COMPRESSION_DEFAULT = "lz4"


def bucket_file_name(bucket: int) -> str:
    return f"part-b{bucket:05d}-{uuid.uuid4().hex[:12]}.parquet"


def bucket_id_of_file(path: str) -> Optional[int]:
    """The bucket id encoded in an index data file name."""
    m = _BUCKET_FILE_RE.search(os.path.basename(path))
    return int(m.group(1)) if m else None


def _io_workers(n: int) -> int:
    return max(1, min(n, os.cpu_count() or 4, 16))


def _read_retry(fn):
    """One file read behind the ``data.read`` site, transient IO errors
    retried with the default policy."""
    from hyperspace_tpu_torch.utils.retry import RetryPolicy

    def attempt():
        faults.check("data.read")
        return fn()

    out = RetryPolicy().call(attempt)
    metrics.inc("io.files.read")
    return out


def read_parquet_file(path: str, columns: Optional[Sequence[str]]):
    """One Parquet file, the corruption checkpoint of ``data.read`` just
    before it (damage found at read time stays on retry)."""
    import pyarrow.parquet as pq

    cols = None if columns is None else list(columns)
    faults.corrupt_file("data.read", path)
    # partitioning=None: no hive columns inferred from the file's own
    # path (an index file under v__=N/ must not grow a v__ column).
    return _read_retry(
        lambda: pq.read_table(path, columns=cols, partitioning=None))


def read_table(paths: Sequence[str], file_format: str = "parquet",
               columns: Optional[Sequence[str]] = None,
               options: Optional[Dict[str, str]] = None,
               partition_roots: Optional[Sequence[str]] = None,
               partition_spec: Optional[Dict[str, str]] = None):
    """Read files of ``file_format`` and concatenate them, in ``paths``
    order, into one arrow Table.

    With ``partition_roots`` (a source scan's root paths; never given for
    index files), each file's ``key=value`` directories below the roots
    become constant columns (io/partitions.py) of the types
    ``partition_spec`` gives, or the directory tree's when it is None."""
    import pyarrow as pa

    with span("io.read", files=len(paths), format=file_format) as sp:
        if not paths:
            return pa.table({})
        load = _file_reader(file_format, columns, options, partition_roots,
                            partition_spec)
        if len(paths) == 1:
            tables = [load(paths[0])]
        else:
            # Each read runs in a copy of the caller's context, so a
            # retry it absorbs lands in the caller's run report
            # (telemetry/report.py).
            contexts = [contextvars.copy_context() for _ in paths]
            with ThreadPoolExecutor(_io_workers(len(paths))) as pool:
                tables = list(pool.map(lambda ctx, p: ctx.run(load, p),
                                       contexts, paths))
        out = pa.concat_tables(tables, promote_options="default")
        sp.set(rows=out.num_rows, bytes=out.nbytes)
        return out


def read_file(path: str, columns: Optional[Sequence[str]],
              file_format: str = "parquet",
              options: Optional[Dict[str, str]] = None,
              partition_roots: Optional[Sequence[str]] = None,
              partition_spec: Optional[Dict[str, str]] = None):
    """One file's ``columns``: ``read_table`` of one path without its
    span.  A Parquet file written before a column was added to the
    source reads without it (the caller fills it with nulls)."""
    return _file_reader(file_format, columns, options, partition_roots,
                        partition_spec)(path)


def _file_reader(file_format: str, columns: Optional[Sequence[str]],
                 options: Optional[Dict[str, str]],
                 partition_roots: Optional[Sequence[str]],
                 partition_spec: Optional[Dict[str, str]]):
    """The function that reads one file of ``file_format``, its
    partition columns attached.  The spec comes from the directory tree,
    never from the files one call reads, so that every caller (a scan,
    a build chunk, a hybrid subset) resolves the same types."""
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.partitions import (
        attach_partition_columns,
        partition_spec_for_roots,
    )

    options = options or {}
    spec: Dict[str, str] = {}
    file_columns = columns
    if partition_roots:
        spec = partition_spec if partition_spec is not None \
            else partition_spec_for_roots(partition_roots)
        if spec and columns and file_format != "parquet":
            # Partition columns come from the paths, not the file.
            file_columns = [c for c in columns if c not in spec]

    def load(path: str):
        file_spec, cols = spec, file_columns
        if spec and file_format == "parquet":
            # A column this file holds wins over the path value, decided
            # per file: in a mixed-schema file set, a file without the
            # column takes the path value, not nulls.  One ParquetFile
            # gives the schema and the rows; ``columns=[]`` keeps the
            # row count of a projection of partition columns only.
            def read_with_spec():
                with pq.ParquetFile(path) as pf:
                    present = set(pf.schema_arrow.names)
                    fspec = {k: t for k, t in spec.items()
                             if k not in present}
                    fcols = None if cols is None \
                        else [c for c in columns if c not in fspec]
                    return fspec, pf.read(
                        columns=None if fcols is None
                        else [c for c in fcols if c in present])

            file_spec, t = _read_retry(read_with_spec)
        else:
            t = _read_one(path, file_format, cols, options)
        if file_spec:
            t = attach_partition_columns(t, path, partition_roots, file_spec,
                                         columns)
        return t

    return load


def _read_one(path: str, file_format: str, columns,
              options: Dict[str, str]):
    """One file without partition columns; each format's read passes
    the ``data.read`` site once (Parquet's in ``read_parquet_file``)."""
    if file_format != "parquet":
        return _read_retry(
            lambda: _read_one_raw(path, file_format, columns, options))
    return _read_one_raw(path, file_format, columns, options)


def _read_one_raw(path: str, file_format: str, columns,
                  options: Dict[str, str]):
    import pyarrow as pa

    if file_format == "parquet":
        if columns is None:
            return read_parquet_file(path, None)
        try:
            return read_parquet_file(path, columns)
        except (pa.ArrowInvalid, KeyError):
            # A mixed-schema file set (a column added by a later
            # append): the columns this file has; the concatenation
            # promotes the rest to nulls.  An empty intersection still
            # keeps the row count.
            import pyarrow.parquet as pq

            present = set(pq.read_schema(path).names)
            return read_parquet_file(path, [c for c in columns
                                            if c in present])
    if file_format == "csv":
        import pyarrow.csv as pacsv

        read_opts = pacsv.ReadOptions()
        if options.get("header", "true").lower() == "false":
            read_opts.autogenerate_column_names = True
        table = pacsv.read_csv(path, read_options=read_opts)
    elif file_format == "json":
        import pyarrow.json as pajson

        table = pajson.read_json(path)
    elif file_format == "orc":
        import pyarrow.orc as paorc

        if columns is not None:
            present = set(paorc.ORCFile(path).schema.names)
            return paorc.read_table(
                path, columns=[c for c in columns if c in present])
        return paorc.read_table(path)
    elif file_format == "avro":
        from hyperspace_tpu_torch.io import avro

        return avro.to_arrow_table(path, columns)
    elif file_format == "text":
        # One string column "value", one row per line, split on \n, \r
        # and \r\n only (str.splitlines would also split on \x0b,
        # \x85, U+2028 and others); a trailing newline adds no row.
        with open(path, "rb") as f:
            text = f.read().decode("utf-8")
        lines = text.replace("\r\n", "\n").replace("\r", "\n").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        table = pa.table({"value": pa.array(lines, type=pa.string())})
        if columns is not None:
            return table.select([c for c in columns
                                 if c in table.column_names])
        return table
    else:
        raise ValueError(f"Unsupported file format: {file_format!r}")
    if columns:
        table = table.select(list(columns))
    return table


def read_schema(path: str, file_format: str = "parquet",
                options: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Column name -> arrow dtype string for one file of
    ``file_format``: from the footer or header where the format has one
    (Parquet, ORC, Avro), from a read of the file for CSV and JSON."""
    if file_format == "parquet":
        import pyarrow.parquet as pq

        return {f.name: str(f.type)
                for f in _read_retry(lambda: pq.read_schema(path))}
    if file_format == "orc":
        import pyarrow.orc as paorc

        return {f.name: str(f.type) for f in paorc.ORCFile(path).schema}
    if file_format == "avro":
        from hyperspace_tpu_torch.io import avro

        return {f.name: str(f.type) for f in avro.avro_schema_to_arrow(
            avro.read_schema_only(path))}
    if file_format == "text":
        return {"value": "string"}
    table = _read_one(path, file_format, None, options or {})
    return {f.name: str(f.type) for f in table.schema}


def schema_to_arrow(schema: Dict[str, str]):
    """Column name -> dtype string (``read_schema``'s form) back to an
    arrow schema."""
    import pyarrow as pa

    return pa.schema([(name, _dtype_from_string(t)) for name, t in schema.items()])


def _dtype_from_string(t: str):
    import pyarrow as pa

    if t.startswith("timestamp"):
        m = re.match(r"timestamp\[(\w+)(?:, tz=(.*))?\]", t)
        if m:
            return pa.timestamp(m.group(1), tz=m.group(2))
    if t.startswith("decimal128"):
        m = re.match(r"decimal128\((\d+),\s*(\d+)\)", t)
        if m:
            return pa.decimal128(int(m.group(1)), int(m.group(2)))
    try:
        return pa.type_for_alias(t)
    except ValueError:
        return pa.string()


def is_cast_type_name(name: str) -> bool:
    """Whether ``name`` is an arrow type name ``_dtype_from_string``
    resolves (it falls back to a string for any name it does not know);
    ``plan.expr.Cast`` checks its target through this, so that the plan
    never imports pyarrow."""
    import pyarrow as pa

    return _dtype_from_string(name) != pa.string() \
        or name in ("string", "str", "utf8")


def bucket_chunks(n_rows: int, max_rows_per_file: int) -> List:
    """[(offset, rows)] splitting a bucket run at ``max_rows_per_file``
    (0 = single chunk)."""
    chunk = max_rows_per_file if max_rows_per_file > 0 else max(n_rows, 1)
    return [(off, min(chunk, n_rows - off))
            for off in range(0, n_rows, chunk)]


def zorder_codes_from_order_words(word_cols: Sequence[np.ndarray]
                                  ) -> Tuple[np.ndarray, int]:
    """(uint64 Morton code per row, total code bits) from per-column
    (n, 2) uint32 monotone order words, on the host
    (``ops.zorder.zorder_order_words_np``)."""
    from hyperspace_tpu_torch.ops.zorder import (
        words_to_codes64,
        zorder_order_words_np,
    )

    z = zorder_order_words_np([np.asarray(w) for w in word_cols])
    return words_to_codes64(z), 16 * len(word_cols)


def zorder_codes_host(table, indexed_columns) -> Tuple[np.ndarray, int]:
    """(uint64 Morton code per row, total code bits) of ``table``'s rows
    by the ``indexed_columns``: the writer's file-split key, computed on
    the host."""
    from hyperspace_tpu_torch.io import columnar

    return zorder_codes_from_order_words([
        columnar.to_order_words(table.column(c)) for c in indexed_columns])


def zorder_split_chunks(z_sorted: np.ndarray, key_bits: int,
                        max_rows_per_file: int) -> List:
    """[(offset, rows)] of one bucket run in Morton order, cut at cell
    boundaries: where the top ``level`` code bits change, ``level`` the
    fewest bits that give the file count ``max_rows_per_file`` asks for.
    A file then lies inside one cell, narrow on every indexed column;
    ``max_rows_per_file`` still caps a skewed cell's files."""
    n = int(len(z_sorted))
    if n == 0:
        return []
    if max_rows_per_file <= 0 or n <= max_rows_per_file:
        return [(0, n)]
    target_files = -(-n // max_rows_per_file)
    level = max(1, min(key_bits, int(np.ceil(np.log2(target_files)))))
    cells = z_sorted >> np.uint64(key_bits - level)
    cuts = (np.flatnonzero(np.diff(cells)) + 1).tolist()
    bounds = [0, *cuts, n]
    out: List = []
    for i in range(len(bounds) - 1):
        off = bounds[i]
        for o, r in bucket_chunks(bounds[i + 1] - off, max_rows_per_file):
            out.append((off + o, r))
    return out


def _codec(compression: Optional[str]):
    c = (compression or INDEX_COMPRESSION_DEFAULT).lower()
    return None if c == "none" else c


def bucket_offsets(bucket_ids: torch.Tensor, num_buckets: int) -> np.ndarray:
    """(num_buckets + 1,) int64 run offsets of the buckets in the sorted
    order: the exclusive prefix sum of the per-bucket row counts, counted
    on the ids' device (``ops.sort.bucket_counts``)."""
    counts = sync_guard.pull(bucket_counts(bucket_ids, num_buckets),
                             "write_bucketed.counts")
    offsets = np.zeros(num_buckets + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def write_bucketed(table, bucket_ids: torch.Tensor, sort_perm: torch.Tensor,
                   num_buckets: int, out_dir: str,
                   max_rows_per_file: int = 0,
                   split_keys: Optional[np.ndarray] = None,
                   split_key_bits: int = 0,
                   compression: Optional[str] = None) -> List[str]:
    """Write ``table`` as sorted Parquet files, one or more per non-empty
    bucket.

    ``sort_perm`` orders rows by (bucket, sort columns); ``bucket_ids``
    are the per-row bucket assignments in row order.  Each bucket's run
    in the sorted order starts at the exclusive prefix sum of the counts
    of the buckets before it.  Empty buckets get no file.
    ``split_keys`` (the rows' uint64 Morton codes in row order, a
    Z-order layout) cuts each run at cell boundaries
    (``zorder_split_chunks``) instead of every ``max_rows_per_file``
    rows."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(out_dir, exist_ok=True)
    offsets = bucket_offsets(bucket_ids, num_buckets)
    if offsets[-1] != table.num_rows:
        raise HyperspaceError(
            f"bucket counts sum to {offsets[-1]}, table has {table.num_rows} rows")
    perm = sync_guard.pull(sort_perm, "write_bucketed.perm")
    sorted_table = table.take(pa.array(perm))
    sorted_keys = None if split_keys is None else split_keys[perm]
    jobs: List = []  # one per file, so skewed builds still write in parallel
    for b in range(num_buckets):
        start, n = int(offsets[b]), int(offsets[b + 1] - offsets[b])
        if sorted_keys is not None:
            chunks = zorder_split_chunks(sorted_keys[start:start + n],
                                         split_key_bits, max_rows_per_file)
        else:
            chunks = bucket_chunks(n, max_rows_per_file) if n else []
        for off, rows in chunks:
            jobs.append((b, start + off, rows))

    def write(job) -> str:
        b, start, rows = job
        path = os.path.join(out_dir, bucket_file_name(b))
        faults.check("data.write")
        pq.write_table(sorted_table.slice(start, rows), path,
                       compression=_codec(compression))
        # The digest of the intended bytes, then the corruption
        # checkpoint: damage after a write the writer believed good.
        integrity.record_file(path)
        faults.corrupt_file("data.write", path)
        metrics.inc("io.files.written")
        return path

    with span("io.write", rows=table.num_rows, files=len(jobs)), \
            ThreadPoolExecutor(_io_workers(len(jobs))) as pool:
        return list(pool.map(write, jobs))


def write_bucket_run(sorted_bucket_table, bucket: int, out_dir: str,
                     max_rows_per_file: int = 0,
                     split_keys: Optional[np.ndarray] = None,
                     split_key_bits: int = 0,
                     compression: Optional[str] = None) -> List[str]:
    """Write ONE bucket's already sorted rows, split at
    ``max_rows_per_file``: the spill build's finalize, one bucket at a
    time (``write_bucketed`` writes a whole sorted table), and optimize's
    and repair's rewrites.  ``split_keys``, the run's Morton codes in its
    sorted order, cuts at cell boundaries instead
    (``zorder_split_chunks``)."""
    import pyarrow.parquet as pq

    if split_keys is not None:
        chunks = zorder_split_chunks(split_keys, split_key_bits,
                                     max_rows_per_file)
    else:
        chunks = bucket_chunks(sorted_bucket_table.num_rows,
                               max_rows_per_file)
    out: List[str] = []
    with span("io.write", bucket=bucket,
              rows=sorted_bucket_table.num_rows) as sp:
        for off, rows in chunks:
            path = os.path.join(out_dir, bucket_file_name(bucket))
            faults.check("data.write")
            pq.write_table(sorted_bucket_table.slice(off, rows), path,
                           compression=_codec(compression))
            integrity.record_file(path)
            faults.corrupt_file("data.write", path)
            metrics.inc("io.files.written")
            out.append(path)
        sp.set(files=len(out))
    return out


def sort_permutation_host(table, indexed_columns,
                          layout: str = "lexicographic") -> np.ndarray:
    """Within-bucket sort permutation of the index ``layout`` on the host:
    a stable lexsort over one uint64 order code per indexed column (the
    same total order as the (hi, lo) word pair), first column primary;
    or, for "zorder", a stable argsort of the rows' Morton codes by
    ranks within ``table`` (``write_zorder_run`` also cuts the files at
    cell boundaries)."""
    from hyperspace_tpu_torch.io import columnar

    if layout == "zorder":
        codes, _ = zorder_codes_host(table, indexed_columns)
        return np.argsort(codes, kind="stable")
    keys: List[np.ndarray] = []
    for c in reversed(list(indexed_columns)):
        w = columnar.to_order_words(table.column(c))
        keys.append(columnar.join_words64(w[:, 0], w[:, 1]))
    return np.lexsort(tuple(keys))


def sort_permutation_from_codes(btable, code_columns) -> np.ndarray:
    """Within-bucket sort permutation from the uint64 sort codes the spill
    build's route carried along (one column per indexed column, in
    indexed-column order): equal to ``sort_permutation_host`` for
    value-mapped key types, without deriving order words again."""
    keys: List[np.ndarray] = []
    # np.lexsort: the LAST key is primary.
    for name in reversed(list(code_columns)):
        keys.append(btable.column(name).to_numpy(zero_copy_only=False))
    return np.lexsort(tuple(keys))


def write_zorder_run(btable, bucket: int, out_dir: str,
                     max_rows_per_file: int, indexed_columns,
                     compression: Optional[str] = None) -> List[str]:
    """Sort one run into Morton order by ranks within the run, on the
    host, and write it with cell-aligned file cuts: optimize's
    compaction (a subset of the index's files, clustered by its own
    ranks) and repair's rebuild of the one bucket (the whole snapshot,
    so its ranks are the build's)."""
    import pyarrow as pa

    codes, bits = zorder_codes_host(btable, indexed_columns)
    perm = np.argsort(codes, kind="stable")
    return write_bucket_run(btable.take(pa.array(perm)), bucket, out_dir,
                            max_rows_per_file, split_keys=codes[perm],
                            split_key_bits=bits, compression=compression)
