"""CreateAction: validate the config and plan, build the covering index on
the session's device, commit the log entry (counterpart of
hyperspace_tpu/actions/create.py).

The build reads the source one file at a time (``_PrefetchReader``, which
decodes ahead on one thread), in the relation's format (Parquet, CSV,
JSON, ORC, Avro or text) with its hive partition columns, and cuts it
into batches of exactly ``conf.device_batch_rows`` rows:

  - Everything fits in one batch: the monolithic build.  Key columns
    become uint32 hash and order words (``io.columnar``), the hash kernel
    and the stable lexsort by (bucket, key words) run on the device
    (``ops.sort.bucket_sort_permutation``), and one sorted Parquet file
    per non-empty bucket goes into the next ``v__=N`` directory
    (``io.parquet.write_bucketed``, whose run offsets come from the
    bucket histogram kernel).  Below ``conf.device_min_rows("build")``
    rows the bit-identical host mirror
    (``ops.sort.bucket_sort_permutation_np``) computes the permutation
    instead, and nothing is launched.
  - More rows: the spill build (``_BucketSpill``).  Each batch is routed
    on the device (``ops.hash.route_partition``: the same hash and sorts,
    and the histogram's counts as the run cuts; below the build
    threshold its host mirror ``route_partition_np``), and its rows land,
    grouped by bucket, in Arrow IPC run files in a temporary directory;
    each group of buckets is then merged and written as Parquet.  The
    device holds a few batches at once whatever the source's size, and
    every bucket's bytes equal the monolithic build's.

With a mesh of logical shards (``parallel/mesh.active_mesh``: at least 2
local devices under ``conf.mesh_enabled``), each spill chunk is routed
over the mesh instead (``ops.hash.route_partition_mesh``: the hash per
shard, the exchange to each bucket's owner, the sort and the histogram
per shard; the same ``(perm, counts)``), and the build report records
``mesh_devices`` and the route's milliseconds per mesh position.  The
monolithic build takes the bucket shuffle over the mesh
(``parallel.distributed_bucket_sort_permutation``) when
``conf.parallel_build`` asks for it ("on", or "auto" with more than one
local device); "on" also keeps a source beyond one batch in one
monolithic build.  Every route writes the same bytes.

With ``conf.lineage_enabled`` each row carries its source file's
tracker id in ``DATA_FILE_ID_COLUMN`` (stamped per file as it is read),
an int64 column of the index like any other, through both builds.

A Z-order index (``IndexConfig(..., layout="zorder")``) has one bucket
and its rows in Morton order (``ops/zorder.py``), with its files cut at
cell boundaries (``io.parquet.zorder_split_chunks``), and hashes
nothing:

  - Everything fits in one batch: ``_write_table_bucketed`` computes the
    codes and the stable permutation on the device
    (``ops.zorder.zorder_sort``; below the build threshold the numpy
    mirror) and ``write_bucketed`` writes the one bucket, its run offsets
    from the histogram kernel.
  - More rows: the two-pass ``_zorder_streaming_build``.  Pass A reads
    the indexed columns alone and computes the global codes, their order
    and each row's output file on the device; pass B reads the rows
    again and routes them to one Arrow IPC run per (output file, source
    file) in an ``hs_zbuild_`` temporary directory; each output file's
    runs are then merged, sorted by code and written.  The files are the
    monolithic build's, row for row.

Every version directory a build writes gets ``_sketch.parquet``, the
min/max of the indexed columns per index file
(``actions/data_skipping.write_index_file_sketch``; the ``sketch_s``
phase).  Every index data file is hashed as it lands
(``io/integrity.py``), so the committed entry carries its digest.
Phase seconds go to ``session.build_stats_log`` and, with the bytes
read, written and spilled, to the action's build report.

``RefreshAction`` (actions/refresh.py) rebuilds through the same
``_build_index_data``; ``RefreshIncrementalAction`` writes through
``_write_table_bucketed``.  Each source file read is an ``io.read``
span that names its format.  With ``conf.multihost_build_hosts`` >= 1
the build runs as host subprocesses under work claims instead
(``parallel/multihost_build.py``), before the Z-order and spill branches.
pyarrow is imported when a function runs.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    CoveringIndex,
    FileIdTracker,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Signature,
    Source,
    States,
)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.index.signatures import get_provider
from hyperspace_tpu_torch.io import columnar, integrity
from hyperspace_tpu_torch.io.files import remove_file, remove_tree
from hyperspace_tpu_torch.io.parquet import (
    _dtype_from_string,
    read_file,
    sort_permutation_from_codes,
    sort_permutation_host,
    write_bucket_run,
    write_bucketed,
    zorder_codes_from_order_words,
    zorder_split_chunks,
)
from hyperspace_tpu_torch.ops.hash import (
    route_partition,
    route_partition_mesh,
    route_partition_np,
)
from hyperspace_tpu_torch.ops.sort import (
    bucket_sort_permutation,
    bucket_sort_permutation_np,
)
from hyperspace_tpu_torch.ops.zorder import key64_to_codes, zorder_sort
from hyperspace_tpu_torch.parallel import mesh as parallel_mesh
from hyperspace_tpu_torch.parallel import multihost_build
from hyperspace_tpu_torch.parallel.sharded_build import bucket_group_bounds
from hyperspace_tpu_torch.plan.nodes import LogicalPlan
from hyperspace_tpu_torch.telemetry.events import CreateActionEvent
from hyperspace_tpu_torch.telemetry.trace import span
from hyperspace_tpu_torch.utils.resolver import resolve_or_raise

DATA_FILE_ID_COLUMN = "_data_file_id"  # the lineage column

# Spill directories are stamped with the building process's pid, so a
# later build can prove an orphan's owner dead before it removes the
# directory: a killed build runs no cleanup, and the directory holds a
# routed copy of the source.  One kind per build: the bucket spill and
# the Z-order two-pass build's runs.
_SPILL_DIR_KIND = "hs_build_spill_"
_ZBUILD_DIR_KIND = "hs_zbuild_"
_SPILL_DIR_KINDS = (_SPILL_DIR_KIND, _ZBUILD_DIR_KIND)


def _spill_dir_prefix(kind: str) -> str:
    return f"{kind}{os.getpid()}_"


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        pass  # EPERM: the pid exists and belongs to someone else
    return True


def reap_orphan_spill_dirs(tmp_root: Optional[str] = None) -> int:
    """Remove the spill directories of DEAD processes under ``tmp_root``
    (the temp directory by default), run at the start of every build.
    Only pid-stamped directories whose pid provably no longer exists are
    touched.  Returns how many were removed."""
    root = tmp_root or tempfile.gettempdir()
    try:
        names = os.listdir(root)
    except OSError:
        return 0
    reaped = 0
    for name in names:
        kind = next((k for k in _SPILL_DIR_KINDS if name.startswith(k)), None)
        if kind is None:
            continue
        pid_part = name[len(kind):].split("_", 1)[0]
        if not pid_part.isdigit():
            continue  # not pid-stamped: its owner cannot be proven dead
        pid = int(pid_part)
        if pid == os.getpid() or _pid_alive(pid):
            continue
        remove_tree(os.path.join(root, name), ignore_errors=True)
        reaped += 1
    return reaped


class _PrefetchReader:
    """Bounded decode-ahead over the source files: ONE reader thread
    decodes file N+1 while the consumer routes file N, holding at most
    ``depth`` decoded files (the backpressure that bounds host memory by
    batches, not by the dataset).  ``depth=0`` reads inline: the
    forced-serial reference.  ``close()`` cancels queued reads and joins
    the reader, so a failed build never races its own prefetcher."""

    def __init__(self, action: "CreateActionBase", files, columns, relation,
                 lineage: bool, depth: int,
                 spill: Optional["_BucketSpill"] = None) -> None:
        self.action = action
        self.files = list(files)
        self.columns = columns
        self.relation = relation
        self.lineage = lineage
        self.depth = max(0, int(depth))
        self.spill = spill
        self._stall_buffer_s = 0.0
        self.peak_chunks = 0  # most decoded, unconsumed files seen
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: List = []

    def _record_stall(self, seconds: float) -> None:
        """The consumer's wait on decode is the ``prefetch_s`` phase, but
        only once the build spills: a monolithic build has nothing to
        overlap, and its wait is the reader's ``read_s`` counted twice.
        Stalls before the first spill are buffered and flushed with the
        first one after it; without a spill (incremental refresh) they
        stay buffered."""
        if self.spill is None or not self.spill.spilled:
            self._stall_buffer_s += seconds
            return
        self.action._phase("prefetch_s", self._stall_buffer_s + seconds)
        self._stall_buffer_s = 0.0

    def _submit(self, f):
        return self._pool.submit(self.action._read_chunk, f, self.columns,
                                 self.relation, self.lineage)

    def __iter__(self):
        if self.depth == 0:
            for f in self.files:
                yield self.action._read_chunk(f, self.columns, self.relation,
                                              self.lineage)
            return
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="hs-prefetch")
        queue = list(self.files)
        try:
            while queue and len(self._pending) < self.depth:
                self._pending.append(self._submit(queue.pop(0)))
            while self._pending:
                self.peak_chunks = max(self.peak_chunks, sum(
                    1 for f in self._pending if f.done()))
                fut = self._pending.pop(0)
                t0 = time.perf_counter()
                t = fut.result()
                self._record_stall(time.perf_counter() - t0)
                if queue:
                    self._pending.append(self._submit(queue.pop(0)))
                yield t
            # A build that spilled late still owns its earlier stalls.
            if self.spill is not None and self.spill.spilled \
                    and self._stall_buffer_s:
                self._record_stall(0.0)
        finally:
            self.close()

    def close(self) -> None:
        futures, self._pending = self._pending, []
        for fut in futures:
            fut.cancel()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class CreateActionBase(Action):
    """Shared by create and the full refresh."""

    def __init__(self, log_manager: IndexLogManager, data_manager: IndexDataManager,
                 session, plan: LogicalPlan, config: IndexConfig) -> None:
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.session = session
        self.plan = plan
        self.config = config
        self._written_version: Optional[int] = None
        self._index_schema: Dict[str, str] = {}
        self._file_id_tracker = FileIdTracker()
        self._relation_cache = None
        # The entry a refresh rebuilds (None for create): its properties
        # carry over into the new entry.
        self._previous_entry: Optional[IndexLogEntry] = None
        # Wall seconds of this build by phase, published to
        # ``session.build_stats_log``.  The spill build's route and
        # finalize threads add to it at once, hence the lock; their sums
        # are thread seconds and may exceed the wall.
        self.build_phases: Dict[str, float] = {}
        self._phase_lock = threading.Lock()

    def _phase(self, name: str, seconds: float) -> None:
        with self._phase_lock:
            self.build_phases[name] = self.build_phases.get(name, 0.0) + seconds
        # The build report keeps the same seconds under bare phase names.
        self.build_report.add_phase(name, seconds)

    def _host_route(self, rows: int) -> bool:
        """Whether ``rows`` rows take the build's host mirror: fewer than
        the build threshold on the session's device."""
        return rows < self.conf.device_min_rows("build", self.session.device)

    def _write_index_file_sketch(self, out_dir: str,
                                 resolved: IndexConfig) -> None:
        """``_sketch.parquet`` beside the bucket files: each index file's
        min/max of the indexed columns, from the footers (the
        ``sketch_s`` phase)."""
        from hyperspace_tpu_torch.actions.data_skipping import (
            write_index_file_sketch,
        )

        t0 = time.perf_counter()
        write_index_file_sketch(out_dir, resolved.indexed_columns)
        self._phase("sketch_s", time.perf_counter() - t0)

    @property
    def conf(self) -> HyperspaceConf:
        return self.session.conf

    @property
    def index_name(self) -> str:
        return self.config.index_name

    @property
    def num_buckets(self) -> int:
        # A Z-order index is ONE Morton-ordered run: hash buckets would
        # scatter the clustering, each bucket's files spanning every
        # dimension.  Its file granularity is index_max_rows_per_file.
        if getattr(self.config, "layout", None) == "zorder":
            return 1
        return self.conf.num_buckets

    @property
    def lineage_enabled(self) -> bool:
        # A refresh pins it to the previous entry's.
        return self.conf.lineage_enabled

    def _relation(self):
        # Cached for the action's lifetime: the file listing is walked once.
        if self._relation_cache is None:
            leaves = self.plan.leaf_relations()
            if len(leaves) != 1:
                raise HyperspaceError(
                    f"Only plans over exactly one relation are supported for "
                    f"indexing; found {len(leaves)}")
            self._relation_cache = \
                self.session.source_provider_manager.get_relation(leaves[0])
        return self._relation_cache

    def _resolved_config(self) -> IndexConfig:
        schema = list(self._relation().schema())
        return IndexConfig(
            self.config.index_name,
            resolve_or_raise(self.config.indexed_columns, schema, "indexed column"),
            resolve_or_raise(self.config.included_columns, schema, "included column"),
            layout=self.config.layout)

    def _signature(self) -> Signature:
        provider_name = self.conf.signature_provider
        value = get_provider(provider_name).signature(
            self.plan,
            lambda scan: self.session.source_provider_manager
            .get_relation(scan).all_files())
        if value is None:
            raise HyperspaceError("Could not compute plan signature")
        return Signature(provider_name, value)

    def _build_log_entry(self) -> IndexLogEntry:
        resolved = self._resolved_config()
        rel_meta = self._relation().create_relation_metadata(
            self._file_id_tracker)
        # A refresh carries the previous entry's properties forward, the
        # providers' histories (Delta's deltaVersions) with them.
        prev = self._previous_entry
        properties: Dict[str, str] = dict(prev.properties) if prev else {}
        # The log version is the one end() commits at (base_id + 2).
        properties["lineage"] = str(self.lineage_enabled).lower()
        properties["indexLogVersion"] = str(self.base_id + 2)
        properties = self.session.source_provider_manager \
            .enrich_index_properties(rel_meta, properties)
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=CoveringIndex(
                indexed_columns=resolved.indexed_columns,
                included_columns=resolved.included_columns,
                num_buckets=self.num_buckets,
                schema=self._index_schema,
                properties={"layout": resolved.layout},
            ),
            content=Content.from_directory(
                self.data_manager.version_path(self._written_version),
                FileIdTracker()),
            source=Source(
                relations=[rel_meta],
                fingerprint=LogicalPlanFingerprint([self._signature()])),
            properties=properties,
        )

    # -- the build --------------------------------------------------------------
    def _build_index_data(self) -> None:
        t0 = time.perf_counter()
        # Spill directories a killed build left are reaped here, the one
        # moment a build provably needs the temp space back.
        reap_orphan_spill_dirs()
        # Digest on write follows this session's conf (the recorder is
        # process-wide).
        integrity.configure_from_conf(self.conf)
        relation = self._relation()
        resolved = self._resolved_config()
        files = relation.all_files(self._file_id_tracker)
        if not files:
            raise HyperspaceError("No source data files to index")
        batch_rows = max(1, int(self.conf.device_batch_rows))
        # A source beyond one batch spills, its chunks routed over the mesh
        # when there is one; only an explicit parallel_build="on" keeps the
        # monolithic build over the mesh, which holds the whole source.
        streaming = not (
            str(self.conf.parallel_build).lower() in ("on", "true")
            and self._use_distributed_build())
        self._phase("plan_s", time.perf_counter() - t0)
        if multihost_build.armed(self.conf):
            # Host subprocesses route and finalize under work claims; this
            # action coordinates, checks the staged union, and keeps its
            # own commit as the one transaction.
            multihost_build.run_multihost_build(
                self, files, resolved.all_columns, relation, resolved,
                self.lineage_enabled, batch_rows)
            self._publish_build_stats()
            return
        if streaming and resolved.layout == "zorder":
            self._zorder_streaming_build(files, resolved.all_columns, relation,
                                         self.lineage_enabled, resolved,
                                         batch_rows)
            self._publish_build_stats()
            return
        spill = _BucketSpill(self, resolved)
        try:
            self._stream_build(files, resolved.all_columns, relation,
                               self.lineage_enabled, resolved, batch_rows,
                               streaming, spill)
            self._publish_build_stats()
        finally:
            # Joins the route and finalize pools and removes the spill
            # directory on every exit; a no-op after a clean finish().
            spill.cleanup()

    def _publish_build_stats(self) -> None:
        log = getattr(self.session, "build_stats_log", None)
        if log is not None:
            log.append({"index": self.index_name, **self.build_phases})

    def _read_chunk(self, f, columns, relation, lineage: bool):
        """One source file's rows, read with the relation's format and
        options, its hive partition columns attached (of the relation's
        one spec, so every chunk resolves the same types).  A file
        written before a column was added to the source gets that column
        as nulls of the relation's type, as the monolithic concatenation
        would promote it.  With ``lineage`` the rows get the file's
        tracker id as ``DATA_FILE_ID_COLUMN``."""
        import pyarrow as pa

        t0 = time.perf_counter()
        with span("io.read", files=1, format=relation.read_format) as sp:
            t = read_file(f.name, columns, relation.read_format,
                          relation.options,
                          partition_roots=relation.root_paths,
                          partition_spec=relation.partition_spec())
            sp.set(rows=t.num_rows, bytes=t.nbytes)
        self._phase("read_s", time.perf_counter() - t0)
        self.build_report.add_bytes(read=t.nbytes)
        missing = [c for c in columns if c not in t.column_names]
        if missing:
            rel_schema = relation.schema()
            for c in missing:
                t = t.append_column(c, pa.nulls(
                    t.num_rows,
                    type=_dtype_from_string(rel_schema.get(c, "string"))))
        if lineage:
            t = t.append_column(DATA_FILE_ID_COLUMN, pa.array(
                np.full(t.num_rows, f.id, dtype=np.int64)))
        return t

    def _stream_build(self, files, columns, relation, lineage: bool, resolved,
                      batch_rows, streaming: bool,
                      spill: "_BucketSpill") -> None:
        """Read the source and cut it into batches of exactly
        ``batch_rows`` rows for the spill; a source that fits one batch
        never spills and takes the monolithic build, and so does every
        source when ``streaming`` is off.  The pipeline
        (prefetch, route workers, streaming finalize) changes scheduling
        only: with ``build_pipeline_enabled`` off the same functions run
        in the same order on this thread."""
        import pyarrow as pa

        depth = max(1, int(self.conf.build_prefetch_depth)) \
            if spill.pipelined else 0
        reader = _PrefetchReader(self, files, columns, relation, lineage,
                                 depth, spill)
        buffer: List = []
        buffered = 0
        try:
            for t in reader:
                buffer.append(t)
                buffered += t.num_rows
                while streaming and buffered > batch_rows:
                    combined = pa.concat_tables(buffer,
                                                promote_options="default")
                    spill.add_chunk(combined.slice(0, batch_rows))
                    rest = combined.slice(batch_rows)
                    buffer = [rest] if rest.num_rows else []
                    buffered = rest.num_rows
        finally:
            reader.close()
        if depth:
            self.build_report.properties.update(
                prefetch_depth=depth, prefetch_peak_chunks=reader.peak_chunks)
        remainder = pa.concat_tables(buffer, promote_options="default") \
            if buffer else None
        if not spill.spilled:
            self._write_table_bucketed(remainder, resolved)
            return
        if remainder is not None and remainder.num_rows:
            spill.add_chunk(remainder)
        spill.finish()

    def _zorder_streaming_build(self, files, columns, relation, lineage: bool,
                                resolved: IndexConfig, batch_rows: int) -> None:
        """The Z-order build of a source beyond one batch, two passes whose
        files equal the monolithic build's row for row:

          A. read the INDEXED columns alone.  Value-mapped types (numeric,
             temporal, bool) become order words at once, 8 bytes per row
             and column; rank-mapped ones (strings, binary, decimals) keep
             their raw chunks for ONE global rank pass, since chunk-local
             ranks do not compare across chunks.  Then the global codes,
             their order and each row's output file
             (``zorder_split_chunks`` of the codes in order), on the
             device (``_zorder_pass_a``);
          B. read the rows again and route each source file's rows to one
             Arrow IPC run per output file, the code riding along in a
             temporary column; then per output file, concatenate its runs
             in source order, sort stably by code (ties in row order, as
             the monolithic argsort) and write it.

        A source whose Parquet footers count at most ``batch_rows`` rows
        takes the monolithic build directly."""
        import pyarrow as pa

        key_cols = list(resolved.indexed_columns)
        depth = max(1, int(self.conf.build_prefetch_depth)) \
            if self.conf.build_pipeline_enabled else 0

        def build_monolithic() -> None:
            reader = _PrefetchReader(self, files, columns, relation, lineage,
                                     depth)
            try:
                table = pa.concat_tables(list(reader),
                                         promote_options="default")
            finally:
                reader.close()
            self._write_table_bucketed(table, resolved)

        footer_n = _footer_row_count(files)
        if footer_n is not None and footer_n <= batch_rows:
            build_monolithic()
            return
        # -- pass A: the global codes from the indexed columns ------------
        word_parts: List[List] = [[] for _ in key_cols]
        value_mapped: List[Optional[bool]] = [None] * len(key_cols)
        n = 0
        reader = _PrefetchReader(self, files, key_cols, relation, False, depth)
        try:
            for kt in reader:
                n += kt.num_rows
                for i, c in enumerate(key_cols):
                    arr = kt.column(c)
                    if value_mapped[i] is None:
                        value_mapped[i] = columnar.is_numeric_type(
                            kt.schema.field(c).type)
                    if value_mapped[i]:
                        word_parts[i].append(columnar.to_order_words(arr))
                    else:
                        word_parts[i].extend(arr.chunks)
        finally:
            reader.close()
        if n <= batch_rows:
            build_monolithic()
            return
        t0 = time.perf_counter()
        per_col_words = [
            np.concatenate(word_parts[i], axis=0) if value_mapped[i]
            else columnar.to_order_words(pa.chunked_array(word_parts[i]))
            for i in range(len(key_cols))]
        del word_parts
        codes, file_of_row = self._zorder_pass_a(per_col_words, n)
        del per_col_words
        self._phase("kernel_s", time.perf_counter() - t0)

        # -- pass B: route the rows to per-output-file runs ---------------
        # The code's temporary column must not collide with an indexed,
        # included or lineage column.
        z_col = "__z"
        taken = set(columns) | {DATA_FILE_ID_COLUMN}
        while z_col in taken:
            z_col += "_"
        run_dir = tempfile.mkdtemp(prefix=_spill_dir_prefix(_ZBUILD_DIR_KIND))
        schema = None
        try:
            offset = 0
            reader = _PrefetchReader(self, files, columns, relation, lineage,
                                     depth)
            try:
                for chunk_no, t in enumerate(reader):
                    if schema is None:
                        schema = t.schema
                    t0 = time.perf_counter()
                    rows = t.num_rows
                    if offset + rows > n:
                        raise HyperspaceError(
                            "Source grew between Z-order build passes; retry")
                    self._route_zorder_chunk(
                        t.append_column(z_col, pa.array(
                            codes[offset:offset + rows])),
                        file_of_row[offset:offset + rows], run_dir, chunk_no)
                    offset += rows
                    self._phase("spill_route_s", time.perf_counter() - t0)
            finally:
                reader.close()
            if offset != n:
                raise HyperspaceError(
                    "Source shrank between Z-order build passes; retry")
            del codes, file_of_row
            t0 = time.perf_counter()
            version = self.data_manager.get_next_version()
            out_dir = self.data_manager.version_path(version)
            os.makedirs(out_dir, exist_ok=True)
            names = sorted(os.listdir(run_dir))
            with ThreadPoolExecutor(max(1, min(4, len(names)))) as pool:
                list(pool.map(lambda d: self._finish_zorder_file(
                    os.path.join(run_dir, d), z_col, out_dir), names))
            self._phase("spill_finish_s", time.perf_counter() - t0)
        finally:
            remove_tree(run_dir, ignore_errors=True)
        self._write_index_file_sketch(out_dir, resolved)
        self._written_version = version
        self._index_schema = {name: str(t) for name, t in
                              zip(schema.names, schema.types)}

    def _zorder_pass_a(self, per_col_words, n: int) -> tuple:
        """``(codes, file_of_row)``: the rows' (n,) uint64 Morton codes and
        the (n,) int32 index of the output file each row goes to, files
        numbered along the curve and cut by ``zorder_split_chunks``.  The
        codes and their order come from ``_zorder_codes`` (the device at
        or above the build threshold); the cuts are found on the host."""
        codes, perm = self._zorder_codes(per_col_words)
        sorted_codes = codes[sync_guard.pull(perm, "zorder.perm")]
        chunks = zorder_split_chunks(sorted_codes, 16 * len(per_col_words),
                                     self.conf.index_max_rows_per_file)
        del sorted_codes
        counts = torch.tensor([rows for _, rows in chunks], dtype=torch.int64,
                              device=perm.device)
        file_of_sorted = torch.repeat_interleave(
            torch.arange(len(chunks), dtype=torch.int32, device=perm.device),
            counts, output_size=n)
        file_of_row = torch.empty(n, dtype=torch.int32, device=perm.device)
        file_of_row[perm] = file_of_sorted
        return codes, sync_guard.pull(file_of_row, "zorder.file_of_row")

    def _route_zorder_chunk(self, t, fids: np.ndarray, run_dir: str,
                            chunk_no: int) -> None:
        """One source file's rows (with their code column), grouped by
        output file stably, as one Arrow IPC run per output file."""
        import pyarrow as pa

        o = np.argsort(fids, kind="stable")
        sf = fids[o]
        routed = t.take(pa.array(o))
        uniq = np.unique(sf)
        starts = np.searchsorted(sf, uniq, "left")
        ends = np.searchsorted(sf, uniq, "right")
        for fid, st, en in zip(uniq, starts, ends):
            d = os.path.join(run_dir, f"file={int(fid):06d}")
            os.makedirs(d, exist_ok=True)
            self.build_report.add_bytes(spill=_write_chunk_file(
                routed, os.path.join(d, f"run-{chunk_no:05d}.arrow"),
                [(int(st), int(en - st))]), spill_runs=1)

    def _finish_zorder_file(self, d: str, z_col: str, out_dir: str) -> None:
        """One output file from its runs: concatenated in source order,
        sorted stably by code, written as bucket 0 without a further cut
        (pass A's cuts already are cell-aligned and capped)."""
        import pyarrow as pa

        bt = pa.concat_tables(
            [_read_run(os.path.join(d, r)) for r in sorted(os.listdir(d))],
            promote_options="default")
        z = bt.column(z_col).to_numpy()
        bt = bt.take(pa.array(np.argsort(z, kind="stable"))).drop_columns(
            [z_col])
        written = write_bucket_run(
            bt, 0, out_dir, 0, compression=self.conf.index_file_compression)
        self.build_report.add_bytes(
            written=sum(os.path.getsize(p) for p in written),
            files=len(written))
        remove_tree(d, ignore_errors=True)  # its runs are consumed

    def _zorder_codes(self, order_words) -> tuple:
        """The Z-order pass over per-column (n, 2) uint32 order words:
        ``(codes, perm)``, the (n,) uint64 Morton codes on the host and the
        stable permutation into Morton order, a tensor on the session's
        device at or above the build threshold (``ops.zorder.zorder_sort``)
        and the numpy mirror's, on the CPU, below it."""
        n = order_words[0].shape[0]
        if self._host_route(n):
            codes, _ = zorder_codes_from_order_words(order_words)
            return codes, torch.from_numpy(np.argsort(codes, kind="stable"))
        device = self.session.device
        key, perm = zorder_sort([torch.from_numpy(w).to(device)
                                 for w in order_words])
        return key64_to_codes(key), perm

    def _use_distributed_build(self) -> bool:
        """Whether the monolithic build takes the bucket shuffle over the
        mesh: ``conf.parallel_build`` "on", or "auto" with more than one
        local device (``parallel/mesh.local_devices``)."""
        mode = str(self.conf.parallel_build).lower()
        if mode in ("on", "true"):
            return True
        if mode in ("off", "false"):
            return False
        if mode != "auto":
            raise HyperspaceError(
                f"Invalid {self.conf.parallel_build!r} for parallel_build; "
                f"expected 'auto', 'on', or 'off'")
        return len(parallel_mesh.local_devices(self.session.device)) > 1

    def _write_table_bucketed(self, table, resolved: IndexConfig) -> None:
        device = self.session.device
        t0 = time.perf_counter()
        keys = resolved.indexed_columns
        order_words = [columnar.to_order_words(table.column(c)) for c in keys]
        split_keys = None
        if resolved.layout == "zorder":
            # No hash: the one bucket's ids are zeros where the permutation
            # lives, so write_bucketed counts them there.
            split_keys, perm = self._zorder_codes(order_words)
            buckets = torch.zeros(table.num_rows, dtype=torch.int32,
                                  device=perm.device)
        else:
            word_cols = [columnar.to_hash_words(table.column(c)) for c in keys]
            if self._use_distributed_build():
                from hyperspace_tpu_torch.parallel import (
                    distributed_bucket_sort_permutation,
                )

                # The bucket shuffle over every local device (no
                # mesh_max_devices cap, as in the JAX package); the
                # writer's histogram runs on the session's device.
                ids, perm_np = distributed_bucket_sort_permutation(
                    table, keys, self.num_buckets,
                    parallel_mesh.build_mesh(device=device))
                buckets = torch.from_numpy(ids).to(device)
                perm = torch.from_numpy(perm_np)
            elif self._host_route(table.num_rows):
                # The host mirror: the same bytes, no transfer, no launch.
                buckets, perm = (torch.from_numpy(a) for a in
                                 bucket_sort_permutation_np(
                                     word_cols, order_words, self.num_buckets))
            else:
                buckets, perm = bucket_sort_permutation(
                    [torch.from_numpy(w).to(device) for w in word_cols],
                    [torch.from_numpy(w).to(device) for w in order_words],
                    self.num_buckets)
        if perm.device.type == "cuda":
            torch.cuda.synchronize(perm.device)  # the device time lands here
        self._phase("kernel_s", time.perf_counter() - t0)
        version = self.data_manager.get_next_version()
        out_dir = self.data_manager.version_path(version)
        t0 = time.perf_counter()
        written = write_bucketed(
            table, buckets, perm, self.num_buckets, out_dir,
            max_rows_per_file=self.conf.index_max_rows_per_file,
            split_keys=split_keys, split_key_bits=16 * len(keys),
            compression=self.conf.index_file_compression)
        self._phase("write_s", time.perf_counter() - t0)
        self.build_report.add_bytes(
            written=sum(os.path.getsize(p) for p in written),
            files=len(written))
        self._write_index_file_sketch(out_dir, resolved)
        self._written_version = version
        self._index_schema = {name: str(t) for name, t in
                              zip(table.column_names, table.schema.types)}


def _write_chunk_file(routed, path: str, slices) -> int:
    """One spill file as raw Arrow IPC, one record batch per ``(offset,
    rows)`` slice: a (chunk, bucket group) file, whose finalize reads any
    bucket's run by batch index from a memory map, or one Z-order run (a
    single slice).  ``combine_chunks`` keeps each slice ONE batch, so
    batch index == slice position.  Returns the bytes written (the
    report's ``spill_bytes``)."""
    import pyarrow as pa

    with pa.OSFile(path, "wb") as sink:
        with pa.ipc.new_file(sink, routed.schema) as writer:
            for off, rows in slices:
                writer.write_table(routed.slice(off, rows).combine_chunks())
    return os.path.getsize(path)


def _read_run(path: str):
    """A whole spill file, from a memory map."""
    import pyarrow as pa

    with pa.memory_map(path, "rb") as source:
        return pa.ipc.open_file(source).read_all()


def _footer_row_count(files) -> Optional[int]:
    """The source's rows from its Parquet footers, without a decode, or
    None when a footer cannot be read."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    total = 0
    for f in files:
        try:
            total += pq.read_metadata(f.name).num_rows
        except (OSError, pa.ArrowException):
            return None
    return total


class _BucketSpill:
    """The spill build: per chunk, route + partition on the device into
    bucket-aligned Arrow runs; then per bucket group, merge and write.

    Route: each chunk's rows are ordered by (bucket, key) by
    ``route_partition``, the same hash and stable sorts as the monolithic
    build, so bucket ids and tie order cannot differ between the two.
    For value-mapped key types (numeric, temporal, bool) the rows come
    out sorted within each bucket, with their uint64 sort codes carried
    along as temporary columns; rank-mapped keys (strings, binary,
    decimals) are only grouped by bucket, because chunk-local ranks do not
    compare across chunks.  The chunk lands in ONE Arrow IPC file per
    (chunk, bucket group), one record batch per non-empty bucket.

    Finalize: once routing has drained, the bucket groups are closed and
    merged on a pool of their own: each bucket's runs, concatenated in
    chunk order, are sorted stably (by the carried codes, or by order
    words derived again) and written as Parquet, and each group's run
    files are deleted as soon as it is written.  Chunk order plus a
    stable sort reproduces the monolithic tie order exactly.

    ``build_pipeline_enabled=False`` is the forced-serial reference:
    inline routing and sequential finalize, the same functions in the
    same order, so the bytes are the same."""

    # Chunks route concurrently on multi-core hosts while the stream
    # keeps decoding; each in-flight chunk pins one batch in host memory
    # and on the device.
    _MAX_ROUTE_WORKERS = 4
    _MAX_IN_FLIGHT = 3
    _MAX_GROUPS = 8  # bucket groups: the spill-file and finalize unit

    def __init__(self, action: CreateActionBase, resolved: IndexConfig) -> None:
        self.action = action
        self.resolved = resolved
        self.spilled = False
        self.pipelined = bool(action.conf.build_pipeline_enabled)
        self._num_buckets = action.num_buckets
        self._groups = min(self._MAX_GROUPS, self._num_buckets)
        # Bucket b belongs to the group g with bounds[g] <= b < bounds[g+1]:
        # contiguous in a chunk's sorted order, so a group is one slice.
        self._bounds = bucket_group_bounds(self._num_buckets, self._groups)
        self._chunk_no = 0
        self._schema = None
        self._code_cols: tuple = ()
        self._dir: Optional[str] = None  # made at the first spill
        self._pool: Optional[ThreadPoolExecutor] = None
        self._futures: List = []
        # bucket -> [(chunk_no, path, batch_index)], and the run files of
        # each group; route workers append concurrently.
        self._manifest_lock = threading.Lock()
        self._runs: Dict[int, List] = {}
        self._group_files: Dict[int, List[str]] = {}
        # Streaming close: the groups close when the LAST route job lands
        # after end of input, possibly on a route worker while finish()
        # still joins earlier futures.
        self._close_lock = threading.Lock()
        self._routes_pending = 0
        self._input_done = False
        self._closed = False
        self._route_failed = False
        self._finalize_pool: Optional[ThreadPoolExecutor] = None
        self._finalize_futures: List = []
        self._out_dir: Optional[str] = None
        self._mesh = None  # resolved at the first route
        self._mesh_probed = False

    def _route_pool(self) -> Optional[ThreadPoolExecutor]:
        if not self.pipelined:
            return None
        cores = os.cpu_count() or 1
        if self._pool is None and cores > 1:
            self._pool = ThreadPoolExecutor(
                max_workers=min(self._MAX_ROUTE_WORKERS, cores),
                thread_name_prefix="hs-route")
        return self._pool

    def _drain(self) -> None:
        """Wait for the route jobs in flight; raise the first failure."""
        futures, self._futures = self._futures, []
        for fut in futures:
            fut.result()

    def _drain_finalize(self) -> None:
        """Wait for the group finalize jobs in flight; raise the first
        failure."""
        futures, self._finalize_futures = self._finalize_futures, []
        for fut in futures:
            fut.result()

    def cleanup(self) -> None:
        # On the failure path the original error is raised right after
        # this, so a second failure seen while draining is dropped, an
        # injected crash of another worker included: the spill directory
        # below must go whatever the workers raised.
        try:
            self._drain()
        except BaseException:  # noqa: BLE001
            pass
        try:
            self._drain_finalize()
        except BaseException:  # noqa: BLE001
            pass
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._finalize_pool is not None:
            self._finalize_pool.shutdown(wait=True)
            self._finalize_pool = None
        if self._dir is not None:
            remove_tree(self._dir, ignore_errors=True)
            self._dir = None

    def _plan_code_columns(self, table) -> tuple:
        """Names of the carried sort-code columns (one uint64 per indexed
        column), or () when any key type is rank-mapped."""
        key_cols = list(self.resolved.indexed_columns)
        for c in key_cols:
            if not columnar.is_numeric_type(table.schema.field(c).type):
                return ()
        taken = set(table.column_names)
        names = []
        for i in range(len(key_cols)):
            name = f"__hs_sort{i}"
            while name in taken:
                name += "_"
            taken.add(name)
            names.append(name)
        return tuple(names)

    def add_chunk(self, table) -> None:
        if self._dir is None:
            self._dir = tempfile.mkdtemp(
                prefix=_spill_dir_prefix(_SPILL_DIR_KIND))
        self.spilled = True
        if self._schema is None:
            self._schema = table.schema
            self._code_cols = self._plan_code_columns(table)
        chunk_no = self._chunk_no
        self._chunk_no += 1
        pool = self._route_pool()
        if pool is None:
            self._route_chunk(table, chunk_no)
            return
        while len(self._futures) >= self._MAX_IN_FLIGHT:
            self._futures.pop(0).result()
        with self._close_lock:
            self._routes_pending += 1
        self._futures.append(pool.submit(self._route_traced, table, chunk_no))

    def _route_traced(self, table, chunk_no: int) -> None:
        """Route one chunk on a worker, and close the groups when this was
        the LAST route job after end of input, so the finalize starts while
        finish() still joins futures."""
        ok = False
        try:
            self._route_chunk(table, chunk_no)
            ok = True
        finally:
            fire = False
            with self._close_lock:
                self._routes_pending -= 1
                if not ok:
                    self._route_failed = True
                elif self._input_done and self._routes_pending == 0 \
                        and not self._closed and not self._route_failed:
                    self._closed = True
                    fire = True
            if fire:
                self._close_groups()

    def _active_mesh(self):
        """The mesh of this build's chunk routes, resolved once
        (``parallel/mesh.active_mesh``; None: the single device).  Two
        route threads that race here resolve the same mesh."""
        if not self._mesh_probed:
            self._mesh = parallel_mesh.active_mesh(
                self.action.conf, self.action.session.device)
            self._mesh_probed = True
        return self._mesh

    def _route_chunk(self, table, chunk_no: int) -> None:
        import pyarrow as pa

        t0 = time.perf_counter()
        key_cols = list(self.resolved.indexed_columns)
        word_cols = [columnar.to_hash_words(table.column(c)) for c in key_cols]
        codes64 = [columnar.to_order_codes64(table.column(c))
                   for c in key_cols] if self._code_cols else []
        if self.action._host_route(table.num_rows):
            # The host mirror, as in the monolithic build: the same bytes.
            buckets, perm = route_partition_np(word_cols, codes64,
                                               self._num_buckets)
            counts = np.bincount(buckets, minlength=self._num_buckets)
        elif (mesh := self._active_mesh()) is not None:
            # Over the mesh: each shard owns the buckets b % n; the same
            # (perm, counts), so the same runs.
            perm, counts = route_partition_mesh(
                word_cols, [columnar.split_words64(k) for k in codes64],
                self._num_buckets, mesh)
            ms = (time.perf_counter() - t0) * 1000.0
            report = self.action.build_report
            report.properties["mesh_devices"] = mesh.size
            for position in range(mesh.size):
                report.add_device_kernel_ms(position, ms)
        else:
            perm, counts = route_partition(
                word_cols, [columnar.split_words64(k) for k in codes64],
                self._num_buckets, self.action.session.device)
        if int(counts.sum()) != table.num_rows:
            raise HyperspaceError(
                f"bucket counts of chunk {chunk_no} sum to {int(counts.sum())}, "
                f"the chunk has {table.num_rows} rows")
        routed = table.take(pa.array(perm))
        for i, name in enumerate(self._code_cols):
            routed = routed.append_column(name, pa.array(codes64[i][perm]))
        starts = np.zeros(self._num_buckets, dtype=np.int64)
        np.cumsum(counts[:-1], out=starts[1:])
        self._write_chunk_runs(routed, chunk_no, starts, starts + counts)
        self.action._phase("spill_route_s", time.perf_counter() - t0)

    def _write_chunk_runs(self, routed, chunk_no: int, starts, ends) -> None:
        """One Arrow IPC file per (chunk, bucket group), one record batch
        per non-empty bucket.  The run files are read back once and
        deleted, so they skip the Parquet encode."""
        for gid in range(self._groups):
            b0, b1 = self._bounds[gid], self._bounds[gid + 1]
            present = [b for b in range(b0, b1) if ends[b] > starts[b]]
            if not present:
                continue
            path = os.path.join(self._dir,
                                f"chunk-{chunk_no:05d}-g{gid:03d}.arrow")
            nbytes = _write_chunk_file(
                routed, path, [(int(starts[b]), int(ends[b] - starts[b]))
                               for b in present])
            with self._manifest_lock:
                for bi, b in enumerate(present):
                    self._runs.setdefault(b, []).append((chunk_no, path, bi))
                self._group_files.setdefault(gid, []).append(path)
            self.action.build_report.add_bytes(spill=nbytes,
                                               spill_runs=len(present))

    def _finalize_pool_get(self) -> ThreadPoolExecutor:
        if self._finalize_pool is None:
            # At most one worker per core: the finalize is CPU-bound
            # (merge and Parquet encode); one worker still streams.
            workers = max(1, min(int(self.action.conf.build_finalize_workers),
                                 os.cpu_count() or 1))
            self._finalize_pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="hs-finalize")
        return self._finalize_pool

    def _close_groups(self) -> None:
        """Every routed bucket group is closed: queue each on the finalize
        pool, or, in the serial reference, finish them in order.  May run
        on a route worker."""
        with self._manifest_lock:
            gids = sorted(self._group_files)
        if self.pipelined:
            pool = self._finalize_pool_get()
            self._finalize_futures.extend(
                pool.submit(self._finish_group, gid) for gid in gids)
        else:
            for gid in gids:
                self._finish_group(gid)

    def _finish_group(self, gid: int) -> None:
        """Merge and write every bucket of one closed group, then delete
        the group's run files, so spill space goes back while other
        groups still hold theirs."""
        import pyarrow as pa

        t0 = time.perf_counter()
        conf = self.action.conf
        b0, b1 = self._bounds[gid], self._bounds[gid + 1]
        with self._manifest_lock:
            paths = list(self._group_files.get(gid, ()))
            buckets = sorted(b for b in self._runs if b0 <= b < b1)
        readers = {}
        handles = []
        try:
            for p in paths:
                mm = pa.memory_map(p, "rb")
                handles.append(mm)
                readers[p] = pa.ipc.open_file(mm)
            for b in buckets:
                with self._manifest_lock:
                    runs = sorted(self._runs[b])  # chunk order = tie order
                btable = pa.Table.from_batches(
                    [readers[p].get_batch(bi) for _, p, bi in runs])
                if self._code_cols:
                    perm = sort_permutation_from_codes(btable, self._code_cols)
                    btable = btable.take(pa.array(perm)).drop_columns(
                        list(self._code_cols))
                else:
                    perm = sort_permutation_host(
                        btable, self.resolved.indexed_columns)
                    btable = btable.take(pa.array(perm))
                written = write_bucket_run(
                    btable, b, self._out_dir, conf.index_max_rows_per_file,
                    compression=conf.index_file_compression)
                self.action.build_report.add_bytes(
                    written=sum(os.path.getsize(p) for p in written),
                    files=len(written))
        finally:
            for mm in handles:
                mm.close()
        for p in paths:
            remove_file(p, missing_ok=True)
        self.action._phase("spill_finish_s", time.perf_counter() - t0)

    def finish(self) -> None:
        action = self.action
        # The version directory exists BEFORE end of input is announced:
        # the first finalize worker may start while route futures drain.
        version = action.data_manager.get_next_version()
        out_dir = action.data_manager.version_path(version)
        os.makedirs(out_dir, exist_ok=True)
        self._out_dir = out_dir
        fire = False
        with self._close_lock:
            self._input_done = True
            if self._routes_pending == 0 and not self._closed \
                    and not self._route_failed:
                self._closed = True
                fire = True
        if fire:
            self._close_groups()
        self._drain()  # raises the first route failure
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        # The exposed finalize tail: how long the build still waits on
        # the group writes after routing drained (``finalize_s``; the
        # group work itself is ``spill_finish_s`` on the pool's threads).
        t0 = time.perf_counter()
        try:
            self._drain_finalize()
        finally:
            if self.pipelined:
                action._phase("finalize_s", time.perf_counter() - t0)
        if self._finalize_pool is not None:
            self._finalize_pool.shutdown(wait=True)
            self._finalize_pool = None
        remove_tree(self._dir, ignore_errors=True)
        self._dir = None
        action._write_index_file_sketch(out_dir, self.resolved)
        action._written_version = version
        action._index_schema = {name: str(t) for name, t in
                                zip(self._schema.names, self._schema.types)}


class CreateAction(CreateActionBase):
    event_class = CreateActionEvent
    transient_state = States.CREATING
    final_state = States.ACTIVE

    def validate(self) -> None:
        if self.previous_log_entry is not None and \
                self.previous_log_entry.state != States.DOESNOTEXIST:
            raise HyperspaceError(
                f"Another index with name {self.config.index_name!r} already "
                f"exists in state {self.previous_log_entry.state}")
        leaves = self.plan.leaf_relations()
        if len(leaves) != 1 or not \
                self.session.source_provider_manager.is_supported_relation(leaves[0]):
            raise HyperspaceError("Only plans over one supported file-based "
                                  "relation can be indexed")
        self._resolved_config()  # raises on unresolvable columns

    def log_entry_for_begin(self) -> IndexLogEntry:
        # The index data is not written yet: content is the (empty) index
        # directory.
        resolved = self._resolved_config()
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=CoveringIndex(
                indexed_columns=resolved.indexed_columns,
                included_columns=resolved.included_columns,
                num_buckets=self.num_buckets,
                schema={},
            ),
            content=Content.from_directory(self.data_manager.index_path,
                                           FileIdTracker()),
            source=Source(
                relations=[self._relation().create_relation_metadata(FileIdTracker())],
                fingerprint=LogicalPlanFingerprint([self._signature()])),
        )

    def op(self) -> None:
        self._build_index_data()

    def log_entry(self) -> IndexLogEntry:
        return self._build_log_entry()
