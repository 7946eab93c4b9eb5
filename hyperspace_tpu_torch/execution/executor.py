"""Physical execution of a plan into an arrow table (counterpart of
hyperspace_tpu/execution/executor.py).

Numeric work runs on the session's device: a predicate over null-free
numeric columns as the torch closure of ``ops.filter.compile_predicate``,
the match pairs of an equi-join on one numeric key by
``ops.join.sorted_equi_join`` (composite and string keys by
``hashed_equi_join``), a GROUP BY on int or bool keys by
``ops.aggregate.grouped_aggregate``.  Strings, nulls and division stay on
the arrow host path, which owns SQL's three-valued logic.  Below
``conf.device_min_rows(kind)`` rows a filter, join or aggregate takes
the host route instead (the arrow predicate, ``sorted_equi_join_np``,
arrow's group-by); by default the threshold is calibrated for the
session's device (``utils/calibrate.py``).
No device error is caught to answer from the host instead.

An aggregate over an inner equi-join on one numeric key (the TPC-H
Q3/Q10 shape) reads both sides whole and runs the fused
``ops.join_agg.join_group_aggregate``: the joined rows stay on the
device and only per-group results come back; under ``ORDER BY
<aggregate> LIMIT n`` only the top n groups.  A shape it does not take
after reading the sides (a string key, nulls, ``count(a / b)``) is
joined on the host and aggregated from there.

A join whose sides are ``(Project|Filter)*`` chains over index scans
with matching bucket specs runs bucket by bucket: equal keys meet only
inside one bucket, so each per-bucket join reads and joins 1/B of the
data; up to 8 buckets run at once on the shared thread pool.  A side may
also be a hybrid scan's ``BucketUnion(index chain, appended files)``:
the appended rows are routed into the index's buckets by the build's
bucket hash on the session's device (the hash kernel on the card), and
each bucket joins its index files followed by its routed rows.

A ``Union`` or ``BucketUnion`` executed whole concatenates its children
in order, by name; a strict one promotes nulls only.

The analytic operators, as in the JAX package: ``Compute`` and
``WithColumns`` evaluate their expressions with arrow; ``Distinct`` is
arrow's group-by over every column (no fixed row order); ``SetOp``
codes both sides' rows null-safely and keeps the distinct left rows in
order.  A ``Window`` takes the device route when ``_try_device_window``
takes it (a whole-partition aggregate over one int or bool key, reduced
by ``ops.aggregate.grouped_aggregate``), else the host engine
``_window``: one arrow stable sort, ``ops.window``'s segment functions
on CPU tensors, the column scattered back to the input's order.

Scan semantics: ``relation.file_paths`` replaces the listing of the root
paths (index scans, hybrid subsets); ``relation.prune_to_buckets`` drops
index files whose bucket id (from the file name) is not wanted.  A source
scan reads its relation's format (Parquet, CSV, JSON, ORC, Avro, text)
with its options, and its hive partition columns from the paths below
its root paths (io/partitions.py); an index scan never has them.

Identity and residency: every scan's output table is registered with
the fingerprint of the files it read (``device_cache.files_fingerprint``:
paths, sizes, mtimes), a column selection and a window keep it (not the
window's own column), and a filter's output and a join side without its
null keys get a derived fingerprint (the parent's hashed with
``filter:<condition>`` or ``dropnull:<keys>``).  A scan of another
format than Parquet, with options, or with partition columns hashes its
format, options and partition spec into the fingerprint too.
A column of an identified table is converted and uploaded once per
(device, fingerprint, column, kind) into the process-wide
``device_cache.global_cache()``, and later queries over the same files
take it from there (``_device_column``).  Routing follows the JAX
package: an operation whose every input column is resident (or, under
the "eager" policy, cacheable) compares its rows with
``conf.resident_min_rows`` instead of ``conf.device_min_rows``.

``stats`` records per scan the files and rows read, per filter and per
join kernel the route taken ("device" or "host"), its rows and whether
its inputs were resident, per join "bucketed" (with whether a side was
hybrid), "plain" or "device-fused-agg" (with ``resident``), per device
aggregate "device-segment" or "device-join-agg" (with its groups,
``resident`` and ``topn``), per device window "device-segment" (with
its rows, groups and ``resident``) and, when the cache was consulted,
``device_cache`` hits and misses; ``Dataset.collect`` publishes it as
``session.last_execution_stats``.

``IsNull`` is evaluated on the arrow path only, and so is ``BucketIn``,
the quarantine containment's filter: its rows' buckets come from the
build's hash on the session's device (the hash kernel on the card) from
``device_min_rows("build")`` rows, from the host mirror below
(``stats["bucket_in"]`` records the route).

A read of index files that fails with ``OSError`` or pyarrow's
``ArrowException`` is noted in ``index_read_failures``, for
``Dataset.collect``'s containment (execution/containment.py); the error
still propagates.

A join's ``residual`` (an inequality correlation of a rewritten
subquery) filters the matched pairs on the arrow path before the join
type shapes the output; such a join takes the plain route, never the
bucket-aligned join or the fused join→aggregate.  ``Cast``, ``Case``,
``Extract``, the string functions and the string predicates are
evaluated on the arrow path only, as in the JAX package.

Each executed scan appends its IO (files read and listed, bytes) to
``stats["scans"]`` and to the active run report (telemetry/report.py).
Every read-back of a device result goes through
``execution/sync_guard.pull``/``scalar``, so the strict guard passes and
``exec.transfer.d2h.bytes`` counts it; each operator's entry and exit
are deadline checks (utils/deadline.py).

A scan of a lake table (Delta) without ``file_paths`` reads the files of
its provider's snapshot, never a listing of its directory, in their
physical format (Parquet); so do the row estimates.

With a mesh of logical shards (``parallel/mesh.active_mesh``, resolved
once per collect: at least 2 local devices under ``conf.mesh_enabled``),
five routes run over its shards from their own thresholds, each on host
columns (the shards are their own placement, so the column cache is not
read), each with the single-device route's answer: a device filter
splits its columns row-wise ("device-mesh", from
``mesh_filter_min_rows``); a join on one numeric key partitions both
sides by key ownership ("mesh" join kernel, from
``mesh_join_min_rows``); a bucket-aligned INNER join on one numeric
bucket column gives bucket ``b`` to shard ``b % n`` ("bucketed-mesh",
from ``mesh_join_min_rows`` rows by the footers); a GROUP BY partitions
its rows by group-key ownership ("mesh-segment", from
``mesh_agg_min_rows``); and the fused join->aggregate without top-n runs
as three mesh stages ("mesh-fused-agg" / "mesh-join-agg", from
``mesh_join_min_rows``).  ``mesh_enabled="off"``, or one device, keeps
every route above.  pyarrow is imported inside the functions.
"""

from __future__ import annotations

import hashlib
import math
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.execution.device_cache import (
    files_fingerprint,
    global_cache,
)
from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.io.files import list_data_files
from hyperspace_tpu_torch.io.parquet import (
    bucket_id_of_file,
    read_schema,
    read_table,
    schema_to_arrow,
)
from hyperspace_tpu_torch.io.partitions import partition_spec_for_roots
from hyperspace_tpu_torch.plan.expr import (
    And,
    Arith,
    BinOp,
    BucketIn,
    Case,
    Cast,
    Col,
    Expr,
    Extract,
    IsIn,
    IsNull,
    Lit,
    Neg,
    Not,
    Or,
    StringFn,
    StringMatch,
    as_equi_join_pairs,
)
from hyperspace_tpu_torch.plan.nodes import (
    Aggregate,
    BucketUnion,
    Compute,
    Distinct,
    Filter,
    InMemory,
    Join,
    Limit,
    LogicalPlan,
    Project,
    Scan,
    SetOp,
    Sort,
    Union,
    Window,
    WithColumns,
)
from hyperspace_tpu_torch.sources.interfaces import (
    LAKE_DATA_FORMATS,
    physical_read_format,
)
from hyperspace_tpu_torch.telemetry import report as run_report
from hyperspace_tpu_torch.telemetry import timeline
from hyperspace_tpu_torch.telemetry.trace import span
from hyperspace_tpu_torch.utils import deadline as _deadline


class Executor:
    def __init__(self, session) -> None:
        self.session = session
        self.stats: Dict[str, list] = {"joins": [], "scans": []}
        # File identity of the tables of THIS query, for the device
        # column cache: id(table) -> (fingerprint, cacheable column
        # names, the table itself, so that its id is not reused).
        self._scan_fp: Dict[int, Tuple[str, frozenset, object]] = {}
        # The per-query hit and miss counts are updated from the bucketed
        # join's worker threads.
        self._cache_lock = threading.Lock()
        # (index name, paths) of each read of index files that failed with
        # a read error (``containment.is_read_error``): what
        # Dataset.collect's containment takes, and nothing else.
        self.index_read_failures: List[Tuple[str, List[str]]] = []
        # The mesh of logical shards, resolved once per executor (one
        # collect): ``conf.mesh_enabled`` gates every sharded route below;
        # None keeps the single-device paths.
        self._mesh_cache: Tuple[bool, object] = (False, None)

    def _active_mesh(self):
        probed, mesh = self._mesh_cache
        if not probed:
            from hyperspace_tpu_torch.parallel.mesh import active_mesh

            mesh = active_mesh(self.session.conf, self.session.device)
            self._mesh_cache = (True, mesh)
        return mesh

    def _read_index_files(self, rel, paths, read):
        """``read()``, which reads ``paths`` of ``rel``; a read error of
        index files is noted in ``index_read_failures`` and raised."""
        try:
            return read()
        except Exception as e:
            from hyperspace_tpu_torch.execution.containment import (
                is_read_error,
            )

            if rel.index_scan_of is not None and is_read_error(e):
                with self._cache_lock:
                    self.index_read_failures.append(
                        (rel.index_scan_of, list(paths)))
            raise

    # -- device column cache ------------------------------------------------
    def _register_scan_identity(self, table, paths, salt: str = "") -> None:
        conf = self.session.conf
        if conf.device_cache_policy == "off" or conf.device_cache_bytes <= 0:
            return
        fp = files_fingerprint(paths)
        if fp and salt:
            fp = hashlib.md5(f"{fp}|{salt}".encode()).hexdigest()
        if fp:
            self._scan_fp[id(table)] = (fp, frozenset(table.column_names),
                                        table)

    def _scan_identity(self, table) -> Optional[Tuple[str, frozenset]]:
        entry = self._scan_fp.get(id(table))
        return (entry[0], entry[1]) if entry is not None else None

    def _register_derived_identity(self, out, parent_identity,
                                   transform: str) -> None:
        """Identity of a table derived from an identified one by a
        deterministic transform (a filter, a drop of null keys): the
        parent's fingerprint hashed with the transform's text, so the
        repeat of a query addresses the same cached columns, and another
        predicate or file set addresses others."""
        if parent_identity is None or out is None:
            return
        fp, cacheable = parent_identity
        derived = hashlib.md5(f"{fp}|{transform}".encode()).hexdigest()
        self._scan_fp[id(out)] = (
            derived, cacheable & frozenset(out.column_names), out)

    def _propagate_identity(self, out, parent, replaced=()) -> None:
        """A column selection, or a window appending its column, keeps
        its parent's rows and arrays, so it keeps the parent's
        fingerprint; a column of ``replaced`` holds new values and is no
        longer cacheable under it."""
        entry = self._scan_fp.get(id(parent))
        if entry is None or out is None:
            return
        fp, cacheable, _table = entry
        self._scan_fp[id(out)] = (
            fp, (cacheable - frozenset(replaced))
            & frozenset(out.column_names), out)

    def _cache_key(self, identity, column: str, kind: str):
        if identity is None:
            return None
        fp, cacheable = identity
        return (str(self.session.device), fp, column, kind) \
            if column in cacheable else None

    def _all_resident(self, identity, pairs) -> bool:
        """Whether every (column, kind) pair is cached for ``identity``."""
        cache = global_cache()
        keys = [self._cache_key(identity, c, k) for c, k in pairs]
        return bool(keys) and all(k is not None and cache.contains(k)
                                  for k in keys)

    def _device_column(self, table, column: str, identity=None,
                       kind: str = "num") -> "np.ndarray | torch.Tensor":
        """The column in its device domain (``to_device_numeric``; the
        "order" kind of the JAX package's group keys is the same int64
        domain here): a tensor on the session's device from the cache
        when the table's file identity is known (a miss converts,
        uploads and caches it), else the host array, which the device op
        uploads."""
        key = self._cache_key(identity, column, kind)
        if key is None:
            return columnar.to_device_numeric(table.column(column))
        cache = global_cache()
        tensor = cache.get(key)
        with self._cache_lock:
            counters = self.stats.setdefault("device_cache",
                                             {"hits": 0, "misses": 0})
            counters["hits" if tensor is not None else "misses"] += 1
        if tensor is not None:
            return tensor
        host = columnar.to_device_numeric(table.column(column))
        tensor = torch.from_numpy(np.require(host, requirements="CW")) \
            .to(self.session.device)
        timeline.record_transfer("h2d", tensor.nbytes)
        cache.put(key, tensor, self.session.conf.device_cache_bytes)
        return tensor

    def _cache_aware_min_rows(self, identity, pairs, kind: str) -> int:
        """The routing threshold: ``device_min_rows(kind)``, or the lower
        ``resident_min_rows(kind)`` when every input pair is cached for
        this identity, or under "eager" when every one can be (no
        computed column, none the budget rejected)."""
        conf = self.session.conf
        device = self.session.device
        min_rows = conf.device_min_rows(kind, device)
        if identity is None:
            return min_rows
        cache = global_cache()
        keys = [self._cache_key(identity, c, k) for c, k in pairs]
        eager_all_cacheable = (
            conf.device_cache_policy == "eager"
            and all(k is not None and not cache.was_rejected(k)
                    for k in keys))
        if eager_all_cacheable or self._all_resident(identity, pairs):
            return min(min_rows, conf.resident_min_rows(kind, device))
        return min_rows

    def finalize_stats(self) -> None:
        """Close one query's stats: the peak host RSS and, when the query
        ran on a CUDA device, the bytes allocated there, into
        ``stats["memory"]`` and the ``mem.host.peak_rss_mb`` and
        ``mem.device.live_bytes`` gauges.  Once per collect()."""
        from hyperspace_tpu_torch.telemetry import metrics

        mem: Dict[str, float] = {}
        try:
            import resource

            mem["peak_rss_mb"] = round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                / 1024.0, 1)
            metrics.set_gauge("mem.host.peak_rss_mb", mem["peak_rss_mb"])
        except Exception:  # noqa: BLE001 - non-POSIX platform
            pass
        device = self.session.device
        on_card = ("device", "mesh", "bucketed-mesh")
        touched_device = bool(
            self.stats.get("device_cache")
            or any(j.get("strategy", "").startswith(on_card)
                   for j in self.stats.get("joins", []))
            or any(a.get("strategy", "").startswith(on_card)
                   for a in self.stats.get("aggregates", [])))
        if touched_device and device.type == "cuda":
            live = int(torch.cuda.memory_allocated(device))
            mem["device_live_bytes"] = live
            metrics.set_gauge("mem.device.live_bytes", live)
        if mem:
            self.stats["memory"] = mem

    def execute(self, plan: LogicalPlan):
        # Each operator is one interval on the timeline's "exec" lane
        # (one bool check with the timeline off).  Its entry and its exit
        # are both deadline boundaries (utils/deadline.py): the entry
        # checks run on the way down, within microseconds of each other,
        # so only the exit check stops the work stacked above a long
        # scan once the scan spent the budget.
        t0 = timeline.op_begin()
        out = self._execute_node(plan)
        timeline.op_end("exec", type(plan).__name__, t0)
        _deadline.check(type(plan).__name__)
        return out

    def _execute_node(self, plan: LogicalPlan):
        _deadline.check(type(plan).__name__)
        hypothetical = [s.relation.index_scan_of
                        for s in plan.leaf_relations()
                        if s.relation.hypothetical]
        if hypothetical:
            # A what-if plan (advisor/hypothetical.py): its index scans
            # have no file, and running one would answer empty.
            raise HyperspaceError(
                f"Plan contains a hypothetical index scan "
                f"({hypothetical[0]!r}); what-if plans are for analysis "
                f"only and can never execute")
        if isinstance(plan, InMemory):
            return plan.table
        if isinstance(plan, Scan):
            return self._scan(plan)
        if isinstance(plan, Filter):
            return self._filter(plan)
        if isinstance(plan, Project):
            if isinstance(plan.child, Scan):
                # Read only the projected columns from disk.
                return self._scan(plan.child, columns=plan.columns)
            table = self.execute(plan.child)
            out = table.select(plan.columns)
            self._propagate_identity(out, table)
            return out
        if isinstance(plan, Compute):
            import pyarrow as pa

            table = self.execute(plan.child)
            return pa.table({name: _eval_column(e, table)
                             for name, e in plan.exprs})
        if isinstance(plan, WithColumns):
            table = self.execute(plan.child)
            for name, e in plan.exprs:
                column = _eval_column(e, table)
                if name in table.column_names:
                    table = table.set_column(
                        table.column_names.index(name), name, column)
                else:
                    table = table.append_column(name, column)
            return table
        if isinstance(plan, Join):
            return self._join(plan)
        if isinstance(plan, Window):
            table = self.execute(plan.child)
            out = self._try_device_window(table, plan)
            if out is None:
                out = _window(table, plan)
            # The appended column keeps the rows and the source arrays:
            # the identity carries, so a chained window still routes by
            # residency.
            self._propagate_identity(out, table, replaced=(plan.name,))
            return out
        if isinstance(plan, Aggregate):
            return self._aggregate(plan)
        if isinstance(plan, Distinct):
            table = self.execute(plan.child)
            names = table.column_names
            if len(set(names)) != len(names):
                raise ValueError(
                    f"distinct() needs unique column names, got {names}; "
                    f"project/rename the duplicates first")
            if table.num_rows == 0:
                return table
            return table.group_by(names).aggregate([]).select(names)
        if isinstance(plan, Sort):
            return _sorted_table(self.execute(plan.child), plan.keys)
        if isinstance(plan, Limit):
            return self._limit(plan)
        if isinstance(plan, SetOp):
            return self._set_op(plan)
        if isinstance(plan, (BucketUnion, Union)):
            import pyarrow as pa

            tables = [self.execute(c) for c in plan.children]
            # BucketUnion merges an index with its own source's rows: a
            # width mismatch there is schema drift and must raise.
            promote = "permissive" if isinstance(plan, Union) \
                and not plan.strict else "default"
            return pa.concat_tables(tables, promote_options=promote)
        raise ValueError(f"Unknown plan node: {type(plan).__name__}")

    # -- scan ---------------------------------------------------------------
    def _scan(self, plan: Scan, columns: Optional[List[str]] = None):
        with span("exec.scan") as sp:
            out = self._scan_inner(plan, columns, sp)
            sp.set(rows=out.num_rows)
            return out

    def _scan_inner(self, plan: Scan, columns, sp):
        rel = plan.relation
        read_format = physical_read_format(rel.file_format)
        lake_relation = None
        if rel.file_paths is not None:
            paths = list(rel.file_paths)
        elif rel.file_format.lower() in LAKE_DATA_FORMATS:
            # A lake table's files are its snapshot's: a listing would
            # also see the removed and overwritten files and the log.
            lake_relation = self.session.source_provider_manager \
                .get_relation(plan)
            paths = [f.name for f in lake_relation.all_files()]
        else:
            paths = [f.name for f in list_data_files(rel.root_paths)]
        all_paths = paths
        if rel.prune_to_buckets is not None:
            wanted = set(rel.prune_to_buckets)
            paths = [p for p in paths
                     if (b := bucket_id_of_file(p)) is None or b in wanted]
        bytes_read = 0
        for p in paths:
            try:
                bytes_read += os.path.getsize(p)
            except OSError:
                pass  # read_table raises a better error for a missing file
        record = {
            "relation": rel.index_scan_of or ",".join(rel.root_paths),
            "is_index": bool(rel.index_scan_of),
            "files_read": len(paths),
            "files_listed": len(all_paths),
            "bytes_read": bytes_read,
        }
        self.stats["scans"].append(record)
        sp.set(**record)
        run_report.record("scan", **record)
        # Source scans read hive partition columns from the paths below
        # their roots; index scans never do (v__=N is no partition).
        roots = rel.root_paths if rel.index_scan_of is None else None
        spec = partition_spec_for_roots(roots) if roots else {}
        if not paths:
            # Every file pruned: an empty table that keeps the schema, so
            # the nodes above still resolve their columns.
            import pyarrow as pa

            if all_paths:
                schema = read_schema(all_paths[0], read_format,
                                     rel.options_dict)
                for k, t in spec.items():
                    schema.setdefault(k, t)
                empty = schema_to_arrow(schema).empty_table()
            elif lake_relation is not None:
                # A lake table with no file left keeps the schema of its
                # metadata.
                empty = schema_to_arrow(lake_relation.schema()).empty_table()
            else:
                empty = pa.table({})
            return empty.select(columns) if columns else empty
        out = self._read_index_files(rel, paths, lambda: read_table(
            paths, read_format, columns, rel.options_dict,
            partition_roots=roots, partition_spec=spec))
        if columns:
            out = out.select(columns)
        record["rows"] = out.num_rows
        # Another format, its options or the partition spec give other
        # columns from the same files: they key other cached columns.
        plain = rel.file_format == "parquet" and not rel.options and not spec
        self._register_scan_identity(out, paths, "" if plain else repr(
            (read_format, rel.options, sorted(spec.items()))))
        return out

    # -- filter -------------------------------------------------------------
    def _filter(self, plan: Filter):
        import pyarrow as pa

        table = self.execute(plan.child)
        if table.num_rows == 0:
            return table
        out = table.filter(pa.array(self._eval_predicate(plan.condition, table)))
        # The kept rows are a function of the files and the predicate.
        self._register_derived_identity(out, self._scan_identity(table),
                                        f"filter:{plan.condition!r}")
        return out

    def _eval_predicate(self, expr: Expr, table) -> np.ndarray:
        """The device path needs at least one column, every referenced
        column numeric and null-free, and ``device_min_rows("filter")``
        rows (or the resident threshold); all else takes the arrow path.
        With a mesh, ``mesh_filter_min_rows`` rows also open it (else a
        device threshold above the mesh's would hide the mesh route), and
        from there the columns are split over the mesh's shards."""
        cols = expr.referenced_columns()
        identity = self._scan_identity(table)
        pairs = [(c, "num") for c in cols]
        min_rows = self._cache_aware_min_rows(identity, pairs, "filter")
        mesh = self._active_mesh()
        if mesh is not None:
            min_rows = min(min_rows, self.session.conf.mesh_filter_min_rows)
        on_device = bool(cols) \
            and table.num_rows >= min_rows \
            and all(columnar.is_numeric_type(table.schema.field(c).type)
                    and table.column(c).null_count == 0 for c in cols) \
            and _device_compatible(expr, table)
        if on_device:
            # The mesh takes host columns (its shards are its own
            # placement), so it never reads the column cache.
            use_mesh = mesh is not None and table.num_rows \
                >= self.session.conf.mesh_filter_min_rows
            resident = not use_mesh and self._all_resident(identity, pairs)
            mask = self._eval_device(expr, table, identity,
                                     mesh if use_mesh else None)
            self.stats.setdefault("filters", []).append({
                "strategy": "device-mesh" if use_mesh else "device",
                "rows": table.num_rows, "resident": resident})
            return mask
        self.stats.setdefault("filters", []).append({
            "strategy": "host", "rows": table.num_rows})
        return _eval_arrow(expr, table, self._bucket_ids)

    def _bucket_ids(self, table, columns, num_buckets: int) -> np.ndarray:
        """The build's bucket of every row of ``table`` over ``columns``
        (a ``BucketIn``): by ``ops.hash.bucket_ids`` on the session's
        device (the hash kernel on the card) from
        ``device_min_rows("build")`` rows, by the bit-equal host mirror
        ``bucket_ids_np`` below.  A null key hashes to the build's null
        bucket."""
        from hyperspace_tpu_torch.ops.hash import bucket_ids, bucket_ids_np

        word_cols = [columnar.to_hash_words(table.column(c)) for c in columns]
        device = self.session.device
        on_device = table.num_rows >= \
            self.session.conf.device_min_rows("build", device)
        if on_device:
            uploaded = [torch.from_numpy(w).to(device) for w in word_cols]
            timeline.record_transfer("h2d", sum(w.nbytes for w in uploaded))
            ids = sync_guard.pull(bucket_ids(uploaded, num_buckets),
                                  "bucket_in.bucket_ids")
        else:
            ids = bucket_ids_np(word_cols, num_buckets)
        self.stats.setdefault("bucket_in", []).append({
            "strategy": "device" if on_device else "host",
            "rows": table.num_rows})
        return ids

    def _eval_device(self, expr: Expr, table, identity,
                     mesh=None) -> np.ndarray:
        from hyperspace_tpu_torch.ops.aggregate import to_device
        from hyperspace_tpu_torch.ops.filter import compile_predicate

        order = sorted(expr.referenced_columns())
        fn, literals = compile_predicate(_normalize_literals(expr, table), order)
        if mesh is not None:
            from hyperspace_tpu_torch.parallel.filter import (
                eval_predicate_on_mesh,
            )

            return eval_predicate_on_mesh(
                fn, [columnar.to_device_numeric(table.column(c))
                     for c in order], literals, mesh)
        device = self.session.device
        cols = [to_device(self._device_column(table, c, identity, "num"),
                          device) for c in order]
        t0 = timeline.kernel_begin(device)
        mask = fn(cols, literals)
        timeline.kernel_end("filter", t0, mask)
        return sync_guard.pull(mask, "filter.mask")

    # -- join ---------------------------------------------------------------
    def _join(self, plan: Join, _record: bool = True):
        with span("exec.join", how=plan.how) as sp:
            joins_mark = len(self.stats["joins"])
            bucketed = self._try_bucketed_join(plan)
            if bucketed is not None:
                if len(self.stats["joins"]) > joins_mark:
                    sp.set(strategy=self.stats["joins"][joins_mark]
                           .get("strategy"))
                sp.set(rows=bucketed.num_rows)
                return bucketed
            if _record:
                self.stats["joins"].append({"strategy": "plain",
                                            "how": plan.how})
            sp.set(strategy="plain")
            out = self._host_join_tables(self.execute(plan.left),
                                         self.execute(plan.right),
                                         plan.condition, plan.how,
                                         plan.residual)
            sp.set(rows=out.num_rows)
            return out

    def _host_join_tables(self, left, right, condition: Expr, how: str,
                          residual: Optional[Expr] = None):
        """Join two tables.  Match pairs come from the inner equi-join
        over the rows whose keys are all valid (null keys never match),
        then, with a ``residual``, only the pairs it holds true for; the
        join type then shapes the output from them: null extension by
        arrow's null-index take, existence joins by membership."""
        import pyarrow as pa

        pairs = as_equi_join_pairs(condition)
        if pairs is None:
            raise ValueError(f"Non-equi join condition: {condition!r}")
        l_keys, r_keys = [], []
        for a, b in pairs:
            if a in left.column_names and b in right.column_names:
                l_keys.append(a)
                r_keys.append(b)
            elif b in left.column_names and a in right.column_names:
                l_keys.append(b)
                r_keys.append(a)
            else:
                raise ValueError(f"Join columns {a!r}/{b!r} not found")
        # Outer and anti joins still emit null-key rows: keep positions.
        l_map = _valid_key_positions(left, l_keys)
        r_map = _valid_key_positions(right, r_keys)
        lv = left if len(l_map) == left.num_rows else left.take(pa.array(l_map))
        rv = right if len(r_map) == right.num_rows else right.take(pa.array(r_map))
        # The rows with valid keys are a function of the files and the
        # key columns: the sides keep a derived identity.
        if lv is not left:
            self._register_derived_identity(
                lv, self._scan_identity(left), f"dropnull:{l_keys}")
        if rv is not right:
            self._register_derived_identity(
                rv, self._scan_identity(right), f"dropnull:{r_keys}")
        li, ri = self._inner_match_pairs(lv, rv, l_keys, r_keys)
        li = l_map[li] if len(l_map) != left.num_rows else li
        ri = r_map[ri] if len(r_map) != right.num_rows else ri
        if residual is not None and len(li):
            # A pair whose residual is false or null is no match, so an
            # anti join keeps exactly the left rows with no surviving
            # match (NOT EXISTS as SQL reads it).
            combined = _concat_horizontal(left.take(pa.array(li)),
                                          right.take(pa.array(ri)))
            mask = _eval_arrow(residual, combined, self._bucket_ids)
            li, ri = li[mask], ri[mask]

        if how == "inner":
            return _concat_horizontal(left.take(pa.array(li)),
                                      right.take(pa.array(ri)))
        if how == "semi":
            return left.take(pa.array(np.unique(li)))
        if how == "anti":
            mask = np.ones(left.num_rows, dtype=bool)
            mask[li] = False
            return left.filter(pa.array(mask))
        # Outer joins: matched pairs first, then each preserved side's
        # unmatched rows, null-extended (a null index takes a null row).
        l_parts, r_parts = [li], [ri]
        l_masks = [np.zeros(len(li), dtype=bool)]
        r_masks = [np.zeros(len(ri), dtype=bool)]
        if how in ("left", "full"):
            unmatched = np.setdiff1d(np.arange(left.num_rows), li)
            l_parts.append(unmatched)
            r_parts.append(np.zeros(len(unmatched), dtype=ri.dtype))
            l_masks.append(np.zeros(len(unmatched), dtype=bool))
            r_masks.append(np.ones(len(unmatched), dtype=bool))
        if how in ("right", "full"):
            unmatched = np.setdiff1d(np.arange(right.num_rows), ri)
            l_parts.append(np.zeros(len(unmatched), dtype=li.dtype))
            r_parts.append(unmatched)
            l_masks.append(np.ones(len(unmatched), dtype=bool))
            r_masks.append(np.zeros(len(unmatched), dtype=bool))
        l_idx = pa.array(np.concatenate(l_parts), mask=np.concatenate(l_masks))
        r_idx = pa.array(np.concatenate(r_parts), mask=np.concatenate(r_masks))
        return _concat_horizontal(left.take(l_idx), right.take(r_idx))

    def _inner_match_pairs(self, left, right, l_keys: List[str],
                           r_keys: List[str]):
        """(left_indices, right_indices) of the inner matches between two
        tables whose keys hold no null, as int64 numpy arrays."""
        from hyperspace_tpu_torch.ops.join import (
            UnsupportedJoinKeys,
            hashed_equi_join,
            sorted_equi_join,
            sorted_equi_join_np,
        )

        max_rows = max(left.num_rows, right.num_rows)
        cold = self.session.conf.device_min_rows("join",
                                                 self.session.device)
        if (len(l_keys) == 1
                and columnar.is_numeric_type(left.schema.field(l_keys[0]).type)
                and columnar.is_numeric_type(right.schema.field(r_keys[0]).type)):
            # The cold threshold, or the resident one when both key
            # columns are cached for their (maybe filter-derived) sides.
            id_l = self._scan_identity(left)
            id_r = self._scan_identity(right)
            pl = [(l_keys[0], "num")]
            pr = [(r_keys[0], "num")]
            use_device = max_rows >= cold
            if not use_device:
                eff = max(self._cache_aware_min_rows(id_l, pl, "join"),
                          self._cache_aware_min_rows(id_r, pr, "join"))
                use_device = eff < cold and max_rows >= eff
            resident = use_device and self._all_resident(id_l, pl) \
                and self._all_resident(id_r, pr)
            # With a mesh, from its own threshold, the key space is split
            # over the shards by key ownership (host keys: cached tensors
            # keep the single-device join).  The same match set.
            mesh = self._active_mesh()
            use_mesh = mesh is not None and not resident \
                and max_rows >= self.session.conf.mesh_join_min_rows
            if use_mesh:
                from hyperspace_tpu_torch.ops.join import (
                    sorted_equi_join_mesh,
                )

                li, ri = sorted_equi_join_mesh(
                    columnar.to_device_numeric(left.column(l_keys[0])),
                    columnar.to_device_numeric(right.column(r_keys[0])),
                    mesh)
            elif use_device:
                lk = self._device_column(left, l_keys[0], id_l, "num")
                rk = self._device_column(right, r_keys[0], id_r, "num")
                li, ri = sorted_equi_join(lk, rk, self.session.device)
            else:
                li, ri = sorted_equi_join_np(
                    columnar.to_device_numeric(left.column(l_keys[0])),
                    columnar.to_device_numeric(right.column(r_keys[0])))
            self.stats.setdefault("join_kernels", []).append({
                "strategy": "mesh" if use_mesh
                else ("device" if use_device else "host"),
                "rows": int(max_rows), "resident": resident})
            return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)
        # Composite or string keys: the digest join with exact
        # verification; pandas only for key pairs with no common domain.
        use_device = max_rows >= cold
        try:
            li, ri = hashed_equi_join(
                left, right, l_keys, r_keys,
                self.session.device if use_device else None)
            return np.asarray(li, dtype=np.int64), np.asarray(ri, dtype=np.int64)
        except UnsupportedJoinKeys:
            ldf = left.to_pandas()
            rdf = right.to_pandas()
            ldf["__li"] = np.arange(len(ldf))
            rdf["__ri"] = np.arange(len(rdf))
            merged = ldf.merge(rdf, left_on=l_keys, right_on=r_keys,
                               how="inner", suffixes=("", "__r"))
            return (merged["__li"].to_numpy(dtype=np.int64),
                    merged["__ri"].to_numpy(dtype=np.int64))

    def _try_bucketed_join(self, plan: Join):
        """Join bucket by bucket when both sides are (Project|Filter)*
        chains over index scans with matching bucket specs, or hybrid
        ``BucketUnion``s of such a chain and appended rows (what
        JoinIndexRule builds).  An outer or anti join joins a bucket only
        one side has against a zero-row table of the other side, so its
        unmatched rows are emitted as the plain path would.  A join with
        a residual takes the plain path: the per-bucket joins below are
        equi-joins."""
        import pyarrow as pa

        from hyperspace_tpu_torch.utils.parallel_map import parallel_map_ordered

        if plan.residual is not None:
            return None
        precheck = bucketed_join_precheck(self.session, plan)
        if precheck is None:
            return None
        left_side, right_side, l_files, r_files = precheck
        scans_mark = len(self.stats["scans"])
        l_parts = self._side_bucket_parts(left_side, l_files)
        r_parts = None if l_parts is None \
            else self._side_bucket_parts(right_side, r_files)
        shared = [] if l_parts is None or r_parts is None \
            else sorted(set(l_parts) & set(r_parts))
        if not shared:
            # A side that could not be routed, or no bucket on both
            # sides: the plain path gives the right answer, null
            # extension and the joined schema included.  What the
            # probing read is not counted twice.
            del self.stats["scans"][scans_mark:]
            return None
        extra_left = sorted(set(l_parts) - set(r_parts)) \
            if plan.how in ("left", "full", "anti") else []
        extra_right = sorted(set(r_parts) - set(l_parts)) \
            if plan.how in ("right", "full") else []
        hybrid = bool(left_side.appended or right_side.appended)
        meshed = self._try_mesh_bucketed_join(
            plan, left_side, right_side, l_parts, r_parts, shared,
            extra_left or extra_right, hybrid, l_files, r_files)
        if meshed is not None:
            return meshed
        self.stats["joins"].append({
            "strategy": "bucketed",
            "how": plan.how,
            "buckets": len(shared) + len(extra_left) + len(extra_right),
            "hybrid": hybrid,
        })
        # The zero-row donors come from one shared bucket, read once and
        # reused for that bucket's own join.
        pre = {}
        l_donor = r_donor = None
        if extra_left or extra_right:
            donor = shared[0]
            lt0 = self.execute(l_parts[donor]())
            rt0 = self.execute(r_parts[donor]())
            pre[donor] = (lt0, rt0)
            l_donor, r_donor = lt0.slice(0, 0), rt0.slice(0, 0)

        def join_bucket(bucket: int):
            if bucket in extra_left:
                sub = Join(l_parts[bucket](), InMemory(r_donor),
                           plan.condition, plan.how)
            elif bucket in extra_right:
                sub = Join(InMemory(l_donor), r_parts[bucket](),
                           plan.condition, plan.how)
            elif bucket in pre:
                lt, rt = pre[bucket]
                sub = Join(InMemory(lt), InMemory(rt), plan.condition, plan.how)
            else:
                sub = Join(l_parts[bucket](), r_parts[bucket](),
                           plan.condition, plan.how)
            # Per-bucket scans carry no bucket spec: the plain path.
            return self._join(sub, _record=False)

        parts = parallel_map_ordered(
            join_bucket, sorted(shared + extra_left + extra_right),
            max_workers=8)
        return pa.concat_tables(parts, promote_options="default")

    def _try_mesh_bucketed_join(self, plan: Join, left_side, right_side,
                                l_parts, r_parts, shared, one_sided: bool,
                                hybrid: bool, l_files, r_files):
        """The per-bucket joins over the mesh instead of the thread pool:
        bucket ``b`` goes to shard ``b % n`` (the mod ownership the
        sharded build writes with), and ``copartitioned_join_ragged``
        joins each shard's buckets with no exchange, since equal keys
        share a bucket.  Strategy "bucketed-mesh".

        Only an INNER join on one numeric key (the single bucket column),
        with no bucket on one side only, with a mesh, and with at least
        ``mesh_join_min_rows`` rows by the index files' Parquet footers
        (read before anything is decoded: a join under the threshold
        keeps the pool's bounded memory, since the mesh route holds every
        bucket at once).  None otherwise."""
        import pyarrow as pa
        import pyarrow.compute as pc

        if plan.how != "inner" or one_sided:
            return None
        mesh = self._active_mesh()
        if mesh is None:
            return None
        pairs = as_equi_join_pairs(plan.condition)
        if pairs is None or len(pairs) != 1:
            return None
        names = []
        for side in (left_side, right_side):
            name = side.scan.relation.bucket_spec[1][0]
            stored = {k.lower(): v for k, v in
                      self.session.schema_map_of(side.scan).items()}
            if name.lower() not in stored or not columnar.is_numeric_type(
                    schema_to_arrow({"c": stored[name.lower()]})
                    .field(0).type):
                return None
            names.append(name)
        if _footer_row_estimate(l_files, shared) \
                + _footer_row_estimate(r_files, shared) \
                < self.session.conf.mesh_join_min_rows:
            return None

        from hyperspace_tpu_torch.parallel.join import (
            copartitioned_join_ragged,
        )
        from hyperspace_tpu_torch.telemetry import metrics
        from hyperspace_tpu_torch.utils.parallel_map import parallel_map_ordered

        l_tabs = parallel_map_ordered(lambda b: self.execute(l_parts[b]()),
                                      shared, max_workers=8)
        r_tabs = parallel_map_ordered(lambda b: self.execute(r_parts[b]()),
                                      shared, max_workers=8)
        # The executed tables' spelling of the key (the spec's columns
        # match case-insensitively).
        lk_name = _find_column(l_tabs[0], names[0])
        rk_name = _find_column(r_tabs[0], names[1])
        if lk_name is None or rk_name is None:
            return pa.concat_tables(
                [self._join(Join(InMemory(lt), InMemory(rt), plan.condition,
                                 plan.how))
                 for lt, rt in zip(l_tabs, r_tabs)],
                promote_options="default")
        # A null key never matches an inner join.
        l_tabs = [t.filter(pc.is_valid(t.column(lk_name)))
                  if t.column(lk_name).null_count else t for t in l_tabs]
        r_tabs = [t.filter(pc.is_valid(t.column(rk_name)))
                  if t.column(rk_name).null_count else t for t in r_tabs]
        owned = [[i for i, b in enumerate(shared) if b % mesh.size == d]
                 for d in range(mesh.size)]
        l_shard_tabs = [pa.concat_tables([l_tabs[i] for i in g]) if g
                        else l_tabs[0].slice(0, 0) for g in owned]
        r_shard_tabs = [pa.concat_tables([r_tabs[i] for i in g]) if g
                        else r_tabs[0].slice(0, 0) for g in owned]
        dev_ids, l_local, r_local = copartitioned_join_ragged(
            [columnar.to_device_numeric(t.column(lk_name))
             for t in l_shard_tabs],
            [columnar.to_device_numeric(t.column(rk_name))
             for t in r_shard_tabs], mesh)
        metrics.set_gauge("exec.mesh.devices", mesh.size)
        self.stats["joins"].append({
            "strategy": "bucketed-mesh", "how": plan.how,
            "buckets": len(shared), "devices": mesh.size, "hybrid": hybrid})
        bounds = np.searchsorted(dev_ids, np.arange(mesh.size + 1), "left")
        parts = [_concat_horizontal(
            l_shard_tabs[d].take(pa.array(l_local[bounds[d]:bounds[d + 1]])),
            r_shard_tabs[d].take(pa.array(r_local[bounds[d]:bounds[d + 1]])))
            for d in range(mesh.size) if bounds[d + 1] > bounds[d]]
        if not parts:
            return _concat_horizontal(l_shard_tabs[0].slice(0, 0),
                                      r_shard_tabs[0].slice(0, 0))
        return pa.concat_tables(parts, promote_options="default")

    def _side_bucket_parts(self, side: "_BucketedSide", by_bucket):
        """bucket id -> zero-argument function making that bucket's
        sub-plan for one join side, or None when the side's appended rows
        cannot be routed.  A bucket's sub-plan reads its index files
        followed by its routed appended rows."""
        appended_by_bucket: Dict = {}
        if side.appended is not None:
            num_buckets, cols, _ = side.scan.relation.bucket_spec
            routed = self._route_to_buckets(self.execute(side.appended), cols,
                                            num_buckets, side.scan)
            if routed is None:
                return None
            appended_by_bucket = routed

        def make(bucket: int) -> LogicalPlan:
            parts: List[LogicalPlan] = []
            if bucket in by_bucket:
                parts.append(_rewrap(side.scan, side.inner, by_bucket[bucket]))
            if bucket in appended_by_bucket:
                parts.append(InMemory(appended_by_bucket[bucket]))
            node = parts[0] if len(parts) == 1 else Union(parts, strict=True)
            for w in reversed(side.outer):
                node = w.with_children((node,))
            return node

        return {b: (lambda b=b: make(b))
                for b in set(by_bucket) | set(appended_by_bucket)}

    def _route_to_buckets(self, table, cols, num_buckets: int,
                          index_scan: Scan) -> Optional[Dict]:
        """``table``'s rows by the index's bucket, each bucket's rows in
        table order.  The bucket ids come from the build's hash on the
        session's device (the hash kernel on the card; bit-equal to the
        host mirror ``bucket_ids_np``).  Key columns are cast to the
        index's stored type first: the hash reads raw bits, so an int64
        row hashed as float64 would land in another bucket.  None when a
        key column is missing or does not cast."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from hyperspace_tpu_torch.ops.hash import bucket_ids

        if table.num_rows == 0:
            return {}
        by_lower = {c.lower(): c for c in table.column_names}
        stored = {k.lower(): v
                  for k, v in self.session.schema_map_of(index_scan).items()}
        word_cols = []
        for c in cols:
            name = by_lower.get(c.lower())
            if name is None:
                return None
            column = table.column(name)
            stored_type = stored.get(c.lower())
            if stored_type is not None and str(column.type) != stored_type:
                target = schema_to_arrow({"c": stored_type}).field(0).type
                try:
                    column = pc.cast(column, target)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError,
                        pa.ArrowTypeError):
                    return None
            word_cols.append(torch.from_numpy(np.ascontiguousarray(
                columnar.to_hash_words(column))).to(self.session.device))
        timeline.record_transfer("h2d", sum(w.nbytes for w in word_cols))
        ids = sync_guard.pull(bucket_ids(word_cols, num_buckets),
                              "hybrid_route.bucket_ids")
        # A stable sort by bucket keeps each bucket's rows in table order.
        order = np.argsort(ids, kind="stable")
        present, starts, counts = np.unique(ids[order], return_index=True,
                                            return_counts=True)
        routed = table.take(pa.array(order))
        return {int(b): routed.slice(int(s), int(n))
                for b, s, n in zip(present, starts, counts)}

    # -- sort / limit -------------------------------------------------------
    def _limit(self, plan: Limit):
        """The first ``n`` rows.  Over ``Sort(Aggregate)`` ordered by an
        aggregate, the fused top-N join→aggregate ranks the groups on the
        device; over any other Sort, ``pc.select_k_unstable`` selects
        the n rows instead of sorting them all (a key with nulls takes
        the full sort, for Spark's null order)."""
        import pyarrow.compute as pc

        child = plan.child
        if isinstance(child, Sort) and plan.n > 0:
            if isinstance(child.child, Aggregate):
                fused = self._topn_join_aggregate(child.child, child, plan.n)
                if fused is not None:
                    return fused
            table = self.execute(child.child)
            if table.num_rows == 0:
                return table  # select_k rejects a zero-row input
            if any(table.column(c).null_count > 0 for c, _ in child.keys):
                return _sorted_table(table, child.keys).slice(0, plan.n)
            idx = pc.select_k_unstable(
                table, k=min(plan.n, table.num_rows),
                sort_keys=[(c, "ascending" if asc else "descending")
                           for c, asc in child.keys])
            return table.take(idx)
        return self.execute(child).slice(0, plan.n)

    # -- set operations -----------------------------------------------------
    def _set_op(self, plan: SetOp):
        """INTERSECT or EXCEPT with SQL's null-safe row equality: both
        sides stacked into one promoted table, every row given a dense
        null-safe code (``ops.window.partition_codes``), membership one
        ``torch.isin``; the distinct kept rows in left-row order (each
        at its first occurrence)."""
        import pyarrow as pa

        from hyperspace_tpu_torch.ops.window import partition_codes

        left = self.execute(plan.left)
        right = self.execute(plan.right)
        if len(left.column_names) != len(right.column_names):
            raise ValueError(
                f"{plan.kind.upper()} needs equal column counts: "
                f"{left.column_names} vs {right.column_names}")
        stacked = pa.concat_tables(
            [left, right.rename_columns(left.column_names)],
            promote_options="permissive")
        if stacked.num_rows == 0:
            return stacked
        codes = partition_codes(stacked, stacked.column_names)
        ca, cb = codes[:left.num_rows], codes[left.num_rows:]
        in_b = torch.isin(ca, cb)
        kept_rows = torch.nonzero(in_b if plan.kind == "intersect"
                                  else ~in_b).flatten()
        if kept_rows.numel() == 0:
            return stacked.slice(0, 0)
        _, inverse = torch.unique(ca[kept_rows], return_inverse=True)
        groups = int(sync_guard.scalar(inverse.max(), "setop.groups")) + 1
        first = torch.full((groups,), kept_rows.numel(),
                           dtype=torch.int64).scatter_reduce_(
            0, inverse, torch.arange(kept_rows.numel()), "amin")
        rows = torch.sort(kept_rows[first]).values
        return stacked.take(pa.array(sync_guard.pull(rows, "setop.rows")))

    # -- window on the device -----------------------------------------------
    def _try_device_window(self, table, plan: Window):
        """A whole-partition window aggregate (``sum(x) OVER (PARTITION
        BY k)``) through ``ops.aggregate.grouped_aggregate`` on the
        session's device: only per-group results come back, broadcast to
        the rows by one host ``np.searchsorted`` over the ascending group
        keys.  It takes one null-free int or bool partition key, sum,
        min, max, mean or count, a null-free int or float value (count
        reads only the key), no ORDER BY and no frame, and routes by the
        "agg" threshold as ``_try_device_aggregate`` does; None for the
        host engine."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from hyperspace_tpu_torch.ops.aggregate import grouped_aggregate

        if (plan.frame is not None or plan.order_by
                or len(plan.partition_by) != 1
                or plan.func not in ("sum", "min", "max", "mean", "count")
                or table.num_rows == 0):
            return None
        key = plan.partition_by[0]
        kt = table.schema.field(key).type
        if not (pa.types.is_integer(kt) or pa.types.is_boolean(kt)) \
                or pa.types.is_uint64(kt) or table.column(key).null_count > 0:
            return None
        pairs = [(key, "order")]
        src_type = None
        if plan.func == "count":
            # A null-free value's count is the group's row count: only
            # the key ships, and the value stays out of ``pairs``.
            if plan.value is not None \
                    and table.column(plan.value).null_count > 0:
                return None
        else:
            src_type = table.schema.field(plan.value).type
            if not (pa.types.is_integer(src_type)
                    or pa.types.is_floating(src_type)) \
                    or pa.types.is_uint64(src_type) \
                    or table.column(plan.value).null_count > 0:
                return None
            pairs.append((plan.value, "num"))
        identity = self._scan_identity(table)
        if table.num_rows < self._cache_aware_min_rows(identity, pairs, "agg"):
            return None
        resident = self._all_resident(identity, pairs)
        key_cols = [self._device_column(table, key, identity, "order")]
        value_cols = [] if plan.func == "count" else [
            self._device_column(table, plan.value, identity, "num")]
        first_rows, counts, results = grouped_aggregate(
            key_cols, value_cols,
            ["count_all" if plan.func == "count" else plan.func],
            device=self.session.device)
        group_keys = columnar.to_device_numeric(
            table.column(key).take(pa.array(first_rows)))
        rows = columnar.to_device_numeric(table.column(key))
        idx = pa.array(np.searchsorted(group_keys, rows))  # keys ascend
        if plan.func == "count":
            out = pa.array(counts.astype(np.int64))
        elif plan.func in ("min", "max"):
            out = pc.cast(pa.array(results[0]), src_type)
        elif plan.func == "mean":
            out = pa.array(results[0].astype(np.float64))
        else:  # sum: int64 or float64, by the device result's dtype
            out = pa.array(results[0])
        out = out.take(idx)
        self.stats.setdefault("windows", []).append({
            "strategy": "device-segment", "rows": table.num_rows,
            "groups": int(len(counts)), "resident": resident})
        if plan.name in table.column_names:
            return table.set_column(
                table.column_names.index(plan.name), plan.name, out)
        return table.append_column(plan.name, out)

    # -- aggregate ----------------------------------------------------------
    def _aggregate(self, plan: Aggregate):
        with span("exec.aggregate", groups=len(plan.group_by)) as sp:
            attempt = self._try_join_aggregate(plan)
            if attempt is None:
                out = self._aggregate_on_table(plan, self.execute(plan.child))
            else:
                kind, payload = attempt
                if kind == "done":
                    sp.set(strategy="fused_join_agg", rows=payload.num_rows)
                    return payload
                # The sides were read for the attempt and joined on the
                # host.
                out = self._aggregate_on_table(plan, payload)
            sp.set(rows=out.num_rows)
            return out

    def _aggregate_on_table(self, plan: Aggregate, table):
        """Aggregate a table: grouped on the device when
        ``_try_device_aggregate`` takes it, else by arrow's group-by; a
        global aggregation is one row computed per spec."""
        import pyarrow as pa
        import pyarrow.compute as pc

        # The identity of the table as read: the hidden columns appended
        # below are computed per query and never cacheable.
        identity = self._scan_identity(table)
        # Expression inputs become hidden columns first, so the
        # reductions see plain columns.
        agg_inputs: List = []
        for i, (_func, agg_in, _out) in enumerate(plan.aggs):
            if isinstance(agg_in, Expr) and not isinstance(agg_in, Col):
                name = f"__agg_in_{i}"
                while name in table.column_names:
                    name += "_"
                table = table.append_column(name, _eval_column(agg_in, table))
                agg_inputs.append(name)
            elif isinstance(agg_in, Col):
                agg_inputs.append(agg_in.name)
            else:
                agg_inputs.append(agg_in)
        specs = [([] if func == "count_all" else agg_inputs[i], func)
                 for i, (func, _in, _out) in enumerate(plan.aggs)]
        if plan.group_by:
            device = self._try_device_aggregate(table, plan, agg_inputs,
                                                identity)
            if device is not None:
                return device
            keys = list(plan.group_by)
            out = table.group_by(keys).aggregate(specs)
            # Output columns by position, from arrow's layout: the keys
            # are one block at the front (pyarrow >= 8) or the back, in
            # group_by order; the aggregates fill the other positions in
            # spec order.  Matching by name could swap a key named like
            # an automatic aggregate name ("v_sum").
            names = out.column_names
            nk = len(keys)
            if names[:nk] == keys:
                key_idx, agg_idx = list(range(nk)), list(range(nk, len(names)))
            elif names[-nk:] == keys:
                key_idx = list(range(len(names) - nk, len(names)))
                agg_idx = list(range(len(names) - nk))
            else:
                raise AssertionError(
                    f"Unrecognized group-by output layout {names} for keys "
                    f"{keys}")
            assert len(agg_idx) == len(plan.aggs)
            data = {k: out.column(i) for k, i in zip(keys, key_idx)}
            for (_f, _c, out_name), i in zip(plan.aggs, agg_idx):
                data[out_name] = out.column(i)
            return pa.table(data)
        names, values = [], []
        for i, (func, _in, out_name) in enumerate(plan.aggs):
            if func == "count_all":
                value = table.num_rows
            elif func == "count":
                value = table.num_rows - table.column(agg_inputs[i]).null_count
            else:
                value = getattr(pc, func)(table.column(agg_inputs[i])).as_py()
            names.append(out_name)
            values.append(value)
        return pa.table({n: [v] for n, v in zip(names, values)})

    def _try_device_aggregate(self, table, plan: Aggregate,
                              agg_inputs: List[str], identity=None):
        """A GROUP BY on the device (``ops.aggregate.grouped_aggregate``),
        or None for the arrow route.  It needs ``device_min_rows("agg")``
        rows (the resident threshold when its columns are cached for
        ``identity``), integer or bool group keys without nulls (float
        keys would split arrow's one NaN group by bit pattern), null-free
        int or float inputs, and only sum/min/max/mean/count/count_all.
        Groups come back in ascending key order (GROUP BY leaves the
        order open, as on the arrow route).  With a mesh, from
        ``mesh_agg_min_rows`` rows, the rows are split over its shards by
        group-key ownership (``grouped_aggregate_mesh``, strategy
        "mesh-segment"); that threshold also opens the device route."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from hyperspace_tpu_torch.ops.aggregate import (
            AGG_OPS,
            grouped_aggregate,
            grouped_aggregate_mesh,
        )

        if table.num_rows == 0:
            return None
        pairs = [(k, "order") for k in plan.group_by] + [
            (agg_inputs[i], "num")
            for i, (func, _in, _out) in enumerate(plan.aggs)
            if func not in ("count", "count_all")]
        min_rows = self._cache_aware_min_rows(identity, pairs, "agg")
        mesh = self._active_mesh()
        if mesh is not None:
            min_rows = min(min_rows, self.session.conf.mesh_agg_min_rows)
        if table.num_rows < min_rows:
            return None
        if any(func not in AGG_OPS for func, _i, _o in plan.aggs):
            return None
        for k in plan.group_by:
            t = table.schema.field(k).type
            # uint64 is out: the device domain is int64.
            if not (pa.types.is_integer(t) or pa.types.is_boolean(t)) \
                    or pa.types.is_uint64(t) or table.column(k).null_count > 0:
                return None
        for i, (func, _in, _out) in enumerate(plan.aggs):
            if func == "count_all":
                continue
            column = table.column(agg_inputs[i])
            if func == "count":
                # The group's row count, so only without nulls; any type.
                if column.null_count > 0:
                    return None
                continue
            # Strictly int or float: a temporal min/max would not cast
            # back, and a bool sum is uint64 on the arrow route.
            t = column.type
            if not (pa.types.is_integer(t) or pa.types.is_floating(t)) \
                    or pa.types.is_uint64(t) or column.null_count > 0:
                return None
        ops = [f for f, _i, _o in plan.aggs]
        value_inputs = [agg_inputs[i]
                        for i, (func, _in, _out) in enumerate(plan.aggs)
                        if func not in ("count", "count_all")]
        use_mesh = mesh is not None \
            and table.num_rows >= self.session.conf.mesh_agg_min_rows
        if use_mesh:
            # Host columns: the mesh's shards are its own placement, so
            # the column cache is not read.
            resident = False
            first_rows, counts, results = grouped_aggregate_mesh(
                [columnar.to_device_numeric(table.column(k))
                 for k in plan.group_by],
                [columnar.to_device_numeric(table.column(c))
                 for c in value_inputs], ops, mesh)
        else:
            resident = self._all_resident(identity, pairs)
            key_cols = [self._device_column(table, k, identity, "order")
                        for k in plan.group_by]
            # One column per aggregate that is not a count.
            value_cols = [self._device_column(table, c, identity, "num")
                          for c in value_inputs]
            first_rows, counts, results = grouped_aggregate(
                key_cols, value_cols, ops, device=self.session.device)
        self.stats.setdefault("aggregates", []).append({
            "strategy": "mesh-segment" if use_mesh else "device-segment",
            "groups": int(len(first_rows)), "rows": table.num_rows,
            "resident": resident})
        # Only the key columns are gathered.
        taken = table.select(list(plan.group_by)).take(pa.array(first_rows))
        data = {k: taken.column(k) for k in plan.group_by}
        for i, ((func, _in, out_name), res) in enumerate(zip(plan.aggs,
                                                             results)):
            if func in ("count", "count_all"):
                data[out_name] = pa.array(counts.astype(np.int64))
            elif func in ("min", "max"):
                # A reduction returns one of the values: the input's type.
                data[out_name] = pc.cast(
                    pa.array(res), table.schema.field(agg_inputs[i]).type)
            elif func == "mean":
                data[out_name] = pa.array(res.astype(np.float64))
            else:  # sum: int64 or float64, arrow's own sum types
                data[out_name] = pa.array(res)
        return pa.table(data)

    # -- fused join→aggregate (Q3/Q10 on the device) -------------------------
    _JOIN_AGG_OPS = ("sum", "min", "max", "mean", "count", "count_all")

    def _topn_join_aggregate(self, agg: Aggregate, sort: Sort, n: int):
        """ORDER BY <aggregate> LIMIT n over a fused join→aggregate: the
        ranking runs on the device too, so only n groups come back.  None
        when it does not apply."""
        if len(sort.keys) != 1:
            return None
        key, asc = sort.keys[0]
        agg_index = next((i for i, (_f, _in, out) in enumerate(agg.aggs)
                          if out == key), None)
        if agg_index is None:  # ordered by a group column
            return None
        attempt = self._try_join_aggregate(
            agg, topn=(agg_index, bool(asc), int(n)))
        if attempt is None:
            return None
        kind, payload = attempt
        table = payload if kind == "done" \
            else self._aggregate_on_table(agg, payload)
        # The exact sort of the (at most n) groups decides ties.
        return _sorted_table(table, sort.keys).slice(0, n)

    def _static_column_type(self, node, name: str):
        """The arrow type of ``name`` in ``node``'s output when known
        without executing anything (Filter/Project/Sort/Limit chains over
        a Scan or InMemory); None otherwise."""
        while True:
            if isinstance(node, (Filter, Sort, Limit)):
                node = node.child
                continue
            if isinstance(node, Project):
                if name not in node.columns:
                    return None
                node = node.child
                continue
            if isinstance(node, InMemory):
                if name not in node.table.column_names:
                    return None
                return node.table.schema.field(name).type
            if isinstance(node, Scan):
                types = {k.lower(): v for k, v in
                         self.session.schema_map_of(node).items()}
                t = types.get(name.lower())
                return schema_to_arrow({"c": t}).field(0).type \
                    if t is not None else None
            return None

    def _plan_row_upper_bound(self, node) -> Optional[int]:
        """An upper bound of a join side's rows without executing it: the
        Parquet footers' counts under Filter/Project chains (filters only
        shrink).  None for any other shape."""
        import pyarrow.parquet as pq

        while isinstance(node, (Filter, Project, Sort, Limit)):
            node = node.child
        if isinstance(node, InMemory):
            return node.table.num_rows
        if not isinstance(node, Scan):
            return None
        rel = node.relation
        if physical_read_format(rel.file_format) != "parquet":
            return None  # no footer to count
        if rel.file_paths is not None:
            paths = list(rel.file_paths)
        elif rel.file_format.lower() in LAKE_DATA_FORMATS:
            paths = [f.name for f in self.session.source_provider_manager
                     .get_relation(node).all_files()]
        else:
            paths = [f.name for f in list_data_files(rel.root_paths)]
        return self._read_index_files(rel, paths, lambda: sum(
            pq.ParquetFile(p).metadata.num_rows for p in paths))

    def _join_agg_static_pregate(self, plan: Aggregate, child: Join) -> bool:
        """False when the fused path is known ineligible before anything
        runs (a missing or ambiguous column, a type the device path does
        not take), so the plan keeps its normal route, bucketed join
        included; unknowns are left to the checks after the read."""
        import pyarrow as pa

        l_cols = set(child.left.output_columns(self.session.schema_of))
        r_cols = set(child.right.output_columns(self.session.schema_of))
        refs = set(plan.group_by)
        for _func, agg_in, _out in plan.aggs:
            if isinstance(agg_in, Expr):
                refs |= set(agg_in.referenced_columns())
            elif agg_in:
                refs.add(agg_in)
        for name in refs:
            in_l, in_r = name in l_cols, name in r_cols
            if in_l == in_r:  # missing or ambiguous
                return False
            t = self._static_column_type(child.left if in_l else child.right,
                                         name)
            if t is None:
                continue
            if name in plan.group_by:
                if not (pa.types.is_integer(t) or pa.types.is_boolean(t)
                        or pa.types.is_temporal(t)) or pa.types.is_uint64(t):
                    return False
            elif not (pa.types.is_integer(t) or pa.types.is_floating(t)) \
                    or pa.types.is_uint64(t):
                return False
        return True

    def _try_join_aggregate(self, plan: Aggregate,
                            topn: Optional[Tuple[int, bool, int]] = None):
        """``aggregate(inner equi-join)`` through the fused device
        pipeline (``ops.join_agg.join_group_aggregate``): match, gather,
        expression and reductions on the device, only per-group results
        back.

        Returns None to leave the plan alone (another shape; the join
        threshold above 1 << 22 rows without the "eager" cache policy,
        where the JAX package also keeps its bucketed host route; or
        footers' row counts under both the cold and the resident
        threshold); ("done", table) with the fused result;
        or ("joined", table) when the sides were read and a check after
        the read failed: the sides joined on the host, for the caller to
        aggregate.  Each of these is a routing decision; an error of a
        device call propagates."""
        import pyarrow as pa
        import pyarrow.compute as pc

        from hyperspace_tpu_torch.ops.filter import build_value_fn
        from hyperspace_tpu_torch.ops.join_agg import (
            join_group_aggregate,
            join_group_aggregate_mesh,
        )

        conf = self.session.conf
        if not plan.group_by:
            return None
        child = plan.child
        if not isinstance(child, Join) or child.how != "inner" \
                or child.residual is not None:
            return None
        # The plausibility gate: "eager" (pay the upload once, serve
        # repeats from card memory) or a cold threshold low enough that
        # a cold device join can win.
        device = self.session.device
        if conf.device_cache_policy != "eager" \
                and conf.device_min_rows("join_agg", device) > (1 << 22):
            return None
        if any(func not in self._JOIN_AGG_OPS for func, _i, _o in plan.aggs):
            return None
        # min/max keep their input's type, so they need a plain column.
        for func, agg_in, _out in plan.aggs:
            if func in ("min", "max") and not isinstance(agg_in, (Col, str)):
                return None
        pairs = as_equi_join_pairs(child.condition)
        if pairs is None or len(pairs) != 1:
            return None
        if not self._join_agg_static_pregate(plan, child):
            return None
        # When even the footers' row counts are under the lower of the
        # cold and resident thresholds, the device cannot be taken:
        # nothing is read for the attempt.
        lo_thresh = min(conf.device_min_rows("join_agg", device),
                        conf.resident_min_rows("join_agg", device))
        est_l = self._plan_row_upper_bound(child.left)
        est_r = self._plan_row_upper_bound(child.right)
        if est_l is not None and est_r is not None \
                and max(est_l, est_r) < lo_thresh:
            return None

        left = self.execute(child.left)
        right = self.execute(child.right)

        def fallback():
            self.stats["joins"].append({"strategy": "plain", "how": "inner"})
            return ("joined", self._host_join_tables(
                left, right, child.condition, "inner"))

        a, b = pairs[0]
        if a in left.column_names and b in right.column_names:
            lk_name, rk_name = a, b
        elif b in left.column_names and a in right.column_names:
            lk_name, rk_name = b, a
        else:
            return fallback()
        if (lk_name == rk_name or lk_name in right.column_names
                or rk_name in left.column_names):
            # A name on both sides: the column index below cannot tell
            # them apart.
            return fallback()
        if not (columnar.is_numeric_type(left.schema.field(lk_name).type)
                and columnar.is_numeric_type(right.schema.field(rk_name).type)):
            return fallback()
        # An inner join never matches a null key: drop those rows first,
        # with a derived identity, so residency carries across repeats.
        lv, rv = left, right
        if left.column(lk_name).null_count > 0:
            lv = left.filter(pc.is_valid(left.column(lk_name)))
            self._register_derived_identity(
                lv, self._scan_identity(left), f"dropnull:{lk_name}")
        if right.column(rk_name).null_count > 0:
            rv = right.filter(pc.is_valid(right.column(rk_name)))
            self._register_derived_identity(
                rv, self._scan_identity(right), f"dropnull:{rk_name}")
        if lv.num_rows == 0 or rv.num_rows == 0:
            return fallback()

        def side_of(name: str) -> Optional[str]:
            in_l, in_r = name in lv.column_names, name in rv.column_names
            if in_l == in_r:  # missing or ambiguous
                return None
            return "l" if in_l else "r"

        def table_of(side: str):
            return lv if side == "l" else rv

        # Group keys: int, bool or temporal (the int64 domain), no nulls.
        for k in plan.group_by:
            side = side_of(k)
            if side is None:
                return fallback()
            t = table_of(side).schema.field(k).type
            if not (pa.types.is_integer(t) or pa.types.is_boolean(t)
                    or pa.types.is_temporal(t)) or pa.types.is_uint64(t):
                return fallback()
            if table_of(side).column(k).null_count > 0:
                return fallback()
        # Aggregate inputs: null-free int or float columns.
        agg_ref_names: List[str] = []
        for func, agg_in, _out in plan.aggs:
            if func == "count_all":
                continue
            if func == "count" and isinstance(agg_in, Expr) \
                    and not isinstance(agg_in, Col):
                # The device counts group rows, which is count(expr) only
                # when the expression cannot make a null from null-free
                # inputs: + - * and negation, not division (x / 0 is
                # null).
                try:
                    build_value_fn(agg_in, sorted(agg_in.referenced_columns()))
                except ValueError:
                    return fallback()
            refs = [agg_in.name] if isinstance(agg_in, Col) else (
                [agg_in] if isinstance(agg_in, str)
                else list(agg_in.referenced_columns()))
            if func in ("min", "max") and not isinstance(agg_in, (Col, str)):
                return fallback()
            for r in refs:
                side = side_of(r)
                if side is None:
                    return fallback()
                t = table_of(side).schema.field(r).type
                if not (pa.types.is_integer(t) or pa.types.is_floating(t)) \
                        or pa.types.is_uint64(t) \
                        or table_of(side).column(r).null_count > 0:
                    return fallback()
                agg_ref_names.append(r)

        # Routing: the cold threshold, or the resident (or eager) one when
        # every referenced column of each side is cached for that side's
        # (maybe filter-derived) identity.
        referenced = set(plan.group_by) | set(agg_ref_names)
        need_l = sorted({lk_name} | {c for c in referenced
                                     if side_of(c) == "l"})
        need_r = sorted({rk_name} | {c for c in referenced
                                     if side_of(c) == "r"})
        id_l, id_r = self._scan_identity(lv), self._scan_identity(rv)
        pl = [(c, "num") for c in need_l]
        pr = [(c, "num") for c in need_r]
        max_rows = max(lv.num_rows, rv.num_rows)
        cold = conf.device_min_rows("join_agg", self.session.device)
        # The mesh pipeline opens at its own threshold; top-n and
        # resident inputs keep the fused single-device path.
        mesh = self._active_mesh()
        use_mesh = mesh is not None and topn is None \
            and max_rows >= conf.mesh_join_min_rows
        use_device = max_rows >= cold
        if not use_device:
            eff = max(self._cache_aware_min_rows(id_l, pl, "join_agg"),
                      self._cache_aware_min_rows(id_r, pr, "join_agg"))
            use_device = eff < cold and max_rows >= eff
        if not use_device and not use_mesh:
            return fallback()
        resident = self._all_resident(id_l, pl) and self._all_resident(id_r, pr)
        use_mesh = use_mesh and not resident
        ref_order = [("l", c) for c in need_l] + [("r", c) for c in need_r]
        col_ix = {c: i for i, (_s, c) in enumerate(ref_order)}
        if use_mesh:  # host columns: the mesh's shards place them
            columns = [columnar.to_device_numeric(table_of(s).column(c))
                       for s, c in ref_order]
        else:
            columns = [self._device_column(table_of(s), c,
                                           id_l if s == "l" else id_r, "num")
                       for s, c in ref_order]
        value_fns, lits_list = [], []
        for func, agg_in, _out in plan.aggs:
            if func in ("count", "count_all"):
                continue
            expr = Col(agg_in) if isinstance(agg_in, str) else agg_in
            try:
                fn, lits = build_value_fn(expr, [c for _s, c in ref_order])
            except ValueError:
                return fallback()
            value_fns.append(fn)
            lits_list.append(lits)
        args = (columns[col_ix[lk_name]], columns[col_ix[rk_name]], columns,
                [s for s, _c in ref_order], [col_ix[k] for k in plan.group_by],
                [f for f, _i, _o in plan.aggs], value_fns, lits_list)
        if use_mesh:
            li_first, ri_first, counts, results = \
                join_group_aggregate_mesh(*args, mesh)
        else:
            li_first, ri_first, counts, results = join_group_aggregate(
                *args, topn=topn, device=self.session.device)
        route = "mesh" if use_mesh else "device"
        self.stats["joins"].append({"strategy": f"{route}-fused-agg",
                                    "how": "inner", "resident": resident})
        self.stats.setdefault("aggregates", []).append({
            "strategy": f"{route}-join-agg", "groups": int(len(counts)),
            "rows": int(max_rows), "resident": resident,
            "topn": None if topn is None else int(topn[2])})
        data = {}
        for k in plan.group_by:
            if side_of(k) == "l":
                data[k] = lv.column(k).take(pa.array(li_first))
            else:
                data[k] = rv.column(k).take(pa.array(ri_first))
        # One result per aggregate (a count's carries the group counts).
        for (func, agg_in, out_name), res in zip(plan.aggs, results):
            if func in ("count", "count_all"):
                data[out_name] = pa.array(counts.astype(np.int64))
            elif func in ("min", "max"):
                name = agg_in.name if isinstance(agg_in, Col) else agg_in
                data[out_name] = pc.cast(
                    pa.array(res), table_of(side_of(name)).schema.field(name).type)
            elif func == "mean":
                data[out_name] = pa.array(res.astype(np.float64))
            else:  # sum: the device result's dtype
                data[out_name] = pa.array(res)
        return ("done", pa.table(data))

# ---------------------------------------------------------------------------
# predicate routing and the arrow host path
# ---------------------------------------------------------------------------
def _device_compatible(expr: Expr, table) -> bool:
    """Whether the device predicate gives the arrow path's answer on
    ``expr``: temporal columns only against temporal literals or a
    column of the same type, no bool-vs-number mix, no division."""
    import pyarrow as pa

    if isinstance(expr, BinOp):
        sides = (expr.left, expr.right)
        if not all(isinstance(s, (Col, Lit)) for s in sides):
            # Compound operands: int/float columns and numeric literals
            # under + - * and negation only.
            return all(_arith_device_ok(s, table) for s in sides)
        cols_in_cmp = [s for s in sides if isinstance(s, Col)]
        if not cols_in_cmp:
            return False  # a constant predicate: the arrow path owns it
        col_types = [table.schema.field(c.name).type for c in cols_in_cmp]
        if len(col_types) == 2 and (pa.types.is_boolean(col_types[0])
                                    != pa.types.is_boolean(col_types[1])):
            return False  # arrow raises on bool vs number
        if any(pa.types.is_temporal(t) for t in col_types):
            if len(col_types) == 2 and (
                    not all(pa.types.is_temporal(t) for t in col_types)
                    or col_types[0] != col_types[1]):
                return False
            if any(isinstance(s, Lit)
                   and isinstance(s.value, (int, float, bool, np.integer,
                                            np.floating, np.bool_))
                   for s in sides):
                return False  # epoch numbers against a plain number
        for side in sides:
            if not isinstance(side, Lit):
                continue
            v = side.value
            bool_lit = isinstance(v, (bool, np.bool_))
            if bool_lit != pa.types.is_boolean(col_types[0]) and (
                    bool_lit or isinstance(v, (int, float, np.integer,
                                               np.floating))):
                return False  # arrow raises on bool vs number
            if not isinstance(v, (int, float, bool)):
                if columnar.literal_to_numeric(v, col_types[0]) is None:
                    return False
        return True
    if isinstance(expr, (And, Or)):
        return (_device_compatible(expr.left, table)
                and _device_compatible(expr.right, table))
    if isinstance(expr, Not):
        return _device_compatible(expr.child, table)
    if isinstance(expr, IsIn):
        return (_arith_device_ok(expr.child, table)
                and all(isinstance(v, (int, float, bool)) for v in expr.values))
    return False


def _arith_device_ok(e: Expr, table) -> bool:
    """A device value expression: int/float columns, int/float literals
    (not bool) and + - * and negation over them."""
    import pyarrow as pa

    if isinstance(e, Col):
        try:
            t = table.schema.field(e.name).type
        except KeyError:
            return False
        return pa.types.is_integer(t) or pa.types.is_floating(t)
    if isinstance(e, Lit):
        return isinstance(e.value, (int, float)) and not isinstance(e.value, bool)
    if isinstance(e, Arith):
        return (e.op != "/" and _arith_device_ok(e.left, table)
                and _arith_device_ok(e.right, table))
    if isinstance(e, Neg):
        return _arith_device_ok(e.child, table)
    return False


def _normalize_literals(expr: Expr, table) -> Expr:
    """Temporal and bool literals compared with a column, in the
    column's int64 device domain."""
    if isinstance(expr, BinOp):
        left, right = expr.left, expr.right
        if isinstance(left, Col) and isinstance(right, Lit):
            t = table.schema.field(left.name).type
            return BinOp(expr.op, left,
                         Lit(columnar.literal_to_numeric(right.value, t)))
        if isinstance(right, Col) and isinstance(left, Lit):
            t = table.schema.field(right.name).type
            return BinOp(expr.op,
                         Lit(columnar.literal_to_numeric(left.value, t)), right)
        return expr
    if isinstance(expr, And):
        return And(_normalize_literals(expr.left, table),
                   _normalize_literals(expr.right, table))
    if isinstance(expr, Or):
        return Or(_normalize_literals(expr.left, table),
                  _normalize_literals(expr.right, table))
    if isinstance(expr, Not):
        return Not(_normalize_literals(expr.child, table))
    return expr


def _eval_arrow(expr: Expr, table, bucket_ids=None) -> np.ndarray:
    """The host predicate: arrow compute with SQL's three-valued logic;
    null counts as false.  ``bucket_ids(table, columns, num_buckets)``
    gives the rows' buckets of a ``BucketIn``."""
    import pyarrow as pa

    result = _arrow_eval(expr, table, bucket_ids)
    if isinstance(result, pa.Scalar):
        value = result.as_py()
        return np.full(table.num_rows, bool(value) if value is not None else False)
    mask = np.asarray(result.to_numpy(zero_copy_only=False))
    if mask.dtype != np.bool_:
        # Nulls surface as None in an object array.
        mask = np.array([bool(v) if v is not None else False for v in mask])
    return mask


def _eval_column(expr: Expr, table):
    """``expr`` as an output column (an aggregate's input): an array
    result as it is, a scalar one repeated for every row."""
    import pyarrow as pa

    result = _arrow_eval(expr, table)
    if isinstance(result, pa.Scalar):
        return pa.array([result.as_py()] * table.num_rows,
                        type=result.type if result.is_valid else None)
    return result


def _sorted_table(table, keys):
    """ORDER BY with Spark's null order: nulls sort as the smallest
    value, first ascending and last descending."""
    if table.num_rows == 0:
        return table
    return table.take(_sort_indices(table, keys))


def _sort_indices(table, keys):
    """The sort permutation with Spark's null order.  Arrow places nulls
    by one setting for every key, so each key with nulls gets a validity
    flag key in front of it, sorted in the key's own direction: false <
    true puts the nulls first ascending and last descending."""
    import pyarrow.compute as pc

    work = table
    sort_keys = []
    for c, asc in keys:
        direction = "ascending" if asc else "descending"
        if table.column(c).null_count > 0:
            flag = f"__valid__{c}"
            n = 1
            while flag in work.column_names:
                flag = f"__valid__{c}__{n}"
                n += 1
            work = work.append_column(flag, pc.is_valid(table.column(c)))
            sort_keys.append((flag, direction))
        sort_keys.append((c, direction))
    return pc.sort_indices(work, sort_keys=sort_keys)


def _window_empty_type(table, plan: Window):
    """The output type of a window over no rows: the type the rows
    would have given."""
    import pyarrow as pa

    out_type = {"row_number": pa.int32(), "rank": pa.int32(),
                "dense_rank": pa.int32(), "ntile": pa.int32(),
                "count": pa.int64(), "mean": pa.float64()}.get(plan.func)
    if out_type is None and plan.func in ("lag", "lead", "first_value",
                                          "last_value"):
        out_type = table.schema.field(plan.value).type
    if out_type is None and plan.func == "sum":
        src = table.schema.field(plan.value).type
        out_type = pa.int64() \
            if pa.types.is_integer(src) or pa.types.is_boolean(src) \
            else pa.float64()
    if out_type is None:  # min and max keep the input's type
        out_type = table.schema.field(plan.value).type \
            if plan.value else pa.int64()
    return out_type


def _window_values(v_sorted):
    """(values, valid) of a sorted arrow column for ``ops.window``'s
    frame functions, on the CPU: bools and temporals as their integers,
    ints as int64 and floats as float64 tensors, nulls filled with 0 and
    marked in the bool tensor ``valid``; uint64 as a numpy array (no
    torch op takes it).  Strings, binary and decimals give (None,
    valid): the caller takes an exact arrow path or raises (a float64
    view of a decimal would round)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    t = v_sorted.type
    valid = torch.from_numpy(np.asarray(
        pc.is_valid(v_sorted).to_numpy(zero_copy_only=False), dtype=bool))
    num = None
    if pa.types.is_boolean(t):
        num = v_sorted.cast(pa.int8())
    elif pa.types.is_date32(t) or pa.types.is_time32(t):
        num = v_sorted.cast(pa.int32())
    elif (pa.types.is_date64(t) or pa.types.is_time64(t)
            or pa.types.is_timestamp(t) or pa.types.is_duration(t)):
        num = v_sorted.cast(pa.int64())
    elif pa.types.is_integer(t) or pa.types.is_floating(t):
        num = v_sorted
    if num is None:
        return None, valid
    zero = pa.scalar(0.0 if pa.types.is_floating(num.type) else 0,
                     type=num.type)
    vals = pc.fill_null(num, zero).to_numpy(zero_copy_only=False)
    if vals.dtype == np.uint64:
        return vals, valid
    wide = np.float64 if vals.dtype.kind == "f" else np.int64
    return torch.from_numpy(vals.astype(wide)), valid


def _whole_partition_agg_arrow(v_sorted, part: np.ndarray, func: str):
    """A whole-partition aggregate of a type the frame functions do not
    take (strings, binary, decimals): arrow's hash aggregation, exact in
    the value's own type, broadcast back by the partition code."""
    import pyarrow as pa

    t = pa.table({"__c": pa.array(part), "__v": v_sorted})
    by_code = t.group_by("__c").aggregate([("__v", func)]) \
        .sort_by("__c").column(f"__v_{func}")
    if isinstance(by_code, pa.ChunkedArray):
        by_code = by_code.combine_chunks()
    return by_code.take(pa.array(part))


def _tie_starts(table, order_by, perm, new_part: np.ndarray) -> np.ndarray:
    """Per sorted row whether it starts a tie group: a new partition or
    a change of any order key, null-safe, NaN equal to NaN."""
    import pyarrow.compute as pc

    new_tie = new_part.copy()
    for c, _asc in order_by:
        col_sorted = table.column(c).take(perm)
        valid = np.asarray(pc.is_valid(col_sorted)
                           .to_numpy(zero_copy_only=False))
        vals = col_sorted.to_numpy(zero_copy_only=False)
        with np.errstate(invalid="ignore"):
            eq = vals[1:] == vals[:-1]
        if vals.dtype.kind == "f":
            eq = eq | (np.isnan(vals[1:].astype(float))
                       & np.isnan(vals[:-1].astype(float)))
        same = (valid[1:] == valid[:-1]) & (~valid[1:] | eq)
        new_tie[1:] |= ~same.astype(bool)
    return new_tie


def _window(table, plan: Window):
    """One analytic column over ``table`` by the host engine: one stable
    arrow sort by (partition code, order keys) with Spark's null order,
    then ``ops.window``'s segment functions on CPU tensors, then the
    column scattered back to the input's row order."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from hyperspace_tpu_torch.ops import window as W

    n = table.num_rows
    if n == 0:
        return table.append_column(
            plan.name, pa.array([], type=_window_empty_type(table, plan)))
    part_orig = W.partition_codes(table, plan.partition_by)
    pname = "__part"
    suffix = 1
    while pname in table.column_names:
        pname = f"__part__{suffix}"
        suffix += 1
    perm = _sort_indices(table.append_column(
                             pname, pa.array(sync_guard.pull(part_orig))),
                         [(pname, True)] + list(plan.order_by))
    perm_t = torch.from_numpy(np.asarray(perm).astype(np.int64))
    part = part_orig[perm_t]
    new_part = torch.ones(n, dtype=torch.bool)
    new_part[1:] = part[1:] != part[:-1]
    new_tie = torch.from_numpy(
        _tie_starts(table, plan.order_by, perm, sync_guard.pull(new_part)))
    part_start, part_end = W.segment_bounds(new_part)
    func = plan.func
    src_type = table.schema.field(plan.value).type if plan.value else None
    v_sorted = None
    if plan.value is not None:
        v_sorted = table.column(plan.value).take(perm)
        if isinstance(v_sorted, pa.ChunkedArray):
            v_sorted = v_sorted.combine_chunks()
    null = pa.scalar(None, type=src_type) if src_type is not None else None
    if func in ("lag", "lead"):
        # An index shift inside the partition: arrow's take keeps the
        # value's type bit for bit, and a row outside it is null.
        idx = torch.arange(n) - (plan.offset if func == "lag"
                                 else -plan.offset)
        valid = (idx >= 0) & (idx < n) \
            & (part[torch.clamp(idx, 0, n - 1)] == part)
        taken = v_sorted.take(
            pa.array(sync_guard.pull(torch.where(valid, idx, 0))))
        out = pc.if_else(pa.array(sync_guard.pull(valid)), taken, null)
    elif func == "row_number":
        out = pa.array(sync_guard.pull(W.row_number(part_start)))
    elif func == "rank":
        out = pa.array(sync_guard.pull(
            W.rank_from_ties(part_start, new_tie)))
    elif func == "dense_rank":
        out = pa.array(sync_guard.pull(
            W.dense_rank_from_ties(new_part, new_tie)))
    elif func == "ntile":
        out = pa.array(sync_guard.pull(
            W.ntile(part_start, part_end, plan.offset)))
    else:
        _, tie_end = W.segment_bounds(new_tie)
        lo, hi = W.frame_bounds(part_start, part_end, tie_end, plan.frame,
                                bool(plan.order_by))
        if func in ("first_value", "last_value"):
            arg, nonempty = W.frame_first_last(lo, hi, func == "first_value")
            out = pc.if_else(pa.array(sync_guard.pull(nonempty)),
                             v_sorted.take(pa.array(sync_guard.pull(arg))),
                             null)
        elif func == "count" and plan.value is None:
            out = pa.array(sync_guard.pull(W.frame_count(None, lo, hi)))
        else:
            vals, valid = _window_values(v_sorted)
            if vals is None:
                # Strings, binary, decimals: arrow's exact whole-partition
                # aggregate, or an error for a running frame.
                whole = plan.frame is None and not plan.order_by
                arrow_funcs = ("min", "max", "sum", "mean") \
                    if pa.types.is_decimal(v_sorted.type) else ("min", "max")
                if func in arrow_funcs and whole:
                    out = _whole_partition_agg_arrow(
                        v_sorted, sync_guard.pull(part), func)
                    if func in ("sum", "mean"):
                        out = pc.cast(out, pa.float64())
                elif func == "count":
                    out = pa.array(sync_guard.pull(
                        W.frame_count(valid, lo, hi)))
                else:
                    raise ValueError(
                        f"Running window {func}() over a "
                        f"{v_sorted.type} column is not supported; "
                        f"drop the ORDER BY for a whole-partition "
                        f"{func}, or cast the column to a "
                        f"numeric/temporal type")
            elif func == "count":
                out = pa.array(sync_guard.pull(W.frame_count(valid, lo, hi)))
            elif func == "sum":
                sums, cnt = W.frame_sum(vals, valid, lo, hi)
                empty = sync_guard.pull(cnt == 0)
                if isinstance(sums, np.ndarray):
                    # uint64 sums: an int64 result overflows loudly and
                    # never wraps.
                    if sums.size and sums.max() > np.iinfo(np.int64).max:
                        raise ValueError(
                            "window sum() over a uint64 column "
                            "overflows the int64 result type")
                    out = pa.array(sums.astype(np.int64), mask=empty)
                else:
                    out = pa.array(sync_guard.pull(sums), mask=empty)
            elif func == "mean":
                means, cnt = W.frame_mean(vals, valid, lo, hi)
                out = pa.array(sync_guard.pull(means),
                               mask=sync_guard.pull(cnt == 0))
            else:  # min, max
                arg, cnt = W.frame_min_max(
                    vals, valid, lo, hi, part_start, part_end, plan.frame,
                    is_min=(func == "min"))
                out = pc.if_else(pa.array(sync_guard.pull(cnt > 0)),
                                 v_sorted.take(pa.array(sync_guard.pull(arg))),
                                 null)
    # Back to the input's row order.
    inverse = torch.empty(n, dtype=torch.int64)
    inverse[perm_t] = torch.arange(n)
    out = out.take(pa.array(sync_guard.pull(inverse)))
    if plan.name in table.column_names:
        return table.set_column(table.column_names.index(plan.name),
                                plan.name, out)
    return table.append_column(plan.name, out)


def _coerce_numeric_strings(column) -> np.ndarray:
    """A string column parsed as float64 at once, NaN where a string
    (or a null) does not parse."""
    import pandas as pd

    arr = column.to_numpy(zero_copy_only=False)
    return pd.to_numeric(pd.Series(arr), errors="coerce") \
        .to_numpy(dtype=np.float64, na_value=np.nan)


def _parse_float64(column):
    """A string column as float64; a string that does not parse becomes
    NaN, which no comparison matches (the row drops, as for Spark's
    null)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    try:
        return pc.cast(column, pa.float64())
    except (pa.ArrowInvalid, pa.ArrowTypeError):
        return pa.array(_coerce_numeric_strings(column), type=pa.float64())


def _int_bounds(t):
    """The least and greatest value of arrow integer type ``t``."""
    import pyarrow as pa

    bits = t.bit_width
    if pa.types.is_signed_integer(t):
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


def _cast_scalar(v, target):
    """One value cast as Spark's non-ANSI CAST does: null when it does
    not convert.  A string parses as a decimal and truncates to an
    integer target ('3.5' AS INT is 3); an integer string parses exactly
    (no float64 round trip) and only in ASCII-digit form, so Python-only
    syntax ('1_000') is null as on the column path; a float truncates
    toward zero, and a value out of the target's range is null."""
    import pyarrow as pa

    if v is None:
        return None
    if isinstance(v, (float, str)) and pa.types.is_integer(target):
        if isinstance(v, str):
            sv = v.strip()
            if re.fullmatch(r"[+-]?[0-9]+", sv):
                v = int(sv)
            else:
                f = _coerce_numeric_strings(pa.array([v]))[0]
                if math.isnan(f):
                    return None
                v = float(f)
        if isinstance(v, float):
            if math.isnan(v) or math.isinf(v):
                return None
            v = int(v)
        lo, hi = _int_bounds(target)
        return v if lo <= v <= hi else None
    try:
        return pa.array([v]).cast(target)[0].as_py()
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError,
            pa.ArrowTypeError, ValueError, OverflowError):
        return None


def _cast_to_int(child, target):
    """A float or string column cast to integer ``target`` at once:
    truncation toward zero, null where a value does not parse or is out
    of range.  float64 is exact only below 2**53, so integer strings at
    or past it are parsed again one by one (only those that are ASCII
    integers can gain precision)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    ctype = child.type
    valid = np.asarray(pc.is_valid(child).to_numpy(zero_copy_only=False))
    if pa.types.is_floating(ctype):
        arr = np.asarray(pc.fill_null(child, 0.0).to_numpy(zero_copy_only=False),
                         dtype=np.float64)
    else:
        arr = _coerce_numeric_strings(child)
        valid &= ~np.isnan(arr)
        arr = np.where(np.isnan(arr), 0.0, arr)
    finite = np.isfinite(arr)
    trunc = np.trunc(np.where(finite, arr, 0.0))
    lo, hi = _int_bounds(target)
    hi_f = float(hi)
    ok = valid & finite & (trunc >= float(lo)) & (
        trunc <= hi_f if int(hi_f) == hi else trunc < hi_f)
    vals = np.where(ok, trunc, 0.0).astype(np.int64)
    if not pa.types.is_floating(ctype):
        big = np.nonzero(valid & (np.abs(trunc) >= 2.0**53))[0]
        if big.size:
            intlike = np.asarray(pc.fill_null(
                pc.match_substring_regex(child, r"^\s*[+-]?[0-9]+\s*$"), False)
                .to_numpy(zero_copy_only=False), dtype=bool)
            big = big[intlike[big]]
        for i in big.tolist():
            exact = _cast_scalar(child[i].as_py(), target)
            if exact is None:
                ok[i] = False
            else:
                vals[i] = exact
                ok[i] = True
    return pc.cast(pa.array(vals, mask=~ok), target)


def _cast(child, type_name: str):
    """CAST with Spark's non-ANSI semantics: arrow's safe cast when every
    value converts, else null for each value that does not."""
    import pyarrow as pa
    import pyarrow.compute as pc

    from hyperspace_tpu_torch.io.parquet import _dtype_from_string

    target = _dtype_from_string(type_name)
    try:
        return pc.cast(child, target)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError, pa.ArrowTypeError):
        pass
    if isinstance(child, pa.Scalar):
        return pa.scalar(_cast_scalar(child.as_py(), target), type=target)
    ctype = child.type
    if (pa.types.is_integer(target) and target.bit_width <= 64
            and not (pa.types.is_unsigned_integer(target)
                     and target.bit_width == 64)
            and (pa.types.is_floating(ctype) or pa.types.is_string(ctype)
                 or pa.types.is_large_string(ctype))):
        return _cast_to_int(child, target)
    return pa.array([_cast_scalar(v, target) for v in child.to_pylist()],
                    type=target)


def _string_fn(name: str, args, literal_args):
    """A ``StringFn`` over its evaluated ``args``; ``literal_args`` are
    the expressions (substring's start and length are literals)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if name == "upper":
        return pc.utf8_upper(args[0])
    if name == "lower":
        return pc.utf8_lower(args[0])
    if name == "length":
        return pc.cast(pc.utf8_length(args[0]), pa.int32())  # Spark's INT
    if name == "trim":
        return pc.utf8_trim_whitespace(args[0])
    if name == "ltrim":
        return pc.utf8_ltrim_whitespace(args[0])
    if name == "rtrim":
        return pc.utf8_rtrim_whitespace(args[0])
    if name == "substring":
        begin = literal_args[1].value - 1  # 1-based, checked >= 1
        if len(literal_args) == 2:
            return pc.utf8_slice_codeunits(args[0], begin)
        return pc.utf8_slice_codeunits(args[0], begin,
                                       begin + literal_args[2].value)
    # concat: every part as a string, null when any part is null; a
    # scalar part broadcasts without an array of the table's length.
    parts = [a if pa.types.is_string(a.type) or pa.types.is_large_string(a.type)
             else pc.cast(a, pa.string()) for a in args]
    return pc.binary_join_element_wise(*parts, "", null_handling="emit_null")


def _arrow_eval(expr: Expr, table, bucket_ids=None):
    import pyarrow as pa
    import pyarrow.compute as pc

    def ev(e: Expr):
        return _arrow_eval(e, table, bucket_ids)

    if isinstance(expr, Col):
        return table.column(expr.name)
    if isinstance(expr, Lit):
        return pa.scalar(expr.value)
    if isinstance(expr, BinOp):
        left = ev(expr.left)
        right = ev(expr.right)
        ops = {"==": pc.equal, "<": pc.less, "<=": pc.less_equal,
               ">": pc.greater, ">=": pc.greater_equal}
        try:
            return ops[expr.op](left, right)
        except pa.ArrowNotImplementedError:
            # Spark's coercion: a string column against a numeric scalar
            # compares as float64 ('05' == 5); any other scalar is cast
            # to the column's type ("2024" against an int64 column).
            # Uncastable values raise.
            def coerced(scalar, column):
                if (pa.types.is_string(column.type)
                        and (pa.types.is_integer(scalar.type)
                             or pa.types.is_floating(scalar.type))):
                    return (pc.cast(scalar, pa.float64()),
                            _parse_float64(column))
                return pc.cast(scalar, column.type), column

            try:
                if isinstance(left, pa.Scalar) and not isinstance(right, pa.Scalar):
                    lhs, rhs = coerced(left, right)
                    return ops[expr.op](lhs, rhs)
                if isinstance(right, pa.Scalar) and not isinstance(left, pa.Scalar):
                    rhs, lhs = coerced(right, left)
                    return ops[expr.op](lhs, rhs)
            except (pa.ArrowInvalid, pa.ArrowTypeError, ValueError, TypeError):
                pass
            raise
    if isinstance(expr, Arith):
        left = ev(expr.left)
        right = ev(expr.right)
        if expr.op == "/":
            # float64 division; x / 0 is null.
            left = pc.cast(left, pa.float64())
            right = pc.cast(right, pa.float64())
            zero = pc.equal(right, pa.scalar(0.0))
            safe = pc.if_else(zero, pa.scalar(1.0), right)
            return pc.if_else(zero, pa.scalar(None, type=pa.float64()),
                              pc.divide(left, safe))
        fn = {"+": pc.add, "-": pc.subtract, "*": pc.multiply}[expr.op]
        return fn(left, right)
    if isinstance(expr, Neg):
        return pc.negate(ev(expr.child))
    if isinstance(expr, And):
        return pc.and_kleene(ev(expr.left), ev(expr.right))
    if isinstance(expr, Or):
        return pc.or_kleene(ev(expr.left), ev(expr.right))
    if isinstance(expr, Not):
        return pc.invert(ev(expr.child))
    if isinstance(expr, IsIn):
        child = ev(expr.child)
        # SQL: NULL IN (...) is NULL, and x IN (no match..., NULL) is NULL
        # (arrow's is_in says false); both matter under NOT.
        values = [v for v in expr.values if v is not None]
        null_in_list = len(values) != len(expr.values)
        null_bool = pa.scalar(None, type=pa.bool_())
        result = pc.is_in(child, value_set=pa.array(values)) if values \
            else pa.scalar(False)
        if null_in_list:
            result = pc.if_else(result, pa.scalar(True), null_bool)
        if isinstance(child, pa.Scalar):
            return result if child.is_valid else null_bool
        return pc.if_else(pc.is_valid(child), result, null_bool)
    if isinstance(expr, IsNull):
        return pc.is_null(ev(expr.child))
    if isinstance(expr, BucketIn):
        # The containment branch's rows: each row's bucket as the build
        # hashed it, so the mask is null-free.
        if bucket_ids is None:
            raise ValueError(f"{expr!r} needs the executor's bucket hash")
        ids = bucket_ids(table, expr.columns, expr.num_buckets)
        return pa.array(np.isin(ids, np.asarray(expr.buckets, dtype=ids.dtype)))
    if isinstance(expr, Cast):
        return _cast(ev(expr.child), expr.type_name)
    if isinstance(expr, Extract):
        fns = {"year": pc.year, "month": pc.month, "day": pc.day,
               "quarter": pc.quarter}
        # Spark's year() and friends return INT; arrow's int64.
        return pc.cast(fns[expr.field](ev(expr.child)), pa.int32())
    if isinstance(expr, StringFn):
        return _string_fn(expr.name, [ev(a) for a in expr.args], expr.args)
    if isinstance(expr, StringMatch):
        child = ev(expr.child)
        fn = {"like": pc.match_like, "startswith": pc.starts_with,
              "endswith": pc.ends_with,
              "contains": pc.match_substring}[expr.kind]
        return fn(child, expr.pattern)
    if isinstance(expr, Case):
        # Branches in order (built right to left so the first wins); a
        # null condition is false, where arrow's if_else would give null.
        result = ev(expr.otherwise)
        if isinstance(result, pa.Scalar) and not result.is_valid \
                and result.type == pa.null():
            result = None  # an untyped null ELSE: the branches' type
        for cond, value in reversed(expr.branches):
            mask = ev(cond)
            if isinstance(mask, pa.Scalar):
                mask = pa.scalar(bool(mask.as_py()) if mask.is_valid else False)
            else:
                mask = pc.fill_null(mask, False)
            val = ev(value)
            if result is None:
                result = pa.scalar(None, type=val.type)
            result = pc.if_else(mask, val, result)
        return result
    raise ValueError(f"Unsupported expression: {expr!r}")


# ---------------------------------------------------------------------------
# join helpers
# ---------------------------------------------------------------------------
def _concat_horizontal(left, right):
    """The left columns, then the right ones; a right name the output
    already has becomes ``name__1`` (``__2``, ...)."""
    import pyarrow as pa

    names = list(left.column_names)
    cols = list(left.columns)
    for name, column in zip(right.column_names, right.columns):
        out_name = name
        n = 1
        while out_name in names:
            out_name = f"{name}__{n}"
            n += 1
        names.append(out_name)
        cols.append(column)
    return pa.table(dict(zip(names, cols)))


def _footer_row_estimate(files_by_bucket, buckets) -> int:
    """The Parquet footers' row counts of the given buckets' files, with
    no column decoded; a file whose footer cannot be read counts 0 (the
    estimate only routes)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    total = 0
    for b in buckets:
        for path in files_by_bucket.get(b, ()):
            try:
                total += pq.read_metadata(path).num_rows
            except (OSError, pa.ArrowException):
                pass
    return total


def _find_column(table, name: str) -> Optional[str]:
    """``name`` in ``table``, its exact spelling first, else matched
    case-insensitively; None when absent."""
    if name in table.column_names:
        return name
    return next((c for c in table.column_names
                 if c.lower() == name.lower()), None)


def _valid_key_positions(table, keys: List[str]) -> np.ndarray:
    """Positions of the rows whose join keys are all non-null."""
    import pyarrow.compute as pc

    valid = np.ones(table.num_rows, dtype=bool)
    for k in keys:
        column = table.column(k)
        if column.null_count > 0:
            valid &= np.asarray(pc.is_valid(column).to_numpy(zero_copy_only=False))
    return np.nonzero(valid)[0] if not valid.all() else np.arange(table.num_rows)


class _BucketedSide:
    """A join side for the bucket-aligned join: its bucketed index
    ``scan``, the ``inner`` wrappers between a hybrid BucketUnion and the
    scan (none without a union), the ``outer`` wrappers above, and the
    ``appended`` subtree (None for a plain index chain)."""

    def __init__(self, scan: Scan, inner: List[LogicalPlan],
                 outer: List[LogicalPlan],
                 appended: Optional[LogicalPlan]) -> None:
        self.scan = scan
        self.inner = inner
        self.outer = outer
        self.appended = appended


def _is_bucketed_index_scan(node: LogicalPlan) -> bool:
    return (isinstance(node, Scan) and bool(node.relation.bucket_spec)
            and node.relation.file_paths is not None
            and bool(node.relation.index_scan_of))


def _unwrap_chain(node: LogicalPlan):
    wrappers: List[LogicalPlan] = []
    while isinstance(node, (Project, Filter)):
        wrappers.append(node)
        node = node.children[0]
    return wrappers, node


def _bucketed_side(node: LogicalPlan) -> Optional[_BucketedSide]:
    """Match ``(Project|Filter)*`` over a bucketed index scan or over a
    hybrid ``BucketUnion(index chain, appended subtree)``."""
    outer, node = _unwrap_chain(node)
    if _is_bucketed_index_scan(node):
        return _BucketedSide(node, [], outer, None)
    if isinstance(node, BucketUnion) and len(node.children) == 2:
        # The index chain is found by its shape, not its position.
        for index_child, appended_child in (node.children,
                                            node.children[::-1]):
            inner, leaf = _unwrap_chain(index_child)
            if _is_bucketed_index_scan(leaf):
                return _BucketedSide(leaf, inner, outer, appended_child)
    return None


def bucketed_join_precheck(session, plan: Join):
    """(left side, right side, left files by bucket, right files by
    bucket) when ``plan`` can run bucket by bucket, else None.

    Multi-column keys qualify when the join pairs map the two sides'
    bucket columns position by position: the same hash inputs in the
    same order put equal key tuples in the same bucket."""
    pairs = as_equi_join_pairs(plan.condition)
    if not pairs:
        return None
    left_side, right_side = _bucketed_side(plan.left), _bucketed_side(plan.right)
    if left_side is None or right_side is None:
        return None
    l_scan, r_scan = left_side.scan, right_side.scan
    l_spec, r_spec = l_scan.relation.bucket_spec, r_scan.relation.bucket_spec
    if l_spec[0] != r_spec[0]:
        return None
    l_cols = tuple(c.lower() for c in l_spec[1])
    r_cols = tuple(c.lower() for c in r_spec[1])
    if len(pairs) != len(l_cols) or len(l_cols) != len(r_cols):
        return None
    l_to_r = {}
    for a, b in pairs:
        la, rb = a.lower(), b.lower()
        fwd = la in l_cols and rb in r_cols
        rev = rb in l_cols and la in r_cols
        if fwd and rev and la != rb:
            # Both orientations fit: the per-bucket join resolves sides by
            # table columns and could pick the other one.  Plain path.
            return None
        if fwd:
            l_to_r[la] = rb
        elif rev:
            l_to_r[rb] = la
        else:
            return None
    if [l_to_r.get(c) for c in l_cols] != list(r_cols):
        return None
    # Buckets align only when both sides hashed the same bit patterns:
    # an int64 key and a float64 key put equal values in different
    # buckets.
    for lc, rc in zip(l_spec[1], r_spec[1]):
        l_type = session.schema_map_of(l_scan).get(lc)
        r_type = session.schema_map_of(r_scan).get(rc)
        if l_type is None or r_type is None or l_type != r_type:
            return None
    l_files = _files_by_bucket(l_scan)
    r_files = _files_by_bucket(r_scan)
    if l_files is None or r_files is None:
        return None
    return left_side, right_side, l_files, r_files


def _files_by_bucket(scan: Scan):
    """Bucket id -> files, honouring the scan's own bucket pruning."""
    allowed = None if scan.relation.prune_to_buckets is None \
        else set(scan.relation.prune_to_buckets)
    out: Dict[int, List[str]] = {}
    for p in scan.relation.file_paths:
        b = bucket_id_of_file(p)
        if b is None:
            return None
        if allowed is not None and b not in allowed:
            continue
        out.setdefault(b, []).append(p)
    return out


def _rewrap(scan: Scan, wrappers, files) -> LogicalPlan:
    import dataclasses

    rel = dataclasses.replace(scan.relation, file_paths=tuple(files),
                              bucket_spec=None, prune_to_buckets=None)
    node: LogicalPlan = Scan(rel)
    for w in reversed(wrappers):
        node = w.with_children((node,))
    return node
