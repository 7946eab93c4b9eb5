"""CreateAction: validate the config and plan, build the covering index on
the session's device, commit the log entry (counterpart of
hyperspace_tpu/actions/create.py, its monolithic build).

The build: read the source columns, turn the key columns into uint32
hash and order words (``io.columnar``), run the bucket hash kernel and
the stable lexsort by (bucket, key words) on the device
(``ops.sort.bucket_sort_permutation``), and write one sorted Parquet file
per non-empty bucket into the next ``v__=N`` directory
(``io.parquet.write_bucketed``, whose run offsets come from the bucket
histogram kernel).

Only the monolithic build is ported: a source of more rows than
``conf.device_batch_rows`` needs the spill build, which is not, and is
refused with a ``HyperspaceError`` before any data is read.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
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
from hyperspace_tpu_torch.io import columnar
from hyperspace_tpu_torch.io.parquet import read_table, row_count, write_bucketed
from hyperspace_tpu_torch.ops.sort import bucket_sort_permutation
from hyperspace_tpu_torch.plan.nodes import LogicalPlan


def _resolve_or_raise(requested: List[str], available: List[str],
                      what: str) -> List[str]:
    """Resolve ``requested`` against ``available`` case-insensitively,
    returning the schema's own spelling."""
    lookup: Dict[str, str] = {}
    for name in available:
        lookup.setdefault(name.lower(), name)
    missing = [n for n in requested if n.lower() not in lookup]
    if missing:
        raise HyperspaceError(
            f"Could not resolve {what}(s) {missing} against schema {available}")
    return [lookup[n.lower()] for n in requested]


class CreateAction(Action):
    transient_state = States.CREATING
    final_state = States.ACTIVE

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
        # Wall seconds of this build by phase (plan / read / kernel /
        # write), published to ``session.build_stats_log``.
        self.build_phases: Dict[str, float] = {}

    def _phase(self, name: str, seconds: float) -> None:
        self.build_phases[name] = self.build_phases.get(name, 0.0) + seconds

    @property
    def conf(self) -> HyperspaceConf:
        return self.session.conf

    @property
    def num_buckets(self) -> int:
        return self.conf.num_buckets

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
            _resolve_or_raise(self.config.indexed_columns, schema, "indexed column"),
            _resolve_or_raise(self.config.included_columns, schema, "included column"))

    # -- protocol -------------------------------------------------------------
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
        resolved = self._resolved_config()
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=CoveringIndex(
                indexed_columns=resolved.indexed_columns,
                included_columns=resolved.included_columns,
                num_buckets=self.num_buckets,
                schema=self._index_schema,
                properties={"layout": "lexicographic"},
            ),
            content=Content.from_directory(
                self.data_manager.version_path(self._written_version),
                FileIdTracker()),
            source=Source(
                relations=[self._relation().create_relation_metadata(
                    self._file_id_tracker)],
                fingerprint=LogicalPlanFingerprint([self._signature()])),
            # The log version this entry commits at (end() writes at
            # base_id + 2); the port has no lineage column.
            properties={"lineage": "false",
                        "indexLogVersion": str(self.base_id + 2)},
        )

    def _signature(self) -> Signature:
        provider_name = self.conf.signature_provider
        value = get_provider(provider_name).signature(
            self.plan,
            lambda scan: self.session.source_provider_manager
            .get_relation(scan).all_files())
        if value is None:
            raise HyperspaceError("Could not compute plan signature")
        return Signature(provider_name, value)

    # -- the build --------------------------------------------------------------
    def _build_index_data(self) -> None:
        t0 = time.perf_counter()
        relation = self._relation()
        resolved = self._resolved_config()
        files = relation.all_files(self._file_id_tracker)
        if not files:
            raise HyperspaceError("No source data files to index")
        batch_rows = max(1, int(self.conf.device_batch_rows))
        n_rows = row_count([f.name for f in files])
        if n_rows > batch_rows:
            raise HyperspaceError(
                f"The source has {n_rows} rows, more than one device batch "
                f"(device_batch_rows={batch_rows}); such sources need the "
                f"spill build, which is not yet ported to hyperspace_tpu_torch")
        self._phase("plan_s", time.perf_counter() - t0)
        self._stream_build([f.name for f in files], resolved.all_columns, resolved)
        log = getattr(self.session, "build_stats_log", None)
        if log is not None:
            log.append({"index": self.config.index_name, **self.build_phases})

    def _stream_build(self, paths: List[str], columns: List[str],
                      resolved: IndexConfig) -> None:
        """Read the source (one batch: the monolithic build) and write it
        bucketed."""
        t0 = time.perf_counter()
        table = read_table(paths, columns)
        self._phase("read_s", time.perf_counter() - t0)
        self._write_table_bucketed(table, resolved)

    def _write_table_bucketed(self, table, resolved: IndexConfig) -> None:
        device = self.session.device
        t0 = time.perf_counter()
        keys = resolved.indexed_columns
        word_cols = [torch.from_numpy(columnar.to_hash_words(table.column(c)))
                     .to(device) for c in keys]
        order_words = [torch.from_numpy(columnar.to_order_words(table.column(c)))
                       .to(device) for c in keys]
        buckets, perm = bucket_sort_permutation(word_cols, order_words,
                                                self.num_buckets)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # attribute the device time here
        self._phase("kernel_s", time.perf_counter() - t0)
        version = self.data_manager.get_next_version()
        t0 = time.perf_counter()
        write_bucketed(table, buckets, perm, self.num_buckets,
                       self.data_manager.version_path(version),
                       max_rows_per_file=self.conf.index_max_rows_per_file,
                       compression=self.conf.index_file_compression)
        self._phase("write_s", time.perf_counter() - t0)
        self._written_version = version
        self._index_schema = {name: str(t) for name, t in
                              zip(table.column_names, table.schema.types)}
